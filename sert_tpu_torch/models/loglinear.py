"""Log-linear word-to-entity model (port of ``sert_tpu/models/loglinear.py``:
``init`` :29, ``logits`` :40, ``loss`` :71 (its ``_use_fused`` :50 is
``models.common.use_fused``), ``term_log_probs`` :96, ``query_scores``
:106).

word embeddings -> masked-mean window pooling -> affine map into entity
space (``proj_w`` [d, E], ``proj_b`` [E]) -> full softmax over all
entities. The training cross-entropy runs through K5/K6 (``ops/xent``, the
"de" layout) when ``models.common.use_fused`` says so. Query time ranks by
log P(c|q) = sum_t log P(c | w_t), each query term a singleton window.
"""

from __future__ import annotations

from typing import Optional

import torch

from sert_tpu_torch.models.common import (Params, compute_dtype,
                                          masked_mean_embed, param_dtype,
                                          scaled_normal_init, use_fused)
from sert_tpu_torch.ops.xent import xent_loss, xent_loss_plain
from sert_tpu_torch.utils.config import ModelConfig


def init(generator: torch.Generator, cfg: ModelConfig,
         device=None) -> Params:
    """Random params in the reference's keys and layouts."""
    d, V, E = cfg.word_dim, cfg.vocab_size, cfg.num_entities
    pd = param_dtype(cfg)
    return {
        "word_emb": scaled_normal_init(generator, (V, d), d, pd, device),
        "proj_w": scaled_normal_init(generator, (d, E), d, pd, device),
        "proj_b": torch.zeros((E,), dtype=pd, device=device),
    }


def pooled_rep(params: Params, windows: torch.Tensor, lengths: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """[B, d] masked-mean word embeddings in the compute dtype (the
    log-linear window representation: no projection)."""
    return masked_mean_embed(params["word_emb"], windows, lengths,
                             compute_dtype(cfg))


def logits(params: Params, windows: torch.Tensor, lengths: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """[B, E] fp32 unnormalized entity scores: compute-dtype operands, fp32
    products (TF32 must be off on the card), fp32 bias."""
    ct = compute_dtype(cfg)
    pooled = pooled_rep(params, windows, lengths, cfg)
    out = pooled.float() @ params["proj_w"].to(ct).float()
    return out + params["proj_b"].float()


def loss(params: Params, batch, cfg: ModelConfig,
         generator: Optional[torch.Generator] = None,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of the full softmax over entities: K5/K6 (the
    fused path) or their plain version ``xent_loss_plain``, by
    :func:`models.common.use_fused` ("auto" takes the kernels on CUDA at
    every E they take: the reference's E >= 4096 rule was a TPU measurement
    and would keep both log-linear recipes, E = 1100 and 3500, off them)."""
    del generator, noise   # the full softmax samples nothing
    pooled = pooled_rep(params, batch["windows"], batch["lengths"], cfg)
    fused = use_fused(cfg, pooled.device, pooled.shape[0])
    fn = xent_loss if fused else xent_loss_plain
    total = fn(pooled.float(), params["proj_w"], params["proj_b"],
               batch["entities"].long(), "de", dtype=cfg.compute_dtype)
    return total / batch["windows"].shape[0]


def term_log_probs(params: Params, term_ids: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """[T, E] log P(c | w_t) for single query terms (singleton windows)."""
    T = term_ids.shape[0]
    lengths = torch.ones((T,), dtype=torch.int64, device=term_ids.device)
    z = logits(params, term_ids[:, None], lengths, cfg)
    return torch.log_softmax(z, dim=-1)


def query_scores(params: Params, term_ids: torch.Tensor,
                 num_terms: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[E] retrieval scores: the sum of per-term log-probs over the first
    ``num_terms`` entries of the (padded) query."""
    lp = term_log_probs(params, term_ids, cfg)                     # [T, E]
    mask = (torch.arange(term_ids.shape[0], device=term_ids.device)
            < num_terms)[:, None]
    return torch.sum(lp * mask, dim=0)
