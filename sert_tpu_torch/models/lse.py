"""LSE — Latent Semantic Entities, inference part (port of
``sert_tpu/models/lse.py``: ``init`` :33, ``window_rep`` :59,
``query_scores`` :377).

word embeddings -> masked-mean pooling -> ``tanh(x W + b)`` into entity
space -> similarity against ``entity_emb`` [E, d_e]. The training
objectives come with the training slice.
"""

from __future__ import annotations

import torch

from sert_tpu.utils.config import ModelConfig
from sert_tpu_torch.models.common import (Params, compute_dtype,
                                          masked_mean_embed, param_dtype,
                                          scaled_normal_init, unit_rows)


def init(generator: torch.Generator, cfg: ModelConfig,
         device=None) -> Params:
    """Random params in the reference's keys and layouts (``proj_w`` is
    [d_w, d_e], applied as ``x @ proj_w``)."""
    dw, de = cfg.word_dim, cfg.entity_dim
    V, E = cfg.vocab_size, cfg.num_entities
    pd = param_dtype(cfg)
    return {
        "word_emb": scaled_normal_init(generator, (V, dw), dw, pd, device),
        "proj_w": scaled_normal_init(generator, (dw, de), dw, pd, device),
        "proj_b": torch.zeros((de,), dtype=pd, device=device),
        "entity_emb": scaled_normal_init(generator, (E, de), de, pd, device),
    }


def window_rep(params: Params, windows: torch.Tensor, lengths: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """[B, d_e] fp32 window representations: tanh(mean_emb @ W + b).

    The reference's cast order: pooling in the compute dtype, the product
    of compute-dtype operands accumulated in fp32 (bf16 x bf16 products are
    exact in fp32, so an fp32 matmul of the rounded operands is that
    accumulation; TF32 must be off on the card), bias and tanh in fp32."""
    ct = compute_dtype(cfg)
    pooled = masked_mean_embed(params["word_emb"], windows, lengths, ct)
    h = pooled.float() @ params["proj_w"].to(ct).float()
    return torch.tanh(h + params["proj_b"].float())


def query_scores(params: Params, term_ids: torch.Tensor,
                 num_terms: torch.Tensor, cfg: ModelConfig,
                 similarity: str = "dot") -> torch.Tensor:
    """[E] scores of one (padded) query projected as a single window,
    dot or cosine against every entity vector."""
    rep = window_rep(params, term_ids[None, :], num_terms.reshape(1), cfg)
    ent = params["entity_emb"].float()
    if similarity == "cosine":
        rep, ent = unit_rows(rep), unit_rows(ent)
    return ent @ rep[0]
