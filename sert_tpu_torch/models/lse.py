"""LSE — Latent Semantic Entities (port of ``sert_tpu/models/lse.py``:
``init`` :33, ``noise_logits`` :45, ``window_rep`` :59,
``sample_negatives`` :69, ``sampled_softmax_inputs`` :139,
``loss_sampled_softmax`` :171, ``loss_full_softmax`` :222,
``query_scores`` :377).

word embeddings -> masked-mean pooling -> ``tanh(x W + b)`` into entity
space -> similarity against ``entity_emb`` [E, d_e]. Trained with the
importance-corrected sampled softmax over batch-shared negatives, whose
masked logsumexp runs through the K1/K2 kernels (``ops/sampled_lse``) on
the card, or (``lse_full``) with the full softmax over every entity, whose
cross-entropy runs through K5/K6 (``ops/xent``). The binary NCE objective
(``loss`` :86) is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sert_tpu_torch.models.common import (Params, compute_dtype,
                                          masked_mean_embed, param_dtype,
                                          scaled_normal_init, unit_rows,
                                          use_fused)
from sert_tpu_torch.ops.sampled_lse import MASKED, sampled_lse
from sert_tpu_torch.ops.xent import xent_loss, xent_loss_plain
from sert_tpu_torch.utils.config import ModelConfig


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


def noise_logits(entity_counts, cfg: ModelConfig,
                 device=None) -> torch.Tensor:
    """[E] fp32 log-weights of the negative-sampling distribution: zeros
    for ``uniform`` (or no counts), ``unigram_power * log(counts)`` for
    ``unigram``."""
    E = cfg.num_entities
    if cfg.negative_distribution == "uniform" or entity_counts is None:
        return torch.zeros((E,), dtype=torch.float32, device=device)
    c = torch.as_tensor(np.asarray(entity_counts), dtype=torch.float32,
                        device=device)
    return cfg.unigram_power * torch.log(c.clamp(min=1e-12))


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


_SCAN_WIDTH = 1024


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a 1-D tensor, the same bits on every run.
    On CUDA a 1-D ``torch.cumsum`` is a single-pass scan whose fp32 sums
    associate differently from run to run (measured on the H100), which
    moves inverse-CDF draws across entity boundaries; a scan along the
    rows of a 2-D tensor takes a fixed order. So: scan rows of 1024, then
    add the scanned row totals."""
    n = x.numel()
    if n <= _SCAN_WIDTH:
        return torch.cumsum(x.expand(2, n), dim=1)[0]
    rows = -(-n // _SCAN_WIDTH)
    m = F.pad(x, (0, rows * _SCAN_WIDTH - n)).view(rows, _SCAN_WIDTH)
    m = torch.cumsum(m, dim=1)
    before = F.pad(_cumsum(m[:, -1])[:-1], (1, 0))
    return (m + before[:, None]).reshape(-1)[:n]


def sample_negatives(generator: torch.Generator, noise: torch.Tensor,
                     batch_size: int, cfg: ModelConfig) -> torch.Tensor:
    """[B, k] int64 entity ids drawn iid with replacement from
    softmax(noise), by inverse CDF (prefix sums + searchsorted) on noise's
    device with ``generator``; the same draws on every run. They differ
    from ``jax.random``'s."""
    cdf = _cumsum(torch.softmax(noise.float(), dim=0))
    u = torch.rand((batch_size, cfg.num_negatives), generator=generator,
                   device=noise.device) * cdf[-1]   # guards cdf[-1] < 1
    idx = torch.searchsorted(cdf, u)
    return idx.clamp(max=cfg.num_entities - 1)


def sampled_softmax_inputs(params: Params, batch, cfg: ModelConfig,
                           generator: Optional[torch.Generator] = None,
                           negatives: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None):
    """(reps [B, de], cand [k, de], corr [k], negatives [k], pos [B],
    s_pos [B]): the window reps, the gathered candidate rows, their
    -log(k q) correction and the positives' scores, all fp32."""
    reps = window_rep(params, batch["windows"], batch["lengths"], cfg)
    ent = params["entity_emb"]
    if noise is None:
        noise = torch.zeros((cfg.num_entities,), dtype=torch.float32,
                            device=ent.device)
    logq = torch.log_softmax(noise.float(), dim=0)
    if negatives is None:
        negatives = sample_negatives(generator, noise, 1, cfg)[0]
    negatives = negatives.long()
    k = negatives.shape[0]
    ent = ent.float()
    pos = batch["entities"].long()
    # F.embedding: its backward sums duplicate ids in a fixed order.
    cand = F.embedding(negatives, ent)
    s_pos = torch.sum(reps * F.embedding(pos, ent), dim=-1)
    corr = logq[negatives] + math.log(k)
    return reps, cand, corr, negatives, pos, s_pos


def loss_sampled_softmax(params: Params, batch, cfg: ModelConfig,
                         generator: Optional[torch.Generator] = None,
                         negatives: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Importance-corrected sampled softmax with batch-shared negatives
    (accidental hits masked): mean over the batch of
    logsumexp([s_pos, s_neg - corr]) - s_pos. ``negatives`` [k] may be
    passed (parity tests); otherwise they are drawn from ``noise`` with
    ``generator``."""
    reps, cand, corr, negatives, pos, s_pos = sampled_softmax_inputs(
        params, batch, cfg, generator=generator, negatives=negatives,
        noise=noise)
    if use_fused(cfg, reps.device, reps.shape[0]):
        # lse([s_pos, s_neg*]) - s_pos = softplus(lse(s_neg*) - s_pos)
        lse_neg = sampled_lse(reps, cand, corr, negatives, pos,
                              dtype=cfg.compute_dtype)
        return torch.mean(F.softplus(lse_neg - s_pos))
    s_neg = reps @ cand.T - corr[None, :]
    hit = negatives[None, :] == pos[:, None]
    s_neg = torch.where(hit, torch.full_like(s_neg, MASKED), s_neg)
    lse_all = torch.logsumexp(torch.cat([s_pos[:, None], s_neg], dim=1),
                              dim=-1)
    return torch.mean(lse_all - s_pos)


def loss_full_softmax(params: Params, batch, cfg: ModelConfig,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean full-softmax cross-entropy over all entities (``lse_full``):
    the window reps against ``entity_emb`` in its [E, d] ("ed") layout with
    a zero bias, through K5/K6 when :func:`use_fused` says so, else their
    plain version :func:`ops.xent.xent_loss_plain`."""
    del generator, noise   # the full softmax samples nothing
    reps = window_rep(params, batch["windows"], batch["lengths"], cfg)
    ent = params["entity_emb"]
    zeros_b = torch.zeros((cfg.num_entities,), dtype=torch.float32,
                          device=reps.device)
    fused = use_fused(cfg, reps.device, reps.shape[0])
    fn = xent_loss if fused else xent_loss_plain
    total = fn(reps, ent, zeros_b, batch["entities"].long(), "ed",
               dtype=cfg.compute_dtype)
    return total / batch["windows"].shape[0]
