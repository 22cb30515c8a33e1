"""LSE — Latent Semantic Entities (port of ``sert_tpu/models/lse.py``:
``init`` :33, ``noise_logits`` :45, ``window_rep`` :59,
``sample_negatives`` :69, ``loss`` :86, ``sampled_softmax_inputs`` :139,
``loss_sampled_softmax`` :171, ``loss_full_softmax`` :222, the serve-time
fold-in ``fold_in_entity`` :245, ``_entity_windows`` :272,
``_fold_in_opt`` :290 and ``fold_in_entity_gradient`` :324,
``query_scores`` :377).

word embeddings -> masked-mean pooling -> ``tanh(x W + b)`` into entity
space -> similarity against ``entity_emb`` [E, d_e]. Trained with the
binary NCE objective over per-example negatives (``loss``, plain PyTorch:
the reference has no kernel for it), with the importance-corrected sampled
softmax over batch-shared negatives, whose masked logsumexp runs through
the K1/K2 kernels (``ops/sampled_lse``) on the card, or (``lse_full``)
with the full softmax over every entity, whose cross-entropy runs through
K5/K6 (``ops/xent``). The two sampled objectives end in
:func:`nce_tail` / :func:`sampled_softmax_tail`, functions of the
already-gathered rows, which the row-sparse step (``train/sparse.py``)
calls on its own gathers.

The fold-in maps an unseen entity's text into the trained entity space
without retraining (``serving.EntitySearcher.add_entities``): the mean f
over its windows, or that f-image refitted on the entity's slice of the
NCE objective against frozen reps. Its arithmetic is plain PyTorch, as in
the reference (no kernel there either).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

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
    pooled = masked_mean_embed(params["word_emb"], windows, lengths,
                               compute_dtype(cfg))
    return project(pooled, params, cfg)


def project(pooled: torch.Tensor, params: Params,
            cfg: ModelConfig) -> torch.Tensor:
    """[B, d_e] fp32 tanh(pooled @ proj_w + b) of compute-dtype pooled
    rows (``window_rep`` after its pooling)."""
    h = pooled.float() @ params["proj_w"].to(compute_dtype(cfg)).float()
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


def noise_table(noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cdf, log q) of q = softmax(noise), both [E] fp32: the inclusive
    prefix sums the inverse-CDF draws search, and the log-probabilities the
    sampled softmax's correction reads."""
    z = noise.float()
    return _cumsum(torch.softmax(z, 0)), torch.log_softmax(z, 0)


# noise tensor -> (its version, cdf, log q). A run's noise is fixed, and a
# softmax over one 10M-long row takes milliseconds on the card (one block),
# so each noise tensor's table is computed once, and again only if the
# tensor changes in place. Keyed by identity: a tensor's == is elementwise.
_TABLES = WeakIdKeyDictionary()


def _table(noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hit = _TABLES.get(noise)
    if hit is None or hit[0] != noise._version:
        hit = (noise._version, *noise_table(noise))
        _TABLES[noise] = hit
    return hit[1], hit[2]


def sample_negatives(generator: torch.Generator, noise: torch.Tensor,
                     batch_size: int, cfg: ModelConfig) -> torch.Tensor:
    """[B, k] int64 entity ids drawn iid with replacement from
    softmax(noise), by inverse CDF (prefix sums + searchsorted) on noise's
    device with ``generator``; the same draws on every run. They differ
    from ``jax.random``'s."""
    cdf = _table(noise)[0]
    u = torch.rand((batch_size, cfg.num_negatives), generator=generator,
                   device=noise.device) * cdf[-1]   # guards cdf[-1] < 1
    idx = torch.searchsorted(cdf, u)
    return idx.clamp(max=cfg.num_entities - 1)


def noise_or_uniform(noise: Optional[torch.Tensor], cfg: ModelConfig,
                     device) -> torch.Tensor:
    """``noise``, or the uniform distribution's zero logits on ``device``
    where it is None."""
    if noise is not None:
        return noise
    return torch.zeros((cfg.num_entities,), dtype=torch.float32,
                       device=device)


def nce_tail(reps: torch.Tensor, pos_rows: torch.Tensor,
             neg_rows: torch.Tensor) -> torch.Tensor:
    """The binary NCE loss of fp32 reps [B, d] against the gathered rows
    of their positives [B, d] and of their negatives [B, k, d], both taken
    in fp32: -mean(log sigma(s_pos) + sum_k log sigma(-s_neg))."""
    s_pos = torch.sum(reps * pos_rows.float(), dim=-1)
    s_neg = torch.einsum("bd,bkd->bk", reps, neg_rows.float())
    ll = F.logsigmoid(s_pos) + torch.sum(F.logsigmoid(-s_neg), dim=-1)
    return -torch.mean(ll)


def loss(params: Params, batch, cfg: ModelConfig,
         generator: Optional[torch.Generator] = None,
         negatives: Optional[torch.Tensor] = None,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary NCE (negative-sampling) objective with per-example negatives
    [B, k]: ``negatives`` may be passed (parity tests); otherwise they are
    drawn from ``noise`` (default uniform) with ``generator``."""
    reps = window_rep(params, batch["windows"], batch["lengths"], cfg)
    ent = params["entity_emb"]
    if negatives is None:
        negatives = sample_negatives(
            generator, noise_or_uniform(noise, cfg, ent.device),
            reps.shape[0], cfg)
    ent = ent.float()
    # F.embedding: its backward sums duplicate ids in a fixed order.
    return nce_tail(reps, F.embedding(batch["entities"].long(), ent),
                    F.embedding(negatives.long(), ent))


def sampled_correction(noise: torch.Tensor,
                       negatives: torch.Tensor) -> torch.Tensor:
    """[k] fp32 log(k q(candidate)) of each drawn candidate under
    softmax(noise): the sampled softmax's importance correction."""
    return _table(noise)[1][negatives] + math.log(negatives.shape[0])


def sampled_softmax_inputs(params: Params, batch, cfg: ModelConfig,
                           generator: Optional[torch.Generator] = None,
                           negatives: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None):
    """(reps [B, de], pos_rows [B, de], cand [k, de], corr [k],
    negatives [k], pos [B]): the window reps, the gathered rows of the
    positives and the candidates, and the candidates' -log(k q)
    correction, all fp32: the arguments of :func:`sampled_softmax_tail`."""
    reps = window_rep(params, batch["windows"], batch["lengths"], cfg)
    ent = params["entity_emb"]
    noise = noise_or_uniform(noise, cfg, ent.device)
    if negatives is None:
        negatives = sample_negatives(generator, noise, 1, cfg)[0]
    negatives = negatives.long()
    ent = ent.float()
    pos = batch["entities"].long()
    # F.embedding: its backward sums duplicate ids in a fixed order.
    return (reps, F.embedding(pos, ent), F.embedding(negatives, ent),
            sampled_correction(noise, negatives), negatives, pos)


def sampled_softmax_tail(reps: torch.Tensor, pos_rows: torch.Tensor,
                         cand_rows: torch.Tensor, corr: torch.Tensor,
                         negatives: torch.Tensor, pos: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """The sampled softmax's loss from the gathered rows (taken in fp32):
    mean over the batch of logsumexp([s_pos, s_neg - corr]) - s_pos with
    accidental hits masked, through K1/K2 where :func:`use_fused` says so
    (the [B, k] logits then never reach memory), else in plain PyTorch."""
    s_pos = torch.sum(reps * pos_rows.float(), dim=-1)
    cand = cand_rows.float()
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


def loss_sampled_softmax(params: Params, batch, cfg: ModelConfig,
                         generator: Optional[torch.Generator] = None,
                         negatives: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Importance-corrected sampled softmax with batch-shared negatives
    (accidental hits masked). ``negatives`` [k] may be passed (parity
    tests); otherwise they are drawn from ``noise`` with ``generator``."""
    return sampled_softmax_tail(*sampled_softmax_inputs(
        params, batch, cfg, generator=generator, negatives=negatives,
        noise=noise), cfg)


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


# Windows a fold-in projects per dispatch: the gather materializes
# [W, window, d_w], and an unbounded text (reachable from the HTTP
# server's POST /entities) must not become one multi-GB allocation.
FOLD_IN_CHUNK = 8192


def _entity_windows(token_ids, window_size: int):
    """Sliding stride-1 windows + lengths over an entity's encoded text
    (the f-input distribution training used), as int32 numpy arrays;
    shared by both fold-in paths."""
    ids = np.asarray(token_ids, np.int32)
    if ids.size == 0:
        raise ValueError("fold_in_entity needs at least one in-vocab token")
    n = int(ids.size)
    if n <= window_size:
        return ids[None, :], np.asarray([n], np.int32)
    windows = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(ids, window_size))
    return windows, np.full(windows.shape[0], window_size, np.int32)


def host_window_rep(params: Params, windows: np.ndarray,
                    lengths: np.ndarray, cfg: ModelConfig) -> torch.Tensor:
    """:func:`window_rep` of numpy windows and lengths, on the params'
    device."""
    device = params["word_emb"].device
    return window_rep(params, torch.from_numpy(windows).to(device),
                      torch.from_numpy(lengths).to(device), cfg)


@torch.no_grad()
def fold_in_entity(params: Params, token_ids, cfg: ModelConfig,
                   window_size: int = 16) -> torch.Tensor:
    """[d_e] fp32 embedding of an unseen entity from its encoded text: the
    mean of f (:func:`window_rep`) over its stride-1 windows, summed in
    chunks of :data:`FOLD_IN_CHUNK` windows, on the params' device.
    Log-linear has no analogue: its candidates are trained columns."""
    windows, lengths = _entity_windows(token_ids, window_size)
    W = windows.shape[0]
    acc = None
    for lo in range(0, W, FOLD_IN_CHUNK):
        reps = host_window_rep(params, windows[lo:lo + FOLD_IN_CHUNK],
                               lengths[lo:lo + FOLD_IN_CHUNK], cfg)
        s = torch.sum(reps, dim=0)
        acc = s if acc is None else acc + s
    return acc / W


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


@torch.no_grad()
def _fold_in_opt(pos_reps: torch.Tensor, pos_w: torch.Tensor,
                 neg_reps: torch.Tensor, v0: torch.Tensor,
                 neg_weight: float, lr: float, steps: int) -> torch.Tensor:
    """Optimize one entity embedding v against FROZEN window reps with
    full-batch fp32 adam (optax's defaults, bias correction by step
    count) for ``steps`` steps on

        L(v) = -sum_p w_p log sigma(pos_p . v)
               - neg_weight * mean_n log sigma(-neg_n . v),

    entity e's slice of the NCE objective (``pos_w`` masks padding rows).
    Its gradient in closed form: -pos^T (w sigma(-s_pos)) + neg_weight
    / N neg^T sigma(s_neg). A loop on the reps' device that reads nothing
    back to the host."""
    f32 = dict(dtype=torch.float32, device=v0.device)
    b1, b2 = torch.tensor(ADAM_B1, **f32), torch.tensor(ADAM_B2, **f32)
    scale_neg = torch.tensor(neg_weight, **f32) / neg_reps.shape[0]
    v, mu, nu = v0.clone(), torch.zeros_like(v0), torch.zeros_like(v0)
    for count in range(1, steps + 1):
        g = (neg_reps.T @ torch.sigmoid(neg_reps @ v) * scale_neg
             - pos_reps.T @ (pos_w * torch.sigmoid(-(pos_reps @ v))))
        mu.mul_(ADAM_B1).add_(g * (1 - ADAM_B1))
        nu.mul_(ADAM_B2).add_(g * g * (1 - ADAM_B2))
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        v.add_(mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) * -lr)
    return v


@torch.no_grad()
def fold_in_entity_gradient(params: Params, token_ids, cfg: ModelConfig,
                            neg_reps: torch.Tensor, window_size: int = 16,
                            neg_weight: Optional[float] = None,
                            steps: int = 1000, lr: float = 0.05,
                            max_windows: int = 4096,
                            seed: int = 0) -> torch.Tensor:
    """[d_e] fp32 embedding of an unseen entity, optimized into the
    trained geometry: from its f-image, :func:`_fold_in_opt` fits the
    entity's slice of the NCE objective against frozen params, with its
    own text windows as positives and ``neg_reps`` (background window
    reps, ``serving.EntitySearcher._raw_negative_reps``) as negatives. The
    result scores on the trained index's own scale, with no calibration.

    ``neg_weight`` defaults to ``cfg.num_negatives`` (training drew k
    negatives per positive window). Texts past ``max_windows`` windows are
    subsampled with numpy's ``default_rng(seed)``, as the reference does;
    the positives pad to a power-of-two bucket of zero-weight rows (at
    least 8), and the f-image is their weighted sum over the padded rows."""
    windows, lengths = _entity_windows(token_ids, window_size)
    W = windows.shape[0]
    if W > max_windows:
        sel = np.random.default_rng(seed).choice(W, size=max_windows,
                                                 replace=False)
        windows, lengths = windows[np.sort(sel)], lengths[np.sort(sel)]
        W = max_windows
    P = max(8, 1 << (W - 1).bit_length())
    pos_w = np.zeros((P,), np.float32)
    pos_w[:W] = 1.0 / W
    pad = np.zeros((P - W, windows.shape[1]), np.int32)
    windows = np.concatenate([windows, pad])
    lengths = np.concatenate([lengths, np.ones((P - W,), np.int32)])
    pos_reps = host_window_rep(params, windows, lengths, cfg)
    w = torch.from_numpy(pos_w).to(pos_reps.device)
    v0 = torch.sum(pos_reps * w[:, None], dim=0)                # f-image
    if neg_weight is None:
        neg_weight = float(cfg.num_negatives)
    return _fold_in_opt(pos_reps, w,
                        torch.as_tensor(neg_reps, dtype=torch.float32,
                                        device=pos_reps.device),
                        v0, neg_weight, lr, steps)
