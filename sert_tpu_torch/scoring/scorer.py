"""Entity scoring engines (port of ``sert_tpu/scoring/scorer.py``).

Both families score as R @ M^T (+ alpha * bias) with R [Q, d] the query
reps and M [E, d] the entity matrix:

  * log-linear: log P(c|q) = sum_t [z_tc - lse_t], z_tc = e_t . W_c + b_c.
    The per-term normalizer lse_t is constant across entities, so ranking
    needs only (sum_t e_t) . W_c + |q| b_c, one product against M = proj_w^T
    with alpha = |q|; the exact normalizers are subtracted afterwards, so
    the reported scores are exact log-probs;
  * LSE: the query rep against ``entity_emb`` (unit rows under cosine).

``dense_scores`` is the exact [Q, E] oracle; ``streaming_topk`` the exact
scan over entity chunks at O(Q * chunk) memory (``chunked_topk_core``, its
sweep, is also the per-shard base of a distributed engine);
``pallas_topk`` is the kernel engine (K3 + K4 via ``ops.exact_topk``, then
the log-linear normalizer through K5; the name is the reference's, shared
by the recipes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sert_tpu_torch.models import api
from sert_tpu_torch.models.common import compute_dtype, unit_rows
from sert_tpu_torch.ops.exact_topk import (exact_topk_prepared,
                                           prepare_entities)
from sert_tpu_torch.ops.xent import kernel_limits, xent_lse
from sert_tpu_torch.utils.config import ModelConfig

NEG_INF = -1e30


def _query_reps_and_terms(params, cfg: ModelConfig, term_ids: torch.Tensor,
                          num_terms: torch.Tensor, similarity: str):
    """(R [Q, d], term embeddings [Q, T, d] or None, mask [Q, T]). For
    log-linear R is the sum of the query's term embeddings in the compute
    dtype and the term embeddings are masked past each query's length; for
    LSE R is the fp32 window rep (unit rows under cosine)."""
    T = term_ids.shape[1]
    mask = (torch.arange(T, device=term_ids.device)[None, :]
            < num_terms[:, None])
    if cfg.model == "loglinear":
        emb = F.embedding(term_ids.long(), params["word_emb"])
        emb = emb.to(compute_dtype(cfg))
        emb = emb * mask[:, :, None].to(emb.dtype)
        return emb.sum(dim=1), emb, mask
    reps = api.window_rep(params, term_ids, num_terms, cfg)
    if similarity == "cosine":
        reps = unit_rows(reps)
    return reps, None, mask


def _entity_matrix(params, cfg: ModelConfig, similarity: str
                   ) -> torch.Tensor:
    """[E, d] fp32, normalized in fp32 (before any bf16 staging cast) under
    LSE cosine similarity."""
    M = api.entity_matrix(params, cfg).float()
    if cfg.model != "loglinear" and similarity == "cosine":
        M = unit_rows(M)
    return M


def dense_scores(params, cfg: ModelConfig, term_ids: torch.Tensor,
                 num_terms: torch.Tensor, similarity: str = "dot"
                 ) -> torch.Tensor:
    """Exact [Q, E] fp32 scores: log-probs for log-linear (with exact
    per-term normalizers over a [Q, T, E] logits array), similarity for LSE.
    TF32 must be off on the card."""
    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    M = _entity_matrix(params, cfg, similarity)
    scores = R.float() @ M.T
    if cfg.model == "loglinear":
        b = params["proj_b"].float()
        scores = scores + num_terms.float()[:, None] * b[None, :]
        z = torch.einsum("qtd,ed->qte", term_emb.float(), M) + b
        lse_t = torch.logsumexp(z, dim=-1)                          # [Q, T]
        scores = scores - torch.sum(lse_t * mask, dim=-1)[:, None]
    return scores


def lse_chunk_update(run_max: torch.Tensor, run_sum: torch.Tensor,
                     z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One online-logsumexp step over the trailing (entity) axis of ``z``:
    merge the running (max, sumexp) with a new chunk of logits."""
    m_new = torch.maximum(run_max, z.amax(dim=-1))
    run_sum = (run_sum * torch.exp(run_max - m_new)
               + torch.sum(torch.exp(z - m_new[..., None]), dim=-1))
    return m_new, run_sum


def _stable_topk(s: torch.Tensor, i: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of ``s`` along dim 1 with ``i`` alongside; equal values
    keep their order (lax.top_k's tie rule), so padding ties resolve as
    in the reference."""
    vals, sel = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(i, 1, sel[:, :k])


def chunked_topk_core(R: torch.Tensor, term_emb: Optional[torch.Tensor],
                      mask: torch.Tensor, M: torch.Tensor,
                      bias: Optional[torch.Tensor], k: int, chunk: int,
                      is_ll: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, torch.Tensor]:
    """The streaming sweep over an entity-matrix block ``M`` [E_rows, d].

    Returns un-normalized (top_s [Q, k], top_i [Q, k] local row ids,
    run_max [Q, T], run_sum [Q, T]); the caller applies the log-linear
    normalizer (:func:`apply_ll_normalizer`). ``k`` entries always come
    back: with fewer than k rows the tail is NEG_INF (it loses any later
    merge). Each chunk is one fp32 product (TF32 must be off on the card)
    and a merge of the running top k with it."""
    E_rows = M.shape[0]
    Q, T = mask.shape
    dev = M.device
    top_s = torch.full((Q, k), NEG_INF, device=dev)
    top_i = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    run_max = torch.full((Q, T), NEG_INF, device=dev)
    run_sum = torch.zeros((Q, T), device=dev)
    if is_ll:
        te = term_emb.float()
        tm32 = mask.float()
        b = bias.float()
    for lo in range(0, E_rows, chunk):
        Mc = M[lo:lo + chunk]
        if is_ll:
            # term-level logits for the online normalizer
            z = torch.einsum("qtd,cd->qtc", te, Mc) + b[lo:lo + chunk]
            run_max, run_sum = lse_chunk_update(run_max, run_sum, z)
            sc = torch.sum(z * tm32[:, :, None], dim=1)             # [Q, C]
        else:
            sc = R.float() @ Mc.T                                   # [Q, C]
        ids = torch.arange(lo, lo + Mc.shape[0], device=dev)
        top_s, top_i = _stable_topk(
            torch.cat([top_s, sc], dim=1),
            torch.cat([top_i, ids.expand(Q, -1)], dim=1), k)
    return top_s, top_i, run_max, run_sum


def apply_ll_normalizer(top_s: torch.Tensor, run_max: torch.Tensor,
                        run_sum: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """Fold the accumulated per-term logsumexp into final log-prob scores."""
    lse_t = run_max + torch.log(run_sum.clamp(min=1e-30))           # [Q, T]
    return top_s - torch.sum(lse_t * mask, dim=-1)[:, None]


def normalizer_engine(device: torch.device, rows: int, num_entities: int,
                      dim: int) -> str:
    """:func:`ll_log_normalizer`'s "auto": "fused" (K5) on a CUDA device
    where ``ops.xent.kernel_limits`` takes ``rows`` term rows of width
    ``dim`` over ``num_entities``, else "scan"."""
    if device.type == "cuda" and kernel_limits(rows, num_entities,
                                               dim) is None:
        return "fused"
    return "scan"


def ll_log_normalizer(params, cfg: ModelConfig, term_ids: torch.Tensor,
                      num_terms: torch.Tensor, chunk: int = 1 << 16,
                      similarity: str = "dot",
                      engine: str = "auto") -> torch.Tensor:
    """[Q] log-linear normalization constants sum_t logsumexp_c(z_tc), in
    fp32.

    ``engine="fused"`` runs K5 (``ops.xent.xent_lse``, the "de" layout, fp32
    products) over the flattened [Q*T, d] term embeddings: no [Q, T, E]
    logits. ``"scan"`` is the plain fixed-memory sweep over ``chunk``
    entities at a time. ``"auto"`` is "fused" on CUDA where K5 takes the
    shape (``ops.xent.kernel_limits`` of the [Q*T, d] rows, decided before
    any launch) and "scan" otherwise."""
    Q, T = term_ids.shape
    if engine == "auto":
        d, E = params["proj_w"].shape
        engine = normalizer_engine(term_ids.device, Q * T, E, d)
    if engine == "fused":
        mask = (torch.arange(T, device=term_ids.device)[None, :]
                < num_terms[:, None])
        emb = F.embedding(term_ids.long(), params["word_emb"])     # [Q, T, d]
        lse = xent_lse(emb.reshape(Q * T, -1).float(), params["proj_w"],
                       params["proj_b"], "de", "float32").reshape(Q, T)
        return torch.sum(lse * mask, dim=-1)
    if engine != "scan":
        raise ValueError(f"unknown normalizer engine {engine!r}")
    _, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    M = _entity_matrix(params, cfg, similarity)
    b = params["proj_b"].float()
    te = term_emb.float()
    run_max = torch.full((Q, T), NEG_INF, device=M.device)
    run_sum = torch.zeros((Q, T), device=M.device)
    for lo in range(0, M.shape[0], chunk):
        z = (torch.einsum("qtd,cd->qtc", te, M[lo:lo + chunk])
             + b[lo:lo + chunk])
        run_max, run_sum = lse_chunk_update(run_max, run_sum, z)
    lse_t = run_max + torch.log(run_sum.clamp(min=1e-30))
    return torch.sum(lse_t * mask, dim=-1)


def pallas_topk(params, cfg: ModelConfig, term_ids: torch.Tensor,
                num_terms: torch.Tensor, k: int = 100,
                similarity: str = "dot", prep=None, normalize: bool = True,
                adaptive_bins: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores, entity ids) through the kernel engine.

    For log-linear the prefilter ranks by the rank-equivalent un-normalized
    sum of logits (K3 with bias ``proj_b`` and alpha = |q|), K4 rescores,
    and the exact normalizer (:func:`ll_log_normalizer`, K5 on the card) is
    subtracted afterwards; ``normalize=False`` skips it (rankings are the
    same). ``prep``: ops.exact_topk.prepare_entities of the entity matrix,
    staged once and reused across batches (score_topics does)."""
    R, _, _ = _query_reps_and_terms(params, cfg, term_ids, num_terms,
                                    similarity)
    if prep is None:
        prep = prepare_entities(_entity_matrix(params, cfg, similarity))
    is_ll = cfg.model == "loglinear"
    bias = params["proj_b"].float() if is_ll else None
    alpha = num_terms.float() if is_ll else None
    top_s, top_i = exact_topk_prepared(R.float(), prep, bias=bias,
                                       alpha=alpha, k=k,
                                       adaptive_bins=adaptive_bins)
    if is_ll and normalize:
        const = ll_log_normalizer(params, cfg, term_ids, num_terms,
                                  similarity=similarity)
        top_s = top_s - const[:, None]
    return top_s, top_i


def streaming_topk(params, cfg: ModelConfig, term_ids: torch.Tensor,
                   num_terms: torch.Tensor, k: int = 100, chunk: int = 32768,
                   similarity: str = "dot"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k entities (scores [Q, k], ids [Q, k]) at O(Q * chunk) memory:
    the entity matrix in ``chunk``-row blocks, each one product and a
    merge of the running best. The log-linear normalizer accumulates
    online and is applied after the scan, so the scores are
    :func:`dense_scores`'."""
    E = api.entity_matrix(params, cfg).shape[0]
    k = min(k, E)
    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    M = _entity_matrix(params, cfg, similarity)
    is_ll = cfg.model == "loglinear"
    bias = params["proj_b"] if is_ll else None
    top_s, top_i, run_max, run_sum = chunked_topk_core(
        R, term_emb, mask, M, bias, k, chunk, is_ll)
    if is_ll:
        top_s = apply_ll_normalizer(top_s, run_max, run_sum, mask)
    return top_s, top_i
