"""Distributed top-k over the entity matrix sharded on ``model`` (port of
``sert_tpu/parallel/topk.py``: ``_merge_topk`` :24, ``_local_lse`` :31,
``_local_binmax_topk`` :58, ``_shard_body`` :98, ``resolve_local_engine``
:195, ``prepare_distributed`` :205, ``distributed_topk`` :234).

Each model rank owns a contiguous row block of the entity matrix and finds
its block's top k with a local engine:

  * "pallas": K3 + K4 on the block (``ops.exact_topk.exact_topk_prepared``
    on :func:`prepare_distributed`'s staging), the single-card kernel
    engine per shard;
  * "binmax": the same bin-max prefilter in plain PyTorch, the block's
    [Q, rows] scores materialized once and the candidates gathered from
    them;
  * "scan": the fixed-memory streaming sweep
    (``scoring.scorer.chunked_topk_core``).

The block's ids are offset into the global range, and the winners merge:

  * "allgather": every rank gathers the [Q, k] winners of every block and
    takes the top k again (one collective);
  * "ring": a carry of winners travels S - 1 hops around the ring, each
    hop merged with the resident block's winners.

Merges keep the reference's tie rule (``lax.top_k``: the carry before the
local winners, the lower position first) through ``_stable_topk``. The
log-linear normalizer is global: each block's per-term (max, sumexp)
combines by a max and a rescaled sum over ``model`` before it is applied;
the block's part goes through K5 on a CUDA device where K5 takes the
shape (``scoring.scorer.normalizer_engine``), else a plain scan. Queries
split over ``data`` and every rank returns the whole batch's answer.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from sert_tpu_torch.models import api
from sert_tpu_torch.ops.exact_topk import (exact_topk_prepared,
                                           prepare_entities)
from sert_tpu_torch.ops.score_binmax import kernel_limits as binmax_limits
from sert_tpu_torch.ops.xent import xent_lse
from sert_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce_max,
                                          all_reduce_sum, ring_shift)
from sert_tpu_torch.parallel.sharding import block, shard_params
from sert_tpu_torch.scoring.scorer import (NEG_INF, _entity_matrix,
                                           _query_reps_and_terms,
                                           _stable_topk, apply_ll_normalizer,
                                           chunked_topk_core,
                                           lse_chunk_update,
                                           normalizer_engine)
from sert_tpu_torch.utils.config import ModelConfig

LOCAL_ENGINES = ("pallas", "binmax", "scan")
MERGES = ("allgather", "ring")


def _merge_topk(s_a, i_a, s_b, i_b, k):
    return _stable_topk(torch.cat([s_a, s_b], dim=1),
                        torch.cat([i_a, i_b], dim=1), k)


def _pad_k(top_s, top_i, k):
    """A block with fewer than k rows pads its winners with -inf for the
    merge."""
    short = k - top_s.shape[1]
    if short > 0:
        top_s = F.pad(top_s, (0, short), value=float("-inf"))
        top_i = F.pad(top_i, (0, short))
    return top_s, top_i


def _local_lse(term_emb, M, bias, chunk):
    """Per-term (max, sumexp) [Q, T] over the block's rows ``M`` [rows, d]
    in plain fp32 chunks: this block's part of the log-linear normalizer."""
    Q, T = term_emb.shape[:2]
    te = term_emb.float()
    run_max = torch.full((Q, T), NEG_INF, device=M.device)
    run_sum = torch.zeros((Q, T), device=M.device)
    for lo in range(0, M.shape[0], chunk):
        z = (torch.einsum("qtd,cd->qtc", te, M[lo:lo + chunk])
             + bias[lo:lo + chunk])
        run_max, run_sum = lse_chunk_update(run_max, run_sum, z)
    return run_max, run_sum


def _block_normalizer(term_emb, params, M, bias, chunk):
    """The block's (max, sumexp) of the log-linear normalizer: K5 over the
    block's proj_w where ``normalizer_engine`` takes it (its lse, with a
    sum of 1), else :func:`_local_lse`."""
    Q, T, d = term_emb.shape
    W = params["proj_w"]
    if normalizer_engine(M.device, Q * T, W.shape[1], d) == "fused":
        lse = xent_lse(term_emb.reshape(Q * T, d).float(), W,
                       params["proj_b"], "de", "float32").reshape(Q, T)
        return lse, torch.ones_like(lse)
    return _local_lse(term_emb, M, bias, chunk)


def _local_binmax_topk(R, mask, M, bias, k, is_ll, pad_bins: int = 16,
                       lanes: int = 128):
    """The block's top k by the bin-max prefilter in plain PyTorch: its
    [Q, rows] scores once, the max of each bin of ``lanes``, the top
    k + ``pad_bins`` bins, and the top k of their gathered scores."""
    rows, Q = M.shape[0], R.shape[0]
    pad = (-rows) % lanes
    z = R.float() @ F.pad(M, (0, 0, 0, pad)).T                  # [Q, rows_p]
    if is_ll:
        alpha = mask.float().sum(dim=-1)
        z = z + alpha[:, None] * F.pad(bias, (0, pad))[None, :]
    col = torch.arange(rows + pad, device=z.device)
    z = z.masked_fill(col[None, :] >= rows, float("-inf"))
    bins = z.reshape(Q, -1, lanes).amax(dim=-1)                 # [Q, n_bins]
    k_local = min(k, rows)
    nb = min(k_local + pad_bins, bins.shape[1])
    bin_ids = torch.arange(bins.shape[1], device=z.device).expand(Q, -1)
    _, bin_idx = _stable_topk(bins, bin_ids, nb)
    ent_idx = (bin_idx[:, :, None] * lanes
               + torch.arange(lanes, device=z.device)).reshape(Q, -1)
    top_s, top_i = _stable_topk(torch.gather(z, 1, ent_idx), ent_idx,
                                k_local)
    return _pad_k(top_s, top_i, k)


def resolve_local_engine(local_engine: str, device: torch.device,
                         dim: int) -> str:
    """"auto" -> the per-shard engine: "pallas" (K3/K4) on a CUDA device
    where K3 takes the padded width, else "binmax" (the reference's rule
    off the TPU). The one resolver of ``distributed_topk`` and
    ``scoring.run.stage_distributed``, so the staging matches the sweep."""
    if local_engine == "auto":
        if device.type == "cuda" and binmax_limits(dim) is None:
            return "pallas"
        return "binmax"
    if local_engine not in LOCAL_ENGINES:
        raise ValueError(f"unknown local engine {local_engine!r}")
    return local_engine


def local_params(params, cfg: ModelConfig, mesh: Mesh):
    """This rank's params from the full ones or from its shard already
    (``sharding.shard_params``), told apart by the entity rows; ValueError
    where the model axis does not divide the entity count."""
    E, tp = cfg.num_entities, mesh.shape["model"]
    if E % tp:
        raise ValueError(f"num_entities={E} must divide by model axis {tp}")
    rows = api.entity_matrix(params, cfg).shape[0]
    if rows == E // tp:
        return params
    if rows == E:
        return shard_params(params, mesh, cfg)
    raise ValueError(f"entity rows {rows} are neither {E} nor the block "
                     f"{E // tp} of a {tp}-way model axis")


def prepare_distributed(params, cfg: ModelConfig, mesh: Mesh,
                        similarity: str = "dot",
                        rescore_dtype: str = "float32",
                        prefilter_dtype: str = "bfloat16"):
    """The "pallas" engine's one-time staging of this rank's block
    (``ops.exact_topk.prepare_entities`` of its rows). Pass it as
    ``distributed_topk(..., prep=...)``."""
    params = local_params(params, cfg, mesh)
    return prepare_entities(_entity_matrix(params, cfg, similarity),
                            rescore_dtype=rescore_dtype,
                            prefilter_dtype=prefilter_dtype)


def distributed_topk(params, cfg: ModelConfig, term_ids: torch.Tensor,
                     num_terms: torch.Tensor, mesh: Mesh, k: int = 100,
                     chunk: int = 32768, similarity: str = "dot",
                     merge: str = "allgather", local_engine: str = "auto",
                     prep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (scores [Q, k], entity ids [Q, k]) over the entity matrix
    sharded on ``mesh``'s ``model`` axis, on every rank. ``params``: the
    full params or this rank's shard; every rank passes the same queries,
    which split over ``data`` (Q must divide by it). The entity count must
    divide by the model axis (the recipes pad it).

    ``local_engine``: "auto" (see :func:`resolve_local_engine`), "pallas",
    "binmax" or "scan"; ``merge``: "allgather" or "ring"; ``prep``:
    :func:`prepare_distributed`'s staging for "pallas" (staged here
    without it)."""
    if merge not in MERGES:
        raise ValueError(f"unknown merge strategy {merge!r}")
    params = local_params(params, cfg, mesh)
    E = cfg.num_entities
    k = min(k, E)
    is_ll = cfg.model == "loglinear"
    M = _entity_matrix(params, cfg, similarity)                 # [E/tp, d]
    local_engine = resolve_local_engine(local_engine, M.device, M.shape[1])
    dp, axis = mesh.shape["data"], "model"
    if dp > 1:
        lo, hi = block(term_ids.shape[0], mesh, "data")
        term_ids, num_terms = term_ids[lo:hi], num_terms[lo:hi]
    R, term_emb, mask = _query_reps_and_terms(params, cfg, term_ids,
                                              num_terms, similarity)
    rows = M.shape[0]
    bias = params["proj_b"].float() if is_ll else None

    run_max = run_sum = None
    if local_engine == "scan":
        top_s, top_i, run_max, run_sum = chunked_topk_core(
            R, term_emb, mask, M, bias, k, chunk, is_ll)
    else:
        if local_engine == "pallas":
            if prep is None:
                prep = prepare_entities(M)
            top_s, top_i = exact_topk_prepared(
                R.float(), prep, bias=bias,
                alpha=mask.float().sum(dim=-1) if is_ll else None,
                k=min(k, rows))
            top_s, top_i = _pad_k(top_s, top_i, k)
        else:
            top_s, top_i = _local_binmax_topk(R, mask, M, bias, k, is_ll)
        if is_ll:
            run_max, run_sum = _block_normalizer(term_emb, params, M, bias,
                                                 chunk)
    top_i = top_i + mesh.coords[axis] * rows

    if is_ll:   # the global per-term logsumexp from the blocks' pairs
        g_max = all_reduce_max(run_max, mesh, axis)
        run_sum = all_reduce_sum(run_sum * torch.exp(run_max - g_max), mesh,
                                 axis)
        run_max = g_max

    if merge == "allgather":
        all_s = all_gather(top_s, mesh, axis)                   # [S, Q, k]
        all_i = all_gather(top_i, mesh, axis)
        Q = all_s.shape[1]
        top_s, top_i = _stable_topk(all_s.transpose(0, 1).reshape(Q, -1),
                                    all_i.transpose(0, 1).reshape(Q, -1), k)
    else:
        carry_s, carry_i = top_s, top_i
        for _ in range(mesh.shape[axis] - 1):
            carry_s = ring_shift(carry_s, mesh, axis)
            carry_i = ring_shift(carry_i, mesh, axis)
            carry_s, carry_i = _merge_topk(carry_s, carry_i, top_s, top_i, k)
        top_s, top_i = carry_s, carry_i

    if is_ll:
        top_s = apply_ll_normalizer(top_s, run_max, run_sum, mask)
    if dp > 1:
        Q = top_s.shape[0] * dp
        top_s = all_gather(top_s, mesh, "data").reshape(Q, k)
        top_i = all_gather(top_i, mesh, "data").reshape(Q, k)
    return top_s, top_i
