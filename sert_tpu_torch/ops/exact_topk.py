"""Exact top-k via the bin-max prefilter (K3) + gather-rescore (K4)
(port of ``sert_tpu/ops/exact_topk.py``).

  1. bins = score_binmax(R, M)                       # [Q, ceil(E/bw)], K3
  2. Every bin holding a true top-k element has bin max >= theta (the k-th
     score), and at most k bins do, so the top (k + pad) bins by max hold
     every true top-k element.
  3. Rescore exactly (fp32) only those bins' entities (K4), then one top-k
     over [Q, (k + pad) * bw].

Precision: the default prefilter multiplies in bf16, so "exact" holds for
margins above bf16 resolution (~4e-3 relative); ``pad_bins`` absorbs
boundary reshuffles, and ``prepare_entities(..., prefilter_dtype=
"float32")`` makes the prefilter fp32-class (K3's fp32 mode, 3xTF32 on the
card; twice the staged bytes). The returned scores are always the fp32
rescores. Exact ties beyond the pad can trade one tied entity for another.

Staging options, as in the reference: ``bin_width`` 64 or 128;
``layout="clustered"`` orders the rows by a coarse spherical k-means so a
query's winners share bins (the permutation is undone on the returned
ids); ``adaptive_bins`` rescores only that many top bins first and falls
back to the full rescore unless the result is provably exact;
``fused_rescore=False`` rescores by a plain gather and a batched product
(the reference's XLA path) in place of K4.
``hierarchical_topk`` is an XLA-side trick, not a kernel: ``torch.topk``
takes its place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sert_tpu_torch.ops.gather_rescore import (gather_rescore,
                                               gather_rescore_plain)
from sert_tpu_torch.ops.score_binmax import (LANES, pad_dim,
                                             prepare_binmax_matrix,
                                             score_binmax_prepared)


class PreparedEntities(NamedTuple):
    """The entity matrix staged once for repeated sweeps, both on the
    device: the prefilter operand (bf16, or fp32) and the bin-major rescore
    copy, each feature-padded to the same width. Under
    ``layout="clustered"`` row r of both is M[perm[r]]."""
    Mp: torch.Tensor        # [E, dp] prefilter dtype
    M_binned: torch.Tensor  # [n_bins, bin_width, dp] rescore dtype
    num_entities: int
    dim: int
    bin_width: int = LANES
    perm: Optional[torch.Tensor] = None    # [E] int64, clustered layout


def _cluster_order(M: torch.Tensor, n_clusters: Optional[int] = None,
                   iters: int = 8, sample: int = 1 << 16, seed: int = 0,
                   centroid_idx: Optional[torch.Tensor] = None,
                   sample_idx: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[E] int64 permutation grouping directionally similar rows: a coarse
    spherical k-means on a subsample, then a stable sort by assignment.

    ``n_clusters`` defaults to ~E/128 (at least 256, at most 8192), so a
    cluster is about one bin wide. The initial centroids and the
    subsample are draws without replacement from a CPU ``torch.Generator``
    seeded with ``seed`` (the same on either device); ``centroid_idx`` /
    ``sample_idx`` replace them (the tests inject the reference's
    ``jax.random`` draws). A centroid's sum is an ordered segment sum after
    a stable sort (no float atomics), so two stagings give the same
    permutation; an empty cluster keeps its centroid."""
    E = M.shape[0]
    dev = M.device
    if n_clusters is None:
        n_clusters = min(8192, max(256, E // LANES))
    gen = torch.Generator().manual_seed(seed)
    if centroid_idx is None:
        centroid_idx = torch.randperm(E, generator=gen)[:min(n_clusters, E)]
    if sample_idx is None:
        sample_idx = torch.randperm(E, generator=gen)[:min(sample, E)]
    Xn = M.float()
    Xn = Xn / Xn.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    C = Xn[centroid_idx.to(dev).long()]
    sub = Xn[sample_idx.to(dev).long()]
    ids = torch.arange(C.shape[0], device=dev)
    for _ in range(iters):
        a, order = torch.sort(_assign_chunked(sub, C), stable=True)
        cnt = (torch.searchsorted(a, ids, right=True)
               - torch.searchsorted(a, ids))
        tot = torch.segment_reduce(sub[order], "sum", lengths=cnt, axis=0,
                                   unsafe=True)
        Cn = tot / cnt.clamp(min=1)[:, None].float()
        # an empty cluster keeps its previous centroid
        C = torch.where(cnt[:, None] > 0, Cn, C)
        C = C / C.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    return torch.sort(_assign_chunked(Xn, C), stable=True).indices


def _assign_chunked(X: torch.Tensor, C: torch.Tensor,
                    slab: int = 1 << 15) -> torch.Tensor:
    """argmax(X @ C^T, dim=1) in row slabs: the whole [n, C] at E = 1M x
    8192 clusters would be a 31 GB temporary. fp32 products (TF32 must be
    off on the card)."""
    return torch.cat([torch.argmax(X[lo:lo + slab] @ C.T, dim=1)
                      for lo in range(0, X.shape[0], slab)])


# "auto" rescore dtype: fp32 until the staged fp32 rescore copy alone would
# exceed this many bytes, then bf16. Sized for an 80 GB H100: serving holds
# the fp32 params (4 bytes per entity element), the bf16 sweep copy (2) and
# the rescore copy (4 in fp32), 10 bytes per element in all; at the 16 GiB
# limit (E = 32M at d = 128) that is ~40 GiB, half the card, leaving the
# rest for transient scores and a co-resident trainer. Past it the bf16
# copy keeps E = 64M within the same share. (The reference's 2 GiB limit
# was sized for a 16 GB TPU.)
RESCORE_AUTO_FP32_LIMIT = 16 << 30

# Bins rescored beyond k: absorbs the bf16 prefilter's reshuffles at the
# k-boundary (the reference's default).
PAD_BINS = 12

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_rescore_dtype(choice: str, num_entities: int, dim: int) -> str:
    """"auto" -> "float32" below RESCORE_AUTO_FP32_LIMIT staged bytes, else
    "bfloat16"; explicit choices pass through (validated)."""
    if choice == "auto":
        return ("bfloat16"
                if num_entities * dim * 4 > RESCORE_AUTO_FP32_LIMIT
                else "float32")
    if choice not in _DTYPES:
        raise ValueError(f"unknown rescore_dtype {choice!r}")
    return choice


def prepare_entities(M: torch.Tensor, rescore_dtype: str = "float32",
                     prefilter_dtype: str = "bfloat16",
                     bin_width: int = LANES, layout: str = "natural"
                     ) -> PreparedEntities:
    """Stage M [E, d] on its device for :func:`exact_topk_prepared`.

    ``prefilter_dtype`` "float32" stages K3's operand in fp32 (its fp32
    mode). ``bin_width``: entities a bin (64 or 128). ``layout=
    "clustered"`` permutes the rows by :func:`_cluster_order`; results are
    exact under either layout."""
    if prefilter_dtype not in _DTYPES:
        raise ValueError(f"unknown prefilter_dtype {prefilter_dtype!r}")
    E, d = M.shape
    perm = None
    if layout == "clustered":
        perm = _cluster_order(M)
        M = M[perm]
    elif layout != "natural":
        raise ValueError(f"unknown layout {layout!r}")
    Mp = prepare_binmax_matrix(M, _DTYPES[prefilter_dtype])
    rows = -(-E // bin_width) * bin_width
    M_binned = F.pad(pad_dim(M.to(_DTYPES[rescore_dtype]), Mp.shape[1]),
                     (0, 0, 0, rows - E))
    M_binned = M_binned.reshape(-1, bin_width, Mp.shape[1]).contiguous()
    return PreparedEntities(Mp, M_binned, E, d, bin_width, perm)


# The adaptive rescore's acceptance slack, relative, by prefilter dtype: a
# bin max rounds in the prefilter's dtype while theta is an fp32 rescore, so
# an unrescored bin whose true max sits within that rounding of theta could
# round below it. bf16: the reference's 2^-7, twice bf16's ~4e-3 model.
# fp32: K3's fp32 mode (3xTF32) errs from fp64 by up to 6.98e-6 of a
# query's top bin max on the H100 (unit rows, E 1M, d 672, its widest; the
# tensor cores' fp32 sums truncate, so the error grows with d), past the
# reference's 2^-20, so the slack is 2^-14 (6.1e-5, 8.7x the largest
# reading; chip_smoke.py and the card tests fail past a quarter of it). A
# wider margin only costs a fallback, never exactness.
ADAPTIVE_EPS = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -14}


def exact_topk_prepared(R: torch.Tensor, prep: PreparedEntities,
                        bias: Optional[torch.Tensor] = None,
                        alpha: Optional[torch.Tensor] = None,
                        k: int = 100, pad_bins: int = PAD_BINS,
                        fused_rescore: bool = True,
                        adaptive_bins: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] fp32, entity ids [Q, k] int64) of R @ M^T
    (+ alpha * bias), best first. ``bias`` is in the original entity order
    under either layout.

    ``fused_rescore=False`` rescores the chosen bins by a gather and one
    batched product (``gather_rescore_plain``) in place of K4.

    ``adaptive_bins=na`` (0 < na < k + pad_bins) makes the rescore
    two-phase: rescore the top ``na`` bins, take the provisional k-th score
    theta, and accept iff every query's (na+1)-th bin max is below theta
    less the prefilter dtype's slack (:data:`ADAPTIVE_EPS`): any element of
    an unrescored bin is then provably below k rescored candidates. Else
    the whole batch falls back to the full k + pad_bins rescore. The
    decision is one host branch on a device bool, so an adaptive call costs
    one device sync."""
    Q = R.shape[0]
    E, bw = prep.num_entities, prep.bin_width
    k = min(k, E)
    if adaptive_bins > 0 and adaptive_bins * bw < k:
        raise ValueError(
            f"adaptive_bins={adaptive_bins} x bin_width={bw} yields only "
            f"{adaptive_bins * bw} phase-1 candidates < k={k}; raise "
            f"adaptive_bins to at least {-(-k // bw)} (or 0 to disable "
            "the two-phase rescore)")
    # Clustered staging permuted the rows; the bias pairs with them in
    # both kernels, so it is permuted once here.
    if prep.perm is not None and bias is not None:
        bias = bias[prep.perm]
    R = pad_dim(R.float(), prep.Mp.shape[1])
    bins = score_binmax_prepared(R, prep.Mp, E, bias, alpha, bin_width=bw)
    nb = min(k + pad_bins, bins.shape[1])
    bin_vals, bin_idx = torch.topk(bins, nb, dim=1)           # [Q, nb]

    def rescore_select(nbx: int):
        """Exact rescore of the top ``nbx`` bins, then the final top k."""
        bi = bin_idx[:, :nbx]
        if fused_rescore:
            sc = gather_rescore(R, prep.M_binned, bi.int())   # [Q, nbx*bw]
        else:
            sc = gather_rescore_plain(R, prep.M_binned, bi)
        ent_idx = (bi[:, :, None] * bw
                   + torch.arange(bw, device=R.device)).reshape(Q, nbx * bw)
        if bias is not None:    # already in staged order
            a = (alpha.float() if alpha is not None
                 else torch.ones(Q, device=R.device))
            sc = sc + a[:, None] * bias.float()[ent_idx.clamp(max=E - 1)]
        sc = sc.masked_fill(ent_idx >= E, float("-inf"))
        # Positions -> entity ids arithmetically: pos = j * bw + l.
        top_s, pos = torch.topk(sc, k, dim=1)
        return top_s, torch.gather(bi, 1, pos // bw) * bw + pos % bw

    if 0 < adaptive_bins < nb:
        top_s, top_i = rescore_select(adaptive_bins)
        theta = top_s[:, -1]
        eps = ADAPTIVE_EPS[prep.Mp.dtype]
        scale = torch.maximum(bin_vals[:, 0].abs(), theta.abs())
        need_more = torch.any(
            bin_vals[:, adaptive_bins:] >= (theta - eps * scale)[:, None])
        if bool(need_more):                                   # a host sync
            top_s, top_i = rescore_select(nb)
    else:
        top_s, top_i = rescore_select(nb)
    if prep.perm is not None:   # undo the clustered staging permutation
        top_i = prep.perm[top_i.clamp(max=E - 1)]
    return top_s, top_i


def exact_topk(R: torch.Tensor, M: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               alpha: Optional[torch.Tensor] = None,
               k: int = 100, pad_bins: int = PAD_BINS,
               rescore_dtype: str = "float32",
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot convenience: prepare_entities + exact_topk_prepared."""
    prep = prepare_entities(M, rescore_dtype=rescore_dtype)
    return exact_topk_prepared(R, prep, bias, alpha, k=k, pad_bins=pad_bins)
