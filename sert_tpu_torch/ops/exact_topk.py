"""Exact top-k via the bin-max prefilter (K3) + gather-rescore (K4)
(port of ``sert_tpu/ops/exact_topk.py``).

  1. bins = score_binmax(R, M)                       # [Q, ceil(E/bw)], K3
  2. Every bin holding a true top-k element has bin max >= theta (the k-th
     score), and at most k bins do, so the top (k + pad) bins by max hold
     every true top-k element.
  3. Rescore exactly (fp32) only those bins' entities (K4), then one top-k
     over [Q, (k + pad) * bw].

Precision: the prefilter multiplies in bf16, so "exact" holds for margins
above bf16 resolution (~4e-3 relative); ``pad_bins`` absorbs boundary
reshuffles. The returned scores are always the fp32 rescores. Exact ties
beyond the pad can trade one tied entity for another.

Not ported yet (ROADMAP Queue 1 item 11): the clustered layout, the
two-phase ``adaptive_bins`` rescore, the fp32 prefilter and the unfused
(gather-then-einsum) rescore.
``hierarchical_topk`` is an XLA-side trick, not a kernel: ``torch.topk``
takes its place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sert_tpu_torch.ops.gather_rescore import gather_rescore
from sert_tpu_torch.ops.score_binmax import (LANES, pad_dim,
                                             prepare_binmax_matrix,
                                             score_binmax_prepared)


class PreparedEntities(NamedTuple):
    """The entity matrix staged once for repeated sweeps, both on the
    device: the bf16 prefilter operand and the bin-major rescore copy, each
    feature-padded to the same width."""
    Mp: torch.Tensor        # [E, dp] bf16
    M_binned: torch.Tensor  # [n_bins, bin_width, dp] rescore dtype
    num_entities: int
    dim: int
    bin_width: int = LANES


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
                     bin_width: int = LANES,
                     layout: str = "natural") -> PreparedEntities:
    """Stage M [E, d] on its device for :func:`exact_topk_prepared`."""
    if layout == "clustered":
        raise NotImplementedError(
            "layout='clustered' is not ported yet (ROADMAP Queue 1 item 11)")
    if layout != "natural":
        raise ValueError(f"unknown layout {layout!r}")
    E, d = M.shape
    Mp = prepare_binmax_matrix(M)
    rows = -(-E // bin_width) * bin_width
    M_binned = F.pad(pad_dim(M.to(_DTYPES[rescore_dtype]), Mp.shape[1]),
                     (0, 0, 0, rows - E))
    M_binned = M_binned.reshape(-1, bin_width, Mp.shape[1]).contiguous()
    return PreparedEntities(Mp, M_binned, E, d, bin_width)


def exact_topk_prepared(R: torch.Tensor, prep: PreparedEntities,
                        bias: Optional[torch.Tensor] = None,
                        alpha: Optional[torch.Tensor] = None,
                        k: int = 100, pad_bins: int = PAD_BINS,
                        adaptive_bins: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] fp32, entity ids [Q, k] int64) of R @ M^T
    (+ alpha * bias), best first."""
    if adaptive_bins > 0:
        raise NotImplementedError(
            "adaptive_bins is not ported yet: the engine rescores all "
            "k + pad_bins bins (ROADMAP Queue 1 item 11)")
    Q = R.shape[0]
    E, bw = prep.num_entities, prep.bin_width
    k = min(k, E)
    R = pad_dim(R.float(), prep.Mp.shape[1])
    bins = score_binmax_prepared(R, prep.Mp, E, bias, alpha, bin_width=bw)
    nb = min(k + pad_bins, bins.shape[1])
    bin_idx = torch.topk(bins, nb, dim=1).indices             # [Q, nb]

    sc = gather_rescore(R, prep.M_binned, bin_idx.int())      # [Q, nb*bw]
    ent_idx = (bin_idx[:, :, None] * bw
               + torch.arange(bw, device=R.device)).reshape(Q, nb * bw)
    if bias is not None:
        a = (alpha.float() if alpha is not None
             else torch.ones(Q, device=R.device))
        sc = sc + a[:, None] * bias.float()[ent_idx.clamp(max=E - 1)]
    sc = sc.masked_fill(ent_idx >= E, float("-inf"))

    # Positions -> entity ids arithmetically: pos = j * bw + l.
    top_s, pos = torch.topk(sc, k, dim=1)
    sel_bin = torch.gather(bin_idx, 1, pos // bw)
    return top_s, sel_bin * bw + pos % bw


def exact_topk(R: torch.Tensor, M: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               alpha: Optional[torch.Tensor] = None,
               k: int = 100, pad_bins: int = PAD_BINS,
               rescore_dtype: str = "float32",
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot convenience: prepare_entities + exact_topk_prepared."""
    prep = prepare_entities(M, rescore_dtype=rescore_dtype)
    return exact_topk_prepared(R, prep, bias, alpha, k=k, pad_bins=pad_bins)
