"""K4: fused gather + exact rescore of chosen bins
(``csrc/gather_rescore.cu``).

``out[q, j*bw + l] = R[q] . M_binned[bin_idx[q, j], l]`` in fp32: only the
chosen bins' rows are read, and the gathered [Q, NB*bw, d] matrix never
reaches device memory. Port of ``sert_tpu/ops/gather_rescore.py``. As
there, R is rounded through M_binned's dtype before the fp32 products.

The kernel is bin-major: an inverse index built on the device groups the
(q, j) pairs by bin, and a persistent sweep reads each chosen bin once
and rescores it for every query that chose it. :func:`_plan` is its
shape-only plan (row chunks, pairs a pass, shared memory, grid, scratch).

A CUDA tensor goes to the kernel, a CPU tensor to
:func:`gather_rescore_plain` (index-select + einsum, the kernel's oracle).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sert_tpu_torch.ops import _build
from sert_tpu_torch.utils import debug

_KERNELS = {torch.float32: "sert_gather_rescore_f32",
            torch.bfloat16: "sert_gather_rescore_bf16"}

# Kernel launches since the last reset (see score_binmax.launches).
launches = 0

THREADS = 256              # the sweep's block (csrc/gather_rescore.cu)
PAIRS_PER_THREAD = 8       # accumulators a thread carries through a pass
PAIR_IDS = 256             # pair ids an item stages beside its rows
STAGE_BYTES = 128 * (128 + 4) * 4   # a stage's rows: a 128-row fp32 bin at d 128
R_BYTES = 32 << 10         # R rows staged a pass, where all of R does not fit
SMEM_LIMIT = 232_448       # shared memory a block may use on the H100
SM_SMEM = 233_472          # an SM's, of which 1 KB a block is reserved


class Plan(NamedTuple):
    """K4's launch, from the shapes alone. The kernel takes rows,
    pairs_per_pass, resident and blocks, and derives the rest itself; the
    derived fields here mirror it, to size the grid and for the tests."""
    rows: int              # rows of a bin staged at once (a row chunk)
    chunks: int            # row chunks a bin
    npl: int               # pair lanes: THREADS // rows threads a row
    pairs_per_pass: int    # pairs a pass, <= npl * PAIRS_PER_THREAD
    m_bytes: int           # a stage's rows
    stage_bytes: int       # a stage: its rows and PAIR_IDS pair ids
    resident: bool         # all of R in shared memory, loaded once a block
    smem: int              # dynamic shared memory of a block
    blocks: int            # persistent blocks
    scratch: int           # int32 entries of the inverse index


def gather_rescore_plain(R: torch.Tensor, M_binned: torch.Tensor,
                         bin_idx: torch.Tensor) -> torch.Tensor:
    """Materializes the [Q, NB*bw, d] gather, then one batched product."""
    Q, NB = bin_idx.shape
    _, bw, d = M_binned.shape
    Mg = M_binned.index_select(0, bin_idx.reshape(-1).long())
    Mg = Mg.reshape(Q, NB * bw, d).float()
    r = R.to(M_binned.dtype).float()
    return torch.einsum("qd,qnd->qn", r, Mg)


def _plan(Q: int, NB: int, n_bins: int, bw: int, d: int, elem: int,
          sms: int) -> Plan:
    """Row chunks of at most STAGE_BYTES (rows padded by 4 elements against
    bank conflicts; a multiple of 32 when a bin takes several, so that a
    warp shares one pair lane), pair lanes for the threads left over, R
    resident where it fits beside two stages (else staged a pass at a time
    within R_BYTES), and as many blocks as fit an SM's shared memory (up to
    4), times ``sms``, but no more than the items can use."""
    row_bytes = (d + 4) * elem
    rows = max(1, min(bw, THREADS, STAGE_BYTES // row_bytes))
    if 32 <= rows < bw:
        rows -= rows % 32
    m_bytes = -(-rows * row_bytes // 16) * 16
    stage = m_bytes + 4 * PAIR_IDS
    npl = THREADS // rows
    resident = 2 * stage + 4 * Q * d <= SMEM_LIMIT
    if resident:
        pp, r_bytes = npl * PAIRS_PER_THREAD, 4 * Q * d
    else:
        pp = max(1, min(npl * PAIRS_PER_THREAD, R_BYTES // (4 * d)))
        r_bytes = 4 * pp * d
    smem = 2 * stage + r_bytes
    if smem > SMEM_LIMIT:
        raise ValueError(f"K4 cannot stage rows of width {d}: {smem} bytes "
                         f"of shared memory a block, over {SMEM_LIMIT}")
    chunks = -(-bw // rows)
    per_sm = max(1, min(4, SM_SMEM // (smem + 1024)))
    blocks = min(sms * per_sm, n_bins * chunks, Q * NB * chunks)
    return Plan(rows, chunks, npl, pp, m_bytes, stage, resident, smem,
                blocks, 4 * n_bins + Q * NB + 1)


def _launch(R: torch.Tensor, M_binned: torch.Tensor,
            bin_idx: torch.Tensor) -> torch.Tensor:
    global launches
    dev = R.device
    Q, d = R.shape
    NB = bin_idx.shape[1]
    n_bins, bw, dm = M_binned.shape
    if M_binned.dtype not in _KERNELS or not M_binned.is_contiguous():
        raise ValueError("K4 takes a contiguous fp32 or bf16 M_binned")
    if M_binned.device != dev or bin_idx.device != dev:
        raise ValueError(f"R, M_binned and bin_idx must all be on {dev}")
    if dm != d or d % 4:
        raise ValueError(f"K4 needs R and M_binned of one width, a multiple "
                         f"of 4 (got {d} and {dm})")
    if bin_idx.dtype != torch.int32 or bin_idx.shape[0] != Q:
        raise ValueError(f"bin_idx must be int32 [{Q}, NB]")
    r = R.to(M_binned.dtype).float().contiguous()
    idx = bin_idx.contiguous()
    out = torch.empty((Q, NB * bw), dtype=torch.float32, device=dev)
    if Q == 0 or NB == 0:
        return out
    plan = _plan(Q, NB, n_bins, bw, d, M_binned.element_size(),
                 torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.kernel(_KERNELS[M_binned.dtype])(
            r.data_ptr(), M_binned.data_ptr(), idx.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), Q, NB, n_bins, bw, d,
            plan.rows, plan.pairs_per_pass, int(plan.resident), plan.blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gather_rescore")
    launches += 1
    debug.kernel_outputs("gather_rescore", out)
    return out


def gather_rescore(R: torch.Tensor, M_binned: torch.Tensor,
                   bin_idx: torch.Tensor) -> torch.Tensor:
    """[Q, NB*bw] exact fp32 scores of the selected bins.

    R [Q, d], M_binned [n_bins, bw, d] (ops.exact_topk.prepare_entities),
    bin_idx [Q, NB] int32 in [0, n_bins). The kernel turns an index
    outside that range into NaN scores; the plain version raises."""
    if R.device.type == "cpu":
        return gather_rescore_plain(R, M_binned, bin_idx)
    if R.device.type != "cuda":
        raise ValueError(f"gather_rescore runs on cpu or cuda, not "
                         f"{R.device}")
    return _launch(R, M_binned, bin_idx)
