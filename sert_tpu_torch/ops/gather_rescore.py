"""K4: fused gather + exact rescore of chosen bins
(``csrc/gather_rescore.cu``).

``out[q, j*bw + l] = R[q] . M_binned[bin_idx[q, j], l]`` in fp32: each query
reads only the rows of its own bins, and the gathered [Q, NB*bw, d] matrix
never reaches device memory. Port of ``sert_tpu/ops/gather_rescore.py``.
As there, R is rounded through M_binned's dtype before the fp32 products.

A CUDA tensor goes to the kernel, a CPU tensor to
:func:`gather_rescore_plain` (index-select + einsum, the kernel's oracle).
"""

from __future__ import annotations

import torch

from sert_tpu_torch.ops import _build

_KERNELS = {torch.float32: "sert_gather_rescore_f32",
            torch.bfloat16: "sert_gather_rescore_bf16"}

# Kernel launches since the last reset (see score_binmax.launches).
launches = 0


def gather_rescore_plain(R: torch.Tensor, M_binned: torch.Tensor,
                         bin_idx: torch.Tensor) -> torch.Tensor:
    """Materializes the [Q, NB*bw, d] gather, then one batched product."""
    Q, NB = bin_idx.shape
    _, bw, d = M_binned.shape
    Mg = M_binned.index_select(0, bin_idx.reshape(-1).long())
    Mg = Mg.reshape(Q, NB * bw, d).float()
    r = R.to(M_binned.dtype).float()
    return torch.einsum("qd,qnd->qn", r, Mg)


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
    with torch.cuda.device(dev):
        err = _build.kernel(_KERNELS[M_binned.dtype])(
            r.data_ptr(), M_binned.data_ptr(), idx.data_ptr(),
            out.data_ptr(), Q, NB, n_bins, bw, d,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gather_rescore")
    launches += 1
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
