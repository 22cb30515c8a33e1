"""K3: fused scoring + bin-max sweep (``csrc/score_binmax.cu``).

``out[q, b] = max_{l < bw} S[q, b*bw + l]`` with
``S = R @ M^T (+ alpha_q * bias_e)``, inputs in the dtype ``Mp`` was staged
in (bf16, or fp32 for a full-precision prefilter) and fp32 accumulation;
the [Q, E] score matrix never reaches device memory. Port of
``sert_tpu/ops/score_binmax.py``; the kernel's source note says what it
replaces and what bounds it on the H100.

A CUDA tensor goes to the kernel, a CPU tensor to :func:`score_binmax_plain`
(the same arithmetic in plain PyTorch, and the kernel's oracle on the card).
Both modes are a persistent sweep: TMA streams the entity tiles, wgmma
scores them against the resident query tile, and the bin maxima are taken
from the accumulator registers. The fp32 mode runs its products as 3xTF32
(each consumer warpgroup splits the landed M tiles into TF32 parts, R's
parts are split in registers), on the ring :func:`_plan_f32` sizes.
Entities past ``num_entities`` are -inf in both, so a partial tail bin holds
the max over its valid entities only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from sert_tpu_torch.ops import _build
from sert_tpu_torch.utils import debug

LANES = 128          # default bin width; the kernel's entity tile is 128
DIM_MULTIPLE = 16    # the bf16 tensor-core fragment depth
MAX_DIM = 512        # widest d: the resident R tile (8 sub-tiles of 64
                     # columns) and the ring fit 227 KB of shared memory
# The fp32 mode's widest d: its resident 64 query rows of d (in sub-tiles of
# 32 floats), one consumer warpgroup's lo buffer and two ring stages fit 227
# KB of shared memory up to d = 672 (_plan_f32).
MAX_DIM_F32 = 672
SMEM_LIMIT = 232_448        # shared memory a block may take on the H100
F32_COLS = 32               # fp32 columns of a 128-byte sub-tile
R_SUB_BYTES = 64 * 128      # a sub-tile of the 64 resident query rows
M_SUB_BYTES = 128 * 128     # a sub-tile of a 128-row entity tile: a ring
                            # stage, or a consumer's lo buffer
F32_MAX_STAGES = 4          # ring stages a consumer warpgroup, at most
_MAX_DIM = {torch.bfloat16: MAX_DIM, torch.float32: MAX_DIM_F32}
_KERNELS = {torch.bfloat16: "sert_score_binmax",
            torch.float32: "sert_score_binmax_f32"}

# Kernel launches since the last reset, of the bf16 mode and of the fp32
# mode (chip_smoke.py shows the serving path went through the kernel with
# them).
launches = 0
f32_launches = 0


class PlanF32(NamedTuple):
    consumers: int      # consumer warpgroups, taking entity tiles in turn
    stages: int         # ring stages each
    smem: int           # dynamic shared memory of a block, bytes


def _smem_f32(nsub: int, consumers: int, stages: int) -> int:
    """R's sub-tiles, each consumer's stages and lo buffer, the barriers
    (a full and an empty one a stage, one for R): the kernel's layout."""
    return (nsub * R_SUB_BYTES + consumers * (stages + 1) * M_SUB_BYTES
            + (2 * consumers * stages + 1) * 8)


def _plan_f32(d: int) -> PlanF32:
    """The fp32 mode's ring for rows of width d, from d alone: two
    consumer warpgroups (one splits while the other multiplies) while each
    keeps two stages beside the resident R rows, else one; each as many
    stages as fit, up to F32_MAX_STAGES."""
    nsub = -(-d // F32_COLS)
    for consumers in (2, 1):
        room = SMEM_LIMIT - _smem_f32(nsub, consumers, 0)
        stages = min(F32_MAX_STAGES, room // (consumers * (M_SUB_BYTES + 16)))
        if stages >= 2:
            return PlanF32(consumers, stages,
                           _smem_f32(nsub, consumers, stages))
    raise ValueError(f"K3's fp32 mode cannot hold 64 rows of width {d} "
                     f"beside two ring stages in {SMEM_LIMIT} bytes")


def kernel_limits(d: int, dtype: torch.dtype = torch.bfloat16):
    """None when K3 takes entity rows of width d (padded to a multiple of
    16) staged in ``dtype``; else what it refuses
    (scoring.run.resolve_engine gates on it)."""
    if dtype not in _MAX_DIM:
        return f"K3 takes bf16 or fp32 rows, got {dtype}"
    dp = -(-d // DIM_MULTIPLE) * DIM_MULTIPLE
    if dp > _MAX_DIM[dtype]:
        return f"K3 takes a padded d <= {_MAX_DIM[dtype]} in {dtype}, got {dp}"
    return None


def pad_dim(x: torch.Tensor, dp: int) -> torch.Tensor:
    """Zero-pad the trailing (feature) axis to ``dp`` columns; zero columns
    leave every dot product unchanged."""
    pad = dp - x.shape[-1]
    return F.pad(x, (0, pad)) if pad > 0 else x


def prepare_binmax_matrix(M: torch.Tensor,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """One-time cast + feature pad of the entity matrix for the sweep: [E, dp]
    contiguous with dp a multiple of 16, in ``dtype`` (bf16, or fp32 for a
    full-precision prefilter). Keep it resident across calls."""
    dp = -(-M.shape[1] // DIM_MULTIPLE) * DIM_MULTIPLE
    return pad_dim(M.to(dtype), dp).contiguous()


def score_binmax_plain(R: torch.Tensor, Mp: torch.Tensor, num_entities: int,
                       bias: Optional[torch.Tensor] = None,
                       alpha: Optional[torch.Tensor] = None,
                       bin_width: int = LANES) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 products of the
    inputs rounded to ``Mp``'s dtype (TF32 must be off on the card), then
    the masked bin max. Materializes [Q, E]."""
    E, bw = num_entities, bin_width
    Q = R.shape[0]
    n_bins = -(-E // bw)
    R = pad_dim(R, Mp.shape[1]).to(Mp.dtype).float()
    s = R @ Mp[:E].float().T                                    # [Q, E]
    if bias is not None:
        a = (alpha.float() if alpha is not None
             else torch.ones(Q, device=R.device))
        s = s + a[:, None] * bias[:E].float()[None, :]
    s = F.pad(s, (0, n_bins * bw - E), value=float("-inf"))
    return s.view(Q, n_bins, bw).amax(dim=-1)


def _launch(R: torch.Tensor, Mp: torch.Tensor, E: int,
            bias: Optional[torch.Tensor], alpha: Optional[torch.Tensor],
            bw: int) -> torch.Tensor:
    global launches, f32_launches
    dev = R.device
    Q, d = R.shape
    if (Mp.dtype not in _KERNELS or not Mp.is_contiguous()
            or Mp.data_ptr() % 16):
        raise ValueError("the K3 kernel takes a contiguous bf16 or fp32 Mp "
                         "(prepare_binmax_matrix)")
    if Mp.device != dev or Mp.shape[0] < E:
        raise ValueError(f"Mp must be on {dev} with >= {E} rows")
    if d % DIM_MULTIPLE or kernel_limits(d, Mp.dtype):
        raise ValueError(f"K3 needs d % {DIM_MULTIPLE} == 0 and d <= "
                         f"{_MAX_DIM[Mp.dtype]} in {Mp.dtype}, got d={d}")
    if LANES % bw:
        raise ValueError(f"bin_width {bw} must divide {LANES}")
    Rb = R.to(Mp.dtype).contiguous()
    if bias is not None:
        if bias.device != dev or bias.shape[0] < E:
            raise ValueError(f"bias must be on {dev} with >= {E} entries")
        bias = bias.float().contiguous()
        if alpha is not None:
            if alpha.device != dev or alpha.shape != (Q,):
                raise ValueError(f"alpha must be [{Q}] on {dev}")
            alpha = alpha.float().contiguous()
    else:
        alpha = None            # alpha only scales the bias
    n_bins = -(-E // bw)
    out = torch.empty((Q, n_bins), dtype=torch.float32, device=dev)
    if Q == 0:
        return out
    plan = _plan_f32(d) if Mp.dtype == torch.float32 else ()
    with torch.cuda.device(dev):
        err = _build.kernel(_KERNELS[Mp.dtype])(
            Rb.data_ptr(), Mp.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            alpha.data_ptr() if alpha is not None else None,
            out.data_ptr(), Q, E, d, bw, n_bins, *plan,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "score_binmax")
    if Mp.dtype == torch.float32:
        f32_launches += 1
    else:
        launches += 1
    debug.kernel_outputs("score_binmax", out)
    return out


def score_binmax_prepared(R: torch.Tensor, Mp: torch.Tensor,
                          num_entities: int,
                          bias: Optional[torch.Tensor] = None,
                          alpha: Optional[torch.Tensor] = None,
                          bin_width: int = LANES) -> torch.Tensor:
    """[Q, ceil(E / bin_width)] bin maxima of R @ M^T (+ alpha * bias).

    ``Mp`` comes from :func:`prepare_binmax_matrix` (bf16, or fp32 for
    the fp32 mode); R [Q, d] is padded to its width and rounded to its
    dtype. bias [E] and alpha [Q] are optional (alpha defaults to ones when
    a bias is given)."""
    if num_entities < 1:
        raise ValueError("score_binmax needs at least one entity")
    if R.device.type == "cpu":
        return score_binmax_plain(R, Mp, num_entities, bias, alpha,
                                  bin_width)
    if R.device.type != "cuda":
        raise ValueError(f"score_binmax runs on cpu or cuda, not {R.device}")
    R = pad_dim(R, Mp.shape[1])
    return _launch(R, Mp, num_entities, bias, alpha, bin_width)


def score_binmax(R: torch.Tensor, M: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 alpha: Optional[torch.Tensor] = None,
                 bin_width: int = LANES) -> torch.Tensor:
    """One-shot: prepare M and sweep (tests); hot paths prepare once."""
    return score_binmax_prepared(R, prepare_binmax_matrix(M), M.shape[0],
                                 bias, alpha, bin_width)
