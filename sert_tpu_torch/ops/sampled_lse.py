"""K1 + K2: masked log-sum-exp over shared sampled-softmax candidates
(``csrc/sampled_lse.cu``), port of ``sert_tpu/ops/sampled_lse.py``.

    out_i = logsumexp_j { reps_i . cand_j - corr_j : cand_ids_j != pos_ids_i }

:func:`sampled_lse` is differentiable in reps, cand and corr. On CUDA
tensors it is a ``torch.autograd.Function`` whose forward launches K1 and
whose backward launches K2; the [B, k] logits never reach device memory.
On CPU tensors it is :func:`sampled_lse_plain`, the same arithmetic in plain
PyTorch with autograd's gradient, which is also the kernels' oracle on the
card. Both round where the reference does: reps and candidates to the
compute dtype, fp32 products, and the probabilities to the compute dtype
before the dC and dreps products. A row whose every candidate is masked
gives ~-1e30 (the softplus loss then has gradient exactly 0).

The kernels are three modes of one warp-specialized sweep: a block keeps a
resident tile of 128 rows (X) and streams the other operand's tiles (Y)
through a TMA-fed ring. K1 and K2's dreps sweep take a batch tile of R as X
and one chunk of C's tiles as Y; K2's dC sweep a candidate tile of C as X
and one slice of R's batch tiles as Y. How the Y tiles split into chunks
and slices is :func:`_plan`, from the shapes alone (so two calls give the
same bits), chosen to fill the card's 132 SMs with one block each; the
wrapper merges K1's chunks and sums K2's partials.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sert_tpu_torch.ops import _build

DIM_MULTIPLE = 32   # the kernels' operand width multiple
MAX_DIM = 256       # widest padded d whose tiles fit the shared memory
X_ROWS = 128        # rows of a sweep's resident tile (two warpgroups of 64)
SMS = 132           # SMs of an H100; a sweep holds one block on each
BLOCK_FILL = 2      # a block's start-up (its resident tile, the ring's fill),
                    # in Y tiles, as the plan weighs it
MASKED = -1e30

# Kernel launches since the last reset (chip_smoke.py shows the training
# path went through the kernels with them): K1 and K2.
fwd_launches = 0
bwd_launches = 0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _compute_dtype(dtype: str) -> torch.dtype:
    if dtype not in _DTYPES:
        raise ValueError(f"sampled_lse dtype must be one of {sorted(_DTYPES)}"
                         f", got {dtype!r}")
    return _DTYPES[dtype]


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to
    ``dtype`` (the reference's rounding of p before its two products)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).float(), None


class _Round(torch.autograd.Function):
    """``x`` (wider than ``dtype``) rounded to ``dtype`` and held in fp32;
    the gradient passes back unrounded, in x's own dtype."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.in_dtype = x.dtype
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None


def _operand_fp32(x: torch.Tensor, ct: torch.dtype) -> torch.Tensor:
    if x.dtype == ct or ct == torch.float32:
        return x.float()
    return _Round.apply(x, ct)


def sampled_lse_plain(reps: torch.Tensor, cand: torch.Tensor,
                      corr: torch.Tensor, cand_ids: torch.Tensor,
                      pos_ids: torch.Tensor,
                      dtype: str = "float32") -> torch.Tensor:
    """[B] masked logsumexp in plain PyTorch; materializes [B, k]. On the
    card TF32 must be off for its fp32 products to be fp32."""
    ct = _compute_dtype(dtype)
    z = _operand_fp32(reps, ct) @ _operand_fp32(cand, ct).T
    if ct != torch.float32:
        z = _RoundGrad.apply(z, ct)
    z = z - corr.float()[None, :]
    hit = cand_ids.reshape(1, -1) == pos_ids.reshape(-1, 1)
    z = torch.where(hit, torch.full_like(z, MASKED), z)
    return torch.logsumexp(z, dim=-1)


def _width(dp: int) -> int:
    """The kernels' width for a padded d: 64, 128 or 256 (TMA zero-fills
    the columns between)."""
    return 64 if dp <= 64 else 128 if dp <= 128 else 256


def _ytile(ct: torch.dtype, dp: int) -> int:
    """Rows of a streamed Y tile, as csrc/sampled_lse.cu's Geom sizes it:
    narrower where the accumulator is wide, so that the registers and four
    stages (three for fp32 at 256) fit."""
    kw = _width(dp)
    if ct == torch.bfloat16:
        return 128 if kw <= 128 else 64
    return 128 if kw <= 64 else 64 if kw <= 128 else 32


class Sweep(NamedTuple):
    """One sweep's plan: ``n_x`` resident tiles of 128 rows, ``n_y`` streamed
    tiles of ``y_rows`` rows, split into ``parts`` runs of ``per`` tiles in
    order (the last may be shorter). ``parts * n_x`` blocks."""
    n_x: int
    n_y: int
    y_rows: int
    per: int
    parts: int

    @property
    def blocks(self) -> int:
        return self.n_x * self.parts


def _split(n_x: int, n_y: int, y_rows: int) -> Sweep:
    """The fewest parts whose blocks finish soonest, each block one SM's
    work in turn: rounds of SMS blocks times (tiles a block + its start-up).
    """
    best, best_cost = 1, None
    for c in range(1, n_y + 1):
        per = -(-n_y // c)
        cost = -(-(n_x * c) // SMS) * (per + BLOCK_FILL)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    per = -(-n_y // best)
    return Sweep(n_x, n_y, y_rows, per, -(-n_y // per))


def _plan(B: int, k: int, d: int, dtype: str = "bfloat16"):
    """(K1's and the dreps sweep's plan, the dC sweep's plan) for B rows, k
    candidates and width d in ``dtype``, from the shapes alone. K1 / dreps:
    batch tiles resident, candidate tiles in chunks; dC: candidate tiles
    resident, batch tiles in slices (many where k is small: k = 256 leaves
    two candidate tiles for 132 SMs)."""
    dp = -(-d // DIM_MULTIPLE) * DIM_MULTIPLE
    yr = _ytile(_compute_dtype(dtype), dp)
    fwd = _split(-(-B // X_ROWS), -(-k // yr), yr)
    dc = _split(-(-k // X_ROWS), -(-B // yr), yr)
    return fwd, dc


def _operand(x: torch.Tensor, ct: torch.dtype, dp: int) -> torch.Tensor:
    """A contiguous [rows, dp] copy in the compute dtype, 16-byte aligned."""
    x = x.to(ct)
    if x.shape[1] != dp:
        x = F.pad(x, (0, dp - x.shape[1]))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(reps, cand, corr, cand_ids, pos_ids):
    dev = reps.device
    B, d = reps.shape
    k = cand.shape[0]
    if cand.shape[1] != d or corr.shape != (k,) or cand_ids.shape != (k,) \
            or pos_ids.shape != (B,):
        raise ValueError(
            f"sampled_lse shapes: reps [B, d], cand [k, d], corr [k], "
            f"cand_ids [k], pos_ids [B]; got {tuple(reps.shape)}, "
            f"{tuple(cand.shape)}, {tuple(corr.shape)}, "
            f"{tuple(cand_ids.shape)}, {tuple(pos_ids.shape)}")
    for name, t in (("cand", cand), ("corr", corr), ("cand_ids", cand_ids),
                    ("pos_ids", pos_ids)):
        if t.device != dev:
            raise ValueError(f"sampled_lse: {name} on {t.device}, reps on "
                             f"{dev}")
    if not (reps.is_floating_point() and cand.is_floating_point()):
        raise ValueError("sampled_lse: reps and cand must be floating")
    if cand_ids.is_floating_point() or pos_ids.is_floating_point():
        raise ValueError("sampled_lse: ids must be integers")
    problem = kernel_limits(B, k, d)
    if problem:
        raise ValueError(problem)
    return B, k, d, -(-d // DIM_MULTIPLE) * DIM_MULTIPLE


def kernel_limits(B: int, k: int, d: int):
    """None when the K1/K2 kernels take B rows, k candidates and width d;
    else what they refuse (models.common.use_fused gates on it)."""
    if B == 0 or k == 0:
        return "the K1/K2 kernels need at least one row and one candidate"
    dp = -(-d // DIM_MULTIPLE) * DIM_MULTIPLE
    if dp > MAX_DIM:
        return f"the K1/K2 kernels take d <= {MAX_DIM}, got {d}"
    if B >= 2 ** 31 // max(dp, 1) or k >= 2 ** 31 // max(dp, 1):
        return "sampled_lse: B * d and k * d must fit in int32"
    return None


def _sum_parts(part: torch.Tensor) -> torch.Tensor:
    """A plan's partials summed over their first axis (a fixed-order
    reduction, no atomics); one part is taken as it is."""
    return part[0] if part.shape[0] == 1 else part.sum(dim=0)


class _SampledLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, reps, cand, corr, cand_ids, pos_ids, dtype):
        global fwd_launches
        ct = _compute_dtype(dtype)
        B, k, d, dp = _check(reps, cand, corr, cand_ids, pos_ids)
        dev = reps.device
        R = _operand(reps.detach(), ct, dp)
        C = _operand(cand.detach(), ct, dp)
        co = corr.detach().float().contiguous()
        ids = cand_ids.to(torch.int32).contiguous()
        pos = pos_ids.to(torch.int32).contiguous()
        fwd, dc = _plan(B, k, d, dtype)
        m = torch.empty((fwd.parts, B), dtype=torch.float32, device=dev)
        s = torch.empty_like(m)
        with torch.cuda.device(dev):
            err = _build.kernel("sert_sampled_lse_fwd")(
                R.data_ptr(), C.data_ptr(), co.data_ptr(), ids.data_ptr(),
                pos.data_ptr(), m.data_ptr(), s.data_ptr(), B, k, dp,
                fwd.per, fwd.parts, fwd.y_rows, int(ct == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "sampled_lse forward (K1)")
        fwd_launches += 1
        M = m.amax(dim=0)
        lse = M + torch.log(torch.sum(s * torch.exp(m - M[None, :]), dim=0))
        ctx.save_for_backward(R, C, co, ids, pos, lse)
        ctx.meta = (ct, d, dp, fwd, dc, reps.dtype, cand.dtype)
        return lse

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        R, C, co, ids, pos, lse = ctx.saved_tensors
        ct, d, dp, fwd, dc, reps_dtype, cand_dtype = ctx.meta
        B, k = R.shape[0], C.shape[0]
        dev = R.device
        g = g.float().contiguous()
        dC = torch.empty((dc.parts, k, dp), dtype=torch.float32, device=dev)
        dcorr = torch.empty((dc.parts, k), dtype=torch.float32, device=dev)
        dreps = torch.empty((fwd.parts, B, dp), dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            err = _build.kernel("sert_sampled_lse_bwd")(
                R.data_ptr(), C.data_ptr(), co.data_ptr(), ids.data_ptr(),
                pos.data_ptr(), lse.data_ptr(), g.data_ptr(), dC.data_ptr(),
                dcorr.data_ptr(), dreps.data_ptr(), B, k, dp, fwd.per,
                fwd.parts, dc.per, dc.parts, fwd.y_rows,
                int(ct == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "sampled_lse backward (K2)")
        bwd_launches += 1
        return (_sum_parts(dreps)[:, :d].to(reps_dtype),
                _sum_parts(dC)[:, :d].to(cand_dtype), _sum_parts(dcorr),
                None, None, None)


def sampled_lse(reps: torch.Tensor, cand: torch.Tensor, corr: torch.Tensor,
                cand_ids: torch.Tensor, pos_ids: torch.Tensor,
                dtype: str = "float32") -> torch.Tensor:
    """[B] masked logsumexp of ``reps @ cand.T - corr`` over candidates
    whose id differs from the row's positive id.

    reps [B, d] and cand [k, d] (cand keeps its dtype; its gradient comes
    back in it), corr [k] fp32, cand_ids [k] and pos_ids [B] integer.
    ``dtype`` "bfloat16" multiplies bf16-rounded operands with fp32
    accumulation. CUDA tensors go through K1/K2, CPU tensors through
    :func:`sampled_lse_plain`."""
    if reps.device.type == "cpu":
        return sampled_lse_plain(reps, cand, corr, cand_ids, pos_ids, dtype)
    if reps.device.type != "cuda":
        raise ValueError(f"sampled_lse runs on cpu or cuda, not "
                         f"{reps.device}")
    return _SampledLse.apply(reps, cand, corr, cand_ids, pos_ids, dtype)
