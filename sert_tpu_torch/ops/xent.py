"""K5 + K6 + K7: softmax cross-entropy over the whole entity axis
(``csrc/xent.cu``, ``csrc/xent_wgmma.cu``), port of
``sert_tpu/ops/xent.py`` (``xent_loss`` :293, ``_fwd_partials`` :270,
``_bwd_calls`` :364, ``xent_loss_apply`` :615, ``xent_bwd_apply`` :525).

    z_bj = pooled_b . W(j) + b_j
    loss = sum_b [ logsumexp_j z_bj - z_{b, y_b} ]

``W`` is the entity matrix in its storage layout: "de" = [d, E] (the
log-linear ``proj_w``) or "ed" = [E, d] (the LSE ``entity_emb``). On CUDA
tensors :func:`xent_loss` is a ``torch.autograd.Function`` whose forward
launches K5 (per-chunk (max, sumexp), merged here) and whose backward
launches K6 (dpooled, dW in W's layout, db), planned here from the shapes
alone; the [B, E] logits never reach device memory. The compute dtype picks
the sweep: bf16 runs the three modes of the warp-specialized TMA + wgmma
sweep of ``csrc/xent_wgmma.cu`` on a bf16 operand of W made once a forward
(:func:`_w_operand`; W itself where it is one already), fp32 the mma.sync
sweep of ``csrc/xent.cu``, which reads W in place, in its own dtype, never
copied or transposed. :func:`xent_lse` is the forward alone (the log-linear
query normalizer). On CPU tensors both are their plain versions
(:func:`xent_loss_plain`, :func:`xent_lse_plain`), which are also the
kernels' oracle on the card. Both round where the reference does: pooled and
W to the compute dtype, fp32 products and softmax, the gold logit a separate
fp32 sum of compute-dtype-rounded products, and p = softmax - onehot rounded
to the compute dtype before the dW and dpooled products.

:func:`xent_loss_apply` is the optimizer-in-backward step's loss: K5, then
K7, which is K6's dpooled sweep and then K6's dW sweep with adam, adagrad
or sgd applied to W (and its optimizer slots) where K6 would store dW
(or, where the dW sweep is split over the batch, in the ordered sum of
its slices), so dW never reaches device memory. Each compute dtype takes
K6's own sweeps (bf16: the wgmma sweep's DP mode, then its APPLY mode;
fp32: the mma.sync sweep's), so K6 and K7 give the same dpooled and dW
bit for bit. Its plain version is :func:`xent_loss_apply_plain`.

On a mesh each rank holds a block of the entity axis:
:func:`sharded_xent_loss` (K5, then K6, per block) and, where every rank
holds the whole batch, :func:`sharded_xent_apply` (K5, then K7, per
block; ``make_sharded_xent_apply`` :818), their blocks joined by a
:class:`Stitch`.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sert_tpu_torch.ops import _build
from sert_tpu_torch.ops.sampled_lse import (DIM_MULTIPLE, MAX_DIM, X_ROWS,
                                            _compute_dtype, _operand,
                                            _operand_fp32, _RoundGrad,
                                            _split, _sum_parts, _ytile)
from sert_tpu_torch.utils import debug

LAYOUTS = ("de", "ed")
# The mma.sync sweep's tile (K7 there sums G^2 per entity tile of TILE; the
# wgmma sweep's K7 per tile of X_ROWS).
TILE = 64
# K7's optimizers (their index is the kernel's code) and the state slots of
# each, shaped and typed as W; the constants are baked into the kernel as
# the reference bakes them (xent_bwd_apply :552-553).
OPTIMIZERS = ("adam", "adagrad", "sgd")
SLOTS = {"adam": ("m", "v"), "adagrad": ("acc",), "sgd": ()}
ADAM_B1, ADAM_B2, ADAM_EPS, ADAGRAD_EPS = 0.9, 0.999, 1e-8, 1e-7

# Kernel launches since the last reset (chip_smoke.py shows the training and
# scoring paths went through the kernels with them): K5, K6 and K7; and of
# each, those that took the bf16 route (the wgmma sweep).
fwd_launches = 0
bwd_launches = 0
apply_launches = 0
fwd_wgmma_launches = 0
bwd_wgmma_launches = 0
apply_wgmma_launches = 0


def _logits_plain(pooled, W, b, layout, ct):
    """[B, E] fp32 logits of the compute-dtype-rounded operands, with the
    incoming gradient rounded to ``ct`` (the reference's p cast)."""
    P, Wf = _operand_fp32(pooled, ct), _operand_fp32(W, ct)
    z = P @ Wf if layout == "de" else P @ Wf.T
    if ct != torch.float32:
        z = _RoundGrad.apply(z, ct)
    return z + b.float()


def xent_loss_plain(pooled: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                    labels: torch.Tensor, layout: str = "de",
                    dtype: str = "float32") -> torch.Tensor:
    """The SUM of the rows' softmax cross-entropies in plain PyTorch;
    materializes [B, E]. Autograd's gradient of it is softmax - onehot
    rounded to the compute dtype before both products. On the card TF32 must
    be off for its fp32 products to be fp32."""
    _check_layout(layout)
    z = _logits_plain(pooled, W, b, layout, _compute_dtype(dtype))
    gold = z.gather(1, labels.long()[:, None])[:, 0]
    return torch.sum(torch.logsumexp(z, dim=-1) - gold)


def xent_lse_plain(pooled: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                   layout: str = "de", dtype: str = "float32"
                   ) -> torch.Tensor:
    """[B] logsumexp over entities of pooled . W(j) + b_j, plain."""
    _check_layout(layout)
    return torch.logsumexp(
        _logits_plain(pooled, W, b, layout, _compute_dtype(dtype)), dim=-1)


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"xent layout must be one of {LAYOUTS}, got "
                         f"{layout!r}")


def _sweep_width(d: int, ct: torch.dtype) -> int:
    """d padded to the sweep's feature chunk, 128 bytes of a row: a multiple
    of 32 for fp32 products, of 64 for bf16 ones."""
    chunk = 128 // (torch.finfo(ct).bits // 8)
    return -(-d // chunk) * chunk


def _check(pooled, W, b, labels, layout, ct=torch.float32):
    """(B, E, d, dp, strides (sj, sk) of W(j, k)) after checking shapes,
    devices, dtypes and the kernels' limits; dp is the width P is padded to
    for compute dtype ``ct``."""
    _check_layout(layout)
    if pooled.dim() != 2 or W.dim() != 2:
        raise ValueError("xent: pooled [B, d] and W 2-D")
    B, d = pooled.shape
    E = W.shape[1] if layout == "de" else W.shape[0]
    wd = W.shape[0] if layout == "de" else W.shape[1]
    if wd != d or b.shape != (E,) or (labels is not None
                                      and labels.shape != (B,)):
        raise ValueError(
            f"xent shapes ({layout}): pooled [B, d], W "
            f"{'[d, E]' if layout == 'de' else '[E, d]'}, b [E], labels [B];"
            f" got {tuple(pooled.shape)}, {tuple(W.shape)}, "
            f"{tuple(b.shape)}, "
            f"{None if labels is None else tuple(labels.shape)}")
    for name, t in (("W", W), ("b", b), ("labels", labels)):
        if t is not None and t.device != pooled.device:
            raise ValueError(f"xent: {name} on {t.device}, pooled on "
                             f"{pooled.device}")
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xent: W must be float32 or bfloat16, got "
                         f"{W.dtype}")
    if not W.is_contiguous():
        raise ValueError("xent: W must be contiguous (the kernels read it "
                         "in place)")
    if not pooled.is_floating_point():
        raise ValueError("xent: pooled must be floating")
    if labels is not None and labels.is_floating_point():
        raise ValueError("xent: labels must be integers")
    problem = kernel_limits(B, E, d)
    if problem:
        raise ValueError(f"xent: {problem}")
    dp = _sweep_width(d, ct)
    strides = (1, E) if layout == "de" else (d, 1)
    return B, E, d, dp, strides


def kernel_limits(B: int, E: int, d: int):
    """None when the K5/K6/K7 kernels take B rows, E entities and width d;
    else what they refuse (train/fused.py gates on it)."""
    if B == 0 or E == 0:
        return "the kernels need at least one row and one entity"
    dp = -(-d // DIM_MULTIPLE) * DIM_MULTIPLE
    if dp > MAX_DIM:
        return f"the kernels take d <= {MAX_DIM}, got {d}"
    if B >= 2 ** 31 // dp or E >= 2 ** 31 - 64:
        return "B * d and E must fit in int32"
    return None


# The mma.sync sweep (csrc/xent.cu: K5, K6 and K7 in fp32 compute) holds two
# blocks an SM of an H100 (its shared memory and registers); each of its
# sweeps splits its loop axis into parts so that the grid is at most one
# round of such blocks.
K6_BLOCKS = 2 * 132
# The entity tiles a block of the dpooled sweep sums into its tensor-core
# accumulators before it adds them into its partial (in fp32) and starts
# them from zero. The accumulators' sums drift from the exact one in
# proportion to their length: at E 500k, d 256, B 1024 the one-card dpooled
# read 7.5e-5 (relative norm) from an fp64 one over whole chunks of 489
# tiles, 9.9e-6 over 64, 4.9e-6 over 32 and 2.5e-6 over 16
# (tools/dpooled_fp64.py on the H100; PERF.md §6).
DP_MAX_TILES = 32


def _k6_split(n_fixed: int, n_loop: int):
    """(tiles per part, parts) of a sweep whose grid is n_fixed tiles x
    parts of its n_loop looped tiles: as many parts as one round of
    K6_BLOCKS holds, at least one."""
    n = max(1, min(n_loop, K6_BLOCKS // n_fixed))
    per = -(-n_loop // n)
    return per, -(-n_loop // per)


def _dw_splits(B: int, E: int):
    """(batch tiles per slice, slices S) of the dW sweep of K6 and K7,
    whose block (entity tile, slice) sums its slice's batch tiles, the
    slices then summed in order. A function of the shapes alone (never of
    the card or of timing), so that a run and its resume take the same
    sums; S = 1 once the entity tiles alone fill the card."""
    return _k6_split(-(-E // TILE), -(-B // TILE))


def _dp_chunks(B: int, E: int):
    """(entity tiles per chunk, chunks) of K5 and of the dpooled sweep of
    K6 and K7, whose block (batch tile, chunk) writes one partial that the
    wrapper merges or sums in order."""
    return _k6_split(-(-B // TILE), -(-E // TILE))


def _dw_scratch_numel(B: int, E: int, dp: int) -> int:
    """fp32 values of the dW sweep's slice partials ([S, Ep, dp] in W's
    layout, then [S, Ep]; Ep = E rounded up to 64), or 0 with one slice,
    where the sweep writes dW or applies the update itself."""
    S = _dw_splits(B, E)[1]
    return S * -(-E // TILE) * TILE * (dp + 1) if S > 1 else 0


def _backward_sweeps(B, E, dp, dev):
    """The plans and buffers of the mma.sync sweep's backward, K6's and
    K7's: ((entity tiles per chunk, chunks) of the dpooled sweep, (batch
    tiles per slice, slices) of the dW sweep, the dpooled partials
    [chunks, Bp, dp] (Bp = B rounded up to 64), the dW sweep's scratch or
    None)."""
    per, n_chunks = _dp_chunks(B, E)
    part = torch.empty((n_chunks, -(-B // TILE) * TILE, dp),
                       dtype=torch.float32, device=dev)
    n = _dw_scratch_numel(B, E, dp)
    scratch = (torch.empty((n,), dtype=torch.float32, device=dev) if n
               else None)
    return (per, n_chunks), _dw_splits(B, E), part, scratch


@functools.lru_cache(maxsize=None)
def _wgmma_plan(B: int, E: int, d: int):
    """(K5's and the dpooled sweep's plan, the dW sweep's plan) of the bf16
    sweep (``csrc/xent_wgmma.cu``), as ``sampled_lse.Sweep``s: K5 / dpooled
    hold batch tiles of 128 rows and stream W's entity tiles in chunks; dW
    holds entity tiles of 128 and streams P's batch tiles in slices, many
    only where the entity tiles are few. Each is K1/K2's split
    (``sampled_lse._split``): the fewest parts whose blocks, one an SM,
    finish soonest. A function of the shapes alone (never of the card or
    of timing), so that a run and its resume take the same sums."""
    dp = _sweep_width(d, torch.bfloat16)
    yr = _ytile(torch.bfloat16, dp)
    return (_split(-(-B // X_ROWS), -(-E // yr), yr),
            _split(-(-E // X_ROWS), -(-B // yr), yr))


def _wgmma_scratch_numel(B: int, E: int, d: int) -> int:
    """fp32 values of the bf16 dW sweep's slice partials ([S, Ex, dp], then
    the db partials [S, Ex]; Ex = E rounded up to 128), or 0 with one
    slice, where the sweep writes dW itself."""
    S = _wgmma_plan(B, E, d)[1].parts
    return (S * -(-E // X_ROWS) * X_ROWS * (_sweep_width(d, torch.bfloat16)
                                             + 1) if S > 1 else 0)


def _w_operand(W: torch.Tensor) -> torch.Tensor:
    """W (contiguous, "de" or "ed") as the bf16 sweep reads it through TMA:
    bf16, rows a whole number of 16 bytes apart, 16-byte aligned, zeros in
    any padding columns. A bf16 W that is one already is taken as it is;
    an fp32 W is cast once (the rounding xent_loss_plain applies), which
    reads fp32 W once and writes a bf16 copy (256 MB at E 1M, d 128) that
    the backward reuses."""
    Wb = W.to(torch.bfloat16)
    pad = -Wb.shape[1] % 8
    if pad:
        Wb = F.pad(Wb, (0, pad))
    return Wb if Wb.data_ptr() % 16 == 0 else Wb.clone()


def _fwd(P, W, Wb, b, geometry, ct):
    """Launch K5 on P [B, dp] and merge its chunks: lse [B] fp32. bf16
    compute runs the wgmma sweep on W's bf16 operand ``Wb``
    (:func:`_w_operand`), fp32 compute the mma.sync sweep on W itself."""
    global fwd_launches, fwd_wgmma_launches
    B, E, d, dp, strides, layout = geometry
    dev = P.device
    if ct == torch.bfloat16:
        plan = _wgmma_plan(B, E, d)[0]
        per, n_chunks = plan.per, plan.parts
    else:
        per, n_chunks = _dp_chunks(B, E)
    m = torch.empty((n_chunks, B), dtype=torch.float32, device=dev)
    s = torch.empty_like(m)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if ct == torch.bfloat16:
            err = _build.kernel("sert_xent_wgmma_fwd")(
                P.data_ptr(), Wb.data_ptr(), b.data_ptr(), m.data_ptr(),
                s.data_ptr(), B, E, d, dp, Wb.shape[1], int(layout == "de"),
                per, n_chunks, plan.y_rows, stream)
        else:
            err = _build.kernel("sert_xent_fwd")(
                P.data_ptr(), W.data_ptr(), b.data_ptr(), m.data_ptr(),
                s.data_ptr(), B, E, d, dp, strides[0], strides[1], per,
                n_chunks, int(W.dtype == torch.bfloat16), stream)
    _build.check(err, "xent forward (K5)")
    fwd_launches += 1
    fwd_wgmma_launches += ct == torch.bfloat16
    debug.kernel_outputs("xent_fwd", m, s)
    M = m.amax(dim=0)
    return M + torch.log(torch.sum(s * torch.exp(m - M[None, :]), dim=0))


def _cuda_only(pooled: torch.Tensor) -> None:
    if pooled.device.type != "cuda":
        raise ValueError(f"xent runs on cpu or cuda, not {pooled.device}")


def _geometry(pooled, W, b, labels, layout, ct):
    """:func:`_check`'s (B, E, d, dp, strides), then the layout."""
    return (*_check(pooled, W, b, labels, layout, ct), layout)


def _loss_forward(pooled, W, b, labels, layout, ct):
    """K5 and the gold logit: (loss sum, the backward's operands (P, W, fp32
    bias, int32 labels, lse [B], W's bf16 operand or None in fp32
    compute), geometry (B, E, d, dp, strides, layout)). P is padded here,
    once, to the sweeps' width dp, and W's bf16 operand made once
    (:func:`_w_operand`); K6 or K7 reads them as they are."""
    geometry = _geometry(pooled, W, b, labels, layout, ct)
    d = geometry[2]
    P = _operand(pooled.detach(), ct, geometry[3])
    Wd = W.detach()
    Wb = _w_operand(Wd) if ct == torch.bfloat16 else None
    bf = b.detach().float().contiguous()
    lab = labels.to(torch.int32).contiguous()
    lse = _fwd(P, Wd, Wb, bf, geometry, ct)
    # The gold logit: one gather of W's gold rows, an fp32 sum of
    # compute-dtype-rounded products (the reference's xent.py:347-355).
    idx = labels.long()
    w_gold = Wd[:, idx].T if layout == "de" else Wd[idx]
    z_gold = (torch.sum(P[:, :d].float() * w_gold.to(ct).float(), dim=1)
              + bf[idx])
    return torch.sum(lse - z_gold), (P, Wd, bf, lab, lse, Wb), geometry


def _bwd(saved, geometry, g, ct):
    """Launch K6 on :func:`_loss_forward`'s operands and geometry (or the
    sharded loss's: lse [B] may come from outside, a label -1 is a row
    whose gold entity another shard holds): (dpooled [B, d], dW in W's
    layout, db [E]), fp32, each times the fp32 scalar ``g`` [1]. bf16
    compute runs the wgmma sweep's dW and dpooled modes on W's bf16
    operand, fp32 compute the mma.sync sweep's on W itself."""
    global bwd_launches, bwd_wgmma_launches
    P, W, bf, lab, lse, Wb = saved
    B, E, d, dp, strides, layout = geometry
    dev = P.device
    dW = torch.empty(W.shape, dtype=torch.float32, device=dev)
    db = torch.empty((E,), dtype=torch.float32, device=dev)
    if ct == torch.bfloat16:
        fwd, dw = _wgmma_plan(B, E, d)
        part = torch.empty((fwd.parts, B, dp), dtype=torch.float32,
                           device=dev)
        n = _wgmma_scratch_numel(B, E, d)
        scratch = (torch.empty((n,), dtype=torch.float32, device=dev) if n
                   else None)
    else:
        (per, n_chunks), (bper, n_slices), part, scratch = _backward_sweeps(
            B, E, dp, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sp = None if scratch is None else scratch.data_ptr()
        if ct == torch.bfloat16:
            err = _build.kernel("sert_xent_wgmma_bwd")(
                P.data_ptr(), Wb.data_ptr(), bf.data_ptr(), lse.data_ptr(),
                lab.data_ptr(), g.data_ptr(), dW.data_ptr(), db.data_ptr(),
                part.data_ptr(), sp, B, E, d, dp, Wb.shape[1],
                int(layout == "de"), fwd.per, fwd.parts, dw.per, dw.parts,
                fwd.y_rows, stream)
        else:
            err = _build.kernel("sert_xent_bwd")(
                P.data_ptr(), W.data_ptr(), bf.data_ptr(), lse.data_ptr(),
                lab.data_ptr(), g.data_ptr(), dW.data_ptr(), db.data_ptr(),
                part.data_ptr(), sp, B, E, d, dp, strides[0], strides[1],
                per, n_chunks, bper, n_slices, DP_MAX_TILES,
                int(W.dtype == torch.bfloat16), stream)
    _build.check(err, "xent backward (K6)")
    bwd_launches += 1
    bwd_wgmma_launches += ct == torch.bfloat16
    debug.kernel_outputs("xent_bwd", dW, db)
    return _sum_parts(part)[:B, :d] * g, dW, db


class _XentLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pooled, W, b, labels, layout, dtype):
        ct = _compute_dtype(dtype)
        loss, saved, geometry = _loss_forward(pooled, W, b, labels, layout,
                                              ct)
        ctx.save_for_backward(*saved)
        ctx.meta = (ct, geometry, pooled.dtype, b.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        ct, geometry, pooled_dtype, b_dtype = ctx.meta
        W = ctx.saved_tensors[1]
        dpooled, dW, db = _bwd(ctx.saved_tensors, geometry,
                               g.float().reshape(1).contiguous(), ct)
        return (dpooled.to(pooled_dtype), dW.to(W.dtype), db.to(b_dtype),
                None, None, None)


def xent_loss(pooled: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
              labels: torch.Tensor, layout: str = "de",
              dtype: str = "float32") -> torch.Tensor:
    """SUM over the batch of the softmax cross-entropies of
    ``pooled @ W + b`` ("de", W [d, E]) or ``pooled @ W.T + b`` ("ed",
    W [E, d]) against ``labels`` [B]; divide by B for the mean.

    Differentiable in pooled, W and b; W's gradient comes back in W's
    layout and dtype. ``dtype`` "bfloat16" multiplies bf16-rounded operands
    (W's tiles cast on their way into the kernel) with fp32 accumulation.
    CUDA tensors go through K5/K6, CPU tensors through
    :func:`xent_loss_plain`."""
    if pooled.device.type == "cpu":
        return xent_loss_plain(pooled, W, b, labels, layout, dtype)
    _cuda_only(pooled)
    return _XentLoss.apply(pooled, W, b, labels, layout, dtype)


@torch.no_grad()
def xent_lse(pooled: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
             layout: str = "de", dtype: str = "float32") -> torch.Tensor:
    """[B] fp32 logsumexp over entities of the same logits: K5 alone on CUDA
    tensors, :func:`xent_lse_plain` on CPU tensors. Not differentiable."""
    if pooled.device.type == "cpu":
        return xent_lse_plain(pooled, W, b, layout, dtype)
    _cuda_only(pooled)
    ct = _compute_dtype(dtype)
    geometry = _geometry(pooled, W, b, None, layout, ct)
    Wb = _w_operand(W) if ct == torch.bfloat16 else None
    return _fwd(_operand(pooled, ct, geometry[3]), W, Wb,
                b.float().contiguous(), geometry, ct)


# ------- the backward fed an outside lse, and the entity-sharded loss -------
#
# Port of sert_tpu/ops/xent.py _shard_fwd_stitch :689 and
# make_sharded_xent_loss :721 (its shard_map body is the rank's own block
# here: sharded_xent_loss). Each model rank holds a block of W's entity
# axis (and of b). Forward: K5 gives the block's lse; the global lse is the
# max over the blocks plus the log of the rescaled sum; the gold logit
# comes from the rank whose block holds the label, summed over the blocks.
# The collectives come from the caller (a Stitch), so this layer knows no
# mesh.
# Backward: K6 fed the GLOBAL lse and the block's labels, -1 where the gold
# entity lies on another block (its onehot never fires here; the owning
# rank supplies the -1 of softmax-minus-onehot). The rank's loss is its
# partial, the global loss / tp (the mesh's convention, parallel/mesh.py),
# so the returned gradients are plain local ones: W's and b's block, and
# this block's share of dpooled, which the step sums over ``model``.


@torch.no_grad()
def xent_bwd_plain(pooled: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                   lse: torch.Tensor, labels: torch.Tensor,
                   layout: str = "de", dtype: str = "float32"):
    """(dpooled [B, d], dW in W's layout, db [E]), fp32: the gradients of
    sum_b [lse_b - z_{b, y_b}] taken with ``lse`` [B] as given (p =
    exp(z - lse) - onehot, no onehot where a label is -1), in plain
    PyTorch; materializes [B, E]. Rounds where autograd of
    :func:`xent_loss_plain` does: p to the compute dtype before both
    products, db from the unrounded p."""
    _check_layout(layout)
    ct = _compute_dtype(dtype)
    P, Wf = _operand_fp32(pooled, ct), _operand_fp32(W, ct)
    z = (P @ Wf if layout == "de" else P @ Wf.T) + b.float()
    p = torch.exp(z - lse.float()[:, None])
    lab = labels.long()
    rows = torch.nonzero(lab >= 0)[:, 0]
    p[rows, lab[rows]] -= 1.0
    db = p.sum(dim=0)
    if ct != torch.float32:
        p = p.to(ct).float()
    if layout == "de":
        return p @ Wf.T, P.T @ p, db
    return p @ Wf, p.T @ P, db


def xent_bwd(pooled: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
             lse: torch.Tensor, labels: torch.Tensor, layout: str = "de",
             dtype: str = "float32"):
    """:func:`xent_bwd_plain`'s gradients through K6 on CUDA tensors (the
    kernel fed ``lse`` from outside and labels of -1 off the shard), the
    plain version on CPU tensors."""
    if pooled.device.type == "cpu":
        return xent_bwd_plain(pooled, W, b, lse, labels, layout, dtype)
    _cuda_only(pooled)
    ct = _compute_dtype(dtype)
    geometry = _geometry(pooled, W, b, labels, layout, ct)
    saved = (_operand(pooled.detach(), ct, geometry[3]), W.detach(),
             b.detach().float().contiguous(),
             labels.to(torch.int32).contiguous(),
             lse.detach().float().contiguous(),
             _w_operand(W.detach()) if ct == torch.bfloat16 else None)
    one = torch.ones((1,), dtype=torch.float32, device=pooled.device)
    return _bwd(saved, geometry, one, ct)


class Stitch(NamedTuple):
    """How this rank's entity block joins the others: ``offset``, the
    global id of the block's first entity; ``parts``, the number of
    blocks; ``reduce_max`` / ``reduce_sum``, the elementwise max and sum
    of a tensor over the ranks holding the blocks (``parallel.fused_loss``
    gives them over the mesh's ``model`` axis). The sum must be
    differentiable under the mesh's convention (``parallel/mesh.py``)."""
    offset: int
    parts: int
    reduce_max: Callable[[torch.Tensor], torch.Tensor]
    reduce_sum: Callable[[torch.Tensor], torch.Tensor]


ONE_BLOCK = Stitch(0, 1, lambda x: x, lambda x: x)


def _block_forward(pooled, W, b, labels, stitch, layout, dtype, fused):
    """The forward of this rank's entity block, stitched with the others:
    K5 (or its plain version) on the block, the global lse (the max over
    the blocks, then the rescaled sum) and the global gold logit (from the
    block holding the label). Returns (lse [B], z_gold [B], the backward's
    operands, geometry): with ``fused`` K6's or K7's operands (P, W, fp32
    bias, int32 labels of the block, -1 off it, lse, W's bf16 operand or
    None) and :func:`_loss_forward`'s geometry, else (pooled, W, b, int64
    labels of the block, lse) and None. Nothing here is differentiable."""
    ct = _compute_dtype(dtype)
    El = W.shape[1] if layout == "de" else W.shape[0]
    lab = labels.long() - stitch.offset
    own = (lab >= 0) & (lab < El)
    idx = lab.clamp(0, El - 1)
    lab_k = torch.where(own, idx, torch.full_like(idx, -1))
    Wd = W.detach()
    if fused:
        geometry = _geometry(pooled, W, b, labels, layout, ct)
        P = _operand(pooled.detach(), ct, geometry[3])
        Wb = _w_operand(Wd) if ct == torch.bfloat16 else None
        bf = b.detach().float().contiguous()
        lse_l = _fwd(P, Wd, Wb, bf, geometry, ct)
    else:
        _check_layout(layout)
        geometry = None
        bf = b.detach().float()
        lse_l = xent_lse_plain(pooled.detach(), Wd, b.detach(), layout,
                               dtype)
    # The gold logit, from the rank holding the label's column: an fp32
    # sum of compute-dtype-rounded products (the reference's :711-717).
    w_gold = Wd[:, idx].T if layout == "de" else Wd[idx]
    z_gold = (torch.sum(pooled.detach().to(ct).float()
                        * w_gold.to(ct).float(), dim=1) + bf[idx])
    # The global lse: max over the blocks, then the rescaled sum, which
    # travels with the gold logits' sum.
    M = stitch.reduce_max(lse_l)
    sums = stitch.reduce_sum(torch.stack([torch.exp(lse_l - M),
                                          torch.where(own, z_gold, 0.0)]))
    lse, z_gold = M + torch.log(sums[0]), sums[1]
    if fused:
        saved = (P, Wd, bf, lab_k.to(torch.int32).contiguous(),
                 lse.contiguous(), Wb)
    else:
        saved = (pooled.detach(), Wd, b.detach(), lab_k, lse)
    return lse, z_gold, saved, geometry


class _ShardedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pooled, W, b, labels, stitch, layout, dtype, fused):
        lse, z_gold, saved, ctx.geometry = _block_forward(
            pooled, W, b, labels, stitch, layout, dtype, fused)
        ctx.save_for_backward(*saved)
        ctx.meta = (_compute_dtype(dtype), layout, dtype, fused,
                    pooled.dtype, b.dtype)
        return torch.sum(lse - z_gold) / stitch.parts

    @staticmethod
    def backward(ctx, g):
        ct, layout, dtype, fused, pooled_dtype, b_dtype = ctx.meta
        W = ctx.saved_tensors[1]
        g = g.float().reshape(1).contiguous()
        if fused:
            dpooled, dW, db = _bwd(ctx.saved_tensors, ctx.geometry, g, ct)
        else:
            pooled, _, b, lab_k, lse = ctx.saved_tensors
            dpooled, dW, db = (t * g for t in xent_bwd_plain(
                pooled, W, b, lse, lab_k, layout, dtype))
        return (dpooled.to(pooled_dtype), dW.to(W.dtype), db.to(b_dtype),
                None, None, None, None, None)


def sharded_xent_loss(pooled: torch.Tensor, W: torch.Tensor,
                      b: torch.Tensor, labels: torch.Tensor,
                      stitch: Stitch = ONE_BLOCK, layout: str = "de",
                      dtype: str = "float32",
                      fused: bool = True) -> torch.Tensor:
    """This rank's partial of the softmax cross-entropy SUM over an entity
    axis split into ``stitch.parts`` blocks: the rows ``pooled`` [B, d]
    and their global ``labels``, against this rank's block of W
    (W [d, E/parts] "de" or [E/parts, d] "ed") and of b [E/parts]. The
    partials of the blocks sum to the loss; each is (sum over the rows of
    the global row loss) / parts. ``fused``: K5 and K6 (CUDA tensors
    only), else their plain versions on the block."""
    if fused:
        _cuda_only(pooled)
    return _ShardedXent.apply(pooled, W, b, labels, stitch, layout, dtype,
                              fused)


# ------------- the backward fused with the optimizer update (K7) ------------

def _slots(W: torch.Tensor, opt: str, opt_tree) -> list:
    """The optimizer's state slots of W (adam m, v; adagrad acc; sgd none),
    after checking that each has W's shape, dtype, device and layout."""
    if opt not in OPTIMIZERS:
        raise ValueError(f"xent_loss_apply: opt must be one of {OPTIMIZERS}, "
                         f"got {opt!r}")
    if set(opt_tree) != set(SLOTS[opt]):
        raise ValueError(f"xent_loss_apply: {opt} takes the slots "
                         f"{SLOTS[opt]}, got {sorted(opt_tree)}")
    slots = [opt_tree[k] for k in SLOTS[opt]]
    for name, s in zip(SLOTS[opt], slots):
        if (s.shape != W.shape or s.dtype != W.dtype or s.device != W.device
                or not s.is_contiguous()):
            raise ValueError(
                f"xent_loss_apply: slot {name!r} must be contiguous and have "
                f"W's shape {tuple(W.shape)}, dtype {W.dtype} and device "
                f"{W.device}; got {tuple(s.shape)}, {s.dtype}, {s.device}")
    return slots


def _bias_corr(count) -> tuple:
    """adam's (1 - 0.9^t, 1 - 0.999^t) with t = count + 1, in fp32 as the
    reference takes them (xent.py:654-655)."""
    t = np.float32(count) + np.float32(1.0)
    return (float(np.float32(1.0) - np.float32(ADAM_B1) ** t),
            float(np.float32(1.0) - np.float32(ADAM_B2) ** t))


def _update_plain(W, slots, dW, opt, lr, count, gscale) -> torch.Tensor:
    """The update of W and its slots, in place, from the summed loss's fp32
    dW, in the kernel's order and in fp32 from W's stored values; returns
    ||gscale * dW||^2."""
    g = dW * gscale
    if opt == "adam":
        bc1, bc2 = _bias_corr(count)
        m2 = ADAM_B1 * slots[0].float() + (1.0 - ADAM_B1) * g
        v2 = ADAM_B2 * slots[1].float() + (1.0 - ADAM_B2) * g * g
        upd = lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS)
        slots[0].copy_(m2)
        slots[1].copy_(v2)
    elif opt == "adagrad":
        a2 = slots[0].float() + g * g
        upd = lr * g * torch.where(a2 > 0, torch.rsqrt(a2 + ADAGRAD_EPS), 0.0)
        slots[0].copy_(a2)
    else:
        upd = lr * g
    W.copy_(W.float() - upd)
    return torch.sum(g * g)


@torch.no_grad()
def xent_loss_apply_plain(pooled: torch.Tensor, W: torch.Tensor,
                          b: torch.Tensor, labels: torch.Tensor, *, opt: str,
                          opt_tree, lr: float, count, gscale: float,
                          layout: str = "de", dtype: str = "float32"):
    """:func:`xent_loss_apply` in plain PyTorch: the loss and gradients of
    :func:`xent_loss_plain` (materializing [B, E]), then the update in the
    kernel's order, in fp32 from W's stored values. Updates W and the slots
    in place."""
    slots = _slots(W, opt, opt_tree)
    with torch.enable_grad():
        p, w, bb = (t.detach().float().requires_grad_(True)
                    for t in (pooled, W, b))
        loss = xent_loss_plain(p, w, bb, labels, layout, dtype)
        dpooled, dW, db = torch.autograd.grad(loss, [p, w, bb])
    gsq = _update_plain(W, slots, dW, opt, lr, count, gscale)
    return (loss.detach(), W, opt_tree, db * gscale, dpooled * gscale, gsq)


def _wgmma_dpooled(saved, geometry, stream):
    """K6's dpooled sweep on the bf16 route alone, on :func:`_loss_forward`'s
    operands and geometry: K7's dpooled in bf16 compute, so that K6 and K7
    give the same dpooled bit for bit. Returns its unscaled partials
    [chunks, B, dp]."""
    P, _, bf, lab, lse, Wb = saved
    B, E, d, dp, _, layout = geometry
    plan = _wgmma_plan(B, E, d)[0]
    part = torch.empty((plan.parts, B, dp), dtype=torch.float32,
                       device=P.device)
    err = _build.kernel("sert_xent_wgmma_dpooled")(
        P.data_ptr(), Wb.data_ptr(), bf.data_ptr(), lse.data_ptr(),
        lab.data_ptr(), part.data_ptr(), B, E, d, dp, Wb.shape[1],
        int(layout == "de"), plan.per, plan.parts, plan.y_rows, stream)
    _build.check(err, "xent backward with the optimizer update (K7)")
    return part


def _bwd_apply(saved, geometry, slots, opt, lr, count, gscale, ct):
    """Launch K7 on :func:`_loss_forward`'s operands and geometry: K6's
    dpooled sweep, then its dW sweep with the update in place of the dW
    store (and, with S > 1 slices, the update in the ordered sum of the
    slices), on K6's plans and K6's sweeps. bf16 compute runs the wgmma
    sweep (:func:`_wgmma_dpooled`, then ``sert_xent_wgmma_apply``, which
    reads W's bf16 operand and updates W itself), fp32 compute the mma.sync
    sweep (``sert_xent_bwd_apply``); the dpooled sweep goes first either
    way, since it reads all of W before the update. Updates W and the
    slots in place; returns (db * gscale, dpooled * gscale, gsq)."""
    global apply_launches, apply_wgmma_launches
    P, W, bf, lab, lse, Wb = saved
    B, E, d, dp, strides, layout = geometry
    dev = P.device
    bf16 = ct == torch.bfloat16
    db = torch.empty((E,), dtype=torch.float32, device=dev)
    bc1, bc2 = _bias_corr(count) if opt == "adam" else (1.0, 1.0)
    s1, s2 = ([s.data_ptr() for s in slots] + [None, None])[:2]
    code, w_bf16 = OPTIMIZERS.index(opt), int(W.dtype == torch.bfloat16)
    if bf16:
        dw = _wgmma_plan(B, E, d)[1]
        n = _wgmma_scratch_numel(B, E, d)
        scratch = (torch.empty((n,), dtype=torch.float32, device=dev) if n
                   else None)
        gsq = torch.empty((dw.n_x,), dtype=torch.float32, device=dev)
    else:
        (per, n_chunks), (bper, n_slices), part, scratch = _backward_sweeps(
            B, E, dp, dev)
        gsq = torch.empty((-(-E // TILE),), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            part = _wgmma_dpooled(saved, geometry, stream)
            err = _build.kernel("sert_xent_wgmma_apply")(
                P.data_ptr(), Wb.data_ptr(), W.data_ptr(), bf.data_ptr(),
                lse.data_ptr(), lab.data_ptr(), s1, s2, db.data_ptr(),
                gsq.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, E, d,
                dp, Wb.shape[1], int(layout == "de"), dw.per, dw.parts,
                dw.y_rows, code, lr, gscale, bc1, bc2, w_bf16, stream)
        else:
            err = _build.kernel("sert_xent_bwd_apply")(
                P.data_ptr(), W.data_ptr(), bf.data_ptr(), lse.data_ptr(),
                lab.data_ptr(), s1, s2, db.data_ptr(), part.data_ptr(),
                gsq.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                B, E, d, dp, strides[0], strides[1], per, n_chunks, bper,
                n_slices, DP_MAX_TILES, code, lr, gscale, bc1, bc2, w_bf16,
                stream)
    _build.check(err, "xent backward with the optimizer update (K7)")
    apply_launches += 1
    apply_wgmma_launches += bf16
    debug.kernel_outputs("xent_bwd_apply", W, db, gsq)
    return (db * gscale, _sum_parts(part)[:B, :d] * gscale, torch.sum(gsq))


@torch.no_grad()
def xent_loss_apply(pooled: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                    labels: torch.Tensor, *, opt: str, opt_tree, lr: float,
                    count, gscale: float, layout: str = "de",
                    dtype: str = "float32"):
    """The softmax cross-entropy's loss and backward with the optimizer
    update of W applied inside the backward: K5, then K7 on CUDA tensors;
    :func:`xent_loss_apply_plain` on CPU tensors. Not differentiable.

    ``opt`` is "adam" (``opt_tree`` {"m", "v"}), "adagrad" ({"acc"}) or
    "sgd" ({}), each slot shaped and typed as W (fp32 or bf16 storage;
    b1 = 0.9, b2 = 0.999, eps 1e-8 for adam and 1e-7 for adagrad, as in
    the reference), ``lr`` the constant learning rate, ``count`` adam's
    step count before this update (bias correction at t = count + 1),
    ``gscale`` the factor from the summed loss to the update's gradient
    (1 / B for the mean). W and the slots are updated IN PLACE (the
    reference donates their buffers through input-output aliasing,
    xent.py:580, :595, :607) and returned.

    Returns ``(loss_sum, W, opt_tree, db * gscale, dpooled * gscale,
    gsq)``: db and dpooled are the gradients of the gscale-scaled loss in
    fp32, gsq = ||gscale * dW||^2 (fp32 scalar) for the grad-norm
    metric."""
    if pooled.device.type == "cpu":
        return xent_loss_apply_plain(
            pooled, W, b, labels, opt=opt, opt_tree=opt_tree, lr=lr,
            count=count, gscale=gscale, layout=layout, dtype=dtype)
    _cuda_only(pooled)
    slots = _slots(W, opt, opt_tree)
    ct = _compute_dtype(dtype)
    loss, saved, geometry = _loss_forward(pooled, W, b, labels, layout, ct)
    db, dpooled, gsq = _bwd_apply(saved, geometry, slots, opt, lr, count,
                                  gscale, ct)
    return loss, W, opt_tree, db, dpooled, gsq


# ---------- the entity-sharded backward with the update (pure TP) ----------
#
# Port of sert_tpu/ops/xent.py make_sharded_xent_apply :818 (its shard_map
# body :857-905 is the rank's own block here). Where the mesh's data axis
# has size 1, every rank holds the whole batch, so the dW of its block is
# the complete gradient of the block's entity columns and the update
# applies per block with no reduction before it. The forward is the
# sharded loss's (_block_forward); K7 is fed the global lse and the
# block's labels, -1 off the block.

def _stitched_apply(stitch: Stitch, lse, z_gold, W, opt_tree, db, dpooled,
                    gsq):
    """``xent_loss_apply``'s results from a block's: the global loss
    (alike on every block), W and the slots as given, the block's db, and
    dpooled and gsq summed over the blocks (one collective)."""
    flat = stitch.reduce_sum(torch.cat([dpooled.reshape(-1),
                                        gsq.reshape(1)]))
    return (torch.sum(lse - z_gold), W, opt_tree, db,
            flat[:-1].view(dpooled.shape), flat[-1])


@torch.no_grad()
def sharded_xent_apply_plain(pooled: torch.Tensor, W: torch.Tensor,
                             b: torch.Tensor, labels: torch.Tensor,
                             stitch: Stitch, *, opt: str,
                             opt_tree, lr: float, count, gscale: float,
                             layout: str, dtype: str):
    """:func:`sharded_xent_apply` in plain PyTorch: the block's lse
    (:func:`xent_lse_plain`), stitched; :func:`xent_bwd_plain` fed the
    global lse; the update in the kernel's order (materializes
    [B, E/parts])."""
    slots = _slots(W, opt, opt_tree)
    lse, z_gold, saved, _ = _block_forward(pooled, W, b, labels, stitch,
                                           layout, dtype, False)
    dpooled, dW, db = xent_bwd_plain(pooled, W, b, lse, saved[3], layout,
                                     dtype)
    gsq = _update_plain(W, slots, dW, opt, lr, count, gscale)
    return _stitched_apply(stitch, lse, z_gold, W, opt_tree, db * gscale,
                           dpooled * gscale, gsq)


@torch.no_grad()
def sharded_xent_apply(pooled: torch.Tensor, W: torch.Tensor,
                       b: torch.Tensor, labels: torch.Tensor,
                       stitch: Stitch, *, opt: str, opt_tree,
                       lr: float, count, gscale: float, layout: str,
                       dtype: str):
    """:func:`xent_loss_apply` on this rank's block of an entity axis split
    into ``stitch.parts`` blocks, every rank holding the whole batch: the
    rows ``pooled`` [B, d] and their global ``labels``, this rank's block
    of W ([d, E/parts] "de" or [E/parts, d] "ed"), of b [E/parts] and of
    the optimizer slots. K5 on the block, its lse stitched with the
    others', then K7 fed the global lse and labels of -1 off the block,
    which updates W's block and its slots IN PLACE; on CPU tensors
    :func:`sharded_xent_apply_plain`. Not differentiable.

    Returns ``(loss_sum, W, opt_tree, db * gscale, dpooled * gscale,
    gsq)``: the global loss (alike on every block), this block's db, and
    dpooled and gsq = ||gscale * dW||^2 over every block (summed with
    ``stitch.reduce_sum``)."""
    if pooled.device.type == "cpu":
        return sharded_xent_apply_plain(
            pooled, W, b, labels, stitch, opt=opt, opt_tree=opt_tree, lr=lr,
            count=count, gscale=gscale, layout=layout, dtype=dtype)
    _cuda_only(pooled)
    slots = _slots(W, opt, opt_tree)
    lse, z_gold, saved, geometry = _block_forward(pooled, W, b, labels,
                                                  stitch, layout, dtype,
                                                  True)
    db, dpooled, gsq = _bwd_apply(saved, geometry, slots, opt, lr, count,
                                  gscale, _compute_dtype(dtype))
    return _stitched_apply(stitch, lse, z_gold, W, opt_tree, db, dpooled,
                           gsq)
