"""K5 + K6: softmax cross-entropy over the whole entity axis
(``csrc/xent.cu``), port of ``sert_tpu/ops/xent.py`` (``xent_loss`` :293,
``_fwd_partials`` :270, ``_bwd_calls`` :364).

    z_bj = pooled_b . W(j) + b_j
    loss = sum_b [ logsumexp_j z_bj - z_{b, y_b} ]

``W`` is the entity matrix in its storage layout: "de" = [d, E] (the
log-linear ``proj_w``) or "ed" = [E, d] (the LSE ``entity_emb``). On CUDA
tensors :func:`xent_loss` is a ``torch.autograd.Function`` whose forward
launches K5 (per-chunk (max, sumexp), merged here) and whose backward
launches K6 (dpooled, dW in W's layout, db); the [B, E] logits never reach
device memory, and W is read in place, in its own dtype, never copied or
transposed. :func:`xent_lse` is the forward alone (the log-linear query
normalizer). On CPU tensors both are their plain versions
(:func:`xent_loss_plain`, :func:`xent_lse_plain`), which are also the
kernels' oracle on the card. Both round where the reference does: pooled and
W to the compute dtype, fp32 products and softmax, the gold logit a separate
fp32 sum of compute-dtype-rounded products, and p = softmax - onehot rounded
to the compute dtype before the dW and dpooled products.
"""

from __future__ import annotations

import torch

from sert_tpu_torch.ops import _build
from sert_tpu_torch.ops.sampled_lse import (DIM_MULTIPLE, MAX_DIM, _chunking,
                                            _compute_dtype, _operand,
                                            _operand_fp32, _RoundGrad)

LAYOUTS = ("de", "ed")

# Kernel launches since the last reset (chip_smoke.py shows the training and
# scoring paths went through the kernels with them): K5 and K6.
fwd_launches = 0
bwd_launches = 0


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


def _check(pooled, W, b, labels, layout):
    """(B, E, d, dp, strides (sj, sk) of W(j, k)) after checking shapes,
    devices, dtypes and the kernels' limits."""
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
    if B == 0 or E == 0:
        raise ValueError("the K5/K6 kernels need at least one row and one "
                         "entity")
    dp = -(-d // DIM_MULTIPLE) * DIM_MULTIPLE
    if dp > MAX_DIM:
        raise ValueError(f"the K5/K6 kernels take d <= {MAX_DIM}, got {d}")
    if B >= 2 ** 31 // dp or E >= 2 ** 31 - 64:
        raise ValueError("xent: B * d and E must fit in int32")
    strides = (1, E) if layout == "de" else (d, 1)
    return B, E, d, dp, strides


def _fwd(P, W, b, B, E, d, dp, strides, ct):
    """Launch K5 and merge its chunks: lse [B] fp32."""
    global fwd_launches
    dev = P.device
    per, n_chunks = _chunking(B, E)
    m = torch.empty((n_chunks, B), dtype=torch.float32, device=dev)
    s = torch.empty_like(m)
    with torch.cuda.device(dev):
        err = _build.kernel("sert_xent_fwd")(
            P.data_ptr(), W.data_ptr(), b.data_ptr(), m.data_ptr(),
            s.data_ptr(), B, E, d, dp, strides[0], strides[1], per,
            n_chunks, int(ct == torch.bfloat16),
            int(W.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "xent forward (K5)")
    fwd_launches += 1
    M = m.amax(dim=0)
    return M + torch.log(torch.sum(s * torch.exp(m - M[None, :]), dim=0))


def _cuda_only(pooled: torch.Tensor) -> None:
    if pooled.device.type != "cuda":
        raise ValueError(f"xent runs on cpu or cuda, not {pooled.device}")


class _XentLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pooled, W, b, labels, layout, dtype):
        ct = _compute_dtype(dtype)
        B, E, d, dp, strides = _check(pooled, W, b, labels, layout)
        P = _operand(pooled.detach(), ct, dp)
        Wd = W.detach()
        bf = b.detach().float().contiguous()
        lab = labels.to(torch.int32).contiguous()
        lse = _fwd(P, Wd, bf, B, E, d, dp, strides, ct)
        # The gold logit: one gather of W's gold rows, an fp32 sum of
        # compute-dtype-rounded products (the reference's xent.py:347-355).
        idx = labels.long()
        w_gold = Wd[:, idx].T if layout == "de" else Wd[idx]
        z_gold = (torch.sum(P[:, :d].float() * w_gold.to(ct).float(), dim=1)
                  + bf[idx])
        ctx.save_for_backward(P, Wd, bf, lab, lse)
        ctx.meta = (ct, B, E, d, dp, strides, pooled.dtype, b.dtype)
        return torch.sum(lse - z_gold)

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        P, W, bf, lab, lse = ctx.saved_tensors
        ct, B, E, d, dp, strides, pooled_dtype, b_dtype = ctx.meta
        dev = P.device
        g = g.float().reshape(1).contiguous()
        per, n_chunks = _chunking(B, E)
        dW = torch.empty(W.shape, dtype=torch.float32, device=dev)
        db = torch.empty((E,), dtype=torch.float32, device=dev)
        part = torch.empty((n_chunks, B, dp), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = _build.kernel("sert_xent_bwd")(
                P.data_ptr(), W.data_ptr(), bf.data_ptr(), lse.data_ptr(),
                lab.data_ptr(), g.data_ptr(), dW.data_ptr(), db.data_ptr(),
                part.data_ptr(), B, E, d, dp, strides[0], strides[1], per,
                n_chunks, int(ct == torch.bfloat16),
                int(W.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "xent backward (K6)")
        bwd_launches += 1
        dpooled = (part.sum(dim=0)[:, :d] * g).to(pooled_dtype)
        return (dpooled, dW.to(W.dtype), db.to(b_dtype), None, None, None)


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
    B, E, d, dp, strides = _check(pooled, W, b, None, layout)
    return _fwd(_operand(pooled, ct, dp), W, b.float().contiguous(), B, E, d,
                dp, strides, ct)
