"""The dense adam update in one pass over each leaf (``csrc/adam.cu``).

``train.step.Optimizer``'s adam on a CUDA device: per leaf, read the param
p, its gradient g and the moments m and v once, and write p, m and v once,
where the torch composition (:func:`adam_plain`) runs fourteen elementwise
passes. The JAX package leaves this to optax, which XLA fuses into one
pass; no Pallas kernel corresponds. The kernel computes :func:`adam_plain`'s
arithmetic to the bit, as that composition runs on a CUDA tensor, and
takes one launch for all the leaves of one dtype (up to :data:`MAX_LEAVES`
a launch). :func:`adam_plain` is the CPU path and the kernel's oracle.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sert_tpu_torch.ops import _build
from sert_tpu_torch.utils import profiling

# (the dtype of p, m and v, the gradient's): the kernel's entry point.
_KERNELS = {(torch.float32, torch.float32): "sert_adam_update_f32",
            (torch.bfloat16, torch.bfloat16): "sert_adam_update_bf16",
            (torch.bfloat16, torch.float32): "sert_adam_update_bf16_f32grad"}
VEC_BYTES = 16            # the kernel's loads and stores
MAX_LEAVES = 32           # leaves a launch (the kernel's parameter table)

# Kernel launches since the last reset (see score_binmax.launches).
launches = 0

# A leaf: its param, gradient, first and second moment, one shape.
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Consts(NamedTuple):
    """adam's constants for the gradients of one dtype, each a Python
    float that dtype holds (``train.step.scalar``), as the JAX package
    applies them in the gradient's dtype."""
    b1: float                   # B1
    c1: float                   # 1 - B1
    b2: float                   # B2
    c2: float                   # 1 - B2
    bc1: float                  # the bias corrections 1 - B1^t, 1 - B2^t
    bc2: float
    eps: float
    neg_lr: float               # -lr
    neg_decay: Optional[float]  # -weight_decay; None without decay
    clip_below: float           # g is kept where its norm is below this
    clip: float                 # the clipping norm, as a factor


def adam_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, k: Consts) -> None:
    """adam on one leaf, in place, as torch elementwise ops; ``g`` is the
    gradient as clipped, ``k`` the constants of its dtype."""
    m.mul_(k.b1).add_(g * k.c1)
    v.mul_(k.b2).add_(g * g * k.c2)
    u = (m / k.bc1) / (torch.sqrt(v / k.bc2) + k.eps)
    u = u * k.neg_lr
    if k.neg_decay is not None:
        u = u + p * k.neg_decay
    p.add_(u.to(p.dtype))


def _head(ptrs: Sequence[int], elems: Sequence[int], n: int,
          vec: int) -> int:
    """The elements of a leaf before its first whole unit of ``vec``
    elements: the first element at which each of its tensors (at addresses
    ``ptrs``, of ``elems`` bytes an element) reaches a 16-byte boundary (at
    most ``n``); -1 where they reach none at one element, each element then
    on its own."""
    for h in range(vec):
        if all((a + h * e) % VEC_BYTES == 0 for a, e in zip(ptrs, elems)):
            return min(n, h)
    return -1


def _recip(x: float) -> float:
    """fp32's 1 / x: PyTorch divides a CUDA tensor by a Python float as a
    product with this."""
    return float(np.float32(1.0) / np.float32(x))


def _launch(leaves: Sequence[Leaf], k: Consts,
            norm: Optional[torch.Tensor]) -> None:
    global launches
    p0, g0 = leaves[0][:2]
    dev, dtype, gtype = p0.device, p0.dtype, g0.dtype
    if (dtype, gtype) not in _KERNELS:
        raise ValueError(f"the adam kernel takes fp32 or bf16 leaves, with "
                         f"gradients of their dtype or, for bf16, fp32; not "
                         f"{dtype} with {gtype} gradients")
    if norm is not None and (norm.device != dev or norm.dtype != torch.float32
                             or norm.numel() != 1):
        raise ValueError(f"the norm must be one fp32 value on {dev}")
    rows, keep = [], []
    vec = VEC_BYTES // min(dtype.itemsize, gtype.itemsize)
    for p, g, m, v in leaves:
        if (any(t.dtype != dtype for t in (p, m, v)) or g.dtype != gtype
                or any(t.device != dev for t in (p, g, m, v))):
            raise ValueError(f"a kernel launch takes p, m and v of one "
                             f"dtype and gradients of one dtype on one "
                             f"device ({dtype}, {gtype}, {dev})")
        if not g.shape == m.shape == v.shape == p.shape:
            raise ValueError("p, g, m and v must have one shape")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("the kernel updates p, m and v in place: they "
                             "must be contiguous")
        g = g.contiguous()
        keep.append(g)      # else the next copy may take a freed one's memory
        n = p.numel()
        if n:
            ts = (p, g, m, v)
            ptrs = [t.data_ptr() for t in ts]
            rows.append(ptrs + [n, _head(ptrs, [t.element_size() for t in ts],
                                         n, vec)])
    if not rows:
        return
    table = np.asarray(rows, dtype=np.int64)
    with torch.cuda.device(dev), profiling.launch("adam_update"):
        err = _build.kernel(_KERNELS[dtype, gtype])(
            table.ctypes.data, len(rows), k.b1, k.c1, k.b2, k.c2,
            _recip(k.bc1), _recip(k.bc2), k.eps, k.neg_lr,
            0.0 if k.neg_decay is None else k.neg_decay,
            int(k.neg_decay is not None),
            None if norm is None else norm.data_ptr(), k.clip_below, k.clip,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adam_update")
    launches += 1


def _batches(leaves: Sequence[Leaf]) -> List[List[Leaf]]:
    """The kernel's launches: the leaves of each device and pair of
    dtypes (the param's, the gradient's), in order, :data:`MAX_LEAVES` at
    a time."""
    groups: dict = {}
    for leaf in leaves:
        p, g = leaf[:2]
        groups.setdefault((p.device, p.dtype, g.dtype), []).append(leaf)
    return [group[i:i + MAX_LEAVES] for group in groups.values()
            for i in range(0, len(group), MAX_LEAVES)]


def adam_update(leaves: Sequence[Leaf],
                consts: Callable[[torch.dtype], Consts],
                norm: Optional[torch.Tensor] = None) -> None:
    """adam on each leaf (p, g, m, v) of a CUDA device, in place, through
    the kernel, with the constants ``consts`` gives for the gradient's
    dtype; with ``norm``, on gradients clipped by it. One launch for the
    leaves of each device and pair of dtypes (more past
    :data:`MAX_LEAVES`)."""
    for leaf in leaves:
        if leaf[0].device.type != "cuda":
            raise ValueError(f"the adam kernel runs on cuda, not "
                             f"{leaf[0].device}")
    for batch in _batches(leaves):
        _launch(batch, consts(batch[0][1].dtype), norm)
