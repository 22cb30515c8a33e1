"""Numeric and input sanitizers (port of ``sert_tpu/utils/debug.py``).

Two failure surfaces get explicit, cheap guards: bad host-side batches
(out-of-range ids from a corrupted shard) and numeric blowups inside the
step (NaN/Inf loss, grads or params). The reference's ``checked`` is
``jax.experimental.checkify``; here it is a ``TorchDispatchMode`` that
records every op's output, and each CUDA kernel wrapper reports its
outputs through :func:`kernel_outputs`, since the mode cannot see inside
a kernel called through ctypes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)

from sert_tpu_torch.utils.config import ModelConfig

# Ops whose output is uninitialized memory until something writes it.
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


def _is_view(func) -> bool:
    """An op whose every output aliases an input it does not write (detach,
    alias, view, slice, t, ...): it makes no new values. checkify's
    float_checks check only the primitives that can make a NaN, none of
    them data movement; a view of a NaN made elsewhere is that op's."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)
_DIVISIONS = ("div", "floor_divide", "remainder", "fmod")


def validate_batch(batch: Dict[str, np.ndarray], cfg: ModelConfig) -> None:
    """Host-side shape/range validation of one instance batch; raises
    ValueError with a precise message on corruption."""
    w, l, e = batch["windows"], batch["lengths"], batch["entities"]
    B, width = w.shape
    if l.shape != (B,) or e.shape != (B,):
        raise ValueError(f"batch shape mismatch: {w.shape} {l.shape} {e.shape}")
    if B == 0:
        # Precise error before any min/max reduction (which has no
        # identity on a zero-size array and raises opaquely).
        raise ValueError("empty batch (B=0 rows)")
    if w.min() < 0 or w.max() >= cfg.vocab_size:
        raise ValueError(
            f"window term id out of range [0, {cfg.vocab_size}): "
            f"min={w.min()} max={w.max()}")
    if l.min() < 0 or l.max() > width:
        raise ValueError(f"length out of range [0, {width}]: "
                         f"min={l.min()} max={l.max()}")
    if e.min() < 0 or e.max() >= cfg.num_entities:
        raise ValueError(
            f"entity id out of range [0, {cfg.num_entities}): "
            f"min={e.min()} max={e.max()}")


class CheckError:
    """What :func:`checked` recorded: each check a message and a device
    bool, in the order the ops ran; reading it syncs."""

    def __init__(self, checks: List[Tuple[str, torch.Tensor]]):
        self._checks = checks

    def get(self) -> Optional[str]:
        """The first failed check's message, or None."""
        for msg, failed in self._checks:
            if bool(failed):
                return msg
        return None

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


class _FloatChecks(TorchDispatchMode):
    """checkify.float_checks as a dispatch mode: a NaN in any floating
    output of an op that makes values (not of a view, nor of uninitialized
    memory), and integer division by zero. Records device bools; nothing
    syncs while the checked function runs."""

    def __init__(self):
        super().__init__()
        self.checks: List[Tuple[str, torch.Tensor]] = []

    def record(self, what: str, tensors, cols: Optional[int] = None
               ) -> None:
        with _disable_current_modes():
            for t in tensors:
                if torch.is_tensor(t) and t.is_floating_point():
                    if cols is not None and t.dim():
                        t = t[..., :cols]
                    self.checks.append((f"nan generated by {what}",
                                        torch.isnan(t).any()))

    def _division_by_zero(self, func, args) -> Optional[torch.Tensor]:
        """A device bool: an integer division's divisor holds a zero."""
        if (func.overloadpacket.__name__.rstrip("_") not in _DIVISIONS
                or len(args) < 2 or not torch.is_tensor(args[0])
                or args[0].is_floating_point() or args[0].is_complex()):
            return None
        b = args[1]
        if torch.is_tensor(b):
            return None if b.is_floating_point() else (b == 0).any()
        return torch.tensor(b == 0) if isinstance(b, int) else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        zero = self._division_by_zero(func, args)
        if zero is not None:
            self.checks.append((f"division by zero in {func}", zero))
        try:
            out = func(*args, **(kwargs or {}))
        except RuntimeError as e:
            # The CPU refuses an integer division by zero; name it as the
            # check would.
            if zero is not None and bool(zero):
                raise FloatingPointError(
                    f"division by zero in {func}") from e
            raise
        if (func.overloadpacket.__name__ not in _UNINITIALIZED
                and not _is_view(func)):
            self.record(str(func), _pytree.tree_leaves(out))
        return out


def kernel_outputs(name: str, *tensors: torch.Tensor,
                   cols: Optional[int] = None) -> None:
    """Called by each kernel wrapper right after its launch, with the
    outputs the kernel wrote (``cols``: only the leading columns of each
    are read, the rest is the sweep's padding): under :func:`checked`, a
    NaN there is named as the kernel's. A no-op otherwise."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _FloatChecks):
            mode.record(f"kernel {name}", tensors, cols)


def checked(fn: Callable) -> Callable:
    """Wrap a function with NaN and division-by-zero checks (the
    reference's ``checkify.float_checks``). Returns ``(err, out)``; call
    ``err.throw()`` to raise ``FloatingPointError`` naming the first op
    (or kernel) whose output held a NaN.

    >>> loss_checked = checked(lambda p, b: api.loss_fn(p, b, cfg))
    >>> err, loss = loss_checked(params, batch)
    >>> err.throw()
    """
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        mode = _FloatChecks()
        with mode:
            out = fn(*args, **kwargs)
        return CheckError(mode.checks), out
    return wrapper


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) of a tensor, a dict, a list or tuple, or a
    dataclass (a TrainState, whose ``opt_state`` keys are already the
    optax tree's paths), as ``jax.tree_util.keystr`` names them."""
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            sub = (f"{path}{k}" if path.endswith(".opt_state")
                   and str(k).startswith("[") else f"{path}[{k!r}]")
            yield from _leaves(v, sub)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")


def assert_all_finite(tree: Any, what: str = "tree") -> None:
    """Finite check over a dict of tensors or a TrainState (use at
    checkpoint boundaries: a snapshot of NaN params is worse than a
    crash); raises FloatingPointError naming the leaf."""
    for key, leaf in _leaves(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {what}{key}")
