"""Tracing / profiling utilities (port of ``sert_tpu/utils/profiling.py``).

  * ``trace(logdir)`` — ``torch.profiler`` over a block (CPU activity, and
    CUDA activity where a card is present), written into ``logdir`` as a
    chrome trace (``*.pt.trace.json``; chrome://tracing, Perfetto or
    TensorBoard's profile plugin).
  * ``annotate(name)`` — a named region inside a trace.
  * ``StepTimer`` — honest wall-clock step rates: it fences the device
    before reading the clock (``torch.cuda.synchronize`` on a CUDA
    argument, or a caller's fence).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, Optional

import torch
from torch.utils import _pytree


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a profiler trace of the block into ``logdir``; a no-op
    where the profiler cannot start."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    try:
        prof.start()
    except RuntimeError:  # pragma: no cover - platform dependent
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()


def annotate(name: str):
    """Named sub-region for traces: ``with annotate("scoring"): ...``"""
    return torch.profiler.record_function(name)


def _fence(arg: Any) -> None:
    """Wait for the devices of every CUDA tensor in ``arg`` (a tensor, or
    a dict / list / tuple of them)."""
    devices = {t.device for t in _pytree.tree_leaves(arg)
               if torch.is_tensor(t) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Rolling steps/sec with an explicit device fence.

    >>> timer = StepTimer()
    >>> for batch in batches:
    ...     state, metrics = step(state, batch)
    ...     rate = timer.tick(metrics["loss"])   # None until window fills
    """

    def __init__(self, fence=None, window: int = 50):
        self._fence = fence
        self._window = window
        self._count = 0
        self._t0: Optional[float] = None
        self.last_rate: Optional[float] = None

    def tick(self, fence_arg: Any = None) -> Optional[float]:
        self._count += 1
        if self._count % self._window:
            return None
        if self._fence is not None:
            self._fence(fence_arg)
        elif fence_arg is not None:
            _fence(fence_arg)
        now = time.perf_counter()
        rate = None
        if self._t0 is not None:
            rate = self._window / (now - self._t0)
            self.last_rate = rate
        self._t0 = now
        return rate
