"""Tracing / profiling utilities (port of ``sert_tpu/utils/profiling.py``).

  * ``trace(logdir)`` — ``torch.profiler`` over a block (CPU activity on
    every thread, and CUDA activity where a card is present), written into
    ``logdir`` as a chrome trace (``*.pt.trace.json``; chrome://tracing,
    Perfetto or TensorBoard's profile plugin), with spans and counters
    recording.
  * ``recording()`` — turns the program's spans and counters on; ``trace``
    opens it around its profiler, and so can a caller's own profiler.
  * ``annotate(name, ident=None)`` — a named span: inside a recording a
    ``torch.profiler.record_function`` range, so the profiler puts it on
    the clock of the device's activity and links the kernels launched
    inside it; outside one a shared null context after one flag check (no
    allocation, no launch, no sync), as the reference's annotation is
    recorded only under a trace. ``ident`` joins spans across threads
    (``span_idents``).
  * ``launch(name)`` — inside a recording, a profiler operation around a
    kernel launched through ctypes, so that the trace links the kernel to
    the span it was launched in; outside one the shared null context.
  * ``count(name, value)`` / ``counters()`` — counters kept while
    recording; a device tensor stays on the device, summed when read, so
    a recorded step launches nothing more.
  * ``StepTimer`` — honest wall-clock step rates: it fences the device
    before reading the clock (``torch.cuda.synchronize`` on a CUDA
    argument, or a caller's fence).

The program's spans are named ``sert.<layer>.<part>``: ``sert.feed.wait``
(the consumer's queue get), ``sert.feed.put`` (the feeder thread making one
item) with its children ``sert.feed.read`` (the host iterator) and
``sert.feed.copy`` (``DevicePut``), ``sert.step.micro`` (one micro-step)
with its children ``sert.step.sample``, ``sert.step.loss``,
``sert.step.backward``, ``sert.step.dedup``, ``sert.step.fused`` and
``sert.step.optimizer``. Counters: ``rows.slots.<table>`` and
``rows.unique.<table>``, the lazy step's de-duplicated slots and the
distinct rows among them; ``optimizer.leaves.kernel`` and
``optimizer.leaves.plain``, the leaves that adam's kernel updated and the
rest.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Dict, Hashable, Iterator, List, Optional, Tuple

import torch
from torch.utils import _pytree

_NULL = contextlib.nullcontext()
_recording = False
_counts: Dict[str, List[Any]] = collections.defaultdict(list)
_idents: Dict[str, List[Tuple[int, Hashable]]] = collections.defaultdict(
    list)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record the program's spans and counters inside the block."""
    global _recording
    before, _recording = _recording, True
    try:
        yield
    finally:
        _recording = before


def profile_all_threads() -> Dict[str, Any]:
    """``torch.profiler.profile``'s keyword arguments that record the CPU
    operations of every thread (the feeder's spans run on its own), where
    this torch has the option; else none."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):  # pragma: no cover - older torch
        return {}


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a profiler trace of the block into ``logdir``, with spans
    and counters recording; a no-op where the profiler cannot start."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir),
                   **profile_all_threads())
    with recording():
        try:
            prof.start()
        except RuntimeError:  # pragma: no cover - platform dependent
            prof = None
        try:
            yield
        finally:
            if prof is not None:
                prof.stop()


def annotate(name: str, ident: Optional[Hashable] = None):
    """Named sub-region for traces: ``with annotate("scoring"): ...``.
    While recording, ``ident`` is kept with the wall clock's ns at the
    span's start (``span_idents``), so that a reader can join spans of two
    threads that handle the same item."""
    if not _recording:
        return _NULL
    if ident is not None:
        _idents[name].append((time.time_ns(), ident))
    return torch.profiler.record_function(name)


def launch(name: str):
    """A profiler operation named ``name`` around a kernel launched through
    ctypes, which no torch operation holds: while recording, one of the
    function scope (``RecordFunctionFast``, as torch's own compiled kernels
    are launched inside), so that the profiler links the kernel to it and
    a reader to the span around it; a ``record_function`` range is of the
    user scope, to which the profiler links no kernel. Outside a recording
    the shared null context."""
    if not _recording:
        return _NULL
    from torch._C._profiler import _RecordFunctionFast
    return _RecordFunctionFast(name)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while recording: a number, or
    a tensor whose elements are added, kept where it lives until
    :func:`counters` sums it (so call that after each recording)."""
    if _recording:
        _counts[name].append(value)


def counters() -> Dict[str, float]:
    """Every counter's sum since the last call, as host numbers (summing
    a device tensor waits for it); resets them."""
    global _counts
    kept, _counts = _counts, collections.defaultdict(list)
    return {name: float(sum(float(v.sum()) if torch.is_tensor(v) else v
                            for v in vals))
            for name, vals in kept.items()}


def span_idents() -> Dict[str, List[Tuple[int, Hashable]]]:
    """For each span name given an ``ident`` since the last call, its
    (wall clock ns at the start, ident) in order; resets them. Another
    thread may be adding to them: they are swapped out, not copied."""
    global _idents
    kept, _idents = _idents, collections.defaultdict(list)
    return dict(kept)


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
