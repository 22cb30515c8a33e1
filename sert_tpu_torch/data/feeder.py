"""Device feed: a depth-2 host->device batch pipeline (port of
``sert_tpu/data/feeder.py:20``, which imports jax).

A background thread turns each host item into device tensors while the
current step runs. On a CUDA device it copies each numpy array (the int32
planes, or the packed feed's uint16 and uint8 ones) into pinned memory and
then to the card with ``non_blocking=True`` on a stream of its own, and
records an event; the consumer's stream waits on that event before the
batch is used, so the copy overlaps the previous step.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


class DevicePut:
    """Host batch (dict of numpy arrays) -> dict of tensors on ``device``.
    Called on the feeder's thread; :meth:`ready` is called on the consuming
    thread before the batch is used."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, batch: Dict[str, np.ndarray]):
        if self._stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def ready(self, put) -> Dict[str, torch.Tensor]:
        out, event = put
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in out.values():
                t.record_stream(current)     # freed only after its use
        return out


class PrefetchFeeder:
    """Wrap a host iterator; yields ``put_fn(item)`` for each item, made on
    a worker thread at most ``depth`` items ahead. Exceptions in the
    worker propagate to the consumer. ``deterministic=True`` runs
    ``put_fn`` on the consumer's thread instead (test mode).

    Shutdown: if the consumer stops early, call :meth:`close` (or use the
    feeder as a context manager) so the worker stops instead of blocking
    forever on a full queue; its queue puts poll a stop flag. One-shot:
    build a new feeder per epoch."""

    _SENTINEL = object()

    def __init__(self, batches: Iterator[Any],
                 put_fn: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2, deterministic: bool = False):
        self._batches = batches
        self._put = put_fn if put_fn is not None else (lambda b: b)
        self._deterministic = deterministic
        self._finished = False
        if not deterministic:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._err: Optional[BaseException] = None
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _put_or_stop(self, item) -> bool:
        """Blocking put that gives up when close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for b in self._batches:
                if self._stop.is_set() or not self._put_or_stop(self._put(b)):
                    return
        except BaseException as e:  # re-raised on the consumer's side
            self._err = e
        finally:
            self._put_or_stop(self._SENTINEL)

    def close(self) -> None:
        """Stop the worker and drop staged items. Idempotent."""
        if self._deterministic:
            return
        self._finished = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchFeeder":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __iter__(self) -> Iterator[Any]:
        if self._deterministic:
            for b in self._batches:
                yield self._put(b)
            return
        if self._finished:
            raise RuntimeError(
                "PrefetchFeeder is exhausted; construct a new one per epoch")
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                self._finished = True
                if self._err is not None:
                    raise self._err
                return
            yield item
