"""Read a ``torch.profiler`` trace of the traced window.

The window is the host span ``portbench.window`` (its calls and the
synchronize after them). The device is busy where any of its operations
(kernels, copies, fills) runs; the idle gaps between them are named by
what the host was doing in the middle of each: the harness's span around
the call (``portbench.feed``, ``portbench.step``, ``portbench.log``) and
the innermost host operation there.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    micro_steps: int
    kernels: List[Tuple[str, float]]        # (name, seconds) of each launch
    device_ops: List[List]                  # [name, seconds], longest first
    idle_gaps: List[List]                   # [what the host did, seconds]


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) != "CPU"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_label(cpu: List[Tuple[float, float, str]], starts: List[float],
                t: float) -> str:
    """The harness span and the innermost host operation running at ``t``
    on the main thread (``cpu`` sorted by start)."""
    span, inner = None, None
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 5000, -1), -1):
        a, b, name = cpu[j]
        if b < t:
            continue
        if name.startswith(SPAN_PREFIX):
            if name != WINDOW and span is None:
                span = name
            if inner is None:
                inner = name
            if span is not None:
                break
        elif inner is None:
            inner = name
    parts = [p for p in (span, inner) if p and p != WINDOW]
    return " > ".join(dict.fromkeys(parts)) or "between the harness's calls"


def read(prof, micro_steps: int) -> Optional[DeviceTrace]:
    """The traced window of ``prof``; None if it holds no device
    operation."""
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    thread = win[0].thread
    dev = []
    for e in events:
        if not _is_device(e) or e.name.startswith(SPAN_PREFIX):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            dev.append((a, b, e.name))
    if not dev:
        return None
    busy = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    kernels = [(name, (b - a) * 1e-6) for a, b, name in dev
               if not name.startswith(("Memcpy", "Memset"))]

    cpu = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events
                 if not _is_device(e) and e.thread == thread)
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_label(cpu, starts, 0.5 * (a + b))] += (b - a) * 1e-6
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        micro_steps=micro_steps, kernels=kernels,
        device_ops=[[n[:160], s] for n, s in sorted(
            by_name.items(), key=lambda x: -x[1])[:TOP]],
        idle_gaps=[[n[:160], s] for n, s in sorted(
            gaps.items(), key=lambda x: -x[1])[:TOP]])
