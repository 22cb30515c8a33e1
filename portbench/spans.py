"""Put a ``torch.profiler`` trace's device time and idle gaps down to the
program's spans (``sert.*``, ``sert_tpu_torch/utils/profiling.py``),
recorded inside ``profiling.recording()``.

Inside the traced window (``trace.WINDOW`` on the window's thread):

* ``span_device``: each device operation's seconds go to the innermost
  program span around the CPU operation that launched it (the profiler's
  linked correlation id), on the launching thread; where that thread
  holds no program span (the autograd engine's device thread runs the
  backward), to the innermost span on the window's thread at the launch;
  else to ``NO_SPAN``.
* ``span_host``: each span's own seconds on its thread (its wall time less
  the spans directly inside it), summed by name.
* ``idle_gaps``: each idle gap named by the host at its middle: the
  harness span, the innermost program span on the window's thread, where
  that is ``sert.feed.wait`` the feeder thread's innermost span, and the
  innermost host operation.
* ``feed``: each item the window's thread waited for, its put on the
  feeder thread joined to its wait by the idents the program keeps
  (``profiling.span_idents``).

The profiler mirrors each span as a device row as well; ``without_spans``
gives the trace without the spans and those rows, which is what
``trace.read`` reads, so that its metrics read as they do unrecorded.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from portbench import trace

PREFIX = "sert."
NO_SPAN = "(no span)"
FEED_WAIT = "sert.feed.wait"
FEED_PUT = "sert.feed.put"


@dataclasses.dataclass
class SpanTrace:
    micro_steps: int
    device_s: float                  # every device operation's seconds
    span_device: Dict[str, float]    # device seconds by innermost span
    span_host: Dict[str, float]      # own host seconds by span
    idle_gaps: List[List]            # [what the host did, seconds]
    feed: List[Tuple]                # (ident, put (a, b), wait (a, b)), s


class _Trace:
    """A trace's events, read as ``trace.read`` reads a profiler's."""

    def __init__(self, events: list):
        self._events = events

    def events(self) -> list:
        return self._events


def without_spans(prof) -> _Trace:
    """``prof``'s trace without the program's spans and their device
    rows."""
    return _Trace([e for e in prof.events()
                   if not e.name.startswith(PREFIX)])


class _Nest:
    """Spans of one thread, which nest: the innermost one at a time."""

    def __init__(self, spans: Sequence[Tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (a, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else None

    def own_seconds(self, w0: float, w1: float) -> Dict[str, float]:
        own: Dict[str, float] = collections.defaultdict(float)
        for i, (a, b, name) in enumerate(self.spans):
            d = max(0.0, min(b, w1) - max(a, w0)) * 1e-6
            own[name] += d
            if self.parent[i] >= 0:
                own[self.spans[self.parent[i]][2]] -= d
        return own


def _innermost_op(cpu: List[Tuple[float, float, str]], starts: List[float],
                  t: float) -> Tuple[Optional[str], Optional[str]]:
    """(the harness span, the innermost host operation) on the window's
    thread at ``t``, as ``trace._host_label`` finds them."""
    span = inner = None
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 5000, -1), -1):
        a, b, name = cpu[j]
        if b < t or name == trace.WINDOW:
            continue
        if name.startswith(trace.SPAN_PREFIX):
            span = name
            break
        if inner is None:
            inner = name
    return span, inner


def _join_idents(events, t0_ns: Optional[int],
                 idents: Dict[str, List[Tuple[int, Hashable]]]
                 ) -> Dict[int, Hashable]:
    """Each recorded feed span (by its event's position) -> the ident kept
    nearest its start on the wall clock."""
    out: Dict[int, Hashable] = {}
    if t0_ns is None:
        return out
    for name in (FEED_PUT, FEED_WAIT):
        kept = sorted(idents.get(name, []), key=lambda x: x[0])
        times = [k[0] for k in kept]
        if not kept:
            continue
        for pos, e in enumerate(events):
            if e.name != name:
                continue
            t = t0_ns + e.time_range.start * 1e3
            i = bisect.bisect_left(times, t)
            near = [j for j in (i - 1, i) if 0 <= j < len(kept)]
            j = min(near, key=lambda j: abs(times[j] - t))
            out[pos] = kept[j][1]
    return out


def _trace_start_ns(prof) -> Optional[int]:
    try:
        return int(prof.profiler.kineto_results.trace_start_ns())
    except AttributeError:
        return None


def _device_type(dt) -> bool:
    return getattr(dt, "name", str(dt)) != "CPU"


def _launches(prof, events) -> Tuple[Dict[int, int],
                                     Dict[int, Tuple[int, float]]]:
    """(each device operation's id -> the id of the CPU operation that
    launched it, each CPU operation's id -> (its thread, its start in
    us)), from the profiler's own events where it keeps them (its
    ``FunctionEvent`` carries the link only in some versions of torch)."""
    try:
        raw = prof.profiler.kineto_results.events()
        t0 = prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        raw = None
    link: Dict[int, int] = {}
    ops: Dict[int, Tuple[int, float]] = {}
    if raw is not None:
        for k in raw:
            if _device_type(k.device_type()):
                link[k.correlation_id()] = k.linked_correlation_id()
            elif k.linked_correlation_id() == 0:
                ops[k.correlation_id()] = (k.start_thread_id(),
                                           (k.start_ns() - t0) * 1e-3)
        return link, ops
    for e in events:
        if trace._is_device(e):
            link[e.id] = e.linked_correlation_id
        elif e.linked_correlation_id == 0 and not e.name.startswith(PREFIX):
            ops[e.id] = (e.thread, e.time_range.start)
    return link, ops


def read(prof, micro_steps: int,
         idents: Optional[Dict[str, List[Tuple[int, Hashable]]]] = None
         ) -> Optional[SpanTrace]:
    """The program's spans in the traced window of ``prof``; None where it
    holds no device operation or no program span. ``idents``: what
    ``profiling.span_idents()`` returned after the trace."""
    events = list(prof.events())
    win = [e for e in events
           if e.name == trace.WINDOW and not trace._is_device(e)]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    main = win[0].thread
    by_thread: Dict[int, list] = collections.defaultdict(list)
    cpu_main = []
    for e in events:
        if trace._is_device(e):
            continue
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(PREFIX):
            by_thread[e.thread].append((a, b, e.name))
        elif e.thread == main:
            cpu_main.append((a, b, e.name))
    if not by_thread.get(main):
        return None
    nests = {th: _Nest(s) for th, s in by_thread.items()}

    link, launches = _launches(prof, events)
    span_device: Dict[str, float] = collections.defaultdict(float)
    dev = []
    for e in events:
        if not trace._is_device(e) or e.name.startswith(
                (PREFIX, trace.SPAN_PREFIX)):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = None
        launch = launches.get(link.get(e.id, 0))
        if launch is not None:
            th, t = launch
            if th in nests:
                name = nests[th].at(t)
            if name is None:
                name = nests[main].at(t)
        span_device[name or NO_SPAN] += (b - a) * 1e-6
    if not dev:
        return None

    span_host: Dict[str, float] = collections.defaultdict(float)
    for nest in nests.values():
        for name, s in nest.own_seconds(w0, w1).items():
            span_host[name] += s

    cpu_main.sort()
    starts = [c[0] for c in cpu_main]
    others = [n for th, n in nests.items() if th != main]
    gaps: Dict[str, float] = collections.defaultdict(float)
    busy = trace._union(dev)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        t = 0.5 * (a + b)
        harness, op = _innermost_op(cpu_main, starts, t)
        prog = nests[main].at(t)
        feeder = None
        if prog == FEED_WAIT:
            feeder = next((s for s in (n.at(t) for n in others) if s),
                          "the feeder idle")
        parts = [p for p in (harness, prog, feeder, op) if p]
        gaps[" > ".join(parts) or "between the harness's calls"] += \
            (b - a) * 1e-6

    joined = _join_idents(events, _trace_start_ns(prof), idents or {})
    puts, waits = {}, []
    for pos, ident in joined.items():
        e = events[pos]
        ab = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name == FEED_PUT:
            puts[ident] = ab
        elif e.thread == main and w0 <= e.time_range.start <= w1:
            waits.append((ident, ab))
    feed = [(ident, puts[ident], ab) for ident, ab in sorted(
        waits, key=lambda x: x[1]) if ident in puts]

    return SpanTrace(
        micro_steps=micro_steps,
        device_s=sum(b - a for a, b in dev) * 1e-6,
        span_device=dict(sorted(span_device.items(), key=lambda x: -x[1])),
        span_host=dict(sorted(span_host.items(), key=lambda x: -x[1])),
        idle_gaps=[[n[:160], s] for n, s in sorted(
            gaps.items(), key=lambda x: -x[1])[:trace.TOP]],
        feed=feed)
