"""The program's spans read from a made-up profiler trace (``spans.py``),
and from a real one on the CPU."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import spans, trace

T0 = 1_700_000_000_000_000_000      # the trace's start, wall clock ns
MAIN, AUTOGRAD, FEEDER = 1, 2, 3


def _ev(name, a, b, thread=MAIN, device=False, id=0, link=0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        thread=0 if device else thread, id=id, linked_correlation_id=link,
        device_type=types.SimpleNamespace(name="CUDA" if device else "CPU"))


class _Prof:
    """A profiler's parsed events; with ``kineto``, those events without
    their link to the CPU operations (as some versions of torch parse
    them) and the profiler's own events, which keep it."""

    def __init__(self, events, kineto=False):
        self._events = events
        for i, e in enumerate(events):
            if e.device_type.name != "CPU":
                e.id = 1000 + i          # the launch's correlation id
        results = types.SimpleNamespace(trace_start_ns=lambda: T0)
        if kineto:
            results.events = lambda: [_kineto(e) for e in events]
            self._events = [types.SimpleNamespace(**{
                k: v for k, v in vars(e).items()
                if k != "linked_correlation_id"}) for e in events]
        self.profiler = types.SimpleNamespace(kineto_results=results)

    def events(self):
        return list(self._events)


def _kineto(e):
    return types.SimpleNamespace(
        device_type=lambda: e.device_type, correlation_id=lambda: e.id,
        linked_correlation_id=lambda: e.linked_correlation_id,
        start_thread_id=lambda: e.thread,
        start_ns=lambda: T0 + int(e.time_range.start * 1e3))


def _harness():
    """A traced window (us) of one micro-step and one feed wait, and the
    device's operations, without the program's spans."""
    return [
        _ev(trace.WINDOW, 0, 1000),
        _ev("portbench.step", 10, 880),
        _ev("aten::mm", 40, 60, id=11),
        _ev("aten::mul", 220, 230, thread=AUTOGRAD, id=12),
        _ev("aten::add", 520, 530, id=13),
        _ev("aten::index", 812, 840, id=15),
        _ev("portbench.feed", 900, 990),
        _ev("aten::copy_", 955, 958, thread=FEEDER, id=14),
        _ev("mm_kernel", 100, 150, device=True, link=11),
        _ev("mul_kernel", 300, 400, device=True, link=12),
        _ev("add_kernel", 600, 650, device=True, link=13),
        _ev("index_kernel", 850, 860, device=True, link=15),
        _ev("a kernel of an unknown launch", 700, 710, device=True, link=99),
        _ev("Memcpy HtoD (Pinned -> Device)", 960, 962, device=True,
            link=14)]


def _program():
    """The program's spans in that window, and the device rows the
    profiler mirrors some of them in."""
    return [
        _ev("sert.step.micro", 20, 800),
        _ev("sert.step.loss", 30, 200),
        _ev("sert.step.backward", 210, 505),
        _ev("sert.step.optimizer", 510, 700),
        _ev("sert.step.dedup", 810, 845),
        _ev("sert.feed.wait", 905, 985),
        _ev("sert.feed.put", 880, 995, thread=FEEDER),
        _ev("sert.feed.read", 885, 950, thread=FEEDER),
        _ev("sert.feed.copy", 950, 990, thread=FEEDER),
        _ev("sert.step.loss", 100, 150, device=True),
        _ev("sert.step.micro", 100, 710, device=True)]


IDENTS = {"sert.feed.put": [(T0 + 860_000, (0, 4)), (T0 + 879_000, (0, 5))],
          "sert.feed.wait": [(T0 + 904_000, (0, 5))]}


@pytest.mark.parametrize("kineto", [False, True])
def test_device_time_goes_to_the_span_that_launched_it(kineto):
    got = spans.read(_Prof(_harness() + _program(), kineto), 1, IDENTS)
    # mm in the loss; mul from the autograd thread, which holds no span,
    # to the main thread's span at its launch; the feeder's copy to its
    # own thread's span; a kernel without a known launch to none.
    assert got.span_device == pytest.approx({
        "sert.step.loss": 50e-6, "sert.step.backward": 100e-6,
        "sert.step.optimizer": 50e-6, "sert.step.dedup": 10e-6,
        "sert.feed.copy": 2e-6, spans.NO_SPAN: 10e-6})
    assert got.device_s == pytest.approx(222e-6)
    # Own host time: the micro-step less its three parts inside it.
    assert got.span_host["sert.step.micro"] == pytest.approx(
        (780 - 170 - 295 - 190) * 1e-6)
    assert got.span_host["sert.feed.put"] == pytest.approx(
        (115 - 65 - 40) * 1e-6)
    assert got.span_host["sert.feed.wait"] == pytest.approx(80e-6)


def test_idle_gaps_name_the_program_span_and_the_feeder():
    got = dict(map(tuple, spans.read(_Prof(_harness() + _program()), 1,
                                     IDENTS).idle_gaps))
    # The gap from 860 to 960 has its middle (910) in the consumer's wait
    # while the feeder reads; the one from 962 to 1000 (981) while the
    # feeder copies.
    assert got == pytest.approx({
        "portbench.step > sert.step.loss > aten::mm": 100e-6,
        "portbench.step > sert.step.backward": 150e-6 + 200e-6,
        "portbench.step > sert.step.optimizer": 50e-6,
        "portbench.step > sert.step.micro": 140e-6,
        "portbench.feed > sert.feed.wait > sert.feed.read": 100e-6,
        "portbench.feed > sert.feed.wait > sert.feed.copy": 38e-6})
    assert sum(got.values()) == pytest.approx(1000e-6 - 222e-6)


def test_a_put_is_joined_to_the_wait_that_received_its_item():
    (got,) = spans.read(_Prof(_harness() + _program()), 1, IDENTS).feed
    assert got[0] == (0, 5)
    assert got[1:] == (pytest.approx((880e-6, 995e-6)),
                       pytest.approx((905e-6, 985e-6)))
    assert spans.read(_Prof(_harness() + _program()), 1).feed == []


def test_the_harness_reads_the_same_trace_with_the_program_spans_out():
    """``trace.read`` over ``without_spans`` reads the trace as it is
    without a recording: every existing reader reads the same. Read raw,
    the mirrored device rows would count as device work."""
    bare = trace.read(_Prof(_harness()), 1)
    recorded = _Prof(_harness() + _program())
    assert trace.read(spans.without_spans(recorded), 1) == bare
    assert trace.read(recorded, 1).busy_s > bare.busy_s


def test_nothing_to_read_without_device_work_or_program_spans():
    no_device = [e for e in _harness() + _program()
                 if e.device_type.name == "CPU"]
    assert spans.read(_Prof(no_device), 1) is None
    assert spans.read(_Prof(_harness()), 1) is None
    assert spans.read(_Prof(_program()), 1) is None      # no window


def test_a_recorded_step_on_the_cpu_reads_nothing_and_breaks_nothing():
    """On the CPU the profiler sees no device: the spans are there, and
    the reader finds nothing to put them down to."""
    from torch.profiler import profile, record_function

    from sert_tpu_torch.utils import profiling
    with profiling.recording(), profile(
            **profiling.profile_all_threads()) as prof:
        with record_function(trace.WINDOW):
            with profiling.annotate("sert.step.micro"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.name == "sert.step.micro" for e in prof.events())
    assert spans.read(prof, 1, profiling.span_idents()) is None
    assert trace.read(spans.without_spans(prof), 1) is None


def test_nest_finds_the_innermost_span():
    nest = spans._Nest([(0, 10, "a"), (1, 3, "b"), (4, 6, "c"),
                        (4.5, 5, "d")])
    assert [nest.at(t) for t in (0.5, 2, 3.5, 4.7, 5.5, 7, 11)] == \
        ["a", "b", "a", "d", "c", "a", None]
    assert nest.own_seconds(0, 10) == pytest.approx(
        {"a": 6e-6, "b": 2e-6, "c": 1.5e-6, "d": 0.5e-6})
    assert nest.own_seconds(2, 5) == pytest.approx(
        {"a": 1e-6, "b": 1e-6, "c": 0.5e-6, "d": 0.5e-6})
    assert np.isclose(sum(nest.own_seconds(0, 10).values()), 10e-6)
