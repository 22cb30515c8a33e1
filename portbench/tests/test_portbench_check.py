"""The check on the CPU at a small size: the reference agrees with the
port's dense and lazy steps, and a run whose timed path is broken, or the
control in the program's place, comes out not correct."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import calibrate, check, host, run
from portbench.tests.portbench_cells import TINY, make_root

CELLS = sorted(TINY)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


def _run(root, cell, seed=5, trace=False):
    return run.run_cell(root, cell, seed, 0.5, trace, "cpu",
                        time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_ports_cpu_step(root, cell):
    out = _run(root, cell, seed=2 ** 31 + 11)
    assert out["correct"], out["checks"]
    assert list(out["checks"]) == list(check.NAMES)
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # The CPU has no device trace: the metrics read from one are left out.
    assert set(out["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                   if cell in m.get("workloads", [cell])
                                   and m["source"] != "device_trace"}
    assert json.loads(json.dumps(run._plain(out)))


def _frozen(real):
    """make_train_step whose step computes its loss and leaves the state
    as it was."""
    def make(*args, **kwargs):
        inner = real(*args, **kwargs)

        def step(state, batch):
            keep = ({k: v.clone() for k, v in state.params.items()},
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in state.opt_state.items()})
            state, metrics = inner(state, batch)
            for k, v in keep[0].items():
                state.params[k].copy_(v)
            for k, v in keep[1].items():
                if torch.is_tensor(v):
                    state.opt_state[k].copy_(v)
                else:
                    state.opt_state[k] = v
            return state, metrics
        return step
    return make


def _half(real):
    """make_train_step whose step trains on the first half of each
    batch's rows."""
    def make(*args, **kwargs):
        inner = real(*args, **kwargs)

        def step(state, batch):
            B = batch["entities"].shape[-1]
            axis = batch["entities"].dim() - 1
            return inner(state, {k: v.narrow(axis, 0, B // 2)
                                 for k, v in batch.items()})
        return step
    return make


def _skipping(real):
    """make_train_step whose step, called on a group of micro-steps, runs
    the first and skips the rest."""
    def make(*args, **kwargs):
        inner = real(*args, **kwargs)

        def step(state, batch):
            if batch["entities"].dim() == 2:
                batch = {k: v[:1] for k, v in batch.items()}
            return inner(state, batch)
        return step
    return make


def _altered(real):
    """The sampled softmax's loss altered by 1 % where it is produced."""
    def tail(*args, **kwargs):
        return real(*args, **kwargs) * 1.01
    return tail


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_loss", "group_skipped"])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    from sert_tpu_torch.models import lse
    from sert_tpu_torch.train import step
    wrap = {"unchanged_state": _frozen, "half_batch": _half,
            "group_skipped": _skipping}.get(fault)
    if wrap is not None:
        monkeypatch.setattr(step, "make_train_step",
                            wrap(step.make_train_step))
    else:
        monkeypatch.setattr(lse, "sampled_softmax_tail",
                            _altered(lse.sampled_softmax_tail))
    out = _run(root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    """The reference computed in float8 where the configuration computes
    in bfloat16, read as the program is, fails the cell's limits; the
    program, on the same seed, passes them. So do the planted faults."""
    limits = json.loads((root / "portbench" / "limits"
                         / f"{cell}.json").read_text())
    got = dict(calibrate.readings(root, cell, 3, "cpu", planted=True))
    assert check.verdict(got["program"], limits)[0], got["program"]
    for kind in calibrate.FAULTS:
        assert not check.verdict(got[kind], limits)[0], (kind, got[kind])


@pytest.mark.parametrize("cell", CELLS[:1])
def test_traced_run_reports_its_spans(root, cell):
    out = _run(root, cell, trace=True)
    assert out["correct"]
    # The CPU has no device trace and no device allocator: only the
    # state's metric remains; the window's host spans are in the record.
    assert set(out["metrics"]) == {"state_gib"}
    assert out["device"]["busy_s"] == 0.0
    spans = out["spans"]
    assert spans["micro_steps"] > 0 and spans["window_s"] > 0
    assert 0 < spans["feed_wait_s"] + spans["step_enqueue_s"] \
        <= spans["window_s"]


def test_the_record_holds_the_windows_host_cpu_time(root):
    """``host_cpu_ms`` (the process's CPU clock around the window) agrees
    with the threads' CPU time that ``/proc`` kept for the same window, to
    10 % and the ticks ``/proc`` counts in."""
    out = _run(root, CELLS[0], seed=9)
    h, n = out["host"], out["spans"]["micro_steps"]
    assert h["host_cpu_ms"] > 0 and "main" in h["threads"]
    tol = 0.1 * h["host_cpu_ms"] + 3e3 * host.TICK_S / n
    assert abs(h["host_cpu_ms"] - h["process_cpu_ms"]) <= tol
    assert h["process_cpu_ms"] == pytest.approx(
        h["threads_cpu_ms"] + h["ended_threads_cpu_ms"])
