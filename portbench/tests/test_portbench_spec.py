"""The harness finds a cell's files by name, so that a new cell,
configuration, traffic mix or metric is new files and new entries; and
``run.py`` refuses to run where it cannot measure."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import run, spec
from portbench.tests.portbench_cells import REPO, make_root


def test_real_cells_resolve():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for work in bench["workloads"]:
        cell = spec.find_cell(REPO, work["name"])
        assert cell.chips == work["chips"] == 1
        e2e = {m["name"] for m in cell.end_to_end}
        assert {"peak_mem_gib", "setup_s"} <= e2e
        assert cell.per_layer and all(m["moves"] in e2e
                                      for m in cell.per_layer)
        assert set(cell.limits) == {"loss_gap", "grad_gap", "grad_diff",
                                    "change_gap", "rows_outside"}
        for m in cell.per_layer + cell.end_to_end:
            assert callable(spec.reader(REPO, m["name"]))
        assert callable(spec.runner(REPO, cell.traffic["kind"]).run)


TOY_RUNNER = """
class View:
    setup_s, memory = 0.5, {"peak": 0}

    def __init__(self, ops):
        self.ops = ops


def run(cell, seed, seconds, trace, device, tmp, t_start):
    ops = cell.traffic["ops"] * cell.config["scale"]
    return {"correct": True, "attempted": ops, "failed": 0,
            "checks": {"ops": {"value": ops, "limit": 10 ** 6}},
            "memory_peak_bytes": 0, "view": View(ops)}
"""


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A configuration, two traffic mixes (one of a new kind, with its
    runner), two cells, an end-to-end and two per-layer metrics, one of
    them a quantity split over cells, added as files and entries beside
    files left byte for byte as they were; the new kind's cell runs."""
    root = make_root(tmp_path)
    here = root / "portbench"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((here / "configs/tiny.json").read_text())
    conf["name"], conf["scale"] = "newconf", 3
    (here / "configs/newconf.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic/train.json").read_text())
    mix["signal"] = 0.9
    (here / "traffic/clearer.json").write_text(json.dumps(mix))
    (here / "traffic/toy.json").write_text(json.dumps({"kind": "toy",
                                                       "ops": 7}))
    (here / "toy_cell.py").write_text(TOY_RUNNER)
    for cell in ("newconf.clearer", "newconf.toy"):
        (here / f"limits/{cell}.json").write_text(
            (here / "limits/tiny.train.json").read_text())
    (here / "metrics/calls_per_s.py").write_text(
        "def read(view):\n"
        "    return view.spans['calls'] / view.spans['window_s']\n")
    (here / "metrics/toy_ops.py").write_text(
        "def read(view):\n    return float(view.ops)\n")
    bench["configs"].append({"name": "newconf", "source": "x",
                             "file": "portbench/configs/newconf.json",
                             "reduced": [], "why": "x"})
    for traffic in ("clearer", "toy"):
        bench["workloads"].append({"name": f"newconf.{traffic}",
                                   "config": "newconf", "traffic": traffic,
                                   "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "toy_ops", "unit": "ops",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["newconf.toy"]})
    bench["per_layer"] += [
        {"name": "calls_per_s", "unit": "calls/s", "better": "higher",
         "source": "host_clock", "layer": "train step",
         "moves": "train_windows_per_s", "workloads": ["newconf.clearer"]},
        {"name": "k1_roofline.toy", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "toy_ops",
         "workloads": ["newconf.toy"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell(root, "newconf.clearer")
    assert cell.config["name"] == "newconf"
    assert cell.traffic["signal"] == 0.9
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    read = spec.reader(root, "calls_per_s")

    class View:
        spans = {"calls": 50, "window_s": 2.0}
    assert read(View()) == 25.0
    # The split quantity is read by the reader of its first name.
    assert spec.reader(root, "k1_roofline.toy").__module__ != \
        spec.reader(root, "k1_roofline").__module__
    assert spec.reader(root, "k1_roofline.toy").__code__.co_filename == \
        spec.reader(root, "k1_roofline").__code__.co_filename

    out = run.run_cell(root, "newconf.toy", 1, 1.0, False, "cpu", 0.0)
    assert out["correct"] and out["attempted"] == 21
    assert out["metrics"] == {"toy_ops": {"value": 21.0, "unit": "ops"},
                              "peak_mem_gib": {"value": 0.0, "unit": "GiB"},
                              "setup_s": {"value": 0.5, "unit": "s"}}
    assert list(out)[-1] == "checks"
    assert all(p.read_bytes() == b for p, b in before.items())


def _run(cwd: Path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lse1m.train",
         "--seed", "3", "--seconds", "1", "--trace", "0", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "sert_tpu_torch" in got.stderr


def test_run_refuses_without_a_cuda_device():
    import torch
    if torch.cuda.is_available():
        return        # the card is there: nothing to refuse
    got = _run(REPO)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "CUDA" in got.stderr


def test_both_cells_are_held_to_their_device_time():
    """Each cell's per-layer metrics move a metric the device's trace or
    allocator reads, none the host's clock."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for work in bench["workloads"]:
        cell = spec.find_cell(REPO, work["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert e2e == {"step_device_ms", "peak_mem_gib", "setup_s"}
        moved = {m["moves"] for m in cell.per_layer}
        assert moved == {"step_device_ms", "peak_mem_gib"}
        assert "device_mfu_pct" in {m["name"] for m in cell.per_layer}
