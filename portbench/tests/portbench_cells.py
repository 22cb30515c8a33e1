"""Small copies of the benchmark's cells for the CPU tests: a checkout root
under a temporary directory whose ``BENCHMARK.json`` holds the real
cells' configurations cut to a few thousand rows, with the real traffic,
runners and readers, and limits of their own set on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
# (cell, the real cell it cuts down)
TINY = {"tiny.train": "lse1m.train", "tinylazy.train": "lse10m.train_lazy"}
# The tiny cells' limits, set on the CPU as the real cells' are on the card
# (PERF.md §2), between the program's largest reading over 8 seeds and the
# smallest of the control (3 seeds) or, for ``change_gap``, of the planted
# faults: near lower^0.4 * upper^0.6. Readings (program / upper):
# tiny.train loss 2.51e-6 / 1.67e-5, grad_gap 9.45e-5 / 1.16e-3,
# grad_diff 2.88e-3 / 4.44e-2, change_gap 1.38e-4 / 0.159;
# tinylazy.train 2.12e-6 / 1.60e-5, 6.09e-4 / 2.04e-3, 4.54e-3 / 4.40e-2,
# 7.91e-4 / 0.224.
TINY_LIMITS = {
    "tiny.train": {"loss_gap": 8e-6, "grad_gap": 4e-4, "grad_diff": 1.5e-2,
                   "change_gap": 1e-2, "rows_outside": 0},
    "tinylazy.train": {"loss_gap": 7e-6, "grad_gap": 1.2e-3,
                       "grad_diff": 1.8e-2, "change_gap": 2.3e-2,
                       "rows_outside": 0}}


def tiny_config(real: dict, name: str) -> dict:
    c = json.loads(json.dumps(real))
    c["name"] = name
    c["vocab_size"], c["num_entities"], c["num_instances"] = 3000, 20000, 4096
    r = c["recipe"]
    r["train"]["batch_size"] = 256
    r["train"]["log_every_steps"] = 8
    r["model"]["num_negatives"] = 1024
    r["data"]["instances_per_shard"] = 1024
    return c


def make_root(tmp: Path) -> Path:
    """A checkout root under ``tmp`` with the tiny cells beside the real
    ones; returns it."""
    root = Path(tmp) / "checkout"
    (root / "portbench").mkdir(parents=True)
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(BENCH / sub, root / "portbench" / sub)
    for runner in BENCH.glob("*_cell.py"):
        shutil.copy(runner, root / "portbench" / runner.name)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, real in TINY.items():
        work = next(w for w in bench["workloads"] if w["name"] == real)
        conf = next(c for c in bench["configs"] if c["name"] == work["config"])
        name = cell.split(".")[0]
        tiny = tiny_config(json.loads((REPO / conf["file"]).read_text()),
                           name)
        path = f"portbench/configs/{name}.json"
        (root / path).write_text(json.dumps(tiny))
        bench["configs"].append({**conf, "name": name, "file": path})
        bench["workloads"].append({**work, "name": cell, "config": name})
        (root / "portbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS[cell]))
        for m in bench["per_layer"] + bench["end_to_end"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
