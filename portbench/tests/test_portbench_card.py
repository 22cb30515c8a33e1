"""Each cell on the card, a short window: correct, with every metric it
lists. Run on the card: ``python -m pytest -m gpu portbench/tests``."""

from __future__ import annotations

import json
import time

import pytest

from portbench import run
from portbench.tests.portbench_cells import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    out = run.run_cell(REPO, cell, 1234 + trace, 2.0, bool(trace), "cuda",
                       time.perf_counter())
    assert out["correct"], out["checks"]
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for name in want:
            if "roofline" in name or "mfu" in name:
                assert 0 < out["metrics"][name]["value"] <= 100
