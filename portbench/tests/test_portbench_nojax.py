"""What the benchmark loads holds neither JAX nor the JAX package, and
the reference nothing of the program; the benchmark reads nothing of the
JAX side's benchmark."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.portbench_cells import BENCH, REPO

JAX_SIDE = {"jax", "jaxlib", "flax", "sert_tpu"}

_LOAD = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

RUN_SIDE = """
from portbench import calibrate, run, spec, train_cell, trace
train_cell.Program()
bench = json.load(open({bench!r}))
for m in bench['per_layer'] + bench['end_to_end']:
    spec.reader({root!r}, m['name'])
for w in bench['workloads']:
    spec.runner({root!r}, spec.find_cell({root!r}, w['name']).traffic['kind'])
"""


def _top_level(body: str) -> set:
    code = _LOAD.format(root=str(REPO), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_side_loads_no_jax():
    loaded = _top_level(RUN_SIDE.format(
        bench=str(REPO / "BENCHMARK.json"), root=str(REPO)))
    assert "sert_tpu_torch" in loaded         # the program is there
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level("from portbench import reference")
    assert not loaded & (JAX_SIDE | {"sert_tpu_torch"})


def test_run_names_jax_when_it_is_loaded(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH.rglob("*") if p.suffix in (".py", ".json")
    and "__pycache__" not in p.parts and p.name != "test_portbench_nojax.py"))
def test_no_source_reads_the_jax_side(path):
    text = path.read_text()
    for word in ("import jax", "from jax", "import sert_tpu\n",
                 "from sert_tpu ", "from sert_tpu.", "benchmarks/",
                 "bench.py"):
        assert word not in text, (path, word)
