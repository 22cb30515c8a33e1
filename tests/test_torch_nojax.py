"""The port runs without JAX: it and its card-side scripts import nothing
of it, directly or through the reference's jax-importing subpackages."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
# The reference's host modules that import no jax (the port reuses them);
# sert_tpu.models, .scoring, .ops, .train and .parallel import jax through
# their packages' __init__.
JAX_FREE = ("sert_tpu.data", "sert_tpu.eval", "sert_tpu.recipes",
            "sert_tpu.utils.config", "sert_tpu.utils.logging")
JAX_DATA = ("sert_tpu.data.feeder", "sert_tpu.data.wirepack")

SERVE_ON_CPU = """
import importlib, pkgutil, sys, tempfile
import sert_tpu_torch
for m in pkgutil.walk_packages(sert_tpu_torch.__path__, "sert_tpu_torch."):
    importlib.import_module(m.name)
from sert_tpu_torch import cli
from sert_tpu_torch.fixture import (read_run, write_eval_inputs,
                                    write_serving_fixture)
from sert_tpu_torch.serving import EntitySearcher
recipe = cli.load_recipe("synthetic_1m_retrieval")
with tempfile.TemporaryDirectory() as root:
    data, run, topics = write_serving_fixture(root, recipe, 600, 400, 5,
                                              seed=1)
    s = EntitySearcher(recipe, data, run, k=50, device="cpu")
    assert s.engine == "pallas"
    hits = s.search_many(list(topics.values()))
    assert [len(h) for h in hits] == [50] * 5, hits
    topics_path, qrels_path = write_eval_inputs(
        root, topics, {q: [int(h[0][0][1:])] for q, h in zip(topics, hits)})
    assert cli.main(["query", "--recipe", "synthetic_1m_retrieval", "--data",
                     data, "--run-dir", run, "--topics", topics_path,
                     "--out", root + "/run.trec", "--device", "cpu"]) == 0
    assert {len(v) for v in read_run(root + "/run.trec").values()} == {400}
    assert cli.main(["evaluate", "--run", root + "/run.trec",
                     "--qrels", qrels_path]) == 0
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("JAX_MODULES", loaded)
"""


def _run(code_or_path, cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, *(["-c", code_or_path] if "\n" in code_or_path
                             else [code_or_path]), *args]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=300)


def test_serving_path_runs_with_no_jax_module_loaded():
    proc = _run(SERVE_ON_CPU, REPO)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "sert_tpu":
                yield from (f"sert_tpu.{a.name}" for a in node.names)
            else:
                yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "sert_tpu_torch").rglob("*.py"),
              REPO / "chip_smoke.py", REPO / "tools/profile_torch_serve.py"]))
def test_no_source_imports_jax(path):
    for name in _imports(REPO / path):
        assert name.split(".")[0] not in ("jax", "jaxlib"), (path, name)
        if name.split(".")[0] == "sert_tpu":
            # The card-side scripts name only the port; the port itself
            # reuses the reference's jax-free host modules.
            assert path.startswith("sert_tpu_torch/"), (path, name)
            assert name.startswith(JAX_FREE), (path, name)
            assert not name.startswith(JAX_DATA), (path, name)


def test_chip_smoke_refuses_a_host_without_cuda(tmp_path):
    """Here (no CUDA device) the smoke run exits non-zero and prints no
    result, from the repo and from a directory holding only the script."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        proc = _run(str(script), cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
