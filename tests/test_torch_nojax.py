"""The port stands alone and runs on the card unless asked for the CPU.

- It imports nothing of JAX and nothing of the reference package
  ``sert_tpu``, directly or indirectly: its host code (data, eval, native,
  recipes, configs, logging) is its own copy, which writes the reference's
  formats byte for byte.
- Its entry points, called without a device on a host without CUDA, stop
  with a message naming ``device="cpu"`` / ``--device cpu`` before doing
  any work.
"""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "sert_tpu")

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
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sert_tpu"))
print("FOREIGN_MODULES", loaded)
"""


# Fold-in (both methods) and the HTTP server on the serving fixture, with
# no jax module loaded: the fixture has no instance shards, so the
# gradient fold-in's pool is the synthesized one.
FOLD_IN_AND_HTTP_ON_CPU = """
import json, sys, tempfile, threading, urllib.request
from sert_tpu_torch import cli
from sert_tpu_torch.fixture import write_serving_fixture
from sert_tpu_torch.serving import EntitySearcher, make_http_server
recipe = cli.load_recipe("synthetic_1m_retrieval")
with tempfile.TemporaryDirectory() as root:
    data, run, topics = write_serving_fixture(root, recipe, 600, 400, 5,
                                              seed=1)
    s = EntitySearcher(recipe, data, run, k=50, device="cpu")
    texts = list(topics.values())
    assert s.add_entities([("new-a", texts[0]), ("new-b", texts[1])]) == 2
    assert s.add_entities([("new-g", texts[2])], method="gradient") == 1
    server = make_http_server(s, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        assert json.loads(r.read())["extra_entities"] == 3
    req = urllib.request.Request(
        base + "/search", data=json.dumps({"queries": texts[:3]}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        batched = json.loads(r.read())["batched"]
    server.shutdown()
    server.server_close()
    names = [[h["entity"] for h in b["results"]] for b in batched]
    assert all("new-" + c in n for c, n in zip("abg", names)), names
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "sert_tpu"))
print("FOREIGN_MODULES", loaded)
"""


def _run(code_or_path, cwd, *args, env=None):
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           **(env or {})}
    cmd = [sys.executable, *(["-c", code_or_path] if "\n" in code_or_path
                             else [code_or_path]), *args]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=300)


# `python -m sert_tpu_torch ARGS` with jax and the reference unimportable.
CLI_BLOCKED = """
import runpy, sys
class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError(f"{name} is blocked: the port must not need it")
sys.meta_path.insert(0, Blocked())
sys.argv = ["sert_tpu_torch", *sys.argv[1:]]
runpy.run_module("sert_tpu_torch", run_name="__main__", alter_sys=True)
""" % (BLOCKED,)


def _cli_blocked_pipeline(tmp_path, recipe):
    from sert_tpu_torch.utils.config import save_config
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, num_epochs=1))
    r, data, run = (str(tmp_path / n) for n in ("r.json", "data", "run"))
    save_config(recipe, r)
    trec = str(tmp_path / "run.trec")
    for args in (["prepare", "--recipe", r, "--out", data],
                 ["train", "--recipe", r, "--data", data, "--out", run,
                  "--device", "cpu"],
                 ["query", "--recipe", r, "--data", data, "--run-dir", run,
                  "--topics", data + "/topics.tsv", "--out", trec,
                  "--device", "cpu"],
                 ["evaluate", "--run", trec, "--qrels",
                  data + "/qrels.trec"]):
        proc = _run(CLI_BLOCKED, REPO, *args)
        assert proc.returncode == 0, (args[0], proc.stderr[-3000:])
    assert (tmp_path / "run.trec").stat().st_size > 0
    return json.loads(proc.stdout)


def test_prepare_train_query_run_with_jax_blocked(tmp_path):
    from sert_tpu_torch import recipes
    metrics = _cli_blocked_pipeline(tmp_path, recipes.tiny_recipe(
        "lse", objective="sampled_softmax", negative_distribution="unigram"))
    assert 0.0 <= metrics["ndcg@100"] <= 1.0


def test_loglinear_runs_with_jax_and_the_reference_blocked(tmp_path):
    from sert_tpu_torch import recipes
    metrics = _cli_blocked_pipeline(tmp_path,
                                    recipes.tiny_recipe("loglinear"))
    assert 0.0 <= metrics["ndcg@100"] <= 1.0


def test_fused_update_runs_with_jax_and_the_reference_blocked(tmp_path):
    """The optimizer-in-backward step (train/fused.py, K7's wrapper)."""
    from sert_tpu_torch import recipes
    recipe = recipes.tiny_recipe("loglinear")
    recipe = dataclasses.replace(
        recipe, model=dataclasses.replace(recipe.model, word_dim=128),
        train=dataclasses.replace(recipe.train, fused_update="on"))
    metrics = _cli_blocked_pipeline(tmp_path, recipe)
    assert 0.0 <= metrics["ndcg@100"] <= 1.0


def test_lazy_nce_step_runs_with_jax_and_the_reference_blocked(tmp_path):
    """The NCE objective (models/lse.py) through the row-sparse lazy step
    (train/sparse.py)."""
    from sert_tpu_torch import recipes
    recipe = recipes.tiny_recipe("lse")
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, sparse_update="on", batch_size=1024))
    metrics = _cli_blocked_pipeline(tmp_path, recipe)
    assert 0.0 <= metrics["ndcg@100"] <= 1.0


def test_packed_feed_runs_with_jax_and_the_reference_blocked(tmp_path):
    """packed_feed="on" (data/wirepack.py, the loop's unpack)."""
    from sert_tpu_torch import recipes
    recipe = recipes.tiny_recipe("lse", objective="sampled_softmax")
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, packed_feed="on", steps_per_call=2))
    metrics = _cli_blocked_pipeline(tmp_path, recipe)
    assert 0.0 <= metrics["ndcg@100"] <= 1.0


def test_fuse_and_report_run_with_jax_and_the_reference_blocked(tmp_path):
    """``fuse`` and ``report`` (eval/fuse.py, eval/report.py, the model
    ranker on the CPU) through the CLI with jax and the reference
    unimportable."""
    from sert_tpu_torch import recipes
    _cli_blocked_pipeline(tmp_path, recipes.tiny_recipe("loglinear"))
    r, data, run = (str(tmp_path / n) for n in ("r.json", "data", "run"))
    lm, fused, md = (str(tmp_path / n) for n in ("lm.trec", "fused.trec",
                                                 "report.md"))
    for args in (["query", "--recipe", r, "--data", data, "--topics",
                  data + "/topics.tsv", "--out", lm, "--ranker", "lm"],
                 ["fuse", "--runs", str(tmp_path / "run.trec"), lm, "--out",
                  fused, "--weights", "0.5", "0.5"],
                 ["report", "--recipe", r, "--data", data, "--run-dir", run,
                  "--topics", data + "/topics.tsv", "--qrels",
                  data + "/qrels.trec", "--out", md, "--device", "cpu"],
                 ["report", "--recipe", r, "--data", data, "--run-dir", run,
                  "--topics", data + "/topics.tsv", "--qrels",
                  data + "/qrels.trec", "--json", "--device", "cpu"]):
        proc = _run(CLI_BLOCKED, REPO, *args)
        assert proc.returncode == 0, (args[0], proc.stderr[-3000:])
    assert set(json.loads(proc.stdout)["rankers"]) == {"model", "lm",
                                                        "interp", "rrf"}
    assert os.path.getsize(fused) > 0
    assert "| lm (baseline) |" in open(md).read()


def test_serving_path_runs_with_no_jax_module_loaded():
    proc = _run(SERVE_ON_CPU, REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout


def test_fold_in_and_http_run_with_no_jax_module_loaded():
    proc = _run(FOLD_IN_AND_HTTP_ON_CPU, REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout


def test_lm_ranker_runs_with_jax_and_the_reference_blocked(tmp_path):
    """``query --ranker lm`` (models/lm.py over the prepared lm_stats)
    through the CLI with jax and the reference unimportable."""
    from sert_tpu_torch import recipes
    from sert_tpu_torch.utils.config import save_config
    r, data = str(tmp_path / "r.json"), str(tmp_path / "data")
    save_config(recipes.tiny_recipe("lse"), r)
    trec = str(tmp_path / "lm.trec")
    for args in (["prepare", "--recipe", r, "--out", data],
                 ["query", "--recipe", r, "--data", data, "--topics",
                  data + "/topics.tsv", "--out", trec, "--ranker", "lm"],
                 ["evaluate", "--run", trec, "--qrels",
                  data + "/qrels.trec"]):
        proc = _run(CLI_BLOCKED, REPO, *args)
        assert proc.returncode == 0, (args[0], proc.stderr[-3000:])
    assert 0.5 <= json.loads(proc.stdout)["ndcg@100"] <= 1.0


def test_mesh_dry_run_with_jax_and_the_reference_blocked():
    """The multi-rank dry run (parallel/dryrun.py) from a process that
    cannot import jax or the reference: a (2, 2) mesh of 4 gloo ranks, its
    sharded step and distributed top-k against one rank, no foreign
    module in any rank."""
    code = CLI_BLOCKED.replace('runpy.run_module("sert_tpu_torch"',
                               'runpy.run_module('
                               '"sert_tpu_torch.parallel.dryrun"')
    proc = _run(code, REPO, "--ranks", "4", "--mesh", "2", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] and len(report["ranks"]) == 4
    assert all(r["foreign"] == [] for r in report["ranks"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "sert_tpu_torch").rglob("*.py"),
              REPO / "chip_smoke.py", *(REPO / "tools").glob("*torch*.py"),
              REPO / "tools/fused_tp_seeds.py",
              REPO / "tools/dpooled_fp64.py",
              REPO / "tools/fused_step_ab.py"]))
def test_no_source_imports_jax(path):
    """Neither jax nor anything of the reference package, by any import
    statement, anywhere in the file (function bodies included)."""
    for name in _imports(REPO / path):
        assert name.split(".")[0] not in BLOCKED, (path, name)


def test_chip_smoke_refuses_a_host_without_cuda(tmp_path):
    """Here (no CUDA device) the smoke run exits non-zero and prints no
    result, from the repo and from a directory holding only the script."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        proc = _run(str(script), cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


# --- the copied host code writes the reference's formats --------------------

def _files(d: Path):
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("use_native", [True, False])
def test_prepare_writes_what_the_reference_writes(tmp_path, use_native):
    from sert_tpu import pipeline as ref_pipeline
    from sert_tpu import recipes as ref_recipes
    from sert_tpu.data import prepare as ref_prepare
    from sert_tpu_torch import pipeline, recipes
    from sert_tpu_torch.data import prepare
    from sert_tpu_torch.native import loader
    if use_native and shutil.which("g++"):
        assert loader.maybe_load() is not None    # built into build/
    col = recipes.tiny_spec(seed=2).build()
    ref_col = ref_recipes.tiny_spec(seed=2).build()
    assert col.docs == ref_col.docs and col.qrels == ref_col.qrels
    recipe = recipes.tiny_recipe("loglinear")
    out = {}
    for name, prep_mod, pipe in (("port", prepare, pipeline),
                                 ("ref", ref_prepare, ref_pipeline)):
        real = prep_mod.prepare

        def fixed(*a, _real=real, **k):
            return _real(*a, use_native=use_native, **k)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pipe, "prepare", fixed)
            pipe.prepare_collection(col, str(tmp_path / name), recipe)
        out[name] = tmp_path / name
    names = _files(out["port"])
    assert names == _files(out["ref"])
    assert {"vocab.json", "entities.json", "assoc.json",
            "instances.meta.json"} <= set(names)
    for n in names:
        a, b = out["port"] / n, out["ref"] / n
        if n.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=n)
        else:
            assert a.read_bytes() == b.read_bytes(), n


def test_recipes_are_the_reference_recipes():
    from sert_tpu import recipes as ref_recipes
    from sert_tpu.utils.config import config_to_dict as ref_to_dict
    from sert_tpu_torch import recipes
    from sert_tpu_torch.utils.config import config_to_dict
    assert list(recipes.RECIPES) == list(ref_recipes.RECIPES)
    for name, fn in recipes.RECIPES.items():
        assert config_to_dict(fn()) == ref_to_dict(ref_recipes.RECIPES[name]())
    for model in ("loglinear", "lse", "lse_full"):
        assert config_to_dict(recipes.tiny_recipe(model)) == ref_to_dict(
            ref_recipes.tiny_recipe(model))
    assert {n: dataclasses.asdict(s) for n, s in recipes.SYNTH_SPECS.items()} \
        == {n: dataclasses.asdict(s)
            for n, s in ref_recipes.SYNTH_SPECS.items()}


# --- card first: no device means the card, never a quiet CPU ---------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_names_the_cpu_option(no_cuda):
    from sert_tpu_torch import pipeline
    with pytest.raises(pipeline.NoCudaDevice,
                       match='device="cpu".*--device cpu'):
        pipeline.default_device()
    assert pipeline.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_without_a_device_stop_before_any_work(no_cuda,
                                                            tmp_path):
    from sert_tpu_torch import pipeline, recipes
    from sert_tpu_torch.serving import EntitySearcher
    recipe = recipes.tiny_recipe("loglinear")
    missing = str(tmp_path / "missing")       # never read: the check is first
    calls = [
        lambda: pipeline.train_from_dir(recipe, missing,
                                        str(tmp_path / "run")),
        lambda: pipeline.run_end_to_end(recipes.tiny_spec().build(), recipe,
                                        str(tmp_path / "e2e")),
        lambda: pipeline.load_scorer(missing, missing, recipe),
        lambda: EntitySearcher(recipe, missing, missing),
    ]
    for call in calls:
        with pytest.raises(pipeline.NoCudaDevice, match="--device cpu"):
            call()
    assert sorted(p.name for p in tmp_path.iterdir()) == []


def test_cli_train_without_device_stops_with_the_advice(tmp_path):
    from sert_tpu_torch import recipes
    from sert_tpu_torch.utils.config import save_config
    save_config(recipes.tiny_recipe("loglinear"), str(tmp_path / "r.json"))
    proc = _run(CLI_BLOCKED, REPO, "train", "--recipe",
                str(tmp_path / "r.json"), "--data", str(tmp_path / "data"),
                "--out", str(tmp_path / "run"),
                env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr
    assert "--device cpu" in proc.stderr and "Traceback" not in proc.stderr
    assert not (tmp_path / "run").exists()
