"""The port's run fusion and ranker report (sert_tpu_torch.eval.fuse,
eval.report and the ``fuse`` / ``report`` commands) against the
reference's (sert_tpu.eval.fuse, eval.report, ``python -m sert_tpu
fuse|report``) on the CPU.

``fuse_runs`` and the report's tables are the same host numpy code in
both packages, so fused runs, run files, CLI output and the lm ranker's
metrics are held equal. The model ranker scores in fp32 in each
package's own framework: its scores are held within 1e-5 (fp32
reassociation of the same products) and its rankings equal up to ties
of that size. The interp and rrf rankers fuse it: their scores are held
within 1e-4 (a min-max normalized score moves by the model's error over
its topic's score range), the metrics of every ranker within 1e-6.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu import cli as ref_cli  # noqa: E402
from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu import recipes  # noqa: E402
from sert_tpu.eval import fuse as ref_fuse  # noqa: E402
from sert_tpu.eval import report as ref_report  # noqa: E402
from sert_tpu.eval.trec import (write_qrels, write_run,  # noqa: E402
                                write_topics)
from sert_tpu.utils.config import save_config  # noqa: E402
from sert_tpu_torch import cli  # noqa: E402
from sert_tpu_torch.eval import (build_ranker_runs, format_markdown,  # noqa: E402
                                 fuse_runs, ranker_report)

SCORE_TOL = 1e-5


def _runs(seed, n_runs=2, topics=6, docs=12):
    """Seeded runs over shared and unshared docs and topics, with exact
    ties, a one-entry topic and an all-equal topic."""
    rng = np.random.default_rng(seed)
    runs = []
    for r in range(n_runs):
        run = {}
        for t in range(topics - (r % 2)):       # a topic in one run only
            n = int(rng.integers(1, docs))
            ds = rng.choice(docs, size=n, replace=False)
            scores = np.round(rng.normal(size=n), 1)   # ties
            run[f"q{t}"] = [(f"d{d}", float(s)) for d, s in zip(ds, scores)]
        run["flat"] = [(f"d{d}", 0.5) for d in range(3 + r)]
        runs.append(run)
    return runs


@pytest.mark.parametrize("k", [0, 5])
@pytest.mark.parametrize("weights", [None, [0.3, 0.7], [1.0, 0.0]])
@pytest.mark.parametrize("method,norm", [("interp", "minmax"),
                                         ("interp", "zscore"),
                                         ("interp", "none"), ("rrf", "minmax")])
def test_fuse_runs_matches_reference(method, norm, weights, k):
    runs = _runs(len(str(weights)) + k)
    kw = dict(weights=weights, method=method, norm=norm, k=k, rrf_k=30.0)
    assert fuse_runs(runs, **kw) == ref_fuse.fuse_runs(runs, **kw)


def test_fuse_runs_of_three_and_its_refusals_match_reference():
    runs = _runs(9, n_runs=3)
    assert fuse_runs(runs) == ref_fuse.fuse_runs(runs)
    for bad in (dict(runs=[]), dict(runs=runs, weights=[1.0]),
                dict(runs=runs, method="borda"),
                dict(runs=runs, norm="rank")):
        with pytest.raises(ValueError) as want:
            ref_fuse.fuse_runs(**bad)
        with pytest.raises(ValueError, match=str(want.value)):
            fuse_runs(**bad)


# --- the commands on a run the reference trained -----------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(recipe JSON, data dir, run dir, topics, qrels, model run file, lm
    run file) of a tiny log-linear collection the reference prepared and
    trained."""
    root = tmp_path_factory.mktemp("report")
    recipe = recipes.tiny_recipe("loglinear")
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, num_epochs=2))
    col = recipes.tiny_spec(seed=6).build()
    data, run = str(root / "data"), str(root / "run")
    ref_pipeline.prepare_collection(col, data, recipe)
    ref_pipeline.train_from_dir(recipe, data, run, resume=False)
    recipe_path, topics, qrels = (str(root / n) for n in
                                  ("recipe.json", "topics.tsv", "qrels.trec"))
    save_config(recipe, recipe_path)
    write_topics(col.topics, topics)
    write_qrels(col.qrels, qrels)
    runs = ref_report.build_ranker_runs(recipe, data, run, col.topics)
    paths = {}
    for name in ("model", "lm"):
        paths[name] = str(root / f"{name}.trec")
        write_run(runs[name], paths[name])
    return recipe_path, data, run, topics, qrels, paths, col


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    [], ["--method", "rrf", "--rrf-k", "20"],
    ["--weights", "0.3", "0.7", "--norm", "zscore", "-k", "10"],
    ["--norm", "none", "--weights", "2", "1"],
])
def test_fuse_cli_is_byte_equal_to_the_reference(trained, tmp_path, capsys,
                                                 flags):
    paths = trained[5]
    outs = {}
    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        out = str(tmp_path / f"{name}.trec")
        rc, text = _cli(main, ["fuse", "--runs", paths["model"],
                               paths["lm"], "--out", out, *flags], capsys)
        assert rc == 0
        outs[name] = (open(out, "rb").read(), text.replace(out, "OUT"))
    assert outs["port"] == outs["ref"]
    assert outs["port"][0]


@pytest.mark.parametrize("argv", [
    ["fuse", "--runs", "MODEL", "--out", "OUT"],
    ["fuse", "--runs", "MODEL", "LM", "--out", "OUT", "--weights", "1"],
])
def test_fuse_cli_errors_match_the_reference(trained, tmp_path, argv):
    paths = trained[5]
    argv = [{"MODEL": paths["model"], "LM": paths["lm"],
             "OUT": str(tmp_path / "f.trec")}.get(a, a) for a in argv]
    with pytest.raises(SystemExit) as want:
        ref_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    assert str(got.value) == str(want.value) != ""


def _same_run(got, want, tol=SCORE_TOL):
    """Equal ids up to ties within ``tol``; scores within ``tol``."""
    assert got.keys() == want.keys()
    for q in want:
        g, w = got[q], want[q]
        assert len(g) == len(w), q
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=tol, rtol=0, err_msg=q)
        for (gn, gs), (wn, ws) in zip(g, w):
            assert gn == wn or abs(dict(w).get(gn, -np.inf) - gs) <= tol, q


def test_ranker_runs_match_the_reference(trained):
    recipe_path, data, run, _, _, _, col = trained
    recipe = cli.load_recipe(recipe_path)
    got = build_ranker_runs(recipe, data, run, col.topics, device="cpu")
    want = ref_report.build_ranker_runs(recipe, data, run, col.topics)
    assert got.keys() == want.keys() == {"model", "lm", "interp", "rrf"}
    assert got["lm"] == want["lm"]
    _same_run(got["model"], want["model"])
    for name in ("interp", "rrf"):     # fusions of the model's run
        _same_run(got[name], want[name], tol=1e-4)


def _report_argv(trained, *extra):
    recipe_path, data, run, topics, qrels = trained[:5]
    return ["report", "--recipe", recipe_path, "--data", data, "--run-dir",
            run, "--topics", topics, "--qrels", qrels, *extra]


def test_report_json_matches_the_reference(trained, capsys):
    rc, want = _cli(ref_cli.main, _report_argv(trained, "--json"), capsys)
    assert rc == 0
    rc, got = _cli(cli.main, _report_argv(trained, "--json", "--device",
                                          "cpu"), capsys)
    assert rc == 0
    got, want = json.loads(got), json.loads(want)
    assert got["rankers"]["lm"] == want["rankers"]["lm"]
    assert got.keys() == want.keys() and got["measures"] == want["measures"]
    for name, row in want["rankers"].items():
        for m, v in row["all"].items():
            assert got["rankers"][name]["all"][m] == pytest.approx(
                v, abs=1e-6), (name, m)
        for m, c in row.get("vs_baseline", {}).items():
            assert got["rankers"][name]["vs_baseline"][m] == pytest.approx(
                c, abs=1e-6), (name, m)


def test_report_markdown_matches_the_reference(trained, tmp_path, capsys):
    outs = {}
    for name, main, dev in (("ref", ref_cli.main, []),
                            ("port", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.md")
        rc, text = _cli(main, _report_argv(trained, "--out", out,
                                           "--title", "tiny", *dev), capsys)
        assert rc == 0 and text.strip() == f"wrote report for 4 rankers to "\
            f"{out}"
        outs[name] = open(out).read()
    assert outs["port"] == outs["ref"]
    assert "### tiny" in outs["port"]
    assert "| lm (baseline) |" in outs["port"]


def test_lm_only_report_needs_no_device(trained, capsys):
    recipe_path, data, _, topics, qrels = trained[:5]
    argv = ["report", "--recipe", recipe_path, "--data", data, "--topics",
            topics, "--qrels", qrels]
    rc, want = _cli(ref_cli.main, argv, capsys)
    assert rc == 0
    rc, got = _cli(cli.main, argv, capsys)
    assert rc == 0 and got == want
    assert "| model |" not in got and "| lm (baseline) |" in got


@pytest.mark.parametrize("extra,match", [
    (["--fuse-weight", "1.5"], "fuse-weight"),
    (["--step", "99999"], "no checkpoint"),
])
def test_report_errors_exit_as_the_reference(trained, extra, match):
    argv = _report_argv(trained, *extra)
    with pytest.raises(SystemExit, match=match) as want:
        ref_cli.main(argv)
    with pytest.raises(SystemExit, match=match) as got:
        cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


# --- the reference's report cases (tests/test_report.py) on the port --------

def _mk_runs(n_topics=12):
    """model ranks the relevant entity first on every topic; lm only on
    half — a visible, significant delta."""
    model, lm = {}, {}
    for i in range(n_topics):
        qid = f"q{i}"
        rel, other = f"e{i}", f"x{i}"
        model[qid] = [(rel, 2.0), (other, 1.0)]
        lm[qid] = ([(rel, 2.0), (other, 1.0)] if i % 2 == 0
                   else [(other, 2.0), (rel, 1.0)])
    qrels = {f"q{i}": {f"e{i}": 1} for i in range(n_topics)}
    return {"model": model, "lm": lm}, qrels


def test_deltas_and_significance():
    runs, qrels = _mk_runs()
    rep = ranker_report(runs, qrels, measures=("recip_rank",),
                        n_samples=5000)
    assert rep == ref_report.ranker_report(runs, qrels,
                                           measures=("recip_rank",),
                                           n_samples=5000)
    assert rep["baseline"] == "lm"
    assert "vs_baseline" not in rep["rankers"]["lm"]
    vs = rep["rankers"]["model"]["vs_baseline"]["recip_rank"]
    assert rep["rankers"]["model"]["all"]["recip_rank"] == 1.0
    assert rep["rankers"]["lm"]["all"]["recip_rank"] == 0.75
    assert vs["delta"] == pytest.approx(0.25)
    assert vs["p_randomization"] < 0.05


def test_markdown_marks_significance():
    runs, qrels = _mk_runs()
    rep = ranker_report(runs, qrels, measures=("recip_rank", "map"),
                        n_samples=5000)
    md = format_markdown(rep, title="t")
    assert md == ref_report.format_markdown(rep, title="t")
    assert "### t" in md and "| lm (baseline) |" in md
    model_row = next(r for r in md.splitlines() if r.startswith("| model"))
    assert "†" in model_row
    lm_row = next(r for r in md.splitlines() if r.startswith("| lm"))
    assert "†" not in lm_row
    json.dumps(rep)
