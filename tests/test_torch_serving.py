"""The port's serving path against the JAX reference on one trained run.

A tiny LSE is trained once by the reference (``sert_tpu.pipeline``) and
snapshotted as a bf16 params-only checkpoint, the format the flagship
recipe serves from. Both packages then score the same topics with the
kernel engine (``engine="pallas"``: the Pallas kernels in interpret mode on
the reference side, the kernels' plain versions on the port's side).

Tolerances: the rescored scores are fp32 dot products of the same bf16
params (1e-5); rankings agree up to ties (entities whose scores differ by
less than 1e-5 may trade places); metrics agree to 1e-6.
"""

import dataclasses
import io
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu import recipes  # noqa: E402
from sert_tpu.data.prepare import encode_queries  # noqa: E402
from sert_tpu.eval.metrics import evaluate_run  # noqa: E402
from sert_tpu.eval.trec import read_run, write_qrels, write_topics  # noqa: E402
from sert_tpu.scoring.run import score_topics as ref_score_topics  # noqa: E402
from sert_tpu.utils.config import ScoreConfig  # noqa: E402
from sert_tpu_torch import cli, pipeline  # noqa: E402
from sert_tpu_torch.scoring.run import score_topics  # noqa: E402
from sert_tpu_torch.serving import EntitySearcher, serve_stdin  # noqa: E402
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
K = 20
# 300 entities fill two 128-wide bins and a partial third, so the engine's
# bin selection, tail mask and rescore all take part.
SPEC = recipes.SyntheticSpec(num_entities=300, vocab_size=800,
                             docs_per_entity=2, doc_len=60, num_topics=16,
                             seed=3)


def _recipe(similarity="cosine"):
    r = recipes.tiny_recipe("lse", objective="sampled_softmax")
    return dataclasses.replace(
        r,
        train=dataclasses.replace(r.train, num_epochs=1,
                                  epoch_snapshot="params",
                                  final_snapshot="params",
                                  snapshot_dtype="bfloat16"),
        score=ScoreConfig(top_k=K, engine="pallas", similarity=similarity))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(workdir, recipe, collection): a reference-trained run with a bf16
    params-only snapshot, plus topics and qrels files."""
    w = str(tmp_path_factory.mktemp("served"))
    recipe = _recipe()
    col = SPEC.build()
    ref_pipeline.prepare_collection(col, f"{w}/data", recipe)
    ref_pipeline.train_from_dir(recipe, f"{w}/data", f"{w}/run",
                                resume=False)
    write_topics(col.topics, f"{w}/topics.tsv")
    write_qrels(col.qrels, f"{w}/qrels.trec")
    return w, recipe, col


def _resolved(w, recipe):
    from sert_tpu.data.instances import InstanceDataset
    return pipeline.resolve_model_config(recipe, InstanceDataset(
        f"{w}/data").meta)


def _assert_same_run(got, want):
    """Same topics, same depth, scores within TOL rank by rank; an entity
    in one run only must sit at a tie with the other run's last score."""
    assert got.keys() == want.keys()
    for qid in want:
        g, r = dict(got[qid]), dict(want[qid])
        assert len(got[qid]) == len(want[qid])
        np.testing.assert_allclose([s for _, s in got[qid]],
                                   [s for _, s in want[qid]], atol=TOL)
        for name in g.keys() & r.keys():
            assert abs(g[name] - r[name]) <= TOL
        if g.keys() != r.keys():
            floor = min(r.values())
            for name in g.keys() ^ r.keys():
                assert abs(g.get(name, r.get(name)) - floor) <= TOL


def test_snapshot_is_bf16_params_only_and_loads_as_the_reference(trained):
    w, recipe, _ = trained
    path = ckpt.latest_checkpoint(f"{w}/run/checkpoints")
    meta = ckpt.load_meta(path)
    assert meta["params_only"] and meta["snapshot_dtype"] == "bfloat16"
    raw = ckpt.load_params(path)
    assert {v.dtype for v in raw.values()} == {torch.bfloat16}
    resolved = _resolved(w, recipe)
    params, vocab, reg = pipeline.load_scorer(f"{w}/run", f"{w}/data",
                                              resolved)
    ref_params, ref_vocab, ref_reg = ref_pipeline.load_scorer(
        f"{w}/run", f"{w}/data", resolved)
    assert len(vocab) == len(ref_vocab) and reg.names == ref_reg.names
    for key, arr in ref_params.items():
        assert params[key].dtype == torch.float32
        np.testing.assert_array_equal(params[key].numpy(), np.asarray(arr))
        np.testing.assert_array_equal(raw[key].float().numpy(),
                                      np.asarray(arr))


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
def test_score_topics_matches_reference(trained, similarity):
    w, recipe, col = trained
    resolved = _resolved(w, recipe)
    sc = dataclasses.replace(resolved.score, similarity=similarity)
    params, vocab, reg = pipeline.load_scorer(f"{w}/run", f"{w}/data",
                                              resolved)
    ref_params, _, _ = ref_pipeline.load_scorer(f"{w}/run", f"{w}/data",
                                                resolved)
    encoded = encode_queries(col.topics, vocab, resolved.data)
    got = score_topics(params, resolved.model, encoded, reg.names, sc)
    want = ref_score_topics(ref_params, resolved.model, encoded, reg.names,
                            sc)
    assert {len(v) for v in got.values() if v} == {K}
    _assert_same_run(got, want)
    m_got = evaluate_run(got, col.qrels)["all"]
    m_want = evaluate_run(want, col.qrels)["all"]
    assert m_got.keys() == m_want.keys()
    for name in m_want:
        assert abs(m_got[name] - m_want[name]) <= 1e-6, name


def test_searcher_answers_like_score_topics(trained):
    w, recipe, col = trained
    s = EntitySearcher(recipe, f"{w}/data", f"{w}/run", k=K, device="cpu")
    assert s.engine == "pallas" and s.prep is not None
    assert s.prep.M_binned.dtype == torch.float32      # "auto" at this E
    qids = sorted(col.topics)
    texts = [col.topics[q] for q in qids]
    many = s.search_many(texts)
    encoded = encode_queries(col.topics, s.vocab, s.recipe.data)
    want = score_topics(s.params, s.recipe.model, encoded, s.names,
                        dataclasses.replace(s.score_cfg, top_k=K))
    _assert_same_run(dict(zip(qids, many)), want)
    _assert_same_run({0: s.search(texts[0])}, {0: many[0]})
    _assert_same_run({0: s.search(texts[0], k=3)}, {0: many[0][:3]})
    assert s.stats["dispatches"] == 3
    assert s.stats["batched_queries"] == len(texts) + 2


def test_searcher_oov_clamp_and_concurrency(trained):
    w, recipe, col = trained
    s = EntitySearcher(recipe, f"{w}/data", f"{w}/run", k=5, device="cpu")
    assert s.search("qqqzzz xxyyzz") is None
    texts = [col.topics[q] for q in sorted(col.topics)]
    out = s.search_many(["qqqzzz", texts[1]], k=10 ** 6)
    assert out[0] is None and len(out[1]) == s.k_max == 100
    assert len(s.search(texts[1], k=0)) == 5
    alone = [s.search(t) for t in texts]
    got = [None] * len(texts)

    def ask(i):
        got[i] = s.search(texts[i])

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(texts))]
    before = dict(s.stats)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    # A coalesced dispatch puts a query in another row of the batch.
    _assert_same_run(dict(enumerate(got)), dict(enumerate(alone)))
    assert (s.stats["batched_queries"] - before["batched_queries"]
            == len(texts))
    assert s.stats["dispatches"] - before["dispatches"] <= len(texts)


def test_serve_stdin_prints_ranked_lines(trained):
    w, recipe, col = trained
    s = EntitySearcher(recipe, f"{w}/data", f"{w}/run", k=3, device="cpu")
    text = col.topics[sorted(col.topics)[0]]
    out = io.StringIO()
    serve_stdin(s, io.StringIO(f"a\t{text}\nqqqzzz\n\nignored\n"), out)
    lines = out.getvalue().splitlines()
    assert [ln.split("\t")[:2] for ln in lines[:3]] == [
        ["a", "1"], ["a", "2"], ["a", "3"]]
    assert [ln.split("\t")[2] for ln in lines[:3]] == [
        n for n, _ in s.search(text)]
    assert lines[3].startswith("q1\t-\t-\t-")
    assert len(lines) == 4


def test_cli_query_and_evaluate(trained, tmp_path, capsys):
    """``python -m sert_tpu_torch query`` writes the searcher's run;
    ``evaluate`` scores it as the reference's metrics do."""
    w, recipe, col = trained
    out = str(tmp_path / "run.trec")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "sert_tpu_torch", "query", "--recipe",
         "tiny", "--data", f"{w}/data", "--run-dir", f"{w}/run",
         "--topics", f"{w}/topics.tsv", "--out", out, "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env)
    # "tiny" is no named recipe: the CLI refuses it in one clean line.
    assert proc.returncode != 0 and "unknown recipe" in proc.stderr
    recipe_path = str(tmp_path / "recipe.json")
    from sert_tpu.utils.config import save_config
    save_config(recipe, recipe_path)
    proc = subprocess.run(
        [sys.executable, "-m", "sert_tpu_torch", "query", "--recipe",
         recipe_path, "--data", f"{w}/data", "--run-dir", f"{w}/run",
         "--topics", f"{w}/topics.tsv", "--out", out, "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    run = read_run(out)
    s = EntitySearcher(recipe, f"{w}/data", f"{w}/run", k=K, device="cpu")
    qids = sorted(col.topics)
    want = dict(zip(qids, s.search_many([col.topics[q] for q in qids])))
    _assert_same_run(run, {q: v for q, v in want.items() if v})

    assert cli.main(["evaluate", "--run", out, "--qrels",
                     f"{w}/qrels.trec"]) == 0
    import json
    printed = json.loads(capsys.readouterr().out)
    want_m = evaluate_run(run, col.qrels)["all"]
    for name in want_m:
        assert abs(printed[name] - want_m[name]) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_checkpoint_loads_in_reference(trained, tmp_path, dtype):
    """A checkpoint written by the port loads in the reference with the
    same values, and both score it to the same run."""
    w, recipe, col = trained
    resolved = _resolved(w, recipe)
    params, _, reg = pipeline.load_scorer(f"{w}/run", f"{w}/data", resolved)
    rng = np.random.default_rng(5)
    params = {k: (v + torch.from_numpy(
        rng.normal(scale=0.01, size=v.shape).astype(np.float32))).to(dtype)
        for k, v in params.items()}
    vocab_hash = ckpt.load_meta(
        ckpt.latest_checkpoint(f"{w}/run/checkpoints"))["vocab_hash"]
    run_dir = str(tmp_path / "run")
    path = ckpt.save_params_checkpoint(f"{run_dir}/checkpoints", 7, params,
                                       {"vocab_hash": vocab_hash})
    assert path.endswith("ckpt-00000007.npz")
    ref_params, vocab, _ = ref_pipeline.load_scorer(run_dir, f"{w}/data",
                                                    resolved)
    for key, t in params.items():
        np.testing.assert_array_equal(np.asarray(ref_params[key]),
                                      t.float().numpy())
    encoded = encode_queries(col.topics, vocab, resolved.data)
    got = score_topics(
        pipeline.load_scorer(run_dir, f"{w}/data", resolved)[0],
        resolved.model, encoded, reg.names, resolved.score)
    want = ref_score_topics(ref_params, resolved.model, encoded, reg.names,
                            resolved.score)
    _assert_same_run(got, want)


def test_load_scorer_refuses_a_foreign_vocabulary(trained, tmp_path):
    w, recipe, _ = trained
    resolved = _resolved(w, recipe)
    params, _, _ = pipeline.load_scorer(f"{w}/run", f"{w}/data", resolved)
    run_dir = str(tmp_path / "run")
    ckpt.save_params_checkpoint(f"{run_dir}/checkpoints", 1, params,
                                {"vocab_hash": "not-this-vocabulary"})
    with pytest.raises(ValueError, match="vocabulary hash mismatch"):
        pipeline.load_scorer(run_dir, f"{w}/data", resolved)
    with pytest.raises(FileNotFoundError):
        pipeline.load_scorer(str(tmp_path / "none"), f"{w}/data", resolved)
