"""The port's lm ranker (``sert_tpu_torch/models/lm.py``) against the
reference's (``sert_tpu/models/lm.py``) on the same prepared statistics.

Both are the same numpy operations over the same ``lm_stats.npz``, so
scores, top-k ids and run files are held equal (``assert_array_equal``,
byte-equal run files), not within a tolerance.
"""

import os

import numpy as np
import pytest

from sert_tpu import cli as ref_cli
from sert_tpu import pipeline as ref_pipeline
from sert_tpu import recipes
from sert_tpu.data.lm_stats import LMStatsBuilder as RefBuilder
from sert_tpu.data.prepare import encode_queries
from sert_tpu.eval.trec import write_topics
from sert_tpu.models import lm as ref_lm
from sert_tpu.utils.config import save_config
from sert_tpu_torch import cli
from sert_tpu_torch.data.lm_stats import LMStats, LMStatsBuilder
from sert_tpu_torch.models import lm


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """(data dir, recipe JSON, topics file, collection) of the tiny
    collection as the reference prepares it (lm_stats included)."""
    root = tmp_path_factory.mktemp("lm")
    recipe = recipes.tiny_recipe("lse")
    col = recipes.tiny_spec(seed=5).build()
    data = str(root / "data")
    ref_pipeline.prepare_collection(col, data, recipe)
    recipe_path = str(root / "recipe.json")
    save_config(recipe, recipe_path)
    topics = str(root / "topics.tsv")
    # One topic with no in-vocabulary term: both rankers return it empty.
    write_topics({**col.topics, "oov": "zzzunknownzzz"}, topics)
    return data, recipe_path, topics, col


def _pair(data, **kw):
    ref, vocab, reg = ref_lm.load_lm(data, **kw)
    port, pvocab, preg = lm.load_lm(data, **kw)
    assert len(pvocab) == len(vocab) and preg.names == reg.names
    return ref, port, vocab, reg


SMOOTHINGS = [dict(smoothing="dirichlet", mu=2000.0),
              dict(smoothing="dirichlet", mu=50.0),
              dict(smoothing="jm", lam=0.3)]


def _queries(col, vocab):
    from sert_tpu.utils.config import DataConfig
    enc = encode_queries(col.topics, vocab, DataConfig())
    qs = [enc[t] for t in sorted(enc)]
    return qs + [[], [0, 0, 1], qs[0] * 3]


@pytest.mark.parametrize("kw", SMOOTHINGS)
def test_score_equals_reference(prepared, kw):
    data, _, _, col = prepared
    ref, port, vocab, _ = _pair(data, **kw)
    qs = _queries(col, vocab)
    for chunk in (7, 1 << 16):
        np.testing.assert_array_equal(port.score(qs, chunk=chunk),
                                      ref.score(qs, chunk=chunk))


@pytest.mark.parametrize("kw", SMOOTHINGS)
def test_topk_across_chunks_equals_reference(prepared, kw):
    data, _, _, col = prepared
    ref, port, vocab, _ = _pair(data, **kw)
    qs = _queries(col, vocab)
    for k, chunk in ((5, 3), (10, 7), (32, 1 << 16), (1000, 5)):
        got_s, got_i = port.topk(qs, k, chunk=chunk)
        want_s, want_i = ref.topk(qs, k, chunk=chunk)
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_i, want_i)
    # the chunked top k is the top k of the full scores
    full = port.score(qs)
    s, i = port.topk(qs, 6, chunk=5)
    np.testing.assert_array_equal(s, np.take_along_axis(full, i, axis=1))


@pytest.mark.parametrize("kw", SMOOTHINGS)
def test_rank_topics_equals_reference(prepared, kw):
    data, _, _, col = prepared
    ref, port, vocab, reg = _pair(data, **kw)
    from sert_tpu.utils.config import DataConfig
    enc = encode_queries({**col.topics, "oov": "zzzunknownzzz"}, vocab,
                         DataConfig())
    got = port.rank_topics(enc, reg.names, k=20, chunk=9)
    assert got == ref.rank_topics(enc, reg.names, k=20, chunk=9)
    assert got["oov"] == [] and all(got[t] for t in col.topics)


@pytest.mark.parametrize("kw", [dict(smoothing="bm25"),
                                dict(smoothing="dirichlet", mu=0.0),
                                dict(smoothing="jm", lam=0.0),
                                dict(smoothing="jm", lam=1.0)])
def test_smoothing_errors_match_reference(prepared, kw):
    data = prepared[0]
    stats = LMStats.load(os.path.join(data, "lm_stats.npz"))
    with pytest.raises(ValueError) as want:
        ref_lm.EntityLM(stats, **kw)
    with pytest.raises(ValueError) as got:
        lm.EntityLM(stats, **kw)
    assert str(got.value) == str(want.value)


def test_missing_stats_is_refused_like_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        ref_lm.load_lm(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        lm.load_lm(str(tmp_path))
    assert str(got.value) == str(want.value)


def test_hand_built_stats_score_as_the_reference():
    """Stats from the port's own builder score as the reference's builder's
    stats do (entity 2 has no text: jm falls back to the background)."""
    docs = [([0], [0, 0, 1]), ([1], [1, 2]), ([0, 1], [3])]
    stats, ref_stats = LMStatsBuilder(5), RefBuilder(5)
    for ents, toks in docs:
        stats.add(ents, toks)
        ref_stats.add(ents, toks)
    stats, ref_stats = stats.finalize(3), ref_stats.finalize(3)
    qs = [[0], [1, 1], [2, 3], [4], []]
    for kw in SMOOTHINGS:
        np.testing.assert_array_equal(
            lm.EntityLM(stats, **kw).score(qs),
            ref_lm.EntityLM(ref_stats, **kw).score(qs))


@pytest.mark.parametrize("extra", [[], ["--smoothing", "jm", "--lam", "0.3"],
                                   ["--mu", "100"]])
def test_cli_lm_run_equals_reference(prepared, tmp_path, extra, capsys):
    """``query --ranker lm`` from both CLIs writes the same run file; the
    port needs no run dir and no device."""
    data, recipe_path, topics, _ = prepared
    out = {n: str(tmp_path / f"{n}.trec") for n in ("ref", "port")}
    args = ["query", "--recipe", recipe_path, "--data", data, "--topics",
            topics, "--ranker", "lm", *extra]
    assert ref_cli.main([*args, "--out", out["ref"]]) == 0
    assert cli.main([*args, "--out", out["port"]]) == 0
    assert "(lm ranker)" in capsys.readouterr().out
    with open(out["port"], "rb") as a, open(out["ref"], "rb") as b:
        port_bytes = a.read()
        assert port_bytes == b.read()
    assert port_bytes


def test_cli_lm_without_stats_exits_cleanly(prepared, tmp_path):
    _, recipe_path, topics, _ = prepared
    empty = tmp_path / "data"
    empty.mkdir()
    import shutil
    data = prepared[0]
    for name in os.listdir(data):
        if name != "lm_stats.npz":
            src = os.path.join(data, name)
            if os.path.isfile(src):
                shutil.copy(src, empty / name)
    with pytest.raises(SystemExit, match="lm_stats.npz not found"):
        cli.main(["query", "--recipe", recipe_path, "--data", str(empty),
                  "--topics", topics, "--ranker", "lm", "--out",
                  str(tmp_path / "run.trec")])
