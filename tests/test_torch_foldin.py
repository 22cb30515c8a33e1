"""Serve-time fold-in of the port (``sert_tpu_torch/models/lse.py``'s
fold-in functions, ``EntitySearcher.add_entities`` and its helpers)
against the reference, and the reference's fold-in behaviour on the port.

Two tiny LSE runs are trained once by the reference with cosine scoring
(as ``tests/test_foldin.py`` trains them): one with the NCE objective, one
with the sampled softmax. Both packages' searchers stand up on the same
directories (the port's on the CPU). Every random draw on this path is
numpy's ``default_rng`` in both packages, so both fold in from the same
windows.

Tolerances (in parentheses, the gaps these comparisons read on the CPU
when the tolerances were set):
- the window lists: equal;
- ``fold_in_entity`` and the background reps: 1e-6 absolute (fp32
  products summed in another order, 2e-7 and 5e-7);
- ``fold_in_entity_gradient`` after 1 and 10 adam steps: 1e-5 relative +
  1e-6 absolute (7e-7); after the default 1000 steps, where adam amplifies
  the reassociation wherever the gradient nears 0: cosine >= 1 - 1e-5 and
  norms within 1e-4 relative (1 - cos below fp32's resolution, 5e-6);
- the stored vectors 1e-5, spans 1e-6 (4e-7, 6e-8); merged scores 1e-5,
  names equal up to ties within that.
"""

import dataclasses
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu import recipes  # noqa: E402
from sert_tpu.models import lse as ref_lse  # noqa: E402
from sert_tpu.serving import EntitySearcher as RefSearcher  # noqa: E402
from sert_tpu_torch import serving  # noqa: E402
from sert_tpu_torch.models import lse  # noqa: E402
from sert_tpu_torch.serving import EntitySearcher, make_http_server  # noqa: E402

ATOL = 1e-6
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
COS_MIN, NORM_RTOL = 1 - 1e-5, 1e-4
VEC_ATOL, SPAN_ATOL, SCORE_TOL = 1e-5, 1e-6, 1e-5

OBJECTIVES = {"nce": {},
              "sampled_softmax": dict(objective="sampled_softmax",
                                      num_negatives=16)}


def _train(root, model="lse", seed=7, **model_kw):
    recipe = recipes.tiny_recipe(model, **model_kw)
    recipe = dataclasses.replace(recipe, score=dataclasses.replace(
        recipe.score, similarity="cosine"))
    col = recipes.tiny_spec(seed=seed).build()
    data, run = str(root / "data"), str(root / "run")
    ref_pipeline.prepare_collection(col, data, recipe)
    ref_pipeline.train_from_dir(recipe, data, run, resume=False)
    return recipe, col, data, run


@pytest.fixture(scope="module", params=sorted(OBJECTIVES))
def trained(request, tmp_path_factory):
    """(recipe, collection, data dir, run dir) of one objective."""
    return _train(tmp_path_factory.mktemp(request.param),
                  **OBJECTIVES[request.param])


@pytest.fixture(scope="module")
def nce_run(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("nce_only"))


@pytest.fixture(scope="module")
def ss_run(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("ss_only"),
                  **OBJECTIVES["sampled_softmax"])


def _port(run, k=10):
    recipe, _, data, run_dir = run
    return EntitySearcher(recipe, data, run_dir, k=k, device="cpu")


def _both(run, k=10):
    recipe, _, data, run_dir = run
    return RefSearcher(recipe, data, run_dir, k=k), _port(run, k)


def _text(col, i):
    """Entity i's associated text: a new entity with it is i's twin."""
    target = col.entities[i]
    return " ".join(t for d, es in col.doc_entities.items()
                    for t in col.docs[d].split() if target in es)


def _topic_of(col, entity):
    return [t for t in sorted(col.topics) if entity in col.qrels[t]][0]


def _assert_same_hits(got, want):
    """Scores within SCORE_TOL rank by rank and name by name; a name in one
    list only must tie (within SCORE_TOL) with the other list's last."""
    assert (got is None) == (want is None)
    if want is None:
        return
    assert len(got) == len(want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=SCORE_TOL)
    g, w = dict(got), dict(want)
    for name in g.keys() & w.keys():
        assert abs(g[name] - w[name]) <= SCORE_TOL, name
    floor = min(w.values())
    for name in g.keys() ^ w.keys():
        assert abs(g.get(name, w.get(name)) - floor) <= SCORE_TOL, name


# --- the fold-in functions against the reference ---------------------------

@pytest.mark.parametrize("n,window", [(1, 6), (3, 6), (6, 6), (7, 6),
                                      (40, 6), (40, 16)])
def test_entity_windows_equal_reference(n, window):
    ids = list(np.random.default_rng(n).integers(1, 500, size=n))
    got = lse._entity_windows(ids, window)
    want = ref_lse._entity_windows(ids, window)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_entity_windows_refuse_an_empty_text():
    with pytest.raises(ValueError, match="at least one") as got:
        lse._entity_windows([], 6)
    with pytest.raises(ValueError) as want:
        ref_lse._entity_windows([], 6)
    assert str(got.value) == str(want.value)


def test_fold_in_entity_matches_reference(trained):
    """A text of a few windows, and one past a chunk of 8192 windows."""
    ref, port = _both(trained)
    ids = ref.encode(_text(trained[1], 3))
    long_ids = list(np.resize(ids, lse.FOLD_IN_CHUNK + 100))
    w = port.recipe.data.window_size
    for toks in (ids, ids[:3], long_ids):
        got = lse.fold_in_entity(port.params, toks, port.recipe.model,
                                 window_size=w)
        want = np.asarray(ref_lse.fold_in_entity(
            ref.params, toks, ref.recipe.model, window_size=w))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("steps,max_windows", [(1, 4096), (10, 4096),
                                               (10, 64), (1000, 4096)])
def test_fold_in_gradient_matches_reference(trained, steps, max_windows):
    """The same windows and negatives in both; past ``max_windows`` both
    subsample with numpy's default_rng(0)."""
    ref, port = _both(trained)
    ids = ref.encode(_text(trained[1], 6))
    assert len(ids) > 64
    neg = np.array(ref._raw_negative_reps(ids))
    w = port.recipe.data.window_size
    got = lse.fold_in_entity_gradient(
        port.params, ids, port.recipe.model, torch.from_numpy(neg),
        window_size=w, steps=steps, max_windows=max_windows).numpy()
    want = np.asarray(ref_lse.fold_in_entity_gradient(
        ref.params, ids, ref.recipe.model, neg, window_size=w, steps=steps,
        max_windows=max_windows))
    if steps < 1000:
        np.testing.assert_allclose(got, want, rtol=STEP_RTOL, atol=STEP_ATOL)
    else:
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= COS_MIN
        assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) \
            <= NORM_RTOL


def test_fold_in_opt_takes_optax_adam_steps():
    """_fold_in_opt alone on random reps against the reference's jitted
    scan: one step moves v by lr in each coordinate's sign (adam's first
    step), ten steps agree at reassociation level."""
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(8, 16)).astype(np.float32)
    pw = np.full(8, 1 / 5, np.float32)
    pw[5:] = 0
    neg = rng.normal(size=(40, 16)).astype(np.float32)
    v0 = rng.normal(size=16).astype(np.float32)
    for steps in (1, 10):
        got = lse._fold_in_opt(torch.from_numpy(pos), torch.from_numpy(pw),
                               torch.from_numpy(neg), torch.from_numpy(v0),
                               8.0, 0.05, steps).numpy()
        want = np.asarray(ref_lse._fold_in_opt(pos, pw, neg, v0,
                                               np.float32(8.0),
                                               np.float32(0.05), steps))
        np.testing.assert_allclose(got, want, rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
        if steps == 1:
            np.testing.assert_allclose(np.abs(got - v0), 0.05, rtol=1e-4)


@pytest.mark.parametrize("raw", [False, True])
def test_background_reps_match_reference(trained, raw):
    ref, port = _both(trained)
    got, want = port._background_reps(raw=raw), np.asarray(
        ref._background_reps(raw=raw))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if raw:     # the same real windows, drawn by the same default_rng(0)
        for a, b in zip(port._bg_raw_pool, ref._bg_raw_pool):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-6)


def test_raw_negative_keep_mask_matches_reference(trained):
    ref, port = _both(trained)
    col = trained[1]
    for ids in (ref.encode(_text(col, 6)), ref.encode(_text(col, 2)),
                ref.encode(col.topics[sorted(col.topics)[0]])):
        got, want = port._raw_negative_reps(ids), np.asarray(
            ref._raw_negative_reps(ids))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_trained_stats_and_moment_match_equal_reference(trained):
    ref, port = _both(trained)
    np.testing.assert_allclose(port._trained_stats(), ref._trained_stats(),
                               atol=ATOL, rtol=0)
    v = np.random.default_rng(1).normal(
        size=port.recipe.model.entity_dim).astype(np.float32)
    np.testing.assert_allclose(port._match_trained_moments(v),
                               ref._match_trained_moments(v),
                               atol=VEC_ATOL, rtol=0)


@pytest.mark.parametrize("method", ["affine", "gradient"])
def test_add_entities_matches_reference(trained, method):
    """The stored vectors, spans and raw flags after two calls (the second
    appends), then every topic through search_many and one through
    search, merged with the extras."""
    ref, port = _both(trained)
    col = trained[1]
    for batch in ([("new-3", _text(col, 3)), ("new-6", _text(col, 6))],
                  [("new-10", _text(col, 10))]):
        assert port.add_entities(batch, method=method) == \
            ref.add_entities(batch, method=method)
    assert port._extra_names == ref._extra_names
    assert port.num_extra_entities == ref.num_extra_entities == 3
    np.testing.assert_allclose(port._extra_vecs, ref._extra_vecs,
                               atol=VEC_ATOL, rtol=0)
    np.testing.assert_allclose(port._extra_spans, ref._extra_spans,
                               atol=SPAN_ATOL, rtol=0)
    np.testing.assert_array_equal(port._extra_raw, ref._extra_raw)
    assert port._extra_raw.all() == (method == "gradient")

    texts = [col.topics[t] for t in sorted(col.topics)] + ["zzzunknownzzz"]
    got, want = port.search_many(texts), ref.search_many(texts)
    assert got[-1] is None and want[-1] is None
    for g, w in zip(got, want):
        _assert_same_hits(g, w)
    merged = {n for hits in got[:-1] for n, _ in hits}
    assert {"new-3", "new-6", "new-10"} <= merged
    _assert_same_hits(port.search(texts[0], k=port.k_max),
                      ref.search(texts[0], k=ref.k_max))


def _refusals(col):
    return [
        ([(col.entities[0], "some text")], "affine"),       # trained name
        ([("dup", _text(col, 1)), ("dup", _text(col, 2))], "affine"),
        ([("brand-new", "zzz-never-seen-term")], "affine"),
        ([("brand-new", "zzz-never-seen-term")], "gradient"),
        ([("brand-new", _text(col, 1))], "magic"),
        ([(1, _text(col, 1))], "affine"),
        ([("brand-new", None)], "gradient"),
    ]


def test_refusals_match_reference(nce_run):
    ref, port = _both(nce_run)
    for items, method in _refusals(nce_run[1]):
        with pytest.raises(Exception) as want:
            ref.add_entities(items, method=method)
        with pytest.raises(Exception) as got:
            port.add_entities(items, method=method)
        assert type(got.value) is type(want.value) is ValueError
        assert str(got.value) == str(want.value)
    assert port.num_extra_entities == ref.num_extra_entities == 0


def test_loglinear_refusal_matches_reference(tmp_path):
    recipe, _, data, run = _train(tmp_path, model="loglinear", seed=8)
    ref = RefSearcher(recipe, data, run)
    port = EntitySearcher(recipe, data, run, device="cpu")
    with pytest.raises(ValueError, match="LSE") as got:
        port.add_entities([("x", "whatever text")])
    with pytest.raises(ValueError) as want:
        ref.add_entities([("x", "whatever text")])
    assert str(got.value) == str(want.value)


# --- the reference's fold-in behaviour, on the port alone ------------------

def test_fold_in_vector_is_mean_window_rep(nce_run):
    s = _port(nce_run)
    ids = s.vocab.encode(nce_run[1].docs[sorted(nce_run[1].docs)[0]]
                         .split()[:20])
    v = lse.fold_in_entity(s.params, ids, s.recipe.model, window_size=6)
    wins = np.lib.stride_tricks.sliding_window_view(
        np.asarray(ids, np.int32), 6)
    reps = lse.window_rep(s.params, torch.from_numpy(wins.copy()),
                          torch.full((wins.shape[0],), 6, dtype=torch.int32),
                          s.recipe.model)
    np.testing.assert_allclose(v.numpy(), reps.mean(0).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_folded_entity_is_retrieved(nce_run):
    s = _port(nce_run, k=5)
    col = nce_run[1]
    target = col.entities[3]
    assert s.add_entities([("folded-new", _text(col, 3))]) == 1
    assert s.num_extra_entities == 1
    hits = s.search(col.topics[_topic_of(col, target)], k=10)
    names = [n for n, _ in hits]
    assert "folded-new" in names
    assert names.index("folded-new") <= names.index(target) + 2
    scores = dict(hits)
    assert scores["folded-new"] <= scores[names[0]] + 1e-6
    assert abs(scores["folded-new"] - scores[target]) < 0.5


@pytest.mark.parametrize("method,i,j", [("affine", 5, 9),
                                        ("gradient", 10, 2)])
def test_folded_entity_does_not_dominate_unrelated_topics(nce_run, method,
                                                          i, j):
    s = _port(nce_run)
    col = nce_run[1]
    s.add_entities([("folded", _text(col, i))], method=method)
    other = col.entities[j]
    names = [n for n, _ in s.search(col.topics[_topic_of(col, other)],
                                    k=10)]
    assert other in names
    assert "folded" not in names or names.index("folded") > \
        names.index(other)


def test_search_many_merges_folded(nce_run):
    s = _port(nce_run)
    col = nce_run[1]
    s.add_entities([("folded-m", _text(col, 4))])
    out = s.search_many([col.topics[_topic_of(col, col.entities[4])],
                         "zzz-not-in-vocab"])
    assert out[1] is None
    assert "folded-m" in [n for n, _ in out[0]]


def test_error_contract(nce_run):
    s = _port(nce_run)
    col = nce_run[1]
    with pytest.raises(ValueError, match="already indexed"):
        s.add_entities([(col.entities[0], "some text")])
    with pytest.raises(ValueError, match="no in-vocab"):
        s.add_entities([("brand-new", "zzz-never-seen-term")])
    with pytest.raises(ValueError, match="method"):
        s.add_entities([("brand-new", "some text")], method="magic")
    s.add_entities([("brand-new", _text(col, 1))])
    with pytest.raises(ValueError, match="already indexed"):
        s.add_entities([("brand-new", _text(col, 2))], method="gradient")


def test_gradient_twin_ranks_with_original_across_topics(nce_run):
    """A twin folded by the NCE refit scores like the original across the
    topic set, raw, with no calibration."""
    s = _port(nce_run)
    col = nce_run[1]
    target = col.entities[6]
    assert s.add_entities([("grad-twin", _text(col, 6))],
                          method="gradient") == 1
    assert bool(s._extra_raw[0])
    orig_sc, twin_sc, rank_gap, top_gaps = [], [], [], []
    for tid in sorted(col.topics):
        hits = s.search(col.topics[tid], k=s.k_max)
        names = [n for n, _ in hits]
        scores = dict(hits)
        if target not in names:
            continue
        assert "grad-twin" in names, tid
        orig_sc.append(scores[target])
        twin_sc.append(scores["grad-twin"])
        gap = abs(names.index("grad-twin") - names.index(target))
        rank_gap.append(gap)
        rt = names.index(target)
        vals = [v for _, v in hits]
        if rt < 5 and scores[target] > vals[min(5, len(vals) - 1)] + 0.1:
            top_gaps.append(gap)
    assert len(rank_gap) >= len(col.topics) // 2
    orig_sc, twin_sc = np.asarray(orig_sc), np.asarray(twin_sc)
    assert np.abs(orig_sc - twin_sc).max() < 0.2
    assert np.abs(orig_sc - twin_sc).mean() < 0.1
    assert np.corrcoef(orig_sc, twin_sc)[0, 1] > 0.95
    assert top_gaps and max(top_gaps) <= 4
    assert sum(rank_gap) / len(rank_gap) <= 5.0


def test_gradient_twin_softmax_family(ss_run):
    """For a sampled-softmax index the gradient method folds the f-image
    at the trained rows' median norm, scored raw."""
    s = _port(ss_run)
    col = ss_run[1]
    target = col.entities[6]
    assert s.add_entities([("ss-twin", _text(col, 6))],
                          method="gradient") == 1
    assert bool(s._extra_raw[0])
    nm, _ = s._trained_stats()
    assert float(np.linalg.norm(s._extra_vecs[0])) == pytest.approx(
        nm, rel=1e-5)
    orig_sc, twin_sc = [], []
    for tid in sorted(col.topics):
        sc = dict(s.search(col.topics[tid], k=s.k_max))
        if target in sc and "ss-twin" in sc:
            orig_sc.append(sc[target])
            twin_sc.append(sc["ss-twin"])
    assert len(orig_sc) >= len(col.topics) // 2
    orig_sc, twin_sc = np.asarray(orig_sc), np.asarray(twin_sc)
    assert np.abs(orig_sc - twin_sc).max() < 0.2
    assert np.corrcoef(orig_sc, twin_sc)[0, 1] > 0.9


def test_gradient_vector_beats_f_image_on_nce_objective(nce_run):
    s = _port(nce_run)
    col = nce_run[1]
    ids = s.encode(_text(col, 1))
    neg = s._background_reps(raw=True)
    w, cfg = s.recipe.data.window_size, s.recipe.model
    v_f = lse.fold_in_entity(s.params, ids, cfg, window_size=w).numpy()
    v_g = lse.fold_in_entity_gradient(s.params, ids, cfg,
                                      torch.from_numpy(neg),
                                      window_size=w).numpy()
    wins, lens = lse._entity_windows(ids, w)
    pos = lse.host_window_rep(s.params, wins, lens, cfg).numpy()

    def nce(v):
        def log_sig(x):
            return -np.logaddexp(0.0, -x)
        k = cfg.num_negatives
        return -(np.mean(log_sig(pos @ v)) + k * np.mean(log_sig(-(neg @ v))))

    assert nce(v_g) < nce(v_f) - 1e-3


def test_raw_pool_samples_real_training_windows(nce_run, monkeypatch):
    """The gradient fold-in's negative pool comes from the instance shards
    when they are there (not from the lm_stats fallback)."""
    consulted = []
    real_cls = serving.InstanceDataset

    class Spy(real_cls):
        @property
        def shard_paths(self):
            p = real_cls.shard_paths.fget(self)
            consulted.append(p[0])
            return p

    monkeypatch.setattr(serving, "InstanceDataset", Spy)
    reps = _port(nce_run)._background_reps(raw=True)
    assert consulted, "real-window negative pool was not consulted"
    with np.load(consulted[0]) as z:
        n_shard = z["windows"].shape[0]
    assert reps.shape[0] == min(2048, n_shard)


def test_raw_pool_falls_back_as_the_reference(nce_run, monkeypatch):
    """Without shards both packages draw the pool as 2048 windows of terms
    from the collection distribution (lm_stats), with the same
    default_rng(0) draws, and filter it the same way."""
    from sert_tpu import serving as ref_serving
    from sert_tpu.data import instances as ref_instances

    def no_shards(cls):
        return type("NoShards", (cls,), {"shard_paths": property(
            lambda self: [])})

    monkeypatch.setattr(serving, "InstanceDataset",
                        no_shards(serving.InstanceDataset))
    monkeypatch.setattr(ref_instances, "InstanceDataset",
                        no_shards(ref_instances.InstanceDataset))
    assert ref_serving  # the reference imports InstanceDataset per call
    ref, port = _both(nce_run)
    got, want = port._background_reps(raw=True), np.asarray(
        ref._background_reps(raw=True))
    assert got.shape == (2048, port.recipe.model.entity_dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for a, b in zip(port._bg_raw_pool, ref._bg_raw_pool):
        np.testing.assert_array_equal(a, b)
    ids = port.encode(_text(nce_run[1], 6))
    np.testing.assert_allclose(port._raw_negative_reps(ids),
                               np.asarray(ref._raw_negative_reps(ids)),
                               atol=ATOL, rtol=0)


def test_raw_pool_excludes_entity_own_windows(nce_run):
    s = _port(nce_run)
    col = nce_run[1]
    ids = s.encode(_text(col, 6))
    full = s._background_reps(raw=True)
    filtered = s._raw_negative_reps(ids)
    wins, lens = s._bg_raw_pool
    member = np.isin(wins, np.asarray(ids, np.int32))
    valid = np.arange(wins.shape[1])[None, :] < lens[:, None]
    frac = (member & valid).sum(1) / np.maximum(lens, 1)
    n_contam = int((frac > 0.5).sum())
    assert n_contam > 0
    assert filtered.shape[0] == full.shape[0] - n_contam
    other = s.encode("zzzunknownzzz " + col.topics[sorted(col.topics)[0]])
    assert s._raw_negative_reps(other).shape[0] >= filtered.shape[0]


def test_fold_in_and_searches_interleave_consistently(nce_run):
    """Folds and searches from many threads at once (a short switch
    interval): every answer pairs each extra's name with its own score
    (each folded twin ranks at or near its own topic's top), and the
    extras end complete and in call order within each thread."""
    s = _port(nce_run)
    col = nce_run[1]
    texts = [col.topics[t] for t in sorted(col.topics)]
    errors, answers = [], []

    def fold(base):
        try:
            for j in range(3):
                s.add_entities([(f"t{base}-{j}", _text(col, base + j))])
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    def ask(i):
        try:
            for _ in range(3):
                answers.append(s.search_many(texts[i::4]))
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    threads = ([threading.Thread(target=fold, args=(b,)) for b in (0, 8)]
               + [threading.Thread(target=ask, args=(i,)) for i in range(4)])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(s._extra_names) == sorted(
        f"t{b}-{j}" for b in (0, 8) for j in range(3))
    for b in (0, 8):
        mine = [n for n in s._extra_names if n.startswith(f"t{b}-")]
        assert mine == [f"t{b}-{j}" for j in range(3)]
    n = s.num_extra_entities
    assert s._extra_vecs.shape[0] == s._extra_spans.shape[0] == n
    # after the race, the answers equal a quiet searcher's with the same
    # extras
    quiet = _port(nce_run)
    for b in (0, 8):
        for j in range(3):
            quiet.add_entities([(f"t{b}-{j}", _text(col, b + j))])
    quiet_names = quiet._extra_names
    order = [quiet_names.index(x) for x in s._extra_names]
    np.testing.assert_allclose(s._extra_vecs, quiet._extra_vecs[order],
                               atol=1e-6)
    for got, want in zip(s.search_many(texts), quiet.search_many(texts)):
        _assert_same_hits(got, want)
    assert answers


def test_http_entities_endpoint(nce_run):
    s = _port(nce_run, k=5)
    col = nce_run[1]
    server = make_http_server(s, port=0)
    host, port = server.server_address[:2]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{host}:{port}"

    def post(payload):
        req = urllib.request.Request(
            base + "/entities", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    try:
        doc = col.docs[sorted(col.docs)[0]]
        res = post({"entities": [{"name": "http-folded", "text": doc}]})
        assert res == {"added": 1, "extra_entities": 1}
        res = post({"entities": [{"name": "http-grad", "text": doc}],
                    "method": "gradient"})
        assert res == {"added": 1, "extra_entities": 2}
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["extra_entities"] == 2
        for payload in ({"entities": []},
                        {"entities": [{"name": "n2", "text": 123}]},
                        {"entities": [{"name": ["x"], "text": doc}]},
                        {"entities": [{"name": "n3", "text": doc}],
                         "method": 5},
                        {"entities": [{"name": "http-folded",
                                       "text": doc}]}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(payload)
            assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
