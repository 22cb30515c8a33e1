"""The port's scoring engines and staging options against the JAX reference.

On the CPU the port's K3/K4 wrappers run their plain versions and the
reference's Pallas kernels run under the Pallas interpreter, on the same
numpy inputs: the streaming and approx engines, ``score_topics`` with each
single-device engine, the clustered layout (with the reference's random
draws injected), the two-phase ``adaptive_bins`` rescore, the fp32
prefilter, ``bin_width=64``, the unfused rescore and the "auto" engine
rule.

Tolerances: scores are fp32 products of the same inputs summed in another
order (1e-5); K3's fp32 mode multiplies fp32 inputs on both sides (1e-6
relative to the largest score); ids are equal (continuous random scores
have no ties).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.scoring import run as ref_run  # noqa: E402
from sert_tpu.scoring import scorer as ref_scorer  # noqa: E402
from sert_tpu.utils.config import ModelConfig, ScoreConfig  # noqa: E402
from sert_tpu_torch.models.convert import params_from_jax  # noqa: E402
from sert_tpu_torch.ops import exact_topk, score_binmax  # noqa: E402
from sert_tpu_torch.scoring import run, scorer  # noqa: E402

ref_topk = importlib.import_module("sert_tpu.ops.exact_topk")
ref_k3 = importlib.import_module("sert_tpu.ops.score_binmax")

V, D, DE = 60, 16, 12
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfg(model, E):
    return ModelConfig(model=model, vocab_size=V, num_entities=E,
                       word_dim=D, entity_dim=DE)


def _np_params(model, E, seed=0):
    rng = np.random.default_rng(seed)
    if model == "loglinear":
        return {"word_emb": rng.normal(size=(V, D)).astype(np.float32) / 2,
                "proj_w": rng.normal(size=(D, E)).astype(np.float32) / 2,
                "proj_b": rng.normal(size=(E,)).astype(np.float32) / 4}
    return {"word_emb": rng.normal(size=(V, D)).astype(np.float32) / 2,
            "proj_w": rng.normal(size=(D, DE)).astype(np.float32) / 2,
            "proj_b": rng.normal(size=(DE,)).astype(np.float32) / 4,
            "entity_emb": rng.normal(size=(E, DE)).astype(np.float32)}


def _queries(seed=1, Q=6, T=16):
    rng = np.random.default_rng(seed)
    num_terms = rng.integers(1, 5, size=Q).astype(np.int32)
    term_ids = np.zeros((Q, T), np.int32)
    for i, n in enumerate(num_terms):
        term_ids[i, :n] = rng.integers(1, V, size=n)
    return term_ids, num_terms


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _mat(seed, Q=8, E=2048, d=32):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(Q, d)).astype(np.float32)
    M = rng.normal(size=(E, d)).astype(np.float32)
    bias = rng.normal(size=E).astype(np.float32)
    alpha = np.full(Q, 1.5, np.float32)
    return R, M, bias, alpha


@pytest.fixture
def k4_calls(monkeypatch):
    """Counts exact_topk's fused rescores (K4's plain version on the CPU)."""
    calls = []
    real = exact_topk.gather_rescore

    def counted(*args):
        calls.append(args[2].shape[1])
        return real(*args)

    monkeypatch.setattr(exact_topk, "gather_rescore", counted)
    return calls


# --- the streaming engine ---------------------------------------------------

@pytest.mark.parametrize("E,chunk,k", [(1000, 128, 20),     # ragged chunks
                                       (50, 16, 80)])       # k > E clamped
@pytest.mark.parametrize("model,similarity", [("lse", "dot"),
                                              ("lse", "cosine"),
                                              ("loglinear", "dot")])
def test_streaming_topk_matches_reference(model, similarity, E, chunk, k):
    cfg = _cfg(model, E)
    p = _np_params(model, E)
    term_ids, num_terms = _queries()
    want_s, want_i = ref_scorer.streaming_topk(
        _jp(p), cfg, jnp.asarray(term_ids), jnp.asarray(num_terms), k=k,
        chunk=chunk, similarity=similarity)
    got_s, got_i = scorer.streaming_topk(
        params_from_jax(p), cfg, _t(term_ids), _t(num_terms), k=k,
        chunk=chunk, similarity=similarity)
    assert got_s.shape == (6, min(k, E))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    dense = scorer.dense_scores(params_from_jax(p), cfg, _t(term_ids),
                                _t(num_terms), similarity=similarity)
    np.testing.assert_allclose(got_s.numpy(),
                               torch.gather(dense, 1, got_i).numpy(), **TOL)


@pytest.mark.parametrize("is_ll", [False, True])
def test_chunked_topk_core_pads_a_short_block_as_the_reference(is_ll):
    """Fewer rows than k: the tail is NEG_INF with the reference's ids,
    and the un-normalized (max, sumexp) carry matches."""
    rng = np.random.default_rng(5)
    Q, T, d, rows, k = 4, 3, 8, 20, 32
    R = rng.normal(size=(Q, d)).astype(np.float32)
    te = rng.normal(size=(Q, T, d)).astype(np.float32)
    mask = np.arange(T)[None, :] < rng.integers(1, T + 1, size=Q)[:, None]
    M = rng.normal(size=(rows, d)).astype(np.float32)
    b = rng.normal(size=rows).astype(np.float32)
    want = ref_scorer.chunked_topk_core(
        jnp.asarray(R), jnp.asarray(te), jnp.asarray(mask), jnp.asarray(M),
        jnp.asarray(b), k, 8, is_ll)
    got = scorer.chunked_topk_core(_t(R), _t(te), _t(mask), _t(M), _t(b), k,
                                   8, is_ll)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("model", ["lse", "loglinear"])
@pytest.mark.parametrize("engine", ["approx", "streaming", "dense"])
def test_score_topics_matches_reference(engine, model):
    E = 300
    cfg = _cfg(model, E)
    p = _np_params(model, E, seed=2)
    term_ids, num_terms = _queries(seed=3, Q=10)
    encoded = {f"q{i}": term_ids[i, :n].tolist()
               for i, n in enumerate(num_terms)}
    encoded["oov"] = []
    names = [f"e{i}" for i in range(E)]
    sc = ScoreConfig(top_k=25, engine=engine, entity_chunk=128,
                     query_batch=4, similarity="cosine")
    want = ref_run.score_topics(_jp(p), cfg, encoded, names, sc)
    got = run.score_topics(params_from_jax(p), cfg, encoded, names, sc)
    assert got.keys() == want.keys() and got["oov"] == []
    for qid in want:
        assert [n for n, _ in got[qid]] == [n for n, _ in want[qid]]
        np.testing.assert_allclose([s for _, s in got[qid]],
                                   [s for _, s in want[qid]], **TOL)


@pytest.mark.parametrize("target", [0.0, -0.5, 1.5])
def test_approx_refuses_a_recall_target_outside_0_1(target):
    p = _np_params("lse", 40)
    sc = ScoreConfig(engine="approx", recall_target=target)
    with pytest.raises(ValueError, match="recall_target"):
        run.score_topics(params_from_jax(p), _cfg("lse", 40), {"q": [1, 2]},
                         [f"e{i}" for i in range(40)], sc)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ["auto", "dense", "streaming", "pallas",
                                    "approx", "bogus"])
def test_resolve_engine_matches_reference_off_the_tpu(engine, use_pallas):
    sc = ScoreConfig(engine=engine, use_pallas=use_pallas, entity_chunk=100)
    for E in (100, 101):
        try:
            want = ref_run.resolve_engine(sc, E)
        except ValueError:
            with pytest.raises(ValueError):
                run.resolve_engine(sc, E, CPU, 64)
            continue
        assert run.resolve_engine(sc, E, CPU, 64) == want


def test_resolve_engine_refuses_only_distributed():
    sc = ScoreConfig(engine="distributed")
    assert ref_run.resolve_engine(sc, 10) == "distributed"
    with pytest.raises(NotImplementedError, match="item 12"):
        run.resolve_engine(sc, 10, CPU, 64)


# --- the clustered layout ---------------------------------------------------

def _ref_draws(E, n_clusters=None, sample=1 << 16, seed=0):
    """The reference's _cluster_order draws, as it makes them."""
    if n_clusters is None:
        n_clusters = min(8192, max(256, E // 128))
    k1, k2 = jax.random.split(jax.random.key(seed))
    c = jax.random.choice(k1, E, (min(n_clusters, E),), replace=False)
    s = jax.random.choice(k2, E, (min(sample, E),), replace=False)
    return _t(c), _t(s)


@pytest.mark.parametrize("E,d,sample", [(1500, 32, 1 << 16),
                                        (1500, 32, 512),
                                        (40_000, 16, 1 << 16)])  # 2 slabs
def test_cluster_order_matches_reference_with_its_draws(E, d, sample):
    M = np.random.default_rng(E + d).normal(size=(E, d)).astype(np.float32)
    want = np.asarray(ref_topk._cluster_order(jnp.asarray(M), sample=sample))
    c, s = _ref_draws(E, sample=sample)
    got = exact_topk._cluster_order(_t(M), sample=sample, centroid_idx=c,
                                    sample_idx=s)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_cluster_order_is_a_repeatable_permutation():
    M = _t(np.random.default_rng(9).normal(size=(3000, 16))
           .astype(np.float32))
    a, b = exact_topk._cluster_order(M), exact_topk._cluster_order(M)
    assert torch.equal(a, b)
    assert torch.equal(torch.sort(a).values, torch.arange(3000))


@pytest.mark.parametrize("with_bias", [False, True])
def test_clustered_layout_matches_natural_and_reference(with_bias):
    R, M, bias, alpha = _mat(17, E=1500)
    b, a = (_t(bias), _t(alpha)) if with_bias else (None, None)
    nat = exact_topk.prepare_entities(_t(M))
    clu = exact_topk.prepare_entities(_t(M), layout="clustered")
    assert nat.perm is None
    assert torch.equal(torch.sort(clu.perm).values, torch.arange(1500))
    s0, i0 = exact_topk.exact_topk_prepared(_t(R), nat, b, a, k=40)
    s1, i1 = exact_topk.exact_topk_prepared(_t(R), clu, b, a, k=40)
    torch.testing.assert_close(s1, s0, **TOL)
    assert torch.equal(i1, i0)
    ref = ref_topk.prepare_entities(jnp.asarray(M), layout="clustered")
    rs, ri = ref_topk.exact_topk_prepared(
        jnp.asarray(R), ref, None if b is None else jnp.asarray(bias),
        None if a is None else jnp.asarray(alpha), k=40)
    np.testing.assert_allclose(s1.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ri))


# --- the two-phase adaptive rescore ------------------------------------------

@pytest.mark.parametrize("na,calls", [(2, [2, 16]),     # falls back
                                      (64, [16])])      # >= nb: one pass
def test_adaptive_bins_exact_both_branches(na, calls, k4_calls):
    R, M, _, _ = _mat(100 + na)
    prep = exact_topk.prepare_entities(_t(M), layout="clustered")
    s0, i0 = exact_topk.exact_topk_prepared(_t(R), prep, k=30)
    del k4_calls[:]
    s1, i1 = exact_topk.exact_topk_prepared(_t(R), prep, k=30,
                                            adaptive_bins=na)
    assert k4_calls == calls
    torch.testing.assert_close(s1, s0, **TOL)
    assert torch.equal(i1, i0)
    ref = ref_topk.prepare_entities(jnp.asarray(M), layout="clustered")
    rs, ri = ref_topk.exact_topk_prepared(jnp.asarray(R), ref, k=30,
                                          adaptive_bins=na)
    np.testing.assert_allclose(s1.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ri))


def _one_feature(scores, d=8):
    """M whose column 0 holds ``scores`` and R = e_0: R @ M^T = scores."""
    M = np.zeros((len(scores), d), np.float32)
    M[:, 0] = scores
    R = np.zeros((1, d), np.float32)
    R[0, 0] = 1.0
    return R, M


@pytest.mark.parametrize("prefilter", ["bfloat16", "float32"])
def test_adaptive_bins_accepts_phase_one_when_it_is_provably_exact(
        prefilter, k4_calls):
    """Every winner in one bin, every other bin far below theta: phase 1
    stands, one rescore of one bin."""
    s = np.zeros(1024, np.float32)
    s[:128] = 1.0 + np.arange(128) * 1e-3
    s[128:] = np.random.default_rng(0).uniform(-1, 0.5, size=896)
    R, M = _one_feature(s)
    prep = exact_topk.prepare_entities(_t(M), prefilter_dtype=prefilter)
    top_s, top_i = exact_topk.exact_topk_prepared(_t(R), prep, k=4,
                                                  adaptive_bins=1)
    assert k4_calls == [1]
    order = np.argsort(s)[::-1][:4]
    np.testing.assert_array_equal(top_i[0].numpy(), order)
    np.testing.assert_allclose(top_s[0].numpy(), s[order], rtol=1e-6)


def test_near_tie_bin_falls_back_not_skipped(k4_calls):
    """Bin 1's one entity is truly the second best, but bf16 rounds every
    bin max to 1.0; the acceptance slack must send the batch to the full
    rescore (as tests/test_ops.py holds the reference)."""
    s0 = 1.0 + np.arange(128) * 1e-5
    s1 = np.zeros(128)
    s1[0] = 1.001265
    scores = np.concatenate([s0, s1]).astype(np.float32)
    R, M = _one_feature(scores)
    prep = exact_topk.prepare_entities(_t(M))
    assert prep.bin_width == 128
    top_s, top_i = exact_topk.exact_topk_prepared(_t(R), prep, k=4,
                                                  adaptive_bins=1)
    assert k4_calls == [1, 2]
    order = np.argsort(scores)[::-1][:4]
    np.testing.assert_array_equal(np.sort(top_i[0].numpy()), np.sort(order))
    np.testing.assert_allclose(top_s[0].numpy(),
                               np.sort(scores[order])[::-1], rtol=1e-6,
                               atol=1e-6)


def test_adaptive_bins_too_small_for_k_raises():
    R, M, _, _ = _mat(3, Q=2)
    prep = exact_topk.prepare_entities(_t(M))
    with pytest.raises(ValueError, match="adaptive_bins"):
        exact_topk.exact_topk_prepared(_t(R), prep, k=200, adaptive_bins=1)


# --- the fp32 prefilter, bin width 64, the unfused rescore -------------------

@pytest.mark.parametrize("bw", [64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fp32_prefilter_plain_matches_reference_sweep(with_bias, bw):
    R, M, bias, alpha = _mat(bw + with_bias, E=1024)
    b, a = (bias, alpha) if with_bias else (None, None)
    Mp = ref_k3.prepare_binmax_matrix(jnp.asarray(M), te=512,
                                      dtype=jnp.float32)
    want = np.asarray(ref_k3.score_binmax_prepared(
        jnp.asarray(R), Mp, 1024, None if b is None else jnp.asarray(b),
        None if a is None else jnp.asarray(a), te=512, bin_width=bw))
    Mq = score_binmax.prepare_binmax_matrix(_t(M), torch.float32)
    assert Mq.dtype == torch.float32
    got = score_binmax.score_binmax_prepared(
        _t(R), Mq, 1024, None if b is None else _t(b),
        None if a is None else _t(a), bin_width=bw)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * scale)


def test_fp32_prefilter_recovers_the_fp64_topk_below_bf16_resolution():
    """One near-duplicate a bin, 64 bins whose maxima are 1e-5 apart (all
    one bf16 value), the rest far below: the bf16 prefilter sees 64 tied
    bins for 22 places; the fp32 one ranks them, and finds the fp64 top
    k, as the reference's fp32 sweep does."""
    n_bins, k = 64, 10
    rng = np.random.default_rng(4)
    s = rng.uniform(-0.5, 0.3, size=n_bins * 128)
    s[np.arange(n_bins) * 128 + rng.integers(0, 128, n_bins)] = (
        0.89 + np.arange(n_bins) * 1e-5)
    R, M = _one_feature(s.astype(np.float32))
    want = np.argsort(-R.astype(np.float64) @ M.astype(np.float64).T,
                      axis=1)[:, :k]
    bf = exact_topk.prepare_entities(_t(M))
    bins = score_binmax.score_binmax_prepared(_t(R), bf.Mp, len(s))
    assert torch.unique(torch.topk(bins, n_bins).values).numel() == 1
    prep = exact_topk.prepare_entities(_t(M), prefilter_dtype="float32")
    assert prep.Mp.dtype == torch.float32
    _, got = exact_topk.exact_topk_prepared(_t(R), prep, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = ref_topk.prepare_entities(jnp.asarray(M),
                                    prefilter_dtype="float32")
    _, ri = ref_topk.exact_topk_prepared(jnp.asarray(R), ref, k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ri))


@pytest.mark.parametrize("layout", ["natural", "clustered"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_unfused_rescore_equals_fused(with_bias, layout, k4_calls):
    R, M, bias, alpha = _mat(21, E=1500)
    b, a = (_t(bias), _t(alpha)) if with_bias else (None, None)
    prep = exact_topk.prepare_entities(_t(M), layout=layout)
    s0, i0 = exact_topk.exact_topk_prepared(_t(R), prep, b, a, k=25)
    del k4_calls[:]
    s1, i1 = exact_topk.exact_topk_prepared(_t(R), prep, b, a, k=25,
                                            fused_rescore=False)
    assert k4_calls == []
    assert torch.equal(s1, s0) and torch.equal(i1, i0)
    ref = ref_topk.prepare_entities(jnp.asarray(M), layout=layout)
    rs, ri = ref_topk.exact_topk_prepared(
        jnp.asarray(R), ref, None if b is None else jnp.asarray(bias),
        None if a is None else jnp.asarray(alpha), k=25,
        fused_rescore=False)
    np.testing.assert_allclose(s1.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ri))


@pytest.mark.parametrize("prefilter", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_bin_width_64_matches_reference(with_bias, prefilter):
    R, M, bias, alpha = _mat(31, E=1000)
    b, a = (bias, alpha) if with_bias else (None, None)
    prep = exact_topk.prepare_entities(_t(M), bin_width=64,
                                       prefilter_dtype=prefilter)
    assert prep.M_binned.shape[:2] == (16, 64)
    got_s, got_i = exact_topk.exact_topk_prepared(
        _t(R), prep, None if b is None else _t(b),
        None if a is None else _t(a), k=30)
    ref = ref_topk.prepare_entities(jnp.asarray(M), bin_width=64,
                                    prefilter_dtype=prefilter)
    rs, ri = ref_topk.exact_topk_prepared(
        jnp.asarray(R), ref, None if b is None else jnp.asarray(b),
        None if a is None else jnp.asarray(a), k=30)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ri))


def test_unknown_staging_options_raise():
    M = torch.randn(300, 16)
    with pytest.raises(ValueError, match="layout"):
        exact_topk.prepare_entities(M, layout="sorted")
    with pytest.raises(ValueError, match="prefilter_dtype"):
        exact_topk.prepare_entities(M, prefilter_dtype="float16")


@pytest.mark.parametrize("dtype,limit", [(torch.bfloat16, 512),
                                         (torch.float32, 672)])
def test_k3_limits_by_dtype(dtype, limit):
    assert score_binmax.kernel_limits(limit, dtype) is None
    assert score_binmax.kernel_limits(limit - 15, dtype) is None
    assert score_binmax.kernel_limits(limit + 1, dtype) is not None
    assert score_binmax.kernel_limits(64, torch.float16) is not None
