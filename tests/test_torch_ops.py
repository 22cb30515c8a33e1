"""The port's kernel modules against the JAX reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions and the
reference's kernels run under the Pallas interpreter (its default off the
TPU), on the same numpy inputs. The CUDA kernels are held to the plain
versions by tests/test_torch_kernels.py, on the card.

Tolerances: both sides multiply bf16-rounded inputs exactly and sum in
fp32, so the prefilter bin maxima agree to fp32 reassociation (rtol 1e-5);
rescored scores are fp32 dot products (1e-5).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sert_tpu_torch.ops import exact_topk, gather_rescore  # noqa: E402
from sert_tpu_torch.ops import score_binmax  # noqa: E402

# sert_tpu.ops re-exports functions under its modules' names, so the
# reference modules are imported by their full names.
ref_topk = importlib.import_module("sert_tpu.ops.exact_topk")
ref_k3 = importlib.import_module("sert_tpu.ops.score_binmax")
ref_k4 = importlib.import_module("sert_tpu.ops.gather_rescore")

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed, Q=8, E=1024, d=32, unit=False):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(Q, d)).astype(np.float32)
    M = rng.normal(size=(E, d)).astype(np.float32)
    if unit:
        R /= np.linalg.norm(R, axis=1, keepdims=True)
        M /= np.linalg.norm(M, axis=1, keepdims=True)
    bias = rng.normal(size=E).astype(np.float32)
    alpha = rng.integers(1, 5, size=Q).astype(np.float32)
    return R, M, bias, alpha


def _bf16_scores(R, M):
    """fp64 scores of the bf16-rounded inputs (numpy, independent of both
    packages)."""
    r = np.asarray(jnp.asarray(R, jnp.bfloat16), np.float64)
    m = np.asarray(jnp.asarray(M, jnp.bfloat16), np.float64)
    return r @ m.T


class TestScoreBinmax:
    @pytest.mark.parametrize("bw", [64, 128])
    @pytest.mark.parametrize("with_bias", [False, True])
    def test_plain_matches_pallas(self, with_bias, bw):
        R, M, bias, alpha = _data(bw + with_bias, E=1024)
        b, a = (bias, alpha) if with_bias else (None, None)
        Mp = ref_k3.prepare_binmax_matrix(jnp.asarray(M), te=512)
        want = np.asarray(ref_k3.score_binmax_prepared(
            jnp.asarray(R), Mp, 1024,
            None if b is None else jnp.asarray(b),
            None if a is None else jnp.asarray(a), te=512, bin_width=bw))
        got = score_binmax.score_binmax(
            torch.from_numpy(R), torch.from_numpy(M),
            None if b is None else torch.from_numpy(b),
            None if a is None else torch.from_numpy(a), bin_width=bw)
        assert got.shape == (8, 1024 // bw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    @pytest.mark.parametrize("E", [1000, 777])
    def test_ragged_tail_bin_holds_valid_entities_only(self, E):
        """Full bins equal the reference; the partial tail bin is the max
        over its valid entities (the reference pads with zero rows, which
        may inflate it, so it is checked against numpy instead)."""
        R, M, _, _ = _data(E, E=E)
        want = np.asarray(ref_k3.score_binmax(jnp.asarray(R),
                                              jnp.asarray(M)))
        got = score_binmax.score_binmax(torch.from_numpy(R),
                                        torch.from_numpy(M)).numpy()
        full = E // 128
        np.testing.assert_allclose(got[:, :full], want[:, :full], **TOL)
        tail = _bf16_scores(R, M)[:, full * 128:].max(axis=1)
        np.testing.assert_allclose(got[:, full], tail, **TOL)

    @pytest.mark.parametrize("E", [1024, 1000])
    def test_bw64_bias_matches_pallas_and_tail(self, E):
        """bw = 64 with the bias: full bins equal the reference; at E = 1000
        the partial tail bin (40 valid entities) is the max over its valid
        entities, held against numpy (the reference's zero rows score
        alpha * 0 + 0 there and may inflate it)."""
        R, M, bias, alpha = _data(E + 64, E=E)
        Mp = ref_k3.prepare_binmax_matrix(jnp.asarray(M), te=512)
        want = np.asarray(ref_k3.score_binmax_prepared(
            jnp.asarray(R), Mp, E, jnp.asarray(bias), jnp.asarray(alpha),
            te=512, bin_width=64))
        got = score_binmax.score_binmax(
            torch.from_numpy(R), torch.from_numpy(M), torch.from_numpy(bias),
            torch.from_numpy(alpha), bin_width=64).numpy()
        full = E // 64
        assert got.shape == (8, -(-E // 64))
        np.testing.assert_allclose(got[:, :full], want[:, :full], **TOL)
        if full < got.shape[1]:
            s = (_bf16_scores(R, M) + alpha[:, None].astype(np.float64)
                 * bias[None, :])
            np.testing.assert_allclose(got[:, full],
                                       s[:, full * 64:].max(axis=1), **TOL)

    def test_feature_width_is_padded_to_16(self):
        M = torch.randn(10, 20)
        Mp = score_binmax.prepare_binmax_matrix(M)
        assert Mp.shape == (10, 32) and Mp.dtype == torch.bfloat16
        assert torch.equal(Mp[:, 20:], torch.zeros(10, 12, dtype=Mp.dtype))

    def test_other_devices_raise_instead_of_falling_back(self):
        R = torch.zeros(2, 16, device="meta")
        Mp = torch.zeros(4, 16, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            score_binmax.score_binmax_prepared(R, Mp, 4)


class TestGatherRescore:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_pallas(self, dtype):
        rng = np.random.default_rng(3)
        Q, n_bins, bw, d, NB = 16, 12, 128, 32, 5
        R = rng.normal(size=(Q, d)).astype(np.float32)
        Mb = rng.normal(size=(n_bins, bw, d)).astype(np.float32)
        idx = rng.integers(0, n_bins, size=(Q, NB)).astype(np.int32)
        Mj = jnp.asarray(Mb, getattr(jnp, dtype))
        want = np.asarray(ref_k4.gather_rescore(jnp.asarray(R), Mj,
                                                jnp.asarray(idx)))
        Mt = torch.from_numpy(Mb).to(getattr(torch, dtype))
        got = gather_rescore.gather_rescore(torch.from_numpy(R), Mt,
                                            torch.from_numpy(idx))
        assert got.shape == (Q, NB * bw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("case", ["duplicates", "bw64", "shared"])
    def test_plain_matches_pallas_on_bin_choices(self, case, dtype):
        """The kernel's card cases the reference takes (Q a multiple of its
        16): a bin twice in a row, bins of 64, and every query on the same
        bins, each row in its own order."""
        rng = np.random.default_rng(4)
        Q, n_bins, d, NB = 32, 12, 32, 6
        bw = 64 if case == "bw64" else 128
        R = rng.normal(size=(Q, d)).astype(np.float32)
        Mb = rng.normal(size=(n_bins, bw, d)).astype(np.float32)
        idx = rng.integers(0, n_bins, size=(Q, NB)).astype(np.int32)
        if case == "duplicates":
            idx[:, 1] = idx[:, 0]
            idx[::2, 5] = idx[::2, 2]
        elif case == "shared":
            idx = np.stack([rng.permutation(NB) for _ in range(Q)])
            idx = idx.astype(np.int32)
        Mj = jnp.asarray(Mb, getattr(jnp, dtype))
        want = np.asarray(ref_k4.gather_rescore(jnp.asarray(R), Mj,
                                                jnp.asarray(idx)))
        Mt = torch.from_numpy(Mb).to(getattr(torch, dtype))
        got = gather_rescore.gather_rescore(torch.from_numpy(R), Mt,
                                            torch.from_numpy(idx))
        assert got.shape == (Q, NB * bw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _oracle_check(got_s, got_i, dense, k):
    """Returned scores are the dense scores of the returned ids; the id
    set equals the dense top-k wherever the k-th/(k+1)-th gap is clear."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    np.testing.assert_allclose(
        got_s, np.take_along_axis(dense, got_i, axis=1), **TOL)
    order = np.argsort(-dense, axis=1)
    for q in range(dense.shape[0]):
        srt = dense[q, order[q]]
        if srt[k - 1] - srt[k] > 1e-5:
            assert set(got_i[q]) == set(order[q, :k])


class TestExactTopk:
    @pytest.mark.parametrize("with_bias", [False, True])
    @pytest.mark.parametrize("E,k", [(5000, 10), (700, 40)])
    def test_matches_reference_and_dense(self, E, k, with_bias):
        R, M, bias, alpha = _data(E + k, Q=16, E=E, unit=True)
        b, a = (bias, alpha) if with_bias else (None, None)
        dense = R.astype(np.float64) @ M.astype(np.float64).T
        if with_bias:
            dense = dense + alpha[:, None] * bias[None, :]
        dense = dense.astype(np.float32)
        t = (lambda x: None if x is None else torch.from_numpy(x))
        got_s, got_i = exact_topk.exact_topk(t(R), t(M), t(b), t(a), k=k)
        j = (lambda x: None if x is None else jnp.asarray(x))
        ref_s, ref_i = ref_topk.exact_topk(j(R), j(M), j(b), j(a), k=k)
        _oracle_check(got_s.numpy(), got_i.numpy(), dense, k)
        _oracle_check(ref_s, ref_i, dense, k)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), **TOL)

    def test_bf16_rescore_matches_reference(self):
        R, M, _, _ = _data(11, Q=16, E=3000, unit=True)
        got_s, _ = exact_topk.exact_topk(torch.from_numpy(R),
                                         torch.from_numpy(M), k=20,
                                         rescore_dtype="bfloat16")
        ref_s, _ = ref_topk.exact_topk(jnp.asarray(R), jnp.asarray(M), k=20,
                                       rescore_dtype="bfloat16")
        np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), **TOL)

    def test_k_clamped_to_entities(self):
        R, M, _, _ = _data(6, E=200)
        s, i = exact_topk.exact_topk(torch.from_numpy(R),
                                     torch.from_numpy(M), k=500)
        assert s.shape == (8, 200)
        assert (np.sort(i.numpy(), axis=1) == np.arange(200)).all()

    @pytest.mark.parametrize("na", [0, 2, 64])
    def test_clustered_adaptive_matches_reference(self, na):
        """The clustered layout with the two-phase rescore (na 2: phase 1
        then the fallback; 64: one pass) against the reference's."""
        R, M, bias, alpha = _data(40 + na, E=2048)
        prep = exact_topk.prepare_entities(torch.from_numpy(M),
                                           layout="clustered")
        got_s, got_i = exact_topk.exact_topk_prepared(
            torch.from_numpy(R), prep, torch.from_numpy(bias),
            torch.from_numpy(alpha), k=30, adaptive_bins=na)
        ref = ref_topk.prepare_entities(jnp.asarray(M), layout="clustered")
        want_s, want_i = ref_topk.exact_topk_prepared(
            jnp.asarray(R), ref, jnp.asarray(bias), jnp.asarray(alpha), k=30,
            adaptive_bins=na)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))

    @pytest.mark.parametrize("E,d,want", [
        (1_000_000, 128, "float32"), (32 << 20, 128, "float32"),
        ((32 << 20) + 1, 128, "bfloat16")])
    def test_auto_rescore_dtype_budget(self, E, d, want):
        assert exact_topk.resolve_rescore_dtype("auto", E, d) == want
        assert exact_topk.resolve_rescore_dtype("bfloat16", E, d) == \
            "bfloat16"
        with pytest.raises(ValueError):
            exact_topk.resolve_rescore_dtype("fp16", E, d)
