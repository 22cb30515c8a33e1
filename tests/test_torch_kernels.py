"""The port's CUDA kernels (K1/K2 sampled_lse, K3 score_binmax, K4
gather_rescore, K5/K6/K7 xent) against their plain PyTorch versions, and
the build that binds them.

Imports nothing of JAX, so it runs on a host without it. The ``gpu`` tests
skip without a CUDA device; on the card run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX for the reference's tests).

Tolerances: the kernel and its plain version multiply the same
bf16-rounded (K3) or fp32 (K4) inputs and sum in fp32 in another order
(rtol 1e-5, atol 1e-5). K1/K2 likewise, relative to the largest output
(1e-4 in fp32); in bf16 the probabilities are rounded after fp32 sums that
differ in order, so an element may land one bf16 step apart (2e-2). K5/K6
the same, for the loss, lse, dpooled, dW and db; K7 as K5/K6, with the
updated W held relative to the learning rate.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu_torch.ops import _build, exact_topk  # noqa: E402
from sert_tpu_torch.ops import gather_rescore, score_binmax  # noqa: E402
from sert_tpu_torch.ops import sampled_lse, xent  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed, Q, E, d):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(Q, d)).astype(np.float32)
    M = rng.normal(size=(E, d)).astype(np.float32)
    R /= np.linalg.norm(R, axis=1, keepdims=True)
    M /= np.linalg.norm(M, axis=1, keepdims=True)
    bias = rng.normal(size=E).astype(np.float32)
    alpha = rng.integers(1, 5, size=Q).astype(np.float32)
    return R, M, bias, alpha


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run pytest -m gpu on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class TestBuild:
    def test_library_is_named_by_source_hash_for_sm90a(self):
        path = _build.library_path()
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith("libsert_kernels-")
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        assert {s.name for s in _build._sources()} >= {
            "score_binmax.cu", "gather_rescore.cu", "sampled_lse.cu",
            "xent.cu", "tile_mm.cuh"}

    def test_every_entry_point_is_declared(self):
        src = "".join(p.read_text() for p in _build._sources())
        for name in _build._SIGNATURES:
            assert f'extern "C" int {name}(' in src

    def test_plain_path_does_not_count_launches(self):
        n3, n4 = score_binmax.launches, gather_rescore.launches
        exact_topk.exact_topk(torch.randn(4, 16), torch.randn(500, 16), k=5)
        assert (score_binmax.launches, gather_rescore.launches) == (n3, n4)

    @pytest.mark.gpu
    def test_failed_launch_raises(self, cuda):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(1, "probe")


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("bw", [64, 128])
    @pytest.mark.parametrize("E", [1024, 777, 5000])
    @pytest.mark.parametrize("with_bias", [False, True])
    def test_score_binmax_matches_plain(self, cuda, E, with_bias, bw):
        R, M, bias, alpha = (torch.from_numpy(x).to(cuda)
                             for x in _data(E, Q=70, E=E, d=48))
        Mp = score_binmax.prepare_binmax_matrix(M)
        b, a = (bias, alpha) if with_bias else (None, None)
        n = score_binmax.launches
        got = score_binmax.score_binmax_prepared(R, Mp, E, b, a, bw)
        assert score_binmax.launches == n + 1
        want = score_binmax.score_binmax_plain(R, Mp, E, b, a, bw)
        assert got.shape == (70, -(-E // bw))
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gather_rescore_matches_plain(self, cuda, dtype):
        g = torch.Generator(device=cuda).manual_seed(0)
        R = torch.randn(33, 64, generator=g, device=cuda)
        Mb = torch.randn(50, 128, 64, generator=g, device=cuda).to(dtype)
        idx = torch.randint(0, 50, (33, 21), generator=g, device=cuda,
                            dtype=torch.int32)
        n = gather_rescore.launches
        got = gather_rescore.gather_rescore(R, Mb, idx)
        assert gather_rescore.launches == n + 1
        want = gather_rescore.gather_rescore_plain(R, Mb, idx)
        torch.testing.assert_close(got, want, **TOL)

    def test_gather_rescore_out_of_range_bin_is_nan(self, cuda):
        R = torch.ones(2, 16, device=cuda)
        Mb = torch.ones(3, 64, 16, device=cuda)
        idx = torch.tensor([[0, 3], [-1, 2]], dtype=torch.int32, device=cuda)
        out = gather_rescore.gather_rescore(R, Mb, idx)
        assert out[0, :64].eq(16).all() and out[0, 64:].isnan().all()
        assert out[1, :64].isnan().all() and out[1, 64:].eq(16).all()

    @pytest.mark.parametrize("with_bias", [False, True])
    @pytest.mark.parametrize("E", [1024, 1025])       # a tile edge, one past
    @pytest.mark.parametrize("Q,d", [(1, 48), (130, 512)])
    @pytest.mark.parametrize("bw", [128, 64, 16, 2])
    def test_score_binmax_shapes(self, cuda, bw, Q, d, E, with_bias):
        R, M, bias, alpha = (torch.from_numpy(x).to(cuda)
                             for x in _data(Q + E, Q=Q, E=E, d=d))
        Mp = score_binmax.prepare_binmax_matrix(M)
        b, a = (bias, alpha) if with_bias else (None, None)
        got = score_binmax.score_binmax_prepared(R, Mp, E, b, a, bw)
        want = score_binmax.score_binmax_plain(R, Mp, E, b, a, bw)
        assert got.shape == (Q, -(-E // bw))
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("with_bias", [False, True])
    @pytest.mark.parametrize("d", [192, 320, 512])
    @pytest.mark.parametrize("Q", [64, 130])
    def test_score_binmax_walks_many_tiles(self, cuda, Q, d, with_bias):
        """E past 100k: every block takes many tiles in turn between its
        two warpgroups, each tile of 3, 5 or 8 sub-tiles through a ring of
        4 stages a warpgroup."""
        E = 100_003
        g = torch.Generator(device=cuda).manual_seed(Q + d)
        R = torch.nn.functional.normalize(
            torch.randn(Q, d, generator=g, device=cuda), dim=1)
        M = torch.nn.functional.normalize(
            torch.randn(E, d, generator=g, device=cuda), dim=1)
        ba = ((torch.randn(E, generator=g, device=cuda),
               torch.randint(1, 5, (Q,), generator=g, device=cuda).float())
              if with_bias else ())
        Mp = score_binmax.prepare_binmax_matrix(M)
        got = score_binmax.score_binmax_prepared(R, Mp, E, *ba, bin_width=128)
        want = score_binmax.score_binmax_plain(R, Mp, E, *ba, bin_width=128)
        assert got.shape == (Q, -(-E // 128))
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("bw", [1, 2, 4, 8, 16, 32, 64, 128])
    def test_score_binmax_every_bin_width(self, cuda, bw):
        R, M, bias, alpha = (torch.from_numpy(x).to(cuda)
                             for x in _data(bw, Q=70, E=1000, d=64))
        Mp = score_binmax.prepare_binmax_matrix(M)
        got = score_binmax.score_binmax_prepared(R, Mp, 1000, bias, alpha,
                                                 bw)
        want = score_binmax.score_binmax_plain(R, Mp, 1000, bias, alpha, bw)
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("Q,d", [(1, 48), (70, 512), (300, 48),
                                     (33, 36)])
    @pytest.mark.parametrize("bw", [64, 128])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gather_rescore_shapes(self, cuda, dtype, bw, Q, d):
        """40 bins, 13 drawn a query with repeats (duplicates in a row); d
        36 gives rows of 72 bytes in bf16, which a 16-byte copy does not
        divide. Rows of unit norm, as the serving path's cosine scores: the 1e-5
        contract is absolute at that scale (N(0, 1) rows at d = 512 give
        scores near 22, whose fp32 sums in two orders differ by ~3e-5)."""
        g = torch.Generator(device=cuda).manual_seed(Q + d + bw)
        R = torch.randn(Q, d, generator=g, device=cuda)
        R = R / R.norm(dim=1, keepdim=True)
        Mb = torch.randn(40, bw, d, generator=g, device=cuda)
        Mb = (Mb / Mb.norm(dim=2, keepdim=True)).to(dtype)
        idx = torch.randint(0, 40, (Q, 13), generator=g, device=cuda,
                            dtype=torch.int32)
        got = gather_rescore.gather_rescore(R, Mb, idx)
        want = gather_rescore.gather_rescore_plain(R, Mb, idx)
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gather_rescore_duplicates_and_one_bin(self, cuda, dtype):
        """Every query holds bin 3 in every slot: one bin, 70 * 9 pairs."""
        g = torch.Generator(device=cuda).manual_seed(1)
        R = torch.randn(70, 128, generator=g, device=cuda)
        Mb = torch.randn(6, 128, 128, generator=g, device=cuda).to(dtype)
        idx = torch.full((70, 9), 3, dtype=torch.int32, device=cuda)
        got = gather_rescore.gather_rescore(R, Mb, idx)
        want = gather_rescore.gather_rescore_plain(R, Mb, idx)
        torch.testing.assert_close(got, want, **TOL)

    def test_gather_rescore_shared_bins(self, cuda):
        """Every query holds the same bins, each row in its own order (unit
        rows, as in test_gather_rescore_shapes)."""
        g = torch.Generator(device=cuda).manual_seed(2)
        R = torch.randn(64, 128, generator=g, device=cuda)
        R = R / R.norm(dim=1, keepdim=True)
        Mb = torch.randn(300, 128, 128, generator=g, device=cuda)
        Mb = Mb / Mb.norm(dim=2, keepdim=True)
        idx = torch.stack([torch.randperm(100, generator=g, device=cuda)
                           for _ in range(64)]).int()
        got = gather_rescore.gather_rescore(R, Mb, idx)
        want = gather_rescore.gather_rescore_plain(R, Mb, idx)
        torch.testing.assert_close(got, want, **TOL)

    def test_gather_rescore_no_bins(self, cuda):
        R = torch.randn(5, 16, device=cuda)
        Mb = torch.randn(3, 64, 16, device=cuda)
        idx = torch.zeros(5, 0, dtype=torch.int32, device=cuda)
        assert gather_rescore.gather_rescore(R, Mb, idx).shape == (5, 0)

    def test_gather_rescore_two_calls_are_bit_equal(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(3)
        R = torch.randn(64, 128, generator=g, device=cuda)
        Mb = torch.randn(500, 128, 128, generator=g, device=cuda)
        idx = torch.randint(0, 500, (64, 120), generator=g, device=cuda,
                            dtype=torch.int32)
        a = gather_rescore.gather_rescore(R, Mb, idx)
        b = gather_rescore.gather_rescore(R, Mb, idx)
        assert torch.equal(a, b)

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, cuda):
        R = torch.randn(4, 24, device=cuda)                 # d % 16 != 0
        Mp = torch.randn(100, 24, device=cuda).bfloat16()
        with pytest.raises(ValueError, match="d % 16"):
            score_binmax.score_binmax_prepared(R, Mp, 100)
        with pytest.raises(ValueError, match="bf16 or fp32 Mp"):
            score_binmax.score_binmax_prepared(R, Mp.half(), 100)
        wide = torch.randn(4, 688, device=cuda)          # past the fp32 limit
        with pytest.raises(ValueError, match="d <= 672"):
            score_binmax.score_binmax_prepared(wide, wide.clone(), 4)
        Mb = torch.randn(3, 128, 24, device=cuda)
        idx = torch.zeros(4, 2, dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError, match="int32"):
            gather_rescore.gather_rescore(R, Mb, idx)

    @pytest.mark.parametrize("with_bias", [False, True])
    @pytest.mark.parametrize("E", [1024, 1025, 777])  # a tile edge, one past
    @pytest.mark.parametrize("d", [16, 48, 128, 320, 512, 672])
    @pytest.mark.parametrize("bw", [128, 64])
    def test_score_binmax_f32_matches_plain(self, cuda, bw, d, E, with_bias):
        """K3's fp32 mode (3xTF32) against the plain version's fp32
        products: d from 16 to its limit, E at and past a tile edge."""
        R, M, bias, alpha = (torch.from_numpy(x).to(cuda)
                             for x in _data(d + E, Q=70, E=E, d=d))
        Mp = score_binmax.prepare_binmax_matrix(M, torch.float32)
        b, a = (bias, alpha) if with_bias else (None, None)
        n, n16 = score_binmax.f32_launches, score_binmax.launches
        got = score_binmax.score_binmax_prepared(R, Mp, E, b, a, bw)
        assert (score_binmax.f32_launches, score_binmax.launches) == \
            (n + 1, n16)
        want = score_binmax.score_binmax_plain(R, Mp, E, b, a, bw)
        assert got.shape == (70, -(-E // bw))
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("bw", [1, 2, 4, 8, 16, 32])
    def test_score_binmax_f32_every_bin_width(self, cuda, bw):
        R, M, bias, alpha = (torch.from_numpy(x).to(cuda)
                             for x in _data(bw, Q=9, E=1000, d=64))
        Mp = score_binmax.prepare_binmax_matrix(M, torch.float32)
        got = score_binmax.score_binmax_prepared(R, Mp, 1000, bias, alpha, bw)
        want = score_binmax.score_binmax_plain(R, Mp, 1000, bias, alpha, bw)
        torch.testing.assert_close(got, want, **TOL)

    @pytest.mark.parametrize("Q", [1, 64, 130])
    def test_score_binmax_f32_walks_many_tiles(self, cuda, Q):
        """E past 100k: each block takes many tiles, each of 4 chunks
        through the 3-stage ring; close to fp64 (3xTF32)."""
        E, d = 100_003, 128
        g = torch.Generator(device=cuda).manual_seed(Q)
        R = torch.nn.functional.normalize(
            torch.randn(Q, d, generator=g, device=cuda), dim=1)
        M = torch.nn.functional.normalize(
            torch.randn(E, d, generator=g, device=cuda), dim=1)
        Mp = score_binmax.prepare_binmax_matrix(M, torch.float32)
        got = score_binmax.score_binmax_prepared(R, Mp, E)
        torch.testing.assert_close(
            got, score_binmax.score_binmax_plain(R, Mp, E), **TOL)
        s64 = (R.double() @ M.double().T)
        s64 = torch.nn.functional.pad(s64, (0, -E % 128),
                                      value=float("-inf"))
        want64 = s64.view(Q, -1, 128).amax(-1)
        assert (got.double() - want64).abs().max().item() < 2e-6

    @pytest.mark.parametrize("with_bias", [False, True])
    @pytest.mark.parametrize("d", [128, 320, 512, 672])
    def test_score_binmax_f32_error_within_adaptive_slack(self, cuda, d,
                                                          with_bias):
        """K3's fp32 mode against fp64 bin maxima, as the two-phase
        rescore's acceptance cut reads it (each query's worst error over
        its largest bin max): the fp32 slack covers it four times, from
        d 128 up to the mode's widest d."""
        E, Q = 100_003, 64
        g = torch.Generator(device=cuda).manual_seed(d)
        R = torch.nn.functional.normalize(
            torch.randn(Q, d, generator=g, device=cuda), dim=1)
        M = torch.nn.functional.normalize(
            torch.randn(E, d, generator=g, device=cuda), dim=1)
        b, a = ((0.1 * torch.randn(E, generator=g, device=cuda),
                 torch.randint(1, 9, (Q,), generator=g, device=cuda).float())
                if with_bias else (None, None))
        Mp = score_binmax.prepare_binmax_matrix(M, torch.float32)
        got = score_binmax.score_binmax_prepared(R, Mp, E, b, a).double()
        s64 = R.double() @ M.double().T
        if with_bias:
            s64 += a.double()[:, None] * b.double()[None, :]
        s64 = torch.nn.functional.pad(s64, (0, -E % 128),
                                      value=float("-inf"))
        want = s64.view(Q, -1, 128).amax(-1)
        rel = ((got - want).abs().amax(1) / want.amax(1).abs()).max().item()
        assert 4 * rel <= exact_topk.ADAPTIVE_EPS[torch.float32], rel

    def test_exact_topk_f32_prefilter_on_card_matches_cpu(self, cuda):
        R, M, _, _ = _data(5, Q=64, E=20000, d=128)
        cpu = exact_topk.prepare_entities(torch.from_numpy(M),
                                          prefilter_dtype="float32")
        cpu_s, cpu_i = exact_topk.exact_topk_prepared(torch.from_numpy(R),
                                                      cpu, k=100)
        gpu = exact_topk.prepare_entities(torch.from_numpy(M).to(cuda),
                                          prefilter_dtype="float32")
        n = score_binmax.f32_launches
        gpu_s, gpu_i = exact_topk.exact_topk_prepared(
            torch.from_numpy(R).to(cuda), gpu, k=100)
        assert score_binmax.f32_launches == n + 1
        torch.testing.assert_close(gpu_s.cpu(), cpu_s, **TOL)
        assert torch.equal(gpu_i.cpu(), cpu_i)

    def test_cluster_order_on_card_is_repeatable(self, cuda):
        """Ordered segment sums (no float atomics): two stagings on the
        card give the same permutation."""
        M = torch.from_numpy(_data(6, Q=1, E=50_000, d=64)[1]).to(cuda)
        perm = exact_topk._cluster_order(M)
        assert torch.equal(perm, exact_topk._cluster_order(M))
        assert torch.equal(torch.sort(perm).values,
                           torch.arange(50_000, device=cuda))

    @pytest.mark.parametrize("na", [0, 2, 64])
    def test_clustered_adaptive_on_card_matches_cpu(self, cuda, na):
        R, M, bias, alpha = _data(7, Q=64, E=20000, d=128)
        prep = exact_topk.prepare_entities(torch.from_numpy(M).to(cuda),
                                           layout="clustered")
        got_s, got_i = exact_topk.exact_topk_prepared(
            torch.from_numpy(R).to(cuda), prep,
            torch.from_numpy(bias).to(cuda),
            torch.from_numpy(alpha).to(cuda), k=100, adaptive_bins=na)
        want_s, want_i = exact_topk.exact_topk(
            torch.from_numpy(R), torch.from_numpy(M),
            torch.from_numpy(bias), torch.from_numpy(alpha), k=100)
        torch.testing.assert_close(got_s.cpu(), want_s, **TOL)
        assert torch.equal(got_i.cpu(), want_i)

    def test_exact_topk_on_card_matches_cpu(self, cuda):
        R, M, _, _ = _data(4, Q=64, E=20000, d=128)
        cpu_s, cpu_i = exact_topk.exact_topk(torch.from_numpy(R),
                                             torch.from_numpy(M), k=100)
        n3, n4 = score_binmax.launches, gather_rescore.launches
        gpu_s, gpu_i = exact_topk.exact_topk(torch.from_numpy(R).to(cuda),
                                             torch.from_numpy(M).to(cuda),
                                             k=100)
        assert score_binmax.launches == n3 + 1
        assert gather_rescore.launches == n4 + 1
        torch.testing.assert_close(gpu_s.cpu(), cpu_s, **TOL)
        dense = R.astype(np.float64) @ M.astype(np.float64).T
        np.testing.assert_allclose(
            gpu_s.cpu().numpy(),
            np.take_along_axis(dense, gpu_i.cpu().numpy(), axis=1), **TOL)


SLSE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _slse_inputs(dev, B, k, d, all_masked=False, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    reps = torch.tanh(torch.randn(B, d, generator=g, device=dev))
    cand = torch.randn(k, d, generator=g, device=dev) * (2.0 / d ** 0.5)
    corr = 0.5 * torch.randn(k, generator=g, device=dev)
    pos = torch.randint(0, 1000, (B,), generator=g, device=dev)
    ids = torch.randint(0, 1000, (k,), generator=g, device=dev)
    ids[:min(B, k) // 2] = pos[:min(B, k) // 2]
    if all_masked:
        ids[:] = 7
        pos[pos == 7] = 8
        pos[0] = 7
    return reps, cand, corr, ids, pos


def _slse_run(fn, reps, cand, corr, ids, pos, dtype):
    r, c, co = (t.clone().requires_grad_(True) for t in (reps, cand, corr))
    lse = fn(r, c, co, ids, pos, dtype)
    s_pos = torch.linspace(-1, 1, reps.shape[0], device=reps.device)
    grads = torch.autograd.grad(
        torch.nn.functional.softplus(lse - s_pos).sum(), [r, c, co])
    return [lse.detach(), *grads]


@pytest.mark.gpu
class TestSampledLseOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,k,d", [(256, 4096, 128), (100, 777, 24),
                                       (64, 64, 256), (300, 130, 40)])
    def test_kernels_match_plain(self, cuda, B, k, d, dtype):
        x = _slse_inputs(cuda, B, k, d)
        n = (sampled_lse.fwd_launches, sampled_lse.bwd_launches)
        got = _slse_run(sampled_lse.sampled_lse, *x, dtype)
        assert (sampled_lse.fwd_launches, sampled_lse.bwd_launches) == (
            n[0] + 1, n[1] + 1)
        want = _slse_run(sampled_lse.sampled_lse_plain, *x, dtype)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            err = (a.float() - b.float()).abs().max().item()
            assert err <= SLSE_TOL[dtype] * b.abs().max().item()

    def test_all_masked_row_has_zero_gradient(self, cuda):
        x = _slse_inputs(cuda, 128, 1000, 64, all_masked=True)
        lse, dreps, _, _ = _slse_run(sampled_lse.sampled_lse, *x,
                                     "bfloat16")
        assert lse[0].item() < -1e29 and not bool(dreps[0].any())
        assert bool(torch.isfinite(dreps).all())

    def test_bf16_candidates_keep_their_dtype(self, cuda):
        reps, cand, corr, ids, pos = _slse_inputs(cuda, 64, 500, 32)
        c = cand.bfloat16().requires_grad_(True)
        out = sampled_lse.sampled_lse(reps, c, corr, ids, pos, "bfloat16")
        (g,) = torch.autograd.grad(out.sum(), [c])
        assert g.dtype == torch.bfloat16

    def test_backward_is_deterministic(self, cuda):
        x = _slse_inputs(cuda, 512, 3000, 128)
        a = _slse_run(sampled_lse.sampled_lse, *x, "bfloat16")
        b = _slse_run(sampled_lse.sampled_lse, *x, "bfloat16")
        assert all(torch.equal(u, v) for u, v in zip(a, b))

    # The amazon_* recipes' k = 256 (d 256 bf16, d 128 fp32: the dC sweep
    # split into one slice a batch tile), k under one tile (the most
    # slices), d = 256 with many candidate tiles, and a ragged B.
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,k,d", [(4096, 256, 256), (1024, 256, 128),
                                       (4096, 100, 128), (512, 3000, 256),
                                       (1000, 2049, 128)])
    def test_planned_shapes_match_plain(self, cuda, B, k, d, dtype):
        fwd, dc = sampled_lse._plan(B, k, d, dtype)
        assert fwd.blocks >= 1 and dc.blocks >= 1
        x = _slse_inputs(cuda, B, k, d)
        got = _slse_run(sampled_lse.sampled_lse, *x, dtype)
        want = _slse_run(sampled_lse.sampled_lse_plain, *x, dtype)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            err = (a.float() - b.float()).abs().max().item()
            assert err <= SLSE_TOL[dtype] * b.abs().max().item()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,k,d", [(4096, 100, 128), (4096, 256, 256)])
    def test_sliced_backward_is_bit_equal(self, cuda, B, k, d, dtype):
        dc = sampled_lse._plan(B, k, d, dtype)[1]
        assert dc.parts >= 32 and (k > 128 or dc.parts == dc.n_y)
        x = _slse_inputs(cuda, B, k, d)
        a = _slse_run(sampled_lse.sampled_lse, *x, dtype)
        b = _slse_run(sampled_lse.sampled_lse, *x, dtype)
        assert all(torch.equal(u, v) for u, v in zip(a, b))

    def test_wrapper_refuses_what_the_kernels_do_not_take(self, cuda):
        reps, cand, corr, ids, pos = _slse_inputs(cuda, 8, 16, 16)
        with pytest.raises(ValueError, match="d <= 256"):
            sampled_lse.sampled_lse(torch.zeros(8, 300, device=cuda),
                                    torch.zeros(16, 300, device=cuda),
                                    corr, ids, pos)
        with pytest.raises(ValueError, match="dtype"):
            sampled_lse.sampled_lse(reps, cand, corr, ids, pos, "float16")
        with pytest.raises(ValueError, match="on cpu"):
            sampled_lse.sampled_lse(reps, cand, corr.cpu(), ids, pos)
        with pytest.raises(ValueError, match="shapes"):
            sampled_lse.sampled_lse(reps, cand, corr[:3], ids, pos)


@pytest.mark.gpu
def test_negative_sampling_repeats_on_the_card(cuda):
    """The same generator seed draws the same negatives (a 1-D cumsum on
    CUDA would not: see models.lse._cumsum)."""
    from sert_tpu_torch.models import lse
    from sert_tpu_torch.utils.config import ModelConfig
    cfg = ModelConfig(model="lse", num_entities=1_000_000,
                      num_negatives=32768)
    g = torch.Generator(device=cuda).manual_seed(3)
    noise = 0.75 * torch.log(torch.randint(1, 50, (cfg.num_entities,),
                                           generator=g, device=cuda).float())
    draws = [lse.sample_negatives(torch.Generator(device=cuda).manual_seed(0),
                                  noise, 4, cfg) for _ in range(8)]
    assert all(torch.equal(draws[0], d) for d in draws[1:])
    cdf, log_q = lse.noise_table(noise)
    for _ in range(8):
        again = lse.noise_table(noise)
        assert torch.equal(cdf, again[0]) and torch.equal(log_q, again[1])


def _heavy_ids(g, n, rows, dev):
    """``n`` row ids over ``rows`` rows, half of them from the first 64 rows
    (so segments run hundreds of slots long)."""
    ids = torch.randint(0, rows, (n,), generator=g, device=dev)
    hot = torch.randint(0, 64, (n,), generator=g, device=dev)
    return torch.where(torch.rand(n, generator=g, device=dev) < 0.5, hot, ids)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_row_dedup_and_update_match_the_cpu(cuda, optimizer):
    """The lazy step's de-duplication and row update at E = 1M with heavy
    duplicates: the same bits as on the CPU in fp32 (both add a segment's
    rows one by one in slot order; the update's arithmetic is elementwise
    and correctly rounded on both: its one square root is taken in fp64,
    since torch's fp32 sqrt on CUDA is not correctly rounded)."""
    from sert_tpu_torch.train import sparse
    from sert_tpu_torch.utils.config import TrainConfig
    rows, d, n = 1_000_000, 128, 36_864
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = _heavy_ids(g, n, rows, cuda)
    grads = torch.randn(n, d, generator=g, device=cuda)
    param = torch.randn(rows, d, generator=g, device=cuda)
    st = {name: torch.rand(rows, d, generator=g, device=cuda) * 1e-3
          for name in sparse._ROW_STATE[optimizer]}
    on_card = sparse._dedup_rows(ids, grads)
    on_cpu = sparse._dedup_rows(ids.cpu(), grads.cpu())
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    tcfg = TrainConfig(optimizer=optimizer)
    cpu_param, cpu_st = param.cpu(), {k: v.cpu() for k, v in st.items()}
    sparse._row_update(tcfg, param, st, *on_card, 3e-3, 5)
    sparse._row_update(tcfg, cpu_param, cpu_st, *on_cpu, 3e-3, 5)
    assert torch.equal(param.cpu(), cpu_param)
    for k in st:
        assert torch.equal(st[k].cpu(), cpu_st[k]), k


@pytest.mark.gpu
def test_lazy_steps_are_bit_equal_on_the_card(cuda):
    """Two runs of two lazy micro-steps (bf16 params, adam, K1/K2) at
    E = 1M from the same state and generator: the same bits; rows no step
    touched keep theirs."""
    from sert_tpu_torch.train.step import init_state, make_train_step
    from sert_tpu_torch.utils.config import ModelConfig, TrainConfig
    mcfg = ModelConfig(model="lse", vocab_size=50_000, num_entities=1_000_000,
                       word_dim=128, entity_dim=128, num_negatives=32768,
                       objective="sampled_softmax",
                       negative_distribution="unigram",
                       compute_dtype="bfloat16", param_dtype="bfloat16")
    tcfg = TrainConfig(batch_size=4096, optimizer="adam", sparse_update="on",
                       learning_rate=3e-3)
    g = torch.Generator(device=cuda).manual_seed(1)
    noise = 0.75 * torch.log(torch.randint(1, 50, (mcfg.num_entities,),
                                           generator=g, device=cuda).float())
    batches = [{"windows": _heavy_ids(g, 4096 * 8, mcfg.vocab_size, cuda)
                .reshape(4096, 8).int(),
                "lengths": torch.randint(4, 9, (4096,), generator=g,
                                         device=cuda).int(),
                "entities": _heavy_ids(g, 4096, mcfg.num_entities, cuda)
                .int()} for _ in range(2)]
    runs = []
    for _ in range(2):
        state = init_state(0, mcfg, tcfg, device=cuda)
        first = state.params["entity_emb"].clone()
        step = make_train_step(mcfg, tcfg, noise=noise, device=cuda)
        n = sampled_lse.fwd_launches
        for b in batches:
            state, m = step(state, b)
        assert sampled_lse.fwd_launches == n + 2
        assert torch.isfinite(m["loss"])
        runs.append(state)
    a, b = runs
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for k, v in a.opt_state.items():
        assert (torch.equal(v, b.opt_state[k]) if torch.is_tensor(v)
                else v == b.opt_state[k]), k
    touched = a.opt_state["['rows']['entity_emb']['m']"].any(dim=1)
    assert torch.equal(a.params["entity_emb"][~touched], first[~touched])


# K5/K6 against their plain version, relative to max |plain|: one bf16 step
# for the elementwise gradients; the loss and the lse are fp32 reductions of
# the same rounded operands in either dtype.
XENT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
XENT_SUM_RTOL = 1e-4
# K6's bf16 gradients where they hold exp(z - lse) terms alone, relative to
# the plain version's largest value there (chip_smoke.py's
# XENT_SOFTMAX_TOL): XENT_TOL's scale is the one-hot term, which hides them.
XENT_SOFTMAX_TOL = 4e-3


def _xent_inputs(dev, B, E, d, layout, w_dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    pooled = 0.5 * torch.randn(B, d, generator=g, device=dev)
    W = torch.randn((d, E) if layout == "de" else (E, d), generator=g,
                    device=dev) * (2.0 / d ** 0.5)
    b = 0.1 * torch.randn(E, generator=g, device=dev)
    labels = torch.randint(0, E, (B,), generator=g, device=dev)
    return pooled, W.to(w_dtype), b, labels


def _xent_run(fn, pooled, W, b, labels, layout, dtype):
    p, w, bb = (t.clone().requires_grad_(True) for t in (pooled, W, b))
    loss = fn(p, w, bb, labels, layout, dtype)
    grads = torch.autograd.grad(loss / pooled.shape[0], [p, w, bb])
    return [loss.detach(), *grads]


def _softmax_part_rel(got, want, labels, layout):
    """{output: max |got - want| / max |want|} of (dpooled, dW, db) over
    the entries with no one-hot term: dW's and db's entities that no label
    names, dpooled's rows labelled -1 (where there are any)."""
    named = torch.zeros(want[2].shape[0], dtype=torch.bool,
                        device=labels.device)
    named[labels[labels >= 0].long()] = True
    parts = {"dW": (got[1], want[1], ~named, int(layout == "de")),
             "db": (got[2], want[2], ~named, 0)}
    if bool((labels < 0).any()):
        parts["dpooled"] = (got[0], want[0], labels < 0, 0)
    rel = {}
    for name, (a, w, keep, axis) in parts.items():
        a, w = a.float().transpose(0, axis), w.float().transpose(0, axis)
        a, w = a[keep], w[keep]
        rel[name] = ((a - w).abs().max() / w.abs().max()).item()
    return rel


@pytest.mark.gpu
class TestXentOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("layout", ["de", "ed"])
    @pytest.mark.parametrize("B,E,d", [(256, 4096, 128), (100, 777, 24),
                                       (64, 130, 256), (1000, 1100, 128)])
    def test_kernels_match_plain(self, cuda, B, E, d, layout, dtype):
        x = _xent_inputs(cuda, B, E, d, layout)
        n = (xent.fwd_launches, xent.bwd_launches)
        got = _xent_run(xent.xent_loss, *x, layout, dtype)
        assert (xent.fwd_launches, xent.bwd_launches) == (n[0] + 1, n[1] + 1)
        want = _xent_run(xent.xent_loss_plain, *x, layout, dtype)
        for name, a, b in zip(("loss", "dpooled", "dW", "db"), got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            err = (a.float() - b.float()).abs().max().item()
            rtol = XENT_SUM_RTOL if name == "loss" else XENT_TOL[dtype]
            assert err <= rtol * b.abs().max().item(), name
        lse = xent.xent_lse(x[0], x[1], x[2], layout, dtype)
        want = xent.xent_lse_plain(x[0], x[1], x[2], layout, dtype)
        err = (lse - want).abs().max().item()
        assert err <= XENT_SUM_RTOL * want.abs().max().item()

    def test_bf16_weights_keep_their_dtype(self, cuda):
        x = _xent_inputs(cuda, 64, 500, 64, "ed", torch.bfloat16)
        got = _xent_run(xent.xent_loss, *x, "ed", "bfloat16")
        want = _xent_run(xent.xent_loss_plain, *x, "ed", "bfloat16")
        assert got[2].dtype == torch.bfloat16
        for i, (a, b) in enumerate(zip(got, want)):
            err = (a.float() - b.float()).abs().max().item()
            rtol = XENT_SUM_RTOL if i == 0 else XENT_TOL["bfloat16"]
            assert err <= rtol * b.float().abs().max().item()

    def test_backward_is_deterministic(self, cuda):
        x = _xent_inputs(cuda, 512, 3000, 128, "de")
        a = _xent_run(xent.xent_loss, *x, "de", "bfloat16")
        b = _xent_run(xent.xent_loss, *x, "de", "bfloat16")
        assert all(torch.equal(u, v) for u, v in zip(a, b))

    # K6's dW sweep split over the batch axis (ops.xent._dw_splits): the
    # most slices (B 4096 over 5 entity tiles), a ragged last slice (B
    # 1000), an entity tail with one slice, and cerc's shape.
    @pytest.mark.parametrize("B,E,d,layout,dtype,slices", [
        (4096, 300, 256, "de", "float32", 32),
        (1000, 1100, 128, "de", "float32", 8),
        (1000, 1100, 128, "ed", "bfloat16", 8),
        (4096, 131071, 64, "ed", "bfloat16", 1),
        (1024, 3500, 256, "de", "float32", 4)])
    def test_split_dw_sweep_matches_plain(self, cuda, B, E, d, layout, dtype,
                                          slices):
        assert xent._dw_splits(B, E)[1] == slices
        x = _xent_inputs(cuda, B, E, d, layout)
        got = _xent_run(xent.xent_loss, *x, layout, dtype)
        want = _xent_run(xent.xent_loss_plain, *x, layout, dtype)
        for name, a, b in zip(("loss", "dpooled", "dW", "db"), got, want):
            err = (a.float() - b.float()).abs().max().item()
            rtol = XENT_SUM_RTOL if name == "loss" else XENT_TOL[dtype]
            assert err <= rtol * b.abs().max().item(), name

    @pytest.mark.parametrize("B,E,d", [(1024, 3500, 256), (4096, 300, 128)])
    def test_backward_is_bit_equal_with_split(self, cuda, B, E, d):
        x = _xent_inputs(cuda, B, E, d, "de")
        a = _xent_run(xent.xent_loss, *x, "de", "float32")
        b = _xent_run(xent.xent_loss, *x, "de", "float32")
        assert all(torch.equal(u, v) for u, v in zip(a, b))

    # K5 alone: at its most chunks (one entity tile a chunk, the last one
    # entity wide), at the log-linear normalizer's 64 x 16 query rows, and
    # at d = 24 in bf16, whose P is zero-padded to the sweep's 64.
    @pytest.mark.parametrize("B,E,d,layout,dtype,chunks", [
        (64, 16001, 128, "ed", "float32", 251),
        (1024, 3500, 256, "de", "float32", 14),
        (100, 777, 24, "de", "bfloat16", 13),
        (100, 777, 24, "ed", "bfloat16", 13)])
    def test_forward_matches_plain(self, cuda, B, E, d, layout, dtype,
                                   chunks):
        assert xent._dp_chunks(B, E)[1] == chunks
        pooled, W, b, _ = _xent_inputs(cuda, B, E, d, layout)
        n = xent.fwd_launches
        got = xent.xent_lse(pooled, W, b, layout, dtype)
        assert xent.fwd_launches == n + 1
        want = xent.xent_lse_plain(pooled, W, b, layout, dtype)
        assert got.shape == want.shape == (B,)
        err = (got - want).abs().max().item()
        assert err <= XENT_SUM_RTOL * want.abs().max().item()

    # The bf16 route (csrc/xent_wgmma.cu) at full width: the log-linear
    # A/B's "de" (E 500k, d 256), d 256 in "ed", lse_full's 128k; every
    # launch on the wgmma sweep, two backward calls bit for bit.
    @pytest.mark.parametrize("B,E,d,layout", [(1024, 500_000, 256, "de"),
                                              (4096, 131072, 256, "ed"),
                                              (4096, 131072, 128, "ed")])
    def test_wgmma_route_at_full_width(self, cuda, B, E, d, layout):
        x = _xent_inputs(cuda, B, E, d, layout, seed=5)
        n = (xent.fwd_wgmma_launches, xent.bwd_wgmma_launches)
        got = _xent_run(xent.xent_loss, *x, layout, "bfloat16")
        again = _xent_run(xent.xent_loss, *x, layout, "bfloat16")
        assert (xent.fwd_wgmma_launches, xent.bwd_wgmma_launches) == (
            n[0] + 2, n[1] + 2)
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        want = _xent_run(xent.xent_loss_plain, *x, layout, "bfloat16")
        for name, a, b in zip(("loss", "dpooled", "dW", "db"), got, want):
            err = (a.float() - b.float()).abs().max().item()
            rtol = XENT_SUM_RTOL if name == "loss" else XENT_TOL["bfloat16"]
            assert err <= rtol * b.abs().max().item(), name
        rel = _softmax_part_rel(got[1:], want[1:], x[3], layout)
        assert max(rel.values()) <= XENT_SOFTMAX_TOL, rel

    # K6's bf16 route fed an lse from outside, a ragged B, labels of -1 and
    # the entity tail, with W stored in fp32 (cast once) and in bf16.
    @pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("layout", ["ed", "de"])
    def test_wgmma_k6_ragged_with_off_shard_labels(self, cuda, layout,
                                                   w_dtype):
        B, E, d = 1000, 131071, 128
        pooled, W, b, labels = _xent_inputs(cuda, B, E, d, layout, w_dtype,
                                            seed=6)
        lse = xent.xent_lse_plain(pooled, W, b, layout, "bfloat16") + 0.7
        labels = torch.where(torch.arange(B, device=cuda) % 3 == 0,
                             torch.full_like(labels, -1), labels)
        n = xent.bwd_wgmma_launches
        got = xent.xent_bwd(pooled, W, b, lse, labels, layout, "bfloat16")
        assert xent.bwd_wgmma_launches == n + 1
        want = xent.xent_bwd_plain(pooled, W, b, lse, labels, layout,
                                   "bfloat16")
        for name, a, w in zip(("dpooled", "dW", "db"), got, want):
            assert a.shape == w.shape, name
            err = (a - w).abs().max().item()
            assert err <= XENT_TOL["bfloat16"] * w.abs().max().item(), name
        rel = _softmax_part_rel(got, want, labels, layout)
        assert max(rel.values()) <= XENT_SOFTMAX_TOL, rel
        # The control: lse + 0.01 scales every exp(z - lse) by e^-0.01,
        # which XENT_SOFTMAX_TOL sees on each output.
        bad = xent.xent_bwd(pooled, W, b, lse + 0.01, labels, layout,
                            "bfloat16")
        rel = _softmax_part_rel(bad, want, labels, layout)
        assert len(rel) == 3 and min(rel.values()) > XENT_SOFTMAX_TOL, rel

    def test_k6_as_the_autograd_threads_first_cuda_work(self, cuda):
        """K6 launched from a fresh autograd worker whose first CUDA work
        it is, its buffers taken from the allocator's cache (a plain loss
        was built before): the tensor maps' encoder needs the thread's
        context bound first. A process of its own, so that the worker is
        fresh."""
        import subprocess
        import sys
        from pathlib import Path
        code = (
            "import torch\n"
            "from sert_tpu_torch.ops import xent\n"
            "g = torch.Generator(device='cuda').manual_seed(0)\n"
            "B, E, d = 4096, 131072, 128\n"
            "x = (0.5 * torch.randn(B, d, generator=g, device='cuda'),\n"
            "     torch.randn(E, d, generator=g, device='cuda') * 0.1,\n"
            "     0.1 * torch.randn(E, generator=g, device='cuda'))\n"
            "y = torch.randint(0, E, (B,), generator=g, device='cuda')\n"
            "p, w, b = (t.clone().requires_grad_(True) for t in x)\n"
            "loss = xent.xent_loss(p, w, b, y, 'ed', 'bfloat16')\n"
            "plain = xent.xent_loss_plain(*(t.clone().requires_grad_(True)\n"
            "                               for t in x), y, 'ed', 'bfloat16')\n"
            "torch.autograd.grad(loss, [p, w, b])\n"
            "torch.cuda.synchronize()\n"
            "print('ok')\n")
        proc = subprocess.run([sys.executable, "-c", code],
                              cwd=Path(__file__).resolve().parents[1],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr

    def test_wrapper_refuses_what_the_kernels_do_not_take(self, cuda):
        pooled, W, b, labels = _xent_inputs(cuda, 8, 16, 16, "ed")
        with pytest.raises(ValueError, match="d <= 256"):
            xent.xent_loss(torch.zeros(8, 300, device=cuda),
                           torch.zeros(16, 300, device=cuda), b, labels,
                           "ed")
        with pytest.raises(ValueError, match="on cpu"):
            xent.xent_loss(pooled, W, b.cpu(), labels, "ed")
        with pytest.raises(ValueError, match="contiguous"):
            xent.xent_loss(pooled, W.T.contiguous().T, b, labels, "ed")


# K7 against its plain version, from seeded non-zero moments with count 3:
# the loss and gsq (fp32 sums) as K5's loss; db, dpooled and the slots as
# K6's gradients, relative to max |plain|; W' relative to lr (the update is
# lr-sized). bf16 storage: each stored value may also round one bf16 step
# (at most 2^-7 of the value) apart.
APPLY_LR = 1e-2


@pytest.mark.gpu
class TestShardedOnCard:
    """The kernels as a mesh rank runs them: K6 fed an lse from outside
    and labels of -1 off the shard, and K3/K4 on a row block whose ids are
    offset into the global range."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("layout", ["de", "ed"])
    @pytest.mark.parametrize("B,E,d", [(1024, 875, 256), (256, 4096, 128)])
    def test_k6_with_outside_lse_and_off_shard_labels(self, cuda, B, E, d,
                                                      layout, dtype):
        pooled, W, b, labels = _xent_inputs(cuda, B, E, d, layout, seed=3)
        # a global lse larger than the block's (the other blocks' mass),
        # and a third of the rows' gold entities on other blocks
        lse = xent.xent_lse_plain(pooled, W, b, layout, dtype) + 0.7
        labels = torch.where(torch.arange(B, device=cuda) % 3 == 0,
                             torch.full_like(labels, -1), labels)
        n = xent.bwd_launches
        got = xent.xent_bwd(pooled, W, b, lse, labels, layout, dtype)
        assert xent.bwd_launches == n + 1
        want = xent.xent_bwd_plain(pooled, W, b, lse, labels, layout, dtype)
        for name, a, w in zip(("dpooled", "dW", "db"), got, want):
            assert a.shape == w.shape, name
            err = (a - w).abs().max().item()
            assert err <= XENT_TOL[dtype] * w.abs().max().item(), name

    def test_sharded_loss_on_one_rank_is_the_loss(self, cuda):
        """At one rank the sharded loss's stitch is the identity: K5/K6
        give xent_loss's value and gradients bit for bit."""
        x = _xent_inputs(cuda, 1024, 875, 256, "de", seed=4)
        want = _xent_run(xent.xent_loss, *x, "de", "float32")

        def sharded(p, w, bb, lab, layout, dtype):
            return xent.sharded_xent_loss(p, w, bb, lab, xent.ONE_BLOCK,
                                          layout, dtype)
        got = _xent_run(sharded, *x, "de", "float32")
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    def test_sharded_losses_at_tp_above_one_on_a_gloo_world(self, cuda):
        """The stitch at tp > 1 through the kernels: four gloo ranks share
        the card (NCCL takes one rank per card) and run the sharded xent
        loss (K5, then K6 fed the stitched lse, labels of -1 off the
        block) and the mesh's model losses (K5/K6 per entity block, K1/K2
        per candidate block, K1/K2 on the whole block where tp does not
        divide k); each is held against the same loss on one card, and
        every rank must have launched its kernels."""
        from sert_tpu_torch.parallel.dryrun import check_card_world
        report = check_card_world(4)
        assert report["ok"], report

    @pytest.mark.parametrize("blocks", [2, 8])
    def test_k3_k4_per_block_with_offset(self, cuda, blocks):
        """Each block's K3/K4 top k, offset and merged by the top k of the
        concatenation, is the whole matrix's kernel engine answer."""
        R, M, _, _ = _data(5, Q=64, E=40_000, d=128)
        Rt, Mt = torch.from_numpy(R).to(cuda), torch.from_numpy(M).to(cuda)
        want_s, want_i = exact_topk.exact_topk(Rt, Mt, k=100)
        rows = M.shape[0] // blocks
        parts_s, parts_i = [], []
        n3 = score_binmax.launches
        for m in range(blocks):
            s, i = exact_topk.exact_topk(Rt, Mt[m * rows:(m + 1) * rows],
                                         k=100)
            parts_s.append(s)
            parts_i.append(i + m * rows)
        assert score_binmax.launches == n3 + blocks
        s, sel = torch.sort(torch.cat(parts_s, 1), dim=1, descending=True,
                            stable=True)
        i = torch.gather(torch.cat(parts_i, 1), 1, sel[:, :100])
        assert torch.equal(i, want_i)
        torch.testing.assert_close(s[:, :100], want_s, **TOL)


def _apply_inputs(dev, B, E, d, layout, opt, w_dtype=torch.float32):
    pooled, W, b, labels = _xent_inputs(dev, B, E, d, layout)
    g = torch.Generator(device=dev).manual_seed(1)
    slots = {"m": 1e-3 * torch.randn(W.shape, generator=g, device=dev),
             "v": 1e-5 * (0.5 + torch.randn(W.shape, generator=g,
                                            device=dev).abs()),
             "acc": 1e-5 * (0.5 + torch.randn(W.shape, generator=g,
                                              device=dev).abs())}
    tree = {k: slots[k].to(w_dtype) for k in xent.SLOTS[opt]}
    return pooled, W.to(w_dtype), b, labels, tree


def _apply_run(fn, x, opt, layout, dtype):
    pooled, W, b, labels, tree = x
    W, tree = W.clone(), {k: v.clone() for k, v in tree.items()}
    out = fn(pooled, W, b, labels, opt=opt, opt_tree=tree, lr=APPLY_LR,
             count=3, gscale=1.0 / pooled.shape[0], layout=layout,
             dtype=dtype)
    return {"loss": out[0], "gsq": out[5], "db": out[3], "dpooled": out[4],
            "W": W, **tree}


def _check_apply(got, want, dtype):
    for name, b in want.items():
        a = got[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all()), name
        if name in ("loss", "gsq"):
            limit = XENT_SUM_RTOL * b.abs().max()
        elif name == "W":
            limit = XENT_TOL[dtype] * APPLY_LR
        else:
            limit = XENT_TOL[dtype] * b.abs().max()
        if want[name].dtype == torch.bfloat16:
            limit = limit + 2.0 ** -7 * b.abs()
        assert bool(((a - b).abs() <= limit).all()), (
            name, (a - b).abs().max().item())


def _k7_softmax_rel(got, want, x, opt, layout):
    """{output: max |got - want| / max |want|} of K7's softmax part, as
    _softmax_part_rel takes K6's: db on the entities no label names and,
    for adam on fp32 slots, the gradient G = (m' - 0.9 m) / 0.1 read back
    from the first moment there."""
    labels, tree = x[3], x[4]
    named = torch.zeros(want["db"].shape[0], dtype=torch.bool,
                        device=labels.device)
    named[labels.long()] = True
    parts = {"db": (got["db"], want["db"], 0)}
    if opt == "adam" and tree["m"].dtype == torch.float32:
        parts["G"] = ((got["m"] - 0.9 * tree["m"]) / 0.1,
                      (want["m"] - 0.9 * tree["m"]) / 0.1,
                      int(layout == "de"))
    rel = {}
    for name, (a, w, axis) in parts.items():
        a = a.float().transpose(0, axis)[~named]
        w = w.float().transpose(0, axis)[~named]
        rel[name] = ((a - w).abs().max() / w.abs().max()).item()
    return rel


@pytest.mark.gpu
class TestXentApplyOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("layout", ["de", "ed"])
    @pytest.mark.parametrize("opt", ["adam", "adagrad", "sgd"])
    @pytest.mark.parametrize("B,E,d", [(256, 4096, 128), (100, 777, 24),
                                       (64, 130, 256), (1000, 1100, 128)])
    def test_kernel_matches_plain(self, cuda, B, E, d, opt, layout, dtype):
        x = _apply_inputs(cuda, B, E, d, layout, opt)
        n = (xent.fwd_launches, xent.bwd_launches, xent.apply_launches)
        got = _apply_run(xent.xent_loss_apply, x, opt, layout, dtype)
        assert (xent.fwd_launches, xent.bwd_launches,
                xent.apply_launches) == (n[0] + 1, n[1], n[2] + 1)
        want = _apply_run(xent.xent_loss_apply_plain, x, opt, layout, dtype)
        _check_apply(got, want, dtype)

    @pytest.mark.parametrize("opt", ["adam", "adagrad"])
    def test_bf16_storage(self, cuda, opt):
        x = _apply_inputs(cuda, 256, 3001, 128, "ed", opt, torch.bfloat16)
        got = _apply_run(xent.xent_loss_apply, x, opt, "ed", "bfloat16")
        want = _apply_run(xent.xent_loss_apply_plain, x, opt, "ed",
                          "bfloat16")
        assert got["W"].dtype == torch.bfloat16
        _check_apply(got, want, "bfloat16")

    def test_is_deterministic(self, cuda):
        x = _apply_inputs(cuda, 512, 3000, 128, "de", "adam")
        a = _apply_run(xent.xent_loss_apply, x, "adam", "de", "bfloat16")
        b = _apply_run(xent.xent_loss_apply, x, "adam", "de", "bfloat16")
        assert all(torch.equal(a[k], b[k]) for k in a)

    # The update sweep split over the batch (ops.xent._dw_splits: S > 1,
    # the update in the ordered sum of the slices) and whole (S = 1, the
    # update in the sweep's epilogue, here with a one-entity tail tile).
    @pytest.mark.parametrize("opt", ["adam", "adagrad", "sgd"])
    @pytest.mark.parametrize("B,E,d,layout,dtype,slices", [
        (1024, 1100, 128, "de", "float32", 8),
        (1024, 1100, 128, "ed", "bfloat16", 8),
        (1024, 3500, 256, "de", "float32", 4),
        (4096, 131071, 128, "ed", "bfloat16", 1)])
    def test_slices_match_plain(self, cuda, B, E, d, layout, dtype, slices,
                                opt):
        # bf16 K7 runs the wgmma sweep's dW plan, fp32 the mma.sync one's.
        assert (xent._wgmma_plan(B, E, d)[1].parts if dtype == "bfloat16"
                else xent._dw_splits(B, E)[1]) == slices
        x = _apply_inputs(cuda, B, E, d, layout, opt)
        got = _apply_run(xent.xent_loss_apply, x, opt, layout, dtype)
        want = _apply_run(xent.xent_loss_apply_plain, x, opt, layout, dtype)
        _check_apply(got, want, dtype)

    @pytest.mark.parametrize("B,E,d,layout,dtype", [
        (1024, 3500, 256, "de", "float32"),       # 4 slices
        (4096, 131071, 128, "ed", "bfloat16"),    # one slice
        (1024, 3500, 256, "de", "bfloat16"),      # 4 slices of the wgmma plan
        (256, 20_000, 128, "de", "bfloat16")])    # its one slice
    def test_two_calls_are_bit_equal(self, cuda, B, E, d, layout, dtype):
        x = _apply_inputs(cuda, B, E, d, layout, "adam")
        a = _apply_run(xent.xent_loss_apply, x, "adam", layout, dtype)
        b = _apply_run(xent.xent_loss_apply, x, "adam", layout, dtype)
        assert set(a) == {"loss", "gsq", "db", "dpooled", "W", "m", "v"}
        assert all(torch.equal(a[k], b[k]) for k in a)

    # K7 in bf16 compute: the wgmma sweep's DP mode, then its APPLY mode,
    # the update in the epilogue (one slice) or in the ordered sum of the
    # slices (S > 1: cerc's shape in bf16, and 8), fp32 and bf16 storage.
    @pytest.mark.parametrize("opt", ["adam", "adagrad", "sgd"])
    @pytest.mark.parametrize("B,E,d,layout,w_dtype,slices", [
        (1024, 3500, 256, "de", torch.float32, 4),
        (1024, 3500, 256, "ed", torch.float32, 4),
        (256, 20_000, 128, "de", torch.float32, 1),
        (256, 20_001, 64, "ed", torch.float32, 1),
        (1000, 1100, 128, "ed", torch.bfloat16, 8),
        (256, 20_000, 128, "de", torch.bfloat16, 1)])
    def test_bf16_on_the_wgmma_sweep_matches_plain(self, cuda, B, E, d,
                                                   layout, w_dtype, slices,
                                                   opt):
        assert xent._wgmma_plan(B, E, d)[1].parts == slices
        x = _apply_inputs(cuda, B, E, d, layout, opt, w_dtype)
        n = (xent.apply_launches, xent.apply_wgmma_launches)
        got = _apply_run(xent.xent_loss_apply, x, opt, layout, "bfloat16")
        assert (xent.apply_launches, xent.apply_wgmma_launches) == (
            n[0] + 1, n[1] + 1)
        want = _apply_run(xent.xent_loss_apply_plain, x, opt, layout,
                          "bfloat16")
        _check_apply(got, want, "bfloat16")
        for name, rel in _k7_softmax_rel(got, want, x, opt, layout).items():
            assert rel <= XENT_SOFTMAX_TOL, (name, rel)

    # One dW: K7's sgd update is W - lr (K6's dW at g = gscale), in
    # _update_plain's order, bit for bit, from the epilogue (one slice) and
    # from the sum of the slices (4), in both layouts.
    @pytest.mark.parametrize("layout", ["de", "ed"])
    @pytest.mark.parametrize("B,E,d", [(1024, 3500, 256), (256, 20_000, 128)])
    def test_bf16_sgd_update_is_k6_dw_bit_for_bit(self, cuda, B, E, d,
                                                  layout):
        pooled, W, b, labels, _ = _apply_inputs(cuda, B, E, d, layout, "sgd")
        gscale = 1.0 / B
        _, saved, geometry = xent._loss_forward(pooled, W, b, labels, layout,
                                                torch.bfloat16)
        g = torch.full((1,), gscale, device=cuda)
        dW = xent._bwd(saved, geometry, g, torch.bfloat16)[1]
        want = W.clone()
        xent._update_plain(want, [], dW, "sgd", APPLY_LR, 0, 1.0)
        got = W.clone()
        xent.xent_loss_apply(pooled, got, b, labels, opt="sgd", opt_tree={},
                             lr=APPLY_LR, count=0, gscale=gscale,
                             layout=layout, dtype="bfloat16")
        assert torch.equal(got, want)

    def test_fused_step_launches_k5_and_k7_only(self, cuda):
        from sert_tpu_torch.train.step import init_state, make_train_step
        from sert_tpu_torch.utils.config import ModelConfig, TrainConfig
        B, E, n = 256, 1100, 3
        mcfg = ModelConfig(model="loglinear", vocab_size=500, num_entities=E,
                           word_dim=128, entity_dim=128, fused_softmax="on")
        tcfg = TrainConfig(optimizer="adam", batch_size=B,
                           learning_rate=1e-3, fused_update="on")
        state = init_state(0, mcfg, tcfg, device="cuda")
        step = make_train_step(mcfg, tcfg, device="cuda")
        g = torch.Generator(device=cuda).manual_seed(0)
        before = (xent.fwd_launches, xent.bwd_launches, xent.apply_launches)
        for _ in range(n):
            batch = {"windows": torch.randint(1, 500, (B, 8), generator=g,
                                              device=cuda).int(),
                     "lengths": torch.full((B,), 8, dtype=torch.int32,
                                           device=cuda),
                     "entities": torch.randint(0, E, (B,), generator=g,
                                               device=cuda).int()}
            state, m = step(state, batch)
        assert torch.isfinite(m["loss"]).item()
        assert (xent.fwd_launches, xent.bwd_launches,
                xent.apply_launches) == (before[0] + n, before[1],
                                         before[2] + n)

    def test_wrapper_refuses_what_the_kernel_does_not_take(self, cuda):
        pooled, W, b, labels, tree = _apply_inputs(cuda, 8, 16, 16, "ed",
                                                   "adam")
        kw = dict(opt="adam", lr=APPLY_LR, count=0, gscale=1.0, layout="ed")
        with pytest.raises(ValueError, match="dtype"):
            xent.xent_loss_apply(pooled, W, b, labels, opt_tree={
                "m": tree["m"], "v": tree["v"].bfloat16()}, **kw)
        with pytest.raises(ValueError, match="device"):
            xent.xent_loss_apply(pooled, W, b, labels, opt_tree={
                "m": tree["m"], "v": tree["v"].cpu()}, **kw)
        with pytest.raises(ValueError, match="d <= 256"):
            big = torch.zeros(16, 300, device=cuda)
            xent.xent_loss_apply(torch.zeros(8, 300, device=cuda), big, b,
                                 labels, opt_tree={"m": big.clone(),
                                                   "v": big.clone()}, **kw)


# --- the packed feed's unpack, adafactor and the debug guards on the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("V,E,lead,w", [(250_000, 1_000_000, (), 8),
                                        (250_000, 1_000_000, (4,), 8),
                                        (65_537, 1 << 24, (), 5),
                                        (100, 65_536, (2,), 7)])
def test_unpack_batch_on_card_is_exact(cuda, V, E, lead, w):
    """The packed planes (uint16 and uint8) cross to the card and unpack
    there to the raw int32 ids, bit for bit, as they do on the CPU."""
    from sert_tpu_torch.data import wirepack
    rng = np.random.default_rng(V + E)
    raw = {"windows": rng.integers(0, V, size=lead + (64, w)),
           "lengths": rng.integers(1, w + 1, size=lead + (64,)),
           "entities": rng.integers(0, E, size=lead + (64,))}
    raw = {k: v.astype(np.int32) for k, v in raw.items()}
    raw["windows"].reshape(-1, w)[0] = V - 1
    raw["entities"].reshape(-1)[0] = E - 1
    packed = wirepack.pack_batch(raw, V, E)
    got = wirepack.unpack_batch({k: torch.from_numpy(v).to(cuda)
                                 for k, v in packed.items()}, V, E)
    for k, v in raw.items():
        assert got[k].device.type == "cuda" and got[k].dtype == torch.int32
        assert np.array_equal(got[k].cpu().numpy(), v), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adafactor_on_card_matches_the_cpu(cuda, dtype):
    """Eight adafactor updates of factored ([128, 300], [300, 128]) and
    unfactored ([300], [40, 128]) leaves on the card against the CPU from
    the same params and gradients: fp32 within reassociation (rtol 1e-5,
    atol 2e-3 x lr), bf16 within the bf16 class (2e-2)."""
    from sert_tpu_torch.train.step import make_optimizer
    from sert_tpu_torch.utils.config import TrainConfig
    lr = 1e-2
    cfg = TrainConfig(optimizer="adafactor", learning_rate=lr)
    rng = np.random.default_rng(0)
    shapes = {"w": (128, 300), "t": (300, 128), "b": (300,), "e": (40, 128)}
    host = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(dtype) for k, s in shapes.items()}
    card = {k: v.to(cuda) for k, v in host.items()}
    opt_h, opt_c = make_optimizer(cfg), make_optimizer(cfg)
    st_h, st_c = opt_h.init(host), opt_c.init(card)
    for i in range(8):
        g = {k: torch.from_numpy((rng.normal(size=s) * (1 + i)).astype(
            np.float32)).to(dtype) for k, s in shapes.items()}
        opt_h.update(host, g, st_h)
        opt_c.update(card, {k: v.to(cuda) for k, v in g.items()}, st_c)
    fp32 = dtype == torch.float32
    tol = dict(rtol=1e-5, atol=2e-3 * lr) if fp32 else dict(rtol=2e-2,
                                                            atol=2e-2)
    for k in shapes:
        torch.testing.assert_close(card[k].cpu(), host[k], **tol)
    for k, v in st_h.items():
        if torch.is_tensor(v):
            torch.testing.assert_close(st_c[k].cpu(), v,
                                       rtol=1e-4 if fp32 else 2e-2,
                                       atol=1e-12 if fp32 else 2e-2)
        else:
            assert st_c[k] == v


@pytest.mark.gpu
def test_checked_names_the_kernel_that_made_a_nan(cuda):
    """K4 writes NaN scores for an out-of-range bin (by design; the plain
    version raises): under debug.checked its wrapper names it."""
    from sert_tpu_torch.utils import debug
    R, M, _, _ = _data(0, 4, 1024, 64)
    Mb = torch.from_numpy(M).to(cuda).reshape(8, 128, 64).contiguous()
    ok = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    f = debug.checked(lambda idx: gather_rescore.gather_rescore(
        torch.from_numpy(R).to(cuda), Mb, idx))
    err, _ = f(ok)
    assert err.get() is None
    err, out = f(ok + 99)
    assert torch.isnan(out).all()
    assert err.get() == "nan generated by kernel gather_rescore"
