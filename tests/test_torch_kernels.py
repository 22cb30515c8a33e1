"""The port's CUDA kernels (K3 score_binmax, K4 gather_rescore) against
their plain PyTorch versions, and the build that binds them.

Imports nothing of JAX, so it runs on a host without it. The ``gpu`` tests
skip without a CUDA device; on the card run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX for the reference's tests).

Tolerances: the kernel and its plain version multiply the same
bf16-rounded (K3) or fp32 (K4) inputs and sum in fp32 in another order
(rtol 1e-5, atol 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu_torch.ops import _build, exact_topk  # noqa: E402
from sert_tpu_torch.ops import gather_rescore, score_binmax  # noqa: E402

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
            "score_binmax.cu", "gather_rescore.cu"}

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

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, cuda):
        R = torch.randn(4, 24, device=cuda)                 # d % 16 != 0
        Mp = torch.randn(100, 24, device=cuda).bfloat16()
        with pytest.raises(ValueError, match="d % 16"):
            score_binmax.score_binmax_prepared(R, Mp, 100)
        with pytest.raises(ValueError, match="bf16 Mp"):
            score_binmax.score_binmax_prepared(R, Mp.float(), 100)
        Mb = torch.randn(3, 128, 24, device=cuda)
        idx = torch.zeros(4, 2, dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError, match="int32"):
            gather_rescore.gather_rescore(R, Mb, idx)

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
