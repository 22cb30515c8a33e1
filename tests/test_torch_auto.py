"""The port's "auto" switches against the kernels' own limits, and the shape
plans of the sweeps of K5, K6 and K7 (with what each launch is given), on
the CPU.

"auto" takes a kernel on a CUDA device only where the kernel takes the
shapes, decided from the shapes before any launch; past them it takes the
plain version (the reference trains and serves such models through its XLA
composition, ``sert_tpu/models/loglinear.py:55-68``,
``sert_tpu/models/lse.py:129-136``), while "on" still reaches the kernel's
wrapper, which raises. None of this needs a card: the decisions read a
``torch.device`` object only. The plain path past the limit is held to the
reference's Pallas kernel in interpret mode, with test_torch_xent.py's
tolerances.
"""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.ops.xent import xent_loss as ref_xent_loss  # noqa: E402
from sert_tpu_torch.models.common import use_fused  # noqa: E402
from sert_tpu_torch.ops import _build, xent  # noqa: E402
from sert_tpu_torch.scoring.run import resolve_engine  # noqa: E402
from sert_tpu_torch.scoring.scorer import normalizer_engine  # noqa: E402
from sert_tpu_torch.utils.config import ModelConfig, ScoreConfig  # noqa: E402

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _cfg(model, dim, fused="auto"):
    return ModelConfig(model=model, objective="sampled_softmax",
                       num_entities=3500, word_dim=dim, entity_dim=dim,
                       num_negatives=1024, fused_softmax=fused)


@pytest.mark.parametrize("model", ["loglinear", "lse_full", "lse"])
def test_auto_takes_the_kernels_only_within_their_width(model):
    assert use_fused(_cfg(model, 256), CUDA, rows=1024)
    assert not use_fused(_cfg(model, 384), CUDA, rows=1024)
    assert not use_fused(_cfg(model, 256), CPU, rows=1024)
    assert use_fused(_cfg(model, 384, "on"), CUDA)
    assert use_fused(_cfg(model, 384, "on"), CPU)
    assert not use_fused(_cfg(model, 256, "off"), CUDA)


def test_auto_reads_the_width_of_each_family():
    # log-linear multiplies at word_dim, the LSE families at entity_dim.
    wide_words = ModelConfig(model="loglinear", num_entities=3500,
                             word_dim=384, entity_dim=64)
    wide_ents = ModelConfig(model="lse_full", num_entities=3500,
                            word_dim=64, entity_dim=384)
    assert not use_fused(wide_words, CUDA, rows=64)
    assert not use_fused(wide_ents, CUDA, rows=64)
    assert use_fused(ModelConfig(model="lse_full", num_entities=3500,
                                 word_dim=384, entity_dim=64), CUDA, rows=64)


def test_auto_refuses_shapes_the_kernels_refuse_besides_width():
    assert not use_fused(_cfg("loglinear", 128), CUDA, rows=0)
    assert not use_fused(_cfg("lse", 128).replace(num_negatives=0), CUDA)


@pytest.mark.parametrize("dim,want", [(640, "scan"), (384, "scan"),
                                      (256, "fused")])
def test_normalizer_auto_follows_k5s_limits(dim, want):
    assert normalizer_engine(CUDA, 64 * 16, 3500, dim) == want
    assert normalizer_engine(CPU, 64 * 16, 3500, dim) == "scan"


@pytest.mark.parametrize("dim,want", [(640, "dense"), (512, "pallas"),
                                      (500, "pallas"), (128, "pallas")])
def test_scoring_auto_follows_k3s_limit(dim, want):
    sc = ScoreConfig(entity_chunk=100)
    assert resolve_engine(sc, 50, CUDA, dim) == want
    assert resolve_engine(sc, 50, CPU, dim) == "dense"
    assert resolve_engine(sc, 500, CPU, dim) == "streaming"
    assert resolve_engine(sc, 500, CUDA, dim) == (
        "streaming" if want == "dense" else "pallas")
    assert resolve_engine(ScoreConfig(engine="pallas"), 50, CUDA,
                          640) == "pallas"


@pytest.mark.parametrize("B,E", [(1024, 3500), (1000, 1100), (4096, 300),
                                 (64, 130), (4096, 131071), (1024, 500_000),
                                 (4096, 1_000_000), (65, 64)])
def test_dw_splits_cover_every_batch_tile_once(B, E):
    per, slices = xent._dw_splits(B, E)
    n_btiles = -(-B // 64)
    covered = [bt for s in range(slices)
               for bt in range(s * per, min((s + 1) * per, n_btiles))]
    assert covered == list(range(n_btiles))
    assert all(s * per < n_btiles for s in range(slices))   # none empty
    assert xent._dw_splits(B, E) == (per, slices)


def test_k6_plans_fill_one_round_and_stop_splitting_when_tiles_do():
    # At most K6_BLOCKS (two blocks an SM) a sweep, as many as fit.
    assert xent._dw_splits(1024, 3500) == (4, 4)       # cerc: 220 blocks
    assert xent._dw_splits(1024, 1100) == (2, 8)       # w3c: 144 blocks
    assert xent._dw_splits(4096, 300) == (2, 32)       # the most slices
    for E in (131_072, 500_000, 1_000_000):
        assert xent._dw_splits(4096, E)[1] == 1        # dW written directly
    assert xent._dp_chunks(1024, 3500) == (4, 14)      # 224 blocks
    assert xent._dp_chunks(4096, 1_000_000) == (3907, 4)
    # The dpooled blocks flush their sums every DP_MAX_TILES of these.
    assert xent._dp_chunks(1024, 500_000) == (489, 16)
    for B, E in ((1024, 3500), (1000, 1100), (4096, 300), (4096, 131071)):
        for plan, fixed in ((xent._dw_splits, -(-E // 64)),
                            (xent._dp_chunks, -(-B // 64))):
            assert fixed * plan(B, E)[1] <= max(fixed, xent.K6_BLOCKS)


@pytest.mark.parametrize("B,E", [(1024, 3500), (1000, 1100), (4096, 300),
                                 (4096, 131071), (64, 130), (1024, 500_000),
                                 (1024, 125_000)])
def test_dp_chunks_cover_every_entity_tile_once(B, E):
    per, chunks = xent._dp_chunks(B, E)
    n_etiles = -(-E // 64)
    covered = [t for c in range(chunks)
               for t in range(c * per, min((c + 1) * per, n_etiles))]
    assert covered == list(range(n_etiles))
    assert all(c * per < n_etiles for c in range(chunks))


# chip_smoke.py's K5 / K7 shapes (B, E, d) and the dW sweep's slices there.
SMOKE_SHAPES = {"w3c": (1024, 1100, 128, 8),
                "w3c_ragged": (1000, 1100, 128, 8),
                "cerc": (1024, 3500, 256, 4),
                "ll_500k": (1024, 500_000, 256, 1),
                "lse_full_128k": (4096, 131072, 128, 1),
                "lse_full_tail": (4096, 131071, 128, 1),
                "lse_full_1m": (4096, 1_000_000, 128, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SMOKE_SHAPES))
def test_dw_scratch_holds_the_slices_partials_or_nothing(name, dtype):
    B, E, d, slices = SMOKE_SHAPES[name]
    dp = xent._sweep_width(d, dtype)
    assert dp == d                    # the smoke's widths need no padding
    assert xent._dw_splits(B, E)[1] == slices
    n = xent._dw_scratch_numel(B, E, dp)
    if slices > 1:
        assert n == slices * -(-E // 64) * 64 * (dp + 1)
    else:
        assert n == 0 and xent._backward_sweeps(B, E, dp, CPU)[3] is None


@pytest.mark.parametrize("d,dtype,dp", [(24, torch.float32, 32),
                                        (24, torch.bfloat16, 64),
                                        (96, torch.bfloat16, 128),
                                        (256, torch.bfloat16, 256)])
def test_sweep_width_is_whole_128_byte_chunks(d, dtype, dp):
    assert xent._sweep_width(d, dtype) == dp
    assert dp * torch.finfo(dtype).bits // 8 % 128 == 0


@pytest.fixture
def launches(monkeypatch):
    """The kernels' entry points replaced by recorders that check the
    argument count against the C signature: [(name, args)] of each call.
    What the launches are given is a function of the shapes alone, so it
    is checked here, on CPU tensors, without a card."""
    calls = []

    def kernel(name):
        def launch(*args):
            assert len(args) == len(_build._SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "check", lambda err, what: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


# (B, E, d, layout, dtype): the dW sweep split (8 slices) and whole (one
# slice, a one-entity tail tile), bf16 widths padded to 64.
WIRING = [(1000, 1100, 24, "de", "float32"), (300, 9001, 40, "ed", "bfloat16"),
          (64, 130, 96, "de", "bfloat16"), (1024, 3500, 256, "de", "float32")]


@pytest.mark.parametrize("B,E,d,layout,dtype", WIRING)
def test_each_sweep_takes_its_plan(launches, B, E, d, layout, dtype):
    """K5's grid is _dp_chunks; K6's and K7's dpooled sweeps the same plan,
    their dW sweeps _dw_splits with scratch only where S > 1; every launch
    reads the one P padded in the forward; at most one round of
    K6_BLOCKS a sweep. bf16 compute sends K5, K6 and K7 (its dpooled
    sweep, then its update on the dW sweep's plan) to the wgmma sweep's
    entry points (their plan: tests/test_torch_xent_wgmma.py)."""
    rng = np.random.default_rng(0)
    ct = xent._compute_dtype(dtype)
    pooled = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(d, E) if layout == "de"
                                    else (E, d)).astype(np.float32))
    b = torch.zeros(E)
    labels = torch.from_numpy(rng.integers(0, E, size=B))
    per, chunks = xent._dp_chunks(B, E)
    bper, slices = xent._dw_splits(B, E)
    n_bt, n_et = -(-B // 64), -(-E // 64)
    assert n_bt * chunks <= max(n_bt, xent.K6_BLOCKS)
    assert n_et * slices <= max(n_et, xent.K6_BLOCKS)
    dp = xent._sweep_width(d, ct)

    p = pooled.clone().requires_grad_(True)
    loss = xent._XentLoss.apply(p, W, b, labels, layout, dtype)
    torch.autograd.grad(loss, [p])
    _, saved, geometry = xent._loss_forward(pooled, W, b, labels, layout, ct)
    assert saved[0].shape == (B, dp) and geometry[3] == dp
    slots = [torch.zeros_like(W), torch.zeros_like(W)]
    xent._bwd_apply(saved, geometry, slots, "adam", 1e-3, 0, 1.0 / B, ct)

    names = [n for n, _ in launches]
    bf16 = dtype == "bfloat16"
    k5, k6 = (("sert_xent_wgmma_fwd", "sert_xent_wgmma_bwd") if bf16
              else ("sert_xent_fwd", "sert_xent_bwd"))
    assert names == [k5, k6, k5] + (
        ["sert_xent_wgmma_dpooled", "sert_xent_wgmma_apply"] if bf16
        else ["sert_xent_bwd_apply"])
    fwd, bwd, apply = launches[0][1], launches[1][1], launches[-1][1]
    assert fwd[5:9] == (B, E, d, dp) and bwd[10:14] == (B, E, d, dp)
    if dtype == "float32":
        assert fwd[11:13] == (per, chunks)
        assert bwd[16:21] == (per, chunks, bper, slices, xent.DP_MAX_TILES)
        assert (bwd[9] is None) == (slices == 1)
        assert apply[11:15] == (B, E, d, dp)
        assert apply[17:22] == (per, chunks, bper, slices,
                                xent.DP_MAX_TILES)
        assert (apply[10] is None) == (slices == 1)
        assert apply[8] is not None              # K7's own dpooled sweep
        assert apply[5] is not None and apply[6] is not None  # adam's m, v
    else:
        dw = xent._wgmma_plan(B, E, d)[1]
        assert apply[11:15] == (B, E, d, dp)
        assert apply[17:20] == (dw.per, dw.parts, dw.y_rows)
        assert (apply[10] is None) == (dw.parts == 1)
        assert apply[6] is not None and apply[7] is not None  # adam's m, v


@pytest.mark.parametrize("layout", ["de", "ed"])
def test_plain_path_past_the_width_matches_the_reference(layout):
    # d = 384: "auto" on a card now takes the plain version, which must
    # agree with the reference's Pallas kernel (interpret mode).
    B, d, E = 12, 384, 200
    assert not use_fused(_cfg("loglinear", d).replace(num_entities=E),
                         CUDA, rows=B)
    rng = np.random.default_rng(7)
    pooled = rng.normal(size=(B, d)).astype(np.float32)
    Wde = (rng.normal(size=(d, E)) * 0.1).astype(np.float32)
    W = Wde if layout == "de" else np.ascontiguousarray(Wde.T)
    b = (rng.normal(size=(E,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, E, size=B).astype(np.int32)
    want = float(ref_xent_loss(pooled, W, b, jnp.asarray(labels), layout, 8,
                               128, None, "float32"))
    tp, tw, tb = (torch.tensor(x, requires_grad=True)
                  for x in (pooled, W, b))
    got = xent.xent_loss_plain(tp, tw, tb, torch.from_numpy(labels), layout)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    gw = jax.grad(lambda p, w, bb: ref_xent_loss(
        p, w, bb, jnp.asarray(labels), layout, 8, 128, None, "float32"),
        argnums=(0, 1, 2))(pooled, W, b)
    for name, a, c in zip(("dpooled", "dW", "db"),
                          torch.autograd.grad(got, [tp, tw, tb]), gw):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-3,
                                   atol=1e-4, err_msg=name)
