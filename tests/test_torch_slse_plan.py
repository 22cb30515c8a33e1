"""K1/K2's shape-only sweep plan (sert_tpu_torch.ops.sampled_lse._plan) and
the plain masked logsumexp at the widths the amazon_* recipes train at,
against the JAX reference (sert_tpu.ops.sampled_lse) on the CPU.

The plan decides, from B, k, d and the dtype alone, how K1's and K2's
sweeps split their streamed tiles over blocks; the kernels and the
wrapper's merge trust it to cover every tile once, in order, so these run
without a card. The reference runs its Pallas kernels in interpret mode,
as tests/test_ops.py::TestSampledLse does; tolerances are that test's
(forward rtol 1e-5, gradients rtol 1e-3 / atol 1e-4: the interpreter sums
tiles in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.ops.sampled_lse import sampled_lse as ref_sampled_lse  # noqa: E402
from sert_tpu_torch.ops import sampled_lse as slse  # noqa: E402

# (B, k, d, dtype): the flagship (synthetic_1m_retrieval) in both dtypes and
# at d = 256, the amazon_* recipes' k = 256 (home_kitchen: B 4096, d 256,
# bf16; musical_instruments: B 1024, d 128, fp32), ragged B and k, k under
# one tile (the dC sweep's most slices), and one row.
SHAPES = [(4096, 32768, 128, "bfloat16"), (4096, 32768, 128, "float32"),
          (4096, 32768, 256, "bfloat16"), (4096, 32768, 256, "float32"),
          (4096, 256, 256, "bfloat16"), (1024, 256, 128, "float32"),
          (1000, 32767, 128, "bfloat16"), (4095, 333, 40, "float32"),
          (4096, 100, 128, "bfloat16"), (1, 1, 8, "float32")]


def _ranges(sweep):
    """The Y tiles each part of a sweep walks, as the kernel walks them:
    part p from tile p * per, min(per, n_y - p * per) tiles."""
    return [range(p * sweep.per, min((p + 1) * sweep.per, sweep.n_y))
            for p in range(sweep.parts)]


@pytest.mark.parametrize("B,k,d,dtype", SHAPES)
def test_plan_covers_every_tile_once_in_order(B, k, d, dtype):
    fwd, dc = slse._plan(B, k, d, dtype)
    for sweep, x_rows, y_rows in ((fwd, B, k), (dc, k, B)):
        assert sweep.n_x == -(-x_rows // slse.X_ROWS)
        assert sweep.n_y == -(-y_rows // sweep.y_rows)
        parts = _ranges(sweep)
        assert [t for r in parts for t in r] == list(range(sweep.n_y))
        assert all(len(r) > 0 for r in parts)
        assert sweep.blocks == sweep.n_x * len(parts)


@pytest.mark.parametrize("B,k,d,dtype", SHAPES)
def test_plan_depends_on_the_shapes_alone(B, k, d, dtype):
    assert slse._plan(B, k, d, dtype) == slse._plan(B, k, d, dtype)
    fwd, dc = slse._plan(B, k, d, dtype)
    # Both sweeps stream tiles of the same rows: one kernel geometry a
    # (dtype, width), whose Y tile the wrapper hands the kernel to check.
    assert fwd.y_rows == dc.y_rows == slse._ytile(
        slse._compute_dtype(dtype), -(-d // slse.DIM_MULTIPLE)
        * slse.DIM_MULTIPLE)


@pytest.mark.parametrize("dtype,width,rows", [
    ("bfloat16", 64, 128), ("bfloat16", 128, 128), ("bfloat16", 256, 64),
    ("float32", 64, 128), ("float32", 128, 64), ("float32", 256, 32)])
def test_y_tile_narrows_with_the_width(dtype, width, rows):
    ct = slse._compute_dtype(dtype)
    assert slse._ytile(ct, width) == rows
    assert slse._ytile(ct, width - 32) == rows   # dp rounds up to width


def test_small_k_splits_the_dc_sweep_over_the_batch():
    # k = 256 is two candidate tiles: without slices the dC sweep would be
    # two blocks on 132 SMs.
    _, dc = slse._plan(4096, 256, 256, "bfloat16")
    assert dc.n_x == 2 and dc.parts == dc.n_y == 64 and dc.blocks == 128
    _, dc = slse._plan(1024, 256, 128, "float32")
    assert dc.parts == dc.n_y == 16
    _, dc = slse._plan(4096, 100, 128, "bfloat16")
    assert dc.n_x == 1 and dc.parts == dc.n_y == 32 and dc.per == 1


def test_flagship_fills_the_card_in_one_round():
    fwd, dc = slse._plan(4096, 32768, 128, "bfloat16")
    assert (fwd.parts, fwd.per, fwd.blocks) == (4, 64, 128)
    assert (dc.parts, dc.blocks) == (1, 256)
    assert fwd.blocks <= slse.SMS


def _case(seed, B, k, d, E=500):
    rng = np.random.default_rng(seed)
    reps = rng.normal(size=(B, d)).astype(np.float32)
    cand = (rng.normal(size=(k, d)) * 0.3).astype(np.float32)
    corr = rng.normal(size=(k,)).astype(np.float32)
    ids = rng.integers(0, E, size=k).astype(np.int32)
    pos = rng.integers(0, E, size=B).astype(np.int32)
    ids[:min(B, k)] = pos[:min(B, k)]       # accidental hits
    return reps, cand, corr, ids, pos


@pytest.mark.parametrize("B,k,d", [(64, 256, 256), (24, 333, 256),
                                   (64, 257, 128)])
def test_plain_matches_reference_at_recipe_widths(B, k, d):
    reps, cand, corr, ids, pos = _case(B * k + d, B, k, d)
    w = np.random.default_rng(1).normal(size=(B,)).astype(np.float32)

    def ref(r, c, co):
        return jnp.sum(w * ref_sampled_lse(r, c, co, jnp.asarray(ids),
                                           jnp.asarray(pos), 8, 128))

    want = np.asarray(ref(reps, cand, corr))
    gw = jax.grad(ref, argnums=(0, 1, 2))(reps, cand, corr)
    r, c, co = (torch.tensor(x, requires_grad=True)
                for x in (reps, cand, corr))
    got = torch.sum(torch.from_numpy(w) * slse.sampled_lse(
        r, c, co, torch.from_numpy(ids), torch.from_numpy(pos)))
    grads = torch.autograd.grad(got, [r, c, co])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    for a, b in zip(grads, gw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)
