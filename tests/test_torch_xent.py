"""Parity of the port's K5/K6 plain versions (sert_tpu_torch.ops.xent) with
the reference's Pallas kernels (sert_tpu.ops.xent.xent_loss, run in
interpret mode with small tiles as tests/test_ops.py runs it) on the CPU,
on the same numpy inputs, for both entity layouts, both compute dtypes and
ragged batch and entity counts.

Tolerances, with their reasons:
- fp32: the loss to rtol 1e-5 and the gradients to rtol 1e-3 / atol 1e-4
  (the reference's own test: its interpret-mode kernel sums tiles in
  another order);
- bf16: both multiply the same bf16-rounded operands with fp32 sums, so the
  loss agrees to rtol 1e-5; p is rounded to bf16 after fp32 sums that
  differ in order, so a gradient element may move one bf16 step (rtol 2e-2
  / atol 5e-2, the class of tests/test_torch_train.py's bf16 cases).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.ops.xent import xent_loss as ref_xent_loss  # noqa: E402
from sert_tpu_torch.ops import xent  # noqa: E402

GRAD_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
            "bfloat16": dict(rtol=2e-2, atol=5e-2)}


def _case(seed, B, d, E, layout):
    rng = np.random.default_rng(seed)
    pooled = rng.normal(size=(B, d)).astype(np.float32)
    Wde = (rng.normal(size=(d, E)) * 0.3).astype(np.float32)
    W = Wde if layout == "de" else np.ascontiguousarray(Wde.T)
    b = (rng.normal(size=(E,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, E, size=B).astype(np.int32)
    return pooled, W, b, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["de", "ed"])
@pytest.mark.parametrize("B,d,E", [(20, 24, 300), (13, 128, 257),
                                   (8, 40, 64)])
def test_plain_loss_and_grads_match_the_reference_kernel(B, d, E, layout,
                                                         dtype):
    pooled, W, b, labels = _case(B * E + d, B, d, E, layout)

    def ref(p, w, bb):
        return ref_xent_loss(p, w, bb, jnp.asarray(labels), layout, 8, 128,
                             None, dtype)

    want = float(ref(pooled, W, b))
    gw = jax.grad(ref, argnums=(0, 1, 2))(pooled, W, b)
    tp, tw, tb = (torch.tensor(x, requires_grad=True)
                  for x in (pooled, W, b))
    got = xent.xent_loss_plain(tp, tw, tb, torch.from_numpy(labels), layout,
                               dtype)
    gg = torch.autograd.grad(got, [tp, tw, tb])
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    for name, a, c in zip(("dpooled", "dW", "db"), gg, gw):
        assert a.shape == c.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                   **GRAD_TOL[dtype], err_msg=name)


@pytest.mark.parametrize("layout", ["de", "ed"])
def test_plain_lse_is_the_logsumexp_of_the_logits(layout):
    pooled, W, b, _ = _case(3, 11, 32, 90, layout)
    z = pooled @ (W if layout == "de" else W.T) + b
    want = np.asarray(jax.scipy.special.logsumexp(z, axis=-1))
    got = xent.xent_lse_plain(torch.from_numpy(pooled), torch.from_numpy(W),
                              torch.from_numpy(b), layout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    pooled, W, b, labels = _case(5, 6, 16, 50, "de")
    tp = torch.tensor(pooled, requires_grad=True)
    n = (xent.fwd_launches, xent.bwd_launches)
    loss = xent.xent_loss(tp, torch.from_numpy(W), torch.from_numpy(b),
                          torch.from_numpy(labels))
    loss.backward()
    lse = xent.xent_lse(tp.detach(), torch.from_numpy(W),
                        torch.from_numpy(b))
    assert (xent.fwd_launches, xent.bwd_launches) == n
    assert loss.item() == pytest.approx(xent.xent_loss_plain(
        tp.detach(), torch.from_numpy(W), torch.from_numpy(b),
        torch.from_numpy(labels)).item())
    assert lse.shape == (6,) and not lse.requires_grad


def test_the_kernels_check_refuses_what_they_do_not_take():
    pooled, W, b, labels = (torch.from_numpy(x)
                            for x in _case(5, 6, 16, 50, "ed"))
    B, E, d, dp, strides = xent._check(pooled, W, b, labels, "ed")
    assert (B, E, d, dp, strides) == (6, 50, 16, 32, (16, 1))
    assert xent._check(pooled, W.T.contiguous(), b, labels,
                       "de")[4] == (1, 50)
    with pytest.raises(ValueError, match="layout"):
        xent._check(pooled, W, b, labels, "ee")
    with pytest.raises(ValueError, match="shapes"):
        xent._check(pooled, W, b[:3], labels, "ed")
    with pytest.raises(ValueError, match="contiguous"):
        xent._check(pooled, W.T.contiguous().T, b, labels, "ed")
    with pytest.raises(ValueError, match="d <= 256"):
        xent._check(torch.zeros(2, 300), torch.zeros(4, 300), torch.zeros(4),
                    torch.zeros(2, dtype=torch.int64), "ed")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        xent._check(pooled, W.half(), b, labels, "ed")
    with pytest.raises(ValueError, match="dtype"):
        xent.xent_loss(pooled, W, b, labels, "ed", "float16")
