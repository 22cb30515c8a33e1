"""The bf16 route of K5/K6 (``csrc/xent_wgmma.cu``) on the CPU: its plan,
a function of the shapes alone, covers every tile once and is the same for
a run and its resume; bf16 compute launches the wgmma sweep's entry points
with that plan and W's bf16 operand (K7's dpooled sweep too), while fp32
compute and K7's update launch what they launched before the route
existed; the bf16 operand is the cast that ``xent_loss_plain`` makes.
The launches are recorded in place of the library, so no card is needed
(as tests/test_torch_auto.py records them).
"""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu_torch.ops import _build, xent  # noqa: E402
from sert_tpu_torch.ops.sampled_lse import _operand_fp32  # noqa: E402

# (B, E, d): the smoke's bf16 shapes (lse_full's flagship and 128k, its
# tail, d 256, the log-linear A/B's E 500k, cerc), a ragged B, one tile.
SHAPES = [(4096, 1_000_000, 128), (4096, 131072, 128), (4096, 131071, 128),
          (4096, 131072, 256), (1024, 500_000, 256), (1024, 3500, 256),
          (1000, 131071, 128), (100, 777, 24), (4096, 300, 256), (1, 1, 8)]


@pytest.mark.parametrize("B,E,d", SHAPES)
def test_plan_covers_every_tile_once_and_resumes_alike(B, E, d):
    fwd, dw = xent._wgmma_plan(B, E, d)
    rows = 128 if xent._sweep_width(d, torch.bfloat16) <= 128 else 64
    assert fwd.y_rows == dw.y_rows == rows          # the kernel's Y tile
    for plan, n_x, n_y in ((fwd, -(-B // 128), -(-E // rows)),
                           (dw, -(-E // 128), -(-B // rows))):
        assert (plan.n_x, plan.n_y) == (n_x, n_y)
        covered = [t for p in range(plan.parts)
                   for t in range(p * plan.per, min((p + 1) * plan.per, n_y))]
        assert covered == list(range(n_y))
        assert all(p * plan.per < n_y for p in range(plan.parts))  # none empty
    xent._wgmma_plan.cache_clear()                  # a resumed process
    assert xent._wgmma_plan(B, E, d) == (fwd, dw)
    n = xent._wgmma_scratch_numel(B, E, d)
    dp = xent._sweep_width(d, torch.bfloat16)
    assert n == (dw.parts * -(-E // 128) * 128 * (dp + 1) if dw.parts > 1
                 else 0)


def test_flagship_plan_walks_whole_chunks_in_rounds_of_the_card():
    fwd, dw = xent._wgmma_plan(4096, 1_000_000, 128)
    assert (fwd.n_x, fwd.per, fwd.parts, fwd.blocks) == (32, 237, 33, 1056)
    assert fwd.blocks % 132 == 0                     # 8 full rounds
    assert (dw.parts, dw.blocks) == (1, 7813)        # dW written directly


@pytest.mark.parametrize("layout,shape,pad", [("de", (24, 1099), 5),
                                              ("ed", (1099, 20), 4),
                                              ("ed", (300, 24), 0)])
def test_w_operand_is_the_plain_cast_padded_to_16_bytes(layout, shape, pad):
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    Wb = xent._w_operand(W)
    assert Wb.dtype == torch.bfloat16 and Wb.is_contiguous()
    assert Wb.shape == (shape[0], shape[1] + pad)
    assert Wb.shape[1] * 2 % 16 == 0 and Wb.data_ptr() % 16 == 0
    assert torch.equal(Wb[:, :shape[1]].float(),
                       _operand_fp32(W, torch.bfloat16))
    assert not Wb[:, shape[1]:].any()
    b16 = W.to(torch.bfloat16)
    if pad == 0:                                    # taken as it is
        assert xent._w_operand(b16).data_ptr() == b16.data_ptr()


@pytest.fixture
def launches(monkeypatch):
    """[(entry point, args)] of each launch, the library replaced by a
    recorder that checks the argument count against the C signature."""
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


def _inputs(B, E, d, layout, w_dtype=torch.float32):
    rng = np.random.default_rng(1)
    pooled = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(d, E) if layout == "de"
                                    else (E, d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, E, size=B))
    return pooled, W.to(w_dtype), torch.zeros(E), labels


# (B, E, d, layout, W's storage): dW split (4 slices) and whole, a ragged
# B, bf16 storage taken in place, d padded to the sweep's 64.
WIRING = [(1024, 3500, 256, "de", torch.float32),
          (1000, 9001, 40, "ed", torch.float32),
          (300, 20_000, 128, "ed", torch.bfloat16),
          (64, 130, 96, "de", torch.bfloat16)]


@pytest.mark.parametrize("B,E,d,layout,w_dtype", WIRING)
def test_bf16_compute_launches_the_wgmma_sweep_with_its_plan(
        launches, B, E, d, layout, w_dtype):
    pooled, W, b, labels = _inputs(B, E, d, layout, w_dtype)
    fwd, dw = xent._wgmma_plan(B, E, d)
    dp = xent._sweep_width(d, torch.bfloat16)
    n = (xent.fwd_wgmma_launches, xent.bwd_wgmma_launches)
    p = pooled.clone().requires_grad_(True)
    loss = xent._XentLoss.apply(p, W, b, labels, layout, "bfloat16")
    torch.autograd.grad(loss, [p])
    # a mesh rank's block: its labels off the block are -1
    block = xent.Stitch(E // 2, 2, lambda x: x, lambda x: x)
    _, _, saved, geometry = xent._block_forward(
        pooled, W, b, labels, block, layout, "bfloat16", True)
    assert (saved[3] == -1).any()
    xent._bwd(saved, geometry, torch.ones(1), torch.bfloat16)
    assert [n for n, _ in launches] == [
        "sert_xent_wgmma_fwd", "sert_xent_wgmma_bwd", "sert_xent_wgmma_fwd",
        "sert_xent_wgmma_bwd"]
    assert (xent.fwd_wgmma_launches, xent.bwd_wgmma_launches) == (
        n[0] + 2, n[1] + 2)
    Wb = xent._w_operand(W)
    for name, a in launches:
        ldw, de = (a[9], a[10]) if name.endswith("fwd") else (a[14], a[15])
        assert ldw == Wb.shape[1] and ldw % 8 == 0
        assert de == int(layout == "de")
        if w_dtype == torch.bfloat16 and Wb.shape == W.shape:
            assert a[1] == W.data_ptr()             # W itself, no copy
        else:
            assert a[1] != W.data_ptr()
    k5, k6 = launches[0][1], launches[1][1]
    assert k5[5:9] == (B, E, d, dp)
    assert k5[11:14] == (fwd.per, fwd.parts, fwd.y_rows)
    assert k6[10:14] == (B, E, d, dp)
    assert k6[16:21] == (fwd.per, fwd.parts, dw.per, dw.parts, fwd.y_rows)
    assert (k6[9] is None) == (dw.parts == 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp32_compute_and_k7_update_launch_what_they_did(launches, dtype):
    """fp32 K5/K6 and K7's update (in either compute dtype) take the
    mma.sync sweep's entry points with its plans, strides and W in place,
    as they did before the wgmma route (K5/K6 there now fp32 compute
    only). In bf16 compute K7's dpooled is K6's wgmma dpooled mode, with
    K5's plan, launched before the update, and K7's own is skipped."""
    B, E, d, layout = 1000, 1100, 24, "de"
    pooled, W, b, labels = _inputs(B, E, d, layout)
    ct = xent._compute_dtype(dtype)
    dp = xent._sweep_width(d, ct)
    per, chunks = xent._dp_chunks(B, E)
    bper, slices = xent._dw_splits(B, E)
    n = xent.fwd_wgmma_launches, xent.bwd_wgmma_launches
    if dtype == "float32":
        p = pooled.clone().requires_grad_(True)
        loss = xent._XentLoss.apply(p, W, b, labels, layout, dtype)
        torch.autograd.grad(loss, [p])
    _, saved, geometry = xent._loss_forward(pooled, W, b, labels, layout, ct)
    slots = [torch.zeros_like(W), torch.zeros_like(W)]
    xent._bwd_apply(saved, geometry, slots, "adam", 1e-3, 0, 1.0 / B, ct)
    want = (["sert_xent_fwd", "sert_xent_bwd", "sert_xent_fwd"]
            if dtype == "float32" else
            ["sert_xent_wgmma_fwd", "sert_xent_wgmma_dpooled"])
    assert [name for name, _ in launches] == want + ["sert_xent_bwd_apply"]
    assert (xent.fwd_wgmma_launches, xent.bwd_wgmma_launches) == (
        n[0] + (dtype == "bfloat16"), n[1])
    strides = (1, E)
    for name, a in launches:
        if name == "sert_xent_fwd":
            assert a[1] == W.data_ptr()
            assert a[5:] == (B, E, d, dp, *strides, per, chunks, 0, 0)
        elif name == "sert_xent_bwd":
            assert a[1] == W.data_ptr()
            assert a[10:] == (B, E, d, dp, *strides, per, chunks, bper,
                              slices, 0, 0)
        elif name == "sert_xent_wgmma_dpooled":
            plan = xent._wgmma_plan(B, E, d)[0]
            assert a[6:10] == (B, E, d, dp) and a[11] == 1     # "de"
            assert a[12:15] == (plan.per, plan.parts, plan.y_rows)
        elif name == "sert_xent_bwd_apply":
            assert a[1] == W.data_ptr()
            assert (a[8] is None) == (dtype == "bfloat16")
            assert a[11:21] == (B, E, d, dp, *strides, per, chunks, bper,
                                slices)
            assert a[21] == xent.OPTIMIZERS.index("adam")
            assert a[26:] == (int(dtype == "bfloat16"), 0, 0)
