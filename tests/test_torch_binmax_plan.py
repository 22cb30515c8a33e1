"""K3's fp32 mode's shape-only plan (sert_tpu_torch.ops.score_binmax._plan_f32)
and its width limit, on the CPU.

The plan sizes the fp32 sweep's shared memory from d alone: the resident
64 query rows, each consumer warpgroup's ring stages and lo buffer, the
barriers. The kernel trusts it (it refuses a plan smaller than its layout),
so these run without a card.
"""

import pytest

torch = pytest.importorskip("torch")

from sert_tpu_torch.ops import score_binmax as k3  # noqa: E402

WIDTHS = list(range(16, k3.MAX_DIM_F32 + 1, 16))


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_fits_with_two_stages_at_every_width(d):
    plan = k3._plan_f32(d)
    assert plan.consumers in (1, 2)
    assert 2 <= plan.stages <= k3.F32_MAX_STAGES
    assert plan.smem <= k3.SMEM_LIMIT
    nsub = -(-d // k3.F32_COLS)
    assert plan.smem == k3._smem_f32(nsub, plan.consumers, plan.stages)
    assert plan.smem >= nsub * k3.R_SUB_BYTES + plan.consumers * (
        plan.stages + 1) * k3.M_SUB_BYTES
    # As many stages as fit: one more would not.
    if plan.stages < k3.F32_MAX_STAGES:
        assert k3._smem_f32(nsub, plan.consumers,
                            plan.stages + 1) > k3.SMEM_LIMIT


def test_two_consumers_where_each_keeps_two_stages():
    """Two warpgroups up to the bf16 mode's widest d, one past it."""
    assert {k3._plan_f32(d).consumers for d in WIDTHS if d <= 512} == {2}
    assert {k3._plan_f32(d).consumers for d in WIDTHS if d > 512} == {1}
    assert k3._plan_f32(128) == k3.PlanF32(2, 4, k3._smem_f32(4, 2, 4))
    assert k3._plan_f32(k3.MAX_DIM_F32).stages == 2


def test_kernel_limits_take_672_in_fp32_and_refuse_688():
    assert k3.kernel_limits(672, torch.float32) is None
    assert k3.kernel_limits(660, torch.float32) is None     # pads to 672
    assert "672" in k3.kernel_limits(688, torch.float32)
    assert k3.kernel_limits(512, torch.bfloat16) is None
    assert "512" in k3.kernel_limits(528, torch.bfloat16)


def test_plan_refuses_rows_it_cannot_hold():
    with pytest.raises(ValueError, match="two ring stages"):
        k3._plan_f32(1024)
