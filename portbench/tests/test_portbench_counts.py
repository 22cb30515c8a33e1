"""The operation counts behind the rooflines and the MFU, the kernels'
names, and the readers on a made-up trace."""

from __future__ import annotations

import types

import pytest

from portbench import counts, kernels, trace
from portbench.tests.portbench_cells import REPO
from portbench.spec import reader

B, K, D = 4096, 32768, 128      # the flagship's batch, negatives, width


def test_flagship_counts():
    assert counts.k1(B, K, D, "bfloat16")["flops"] == pytest.approx(
        3.436e10, rel=1e-3)
    assert counts.k2(B, K, D, "bfloat16")["flops"] == pytest.approx(
        6.872e10, rel=1e-3)
    assert counts.model_flops(B, K, D, D) == pytest.approx(1.035e11,
                                                           rel=1e-3)
    # Both sweeps are bound by their products, not their bytes.
    for c, ms in ((counts.k1(B, K, D, "bfloat16"), 0.0347),
                  (counts.k2(B, K, D, "bfloat16"), 0.0695)):
        assert c["bytes"] / counts.PEAK_BYTES < c["flops"] / 989e12
        assert counts.bound_s(c["flops"], c["bytes"], "bfloat16") * 1e3 \
            == pytest.approx(ms, rel=1e-2)
    assert counts.bound_s(1.0, 1.0, "float32") is None


@pytest.mark.parametrize("name,mode", [
    ("void (anonymous namespace)::slse_sweep_kernel<__nv_bfloat16, 128, 0>"
     "(CUtensorMap_st, CUtensorMap_st, float const*)", 0),
    ("void (anonymous namespace)::slse_sweep_kernel<float, 256, 2>(int)", 2),
    ("_ZN12_GLOBAL__N_117slse_sweep_kernelI13__nv_bfloat16Li128ELi1EEEv"
     "14CUtensorMap_st", 1),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int)", None),
])
def test_sweep_mode_from_a_kernel_name(name, mode):
    assert kernels.sweep_mode(name) == mode


def _view(kernel_list, busy=0.05, window=1.0, micro=10):
    device = trace.DeviceTrace(window_s=window, busy_s=busy,
                               micro_steps=micro, kernels=kernel_list,
                               device_ops=[], idle_gaps=[])
    return types.SimpleNamespace(
        device=device,
        dims={"batch_size": B, "num_negatives": K, "word_dim": D,
              "entity_dim": D, "compute_dtype": "bfloat16"},
        memory={"peak": 3 * 2 ** 30, "init_peak": 2 ** 30, "state": 2 ** 29},
        setup_s=12.5)


def _sweep(mode):
    return f"void slse_sweep_kernel<__nv_bfloat16, 128, {mode}>(int)"


def test_readers_on_a_made_up_trace():
    # Ten micro-steps: K1 0.1 ms, K2 0.1 + 0.15 ms a call, one other kernel.
    ks = []
    for _ in range(10):
        ks += [(_sweep(0), 1e-4), (_sweep(2), 1e-4), (_sweep(1), 1.5e-4),
               ("elementwise", 1e-3)]
    view = _view(ks)
    read = {n: reader(REPO, n)(view) for n in (
        "k1_roofline", "k2_roofline", "launches_per_step",
        "k1_roofline.lazy", "device_mfu_pct", "step_device_ms",
        "peak_mem_gib", "setup_s", "init_peak_gib", "state_gib")}
    assert read["k1_roofline"] == pytest.approx(100 * 3.4743e-5 / 1e-4,
                                                rel=1e-3)
    assert read["k2_roofline"] == pytest.approx(100 * 6.9487e-5 / 2.5e-4,
                                                rel=1e-3)
    assert read["launches_per_step"] == 4.0
    # The device works 50 ms over the trace's 10 micro-steps.
    assert read["step_device_ms"] == pytest.approx(5.0)
    assert read["device_mfu_pct"] == pytest.approx(
        100 * 1.0348e11 / (5e-3 * 989e12), rel=1e-3)
    assert read["k1_roofline.lazy"] == read["k1_roofline"]
    assert (read["peak_mem_gib"], read["init_peak_gib"], read["state_gib"],
            read["setup_s"]) == (3.0, 1.0, 0.5, 12.5)


def test_readers_find_nothing_to_read_without_their_kernels():
    view = _view([("elementwise", 1e-3)] * 4)
    assert reader(REPO, "k1_roofline")(view) is None
    assert reader(REPO, "k2_roofline")(view) is None
    # K2 needs its two sweeps as often each.
    view = _view([(_sweep(2), 1e-4)] * 2 + [(_sweep(1), 1e-4)])
    assert reader(REPO, "k2_roofline")(view) is None
    view.device = None
    for n in ("k1_roofline", "launches_per_step", "step_device_ms",
              "device_mfu_pct"):
        assert reader(REPO, n)(view) is None


def test_busy_time_is_the_union_of_device_intervals():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    cpu = [(0.0, 10.0, "portbench.window"), (1.0, 4.0, "portbench.step"),
           (2.0, 3.0, "aten::index")]
    starts = [c[0] for c in cpu]
    assert trace._host_label(cpu, starts, 2.5) == \
        "portbench.step > aten::index"
    assert trace._host_label(cpu, starts, 3.5) == "portbench.step"
    assert trace._host_label(cpu, starts, 6.0) == \
        "between the harness's calls"
