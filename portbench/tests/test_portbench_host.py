"""The run's record of the host: CPU lists (a card's local CPUs, a core's
SMT siblings) parsed as sysfs writes them, the card's locality read from a
fake sysfs tree and its fallback where the tree lacks it, and the window
probe's readings of this process's threads."""

from __future__ import annotations

import gc
import os
import threading
import time
from pathlib import Path

import pytest

from portbench import host


@pytest.mark.parametrize("text, cpus", [
    ("0-31,64-95", set(range(32)) | set(range(64, 96))),   # local_cpulist
    ("3,67\n", {3, 67}),                                    # SMT siblings
    ("5", {5}),
    ("0,2-3,7\n", {0, 2, 3, 7}),
    ("\n", set()),
])
def test_cpulist_parses_and_prints_back(text, cpus):
    assert host.parse_cpulist(text) == cpus
    assert host.parse_cpulist(host.cpulist(cpus)) == cpus


def test_cpulist_joins_runs():
    assert host.cpulist([3, 1, 2, 7, 9, 8]) == "1-3,7-9"


def _write(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _pci(root: Path, bus: str, vendor: str, klass: str, node=None,
         local=None) -> None:
    d = f"bus/pci/devices/{bus}/"
    _write(root, d + "vendor", vendor + "\n")
    _write(root, d + "class", klass + "\n")
    if node is not None:
        _write(root, d + "numa_node", f"{node}\n")
    if local is not None:
        _write(root, d + "local_cpulist", local + "\n")


def _fake_machine(root: Path) -> None:
    _pci(root, "0000:1a:00.0", "0x8086", "0x030000", 0, "0-7")
    _pci(root, "0000:3b:00.0", "0x10de", "0x030200", 0, "0-3")
    _pci(root, "0000:3c:00.0", "0x10de", "0x068000", 0, "0-7")  # a bridge
    _pci(root, "0000:b1:00.0", "0x10de", "0x030200", 1, "4-7")


def test_locality_reads_the_cards_in_bus_order(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    _fake_machine(tmp_path)
    assert host.cards(tmp_path) == ["0000:3b:00.0", "0000:b1:00.0"]
    assert host.locality(2, tmp_path) == {
        "cards": ["0000:3b:00.0", "0000:b1:00.0"], "numa_node": [0, 1],
        "local_cpulist": "0-7"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert host.locality(1, tmp_path) == {
        "cards": ["0000:b1:00.0"], "numa_node": [1], "local_cpulist": "4-7"}


@pytest.mark.parametrize("case", ["no sysfs", "no node", "named cards",
                                  "too few cards"])
def test_locality_says_why_where_it_cannot_be_read(tmp_path, monkeypatch,
                                                   case):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    chips = 1
    if case == "no node":
        _pci(tmp_path, "0000:3b:00.0", "0x10de", "0x030200")
    elif case != "no sysfs":
        _fake_machine(tmp_path)
    if case == "named cards":
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-5a1b")
    if case == "too few cards":
        chips = 4
    rec = host.locality(chips, tmp_path / "nothing" if case == "no sysfs"
                        else tmp_path)
    assert list(rec) == ["not_read"]


def test_threads_and_the_window_probe_read_this_process():
    ths = host.threads()
    main = ths.get(os.getpid())
    assert main is not None and main["cpu_s"] >= 0
    assert main["cpu_s"] == main["user_s"] + main["sys_s"]
    assert main["last_cpu"] in os.sched_getaffinity(0)
    probe = host.WindowProbe(0.06, 1)
    probe.start()
    t0 = time.perf_counter()
    while (elapsed := time.perf_counter() - t0) < 0.1:
        probe.tick(elapsed)
        sum(i * i for i in range(20000))
    gc.collect(0)
    rec = probe.stop(10)
    assert "card" in rec and rec["allowed"]
    assert len(rec["freq_khz"]) == len(probe.looks) >= 1
    assert rec["gc"]["collections"][0] >= 1
    row = rec["threads"]["main"]
    assert row["name"] == "MainThread"
    assert row["cpu_ms"] == pytest.approx(row["user_ms"] + row["sys_ms"])
    assert len(row["ran_on"]) == len(probe.looks) + 1
    assert rec["process_cpu_ms"] >= 0 and rec["threads_cpu_ms"] >= 0
    assert rec["ended_threads_cpu_ms"] == pytest.approx(
        rec["process_cpu_ms"] - rec["threads_cpu_ms"])
    assert gc.callbacks.count(probe._gc) == 0


def test_the_probe_counts_a_thread_that_ended_in_the_window():
    """A thread that works and ends inside the window is gone from
    ``/proc/self/task`` at the end; its CPU time shows in the process's
    less the living threads'."""
    probe = host.WindowProbe(1.0, 1)
    probe.start()

    def work():
        t = time.thread_time()
        while time.thread_time() - t < 0.3:
            sum(i * i for i in range(20000))
    worker = threading.Thread(target=work)
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    rec = probe.stop(1)
    # 300 CPU ms in one micro-step, read at the clock tick's resolution.
    assert rec["ended_threads_cpu_ms"] >= 300 - 2e3 * host.TICK_S
