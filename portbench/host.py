"""What the host did over a measured window, for the run's record.

A training cell whose device waits on the host is paced by the host's
threads: the main thread's Python, then the autograd thread's backward,
one after the other, and the feed's thread beside them. A run records
where the card sits on the host (its NUMA node and local CPUs, where
``/sys`` shows them), and over its measured window each thread's CPU time
and the CPUs it ran on (``WindowProbe``). These are records, not metrics:
they say why a window took the time it did.

Everything here reads ``/sys`` and ``/proc``; nothing is set. Where a file
cannot be read, the record says so.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

SYS = Path("/sys")
TASKS = Path("/proc/self/task")
NVIDIA = "0x10de"
TICK_S = 1.0 / os.sysconf("SC_CLK_TCK")
SAMPLES = 5      # looks at where each thread last ran, over a window


def parse_cpulist(text: str) -> Set[int]:
    """The CPUs of a sysfs CPU list, such as a card's ``local_cpulist``
    (``"0-31,64-95"``) or a core's ``thread_siblings_list`` (``"3,67"``)."""
    cpus: Set[int] = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def cpulist(cpus: Iterable[int]) -> str:
    """``cpus`` as a sysfs CPU list, runs of CPUs as ``lo-hi``."""
    runs: List[List[int]] = []
    for c in sorted(set(cpus)):
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(f"{a}" if a == b else f"{a}-{b}" for a, b in runs)


def cards(sys_root: Path = SYS) -> List[str]:
    """The PCI bus ids of the NVIDIA display controllers, in bus order,
    the order in which CUDA numbers cards of one kind."""
    devices = sys_root / "bus/pci/devices"
    found = []
    for d in sorted(devices.iterdir()) if devices.is_dir() else []:
        try:
            vendor = (d / "vendor").read_text().strip()
            klass = (d / "class").read_text().strip()
        except OSError:
            continue
        if vendor == NVIDIA and klass.startswith("0x03"):
            found.append(d.name)
    return found


def _visible(found: List[str]) -> Optional[List[str]]:
    """The cards CUDA numbers from 0, under ``CUDA_VISIBLE_DEVICES``; None
    where it names cards otherwise than by index."""
    spec = os.environ.get("CUDA_VISIBLE_DEVICES")
    if spec is None:
        return found
    try:
        picks = [int(x) for x in spec.split(",") if x.strip()]
    except ValueError:
        return None
    return [found[i] for i in picks if 0 <= i < len(found)]


def locality(chips: int, sys_root: Path = SYS) -> Dict:
    """The first ``chips`` cards CUDA will use, their NUMA nodes and the
    CPUs local to them (``/sys/bus/pci/devices/<bus id>/``); ``not_read``
    and the reason in their place where they cannot be read."""
    visible = _visible(cards(sys_root))
    if visible is None or len(visible) < chips:
        return {"not_read": "the cards' PCI devices were not found"}
    nodes, local = [], set()
    try:
        for bus in visible[:chips]:
            d = sys_root / "bus/pci/devices" / bus
            nodes.append(int((d / "numa_node").read_text()))
            local |= parse_cpulist((d / "local_cpulist").read_text())
    except (OSError, ValueError):
        return {"not_read": "the cards' NUMA node could not be read"}
    return {"cards": visible[:chips], "numa_node": nodes,
            "local_cpulist": cpulist(local)}


def _stat(path: Path):
    """The fields of a ``stat`` file after the name: ``f[0]`` is field 3."""
    head, _, rest = path.read_text().rpartition(")")
    return head.partition("(")[2], rest.split()


def threads() -> Dict[int, Dict]:
    """Each thread of this process: its name, CPU seconds in user and
    system mode (``/proc/self/task/<tid>/stat``, fields 14 and 15) and the
    CPU it last ran on (field 39)."""
    out = {}
    for task in TASKS.iterdir():
        try:
            comm, f = _stat(task / "stat")
        except OSError:
            continue                       # the thread has ended
        t = {"comm": comm, "user_s": int(f[11]) * TICK_S,
             "sys_s": int(f[12]) * TICK_S, "last_cpu": int(f[36])}
        t["cpu_s"] = t["user_s"] + t["sys_s"]
        out[int(task.name)] = t
    return out


def process_cpu_s() -> float:
    """This process's CPU seconds by ``/proc/self/stat``, every thread
    counted, those that ended included."""
    _, f = _stat(Path("/proc/self/stat"))
    return (int(f[11]) + int(f[12])) * TICK_S


def frequencies(cpus: Iterable[int], sys_root: Path = SYS) -> Dict[int, int]:
    """Each readable ``scaling_cur_freq`` of ``cpus``, in kHz."""
    out = {}
    for c in sorted(cpus):
        try:
            out[c] = int((sys_root / f"devices/system/cpu/cpu{c}/cpufreq"
                          / "scaling_cur_freq").read_text())
        except (OSError, ValueError):
            pass
    return out


class WindowProbe:
    """What the host did over one measured window: the cards' locality
    and the CPUs the process may use; each thread's CPU ms a micro-step in
    user and system mode from ``/proc``, and the CPU ms of the threads
    that ended in the window (the process's less the living threads');
    where each thread ran at ``SAMPLES`` looks spread over the window;
    the cores' clocks where readable; and the garbage collections.
    ``tick`` costs a clock comparison but at a look."""

    def __init__(self, seconds: float, chips: int):
        self.every = seconds / (SAMPLES + 1)
        self.next = self.every
        self.chips = chips
        self.looks: List[Dict[int, int]] = []
        self.freqs: List[Dict[int, int]] = []
        self.gcs = {"collections": [0, 0, 0], "s": 0.0}
        self._gc_t = 0.0

    def _gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gcs["collections"][info["generation"]] += 1
            self.gcs["s"] += time.perf_counter() - self._gc_t

    def start(self) -> None:
        self.card = locality(self.chips)
        self.allowed = os.sched_getaffinity(0)
        self.t0 = threads()
        self.proc0 = process_cpu_s()
        gc.callbacks.append(self._gc)

    def tick(self, elapsed: float) -> None:
        if elapsed >= self.next:
            self.next += self.every
            self.looks.append({tid: t["last_cpu"]
                               for tid, t in threads().items()})
            self.freqs.append(frequencies(self.allowed))

    def stop(self, micro_steps: int) -> Dict:
        gc.callbacks.remove(self._gc)
        t1, proc1 = threads(), process_cpu_s()
        named = {t.native_id: t.name for t in threading.enumerate()}
        main_tid = threading.main_thread().native_id
        per = 1e3 / max(micro_steps, 1)
        rows = {}
        for tid, t in t1.items():
            t0 = self.t0.get(tid, {})
            row = {"name": named.get(tid, t["comm"]),
                   "ran_on": [look[tid] for look in self.looks
                              if tid in look] + [t["last_cpu"]]}
            for key in ("cpu", "user", "sys"):
                row[f"{key}_ms"] = (t[f"{key}_s"]
                                    - t0.get(f"{key}_s", 0.0)) * per
            if row["cpu_ms"] > 0 or tid == main_tid:
                rows["main" if tid == main_tid else str(tid)] = row
        live = sum(r["cpu_ms"] for r in rows.values())
        process = (proc1 - self.proc0) * per
        return {"card": self.card, "allowed": cpulist(self.allowed),
                "process_cpu_ms": process, "threads_cpu_ms": live,
                "ended_threads_cpu_ms": process - live, "threads": rows,
                "freq_khz": self.freqs, "gc": self.gcs}
