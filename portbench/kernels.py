"""The program's kernels by name in a device trace.

K1 and K2 are modes of one template, ``slse_sweep_kernel<T, KW, MODE>``
(``sert_tpu_torch/csrc/sampled_lse.cu``): MODE 0 is K1's forward, 1 and 2
K2's dreps and dC sweeps. A trace names a launch demangled
(``slse_sweep_kernel<__nv_bfloat16, 128, 0>(...)``) or mangled
(``..._slse_sweep_kernelI13__nv_bfloat16Li128ELi0EEv...``).
"""

from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

FWD, DREPS, DC = 0, 1, 2
_DEMANGLED = re.compile(r"slse_sweep_kernel<([^>]*)>")
_MANGLED = re.compile(r"slse_sweep_kernelI.*?Li\d+ELi(\d+)E")


def sweep_mode(name: str) -> Optional[int]:
    """The MODE of a sampled-LSE sweep launch, or None for another
    kernel."""
    m = _DEMANGLED.search(name)
    if m:
        last = m.group(1).split(",")[-1].strip()
        digits = re.search(r"(\d+)\s*$", last)
        return int(digits.group(1)) if digits else None
    m = _MANGLED.search(name)
    return int(m.group(1)) if m else None


def sweep_seconds(device, modes: Iterable[int]
                  ) -> Optional[Tuple[float, int]]:
    """(device seconds of the sweep launches in ``modes``, the number of
    calls: launches of the first mode), or None where the trace holds no
    launch of every mode, or not as many of each."""
    if device is None:
        return None
    modes = tuple(modes)
    seconds, launches = 0.0, {m: 0 for m in modes}
    for name, s in device.kernels:
        mode = sweep_mode(name)
        if mode in launches:
            seconds += s
            launches[mode] += 1
    counts = set(launches.values())
    if len(counts) != 1 or 0 in counts:
        return None
    return seconds, counts.pop()
