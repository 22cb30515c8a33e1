#!/usr/bin/env python3
"""Device time by kernel of the full-softmax backward (K6) and of its plain
version, at chip_smoke.py's xent shapes, on one card.

    python tools/profile_torch_xent.py [--cases cerc w3c ...] [--calls 20]

For each case, seeded inputs on the card (chip_smoke's ``_xent_case``), one
forward, three warm-up backward calls, then ``--calls`` backward calls
under ``torch.profiler``: the device time of each kernel per call (K6's dW
sweep, the reduce of its slices, its dpooled sweep, the wrapper's sum of
the dpooled partials), and of the plain version's kernels (autograd of
``xent_loss_plain``, TF32 off) where its [B, E] logits fit. Unlike the
smoke's CUDA-event times these leave out the host's launch work. Prints
one line per kernel and one JSON object as its last line. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {   # name: (B, E, d, layout, dtype), as chip_smoke.phase_xent_kernels
    "cerc": (1024, 3500, 256, "de", "float32"),
    "w3c_ragged": (1000, 1100, 128, "de", "float32"),
    "cerc_bf16": (1024, 3500, 256, "de", "bfloat16"),
    "split_max": (4096, 300, 256, "de", "float32"),
    "lse_full_128k": (4096, 131072, 128, "ed", "bfloat16"),
    "lse_full_flagship": (4096, 1_000_000, 128, "ed", "bfloat16"),
}
PLAIN_MAX_LOGITS = 1 << 30     # [B, E] fp32 entries the plain version may hold


def device_ms(fn, calls: int) -> dict:
    """{kernel name: ms per call} of ``calls`` calls of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / calls for k, v in sorted(by.items(), key=lambda t: -t[1])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_xent: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sert_tpu_torch.ops import xent
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for name in args.cases:
        B, E, d, layout, dtype = CASES[name]
        x = chip_smoke._xent_case(B, E, d, layout, 1)
        fns = [("kernel", xent.xent_loss)]
        if B * E <= PLAIN_MAX_LOGITS:
            fns.append(("plain", xent.xent_loss_plain))
        for label, fn in fns:
            p, w, b = (t.clone().requires_grad_(True) for t in x[:3])
            loss = fn(p, w, b, x[3], layout, dtype)
            calls = args.calls if E <= 200_000 else max(2, args.calls // 10)
            ms = device_ms(lambda: torch.autograd.grad(
                loss, [p, w, b], retain_graph=True), calls)
            total = sum(ms.values())
            print(f"{name} {label} device_ms_per_backward={total:.4f}")
            for k, v in list(ms.items())[:6]:
                print(f"    {v:.4f}  {k[:90]}")
            out[f"{name}/{label}"] = {"total_ms": total,
                                      "by_kernel": [[k[:90], v] for k, v
                                                    in list(ms.items())[:6]]}
            del loss, p, w, b
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
