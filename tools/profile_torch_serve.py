#!/usr/bin/env python3
"""Where a serving batch of the PyTorch port spends its time, on one card.

    python tools/profile_torch_serve.py [--out chiprun_out/profile]

Stages the same full-width serving fixture as ``chip_smoke.py`` (its
``full_width_searcher``: synthetic_1m_retrieval, 1M entities, batches of 64
at depth 1000), answers its queries once to warm up, then:

  * host clock: ``search_many`` of all queries, five times, each ending in
    the searcher's own read-back; then ``search`` of 20 single queries one
    after another;
  * ``torch.profiler`` over one more ``search_many``: device time by
    kernel (the stages of a batch: query-rep ops, K3, the two top-k, K4),
    the device's busy and idle share of the window, and the CPU time by
    operator; the Chrome trace and the key-averages table go to ``--out``.

Prints one JSON object as its last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as root:
        searcher, _, _, topics, _, _ = chip_smoke.full_width_searcher(root)
    texts = [topics[q] for q in sorted(topics)]
    searcher.search_many(texts)
    n_batches = -(-len(texts) // chip_smoke.Q)

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        searcher.search_many(texts)
        walls.append(time.perf_counter() - t0)
    one = []
    for text in texts[:20]:
        t0 = time.perf_counter()
        searcher.search(text)
        one.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        searcher.search_many(texts)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    ka = prof.key_averages()
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(ka.table(sort_by="device_time_total", row_limit=40))
    # Device-side events (kernels, copies, memsets) run on one stream here,
    # so their summed durations are the device's busy time.
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    dev = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                 key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in dev)
    cpu_ops = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                      for e in ka), key=lambda x: -x[1])[:12]

    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "queries": len(texts), "batches": n_batches,
        "search_many_s": walls,
        "per_batch_ms": [w * 1e3 / n_batches for w in walls],
        "search_one_ms": one,
        "profiled_window_ms": window_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / (window_s * 1e3),
        "device_ms_by_kernel": [[n[:80], ms, c] for n, ms, c in dev][:16],
        "cpu_self_ms_by_op": [[n, ms, c] for n, ms, c in cpu_ops],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    for key, val in result.items():
        print(f"{key}: {val}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
