#!/usr/bin/env python3
"""The fused-update step's A/B (chip_smoke.py's ``fused_ab``) in a chosen
compute dtype: ms per micro-step and peak device memory of the training
step with ``fused_update`` off (K5 + K6, then the optimizer) and on (K5 +
K7, the optimizer inside the backward), at the reference's fused-step
width (log-linear, E 500k, V 60k, d 256, B 1024, fp32 params, lr 1e-2,
8 micro-steps a call), on one card.

    python tools/fused_step_ab.py [--compute float32] [--opts adam sgd]
        [--calls 3]

For each optimizer the modes run in turns (off, on, on, off), each from
the same seeded state on the same seeded batches: a warm call, then
``--calls`` timed calls (host clock, the last loss read back). Peak memory
is ``torch.cuda.max_memory_allocated`` over the warm and timed calls.
Prints one line per run and one JSON object as its last line. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/fused_step_ab.py")
    ap.add_argument("--compute", default="float32",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--opts", nargs="+", default=["adam", "adagrad", "sgd"],
                    choices=["adam", "adagrad", "sgd"])
    ap.add_argument("--calls", type=int, default=3)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fused_step_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sert_tpu_torch.train.step import init_state, make_train_step
    mcfg, train, w = chip_smoke._ab_configs()
    mcfg = mcfg.replace(compute_dtype=a.compute)
    B, n, E = train.batch_size, chip_smoke.AB_STEPS_PER_CALL, chip_smoke.AB_E
    print(chip_smoke.card(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    lengths = torch.randint(1, w + 1, (n, B), generator=g, device="cuda")
    windows = torch.randint(0, chip_smoke.AB_V, (n, B, w), generator=g,
                            device="cuda")
    batch = {"windows": (windows * (torch.arange(w, device="cuda")
                                    < lengths[..., None])).int(),
             "lengths": lengths.int(),
             "entities": torch.randint(0, E, (n, B), generator=g,
                                       device="cuda").int()}
    out = {"compute": a.compute, "E": E, "B": B, "steps_per_call": n,
           "timed_steps": a.calls * n, "nvidia_smi": chip_smoke.card()}
    for opt in a.opts:
        for i, mode in enumerate(("off", "on", "on", "off")):
            tcfg = dataclasses.replace(train, optimizer=opt,
                                       fused_update=mode, steps_per_call=n)
            state = init_state(chip_smoke.SEED, mcfg, tcfg, device="cuda")
            step = make_train_step(mcfg, tcfg, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(state, batch)                              # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(a.calls):
                _, m = step(state, batch)
            loss = m["loss"].item()                         # syncs
            ms = (time.perf_counter() - t0) * 1e3 / (a.calls * n)
            peak = torch.cuda.max_memory_allocated()
            print(f"fused_step_ab opt={opt} mode={mode} run={i} "
                  f"ms_per_step={ms} peak_mem_bytes={peak} loss={loss}",
                  flush=True)
            out.setdefault(opt, {}).setdefault(mode, []).append(
                {"ms_per_step": ms, "peak_mem_bytes": peak, "loss": loss})
            del state, step, m
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
