"""The readings that a cell's limits are set from, at the cell's own size.

    python portbench/calibrate.py --workload lse1m.train \\
        --seeds 101 102 ... --control-seeds 101 102 103

For each seed: the set-up of a run and its first two groups of
micro-steps, then the numbers that ``check.py`` compares, read for the
program and, on the control seeds, for the control (the reference
computed in float8 where the configuration computes in bfloat16, in the
program's place) and for three faults planted in the reference put in the
program's place: half of each batch left out (the mean taken over the
rest), the loss altered by 1 % where it is produced, and a call that runs
the first micro-step of its group and skips the rest. A state left unchanged reads 1 (the norm of
no change against the reference's) and needs no run. Prints one JSON line
a reading and, last, each number's largest program reading and smallest
reading of the control and of each fault. Needs the cell's CUDA devices;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, spec, train_cell  # noqa: E402

FAULTS = {"control": dict(compute="fp8"),
          "half_batch": dict(half_batch=True),
          "loss_altered": dict(loss_scale=1.01),
          "group_skipped": dict(skip_group=True)}


def readings(root: Path, workload: str, seed: int, device: str,
             planted: bool) -> list:
    """[(kind, {number: reading})] of one seed: the program's, and with
    ``planted`` the control's and the faults'."""
    import gc

    import torch
    cell = spec.find_cell(root, workload)
    prog = train_cell.Program()
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        s = train_cell.prepare(prog, cell, seed, device, tmp)
        state, step, feed, _ = train_cell.start(prog, s)
        try:
            state, steps, host = train_cell.first_steps(s, state, step, feed)
        finally:
            feed.close()
        del state, step, feed
        gc.collect()
        if s.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = train_cell.reference_steps(s, host)
        out = [("program", check.readings(steps, ref))]
        if planted:
            for kind, how in FAULTS.items():
                got = train_cell.reference_steps(s, host, **how)
                out.append((kind, check.readings(got, ref)))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lowest, highest = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        for kind, vals in readings(ROOT, args.workload, seed, args.device,
                                   seed in args.control_seeds):
            print(json.dumps({"seed": seed, "kind": kind, **vals,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            for n, v in vals.items():
                if kind == "program":
                    highest[n] = max(highest.get(n, v), v)
                else:
                    key = f"{kind}.{n}"
                    lowest[key] = min(lowest.get(key, v), v)
    print(json.dumps({"program_highest": highest, "planted_lowest": lowest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
