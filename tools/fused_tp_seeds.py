#!/usr/bin/env python3
"""The pure-TP fused step's check (``parallel.dryrun.check_fused_card_world``)
on several seeds, at chip_smoke.py's ``mesh_fused_tp`` width: log-linear,
E 500k, d 256, B 1024, 4 gloo ranks sharing one card at mesh (1, 4), adam,
adagrad and sgd, MESH_FUSED_STEPS micro-steps.

    python tools/fused_tp_seeds.py [--seeds 0 1 2 3] [--compute bfloat16]

Each seed sets both the initial state (``TrainConfig.seed``) and the
batches. Prints, for each seed and optimizer, the worst leaf's relative
norm of the step's change against "off" (the dense sharded step) and
against one card, beside the check's limits; then one JSON object, the
worst of each over the seeds, as its last line. Exits 1 if a seed fails the
check. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/fused_tp_seeds.py")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--compute", default="bfloat16",
                    choices=["bfloat16", "float32"])
    a = ap.parse_args(argv)
    import chip_smoke
    from sert_tpu_torch.parallel import dryrun
    mcfg, tcfg, window = chip_smoke._ab_configs()
    mcfg = mcfg.replace(compute_dtype=a.compute)
    print(chip_smoke.card(), flush=True)
    worst, ok = {}, True
    for seed in a.seeds:
        report = dryrun.check_fused_card_world(
            mcfg, dataclasses.replace(tcfg, seed=seed),
            n=chip_smoke.CARD_RANKS, window=window,
            steps=chip_smoke.MESH_FUSED_STEPS, seed=seed)
        ok = ok and report["ok"]
        for opt, rep in report["optimizers"].items():
            for which, leaves in rep["leaves"].items():
                leaf = max(leaves, key=lambda k: leaves[k]["rel_norm"])
                rel = leaves[leaf]["rel_norm"]
                print(f"seed={seed} opt={opt} compute={a.compute} "
                      f"against={which} worst_leaf={leaf} rel_norm={rel} "
                      f"ok={rep['ok']}", flush=True)
                key = f"{opt}_{which}"
                if rel > worst.get(key, (-1.0,))[0]:
                    worst[key] = (rel, seed, leaf)
    print(json.dumps({"compute": a.compute, "seeds": a.seeds, "ok": ok,
                      "rtol": dryrun.FUSED_TP_RTOL,
                      "one_card_rtol":
                          dryrun.FUSED_TP_ONE_CARD_RTOL[a.compute],
                      "worst": worst}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
