#!/usr/bin/env python3
"""Where a training micro-step of the PyTorch port spends its time, on one
card.

    python tools/profile_torch_train.py [--recipe cerc_expert_finding]
        [--model lse_full] [--vocab 39885] [--entities 3500]
        [--param-dtype bfloat16] [--objective nce|sampled_softmax]
        [--sparse-update on|off]
        [--dim 256] [--compute-dtype bfloat16] [--fused-update on|off]
        [--steps 50] [--out chiprun_out/profile_train]

Builds the recipe's model at its width with ``--vocab`` words and
``--entities`` entities (random seeded weights; ``--model`` swaps the
family, e.g. ``lse_full`` on ``synthetic_1m_retrieval``; ``--dim`` and
``--compute-dtype``, ``--param-dtype`` and ``--objective`` replace the
recipe's, ``--fused-update`` its ``fused_update``: "on" takes the
optimizer-in-backward step, K5 + K7, and ``--sparse-update`` its
``sparse_update``: "on" takes the row-sparse lazy step), e.g. the 10M
lazy step: ``--recipe synthetic_10m_training --vocab 250000 --entities
10000000``, and its dense step with ``--sparse-update off``,
and feeds it seeded random batches of the recipe's shape that already sit
on the card, so the feed is left out.
After five warm-up steps:

  * host clock: ``--steps`` micro-steps through ``train.step``'s step
    (dense, or fused where the config says so), ending in a synchronize:
    steps/s;
  * ``torch.profiler`` over ten more: device time by kernel (K5/K6, K5/K7
    or K1/K2, the optimizer's elementwise kernels, the embedding gathers
    and their backward, the lazy step's sorts, segment sums and row
    updates), the device's busy and idle share of the window;
    the Chrome trace and the key-averages table go to ``--out``.

Prints one JSON object as its last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", default="cerc_expert_finding")
    ap.add_argument("--model", default=None,
                    help="model family in place of the recipe's")
    ap.add_argument("--vocab", type=int, default=39885,
                    help="words (default: the CERC stand-in's vocabulary)")
    ap.add_argument("--entities", type=int, default=3500)
    ap.add_argument("--dim", type=int, default=None,
                    help="word (log-linear) or entity dim, else the recipe's")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--fused-update", default=None,
                    choices=["auto", "on", "off"],
                    help="the optimizer-in-backward step (K7), else the "
                         "recipe's setting")
    ap.add_argument("--param-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--objective", default=None,
                    choices=["nce", "sampled_softmax"])
    ap.add_argument("--sparse-update", default=None,
                    choices=["auto", "on", "off"],
                    help="the row-sparse lazy step, else the recipe's "
                         "setting")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/profile_train")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.models import lse
    from sert_tpu_torch.train.fused import fused_enabled
    from sert_tpu_torch.train.sparse import sparse_enabled
    from sert_tpu_torch.train.step import init_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    recipe = load_recipe(args.recipe)
    mcfg = recipe.model.replace(model=args.model or recipe.model.model,
                                vocab_size=args.vocab,
                                num_entities=args.entities)
    if args.dim:
        mcfg = mcfg.replace(**{("word_dim" if mcfg.model == "loglinear"
                                else "entity_dim"): args.dim})
    for field in ("compute_dtype", "param_dtype", "objective"):
        if getattr(args, field):
            mcfg = mcfg.replace(**{field: getattr(args, field)})
    tcfg = dataclasses.replace(
        recipe.train, steps_per_call=1, lr_decay_steps=10_000,
        fused_update=args.fused_update or recipe.train.fused_update,
        sparse_update=args.sparse_update or recipe.train.sparse_update)
    dev = torch.device("cuda")
    state = init_state(args.seed, mcfg, tcfg, device=dev)
    noise = (lse.noise_logits(None, mcfg, dev) if mcfg.model == "lse"
             else None)
    step = make_train_step(mcfg, tcfg, noise=noise, device=dev)
    fused = fused_enabled(mcfg, tcfg, dev)

    g = torch.Generator(device=dev).manual_seed(args.seed)
    B, w = tcfg.batch_size, recipe.data.window_size
    n = args.steps + 15
    lengths = torch.randint(w // 2, w + 1, (n, B), generator=g, device=dev)
    windows = torch.randint(0, args.vocab, (n, B, w), generator=g,
                            device=dev)
    windows = windows * (torch.arange(w, device=dev) < lengths[..., None])
    entities = torch.randint(0, args.entities, (n, B), generator=g,
                             device=dev)
    batches = [{"windows": windows[i].int(), "lengths": lengths[i].int(),
                "entities": entities[i].int()} for i in range(n)]

    for b in batches[:5]:
        step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[5:5 + args.steps]:
        _, metrics = step(state, b)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    loss = metrics["loss"].item()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[5 + args.steps:]:
            step(state, b)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    ka = prof.key_averages()
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(ka.table(sort_by="device_time_total", row_limit=40))
    # Device-side events run on one stream here, so their summed durations
    # are the device's busy time.
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, c + 1)
    dev_ms = sorted(((k, ms, c) for k, (ms, c) in by_name.items()),
                    key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in dev_ms)
    profiled = 10

    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "recipe": recipe.name, "model": mcfg.model,
        "vocab": args.vocab, "entities": args.entities, "batch": B,
        "compute_dtype": mcfg.compute_dtype,
        "param_dtype": mcfg.param_dtype, "objective": mcfg.objective,
        "optimizer": tcfg.optimizer, "fused_update": fused,
        "sparse_update": sparse_enabled(mcfg, tcfg),
        "timed_steps": args.steps,
        "steps_per_sec": args.steps / wall_s,
        "ms_per_step": wall_s * 1e3 / args.steps, "last_loss": loss,
        "profiled_steps": profiled,
        "profiled_window_ms": window_s * 1e3,
        "device_busy_ms_per_step": busy_ms / profiled,
        "device_idle_share": 1 - busy_ms / (window_s * 1e3),
        "device_ms_per_step_by_kernel": [
            [k[:80], ms / profiled, c / profiled] for k, ms, c in dev_ms][:20],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    for key, val in result.items():
        print(f"{key}: {val}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
