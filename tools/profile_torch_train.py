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
and feeds it seeded random batches of the recipe's shape from the host
through the loop's feed (a ``PrefetchFeeder`` copying each to the card on
its own thread with ``DevicePut``).
After five warm-up steps:

  * host clock: ``--steps`` micro-steps through ``train.step``'s step
    (dense, or fused where the config says so), ending in a synchronize:
    steps/s;
  * ``torch.profiler`` over ten more, with the program's spans and
    counters recording (``utils.profiling.recording``): device time by
    kernel (K5/K6, K5/K7 or K1/K2, the optimizer's elementwise kernels, the
    embedding gathers and their backward, the lazy step's sorts, segment
    sums and row updates), the device's busy and idle share of the window
    (``portbench/trace.py``), and by span (``portbench/spans.py``): each
    part's device ms and own host ms a micro-step, the idle gaps named by
    the span the host was in (on the feeder thread too, where the step
    waits for a batch), the feed's items that were not ready when the
    step asked for them, the lazy step's padding share of its
    de-duplicated row slots, per table, and each counter a micro-step
    (``optimizer.leaves.kernel``: leaves the adam kernel updated);
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

import numpy as np
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
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import spans, trace
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.data.feeder import DevicePut, PrefetchFeeder
    from sert_tpu_torch.models import lse
    from sert_tpu_torch.train.fused import fused_enabled
    from sert_tpu_torch.train.sparse import sparse_enabled
    from sert_tpu_torch.train.step import init_state, make_train_step
    from sert_tpu_torch.utils import profiling

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

    rng = np.random.default_rng(args.seed)
    B, w = tcfg.batch_size, recipe.data.window_size
    n = args.steps + 15
    lengths = rng.integers(w // 2, w + 1, (n, B))
    windows = (rng.integers(0, args.vocab, (n, B, w))
               * (np.arange(w) < lengths[..., None]))
    entities = rng.integers(0, args.entities, (n, B))
    batches = [{"windows": windows[i].astype(np.int32),
                "lengths": lengths[i].astype(np.int32),
                "entities": entities[i].astype(np.int32)} for i in range(n)]
    put = DevicePut(dev)

    def fed(host):
        with PrefetchFeeder(iter(host), put_fn=put) as feeder:
            for staged in feeder:
                yield put.ready(staged)

    for b in fed(batches[:5]):
        step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in fed(batches[5:5 + args.steps]):
        _, metrics = step(state, b)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    loss = metrics["loss"].item()

    profiled = 10
    profiling.counters()
    profiling.span_idents()
    with profiling.recording(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            **profiling.profile_all_threads()) as prof:
        with record_function(trace.WINDOW):
            for b in fed(batches[5 + args.steps:]):
                step(state, b)
            torch.cuda.synchronize()
    counters = profiling.counters()
    idents = profiling.span_idents()
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    ka = prof.key_averages()
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(ka.table(sort_by="device_time_total", row_limit=40))
    dev = trace.read(spans.without_spans(prof), profiled)
    by_span = spans.read(prof, profiled, idents)
    per_step = 1e3 / profiled
    # The lazy step's share of padding in its de-duplicated row slots.
    rows = {t: (counters[f"rows.unique.{t}"], counters[f"rows.slots.{t}"])
            for t in ("word_emb", "entity_emb")
            if counters.get(f"rows.slots.{t}")}
    if rows:
        rows["both"] = tuple(map(sum, zip(*rows.values())))
    padding = {t: 100.0 * (1.0 - u / n) for t, (u, n) in rows.items()}

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
        "profiled_window_ms": dev.window_s * 1e3,
        "device_busy_ms_per_step": dev.busy_s * per_step,
        "device_idle_share": 1 - dev.busy_s / dev.window_s,
        "device_ms_per_step_by_kernel": [
            [k[:80], s * per_step] for k, s in dev.device_ops],
        "device_ms_per_step_by_span": {
            k: s * per_step for k, s in by_span.span_device.items()},
        "host_ms_per_step_by_span": {
            k: s * per_step for k, s in by_span.span_host.items()},
        "idle_ms_per_step_by_span": [
            [k, s * per_step] for k, s in by_span.idle_gaps],
        "feed_items": len(by_span.feed),
        "feed_items_not_ready": sum(put[1] > wait[0]
                                    for _, put, wait in by_span.feed),
        "row_padding_pct": padding,
        "counters_per_step": {k: v / profiled for k, v in counters.items()},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    for key, val in result.items():
        print(f"{key}: {val}")
    print(f"{'span':22} {'device ms':>10} {'host ms':>9}  (a micro-step)")
    for name in sorted(set(by_span.span_device) | set(by_span.span_host)):
        print(f"{name:22} {by_span.span_device.get(name, 0) * per_step:10.4f}"
              f" {by_span.span_host.get(name, 0) * per_step:9.4f}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
