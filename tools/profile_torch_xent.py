#!/usr/bin/env python3
"""Device time by kernel of the full-softmax kernels (K5 forward, K6
backward, K7 backward with the optimizer update), of the sampled-softmax
kernels (K1 forward, K2 backward) and of the serving kernels (K3 score +
bin max, K4 rescore), and of their plain versions, at chip_smoke.py's
shapes, on one card.

    python tools/profile_torch_xent.py [--kernel fwd|bwd|apply|slse_fwd|
        slse_bwd|binmax|rescore] [--cases cerc w3c ...] [--opt adam]
        [--calls 20]

For each case, seeded inputs on the card (chip_smoke's ``_xent_case``, and
``_apply_case`` for K7), three warm-up calls, then ``--calls`` calls under
``torch.profiler``: the device time of each kernel per call, and of the
plain version's kernels (TF32 off) where its [B, E] logits fit; then the
CUDA-event time of ``--calls`` more calls without the profiler, host work
included, as chip_smoke.py times them; and the peak device memory one call
allocates beyond what was allocated before it.
- ``fwd``: the forward of ``xent_loss`` (K5's sweep, the merge of its
  chunks and the gold logit) against ``xent_loss_plain``'s;
- ``bwd``: the backward of ``xent_loss`` (K6's dW sweep, the sum of its
  slices, its dpooled sweep, the wrapper's sum of the dpooled partials)
  against autograd of ``xent_loss_plain``;
- ``apply``: K7 alone on K5's outputs (its dpooled sweep, its update
  sweep, the sum of its slices with the update, the wrapper's sums), W and
  the slots updated in place, against autograd of the plain loss and the
  plain update;
- ``slse_fwd`` / ``slse_bwd``: ``sampled_lse``'s forward (K1 and the merge
  of its chunks) / its backward (K2's dC and dreps sweeps and the sums of
  their partials) against ``sampled_lse_plain``'s, on chip_smoke's
  ``_slse_case`` inputs: the flagship in bf16 and fp32, and the amazon_*
  recipes' k = 256 shapes;
- ``binmax``: K3 (``score_binmax_prepared``) against
  ``score_binmax_plain`` at the serving shape (Q 64, E 1M, d 128, bw 128,
  chip_smoke's seeded unit rows), without and with the bias, at a partial
  tail (E = 1M - 1) and at bw = 64 with the bias; and its fp32 mode (M
  staged in fp32, 3xTF32 products) without and with the bias and at
  bw = 64 with the bias (``f32``, ``f32_bias``, ``f32_bw64_bias``);
- ``rescore``: K4 (``gather_rescore``: its index build, count, scan and
  scatter, then its sweep) against ``gather_rescore_plain``, fp32 and bf16
  rows, on the smoke's ``bin_idx`` (each query's top 1012 bins by K3's
  maxima) and on a shared-bins input (every query holds the same 1012
  bins, each row in its own order). Besides K4's calls back to back
  (``kernel``, ``plain``; the shared-bins rows, 66 MB, then partly stay in
  the 50 MB L2), each is profiled after K3's sweep, as the serving path
  runs it (``kernel_after_k3``: K3 then K4 a call, the device time summed
  over K4's own kernels; no event time).
The device times leave out the host's launch work, which the event times
hold; on a host slow to launch, small shapes are host-bound. Prints one
line per kernel and one JSON object as its last line. Needs a CUDA
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

CASES = {   # name: (B, E, d, layout, dtype), as chip_smoke's xent phases
    "cerc": (1024, 3500, 256, "de", "float32"),
    "w3c": (1024, 1100, 128, "de", "float32"),
    "w3c_ragged": (1000, 1100, 128, "de", "float32"),
    "cerc_bf16": (1024, 3500, 256, "de", "bfloat16"),
    "split_max": (4096, 300, 256, "de", "float32"),
    "ll_500k": (1024, 500_000, 256, "de", "bfloat16"),
    "ll_500k_f32": (1024, 500_000, 256, "de", "float32"),
    "lse_full_128k": (4096, 131072, 128, "ed", "bfloat16"),
    "lse_full_tail": (4096, 131071, 128, "ed", "bfloat16"),
    "lse_full_flagship": (4096, 1_000_000, 128, "ed", "bfloat16"),
}
SLSE_CASES = {   # name: (B, k, d, dtype), as chip_smoke's train_kernels
    "flagship_bf16": (4096, 32768, 128, "bfloat16"),
    "flagship_fp32": (4096, 32768, 128, "float32"),
    "amazon_home_kitchen": (4096, 256, 256, "bfloat16"),
    "amazon_musical_instruments": (1024, 256, 128, "float32"),
}
SERVE_Q, SERVE_E, SERVE_D, SERVE_NB = 64, 1_000_000, 128, 1012
BINMAX_CASES = {   # name: (E, bw, with bias, staged dtype)
    "serving": (SERVE_E, 128, False, "bfloat16"),
    "serving_bias": (SERVE_E, 128, True, "bfloat16"),
    "tail": (SERVE_E - 1, 128, False, "bfloat16"),
    "bw64_bias": (SERVE_E, 64, True, "bfloat16"),
    "f32": (SERVE_E, 128, False, "float32"),
    "f32_bias": (SERVE_E, 128, True, "float32"),
    "f32_bw64_bias": (SERVE_E, 64, True, "float32"),
}
RESCORE_CASES = {   # name: (bins, row dtype)
    "serving_fp32": ("chosen", "float32"),
    "serving_bf16": ("chosen", "bfloat16"),
    "shared_fp32": ("shared", "float32"),
    "shared_bf16": ("shared", "bfloat16"),
}
DEFAULT_CASES = {
    "fwd": ["cerc", "w3c_ragged", "cerc_bf16", "lse_full_128k",
            "lse_full_flagship"],
    "bwd": ["cerc", "w3c_ragged", "cerc_bf16", "split_max", "lse_full_128k",
            "lse_full_flagship"],
    "apply": ["w3c", "cerc", "ll_500k", "lse_full_128k", "lse_full_tail"],
    "slse_fwd": list(SLSE_CASES),
    "slse_bwd": list(SLSE_CASES),
    "binmax": list(BINMAX_CASES),
    "rescore": list(RESCORE_CASES),
}
_serving = {}
PLAIN_MAX_LOGITS = 1 << 30     # [B, E] fp32 entries the plain version may hold
APPLY_LR, APPLY_COUNT = 1e-2, 3


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


def serving_inputs() -> dict:
    """chip_smoke's serving inputs (phase 3), made once: unit rows R [64,
    128] and M [1M, 128], bias, alpha, the bf16 sweep copy, each query's top
    1012 bins by the plain bin maxima, a shared-bins index and the
    bin-major rows in both dtypes (and K3's fp32 sweep copy)."""
    if not _serving:
        from sert_tpu_torch.ops import score_binmax as k3
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        R = torch.randn(SERVE_Q, SERVE_D, generator=g, device=dev)
        R = R / R.norm(dim=1, keepdim=True)
        M = torch.randn(SERVE_E, SERVE_D, generator=g, device=dev)
        M = M / M.norm(dim=1, keepdim=True)
        bias = 0.1 * torch.randn(SERVE_E, generator=g, device=dev)
        alpha = torch.randint(1, 9, (SERVE_Q,), generator=g,
                              device=dev).float()
        Mp = k3.prepare_binmax_matrix(M)
        bins = k3.score_binmax_plain(R, Mp, SERVE_E)
        chosen = torch.topk(bins, SERVE_NB, dim=1).indices.int()
        shared = torch.stack([
            chosen[0][torch.randperm(SERVE_NB, generator=g, device=dev)]
            for _ in range(SERVE_Q)]).int()
        n_bins = bins.shape[1]
        Mb = torch.nn.functional.pad(M, (0, 0, 0, n_bins * 128 - SERVE_E))
        Mb = Mb.view(n_bins, 128, SERVE_D)
        _serving.update(R=R, Rb=R.bfloat16(), bias=bias, alpha=alpha, Mp=Mp,
                        Mp32=k3.prepare_binmax_matrix(M, torch.float32),
                        chosen=chosen, shared=shared, float32=Mb,
                        bfloat16=Mb.bfloat16())
    return _serving


def serving_calls(kernel: str, name: str, with_plain: bool):
    """[(label, fn)] of K3 or K4 and their plain versions on the serving
    inputs; K4's also after K3's sweep (see the docstring)."""
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    x = serving_inputs()
    if kernel == "binmax":
        E, bw, with_bias, dtype = BINMAX_CASES[name]
        ba = (x["bias"], x["alpha"]) if with_bias else (None, None)
        Mp = x["Mp32" if dtype == "float32" else "Mp"]
        return [(label, lambda fn=fn: fn(x["R"], Mp, E, *ba, bw))
                for label, fn in [("kernel", k3.score_binmax_prepared),
                                  ("plain", k3.score_binmax_plain)]
                [:1 + with_plain]]
    bins, dtype = RESCORE_CASES[name]
    Mb, idx = x[dtype], x[bins]
    out = []
    for label, fn in [("kernel", k4.gather_rescore),
                      ("plain", k4.gather_rescore_plain)][:1 + with_plain]:
        out.append((label, lambda fn=fn: fn(x["R"], Mb, idx)))
        out.append((label + "_after_k3", lambda fn=fn: (
            k3.score_binmax_prepared(x["Rb"], x["Mp"], SERVE_E),
            fn(x["R"], Mb, idx))))
    return out


def calls_of(kernel: str, name: str, opt: str, with_plain: bool):
    """[(label, fn)] of the kernel's call and, with ``with_plain``, its
    plain version's, on the case's seeded inputs."""
    import chip_smoke
    if kernel in ("binmax", "rescore"):
        return serving_calls(kernel, name, with_plain)
    from sert_tpu_torch.ops import sampled_lse as slse
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.ops.sampled_lse import _compute_dtype
    if kernel.startswith("slse"):
        B, k, d, dtype = SLSE_CASES[name]
        reps, cand, corr, ids, pos, s_pos = chip_smoke._slse_case(
            B, k, dtype, 0, d=d)
        out = []
        for label, fn in [("kernel", slse.sampled_lse),
                          ("plain", slse.sampled_lse_plain)][:1 + with_plain]:
            if kernel == "slse_fwd":
                out.append((label, torch.no_grad()(
                    lambda fn=fn: fn(reps, cand, corr, ids, pos, dtype))))
                continue
            r, c, co = (t.clone().requires_grad_(True)
                        for t in (reps, cand, corr))
            loss = torch.nn.functional.softplus(
                fn(r, c, co, ids, pos, dtype) - s_pos).sum()
            out.append((label, lambda loss=loss, args=(r, c, co):
                        torch.autograd.grad(loss, list(args),
                                            retain_graph=True)))
        return out
    B, E, d, layout, dtype = CASES[name]
    if kernel == "fwd":
        x = chip_smoke._xent_case(B, E, d, layout, 1)
        out = []
        for label, fn in [("kernel", xent.xent_loss),
                          ("plain", xent.xent_loss_plain)][:1 + with_plain]:
            out.append((label, torch.no_grad()(
                lambda fn=fn: fn(*x, layout, dtype))))
        return out
    if kernel == "bwd":
        x = chip_smoke._xent_case(B, E, d, layout, 1)
        out = []
        for label, fn in [("kernel", xent.xent_loss),
                          ("plain", xent.xent_loss_plain)][:1 + with_plain]:
            p, w, bb = (t.clone().requires_grad_(True) for t in x[:3])
            loss = fn(p, w, bb, x[3], layout, dtype)
            out.append((label, lambda loss=loss, args=(p, w, bb):
                        torch.autograd.grad(loss, list(args),
                                            retain_graph=True)))
        return out
    pooled, W, b, labels, slots = chip_smoke._apply_case(
        B, E, d, layout, opt, 1, torch.float32)
    ct = _compute_dtype(dtype)
    kw = dict(opt=opt, lr=APPLY_LR, count=APPLY_COUNT, gscale=1.0 / B)
    ordered = [slots[k] for k in xent.SLOTS[opt]]
    with torch.no_grad():
        _, saved, geometry = xent._loss_forward(pooled, W, b, labels, layout,
                                                ct)
    out = [("kernel", lambda: xent._bwd_apply(saved, geometry, ordered,
                                              ct=ct, **kw))]
    if with_plain:
        Wp, plain_slots = W.clone(), [s.clone() for s in ordered]
        p, w, bb = (t.detach().float().clone().requires_grad_(True)
                    for t in (pooled, W, b))
        loss = xent.xent_loss_plain(p, w, bb, labels, layout, dtype)

        def plain():
            dW = torch.autograd.grad(loss, [p, w, bb], retain_graph=True)[1]
            with torch.no_grad():
                xent._update_plain(Wp, plain_slots, dW, **kw)

        out.append(("plain", plain))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(DEFAULT_CASES), default="bwd")
    ap.add_argument("--cases", nargs="*",
                    choices=sorted(CASES) + sorted(SLSE_CASES)
                    + sorted(BINMAX_CASES) + sorted(RESCORE_CASES))
    ap.add_argument("--opt", default="adam", choices=["adam", "adagrad",
                                                      "sgd"])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_xent: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "kernel": args.kernel, "opt": args.opt}
    serving = args.kernel in ("binmax", "rescore")
    for name in args.cases or DEFAULT_CASES[args.kernel]:
        if serving:
            B, E, calls = 1, 1, args.calls
        else:
            B, E = (SLSE_CASES if args.kernel.startswith("slse") else
                    CASES)[name][:2]
            calls = args.calls if E <= 200_000 else max(2, args.calls // 10)
        for label, fn in calls_of(args.kernel, name, args.opt,
                                  B * E <= PLAIN_MAX_LOGITS):
            ms = device_ms(fn, calls)
            if label.endswith("_after_k3"):   # K4's own kernels only
                ms = {k: v for k, v in ms.items() if "score_binmax" not in k}
                event = float("nan")
            else:
                event = chip_smoke.cuda_ms(fn, iters=calls, warmup=1)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            total = sum(ms.values())
            print(f"{args.kernel} {name} {label} device_ms_per_call="
                  f"{total:.4f} event_ms_per_call={event:.4f} "
                  f"peak_bytes_above_start={peak}")
            for k, v in list(ms.items())[:6]:
                print(f"    {v:.4f}  {k[:90]}")
            out[f"{name}/{label}"] = {"total_ms": total, "event_ms": event,
                                      "peak_bytes_above_start": peak,
                                      "by_kernel": [[k[:90], v] for k, v
                                                    in list(ms.items())[:6]]}
            del fn
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
