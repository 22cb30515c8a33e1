"""A world of gloo ranks, and the multi-rank dry run (the port's
counterpart of ``dryrun_multichip`` in ``__graft_entry__.py:44``).

:func:`launch` starts ``n`` processes of ``python -m
sert_tpu_torch.parallel.dryrun --worker ...``, each of which joins a gloo
world through a file store of its own (a fresh directory, so concurrent
worlds never meet), calls one function of this package by its import path
with the pickled arguments, and writes its result back; the parent
returns the results by rank. The children import torch and this package
only.

:func:`dryrun_multichip` runs one sharded train step and one
``distributed_topk`` on a mesh of ``n`` ranks and holds each against the
same computation on one rank:

    python -m sert_tpu_torch.parallel.dryrun [--ranks 8] [--mesh 2 4]

:func:`check_card_world` runs the sharded losses at tp > 1 through their
kernels, on a world of gloo ranks that share one card (NCCL takes one
rank per card; gloo's all-reduce takes CUDA tensors); ``chip_smoke.py``
and a ``gpu`` test of ``tests/test_torch_kernels.py`` run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
from typing import Any, List

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def launch(n: int, fn: str, *args, timeout: float = 600.0) -> List[Any]:
    """``fn`` ("module:function" in this package) called with ``args`` on
    each rank of an ``n``-rank gloo world of CPU processes; the ranks'
    results, in rank order. RuntimeError naming the rank that failed (with
    the end of its standard error), or that outlived ``timeout``
    seconds."""
    with tempfile.TemporaryDirectory(prefix="sert-world-") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as fh:
            pickle.dump((fn, args), fh)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        procs = []
        for r in range(n):
            err = open(os.path.join(tmp, f"err{r}.txt"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "sert_tpu_torch.parallel.dryrun",
                 "--worker", tmp, str(r), str(n)],
                env=env, cwd=tmp, stdout=err, stderr=subprocess.STDOUT),
                err))
        failed = []
        try:
            for r, (p, _) in enumerate(procs):
                try:
                    if p.wait(timeout=timeout) != 0:
                        failed.append(r)
                except subprocess.TimeoutExpired:
                    failed.append(r)
                    break
        finally:
            for p, err in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                err.close()
        if failed:
            r = failed[0]
            with open(os.path.join(tmp, f"err{r}.txt")) as fh:
                tail = fh.read()[-4000:]
            raise RuntimeError(f"rank {r} of {n} failed running {fn}:\n"
                               f"{tail}")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def _worker(tmp: str, rank: int, n: int) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "job.pkl"), "rb") as fh:
        fn, args = pickle.load(fh)
    mod, name = fn.split(":")
    if not mod.startswith("sert_tpu_torch."):
        raise ValueError(f"{fn}: not a function of sert_tpu_torch")
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        world_size=n, rank=rank)
    try:
        result = getattr(importlib.import_module(mod), name)(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


# ------------------------------ the dry run -------------------------------

def check_world(mesh_shape) -> dict:
    """On every rank of the world: one sharded train step of a tiny
    sampled-softmax LSE model and one ``distributed_topk`` (ring merge,
    binmax per shard) on ``mesh_shape``, each beside the same computation
    on this rank alone (no collective). Returns the largest differences."""
    import numpy as np
    import torch
    from sert_tpu_torch.parallel.mesh import make_mesh
    from sert_tpu_torch.parallel.sharding import gather_tensor
    from sert_tpu_torch.parallel.topk import distributed_topk
    from sert_tpu_torch.parallel.train import (make_sharded_train_step,
                                               state_specs)
    from sert_tpu_torch.scoring.scorer import streaming_topk
    from sert_tpu_torch.train.step import init_state, make_train_step
    from sert_tpu_torch.utils.config import ModelConfig, TrainConfig

    mcfg = ModelConfig(model="lse", objective="sampled_softmax",
                       vocab_size=50, num_entities=64, word_dim=8,
                       entity_dim=8, num_negatives=16)
    tcfg = TrainConfig(batch_size=16, learning_rate=1e-2,
                       sparse_update="off")
    mesh = make_mesh(tuple(mesh_shape), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"windows": rng.integers(0, 50, (16, 5)).astype(np.int32),
             "lengths": np.full(16, 5, np.int32),
             "entities": rng.integers(0, 64, 16).astype(np.int32)}
    step, init_fn, put_fn = make_sharded_train_step(mcfg, tcfg, mesh)
    state, m = step(init_fn(), put_fn(batch))
    specs = state_specs(mcfg, tcfg)["params"]
    got = {k: gather_tensor(v, specs[k], mesh) for k, v in
           state.params.items()}
    one = init_state(tcfg.seed, mcfg, tcfg, "cpu", sparse_override=False)
    one, m1 = make_train_step(mcfg, tcfg)(
        one, {k: torch.from_numpy(v) for k, v in batch.items()})
    step_err = max(float((got[k] - one.params[k]).abs().max()) for k in got)

    t = torch.from_numpy(rng.integers(0, 50, (8, 3)).astype(np.int32))
    n_t = torch.from_numpy(rng.integers(1, 4, 8).astype(np.int32))
    s, i = distributed_topk(one.params, mcfg, t, n_t, mesh, k=8, chunk=8,
                            merge="ring", local_engine="binmax")
    ws, wi = streaming_topk(one.params, mcfg, t, n_t, k=8, chunk=16)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "sert_tpu"))
    return {"mesh": list(mesh_shape), "rank": mesh.rank, "foreign": foreign,
            "step_param_err": step_err,
            "loss_err": abs(float(m["loss"]) - float(m1["loss"])),
            "topk_score_err": float((s - ws).abs().max()),
            "topk_ids_equal": bool(torch.equal(i, wi))}


def dryrun_multichip(n: int = 8, mesh_shape=(2, 4)) -> dict:
    """:func:`check_world` on an ``n``-rank gloo world; every rank's
    report, and ``ok``: the step's params and loss within 2e-5 of one
    rank, the top-k ids equal and its scores within 1e-5, and no module of
    jax or of the reference package loaded in any rank."""
    reports = launch(n, "sert_tpu_torch.parallel.dryrun:check_world",
                     list(mesh_shape))
    ok = all(r["step_param_err"] <= 2e-5 and r["loss_err"] <= 2e-5
             and r["topk_ids_equal"] and r["topk_score_err"] <= 1e-5
             and not r["foreign"] for r in reports)
    return {"ok": ok, "ranks": reports}


# check_card_world's cases: (id, mesh, the loss's inputs). The widths are
# those of the mesh recipes' shards: cerc_expert_finding's E 3500 over 4
# model ranks at d 256, and the flagship's d 128 with 1024 candidates split
# 4 ways (or 1022, which 4 does not divide: the candidate axis stays whole).
CARD_XENT = [("xent-de-1x4", (1, 4), "de", 512, 3500, 256),
             ("xent-ed-2x2", (2, 2), "ed", 512, 4096, 128)]
CARD_MODELS = [
    ("loglinear-1x4", (1, 4), dict(model="loglinear", num_entities=3500,
                                   word_dim=256)),
    ("lse_full-1x4", (1, 4), dict(model="lse_full", num_entities=4096,
                                  word_dim=128, entity_dim=128)),
    ("lse_full-bf16-1x4", (1, 4), dict(model="lse_full", num_entities=4096,
                                       word_dim=128, entity_dim=128,
                                       compute_dtype="bfloat16")),
    ("sampled-bf16-1x4", (1, 4), dict(model="lse",
                                      objective="sampled_softmax",
                                      num_entities=8192, word_dim=128,
                                      entity_dim=128, num_negatives=1024,
                                      compute_dtype="bfloat16")),
    ("sampled-2x2", (2, 2), dict(model="lse", objective="sampled_softmax",
                                 num_entities=8192, word_dim=128,
                                 entity_dim=128, num_negatives=1024)),
    ("sampled-k1022-1x4", (1, 4), dict(model="lse",
                                       objective="sampled_softmax",
                                       num_entities=8192, word_dim=128,
                                       entity_dim=128, num_negatives=1022))]
# Relative to the largest magnitude of the one-card value: fp32 sums taken
# in another order (bf16 operands: p rounded to bf16 may round the other
# way, one bf16 step). bf16: ~4x the largest reading on the H100, 2.8e-3
# (lse_full's gradients through the bf16 K5/K6 per block; K1/K2's sampled
# case 1.1e-3).
CARD_TOL = {"float32": 1e-4, "bfloat16": 1.1e-2}


def _card_cases(seed: int = 0):
    import numpy as np
    import torch
    from sert_tpu_torch.models import api
    from sert_tpu_torch.utils.config import ModelConfig, TrainConfig
    rng = np.random.default_rng(seed)
    jobs, dtypes = [], []
    for cid, mesh, layout, B, E, d in CARD_XENT:
        W = (rng.normal(size=(d, E)) * (2.0 / d ** 0.5)).astype(np.float32)
        jobs.append((cid, "xent_loss", dict(
            mesh=mesh, layout=layout, fused=True, device="cuda",
            pooled=(0.5 * rng.normal(size=(B, d))).astype(np.float32),
            W=W if layout == "de" else np.ascontiguousarray(W.T),
            b=(0.1 * rng.normal(size=E)).astype(np.float32),
            labels=rng.integers(0, E, B).astype(np.int64))))
        dtypes.append("float32")
    tcfg = TrainConfig(batch_size=256, sparse_update="off")
    for i, (cid, mesh, kw) in enumerate(CARD_MODELS):
        cfg = ModelConfig(vocab_size=1000, **kw)
        params = {k: v.numpy() for k, v in api.init_params(
            torch.Generator().manual_seed(seed + i), cfg, "cpu").items()}
        batch = {"windows": rng.integers(0, 1000, (256, 5)).astype(np.int32),
                 "lengths": rng.integers(1, 6, 256).astype(np.int32),
                 "entities": rng.integers(0, cfg.num_entities,
                                          256).astype(np.int32)}
        negs = (rng.integers(0, cfg.num_entities, cfg.num_negatives)
                .astype(np.int64) if cfg.objective == "sampled_softmax"
                and cfg.model == "lse" else None)
        jobs.append((cid, "model_loss", dict(
            mesh=mesh, cfg=cfg, tcfg=tcfg, params=params, batch=batch,
            negatives=negs, device="cuda")))
        dtypes.append(cfg.compute_dtype)
    return jobs, dtypes


def _one_card(name: str, spec: dict) -> dict:
    """The case's loss and full gradients on one card, in this process:
    ``ops.xent.xent_loss`` (K5/K6 over every entity) or the single-card
    model loss."""
    import torch
    from sert_tpu_torch.parallel import worlds
    if name == "model_loss":
        return worlds.one_card_loss(spec)
    from sert_tpu_torch.ops.xent import xent_loss
    leaves = [torch.from_numpy(spec[k]).cuda().requires_grad_(True)
              for k in ("pooled", "W", "b")]
    loss = xent_loss(*leaves, torch.from_numpy(spec["labels"]).cuda(),
                     spec["layout"], "float32")
    grads = torch.autograd.grad(loss, leaves)
    return {"loss": loss.item(),
            "grads": [g.float().cpu().numpy() for g in grads]}


def check_card_world(n: int = 4, timeout: float = 600.0) -> dict:
    """The sharded losses at tp > 1 on CUDA tensors: an ``n``-rank gloo
    world whose ranks all hold the one card runs each case of
    :data:`CARD_XENT` (``ops.xent.sharded_xent_loss`` through K5, then K6
    fed the stitched lse with labels of -1 off the block) and
    :data:`CARD_MODELS` (the mesh's model losses: K5/K6 per entity block,
    K1/K2 per [B/dp, k/tp] block, or on the whole [B/dp, k] block where tp
    does not divide k), each held against the same loss on one card in
    this process. Returns each case's largest relative errors, the
    launches of its ranks, and ``ok``: every error within
    :data:`CARD_TOL` and every rank through its kernels."""
    import numpy as np
    from sert_tpu_torch.ops import _build
    _build.build()                 # the ranks load it; none compiles
    jobs, dtypes = _card_cases()
    out = launch(n, "sert_tpu_torch.parallel.worlds:run_jobs",
                 [(name, spec) for _, name, spec in jobs], timeout=timeout)
    report, ok = [], True
    for j, ((cid, name, spec), dtype) in enumerate(zip(jobs, dtypes)):
        want = _one_card(name, spec)
        wg = (want["grads"] if name == "xent_loss"
              else [want["grads"][k] for k in sorted(want["grads"])])
        errs = {"loss": 0.0, "grads": 0.0}
        launches = []
        for r in out:
            got = r[j]
            gg = (got["grads"] if name == "xent_loss"
                  else [got["grads"][k] for k in sorted(want["grads"])])
            errs["loss"] = max(errs["loss"], abs(got["loss"] - want["loss"])
                               / abs(want["loss"]))
            for a, w in zip(gg, wg):
                scale = float(np.abs(w).max()) or 1.0
                errs["grads"] = max(errs["grads"], float(
                    np.abs(a - w).max()) / scale)
            launches.append(got["launches"])
        kernels = ("xent_fwd", "xent_bwd") if (
            name == "xent_loss" or spec["cfg"].model != "lse") else (
            "sampled_lse_fwd", "sampled_lse_bwd")
        through = all(all(l[k] > 0 for k in kernels) for l in launches)
        case_ok = (through and errs["loss"] <= CARD_TOL[dtype]
                   and errs["grads"] <= CARD_TOL[dtype])
        ok = ok and case_ok
        report.append({"case": cid, "mesh": list(spec["mesh"]),
                       "dtype": dtype, "rel_err": errs,
                       "rank_launches": {k: [l[k] for l in launches]
                                         for k in kernels},
                       "ok": case_ok})
    return {"ok": ok, "ranks": n, "cases": report}


def _one_card_fused(cfg, tcfg, batches, out_dir: str, device) -> dict:
    """The one-card fused step (``train.fused.make_fused_train_step``) of
    ``cfg``, ``tcfg`` at mesh (1, 1) over ``batches`` on ``device``, in this
    process: its losses and grad norms, and its params and slots after
    the first micro-step written to ``out_dir`` as ``.npy`` files (their
    paths by leaf name)."""
    import dataclasses
    import numpy as np
    import torch
    from sert_tpu_torch.parallel.worlds import tensor_leaves
    from sert_tpu_torch.train.fused import make_fused_train_step
    from sert_tpu_torch.train.step import init_state
    tcfg = dataclasses.replace(tcfg, mesh_shape=(1, 1), fused_update="on")
    state = init_state(tcfg.seed, cfg, tcfg, device)
    step = make_fused_train_step(cfg, tcfg)
    losses, norms, paths = [], [], {}
    for i, b in enumerate(batches):
        _, m = step(state, {k: torch.from_numpy(v).to(device)
                            for k, v in b.items()})
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            for j, (k, t) in enumerate(sorted(tensor_leaves(state).items())):
                paths[k] = os.path.join(out_dir, f"{j}.npy")
                np.save(paths[k], t.cpu().numpy())
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "norms": norms, "paths": paths}


def seeded_batches(cfg, tcfg, window: int, steps: int, seed: int):
    """``steps`` seeded host batches of ``tcfg.batch_size`` windows of
    width ``window`` (lengths 1 to ``window``, padding id 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        lengths = rng.integers(1, window + 1, tcfg.batch_size)
        windows = rng.integers(0, cfg.vocab_size,
                               (tcfg.batch_size, window))
        windows *= np.arange(window) < lengths[:, None]
        out.append({"windows": windows.astype(np.int32),
                    "lengths": lengths.astype(np.int32),
                    "entities": rng.integers(0, cfg.num_entities,
                                             tcfg.batch_size)
                    .astype(np.int32)})
    return out


def _max_rel(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _leaf_parity(stats, leaf: str, sharded: bool) -> dict:
    """One leaf's ``worlds._diff_stats`` over the mesh from each rank's
    ``stats`` (a sharded leaf's blocks added, a replicated leaf's from rank
    0: the ranks hold equal copies): the norm of the difference of the two
    changes beyond rounding over the norm of the other's change
    (``rel_norm``), the same for a step that left the leaf as it was
    (``skipped``: near 1 where the leaf's change is many storage steps,
    near 0 where its storage cannot hold the change), whether it moved,
    the largest difference, and the elements more than one storage step
    apart, out of all."""
    rows = ([st[leaf] for st in stats] if sharded else [stats[0][leaf]])
    num, den, skip = (sum(x[i] for x in rows) for i in range(3))
    moved = den > 0
    return {"rel_norm": (num / den) ** 0.5 if moved else float("inf"),
            "skipped": (skip / den) ** 0.5 if moved else 0.0,
            "moved": moved, "max_abs": max(x[3] for x in rows),
            "over_one_step": sum(x[4] for x in rows),
            "of": sum(x[5] for x in rows)}


# The pure-TP fused step's check: its optimizers; the norm of the
# difference of "on"'s and "off"'s changes from one state, beyond
# rounding, allowed relative to the norm of "off"'s change; and the same
# against one card's first step, by compute dtype. The mesh sums dpooled
# over its blocks, one card over every entity, each block's sum in other
# chunks (bf16 also rounds dpooled and K7's p - y), so the word table's
# change, and adam's first m and v (the gradient itself), differ by more
# than the entity blocks' do. "on" and "off" take their dW from the same
# sweep in either compute dtype (K7's update runs on K6's dW mode), so
# they differ by the update's arithmetic only. Readings at the chip
# phase's width over seeds 0-3 (tools/fused_tp_seeds.py, PERF.md §6):
# against "off" at most 3.9e-6 (adam's proj_w; adagrad 4.3e-10, sgd 0) in
# bf16 and fp32, 25x under FUSED_TP_RTOL; against one card at most 7.9e-4
# in bf16 (adam's word table), 2.5x under, and 1.2e-5 in fp32 (adam's
# word table), 43x under: the fp32 dpooled sweep adds its tensor-core sums
# up every ops.xent.DP_MAX_TILES entity tiles, so that one card's long
# sums stay near the blocks' shorter ones.
FUSED_TP_OPTS = ("adam", "adagrad", "sgd")
FUSED_TP_RTOL = 1e-4
FUSED_TP_ONE_CARD_RTOL = {"float32": 5e-4, "bfloat16": 2e-3}
# A skipped update of each param must read at least this: the check sees
# the change (sgd's word table, the smallest, reads 0.98).
FUSED_TP_MIN_SKIPPED = 0.9


def check_fused_card_world(cfg, tcfg, n: int = 4, window: int = 8,
                           steps: int = 8, seed: int = 0,
                           device: str = "cuda") -> dict:
    """The pure-TP fused step on the card: for each optimizer of
    :data:`FUSED_TP_OPTS`, ``cfg`` (log-linear or lse_full) and ``tcfg`` run
    ``steps`` seeded micro-steps on an ``n``-rank gloo world whose ranks
    all hold the one card, at mesh (1, n), with ``fused_update`` "on" (K5
    + K7 per entity block), each micro-step also taken from the same state
    by the dense sharded step, "off" (K5/K6 per block)
    (``worlds.fused_tp_card``), and through the one-card fused step in this
    process.

    Held, on each param and slot, on the step's change (Delta = after -
    before), since one step moves a leaf by a small fraction of its size,
    beyond what the rounding of the stored values explains
    (``worlds._diff_stats``): each micro-step's Delta of "on" against that
    of "off" from the same state within :data:`FUSED_TP_RTOL` of the
    norm of "off"'s, and the first micro-step's against one card's from
    the initial state within :data:`FUSED_TP_ONE_CARD_RTOL` of the compute
    dtype; every leaf moved, and a skipped update of every param reads at
    least :data:`FUSED_TP_MIN_SKIPPED` (near 1; one of the wrong sign near
    2). The largest difference and the elements more than one storage step
    apart are reported. The losses and grad norms within
    :data:`FUSED_TP_RTOL` (relative) of "off"'s and, over the free-running
    micro-steps, of one card's; every replicated leaf bit-equal on every
    rank; every block E / n entities wide; every rank's "on" run K5 and K7
    once a micro-step and K6 never ("off": K5 and K6).

    Returns a report by optimizer (launches, ms a micro-step and the
    collectives' share by rank, peak memory by rank, the errors) and
    ``ok``. ``device`` "cpu" runs the same on CPU ranks, where no kernel
    launches."""
    import dataclasses
    import numpy as np
    from sert_tpu_torch.ops import _build
    from sert_tpu_torch.parallel.sharding import sharded_axis
    from sert_tpu_torch.parallel.train import state_specs
    if device == "cuda":
        _build.build()             # the ranks load it; none compiles
    rtol = FUSED_TP_RTOL
    one_card_rtol = FUSED_TP_ONE_CARD_RTOL[cfg.compute_dtype]
    batches = seeded_batches(cfg, tcfg, window, steps, seed)
    report, ok = {}, True
    with tempfile.TemporaryDirectory(prefix="sert-fused-") as tmp:
        jobs, ones = [], {}
        for opt in FUSED_TP_OPTS:
            t = dataclasses.replace(tcfg, optimizer=opt, steps_per_call=1,
                                    mesh_shape=(1, n))
            os.makedirs(os.path.join(tmp, opt))
            ones[opt] = _one_card_fused(cfg, t, batches,
                                        os.path.join(tmp, opt), device)
            jobs.append(("fused_tp_card", dict(
                cfg=cfg, tcfg=t, batches=batches, device=device,
                one_card=ones[opt]["paths"])))
        out = launch(n, "sert_tpu_torch.parallel.worlds:run_jobs", jobs,
                     timeout=600.0)
    k = steps if device == "cuda" else 0
    want = {"on": (k, 0, k), "off": (k, k, 0)}    # K5, K6, K7 a rank
    for j, opt in enumerate(FUSED_TP_OPTS):
        ranks = [r[j] for r in out]
        r0 = ranks[0]
        on, off, one = r0["on"], r0["off"], ones[opt]
        errs = {f"{key}_vs_{name}": _max_rel(on[key], other[key])
                for key in ("losses", "norms")
                for name, other in (("off", off), ("one_card", one))}
        # The worst micro-step against "off", and the first against one
        # card, leaf by leaf.
        leaves = {"vs_off": {}, "vs_one_card": {
            leaf: _leaf_parity([r["vs_one_card"] for r in ranks], leaf,
                               r0["sharded"][leaf]) for leaf in r0["blocks"]}}
        for i in range(steps):
            for leaf in r0["blocks"]:
                x = _leaf_parity([r["vs_off"][i] for r in ranks], leaf,
                                 r0["sharded"][leaf])
                w = leaves["vs_off"].setdefault(leaf, x)
                leaves["vs_off"][leaf] = {
                    k: (w[k] and x[k] if k == "moved" else
                        min(w[k], x[k]) if k == "skipped" else
                        max(w[k], x[k])) for k in x}
        specs = state_specs(cfg, dataclasses.replace(tcfg, optimizer=opt))
        limits = {"vs_off": rtol, "vs_one_card": one_card_rtol}
        leaves_ok = all(x["moved"] and x["rel_norm"] <= limits[which]
                        and (leaf not in specs["params"]
                             or x["skipped"] >= FUSED_TP_MIN_SKIPPED)
                        for which, v in leaves.items()
                        for leaf, x in v.items())
        axes = {name: sharded_axis(spec) for group in specs.values()
                for name, spec in group.items()}
        blocks_ok = all(
            r["blocks"][leaf][axes[leaf]] == cfg.num_entities // n
            for r in ranks for leaf in r["blocks"]
            if axes[leaf] is not None)
        replicas_ok = all(r["replica_hash"] == r0["replica_hash"]
                          for r in ranks)
        metrics_alike = all(r["on"]["losses"] == on["losses"]
                            and r["on"]["norms"] == on["norms"]
                            for r in ranks)
        through = all(
            (r[m]["launches"]["xent_fwd"], r[m]["launches"]["xent_bwd"],
             r[m]["launches"]["xent_bwd_apply"]) == want[m]
            for r in ranks for m in want)
        opt_ok = (through and blocks_ok and replicas_ok and metrics_alike
                  and leaves_ok and max(errs.values()) <= rtol)
        ok = ok and opt_ok
        report[opt] = {
            "ok": opt_ok, "launches_through_kernels": through,
            "blocks_ok": blocks_ok, "replicas_bit_equal": replicas_ok,
            "metrics_alike_on_ranks": metrics_alike,
            "leaves_within_rtol": leaves_ok,
            "errors": errs,
            "leaves": leaves,
            "launches": {m: [r[m]["launches"] for r in ranks]
                         for m in want},
            "ms_per_step": {m: [float(np.median(r[m]["ms"][1:]))
                                for r in ranks] for m in want},
            "collective_share": {
                m: [r[m]["collective_s"] * 1e3 / sum(r[m]["ms"])
                    for r in ranks] for m in want},
            "collective_calls_per_step": {
                m: r0[m]["collective_calls"] / steps for m in want},
            "peak_mem_bytes": {m: [r[m]["peak_mem_bytes"] for r in ranks]
                               for m in want},
            "losses": {"on": on["losses"], "off": off["losses"],
                       "one_card": one["losses"]}}
    return {"ok": ok, "ranks": n, "mesh": [1, n], "steps": steps,
            "compute_dtype": cfg.compute_dtype, "rtol": rtol,
            "one_card_rtol": one_card_rtol,
            "optimizers": report}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "sert_tpu_torch.parallel.dryrun")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 4))
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        tmp, rank, n = a.worker
        _worker(tmp, int(rank), int(n))
        return 0
    report = dryrun_multichip(a.ranks, tuple(a.mesh))
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
