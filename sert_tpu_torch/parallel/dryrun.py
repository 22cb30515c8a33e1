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
# way, one bf16 step).
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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
