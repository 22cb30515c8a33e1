"""Work run on every rank of a gloo world (``parallel.dryrun.launch``):
the sharded losses, steps (the pure-TP fused step too), loop, feed, top-k
and searcher on a mesh, from numpy inputs, each returning numpy results
that a caller holds against one rank or against the reference. The ranks
are CPU processes; the losses and the pure-TP fused step also run on CUDA
tensors (``spec["device"]``), every rank on the same card, which gloo
allows where NCCL does not.

:func:`run_jobs` runs a list of ``(function name, spec)`` jobs in one
world, so that one world of processes serves many cases. Every function
here takes a spec dict and returns a dict (or a list of them); full
tensors come back whole: sharded leaves gathered over ``model``, rows
gathered over ``data``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from sert_tpu_torch.models import lse as lse_model
from sert_tpu_torch.parallel.mesh import (all_gather, all_reduce_sum,
                                          make_mesh, world_rank)
from sert_tpu_torch.parallel.sharding import (batch_rows, block,
                                              gather_state, gather_tensor,
                                              shard_state, shard_tensor,
                                              sharded_axis)
from sert_tpu_torch.parallel.train import (_finish, make_mesh_loss,
                                           make_sharded_train_step,
                                           state_specs)
from sert_tpu_torch.train.step import init_state


def run_jobs(jobs) -> List[Any]:
    """Each ``(name, spec)`` of ``jobs`` through the function of this
    module of that name, in order, on every rank; their results."""
    return [globals()[name](spec) for name, spec in jobs]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tensors(d, device="cpu") -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in d.items()}


def _launches() -> Dict[str, int]:
    """The kernels' launch counts so far in this process."""
    from sert_tpu_torch.ops import adam, sampled_lse, xent
    return {"sampled_lse_fwd": sampled_lse.fwd_launches,
            "sampled_lse_bwd": sampled_lse.bwd_launches,
            "xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches,
            "xent_bwd_apply": xent.apply_launches,
            "adam_update": adam.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in _launches().items()}


@contextlib.contextmanager
def injected_negatives(negatives, record=None):
    """``models.lse.sample_negatives`` returns ``negatives`` (reshaped to
    the draw asked for) while the block runs; with ``negatives`` None it
    draws as always, and each draw is appended to ``record``."""
    orig = lse_model.sample_negatives

    def fake(gen, noise, n, cfg):
        if negatives is None:
            out = orig(gen, noise, n, cfg)
        else:
            out = torch.from_numpy(np.asarray(negatives)).long().reshape(
                n, -1).to(noise.device)
        if record is not None:
            record.append(out.cpu().numpy())
        return out

    lse_model.sample_negatives = fake
    try:
        yield
    finally:
        lse_model.sample_negatives = orig


def mesh_shapes(spec) -> dict:
    """``make_mesh`` of each shape in ``spec["shapes"]`` on this world:
    the (data, model) it gives, or the ValueError's text."""
    out = []
    for shape in spec["shapes"]:
        try:
            m = make_mesh(tuple(shape), device="cpu")
            out.append([m.shape["data"], m.shape["model"]])
        except ValueError as e:
            out.append(str(e))
    return {"shapes": out}


def xent_loss(spec) -> dict:
    """``ops.xent.sharded_xent_loss`` on ``spec["mesh"]`` from the full
    pooled, W, b and labels: the global loss and the full gradients of
    pooled, W and b. On ``spec["device"]`` (the CPU by default), through
    K5/K6 per block where ``spec["fused"]``, else their plain versions."""
    from sert_tpu_torch.ops.xent import sharded_xent_loss
    from sert_tpu_torch.parallel.fused_loss import model_stitch
    dev = spec.get("device", "cpu")
    mesh = make_mesh(tuple(spec["mesh"]), device=dev)
    layout = spec["layout"]
    pooled, W, b = (torch.from_numpy(spec[k]) for k in ("pooled", "W", "b"))
    labels = torch.from_numpy(spec["labels"])
    r0, r1 = block(pooled.shape[0], mesh, "data")
    w_spec = (None, "model") if layout == "de" else ("model", None)
    W_l = shard_tensor(W, w_spec, mesh).to(dev).contiguous()
    b_l = shard_tensor(b, ("model",), mesh).to(dev).contiguous()
    p_l = pooled[r0:r1].to(dev).contiguous()
    leaves = [t.requires_grad_(True) for t in (p_l, W_l, b_l)]
    before = _launches()
    partial = sharded_xent_loss(
        leaves[0], leaves[1], leaves[2], labels[r0:r1].to(dev),
        model_stitch(mesh, W_l.shape[1 if layout == "de" else 0]), layout,
        spec.get("dtype", "float32"), fused=spec.get("fused", False))
    dp, dW, db = torch.autograd.grad(partial, leaves)
    launches = _since(before)
    dp = all_reduce_sum(dp, mesh, "model").cpu()
    dp = all_gather(dp, mesh, "data").reshape(pooled.shape)
    dW = gather_tensor(all_reduce_sum(dW, mesh, "data").cpu(), w_spec, mesh)
    db = gather_tensor(all_reduce_sum(db, mesh, "data").cpu(), ("model",),
                       mesh)
    loss = all_reduce_sum(partial.detach(), mesh, ("data", "model"))
    return {"loss": float(loss), "grads": [_np(dp), _np(dW), _np(db)],
            "launches": launches}


def xent_apply(spec) -> dict:
    """``ops.xent.sharded_xent_apply`` on the (1, world) mesh from the full
    pooled, W, b, labels and ``spec["slots"]`` (each rank its block of W,
    b and the slots), with ``spec["kw"]`` (opt, lr, count, gscale,
    layout, dtype): the loss, gsq and dpooled, and the full updated W,
    slots and db (gathered over ``model``)."""
    from sert_tpu_torch.ops.xent import sharded_xent_apply
    from sert_tpu_torch.parallel.fused_loss import model_stitch
    mesh = make_mesh((1, -1), device="cpu")
    kw = spec["kw"]
    w_spec = (None, "model") if kw["layout"] == "de" else ("model", None)

    def mine(x, s):
        return shard_tensor(torch.from_numpy(x), s, mesh).contiguous()

    W, b = mine(spec["W"], w_spec), mine(spec["b"], ("model",))
    slots = {k: mine(v, w_spec) for k, v in spec["slots"].items()}
    loss, W, slots, db, dpooled, gsq = sharded_xent_apply(
        torch.from_numpy(spec["pooled"]), W, b,
        torch.from_numpy(spec["labels"]), model_stitch(mesh, b.shape[0]),
        opt_tree=slots, **kw)
    return {"loss": float(loss), "gsq": float(gsq), "dpooled": _np(dpooled),
            "db": _np(gather_tensor(db, ("model",), mesh)),
            "W": _np(gather_tensor(W, w_spec, mesh)),
            "slots": {k: _np(gather_tensor(v, w_spec, mesh))
                      for k, v in slots.items()}}


def model_loss(spec) -> dict:
    """The mesh loss of ``spec["cfg"]`` (``parallel.train.make_mesh_loss``)
    on one global batch from full numpy params, with ``spec["negatives"]``
    injected (where given), on ``spec["device"]`` (the CPU by default):
    the global loss, every param's full gradient after the step's
    reduction, and the kernels this rank launched."""
    cfg, tcfg = spec["cfg"], spec["tcfg"]
    dev = spec.get("device", "cpu")
    mesh = make_mesh(tuple(spec["mesh"]), device=dev)
    specs = state_specs(cfg, tcfg)
    params = shard_state(
        dataclasses.replace(init_state(0, cfg, tcfg, "cpu",
                                       sparse_override=False),
                            params=_tensors(spec["params"])),
        mesh, cfg, specs).params
    batch = _tensors(batch_rows(spec["batch"], mesh), dev)
    names = sorted(params)
    leaves = {n: params[n].to(dev).detach().requires_grad_(True)
              for n in names}
    before = _launches()
    with injected_negatives(spec.get("negatives")):
        partial = make_mesh_loss(cfg, mesh)(
            leaves, batch, cfg, generator=torch.Generator().manual_seed(0))
    grads = dict(zip(names, torch.autograd.grad(
        partial, [leaves[n] for n in names])))
    axes = {n: sharded_axis(s) for n, s in specs["params"].items()}
    grads, loss = _finish(grads, partial.detach(), axes, mesh)
    launches = _since(before)
    return {"loss": float(loss), "launches": launches,
            "grads": {n: _np(gather_tensor(g.cpu(), specs["params"][n],
                                           mesh))
                      for n, g in grads.items()}}


def one_card_loss(spec) -> dict:
    """:func:`model_loss`'s results from the single-card loss
    (``models.api.loss_fn``) on full params, in this process alone."""
    from sert_tpu_torch.models import api
    cfg, dev = spec["cfg"], spec.get("device", "cpu")
    params = {n: t.requires_grad_(True)
              for n, t in _tensors(spec["params"], dev).items()}
    names = sorted(params)
    before = _launches()
    with injected_negatives(spec.get("negatives")):
        loss = api.loss_fn(params, _tensors(spec["batch"], dev), cfg,
                           generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return {"loss": loss.item(), "launches": _since(before),
            "grads": {n: _np(g) for n, g in zip(names, grads)}}


def _rows(batch, mesh, bdim: int = 0):
    return _tensors(batch_rows(batch, mesh, bdim))


def tensor_leaves(state) -> Dict[str, torch.Tensor]:
    """The params and the optimizer's tensor slots of a TrainState, by
    name (a param's name, or an optimizer state key)."""
    return {**state.params, **{k: v for k, v in state.opt_state.items()
                               if isinstance(v, torch.Tensor)}}


def train_steps(spec) -> dict:
    """``make_sharded_train_step`` of ``spec["cfg"]``, ``spec["tcfg"]`` on
    ``spec["mesh"]`` over ``spec["batches"]`` (global host batches), from
    ``spec["params"]`` (full numpy params; the step's own init where
    absent), with ``spec["negatives"]`` injected at every draw (drawn by
    the generator where absent): each step's loss and grad norm, the
    final full params and optimizer slots, the shapes of this rank's
    blocks of them, the draws this rank made and the kernels it
    launched."""
    cfg, tcfg = spec["cfg"], spec["tcfg"]
    mesh = make_mesh(tuple(spec["mesh"]), device="cpu")
    step, init_fn, put_fn = make_sharded_train_step(cfg, tcfg, mesh)
    specs = state_specs(cfg, tcfg)
    if spec.get("params") is not None:
        state = init_state(tcfg.seed, cfg, tcfg, "cpu",
                           sparse_override=False)
        state = shard_state(dataclasses.replace(
            state, params=_tensors(spec["params"])), mesh, cfg, specs)
    else:
        state = init_fn()
    losses, norms, draws = [], [], []
    before = _launches()
    with injected_negatives(spec.get("negatives"), record=draws):
        for b in spec["batches"]:
            state, m = step(state, put_fn(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    launches = _since(before)
    blocks = {k: tuple(v.shape) for k, v in tensor_leaves(state).items()}
    full = gather_state(state, mesh, specs)
    return {"losses": losses, "norms": norms, "draws": draws,
            "launches": launches, "blocks": blocks,
            "params": {k: _np(v) for k, v in full.params.items()},
            "opt": {k: (v if isinstance(v, int) else _np(v))
                    for k, v in full.opt_state.items()}}


@contextlib.contextmanager
def timed_collectives(sync):
    """[seconds, calls] of ``torch.distributed.all_reduce`` while the block
    runs (every collective of a train step), ``sync()`` called before and
    after each so that the time is the collective's, not that of the
    kernels it would wait for."""
    import torch.distributed as dist
    orig, spent = dist.all_reduce, [0.0, 0]

    def timed(*args, **kw):
        sync()
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        sync()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    dist.all_reduce = timed
    try:
        yield spent
    finally:
        dist.all_reduce = orig


def _diff_stats(got: torch.Tensor, want: torch.Tensor, base: torch.Tensor
                ) -> list:
    """How far ``got`` lies from ``want``, two results of one step from
    ``base``, measured on the step's change (Delta = result - base) beyond
    what the rounding of the stored results explains: two roundings put
    the stored values at most one storage step of ``want`` further apart
    than the exact ones, so each element's difference counts by its
    excess over that step. Returns [sum of squared excesses of Delta_got -
    Delta_want (= got - want), sum of squares of Delta_want, the same sum
    of excesses for a step that left the leaf as it was (got = base),
    largest absolute difference, elements more than one step apart,
    elements], the sums in fp64."""
    w = want.to(got.device)
    step = (torch.nextafter(w.abs(), torch.full_like(w, float("inf")))
            - w.abs()).double()
    b = w.double()
    diff = (got.double() - b).abs()
    excess = (diff - step).clamp_min(0.0)
    moved = b - base.to(got.device).double()
    skipped = (moved.abs() - step).clamp_min(0.0)
    return [float((excess ** 2).sum()), float((moved ** 2).sum()),
            float((skipped ** 2).sum()),
            float(diff.max()) if diff.numel() else 0.0,
            int((excess > 0).sum()), diff.numel()]


def _copy_state(state):
    return dataclasses.replace(
        state, params={k: v.clone() for k, v in state.params.items()},
        opt_state={k: v if isinstance(v, int) else v.clone()
                   for k, v in state.opt_state.items()})


def fused_tp_card(spec) -> dict:
    """The pure-TP fused step on ``spec["device"]``: ``spec["tcfg"]``'s
    ``make_sharded_train_step`` of ``spec["cfg"]`` on the (1, world) mesh
    with ``fused_update`` "on" over ``spec["batches"]`` (global host
    batches) from the step's own init; before each micro-step, a copy of
    the state takes the same micro-step through the dense sharded step
    ("off"). Returns, for each: the losses, grad norms, host ms a
    micro-step (each synced by reading its loss), seconds and calls in
    collectives (:func:`timed_collectives`), launches, and peak device
    memory (the state's, without the copy, and the micro-step's own).
    Also, for every param and slot this rank holds, :func:`_diff_stats`
    of "on" against "off" after each micro-step (the change from the state
    before it), and after the first against ``spec["one_card"]`` (``.npy``
    paths by leaf name of the one-card state then; this rank's block
    sliced out; the change from the initial state); whether each leaf is
    sharded, its block's shape, and a hash of each replicated leaf's bytes
    (every rank's must be equal)."""
    import hashlib
    cfg, tcfg = spec["cfg"], spec["tcfg"]
    dev = torch.device(spec.get("device", "cuda"))
    mesh = make_mesh((1, -1), device=dev)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    specs = state_specs(cfg, tcfg)
    axes = {name: sharded_axis(s) for group in specs.values()
            for name, s in group.items()}
    steps = {m: make_sharded_train_step(
        cfg, dataclasses.replace(tcfg, fused_update=m), mesh)
        for m in ("on", "off")}
    state = steps["on"][1]()
    batches = [steps["on"][2](b) for b in spec["batches"]]
    runs = {m: {"losses": [], "norms": [], "ms": [], "launches": {},
                "collective_s": 0.0, "collective_calls": 0,
                "peak_mem_bytes": 0} for m in steps}
    vs_off, vs_one = [], None
    for i, b in enumerate(batches):
        sync()
        resident = torch.cuda.memory_allocated(dev) if cuda else 0
        start_state, before = _copy_state(state), _copy_state(state)
        for mode, st in (("off", before), ("on", state)):
            run = runs[mode]
            sync()
            if cuda:
                start = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            n0 = _launches()
            with timed_collectives(sync) as coll:
                t0 = time.perf_counter()
                _, m = steps[mode][0](st, b)
                run["losses"].append(m["loss"].item())
                run["ms"].append((time.perf_counter() - t0) * 1e3)
                run["norms"].append(m["grad_norm"].item())
            for k, n in _since(n0).items():
                run["launches"][k] = run["launches"].get(k, 0) + n
            run["collective_s"] += coll[0]
            run["collective_calls"] += coll[1]
            if cuda:       # the state's, and the micro-step's own
                run["peak_mem_bytes"] = max(
                    run["peak_mem_bytes"], resident
                    + torch.cuda.max_memory_allocated(dev) - start)
        on, off = tensor_leaves(state), tensor_leaves(before)
        base = tensor_leaves(start_state)
        vs_off.append({k: _diff_stats(t, off[k], base[k])
                       for k, t in on.items()})
        del before, off
        if i == 0:
            vs_one = {}
            for k, t in on.items():
                full = np.load(spec["one_card"][k], mmap_mode="r")
                if axes[k] is not None:
                    lo, hi = block(full.shape[axes[k]], mesh)
                    full = full[(slice(None),) * axes[k] + (slice(lo, hi),)]
                vs_one[k] = _diff_stats(t, torch.from_numpy(
                    np.ascontiguousarray(full)), base[k])
        del start_state, base
    on = tensor_leaves(state)
    return {"rank": world_rank(), **runs, "vs_off": vs_off,
            "vs_one_card": vs_one,
            "sharded": {k: axes[k] is not None for k in on},
            "blocks": {k: tuple(t.shape) for k, t in on.items()},
            "replica_hash": {k: hashlib.sha256(t.cpu().numpy().tobytes())
                             .hexdigest() for k, t in on.items()
                             if axes[k] is None}}


def train_loop(spec) -> dict:
    """``pipeline.train_from_dir`` of ``spec["recipe"]`` on
    ``spec["data"]`` into ``spec["out"]`` on the CPU (each run of
    ``spec["runs"]`` resumes the last; a run is a num_epochs, or a dict of
    TrainConfig fields to set): the final full params and step of each
    run and the fused steps it built on a mesh, and the steps of the
    checkpoints this rank wrote."""
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.train import checkpoint as ckpt
    from sert_tpu_torch.train import fused
    out, writes, built = [], [], []
    write, make_fused = ckpt._write, fused.make_fused_train_step

    def counted(*args, **kw):
        writes.append(args[1])
        return write(*args, **kw)

    def counted_fused(*args, **kw):
        built.append(kw.get("stitch") is not None)
        return make_fused(*args, **kw)

    ckpt._write, fused.make_fused_train_step = counted, counted_fused
    try:
        for run in spec.get("runs", [None]):
            recipe = spec["recipe"]
            if run is not None:
                fields = run if isinstance(run, dict) else {
                    "num_epochs": run}
                recipe = dataclasses.replace(
                    recipe, train=dataclasses.replace(recipe.train,
                                                      **fields))
            n = len(built)
            state, _ = pipeline.train_from_dir(recipe, spec["data"],
                                               spec["out"], device="cpu")
            out.append({"step": state.step,
                        "fused_mesh_steps": sum(built[n:]),
                        "params": {k: _np(v)
                                   for k, v in state.params.items()}})
    finally:
        ckpt._write, fused.make_fused_train_step = write, make_fused
    return {"rank": world_rank(), "runs": out, "writes": writes}


def feed_steps(spec) -> dict:
    """A sharded step fed per data rank (``iter_batches`` in reader mode,
    this rank's reader (d, dp)) and the same step fed replicated (every
    rank reads ``iter_global_batches`` and keeps its rows) over
    ``spec["steps"]`` steps of ``spec["data"]``: both runs' losses and
    final full params."""
    from sert_tpu_torch.data.instances import InstanceDataset
    cfg, tcfg = spec["cfg"], spec["tcfg"]
    mesh = make_mesh(tuple(spec["mesh"]), device="cpu")
    dp = mesh.shape["data"]
    ds = InstanceDataset(spec["data"], seed=0)
    local = tcfg.batch_size // dp
    specs = state_specs(cfg, tcfg)
    out = {}
    for mode in ("per_process", "replicated"):
        step, init_fn, put_fn = make_sharded_train_step(
            cfg, tcfg, mesh, per_process_feed=mode == "per_process")
        state = init_fn()
        if mode == "per_process":
            it = ds.iter_batches(local, epoch=0,
                                 readers=(mesh.coords["data"], dp))
        else:
            it = ds.iter_global_batches(local, epoch=0, num_readers=dp)
        losses = []
        for _, (batch, _cur) in zip(range(spec["steps"]), it):
            state, m = step(state, put_fn(batch))
            losses.append(float(m["loss"]))
        full = gather_state(state, mesh, specs)
        out[mode] = {"losses": losses,
                     "params": {k: _np(v) for k, v in full.params.items()}}
    return out


def topk(spec) -> list:
    """``distributed_topk`` for each case of ``spec["cases"]`` on
    ``spec["mesh"]`` from full numpy params (sharded first where a case
    says ``sharded``): (scores, ids), or the ValueError's text."""
    from sert_tpu_torch.parallel.sharding import shard_params
    from sert_tpu_torch.parallel.topk import distributed_topk
    mesh = make_mesh(tuple(spec["mesh"]), device="cpu")
    out = []
    for c in spec["cases"]:
        params = _tensors(c["params"])
        if c.get("sharded"):
            params = shard_params(params, mesh, c["cfg"])
        try:
            s, i = distributed_topk(
                params, c["cfg"], torch.from_numpy(c["term_ids"]),
                torch.from_numpy(c["num_terms"]), mesh, k=c["k"],
                chunk=c.get("chunk", 8), merge=c["merge"],
                local_engine=c["engine"])
            out.append((_np(s), i.numpy()))
        except ValueError as e:
            out.append(str(e))
    return out


def searcher(spec) -> dict:
    """An ``EntitySearcher`` of ``spec["recipe"]`` (the distributed engine)
    over the run ``spec["run"]`` on every rank: rank 0 answers
    ``spec["queries"]`` with ``search_many`` and folds in
    ``spec["fold"]`` by the gradient method (the trained rows' sample
    travels as a rows message), then releases the others, which follow."""
    from sert_tpu_torch.serving import EntitySearcher
    s = EntitySearcher(spec["recipe"], spec["data"], spec["run"], k=10,
                       device="cpu")
    if world_rank() != 0:
        s.follow()
        return {"rank": world_rank()}
    try:
        hits = s.search_many(spec["queries"])
        added = (s.add_entities(spec["fold"], method="gradient")
                 if spec.get("fold") else 0)
        after = s.search_many(spec["queries"])
    finally:
        s.close()
    # The fold-in filled the trained rows' cache: no message goes out.
    return {"rank": 0, "hits": hits, "added": added, "after": after,
            "stats": s._trained_stats() if added else None}
