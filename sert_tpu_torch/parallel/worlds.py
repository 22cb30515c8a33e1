"""Work run on every rank of a gloo world (``parallel.dryrun.launch``):
the sharded losses, steps, loop, feed, top-k and searcher on a mesh, from
numpy inputs, each returning numpy results that a caller holds against
one rank or against the reference. The ranks are CPU processes; the
losses also run on CUDA tensors (``spec["device"]``), every rank on the
same card, which gloo allows where NCCL does not.

:func:`run_jobs` runs a list of ``(function name, spec)`` jobs in one
world, so that one world of processes serves many cases. Every function
here takes a spec dict and returns a dict (or a list of them); full
tensors come back whole: sharded leaves gathered over ``model``, rows
gathered over ``data``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    from sert_tpu_torch.ops import sampled_lse, xent
    return {"sampled_lse_fwd": sampled_lse.fwd_launches,
            "sampled_lse_bwd": sampled_lse.bwd_launches,
            "xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches}


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


def train_steps(spec) -> dict:
    """``make_sharded_train_step`` of ``spec["cfg"]``, ``spec["tcfg"]`` on
    ``spec["mesh"]`` over ``spec["batches"]`` (global host batches), from
    ``spec["params"]`` (full numpy params; the step's own init where
    absent), with ``spec["negatives"]`` injected at every draw (drawn by
    the generator where absent): each step's loss and grad norm, the
    final full params and optimizer slots, and the draws this rank made."""
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
    with injected_negatives(spec.get("negatives"), record=draws):
        for b in spec["batches"]:
            state, m = step(state, put_fn(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    full = gather_state(state, mesh, specs)
    return {"losses": losses, "norms": norms, "draws": draws,
            "params": {k: _np(v) for k, v in full.params.items()},
            "opt": {k: (v if isinstance(v, int) else _np(v))
                    for k, v in full.opt_state.items()}}


def train_loop(spec) -> dict:
    """``pipeline.train_from_dir`` of ``spec["recipe"]`` on
    ``spec["data"]`` into ``spec["out"]`` on the CPU (each run of
    ``spec["runs"]``, a list of num_epochs, resumes the last): the final
    full params and step of each run, and the steps of the checkpoints
    this rank wrote."""
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.train import checkpoint as ckpt
    out, writes = [], []
    write = ckpt._write

    def counted(*args, **kw):
        writes.append(args[1])
        return write(*args, **kw)

    ckpt._write = counted
    try:
        for epochs in spec.get("runs", [None]):
            recipe = spec["recipe"]
            if epochs is not None:
                recipe = dataclasses.replace(
                    recipe, train=dataclasses.replace(recipe.train,
                                                      num_epochs=epochs))
            state, _ = pipeline.train_from_dir(recipe, spec["data"],
                                               spec["out"], device="cpu")
            out.append({"step": state.step,
                        "params": {k: _np(v)
                                   for k, v in state.params.items()}})
    finally:
        ckpt._write = write
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
