"""The train step on the mesh (port of ``sert_tpu/parallel/train.py``:
``_want_fused_sampled`` :33,
``make_sharded_train_step`` :57, ``_finish`` :111).

The reference jits the single-device step with NamedShardings and lets
GSPMD insert the collectives. Here each rank runs the step on its data
block's rows and its model block of every entity-axis leaf, and the
collectives are written out: the loss is the rank's partial
(``parallel/fused_loss.py``), autograd gives the rank's gradients, and
:func:`_finish`'s reduction sums them as the reference's shard_map
transpose does: every leaf over ``data`` (the DP all-reduce), and a leaf
replicated over ``model`` (the word table, the LSE projection) over
``model`` too. The optimizer then updates each rank's blocks in place;
its global norm and adafactor's factored means sum the sharded leaves
over ``model`` (``train.step.ShardInfo``).

With ``fused_update="on"`` on a pure-TP mesh (data axis 1) the step is
instead ``train/fused.py``'s per entity block (the reference's :72-81):
K5 and K7 on the block, the optimizer applied inside K7, so no gradient
of the entity matrix leaves its rank; the collectives are the stitch's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sert_tpu_torch.models import api
from sert_tpu_torch.parallel.fused_loss import (make_replicated_loss,
                                                make_sharded_fused_loss,
                                                make_sharded_sampled_loss,
                                                model_stitch)
from sert_tpu_torch.parallel.mesh import WORLD, Mesh, all_reduce_sum
from sert_tpu_torch.parallel.sharding import (batch_rows, shard_state,
                                              sharded_axis, state_shardings)
from sert_tpu_torch.train import fused
from sert_tpu_torch.train.step import (Optimizer, ShardInfo, TrainState,
                                       check_optimizer_model_fit,
                                       global_norm, init_state,
                                       make_train_step, micro_step_calls)
from sert_tpu_torch.utils.config import ModelConfig, TrainConfig


def _want_fused_sampled(model_cfg: ModelConfig, mesh: Mesh) -> bool:
    """Whether the sampled softmax splits its candidates over ``model``
    (``make_sharded_sampled_loss``): "on" always (the maker raises on a k
    that tp does not divide), otherwise where tp divides k. Where it does
    not, the candidate axis stays whole on every model rank (where the
    reference runs its XLA composition on a mesh)."""
    if model_cfg.model != "lse" or model_cfg.objective != "sampled_softmax":
        return False
    if model_cfg.fused_softmax == "on":
        return True
    return model_cfg.num_negatives % mesh.shape["model"] == 0


def make_mesh_loss(model_cfg: ModelConfig, mesh: Mesh):
    """The rank's partial loss for ``model_cfg`` on ``mesh``: the sharded
    full softmax (loglinear, lse_full), the sampled softmax split over
    ``model`` where :func:`_want_fused_sampled` holds, else the LSE loss
    whole on every model rank (NCE, or a k that tp does not divide)."""
    if model_cfg.model in ("loglinear", "lse_full"):
        return make_sharded_fused_loss(model_cfg, mesh)
    if _want_fused_sampled(model_cfg, mesh):
        return make_sharded_sampled_loss(model_cfg, mesh)
    return make_replicated_loss(model_cfg, mesh)


def _meta_state(model_cfg: ModelConfig, train_cfg: TrainConfig
                ) -> TrainState:
    """The full dense state's shapes: params and slots on the meta
    device."""
    params = api.init_params(torch.Generator(), model_cfg, "meta")
    return TrainState(params, Optimizer(train_cfg).init(params), 0, None)


def state_specs(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """:func:`parallel.sharding.state_shardings` of the full dense state,
    from shapes alone."""
    return state_shardings(_meta_state(model_cfg, train_cfg), model_cfg)


def make_sharded_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                            mesh: Mesh, noise=None,
                            per_process_feed: bool = False):
    """(train_step, init_fn, put_fn) on ``mesh``: ``init_fn()`` is this
    rank's blocks of the fresh state (every rank draws the full state from
    the same seed and keeps its blocks; the generator that draws the
    negatives is then alike on every rank), ``put_fn(batch)`` this rank's
    rows of a host batch as tensors on the mesh's device, and
    ``train_step(state, batch)`` the step with the contract of
    ``train.step.make_train_step``'s (metrics: the global loss and grad
    norm, alike on every rank).

    ``per_process_feed``: ``put_fn`` takes this data rank's rows already
    (B/dp of them; the loop's reader mode), not the global batch.

    The step, in the reference's order: on a mesh of one rank with
    ``fused_update`` or ``sparse_update`` "on", the one-card step
    (``make_train_step``: the fused step, K5 + K7, or the row-sparse lazy
    one) on its own state; on a pure-TP mesh with ``fused_update="on"``,
    the fused step per entity block (``train.fused.make_fused_train_step``
    with this rank's ``model_stitch``; "on" elsewhere on a mesh raises);
    otherwise the dense step on this rank's blocks. ``sparse_update="on"``
    on a mesh larger than one rank raises, as the reference's gate refuses
    a mesh."""
    check_optimizer_model_fit(model_cfg, train_cfg)
    one_rank = mesh.size == 1 and "on" in (train_cfg.fused_update,
                                           train_cfg.sparse_update)
    specs = state_specs(model_cfg, train_cfg)
    if one_rank:
        step = make_train_step(model_cfg, train_cfg, noise=noise,
                               device=mesh.device)
    elif fused.fused_tp_enabled(model_cfg, train_cfg, mesh):
        step = fused.make_fused_train_step(
            model_cfg, train_cfg, stitch=model_stitch(
                mesh, model_cfg.num_entities // mesh.shape["model"]))
    elif mesh.size > 1 and train_cfg.sparse_update == "on":
        raise ValueError(
            "sparse_update='on' needs mesh_shape=(1, 1): the row-sparse "
            "step is single-device")
    else:
        step = _dense_step(model_cfg, train_cfg, mesh, specs, noise)

    def init_fn() -> TrainState:
        if one_rank:       # the one-card step's state: dense or row-sparse
            return init_state(train_cfg.seed, model_cfg, train_cfg,
                              mesh.device)
        state = init_state(train_cfg.seed, model_cfg, train_cfg, mesh.device,
                           sparse_override=False)
        return shard_state(state, mesh, model_cfg, specs)

    bdim = 1 if train_cfg.steps_per_call > 1 else 0

    def put_fn(batch):
        if per_process_feed:
            n = next(iter(batch.values())).shape[bdim]
            if n * mesh.shape["data"] != train_cfg.batch_size:
                raise ValueError(
                    f"local batch rows {n} must be the data rank's share "
                    f"of batch_size {train_cfg.batch_size}")
        else:
            batch = batch_rows(batch, mesh, bdim)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
                for k, v in batch.items()}

    return step, init_fn, put_fn


def _dense_step(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh,
                specs, noise):
    """The dense step on this rank's blocks: the mesh loss's partial,
    autograd, :func:`_finish`'s reduction, the optimizer on the blocks."""
    loss_fn = make_mesh_loss(model_cfg, mesh)
    meta = _meta_state(model_cfg, train_cfg)
    shards = ShardInfo(
        axes={n: sharded_axis(s) for n, s in specs["params"].items()},
        shapes={n: tuple(t.shape) for n, t in meta.params.items()},
        model_sum=lambda x: all_reduce_sum(x, mesh, "model"))
    opt = Optimizer(train_cfg, shards=shards)

    def micro_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        names = sorted(state.params)
        leaves = {n: state.params[n].detach().requires_grad_(True)
                  for n in names}
        partial = loss_fn(leaves, batch, model_cfg,
                          generator=state.generator, noise=noise)
        grads = dict(zip(names, torch.autograd.grad(
            partial, [leaves[n] for n in names])))
        grads, loss = _finish(grads, partial.detach(), shards.axes, mesh)
        grad_norm = global_norm(grads, shards)
        opt.update(state.params, grads, state.opt_state)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return micro_step_calls(micro_step, train_cfg.steps_per_call)


@torch.no_grad()
def _finish(grads, partial: torch.Tensor, axes, mesh: Mesh):
    """(gradients, global loss) from this rank's gradients and partial
    loss: a leaf replicated over ``model`` (``axes[name]`` None) sums its
    gradient over the whole mesh, a sharded leaf over ``data``; the
    partials sum over the whole mesh. Each group's tensors travel flat in
    fp32 in one collective and come back in their own dtype."""
    if mesh.size == 1:
        return grads, partial
    names = sorted(grads)
    rep = [n for n in names if axes[n] is None]
    split = [n for n in names if axes[n] is not None]
    out = dict(grads)

    def reduce(keys, axis, extra=()):
        flat = torch.cat([grads[n].float().reshape(-1) for n in keys]
                         + [t.float().reshape(-1) for t in extra])
        flat = all_reduce_sum(flat, mesh, axis)
        at = 0
        for n in keys:
            g = grads[n]
            out[n] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
            at += g.numel()
        return flat[at:]

    loss = reduce(rep, WORLD, extra=(partial,))[0]
    if split:
        reduce(split, "data")
    return out, loss
