"""The losses of a train step on the mesh: each rank's partial of the
global mean loss, from its data block's rows and its model block of the
entity axis (port of ``sert_tpu/parallel/fused_loss.py``:
``make_sharded_fused_loss`` :30, ``make_sharded_sampled_loss`` :68, and of
the row gathers GSPMD partitions for the reference,
``sert_tpu/models/lse.py:139`` ``sampled_softmax_inputs``).

Every loss here returns the rank's partial (the mesh's convention,
``parallel/mesh.py``): the partials of all ranks sum to the global mean
loss over the global batch, each rank's value being its data block's
share divided by tp. The pooling front (word gather, masked mean, the tanh
projection) runs on each rank for its rows from the replicated word table;
the step sums the replicated leaves' gradients over the mesh. Where the
blocks split the softmax, the window reps' gradient is summed over
``model`` in fp32 before the front's backward rounds it to the compute
dtype (``parallel.mesh.grad_on_first``), where the reference's
shard_map transpose sums it.

  * full softmax (loglinear, lse_full): ``ops.xent.sharded_xent_loss``,
    K5/K6 per entity block (or their plain versions per block);
  * sampled softmax (lse, the flagship objective): the shared candidates'
    rows are gathered from the sharded entity table, and each rank runs
    the differentiable ``sampled_lse`` (K1 forward, K2 backward) on its
    [B/dp, k/tp] block, stitched with a max and a sum over ``model``. The
    [B, k] logits exist nowhere. Where tp does not divide k ("auto"), the
    candidate axis stays whole on every model rank, and each runs the
    single-card tail on its [B/dp, k] block (K1/K2 where the block's
    shapes allow);
  * NCE: the plain objective on the gathered rows (the reference has no
    kernel for it).

Every batch-shared draw is one draw: each rank's generator is seeded
alike and steps in lockstep, and nothing drawn depends on the rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from sert_tpu_torch.models import loglinear, lse as lse_model
from sert_tpu_torch.models.common import use_fused
from sert_tpu_torch.ops.sampled_lse import sampled_lse, sampled_lse_plain
from sert_tpu_torch.ops.xent import Stitch, sharded_xent_loss
from sert_tpu_torch.parallel.mesh import (Mesh, all_reduce_max,
                                          all_reduce_sum, grad_on_first)
from sert_tpu_torch.parallel.sharding import block
from sert_tpu_torch.utils.config import ModelConfig


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """[*ids.shape, d] rows of the entity table whose ``model`` blocks the
    ranks hold (``table`` this rank's block [E/tp, d], ``ids`` global):
    each rank gathers the rows it owns, zeros elsewhere, and a sum over
    ``model`` assembles them. The backward sums the incoming gradients over
    ``model`` and each rank keeps its own rows, duplicate ids summed in a
    fixed order (``F.embedding``'s backward, no float atomics)."""
    El = table.shape[0]
    loc = ids.long() - mesh.coords["model"] * El
    own = (loc >= 0) & (loc < El)
    rows = F.embedding(loc.clamp(0, El - 1), table)
    rows = rows * own.unsqueeze(-1).to(rows.dtype)
    return all_reduce_sum(rows, mesh, "model")


def model_stitch(mesh: Mesh, block_len: int) -> Stitch:
    """The ``ops.xent.Stitch`` of this rank's block of ``block_len``
    entities on the mesh's ``model`` axis."""
    return Stitch(mesh.coords["model"] * block_len, mesh.shape["model"],
                  lambda x: all_reduce_max(x, mesh, "model"),
                  lambda x: all_reduce_sum(x, mesh, "model"))


def _global_rows(batch, mesh: Mesh) -> int:
    return batch["windows"].shape[0] * mesh.shape["data"]


def make_sharded_fused_loss(cfg: ModelConfig, mesh: Mesh):
    """``loss_fn(params, batch, cfg, generator=None, noise=None)`` -> the
    rank's partial of the full-softmax loss for ``cfg.model`` in
    {"loglinear", "lse_full"}: K5/K6 per entity block where
    ``models.common.use_fused`` takes the block's shapes, else their plain
    versions.
    ValueError for another family, or an entity count the model axis does
    not divide."""
    if cfg.model not in ("loglinear", "lse_full"):
        raise ValueError(
            f"sharded fused softmax applies to full-softmax families only, "
            f"got {cfg.model!r}")
    tp = mesh.shape["model"]
    if cfg.num_entities % tp:
        raise ValueError(
            f"num_entities={cfg.num_entities} must divide the model axis "
            f"({tp}) for the sharded fused kernel; pad the entity count")
    El = cfg.num_entities // tp

    def loss_fn(params, batch, cfg_: ModelConfig, generator=None,
                noise=None) -> torch.Tensor:
        del generator, noise   # the full softmax samples nothing
        if cfg_.model == "loglinear":
            pooled = loglinear.pooled_rep(params, batch["windows"],
                                          batch["lengths"], cfg_).float()
            W, b, layout = params["proj_w"], params["proj_b"], "de"
        else:
            pooled = lse_model.window_rep(params, batch["windows"],
                                          batch["lengths"], cfg_)
            W, layout = params["entity_emb"], "ed"
            b = torch.zeros((El,), dtype=torch.float32, device=W.device)
        kernel = use_fused(dataclasses.replace(cfg_, num_entities=El),
                           pooled.device, pooled.shape[0])
        pooled = grad_on_first(pooled, mesh, "model")
        total = sharded_xent_loss(pooled, W, b, batch["entities"].long(),
                                  model_stitch(mesh, El), layout,
                                  cfg_.compute_dtype, kernel)
        return total / _global_rows(batch, mesh)

    return loss_fn


def _sampled_inputs(params, batch, cfg: ModelConfig, mesh: Mesh,
                    generator, noise, negatives):
    """(reps [B/dp, de], pos_rows, cand [k, de], corr [k], negatives [k],
    pos [B/dp]) with the rows gathered from the sharded table: the
    arguments of ``models.lse.sampled_softmax_tail``."""
    reps = lse_model.window_rep(params, batch["windows"], batch["lengths"],
                                cfg)
    table = params["entity_emb"].float()
    noise = lse_model.noise_or_uniform(noise, cfg, table.device)
    if negatives is None:
        negatives = lse_model.sample_negatives(generator, noise, 1, cfg)[0]
    negatives = negatives.long()
    pos = batch["entities"].long()
    return (reps, gather_rows(table, pos, mesh),
            gather_rows(table, negatives, mesh),
            lse_model.sampled_correction(noise, negatives), negatives, pos)


def make_sharded_sampled_loss(cfg: ModelConfig, mesh: Mesh):
    """``loss_fn(params, batch, cfg, generator=None, noise=None,
    negatives=None)`` -> the rank's partial of the sampled-softmax loss,
    the candidate axis split over ``model``: this rank's [B/dp, k/tp]
    block through ``sampled_lse`` (K1/K2 where ``models.common.use_fused``
    takes the block's shapes, else ``sampled_lse_plain``), the global
    masked lse stitched with a max and a sum over ``model``. ValueError
    for another objective, or a k that tp does not divide."""
    if cfg.model != "lse" or cfg.objective != "sampled_softmax":
        raise ValueError(
            "sharded fused sampled-lse applies to the lse family's "
            f"sampled_softmax objective only, got model={cfg.model!r} "
            f"objective={cfg.objective!r}")
    tp = mesh.shape["model"]
    if cfg.num_negatives % tp:
        raise ValueError(
            f"num_negatives={cfg.num_negatives} must divide the model axis "
            f"({tp}) for the sharded fused sampled-lse; pick a mesh-"
            "divisible candidate count")
    lo, hi = block(cfg.num_negatives, mesh)

    def loss_fn(params, batch, cfg_: ModelConfig, generator=None,
                noise=None, negatives=None) -> torch.Tensor:
        reps, pos_rows, cand, corr, negs, pos = _sampled_inputs(
            params, batch, cfg_, mesh, generator, noise, negatives)
        reps = grad_on_first(reps, mesh, "model")
        s_pos = torch.sum(reps * pos_rows, dim=-1)
        kernel = use_fused(
            dataclasses.replace(cfg_, num_negatives=hi - lo), reps.device,
            reps.shape[0])
        fn = sampled_lse if kernel else sampled_lse_plain
        # A block whose every candidate is masked for a row gives ~-1e30,
        # which vanishes under the exp.
        lse_l = fn(reps, cand[lo:hi], corr[lo:hi], negs[lo:hi], pos,
                   dtype=cfg_.compute_dtype)
        M = all_reduce_max(lse_l, mesh, "model")
        lse_g = M + torch.log(all_reduce_sum(torch.exp(lse_l - M), mesh,
                                             "model"))
        return (torch.sum(F.softplus(lse_g - s_pos))
                / (tp * _global_rows(batch, mesh)))

    return loss_fn


def make_replicated_loss(cfg: ModelConfig, mesh: Mesh):
    """``loss_fn(params, batch, cfg, generator=None, noise=None,
    negatives=None)`` -> the rank's partial of the LSE loss computed whole
    on every model rank from the gathered rows: the NCE objective (the
    batch's [B, k] negatives drawn whole, this data block's rows taken),
    or the sampled softmax with the candidate axis whole (where tp does
    not divide k): ``models.lse.sampled_softmax_tail`` on the [B/dp, k]
    block, K1/K2 where ``models.common.use_fused`` takes its shapes, as on
    one card."""
    if cfg.model != "lse":
        raise ValueError(f"the replicated loss is the lse family's, got "
                         f"{cfg.model!r}")
    tp, dp = mesh.shape["model"], mesh.shape["data"]

    def loss_fn(params, batch, cfg_: ModelConfig, generator=None,
                noise=None, negatives=None) -> torch.Tensor:
        B = _global_rows(batch, mesh)
        share = batch["windows"].shape[0] / (B * tp)
        if cfg_.objective == "sampled_softmax":
            return share * lse_model.sampled_softmax_tail(
                *_sampled_inputs(params, batch, cfg_, mesh, generator,
                                 noise, negatives), cfg_)
        if cfg_.objective != "nce":
            raise ValueError(f"unknown LSE objective: {cfg_.objective!r}")
        reps = lse_model.window_rep(params, batch["windows"],
                                    batch["lengths"], cfg_)
        table = params["entity_emb"].float()
        if negatives is None:
            negatives = lse_model.sample_negatives(
                generator, lse_model.noise_or_uniform(noise, cfg_,
                                                      table.device), B, cfg_)
        lo, hi = block(B, mesh, "data") if dp > 1 else (0, B)
        return share * lse_model.nce_tail(
            reps, gather_rows(table, batch["entities"], mesh),
            gather_rows(table, negatives[lo:hi], mesh))

    return loss_fn
