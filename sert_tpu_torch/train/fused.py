"""The optimizer-in-backward train step (port of ``sert_tpu/train/fused.py``:
``fused_applicable`` :76, ``fused_enabled`` :130, ``make_fused_train_step``
:237).

For the full-softmax families (log-linear, ``lse_full``) the step runs the
loss through ``ops.xent.xent_loss_apply``: K5 for the loss, then K7, whose
dW sweep applies adam, adagrad or sgd to its entity tile of the entity
matrix (``proj_w`` [d, E] or ``entity_emb`` [E, d]) and its optimizer
slots, in place, so the matrix's gradient never reaches device memory and
no separate optimizer pass reads it back. The small leaves (``word_emb``
and ``proj_b``; for ``lse_full`` ``word_emb``, ``proj_w`` and ``proj_b``)
take their gradients through autograd from the kernel's dpooled and go
through the dense step's own ``Optimizer.update``, on those leaves alone,
which advances adam's count once. The optimizer state keeps the dense
step's keys (``[0].mu['proj_w']``, ...), so a checkpoint resumes under
either mode and in either package.

Applicability, as the reference's: a full-softmax model, adam, adagrad or
sgd, no weight decay, no clipping (the global norm would need dW before
any update), a constant lr with no warmup (the kernel takes one lr),
adagrad's eps 1e-7 (baked into the kernel), one device and a width that
is a multiple of 128. The reference's VMEM plan (``fused_update_te``) is a
TPU limit and is not ported: the kernels' own limits take its place
(``ops.xent.kernel_limits``), so a batch the TPU refused (B = 32768) is
applicable here.

On a pure-TP mesh (data axis 1, ``fused_tp_applicable`` :83,
``fused_tp_enabled`` :99, ``make_fused_train_step(stitch=)``; "on" only)
every rank holds the whole batch, so the dW of its block of the entity
matrix is the complete gradient of those columns: K5 runs on the block,
the ranks stitch the lse and the gold logit over ``model``, and K7
updates the block and its slots in place
(``ops.xent.sharded_xent_apply``). Under data parallelism dW would have
to be summed over ``data`` before any update, the round trip the fusion
removes, so "on" raises there.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sert_tpu_torch.models import loglinear, lse
from sert_tpu_torch.models.common import use_fused
from sert_tpu_torch.ops.xent import (ADAGRAD_EPS, OPTIMIZERS, SLOTS,
                                     Stitch, kernel_limits,
                                     sharded_xent_apply, xent_loss_apply)
from sert_tpu_torch.train.step import (TrainState, has_schedule,
                                       make_optimizer, micro_step_calls)
from sert_tpu_torch.utils.config import ModelConfig, TrainConfig

# The optax state path of each of ops.xent's slots.
_SLOT_PATHS = {"m": "[0].mu", "v": "[0].nu", "acc": "[0].sum_of_squares"}


def _dim(model_cfg: ModelConfig) -> int:
    return (model_cfg.word_dim if model_cfg.model == "loglinear"
            else model_cfg.entity_dim)


def _semantics_ok(model_cfg: ModelConfig, train_cfg: TrainConfig) -> bool:
    """The part of the gates the mesh does not touch: the family, the
    optimizer, no decay or clipping, a constant lr, adagrad's eps and a
    width that is a multiple of 128 (module docstring)."""
    return (
        model_cfg.model in ("loglinear", "lse_full")
        and train_cfg.optimizer in OPTIMIZERS
        and train_cfg.weight_decay == 0.0
        and train_cfg.grad_clip_norm == 0.0
        and not has_schedule(train_cfg)
        and (train_cfg.optimizer != "adagrad"
             or train_cfg.adagrad_eps == ADAGRAD_EPS)
        and _dim(model_cfg) % 128 == 0)


def fused_applicable(model_cfg: ModelConfig, train_cfg: TrainConfig) -> bool:
    """True when the one-device fused step exists and matches the dense
    step's semantics (module docstring)."""
    return (tuple(train_cfg.mesh_shape) == (1, 1)
            and _semantics_ok(model_cfg, train_cfg)
            and kernel_limits(train_cfg.batch_size, model_cfg.num_entities,
                              _dim(model_cfg)) is None)


def fused_tp_applicable(model_cfg: ModelConfig, train_cfg: TrainConfig,
                        mesh_shape=None) -> bool:
    """True when the pure-TP step applies on a (data, model) mesh of
    ``mesh_shape`` (default ``train_cfg.mesh_shape``): data 1, model above
    1 and dividing the entity count, the one-device step's semantics, and
    the kernels' limits at a block's shape (B, E / tp, d)."""
    dp, tp = (tuple(mesh_shape) if mesh_shape is not None
              else tuple(train_cfg.mesh_shape))
    return (dp == 1 and tp > 1
            and model_cfg.num_entities % tp == 0
            and _semantics_ok(model_cfg, train_cfg)
            and kernel_limits(train_cfg.batch_size,
                              model_cfg.num_entities // tp,
                              _dim(model_cfg)) is None)


def fused_tp_enabled(model_cfg: ModelConfig, train_cfg: TrainConfig,
                     mesh) -> bool:
    """Whether the step on ``mesh`` (``parallel.mesh.Mesh``) is the
    pure-TP fused one. "off" and "auto" never (the reference keeps "auto"
    off on meshes: its one-device measurements do not carry over); "on"
    where :func:`fused_tp_applicable` holds, and a ValueError otherwise,
    never a silent fallback."""
    mode = train_cfg.fused_update
    if mode in ("off", "auto"):
        return False
    if mode != "on":
        raise ValueError(f"unknown fused_update mode: {mode!r}")
    shape = (mesh.shape["data"], mesh.shape["model"])
    if fused_tp_applicable(model_cfg, train_cfg, mesh_shape=shape):
        return True
    d = _dim(model_cfg)
    raise ValueError(
        "fused_update='on' on a mesh requires a pure-TP layout (data axis "
        "of size 1: under data parallelism dW must be summed over 'data' "
        "before any update, so the in-kernel update cannot apply), "
        "num_entities divisible by the model axis, model in (loglinear, "
        "lse_full), optimizer in (adam, adagrad, sgd), weight_decay=0, "
        "grad_clip_norm=0, a constant lr (no schedule or warmup), "
        "adagrad_eps=1e-7, a word/entity dim that is a multiple of 128, "
        "and the K5/K7 kernels' limits at a block's shape "
        "(ops.xent.kernel_limits); got "
        f"mesh={shape} model={model_cfg.model!r} "
        f"optimizer={train_cfg.optimizer!r} E={model_cfg.num_entities} "
        f"weight_decay={train_cfg.weight_decay} "
        f"grad_clip_norm={train_cfg.grad_clip_norm} "
        f"batch={train_cfg.batch_size} dim={d}")


def fused_enabled(model_cfg: ModelConfig, train_cfg: TrainConfig,
                  device=None) -> bool:
    """Whether the train step is the fused one. "auto" keeps the
    reference's rule: sgd only (its TPU A/B found the fusion a loss for
    adam and adagrad; the port's own ratios are in PERF.md), applicable,
    and only where the loss takes its kernel path, which
    ``models.common.use_fused`` decides on the params' ``device`` (None:
    the CPU). "on" is every applicable config, and a ValueError
    otherwise."""
    mode = train_cfg.fused_update
    if mode == "off":
        return False
    if mode == "auto":
        return (train_cfg.optimizer == "sgd"
                and fused_applicable(model_cfg, train_cfg)
                and use_fused(model_cfg, torch.device(device or "cpu")))
    if mode != "on":
        raise ValueError(f"unknown fused_update mode: {mode!r}")
    if not fused_applicable(model_cfg, train_cfg):
        d = _dim(model_cfg)
        limits = kernel_limits(train_cfg.batch_size, model_cfg.num_entities,
                               d)
        raise ValueError(
            "fused_update='on' requires model in (loglinear, lse_full), "
            "optimizer in (adam, adagrad, sgd), weight_decay=0, "
            "grad_clip_norm=0, a constant lr (no schedule or warmup: the "
            "kernel takes one lr), adagrad_eps=1e-7, mesh_shape=(1, 1) (on a "
            "pure-TP mesh: fused_tp_enabled), a word/entity dim "
            "that is a multiple of 128, and the K5/K7 kernels' limits "
            f"(ops.xent.kernel_limits: {limits or 'met'}); "
            f"got model={model_cfg.model!r} "
            f"optimizer={train_cfg.optimizer!r} "
            f"weight_decay={train_cfg.weight_decay} "
            f"grad_clip_norm={train_cfg.grad_clip_norm} "
            f"lr_schedule={train_cfg.lr_schedule!r} "
            f"lr_warmup_steps={train_cfg.lr_warmup_steps} "
            f"mesh={tuple(train_cfg.mesh_shape)} "
            f"batch={train_cfg.batch_size} dim={d}")
    return True


def make_fused_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                          stitch: Optional[Stitch] = None):
    """The fused step, with the dense ``train.step.make_train_step``'s
    contract: ``step(state, batch) -> (state, metrics)`` updating the
    params and the optimizer state in place, ``steps_per_call > 1`` a
    Python loop over the stacked batch's micro-steps, metrics the last
    micro-step's (loss and grad_norm as device tensors).

    With ``stitch`` (this rank's entity block on a pure-TP mesh, whose
    blocks it joins: ``parallel.fused_loss.model_stitch``;
    ``fused_tp_applicable`` must hold) the state is this rank's: its
    blocks of the entity matrix, of its slots and of ``proj_b``, the other
    leaves whole, and the batch is the whole batch. Metrics are global and
    alike on every rank."""
    cfg, opt_name = model_cfg, train_cfg.optimizer
    loglin = cfg.model == "loglinear"
    E = cfg.num_entities
    if stitch is None:
        if not fused_applicable(model_cfg, train_cfg):
            raise ValueError("fused step built for an inapplicable config; "
                             "see fused_applicable")
    else:
        if not fused_tp_applicable(model_cfg, train_cfg,
                                   mesh_shape=(1, stitch.parts)):
            raise ValueError("mesh fused step built for an inapplicable "
                             "config; see fused_tp_applicable")
        E //= stitch.parts
    opt = make_optimizer(train_cfg)          # the stock small-leaf update
    mat_key, layout = ("proj_w", "de") if loglin else ("entity_emb", "ed")
    head_keys = (("word_emb",) if loglin
                 else ("word_emb", "proj_w", "proj_b"))

    def micro_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        params, opt_state = state.params, state.opt_state
        # K7's adam count, read before the small leaves' update advances it.
        count = (opt_state[opt._key("[0].count")] if opt_name == "adam"
                 else state.step)
        B = batch["windows"].shape[0]
        leaves = {k: params[k].detach().requires_grad_(True)
                  for k in head_keys}
        with torch.enable_grad():
            if loglin:
                pooled = loglinear.pooled_rep(
                    leaves, batch["windows"], batch["lengths"], cfg).float()
            else:
                pooled = lse.window_rep(leaves, batch["windows"],
                                        batch["lengths"], cfg)
        W = params[mat_key]
        # lse_full's logits have no bias: a zero vector, not a parameter.
        bias = (params["proj_b"] if loglin else
                torch.zeros((E,), dtype=torch.float32, device=W.device))
        kw = dict(opt=opt_name,
                  opt_tree={s: opt_state[opt._key(_SLOT_PATHS[s], mat_key)]
                            for s in SLOTS[opt_name]},
                  lr=train_cfg.learning_rate, count=count, gscale=1.0 / B,
                  layout=layout, dtype=cfg.compute_dtype)
        if stitch is None:
            loss_sum, _, _, db, dpooled, gsq = xent_loss_apply(
                pooled.detach(), W, bias, batch["entities"], **kw)
        else:
            loss_sum, _, _, db, dpooled, gsq = sharded_xent_apply(
                pooled.detach(), W, bias, batch["entities"], stitch, **kw)
        # dpooled is the whole batch's on every rank, so the replicated
        # leaves' gradients are complete here: no sum over the mesh.
        grads = dict(zip(head_keys, torch.autograd.grad(
            pooled, [leaves[k] for k in head_keys], grad_outputs=dpooled)))
        if loglin:
            grads["proj_b"] = db        # lse_full's db is dropped
        opt.update(params, grads, opt_state)
        grads_sq = gsq
        for k, g in grads.items():
            sq = torch.sum(g.float() * g.float())
            if stitch is not None and k == "proj_b" and loglin:
                sq = stitch.reduce_sum(sq)          # a block of the entities
            grads_sq = grads_sq + sq
        state.step += 1
        return {"loss": loss_sum / B, "grad_norm": torch.sqrt(grads_sq)}

    return micro_step_calls(micro_step, train_cfg.steps_per_call)
