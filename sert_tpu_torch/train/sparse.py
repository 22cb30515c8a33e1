"""Row-sparse (lazy) optimizer step for the sampled-objective LSE model
(port of ``sert_tpu/train/sparse.py``: ``sparse_applicable`` :54,
``sparse_enabled`` :66, ``_dedup_rows`` :97, ``_row_state_init`` :122,
``_row_update`` :139, ``_forward`` :184, ``init_sparse_opt_state`` :227,
``_dense_opt`` :234, ``make_sparse_train_step`` :253).

The sampled objectives touch B + k entity rows (B * (k + 1) for NCE) and
at most B * w word rows a step. The dense step's autograd writes dense
[E, d] / [V, d] gradients and its optimizer reads and rewrites every
moment; this step differentiates with respect to the GATHERED rows only,
combines duplicate rows (a stable sort and an ordered segment sum, in the
gradient's dtype, with no atomics, so two runs give the same bits) and
updates those rows' params and optimizer state in place.

Lazy semantics, as the reference's: sgd and adagrad give the dense
update's values (their update is zero where the gradient is); adam is
standard-lazy: rows a step does not touch keep their moments frozen
instead of decaying, so it equals the dense step only where every row is
touched.

The state is flat like the dense step's, keyed by the reference's tree
paths below ``.opt_state``: ``['dense'][0].mu['proj_w']``,
``['dense'][0].count``, ... for the dense leaves (``proj_w``, ``proj_b``,
the port's ``Optimizer`` with no clip chain) and
``['rows']['entity_emb']['m']``, ``['rows']['word_emb']['acc']``, ...
for the row state, so that either package resumes the other's
checkpoints.

On the card the sampled softmax's loss goes through K1/K2 (the tail the
dense loss also ends in, ``models.lse.sampled_softmax_tail``), so the
[B, k] logits never reach memory; NCE is plain PyTorch, as in the
reference. The de-duplication and the row updates are plain PyTorch on
either device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sert_tpu_torch.models import lse as lse_model
from sert_tpu_torch.models.common import (Params, compute_dtype,
                                          masked_mean_pool)
from sert_tpu_torch.train.step import (Optimizer, TrainState, make_lr,
                                       micro_step_calls, scalar)
from sert_tpu_torch.utils.config import ModelConfig, TrainConfig

_DENSE_KEYS = ("proj_w", "proj_b")
_SPARSE_KEYS = ("word_emb", "entity_emb")
_DENSE_PREFIX = "['dense']"
_ROW_STATE = {"adam": ("m", "v"), "adagrad": ("acc",), "sgd": ()}
B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.scale_by_adam's defaults


def sparse_applicable(model_cfg: ModelConfig, train_cfg: TrainConfig) -> bool:
    """Whether the lazy step exists for the config: LSE with a sampled
    objective, adam, adagrad or sgd, no weight decay, one device."""
    return (
        model_cfg.model == "lse"
        and model_cfg.objective in ("nce", "sampled_softmax")
        and train_cfg.optimizer in ("adam", "adagrad", "sgd")
        and train_cfg.weight_decay == 0.0
        and tuple(train_cfg.mesh_shape) == (1, 1)
    )


def sparse_enabled(model_cfg: ModelConfig, train_cfg: TrainConfig) -> bool:
    """``sparse_update``: "off" never; "on" always, raising ValueError
    where the step does not apply; "auto" for adagrad and sgd where it
    applies (they equal the dense update), never for adam (the reference
    measured standard-lazy adam below dense adam in quality)."""
    mode = train_cfg.sparse_update
    if mode == "off":
        return False
    if mode == "auto":
        return (train_cfg.optimizer != "adam"
                and sparse_applicable(model_cfg, train_cfg))
    if mode == "on":
        if not sparse_applicable(model_cfg, train_cfg):
            raise ValueError(
                "sparse_update='on' requires model='lse' with a sampled "
                "objective, optimizer in (adam, adagrad, sgd), "
                "weight_decay=0, and mesh_shape=(1, 1); got "
                f"model={model_cfg.model!r} objective={model_cfg.objective!r} "
                f"optimizer={train_cfg.optimizer!r} "
                f"weight_decay={train_cfg.weight_decay} "
                f"mesh={tuple(train_cfg.mesh_shape)}")
        return True
    raise ValueError(f"unknown sparse_update mode: {mode!r}")


# ---------------------------------------------------------------------------
# Row bookkeeping


def _dedup_rows(ids: torch.Tensor, grads: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine duplicate row ids: a stable sort, then an ordered segment
    sum in ``grads``' dtype.

    ``ids`` int [N], ``grads`` [N, d] (per-slot gradients, duplicates not
    yet combined). Returns (ids_u int64 [N], g_u [N, d], valid bool [N]):
    slot j < n_unique holds the j-th smallest distinct id and its summed
    gradient, in slot order; every later slot is padding (``valid``
    False), with zero gradient and slot 0's id, so that an update which
    gives it slot 0's new values writes the same bits twice. n_unique
    stays on the device: nothing here waits for it."""
    n = ids.shape[0]
    sid, order = torch.sort(ids.long(), stable=True)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, dim=0) - 1                        # [N]
    slots = torch.arange(n, device=ids.device)
    lengths = (torch.searchsorted(seg, slots, right=True)
               - torch.searchsorted(seg, slots))
    # One thread a (segment, column) adds the segment's rows in order, on
    # the CPU and on the card alike; an empty segment sums to 0.
    g_u = torch.segment_reduce(grads[order], "sum", lengths=lengths,
                               axis=0, unsafe=True)
    ids_u = sid[:1].repeat(n).scatter_(0, seg, sid)
    return ids_u, g_u, slots <= seg[-1]


def _row_key(leaf: str, name: str) -> str:
    return f"['rows']['{leaf}']['{name}']"


def _row_state_init(params: Params, train_cfg: TrainConfig) -> Dict:
    """Per-row optimizer state of the embedding tables, in the shapes and
    dtypes optax allocates densely: adam's m and v (zeros), adagrad's acc
    (``adagrad_init_accumulator``), nothing for sgd."""
    out = {}
    for leaf in _SPARSE_KEYS:
        p = params[leaf]
        for name in _ROW_STATE[train_cfg.optimizer]:
            out[_row_key(leaf, name)] = (
                torch.full_like(p, train_cfg.adagrad_init_accumulator)
                if name == "acc" else torch.zeros_like(p))
    return out


@torch.no_grad()
def _row_update(train_cfg: TrainConfig, param: torch.Tensor,
                st: Dict[str, torch.Tensor], ids_u: torch.Tensor,
                g_u: torch.Tensor, valid: torch.Tensor, lr: float,
                t: int) -> None:
    """One lazy optimizer step, in place, on the rows ``ids_u`` names
    (``_dedup_rows``' output), with optax's arithmetic: ``st`` maps the
    row state's names (m, v / acc) to their tables. Padding slots write
    slot 0's new values to slot 0's row."""
    def put(table: torch.Tensor, new: torch.Tensor) -> None:
        table[ids_u] = torch.where(valid[:, None], new, new[:1])

    kind = train_cfg.optimizer
    g = g_u.float()
    if kind == "sgd":
        upd = -lr * g
    elif kind == "adagrad":
        acc_new = st["acc"][ids_u] + g_u * g_u
        inv = torch.where(acc_new > 0, torch.rsqrt(
            acc_new.float() + train_cfg.adagrad_eps), 0.0)
        upd = -lr * g * inv
        put(st["acc"], acc_new.to(st["acc"].dtype))
    else:
        # optax.scale_by_adam (eps_root 0): the moments in their dtype, with
        # the decay constants rounded to it (``step.scalar``); the bias
        # corrections in fp32.
        c = functools.partial(scalar, dtype=st["m"].dtype)
        m_new = c(B1) * st["m"][ids_u] + c(1.0 - B1) * g_u
        v_new = c(B2) * st["v"][ids_u] + c(1.0 - B2) * (g_u * g_u)
        # As device tensors: CUDA divides by a Python scalar as a multiply
        # by its reciprocal, the CPU divides; both divide by a tensor.
        bc1, bc2 = (torch.full((), float(1 - np.float32(b) ** np.float32(t)),
                               device=g.device) for b in (B1, B2))
        m_hat = m_new.float() / bc1
        v_hat = v_new.float() / bc2
        # The square root in fp64, rounded to fp32, is the correctly rounded
        # fp32 root on either device; torch's fp32 sqrt on CUDA is not.
        upd = -lr * m_hat / (torch.sqrt(v_hat.double()).float() + EPS)
        put(st["m"], m_new.to(st["m"].dtype))
        put(st["v"], v_new.to(st["v"].dtype))
    put(param, param[ids_u] + upd.to(param.dtype))


# ---------------------------------------------------------------------------
# The loss on gathered rows


def _forward(dense_p: Params, word_rows: torch.Tensor,
             ent_rows: torch.Tensor, batch, negatives: torch.Tensor,
             corr: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """The LSE sampled loss as a function of the gathered rows: the
    windows' word rows [B, w, dw], and the entity rows [B + k, de] of the
    positives then the candidates (sampled softmax, ``corr`` their
    correction) or [B (k + 1), de] of the positives then each example's
    negatives (NCE, ``corr`` None). The same function as
    ``models.lse.loss`` / ``loss_sampled_softmax`` (casts commute with
    gathers), whose tails it calls."""
    pooled = masked_mean_pool(word_rows.to(compute_dtype(cfg)),
                              batch["lengths"])
    reps = lse_model.project(pooled, dense_p, cfg)
    B = reps.shape[0]
    ent = ent_rows.float()
    if cfg.objective == "sampled_softmax":
        return lse_model.sampled_softmax_tail(
            reps, ent[:B], ent[B:], corr, negatives,
            batch["entities"].long(), cfg)
    return lse_model.nce_tail(reps, ent[:B],
                              ent[B:].reshape(B, cfg.num_negatives, -1))


# ---------------------------------------------------------------------------
# State + step


def _dense_opt(train_cfg: TrainConfig) -> Optimizer:
    """The dense leaves' optimizer: bare (the global-norm clip takes in the
    row gradients too and is applied here; weight decay is refused), its
    state under ``['dense']``, its lr the schedule at its own count."""
    return Optimizer(dataclasses.replace(train_cfg, grad_clip_norm=0.0,
                                         weight_decay=0.0),
                     prefix=_DENSE_PREFIX)


def init_sparse_opt_state(params: Params, train_cfg: TrainConfig) -> Dict:
    """The dense leaves' optimizer state under ``['dense']`` and the
    embedding tables' row state under ``['rows']``."""
    dense_p = {k: params[k] for k in _DENSE_KEYS}
    return {**_dense_opt(train_cfg).init(dense_p),
            **_row_state_init(params, train_cfg)}


def make_sparse_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                           noise: Optional[torch.Tensor] = None):
    """The lazy step, with ``train.step.make_train_step``'s contract
    (in place; ``steps_per_call > 1`` takes a stacked batch). ``noise``:
    the negative-sampling logits, on the params' device (None: uniform)."""
    if not sparse_applicable(model_cfg, train_cfg):
        raise ValueError("sparse step built for an inapplicable config; "
                         "see sparse_applicable")
    cfg = model_cfg
    opt = _dense_opt(train_cfg)
    lr_of = make_lr(train_cfg)
    names = _ROW_STATE[train_cfg.optimizer]
    clip = train_cfg.grad_clip_norm

    def micro_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        params = state.params
        dev = params["entity_emb"].device
        nz = lse_model.noise_or_uniform(noise, cfg, dev)
        windows, pos = batch["windows"].long(), batch["entities"].long()
        B = windows.shape[0]
        if cfg.objective == "sampled_softmax":
            negatives = lse_model.sample_negatives(
                state.generator, nz, 1, cfg)[0].long()          # [k]
            corr = lse_model.sampled_correction(nz, negatives)
            ent_idx = torch.cat([pos, negatives])
        else:
            negatives = lse_model.sample_negatives(
                state.generator, nz, B, cfg).long()             # [B, k]
            corr = None
            ent_idx = torch.cat([pos, negatives.reshape(-1)])

        word_rows = params["word_emb"][windows].requires_grad_(True)
        ent_rows = params["entity_emb"][ent_idx].requires_grad_(True)
        dense_p = {k: params[k].detach().requires_grad_(True)
                   for k in _DENSE_KEYS}
        loss = _forward(dense_p, word_rows, ent_rows, batch, negatives,
                        corr, cfg)
        *g_d, g_w, g_e = torch.autograd.grad(
            loss, [dense_p[k] for k in _DENSE_KEYS] + [word_rows, ent_rows])
        g_dense = dict(zip(_DENSE_KEYS, g_d))
        rows = {
            "word_emb": _dedup_rows(windows.reshape(-1),
                                    g_w.reshape(-1, g_w.shape[-1])),
            "entity_emb": _dedup_rows(ent_idx, g_e)}

        # The dense path's global norm: the de-duplicated rows are exactly
        # the scatter-added gradient's non-zero rows.
        with torch.no_grad():
            gn = torch.sqrt(
                sum(torch.sum(torch.square(g_dense[k].float()))
                    for k in sorted(g_dense))
                + sum(torch.sum(torch.square(g_u.float()))
                      for _, g_u, _ in rows.values()))
            if clip > 0:
                # optax.clip_by_global_norm: scale by clip / max(gn, clip).
                scale = clip / torch.clamp(gn, min=clip)
                g_dense = {k: (g.float() * scale).to(g.dtype)
                           for k, g in g_dense.items()}
                rows = {k: (ids, (g.float() * scale).to(g.dtype), valid)
                        for k, (ids, g, valid) in rows.items()}
            opt.update(params, g_dense, state.opt_state)
            # The schedule's value for this update: at the completed-update
            # count, as optax's scale_by_schedule reads it.
            lr = lr_of(state.step)
            for leaf, (ids, g_u, valid) in rows.items():
                st = {n: state.opt_state[_row_key(leaf, n)] for n in names}
                _row_update(train_cfg, params[leaf], st, ids, g_u, valid, lr,
                            state.step + 1)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": gn}

    return micro_step_calls(micro_step, train_cfg.steps_per_call)
