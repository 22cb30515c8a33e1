"""The train step (port of ``sert_tpu/train/step.py``): state, learning-rate
schedules, the optimizers and the dense step.

PyTorch runs eagerly, so there is no jit and no donation: the step updates
the params and the optimizer state IN PLACE (the reference's donated
buffers play the same role). The optimizers are plain tensor arithmetic
whose state mirrors optax's tree: ``opt_state`` maps each leaf's tree path
below ``.opt_state`` (``[0].mu['word_emb']``, ``[1].count``, ...) to a
tensor, or to a host int for the ``count`` leaves, so checkpoints carry
across packages.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sert_tpu_torch.models import api
from sert_tpu_torch.models.common import Params
from sert_tpu_torch.utils.config import ModelConfig, TrainConfig

OptState = Dict[str, object]


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: OptState
    step: int                       # completed micro-steps
    generator: torch.Generator      # draws the negatives, on the params' device


def release_opt_state(state: TrainState) -> TrainState:
    """The state with ``opt_state={}``: the moments' device memory is freed
    once nothing else holds them. The result scores but cannot resume."""
    return dataclasses.replace(state, opt_state={})


def check_optimizer_model_fit(model_cfg: ModelConfig,
                              train_cfg: TrainConfig) -> None:
    """Warn on the reference's measured optimizer/LSE traps (adafactor, and
    adagrad at >= 100k entities; ``sert_tpu/train/step.py:50``)."""
    if train_cfg.optimizer == "adafactor" and model_cfg.model == "lse":
        warnings.warn(
            "optimizer='adafactor' with the sampled-objective LSE model is "
            "a measured quality trap in the reference (factored second "
            "moments mis-scale sparse negative-sampling updates); use adam",
            UserWarning, stacklevel=3)
    if (train_cfg.optimizer == "adagrad" and model_cfg.model == "lse"
            and model_cfg.num_entities >= 100_000):
        warnings.warn(
            "optimizer='adagrad' with LSE degrades with scale: the "
            "reference measured chance-level training at 1M entities; use "
            "optimizer='adam' for LSE at scale",
            UserWarning, stacklevel=3)


def _linear(init: float, end: float, steps: int, count: float) -> float:
    """optax.linear_schedule; constant ``init`` when steps <= 0."""
    if steps <= 0:
        return init
    c = min(max(count, 0.0), steps)
    return (init - end) * (1.0 - c / steps) + end


def _cosine(init: float, steps: int, alpha: float, count: float) -> float:
    """optax.cosine_decay_schedule."""
    c = min(count, float(steps))
    return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / steps))
                   + alpha)


def has_schedule(cfg: TrainConfig) -> bool:
    """Whether the lr varies with the step, so that the optimizer state
    carries the schedule's ``count`` leaf (optax's scale_by_schedule)."""
    return cfg.lr_schedule != "constant" or cfg.lr_warmup_steps > 0


def make_lr(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate as a function of the number of completed updates,
    with the values of ``sert_tpu.train.step.make_lr``'s optax schedules
    (which compute them in fp32). Peak is ``learning_rate``."""
    peak, w = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_schedule == "constant":
        if w <= 0:
            return lambda step: peak
        return lambda step: (_linear(0.0, peak, w, step) if step < w
                             else peak)
    if cfg.lr_schedule not in ("cosine", "linear"):
        raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r}")
    total = cfg.lr_decay_steps
    if total <= 0:
        raise ValueError(
            f"lr_schedule={cfg.lr_schedule!r} needs lr_decay_steps > 0; "
            "the train loop fills it from num_epochs x batches/epoch — set "
            "it explicitly when building a step outside the loop")
    end = cfg.lr_final_fraction * peak
    if cfg.lr_schedule == "cosine":
        if total - w <= 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, "
                f"got decay_steps={total - w}")
        alpha = 0.0 if peak == 0.0 else end / peak
        init = 0.0 if w > 0 else peak

        def cosine(step):
            if step < w:
                return _linear(init, peak, w, step)
            return _cosine(peak, total - w, alpha, step - w)
        return cosine
    decay_steps = max(total - w, 1)
    if w <= 0:
        return lambda step: _linear(peak, end, decay_steps, step)
    return lambda step: (_linear(0.0, peak, w, step) if step < w
                         else _linear(peak, end, decay_steps, step - w))


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` for adafactor's arguments: the (second
    largest, largest) axes of a leaf whose two largest dims are both at
    least ``Optimizer.MIN_DIM_TO_FACTOR``, else None (a full ``v``)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < Optimizer.MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass
class ShardInfo:
    """Where a mesh step's leaves lie (``parallel/train.py``): each param's
    sharded axis (None where it is replicated), its full shape, and the sum
    over the ``model`` axis. The reductions that GSPMD inserted for the
    reference over a sharded axis (the global norm, adafactor's factored
    means) sum each sharded leaf over ``model`` exactly once; a replicated
    leaf counts once."""
    axes: Dict[str, Optional[int]]
    shapes: Dict[str, Tuple[int, ...]]
    model_sum: Callable[[torch.Tensor], torch.Tensor]

    def mean(self, x: torch.Tensor, n: str, dim: int, full_dim: int,
             keepdim: bool = False) -> torch.Tensor:
        """``x.mean(dim)`` over the full axis ``full_dim`` of leaf ``n``
        (``dim`` is that axis in ``x``)."""
        if self.axes.get(n) != full_dim:
            return x.mean(dim, keepdim=keepdim)
        return (self.model_sum(x.sum(dim, keepdim=keepdim))
                / self.shapes[n][full_dim])


class Optimizer:
    """adam / adagrad / sgd / adafactor with optax's arithmetic, plus
    optional global-norm clipping (before) and decoupled weight decay
    (after), as ``sert_tpu.train.step.make_optimizer`` chains them.
    adafactor is ``optax.adafactor(lr, multiply_by_parameter_scale=False,
    clipping_threshold=None)``: the factored second moment alone, no
    momentum. :meth:`update` changes the params and the state in place.
    ``shards`` (a mesh step's :class:`ShardInfo`): the norm and the
    factored statistics reduce over the sharded axes."""

    B1, B2, EPS = 0.9, 0.999, 1e-8
    # optax.scale_by_factored_rms's defaults.
    DECAY_RATE, FACTORED_EPS, MIN_DIM_TO_FACTOR = 0.8, 1e-30, 128

    def __init__(self, cfg: TrainConfig, prefix: str = "",
                 shards: Optional[ShardInfo] = None):
        if cfg.optimizer not in ("adam", "adagrad", "sgd", "adafactor"):
            raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.shards = shards
        self.lr = make_lr(cfg)
        self.scheduled = has_schedule(cfg)
        self.clip = cfg.grad_clip_norm
        self.decay = cfg.weight_decay
        self.acc0 = cfg.adagrad_init_accumulator
        self.adagrad_eps = cfg.adagrad_eps
        # optax.chain(clip?, opt, decay?) nests opt's state one level down;
        # ``prefix`` places the whole tree below a key of an outer state.
        chained = self.clip > 0 or self.decay > 0
        self.prefix = prefix + (f"[{1 if self.clip > 0 else 0}]" if chained
                                else "")

    def _key(self, leaf: str, name: Optional[str] = None) -> str:
        return self.prefix + leaf + (f"['{name}']" if name else "")

    def init(self, params: Params) -> OptState:
        state: OptState = {}
        if self.kind == "adam":
            state[self._key("[0].count")] = 0
            for n, p in sorted(params.items()):
                state[self._key("[0].mu", n)] = torch.zeros_like(p)
                state[self._key("[0].nu", n)] = torch.zeros_like(p)
        elif self.kind == "adagrad":
            for n, p in sorted(params.items()):
                state[self._key("[0].sum_of_squares", n)] = torch.full_like(
                    p, self.acc0)
        elif self.kind == "adafactor":
            # optax's init: the unused slots of a leaf hold zeros of (1,).
            state[self._key("[0].count")] = 0
            for n, p in sorted(params.items()):
                dims = factored_dims(p.shape)
                shapes = {"v_row": (1,), "v_col": (1,), "v": p.shape}
                if dims is not None:
                    d1, d0 = dims
                    shapes = {"v_row": np.delete(p.shape, d0),
                              "v_col": np.delete(p.shape, d1), "v": (1,)}
                for slot, shape in shapes.items():
                    state[self._key(f"[0].{slot}", n)] = p.new_zeros(
                        tuple(int(s) for s in shape))
        if self.scheduled:
            state[self._key("[1].count")] = 0
        return state

    def _factored_rms(self, n: str, g: torch.Tensor, state: OptState,
                      decay: float, keep: float) -> torch.Tensor:
        """optax.scale_by_factored_rms on one leaf: its statistics in fp32
        (``decay`` and ``keep`` = 1 - decay are fp32 values, as optax's
        strongly typed fp32 decay is), stored in the leaf's dtype, and the
        scaled gradient in the leaf's dtype."""
        dtype = g.dtype
        g2 = g * g + scalar(self.FACTORED_EPS, dtype)
        sh = self.shards
        dims = factored_dims(g.shape if sh is None else sh.shapes[n])
        if dims is None:
            v = state[self._key("[0].v", n)]
            v.copy_(decay * v.float() + keep * g2.float())
            return g * v ** -0.5
        d1, d0 = dims

        def mean(x, dim, full_dim, keepdim=False):
            if sh is None:
                return x.mean(dim, keepdim=keepdim)
            return sh.mean(x, n, dim, full_dim, keepdim)

        v_row = state[self._key("[0].v_row", n)]
        v_col = state[self._key("[0].v_col", n)]
        # jnp.mean of a bf16 array sums in fp32 and rounds the mean.
        v_row.copy_(decay * v_row.float()
                    + keep * mean(g2.float(), d0, d0).to(dtype).float())
        v_col.copy_(decay * v_col.float()
                    + keep * mean(g2.float(), d1, d1).to(dtype).float())
        row_mean = mean(v_row.float(), d1 - 1 if d1 > d0 else d1, d1,
                        keepdim=True).to(dtype)
        row_factor = (v_row / row_mean) ** -0.5
        col_factor = v_col ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: OptState) -> None:
        if self.clip > 0:
            norm = global_norm(grads, self.shards)
            keep = norm < self.clip
            grads = {n: torch.where(keep, g, g / norm.to(g.dtype)
                                    * scalar(self.clip, g.dtype))
                     for n, g in grads.items()}
        if self.scheduled:
            count = state[self._key("[1].count")]
            lr = self.lr(count)
            state[self._key("[1].count")] = count + 1
        else:
            lr = self.lr(0)
        if self.kind in ("adam", "adafactor"):
            count = state[self._key("[0].count")] + 1
            state[self._key("[0].count")] = count
        if self.kind == "adam":
            bc1 = 1.0 - self.B1 ** count
            bc2 = 1.0 - self.B2 ** count
        elif self.kind == "adafactor":
            # optax's _decay_rate_pow of the count before this update, in
            # fp32; as host floats, so no copy to the device waits on it.
            decay_t = 1.0 - torch.tensor(float(count),
                                         dtype=torch.float32) \
                ** -self.DECAY_RATE
            decay, keep = float(decay_t), float(1.0 - decay_t)
        for n, g in grads.items():
            p = params[n]
            c = functools.partial(scalar, dtype=g.dtype)
            if self.kind == "adam":
                mu = state[self._key("[0].mu", n)]
                nu = state[self._key("[0].nu", n)]
                mu.mul_(c(self.B1)).add_(g * c(1 - self.B1))
                nu.mul_(c(self.B2)).add_(g * g * c(1 - self.B2))
                u = (mu / c(bc1)) / (torch.sqrt(nu / c(bc2)) + c(self.EPS))
            elif self.kind == "adagrad":
                sos = state[self._key("[0].sum_of_squares", n)]
                sos.add_(g * g)
                inv = torch.where(sos > 0, torch.rsqrt(
                    sos + c(self.adagrad_eps)), torch.zeros(
                        (), dtype=sos.dtype, device=sos.device))
                u = inv * g
            elif self.kind == "adafactor":
                u = self._factored_rms(n, g, state, decay, keep)
            else:
                u = g
            # adam's scale(-lr), or adafactor's scale(lr) then scale(-1):
            # a negation is exact, so one product either way.
            u = u * c(-lr)
            if self.decay > 0:
                u = u + p * c(-self.decay)
            p.add_(u.to(p.dtype))


@functools.lru_cache(maxsize=1024)
def scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``. JAX applies a Python scalar to an array
    in the array's dtype (a weak type), so optax's bf16 arithmetic uses
    bf16 constants (0.9 as 0.8984375); torch would apply them in fp32. In
    fp32 this is the value torch uses anyway. Memoized: the optimizers ask
    for the same few constants every micro-step."""
    return float(torch.tensor(x, dtype=dtype))


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """The optimizer a TrainConfig names (``sert_tpu.train.step
    .make_optimizer``'s menu and chain)."""
    return Optimizer(cfg)


def global_norm(tensors: Params,
                shards: Optional[ShardInfo] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm).
    With ``shards``, each sharded leaf's sum of squares is summed over the
    ``model`` axis (one collective for all of them)."""
    names = sorted(tensors)
    sq = {n: torch.sum(tensors[n].float() * tensors[n].float())
          for n in names}
    split = [n for n in names
             if shards is not None and shards.axes.get(n) is not None]
    if split:
        summed = shards.model_sum(torch.stack([sq[n] for n in split]))
        sq.update(zip(split, summed.unbind(0)))
    return torch.sqrt(sum(sq[n] for n in names))


def init_state(seed: int, model_cfg: ModelConfig, train_cfg: TrainConfig,
               device=None, sparse_override: Optional[bool] = None
               ) -> TrainState:
    """Fresh params (drawn with a generator seeded by ``seed`` on
    ``device``), the optimizer's zero state and step 0. The same generator
    then draws the negatives. The state is the row-sparse step's
    (``train.sparse``) where ``sparse_enabled`` holds. ``sparse_override``
    (the reference's parameter) pins the flavor whatever the config says,
    e.g. to ``checkpoint.has_sparse_opt_state(path)`` for a template that
    must match a file. The port's own loaders do not pass it:
    ``load_scorer`` reads params only, and the loop's resume pins
    ``sparse_update`` in the config (``loop._pin_sparse_update``)."""
    from sert_tpu_torch.train import sparse   # it imports this module
    if (train_cfg.lr_schedule != "constant"
            and train_cfg.lr_decay_steps <= 0):
        # Building the state never evaluates the schedule.
        train_cfg = dataclasses.replace(
            train_cfg, lr_decay_steps=train_cfg.lr_warmup_steps + 1)
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    params = api.init_params(gen, model_cfg, device)
    use_sparse = (sparse.sparse_enabled(model_cfg, train_cfg)
                  if sparse_override is None else bool(sparse_override))
    if use_sparse:
        opt_state = sparse.init_sparse_opt_state(params, train_cfg)
    else:
        opt_state = make_optimizer(train_cfg).init(params)
    return TrainState(params=params, opt_state=opt_state, step=0,
                      generator=gen)


def micro_step_calls(micro_step, n: int):
    """``step(state, batch) -> (state, metrics)`` over ``micro_step(state,
    batch) -> metrics``: one micro-step, or with ``n > 1`` a Python loop
    over the stacked batch's leading micro-step axis, with the last
    micro-step's metrics."""
    def step(state: TrainState, batch
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if n <= 1:
            return state, micro_step(state, batch)
        metrics = None
        for i in range(next(iter(batch.values())).shape[0]):
            metrics = micro_step(state, {k: v[i] for k, v in batch.items()})
        return state, metrics

    return step


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    noise: Optional[torch.Tensor] = None, loss_fn=None,
                    device=None):
    """``step(state, batch) -> (state, metrics)``: one dense update per
    micro-step, in place. ``noise``: the negative-sampling logits over
    entities (LSE), on the params' device. ``loss_fn``: api.loss_fn's
    signature, overridable (tests inject negatives through it).
    ``device``: the params' device (None: the CPU, as in
    :func:`init_state`), on which ``fused_update="auto"`` decides.

    Where no ``loss_fn`` is given, the step is
    ``train.sparse.make_sparse_train_step``'s (the row-sparse lazy
    update) where ``train.sparse.sparse_enabled`` holds, else
    ``train.fused.make_fused_train_step``'s (the optimizer applied inside
    the softmax backward, K7) where ``train.fused.fused_enabled`` holds,
    with the same contract.

    With ``steps_per_call > 1`` the step takes a stacked batch (leading
    micro-step axis) and runs the micro-steps in a Python loop; metrics are
    the last one's, as device tensors (reading them syncs)."""
    check_optimizer_model_fit(model_cfg, train_cfg)
    if loss_fn is None:
        # Both import this module.
        from sert_tpu_torch.train import fused, sparse
        if sparse.sparse_enabled(model_cfg, train_cfg):
            return sparse.make_sparse_train_step(model_cfg, train_cfg,
                                                 noise=noise)
        if fused.fused_enabled(model_cfg, train_cfg, device):
            return fused.make_fused_train_step(model_cfg, train_cfg)
    opt = make_optimizer(train_cfg)
    if loss_fn is None:
        loss_fn = api.loss_fn

    def micro_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        names = sorted(state.params)
        leaves = {n: state.params[n].detach().requires_grad_(True)
                  for n in names}
        loss = loss_fn(leaves, batch, model_cfg,
                       generator=state.generator, noise=noise)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        grads = dict(zip(names, grads))
        grad_norm = global_norm(grads)
        opt.update(state.params, grads, state.opt_state)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return micro_step_calls(micro_step, train_cfg.steps_per_call)
