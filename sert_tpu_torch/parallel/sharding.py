"""Which axis of which tensor lives on which mesh axis, and the slicing and
gathering that follow (port of ``sert_tpu/parallel/sharding.py``:
``_spec_for_shape`` :30, ``state_shardings`` :47, ``batch_sharding`` :64,
``shard_state`` :75).

Rule: the ENTITY axis is the tensor-parallel axis; everything else is
replicated. The reference applies it by shape (the first axis of length
``num_entities``); the port reads each param's entity axis from the
model's layout (:func:`param_spec`), which is the shape rule wherever no
other width equals the entity count, and each optimizer slot follows its
param (adam's moments, adafactor's ``v_col`` [E]):

  loglinear: proj_w [d, E] -> (None, "model"); proj_b [E] -> ("model",)
  lse:       entity_emb [E, d_e] -> ("model", None)
  word_emb:  replicated

Model rank m holds the contiguous block [m E/tp, (m + 1) E/tp) of a
sharded axis; data rank d feeds the batch rows [d B/dp, (d + 1) B/dp).
A spec is a tuple with one entry an axis: "model" or None.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sert_tpu_torch.parallel.mesh import Mesh, all_gather
from sert_tpu_torch.utils.config import ModelConfig

Spec = Tuple[Optional[str], ...]


def sharded_axis(spec: Spec) -> Optional[int]:
    """The index of the "model" axis of ``spec``, or None."""
    return spec.index("model") if "model" in spec else None


# The entity axis of each param, by the model's layout: where a width
# equals the entity count (a square proj_w at d == E, or word_emb's d), the
# shape alone would pick the wrong axis, and the losses read the entity
# block.
_ENTITY_AXIS = {("loglinear", "proj_w"): 1, ("loglinear", "proj_b"): 0,
                ("lse", "entity_emb"): 0, ("lse_full", "entity_emb"): 0}


def param_spec(name: str, shape, cfg: ModelConfig) -> Spec:
    """The spec of param ``name``: "model" on its entity axis (proj_w's
    and proj_b's for log-linear, entity_emb's rows for LSE), replicated
    for the rest (the word table, the LSE projection)."""
    axis = _ENTITY_AXIS.get((cfg.model, name))
    if axis is None:
        return (None,) * len(shape)
    return tuple("model" if i == axis else None for i in range(len(shape)))


def _slot_spec(key: str, leaf, params_specs, params_shapes) -> Spec:
    """An optimizer slot's spec: its param's where it has the param's
    shape; adafactor's factored ``v_row`` / ``v_col`` drop the axis they
    average over; a host int or a placeholder replicates."""
    if isinstance(leaf, int) or not isinstance(leaf, torch.Tensor):
        return ()
    name = key[key.rfind("['") + 2:-2] if key.endswith("']") else None
    if name not in params_specs:
        return (None,) * leaf.dim()
    pspec, pshape = params_specs[name], params_shapes[name]
    if tuple(leaf.shape) == tuple(pshape):
        return pspec
    from sert_tpu_torch.train.step import factored_dims
    dims = factored_dims(pshape)
    factored = ".v_row[" in key or ".v_col[" in key
    if factored and dims is not None and leaf.dim() == len(pshape) - 1:
        drop = dims[1] if ".v_row[" in key else dims[0]
        return tuple(a for i, a in enumerate(pspec) if i != drop)
    return (None,) * leaf.dim()


def state_shardings(state, cfg: ModelConfig) -> Dict[str, Dict[str, Spec]]:
    """The specs of a full (unsharded) TrainState's leaves:
    ``{"params": {name: spec}, "opt_state": {key: spec}}``. The shape rule
    holds, with each param's entity axis read from the model's layout
    (:func:`param_spec`), and each slot following its param (a host int
    such as a count is ``()``). Also takes a params dict, giving the
    params' specs alone. ValueError where ``vocab_size ==
    num_entities``, as the reference's."""
    if cfg.vocab_size == cfg.num_entities:
        raise ValueError(
            "vocab_size == num_entities would make the shape-based sharding "
            "rule ambiguous; offset one of them by 1")
    params = state if isinstance(state, dict) else state.params
    pspecs = {k: param_spec(k, tuple(v.shape), cfg)
              for k, v in params.items()}
    if isinstance(state, dict):
        return pspecs
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    return {"params": pspecs,
            "opt_state": {k: _slot_spec(k, v, pspecs, shapes)
                          for k, v in state.opt_state.items()}}


def block(n: int, mesh: Mesh, axis: str = "model") -> Tuple[int, int]:
    """[lo, hi) of this rank's block of a length-``n`` axis split evenly
    over mesh ``axis``; ValueError where it does not divide."""
    s = mesh.shape[axis]
    if n % s:
        raise ValueError(f"length {n} must divide by the {axis} mesh axis "
                         f"({s})")
    per = n // s
    i = mesh.coords[axis]
    return i * per, (i + 1) * per


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a full tensor: a contiguous copy of its slice
    of the "model" axis of ``spec``; the tensor itself where nothing
    shards (a replicated leaf, or a model axis of size 1)."""
    ax = sharded_axis(spec)
    if ax is None or mesh.shape["model"] == 1:
        return t
    lo, hi = block(t.shape[ax], mesh)
    return t.narrow(ax, lo, hi - lo).contiguous()


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every model rank's block, in shard order (a
    collective over ``model``: every rank of the axis calls it)."""
    ax = sharded_axis(spec)
    if ax is None or mesh.shape["model"] == 1:
        return t
    parts = all_gather(t, mesh, "model")
    return torch.cat(list(parts.unbind(0)), dim=ax)


def shard_params(params, mesh: Mesh, cfg: ModelConfig):
    """This rank's blocks of a full params dict."""
    specs = state_shardings(params, cfg)
    return {k: shard_tensor(v, specs[k], mesh) for k, v in params.items()}


def _map_state(state, specs, fn):
    params = {k: fn(v, specs["params"][k]) for k, v in state.params.items()}
    opt = {k: v if isinstance(v, int) else fn(v, specs["opt_state"][k])
           for k, v in state.opt_state.items()}
    return dataclasses.replace(state, params=params, opt_state=opt)


def shard_state(state, mesh: Mesh, cfg: ModelConfig, specs=None):
    """This rank's blocks of a full TrainState: params and optimizer slots
    alike (a slot follows its leaf's shape). ``specs``: the full state's
    :func:`state_shardings`, where the caller has them."""
    specs = specs or state_shardings(state, cfg)
    return _map_state(state, specs,
                      lambda t, s: shard_tensor(t, s, mesh))


def gather_state(state, mesh: Mesh, specs):
    """The full TrainState from every model rank's blocks (collective over
    ``model``); ``specs`` are the full state's :func:`state_shardings`."""
    return _map_state(state, specs,
                      lambda t, s: gather_tensor(t, s, mesh))


def batch_rows(batch, mesh: Mesh, bdim: int = 0):
    """This data rank's rows of a global host batch (dict of numpy
    arrays; ``bdim`` 1 for a stacked group of micro-steps): rows
    [d B/dp, (d + 1) B/dp). ValueError where B does not divide."""
    dp = mesh.shape["data"]
    n = next(iter(batch.values())).shape[bdim]
    if n % dp:
        raise ValueError(
            f"batch size {n} must be a multiple of the data mesh axis "
            f"({dp}); set TrainConfig.batch_size accordingly")
    if dp == 1:
        return batch
    lo, hi = block(n, mesh, "data")
    return {k: np.ascontiguousarray(np.take(v, np.arange(lo, hi), axis=bdim))
            for k, v in batch.items()}
