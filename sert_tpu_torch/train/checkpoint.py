"""Checkpoints in the reference's format (port of
``sert_tpu/train/checkpoint.py``): full train state or params only, the
async writer, and the readers.

Format: ``ckpt-{step:08d}.npz`` of arrays keyed by the JAX tree path of
the reference's ``TrainState`` (``.params['word_emb']``,
``.opt_state[0].mu['word_emb']``, ``.opt_state[1].count``, ``.step``,
``.rng``; the row-sparse step's ``.opt_state['dense'][0].mu['proj_w']``,
``.opt_state['rows']['entity_emb']['m']``, ...) and a
``ckpt-{step:08d}.json`` sidecar (step, ``params_only``,
``snapshot_dtype``, epoch, cursor, vocab hash, ...). bfloat16 arrays are
stored as their uint16 bit pattern; this module views them straight into
``torch.bfloat16`` (no ml_dtypes). Either package loads the other's files.

The port's generator state goes under a key of its own
(``.torch_generator``), which the reference ignores; it still writes a
``.rng`` of the reference's shape (uint32[2] key data, derived from the
generator state), so the JAX package resumes a port checkpoint. A JAX
checkpoint seeds the port's generator from its ``.rng``; the draws differ
from ``jax.random``'s by nature.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sert_tpu_torch.models.convert import params_to_numpy, tensor_from_numpy

_CKPT_RE = re.compile(r"ckpt-(\d+)\.npz$")
_PARAM_KEY_RE = re.compile(r"^\.params\['([^']+)'\]$")
GENERATOR_KEY = ".torch_generator"


def list_checkpoints(ckpt_dir: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = _CKPT_RE.match(name)
            if m:
                out[int(m.group(1))] = os.path.join(ckpt_dir, name)
    return dict(sorted(out.items()))


def load_meta(path: str) -> Dict:
    """A checkpoint's JSON sidecar ({} when absent), without the npz."""
    meta_path = path[:-len(".npz")] + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            return json.load(fh)
    return {}


def latest_checkpoint(ckpt_dir: str, full_only: bool = False
                      ) -> Optional[str]:
    """Newest checkpoint path; ``full_only`` skips params-only snapshots."""
    for _, path in sorted(list_checkpoints(ckpt_dir).items(), reverse=True):
        if full_only and load_meta(path).get("params_only"):
            continue
        return path
    return None


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The ``.params[...]`` arrays of a checkpoint as CPU tensors in their
    stored dtype. A uint16 param is the reference's bf16 carrier (a bf16
    ``snapshot_dtype`` snapshot, or a run with bf16 ``param_dtype``) and is
    viewed as torch.bfloat16."""
    sdt = load_meta(path).get("snapshot_dtype")
    if sdt not in (None, "float32", "bfloat16"):
        raise ValueError(f"{path}: unsupported snapshot_dtype {sdt!r}")
    params = {}
    with np.load(path) as z:
        for key in z.files:
            m = _PARAM_KEY_RE.match(key)
            if m is None:
                continue
            arr = z[key]
            if arr.dtype != np.uint16 and arr.dtype.kind != "f":
                raise ValueError(f"{path}: {key} has dtype {arr.dtype}")
            params[m.group(1)] = tensor_from_numpy(arr)
    if not params:
        raise ValueError(f"{path} holds no .params arrays")
    return params


def _write(ckpt_dir: str, step: int, flat: Mapping[str, np.ndarray],
           extra: Dict, meta: Optional[Dict]) -> str:
    """Atomic write: sidecar first, the npz rename last (discovery keys on
    the npz, so a crash between the two leaves a harmless orphan .json)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    base = os.path.join(ckpt_dir, f"ckpt-{step:08d}")
    with open(base + ".npz.tmp", "wb") as fh:
        np.savez(fh, **flat)
    with open(base + ".json.tmp", "w") as fh:
        json.dump({"step": int(step), **extra, **(meta or {})}, fh, indent=2)
    os.replace(base + ".json.tmp", base + ".json")
    os.replace(base + ".npz.tmp", base + ".npz")
    return base + ".npz"


def _prune(ckpt_dir: str, max_to_keep: int) -> None:
    """Keep the newest ``max_to_keep`` checkpoints, and never evict the
    newest full one (the run's only resume point among params-only
    snapshots)."""
    existing = list_checkpoints(ckpt_dir)
    newest_full = next((s for s in sorted(existing, reverse=True)
                        if not load_meta(existing[s]).get("params_only")),
                       None)
    for old in sorted(existing)[:-max_to_keep]:
        if old == newest_full:
            continue
        os.remove(existing[old])
        j = existing[old][:-len(".npz")] + ".json"
        if os.path.exists(j):
            os.remove(j)


def save_params_checkpoint(ckpt_dir: str, step: int,
                           params: Mapping[str, torch.Tensor],
                           meta: Optional[Dict] = None) -> str:
    """Write a params-only checkpoint the reference loads (its epoch
    snapshot format). bf16 params are stored as the uint16 view and the
    sidecar records ``snapshot_dtype``; the floating params must share one
    dtype, as the reference's snapshots do."""
    dts = {t.dtype for t in params.values()}
    if len(dts) != 1 or not dts <= {torch.float32, torch.bfloat16}:
        raise ValueError("params must all be float32 or all bfloat16, got "
                         f"{sorted(map(str, dts))}")
    flat = {f".params['{k}']": v
            for k, v in params_to_numpy(params).items()}
    flat[".step"] = np.asarray(step, np.int32)
    extra = {"params_only": True}
    if dts == {torch.bfloat16}:
        extra["snapshot_dtype"] = "bfloat16"
    return _write(ckpt_dir, step, flat, extra, meta)


_SNAPSHOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _narrow(params_dtype: Optional[str]) -> Optional[torch.dtype]:
    if params_dtype in (None, "float32"):
        return None
    if params_dtype not in _SNAPSHOT_DTYPES:
        raise ValueError(f"unsupported snapshot dtype {params_dtype!r}")
    return _SNAPSHOT_DTYPES[params_dtype]


def _array(t) -> np.ndarray:
    if isinstance(t, int):
        return np.asarray(t, np.int32)
    return params_to_numpy({"x": t})["x"]


def _rng_key_data(gen_state: np.ndarray) -> np.ndarray:
    """uint32[2] for the reference's ``.rng``, derived from the port's
    generator state (a resumed JAX run draws its own stream from it)."""
    digest = hashlib.sha256(gen_state.tobytes()).digest()[:8]
    return np.frombuffer(digest, np.uint32).copy()


def _flatten(state: Any, params_only: bool) -> Dict[str, np.ndarray]:
    """Host arrays keyed by tree path. Params-only keeps ``.params`` and
    ``.step``; the optimizer state never leaves the device."""
    flat = {f".params['{k}']": v
            for k, v in params_to_numpy(state.params).items()}
    flat[".step"] = np.asarray(state.step, np.int32)
    if not params_only:
        for key, v in state.opt_state.items():
            flat[".opt_state" + key] = _array(v)
        gen = state.generator.get_state().numpy()
        flat[GENERATOR_KEY] = gen
        flat[".rng"] = _rng_key_data(gen)
    return flat


def _cast_params(state: Any, dtype: Optional[torch.dtype]) -> Any:
    if dtype is None:
        return state
    return dataclasses.replace(state, params={
        k: v.to(dtype) if v.is_floating_point() else v
        for k, v in state.params.items()})


def _on_mesh(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    meta: Optional[Dict] = None, max_to_keep: int = 0,
                    params_only: bool = False,
                    params_dtype: Optional[str] = None, mesh=None,
                    specs=None) -> str:
    """Write ckpt-{step}.npz + .json atomically from a ``TrainState``.

    ``params_only``: just ``.params`` and ``.step`` (the reference's epoch
    dump; serves scoring, not resume), stored at ``params_dtype``
    ("bfloat16" casts on the device before the fetch and is recorded in
    the sidecar). ``max_to_keep > 0`` prunes the oldest checkpoints.

    ``mesh`` (of more than one rank) with ``specs`` (the full state's
    ``parallel.sharding.state_shardings``): every rank calls this with its
    blocks; they are gathered in shard order (a collective), rank 0 alone
    writes the one-card format, and every rank returns after the file is
    in place (the reference's ``_to_host`` :47 and ``_barrier`` :98)."""
    from sert_tpu_torch.parallel import mesh as mesh_mod
    if _on_mesh(mesh):
        from sert_tpu_torch.parallel.sharding import gather_state
        if params_only:     # the slots never leave their ranks
            state = dataclasses.replace(state, opt_state={})
        state = gather_state(state, mesh, specs)
        if mesh_mod.world_rank() != 0:
            mesh_mod.barrier()
            return os.path.join(ckpt_dir, f"ckpt-{step:08d}.npz")
    narrow = _narrow(params_dtype) if params_only else None
    flat = _flatten(_cast_params(state, narrow), params_only)
    extra = {"params_only": True} if params_only else {}
    if narrow is not None:
        extra["snapshot_dtype"] = params_dtype
    path = _write(ckpt_dir, step, flat, extra, meta)
    if max_to_keep > 0:
        _prune(ckpt_dir, max_to_keep)
    if _on_mesh(mesh):
        mesh_mod.barrier()
    return path


def rewrite_meta(ckpt_dir: str, step: int, meta: Optional[Dict],
                 mesh=None) -> str:
    """Atomically replace an existing checkpoint's sidecar (a mid-epoch
    save that lands on the epoch boundary becomes the epoch snapshot
    without writing the npz again). On a ``mesh``, rank 0 writes and
    every rank returns after it."""
    from sert_tpu_torch.parallel import mesh as mesh_mod
    base = os.path.join(ckpt_dir, f"ckpt-{step:08d}")
    if not _on_mesh(mesh) or mesh_mod.world_rank() == 0:
        if not os.path.exists(base + ".npz"):
            raise FileNotFoundError(
                f"no checkpoint to rewrite at {base}.npz")
        with open(base + ".json.tmp", "w") as fh:
            json.dump({"step": int(step), **(meta or {})}, fh, indent=2)
        os.replace(base + ".json.tmp", base + ".json")
    if _on_mesh(mesh):
        mesh_mod.barrier()
    return base + ".npz"


def _device_copy(state: Any, params_only: bool,
                 narrow: Optional[torch.dtype]) -> Any:
    """Fresh buffers for everything the writer reads: the step updates
    params and optimizer state in place while the write runs."""
    params = {k: (v.to(narrow) if narrow is not None
                  and v.is_floating_point() and v.dtype != narrow
                  else v.clone())
              for k, v in state.params.items()}
    if params_only:
        return dataclasses.replace(state, params=params, opt_state={})
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    opt = {k: v if isinstance(v, int) else v.clone()
           for k, v in state.opt_state.items()}
    return dataclasses.replace(state, params=params, opt_state=opt,
                               generator=gen)


class AsyncCheckpointer:
    """Overlap the device->host fetch and the npz write with training: the
    state is copied on the device first, then one worker thread fetches
    and writes while the next steps run. At most one save is in flight (a
    second ``save`` waits for the first); a worker's exception re-raises
    on the next ``save``/``wait``. On a ``mesh`` of more than one rank
    (with the full state's ``specs``) every save is synchronous:
    :func:`save_checkpoint` gathers the blocks and rank 0 writes."""

    def __init__(self, mesh=None, specs=None) -> None:
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._mesh, self._specs = mesh, specs

    def save(self, ckpt_dir: str, step: int, state: Any,
             meta: Optional[Dict] = None, max_to_keep: int = 0,
             sync: bool = False, params_only: bool = False,
             params_dtype: Optional[str] = None) -> None:
        self.wait()
        if sync or _on_mesh(self._mesh):
            save_checkpoint(ckpt_dir, step, state, meta,
                            max_to_keep=max_to_keep, params_only=params_only,
                            params_dtype=params_dtype, mesh=self._mesh,
                            specs=self._specs)
            return
        narrow = _narrow(params_dtype) if params_only else None
        snap = _device_copy(state, params_only, narrow)

        def work() -> None:
            try:
                save_checkpoint(ckpt_dir, step, snap, meta,
                                max_to_keep=max_to_keep,
                                params_only=params_only,
                                params_dtype=params_dtype)
            except BaseException as exc:   # re-raised by wait()
                self._err = exc

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"ckpt-writer-{step}")
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) is durable on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def has_sparse_opt_state(path: str) -> bool:
    """True when the checkpoint holds the reference's row-sparse lazy
    optimizer state (``.opt_state['dense']...``). Reads only the npz
    directory."""
    with np.load(path) as z:
        return any(k.startswith(".opt_state['dense']") for k in z.files)


def _leaf(flat, key: str, like: torch.Tensor) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != "
                         f"expected {tuple(like.shape)}")
    return tensor_from_numpy(arr).to(device=like.device, dtype=like.dtype)


def _generator(flat, like: torch.Generator) -> torch.Generator:
    """The port's generator state when the file has it (and it is for
    this device type), else a generator seeded from ``.rng``'s key data."""
    gen = torch.Generator(device=like.device)
    state = flat.get(GENERATOR_KEY)
    if state is not None and state.size == like.get_state().numel():
        gen.set_state(torch.from_numpy(np.array(state, np.uint8)))
        return gen
    if ".rng" not in flat:
        raise KeyError("checkpoint missing leaf .rng")
    key = np.asarray(flat[".rng"]).astype(np.uint64).reshape(-1)
    gen.manual_seed(int(key[0]) << 32 | int(key[-1]))
    return gen


def load_checkpoint(path: str, template: Any) -> Tuple[Any, Dict]:
    """Restore a ``TrainState`` shaped like ``template`` (its params' and
    moments' shapes, dtypes and devices) plus the JSON meta. Params-only
    snapshots fill ``.params`` and ``.step`` and keep the template's other
    fields. Leaves of the file that the template lacks are ignored; a
    template of the other optimizer-state flavor (dense or row-sparse,
    see :func:`has_sparse_opt_state`) misses leaves and raises KeyError."""
    meta = load_meta(path)
    sdt = meta.get("snapshot_dtype")
    if sdt not in (None, "float32", "bfloat16"):
        raise ValueError(f"{path}: unsupported snapshot_dtype {sdt!r}")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = {n: _leaf(flat, f".params['{n}']", t)
              for n, t in template.params.items()}
    step = int(flat[".step"]) if ".step" in flat else template.step
    if meta.get("params_only"):
        return dataclasses.replace(template, params=params, step=step), meta
    opt_state = {}
    for key, t in template.opt_state.items():
        if isinstance(t, int):
            if ".opt_state" + key not in flat:
                raise KeyError(f"checkpoint missing leaf .opt_state{key}")
            opt_state[key] = int(flat[".opt_state" + key])
        else:
            opt_state[key] = _leaf(flat, ".opt_state" + key, t)
    return dataclasses.replace(
        template, params=params, opt_state=opt_state, step=step,
        generator=_generator(flat, template.generator)), meta
