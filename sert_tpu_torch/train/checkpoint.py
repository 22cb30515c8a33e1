"""Checkpoints in the reference's format (port of
``sert_tpu/train/checkpoint.py``): the read side plus a params-only writer.

Format: ``ckpt-{step:08d}.npz`` of arrays keyed by the JAX tree path
(``.params['word_emb']``, ..., ``.step``) and a ``ckpt-{step:08d}.json``
sidecar (step, ``params_only``, ``snapshot_dtype``, vocab hash, ...).
bfloat16 arrays are stored as their uint16 bit pattern; this module views
them straight into ``torch.bfloat16`` (no ml_dtypes). Either package loads
the other's files.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from sert_tpu_torch.models.convert import params_to_numpy, tensor_from_numpy

_CKPT_RE = re.compile(r"ckpt-(\d+)\.npz$")
_PARAM_KEY_RE = re.compile(r"^\.params\['([^']+)'\]$")


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


def save_params_checkpoint(ckpt_dir: str, step: int,
                           params: Mapping[str, torch.Tensor],
                           meta: Optional[Dict] = None) -> str:
    """Write a params-only checkpoint the reference loads (its epoch
    snapshot format). bf16 params are stored as the uint16 view and the
    sidecar records ``snapshot_dtype``; the floating params must share one
    dtype, as the reference's snapshots do. Atomic: sidecar first, the npz
    rename last (discovery keys on the npz)."""
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
    os.makedirs(ckpt_dir, exist_ok=True)
    base = os.path.join(ckpt_dir, f"ckpt-{step:08d}")
    with open(base + ".npz.tmp", "wb") as fh:
        np.savez(fh, **flat)
    with open(base + ".json.tmp", "w") as fh:
        json.dump({"step": int(step), **extra, **(meta or {})}, fh, indent=2)
    os.replace(base + ".json.tmp", base + ".json")
    os.replace(base + ".npz.tmp", base + ".npz")
    return base + ".npz"
