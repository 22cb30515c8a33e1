"""Parameters across the package boundary, as numpy arrays.

The reference's params are a dict of arrays keyed ``word_emb`` / ``proj_w``
/ ``proj_b`` / ``entity_emb`` in fixed layouts; the port keeps the same keys
and layouts, so conversion is a copy per array. bfloat16 travels as its
uint16 bit pattern (the reference's checkpoint carrier, and what numpy
holds without ml_dtypes): it is reinterpreted, never numerically cast.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _is_bf16_carrier(arr: np.ndarray) -> bool:
    # uint16 is the reference's storable bf16; kind "V" with itemsize 2 is
    # an ml_dtypes bfloat16 array (np.asarray of a jax bf16 array).
    return arr.dtype == np.uint16 or (arr.dtype.kind == "V"
                                      and arr.dtype.itemsize == 2)


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """One array -> CPU tensor sharing its memory (a read-only array, such
    as a view of a jax array, is copied first); a bf16 carrier becomes
    torch.bfloat16."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if _is_bf16_carrier(arr):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(np_params: Mapping[str, np.ndarray], device="cpu",
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """The reference's params (numpy arrays, same keys and layouts) as
    tensors on ``device``; ``dtype`` casts the floating ones. On the CPU
    an uncast tensor shares the array's memory."""
    out = {}
    for key, arr in np_params.items():
        t = tensor_from_numpy(np.asarray(arr))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[key] = t.to(device)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """The inverse: host numpy arrays, bf16 as the uint16 carrier."""
    out = {}
    for key, t in params.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out
