"""Operations, bytes and peaks behind the rooflines and the step's MFU.

A kernel's bound counts the work the mathematics needs, whatever
implements it: the larger of its products' operations over the chip's
peak for the compute dtype, and its inputs read once and outputs written
once over the memory's rate. The peaks are NVIDIA's data sheet for one
H100 SXM (dense, no sparsity, at the full 700 W).
"""

from __future__ import annotations

from typing import Dict, Optional

PEAK_FLOPS = {"bfloat16": 989e12}     # tensor-core rate by compute dtype
PEAK_BYTES = 3.35e12                  # HBM3


def _width(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4}[dtype]


def bound_s(flops: float, nbytes: float, dtype: str) -> Optional[float]:
    """The least seconds the chip could take, or None without a peak for
    ``dtype``."""
    peak = PEAK_FLOPS.get(dtype)
    if peak is None:
        return None
    return max(flops / peak, nbytes / PEAK_BYTES)


def k1(B: int, k: int, d: int, dtype: str) -> Dict[str, float]:
    """The sampled logsumexp's forward: reps [B, d] against candidates
    [k, d], with the correction [k], the ids [k] and the positives [B]
    read, and the lse [B] written."""
    w = _width(dtype)
    return {"flops": 2.0 * B * k * d,
            "bytes": float((B + k) * d * w + k * 8 + B * 4 + B * 4)}


def k2(B: int, k: int, d: int, dtype: str) -> Dict[str, float]:
    """Its backward: the two gradient products (dreps = P C, dC = P^T R),
    not the logits recomputed; reads K1's inputs, the lse and the upstream
    gradient, writes dreps [B, d], dC [k, d] and dcorr [k] in float32."""
    w = _width(dtype)
    return {"flops": 4.0 * B * k * d,
            "bytes": float((B + k) * d * w + k * 8 + B * 12
                           + (B + k) * d * 4 + k * 4)}


def model_flops(B: int, k: int, word_dim: int, entity_dim: int) -> float:
    """A micro-step's model FLOPs: K1 and K2 at the entity width, and the
    projection, 2 B d_w d_e forward and twice that backward."""
    return (k1(B, k, entity_dim, "bfloat16")["flops"]
            + k2(B, k, entity_dim, "bfloat16")["flops"]
            + 6.0 * B * word_dim * entity_dim)
