"""Shared model pieces: pooling, dtype handling, initializers
(port of ``sert_tpu/models/common.py``)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from sert_tpu_torch.utils.config import ModelConfig

Params = Dict[str, torch.Tensor]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16


def use_fused(cfg: ModelConfig, device: torch.device) -> bool:
    """Whether a loss takes its kernel path (K1/K2 for the sampled
    objective, K5/K6 for the full softmax): "on" always, "off" never (the
    plain version, on any device), "auto" on CUDA tensors. The reference's
    thresholds (k >= 2048, E >= 4096) and VMEM plans are TPU measurements
    and are not carried over."""
    if cfg.fused_softmax == "on":
        return True
    if cfg.fused_softmax == "off":
        return False
    return device.type == "cuda"


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (a zero row stays zero), for cosine
    similarity."""
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def masked_mean_pool(rows: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """Masked mean over pre-gathered window rows: [B, w, d], [B] -> [B, d].
    Positions past each length are excluded; a zero-length window gives a
    zero vector, not NaN. Computed in ``rows``' dtype, like the reference."""
    w = rows.shape[1]
    mask = torch.arange(w, device=rows.device)[None, :] < lengths[:, None]
    rows = rows * mask[:, :, None].to(rows.dtype)
    denom = lengths.clamp(min=1).to(rows.dtype)[:, None]
    return rows.sum(dim=1) / denom


def masked_mean_embed(word_emb: torch.Tensor, windows: torch.Tensor,
                      lengths: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Masked-mean pooling of word embeddings over fixed-width windows
    (int [B, w], lengths int [B]). ``dtype`` casts the gathered rows only,
    which equals casting the whole table first (the reference's order)
    without copying the table. The gather is ``F.embedding``, whose
    backward sums duplicate ids in a fixed order (indexing's backward does
    not on the CPU), so that resume is exact."""
    rows = F.embedding(windows.long(), word_emb)
    if dtype is not None:
        rows = rows.to(dtype)
    return masked_mean_pool(rows, lengths)


def scaled_normal_init(generator: torch.Generator, shape, dim: int,
                       dtype: torch.dtype = torch.float32,
                       device=None) -> torch.Tensor:
    """N(0, 1/dim) init, drawn from ``generator`` (on ``device``)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * (1.0 / math.sqrt(dim))).to(dtype)
