"""Uniform model API dispatching on ``ModelConfig.model`` (port of
``sert_tpu/models/api.py`` :29-92).

All three families are ported for training and inference: ``loglinear``
and ``lse_full`` train with the full softmax (K5/K6), ``lse`` with the
binary NCE objective (plain PyTorch) or ``objective="sampled_softmax"``
(K1/K2).
"""

from __future__ import annotations

from typing import Optional

import torch

from sert_tpu_torch.models import loglinear, lse
from sert_tpu_torch.models.common import Params
from sert_tpu_torch.utils.config import ModelConfig

MODEL_FAMILIES = ("loglinear", "lse", "lse_full")


def _family(cfg: ModelConfig) -> str:
    if cfg.model not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family: {cfg.model!r}")
    return cfg.model


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    if _family(cfg) == "loglinear":
        return loglinear.init(generator, cfg, device)
    return lse.init(generator, cfg, device)


def loss_fn(params: Params, batch, cfg: ModelConfig,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training loss of a batch (scalar, differentiable in params)."""
    fam = _family(cfg)
    if fam == "loglinear":
        return loglinear.loss(params, batch, cfg)
    if fam == "lse_full":
        return lse.loss_full_softmax(params, batch, cfg)
    if cfg.objective == "sampled_softmax":
        return lse.loss_sampled_softmax(params, batch, cfg,
                                        generator=generator, noise=noise)
    if cfg.objective == "nce":
        return lse.loss(params, batch, cfg, generator=generator,
                        noise=noise)
    raise ValueError(f"unknown LSE objective: {cfg.objective!r}")


def window_rep(params: Params, windows: torch.Tensor, lengths: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """[B, d] query/window representations in scoring space: the pooled
    word embeddings (compute dtype) for log-linear, the projected fp32
    reps for LSE."""
    if _family(cfg) == "loglinear":
        return loglinear.pooled_rep(params, windows, lengths, cfg)
    return lse.window_rep(params, windows, lengths, cfg)


def entity_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """[E, d] the dense entity matrix the scoring engine multiplies against:
    ``proj_w.T`` (a view) for log-linear, ``entity_emb`` for LSE."""
    if _family(cfg) == "loglinear":
        return params["proj_w"].T
    return params["entity_emb"]


def entity_bias(params: Params, cfg: ModelConfig) -> Optional[torch.Tensor]:
    return params["proj_b"] if _family(cfg) == "loglinear" else None


def all_entity_scores(params: Params, windows: torch.Tensor,
                      lengths: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    """[B, E] fp32 dense scores of window reps against every entity
    (pre-softmax for log-linear, similarity for LSE)."""
    reps = window_rep(params, windows, lengths, cfg)
    scores = reps.float() @ entity_matrix(params, cfg).float().T
    b = entity_bias(params, cfg)
    return scores + b.float() if b is not None else scores


def query_scores(params: Params, term_ids: torch.Tensor,
                 num_terms: torch.Tensor, cfg: ModelConfig,
                 similarity: str = "dot") -> torch.Tensor:
    """[E] retrieval scores for one (padded) query."""
    if _family(cfg) == "loglinear":
        return loglinear.query_scores(params, term_ids, num_terms, cfg)
    return lse.query_scores(params, term_ids, num_terms, cfg, similarity)
