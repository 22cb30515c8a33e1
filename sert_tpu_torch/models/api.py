"""Uniform model API dispatching on ``ModelConfig.model`` (port of
``sert_tpu/models/api.py`` :29-92).

The LSE families (``lse``, ``lse_full``) are ported for inference, where
they share one model; ``loss_fn`` trains ``lse`` with
``objective="sampled_softmax"``. The log-linear family and ``lse_full``
training come with ROADMAP Queue 1 item 6, the NCE objective with item 7;
each raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Optional

import torch

from sert_tpu.utils.config import ModelConfig
from sert_tpu_torch.models import lse
from sert_tpu_torch.models.common import Params

MODEL_FAMILIES = ("loglinear", "lse", "lse_full")


def _family(cfg: ModelConfig) -> str:
    if cfg.model not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family: {cfg.model!r}")
    if cfg.model == "loglinear":
        raise NotImplementedError(
            "the log-linear family is not ported yet (ROADMAP Queue 1 "
            "item 6: log-linear + lse_full)")
    return cfg.model


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    _family(cfg)
    return lse.init(generator, cfg, device)


def loss_fn(params: Params, batch, cfg: ModelConfig,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training loss of a batch (scalar, differentiable in params)."""
    fam = _family(cfg)
    if fam == "lse_full":
        raise NotImplementedError(
            "lse_full training (the full softmax over all entities, K5/K6) "
            "is not ported yet (ROADMAP Queue 1 item 6: log-linear + "
            "lse_full)")
    if cfg.objective == "sampled_softmax":
        return lse.loss_sampled_softmax(params, batch, cfg,
                                        generator=generator, noise=noise)
    if cfg.objective == "nce":
        raise NotImplementedError(
            "the LSE nce objective is not ported yet (ROADMAP Queue 1 "
            "item 7: NCE objective); use objective='sampled_softmax'")
    raise ValueError(f"unknown LSE objective: {cfg.objective!r}")


def window_rep(params: Params, windows: torch.Tensor, lengths: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """[B, d] query/window representations in scoring space."""
    _family(cfg)
    return lse.window_rep(params, windows, lengths, cfg)


def entity_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """[E, d] the dense entity matrix the scoring engine multiplies against."""
    _family(cfg)
    return params["entity_emb"]


def entity_bias(params: Params, cfg: ModelConfig) -> Optional[torch.Tensor]:
    _family(cfg)
    return None


def all_entity_scores(params: Params, windows: torch.Tensor,
                      lengths: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    """[B, E] fp32 dense scores of window reps against every entity."""
    reps = window_rep(params, windows, lengths, cfg)
    return reps.float() @ entity_matrix(params, cfg).float().T


def query_scores(params: Params, term_ids: torch.Tensor,
                 num_terms: torch.Tensor, cfg: ModelConfig,
                 similarity: str = "dot") -> torch.Tensor:
    """[E] retrieval scores for one (padded) query."""
    _family(cfg)
    return lse.query_scores(params, term_ids, num_terms, cfg, similarity)
