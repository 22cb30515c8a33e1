"""Entity scoring engines, LSE branches (port of
``sert_tpu/scoring/scorer.py``).

scores = R @ M^T with R [Q, d] the query reps and M [E, d] the entity
matrix (both unit rows under cosine similarity). ``dense_scores`` is the
exact [Q, E] product; ``pallas_topk`` is the kernel engine (K3 + K4 via
``ops.exact_topk``; the name is the reference's, shared by the recipes).
The log-linear branches (bias, exact normalizer: K5) and the streaming
engine come later (ROADMAP Queue 1 items 4 and 6); ``models.api`` raises
for log-linear params.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sert_tpu.utils.config import ModelConfig
from sert_tpu_torch.models import api
from sert_tpu_torch.models.common import unit_rows
from sert_tpu_torch.ops.exact_topk import (exact_topk_prepared,
                                           prepare_entities)


def _query_reps_and_terms(params, cfg: ModelConfig, term_ids: torch.Tensor,
                          num_terms: torch.Tensor, similarity: str):
    """(R [Q, d] fp32, None, mask [Q, T]); the middle slot holds the
    log-linear term embeddings in the reference."""
    T = term_ids.shape[1]
    mask = (torch.arange(T, device=term_ids.device)[None, :]
            < num_terms[:, None])
    reps = api.window_rep(params, term_ids, num_terms, cfg)
    if similarity == "cosine":
        reps = unit_rows(reps)
    return reps, None, mask


def _entity_matrix(params, cfg: ModelConfig, similarity: str
                   ) -> torch.Tensor:
    """[E, d] fp32, normalized in fp32 (before any bf16 staging cast)."""
    M = api.entity_matrix(params, cfg).float()
    if similarity == "cosine":
        M = unit_rows(M)
    return M


def dense_scores(params, cfg: ModelConfig, term_ids: torch.Tensor,
                 num_terms: torch.Tensor, similarity: str = "dot"
                 ) -> torch.Tensor:
    """Exact [Q, E] fp32 similarity scores (TF32 must be off on the card)."""
    R, _, _ = _query_reps_and_terms(params, cfg, term_ids, num_terms,
                                    similarity)
    return R @ _entity_matrix(params, cfg, similarity).T


def pallas_topk(params, cfg: ModelConfig, term_ids: torch.Tensor,
                num_terms: torch.Tensor, k: int = 100,
                similarity: str = "dot", prep=None,
                adaptive_bins: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores, entity ids) through the kernel engine.

    ``prep``: ops.exact_topk.prepare_entities of the entity matrix, staged
    once and reused across batches (score_topics does)."""
    R, _, _ = _query_reps_and_terms(params, cfg, term_ids, num_terms,
                                    similarity)
    if prep is None:
        prep = prepare_entities(_entity_matrix(params, cfg, similarity))
    return exact_topk_prepared(R, prep, k=k, adaptive_bins=adaptive_bins)
