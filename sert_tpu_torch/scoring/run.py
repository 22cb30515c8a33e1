"""Topics -> TREC run glue (port of ``sert_tpu/scoring/run.py``): batch
queries, score them against every entity, keep the top k per topic.

Queries pad to a fixed term budget; topics whose terms are all out of
vocabulary yield empty result lists.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sert_tpu_torch.ops.exact_topk import (prepare_entities,
                                           resolve_rescore_dtype)
from sert_tpu_torch.scoring.scorer import (_entity_matrix, dense_scores,
                                           pallas_topk)
from sert_tpu_torch.utils.config import ModelConfig, ScoreConfig

_NOT_PORTED = ("streaming", "approx", "distributed")


def resolve_engine(sc: ScoreConfig, num_entities: int,
                   device: torch.device) -> str:
    """The scoring engine for params on ``device``. "pallas" is the K3 + K4
    kernel engine (the recipes' name for it). "auto": that engine on a CUDA
    device; on the CPU dense scoring up to ``entity_chunk`` entities, else
    the engine's plain versions (the reference's streaming scan is not
    ported yet). ``use_pallas`` is the legacy alias."""
    if sc.use_pallas:
        return "pallas"
    if sc.engine in _NOT_PORTED:
        raise NotImplementedError(
            f"scoring engine {sc.engine!r} is not ported yet (ROADMAP "
            "Queue 1 items 4, 11 and 12)")
    if sc.engine != "auto":
        if sc.engine not in ("dense", "pallas"):
            raise ValueError(f"unknown scoring engine {sc.engine!r}")
        return sc.engine
    if device.type == "cuda" or num_entities > sc.entity_chunk:
        return "pallas"
    return "dense"


def stage_entities(params, cfg: ModelConfig, sc: ScoreConfig):
    """The kernel engine's one-time staging of the entity matrix
    (ops.exact_topk.prepare_entities) in the rescore dtype ``sc`` resolves
    for it."""
    M = _entity_matrix(params, cfg, sc.similarity)
    rdt = resolve_rescore_dtype(sc.rescore_dtype, *M.shape)
    return prepare_entities(M, rescore_dtype=rdt, layout=sc.layout)


# The engine's query-term budget; longer queries truncate.
MAX_QUERY_TERMS = 16


def pad_queries(encoded: Mapping[str, Sequence[int]],
                max_terms: int = MAX_QUERY_TERMS,
                ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(qids, term_ids [Q, T], num_terms [Q]); long queries truncate to T."""
    qids = sorted(encoded)
    Q = len(qids)
    term_ids = np.zeros((Q, max_terms), np.int32)
    num_terms = np.zeros((Q,), np.int32)
    for i, qid in enumerate(qids):
        ids = list(encoded[qid])[:max_terms]
        term_ids[i, :len(ids)] = ids
        num_terms[i] = len(ids)
    return qids, term_ids, num_terms


def score_topics(
    params,
    cfg: ModelConfig,
    encoded_topics: Mapping[str, Sequence[int]],
    entity_names: Sequence[str],
    score_cfg: Optional[ScoreConfig] = None,
    max_terms: int = MAX_QUERY_TERMS,
    prep=None,
) -> Dict[str, List[Tuple[str, float]]]:
    """Score every topic against every entity; returns a TREC run dict
    {qid: [(entity_name, score), ...]} with the top k per topic.

    Runs on the params' device. ``prep``: the kernel engine's one-time
    staging (ops.exact_topk.prepare_entities), for repeated calls; without
    it each call stages the entity matrix again."""
    sc = score_cfg or ScoreConfig()
    qids, term_ids, num_terms = pad_queries(encoded_topics, max_terms)
    E = len(entity_names)
    run: Dict[str, List[Tuple[str, float]]] = {qid: [] for qid in qids}
    device = params["word_emb"].device

    engine = resolve_engine(sc, E, device)
    if engine == "pallas" and prep is None:
        prep = stage_entities(params, cfg, sc)

    B = sc.query_batch
    k = min(sc.top_k, E)

    def dispatch(t, m):
        """Queue one device batch without a host sync: every batch is
        enqueued back to back and read back below."""
        t = torch.from_numpy(t).to(device)
        m = torch.from_numpy(m).to(device)
        if engine == "pallas":
            return pallas_topk(params, cfg, t, m, k=k,
                               similarity=sc.similarity, prep=prep,
                               normalize=sc.normalize_scores,
                               adaptive_bins=sc.adaptive_bins)
        scores = dense_scores(params, cfg, t, m, similarity=sc.similarity)
        return torch.topk(scores, k, dim=1)

    pending = []
    with torch.no_grad():
        for lo in range(0, len(qids), B):
            hi = min(lo + B, len(qids))
            n = hi - lo
            # Pad the last batch to the fixed batch size.
            t = np.zeros((B, max_terms), np.int32)
            m = np.zeros((B,), np.int32)
            t[:n], m[:n] = term_ids[lo:hi], num_terms[lo:hi]
            pending.append((lo, n, m, dispatch(t, m)))

    for lo, n, m, (top_s, idx) in pending:
        top_s, idx = top_s.cpu().numpy(), idx.cpu().numpy()   # sync point
        for qi in range(n):
            if m[qi] == 0:
                continue  # all-OOV query: no meaningful scores
            order = np.argsort(-top_s[qi], kind="stable")
            run[qids[lo + qi]] = [(entity_names[idx[qi, j]],
                                   float(top_s[qi, j])) for j in order]
    return run
