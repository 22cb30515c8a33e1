"""Run fusion: combine two (or more) TREC runs into one (a copy of
``sert_tpu/eval/fuse.py``).

The companion papers' headline tables combine the semantic model with a
lexical language model by linear score interpolation (SURVEY.md section 1
evaluation protocol); reciprocal rank fusion is included as the
rank-based alternative that needs no score calibration.

Methods:
  interp: score = sum_i w_i * norm(score_i), per topic. Documents missing
          from a run contribute that run's floor: 0.0 under minmax (the
          normalized minimum), the per-topic minimum otherwise.
  rrf:    score = sum_i w_i / (rrf_k + rank_i), unretrieved documents
          contribute 0 (Cormack et al., the standard convention).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

Run = Mapping[str, Sequence[Tuple[str, float]]]


def _normalize(entries: Sequence[Tuple[str, float]],
               how: str) -> Tuple[Dict[str, float], float]:
    """(normalized scores, floor for documents this run did NOT retrieve).

    All-equal scores carry no ORDERING information but retrieval itself is
    evidence: they map to 1.0 with floor 0.0 under BOTH minmax and zscore
    (not all-zeros, which would tie every retrieved doc with every
    unretrieved one and silently discard the run's contribution for that
    topic — the LM ranker produces legitimately-tied topics; a degenerate
    topic has no scale for zscore to preserve anyway). minmax's floor is
    always 0.0, the normalized minimum; zscore/none keep the per-topic
    minimum as floor."""
    docs = [d for d, _ in entries]
    s = np.asarray([v for _, v in entries], np.float64)
    if len(s) == 0:
        return {}, 0.0
    if how == "none":
        return dict(zip(docs, s.tolist())), float(s.min())
    if how == "minmax":
        lo, hi = s.min(), s.max()
        s = (s - lo) / (hi - lo) if hi > lo else np.ones_like(s)
        return dict(zip(docs, s.tolist())), 0.0
    if how == "zscore":
        sd = s.std()
        if sd == 0:
            return dict(zip(docs, np.ones_like(s).tolist())), 0.0
        s = (s - s.mean()) / sd
        return dict(zip(docs, s.tolist())), float(s.min())
    raise ValueError(f"unknown normalization {how!r}")


def fuse_runs(runs: Sequence[Run], weights: Sequence[float] = None,
              method: str = "interp", norm: str = "minmax",
              rrf_k: float = 60.0, k: int = 0,
              ) -> Dict[str, List[Tuple[str, float]]]:
    """Fuse runs over the union of their topics and documents.

    ``weights`` defaults to uniform; they need not sum to 1 (rankings are
    scale-invariant). ``k`` > 0 truncates each fused topic to the top k.
    """
    if not runs:
        raise ValueError("need at least one run")
    if weights is None:
        weights = [1.0] * len(runs)
    if len(weights) != len(runs):
        raise ValueError(f"{len(runs)} runs but {len(weights)} weights")
    if method not in ("interp", "rrf"):
        raise ValueError(f"unknown fusion method {method!r}")

    topics = sorted({t for r in runs for t in r})
    fused: Dict[str, List[Tuple[str, float]]] = {}
    for topic in topics:
        acc: Dict[str, float] = {}
        if method == "rrf":
            for run, w in zip(runs, weights):
                # Ranks follow the run file's score order (desc, stable).
                order = sorted(run.get(topic, ()), key=lambda e: -e[1])
                for rank, (doc, _) in enumerate(order, start=1):
                    acc[doc] = acc.get(doc, 0.0) + w / (rrf_k + rank)
        else:
            normed = [_normalize(run.get(topic, ()), norm) for run in runs]
            per_run = [s for s, _ in normed]
            floors = [f for _, f in normed]
            for doc in set().union(*per_run):
                acc[doc] = sum(w * s.get(doc, f) for s, f, w
                               in zip(per_run, floors, weights))
        ranked = sorted(acc.items(), key=lambda e: (-e[1], e[0]))
        fused[topic] = ranked[:k] if k > 0 else ranked
    return fused
