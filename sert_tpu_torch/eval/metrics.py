"""Native trec_eval-style retrieval metrics.

Conventions follow trec_eval (the reference's oracle, SURVEY.md section 4.4):

  * Ranking order: score descending, ties broken by document id DESCENDING
    (trec_eval's historical tie-break).
  * Relevance: graded integers; rel > 0 counts as relevant for the binary
    metrics (MAP, MRR, P@k, recall@k).
  * NDCG: linear gain rel_i / log2(i + 1), ideal from the qrels' own sorted
    grades (trec_eval's "ndcg" measure).

All functions take ``ranking`` as an already-ordered list of doc ids and
``rels`` as {doc_id: grade}; :func:`evaluate_run` applies the canonical sort.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple


def _binary(rels: Mapping[str, int]) -> set:
    return {d for d, r in rels.items() if r > 0}


def rank_run_entries(entries: Iterable[Tuple[str, float]]) -> List[str]:
    """Canonical trec_eval ordering: score desc, docno desc on ties."""
    return [d for d, _ in sorted(entries, key=lambda e: (e[1], e[0]), reverse=True)]


def ndcg_at_k(ranking: Sequence[str], rels: Mapping[str, int], k: int) -> float:
    dcg = 0.0
    for i, doc in enumerate(ranking[:k]):
        g = rels.get(doc, 0)
        if g > 0:
            dcg += g / math.log2(i + 2)
    ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
    idcg = sum(g / math.log2(i + 2) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def average_precision(ranking: Sequence[str], rels: Mapping[str, int]) -> float:
    relevant = _binary(rels)
    if not relevant:
        return 0.0
    hits, total = 0, 0.0
    for i, doc in enumerate(ranking):
        if doc in relevant:
            hits += 1
            total += hits / (i + 1)
    return total / len(relevant)


def reciprocal_rank(ranking: Sequence[str], rels: Mapping[str, int]) -> float:
    relevant = _binary(rels)
    for i, doc in enumerate(ranking):
        if doc in relevant:
            return 1.0 / (i + 1)
    return 0.0


def precision_at_k(ranking: Sequence[str], rels: Mapping[str, int], k: int) -> float:
    relevant = _binary(rels)
    return sum(1 for d in ranking[:k] if d in relevant) / k


def recall_at_k(ranking: Sequence[str], rels: Mapping[str, int], k: int) -> float:
    relevant = _binary(rels)
    if not relevant:
        return 0.0
    return sum(1 for d in ranking[:k] if d in relevant) / len(relevant)


DEFAULT_MEASURES = ("ndcg@100", "map", "recip_rank", "p@5", "p@10",
                    "recall@100", "recall@1000")


def evaluate_topic(entries: Iterable[Tuple[str, float]],
                   rels: Mapping[str, int],
                   measures: Sequence[str] = DEFAULT_MEASURES) -> Dict[str, float]:
    ranking = rank_run_entries(entries)
    out: Dict[str, float] = {}
    for m in measures:
        if m == "map":
            out[m] = average_precision(ranking, rels)
        elif m == "recip_rank":
            out[m] = reciprocal_rank(ranking, rels)
        elif m.startswith("ndcg@"):
            out[m] = ndcg_at_k(ranking, rels, int(m.split("@")[1]))
        elif m.startswith("p@"):
            out[m] = precision_at_k(ranking, rels, int(m.split("@")[1]))
        elif m.startswith("recall@"):
            out[m] = recall_at_k(ranking, rels, int(m.split("@")[1]))
        else:
            raise ValueError(f"unknown measure: {m}")
    return out


def evaluate_run(run: Mapping[str, Iterable[Tuple[str, float]]],
                 qrels: Mapping[str, Mapping[str, int]],
                 measures: Sequence[str] = DEFAULT_MEASURES,
                 judged_only: bool = False,
                 ) -> Dict[str, Dict[str, float]]:
    """Per-topic metrics plus macro-averaged ``"all"`` row.

    Topics present in qrels but missing from the run score 0 (trec_eval
    -c semantics: judged topics always count). ``judged_only`` drops
    unjudged documents from the run before scoring (trec_eval -J).
    """
    if "all" in qrels:
        # trec_eval's own reserved summary id; a real topic named "all"
        # would silently overwrite the macro row and deflate every average.
        raise ValueError(
            'topic id "all" is reserved for the macro-average row '
            "(trec_eval convention); rename the topic in the qrels")
    per_topic: Dict[str, Dict[str, float]] = {}
    for qid, rels in qrels.items():
        entries = run.get(qid, [])
        if judged_only:
            entries = [(d, s) for d, s in entries if d in rels]
        per_topic[qid] = evaluate_topic(entries, rels, measures)
    n = max(len(per_topic), 1)
    per_topic["all"] = {
        m: sum(t[m] for q, t in per_topic.items() if q != "all") / n
        for m in measures}
    return per_topic
