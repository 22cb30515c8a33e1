"""Smoothed query-likelihood entity language model (lexical baseline;
port of ``sert_tpu/models/lm.py``: ``load_lm`` :29, ``EntityLM`` :52).

The companion papers report every semantic result next to — and linearly
combined with — a profile-based language model: concatenate each entity's
associated text, estimate P(t|e) with smoothing, rank by
``log P(q|e) = sum_t c(t; q) * log P_smooth(t|e)`` (SURVEY.md section 1;
the WWW 2016 / CIKM 2016 evaluation protocol). This module provides that
baseline natively so `query --ranker lm` and `fuse` reproduce the papers'
ensemble workflow offline.

Smoothing:
  dirichlet:  P(t|e) = (tf(t,e) + mu * P(t|C)) / (len_e + mu)
  jm:         P(t|e) = (1-lam) * tf(t,e)/len_e + lam * P(t|C)

Scoring is host-side numpy over the sparse prepare-time statistics
(data/lm_stats.py documents why this is not a device kernel), chunked over
the entity axis with a running top-k so memory stays O(Q * (k + chunk)).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from sert_tpu_torch.data.lm_stats import LM_STATS_NAME, LMStats


def load_lm(data_dir: str, smoothing: str = "dirichlet", mu: float = 2000.0,
            lam: float = 0.5):
    """(EntityLM, Vocabulary, EntityRegistry) from a prepared data dir — the
    one loader for every LM surface (query --ranker lm, report) so the
    stats filename, error message, and defaults cannot drift between them."""
    import os

    from sert_tpu_torch.data.assoc import EntityRegistry
    from sert_tpu_torch.data.prepare import ENTITIES_NAME, VOCAB_NAME
    from sert_tpu_torch.data.vocab import Vocabulary

    stats_path = os.path.join(data_dir, LM_STATS_NAME)
    if not os.path.exists(stats_path):
        raise FileNotFoundError(
            f"{stats_path} not found — re-run prepare with "
            f"data.build_lm_stats=true (the default)")
    vocab = Vocabulary.load(os.path.join(data_dir, VOCAB_NAME))
    registry = EntityRegistry.load(os.path.join(data_dir, ENTITIES_NAME))
    lm = EntityLM(LMStats.load(stats_path), smoothing=smoothing, mu=mu,
                  lam=lam)
    return lm, vocab, registry


class EntityLM:
    def __init__(self, stats: LMStats, smoothing: str = "dirichlet",
                 mu: float = 2000.0, lam: float = 0.5):
        if smoothing not in ("dirichlet", "jm"):
            raise ValueError(f"unknown smoothing {smoothing!r}")
        if smoothing == "dirichlet" and mu <= 0:
            raise ValueError("dirichlet smoothing needs mu > 0")
        if smoothing == "jm" and not (0.0 < lam < 1.0):
            raise ValueError("jm smoothing needs 0 < lam < 1")
        self.stats = stats
        self.smoothing = smoothing
        self.mu = float(mu)
        self.lam = float(lam)

    # -- core ---------------------------------------------------------------

    def _term_log_probs(self, term_id: int, lo: int, hi: int) -> np.ndarray:
        """log P_smooth(term | e) for entities in [lo, hi)."""
        s = self.stats
        p_c = s.collection_prob(term_id)
        ln = s.entity_len[lo:hi].astype(np.float64)
        ents, cnts = s.term_column(term_id)
        tf = np.zeros(hi - lo, np.float64)
        # The column's entity ids ascend (stable sort of CSR order), so the
        # chunk's hits are one searchsorted slice — not an O(nnz) boolean
        # scan per chunk, which made frequent terms O(n_chunks * nnz).
        a, b = np.searchsorted(ents, (lo, hi))
        tf[ents[a:b] - lo] = cnts[a:b]
        if self.smoothing == "dirichlet":
            return np.log(tf + self.mu * p_c) - np.log(ln + self.mu)
        # jm; entities with no text fall back to the background model alone.
        safe_len = np.maximum(ln, 1.0)
        return np.log((1.0 - self.lam) * tf / safe_len + self.lam * p_c)

    def score(self, queries: Sequence[Sequence[int]],
              chunk: int = 1 << 16) -> np.ndarray:
        """[Q, E] query log-likelihoods. Empty (all-OOV) queries score 0
        everywhere — the same degenerate constant ranking the semantic
        scorer produces for them."""
        E = self.stats.num_entities
        out = np.zeros((len(queries), E), np.float64)
        for lo in range(0, E, chunk):
            hi = min(lo + chunk, E)
            cache: Dict[int, np.ndarray] = {}
            for qi, terms in enumerate(queries):
                for t in terms:
                    t = int(t)
                    if self.stats.collection_counts[t] == 0:
                        continue   # term absent from the collection
                    if t not in cache:
                        cache[t] = self._term_log_probs(t, lo, hi)
                    out[qi, lo:hi] += cache[t]
        return out

    def topk(self, queries: Sequence[Sequence[int]], k: int,
             chunk: int = 1 << 16) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], entity indices [Q, k]), descending, running
        top-k per entity chunk (never materializes [Q, E])."""
        E = self.stats.num_entities
        k = min(k, E)
        Q = len(queries)
        best_s = np.full((Q, k), -np.inf)
        best_i = np.zeros((Q, k), np.int64)
        for lo in range(0, E, chunk):
            hi = min(lo + chunk, E)
            cache: Dict[int, np.ndarray] = {}
            sc = np.zeros((Q, hi - lo), np.float64)
            for qi, terms in enumerate(queries):
                for t in terms:
                    t = int(t)
                    if self.stats.collection_counts[t] == 0:
                        continue
                    if t not in cache:
                        cache[t] = self._term_log_probs(t, lo, hi)
                    sc[qi] += cache[t]
            cand_s = np.concatenate([best_s, sc], axis=1)
            cand_i = np.concatenate(
                [best_i, np.broadcast_to(np.arange(lo, hi), (Q, hi - lo))],
                axis=1)
            part = np.argpartition(-cand_s, k - 1, axis=1)[:, :k]
            rows = np.arange(Q)[:, None]
            best_s = cand_s[rows, part]
            best_i = cand_i[rows, part]
        order = np.argsort(-best_s, kind="stable", axis=1)
        rows = np.arange(Q)[:, None]
        return best_s[rows, order], best_i[rows, order]

    # -- TREC-run front end ---------------------------------------------------

    def rank_topics(self, encoded: Mapping[str, Sequence[int]],
                    entity_names: Sequence[str], k: int = 100,
                    chunk: int = 1 << 16) -> Dict[str, List[Tuple[str, float]]]:
        """Run-file dict {topic: [(entity, score) ...]} like score_topics.

        Topics with no scoreable term come back as empty lists, matching
        scoring/run.py's semantics — emitting k arbitrary zero-scored
        entities would add pure noise to the run and skew any fusion
        against the semantic ranker. "No scoreable term" covers both empty
        encodings (every term OOV) and terms that are in-vocab but absent
        from the LM collection (the vocabulary is built from ALL documents;
        the statistics only from associated ones), which the scorer skips
        and which would otherwise leave the topic at a constant 0."""
        tids = list(encoded.keys())
        cc = self.stats.collection_counts
        live = [t for t in tids
                if any(cc[int(term)] > 0 for term in encoded[t])]
        run: Dict[str, List[Tuple[str, float]]] = {t: [] for t in tids}
        if live:
            scores, idx = self.topk([encoded[t] for t in live], k=k,
                                    chunk=chunk)
            for q, tid in enumerate(live):
                run[tid] = [(entity_names[int(i)], float(s))
                            for s, i in zip(scores[q], idx[q])]
        return run
