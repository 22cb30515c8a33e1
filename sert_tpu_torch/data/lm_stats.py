"""Per-entity term statistics for the lexical language-model baseline.

Both companion papers evaluate the semantic models against — and fused
with — a smoothed query-likelihood language model over each entity's
associated text (the classic profile-based baseline; SURVEY.md section 1
capability contract, "rank entities for a free-text query"). The
statistics are collected during the prepare sweep over the SAME encoded
token stream the window extractor consumes, so the LM sees exactly the
preprocessing (lowercase, stopwords, OOV-dropped) the semantic models see.

Design note (why this is host-side numpy, not a TPU kernel): the stats
are a sparse entity×term count matrix built once at prepare time by a
streaming reduction — integer scatter-adds with data-dependent sparsity,
no MXU work anywhere. Scoring (models/lm.py) is a handful of sparse
column gathers per query term. Shipping the sparse matrix to HBM would
cost more than the whole computation; the dense semantic scoring path is
where the TPU earns its keep.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

LM_STATS_NAME = "lm_stats.npz"


class LMStatsBuilder:
    """Streaming (entity, term) count accumulator for the prepare sweep.

    ``add`` is called once per document with the document's associated
    entity ids and its encoded token ids; memory grows with the number of
    distinct (doc, entity, term) triples, which are merged in ``finalize``
    by a single sort + segmented reduction.
    """

    def __init__(self, vocab_size: int):
        if vocab_size <= 0:
            raise ValueError("vocab_size must be positive")
        self.vocab_size = int(vocab_size)
        self._keys: List[np.ndarray] = []    # entity * V + term, int64
        self._cnts: List[np.ndarray] = []

    def add(self, entity_ids: Sequence[int], token_ids: Sequence[int]) -> None:
        if len(token_ids) == 0 or len(entity_ids) == 0:
            return
        terms, counts = np.unique(
            np.asarray(token_ids, dtype=np.int64), return_counts=True)
        for e in entity_ids:
            self._keys.append(int(e) * self.vocab_size + terms)
            self._cnts.append(counts)

    def finalize(self, num_entities: int) -> "LMStats":
        V = self.vocab_size
        if self._keys:
            keys = np.concatenate(self._keys)
            cnts = np.concatenate(self._cnts).astype(np.int64)
            order = np.argsort(keys, kind="stable")
            keys, cnts = keys[order], cnts[order]
            uniq, starts = np.unique(keys, return_index=True)
            sums = np.add.reduceat(cnts, starts)
        else:
            uniq = np.zeros(0, np.int64)
            sums = np.zeros(0, np.int64)
        ents = (uniq // V).astype(np.int32)
        terms = (uniq % V).astype(np.int32)

        indptr = np.zeros(num_entities + 1, np.int64)
        np.add.at(indptr, ents + 1, 1)
        indptr = np.cumsum(indptr)

        coll = np.zeros(V, np.int64)
        np.add.at(coll, terms, sums)
        return LMStats(indptr=indptr, terms=terms, counts=sums,
                       collection_counts=coll)


class LMStats:
    """CSR (by entity) term counts + collection statistics.

    A term-major (CSC) view is derived lazily for scoring: per query term,
    the scorer needs that term's (entity, count) column.
    """

    def __init__(self, indptr: np.ndarray, terms: np.ndarray,
                 counts: np.ndarray, collection_counts: np.ndarray):
        self.indptr = np.asarray(indptr, np.int64)
        self.terms = np.asarray(terms, np.int32)
        self.counts = np.asarray(counts, np.int64)
        self.collection_counts = np.asarray(collection_counts, np.int64)
        self.num_entities = len(self.indptr) - 1
        self.vocab_size = len(self.collection_counts)
        # Per-entity token totals (segmented sum; robust to empty rows).
        self.entity_len = np.zeros(self.num_entities, np.int64)
        if len(self.counts):
            row_of = np.repeat(np.arange(self.num_entities, dtype=np.int64),
                               np.diff(self.indptr))
            np.add.at(self.entity_len, row_of, self.counts)
        self.total_tokens = int(self.counts.sum())
        self._csc = None

    # -- term-major view ----------------------------------------------------

    def _build_csc(self):
        order = np.argsort(self.terms, kind="stable")
        t_sorted = self.terms[order]
        ent_of = np.repeat(
            np.arange(self.num_entities, dtype=np.int32),
            np.diff(self.indptr))
        t_indptr = np.zeros(self.vocab_size + 1, np.int64)
        np.add.at(t_indptr, t_sorted.astype(np.int64) + 1, 1)
        self._csc = (np.cumsum(t_indptr), ent_of[order], self.counts[order])

    def term_column(self, term_id: int):
        """(entity_ids, counts) of the entities whose text contains term_id."""
        if self._csc is None:
            self._build_csc()
        indptr, ents, cnts = self._csc
        lo, hi = indptr[term_id], indptr[term_id + 1]
        return ents[lo:hi], cnts[lo:hi]

    def collection_prob(self, term_id: int) -> float:
        """P(t | collection) where the collection is the concatenation of
        the ENTITY PSEUDO-DOCUMENTS (each document counted once per
        associated entity, consistent with entity_len/total_tokens) — the
        background model of the profile corpus the entity LMs are built
        from, not of the raw document collection. For one-to-one
        associations the two coincide; in many-to-many collections the
        pseudo-document background is the self-consistent choice for
        smoothing the same pseudo-document LMs."""
        if self.total_tokens == 0:
            return 0.0
        return float(self.collection_counts[term_id]) / self.total_tokens

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:   # file object: savez won't append .npz
            np.savez_compressed(fh, indptr=self.indptr, terms=self.terms,
                                counts=self.counts,
                                collection_counts=self.collection_counts)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "LMStats":
        with np.load(path) as z:
            return cls(indptr=z["indptr"], terms=z["terms"],
                       counts=z["counts"],
                       collection_counts=z["collection_counts"])
