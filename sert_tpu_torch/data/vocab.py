"""Vocabulary construction: top-N terms with stopword/min-frequency filtering.

Reference behavior (SURVEY.md section 3.1): build a vocabulary of the most
frequent terms, drop out-of-vocabulary tokens entirely (they simply vanish
from the window stream). Term ids are dense int32 in [0, size).

Id 0 is NOT reserved: OOV terms are dropped, not mapped, exactly as in the
reference pipeline. Padding of short windows is handled by an explicit
``length`` field downstream (see windows.py), never by a sentinel token.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional, Sequence


class Vocabulary:
    """Immutable term <-> id mapping plus per-term counts."""

    def __init__(self, terms: Sequence[str], counts: Optional[Sequence[int]] = None):
        self._terms: List[str] = list(terms)
        self._counts: List[int] = list(counts) if counts is not None else [0] * len(terms)
        self._index: Dict[str, int] = {t: i for i, t in enumerate(self._terms)}
        if len(self._index) != len(self._terms):
            raise ValueError("duplicate terms in vocabulary")

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls,
        token_streams: Iterable[Iterable[str]],
        max_size: int = 65536,
        min_count: int = 2,
    ) -> "Vocabulary":
        """Two-pass contract, pass 1: count tokens, keep top-``max_size`` terms
        with frequency >= ``min_count``. Deterministic tie-break: higher count
        first, then lexicographic."""
        counter: Counter = Counter()
        for stream in token_streams:
            counter.update(stream)
        return cls.from_counter(counter, max_size, min_count)

    @classmethod
    def from_counter(cls, counter: Counter, max_size: int = 65536,
                     min_count: int = 2) -> "Vocabulary":
        """Build from pre-merged term counts (the multiprocessing prepare
        path merges per-worker Counters, then calls this)."""
        items = [(t, c) for t, c in counter.items() if c >= min_count]
        items.sort(key=lambda tc: (-tc[1], tc[0]))
        items = items[:max_size]
        return cls([t for t, _ in items], [c for _, c in items])

    # -- lookup ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._terms)

    def __contains__(self, term: str) -> bool:
        return term in self._index

    def id(self, term: str) -> int:
        return self._index[term]

    def term(self, idx: int) -> str:
        return self._terms[idx]

    def count(self, idx: int) -> int:
        return self._counts[idx]

    @property
    def counts(self) -> List[int]:
        return list(self._counts)

    def encode(self, tokens: Iterable[str]) -> List[int]:
        """Map tokens to ids, dropping OOV (reference semantics)."""
        idx = self._index
        return [idx[t] for t in tokens if t in idx]

    @property
    def term_to_id(self) -> Dict[str, int]:
        """The term->id map (treat as read-only; handed to worker pools)."""
        return self._index

    def iter_terms(self) -> Iterator[str]:
        return iter(self._terms)

    # -- persistence -------------------------------------------------------

    def content_hash(self) -> str:
        """Stable hash recorded in checkpoints so a scorer can refuse to load
        params trained against a different vocabulary."""
        h = hashlib.sha256()
        for t in self._terms:
            h.update(t.encode())
            h.update(b"\x00")
        return h.hexdigest()[:16]

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({"terms": self._terms, "counts": self._counts}, fh)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as fh:
            d = json.load(fh)
        return cls(d["terms"], d.get("counts"))
