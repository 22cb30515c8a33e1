"""Entity registry and entity-document associations.

Reference behavior (SURVEY.md section 3.1 "Entity-document associations"):
experts are associated to enterprise documents via authorship/e-mail
heuristics; products are associated to their own review/description text.
Here both reduce to an explicit many-to-many doc_id -> [entity_id] map the
window extractor consumes.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple


class EntityRegistry:
    """Dense int32 ids for entity identifiers (experts, products)."""

    def __init__(self, names: Sequence[str] = ()):  # deterministic order
        self._names: List[str] = list(names)
        self._index: Dict[str, int] = {n: i for i, n in enumerate(self._names)}
        if len(self._index) != len(self._names):
            raise ValueError("duplicate entity names")

    def __len__(self) -> int:
        return len(self._names)

    def add(self, name: str) -> int:
        if name in self._index:
            return self._index[name]
        idx = len(self._names)
        self._names.append(name)
        self._index[name] = idx
        return idx

    def id(self, name: str) -> int:
        return self._index[name]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def name(self, idx: int) -> str:
        return self._names[idx]

    @property
    def names(self) -> List[str]:
        return list(self._names)

    def save(self, path: str) -> None:
        self.write(path, self._names)

    @staticmethod
    def write(path: str, names: Sequence[str]) -> None:
        """Write ``names`` in :meth:`save`'s format without building a
        registry's name index (seconds at 10M names)."""
        with open(path, "w") as fh:
            fh.write(json.dumps(list(names)))

    @classmethod
    def load(cls, path: str) -> "EntityRegistry":
        with open(path) as fh:
            return cls(json.load(fh))


class Associations:
    """doc_id -> list of entity ids (dense ints from an EntityRegistry)."""

    def __init__(self) -> None:
        self._by_doc: Dict[str, List[int]] = {}

    def add(self, doc_id: str, entity_id: int) -> None:
        lst = self._by_doc.setdefault(doc_id, [])
        if entity_id not in lst:
            lst.append(entity_id)

    def entities_for(self, doc_id: str) -> List[int]:
        return self._by_doc.get(doc_id, [])

    def __len__(self) -> int:
        return len(self._by_doc)

    def items(self) -> Iterable[Tuple[str, List[int]]]:
        return self._by_doc.items()

    def entity_instance_counts(self, num_entities: int) -> List[int]:
        """How many doc-associations each entity has (for unigram negative
        sampling distributions)."""
        counts = [0] * num_entities
        for ents in self._by_doc.values():
            for e in ents:
                counts[e] += 1
        return counts

    def save(self, path: str) -> None:
        self.write(path, self._by_doc)

    @staticmethod
    def write(path: str, by_doc: Dict[str, List[int]]) -> None:
        """Write a doc_id -> entity ids map in :meth:`save`'s format
        without building an Associations."""
        with open(path, "w") as fh:
            fh.write(json.dumps(by_doc))

    @classmethod
    def load(cls, path: str) -> "Associations":
        a = cls()
        with open(path) as fh:
            a._by_doc = {k: list(v) for k, v in json.load(fh).items()}
        return a
