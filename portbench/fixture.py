"""The training traffic: instance shards made from a seed.

The mix is the recipes' own stand-in collection (``SYNTH_1M`` and
``SYNTH_10M`` in ``sert_tpu_torch/recipes.py``: ``make_synthetic`` in its
hard mode, read by ``prepare`` into stride-1 windows), drawn window by
window instead of document by document, so that a cut of an epoch of
500M windows is made in seconds:

- documents: entity i (entities by id) has max(1, round(docs_per_entity *
  w_i)) documents of ``doc_len`` terms, w_i = (i + 1) ** -doc_skew scaled
  to mean 1 (the hard mode's association skew). A document gives
  doc_len - window + 1 windows, all of the same length, so an entity
  carries windows in proportion to its documents, and its association
  count, which the unigram noise is drawn from, is its documents;
- signatures: entities come in groups of ``group_size`` consecutive ids
  whose first ``signature_size // 2`` terms are the group's, the rest the
  entity's own, all from the ids at or above ``signature_floor_share`` of
  the vocabulary;
- terms: each term of a window is one of its entity's signature terms
  with probability ``signal``, else an id drawn with weight
  1 / (id + 1) ** noise_zipf (the background Zipf).

The cut's windows are drawn independently, each from a document drawn
uniformly, and written in the on-disk format of the port's
``InstanceDataset``. Where the stand-in differs: it deals signature terms
from a shuffled pool (here drawn with replacement), renumbers terms by
frequency (here the drawn ids are kept), and reads every window of every
document (here a sample of them).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

META_NAME = "instances.meta.json"
CHUNK = 1 << 18           # windows drawn per round of the generator


class _ShardWriter:
    """Buffers windows and writes shards of ``per_shard`` instances, each
    permuted, as the port's ``InstanceWriter`` does."""

    def __init__(self, out_dir: str, per_shard: int, rng):
        self.out_dir = out_dir
        self.per_shard = per_shard
        self.rng = rng
        self.buf: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.buffered = 0
        self.shards: List[Dict] = []

    def add(self, windows, lengths, entities) -> None:
        self.buf.append((windows, lengths, entities))
        self.buffered += windows.shape[0]
        while self.buffered >= self.per_shard:
            self._flush(self.per_shard)

    def _flush(self, n: int) -> None:
        w, l, e = (np.concatenate([b[i] for b in self.buf]) for i in range(3))
        perm = self.rng.permutation(n)
        name = f"shard-{len(self.shards):05d}.npz"
        np.savez(os.path.join(self.out_dir, name), windows=w[:n][perm],
                 lengths=l[:n][perm], entities=e[:n][perm])
        self.shards.append({"path": name, "num": int(n)})
        self.buf = [(w[n:], l[n:], e[n:])]
        self.buffered = int(w.shape[0] - n)

    def finalize(self) -> List[Dict]:
        if self.buffered:
            self._flush(self.buffered)
        return self.shards


def documents(num_entities: int, traffic: Dict) -> np.ndarray:
    """[E] int64: each entity's documents (its association count)."""
    w = (np.arange(num_entities, dtype=np.float64) + 1.0) \
        ** -float(traffic["doc_skew"])
    w *= num_entities / w.sum()
    return np.maximum(1, np.round(traffic["docs_per_entity"] * w)).astype(
        np.int64)


def epoch_windows(num_entities: int, window: int, traffic: Dict) -> int:
    """The windows of one epoch of the whole stand-in."""
    per_doc = max(int(traffic["doc_len"]) - window + 1, 1)
    return int(documents(num_entities, traffic).sum()) * per_doc


def signatures(rng, num_entities: int, vocab_size: int,
               traffic: Dict) -> np.ndarray:
    """[E, signature_size] int32: the group's terms, then the entity's."""
    S, g = int(traffic["signature_size"]), int(traffic["group_size"])
    lo = int(vocab_size * traffic["signature_floor_share"])
    groups = -(-num_entities // g)
    shared = rng.integers(lo, vocab_size, size=(groups, S // 2),
                          dtype=np.int32)
    own = rng.integers(lo, vocab_size, size=(num_entities, S - S // 2),
                       dtype=np.int32)
    return np.concatenate([shared[np.arange(num_entities) // g], own], axis=1)


def _cdf(weights: np.ndarray) -> np.ndarray:
    c = np.cumsum(weights, dtype=np.float64)
    return c / c[-1]


def write_shards(data_dir: str, traffic: Dict, *, vocab_size: int,
                 num_entities: int, num_instances: int, window: int,
                 per_shard: int, seed: int) -> Tuple[Dict, np.ndarray]:
    """Write ``num_instances`` windows in shards and the meta file under
    ``data_dir``; returns (meta, counts), counts [E] float64 the documents
    each entity is associated with."""
    E, V, w = num_entities, vocab_size, window
    S = int(traffic["signature_size"])
    os.makedirs(data_dir, exist_ok=True)
    draw, order = (np.random.default_rng(s) for s in
                   np.random.SeedSequence(int(seed)).spawn(2))
    docs = documents(E, traffic)
    entity_cdf = _cdf(docs.astype(np.float64))
    term_cdf = _cdf((np.arange(V, dtype=np.float64) + 1.0)
                    ** -float(traffic["noise_zipf"]))
    sig = signatures(draw, E, V, traffic)
    length = min(int(traffic["doc_len"]), w)

    writer = _ShardWriter(data_dir, per_shard, order)
    for start in range(0, num_instances, CHUNK):
        n = min(CHUNK, num_instances - start)
        ents = np.minimum(np.searchsorted(entity_cdf, draw.random(n),
                                          side="right"), E - 1)
        pick = sig[ents[:, None], draw.integers(0, S, size=(n, w))]
        noise = np.minimum(np.searchsorted(term_cdf, draw.random((n, w)),
                                           side="right"), V - 1)
        windows = np.where(draw.random((n, w)) < traffic["signal"], pick,
                           noise).astype(np.int32)
        windows[:, length:] = 0
        writer.add(windows, np.full(n, length, np.int32),
                   ents.astype(np.int32))
    shards = writer.finalize()
    meta = {"window_size": w,
            "num_instances": int(sum(s["num"] for s in shards)),
            "shards": shards, "vocab_size": V, "num_entities": E}
    with open(os.path.join(data_dir, META_NAME), "w") as fh:
        json.dump(meta, fh, indent=2)
    return meta, docs.astype(np.float64)


def read_shard(data_dir: str, name: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(data_dir, name)) as z:
        return {k: z[k] for k in ("windows", "lengths", "entities")}
