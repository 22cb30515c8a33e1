"""Synthetic fixtures at any size, made from a seed: a serving fixture
(random weights) and a training fixture (instances to train on).

Used by ``chip_smoke.py`` (a recipe's full width: 250k terms, 1M entities)
and the CPU tests (a few hundred of each). Both data dirs hold a
``Vocabulary`` of synthetic terms that tokenize to themselves, an
``EntityRegistry`` and an ``instances.meta.json`` with ``vocab_size`` /
``num_entities``.

* ``write_serving_fixture``: no instance shards; the run dir holds one
  random-weight params-only checkpoint in the recipe's ``snapshot_dtype``.
* ``write_training_fixture``: instance shards and an ``Associations`` file,
  as ``prepare`` writes them, in place of preparing a real collection
  (which takes minutes on the host at 1M entities). Every entity has a
  signature of a few terms; its windows draw most of their terms from it,
  and popular entities (Zipf over a seeded permutation) carry most
  windows, so a model learns enough in a few dozen steps for its loss to
  fall. The unigram noise comes from the association counts.

``write_eval_inputs`` and ``read_run`` carry topics, qrels and TREC runs to
and from the CLI.
"""

from __future__ import annotations

import json
import os
import string
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from sert_tpu_torch.data.assoc import Associations, EntityRegistry
from sert_tpu_torch.data.instances import META_NAME, InstanceWriter
from sert_tpu_torch.data.prepare import ASSOC_NAME, ENTITIES_NAME, VOCAB_NAME
from sert_tpu_torch.data.vocab import Vocabulary
from sert_tpu_torch.eval.trec import read_run, write_qrels, write_topics
from sert_tpu_torch.models import api
from sert_tpu_torch.pipeline import resolve_model_config
from sert_tpu_torch.train.checkpoint import save_params_checkpoint
from sert_tpu_torch.utils.config import RecipeConfig


def term(i: int, width: int = 4) -> str:
    """The i-th synthetic term: 'zq' + i in base 26 letters; lowercase, no
    stopword, so the tokenizer keeps it as it is."""
    letters = []
    for _ in range(width):
        i, r = divmod(i, 26)
        letters.append(string.ascii_lowercase[r])
    if i:
        raise ValueError(f"term index beyond 26**{width}")
    return "zq" + "".join(reversed(letters))


def entity_name(i: int) -> str:
    return f"e{i:07d}"


def _write_names(data_dir: str, num_terms: int, num_entities: int):
    """Write the vocabulary and the entity registry's file (through
    ``EntityRegistry.write``: no name index, seconds at 10M entities);
    returns (terms, vocab)."""
    os.makedirs(data_dir, exist_ok=True)
    terms = [term(i) for i in range(num_terms)]
    vocab = Vocabulary(terms, [1] * num_terms)
    vocab.save(os.path.join(data_dir, VOCAB_NAME))
    EntityRegistry.write(os.path.join(data_dir, ENTITIES_NAME),
                         [entity_name(i) for i in range(num_entities)])
    return terms, vocab


def write_serving_fixture(root: str, recipe: RecipeConfig, num_terms: int,
                          num_entities: int, num_queries: int,
                          seed: int = 0, max_query_terms: int = 8,
                          device=None) -> Tuple[str, str, Dict[str, str]]:
    """Write ``root/data`` and ``root/run``; returns (data_dir, run_dir,
    topics {qid: text}) with queries of 1..max_query_terms in-vocabulary
    terms. The params are drawn on ``device`` from a generator seeded with
    ``seed``; the topics from numpy with the same seed."""
    data_dir = os.path.join(root, "data")
    run_dir = os.path.join(root, "run")
    terms, vocab = _write_names(data_dir, num_terms, num_entities)
    meta = {"window_size": recipe.data.window_size, "num_instances": 0,
            "shards": [], "vocab_size": num_terms,
            "num_entities": num_entities, "vocab_hash": vocab.content_hash()}
    with open(os.path.join(data_dir, META_NAME), "w") as fh:
        json.dump(meta, fh)

    cfg = resolve_model_config(recipe, meta).model
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    params = api.init_params(gen, cfg, device)
    sdt = (torch.bfloat16 if recipe.train.snapshot_dtype == "bfloat16"
           else torch.float32)
    save_params_checkpoint(
        os.path.join(run_dir, "checkpoints"), 1,
        {k: v.to(sdt) for k, v in params.items()},
        {"epoch": 1, "cursor": None, "vocab_hash": vocab.content_hash()})
    del params

    rng = np.random.default_rng(seed)
    topics = {}
    for q in range(num_queries):
        n = int(rng.integers(1, max_query_terms + 1))
        ids = rng.choice(num_terms, size=n, replace=False)
        topics[f"t{q:04d}"] = " ".join(terms[i] for i in ids)
    return data_dir, run_dir, topics


def write_training_fixture(root: str, recipe: RecipeConfig, num_terms: int,
                           num_entities: int, num_instances: int,
                           num_queries: int = 0, seed: int = 0,
                           signature_size: int = 8, signal: float = 0.8,
                           zipf: float = 1.1
                           ) -> Tuple[str, Dict[str, str],
                                      Dict[str, Dict[str, int]]]:
    """Write ``root/data`` for training; returns (data_dir, topics, qrels).

    ``num_instances`` windows of the recipe's width: each term comes from
    its entity's ``signature_size`` signature terms with probability
    ``signal``, else uniformly from the vocabulary; lengths run from half
    the width to the full width. Entities carry windows with weight
    1 / (rank + 10) ** zipf. Each of ``num_queries`` topics is four
    signature terms of one of the most popular entities, which its qrels
    mark relevant."""
    E, V, w = num_entities, num_terms, recipe.data.window_size
    data_dir = os.path.join(root, "data")
    terms, vocab = _write_names(data_dir, V, E)
    rng = np.random.default_rng(seed)
    rank = rng.permutation(E)
    weight = 1.0 / (rank + 10.0) ** zipf
    prob = weight / weight.sum()
    signatures = rng.integers(0, V, size=(E, signature_size),
                              dtype=np.int32)

    writer = InstanceWriter(data_dir, w, recipe.data.instances_per_shard,
                            seed=seed)
    chunk = 1 << 18
    for lo in range(0, num_instances, chunk):
        n = min(chunk, num_instances - lo)
        ents = rng.choice(E, size=n, p=prob).astype(np.int32)
        pick = rng.integers(0, signature_size, size=(n, w))
        windows = np.where(rng.random((n, w)) < signal,
                           signatures[ents[:, None], pick],
                           rng.integers(0, V, size=(n, w), dtype=np.int32))
        lengths = rng.integers(max(w // 2, 1), w + 1, size=n,
                               dtype=np.int32)
        windows[np.arange(w)[None, :] >= lengths[:, None]] = 0
        writer.add(windows.astype(np.int32), lengths, ents)
    writer.finalize(extra_meta={"vocab_size": V, "num_entities": E,
                                "vocab_hash": vocab.content_hash()})

    # Each entity has one document per expected window (at least one), so
    # the association counts the unigram noise reads follow its popularity.
    # Document j holds every entity with more than j documents: the file
    # then has max(docs) documents, not one an entity, which keeps writing
    # and loading it to seconds at 10M entities.
    docs = np.maximum(1, np.rint(prob * num_instances)).astype(np.int64)
    by_docs = np.argsort(-docs, kind="stable")
    more = E - np.searchsorted(np.sort(docs), np.arange(docs.max()),
                               side="right")        # entities with > j docs
    Associations.write(os.path.join(data_dir, ASSOC_NAME),
                       {f"d{j}": by_docs[:n].tolist()
                        for j, n in enumerate(more)})

    topics, qrels = {}, {}
    for q, e in enumerate(np.argsort(rank)[:num_queries]):
        ids = rng.choice(signatures[e], size=min(4, signature_size),
                         replace=False)
        qid = f"t{q:04d}"
        topics[qid] = " ".join(terms[i] for i in ids)
        qrels[qid] = {entity_name(int(e)): 1}
    return data_dir, topics, qrels


def write_eval_inputs(root: str, topics: Dict[str, str],
                      relevant: Dict[str, Iterable[int]]) -> Tuple[str, str]:
    """Write ``root/topics.tsv`` and binary ``root/qrels.trec`` (each
    topic's ``relevant`` entity ids); returns their paths."""
    topics_path = os.path.join(root, "topics.tsv")
    qrels_path = os.path.join(root, "qrels.trec")
    write_topics(topics, topics_path)
    write_qrels({q: {entity_name(e): 1 for e in ids}
                 for q, ids in relevant.items()}, qrels_path)
    return topics_path, qrels_path


__all__ = ["entity_name", "read_run", "term", "write_eval_inputs",
           "write_serving_fixture", "write_training_fixture"]
