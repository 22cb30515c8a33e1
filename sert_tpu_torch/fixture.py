"""Random-weight serving fixtures: a data dir and a run dir that the serving
path loads like a trained run, at any size, made from a seed.

Used by ``chip_smoke.py`` (a recipe's full width: 250k terms, 1M entities)
and the CPU tests (a few hundred of each). The data dir holds what serving
reads and nothing a trainer would (no instance shards): a ``Vocabulary``
of synthetic terms that tokenize to themselves, an ``EntityRegistry`` and
an ``instances.meta.json`` with ``vocab_size`` / ``num_entities``. The run
dir holds one params-only checkpoint, stored in the recipe's
``snapshot_dtype``. ``write_eval_inputs`` and ``read_run`` carry topics,
qrels and TREC runs to and from the CLI.
"""

from __future__ import annotations

import json
import os
import string
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from sert_tpu.data.assoc import EntityRegistry
from sert_tpu.data.instances import META_NAME
from sert_tpu.data.prepare import ENTITIES_NAME, VOCAB_NAME
from sert_tpu.data.vocab import Vocabulary
from sert_tpu.eval.trec import read_run, write_qrels, write_topics
from sert_tpu.utils.config import RecipeConfig
from sert_tpu_torch.models import api
from sert_tpu_torch.pipeline import resolve_model_config
from sert_tpu_torch.train.checkpoint import save_params_checkpoint


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
    os.makedirs(data_dir, exist_ok=True)
    terms = [term(i) for i in range(num_terms)]
    vocab = Vocabulary(terms, [1] * num_terms)
    vocab.save(os.path.join(data_dir, VOCAB_NAME))
    EntityRegistry([entity_name(i) for i in range(num_entities)]).save(
        os.path.join(data_dir, ENTITIES_NAME))
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
           "write_serving_fixture"]
