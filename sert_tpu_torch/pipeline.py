"""End-to-end pipeline driver: collection -> trained model -> run ->
metrics (port of ``sert_tpu/pipeline.py``: ``prepare_collection`` :34,
``resolve_model_config`` :46, ``load_pretrained_word_emb`` :54,
``train_from_dir`` :80, ``load_scorer`` :106, ``sweep_checkpoints`` :137,
``run_end_to_end`` :195), for every model family. Preparing is the port's
copy of the reference's host code (``data/prepare.py``).

Every entry point runs on the CUDA card unless its caller asks for the CPU
(``device="cpu"``, ``--device cpu``): without a card, ``device=None``
raises (:func:`default_device`) rather than running on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from sert_tpu_torch.data.assoc import Associations, EntityRegistry
from sert_tpu_torch.data.instances import InstanceDataset
from sert_tpu_torch.data.prepare import (ASSOC_NAME, ENTITIES_NAME,
                                         VOCAB_NAME, encode_queries, prepare)
from sert_tpu_torch.data.vocab import Vocabulary
from sert_tpu_torch.eval.metrics import evaluate_run
from sert_tpu_torch.eval.trec import write_qrels, write_run, write_topics
from sert_tpu_torch.models.common import param_dtype
from sert_tpu_torch.train import checkpoint as ckpt
from sert_tpu_torch.utils.config import RecipeConfig, save_config
from sert_tpu_torch.utils.logging import get_logger

log = get_logger("pipeline")


def prepare_collection(col, out_dir: str, recipe: RecipeConfig) -> Dict:
    """Prepare any (docs, doc -> entities) collection shaped like a
    ``SyntheticCollection``; returns the instance meta."""
    registry = EntityRegistry(col.entities)
    assoc = Associations()
    for doc_id, ents in col.doc_entities.items():
        for e in ents:
            assoc.add(doc_id, registry.id(e))
    return prepare(col.docs, assoc, registry, out_dir, recipe.data)


def resolve_model_config(recipe: RecipeConfig, meta: Mapping) -> RecipeConfig:
    """Fill vocab_size / num_entities from the prepared dataset."""
    mcfg = recipe.model.replace(vocab_size=int(meta["vocab_size"]),
                                num_entities=int(meta["num_entities"]))
    return RecipeConfig(name=recipe.name, data=recipe.data, model=mcfg,
                        train=recipe.train, score=recipe.score)


def load_pretrained_word_emb(npz_path: str, vocab: Vocabulary,
                             base_emb: np.ndarray):
    """Overwrite rows of ``base_emb`` with vectors from a dump-format npz
    (``word_emb`` + ``terms`` arrays, as the dump command writes them).
    Terms are matched by string; vocabulary terms absent from the dump keep
    their fresh initialization. Returns (fp32 embeddings, matched count)."""
    with np.load(npz_path, allow_pickle=True) as z:
        if "word_emb" not in z or "terms" not in z:
            raise ValueError(
                f"{npz_path} is not a dump npz (needs word_emb + terms)")
        emb = np.asarray(z["word_emb"], np.float32)
        terms = z["terms"]
    if emb.shape[1] != base_emb.shape[1]:
        raise ValueError(
            f"pretrained word_dim {emb.shape[1]} != model word_dim "
            f"{base_emb.shape[1]}")
    out = np.asarray(base_emb, np.float32).copy()
    hits = 0
    for i, t in enumerate(terms):
        t = str(t)
        if t in vocab:
            out[vocab.id(t)] = emb[i]
            hits += 1
    return out, hits


def word_emb_hook(npz_path: str, vocab: Vocabulary):
    """The train loop's ``init_params_hook`` for ``--init-word-emb``: seeds
    the fresh params' ``word_emb`` from a dump npz
    (:func:`load_pretrained_word_emb`), in place, in the params' dtype on
    their device."""
    def hook(params):
        we = params["word_emb"]
        new, hits = load_pretrained_word_emb(npz_path, vocab,
                                             we.float().cpu().numpy())
        log.info("init: seeded %d/%d word embeddings from %s",
                 hits, new.shape[0], npz_path)
        we.copy_(torch.from_numpy(new))
        return params
    return hook


def train_from_dir(recipe: RecipeConfig, data_dir: str, out_dir: str,
                   resume: bool = True, init_word_emb: Optional[str] = None,
                   device=None, **loop_kwargs):
    """Train on a prepared data dir on ``device`` (default: the card);
    returns (TrainState, resolved recipe). The unigram noise comes from the
    data dir's entity associations. ``init_word_emb``: a dump npz whose
    vectors seed the word embeddings of a fresh run (not of a resumed
    one)."""
    device = resolve_device(device)
    from sert_tpu_torch.train.loop import train as train_loop
    dataset = InstanceDataset(data_dir, seed=recipe.train.seed)
    recipe = resolve_model_config(recipe, dataset.meta)
    assoc = Associations.load(os.path.join(data_dir, ASSOC_NAME))
    counts = np.asarray(
        assoc.entity_instance_counts(recipe.model.num_entities), np.float64)
    os.makedirs(out_dir, exist_ok=True)
    from sert_tpu_torch.parallel.mesh import world_rank
    if world_rank() == 0:    # one writer on a mesh of several ranks
        save_config(recipe, os.path.join(out_dir, "recipe.json"))
    if init_word_emb:
        vocab = Vocabulary.load(os.path.join(data_dir, VOCAB_NAME))
        loop_kwargs = {**loop_kwargs,
                       "init_params_hook": word_emb_hook(init_word_emb,
                                                         vocab)}
    state = train_loop(recipe, dataset, out_dir, entity_counts=counts,
                       resume=resume, device=device, **loop_kwargs)
    return state, recipe


def _check_shapes(params, recipe: RecipeConfig, path: str) -> None:
    m = recipe.model
    if m.model == "loglinear":
        want = {"proj_w": (m.word_dim, m.num_entities),
                "proj_b": (m.num_entities,)}
    else:
        want = {"proj_w": (m.word_dim, m.entity_dim),
                "proj_b": (m.entity_dim,),
                "entity_emb": (m.num_entities, m.entity_dim)}
    want["word_emb"] = (m.vocab_size, m.word_dim)
    for key, shape in want.items():
        if key not in params:
            raise KeyError(f"checkpoint {path} has no param {key!r}")
        if tuple(params[key].shape) != shape:
            raise ValueError(f"checkpoint {path} param {key} shape "
                             f"{tuple(params[key].shape)} != expected "
                             f"{shape}")


def load_scorer(run_dir: str, data_dir: str, recipe: RecipeConfig,
                step: Optional[int] = None, device=None):
    """(params on ``device`` (default: the card) in the recipe's param
    dtype, vocab, registry) from a checkpoint (latest, or ``step``) of
    ``run_dir``.

    Refuses a vocabulary whose hash differs from the one recorded at
    train time, and params whose shapes do not match the recipe (which
    must be resolved against the data dir's meta)."""
    device = resolve_device(device)
    vocab = Vocabulary.load(os.path.join(data_dir, VOCAB_NAME))
    registry = EntityRegistry.load(os.path.join(data_dir, ENTITIES_NAME))
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if step is None:
        path = ckpt.latest_checkpoint(ckpt_dir)
    else:
        path = ckpt.list_checkpoints(ckpt_dir).get(step)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    trained_hash = ckpt.load_meta(path).get("vocab_hash")
    if trained_hash and trained_hash != vocab.content_hash():
        raise ValueError(
            "vocabulary hash mismatch between checkpoint and data dir")
    params = ckpt.load_params(path)
    _check_shapes(params, recipe, path)
    pd = param_dtype(recipe.model)
    # Move in the stored dtype, then cast on the device (a bf16 snapshot
    # crosses the host link at half the fp32 bytes).
    params = {k: v.to(device).to(pd) for k, v in params.items()}
    return params, vocab, registry


def sweep_checkpoints(recipe: RecipeConfig, data_dir: str, run_dir: str,
                      topics_path: str, qrels_path: str,
                      measure: str = "ndcg@100", device=None) -> Dict:
    """Evaluate every epoch snapshot of the run on ``device`` (default: the
    card): the reference's workflow for choosing the snapshot by metric.
    Returns {"per_step": {step: metric}, "best_step", "best", "measure"}.

    Each file's meta sidecar is read first: a vocabulary hash that differs
    from the data dir's raises, and a mid-epoch checkpoint is skipped
    before its params are read. Each snapshot's params are read as the file
    holds them (params-only or full, sparse or dense optimizer state: only
    the params are read), then scored through ``score_topics``."""
    from sert_tpu_torch.eval.trec import read_qrels, read_topics
    from sert_tpu_torch.scoring.run import score_topics
    device = resolve_device(device)
    ds = InstanceDataset(data_dir)
    resolved = resolve_model_config(recipe, ds.meta)
    vocab = Vocabulary.load(os.path.join(data_dir, VOCAB_NAME))
    registry = EntityRegistry.load(os.path.join(data_dir, ENTITIES_NAME))
    encoded = encode_queries(read_topics(topics_path), vocab, resolved.data)
    qrels = read_qrels(qrels_path)

    per_step: Dict[str, float] = {}
    ckpts = ckpt.list_checkpoints(os.path.join(run_dir, "checkpoints"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {run_dir}")
    vocab_hash = vocab.content_hash()
    pd = param_dtype(resolved.model)
    for step, path in ckpts.items():
        meta = ckpt.load_meta(path)
        trained_hash = meta.get("vocab_hash")
        if trained_hash and trained_hash != vocab_hash:
            raise ValueError(
                f"checkpoint {path} was trained against a different "
                f"vocabulary than {data_dir}")
        if meta.get("cursor") is not None:
            continue  # mid-epoch step checkpoint; sweep epoch snapshots only
        params = ckpt.load_params(path)
        _check_shapes(params, resolved, path)
        params = {k: v.to(device).to(pd) for k, v in params.items()}
        run = score_topics(params, resolved.model, encoded, registry.names,
                           resolved.score)
        del params
        res = evaluate_run(run, qrels, measures=(measure,))
        per_step[str(step)] = res["all"][measure]
        log.info("sweep: step %d %s=%.4f", step, measure, per_step[str(step)])
    if not per_step:
        raise FileNotFoundError(f"no epoch snapshots in {run_dir}")
    best_step = max(per_step, key=per_step.get)
    return {"per_step": per_step, "best_step": int(best_step),
            "best": per_step[best_step], "measure": measure}


class NoCudaDevice(RuntimeError):
    """No CUDA device, and the caller did not ask for the CPU."""


def default_device() -> torch.device:
    """The CUDA card. Without one this raises :class:`NoCudaDevice`: the CPU
    runs only when the caller asks for it."""
    if not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device: sert_tpu_torch runs on the card by default; "
            "pass device=\"cpu\" (--device cpu on the command line) to run "
            "on the CPU")
    if "LOCAL_RANK" in os.environ:     # a launcher's rank: its own card
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


def run_end_to_end(col, recipe: RecipeConfig, workdir: str,
                   device=None) -> Dict[str, Dict[str, float]]:
    """prepare -> train -> score -> evaluate under ``workdir`` on
    ``device`` (default: the card); returns per-topic metrics with the
    macro average under "all"."""
    from sert_tpu_torch.scoring.run import score_topics
    from sert_tpu_torch.train.step import release_opt_state
    data_dir = os.path.join(workdir, "data")
    run_dir = os.path.join(workdir, "run")
    device = resolve_device(device)
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(run_dir, exist_ok=True)

    prepare_collection(col, data_dir, recipe)
    state, recipe = train_from_dir(recipe, data_dir, run_dir, device=device)
    # Scoring never reads the optimizer state; free its device memory
    # before the engine stages the entity matrix.
    state = release_opt_state(state)

    vocab = Vocabulary.load(os.path.join(data_dir, VOCAB_NAME))
    registry = EntityRegistry.load(os.path.join(data_dir, ENTITIES_NAME))
    encoded = encode_queries(col.topics, vocab, recipe.data)
    run = score_topics(state.params, recipe.model, encoded, registry.names,
                       recipe.score)

    write_run(run, os.path.join(run_dir, "run.trec"))
    write_qrels(col.qrels, os.path.join(run_dir, "qrels.trec"))
    write_topics(col.topics, os.path.join(run_dir, "topics.tsv"))
    results = evaluate_run(run, col.qrels)
    log.info("e2e %s: %s", recipe.name,
             {k: round(v, 4) for k, v in results["all"].items()})
    return results
