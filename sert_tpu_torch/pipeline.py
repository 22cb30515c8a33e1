"""Pipeline pieces of the serving path (port of ``sert_tpu/pipeline.py``:
``resolve_model_config`` :46 and ``load_scorer`` :106)."""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from sert_tpu.data.assoc import EntityRegistry
from sert_tpu.data.prepare import ENTITIES_NAME, VOCAB_NAME
from sert_tpu.data.vocab import Vocabulary
from sert_tpu.utils.config import RecipeConfig
from sert_tpu_torch.models.common import param_dtype
from sert_tpu_torch.train import checkpoint as ckpt


def resolve_model_config(recipe: RecipeConfig, meta: Mapping) -> RecipeConfig:
    """Fill vocab_size / num_entities from the prepared dataset."""
    mcfg = recipe.model.replace(vocab_size=int(meta["vocab_size"]),
                                num_entities=int(meta["num_entities"]))
    return RecipeConfig(name=recipe.name, data=recipe.data, model=mcfg,
                        train=recipe.train, score=recipe.score)


def _check_shapes(params, recipe: RecipeConfig, path: str) -> None:
    m = recipe.model
    want = {"word_emb": (m.vocab_size, m.word_dim),
            "proj_w": (m.word_dim, m.entity_dim),
            "proj_b": (m.entity_dim,),
            "entity_emb": (m.num_entities, m.entity_dim)}
    for key, shape in want.items():
        if key not in params:
            raise KeyError(f"checkpoint {path} has no param {key!r}")
        if tuple(params[key].shape) != shape:
            raise ValueError(f"checkpoint {path} param {key} shape "
                             f"{tuple(params[key].shape)} != expected "
                             f"{shape}")


def load_scorer(run_dir: str, data_dir: str, recipe: RecipeConfig,
                step: Optional[int] = None, device=None):
    """(params on ``device`` in the recipe's param dtype, vocab, registry)
    from a checkpoint (latest, or ``step``) of ``run_dir``.

    Refuses a vocabulary whose hash differs from the one recorded at
    train time, and params whose shapes do not match the recipe (which
    must be resolved against the data dir's meta)."""
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


def default_device() -> torch.device:
    """The first CUDA device when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
