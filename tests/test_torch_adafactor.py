"""Parity of the port's adafactor (sert_tpu_torch.train.step.Optimizer)
with the reference's ``optax.adafactor(lr, multiply_by_parameter_scale=
False, clipping_threshold=None)`` (sert_tpu.train.step.make_optimizer) on
the CPU, on the same numpy inputs.

optax factors a leaf's second moment only where its two largest dims are
both >= 128, so every case holds leaves that factor (either orientation)
beside leaves that do not.

Tolerances, with their reasons:
- fp32 params: rtol 1e-5 and atol 2e-3 x lr (reassociation of the same
  arithmetic; an update is lr-sized whatever the gradient's size, so a
  cancellation residual moves it by a fraction of lr);
  fp32 statistics: rtol 1e-4 / atol 1e-12 (sums of squares in another
  order, compounded over the steps);
- bf16 params and statistics: the bf16 class, rtol / atol 2e-2 (each
  package rounds the same fp32 statistics to bf16, a last-bit tie can
  round the other way and the next steps carry it);
- checkpoints across packages and resume within the port: bit for bit.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from optax._src.factorized import _factored_dims  # noqa: E402

from sert_tpu.train import checkpoint as ref_ckpt  # noqa: E402
from sert_tpu.train import fused as ref_fused  # noqa: E402
from sert_tpu.train import sparse as ref_sparse  # noqa: E402
from sert_tpu.train import step as ref_step  # noqa: E402
from sert_tpu.utils.config import ModelConfig, TrainConfig  # noqa: E402
from sert_tpu_torch import pipeline, recipes  # noqa: E402
from sert_tpu_torch.models.convert import (params_from_jax,  # noqa: E402
                                           params_to_numpy)
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sert_tpu_torch.train import fused, sparse  # noqa: E402
from sert_tpu_torch.train import step as port_step  # noqa: E402

LR = 1e-2
PARAM_TOL = {"float32": dict(rtol=1e-5, atol=2e-3 * LR),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
STATE_TOL = {"float32": dict(rtol=1e-4, atol=1e-12),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Leaves that factor ([128, 200] by rows, [300, 128] by columns, [130,
# 129]) and leaves that keep a full v ([200], [40, 128]).
SHAPES = {"proj_w": (128, 200), "proj_b": (200,), "word_emb": (40, 128),
          "tall": (300, 128), "square": (130, 129)}
CHAINS = [
    dict(),
    dict(lr_schedule="cosine", lr_decay_steps=12, lr_warmup_steps=2),
    dict(grad_clip_norm=0.5, weight_decay=0.01),
    dict(grad_clip_norm=50.0, lr_schedule="linear", lr_decay_steps=9),
]
STEPS = 10


def _keystr_arrays(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_arrays(opt_state):
    return {k: (np.float32(v) if isinstance(v, int) else v.float().numpy())
            for k, v in opt_state.items()}


@pytest.mark.parametrize("shape", [(7,), (128,), (127, 500), (128, 128),
                                   (500, 128), (128, 64), (3, 128, 256),
                                   (256, 2, 128)])
def test_factored_dims_match_optax(shape):
    assert port_step.factored_dims(shape) == _factored_dims(shape, True, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", CHAINS)
def test_updates_and_state_match_optax(dtype, chain):
    cfg = TrainConfig(optimizer="adafactor", learning_rate=LR, **chain)
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    ref_p = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    port_p = {k: torch.from_numpy(v.copy()).to(getattr(torch, dtype))
              for k, v in p0.items()}
    ref_opt = ref_step.make_optimizer(cfg)
    ref_s = ref_opt.init(ref_p)
    port_opt = port_step.make_optimizer(cfg)
    port_s = port_opt.init(port_p)
    assert set(port_s) == set(_keystr_arrays(ref_s))
    for k, v in _keystr_arrays(ref_s).items():
        got = port_s[k]
        if not isinstance(got, int):
            assert tuple(got.shape) == v.shape, k
            assert got.dtype == getattr(torch, dtype), k
    for i in range(STEPS):
        g = {k: (rng.normal(size=s) * (1 + i)).astype(np.float32)
             for k, s in SHAPES.items()}
        upd, ref_s = ref_opt.update({k: jnp.asarray(v, dtype)
                                     for k, v in g.items()}, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
        port_opt.update(port_p, {k: torch.from_numpy(v).to(port_p[k].dtype)
                                 for k, v in g.items()}, port_s)
        for k in SHAPES:
            np.testing.assert_allclose(
                port_p[k].float().numpy(), np.asarray(ref_p[k], np.float32),
                **PARAM_TOL[dtype], err_msg=f"step {i + 1} {k}")
        want = _keystr_arrays(ref_s)
        for k, got in _port_arrays(port_s).items():
            np.testing.assert_allclose(got, want[k], **STATE_TOL[dtype],
                                       err_msg=f"step {i + 1} {k}")


# --- the train step of a model, checkpoints and resume -----------------------

V, E, B, W = 150, 200, 16, 5


def _cfg(model="loglinear", param_dtype="float32"):
    # word_dim 128: word_emb [150, 128] and proj_w [128, 200] factor,
    # proj_b does not (lse_full's entity_emb [200, 128] factors too).
    return ModelConfig(model=model, vocab_size=V, num_entities=E,
                       word_dim=128, entity_dim=128, param_dtype=param_dtype)


def _np_params(model, seed=0):
    rng = np.random.default_rng(seed)
    out = {"word_emb": rng.normal(size=(V, 128)).astype(np.float32) / 2,
           "proj_w": rng.normal(size=(128, E if model == "loglinear"
                                      else 128)).astype(np.float32) / 8,
           "proj_b": rng.normal(size=(E if model == "loglinear"
                                      else 128,)).astype(np.float32) / 4}
    if model == "lse_full":
        out["entity_emb"] = rng.normal(size=(E, 128)).astype(np.float32)
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"windows": rng.integers(0, V, size=(B, W)).astype(np.int32),
            "lengths": rng.integers(1, W + 1, size=B).astype(np.int32),
            "entities": rng.integers(0, E, size=B).astype(np.int32)}


def _ref_state_arrays(state):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            (state.params, state.opt_state))[0]:
        key = jax.tree_util.keystr(path)
        key = (".params" + key[3:] if key.startswith("[0]")
               else ".opt_state" + key[3:])
        out[key] = np.asarray(leaf)
    return out


def _port_state_arrays(state):
    out = {f".params['{k}']": v for k, v in
           params_to_numpy(state.params).items()}
    for k, v in params_to_numpy({k: v for k, v in state.opt_state.items()
                                 if torch.is_tensor(v)}).items():
        out[".opt_state" + k] = v
    for k, v in state.opt_state.items():
        if isinstance(v, int):
            out[".opt_state" + k] = np.asarray(v, np.int32)
    return out


def _as_f32(arrays):
    return {k: (np.asarray(v).view(jnp.bfloat16).astype(np.float32)
                if np.asarray(v).dtype == np.uint16
                else np.asarray(v, np.float32)) for k, v in arrays.items()}


@pytest.mark.parametrize("model,param_dtype,chain", [
    ("loglinear", "float32", dict()),
    ("loglinear", "float32", dict(lr_schedule="cosine", lr_decay_steps=8)),
    ("loglinear", "bfloat16", dict()),
    ("lse_full", "float32", dict(grad_clip_norm=0.5, weight_decay=0.01)),
])
def test_train_steps_match_reference(model, param_dtype, chain):
    """Eight dense train steps of a tiny model, trained by both packages
    from the same params on the same batches."""
    mcfg = _cfg(model, param_dtype)
    tcfg = TrainConfig(optimizer="adafactor", learning_rate=LR, **chain)
    p = _np_params(model, seed=7)
    ref_s = ref_step.init_state(jax.random.key(0), mcfg, tcfg)
    ref_s = ref_s._replace(params={k: jnp.asarray(v, param_dtype)
                                   for k, v in p.items()})
    port_s = port_step.init_state(0, mcfg, tcfg)
    port_s.params = params_from_jax({k: v.copy() for k, v in p.items()},
                                    dtype=getattr(torch, param_dtype))
    ref_fn = ref_step.make_train_step(mcfg, tcfg, jit=False)
    port_fn = port_step.make_train_step(mcfg, tcfg)
    assert set(_port_state_arrays(port_s)) == set(_ref_state_arrays(ref_s))
    for i in range(8):
        b = _batch(10 + i)
        ref_s, ref_m = ref_fn(ref_s, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        port_s, port_m = port_fn(port_s, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        assert port_s.step == int(ref_s.step) == i + 1
        np.testing.assert_allclose(port_m["loss"].item(),
                                   float(ref_m["loss"]),
                                   rtol=1e-5 if param_dtype == "float32"
                                   else 2e-2)
        want = _as_f32(_ref_state_arrays(ref_s))
        for key, got in _as_f32(_port_state_arrays(port_s)).items():
            t = (PARAM_TOL if key.startswith(".params")
                 else STATE_TOL)[param_dtype]
            np.testing.assert_allclose(got, want[key], **t,
                                       err_msg=f"step {i + 1} {key}")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_full_state_checkpoints_cross_load(tmp_path, param_dtype):
    mcfg = _cfg(param_dtype=param_dtype)
    tcfg = TrainConfig(optimizer="adafactor", lr_schedule="cosine",
                       lr_decay_steps=10, grad_clip_norm=1.0)
    rng = np.random.default_rng(0)
    port_s = port_step.init_state(5, mcfg, tcfg)
    for k, v in port_s.opt_state.items():   # non-trivial statistics, counts
        if isinstance(v, int):
            port_s.opt_state[k] = 3
        else:
            v.copy_(torch.from_numpy(rng.random(v.shape).astype(np.float32)))
    port_s.step = 3
    path = ckpt.save_checkpoint(str(tmp_path / "p"), 3, port_s,
                                {"epoch": 1})
    ref_s, meta = ref_ckpt.load_checkpoint(
        path, ref_step.init_state(jax.random.key(1), mcfg, tcfg))
    assert meta["epoch"] == 1 and int(ref_s.step) == 3
    want = _port_state_arrays(port_s)
    got_ref = _ref_state_arrays(ref_s)
    assert set(got_ref) == set(want)
    for key, arr in got_ref.items():
        np.testing.assert_array_equal(
            arr.view(np.uint16) if arr.dtype == jnp.bfloat16 else arr,
            want[key], err_msg=key)

    path2 = ref_ckpt.save_checkpoint(str(tmp_path / "r"), 4, ref_s)
    back, _ = ckpt.load_checkpoint(path2, port_step.init_state(9, mcfg,
                                                               tcfg))
    got = _port_state_arrays(back)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def _prepared(tmp_path):
    recipe = recipes.tiny_recipe("loglinear")
    recipe = dataclasses.replace(
        recipe, model=dataclasses.replace(recipe.model, word_dim=128),
        train=dataclasses.replace(recipe.train, optimizer="adafactor",
                                  learning_rate=LR))
    data = str(tmp_path / "data")
    pipeline.prepare_collection(recipes.tiny_spec(seed=4).build(), data,
                                recipe)
    return recipe, data


def test_resume_is_exact_and_the_loss_falls(tmp_path):
    recipe, data = _prepared(tmp_path)
    two = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, num_epochs=2, log_every_steps=1))
    one = dataclasses.replace(two, train=dataclasses.replace(
        two.train, num_epochs=1))
    s_all, _ = pipeline.train_from_dir(two, data, str(tmp_path / "a"),
                                       device="cpu")
    pipeline.train_from_dir(one, data, str(tmp_path / "b"), device="cpu")
    s_res, _ = pipeline.train_from_dir(two, data, str(tmp_path / "b"),
                                       device="cpu")
    assert s_all.step == s_res.step > 0
    assert any(port_step.factored_dims(p.shape) for p in
               s_all.params.values())
    for k in s_all.params:
        assert torch.equal(s_all.params[k], s_res.params[k]), k
    assert s_all.opt_state.keys() == s_res.opt_state.keys()
    for k, v in s_all.opt_state.items():
        assert (torch.equal(v, s_res.opt_state[k]) if torch.is_tensor(v)
                else v == s_res.opt_state[k]), k
    losses = [json.loads(x)["loss"] for x in open(os.path.join(
        tmp_path / "a", "train_log.jsonl")) if '"train_step"' in x]
    assert len(losses) >= 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


# --- the gates stay the reference's ------------------------------------------

def test_fused_auto_resolves_dense_and_on_raises_as_the_reference():
    mcfg = _cfg()
    for mode in ("auto", "off"):
        tcfg = TrainConfig(optimizer="adafactor", fused_update=mode)
        assert not fused.fused_enabled(mcfg, tcfg, torch.device("cuda"))
        assert not ref_fused.fused_enabled(mcfg, tcfg)
    tcfg = TrainConfig(optimizer="adafactor", fused_update="on")
    with pytest.raises(ValueError, match="fused_update='on'"):
        fused.fused_enabled(mcfg, tcfg, torch.device("cuda"))
    with pytest.raises(ValueError, match="fused_update='on'"):
        ref_fused.fused_enabled(mcfg, tcfg)


def test_sparse_on_raises_and_lse_warns_as_the_reference():
    mcfg = ModelConfig(model="lse", objective="sampled_softmax",
                       vocab_size=V, num_entities=E, word_dim=16,
                       entity_dim=16, num_negatives=8)
    auto = TrainConfig(optimizer="adafactor")
    assert not sparse.sparse_enabled(mcfg, auto)
    assert not ref_sparse.sparse_enabled(mcfg, auto)
    on = TrainConfig(optimizer="adafactor", sparse_update="on")
    with pytest.raises(ValueError, match="sparse_update='on'"):
        sparse.sparse_enabled(mcfg, on)
    with pytest.raises(ValueError, match="sparse_update='on'"):
        ref_sparse.sparse_enabled(mcfg, on)
    with pytest.warns(UserWarning, match="adafactor"):
        port_step.make_train_step(mcfg, auto)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_step.make_train_step(_cfg(), auto)
