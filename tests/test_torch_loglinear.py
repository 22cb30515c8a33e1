"""Parity of the port's full-softmax families (sert_tpu_torch: the
log-linear model, LSE's ``lse_full`` objective, their train steps, the
scorer's log-linear branches, checkpoints and the CLI) with the JAX
reference (sert_tpu) on the CPU, on the same numpy inputs.

Tolerances, with their reasons:
- fp32 losses: rtol 1e-5 / atol 1e-6 (reassociation); their gradients
  rtol 1e-3 / atol 1e-5 (the reference's fused path runs its Pallas kernel
  in interpret mode, which sums tiles in another order: the tolerance of
  tests/test_ops.py::TestFusedXent::test_model_losses_match_unfused);
- bf16: the bf16 class, rtol / atol 2e-2 (the reference casts the whole
  word table to bf16 and scatter-adds that gradient in bf16, the port casts
  the gathered rows and accumulates in fp32);
- three optimizer steps: rtol 1e-4 / atol 1e-6 on params and moments;
- scores: 1e-5 (fp32 products of the same params), rankings equal up to
  ties; the normalizer: rtol 1e-5;
- checkpoints: bit for bit.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.models import api as ref_api  # noqa: E402
from sert_tpu.models import loglinear as ref_loglinear  # noqa: E402
from sert_tpu.models import lse as ref_lse  # noqa: E402
from sert_tpu.scoring import scorer as ref_scorer  # noqa: E402
from sert_tpu.train import checkpoint as ref_ckpt  # noqa: E402
from sert_tpu.train import step as ref_step  # noqa: E402
from sert_tpu.utils.config import ModelConfig, TrainConfig  # noqa: E402
from sert_tpu_torch import cli, recipes  # noqa: E402
from sert_tpu_torch.models import api, loglinear, lse  # noqa: E402
from sert_tpu_torch.models.convert import (params_from_jax,  # noqa: E402
                                           params_to_numpy)
from sert_tpu_torch.ops import xent  # noqa: E402
from sert_tpu_torch.scoring import scorer  # noqa: E402
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sert_tpu_torch.train import loop  # noqa: E402
from sert_tpu_torch.train import step as port_step  # noqa: E402
from sert_tpu_torch.utils.config import save_config  # noqa: E402

V, D, DE, E, B, W = 60, 16, 12, 40, 16, 5
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = {"float32": dict(rtol=1e-3, atol=1e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cfg(model="loglinear", compute="float32", fused="off", E_=E):
    return ModelConfig(model=model, vocab_size=V, num_entities=E_,
                       word_dim=D, entity_dim=DE, compute_dtype=compute,
                       fused_softmax=fused)


def _np_params(model="loglinear", seed=0, E_=E):
    rng = np.random.default_rng(seed)
    if model == "loglinear":
        return {"word_emb": rng.normal(size=(V, D)).astype(np.float32) / 2,
                "proj_w": rng.normal(size=(D, E_)).astype(np.float32) / 2,
                "proj_b": rng.normal(size=(E_,)).astype(np.float32) / 4}
    return {"word_emb": rng.normal(size=(V, D)).astype(np.float32) / 2,
            "proj_w": rng.normal(size=(D, DE)).astype(np.float32) / 2,
            "proj_b": rng.normal(size=(DE,)).astype(np.float32) / 4,
            "entity_emb": rng.normal(size=(E_, DE)).astype(np.float32)}


def _batch(seed=1, n=B):
    rng = np.random.default_rng(seed)
    return {"windows": rng.integers(0, V, size=(n, W)).astype(np.int32),
            "lengths": rng.integers(1, W + 1, size=n).astype(np.int32),
            "entities": rng.integers(0, E, size=n).astype(np.int32)}


def _queries(seed=2, Q=7, T=4):
    rng = np.random.default_rng(seed)
    term_ids = rng.integers(0, V, size=(Q, T)).astype(np.int32)
    num_terms = rng.integers(1, T + 1, size=Q).astype(np.int32)
    num_terms[0] = T
    return term_ids, num_terms


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_init_keys_shapes_and_seeding():
    cfg = _cfg()
    p1 = api.init_params(torch.Generator().manual_seed(3), cfg)
    p2 = api.init_params(torch.Generator().manual_seed(3), cfg)
    assert {k: tuple(v.shape) for k, v in p1.items()} == {
        "word_emb": (V, D), "proj_w": (D, E), "proj_b": (E,)}
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not p1["proj_b"].any()
    assert abs(p1["proj_w"].std().item() - D ** -0.5) < 0.05


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("model", ["loglinear", "lse_full"])
def test_loss_matches_reference(model, fused, compute):
    """Both branches: "on" is K5/K6's plain version here and the Pallas
    kernel in interpret mode in the reference; "off" the composition."""
    cfg = _cfg(model, compute, fused)
    p, batch = _np_params(model), _batch()
    fn = ref_loglinear.loss if model == "loglinear" else \
        ref_lse.loss_full_softmax
    want, gw = jax.value_and_grad(
        lambda q: fn(q, {k: jnp.asarray(v) for k, v in batch.items()},
                     cfg))(_jp(p))
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(p).items()}
    got = api.loss_fn(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    names = sorted(tp)
    gg = torch.autograd.grad(got, [tp[n] for n in names])
    np.testing.assert_allclose(got.item(), float(want), **TOL[compute])
    for n, g in zip(names, gg):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw[n]),
                                   **GRAD_TOL[compute], err_msg=n)


def test_fused_switch_takes_the_kernels_only_on_cuda_or_when_asked():
    calls = []
    real = xent.xent_loss

    def spy(*a, **k):
        calls.append(a[4])
        return real(*a, **k)

    batch = {k: _t(v) for k, v in _batch().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loglinear, "xent_loss", spy)
        mp.setattr(lse, "xent_loss", spy)
        for model in ("loglinear", "lse_full"):
            p = params_from_jax(_np_params(model))
            api.loss_fn(p, batch, _cfg(model, fused="auto"))
            api.loss_fn(p, batch, _cfg(model, fused="off"))
            api.loss_fn(p, batch, _cfg(model, fused="on"))
    assert calls == ["de", "ed"]        # "on" only: "auto" is CUDA's


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_term_log_probs_and_query_scores_match_reference(compute):
    cfg = _cfg(compute=compute)
    p = _np_params()
    term_ids, num_terms = _queries()
    tol = dict(rtol=1e-5, atol=1e-5) if compute == "float32" else \
        TOL["bfloat16"]
    want = ref_loglinear.term_log_probs(_jp(p), jnp.asarray(term_ids[0]),
                                        cfg)
    got = loglinear.term_log_probs(params_from_jax(p), _t(term_ids[0]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for q in range(3):
        want = ref_api.query_scores(_jp(p), jnp.asarray(term_ids[q]),
                                    jnp.asarray(num_terms[q]), cfg)
        got = api.query_scores(params_from_jax(p), _t(term_ids[q]),
                               _t(num_terms[q]), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_api_surface_matches_reference():
    cfg = _cfg()
    p, batch = _np_params(), _batch()
    tp = params_from_jax(p)
    w, n = batch["windows"], batch["lengths"]
    np.testing.assert_allclose(
        api.window_rep(tp, _t(w), _t(n), cfg).numpy(),
        np.asarray(ref_api.window_rep(_jp(p), jnp.asarray(w),
                                      jnp.asarray(n), cfg)), atol=1e-6)
    np.testing.assert_array_equal(api.entity_matrix(tp, cfg).numpy(),
                                  np.asarray(ref_api.entity_matrix(_jp(p),
                                                                   cfg)))
    np.testing.assert_array_equal(api.entity_bias(tp, cfg).numpy(),
                                  p["proj_b"])
    np.testing.assert_allclose(
        api.all_entity_scores(tp, _t(w), _t(n), cfg).numpy(),
        np.asarray(ref_api.all_entity_scores(_jp(p), jnp.asarray(w),
                                             jnp.asarray(n), cfg)),
        atol=1e-5)


# --- train steps and checkpoints -------------------------------------------

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
    for k, v in state.opt_state.items():
        out[".opt_state" + k] = np.asarray(
            v if isinstance(v, int) else v.numpy())
    return out


@pytest.mark.parametrize("model,fused,train_kw", [
    ("loglinear", "off", dict(optimizer="adam")),
    ("loglinear", "on", dict(optimizer="adam", lr_schedule="cosine",
                             lr_decay_steps=4)),
    ("loglinear", "off", dict(optimizer="adagrad")),
    ("loglinear", "off", dict(optimizer="sgd", learning_rate=0.1)),
    ("lse_full", "on", dict(optimizer="adam")),
    ("lse_full", "off", dict(optimizer="adam", grad_clip_norm=0.05,
                             weight_decay=0.01)),
])
def test_three_steps_match_reference(model, fused, train_kw):
    mcfg = _cfg(model, fused=fused)
    tcfg = TrainConfig(learning_rate=train_kw.pop("learning_rate", 5e-2),
                       **train_kw)
    p = _np_params(model, seed=7)
    ref_s = ref_step.init_state(jax.random.key(0), mcfg, tcfg)
    ref_s = ref_s._replace(params=_jp(p))
    port_s = port_step.init_state(0, mcfg, tcfg)
    # A copy: the port updates in place, and JAX may alias p's memory and
    # read it after an asynchronous dispatch.
    port_s.params = params_from_jax({k: v.copy() for k, v in p.items()})
    ref_fn = ref_step.make_train_step(mcfg, tcfg, jit=False)
    port_fn = port_step.make_train_step(mcfg, tcfg)
    assert set(_port_state_arrays(port_s)) == set(_ref_state_arrays(ref_s))
    for i in range(3):
        b = _batch(10 + i)
        ref_s, ref_m = ref_fn(ref_s, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        port_s, port_m = port_fn(port_s, {k: _t(v) for k, v in b.items()})
        assert port_s.step == int(ref_s.step) == i + 1
        np.testing.assert_allclose(port_m["loss"].item(),
                                   float(ref_m["loss"]), rtol=1e-5)
        want = _ref_state_arrays(ref_s)
        for key, got in _port_state_arrays(port_s).items():
            np.testing.assert_allclose(got, want[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} {key}")


def test_fused_update_on_names_its_item(tmp_path):
    """"on" is ported (the fused step, tests/test_torch_fused.py): the loop
    takes it, an unknown mode still raises, and "on" with a mesh shape on
    the one-card step raises the reference's ``mesh_shape=(1, 1)``
    message (the mesh's own step is tests/test_torch_mesh_fused.py's)."""
    recipe = recipes.tiny_recipe("loglinear")
    for mode in ("on", "auto", "off"):
        loop._check_supported(dataclasses.replace(
            recipe, train=dataclasses.replace(recipe.train,
                                              fused_update=mode)))
    with pytest.raises(ValueError, match="unknown fused_update"):
        loop._check_supported(dataclasses.replace(
            recipe, train=dataclasses.replace(recipe.train,
                                              fused_update="always")))
    with pytest.raises(ValueError, match=r"mesh_shape=\(1, 1\)"):
        port_step.make_train_step(
            recipe.model.replace(word_dim=128),
            dataclasses.replace(recipe.train, fused_update="on",
                                mesh_shape=(1, 2)))


def test_full_state_checkpoints_cross_load(tmp_path):
    mcfg = _cfg()
    tcfg = TrainConfig(optimizer="adam", lr_schedule="cosine",
                       lr_decay_steps=10)
    rng = np.random.default_rng(0)
    port_s = port_step.init_state(5, mcfg, tcfg)
    for k, v in port_s.opt_state.items():
        if isinstance(v, int):
            port_s.opt_state[k] = 3
        else:
            v.copy_(_t(rng.random(v.shape).astype(np.float32)))
    port_s.step = 3
    path = ckpt.save_checkpoint(str(tmp_path / "p"), 3, port_s,
                                {"epoch": 1})
    ref_s, meta = ref_ckpt.load_checkpoint(
        path, ref_step.init_state(jax.random.key(1), mcfg, tcfg))
    assert meta["epoch"] == 1 and int(ref_s.step) == 3
    want = _port_state_arrays(port_s)
    for key, arr in _ref_state_arrays(ref_s).items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)

    path2 = ref_ckpt.save_checkpoint(str(tmp_path / "r"), 4, ref_s)
    back, _ = ckpt.load_checkpoint(path2, port_step.init_state(9, mcfg,
                                                               tcfg))
    got = _port_state_arrays(back)
    for key, arr in _ref_state_arrays(ref_s).items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


# --- the scorer's log-linear branches --------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_dense_scores_match_reference(compute):
    cfg = _cfg(compute=compute)
    p = _np_params()
    term_ids, num_terms = _queries()
    want = ref_scorer.dense_scores(_jp(p), cfg, jnp.asarray(term_ids),
                                   jnp.asarray(num_terms))
    got = scorer.dense_scores(params_from_jax(p), cfg, _t(term_ids),
                              _t(num_terms))
    tol = dict(rtol=1e-5, atol=1e-5) if compute == "float32" else \
        TOL["bfloat16"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("ref_engine", ["fused", "scan"])
@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_normalizer_matches_reference(engine, ref_engine):
    cfg = _cfg(E_=300)
    p = _np_params(E_=300)
    term_ids, num_terms = _queries()
    want = ref_scorer.ll_log_normalizer(_jp(p), cfg, jnp.asarray(term_ids),
                                        jnp.asarray(num_terms), chunk=128,
                                        engine=ref_engine)
    got = scorer.ll_log_normalizer(params_from_jax(p), cfg, _t(term_ids),
                                   _t(num_terms), chunk=128, engine=engine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_pallas_topk_matches_reference(normalize):
    """The kernel engine's plain versions against the reference's Pallas
    engine in interpret mode: K3 with the bias and alpha = |q|, K4, and the
    normalizer; 300 entities fill two bins of 128 and a partial third."""
    cfg = _cfg(E_=300)
    p = _np_params(E_=300)
    term_ids, num_terms = _queries()
    want_s, want_i = ref_scorer.pallas_topk(
        _jp(p), cfg, jnp.asarray(term_ids), jnp.asarray(num_terms), k=20,
        normalize=normalize)
    got_s, got_i = scorer.pallas_topk(params_from_jax(p), cfg, _t(term_ids),
                                      _t(num_terms), k=20,
                                      normalize=normalize)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if normalize:
        dense = scorer.dense_scores(params_from_jax(p), cfg, _t(term_ids),
                                    _t(num_terms))
        np.testing.assert_allclose(
            got_s.numpy(), torch.gather(dense, 1, got_i).numpy(), rtol=1e-5,
            atol=1e-5)


# --- end to end ------------------------------------------------------------

@pytest.mark.parametrize("model", ["loglinear", "lse_full"])
def test_cli_e2e_on_the_cpu(tmp_path, capsys, model):
    save_config(recipes.tiny_recipe(model), str(tmp_path / "r.json"))
    assert cli.main(["e2e", "--recipe", str(tmp_path / "r.json"),
                     "--workdir", str(tmp_path / "w"),
                     "--device", "cpu"]) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert metrics["ndcg@100"] > 0.85, metrics
