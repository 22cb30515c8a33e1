"""Parity of the port's training slice (sert_tpu_torch: ops.sampled_lse,
models.lse's sampled objective, train.step, train.checkpoint, train.loop,
pipeline, cli) with the JAX reference (sert_tpu) on the CPU, on the same
numpy inputs; negatives are injected, never drawn, where both run.

Tolerances, with their reasons:
- the masked logsumexp and its gradients: those of the reference's own
  test (tests/test_ops.py::TestSampledLse): forward rtol 1e-5, gradients
  rtol 1e-3 / atol 1e-4 (the reference runs its Pallas kernel in interpret
  mode, which sums tiles in another order), bf16 rtol 0.02 / atol 0.05;
- the objective in fp32: rtol 1e-5 / atol 1e-6 (reassociation); in bf16
  the bf16 class (atol 2e-2 on O(1) values): the reference casts the
  whole word table to bf16 before the gather and scatter-adds that
  gradient in bf16, the port casts the gathered rows and accumulates fp32;
- learning rates: rtol 1e-6, atol 1e-7 x the peak (optax evaluates its
  schedules in fp32, so near the end of a cosine the error is absolute,
  at the peak's scale);
- three optimizer steps: rtol 1e-4 / atol 1e-6 on params and moments
  (fp32 reassociation of the same arithmetic, compounded over the steps);
- resume within the port and checkpoint round trips: bit for bit.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu import recipes  # noqa: E402
from sert_tpu.models import lse as ref_lse  # noqa: E402
from sert_tpu.ops.sampled_lse import sampled_lse as ref_sampled_lse  # noqa: E402
from sert_tpu.train import checkpoint as ref_ckpt  # noqa: E402
from sert_tpu.train import step as ref_step  # noqa: E402
from sert_tpu.utils.config import ModelConfig, TrainConfig  # noqa: E402
from sert_tpu_torch import cli, pipeline  # noqa: E402
from sert_tpu_torch.data.feeder import PrefetchFeeder  # noqa: E402
from sert_tpu_torch.models import api, lse  # noqa: E402
from sert_tpu_torch.models.convert import (params_from_jax,  # noqa: E402
                                           params_to_numpy)
from sert_tpu_torch.ops import sampled_lse as slse  # noqa: E402
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sert_tpu_torch.train import step as port_step  # noqa: E402
from sert_tpu_torch.train.loop import _group_batches  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- K1/K2: the masked logsumexp ------------------------------------------

def _slse_case(seed, B, k, d, E=500, hits=True):
    rng = np.random.default_rng(seed)
    reps = rng.normal(size=(B, d)).astype(np.float32)
    cand = (rng.normal(size=(k, d)) * 0.3).astype(np.float32)
    corr = rng.normal(size=(k,)).astype(np.float32)
    ids = rng.integers(0, E, size=k).astype(np.int32)
    pos = rng.integers(0, E, size=B).astype(np.int32)
    if hits:
        ids[:min(B, k)] = pos[:min(B, k)]
    return reps, cand, corr, ids, pos


def _port_grads(f, reps, cand, corr):
    r, c, co = (torch.tensor(x, requires_grad=True) for x in (reps, cand,
                                                               corr))
    out = f(r, c, co)
    grads = torch.autograd.grad(out, [r, c, co])
    return out.detach().numpy(), [g.numpy() for g in grads]


class TestSampledLse:
    @pytest.mark.parametrize("B,k,d", [(20, 300, 24), (8, 256, 128),
                                       (12, 700, 48)])
    def test_fwd_and_grads_match_reference(self, B, k, d):
        reps, cand, corr, ids, pos = _slse_case(B + k, B, k, d)
        w = np.random.default_rng(1).normal(size=(B,)).astype(np.float32)

        def ref(r, c, co):
            return jnp.sum(w * ref_sampled_lse(r, c, co, jnp.asarray(ids),
                                               jnp.asarray(pos), 8, 128))

        want = np.asarray(ref(reps, cand, corr))
        gw = jax.grad(ref, argnums=(0, 1, 2))(reps, cand, corr)
        got, gg = _port_grads(
            lambda r, c, co: torch.sum(_t(w) * slse.sampled_lse(
                r, c, co, _t(ids), _t(pos))), reps, cand, corr)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for a, b in zip(gg, gw):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3,
                                       atol=1e-4)

    def test_all_masked_row_softplus_loss_and_grad_zero(self):
        reps, cand, corr, ids, pos = _slse_case(9, 6, 40, 16, hits=False)
        ids[:] = 7
        pos[2] = 7                      # row 2: all 40 candidates masked
        s_pos = np.random.default_rng(2).normal(size=(6,)).astype(np.float32)

        def ref(r, c, co):
            return jnp.sum(jax.nn.softplus(ref_sampled_lse(
                r, c, co, jnp.asarray(ids), jnp.asarray(pos), 8, 128)
                - s_pos))

        want = np.asarray(ref(reps, cand, corr))
        gw = jax.grad(ref, argnums=(0, 1, 2))(reps, cand, corr)
        got, gg = _port_grads(
            lambda r, c, co: torch.sum(torch.nn.functional.softplus(
                slse.sampled_lse(r, c, co, _t(ids), _t(pos)) - _t(s_pos))),
            reps, cand, corr)
        out = slse.sampled_lse(_t(reps), _t(cand), _t(corr), _t(ids),
                               _t(pos))
        assert float(out[2]) < -1e29
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert not np.any(gg[0][2])          # row 2's dreps is exactly 0
        for a, b in zip(gg, gw):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3,
                                       atol=1e-4)

    def test_bf16_candidates_and_compute(self):
        reps, cand, corr, ids, pos = _slse_case(11, 8, 200, 32)
        cand16 = jnp.asarray(cand, jnp.bfloat16)
        want = ref_sampled_lse(jnp.asarray(reps), cand16, jnp.asarray(corr),
                               jnp.asarray(ids), jnp.asarray(pos), 8, 128,
                               None, "bfloat16")
        gw = jax.grad(lambda c: jnp.sum(ref_sampled_lse(
            jnp.asarray(reps), c, jnp.asarray(corr), jnp.asarray(ids),
            jnp.asarray(pos), 8, 128, None, "bfloat16")))(cand16)
        c = params_from_jax({"c": np.asarray(cand16)})["c"]
        c.requires_grad_(True)
        got = slse.sampled_lse(_t(reps), c, _t(corr), _t(ids), _t(pos),
                               "bfloat16")
        (g,) = torch.autograd.grad(got.sum(), [c])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0.02, atol=0.05)
        assert g.dtype == torch.bfloat16 and bool(g.float().isfinite().all())
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(gw, np.float32),
                                   rtol=0.02, atol=0.05)

    def test_cpu_path_launches_no_kernel(self):
        reps, cand, corr, ids, pos = _slse_case(3, 4, 50, 16)
        n = (slse.fwd_launches, slse.bwd_launches)
        r = torch.tensor(reps, requires_grad=True)
        slse.sampled_lse(r, _t(cand), _t(corr), _t(ids), _t(pos)).sum() \
            .backward()
        assert (slse.fwd_launches, slse.bwd_launches) == n

    def test_refuses_a_bad_dtype(self):
        reps, cand, corr, ids, pos = _slse_case(3, 4, 50, 16)
        with pytest.raises(ValueError, match="dtype"):
            slse.sampled_lse(_t(reps), _t(cand), _t(corr), _t(ids), _t(pos),
                             "float16")


# --- the LSE objective -----------------------------------------------------

V, DW, DE, E, B, W, K = 60, 16, 12, 40, 16, 5, 12


def _cfg(compute="float32", fused="off", **kw):
    return ModelConfig(model="lse", objective="sampled_softmax",
                       vocab_size=V, num_entities=E, word_dim=DW,
                       entity_dim=DE, num_negatives=K,
                       negative_distribution="unigram",
                       compute_dtype=compute, fused_softmax=fused, **kw)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "word_emb": rng.normal(size=(V, DW)).astype(np.float32) / 2,
        "proj_w": rng.normal(size=(DW, DE)).astype(np.float32) / 2,
        "proj_b": rng.normal(size=(DE,)).astype(np.float32) / 4,
        "entity_emb": rng.normal(size=(E, DE)).astype(np.float32) / 2,
    }


def _batch(seed=1, n=B):
    rng = np.random.default_rng(seed)
    return {"windows": rng.integers(0, V, size=(n, W)).astype(np.int32),
            "lengths": rng.integers(1, W + 1, size=n).astype(np.int32),
            "entities": rng.integers(0, E, size=n).astype(np.int32)}


def _negatives(seed, batch):
    negs = np.random.default_rng(seed).integers(0, E, size=K).astype(np.int32)
    negs[:3] = batch["entities"][:3]          # accidental hits
    return negs


def _counts(seed=5):
    return np.random.default_rng(seed).integers(1, 20, size=E)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", ["off", "on"])
def test_loss_sampled_softmax_matches_reference(fused, compute):
    cfg = _cfg(compute, fused)
    p, batch = _np_params(), _batch()
    negs = _negatives(2, batch)
    noise_ref = ref_lse.noise_logits(_counts(), cfg)
    noise = lse.noise_logits(_counts(), cfg)
    np.testing.assert_allclose(noise.numpy(), np.asarray(noise_ref),
                               rtol=1e-6)

    def ref(params):
        return ref_lse.loss_sampled_softmax(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg,
            negatives=jnp.asarray(negs), noise=noise_ref)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, gw = jax.value_and_grad(ref)(jp)
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(p).items()}
    got = lse.loss_sampled_softmax(
        tp, {k: _t(v) for k, v in batch.items()}, cfg,
        negatives=_t(negs), noise=noise)
    names = sorted(tp)
    gg = torch.autograd.grad(got, [tp[n] for n in names])
    tol = (dict(rtol=1e-5, atol=1e-6) if compute == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(got.item(), float(want), **tol)
    for n, g in zip(names, gg):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw[n]), **tol,
                                   err_msg=n)


def _nce_negatives(seed, batch):
    negs = np.random.default_rng(seed).integers(0, E, size=(B, K)
                                                ).astype(np.int32)
    negs[:3, 0] = batch["entities"][:3]       # a negative equal to the positive
    return negs


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_nce_loss_matches_reference(compute):
    cfg = _cfg(compute).replace(objective="nce")
    p, batch = _np_params(), _batch()
    negs = _nce_negatives(2, batch)

    def ref(params):
        return ref_lse.loss(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, cfg,
                            negatives=jnp.asarray(negs))

    want, gw = jax.value_and_grad(ref)({k: jnp.asarray(v)
                                        for k, v in p.items()})
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(p).items()}
    got = lse.loss(tp, {k: _t(v) for k, v in batch.items()}, cfg,
                   negatives=_t(negs))
    names = sorted(tp)
    gg = torch.autograd.grad(got, [tp[n] for n in names])
    tol = (dict(rtol=1e-5, atol=1e-6) if compute == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(got.item(), float(want), **tol)
    for n, g in zip(names, gg):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw[n]), **tol,
                                   err_msg=n)


def test_nce_loss_matches_the_numpy_twin():
    from sert_tpu.models.numpy_ref import lse_nce_loss
    cfg = _cfg().replace(objective="nce")
    p, batch = _np_params(4), _batch(5)
    negs = _nce_negatives(6, batch)
    want = lse_nce_loss(p, batch["windows"], batch["lengths"],
                        batch["entities"], negs)
    got = lse.loss(params_from_jax(p), {k: _t(v) for k, v in batch.items()},
                   cfg, negatives=_t(negs))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_api_dispatches_nce_and_draws_per_example_negatives(monkeypatch):
    cfg = _cfg().replace(objective="nce")
    p = params_from_jax(_np_params())
    batch = {k: _t(v) for k, v in _batch().items()}
    seen = []
    draw = lse.sample_negatives

    def spy(generator, noise, n, c):
        seen.append((n, noise.shape))
        return draw(generator, noise, n, c)

    monkeypatch.setattr(lse, "sample_negatives", spy)
    noise = lse.noise_logits(_counts(), cfg)
    got = api.loss_fn(p, batch, cfg, generator=torch.Generator()
                      .manual_seed(3), noise=noise)
    assert seen == [(B, (E,))]
    negs = draw(torch.Generator().manual_seed(3), noise, B, cfg)
    want = lse.loss(p, batch, cfg, negatives=negs)
    assert got.item() == want.item()
    seen.clear()
    api.loss_fn(p, batch, cfg, generator=torch.Generator().manual_seed(3))
    assert seen == [(B, (E,))]                 # uniform noise by default


def test_fused_auto_takes_the_composition_on_the_cpu():
    from sert_tpu_torch.models.common import use_fused
    assert not use_fused(_cfg(fused="auto"), torch.device("cpu"))
    assert use_fused(_cfg(fused="auto"), torch.device("cuda"))
    assert use_fused(_cfg(fused="on"), torch.device("cpu"))
    assert not use_fused(_cfg(fused="off"), torch.device("cuda"))


def test_sample_negatives_follow_the_noise():
    cfg = _cfg().replace(num_negatives=4000)
    noise = torch.full((E,), -30.0)
    noise[[3, 17]] = 0.0                       # all mass on two entities
    g = torch.Generator().manual_seed(0)
    negs = lse.sample_negatives(g, noise, 2, cfg)
    assert negs.shape == (2, 4000) and negs.dtype == torch.int64
    assert set(negs.unique().tolist()) == {3, 17}
    frac = (negs == 3).float().mean().item()
    assert 0.45 < frac < 0.55
    again = lse.sample_negatives(torch.Generator().manual_seed(0), noise, 2,
                                 cfg)
    assert torch.equal(negs, again)


def test_noise_table_is_computed_once_and_follows_in_place_changes():
    cfg = _cfg().replace(num_negatives=64)
    noise = torch.from_numpy(
        np.random.default_rng(5).normal(size=E).astype(np.float32))
    negs = torch.arange(E)
    corr = lse.sampled_correction(noise, negs)
    want = jax.nn.log_softmax(jnp.asarray(noise.numpy())) + np.log(E)
    np.testing.assert_allclose(corr.numpy(), np.asarray(want), atol=1e-6)
    table = lse._table(noise)
    assert lse._table(noise)[0] is table[0]    # cached for this tensor
    cdf, log_q = lse.noise_table(noise)
    assert torch.equal(cdf, table[0]) and torch.equal(log_q, table[1])
    noise.fill_(-30.0)
    noise[7] = 0.0                             # in place: all mass on 7
    draws = lse.sample_negatives(torch.Generator().manual_seed(0), noise,
                                 2, cfg)
    assert set(draws.unique().tolist()) == {7}
    assert lse._table(noise)[0] is not table[0]


def test_registry_and_association_writers_match_save(tmp_path):
    from sert_tpu.data.assoc import Associations as RefAssociations
    from sert_tpu.data.assoc import EntityRegistry as RefRegistry
    from sert_tpu_torch.data.assoc import Associations, EntityRegistry
    names = [f"e{i}" for i in range(5)]
    by_doc = {"d0": [0, 3, 4], "d1": [3], "d2": [1, 2]}
    reg, assoc = EntityRegistry(names), Associations()
    for doc, ents in by_doc.items():
        for e in ents:
            assoc.add(doc, e)
    reg.save(str(tmp_path / "reg_saved"))
    assoc.save(str(tmp_path / "assoc_saved"))
    EntityRegistry.write(str(tmp_path / "reg_written"), names)
    Associations.write(str(tmp_path / "assoc_written"), by_doc)
    for kind in ("reg", "assoc"):
        assert ((tmp_path / f"{kind}_saved").read_text()
                == (tmp_path / f"{kind}_written").read_text())
    assert RefRegistry.load(str(tmp_path / "reg_written")).names == names
    ref = RefAssociations.load(str(tmp_path / "assoc_written"))
    assert dict(ref.items()) == by_doc
    assert ref.entity_instance_counts(5) == [1, 1, 1, 2, 1]


@pytest.mark.parametrize("n", [1, 5, 1024, 1025, 5000, 1024 * 1024 + 3])
def test_prefix_sums_match_cumsum(n):
    x = torch.rand(n, generator=torch.Generator().manual_seed(n))
    torch.testing.assert_close(lse._cumsum(x),
                               torch.cumsum(x.double(), 0).float(),
                               rtol=1e-5, atol=1e-6)


def test_all_entity_scores_match_reference():
    cfg, p, batch = _cfg(), _np_params(3), _batch(4)
    from sert_tpu.models import api as ref_api
    want = ref_api.all_entity_scores(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(batch["windows"]), jnp.asarray(batch["lengths"]), cfg)
    got = api.all_entity_scores(params_from_jax(p), _t(batch["windows"]),
                                _t(batch["lengths"]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --- learning rates and the optimizer step --------------------------------

@pytest.mark.parametrize("sched", [
    dict(lr_schedule="constant"),
    dict(lr_schedule="constant", lr_warmup_steps=5),
    dict(lr_schedule="cosine", lr_decay_steps=30),
    dict(lr_schedule="cosine", lr_decay_steps=30, lr_warmup_steps=5,
         lr_final_fraction=0.05),
    dict(lr_schedule="linear", lr_decay_steps=30),
    dict(lr_schedule="linear", lr_decay_steps=30, lr_warmup_steps=5,
         lr_final_fraction=0.1),
])
def test_make_lr_matches_optax(sched):
    cfg = TrainConfig(learning_rate=3e-3, **sched)
    want = ref_step.make_lr(cfg)
    got = port_step.make_lr(cfg)
    for s in range(40):
        w = float(want(s)) if callable(want) else want
        np.testing.assert_allclose(got(s), w, rtol=1e-6,
                                   atol=1e-7 * cfg.learning_rate,
                                   err_msg=f"step {s}")


def _ref_state_arrays(state):
    """Reference params + optimizer state as {tree path: numpy array}."""
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


@pytest.mark.parametrize("train_kw", [
    dict(optimizer="adam"),
    dict(optimizer="adam", lr_schedule="cosine", lr_decay_steps=4,
         lr_warmup_steps=1),
    dict(optimizer="adagrad"),
    dict(optimizer="sgd", learning_rate=0.1),
    dict(optimizer="adam", grad_clip_norm=0.05, weight_decay=0.01),
    dict(optimizer="adagrad", grad_clip_norm=0.05, weight_decay=0.01,
         lr_schedule="linear", lr_decay_steps=5),
])
def test_three_steps_match_reference(train_kw):
    mcfg = _cfg()
    tcfg = TrainConfig(learning_rate=train_kw.pop("learning_rate", 5e-2),
                       sparse_update="off", **train_kw)
    batches = [_batch(10 + i) for i in range(3)]
    negs = [_negatives(20 + i, b) for i, b in enumerate(batches)]
    noise_ref = ref_lse.noise_logits(_counts(), mcfg)
    noise = lse.noise_logits(_counts(), mcfg)
    calls = {"ref": 0, "port": 0}

    def ref_loss(params, batch, cfg, rng=None, noise=None):
        i = calls["ref"]
        calls["ref"] += 1
        return ref_lse.loss_sampled_softmax(params, batch, cfg,
                                            negatives=jnp.asarray(negs[i]),
                                            noise=noise)

    def port_loss(params, batch, cfg, generator=None, noise=None):
        i = calls["port"]
        calls["port"] += 1
        return lse.loss_sampled_softmax(params, batch, cfg,
                                        negatives=_t(negs[i]), noise=noise)

    ref_s = ref_step.init_state(jax.random.key(0), mcfg, tcfg)
    p = _np_params(7)
    ref_s = ref_s._replace(params={k: jnp.asarray(v) for k, v in p.items()})
    port_s = port_step.init_state(0, mcfg, tcfg)
    # A copy: the port updates in place, and JAX may alias p's memory and
    # read it after an asynchronous dispatch.
    port_s.params = params_from_jax({k: v.copy() for k, v in p.items()})
    ref_fn = ref_step.make_train_step(mcfg, tcfg, noise=noise_ref, jit=False,
                                      loss_fn=ref_loss)
    port_fn = port_step.make_train_step(mcfg, tcfg, noise=noise,
                                        loss_fn=port_loss)
    assert set(_port_state_arrays(port_s)) == set(_ref_state_arrays(ref_s))
    for i, b in enumerate(batches):
        ref_s, ref_m = ref_fn(ref_s, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        port_s, port_m = port_fn(port_s, {k: _t(v) for k, v in b.items()})
        assert port_s.step == int(ref_s.step) == i + 1
        np.testing.assert_allclose(port_m["loss"].item(),
                                   float(ref_m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(port_m["grad_norm"].item(),
                                   float(ref_m["grad_norm"]), rtol=1e-5)
        want = _ref_state_arrays(ref_s)
        for key, got in _port_state_arrays(port_s).items():
            np.testing.assert_allclose(got, want[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} {key}")


def test_steps_per_call_runs_the_micro_steps_in_order():
    mcfg = _cfg()
    batches = [_batch(30 + i) for i in range(4)]
    negs = [_negatives(40 + i, b) for i, b in enumerate(batches)]

    def run(n):
        tcfg = TrainConfig(optimizer="adam", learning_rate=1e-2,
                           steps_per_call=n)
        it = iter(negs)
        fn = port_step.make_train_step(
            mcfg, tcfg, loss_fn=lambda p, b, c, generator=None, noise=None:
            lse.loss_sampled_softmax(p, b, c, negatives=_t(next(it))))
        s = port_step.init_state(3, mcfg, tcfg)
        groups = _group_batches(((b, None) for b in batches), n,
                                stack=n > 1)
        for stacked, _ in groups:
            s, m = fn(s, {k: _t(v) for k, v in stacked.items()})
        return s, m

    one, m1 = run(1)
    four, m4 = run(4)
    assert one.step == four.step == 4
    assert m1["loss"].item() == m4["loss"].item()
    for k in one.params:
        assert torch.equal(one.params[k], four.params[k])


@pytest.mark.parametrize("train_kw", [dict(optimizer="adafactor")])
def test_unported_optimizers_raise(train_kw):
    """Named for the refusal it replaced: adafactor, once refused, now
    builds the dense step (no sparse or fused step takes it) with
    optax's state, and one step moves every param
    (tests/test_torch_adafactor.py holds it against the reference)."""
    tcfg = TrainConfig(sparse_update="auto", **train_kw)
    negs = _negatives(3, _batch(2))
    with pytest.warns(UserWarning, match="adafactor"):
        fn = port_step.make_train_step(
            _cfg(), tcfg, loss_fn=lambda p, b, c, generator=None, noise=None:
            lse.loss_sampled_softmax(p, b, c, negatives=_t(negs)))
    s = port_step.init_state(0, _cfg(), tcfg)
    assert {k.split("['")[0] for k in s.opt_state} == {
        "[0].count", "[0].v_row", "[0].v_col", "[0].v"}
    before = {k: v.clone() for k, v in s.params.items()}
    s, m = fn(s, {k: _t(v) for k, v in _batch(2).items()})
    assert s.step == 1 and s.opt_state["[0].count"] == 1
    assert np.isfinite(m["loss"].item())
    for k, v in s.params.items():
        assert not torch.equal(v, before[k]), k


# --- checkpoints across packages -------------------------------------------

@pytest.mark.parametrize("train_kw", [
    dict(optimizer="adam", lr_schedule="cosine", lr_decay_steps=10),
    dict(optimizer="adagrad", grad_clip_norm=1.0),
    dict(optimizer="sgd", weight_decay=0.01),
])
def test_full_state_checkpoints_cross_load(tmp_path, train_kw):
    mcfg, tcfg = _cfg(), TrainConfig(sparse_update="off", **train_kw)
    rng = np.random.default_rng(0)
    port_s = port_step.init_state(5, mcfg, tcfg)
    for k, v in port_s.opt_state.items():   # non-trivial moments and counts
        if isinstance(v, int):
            port_s.opt_state[k] = 3
        else:
            v.copy_(_t(rng.random(v.shape).astype(np.float32)))
    port_s.step = 3
    path = ckpt.save_checkpoint(str(tmp_path / "p"), 3, port_s,
                                {"epoch": 1})
    ref_tmpl = ref_step.init_state(jax.random.key(1), mcfg, tcfg)
    ref_s, meta = ref_ckpt.load_checkpoint(path, ref_tmpl)
    assert meta["epoch"] == 1 and int(ref_s.step) == 3
    want = _port_state_arrays(port_s)
    for key, arr in _ref_state_arrays(ref_s).items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
    assert np.asarray(jax.random.key_data(ref_s.rng)).shape == (2,)

    # ... and back: the reference's file into the port.
    path2 = ref_ckpt.save_checkpoint(str(tmp_path / "r"), 4, ref_s)
    back, _ = ckpt.load_checkpoint(path2, port_step.init_state(9, mcfg,
                                                               tcfg))
    assert back.step == int(ref_s.step) == 3
    got = _port_state_arrays(back)
    for key, arr in _ref_state_arrays(ref_s).items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    key_data = np.asarray(jax.random.key_data(ref_s.rng)).astype(np.uint64)
    seeded = torch.Generator().manual_seed(
        int(key_data[0]) << 32 | int(key_data[1]))
    assert torch.equal(back.generator.get_state(), seeded.get_state())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_only_checkpoints_cross_load(tmp_path, dtype):
    mcfg, tcfg = _cfg(), TrainConfig(sparse_update="off")
    port_s = port_step.init_state(2, mcfg, tcfg)
    path = ckpt.save_checkpoint(str(tmp_path / "p"), 7, port_s,
                                params_only=True, params_dtype=dtype)
    meta = ckpt.load_meta(path)
    assert meta["params_only"] is True
    assert meta.get("snapshot_dtype", "float32") == dtype
    ref_s, _ = ref_ckpt.load_checkpoint(
        path, ref_step.init_state(jax.random.key(0), mcfg, tcfg))
    for k, v in port_s.params.items():
        want = v.to(getattr(torch, dtype)).float().numpy()
        np.testing.assert_array_equal(np.asarray(ref_s.params[k],
                                                 np.float32), want)

    ref_path = ref_ckpt.save_checkpoint(
        str(tmp_path / "r"), 8, ref_s, params_only=True, params_dtype=dtype)
    tmpl = port_step.init_state(4, mcfg, tcfg)
    back, meta = ckpt.load_checkpoint(ref_path, tmpl)
    assert back.step == int(ref_s.step) == 0
    assert back.opt_state is tmpl.opt_state
    for k in port_s.params:
        np.testing.assert_array_equal(
            back.params[k].numpy(), np.asarray(ref_s.params[k], np.float32))


def test_async_checkpointer_snapshots_the_state_it_was_given(tmp_path):
    mcfg, tcfg = _cfg(), TrainConfig()
    s = port_step.init_state(0, mcfg, tcfg)
    before = {k: v.clone() for k, v in s.params.items()}
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), 1, s, {"epoch": 0})
    for v in s.params.values():        # the next step updates in place
        v.add_(1.0)
    saver.wait()
    back, _ = ckpt.load_checkpoint(ckpt.latest_checkpoint(str(tmp_path)),
                                   port_step.init_state(1, mcfg, tcfg))
    for k, v in before.items():
        assert torch.equal(back.params[k], v)


# --- the loop: resume ------------------------------------------------------

def _prepared(tmp_path, seed=1):
    recipe = recipes.tiny_recipe("lse", objective="sampled_softmax",
                                 negative_distribution="unigram")
    data = str(tmp_path / "data")
    pipeline.prepare_collection(recipes.tiny_spec(seed=seed).build(), data,
                                recipe)
    return recipe, data


def _with_train(recipe, **kw):
    return dataclasses.replace(recipe,
                               train=dataclasses.replace(recipe.train, **kw))


def _final_params(run_dir):
    path = ckpt.latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    return ckpt.load_params(path), ckpt.load_meta(path)


def test_resume_across_an_epoch_boundary_is_exact(tmp_path):
    recipe, data = _prepared(tmp_path)
    two = _with_train(recipe, num_epochs=2)
    s_all, _ = pipeline.train_from_dir(two, data, str(tmp_path / "a"),
                                       device="cpu")
    pipeline.train_from_dir(_with_train(recipe, num_epochs=1), data,
                            str(tmp_path / "b"), device="cpu")
    s_res, _ = pipeline.train_from_dir(two, data, str(tmp_path / "b"),
                                       device="cpu")
    assert s_all.step == s_res.step > 0
    for k in s_all.params:
        assert torch.equal(s_all.params[k], s_res.params[k]), k
    for k, v in s_all.opt_state.items():
        assert (torch.equal(v, s_res.opt_state[k]) if torch.is_tensor(v)
                else v == s_res.opt_state[k]), k


def test_resume_from_a_mid_epoch_checkpoint_is_exact(tmp_path):
    recipe, data = _prepared(tmp_path, seed=2)
    r = _with_train(recipe, num_epochs=2, checkpoint_every_steps=10,
                    lr_schedule="cosine", steps_per_call=2)
    run = str(tmp_path / "run")
    s_all, _ = pipeline.train_from_dir(r, data, run, device="cpu")
    cdir = os.path.join(run, "checkpoints")
    steps = sorted(ckpt.list_checkpoints(cdir))
    mid = [s for s in steps
           if ckpt.load_meta(ckpt.list_checkpoints(cdir)[s])["cursor"]]
    assert mid and mid[0] < s_all.step
    for s, path in ckpt.list_checkpoints(cdir).items():
        if s > mid[0]:                      # a crash right after mid[0]
            os.remove(path)
            os.remove(path[:-4] + ".json")
    s_res, _ = pipeline.train_from_dir(r, data, run, device="cpu")
    assert s_res.step == s_all.step
    for k in s_all.params:
        assert torch.equal(s_all.params[k], s_res.params[k]), k


def test_snapshot_rules(tmp_path):
    recipe, data = _prepared(tmp_path, seed=3)
    r = _with_train(recipe, num_epochs=3, epoch_snapshot="params",
                    snapshot_dtype="bfloat16", epoch_snapshot_every=2)
    run = str(tmp_path / "run")
    pipeline.train_from_dir(r, data, run, device="cpu")
    cdir = os.path.join(run, "checkpoints")
    metas = [ckpt.load_meta(p) for p in ckpt.list_checkpoints(cdir).values()]
    assert [m["epoch"] for m in metas] == [2, 3]
    assert metas[0]["params_only"] and metas[0]["snapshot_dtype"] == \
        "bfloat16"
    assert not metas[1].get("params_only")      # final_snapshot="full"
    logs = [json.loads(x) for x in open(os.path.join(run,
                                                     "train_log.jsonl"))]
    events = {x["event"] for x in logs}
    assert {"warmup", "train_step", "epoch_end",
            "epoch_snapshot_skipped"} <= events
    step_fields = {"step", "epoch", "loss", "grad_norm", "steps_per_sec",
                   "instances_per_sec", "feed_wait_ms", "device_sync_ms"}
    assert all(step_fields <= set(x) for x in logs
               if x["event"] == "train_step")


@pytest.mark.parametrize("train_kw,item", [
    (dict(mesh_shape=(2, 1)), "item 12"),
])
def test_unported_loop_options_raise(tmp_path, caplog, train_kw, item):
    """The mesh (ROADMAP Queue 1 item 12) was once refused here and is now
    ported; the test keeps its name. A mesh larger than the world of one
    rank no longer raises: it logs the reference's warning, trains on that
    rank, and ends where the one-device run ends
    (tests/test_torch_mesh_train.py holds the mesh itself)."""
    recipe, data = _prepared(tmp_path)
    log = logging.getLogger("sert_tpu.train")   # the port's does not
    log.addHandler(caplog.handler)              # propagate to the root
    try:
        with caplog.at_level(logging.WARNING):
            meshed, _ = pipeline.train_from_dir(
                _with_train(recipe, **train_kw), data,
                str(tmp_path / "run"), device="cpu")
    finally:
        log.removeHandler(caplog.handler)
    assert "mesh (2, 1) needs 2 devices, have 1; running single-device" \
        in caplog.text, item
    single, _ = pipeline.train_from_dir(recipe, data, str(tmp_path / "one"),
                                        device="cpu")
    assert meshed.step == single.step > 0
    for k, v in single.params.items():
        assert torch.equal(meshed.params[k], v), (item, k)


def test_packed_feed_resumes_where_the_raw_feed_ends(tmp_path):
    """packed_feed="on" (once refused): a packed run resumed from its
    mid-epoch checkpoint ends bit for bit where the raw run ends
    (tests/test_torch_wirepack.py holds the format to the reference)."""
    recipe, data = _prepared(tmp_path, seed=4)
    r = _with_train(recipe, num_epochs=2, checkpoint_every_steps=10)
    s_raw, _ = pipeline.train_from_dir(r, data, str(tmp_path / "raw"),
                                       device="cpu")
    packed = _with_train(r, packed_feed="on")
    run = str(tmp_path / "packed")
    pipeline.train_from_dir(packed, data, run, device="cpu")
    cdir = os.path.join(run, "checkpoints")
    saved = ckpt.list_checkpoints(cdir)
    mid = min(s for s, p in saved.items() if ckpt.load_meta(p)["cursor"])
    for s, path in saved.items():
        if s > mid:                      # a crash right after mid
            os.remove(path)
            os.remove(path[:-4] + ".json")
    s_res, _ = pipeline.train_from_dir(packed, data, run, device="cpu")
    assert s_res.step == s_raw.step > mid
    for k in s_raw.params:
        assert torch.equal(s_raw.params[k], s_res.params[k]), k


def test_init_word_emb_seeds_the_fresh_run_as_the_reference(tmp_path):
    """A dump-format npz (terms in another order, one unknown, one vocab
    term missing) seeds the fresh run's word_emb as the reference's
    load_pretrained_word_emb seeds the same initialization; with no epoch
    to train the state returned is step 0's."""
    from sert_tpu.data.vocab import Vocabulary
    recipe, data = _prepared(tmp_path)
    state, resolved = pipeline.train_from_dir(
        _with_train(recipe, num_epochs=0), data, str(tmp_path / "fresh"),
        device="cpu")
    base = state.params["word_emb"].numpy().copy()
    vocab = Vocabulary.load(os.path.join(data, "vocab.json"))
    terms = list(vocab.iter_terms())[1:][::-1] + ["not-a-term"]
    emb = np.random.default_rng(0).normal(
        size=(len(terms), base.shape[1])).astype(np.float32)
    npz = str(tmp_path / "dump.npz")
    np.savez(npz, word_emb=emb, terms=np.asarray(terms, dtype=object))
    want, hits = ref_pipeline.load_pretrained_word_emb(npz, vocab, base)
    assert hits == len(terms) - 1
    seeded, _ = pipeline.train_from_dir(
        _with_train(recipe, num_epochs=0), data, str(tmp_path / "seeded"),
        init_word_emb=npz, device="cpu")
    assert seeded.step == 0
    np.testing.assert_array_equal(seeded.params["word_emb"].numpy(), want)
    for key in ("proj_w", "proj_b", "entity_emb"):
        assert torch.equal(seeded.params[key], state.params[key])


# --- the feeder -------------------------------------------------------------

def test_feeder_yields_in_order_and_propagates_errors():
    assert list(PrefetchFeeder(iter(range(5)), lambda x: x * 2)) == \
        [0, 2, 4, 6, 8]
    assert list(PrefetchFeeder(iter(range(3)), deterministic=True)) == \
        [0, 1, 2]

    def broken():
        yield 1
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(PrefetchFeeder(broken()))
    f = PrefetchFeeder(iter(range(100)))
    next(iter(f))
    f.close()
    assert not f._thread.is_alive()


# --- end to end --------------------------------------------------------------

def _tiny_recipe():
    return recipes.tiny_recipe("lse", objective="sampled_softmax",
                               negative_distribution="unigram")


def test_nce_recipe_end_to_end(tmp_path):
    """tiny_recipe("lse") as it stands: the NCE objective, adam (the lazy
    step end to end: tests/test_torch_nojax.py and chip_smoke.py)."""
    recipe = recipes.tiny_recipe("lse")
    assert recipe.model.objective == "nce"
    results = pipeline.run_end_to_end(recipes.tiny_spec(seed=1).build(),
                                      recipe, str(tmp_path), device="cpu")
    assert results["all"]["ndcg@100"] > 0.85, results["all"]


def test_run_end_to_end_reaches_the_reference_bar(tmp_path):
    results = pipeline.run_end_to_end(recipes.tiny_spec(seed=1).build(),
                                      _tiny_recipe(), str(tmp_path),
                                      device="cpu")
    assert results["all"]["ndcg@100"] > 0.85, results["all"]
    for name in ("run.trec", "qrels.trec", "train_log.jsonl",
                 "recipe.json"):
        assert os.path.exists(tmp_path / "run" / name)


def test_cli_prepare_train_query_evaluate(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from sert_tpu.utils.config import save_config
    save_config(_tiny_recipe(), "r.json")
    assert cli.main(["prepare", "--recipe", "r.json", "--out", "data"]) == 0
    assert cli.main(["train", "--recipe", "r.json", "--data", "data",
                     "--out", "run", "--device", "cpu"]) == 0
    assert cli.main(["query", "--recipe", "r.json", "--data", "data",
                     "--run-dir", "run", "--topics", "data/topics.tsv",
                     "--out", "run.trec", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(["evaluate", "--run", "run.trec", "--qrels",
                     "data/qrels.trec"]) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert metrics["ndcg@100"] > 0.85, metrics


def test_port_run_scores_like_the_reference_on_its_checkpoint(tmp_path):
    """The reference's scorer on the port's trained checkpoint ranks like
    the port's own scorer."""
    recipe, data = _prepared(tmp_path, seed=4)
    run = str(tmp_path / "run")
    state, resolved = pipeline.train_from_dir(recipe, data, run,
                                              device="cpu")
    ref_params, _, registry = ref_pipeline.load_scorer(run, data, resolved)
    from sert_tpu.scoring.scorer import dense_scores as ref_dense
    from sert_tpu_torch.scoring.scorer import dense_scores
    batch = _batch(50, n=8)
    w = np.minimum(batch["windows"], resolved.model.vocab_size - 1)
    want = ref_dense(ref_params, resolved.model, jnp.asarray(w),
                     jnp.asarray(batch["lengths"]), "dot")
    got = dense_scores(state.params, resolved.model, _t(w),
                       _t(batch["lengths"]), "dot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
