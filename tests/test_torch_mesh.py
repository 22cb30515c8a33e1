"""The port's mesh (sert_tpu_torch.parallel): mesh shapes, the sharding
rule, and the sharded losses on a gloo world of 8 CPU ranks, held against
the reference (sert_tpu) on the conftest's 8 fake CPU devices and on one
device, on the same numpy inputs; negatives are injected.

One world of 8 ranks (parallel.dryrun.launch) runs every case of this
file; the reference's side is computed here. Counterparts of
tests/test_parallel.py:42-73 (mesh, rule) and
tests/test_parallel_fused.py:53, :298, :358 (the sharded losses), at their
meshes and tolerances: the xent loss within 1e-3 and its gradients within
1e-4 (atol and rtol); the sampled softmax rtol 1e-5, its gradients 1e-5.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.models import api as ref_api  # noqa: E402
from sert_tpu.models import lse as ref_lse  # noqa: E402
from sert_tpu.utils import config as ref_config  # noqa: E402
from sert_tpu_torch.parallel import fused_loss, train as ptrain  # noqa: E402
from sert_tpu_torch.parallel.dryrun import launch  # noqa: E402
from sert_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from sert_tpu_torch.parallel.sharding import (  # noqa: E402
    param_spec, shard_state, state_shardings)
from sert_tpu_torch.train.step import init_state  # noqa: E402
from sert_tpu_torch.utils.config import ModelConfig, TrainConfig  # noqa: E402

B, D, E, V = 32, 16, 64, 50
MESHES = [(2, 4), (8, 1), (1, 8)]
TCFG = TrainConfig(batch_size=16, learning_rate=1e-2, sparse_update="off")


def ref_cfg(cfg) -> ref_config.ModelConfig:
    return ref_config.ModelConfig(**dataclasses.asdict(cfg))


def _xent_inputs(layout, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(D, E)).astype(np.float32)
    return dict(pooled=rng.normal(size=(B, D)).astype(np.float32),
                W=W if layout == "de" else np.ascontiguousarray(W.T),
                b=rng.normal(size=(E,)).astype(np.float32),
                labels=rng.integers(0, E, size=B).astype(np.int64))


def _batch(seed, batch_size=16, w=5):
    rng = np.random.default_rng(seed)
    return {"windows": rng.integers(0, V, (batch_size, w)).astype(np.int32),
            "lengths": rng.integers(1, w + 1, batch_size).astype(np.int32),
            "entities": rng.integers(0, E, batch_size).astype(np.int32)}


def _sampled_cfg(k=16, fused="on"):
    return ModelConfig(model="lse", objective="sampled_softmax",
                       vocab_size=V, num_entities=E, word_dim=8,
                       entity_dim=8, num_negatives=k, fused_softmax=fused)


# The model-loss cases: (id, port cfg, mesh, negatives shape or None).
MODEL_CASES = (
    [(f"sampled-{m[0]}x{m[1]}", _sampled_cfg(), m, (16,)) for m in MESHES]
    + [("sampled-k12-auto-1x8", _sampled_cfg(12, "auto"), (1, 8), (12,)),
       ("nce-2x4", _sampled_cfg().replace(objective="nce",
                                           fused_softmax="auto"), (2, 4),
        (16, 16)),
       ("loglinear-2x4", ModelConfig(model="loglinear", vocab_size=V,
                                     num_entities=E, word_dim=8), (2, 4),
        None),
       ("lse_full-1x8", _sampled_cfg().replace(model="lse_full",
                                               fused_softmax="auto"),
        (1, 8), None)])


def _model_inputs(cfg, neg_shape, seed):
    params = ref_api.init_params(jax.random.key(seed), ref_cfg(cfg))
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    rng = np.random.default_rng(seed)
    negs = (None if neg_shape is None
            else rng.integers(0, E, neg_shape).astype(np.int64))
    return params, _batch(seed), negs


@pytest.fixture(scope="module")
def world():
    """Every case of this file on one 8-rank world: {case id: results by
    rank}."""
    jobs, ids = [], []
    jobs.append(("mesh_shapes", {"shapes": [(-1, 4), (2, -1), (4, 4),
                                            (1, 4), (8, 1)]}))
    ids.append("shapes")
    for layout in ("de", "ed"):
        for m in MESHES:
            jobs.append(("xent_loss", dict(mesh=m, layout=layout,
                                           **_xent_inputs(layout))))
            ids.append(f"xent-{layout}-{m[0]}x{m[1]}")
    for i, (cid, cfg, m, neg_shape) in enumerate(MODEL_CASES):
        params, batch, negs = _model_inputs(cfg, neg_shape, i)
        jobs.append(("model_loss", dict(mesh=m, cfg=cfg, tcfg=TCFG,
                                        params=params, batch=batch,
                                        negatives=negs)))
        ids.append(cid)
    out = launch(8, "sert_tpu_torch.parallel.worlds:run_jobs", jobs)
    return {cid: [r[j] for r in out] for j, cid in enumerate(ids)}


# --- the mesh ----------------------------------------------------------------

class TestMesh:
    def test_one_rank_shapes(self):
        m = make_mesh((1, 1), device="cpu")
        assert m.shape == {"data": 1, "model": 1} and m.size == 1
        assert make_mesh((1, -1), device="cpu").shape["model"] == 1
        with pytest.raises(ValueError, match="needs 8 ranks, have 1"):
            make_mesh((2, 4), device="cpu")
        with pytest.raises(ValueError, match="at most one"):
            make_mesh((-1, -1), device="cpu")

    def test_infer_in_world(self, world):
        shapes = world["shapes"][0]["shapes"]
        assert shapes[:2] == [[2, 4], [2, 4]]
        assert "needs 16 ranks, have 8" in shapes[2]
        assert "leaves 4 of the 8 ranks out" in shapes[3]
        assert shapes[4] == [8, 1]
        # every rank built the same meshes
        assert all(r == world["shapes"][0] for r in world["shapes"])


class TestShardingRules:
    def test_entity_axis_sharded(self):
        cfg = ModelConfig(model="loglinear", vocab_size=50, num_entities=40,
                          word_dim=8)
        sh = state_shardings(init_state(0, cfg, TCFG), cfg)["params"]
        assert sh["proj_w"] == (None, "model")
        assert sh["proj_b"] == ("model",)
        assert sh["word_emb"] == (None, None)

    def test_lse_entity_emb_row_sharded(self):
        cfg = ModelConfig(model="lse", vocab_size=50, num_entities=40,
                          word_dim=8, entity_dim=8)
        sh = state_shardings(init_state(0, cfg, TCFG), cfg)
        assert sh["params"]["entity_emb"] == ("model", None)
        assert sh["opt_state"]["[0].mu['entity_emb']"] == ("model", None)
        assert sh["opt_state"]["[0].count"] == ()

    def test_ambiguous_sizes_rejected(self):
        cfg = ModelConfig(model="loglinear", vocab_size=40, num_entities=40,
                          word_dim=8)
        with pytest.raises(ValueError, match="ambiguous"):
            state_shardings(init_state(0, cfg, TCFG), cfg)

    def test_square_maps_the_entity_axis_and_slots_follow(self):
        """A width equal to the entity count: the layout's entity axis
        shards (a square proj_w's columns, not its rows; word_emb's d not
        at all)."""
        cfg = ModelConfig(model="loglinear", vocab_size=50, num_entities=8,
                          word_dim=8)
        assert param_spec("proj_w", (8, 8), cfg) == (None, "model")
        assert param_spec("word_emb", (50, 8), cfg) == (None, None)
        cfg = ModelConfig(model="loglinear", vocab_size=50, num_entities=256,
                          word_dim=128)
        tcfg = dataclasses.replace(TCFG, optimizer="adafactor")
        sh = state_shardings(init_state(0, cfg, tcfg), cfg)["opt_state"]
        # proj_w [128, 256] factors: v_row [128] replicated, v_col [256]
        assert sh["[0].v_row['proj_w']"] == (None,)
        assert sh["[0].v_col['proj_w']"] == ("model",)

    def test_one_rank_shard_is_the_state(self):
        cfg = _sampled_cfg()
        state = init_state(0, cfg, TCFG)
        got = shard_state(state, make_mesh((1, 1), device="cpu"), cfg)
        assert all(got.params[k] is v for k, v in state.params.items())


# --- the sharded losses ------------------------------------------------------

def _ref_xent(pooled, W, b, labels, layout):
    Wd = W if layout == "de" else W.T
    z = pooled @ Wd + b
    lse = jax.scipy.special.logsumexp(z, axis=-1)
    gold = jnp.take_along_axis(z, labels[:, None], 1)[:, 0]
    return jnp.sum(lse - gold)


class TestShardedXent:
    @pytest.mark.parametrize("mesh_shape", MESHES)
    @pytest.mark.parametrize("layout", ["de", "ed"])
    def test_loss_and_grads_match_reference(self, world, mesh_shape,
                                            layout):
        x = _xent_inputs(layout)
        args = (jnp.asarray(x["pooled"]), jnp.asarray(x["W"]),
                jnp.asarray(x["b"]), jnp.asarray(x["labels"], jnp.int32))
        lr, gr = jax.value_and_grad(
            lambda p, w, bb, lab: _ref_xent(p, w, bb, lab, layout),
            argnums=(0, 1, 2))(*args)
        runs = world[f"xent-{layout}-{mesh_shape[0]}x{mesh_shape[1]}"]
        for r in runs:
            assert abs(r["loss"] - float(lr)) < 1e-3
            for got, want in zip(r["grads"], gr):
                np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                           rtol=1e-4)
        for r in runs[1:]:      # every rank holds the same global values
            assert r["loss"] == runs[0]["loss"]


def _ref_loss(cfg, params, batch, negs):
    rc = ref_cfg(cfg.replace(fused_softmax="off"))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    p = {k: jnp.asarray(v) for k, v in params.items()}
    neg = None if negs is None else jnp.asarray(negs, jnp.int32)

    def f(p):
        if cfg.model != "lse":
            return ref_api.loss_fn(p, b, rc)
        if cfg.objective == "nce":
            return ref_lse.loss(p, b, rc, negatives=neg)
        return ref_lse.loss_sampled_softmax(p, b, rc, negatives=neg)
    return jax.value_and_grad(f)(p)


class TestShardedModelLosses:
    @pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in
                                                       MODEL_CASES])
    def test_loss_and_every_grad_match_reference(self, world, case):
        i = MODEL_CASES.index(case)
        cid, cfg, _, neg_shape = case
        params, batch, negs = _model_inputs(cfg, neg_shape, i)
        lr, gr = _ref_loss(cfg, params, batch, negs)
        for r in world[cid]:
            np.testing.assert_allclose(r["loss"], float(lr), rtol=1e-5)
            assert set(r["grads"]) == set(gr)
            for name, want in gr.items():
                np.testing.assert_allclose(r["grads"][name],
                                           np.asarray(want), atol=1e-5,
                                           rtol=1e-5, err_msg=name)


class TestGates:
    MESH = types.SimpleNamespace(shape={"data": 2, "model": 4})

    def test_sampled_gate_and_rejection(self):
        cfg = _sampled_cfg
        assert ptrain._want_fused_sampled(cfg(16, "auto"), self.MESH)
        assert ptrain._want_fused_sampled(cfg(16, "off"), self.MESH)
        assert not ptrain._want_fused_sampled(cfg(10, "auto"), self.MESH)
        assert ptrain._want_fused_sampled(cfg(10, "on"), self.MESH)
        with pytest.raises(ValueError, match="divide"):
            fused_loss.make_sharded_sampled_loss(cfg(10, "on"), self.MESH)
        with pytest.raises(ValueError, match="sampled_softmax"):
            fused_loss.make_sharded_sampled_loss(
                cfg().replace(objective="nce"), self.MESH)
        assert not ptrain._want_fused_sampled(
            ModelConfig(model="loglinear", vocab_size=V, num_entities=E,
                        word_dim=8, fused_softmax="on"), self.MESH)

    def test_full_softmax_loss_and_its_stitch(self):
        """The sharded full softmax takes only the full-softmax families
        and an entity count tp divides; its stitch starts rank m's block
        at m * E / tp and divides the partial by tp."""
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 4},
                                     coords={"data": 0, "model": 3},
                                     device=torch.device("cuda"))
        cfg = ModelConfig(model="loglinear", vocab_size=V, num_entities=E,
                          word_dim=8)
        with pytest.raises(ValueError, match="divide the model axis"):
            fused_loss.make_sharded_fused_loss(cfg.replace(num_entities=66),
                                               mesh)
        with pytest.raises(ValueError, match="full-softmax"):
            fused_loss.make_sharded_fused_loss(_sampled_cfg(), mesh)
        st = fused_loss.model_stitch(mesh, E // 4)
        assert (st.offset, st.parts) == (3 * E // 4, 4)

    def test_fused_update_on_a_mesh_names_the_item(self, monkeypatch):
        """fused_update="on" on a pure-TP mesh builds the fused step per
        entity block; under data parallelism it raises "pure-TP" (the
        reference's gate), never falling back."""
        cfg = ModelConfig(model="loglinear", vocab_size=V, num_entities=E,
                          word_dim=128)
        tcfg = dataclasses.replace(TCFG, fused_update="on")
        built = []
        make = ptrain.fused.make_fused_train_step
        monkeypatch.setattr(ptrain.fused, "make_fused_train_step",
                            lambda *a, **kw: built.append(kw["stitch"])
                            or make(*a, **kw))
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 4}, size=4,
                                     coords={"data": 0, "model": 1},
                                     device=torch.device("cpu"))
        step, _, _ = ptrain.make_sharded_train_step(cfg, tcfg, mesh)
        assert callable(step)
        assert [(st.offset, st.parts) for st in built] == [(E // 4, 4)]
        mesh = types.SimpleNamespace(shape={"data": 2, "model": 2}, size=4,
                                     coords={"data": 0, "model": 1},
                                     device=torch.device("cpu"))
        with pytest.raises(ValueError, match="pure-TP"):
            ptrain.make_sharded_train_step(cfg, tcfg, mesh)
