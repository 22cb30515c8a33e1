"""The port's sharded training (sert_tpu_torch.parallel.train, the loop's
mesh branch, per-process feeding, mesh checkpoints) on a gloo world of 8
CPU ranks, held against the reference (sert_tpu) on the conftest's 8 fake
CPU devices and on one device, on the same numpy inputs.

One world of 8 ranks runs every case of this file (parallel.dryrun.launch);
the reference's side and the port's one-rank side are computed here. The
negatives are one fixed draw injected into every step of both packages
(the reference's step is jitted, so its injected draw is traced once).
Counterparts of tests/test_parallel.py:83-191 and
tests/test_multihost.py:97, :153, :253. Tolerances: the reference's,
rtol 2e-4 / atol 2e-5 on params after 5 steps, rtol 2e-4 on the loss and
the grad norm; the feeds of one composition rtol 1e-6 (the same rows).
"""

import contextlib
import dataclasses
import logging
import os
import shutil
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.models import lse as ref_lse  # noqa: E402
from sert_tpu.parallel.mesh import make_mesh as ref_make_mesh  # noqa: E402
from sert_tpu.parallel.train import (  # noqa: E402
    make_sharded_train_step as ref_sharded_step)
from sert_tpu.train import checkpoint as ref_ckpt  # noqa: E402
from sert_tpu.train import step as ref_step  # noqa: E402
from sert_tpu.train.loop import train as ref_train  # noqa: E402
from sert_tpu.utils import config as rc  # noqa: E402
from sert_tpu_torch import pipeline, recipes  # noqa: E402
from sert_tpu_torch.data.assoc import (Associations,  # noqa: E402
                                       EntityRegistry)
from sert_tpu_torch.data.instances import InstanceDataset  # noqa: E402
from sert_tpu_torch.data.prepare import prepare  # noqa: E402
from sert_tpu_torch.data.synthetic import make_synthetic  # noqa: E402
from sert_tpu_torch.models import lse  # noqa: E402
from sert_tpu_torch.parallel.dryrun import launch  # noqa: E402
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sert_tpu_torch.train.step import init_state, make_train_step  # noqa: E402
from sert_tpu_torch.utils.config import (DataConfig, ModelConfig,  # noqa: E402
                                         RecipeConfig, TrainConfig)

V, E = 50, 40
MESHES = [(2, 4), (8, 1), (1, 8)]
TCFG = TrainConfig(batch_size=16, learning_rate=1e-2, sparse_update="off")
FAMILIES = {
    "loglinear": ModelConfig(model="loglinear", vocab_size=V,
                             num_entities=E, word_dim=8),
    "lse": ModelConfig(model="lse", vocab_size=V, num_entities=E,
                       word_dim=8, entity_dim=8, num_negatives=4),
    "lse_sampled": ModelConfig(model="lse", objective="sampled_softmax",
                               vocab_size=V, num_entities=E, word_dim=8,
                               entity_dim=8, num_negatives=16),
    "lse_full": ModelConfig(model="lse_full", vocab_size=V, num_entities=E,
                            word_dim=8, entity_dim=8),
}
FACTORED = ModelConfig(model="loglinear", vocab_size=V, num_entities=256,
                       word_dim=128)
ADAFACTOR = {
    # the reference's test (:111): no leaf of it factors
    "unfactored-2x4": (FAMILIES["loglinear"], (2, 4)),
    # proj_w [128, 256] factors, its column statistic over the entity axis
    "factored-1x8": (FACTORED, (1, 8)),
    "factored-8x1": (FACTORED, (8, 1)),
}
STEP_TOL = dict(rtol=2e-4, atol=2e-5)


def _ref_cfg(cfg):
    return rc.ModelConfig(**dataclasses.asdict(cfg))


def _ref_tcfg(tcfg):
    return rc.TrainConfig(**{**dataclasses.asdict(tcfg),
                             "mesh_shape": tuple(tcfg.mesh_shape),
                             "donate_state": False})


def _batches(n, E_=E, seed=0):
    rng = np.random.default_rng(seed)
    return [{"windows": rng.integers(0, V, (16, 5)).astype(np.int32),
             "lengths": rng.integers(1, 6, 16).astype(np.int32),
             "entities": rng.integers(0, E_, 16).astype(np.int32)}
            for _ in range(n)]


def _negatives(cfg, seed=1):
    if cfg.model != "lse":
        return None
    n = 1 if cfg.objective == "sampled_softmax" else 16
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.num_entities,
                        (n, cfg.num_negatives)).astype(np.int64)


@contextlib.contextmanager
def _ref_negatives(negs):
    with mock.patch.object(ref_lse, "sample_negatives",
                           lambda rng, noise, n, cfg: jnp.asarray(
                               negs, jnp.int32).reshape(n, -1)):
        yield


def _ref_params(cfg, tcfg):
    state = ref_step.init_state(jax.random.key(tcfg.seed), _ref_cfg(cfg),
                                _ref_tcfg(tcfg))
    return {k: np.asarray(v, np.float32) for k, v in state.params.items()}


def _noise(cfg):
    return (jnp.zeros((cfg.num_entities,), jnp.float32)
            if cfg.model == "lse" else None)


def _ref_single(cfg, tcfg, batches, negs):
    """The reference's one-device step over the batches: (losses, norms,
    params)."""
    with _ref_negatives(negs):
        state = ref_step.init_state(jax.random.key(tcfg.seed),
                                    _ref_cfg(cfg), _ref_tcfg(tcfg))
        step = ref_step.make_train_step(_ref_cfg(cfg), _ref_tcfg(tcfg),
                                        noise=_noise(cfg))
        out = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in
                                    b.items()})
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, {k: np.asarray(v, np.float32) for k, v in
                 state.params.items()}


def _ref_sharded(cfg, tcfg, mesh_shape, batches, negs):
    with _ref_negatives(negs):
        step, init_fn, put_fn = ref_sharded_step(
            _ref_cfg(cfg), _ref_tcfg(tcfg), ref_make_mesh(mesh_shape),
            _noise(cfg))
        state = init_fn()
        out = []
        for b in batches:
            state, m = step(state, put_fn(b))
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, {k: np.asarray(jax.device_get(v), np.float32)
                 for k, v in state.params.items()}


def _prepare(root, instances_per_shard=256, n_entities=8):
    col = make_synthetic(num_entities=n_entities, vocab_size=400,
                         docs_per_entity=3, doc_len=40, num_topics=2, seed=9)
    reg = EntityRegistry(col.entities)
    assoc = Associations()
    for d, es in col.doc_entities.items():
        for e in es:
            assoc.add(d, reg.id(e))
    ddir = str(root / "data")
    prepare(col.docs, assoc, reg, ddir,
            DataConfig(window_size=4, vocab_min_count=1,
                       instances_per_shard=instances_per_shard))
    return ddir


def _loop_recipe(data, mesh_shape, epochs=2):
    ds = InstanceDataset(data)
    mcfg = ModelConfig(model="loglinear", vocab_size=ds.meta["vocab_size"],
                       num_entities=8, word_dim=8)
    return RecipeConfig(name="mesh", model=mcfg, train=TrainConfig(
        batch_size=16, num_epochs=epochs, learning_rate=1e-2,
        log_every_steps=0, mesh_shape=mesh_shape))


STEP_CASES = [(f, m) for m in MESHES for f in FAMILIES]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The reference's runs, then every port case on one 8-rank world."""
    root = tmp_path_factory.mktemp("mesh_train")
    data = _prepare(root)
    batches = _batches(5)
    jobs, ids = [], []
    for fam, m in STEP_CASES:
        cfg = FAMILIES[fam]
        jobs.append(("train_steps", dict(
            mesh=m, cfg=cfg, tcfg=TCFG, params=_ref_params(cfg, TCFG),
            batches=batches, negatives=_negatives(cfg))))
        ids.append(f"step-{fam}-{m}")
    ada = dataclasses.replace(TCFG, optimizer="adafactor")
    for name, (cfg, m) in ADAFACTOR.items():
        jobs.append(("train_steps", dict(
            mesh=m, cfg=cfg, tcfg=ada, params=_ref_params(cfg, ada),
            batches=_batches(5, cfg.num_entities))))
        ids.append(f"adafactor-{name}")
    for fam in ("lse_sampled", "lse"):
        jobs.append(("train_steps", dict(mesh=(2, 4), cfg=FAMILIES[fam],
                                         tcfg=TCFG, batches=batches[:2])))
        ids.append(f"draws-{fam}")
    # The loop: (1, 8) beside one device; (2, 4) broken and unbroken.
    loops = {"1x8": ((1, 8), [None, None]), "2x4": ((2, 4), [2]),
             "2x4-resumed": ((2, 4), [1, 2])}
    for name, (m, runs) in loops.items():
        jobs.append(("train_loop", dict(
            recipe=_loop_recipe(data, m), data=data,
            out=str(root / f"loop-{name}"), runs=runs)))
        ids.append(f"loop-{name}")
    # The reference's (2, 4) mesh run, resumed (a no-op) by the port's mesh.
    ref_recipe = _loop_recipe(data, (2, 4))
    ref_r = rc.RecipeConfig(name="ref", model=_ref_cfg(ref_recipe.model),
                            train=_ref_tcfg(ref_recipe.train))
    from sert_tpu.data import InstanceDataset as RefDataset
    ref_state = ref_train(ref_r, RefDataset(data), str(root / "ref-run"),
                          deterministic_feed=True)
    shutil.copytree(root / "ref-run", root / "ref-run-port")
    jobs.append(("train_loop", dict(recipe=ref_recipe, data=data,
                                    out=str(root / "ref-run-port"))))
    ids.append("loop-ref-resumed")
    feed_cfg = ModelConfig(model="loglinear",
                           vocab_size=InstanceDataset(data).meta[
                               "vocab_size"], num_entities=8, word_dim=8)
    jobs.append(("feed_steps", dict(mesh=(2, 4), cfg=feed_cfg,
                                    tcfg=TCFG, data=data, steps=4)))
    ids.append("feed")
    out = launch(8, "sert_tpu_torch.parallel.worlds:run_jobs", jobs)
    world = {cid: [r[j] for r in out] for j, cid in enumerate(ids)}
    return dict(root=root, data=data, batches=batches, world=world,
                ref_state=ref_state, feed_cfg=feed_cfg)


@contextlib.contextmanager
def _train_warnings(caplog):
    """The port's loggers do not propagate to the root: hand caplog's
    handler to the train logger while the block runs."""
    log = logging.getLogger("sert_tpu.train")
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            yield
    finally:
        log.removeHandler(caplog.handler)


def _assert_params(got, want, msg=""):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **STEP_TOL,
                                   err_msg=f"{msg} {k}")


class TestShardedTraining:
    @pytest.mark.parametrize("fam,mesh_shape", STEP_CASES,
                             ids=[f"{f}-{m[0]}x{m[1]}" for f, m in
                                  STEP_CASES])
    def test_sharded_step_matches_reference(self, env, fam, mesh_shape):
        """5 steps on the mesh against the reference's one-device step
        (and, at (2, 4), its own sharded step): params, loss, grad norm."""
        cfg = FAMILIES[fam]
        runs = env["world"][f"step-{fam}-{mesh_shape}"]
        refs = [_ref_single(cfg, TCFG, env["batches"], _negatives(cfg)),
                _ref_sharded(cfg, TCFG, mesh_shape, env["batches"],
                             _negatives(cfg))]
        for metrics, params in refs:
            got = runs[0]
            _assert_params(got["params"], params, fam)
            np.testing.assert_allclose(got["losses"],
                                       [m[0] for m in metrics], rtol=2e-4)
            np.testing.assert_allclose(got["norms"],
                                       [m[1] for m in metrics], rtol=2e-4)
        for r in runs[1:]:     # every rank holds the same global metrics
            assert r["losses"] == runs[0]["losses"]
            assert r["norms"] == runs[0]["norms"]

    @pytest.mark.parametrize("name", list(ADAFACTOR))
    def test_sharded_adafactor_matches_single_device(self, env, name):
        """adafactor on the mesh against the reference's one-device and
        sharded steps; the factored cases' column statistic [E] is summed
        over the model axis (1, 8) or whole on each rank (8, 1)."""
        cfg, mesh_shape = ADAFACTOR[name]
        tcfg = dataclasses.replace(TCFG, optimizer="adafactor")
        got = env["world"][f"adafactor-{name}"][0]
        batches = _batches(5, cfg.num_entities)
        for want, want_p in (_ref_single(cfg, tcfg, batches, None),
                             _ref_sharded(cfg, tcfg, mesh_shape, batches,
                                          None)):
            _assert_params(got["params"], want_p, name)
            np.testing.assert_allclose(got["losses"], [m[0] for m in want],
                                       rtol=2e-4)
            np.testing.assert_allclose(got["norms"], [m[1] for m in want],
                                       rtol=2e-4)
        if name.startswith("factored"):
            assert got["opt"]["[0].v_col['proj_w']"].shape == (256,)

    def test_data_only_mesh(self, env):
        got = env["world"]["step-loglinear-(8, 1)"][0]
        assert np.isfinite(got["losses"]).all()

    @pytest.mark.parametrize("fam", ["lse_sampled", "lse"])
    def test_negatives_equal_on_every_rank(self, env, fam):
        """The batch-shared draw is one draw: every rank's generator steps
        in lockstep, and the draws are the one-device run's."""
        runs = env["world"][f"draws-{fam}"]
        draws = [r["draws"] for r in runs]
        assert len(draws[0]) == 2
        for d in draws[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(d, draws[0]))
        cfg = FAMILIES[fam]
        state = init_state(TCFG.seed, cfg, TCFG, sparse_override=False)
        noise = torch.zeros((E,))
        n = 1 if cfg.objective == "sampled_softmax" else 16
        one = lse.sample_negatives(state.generator, noise, n, cfg)
        assert np.array_equal(one.numpy(), draws[0][0])


class TestMeshTrainLoop:
    def test_loop_uses_mesh_and_matches_single_device(self, env, tmp_path):
        """A (1, 8) recipe trained by the same loop gives the params of the
        one-device run, and resuming the finished run loads cleanly."""
        r1 = _loop_recipe(env["data"], (1, 1))
        single, _ = pipeline.train_from_dir(r1, env["data"],
                                            str(tmp_path / "single"),
                                            device="cpu")
        first, again = env["world"]["loop-1x8"][0]["runs"]
        _assert_params(first["params"], {k: v.numpy() for k, v in
                                         single.params.items()})
        assert first["step"] == again["step"] == single.step
        for k, v in first["params"].items():
            np.testing.assert_array_equal(again["params"][k], v)

    def test_resumed_mesh_run_matches_the_unbroken_one(self, env):
        whole = env["world"]["loop-2x4"][0]["runs"][-1]
        part, rest = env["world"]["loop-2x4-resumed"][0]["runs"]
        assert rest["step"] == whole["step"] == 2 * part["step"]
        for k, v in whole["params"].items():
            np.testing.assert_array_equal(rest["params"][k], v)

    def test_only_rank_zero_wrote_and_the_reference_reads_it(self, env):
        runs = env["world"]["loop-2x4"]
        assert runs[0]["writes"] and not any(r["writes"] for r in runs[1:])
        cdir = env["root"] / "loop-2x4" / "checkpoints"
        names = sorted(os.listdir(cdir))
        assert all(n.endswith((".npz", ".json")) for n in names), names
        path = ckpt.latest_checkpoint(str(cdir), full_only=True)
        final = env["world"]["loop-2x4"][0]["runs"][-1]["params"]
        # the one-card port reads it
        state = init_state(0, _loop_recipe(env["data"], (1, 1)).model,
                           TrainConfig(batch_size=16))
        loaded, meta = ckpt.load_checkpoint(path, state)
        for k, v in final.items():
            np.testing.assert_array_equal(loaded.params[k].numpy(), v)
        # the reference reads it
        ref_s = env["ref_state"]
        ref_loaded, _ = ref_ckpt.load_checkpoint(path, ref_s)
        for k, v in final.items():
            np.testing.assert_array_equal(
                np.asarray(ref_loaded.params[k]), v)
        assert int(ref_loaded.step) == meta["step"]

    def test_port_mesh_resumes_the_reference_mesh_run(self, env):
        got = env["world"]["loop-ref-resumed"][0]["runs"][0]
        ref_s = env["ref_state"]
        assert got["step"] == int(ref_s.step)
        for k, v in got["params"].items():
            np.testing.assert_array_equal(
                v, np.asarray(jax.device_get(ref_s.params[k]), np.float32))

    def test_oversized_mesh_falls_back(self, env, tmp_path, caplog):
        r = _loop_recipe(env["data"], (64, 1), epochs=1)
        with _train_warnings(caplog):
            state, _ = pipeline.train_from_dir(r, env["data"],
                                               str(tmp_path / "o"),
                                               device="cpu")
        assert state.step > 0
        assert "mesh (64, 1) needs 64 devices, have 1; running " \
               "single-device" in caplog.text

    def test_amazon_home_kitchen_trains_on_one_process(self, env, tmp_path,
                                                       caplog):
        """The (8, 1) mesh recipe at a cut size: one process, the
        reference's fallback warning, a finite loss."""
        r = recipes.amazon_home_kitchen()
        ds = InstanceDataset(env["data"])
        r = dataclasses.replace(
            r, model=r.model.replace(vocab_size=ds.meta["vocab_size"],
                                     num_entities=8, word_dim=16,
                                     entity_dim=16, num_negatives=16),
            train=dataclasses.replace(r.train, batch_size=16, num_epochs=1,
                                      steps_per_call=1, log_every_steps=0))
        assert r.train.mesh_shape == (8, 1)
        with _train_warnings(caplog):
            state, _ = pipeline.train_from_dir(r, env["data"],
                                               str(tmp_path / "ahk"),
                                               device="cpu")
        assert state.step > 0
        assert "needs 8 devices, have 1" in caplog.text
        assert all(torch.isfinite(v).all() for v in state.params.values())


class TestFeeds:
    def test_per_process_feed_matches_replicated(self, env):
        runs = env["world"]["feed"]
        for r in runs:
            pp, rep = r["per_process"], r["replicated"]
            assert len(pp["losses"]) == 4
            np.testing.assert_allclose(pp["losses"], rep["losses"],
                                       rtol=1e-6)
            for k in pp["params"]:
                np.testing.assert_allclose(pp["params"][k],
                                           rep["params"][k], rtol=1e-6,
                                           atol=1e-7, err_msg=k)
        for r in runs[1:]:
            assert r["per_process"]["losses"] == \
                runs[0]["per_process"]["losses"]

    def test_per_process_feed_matches_single_process(self, env):
        """The same composition fed to the one-device step
        (iter_global_batches in one process) gives the mesh's losses."""
        ds = InstanceDataset(env["data"], seed=0)
        cfg = env["feed_cfg"]
        state = init_state(TCFG.seed, cfg, TCFG, sparse_override=False)
        step = make_train_step(cfg, TCFG)
        losses = []
        it = ds.iter_global_batches(8, epoch=0, num_readers=2)
        for _, (batch, _c) in zip(range(4), it):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                    batch.items()})
            losses.append(float(m["loss"]))
        got = env["world"]["feed"][0]["per_process"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
