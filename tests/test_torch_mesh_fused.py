"""The port's pure-TP fused-update step (sert_tpu_torch.train.fused with a
mesh, ops.xent.sharded_xent_apply: K5 and K7 per entity block, their plain
versions on the CPU) on gloo worlds of CPU ranks, held against the
reference's make_sharded_train_step(fused_update="on") on the conftest's
fake CPU devices and against the port's own dense sharded step, on the
same numpy inputs; its gates against the reference's; the loop on a
(1, 4) mesh with it; and make_sharded_train_step's route at mesh (1, 1),
where "on" takes the one-card step as the reference's does.
Counterpart of tests/test_parallel_fused.py:193-281.

Two worlds run every port case, started together: 8 ranks for the (1, 8)
mesh and 4 for the (1, 4) one (a mesh holds every rank of its world).
JAX and the reference are imported inside the helpers that use them, so
that the ``gpu`` test runs on a host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_mesh_fused.py

Tolerances, the reference's (tests/test_parallel_fused.py:246-266): after
3 steps at lr 0.05, params rtol = atol = 1e-7 for sgd (reassociation),
1e-6 adagrad, 1e-4 adam (which amplifies reassociation where v ~ 0), the
loss rtol 1e-5 and the grad norm rtol 1e-4; lse_full adam 1e-4. The
checkpoint round trips are bit for bit.
"""

import concurrent.futures
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu_torch.data.assoc import (Associations,  # noqa: E402
                                       EntityRegistry)
from sert_tpu_torch.data.instances import InstanceDataset  # noqa: E402
from sert_tpu_torch.data.prepare import prepare  # noqa: E402
from sert_tpu_torch.data.synthetic import make_synthetic  # noqa: E402
from sert_tpu_torch.ops import xent  # noqa: E402
from sert_tpu_torch.parallel import dryrun  # noqa: E402
from sert_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from sert_tpu_torch.parallel.train import (  # noqa: E402
    make_sharded_train_step)
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sert_tpu_torch.train import fused, sparse  # noqa: E402
from sert_tpu_torch.train.step import init_state  # noqa: E402
from sert_tpu_torch.utils.config import (DataConfig, ModelConfig,  # noqa: E402
                                         RecipeConfig, TrainConfig)

V, E, D128, STEPS = 50, 64, 128, 3
TOL = {"sgd": 1e-7, "adagrad": 1e-6, "adam": 1e-4}
LSE_FULL_TOL = 1e-4


def _cfg(model):
    return ModelConfig(model=model, vocab_size=V, num_entities=E,
                       word_dim=D128 if model == "loglinear" else 64,
                       entity_dim=D128, fused_softmax="off")


def _tcfg(opt, mesh_shape, fu):
    return TrainConfig(batch_size=16, learning_rate=0.05, optimizer=opt,
                       mesh_shape=mesh_shape, fused_update=fu,
                       sparse_update="off")


def _batch(seed, w=5):
    rng = np.random.default_rng(seed)
    return {"windows": rng.integers(0, V, (16, w)).astype(np.int32),
            "lengths": np.full(16, w, np.int32),
            "entities": rng.integers(0, E, 16).astype(np.int32)}


BATCHES = [_batch(i) for i in range(STEPS)]
# (world, family, optimizer, fused_update): the port's step cases.
STEP_CASES = ([(8, "loglinear", o, fu) for o in TOL for fu in ("on", "off")]
              + [(4, "lse_full", "adam", fu) for fu in ("on", "off")])


def _mesh_of(world):
    return (1, world)


# ops.xent.sharded_xent_apply at (1, 8), both layouts: the layout,
# optimizer, B and E of each case (tests/test_torch_fused.py's K7 inputs).
APPLY_CASES = [("de", "adam", 64, 512), ("ed", "adagrad", 48, 256)]
APPLY_LR = 1e-2


def _apply_inputs(layout, opt, B, E, seed=0):
    rng = np.random.default_rng(seed)
    pooled = (0.5 * rng.normal(size=(B, D128))).astype(np.float32)
    Wde = (rng.normal(size=(D128, E)) * 2.0 / D128 ** 0.5).astype(np.float32)
    slots = {"m": 1e-3 * rng.normal(size=Wde.shape),
             "v": 1e-5 * np.abs(rng.normal(size=Wde.shape)),
             "acc": 1e-5 * np.abs(rng.normal(size=Wde.shape))}
    lay = (lambda x: x) if layout == "de" else (
        lambda x: np.ascontiguousarray(x.T))
    return dict(
        pooled=pooled, W=lay(Wde),
        b=(0.1 * rng.normal(size=E)).astype(np.float32),
        labels=rng.integers(0, E, size=B).astype(np.int64),
        slots={k: lay(slots[k].astype(np.float32))
               for k in xent.SLOTS[opt]},
        kw=dict(opt=opt, lr=APPLY_LR, count=3, gscale=1.0 / B,
                layout=layout, dtype="float32"))


# --- the reference's side (jax imported here) ------------------------------

def _ref_cfgs(cfg, tcfg):
    from sert_tpu.utils import config as rc
    return (rc.ModelConfig(**dataclasses.asdict(cfg)),
            rc.TrainConfig(**{**dataclasses.asdict(tcfg),
                              "mesh_shape": tuple(tcfg.mesh_shape),
                              "donate_state": False}))


def _ref_params(cfg, tcfg):
    import jax
    from sert_tpu.train import step as ref_step
    state = ref_step.init_state(jax.random.key(tcfg.seed),
                                *_ref_cfgs(cfg, tcfg))
    return {k: np.asarray(v, np.float32) for k, v in state.params.items()}


def _ref_sharded(cfg, tcfg):
    """The reference's sharded step over BATCHES on the fake devices:
    (params, slots as the port names them, last loss, last grad norm)."""
    import jax
    from sert_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from sert_tpu.parallel.train import make_sharded_train_step as ref_step
    rcfg, rtcfg = _ref_cfgs(cfg, tcfg)
    step, init_fn, put_fn = ref_step(rcfg, rtcfg,
                                     ref_make_mesh(tuple(tcfg.mesh_shape)))
    state = init_fn()
    for b in BATCHES:
        state, m = step(state, put_fn(b))
    inner = jax.device_get(state.opt_state)[0]
    slots = {}
    for attr, name in (("mu", "[0].mu"), ("nu", "[0].nu"),
                       ("sum_of_squares", "[0].sum_of_squares")):
        for k, v in getattr(inner, attr, {}).items():
            slots[f"{name}['{k}']"] = np.asarray(v, np.float32)
    return ({k: np.asarray(jax.device_get(v), np.float32)
             for k, v in state.params.items()}, slots,
            float(m["loss"]), float(m["grad_norm"]))


# --- the port's worlds -----------------------------------------------------

def _prepare(root):
    col = make_synthetic(num_entities=8, vocab_size=400, docs_per_entity=3,
                         doc_len=40, num_topics=2, seed=9)
    reg = EntityRegistry(col.entities)
    assoc = Associations()
    for d, es in col.doc_entities.items():
        for e in es:
            assoc.add(d, reg.id(e))
    ddir = str(root / "data")
    prepare(col.docs, assoc, reg, ddir,
            DataConfig(window_size=4, vocab_min_count=1,
                       instances_per_shard=256))
    return ddir


def _loop_recipe(data):
    mcfg = ModelConfig(model="loglinear",
                       vocab_size=InstanceDataset(data).meta["vocab_size"],
                       num_entities=8, word_dim=D128)
    return RecipeConfig(name="mesh_fused", model=mcfg, train=TrainConfig(
        batch_size=16, num_epochs=1, learning_rate=1e-2, log_every_steps=0,
        mesh_shape=(1, 4), fused_update="on"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Every port case, on a world of 8 ranks and one of 4."""
    root = tmp_path_factory.mktemp("mesh_fused")
    data = _prepare(root)
    jobs = {8: [], 4: []}        # (case, (function, spec)) by world size
    for case in STEP_CASES:
        world, fam, opt, fu = case
        cfg, tcfg = _cfg(fam), _tcfg(opt, _mesh_of(world), fu)
        jobs[world].append((case, ("train_steps", dict(
            mesh=_mesh_of(world), cfg=cfg, tcfg=tcfg,
            params=_ref_params(cfg, tcfg), batches=BATCHES))))
    for case in APPLY_CASES:
        jobs[8].append((case, ("xent_apply", _apply_inputs(*case))))
    # The loop at (1, 4): one epoch "on", then resumed "off" to two.
    jobs[4].append(("loop", ("train_loop", dict(
        recipe=_loop_recipe(data), data=data, out=str(root / "loop"),
        runs=[None, {"num_epochs": 2, "fused_update": "off"}]))))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(dryrun.launch, n,
                                  "sert_tpu_torch.parallel.worlds:run_jobs",
                                  [job for _, job in jobs[n]]) for n in jobs}
        out = {n: f.result() for n, f in futures.items()}
    world = {case: [r[j] for r in out[n]]
             for n in jobs for j, (case, _) in enumerate(jobs[n])}
    return dict(root=root, data=data, world=world)


def _assert_close(got, want, tol, msg=""):
    assert set(got) == set(want), msg
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol,
                                   err_msg=f"{msg} {k}")


def _slots(opt):
    return {k: v for k, v in opt.items() if not isinstance(v, int)}


@pytest.mark.parametrize("case", APPLY_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_sharded_apply_matches_the_reference(env, case):
    """sharded_xent_apply (K5/K7's plain versions per block, stitched)
    against the reference's make_sharded_xent_apply (interpret mode) on
    the same mesh and inputs, with the single-device K7 test's tolerances
    (tests/test_torch_fused.py): the loss and gsq rtol 1e-5; db, dpooled,
    W' and the slots atol 1e-7."""
    import jax
    import jax.numpy as jnp
    from sert_tpu.ops.xent import make_sharded_xent_apply
    from sert_tpu.parallel.mesh import make_mesh as ref_make_mesh
    x = _apply_inputs(*case)
    kw = dict(x["kw"])
    count, gscale = kw.pop("count"), kw.pop("gscale")
    fn = make_sharded_xent_apply(ref_make_mesh((1, 8)), **kw)
    loss, W, slots, db, dpooled, gsq = jax.tree.map(np.asarray, fn(
        *(jnp.asarray(x[k]) for k in ("pooled", "W", "b", "labels")),
        {k: jnp.asarray(v) for k, v in x["slots"].items()},
        jnp.asarray(count, jnp.int32)))
    del gscale                    # the reference takes 1 / B itself
    runs = env["world"][case]
    for got in runs:              # every rank holds the same results
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["gsq"], float(gsq), rtol=1e-5)
        for name, want in (("db", db), ("dpooled", dpooled), ("W", W)):
            np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-7,
                                       err_msg=name)
        for k, v in slots.items():
            np.testing.assert_allclose(got["slots"][k], v, rtol=0,
                                       atol=1e-7, err_msg=k)


class TestPureTPStep:
    def test_loglinear_sgd_matches_the_reference(self, env):
        """(1, 8) sgd "on" against the reference's fused step on the same
        mesh: params 1e-7, the loss rtol 1e-5, the grad norm rtol 1e-4."""
        got = env["world"][(8, "loglinear", "sgd", "on")][0]
        params, _, loss, norm = _ref_sharded(_cfg("loglinear"),
                                             _tcfg("sgd", (1, 8), "on"))
        _assert_close(got["params"], params, TOL["sgd"], "sgd")
        np.testing.assert_allclose(got["losses"][-1], loss, rtol=1e-5)
        np.testing.assert_allclose(got["norms"][-1], norm, rtol=1e-4)

    def test_lse_full_adam_matches_the_reference(self, env):
        got = env["world"][(4, "lse_full", "adam", "on")][0]
        params, slots, loss, norm = _ref_sharded(
            _cfg("lse_full"), _tcfg("adam", (1, 4), "on"))
        _assert_close(got["params"], params, LSE_FULL_TOL, "lse_full")
        _assert_close(_slots(got["opt"]), slots, LSE_FULL_TOL, "lse_full")
        np.testing.assert_allclose(got["losses"][-1], loss, rtol=1e-5)
        np.testing.assert_allclose(got["norms"][-1], norm, rtol=1e-4)

    @pytest.mark.slow
    @pytest.mark.parametrize("opt", ["adam", "adagrad"])
    def test_loglinear_matches_the_reference(self, env, opt):
        got = env["world"][(8, "loglinear", opt, "on")][0]
        params, slots, loss, norm = _ref_sharded(_cfg("loglinear"),
                                                 _tcfg(opt, (1, 8), "on"))
        _assert_close(got["params"], params, TOL[opt], opt)
        _assert_close(_slots(got["opt"]), slots, TOL[opt], opt)
        np.testing.assert_allclose(got["losses"][-1], loss, rtol=1e-5)
        np.testing.assert_allclose(got["norms"][-1], norm, rtol=1e-4)

    @pytest.mark.parametrize("world,fam,opt", [
        (8, "loglinear", o) for o in TOL] + [(4, "lse_full", "adam")])
    def test_matches_the_dense_sharded_step(self, env, world, fam, opt):
        """"on" against "off" on the same mesh (the dense step, K5/K6's
        plain versions per block): params, slots, every step's loss and
        grad norm."""
        on = env["world"][(world, fam, opt, "on")][0]
        off = env["world"][(world, fam, opt, "off")][0]
        tol = TOL[opt] if fam == "loglinear" else LSE_FULL_TOL
        _assert_close(on["params"], off["params"], tol, opt)
        _assert_close(_slots(on["opt"]), _slots(off["opt"]), tol, opt)
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
        np.testing.assert_allclose(on["norms"], off["norms"], rtol=1e-4)

    @pytest.mark.parametrize("case", STEP_CASES[::2],
                             ids=lambda c: f"{c[1]}-{c[2]}")
    def test_blocks_stay_sharded_and_metrics_alike(self, env, case):
        """Params and slots stay in blocks of E / tp on every rank (the
        entity matrix, proj_b, their moments); every rank reports the same
        global loss and grad norm; the CPU launches nothing."""
        world, fam = case[0], case[1]
        runs = env["world"][case]
        El = E // world
        mat, want = (("proj_w", (D128, El)) if fam == "loglinear"
                     else ("entity_emb", (El, D128)))
        for r in runs:
            blocks = r["blocks"]
            assert blocks[mat] == want
            for key, shape in blocks.items():
                if key.endswith(f"['{mat}']"):
                    assert shape == want, key
            if fam == "loglinear":
                assert blocks["proj_b"] == (El,)
                assert blocks["word_emb"] == (V, D128)
            assert r["losses"] == runs[0]["losses"]
            assert r["norms"] == runs[0]["norms"]
            assert not any(r["launches"].values())


_GATE_CASES = [   # tests/test_parallel_fused.py:262-281 and the one-device
    ("loglinear", {}, {}, (1, 8)),                 # table's conditions
    ("loglinear", {}, {}, (2, 4)),
    ("loglinear", {}, {}, (1, 1)),
    ("loglinear", dict(num_entities=63), {}, (1, 8)),
    ("lse", {}, {}, (1, 8)),
    ("lse_full", {}, {}, (1, 4)),
    ("loglinear", {}, dict(optimizer="adafactor"), (1, 8)),
    ("loglinear", {}, dict(weight_decay=0.01), (1, 8)),
    ("loglinear", {}, dict(grad_clip_norm=1.0), (1, 8)),
    ("loglinear", dict(word_dim=120), {}, (1, 8)),
    ("loglinear", {}, dict(optimizer="adagrad", adagrad_eps=1e-4), (1, 8)),
    ("loglinear", {}, dict(lr_schedule="cosine", lr_decay_steps=10), (1, 8)),
    ("loglinear", {}, dict(lr_warmup_steps=5), (1, 8)),
    ("loglinear", {}, dict(optimizer="sgd"), (1, 8)),
    ("loglinear", {}, dict(batch_size=1 << 15), (1, 8)),
    ("lse_full", dict(entity_dim=384), {}, (1, 4)),
]


@pytest.mark.parametrize("model,model_kw,train_kw,shape", _GATE_CASES)
def test_gates_match_the_reference(model, model_kw, train_kw, shape):
    """fused_tp_applicable and fused_tp_enabled case for case against the
    reference's: "off" and "auto" off on a mesh, "on" where applicable,
    and the reference's "pure-TP" ValueError where not."""
    from sert_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from sert_tpu.train import fused as ref_fused
    cfg = ModelConfig(model=model, vocab_size=V, **{
        "num_entities": E, "word_dim": D128, "entity_dim": D128,
        **model_kw})
    tcfg = TrainConfig(**{"batch_size": 16, "mesh_shape": shape,
                          **train_kw})
    ref = _ref_cfgs(cfg, tcfg)
    want = ref_fused.fused_tp_applicable(*ref, mesh_shape=shape)
    got = fused.fused_tp_applicable(cfg, tcfg, mesh_shape=shape)
    assert fused.fused_tp_applicable(cfg, tcfg) == got   # mesh_shape's own
    if train_kw.get("batch_size") == 1 << 15:
        # tests/test_torch_fused.py's deliberate difference: the
        # reference's TPU VMEM plan refuses B = 32768, the kernels take it.
        assert (want, got) == (False, True)
    elif model_kw.get("entity_dim") == 384:
        # and its other side: the kernels take d <= 256.
        assert (want, got) == (True, False)
    else:
        assert got == want
    mesh = types.SimpleNamespace(shape={"data": shape[0],
                                        "model": shape[1]})
    ref_mesh = ref_make_mesh(shape)
    for mode in ("off", "auto", "on"):
        t = dataclasses.replace(tcfg, fused_update=mode)
        r = dataclasses.replace(ref[1], fused_update=mode)
        if mode == "on" and not got:
            with pytest.raises(ValueError, match="pure-TP"):
                fused.fused_tp_enabled(cfg, t, mesh)
            if not want:
                with pytest.raises(ValueError, match="pure-TP"):
                    ref_fused.fused_tp_enabled(ref[0], r, ref_mesh)
            continue
        assert fused.fused_tp_enabled(cfg, t, mesh) == (mode == "on")
        if want == got:
            assert ref_fused.fused_tp_enabled(ref[0], r, ref_mesh) == \
                (mode == "on")


class TestMeshLoop:
    def test_fused_run_resumes_under_off_and_the_reference_reads_it(self,
                                                                     env):
        """The loop at (1, 4) with fused_update "on" builds the mesh's
        fused step; its checkpoint resumes under "off" (rank 0 alone
        writes, no step twice); the one-card port and the reference read
        that checkpoint bit for bit."""
        import jax
        from sert_tpu.train import checkpoint as ref_ckpt
        from sert_tpu.train import step as ref_step
        runs = env["world"]["loop"]
        for r in runs:
            first, resumed = r["runs"]
            assert (first["fused_mesh_steps"], resumed["fused_mesh_steps"]) \
                == (1, 0)
            assert resumed["step"] == 2 * first["step"] > 0
        writes = runs[0]["writes"]
        assert writes == sorted(set(writes)) and writes[-1] == \
            runs[0]["runs"][1]["step"]
        assert not any(r["writes"] for r in runs[1:])
        first = runs[0]["runs"][0]
        path = ckpt.list_checkpoints(str(env["root"] / "loop"
                                         / "checkpoints"))[first["step"]]
        recipe = _loop_recipe(env["data"])
        one = dataclasses.replace(recipe.train, mesh_shape=(1, 1))
        loaded, meta = ckpt.load_checkpoint(
            path, init_state(0, recipe.model, one))
        assert meta["step"] == first["step"]
        ref_state = ref_step.init_state(
            jax.random.key(0), *_ref_cfgs(recipe.model, one))
        ref_loaded, _ = ref_ckpt.load_checkpoint(path, ref_state)
        for k, v in first["params"].items():
            np.testing.assert_array_equal(loaded.params[k].numpy(), v)
            np.testing.assert_array_equal(np.asarray(ref_loaded.params[k]),
                                          v)
        assert int(ref_loaded.step) == first["step"]


class TestOneRankMesh:
    """make_sharded_train_step at mesh (1, 1) with "on" takes the one-card
    step, as the reference's does at size 1 (its make_train_step)."""

    def test_fused_on_is_the_one_card_fused_step(self, monkeypatch):
        cfg, tcfg = _cfg("loglinear"), _tcfg("adam", (1, 1), "on")
        calls = []
        plain = xent.xent_loss_apply_plain
        monkeypatch.setattr(xent, "xent_loss_apply_plain",
                            lambda *a, **kw: calls.append(1)
                            or plain(*a, **kw))
        step, init_fn, put_fn = make_sharded_train_step(
            cfg, tcfg, make_mesh((1, 1), device="cpu"))
        state = init_fn()
        for b in BATCHES:
            _, m = step(state, put_fn(b))
        assert len(calls) == STEPS          # K7's route, its plain version
        one = init_state(tcfg.seed, cfg, tcfg, "cpu")
        one_step = fused.make_fused_train_step(cfg, tcfg)
        for b in BATCHES:
            _, m1 = one_step(one, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        assert torch.equal(m["loss"], m1["loss"])
        assert torch.equal(m["grad_norm"], m1["grad_norm"])
        assert state.opt_state.keys() == one.opt_state.keys()
        for k, v in one.params.items():
            assert torch.equal(state.params[k], v), k
        for k, v in one.opt_state.items():
            assert (v == state.opt_state[k] if isinstance(v, int)
                    else torch.equal(v, state.opt_state[k])), k

    def test_sparse_on_is_the_lazy_step(self):
        cfg = ModelConfig(model="lse", objective="sampled_softmax",
                          vocab_size=V, num_entities=E, word_dim=8,
                          entity_dim=8, num_negatives=16)
        tcfg = TrainConfig(batch_size=16, learning_rate=1e-2,
                           sparse_update="on")
        step, init_fn, put_fn = make_sharded_train_step(
            cfg, tcfg, make_mesh((1, 1), device="cpu"))
        state = init_fn()
        one = init_state(tcfg.seed, cfg, tcfg, "cpu")
        assert state.opt_state.keys() == sparse.init_sparse_opt_state(
            one.params, tcfg).keys() == one.opt_state.keys()
        lazy = sparse.make_sparse_train_step(cfg, tcfg)
        for b in BATCHES:
            _, m = step(state, put_fn(b))
            _, m1 = lazy(one, {k: torch.from_numpy(v) for k, v in b.items()})
            assert torch.equal(m["loss"], m1["loss"])
        for k, v in one.params.items():
            assert torch.equal(state.params[k], v), k
        for k, v in one.opt_state.items():
            assert (v == state.opt_state[k] if isinstance(v, int)
                    else torch.equal(v, state.opt_state[k])), k


def _card_cfgs():
    cfg = ModelConfig(model="loglinear", vocab_size=1000,
                      num_entities=16384, word_dim=128,
                      compute_dtype="bfloat16")
    return cfg, TrainConfig(batch_size=256, learning_rate=1e-2,
                            sparse_update="off")


def test_card_world_check_on_cpu_ranks():
    """The chip phase's check (parallel.dryrun.check_fused_card_world) on
    CPU ranks at a small width, bf16 compute: for each optimizer, each
    step's change under "on" within 1e-4 of that under "off" from the same
    state, and the first within the check's bf16 limit of one rank's;
    replicas bit-equal, blocks of E / 4."""
    cfg, tcfg = _card_cfgs()
    report = dryrun.check_fused_card_world(cfg, tcfg, n=4, steps=2,
                                           device="cpu")
    assert report["ok"], report
    assert sorted(report["optimizers"]) == ["adagrad", "adam", "sgd"]


def test_card_world_check_holds_the_change():
    """The check's measure (worlds._diff_stats, dryrun._leaf_parity) on an
    sgd-sized step, which moves each element of a leaf of scale 1/16 by
    3e-7, some 50 storage steps: the step against itself, or one storage
    step from it, reads 0, a skipped update ~1 and one of the wrong sign
    ~2, where the leaf-relative norm of the difference reads ~1e-5 for
    both and would pass them."""
    from sert_tpu_torch.parallel import worlds
    g = torch.Generator().manual_seed(0)
    base = torch.randn(4096, generator=g) / 16
    want = base - 3e-7 * torch.randn(4096, generator=g).sign()

    def read(got):
        stats = [{"w": worlds._diff_stats(got, want, base)}]
        return dryrun._leaf_parity(stats, "w", False)

    same = read(want.clone())
    rounded = read(torch.nextafter(want, torch.full_like(want, 1.0)))
    skipped, flipped = read(base.clone()), read(2 * base - want)
    assert same["rel_norm"] == rounded["rel_norm"] == 0.0 and same["moved"]
    assert rounded["max_abs"] > 0 and rounded["over_one_step"] == 0
    assert skipped["rel_norm"] == pytest.approx(skipped["skipped"])
    assert 0.95 < skipped["rel_norm"] <= 1.0
    assert skipped["skipped"] >= dryrun.FUSED_TP_MIN_SKIPPED
    assert flipped["rel_norm"] == pytest.approx(2.0, rel=0.05)
    assert skipped["over_one_step"] == flipped["over_one_step"] == 4096
    for got in (base, 2 * base - want):
        assert float(torch.norm(got - want) / torch.norm(want)) < 2e-5
    unmoved = dryrun._leaf_parity(
        [{"w": worlds._diff_stats(base, base, base)}], "w", False)
    assert not unmoved["moved"]


@pytest.mark.gpu
def test_card_world_at_a_small_width():
    """The chip phase at a small width: 4 gloo ranks sharing the card at
    (1, 4), K5 and K7 once a micro-step on every rank, K6 never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run pytest -m gpu on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tcfg = _card_cfgs()
    report = dryrun.check_fused_card_world(cfg, tcfg, n=4, steps=4)
    assert report["ok"], report
