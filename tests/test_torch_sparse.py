"""Parity of the port's row-sparse lazy step (sert_tpu_torch.train.sparse)
with the JAX reference's (sert_tpu.train.sparse) on the CPU, on the same
numpy inputs: the mirrors of tests/test_train_sparse.py, each run against
the reference's ``make_sparse_train_step`` and not against the port
itself, then the lazy step against the port's dense step, checkpoints
across the packages, the resume pin and ``load_scorer``.

Negatives are injected, never drawn: ``sample_negatives`` is replaced in
both packages' model modules (which both steps call through), returning
the same numpy draws in call order.

Tolerances, with their reasons:
- fp32: params and moments atol 1e-6 / rtol 1e-5 (the same arithmetic,
  reassociated); adam's params over several steps also atol 2e-3 x lr:
  adam's update is lr-sized whatever the gradient's size, and where a
  gradient element is a cancellation residual within a few tens of adam's
  eps, reassociation moves it by percents and the update by a few parts
  in a thousand of lr; losses and gradient norms rtol 1e-5;
- bf16 params: one bf16 step of each leaf, 2^-8 x its max |value| (both
  round the same values at the same places; an fp32 sum in another order
  can land one step apart), losses rtol 1e-5;
- the lazy step against the port's dense step: atol 1e-6 / rtol 1e-5 (the
  dense step scatter-adds the same gradients in another order);
- two runs of the port, and checkpoint round trips: bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu.models import lse as ref_lse  # noqa: E402
from sert_tpu.train import checkpoint as ref_ckpt  # noqa: E402
from sert_tpu.train import sparse as ref_sparse  # noqa: E402
from sert_tpu.train import step as ref_step  # noqa: E402
from sert_tpu.utils.config import ModelConfig, TrainConfig  # noqa: E402
from sert_tpu_torch import pipeline, recipes  # noqa: E402
from sert_tpu_torch.models import lse  # noqa: E402
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sert_tpu_torch.train import sparse  # noqa: E402
from sert_tpu_torch.train import step as port_step  # noqa: E402
from sert_tpu_torch.train.loop import _group_batches, train  # noqa: E402
from sert_tpu_torch.utils.config import RecipeConfig  # noqa: E402

V, E, DW, DE, B, W, K = 97, 53, 12, 10, 16, 5, 7
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfg(objective="sampled_softmax", pdt="float32", **kw):
    return ModelConfig(model="lse", vocab_size=V, num_entities=E,
                       word_dim=DW, entity_dim=DE, objective=objective,
                       num_negatives=K, param_dtype=pdt,
                       compute_dtype=("bfloat16" if pdt == "bfloat16"
                                      else "float32"),
                       negative_distribution="unigram", **kw)


def _tcfg(**kw):
    kw.setdefault("batch_size", B)
    kw.setdefault("donate_state", False)
    kw.setdefault("learning_rate", 0.05)
    return TrainConfig(**kw)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"word_emb": rng.normal(size=(V, DW)).astype(np.float32) / 2,
            "proj_w": rng.normal(size=(DW, DE)).astype(np.float32) / 2,
            "proj_b": rng.normal(size=(DE,)).astype(np.float32) / 4,
            "entity_emb": rng.normal(size=(E, DE)).astype(np.float32) / 2}


def _batches(n, seed=0, objective="sampled_softmax"):
    """n batches and, for each, its negatives ([1, k] shared, or [B, k]
    for NCE) with three accidental hits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"windows": rng.integers(0, V, size=(B, W)).astype(np.int32),
             "lengths": rng.integers(1, W + 1, size=B).astype(np.int32),
             "entities": rng.integers(0, E, size=B).astype(np.int32)}
        negs = rng.integers(0, E, size=(B if objective == "nce" else 1, K)
                            ).astype(np.int32)
        negs.reshape(-1)[:3] = b["entities"][:3]
        out.append((b, negs))
    return out


def _counts():
    return np.random.default_rng(5).integers(1, 20, size=E)


def _inject(monkeypatch, negs):
    """Both packages' sample_negatives return ``negs`` in call order."""
    it_ref, it_port = iter(list(negs)), iter(list(negs))
    monkeypatch.setattr(
        ref_lse, "sample_negatives",
        lambda rng, noise, n, cfg: jnp.asarray(next(it_ref)).reshape(n, -1))
    monkeypatch.setattr(
        lse, "sample_negatives",
        lambda gen, noise, n, cfg: torch.from_numpy(
            next(it_port)).long().reshape(n, -1))


def _states(mcfg, tcfg, p=None):
    """(reference state, port state) with the same params."""
    p = _np_params() if p is None else p
    jdt = jnp.bfloat16 if mcfg.param_dtype == "bfloat16" else jnp.float32
    ref_s = ref_step.init_state(jax.random.key(0), mcfg, tcfg)
    ref_s = ref_s._replace(params={k: jnp.asarray(v).astype(jdt)
                                   for k, v in p.items()})
    port_s = port_step.init_state(0, mcfg, tcfg)
    pdt = getattr(torch, mcfg.param_dtype)
    port_s.params = {k: torch.from_numpy(v.copy()).to(pdt)
                     for k, v in p.items()}
    return ref_s, port_s


def _ref_arrays(state):
    """Reference params + optimizer state as {tree path: fp32 array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            (state.params, state.opt_state))[0]:
        key = jax.tree_util.keystr(path)
        key = (".params" + key[3:] if key.startswith("[0]")
               else ".opt_state" + key[3:])
        out[key] = np.asarray(leaf).astype(np.float32)
    return out


def _port_arrays(state):
    out = {f".params['{k}']": v.float().numpy()
           for k, v in state.params.items()}
    for k, v in state.opt_state.items():
        out[".opt_state" + k] = (np.asarray(v, np.float32)
                                 if isinstance(v, int) else v.float().numpy())
    return out


def _assert_states_close(port_s, ref_s, bf16, msg="", adam_lr=None):
    """``adam_lr``: the lr of an adam run (see the module docstring)."""
    want, got = _ref_arrays(ref_s), _port_arrays(port_s)
    assert set(got) == set(want), set(got) ^ set(want)
    for key, arr in want.items():
        if bf16:
            step = 2.0 ** -8 * float(np.abs(arr).max())
            np.testing.assert_allclose(got[key], arr, rtol=0, atol=step,
                                       err_msg=f"{msg} {key}")
        else:
            tol = dict(F32_TOL)
            if adam_lr and key.startswith(".params"):
                tol["atol"] = max(tol["atol"], 2e-3 * adam_lr)
            np.testing.assert_allclose(got[key], arr, **tol,
                                       err_msg=f"{msg} {key}")


def _run_both(monkeypatch, mcfg, tcfg, steps, p=None):
    """``steps`` [(batch, negatives)] through the reference's lazy step and
    the port's; the losses and norms compared each step. Returns the final
    (reference state, port state)."""
    _inject(monkeypatch, [n for _, n in steps])
    ref_s, port_s = _states(mcfg, tcfg, p)
    ref_fn = ref_step.make_train_step(
        mcfg, tcfg, noise=ref_lse.noise_logits(_counts(), mcfg), jit=False)
    port_fn = port_step.make_train_step(
        mcfg, tcfg, noise=lse.noise_logits(_counts(), mcfg))
    for i, (b, _) in enumerate(steps):
        ref_s, ref_m = ref_fn(ref_s, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        port_s, port_m = port_fn(port_s, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        assert port_s.step == int(ref_s.step) == i + 1
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(port_m[m].item(), float(ref_m[m]),
                                       rtol=1e-5, err_msg=f"step {i} {m}")
    return ref_s, port_s


# --- gating -----------------------------------------------------------------

_GRID = [
    (_cfg(), _tcfg()),
    (_cfg(), _tcfg(optimizer="adagrad")),
    (_cfg(), _tcfg(optimizer="sgd")),
    (_cfg(), _tcfg(sparse_update="on")),
    (_cfg("nce"), _tcfg(optimizer="adagrad")),
    (_cfg(), _tcfg(sparse_update="off")),
    (_cfg(), _tcfg(optimizer="adafactor")),
    (_cfg(), _tcfg(weight_decay=0.01)),
    (_cfg(), _tcfg(mesh_shape=(2, 4))),
    (ModelConfig(model="loglinear", vocab_size=V, num_entities=E), _tcfg()),
    (_cfg().replace(model="lse_full"), _tcfg(optimizer="adagrad")),
    (_cfg(), _tcfg(grad_clip_norm=0.0, mesh_shape=(1, 8))),
]


@pytest.mark.parametrize("i", range(len(_GRID)))
def test_gating_matches_reference(i):
    mcfg, tcfg = _GRID[i]
    assert (sparse.sparse_applicable(mcfg, tcfg)
            == ref_sparse.sparse_applicable(mcfg, tcfg))
    assert (sparse.sparse_enabled(mcfg, tcfg)
            == ref_sparse.sparse_enabled(mcfg, tcfg))


def test_auto_enables_exactly_adagrad_and_sgd():
    assert not sparse.sparse_enabled(_cfg(), _tcfg())            # adam
    assert sparse.sparse_enabled(_cfg(), _tcfg(optimizer="adagrad"))
    assert sparse.sparse_enabled(_cfg("nce"), _tcfg(optimizer="sgd"))
    assert sparse.sparse_enabled(_cfg(), _tcfg(sparse_update="on"))


@pytest.mark.parametrize("tcfg", [_tcfg(optimizer="adafactor",
                                        sparse_update="on"),
                                  _tcfg(weight_decay=0.01,
                                        sparse_update="on")])
def test_on_rejects_inapplicable(tcfg):
    for fn in (sparse.sparse_enabled, ref_sparse.sparse_enabled):
        with pytest.raises(ValueError, match="sparse_update"):
            fn(_cfg(), tcfg)
    with pytest.raises(ValueError, match="sparse_update"):
        port_step.make_train_step(_cfg(), tcfg)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="sparse_update"):
        sparse.sparse_enabled(_cfg(), _tcfg(sparse_update="maybe"))


# --- the pieces alone -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,rows", [(1, 5), (40, 3), (400, 30), (64, 1000)])
def test_dedup_rows_matches_reference(n, rows, dtype):
    rng = np.random.default_rng(n + rows)
    ids = rng.integers(0, rows, size=n).astype(np.int32)
    g = rng.normal(size=(n, 6)).astype(np.float32)
    ref_ids, ref_g = ref_sparse._dedup_rows(
        jnp.asarray(ids), jnp.asarray(g).astype(dtype), rows)
    ids_u, g_u, valid = sparse._dedup_rows(
        torch.from_numpy(ids), torch.from_numpy(g).to(getattr(torch, dtype)))
    nu = len(np.unique(ids))
    assert valid.tolist() == [True] * nu + [False] * (n - nu)
    assert g_u.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ids_u[:nu].numpy(), np.asarray(ref_ids)[:nu])
    # Both add each segment's rows in slot order, in the gradient's dtype.
    np.testing.assert_array_equal(g_u[:nu].float().numpy(),
                                  np.asarray(ref_g).astype(np.float32)[:nu])
    assert not g_u[nu:].any()
    assert (ids_u[nu:] == ids_u[0]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adam", "adagrad", "sgd"])
def test_row_update_matches_reference(optimizer, dtype):
    rng = np.random.default_rng(7)
    rows, d, n = 20, 6, 30
    tcfg = _tcfg(optimizer=optimizer)
    p = rng.normal(size=(rows, d)).astype(np.float32)
    st = {name: (rng.random((rows, d)) * 0.1).astype(np.float32)
          for name in sparse._ROW_STATE[optimizer]}
    ids = rng.integers(0, rows, size=n).astype(np.int32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_ids, ref_g = ref_sparse._dedup_rows(jnp.asarray(ids),
                                            jnp.asarray(g).astype(jdt), rows)
    ref_p, ref_st = ref_sparse._row_update(
        tcfg, jnp.asarray(p).astype(jdt),
        {k: jnp.asarray(v).astype(jdt) for k, v in st.items()},
        ref_ids, ref_g, 0.05, jnp.asarray(3, jnp.int32))
    tp = torch.from_numpy(p).to(tdt)
    tst = {k: torch.from_numpy(v).to(tdt) for k, v in st.items()}
    sparse._row_update(tcfg, tp, tst, *sparse._dedup_rows(
        torch.from_numpy(ids), torch.from_numpy(g).to(tdt)), 0.05, 3)
    for got, want in [(tp, ref_p)] + [(tst[k], ref_st[k]) for k in st]:
        want = np.asarray(want).astype(np.float32)
        if dtype == "bfloat16":
            np.testing.assert_allclose(
                got.float().numpy(), want, rtol=0,
                atol=2.0 ** -8 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    untouched = sorted(set(range(rows)) - set(ids.tolist()))
    assert torch.equal(tp[untouched], torch.from_numpy(p).to(tdt)[untouched])


# --- the step against the reference's ----------------------------------------

@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adam", "adagrad", "sgd"])
@pytest.mark.parametrize("objective", ["nce", "sampled_softmax"])
def test_three_steps_match_reference(monkeypatch, objective, optimizer, pdt):
    """With a cosine schedule and global-norm clipping that binds."""
    mcfg = _cfg(objective, pdt)
    tcfg = _tcfg(optimizer=optimizer, sparse_update="on",
                 lr_schedule="cosine", lr_decay_steps=10,
                 grad_clip_norm=1.0)
    ref_s, port_s = _run_both(monkeypatch, mcfg, tcfg,
                              _batches(3, objective=objective))
    _assert_states_close(port_s, ref_s, pdt == "bfloat16",
                         adam_lr=tcfg.learning_rate * (optimizer == "adam"))
    assert all(v.dtype == getattr(torch, pdt) for v in
               port_s.opt_state.values() if torch.is_tensor(v)
               and v.dim() == 2)


def test_adagrad_knobs_parity_and_effect(monkeypatch):
    mcfg = _cfg()
    knobs = dict(optimizer="adagrad", adagrad_init_accumulator=1.0,
                 adagrad_eps=1e-4)
    steps = _batches(4, seed=3)
    ref_s, port_s = _run_both(monkeypatch, mcfg, _tcfg(**knobs), steps)
    _assert_states_close(port_s, ref_s, False)
    _, default = _run_both(monkeypatch, mcfg, _tcfg(optimizer="adagrad"),
                           steps)
    assert max((default.params[k] - port_s.params[k]).abs().max().item()
               for k in port_s.params) > 1e-5, "the knobs changed nothing"


def test_steps_per_call_matches_reference_steps(monkeypatch):
    mcfg = _cfg()
    tcfg = _tcfg(optimizer="adam", sparse_update="on")
    steps = _batches(4, seed=4)
    ref_s, _ = _run_both(monkeypatch, mcfg, tcfg, steps)
    _inject(monkeypatch, [n for _, n in steps])
    _, port_s = _states(mcfg, tcfg)
    fn = port_step.make_train_step(
        mcfg, dataclasses.replace(tcfg, steps_per_call=4),
        noise=lse.noise_logits(_counts(), mcfg))
    (stacked, _), = _group_batches(((b, None) for b, _ in steps), 4)
    port_s, _ = fn(port_s, {k: torch.from_numpy(v)
                            for k, v in stacked.items()})
    assert port_s.step == 4
    _assert_states_close(port_s, ref_s, False, adam_lr=tcfg.learning_rate)


# --- the lazy step against the port's dense step -----------------------------

def _port_run(mcfg, tcfg, batches, seed=0):
    """The port's step (as the config resolves it) over ``batches``, its
    negatives drawn from the state's generator."""
    state = port_step.init_state(seed, mcfg, tcfg)
    fn = port_step.make_train_step(mcfg, tcfg,
                                   noise=lse.noise_logits(_counts(), mcfg))
    losses = []
    for b in batches:
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(m["loss"].item())
    return state, losses


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
@pytest.mark.parametrize("objective", ["nce", "sampled_softmax"])
def test_lazy_equals_dense_for_adagrad_and_sgd(objective, optimizer):
    mcfg = _cfg(objective)
    batches = [b for b, _ in _batches(6, seed=5)]
    lazy, l_lazy = _port_run(mcfg, _tcfg(optimizer=optimizer), batches)
    dense, l_dense = _port_run(
        mcfg, _tcfg(optimizer=optimizer, sparse_update="off"), batches)
    assert any(k.startswith("['rows']") for k in lazy.opt_state) or \
        optimizer == "sgd"
    np.testing.assert_allclose(l_lazy, l_dense, rtol=1e-5)
    for k in dense.params:
        np.testing.assert_allclose(lazy.params[k].numpy(),
                                   dense.params[k].numpy(), **F32_TOL,
                                   err_msg=k)


def test_lazy_adam_equals_dense_where_every_row_is_touched():
    """Dense adam moves rows with a zero gradient (its moments decay), lazy
    adam does not; with every row touched every step they are one
    recursion."""
    V2, E2 = 40, 8                      # B * W = 80 >= V2, B = 16 >= E2
    mcfg = _cfg().replace(vocab_size=V2, num_entities=E2)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(4):
        windows = rng.integers(0, V2, size=(B, W)).astype(np.int32)
        windows.reshape(-1)[:V2] = np.arange(V2)
        batches.append({
            "windows": windows, "lengths": np.full(B, W, np.int32),
            "entities": np.concatenate([np.arange(E2), rng.integers(
                0, E2, size=B - E2)]).astype(np.int32)})

    def run(tcfg):
        state = port_step.init_state(0, mcfg, tcfg)
        fn = port_step.make_train_step(mcfg, tcfg)
        for b in batches:
            state, _ = fn(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        return state

    lazy = run(_tcfg(optimizer="adam", sparse_update="on"))
    dense = run(_tcfg(optimizer="adam", sparse_update="off"))
    for k in dense.params:
        np.testing.assert_allclose(lazy.params[k].numpy(),
                                   dense.params[k].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)


def test_two_lazy_runs_are_bit_equal_and_untouched_rows_stay():
    mcfg = _cfg(pdt="bfloat16")
    tcfg = _tcfg(optimizer="adam", sparse_update="on")
    batches = [b for b, _ in _batches(3, seed=6)]
    init = port_step.init_state(0, mcfg, tcfg).params["entity_emb"].clone()
    a, la = _port_run(mcfg, tcfg, batches)
    b, lb = _port_run(mcfg, tcfg, batches)
    assert la == lb
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for k, v in a.opt_state.items():
        assert (torch.equal(v, b.opt_state[k]) if torch.is_tensor(v)
                else v == b.opt_state[k]), k
    moved = (a.params["entity_emb"] != init).any(dim=1)
    touched = a.opt_state["['rows']['entity_emb']['m']"].any(dim=1)
    assert moved.any() and not (moved & ~touched).any()


# --- checkpoints -------------------------------------------------------------

@pytest.mark.parametrize("optimizer,pdt", [("adam", "float32"),
                                           ("adagrad", "bfloat16")])
def test_sparse_checkpoints_cross_load_and_continue(tmp_path, monkeypatch,
                                                    optimizer, pdt):
    """Two lazy steps in each package; each one's full checkpoint loads in
    the other bit for bit and takes a third step there that matches the
    third step in the package that wrote it."""
    mcfg = _cfg(pdt=pdt)
    tcfg = _tcfg(optimizer=optimizer, sparse_update="on",
                 lr_schedule="cosine", lr_decay_steps=10)
    steps = _batches(3, seed=8)
    ref_s, port_s = _run_both(monkeypatch, mcfg, tcfg, steps[:2])
    bf16 = pdt == "bfloat16"
    b3 = steps[2][0]
    ref_fn = ref_step.make_train_step(
        mcfg, tcfg, noise=ref_lse.noise_logits(_counts(), mcfg), jit=False)
    port_fn = port_step.make_train_step(
        mcfg, tcfg, noise=lse.noise_logits(_counts(), mcfg))

    p_path = ckpt.save_checkpoint(str(tmp_path / "p"), 2, port_s,
                                  {"epoch": 0})
    r_path = ref_ckpt.save_checkpoint(str(tmp_path / "r"), 2, ref_s)
    for path in (p_path, r_path):
        assert ckpt.has_sparse_opt_state(path)
        assert ref_ckpt.has_sparse_opt_state(path)
    in_ref, _ = ref_ckpt.load_checkpoint(
        p_path, ref_step.init_state(jax.random.key(1), mcfg, tcfg))
    # The reference's loader returns host arrays; its unjitted step wants
    # device arrays.
    in_ref = jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, in_ref)
    in_port, _ = ckpt.load_checkpoint(
        r_path, port_step.init_state(9, mcfg, tcfg))
    want, got = _port_arrays(port_s), _ref_arrays(in_ref)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    want, got = _ref_arrays(ref_s), _port_arrays(in_port)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    # The third step: each package on the other's file, and on its own.
    _inject(monkeypatch, [steps[2][1]] * 2)
    tb = {k: torch.from_numpy(v) for k, v in b3.items()}
    jb = {k: jnp.asarray(v) for k, v in b3.items()}
    in_ref, _ = ref_fn(in_ref, jb)
    port_s, _ = port_fn(port_s, tb)
    adam_lr = tcfg.learning_rate * (optimizer == "adam")
    _assert_states_close(port_s, in_ref, bf16, "port file in reference",
                         adam_lr)
    _inject(monkeypatch, [steps[2][1]] * 2)
    ref_s, _ = ref_fn(ref_s, jb)
    in_port, _ = port_fn(in_port, tb)
    _assert_states_close(in_port, ref_s, bf16, "reference file in port",
                         adam_lr)


def test_flavor_detection_and_override(tmp_path):
    mcfg = _cfg()
    dense = port_step.init_state(0, mcfg, _tcfg(optimizer="adagrad",
                                                sparse_update="off"))
    lazy = port_step.init_state(0, mcfg, _tcfg(optimizer="adagrad"))
    assert not any(k.startswith("['") for k in dense.opt_state)
    assert set(lazy.opt_state) == {
        "['dense'][0].sum_of_squares['proj_b']",
        "['dense'][0].sum_of_squares['proj_w']",
        "['rows']['entity_emb']['acc']", "['rows']['word_emb']['acc']"}
    p_dense = ckpt.save_checkpoint(str(tmp_path / "d"), 1, dense)
    p_lazy = ckpt.save_checkpoint(str(tmp_path / "s"), 1, lazy)
    assert not ckpt.has_sparse_opt_state(p_dense)
    assert ckpt.has_sparse_opt_state(p_lazy)

    # A dense file under a config that resolves to the lazy step: the
    # template must follow the file.
    tc_auto = _tcfg(optimizer="adagrad")
    with pytest.raises(KeyError):
        ckpt.load_checkpoint(p_dense, port_step.init_state(1, mcfg, tc_auto))
    tmpl = port_step.init_state(1, mcfg, tc_auto, sparse_override=False)
    back, _ = ckpt.load_checkpoint(p_dense, tmpl)
    for k in dense.params:
        assert torch.equal(back.params[k], dense.params[k])
    released = port_step.release_opt_state(lazy)
    assert released.opt_state == {} and lazy.opt_state


def _prepared(tmp_path, **model_kw):
    """The tiny LSE recipe and its prepared data; batches of 1024 give 14
    micro-steps an epoch, which keeps the loop tests short."""
    recipe = recipes.tiny_recipe("lse", **model_kw)
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, batch_size=1024))
    data = str(tmp_path / "data")
    pipeline.prepare_collection(recipes.tiny_spec(seed=1).build(), data,
                                recipe)
    return recipe, data


def _with_train(recipe, **kw):
    return dataclasses.replace(recipe,
                               train=dataclasses.replace(recipe.train, **kw))


def test_resume_pins_the_flavor_to_the_checkpoint(tmp_path):
    """A run checkpointed dense, resumed under a config that now resolves
    to the lazy step, continues dense; and the reverse."""
    recipe, data = _prepared(tmp_path)
    off = _with_train(recipe, optimizer="adagrad", sparse_update="off",
                      num_epochs=1)
    run = str(tmp_path / "run")
    pipeline.train_from_dir(off, data, run, device="cpu")
    auto = _with_train(off, sparse_update="auto", num_epochs=2)
    final, _ = pipeline.train_from_dir(auto, data, run, device="cpu")
    assert not any(k.startswith("['") for k in final.opt_state)

    on = _with_train(recipe, optimizer="adam", sparse_update="on",
                     num_epochs=1)
    run2 = str(tmp_path / "run2")
    pipeline.train_from_dir(on, data, run2, device="cpu")
    resumed, _ = pipeline.train_from_dir(
        _with_train(on, sparse_update="auto", num_epochs=2), data, run2,
        device="cpu")
    assert "['rows']['entity_emb']['m']" in resumed.opt_state


def test_resume_of_a_sparse_checkpoint_under_an_inapplicable_config_raises(
        tmp_path):
    mcfg = _cfg()
    state = port_step.init_state(0, mcfg, _tcfg(optimizer="adagrad"))
    ckpt.save_checkpoint(str(tmp_path / "run" / "checkpoints"), 1, state)
    bad = RecipeConfig(name="t", model=mcfg,
                       train=_tcfg(optimizer="adafactor"))
    with pytest.raises(ValueError, match="row-sparse optimizer state"):
        train(bad, dataset=None, out_dir=str(tmp_path / "run"),
              device="cpu")


def test_resume_of_the_lazy_step_is_exact(tmp_path):
    recipe, data = _prepared(tmp_path, objective="sampled_softmax",
                             negative_distribution="unigram")
    r = _with_train(recipe, sparse_update="on", num_epochs=2,
                    checkpoint_every_steps=4, lr_schedule="cosine",
                    steps_per_call=2)
    run = str(tmp_path / "run")
    s_all, _ = pipeline.train_from_dir(r, data, run, device="cpu")
    cdir = os.path.join(run, "checkpoints")
    saved = ckpt.list_checkpoints(cdir)
    mid = min(s for s, p in saved.items() if ckpt.load_meta(p)["cursor"])
    for s, path in saved.items():
        if s > mid:                      # a crash right after the save
            os.remove(path)
            os.remove(path[:-4] + ".json")
    s_res, _ = pipeline.train_from_dir(r, data, run, device="cpu")
    assert s_res.step == s_all.step > mid
    for k in s_all.params:
        assert torch.equal(s_all.params[k], s_res.params[k]), k
    for k, v in s_all.opt_state.items():
        assert (torch.equal(v, s_res.opt_state[k]) if torch.is_tensor(v)
                else v == s_res.opt_state[k]), k
    assert torch.equal(s_all.generator.get_state(),
                       s_res.generator.get_state())


def test_load_scorer_takes_a_sparse_checkpoint(tmp_path):
    recipe, data = _prepared(tmp_path)
    r = _with_train(recipe, sparse_update="on", num_epochs=1)
    run = str(tmp_path / "run")
    state, resolved = pipeline.train_from_dir(r, data, run, device="cpu")
    path = ckpt.latest_checkpoint(os.path.join(run, "checkpoints"))
    assert ckpt.has_sparse_opt_state(path)
    params, _, _ = pipeline.load_scorer(run, data, resolved, device="cpu")
    ref_params, _, _ = ref_pipeline.load_scorer(run, data, resolved)
    for k, v in state.params.items():
        assert torch.equal(params[k], v), k
        np.testing.assert_array_equal(np.asarray(ref_params[k]), v.numpy())
