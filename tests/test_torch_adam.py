"""The dense adam update (``ops/adam.py``, ``csrc/adam.cu``): the CPU path
and the launch's wiring here, the kernel against the plain composition on
the card.

Imports nothing of JAX, so it runs on a host without it. The ``gpu`` tests
skip without a CUDA device; on the card run

    python -m pytest --noconftest -m gpu tests/test_torch_adam.py

The kernel's oracle is ``Optimizer.update``'s adam as the torch
composition stood before the kernel (``_old_update``), and the two must
agree to the bit: the kernel repeats the composition's operations in its
order, each rounded where torch rounds it.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu_torch.ops import _build, adam  # noqa: E402
from sert_tpu_torch.train.step import (Optimizer, global_norm,  # noqa: E402
                                       init_state, make_train_step)
from sert_tpu_torch.utils import profiling  # noqa: E402
from sert_tpu_torch.utils.config import ModelConfig, TrainConfig  # noqa: E402

# The flagship's leaves (synthetic_1m_retrieval: V 250k, E 1M, d 128).
FLAGSHIP = {"word_emb": (250_000, 128), "entity_emb": (1_000_000, 128),
            "proj_w": (128, 128), "proj_b": (128,)}
ODD = [(1,), (127,), (16_385,)]
FLAGSHIP_SMALL = {"word_emb": (50, 16), "entity_emb": (90, 16),
                  "proj_w": (16, 16), "proj_b": (16,)}


def _cfg(**kw) -> TrainConfig:
    base = dict(optimizer="adam", learning_rate=3e-3, lr_schedule="constant")
    base.update(kw)
    return TrainConfig(**base)


def _leaves(shapes, dtype, device, seed=0):
    """Params, gradients and an adam state some updates along: m of
    either sign, v positive."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=device)).to(
            dtype)

    params = {n: draw(s) for n, s in shapes.items()}
    grads = {n: draw(s, 1e-2) for n, s in shapes.items()}
    moments = {n: (draw(s, 1e-3), draw(s, 1e-4).abs())
               for n, s in shapes.items()}
    return params, grads, moments


def _state(opt, params, moments, count):
    state = opt.init(params)
    for n, (m, v) in moments.items():
        state[opt._key("[0].mu", n)].copy_(m)
        state[opt._key("[0].nu", n)].copy_(v)
    for k in state:
        if k.endswith("count"):
            state[k] = count
    return state


def _clone(tree):
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in tree.items()}


def _old_update(opt, params, grads, state):
    """``Optimizer.update``'s adam as the torch composition stood before the
    kernel: clip every gradient first, then each leaf's fourteen passes."""
    if opt.clip > 0:
        norm = global_norm(grads)
        keep = norm < opt.clip
        grads = {n: torch.where(keep, g, g / norm.to(g.dtype)
                                * adam_scalar(opt.clip, g.dtype))
                 for n, g in grads.items()}
    if opt.scheduled:
        count = state[opt._key("[1].count")]
        lr = opt.lr(count)
        state[opt._key("[1].count")] = count + 1
    else:
        lr = opt.lr(0)
    count = state[opt._key("[0].count")] + 1
    state[opt._key("[0].count")] = count
    bc1, bc2 = 1.0 - opt.B1 ** count, 1.0 - opt.B2 ** count
    for n, g in grads.items():
        p = params[n]

        def c(x):
            return adam_scalar(x, g.dtype)
        mu, nu = state[opt._key("[0].mu", n)], state[opt._key("[0].nu", n)]
        mu.mul_(c(opt.B1)).add_(g * c(1 - opt.B1))
        nu.mul_(c(opt.B2)).add_(g * g * c(1 - opt.B2))
        u = (mu / c(bc1)) / (torch.sqrt(nu / c(bc2)) + c(opt.EPS))
        u = u * c(-lr)
        if opt.decay > 0:
            u = u + p * c(-opt.decay)
        p.add_(u.to(p.dtype))


def adam_scalar(x, dtype):
    return float(torch.tensor(x, dtype=dtype))


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# --------------------------------------------------------------- CPU -----

def test_entry_points_are_declared():
    assert set(adam._KERNELS.values()) == {
        "sert_adam_update_f32", "sert_adam_update_bf16",
        "sert_adam_update_bf16_f32grad"}
    assert set(adam._KERNELS.values()) <= set(_build._SIGNATURES)
    assert "adam.cu" in {s.name for s in _build._sources()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip,decay,schedule", [
    (0.0, 0.0, "constant"), (1e-3, 0.0, "cosine"), (10.0, 0.01, "cosine"),
    (0.0, 0.01, "linear")])
def test_cpu_leaves_take_the_torch_composition(dtype, clip, decay, schedule):
    """On CPU tensors the adam branch runs the composition as it stood,
    bit for bit over three updates, and launches nothing."""
    shapes = {"a": (33, 8), "b": (7,)}
    cfg = _cfg(grad_clip_norm=clip, weight_decay=decay, lr_schedule=schedule,
               lr_decay_steps=10)
    opt = Optimizer(cfg)
    params, grads, moments = _leaves(shapes, dtype, "cpu")
    state = _state(opt, params, moments, 2)
    old_p, old_s = _clone(params), _clone(state)
    n = adam.launches
    for _ in range(3):
        opt.update(params, grads, state)
        _old_update(opt, old_p, grads, old_s)
    assert adam.launches == n
    _assert_trees_equal(params, old_p)
    _assert_trees_equal(state, old_s)


@pytest.mark.parametrize("clip", [0.0, 1e-3])
def test_cpu_bf16_leaves_with_fp32_gradients(clip):
    """bf16 params and moments with an fp32 gradient (the fused step's
    bias) take the composition as it stood, its constants in fp32."""
    shapes = {"b": (37,)}
    opt = Optimizer(_cfg(grad_clip_norm=clip, weight_decay=0.01))
    params, _, moments = _leaves(shapes, torch.bfloat16, "cpu")
    grads = {"b": 1e-2 * torch.randn(37, generator=torch.Generator()
                                     .manual_seed(3))}
    state = _state(opt, params, moments, 2)
    old_p, old_s = _clone(params), _clone(state)
    for _ in range(3):
        opt.update(params, grads, state)
        _old_update(opt, old_p, grads, old_s)
    assert params["b"].dtype == torch.bfloat16
    _assert_trees_equal(params, old_p)
    _assert_trees_equal(state, old_s)


def test_the_kernel_takes_only_cuda_leaves():
    k = Optimizer(_cfg())._adam_consts(torch.float32, 1e-3, 0.1, 0.001)
    with pytest.raises(ValueError, match="runs on cuda"):
        adam.adam_update([(torch.zeros(3),) * 4], lambda dt: k)


def test_clipping_moves_the_update():
    """A clip below the norm changes the update; one above it does not."""
    shapes = {"a": (64,)}
    out = {}
    for clip in (0.0, 1e-4, 1e3):
        opt = Optimizer(_cfg(grad_clip_norm=clip))
        params, grads, moments = _leaves(shapes, torch.float32, "cpu")
        state = _state(opt, params, moments, 4)
        opt.update(params, grads, state)
        out[clip] = params["a"]
    assert torch.equal(out[0.0], out[1e3])
    assert not torch.equal(out[0.0], out[1e-4])


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_the_leaves_are_counted_while_recording(kind):
    opt = Optimizer(_cfg(optimizer=kind))
    params, grads, _ = _leaves(FLAGSHIP_SMALL, torch.float32, "cpu")
    state = opt.init(params)
    profiling.counters()
    opt.update(params, grads, state)
    assert profiling.counters() == {}
    with profiling.recording():
        opt.update(params, grads, state)
        opt.update(params, grads, state)
        got = profiling.counters()
    assert got == {"optimizer.leaves.kernel": 0,
                   "optimizer.leaves.plain": 2 * len(FLAGSHIP_SMALL)}


@pytest.mark.parametrize("offsets,elem,n,want", [
    ((0, 0, 0, 0), 4, 100, 0), ((4, 4, 4, 4), 4, 100, 3),
    ((12, 12, 12, 12), 4, 100, 1), ((4, 4, 4, 4), 4, 2, 2),
    ((2, 2, 2, 2), 2, 100, 7), ((0, 4, 0, 0), 4, 100, -1),
    ((8, 8, 8, 0), 2, 100, -1), ((2, 2, 2, 2), 4, 100, -1),
    # bf16 p, m and v with an fp32 gradient: units of eight elements.
    ((2, 4, 2, 2), (2, 4, 2, 2), 100, 7), ((4, 8, 4, 4), (2, 4, 2, 2), 100, 6),
    ((4, 4, 4, 4), (2, 4, 2, 2), 100, -1), ((0, 0, 0, 0), (2, 4, 2, 2), 5, 0)])
def test_the_head_reaches_the_common_alignment(offsets, elem, n, want):
    ptrs = [4096 * (i + 1) + o for i, o in enumerate(offsets)]
    elems = elem if isinstance(elem, tuple) else (elem,) * 4
    assert adam._head(ptrs, elems, n, 16 // min(elems)) == want


def test_launches_group_by_dtype_and_split_past_the_table():
    f = [(torch.zeros(3),) * 4 for _ in range(adam.MAX_LEAVES + 8)]
    b = [(torch.zeros(3, dtype=torch.bfloat16),) * 4 for _ in range(3)]
    mixed = f[:5] + b[:1] + f[5:] + b[1:]
    got = adam._batches(mixed)
    assert [len(x) for x in got] == [adam.MAX_LEAVES, 8, 3]
    assert [x[0][0].dtype for x in got] == [torch.float32] * 2 + [
        torch.bfloat16]
    assert [leaf for x in got[:2] for leaf in x] == f
    assert got[2] == b
    # bf16 params with fp32 gradients launch apart from bf16 ones.
    fg = [(b[0][0], f[0][0], b[0][0], b[0][0])]
    got = adam._batches(b[:1] + fg + b[1:])
    assert [len(x) for x in got] == [3, 1]
    assert got[1] == fg


@pytest.fixture
def launches(monkeypatch):
    """The entry points replaced by recorders that read the leaf table
    while the call lasts, as the C side copies it: [(name, table, args)]."""
    calls = []

    def kernel(name):
        def launch(*args):
            assert len(args) == len(_build._SIGNATURES[name]), name
            rows = np.ctypeslib.as_array(
                (ctypes.c_longlong * (6 * args[1])).from_address(args[0]))
            calls.append((name, rows.reshape(-1, 6).copy(), args))
            return 0
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "check", lambda err, what: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("dtype,name", [
    (torch.float32, "sert_adam_update_f32"),
    (torch.bfloat16, "sert_adam_update_bf16")])
def test_a_launch_is_given_the_table_and_the_constants(launches, dtype,
                                                       name):
    """What the kernel is given, from the leaves alone: each leaf's four
    addresses, its size and its head; the constants, the bias corrections
    as their fp32 reciprocals; the decay flag, the norm, the stream."""
    opt = Optimizer(_cfg(grad_clip_norm=0.5, weight_decay=0.01))
    k = opt._adam_consts(dtype, lr=3e-3, bc1=1 - 0.9 ** 3,
                         bc2=1 - 0.999 ** 3)
    base = torch.zeros(4, 1000, dtype=dtype)
    shifted = [base[i, 1:] for i in range(4)]     # one element off
    mixed = [base[0, 1:], base[1, :-1], base[2, 1:], base[3, 1:]]
    empty = [torch.zeros(0, dtype=dtype)] * 4
    transposed_g = torch.zeros(16, 8, dtype=dtype).t()
    plain = [torch.zeros(8, 16, dtype=dtype) for _ in range(3)]
    norm = torch.ones((), dtype=torch.float32)
    leaves = [tuple(shifted), tuple(mixed), tuple(empty),
              (plain[0], transposed_g, plain[1], plain[2])]
    n = adam.launches
    adam._launch(leaves, k, norm)
    assert adam.launches == n + 1
    ((got_name, table, args),) = launches
    assert got_name == name
    elem = base.element_size()
    assert table[0, :4].tolist() == [t.data_ptr() for t in shifted]
    assert table[0, 4:].tolist() == [999, 16 // elem - 1]
    assert table[1, 4:].tolist() == [999, -1]
    # The empty leaf is left out; the transposed gradient is copied.
    assert table.shape[0] == 3
    assert table[2, 1] != transposed_g.data_ptr()
    assert table[2, 4] == 128
    assert args[1] == 3
    assert list(args[2:6]) == [k.b1, k.c1, k.b2, k.c2]
    assert args[6] == float(np.float32(1) / np.float32(k.bc1))
    assert args[7] == float(np.float32(1) / np.float32(k.bc2))
    assert list(args[8:12]) == [k.eps, k.neg_lr, k.neg_decay, 1]
    assert args[12] == norm.data_ptr()
    assert list(args[13:]) == [0.5, k.clip, 7]
    # Without decay or clipping.
    k = k._replace(neg_decay=None)
    adam._launch([tuple(plain) + (plain[0],)], k, None)
    assert launches[-1][2][10:13] == (0.0, 0, None)


def test_a_bf16_leaf_with_an_fp32_gradient_launches_its_own_kernel(
        launches):
    """Its head counts in units of eight elements; its constants are the
    gradient's (fp32)."""
    k = Optimizer(_cfg())._adam_consts(torch.float32, 3e-3, 0.1, 0.001)
    p, m, v = (torch.zeros(1001, dtype=torch.bfloat16) for _ in range(3))
    g = torch.zeros(1001)
    leaf = (p[1:], g[1:], m[1:], v[1:])      # 2 and 4 bytes past 16
    adam._launch([leaf], k, None)
    ((name, table, args),) = launches
    assert name == "sert_adam_update_bf16_f32grad"
    assert table[0, :4].tolist() == [t.data_ptr() for t in leaf]
    assert table[0, 4:].tolist() == [1000, 7]
    assert list(args[2:6]) == [k.b1, k.c1, k.b2, k.c2] == [
        0.8999999761581421, 0.10000000149011612, 0.9990000128746033,
        0.0010000000474974513]


def test_a_launch_refuses_what_the_kernel_does_not_take(launches):
    k = Optimizer(_cfg())._adam_consts(torch.float32, 1e-3, 0.1, 0.001)
    t = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        adam._launch([(t.half(),) * 4], k, None)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        adam._launch([(t, t.double(), t, t)], k, None)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        adam._launch([(t, t.bfloat16(), t, t)], k, None)
    with pytest.raises(ValueError, match="one dtype"):
        adam._launch([(t,) * 4, (t, t.bfloat16(), t, t)], k, None)
    with pytest.raises(ValueError, match="one dtype"):
        adam._launch([(t, t, t.bfloat16(), t)], k, None)
    with pytest.raises(ValueError, match="one shape"):
        adam._launch([(t, t[:4], t, t)], k, None)
    with pytest.raises(ValueError, match="contiguous"):
        adam._launch([(t.t(), t, t, t)], k, None)
    with pytest.raises(ValueError, match="norm"):
        adam._launch([(t,) * 4], k, torch.ones(2))
    assert launches == []


# --------------------------------------------------------------- card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run pytest -m gpu on the H100")
    return torch.device("cuda")


@pytest.fixture
def plain_launch(monkeypatch):
    """Runs ``fn`` with ``Optimizer.update`` replaced by the composition
    as it stood (``_old_update``), which launches no kernel."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(Optimizer, "update", _old_update)
            n = adam.launches
            out = fn()
            assert adam.launches == n
            return out
    return run


def _kernel_and_plain(plain_launch, cfg, shapes, dtype, dev, count=3,
                      updates=1, leaves=None):
    """Params and state after ``updates`` updates through the kernel and
    through the plain composition, from the same start."""
    opt = Optimizer(cfg)
    params, grads, moments = leaves or _leaves(shapes, dtype, dev)
    state = _state(opt, params, moments, count)
    p2, s2 = _clone(params), _clone(state)
    for _ in range(updates):
        opt.update(params, grads, state)
        plain_launch(lambda: opt.update(p2, grads, s2))
    torch.cuda.synchronize()
    return (params, state), (p2, s2), grads


def _clip_for(case, shapes, dtype, dev):
    """A clip norm below the gradients' norm ("above": they are scaled)
    or above it ("below": they are kept)."""
    if case == "off":
        return 0.0
    _, grads, _ = _leaves(shapes, dtype, dev)
    norm = float(global_norm(grads))
    return norm * (0.5 if case == "above" else 2.0)


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("shape", list(FLAGSHIP.values()) + ODD)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("clip", ["off", "below", "above"])
    @pytest.mark.parametrize("decay", [0.0, 0.01])
    def test_kernel_is_bit_equal_to_plain(self, cuda, plain_launch, shape,
                                          dtype, clip, decay):
        shapes = {"x": shape}
        cfg = _cfg(grad_clip_norm=_clip_for(clip, shapes, dtype, cuda),
                   weight_decay=decay)
        n = adam.launches
        (p, s), (p2, s2), _ = _kernel_and_plain(plain_launch, cfg, shapes,
                                                dtype, cuda)
        assert adam.launches == n + 1
        _assert_trees_equal(p, p2)
        _assert_trees_equal(s, s2)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("which", ["all", "p"])
    @pytest.mark.parametrize("n", [1, 5, 16_385])
    def test_a_leaf_four_bytes_off_alignment(self, cuda, plain_launch,
                                             dtype, which, n):
        """The four tensors viewed 4 bytes past a 16-byte boundary (a head
        and a tail around the vectors), or p alone (every element on its
        own)."""
        shift = 4 // torch.tensor([], dtype=dtype).element_size()

        def off(t, moved):
            if not moved:
                return t
            buf = torch.empty(t.numel() + shift, dtype=dtype, device=cuda)
            view = buf[shift:]
            view.copy_(t)
            assert view.data_ptr() % 16 == 4
            return view

        params, grads, moments = _leaves({"x": (n,)}, dtype, cuda)
        moved = {"p": True, "g": which == "all", "m": which == "all"}
        params = {"x": off(params["x"], moved["p"])}
        grads = {"x": off(grads["x"], moved["g"])}
        moments = {"x": tuple(off(t, moved["m"]) for t in moments["x"])}
        opt = Optimizer(_cfg(weight_decay=0.01))
        state = _state(opt, params, {}, 3)
        for key, t in zip(("[0].mu", "[0].nu"), moments["x"]):
            state[opt._key(key, "x")] = t
        p2, s2 = _clone(params), _clone(state)
        opt.update(params, grads, state)
        plain_launch(lambda: opt.update(p2, grads, s2))
        torch.cuda.synchronize()
        _assert_trees_equal(params, p2)
        _assert_trees_equal(state, s2)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_five_updates_under_the_cosine_lr(self, cuda, plain_launch,
                                              dtype):
        shapes = {"proj_w": (128, 128), "proj_b": (128,), "t": (16_385, 3)}
        cfg = _cfg(lr_schedule="cosine", lr_decay_steps=8)
        (p, s), (p2, s2), _ = _kernel_and_plain(
            plain_launch, cfg, shapes, dtype, cuda, count=0, updates=5)
        _assert_trees_equal(p, p2)
        _assert_trees_equal(s, s2)
        assert s[Optimizer(cfg)._key("[1].count")] == 5

    def test_the_flagships_leaves_take_one_launch(self, cuda):
        opt = Optimizer(_cfg(lr_schedule="cosine", lr_decay_steps=100))
        params, grads, moments = _leaves(FLAGSHIP, torch.float32, cuda)
        state = _state(opt, params, moments, 0)
        n = adam.launches
        profiling.counters()
        with profiling.recording():
            opt.update(params, grads, state)
            got = profiling.counters()
        assert adam.launches == n + 1
        assert got == {"optimizer.leaves.kernel": 4,
                       "optimizer.leaves.plain": 0}

    def test_leaves_of_two_dtypes_take_two_launches(self, cuda,
                                                    plain_launch):
        shapes = {"a": (300, 7), "b": (64,)}
        fa = _leaves(shapes, torch.float32, cuda, seed=1)
        fb = _leaves(shapes, torch.bfloat16, cuda, seed=2)
        leaves = tuple({**x, **{k + "16": t for k, t in y.items()}}
                       for x, y in zip(fa, fb))
        n = adam.launches
        (p, s), (p2, s2), _ = _kernel_and_plain(
            plain_launch, _cfg(), None, None, cuda, leaves=leaves)
        assert adam.launches == n + 2
        _assert_trees_equal(p, p2)
        _assert_trees_equal(s, s2)

    def test_the_kernel_refuses_half_leaves(self, cuda):
        opt = Optimizer(_cfg())
        params, grads, _ = _leaves({"x": (8,)}, torch.float16, cuda)
        with pytest.raises(ValueError, match="fp32 or bf16"):
            opt.update(params, grads, opt.init(params))

    @pytest.mark.parametrize("clip", ["off", "below", "above"])
    @pytest.mark.parametrize("decay", [0.0, 0.01])
    @pytest.mark.parametrize("shape", [(128,), (1,), (16_385,)])
    def test_bf16_leaves_with_fp32_gradients(self, cuda, plain_launch,
                                             shape, clip, decay):
        """bf16 p, m and v with an fp32 gradient (the fused step's bias),
        beside a bf16 leaf: bit-equal to the composition as it stood, one
        launch for each pair of dtypes."""
        shapes = {"w": (128, 128), "b": shape}
        params, grads, moments = _leaves(shapes, torch.bfloat16, cuda)
        grads["b"] = 1e-2 * torch.randn(shape, device=cuda, generator=(
            torch.Generator(device=cuda).manual_seed(5)))
        cfg = _cfg(grad_clip_norm=_clip_for(clip, shapes, torch.bfloat16,
                                            cuda), weight_decay=decay)
        n = adam.launches
        (p, s), (p2, s2), _ = _kernel_and_plain(
            plain_launch, cfg, None, None, cuda,
            leaves=(params, grads, moments))
        assert adam.launches == n + 2
        _assert_trees_equal(p, p2)
        _assert_trees_equal(s, s2)

    def test_the_fused_loglinear_bf16_step(self, cuda, plain_launch):
        """The fused step (K5 + K7) of a log-linear model with bf16 params
        (it takes no clipping, decay or schedule): its small leaves' adam,
        the bias's gradient fp32, bit-equal over three micro-steps to the
        same step with the composition as it stood."""
        mcfg = ModelConfig(model="loglinear", vocab_size=300,
                           num_entities=1000, word_dim=128, entity_dim=128,
                           compute_dtype="bfloat16", param_dtype="bfloat16",
                           fused_softmax="on")
        tcfg = TrainConfig(optimizer="adam", batch_size=256,
                           learning_rate=0.05, lr_schedule="constant",
                           fused_update="on")
        rng = np.random.default_rng(0)
        batches = [{"windows": torch.from_numpy(rng.integers(
                        0, 300, size=(256, 5)).astype(np.int32)).to(cuda),
                    "lengths": torch.from_numpy(rng.integers(
                        1, 6, size=256).astype(np.int32)).to(cuda),
                    "entities": torch.from_numpy(rng.integers(
                        0, 1000, size=256).astype(np.int32)).to(cuda)}
                   for _ in range(3)]

        def run():
            state = init_state(0, mcfg, tcfg, cuda)
            step = make_train_step(mcfg, tcfg, device=cuda)
            for b in batches:
                state, _ = step(state, b)
            torch.cuda.synchronize()
            return state

        n = adam.launches
        got = run()
        assert adam.launches == n + 3 * 2     # bf16, and bf16 with fp32
        want = plain_launch(run)
        assert got.params["proj_b"].dtype == torch.bfloat16
        _assert_trees_equal(got.params, want.params)
        _assert_trees_equal(got.opt_state, want.opt_state)
