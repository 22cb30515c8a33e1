"""The port's input and numeric guards (sert_tpu_torch.utils.debug) and
tracing utilities (utils.profiling): the reference's TestDebug and
TestProfiling cases (tests/test_utils.py) on the port, with the
reference's messages and leaf names where both packages name one."""

import contextlib
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu.train import step as ref_step  # noqa: E402
from sert_tpu.utils import debug as ref_debug  # noqa: E402
from sert_tpu.utils.config import ModelConfig, TrainConfig  # noqa: E402
from sert_tpu_torch.models import api  # noqa: E402
from sert_tpu_torch.train import step as port_step  # noqa: E402
from sert_tpu_torch.utils import debug, profiling  # noqa: E402

CFG = ModelConfig(model="loglinear", vocab_size=30, num_entities=9, word_dim=4)


def _batch():
    return {"windows": np.array([[1, 2], [3, 4]], np.int32),
            "lengths": np.array([2, 2], np.int32),
            "entities": np.array([0, 8], np.int32)}


def _tbatch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _params():
    return api.init_params(torch.Generator().manual_seed(0), CFG)


class TestDebug:
    def test_validate_ok(self):
        debug.validate_batch(_batch(), CFG)

    @pytest.mark.parametrize("field,val,msg", [
        ("windows", np.array([[1, 99], [3, 4]], np.int32), "term id"),
        ("entities", np.array([0, 9], np.int32), "entity id"),
        ("lengths", np.array([3, 2], np.int32), "length"),
        ("lengths", np.array([2], np.int32), "shape mismatch"),
    ])
    def test_validate_catches(self, field, val, msg):
        b = _batch()
        b[field] = val
        with pytest.raises(ValueError, match=msg) as got:
            debug.validate_batch(b, CFG)
        with pytest.raises(ValueError) as want:
            ref_debug.validate_batch(b, CFG)
        assert str(got.value) == str(want.value)

    def test_checked_loss_flags_nan(self):
        params = _params()
        params["proj_w"] = params["proj_w"] * torch.nan
        f = debug.checked(lambda p, b: api.loss_fn(p, b, CFG))
        err, _ = f(params, _tbatch())
        assert err.get().startswith("nan generated by aten.")
        with pytest.raises(FloatingPointError, match="nan generated by"):
            err.throw()

    def test_checked_loss_clean(self):
        f = debug.checked(lambda p, b: api.loss_fn(p, b, CFG))
        err, loss = f(_params(), _tbatch())
        err.throw()  # no error
        assert err.get() is None
        assert np.isfinite(float(loss))

    def test_checked_names_the_first_op(self):
        def f(x):
            y = torch.log(x)          # NaN first here
            return torch.exp(y) + 1
        err, _ = debug.checked(f)(torch.tensor([1.0, -1.0]))
        assert err.get() == "nan generated by aten.log.default"

    def test_checked_flags_integer_division_by_zero(self):
        err, _ = debug.checked(lambda a, b: torch.div(
            a, b, rounding_mode="trunc"))(torch.tensor([4, 6]),
                                          torch.tensor([2, 3]))
        assert err.get() is None
        f = debug.checked(lambda a, b: torch.remainder(a, b))
        # The CPU refuses it outright; the check names it.
        with pytest.raises(FloatingPointError,
                           match="division by zero in aten.remainder"):
            f(torch.tensor([4, 6]), torch.tensor([2, 0]))
        with pytest.raises(FloatingPointError, match="division by zero"):
            debug.checked(lambda a: a // 0)(torch.tensor([4, 6]))

    def test_checked_names_a_kernel_at_its_boundary(self):
        """A kernel writes through a pointer, unseen by the dispatcher: its
        wrapper's kernel_outputs names it. The uninitialized buffer (empty)
        and the views that reach its memory (numpy's detach) make no
        values, so nothing is checked before the kernel's outputs, whatever
        the buffer held."""
        def wrapper():
            out = torch.empty(4)            # uninitialized: not checked
            out.numpy()[:] = [1.0, np.nan, 2.0, 3.0]   # "the kernel"
            debug.kernel_outputs("xent_fwd", out)
            return out.sum()
        err, _ = debug.checked(wrapper)()
        assert err.get() == "nan generated by kernel xent_fwd"
        assert err._checks[0][0] == "nan generated by kernel xent_fwd"
        padded = torch.zeros(2, 6)
        padded[:, 4:] = torch.nan           # the sweep's padding columns
        err, _ = debug.checked(
            lambda: debug.kernel_outputs("k", padded, cols=4))()
        assert err.get() is None
        debug.kernel_outputs("no mode", torch.tensor([np.nan]))  # no-op

    def test_checked_leaves_views_to_the_op_that_made_the_nan(self):
        """As checkify's float_checks, which check no data movement: a
        view of a NaN made outside is not flagged, an op that computes
        from it is."""
        x = torch.tensor([1.0, np.nan, 2.0])
        err, _ = debug.checked(lambda t: t.detach()[1:].view(2, 1).t())(x)
        assert err.get() is None
        err, _ = debug.checked(lambda t: t.detach()[1:] * 2)(x)
        assert err.get() == "nan generated by aten.mul.Tensor"

    def test_assert_all_finite(self):
        debug.assert_all_finite({"a": torch.ones(3)})
        with pytest.raises(FloatingPointError, match="a"):
            debug.assert_all_finite({"a": torch.tensor([1.0, torch.inf])})

    def test_assert_all_finite_names_a_state_leaf_as_the_reference(self):
        tcfg = TrainConfig(optimizer="adam", lr_schedule="cosine",
                           lr_decay_steps=10)
        port = port_step.init_state(0, CFG, tcfg)
        ref = ref_step.init_state(jax.random.key(0), CFG, tcfg)
        debug.assert_all_finite(port, "state")
        port.opt_state["[0].nu['proj_w']"][1, 2] = torch.nan
        ref = ref._replace(opt_state=jax.tree_util.tree_map_with_path(
            lambda p, v: v.at[1, 2].set(jnp.nan)
            if jax.tree_util.keystr(p) == "[0].nu['proj_w']" else v,
            ref.opt_state))
        with pytest.raises(FloatingPointError) as want:
            ref_debug.assert_all_finite(ref, "state")
        with pytest.raises(FloatingPointError) as got:
            debug.assert_all_finite(port, "state")
        assert str(got.value) == str(want.value) == (
            "non-finite values in state.opt_state[0].nu['proj_w']")


class TestProfiling:
    def test_step_timer(self):
        t = profiling.StepTimer(window=2)
        assert t.tick(torch.ones(1)) is None
        assert t.tick(torch.ones(1)) is None      # first window: no baseline
        t.tick(torch.ones(1))
        rate = t.tick(torch.ones(1))
        assert rate is not None and rate > 0

    def test_step_timer_calls_the_callers_fence(self):
        seen = []
        t = profiling.StepTimer(fence=seen.append, window=1)
        t.tick({"loss": torch.ones(1)})
        assert len(seen) == 1 and "loss" in seen[0]

    def test_trace_noop_safe(self, tmp_path):
        with profiling.trace(str(tmp_path / "trace")):
            _ = torch.arange(4).sum()

    def test_annotate(self):
        with profiling.annotate("region"):
            _ = torch.arange(4).sum()

    def test_trace_writes_the_annotated_region(self, tmp_path):
        logdir = str(tmp_path / "trace")
        with profiling.trace(logdir):
            with profiling.annotate("scoring_region"):
                _ = torch.ones(64, 64) @ torch.ones(64, 64)
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        assert len(files) == 1
        names = {e.get("name") for e in json.load(open(files[0]))[
            "traceEvents"]}
        assert "scoring_region" in names


# ---------------------------------------------------------------------------
# The program's spans and counters (utils.profiling.recording)

SV, SE, SD, SB, SW, SK = 97, 53, 8, 16, 5, 7
STEP_KINDS = ("dense", "lazy", "fused")
# Each step's spans directly inside sert.step.micro, in order.
STEP_SPANS = {
    "dense": ["sert.step.loss", "sert.step.backward", "sert.step.optimizer"],
    "lazy": ["sert.step.sample", "sert.step.loss", "sert.step.backward",
             "sert.step.dedup", "sert.step.optimizer"],
    "fused": ["sert.step.loss", "sert.step.fused", "sert.step.backward",
              "sert.step.optimizer"]}


def _step_setup(kind, steps_per_call=1):
    """(step, state, batches): a tiny LSE sampled-softmax step, dense or
    lazy, or a log-linear fused step, with 4 host batches."""
    from sert_tpu_torch.utils import config as port_config
    tk = dict(batch_size=SB, learning_rate=0.05, donate_state=False,
              steps_per_call=steps_per_call, lr_decay_steps=10)
    if kind == "fused":
        mcfg = port_config.ModelConfig(
            model="loglinear", vocab_size=SV, num_entities=SE, word_dim=128,
            fused_softmax="on")
        tcfg = port_config.TrainConfig(optimizer="adam", fused_update="on",
                                       **tk)
    else:
        mcfg = port_config.ModelConfig(
            model="lse", vocab_size=SV, num_entities=SE, word_dim=SD,
            entity_dim=SD, objective="sampled_softmax", num_negatives=SK,
            negative_distribution="unigram")
        tcfg = port_config.TrainConfig(
            optimizer="adam", lr_schedule="cosine",
            sparse_update="on" if kind == "lazy" else "off", **tk)
    from sert_tpu_torch.models import lse
    noise = (lse.noise_logits(np.arange(1, SE + 1), mcfg, "cpu")
             if mcfg.model == "lse" else None)
    step = port_step.make_train_step(mcfg, tcfg, noise=noise)
    state = port_step.init_state(0, mcfg, tcfg)
    rng = np.random.default_rng(3)
    batches = [{"windows": rng.integers(0, SV, (SB, SW)).astype(np.int32),
                "lengths": rng.integers(1, SW + 1, SB).astype(np.int32),
                "entities": rng.integers(0, SE, SB).astype(np.int32)}
               for _ in range(4)]
    return step, state, batches


def _spans(events):
    """{thread: [(start, end, name)]} of the program's spans."""
    out = {}
    for e in events:
        if e.name.startswith("sert."):
            out.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    return out


def _children(spans, parent):
    """The spans directly inside each ``parent`` span, by start."""
    spans = sorted(spans)
    out = []
    for a, b, name in spans:
        if name != parent:
            continue
        inner = [s for s in spans if a <= s[0] and s[1] <= b and s[2] != parent]
        out.append([n for x, y, n in inner
                    if not any(p[0] <= x and y <= p[1] and p != (x, y, n)
                               for p in inner)])
    return out


class TestSpans:
    @pytest.fixture(autouse=True)
    def _fresh(self):
        """No counter or ident left from another test's recording."""
        profiling.counters()
        profiling.span_idents()

    def test_annotate_outside_a_recording_is_one_shared_null_context(self):
        a, b = profiling.annotate("sert.x"), profiling.annotate("sert.y", 3)
        assert a is b
        with a:
            pass
        profiling.count("c", 5)
        profiling.count("c", torch.ones(3, dtype=torch.bool))
        assert profiling.counters() == {} and profiling.span_idents() == {}

    def test_a_bare_profiler_records_no_program_span(self):
        """What the benchmark's measured runs see: a profiler alone does
        not turn the spans on."""
        from torch.profiler import profile
        step, state, batches = _step_setup("dense")
        with profile() as prof:
            step(state, {k: torch.from_numpy(v) for k, v in
                         batches[0].items()})
        names = {e.name for e in prof.events()}
        assert "aten::mm" in names or "aten::matmul" in names
        assert not [n for n in names if n.startswith("sert.")]

    @pytest.mark.parametrize("kind", STEP_KINDS)
    def test_the_step_spans_nest_in_the_micro_step(self, kind, tmp_path):
        """Inside ``profiling.trace``, each micro-step of a call of two is
        one ``sert.step.micro`` holding its parts in order, in the chrome
        trace it writes."""
        step, state, batches = _step_setup(kind, steps_per_call=2)
        group = {k: torch.from_numpy(np.stack([b[k] for b in batches[:2]]))
                 for k in batches[0]}
        logdir = str(tmp_path / "trace")
        with profiling.trace(logdir):
            step(state, group)
        (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        events = [e for e in json.load(open(path))["traceEvents"]
                  if e.get("ph") == "X" and e["name"].startswith("sert.")]
        threads = {e["tid"] for e in events}
        assert len(threads) == 1
        spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events]
        assert sum(n == "sert.step.micro" for _, _, n in spans) == 2
        assert _children(spans, "sert.step.micro") == [STEP_SPANS[kind]] * 2
        assert not [n for _, _, n in spans
                    if n not in STEP_SPANS[kind] + ["sert.step.micro"]]

    def test_the_feeders_put_carries_the_ident_of_its_wait(self):
        """The worker's ``sert.feed.put`` (around ``sert.feed.read`` and
        the put function) runs on its own thread; the consumer's wait that
        receives item i carries the ident the put of item i carried."""
        from torch.profiler import profile

        from sert_tpu_torch.data.feeder import PrefetchFeeder
        def put_fn(i):
            return i
        with profiling.recording(), profile(
                **profiling.profile_all_threads()) as prof:
            got = list(PrefetchFeeder(iter(range(6)), put_fn=put_fn))
        assert got == list(range(6))
        idents = profiling.span_idents()
        puts = [i for _, i in idents["sert.feed.put"]]
        waits = [i for _, i in idents["sert.feed.wait"]]
        serial = puts[0][0]
        # Six items, then the put and the wait of the end of the stream.
        assert puts == [(serial, i) for i in range(7)]
        assert waits == [(serial, i) for i in range(7)]
        spans = _spans(prof.events())
        main = [th for th, s in spans.items()
                if any(n == "sert.feed.wait" for _, _, n in s)]
        assert len(main) == 1
        if profiling.profile_all_threads():
            worker = [th for th in spans if th != main[0]]
            assert len(worker) == 1
            s = spans[worker[0]]
            assert sum(n == "sert.feed.put" for _, _, n in s) == 7
            assert _children(s, "sert.feed.put") == \
                [["sert.feed.read"]] * 7

    def test_the_lazy_steps_row_counters_count_distinct_rows(
            self, monkeypatch):
        from sert_tpu_torch.models import lse
        negs = [np.array([[1, 2, 2, 9, 50, 1, 4]]),
                np.array([[0, 0, 0, 0, 0, 0, 0]])]
        it = iter(negs)
        monkeypatch.setattr(lse, "sample_negatives",
                            lambda gen, noise, n, cfg: torch.from_numpy(
                                next(it)).long().reshape(n, -1))
        step, state, batches = _step_setup("lazy")
        with profiling.recording():
            for b in batches[:2]:
                step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            got = profiling.counters()
        want = {
            "rows.slots.word_emb": 2 * SB * SW,
            "rows.unique.word_emb": sum(
                torch.unique(torch.from_numpy(b["windows"])).numel()
                for b in batches[:2]),
            "rows.slots.entity_emb": 2 * (SB + SK),
            "rows.unique.entity_emb": sum(
                torch.unique(torch.from_numpy(np.concatenate(
                    [b["entities"], n.ravel()]))).numel()
                for b, n in zip(batches, negs)),
            # The dense leaves' adam, proj_w and proj_b, on the CPU.
            "optimizer.leaves.kernel": 0,
            "optimizer.leaves.plain": 2 * 2}
        assert got == want
        assert profiling.counters() == {}

    @pytest.mark.parametrize("kind", STEP_KINDS)
    def test_recording_leaves_the_state_bit_equal(self, kind):
        """Three micro-steps with the spans and counters on, under a
        profiler, give the params and optimizer state of three without."""
        from torch.profiler import profile
        results = []
        for on in (False, True):
            step, state, batches = _step_setup(kind)
            ctx = profiling.recording() if on else contextlib.nullcontext()
            with ctx, profile(**profiling.profile_all_threads()):
                for b in batches[:3]:
                    step(state, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
            profiling.counters()
            results.append(state)
        off, on = results
        assert off.step == on.step == 3
        for tree in ("params", "opt_state"):
            a, b = getattr(off, tree), getattr(on, tree)
            assert a.keys() == b.keys()
            for k in a:
                if torch.is_tensor(a[k]):
                    assert torch.equal(a[k], b[k]), (tree, k)
                else:
                    assert a[k] == b[k], (tree, k)
