"""The port's input and numeric guards (sert_tpu_torch.utils.debug) and
tracing utilities (utils.profiling): the reference's TestDebug and
TestProfiling cases (tests/test_utils.py) on the port, with the
reference's messages and leaf names where both packages name one."""

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
