"""The port's packed wire feed (sert_tpu_torch.data.wirepack and the
loop's ``packed_feed="on"``) against the reference's
(sert_tpu.data.wirepack) on the CPU: the packing byte for byte, the
unpack equal to ``unpack_batch_jnp`` element for element, the mode rules,
and training with the packed feed bit-equal to training without it.
Every comparison is exact: packing is integer arithmetic."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sert_tpu.data import wirepack as ref_wirepack  # noqa: E402
from sert_tpu_torch import pipeline, recipes  # noqa: E402
from sert_tpu_torch.data import wirepack  # noqa: E402
from sert_tpu_torch.train import loop  # noqa: E402

ID_SPACES = [65_536, 65_537, 250_000, 1_000_000, 1 << 24]
UNPACK = wirepack.unpack_batch


def _batch(rng, V, E, B=32, w=8, lead=()):
    return {
        "windows": rng.integers(0, V, size=lead + (B, w)).astype(np.int32),
        "lengths": rng.integers(1, w + 1, size=lead + (B,)).astype(np.int32),
        "entities": rng.integers(0, E, size=lead + (B,)).astype(np.int32),
    }


def _with_extremes(raw, V, E):
    """Each plane's largest id and 0 in the first rows: the bits a shift
    or a mask could lose."""
    raw["windows"].reshape(-1, raw["windows"].shape[-1])[0] = V - 1
    raw["windows"].reshape(-1, raw["windows"].shape[-1])[1] = 0
    raw["entities"].reshape(-1)[:2] = (E - 1, 0)
    return raw


def _unpack_both(packed, V, E):
    ref = ref_wirepack.unpack_batch_jnp(
        {k: jnp.asarray(v) for k, v in packed.items()}, V, E)
    got = wirepack.unpack_batch({k: torch.from_numpy(v)
                                 for k, v in packed.items()}, V, E)
    return ref, got


@pytest.mark.parametrize("V", ID_SPACES)
@pytest.mark.parametrize("E", ID_SPACES)
def test_pack_is_byte_equal_and_unpack_equal_to_the_reference(V, E):
    rng = np.random.default_rng((V * 7 + E) % (1 << 32))
    raw = _with_extremes(_batch(rng, V, E), V, E)
    packed = wirepack.pack_batch(raw, V, E)
    want = ref_wirepack.pack_batch(raw, V, E)
    assert packed.keys() == want.keys()
    for k in want:
        assert packed[k].dtype == want[k].dtype, k
        assert packed[k].tobytes() == want[k].tobytes(), k
    ref, got = _unpack_both(packed, V, E)
    for k in raw:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), raw[k], err_msg=k)


@pytest.mark.parametrize("w", [1, 3, 5, 7, 9, 13])
@pytest.mark.parametrize("V", [70_000, 250_000, 1 << 24])
def test_window_widths_off_the_group(w, V):
    """Widths that are not a multiple of 8 // hi_bits(V) pad the window
    hi plane; the pad never reaches the ids."""
    E = 1_000_000
    raw = _with_extremes(_batch(np.random.default_rng(w), V, E, B=16, w=w),
                         V, E)
    packed = wirepack.pack_batch(raw, V, E)
    assert packed["whi"].tobytes() == ref_wirepack.pack_batch(
        raw, V, E)["whi"].tobytes()
    ref, got = _unpack_both(packed, V, E)
    for k in raw:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(got[k].numpy(), raw[k])


@pytest.mark.parametrize("lead", [(1,), (4,), (2, 3)])
def test_stacked_batches(lead):
    """steps_per_call's [n, B, w] stacks (and any further leading axes)
    pack and unpack intact."""
    V, E = 250_000, 1_000_000
    raw = _batch(np.random.default_rng(3), V, E, B=16, w=5, lead=lead)
    packed = wirepack.pack_batch(raw, V, E)
    ref, got = _unpack_both(packed, V, E)
    for k in raw:
        assert tuple(got[k].shape) == raw[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(got[k].numpy(), raw[k])


def test_feed_bytes_at_the_flagship():
    """vocab 250k, 1M entities, w 8: 22 bytes an instance against 40."""
    V, E, B, w = 250_000, 1_000_000, 4096, 8
    raw = _batch(np.random.default_rng(0), V, E, B=B, w=w)
    packed = wirepack.pack_batch(raw, V, E)
    assert wirepack.packed_nbytes(raw) == 40 * B
    assert wirepack.packed_nbytes(packed) == 22 * B
    assert {k: v.dtype for k, v in packed.items()} == {
        "wlo": np.uint16, "elo": np.uint16, "len": np.uint8,
        "whi": np.uint8, "ehi": np.uint8}


@pytest.mark.parametrize("n", [0, 1, 16, 17, 18, 20, 24, 25])
def test_hi_bits_and_packable_match_the_reference(n):
    space = max(1 << n, 1)
    for size in {space - 1, space, space + 1} - {0}:
        try:
            want = ref_wirepack.hi_bits(size)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                wirepack.hi_bits(size)
        else:
            assert wirepack.hi_bits(size) == want
        assert wirepack.packable(size, 100) == ref_wirepack.packable(size,
                                                                     100)


@pytest.mark.parametrize("mode,V,E,w", [
    ("off", 100, 100, 8), ("on", 100, 100, 8), ("auto", 100, 100, 8),
    ("auto", 250_000, 1_000_000, 8), ("off", 1 << 25, 100, 8),
    ("auto", 1 << 25, 100, 8), ("auto", 100, 100, 300),
    ("off", 100, 100, 300),
])
def test_feed_enabled_rules(mode, V, E, w):
    """As the reference's on the CPU, where its "auto" is off too (it
    packs only on the TPU backend); the port's "auto" is off everywhere."""
    assert wirepack.feed_enabled(mode, V, E, w) == \
        ref_wirepack.feed_enabled(mode, V, E, w) == (mode == "on")


@pytest.mark.parametrize("mode,V,E,w", [
    ("on", 1 << 25, 100, 8), ("on", 100, 1 << 25, 8), ("on", 100, 100, 300),
    ("bogus", 100, 100, 8),
])
def test_feed_enabled_refusals(mode, V, E, w):
    match = "unknown" if mode == "bogus" else "packed_feed"
    with pytest.raises(ValueError, match=match):
        ref_wirepack.feed_enabled(mode, V, E, w)
    with pytest.raises(ValueError, match=match):
        wirepack.feed_enabled(mode, V, E, w)


def test_window_cap():
    raw = _batch(np.random.default_rng(1), 100, 100, B=4, w=300)
    with pytest.raises(ValueError, match="255"):
        wirepack.pack_batch(raw, 100, 100)


# --- the loop -----------------------------------------------------------------

def _train(tmp_path, name, recipe, data, monkeypatch):
    """Train ``recipe``; returns (state, logged losses, unpacked shapes)."""
    shapes = []

    def spy(packed, V, E):
        shapes.append(tuple(packed["wlo"].shape))
        return UNPACK(packed, V, E)

    monkeypatch.setattr(wirepack, "unpack_batch", spy)
    run = str(tmp_path / name)
    state, _ = pipeline.train_from_dir(recipe, data, run, device="cpu")
    losses = [json.loads(x)["loss"] for x in open(os.path.join(
        run, "train_log.jsonl")) if '"train_step"' in x]
    return state, losses, shapes


@pytest.mark.parametrize("spc", [1, 4])
def test_packed_feed_trains_bit_equal_to_raw(tmp_path, monkeypatch, spc):
    base = recipes.tiny_recipe("lse", objective="sampled_softmax")
    base = dataclasses.replace(base, train=dataclasses.replace(
        base.train, num_epochs=2, steps_per_call=spc, log_every_steps=1))
    data = str(tmp_path / "data")
    pipeline.prepare_collection(recipes.tiny_spec(seed=2).build(), data,
                                base)
    runs = {}
    for mode in ("off", "on"):
        recipe = dataclasses.replace(base, train=dataclasses.replace(
            base.train, packed_feed=mode))
        runs[mode] = _train(tmp_path, mode, recipe, data, monkeypatch)
    (s_off, l_off, n_off), (s_on, l_on, n_on) = runs["off"], runs["on"]
    assert n_off == [] and len(n_on) == s_on.step // spc > 0
    lead = (spc,) if spc > 1 else ()
    assert {s[:-2] for s in n_on} == {lead}
    assert s_on.step == s_off.step and l_on == l_off and len(l_on) >= 2
    for k in s_off.params:
        assert torch.equal(s_on.params[k], s_off.params[k]), k
    for k, v in s_off.opt_state.items():
        assert (torch.equal(v, s_on.opt_state[k]) if torch.is_tensor(v)
                else v == s_on.opt_state[k]), k


def test_loop_accepts_the_modes_and_refuses_an_unknown_one():
    recipe = recipes.tiny_recipe("loglinear")
    for mode in ("on", "auto", "off"):
        loop._check_supported(dataclasses.replace(
            recipe, train=dataclasses.replace(recipe.train,
                                              packed_feed=mode)))
    with pytest.raises(ValueError, match="unknown packed_feed"):
        loop._check_supported(dataclasses.replace(
            recipe, train=dataclasses.replace(recipe.train,
                                              packed_feed="always")))
