"""Parity of the port's LSE inference path (sert_tpu_torch.models) with the
JAX reference (sert_tpu.models) on the CPU, on the same numpy inputs.

Tolerances: fp32 compute agrees to reassociation level (atol 1e-5); bf16
compute rounds the pooled input at slightly different places in the two
frameworks (atol 2e-2, the bf16 class for O(1) values).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sert_tpu.models import lse as ref_lse  # noqa: E402
from sert_tpu.scoring import scorer as ref_scorer  # noqa: E402
from sert_tpu.utils.config import ModelConfig  # noqa: E402
from sert_tpu_torch.models import api, common, lse  # noqa: E402
from sert_tpu_torch.models.convert import (params_from_jax,  # noqa: E402
                                           params_to_numpy)
from sert_tpu_torch.scoring import scorer  # noqa: E402

V, DW, DE, E, B, W = 60, 16, 12, 40, 9, 6
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfg(compute="float32", model="lse"):
    return ModelConfig(model=model, vocab_size=V, num_entities=E,
                       word_dim=DW, entity_dim=DE, compute_dtype=compute)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "word_emb": rng.normal(size=(V, DW)).astype(np.float32) / 4,
        "proj_w": rng.normal(size=(DW, DE)).astype(np.float32) / 4,
        "proj_b": rng.normal(size=(DE,)).astype(np.float32) / 4,
        "entity_emb": rng.normal(size=(E, DE)).astype(np.float32),
    }


def _windows(seed=1):
    rng = np.random.default_rng(seed)
    windows = rng.integers(0, V, size=(B, W)).astype(np.int32)
    lengths = rng.integers(0, W + 1, size=(B,)).astype(np.int32)
    lengths[0] = 0                      # an all-OOV query
    return windows, lengths


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_window_rep_matches_reference(compute):
    cfg = _cfg(compute)
    p = _np_params()
    windows, lengths = _windows()
    want = np.asarray(ref_lse.window_rep(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(windows),
        jnp.asarray(lengths), cfg))
    got = lse.window_rep(params_from_jax(p), torch.from_numpy(windows),
                         torch.from_numpy(lengths), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL[compute])


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_query_reps_match_reference(compute, similarity):
    cfg = _cfg(compute)
    p = _np_params(2)
    windows, lengths = _windows(3)
    want, _, want_mask = ref_scorer._query_reps_and_terms(
        {k: jnp.asarray(v) for k, v in p.items()}, cfg,
        jnp.asarray(windows), jnp.asarray(lengths), similarity)
    got, _, mask = scorer._query_reps_and_terms(
        params_from_jax(p), cfg, torch.from_numpy(windows),
        torch.from_numpy(lengths), similarity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL[compute])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_query_scores_match_reference(similarity):
    cfg = _cfg()
    p = _np_params(4)
    ids = np.array([3, 7, 11, 0], np.int32)
    want = np.asarray(ref_lse.query_scores(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(ids),
        jnp.asarray(3), cfg, similarity))
    got = api.query_scores(params_from_jax(p), torch.from_numpy(ids),
                           torch.tensor(3), cfg, similarity)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_entity_matrix_is_normalized_in_fp32():
    cfg = _cfg()
    p = _np_params(5)
    want = np.asarray(ref_scorer._entity_matrix(
        {k: jnp.asarray(v) for k, v in p.items()}, cfg, "cosine"))
    got = scorer._entity_matrix(params_from_jax(p), cfg, "cosine")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_masked_mean_pool_zero_length_is_zero():
    rows = torch.ones(2, 3, 4)
    out = common.masked_mean_pool(rows, torch.tensor([0, 2]))
    assert torch.equal(out[0], torch.zeros(4))
    assert torch.equal(out[1], torch.ones(4))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_keeps_reference_keys_layouts_and_seed(param_dtype):
    cfg = dataclasses.replace(_cfg(), param_dtype=param_dtype)
    p1 = api.init_params(torch.Generator().manual_seed(7), cfg)
    p2 = api.init_params(torch.Generator().manual_seed(7), cfg)
    shapes = {k: tuple(v.shape) for k, v in p1.items()}
    assert shapes == {"word_emb": (V, DW), "proj_w": (DW, DE),
                      "proj_b": (DE,), "entity_emb": (E, DE)}
    assert {v.dtype for v in p1.values()} == {common.param_dtype(cfg)}
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    std = p1["entity_emb"].float().std().item()
    assert abs(std - DE ** -0.5) < 0.05


def test_loglinear_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        api.entity_matrix({}, _cfg(model="loglinear"))


class TestParamsFromJax:
    def test_fp32_round_trip(self):
        p = _np_params()
        back = params_to_numpy(params_from_jax(p))
        for k in p:
            np.testing.assert_array_equal(back[k], p[k])

    def test_bf16_carrier_is_viewed_not_cast(self):
        p = _np_params()
        ref = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
        carrier = {k: np.asarray(v).view(np.uint16) for k, v in ref.items()}
        t = params_from_jax(carrier)
        assert {v.dtype for v in t.values()} == {torch.bfloat16}
        for k in p:
            np.testing.assert_array_equal(
                t[k].float().numpy(), np.asarray(ref[k], np.float32))
            np.testing.assert_array_equal(params_to_numpy(t)[k], carrier[k])

    def test_ml_dtypes_bf16_and_dtype_cast(self):
        p = _np_params()
        ref = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
               for k, v in p.items()}
        t = params_from_jax(ref, dtype=torch.float32)
        for k in p:
            assert t[k].dtype == torch.float32
            np.testing.assert_array_equal(t[k].numpy(),
                                          ref[k].astype(np.float32))

    def test_jax_and_port_agree_on_converted_params(self):
        """The same numbers reach both packages: dense scores agree."""
        cfg = _cfg()
        p = _np_params(9)
        windows, lengths = _windows(9)
        want = np.asarray(ref_scorer.dense_scores(
            {k: jnp.asarray(v) for k, v in p.items()}, cfg,
            jnp.asarray(windows), jnp.asarray(lengths), "cosine"))
        got = scorer.dense_scores(params_from_jax(p), cfg,
                                  torch.from_numpy(windows),
                                  torch.from_numpy(lengths), "cosine")
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
