"""The training mix is the recipes' stand-in collection: its parameters
are ``SYNTH_1M``'s and ``SYNTH_10M``'s, its documents per entity are
``make_synthetic``'s, and the windows it writes have the stand-in's
statistics in the format the port's ``InstanceDataset`` reads."""

from __future__ import annotations

import inspect
import json
import os

import numpy as np
import pytest

from portbench import fixture

TRAFFIC = json.loads(open(os.path.join(
    os.path.dirname(__file__), "..", "traffic", "train.json")).read())


@pytest.mark.parametrize("recipe", ["synthetic_1m_retrieval",
                                    "synthetic_10m_training"])
def test_the_mix_is_the_recipes_stand_in(recipe):
    from sert_tpu_torch.data.synthetic import make_synthetic
    from sert_tpu_torch.recipes import SYNTH_SPECS
    spec = SYNTH_SPECS[recipe]
    defaults = inspect.signature(make_synthetic).parameters
    assert spec.hard
    assert (TRAFFIC["docs_per_entity"], TRAFFIC["doc_len"],
            TRAFFIC["signature_size"], TRAFFIC["signal"]) == (
        spec.docs_per_entity, spec.doc_len, spec.signature_size, spec.signal)
    assert TRAFFIC["doc_skew"] == defaults["doc_skew"].default
    assert TRAFFIC["group_size"] == defaults["group_size"].default


@pytest.mark.parametrize("num_entities", [7, 300, 1001])
def test_documents_per_entity_are_the_stand_ins(num_entities):
    from sert_tpu_torch.data.synthetic import make_synthetic
    col = make_synthetic(num_entities=num_entities, vocab_size=400,
                         docs_per_entity=TRAFFIC["docs_per_entity"],
                         doc_len=TRAFFIC["doc_len"], num_topics=1, seed=3,
                         hard=True, signal=TRAFFIC["signal"],
                         signature_size=TRAFFIC["signature_size"])
    index = {e: i for i, e in enumerate(col.entities)}
    theirs = np.zeros(num_entities, np.int64)
    for ents in col.doc_entities.values():
        for e in ents:
            theirs[index[e]] += 1
    np.testing.assert_array_equal(
        fixture.documents(num_entities, TRAFFIC), theirs)


def test_an_epoch_is_the_recipes():
    # synthetic_10m_training's docstring: 500.5M instances an epoch.
    assert fixture.epoch_windows(10_000_000, 8, TRAFFIC) == 500_528_325
    assert fixture.epoch_windows(1_000_000, 8, TRAFFIC) == 49_805_151


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_windows_have_the_stand_ins_statistics(tmp_path, seed):
    from sert_tpu_torch.data.instances import InstanceDataset
    V, E, n = 5000, 400, 40_000
    meta, counts = fixture.write_shards(
        str(tmp_path), TRAFFIC, vocab_size=V, num_entities=E,
        num_instances=n, window=8, per_shard=7000, seed=seed)
    assert meta["num_instances"] == n
    assert [s["num"] for s in meta["shards"]] == [7000] * 5 + [5000]
    np.testing.assert_array_equal(counts, fixture.documents(E, TRAFFIC))
    ds = InstanceDataset(str(tmp_path), seed=1)
    batches = list(ds.iter_batches(1000, epoch=0))
    assert len(batches) == n // 1000
    shards = [fixture.read_shard(str(tmp_path), s["path"])
              for s in meta["shards"]]
    win = np.concatenate([s["windows"] for s in shards])
    ents = np.concatenate([s["entities"] for s in shards])
    assert (np.concatenate([s["lengths"] for s in shards]) == 8).all()
    # Entities carry windows in proportion to their documents.
    share = np.bincount(ents, minlength=E) / n
    want = counts / counts.sum()
    assert np.abs(share - want).sum() < 0.12     # 0.52 for a uniform draw
    # Terms: the signal share from the entity's signature, the rest from
    # the background Zipf, whose head is id 0.
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(2)[0])
    sig = fixture.signatures(rng, E, V, TRAFFIC)
    in_sig = (win[:, :, None] == sig[ents][:, None, :]).any(-1).mean()
    assert in_sig == pytest.approx(TRAFFIC["signal"], abs=5e-3)
    zipf_head = 1.0 / np.sum(1.0 / np.arange(1, V + 1))
    assert (win == 0).mean() == pytest.approx(
        (1 - TRAFFIC["signal"]) * zipf_head, rel=0.05)
    # A group's members share the first half of their signatures.
    half = TRAFFIC["signature_size"] // 2
    g = TRAFFIC["group_size"]
    assert (sig[:g, :half] == sig[0, :half]).all()
    assert (sig[:, half:] >= V * TRAFFIC["signature_floor_share"]).all()


def test_the_same_seed_writes_the_same_shards(tmp_path):
    for d in ("a", "b"):
        fixture.write_shards(str(tmp_path / d), TRAFFIC, vocab_size=900,
                             num_entities=50, num_instances=3000, window=8,
                             per_shard=1024, seed=2 ** 33 + 1)
    for name in ("shard-00000.npz", "shard-00002.npz"):
        a = fixture.read_shard(str(tmp_path / "a"), name)
        b = fixture.read_shard(str(tmp_path / "b"), name)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
