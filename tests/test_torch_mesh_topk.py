"""The port's entity-sharded serving (sert_tpu_torch.parallel.topk,
scoring.run's distributed engine, EntitySearcher in lockstep) on gloo
worlds of 8 and 2 CPU ranks and on one, held against the reference
(sert_tpu) on the same numpy params and queries.

Counterparts of tests/test_parallel.py:229-305: both merges x the binmax,
scan and pallas (K3/K4's plain versions on the CPU) local engines x LSE and
log-linear at meshes (2, 4), (1, 8) and (1, 2); k larger than a shard; an
uneven shard rejected; params already sharded. Ids are equal to the
reference's streaming engine's; scores within 1e-5, or for log-linear
within 1e-5 x max(|score|, |its un-normalized sum|) (the global normalizer
sums per-shard partials in another order).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu.models import api as ref_api  # noqa: E402
from sert_tpu.scoring import run as ref_run  # noqa: E402
from sert_tpu.scoring.scorer import ll_log_normalizer  # noqa: E402
from sert_tpu.scoring.scorer import streaming_topk  # noqa: E402
from sert_tpu.utils import config as rc  # noqa: E402
from sert_tpu_torch import pipeline, recipes  # noqa: E402
from sert_tpu_torch.data.instances import InstanceDataset  # noqa: E402
from sert_tpu_torch.data.prepare import encode_queries  # noqa: E402
from sert_tpu_torch.eval.trec import read_topics, write_topics  # noqa: E402
from sert_tpu_torch.parallel.dryrun import launch  # noqa: E402
from sert_tpu_torch.parallel.topk import resolve_local_engine  # noqa: E402
from sert_tpu_torch.scoring import run  # noqa: E402
from sert_tpu_torch.serving import EntitySearcher  # noqa: E402
from sert_tpu_torch.utils.config import ModelConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {
    "loglinear": ModelConfig(model="loglinear", vocab_size=50,
                             num_entities=40, word_dim=8),
    "lse": ModelConfig(model="lse", vocab_size=50, num_entities=40,
                       word_dim=8, entity_dim=8, num_negatives=4),
}
ENGINES = ["binmax", "scan", "pallas"]
MERGES = ["allgather", "ring"]
GRID = [(c, m, e) for c in CFGS for m in MERGES for e in ENGINES]


def _ref_cfg(cfg):
    return rc.ModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=7):
    p = ref_api.init_params(jax.random.key(seed), _ref_cfg(cfg))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _queries(seed=7, Q=8, T=3, V=50):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (Q, T)).astype(np.int32),
            rng.integers(1, T + 1, Q).astype(np.int32))


def _want(cfg, params, t, n, k):
    """The reference's streaming engine: (scores, ids, un-normalized
    scores) as numpy."""
    p = {k_: jnp.asarray(v) for k_, v in params.items()}
    s, i = streaming_topk(p, _ref_cfg(cfg), jnp.asarray(t), jnp.asarray(n),
                          k=k, chunk=16)
    s, i = np.asarray(s), np.asarray(i)
    raw = s
    if cfg.model == "loglinear":
        const = np.asarray(ll_log_normalizer(p, _ref_cfg(cfg),
                                             jnp.asarray(t), jnp.asarray(n)))
        raw = s + const[:, None]
    return s, i, raw


def _assert_topk(got, want, is_ll):
    s, i = got
    ws, wi, raw = want
    np.testing.assert_array_equal(i, wi)
    tol = 1e-5 * np.maximum(np.abs(ws), np.abs(raw)) if is_ll else 1e-5
    assert np.all(np.abs(s - ws) <= tol), np.abs(s - ws).max()


def _case(cfg_name, merge, engine, k=8, sharded=False, E=None, seed=7):
    cfg = CFGS[cfg_name]
    if E is not None:
        cfg = cfg.replace(num_entities=E)
    t, n = _queries(seed)
    return dict(cfg=cfg, params=_params(cfg, seed), term_ids=t,
                num_terms=n, k=k, chunk=8, merge=merge, engine=engine,
                sharded=sharded)


EXTRA_8 = {  # (1, 8): k = 16 above a shard's 5 rows; an uneven shard
    "k16-binmax": _case("lse", "allgather", "binmax", k=16, seed=9),
    "k16-pallas": _case("lse", "allgather", "pallas", k=16, seed=9),
    "uneven": _case("lse", "allgather", "binmax", E=42, seed=0),
}
SHARDED_24 = _case("lse", "allgather", "binmax", sharded=True, seed=1)


def _lse_recipe():
    r = recipes.tiny_recipe("lse", objective="sampled_softmax")
    return dataclasses.replace(
        r, train=dataclasses.replace(r.train, num_epochs=1,
                                     log_every_steps=0),
        score=dataclasses.replace(r.score, engine="distributed",
                                  merge="ring"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny sampled-softmax LSE run the port trained on the CPU, with its
    topics: (recipe, data dir, run dir, topics)."""
    root = tmp_path_factory.mktemp("dist_run")
    r = _lse_recipe()
    col = recipes.tiny_spec(seed=7).build()
    data, run_dir = str(root / "data"), str(root / "run")
    pipeline.prepare_collection(col, data, r)
    pipeline.train_from_dir(r, data, run_dir, device="cpu")
    write_topics(col.topics, str(root / "topics.tsv"))
    return r, data, run_dir, read_topics(str(root / "topics.tsv"))


@pytest.fixture(scope="module")
def worlds(trained):
    r, data, run_dir, topics = trained
    texts = [topics[q] for q in sorted(topics)]
    jobs8 = []
    for mesh in [(2, 4), (1, 8)]:
        jobs8.append(("topk", dict(mesh=mesh, cases=[_case(*g)
                                                     for g in GRID])))
    jobs8.append(("topk", dict(mesh=(1, 8), cases=list(EXTRA_8.values()))))
    jobs8.append(("topk", dict(mesh=(2, 4), cases=[SHARDED_24])))
    out8 = launch(8, "sert_tpu_torch.parallel.worlds:run_jobs", jobs8)
    fold = [("folded_entity", " ".join(texts[3:5]))]
    jobs2 = [("topk", dict(mesh=(1, 2), cases=[_case(*g) for g in GRID])),
             ("searcher", dict(recipe=r, data=data, run=run_dir,
                               queries=texts[:3], fold=fold))]
    out2 = launch(2, "sert_tpu_torch.parallel.worlds:run_jobs", jobs2)
    return {"(2, 4)": [o[0] for o in out8], "(1, 8)": [o[1] for o in out8],
            "extra": [o[2] for o in out8], "sharded": [o[3] for o in out8],
            "(1, 2)": [o[0] for o in out2], "searcher": [o[1] for o in out2],
            "fold": fold, "queries": texts[:3]}


class TestDistributedTopk:
    @pytest.mark.parametrize("mesh", ["(2, 4)", "(1, 8)", "(1, 2)"])
    @pytest.mark.parametrize("cfg_name,merge,engine", GRID,
                             ids=["-".join(g) for g in GRID])
    def test_matches_reference(self, worlds, mesh, cfg_name, merge, engine):
        case = _case(cfg_name, merge, engine)
        want = _want(case["cfg"], case["params"], case["term_ids"],
                     case["num_terms"], case["k"])
        results = worlds[mesh]
        j = GRID.index((cfg_name, merge, engine))
        for r in results:       # every rank returns the global answer
            _assert_topk(r[j], want, cfg_name == "loglinear")

    @pytest.mark.parametrize("name", ["k16-binmax", "k16-pallas"])
    def test_local_engine_k_exceeds_shard(self, worlds, name):
        case = EXTRA_8[name]
        want = _want(case["cfg"], case["params"], case["term_ids"],
                     case["num_terms"], 16)
        got = worlds["extra"][0][list(EXTRA_8).index(name)]
        _assert_topk(got, want, False)

    def test_uneven_shard_rejected(self, worlds):
        got = worlds["extra"][0][list(EXTRA_8).index("uneven")]
        assert isinstance(got, str) and "must divide" in got

    def test_sharded_params_stay_sharded(self, worlds):
        c = SHARDED_24
        want = _want(c["cfg"], c["params"], c["term_ids"], c["num_terms"], 8)
        _assert_topk(worlds["sharded"][0][0], want, False)

    def test_auto_local_engine(self):
        assert resolve_local_engine("auto", torch.device("cuda"), 128) == \
            "pallas"
        assert resolve_local_engine("auto", torch.device("cuda"), 10_000) \
            == "binmax"
        assert resolve_local_engine("auto", torch.device("cpu"), 128) == \
            "binmax"
        with pytest.raises(ValueError, match="local engine"):
            resolve_local_engine("fast", torch.device("cpu"), 128)


def _meta(data):
    return InstanceDataset(data).meta


def _encoded(trained):
    r, data, run_dir, topics = trained
    params, vocab, registry = pipeline.load_scorer(
        run_dir, data, pipeline.resolve_model_config(r, _meta(data)),
        device="cpu")
    return params, encode_queries(topics, vocab, r.data), registry


class TestDistributedEngine:
    def test_one_rank_equals_the_exact_engines_and_the_reference(
            self, trained):
        """engine="distributed" answers on one device: equal to the
        streaming scan and to the reference's distributed engine."""
        r, data, run_dir, topics = trained
        resolved = pipeline.resolve_model_config(r, _meta(data))
        params, encoded, registry = _encoded(trained)
        names = registry.names
        got = run.score_topics(params, resolved.model, encoded, names,
                               resolved.score)
        exact = run.score_topics(params, resolved.model, encoded, names,
                                 dataclasses.replace(resolved.score,
                                                     engine="streaming"))
        ref_r = rc.RecipeConfig(
            name="r", model=_ref_cfg(resolved.model),
            score=rc.ScoreConfig(**{**dataclasses.asdict(resolved.score),
                                    "mesh_shape": (1, -1)}))
        ref_params, _, _ = ref_pipeline.load_scorer(run_dir, data, ref_r)
        want = ref_run.score_topics(ref_params, ref_r.model, encoded, names,
                                    ref_r.score)
        for other in (exact, want):
            assert set(got) == set(other)
            for q in got:
                assert [n for n, _ in got[q]] == [n for n, _ in other[q]]
                np.testing.assert_allclose([s for _, s in got[q]],
                                           [s for _, s in other[q]],
                                           atol=1e-5)

    def test_searcher_on_one_rank_keeps_only_the_staged_params(
            self, trained):
        r, data, run_dir, topics = trained
        queries = [topics[q] for q in sorted(topics)][:3]
        s = EntitySearcher(r, data, run_dir, k=10, device="cpu")
        assert s.engine == "distributed"
        assert s.params is s.prep.params
        exact = EntitySearcher(dataclasses.replace(
            r, score=dataclasses.replace(r.score, engine="streaming")),
            data, run_dir, k=10, device="cpu")
        for a, b in zip(s.search_many(queries), exact.search_many(queries)):
            assert [n for n, _ in a] == [n for n, _ in b]
            np.testing.assert_allclose([x for _, x in a], [x for _, x in b],
                                       atol=1e-5)
        s.close()      # a no-op at one rank

    def test_searcher_in_lockstep_on_two_ranks(self, worlds, trained):
        """Rank 0 serves the queries and a gradient fold-in (the trained
        rows' sample travels to the follower); the answers equal one
        rank's exact searcher with the same fold-in."""
        r, data, run_dir, _ = trained
        got = worlds["searcher"][0]
        assert worlds["searcher"][1] == {"rank": 1}
        exact = EntitySearcher(dataclasses.replace(
            r, score=dataclasses.replace(r.score, engine="streaming")),
            data, run_dir, k=10, device="cpu")
        before = exact.search_many(worlds["queries"])
        exact.add_entities(worlds["fold"], method="gradient")
        after = exact.search_many(worlds["queries"])
        assert got["added"] == 1
        np.testing.assert_allclose(got["stats"], exact._trained_stats(),
                                   rtol=1e-6)
        for g, w in zip(got["hits"] + got["after"], before + after):
            assert [n for n, _ in g] == [n for n, _ in w]
            np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                                       atol=1e-5)


def test_cli_under_torchrun_on_two_cpu_ranks(tmp_path):
    """``torchrun --nproc_per_node 2 -m sert_tpu_torch train|query``
    with ``--device cpu`` (gloo): a (1, 2) mesh recipe trains on both
    ranks and its checkpoint is the one-rank run's; ``query`` through the
    distributed engine writes (from rank 0) the one-rank streaming
    engine's run."""
    import subprocess
    import sys
    from sert_tpu_torch import cli
    from sert_tpu_torch.eval.trec import read_run
    from sert_tpu_torch.train import checkpoint as ckpt
    from sert_tpu_torch.utils.config import save_config
    r = _lse_recipe()
    r = dataclasses.replace(r, train=dataclasses.replace(r.train,
                                                         mesh_shape=(1, 2)))
    one = dataclasses.replace(
        r, train=dataclasses.replace(r.train, mesh_shape=(1, 1)),
        score=dataclasses.replace(r.score, engine="streaming"))
    paths = {n: str(tmp_path / n) for n in ("r.json", "one.json", "data",
                                            "run", "run1", "d.trec",
                                            "s.trec")}
    save_config(r, paths["r.json"])
    save_config(one, paths["one.json"])
    assert cli.main(["prepare", "--recipe", paths["r.json"], "--out",
                     paths["data"]]) == 0
    topics = paths["data"] + "/topics.tsv"
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", "-m", "sert_tpu_torch"]
    for args in (["train", "--recipe", paths["r.json"], "--data",
                  paths["data"], "--out", paths["run"], "--device", "cpu"],
                 ["query", "--recipe", paths["r.json"], "--data",
                  paths["data"], "--run-dir", paths["run"], "--topics",
                  topics, "--out", paths["d.trec"], "--device", "cpu"]):
        proc = subprocess.run(torchrun + args, capture_output=True,
                              text=True, timeout=300, cwd=tmp_path,
                              env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, (args[0], proc.stderr[-3000:])
    assert cli.main(["train", "--recipe", paths["one.json"], "--data",
                     paths["data"], "--out", paths["run1"], "--device",
                     "cpu"]) == 0
    assert cli.main(["query", "--recipe", paths["one.json"], "--data",
                     paths["data"], "--run-dir", paths["run"], "--topics",
                     topics, "--out", paths["s.trec"], "--device",
                     "cpu"]) == 0
    got, want = read_run(paths["d.trec"]), read_run(paths["s.trec"])
    assert got.keys() == want.keys()
    for q in got:
        assert [n for n, _ in got[q]] == [n for n, _ in want[q]]
    mesh_ck = ckpt.load_params(ckpt.latest_checkpoint(paths["run"] +
                                                      "/checkpoints"))
    one_ck = ckpt.load_params(ckpt.latest_checkpoint(paths["run1"] +
                                                     "/checkpoints"))
    for k, v in one_ck.items():
        np.testing.assert_allclose(mesh_ck[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
