"""The port's run-reading workflows against the reference's on one run:
``sweep`` (choose the epoch snapshot by metric), ``dump`` (npz and
word2vec), ``train --init-word-emb`` (seed a run from a dump) and
``neighbors``.

Tiny runs are trained once by the reference: an LSE run of two epochs with
mid-epoch checkpoints between its bf16 params-only epoch snapshots, and a
log-linear run (whose dump carries ``entity_bias``). Both packages then
read the same files on the CPU. Dumped arrays, word2vec files and the
neighbours' lines are held byte for byte; sweep metrics to 1e-6 (the same
fp32 scores, summed in another order).
"""

import dataclasses
import json
import logging
import os
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sert_tpu import cli as ref_cli  # noqa: E402
from sert_tpu import pipeline as ref_pipeline  # noqa: E402
from sert_tpu import recipes  # noqa: E402
from sert_tpu.data.assoc import EntityRegistry  # noqa: E402
from sert_tpu.data.vocab import Vocabulary  # noqa: E402
from sert_tpu.eval.trec import write_qrels, write_topics  # noqa: E402
from sert_tpu.utils.config import save_config  # noqa: E402
from sert_tpu_torch import cli, pipeline  # noqa: E402
from sert_tpu_torch.train import checkpoint as ckpt  # noqa: E402


def _train_run(root, model, epochs, **train_kw):
    """A reference-trained tiny run: (recipe JSON, data dir, run dir,
    topics file, qrels file)."""
    kw = {"objective": "sampled_softmax"} if model == "lse" else {}
    r = recipes.tiny_recipe(model, **kw)
    r = dataclasses.replace(r, train=dataclasses.replace(
        r.train, num_epochs=epochs, **train_kw))
    col = recipes.tiny_spec(seed=7).build()
    data, run = str(root / "data"), str(root / "run")
    ref_pipeline.prepare_collection(col, data, r)
    ref_pipeline.train_from_dir(r, data, run, resume=False)
    recipe_path = str(root / "recipe.json")
    save_config(r, recipe_path)
    write_topics(col.topics, str(root / "topics.tsv"))
    write_qrels(col.qrels, str(root / "qrels.trec"))
    return (recipe_path, data, run, str(root / "topics.tsv"),
            str(root / "qrels.trec"))


@pytest.fixture(scope="module")
def lse_run(tmp_path_factory):
    return _train_run(tmp_path_factory.mktemp("lse"), "lse", 2,
                      checkpoint_every_steps=40, epoch_snapshot="params",
                      snapshot_dtype="bfloat16")


@pytest.fixture(scope="module")
def ll_run(tmp_path_factory):
    return _train_run(tmp_path_factory.mktemp("ll"), "loglinear", 1)


def _args(run, *rest):
    recipe, data, run_dir = run[:3]
    return ["--recipe", recipe, "--data", data, "--run-dir", run_dir, *rest]


# --- sweep ------------------------------------------------------------------

def test_sweep_matches_reference_and_skips_mid_epoch_checkpoints(
        lse_run, capsys):
    recipe_path, data, run_dir, topics, qrels = lse_run
    metas = {s: ckpt.load_meta(p) for s, p in ckpt.list_checkpoints(
        os.path.join(run_dir, "checkpoints")).items()}
    epochs = {str(s) for s, m in metas.items() if m.get("cursor") is None}
    assert len(epochs) == 2 and len(metas) > len(epochs)
    recipe = cli.load_recipe(recipe_path)
    want = ref_pipeline.sweep_checkpoints(recipe, data, run_dir, topics,
                                          qrels)
    got = pipeline.sweep_checkpoints(recipe, data, run_dir, topics, qrels,
                                     device="cpu")
    assert set(got["per_step"]) == set(want["per_step"]) == epochs
    for step, value in want["per_step"].items():
        assert abs(got["per_step"][step] - value) <= 1e-6
    assert got["best_step"] == want["best_step"]
    assert got["measure"] == "ndcg@100"
    assert cli.main(["sweep", *_args(lse_run, "--topics", topics, "--qrels",
                                     qrels, "--device", "cpu")]) == 0
    assert json.loads(capsys.readouterr().out) == got


def test_sweep_refuses_a_checkpoint_of_another_vocabulary(lse_run, tmp_path):
    recipe_path, data, run_dir, topics, qrels = lse_run
    run_copy = str(tmp_path / "run")
    shutil.copytree(run_dir, run_copy)
    ckpt_dir = os.path.join(run_copy, "checkpoints")
    step = max(ckpt.list_checkpoints(ckpt_dir))
    meta = ckpt.load_meta(ckpt.list_checkpoints(ckpt_dir)[step])
    meta.pop("step")
    ckpt.rewrite_meta(ckpt_dir, step, {**meta, "vocab_hash": "0" * 16})
    recipe = cli.load_recipe(recipe_path)
    for sweep in (ref_pipeline.sweep_checkpoints,
                  lambda *a: pipeline.sweep_checkpoints(*a, device="cpu")):
        with pytest.raises(ValueError, match="different vocabulary"):
            sweep(recipe, data, run_copy, topics, qrels)


# --- dump ---------------------------------------------------------------------

def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("which", ["lse", "loglinear"])
def test_dump_npz_members_equal_the_reference_bytes(which, lse_run, ll_run,
                                                    tmp_path):
    run = lse_run if which == "lse" else ll_run
    out = {n: str(tmp_path / f"{n}.npz") for n in ("ref", "port")}
    assert ref_cli.main(["dump", *_args(run, "--out", out["ref"])]) == 0
    assert cli.main(["dump", *_args(run, "--out", out["port"], "--device",
                                    "cpu")]) == 0
    got, want = _members(out["port"]), _members(out["ref"])
    assert got == want
    names = {"word_emb.npy", "entity_matrix.npy", "terms.npy",
             "entities.npy"}
    assert set(got) == (names | {"entity_bias.npy"}
                        if which == "loglinear" else names)
    with np.load(out["port"], allow_pickle=True) as z:
        assert z["word_emb"].dtype == np.float32
        assert z["terms"].dtype == object


@pytest.mark.parametrize("out_name", ["vecs", "vecs.npz"])
def test_dump_word2vec_equals_the_reference_bytes(out_name, lse_run,
                                                  tmp_path):
    for pkg, main in (("ref", ref_cli.main), ("port", cli.main)):
        os.makedirs(tmp_path / pkg)
        extra = ["--device", "cpu"] if pkg == "port" else []
        assert main(["dump", *_args(lse_run, "--out",
                                    str(tmp_path / pkg / out_name),
                                    "--format", "word2vec", *extra)]) == 0
    for suffix in ("words.vec", "entities.vec"):
        name = f"vecs.{suffix}"
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "ref" / name).read_bytes()
        header = got.split(b"\n", 1)[0].split()
        assert len(header) == 2 and int(header[1]) == 32


# --- train --init-word-emb ------------------------------------------------------

class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_init_word_emb_from_a_dump_matches_reference(lse_run, tmp_path):
    """The port's dump seeds a new run: the rows and the hit count are the
    reference's; the CLI trains from it and logs the count."""
    recipe_path, data = lse_run[:2]
    npz = str(tmp_path / "dump.npz")
    assert cli.main(["dump", *_args(lse_run, "--out", npz, "--device",
                                    "cpu")]) == 0
    vocab = Vocabulary.load(os.path.join(data, "vocab.json"))
    base = np.random.default_rng(3).normal(
        size=(len(vocab), 32)).astype(np.float32)
    want, want_hits = ref_pipeline.load_pretrained_word_emb(npz, vocab, base)
    got, hits = pipeline.load_pretrained_word_emb(npz, vocab, base)
    assert hits == want_hits == len(vocab)
    np.testing.assert_array_equal(got, want)
    with np.load(npz, allow_pickle=True) as z:
        np.testing.assert_array_equal(got, z["word_emb"])

    records = _Records()
    logger = logging.getLogger("sert_tpu.pipeline")
    logger.addHandler(records)
    try:
        assert cli.main(["train", "--recipe", recipe_path, "--data", data,
                         "--out", str(tmp_path / "seeded"),
                         "--init-word-emb", npz, "--device", "cpu"]) == 0
    finally:
        logger.removeHandler(records)
    assert (f"init: seeded {hits}/{len(vocab)} word embeddings from {npz}"
            in records.messages)
    assert ckpt.latest_checkpoint(str(tmp_path / "seeded" / "checkpoints"))


def test_init_word_emb_refuses_a_file_that_is_not_a_dump(lse_run, tmp_path):
    data = lse_run[1]
    vocab = Vocabulary.load(os.path.join(data, "vocab.json"))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, entity_matrix=np.zeros((2, 32), np.float32))
    with pytest.raises(ValueError, match="not a dump npz"):
        pipeline.load_pretrained_word_emb(bad, vocab, np.zeros((3, 32)))
    wide = str(tmp_path / "wide.npz")
    np.savez(wide, word_emb=np.zeros((1, 8), np.float32),
             terms=np.asarray(["a"], dtype=object))
    with pytest.raises(ValueError, match="word_dim"):
        pipeline.load_pretrained_word_emb(wide, vocab, np.zeros((3, 32)))


# --- neighbors ---------------------------------------------------------------

@pytest.mark.parametrize("which", ["lse", "loglinear"])
@pytest.mark.parametrize("space", ["entity", "term"])
def test_neighbors_equal_the_reference(space, which, lse_run, ll_run,
                                       capsys):
    run = lse_run if which == "lse" else ll_run
    data = run[1]
    if space == "entity":
        names = EntityRegistry.load(os.path.join(data,
                                                 "entities.json")).names
        query = ["--entity", names[3]]
    else:
        vocab = Vocabulary.load(os.path.join(data, "vocab.json"))
        query = ["--term", list(vocab.iter_terms())[5].upper()]
    assert ref_cli.main(["neighbors", *_args(run, *query, "-k", "7")]) == 0
    want = capsys.readouterr().out
    assert cli.main(["neighbors", *_args(run, *query, "-k", "7",
                                         "--device", "cpu")]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 7


def test_neighbors_needs_exactly_one_query(lse_run):
    with pytest.raises(SystemExit, match="exactly one"):
        cli.main(["neighbors", *_args(lse_run, "--device", "cpu")])
    with pytest.raises(SystemExit, match="not in the vocabulary"):
        cli.main(["neighbors", *_args(lse_run, "--term", "zzqqxx",
                                      "--device", "cpu")])
