"""End-to-end smoke run of the PyTorch / H100 port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device: the card, its power limit; TF32 off for the fp32 references;
  2. build: nvcc compiles sert_tpu_torch/csrc into build/;
  3. kernels: K3 (score + bin-max, with and without bias) and K4
     (gather-rescore, fp32 and bf16 rows) against their plain PyTorch
     versions at the serving shapes (Q=64, E=1M, d=128, bw=128, NB=1012),
     with CUDA-event times for both;
  4. serve: a random-weight synthetic_1m_retrieval checkpoint at full width
     (V=250k, E=1M) behind the port's EntitySearcher: one search, then
     200 queries; recall against an fp32 dense oracle and score agreement.
     The oracle builds the query reps and the normalized entity matrix with
     the same port functions the searcher uses, so it checks the K3 + K4
     engine and the top-k, not the query encoding (the CPU tests hold that
     against the JAX reference);
  5. cli: `python -m sert_tpu_torch query` and `evaluate` on the same data.
Then one JSON line of kernel records, and the device record as the last line.

Imports nothing of JAX and nothing of the JAX package by name; only
`sert_tpu_torch`. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
RECIPE = "synthetic_1m_retrieval"
V, E = 250_000, 1_000_000  # SYNTH_1M's vocabulary and entities
Q, D, BW, K = 64, 128, 128, 1000
TOL = dict(rtol=1e-5, atol=1e-5)
RECALL_MIN = 0.99
SCORE_TOL = 1e-5
N_QUERIES = 200        # SYNTH_1M.num_topics


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``iters`` launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from sert_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=_build.last_build_seconds, lib=os.path.relpath(path))


def phase_kernels() -> dict:
    """Both kernels against their plain versions on the same inputs, each
    in the variant the serving path runs and in its other variant."""
    import torch
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.ops.exact_topk import PAD_BINS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    R = torch.randn(Q, D, generator=g, device=dev)
    R = R / R.norm(dim=1, keepdim=True)
    M = torch.randn(E, D, generator=g, device=dev)
    M = M / M.norm(dim=1, keepdim=True)
    bias = 0.1 * torch.randn(E, generator=g, device=dev)
    alpha = torch.randint(1, 9, (Q,), generator=g, device=dev).float()
    Mp = k3.prepare_binmax_matrix(M)
    records = {}

    def compare(name, variant, kernel, plain, source, replaces):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        say("kernels", name=name, variant=variant, max_abs_err=err,
            rtol=TOL["rtol"], atol=TOL["atol"], ms=ms, plain_ms=plain_ms)
        rec = records.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        return got

    src3 = "sert_tpu_torch/csrc/score_binmax.cu"
    bins = compare(
        "score_binmax", "nobias",
        lambda: k3.score_binmax_prepared(R, Mp, E, bin_width=BW),
        lambda: k3.score_binmax_plain(R, Mp, E, bin_width=BW),
        src3, "sert_tpu/ops/score_binmax.py:57")
    compare(
        "score_binmax", "bias",
        lambda: k3.score_binmax_prepared(R, Mp, E, bias, alpha, BW),
        lambda: k3.score_binmax_plain(R, Mp, E, bias, alpha, BW),
        src3, "sert_tpu/ops/score_binmax.py:51")
    bin_idx = torch.topk(bins, K + PAD_BINS, dim=1).indices.int()
    n_bins = bins.shape[1]
    M_binned = torch.nn.functional.pad(M, (0, 0, 0, n_bins * BW - E))
    M_binned = M_binned.view(n_bins, BW, D)
    src4 = "sert_tpu_torch/csrc/gather_rescore.cu"
    for variant, mb in (("float32", M_binned),
                        ("bfloat16", M_binned.bfloat16())):
        compare("gather_rescore", variant,
                lambda: k4.gather_rescore(R, mb, bin_idx),
                lambda: k4.gather_rescore_plain(R, mb, bin_idx),
                src4, "sert_tpu/ops/gather_rescore.py:31")
    return records


def full_width_searcher(root: str):
    """Write a random-weight RECIPE serving fixture at full width under
    ``root`` and stage the port's EntitySearcher on it, with peak memory
    counted from the load. Returns (searcher, data_dir, run_dir, topics,
    fixture seconds, load + stage + warm-up seconds)."""
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.fixture import write_serving_fixture
    from sert_tpu_torch.serving import EntitySearcher

    recipe = load_recipe(RECIPE)
    t0 = time.perf_counter()
    data_dir, run_dir, topics = write_serving_fixture(
        root, recipe, V, E, N_QUERIES, seed=SEED, device="cuda")
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    searcher = EntitySearcher(recipe, data_dir, run_dir, k=K, query_batch=Q)
    t2 = time.perf_counter()
    if searcher.engine != "pallas":
        raise AssertionError(f"engine {searcher.engine}, not the kernels")
    return searcher, data_dir, run_dir, topics, t1 - t0, t2 - t1


def phase_serve(root: str):
    """The port's EntitySearcher on a full-width random-weight RECIPE
    checkpoint, checked against an fp32 dense oracle. Returns (data_dir,
    run_dir, topics, oracle top-10 ids, launches by kernel)."""
    import torch
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.scoring.run import pad_queries
    from sert_tpu_torch.scoring.scorer import (_entity_matrix,
                                               _query_reps_and_terms)

    searcher, data_dir, run_dir, topics, fixture_s, load_s = (
        full_width_searcher(root))
    say("serve", fixture_s=fixture_s, load_stage_warmup_s=load_s,
        entities=searcher.num_entities, vocab=len(searcher.vocab),
        rescore_dtype=str(searcher.prep.M_binned.dtype))

    texts = [topics[q] for q in sorted(topics)]
    k3.launches = k4.launches = 0
    t0 = time.perf_counter()
    one = searcher.search(texts[0])
    t1 = time.perf_counter()
    many = searcher.search_many(texts)
    t2 = time.perf_counter()
    launches = {"score_binmax": k3.launches, "gather_rescore": k4.launches}
    n_batches = -(-len(texts) // Q)
    say("serve", search_ms=(t1 - t0) * 1e3,
        search_many_s=t2 - t1, batches=n_batches,
        per_batch_ms=(t2 - t1) * 1e3 / n_batches,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(launches).replace(" ", ""))
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    a, b = dict(one), dict(many[0])
    if a.keys() != b.keys() or max(abs(a[n] - b[n]) for n in a) > SCORE_TOL:
        raise AssertionError("search and search_many disagree on query 0")

    # fp32 dense oracle on the card, 64 queries at a time; it shares the
    # query-rep and entity-normalization functions with the searcher.
    cfg, params = searcher.recipe.model, searcher.params
    encoded = {f"{i:04d}": searcher.encode(t) for i, t in enumerate(texts)}
    _, term_ids, num_terms = pad_queries(encoded)
    M = _entity_matrix(params, cfg, "cosine")
    recalls, worst, oracle_top = [], 0.0, []
    with torch.no_grad():
        for lo in range(0, len(texts), Q):
            t = torch.from_numpy(term_ids[lo:lo + Q]).cuda()
            m = torch.from_numpy(num_terms[lo:lo + Q]).cuda()
            R = _query_reps_and_terms(params, cfg, t, m, "cosine")[0]
            S = R @ M.T                                         # [64, E]
            top = torch.topk(S, K, dim=1).indices.cpu().numpy()
            for i in range(R.shape[0]):
                hits = many[lo + i]
                if len(hits) != K:
                    raise AssertionError(f"query {lo + i}: {len(hits)} hits")
                ids = [int(name[1:]) for name, _ in hits]
                got = torch.tensor([s for _, s in hits], device="cuda")
                want = S[i, torch.tensor(ids, device="cuda")]
                worst = max(worst, (got - want).abs().max().item())
                recalls.append(len(set(ids) & set(top[i].tolist())) / K)
                oracle_top.append(top[i, :10].tolist())
            del S
    recall = sum(recalls) / len(recalls)
    say("serve", mean_recall_vs_dense=recall, min_recall=min(recalls),
        max_score_err=worst)
    if recall < RECALL_MIN or worst > SCORE_TOL:
        raise AssertionError(f"recall {recall} < {RECALL_MIN} or score "
                             f"error {worst} > {SCORE_TOL}")
    del searcher, params, M
    torch.cuda.empty_cache()
    return data_dir, run_dir, topics, oracle_top, launches


def phase_cli(root: str, data_dir: str, run_dir: str, topics: dict,
              oracle_top: list) -> None:
    """`query` into a TREC run, then `evaluate` against qrels marking each
    topic's 10 best entities by the dense oracle as relevant."""
    from sert_tpu_torch.fixture import read_run, write_eval_inputs
    topics_path, qrels_path = write_eval_inputs(
        root, topics, dict(zip(sorted(topics), oracle_top)))
    run_path = os.path.join(root, "run.trec")

    def cli(*args):
        proc = subprocess.run([sys.executable, "-m", "sert_tpu_torch", *args],
                              capture_output=True, text=True, cwd=HERE)
        if proc.returncode != 0:
            raise RuntimeError(f"sert_tpu_torch {args[0]} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        return proc.stdout

    t0 = time.perf_counter()
    cli("query", "--recipe", RECIPE, "--data", data_dir,
        "--run-dir", run_dir, "--topics", topics_path, "--out", run_path)
    t1 = time.perf_counter()
    run = read_run(run_path)
    sizes = {len(v) for v in run.values()}
    if len(run) != len(topics) or sizes != {K}:
        raise AssertionError(f"run has {len(run)} topics, sizes {sizes}")
    metrics = json.loads(cli("evaluate", "--run", run_path,
                             "--qrels", qrels_path))
    say("cli", query_s=t1 - t0, topics=len(run), entries_per_topic=K,
        ndcg_at_100=metrics["ndcg@100"],
        recall_at_1000=metrics["recall@1000"])
    if metrics["recall@1000"] < RECALL_MIN:
        raise AssertionError(f"CLI run misses the oracle's top 10: "
                             f"{metrics}")


def main() -> int:
    import sert_tpu_torch  # noqa: F401  (fails outside a checkout)
    kind = phase_device()
    phase_build()
    records = phase_kernels()
    with tempfile.TemporaryDirectory() as root:
        data_dir, run_dir, topics, oracle_top, launches = phase_serve(root)
        phase_cli(root, data_dir, run_dir, topics, oracle_top)
    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
