"""Ranker comparison report: the companion papers' headline-table workflow
(a copy of ``sert_tpu/eval/report.py``; the model ranker runs on a torch
device).

Both papers present their results as one table per collection — the
semantic model next to the lexical language-model baseline and their
combination, each row a ranker, each column a metric, significance
markers against the baseline (SURVEY.md section 1, evaluation protocol).
This module produces that table natively from a prepared data dir and a
trained run dir:

  rankers: model   — the trained semantic model (scoring engines),
           lm      — smoothed query-likelihood entity LM (no training),
           interp  — per-topic normalized linear interpolation of the two,
           rrf     — reciprocal rank fusion (rank-based alternative).

Significance: paired randomization + t-test of every ranker against the
``lm`` baseline over shared topics (eval/significance.py), the papers'
convention for the dagger markers.

CLI: ``python -m sert_tpu_torch report ...`` (markdown to stdout or
--out).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from sert_tpu_torch.eval.fuse import fuse_runs
from sert_tpu_torch.eval.metrics import DEFAULT_MEASURES, evaluate_run

Run = Dict[str, List[Tuple[str, float]]]


def build_ranker_runs(recipe, data_dir: str, run_dir: Optional[str],
                      topics: Mapping[str, str], step: Optional[int] = None,
                      fuse_weight: float = 0.5, smoothing: str = "dirichlet",
                      mu: float = 2000.0, lam: float = 0.5, device=None,
                      ) -> Dict[str, Run]:
    """All four rankers' runs for one collection.

    ``fuse_weight`` is the semantic model's interpolation weight (the
    lexical LM gets ``1 - fuse_weight``). With ``run_dir=None`` only the
    lm ranker runs (nothing trained to compare). ``device``: where the
    model ranker's params load and score (default: the card; the lm
    ranker is host code)."""
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.data.instances import InstanceDataset
    from sert_tpu_torch.data.prepare import encode_queries
    from sert_tpu_torch.models.lm import load_lm

    ds = InstanceDataset(data_dir)
    resolved = pipeline.resolve_model_config(recipe, ds.meta)
    lm, vocab, registry = load_lm(data_dir, smoothing=smoothing, mu=mu,
                                  lam=lam)

    runs: Dict[str, Run] = {}
    k = resolved.score.top_k
    # load_scorer re-validates vocab/registry against the checkpoint; both
    # loaders return identical objects for one data dir, so encode once.
    if run_dir is not None:
        from sert_tpu_torch.scoring.run import score_topics
        params, vocab, registry = pipeline.load_scorer(
            run_dir, data_dir, resolved, step=step,
            device=pipeline.resolve_device(device))
    encoded = encode_queries(dict(topics), vocab, resolved.data)
    if run_dir is not None:
        runs["model"] = score_topics(params, resolved.model, encoded,
                                     registry.names, resolved.score)
    runs["lm"] = lm.rank_topics(encoded, registry.names, k=k)

    if "model" in runs:
        pair = [runs["model"], runs["lm"]]
        w = float(fuse_weight)
        runs["interp"] = fuse_runs(pair, weights=[w, 1.0 - w],
                                   method="interp", k=k)
        runs["rrf"] = fuse_runs(pair, method="rrf", k=k)
    return runs


def ranker_report(runs: Mapping[str, Run],
                  qrels: Mapping[str, Mapping[str, int]],
                  measures: Sequence[str] = DEFAULT_MEASURES,
                  baseline: str = "lm", n_samples: int = 20_000,
                  ) -> Dict:
    """Evaluate every ranker and test each against the baseline.

    Returns {"rankers": {name: {"all": {...}, "vs_baseline": {measure:
    {"delta", "p_randomization", "p_ttest"}}}}, "baseline": name,
    "measures": [...]} — JSON-serializable."""
    from sert_tpu_torch.eval.significance import compare_runs

    per_topic = {name: evaluate_run(run, qrels, measures)
                 for name, run in runs.items()}
    out: Dict = {"baseline": baseline, "measures": list(measures),
                 "rankers": {}}
    base = per_topic.get(baseline)
    for name, pt in per_topic.items():
        row: Dict = {"all": pt["all"]}
        if base is not None and name != baseline:
            cmp = compare_runs(
                {q: v for q, v in pt.items() if q != "all"},
                {q: v for q, v in base.items() if q != "all"},
                measures, n_samples=n_samples)
            row["vs_baseline"] = {
                m: {"delta": c["delta"],
                    "p_randomization": c["p_randomization"],
                    "p_ttest": c["p_ttest"]}
                for m, c in cmp.items()}
        out["rankers"][name] = row
    return out


def format_markdown(report: Dict, title: str = "") -> str:
    """The papers' table shape: rankers as rows, metrics as columns; a
    dagger marks p < 0.05 (randomization test) against the baseline."""
    measures = report["measures"]
    base = report["baseline"]
    lines = []
    if title:
        lines.append(f"### {title}")
        lines.append("")
    lines.append("| ranker | " + " | ".join(measures) + " |")
    lines.append("|---" * (len(measures) + 1) + "|")
    order = [r for r in ("lm", "model", "interp", "rrf")
             if r in report["rankers"]]
    order += [r for r in report["rankers"] if r not in order]
    for name in order:
        row = report["rankers"][name]
        cells = []
        for m in measures:
            v = row["all"][m]
            mark = ""
            vs = row.get("vs_baseline", {}).get(m)
            if vs is not None and vs["p_randomization"] < 0.05:
                mark = "†"
            cells.append(f"{v:.4f}{mark}")
        label = f"{name} (baseline)" if name == base else name
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    lines.append("")
    lines.append(f"† p < 0.05 vs `{base}` (paired randomization test).")
    return "\n".join(lines)
