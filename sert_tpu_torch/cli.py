"""Command-line interface of the port (subcommands and flags as in
``sert_tpu/cli.py``):

  python -m sert_tpu_torch list      — named recipes
  python -m sert_tpu_torch query     — checkpoint + topics -> TREC run file
  python -m sert_tpu_torch evaluate  — run + qrels -> metrics
  python -m sert_tpu_torch serve     — stdin queries -> ranked entities

``query`` and ``serve`` take ``--device`` (default: the first CUDA device
when there is one, else the CPU). The lm ranker, ``fuse``, ``report``,
``serve --http`` and the training commands are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _add_recipe_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--recipe", required=True,
                   help="named recipe (see `list`) or path to a recipe JSON")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda when available, "
                        "else cpu)")


def load_recipe(spec: str):
    """A named recipe (see `list`) or a recipe JSON file."""
    from sert_tpu import recipes
    from sert_tpu.utils.config import load_recipe as load_recipe_file
    if spec in recipes.RECIPES:
        return recipes.RECIPES[spec]()
    if os.path.exists(spec):
        return load_recipe_file(spec)
    raise SystemExit(
        f"unknown recipe {spec!r}; try `python -m sert_tpu_torch list`")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="sert_tpu_torch")
    from sert_tpu_torch import __version__
    ap.add_argument("--version", action="version",
                    version=f"sert-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list named recipes")

    p = sub.add_parser("query", help="score topics into a TREC run file")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--run-dir", default=None,
                   help="trained run directory (required for --ranker model)")
    p.add_argument("--topics", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--ranker", choices=("model",), default="model",
                   help="'model' = the trained semantic model (the lm "
                        "ranker is not ported yet)")
    _add_device_arg(p)

    p = sub.add_parser("evaluate", help="trec_eval-style metrics")
    p.add_argument("--run", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--measures", nargs="*", default=None)
    p.add_argument("--per-topic", action="store_true",
                   help="print per-topic rows, not just the macro average")
    p.add_argument("--judged-only", action="store_true",
                   help="drop unjudged documents before scoring (trec_eval -J)")
    p.add_argument("--compare", default=None, metavar="RUN_B",
                   help="second run file: report paired significance "
                        "(randomization + t-test) of run vs RUN_B per "
                        "measure instead of plain metrics")

    p = sub.add_parser("serve", help="stdin query serving: one query per "
                                     "line (optionally 'qid<TAB>text'), "
                                     "ranked entities out; the entity "
                                     "matrix stays staged on the device")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--batch", type=int, default=16,
                   help="queries scored per device dispatch")
    _add_device_arg(p)

    args = ap.parse_args(argv)

    if args.cmd == "list":
        from sert_tpu import recipes
        for name in recipes.RECIPES:
            print(name)
        return 0

    if args.cmd == "query":
        recipe = load_recipe(args.recipe)
        from sert_tpu.data.instances import InstanceDataset
        from sert_tpu.data.prepare import encode_queries
        from sert_tpu.eval.trec import read_topics, write_run
        from sert_tpu_torch import pipeline
        from sert_tpu_torch.scoring.run import score_topics
        if not args.run_dir:
            raise SystemExit("--run-dir is required with --ranker model")
        ds = InstanceDataset(args.data)
        resolved = pipeline.resolve_model_config(recipe, ds.meta)
        device = args.device or pipeline.default_device()
        try:
            params, vocab, registry = pipeline.load_scorer(
                args.run_dir, args.data, resolved, step=args.step,
                device=device)
        except FileNotFoundError as e:
            raise SystemExit(
                f"{e} — train first or pass --run-dir of a finished run")
        except ValueError as e:
            raise SystemExit(str(e))
        topics = read_topics(args.topics)
        encoded = encode_queries(topics, vocab, resolved.data)
        run = score_topics(params, resolved.model, encoded, registry.names,
                           resolved.score)
        write_run(run, args.out)
        print(f"wrote {sum(len(v) for v in run.values())} entries "
              f"for {len(run)} topics to {args.out}")
        return 0

    if args.cmd == "evaluate":
        from sert_tpu.eval.metrics import DEFAULT_MEASURES, evaluate_run
        from sert_tpu.eval.trec import read_qrels, read_run
        run = read_run(args.run)
        qrels = read_qrels(args.qrels)
        measures = tuple(args.measures) if args.measures else DEFAULT_MEASURES
        results = evaluate_run(run, qrels, measures,
                               judged_only=args.judged_only)
        if args.compare:
            from sert_tpu.eval.significance import compare_runs
            run_b = read_run(args.compare)
            results_b = evaluate_run(run_b, qrels, measures,
                                     judged_only=args.judged_only)
            report = compare_runs(results, results_b, measures)
            print(json.dumps(report, indent=2, sort_keys=True))
            return 0
        out = results if args.per_topic else results["all"]
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0

    if args.cmd == "serve":
        recipe = load_recipe(args.recipe)
        from sert_tpu_torch.serving import EntitySearcher, serve_stdin
        searcher = EntitySearcher(recipe, args.data, args.run_dir,
                                  step=args.step, k=args.k,
                                  query_batch=args.batch, device=args.device)
        print("ready: one query per line ('qid<TAB>text' or bare text); "
              "EOF/empty line exits", file=sys.stderr, flush=True)
        serve_stdin(searcher, sys.stdin, sys.stdout)
        return 0

    return 1


def console_main(argv: Optional[List[str]] = None) -> int:
    """Entry point for `python -m sert_tpu_torch`: expected user errors
    print one clean line instead of a traceback; set SERT_TPU_DEBUG=1 to
    re-raise them."""
    try:
        return main(argv)
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0
    except (FileNotFoundError, NotADirectoryError, IsADirectoryError,
            PermissionError, ValueError, NotImplementedError) as e:
        if os.environ.get("SERT_TPU_DEBUG"):
            raise
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(console_main())
