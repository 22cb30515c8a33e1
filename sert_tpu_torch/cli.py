"""Command-line interface of the port (subcommands and flags as in
``sert_tpu/cli.py``):

  python -m sert_tpu_torch list      — named recipes
  python -m sert_tpu_torch prepare   — collection -> vocab + instance shards
  python -m sert_tpu_torch train     — instances -> per-epoch checkpoints
  python -m sert_tpu_torch query     — checkpoint + topics -> TREC run file
  python -m sert_tpu_torch evaluate  — run + qrels -> metrics
  python -m sert_tpu_torch sweep     — every epoch snapshot -> metric, best
  python -m sert_tpu_torch dump      — learned vectors -> npz or word2vec
  python -m sert_tpu_torch serve     — stdin queries (or, with --http, a
                                       JSON HTTP API) -> ranked entities
  python -m sert_tpu_torch neighbors — nearest terms or entities
  python -m sert_tpu_torch e2e       — synthetic recipe end to end

``train``, ``query``, ``sweep``, ``dump``, ``serve``, ``neighbors`` and
``e2e`` load params onto the CUDA card; they take ``--device cpu`` to run
on the CPU, and without a card and without it they stop with that advice.
``prepare``, ``evaluate`` and ``query --ranker lm`` are host code, as are
``dump``'s and ``neighbors``' arithmetic. ``fuse`` and ``report`` are not
ported yet.
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
                   help="torch device (default: the CUDA card; pass cpu to "
                        "run on the CPU)")


def load_recipe(spec: str):
    """A named recipe (see `list`) or a recipe JSON file."""
    from sert_tpu_torch import recipes
    from sert_tpu_torch.utils.config import load_recipe as load_recipe_file
    if spec in recipes.RECIPES:
        return recipes.RECIPES[spec]()
    if os.path.exists(spec):
        return load_recipe_file(spec)
    raise SystemExit(
        f"unknown recipe {spec!r}; try `python -m sert_tpu_torch list`")


def _prepare(recipe, args) -> None:
    """The reference's prepare command: the synthetic stand-in (with its
    topics and qrels), Amazon reviews, or TREC expert finding."""
    from sert_tpu_torch import pipeline, recipes
    from sert_tpu_torch.data.prepare import prepare
    if args.synthetic or not (args.trec_docs or args.amazon_reviews):
        spec = recipes.SYNTH_SPECS.get(recipe.name)
        if spec is None:
            print(f"note: no synthetic stand-in registered for recipe "
                  f"{recipe.name!r}; using the tiny demo collection",
                  file=sys.stderr)
            spec = recipes.tiny_spec()
        col = spec.build()
        pipeline.prepare_collection(col, args.out, recipe)
        from sert_tpu_torch.eval.trec import write_qrels, write_topics
        write_topics(col.topics, os.path.join(args.out, "topics.tsv"))
        write_qrels(col.qrels, os.path.join(args.out, "qrels.trec"))
    elif args.amazon_reviews:
        from sert_tpu_torch.data.corpus import build_product_collection
        docs, assoc, registry = build_product_collection(args.amazon_reviews)
        prepare(docs, assoc, registry, args.out, recipe.data)
    else:
        if not args.candidates:
            raise SystemExit(
                "TREC expert-finding prepare needs --candidates "
                "(id<TAB>name<TAB>email... file)")
        from sert_tpu_torch.data.corpus import (build_expert_associations,
                                                iter_trec_docs,
                                                load_candidates,
                                                trec_collection_files)
        files = []
        for spec in args.trec_docs:
            files.extend(trec_collection_files(spec)
                         if os.path.isdir(spec) else [spec])
        docs = dict(iter_trec_docs(files))
        registry, mentions = load_candidates(args.candidates)
        assoc = build_expert_associations(docs.items(), mentions, registry)
        prepare(docs, assoc, registry, args.out, recipe.data)


def _load_run(args):
    """(resolved recipe, host params, vocab, registry) of ``--run-dir`` at
    ``--step``, read through the device the command was given."""
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.data.instances import InstanceDataset
    recipe = load_recipe(args.recipe)
    resolved = pipeline.resolve_model_config(
        recipe, InstanceDataset(args.data).meta)
    params, vocab, registry = pipeline.load_scorer(
        args.run_dir, args.data, resolved, step=args.step,
        device=pipeline.resolve_device(args.device))
    return resolved, params, vocab, registry


def _host(t):
    """An fp32 numpy copy of a tensor (numpy has no bf16). Strides are
    kept: the log-linear entity matrix stays the transposed view of
    ``proj_w`` that the reference writes (a Fortran-ordered array)."""
    return t.float().cpu().numpy()


def _dump(args) -> int:
    """The reference's dump: ``word_emb``, ``entity_matrix``, ``terms``
    and ``entities`` (object arrays) and, where the model has one,
    ``entity_bias``, as an npz (what ``train --init-word-emb`` reads), or
    the word2vec text format. Arrays are written in fp32."""
    import numpy as np
    from sert_tpu_torch.models import api as model_api
    resolved, params, vocab, registry = _load_run(args)
    out = {
        "word_emb": _host(params["word_emb"]),
        "entity_matrix": _host(model_api.entity_matrix(params,
                                                       resolved.model)),
        "terms": np.asarray(list(vocab.iter_terms()), dtype=object),
        "entities": np.asarray(registry.names, dtype=object),
    }
    if args.format == "word2vec":
        # The classic text format (a header line "N d", then "token v1 ..
        # vd"), loadable by gensim's KeyedVectors.load_word2vec_format(
        # binary=False). Tokens must be space-free.
        base = args.out[:-4] if args.out.endswith(".npz") else args.out

        def _w2v(path, names, mat):
            with open(path, "w") as fh:
                fh.write(f"{mat.shape[0]} {mat.shape[1]}\n")
                for name, row in zip(names, mat):
                    tok = str(name).replace(" ", "_")
                    fh.write(tok + " "
                             + " ".join(f"{x:.6f}" for x in
                                        row.astype(np.float64)) + "\n")

        wpath, epath = base + ".words.vec", base + ".entities.vec"
        _w2v(wpath, out["terms"], out["word_emb"])
        _w2v(epath, out["entities"], out["entity_matrix"])
        print(f"wrote {wpath} ({out['word_emb'].shape}) and "
              f"{epath} ({out['entity_matrix'].shape})")
        return 0
    bias = model_api.entity_bias(params, resolved.model)
    if bias is not None:
        out["entity_bias"] = _host(bias)
    np.savez(args.out, **out)
    print(f"wrote {', '.join(out)} to {args.out}")
    return 0


def _neighbors(args) -> int:
    """The reference's neighbors: cosine nearest neighbours of one term
    (word space) or entity (entity space), host numpy."""
    import numpy as np
    from sert_tpu_torch.models import api as model_api
    if bool(args.term) == bool(args.entity):
        raise SystemExit("pass exactly one of --term / --entity")
    resolved, params, vocab, registry = _load_run(args)
    if args.term:
        names = list(vocab.iter_terms())
        term = args.term.lower() if resolved.data.lowercase else args.term
        if term not in vocab:
            raise SystemExit(f"term {args.term!r} not in the vocabulary")
        M = _host(params["word_emb"])
        qi = vocab.id(term)
    else:
        names = list(registry.names)
        if args.entity not in names:
            raise SystemExit(f"entity {args.entity!r} unknown")
        M = _host(model_api.entity_matrix(params, resolved.model))
        qi = names.index(args.entity)
    M = M / np.maximum(np.linalg.norm(M, axis=1, keepdims=True), 1e-9)
    sims = M @ M[qi]
    sims[qi] = -np.inf  # the query itself is not its own neighbor
    order = np.argsort(-sims)[:args.k]
    for rank, i in enumerate(order, 1):
        print(f"{rank}\t{names[i]}\t{sims[i]:.4f}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="sert_tpu_torch")
    from sert_tpu_torch import __version__
    ap.add_argument("--version", action="version",
                    version=f"sert-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list named recipes")

    p = sub.add_parser("prepare", help="build vocab + instance shards")
    _add_recipe_arg(p)
    p.add_argument("--out", required=True, help="output data directory")
    p.add_argument("--synthetic", action="store_true",
                   help="use the recipe's synthetic stand-in collection")
    p.add_argument("--trec-docs", nargs="*", default=None,
                   help="TREC SGML collection files/dirs")
    p.add_argument("--candidates", default=None,
                   help="expert candidates file (id<TAB>name<TAB>email...) "
                        "for TREC expert-finding prepare")
    p.add_argument("--amazon-reviews", nargs="*", default=None,
                   help="Amazon review JSON(.gz) files")

    p = sub.add_parser("train", help="train from prepared instances")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--init-word-emb", default=None, metavar="DUMP_NPZ",
                   help="seed word embeddings from a dump npz (terms matched "
                        "by string; fresh init for terms not in the dump)")
    _add_device_arg(p)

    p = sub.add_parser("query", help="score topics into a TREC run file")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--run-dir", default=None,
                   help="trained run directory (required for --ranker model)")
    p.add_argument("--topics", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--ranker", choices=("model", "lm"), default="model",
                   help="'model' = the trained semantic model; 'lm' = the "
                        "smoothed query-likelihood entity language model "
                        "over prepare-time term statistics (the papers' "
                        "lexical baseline; no checkpoint needed)")
    p.add_argument("--smoothing", choices=("dirichlet", "jm"),
                   default="dirichlet", help="LM smoothing (--ranker lm)")
    p.add_argument("--mu", type=float, default=2000.0,
                   help="Dirichlet prior mass (--ranker lm)")
    p.add_argument("--lam", type=float, default=0.5,
                   help="Jelinek-Mercer background weight (--ranker lm)")
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

    p = sub.add_parser("sweep", help="evaluate EVERY epoch checkpoint and "
                                     "report the best (reference workflow: "
                                     "choose the epoch snapshot by metric)")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--topics", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--measure", default="ndcg@100")
    _add_device_arg(p)

    p = sub.add_parser("dump", help="export learned representations")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--out", required=True, help="output .npz path (or the "
                   "basename for --format word2vec)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--format", choices=("npz", "word2vec"), default="npz",
                   help="word2vec = gensim-loadable TEXT vectors, two "
                        "files <out>.words.vec and <out>.entities.vec "
                        "(spaces in entity names become underscores); "
                        "npz keeps the full typed export incl. bias")
    _add_device_arg(p)

    p = sub.add_parser("serve", help="query serving: from stdin (one query "
                                     "per line, optionally 'qid<TAB>text') "
                                     "or over HTTP, ranked entities out; "
                                     "the entity matrix stays staged on "
                                     "the device")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--batch", type=int, default=16,
                   help="queries scored per device dispatch")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve a JSON HTTP API (GET /healthz, GET|POST "
                        "/search, POST /entities) instead of the stdin "
                        "loop")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --http (default loopback)")
    _add_device_arg(p)

    p = sub.add_parser("neighbors", help="nearest neighbors of a term or "
                                         "entity in the learned space "
                                         "(qualitative inspection, the "
                                         "companion papers' table workflow)")
    _add_recipe_arg(p)
    p.add_argument("--data", required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--term", default=None, help="query term (word space)")
    p.add_argument("--entity", default=None,
                   help="query entity name (entity space)")
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--step", type=int, default=None)
    _add_device_arg(p)

    p = sub.add_parser("e2e", help="synthetic recipe end to end")
    _add_recipe_arg(p)
    p.add_argument("--workdir", required=True)
    _add_device_arg(p)

    args = ap.parse_args(argv)

    if args.cmd == "list":
        from sert_tpu_torch import recipes
        for name in recipes.RECIPES:
            print(name)
        return 0

    if args.cmd == "prepare":
        recipe = load_recipe(args.recipe)
        _prepare(recipe, args)
        return 0

    if args.cmd == "train":
        recipe = load_recipe(args.recipe)
        from sert_tpu_torch import pipeline
        pipeline.train_from_dir(recipe, args.data, args.out,
                                resume=not args.no_resume,
                                init_word_emb=args.init_word_emb,
                                device=args.device)
        return 0

    if args.cmd == "e2e":
        recipe = load_recipe(args.recipe)
        from sert_tpu_torch import pipeline, recipes
        device = pipeline.resolve_device(args.device)
        if recipe.name == "synthetic_10m_scoring":
            raise SystemExit(
                "synthetic_10m_scoring is a scoring-only benchmark recipe")
        spec = recipes.SYNTH_SPECS.get(recipe.name)
        if spec is None:
            print(f"note: no synthetic stand-in registered for recipe "
                  f"{recipe.name!r}; using the tiny demo collection",
                  file=sys.stderr)
            spec = recipes.tiny_spec()
        results = pipeline.run_end_to_end(spec.build(), recipe, args.workdir,
                                          device=device)
        print(json.dumps(results["all"], indent=2, sort_keys=True))
        return 0

    if args.cmd == "query":
        recipe = load_recipe(args.recipe)
        from sert_tpu_torch import pipeline
        from sert_tpu_torch.data.instances import InstanceDataset
        from sert_tpu_torch.data.prepare import encode_queries
        from sert_tpu_torch.eval.trec import read_topics, write_run
        from sert_tpu_torch.scoring.run import score_topics
        ds = InstanceDataset(args.data)
        resolved = pipeline.resolve_model_config(recipe, ds.meta)
        if args.ranker == "lm":
            from sert_tpu_torch.models.lm import load_lm
            try:
                lm, vocab, registry = load_lm(args.data,
                                              smoothing=args.smoothing,
                                              mu=args.mu, lam=args.lam)
            except (FileNotFoundError, ValueError) as e:
                raise SystemExit(str(e))
            topics = read_topics(args.topics)
            encoded = encode_queries(topics, vocab, resolved.data)
            run = lm.rank_topics(encoded, registry.names,
                                 k=resolved.score.top_k)
            write_run(run, args.out)
            print(f"wrote {sum(len(v) for v in run.values())} entries "
                  f"for {len(run)} topics to {args.out} (lm ranker)")
            return 0
        if not args.run_dir:
            raise SystemExit("--run-dir is required with --ranker model")
        device = pipeline.resolve_device(args.device)
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
        from sert_tpu_torch.eval.metrics import DEFAULT_MEASURES, evaluate_run
        from sert_tpu_torch.eval.trec import read_qrels, read_run
        run = read_run(args.run)
        qrels = read_qrels(args.qrels)
        measures = tuple(args.measures) if args.measures else DEFAULT_MEASURES
        results = evaluate_run(run, qrels, measures,
                               judged_only=args.judged_only)
        if args.compare:
            from sert_tpu_torch.eval.significance import compare_runs
            run_b = read_run(args.compare)
            results_b = evaluate_run(run_b, qrels, measures,
                                     judged_only=args.judged_only)
            report = compare_runs(results, results_b, measures)
            print(json.dumps(report, indent=2, sort_keys=True))
            return 0
        out = results if args.per_topic else results["all"]
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0

    if args.cmd == "sweep":
        recipe = load_recipe(args.recipe)
        from sert_tpu_torch import pipeline
        results = pipeline.sweep_checkpoints(
            recipe, args.data, args.run_dir, args.topics, args.qrels,
            measure=args.measure, device=args.device)
        print(json.dumps(results, indent=2, sort_keys=True))
        return 0

    if args.cmd == "dump":
        return _dump(args)

    if args.cmd == "neighbors":
        return _neighbors(args)

    if args.cmd == "serve":
        recipe = load_recipe(args.recipe)
        from sert_tpu_torch.serving import (EntitySearcher, make_http_server,
                                            serve_stdin)
        searcher = EntitySearcher(recipe, args.data, args.run_dir,
                                  step=args.step, k=args.k,
                                  query_batch=args.batch, device=args.device)
        if args.http is not None:
            server = make_http_server(searcher, host=args.host,
                                      port=args.http)
            host, port = server.server_address[:2]
            print(f"ready: http://{host}:{port} — GET /healthz, "
                  f"GET /search?q=...&k=N, POST /search "
                  f'{{"query": "...", "k": N}}, POST /entities',
                  file=sys.stderr, flush=True)
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.server_close()
            return 0
        print("ready: one query per line ('qid<TAB>text' or bare text); "
              "EOF/empty line exits", file=sys.stderr, flush=True)
        serve_stdin(searcher, sys.stdin, sys.stdout)
        return 0

    return 1


def console_main(argv: Optional[List[str]] = None) -> int:
    """Entry point for `python -m sert_tpu_torch`: expected user errors
    print one clean line instead of a traceback; set SERT_TPU_DEBUG=1 to
    re-raise them."""
    from sert_tpu_torch.pipeline import NoCudaDevice
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
            PermissionError, ValueError, NotImplementedError,
            NoCudaDevice) as e:
        if os.environ.get("SERT_TPU_DEBUG"):
            raise
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(console_main())
