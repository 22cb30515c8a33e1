"""Query serving: the scorer staged once behind a reusable searcher (port
of ``sert_tpu/serving.py``: ``EntitySearcher`` :65-609, ``serve_stdin``
:612 and the HTTP server :635-764).

  * :class:`EntitySearcher` loads a trained run onto a device, resolves
    the engine (any single-device engine the recipe's ScoreConfig names:
    the kernels, streaming, approx or dense), stages the entity matrix
    once for the kernel engine (in the recipe's layout), fires one
    warm-up dispatch (which also builds the kernels), and answers
    free-text queries with a thread-safe ``search`` / ``search_many``; for
    LSE models ``add_entities`` folds NEW entities into the live index
    without retraining (``models.lse.fold_in_entity``);
  * :func:`serve_stdin` is the interactive loop used by ``serve``;
  * :func:`make_http_server` is a JSON HTTP API on the stdlib
    ``ThreadingHTTPServer`` (GET /healthz, GET|POST /search, POST
    /entities), used by ``serve --http PORT``.

Device dispatches serialize on one lock, so per-query latency stays
predictable. Concurrent requests micro-batch: the first free thread
becomes the leader, drains every request that arrived while the previous
dispatch ran, and answers them all with one engine call; a lone request
dispatches at once.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from sert_tpu_torch import pipeline
from sert_tpu_torch.data.instances import InstanceDataset
from sert_tpu_torch.data.prepare import encode_queries
from sert_tpu_torch.models import lse as lse_model
from sert_tpu_torch.models.api import entity_matrix
from sert_tpu_torch.models.lm import load_lm
from sert_tpu_torch.scoring.run import (MAX_QUERY_TERMS, resolve_engine,
                                        score_topics, stage_entities)
from sert_tpu_torch.utils.config import RecipeConfig
from sert_tpu_torch.utils.logging import get_logger

log = get_logger("serving")


def _host(t: torch.Tensor) -> np.ndarray:
    """fp32 numpy copy of a device tensor (numpy has no bf16: the cast
    happens on the device)."""
    return t.float().cpu().numpy()


class _BatchReq:
    """One submission to the micro-batcher: encoded queries (an empty list
    is an all-OOV placeholder, answered ``None``) and the caller's clamped
    k. Filled in by whichever thread leads the dispatch."""

    __slots__ = ("ids_list", "k", "results", "error", "done")

    def __init__(self, ids_list, k):
        self.ids_list = ids_list
        self.k = k
        self.results = None
        self.error = None
        self.done = False


class EntitySearcher:
    """Load a trained run and answer ranked-entity queries repeatedly.

    ``device`` defaults to the CUDA card (without one, and without
    ``device="cpu"``, the constructor raises); params, the staged entity
    matrix and every dispatch live there."""

    def __init__(self, recipe: RecipeConfig, data_dir: str, run_dir: str,
                 step: Optional[int] = None, k: int = 10,
                 query_batch: int = 16, device=None):
        self.device = pipeline.resolve_device(device)
        ds = InstanceDataset(data_dir)
        self.recipe = pipeline.resolve_model_config(recipe, ds.meta)
        self.params, self.vocab, self.registry = pipeline.load_scorer(
            run_dir, data_dir, self.recipe, step=step, device=self.device)
        # Stage at a k cap (>= the default, the constructor's k and the
        # recipe's top_k, floored at 100, clamped to E) so a per-request k
        # up to the cap is a free slice of one staged engine.
        self.names = self.registry.names
        self.num_entities = len(self.names)
        self.default_k = k
        self.k_max = min(max(k, 100, self.recipe.score.top_k),
                         self.num_entities)
        self.score_cfg = dataclasses.replace(
            self.recipe.score, top_k=self.k_max, query_batch=query_batch)
        # The one device-dispatch lock. Reentrant: fold-in holds it across
        # its whole device sequence while its probe re-enters _score.
        self._lock = threading.RLock()
        self.prep = None
        self.engine = resolve_engine(
            self.score_cfg, self.num_entities, self.device,
            entity_matrix(self.params, self.recipe.model).shape[1])
        if self.engine == "pallas":
            self.prep = stage_entities(self.params, self.recipe.model,
                                       self.score_cfg)
        # Folded-in entities (LSE only): names + vectors appended at serve
        # time, scored per query on the host and merged into the engine's
        # top k.
        self._extra_names: List[str] = []
        self._extra_vecs = None      # np.ndarray [n, d_e] or None
        self._extra_spans = None     # np.ndarray [n, 2]: (floor, top)
        self._extra_raw = None       # np.ndarray [n] bool: gradient fold-in
        self.data_dir = data_dir     # the gradient fold-in's negative pool
        # Micro-batcher state: pending requests + a single-leader flag,
        # guarded by one condition variable (see module docstring).
        self._bq_cond = threading.Condition()
        self._bq_pending: List[_BatchReq] = []
        self._bq_busy = False
        # dispatches = engine calls made by the batcher, batched_queries =
        # live queries answered, max_batch = largest single dispatch.
        self.stats = {"dispatches": 0, "batched_queries": 0, "max_batch": 0}
        # Warm-up dispatch: kernel build and first launches happen here.
        self._score({"_warmup": self.vocab.encode(["warmup"])})

    def _score(self, encoded):
        return score_topics(self.params, self.recipe.model, encoded,
                            self.names, self.score_cfg, prep=self.prep)

    def encode(self, text: str) -> List[int]:
        """Query terms -> vocab ids with document preprocessing (OOV
        dropped, reference semantics)."""
        return encode_queries({"q": text}, self.vocab, self.recipe.data)["q"]

    def search(self, text: str, k: Optional[int] = None
               ) -> Optional[List[Tuple[str, float]]]:
        """Ranked ``[(entity_name, score), ...]`` for a free-text query, or
        ``None`` when every query term is out of vocabulary."""
        ids = self.encode(text)
        if not ids:
            return None
        return self._submit([ids], self._clamp_k(k))[0]

    def search_many(self, texts: List[str], k: Optional[int] = None
                    ) -> List[Optional[List[Tuple[str, float]]]]:
        """Batched search through one engine pipeline; all-OOV positions
        come back as ``None``. Joins the same micro-batcher as search."""
        encoded = encode_queries(
            {str(i): t for i, t in enumerate(texts)},
            self.vocab, self.recipe.data)
        ids_list = [encoded[str(i)] for i in range(len(texts))]
        if not any(ids_list):
            return [None] * len(texts)
        return self._submit(ids_list, self._clamp_k(k))

    # -- micro-batching (queue-drain): one engine call per contention burst --

    def _submit(self, ids_list: List[List[int]], kk: int
                ) -> List[Optional[List[Tuple[str, float]]]]:
        """Submit one request and block until answered. The first thread
        to find no dispatch in flight drains the whole pending queue and
        answers it with one engine call; the others wait."""
        req = _BatchReq(ids_list, kk)
        batch = None
        with self._bq_cond:
            self._bq_pending.append(req)
            while not req.done and self._bq_busy:
                self._bq_cond.wait()
            if not req.done:
                self._bq_busy = True                # become the leader
                batch = self._bq_pending
                self._bq_pending = []
        if batch is not None:
            self._run_batch(batch)
        if req.error is not None:
            raise req.error
        return req.results

    def _answer(self, reqs: List[_BatchReq]) -> None:
        """Score every live query in ``reqs`` with one engine dispatch at
        the staged k cap, merge the folded-in entities, and hand each
        request its slice."""
        flat: List[List[int]] = []
        for r in reqs:
            flat.extend(ids for ids in r.ids_list if ids)
        merged = []
        if flat:
            keys = [str(i) for i in range(len(flat))]
            with self._lock:
                run = self._score(dict(zip(keys, flat)))
                merged = self._merge_extra_batch(
                    flat, [run[key] for key in keys], self.k_max)
        it = iter(merged)
        for r in reqs:
            r.results = [next(it)[:r.k] if ids else None
                         for ids in r.ids_list]
        self.stats["dispatches"] += 1
        self.stats["batched_queries"] += len(flat)
        self.stats["max_batch"] = max(self.stats["max_batch"], len(flat))

    def _run_batch(self, batch: List[_BatchReq]) -> None:
        """Leader path: answer the drained queue, wake the waiters. If a
        coalesced dispatch fails, each request is retried alone so only
        the offending one sees the exception."""
        try:
            self._answer(batch)
        except (KeyboardInterrupt, SystemExit) as e:
            for r in batch:
                r.error = e
            raise
        except Exception as e:
            if len(batch) == 1:
                batch[0].error = e
            else:
                for r in batch:
                    try:
                        self._answer([r])
                    except Exception as e_r:
                        r.error = e_r
        finally:
            with self._bq_cond:
                self._bq_busy = False
                for r in batch:
                    r.done = True
                self._bq_cond.notify_all()

    # -- fold-in: add entities at serve time (LSE only) ----------------------

    def add_entities(self, items: List[Tuple[str, str]],
                     method: str = "affine") -> int:
        """Fold (name, associated-text) pairs into the live index without
        retraining; returns the number added. Raises ValueError for
        log-linear models (candidates exist only as trained columns), for
        items that are not (str, str) pairs, for duplicate names, for text
        with no in-vocab token, and for an unknown ``method``.

        ``method="affine"``: the vector is the unit mean f-image of the
        text (``models.lse.fold_in_entity``), scored through an affine map
        fitted now: the vector's mean cosine against random background
        windows goes to 0, a perfect match to the trained index's top
        score for the text as a query (one batched engine probe). f-images
        are far more alike than trained rows, so raw f-cosines would
        outrank every trained entity.

        ``method="gradient"``: the vector lives in the trained score
        geometry and merges raw. For the softmax family (``lse_full``,
        ``sampled_softmax``) it is the f-image rescaled to the trained
        rows' median norm (softmax training aligns each row with its mean
        window rep); for binary NCE it is the f-image refitted on the
        entity's slice of the NCE objective against real collection
        windows (``models.lse.fold_in_entity_gradient``), then placed in
        the trained population (:meth:`_match_trained_moments`)."""
        if method not in ("affine", "gradient"):
            raise ValueError(f"unknown fold-in method {method!r}: "
                             "use 'affine' or 'gradient'")
        if not self.recipe.model.model.startswith("lse"):
            raise ValueError(
                "fold-in needs the LSE family: log-linear candidates exist "
                "only as learned projection columns — retrain to add them")
        for name, text in items:
            if not isinstance(name, str) or not isinstance(text, str):
                raise ValueError(
                    "add_entities items must be (str name, str text) pairs")
        if self.score_cfg.similarity != "cosine":
            log.warning(
                "fold-in under similarity=%r: calibration maps folded "
                "scores into [0, probe-top]; trained dot scores are "
                "unbounded, so cross-set ranking is approximate (cosine "
                "recipes are exact)", self.score_cfg.similarity)
        mcfg, window = self.recipe.model, self.recipe.data.window_size
        # The lock spans the whole sequence: fold-in serializes with
        # searches, and the duplicate check is atomic with the append.
        with self._lock:
            # The registry's own index, not a set of every trained name
            # (most of a 0.5 s fold-in call at 1M names on the H100's host).
            taken = set(self._extra_names)
            vecs, names, probes = [], [], {}
            for name, text in items:
                if name in self.registry or name in taken or name in names:
                    raise ValueError(f"entity name {name!r} already indexed")
                ids = self.encode(text)
                if not ids:
                    raise ValueError(
                        f"entity {name!r}: no in-vocab token in its text")
                if method == "gradient":
                    if (mcfg.model == "lse_full"
                            or mcfg.objective == "sampled_softmax"):
                        v = _host(lse_model.fold_in_entity(
                            self.params, ids, mcfg, window_size=window))
                        v = v * (self._trained_stats()[0]
                                 / max(float(np.linalg.norm(v)), 1e-9))
                    else:
                        v = _host(lse_model.fold_in_entity_gradient(
                            self.params, ids, mcfg,
                            self._raw_negative_reps(ids),
                            window_size=window))
                        v = self._match_trained_moments(v)
                else:
                    v = _host(lse_model.fold_in_entity(
                        self.params, ids, mcfg, window_size=window))
                    v = v / max(float(np.linalg.norm(v)), 1e-9)
                    # Term-capped like a query, so `top` is the trained
                    # index's response to this content as a query.
                    probes[name] = ids[:MAX_QUERY_TERMS]
                names.append(name)
                vecs.append(v)
            if probes:   # affine calibration: one batched engine call
                # ``method`` is one per call: probes holds every name.
                run = self._score(probes)
                floors = self._background_reps() @ np.stack(vecs).T
            spans = []
            for j, name in enumerate(names):
                if name not in probes:   # gradient: raw trained geometry
                    spans.append((0.0, 0.0))
                    continue
                probe = run[name]
                # A non-positive probe top means the trained index calls
                # this content noise; folded scores clamp to 0 there.
                top = max(float(probe[0][1]), 0.0) if probe else 0.0
                spans.append((float(floors[:, j].mean()), top))
            # vecs/spans/raw BEFORE names: entries only append, so a
            # concurrent reader pairing names[i] with vecs[i]/spans[i]
            # always sees a consistent prefix.
            stacked = np.stack(vecs)
            spn = np.asarray(spans, np.float64)
            raw = np.asarray([n not in probes for n in names], bool)
            self._extra_vecs = (stacked if self._extra_vecs is None else
                                np.concatenate([self._extra_vecs, stacked]))
            self._extra_spans = (spn if self._extra_spans is None else
                                 np.concatenate([self._extra_spans, spn]))
            self._extra_raw = (raw if self._extra_raw is None else
                               np.concatenate([self._extra_raw, raw]))
            self._extra_names = self._extra_names + names
        return len(names)

    def _background_reps(self, n_windows: int = 64, seed: int = 0,
                         raw: bool = False) -> np.ndarray:
        """[n, d_e] fp32 reps of background windows, computed once per
        variant with numpy's ``default_rng(seed)`` (the reference's draws).
        Unit rows by default: ``n_windows`` windows of terms drawn from the
        collection distribution (lm_stats, else uniform over the vocab),
        the affine calibration's yardstick. ``raw=True``: up to 2048
        unnormalized reps of real training windows from the first instance
        shard, the gradient fold-in's negative pool (the synthesized draw
        where there is no shard)."""
        attr = "_bg_reps_raw" if raw else "_bg_reps"
        if getattr(self, attr, None) is None:
            rng = np.random.default_rng(seed)
            wins = lens = None
            if raw:
                n_windows = max(n_windows, 2048)
                try:
                    shard = InstanceDataset(self.data_dir).shard_paths[0]
                    with np.load(shard) as z:
                        total = z["windows"].shape[0]
                        sel = np.sort(rng.choice(
                            total, size=min(n_windows, total),
                            replace=False))
                        wins = z["windows"][sel].astype(np.int32)
                        lens = z["lengths"][sel].astype(np.int32)
                except (FileNotFoundError, KeyError, IndexError):
                    pass
            if wins is None:
                V = len(self.vocab)
                w = self.recipe.data.window_size
                try:
                    lm, _, _ = load_lm(self.data_dir)
                    p = lm.stats.collection_counts.astype(np.float64)
                    p = p / p.sum() if p.sum() > 0 else None
                except (FileNotFoundError, ValueError):
                    p = None
                wins = rng.choice(V, size=(n_windows, w), p=p).astype(
                    np.int32)
                lens = np.full(n_windows, w, np.int32)
            with torch.no_grad():
                reps = _host(lse_model.host_window_rep(
                    self.params, wins, lens, self.recipe.model))
            if not raw:
                reps = reps / np.maximum(
                    np.linalg.norm(reps, axis=-1, keepdims=True), 1e-9)
            else:
                self._bg_raw_pool = (wins, lens)
            setattr(self, attr, reps)
        return getattr(self, attr)

    def _raw_negative_reps(self, entity_term_ids) -> np.ndarray:
        """The gradient fold-in's negative pool for ONE entity: the raw
        background reps minus windows that are mostly (> 50 %) the
        entity's own terms, which as negatives would repel the vector from
        its own direction. Keeps at least the 64 least-overlapping
        windows."""
        reps = self._background_reps(raw=True)
        pool = getattr(self, "_bg_raw_pool", None)
        if pool is None:        # synthesized fallback pool: iid draws carry
            return reps         # no entity structure to contaminate
        wins, lens = pool
        member = np.isin(wins, np.fromiter(entity_term_ids, np.int32))
        valid = np.arange(wins.shape[1])[None, :] < lens[:, None]
        frac = (member & valid).sum(1) / np.maximum(lens, 1)
        keep = frac <= 0.5
        if keep.sum() < min(64, len(frac)):
            keep = frac <= np.partition(frac, 63)[63] if len(frac) > 64 \
                else np.ones_like(keep)
        return reps[keep]

    def _trained_stats(self, sample: int = 4096) -> Tuple[float, float]:
        """(median row norm, median per-row mean background cosine) of up
        to ``sample`` evenly spaced trained entity rows, cached: the
        yardsticks a gradient-folded vector is matched against."""
        if getattr(self, "_trained_stats_cache", None) is None:
            E = self.num_entities
            idx = np.linspace(0, E - 1, num=min(sample, E)).astype(np.int64)
            emb = self.params["entity_emb"]
            rows = _host(emb[torch.from_numpy(idx).to(emb.device)])
            norms = np.linalg.norm(rows, axis=-1)
            rows_n = rows / np.maximum(norms[:, None], 1e-9)
            neg = self._background_reps(raw=True)
            neg_n = neg / np.maximum(
                np.linalg.norm(neg, axis=-1, keepdims=True), 1e-9)
            bg = (neg_n @ rows_n.T).mean(axis=0)       # per-row bg mean cos
            self._trained_stats_cache = (float(np.median(norms)),
                                         float(np.median(bg)))
        return self._trained_stats_cache

    def _match_trained_moments(self, v: np.ndarray) -> np.ndarray:
        """Place an NCE-refitted vector in the trained population: shift it
        against the mean background direction (bisection) until its mean
        background cosine equals the trained rows' median (NCE alone
        leaves it less anti-correlated with the background than sibling
        competition left the trained rows), then rescale it to their
        median norm (full-batch adam overshoots the norm)."""
        norm_med, bg_target = self._trained_stats()
        neg = self._background_reps(raw=True)
        neg_n = neg / np.maximum(
            np.linalg.norm(neg, axis=-1, keepdims=True), 1e-9)
        u = neg_n.mean(axis=0)
        u = u / max(float(np.linalg.norm(u)), 1e-9)
        vn = v / max(float(np.linalg.norm(v)), 1e-9)

        def bg(a):
            w = vn - a * u
            w = w / max(float(np.linalg.norm(w)), 1e-9)
            return float((neg_n @ w).mean())

        lo, hi = 0.0, 4.0
        if bg(lo) > bg_target:          # only shift DOWN toward the target
            for _ in range(30):
                mid = 0.5 * (lo + hi)
                if bg(mid) > bg_target:
                    lo = mid
                else:
                    hi = mid
            vn = vn - 0.5 * (lo + hi) * u
            vn = vn / max(float(np.linalg.norm(vn)), 1e-9)
        return vn * norm_med

    @property
    def num_extra_entities(self) -> int:
        return len(self._extra_names)

    def _merge_extra_batch(self, ids_list, hits_list, kk):
        """Score the folded-in entities for a batch of queries and merge
        them into each query's engine hits, on the host (Python's stable
        sort: an extra that ties sits after the engine's hits). One
        window-rep dispatch for the batch; the caller holds the lock.
        Query ids are term-capped as the engine caps them. Affine entities
        score by their calibrated f-cosine, gradient ones as trained rows
        do (cosine, or the raw dot product)."""
        names, vecs = self._extra_names, self._extra_vecs   # prefix-stable
        spans, raw_mask = self._extra_spans, self._extra_raw
        if not names:
            return [h[:kk] for h in hits_list]
        capped = [ids[:MAX_QUERY_TERMS] for ids in ids_list]
        Q = len(capped)
        T = max(max(len(c) for c in capped), 1)
        t = np.zeros((Q, T), np.int32)
        n_t = np.zeros((Q,), np.int32)
        for i, c in enumerate(capped):
            t[i, :len(c)] = c
            n_t[i] = len(c)
        with torch.no_grad():
            reps_raw = _host(lse_model.host_window_rep(
                self.params, t, n_t, self.recipe.model))     # [Q, d_e]
        reps = reps_raw / np.maximum(
            np.linalg.norm(reps_raw, axis=-1, keepdims=True), 1e-9)
        n = min(len(names), vecs.shape[0], spans.shape[0], raw_mask.shape[0])
        vecs_n = vecs[:n] / np.maximum(
            np.linalg.norm(vecs[:n], axis=-1, keepdims=True), 1e-9)
        cos = reps @ vecs_n.T                                # [Q, n]
        floor, top = spans[:n, 0], spans[:n, 1]
        side = (np.maximum(cos - floor[None, :], 0.0)
                / np.maximum(1.0 - floor[None, :], 1e-9) * top[None, :])
        if raw_mask[:n].any():
            raw_side = (cos if self.score_cfg.similarity == "cosine"
                        else reps_raw @ vecs[:n].T)
            side = np.where(raw_mask[:n][None, :], raw_side, side)
        out = []
        for qi, hits in enumerate(hits_list):
            merged = list(hits) + list(zip(names[:n], side[qi].tolist()))
            merged.sort(key=lambda e: -e[1])
            out.append(merged[:kk])
        return out

    def _clamp_k(self, k: Optional[int]) -> int:
        """Requested k -> [1, k_max]; None and non-positive values fall
        back to the default."""
        if k is None or k < 1:
            return min(self.default_k, self.k_max)
        return min(k, self.k_max)


def serve_stdin(searcher: EntitySearcher, in_stream, out_stream) -> None:
    """One query per line ('qid<TAB>text' or bare text); ranked entities as
    'qid<TAB>rank<TAB>entity<TAB>score' lines; empty line or EOF exits."""
    qn = 0
    for line in in_stream:
        line = line.rstrip("\n")
        if not line.strip():
            break
        if "\t" in line:
            qid, text = line.split("\t", 1)
        else:
            qn += 1
            qid, text = f"q{qn}", line
        hits = searcher.search(text)
        if hits is None:
            print(f"{qid}\t-\t-\t-\t# all terms out of vocabulary",
                  file=out_stream, flush=True)
            continue
        for rank, (name, score) in enumerate(hits, 1):
            print(f"{qid}\t{rank}\t{name}\t{score:.6f}", file=out_stream)
        out_stream.flush()


def _hits_payload(query: str, hits) -> dict:
    if hits is None:
        return {"query": query, "results": [],
                "warning": "all query terms out of vocabulary"}
    return {"query": query,
            "results": [{"rank": r, "entity": name, "score": float(s)}
                        for r, (name, s) in enumerate(hits, 1)]}


def _search_payload(searcher: EntitySearcher, query: str,
                    k: Optional[int]) -> dict:
    return _hits_payload(query, searcher.search(query, k=k))


class _Handler(BaseHTTPRequestHandler):
    # set by make_http_server
    searcher: EntitySearcher = None

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route through the package logger
        log.debug("http: " + fmt, *args)

    def _body(self) -> dict:
        # max(0): a negative Content-Length would read until EOF and park
        # this handler thread on a held-open connection.
        n = max(int(self.headers.get("Content-Length", 0)), 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._reply(200, {
                "status": "ok",
                "entities": self.searcher.num_entities,
                "extra_entities": self.searcher.num_extra_entities,
                "model": self.searcher.recipe.model.model,
                "vocab_size": len(self.searcher.vocab),
                "k_default": self.searcher.default_k,
                "k_max": self.searcher.k_max,
            })
            return
        if url.path == "/search":
            q = parse_qs(url.query)
            query = (q.get("q") or q.get("query") or [""])[0]
            if not query:
                self._reply(400, {"error": "missing q= parameter"})
                return
            try:
                k = int(q["k"][0]) if "k" in q else None
            except ValueError:
                self._reply(400, {"error": "k must be an integer"})
                return
            self._reply(200, _search_payload(self.searcher, query, k))
            return
        self._reply(404, {"error": f"unknown path {url.path!r}; "
                                   "use /healthz or /search"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path == "/entities":
            # Fold-in: {"entities": [{"name": ..., "text": ...}, ...],
            #           "method": "affine" (default) | "gradient"}
            try:
                req = self._body()
                items = req.get("entities")
                method = req.get("method", "affine")
                if not isinstance(method, str):
                    raise ValueError("'method' must be a string")
                if (not isinstance(items, list) or not items
                        or not all(isinstance(e, dict)
                                   and isinstance(e.get("name"), str)
                                   and e.get("name")
                                   and isinstance(e.get("text"), str)
                                   and e.get("text") for e in items)):
                    raise ValueError(
                        "'entities' must be a non-empty list of "
                        "{name: str, text: str} objects")
                added = self.searcher.add_entities(
                    [(e["name"], e["text"]) for e in items], method=method)
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, {
                "added": added,
                "extra_entities": self.searcher.num_extra_entities})
            return
        if url.path != "/search":
            self._reply(404, {"error": f"unknown path {url.path!r}"})
            return
        try:
            req = self._body()
            query = req.get("query") or req.get("q") or ""
            queries = req.get("queries")
            k = req.get("k")
            # bool is an int subclass; floats are refused like the GET
            # path's "k must be an integer", not truncated.
            if k is not None and (isinstance(k, bool)
                                  or not isinstance(k, int)):
                raise ValueError("k must be an integer")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"})
            return
        if queries is not None:
            if (not isinstance(queries, list)
                    or not all(isinstance(q, str) for q in queries)):
                self._reply(400, {"error": "'queries' must be a list of "
                                           "strings"})
                return
            batches = self.searcher.search_many(queries, k=k)
            self._reply(200, {"batched": [
                _hits_payload(q, hits) for q, hits in zip(queries, batches)
            ]})
            return
        if not query:
            self._reply(400, {"error": "missing 'query' or 'queries' field"})
            return
        self._reply(200, _search_payload(self.searcher, query, k))


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of concurrent clients
    # past the fifth has its connects dropped, and each retries after a
    # second (16 clients took 1.05 s on the H100's host, one query 11 ms).
    request_queue_size = 128


def make_http_server(searcher: EntitySearcher, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server; ``port=0`` binds an
    ephemeral port. Call ``serve_forever()`` / ``shutdown()``."""
    handler = type("BoundHandler", (_Handler,), {"searcher": searcher})
    return _Server((host, port), handler)
