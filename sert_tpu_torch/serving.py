"""Query serving: the scorer staged once behind a reusable searcher (port
of ``sert_tpu/serving.py``: ``EntitySearcher`` :65-256 and
``serve_stdin`` :612).

  * :class:`EntitySearcher` loads a trained run onto a device, resolves
    the engine, stages the entity matrix once (kernel engine), fires one
    warm-up dispatch (which also builds the kernels), and answers
    free-text queries with a thread-safe ``search`` / ``search_many``;
  * :func:`serve_stdin` is the interactive loop used by ``serve``.

Concurrent requests micro-batch: the first free thread becomes the leader,
drains every request that arrived while the previous dispatch ran, and
answers them all with one engine call; a lone request dispatches at once.

Fold-in (``add_entities``) and the HTTP server are not ported yet
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

from sert_tpu_torch import pipeline
from sert_tpu_torch.data.instances import InstanceDataset
from sert_tpu_torch.data.prepare import encode_queries
from sert_tpu_torch.models.api import entity_matrix
from sert_tpu_torch.scoring.run import (resolve_engine, score_topics,
                                        stage_entities)
from sert_tpu_torch.utils.config import RecipeConfig


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
        self._lock = threading.Lock()   # the one device-dispatch lock
        self.prep = None
        self.engine = resolve_engine(
            self.score_cfg, self.num_entities, self.device,
            entity_matrix(self.params, self.recipe.model).shape[1])
        if self.engine == "pallas":
            self.prep = stage_entities(self.params, self.recipe.model,
                                       self.score_cfg)
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
        the staged k cap and hand each request its slice."""
        flat: List[List[int]] = []
        for r in reqs:
            flat.extend(ids for ids in r.ids_list if ids)
        hits = []
        if flat:
            keys = [str(i) for i in range(len(flat))]
            with self._lock:
                run = self._score(dict(zip(keys, flat)))
            hits = [run[key] for key in keys]
        it = iter(hits)
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
