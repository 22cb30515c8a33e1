"""Multiprocessing tokenize/encode for the prepare pipeline.

The reference overlapped batch construction with compute via
multiprocessing workers (SURVEY.md section 4.2). In this framework the
training-side feed is already covered by pre-serialized shards + the
threaded prefetch feeder; the remaining Python-bound hot loop is corpus
tokenization during prepare. This module fans it out over a process pool
with DETERMINISTIC output order (ordered imap), so parallel and serial
prepares produce byte-identical artifacts.

Workers hold the vocabulary/config in process-global state (set once by the
pool initializer) — pickling a 100k-term dict per task would erase the win.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from collections import Counter
from typing import Dict, Iterator, List, Optional, Tuple

from sert_tpu_torch.data.tokenize import tokenize_cfg
from sert_tpu_torch.utils.config import DataConfig

_WORKER_STATE: dict = {}


def _init_worker(cfg: DataConfig, vocab_index: Optional[Dict[str, int]]) -> None:
    _WORKER_STATE["cfg"] = cfg
    _WORKER_STATE["index"] = vocab_index


_tok = tokenize_cfg   # shared option plumbing: data.tokenize.config_opts


def _count_chunk(texts: List[str]) -> Counter:
    cfg = _WORKER_STATE["cfg"]
    c: Counter = Counter()
    for t in texts:
        c.update(_tok(t, cfg))
    return c


def _encode_chunk(items: List[Tuple[str, str]]) -> List[Tuple[str, List[int]]]:
    cfg, index = _WORKER_STATE["cfg"], _WORKER_STATE["index"]
    out = []
    for doc_id, text in items:
        out.append((doc_id,
                    [index[t] for t in _tok(text, cfg) if t in index]))
    return out


def _chunks(seq: List, n: int) -> Iterator[List]:
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def _pool_context():
    """Pick the safest start method available to this caller.

    forkserver avoids forking the (JAX-threaded) parent — Python 3.12 warns
    that such forks can deadlock children. But forkserver/spawn re-import
    the caller's __main__, which is impossible for stdin/REPL callers
    (multiprocessing would loop respawning FileNotFoundError workers), so
    those fall back to fork: safe in practice here because workers touch
    only re/collections before exec'ing their task.
    """
    import os
    import sys
    main = sys.modules.get("__main__")
    main_file = getattr(main, "__file__", None)
    # NB: stdin scripts report __file__='<stdin>' — truthy but not a real
    # path, so existence must be checked, not just presence.
    importable = (getattr(main, "__spec__", None) is not None
                  or (main_file is not None and os.path.exists(main_file)))
    return mp.get_context("forkserver" if importable else "fork")


# Recursion guard: forkserver/spawn workers re-import the caller's __main__
# (as __mp_main__); an UNGUARDED top-level script calling prepare() would
# otherwise re-enter pool creation from inside each worker bootstrap — a
# fork bomb. Children inherit this env marker (set only while workers are
# being spawned) and run serially instead. Scripts should still follow the
# standard multiprocessing rule: put work under `if __name__ == "__main__"`.
_BOOTSTRAP_ENV = "SERT_MP_BOOTSTRAP"


def _make_pool(num_workers: int, initargs):
    if os.environ.get(_BOOTSTRAP_ENV):
        return None  # inside a worker bootstrap: caller runs serially
    os.environ[_BOOTSTRAP_ENV] = "1"
    try:
        return _pool_context().Pool(num_workers, initializer=_init_worker,
                                    initargs=initargs)
    finally:
        del os.environ[_BOOTSTRAP_ENV]


def parallel_term_counts(texts: List[str], cfg: DataConfig,
                         num_workers: int, chunk: int = 256) -> Counter:
    """Merged token counts over all texts (vocabulary pass 1)."""
    pool = _make_pool(num_workers, (cfg, None))
    total: Counter = Counter()
    if pool is None:
        _init_worker(cfg, None)
        for part in _chunks(texts, chunk):
            total.update(_count_chunk(part))
        return total
    with pool:
        for c in pool.imap(_count_chunk, _chunks(texts, chunk)):
            total.update(c)
    return total


def parallel_encode(items: List[Tuple[str, str]], cfg: DataConfig,
                    vocab_index: Dict[str, int], num_workers: int,
                    chunk: int = 256) -> Iterator[Tuple[str, List[int]]]:
    """(doc_id, token_ids) in the INPUT order (vocabulary pass 2)."""
    pool = _make_pool(num_workers, (cfg, vocab_index))
    if pool is None:
        _init_worker(cfg, vocab_index)
        for part in _chunks(items, chunk):
            yield from _encode_chunk(part)
        return
    with pool:
        for batch in pool.imap(_encode_chunk, _chunks(items, chunk)):
            yield from batch
