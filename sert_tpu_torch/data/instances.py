"""Serialized training instances: sharded on-disk batches.

Reference behavior (SURVEY.md sections 3.1/4.1): the prepare step serializes
shuffled instance batches to disk; the trainer streams them per epoch. Here a
shard is one ``.npz`` with three aligned int32 arrays (windows [N, w],
lengths [N], entities [N]) plus a JSON meta file for the whole dataset.

Determinism & resume contract: iteration order is a pure function of
(seed, epoch); the (epoch, shard, batch) cursor stored in checkpoints makes
resume exact (SURVEY.md section 6, checkpoint/resume).
"""

from __future__ import annotations

import io
import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

META_NAME = "instances.meta.json"


class InstanceWriter:
    """Accumulates (windows, lengths, entities) arrays and writes shards.

    Instances are shuffled within each shard at write time (reference
    semantics: shuffled batches on disk); cross-shard order is randomized per
    epoch by the reader.
    """

    def __init__(self, out_dir: str, window_size: int,
                 instances_per_shard: int = 1 << 18, seed: int = 0):
        self.out_dir = out_dir
        self.window_size = int(window_size)
        self.instances_per_shard = int(instances_per_shard)
        self._rng = np.random.default_rng(seed)
        self._buf_w: List[np.ndarray] = []
        self._buf_l: List[np.ndarray] = []
        self._buf_e: List[np.ndarray] = []
        self._buffered = 0
        self._shards: List[Dict] = []
        os.makedirs(out_dir, exist_ok=True)

    def add(self, windows: np.ndarray, lengths: np.ndarray, entities: np.ndarray) -> None:
        if windows.shape[0] == 0:
            return
        assert windows.shape[1] == self.window_size
        self._buf_w.append(np.asarray(windows, np.int32))
        self._buf_l.append(np.asarray(lengths, np.int32))
        self._buf_e.append(np.asarray(entities, np.int32))
        self._buffered += windows.shape[0]
        while self._buffered >= self.instances_per_shard:
            self._flush(self.instances_per_shard)

    def _flush(self, n: int) -> None:
        w = np.concatenate(self._buf_w)
        l = np.concatenate(self._buf_l)
        e = np.concatenate(self._buf_e)
        take_w, rest_w = w[:n], w[n:]
        take_l, rest_l = l[:n], l[n:]
        take_e, rest_e = e[:n], e[n:]
        perm = self._rng.permutation(take_w.shape[0])
        idx = len(self._shards)
        path = os.path.join(self.out_dir, f"shard-{idx:05d}.npz")
        np.savez(path, windows=take_w[perm], lengths=take_l[perm], entities=take_e[perm])
        self._shards.append({"path": os.path.basename(path), "num": int(take_w.shape[0])})
        self._buf_w, self._buf_l, self._buf_e = [rest_w], [rest_l], [rest_e]
        self._buffered = int(rest_w.shape[0])

    def finalize(self, extra_meta: Optional[Dict] = None) -> Dict:
        if self._buffered:
            self._flush(self._buffered)
        meta = {
            "window_size": self.window_size,
            "num_instances": int(sum(s["num"] for s in self._shards)),
            "shards": self._shards,
        }
        if extra_meta:
            meta.update(extra_meta)
        with open(os.path.join(self.out_dir, META_NAME), "w") as fh:
            json.dump(meta, fh, indent=2)
        return meta


Cursor = Tuple[int, int, int]  # (epoch, shard_position, batch_within_shard)


class InstanceDataset:
    """Deterministic shuffled batch iterator over instance shards.

    Per epoch: shard order is permuted by ``default_rng((seed, epoch))`` and
    each shard is permuted in-memory, so two processes with the same seed see
    identical streams. ``iter_batches`` can start from a cursor for exact
    resume. Trailing instances that do not fill a batch are dropped (static
    shapes for the compiled train step).
    """

    def __init__(self, data_dir: str, seed: int = 0):
        self.data_dir = data_dir
        self.seed = int(seed)
        with open(os.path.join(data_dir, META_NAME)) as fh:
            self.meta = json.load(fh)
        self.window_size = int(self.meta["window_size"])
        self.num_instances = int(self.meta["num_instances"])
        self._shard_files = [s["path"] for s in self.meta["shards"]]

    @property
    def shard_paths(self) -> List[str]:
        """Absolute paths of the instance shard .npz files, in meta order."""
        return [os.path.join(self.data_dir, n) for n in self._shard_files]

    def num_batches_per_epoch(self, batch_size: int,
                              readers: Optional[Tuple[int, int]] = None
                              ) -> int:
        # Lower bound: per-shard drop-last. With ``readers=(r, P)`` this is
        # the LOCKSTEP epoch length: the minimum local batch count over all
        # P readers (identical for every r — the global assembly needs all
        # readers to contribute one sub-batch per step, so the epoch stops
        # when the thinnest reader runs dry).
        if readers is None:
            return sum(s["num"] // batch_size for s in self.meta["shards"])
        _, P = readers
        if P > len(self._shard_files):
            raise ValueError(
                f"{P} readers over {len(self._shard_files)} instance "
                "shards leaves some readers with no data; lower the "
                "reader count or raise data.instances_per_shard at "
                "prepare time so every process owns at least one shard")
        return min(
            sum(s["num"] // batch_size
                for s in self.meta["shards"][q::P])
            for q in range(P))

    def _load_shard(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        # ONE bulk sequential read, then parse the zip container in memory.
        # np.load on a file object issues many small chunked reads through
        # zipfile; on high-latency block devices that measures ~4x slower
        # than the device's sequential rate (8 vs 30 MB/s cold on the
        # 1M-stress dataset — benchmarks/NOTES.md, feeder section).
        with open(os.path.join(self.data_dir, name), "rb") as fh:
            raw = fh.read()
        with np.load(io.BytesIO(raw)) as z:
            return z["windows"], z["lengths"], z["entities"]

    def iter_batches(
        self,
        batch_size: int,
        epoch: int,
        start_cursor: Optional[Cursor] = None,
        readers: Optional[Tuple[int, int]] = None,
    ) -> Iterator[Tuple[Dict[str, np.ndarray], Cursor]]:
        """Yield (batch dict, cursor-of-NEXT-batch) pairs for one epoch.

        ``readers=(r, P)`` is the multi-host ingestion mode (SURVEY.md
        section 6, comm-backend row): reader r streams ONLY its own shard
        subset (raw meta order ``[r::P]`` — fixed across epochs, so every
        file is read by exactly one process), in a per-epoch permuted
        order, yielding ``batch_size``-row LOCAL sub-batches. The global
        batch is the concatenation of the P readers' sub-batches for the
        same step (``iter_global_batches`` builds that composition in one
        process; ``parallel/train``'s per-process put assembles it on a
        mesh without any process materializing the whole batch). All
        readers stop at the lockstep epoch length
        (``num_batches_per_epoch(batch_size, readers)``), so a stored
        cursor — ``(epoch, consumed_batches, 0)`` in this mode, identical
        on every process — resumes every reader consistently.
        """
        if readers is not None:
            yield from self._iter_reader(batch_size, epoch, start_cursor,
                                         readers)
            return
        rng = np.random.default_rng([self.seed, epoch])
        shard_order = rng.permutation(len(self._shard_files))
        # One sub-rng per shard, drawn up-front so skipping shards on resume
        # does not change later shards' permutations.
        shard_seeds = rng.integers(0, 2**63 - 1, size=len(self._shard_files))

        start_shard, start_batch = 0, 0
        if start_cursor is not None:
            c_epoch, start_shard, start_batch = start_cursor
            assert c_epoch == epoch, "cursor epoch mismatch"

        def load_permuted(si: int):
            w, l, e = self._load_shard(self._shard_files[shard_order[si]])
            perm = np.random.default_rng(
                shard_seeds[si]).permutation(w.shape[0])
            return w[perm], l[perm], e[perm]

        # One-slot shard readahead: shard si+1 loads (disk read + permute)
        # on a daemon thread while si's batches are consumed. The disk here
        # sits behind ~10 ms of per-IO latency, so an unhidden cold shard
        # load stalls the feed for seconds at every shard boundary — the
        # measured host-side epoch rate on the 1M-stress dataset was 50
        # batches/s against the device's 77 steps/s (NOTES.md).
        nxt_result: List = [None, None]  # (exception?, tuple)

        def prefetch(si: int) -> threading.Thread:
            def work():
                try:
                    nxt_result[0], nxt_result[1] = None, load_permuted(si)
                except BaseException as exc:  # re-raised on the consumer side
                    nxt_result[0], nxt_result[1] = exc, None
            t = threading.Thread(target=work, daemon=True)
            t.start()
            return t

        pending: Optional[threading.Thread] = None
        for si in range(start_shard, len(shard_order)):
            if pending is None:
                w, l, e = load_permuted(si)
            else:
                pending.join()
                if nxt_result[0] is not None:
                    raise nxt_result[0]
                w, l, e = nxt_result[1]
            if si + 1 < len(shard_order):
                pending = prefetch(si + 1)
            else:
                pending = None
            n_batches = w.shape[0] // batch_size
            b0 = start_batch if si == start_shard else 0
            for bi in range(b0, n_batches):
                lo, hi = bi * batch_size, (bi + 1) * batch_size
                batch = {"windows": w[lo:hi], "lengths": l[lo:hi], "entities": e[lo:hi]}
                nxt: Cursor = (epoch, si, bi + 1) if bi + 1 < n_batches else (epoch, si + 1, 0)
                yield batch, nxt

    def _iter_reader(self, batch_size: int, epoch: int,
                     start_cursor: Optional[Cursor],
                     readers: Tuple[int, int]
                     ) -> Iterator[Tuple[Dict[str, np.ndarray], Cursor]]:
        r, P = readers
        if not 0 <= r < P:
            raise ValueError(f"reader id {r} outside [0, {P})")
        limit = self.num_batches_per_epoch(batch_size, readers)
        my_shards = list(range(len(self._shard_files)))[r::P]
        # Per-(epoch, reader) order + per-shard permutation seeds, drawn
        # up-front so arithmetic shard skipping on resume cannot shift
        # later shards' permutations (same contract as the single-reader
        # path).
        rng = np.random.default_rng([self.seed, epoch, r])
        order = rng.permutation(len(my_shards))
        shard_seeds = rng.integers(0, 2**63 - 1, size=len(my_shards))

        consumed0 = 0
        if start_cursor is not None:
            c_epoch, consumed0, _ = start_cursor
            assert c_epoch == epoch, "cursor epoch mismatch"

        def load_permuted(oi: int):
            name = self._shard_files[my_shards[order[oi]]]
            w, l, e = self._load_shard(name)
            perm = np.random.default_rng(
                shard_seeds[oi]).permutation(w.shape[0])
            return w[perm], l[perm], e[perm]

        def shard_batches(oi: int) -> int:
            return (self.meta["shards"][my_shards[order[oi]]]["num"]
                    // batch_size)

        # Arithmetic seek: skip whole already-consumed shards without
        # loading them (resume must not replay or re-read).
        emitted, oi0, b0 = 0, 0, 0
        while oi0 < len(order) and emitted + shard_batches(oi0) <= consumed0:
            emitted += shard_batches(oi0)
            oi0 += 1
        b0 = consumed0 - emitted

        nxt_result: List = [None, None]

        def prefetch(oi: int) -> threading.Thread:
            def work():
                try:
                    nxt_result[0], nxt_result[1] = None, load_permuted(oi)
                except BaseException as exc:
                    nxt_result[0], nxt_result[1] = exc, None
            t = threading.Thread(target=work, daemon=True)
            t.start()
            return t

        consumed = consumed0
        pending: Optional[threading.Thread] = None
        for oi in range(oi0, len(order)):
            if consumed >= limit:
                return
            if pending is None:
                w, l, e = load_permuted(oi)
            else:
                pending.join()
                if nxt_result[0] is not None:
                    raise nxt_result[0]
                w, l, e = nxt_result[1]
            if oi + 1 < len(order):
                pending = prefetch(oi + 1)
            else:
                pending = None
            n_batches = w.shape[0] // batch_size
            for bi in range(b0 if oi == oi0 else 0, n_batches):
                lo, hi = bi * batch_size, (bi + 1) * batch_size
                yield ({"windows": w[lo:hi], "lengths": l[lo:hi],
                        "entities": e[lo:hi]},
                       (epoch, consumed + 1, 0))
                consumed += 1
                if consumed >= limit:
                    return

    def iter_global_batches(
        self,
        batch_size: int,
        epoch: int,
        num_readers: int,
        start_cursor: Optional[Cursor] = None,
    ) -> Iterator[Tuple[Dict[str, np.ndarray], Cursor]]:
        """Single-process emulation of the multi-host composition: zip the
        ``num_readers`` reader streams and concatenate their sub-batches
        into one global batch of ``batch_size * num_readers`` rows — row
        block p is exactly what process p feeds on a pod, so a run fed
        this way is step-for-step comparable with a per-process-fed run
        (tests/test_multihost.py proves the equality)."""
        its = [self.iter_batches(batch_size, epoch,
                                 start_cursor=start_cursor, readers=(q, num_readers))
               for q in range(num_readers)]
        for items in zip(*its):
            yield ({k: np.concatenate([b[k] for b, _ in items])
                    for k in items[0][0]},
                   items[0][1])
