"""The epoch loop: feed, step, log, snapshot, resume (port of
``sert_tpu/train/loop.py``: ``train`` :32, ``_group_batches`` :481,
``_batch_put`` :503).

A PrefetchFeeder copies the next batches to the device while the current
step runs, metrics stream to JSONL with one host sync per log interval,
and checkpoints carry the exact (epoch, shard, batch) cursor, so resume
replays nothing and skips nothing. With ``packed_feed="on"`` the feeder
thread packs each batch (or stacked group) into the wire format of
``data/wirepack.py`` before the copy, and the step unpacks it on the
device, so every step receives the standard int32 batch.

A recipe whose ``mesh_shape`` holds more than one rank trains on the mesh
(``parallel/``: the sharded step, each rank its rows and its entity
blocks) when the world of ranks holds it, fed per data rank from the
instance shards of its reader where there are several data ranks and
several processes; with fewer ranks than the mesh asks for, one rank
trains alone after the reference's warning. Checkpoints on a mesh are
gathered and written by rank 0 in the one-card format; a resume reads the
full file and keeps this rank's blocks.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from sert_tpu_torch.data import wirepack
from sert_tpu_torch.data.feeder import DevicePut, PrefetchFeeder
from sert_tpu_torch.data.instances import InstanceDataset
from sert_tpu_torch.models import lse as lse_model
from sert_tpu_torch.parallel.mesh import make_mesh, world_rank, world_size
from sert_tpu_torch.parallel.sharding import (batch_rows, gather_state,
                                              shard_state)
from sert_tpu_torch.parallel.train import (make_sharded_train_step,
                                           state_specs)
from sert_tpu_torch.pipeline import resolve_device
from sert_tpu_torch.train import checkpoint as ckpt
from sert_tpu_torch.train import sparse
from sert_tpu_torch.train.step import TrainState, init_state, make_train_step
from sert_tpu_torch.utils.config import RecipeConfig, config_to_dict
from sert_tpu_torch.utils.logging import JsonlLogger, get_logger

log = get_logger("train")


def _check_supported(recipe: RecipeConfig) -> None:
    tcfg = recipe.train
    if tcfg.packed_feed not in ("auto", "on", "off"):
        raise ValueError(f"unknown packed_feed: {tcfg.packed_feed!r}")
    if tcfg.fused_update not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_update: {tcfg.fused_update!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(recipe: RecipeConfig, dataset: InstanceDataset, out_dir: str,
          entity_counts: Optional[np.ndarray] = None, resume: bool = True,
          device=None, init_params_hook: Optional[Callable] = None
          ) -> TrainState:
    """Run (or resume) training on ``device`` (default: the CUDA card; the
    CPU only when asked for); returns the final TrainState.

    ``init_params_hook(params) -> params`` transforms the fresh
    initialization (e.g. seeding word embeddings from a dump,
    ``pipeline.word_emb_hook``); a resumed run skips it."""
    _check_supported(recipe)
    mcfg, tcfg = recipe.model, recipe.train
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    t_enter = time.perf_counter()
    # Resume continues with the optimizer-state flavor (dense or row-sparse)
    # the newest full checkpoint holds, whatever "auto" resolves to now.
    latest = (ckpt.latest_checkpoint(ckpt_dir, full_only=True)
              if resume else None)
    if latest is not None:
        tcfg = _pin_sparse_update(mcfg, tcfg, latest)

    if tcfg.lr_schedule != "constant" and tcfg.lr_decay_steps <= 0:
        # The run's total step count; a resumed run recomputes the same.
        horizon = max(tcfg.num_epochs
                      * dataset.num_batches_per_epoch(tcfg.batch_size), 1)
        tcfg = dataclasses.replace(tcfg, lr_decay_steps=horizon)
        log.info("lr_schedule=%s: decay horizon filled to %d steps",
                 tcfg.lr_schedule, horizon)

    noise = None
    if mcfg.model == "lse":
        noise = lse_model.noise_logits(
            entity_counts if mcfg.negative_distribution == "unigram" else None,
            mcfg, device)
    mesh, readers, feed_batch = _mesh_branch(tcfg, device)
    specs = rows_fn = None
    if mesh is not None:
        train_step, _, _ = make_sharded_train_step(
            mcfg, tcfg, mesh, noise=noise,
            per_process_feed=readers is not None)
        specs = state_specs(mcfg, tcfg)
        if readers is None:
            bdim = 1 if tcfg.steps_per_call > 1 else 0

            def rows_fn(batch):
                return batch_rows(batch, mesh, bdim)
    else:
        train_step = make_train_step(mcfg, tcfg, noise=noise, device=device)
    pack_fn = None
    if mesh is not None and tcfg.packed_feed == "on":
        log.warning("packed_feed='on' ignored: the sharded train step "
                    "consumes raw batches")
    elif wirepack.feed_enabled(tcfg.packed_feed, mcfg.vocab_size,
                               mcfg.num_entities, recipe.data.window_size):
        V, E = mcfg.vocab_size, mcfg.num_entities
        base_step = train_step

        def train_step(s, packed):
            return base_step(s, wirepack.unpack_batch(packed, V, E))

        def pack_fn(batch):
            return wirepack.pack_batch(batch, V, E)

        log.info("packed feed on (vocab=%d entities=%d): id planes ship at "
                 "true bit width", V, E)

    t_setup = time.perf_counter()
    # On a mesh every rank draws the full state from the seed, and keeps
    # its blocks once a hook or a checkpoint has filled it.
    state = init_state(tcfg.seed, mcfg, tcfg, device,
                       sparse_override=False if mesh is not None else None)
    _sync(device)
    t_init = time.perf_counter()
    start_epoch, cursor = 0, None
    if init_params_hook is not None and latest is None:
        state = dataclasses.replace(state,
                                    params=init_params_hook(state.params))
    if latest is None and resume and ckpt.latest_checkpoint(ckpt_dir):
        log.warning(
            "resume: %s holds only params-only epoch snapshots (no full "
            "train state) — RESTARTING FROM SCRATCH. Use "
            "checkpoint_every_steps for mid-run full saves if crash "
            "recovery matters at this scale.", ckpt_dir)
    if latest is not None:
        state, meta = ckpt.load_checkpoint(latest, state)
        ck_hash = meta.get("vocab_hash")
        ds_hash = dataset.meta.get("vocab_hash")
        if ck_hash and ds_hash and ck_hash != ds_hash:
            raise ValueError(
                f"cannot resume from {latest}: it was trained against a "
                "different vocabulary than the data dir now holds "
                "(re-prepared corpus?); retrain fresh (resume=False / new "
                "out_dir) or restore the original prepared data")
        start_epoch = int(meta.get("epoch", 0))
        cur = meta.get("cursor")
        cursor = tuple(cur) if cur is not None else None
        if cursor is not None and cursor[0] != start_epoch:
            cursor = None
        log.info("resumed from %s (epoch=%d cursor=%s)", latest,
                 start_epoch, cursor)
    if mesh is not None:
        state = shard_state(state, mesh, mcfg, specs)

    meta_common = {"recipe": config_to_dict(recipe),
                   "vocab_hash": dataset.meta.get("vocab_hash")}
    # On a mesh of several ranks, rank 0 keeps the metrics log.
    jlog = JsonlLogger(os.path.join(out_dir, "train_log.jsonl")
                       if world_rank() == 0 else None)
    n_micro = max(tcfg.steps_per_call, 1)
    n_batches = dataset.num_batches_per_epoch(feed_batch, readers=readers)
    if n_batches == 0:
        raise ValueError(
            f"dataset yields 0 full batches of train.batch_size="
            f"{tcfg.batch_size} ({dataset.num_instances} instances spread "
            f"over {len(dataset.meta['shards'])} shards, tails dropped per "
            "shard); every epoch would train 0 steps — lower "
            "train.batch_size or raise data.instances_per_shard")
    if n_micro > n_batches:
        log.warning("steps_per_call=%d exceeds the %d full batches per "
                    "epoch; clamping to %d so epochs are not dropped "
                    "entirely", n_micro, n_batches, n_batches)
        n_micro = n_batches
    stack_groups = tcfg.steps_per_call > 1
    put = DevicePut(device)
    feeders = []
    saver = ckpt.AsyncCheckpointer(mesh, specs)
    sync_saves = not tcfg.async_checkpoint
    try:
        for epoch in range(start_epoch, tcfg.num_epochs):
            t_loop0 = time.perf_counter()
            epoch_cursor = cursor if epoch == start_epoch else None
            batches = dataset.iter_batches(feed_batch, epoch=epoch,
                                           start_cursor=epoch_cursor,
                                           readers=readers)
            batches = _group_batches(batches, n_micro, stack=stack_groups)
            feeder = PrefetchFeeder(batches,
                                    put_fn=_batch_put(put, pack_fn, rows_fn))
            feeders.append(feeder)
            last_cursor = epoch_cursor
            t_last = time.perf_counter()
            prev_step = step_i = state.step
            epoch_losses = []
            last_save_step = -1
            feed_wait = 0.0
            first = epoch == start_epoch
            batch_iter = iter(feeder)
            t_first_feed = time.perf_counter()
            while True:
                t_f = time.perf_counter()
                try:
                    staged, next_cursor = next(batch_iter)
                except StopIteration:
                    break
                feed_wait += time.perf_counter() - t_f
                t_first = time.perf_counter()
                state, metrics = train_step(state, put.ready(staged))
                last_cursor = next_cursor
                step_i = state.step
                if first:
                    first = False
                    _sync(device)
                    now = time.perf_counter()
                    warm = dict(setup_s=round(t_setup - t_enter, 2),
                                init_s=round(t_init - t_setup, 2),
                                pre_loop_s=round(t_loop0 - t_init, 2),
                                feeder_ctor_s=round(t_last - t_loop0, 2),
                                step_sync_s=round(t_first_feed - t_last, 2),
                                first_batch_s=round(t_first - t_first_feed,
                                                    2),
                                first_step_s=round(now - t_first, 2))
                    log.info("warmup: %s", warm)
                    jlog.log("warmup", **warm)
                if (tcfg.log_every_steps
                        and step_i % tcfg.log_every_steps < n_micro):
                    t_s = time.perf_counter()
                    loss = float(metrics["loss"])      # the interval's sync
                    now = time.perf_counter()
                    interval = max(step_i - prev_step, 1)
                    sps = interval / max(now - t_last, 1e-9)
                    t_last, prev_step = now, step_i
                    epoch_losses.append(loss)
                    jlog.log("train_step", step=step_i, epoch=epoch,
                             loss=loss,
                             grad_norm=float(metrics["grad_norm"]),
                             steps_per_sec=sps,
                             instances_per_sec=sps * tcfg.batch_size,
                             feed_wait_ms=feed_wait * 1e3 / interval,
                             device_sync_ms=(now - t_s) * 1e3)
                    feed_wait = 0.0
                if (tcfg.checkpoint_every_steps
                        and step_i % tcfg.checkpoint_every_steps < n_micro):
                    saver.save(ckpt_dir, step_i, state,
                               {"epoch": epoch, "cursor": list(last_cursor),
                                **meta_common},
                               max_to_keep=tcfg.keep_checkpoints,
                               sync=sync_saves)
                    last_save_step = step_i
            if last_save_step == step_i:
                # The mid-epoch save already holds this state: upgrade its
                # sidecar to the epoch snapshot.
                saver.wait()
                ckpt.rewrite_meta(ckpt_dir, step_i,
                                  {"epoch": epoch + 1, "cursor": None,
                                   **meta_common}, mesh=mesh)
            else:
                final = epoch + 1 == tcfg.num_epochs
                every = max(1, tcfg.epoch_snapshot_every)
                if final or (epoch + 1) % every == 0:
                    # Each knob governs its own epochs: final_snapshot the
                    # last, epoch_snapshot the others.
                    p_only = ((tcfg.final_snapshot if final
                               else tcfg.epoch_snapshot) == "params")
                    saver.save(
                        ckpt_dir, step_i, state,
                        {"epoch": epoch + 1, "cursor": None, **meta_common},
                        max_to_keep=tcfg.keep_checkpoints, sync=sync_saves,
                        params_only=p_only,
                        params_dtype=tcfg.snapshot_dtype if p_only else None)
                else:
                    jlog.log("epoch_snapshot_skipped", epoch=epoch,
                             step=step_i, every=every)
            log.info("epoch %d done at step %d%s", epoch, step_i,
                     (" (mean logged loss %.4f)" % float(np.mean(epoch_losses)))
                     if epoch_losses else "")
            jlog.log("epoch_end", epoch=epoch, step=step_i)
            cursor = None
    finally:
        for f in feeders:
            f.close()
        jlog.close()
        # Returning means the latest snapshot is on disk; a writer failure
        # must not mask an exception already on its way out.
        if sys.exc_info()[0] is None:
            saver.wait()
        else:
            try:
                saver.wait()
            except BaseException:
                log.exception("async checkpoint save failed during teardown")
    if mesh is not None:
        state = gather_state(state, mesh, specs)
    return state


def _mesh_branch(tcfg, device):
    """(mesh or None, readers or None, rows a rank feeds a step) for
    ``tcfg.mesh_shape`` in the current world of ranks: the mesh where the
    world holds it; per-data-rank readers ``(d, dp)`` where there are
    several ranks and several data ranks (the model ranks of one data
    index read the same reader); None and one device, after the
    reference's warning, where the mesh asks for more ranks than the one
    there is. ValueError where several ranks would not fill the mesh."""
    mesh_size = tcfg.mesh_shape[0] * tcfg.mesh_shape[1]
    world = world_size()
    if mesh_size > world and world == 1:
        log.warning("mesh %s needs %d devices, have %d; running "
                    "single-device", tuple(tcfg.mesh_shape), mesh_size,
                    world)
        return None, None, tcfg.batch_size
    if mesh_size != world:
        raise ValueError(
            f"mesh_shape={tuple(tcfg.mesh_shape)} needs {mesh_size} ranks; "
            f"the world has {world}")
    if world == 1:
        return None, None, tcfg.batch_size
    mesh = make_mesh(tuple(tcfg.mesh_shape), device=device)
    dp = mesh.shape["data"]
    readers, feed = None, tcfg.batch_size
    if dp > 1:
        if tcfg.batch_size % dp:
            raise ValueError(
                f"batch_size {tcfg.batch_size} must divide by the data "
                f"mesh axis ({dp}) for per-process feeding")
        readers, feed = (mesh.coords["data"], dp), tcfg.batch_size // dp
        log.info("per-process feed: reader %d/%d, %d local rows per global "
                 "batch", readers[0], dp, feed)
    log.info("training on mesh %s", mesh.shape)
    return mesh, readers, feed


def _pin_sparse_update(mcfg, tcfg, path: str):
    """``tcfg`` with ``sparse_update`` pinned to the flavor of the
    optimizer state in the checkpoint at ``path``; ValueError where that is
    row-sparse and the config cannot run the lazy step."""
    ckpt_sparse = ckpt.has_sparse_opt_state(path)
    cfg_sparse = sparse.sparse_enabled(mcfg, tcfg)
    if ckpt_sparse == cfg_sparse:
        return tcfg
    if ckpt_sparse and not sparse.sparse_applicable(mcfg, tcfg):
        raise ValueError(
            f"checkpoint {path} holds row-sparse optimizer state but the "
            "current config cannot run the sparse step (see "
            "train/sparse.py sparse_applicable); resume with the original "
            "optimizer/model settings or start a fresh run dir")
    pinned = "on" if ckpt_sparse else "off"
    log.warning("resume: pinning sparse_update=%r to match the optimizer "
                "state in %s (config resolved to %r)", pinned, path,
                "on" if cfg_sparse else "off")
    return dataclasses.replace(tcfg, sparse_update=pinned)


def _group_batches(it, n: int, stack: Optional[bool] = None):
    """Group n (batch, cursor) pairs into (stacked batch [n, ...], cursor of
    the last member); incomplete tail groups are dropped. With ``stack``
    (default n > 1) batches get the leading micro-step axis even at n=1."""
    if stack is None:
        stack = n > 1
    if n <= 1 and not stack:
        yield from it
        return
    buf = []
    for batch, cur in it:
        buf.append((batch, cur))
        if len(buf) == n:
            yield ({k: np.stack([b[k] for b, _ in buf]) for k in buf[0][0]},
                   buf[-1][1])
            buf = []


def _batch_put(put: DevicePut, pack_fn: Optional[Callable] = None,
               rows_fn: Optional[Callable] = None):
    """Lift the device put over (batch, cursor) pairs, leaving the cursors
    on the host. ``rows_fn`` (a mesh rank's rows of the global batch) and
    ``pack_fn`` (data/wirepack.py) run on the feeder thread before the
    copy, so fewer bytes cross."""
    def lifted(item):
        batch, cur = item
        if rows_fn is not None:
            batch = rows_fn(batch)
        if pack_fn is not None:
            batch = pack_fn(batch)
        return put(batch), cur
    return lifted
