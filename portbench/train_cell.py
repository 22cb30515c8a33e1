"""A training cell: the port's training step, fed as its loop feeds it.

Set-up writes the cell's fixture from the seed, builds the step
(``train.step.make_train_step``: the dense step, or the row-sparse lazy
step where the recipe asks for it, with K1/K2 under "auto"), its state
(``init_state``, then the benchmark's own weights from the seed), and the
loop's feed: per epoch, the dataset's batches grouped by
``steps_per_call`` and copied to the device by a ``PrefetchFeeder`` on its
own thread. The first group's micro-steps go one call each, so that the
loss of each and the optimizer's state after the first can be read; the
second group goes as one call, as the window calls the step, and the
params are read after it, for the check. Two more calls and a loss read
warm up the rest. The window then calls the step on group after group,
reads the loss back every ``log_every_steps`` as the loop does, runs epoch
after epoch, and ends with a synchronize. The loop's snapshots are left
out.

Over the window, ``host.WindowProbe`` records what the host's threads did
(the run's ``record``, not a metric). A ``torch.profiler`` trace of
``PROFILED_CALLS`` calls follows the window where the run is traced or the
cell has an end-to-end metric read from the device's trace; a traced run
also records the harness's host spans.
Once the program's state is freed, the plain reference (``reference.py``)
follows the micro-steps of both groups from the same weights, batches and
candidates, and ``check.py`` compares the two.

``run`` is the runner of cells whose traffic is of kind ``train``
(``spec.runner``): it returns the run's outcome and the ``View`` that the
cell's metric readers read.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, fixture, reference, weights
from portbench.host import WindowProbe
from portbench.spec import Cell

PROFILED_CALLS = 25      # calls in the traced window
PROFILER_WARM_CALLS = 2  # calls under the profiler before it
NORM_ROWS = 1 << 17      # rows a blocked norm reads at a time


class Program:
    """The port's modules the cell drives, imported when the cell runs
    (and looked up there, so a test can plant a fault in them)."""

    def __init__(self):
        from sert_tpu_torch.data import feeder, instances, wirepack
        from sert_tpu_torch.models import lse
        from sert_tpu_torch.train import loop, step
        from sert_tpu_torch.utils import config
        self.feeder, self.instances, self.wirepack = feeder, instances, \
            wirepack
        self.lse, self.loop, self.step, self.config = lse, loop, step, config


@dataclasses.dataclass
class Setup:
    cell: Cell
    seed: int
    device: torch.device
    recipe: object
    dims: Dict[str, int]
    data_dir: str
    counts: np.ndarray
    horizon: int
    lazy: bool

    @property
    def mcfg(self):
        return self.recipe.model

    @property
    def tcfg(self):
        return self.recipe.train


def negatives_seed(seed: int) -> int:
    """The seed of the generator that draws the candidates."""
    words = np.random.SeedSequence([int(seed), 7]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _supported(recipe) -> bool:
    """Whether the reference implements what ``recipe`` trains (and so
    whether its adam is lazy)."""
    m, t = recipe.model, recipe.train
    if not (m.model == "lse" and m.objective == "sampled_softmax"
            and m.negative_distribution == "unigram" and t.optimizer == "adam"
            and t.lr_schedule == "cosine" and t.lr_warmup_steps == 0
            and t.grad_clip_norm == 0 and t.weight_decay == 0
            and tuple(t.mesh_shape) == (1, 1)):
        raise ValueError("the reference trains the LSE sampled softmax with "
                         "cosine-scheduled adam on one device, without clip"
                         "ping or weight decay; the recipe asks for more")
    return t.sparse_update == "on"


def prepare(prog: Program, cell: Cell, seed: int, device, tmp: str) -> Setup:
    """The recipe of the cell's configuration, and its fixture under
    ``tmp`` (written from ``seed``)."""
    conf = cell.config
    rd = json.loads(json.dumps(conf["recipe"]))
    rd["model"].update(vocab_size=conf["vocab_size"],
                       num_entities=conf["num_entities"])
    recipe = prog.config.config_from_dict(prog.config.RecipeConfig, rd)
    lazy = _supported(recipe)
    m, B = recipe.model, recipe.train.batch_size
    dims = {"vocab_size": m.vocab_size, "num_entities": m.num_entities,
            "word_dim": m.word_dim, "entity_dim": m.entity_dim}
    data_dir = os.path.join(tmp, "data")
    meta, counts = fixture.write_shards(
        data_dir, cell.traffic, vocab_size=m.vocab_size,
        num_entities=m.num_entities, num_instances=conf["num_instances"],
        window=recipe.data.window_size,
        per_shard=recipe.data.instances_per_shard, seed=seed)
    # The loop's decay horizon: the epochs' batches, tails dropped.
    horizon = recipe.train.num_epochs * sum(s["num"] // B
                                            for s in meta["shards"])
    recipe = dataclasses.replace(recipe, train=dataclasses.replace(
        recipe.train, seed=seed, lr_decay_steps=horizon))
    return Setup(cell, seed, torch.device(device), recipe, dims, data_dir,
                 counts, horizon, lazy)


class EpochFeed:
    """The loop's feed, epoch after epoch: each epoch's batches grouped by
    ``steps_per_call`` and put on the device by a ``PrefetchFeeder``.
    While ``recording``, ``host`` holds the host arrays of each group put
    on the device and not yet taken by :meth:`next`."""

    def __init__(self, prog: Program, s: Setup, pack_fn):
        self.prog, self.s = prog, s
        self.dataset = prog.instances.InstanceDataset(s.data_dir,
                                                      seed=s.tcfg.seed)
        B = s.tcfg.batch_size
        self.n_micro = min(max(s.tcfg.steps_per_call, 1),
                           self.dataset.num_batches_per_epoch(B))
        self.stack = s.tcfg.steps_per_call > 1
        self.put = prog.feeder.DevicePut(s.device)
        self.put_fn = prog.loop._batch_put(self.put, pack_fn)
        self.recording = True
        self.host: collections.deque = collections.deque()
        self.epoch = -1
        self._open()

    def _groups(self, epoch: int):
        batches = self.dataset.iter_batches(self.s.tcfg.batch_size,
                                            epoch=epoch)
        for item in self.prog.loop._group_batches(batches, self.n_micro,
                                                  stack=self.stack):
            if self.recording:
                self.host.append(item[0])
            yield item

    def _open(self) -> None:
        self.epoch += 1
        self.feeder = self.prog.feeder.PrefetchFeeder(
            self._groups(self.epoch), put_fn=self.put_fn)
        self.it = iter(self.feeder)

    def next(self):
        while True:
            try:
                staged, _ = next(self.it)
                return self.put.ready(staged)
            except StopIteration:
                self.feeder.close()
                self._open()

    def close(self) -> None:
        self.feeder.close()


def start(prog: Program, s: Setup):
    """(state, step, feed, memory): the program's step and state, with the
    benchmark's weights and candidate generator, the loop's feed, and the
    device bytes that the set-up held: ``init_peak`` the allocator's peak
    until ``init_state`` returned, ``state`` the params' and optimizer
    state's own."""
    m, t = s.mcfg, s.tcfg
    noise = prog.lse.noise_logits(s.counts, m, s.device)
    step = prog.step.make_train_step(m, t, noise=noise, device=s.device)
    pack_fn = None
    if prog.wirepack.feed_enabled(t.packed_feed, m.vocab_size,
                                  m.num_entities, s.recipe.data.window_size):
        base, V, E = step, m.vocab_size, m.num_entities

        def step(state, packed):
            return base(state, prog.wirepack.unpack_batch(packed, V, E))

        def pack_fn(batch):
            return prog.wirepack.pack_batch(batch, V, E)
    state = prog.step.init_state(s.seed, m, t, s.device)
    memory = {"init_peak": (torch.cuda.max_memory_allocated(s.device)
                            if s.device.type == "cuda" else 0),
              "state": sum(v.numel() * v.element_size() for v in
                           [*state.params.values(),
                            *state.opt_state.values()]
                           if torch.is_tensor(v))}
    weights.fill(state.params, s.seed, s.dims)
    state.generator.manual_seed(negatives_seed(s.seed))
    return state, step, EpochFeed(prog, s, pack_fn), memory


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _sq_sum(t: torch.Tensor) -> float:
    """The sum of squares of ``t``, NORM_ROWS rows at a time."""
    total = 0.0
    for lo in range(0, max(t.shape[0], 1), NORM_ROWS):
        total += float(t[lo:lo + NORM_ROWS].float().square().sum(
            dtype=torch.float64))
    return total


def _first_moment(opt_state: Dict, leaf: str) -> Optional[torch.Tensor]:
    """Adam's first moment of ``leaf``: optax's ``mu`` of the dense step,
    or the lazy step's row state ``m``."""
    for key, val in opt_state.items():
        if key.endswith((f"mu['{leaf}']", f"['{leaf}']['m']")):
            return val
    return None


@torch.no_grad()
def first_gradients(opt_state: Dict):
    """Each leaf's first gradient, as the optimizer got it, from adam's
    first moment after one step: mu = (1 - b1) g, with (1 - b1) as the
    moment's dtype holds it. Returns (norms, {leaf: (ids, values)}), the
    rows of an embedding table where it is not zero."""
    norms, grads = {}, {}
    for leaf in weights.LEAVES:
        mu = _first_moment(opt_state, leaf)
        if mu is None:
            norms[leaf] = math.nan
            grads[leaf] = (None, torch.full((1,), math.nan))
            continue
        c = float(torch.tensor(1.0 - reference.B1, dtype=mu.dtype))
        norms[leaf] = math.sqrt(_sq_sum(mu)) / c
        if leaf in weights.ROW_LEAVES:
            ids = torch.cat([
                torch.nonzero((mu[lo:lo + NORM_ROWS] != 0).any(dim=1))[:, 0]
                + lo for lo in range(0, mu.shape[0], NORM_ROWS)])
            grads[leaf] = (ids, mu[ids].float() / c)
        else:
            grads[leaf] = (None, mu.float() / c)
    return norms, grads


@torch.no_grad()
def change_readout(params: Dict[str, torch.Tensor], seed: int, dims):
    """(each leaf's norm of its change from the seed's weights, the rows
    of each embedding table that changed), block by block."""
    norms, changed = {}, {}
    for leaf in weights.LEAVES:
        p, sq, ids = params[leaf], 0.0, []
        for lo, hi in weights.blocks(dims, leaf):
            p0 = weights.make_block(seed, dims, leaf, lo, hi, p.dtype,
                                    p.device)
            for a in range(0, hi - lo, NORM_ROWS):
                d = (p[lo + a:lo + a + NORM_ROWS].float()
                     - p0[a:a + NORM_ROWS].float())
                sq += _sq_sum(d)
                if leaf in weights.ROW_LEAVES:
                    ids.append(torch.nonzero((d != 0).any(dim=1))[:, 0]
                               + lo + a)
            del p0
        norms[leaf] = math.sqrt(sq)
        if ids:
            changed[leaf] = torch.cat(ids)
    return norms, changed


def _micro_batches(group: Dict, stacked: bool):
    if not stacked:
        yield group
        return
    for i in range(next(iter(group.values())).shape[0]):
        yield {k: v[i:i + 1] for k, v in group.items()}


def _host_micro(host_group: Dict[str, np.ndarray], stacked: bool):
    if not stacked:
        return [host_group]
    n = next(iter(host_group.values())).shape[0]
    return [{k: v[i] for k, v in host_group.items()} for i in range(n)]


def first_steps(s: Setup, state, step, feed: EpochFeed):
    """Run the first group one micro-step a call, then the second group as
    one call, as the window calls the step. Returns (state, the program's
    ``reference.Steps`` of those micro-steps: each single call's loss, then
    the group call's (its last micro-step's); their host batches)."""
    losses: List[float] = []
    host: List[Dict[str, np.ndarray]] = []
    norms = grads = None
    group = feed.next()
    host.extend(_host_micro(feed.host.popleft(), feed.stack))
    for sub in _micro_batches(group, feed.stack):
        state, metrics = step(state, sub)
        losses.append(float(metrics["loss"]))
        if norms is None:
            norms, grads = first_gradients(state.opt_state)
    group = feed.next()
    host.extend(_host_micro(feed.host.popleft(), feed.stack))
    state, metrics = step(state, group)
    losses.append(float(metrics["loss"]))
    change, changed = change_readout(state.params, s.seed, s.dims)
    feed.recording = False
    feed.host.clear()
    return (state, reference.Steps(losses, norms, grads, change, changed),
            host)


def reference_steps(s: Setup, host: List[Dict[str, np.ndarray]],
                    compute: str = "fp32", half_batch: bool = False,
                    loss_scale: float = 1.0,
                    skip_group: bool = False) -> reference.Steps:
    """The reference over ``host``'s batches (``first_steps``' two groups)
    from the seed's weights, with the candidates drawn again by its own
    rule from the same seed; its losses are the first group's and the last
    micro-step's, as ``first_steps`` reads the program's.

    ``skip_group`` (a fault) runs the second group's first micro-step
    alone, as a call that skips the rest of its group would."""
    n = len(host) // 2          # micro-steps a call
    if skip_group:
        host = host[:n + 1]
    dev, m, t = s.device, s.mcfg, s.tcfg
    counts = torch.as_tensor(s.counts, dtype=torch.float32, device=dev)
    cdf, logq = reference.noise_table(counts, m.unigram_power)
    gen = torch.Generator(device=dev).manual_seed(negatives_seed(s.seed))
    negs = [reference.draw_negatives(gen, cdf, m.num_negatives)
            for _ in host]
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in host]
    ids = {"word_emb": torch.unique(torch.cat(
               [b["windows"].reshape(-1).long() for b in batches])),
           "entity_emb": torch.unique(torch.cat(
               [b["entities"].long() for b in batches] + negs))}
    sdt = torch.float32 if m.param_dtype == "float32" else torch.bfloat16
    start_ = {leaf: (ids.get(leaf), weights.rows(s.seed, s.dims, leaf,
                                                 ids.get(leaf), sdt, dev))
              for leaf in weights.LEAVES}
    lrs = [reference.cosine_lr(i, t.learning_rate, s.horizon,
                               t.lr_final_fraction) for i in range(len(host))]
    out = reference.run(start_, batches, negs, logq, lrs, lazy=s.lazy,
                        compute=compute, half_batch=half_batch,
                        loss_scale=loss_scale)
    out.losses = out.losses[:n] + out.losses[-1:]
    return out


def window(s: Setup, state, step, feed: EpochFeed, seconds: float,
           profiler=None, probe=None) -> Dict[str, float]:
    """Call the step group after group for ``seconds``, then synchronize;
    ``cpu_s`` is the process's CPU seconds over it, every thread counted.
    Under ``profiler`` (the traced window), each call's feed, step and
    loss read are spans of their own, and the window is ``calls`` calls
    long instead. ``probe`` (a ``host.WindowProbe``) looks at the host's
    threads now and then."""
    from torch.profiler import record_function
    nothing = contextlib.nullcontext()
    log_every = s.tcfg.log_every_steps
    per_call = feed.n_micro if feed.stack else 1
    micro = calls = failed = last_log = 0
    feed_s = step_s = 0.0
    marks: List[float] = []
    _sync(s.device)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    while True:
        with record_function("portbench.feed") if profiler else nothing:
            a = time.perf_counter()
            batch = feed.next()
            b = time.perf_counter()
        with record_function("portbench.step") if profiler else nothing:
            state, metrics = step(state, batch)
            c = time.perf_counter()
        feed_s += b - a
        step_s += c - b
        calls += 1
        micro += per_call
        if log_every and state.step % log_every < per_call:
            with record_function("portbench.log") if profiler else nothing:
                loss = float(metrics["loss"])      # the loop's sync
            if not math.isfinite(loss):
                failed += micro - last_log
            last_log = micro
            marks.append(time.perf_counter() - t0)
        if probe is not None:
            probe.tick(c - t0)
        if (calls >= PROFILED_CALLS if profiler else c - t0 >= seconds):
            break
    _sync(s.device)
    return {"window_s": time.perf_counter() - t0,
            "cpu_s": time.process_time() - cpu0, "micro_steps": micro,
            "calls": calls, "feed_wait_s": feed_s, "step_enqueue_s": step_s,
            "failed": failed, "log_reads_s": marks}


def traced_window(s: Setup, state, step, feed: EpochFeed):
    """The profiler's trace of PROFILED_CALLS calls, read by
    ``trace.read``; None where it holds no device operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace
    acts = [ProfilerActivity.CPU]
    if s.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(PROFILER_WARM_CALLS):
            state, _ = step(state, feed.next())
        _sync(s.device)
        with record_function(trace.WINDOW):
            spans = window(s, state, step, feed, 0.0, profiler=prof)
    return trace.read(prof, spans["micro_steps"])


def _phases(t_start: float, marks: Dict[str, float]) -> Dict[str, float]:
    """Seconds of each part of the set-up, from the marks at their ends:
    ``imports`` (the process and the harness), ``fixture`` (the program's
    modules and the traffic), ``state``, ``checked_steps``, ``warm_up``."""
    out, last = {}, t_start
    for name, t in marks.items():
        out[name], last = t - last, t
    return out


def device_traced(cell: Cell, trace: bool, device: torch.device) -> bool:
    """Whether a run takes the profiler's trace: traced, or on the card
    where the cell has an end-to-end metric read from the device's
    trace."""
    return trace or (device.type == "cuda" and any(
        m["source"] == "device_trace" for m in cell.end_to_end))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        tmp: str, t_start: float) -> Dict:
    """One run of the cell; returns its outcome (``correct``,
    ``attempted``, ``failed``, ``checks``, ``memory_peak_bytes``, with a
    device trace ``busy_s``, ``window_s`` and ``breakdown``, and the
    ``view`` that the metric readers read)."""
    marks = {"imports": time.perf_counter()}
    prog = Program()
    s = prepare(prog, cell, seed, device, tmp)
    marks["fixture"] = time.perf_counter()
    if s.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(s.device)
    state, step, feed, memory = start(prog, s)
    marks["state"] = time.perf_counter()
    try:
        state, prog_steps, host = first_steps(s, state, step, feed)
        marks["checked_steps"] = time.perf_counter()
        for _ in range(2):
            state, metrics = step(state, feed.next())
        float(metrics["loss"])
        _sync(s.device)
        marks["warm_up"] = time.perf_counter()
        setup_s = marks["warm_up"] - t_start
        probe = WindowProbe(seconds, cell.chips)
        probe.start()
        spans = window(s, state, step, feed, seconds, probe=probe)
        on_host = probe.stop(spans["micro_steps"])
        on_host["host_cpu_ms"] = 1e3 * spans["cpu_s"] / spans["micro_steps"]
        memory["peak"] = (torch.cuda.max_memory_allocated(s.device)
                          if s.device.type == "cuda" else 0)
        dev_trace = (traced_window(s, state, step, feed)
                     if device_traced(cell, trace, s.device) else None)
    finally:
        feed.close()
    # The program's state goes before the reference runs.
    del state, step, metrics, feed
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(s, host)
    ok, checks = check.verdict(check.readings(prog_steps, ref), cell.limits)
    out = {"correct": ok, "attempted": spans["micro_steps"],
           "failed": spans["failed"], "checks": checks,
           "memory_peak_bytes": memory["peak"],
           "view": View(s, spans, dev_trace, memory, setup_s),
           "record": {"spans": spans, "host": on_host,
                      "setup_phases_s": _phases(t_start, marks),
                      "losses": {"program": prog_steps.losses,
                                 "reference": ref.losses}}}
    if dev_trace is not None:
        out["busy_s"], out["window_s"] = dev_trace.busy_s, dev_trace.window_s
        out["breakdown"] = {"device_ops": dev_trace.device_ops,
                            "idle_gaps": dev_trace.idle_gaps}
    return out


@dataclasses.dataclass
class View:
    """What a metric reader reads: the cell's sizes, the host spans of the
    measured window, the device trace that follows it (None without one),
    the device bytes (``start``'s ``memory``, and ``peak`` over set-up and
    window) and the set-up's seconds."""
    setup: Setup
    spans: Dict[str, float]
    device: Optional[object]
    memory: Dict[str, int]
    setup_s: float

    @property
    def dims(self) -> Dict:
        m, t = self.setup.mcfg, self.setup.tcfg
        return {"batch_size": t.batch_size, "num_negatives": m.num_negatives,
                "word_dim": m.word_dim, "entity_dim": m.entity_dim,
                "compute_dtype": m.compute_dtype}
