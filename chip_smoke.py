"""End-to-end smoke run of the PyTorch / H100 port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero):
  1. device: the card, its power limit; TF32 off for the fp32 references;
  2. build: nvcc compiles sert_tpu_torch/csrc into build/;
  3. kernels: K3 (score + bin-max, with and without bias) and K4
     (gather-rescore, fp32 and bf16 rows) against their plain PyTorch
     versions at the serving shapes (Q=64, E=1M, d=128, bw=128, NB=1012),
     with CUDA-event times for both; K3 also at bw=64 and at a partial
     tail (E=1M-1), with and without the bias; K3's fp32 mode (M staged
     in fp32, 3xTF32) the same way, and both modes' bin maxima against
     fp64 (the error relative to the largest score); K4 also on shared
     bins (every query the same 1012, each row in its own order), with a
     bin twice in a row, with out-of-range ids (NaN scores), and two calls
     bit for bit;
  4. train_kernels: K1 (the masked-LSE forward) and K2 (its backward)
     against sampled_lse_plain + autograd on the same inputs, at the
     flagship's B=4096, k=32768, d=128 in bf16 and fp32, at a ragged
     k=32767 and a small k=1024, at the amazon_* recipes' k=256 shapes
     (B=4096, d=256, bf16; B=1024, d=128, fp32), at k=100 (the dC sweep's
     most batch slices), with accidental hits, and a case with an
     all-masked row; each case's sweep plan (chunks, slices, blocks), two
     K2 calls bit for bit at the flagship and at k=100, errors of lse,
     dreps, dC and dcorr with their tolerances, CUDA-event times of kernel
     and plain;
  5. serve: a random-weight synthetic_1m_retrieval checkpoint at full width
     (V=250k, E=1M) behind the port's EntitySearcher: one search, then
     200 queries; recall against an fp32 dense oracle and score agreement.
     The oracle builds the query reps and the normalized entity matrix with
     the same port functions the searcher uses, so it checks the K3 + K4
     engine and the top-k, not the query encoding (the CPU tests hold that
     against the JAX reference);
  6. cli: `python -m sert_tpu_torch query` and `evaluate` on the same data;
  7. train: synthetic_1m_retrieval at full width (V=250k, E=1M, d=128,
     B=4096, k=32768, bf16, adam + cosine, steps_per_call=4, bf16
     params-only epoch snapshots, a full final one) for 2 epochs of a
     262,144-window training fixture, through the function the `train`
     command runs (pipeline.train_from_dir, in this process so that the
     launch counts and the state can be read) on a recipe JSON loaded as
     the command loads it; the loss must be finite and fall, K1/K2 must
     carry every step, and the final full checkpoint must load back equal
     to the state in memory. Then `python -m sert_tpu_torch train` on the
     finished run resumes from that checkpoint and writes nothing;
  8. serve_trained: the serve checks again, on the run phase 7 wrote;
  8a. serve_engines: that run behind a searcher of each other engine and
     staging option, every topic against the fp32 dense oracle, each
     batch's latency (median of 3) beside the natural kernel engine's:
     streaming (chunks of 32,768) and approx (recall 1.0 up to exact
     ties), the clustered layout (ids the natural layout's but for ties)
     and with it the adaptive rescore of 128 bins (K4's launches a call
     give the share that fell back); the k-means at 1M (7,812 clusters)
     timed alone and the same permutation as both stagings';
     exact_topk_prepared with the fp32 prefilter (K3's fp32 mode) and
     with bins of 64 (recall >= 0.99, score error <= 1e-5); then the first
     50,000 trained rows at depth 100: mean winner-bins under each layout
     and the share of single-query calls whose rescore of 64 bins fell
     back;
  8b. cli_scoring: `sweep` over the run's epoch snapshots (in this
     process, its K3/K4 launches counted), `dump --format npz` at full
     width (its arrays the served params), `neighbors --entity` and
     `--term` (the first neighbour the host numpy argmax), `train
     --init-word-emb` from that dump on a 4-step fixture of the same
     vocabulary (step 0's rows the dump's, through the command's function
     with no epoch; the command's loss finite, every row seeded);
  8c. serve_foldin: on that searcher, add_entities of 64 entities by the
     affine method (each one topic's own four-term text, under the window
     of 8, so its f-image is that topic's query rep) and of 8 by the
     gradient method (sampled softmax: the f-image at the trained median
     norm): each call's latency, the K3/K4 launches of the affine probe,
     peak memory; each vector against the port on the CPU from the same
     params (1e-5); every topic through search_many against a dense fp32
     oracle over the trained rows and the 72 extras (their scores from the
     stored vectors and spans), recall >= 0.99 and score error <= 1e-5;
     each affine entity in its own topic's top 10 within 1e-5 of that
     topic's trained top score; a batch's latency with 0 and 72 extras;
     then the NCE refit (fold_in_entity_gradient, 1000 adam steps) at full
     width on the card against the CPU (cosine >= 1 - 1e-5, norms within
     1e-4);
  8d. serve_http: make_http_server on that searcher, on loopback: 16
     concurrent POST /search clients (they must coalesce, max_batch > 1;
     each answer search_many's, scores within 1e-6), one query's latency
     and the clients' queries/s, a batched POST and a GET, /healthz (the
     72 extras), POST /entities and a duplicate name (400);
  9. xent_kernels: K5 (the full-softmax forward) and K6 (its backward)
     against xent_loss_plain + autograd on the same inputs, fp32 compute
     on csrc/xent.cu's mma.sync sweep and bf16 on csrc/xent_wgmma.cu's
     wgmma sweep: "de" fp32 at cerc's B=1024, d=256, E=3500 and at w3c's
     d=128, E=1100 with a ragged B=1000; "ed" bf16 at B=4096, d=128,
     E=131072, at E=131071 (a tail tile) and at d=256; "de" bf16 at cerc's
     shape and at the log-linear A/B's E=500k, d=256, B=1024; fp32 "de" at
     B=4096, E=300, d=256 (K6's dW sweep at its most batch slices); each
     case's plan (chunks, slices, blocks), and two K6 backward calls bit
     for bit at cerc's shape, the split one and lse_full's 128k; K6 fed an
     outside lse on a ragged B=1000 with a third of the labels -1 at
     E=131071, both layouts, bf16; K5 alone at the log-linear
     normalizer's shape (64 queries x 16 terms, "de", fp32, d=256); and
     K5/K6 at lse_full's flagship shape (B=4096, E=1M, d=128, bf16, "ed"),
     the forward held against an lse the plain version computes in
     entity chunks and K6 fed that lse against the plain version chunk by
     chunk; errors of loss, lse, dpooled, dW and db with their tolerances,
     CUDA-event times of kernel and plain, each bound with its
     exponentials, and beside the bf16 cases cuBLAS's one product of the
     same operands (product_ms);
 10. xent_apply_kernels: K7 (the full-softmax backward with adam, adagrad
     or sgd applied to W and its slots in place) against
     xent_loss_apply_plain on the same inputs, from seeded non-zero
     moments, for each optimizer: "de" fp32 at w3c's B=1024 and a ragged
     B=1000 (E=1100, d=128) and at cerc's (B=1024, E=3500, d=256); "de"
     bf16 at cerc's shape and at the reference's fused-step width (B=1024,
     E=500k, d=256); "ed" bf16 at B=4096, E=131072 and 131071; bf16
     storage once; each case's dW-sweep slices (the update in the sweep
     with one, in the ordered sum of the slices with more; bf16 on the
     wgmma sweep's plan); errors of the loss, gsq, db, dpooled, W' and the
     slots with their tolerances, two K7 calls bit for bit at w3c's, cerc's
     and cerc_bf16's shapes (slices) and at E=500k and 131071 (one slice),
     each bf16 case's sgd update against W - lr (K6's dW) bit for bit,
     CUDA-event times of K7 alone and of the plain backward + update;
 11. train_loglinear: cerc_expert_finding as the recipe stands (V from the
     CERC stand-in, E=3500, d=256, B=1024, fp32, adam + cosine, 5 epochs)
     end to end through pipeline.run_end_to_end (the port's own prepare,
     training through K5/K6, scoring through K3 with the bias + K4 + the
     K5 normalizer, evaluation); the loss must be finite and fall, K5/K6
     must carry every micro-step, the served top 100 must match the exact
     dense log-probs (the ids, and the scores within 1e-4 of the larger of
     the score and its un-normalized sum), and the first 8 steps must
     match the plain version on the card (fused_softmax="off") on the same
     batches; then serve_http on that run: one GET and one batched POST
     through K3 with the bias, K4 and the K5 normalizer, each answer
     search_many's;
 11a. report: on that run, `query` (the model ranker, and --ranker lm),
     `fuse --method interp --weights 0.5 0.5 -k 100` of the two run files
     and `report --json` through the CLI in this process: the report's
     model ranker through K3 with the bias, K4 and the K5 normalizer (its
     launches counted), its model and lm runs byte-equal to `query`'s run
     files, the fused file's metrics the report's interp row; the markdown
     table and the report's wall time;
 12. train_fused: w3c_expert_finding as the recipe stands (W3C stand-in,
     E=1100, d=128, B=1024, fp32, adam at a constant 1e-3,
     steps_per_call=16, 5 epochs) with fused_update="on", end to end as
     phase 11: K5 + K7 every micro-step and K6 never, the loss finite and
     falling, the served top 100 against the dense oracle; its first 8
     steps against the dense step (K5/K6 + the dense adam) on the same
     batches, and two fused runs of 8 steps bit for bit;
 12a. train_adafactor: w3c_expert_finding as phase 12 with
     optimizer="adafactor" at lr 1e-2 (fused_update "auto" resolves to the
     dense step): K5/K6 every micro-step and K7 never, the loss finite and
     falling, the served top 100 against the dense oracle, NDCG@100 beside
     phase 12's adam run; its first 8 steps through K5/K6 against the
     plain version (within 1e-3 relative);
 13. train_lse_full: the flagship's width with model="lse_full" (V=250k,
     E=1M, d=128, B=4096, bf16, adam) for 16 steps of the training
     fixture, through K5/K6 every step, every launch on the bf16 route
     (the wgmma sweep);
 14. fused_ab (run last): the reference's fused-step A/B at its width
     (log-linear, E=500k, V=60k, d=256, B=1024, bf16 compute, fp32 params,
     steps_per_call=8) for adam, adagrad and sgd, fused_update off and on
     in turns: ms per micro-step, peak memory, and the two modes' losses
     within 1e-4 of each other; then adafactor_ab: adafactor with
     fused_update off, twice, K5/K6 every micro-step and K7 never, ms per
     micro-step and peak memory beside them;
 15. train_10m: synthetic_10m_training at its widths (V=250k, E=10M,
     d=128, B=4096, k=32768 unigram negatives, bf16 compute and params,
     the row-sparse lazy adam step, cosine, steps_per_call=4, bf16
     params-only snapshots), cut to one epoch of a 2^20-window training
     fixture (256 micro-steps) in place of 500.5M instances, through
     pipeline.train_from_dir: the loss finite and falling, K1 and K2 once
     each a micro-step, mid-run steps/s and peak memory; then the first
     micro-step through K1/K2 against the plain version from the same
     state and negatives (loss within 1e-4, gradient norm within the bf16
     class), two lazy runs of 8 micro-steps bit for bit, and the rows no
     micro-step touched (drawn again from a copy of the generator) at
     their initial bits;
 16. serve_10m: that run's final snapshot served through K3 + K4 at
     E = 10M (64 topics, depth 1000) against the fp32 dense oracle
     (recall >= 0.99, score error <= 1e-5), with the latencies of one query
     and of a batch; then, on the searcher's staged rows (bf16 prefilter
     2.56 GB, fp32 rescore rows 5.12 GB), K3's bin maxima for one batch of
     64 topics against score_binmax_plain and K4's every rescored score for
     that batch's bins against gather_rescore_plain, within 1e-5;
 17. sparse_ab_10m: the same recipe's micro-step with the lazy step and
     with the dense one (dense adam over the bf16 params), in turns, a
     warm call then 16 timed micro-steps each: ms a micro-step and peak
     memory (reported; only the losses must be finite);
 18. sparse_resume: synthetic_1m_retrieval on phase 7's fixture with the
     lazy adam step, a full checkpoint every 32 micro-steps; after a crash
     right after the first, a fresh loop resumes and must end bit for bit
     where the unbroken run ended (params, moments, generator);
 18a. packed_feed: the flagship at full width on phase 7's fixture, its
     first 32 micro-steps trained twice through the loop from the same
     fresh state, packed_feed "on" and "off": losses and final params bit
     for bit, K1/K2 once a micro-step in each, 22 feed bytes an instance
     against 40, mid-run steps/s of both;
 18b. debug: utils.debug.checked over the log-linear loss and gradients
     through K5/K6 at cerc's widths (NaN params name an op, clean ones
     none), and utils.profiling.trace around one annotated flagship
     micro-step (the chrome trace names K1/K2's kernel and the region);
 19. nce_tiny: tiny_recipe("lse") as it stands (the NCE objective) end to
     end on the card with the dense step and with the lazy one: the loss
     falls, NDCG@100 printed; on the dense run a gradient fold-in (the NCE
     refit and the moment match on the card: raw, at the trained median
     norm) and `python -m sert_tpu_torch query --ranker lm`, its NDCG@100
     beside the model's;
 20. mesh_kernels: the per-shard kernels at the mesh recipes' shard
     shapes against their plain versions (not counted as launches): K3/K4
     on each of synthetic_10m_scoring's 8 row blocks of a seeded 10M
     matrix (1.25M rows, d=128, Q=64, depth 1000), the blocks' winners
     (ids offset by each block's) merged by the port's all-gather merge
     and by its ring merge's hop sequence in one process, each held
     against the fp32 dense oracle (recall >= 0.99, score error <= 1e-5),
     the merges equal up to the order of exact ties, and never less exact
     than the one-card kernel engine on the whole matrix (its bf16
     prefilter keeps k + pad bins of 10M rows, a block's of 1.25M); K1/K2
     at amazon_home_kitchen's (8, 1) shard (B=512, k=256, d=256, bf16) and
     at the flagship's (2, 4) block (B=2048, k=8192, bf16); K5 on each of
     cerc_expert_finding's four model shards (E=3500/4, d=256, fp32 "de"),
     their lse stitched (a max and a rescaled sum) against the plain lse
     over every entity, then K6 on one shard fed that global lse and
     labels of -1 off the shard against xent_bwd_plain;
 20a. mesh_fused_tp: the pure-TP fused step (K5 and K7 per entity block)
     at phase 14's width (E 500k, V 60k, d 256, B 1024, bf16 compute, fp32
     params, lr 1e-2) on a world of 4 gloo ranks sharing the card, mesh
     (1, 4), blocks of 125,000 entities, for adam, adagrad and sgd: each
     of 8 micro-steps against the dense sharded step (K5/K6 per block)
     taken from the same state, the first against the one-card fused step,
     the free-running losses and grad norms against one card's, all within
     1e-4 (params and slots: the norm of the difference of each leaf's
     change over the norm of the other's change, which a skipped update
     reads as ~1, each element's difference counted beyond one storage
     step; against one card within 2e-3, set from the readings, and the
     same run in fp32 compute for 2 micro-steps, within 5e-4);
     every rank K5 and K7 once a micro-step, K6 never; replicated leaves
     bit-equal on every rank; each rank's ms a micro-step, the gloo
     collectives' share and peak memory; K7 alone on one block against
     its plain version for each optimizer (W' held to its change where
     that is smaller than lr), its time and bound with adam;
 21. mesh_nccl: a world of one rank over NCCL, the (1, 1) mesh: the
     sharded flagship step (parallel.make_sharded_train_step) against the
     one-card step for 8 micro-steps from the same seed (losses and params
     compared bit for bit, the difference printed); fused_update="on" at
     (1, 1) (the one-card fused step, K5 + K7) against
     make_fused_train_step at phase 14's width with adam for 8
     micro-steps, params, slots and losses bit for bit; `python -m
     sert_tpu_torch query` with engine="distributed" (merge allgather) at
     synthetic_10m_scoring's score settings on phase 15's 10M run, and
     in process with both merges, against the kernel engine (ids equal,
     scores within 1e-5, the run file byte-equal); amazon_home_kitchen as
     its recipe stands (mesh (8, 1)) on a seeded fixture at its widths,
     falling back to one card with the reference's warning, K1/K2 every
     micro-step.
Then one JSON line of kernel records (with each one's bound: the larger of
its operations over the H100's peak rate for their type, K1/K2's also
their exponentials over the special-function units' rate, and its bytes
over 3.35 TB/s; fp32 products of K5-K7 run as 3xTF32 on the tensor cores,
and their CUDA-core bound is kept beside), and the device record as the
last line.

Imports nothing of JAX and nothing of the JAX package by name; only
`sert_tpu_torch`. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
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
B_TRAIN, K_NEG = 4096, 32768           # the flagship's batch and negatives
# K1/K2 against their plain version: max |kernel - plain| <= tol * max
# |plain| per output. Both round the same operands; fp32 sums differ in
# order only, while in bf16 p is rounded after fp32 sums that differ in
# order, so an element can land one bf16 step (2^-8) apart.
SLSE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_INSTANCES = 1 << 18              # 64 steps an epoch at B=4096
TRAIN_EPOCHS = 2
TRAIN_LOG_EVERY = 16
# K5/K6 against their plain version: the elementwise gradients dpooled, dW
# and db as K1/K2 above. The loss and the lse are fp32 reductions of the
# same rounded operands in either dtype, so they are held to 1e-4 relative
# in both (measured on the H100: loss error 0, lse error 2.9e-6 on an lse
# of about 14 at E = 1M), which a kernel that dropped entity tiles fails.
XENT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
XENT_SUM_RTOL = 1e-4
# K6's bf16 gradients where they hold exp(z - lse) terms alone (dW's and
# db's entities that no label names, dpooled's rows labelled -1), relative
# to the plain version's largest value there. XENT_TOL's scale is the
# one-hot term, about 1e4 times that part at E = 1M, so a K6 that dropped or
# mis-scaled exp(z - lse) would pass it. This limit is about 5x the largest
# reading on the H100 (8.1e-4, dW at E 500k "de" d 256), and fails K6 fed
# lse + 0.01, each of those terms 1 % small (phase_xent_kernels checks that
# it does).
XENT_SOFTMAX_TOL = 4e-3
# The first steps of the fused and the plain log-linear runs: both are fp32
# products of the same operands, summed in another order, carried through
# that many adam steps.
PARITY_STEPS, PARITY_RTOL = 8, 1e-3
LL_RECALL_MIN, LL_SCORE_RTOL = 0.99, 1e-5   # score: see phase_train_loglinear
LSE_FULL_STEPS = 16
# K7 against its plain version: as K5/K6 above, and the updated W within
# XENT_TOL of the learning rate (an update is lr-sized), from seeded
# non-zero moments with count 3.
APPLY_LR = 1e-2
# The fused step against the dense one on the same batches: both take the
# fp32 class of product (K6's and K7's sweeps, 3xTF32 on the tensor cores),
# so the gradients differ in rounding and summation order only, and the
# optimizer's arithmetic is in another order (an ulp of an lr-sized update
# per step).
FUSED_PARITY_RTOL = 1e-4
# The fused-step A/B at the width of the reference's
# benchmarks/fused_step_bench.py (log-linear, bf16 compute, fp32 params,
# lr 1e-2): timed calls of AB_STEPS_PER_CALL micro-steps after a warm one.
AB_V, AB_E, AB_D, AB_LR = 60_000, 500_000, 256, 1e-2
AB_STEPS_PER_CALL, AB_CALLS = 8, 3
# train_adafactor: w3c_expert_finding with adafactor at the reference's
# quality setting (benchmarks/NOTES.md:280-282).
ADAFACTOR_LR = 1e-2
# packed_feed: the flagship's first micro-steps on phase 7's fixture, a
# log every PACKED_LOG_EVERY of them (so mid-run rates exist).
PACKED_STEPS, PACKED_LOG_EVERY = 32, 8
# debug: checked over the log-linear loss at cerc's widths (E 3500, d 256)
# over a vocabulary of this size.
DEBUG_V, DEBUG_E = 20_000, 3500
# The H100 SXM's published dense peaks (bf16 on tensor cores, fp32 on the
# CUDA cores, and fp32 products as three TF32 passes on the tensor cores,
# as K5-K7 run them) and its memory rate, for each kernel's bound.
# synthetic_10m_training at its widths (SYNTH_10M's vocabulary and
# entities) on one epoch of a seeded training fixture of 2^20 windows (256
# micro-steps) in place of its 500.5M instances; served to 64 topics.
RECIPE_10M = "synthetic_10m_training"
V_10M, E_10M = 250_000, 10_000_000
TRAIN_10M_INSTANCES = 1 << 20
TRAIN_10M_LOG_EVERY = 16
N_QUERIES_10M = 64
LAZY_REPEAT_STEPS = 8     # two lazy runs of this many micro-steps, bit for bit
AB_10M_STEPS = 16         # timed micro-steps of each mode in sparse_ab_10m
RESUME_CKPT_EVERY = 32    # sparse_resume: the mid-epoch full checkpoint
# serve_fold_in: 64 entities folded by the affine method (each one topic's
# own text) and 8 by the gradient method into the trained 1M-entity
# searcher; each vector within FOLD_VEC_TOL of the port's on the CPU from
# the same params. The NCE refit's 1000 adam steps at full width are held
# to the CPU with tests/test_torch_foldin.py's tolerance (cosine, norm).
FOLD_AFFINE, FOLD_GRADIENT = 64, 8
FOLD_VEC_TOL = 1e-5
FOLD_COS_MIN, FOLD_NORM_RTOL = 1 - 1e-5, 1e-4
# serve_http: concurrent POST /search clients; each answer against
# search_many's (the merge's window reps are computed at another batch
# shape, which moves an extra's score by fp32 rounding only).
HTTP_CLIENTS = 16
HTTP_SCORE_TOL = LL_HTTP_SCORE_TOL = 1e-6
# serve_engines: the streaming engine's chunk, the adaptive rescore's
# phase-1 bins at depth 1000, and the layout's own regime (the first 50,000
# trained rows at depth 100, phase 1 of 64 bins). Streaming and approx are
# exact: a returned id outside the oracle's top k must tie its k-th score
# within ENGINE_TIE (the same fp32 products, taken in other chunks).
ENGINE_CHUNK, ADAPTIVE_BINS = 32_768, 128
LAYOUT_E, LAYOUT_K, LAYOUT_NA = 50_000, 100, 64
ENGINE_TIE = 1e-6
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# Exponentials a second: 16 special-function-unit results a clock on each
# of the 132 SMs (Hopper architecture white paper: four SFUs in each of an
# SM's four partitions) at the 1.98 GHz boost clock.
EXP_PER_S = 16 * 132 * 1.98e9


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


def bound(flops: float, moved: float, dtype: str, exps: float = 0) -> dict:
    """The least time the card could take for the work: the larger of the
    operations over the peak rate of their type (and ``exps``
    exponentials over the special-function units' rate) and the bytes
    moved over the memory rate; and which of the two it is."""
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / EXP_PER_S) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return dict(bound_ms=t_ops, bound_by="operations")
    return dict(bound_ms=t_bytes, bound_by="bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = card()
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
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=None))
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
    # K3's record is its no-bias variant: it reads the bf16 copy once.
    records["score_binmax"].update(bound(
        2 * Q * E * Mp.shape[1], nbytes(Mp, R, bins), "bfloat16"))

    def check(name, variant, got, want):
        """An untimed case: within TOL of the plain version."""
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        say("kernels", name=name, variant=variant, max_abs_err=err,
            rtol=TOL["rtol"], atol=TOL["atol"])
        rec = records[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    # K3 at bw = 64 (two bins a tile) and at a partial tail tile.
    for e, bw in ((E, 64), (E - 1, BW)):
        for ba in ((), (bias, alpha)):
            check("score_binmax",
                  f"E={e},bw={bw},{'bias' if ba else 'nobias'}",
                  k3.score_binmax_prepared(R, Mp, e, *ba, bin_width=bw),
                  k3.score_binmax_plain(R, Mp, e, *ba, bin_width=bw))
    # K3's fp32 mode: M staged in fp32, 3xTF32 products, against the plain
    # version (fp32 products, TF32 off) and against fp64.
    Mp32 = k3.prepare_binmax_matrix(M, torch.float32)
    n16, n32 = k3.launches, k3.f32_launches
    bins32 = compare(
        "score_binmax_f32", "nobias",
        lambda: k3.score_binmax_prepared(R, Mp32, E, bin_width=BW),
        lambda: k3.score_binmax_plain(R, Mp32, E, bin_width=BW),
        src3, "sert_tpu/ops/score_binmax.py:57")
    compare(
        "score_binmax_f32", "bias",
        lambda: k3.score_binmax_prepared(R, Mp32, E, bias, alpha, BW),
        lambda: k3.score_binmax_plain(R, Mp32, E, bias, alpha, BW),
        src3, "sert_tpu/ops/score_binmax.py:51")
    if k3.launches != n16 or k3.f32_launches == n32:
        raise AssertionError("an fp32 Mp did not launch K3's fp32 mode")
    # It reads the fp32 copy once; 3xTF32 runs three products.
    records["score_binmax_f32"].update(bound(
        2 * Q * E * Mp32.shape[1], nbytes(Mp32, R, bins32), "tf32x3"))
    for e, bw in ((E, 64), (E - 1, BW)):
        for ba in ((), (bias, alpha)):
            check("score_binmax_f32",
                  f"E={e},bw={bw},{'bias' if ba else 'nobias'}",
                  k3.score_binmax_prepared(R, Mp32, e, *ba, bin_width=bw),
                  k3.score_binmax_plain(R, Mp32, e, *ba, bin_width=bw))
    for ba in ((), (bias, alpha)):
        for mode, mp in (("float32", Mp32), ("bfloat16", Mp)):
            _binmax_vs_fp64("kernels", f"d={D},{mode}", R, M, mp, *ba)
    del Mp32
    torch.cuda.empty_cache()
    # The fp32 mode at its widest d, where the sums are longest and the
    # scores of unit rows smallest.
    g672 = torch.Generator(device=dev).manual_seed(SEED + 2)
    R672 = torch.randn(Q, k3.MAX_DIM_F32, generator=g672, device=dev)
    M672 = torch.randn(E, k3.MAX_DIM_F32, generator=g672, device=dev)
    R672 = R672 / R672.norm(dim=1, keepdim=True)
    M672 = M672 / M672.norm(dim=1, keepdim=True)
    Mp672 = k3.prepare_binmax_matrix(M672, torch.float32)
    for ba in ((), (bias, alpha)):
        _binmax_vs_fp64("kernels", f"d={k3.MAX_DIM_F32},float32", R672, M672,
                        Mp672, *ba)
    del M672, Mp672
    torch.cuda.empty_cache()
    # K3 at wide rows, where every block walks its ring many times over with
    # more sub-tiles a tile (8 and 5) than a warpgroup's share of the ring.
    gw = torch.Generator(device=dev).manual_seed(SEED + 1)
    for q, d in ((Q, 512), (130, 320)):
        Rw = torch.randn(q, d, generator=gw, device=dev)
        Mw = torch.randn(E, d, generator=gw, device=dev)
        Mw = k3.prepare_binmax_matrix(Mw / Mw.norm(dim=1, keepdim=True))
        Rw = Rw / Rw.norm(dim=1, keepdim=True)
        aw = torch.randint(1, 9, (q,), generator=gw, device=dev).float()
        for ba in ((), (bias, aw)):
            check("score_binmax",
                  f"Q={q},d={d},{'bias' if ba else 'nobias'}",
                  k3.score_binmax_prepared(Rw, Mw, E, *ba, bin_width=BW),
                  k3.score_binmax_plain(Rw, Mw, E, *ba, bin_width=BW))
        del Mw
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
    # K4's record is its fp32-row variant. The least it must read is each
    # bin this run's queries chose, once.
    rows = torch.unique(bin_idx).numel() * BW * D * 4
    n_out = Q * bin_idx.shape[1] * BW
    records["gather_rescore"].update(bound(
        2 * n_out * D, rows + nbytes(R, bin_idx) + 4 * n_out, "float32"))

    # K4 on shared bins (every query holds query 0's bins, each row in its
    # own order), with a bin twice in a row, and two calls bit for bit.
    shared = torch.stack([bin_idx[0][torch.randperm(
        bin_idx.shape[1], generator=g, device=dev)] for _ in range(Q)])
    dup = bin_idx.clone()
    dup[:, 1] = dup[:, 0]
    dup[::2, -1] = dup[::2, 2]
    for variant, idx in (("shared_bins", shared), ("duplicates", dup)):
        check("gather_rescore", variant, k4.gather_rescore(R, M_binned, idx),
              k4.gather_rescore_plain(R, M_binned, idx))
    same = torch.equal(k4.gather_rescore(R, M_binned, bin_idx),
                       k4.gather_rescore(R, M_binned, bin_idx))
    say("kernels", name="gather_rescore", two_calls_bit_equal=same)
    if not same:
        raise AssertionError("two K4 calls differ")
    # An id outside [0, n_bins) yields NaN for its bw scores, the rest as
    # plain on the in-range ids.
    bad = bin_idx.clone()
    bad[0, 5], bad[3, 0], bad[Q - 1, -1] = n_bins, -1, 1 << 30
    out_of_range = ((bad < 0) | (bad >= n_bins)).repeat_interleave(BW, 1)
    got = k4.gather_rescore(R, M_binned, bad)
    want = k4.gather_rescore_plain(R, M_binned, bad.clamp(0, n_bins - 1))
    if not bool(got[out_of_range].isnan().all()):
        raise AssertionError("an out-of-range bin did not give NaN")
    check("gather_rescore", "out_of_range_ids", got[~out_of_range],
          want[~out_of_range])
    return records


def _slse_case(B, k, dtype, seed, all_masked=False, d=D):
    """Seeded inputs on the card: tanh reps, N(0, 1/d) candidates scaled
    up, -log(k q) corrections, and ids with accidental hits (or, with
    ``all_masked``, every candidate id equal to row 0's positive)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    reps = torch.tanh(torch.randn(B, d, generator=g, device=dev))
    cand = torch.randn(k, d, generator=g, device=dev) * (2.0 / d ** 0.5)
    corr = (torch.log(torch.tensor(float(k), device=dev))
            + 0.5 * torch.randn(k, generator=g, device=dev))
    pos = torch.randint(0, E, (B,), generator=g, device=dev)
    ids = torch.randint(0, E, (k,), generator=g, device=dev)
    if all_masked:
        ids[:] = 7
        pos[pos == 7] = 8
        pos[0] = 7
    else:
        n = min(B, k) // 2
        ids[:n] = pos[:n]                # forced accidental hits
    s_pos = torch.randn(B, generator=g, device=dev)
    return reps, cand, corr, ids, pos, s_pos


def _slse_plan_text(B, k, d, dtype) -> str:
    """A case's sweep plan (ops.sampled_lse._plan) in one word."""
    from sert_tpu_torch.ops import sampled_lse as slse
    fwd, dc = slse._plan(B, k, d, dtype)
    return (f"fwd/dreps:{fwd.n_x}x{fwd.parts}chunks_of_{fwd.per}x"
            f"{fwd.y_rows}rows={fwd.blocks}blocks,"
            f"dc:{dc.n_x}x{dc.parts}slices_of_{dc.per}x{dc.y_rows}rows="
            f"{dc.blocks}blocks")


# K1/K2's cases: (label, B, k, d, dtype, all-masked row, two K2 calls held
# bit for bit). The flagship in both dtypes, a ragged k, a small k, the
# amazon_* recipes' k = 256 shapes (home_kitchen: d = 256, bf16;
# musical_instruments: B = 1024, fp32), the dC sweep at its most batch
# slices (k under one candidate tile: one batch tile a slice), and an
# all-masked row.
SLSE_CASES = [("flagship", B_TRAIN, K_NEG, D, "bfloat16", False, True),
              ("flagship", B_TRAIN, K_NEG, D, "float32", False, False),
              ("ragged", B_TRAIN, K_NEG - 1, D, "bfloat16", False, False),
              ("small_k", B_TRAIN, 1024, D, "bfloat16", False, False),
              ("small_k", B_TRAIN, 1024, D, "float32", False, False),
              ("amazon_home_kitchen", 4096, 256, 256, "bfloat16", False,
               False),
              ("amazon_musical_instruments", 1024, 256, D, "float32", False,
               False),
              ("dc_slices_max", B_TRAIN, 100, D, "bfloat16", False, True),
              ("all_masked", 256, 1024, D, "bfloat16", True, False)]


def _slse_check(phase: str, seed: int, case, records: dict,
                keep_times: bool = False) -> None:
    """One K1/K2 case of SLSE_CASES' form against sampled_lse_plain +
    autograd on the same seeded inputs: errors join ``records``, times and
    the case's bounds are printed (and with ``keep_times`` kept as the
    records' times)."""
    import torch
    import torch.nn.functional as F
    from sert_tpu_torch.ops import sampled_lse as slse
    label, B, k, d, dtype, masked, twice = case
    reps, cand, corr, ids, pos, s_pos = _slse_case(B, k, dtype, seed,
                                                   masked, d)
    say(phase, case=label, B=B, k=k, d=d, dtype=dtype,
        plan=_slse_plan_text(B, k, d, dtype))
    tol = SLSE_TOL[dtype]
    out = {}
    for name, fn in (("kernel", slse.sampled_lse),
                     ("plain", slse.sampled_lse_plain)):
        r, c, co = (t.clone().requires_grad_(True)
                    for t in (reps, cand, corr))
        lse = fn(r, c, co, ids, pos, dtype)
        loss = F.softplus(lse - s_pos).sum()
        grads = torch.autograd.grad(loss, [r, c, co], retain_graph=True)
        out[name] = dict(lse=lse.detach(), dreps=grads[0],
                         dC=grads[1], dcorr=grads[2])
        if name == "kernel" and twice:
            again = torch.autograd.grad(loss, [r, c, co],
                                        retain_graph=True)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            say(phase, case=label, dtype=dtype,
                two_backward_calls_bit_equal=same)
            if not same:
                raise AssertionError(f"{label}: two K2 calls differ")
            del again
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: fn(reps, cand, corr, ids, pos,
                                        dtype), iters=5, warmup=1)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            loss, [r, c, co], retain_graph=True), iters=5, warmup=1)
        out[name].update(fwd_ms=fwd_ms, bwd_ms=bwd_ms)
        del lse, loss, grads
    errs = {}
    for key in ("lse", "dreps", "dC", "dcorr"):
        a, b = out["kernel"][key].float(), out["plain"][key].float()
        if masked and key == "lse":      # both ~-1e30 on the masked row
            a, b = a[1:], b[1:]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} {dtype}: {key} not finite")
        err = (a - b).abs().max().item()
        limit = tol * b.abs().max().item()
        errs[key] = err
        say(phase, case=label, B=B, k=k, d=d, dtype=dtype,
            output=key, max_abs_err=err, tol=f"{tol}*max|plain|",
            bound=limit)
        if err > limit:
            raise AssertionError(f"{label} {dtype}: {key} error {err} "
                                 f"> {limit}")
    if masked:
        got = out["kernel"]
        if got["lse"][0].item() > -1e29 or bool(got["dreps"][0].any()):
            raise AssertionError("the all-masked row's lse is not "
                                 "~-1e30 or its dreps is not exactly 0")
    k_, p_ = out["kernel"], out["plain"]
    # One product of [B, d] by [d, k] a pass: K1 makes one, K2 three (z
    # again, dC and dreps); inputs read once, outputs written once. Each
    # sweep also takes one exponential of every logit (K1 one sweep, K2
    # two), and those run on the SMs' special-function units, a floor of
    # their own beside the tensor cores' (the larger of the two counts).
    ins = nbytes(reps, cand, corr, ids, pos)
    fb = bound(2 * B * k * d, ins + 4 * B, dtype, exps=B * k)
    bb = bound(6 * B * k * d, ins + 8 * B + nbytes(reps, cand, corr), dtype,
               exps=2 * B * k)
    say(phase, case=label, B=B, k=k, d=d, dtype=dtype,
        fwd_ms=k_["fwd_ms"], fwd_plain_ms=p_["fwd_ms"],
        fwd_bound_ms=fb["bound_ms"], bwd_ms=k_["bwd_ms"],
        bwd_plain_ms=p_["bwd_ms"], bwd_bound_ms=bb["bound_ms"])
    fwd, bwd = records["sampled_lse_fwd"], records["sampled_lse_bwd"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], errs["lse"])
    bwd["max_abs_err"] = max(bwd["max_abs_err"], errs["dreps"],
                             errs["dC"], errs["dcorr"])
    if keep_times:
        fwd.update(ms=k_["fwd_ms"], plain_ms=p_["fwd_ms"], **fb)
        bwd.update(ms=k_["bwd_ms"], plain_ms=p_["bwd_ms"], **bb)
    del out
    torch.cuda.empty_cache()


def phase_train_kernels() -> dict:
    """K1 and K2 against sampled_lse_plain + autograd on the same inputs.
    Returns the kernel records of the flagship bf16 case (the training
    path's variant), with errors maxed over every case."""
    src = "sert_tpu_torch/csrc/sampled_lse.cu"
    records = {
        "sampled_lse_fwd": dict(name="sampled_lse_fwd", route="cuda",
                                source=src,
                                replaces="sert_tpu/ops/sampled_lse.py:78",
                                launches=0, max_abs_err=0.0,
                                library_ms=None),
        "sampled_lse_bwd": dict(name="sampled_lse_bwd", route="cuda",
                                source=src,
                                replaces="sert_tpu/ops/sampled_lse.py:89",
                                launches=0, max_abs_err=0.0,
                                library_ms=None)}
    for i, case in enumerate(SLSE_CASES):
        _slse_check("train_kernels", i, case, records, keep_times=i == 0)
    return records


def full_width_searcher(root: str, entities: int = E):
    """Write a random-weight RECIPE serving fixture at full width (with
    ``entities`` entities) under ``root`` and stage the port's
    EntitySearcher on it, with peak memory counted from the load. Returns
    (searcher, data_dir, run_dir, topics, fixture seconds, load + stage +
    warm-up seconds)."""
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.fixture import write_serving_fixture
    from sert_tpu_torch.serving import EntitySearcher

    recipe = load_recipe(RECIPE)
    t0 = time.perf_counter()
    data_dir, run_dir, topics = write_serving_fixture(
        root, recipe, V, entities, N_QUERIES, seed=SEED, device="cuda")
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
    searcher, data_dir, run_dir, topics, fixture_s, load_s = (
        full_width_searcher(root))
    say("serve", fixture_s=fixture_s, load_stage_warmup_s=load_s,
        entities=searcher.num_entities, vocab=len(searcher.vocab),
        rescore_dtype=str(searcher.prep.M_binned.dtype))
    oracle_top, launches, _ = check_searcher("serve", searcher, topics)
    return data_dir, run_dir, topics, oracle_top, launches


def check_searcher(phase: str, searcher, topics: dict,
                   recall_min: float = RECALL_MIN, kernels: bool = True,
                   tie: float = 0.0):
    """One search, then every topic through ``search_many``; recall and
    score error against an fp32 dense oracle on the card (``kernels``:
    K3 and K4 must each have launched; ``tie``: a returned id outside the
    oracle's top k also counts when its score ties the k-th within it).
    Returns (oracle top-10 ids, launches by kernel, the results)."""
    import torch
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.scoring.run import pad_queries
    from sert_tpu_torch.scoring.scorer import (_entity_matrix,
                                               _query_reps_and_terms)

    texts = [topics[q] for q in sorted(topics)]
    k3.launches = k4.launches = 0
    t0 = time.perf_counter()
    one = searcher.search(texts[0])
    t1 = time.perf_counter()
    many = searcher.search_many(texts)
    t2 = time.perf_counter()
    launches = {"score_binmax": k3.launches, "gather_rescore": k4.launches}
    n_batches = -(-len(texts) // Q)
    say(phase, search_ms=(t1 - t0) * 1e3,
        search_many_s=t2 - t1, batches=n_batches,
        per_batch_ms=(t2 - t1) * 1e3 / n_batches,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(launches).replace(" ", ""))
    if kernels and min(launches.values()) < 1:
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
    recalls, tied, worst, oracle_top = [], [], 0.0, []
    with torch.no_grad():
        for lo in range(0, len(texts), Q):
            t = torch.from_numpy(term_ids[lo:lo + Q]).cuda()
            m = torch.from_numpy(num_terms[lo:lo + Q]).cuda()
            R = _query_reps_and_terms(params, cfg, t, m, "cosine")[0]
            S = R @ M.T                                         # [64, E]
            top_s, top = torch.topk(S, K, dim=1)
            kth = top_s[:, -1].cpu().numpy()
            top = top.cpu().numpy()
            for i in range(R.shape[0]):
                hits = many[lo + i]
                if len(hits) != K:
                    raise AssertionError(f"query {lo + i}: {len(hits)} hits")
                ids = [int(name[1:]) for name, _ in hits]
                got = torch.tensor([s for _, s in hits], device="cuda")
                want = S[i, torch.tensor(ids, device="cuda")]
                worst = max(worst, (got - want).abs().max().item())
                found = set(ids) & set(top[i].tolist())
                recalls.append(len(found) / K)
                tied.append((len(found) + int(
                    (want.cpu().numpy()[[j not in found for j in ids]]
                     >= kth[i] - tie).sum())) / K)
                oracle_top.append(top[i, :10].tolist())
            del S
    recall = sum(recalls) / len(recalls)
    with_ties = sum(tied) / len(tied)
    say(phase, mean_recall_vs_dense=recall, min_recall=min(recalls),
        mean_recall_with_ties=with_ties, tie=tie, max_score_err=worst)
    if with_ties < recall_min or worst > SCORE_TOL:
        raise AssertionError(f"recall {with_ties} < {recall_min} or score "
                             f"error {worst} > {SCORE_TOL}")
    del params, M
    return oracle_top, launches, many


def sert_cli(*args, stderr: bool = False):
    """``python -m sert_tpu_torch ARGS`` in a subprocess; its stdout (and,
    with ``stderr``, its standard error beside it)."""
    proc = subprocess.run([sys.executable, "-m", "sert_tpu_torch", *args],
                          capture_output=True, text=True, cwd=HERE)
    if proc.returncode != 0:
        raise RuntimeError(f"sert_tpu_torch {args[0]} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return (proc.stdout, proc.stderr) if stderr else proc.stdout


def phase_cli(root: str, data_dir: str, run_dir: str, topics: dict,
              oracle_top: list) -> None:
    """`query` into a TREC run, then `evaluate` against qrels marking each
    topic's 10 best entities by the dense oracle as relevant."""
    from sert_tpu_torch.fixture import read_run, write_eval_inputs
    topics_path, qrels_path = write_eval_inputs(
        root, topics, dict(zip(sorted(topics), oracle_top)))
    run_path = os.path.join(root, "run.trec")

    t0 = time.perf_counter()
    sert_cli("query", "--recipe", RECIPE, "--data", data_dir,
        "--run-dir", run_dir, "--topics", topics_path, "--out", run_path)
    t1 = time.perf_counter()
    run = read_run(run_path)
    sizes = {len(v) for v in run.values()}
    if len(run) != len(topics) or sizes != {K}:
        raise AssertionError(f"run has {len(run)} topics, sizes {sizes}")
    metrics = json.loads(sert_cli("evaluate", "--run", run_path,
                             "--qrels", qrels_path))
    say("cli", query_s=t1 - t0, topics=len(run), entries_per_topic=K,
        ndcg_at_100=metrics["ndcg@100"],
        recall_at_1000=metrics["recall@1000"])
    if metrics["recall@1000"] < RECALL_MIN:
        raise AssertionError(f"CLI run misses the oracle's top 10: "
                             f"{metrics}")


def train_recipe_json(root: str, name: str = RECIPE,
                      epochs: int = TRAIN_EPOCHS,
                      log_every: int = TRAIN_LOG_EVERY,
                      filename: str = "recipe.json") -> str:
    """A recipe with a phase's cuts (``epochs`` epochs, a log every
    ``log_every`` micro-steps so that a short run logs at all) as a recipe
    JSON under ``root``; by default the flagship's for phase 7."""
    import dataclasses
    from sert_tpu_torch.cli import load_recipe
    r = load_recipe(name)
    r = dataclasses.replace(r, train=dataclasses.replace(
        r.train, num_epochs=epochs, log_every_steps=log_every))
    path = os.path.join(root, filename)
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(r), fh, indent=2, sort_keys=True)
    return path


def phase_train(root: str):
    """Train the flagship at full width on the training fixture; check the
    loss, the K1/K2 launches, the snapshots and the final checkpoint.
    Returns (data_dir, run_dir, topics, qrels, launches by kernel)."""
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.fixture import write_training_fixture
    from sert_tpu_torch.ops import sampled_lse as slse
    from sert_tpu_torch.train import checkpoint as ckpt

    recipe = load_recipe(train_recipe_json(root))
    t0 = time.perf_counter()
    data_dir, topics, qrels = write_training_fixture(
        os.path.join(root, "train"), recipe, V, E, TRAIN_INSTANCES,
        num_queries=N_QUERIES, seed=SEED)
    t1 = time.perf_counter()
    run_dir = os.path.join(root, "train", "run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slse.fwd_launches = slse.bwd_launches = 0
    state, _ = pipeline.train_from_dir(recipe, data_dir, run_dir,
                                       resume=False, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"sampled_lse_fwd": slse.fwd_launches,
                "sampled_lse_bwd": slse.bwd_launches}
    peak = torch.cuda.max_memory_allocated()

    logs = [json.loads(line) for line in
            open(os.path.join(run_dir, "train_log.jsonl"))]
    steps = [r for r in logs if r["event"] == "train_step"]
    losses = [r["loss"] for r in steps]
    first_of_epoch = {min(r["step"] for r in steps if r["epoch"] == e)
                      for e in {r["epoch"] for r in steps}}
    mid_sps = [r["steps_per_sec"] for r in steps
               if r["step"] not in first_of_epoch]
    warm = next((r for r in logs if r["event"] == "warmup"), {})
    saved = ckpt.list_checkpoints(os.path.join(run_dir, "checkpoints"))
    written = {s: {k: v for k, v in ckpt.load_meta(p).items()
                   if k in ("params_only", "snapshot_dtype", "epoch")}
               for s, p in saved.items()}
    say("train", fixture_s=t1 - t0, train_s=t2 - t1, steps=state.step,
        first_loss=losses[0] if losses else None,
        last_loss=losses[-1] if losses else None,
        mid_epoch_steps_per_sec=json.dumps(mid_sps),
        first_step_s=warm.get("first_step_s"), peak_mem_bytes=peak,
        launches=json.dumps(launches).replace(" ", ""),
        checkpoints=json.dumps(written).replace(" ", ""))
    want_steps = TRAIN_EPOCHS * TRAIN_INSTANCES // B_TRAIN
    if state.step != want_steps:
        raise AssertionError(f"{state.step} steps, expected {want_steps}")
    if len(losses) < 2 or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss is not finite and falling: {losses}")
    if min(launches.values()) < state.step:
        raise AssertionError(f"K1/K2 launched {launches} times for "
                             f"{state.step} steps")
    final = saved.get(state.step)
    if final is None or written[state.step].get("params_only") or any(
            not w.get("params_only") or w.get("snapshot_dtype") != "bfloat16"
            for s, w in written.items() if s != state.step):
        raise AssertionError(f"snapshots are not the recipe's: {written}")

    loaded, _ = ckpt.load_checkpoint(final, state)
    same = _states_equal(loaded, state)
    say("train", reloaded_final=os.path.basename(final),
        equals_state_in_memory=same)
    if not same:
        raise AssertionError("the final checkpoint differs from the state")
    del state, loaded
    torch.cuda.empty_cache()

    # The `train` command on the finished run: it resumes from the final
    # full checkpoint, has no epoch left, and writes nothing.
    t0 = time.perf_counter()
    sert_cli("train", "--recipe", os.path.join(root, "recipe.json"),
             "--data", data_dir, "--out", run_dir, "--device", "cuda")
    after = ckpt.list_checkpoints(os.path.join(run_dir, "checkpoints"))
    say("train", cli_train_resume_s=time.perf_counter() - t0,
        checkpoints_unchanged=after == saved)
    if after != saved:
        raise AssertionError(f"the resumed `train` wrote {after}")
    return data_dir, run_dir, topics, qrels, launches


def phase_serve_trained(root: str, data_dir: str, run_dir: str,
                        topics: dict, qrels: dict):
    """The searcher on the run phase_train wrote, checked like the random
    one, and the reciprocal rank of each topic's planted entity. Returns
    the searcher (the fold-in and HTTP phases serve from it)."""
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.serving import EntitySearcher
    recipe = load_recipe(os.path.join(root, "recipe.json"))
    searcher = EntitySearcher(recipe, data_dir, run_dir, k=K, query_batch=Q)
    if searcher.engine != "pallas":
        raise AssertionError(f"engine {searcher.engine}, not the kernels")
    _, launches, many = check_searcher("serve_trained", searcher, topics)
    run = {q: hits for q, hits in zip(sorted(topics), many)}
    torch.cuda.empty_cache()
    hits_at = [next((i for i, (n, _) in enumerate(run[q]) if n in qrels[q]),
                    None) for q in sorted(topics)]
    mrr = sum(1.0 / (i + 1) for i in hits_at if i is not None) / len(hits_at)
    say("serve_trained", topics=len(topics), mrr_of_planted_entity=mrr,
        found_at_1000=sum(i is not None for i in hits_at),
        launches=json.dumps(launches).replace(" ", ""))
    return searcher


def _median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def _engine_searcher(root: str, data_dir: str, run_dir: str, **score_kw):
    """An EntitySearcher on the trained run with the recipe's ScoreConfig
    changed by ``score_kw``, and its load + stage + warm-up seconds."""
    import dataclasses
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.serving import EntitySearcher
    recipe = load_recipe(os.path.join(root, "recipe.json"))
    recipe = dataclasses.replace(recipe, score=dataclasses.replace(
        recipe.score, **score_kw))
    t0 = time.perf_counter()
    searcher = EntitySearcher(recipe, data_dir, run_dir, k=K, query_batch=Q)
    torch.cuda.synchronize()
    return searcher, time.perf_counter() - t0


def _topk_check(phase: str, name: str, fn, Rs, M) -> dict:
    """``fn(R)`` -> (scores, ids) on each batch of query reps against the
    fp32 dense oracle on the card: recall at K and score error, each
    kernel's launches over the batches, and one batch's latency."""
    import torch
    _zero_kernel_counts()
    outs = [fn(R) for R in Rs]
    torch.cuda.synchronize()
    launches = _kernel_counts()
    recalls, worst = [], 0.0
    for R, (top_s, top_i) in zip(Rs, outs):
        S = R @ M.T
        want = torch.topk(S, K, dim=1).indices
        worst = max(worst, (top_s - torch.gather(S, 1, top_i)).abs()
                    .max().item())
        for g, w in zip(top_i.tolist(), want.tolist()):
            recalls.append(len(set(g) & set(w)) / K)
        del S
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(Rs[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    recall = sum(recalls) / len(recalls)
    say(phase, engine=name, mean_recall_vs_dense=recall,
        min_recall=min(recalls), max_score_err=worst,
        batch_ms_median=_median(ms), batch_ms=json.dumps(ms),
        launches=json.dumps(launches).replace(" ", ""))
    if recall < RECALL_MIN or worst > SCORE_TOL:
        raise AssertionError(f"{name}: recall {recall} < {RECALL_MIN} or "
                             f"score error {worst} > {SCORE_TOL}")
    return launches


def _binmax_vs_fp64(phase: str, variant: str, R, M, Mp, bias=None,
                    alpha=None) -> float:
    """K3 on the staged ``Mp`` against the fp64 bin maxima of R M^T
    (+ alpha * bias), as the two-phase rescore's acceptance cut reads it:
    each query's largest error over its largest bin max, the worst query.
    An fp32 ``Mp`` must stay within a quarter of the fp32 slack
    (``exact_topk.ADAPTIVE_EPS``). Its launches are not the path's."""
    import torch
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.ops.exact_topk import ADAPTIVE_EPS
    E, q = M.shape[0], R.shape[0]
    n_bins = -(-E // BW)
    s64 = R.double() @ M.double().T
    if bias is not None:
        s64 += alpha.double()[:, None] * bias.double()[None, :]
    s64 = torch.nn.functional.pad(s64, (0, n_bins * BW - E),
                                  value=float("-inf"))
    want = s64.view(q, n_bins, BW).amax(dim=-1)
    del s64
    got = k3.score_binmax_prepared(R, Mp, E, bias, alpha,
                                   bin_width=BW).double()
    rel = ((got - want).abs().amax(1) / want.amax(1).abs()).max().item()
    slack = ADAPTIVE_EPS[Mp.dtype]
    say(phase, name="score_binmax", variant=variant,
        bias=bias is not None, max_err_vs_fp64_rel_to_query_max=rel,
        adaptive_slack=slack)
    if Mp.dtype == torch.float32 and 4 * rel > slack:
        raise AssertionError(f"K3 fp32 {variant}: {rel} of the query's max "
                             f"from fp64, past a quarter of the slack "
                             f"{slack}")
    return rel


def _layout_regime(M, R) -> dict:
    """The clustered layout where it was built to help: the first
    LAYOUT_E trained rows at depth LAYOUT_K. Mean winner-bins (distinct
    bins holding a query's true top k) under each layout, and the share
    of queries (one a call) whose two-phase rescore of LAYOUT_NA bins fell
    back to the full one; every answer against the oracle. Returns the
    launches by kernel."""
    import torch
    from sert_tpu_torch.ops import exact_topk
    M = M[:LAYOUT_E].contiguous()
    S = R @ M.T
    want_s, want = torch.topk(S, LAYOUT_K, dim=1)
    stats, total = {}, {}
    for layout in ("natural", "clustered"):
        t0 = time.perf_counter()
        prep = exact_topk.prepare_entities(M, layout=layout)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        pos = (want if prep.perm is None
               else torch.argsort(prep.perm)[want])
        bins = [torch.unique(p // prep.bin_width).numel()
                for p in pos]
        _zero_kernel_counts()
        worst, recalls = 0.0, []
        for i in range(R.shape[0]):
            top_s, top_i = exact_topk.exact_topk_prepared(
                R[i:i + 1], prep, k=LAYOUT_K, adaptive_bins=LAYOUT_NA)
            worst = max(worst, (top_s[0] - S[i, top_i[0]]).abs()
                        .max().item())
            recalls.append(len(set(top_i[0].tolist())
                               & set(want[i].tolist())) / LAYOUT_K)
        calls = R.shape[0]
        launches = _kernel_counts()
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        stats[layout] = dict(
            stage_s=stage_s, mean_winner_bins=sum(bins) / len(bins),
            fallback_share=(launches["gather_rescore"] - calls) / calls,
            mean_recall_vs_dense=sum(recalls) / len(recalls),
            max_score_err=worst)
        if stats[layout]["mean_recall_vs_dense"] < RECALL_MIN \
                or worst > SCORE_TOL:
            raise AssertionError(f"{layout} at {LAYOUT_E}: {stats}")
    say("serve_engines", regime=f"E={LAYOUT_E},k={LAYOUT_K},"
        f"adaptive_bins={LAYOUT_NA},one_query_a_call",
        stats=json.dumps(stats).replace(" ", ""))
    return total


def phase_serve_engines(root: str, data_dir: str, run_dir: str,
                        topics: dict, natural) -> dict:
    """Every single-device engine and staging option on the trained 1M
    run, against the fp32 dense oracle, beside the natural kernel engine
    (``natural``, phase 8's searcher): the streaming scan and approx
    (exact: recall 1.0 up to exact ties), the clustered layout (its ids
    the natural layout's but for ties; its k-means timed; two stagings
    the same permutation) and with it the two-phase rescore (K4's
    launches a call give the share that fell back), then
    ``exact_topk_prepared`` with the fp32 prefilter (K3's fp32 mode) and
    with bins of 64; and the layout at 50,000 rows. Each searcher's batch
    latency is the median of three on the host clock. Returns the
    launches by kernel of the path."""
    import torch
    from sert_tpu_torch.ops import exact_topk
    from sert_tpu_torch.scoring.run import pad_queries
    from sert_tpu_torch.scoring.scorer import (_entity_matrix,
                                               _query_reps_and_terms)
    texts = [topics[q] for q in sorted(topics)]
    batch = texts[:Q]
    natural_ms = _batch_ms(natural, batch)
    natural_hits = natural.search_many(batch)
    say("serve_engines", engine="pallas", layout="natural",
        batch_ms_median=_median(natural_ms),
        batch_ms=json.dumps(natural_ms))
    total: dict = {}

    def add(counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    cases = [("streaming", dict(engine="streaming",
                                entity_chunk=ENGINE_CHUNK), 1.0, False),
             ("approx", dict(engine="approx"), 1.0, False),
             ("clustered", dict(engine="pallas", layout="clustered"),
              RECALL_MIN, True),
             ("clustered_adaptive", dict(engine="pallas", layout="clustered",
                                         adaptive_bins=ADAPTIVE_BINS),
              RECALL_MIN, True)]
    perms = []
    for name, kw, recall_min, kernels in cases:
        searcher, load_s = _engine_searcher(root, data_dir, run_dir, **kw)
        if searcher.engine != kw["engine"]:
            raise AssertionError(f"{name}: engine {searcher.engine}")
        _zero_kernel_counts()
        _, launches, _ = check_searcher(
            f"serve_engines:{name}", searcher, topics, recall_min=recall_min,
            kernels=kernels, tie=0.0 if kernels else ENGINE_TIE)
        add(launches)
        ms = _batch_ms(searcher, batch)
        extra = {}
        if kernels:
            perms.append(searcher.prep.perm)
            hits = searcher.search_many(batch)
            same = all(_same_hits(g, w, ENGINE_TIE)
                       for g, w in zip(hits, natural_hits))
            extra["ids_equal_natural_but_ties"] = same
            if not same:
                raise AssertionError(f"{name}: ids differ from the natural "
                                     "layout's beyond ties")
            calls = launches["score_binmax"]
            extra["k4_launches_per_call"] = (launches["gather_rescore"]
                                             / calls)
            extra["fallback_share"] = (launches["gather_rescore"]
                                       - calls) / calls
        elif launches["score_binmax"] or launches["gather_rescore"]:
            raise AssertionError(f"{name} launched K3/K4: {launches}")
        say("serve_engines", engine=name, load_stage_warmup_s=load_s,
            batch_ms_median=_median(ms), batch_ms=json.dumps(ms),
            natural_batch_ms_median=_median(natural_ms), **extra)
        del searcher
        torch.cuda.empty_cache()

    # The layout's k-means at 1M, timed alone; each staging gave the same
    # permutation.
    params, cfg = natural.params, natural.recipe.model
    M = _entity_matrix(params, cfg, "cosine")
    t0 = time.perf_counter()
    perm = exact_topk._cluster_order(M)
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    same = all(torch.equal(p, perm) for p in perms)
    say("serve_engines", clustered_kmeans_s=kmeans_s,
        clusters=min(8192, max(256, E // BW)), entities=E,
        stagings_same_permutation=same)
    if not same:
        raise AssertionError("two clustered stagings differ")

    encoded = {f"{i:04d}": natural.encode(t) for i, t in enumerate(texts)}
    _, term_ids, num_terms = pad_queries(encoded)
    Rs = []
    with torch.no_grad():
        for lo in range(0, len(texts), Q):
            Rs.append(_query_reps_and_terms(
                params, cfg, torch.from_numpy(term_ids[lo:lo + Q]).cuda(),
                torch.from_numpy(num_terms[lo:lo + Q]).cuda(), "cosine")[0])
        for name, kw, mode in (("prefilter_float32",
                                dict(prefilter_dtype="float32"),
                                "score_binmax_f32"),
                               ("bin_width_64", dict(bin_width=64),
                                "score_binmax")):
            t0 = time.perf_counter()
            prep = exact_topk.prepare_entities(M, **kw)
            torch.cuda.synchronize()
            say("serve_engines", engine=name,
                stage_s=time.perf_counter() - t0,
                prefilter=str(prep.Mp.dtype), bin_width=prep.bin_width)
            launches = _topk_check(
                "serve_engines", name,
                lambda R: exact_topk.exact_topk_prepared(R, prep, k=K),
                Rs, M)
            if launches[mode] != len(Rs) or launches["gather_rescore"] < 1:
                raise AssertionError(f"{name} did not run {mode} and K4 "
                                     f"a batch: {launches}")
            add(launches)
            if prep.Mp.dtype == torch.float32:    # the trained rows
                for R in Rs:
                    _binmax_vs_fp64("serve_engines", "trained,float32", R,
                                    M, prep.Mp)
            del prep
        add(_layout_regime(M, torch.cat(Rs)))
    del M, Rs
    torch.cuda.empty_cache()
    return total


def phase_cli_scoring(root: str, data_dir: str, run_dir: str, topics: dict,
                      qrels: dict, searcher) -> dict:
    """The workflows that read the trained run, through the CLI: `sweep`
    over its epoch snapshots (in this process, so that its K3/K4 launches
    count), `dump --format npz` at full width (the arrays equal the
    served params), `neighbors --entity` and `--term` (the first neighbour
    the host numpy argmax), and `train --init-word-emb` from that dump on
    a 4-step fixture of the same vocabulary (the rows at step 0 equal the
    dump's; the command's loss finite). Returns the sweep's launches."""
    import contextlib
    import io
    import numpy as np
    import torch
    from sert_tpu_torch import cli, pipeline
    from sert_tpu_torch.eval.trec import write_qrels, write_topics
    from sert_tpu_torch.fixture import write_training_fixture
    recipe_json = os.path.join(root, "recipe.json")
    run_args = ["--recipe", recipe_json, "--data", data_dir, "--run-dir",
                run_dir]
    topics_path = os.path.join(root, "sweep_topics.tsv")
    qrels_path = os.path.join(root, "sweep_qrels.trec")
    write_topics(topics, topics_path)
    write_qrels(qrels, qrels_path)

    _zero_kernel_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["sweep", *run_args, "--topics", topics_path,
                       "--qrels", qrels_path])
    sweep_s = time.perf_counter() - t0
    launches = _kernel_counts()
    sweep = json.loads(out.getvalue())
    say("cli_scoring", command="sweep", seconds=sweep_s,
        per_step=json.dumps(sweep["per_step"]).replace(" ", ""),
        best_step=sweep["best_step"], best=sweep["best"],
        launches=json.dumps(launches).replace(" ", ""))
    if (rc != 0 or len(sweep["per_step"]) != TRAIN_EPOCHS
            or str(sweep["best_step"]) not in sweep["per_step"]
            or launches["score_binmax"] < TRAIN_EPOCHS
            or launches["gather_rescore"] < TRAIN_EPOCHS):
        raise AssertionError(f"sweep: {sweep}, launches {launches}")

    npz = os.path.join(root, "dump.npz")
    t0 = time.perf_counter()
    sert_cli("dump", *run_args, "--out", npz)
    dump_s = time.perf_counter() - t0
    with np.load(npz, allow_pickle=True) as z:
        dump = {k: z[k] for k in z.files}
    same = (np.array_equal(dump["word_emb"],
                           searcher.params["word_emb"].float().cpu().numpy())
            and np.array_equal(dump["entity_matrix"],
                               searcher.params["entity_emb"].float().cpu()
                               .numpy()))
    say("cli_scoring", command="dump", seconds=dump_s,
        bytes=os.path.getsize(npz), arrays=",".join(sorted(dump)),
        word_emb=dump["word_emb"].shape, entity_matrix=
        dump["entity_matrix"].shape, equal_to_served_params=same)
    if not same or dump["terms"].shape != (V,) \
            or dump["entities"].shape != (E,):
        raise AssertionError("the dump is not the served run")

    for flag, names, mat, i in (("--entity", dump["entities"],
                                 dump["entity_matrix"], 12345),
                                ("--term", dump["terms"], dump["word_emb"],
                                 777)):
        t0 = time.perf_counter()
        lines = sert_cli("neighbors", *run_args, flag, str(names[i]),
                         "-k", "5").splitlines()
        Mn = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True),
                              1e-9)
        sims = Mn @ Mn[i]
        sims[i] = -np.inf
        want = str(names[int(np.argmax(sims))])
        got = lines[0].split("\t")[1]
        say("cli_scoring", command="neighbors", query=flag,
            seconds=time.perf_counter() - t0, first=got, oracle=want)
        if len(lines) != 5 or got != want:
            raise AssertionError(f"neighbors {flag}: {lines} vs {want}")

    # --init-word-emb: a fresh 4-step fixture of the same vocabulary; step
    # 0 through the command's own function with no epoch to train.
    from sert_tpu_torch.cli import load_recipe
    seed_data, _, _ = write_training_fixture(
        os.path.join(root, "seeded"), load_recipe(recipe_json), V, E,
        4 * B_TRAIN, seed=SEED + 1)
    state, _ = pipeline.train_from_dir(
        load_recipe(train_recipe_json(root, epochs=0,
                                      filename="seed0.json")),
        seed_data, os.path.join(root, "seeded", "run0"), init_word_emb=npz,
        device="cuda")
    step0 = state.params["word_emb"].float().cpu().numpy()
    rows_equal = state.step == 0 and np.array_equal(step0, dump["word_emb"])
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, err = sert_cli("train", "--recipe",
                      train_recipe_json(root, epochs=1, log_every=1,
                                        filename="seed1.json"),
                      "--data", seed_data, "--out",
                      os.path.join(root, "seeded", "run"),
                      "--init-word-emb", npz, stderr=True)
    _, losses, _ = _train_log(os.path.join(root, "seeded", "run"))
    seeded = f"init: seeded {V}/{V} word embeddings" in err
    say("cli_scoring", command="train --init-word-emb",
        seconds=time.perf_counter() - t0, step0_rows_equal_dump=rows_equal,
        logged_all_rows_seeded=seeded, losses=json.dumps(losses))
    if not rows_equal or not seeded or not losses \
            or not all(map(math.isfinite, losses)):
        raise AssertionError("train --init-word-emb did not seed the run")
    return launches


def _kernel_counts(xent_too: bool = False) -> dict:
    """The serving kernels' launch counters, by kernel name (K3's fp32
    mode as ``score_binmax_f32``)."""
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.ops import xent
    counts = {"score_binmax": k3.launches, "gather_rescore": k4.launches,
              "score_binmax_f32": k3.f32_launches}
    if xent_too:
        counts["xent_fwd"] = xent.fwd_launches
    return counts


def _zero_kernel_counts() -> None:
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.ops import xent
    k3.launches = k3.f32_launches = k4.launches = xent.fwd_launches = 0


def _host_params(params: dict) -> dict:
    """The window-rep params (not the entity rows) copied to the host, in
    their own dtype: the port on the CPU from the card's params."""
    return {k: params[k].cpu() for k in ("word_emb", "proj_w", "proj_b")}


def _same_hits(got, want, tol: float) -> bool:
    """Scores within ``tol`` rank by rank and name by name; names may trade
    places only within a tie, and a name in one list only must tie with
    the other list's last score."""
    if got is None or want is None or len(got) != len(want):
        return got is None and want is None
    if max(abs(a[1] - b[1]) for a, b in zip(got, want)) > tol:
        return False
    g, w = dict(got), dict(want)
    floor = min(w.values())
    return (all(abs(g[n] - w[n]) <= tol for n in g.keys() & w.keys())
            and all(abs(g.get(n, w.get(n)) - floor) <= tol
                    for n in g.keys() ^ w.keys()))


def _batch_ms(searcher, texts, repeats: int = 3) -> list:
    """Host-clock milliseconds of ``repeats`` search_many calls of
    ``texts`` (one batch), after a warm one."""
    searcher.search_many(texts)
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        searcher.search_many(texts)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_serve_foldin(searcher, topics: dict) -> dict:
    """Fold 64 entities (affine: each one topic's own four-term text) and 8
    (gradient) into the trained 1M-entity searcher; each vector against
    the port on the CPU from the same params; every topic through
    search_many against a dense oracle over the trained rows and the 72
    extras; each affine entity in its own topic's top 10 at that topic's
    trained top score; then the NCE refit at full width against the CPU.
    Returns the launches by kernel of the path."""
    import torch
    from sert_tpu_torch.models import lse
    from sert_tpu_torch.scoring.run import pad_queries
    from sert_tpu_torch.scoring.scorer import (_entity_matrix,
                                               _query_reps_and_terms)
    from sert_tpu_torch.utils.config import ModelConfig

    if searcher.engine != "pallas":
        raise AssertionError(f"engine {searcher.engine}, not the kernels")
    qids = sorted(topics)
    texts = [topics[q] for q in qids]
    affine = [(f"fold-{q}", topics[q]) for q in qids[:FOLD_AFFINE]]
    gradient = [(f"fold-{q}", topics[q])
                for q in qids[FOLD_AFFINE:FOLD_AFFINE + FOLD_GRADIENT]]
    _zero_kernel_counts()
    batch0_ms = _batch_ms(searcher, texts[:Q])

    torch.cuda.reset_peak_memory_stats()
    before = _kernel_counts()
    t0 = time.perf_counter()
    searcher.add_entities(affine, method="affine")
    t1 = time.perf_counter()
    probe = {k: v - before[k] for k, v in _kernel_counts().items()}
    searcher.add_entities(gradient, method="gradient")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    say("serve_foldin", affine_entities=len(affine),
        affine_add_ms=(t1 - t0) * 1e3, gradient_entities=len(gradient),
        gradient_add_ms=(t2 - t1) * 1e3,
        probe_launches=json.dumps(probe).replace(" ", ""),
        peak_mem_bytes=peak, extras=searcher.num_extra_entities)
    if min(probe["score_binmax"], probe["gather_rescore"]) < 1:
        raise AssertionError(f"the affine probe launched no kernel: {probe}")

    # Each fold-in vector against the port on the CPU, same params.
    cpu_params = _host_params(searcher.params)
    cfg, w = searcher.recipe.model, searcher.recipe.data.window_size
    norm_med = searcher._trained_stats()[0]
    worst = 0.0
    for j, (name, text) in enumerate(affine + gradient):
        v = lse.fold_in_entity(cpu_params, searcher.encode(text), cfg,
                               window_size=w).numpy()
        scale = 1.0 if j < len(affine) else norm_med
        v = v * scale / max(float((v * v).sum()) ** 0.5, 1e-9)
        worst = max(worst, float(abs(v - searcher._extra_vecs[j]).max()))
    say("serve_foldin", vectors_vs_cpu_max_abs_err=worst, tol=FOLD_VEC_TOL)
    if worst > FOLD_VEC_TOL:
        raise AssertionError(f"fold-in vectors differ from the CPU's by "
                             f"{worst}")

    batch72_ms = _batch_ms(searcher, texts[:Q])
    t0 = time.perf_counter()
    many = searcher.search_many(texts)
    many_s = time.perf_counter() - t0
    launches = _kernel_counts()
    say("serve_foldin", batch_ms_0_extras=json.dumps(batch0_ms),
        batch_ms_72_extras=json.dumps(batch72_ms), search_many_s=many_s,
        launches=json.dumps(launches).replace(" ", ""))

    # Dense fp32 oracle: the trained scores S = R M^T beside each extra's
    # score from its stored vector and span (the calibration in plain
    # torch), ranked together to depth K.
    E = searcher.num_entities
    names = searcher._extra_names
    vecs = torch.from_numpy(searcher._extra_vecs).cuda()
    vecs_n = vecs / vecs.norm(dim=1, keepdim=True).clamp(min=1e-9)
    floor = torch.from_numpy(searcher._extra_spans[:, 0]).float().cuda()
    top = torch.from_numpy(searcher._extra_spans[:, 1]).float().cuda()
    raw = torch.from_numpy(searcher._extra_raw).cuda()
    index = {n: E + j for j, n in enumerate(names)}
    encoded = {f"{i:04d}": searcher.encode(t) for i, t in enumerate(texts)}
    _, term_ids, num_terms = pad_queries(encoded)
    M = _entity_matrix(searcher.params, cfg, "cosine")
    recalls, err, own = [], 0.0, []
    with torch.no_grad():
        for lo in range(0, len(texts), Q):
            t = torch.from_numpy(term_ids[lo:lo + Q]).cuda()
            m = torch.from_numpy(num_terms[lo:lo + Q]).cuda()
            R = _query_reps_and_terms(searcher.params, cfg, t, m,
                                      "cosine")[0]
            S = R @ M.T                                         # [64, E]
            cos = R @ vecs_n.T                                  # [64, 72]
            side = ((cos - floor).clamp(min=0.0)
                    / (1.0 - floor).clamp(min=1e-9) * top)
            S = torch.cat([S, torch.where(raw, cos, side)], dim=1)
            best = torch.topk(S, K, dim=1).indices.cpu().numpy()
            for i in range(R.shape[0]):
                q = lo + i
                hits = many[q]
                ids = [index[n] if n in index else int(n[1:])
                       for n, _ in hits]
                got = torch.tensor([s for _, s in hits], device="cuda")
                err = max(err, (got - S[i, ids]).abs().max().item())
                recalls.append(len(set(ids) & set(best[i].tolist())) / K)
                if q < len(affine):
                    trained_top = S[i, :E].max().item()
                    score = dict(hits[:10]).get(affine[q][0])
                    own.append(None if score is None
                               else abs(score - trained_top))
            del S
    recall = sum(recalls) / len(recalls)
    missing = sum(d is None for d in own)
    own_err = max((d for d in own if d is not None), default=float("inf"))
    say("serve_foldin", mean_recall_vs_dense=recall, min_recall=min(recalls),
        max_score_err=err, own_topic_top10=len(own) - missing,
        own_topic_score_err=own_err)
    if recall < RECALL_MIN or err > SCORE_TOL:
        raise AssertionError(f"recall {recall} < {RECALL_MIN} or score "
                             f"error {err} > {SCORE_TOL}")
    if missing or own_err > SCORE_TOL:
        raise AssertionError(f"{missing} folded entities miss their own "
                             f"topic's top 10, or score {own_err} from "
                             f"its trained top")
    del M, vecs

    # The NCE refit (_fold_in_opt, 1000 adam steps) at full width on the
    # card against the port on the CPU.
    ids = searcher.encode(texts[0])
    neg = searcher._raw_negative_reps(ids)
    neg_weight = float(ModelConfig.num_negatives)
    kw = dict(window_size=w, neg_weight=neg_weight)
    lse.fold_in_entity_gradient(searcher.params, ids, cfg,
                                torch.from_numpy(neg), steps=2, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v_card = lse.fold_in_entity_gradient(searcher.params, ids, cfg,
                                         torch.from_numpy(neg), **kw)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    v_cpu = lse.fold_in_entity_gradient(cpu_params, ids, cfg,
                                        torch.from_numpy(neg), **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    v_card = v_card.cpu()
    cos = float(v_card @ v_cpu / (v_card.norm() * v_cpu.norm()))
    rel = abs(float(v_card.norm() / v_cpu.norm()) - 1.0)
    say("serve_foldin", nce_refit_steps=1000, negatives=neg.shape[0],
        neg_weight=neg_weight, card_ms=card_ms, cpu_ms=cpu_ms,
        cos_vs_cpu=cos, norm_rel_diff=rel, cos_min=FOLD_COS_MIN,
        norm_rtol=FOLD_NORM_RTOL)
    if not cos >= FOLD_COS_MIN or not rel <= FOLD_NORM_RTOL:
        raise AssertionError(f"the card's NCE refit differs from the CPU's: "
                             f"cos {cos}, norm {rel}")
    return launches


class _Http:
    """A server on loopback in a thread; ``call`` returns (status, JSON)."""

    def __init__(self, searcher):
        from sert_tpu_torch.serving import make_http_server
        self.server = make_http_server(searcher, port=0)
        self.base = "http://127.0.0.1:%d" % self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def call(self, path, body=None):
        import urllib.error
        import urllib.request
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def _hits_of(payload) -> list:
    return [(r["entity"], r["score"]) for r in payload["results"]]


def _check_http_answers(phase, http, searcher, texts, k, tol) -> None:
    """A batched POST of ``texts`` and a GET of the first, each against
    search_many's answers."""
    import urllib.parse
    want = searcher.search_many(texts, k=k)
    code, body = http.call("/search", {"queries": texts, "k": k})
    got = [_hits_of(b) for b in body["batched"]] if code == 200 else []
    code_get, one = http.call("/search?q=%s&k=%d"
                              % (urllib.parse.quote(texts[0]), k))
    ok = (code == code_get == 200 and len(got) == len(want)
          and all(_same_hits(g, w, tol) for g, w in zip(got, want))
          and _same_hits(_hits_of(one), want[0], tol))
    say(phase, batched_post=len(texts), get=1, k=k, equal_search_many=ok)
    if not ok:
        raise AssertionError(f"{phase}: HTTP answers differ from "
                             f"search_many's")


def phase_serve_http(searcher, topics: dict) -> dict:
    """The JSON HTTP server on the fold-in phase's searcher: 16 concurrent
    POST /search clients (coalesced, each answer search_many's), a batched
    POST, a GET, /healthz, POST /entities and a duplicate. Returns the
    launches by kernel of the path."""
    texts = [topics[q] for q in sorted(topics)]
    want = searcher.search_many(texts[:HTTP_CLIENTS])
    extras = searcher.num_extra_entities
    _zero_kernel_counts()
    http = _Http(searcher)
    try:
        code, one = http.call("/search", {"query": texts[0]})   # warm
        t0 = time.perf_counter()
        code, one = http.call("/search", {"query": texts[0]})
        one_ms = (time.perf_counter() - t0) * 1e3
        searcher.stats.update(dispatches=0, batched_queries=0, max_batch=0)
        got = [None] * HTTP_CLIENTS

        def client(i):
            got[i] = http.call("/search", {"query": texts[i]})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        stats = dict(searcher.stats)
        same = all(g is not None and g[0] == 200
                   and _same_hits(_hits_of(g[1]), w, HTTP_SCORE_TOL)
                   for g, w in zip(got, want))
        say("serve_http", one_query_ms=one_ms, clients=HTTP_CLIENTS,
            clients_wall_s=wall, queries_per_s=HTTP_CLIENTS / wall,
            dispatches=stats["dispatches"], max_batch=stats["max_batch"],
            equal_search_many=same)
        if code != 200 or not same or stats["max_batch"] < 2:
            raise AssertionError(f"HTTP clients: equal {same}, stats {stats}")
        _check_http_answers("serve_http", http, searcher, texts[:Q], 100,
                            HTTP_SCORE_TOL)
        health = http.call("/healthz")
        added = http.call("/entities", {"entities": [
            {"name": "http-new", "text": texts[-1]}]})
        dup = http.call("/entities", {"entities": [
            {"name": "http-new", "text": texts[-2]}]})
        say("serve_http", healthz=json.dumps(health[1]).replace(" ", ""),
            post_entities=added[0], duplicate=dup[0])
        if (health[0] != 200 or health[1]["extra_entities"] != extras
                or health[1]["entities"] != searcher.num_entities
                or added != (200, {"added": 1,
                                   "extra_entities": extras + 1})
                or dup[0] != 400):
            raise AssertionError(f"healthz {health}, POST /entities "
                                 f"{added}, duplicate {dup}")
    finally:
        http.close()
    return _kernel_counts()


def phase_serve_http_loglinear(root: str) -> dict:
    """The HTTP server on cerc_expert_finding's run (phase 11): K3 with
    the bias, K4 and the K5 normalizer behind one GET and one batched
    POST, each against search_many. Returns the launches by kernel."""
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.eval.trec import read_topics
    from sert_tpu_torch.serving import EntitySearcher
    work = os.path.join(root, "cerc_expert_finding")
    _zero_kernel_counts()
    searcher = EntitySearcher(load_recipe("cerc_expert_finding"),
                              os.path.join(work, "data"),
                              os.path.join(work, "run"))
    if searcher.engine != "pallas":
        raise AssertionError(f"engine {searcher.engine}, not the kernels")
    topics = read_topics(os.path.join(work, "run", "topics.tsv"))
    http = _Http(searcher)
    try:
        _check_http_answers("serve_http", http, searcher,
                            [topics[q] for q in sorted(topics)],
                            searcher.k_max, LL_HTTP_SCORE_TOL)
    finally:
        http.close()
    launches = _kernel_counts(xent_too=True)
    say("serve_http", model="loglinear", recipe="cerc_expert_finding",
        launches=json.dumps(launches).replace(" ", ""))
    if min(launches["score_binmax"], launches["gather_rescore"],
           launches["xent_fwd"]) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    del searcher
    torch.cuda.empty_cache()
    return launches


def _xent_case(B, E, d, layout, seed):
    """Seeded inputs on the card: pooled reps, an entity matrix in
    ``layout`` scaled as an initialized one, a small bias, labels."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    pooled = 0.5 * torch.randn(B, d, generator=g, device="cuda")
    W = torch.randn((d, E) if layout == "de" else (E, d), generator=g,
                    device="cuda") * (2.0 / d ** 0.5)
    b = 0.1 * torch.randn(E, generator=g, device="cuda")
    labels = torch.randint(0, E, (B,), generator=g, device="cuda")
    return pooled, W, b, labels


def _xent_outputs(fn, pooled, W, b, labels, layout, dtype, iters,
                  repeat=False):
    """Loss and gradients of the mean loss, and CUDA-event times of the
    forward and of the backward alone. ``repeat``: the backward again, which
    must give the same bits."""
    import torch
    p, w, bb = (t.clone().requires_grad_(True) for t in (pooled, W, b))
    loss = fn(p, w, bb, labels, layout, dtype)
    mean = loss / pooled.shape[0]
    grads = torch.autograd.grad(mean, [p, w, bb], retain_graph=True)
    if repeat:
        again = torch.autograd.grad(mean, [p, w, bb], retain_graph=True)
        same = all(torch.equal(u, v) for u, v in zip(grads, again))
        say("xent_kernels", backward_twice_bit_equal=same,
            shape=f"{pooled.shape[0]}x{b.shape[0]}x{pooled.shape[1]}")
        if not same:
            raise AssertionError("two backward calls differ")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fn(pooled, W, b, labels, layout, dtype),
                         iters=iters, warmup=1)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        mean, [p, w, bb], retain_graph=True), iters=iters, warmup=1)
    return dict(loss=loss.detach(), dpooled=grads[0], dW=grads[1],
                db=grads[2], fwd_ms=fwd_ms, bwd_ms=bwd_ms)


def _xent_work(B, E, d, pooled, W, b, labels):
    """(K5 flops, K5 bytes, K5 exponentials, K6 flops, K6 bytes, K6
    exponentials): one [B, d] x [d, E] product in K5, three in K6 (z again,
    dW, dpooled); inputs read once, outputs written once; an exponential
    of every logit, B * E in each of K5 and K6 (the function's, however
    many z passes a design takes), on the SMs' special-function units, as
    K1/K2's."""
    ins = nbytes(pooled, W, b, labels)
    return (2 * B * E * d, ins + 4 * B, B * E, 6 * B * E * d,
            ins + 8 * B + nbytes(pooled, W, b), B * E)


def _masked_err(got, want, keep, axis: int = 0):
    """(max |got - want|, max |want|) over the slices of ``axis`` that the
    boolean ``keep`` marks."""
    index = [slice(None)] * got.dim()
    index[axis] = keep
    a, w = got[tuple(index)].float(), want[tuple(index)].float()
    return (a - w).abs().max().item(), w.abs().max().item()


def _unnamed(labels, E):
    """The entities [E] of a label-free column: no row's label names them."""
    import torch
    named = torch.zeros(E, dtype=torch.bool, device=labels.device)
    named[labels[labels >= 0].long()] = True
    return ~named


def _softmax_errs(got, want, labels, layout) -> dict:
    """{output: (max |kernel - plain|, max |plain|)} of K6's (dpooled, dW,
    db) where they hold exp(z - lse) terms alone: dW's and db's entities
    that no label names, dpooled's rows labelled -1 (where there are)."""
    free = _unnamed(labels, want[2].shape[0])
    errs = {"dW": _masked_err(got[1], want[1], free, int(layout == "de")),
            "db": _masked_err(got[2], want[2], free)}
    if bool((labels < 0).any()):
        errs["dpooled"] = _masked_err(got[0], want[0], labels < 0)
    return errs


def _softmax_part(label, got, want, labels, layout) -> None:
    """:func:`_softmax_errs` printed and held to XENT_SOFTMAX_TOL."""
    for name, (err, scale) in _softmax_errs(got, want, labels,
                                            layout).items():
        say("xent_kernels", case=label, output=name, part="softmax",
            max_abs_err=err, max_plain=scale, rel=err / scale,
            tol=XENT_SOFTMAX_TOL)
        if not err <= XENT_SOFTMAX_TOL * scale:
            raise AssertionError(f"{label}: {name}'s softmax part error "
                                 f"{err} > {XENT_SOFTMAX_TOL} * {scale}")


def _product_ms(pooled, W, layout, iters) -> float:
    """CUDA-event ms of cuBLAS's [B, d] x [d, E] product of the same bf16
    operands (torch.matmul into a bf16 [B, chunk] buffer, E in chunks of
    2^17): one z pass's products, the tensor cores' yardstick beside K5
    and K6. The port never calls it."""
    import torch
    P, Wb = pooled.bfloat16(), W.bfloat16()
    E = W.shape[1] if layout == "de" else W.shape[0]
    step = min(E, 1 << 17)
    out = torch.empty((P.shape[0], step), dtype=torch.bfloat16,
                      device=P.device)

    def run():
        for lo in range(0, E, step):
            hi = min(E, lo + step)
            w = Wb[:, lo:hi] if layout == "de" else Wb[lo:hi].T
            torch.matmul(P, w, out=out[:, :hi - lo])

    return cuda_ms(run, iters=iters, warmup=1)


def _wgmma_plan_text(B, E, d) -> str:
    """The bf16 sweep's plan (ops.xent._wgmma_plan) in one word."""
    from sert_tpu_torch.ops import xent
    fwd, dw = xent._wgmma_plan(B, E, d)
    return (f"fwd/dp:{fwd.n_x}x{fwd.parts}chunks_of_{fwd.per}x"
            f"{fwd.y_rows}rows={fwd.blocks}blocks,"
            f"dw:{dw.n_x}x{dw.parts}slices_of_{dw.per}x{dw.y_rows}rows="
            f"{dw.blocks}blocks")


def phase_xent_kernels() -> dict:
    """K5 and K6 against xent_loss_plain + autograd on the same inputs, in
    fp32 compute (csrc/xent.cu's mma.sync sweep) and in bf16 (csrc/
    xent_wgmma.cu's wgmma sweep; its gradients also on their softmax
    part, XENT_SOFTMAX_TOL, with a control). Returns the kernel records:
    the times of the lse_full_128k case (bf16, the lse_full training
    path's route), the fp32 route's times at cerc's shape (the log-linear
    training path's) beside them, errors maxed over every case."""
    import torch
    from sert_tpu_torch.ops import xent
    src, src32 = ("sert_tpu_torch/csrc/xent_wgmma.cu",
                  "sert_tpu_torch/csrc/xent.cu")
    records = {
        "xent_fwd": dict(name="xent_fwd", route="cuda", source=src,
                         fp32_source=src32,
                         replaces="sert_tpu/ops/xent.py:152", launches=0,
                         max_abs_err=0.0, library_ms=None),
        "xent_bwd": dict(name="xent_bwd", route="cuda", source=src,
                         fp32_source=src32,
                         replaces="sert_tpu/ops/xent.py:219", launches=0,
                         max_abs_err=0.0, library_ms=None)}
    # split_max: the fp32 dW sweep at its most slices (32 over 5 entity
    # tiles); w3c_ragged's last slice ends in a partial batch tile; the bf16
    # cases: lse_full's width, its entity tail, d 256 in "ed" and "de" (the
    # log-linear A/B's width, E 500k).
    cases = [("cerc", 1024, 3500, 256, "de", "float32"),
             ("w3c_ragged", 1000, 1100, 128, "de", "float32"),
             ("lse_full_128k", 4096, 131072, 128, "ed", "bfloat16"),
             ("lse_full_tail", 4096, 131071, 128, "ed", "bfloat16"),
             ("cerc_bf16", 1024, 3500, 256, "de", "bfloat16"),
             ("split_max", 4096, 300, 256, "de", "float32"),
             ("lse_full_128k_d256", 4096, 131072, 256, "ed", "bfloat16"),
             ("ll_500k", 1024, 500_000, 256, "de", "bfloat16")]
    bit_equal = ("cerc", "split_max", "lse_full_128k")
    for i, (label, B, E, d, layout, dtype) in enumerate(cases):
        x = _xent_case(B, E, d, layout, 100 + i)
        iters = 3 if E > 100_000 else 10
        if dtype == "bfloat16":
            say("xent_kernels", case=label, route=src,
                plan=_wgmma_plan_text(B, E, d))
        else:
            per, slices = xent._dw_splits(B, E)
            chunk_tiles, chunks = xent._dp_chunks(B, E)
            # K5 and K6's dpooled sweep share the chunk plan.
            say("xent_kernels", case=label, route=src32, fwd_chunks=chunks,
                fwd_blocks=chunks * -(-B // 64), dw_slices=slices,
                dw_btiles_per_slice=per, dw_blocks=slices * -(-E // 64),
                dp_blocks=chunks * -(-B // 64),
                dp_tiles_per_block=chunk_tiles,
                dp_flush_tiles=xent.DP_MAX_TILES)
        k_ = _xent_outputs(xent.xent_loss, *x, layout, dtype, iters,
                           repeat=label in bit_equal)
        p_ = _xent_outputs(xent.xent_loss_plain, *x, layout, dtype, iters)
        with torch.no_grad():
            k_["lse"] = xent.xent_lse(*x[:3], layout, dtype)
            p_["lse"] = xent.xent_lse_plain(*x[:3], layout, dtype)
        errs = {}
        for key in ("loss", "lse", "dpooled", "dW", "db"):
            a, b = k_[key].float(), p_[key].float()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{label}: {key} not finite")
            errs[key] = err = (a - b).abs().max().item()
            rtol = XENT_SUM_RTOL if key in ("loss", "lse") else XENT_TOL[dtype]
            tol = rtol * b.abs().max().item()
            say("xent_kernels", case=label, B=B, E=E, d=d, layout=layout,
                dtype=dtype, output=key, max_abs_err=err,
                tol=f"{rtol}*max|plain|", bound=tol)
            if err > tol:
                raise AssertionError(f"{label}: {key} error {err} > {tol}")
        if dtype == "bfloat16":
            grads = ("dpooled", "dW", "db")
            _softmax_part(label, [k_[key] for key in grads],
                          [p_[key] for key in grads], x[3], layout)
        f_flops, f_bytes, f_exps, b_flops, b_bytes, b_exps = _xent_work(
            B, E, d, *x)
        # fp32 products run as 3xTF32 on the tensor cores; their bounds on
        # the CUDA cores are kept beside.
        fb = bound(f_flops, f_bytes, _product_type(dtype), exps=f_exps)
        fb_cores = bound(f_flops, f_bytes, dtype, exps=f_exps)["bound_ms"]
        bb = bound(b_flops, b_bytes, _product_type(dtype), exps=b_exps)
        bb_cores = bound(b_flops, b_bytes, dtype, exps=b_exps)["bound_ms"]
        product = (_product_ms(x[0], x[1], layout, iters)
                   if dtype == "bfloat16" else None)
        say("xent_kernels", case=label, fwd_ms=k_["fwd_ms"],
            fwd_plain_ms=p_["fwd_ms"], fwd_bound_ms=fb["bound_ms"],
            fwd_bound_cuda_cores_ms=fb_cores, bwd_ms=k_["bwd_ms"],
            bwd_plain_ms=p_["bwd_ms"], bwd_bound_ms=bb["bound_ms"],
            bwd_bound_cuda_cores_ms=bb_cores, bound_by=fb["bound_by"],
            product_ms=product)
        fwd, bwd = records["xent_fwd"], records["xent_bwd"]
        fwd["max_abs_err"] = max(fwd["max_abs_err"], errs["loss"],
                                 errs["lse"])
        bwd["max_abs_err"] = max(bwd["max_abs_err"], errs["dpooled"],
                                 errs["dW"], errs["db"])
        if label == "lse_full_128k":
            fwd.update(ms=k_["fwd_ms"], plain_ms=p_["fwd_ms"], **fb,
                       bound_cuda_cores_ms=fb_cores, product_ms=product)
            bwd.update(ms=k_["bwd_ms"], plain_ms=p_["bwd_ms"], **bb,
                       bound_cuda_cores_ms=bb_cores, product_ms=product)
        elif label == "cerc":
            fwd.update(fp32_ms=k_["fwd_ms"], fp32_plain_ms=p_["fwd_ms"],
                       fp32_bound_ms=fb["bound_ms"])
            bwd.update(fp32_ms=k_["bwd_ms"], fp32_plain_ms=p_["bwd_ms"],
                       fp32_bound_ms=bb["bound_ms"])
        del k_, p_, x
        torch.cuda.empty_cache()

    # K6 fed an lse from outside with a third of the labels -1 (a shard's
    # rows whose gold entity another shard holds) on a ragged B and the
    # entity tail, in bf16, each layout.
    B, E, d = 1000, 131071, 128
    for j, layout in enumerate(("ed", "de")):
        pooled, W, b, labels = _xent_case(B, E, d, layout, 250 + j)
        lse = xent.xent_lse_plain(pooled, W, b, layout, "bfloat16") + 0.7
        labels = torch.where(torch.arange(B, device="cuda") % 3 == 0,
                             torch.full_like(labels, -1), labels)
        got = xent.xent_bwd(pooled, W, b, lse, labels, layout, "bfloat16")
        want = xent.xent_bwd_plain(pooled, W, b, lse, labels, layout,
                                   "bfloat16")
        for name, a, w in zip(("dpooled", "dW", "db"), got, want):
            err = (a - w).abs().max().item()
            tol = XENT_TOL["bfloat16"] * w.abs().max().item()
            say("xent_kernels", case="ragged_offshard", B=B, E=E, d=d,
                layout=layout, dtype="bfloat16", labels_minus_one=int(
                    (labels < 0).sum()), output=name, max_abs_err=err,
                tol=f"{XENT_TOL['bfloat16']}*max|plain|", bound=tol)
            if not bool(torch.isfinite(a).all()) or err > tol:
                raise AssertionError(f"ragged_offshard {layout}: {name} "
                                     f"error {err} > {tol}")
            records["xent_bwd"]["max_abs_err"] = max(
                records["xent_bwd"]["max_abs_err"], err)
        _softmax_part(f"ragged_offshard_{layout}", got, want, labels, layout)
        # The control: K6 fed lse + shift scales every exp(z - lse) by
        # e^-shift. XENT_TOL's measure (xent_tol_rel) passes the small
        # shifts; XENT_SOFTMAX_TOL must fail each.
        for shift in (30.0, 0.05, 0.01):
            bad = xent.xent_bwd(pooled, W, b, lse + shift, labels, layout,
                                "bfloat16")
            rel = {name: err / scale for name, (err, scale) in
                   _softmax_errs(bad, want, labels, layout).items()}
            whole = max((a - w).abs().max().item() / w.abs().max().item()
                        for a, w in zip(bad, want))
            say("xent_kernels", case=f"control_lse_plus_{shift}",
                layout=layout, softmax_part_rel=json.dumps(rel).replace(
                    " ", ""), xent_tol_rel=whole,
                fails_softmax_tol=min(rel.values()) > XENT_SOFTMAX_TOL)
            if min(rel.values()) <= XENT_SOFTMAX_TOL:
                raise AssertionError(f"XENT_SOFTMAX_TOL passes K6 fed lse + "
                                     f"{shift}: {rel}")
            del bad
        del got, want, pooled, W
        torch.cuda.empty_cache()

    # K5 alone at the normalizer's shape: 64 queries x 16 terms, fp32.
    pooled, W, b, _ = _xent_case(64 * 16, 3500, 256, "de", 200)
    got = xent.xent_lse(pooled, W, b, "de", "float32")
    want = xent.xent_lse_plain(pooled, W, b, "de", "float32")
    err = (got - want).abs().max().item()
    tol = XENT_SUM_RTOL * want.abs().max().item()
    chunks = xent._dp_chunks(64 * 16, 3500)[1]
    say("xent_kernels", case="normalizer", rows=64 * 16, E=3500, d=256,
        fwd_chunks=chunks, fwd_blocks=chunks * 16, max_abs_err=err, tol=tol,
        ms=cuda_ms(lambda: xent.xent_lse(pooled, W, b, "de", "float32")),
        plain_ms=cuda_ms(lambda: xent.xent_lse_plain(pooled, W, b, "de",
                                                     "float32")))
    if err > tol:
        raise AssertionError(f"normalizer lse error {err} > {tol}")
    records["xent_fwd"]["max_abs_err"] = max(
        records["xent_fwd"]["max_abs_err"], err)

    # K5/K6 at lse_full's flagship shape; the plain versions in chunks of
    # entities (the whole [B, E] fp32 logits would be 16 GB): the lse, then
    # K6 fed that lse (xent_bwd) against xent_bwd_plain chunk by chunk.
    B, E, d = B_TRAIN, 1_000_000, D
    pooled, W, b, labels = _xent_case(B, E, d, "ed", 300)
    got = xent.xent_lse(pooled, W, b, "ed", "bfloat16")
    step = 1 << 16

    def plain_lse():
        out = torch.full((B,), -float("inf"), device="cuda")
        for lo in range(0, E, step):
            z = xent._logits_plain(pooled, W[lo:lo + step], b[lo:lo + step],
                                   "ed", torch.bfloat16)
            out = torch.logaddexp(out, torch.logsumexp(z, dim=-1))
        return out

    with torch.no_grad():
        want = plain_lse()
        err = (got - want).abs().max().item()
        tol = XENT_SUM_RTOL * want.abs().max().item()
        fwd_ms = cuda_ms(lambda: xent.xent_loss(pooled, W, b, labels, "ed",
                                                "bfloat16"), iters=3)
        plain_ms = cuda_ms(plain_lse, iters=3, warmup=1)
    if err > tol:
        raise AssertionError(f"flagship lse error {err} > {tol}")
    records["xent_fwd"]["max_abs_err"] = max(
        records["xent_fwd"]["max_abs_err"], err)
    dpooled, dW, db = xent.xent_bwd(pooled, W, b, want, labels, "ed",
                                    "bfloat16")
    errs = {"dpooled": 0.0, "dW": 0.0, "db": 0.0}
    scale = dict(errs)
    soft = {"dW": [0.0, 0.0], "db": [0.0, 0.0]}   # softmax part: err, max
    free = _unnamed(labels, E)
    want_dp = torch.zeros_like(dpooled)
    for lo in range(0, E, step):
        hi = min(E, lo + step)
        loc = labels - lo
        lab = torch.where((loc >= 0) & (loc < hi - lo), loc,
                          torch.full_like(loc, -1))
        p_dp, p_dw, p_db = xent.xent_bwd_plain(pooled, W[lo:hi], b[lo:hi],
                                               want, lab, "ed", "bfloat16")
        want_dp += p_dp
        for name, a, w in (("dW", dW[lo:hi], p_dw), ("db", db[lo:hi], p_db)):
            errs[name] = max(errs[name], (a - w).abs().max().item())
            scale[name] = max(scale[name], w.abs().max().item())
            e_s, m_s = _masked_err(a, w, free[lo:hi])
            soft[name] = [max(soft[name][0], e_s), max(soft[name][1], m_s)]
        del p_dp, p_dw, p_db
    for name, (err_s, max_s) in soft.items():
        say("xent_kernels", case="lse_full_flagship", output=name,
            part="softmax", max_abs_err=err_s, max_plain=max_s,
            rel=err_s / max_s, tol=XENT_SOFTMAX_TOL)
        if not err_s <= XENT_SOFTMAX_TOL * max_s:
            raise AssertionError(f"flagship {name}'s softmax part error "
                                 f"{err_s} > {XENT_SOFTMAX_TOL} * {max_s}")
    errs["dpooled"] = (dpooled - want_dp).abs().max().item()
    scale["dpooled"] = want_dp.abs().max().item()
    for name in errs:
        tol6 = XENT_TOL["bfloat16"] * scale[name]
        say("xent_kernels", case="lse_full_flagship", output=name,
            max_abs_err=errs[name], tol=f"{XENT_TOL['bfloat16']}*max|plain|",
            bound=tol6)
        if not math.isfinite(errs[name]) or errs[name] > tol6:
            raise AssertionError(f"flagship {name} error {errs[name]} > "
                                 f"{tol6}")
    records["xent_bwd"]["max_abs_err"] = max(
        records["xent_bwd"]["max_abs_err"], *errs.values())
    del dpooled, dW, db, want_dp
    p, w = pooled.clone().requires_grad_(True), W.clone().requires_grad_(True)
    mean = xent.xent_loss(p, w, b, labels, "ed", "bfloat16") / B
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(mean, [p, w],
                                                 retain_graph=True),
                     iters=3, warmup=1)
    f_flops, f_bytes, f_exps, b_flops, b_bytes, b_exps = _xent_work(
        B, E, d, pooled, W, b, labels)
    say("xent_kernels", case="lse_full_flagship", B=B, E=E, d=d,
        layout="ed", dtype="bfloat16", plan=_wgmma_plan_text(B, E, d),
        lse_max_abs_err=err, tol=tol, fwd_ms=fwd_ms,
        fwd_plain_chunked_ms=plain_ms,
        fwd_bound_ms=bound(f_flops, f_bytes, "bfloat16",
                           exps=f_exps)["bound_ms"],
        bwd_ms=bwd_ms,
        bwd_bound_ms=bound(b_flops, b_bytes, "bfloat16",
                           exps=b_exps)["bound_ms"],
        product_ms=_product_ms(pooled, W, "ed", 3))
    del p, w, mean, pooled, W, b, labels
    torch.cuda.empty_cache()
    return records


def _apply_case(B, E, d, layout, opt, seed, w_dtype):
    """K5/K6's seeded inputs plus seeded non-zero optimizer slots (m ~
    N(0, 1e-3); v and acc in 1e-5 * (0.5 + |N(0, 1)|), the size of g^2),
    W and the slots in ``w_dtype`` storage."""
    import torch
    from sert_tpu_torch.ops import xent
    pooled, W, b, labels = _xent_case(B, E, d, layout, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    slots = {}
    for name in xent.SLOTS[opt]:
        x = torch.randn(W.shape, generator=g, device="cuda")
        slots[name] = (1e-3 * x if name == "m"
                       else 1e-5 * (0.5 + x.abs())).to(w_dtype)
    return pooled, W.to(w_dtype), b, labels, slots


def _product_type(dtype: str) -> str:
    """The peak-rate type of K5-K7's products: fp32 runs as 3xTF32."""
    return "tf32x3" if dtype == "float32" else dtype


def _apply_outputs(fn, x, opt, layout, dtype):
    """One call of ``fn`` (xent_loss_apply or its plain version) on copies
    of W and the slots: the loss, gsq, db, dpooled, W' and the slots'."""
    pooled, W, b, labels, slots = x
    W, slots = W.clone(), {k: v.clone() for k, v in slots.items()}
    out = fn(pooled, W, b, labels, opt=opt, opt_tree=slots, lr=APPLY_LR,
             count=3, gscale=1.0 / pooled.shape[0], layout=layout,
             dtype=dtype)
    return {"loss": out[0], "gsq": out[5], "db": out[3], "dpooled": out[4],
            "W": W, **slots}


def _apply_times(x, opt, layout, dtype, iters):
    """CUDA-event ms of K7 alone (on K5's outputs, W and the slots updated
    in place on copies) and of the plain version's same work (autograd's
    backward of the plain loss, then the plain update)."""
    import torch
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.ops.sampled_lse import _compute_dtype
    pooled, W, b, labels, slots = x
    ct = _compute_dtype(dtype)
    W, slots = W.clone(), {k: v.clone() for k, v in slots.items()}
    kw = dict(opt=opt, lr=APPLY_LR, count=3, gscale=1.0 / pooled.shape[0])
    with torch.no_grad():
        _, saved, geometry = xent._loss_forward(pooled, W, b, labels, layout,
                                                ct)
        kslots = [slots[k] for k in xent.SLOTS[opt]]
        ms = cuda_ms(lambda: xent._bwd_apply(saved, geometry, kslots, ct=ct,
                                             **kw), iters=iters, warmup=1)
    del saved
    # The graph's own copies: the plain update below changes W in place.
    p, w, bb = (t.detach().float().clone().requires_grad_(True)
                for t in (pooled, W, b))
    loss = xent.xent_loss_plain(p, w, bb, labels, layout, dtype)

    def plain():
        dW = torch.autograd.grad(loss, [p, w, bb], retain_graph=True)[1]
        with torch.no_grad():
            xent._update_plain(W, kslots, dW, **kw)

    plain_ms = cuda_ms(plain, iters=iters, warmup=1)
    return ms, plain_ms


def _apply_errors(phase, label, opt, got, x, layout, dtype, shape) -> dict:
    """Each of K7's outputs ``got`` against xent_loss_apply_plain's on the
    same inputs ``x``: its largest error, printed with its tolerance
    (XENT_TOL of the output's scale; W' of the smaller of lr and its
    largest change from W, the latter plus one fp32 step of its value; a
    bf16 stored output one step of its value more); AssertionError
    beyond."""
    import torch
    from sert_tpu_torch.ops import xent
    want = _apply_outputs(xent.xent_loss_apply_plain, x, opt, layout, dtype)
    errs = {}
    for key, b in want.items():
        a, bf32 = got[key].float(), b.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} {opt}: {key} not finite")
        if key in ("loss", "gsq"):
            rtol, scale = XENT_SUM_RTOL, bf32.abs().max()
        elif key == "W":
            rtol, scale = XENT_TOL[dtype], APPLY_LR
        else:
            rtol, scale = XENT_TOL[dtype], bf32.abs().max()
        limit = rtol * scale
        if key == "W":
            # sgd's and adagrad's steps can move W by far less than lr.
            step = (bf32 - x[1].float()).abs().max()
            limit = torch.clamp(rtol * step + 2.0 ** -22 * bf32.abs(),
                                max=limit)
        if b.dtype == torch.bfloat16:
            # One step of the storage: at most 2^-7 of the value.
            limit = limit + 2.0 ** -7 * bf32.abs()
        diff = (a - bf32).abs()
        errs[key] = err = diff.max().item()
        extra = dict(max_change=step.item()) if key == "W" else {}
        say(phase, case=label, opt=opt, **shape, output=key, **extra,
            max_abs_err=err,
            tol=(f"min({rtol}*lr,{rtol}*max|W'-W|+2^-22*|plain|)"
                 if key == "W" else f"{rtol}*max|plain|")
                + ("+2^-7*|plain|" if b.dtype == torch.bfloat16 else ""))
        if not bool((diff <= limit).all()):
            raise AssertionError(f"{label} {opt}: {key} error {err}")
    return errs


def _apply_bound(x, dtype):
    """K7's bound on inputs ``x`` (its own three products, z, dW and
    dpooled; its dpooled sweep's recompute of z is not counted; P, W, the
    slots, the bias and the labels read once, W' and the slots written
    once, db, dpooled and the per-tile gsq written once), and the same on
    the CUDA cores."""
    pooled, W, b, labels, slots = x
    B, d = pooled.shape
    E = b.shape[0]
    flops = 6 * B * E * d
    moved = (nbytes(pooled, W, b, labels, *slots.values())
             + nbytes(W, *slots.values()) + 4 * (E + B * d - (-E // 64)))
    return (bound(flops, moved, _product_type(dtype)),
            bound(flops, moved, dtype)["bound_ms"])


def _k7_is_k6_dw(x, layout) -> bool:
    """One dW: whether K7's sgd update of W (bf16 compute) on inputs ``x``
    is W - lr (K6's dW at g = gscale), in _update_plain's order, bit for
    bit."""
    import torch
    from sert_tpu_torch.ops import xent
    pooled, W, b, labels, _ = x
    gscale = 1.0 / pooled.shape[0]
    with torch.no_grad():
        _, saved, geometry = xent._loss_forward(pooled, W, b, labels,
                                                layout, torch.bfloat16)
        g = torch.full((1,), gscale, device=W.device)
        dW = xent._bwd(saved, geometry, g, torch.bfloat16)[1]
        del saved
        want = W.clone()
        xent._update_plain(want, [], dW, "sgd", APPLY_LR, 0, 1.0)
        del dW
    got = _apply_outputs(xent.xent_loss_apply, x, "sgd", layout,
                         "bfloat16")["W"]
    return bool(torch.equal(got, want))


def phase_xent_apply_kernels() -> dict:
    """K7 against xent_loss_apply_plain on the same inputs, for each
    optimizer. Returns the kernel record of the w3c adam case (the fused
    training path's variant), with errors maxed over every case."""
    import torch
    from sert_tpu_torch.ops import xent
    rec = dict(name="xent_bwd_apply", route="cuda",
               source="sert_tpu_torch/csrc/xent.cu",
               bf16_source="sert_tpu_torch/csrc/xent_wgmma.cu",
               replaces="sert_tpu/ops/xent.py:468", launches=0,
               max_abs_err=0.0, library_ms=None)
    f32, bf = torch.float32, torch.bfloat16
    cases = [("w3c", 1024, 1100, 128, "de", "float32", f32),
             ("w3c_ragged", 1000, 1100, 128, "de", "float32", f32),
             ("cerc", 1024, 3500, 256, "de", "float32", f32),
             ("cerc_bf16", 1024, 3500, 256, "de", "bfloat16", f32),
             ("ll_500k", 1024, 500_000, 256, "de", "bfloat16", f32),
             ("lse_full_128k", 4096, 131072, 128, "ed", "bfloat16", f32),
             ("lse_full_tail", 4096, 131071, 128, "ed", "bfloat16", f32)]
    # Two calls bit for bit: the update in the sum of the slices (w3c 8,
    # cerc 4, cerc_bf16 4) and in the sweep's epilogue (one slice: ll_500k,
    # and a one-entity tail).
    bit_equal = ("w3c", "cerc", "cerc_bf16", "ll_500k", "lse_full_tail")
    runs = [(c, opt) for c in cases for opt in xent.OPTIMIZERS]
    runs.append((("bf16_storage", 4096, 131072, 128, "ed", "bfloat16", bf),
                 "adam"))
    for i, ((label, B, E, d, layout, dtype, w_dtype), opt) in enumerate(runs):
        x = _apply_case(B, E, d, layout, opt, 400 + i, w_dtype)
        if dtype == "bfloat16":          # the wgmma sweep's plans
            fwd, dw = xent._wgmma_plan(B, E, d)
            say("xent_apply_kernels", case=label, opt=opt,
                dw_slices=dw.parts, dw_btiles_per_slice=dw.per,
                dw_blocks=dw.blocks, dp_blocks=fwd.blocks)
        else:
            per, slices = xent._dw_splits(B, E)
            say("xent_apply_kernels", case=label, opt=opt, dw_slices=slices,
                dw_btiles_per_slice=per, dw_blocks=slices * -(-E // 64),
                dp_blocks=xent._dp_chunks(B, E)[1] * -(-B // 64))
        got = _apply_outputs(xent.xent_loss_apply, x, opt, layout, dtype)
        if label in bit_equal:
            again = _apply_outputs(xent.xent_loss_apply, x, opt, layout,
                                   dtype)
            same = all(torch.equal(got[k], again[k]) for k in got)
            say("xent_apply_kernels", case=label, opt=opt,
                apply_twice_bit_equal=same, outputs=",".join(sorted(got)))
            if not same:
                raise AssertionError(f"{label} {opt}: two K7 calls differ")
            del again
        errs = _apply_errors("xent_apply_kernels", label, opt, got, x,
                             layout, dtype, dict(B=B, E=E, d=d,
                                                 layout=layout, dtype=dtype,
                                                 storage=str(w_dtype)[6:]))
        del got
        if dtype == "bfloat16" and opt == "sgd":
            same = _k7_is_k6_dw(x, layout)
            say("xent_apply_kernels", case=label, opt=opt,
                k7_update_is_w_minus_lr_k6_dw_bit_for_bit=same)
            if not same:
                raise AssertionError(f"{label}: K7's sgd update is not "
                                     f"W - lr (K6's dW)")
        iters = 3 if E > 100_000 else 10
        ms, plain_ms = _apply_times(x, opt, layout, dtype, iters)
        bnd, cores = _apply_bound(x, dtype)
        say("xent_apply_kernels", case=label, opt=opt, ms=ms,
            plain_ms=plain_ms, **bnd, bound_cuda_cores_ms=cores)
        rec["max_abs_err"] = max(rec["max_abs_err"], *errs.values())
        if i == 0:
            rec.update(ms=ms, plain_ms=plain_ms, **bnd,
                       bound_cuda_cores_ms=cores)
        del x
        torch.cuda.empty_cache()
    return {"xent_bwd_apply": rec}


def _train_log(run_dir: str):
    """(logged train steps, losses, mid-run steps/s) of a run's JSONL log;
    the first logged interval of each epoch holds its warm-up."""
    logs = [json.loads(line) for line in
            open(os.path.join(run_dir, "train_log.jsonl"))]
    steps = [r for r in logs if r["event"] == "train_step"]
    first = {min(r["step"] for r in steps if r["epoch"] == e)
             for e in {r["epoch"] for r in steps}}
    return (steps, [r["loss"] for r in steps],
            [r["steps_per_sec"] for r in steps if r["step"] not in first])


def _spread(xs) -> str:
    """min / median / max of a list of rates, and how many there are."""
    xs = sorted(xs)
    return (f"{xs[0]:.2f}/{xs[len(xs) // 2]:.2f}/{xs[-1]:.2f}(n={len(xs)})"
            if xs else "none")


def _check_falling(losses) -> None:
    if len(losses) < 2 or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss is not finite and falling: {losses}")


def _run_loglinear_e2e(phase, recipe, col, root):
    """``recipe`` end to end on the card through pipeline.run_end_to_end,
    its launches counted from 0; the loss must be finite and fall, and the
    served top 100 must match the dense oracle. Returns (launches by
    kernel, micro-steps, query batches, the resolved model config)."""
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.data.instances import InstanceDataset
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.train import checkpoint as ckpt

    work = os.path.join(root, recipe.name)
    data_dir, run_dir = os.path.join(work, "data"), os.path.join(work, "run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    xent.fwd_launches = xent.bwd_launches = xent.apply_launches = 0
    k3.launches = k4.launches = 0
    results = pipeline.run_end_to_end(col, recipe, work, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches,
                "xent_bwd_apply": xent.apply_launches,
                "score_binmax": k3.launches, "gather_rescore": k4.launches}
    peak = torch.cuda.max_memory_allocated()
    steps, losses, mid_sps = _train_log(run_dir)
    n_steps = max(ckpt.list_checkpoints(os.path.join(run_dir,
                                                     "checkpoints")))
    meta = InstanceDataset(data_dir).meta
    say(phase, e2e_s=t2 - t1, instances=meta["num_instances"],
        vocab=meta["vocab_size"], entities=meta["num_entities"],
        steps=n_steps, first_loss=losses[0], last_loss=losses[-1],
        mid_run_steps_per_sec=_spread(mid_sps),
        ndcg_at_100=results["all"]["ndcg@100"],
        recall_at_100=results["all"]["recall@100"], peak_mem_bytes=peak,
        launches=json.dumps(launches).replace(" ", ""))
    _check_falling(losses)
    _check_served_loglinear(phase, recipe, col, data_dir, run_dir)
    n_batches = -(-len(col.topics) // recipe.score.query_batch)
    cfg = pipeline.resolve_model_config(recipe, meta).model
    return launches, n_steps, n_batches, cfg


def phase_train_loglinear(root: str) -> dict:
    """cerc_expert_finding end to end on the card; returns the launches by
    kernel of that run."""
    import dataclasses
    import torch
    from sert_tpu_torch import recipes
    from sert_tpu_torch.cli import load_recipe

    recipe = load_recipe("cerc_expert_finding")
    t0 = time.perf_counter()
    col = recipes.CERC_SYNTH.build()
    say("train_loglinear", build_collection_s=time.perf_counter() - t0)
    launches, n_steps, n_batches, cfg = _run_loglinear_e2e(
        "train_loglinear", recipe, col, root)
    if launches["xent_bwd"] != n_steps or launches["xent_bwd_apply"] or \
            launches["xent_fwd"] != n_steps + n_batches or \
            min(launches["score_binmax"], launches["gather_rescore"]) < 1:
        raise AssertionError(f"launches {launches} for {n_steps} steps and "
                             f"{n_batches} query batches")

    # The first steps through K5/K6 against the plain version on the card,
    # on the same batches from the same initial state.
    runs = _first_steps(recipe, os.path.join(root, recipe.name, "data"), [
        (fused, dataclasses.replace(cfg, fused_softmax=fused), None)
        for fused in ("auto", "off")])
    losses = {k: v[0] for k, v in runs.items()}
    counts = {k: v[2] for k, v in runs.items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["auto"],
                                                  losses["off"]))
    say("train_loglinear", parity_steps=PARITY_STEPS,
        fused_losses=json.dumps(losses["auto"]),
        plain_losses=json.dumps(losses["off"]), max_rel_diff=rel,
        rtol=PARITY_RTOL, launches=json.dumps(counts).replace(" ", ""))
    if rel > PARITY_RTOL or counts != {"auto": (PARITY_STEPS,) * 2 + (0,),
                                       "off": (0, 0, 0)}:
        raise AssertionError(f"fused and plain steps differ by {rel}, or "
                             f"took the wrong paths: {counts}")
    torch.cuda.empty_cache()
    return launches


def phase_train_fused(root: str) -> dict:
    """w3c_expert_finding end to end with fused_update="on" (K5 + K7 every
    micro-step), its first steps against the dense step, two fused runs
    bit for bit; returns the launches by kernel of the end-to-end run."""
    import dataclasses
    import torch
    from sert_tpu_torch import recipes
    from sert_tpu_torch.cli import load_recipe

    r = load_recipe("w3c_expert_finding")
    recipe = dataclasses.replace(r, train=dataclasses.replace(
        r.train, fused_update="on"))
    t0 = time.perf_counter()
    col = recipes.W3C_SYNTH.build()
    say("train_fused", build_collection_s=time.perf_counter() - t0)
    launches, n_steps, n_batches, cfg = _run_loglinear_e2e(
        "train_fused", recipe, col, root)
    if launches["xent_bwd_apply"] != n_steps or launches["xent_bwd"] or \
            launches["xent_fwd"] != n_steps + n_batches or \
            min(launches["score_binmax"], launches["gather_rescore"]) < 1:
        raise AssertionError(f"launches {launches} for {n_steps} steps and "
                             f"{n_batches} query batches")

    # The first steps through K5 + K7 against the dense step (K5/K6 and the
    # dense adam) on the same batches, and a second fused run.
    dense = dataclasses.replace(recipe.train, fused_update="off")
    runs = _first_steps(recipe, os.path.join(root, recipe.name, "data"), [
        ("fused", cfg, None), ("dense", cfg, dense), ("fused_again", cfg,
                                                      None)])
    losses = {k: v[0] for k, v in runs.items()}
    counts = {k: v[2] for k, v in runs.items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["fused"],
                                                  losses["dense"]))
    same = all(torch.equal(runs["fused"][1][k], runs["fused_again"][1][k])
               for k in runs["fused"][1])
    say("train_fused", parity_steps=PARITY_STEPS,
        fused_losses=json.dumps(losses["fused"]),
        dense_losses=json.dumps(losses["dense"]), max_rel_diff=rel,
        rtol=FUSED_PARITY_RTOL, fused_runs_bit_equal=same,
        launches=json.dumps(counts).replace(" ", ""))
    want = {"fused": (PARITY_STEPS, 0, PARITY_STEPS),
            "dense": (PARITY_STEPS, PARITY_STEPS, 0),
            "fused_again": (PARITY_STEPS, 0, PARITY_STEPS)}
    if rel > FUSED_PARITY_RTOL or not same or counts != want:
        raise AssertionError(f"fused and dense steps differ by {rel}, two "
                             f"fused runs equal: {same}, or the steps took "
                             f"the wrong paths: {counts}")
    del runs
    torch.cuda.empty_cache()
    return launches


def phase_fused_ab() -> dict:
    """The reference's fused-step A/B at its width (benchmarks/
    fused_step_bench.py: log-linear, E=500k, V=60k, d=256, B=1024, bf16
    compute, fp32 params, lr 1e-2, steps_per_call=8): for adam, adagrad and
    sgd, fused_update off and on in turns (off, on, on, off), each from the
    same seeded state on the same seeded batches, a warm call then AB_CALLS
    timed calls; ms per micro-step, peak memory, and the last losses of
    the two modes against each other. Then adafactor (the reference's gate
    keeps it off K7) the same way with fused_update off, twice: K5 and K6
    every micro-step, K7 never, ms per micro-step and peak memory beside
    the other rows. Returns adafactor's launches by kernel."""
    import dataclasses
    import torch
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.train.step import init_state, make_train_step

    mcfg, train, w = _ab_configs()
    B, n = train.batch_size, AB_STEPS_PER_CALL
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lengths = torch.randint(1, w + 1, (n, B), generator=g, device="cuda")
    windows = torch.randint(0, AB_V, (n, B, w), generator=g, device="cuda")
    batch = {"windows": (windows * (torch.arange(w, device="cuda")
                                    < lengths[..., None])).int(),
             "lengths": lengths.int(),
             "entities": torch.randint(0, AB_E, (n, B), generator=g,
                                       device="cuda").int()}
    for opt in ("adam", "adagrad", "sgd"):
        got = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            tcfg = dataclasses.replace(train, optimizer=opt,
                                       fused_update=mode, steps_per_call=n)
            state = init_state(SEED, mcfg, tcfg, device="cuda")
            step = make_train_step(mcfg, tcfg, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            xent.apply_launches = xent.bwd_launches = 0
            xent.apply_wgmma_launches = 0
            step(state, batch)                              # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(AB_CALLS):
                _, m = step(state, batch)
            loss = m["loss"].item()                         # syncs
            ms = (time.perf_counter() - t0) * 1e3 / (AB_CALLS * n)
            want = (AB_CALLS + 1) * n
            used = {"on": (want, 0), "off": (0, want)}[mode]
            # bf16 compute: every K7 on the wgmma sweep.
            if ((xent.apply_launches, xent.bwd_launches) != used
                    or xent.apply_wgmma_launches != used[0]):
                raise AssertionError(
                    f"{opt} {mode}: K7/K6 launched {xent.apply_launches}/"
                    f"{xent.bwd_launches} times ({xent.apply_wgmma_launches}"
                    f" K7 on the wgmma sweep), not {used}")
            if not math.isfinite(loss):
                raise AssertionError(f"{opt} {mode}: loss {loss}")
            got[mode].append((ms, torch.cuda.max_memory_allocated(), loss))
            del state, step, m
            torch.cuda.empty_cache()
        off_loss, on_loss = got["off"][0][2], got["on"][0][2]
        rel = abs(on_loss - off_loss) / abs(off_loss)
        off = sum(t for t, _, _ in got["off"]) / 2
        on = sum(t for t, _, _ in got["on"]) / 2
        say("fused_ab", opt=opt, E=AB_E, V=AB_V, d=AB_D, B=B,
            steps_per_call=n, timed_steps=AB_CALLS * n,
            off_ms_per_step=json.dumps([t for t, _, _ in got["off"]]),
            on_ms_per_step=json.dumps([t for t, _, _ in got["on"]]),
            off_over_on=off / on,
            off_peak_mem_bytes=max(p for _, p, _ in got["off"]),
            on_peak_mem_bytes=max(p for _, p, _ in got["on"]),
            off_loss=off_loss, on_loss=on_loss, loss_rel_diff=rel,
            rtol=FUSED_PARITY_RTOL)
        if rel > FUSED_PARITY_RTOL:
            raise AssertionError(f"{opt}: fused and dense losses differ by "
                                 f"{rel}")

    got, launches = [], {"xent_fwd": 0, "xent_bwd": 0, "xent_bwd_apply": 0}
    for _ in range(2):
        tcfg = dataclasses.replace(train, optimizer="adafactor",
                                   fused_update="off", steps_per_call=n)
        state = init_state(SEED, mcfg, tcfg, device="cuda")
        step = make_train_step(mcfg, tcfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        xent.fwd_launches = xent.apply_launches = xent.bwd_launches = 0
        step(state, batch)                                  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AB_CALLS):
            _, m = step(state, batch)
        loss = m["loss"].item()                             # syncs
        ms = (time.perf_counter() - t0) * 1e3 / (AB_CALLS * n)
        want = (AB_CALLS + 1) * n
        used = (xent.fwd_launches, xent.bwd_launches, xent.apply_launches)
        if used != (want, want, 0):
            raise AssertionError(f"adafactor: K5/K6/K7 launched {used} "
                                 f"times, not {(want, want, 0)}")
        if not math.isfinite(loss):
            raise AssertionError(f"adafactor: loss {loss}")
        for name, k in zip(("xent_fwd", "xent_bwd", "xent_bwd_apply"), used):
            launches[name] += k
        got.append((ms, torch.cuda.max_memory_allocated(), loss))
        del state, step, m
        torch.cuda.empty_cache()
    say("adafactor_ab", opt="adafactor", E=AB_E, V=AB_V, d=AB_D, B=B,
        steps_per_call=n, timed_steps=AB_CALLS * n, fused_update="off",
        ms_per_step=json.dumps([t for t, _, _ in got]),
        peak_mem_bytes=max(p for _, p, _ in got), loss=got[0][2],
        launches=json.dumps(launches).replace(" ", ""))
    return launches


def _check_served_loglinear(phase, recipe, col, data_dir, run_dir) -> None:
    """The served top 100 of a trained log-linear run against the exact
    dense log-probs of its params (launches here are checks, not the
    path)."""
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.data.instances import InstanceDataset
    from sert_tpu_torch.data.prepare import VOCAB_NAME, encode_queries
    from sert_tpu_torch.data.vocab import Vocabulary
    from sert_tpu_torch.scoring import scorer
    from sert_tpu_torch.scoring.run import pad_queries, stage_entities
    meta = InstanceDataset(data_dir).meta
    resolved = pipeline.resolve_model_config(recipe, meta)
    cfg = resolved.model
    params, vocab, _ = pipeline.load_scorer(run_dir, data_dir, resolved,
                                            device="cuda")
    encoded = encode_queries(col.topics, Vocabulary.load(
        os.path.join(data_dir, VOCAB_NAME)), resolved.data)
    _, term_ids, num_terms = pad_queries(encoded)
    t = torch.from_numpy(term_ids).cuda()
    m = torch.from_numpy(num_terms).cuda()
    k = min(100, cfg.num_entities)
    with torch.no_grad():
        dense = scorer.dense_scores(params, cfg, t, m)
        top_s, top_i = scorer.pallas_topk(
            params, cfg, t, m, k=k, prep=stage_entities(params, cfg,
                                                        resolved.score))
    live = (m > 0).nonzero()[:, 0]
    oracle = torch.topk(dense, k, dim=1).indices
    recall = min(len(set(top_i[q].tolist()) & set(oracle[q].tolist())) / k
                 for q in live.tolist())
    # Relative to the larger of the score and its un-normalized sum: a
    # log-prob near 0 is the difference of that sum and a normalizer of the
    # same size (tens to hundreds once trained), so fp32 leaves it an
    # absolute error of that size's last bits. Held to LL_SCORE_RTOL of
    # that scale (on the H100: 7.5e-7 measured; relative to the score
    # alone the same run read 1.068e-4).
    want = torch.gather(dense, 1, top_i)[live]
    R = scorer._query_reps_and_terms(params, cfg, t, m, "dot")[0]
    raw = (R.float() @ scorer._entity_matrix(params, cfg, "dot").T
           + m.float()[:, None] * params["proj_b"].float())
    scale = torch.maximum(want.abs(), torch.gather(raw, 1, top_i)[live].abs())
    rel = ((top_s[live] - want).abs() / scale).max().item()
    say(phase, served_queries=len(live), min_recall_at_100=recall,
        max_score_rel_err=rel)
    if recall < LL_RECALL_MIN or rel > LL_SCORE_RTOL:
        raise AssertionError(f"served top 100: recall {recall}, score "
                             f"error {rel}")
    del params, dense, raw
    torch.cuda.empty_cache()


def _epoch0_batches(recipe, data_dir, n):
    """(the first ``n`` batches of epoch 0 on the card, the run's micro-step
    horizon for the lr schedule)."""
    import torch
    from sert_tpu_torch.data.instances import InstanceDataset
    ds = InstanceDataset(data_dir, seed=recipe.train.seed)
    horizon = recipe.train.num_epochs * ds.num_batches_per_epoch(
        recipe.train.batch_size)
    batches = []
    for batch, _ in ds.iter_batches(recipe.train.batch_size, epoch=0):
        batches.append({k: torch.from_numpy(v).cuda()
                        for k, v in batch.items()})
        if len(batches) == n:
            break
    return batches, horizon


def _first_steps(recipe, data_dir, variants) -> dict:
    """The first PARITY_STEPS micro-steps of epoch 0's batches, one at a
    time, from the recipe's initial state on the card, for each (name,
    model config, train config or None for the recipe's) of ``variants``:
    {name: (losses, final params, launches of (K5, K6, K7))}."""
    import dataclasses
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.train.step import init_state, make_train_step
    batches, horizon = _epoch0_batches(recipe, data_dir, PARITY_STEPS)
    out = {}
    for name, mcfg, tcfg in variants:
        tcfg = dataclasses.replace(tcfg or recipe.train, steps_per_call=1,
                                   lr_decay_steps=horizon)
        state = init_state(tcfg.seed, mcfg, tcfg, device="cuda")
        step = make_train_step(mcfg, tcfg, device="cuda")
        xent.fwd_launches = xent.bwd_launches = xent.apply_launches = 0
        losses = [step(state, b)[1]["loss"].item() for b in batches]
        out[name] = (losses, state.params, (xent.fwd_launches,
                                            xent.bwd_launches,
                                            xent.apply_launches))
        del state
    return out


def phase_train_lse_full(root: str) -> dict:
    """The flagship's width with the full softmax (lse_full) for a few
    steps; returns the launches by kernel of that run."""
    import dataclasses
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.fixture import write_training_fixture
    from sert_tpu_torch.ops import xent

    r = load_recipe(RECIPE)
    recipe = dataclasses.replace(
        r, name="lse_full_1m",
        model=dataclasses.replace(r.model, model="lse_full"),
        train=dataclasses.replace(r.train, num_epochs=1, log_every_steps=4,
                                  final_snapshot="params"))
    t0 = time.perf_counter()
    data_dir, _, _ = write_training_fixture(
        os.path.join(root, "full"), recipe, V, E, LSE_FULL_STEPS * B_TRAIN,
        seed=SEED)
    run_dir = os.path.join(root, "full", "run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    xent.fwd_launches = xent.bwd_launches = xent.apply_launches = 0
    xent.fwd_wgmma_launches = xent.bwd_wgmma_launches = 0
    state, _ = pipeline.train_from_dir(recipe, data_dir, run_dir,
                                       resume=False, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches,
                "xent_bwd_apply": xent.apply_launches}
    # bf16 compute: every K5 and K6 launch took the wgmma sweep
    # (csrc/xent_wgmma.cu).
    wgmma = (xent.fwd_wgmma_launches, xent.bwd_wgmma_launches)
    steps, losses, mid_sps = _train_log(run_dir)
    say("train_lse_full", fixture_s=t1 - t0, train_s=t2 - t1,
        steps=state.step, losses=json.dumps(losses),
        mid_run_steps_per_sec=json.dumps(mid_sps),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(launches).replace(" ", ""),
        compute_dtype=recipe.model.compute_dtype,
        wgmma_route_launches=f"{wgmma[0]},{wgmma[1]}")
    if state.step != LSE_FULL_STEPS:
        raise AssertionError(f"{state.step} steps, not {LSE_FULL_STEPS}")
    _check_falling(losses)
    if launches != {"xent_fwd": state.step, "xent_bwd": state.step,
                    "xent_bwd_apply": 0}:
        raise AssertionError(f"K5/K6/K7 launched {launches} times for "
                             f"{state.step} steps")
    if recipe.model.compute_dtype != "bfloat16" or wgmma != (state.step,
                                                              state.step):
        raise AssertionError(f"K5/K6 took the wgmma sweep {wgmma} times "
                             f"of {state.step} steps")
    del state
    torch.cuda.empty_cache()
    return launches


def _unigram_noise(recipe, data_dir):
    """The unigram noise logits of a data dir's associations, on the card,
    as pipeline.train_from_dir builds them."""
    import numpy as np
    from sert_tpu_torch.data.assoc import Associations
    from sert_tpu_torch.data.prepare import ASSOC_NAME
    from sert_tpu_torch.models import lse
    counts = Associations.load(os.path.join(
        data_dir, ASSOC_NAME)).entity_instance_counts(
            recipe.model.num_entities)
    return lse.noise_logits(np.asarray(counts, np.float64), recipe.model,
                            "cuda")


def _states_equal(a, b) -> bool:
    import torch
    return (a.step == b.step
            and all(torch.equal(a.params[n], b.params[n]) for n in a.params)
            and a.opt_state.keys() == b.opt_state.keys()
            and all(torch.equal(v, b.opt_state[n]) if torch.is_tensor(v)
                    else v == b.opt_state[n]
                    for n, v in a.opt_state.items())
            and torch.equal(a.generator.get_state(),
                            b.generator.get_state()))


def phase_train_10m(root: str):
    """synthetic_10m_training at its widths (bf16 params, the lazy adam
    step, K1/K2 every micro-step) on one epoch of the training fixture,
    through the function the `train` command runs; then its first
    micro-step against the plain version and two lazy runs bit for bit.
    Returns (the recipe JSON, data_dir, run_dir, topics, launches by
    kernel)."""
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.fixture import write_training_fixture
    from sert_tpu_torch.ops import sampled_lse as slse
    from sert_tpu_torch.train import checkpoint as ckpt

    recipe_json = train_recipe_json(root, RECIPE_10M, 1, TRAIN_10M_LOG_EVERY,
                                    "recipe_10m.json")
    recipe = load_recipe(recipe_json)
    work = os.path.join(root, "10m")
    t0 = time.perf_counter()
    data_dir, topics, _ = write_training_fixture(
        work, recipe, V_10M, E_10M, TRAIN_10M_INSTANCES,
        num_queries=N_QUERIES_10M, seed=SEED)
    t1 = time.perf_counter()
    run_dir = os.path.join(work, "run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    slse.fwd_launches = slse.bwd_launches = 0
    state, resolved = pipeline.train_from_dir(recipe, data_dir, run_dir,
                                              resume=False, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"sampled_lse_fwd": slse.fwd_launches,
                "sampled_lse_bwd": slse.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    _, losses, mid_sps = _train_log(run_dir)
    warm = next((r for r in map(json.loads, open(os.path.join(
        run_dir, "train_log.jsonl"))) if r["event"] == "warmup"), {})
    saved = ckpt.list_checkpoints(os.path.join(run_dir, "checkpoints"))
    written = {s: {k: v for k, v in ckpt.load_meta(p).items()
                   if k in ("params_only", "snapshot_dtype", "epoch")}
               for s, p in saved.items()}
    say("train_10m", cut=f"1_epoch_of_{TRAIN_10M_INSTANCES}_fixture_windows"
        "_not_500.5M_instances", entities=E_10M, vocab=V_10M,
        fixture_s=t1 - t0, train_s=t2 - t1, steps=state.step,
        first_loss=losses[0], last_loss=losses[-1],
        mid_run_steps_per_sec=_spread(mid_sps),
        setup_s=warm.get("setup_s"), init_s=warm.get("init_s"),
        first_step_s=warm.get("first_step_s"), peak_mem_bytes=peak,
        launches=json.dumps(launches).replace(" ", ""),
        checkpoints=json.dumps(written).replace(" ", ""))
    want = TRAIN_10M_INSTANCES // B_TRAIN
    if state.step != want or not any(
            k.startswith("['rows']") for k in state.opt_state):
        raise AssertionError(f"{state.step} steps (expected {want}), or "
                             "not the lazy step's state")
    _check_falling(losses)
    if launches != {"sampled_lse_fwd": want, "sampled_lse_bwd": want}:
        raise AssertionError(f"K1/K2 launched {launches} times for {want} "
                             "micro-steps")
    if not saved or any(not w.get("params_only")
                        or w.get("snapshot_dtype") != "bfloat16"
                        for w in written.values()):
        raise AssertionError(f"snapshots are not the recipe's: {written}")
    del state
    torch.cuda.empty_cache()
    _lazy_checks_10m(resolved, data_dir)
    return recipe_json, data_dir, run_dir, topics, launches


def _lazy_checks_10m(recipe, data_dir) -> None:
    """The 10M run's first micro-step through K1/K2 against the plain
    version (fused_softmax="off") from the same state and negatives; two
    lazy runs of LAZY_REPEAT_STEPS micro-steps bit for bit; rows that no
    micro-step touched (drawn again from a copy of the generator) keep
    their initial bits."""
    import dataclasses
    import torch
    from sert_tpu_torch.models import lse
    from sert_tpu_torch.ops import sampled_lse as slse
    from sert_tpu_torch.train.step import init_state, make_train_step

    batches, horizon = _epoch0_batches(recipe, data_dir, LAZY_REPEAT_STEPS)
    noise = _unigram_noise(recipe, data_dir)
    mcfg = recipe.model
    tcfg = dataclasses.replace(recipe.train, steps_per_call=1,
                               lr_decay_steps=horizon)
    first = {}
    for fused in ("auto", "off"):
        m = mcfg.replace(fused_softmax=fused)
        state = init_state(tcfg.seed, m, tcfg, device="cuda")
        step = make_train_step(m, tcfg, noise=noise, device="cuda")
        slse.fwd_launches = slse.bwd_launches = 0
        _, met = step(state, batches[0])
        first[fused] = (met["loss"].item(), met["grad_norm"].item(),
                        (slse.fwd_launches, slse.bwd_launches))
        del state, step, met
        torch.cuda.empty_cache()
    loss_rel = abs(first["auto"][0] - first["off"][0]) / abs(first["off"][0])
    norm_rel = abs(first["auto"][1] - first["off"][1]) / abs(first["off"][1])

    runs, t_runs = [], []
    for _ in range(2):
        state = init_state(tcfg.seed, mcfg, tcfg, device="cuda")
        if not runs:
            init = {n: state.params[n].clone()
                    for n in ("word_emb", "entity_emb")}
            gen = torch.Generator(device="cuda")
            gen.set_state(state.generator.get_state())
        step = make_train_step(mcfg, tcfg, noise=noise, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
        t_runs.append((time.perf_counter() - t0) * 1e3 / len(batches))
        runs.append(state)
    same = _states_equal(*runs)
    negs = [lse.sample_negatives(gen, noise, 1, mcfg)[0] for _ in batches]
    touched = {
        "entity_emb": torch.cat([b["entities"].long() for b in batches]
                                + negs),
        "word_emb": torch.cat([b["windows"].long().reshape(-1)
                               for b in batches])}
    kept, moved = {}, {}
    for n, ids in touched.items():
        mask = torch.ones(init[n].shape[0], dtype=torch.bool, device="cuda")
        mask[ids] = False                                   # untouched rows
        kept[n] = torch.equal(runs[0].params[n][mask], init[n][mask])
        moved[n] = int((runs[0].params[n] != init[n]).any(dim=1).sum())
    say("train_10m", first_step_loss_k1k2=first["auto"][0],
        first_step_loss_plain=first["off"][0], loss_rel_diff=loss_rel,
        grad_norm_rel_diff=norm_rel,
        launches_k1k2_plain=json.dumps([first["auto"][2], first["off"][2]]
                                       ).replace(" ", ""),
        repeat_steps=len(batches), two_lazy_runs_bit_equal=same,
        repeat_ms_per_step=json.dumps(t_runs),
        untouched_rows_unchanged=json.dumps(kept).replace(" ", ""),
        rows_moved=json.dumps(moved).replace(" ", ""))
    if loss_rel > XENT_SUM_RTOL or norm_rel > SLSE_TOL["bfloat16"] or \
            first["auto"][2] != (1, 1) or first["off"][2] != (0, 0):
        raise AssertionError(f"the first micro-step through K1/K2 and the "
                             f"plain version differ: {first}")
    if not same or not all(kept.values()) or not min(moved.values()):
        raise AssertionError(f"lazy runs equal: {same}; untouched rows "
                             f"unchanged: {kept}; rows moved: {moved}")
    del runs, init
    torch.cuda.empty_cache()


def phase_serve_10m(recipe_json: str, data_dir: str, run_dir: str,
                    topics: dict, records: dict) -> dict:
    """The 10M run's final snapshot behind the EntitySearcher (K3 + K4 at
    E = 10M, 64 topics, depth 1000) against the fp32 dense oracle, then K3
    and K4 against their plain versions on its staged rows; returns the
    launches by kernel (of the search alone)."""
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.serving import EntitySearcher
    recipe = load_recipe(recipe_json)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    searcher = EntitySearcher(recipe, data_dir, run_dir, k=K, query_batch=Q)
    say("serve_10m", load_stage_warmup_s=time.perf_counter() - t0,
        entities=searcher.num_entities,
        rescore_dtype=str(searcher.prep.M_binned.dtype),
        staged_bytes=nbytes(searcher.prep.Mp, searcher.prep.M_binned))
    if searcher.engine != "pallas":
        raise AssertionError(f"engine {searcher.engine}, not the kernels")
    _, launches, _ = check_searcher("serve_10m", searcher, topics)
    _kernels_at_10m(searcher, topics, records)
    del searcher
    torch.cuda.empty_cache()
    return launches


def _kernels_at_10m(searcher, topics: dict, records: dict) -> None:
    """K3 and K4 against their plain versions on the searcher's own staged
    rows at E = 10M (the bf16 prefilter copy past 2^31 bytes, the fp32
    rescore rows past 2^32), for one batch of Q topics: K3's every bin max
    and K4's every rescored score, not only the returned ones. Within TOL;
    the errors join the kernels' records. Launches here are not counted."""
    import torch
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.ops.exact_topk import PAD_BINS
    from sert_tpu_torch.ops.score_binmax import pad_dim
    from sert_tpu_torch.scoring.run import pad_queries
    from sert_tpu_torch.scoring.scorer import _query_reps_and_terms

    prep, cfg = searcher.prep, searcher.recipe.model
    texts = [topics[q] for q in sorted(topics)][:Q]
    _, term_ids, num_terms = pad_queries(
        {f"{i:04d}": searcher.encode(t) for i, t in enumerate(texts)})
    with torch.no_grad():
        R = _query_reps_and_terms(
            searcher.params, cfg, torch.from_numpy(term_ids).cuda(),
            torch.from_numpy(num_terms).cuda(), "cosine")[0]
        R = pad_dim(R.float(), prep.Mp.shape[1])
        E, bw = prep.num_entities, prep.bin_width
        errs = {}
        bins = k3.score_binmax_prepared(R, prep.Mp, E, bin_width=bw)
        want = k3.score_binmax_plain(R, prep.Mp, E, bin_width=bw)
        torch.cuda.synchronize()
        errs["score_binmax"] = (bins - want).abs().max().item()
        torch.testing.assert_close(bins, want, **TOL)
        del want
        bin_idx = torch.topk(bins, K + PAD_BINS, dim=1).indices.int()
        got = k4.gather_rescore(R, prep.M_binned, bin_idx)
        want = k4.gather_rescore_plain(R, prep.M_binned, bin_idx)
        torch.cuda.synchronize()
        errs["gather_rescore"] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
    for name, err in errs.items():
        rec = records[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    say("serve_10m", kernels_vs_plain=json.dumps(errs).replace(" ", ""),
        queries=R.shape[0], entities=E, bins=bins.shape[1],
        rescored_per_query=got.shape[1], prefilter_bytes=nbytes(prep.Mp),
        rescore_bytes=nbytes(prep.M_binned), rtol=TOL["rtol"],
        atol=TOL["atol"])
    del bins, got, want
    torch.cuda.empty_cache()


def phase_sparse_ab_10m(recipe_json: str, data_dir: str) -> None:
    """synthetic_10m_training's micro-step with the lazy step and with the
    dense one (dense adam over the bf16 params), in turns (on, off, off,
    on), each from the recipe's initial state on the same epoch-0 batches
    stacked as the recipe calls them: a warm call, then AB_10M_STEPS timed
    micro-steps; ms a micro-step and peak memory. Reported, not gated,
    apart from finite losses."""
    import dataclasses
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.data.instances import InstanceDataset
    from sert_tpu_torch.train.step import init_state, make_train_step
    recipe = pipeline.resolve_model_config(load_recipe(recipe_json),
                                           InstanceDataset(data_dir).meta)
    n = recipe.train.steps_per_call
    batches, horizon = _epoch0_batches(recipe, data_dir, n + AB_10M_STEPS)
    calls = [{k: torch.stack([b[k] for b in batches[i:i + n]])
              for k in batches[0]} for i in range(0, len(batches), n)]
    noise = _unigram_noise(recipe, data_dir)
    got = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        tcfg = dataclasses.replace(recipe.train, sparse_update=mode,
                                   lr_decay_steps=horizon)
        state = init_state(tcfg.seed, recipe.model, tcfg, device="cuda")
        step = make_train_step(recipe.model, tcfg, noise=noise,
                               device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, calls[0])                              # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in calls[1:]:
            _, m = step(state, c)
        loss = m["loss"].item()                            # syncs
        ms = (time.perf_counter() - t0) * 1e3 / AB_10M_STEPS
        got[mode].append((ms, torch.cuda.max_memory_allocated(), loss))
        del state, step, m
        torch.cuda.empty_cache()
    on = sum(t for t, _, _ in got["on"]) / 2
    off = sum(t for t, _, _ in got["off"]) / 2
    say("sparse_ab_10m", E=E_10M, V=V_10M, B=recipe.train.batch_size,
        k=recipe.model.num_negatives, steps_per_call=n,
        timed_steps=AB_10M_STEPS,
        lazy_ms_per_step=json.dumps([t for t, _, _ in got["on"]]),
        dense_ms_per_step=json.dumps([t for t, _, _ in got["off"]]),
        dense_over_lazy=off / on,
        lazy_peak_mem_bytes=max(p for _, p, _ in got["on"]),
        dense_peak_mem_bytes=max(p for _, p, _ in got["off"]),
        lazy_loss=got["on"][0][2], dense_loss=got["off"][0][2])
    if not all(math.isfinite(x[2]) for v in got.values() for x in v):
        raise AssertionError(f"a loss is not finite: {got}")


def phase_sparse_resume(root: str, data_dir: str) -> None:
    """The flagship's widths (synthetic_1m_retrieval on phase 7's fixture)
    with the lazy adam step for one epoch, a full checkpoint every
    RESUME_CKPT_EVERY micro-steps; then the checkpoints after the first
    are deleted (a crash right after it) and a fresh loop resumes: its
    final state (params, the rows' moments, the generator) must be the
    unbroken run's, bit for bit."""
    import dataclasses
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.train import checkpoint as ckpt
    r = load_recipe(RECIPE)
    recipe = dataclasses.replace(r, name="sparse_resume",
                                 train=dataclasses.replace(
                                     r.train, num_epochs=1,
                                     sparse_update="on",
                                     checkpoint_every_steps=RESUME_CKPT_EVERY))
    run_dir = os.path.join(root, "sparse_resume")
    cdir = os.path.join(run_dir, "checkpoints")
    t0 = time.perf_counter()
    whole, _ = pipeline.train_from_dir(recipe, data_dir, run_dir,
                                       resume=False, device="cuda")
    t1 = time.perf_counter()
    saved = ckpt.list_checkpoints(cdir)
    first = min(saved)
    if not ckpt.has_sparse_opt_state(saved[first]) or \
            not ckpt.load_meta(saved[first]).get("cursor"):
        raise AssertionError(f"{saved[first]} is not a mid-epoch lazy "
                             "checkpoint")
    size = os.path.getsize(saved[first])
    for s, path in saved.items():
        if s > first:
            os.remove(path)
            os.remove(path[:-len(".npz")] + ".json")
    resumed, _ = pipeline.train_from_dir(recipe, data_dir, run_dir,
                                         resume=True, device="cuda")
    t2 = time.perf_counter()
    same = _states_equal(whole, resumed)
    say("sparse_resume", steps=whole.step, resumed_from=first,
        checkpoint_bytes=size, unbroken_s=t1 - t0, resumed_s=t2 - t1,
        bit_equal=same)
    if not same:
        raise AssertionError("the resumed run's state differs from the "
                             "unbroken run's")
    del whole, resumed
    torch.cuda.empty_cache()


def phase_nce_tiny(root: str) -> dict:
    """tiny_recipe("lse") as it stands (the NCE objective) end to end on the
    card, with the dense step and with the lazy one; the loss must fall.
    Then, on the dense run, a gradient fold-in (the NCE refit and the
    moment match on the card) and `query --ranker lm` beside the model's
    NDCG@100. Returns the launches by kernel of those paths."""
    import dataclasses
    import torch
    from sert_tpu_torch import pipeline, recipes
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.serving import EntitySearcher
    from sert_tpu_torch.utils.config import save_config
    col = recipes.tiny_spec().build()
    launches = {"score_binmax": 0, "gather_rescore": 0}
    ndcg = {}
    for mode in ("off", "on"):
        r = recipes.tiny_recipe("lse")
        r = dataclasses.replace(r, name=f"nce_tiny_{mode}",
                                train=dataclasses.replace(
                                    r.train, sparse_update=mode))
        k3.launches = k4.launches = 0
        t0 = time.perf_counter()
        results = pipeline.run_end_to_end(col, r, os.path.join(root, r.name),
                                          device="cuda")
        _, losses, _ = _train_log(os.path.join(root, r.name, "run"))
        ndcg[mode] = results["all"]["ndcg@100"]
        say("nce_tiny", objective=r.model.objective, sparse_update=mode,
            e2e_s=time.perf_counter() - t0, first_loss=losses[0],
            last_loss=losses[-1], ndcg_at_100=ndcg[mode],
            launches=json.dumps({"score_binmax": k3.launches,
                                 "gather_rescore": k4.launches}
                                ).replace(" ", ""))
        _check_falling(losses)
        launches["score_binmax"] += k3.launches
        launches["gather_rescore"] += k4.launches
        if mode == "off":
            dense = r

    # A twin of entity 6 folded by the gradient method into the dense run.
    work = os.path.join(root, dense.name)
    data_dir, run_dir = os.path.join(work, "data"), os.path.join(work, "run")
    k3.launches = k4.launches = 0
    searcher = EntitySearcher(dense, data_dir, run_dir)
    target = col.entities[6]
    text = " ".join(t for d, es in col.doc_entities.items()
                    for t in col.docs[d].split() if target in es)
    t0 = time.perf_counter()
    searcher.add_entities([("nce-twin", text)], method="gradient")
    fold_ms = (time.perf_counter() - t0) * 1e3
    norm_med = searcher._trained_stats()[0]
    norm = float((searcher._extra_vecs[0] ** 2).sum()) ** 0.5
    tid = next(t for t in sorted(col.topics) if target in col.qrels[t])
    names = [n for n, _ in searcher.search(col.topics[tid],
                                           k=searcher.k_max)]
    say("nce_tiny", gradient_fold_in_ms=fold_ms, norm=norm,
        trained_median_norm=norm_med, raw=bool(searcher._extra_raw[0]),
        twin_rank=names.index("nce-twin"), original_rank=names.index(target),
        launches=json.dumps({"score_binmax": k3.launches,
                             "gather_rescore": k4.launches}).replace(" ", ""))
    if not searcher._extra_raw[0] or abs(norm / norm_med - 1) > 1e-5:
        raise AssertionError(f"the NCE fold-in is not raw at the trained "
                             f"median norm: {norm} against {norm_med}")
    launches["score_binmax"] += k3.launches
    launches["gather_rescore"] += k4.launches
    del searcher
    torch.cuda.empty_cache()

    # The lm ranker through the CLI on the same data and topics.
    recipe_json = os.path.join(work, "recipe.json")
    save_config(dense, recipe_json)
    lm_run = os.path.join(work, "lm.trec")
    t0 = time.perf_counter()
    sert_cli("query", "--recipe", recipe_json, "--data", data_dir,
             "--topics", os.path.join(run_dir, "topics.tsv"), "--out",
             lm_run, "--ranker", "lm")
    lm_s = time.perf_counter() - t0
    metrics = json.loads(sert_cli("evaluate", "--run", lm_run, "--qrels",
                                  os.path.join(run_dir, "qrels.trec")))
    say("nce_tiny", ranker="lm", query_s=lm_s,
        lm_ndcg_at_100=metrics["ndcg@100"], model_ndcg_at_100=ndcg["off"])
    if not 0.0 < metrics["ndcg@100"] <= 1.0:
        raise AssertionError(f"the lm ranker's run: {metrics}")
    return launches


def phase_train_adafactor(root: str) -> dict:
    """w3c_expert_finding end to end with optimizer="adafactor" at lr 1e-2
    (the reference's quality setting, benchmarks/NOTES.md:280-282): K5/K6
    every micro-step, K7 never, the loss finite and falling, the served
    top 100 against the dense oracle, NDCG@100 beside phase 12's adam run
    on the same collection; then its first 8 steps through K5/K6 against
    the plain version. Returns the launches by kernel of the end-to-end
    run."""
    import dataclasses
    import torch
    from sert_tpu_torch import recipes
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.eval.metrics import evaluate_run
    from sert_tpu_torch.eval.trec import read_qrels, read_run

    r = load_recipe("w3c_expert_finding")
    recipe = dataclasses.replace(
        r, name="w3c_expert_finding_adafactor",
        train=dataclasses.replace(r.train, optimizer="adafactor",
                                  learning_rate=ADAFACTOR_LR))
    col = recipes.W3C_SYNTH.build()
    launches, n_steps, n_batches, cfg = _run_loglinear_e2e(
        "train_adafactor", recipe, col, root)
    if launches["xent_bwd"] != n_steps or launches["xent_bwd_apply"] or \
            launches["xent_fwd"] != n_steps + n_batches or \
            min(launches["score_binmax"], launches["gather_rescore"]) < 1:
        raise AssertionError(f"launches {launches} for {n_steps} steps and "
                             f"{n_batches} query batches")
    ndcg = {}
    for name in (recipe.name, r.name):
        run_dir = os.path.join(root, name, "run")
        ndcg[name] = evaluate_run(
            read_run(os.path.join(run_dir, "run.trec")),
            read_qrels(os.path.join(run_dir, "qrels.trec")))["all"][
                "ndcg@100"]
    runs = _first_steps(recipe, os.path.join(root, recipe.name, "data"), [
        (fused, dataclasses.replace(cfg, fused_softmax=fused), None)
        for fused in ("auto", "off")])
    losses = {k: v[0] for k, v in runs.items()}
    counts = {k: v[2] for k, v in runs.items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["auto"],
                                                  losses["off"]))
    say("train_adafactor", ndcg_at_100_adafactor=ndcg[recipe.name],
        ndcg_at_100_adam_fused=ndcg[r.name], parity_steps=PARITY_STEPS,
        kernel_losses=json.dumps(losses["auto"]),
        plain_losses=json.dumps(losses["off"]), max_rel_diff=rel,
        rtol=PARITY_RTOL, launches=json.dumps(counts).replace(" ", ""))
    if rel > PARITY_RTOL or counts != {"auto": (PARITY_STEPS,) * 2 + (0,),
                                       "off": (0, 0, 0)}:
        raise AssertionError(f"kernel and plain steps differ by {rel}, or "
                             f"took the wrong paths: {counts}")
    del runs
    torch.cuda.empty_cache()
    return launches


def phase_report(root: str) -> dict:
    """`report` and `fuse` through the CLI (in this process) on phase 11's
    cerc_expert_finding run: the report's model ranker runs through K3 with
    the bias, K4 and the K5 normalizer (its launches counted from 0); its
    model and lm runs must equal `query`'s run files, and `fuse --method
    interp --weights 0.5 0.5` of those files must score the report's
    interp row. Returns the report's launches by kernel."""
    import contextlib
    import io
    import torch
    from sert_tpu_torch import cli
    from sert_tpu_torch.eval import build_ranker_runs, format_markdown
    from sert_tpu_torch.eval.metrics import evaluate_run
    from sert_tpu_torch.eval.trec import (read_qrels, read_run, read_topics,
                                          write_run)

    work = os.path.join(root, "cerc_expert_finding")
    data, run = os.path.join(work, "data"), os.path.join(work, "run")
    topics, qrels = (os.path.join(run, n) for n in ("topics.tsv",
                                                    "qrels.trec"))
    args = ["--recipe", "cerc_expert_finding", "--data", data]
    paths = {n: os.path.join(work, f"report_{n}.trec")
             for n in ("model", "lm", "interp")}

    def main(*argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(list(argv))
        if rc != 0:
            raise AssertionError(f"{argv[0]} exited {rc}")
        return out.getvalue()

    main("query", *args, "--run-dir", run, "--topics", topics, "--out",
         paths["model"])
    main("query", *args, "--topics", topics, "--out", paths["lm"],
         "--ranker", "lm")
    recipe = cli.load_recipe("cerc_expert_finding")
    # The report's interp keeps each topic's top_k, as the fuse -k does.
    main("fuse", "--runs", paths["model"], paths["lm"], "--out",
         paths["interp"], "--method", "interp", "--weights", "0.5", "0.5",
         "-k", str(recipe.score.top_k))

    _zero_kernel_counts()
    t0 = time.perf_counter()
    report = json.loads(main("report", *args, "--run-dir", run, "--topics",
                             topics, "--qrels", qrels, "--json"))
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    launches = _kernel_counts(xent_too=True)

    runs = build_ranker_runs(recipe, data, run, read_topics(topics))
    same = {}
    for name in ("model", "lm"):
        mine = os.path.join(work, f"report_{name}_again.trec")
        write_run(runs[name], mine)
        same[name] = open(mine, "rb").read() == open(paths[name],
                                                     "rb").read()
    fused = evaluate_run(read_run(paths["interp"]), read_qrels(qrels))["all"]
    interp = report["rankers"]["interp"]["all"]
    print(format_markdown(report, title="cerc_expert_finding"), flush=True)
    say("report", seconds=report_s, rankers=",".join(report["rankers"]),
        ndcg_at_100=json.dumps({k: v["all"]["ndcg@100"] for k, v in
                                report["rankers"].items()}).replace(" ", ""),
        model_run_equals_query=same["model"],
        lm_run_equals_query=same["lm"],
        fuse_interp_equals_report=fused == interp,
        launches=json.dumps(launches).replace(" ", ""))
    if not all(same.values()) or fused != interp:
        raise AssertionError(f"report runs equal query's: {same}; fuse "
                             f"{fused} vs the report's interp {interp}")
    if min(launches["score_binmax"], launches["gather_rescore"],
           launches["xent_fwd"]) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    del runs
    torch.cuda.empty_cache()
    return launches


def _first_batches(data_dir: str, seed: int, n: int):
    """An InstanceDataset of ``data_dir`` cut to its first ``n`` batches
    an epoch (the loop's input, as the train command builds it)."""
    import itertools
    from sert_tpu_torch.data.instances import InstanceDataset

    class FirstBatches(InstanceDataset):
        def num_batches_per_epoch(self, batch_size, readers=None):
            return min(n, super().num_batches_per_epoch(batch_size,
                                                        readers))

        def iter_batches(self, batch_size, epoch, start_cursor=None,
                         readers=None):
            return itertools.islice(super().iter_batches(
                batch_size, epoch, start_cursor, readers), n)

    return FirstBatches(data_dir, seed=seed)


def phase_packed_feed(root: str, data_dir: str) -> dict:
    """The flagship at full width (V=250k, E=1M, w=8, B=4096, k=32768,
    bf16, adam + cosine) on phase 7's fixture cut to PACKED_STEPS
    micro-steps, trained twice from the same fresh state through the
    loop, packed_feed "on" and "off": the losses and the final params bit
    for bit, K1/K2 once a micro-step in each, 22 feed bytes an instance
    against 40, mid-run steps/s of both. Returns the launches by kernel of
    the packed run."""
    import dataclasses
    import numpy as np
    import torch
    from sert_tpu_torch import pipeline
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.data import wirepack
    from sert_tpu_torch.data.assoc import Associations
    from sert_tpu_torch.data.prepare import ASSOC_NAME
    from sert_tpu_torch.ops import sampled_lse as slse
    from sert_tpu_torch.train import loop

    base = pipeline.resolve_model_config(
        dataclasses.replace(load_recipe(os.path.join(root, "recipe.json")),
                            name="packed_feed"),
        _first_batches(data_dir, 0, PACKED_STEPS).meta)
    counts = np.asarray(Associations.load(os.path.join(
        data_dir, ASSOC_NAME)).entity_instance_counts(E), np.float64)
    first, _ = next(_first_batches(data_dir, base.train.seed, 1)
                    .iter_batches(B_TRAIN, epoch=0))
    raw_b = wirepack.packed_nbytes(first)
    wire_b = wirepack.packed_nbytes(wirepack.pack_batch(first, V, E))
    out, launches = {}, {}
    for mode in ("on", "off"):
        recipe = dataclasses.replace(base, train=dataclasses.replace(
            base.train, packed_feed=mode, num_epochs=1,
            log_every_steps=PACKED_LOG_EVERY, final_snapshot="params"))
        run_dir = os.path.join(root, f"packed_{mode}")
        torch.cuda.empty_cache()
        slse.fwd_launches = slse.bwd_launches = 0
        state = loop.train(recipe, _first_batches(data_dir,
                                                  recipe.train.seed,
                                                  PACKED_STEPS),
                           run_dir, entity_counts=counts, resume=False,
                           device="cuda")
        torch.cuda.synchronize()
        launches[mode] = {"sampled_lse_fwd": slse.fwd_launches,
                          "sampled_lse_bwd": slse.bwd_launches}
        _, losses, mid_sps = _train_log(run_dir)
        out[mode] = (state, losses, mid_sps)
    (s_on, l_on, sps_on), (s_off, l_off, sps_off) = out["on"], out["off"]
    same = l_on == l_off and all(torch.equal(s_on.params[k], s_off.params[k])
                                 for k in s_off.params)
    say("packed_feed", steps=s_on.step, feed_bytes_packed=wire_b,
        feed_bytes_raw=raw_b, bytes_per_instance=f"{wire_b / B_TRAIN:g}/"
        f"{raw_b / B_TRAIN:g}", losses=json.dumps(l_on),
        bit_equal=same, mid_run_steps_per_sec_on=_spread(sps_on),
        mid_run_steps_per_sec_off=_spread(sps_off),
        launches=json.dumps(launches).replace(" ", ""))
    want = {"sampled_lse_fwd": PACKED_STEPS, "sampled_lse_bwd": PACKED_STEPS}
    if s_on.step != s_off.step or s_on.step != PACKED_STEPS:
        raise AssertionError(f"{s_on.step}/{s_off.step} steps, not "
                             f"{PACKED_STEPS}")
    if not same or launches["on"] != want or launches["off"] != want:
        raise AssertionError(f"packed and raw runs bit-equal: {same}; "
                             f"K1/K2 launches {launches}")
    if (wire_b, raw_b) != (22 * B_TRAIN, 40 * B_TRAIN):
        raise AssertionError(f"feed bytes {wire_b} packed, {raw_b} raw")
    del out, s_on, s_off, state
    torch.cuda.empty_cache()
    return launches["on"]


def phase_debug(root: str, data_dir: str) -> None:
    """utils.debug.checked over the log-linear loss and its gradients
    through K5/K6 on the card (cerc's widths): NaN params must name an op,
    clean ones none; utils.profiling.trace around one flagship micro-step
    (annotated) must write a chrome trace naming K1/K2's kernel and the
    annotated region."""
    import dataclasses
    import glob
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.models import api
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.train.step import init_state, make_train_step
    from sert_tpu_torch.utils import debug, profiling

    r = load_recipe("cerc_expert_finding")
    cfg = r.model.replace(vocab_size=DEBUG_V, num_entities=DEBUG_E)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = api.init_params(g, cfg, "cuda")
    B, w = r.train.batch_size, r.data.window_size
    batch = {"windows": torch.randint(0, DEBUG_V, (B, w), generator=g,
                                      device="cuda").int(),
             "lengths": torch.full((B,), w, dtype=torch.int32,
                                   device="cuda"),
             "entities": torch.randint(0, DEBUG_E, (B,), generator=g,
                                       device="cuda").int()}

    def loss_and_grads(p):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = api.loss_fn(leaves, batch, cfg)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    checked = debug.checked(loss_and_grads)
    xent.fwd_launches = xent.bwd_launches = 0
    clean, (loss, _) = checked(params)
    nan_params = dict(params, proj_w=params["proj_w"] * float("nan"))
    dirty, _ = checked(nan_params)
    found = dirty.get()
    say("debug", check="checked", clean=clean.get(), nan_params=found,
        loss=loss.item(), launches=json.dumps(
            {"xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches}))
    if clean.get() is not None or not math.isfinite(loss.item()) or \
            not (found or "").startswith("nan generated by"):
        raise AssertionError(f"checked: clean {clean.get()}, NaN {found}")
    if (xent.fwd_launches, xent.bwd_launches) != (2, 2):
        raise AssertionError("checked did not run the loss through K5/K6")
    del params, nan_params

    recipe = load_recipe(os.path.join(root, "recipe.json"))
    tcfg = dataclasses.replace(recipe.train, steps_per_call=1,
                               lr_decay_steps=TRAIN_INSTANCES // B_TRAIN)
    mcfg = recipe.model.replace(vocab_size=V, num_entities=E)
    state = init_state(SEED, mcfg, tcfg, device="cuda")
    step = make_train_step(mcfg, tcfg, noise=_unigram_noise(
        dataclasses.replace(recipe, model=mcfg), data_dir), device="cuda")
    first, _ = next(_first_batches(data_dir, 0, 1).iter_batches(
        B_TRAIN, epoch=0))
    tb = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
    step(state, tb)                                         # warm
    torch.cuda.synchronize()
    logdir = os.path.join(root, "trace")
    with profiling.trace(logdir):
        with profiling.annotate("flagship_step"):
            step(state, tb)
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    events = json.load(open(files[0]))["traceEvents"] if files else []
    kernels = sorted({e["name"].split("<")[0] for e in events
                      if e.get("cat") == "kernel"})
    annotated = any(e.get("name") == "flagship_step" for e in events)
    ported = [k for k in kernels if "slse_sweep_kernel" in k]
    say("debug", check="trace", files=len(files), events=len(events),
        annotated=annotated, kernels=len(kernels), ported=",".join(ported))
    if len(files) != 1 or not annotated or not ported:
        raise AssertionError(f"trace: {files}, annotated {annotated}, "
                             f"kernels {kernels}")
    del state, step
    torch.cuda.empty_cache()


# ---------------------------- the mesh phases --------------------------------
# mesh_kernels: the per-shard kernels at the mesh recipes' shard shapes.
# synthetic_10m_scoring's (1, 8) blocks (E 10M / 8 rows each, d 128, Q 64,
# depth 1000, seeded unit rows); amazon_home_kitchen's (8, 1) shard of its
# batch (B 4096 / 8, k 256, d 256, bf16); the flagship's (2, 4) block
# (B 4096 / 2, k 32768 / 4, d 128, bf16); one of cerc_expert_finding's four
# model shards (E 3500 / 4, d 256, fp32 "de", B 1024).
MESH_E, MESH_SHARDS = 10_000_000, 8
MESH_SLSE_CASES = [("amazon_home_kitchen_8x1_shard", 512, 256, 256,
                    "bfloat16", False, False),
                   ("flagship_2x4_block", 2048, 8192, D, "bfloat16", False,
                    True)]
CERC_B, CERC_E, CERC_D, CERC_TP = 1024, 3500, 256, 4
# mesh_nccl: the sharded flagship step against the one-card step for this
# many micro-steps; the 10M query's engines; amazon_home_kitchen's fallback
# on a fixture of this many windows at its widths.
MESH_STEPS = 8
# mesh_kernels: the sharded losses at tp > 1 on a gloo world of this many
# ranks sharing the card; mesh_fused_tp: the pure-TP fused step on that
# world at mesh (1, CARD_RANKS), this many micro-steps an optimizer.
CARD_RANKS = 4
MESH_FUSED_STEPS = 8
# mesh_fused_tp's witness in fp32 compute: this many micro-steps.
MESH_FUSED_F32_STEPS = 2
AHK_V, AHK_E, AHK_INSTANCES = 60_000, 20_000, 1 << 17


def _merge_winners(parts_s, parts_i, k):
    """The port's all-gather merge of per-block winners ([S] lists of
    [Q, k], ids already offset): the top k of their concatenation in block
    order, ties to the lower position."""
    import torch
    from sert_tpu_torch.scoring.scorer import _stable_topk
    return _stable_topk(torch.cat(parts_s, 1), torch.cat(parts_i, 1), k)


def _canonical(s, i):
    """Each row's (scores, ids) ordered by score, then id: a tie's order
    made independent of the merge that produced it."""
    import torch
    by_id = torch.argsort(i, dim=1, stable=True)
    s, i = torch.gather(s, 1, by_id), torch.gather(i, 1, by_id)
    order = torch.argsort(s, dim=1, descending=True, stable=True)
    return torch.gather(s, 1, order), torch.gather(i, 1, order)


def _ring_winners(parts_s, parts_i, k):
    """The ring merge's hop sequence in one process: rank m's carry starts
    as its block's winners and, S - 1 times, takes rank m - 1's carry and
    merges it with its own winners (parallel/topk.py); every rank's final
    carry."""
    from sert_tpu_torch.parallel.topk import _merge_topk
    S = len(parts_s)
    carry = list(zip(parts_s, parts_i))
    for _ in range(S - 1):
        carry = [_merge_topk(*carry[(m - 1) % S], parts_s[m], parts_i[m], k)
                 for m in range(S)]
    return carry


def phase_mesh_kernels(records: dict) -> None:
    """K3/K4, K1/K2 and K5/K6 at the mesh recipes' shard shapes against
    their plain versions (errors join the kernels' records; launches here
    are comparisons and are not counted)."""
    import torch
    from sert_tpu_torch.ops import gather_rescore as k4
    from sert_tpu_torch.ops import score_binmax as k3
    from sert_tpu_torch.ops.exact_topk import (PAD_BINS, exact_topk_prepared,
                                               prepare_entities)
    from sert_tpu_torch.ops.score_binmax import pad_dim
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    R = torch.randn(Q, D, generator=g, device=dev)
    R = R / R.norm(dim=1, keepdim=True)
    M = torch.randn(MESH_E, D, generator=g, device=dev)
    M = M / M.norm(dim=1, keepdim=True)
    rows = MESH_E // MESH_SHARDS
    parts_s, parts_i, oracle_s, oracle_i = [], [], [], []
    errs = {"score_binmax": 0.0, "gather_rescore": 0.0}
    t0 = time.perf_counter()
    for m in range(MESH_SHARDS):
        Mb = M[m * rows:(m + 1) * rows]
        prep = prepare_entities(Mb)
        Rp = pad_dim(R, prep.Mp.shape[1])
        with torch.no_grad():
            bins = k3.score_binmax_prepared(Rp, prep.Mp, rows)
            want = k3.score_binmax_plain(Rp, prep.Mp, rows)
            torch.testing.assert_close(bins, want, **TOL)
            errs["score_binmax"] = max(errs["score_binmax"],
                                       (bins - want).abs().max().item())
            bin_idx = torch.topk(bins, K + PAD_BINS, dim=1).indices.int()
            got4 = k4.gather_rescore(Rp, prep.M_binned, bin_idx)
            want4 = k4.gather_rescore_plain(Rp, prep.M_binned, bin_idx)
            torch.testing.assert_close(got4, want4, **TOL)
            errs["gather_rescore"] = max(errs["gather_rescore"],
                                         (got4 - want4).abs().max().item())
            if m == 0:
                ms3 = cuda_ms(lambda: k3.score_binmax_prepared(
                    Rp, prep.Mp, rows))
                plain3 = cuda_ms(lambda: k3.score_binmax_plain(
                    Rp, prep.Mp, rows), iters=3, warmup=1)
                ms4 = cuda_ms(lambda: k4.gather_rescore(
                    Rp, prep.M_binned, bin_idx))
                plain4 = cuda_ms(lambda: k4.gather_rescore_plain(
                    Rp, prep.M_binned, bin_idx), iters=3, warmup=1)
                b3 = bound(2 * Q * rows * prep.Mp.shape[1],
                           nbytes(prep.Mp, Rp, bins), "bfloat16")
                n_out = Q * bin_idx.shape[1] * BW
                b4 = bound(2 * n_out * D,
                           torch.unique(bin_idx).numel() * BW * D * 4
                           + nbytes(Rp, bin_idx) + 4 * n_out, "float32")
                say("mesh_kernels", name="score_binmax",
                    shard=f"{rows}_of_{MESH_E}", ms=ms3, plain_ms=plain3,
                    **b3)
                say("mesh_kernels", name="gather_rescore",
                    shard=f"{rows}_of_{MESH_E}", ms=ms4, plain_ms=plain4,
                    **b4)
            s, i = exact_topk_prepared(R, prep, k=K)
            parts_s.append(s)
            parts_i.append(i + m * rows)
            dense = R @ Mb.T                          # the fp32 oracle
            ds, di = torch.topk(dense, K, dim=1)
            oracle_s.append(ds)
            oracle_i.append(di + m * rows)
        del prep, bins, want, got4, want4, dense
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    gathered = _merge_winners(parts_s, parts_i, K)
    ring = _ring_winners(parts_s, parts_i, K)
    prep = prepare_entities(M)
    one_s, one_i = exact_topk_prepared(R, prep, k=K)      # one card
    del prep
    torch.cuda.empty_cache()
    o_s, o_i = _merge_winners(oracle_s, oracle_i, K)

    def recall(i):
        hit = torch.zeros_like(o_i, dtype=torch.bool)
        for q in range(Q):
            hit[q] = torch.isin(o_i[q], i[q])
        return hit.float().mean().item()

    # The one card's bf16 prefilter keeps the top k + pad bins of all E
    # rows, a block's of E / 8, so the blocks keep more bins for the same
    # k and can only be closer to the oracle (serve_10m reads the one
    # card's recall at 10M just below 1). Exact fp32 ties occur among 10M
    # seeded rows, and the merges order a tie by their carry order, so
    # results compare in a canonical order (score, then id). Held: every
    # merge's answer the same, the oracle's within RECALL_MIN / SCORE_TOL,
    # and never less exact than the one card's.
    one_recall = recall(one_i)
    ref_s, ref_i = _canonical(*gathered)
    for name, (s, i) in [("allgather", gathered)] + [
            (f"ring_rank{m}", c) for m, c in enumerate(ring)]:
        cs, ci = _canonical(s, i)
        same_merge = torch.equal(cs, ref_s) and torch.equal(ci, ref_i)
        rec = recall(i)
        oracle_err = (s - o_s).abs().max().item()
        if name in ("allgather", "ring_rank0") or not same_merge:
            one = _canonical(one_s, one_i)[1]
            say("mesh_kernels", merge=name,
                same_as_allgather_up_to_ties=same_merge,
                in_carry_order=torch.equal(i, gathered[1]),
                queries_differing_from_one_card=int(
                    (ci != one).any(dim=1).sum()),
                recall_vs_fp32_oracle=rec, one_card_recall=one_recall,
                score_err_oracle=oracle_err,
                score_err_one_card=(s - one_s).abs().max().item())
        if (not same_merge or rec < max(RECALL_MIN, one_recall)
                or oracle_err > SCORE_TOL):
            raise AssertionError(f"{name}: merged blocks ({same_merge}, "
                                 f"{rec} against one card's {one_recall}, "
                                 f"{oracle_err})")
    say("mesh_kernels", blocks=MESH_SHARDS, entities=MESH_E, queries=Q,
        depth=K, blocks_s=t1 - t0,
        kernels_vs_plain=json.dumps(errs).replace(" ", ""))
    for name, err in errs.items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    del M, R, parts_s, parts_i, oracle_s, oracle_i
    torch.cuda.empty_cache()
    for i, case in enumerate(MESH_SLSE_CASES):
        _slse_check("mesh_kernels", 100 + i, case, records)
    _xent_shard_check(records)
    _card_world_check()


def _card_world_check() -> None:
    """The sharded losses at tp > 1 through their kernels: a world of
    CARD_RANKS gloo ranks on this one card (parallel.dryrun's
    check_card_world) against the same losses on one card. The ranks'
    launches are comparisons and are not counted."""
    from sert_tpu_torch.parallel.dryrun import check_card_world
    t0 = time.perf_counter()
    report = check_card_world(CARD_RANKS, timeout=300.0)
    for case in report["cases"]:
        say("mesh_kernels", check="gloo_world_on_card", ranks=CARD_RANKS,
            **{k: (json.dumps(v).replace(" ", "") if isinstance(v, (dict,
                                                                   list))
                   else v) for k, v in case.items()})
    say("mesh_kernels", check="gloo_world_on_card", ranks=CARD_RANKS,
        ok=report["ok"], seconds=time.perf_counter() - t0)
    if not report["ok"]:
        raise AssertionError(f"sharded losses on a gloo world: {report}")


def _xent_shard_check(records: dict) -> None:
    """K5 on each of cerc's four model shards, the global lse stitched from
    them against the plain lse over every entity, then K6 on one shard fed
    that global lse and labels of -1 off the shard against its plain
    version (xent_bwd_plain) on the same inputs."""
    import torch
    from sert_tpu_torch.ops import xent
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    pooled = 0.5 * torch.randn(CERC_B, CERC_D, generator=g, device=dev)
    W = torch.randn(CERC_D, CERC_E, generator=g, device=dev) * (
        2.0 / CERC_D ** 0.5)
    b = 0.1 * torch.randn(CERC_E, generator=g, device=dev)
    labels = torch.randint(0, CERC_E, (CERC_B,), generator=g, device=dev)
    El = CERC_E // CERC_TP
    blocks = [(W[:, m * El:(m + 1) * El].contiguous(),
               b[m * El:(m + 1) * El].contiguous()) for m in range(CERC_TP)]
    errs = {}
    lses = []
    for Wm, bm in blocks:
        got = xent.xent_lse(pooled, Wm, bm, "de", "float32")
        want = xent.xent_lse_plain(pooled, Wm, bm, "de", "float32")
        errs["lse_block"] = max(errs.get("lse_block", 0.0),
                                (got - want).abs().max().item())
        lses.append(got)
    lse_l = torch.stack(lses)
    top = lse_l.amax(0)
    lse = top + torch.log(torch.exp(lse_l - top).sum(0))
    want = xent.xent_lse_plain(pooled, W, b, "de", "float32")
    errs["lse_global"] = (lse - want).abs().max().item()
    m = 1
    Wm, bm = blocks[m]
    loc = labels - m * El
    lab = torch.where((loc >= 0) & (loc < El), loc, torch.full_like(loc, -1))
    got = xent.xent_bwd(pooled, Wm, bm, lse, lab, "de", "float32")
    plain = xent.xent_bwd_plain(pooled, Wm, bm, lse, lab, "de", "float32")
    for name, a, w in zip(("dpooled", "dW", "db"), got, plain):
        errs[name] = (a - w).abs().max().item()
        if errs[name] > XENT_TOL["float32"] * w.abs().max().item():
            raise AssertionError(f"K6 on a shard: {name} {errs[name]}")
    for key in ("lse_block", "lse_global"):
        if errs[key] > XENT_SUM_RTOL * want.abs().max().item():
            raise AssertionError(f"K5 on the shards: {key} {errs[key]}")
    fwd_ms = cuda_ms(lambda: xent.xent_lse(pooled, Wm, bm, "de", "float32"))
    fwd_plain = cuda_ms(lambda: xent.xent_lse_plain(pooled, Wm, bm, "de",
                                                    "float32"))
    bwd_ms = cuda_ms(lambda: xent.xent_bwd(pooled, Wm, bm, lse, lab, "de",
                                           "float32"))
    bwd_plain = cuda_ms(lambda: xent.xent_bwd_plain(pooled, Wm, bm, lse, lab,
                                                    "de", "float32"))
    off = int((lab < 0).sum())
    say("mesh_kernels", name="xent_fwd+xent_bwd", shard=f"{El}_of_{CERC_E}",
        B=CERC_B, d=CERC_D, labels_off_shard=off,
        errors=json.dumps(errs).replace(" ", ""), fwd_ms=fwd_ms,
        fwd_plain_ms=fwd_plain, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain,
        **{f"fwd_{k}": v for k, v in bound(
            2 * CERC_B * El * CERC_D, nbytes(pooled, Wm, bm) + 8 * CERC_B,
            "tf32x3", exps=CERC_B * El).items()},
        **{f"bwd_{k}": v for k, v in bound(
            6 * CERC_B * El * CERC_D,
            2 * nbytes(pooled, Wm, bm) + nbytes(lse, lab), "tf32x3",
            exps=CERC_B * El).items()})
    records["xent_fwd"]["max_abs_err"] = max(
        records["xent_fwd"]["max_abs_err"], errs["lse_block"])
    records["xent_bwd"]["max_abs_err"] = max(
        records["xent_bwd"]["max_abs_err"], errs["dpooled"], errs["dW"],
        errs["db"])


def _ab_configs():
    """The fused-step A/B's configs (phase_fused_ab): w3c_expert_finding
    at the width of the reference's benchmarks/fused_step_bench.py
    (log-linear, V 60k, E 500k, d 256, B 1024, bf16 compute, fp32
    params, lr 1e-2); and its window width."""
    import dataclasses
    from sert_tpu_torch.cli import load_recipe
    r = load_recipe("w3c_expert_finding")
    mcfg = r.model.replace(vocab_size=AB_V, num_entities=AB_E,
                           word_dim=AB_D, compute_dtype="bfloat16")
    return (mcfg, dataclasses.replace(r.train, learning_rate=AB_LR),
            r.data.window_size)


def phase_mesh_fused_tp(records: dict) -> dict:
    """The pure-TP fused step (train.fused.make_fused_train_step on a mesh:
    K5 and K7 per entity block) at the fused-step A/B's width on a world
    of CARD_RANKS gloo ranks sharing the card, mesh (1, 4), blocks of
    125,000 entities, for adam, adagrad and sgd
    (parallel.dryrun.check_fused_card_world): each of MESH_FUSED_STEPS
    micro-steps against the dense sharded step ("off", K5/K6 per block)
    from the same state, the first against the one-card fused step in this
    process, the free-running losses and grad norms against one card's,
    all within FUSED_PARITY_RTOL, params and slots on each step's change
    beyond rounding (against one card within the check's limit for the
    compute dtype; the same run in fp32 compute too, MESH_FUSED_F32_STEPS
    micro-steps); every rank K5 and K7 once a micro-step and K6 never. Prints each rank's ms a micro-step, the collectives' share and
    peak memory; then K7 alone on one block against its plain version for
    each optimizer, and its time and bound with adam. Returns the ranks'
    launches by kernel ("on" and "off")."""
    import torch
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.parallel import dryrun
    if dryrun.FUSED_TP_RTOL != FUSED_PARITY_RTOL:
        raise AssertionError("the pure-TP check's rtol is not "
                             "FUSED_PARITY_RTOL")
    mcfg, tcfg, window = _ab_configs()
    smi = card()
    launches = {"xent_fwd": 0, "xent_bwd": 0, "xent_bwd_apply": 0}
    for cfg, steps in ((mcfg, MESH_FUSED_STEPS),
                       (mcfg.replace(compute_dtype="float32"),
                        MESH_FUSED_F32_STEPS)):
        t0 = time.perf_counter()
        report = dryrun.check_fused_card_world(
            cfg, tcfg, n=CARD_RANKS, window=window, steps=steps, seed=SEED)
        seconds = time.perf_counter() - t0
        dt = cfg.compute_dtype
        for opt, rep in report["optimizers"].items():
            for mode, ranks in rep["launches"].items():
                for r in ranks:
                    for name in launches:
                        launches[name] += r[name]
            worst = {which: max(x["rel_norm"] for x in v.values())
                     for which, v in rep["leaves"].items()}
            say("mesh_fused_tp", opt=opt, compute=dt,
                mesh=f"1x{CARD_RANKS}", backend="gloo_on_one_card", E=AB_E,
                block=AB_E // CARD_RANKS, V=AB_V, d=AB_D,
                B=tcfg.batch_size, steps=steps, ok=rep["ok"],
                through_kernels=rep["launches_through_kernels"],
                replicas_bit_equal=rep["replicas_bit_equal"],
                blocks_ok=rep["blocks_ok"],
                errors=json.dumps(rep["errors"]).replace(" ", ""),
                worst_change_rel_norm=json.dumps(worst).replace(" ", ""),
                rtol=report["rtol"], one_card_rtol=report["one_card_rtol"],
                card=json.dumps(smi))
            for which, v in rep["leaves"].items():
                say("mesh_fused_tp", opt=opt, compute=dt, against=which,
                    leaves=json.dumps(v).replace(" ", ""))
            say("mesh_fused_tp", opt=opt, compute=dt,
                ms_per_step=json.dumps(rep["ms_per_step"]).replace(" ", ""),
                collective_share=json.dumps(
                    rep["collective_share"]).replace(" ", ""),
                collective_calls_per_step=json.dumps(
                    rep["collective_calls_per_step"]).replace(" ", ""),
                peak_mem_bytes=json.dumps(rep["peak_mem_bytes"]).replace(
                    " ", ""),
                rank_launches=json.dumps(rep["launches"]).replace(" ", ""),
                losses=json.dumps(rep["losses"]).replace(" ", ""),
                card=json.dumps(smi))
        say("mesh_fused_tp", compute=dt, ok=report["ok"], seconds=seconds)
        if not report["ok"]:
            raise AssertionError(f"the pure-TP fused step ({dt}): {report}")
    say("mesh_fused_tp", launches=json.dumps(launches).replace(" ", ""))

    # K7 alone on one block of the world's shape, against its plain
    # version for each optimizer (a comparison: not counted).
    El = AB_E // CARD_RANKS
    shape = dict(B=tcfg.batch_size, E=El, d=AB_D)
    for opt in dryrun.FUSED_TP_OPTS:
        x = _apply_case(tcfg.batch_size, El, AB_D, "de", opt, 900,
                        torch.float32)
        got = _apply_outputs(xent.xent_loss_apply, x, opt, "de", "bfloat16")
        errs = _apply_errors("mesh_fused_tp", "block", opt, got, x, "de",
                             "bfloat16", shape)
        del got
        records["xent_bwd_apply"]["max_abs_err"] = max(
            records["xent_bwd_apply"]["max_abs_err"], *errs.values())
        if opt == "adam":
            ms, plain_ms = _apply_times(x, "adam", "de", "bfloat16", 3)
            bnd, cores = _apply_bound(x, "bfloat16")
            say("mesh_fused_tp", name="xent_bwd_apply",
                shard=f"{El}_of_{AB_E}", B=tcfg.batch_size, d=AB_D,
                opt="adam", ms=ms, plain_ms=plain_ms, **bnd,
                bound_cuda_cores_ms=cores, card=json.dumps(smi))
        del x
        torch.cuda.empty_cache()
    return launches


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_mesh_nccl(root: str, data_dir: str, data_10m: str, run_10m: str,
                    topics_10m: dict) -> dict:
    """A world of one rank over NCCL, the (1, 1) mesh: the sharded flagship
    step against the one-card step, ``query`` through the distributed
    engine at synthetic_10m_scoring's widths (both merges) against the
    kernel engine, and amazon_home_kitchen's (8, 1) mesh falling back to
    one card. Returns the launches by kernel of these paths."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        launches = _mesh_flagship_step(data_dir)
        for name, n in _mesh_fused_one_rank().items():
            launches[name] = launches.get(name, 0) + n
        for name, n in _mesh_query_10m(root, data_10m, run_10m,
                                       topics_10m).items():
            launches[name] = launches.get(name, 0) + n
        for name, n in _mesh_fallback(root).items():
            launches[name] = launches.get(name, 0) + n
    finally:
        dist.destroy_process_group()
    return launches


def _mesh_flagship_step(data_dir: str) -> dict:
    import dataclasses
    import torch
    from sert_tpu_torch.cli import load_recipe
    from sert_tpu_torch.models import lse
    from sert_tpu_torch.ops import sampled_lse as slse
    from sert_tpu_torch.parallel.mesh import make_mesh
    from sert_tpu_torch.parallel.train import make_sharded_train_step
    from sert_tpu_torch.pipeline import resolve_model_config
    from sert_tpu_torch.data.instances import InstanceDataset
    from sert_tpu_torch.train.step import init_state, make_train_step
    import numpy as np
    recipe = resolve_model_config(load_recipe(RECIPE),
                                  InstanceDataset(data_dir).meta)
    batches, horizon = _epoch0_batches(recipe, data_dir, MESH_STEPS)
    mcfg = recipe.model
    tcfg = dataclasses.replace(recipe.train, steps_per_call=1,
                               lr_decay_steps=horizon)
    counts = np.random.default_rng(SEED).integers(1, 50, size=E)
    noise = lse.noise_logits(counts, mcfg, "cuda")
    mesh = make_mesh((1, 1))
    out = {}
    for name in ("one_card", "mesh"):
        if name == "one_card":
            state = init_state(tcfg.seed, mcfg, tcfg, "cuda")
            step = make_train_step(mcfg, tcfg, noise=noise, device="cuda")
        else:
            step, init_fn, _ = make_sharded_train_step(mcfg, tcfg, mesh,
                                                       noise=noise)
            state = init_fn()
        slse.fwd_launches = slse.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(state, b)[1]["loss"].item() for b in batches]
        torch.cuda.synchronize()
        out[name] = dict(losses=losses, params=state.params,
                         s=time.perf_counter() - t0,
                         launches={"sampled_lse_fwd": slse.fwd_launches,
                                   "sampled_lse_bwd": slse.bwd_launches})
        del state, step
    a, b = out["one_card"], out["mesh"]
    diffs = {k: (a["params"][k].float() - b["params"][k].float()).abs()
             .max().item() for k in a["params"]}
    loss_diff = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    say("mesh_nccl", check="flagship_step", mesh="1x1", backend="nccl",
        micro_steps=MESH_STEPS, losses_bit_equal=a["losses"] == b["losses"],
        params_bit_equal=all(v == 0 for v in diffs.values()),
        max_loss_diff=loss_diff,
        max_param_diff=json.dumps(diffs).replace(" ", ""),
        one_card_s=a["s"], mesh_s=b["s"],
        launches=json.dumps(b["launches"]).replace(" ", ""))
    # At (1, 1) every collective is the identity and the step runs the
    # one-card step's kernels on the same operands in the same order: the
    # two runs are held bit-equal (PERF.md section 2).
    if (a["losses"] != b["losses"] or any(v != 0 for v in diffs.values())
            or b["launches"] != {"sampled_lse_fwd": MESH_STEPS,
                                 "sampled_lse_bwd": MESH_STEPS}):
        raise AssertionError(f"sharded flagship step: {loss_diff}, {diffs},"
                             f" {b['launches']}")
    del out
    torch.cuda.empty_cache()
    return b["launches"]


def _mesh_fused_one_rank() -> dict:
    """fused_update="on" at mesh (1, 1) over NCCL: make_sharded_train_step
    takes the one-card fused step (K5 + K7), as the reference's does at
    size 1; MESH_STEPS micro-steps at the fused-step A/B's width with
    adam, against make_fused_train_step's from the same seed on the same
    batches, params, slots and losses bit for bit. Returns the mesh run's
    launches."""
    import dataclasses
    import torch
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.parallel.dryrun import seeded_batches
    from sert_tpu_torch.parallel.mesh import make_mesh
    from sert_tpu_torch.parallel.train import make_sharded_train_step
    from sert_tpu_torch.parallel.worlds import tensor_leaves
    from sert_tpu_torch.train.fused import make_fused_train_step
    from sert_tpu_torch.train.step import init_state
    mcfg, tcfg, window = _ab_configs()
    tcfg = dataclasses.replace(tcfg, optimizer="adam", fused_update="on",
                               steps_per_call=1)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in seeded_batches(mcfg, tcfg, window, MESH_STEPS,
                                       SEED)]
    out = {}
    for name in ("one_card", "mesh"):
        if name == "one_card":
            state = init_state(tcfg.seed, mcfg, tcfg, "cuda")
            step = make_fused_train_step(mcfg, tcfg)
        else:
            step, init_fn, _ = make_sharded_train_step(
                mcfg, tcfg, make_mesh((1, 1)))
            state = init_fn()
        xent.fwd_launches = xent.bwd_launches = xent.apply_launches = 0
        losses = [step(state, b)[1]["loss"].item() for b in batches]
        out[name] = dict(losses=losses, leaves=tensor_leaves(state),
                         launches={"xent_fwd": xent.fwd_launches,
                                   "xent_bwd": xent.bwd_launches,
                                   "xent_bwd_apply": xent.apply_launches})
        del state, step
    a, b = out["one_card"], out["mesh"]
    same = a["leaves"].keys() == b["leaves"].keys() and all(
        torch.equal(v, b["leaves"][k]) for k, v in a["leaves"].items())
    say("mesh_nccl", check="fused_update_on_at_1x1", backend="nccl",
        E=AB_E, d=AB_D, opt="adam", micro_steps=MESH_STEPS,
        losses_bit_equal=a["losses"] == b["losses"],
        params_and_slots_bit_equal=same,
        launches=json.dumps(b["launches"]).replace(" ", ""))
    if not same or a["losses"] != b["losses"] or b["launches"] != {
            "xent_fwd": MESH_STEPS, "xent_bwd": 0,
            "xent_bwd_apply": MESH_STEPS}:
        raise AssertionError(f"fused_update='on' at (1, 1): {same}, "
                             f"{b['launches']}")
    launches = b["launches"]
    del out, a, b
    torch.cuda.empty_cache()
    return launches


def _mesh_query_10m(root: str, data_dir: str, run_dir: str,
                    topics: dict) -> dict:
    """``query`` with engine="distributed" (allgather through the CLI, and
    the ring in process) at synthetic_10m_scoring's widths on the 10M run,
    against the kernel engine on the same params: ids equal, scores within
    SCORE_TOL. Returns the distributed runs' launches."""
    import dataclasses
    import torch
    from sert_tpu_torch import cli, pipeline, recipes
    from sert_tpu_torch.data.instances import InstanceDataset
    from sert_tpu_torch.data.prepare import encode_queries
    from sert_tpu_torch.eval.trec import write_run, write_topics
    from sert_tpu_torch.scoring.run import score_topics
    from sert_tpu_torch.utils.config import save_config
    base = recipes.synthetic_10m_scoring()
    topics_path = os.path.join(root, "topics_10m.tsv")
    write_topics(topics, topics_path)
    runs, launches = {}, {}
    _zero_kernel_counts()
    for merge in ("allgather", "ring"):
        r = dataclasses.replace(base, score=dataclasses.replace(
            base.score, engine="distributed", merge=merge))
        path = os.path.join(root, f"recipe_10m_{merge}.json")
        save_config(r, path)
        if merge == "allgather":      # the command a user runs
            out = os.path.join(root, "dist_10m.trec")
            t0 = time.perf_counter()
            if cli.main(["query", "--recipe", path, "--data", data_dir,
                         "--run-dir", run_dir, "--topics", topics_path,
                         "--out", out]) != 0:
                raise AssertionError("query --engine distributed failed")
            say("mesh_nccl", check="query_cli", merge=merge,
                seconds=time.perf_counter() - t0)
    resolved = pipeline.resolve_model_config(
        r, InstanceDataset(data_dir).meta)
    params, vocab, registry = pipeline.load_scorer(run_dir, data_dir,
                                                   resolved, device="cuda")
    encoded = encode_queries(topics, vocab, resolved.data)
    for name, sc in (("allgather", dataclasses.replace(resolved.score,
                                                       merge="allgather")),
                     ("ring", resolved.score)):
        t0 = time.perf_counter()
        runs[name] = score_topics(params, resolved.model, encoded,
                                  registry.names, sc)
        say("mesh_nccl", check="query", engine="distributed", merge=name,
            seconds=time.perf_counter() - t0)
    launches = _kernel_counts()
    t0 = time.perf_counter()
    want = score_topics(params, resolved.model, encoded, registry.names,
                        dataclasses.replace(resolved.score, engine="pallas"))
    pallas_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    worst = 0.0
    for name, got in runs.items():
        for q, hits in want.items():
            ids = [n for n, _ in got[q]]
            if ids != [n for n, _ in hits]:
                raise AssertionError(f"{name}: topic {q} ids differ from "
                                     "the kernel engine's")
            err = max(abs(a[1] - b[1]) for a, b in zip(got[q], hits))
            worst = max(worst, err)
            if err > SCORE_TOL:
                raise AssertionError(f"{name}: topic {q} score error {err}")
    # The command's run file against the kernel engine's answers written
    # the same way (write_run orders a tie by name).
    pallas_out = os.path.join(root, "pallas_10m.trec")
    write_run(want, pallas_out)
    with open(out, "rb") as a, open(pallas_out, "rb") as b:
        cli_equal = a.read() == b.read()
    if not cli_equal:
        raise AssertionError("query --engine distributed's run file differs "
                             "from the kernel engine's")
    say("mesh_nccl", check="query_10m", entities=E_10M, depth=1000,
        topics=len(want), ids_equal_pallas=True, max_score_err=worst,
        cli_run_file_byte_equal=cli_equal,
        pallas_s=pallas_s,
        launches=json.dumps(launches).replace(" ", ""))
    if not launches.get("score_binmax") or not launches.get(
            "gather_rescore"):
        raise AssertionError(f"the distributed engine ran no K3/K4 "
                             f"({launches})")
    return launches


def _mesh_fallback(root: str) -> dict:
    """amazon_home_kitchen as its recipe stands (mesh (8, 1)) on a world of
    one rank: the reference's warning, then one card through K1/K2 on a
    seeded fixture at its widths."""
    import dataclasses
    import logging
    import torch
    from sert_tpu_torch import pipeline, recipes
    from sert_tpu_torch.fixture import write_training_fixture
    from sert_tpu_torch.ops import sampled_lse as slse
    r = recipes.amazon_home_kitchen()
    r = dataclasses.replace(r, train=dataclasses.replace(
        r.train, num_epochs=1, log_every_steps=16))
    work = os.path.join(root, "ahk")
    data_dir, _, _ = write_training_fixture(work, r, AHK_V, AHK_E,
                                            AHK_INSTANCES, seed=SEED)
    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    log = logging.getLogger("sert_tpu.train")
    handler = Catch(level=logging.WARNING)
    log.addHandler(handler)
    slse.fwd_launches = slse.bwd_launches = 0
    t0 = time.perf_counter()
    try:
        state, _ = pipeline.train_from_dir(r, data_dir,
                                           os.path.join(work, "run"),
                                           resume=False, device="cuda")
    finally:
        log.removeHandler(handler)
    torch.cuda.synchronize()
    launches = {"sampled_lse_fwd": slse.fwd_launches,
                "sampled_lse_bwd": slse.bwd_launches}
    warned = [m for m in seen if "running single-device" in m]
    _, losses, _ = _train_log(os.path.join(work, "run"))
    say("mesh_nccl", check="amazon_home_kitchen_fallback",
        mesh=tuple(r.train.mesh_shape), warning=json.dumps(warned[:1]),
        steps=state.step, seconds=time.perf_counter() - t0,
        losses=_spread(losses), launches=json.dumps(launches).replace(
            " ", ""))
    want = AHK_INSTANCES // r.train.batch_size
    if not warned or state.step != want or launches != {
            "sampled_lse_fwd": want, "sampled_lse_bwd": want} or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"fallback: {warned}, {state.step}, {launches}")
    del state
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import sert_tpu_torch  # noqa: F401  (fails outside a checkout)
    import torch
    t0 = time.perf_counter()
    kind = phase_device()
    phase_build()
    records = phase_kernels()
    records.update(phase_train_kernels())
    records.update(phase_xent_kernels())
    records.update(phase_xent_apply_kernels())
    with tempfile.TemporaryDirectory() as root:
        data_dir, run_dir, topics, oracle_top, launches = phase_serve(root)
        torch.cuda.empty_cache()
        phase_cli(root, data_dir, run_dir, topics, oracle_top)
        data_dir, run_dir, topics, qrels, train_launches = phase_train(root)
        launches.update(train_launches)
        searcher = phase_serve_trained(root, data_dir, run_dir, topics,
                                       qrels)
        # Each path's launches are counted from 0 over that path alone;
        # a kernel's record sums the paths it serves.
        paths = [phase_serve_engines(root, data_dir, run_dir, topics,
                                     searcher),
                 phase_cli_scoring(root, data_dir, run_dir, topics, qrels,
                                   searcher),
                 phase_serve_foldin(searcher, topics),
                 phase_serve_http(searcher, topics)]
        del searcher
        torch.cuda.empty_cache()
        paths += [phase_train_loglinear(root),
                  phase_serve_http_loglinear(root), phase_report(root),
                  phase_train_fused(root), phase_train_adafactor(root),
                  phase_train_lse_full(root)]
        recipe_10m, data_10m, run_10m, topics_10m, launches_10m = (
            phase_train_10m(root))
        paths += [launches_10m,
                  phase_serve_10m(recipe_10m, data_10m, run_10m, topics_10m,
                                  records)]
        phase_sparse_ab_10m(recipe_10m, data_10m)
        phase_sparse_resume(root, data_dir)
        paths.append(phase_packed_feed(root, data_dir))
        phase_debug(root, data_dir)
        paths.append(phase_nce_tiny(root))
        paths.append(phase_fused_ab())
        phase_mesh_kernels(records)
        paths.append(phase_mesh_fused_tp(records))
        paths.append(phase_mesh_nccl(root, data_dir, data_10m, run_10m,
                                     topics_10m))
        for path in paths:
            for name, n in path.items():
                launches[name] = launches.get(name, 0) + n
    for name, rec in records.items():
        rec["launches"] = launches[name]
    say("smoke", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
