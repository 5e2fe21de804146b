"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full-width run (one GPU)
    python3 chip_smoke.py --rows N   # the same at N training rows
    python3 chip_smoke.py --allstate-rows N  # train_allstate at N rows
    python3 chip_smoke.py --stream-allstate 13200000
                                     # only stream the Allstate shape at
                                     # 13.2M rows into a Dataset
    python3 chip_smoke.py --parent smoke_checkout/parent/lightgbm_tpu_torch
                                     # also time the parent's K1 and K2
                                     # in turns

Phases, in order; any failure exits non-zero:

1. build   — compile the kernels from lightgbm_tpu_torch/csrc/ with nvcc
             (sm_90a), one nvcc per source, all started together; the
             wrappers' shared-memory counts equal hist.cu's and
             partition.cu's, and the card holds K2's blocks per SM as
             its plan assumes and launches cooperatively;
2. k1      — the histogram kernel's float path against its plain
             version on the window ladder (the root, 1M, ~100k, ~10k and
             ~1k rows, a 1M-row window with 90% of each feature's rows in
             one bin, u16 windows): allclose, equal bit for bit to its
             fixed-point emulation, sibling subtraction, bit-identical
             reruns;
3. k1_int  — the histogram kernel's int path (int8 payload, exact int32
             sums) against its plain version on the same ladder with
             payloads from discretize(), the child windows of a
             partition (sides 1/2) and a 150k-row window of 127s in few
             bins (past 2^24): bit-exact, and bit-identical reruns;
   k1_ragged — both paths on windows at odd starts, of 1 to 33 rows,
             and sides 1/2 (u8, u16, one feature of two bins): the same
             standards; a non-finite gradient gives a NaN channel;
4. k2      — the partition kernel against its plain version, exact,
             with a bit-identical rerun, on both of its paths (resident
             and streaming) and every payload (f32, int8, none): the
             main path's windows (timed), the resident capacity and one
             row past it, all-left and all-right on each path, 1 to 33
             rows at odd starts, u16 rows, u8 rows of 13 bytes, rows of
             1000 u16 bins; the range rule of EFB bundles (K2_RANGE_CASES:
             a direct split with a NaN bin, multi-member ranges with and
             without a NaN position, both default directions, a forced
             split on a bundled member, both paths, f32 and int8
             payloads, u16 rows); the membership
             rule of categorical splits (K2_MEMBER_CASES: u8 and u16
             bitsets, bundled members, a set holding the NaN bin, both
             paths, f32 and int8); route_pair (K = 4096, NC = 3) equal
             to its plain run; each case prints its
             plan; then k2_alt, the plans partition_plan rejects timed
             beside its choice;
5. train   — the main path through the public API at the Higgs shape
             (10.5M x 28 training rows + 500k held out, 255 leaves, 255
             bins, binary): 1 warm-up + 3 timed iterations, predict,
             save/load round trip; launch counters; then k1_turns (K1 on
             the training data's bins as the main path sees it: the root
             and the ladder's windows, and the per-tree replay — the
             first tree's 255 windows back to back at their offsets and
             sides, its launches counted — both paths; with
             --parent, the parent's K1 in turns: parent, change, change,
             parent); k2_turns (the first tree's 254 partitions replayed
             at their offsets and source buffers, f32 and int8 payloads:
             every n_left equal to the tree's, final buffers equal to the
             plain replay's; device ms per tree by kernel, kernels
             counted, ms per window-size bucket, the root and a 100k
             window; with --parent in turns); one profiled iteration
             (device events only); AUC against the same training with
             the kernels' plain versions forced;
5'. cost   — cost attribution (obs/cost.py) of train's booster, from
             the compile events its training emitted (no training of
             its own): ops/grow_tree, ops/pallas_hist and ops/partition
             each have an event with bytes and an optimal ms, each
             within its declared max_signatures; K1's and K2's optimal
             ms at the root window equal the kernels line's bound_ms;
             each entry's optimal ms beside train's profiled iteration
             (kernel names mapped to entries) and the ``stats`` cost
             section of a telemetry file of the events, beside the
             card's name and power limit. The port's lint, started in
             two subprocesses beside the build: ``python -m
             lightgbm_tpu_torch lint --strict`` must import no torch
             (``-X importtime``) and end clean, and ``lint --ir
             --strict`` on the CPU must end clean;
6. train_quant — quantized-gradient training on the same data
             (use_quantized_grad, 4 bins, stochastic rounding, leaf
             renewal, seed 0): the same measurements but no profiled
             iteration, the int path's launch counter, and a plain-kernel twin with the same seed
             (first tree identical, AUC within 0.002); AUC not below the
             float path's less 0.01;
6'. dist   — distributed training (parallel/): ``python -m
             lightgbm_tpu_torch launch 2 -- python3 chip_smoke.py
             --dist-worker SPEC`` starts a world of two ranks on the one
             card (gloo on CUDA tensors; all_gather, reduce_scatter and
             all_to_all staged through pinned host memory). World A:
             each rank half of train's 10.5M rows, binary, 255 leaves
             and bins, tree_learner=data, 1 + 2 iterations quantized
             then float, against an in-process one-rank twin on the same
             rows with rank 0's mappers (quantized: tree for tree;
             float: the same root split, held-out AUC within 0.002; both
             ranks' model sha256 equal; each rank's K1 and K2 launches
             one per leaf and per split). In the same world at 1M rows,
             1 + 1 iterations: feature-parallel equal to serial,
             voting with top_k 28 equal to data (quantized, 63 leaves),
             voting at the default top_k, and float runs (255 leaves) at hist_comm f32, int16,
             int8 and split_search=sharded (int16 and sharded: AUC within
             0.002 of f32; int8: within 0.002 of the JAX package's int8
             exchange on the same rows, and its gap to f32 is printed). It
             prints the backend, init_process_group seconds, s/iteration
             of world and twin, per-split collective ms (wall clock
             between device synchronizes), histogram wire bytes per
             split against comms.payload_bytes, the int8 quantization's
             ms (CUDA events) and each rank's allocator peak. Faults at
             100,000 rows, started first and run beside world A and the
             twins: stall_rank@2 under a 20 s watchdog (the survivor
             exits 13 naming spmd/verify_step and rank 1; nothing left
             running) beside a clean ``launch 2``, and ``launch 2`` under
             init_refuse@1,rank_kill@3, whose model must be byte-equal
             to the clean one's. With two cards or more, world A again
             on NCCL, a rank per card;
6a. resilience — crash recovery, the guard, the OOM ladder and
             telemetry on the same Dataset and parameters: 2 iterations
             with the checkpoint and telemetry callbacks, then a resume
             to 4 in a fresh Booster, whose trees must equal the first 4
             of train_quant's (quantized) and train's (float) byte for
             byte (float: else node for node, leaf values within 1e-6
             relative, and whether two uninterrupted runs differ); the
             snapshot's bytes, write and restore ms and the resume's
             seconds; nan_grad@1 under skip_tree, float and quantized
             (tree 1 constant, tree 0 equal to the uninterrupted run's,
             finite predictions), nan_hess@1 under clamp (every leaf
             finite, a fault line in the telemetry), the default policy
             raising LightGBMError at iteration 1; oom@1 on train_quant's
             parameters (one rung, 255 -> 127 slots, both trees byte-equal
             to train_quant's; the pool misses after the rung); a
             subprocess on 100,000 rows (63 leaves) with
             LIGHTGBM_TPU_CHECKPOINT and kill@3 (running beside the
             guard runs) ending by SIGKILL,
             its snapshots whole, its resume in this process equal to an
             uninterrupted run's model text; the telemetry's tree.leaves
             equal to the trees', hbm.peak_bytes_in_use equal to
             torch.cuda.max_memory_allocated, each iteration's phases in
             ms and the recorder's host ms; ``stats`` in process, one
             /metrics scrape on localhost, and one profiled iteration
             with telemetry on, whose launch calls (the kernels, copies
             and sets the host enqueues; a trace can lose a few of their
             device-side records) must equal those of train's profiled
             iteration, the same iteration on the same state (device
             events printed beside);
6b. train_valid — the main path with this slice's features on the same
             data: a 500k-row valid set binned with the train set's
             mappers, metric=[auc, binary_logloss], bagging 0.8 every
             iteration, feature_fraction 0.8, record_evaluation and
             early_stopping(5); 1 warm-up + 1 timed iteration (iter_s,
             eval_ms, the in-bag window sizes); every
             tree's root count equal to its iteration's in-bag count, the
             last recorded valid AUC equal to the AUC of predict, and
             against the plain twin (same seeds) the same root splits and
             AUC within 0.002;
6c. train_goss — GOSS (learning_rate 0.5, so sampling from iteration 2)
             on the same Dataset, 1 warm-up + 3 timed iterations: every
             sampled iteration keeps its top rows plus its sampled rest,
             root counts equal to them; against the plain twin with
             float64 histogram sums the same root splits and AUC within
             0.002;
6d. train_regression — regression_l1 with leaf renewal on the main
             path's X with a continuous label (the logits plus Student-t
             noise), 1 warm-up + 2 timed iterations: renew_ms by CUDA
             events, held-out L1; against the plain twin the same root
             splits and L1 within 0.002 relative;
6e. train_constrained — this slice's path on the same Dataset:
             intermediate monotone constraints on features 0-3, float,
             1 warm-up + 1 timed iteration (iter_s, leaves re-searched
             per tree; the float64-sum twin's root splits and
             AUC within 0.002; one quantized tree equal to its twin's);
             advanced, quantized, one tree of 255 leaves equal to its
             twin's (the bounds' chunk of leaves, peak memory, tree
             seconds); interaction constraints (four groups of seven)
             with three forced splits on group 0, one quantized tree
             equal to its twin's, its first splits the forced ones, every
             path inside one group; CEGB (split, coupled and lazy
             penalties), two quantized trees and the lazy matrix equal to
             the twin's; monotone sweeps of the monotone models;
6g. train_growth — the growth variants on train's Dataset: the masked
             grower's first tree (one K1 pass over every row per leaf)
             equal to train's first tree node for node; a histogram pool
             of 16 slots (1 + 1 iterations; misses per tree and the K1
             calls they add): the quantized trees equal train_quant's,
             the float ones with train's root split and AUC within 0.002
             (a recomputed float histogram can differ in its last bit);
             linear trees on a second Dataset of the same rows that
             keeps the raw values (1 + 2 iterations: iter_s, the second
             tree's fit timed alone by CUDA events with its peak extra
             memory, its leaves' models within 1e-3 of a float64 solve
             of their normal equations, AUC within 0.002 of the plain
             twin, predict within 1e-5 of a numpy walk of the model
             text); the level grower under max_depth=7 (the same leaves
             as the compact grower for 99% of 1M training rows) and at
             the full budget (1 + 2 iterations, read-backs per tree,
             launches per iteration, one profiled iteration, AUC within
             0.002 of the plain twin);
6f. surface_higgs — the Python surface on train's Dataset and model:
             save_binary of it and of a valid set (bins loaded back
             equal); ``python3 -m lightgbm_tpu_torch task=train`` in a
             subprocess from the binary files, 2 trees, float (equal to
             train's first two node for node, leaf values to 1e-6
             relative) and quantized (equal to an in-process twin); the
             held-out rows as a %.17g CSV parsed by the native parser
             (which must have built; parse rate) and ``task=predict`` on
             it equal to Booster.predict (1e-7); ``task=refit`` on 500,000
             training rows equal to a numpy refit of the model text
             (1e-5 relative); ``task=convert_model`` compiled by g++ and
             run on 1,000 rows, equal to a float64 numpy walk (1e-9) and
             to predict(raw_score=True), whose sums are float32 (1e-6);
             LGBMClassifier (4 trees, eval_set, AUC, early_stopping)
             equal to train's trees, predict_proba equal to
             booster_.predict, sk_iter_s; a custom objective (numpy
             binary log loss through fobj, 1 + 3 iterations) with the
             built-in binary's root splits (boost_from_average off) and
             AUC within 0.002, custom_iter_s and the seconds of fobj and
             its two copies; every CLI run counts its kernels' launches;
6h. ingest_higgs — streaming ingest of train's own 10.5M x 28 rows
             (ingest_chunk_rows=65,536): an ArrayChunkSource whose device
             bins are torch.equal to the eager Dataset's (mappers and
             labels equal) and whose 1 + 1 trees equal train's first two
             (model text); a chunk factory of unknown length (the
             reservoir sample), 1 + 1, AUC within 0.002 of train's at two
             iterations; construct_s, pass1_s, pass2_s and the host peak
             (tracemalloc) against the float matrix; with pyarrow, the
             held-out rows as an Arrow table streamed as a valid set,
             equal to the eager valid set;
6i. ingest_text — inside surface_higgs, on its %.17g CSV of the 500,000
             held-out rows: eager,
             two_round and ingest_chunk_rows=65,536 (each with
             bin_construct_sample_cnt=500,000), both streamed constructs
             bit-equal to the eager one; MB/s of each;
6j. serve — Booster.compile() of train's model and of a 100-tree forest
             (its 4 trees 25 times): the compiled raw scores of the
             500,000 held-out rows within 1e-6 of a numpy walk of the
             model text, the 100-tree ones 25x the 4-tree ones (rtol and
             atol 1e-5), the eager Booster.predict (taken before
             compile) equal to the compiled and the routed output,
             no new padded shape from 200 requests of 1-20,000 rows after
             warmup; warmup seconds, p50/p99 latency at 1 to 16,384 rows,
             device events of a 1-row call, rows/s; a MicroBatcher (8
             threads x 200 requests of 1-64 rows, every future equal to
             the direct result; p50/p99); a same-layout swap written in
             place (extra device memory at most one field + 1 MiB, the
             old forest raising);
6k. serve_daemon — `python -m lightgbm_tpu_torch serve` on the card,
             over a watch directory where train's first 4 trees were
             published (resilience/publisher.py, a canary of 256
             held-out rows), beside a second daemon started with it under
             serve_kill@5: the ready seconds split into import torch, the
             CUDA context and load + compile + warmup; socket predictions
             of 1, 64, 1,024 and 10,000 rows within 1e-6 of the
             in-process Booster.predict, raw within 1e-6 of the numpy
             walk, recompile delta 0 after warmup, socket p50/p99 beside
             serve's in-process p50 and the request spans' ms; a hot swap
             to the 100-tree forest under a client's traffic (no error
             reply, every reply equal to the model it names; seconds from
             publish to the first reply naming it); publish_torn@3 (the
             publisher retries, the torn bytes never serve),
             publish_poison@4 (canary_refused, the model keeps serving);
             stats and metrics parse; `stats` folds the telemetry; SIGTERM
             during 200 pipelined requests (every reply a prediction or
             draining, every request the batcher took answered, exit 0
             inside --grace); the serve_kill@5 daemon dies by SIGKILL
             after 4 answers; no swap_failure that was not injected;
6l. pipeline — `python -m lightgbm_tpu_torch pipeline --device-type
             cuda` at the main path's width (28 features, 255 leaves,
             binary, 3 generations of 5 rounds, ingest_chunk_rows
             65,536), the JAX package's two slow acceptance runs. First,
             after resilience, the in-process twins of run A's
             generation 0 and of its uninterrupted continuation
             (launches counted: the phase's K1 and K2 calls); then runs
             A and B, one after the other, on the lane (a thread of its
             own, then the examples' CLI runs of 9h) beside the phases
             from train_valid to surface_examples (their figures are
             taken beside them; the lane runs nothing on the card in
             this process), held after surface_examples. Run A
             (tests/test_pipeline.py's chaos run;
             250,000 rows a generation, 10.5M reduced) under
             rank_kill@7, publish_torn@1 and serve_kill@12 at 15
             requests/s: no failure, 3 generations published, 2 swaps
             confirmed, the replica on the last sha, no client timeout,
             a connection error, the longest gap between answers under
             60 s, a swap_failure in serve.jsonl; generation 0's
             published model byte-equal to its twin, generation 1
             (killed and resumed) to the uninterrupted continuation; 64
             requests after the run, each reply's raw scores within 1e-6
             of the model it names. Run B (tests/test_fleet.py's;
             100,000 rows; --swap-timeout 30, not 240: PIPE_B says
             why) under store_outage@1 and publish_poison@2
             with a 60 requests/s spike on 1-3 replicas: scaled up and
             down, a peak of 2 or more, one rollback, the fleet on the
             good sha, the poisoned model never swapped in, no client
             timeout. Printed beside the card's name and power limit:
             each generation's seconds and seconds per iteration, the
             relaunch gap after rank_kill, each replica's spawn to
             ready, autoscale decision to serving, publish to the
             fleet-wide swap, the canary refusal to the rollback and to
             the fleet's convergence, the client's p50/p99 and longest
             gap, each process's device memory; no kernel rebuilt;
7. small runs — uint16 bins (max_bin=400) held to the float standard,
             a deterministic quantized run (200k x 28, no stochastic
             rounding) whose every tree equals its plain twin's, and
             small_objectives: huber, fair, poisson, quantile (alpha
             0.9), mape, gamma, tweedie, cross_entropy and
             cross_entropy_lambda (200k x 28, 2 iterations), every tree
             equal to its float64-sum plain twin's, save/load/predict
             equal to the in-memory prediction; a quantized L1 run held
             tree for tree to its twin;
7b. small constraint runs — intermediate and advanced monotone with
             categorical features, intermediate bundled, a forced split
             on a member of a multi-member bundle, interaction
             constraints bundled, CEGB with bagging 0.8 (quantized, 2
             trees of 63 leaves, each equal to its plain twin's,
             save/load/predict; monotone sweeps);
8. train_rank — lambdarank at the MS LTR shape (2.27M training rows x
             137 features in queries of ~120 documents, at most 1,251;
             10% more queries held out; 255 leaves, 255 bins): 1 warm-up
             + 2 timed iterations, the gradient function timed alone
             (grad_ms), held-out NDCG@10, launch counters; the card's
             gradients of the first 200 queries at
             the warm-up scores equal to the CPU's (rtol 1e-4); against
             the plain twin the same root split and NDCG@10 within 0.002;
9. train_multiclass — softmax multiclass at Covertype's shape (531,012 +
             50,000 held-out rows x 54 features, 7 classes, 255 leaves,
             EFB at its default: the one-hot indicators bundle; G, B and
             the groups printed): 1 iteration of 7 trees (the warm-up,
             timed), held-out multi_logloss and accuracy, every row's
             probabilities summing to 1, launch counters (no profiled
             iteration: its trace took 77.5 s); against the
             plain twin, whose float histograms
             sum in float64 (float32 sums of 531k near-equal hessians
             drift: the drift of the root histogram is printed beside),
             the first iteration's 7 root splits and
             multi_logloss within 0.002; one unbundled iteration with the
             same 7 root splits and multi_logloss within 0.002; then one
             multiclassova and one quantized iteration, each with its 7
             trees identical to its plain twin's; K1 and K2 at the
             bundled width;
9b. train_multiclass_dart — BASELINE.json's config 4: DART (drop_rate
             0.1, skip_drop 0) on train_multiclass's Dataset with its
             50,000 rows as a valid set (multi_logloss), 1 warm-up + 1
             timed iteration of 7 trees; every tree after drop and
             normalize identical to the float64-sum plain twin's, and the
             recorded multi_logloss equal;
9c. predict_breadth — pred_contrib on 1,000 held-out rows of train's
             model and train_multiclass's (each row's contributions sum
             to its raw score; 50 rows of the first iteration equal a
             single-row TreeSHAP of the model text) and pred_early_stop
             (a margin no row passes equals the full walk; the share of
             rows stopped early and the time at the default margin);
9d. train_allstate — EFB at full width: Allstate's shape (100,000 +
             50,000 rows x 4,228 features, 33 one-hot blocks of 128, NaN
             in column 0), binary, 255 leaves: construct and bundling
             seconds, G, B, peak device memory, iter_s, AUC;
             the device's bundled matrix equal to the numpy build on
             100,000 rows; against the float64-sum plain twin the same
             root split in every tree and AUC within 0.002; K1 and K2 at
             the bundled width; ingest_allstate: the same rows streamed from a
             chunk factory of allstate_chunks (ingest_chunk_rows=65,536),
             device bins torch.equal to the eager Dataset's, the host peak
             against the float matrix and against the sample plus one
             chunk;
9e. train_airline — categorical splits at the airline benchmark's shape
             (10,000,000 + 500,000 rows x 8: six categoricals of 7 to
             ~300 categories, DepTime, Distance), binary, 255 leaves,
             1 warm-up + 2 timed iterations: construct_s, the bins per
             mapper, iter_s, the share of categorical splits by
             family, peak memory, AUC (no profiled iteration, for the
             smoke's time); against the float64-sum twin the
             same root splits and AUC within 0.002; a quantized
             iteration tree for tree; raw predict equal to a numpy walk
             of the model text (100,000 held-out rows); K1 and K2 (its
             membership rule) at the airline root;
9f. small categorical and monotone runs — one-hot categoricals, EFB with
             categorical members, basic monotone constraints alone,
             with monotone_penalty and with path_smooth (quantized, 2
             trees of 63 leaves each, every tree equal to the plain
             twin's; monotone sweeps; save/load);
9g. small rf and cv runs — a random forest (200k x 28, bagging 0.632, 3
             iterations): save/load, its raw scores the mean of its
             iterations', the JAX package's average_output model
             (JAX_RF_MODEL) predicting JAX's numbers; cv (3 folds, 3
             rounds, early stopping);
9h. surface_examples — examples/generate_data.py's data; the four
             examples/*/train.conf through ``python3 -m
             lightgbm_tpu_torch config=train.conf num_trees=25`` (four
             processes at once), then predict.conf or task=predict, on
             the lane after the pipeline's runs; predictions equal
             to a numpy walk of the model text (1e-5) and quality above
             tests/test_examples.py's floors; LGBMRegressor, LGBMRanker
             with group, LGBMClassifier with string labels and
             class_weight="balanced" on the same data, in process;
10. report — the card's name and power limit, then one JSON line with
             every kernel's launches (by path), times, bound and library
             time.

The K1 ladder (phases 2-3) and the K2 cases (phase 4) include the widths
of phases 8-9: the roots at 2,270,000 x 137 and 581,012 x 54 u8 bins,
and smaller windows at 137 and 54 features, so that every feature-group
count of K1's plan on those paths runs (each rung prints its plan and
the bound with the rows read once per group); K2 at 137-byte rows (f32
and int8 payloads, the resident capacity and one row past it) and at
54-byte rows.

Timing: windows of 2M rows and more are timed with CUDA events around
back-to-back launches; smaller ones with torch.profiler's device time
(every kernel and memset a call launches), so the host's enqueue is not
counted. Each figure carries its method.

The last line of stdout is {"ok": true, "device": {...}}. Exits non-zero
without printing a result when torch.cuda is unavailable, or when the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

# the range rule's "no upper bound" (K2's hi for a plain split)
INT_MAX = 2 ** 31 - 1

# H100 SXM published peaks and the kernels' bounds: one copy, in the
# port's cost attribution (obs/cost.py), which the kernels line and the
# cost phase both read
from lightgbm_tpu_torch.obs.cost import (  # noqa: E402
    H100_FP32_OPS_PER_S as FP32_OPS_PER_S,
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    H100_INT32_OPS_PER_S as INT32_OPS_PER_S, k1_bound, k2_bound)

# trees in each small run (correctness, not timed)
SMALL_TREES = 2
HIGGS_ROWS = 10_500_000
VALID_ROWS = 500_000
FEATURES = 28
BINS = 255
# MS LTR (MSLR-WEB30K Fold 1, BASELINE.md): 2.27M training rows x 137
# features, ~120 documents per query on average, at most ~1,251
LTR_ROWS = 2_270_000
LTR_FEATURES = 137
LTR_MEAN_QUERY = 120
LTR_MAX_QUERY = 1251
# Covertype (BASELINE.json configs): 581,012 rows x 54 features (10
# numerical, 4 wilderness-area and 40 soil-type indicators), 7 classes
COV_ROWS = 581_012
COV_VALID = 50_000
COV_FEATURES = 54
COV_CLASSES = 7


def make_higgs_like(n, f, seed=0, target=False):
    """The Higgs-shaped generator of bench.py (same draws, same seed).
    ``target``: also a continuous label from the same signal, the logits
    plus Student-t noise of 2 degrees of freedom (``RandomState(seed +
    1)``)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f).astype(np.float32)
    coef = rs.randn(f).astype(np.float32)
    logits = X @ coef * 0.5 + 0.5 * rs.randn(n).astype(np.float32)
    y = (logits > 0).astype(np.float32)
    if not target:
        return X, y.astype(np.float64)
    noise = np.random.RandomState(seed + 1).standard_t(2, n)
    return X, y.astype(np.float64), logits.astype(np.float64) + noise


ALLSTATE_CHUNK = 262_144


def allstate_chunks(n, f, seed=0, per_group=128, rows=ALLSTATE_CHUNK):
    """The rows of :func:`make_allstate_like` as ``(X, y)`` chunks of at
    most ``rows`` rows (float32, float64), in order, with the same draws:
    each block of ``ALLSTATE_CHUNK`` rows draws its picks and its NaN
    mask first (a few integers per row), then its rows are filled chunk
    by chunk, so no more than one chunk of the float matrix exists."""
    groups = f // per_group
    vals = np.random.RandomState(12345).rand(
        groups, per_group).astype(np.float32) * 2
    thresh = np.float32(groups)
    start = 0
    while start < n:
        c = min(ALLSTATE_CHUNK, n - start)
        rs = np.random.RandomState((seed * 1_000_003 + start) % (2 ** 31 - 1))
        picks = [rs.randint(0, per_group, c) for _ in range(groups)]
        nan = rs.rand(c) < 0.1
        signal = np.zeros(c, np.float32)
        for g in range(groups):
            signal += vals[g, picks[g]]
        y = (signal > thresh).astype(np.float64)
        for lo in range(0, c, rows):
            hi = min(c, lo + rows)
            Xc = np.zeros((hi - lo, f), np.float32)
            r = np.arange(hi - lo)
            for g in range(groups):
                pick = picks[g][lo:hi]
                Xc[r, g * per_group + pick] = vals[g, pick]
            Xc[nan[lo:hi], 0] = np.nan
            yield Xc, y[lo:hi]
            del Xc          # one chunk at a time
        start += c


def make_allstate_like(n, f, seed=0, per_group=128):
    """The Allstate-shaped generator of bench.py (make_allstate_like over
    allstate_chunks at its default chunk of 262,144 rows; same draws,
    same seed): ``f // per_group`` one-hot blocks of ``per_group``
    columns, each row one nonzero per block with a value from a fixed
    stream (seed 12345), 10% NaN in column 0, the label the block values'
    sum above its expectation. One float32 matrix, filled chunk by
    chunk (:func:`allstate_chunks`)."""
    X = np.empty((n, f), np.float32)
    y = np.empty(n, np.float64)
    start = 0
    for Xc, yc in allstate_chunks(n, f, seed, per_group):
        X[start:start + len(yc)] = Xc
        y[start:start + len(yc)] = yc
        start += len(yc)
    return X, y


# the airline cell: the ASA Data Expo 2009 airline data as the
# szilard/benchm-ml airline benchmark uses it (label dep_delayed_15min)
AIRLINE_ROWS = 10_000_000
AIRLINE_VALID = 500_000
AIRLINE_CATS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
                ("UniqueCarrier", 22), ("Origin", 300), ("Dest", 300))
AIRLINE_NAMES = [c for c, _ in AIRLINE_CATS] + ["DepTime", "Distance"]


def make_airline_like(n, seed=0):
    """``n`` rows of the airline benchmark's shape: six categorical
    columns (category codes: Month 12, DayofMonth 31, DayOfWeek 7,
    UniqueCarrier ~22, Origin ~300, Dest ~300; carriers and airports drawn
    with Zipf-like frequencies, weight ``1 / rank^1.1``), DepTime (hhmm,
    0-2359) and Distance (miles, log-normal, 30-4983). The label
    (dep_delayed_15min, ~19% positive) is a logistic draw from fixed
    per-category effects (seed 777), the departure hour, the distance and
    noise. The cardinalities approximate the source's (its carriers and
    airports vary by year); the values are synthetic."""
    rs = np.random.RandomState(seed)
    eff = np.random.RandomState(777)
    X = np.empty((n, 8), np.float32)
    logit = np.full(n, -1.75)
    for j, (_, k) in enumerate(AIRLINE_CATS):
        p = None
        if k > 31:
            w = 1.0 / np.arange(1, k + 1) ** 1.1
            p = w / w.sum()
        codes = rs.choice(k, size=n, p=p)
        X[:, j] = codes
        logit += (0.5 if k > 31 else 0.25) * eff.randn(k)[codes]
    hour = np.clip(rs.normal(13.5, 4.5, n), 0.0, 23.99)
    X[:, 6] = np.floor(hour) * 100 + np.floor((hour % 1) * 60)
    dist = np.clip(np.exp(rs.normal(6.6, 0.6, n)), 30, 4983)
    X[:, 7] = np.round(dist)
    logit += 0.09 * (hour - 13.5) + 0.15 * np.log(dist / 700.0)
    logit += 0.5 * rs.randn(n)
    y = (rs.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float64)
    return X, y


def _parse_model(text):
    """The trees of a model text as dicts of numpy arrays."""
    trees = []
    for block in text.split("\nTree=")[1:]:
        kv = dict(ln.split("=", 1) for ln in block.split("\n")[1:]
                  if "=" in ln)
        t = {"num_leaves": int(kv["num_leaves"])}
        for k in ("split_feature", "decision_type", "left_child",
                  "right_child", "cat_boundaries", "cat_threshold",
                  "leaf_count", "internal_count"):
            if k in kv:
                t[k] = np.asarray(kv[k].split(), np.int64)
        for k in ("threshold", "leaf_value"):
            t[k] = np.asarray(kv[k].split(), np.float64)
        if int(kv.get("is_linear", "0")) and "leaf_const" in kv:
            # linear leaves: per leaf its constant and its features'
            # coefficients, in the order of the text
            nf = np.asarray(kv["num_features"].split(), np.int64)
            feats = np.asarray(kv["leaf_features"].split(), np.int64)
            coef = np.asarray(kv["leaf_coeff"].split(), np.float64)
            ends = np.cumsum(nf)
            t["leaf_const"] = np.asarray(kv["leaf_const"].split(),
                                         np.float64)
            t["linear"] = [(feats[e - k:e], coef[e - k:e])
                           for k, e in zip(nf, ends)]
        trees.append(t)
    return trees


def numpy_leaves(text, X):
    """``[T, n]`` leaf of every row of ``X`` in every tree of a model
    text, by a numpy walk: LightGBM's NumericalDecision (missing types
    none, zero and nan) and CategoricalDecision (``int(v)`` goes left
    when its bit is set in the node's u32 words; NaN, negative values and
    values past the words go right)."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    rows = np.arange(n)
    out = []
    for t in _parse_model(text):
        if t["num_leaves"] <= 1:
            out.append(np.zeros(n, np.int64))
            continue
        node = np.zeros(n, np.int64)
        while (node >= 0).any():
            idx = rows[node >= 0]
            nd = node[idx]
            v = X[idx, t["split_feature"][nd]]
            dt = t["decision_type"][nd]
            thr = t["threshold"][nd]
            nan = np.isnan(v)
            mt = (dt >> 2) & 3
            v0 = np.where(nan, 0.0, v)
            missing = np.where(mt == 2, nan,
                               (mt == 1) & (nan | (np.abs(v0) <= 1e-35)))
            left = np.where(missing, (dt & 2) != 0, v0 <= thr)
            cat = (dt & 1) != 0
            if cat.any():
                cb, ct = t["cat_boundaries"], t["cat_threshold"]
                ok = ~nan & (v0 >= 0)
                iv = np.where(ok, v0, 0).astype(np.int64)
                k = thr.astype(np.int64)
                lo = cb[np.where(cat, k, 0)]
                width = cb[np.where(cat, k + 1, 0)] - lo
                inside = ok & ((iv >> 5) < width)
                word = ct[np.where(inside, lo + (iv >> 5), 0)]
                member = inside & (((word >> (iv & 31)) & 1) != 0)
                left = np.where(cat, member, left)
            node[idx] = np.where(left, t["left_child"][nd],
                                 t["right_child"][nd])
        out.append(~node)
    return np.stack(out) if out else np.zeros((0, n), np.int64)


def numpy_tree_values(t, X, lv):
    """Outputs of one parsed tree ``t`` on the rows of ``X`` in leaves
    ``lv``, in float64: the leaf value, or a linear leaf's constant plus
    its coefficients times the row's values (the leaf value for a row
    with NaN in one of its features)."""
    if "linear" not in t:
        return t["leaf_value"][lv]
    X = np.asarray(X, np.float64)
    out = t["leaf_const"][lv].copy()
    for leaf, (feats, coef) in enumerate(t["linear"]):
        rows = np.nonzero(lv == leaf)[0]
        if not len(feats) or not len(rows):
            continue
        x = X[np.ix_(rows, feats)]
        nan = np.isnan(x).any(axis=1)
        out[rows] = np.where(nan, t["leaf_value"][leaf],
                             out[rows] + np.nan_to_num(x) @ coef)
    return out


def numpy_predict_raw(text, X, K=1):
    """Raw scores of ``X`` by a numpy walk of a model text
    (:func:`numpy_leaves`, :func:`numpy_tree_values`), in float64:
    ``[n]``, or ``[n, K]`` for K trees per iteration (tree ``i`` in class
    ``i % K``)."""
    leaves = numpy_leaves(text, X)
    raw = np.zeros((K, np.asarray(X).shape[0]))
    for i, (t, lv) in enumerate(zip(_parse_model(text), leaves)):
        raw[i % K] += numpy_tree_values(t, X, lv)
    return raw[0] if K == 1 else raw.T


def log(msg):
    # one write a line: the pipeline's runs log from a thread of their own
    sys.stdout.write(f"{msg}\n")
    sys.stdout.flush()


def events_ms(fn, reps, torch):
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls (after one warm-up), over ``reps``. The card stays busy when a
    call's device time exceeds its enqueue (the root window)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# the port's timed() phases (utils/timer.py): under a profile that
# records host ops their record_function ranges also show as device-side
# user annotations, which are no device work
PHASE_LABELS = frozenset((
    "boosting/gradients", "boosting/bagging", "tree_learner/grow",
    "boosting/update_score", "engine/eval", "dataset/construct"))


# CUDA runtime calls that enqueue device work (kernels, copies, sets)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaMemsetAsync")


def _is_annotation(e):
    return e.key in PHASE_LABELS or getattr(e, "is_user_annotation", False)


def _device_us(e, DeviceType):
    if getattr(e, "device_type", None) != DeviceType.CUDA \
            or _is_annotation(e):
        return 0.0
    dt = getattr(e, "self_device_time_total", None)
    if dt is None:
        dt = getattr(e, "self_cuda_time_total", 0.0)
    return dt


# short kernels that open and close every profiled trace (profiled_ms)
TRACE_PAD = 8


def profiled_ms(fn, reps, torch, by_name=None, counts=None, expect=None):
    """Device milliseconds per call under torch.profiler (after one
    warm-up): for every kernel and memset the ``reps`` calls launch, its
    mean device time per recorded launch times its launches per call.
    The host's enqueue is not counted. The trace may drop a few launches
    near its start or its end, so the calls are preceded and followed by
    a few short sleep kernels (PyTorch's ``spin_kernel``, left out of the
    sums) that take those losses; a trace still missing more than a tenth of a kernel's
    launches is taken again, and so is one that does not hold exactly
    ``expect`` kernels per call (memory copies and sets aside), where the
    caller knows that number.
    ``by_name``, a dict, receives each kernel's milliseconds per call, and
    ``counts`` its launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        dev = [(e.count, _device_us(e, DeviceType), e.key)
               for e in prof.key_averages()]
        dev = [(c, t, k) for c, t, k in dev
               if t > 0 and "spin_kernel" not in k]
        per_call = [max(1, round(c / reps)) for c, _, _ in dev]
        if dev and all(abs(c - n * reps) <= max(1, n * reps // 10)
                       for (c, _, _), n in zip(dev, per_call)) and (
                expect is None or expect * reps == sum(
                    c for c, _, k in dev
                    if not k.startswith(("Memcpy", "Memset")))):
            ms = {k: t / c * n / 1e3
                  for (c, t, k), n in zip(dev, per_call)}
            if by_name is not None:
                by_name.update(ms)
            if counts is not None:
                counts.update({k: n for (_, _, k), n in zip(dev, per_call)})
            return sum(ms.values())
        log(f"[profiler] incomplete device trace (attempt {attempt + 1}): "
            f"{[c for c, _, _ in dev]} launches for {reps} calls")
    raise AssertionError("torch.profiler recorded no complete device trace")


def queued_ms(fn, reps, torch):
    """Device milliseconds per call: ``reps`` calls enqueued behind a
    sleep kernel (~0.1 s), CUDA events from the sleep's end to the last
    call's, so the host's enqueue is not counted (for calls that do not
    wait for the card)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# windows above this many rows are timed with CUDA events (a launch
# outlasts its enqueue), the others with torch.profiler
EVENTS_MIN_ROWS = 2_000_000


def timed_ms(fn, reps, torch, rows):
    """``(ms, method)`` for a call over a window of ``rows`` rows."""
    if rows >= EVENTS_MIN_ROWS:
        return events_ms(fn, reps, torch), "events"
    return profiled_ms(fn, reps, torch), "profiler"


def phase_build(torch):
    from lightgbm_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    secs = _cuda.build()
    log(f"[build] seconds={time.perf_counter() - t0:.2f} per_source="
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    for name in secs:
        path = _cuda.BUILD_DIR / f"{name}.ptxas.txt"
        if path.exists():
            for line in path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    # the wrapper's launch plan counts K1's shared memory as hist.cu does
    from lightgbm_tpu_torch.ops.histogram import smem_bytes
    lib = _cuda.library("hist")
    for F, fg, B, bb, ip, tr, st in ((28, 28, 255, 1, 0, 512, 3),
                                     (28, 28, 255, 1, 1, 1024, 2),
                                     (40, 10, 401, 2, 0, 256, 4),
                                     (137, 18, 255, 1, 0, 512, 2),
                                     (137, 35, 255, 1, 1, 512, 2),
                                     (54, 18, 255, 1, 0, 1024, 2)):
        if lib.hist_smem_bytes(F, fg, B, bb, ip, tr, st) != smem_bytes(
                F, fg, B, bb, bool(ip), tr, st):
            raise AssertionError("ops/histogram.py smem_bytes() != "
                                 "csrc/hist.cu layout()")
    # K2: the plan's shared memory is partition.cu's layout, the card
    # holds the blocks per SM the plan assumes, and launches cooperatively
    from lightgbm_tpu_torch.ops import partition as part
    plib = _cuda.library("partition")
    if plib.partition_cooperative(0) != 1:
        raise AssertionError("the card has no cooperative launch")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for cnt, F, bb, pb in ((1, 28, 1, 8), (100_003, 28, 1, 2),
                           (part.resident_capacity(28, 1, 8, sms), 28, 1, 8),
                           (10_500_000, 28, 1, 8), (10_500_000, 28, 1, 0),
                           (50_001, 1000, 2, 8), (70_001, 13, 1, 0),
                           (LTR_ROWS, LTR_FEATURES, 1, 8),
                           (part.resident_capacity(LTR_FEATURES, 1, 8, sms),
                            LTR_FEATURES, 1, 8),
                           (COV_ROWS, COV_FEATURES, 1, 2)):
        plan = part.partition_plan(cnt, F, bb, pb, sms)
        if plib.partition_smem_bytes(plan.rows, F, bb, pb, plan.stages) \
                != plan.smem:
            raise AssertionError("ops/partition.py smem_bytes() != "
                                 "csrc/partition.cu layout()")
        occ = plib.partition_occupancy(bb, 0 if plan.path == "resident"
                                       else 1, plan.threads, plan.smem)
        if occ < plan.per_sm:
            raise AssertionError(f"K2 plan {plan} assumes {plan.per_sm} "
                                 f"blocks per SM, the card holds {occ}")
    log(f"[build] K2 plans: shared memory = partition.cu's layout, "
        f"occupancy as the plan assumes, cooperative launch on {sms} SMs")
    return secs


def _rand_window(torch, dev, S, F, B, gen, hot=False):
    """Random bins (u8 up to 256 bins, else u16) and an f32 (grad, hess)
    payload; ``hot``: 90% of each feature's rows in one bin."""
    rows = torch.randint(0, B, (S, F), generator=gen, device=dev,
                         dtype=torch.int32)
    if hot:
        h = torch.rand((S, F), generator=gen, device=dev) < 0.9
        hb = (torch.arange(F, device=dev, dtype=torch.int32) * 37) % B
        rows = torch.where(h, hb[None, :].expand(S, F), rows)
    rows = rows.to(torch.uint8 if B <= 256 else torch.uint16)
    pay = torch.stack([torch.randn(S, generator=gen, device=dev),
                       torch.rand(S, generator=gen, device=dev)],
                      dim=1).contiguous()
    return rows, pay


def fixed_exponent(amax, cnt):
    """csrc/hist.cu ``fixed_exponent``: the largest k with cnt * amax * 2^k
    <= 2^62 (amax < 2^e by frexp), for a finite float32 ``amax``."""
    e = int(np.frexp(np.float32(amax))[1])
    lc = (cnt - 1).bit_length() if cnt > 1 else 0
    return 62 - lc - e


def emulate_fixed(torch, rows, pay, B, absmax):
    """K1's float-path arithmetic (csrc/hist.cu) in exact int64, on the
    tensors' device: per channel c the scale 2^k of ``fixed_exponent(
    absmax[c], rows)``; each row rounded once to round(pay * 2^k); exact
    sums; one conversion of each sum to the nearest f32, then times 2^-k
    rounded once to f32 (``Scale::to_f32``, exact in float64 before that
    rounding, as ldexpf is past the normal range); NaN for a channel whose
    ``absmax`` is not finite. The kernel must equal it bit for bit."""
    S, F = rows.shape
    am = absmax.float().cpu().numpy()
    fin = [bool(np.isfinite(a)) for a in am]
    ks = [fixed_exponent(a, S) if f else 0 for a, f in zip(am, fin)]
    v = torch.stack([torch.round(pay[:, c].double() * 2.0 ** ks[c])
                     if fin[c] else torch.zeros_like(pay[:, c], dtype=
                                                     torch.float64)
                     for c in range(2)], 1).long()
    b = rows.long()
    keep = b < B
    idx = (torch.arange(F, device=rows.device) * B)[None, :] + b
    out = torch.zeros((F * B, 2), dtype=torch.int64, device=rows.device)
    out.index_add_(0, idx[keep], v[:, None, :].expand(S, F, 2)[keep])
    res = out.reshape(F, B, 2).float()
    for c in range(2):
        res[..., c] = (res[..., c].double() * 2.0 ** -ks[c]).float() \
            if fin[c] else float("nan")
    return res


def hist_f64(torch, rows, pay, B):
    """The exact sums (float64 index_add_) of a float payload's
    histogram."""
    S, F = rows.shape
    b = rows.long()
    keep = b < B
    idx = (torch.arange(F, device=rows.device) * B)[None, :] + b
    out = torch.zeros((F * B, 2), dtype=torch.float64, device=rows.device)
    out.index_add_(0, idx[keep],
                   pay.double()[:, None, :].expand(S, F, 2)[keep])
    return out.reshape(F, B, 2)


# the window ladder of K1 (label, rows, features, bins, hot bin)
K1_LADDER = (("root", None, FEATURES, BINS, False),
             ("1M", 1_000_000, FEATURES, BINS, False),
             ("mid", 100_003, FEATURES, BINS, False),
             ("10k", 10_007, FEATURES, BINS, False),
             ("1k", 1_009, FEATURES, BINS, False),
             ("hot_1M", 1_000_000, FEATURES, BINS, True),
             ("u16", 50_000, 8, 300, False),
             # wide enough in F * B to split the features over blocks
             ("wide_u16", 50_000, 40, 300, False),
             # the widths of train_rank (137 features) and
             # train_multiclass (54): the roots, and windows small enough
             # for the plan's smaller tiles, so that every feature-group
             # count those phases launch runs here (float path: 8, 4 and
             # 3 groups at 137, 3 and 2 at 54; int path: 4 and 2 at 137,
             # 1 at 54)
             ("ltr_root", LTR_ROWS, LTR_FEATURES, BINS, False),
             ("ltr_20k", 20_011, LTR_FEATURES, BINS, False),
             ("ltr_10k", 10_007, LTR_FEATURES, BINS, False),
             ("cov_root", COV_ROWS, COV_FEATURES, BINS, False),
             ("cov_10k", 10_007, COV_FEATURES, BINS, False))


def k1_plan(S, F, B, bin_bytes, int_path, pay_bytes, ops_per_s, num_sms):
    """K1's launch plan for a window and what it costs beyond the bound:
    every feature group's blocks stage whole rows (bins and payload) and
    histogram their ``fg`` features of them, so the window's rows are
    read once per group. ``reread_bound_ms`` is the bound with those
    reads."""
    from lightgbm_tpu_torch.ops.histogram import launch_plan
    plan = launch_plan(S, F, B, bin_bytes, num_sms, int_path)
    groups = -(-F // plan.fg)
    nbytes = groups * S * (F * bin_bytes + pay_bytes) + F * B * 2 * 4
    reread = 1e3 * max(nbytes / HBM_BYTES_PER_S, S * F * 2 / ops_per_s)
    d = dict(fg=plan.fg, groups=groups, tile_rows=plan.tile_rows,
             blocks=plan.nblocks, threads=plan.threads, smem=plan.smem,
             reread_bound_ms=reread)
    return d, (f"plan: {groups} group(s) of {plan.fg} features, "
               f"{plan.tile_rows}-row tiles, {plan.nblocks} x {groups} "
               f"blocks, smem={plan.smem}; rows read {groups}x: "
               f"reread_bound_ms={reread:.5f}")


def phase_k1(torch, dev, root_rows, reps):
    from lightgbm_tpu_torch.ops.histogram import hist_plain, window_hist
    from lightgbm_tpu_torch.ops.partition import partition_window
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for label, S, F, B, hot in K1_LADDER:
        S = S or root_rows
        rows, pay = _rand_window(torch, dev, S, F, B, gen, hot)
        k = window_hist(rows, pay, B, 0, S)
        p = hist_plain(rows, pay, B)
        tol = 1e-5 * pay.abs().sum(dim=0)[None, None, :] + 1e-6
        exact = hist_f64(torch, rows, pay, B)
        err64 = (k.double() - exact).abs()
        plain_err64 = float((p.double() - exact).abs().max())
        if not bool((err64 <= tol).all()):
            raise AssertionError(f"K1 {label}: kernel != the exact sums, "
                                 f"max err {float(err64.max())}")
        # on the hot-bin window the plain f32 version's own rounding (one
        # bin sums 900k rows) exceeds the tolerance: there the kernel is
        # held to the exact sums above and to its emulation below
        err = (k - p).abs()
        if label != "hot_1M" and not bool((err <= tol).all()):
            raise AssertionError(f"K1 {label}: kernel != plain, max err "
                                 f"{float(err.max())}")
        del exact
        k2 = window_hist(rows, pay, B, 0, S)
        if not torch.equal(k, k2):
            raise AssertionError(f"K1 {label}: two launches differ")
        absmax = pay.abs().amax(dim=0)
        if not torch.equal(k, emulate_fixed(torch, rows, pay, B, absmax)):
            raise AssertionError(f"K1 {label}: kernel != its fixed-point "
                                 "emulation")
        # sibling subtraction on a partitioned window: parent - left
        # child (kernel, side 1) against the right child (plain, side 2)
        dst_r = torch.empty_like(rows)
        dst_p = torch.empty_like(pay)
        nl = partition_window(rows, dst_r, pay, dst_p, None, None, 0, S, 0,
                              101, INT_MAX, -1, False)
        left = window_hist(dst_r, dst_p, B, 0, S, nl, 1)
        right_k = window_hist(dst_r, dst_p, B, 0, S, nl, 2)
        n_l = int(nl.item())
        right_p = hist_plain(dst_r[n_l:], dst_p[n_l:], B) \
            if label != "hot_1M" \
            else hist_f64(torch, dst_r[n_l:], dst_p[n_l:], B).float()
        serr = ((k - left) - right_p).abs()
        if not bool((serr <= tol).all()):
            raise AssertionError(f"K1 {label}: parent - child != sibling, "
                                 f"max err {float(serr.max())}")
        if not bool(((right_k - right_p).abs() <= tol).all()):
            raise AssertionError(f"K1 {label}: right-child window != plain")
        # timed as the grower calls it: the tree's amax computed once
        ms, method = timed_ms(
            lambda: window_hist(rows, pay, B, 0, S, pay_absmax=absmax),
            reps, torch, S)
        plain_ms, _ = timed_ms(lambda: hist_plain(rows, pay, B), reps,
                               torch, S)
        flat = (torch.arange(F, device=dev, dtype=torch.int64) * B)[None] \
            + rows.to(torch.int64)
        flat = flat.reshape(-1)
        weights = [pay[:, c].repeat_interleave(F) for c in range(2)]

        def library():
            for w in weights:
                torch.bincount(flat, weights=w, minlength=F * B)

        lib_ms, _ = timed_ms(library, max(3, reps // 3), torch, S)
        bound_ms, bound_by = k1_bound(S, F, rows.element_size(), 8, B,
                                       FP32_OPS_PER_S)
        plan, plan_msg = k1_plan(S, F, B, rows.element_size(), False, 8,
                                 FP32_OPS_PER_S, sms)
        d = dict(shape=label, rows=S, features=F, bins=B, plan=plan,
                 held_to="exact" if label == "hot_1M" else "plain",
                 max_abs_err=float(err.max()),
                 max_abs_err_exact=float(err64.max()),
                 plain_max_abs_err_exact=plain_err64,
                 sibling_max_abs_err=float(serr.max()), ms=ms,
                 method=method, plain_ms=plain_ms, library_ms=lib_ms,
                 bound_ms=bound_ms, bound_by=bound_by)
        if method == "events":
            d["profiler_ms"] = profiled_ms(
                lambda: window_hist(rows, pay, B, 0, S, pay_absmax=absmax),
                reps, torch)
        shapes.append(d)
        log(f"[k1] {label} S={S} F={F} B={B} ms={ms:.5f} ({method}"
            + (f"; profiler {d['profiler_ms']:.5f}" if "profiler_ms" in d
               else "") + f") plain_ms={plain_ms:.5f} library_ms="
            f"{lib_ms:.5f} bound_ms={bound_ms:.5f} max_abs_err vs plain="
            f"{float(err.max()):.3g}, vs exact={float(err64.max()):.3g} "
            f"(plain vs exact={plain_err64:.3g}); = fixed-point emulation, "
            f"bit-identical reruns; {plan_msg}")
        del rows, pay, k, k2, p, dst_r, dst_p, flat, weights, err64
    return shapes


def _quant_pay(torch, dev, S, gen):
    """An int8 [S, 2] payload as the quantized path makes it: random
    gradients and hessians through discretize() with stochastic
    rounding (4 levels)."""
    from lightgbm_tpu_torch.ops.quantize import discretize
    g = torch.randn(S, generator=gen, device=dev)
    h = torch.rand(S, generator=gen, device=dev) * 0.25
    noise = torch.rand((S, 2), generator=gen, device=dev)
    return discretize(g, h, None, 4, noise)[0].contiguous()


def _int_library(torch, rows, pay, B):
    """One PyTorch call for the same function: an integer scatter_add_
    over flat (feature, bin, channel) indices (inputs prepared outside
    the timing)."""
    S, F = rows.shape
    dev = rows.device
    flat = (torch.arange(F, device=dev, dtype=torch.int64) * B)[None] \
        + rows.to(torch.int64)
    idx = (flat[:, :, None] * 2 + torch.arange(2, device=dev)).reshape(-1)
    vals = pay.to(torch.int32)[:, None, :].expand(S, F, 2).reshape(-1)
    out = torch.zeros(F * B * 2, dtype=torch.int32, device=dev)

    def library():
        out.zero_()
        out.scatter_add_(0, idx, vals)
    return library, out


def phase_k1_int(torch, dev, root_rows, reps):
    """K1's int path: bit-exact against its plain version (an integer
    index_add_) and bit-identical on rerun, at the quantized path's
    windows."""
    from lightgbm_tpu_torch.ops.histogram import hist_plain, window_hist
    from lightgbm_tpu_torch.ops.partition import partition_window
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for label, S, F, B, hot in K1_LADDER + (("blocked_127", 150_000, 4, 16,
                                             False),):
        S = S or root_rows
        rows, _ = _rand_window(torch, dev, S, F, B, gen, hot)
        if label == "blocked_127":
            # 127 in both channels, ~95% of the rows in bin 3: a bin sums
            # past 2^24, where an f32 accumulator stops being exact
            hot = torch.rand((S, F), generator=gen, device=dev) < 0.95
            rows = torch.where(hot, torch.full_like(rows, 3), rows)
            pay = torch.full((S, 2), 127, dtype=torch.int8, device=dev)
        else:
            pay = _quant_pay(torch, dev, S, gen)
        k = window_hist(rows, pay, B, 0, S)
        p = hist_plain(rows, pay, B)
        if k.dtype != torch.int32 or not torch.equal(k, p):
            err = int((k.long() - p.long()).abs().max())
            raise AssertionError(f"K1 int {label}: kernel != plain, max "
                                 f"err {err}")
        if not torch.equal(k, window_hist(rows, pay, B, 0, S)):
            raise AssertionError(f"K1 int {label}: two launches differ")
        if label == "blocked_127":
            want = torch.stack([torch.bincount(rows[:, f].long(),
                                               minlength=B)
                                for f in range(F)]) * 127
            if not torch.equal(k.long(), want[..., None].expand(F, B, 2)):
                raise AssertionError("K1 int blocked_127: != 127 x counts")
            if int(k.max()) <= 2 ** 24:
                raise AssertionError("K1 int blocked_127: no sum past 2^24")
        # the children of a partitioned window (sides 1 and 2, n_left on
        # the device) and the exact sibling subtraction
        dst_r, dst_p = torch.empty_like(rows), torch.empty_like(pay)
        nl = partition_window(rows, dst_r, pay, dst_p, None, None, 0, S, 0,
                              B // 2 + 1, INT_MAX, -1, False)
        n_l = int(nl.item())
        left = window_hist(dst_r, dst_p, B, 0, S, nl, 1)
        right = window_hist(dst_r, dst_p, B, 0, S, nl, 2)
        if not (torch.equal(left, hist_plain(dst_r[:n_l], dst_p[:n_l], B))
                and torch.equal(right, hist_plain(dst_r[n_l:], dst_p[n_l:],
                                                  B))
                and torch.equal(k - left, right)):
            raise AssertionError(f"K1 int {label}: child windows or "
                                 "sibling subtraction inexact")
        ms, method = timed_ms(lambda: window_hist(rows, pay, B, 0, S),
                              reps, torch, S)
        plain_ms, _ = timed_ms(lambda: hist_plain(rows, pay, B), reps,
                               torch, S)
        library, lib_out = _int_library(torch, rows, pay, B)
        library()
        if not torch.equal(lib_out.reshape(F, B, 2), k):
            raise AssertionError(f"K1 int {label}: scatter_add_ != kernel")
        lib_ms, _ = timed_ms(library, max(3, reps // 3), torch, S)
        bound_ms, bound_by = k1_bound(S, F, rows.element_size(), 2, B,
                                       INT32_OPS_PER_S)
        plan, plan_msg = k1_plan(S, F, B, rows.element_size(), True, 2,
                                 INT32_OPS_PER_S, sms)
        d = dict(shape=label, rows=S, features=F, bins=B, plan=plan,
                 max_abs_err=0.0,
                 ms=ms, method=method, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        if method == "events":
            d["profiler_ms"] = profiled_ms(
                lambda: window_hist(rows, pay, B, 0, S), reps, torch)
        shapes.append(d)
        log(f"[k1_int] {label} S={S} F={F} B={B} ms={ms:.5f} ({method}"
            + (f"; profiler {d['profiler_ms']:.5f}" if "profiler_ms" in d
               else "") + f") plain_ms={plain_ms:.5f} library_ms="
            f"{lib_ms:.5f} bound_ms={bound_ms:.5f} exact, sides exact, "
            f"bit-identical reruns; {plan_msg}")
        del rows, pay, k, p, dst_r, dst_p, left, right, library, lib_out
    return shapes


# K1's ragged windows over a 300k-row buffer, (start, cnt, side): 1- to
# 33-row windows and odd starts, so that the tile copies have ragged
# heads and tails in both streams, and the children of a split (sides
# 1/2, with n_left = RAGGED_N_LEFT on the device)
RAGGED_ROWS = 300_000
RAGGED_N_LEFT = 777
RAGGED = ((0, 1, 0), (1, 1, 0), (3, 29, 0), (5, 31, 0), (7, 33, 0),
          (11, 1000, 0), (13, 100_003, 0), (17, 2000, 1), (17, 2000, 2),
          (0, RAGGED_ROWS, 0), (19, 70_001, 2))


def phase_k1_ragged(torch, dev):
    """Both paths of K1, at the main path's launch plan, on windows that
    start anywhere (u8 bins at the Higgs width, u16 bins, one feature of
    two bins; 90% of each feature's rows in one bin): the int path equal
    to its plain version, the float path equal bit for bit to its
    fixed-point emulation and within the tolerance of the exact sums,
    reruns identical; then a non-finite gradient makes the gradient
    channel NaN (so it reaches the booster's non-finite guard) and
    leaves the hessian channel finite."""
    from lightgbm_tpu_torch.ops.histogram import hist_plain, window_hist
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n = RAGGED_ROWS
    nl = torch.tensor([RAGGED_N_LEFT], dtype=torch.int32, device=dev)
    for B, F in ((BINS, FEATURES), (300, 9), (2, 1)):
        rows, fpay = _rand_window(torch, dev, n, F, B, gen, hot=True)
        ipay = _quant_pay(torch, dev, n, gen)
        for (start, cnt, side), pay in ((w, p) for w in RAGGED
                                        for p in (fpay, ipay)):
            lo, hi = {0: (start, start + cnt),
                      1: (start, start + RAGGED_N_LEFT),
                      2: (start + RAGGED_N_LEFT, start + cnt)}[side]
            k = window_hist(rows, pay, B, start, cnt, nl, side)
            tag = (f"K1 ragged B={B} F={F} start={start} cnt={cnt} "
                   f"side={side} {pay.dtype}")
            if not torch.equal(k, window_hist(rows, pay, B, start, cnt, nl,
                                              side)):
                raise AssertionError(f"{tag}: two launches differ")
            if pay.dtype == torch.int8:
                if not torch.equal(k, hist_plain(rows[lo:hi], pay[lo:hi],
                                                 B)):
                    raise AssertionError(f"{tag}: kernel != plain")
                continue
            # the wrapper's default scale bound: the amax of the window
            am = pay[start:start + cnt].abs().amax(dim=0)
            if not torch.equal(k, emulate_fixed(torch, rows[lo:hi],
                                                pay[lo:hi], B, am)):
                raise AssertionError(f"{tag}: kernel != its fixed-point "
                                     "emulation")
            exact = hist_f64(torch, rows[lo:hi], pay[lo:hi], B)
            tol = 1e-5 * pay[lo:hi].abs().sum(dim=0) + 1e-6
            if not bool(((k - exact).abs() <= tol).all()):
                raise AssertionError(f"{tag}: kernel != the exact sums")
        log(f"[k1_ragged] B={B} F={F} {rows.dtype}: {len(RAGGED)} windows "
            "(odd starts, 1-33 rows, sides 1/2): int = plain, float = "
            "fixed-point emulation and within tol of the exact sums, "
            "bit-identical reruns")
        del rows, fpay, ipay
    rows, pay = _rand_window(torch, dev, 5000, FEATURES, BINS, gen)
    pay[77, 0] = float("inf")
    k = window_hist(rows, pay, BINS, 0, 5000)
    if not (torch.isnan(k[..., 0]).all()
            and torch.isfinite(k[..., 1]).all()):
        raise AssertionError("K1: a non-finite gradient did not make the "
                             "gradient channel NaN")
    log("[k1_ragged] a non-finite gradient -> NaN gradient channel, "
        "finite hessians")


def _k2_pay(torch, dev, n, kind, gen):
    if kind == "f32":
        return torch.randn((n, 2), generator=gen, device=dev)
    if kind == "int8":
        return _quant_pay(torch, dev, n, gen)
    return None


def _plan_str(plan):
    return (f"{plan.path} blocks={plan.nblocks} rows={plan.rows} "
            f"stages={plan.stages} tiles={plan.tiles} "
            f"threads={plan.threads} smem={plan.smem}")


# K2's cases, (label, rows, features, bins, payload, threshold, timed):
# the main path's ladder (timed), then the edges of both paths. The
# resident capacity ("cap") depends on the row's width and payload.
K2_CASES = (("root", None, FEATURES, BINS, "f32", 127, True),
            ("mid", 100_000, FEATURES, BINS, "f32", 90, True),
            ("ragged", 100_003, FEATURES, BINS, "f32", 200, True),
            ("all_left", 65_537, FEATURES, BINS, "f32", BINS, True),
            ("all_right", 65_537, FEATURES, BINS, "f32", -1, True),
            # u16 rows of 16 bytes and of 18
            ("u16", 70_001, 8, 300, "f32", 150, True),
            ("u16_odd", 70_003, 9, 300, "f32", 150, True),
            # the quantized path's rows: a 2-byte int8 (grad, hess) pair
            ("root_int8", None, FEATURES, BINS, "int8", 127, True),
            ("ragged_int8", 100_003, FEATURES, BINS, "int8", 200, True),
            ("u16_int8", 70_001, 8, 300, "int8", 150, True),
            ("u16_odd_int8", 70_003, 9, 300, "int8", 150, True),
            ("root_none", None, FEATURES, BINS, "none", 127, True),
            # exactly the resident capacity and one row past it
            ("cap", "cap", FEATURES, BINS, "f32", 127, True),
            ("cap+1", "cap+1", FEATURES, BINS, "f32", 127, True),
            ("cap_int8", "cap", FEATURES, BINS, "int8", 127, True),
            ("cap+1_int8", "cap+1", FEATURES, BINS, "int8", 127, True),
            ("cap_none", "cap", FEATURES, BINS, "none", 127, False),
            ("cap+1_none", "cap+1", FEATURES, BINS, "none", 127, False),
            # all-left and all-right on the streaming path
            ("stream_all_left", 1_000_003, FEATURES, BINS, "f32", BINS,
             False),
            ("stream_all_right", 1_000_003, FEATURES, BINS, "int8", -1,
             False),
            ("stream_all_left_none", 1_000_003, FEATURES, BINS, "none",
             BINS, False),
            ("resident_all_right_int8", 65_537, FEATURES, BINS, "int8", -1,
             False),
            ("resident_all_left_none", 65_537, FEATURES, BINS, "none", BINS,
             False),
            # u8 rows of 13 bytes (not a multiple of 4), both paths
            ("u8_13", 70_001, 13, BINS, "none", 100, False),
            ("u8_13_f32", 70_001, 13, BINS, "f32", 100, False),
            ("u8_13_stream", 1_500_001, 13, BINS, "int8", 100, False),
            # wide rows: 1000 u16 bins (2000 bytes), both paths
            ("wide_u16", 5_001, 1000, 300, "f32", 150, False),
            ("wide_u16_stream", 50_001, 1000, 300, "int8", 150, False),
            ("wide_u16_stream_none", 40_001, 1000, 300, "none", 150, False),
            # train_rank's 137-byte rows and train_multiclass's 54-byte
            # rows: the roots (streaming), the resident capacity at 137
            # bytes and one row past it
            ("ltr_root", LTR_ROWS, LTR_FEATURES, BINS, "f32", 127, True),
            ("ltr_root_int8", LTR_ROWS, LTR_FEATURES, BINS, "int8", 127,
             True),
            ("ltr_cap", "cap", LTR_FEATURES, BINS, "f32", 127, True),
            ("ltr_cap+1", "cap+1", LTR_FEATURES, BINS, "f32", 127, True),
            ("cov_root", COV_ROWS, COV_FEATURES, BINS, "f32", 127, True),
            ("cov_root_int8", COV_ROWS, COV_FEATURES, BINS, "int8", 127,
             True),
            ("cov_100k", 100_000, COV_FEATURES, BINS, "f32", 127, True))


def direct_rule(f, thr, nan_bin, dl=True):
    """K2's range rule ``(col, lo, hi, nan_pos, dl)`` of a plain split of
    column ``f`` at threshold bin ``thr``: bins above ``thr`` go right,
    the NaN bin follows ``dl``."""
    return (f, thr + 1, INT_MAX, nan_bin, dl)


def _k2_case(torch, dev, gen, S, F, B, kind, rule, pad):
    """One K2 case: window ``[pad, pad + S)`` of buffers of ``S + 2 * pad``
    rows split by the range rule ``rule`` (``(col, lo, hi, nan_pos,
    dl)``), kernel (twice) and plain on the same inputs; raises unless all
    three agree bit for bit. Returns the inputs, a run closure and the
    left count."""
    from lightgbm_tpu_torch.ops.partition import (partition_plain,
                                                  partition_window)
    n = S + 2 * pad
    rows, _ = _rand_window(torch, dev, n, F, B, gen)
    pay = _k2_pay(torch, dev, n, kind, gen)
    ids = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    outs = []
    for fn in (partition_window, partition_window, partition_plain):
        d = (torch.zeros_like(rows),
             None if pay is None else torch.zeros_like(pay),
             torch.zeros_like(ids))
        nl = fn(rows, d[0], pay, d[1], ids, d[2], pad, S, *rule)
        outs.append((nl,) + d)
    for k, what in ((0, "kernel != plain"), (1, "rerun != plain")):
        if not all(b is None or torch.equal(a, b)
                   for a, b in zip(outs[k], outs[2])):
            raise AssertionError(f"K2 S={S} F={F} start={pad} payload="
                                 f"{kind}: {what}")
    d = outs[0][1:]

    def run(fn):
        return lambda: fn(rows, d[0], pay, d[1], ids, d[2], pad, S, *rule)
    return rows, pay, run, int(outs[2][0].item())


# K2's range rule beyond a plain split, (label, rows, features, bins,
# payload, (lo, hi, nan_pos, dl)): a direct split with a NaN bin, and the
# rules of multi-member EFB bundles (a member's positions [lo, hi], its NaN
# position hi or none, either default direction), on both paths, both
# payloads and u16 rows; column 3 of random bins
K2_RANGE_CASES = (
    ("range_direct_nan", 100_003, FEATURES, BINS, "f32",
     (128, INT_MAX, 7, False)),
    ("range_multi", 100_003, FEATURES, BINS, "f32", (40, 120, -1, True)),
    ("range_multi_nan", 100_003, FEATURES, BINS, "int8",
     (40, 120, 120, True)),
    ("range_multi_nan_dl0", 100_003, FEATURES, BINS, "f32",
     (40, 120, 120, False)),
    ("range_one_position", 100_003, FEATURES, BINS, "int8", (1, 1, 1, False)),
    ("range_multi_stream", 1_500_001, FEATURES, BINS, "f32",
     (40, 120, -1, False)),
    ("range_multi_nan_stream", 1_500_001, FEATURES, BINS, "int8",
     (40, 120, 120, True)),
    ("range_multi_nan_stream_f32", 1_500_001, FEATURES, BINS, "f32",
     (200, 254, 254, False)),
    ("range_direct_nan_stream", 1_500_001, FEATURES, BINS, "int8",
     (201, INT_MAX, 200, True)),
    # a forced split on a member of a multi-member bundle (RangeRules of
    # a member at offset 40 with 82 bins, its last the NaN bin, forced at
    # t = 30: missing rows go right)
    ("range_forced_member", 100_003, FEATURES, BINS, "int8",
     (70, 120, 120, False)),
    ("range_forced_member_stream", 1_500_001, FEATURES, BINS, "f32",
     (70, 120, 120, False)),
    ("range_multi_u16", 70_001, 9, 300, "int8", (100, 280, 280, False)),
    ("range_multi_u16_stream", 2_000_003, 9, 300, "f32",
     (100, 280, -1, True)))


class _Bundle:
    """The fields of a bundling plan that ``RangeRules`` reads."""
    def __init__(self, bundle_of, offset_of, is_direct):
        self.bundle_of = np.asarray(bundle_of)
        self.offset_of = np.asarray(offset_of)
        self.is_direct = np.asarray(is_direct)


# K2's membership rule (categorical splits), (label, rows, features, bins,
# payload, member): a set of a direct column's bins, u8 (B = 255: 32
# bytes of bitset) and u16 (B = 300, a categorical feature of more than
# 256 bins: 38 bytes), a bundled categorical member (4 bins at offset 40:
# positions 40-42 hold its bins 1-3, every other value its bin 0, which is
# in the set), and a set that holds the NaN bin (the last) and bin 0;
# both paths, both payloads; column 3 of random bins
K2_MEMBER_CASES = (
    ("member_u8", 100_003, FEATURES, BINS, "f32", "direct"),
    ("member_u8_int8", 100_003, FEATURES, BINS, "int8", "direct"),
    ("member_u8_stream", 1_500_001, FEATURES, BINS, "int8", "direct"),
    ("member_u8_stream_f32", 1_500_001, FEATURES, BINS, "f32", "direct"),
    ("member_u16", 70_001, 9, 300, "int8", "direct"),
    ("member_u16_stream", 2_000_003, 9, 300, "f32", "direct"),
    ("member_bundled", 100_003, FEATURES, BINS, "f32", "bundled"),
    ("member_bundled_stream", 1_500_001, FEATURES, BINS, "int8",
     "bundled"),
    ("member_nan_bin", 100_003, FEATURES, BINS, "int8", "nan"),
    ("member_nan_bin_stream", 1_500_001, FEATURES, BINS, "f32", "nan"))


def member_rule(torch, dev, gen, B, member):
    """K2's arguments ``(col, lo, hi, nan_pos, dl, bits)`` of a
    categorical split on column 3 with a random set of local bins, made
    by ``RangeRules.bitsets`` as the grower makes them."""
    from lightgbm_tpu_torch.ops.partition import RangeRules
    F = 4
    nb = np.full(F, B, np.int64)
    mask = torch.rand((1, B), generator=gen, device=dev) < 0.4
    if member == "bundled":
        nb[3] = 4
        rules = RangeRules(nb, np.full(F, -1), _Bundle(
            [0, 1, 2, 3], [0, 0, 0, 40], [True, True, True, False]))
        mask[0, :4] = torch.tensor([True, False, True, False], device=dev)
    else:
        rules = RangeRules(nb, np.full(F, -1))
        if member == "nan":
            mask[0, 0] = mask[0, B - 1] = True
    bits = rules.bitsets([3], mask, B)[0]
    return (3, 0, INT_MAX, -1, False, bits)


def _k2_ragged(torch, dev, gen):
    """1 to 33 rows at odd starts, every payload: kernel, rerun and plain
    equal."""
    for kind in ("f32", "int8", "none"):
        for cnt in range(1, 34):
            _k2_case(torch, dev, gen, cnt, FEATURES, BINS, kind,
                     direct_rule(3, 127, -1), 2 * cnt * cnt + 1)
    log("[k2] ragged: 1 to 33 rows at odd starts, f32/int8/no payload: "
        "kernel = rerun = plain")


def _k2_route_pair(torch, dev, gen):
    """The JAX kernel's (L, R) contract through the kernel: route_pair on
    K = 4096, NC = 3 (13-byte rows) equals the same call with the plain
    version forced."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    from lightgbm_tpu_torch.ops.partition import route_pair
    A = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 4096), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    r = torch.rand(4096, generator=gen, device=dev)
    ml, mr = r < 0.35, (r >= 0.35) & (r < 0.9)
    L, R = route_pair(A, ml, mr)
    with plain_kernels():
        Lp, Rp = route_pair(A, ml, mr)
    if not (torch.equal(L, Lp) and torch.equal(R, Rp)):
        raise AssertionError("K2 route_pair: kernel != plain")
    lc, rc = int(ml.sum()), int(mr.sum())
    if not (torch.equal(L[:, :lc], A[:, ml])
            and torch.equal(R[:, 4096 - rc:], A[:, mr])):
        raise AssertionError("K2 route_pair: (L, R) contract broken")
    log(f"[k2] route_pair K=4096 NC=3 (13-byte rows): kernel = plain, "
        f"n_left={lc}, n_right={rc}")


def _alt_plan(cnt, F, bin_bytes, pay_bytes, sms, path, rows, stages,
              threads):
    """A plan other than partition_plan's, for timing the alternatives."""
    from lightgbm_tpu_torch.ops.partition import (PartitionPlan, _per_sm,
                                                  smem_bytes)
    smem = smem_bytes(rows, F, bin_bytes, pay_bytes, stages)
    tiles = -(-cnt // rows)
    per_sm = _per_sm(threads, smem)
    if path == "resident":
        return PartitionPlan(path, tiles, rows, 1, tiles, threads, per_sm,
                             smem)
    return PartitionPlan(path, min(tiles, per_sm * sms), rows, stages,
                         tiles, threads, per_sm, smem)


def phase_k2(torch, dev, root_rows, reps):
    """K2 against its plain version, exact, with a bit-identical rerun, on
    both paths and every payload (K2_CASES, the ragged windows and
    route_pair); the main path's windows timed; then the rejected
    alternatives to the chosen plans, timed beside them."""
    from lightgbm_tpu_torch.ops.partition import (partition_plain,
                                                  partition_plan,
                                                  partition_window,
                                                  resident_capacity)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    paths = set()
    for label, S, F, B, kind, thr, timed in K2_CASES:
        pb = {"f32": 8, "int8": 2, "none": 0}[kind]
        bb = 1 if B <= 256 else 2
        cap = resident_capacity(F, bb, pb, sms)
        S = {None: root_rows, "cap": cap, "cap+1": cap + 1}.get(S, S)
        pad = 1000  # the window sits inside larger buffers
        nan_bin = 7 if label == "mid" else -1
        rows, pay, run, nl = _k2_case(torch, dev, gen, S, F, B, kind,
                                      direct_rule(3, thr, nan_bin), pad)
        plan = partition_plan(S, F, bb, pb, sms)
        paths.add((plan.path, kind))
        want = S if "all_left" in label else 0 if "all_right" in label \
            else None
        if want is not None and nl != want:
            raise AssertionError(f"K2 {label}: n_left={nl}, want {want}")
        msg = (f"[k2] {label} S={S} F={F} {rows.dtype} payload={kind} "
               f"n_left={nl} plan: {_plan_str(plan)}; kernel = rerun = "
               "plain")
        if timed:
            ms, method = timed_ms(run(partition_window), reps, torch, S)
            plain_ms, _ = timed_ms(run(partition_plain), reps, torch, S)
            bound_ms = k2_bound(S, F, bb, pb)
            shapes.append(dict(shape=label, rows=S, features=F, payload=kind,
                               n_left=nl, path=plan.path,
                               plan=plan._asdict(), max_abs_err=0.0, ms=ms,
                               method=method, plain_ms=plain_ms,
                               library_ms=None, bound_ms=bound_ms,
                               bound_by="bytes"))
            msg += (f"; ms={ms:.5f} ({method}) plain_ms={plain_ms:.5f} "
                    f"bound_ms={bound_ms:.5f}")
        log(msg)
        del rows, pay, run
    want_paths = {(p, k) for p in ("resident", "stream")
                  for k in ("f32", "int8", "none")}
    if not want_paths <= paths:
        raise AssertionError(f"K2 cases missed {want_paths - paths}")
    range_paths = set()
    for label, S, F, B, kind, rule in K2_RANGE_CASES:
        pb = {"f32": 8, "int8": 2, "none": 0}[kind]
        bb = 1 if B <= 256 else 2
        rows, pay, run, nl = _k2_case(torch, dev, gen, S, F, B, kind,
                                      (3,) + rule, 1000)
        plan = partition_plan(S, F, bb, pb, sms)
        range_paths.add((plan.path, kind))
        log(f"[k2] {label} S={S} F={F} {rows.dtype} payload={kind} rule "
            f"(lo, hi, nan_pos, dl)={rule} n_left={nl} plan: "
            f"{_plan_str(plan)}; kernel = rerun = plain")
        del rows, pay, run
    want_paths = {(p, k) for p in ("resident", "stream")
                  for k in ("f32", "int8")}
    if not want_paths <= range_paths:
        raise AssertionError(f"K2 range cases missed "
                             f"{want_paths - range_paths}")
    member_paths = set()
    for label, S, F, B, kind, member in K2_MEMBER_CASES:
        pb = {"f32": 8, "int8": 2, "none": 0}[kind]
        bb = 1 if B <= 256 else 2
        rule = member_rule(torch, dev, gen, B, member)
        rows, pay, run, nl = _k2_case(torch, dev, gen, S, F, B, kind, rule,
                                      1000)
        plan = partition_plan(S, F, bb, pb, sms)
        member_paths.add((plan.path, kind))
        log(f"[k2] {label} S={S} F={F} {rows.dtype} payload={kind} "
            f"membership rule ({member}, {rule[5].numel()}-byte bitset) "
            f"n_left={nl} plan: {_plan_str(plan)}; kernel = rerun = plain")
        del rows, pay, run
    if not want_paths <= member_paths:
        raise AssertionError(f"K2 membership cases missed "
                             f"{want_paths - member_paths}")
    _k2_ragged(torch, dev, gen)
    _k2_route_pair(torch, dev, gen)
    return shapes, phase_k2_alternatives(torch, dev, gen, root_rows, reps,
                                         sms)


def phase_k2_alternatives(torch, dev, gen, root_rows, reps, sms):
    """The plans partition_plan rejects, each timed beside the chosen one
    in this call and held to the plain version: at the root, the
    streaming path's other tile sizes and ring depths; at the resident
    capacity and at 100k rows, the streaming path instead of the
    resident one, and fewer threads; at 10k rows, resident slices of
    other sizes and threads. Each alternative is (path, rows or None for
    the chosen plan's, stages, threads)."""
    from lightgbm_tpu_torch.ops.partition import (_launch, partition_plain,
                                                  partition_plan,
                                                  resident_capacity)
    out = []
    for label, S, kind, alts in (
            ("root", root_rows, "f32", (("stream", 1024, 2, 512),
                                        ("stream", 1536, 3, 512),
                                        ("stream", 2048, 2, 256))),
            ("root_int8", root_rows, "int8", (("stream", 1024, 2, 512),
                                              ("stream", 2048, 3, 512))),
            ("cap", "cap", "f32", (("stream", 2048, 2, 512),
                                   ("resident", None, 1, 256))),
            ("100k", 100_000, "f32", (("stream", 2048, 2, 512),
                                      ("resident", None, 1, 256))),
            ("10k", 10_007, "f32", (("resident", 251, 1, 256),
                                    ("resident", 127, 1, 512)))):
        pb = 8 if kind == "f32" else 2
        if S == "cap":
            S = resident_capacity(FEATURES, 1, pb, sms)
        rows, _ = _rand_window(torch, dev, S, FEATURES, BINS, gen)
        pay = _k2_pay(torch, dev, S, kind, gen)
        ids = torch.arange(S, device=dev, dtype=torch.int32)
        d = (torch.empty_like(rows), torch.empty_like(pay),
             torch.empty_like(ids))
        p = (torch.empty_like(rows), torch.empty_like(pay),
             torch.empty_like(ids))
        nl_p = partition_plain(rows, p[0], pay, p[1], ids, p[2], 0, S,
                               *direct_rule(3, 127, -1))
        chosen = partition_plan(S, FEATURES, 1, pb, sms)
        plans = [("chosen", chosen)] + [
            ("alt", _alt_plan(S, FEATURES, 1, pb, sms, path,
                              r or chosen.rows, st, th))
            for path, r, st, th in alts]
        for tag, plan in plans:
            def call(plan=plan):
                return _launch(rows, d[0], pay, d[1], ids, d[2], 0, S,
                               *direct_rule(3, 127, -1), plan)
            nl = call()
            if not (torch.equal(nl, nl_p) and all(
                    torch.equal(a, b) for a, b in zip(d, p))):
                raise AssertionError(f"K2 alternative {_plan_str(plan)}: "
                                     "!= plain")
            ms, method = timed_ms(call, reps, torch, S)
            out.append(dict(window=label, rows=S, payload=kind, choice=tag,
                            plan=plan._asdict(), ms=ms, method=method))
            log(f"[k2_alt] {label} S={S} payload={kind} {tag:6s} "
                f"{_plan_str(plan)}: ms={ms:.5f} ({method}); = plain")
        del rows, pay, ids, d, p
    return out


def phase_bundled_kernels(torch, dev, info, rules, tag, reps,
                          k2_picks=None):
    """K1 (both paths) and K2 (both payloads) at the width of a bundled
    matrix, on its root window (``info.bins_bundled``, ``G`` columns,
    ``B = num_positions``), as the bundled grower calls them: K1 float
    held to the exact sums and to its plain version, K1 int bit-exact,
    both timed beside their plain versions, one PyTorch call and the
    bound; K2 with the range rule of a multi-member bundle's member (and
    of a direct column, if any), on the root (and a 10k-row window),
    kernel = rerun = plain, the root timed; ``k2_picks``, a list of
    ``(name, K2 arguments)``, replaces those rules (the first is timed).
    Times: ``queued_ms`` (CUDA
    events over calls enqueued behind a sleep kernel; plain events for
    ``bincount``, which reads back). Returns rung dicts for the K1, K1
    int and K2 entries of the report."""
    from lightgbm_tpu_torch.ops.histogram import hist_plain, window_hist
    from lightgbm_tpu_torch.ops.partition import (partition_plain,
                                                  partition_plan,
                                                  partition_window)
    bins = info.bins_bundled
    S, G = bins.shape
    B = info.num_positions
    bb = bins.element_size()
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    label = f"{tag}_root"
    out = {}
    # K1, float path
    pay = torch.randn((S, 2), generator=gen, device=dev)
    k = window_hist(bins, pay, B, 0, S)
    tol = 1e-5 * pay.abs().sum(dim=0)[None, None, :] + 1e-6
    err64 = float((k.double() - hist_f64(torch, bins, pay, B)).abs().max())
    p = hist_plain(bins, pay, B)
    err = (k - p).abs()
    if err64 > float(tol.min()) or not bool((err <= tol).all()):
        raise AssertionError(f"K1 {label}: kernel != exact sums ({err64}) "
                             f"or plain ({float(err.max())})")
    if not torch.equal(k, window_hist(bins, pay, B, 0, S)):
        raise AssertionError(f"K1 {label}: two launches differ")
    absmax = pay.abs().amax(dim=0)
    method = "queued"
    ms = queued_ms(
        lambda: window_hist(bins, pay, B, 0, S, pay_absmax=absmax), reps,
        torch)
    plain_ms = queued_ms(lambda: hist_plain(bins, pay, B), reps, torch)
    flat = ((torch.arange(G, device=dev, dtype=torch.int64) * B)[None]
            + bins.to(torch.int64)).reshape(-1)
    weights = [pay[:, c].repeat_interleave(G) for c in range(2)]

    def library():
        for w in weights:
            torch.bincount(flat, weights=w, minlength=G * B)
    # bincount reads its input's maximum back to the host: plain events
    lib_ms = events_ms(library, max(3, reps // 3), torch)
    del flat, weights
    bound_ms, bound_by = k1_bound(S, G, bb, 8, B, FP32_OPS_PER_S)
    plan, plan_msg = k1_plan(S, G, B, bb, False, 8, FP32_OPS_PER_S, sms)
    out["k1"] = dict(shape=label, rows=S, features=G, bins=B, plan=plan,
                     held_to="plain", max_abs_err=float(err.max()),
                     max_abs_err_exact=err64, ms=ms, method=method,
                     plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
    log(f"[k1] {label} S={S} G={G} B={B} ms={ms:.5f} ({method}) plain_ms="
        f"{plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms={bound_ms:.5f} "
        f"max_abs_err vs plain={float(err.max()):.3g}, vs exact="
        f"{err64:.3g}; bit-identical reruns; {plan_msg}")
    del k, p, err
    # K1, int path
    qpay = _quant_pay(torch, dev, S, gen)
    k = window_hist(bins, qpay, B, 0, S)
    if k.dtype != torch.int32 or not torch.equal(k, hist_plain(bins, qpay,
                                                               B)):
        raise AssertionError(f"K1 int {label}: kernel != plain")
    if not torch.equal(k, window_hist(bins, qpay, B, 0, S)):
        raise AssertionError(f"K1 int {label}: two launches differ")
    ms = queued_ms(lambda: window_hist(bins, qpay, B, 0, S), reps, torch)
    plain_ms = queued_ms(lambda: hist_plain(bins, qpay, B), reps, torch)
    lib, lib_out = _int_library(torch, bins, qpay, B)
    lib()
    if not torch.equal(lib_out.reshape(G, B, 2), k):
        raise AssertionError(f"K1 int {label}: scatter_add_ != kernel")
    lib_ms = queued_ms(lib, max(3, reps // 3), torch)
    del lib, lib_out
    bound_ms, bound_by = k1_bound(S, G, bb, 2, B, INT32_OPS_PER_S)
    plan, plan_msg = k1_plan(S, G, B, bb, True, 2, INT32_OPS_PER_S, sms)
    out["k1_int"] = dict(shape=label, rows=S, features=G, bins=B,
                         plan=plan, max_abs_err=0.0, ms=ms, method=method,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    log(f"[k1_int] {label} S={S} G={G} B={B} ms={ms:.5f} ({method}) "
        f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms="
        f"{bound_ms:.5f} exact, bit-identical reruns; {plan_msg}")
    del k
    # K2: a multi-member bundle's member (a NaN one where there is one)
    # and a direct column, split at the middle of their bins
    if k2_picks is None:
        multi = [j for g in info.groups if len(g) > 1 for j in g]
        nan_multi = [j for j in multi if rules.nan[j] >= 0]
        direct = [g[0] for g in info.groups if len(g) == 1]
        k2_picks = []
        for kind_f, f in [("multi", (nan_multi or multi)[0])] \
                + [("direct", j) for j in direct[:1]]:
            # the middle of the member's value bins (its NaN bin is its
            # last), missing rows to the right
            has_nan = rules.nan[f] >= 0
            t = max(0, (int(rules.nb[f]) - 2 - int(has_nan)) // 2)
            k2_picks.append((f"{kind_f} member f={f} t={t}",
                             rules(f, t) + (False,)))
    ids = torch.arange(S, device=dev, dtype=torch.int32)
    out["k2"] = []
    for i, ((kind_f, rule), (kind, pl)) in enumerate(
            (pk, py) for pk in k2_picks
            for py in (("f32", pay), ("int8", qpay))):
        shown = rule[:4] if len(rule) < 6 else \
            f"membership, {rule[5].numel()}-byte bitset"
        for cnt in sorted({S, min(S, 10_007)}, reverse=True):
            res = []
            for fn in (partition_window, partition_window, partition_plain):
                d = (torch.empty_like(bins), torch.empty_like(pl),
                     torch.empty_like(ids))
                nl = fn(bins, d[0], pl, d[1], ids, d[2], 0, cnt, *rule)
                res.append((nl,) + d)
            for j in (0, 1):
                if not all(torch.equal(a[:cnt], b[:cnt])
                           for a, b in zip(res[j], res[2])):
                    raise AssertionError(f"K2 {label} {kind_f} {kind} "
                                         f"{cnt} rows: != plain")
            pb = 2 * pl.element_size()
            kp = partition_plan(cnt, G, bb, pb, sms)
            msg = (f"[k2] {label} {kind_f} rule {shown} rows={cnt} "
                   f"G={G} payload={kind} n_left={int(res[2][0])} plan: "
                   f"{_plan_str(kp)}; kernel = rerun = plain")
            if cnt == S and i < 2:
                d = res[0][1:]

                def call(fn, d=d, pl=pl):
                    return fn(bins, d[0], pl, d[1], ids, d[2], 0, S, *rule)
                ms = queued_ms(lambda: call(partition_window), reps, torch)
                plain_ms = queued_ms(lambda: call(partition_plain), reps,
                                     torch)
                bound_ms = k2_bound(S, G, bb, pb)
                out["k2"].append(dict(
                    shape=f"{label}_{kind}", rows=S, features=G,
                    payload=kind, n_left=int(res[2][0]), path=kp.path,
                    plan=kp._asdict(), rule=str(shown),
                    max_abs_err=0.0, ms=ms, method=method,
                    plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                    bound_by="bytes"))
                msg += (f"; ms={ms:.5f} ({method}) plain_ms={plain_ms:.5f} "
                        f"bound_ms={bound_ms:.5f}")
            log(msg)
            del res
    del pay, qpay, ids
    return out


def replay_splits(tree, used, nan_bins):
    """The partitions of a trained tree as the grower made them, in node
    (split) order: node i's window ``[begin, begin + cnt)`` of the
    partitioned row order in buffer ``src`` (its depth's parity: the root
    reads buffer 0 and writes buffer 1), its inner feature, threshold bin,
    default direction and NaN bin, and the tree's left-child count. A
    child's node index is above its parent's, so parents come first."""
    inner = {int(r): i for i, r in enumerate(used)}

    def count(c):
        return int(tree.internal_count[c]) if c >= 0 \
            else int(tree.leaf_count[~c])
    begin, depth, out = {0: 0}, {0: 0}, []
    for i in range(tree.num_leaves - 1):
        lc, rc = int(tree.left_child[i]), int(tree.right_child[i])
        nl = count(lc)
        for c, b in ((lc, begin[i]), (rc, begin[i] + nl)):
            if c >= 0:
                begin[c], depth[c] = b, depth[i] + 1
        f = inner[int(tree.split_feature[i])]
        out.append(dict(src=depth[i] % 2, begin=begin[i], cnt=count(i), f=f,
                        t=int(tree.threshold_bin[i]),
                        dl=bool(int(tree.decision_type[i]) & 2),
                        nan_bin=int(nan_bins[f]), n_left=nl))
    return out


# the replay's window-size buckets (rows)
K2_BUCKETS = ((">2M", 2_000_000, None), ("750k-2M", 750_000, 2_000_000),
              ("90k-750k", 90_000, 750_000), ("<90k", 0, 90_000))
# a sleep kernel of this many cycles (~0.1 s) holds the stream while the
# host enqueues a whole replay, so CUDA events between its windows time
# the device alone
SLEEP_CYCLES = 200_000_000


def load_parent(path):
    """Another copy of the port's package (the parent commit's, for a
    before/after), imported under another name; it builds its own
    ``csrc/`` into its own ``_build/``. Returns a function that imports
    one of its modules (``"ops.histogram"``, ``"ops.partition"``)."""
    import importlib
    import importlib.util
    name = "port_parent_pkg"
    path = os.path.abspath(path)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return lambda module: importlib.import_module(f"{name}.{module}")


def split_call(pw):
    """A K2 wrapper ``pw`` as a function of a plain split's ``(..., begin,
    cnt, f, t, dl, nan_bin)``: by its range rule, or with the arguments
    themselves for a parent's wrapper from before the range rule."""
    if "nan_pos" not in inspect.signature(pw).parameters:
        return pw

    def call(*args):
        *head, f, t, dl, nan_bin = args
        return pw(*head, *direct_rule(f, t, nan_bin, dl))
    return call


def phase_k2_turns(torch, dev, bins, tree, used, nan_bins, reps,
                   parent=None):
    """K2 as the main path sees it: the first trained tree's partitions
    (:func:`replay_splits`) replayed on the training data's device bins
    through the grower's ping-pong buffers, with f32 and int8 payloads
    and row ids. Every n_left must equal the tree's left-child count and
    the final buffers those of the same replay with the plain version.
    Recorded per payload: device ms per tree (torch.profiler, by kernel,
    kernels counted), the calls, the bound, ms per window-size bucket
    (CUDA events between the windows of one replay, enqueued behind a
    sleep kernel), and the root and a 100k-row window alone. With
    ``parent`` (the parent commit's partition module) in turns: parent,
    change, change, parent."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    from lightgbm_tpu_torch.ops.partition import partition_window
    splits = replay_splits(tree, used, nan_bins)
    want = [sp["n_left"] for sp in splits]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    n, F = bins.shape
    bb = bins.element_size()
    impls = [("change", partition_window)]
    if parent is not None:
        impls = [("parent", parent.partition_window),
                 ("change", partition_window),
                 ("change", partition_window),
                 ("parent", parent.partition_window)]
    pays = {"f32": _k2_pay(torch, dev, n, "f32", gen),
            "int8": _k2_pay(torch, dev, n, "int8", gen)}
    ids0 = torch.arange(n, device=dev, dtype=torch.int32)

    def fresh(pay):
        return [(bins.clone(), pay.clone(), ids0.clone()),
                (torch.zeros_like(bins), torch.zeros_like(pay),
                 torch.zeros_like(ids0))]

    def reset(bufs, pay):
        """The tree's first state: buffer 0 the training rows in order
        (buffer 1 is written before it is read)."""
        for a, b in zip(bufs[0], (bins, pay, ids0)):
            a.copy_(b)

    def replay(pw, bufs, nls, after=lambda: None):
        call = split_call(pw)
        for sp in splits:
            s, d = bufs[sp["src"]], bufs[1 - sp["src"]]
            nls.append(call(s[0], d[0], s[1], d[1], s[2], d[2], sp["begin"],
                            sp["cnt"], sp["f"], sp["t"], sp["dl"],
                            sp["nan_bin"]))
            after()

    def run(pw, bufs, pay, nls):
        reset(bufs, pay)
        replay(pw, bufs, nls)

    def check_nls(nls, tag):
        got = torch.cat(nls).cpu().tolist()
        for j in range(0, len(got), len(want)):
            if got[j:j + len(want)] != want:
                raise AssertionError(f"K2 replay {tag}: n_left != the "
                                     "tree's left-child counts")

    def bucket_of(cnt):
        return next(b for b, lo, hi in K2_BUCKETS
                    if cnt > lo and (hi is None or cnt <= hi))
    turns = []
    for kind, pay in pays.items():
        pb = 2 * pay.element_size()
        ref = fresh(pay)
        with plain_kernels():
            nls = []
            run(partition_window, ref, pay, nls)
        check_nls(nls, f"plain {kind}")
        bound = {b: 0.0 for b, _, _ in K2_BUCKETS}
        for sp in splits:
            bound[bucket_of(sp["cnt"])] += k2_bound(sp["cnt"], F, bb, pb)
        for name, pw in impls:
            bufs = fresh(pay)
            nls = []
            run(pw, bufs, pay, nls)
            if not all(torch.equal(a, b) for x, y in zip(bufs, ref)
                       for a, b in zip(x, y)):
                raise AssertionError(f"K2 replay {name} {kind}: final "
                                     "buffers != the plain replay's")
            t = dict(impl=name, payload=kind, splits=len(splits))
            pw.launches = 0
            kernels0 = getattr(pw, "kernels", 0)
            run(pw, bufs, pay, nls)
            t["calls"] = pw.launches
            # kernels per replay: the wrapper's count (the parent's K2
            # launches three per call: count, scan, scatter)
            per_replay = pw.kernels - kernels0 if hasattr(pw, "kernels") \
                else 3 * pw.launches
            # device time by kernel; the resets' copies are not K2's
            by_kernel, counts = {}, {}
            profiled_ms(lambda: run(pw, bufs, pay, nls), 3, torch,
                        by_kernel, counts, expect=per_replay)
            mine = [k for k in by_kernel if not k.startswith("Memcpy")]
            t["replay_ms"] = sum(by_kernel[k] for k in mine)
            t["kernels"] = sum(counts[k] for k in mine)
            t["replay_by_kernel"] = {k[:60]: by_kernel[k] for k in sorted(
                mine, key=lambda k: -by_kernel[k])}
            t["replay_bound_ms"] = sum(bound.values())
            # per window: CUDA events between the windows, all enqueued
            # behind a sleep kernel
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(splits) + 2)]
            it = iter(ev[2:])
            reset(bufs, pay)
            torch.cuda.synchronize()
            ev[0].record()
            torch.cuda._sleep(SLEEP_CYCLES)
            ev[1].record()
            h0 = time.perf_counter()
            replay(pw, bufs, nls, lambda: next(it).record())
            host_ms = 1e3 * (time.perf_counter() - h0)
            torch.cuda.synchronize()
            if ev[0].elapsed_time(ev[1]) < host_ms:
                raise AssertionError("the sleep kernel ended before the "
                                     "host had enqueued the replay")
            per = [ev[j + 1].elapsed_time(ev[j + 2])
                   for j in range(len(splits))]
            t["events_ms"] = sum(per)
            t["buckets"] = {
                b: dict(windows=sum(1 for sp in splits
                                    if bucket_of(sp["cnt"]) == b),
                        rows=sum(sp["cnt"] for sp in splits
                                 if bucket_of(sp["cnt"]) == b),
                        ms=sum(ms for ms, sp in zip(per, splits)
                               if bucket_of(sp["cnt"]) == b),
                        bound_ms=bound[b])
                for b, _, _ in K2_BUCKETS}
            check_nls(nls, f"{name} {kind}")
            # the root, and a 100k-row window, alone, from the first state
            reset(bufs, pay)
            s, d = bufs[0], bufs[1]
            sp = splits[0]
            call = split_call(pw)
            t["root_ms"] = events_ms(
                lambda: call(s[0], d[0], s[1], d[1], s[2], d[2], 0, n,
                             sp["f"], sp["t"], sp["dl"], sp["nan_bin"]),
                reps, torch)
            t["100k_ms"] = profiled_ms(
                lambda: call(s[0], d[0], s[1], d[1], s[2], d[2], 0,
                             min(n, 100_000), sp["f"], sp["t"], sp["dl"],
                             sp["nan_bin"]),
                reps, torch)
            turns.append(t)
            log(f"[k2_turns] {name:6s} {kind:4s} root={t['root_ms']:.5f} "
                f"(events) 100k={t['100k_ms']:.5f} (profiler) replay="
                f"{t['replay_ms']:.4f} ms (profiler) for {len(splits)} "
                f"splits, {t['calls']} calls, {t['kernels']} kernels "
                f"(bound {t['replay_bound_ms']:.4f}); events "
                f"{t['events_ms']:.4f}; by bucket: " + "; ".join(
                    f"{b} {v['windows']}w {v['rows']}r {v['ms']:.4f} "
                    f"(bound {v['bound_ms']:.4f})"
                    for b, v in t["buckets"].items())
                + "; by kernel: " + "; ".join(
                    f"{k} {v:.4f}" for k, v in
                    t["replay_by_kernel"].items()))
            del bufs
        del ref
    log("[k2_turns] every n_left equals the tree's left-child count; "
        "final buffers equal the plain replay's (both payloads)")
    return turns


def _reset_counts():
    from lightgbm_tpu_torch.ops.histogram import window_hist
    from lightgbm_tpu_torch.ops.partition import partition_window
    window_hist.launches = 0
    window_hist.int_launches = 0
    partition_window.launches = 0
    partition_window.kernels = 0
    partition_window.member_launches = 0


def _read_counts():
    from lightgbm_tpu_torch.ops.histogram import window_hist
    from lightgbm_tpu_torch.ops.partition import partition_window
    return dict(hist=window_hist.launches,
                hist_int=window_hist.int_launches,
                partition=partition_window.launches,
                partition_kernels=partition_window.kernels,
                partition_member=partition_window.member_launches)


def binary_scorer(torch, dev, yv):
    """The binary paths' held-out scores: finite [n] probabilities, AUC
    and log loss."""
    from lightgbm_tpu_torch.metrics import auc, binary_logloss
    yv_t = torch.as_tensor(yv, device=dev)

    def score(p):
        if p.shape != (len(yv),) or not np.all(np.isfinite(p)):
            raise AssertionError("predictions are not finite [n] values")
        p_t = torch.as_tensor(p, device=dev)
        return dict(auc=auc(p_t, yv_t), logloss=binary_logloss(p_t, yv_t))
    return score


def _drive(torch, lgb, dev, params, ds, Xv, yv, iters, tag, scorer=None,
           after_warmup=None):
    """Train 1 warm-up + ``iters`` timed iterations through the public
    API with every launch count set to 0 just before and read just
    after; predict the held-out rows, score them (``scorer``: a function
    of the predictions giving a dict of metrics; binary by default) and
    round-trip the model through its text. ``after_warmup(bst)``, which
    launches neither kernel, runs between the warm-up and the timed
    iterations and gives a dict of more results."""
    scorer = scorer or binary_scorer(torch, dev, yv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, num_boost_round=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    extra = {} if after_warmup is None else after_warmup(bst)
    iter_s = []
    for _ in range(iters):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    # every iteration: train() set best_iteration to the warm-up's one
    p = bst.predict(Xv, num_iteration=bst.current_iteration())
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    leaves = [t.num_leaves for t in bst._models]
    metrics = scorer(p)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        p2 = lgb.Booster(model_file=path,
                         params={"device_type": dev.type}).predict(Xv)
    rt = float(np.abs(p2 - p).max())
    if rt > 1e-6:
        raise AssertionError(f"{tag}: save/load round trip moved "
                             f"predictions by {rt}")
    log(f"[{tag}] warmup_s={warm_s:.3f} "
        f"iter_s={[round(s, 4) for s in iter_s]} "
        + (f"median_iter_s={statistics.median(iter_s):.4f} " if iter_s
           else "median_iter_s=none (the warm-up alone) ")
        + f"predict_s={predict_s:.4f} leaves={leaves} "
        f"launches={json.dumps(counts)} peak_mem_bytes={peak} "
        + " ".join(f"{k}={v:.6f}" for k, v in metrics.items())
        + f" roundtrip_max_abs={rt:.3g}")
    return dict(bst=bst, counts=counts, leaves=leaves, iter_s=iter_s,
                warmup_s=warm_s, peak=peak, predict_s=predict_s, **metrics,
                **extra)


def _check_counts(tag, counts, leaves, hist_key):
    """The path's K1 launches (``hist_key``: float or int path) are one
    per leaf (root + one child per split), the other K1 path's none,
    and K2's one per split."""
    other = "hist_int" if hist_key == "hist" else "hist"
    if (counts[hist_key] != sum(leaves) or counts[hist_key] == 0
            or counts[other] != 0 or counts["partition"] == 0
            or counts["partition"] != sum(n - 1 for n in leaves)):
        raise AssertionError(f"{tag}: launch counts {counts} do not match "
                             f"the trees' leaves {leaves}")


def _plain_twin(torch, lgb, dev, params, ds, Xv, yv, rounds, tag,
                scorer=None):
    """The same training with both kernels' plain versions forced: the
    model and its held-out scores (``scorer`` as in :func:`_drive`)."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    scorer = scorer or binary_scorer(torch, dev, yv)
    t0 = time.perf_counter()
    with plain_kernels():
        bst_p = lgb.train(params, ds, num_boost_round=rounds)
        pp = bst_p.predict(Xv)
    plain_s = time.perf_counter() - t0
    m = scorer(pp)
    log(f"[{tag}] plain run: seconds={plain_s:.2f} " + " ".join(
        f"{k}={v:.6f}" for k, v in m.items()))
    return bst_p, m


def exact_float_sums(torch):
    """A context in which the float path's plain histogram sums in
    float64 and rounds each sum once to float32 (the int path is
    unchanged). Float32 atomics over a large window of near-equal
    payloads (every multiclass row's hessian is 1/7 at iteration 0) round
    the same way at every add once the sum is large, and drift far from
    the exact sums, which K1's fixed-point path is held to."""
    import contextlib
    from lightgbm_tpu_torch.ops import histogram

    @contextlib.contextmanager
    def ctx():
        f32 = histogram.hist_plain

        def exact(rows, pay, B):
            if pay.dtype != torch.float32:
                return f32(rows, pay, B)
            return hist_f64(torch, rows, pay, B).float()
        histogram.hist_plain = exact
        try:
            yield
        finally:
            histogram.hist_plain = f32
    return ctx()


def _root_split(bst):
    t = bst._models[0]
    return int(t.split_feature[0]), int(t.threshold_bin[0])


TREE_STRUCTURE = ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "leaf_count",
                  "internal_count")


def _same_structure(a, b):
    return a.num_leaves == b.num_leaves and all(
        np.array_equal(getattr(a, k), getattr(b, k))
        for k in TREE_STRUCTURE)


def phase_train(torch, lgb, dev, n_train, iters, reps, parent):
    """The main path at the Higgs shape (float gradients); then K1 and K2
    in turns on its data and its first tree. ``parent``: a loader of the
    parent commit's modules (:func:`load_parent`) or None."""
    t0 = time.perf_counter()
    X, y, target = make_higgs_like(n_train + VALID_ROWS, FEATURES,
                                   target=True)
    Xt, yt, Xv, yv = X[:n_train], y[:n_train], X[n_train:], y[n_train:]
    log(f"[train] data rows={n_train}+{VALID_ROWS} features={FEATURES} "
        f"gen_s={time.perf_counter() - t0:.2f}")
    params = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
              "learning_rate": 0.1, "verbosity": -1,
              "device_type": dev.type}
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, params={"max_bin": BINS,
                                           "device_type": dev.type})
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    log(f"[train] construct_s={construct_s:.3f}")
    # the cost phase reads this booster's compile events alone: the
    # kernel phases' signatures are forgotten and their events dropped
    from lightgbm_tpu_torch.obs import cost
    cost.drain_compile_events()
    cost.clear_signatures()
    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters, "train")
    r["compile_events"] = cost.drain_compile_events()
    r["signatures"] = cost.signature_counts()
    _check_counts("train", r["counts"], r["leaves"], "hist")
    tree = r["bst"]._models[0]
    wins = replay_windows(tree)
    turns = phase_k1_turns(torch, dev, ds.device_bins(), wins, reps,
                           parent and parent("ops.histogram"))
    k2_turns = phase_k2_turns(torch, dev, ds.device_bins(), tree,
                              ds.used_feature_indices(), ds.feat_nan_bin(),
                              reps, parent and parent("ops.partition"))
    # device events only, for the smoke's time (PERF.md §4)
    prof = profile_iteration(torch, r["bst"], host=False)

    # the same 6 iterations with both kernels' plain versions forced
    bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                             1 + iters, "train")
    auc_p = m_p["auc"]
    r_k, r_p = _root_split(r["bst"]), _root_split(bst_p)
    log(f"[train] root_split kernel={r_k} plain={r_p}")
    if r["auc"] < auc_p - 0.002:
        raise AssertionError(f"AUC {r['auc']} below plain {auc_p} - 0.002")
    if r_k != r_p:
        raise AssertionError("the first tree's root split differs from "
                             "the plain run's")
    model_str = r["bst"].model_to_string()
    del r["bst"], bst_p
    return dict(r, auc_plain=auc_p, construct_s=construct_s, profile=prof,
                model_str=model_str, params=params,
                ds=ds, Xv=Xv, yv=yv, turns=turns, k2_turns=k2_turns,
                Xt=Xt, target=target[:n_train],
                target_valid=target[n_train:])


def phase_train_quant(torch, lgb, dev, tr, iters):
    """Quantized-gradient training on the main path's data and dataset:
    the int path of K1 on every histogram, int8 payload rows in K2."""
    ds, Xv, yv = tr["ds"], tr["Xv"], tr["yv"]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
              "learning_rate": 0.1, "verbosity": -1,
              "use_quantized_grad": True, "num_grad_quant_bins": 4,
              "stochastic_rounding": True, "quant_train_renew_leaf": True,
              "seed": 0, "device_type": dev.type}
    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters, "train_quant")
    _check_counts("train_quant", r["counts"], r["leaves"], "hist_int")
    # no profiled iteration, for the smoke's time (PERF.md §4)
    prof = None

    # the twin: the same seed, so the same rounding draws, and int32
    # histograms that are exact in any order
    bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                             1 + iters, "train_quant")
    auc_p = m_p["auc"]
    a, b = r["bst"]._models[0], bst_p._models[0]
    lv_err = float(np.abs(a.leaf_value - b.leaf_value).max()) \
        if a.num_leaves == b.num_leaves else float("inf")
    same = [int(_same_structure(x, y))
            for x, y in zip(r["bst"]._models, bst_p._models)]
    log(f"[train_quant] root_split kernel={_root_split(r['bst'])} "
        f"plain={_root_split(bst_p)} first-tree leaf value max abs diff="
        f"{lv_err:.3g}, trees identical in structure to the plain run's: "
        f"{same}; float path auc={tr['auc']:.6f}")
    if not _same_structure(a, b) or not np.allclose(
            a.leaf_value, b.leaf_value, rtol=1e-4, atol=1e-5):
        raise AssertionError("train_quant: the first tree differs from the "
                             "plain run's")
    if abs(r["auc"] - auc_p) > 0.002:
        raise AssertionError(f"train_quant: AUC {r['auc']} not within "
                             f"0.002 of the plain run's {auc_p}")
    if r["auc"] < tr["auc"] - 0.01:
        raise AssertionError(f"train_quant: AUC {r['auc']} below the float "
                             f"path's {tr['auc']} - 0.01")
    model_str = r["bst"].model_to_string()
    del r["bst"], bst_p
    return dict(r, auc_plain=auc_p, profile=prof, same_trees=same,
                params=params, model_str=model_str)


# the kill run of the resilience phase: make_higgs_like rows, train's
# parameters, killed by kill@KILL_AT in a subprocess
KILL_ROWS = 100_000
KILL_LEAVES = 63
KILL_AT = 3
KILL_ROUNDS = 5

_KILL_WORKER = """
import sys
import lightgbm_tpu_torch as lgb
from chip_smoke import kill_run
kill_run(lgb, sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
"""


def kill_run(lgb, device_type, rows, rounds, resume_from=None):
    """``rounds`` iterations of train's parameters at ``KILL_LEAVES``
    leaves on ``rows`` rows of make_higgs_like (the resilience phase's
    kill run: in a subprocess
    under ``LIGHTGBM_TPU_CHECKPOINT`` and ``kill@3``, then resumed and
    repeated uninterrupted in process)."""
    X, y = make_higgs_like(rows, FEATURES)
    params = {"objective": "binary", "num_leaves": KILL_LEAVES,
              "max_bin": BINS, "learning_rate": 0.1, "verbosity": -1,
              "device_type": device_type}
    ds = lgb.Dataset(X, label=y, params={"max_bin": BINS,
                                         "device_type": device_type})
    return lgb.train(params, ds, rounds, resume_from=resume_from)


def _faults(spec):
    """``LIGHTGBM_TPU_FAULT_INJECT=spec`` for the enclosed runs."""
    return mock.patch.dict(os.environ, {"LIGHTGBM_TPU_FAULT_INJECT": spec})


class _Recorded:
    """A booster whose ``update`` also records the iteration's telemetry
    event, as the train loop does (for :func:`profile_iteration`)."""

    def __init__(self, bst, rec):
        self.bst, self.rec = bst, rec

    def update(self):
        self.bst.update()
        self.rec.record_iteration(self.bst.current_iteration() - 1)


def _held_trees(tag, text, ref_text, count, exact):
    """The first ``count`` trees of ``text`` against ``ref_text``'s: byte
    for byte (``exact``), else node for node with leaf values within
    1e-6 relative (the CLI's standard). Returns True when byte-equal."""
    got, want = _tree_blocks(text, count), _tree_blocks(ref_text, count)
    if len(got) != count or len(want) != count:
        raise AssertionError(f"{tag}: {len(got)} / {len(want)} trees")
    if got == want:
        return True
    if exact:
        raise AssertionError(f"{tag}: the trees differ from the reference "
                             "run's byte for byte")
    a = _parse_model(text)[:count]
    b = _parse_model(ref_text)[:count]
    for i, (ta, tb) in enumerate(zip(a, b)):
        for key in ("split_feature", "threshold", "left_child",
                    "right_child", "decision_type"):
            if not np.array_equal(ta.get(key), tb.get(key)):
                raise AssertionError(f"{tag}: tree {i} differs in {key}")
        if not np.allclose(ta["leaf_value"], tb["leaf_value"], rtol=1e-6,
                           atol=0):
            raise AssertionError(f"{tag}: tree {i}'s leaf values differ "
                                 "by more than 1e-6 relative")
    return False


def phase_resilience(torch, lgb, dev, tr, trq, iters):
    """Crash recovery, the non-finite guard, the OOM ladder and run
    telemetry on train's Dataset and parameters: a resume byte-equal to
    the uninterrupted trees (quantized and float), skip_tree / clamp /
    raise on injected NaN gradients or hessians, one ``oom@1`` rung, a
    SIGKILLed subprocess resumed in process, and the telemetry stream,
    ``stats``, ``/metrics`` and one profiled iteration with telemetry on.
    K1 and K2 launch throughout; their counts are this path's. The
    resumed runs train ``1 + iters`` iterations (at most 4; the first
    half before the snapshot), train's and train_quant's count."""
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.basic import LightGBMError
    from lightgbm_tpu_torch.obs.export import (MetricsHTTPServer,
                                               parse_openmetrics)
    from lightgbm_tpu_torch.obs.recorder import TelemetryRecorder
    from lightgbm_tpu_torch.resilience import (list_snapshots,
                                               load_latest_snapshot,
                                               restore_booster,
                                               write_snapshot)
    import signal
    import urllib.request
    ds, Xv = tr["ds"], tr["Xv"]
    params, qparams = tr["params"], trq["params"]
    tmp = tempfile.mkdtemp(prefix="resilience_")
    out = {}
    try:
        _reset_counts()
        # the kill run in a subprocess, while the guard runs below
        ck_kill = os.path.join(tmp, "kill")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("LIGHTGBM_TPU_")}
        here = os.path.dirname(os.path.abspath(__file__))
        env.update(LIGHTGBM_TPU_CHECKPOINT=ck_kill,
                   LIGHTGBM_TPU_FAULT_INJECT=f"kill@{KILL_AT}",
                   PYTHONPATH=here)
        kill_log = open(os.path.join(tmp, "kill.log"), "w")
        t_kill = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", _KILL_WORKER, dev.type, str(KILL_ROWS),
             str(KILL_ROUNDS)], cwd=here, env=env, stdout=kill_log,
            stderr=subprocess.STDOUT)
        try:
            # -- the guard ---------------------------------------------
            first = {"float": _tree_blocks(tr["model_str"], 1)[0],
                     "quant": _tree_blocks(trq["model_str"], 1)[0]}
            for tag, p in (("float", params), ("quant", qparams)):
                with _faults("nan_grad@1"):
                    b = lgb.train({**p, "nonfinite_policy": "skip_tree"},
                                  ds, 2)
                leaves = [t.num_leaves for t in b._models]
                pred = b.predict(Xv, num_iteration=2)
                ev = [(e["kind"], e["iteration"], e["action"], e["detail"])
                      for e in b._engine.fault_log]
                log(f"[resilience] skip_tree {tag}: nan_grad@1 leaves="
                    f"{leaves} events={ev}")
                if leaves[1] != 1 or b.current_iteration() != 2:
                    raise AssertionError(f"skip_tree {tag}: tree 1 is not "
                                         "constant")
                if _tree_blocks(b.model_to_string(), 1)[0] != first[tag]:
                    raise AssertionError(f"skip_tree {tag}: tree 0 differs "
                                         "from the uninterrupted run's")
                if not np.all(np.isfinite(pred)):
                    raise AssertionError(f"skip_tree {tag}: predictions "
                                         "are not finite")
                del b
            tpath_c = os.path.join(tmp, "clamp.jsonl")
            with _faults("nan_hess@1"):
                b = lgb.train({**params, "nonfinite_policy": "clamp"}, ds, 2,
                              callbacks=[lgb.telemetry(tpath_c)])
            lv_ok = all(np.all(np.isfinite(t.leaf_value)) for t in b._models)
            faults = [json.loads(line) for line in open(tpath_c)
                      if '"fault"' in line]
            log(f"[resilience] clamp: nan_hess@1 leaves="
                f"{[t.num_leaves for t in b._models]} finite={lv_ok} "
                f"fault lines={[(f['iteration'], f['action'], f['detail']) for f in faults]}")
            if not lv_ok or not any(f["action"] == "clamp" for f in faults):
                raise AssertionError("clamp: a leaf value is not finite or "
                                     "no fault event was recorded")
            del b
            with _faults("nan_grad@1"):
                try:
                    lgb.train(params, ds, 2)
                    raise AssertionError("raise: no LightGBMError")
                except LightGBMError as e:
                    msg = str(e)
            log(f"[resilience] raise: LightGBMError: {msg}")
            if "at iteration 1" not in msg:
                raise AssertionError(f"raise: wrong iteration in {msg!r}")
            # -- the OOM ladder ----------------------------------------
            with _faults("oom@1"):
                b = lgb.train(qparams, ds, 2)
            rungs = [(e["action"], e["detail"]) for e in b._engine.fault_log]
            g = b._engine.grower
            log(f"[resilience] oom@1: rungs={rungs} pool_slots="
                f"{g.cfg.pool_slots} pool misses after the rung="
                f"{g.pool_misses}")
            slots = qparams["num_leaves"] // 2
            if rungs != [(f"histogram pool -> {slots} slots",
                          "RESOURCE_EXHAUSTED in grow; retrying after "
                          "downgrade")] or g.cfg.pool_slots != slots:
                raise AssertionError(f"oom@1: rungs {rungs}")
            _held_trees("oom@1", b.model_to_string(), trq["model_str"], 2,
                        exact=True)
            out["oom_pool_misses"] = g.pool_misses
            del b, g
            t0 = time.perf_counter()
            whole = kill_run(lgb, dev.type, KILL_ROWS, KILL_ROUNDS) \
                .model_to_string()
            whole_s = time.perf_counter() - t0
        except BaseException:
            proc.kill()
            raise
        finally:
            try:
                rc = proc.wait(timeout=600)
            finally:
                kill_log.close()
        kill_s = time.perf_counter() - t_kill
        # -- the kill and resume ---------------------------------------
        rows = list_snapshots(ck_kill)
        log(f"[resilience] kill@{KILL_AT}: subprocess rc={rc} in "
            f"{kill_s:.1f} s, snapshots="
            f"{[(r['iteration'], r['status']) for r in rows]}")
        if rc != -signal.SIGKILL:
            raise AssertionError(
                f"kill: the worker ended with {rc}, not SIGKILL: "
                + open(os.path.join(tmp, "kill.log")).read()[-2000:])
        if [r["iteration"] for r in rows] != list(range(1, KILL_AT + 1)) \
                or any(r["status"] != "ok" for r in rows):
            raise AssertionError(f"kill: snapshots {rows}")
        t0 = time.perf_counter()
        resumed = kill_run(lgb, dev.type, KILL_ROWS, KILL_ROUNDS,
                           resume_from=ck_kill).model_to_string()
        log(f"[resilience] kill: the resume to {KILL_ROUNDS} in "
            f"{time.perf_counter() - t0:.1f} s, the uninterrupted run in "
            f"{whole_s:.1f} s, model texts equal: {resumed == whole}")
        if resumed != whole:
            raise AssertionError("kill: the resumed model differs from the "
                                 "uninterrupted run's")
        # -- resume at the full width ----------------------------------
        total = min(4, 1 + iters)
        half = total // 2
        res = {}
        for tag, p, ref in (("quant", qparams, trq["model_str"]),
                            ("float", params, tr["model_str"])):
            ck = os.path.join(tmp, f"ck_{tag}")
            tpath = os.path.join(tmp, f"{tag}.jsonl")
            rec_s = []
            record = TelemetryRecorder.record_iteration

            def timed_record(self, *a, **kw):
                t = time.perf_counter()
                try:
                    return record(self, *a, **kw)
                finally:
                    rec_s.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            TelemetryRecorder.record_iteration = timed_record
            try:
                t0 = time.perf_counter()
                b2 = lgb.train(p, ds, half,
                               callbacks=[lgb.checkpoint(ck),
                                          lgb.telemetry(tpath)])
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            finally:
                TelemetryRecorder.record_iteration = record
            peak = torch.cuda.max_memory_allocated()
            events = [json.loads(line) for line in open(tpath)]
            its = [e for e in events if e["event"] == "iteration"]
            if [e["tree"]["leaves"] for e in its] != \
                    [t.num_leaves for t in b2._models]:
                raise AssertionError(f"telemetry {tag}: tree.leaves differ "
                                     "from the trees'")
            ev_peak = max(e["hbm"]["peak_bytes_in_use"] for e in its)
            if ev_peak != peak:
                raise AssertionError(
                    f"telemetry {tag}: hbm.peak_bytes_in_use {ev_peak} != "
                    f"max_memory_allocated {peak}")
            for e in its:
                log(f"[resilience] {tag} iteration {e['iteration']} phases "
                    "ms: " + ", ".join(
                        f"{k}={v['total'] * 1e3:.1f} ({v['count']}x)"
                        for k, v in sorted(e["phases"].items())))
            snap_path = sorted(r["path"] for r in list_snapshots(ck))[-1]
            nbytes = os.path.getsize(snap_path)
            t0 = time.perf_counter()
            write_snapshot(os.path.join(tmp, f"again_{tag}"), b2)
            write_ms = (time.perf_counter() - t0) * 1e3
            del b2
            fresh = lgb.Booster(params=p, train_set=ds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_booster(fresh, load_latest_snapshot(ck))
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            del fresh
            t0 = time.perf_counter()
            b4 = lgb.train(p, ds, total, resume_from=ck)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            text = b4.model_to_string(num_iteration=total)
            exact = _held_trees(f"resume {tag}", text, ref, total,
                                exact=(tag == "quant"))
            if not exact:
                # is the float path itself not deterministic?
                again = lgb.train(p, ds, total).model_to_string()
                log("[resilience] float resume not byte-equal; two "
                    "uninterrupted float runs byte-equal: "
                    f"{_tree_blocks(again, total) == _tree_blocks(ref, total)}")
            log(f"[resilience] resume {tag}: {half} + {total - half} "
                "iterations, trees "
                f"{'byte-equal' if exact else 'node for node'} to the "
                f"uninterrupted run's; snapshot {nbytes} bytes, write "
                f"{write_ms:.1f} ms, restore {restore_ms:.1f} ms; the first "
                f"run {first_s:.3f} s, the resume (construct, restore, 2 "
                f"iterations) {resume_s:.3f} s; recorder host ms per "
                f"iteration {[round(s * 1e3, 3) for s in rec_s]}; peak "
                f"{peak}")
            res[tag] = dict(exact=exact, snapshot_bytes=nbytes,
                            write_ms=write_ms, restore_ms=restore_ms,
                            first_s=first_s, resume_s=resume_s,
                            recorder_ms=[s * 1e3 for s in rec_s],
                            tpath=tpath, bst=b4)
            if tag == "quant":
                del res[tag]["bst"], b4
        out["resume"] = res
        # -- telemetry: stats, /metrics, a profiled iteration ----------
        rc = cli.main(["stats", res["float"]["tpath"]])
        if rc != 0:
            raise AssertionError(f"stats exited {rc}")
        server = MetricsHTTPServer(0)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics",
                    timeout=30) as resp:
                scraped = parse_openmetrics(resp.read().decode())
        finally:
            server.close()
        n_it = scraped.get("lightgbm_tpu_iterations_total", {}).get((), 0)
        log(f"[resilience] /metrics: {len(scraped)} samples, "
            f"iterations_total={n_it}")
        # the clamp run's 2 iterations and the two first halves
        if n_it != 2 + 2 * half:
            raise AssertionError("/metrics: the iterations are not counted")
        b4 = res["float"].pop("bst")
        rec = TelemetryRecorder(os.path.join(tmp, "profiled.jsonl"))
        rec.attach(b4)
        try:
            prof = profile_iteration(torch, _Recorded(b4, rec), host=False)
        finally:
            rec.close()
        want = tr["profile"]
        log(f"[resilience] profiled iteration with telemetry on: "
            f"{prof['launches']} device events, launch calls "
            f"{json.dumps(prof['launch_calls'])}; train's same iteration "
            f"without telemetry: {want['launches']} device events, "
            f"launch calls {json.dumps(want['launch_calls'])}")
        for name, p in (("with telemetry", prof), ("train's", want)):
            if not p["launch_calls"].get("cudaLaunchKernel"):
                raise AssertionError(f"the profiled iteration {name} "
                                     "recorded no kernel launch calls")
        if not res["float"]["exact"] or total != 1 + iters:
            log("[resilience] launch calls not compared: the resumed "
                "booster's next iteration is not train's profiled one ("
                + ("the float resume is not byte-equal" if
                   not res["float"]["exact"] else
                   f"{total} iterations, train profiled its {1 + iters + 1}"
                   "th") + ")")
        elif prof["launch_calls"] != want["launch_calls"]:
            raise AssertionError("telemetry changes the work an iteration "
                                 "puts on the card")
        out["profile"] = prof
        del b4
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    out["counts"] = _read_counts()
    log(f"[resilience] launches={json.dumps(out['counts'])}")
    return out


def _growth_run(torch, lgb, dev, params, ds, rounds, tag):
    """``rounds`` iterations through ``lgb.train`` with the launch counts
    set to 0 just before and read just after: the booster, its seconds,
    the counts and the grower's read-backs and pool misses per tree."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, num_boost_round=rounds)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _read_counts()
    g = bst._engine.grower
    trees = len(bst._models)
    info = dict(seconds=sec, counts=counts, grower=g.cfg.grower,
                pool_slots=g.cfg.pool_slots,
                readbacks_per_tree=g.readbacks / trees,
                misses_per_tree=g.pool_misses / trees,
                leaves=[t.num_leaves for t in bst._models])
    log(f"[{tag}] {rounds} iterations in {sec:.3f} s grower={g.cfg.grower} "
        f"pool_slots={g.cfg.pool_slots} leaves={info['leaves']} "
        f"readbacks_per_tree={info['readbacks_per_tree']:.1f} "
        f"pool_misses_per_tree={info['misses_per_tree']:.1f} "
        f"launches={json.dumps(counts)}")
    return bst, info


def _same_trees_as(tag, got, want, exact):
    """Trees of ``got`` against the first ones of ``want``: structure
    node for node, leaf values to rtol=1e-4, atol=1e-5. ``exact``: fail
    unless every tree is equal; else return the list of matches."""
    same = [int(_same_structure(a, b) and np.allclose(
        a.leaf_value, b.leaf_value, rtol=1e-4, atol=1e-5))
        for a, b in zip(got, want)]
    log(f"[{tag}] trees equal to the reference run's: {same}")
    if exact and not (len(same) == len(got) and all(same)):
        raise AssertionError(f"{tag}: trees differ from the reference run's")
    return same


def _linear_reference(torch, raw, row_leaf, grad, hess, feats, lam):
    """Every leaf's linear model by a float64 solve of its normal
    equations, built on the device leaf by leaf (rows sorted by leaf,
    one float64 matmul each): ``(const [L] or NaN, coeff list)``; NaN
    where the leaf keeps its constant (too few rows, or not finite)."""
    order = torch.argsort(row_leaf, stable=True)
    counts = torch.bincount(row_leaf, minlength=len(feats)).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)])
    const = np.full(len(feats), np.nan)
    coef = []
    for leaf, f in enumerate(feats):
        rows = order[starts[leaf]:starts[leaf + 1]]
        x = raw[rows][:, f].double() if f else \
            torch.zeros((len(rows), 0), dtype=torch.float64,
                        device=raw.device)
        ok = ~torch.isnan(x).any(dim=1)
        xa = torch.cat([x[ok], torch.ones((int(ok.sum()), 1),
                                          dtype=torch.float64,
                                          device=raw.device)], dim=1)
        h = hess[rows][ok].double()
        g = grad[rows][ok].double()
        coef.append(None)
        if xa.shape[0] < len(f) + 1:
            continue
        A = (xa * h[:, None]).T @ xa + torch.diag(torch.tensor(
            [lam] * len(f) + [0.0], dtype=torch.float64, device=raw.device))
        sol = -torch.linalg.solve(A, xa.T @ g).cpu().numpy()
        if np.all(np.isfinite(sol)):
            const[leaf] = sol[-1]
            coef[-1] = sol[:-1]
    return const, coef


def phase_train_growth(torch, lgb, dev, tr, trq):
    """The growth variants on the main path's data (ROADMAP Queue 1 item
    16): the masked grower's first tree, the histogram pool (16 slots,
    float and quantized, 2 iterations) against ``train``'s and
    ``train_quant``'s trees, linear trees on a second Dataset of the same
    rows (1 + 2 iterations: the fit's ms and peak memory, the second
    tree's models against a float64 solve, the held-out AUC against the
    plain twin, predict against a numpy walk of the model text), and the
    level grower (per-row outputs equal to the compact grower's under
    ``max_depth=7``; at the full budget 1 + 2 iterations, read-backs per
    tree, one profiled iteration, AUC against the plain twin)."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    from lightgbm_tpu_torch.ops.linear import fit_leaf_linear
    ds, Xv, yv = tr["ds"], tr["Xv"], tr["yv"]
    base = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
            "learning_rate": 0.1, "verbosity": -1, "device_type": dev.type}
    train_trees = _model_trees(lgb, dev, tr["model_str"])
    quant_trees = _model_trees(lgb, dev, trq["model_str"])
    score = binary_scorer(torch, dev, yv)
    out = {}

    # ---- the masked grower: train's first tree ----
    bst, out["masked"] = _growth_run(torch, lgb, dev,
                                     {**base, "grower": "masked"}, ds, 1,
                                     "train_masked")
    _same_trees_as("train_masked", bst._models, train_trees, exact=True)
    if out["masked"]["counts"]["hist"] != bst._models[0].num_leaves \
            or out["masked"]["counts"]["partition"] != 0:
        raise AssertionError("train_masked: not one K1 pass per leaf")

    # ---- the histogram pool, 16 slots ----
    nb = ds.num_total_bins()
    pool_mb = 16.5 * FEATURES * nb * 8 / 2 ** 20
    bst, out["pool"] = _growth_run(
        torch, lgb, dev, {**base, "histogram_pool_size": pool_mb}, ds, 2,
        "train_pool")
    if out["pool"]["pool_slots"] != 16:
        raise AssertionError("train_pool: the pool does not hold 16 slots")
    same = _same_trees_as("train_pool", bst._models, train_trees,
                          exact=False)
    auc_pool = score(bst.predict(Xv))["auc"]
    auc_train2 = score(lgb.Booster(model_str=tr["model_str"], params={
        "device_type": dev.type}).predict(Xv, num_iteration=2))["auc"]
    roots = [(int(t.split_feature[0]), float(t.threshold[0]))
             for t in (bst._models[0], train_trees[0])]
    log(f"[train_pool] auc={auc_pool:.6f} train's first 2 iterations "
        f"auc={auc_train2:.6f} root splits {roots}")
    # a recomputed float histogram can differ from a cached difference
    # in the last bit (as in the JAX package): the float standard
    if roots[0] != roots[1] or abs(auc_pool - auc_train2) > 0.002:
        raise AssertionError("train_pool: root split or AUC differ from "
                             "train's")
    out["pool"].update(same_trees=same, auc=auc_pool, auc_train=auc_train2)
    bst, out["pool_quant"] = _growth_run(
        torch, lgb, dev, {**trq["params"], "histogram_pool_size": pool_mb},
        ds, 2, "train_pool_quant")
    _same_trees_as("train_pool_quant", bst._models, quant_trees, exact=True)

    # ---- linear trees ----
    t0 = time.perf_counter()
    ds_lin = lgb.Dataset(tr["Xt"], label=ds.get_label(), params={
        "max_bin": BINS, "linear_tree": True, "device_type": dev.type})
    ds_lin.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    lin_params = {**base, "linear_tree": True}
    captured = {}

    def capture(b):
        eng = b._engine
        fit = eng._fit_linear

        def wrapped(arrays, row_leaf, g, h, row_w, is_first):
            if not is_first and "arrays" not in captured:
                captured.update(arrays=arrays, row_leaf=row_leaf.clone(),
                                g=g.clone(), h=h.clone())
            return fit(arrays, row_leaf, g, h, row_w, is_first)
        eng._fit_linear = wrapped
        return {}
    r = _drive(torch, lgb, dev, lin_params, ds_lin, Xv, yv, 2,
               "train_linear", after_warmup=capture)
    lin = r["bst"]
    # the second tree's fit again, timed alone, and its peak memory
    eng = lin._engine
    a, rl = captured["arrays"], captured["row_leaf"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    const, coeff, _, feats = eng._fit_linear(a, rl, captured["g"],
                                             captured["h"], None, False)
    ev1.record()
    torch.cuda.synchronize()
    fit_ms = ev0.elapsed_time(ev1)
    fit_peak = torch.cuda.max_memory_allocated() - before
    kmax = max(len(f) for f in feats)
    ref_c, ref_k = _linear_reference(torch, ds_lin.device_raw(), rl,
                                     captured["g"], captured["h"], feats,
                                     0.0)
    c_np = const.cpu().numpy()
    k_np = coeff.cpu().numpy()
    worst, fitted = 0.0, 0
    for leaf, f in enumerate(feats):
        if np.isnan(ref_c[leaf]):
            continue
        fitted += 1
        want = np.concatenate([ref_k[leaf], [ref_c[leaf]]])
        got = np.concatenate([k_np[leaf, :len(f)], [c_np[leaf]]])
        worst = max(worst, float(np.abs(got - want).max()
                                 / max(np.abs(want).max(), 1e-12)))
    log(f"[train_linear] construct_s={construct_s:.3f} raw_bytes="
        f"{ds_lin.device_raw().numel() * 4} fit_ms={fit_ms:.3f} (CUDA "
        f"events, the second tree's fit) fit_peak_extra_bytes={fit_peak} "
        f"k_max={kmax} leaves fitted={fitted}/{len(feats)} max relative "
        f"error against the float64 solve={worst:.3g}")
    if fitted == 0 or worst > 1e-3:
        raise AssertionError("train_linear: the fit differs from the "
                             "float64 solve")
    text = lin.model_to_string()
    raw = lin.predict(Xv, raw_score=True, num_iteration=3)
    walk = numpy_predict_raw(text, Xv)
    walk_err = float(np.abs(raw - walk).max())
    _, m_p = _plain_twin(torch, lgb, dev, lin_params, ds_lin, Xv, yv, 3,
                         "train_linear")
    log(f"[train_linear] predict against the numpy walk max abs "
        f"{walk_err:.3g}; auc={r['auc']:.6f} plain={m_p['auc']:.6f}; "
        f"train's iter_s={statistics.median(tr['iter_s']):.4f}")
    if walk_err > 1e-5 or abs(r["auc"] - m_p["auc"]) > 0.002:
        raise AssertionError("train_linear: predict or AUC off")
    out["linear"] = dict(counts=r["counts"], iter_s=r["iter_s"],
                         fit_ms=fit_ms, fit_peak=fit_peak,
                         construct_s=construct_s, auc=r["auc"],
                         auc_plain=m_p["auc"], worst=worst)
    del r, lin, eng, captured, ds_lin, a, rl

    # ---- the level grower ----
    bst_l, out["level_d7"] = _growth_run(
        torch, lgb, dev, {**base, "grower": "level", "max_depth": 7}, ds, 1,
        "train_level_d7")
    bst_c, out["compact_d7"] = _growth_run(
        torch, lgb, dev, {**base, "max_depth": 7}, ds, 1, "train_compact_d7")
    # on training rows (a threshold in a range of empty bins splits
    # them the same way, held-out rows maybe not)
    Xs = tr["Xt"][:1_000_000]
    pl = bst_l.predict(Xs, raw_score=True)
    pc = bst_c.predict(Xs, raw_score=True)
    d7 = float(np.abs(pl - pc).max())
    # the same leaves: the share of rows in the compact leaf that holds
    # most of their level leaf's rows. The level grower's totals are its
    # histograms' feature-0 sums, the compact grower's its records', so
    # a near tie can split a small leaf differently (the JAX package's
    # growers too; ROADMAP.md Queue 3)
    ll = bst_l.predict(Xs, pred_leaf=True)[:, 0].astype(np.int64)
    lc = bst_c.predict(Xs, pred_leaf=True)[:, 0].astype(np.int64)
    pairs, cnt = np.unique(ll * 1_000_000 + lc, return_counts=True)
    best = {}
    for pr, c in zip(pairs, cnt):
        best[pr // 1_000_000] = max(best.get(pr // 1_000_000, 0), c)
    agree = sum(best.values()) / len(ll)
    close = float(np.mean(np.abs(pl - pc) <= 1e-5))
    log(f"[train_level_d7] leaves {bst_l._models[0].num_leaves} and "
        f"{bst_c._models[0].num_leaves}; {len(pairs)} (level, compact) leaf "
        f"pairs; rows in the same leaf {agree:.6f}; per-row outputs within "
        f"1e-5 {close:.6f}, max abs {d7:.3g} (1M training rows)")
    out["level_d7"].update(max_abs=d7, agree=agree, close=close)
    if bst_l._models[0].num_leaves != bst_c._models[0].num_leaves \
            or agree < 0.99:
        raise AssertionError("train_level_d7: differs from the compact "
                             "grower under a budget that does not bind")
    lvl_params = {**base, "grower": "level"}
    r = _drive(torch, lgb, dev, lvl_params, ds, Xv, yv, 2, "train_level")
    g = r["bst"]._engine.grower
    rb = g.readbacks / len(r["bst"]._models)
    prof = profile_iteration(torch, r["bst"], host=False)
    _, m_p = _plain_twin(torch, lgb, dev, lvl_params, ds, Xv, yv, 3,
                         "train_level")
    log(f"[train_level] readbacks_per_tree={rb:.1f} (train: one per split "
        f"and the root) launches per iteration="
        f"{json.dumps({k: v / 3 for k, v in r['counts'].items()})} "
        f"median_iter_s={statistics.median(r['iter_s']):.4f} (train's "
        f"{statistics.median(tr['iter_s']):.4f}) auc={r['auc']:.6f} "
        f"plain={m_p['auc']:.6f}")
    if abs(r["auc"] - m_p["auc"]) > 0.002:
        raise AssertionError("train_level: AUC not within 0.002 of the "
                             "plain twin's")
    out["level"] = dict(counts=r["counts"], iter_s=r["iter_s"],
                        readbacks_per_tree=rb, profile=prof, auc=r["auc"],
                        auc_plain=m_p["auc"])
    return out


# the streaming phases' chunk (ingest_chunk_rows)
STREAM_CHUNK = 65_536


def _host_peak(fn):
    """``fn()`` and a bound on the host memory it held at once, by
    tracemalloc (numpy's and Python's allocations; torch's CPU allocator
    is not traced). Tracing pauses inside the mapper loop
    (``_find_chunk_mappers``: ``find_bin`` over every column, in threads
    from 100,000 sampled rows), whose Python runs ~14x slower traced:
    what is live at a pause is carried as a base to the end (a block
    freed later still counts, so the figure is an upper bound), and the
    loop's own temporaries (a block of up to 32 sampled columns, a
    column's find_bin temporaries per thread) are not seen."""
    import tracemalloc
    from lightgbm_tpu_torch import basic
    from lightgbm_tpu_torch.data import ingest
    acc = {"base": 0, "peak": 0}

    def pause():
        cur, pk = tracemalloc.get_traced_memory()
        acc["peak"] = max(acc["peak"], acc["base"] + pk)
        acc["base"] += cur
        tracemalloc.stop()

    orig = ingest._find_chunk_mappers

    def untraced(*args, **kwargs):
        pause()
        try:
            return orig(*args, **kwargs)
        finally:
            tracemalloc.start()

    ingest._find_chunk_mappers = basic._find_chunk_mappers = untraced
    tracemalloc.start()
    try:
        out = fn()
    finally:
        pause()
        ingest._find_chunk_mappers = basic._find_chunk_mappers = orig
    return out, acc["peak"]


def _mapper_seconds(fn):
    """``fn()`` and the wall seconds it spent in the mapper loop
    (``data/ingest.py`` ``_find_chunk_mappers``: ``find_bin`` over every
    column, in threads from 100,000 sampled rows)."""
    from lightgbm_tpu_torch import basic
    from lightgbm_tpu_torch.data import ingest
    orig = ingest._find_chunk_mappers
    acc = [0.0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t0

    ingest._find_chunk_mappers = basic._find_chunk_mappers = timed
    try:
        out = fn()
    finally:
        ingest._find_chunk_mappers = basic._find_chunk_mappers = orig
    return out, acc[0]


def _construct(torch, lgb, dev, data, params, **kw):
    """``Dataset(data, params=...)`` constructed: the Dataset, its
    seconds and its host peak."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds, peak = _host_peak(lambda: lgb.Dataset(
        data, params={**params, "device_type": dev.type}, **kw).construct())
    torch.cuda.synchronize()
    return ds, time.perf_counter() - t0, peak


def _tree_blocks(text, count):
    """The text of the first ``count`` trees of a model text."""
    return [b.split("\nend of trees")[0].strip()
            for b in text.split("\nTree=")[1:count + 1]]


def _same_bins(torch, tag, ds, ref):
    """A streamed Dataset's device bins, mappers and labels equal to
    those of the eager ``ref``; raises otherwise."""
    bins_eq = torch.equal(ds.device_bins(), ref.device_bins())
    maps_eq = [m.to_dict() for m in ds.mappers] == \
        [m.to_dict() for m in ref.mappers]
    lab_eq = np.array_equal(ds.get_label(), ref.get_label())
    if not (bins_eq and maps_eq and lab_eq):
        raise AssertionError(f"{tag}: bins equal {bins_eq}, mappers equal "
                             f"{maps_eq}, labels equal {lab_eq}")


def phase_ingest_higgs(torch, lgb, dev, tr):
    """Streaming ingest at the Higgs shape, on ``train``'s own rows
    (10.5M x 28): an ArrayChunkSource with ingest_chunk_rows=65,536,
    whose device bins must equal the eager Dataset's (torch.equal) with
    equal mappers, trained 1 + 1 iterations with train's params: both
    trees equal train's first two (their model text); then a chunk
    factory that declares no length (the reservoir sample), trained 1 +
    1: AUC within 0.002 of train's at two iterations. Prints
    construct_s, pass1_s, pass2_s and the host peak (tracemalloc) of
    each construct against the float matrix's bytes. Then, when pyarrow
    is installed, the held-out rows as an Arrow table streamed as a
    valid set against train's mappers, equal to the eager valid set."""
    from lightgbm_tpu_torch.data import ArrayChunkSource
    Xt, ref, Xv, yv = tr["Xt"], tr["ds"], tr["Xv"], tr["yv"]
    yt = np.asarray(ref.get_label())
    params = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
              "learning_rate": 0.1, "verbosity": -1,
              "device_type": dev.type}
    dparams = {"max_bin": BINS, "ingest_chunk_rows": STREAM_CHUNK}
    out = {}
    n = len(yt)

    def factory():
        for lo in range(0, n, STREAM_CHUNK):
            yield Xt[lo:lo + STREAM_CHUNK], yt[lo:lo + STREAM_CHUNK]

    score = binary_scorer(torch, dev, yv)
    auc_train = score(lgb.Booster(
        model_str=tr["model_str"], params={"device_type": dev.type})
        .predict(Xv, num_iteration=2))["auc"]
    for tag, data in (("ingest_higgs", ArrayChunkSource(Xt, label=yt)),
                      ("ingest_higgs_reservoir", factory)):
        ds, secs, peak = _construct(torch, lgb, dev, data, dparams)
        st = ds._ingest_stats
        log(f"[{tag}] rows={n} features={Xt.shape[1]} source={st['source']}"
            f" chunks={st['chunks']} chunk_rows={st['chunk_rows']} "
            f"sample_rows={st['sample_rows']} construct_s={secs:.3f} "
            f"pass1_s={st['pass1_s']:.3f} pass2_s={st['pass2_s']:.3f} "
            f"host_peak_bytes={peak} float matrix bytes={Xt.nbytes} "
            f"(peak/matrix {peak / Xt.nbytes:.4f}) host_binned_bytes="
            f"{st['host_binned_bytes']} eager construct_s="
            f"{tr['construct_s']:.3f}")
        if tag == "ingest_higgs":
            _same_bins(torch, tag, ds, ref)
            log(f"[{tag}] device bins torch.equal to the eager Dataset's, "
                "mappers and labels equal")
        else:
            diff = sum(a.to_dict() != b.to_dict()
                       for a, b in zip(ds.mappers, ref.mappers))
            log(f"[{tag}] reservoir mappers differing from the eager "
                f"draw's: {diff} of {len(ref.mappers)}")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=1)
        bst.update()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = _read_counts()
        leaves = [t.num_leaves for t in bst._models]
        _check_counts(tag, counts, leaves, "hist")
        auc = score(bst.predict(Xv, num_iteration=2))["auc"]
        log(f"[{tag}] 1 + 1 iterations {train_s:.3f} s, launches="
            f"{json.dumps(counts)} auc={auc:.6f} train's at two iterations "
            f"{auc_train:.6f}")
        if tag == "ingest_higgs":
            if _tree_blocks(bst.model_to_string(), 2) != \
                    _tree_blocks(tr["model_str"], 2):
                raise AssertionError(f"{tag}: the trees differ from train's "
                                     "first two")
            log(f"[{tag}] both trees equal train's first two (model text)")
        elif abs(auc - auc_train) > 0.002:
            raise AssertionError(f"{tag}: AUC {auc} not within 0.002 of "
                                 f"train's {auc_train}")
        out[tag] = dict(construct_s=secs, pass1_s=st["pass1_s"],
                        pass2_s=st["pass2_s"], host_peak=peak, auc=auc,
                        counts=counts, train_s=train_s)
        del bst, ds
    # Arrow: the held-out rows as a pyarrow Table streamed as a valid set
    # against train's mappers, equal to the eager valid set
    try:
        import pyarrow as pa
    except ImportError:
        log("[ingest_arrow] pyarrow is not installed: not run")
        return out
    from lightgbm_tpu_torch.data import ArrowChunkSource
    table = pa.table({"label": yv, **{f"f{j}": Xv[:, j]
                                      for j in range(Xv.shape[1])}})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    va = ref.create_valid(ArrowChunkSource(
        table, chunk_rows=STREAM_CHUNK, label_column="label")).construct()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ve = ref.create_valid(Xv, label=yv).construct()
    _same_bins(torch, "ingest_arrow", va, ve)
    log(f"[ingest_arrow] pyarrow {pa.__version__}: {len(yv)} rows x "
        f"{Xv.shape[1]} streamed as a valid set in {secs:.3f} s; device "
        "bins, mappers and labels equal to the eager valid set's")
    return out


def phase_ingest_text(torch, lgb, dev, csv, nbytes, rows):
    """Text ingest of the held-out rows as surface_higgs writes them (a
    %.17g CSV of ``rows`` x 28 and a label, ``nbytes`` bytes): eager (the
    whole file parsed, then binned), two_round and
    ingest_chunk_rows=65,536, each with bin_construct_sample_cnt equal
    to the rows, so every mapper sees every row; both streamed
    constructs' device bins, mappers and labels equal to the eager
    one's. Prints MB/s of each (not traced: tracemalloc would slow the
    per-line passes) and the wall seconds of each one's mapper loop
    (``find_bin`` over every column).
    Reduced: rows 10.5M -> 500,000 (the text takes
    time to write)."""
    out = {}
    t_all = time.perf_counter()
    log(f"[ingest_text] the CSV of surface_higgs: {rows} rows, {nbytes} "
        f"bytes; reduced: rows 10500000 -> {rows} (writing the text)")
    base = {"max_bin": BINS, "bin_construct_sample_cnt": rows,
            "device_type": dev.type}
    eager = None
    for tag, extra in (("eager", {}), ("two_round", {"two_round": True}),
                       ("chunked", {"ingest_chunk_rows": STREAM_CHUNK})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds, map_s = _mapper_seconds(lambda: lgb.Dataset(
            csv, params={**base, **extra}).construct())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[ingest_text] {tag}: construct_s={secs:.3f} "
            f"{nbytes / 1e6 / secs:.1f} MB/s mappers_s={map_s:.3f}")
        out[tag] = dict(construct_s=secs, mb_s=nbytes / 1e6 / secs,
                        mappers_s=map_s)
        if eager is None:
            eager = ds
            continue
        _same_bins(torch, f"ingest_text {tag}", ds, eager)
        log(f"[ingest_text] {tag}: device bins, mappers and labels equal "
            "to the eager construct's")
        del ds
    log(f"[ingest_text] seconds {time.perf_counter() - t_all:.1f}")
    return out


def _repeat_trees(text, times, keep=None):
    """A model text whose trees are ``text``'s first ``keep`` (default:
    all) repeated ``times`` times, renumbered (no tree_sizes line: the
    loader does not read it)."""
    head, rest = text.split("\nTree=", 1)
    blocks, tail = rest.split("\nend of trees", 1)
    trees = [b.split("\n", 1)[1].strip("\n")
             for b in ("Tree=" + blocks).split("\nTree=")][:keep]
    head = "\n".join(ln for ln in head.split("\n")
                     if not ln.startswith("tree_sizes="))
    body = "\n\n".join(f"Tree={i}\n{t}"
                       for i, t in enumerate(trees * times))
    return f"{head}\n{body}\n\nend of trees{tail}"


def _latency(torch, fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    q = np.percentile(np.asarray(ts) * 1e3, [50.0, 99.0])
    return float(q[0]), float(q[1])


def phase_serve(torch, lgb, dev, tr):
    """The compiled forest and the micro-batcher on train's model (its
    first 4 trees, of 255 leaves) and on a 100-tree forest of them
    repeated 25 times. Checks: predict_raw on the 500,000 held-out rows within
    1e-6 of a numpy walk of the model text; the 100-tree raw scores 25x
    the 4-tree ones (rtol 1e-5, atol 1e-5); the eager Booster.predict,
    taken before compile(), equal to the compiled output and to the
    predict that compile() routes; after warmup, 200 requests
    of 1-20,000 rows add no padded shape; a MicroBatcher with 8 threads
    of 200 requests of 1-64 rows, every future equal to the direct
    result; a same-layout adopt (iterations 1-2 -> 3-4) whose extra peak
    device memory is at most the largest field + 1 MiB, the old forest
    raising. Prints warmup seconds and buckets, p50/p99 latency by
    rows, device launches of a 1-row call (torch.profiler), rows/s at
    16,384 and the batcher's p50/p99."""
    import threading
    from lightgbm_tpu_torch.serve.batcher import MicroBatcher
    from lightgbm_tpu_torch.serve.compile import compile_forest, padded_shapes
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    text, Xv = _repeat_trees(tr["model_str"], 1, keep=4), tr["Xv"]
    dp = {"device_type": dev.type}
    bst = lgb.Booster(model_str=text, params=dp)
    out = {}
    # the eager answers, taken before compile() routes predict
    eager_raw = bst.predict(Xv, raw_score=True)
    eager = bst.predict(Xv)
    t0 = time.perf_counter()
    cf = bst.compile()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nb = cf.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[serve] compile_s={compile_s:.4f} warmup_s={warm_s:.3f} buckets="
        f"{cf.buckets()} ({nb} touched) trees={cf.num_trees}")
    t0 = time.perf_counter()
    raw = cf.predict_raw(Xv)[:, 0]
    full_s = time.perf_counter() - t0
    err = float(np.abs(raw - numpy_predict_raw(text, Xv)).max())
    same = bst._compiled_forest is cf and \
        np.array_equal(eager_raw, raw) and \
        np.array_equal(eager, cf.predict(Xv)) and \
        np.array_equal(eager, bst.predict(Xv))
    log(f"[serve] {len(Xv)} rows in {full_s:.3f} s: max abs err against the "
        f"numpy walk {err:.3g}; the eager Booster.predict (before "
        f"compile) equal to the compiled output and to the routed "
        f"predict {same}")
    if err > 1e-6 or not same:
        raise AssertionError("serve: compiled predictions are off")
    b100 = lgb.Booster(model_str=_repeat_trees(text, 25), params=dp)
    cf100 = b100.compile()
    cf100.warmup()
    raw100 = cf100.predict_raw(Xv)[:, 0]
    err100 = float(np.abs(raw100 - 25 * raw).max())
    log(f"[serve] 100-tree forest: max abs diff from 25x the 4-tree scores "
        f"{err100:.3g}")
    if not np.allclose(raw100, 25 * raw, rtol=1e-5, atol=1e-5):
        raise AssertionError("serve: the 100-tree scores are not 25x the "
                             "4-tree ones")
    rs = np.random.RandomState(0)
    before = padded_shapes()
    for _ in range(200):
        m = int(rs.randint(1, min(20_001, len(Xv))))
        lo = int(rs.randint(0, len(Xv) - m + 1))
        cf.predict_raw(Xv[lo:lo + m])
    grew = padded_shapes() - before
    log(f"[serve] 200 requests of 1-20,000 rows after warmup: {grew} new "
        "padded shapes")
    if grew:
        raise AssertionError("serve: a request size brought a new shape")
    lat = {}
    forests = ((f"{cf.num_trees}_trees", cf),
               (f"{cf100.num_trees}_trees", cf100))
    for name, f in forests:
        for rows in (1, 16, 256, 4096, 16384):
            X = np.ascontiguousarray(Xv[:rows])
            p50, p99 = _latency(torch, lambda: f.predict_raw(X),
                                50 if rows <= 4096 else 20)
            lat[f"{name}_{rows}"] = dict(p50_ms=p50, p99_ms=p99)
        lat[f"{name}_rows_per_s_16384"] = 16384 / (
            lat[f"{name}_16384"]["p50_ms"] / 1e3)
        log(f"[serve] {name} latency ms (p50/p99) by rows: " + "; ".join(
            f"{r}: {lat[f'{name}_{r}']['p50_ms']:.3f}/"
            f"{lat[f'{name}_{r}']['p99_ms']:.3f}"
            for r in (1, 16, 256, 4096, 16384))
            + f"; rows/s at 16384 {lat[f'{name}_rows_per_s_16384']:.0f}")
    launches = {}
    for name, f in forests:
        x1 = np.ascontiguousarray(Xv[:1])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            f.predict_raw(x1)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
        launches[name] = dict(
            events=sum(e.count for e in ev),
            kernels=sum(e.count for e in ev if "memcpy" not in e.key.lower()
                        and "memset" not in e.key.lower()))
    log(f"[serve] device events of one 1-row predict_raw (torch.profiler): "
        f"{json.dumps(launches)}")
    # the micro-batcher: 8 threads x 200 requests of 1-64 rows
    mb = MicroBatcher(cf)
    bad, reqs = [], []
    lock = threading.Lock()

    def client(seed):
        r = np.random.RandomState(seed)
        for _ in range(200):
            m = int(r.randint(1, 65))
            lo = int(r.randint(0, len(Xv) - m))
            got = mb.submit(Xv[lo:lo + m]).result(timeout=120)
            with lock:
                reqs.append((lo, m, got))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batch_s = time.perf_counter() - t0
    stats = mb.stats()
    mb.close()
    for lo, m, got in reqs:
        if not np.array_equal(got, cf.predict_raw(Xv[lo:lo + m])):
            bad.append((lo, m))
    log(f"[serve] batcher: {len(reqs)} requests from 8 threads in "
        f"{batch_s:.3f} s, {stats['batches_total']} batches, p50 "
        f"{stats['p50_ms']} ms p99 {stats['p99_ms']} ms; futures differing "
        f"from the direct result: {len(bad)}")
    if bad or len(reqs) != 1600:
        raise AssertionError("serve: the batcher's answers are off")
    # a same-layout swap: iterations 1-2, then 3-4 written in place
    cf12 = compile_forest(bst, num_iteration=2)
    largest = max(t.numel() * t.element_size() for t in cf12._stacked
                  if isinstance(t, torch.Tensor))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cf34 = compile_forest(bst, start_iteration=2, num_iteration=2,
                          reuse=cf12)
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - base
    try:
        cf12.predict_raw(Xv[:1])
        raise AssertionError("serve: the adopted forest still predicts")
    except RuntimeError:
        pass
    want34 = compile_forest(bst, start_iteration=2,
                            num_iteration=2).predict_raw(Xv[:10_000])
    ok34 = np.array_equal(cf34.predict_raw(Xv[:10_000]), want34)
    log(f"[serve] same-layout swap (iterations 1-2 -> 3-4) in {swap_s:.4f} "
        f"s: extra peak device bytes {extra}, largest field {largest} "
        f"bytes; the old forest raises; new forest equal to a fresh "
        f"compile {ok34}")
    if extra > largest + 2 ** 20 or not ok34:
        raise AssertionError("serve: the in-place swap is off")
    out.update(compile_s=compile_s, warmup_s=warm_s, buckets=nb,
               max_abs_err=err, latency=lat, launches_1row=launches,
               batcher=stats, swap_extra_bytes=extra, swap_s=swap_s)
    return out


DAEMON_GRACE_S = 30
DAEMON_WAIT_S = 120


def _daemon_start(model, workdir, *flags, env=None):
    """``python -m lightgbm_tpu_torch serve model ...`` on the card, its
    output to a file; returns ``(proc, out_path, t_spawn)``."""
    e = dict(os.environ)
    e["PYTHONPATH"] = REPO + (os.pathsep + e["PYTHONPATH"]
                              if e.get("PYTHONPATH") else "")
    for k in ("LIGHTGBM_TPU_FAULT_INJECT", "LIGHTGBM_TPU_TELEMETRY",
              "LIGHTGBM_TPU_RANK", "LIGHTGBM_TPU_METRICS_PORT"):
        e.pop(k, None)
    e.update(env or {})
    out = os.path.join(workdir, f"daemon{len(os.listdir(workdir))}.out")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "serve", model,
         "--port", "0", "--grace", str(DAEMON_GRACE_S), *flags],
        stdout=open(out, "w"), stderr=subprocess.STDOUT, cwd=REPO, env=e,
        start_new_session=True)
    return proc, out, t0


def _daemon_ready(proc, out, t0):
    """The serve_ready line, the seconds from spawn to it, and the
    daemon's startup seconds by part (its ``startup seconds`` line)."""
    ready = startup = None
    while time.perf_counter() - t0 < DAEMON_WAIT_S:
        with open(out) as fh:
            text = fh.read()
        for ln in text.splitlines():
            if ready is None and ln.startswith('{"event": "serve_ready"'):
                ready = json.loads(ln)
                ready_s = time.perf_counter() - t0
            if "startup seconds " in ln:
                startup = json.loads(ln.split("startup seconds ", 1)[1])
        if ready is not None and startup is not None:
            return ready, ready_s, startup
        if proc.poll() is not None:
            break
        time.sleep(0.02)
    raise AssertionError(f"serve_daemon: no serve_ready line:\n"
                         f"{open(out).read()[-3000:]}")


class _Conn:
    """One JSON-lines connection to a daemon."""

    def __init__(self, port):
        import socket
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=DAEMON_WAIT_S)
        self.fh = self.sock.makefile("rwb")

    def send(self, line):
        self.fh.write(line)
        self.fh.flush()

    def recv(self):
        line = self.fh.readline()
        return json.loads(line) if line else None

    def rpc(self, obj):
        self.send((json.dumps(obj) + "\n").encode())
        rep = self.recv()
        if rep is None:
            raise AssertionError(f"serve_daemon: connection closed on "
                                 f"{str(obj)[:80]}")
        return rep

    def close(self):
        self.sock.close()


def _daemon_stop(procs):
    for proc in procs:
        if proc.poll() is None:
            import signal
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)


def phase_serve_daemon(torch, lgb, dev, tr, serve_lat):
    """The serving daemon in subprocesses on the card (docstring 6k).
    ``serve_lat``: phase_serve's in-process latency, printed beside the
    socket's."""
    import signal
    import threading
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.obs import parse_openmetrics, summarize_events
    from lightgbm_tpu_torch.resilience import faults as port_faults
    from lightgbm_tpu_torch.resilience.publisher import publish_model
    from lightgbm_tpu_torch.serve.compile import compile_forest
    t_phase = time.perf_counter()
    Xv = tr["Xv"]
    dp = {"device_type": dev.type}
    texts = {"m4": _repeat_trees(tr["model_str"], 1, keep=4)}
    texts["m100"] = _repeat_trees(texts["m4"], 25)
    texts["m8"] = _repeat_trees(texts["m4"], 2)
    boosters = {k: lgb.Booster(model_str=t, params=dp)
                for k, t in texts.items()}
    ids = {compile_forest(b).model_id: k for k, b in boosters.items()}
    by_name = {v: k for k, v in ids.items()}
    canary_rows = Xv[-256:]

    def publish(key, name, it=-1, spec=""):
        os.environ["LIGHTGBM_TPU_FAULT_INJECT"] = spec
        try:
            raw = boosters[key].predict(canary_rows, raw_score=True)
            return publish_model(
                texts[key], watch, name, fault_iteration=it,
                backoff_base_sec=0.05,
                canary={"rows": canary_rows.tolist(),
                        "scores": raw.tolist(), "tol": 1e-4})
        finally:
            os.environ.pop("LIGHTGBM_TPU_FAULT_INJECT", None)

    work = tempfile.mkdtemp(prefix="serve_daemon_")
    watch = os.path.join(work, "watch")
    os.makedirs(watch)
    kill_dir = os.path.join(work, "kill")
    os.makedirs(kill_dir)
    telem = os.path.join(work, "serve.jsonl")
    publish("m4", "m0004.txt")
    with open(os.path.join(kill_dir, "m.txt"), "w") as fh:
        fh.write(texts["m4"])
    out = {}
    procs = []
    conns = []
    predicted = [0]
    lock = threading.Lock()
    try:
        a = _daemon_start(watch, work, "--device-type", dev.type,
                          "--telemetry", telem, "--stats-interval", "1",
                          "--watch-interval", "0.2")
        b = _daemon_start(os.path.join(kill_dir, "m.txt"), work,
                          "--device-type", dev.type,
                          env={"LIGHTGBM_TPU_FAULT_INJECT": "serve_kill@5"})
        procs = [a[0], b[0]]
        (ready, ready_s, startup), (ready_b, ready_b_s, startup_b) = \
            _daemon_ready(*a), _daemon_ready(*b)
        for tag, rs_, st in (("A", ready_s, startup),
                             ("serve_kill", ready_b_s, startup_b)):
            rest = rs_ - sum(st.values())
            log(f"[serve_daemon] daemon {tag}: ready {rs_:.3f} s after "
                f"spawn = import torch {st['import_torch_s']:.3f} + CUDA "
                f"context {st['device_s']:.3f} + load "
                f"{st['load_s']:.3f} + compile {st['compile_s']:.3f} + "
                f"warmup {st['warmup_s']:.3f} + the interpreter, imports "
                f"and the rest {rest:.3f}")
        if ids.get(ready["model"]) != "m4":
            raise AssertionError(f"serve_daemon: serving {ready} at start")
        out.update(ready_s=ready_s, startup=startup, ready_kill_s=ready_b_s,
                   startup_kill=startup_b)
        c = _Conn(ready["port"])
        conns.append(c)
        first = c.rpc({"cmd": "stats"})
        if first["recompiles"]["delta"] != 0:
            raise AssertionError(f"serve_daemon: recompiles after warmup "
                                 f"{first['recompiles']}")

        def predict_rpc(conn, X, **extra):
            rep = conn.rpc({"rows": X.tolist(), **extra})
            if "predictions" not in rep:
                raise AssertionError(f"serve_daemon: {rep}")
            with lock:
                predicted[0] += 1
            return rep

        # answers at four sizes, and raw against the numpy walk
        errs = {}
        for rows in (1, 64, 1024, 10_000):
            X = Xv[:rows]
            rep = predict_rpc(c, X)
            raw = predict_rpc(c, X, raw=True)
            e1 = float(np.abs(np.asarray(rep["predictions"])
                              - boosters["m4"].predict(X)).max())
            e2 = float(np.abs(np.asarray(raw["predictions"])
                              - numpy_predict_raw(texts["m4"], X)).max())
            errs[rows] = (e1, e2)
            if e1 > 1e-6 or e2 > 1e-6 or rep["n"] != rows:
                raise AssertionError(f"serve_daemon: {rows} rows off by "
                                     f"{e1:.3g} / raw {e2:.3g}")
        log("[serve_daemon] max abs err against Booster.predict / raw "
            "against the numpy walk, by rows: " + "; ".join(
                f"{r}: {e1:.3g} / {e2:.3g}" for r, (e1, e2) in
                errs.items()))
        # socket latency by rows (lines encoded beforehand), spans
        lat = {}
        for rows, reps in ((1, 40), (64, 40), (1024, 20), (10_000, 8)):
            line = (json.dumps({"rows": Xv[:rows].tolist()}) + "\n"
                    ).encode()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                c.send(line)
                rep = c.recv()
                ts.append(time.perf_counter() - t0)
                if rep is None or rep.get("n") != rows:
                    raise AssertionError(f"serve_daemon: {rep}")
            with lock:
                predicted[0] += reps
            q = np.percentile(np.asarray(ts) * 1e3, [50.0, 99.0])
            lat[rows] = (float(q[0]), float(q[1]))
            for k in range(3):
                predict_rpc(c, Xv[:rows], trace={
                    "trace_id": f"smoke{rows:08d}{k:03d}",
                    "span_id": f"client{rows:010d}"})
        stats = c.rpc({"cmd": "stats"})
        if stats["recompiles"]["delta"] != 0:
            raise AssertionError(f"serve_daemon: a request size brought "
                                 f"a new shape: {stats['recompiles']}")
        n4 = boosters["m4"].num_trees()
        inproc = {r: serve_lat.get(f"{n4}_trees_{r}", {}).get("p50_ms")
                  for r in (1, 16, 256, 4096, 16384)}
        # the host's share of a 10,000-row request: the daemon's JSON
        # parse and float32 matrix, timed here on the same line
        line = (json.dumps({"rows": Xv[:10_000].tolist()}) + "\n").encode()
        t0 = time.perf_counter()
        obj = json.loads(line.decode())
        t1 = time.perf_counter()
        np.asarray(obj["rows"], np.float32)
        t2 = time.perf_counter()
        parse_ms = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        log("[serve_daemon] socket latency ms (p50/p99) by rows: "
            + "; ".join(f"{r}: {p50:.3f}/{p99:.3f}"
                        for r, (p50, p99) in lat.items())
            + f"; rows/s at 10,000 {10_000 / (lat[10_000][0] / 1e3):.0f}"
            + "; serve's in-process p50 ms by rows: " + json.dumps(inproc)
            + f"; recompile delta after warmup "
              f"{stats['recompiles']['delta']}; the 10,000-row line "
              f"({len(line)} bytes) parsed in this process: json.loads "
              f"{parse_ms[0]:.3f} ms, float32 matrix {parse_ms[1]:.3f} ms")
        out.update(latency=lat, rows_per_s_10000=10_000 / (
            lat[10_000][0] / 1e3), parse_ms=parse_ms)
        # the serve_kill daemon: 4 answers, then SIGKILL at the 5th
        kc = _Conn(ready_b["port"])
        conns.append(kc)
        for _ in range(4):
            if kc.rpc({"rows": Xv[:2].tolist()}).get("n") != 2:
                raise AssertionError("serve_daemon: serve_kill daemon")
        kc.send((json.dumps({"rows": Xv[:2].tolist()}) + "\n").encode())
        dead = kc.recv() is None
        rc_b = b[0].wait(timeout=60)
        log(f"[serve_daemon] serve_kill@5: 4 answers, the 5th request "
            f"closed the connection {dead}, exit {rc_b}")
        if not dead or rc_b != -signal.SIGKILL:
            raise AssertionError("serve_daemon: serve_kill@5 did not kill")
        # hot swap to the 100-tree forest under traffic
        slices = [Xv[64 * k:64 * (k + 1)] for k in range(8)]
        want = {key: [bst.predict(x) for x in slices]
                for key, bst in boosters.items()}
        seen, bad = [], []
        stop = threading.Event()

        def client():
            cc = _Conn(ready["port"])
            k = 0
            try:
                while not stop.is_set():
                    rep = cc.rpc({"rows": slices[k % 8].tolist()})
                    t = time.perf_counter()
                    key = ids.get(rep.get("model"))
                    if "predictions" not in rep or key is None or \
                            np.abs(np.asarray(rep["predictions"])
                                   - want[key][k % 8]).max() > 1e-6:
                        bad.append(rep if "predictions" not in rep
                                   else rep.get("model"))
                    else:
                        with lock:
                            predicted[0] += 1
                    seen.append((t, key))
                    k += 1
            finally:
                cc.close()

        th = threading.Thread(target=client)
        th.start()

        def wait_for(key, t_pub, what):
            deadline = time.perf_counter() + 30
            while time.perf_counter() < deadline:
                hit = [t for t, k in list(seen) if k == key and t > t_pub]
                if hit:
                    return hit[0] - t_pub
                time.sleep(0.01)
            raise AssertionError(f"serve_daemon: no reply named {what}")

        time.sleep(0.3)
        t_pub = time.perf_counter()
        publish("m100", "m0100.txt")
        swap_s = wait_for("m100", t_pub, "the 100-tree forest")
        time.sleep(0.5)
        # publish_torn@3: the publisher retries; the torn bytes never serve
        n_ev = len(port_faults.FAULT_EVENTS)
        t_pub = time.perf_counter()
        m8 = publish("m8", "m0200.txt", it=3, spec="publish_torn@3")
        torn_events = [e["kind"] for e in port_faults.FAULT_EVENTS[n_ev:]]
        torn_s = wait_for("m8", t_pub, "the 8-tree forest")
        time.sleep(0.5)
        # publish_poison@4: refused by the canary, m8 keeps serving
        n_ev = len(port_faults.FAULT_EVENTS)
        publish("m4", "m0300.txt", it=4, spec="publish_poison@4")
        poison_events = [e["kind"] for e in port_faults.FAULT_EVENTS[n_ev:]]
        time.sleep(1.5)
        stop.set()
        th.join(timeout=60)
        keys = [k for _, k in seen]
        # once m8 serves, nothing else does: not the torn bytes, not the
        # poisoned publication
        after = keys[keys.index("m8"):] if "m8" in keys else []
        log(f"[serve_daemon] swap under traffic: {len(seen)} replies, "
            f"{len(bad)} bad; publish -> first reply naming the 100-tree "
            f"forest {swap_s:.3f} s; publish_torn@3: publisher events "
            f"{torn_events}, version {m8['sha256'][:12]} served after "
            f"{torn_s:.3f} s; publish_poison@4: publisher events "
            f"{poison_events}, replies after m8 naming another model "
            f"{len(after) - after.count('m8')}; models in reply order "
            f"{[k for i, k in enumerate(keys) if i == 0 or keys[i - 1] != k]}")
        if bad or "m100" not in keys or not after or \
                after.count("m8") != len(after) or \
                torn_events != ["publish_torn"] or \
                poison_events != ["publish_poison"]:
            raise AssertionError(f"serve_daemon: swaps off ({bad[:3]})")
        out.update(swap_s=swap_s, torn_swap_s=torn_s, swap_replies=len(seen))
        # stats, metrics
        st = c.rpc({"cmd": "stats"})
        mt = c.rpc({"cmd": "metrics"})
        fams = parse_openmetrics(mt["metrics"])
        info = list(fams["lightgbm_tpu_serve_model_info"])
        if st["model"] != by_name["m8"] or st["swaps_total"] != 2 or \
                dict(info[0]).get("model") != by_name["m8"] or \
                dict(info[0]).get("sha") != m8["sha256"]:
            raise AssertionError(f"serve_daemon: stats {st} / {info}")
        log(f"[serve_daemon] stats: swaps {st['swaps_total']}, swap "
            f"failures {st['swap_failures']}, requests "
            f"{st['requests_total']}, p50/p99 {st['p50_ms']}/"
            f"{st['p99_ms']} ms, device bytes {st['hbm']}; metrics: "
            f"{len(fams)} samples parse")
        # SIGTERM during 200 pipelined requests on 4 connections
        pipes = [_Conn(ready["port"]) for _ in range(4)]
        conns.extend(pipes)
        for i, pc in enumerate(pipes):
            pc.send(b"".join((json.dumps({"rows": slices[k % 8].tolist()})
                              + "\n").encode() for k in range(50)))
        time.sleep(0.02)
        t_term = time.perf_counter()
        os.kill(a[0].pid, signal.SIGTERM)
        got = {"predictions": 0, "draining": 0, "bad": 0}
        for pc in pipes:
            k = 0
            while True:
                rep = pc.recv()
                if rep is None:
                    break
                if "predictions" in rep and ids.get(rep["model"]) and \
                        np.abs(np.asarray(rep["predictions"]) - want[
                            ids[rep["model"]]][k % 8]).max() <= 1e-6:
                    got["predictions"] += 1
                elif rep.get("draining"):
                    got["draining"] += 1
                else:
                    got["bad"] += 1
                k += 1
        rc_a = a[0].wait(timeout=DAEMON_GRACE_S + 30)
        exit_s = time.perf_counter() - t_term
        predicted[0] += got["predictions"]
        events = [json.loads(ln) for ln in open(telem) if ln.strip()]
        serve = [e for e in events if e.get("event") == "serve"]
        faults = [e for e in events if e.get("event") == "fault"]
        took = max(e["requests_total"] for e in serve)
        uninjected = [e for e in faults if e["kind"] == "swap_failure"
                      and "m0200.txt" not in e["detail"]
                      and "m0300.txt" not in e["detail"]]
        log(f"[serve_daemon] SIGTERM during 200 pipelined requests: "
            f"{got}, exit {rc_a} after {exit_s:.3f} s (grace "
            f"{DAEMON_GRACE_S}); requests the batcher took "
            f"{took}, predictions received "
            f"{predicted[0]}; fault events "
            f"{[(e['kind'], e['action']) for e in faults]}")
        if rc_a != 0 or got["bad"] or exit_s > DAEMON_GRACE_S or \
                took != predicted[0] or uninjected \
                or not any(e["kind"] == "canary_refused" for e in faults):
            raise AssertionError("serve_daemon: the drain or the events "
                                 "are off")
        # the request spans, and `stats` over the telemetry
        spans = {}
        for e in events:
            if e.get("event") == "span" and \
                    e.get("trace_id", "").startswith("smoke"):
                rows = int(e["trace_id"][5:13])
                spans.setdefault(rows, {}).setdefault(
                    e["name"], []).append(e["dur"] * 1e3)
        log("[serve_daemon] request spans, median ms by rows: "
            + json.dumps({r: {n.split("/")[1]: round(
                statistics.median(v), 4) for n, v in sorted(d.items())}
                for r, d in sorted(spans.items())}))
        summ = summarize_events(telem)
        rc_stats = cli.main(["stats", telem])
        log(f"[serve_daemon] stats over the telemetry: exit {rc_stats}, "
            f"{summ['serve_events']} serve events, model "
            f"{summ['serve']['model']}")
        if rc_stats != 0 or summ["serve"]["model"] != by_name["m8"] or \
                len(spans) != 4:
            raise AssertionError("serve_daemon: telemetry is off")
        out.update(spans=spans, drain=got, exit_s=exit_s)
    finally:
        for cc in conns:
            cc.close()
        _daemon_stop(procs)
    log(f"[serve_daemon] seconds {time.perf_counter() - t_phase:.1f}")
    return out


# the pipeline phase (6l): the JAX package's two slow acceptance runs
# (tests/test_pipeline.py and tests/test_fleet.py chaos runs) at the
# main path's width on the card
PIPE_SEED = 7
PIPE_ROUNDS = 5
PIPE_CHUNK = 65_536
PIPE_ROWS_A = 250_000
PIPE_ROWS_B = 100_000
PIPE_PARAM = "publish_backoff_sec=2"
PIPE_WAIT_S = 420
PIPE_FLAGS = ["--generations", "3", "--rounds", str(PIPE_ROUNDS),
              "--features", str(FEATURES), "--num-leaves", str(BINS),
              "--ingest-chunk-rows", str(PIPE_CHUNK),
              "--health-interval", "0.5", "--health-grace", "25",
              "--swap-timeout", "240", "--grace", "10",
              "--param", PIPE_PARAM, "--seed", str(PIPE_SEED)]
PIPE_A = ("rank_kill@7,publish_torn@1,serve_kill@12",
          ["--rows", str(PIPE_ROWS_A), "--request-rate", "15",
           "--request-rows", "4", "--keep-fleet"])
# run B's --swap-timeout is 30 s, not the JAX run's 240: the pipeline
# waits that long for the fleet to swap onto the poisoned generation
# before it looks for the rollback (the refusal is the expected path),
# and 240 s of that wait is most of the phase
PIPE_B = ("store_outage@1,publish_poison@2",
          ["--rows", str(PIPE_ROWS_B), "--swap-timeout", "30",
           "--request-rate", "8",
           "--request-rows", "4", "--replicas", "1", "--max-replicas", "3",
           "--autoscale-up-qps", "15", "--autoscale-down-qps", "6",
           "--spike-rate", "60", "--spike-start", "4",
           "--spike-duration", "12", "--retire-grace", "15",
           "--rollback-grace", "8", "--canary-rows", "8",
           "--publish-keep", "4", "--scrape-interval", "1"])


def _pipeline_twin(lgb, dev, gen, rows, init_model=None):
    """One generation's training in this process, as the pipeline's
    worker trains it: the same drifting data (``_gen_data``), streamed
    through the same chunk source, the same parameters."""
    from lightgbm_tpu_torch import pipeline as pp
    from lightgbm_tpu_torch.data import GeneratorChunkSource
    X, y = pp._gen_data(PIPE_SEED, gen, rows, FEATURES)

    def factory():
        for lo in range(0, len(y), PIPE_CHUNK):
            yield X[lo:lo + PIPE_CHUNK], y[lo:lo + PIPE_CHUNK]

    params = {"objective": "binary", "num_leaves": BINS, "verbosity": -1,
              "ingest_chunk_rows": PIPE_CHUNK, "device_type": dev.type,
              **pp._parse_params([PIPE_PARAM])}
    ds = lgb.Dataset(GeneratorChunkSource(factory, num_rows=len(y),
                                          num_features=FEATURES),
                     params=params)
    return lgb.train(params, ds, num_boost_round=PIPE_ROUNDS,
                     init_model=init_model)


def _ps_matching(tag):
    """The pids of this machine's processes whose command line holds
    ``tag`` (a run's own work directory)."""
    out = subprocess.run(["ps", "-eo", "pid=,args="], capture_output=True,
                         text=True, timeout=60).stdout
    return [int(ln.split(None, 1)[0]) for ln in out.splitlines()
            if tag in ln and int(ln.split(None, 1)[0]) != os.getpid()]


def _stop_run(work, ports, wait_s=40):
    """Shut a run's replicas down through their protocol, wait for the
    run's processes to end, and SIGKILL what is left."""
    import signal
    from lightgbm_tpu_torch.resilience.elastic import replica_rpc
    for port in ports:
        replica_rpc(port, {"cmd": "shutdown"}, timeout=5.0)
    deadline = time.perf_counter() + wait_s
    while _ps_matching(work) and time.perf_counter() < deadline:
        time.sleep(0.2)
    left = _ps_matching(work)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return left


class _RunWatch:
    """A thread that watches one pipeline run from outside: when each
    worker's and replica's log file appears (the supervisors create it
    just before the spawn) and when a replica's serve_ready line lands
    in it, and ``nvidia-smi``'s per-process device memory every 3 s."""

    def __init__(self, work):
        import threading
        self.work = work
        self.first_seen = {}
        self.ready = {}
        self.mem = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        next_smi = 0.0
        while not self._stop.wait(0.05):
            logs = os.path.join(self.work, "logs")
            for sub in (os.listdir(logs) if os.path.isdir(logs) else ()):
                d = os.path.join(logs, sub)
                if not os.path.isdir(d):
                    continue
                for fn in os.listdir(d):
                    key = f"{sub}/{fn}"
                    self.first_seen.setdefault(key, time.time())
                    if sub == "fleet" and key not in self.ready:
                        with open(os.path.join(d, fn), errors="replace") as fh:
                            for ln in fh:
                                if ln.startswith('{"event": "serve_ready"'):
                                    self.ready[key] = (time.time(),
                                                       json.loads(ln))
                                    break
            if time.time() >= next_smi:
                next_smi = time.time() + 3.0
                smi = subprocess.run(
                    ["nvidia-smi",
                     "--query-compute-apps=pid,process_name,used_memory",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60)
                self.mem.append((time.time(), smi.stdout.strip()))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)


def _start_pipeline(work, faults, flags, base_port, dev):
    e = dict(os.environ)
    for k in [k for k in e if k.startswith("LIGHTGBM_TPU_")]:
        del e[k]
    e["PYTHONPATH"] = REPO + (os.pathsep + e["PYTHONPATH"]
                              if e.get("PYTHONPATH") else "")
    e["LIGHTGBM_TPU_FAULT_INJECT"] = faults
    out = os.path.join(os.path.dirname(work),
                       os.path.basename(work) + ".out")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "pipeline",
         "--device-type", dev.type, "--workdir", work,
         "--port", str(base_port), *PIPE_FLAGS, *flags],
        stdout=open(out, "w"), stderr=subprocess.STDOUT, cwd=REPO, env=e,
        start_new_session=True)
    return proc, out


def _jsonl(path):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as fh:
        for ln in fh:
            try:
                out.append(json.loads(ln))
            except ValueError:
                pass
    return out


def _free_base(span):
    """A base port with ``span`` free ports from it (replica r serves on
    base + r)."""
    import socket
    for _ in range(100):
        socks = []
        try:
            s0 = socket.socket()
            socks.append(s0)
            s0.bind(("127.0.0.1", 0))
            base = s0.getsockname()[1]
            for r in range(1, span):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + r))
            return base
        except OSError:
            pass
        finally:
            for s in socks:
                s.close()
    raise AssertionError("pipeline: no free port range")


def _run_pipeline(tag, work, spec, dev, span):
    """One pipeline run to its summary; the run's watch and its output."""
    faults, flags = spec
    base = _free_base(span)
    watch = _RunWatch(work)
    t0 = time.perf_counter()
    proc, out = _start_pipeline(work, faults, flags, base, dev)
    try:
        rc = proc.wait(timeout=PIPE_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    run_s = time.perf_counter() - t0
    watch.stop()
    text = open(out).read()
    if rc != 0:
        _stop_run(work, [base + r for r in range(span)])
        raise AssertionError(f"pipeline {tag}: exit {rc} after "
                             f"{run_s:.1f} s:\n{text[-6000:]}")
    summary = None
    for ln in text.splitlines():
        if ln.startswith('{"event": "pipeline_summary"'):
            summary = json.loads(ln)
    if summary is None:
        raise AssertionError(f"pipeline {tag}: no summary:\n{text[-4000:]}")
    return summary, watch, run_s, [base + r for r in range(span)]


def _generation_times(work, gens):
    """Each generation's supervised seconds (train_start to train_done),
    its iterations' seconds (the ``train/iteration`` spans: each from the
    previous iteration's end, the first from the recorder's start), its
    ingest seconds and its trainer's peak allocated device bytes, from
    the telemetry."""
    events = _jsonl(os.path.join(work, "telemetry", "pipeline.jsonl"))
    start = {e["generation"]: e["time"] for e in events
             if e.get("phase") == "train_start"}
    done = {e["generation"]: e["time"] for e in events
            if e.get("phase") == "train_done"}
    out = {}
    for g in range(gens):
        tel = _jsonl(os.path.join(work, "telemetry", f"train_g{g:04d}.jsonl"))
        its = [e["dur"] for e in tel if e.get("event") == "span"
               and e.get("name") == "train/iteration"]
        ing = [e for e in tel if e.get("event") == "ingest"]
        peak = [e["hbm"].get("peak_bytes_in_use") for e in tel
                if e.get("event") == "iteration"]
        out[g] = dict(
            supervised_s=done[g] - start[g], iterations=len(its),
            median_iter_s=statistics.median(its) if its else None,
            iter_s=[round(s, 4) for s in its],
            ingest_s=[round(e["pass1_s"] + e["pass2_s"], 3) for e in ing],
            peak_bytes=max((b for b in peak if b), default=None))
    return out


def _swap_ends(work, path_suffix):
    """Per replica process, the end (wall clock) of its first swap onto
    the file ending in ``path_suffix``, from the serve telemetry."""
    ends = {}
    tdir = os.path.join(work, "telemetry")
    for fn in os.listdir(tdir):
        if not fn.startswith("serve.jsonl") or fn.endswith(".fleet"):
            continue
        for e in _jsonl(os.path.join(tdir, fn)):
            if e.get("event") == "span" and e.get("name") == "swap/apply" \
                    and str(e["attrs"].get("path", "")).endswith(path_suffix):
                ends.setdefault(e["proc"], e["wall"] + e["dur"])
    return ends


def _mem_table(watch, roles):
    """The nvidia-smi sample with the most processes, its pids named
    where they are this machine's pids."""
    best = max(watch.mem, key=lambda m: len(m[1].splitlines()),
               default=(None, ""))
    rows = []
    for ln in best[1].splitlines():
        parts = [p.strip() for p in ln.split(",")]
        if len(parts) == 3 and parts[0].isdigit():
            rows.append((roles.get(int(parts[0]), "?"), *parts))
    return rows


def _serve_peaks(work):
    """Each replica stream's largest allocated device bytes, from its
    ``{"event": "serve"}`` lines."""
    tdir = os.path.join(work, "telemetry")
    out = {}
    for fn in sorted(os.listdir(tdir)):
        if fn.startswith("serve.jsonl") and not fn.endswith(".fleet"):
            peaks = [(e.get("hbm") or {}).get("peak_bytes_in_use")
                     for e in _jsonl(os.path.join(tdir, fn))
                     if e.get("event") == "serve"]
            out[fn] = max((b for b in peaks if b), default=None)
    return out


def phase_pipeline_start(torch, lgb, dev, card):
    """``python -m lightgbm_tpu_torch pipeline --device-type cuda`` at
    the main path's width (28 features, 255 leaves, binary), run A and
    run B of docstring 6l, with the in-process twins of run A's first
    two generations. ``card``: nvidia-smi's name and power limit,
    printed beside every figure.

    The twins run here; runs A and B run on the lane (:class:`Lane`)
    beside the in-process phases that follow: this returns the phase's
    state and the lane's job, and :func:`phase_pipeline_finish` holds
    the runs once the lane has ended."""
    from lightgbm_tpu_torch.ops import _cuda
    t_phase = time.perf_counter()
    built = {p.name: p.stat().st_mtime_ns
             for p in _cuda.BUILD_DIR.glob("*.so")}
    out = {}

    # the twins: generation 0, and generation 1 continued from it
    # (through the model text, as the worker loads it), launches counted
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    twin0 = _pipeline_twin(lgb, dev, 0, PIPE_ROWS_A)
    text0 = twin0.model_to_string()
    twin1 = _pipeline_twin(lgb, dev, 1, PIPE_ROWS_A, init_model=lgb.Booster(
        model_str=text0, params={"device_type": dev.type}))
    text1 = twin1.model_to_string()
    torch.cuda.synchronize()
    counts = _read_counts()
    twin_s = time.perf_counter() - t0
    leaves = [t.num_leaves for t in twin0._models] + \
        [t.num_leaves for t in twin1._models[PIPE_ROUNDS:]]
    _check_counts("pipeline twins", counts, leaves, "hist")
    out["counts"] = counts
    log(f"[pipeline] in-process twins of run A's generations 0 and 1 "
        f"({PIPE_ROWS_A:,} rows x {FEATURES}, {BINS} leaves, "
        f"{PIPE_ROUNDS} + {PIPE_ROUNDS} trees): {twin_s:.2f} s, "
        f"leaves={leaves} launches={json.dumps(counts)} ({card})")

    root = tempfile.mkdtemp(prefix="pipeline_")
    pipe = dict(out=out, root=root, twins_s=time.perf_counter() - t_phase)

    def job():
        _pipeline_runs(dev, card, root, text0, text1, built, out)
    return pipe, job


def phase_pipeline_finish(lgb, dev, pipe, lane, card):
    """Hold the pipeline's runs A and B (:func:`phase_pipeline_start`),
    once ``lane`` has ended: run A's replies against this process's
    predictions, and the phase's seconds."""
    if lane.error is not None:
        raise lane.error
    out = pipe["out"]
    _pipeline_replies(lgb, dev, *out.pop("A_replies"))
    out["phase_s"] = pipe["twins_s"] + out["runs_s"]
    log(f"[pipeline] seconds {out['phase_s']:.1f}: the twins "
        f"{pipe['twins_s']:.1f} s, then runs A and B {out['runs_s']:.1f} s "
        f"on the lane, beside the phases that followed ({card})")
    return out


class Lane:
    """Jobs run one after the other on a thread of their own, beside the
    in-process phases: the pipeline's runs and the examples' CLI
    processes, which wait on process starts and the clock rather than on
    this process. A job runs nothing on the card in this process (a
    profiled window of a phase beside it would count its kernels).
    :meth:`join` waits for the jobs and raises what one raised;
    :meth:`stop` kills the processes of a lane still running."""

    def __init__(self, jobs, roots, clis):
        import threading
        self.jobs = jobs
        # the work directories the jobs' processes name in their command
        # lines, and the CLI runs they started (start_clis)
        self.roots = roots
        self.clis = clis
        self.error = None
        self.stopped = False
        self.seconds = {}
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, name="lane",
                                       daemon=True)
        self.thread.start()

    def _run(self):
        for name, job in self.jobs:
            if self.stopped:
                return
            t0 = time.perf_counter()
            try:
                job()
            except BaseException as exc:
                self.error = exc
                return
            finally:
                self.seconds[name] = time.perf_counter() - t0

    def join(self, timeout):
        """Wait for the jobs; returns this process's seconds of waiting."""
        t0 = time.perf_counter()
        self.thread.join(timeout=timeout)
        if self.thread.is_alive():
            left = self.stop()
            raise AssertionError(
                f"lane: {[n for n, _ in self.jobs]} still running "
                f"{time.perf_counter() - self.t0:.1f} s after their start; "
                f"killed {left}")
        if self.error is not None:
            raise self.error
        return time.perf_counter() - t0

    def stop(self):
        """Kill whatever the jobs left running (a failure elsewhere ends
        the smoke while they run)."""
        self.stopped = True
        if not self.thread.is_alive():
            return []
        for started in self.clis:
            stop_clis(started)
        return [pid for root in self.roots
                for pid in _stop_run(root, [], wait_s=0)]


def _pipeline_replies(lgb, dev, files, replies):
    """Run A's 64 replies after the run, each against the raw prediction
    in this process of the generation's model it names."""
    from lightgbm_tpu_torch.serve.compile import compile_forest
    boosters = {}
    for g, path in files.items():
        b = lgb.Booster(model_file=path, params={"device_type": dev.type})
        boosters[compile_forest(b).model_id] = (g, b)
    worst, named = 0.0, []
    for X, rep in replies:
        if rep.get("model") not in boosters:
            raise AssertionError(f"pipeline run A: reply {rep}")
        g, b = boosters[rep["model"]]
        named.append(g)
        worst = max(worst, float(np.abs(
            np.asarray(rep["predictions"])
            - b.predict(X, raw_score=True)).max()))
    log(f"[pipeline] run A: 64 requests after the run, generations "
        f"named {sorted(set(named))}, max abs err against the "
        f"in-process raw prediction of the named model {worst:.3g}")
    if worst > 1e-6 or set(named) != {2}:
        raise AssertionError("pipeline run A: a reply is off")


def _pipeline_runs(dev, card, root, text0, text1, built, out):
    """Runs A and B of the pipeline phase and their checks, one after
    the other, on the lane (:class:`Lane`); they fill ``out``."""
    from lightgbm_tpu_torch.ops import _cuda
    from lightgbm_tpu_torch.resilience.elastic import replica_rpc
    from lightgbm_tpu_torch.resilience.publisher import load_manifest
    t_runs = time.perf_counter()
    # ---- run A: rank_kill@7, publish_torn@1, serve_kill@12
    work = os.path.join(root, "a")
    summary, watch, run_s, ports = _run_pipeline("A", work, PIPE_A, dev, 1)
    try:
        client = summary["client"]
        fleet = summary["fleet"]
        last = summary["last_published_sha256"]
        serve_faults = {e.get("kind") for e in _jsonl(os.path.join(
            work, "telemetry", "serve.jsonl")) if e.get("event") == "fault"}
        held = (summary["failures"] == []
                and summary["generations_published"] == 3
                and summary["swaps_confirmed"] == 2
                and fleet and all(st and st["manifest_sha256"] == last
                                  for st in fleet)
                and client["timeout"] == 0 and client["conn"] >= 1
                and client["ok"] > 0 and client["max_ok_gap_s"] < 60
                and "swap_failure" in serve_faults)
        log(f"[pipeline] run A: exit 0 after {run_s:.1f} s; failures "
            f"{summary['failures']}, published "
            f"{summary['generations_published']}, swaps confirmed "
            f"{summary['swaps_confirmed']}, fleet on the last sha "
            f"{[st and st['manifest_sha256'] == last for st in fleet]}, "
            f"client {json.dumps(client)}, serve fault kinds "
            f"{sorted(serve_faults)}")
        if not held:
            raise AssertionError("pipeline run A: the JAX package's "
                                 "assertions do not hold")
        pub = os.path.join(work, "publish")
        files = {g: os.path.join(pub, f"model_g{g:04d}.txt")
                 for g in range(3)}
        same0 = open(files[0]).read() == text0
        same1 = open(files[1]).read() == text1
        log(f"[pipeline] run A: generation 0's published model equal byte "
            f"for byte to the in-process twin {same0}; generation 1 "
            f"(killed at iteration 7, resumed) equal to the uninterrupted "
            f"continuation {same1}")
        if not (same0 and same1):
            raise AssertionError("pipeline run A: a published model differs "
                                 "from its in-process twin")
        # 64 requests to the fleet, each held to the model it names by
        # phase_pipeline_finish: this thread runs nothing on the card (a
        # profiled window of a phase beside it would count its kernels)
        rs = np.random.RandomState(PIPE_SEED)
        replies = []
        for k in range(64):
            X = rs.uniform(-2, 2, size=(1 + k % 8, FEATURES)).astype(
                np.float32).astype(np.float64)
            rep = replica_rpc(ports[k % len(ports)],
                              {"rows": X.tolist(), "raw": True}, timeout=30)
            if not rep or "predictions" not in rep:
                raise AssertionError(f"pipeline run A: reply {rep}")
            replies.append((X, rep))
        out["A_replies"] = (files, replies)
        # telemetry: the generations, the relaunch, the replicas, swaps
        gens = _generation_times(work, 3)
        for g, v in gens.items():
            log(f"[pipeline] run A generation {g}: supervised "
                f"{v['supervised_s']:.2f} s, {v['iterations']} iterations "
                f"(a relaunch repeats none), median "
                f"{v['median_iter_s']:.4f} s/iteration {v['iter_s']}, "
                f"ingest {v['ingest_s']} s ({card})")
        spans = [e for e in _jsonl(os.path.join(
            work, "telemetry", "train_g0001.jsonl"))
            if e.get("event") == "span" and e["name"] == "train/iteration"]
        procs = list(dict.fromkeys(e["proc"] for e in spans))
        killed = [e for e in spans if e["proc"] == procs[0]]
        resumed = [e for e in spans if e["proc"] == procs[-1]]
        kill_t = killed[-1]["wall"] + killed[-1]["dur"]
        relaunch = watch.first_seen.get("train_g0001/elastic_g1_rank0.log")
        gap = resumed[0]["wall"] - kill_t
        log(f"[pipeline] run A rank_kill@7: lives {len(procs)}, the killed "
            f"life's last iteration {killed[-1]['attrs']['iteration']}, "
            f"the resumed life's first {resumed[0]['attrs']['iteration']}; "
            f"kill -> resumed first iteration {gap:.3f} s (kill -> "
            f"relaunch spawn "
            f"{(relaunch - kill_t) if relaunch else float('nan'):.3f} s) "
            f"({card})")
        if len(procs) != 2 or killed[-1]["attrs"]["iteration"] != 6 or \
                resumed[0]["attrs"]["iteration"] != 7:
            raise AssertionError("pipeline run A: rank_kill@7 did not "
                                 "kill and resume generation 1 at 7")
        ready = {k: (t - watch.first_seen[k], r)
                 for k, (t, r) in sorted(watch.ready.items())}
        log("[pipeline] run A replicas, spawn -> serve_ready s: "
            + "; ".join(f"{k.split('/')[1][:-4]} {s:.3f}"
                        for k, (s, _) in ready.items()) + f" ({card})")
        swaps = {}
        for g in (1, 2):
            man = load_manifest(files[g])
            ends = _swap_ends(work, os.path.basename(files[g]))
            swaps[g] = (max(ends.values()) - man["created_unix"]
                        if ends else None)
        log("[pipeline] run A publish -> fleet-wide swap s: "
            + "; ".join(f"generation {g} {s:.3f}" if s is not None
                        else f"generation {g} none (loaded at start)"
                        for g, s in swaps.items())
            + f"; client p50 {client.get('p50_ms')} ms, p99 "
              f"{client.get('p99_ms')} ms, max_ok_gap_s "
              f"{client['max_ok_gap_s']} ({card})")
        roles = {os.getpid(): "smoke"}
        for _, r in ready.values():
            roles[r["pid"]] = f"replica{r['rank']}"
        for g in range(3):
            for e in _jsonl(os.path.join(work, "telemetry",
                                         f"train_g{g:04d}.jsonl")):
                if e.get("event") == "span":
                    roles[int(e["proc"].split(".")[0][3:])] = f"trainer_g{g}"
        mem = _mem_table(watch, roles)
        serve_peak = _serve_peaks(work)
        log(f"[pipeline] run A device memory: nvidia-smi by process (the "
            f"sample with the most processes; role, pid, name, used) "
            f"{mem}; allocated peaks, trainers "
            f"{[v['peak_bytes'] for v in gens.values()]} bytes, replicas "
            f"{serve_peak} bytes ({card})")
        out["A"] = dict(run_s=run_s, generations=gens, relaunch_gap_s=gap,
                        ready_s={k: s for k, (s, _) in ready.items()},
                        swap_s=swaps, client=client, memory=mem,
                        serve_peak_bytes=serve_peak)
    finally:
        left = _stop_run(work, ports)
        if left:
            log(f"[pipeline] run A: killed leftover processes {left}")

    # ---- run B: store_outage@1, publish_poison@2, a load spike
    work = os.path.join(root, "b")
    summary, watch, run_s, ports = _run_pipeline("B", work, PIPE_B, dev, 3)
    try:
        life = summary["fleet_lifecycle"]
        client = summary["client"]
        rb = summary["rollbacks"]
        fleet_events = _jsonl(os.path.join(work, "telemetry",
                                           "serve.jsonl.fleet"))
        rb_events = [e for e in fleet_events if e.get("event") == "rollback"]
        bad = rb[0]["bad_sha"] if rb else None
        good = rb[0]["good_sha"] if rb else None
        tdir = os.path.join(work, "telemetry")
        poisoned = "model_g0002.txt"
        served_poison = any(
            e.get("event") == "span" and e.get("name") == "swap/apply"
            and str(e["attrs"].get("path", "")).endswith(poisoned)
            for fn in os.listdir(tdir)
            if fn.startswith("serve.jsonl") and not fn.endswith(".fleet")
            for e in _jsonl(os.path.join(tdir, fn)))
        held = (summary["failures"] == [] and life["scale_ups"] >= 1
                and life["scale_downs"] >= 1 and life["replicas_peak"] >= 2
                and len(rb) == 1 and life["rollbacks"] == 1 and bad != good
                and summary["fleet"] and all(
                    st and st["manifest_sha256"] == good
                    for st in summary["fleet"])
                and not served_poison and client["timeout"] == 0)
        log(f"[pipeline] run B: exit 0 after {run_s:.1f} s; failures "
            f"{summary['failures']}, lifecycle {json.dumps(life)}, "
            f"rollbacks {len(rb)}, fleet on the good sha "
            f"{[st and st['manifest_sha256'] == good for st in summary['fleet']]}"
            f", the poisoned publication swapped in {served_poison}, "
            f"client {json.dumps(client)}")
        if not held:
            raise AssertionError("pipeline run B: the JAX package's "
                                 "assertions do not hold")
        ups = [e for e in fleet_events if e.get("event") == "autoscale"
               and e.get("action") == "up"]
        up_s = []
        for e in ups:
            later = [(t, k) for k, (t, _) in watch.ready.items()
                     if k.endswith(f"_rank{e['rank']}.log")
                     and watch.first_seen[k] >= e["time"] - 0.5]
            up_s.append(round(min(later)[0] - e["time"], 3) if later
                        else None)
        refusals = [e["time"] for fn in os.listdir(tdir)
                    if fn.startswith("serve.jsonl")
                    and not fn.endswith(".fleet")
                    for e in _jsonl(os.path.join(tdir, fn))
                    if e.get("event") == "fault"
                    and e.get("kind") == "canary_refused"]
        rb_t = rb_events[0]["time"]
        conv = _swap_ends(work, rb_events[0].get("republished") or "\0")
        ready = {k: round(t - watch.first_seen[k], 3)
                 for k, (t, _) in sorted(watch.ready.items())}
        gens = _generation_times(work, 3)
        log(f"[pipeline] run B: autoscale decision -> serving s {up_s}; "
            f"replicas spawn -> serve_ready s {ready}; first canary "
            f"refusal -> rollback order {rb_t - min(refusals):.3f} s, -> "
            f"fleet converged on the republished good model "
            f"{(max(conv.values()) - min(refusals)) if conv else float('nan'):.3f}"
            f" s ({len(conv)} replicas swapped); client p50 "
            f"{client.get('p50_ms')} ms, p99 {client.get('p99_ms')} ms, "
            f"max_ok_gap_s {client['max_ok_gap_s']}; generations "
            + "; ".join(f"{g}: {v['supervised_s']:.2f} s, median "
                        f"{v['median_iter_s']:.4f} s/iteration"
                        for g, v in gens.items()) + f" ({card})")
        out["B"] = dict(run_s=run_s, lifecycle=life, autoscale_up_s=up_s,
                        ready_s=ready, generations=gens,
                        refusal_to_rollback_s=rb_t - min(refusals),
                        refusal_to_converged_s=(max(conv.values())
                                                - min(refusals))
                        if conv else None, client=client)
    finally:
        left = _stop_run(work, ports)
        if left:
            log(f"[pipeline] run B: killed leftover processes {left}")

    after = {p.name: p.stat().st_mtime_ns
             for p in _cuda.BUILD_DIR.glob("*.so")}
    log(f"[pipeline] kernel libraries built by the runs' processes: "
        f"{len(set(after.items()) - set(built.items()))} (the build phase "
        f"built them)")
    if after != built:
        raise AssertionError("pipeline: a generation rebuilt a kernel")
    out["runs_s"] = time.perf_counter() - t_runs


COST_ENTRIES = ("ops/grow_tree", "ops/pallas_hist", "ops/partition")
# profiled kernel names by cost entry
COST_KERNELS = {"ops/pallas_hist": ("hist_kernel", "hist_convert_kernel"),
                "ops/partition": ("part_resident", "part_column",
                                  "part_move")}


def start_lint():
    """Both lint runs in subprocesses, started beside the build (they
    use the host's cores, never the card): ``lint --strict`` under ``-X
    importtime`` (whose module list must hold no torch), and ``lint --ir
    --strict`` on the CPU. :func:`phase_cost` waits for them."""
    runs = {}
    for tag, flags, extra in (
            ("lint", ["-X", "importtime"], {}),
            ("lint_ir", [], {"CUDA_VISIBLE_DEVICES": ""})):
        log_path = tempfile.mkstemp(prefix=f"smoke_{tag}_",
                                    suffix=".log")[1]
        fh = open(log_path, "w")
        cmd = [sys.executable, *flags, "-m", "lightgbm_tpu_torch", "lint",
               *(["--ir"] if tag == "lint_ir" else []), "--strict"]
        runs[tag] = dict(proc=subprocess.Popen(
            cmd, stdout=fh, stderr=subprocess.STDOUT,
            env=_smoke_env(extra)), fh=fh, path=log_path,
            t0=time.perf_counter(), cmd=" ".join(cmd[1:]))
    return runs


def stop_lint(runs):
    """Kill what is left of the lint runs (a failure path)."""
    for r in runs.values():
        if r["proc"].poll() is None:
            r["proc"].kill()
            r["proc"].wait()
        r["fh"].close()


def _finish_lint(runs, card):
    """Wait for both lint runs; each must exit 0, and the plain one must
    import no torch (``-X importtime`` lists every module it imported)."""
    for tag, r in runs.items():
        rc = r["proc"].wait(timeout=600)
        r["fh"].close()
        wall = time.perf_counter() - r["t0"]
        with open(r["path"]) as fh:
            text = fh.read()
        os.unlink(r["path"])
        lines = [ln for ln in text.splitlines()
                 if not ln.startswith("import time:")]
        torch_mods = sorted({ln.rsplit("|", 1)[-1].strip()
                             for ln in text.splitlines()
                             if ln.startswith("import time:")
                             and ln.rsplit("|", 1)[-1].strip().split(
                                 ".")[0] == "torch"})
        log(f"[cost] {r['cmd']}: exit {rc}, ended within {wall:.1f} s "
            f"of its start beside the build; "
            f"{lines[-1] if lines else 'no output'}"
            + (f"; torch modules imported: {len(torch_mods)}"
               if tag == "lint" else "") + f" ({card})")
        if rc != 0:
            raise AssertionError(f"{r['cmd']} exited {rc}:\n"
                                 + "\n".join(lines[-40:]))
        if tag == "lint" and torch_mods:
            raise AssertionError(f"{r['cmd']} imported torch: "
                                 f"{torch_mods[:5]}")


def phase_cost(torch, tr, k1, k2, lint_runs, card):
    """Cost attribution (obs/cost.py) of the train phase's Higgs booster,
    read from the compile events its training emitted (no training of
    its own): the three entries of the main path each have an event
    with bytes and an optimal ms, within their declared
    ``max_signatures``; K1's and K2's optimal ms at the root window equal
    the kernels line's ``bound_ms``; each entry's optimal ms beside the
    measured ms of train's profiled iteration; the ``stats`` cost
    section rendered from a telemetry file of the events. Then both lint
    runs must have ended clean."""
    from lightgbm_tpu_torch.obs.jit_tracker import jit_declarations
    from lightgbm_tpu_torch.obs.recorder import (render_stats_table,
                                                 summarize_events)
    events = tr["compile_events"]
    declared = jit_declarations()
    by_entry = {}
    for ev in events:
        by_entry.setdefault(ev["entry"], []).append(ev)
    for name in COST_ENTRIES:
        evs = by_entry.get(name, [])
        if not evs or any(ev["bytes_accessed"] is None
                          or ev["optimal_ms"] is None for ev in evs):
            raise AssertionError(f"cost: {name} has no event with bytes "
                                 f"and optimal_ms ({len(evs)} events)")
        n_sig = tr["signatures"].get(name, 0)
        if n_sig > declared.get(name, 0) or n_sig != len(evs):
            raise AssertionError(
                f"cost: {name} saw {n_sig} signatures ({len(evs)} events) "
                f"against max_signatures={declared.get(name)}")
    # the root window is each kernel's largest call of the tree
    checks = {}
    for name, shapes in (("ops/pallas_hist", k1), ("ops/partition", k2)):
        root = max(by_entry[name], key=lambda ev: ev["bytes_accessed"])
        want = shapes[0]["bound_ms"]
        checks[name] = (root["optimal_ms"], want)
        if abs(root["optimal_ms"] - want) > 1e-9 * want:
            raise AssertionError(f"cost: {name}'s root optimal_ms "
                                 f"{root['optimal_ms']} != the kernels "
                                 f"line's bound_ms {want}")
    prof = tr["profile"]
    log(f"[cost] train's booster (Higgs {tr['leaves'][0]} leaves): "
        f"{len(events)} compile events, signatures "
        f"{json.dumps({k: tr['signatures'].get(k, 0) for k in sorted(by_entry)})}"
        f" against max_signatures "
        f"{json.dumps({k: declared.get(k) for k in sorted(by_entry)})}; "
        "device peaks of the events: "
        f"{events[0]['device_kind']} {events[0]['peak_flops']:.4g} "
        f"operations/s, {events[0]['peak_bytes_per_sec']:.4g} B/s ({card})")
    for name, (got, want) in checks.items():
        log(f"[cost] {name} root window: optimal_ms={got:.6f} = kernels "
            f"line bound_ms={want:.6f} ({card})")
    grow = by_entry["ops/grow_tree"][0]
    log(f"[cost] ops/grow_tree (first tree: modelled K1 and K2, counted "
        f"torch ops): flops={grow['flops']:.4g} "
        f"bytes={grow['bytes_accessed']:.4g} optimal_ms="
        f"{grow['optimal_ms']:.3f} first-call wall_ms={grow['wall_ms']} "
        f"against the profiled iteration's device busy "
        f"{prof['device_busy_ms']:.3f} ms and wall {prof['wall_ms']:.3f} "
        f"ms: roofline share {grow['optimal_ms'] / prof['wall_ms']:.4f} "
        f"of the wall ({card})")
    for name, kernels in COST_KERNELS.items():
        ms = sum(prof["kernels"].get(k, {}).get("ms", 0.0) for k in kernels)
        calls = sum(prof["kernels"].get(k, {}).get("calls", 0)
                    for k in kernels)
        evs = by_entry[name]
        log(f"[cost] {name}: {len(evs)} signatures, optimal_ms at each "
            f"signature's first window "
            f"{[round(ev['optimal_ms'], 6) for ev in evs]}; the profiled "
            f"iteration's {'+'.join(kernels)}: {ms:.3f} device ms in "
            f"{calls} kernels, {ms / max(calls, 1):.4f} ms a kernel ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "telemetry.jsonl")
        with open(path, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev) + "\n")
        table = render_stats_table(summarize_events(path))
    section = table[table.index("xla cost attribution"):] \
        if "xla cost attribution" in table else ""
    if not section:
        raise AssertionError("cost: the stats table has no cost section")
    for line in section.splitlines():
        log(f"[cost] stats: {line}")
    _finish_lint(lint_runs, card)
    return dict(events=len(events), signatures=tr["signatures"],
                roots=checks)


def profile_iteration(torch, bst, host=True):
    """One more boosting iteration under torch.profiler: the card's busy
    time (the sum of the device-side events' times; one stream, so they
    do not overlap) against the iteration's wall time, the kernels that
    take most of it, and the host ops that take most of the host's.
    Runs after the model above was scored, so it does not change what
    was checked. Sleep kernels before and after the iteration (left out
    of the sums) keep the trace's ends from dropping its launches. ``host=False`` records the device's events only (no
    host ops): the trace of an iteration of ~270k launches takes minutes
    of host time to read back with them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    acts = [ProfilerActivity.CPU] if host else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        # short sleep kernels before and after take the launches a trace
        # may drop at its ends (left out of every sum below)
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(1000)
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    rows, host = [], []
    for e in prof.key_averages():
        if "spin_kernel" in e.key:
            continue
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same time as "self device time"
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
            continue
        if _is_annotation(e):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    # the two kernels' own time in the iteration, by kernel name
    ours = {}
    for ms, c, k in rows:
        for tag in ("hist_kernel", "hist_convert_kernel", "part_resident",
                    "part_column", "part_move"):
            if tag in k:
                t = ours.setdefault(tag, [0.0, 0])
                t[0] += ms
                t[1] += c
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / (wall * 1e3) if rows else None,
               kernels={k: dict(ms=v[0], calls=v[1])
                        for k, v in ours.items()},
               top=[dict(name=k[:60], calls=c, ms=ms)
                    for ms, c, k in rows[:10]],
               host_top=[dict(name=k[:60], calls=c, ms=ms)
                         for ms, c, k in host[:8]])
    out["launches"] = sum(c for _, c, _ in rows)
    # the host's calls that put work on the card, one device event each:
    # unlike the device-side records, which a trace can lose a few of,
    # they are recorded whole
    out["launch_calls"] = {k: c for _, c, k in host if k in LAUNCH_CALLS}
    log("[profile] one iteration under torch.profiler: wall_ms="
        f"{out['wall_ms']:.1f} device_busy_ms={busy_ms:.1f} device events="
        f"{out['launches']} profile_s={time.perf_counter() - t_all:.1f} "
        "idle_share="
        + ("not measured (no device time in the trace)"
           if out["idle_share"] is None else f"{out['idle_share']:.3f}")
        + "; K1/K2 kernels: " + "; ".join(
            f"{k} {v[0]:.3f} ms {v[1]}x" for k, v in ours.items()))
    for r in out["top"]:
        log(f"[profile]   {r['ms']:9.3f} ms {r['calls']:6d}x {r['name']}")
    # where the host's time goes: CPU ops by self time (a read-back's
    # wait for the card shows under the op that reads back)
    for r in out["host_top"]:
        log(f"[profile]   host {r['ms']:9.3f} ms {r['calls']:6d}x "
            f"{r['name']}")
    return out


def replay_windows(tree):
    """The histogram windows of a trained tree as the grower takes them,
    as ``(start, cnt, side, n_left)``: the root, then for every split the
    smaller child (by the tree's counts) of the parent's rows ``[start,
    start + cnt)`` of the partitioned row order, where the left child's
    ``n_left`` rows come first (K2 is a stable two-way partition)."""
    def count(c):
        return int(tree.internal_count[c]) if c >= 0 \
            else int(tree.leaf_count[~c])
    wins = [(0, count(0), 0, 0)]
    todo = [(0, 0)]                 # (internal node, its first row)
    while todo:
        i, start = todo.pop()
        lc, rc = int(tree.left_child[i]), int(tree.right_child[i])
        nl = count(lc)
        wins.append((start, count(i), 1 if nl <= count(rc) else 2, nl))
        todo += [(c, s) for c, s in ((lc, start), (rc, start + nl)) if c >= 0]
    return wins


def window_rows(win):
    """The rows that a replay window histograms."""
    start, cnt, side, nl = win
    return cnt if side == 0 else min(nl, cnt - nl)


def phase_k1_turns(torch, dev, bins, wins, reps, parent=None):
    """K1 as the main path sees it, on the training data's device bins:
    the root window (CUDA events), the ladder's smaller windows and the
    hot-bin window (torch.profiler device time), and the per-tree replay
    — the first tree's windows ``wins`` (:func:`replay_windows`) back to
    back at their offsets and sides, with the float path's one amax per
    tree — for both paths, its launches counted by the wrapper over one
    replay. With ``parent`` (the parent commit's histogram module) in
    turns: parent, change, change, parent."""
    from lightgbm_tpu_torch.ops.histogram import window_hist
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    n, F = bins.shape
    B = BINS
    fpay = torch.stack([torch.randn(n, generator=gen, device=dev),
                        torch.rand(n, generator=gen, device=dev) * 0.25],
                       1).contiguous()
    ipay = _quant_pay(torch, dev, n, gen)
    nls = torch.tensor([w[3] for w in wins], dtype=torch.int32, device=dev)
    hot_rows, hot_f = _rand_window(torch, dev, 1_000_000, F, B, gen, True)
    hot_i = _quant_pay(torch, dev, 1_000_000, gen)
    rungs = [(lb, S) for lb, S in (("1M", 1_000_000), ("mid", 100_003),
                                   ("10k", 10_007), ("1k", 1_009))
             if S < n]
    impls = [("change", window_hist)]
    if parent is not None:
        impls = [("parent", parent.window_hist), ("change", window_hist),
                 ("change", window_hist), ("parent", parent.window_hist)]
    turns = []
    for name, wh in impls:
        for path, pay, hpay, ops in (("float", fpay, hot_f, FP32_OPS_PER_S),
                                     ("int", ipay, hot_i, INT32_OPS_PER_S)):
            # the tree's one amax, where the wrapper takes it
            new_float = path == "float" and \
                "pay_absmax" in inspect.signature(wh).parameters

            def call(rows, p, S, am=None):
                kw = {"pay_absmax": am} if new_float else {}
                return lambda: wh(rows, p, B, 0, S, **kw)
            am = fpay.abs().amax(0) if new_float else None
            hot_am = hot_f.abs().amax(0) if new_float else None
            t = dict(impl=name, path=path)
            t["root_ms"] = events_ms(call(bins, pay, n, am), reps, torch)
            for lb, S in rungs:
                t[lb + "_ms"] = profiled_ms(call(bins, pay, S, am), reps,
                                            torch)
            t["hot_1M_ms"] = profiled_ms(call(hot_rows, hpay, 1_000_000,
                                              hot_am), reps, torch)

            def tree():
                # the grower's one amax per tree, then its windows
                kw = {"pay_absmax": pay.abs().amax(0)} if new_float else {}
                for j, (start, cnt, side, _) in enumerate(wins):
                    wh(bins, pay, B, start, cnt, nls[j:j + 1], side, **kw)
            key = "launches" if path == "float" else "int_launches"
            setattr(wh, key, 0)
            tree()
            t["replay_windows"] = len(wins)
            t["replay_launches"] = getattr(wh, key)
            kernels = {}
            t["replay_ms"] = profiled_ms(tree, 3, torch, kernels)
            t["replay_by_kernel"] = {k[:60]: v for k, v in
                                     sorted(kernels.items(),
                                            key=lambda kv: -kv[1])}
            t["replay_bound_ms"] = sum(
                k1_bound(window_rows(w), F, bins.element_size(),
                          8 if path == "float" else 2, B, ops)[0]
                for w in wins)
            turns.append(t)
            log(f"[k1_turns] {name:6s} {path:5s} root={t['root_ms']:.5f} "
                "(events) " + " ".join(f"{lb}={t[lb + '_ms']:.5f}"
                                       for lb, _ in rungs)
                + f" hot_1M={t['hot_1M_ms']:.5f} (profiler) replay="
                f"{t['replay_ms']:.4f} ms for {len(wins)} windows, "
                f"{t['replay_launches']} launches "
                f"(bound {t['replay_bound_ms']:.4f}); by kernel: "
                + "; ".join(f"{k} {v:.4f}" for k, v in
                            t["replay_by_kernel"].items()))
    del fpay, ipay, hot_rows, hot_f, hot_i
    return turns


def phase_train_u16(torch, lgb, dev):
    """A small run with more than 256 bins, so the bins are uint16 on
    the device and both kernels take their u16 paths inside the grower,
    held to the main path's standard against the same run with the
    plain versions forced: the first tree's root split is the same and
    the held-out AUC is not lower by more than 0.002. (Trees further
    down may differ: the two histograms sum in different orders, and
    small leaves over 400 bins have near-tied candidates.)"""
    from lightgbm_tpu_torch.metrics import auc
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    X, y = make_higgs_like(250_000, 8, seed=1)
    Xt, yt, Xv, yv = X[:200_000], y[:200_000], X[200_000:], y[200_000:]
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 400,
              "min_data_in_bin": 1, "verbosity": -1,
              "device_type": dev.type}
    ds = lgb.Dataset(Xt, label=yt, params=params)
    if ds.construct().device_bins().dtype != torch.uint16:
        raise AssertionError("max_bin=400 did not give uint16 bins")
    bst = lgb.train(params, ds, num_boost_round=3)
    with plain_kernels():
        ref = lgb.train(params, ds, num_boost_round=3)
    yv_t = torch.as_tensor(yv, device=dev)
    auc_k = auc(torch.as_tensor(bst.predict(Xv), device=dev), yv_t)
    auc_p = auc(torch.as_tensor(ref.predict(Xv), device=dev), yv_t)
    root_k = (int(bst._models[0].split_feature[0]),
              int(bst._models[0].threshold_bin[0]))
    root_p = (int(ref._models[0].split_feature[0]),
              int(ref._models[0].threshold_bin[0]))
    same = [int(np.array_equal(a.split_feature, b.split_feature)
                and np.array_equal(a.threshold, b.threshold))
            for a, b in zip(bst._models, ref._models)]
    log(f"[train_u16] 200000x8 max_bin=400 (uint16 bins): "
        f"{[t.num_leaves for t in bst._models]} leaves, auc={auc_k:.6f} "
        f"plain auc={auc_p:.6f}, root split kernel={root_k} "
        f"plain={root_p}, trees identical to the plain run's: {same}")
    if root_k != root_p:
        raise AssertionError("u16 run: root split differs from the plain "
                             "run's")
    if auc_k < auc_p - 0.002:
        raise AssertionError(f"u16 run: AUC {auc_k} below plain {auc_p} "
                             "- 0.002")


def phase_train_quant_small(torch, lgb, dev):
    """A small deterministic quantized run (200k x 28, round to nearest,
    no renewal): the int32 histograms are exact whatever the order, so
    every tree, leaf values included, equals its plain twin's."""
    X, y = make_higgs_like(250_000, FEATURES, seed=2)
    Xt, yt, Xv, yv = X[:200_000], y[:200_000], X[200_000:], y[200_000:]
    params = {"objective": "binary", "num_leaves": 63, "max_bin": BINS,
              "verbosity": -1, "use_quantized_grad": True,
              "stochastic_rounding": False, "device_type": dev.type}
    ds = lgb.Dataset(Xt, label=yt, params=params)
    _reset_counts()
    bst = lgb.train(params, ds, num_boost_round=5)
    counts = _read_counts()
    _check_counts("train_quant_small", counts,
                  [t.num_leaves for t in bst._models], "hist_int")
    ref, _ = _plain_twin(torch, lgb, dev, params, ds, Xv, yv, 5,
                         "train_quant_small")
    same = [int(_same_structure(a, b)
                and np.array_equal(a.leaf_value, b.leaf_value))
            for a, b in zip(bst._models, ref._models)]
    log(f"[train_quant_small] 200000x28, 5 trees of "
        f"{[t.num_leaves for t in bst._models]} leaves, launches="
        f"{json.dumps(counts)}, trees identical to the plain run's "
        f"(leaf values included): {same}")
    if len(bst._models) != len(ref._models) or not all(same):
        raise AssertionError("train_quant_small: trees differ from the "
                             "plain run's")


def _query_sizes(rng, total=None, count=None):
    """Query sizes to MSLR-WEB30K's published statistics: log-normal with
    a mean of about ``LTR_MEAN_QUERY`` documents, clipped to
    ``[1, LTR_MAX_QUERY]``, the first query at the maximum. Either
    ``count`` queries, or as many as reach ``total`` rows (the last one
    cut to fit)."""
    sigma = 0.7
    mu = np.log(LTR_MEAN_QUERY) - sigma * sigma / 2
    n = count or int(total / LTR_MEAN_QUERY * 1.3) + 100
    sizes = np.clip(np.round(rng.lognormal(mu, sigma, n)), 1,
                    LTR_MAX_QUERY).astype(np.int64)
    sizes[0] = LTR_MAX_QUERY
    if total is None:
        return sizes
    c = np.cumsum(sizes)
    k = int(np.searchsorted(c, total))
    sizes = sizes[:k + 1].copy()
    sizes[-1] -= int(c[k]) - total
    return sizes[sizes > 0]


def make_ltr_like(n_train, seed=0):
    """MSLR-WEB30K-shaped learning-to-rank data: ``n_train`` training
    rows in queries of ``_query_sizes``, 10% more queries held out, 137
    float32 features, relevance graded 0-4 with most documents at 0
    (about 52/32/12/3/1%), from a latent score of six features, a
    per-query offset and noise. Returns ``(X, y, group)`` for both."""
    rng = np.random.default_rng(seed)
    gt = _query_sizes(rng, total=n_train)
    gv = _query_sizes(rng, count=max(1, round(0.1 * len(gt))))
    n = int(gt.sum() + gv.sum())
    X = rng.standard_normal((n, LTR_FEATURES), dtype=np.float32)
    w = rng.standard_normal(6).astype(np.float32)
    offset = np.repeat(rng.standard_normal(len(gt) + len(gv)) * 0.5,
                       np.concatenate([gt, gv]))
    latent = X[:, :6] @ w + offset + rng.standard_normal(n)
    y = np.digitize(latent, np.quantile(latent, [0.52, 0.84, 0.965, 0.99])
                    ).astype(np.float64)
    m = int(gt.sum())
    return X[:m], y[:m], gt, X[m:], y[m:], gv


def make_covertype_like(n, seed=0):
    """Covertype-shaped data, ``n`` rows x 54 float32 features: 10
    numerical columns on Covertype's scales (elevation, aspect, slope,
    four distances, three hillshades) and 44 one-hot indicators, one of
    4 wilderness areas and one of 40 soil types per row (so each
    indicator is mostly zeros); 7 classes, skewed like Covertype's (two
    hold about 80% of the rows; Covertype's hold 85%), from a noisy
    linear score of all of it."""
    rng = np.random.default_rng(seed)
    num = np.stack([
        rng.normal(2959, 280, n), rng.uniform(0, 360, n),
        np.abs(rng.normal(14, 7.5, n)), rng.exponential(270, n),
        rng.normal(46, 58, n), rng.exponential(2350, n),
        np.clip(rng.normal(212, 27, n), 0, 254),
        np.clip(rng.normal(223, 20, n), 0, 254),
        np.clip(rng.normal(143, 38, n), 0, 254),
        rng.exponential(1980, n)], axis=1).round()
    wild = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.choice(40, n, p=rng.dirichlet(np.full(40, 0.5)))
    X = np.zeros((n, COV_FEATURES), np.float32)
    X[:, :10] = num
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    z = (num - num.mean(0)) / num.std(0)
    prior = np.log([0.365, 0.488, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353])
    logits = (z @ rng.normal(0, 0.5, (10, COV_CLASSES))
              + rng.normal(0, 0.5, (4, COV_CLASSES))[wild]
              + rng.normal(0, 0.5, (40, COV_CLASSES))[soil]
              + 1.5 * prior + rng.gumbel(size=(n, COV_CLASSES)))
    return X, np.argmax(logits, axis=1).astype(np.float64)


def phase_train_rank(torch, lgb, dev, iters):
    """lambdarank at the MS LTR shape (2.27M training rows x 137
    features, 255 leaves, 255 bins): 1 warm-up + ``iters`` timed
    iterations, the gradient function timed alone, held-out NDCG@10 (no
    profiled iteration, for the smoke's time); the card's gradients of the first 200 queries at
    the warm-up scores against the same function on the CPU; against the
    plain twin, the same root split and NDCG@10 within 0.002."""
    from lightgbm_tpu_torch.ranking import (_lambdarank_grads, _pad_queries,
                                            ndcg_at_k)
    t0 = time.perf_counter()
    Xt, yt, gt, Xv, yv, gv = make_ltr_like(LTR_ROWS)
    log(f"[train_rank] data rows={len(yt)}+{len(yv)} features="
        f"{LTR_FEATURES} queries={len(gt)}+{len(gv)} mean_query="
        f"{gt.mean():.1f} max_query={int(gt.max())} labels 0-4 share="
        f"{[round(float(np.mean(yt == c)), 4) for c in range(5)]} "
        f"gen_s={time.perf_counter() - t0:.2f}")
    params = {"objective": "lambdarank", "num_leaves": 255,
              "max_bin": BINS, "learning_rate": 0.1, "verbosity": -1,
              "device_type": dev.type}
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, group=gt,
                     params={"max_bin": BINS, "device_type": dev.type})
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    log(f"[train_rank] construct_s={construct_s:.3f}")
    del Xt
    qb_v = np.concatenate([[0], np.cumsum(gv)])
    yv_t = torch.as_tensor(yv, device=dev)

    def scorer(p):
        if p.shape != (len(yv),) or not np.all(np.isfinite(p)):
            raise AssertionError("train_rank: predictions are not finite "
                                 "[n] values")
        return dict(ndcg10=ndcg_at_k(torch.as_tensor(p, device=dev), yv_t,
                                     qb_v, 10))

    def after_warmup(bst):
        eng = bst._engine
        obj = eng.objective
        s0 = eng.score[0].clone()

        def grads():
            return obj.grad_hess(s0, eng.label, eng.weight)
        grad_ms = events_ms(grads, 3, torch)
        g, h = grads()
        qb = ds.query_boundaries()[:201]
        m = int(qb[-1])
        gc, hc = _lambdarank_grads(
            s0[:m].cpu(), _pad_queries(qb, "cpu"), obj.gain_of_row[:m].cpu(),
            None, obj.sigmoid, obj.trunc, obj.norm)
        err = max(float((g[:m].cpu() - gc).abs().max()),
                  float((h[:m].cpu() - hc).abs().max()))
        log(f"[train_rank] grad_ms={grad_ms:.3f} (CUDA events, the "
            f"gradient function alone, {len(obj.buckets)} query buckets); "
            f"first 200 queries ({m} rows) at the warm-up scores, card vs "
            f"CPU: max_abs_err={err:.3g}")
        if not (torch.allclose(g[:m].cpu(), gc, rtol=1e-4, atol=1e-6)
                and torch.allclose(h[:m].cpu(), hc, rtol=1e-4, atol=1e-6)):
            raise AssertionError("train_rank: the card's lambdarank "
                                 "gradients differ from the CPU's")
        return dict(grad_ms=grad_ms, grad_cpu_max_abs_err=err)

    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters, "train_rank",
               scorer, after_warmup)
    _check_counts("train_rank", r["counts"], r["leaves"], "hist")
    # no profiled iteration, for the smoke's time (PERF.md §4)
    prof = None
    bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv, 1 + iters,
                             "train_rank", scorer)
    r_k, r_p = _root_split(r["bst"]), _root_split(bst_p)
    log(f"[train_rank] root_split kernel={r_k} plain={r_p} ndcg10="
        f"{r['ndcg10']:.6f} plain={m_p['ndcg10']:.6f}")
    if r_k != r_p:
        raise AssertionError("train_rank: the first tree's root split "
                             "differs from the plain run's")
    if abs(r["ndcg10"] - m_p["ndcg10"]) > 0.002:
        raise AssertionError(f"train_rank: NDCG@10 {r['ndcg10']} not within "
                             f"0.002 of the plain run's {m_p['ndcg10']}")
    del r["bst"], bst_p, ds
    return dict(r, ndcg10_plain=m_p["ndcg10"], construct_s=construct_s,
                profile=prof)


def phase_train_multiclass(torch, lgb, dev, iters, reps):
    """softmax multiclass at Covertype's shape (531,012 training + 50,000
    held-out rows x 54 features, 7 classes, 255 leaves, 255 bins, EFB at
    its default, so the sparse one-hot indicators bundle): the bundles
    (G, B, group sizes); 1 warm-up + ``iters`` timed iterations of 7
    trees (none in the smoke: the warm-up is timed too), held-out
    multi_logloss and accuracy (no profiled iteration:
    its trace took 77.5 s of the smoke);
    against the plain twin, the first iteration's 7 root splits and
    multi_logloss within 0.002. The plain twin's float histograms are
    summed in float64 (:func:`exact_float_sums`): at this shape float32
    sums drift far from the exact ones (the root histogram's drift is
    printed beside). Then one iteration unbundled
    (``enable_bundle=False``): the same 7 root splits as the bundled
    run's first iteration, multi_logloss within 0.002 of it. Then one
    multiclassova iteration and one quantized iteration (round to
    nearest), each with its first trees identical to its plain twin's;
    then K1 and K2 at the bundled width (:func:`phase_bundled_kernels`)."""
    from lightgbm_tpu_torch.metrics import multi_logloss
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    t0 = time.perf_counter()
    X, y = make_covertype_like(COV_ROWS)
    n = COV_ROWS - COV_VALID
    Xt, yt, Xv, yv = X[:n], y[:n], X[n:], y[n:]
    log(f"[train_multiclass] data rows={n}+{COV_VALID} features="
        f"{COV_FEATURES} classes={COV_CLASSES} class share="
        f"{[round(float(np.mean(yt == c)), 4) for c in range(COV_CLASSES)]} "
        f"gen_s={time.perf_counter() - t0:.2f}")
    params = {"objective": "multiclass", "num_class": COV_CLASSES,
              "num_leaves": 255, "max_bin": BINS, "learning_rate": 0.1,
              "verbosity": -1, "device_type": dev.type}
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, params={"max_bin": BINS,
                                           "device_type": dev.type})
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    bundles = _bundle_stats(torch, lgb, ds, params, "train_multiclass")
    log(f"[train_multiclass] construct_s={construct_s:.3f}")
    yv_t = torch.as_tensor(yv, device=dev)

    def scorer(p):
        if p.shape != (len(yv), COV_CLASSES) or not np.all(np.isfinite(p)):
            raise AssertionError("train_multiclass: predictions are not "
                                 "finite [n, K] values")
        row_err = float(np.abs(p.sum(axis=1) - 1.0).max())
        if row_err > 1e-5:
            raise AssertionError(f"train_multiclass: a row of probabilities "
                                 f"sums to 1 +- {row_err}")
        p_t = torch.as_tensor(p, device=dev)
        return dict(multi_logloss=multi_logloss(p_t, yv_t),
                    accuracy=float((p.argmax(axis=1) == yv).mean()))

    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters,
               "train_multiclass", scorer)
    _check_counts("train_multiclass", r["counts"], r["leaves"], "hist")
    # no profiled iteration: its 319,716 device events took 77.5 s of
    # the smoke's time, given up for train_growth (PERF.md section 4)
    prof = None
    f32_drift = _f32_drift(torch, ds, yt)

    def roots(bst):
        return [(int(t.split_feature[0]), int(t.threshold_bin[0]))
                for t in bst._models[:COV_CLASSES]]
    # the twin it is held to, whose float sums are exact (the float32
    # sums' drift is measured at the root above)
    with exact_float_sums(torch):
        bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                                 1 + iters, "train_multiclass", scorer)
    roots_k, roots_p = roots(r["bst"]), roots(bst_p)
    same = [int(_same_structure(a, b))
            for a, b in zip(r["bst"]._models, bst_p._models)]
    log(f"[train_multiclass] first iteration's root splits kernel={roots_k} "
        f"plain={roots_p}; multi_logloss={r['multi_logloss']:.6f} plain="
        f"{m_p['multi_logloss']:.6f}; trees identical in structure to the "
        f"plain run's: {same}")
    if roots_k != roots_p:
        raise AssertionError("train_multiclass: the first iteration's root "
                             "splits differ from the plain run's")
    if abs(r["multi_logloss"] - m_p["multi_logloss"]) > 0.002:
        raise AssertionError(
            f"train_multiclass: multi_logloss {r['multi_logloss']} not "
            f"within 0.002 of the plain run's {m_p['multi_logloss']}")
    # one iteration unbundled, against the bundled run's first
    ll_b1 = scorer(r["bst"].predict(Xv, num_iteration=1))["multi_logloss"]
    model_str = r["bst"].model_to_string()
    del r["bst"], bst_p
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst_u = lgb.train({**params, "enable_bundle": False}, ds, 1)
    torch.cuda.synchronize()
    train_s_u = time.perf_counter() - t0
    counts_u = _read_counts()
    _check_counts("train_multiclass_unbundled", counts_u,
                  [t.num_leaves for t in bst_u._models], "hist")
    ll_u = scorer(bst_u.predict(Xv))["multi_logloss"]
    roots_u = roots(bst_u)
    log(f"[train_multiclass_unbundled] one iteration, {X.shape[1]} "
        f"columns: root splits {roots_u} (bundled: {roots_k}); "
        f"multi_logloss={ll_u:.6f} (bundled, first iteration: "
        f"{ll_b1:.6f}); launches={json.dumps(counts_u)}; train seconds "
        f"for the iteration, set-up included: {train_s_u:.4f} (bundled "
        f"warm-up: {r['warmup_s']:.4f})")
    if roots_u != roots_k:
        raise AssertionError("train_multiclass: the unbundled iteration's "
                             "root splits differ from the bundled run's")
    if abs(ll_u - ll_b1) > 0.002:
        raise AssertionError(f"train_multiclass: unbundled multi_logloss "
                             f"{ll_u} not within 0.002 of the bundled "
                             f"{ll_b1}")
    del bst_u
    variants = {}
    for tag, extra, hist_key in (
            ("ova", {"objective": "multiclassova"}, "hist"),
            ("quant", {"use_quantized_grad": True,
                       "stochastic_rounding": False}, "hist_int")):
        # trees of 63 leaves: a check of the objective and the int path,
        # not a timing
        p = {**params, **extra, "num_leaves": 63}
        _reset_counts()
        bst = lgb.train(p, ds, num_boost_round=1)
        counts = _read_counts()
        leaves = [t.num_leaves for t in bst._models]
        _check_counts(f"train_multiclass_{tag}", counts, leaves, hist_key)
        with plain_kernels(), exact_float_sums(torch):
            ref = lgb.train(p, ds, num_boost_round=1)
        same = [int(_same_structure(a, b) and np.allclose(
            a.leaf_value, b.leaf_value, rtol=1e-4, atol=1e-5))
            for a, b in zip(bst._models, ref._models)]
        exact = [int(np.array_equal(a.leaf_value, b.leaf_value))
                 for a, b in zip(bst._models, ref._models)]
        log(f"[train_multiclass_{tag}] one iteration, {len(leaves)} trees of "
            f"{leaves} leaves, launches={json.dumps(counts)}; trees "
            f"identical to the plain run's: {same}, leaf values bit-equal: "
            f"{exact}")
        if len(bst._models) != COV_CLASSES or not all(same):
            raise AssertionError(f"train_multiclass_{tag}: the first trees "
                                 "differ from the plain run's")
        variants[tag] = dict(counts=counts, leaves=leaves, same_trees=same,
                             bit_equal_leaf_values=exact)
        del bst, ref
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops.partition import RangeRules
    info = ds.bundles(Config.from_params(params))
    kern = phase_bundled_kernels(
        torch, dev, info, RangeRules(ds.feat_num_bins(), ds.feat_nan_bin(),
                                     info), "cov_bundled", reps)
    return dict(r, multi_logloss_plain=m_p["multi_logloss"],
                f32_drift=f32_drift, construct_s=construct_s, profile=prof,
                variants=variants, ds=ds, Xv=Xv, yv=yv, scorer=scorer,
                params=params, bundles=bundles, model_str=model_str,
                unbundled=dict(counts=counts_u, roots=roots_u,
                               train_s=train_s_u,
                               multi_logloss=ll_u,
                               bundled_first_multi_logloss=ll_b1),
                kernels=kern)


class _RowWeights:
    """Records the row weights ``_row_weights`` gives each iteration of
    an engine (bagging or GOSS): the in-bag count, the rows kept at
    weight 1 and the amplified ones."""

    def __init__(self, engine):
        self.seen = []
        inner = engine._row_weights

        def wrapped(it, g, h):
            w = inner(it, g, h)
            if w is not None:
                self.seen.append(dict(
                    iteration=it, in_bag=int((w > 0).sum()),
                    weight_one=int((w == 1).sum()),
                    amplified=int((w > 1).sum())))
            return w
        engine._row_weights = wrapped


def _root_counts(bst):
    """Each tree's root count: its in-bag rows."""
    return [int(t.internal_count[0]) if t.num_leaves > 1
            else int(t.leaf_count[0]) for t in bst._models]


def _roots(bst):
    return [(int(t.split_feature[0]), int(t.threshold_bin[0]))
            for t in bst._models if t.num_leaves > 1]


def _iteration_clock(torch):
    """Callbacks that time every iteration of ``train`` (the update, then
    the valid sets' scoring and metrics, which come before the
    after-iteration callbacks): ``(callbacks, seconds)``, ``seconds``
    filled as training runs."""
    stamps, seconds = [], []

    def before(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    before.before_iteration = True
    before.order = -1

    def after(env):
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - stamps[-1])
    # first of the after-iteration callbacks, so early stopping's
    # exception cannot skip it
    after.order = -1
    return [before, after], seconds


def _eval_ms(torch, bst):
    """One iteration's evaluation cost, by CUDA events: scoring the
    valid set with the last tree (``tree_values`` over its bins, as
    ``train_one_iter`` does) plus every metric on it."""
    from lightgbm_tpu_torch.models.gbdt import tree_values
    v = bst._engine.valid_sets[0]
    tree = bst._models[-1]
    score_ms = events_ms(lambda: tree_values(tree, v.dataset), 3, torch)
    metric_ms = events_ms(bst.eval_valid, 3, torch)
    return score_ms, metric_ms


def phase_train_valid(torch, lgb, dev, tr, iters):
    """The main path with this slice's features at the Higgs shape: a
    500k-row valid set binned with the train set's mappers
    (``Dataset(reference=)``), ``metric=[auc, binary_logloss]``, bagging
    (0.8, every iteration), ``feature_fraction=0.8``, and the
    ``record_evaluation`` and ``early_stopping(5)`` callbacks; 1 warm-up
    + ``iters`` timed iterations. Each tree's root count equals its
    iteration's in-bag count; the last recorded valid AUC equals the AUC
    of ``predict``; against the plain twin (the same generator seeds) the
    same root split in every tree and AUC within 0.002."""
    from lightgbm_tpu_torch.metrics import auc
    ds, Xv, yv = tr["ds"], tr["Xv"], tr["yv"]
    t0 = time.perf_counter()
    dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    torch.cuda.synchronize()
    valid_construct_s = time.perf_counter() - t0
    params = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
              "learning_rate": 0.1, "metric": ["auc", "binary_logloss"],
              "bagging_fraction": 0.8, "bagging_freq": 1,
              "feature_fraction": 0.8, "verbosity": -1,
              "device_type": dev.type}
    def run(rounds, recorder=None):
        ev = {}
        bst = [None]
        clock, iter_s = _iteration_clock(torch)

        def attach(env):
            if bst[0] is None:
                bst[0] = env.model
                if recorder is not None:
                    recorder.append(_RowWeights(env.model._engine))
        attach.before_iteration = True
        attach.order = -2
        out = lgb.train(params, ds, rounds, valid_sets=[dv],
                        valid_names=["valid"],
                        callbacks=[attach, *clock,
                                   lgb.record_evaluation(ev),
                                   lgb.early_stopping(5, verbose=False)])
        return out, ev, iter_s

    torch.cuda.synchronize()
    _reset_counts()
    rec = []
    bst, ev, iter_s = run(1 + iters, rec)
    counts = _read_counts()
    leaves = [t.num_leaves for t in bst._models]
    _check_counts("train_valid", counts, leaves, "hist")
    in_bag = [r["in_bag"] for r in rec[0].seen]
    roots = _root_counts(bst)
    r_k = _roots(bst)
    n_iter = bst.current_iteration()
    p = bst.predict(Xv, num_iteration=n_iter)
    if p.shape != (len(yv),) or not np.all(np.isfinite(p)):
        raise AssertionError("train_valid: predictions are not finite [n] "
                             "values")
    auc_pred = auc(torch.as_tensor(p, device=dev),
                   torch.as_tensor(yv, device=dev))
    auc_rec = ev["valid"]["auc"][-1]
    score_ms, metric_ms = _eval_ms(torch, bst)
    # no profiled iteration, for the smoke's time (PERF.md §4)
    prof = None
    log(f"[train_valid] valid set {len(yv)} rows binned with the train "
        f"set's mappers in {valid_construct_s:.3f} s; iter_s="
        f"{[round(x, 4) for x in iter_s]} (the warm-up first; each with "
        f"its valid scoring and metrics) median_timed_iter_s="
        f"{statistics.median(iter_s[1:]):.4f} "
        f"eval_ms={score_ms + metric_ms:.3f} "
        f"(valid scoring of one tree {score_ms:.3f} + metrics "
        f"{metric_ms:.3f}, CUDA events) in-bag window sizes={in_bag} of "
        f"{ds.num_data()} rows, root counts={roots}, leaves={leaves}, "
        f"launches={json.dumps(counts)}")
    log(f"[train_valid] recorded valid auc={ev['valid']['auc']} "
        f"binary_logloss={ev['valid']['binary_logloss']}; auc of predict="
        f"{auc_pred!r} recorded={auc_rec!r} best_iteration="
        f"{bst.best_iteration}")
    if roots != in_bag:
        raise AssertionError(f"train_valid: root counts {roots} are not the "
                             f"in-bag counts {in_bag}")
    if not all(0.79 * ds.num_data() < b < 0.81 * ds.num_data()
               for b in in_bag):
        raise AssertionError("train_valid: in-bag counts far from 0.8 n")
    if abs(auc_rec - auc_pred) > 1e-5:
        raise AssertionError(f"train_valid: recorded AUC {auc_rec} is not "
                             f"the AUC of predict {auc_pred}")
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    with plain_kernels():
        ref, ev_p, _ = run(1 + iters)
    r_p = _roots(ref)
    auc_p = ev_p["valid"]["auc"][-1]
    log(f"[train_valid] plain twin: recorded valid auc={ev_p['valid']['auc']}"
        f"; root splits kernel={r_k} plain={r_p}")
    if r_k != r_p:
        raise AssertionError("train_valid: root splits differ from the "
                             "plain run's")
    if abs(auc_rec - auc_p) > 0.002:
        raise AssertionError(f"train_valid: AUC {auc_rec} not within 0.002 "
                             f"of the plain run's {auc_p}")
    del bst, ref
    return dict(counts=counts, leaves=leaves, iter_s=iter_s,
                eval_ms=score_ms + metric_ms, eval_score_ms=score_ms,
                eval_metric_ms=metric_ms, in_bag=in_bag, auc=auc_rec,
                auc_predict=auc_pred, auc_plain=auc_p, profile=prof,
                valid_construct_s=valid_construct_s, history=ev)


def phase_train_goss(torch, lgb, dev, tr, iters):
    """GOSS on the main path's data and Dataset (``learning_rate=0.5``,
    so GOSS samples from iteration int(1 / 0.5) = 2): 1 warm-up +
    ``iters`` timed iterations. Each sampled iteration's in-bag count is
    its top rows plus its sampled rest, and each tree's root count is
    its in-bag count; the plain twin, whose float histograms sum in
    float64, has the same root splits and AUC within 0.002."""
    ds, Xv, yv = tr["ds"], tr["Xv"], tr["yv"]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
              "learning_rate": 0.5, "data_sample_strategy": "goss",
              "verbosity": -1, "device_type": dev.type}
    rec = []

    def after_warmup(bst):
        rec.append(_RowWeights(bst._engine))
        return {}
    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters, "train_goss",
               after_warmup=after_warmup)
    _check_counts("train_goss", r["counts"], r["leaves"], "hist")
    seen = rec[0].seen
    roots = _root_counts(r["bst"])
    r_k = _roots(r["bst"])
    n = ds.num_data()
    log(f"[train_goss] sampled iterations {seen} of {n} rows (top_rate "
        f"0.2, other_rate 0.1: about {0.2 * n:.0f} + {0.1 * n:.0f}); "
        f"root counts={roots}")
    if len(seen) < 2:
        raise AssertionError("train_goss: GOSS sampled fewer than 2 "
                             "iterations")
    for s_ in seen:
        if s_["in_bag"] != s_["weight_one"] + s_["amplified"] \
                or roots[s_["iteration"]] != s_["in_bag"] \
                or not 0.19 * n <= s_["weight_one"] <= 0.25 * n:
            raise AssertionError(f"train_goss: iteration {s_} does not "
                                 "keep its top rows and sampled rest")
    # no profiled iteration, for the smoke's time (PERF.md §4)
    prof = None
    # the twin's float histograms sum in float64: GOSS weights its
    # sampled rows by 8, and float32 atomics over such windows drift
    # (see exact_float_sums), while the rows GOSS keeps depend on every
    # earlier tree
    with exact_float_sums(torch):
        bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                                 1 + iters, "train_goss")
    r_p = _roots(bst_p)
    log(f"[train_goss] root splits kernel={r_k} plain={r_p}")
    if r_k != r_p:
        raise AssertionError("train_goss: root splits differ from the "
                             "plain run's")
    if abs(r["auc"] - m_p["auc"]) > 0.002:
        raise AssertionError(f"train_goss: AUC {r['auc']} not within 0.002 "
                             f"of the plain run's {m_p['auc']}")
    del r["bst"], bst_p
    return dict(r, auc_plain=m_p["auc"], sampled=seen, profile=prof)


def phase_train_multiclass_dart(torch, lgb, dev, trm, iters):
    """BASELINE.json's config 4 at Covertype's shape: DART multiclass on
    ``train_multiclass``'s data and Dataset (531,012 + 50,000 rows x 54,
    7 classes, 255 leaves, bundled), ``drop_rate=0.1``,
    ``metric=multi_logloss`` on the 50,000 held-out rows as a valid set;
    1 warm-up + ``iters`` timed iterations of 7 trees. ``skip_drop=0``:
    with DART's default of 0.5 each iteration skips its drop with
    probability 1/2, and a run this short could drop nothing. Against
    the plain twin whose float sums are exact (``exact_float_sums``),
    every tree (after drop and normalize) is the same and the recorded
    multi_logloss is equal to 1e-5."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    ds, Xv, yv = trm["ds"], trm["Xv"], trm["yv"]
    dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    params = {**trm["params"], "boosting": "dart", "drop_rate": 0.1,
              "skip_drop": 0.0, "metric": "multi_logloss"}
    def run():
        ev = {}
        clock, iter_s = _iteration_clock(torch)
        bst = lgb.train(params, ds, 1 + iters, valid_sets=[dv],
                        valid_names=["valid"],
                        callbacks=[*clock, lgb.record_evaluation(ev)])
        return bst, ev, iter_s
    _reset_counts()
    bst, ev, iter_s = run()
    counts = _read_counts()
    leaves = [t.num_leaves for t in bst._models]
    _check_counts("train_multiclass_dart", counts, leaves, "hist")
    shrink = [round(t.shrinkage, 6) for t in bst._models]
    m = trm["scorer"](bst.predict(Xv))
    with plain_kernels(), exact_float_sums(torch):
        ref, ev_p, _ = run()
    same = [int(_same_structure(a, b) and np.allclose(
        a.leaf_value, b.leaf_value, rtol=1e-4, atol=1e-5)
        and a.shrinkage == b.shrinkage)
        for a, b in zip(bst._models, ref._models)]
    ll, ll_p = ev["valid"]["multi_logloss"], ev_p["valid"]["multi_logloss"]
    log(f"[train_multiclass_dart] skip_drop=0 so that every iteration after "
        f"the first drops trees (at DART's default 0.5 a {1 + iters}-"
        f"iteration run may drop none); "
        f"iter_s={[round(x, 4) for x in iter_s]} (the "
        f"warm-up first) leaves={leaves} launches={json.dumps(counts)} "
        f"tree shrinkage after drops={shrink}; recorded valid "
        f"multi_logloss={ll} plain={ll_p}; predict multi_logloss="
        f"{m['multi_logloss']!r} accuracy={m['accuracy']!r}; trees "
        f"identical to the plain run's: {same}")
    if len(same) != COV_CLASSES * (1 + iters) or not all(same):
        raise AssertionError("train_multiclass_dart: trees differ from the "
                             "plain run's")
    if not any(s_ < 0.1 - 1e-9 for s_ in shrink):
        raise AssertionError("train_multiclass_dart: no tree was dropped")
    if not np.allclose(ll, ll_p, rtol=0, atol=1e-5):
        raise AssertionError("train_multiclass_dart: recorded multi_logloss "
                             "differs from the plain run's")
    del bst, ref
    return dict(counts=counts, leaves=leaves, iter_s=iter_s,
                recorded_multi_logloss=ll, recorded_multi_logloss_plain=ll_p,
                predict_multi_logloss=m["multi_logloss"],
                accuracy=m["accuracy"], shrinkage=shrink, same_trees=same)


# A random forest written by the JAX package (lightgbm_tpu.train with
# boosting=rf, bagging_fraction=0.632, bagging_freq=1, num_leaves=4, 2
# iterations on 400 rows x 3 features), and its predictions on
# JAX_RF_ROWS: probabilities and raw scores
JAX_RF_MODEL = """tree
version=v4
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=2
objective=binary sigmoid:1
average_output
feature_names=Column_0 Column_1 Column_2
feature_infos=[-2.36959:2.41245] [-3.04614:3.17097] [-2.65562:2.69622]
tree_sizes=507 508

Tree=0
num_leaves=4
num_cat=0
split_feature=0 1 1
split_gain=115.193 27.5521 15.1993
threshold=0.041882283636099187 0.80848810914213076 -0.31799185609860103
decision_type=0 0 0
left_child=1 -1 -2
right_child=2 -3 -4
leaf_value=-1.7270087667147784 0.37875532430008363 0.48322974961594056 \
1.9098009399731488
leaf_weight=25.477 9.24167 7.24347 21.7304
leaf_count=102 37 29 87
internal_value=0.0706878 -1.23772 1.45296
internal_weight=63.6926 32.7205 30.9721
internal_count=255 131 124
is_linear=0
shrinkage=1

Tree=1
num_leaves=4
num_cat=0
split_feature=0 1 1
split_gain=100.159 19.7433 16.9917
threshold=0.23884295384435172 0.70021091237645705 -0.21824529913393112
decision_type=0 0 0
left_child=1 -1 -2
right_child=2 -3 -4
leaf_value=-1.6450089879672198 0.28600772541359376 0.11778798025444459 \
2.0018384985287518
leaf_weight=25.2273 8.74212 8.49235 16.9847
leaf_count=101 35 34 68
internal_value=-0.0672514 -1.20105 1.41879
internal_weight=59.4464 33.7196 25.7268
internal_count=238 135 103
is_linear=0
shrinkage=1

end of trees

feature_importances:
Column_1=4
Column_0=2

parameters:
end of parameters

pandas_categorical:null
"""
JAX_RF_ROWS = [[0.5, -1.0, 0.2], [-0.3, 0.8, float("nan")],
               [2.0, 0.1, -1.5], [-1.2, -0.4, 0.0]]
JAX_RF_PRED = [0.58233873, 0.30904017, 0.87607983, 0.15630143]
JAX_RF_RAW = [0.33238155, -0.80461043, 1.95581961, -1.68600893]


def phase_small_rf_cv(torch, lgb, dev):
    """Two small correctness runs on 200,000 x 28 rows. A random forest
    (``bagging_fraction=0.632``, every iteration; 3 iterations): its
    predictions after a save and load equal the in-memory ones, its raw
    scores are the mean of its iterations' and equal its running-average
    train score, and the JAX package's ``average_output`` model
    (:data:`JAX_RF_MODEL`) predicts JAX's numbers on the card. Then
    ``cv`` with 3 folds, 3 rounds and early stopping."""
    X, y = make_higgs_like(200_000, FEATURES, seed=3)
    base = {"objective": "binary", "num_leaves": 63, "max_bin": BINS,
            "verbosity": -1, "device_type": dev.type}
    ds = lgb.Dataset(X, label=y, params=base)
    params = {**base, "boosting": "rf", "bagging_fraction": 0.632,
              "bagging_freq": 1}
    _reset_counts()
    bst = lgb.train(params, ds, 3)
    counts = _read_counts()
    Xs = X[:20_000]
    raw = bst.predict(Xs, raw_score=True)
    per_iter = np.mean([bst.predict(Xs, start_iteration=i, num_iteration=1,
                                    raw_score=True) for i in range(3)],
                       axis=0)
    train_score = bst._engine.score[0, :20_000].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rf.txt")
        bst.save_model(path)
        loaded = lgb.Booster(model_file=path, params={"device_type":
                                                      dev.type})
        rt = float(np.abs(loaded.predict(Xs) - bst.predict(Xs)).max())
        path = os.path.join(tmp, "jax_rf.txt")
        with open(path, "w") as f:
            f.write(JAX_RF_MODEL)
        jb = lgb.Booster(model_file=path, params={"device_type": dev.type})
        jrows = np.asarray(JAX_RF_ROWS)
        jerr = max(float(np.abs(jb.predict(jrows) - JAX_RF_PRED).max()),
                   float(np.abs(jb.predict(jrows, raw_score=True)
                                - JAX_RF_RAW).max()))
    mean_err = float(np.abs(raw - per_iter).max())
    score_err = float(np.abs(raw - train_score).max())
    log(f"[small_rf] 200000x28, 3 iterations of "
        f"{[t.num_leaves for t in bst._models]} "
        f"leaves, root counts={_root_counts(bst)}, launches="
        f"{json.dumps(counts)}; save/load max abs diff={rt:.3g}; raw = mean "
        f"of the iterations' to {mean_err:.3g}, = the running-average train "
        f"score to {score_err:.3g}; the JAX package's average_output model "
        f"on the card: max abs err {jerr:.3g} against JAX's predictions")
    _check_counts("small_rf", counts, [t.num_leaves for t in bst._models],
                  "hist")
    if rt > 1e-6 or mean_err > 1e-5 or score_err > 1e-4 or jerr > 1e-6:
        raise AssertionError("small_rf: a random forest check failed")
    res = lgb.cv({**base, "early_stopping_round": 2, "learning_rate": 0.3},
                 ds, 3, nfold=3, return_cvbooster=True)
    cvb = res.pop("cvbooster")
    log(f"[small_cv] 3 folds of 200000 rows, 3 rounds: "
        + " ".join(f"{k}={v}" for k, v in res.items())
        + f" best_iteration={cvb.best_iteration}")
    if sorted(res) != ["valid binary_logloss-mean",
                       "valid binary_logloss-stdv"] \
            or not 1 <= len(res["valid binary_logloss-mean"]) <= 3 \
            or not np.all(np.isfinite(res["valid binary_logloss-mean"])) \
            or len(cvb.boosters) != 3:
        raise AssertionError(f"small_cv: unexpected result {res}")
    return dict(rf_counts=counts, cv=res)



ALLSTATE_ROWS = 100_000
ALLSTATE_VALID = 50_000
ALLSTATE_FEATURES = 4228


def _allstate_source(n):
    """A chunk source of :func:`make_allstate_like`'s rows (seed 0), its
    own draws yielded in chunks of ``STREAM_CHUNK`` rows by a factory,
    with the length declared (so the mappers' sample is the eager
    construct's row draw)."""
    from lightgbm_tpu_torch.data import GeneratorChunkSource
    return GeneratorChunkSource(
        lambda: allstate_chunks(n, ALLSTATE_FEATURES, seed=0,
                                rows=STREAM_CHUNK),
        num_rows=n, num_features=ALLSTATE_FEATURES)


def _stream_allstate(torch, lgb, dev, n, tag):
    """The streamed construct of ``n`` Allstate-shaped rows: the Dataset
    and a dict of its seconds, host peak (against the float matrix and
    against the bound of the sample plus one chunk) and device bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ds, secs, peak = _construct(torch, lgb, dev, _allstate_source(n),
                                {"max_bin": BINS,
                                 "ingest_chunk_rows": STREAM_CHUNK})
    st = ds._ingest_stats
    F = ALLSTATE_FEATURES
    matrix = n * F * 4
    bound = (st["sample_rows"] + STREAM_CHUNK) * F * 4
    out = dict(rows=n, construct_s=secs, pass1_s=st["pass1_s"],
               pass2_s=st["pass2_s"], chunks=st["chunks"], host_peak=peak,
               float_matrix_bytes=matrix, sample_chunk_bound=bound,
               device_bytes=torch.cuda.memory_allocated() - base,
               device_peak_bytes=torch.cuda.max_memory_allocated() - base,
               bins_bytes=ds._bins.numel() * ds._bins.element_size())
    log(f"[{tag}] rows={n} features={F} chunks={st['chunks']} "
        f"chunk_rows={st['chunk_rows']} sample_rows={st['sample_rows']} "
        f"construct_s={secs:.3f} pass1_s={st['pass1_s']:.3f} pass2_s="
        f"{st['pass2_s']:.3f} host_peak_bytes={peak} float matrix bytes="
        f"{matrix} (peak/matrix {peak / matrix:.4f}) sample+chunk bound "
        f"{bound} (peak/bound {peak / bound:.4f}) device bytes="
        f"{out['device_bytes']} device peak bytes={out['device_peak_bytes']}"
        f" bins bytes={out['bins_bytes']}")
    return ds, out


def phase_ingest_allstate(torch, lgb, dev, ref, n):
    """Streaming ingest at Allstate's width: the same ``n`` x 4,228 rows
    as train_allstate's eager Dataset ``ref``, yielded chunk by chunk by
    a factory (ingest_chunk_rows=65,536); device bins torch.equal to the
    eager Dataset's, mappers and labels equal."""
    ds, out = _stream_allstate(torch, lgb, dev, n, "ingest_allstate")
    _same_bins(torch, "ingest_allstate", ds, ref)
    log("[ingest_allstate] device bins torch.equal to the eager Dataset's, "
        "mappers and labels equal")
    del ds
    return out


def stream_allstate_only(torch, lgb, dev, n):
    """``--stream-allstate N``: only the streamed construct of ``n``
    Allstate-shaped rows (ROADMAP.md item 18's "done when" at 13.2M),
    then the bins of its first chunk held to an eager binning of the same
    rows with the same mappers, and the labels to the generator's."""
    from lightgbm_tpu_torch.ops.binning import bin_matrix
    ds, out = _stream_allstate(torch, lgb, dev, n, "stream_allstate")
    X0, y0 = next(allstate_chunks(n, ALLSTATE_FEATURES, seed=0,
                                  rows=STREAM_CHUNK))
    want = bin_matrix(X0, ds.used_feature_indices(), ds.mappers,
                      device=dev)
    ok = torch.equal(ds.device_bins()[:len(y0)], want) and \
        np.array_equal(ds.get_label()[:len(y0)], y0) and \
        ds.num_data() == n
    log(f"[stream_allstate] first chunk's bins equal to an eager binning "
        f"with the same mappers, labels equal: {ok}; positive share "
        f"{float(np.mean(ds.get_label())):.4f}")
    if not ok:
        raise AssertionError("stream_allstate: the streamed bins are off")
    return out


def phase_train_allstate(torch, lgb, dev, n_train, iters, reps):
    """EFB at full width: Allstate's shape (``make_allstate_like``, 4,228
    features in 33 one-hot blocks of 128 with NaN in column 0;
    ``n_train`` (100,000) training rows, seed 0, and 50,000 held out,
    seed 1), binary, 255
    leaves, 255 bins, EFB at its default. Reduced: rows 13,200,000 ->
    100,000 (the float32 input alone would be ~223 GB of host memory;
    500,000 until PR 16, then 200,000, cut for the smoke's time); the
    bundling sample holds every row.
    Prints construct_s, the bundling seconds, G, B, the peak device
    memory, iter_s (1 warm-up + ``iters`` timed) and AUC (no profiled
    iteration, for the smoke's time). Then ingest_allstate
    (:func:`phase_ingest_allstate`) on the eager Dataset. Checks: the bundled matrix built on the device equals the numpy build
    from the same plan on 100,000 of its rows; against the plain twin
    (float64 histogram sums, the same Dataset) the same root split in
    every tree and AUC within 0.002; K1 and K2 launched at G columns;
    then K1 and K2 at this width alone (:func:`phase_bundled_kernels`)."""
    from lightgbm_tpu_torch.ops.bundling import bundle_columns_np
    from lightgbm_tpu_torch.ops.partition import RangeRules
    t0 = time.perf_counter()
    Xt, yt = make_allstate_like(n_train, ALLSTATE_FEATURES, seed=0)
    Xv, yv = make_allstate_like(ALLSTATE_VALID, ALLSTATE_FEATURES, seed=1)
    log(f"[train_allstate] data rows={n_train}+{ALLSTATE_VALID} "
        f"features={ALLSTATE_FEATURES} positive share={float(yt.mean()):.4f}"
        f" reduced: rows 13200000 -> {n_train} (host memory) "
        f"gen_s={time.perf_counter() - t0:.2f}")
    params = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
              "learning_rate": 0.1, "verbosity": -1,
              "device_type": dev.type}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, params={"max_bin": BINS,
                                           "device_type": dev.type})
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    log(f"[train_allstate] construct_s={construct_s:.3f} used features="
        f"{len(ds.mappers)} device bytes={torch.cuda.memory_allocated()}")
    del Xt
    ingest = phase_ingest_allstate(torch, lgb, dev, ds, n_train)
    bundles = _bundle_stats(torch, lgb, ds, params, "train_allstate")
    from lightgbm_tpu_torch.config import Config
    info = ds.bundles(Config.from_params(params))
    host = ds._bins[:100_000].numpy()
    want = bundle_columns_np(host, info.groups, info.offset_of, np.uint8)
    if not np.array_equal(info.bins_bundled[:100_000].cpu().numpy(), want):
        raise AssertionError("train_allstate: the bundled matrix built on "
                             "the device != the numpy build")
    log(f"[train_allstate] the device's bundled matrix equals the numpy "
        f"build from the same plan on {len(host)} rows")
    del host, want
    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters, "train_allstate")
    _check_counts("train_allstate", r["counts"], r["leaves"], "hist")
    # no profiled iteration, for the smoke's time (PERF.md §4)
    prof = None
    with exact_float_sums(torch):
        bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                                 1 + iters, "train_allstate")
    roots_k = [_root_split_of(t) for t in r["bst"]._models[:1 + iters]]
    roots_p = [_root_split_of(t) for t in bst_p._models]
    log(f"[train_allstate] root splits kernel={roots_k} plain={roots_p}; "
        f"auc={r['auc']:.6f} plain={m_p['auc']:.6f}; peak_mem_bytes="
        f"{r['peak']}")
    if roots_k != roots_p:
        raise AssertionError("train_allstate: root splits differ from the "
                             "plain run's")
    if abs(r["auc"] - m_p["auc"]) > 0.002:
        raise AssertionError(f"train_allstate: AUC {r['auc']} not within "
                             f"0.002 of the plain run's {m_p['auc']}")
    del r["bst"], bst_p
    kern = phase_bundled_kernels(
        torch, dev, info, RangeRules(ds.feat_num_bins(), ds.feat_nan_bin(),
                                     info), "allstate_bundled", reps)
    del ds, info
    return dict(r, auc_plain=m_p["auc"], construct_s=construct_s,
                bundles=bundles, profile=prof, kernels=kern,
                roots=roots_k, ingest=ingest)


class _SplitTally:
    """Counts the grower's splits by the direction of their records
    (0/1 numerical, 2 one-hot, 3 forward subset, 4 backward subset)
    while it is entered; it wraps ``ops.grow._apply_split`` and changes
    nothing else."""

    def __init__(self):
        self.by_dir = [0] * 5

    def __enter__(self):
        from lightgbm_tpu_torch.ops import grow
        from lightgbm_tpu_torch.ops.split import F_
        self._orig = orig = grow._apply_split

        def tally(t, rec, *a, **kw):
            self.by_dir[int(rec[F_["direction"]])] += 1
            return orig(t, rec, *a, **kw)
        grow._apply_split = tally
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.ops import grow
        grow._apply_split = self._orig

    def shares(self):
        total = max(1, sum(self.by_dir))
        return dict(splits=sum(self.by_dir),
                    categorical=sum(self.by_dir[2:]) / total,
                    one_hot=self.by_dir[2] / total,
                    forward=self.by_dir[3] / total,
                    backward=self.by_dir[4] / total)


def _same_trees(a, b, exact_values):
    return len(a) == len(b) and all(
        _same_structure(x, y) and (
            np.array_equal(x.leaf_value, y.leaf_value) if exact_values
            else np.allclose(x.leaf_value, y.leaf_value, rtol=1e-4,
                             atol=1e-5))
        for x, y in zip(a, b))


def phase_train_airline(torch, lgb, dev, n_train, iters, reps):
    """Categorical splits at full width: the airline benchmark's shape
    (``make_airline_like``: 10,000,000 training rows, seed 0, and 500,000
    held out, seed 1; 6 categorical and 2 numerical features), binary,
    255 leaves, 255 bins, ``categorical_feature`` the six, other
    parameters at their defaults; reduced: none. 1 warm-up + ``iters``
    timed iterations. Prints construct_s, the mappers' bin counts,
    iter_s, the idle share and launches of one profiled iteration, the
    share of categorical splits and of each family, the peak device
    memory and AUC. Checks: against the float64-sum plain twin the same
    root split in every tree and AUC within 0.002; one quantized
    iteration (round to nearest) whose tree equals its plain twin's;
    raw predictions equal to a numpy walk of the saved model text on
    100,000 held-out rows; save/load/predict equal; K1, K2 and K2's
    membership rule launched; then K1 and K2 at this width alone."""
    from lightgbm_tpu_torch.ops.partition import RangeRules
    t0 = time.perf_counter()
    Xt, yt = make_airline_like(n_train, seed=0)
    Xv, yv = make_airline_like(AIRLINE_VALID, seed=1)
    log(f"[train_airline] data rows={n_train}+{AIRLINE_VALID} features="
        f"{AIRLINE_NAMES} positive share={float(yt.mean()):.4f} reduced: "
        f"none gen_s={time.perf_counter() - t0:.2f}")
    cats = list(range(len(AIRLINE_CATS)))
    params = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
              "verbosity": -1, "device_type": dev.type,
              "categorical_feature": cats}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=yt, feature_name=AIRLINE_NAMES,
                     categorical_feature=cats,
                     params={"max_bin": BINS, "device_type": dev.type})
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    nbins = [int(m.num_bins) for m in ds.mappers]
    log(f"[train_airline] construct_s={construct_s:.3f} bins per mapper="
        f"{dict(zip(AIRLINE_NAMES, nbins))} categorical="
        f"{[m.bin_type == 'categorical' for m in ds.mappers]}")
    del Xt
    with _SplitTally() as tally:
        r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters,
                   "train_airline")
    _check_counts("train_airline", r["counts"], r["leaves"], "hist")
    if r["counts"]["partition_member"] <= 0:
        raise AssertionError("train_airline: no membership-rule launch")
    shares = tally.shares()
    log(f"[train_airline] splits by family: {json.dumps(shares)} "
        f"membership launches={r['counts']['partition_member']}")
    # no profiled iteration, for the smoke's time (PERF.md §4)
    prof = None
    bst = r["bst"]
    # raw predictions against a numpy walk of the saved model text
    n_walk = 100_000
    raw = bst.predict(Xv[:n_walk], num_iteration=1 + iters,
                      raw_score=True)
    text = bst.model_to_string(num_iteration=1 + iters)
    walk = numpy_predict_raw(text, Xv[:n_walk])
    walk_err = float(np.abs(raw - walk).max())
    log(f"[train_airline] raw predict vs numpy walk of the model text on "
        f"{n_walk} held-out rows: max_abs_diff={walk_err:.3g}")
    if walk_err > 1e-4:
        raise AssertionError(f"train_airline: raw predictions differ from "
                             f"the model text's walk by {walk_err}")
    with exact_float_sums(torch):
        bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                                 1 + iters, "train_airline")
    roots_k = [_root_split_of(t) for t in bst._models[:1 + iters]]
    roots_p = [_root_split_of(t) for t in bst_p._models]
    log(f"[train_airline] root splits kernel={roots_k} plain={roots_p}; "
        f"auc={r['auc']:.6f} plain={m_p['auc']:.6f}; peak_mem_bytes="
        f"{r['peak']}")
    if roots_k != roots_p:
        raise AssertionError("train_airline: root splits differ from the "
                             "plain run's")
    if abs(r["auc"] - m_p["auc"]) > 0.002:
        raise AssertionError(f"train_airline: AUC {r['auc']} not within "
                             f"0.002 of the plain run's {m_p['auc']}")
    del r["bst"], bst, bst_p
    # one quantized iteration, tree for tree against its plain twin
    qparams = dict(params, use_quantized_grad=True,
                   stochastic_rounding=False)
    _reset_counts()
    bq = lgb.train(qparams, ds, num_boost_round=1)
    qcounts = _read_counts()
    _check_counts("train_airline_quant", qcounts,
                  [t.num_leaves for t in bq._models], "hist_int")
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    with plain_kernels():
        bq_p = lgb.train(qparams, ds, num_boost_round=1)
    same_q = _same_trees(bq._models, bq_p._models, True)
    log(f"[train_airline] quantized iteration: {bq._models[0].num_leaves} "
        f"leaves, {bq._models[0].num_cat} categorical splits, launches="
        f"{json.dumps(qcounts)}, tree identical to the plain run's: "
        f"{same_q}")
    if not same_q:
        raise AssertionError("train_airline: the quantized tree differs "
                             "from the plain run's")
    del bq, bq_p
    # K1 and K2 at this width alone: K2 by the membership rule of an
    # Origin split (a random 40% of its bins) and by a DepTime range rule
    bins = ds.device_bins()
    B = ds.num_total_bins()
    rules = RangeRules(ds.feat_num_bins(), ds.feat_nan_bin())
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    origin = AIRLINE_NAMES.index("Origin")
    mask = (torch.rand((1, B), generator=gen, device=dev) < 0.4) \
        & (torch.arange(B, device=dev) < nbins[origin])[None]
    picks = [("member Origin", rules(origin, 0) + (
                 False, rules.bitsets([origin], mask, B)[0])),
             ("range DepTime", rules(6, nbins[6] // 2) + (False,))]
    info = _Plain(bins, B)
    kern = phase_bundled_kernels(torch, dev, info, rules, "airline", reps,
                                 k2_picks=picks)
    del ds, bins, info
    return dict(r, auc_plain=m_p["auc"], construct_s=construct_s,
                bins=nbins, families=shares, profile=prof, kernels=kern,
                roots=roots_k, walk_err=walk_err, quant_counts=qcounts)


class _Plain:
    """A plain bin matrix in the place of a bundling plan (each column
    its own group) for :func:`phase_bundled_kernels`."""
    def __init__(self, bins, B):
        self.bins_bundled = bins
        self.num_positions = B
        self.groups = [[j] for j in range(bins.shape[1])]


def _small_run(torch, lgb, dev, tag, params, X, y, rounds=SMALL_TREES):
    """Train ``rounds`` trees on quantized gradients (round to nearest),
    its twin with the plain kernels, and a save/load round trip: every
    tree equal to the twin's, leaf values included, and the reloaded
    model's predictions equal. Quantized histograms are exact, so both
    runs break ties alike: a one-hot candidate and its mirror (the other
    category of a two-category leaf) tie in real arithmetic, and so do
    thresholds whose outputs the monotone bounds clamp to one value;
    float sums in another order pick another of them. Returns the
    booster, the Dataset and the counts."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    params = dict(params, use_quantized_grad=True, stochastic_rounding=False)
    ds = lgb.Dataset(X, label=y, params=params)
    _reset_counts()
    bst = lgb.train(params, ds, rounds)
    counts = _read_counts()
    _check_counts(tag, counts, [t.num_leaves for t in bst._models],
                  "hist_int")
    with plain_kernels():
        ref = lgb.train(params, ds, rounds)
    same = [int(_same_trees([a], [b], True))
            for a, b in zip(bst._models, ref._models)]
    p = bst.predict(X[:50_000])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        p2 = lgb.Booster(model_file=path,
                         params={"device_type": dev.type}).predict(
            X[:50_000])
    rt = float(np.abs(p2 - p).max())
    log(f"[{tag}] {X.shape[0]}x{X.shape[1]}, {rounds} trees of "
        f"{[t.num_leaves for t in bst._models]} leaves, categorical splits "
        f"{[t.num_cat for t in bst._models]}, launches={json.dumps(counts)}"
        f", trees identical to the plain run's: {same}; save/load max diff "
        f"{rt:.3g}")
    if len(same) != rounds or not all(same):
        raise AssertionError(f"{tag}: trees differ from the plain run's")
    if not np.all(np.isfinite(p)) or rt > 1e-6:
        raise AssertionError(f"{tag}: save/load/predict differs from the "
                             "in-memory prediction")
    return bst, ds, counts


MONO = {0: 1, 1: 1, 2: -1, 3: -1}


def phase_small_categorical(torch, lgb, dev):
    """Correctness runs (not timed): the one-hot family (200,000 rows,
    three categoricals of at most ``max_cat_to_onehot`` categories beside
    two numerical features); EFB with categorical members (12 sparse
    categoricals of 4 categories in three mutually exclusive blocks of
    4, beside 4 dense numerical features); basic monotone constraints on
    200,000 x 28 Higgs-shaped rows (features 0-1 increasing, 2-3
    decreasing) alone, with ``monotone_penalty=2.0`` and with
    ``path_smooth=1.0``; 2 trees of 63 leaves each. Each run's trees
    equal its float64-sum plain twin's and save/load/predict equals the
    in-memory prediction (quantized gradients, :func:`_small_run`); the
    monotone runs' predictions are monotone
    along each constrained feature (each swept over 40 values of its
    range on 1,000 rows with the others fixed)."""
    from lightgbm_tpu_torch.config import Config
    out = {}
    base = {"objective": "binary", "num_leaves": 63, "max_bin": BINS,
            "verbosity": -1, "device_type": dev.type}
    rs = np.random.RandomState(21)
    n = 200_000
    # one-hot family
    C = rs.randint(0, 4, (n, 3)).astype(np.float32)
    N = rs.randn(n, 2).astype(np.float32)
    X = np.column_stack([C, N])
    logit = 0.8 * (C[:, 0] == 2) - 0.6 * (C[:, 1] == 1) \
        + 0.4 * (C[:, 2] == 3) + 0.5 * N[:, 0]
    y = (rs.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    p = dict(base, categorical_feature=[0, 1, 2])
    with _SplitTally() as tally:
        bst, _, counts = _small_run(torch, lgb, dev, "small_onehot", p, X,
                                    y)
    sh = tally.shares()
    log(f"[small_onehot] splits by family: {json.dumps(sh)}")
    if sh["one_hot"] <= 0 or sh["forward"] + sh["backward"] > 0:
        raise AssertionError("small_onehot: no one-hot split, or a sorted "
                             "subset on a feature of <= 4 categories")
    out["onehot"] = dict(counts=counts, families=sh)
    # EFB with categorical members
    Xe = np.zeros((n, 16), np.float32)
    Xe[:, 12:] = rs.randn(n, 4)
    for blk in range(3):
        col = 4 * blk + rs.randint(0, 4, n)
        on = rs.rand(n) < 0.12
        Xe[np.nonzero(on)[0], col[on]] = rs.randint(1, 4, int(on.sum()))
    logit = Xe[:, 12] + 0.8 * (Xe[:, 1] == 2) - 0.8 * (Xe[:, 6] == 3) \
        + 0.6 * (Xe[:, 9] == 1)
    ye = (rs.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    p = dict(base, categorical_feature=list(range(12)))
    with _SplitTally() as tally:
        bst, ds, counts = _small_run(torch, lgb, dev, "small_efb_cat", p,
                                     Xe, ye)
    info = ds.bundles(Config.from_params(p))
    multi = [g for g in (info.groups if info is not None else [])
             if len(g) > 1]
    cat_members = sorted(j for g in multi for j in g
                         if ds.mappers[j].bin_type == "categorical")
    sh = tally.shares()
    log(f"[small_efb_cat] bundles: {multi}, categorical members "
        f"{cat_members}; splits by family: {json.dumps(sh)}")
    if not cat_members or sh["categorical"] <= 0 \
            or counts["partition_member"] <= 0:
        raise AssertionError("small_efb_cat: no bundled categorical member "
                             "or no categorical split")
    out["efb_cat"] = dict(counts=counts, families=sh, bundles=multi)
    # basic monotone constraints
    Xm, ym = make_higgs_like(n, FEATURES, seed=4)
    mc = [MONO.get(j, 0) for j in range(FEATURES)]
    rows = Xm[:1000].copy()
    for name, extra in (("small_monotone", {}),
                        ("small_monotone_penalty", {"monotone_penalty":
                                                    2.0}),
                        ("small_monotone_smooth", {"path_smooth": 1.0})):
        p = dict(base, monotone_constraints=mc, **extra)
        bst, _, counts = _small_run(torch, lgb, dev, name, p, Xm, ym)
        worst = 0.0
        for f, sign in MONO.items():
            grid = np.quantile(Xm[:, f], np.linspace(0.0, 1.0, 40))
            preds = []
            for g in grid:
                rows[:, f] = g
                preds.append(bst.predict(rows, raw_score=True))
            rows[:, f] = Xm[:1000, f]
            steps = sign * np.diff(np.stack(preds), axis=0)
            worst = min(worst, float(steps.min()))
        log(f"[{name}] monotone sweep over features {list(MONO)}: the "
            f"largest step against the constraint {worst:.3g}")
        if worst < -1e-6:
            raise AssertionError(f"{name}: predictions are not monotone")
        out[name] = dict(counts=counts, worst_step=worst)
    return out


def _root_split_of(tree):
    return int(tree.split_feature[0]), int(tree.threshold_bin[0])


def _monotone_sweep(bst, X, mono, rows=1000, points=40):
    """The largest step against a constraint when each constrained
    feature of ``mono`` ({feature: sign}) sweeps ``points`` quantiles of
    its range on ``rows`` rows with the others fixed (0 or positive:
    monotone)."""
    base = X[:rows].copy()
    worst = 0.0
    for f, sign in mono.items():
        grid = np.quantile(X[:, f], np.linspace(0.0, 1.0, points))
        preds = []
        for g in grid:
            base[:, f] = g
            preds.append(bst.predict(base, raw_score=True))
        base[:, f] = X[:rows, f]
        steps = sign * np.diff(np.stack(preds), axis=0)
        worst = min(worst, float(steps.min()))
    return worst


def _twin_trees(torch, lgb, dev, tag, params, ds, rounds, hist_key):
    """``rounds`` trees with the kernels, launch counts from 0, and the
    same training with the plain kernels: every tree equal to the
    twin's, leaf values included. Returns the booster, the twin and the
    counts."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, rounds)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _read_counts()
    leaves = [t.num_leaves for t in bst._models]
    _check_counts(tag, counts, leaves, hist_key)
    with plain_kernels():
        ref = lgb.train(params, ds, rounds)
    same = [int(_same_trees([a], [b], True))
            for a, b in zip(bst._models, ref._models)]
    log(f"[{tag}] {rounds} trees of {leaves} leaves in {train_s:.2f} s, "
        f"launches={json.dumps(counts)}, trees identical to the plain "
        f"run's: {same}")
    if len(same) != rounds or not all(same):
        raise AssertionError(f"{tag}: trees differ from the plain run's")
    return bst, ref, dict(counts=counts, leaves=leaves, train_s=train_s)


def _paths_in_groups(tree, groups):
    """Whether every root-to-leaf path of ``tree`` uses features of one
    group only."""
    sets = [set(g) for g in groups]
    stack = [(0, frozenset())]
    while stack:
        node, used = stack.pop()
        if node < 0:
            if not any(used <= g for g in sets):
                return False
            continue
        u = used | {int(tree.split_feature[node])}
        stack += [(int(tree.left_child[node]), u),
                  (int(tree.right_child[node]), u)]
    return True


ADVANCED_LEAVES = 255
ADVANCED_MAX_S = 60.0


def phase_train_constrained(torch, lgb, dev, tr, iters):
    """This slice's path at full width, on ``train``'s Dataset (10.5M +
    500k held-out rows x 28, binary, 255 leaves, 255 bins):

    - ``intermediate`` monotone constraints on features 0-3 (``MONO``),
      float gradients, 1 warm-up + ``iters`` timed iterations: iter_s,
      leaves re-searched per tree (no profiled iteration, for the
      smoke's time); against the float64-sum plain twin the same
      root split in every tree and AUC within 0.002; one quantized tree
      equal to its twin's;
    - ``advanced``, quantized, one tree of ``ADVANCED_LEAVES`` leaves
      equal to its twin's: the chunk of queried leaves, peak device
      memory and the tree's seconds;
    - ``interaction_forced``: quantized, one tree, four interaction
      groups of seven features and a forced-split JSON of three nodes on
      group 0 (the root and both children at the features' medians):
      the tree equal to its twin's, its first three splits the forced
      ones, every root-to-leaf path inside one group;
    - ``cegb``: quantized, two trees (the state carries across them),
      ``cegb_penalty_split`` 1e-6, coupled penalties on features 4-7
      and lazy ones on 8-11: both trees and the lazy matrix equal to the
      twin's; the lazy matrix's bytes.

    The intermediate and advanced models sweep each constrained feature
    over 40 values on 1,000 held-out rows: no step against a
    constraint."""
    ds, Xv, yv = tr["ds"], tr["Xv"], tr["yv"]
    mc = [MONO.get(j, 0) for j in range(FEATURES)]
    base = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
            "learning_rate": 0.1, "verbosity": -1, "device_type": dev.type}
    quant = {"use_quantized_grad": True, "stochastic_rounding": False}
    out = {}
    # -- intermediate, float gradients --
    params = dict(base, monotone_constraints=mc,
                  monotone_constraints_method="intermediate")
    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters,
               "train_intermediate")
    _check_counts("train_intermediate", r["counts"], r["leaves"], "hist")
    grower = r["bst"]._engine.grower
    researched = grower.researched / max(1, len(r["leaves"]))
    grower.researched = 0
    # no profiled iteration, for the smoke's time (PERF.md §4)
    prof = None
    worst = _monotone_sweep(r["bst"], Xv, MONO)
    with exact_float_sums(torch):
        bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                                 1 + iters, "train_intermediate")
    roots_k = [_root_split_of(t) for t in r["bst"]._models[:1 + iters]]
    roots_p = [_root_split_of(t) for t in bst_p._models]
    log(f"[train_intermediate] leaves re-searched per tree {researched:.1f}"
        f"; root splits kernel={roots_k} plain="
        f"{roots_p}; auc={r['auc']:.6f} plain={m_p['auc']:.6f}; monotone "
        f"sweep: largest step against a constraint {worst:.3g}")
    if roots_k != roots_p:
        raise AssertionError("train_intermediate: root splits differ from "
                             "the plain run's")
    if abs(r["auc"] - m_p["auc"]) > 0.002:
        raise AssertionError(f"train_intermediate: AUC {r['auc']} not "
                             f"within 0.002 of the plain run's {m_p['auc']}")
    if worst < -1e-6:
        raise AssertionError("train_intermediate: predictions are not "
                             "monotone")
    del r["bst"], bst_p
    out["intermediate"] = dict(r, auc_plain=m_p["auc"], profile=prof,
                               researched_per_tree=researched,
                               worst_step=worst)
    _, _, q = _twin_trees(torch, lgb, dev, "train_intermediate_quant",
                          dict(params, **quant), ds, 1, "hist_int")
    out["intermediate_quant"] = q
    # -- advanced, quantized, one tree --
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = dict(base, **quant, monotone_constraints=mc,
                  num_leaves=ADVANCED_LEAVES,
                  monotone_constraints_method="advanced")
    bst, _, a = _twin_trees(torch, lgb, dev, "train_advanced", params, ds, 1,
                            "hist_int")
    peak = torch.cuda.max_memory_allocated()
    worst = _monotone_sweep(bst, Xv, MONO)
    chunk = bst._engine.grower.adv_chunk
    log(f"[train_advanced] one tree of {ADVANCED_LEAVES} leaves: "
        f"tree_s={a['train_s']:.2f} bounds chunk={chunk} leaves "
        f"peak_mem_bytes={peak}; monotone sweep: largest step against a "
        f"constraint {worst:.3g}")
    if worst < -1e-6:
        raise AssertionError("train_advanced: predictions are not monotone")
    if a["train_s"] > ADVANCED_MAX_S:
        log(f"[train_advanced] the tree took more than {ADVANCED_MAX_S} s")
    out["advanced"] = dict(a, chunk=chunk, peak=peak, worst_step=worst)
    del bst
    # -- interaction constraints and forced splits, quantized, one tree --
    groups = [list(range(7 * g, 7 * g + 7)) for g in range(4)]
    Xt = tr["Xt"]
    med = [float(np.median(Xt[:200_000, j])) for j in range(3)]
    forced = {"feature": 0, "threshold": med[0],
              "left": {"feature": 1, "threshold": med[1]},
              "right": {"feature": 2, "threshold": med[2]}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "forced.json")
        with open(path, "w") as fh:
            json.dump(forced, fh)
        params = dict(base, **quant, interaction_constraints=groups,
                      forcedsplits_filename=path)
        bst, _, c = _twin_trees(torch, lgb, dev, "train_interaction_forced",
                                params, ds, 1, "hist_int")
    t = bst._models[0]
    want_bins = [int(ds.mappers[j].value_to_bin(np.asarray([med[j]]))[0])
                 for j in range(3)]
    got = [(int(t.split_feature[i]), int(t.threshold_bin[i]))
           for i in range(3)]
    in_groups = _paths_in_groups(t, groups)
    log(f"[train_interaction_forced] first splits {got} (forced "
        f"{list(zip(range(3), want_bins))}), every path inside one group: "
        f"{in_groups}")
    if got != list(zip(range(3), want_bins)) or not in_groups:
        raise AssertionError("train_interaction_forced: forced splits or "
                             "interaction groups not kept")
    out["interaction_forced"] = c
    del bst
    # -- CEGB, quantized, two trees --
    coupled = [0.0] * FEATURES
    lazy = [0.0] * FEATURES
    for j in range(4, 8):
        coupled[j] = 50.0
    for j in range(8, 12):
        lazy[j] = 1e-6
    params = dict(base, **quant, cegb_penalty_split=1e-6,
                  cegb_penalty_feature_coupled=coupled,
                  cegb_penalty_feature_lazy=lazy)
    bst, ref, c = _twin_trees(torch, lgb, dev, "train_cegb", params, ds, 2,
                              "hist_int")
    st, st_p = bst._engine.cegb_state, ref._engine.cegb_state
    same_lazy = bool(torch.equal(st.lazy_used, st_p.lazy_used))
    lazy_bytes = st.lazy_used.numel() * st.lazy_used.element_size()
    used = np.nonzero(st.coupled_host)[0].tolist()
    log(f"[train_cegb] coupled features used {used}, lazy bits set "
        f"{int(st.lazy_used.sum())} (equal to the "
        f"plain run's: {same_lazy}), lazy matrix {lazy_bytes} bytes")
    if not same_lazy or not np.array_equal(st.coupled_host,
                                           st_p.coupled_host):
        raise AssertionError("train_cegb: CEGB state differs from the plain "
                             "run's")
    out["cegb"] = dict(c, lazy_bytes=lazy_bytes)
    del bst, ref
    return out


def phase_small_constraints(torch, lgb, dev):
    """Correctness runs (not timed, quantized, 2 trees of 63 leaves, each
    equal to its plain twin's, save/load/predict equal, :func:`_small_run`)
    on ``small_categorical``'s data: 200,000 rows of 12 sparse
    categoricals in three exclusive blocks beside 4 dense features, and
    200,000 x 28 Higgs-shaped rows. Intermediate and advanced monotone
    with the categoricals (unbundled), intermediate bundled, a forced
    split on a member of a multi-member bundle (the sparse columns as
    numbers), interaction constraints bundled, CEGB with bagging 0.8.
    Monotone runs sweep their constrained features."""
    out = {}
    base = {"objective": "binary", "num_leaves": 63, "max_bin": BINS,
            "verbosity": -1, "device_type": dev.type}
    rs = np.random.RandomState(21)
    n = 200_000
    rs.randint(0, 4, (n, 3))
    rs.randn(n, 2)
    rs.rand(n)
    Xe = np.zeros((n, 16), np.float32)
    Xe[:, 12:] = rs.randn(n, 4)
    for blk in range(3):
        col = 4 * blk + rs.randint(0, 4, n)
        on = rs.rand(n) < 0.12
        Xe[np.nonzero(on)[0], col[on]] = rs.randint(1, 4, int(on.sum()))
    logit = Xe[:, 12] - 0.5 * Xe[:, 13] + 0.8 * (Xe[:, 1] == 2) \
        - 0.8 * (Xe[:, 6] == 3) + 0.6 * (Xe[:, 9] == 1)
    ye = (rs.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    mono_e = {12: 1, 13: -1}
    mc_e = [mono_e.get(j, 0) for j in range(16)]
    cats = list(range(12))
    runs = (
        ("small_intermediate_cat", Xe, ye, mono_e,
         dict(categorical_feature=cats, enable_bundle=False,
              monotone_constraints=mc_e,
              monotone_constraints_method="intermediate")),
        ("small_advanced_cat", Xe, ye, mono_e,
         dict(categorical_feature=cats, enable_bundle=False,
              monotone_constraints=mc_e,
              monotone_constraints_method="advanced")),
        ("small_intermediate_bundled", Xe, ye, mono_e,
         dict(categorical_feature=cats, monotone_constraints=mc_e,
              monotone_constraints_method="intermediate")),
        ("small_interaction_bundled", Xe, ye, {},
         dict(interaction_constraints=[[0, 1, 2, 3, 12, 13],
                                       list(range(4, 12)) + [14, 15]])),
    )
    for name, X, y, mono, extra in runs:
        bst, ds, counts = _small_run(torch, lgb, dev, name,
                                     dict(base, **extra), X, y)
        res = dict(counts=counts)
        if mono:
            res["worst_step"] = worst = _monotone_sweep(bst, X, mono)
            log(f"[{name}] monotone sweep: largest step against a "
                f"constraint {worst:.3g}")
            if worst < -1e-6:
                raise AssertionError(f"{name}: predictions are not monotone")
        if name == "small_intermediate_bundled" and ds.bundles(
                _config(base, extra)) is None:
            raise AssertionError(f"{name}: nothing bundled")
        out[name] = res
    # a forced split on a member of a multi-member bundle
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "forced.json")
        with open(path, "w") as fh:
            json.dump({"feature": 1, "threshold": 1.5,
                       "left": {"feature": 12, "threshold": 0.0},
                       "right": {"feature": 6, "threshold": 2.5}}, fh)
        extra = dict(forcedsplits_filename=path)
        bst, ds, counts = _small_run(torch, lgb, dev, "small_forced_member",
                                     dict(base, **extra), Xe, ye)
    info = ds.bundles(_config(base, extra))
    first = [[int(t.split_feature[i]) for i in range(3)]
             for t in bst._models]
    log(f"[small_forced_member] feature 1 bundled with "
        f"{info.groups[int(info.bundle_of[1])]}; first splits {first}")
    if info.is_direct[1] or info.is_direct[6] \
            or any(f != [1, 12, 6] for f in first):
        raise AssertionError("small_forced_member: the forced splits are "
                             "not on bundled members")
    out["small_forced_member"] = dict(counts=counts)
    # CEGB with bagging
    Xm, ym = make_higgs_like(n, FEATURES, seed=4)
    lazy = [0.0] * FEATURES
    lazy[5] = lazy[9] = 2e-5
    coupled = [0.0] * FEATURES
    coupled[2] = coupled[7] = 5.0
    extra = dict(bagging_fraction=0.8, bagging_freq=1,
                 cegb_penalty_split=2e-5, cegb_penalty_feature_lazy=lazy,
                 cegb_penalty_feature_coupled=coupled)
    bst, ds, counts = _small_run(torch, lgb, dev, "small_cegb_bagged",
                                 dict(base, **extra), Xm, ym)
    out["small_cegb_bagged"] = dict(counts=counts)
    return out


def _config(base, extra):
    from lightgbm_tpu_torch.config import Config
    return Config.from_params(dict(base, **extra))


def _shap_oracle(tree, x):
    """TreeSHAP of one row through one parsed tree (``_parse_model``'s
    dict), the textbook single-row recursion (Lundberg et al. 2018,
    Algorithm 2) with LightGBM's decisions, in Python floats:
    ``[F + 1]`` with the expected value last."""
    F = len(x)
    phi = np.zeros(F + 1)
    sf, thr, dt = tree["split_feature"], tree["threshold"], \
        tree["decision_type"]
    lc, rc = tree["left_child"], tree["right_child"]
    lv, lcnt, icnt = tree["leaf_value"], tree["leaf_count"], \
        tree["internal_count"]

    def count(node):
        return float(lcnt[~node]) if node < 0 else float(icnt[node])

    def goes_left(node):
        v = x[sf[node]]
        d = int(dt[node])
        mt = (d >> 2) & 3
        if np.isnan(v) and mt != 2:
            v = 0.0
        if (mt == 2 and np.isnan(v)) or (mt == 1 and abs(v) <= 1e-35):
            return bool(d & 2)
        return v <= thr[node]

    def extend(path, zero, one, feat):
        path = [list(e) for e in path] + [[feat, zero, one,
                                           1.0 if not path else 0.0]]
        d = len(path) - 1
        for i in range(d - 1, -1, -1):
            path[i + 1][3] += one * path[i][3] * (i + 1) / (d + 1)
            path[i][3] = zero * path[i][3] * (d - i) / (d + 1)
        return path

    def unwind(path, idx):
        d = len(path) - 1
        one, zero = path[idx][2], path[idx][1]
        nxt = path[d][3]
        path = [list(e) for e in path]
        for i in range(d - 1, -1, -1):
            if one != 0:
                tmp = path[i][3]
                path[i][3] = nxt * (d + 1) / ((i + 1) * one)
                nxt = tmp - path[i][3] * zero * (d - i) / (d + 1)
            else:
                path[i][3] = path[i][3] * (d + 1) / (zero * (d - i))
        for i in range(idx, d):
            path[i][0:3] = path[i + 1][0:3]
        return path[:-1]

    def unwound_sum(path, idx):
        d = len(path) - 1
        one, zero = path[idx][2], path[idx][1]
        nxt, total = path[d][3], 0.0
        for i in range(d - 1, -1, -1):
            if one != 0:
                tmp = nxt * (d + 1) / ((i + 1) * one)
                total += tmp
                nxt = path[i][3] - tmp * zero * (d - i) / (d + 1)
            else:
                total += path[i][3] / (zero * (d - i) / (d + 1))
        return total

    def recurse(node, path, zero, one, feat):
        path = extend(path, zero, one, feat)
        if node < 0:
            for i in range(1, len(path)):
                w = unwound_sum(path, i)
                phi[path[i][0]] += w * (path[i][2] - path[i][1]) \
                    * lv[~node]
            return
        f = int(sf[node])
        hot, cold = (lc[node], rc[node]) if goes_left(node) \
            else (rc[node], lc[node])
        w = count(node)
        iz, io = 1.0, 1.0
        for k in range(1, len(path)):
            if path[k][0] == f:
                iz, io = path[k][1], path[k][2]
                path = unwind(path, k)
                break
        recurse(int(hot), path, count(int(hot)) / w * iz, io, f)
        recurse(int(cold), path, count(int(cold)) / w * iz, 0.0, f)

    if len(lv) == 1:
        phi[F] = lv[0]
        return phi
    if np.any(np.asarray(dt) & 1):
        raise ValueError("the oracle walks numerical splits only")
    recurse(0, [], 1.0, 1.0, -1)
    phi[F] = float(np.sum(np.asarray(lv) * np.asarray(lcnt))) / icnt[0]
    return phi


CONTRIB_ROWS = 1_000
ORACLE_ROWS = 50


def phase_predict_breadth(torch, lgb, dev, models):
    """``pred_contrib`` and ``pred_early_stop`` on the boosters of
    ``train`` (4 trees of 255 leaves) and ``train_multiclass`` (1
    iteration of 7 trees), loaded from their model texts; ``models``:
    ``{tag: (model text, held-out rows)}``. Contributions on
    ``CONTRIB_ROWS`` held-out rows sum per row to the raw prediction
    (1e-4 relative), and the first iteration's contributions of
    ``ORACLE_ROWS`` rows equal :func:`_shap_oracle` over the parsed text
    (1e-9); early stopping at a margin no row passes equals the full
    walk, and at the default margin (and 0.5), freq 1, the share of rows
    stopped early and the time against the full walk."""
    out = {}
    for tag, (text, Xv) in models.items():
        bst = lgb.Booster(model_str=text, params={"device_type": dev.type})
        K = bst.num_model_per_iteration()
        F = bst.num_feature()
        X = Xv[:CONTRIB_ROWS].astype(np.float64)
        t0 = time.perf_counter()
        contrib = bst.predict(X, pred_contrib=True)
        contrib_s = time.perf_counter() - t0
        raw = bst.predict(X, raw_score=True).reshape(len(X), K)
        sums = contrib.reshape(len(X), K, F + 1).sum(axis=2)
        rel = float(np.max(np.abs(sums - raw) / np.maximum(np.abs(raw),
                                                             1.0)))
        trees = _parse_model(text)
        one = bst.predict(X[:ORACLE_ROWS], pred_contrib=True,
                          num_iteration=1)
        want = np.zeros_like(one)
        for i in range(ORACLE_ROWS):
            for k in range(K):
                want[i, k * (F + 1):(k + 1) * (F + 1)] = _shap_oracle(
                    trees[k], X[i])
        oracle_err = float(np.max(np.abs(one - want)))
        full_t0 = time.perf_counter()
        full = bst.predict(X, raw_score=True)
        full_s = time.perf_counter() - full_t0
        never = bst.predict(X, raw_score=True, pred_early_stop=True,
                            pred_early_stop_margin=1e30)
        equal = bool(np.array_equal(never, full))
        stopped = {}
        for margin in (10.0, 0.5):
            t0 = time.perf_counter()
            es = bst.predict(X, raw_score=True, pred_early_stop=True,
                             pred_early_stop_freq=1,
                             pred_early_stop_margin=margin)
            es_s = time.perf_counter() - t0
            stopped[margin] = dict(
                share=float(np.mean(np.any(
                    np.reshape(es != full, (len(X), -1)), axis=1))),
                seconds=es_s)
        log(f"[predict_breadth] {tag}: K={K} pred_contrib on {len(X)} rows "
            f"{contrib_s:.2f} s, sum against raw max rel err {rel:.3g}; "
            f"{ORACLE_ROWS} rows of the first iteration against the "
            f"oracle max abs err {oracle_err:.3g}; early stop at margin "
            f"1e30 equal to the full walk: {equal}; freq 1: "
            + "; ".join(f"margin {m}: {v['share']:.4f} of rows stopped "
                        f"early, {v['seconds']:.4f} s" for m, v in
                        stopped.items())
            + f" (full walk {full_s:.4f} s)")
        if rel > 1e-4 or oracle_err > 1e-9 or not equal \
                or contrib.shape != (len(X), K * (F + 1)):
            raise AssertionError(f"predict_breadth {tag}: contributions or "
                                 "early-stopped scores are wrong")
        out[tag] = dict(contrib_s=contrib_s, sum_rel_err=rel,
                        oracle_err=oracle_err, early_stop=stopped,
                        full_s=full_s)
    return out


def phase_train_regression(torch, lgb, dev, tr, iters):
    """L1 regression with leaf renewal at the Higgs shape: the main
    path's X (10.5M x 28, ``make_higgs_like`` seed 0) with a continuous
    label, the generator's logits (the binary label's signal) plus
    Student-t noise of 2 degrees of freedom (``make_higgs_like(...,
    target=True)``); ``objective=regression_l1``, 255 leaves, 255 bins, 1
    warm-up + ``iters`` timed iterations, every tree's leaves renewed as
    the median of their residuals (a sort of all 10.5M rows per tree).
    Prints iter_s, renew_ms (CUDA events around each renewal) and the L1
    metric on the 500k held-out rows; against the plain twin, the same
    root split in every tree and L1 within 0.002 relative."""
    from lightgbm_tpu_torch.models import gbdt
    Xt, tt, tv, Xv = tr["Xt"], tr["target"], tr["target_valid"], tr["Xv"]
    params = {"objective": "regression_l1", "num_leaves": 255,
              "max_bin": BINS, "learning_rate": 0.1, "verbosity": -1,
              "device_type": dev.type}
    t0 = time.perf_counter()
    ds = lgb.Dataset(Xt, label=tt, reference=tr["ds"]).construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    tv_t = torch.as_tensor(tv, device=dev)

    def scorer(p):
        if p.shape != (len(tv),) or not np.all(np.isfinite(p)):
            raise AssertionError("train_regression: predictions are not "
                                 "finite [n] values")
        return dict(l1=float((torch.as_tensor(p, device=dev) - tv_t).abs()
                             .mean()))
    renew_ms = []
    renew = gbdt.renew_leaf_values

    def timed_renew(*args, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = renew(*args, **kw)
        b.record()
        b.synchronize()
        renew_ms.append(a.elapsed_time(b))
        return out
    gbdt.renew_leaf_values = timed_renew
    try:
        r = _drive(torch, lgb, dev, params, ds, Xv, tv, iters,
                   "train_regression", scorer)
    finally:
        gbdt.renew_leaf_values = renew
    _check_counts("train_regression", r["counts"], r["leaves"], "hist")
    bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, tv, 1 + iters,
                             "train_regression", scorer)
    roots_k = [_root_split_of(t) for t in r["bst"]._models]
    roots_p = [_root_split_of(t) for t in bst_p._models]
    log(f"[train_regression] construct_s={construct_s:.3f} renew_ms="
        f"{[round(x, 3) for x in renew_ms]} root splits kernel={roots_k} "
        f"plain={roots_p}; l1={r['l1']:.6f} plain={m_p['l1']:.6f}")
    if len(renew_ms) != 1 + iters:
        raise AssertionError("train_regression: not every tree was renewed")
    if roots_k != roots_p:
        raise AssertionError("train_regression: root splits differ from "
                             "the plain run's")
    if abs(r["l1"] - m_p["l1"]) > 0.002 * m_p["l1"]:
        raise AssertionError(f"train_regression: L1 {r['l1']} not within "
                             f"0.002 relative of the plain run's "
                             f"{m_p['l1']}")
    del r["bst"], bst_p, ds
    return dict(r, l1_plain=m_p["l1"], renew_ms=renew_ms,
                construct_s=construct_s)


SMALL_OBJECTIVES = ("huber", "fair", "poisson", "quantile", "mape", "gamma",
                    "tweedie", "cross_entropy", "cross_entropy_lambda")


def small_label(objective, signal, rs):
    """A label in each objective's domain from a signal."""
    n = signal.shape[0]
    if objective == "poisson":
        return rs.poisson(np.exp(signal / 3)).astype(np.float64)
    if objective == "gamma":
        return rs.gamma(2.0, np.exp(signal / 4))
    if objective == "tweedie":
        return np.where(rs.rand(n) < 0.3, 0.0,
                        rs.gamma(1.5, np.exp(signal / 4)))
    if objective.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-(signal + 0.5 * rs.randn(n))))
    if objective == "mape":
        return 5.0 + signal + rs.standard_t(3, n)
    return signal + rs.standard_t(2, n)


def phase_small_objectives(torch, lgb, dev):
    """Every other new objective on 200,000 x 28 rows (the Higgs-shaped
    X, seed 3; a label in each one's domain from its continuous target
    squashed into (-3, 3) by ``3 tanh(t / 3)``), 63 leaves,
    2 iterations (quantile at alpha 0.9): every tree equal to its plain
    twin's with float64 histogram sums, and save, load and predict equal
    to the in-memory prediction, output transform included; then a
    quantized L1 run (round to nearest, with renewal) held tree for tree,
    leaf values included, to its plain twin."""
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    X, _, target = make_higgs_like(200_000, FEATURES, seed=3, target=True)
    sig = 3.0 * np.tanh(target / 3.0)
    rs = np.random.RandomState(3)
    out = {}
    for obj in SMALL_OBJECTIVES + ("regression_l1",):
        y = small_label(obj, sig, rs)
        params = {"objective": obj, "num_leaves": 63, "max_bin": BINS,
                  "verbosity": -1, "device_type": dev.type}
        if obj == "quantile":
            params["alpha"] = 0.9
        if obj == "regression_l1":
            params.update(use_quantized_grad=True,
                          stochastic_rounding=False)
        ds = lgb.Dataset(X, label=y, params=params)
        _reset_counts()
        bst = lgb.train(params, ds, SMALL_TREES)
        counts = _read_counts()
        _check_counts(f"small_{obj}", counts,
                      [t.num_leaves for t in bst._models],
                      "hist_int" if obj == "regression_l1" else "hist")
        with plain_kernels(), exact_float_sums(torch):
            ref = lgb.train(params, ds, SMALL_TREES)
        exact = obj == "regression_l1"
        same = [int(_same_structure(a, b) and (
            np.array_equal(a.leaf_value, b.leaf_value) if exact
            else np.allclose(a.leaf_value, b.leaf_value, rtol=1e-4,
                             atol=1e-5)))
            for a, b in zip(bst._models, ref._models)]
        p = bst.predict(X[:50_000])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "model.txt")
            bst.save_model(path)
            p2 = lgb.Booster(model_file=path,
                             params={"device_type": dev.type}).predict(
                X[:50_000])
        rt = float(np.max(np.abs(p2 - p) / np.maximum(1.0, np.abs(p))))
        log(f"[small_objectives] {obj}: {SMALL_TREES} trees of "
            f"{[t.num_leaves for t in bst._models]} leaves, launches="
            f"{json.dumps(counts)}, trees identical to the plain run's"
            f"{' (leaf values bit-equal)' if exact else ''}: {same}; "
            f"predictions {float(p.min()):.4g}..{float(p.max()):.4g}, "
            f"save/load relative max diff {rt:.3g}")
        if len(same) != SMALL_TREES or not all(same):
            raise AssertionError(f"small {obj}: trees differ from the plain "
                                 "run's")
        if not np.all(np.isfinite(p)) or rt > 1e-6:
            raise AssertionError(f"small {obj}: save/load/predict differs "
                                 "from the in-memory prediction")
        out[obj] = dict(counts=counts, same_trees=same, roundtrip=rt)
        del bst, ref, ds
    return out


def _bundle_stats(torch, lgb, ds, params, tag):
    """Bundle the Dataset as training will (``Dataset.bundles``), timed,
    and print the plan: G bundle columns, B positions, the groups' sizes;
    the device's memory after it (the unbundled matrix then waits on the
    host)."""
    from lightgbm_tpu_torch.config import Config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = ds.bundles(Config.from_params(params))
    torch.cuda.synchronize()
    bundle_s = time.perf_counter() - t0
    if info is None:
        raise AssertionError(f"{tag}: the data did not bundle")
    sizes = sorted((len(g) for g in info.groups), reverse=True)
    multi = [n for n in sizes if n > 1]
    out = dict(bundle_s=bundle_s, features=len(ds.mappers),
               G=int(info.bins_bundled.shape[1]), B=int(info.num_positions),
               multi_groups=len(multi), largest_groups=sizes[:8],
               bundled_features=sum(multi),
               dtype=str(info.bins_bundled.dtype),
               device_bytes_after=torch.cuda.memory_allocated())
    log(f"[{tag}] bundling: seconds={bundle_s:.2f} features={out['features']}"
        f" -> G={out['G']} columns, B={out['B']} positions "
        f"({out['dtype']}); {len(multi)} multi-member bundles of "
        f"{sum(multi)} features, largest {sizes[:8]}; device bytes "
        f"allocated after bundling={out['device_bytes_after']}")
    return out


def _f32_drift(torch, ds, yt):
    """The root histogram of class 0 at iteration 0 (every hessian
    1/7): the plain version's float32 sums and K1's against the float64
    sums, by the largest error over the bins and by feature 0's hessian
    total."""
    from lightgbm_tpu_torch.ops.histogram import hist_plain, window_hist
    bins = ds.device_bins()
    n = bins.shape[0]
    p = np.float32(1.0 / COV_CLASSES)
    y = torch.as_tensor(yt == 0, dtype=torch.float32, device=bins.device)
    pay = torch.stack([p - y, torch.full_like(y, np.float32(
        COV_CLASSES / (COV_CLASSES - 1.0) * p * (1.0 - p)))], 1).contiguous()
    exact = hist_f64(torch, bins, pay, BINS)
    out = {}
    for name, h in (("plain_f32", hist_plain(bins, pay, BINS)),
                    ("kernel", window_hist(bins, pay, BINS, 0, n))):
        out[name] = dict(max_abs_err=float((h.double() - exact).abs().max()),
                         hess_total=float(h[0, :, 1].double().sum()))
    out["exact_hess_total"] = float(exact[0, :, 1].sum())
    log(f"[train_multiclass] root histogram at iteration 0 (every hessian "
        f"1/7, {n} rows), against float64 sums: " + "; ".join(
            f"{k} max_abs_err={v['max_abs_err']:.4g} feature-0 hessian "
            f"total={v['hess_total']:.4f}" for k, v in out.items()
            if isinstance(v, dict))
        + f"; exact total={out['exact_hess_total']:.4f}")
    return out


# -- the Python surface: files, the CLI, sklearn, custom objectives -------

REPO = os.path.dirname(os.path.abspath(__file__))
# runs `python -m lightgbm_tpu_torch <args>` (runpy, as -m does), then
# prints the launch counts of the kernels the run made and where its
# seconds went: from the spawn (CHIP_SMOKE_SPAWNED, the parent's clock) to
# this script's first line, the imports, the CUDA context, then the CLI's
# main, split into its data loading, parsing, training and the rest
_CLI_RUNNER = """
import os, time
t_run = time.time()
spawned = float(os.environ["CHIP_SMOKE_SPAWNED"])
import json, runpy, sys
import torch
t_torch = time.time()
import lightgbm_tpu_torch.cli as cli
t_import = time.time()
if torch.cuda.is_available():
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
t_cuda = time.time()
times = {"start_s": t_run - spawned, "import_torch_s": t_torch - t_run,
         "import_port_s": t_import - t_torch, "cuda_init_s": t_cuda - t_import}


def timed(name, key):
    fn = getattr(cli, name)

    def wrapper(*args, **kwargs):
        t = time.time()
        if name == "main":
            times["to_main_s"] = t - spawned
        try:
            return fn(*args, **kwargs)
        finally:
            times[key] = times.get(key, 0.0) + time.time() - t
    setattr(cli, name, wrapper)


parts = {"_load_dataset": "load_s", "_load_text_file": "parse_s",
         "train_fn": "train_s", "_model": "model_load_s"}
for name, key in [("main", "main_s"), *parts.items()]:
    timed(name, key)
sys.argv = ["lightgbm_tpu_torch"] + sys.argv[1:]
code = 0
try:
    runpy.run_module("lightgbm_tpu_torch", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code or 0
times["rest_of_main_s"] = times.get("main_s", 0.0) - sum(
    times.get(k, 0.0) for k in parts.values())
import chip_smoke
print("[cli_counts] " + json.dumps(chip_smoke._read_counts()), flush=True)
print("[cli_times] " + json.dumps(times), flush=True)
sys.exit(code)
"""
SURFACE_REFIT_ROWS = 500_000
SURFACE_CONVERT_ROWS = 1_000


def run_clis(jobs, timeout=600):
    """``python3 -m lightgbm_tpu_torch <args>`` for every ``{tag: (args,
    cwd)}`` of ``jobs``, all started together (the repo on their path):
    ``{tag: (seconds from the start to its exit, the launch counts of its
    kernels, its seconds by part: see _CLI_RUNNER)}``. A non-zero exit
    fails the phase."""
    return wait_clis(start_clis(jobs), timeout)


def start_clis(jobs):
    """:func:`run_clis`'s processes, started (their output to temporary
    files, so none waits on a full pipe); :func:`wait_clis` waits."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    procs = {}
    for tag, (args, cwd) in jobs.items():
        env["CHIP_SMOKE_SPAWNED"] = repr(time.time())
        so, se = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs[tag] = (subprocess.Popen(
            [sys.executable, "-c", _CLI_RUNNER, *args], cwd=cwd,
            env=dict(env), stdout=so, stderr=se), so, se)
    return t0, procs


def wait_clis(started, timeout=600):
    """The results of :func:`start_clis`'s processes, as
    :func:`run_clis` gives them; none is left running."""
    t0, procs = started
    out = {}
    try:
        for tag, (proc, fo, fe) in procs.items():
            proc.wait(timeout=timeout)
            secs = time.perf_counter() - t0
            fo.seek(0)
            fe.seek(0)
            so, se = fo.read(), fe.read()
            if proc.returncode != 0:
                raise AssertionError(
                    f"{tag}: the CLI exited {proc.returncode}:\n"
                    f"{so[-3000:]}\n{se[-3000:]}")
            found = {}
            for ln in so.splitlines():
                if ln.startswith(("[cli_counts] ", "[cli_times] ")):
                    key, val = ln.split(" ", 1)
                    found[key] = json.loads(val)
            out[tag] = (secs, found["[cli_counts]"], found["[cli_times]"])
    finally:
        stop_clis(started)
    return out


def stop_clis(started):
    """Ends :func:`start_clis`'s processes that still run."""
    for proc, fo, fe in started[1].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fo.close()
        fe.close()


def _cli_times(times):
    """One CLI run's seconds by part (run_clis), as JSON."""
    return json.dumps({k: round(v, 4) for k, v in times.items()})


def _csv_chunk(arr):
    import io
    buf = io.BytesIO()
    np.savetxt(buf, arr, delimiter=",", fmt="%.17g")
    return buf.getvalue()


def write_csv(path, y, X):
    """A label-first CSV of ``%.17g`` values (exact for float64),
    formatted in chunks by a pool of processes, written in order."""
    import multiprocessing
    arr = np.column_stack([np.asarray(y, np.float64),
                           np.asarray(X, np.float64)])
    chunks = np.array_split(arr, max(1, len(arr) // 100_000))
    workers = max(1, min(8, os.cpu_count() or 1))
    with multiprocessing.get_context("spawn").Pool(workers) as pool, \
            open(path, "wb") as f:
        for part in pool.imap(_csv_chunk, chunks):
            f.write(part)
    return os.path.getsize(path)


def _model_trees(lgb, dev, text):
    return lgb.Booster(model_str=text, params={"device_type": dev.type}
                       )._models


def _trees_equal(tag, got, want, rtol):
    """Every tree of ``got`` equal to the same tree of ``want`` node for
    node, leaf values to ``rtol``."""
    same = [int(_same_structure(a, b) and np.allclose(
        a.leaf_value, b.leaf_value, rtol=rtol, atol=0.0))
        for a, b in zip(got, want)]
    log(f"[{tag}] trees equal to the in-process model's: {same}")
    if len(same) != len(got) or len(got) > len(want) or not all(same):
        raise AssertionError(f"{tag}: trees differ from the in-process "
                             "model's")


def _numpy_binary_refit(text, X, y, decay, lr=0.1):
    """The refit of a binary (sigmoid 1) model text in numpy: leaf of
    every row by the numpy walk, binary log-loss gradients ``p - y`` and
    ``p (1 - p)`` in float32 at the refitted trees' running score, leaf
    sums by ``np.bincount``; ``new = decay * old + (1 - decay) * fit``."""
    trees = _parse_model(text)
    leaves = numpy_leaves(text, X)
    score = np.zeros(len(y))
    lab = (np.asarray(y) > 0).astype(np.float32)
    out = []
    for t, lv in zip(trees, leaves):
        p = np.float32(1) / (np.float32(1) + np.exp(-score.astype(
            np.float32)))
        g = (p - lab).astype(np.float64)
        h = (p * (np.float32(1) - p)).astype(np.float64)
        L = t["num_leaves"]
        fit = -np.bincount(lv, g, L) / np.bincount(lv, h, L) * lr
        new = decay * t["leaf_value"] + (1.0 - decay) * fit
        out.append(new)
        score += new[lv]
    return out


_CONVERT_MAIN = r"""
#include <cstdio>
#include <vector>
#include "model.cpp"
int main(int argc, char** argv) {
  int n = atoi(argv[1]), f = atoi(argv[2]);
  std::vector<double> x((size_t)n * f), out(n);
  FILE* in = fopen(argv[3], "rb");
  if (fread(x.data(), sizeof(double), x.size(), in) != x.size()) return 1;
  fclose(in);
  for (int i = 0; i < n; ++i)
    lightgbm_tpu_model::PredictRaw(x.data() + (size_t)i * f, &out[i]);
  FILE* o = fopen(argv[4], "wb");
  fwrite(out.data(), sizeof(double), n, o);
  fclose(o);
  return 0;
}
"""


def phase_surface_higgs(torch, lgb, dev, tr, iters):
    """The Python surface at the Higgs shape, on ``train``'s Dataset and
    model: ``save_binary`` of it and of a valid set; the CLI trains 2
    trees from the binary files (float, then quantized) — equal to the
    in-process trees; ``task=predict`` on a CSV of the held-out rows
    through the native parser (built: asserted) equal to
    ``Booster.predict``; ``task=refit`` on a CSV of 500,000 training rows
    equal to a numpy refit of the model text; ``task=convert_model``
    compiled by the host's g++ and run on 1,000 rows, equal to a float64
    numpy walk (1e-9) and to ``predict(raw_score=True)`` (its float32
    sums, 1e-6); ``LGBMClassifier`` (4 trees, eval_set, AUC, early
    stopping) equal to ``train``'s trees; a custom objective (numpy
    binary log-loss through ``fobj``, 1 + ``iters`` iterations) held to
    the built-in binary without boost_from_average by the root split of
    every tree and AUC within 0.002."""
    from lightgbm_tpu_torch.utils import native
    from lightgbm_tpu_torch.metrics import auc as auc_t
    ds, Xv, yv, Xt = tr["ds"], tr["Xv"], tr["yv"], tr["Xt"]
    yt = np.asarray(ds.get_label())
    base = {"objective": "binary", "num_leaves": 255, "max_bin": BINS,
            "learning_rate": 0.1, "verbosity": -1, "device_type": dev.type}
    cli_base = [f"{k}={v}" for k, v in base.items()]
    out = {}

    def auc_of(p):
        return float(auc_t(torch.as_tensor(p, device=dev),
                           torch.as_tensor(yv, device=dev)))

    with tempfile.TemporaryDirectory() as tmp:
        # 1. binary files
        t0 = time.perf_counter()
        tbin = os.path.join(tmp, "train.bin")
        ds.save_binary(tbin)
        save_s = time.perf_counter() - t0
        vds = ds.create_valid(Xv, label=yv).construct()
        vbin = os.path.join(tmp, "valid.bin")
        vds.save_binary(vbin)
        del vds
        t0 = time.perf_counter()
        back = lgb.Dataset(tbin, params=base).construct()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not torch.equal(back.device_bins(), ds.device_bins()):
            raise AssertionError("surface: the binary file's bins differ")
        del back
        out.update(binary_bytes=os.path.getsize(tbin), save_s=save_s,
                   load_s=load_s)
        log(f"[surface_higgs] save_binary {os.path.getsize(tbin)} bytes in "
            f"{save_s:.2f} s (valid {os.path.getsize(vbin)} bytes); load "
            f"to the device {load_s:.2f} s, bins equal")

        # 2. the CLI trains from the binary files, float and quantized
        # (two processes at once)
        m_float = os.path.join(tmp, "cli_float.txt")
        m_quant = os.path.join(tmp, "cli_quant.txt")
        qparams = {"use_quantized_grad": True, "num_grad_quant_bins": 4,
                   "stochastic_rounding": True,
                   "quant_train_renew_leaf": True, "seed": 0}
        runs = run_clis({
            "surface_cli": (["task=train", f"data={tbin}", f"valid={vbin}",
                             "num_trees=2", f"output_model={m_float}",
                             *cli_base], tmp),
            "surface_cli_quant": (
                ["task=train", f"data={tbin}", "num_trees=2",
                 f"output_model={m_quant}", *cli_base,
                 *[f"{k}={str(v).lower()}" for k, v in qparams.items()]],
                tmp)})
        (secs, counts, ctimes), (qsecs, qcounts, qtimes) = \
            runs["surface_cli"], runs["surface_cli_quant"]
        with open(m_float) as f:
            cli_text = f.read()
        cli_trees = _model_trees(lgb, dev, cli_text)
        _check_counts("surface_cli", counts,
                      [t.num_leaves for t in cli_trees], "hist")
        _trees_equal("surface_cli", cli_trees,
                     _model_trees(lgb, dev, tr["model_str"]), 1e-6)
        with open(m_quant) as f:
            q_trees = _model_trees(lgb, dev, f.read())
        _check_counts("surface_cli_quant", qcounts,
                      [t.num_leaves for t in q_trees], "hist_int")
        twin = lgb.train({**base, **qparams}, ds, 2)
        _trees_equal("surface_cli_quant", q_trees, twin._models, 1e-6)
        del twin
        out.update(cli_train_s=secs, cli_quant_s=qsecs, cli_counts=counts,
                   cli_quant_counts=qcounts, cli_times=ctimes,
                   cli_quant_times=qtimes)
        log(f"[surface_higgs] CLI trainings from the binary files, two "
            f"processes at once (2 trees each; process start, load and "
            f"build included): float with a {len(yv)}-row valid set "
            f"{secs:.2f} s, launches={json.dumps(counts)}; quantized "
            f"{qsecs:.2f} s, launches={json.dumps(qcounts)}")
        log(f"[surface_higgs] CLI seconds by part: float "
            f"{_cli_times(ctimes)}; quantized {_cli_times(qtimes)}")

        # 3-5. task=predict on the held-out rows as a CSV (the native
        # parser), task=refit on 500,000 training rows, task=convert_model:
        # three processes at once
        if native.library() is None:
            raise AssertionError("surface: the native text parser did not "
                                 "build")
        csv = os.path.join(tmp, "valid.csv")
        t0 = time.perf_counter()
        nbytes = write_csv(csv, yv, Xv)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = native.parse_dense_text(csv, False)
        parse_s = time.perf_counter() - t0
        if parsed is None or not np.array_equal(parsed[:, 1:],
                                                Xv.astype(np.float64)):
            raise AssertionError("surface: the native parse differs from "
                                 "the rows written")
        del parsed
        nr = min(SURFACE_REFIT_ROWS, len(yt))
        rcsv = os.path.join(tmp, "refit.csv")
        write_csv(rcsv, yt[:nr], Xt[:nr])
        res = os.path.join(tmp, "pred.txt")
        m_refit = os.path.join(tmp, "refit.txt")
        cpp = os.path.join(tmp, "model.cpp")
        dt = f"device_type={dev.type}"
        runs = run_clis({
            "surface_predict": (["task=predict", f"data={csv}",
                                 f"input_model={m_float}",
                                 f"output_result={res}", dt], tmp),
            "surface_refit": (["task=refit", f"data={rcsv}",
                               f"input_model={m_float}",
                               f"output_model={m_refit}", dt], tmp),
            "surface_convert": (["task=convert_model",
                                 f"input_model={m_float}",
                                 f"convert_model={cpp}", dt], tmp)})
        os.unlink(rcsv)
        psecs, rsecs = runs["surface_predict"][0], runs["surface_refit"][0]
        for tag, run in runs.items():
            out[f"{tag}_times"] = run[2]
            log(f"[surface_higgs] {tag} seconds by part: "
                f"{_cli_times(run[2])}")
        # the same CSV, ingested eagerly, by two_round and in chunks
        out["ingest_text"] = phase_ingest_text(torch, lgb, dev, csv, nbytes,
                                               len(yv))
        got = np.loadtxt(res)
        want = lgb.Booster(model_file=m_float,
                           params={"device_type": dev.type}).predict(Xv)
        perr = float(np.abs(got - want).max())
        out.update(csv_bytes=nbytes, csv_write_s=write_s, parse_s=parse_s,
                   parse_mb_s=nbytes / 1e6 / parse_s,
                   parse_rows_s=len(Xv) / parse_s, cli_predict_s=psecs,
                   predict_err=perr)
        log(f"[surface_higgs] CSV {nbytes} bytes written in {write_s:.2f} "
            f"s; native parse {parse_s:.3f} s = {nbytes / 1e6 / parse_s:.1f}"
            f" MB/s, {len(Xv) / parse_s:.0f} rows/s; CLI predict "
            f"{psecs:.2f} s, max abs err against Booster.predict {perr:.3g}")
        if perr > 1e-7:
            raise AssertionError("surface: CLI predictions differ")

        with open(m_refit) as f:
            refit_trees = _parse_model(f.read())
        want = _numpy_binary_refit(cli_text, Xt[:nr], yt[:nr], 0.9)
        rerr = max(float(np.max(np.abs(t["leaf_value"] - w)
                                / np.maximum(np.abs(w), 1e-12)))
                   for t, w in zip(refit_trees, want))
        out.update(cli_refit_s=rsecs, refit_rel_err=rerr)
        log(f"[surface_higgs] CLI refit on {nr} rows {rsecs:.2f} s, leaf "
            f"values against the numpy refit max rel err {rerr:.3g}")
        if len(refit_trees) != len(want) or rerr > 1e-5:
            raise AssertionError("surface: refit differs from numpy's")

        with open(os.path.join(tmp, "main.cpp"), "w") as f:
            f.write(_CONVERT_MAIN)
        exe = os.path.join(tmp, "convert_exe")
        t0 = time.perf_counter()
        subprocess.run(["g++", "-O2", "-std=c++17", "main.cpp", "-o", exe],
                       cwd=tmp, check=True, capture_output=True,
                       timeout=600)
        compile_s = time.perf_counter() - t0
        Xc = np.ascontiguousarray(Xv[:SURFACE_CONVERT_ROWS], np.float64)
        Xc.tofile(os.path.join(tmp, "x.bin"))
        subprocess.run([exe, str(len(Xc)), str(Xc.shape[1]), "x.bin",
                        "y.bin"], cwd=tmp, check=True, timeout=120)
        cpp_raw = np.fromfile(os.path.join(tmp, "y.bin"), np.float64)
        walk_err = float(np.abs(cpp_raw - numpy_predict_raw(
            cli_text, Xc)).max())
        pred_err = float(np.abs(cpp_raw - lgb.Booster(
            model_file=m_float, params={"device_type": dev.type}).predict(
                Xc, raw_score=True)).max())
        out.update(convert_compile_s=compile_s, convert_walk_err=walk_err,
                   convert_predict_err=pred_err)
        log(f"[surface_higgs] convert_model: g++ {compile_s:.2f} s; raw "
            f"scores of {len(Xc)} rows against the float64 numpy walk max "
            f"abs err {walk_err:.3g}, against predict(raw_score=True) "
            f"(float32 sums) {pred_err:.3g}")
        if walk_err > 1e-9 or pred_err > 1e-6:
            raise AssertionError("surface: the converted model differs")

    # 6. LGBMClassifier at full width
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    _reset_counts()
    t0 = time.perf_counter()
    clf = lgb.LGBMClassifier(n_estimators=4, num_leaves=255,
                             learning_rate=0.1, max_bin=BINS,
                             device_type=dev.type)
    clf.fit(Xt, yt, eval_set=[(Xv, yv)], eval_metric="auc",
            callbacks=[lgb.early_stopping(5, verbose=False), stamp])
    fit_s = time.perf_counter() - t0
    sk_counts = _read_counts()
    sk_trees = clf.booster_._models
    _check_counts("surface_sklearn", sk_counts,
                  [t.num_leaves for t in sk_trees], "hist")
    proba = clf.predict_proba(Xv)[:, 1]
    perr = float(np.abs(proba - clf.booster_.predict(Xv)).max())
    sk_iter = statistics.median(np.diff(stamps)) if len(stamps) > 1 \
        else float("nan")
    _trees_equal("surface_sklearn", sk_trees,
                 _model_trees(lgb, dev, tr["model_str"]), 1e-6)
    sk_auc = clf.evals_result_["valid_0"]["auc"][-1]
    out.update(sk_fit_s=fit_s, sk_iter_s=sk_iter, sk_counts=sk_counts,
               sk_auc=sk_auc)
    log(f"[surface_higgs] LGBMClassifier fit {fit_s:.2f} s (construct "
        f"included), sk_iter_s={sk_iter:.4f} (eval included) against "
        f"train's median_iter_s={statistics.median(tr['iter_s']):.4f}; "
        f"valid auc {sk_auc:.6f}; predict_proba against booster_.predict "
        f"max abs err {perr:.3g}; launches={json.dumps(sk_counts)}")
    if perr > 0 or sk_auc < 0.5:
        raise AssertionError("surface: LGBMClassifier is wrong")
    del clf

    # 7. a custom objective through fobj
    spent = {"fobj": 0.0}

    def fobj(score, data):
        t = time.perf_counter()
        y = data.get_label()
        p = 1.0 / (1.0 + np.exp(-score))
        g, h = p - y, p * (1.0 - p)
        spent["fobj"] += time.perf_counter() - t
        return g, h
    cparams = {**base, "objective": "none"}
    _reset_counts()
    bst = lgb.train(cparams, ds, 1, fobj=fobj)
    c_iter = []
    for _ in range(iters):
        t0 = time.perf_counter()
        bst.update(fobj=fobj)
        torch.cuda.synchronize()
        c_iter.append(time.perf_counter() - t0)
    c_counts = _read_counts()
    _check_counts("surface_custom", c_counts,
                  [t.num_leaves for t in bst._models], "hist")
    fobj_s = spent["fobj"] / (1 + iters)
    t0 = time.perf_counter()
    score = bst._engine.current_score(0)
    d2h_s = time.perf_counter() - t0
    g, h = fobj(score[0], ds)
    t0 = time.perf_counter()
    for a in (g, h):
        torch.as_tensor(np.asarray(a, np.float32), device=dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    c_auc = auc_of(bst.predict(Xv, num_iteration=bst.current_iteration()))
    builtin = lgb.train({**base, "boost_from_average": False}, ds,
                        1 + iters)
    b_auc = auc_of(builtin.predict(Xv))
    roots_c = [_root_split_of(t) for t in bst._models]
    roots_b = [_root_split_of(t) for t in builtin._models]
    out.update(custom_iter_s=statistics.median(c_iter), fobj_s=fobj_s,
               score_d2h_s=d2h_s, grad_h2d_s=h2d_s, custom_auc=c_auc,
               builtin_auc=b_auc, custom_counts=c_counts)
    log(f"[surface_higgs] custom objective: custom_iter_s="
        f"{[round(s, 4) for s in c_iter]} median "
        f"{statistics.median(c_iter):.4f}; per iteration fobj "
        f"{fobj_s:.4f} s, score to host {d2h_s:.4f} s, (g, h) to device "
        f"{h2d_s:.4f} s; root splits {roots_c} built-in {roots_b}; auc "
        f"{c_auc:.6f} built-in {b_auc:.6f}; launches={json.dumps(c_counts)}")
    if roots_c != roots_b or abs(c_auc - b_auc) > 0.002:
        raise AssertionError("surface: the custom objective's model is "
                             "not the built-in binary's")
    return out


# the accuracy floors of tests/test_examples.py
EXAMPLES = {"binary_classification": ("binary", 0.85),
            "regression": ("regression", 0.5),
            "multiclass_classification": ("multiclass", 0.8),
            "lambdarank": ("rank", 0.6)}


def _example_quality(name, preds, y, test_path):
    if name == "multiclass_classification":
        return float(np.mean(np.argmax(preds, axis=1) == y))
    if name == "binary_classification":
        return float(np.mean((preds > 0.5) == (y > 0.5)))
    if name == "regression":
        return float(1 - np.sum((y - preds) ** 2)
                     / np.sum((y - y.mean()) ** 2))
    q = np.loadtxt(test_path + ".query", dtype=int, ndmin=1)
    b = np.concatenate([[0], np.cumsum(q)])
    return float(np.mean([y[a:c][np.argmax(preds[a:c])] >= 2
                          for a, c in zip(b[:-1], b[1:])]))


def _examples_sklearn(lgb, dev, dirs, out):
    """``LGBMRegressor``, ``LGBMRanker`` (with ``group``) and
    ``LGBMClassifier`` (string labels, ``class_weight="balanced"``)
    on the examples' data in ``dirs``; their counts and scores go to
    ``out``."""
    def data(name, split):
        stem = EXAMPLES[name][0]
        raw = np.loadtxt(os.path.join(dirs[name], f"{stem}.{split}"),
                         delimiter=",")
        return raw[:, 1:], raw[:, 0]
    kw = dict(n_estimators=20, device_type=dev.type)
    _reset_counts()
    Xr, yr = data("regression", "train")
    Xe, ye = data("regression", "test")
    reg = lgb.LGBMRegressor(**kw).fit(Xr, yr)
    r2 = 1 - np.sum((ye - reg.predict(Xe)) ** 2) \
        / np.sum((ye - ye.mean()) ** 2)
    Xq, yq = data("lambdarank", "train")
    gq = np.loadtxt(os.path.join(dirs["lambdarank"], "rank.train.query"),
                    dtype=int)
    rank = lgb.LGBMRanker(**kw).fit(Xq, yq, group=gq)
    Xk, yk = data("lambdarank", "test")
    top = _example_quality("lambdarank", rank.predict(Xk), yk,
                           os.path.join(dirs["lambdarank"], "rank.test"))
    Xm, ym = data("multiclass_classification", "train")
    Xn, yn = data("multiclass_classification", "test")
    names = np.array(["c0", "c1", "c2", "c3", "c4"])
    clf = lgb.LGBMClassifier(class_weight="balanced", **kw).fit(
        Xm, names[ym.astype(int)])
    lab = clf.predict(Xn)
    acc = float(np.mean(lab == names[yn.astype(int)]))
    sk_counts = _read_counts()
    leaves = [t.num_leaves for m in (reg, rank, clf)
              for t in m.booster_._models]
    _check_counts("surface_examples sklearn", sk_counts, leaves, "hist")
    out["counts"]["sklearn"] = sk_counts
    out.update(sk_r2=float(r2), sk_rank_top=top, sk_acc=acc)
    log(f"[surface_examples] LGBMRegressor R2 {r2:.4f}; LGBMRanker "
        f"top-1 share {top:.4f}; LGBMClassifier (string labels, "
        f"balanced) accuracy {acc:.4f}, classes "
        f"{[str(c) for c in clf.classes_]}; "
        f"launches={json.dumps(sk_counts)}")
    if not (r2 > 0.5 and top > 0.6 and acc > 0.8
            and set(lab) <= set(names)):
        raise AssertionError("surface_examples: an sklearn wrapper is "
                             "wrong")


def examples_prepare():
    """``examples/generate_data.py``'s data for the four examples, each
    with its ``.conf`` files, in a temporary directory: ``{"tmp": dir,
    "dirs": {name: dir}}``."""
    import importlib.util
    import shutil
    spec = importlib.util.spec_from_file_location(
        "examples_generate_data",
        os.path.join(REPO, "examples", "generate_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    tmp = tempfile.mkdtemp(prefix="examples_")
    dirs = {}
    for name in EXAMPLES:
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for fn in os.listdir(os.path.join(REPO, "examples", name)):
            if fn.endswith(".conf"):
                shutil.copy(os.path.join(REPO, "examples", name, fn), d)
        gen.GENERATORS[name](d)
        dirs[name] = d
    return {"tmp": tmp, "dirs": dirs, "started": []}


def examples_clis(dev, ex):
    """The lane's job of surface_examples: the four trainings through
    ``python3 -m lightgbm_tpu_torch config=train.conf num_trees=25`` (as
    ``tests/test_examples.py`` trains them) at once, then the four
    predictions; their launch counts and seconds go to ``ex``."""
    dirs = ex["dirs"]
    dt = f"device_type={dev.type}"
    t0 = time.perf_counter()
    started = start_clis({
        n: (["config=train.conf", "num_trees=25", dt], dirs[n])
        for n in EXAMPLES})
    ex["started"].append(started)
    ex["counts"] = {n: c for n, (_, c, _t) in wait_clis(started).items()}
    ex["train_s"] = time.perf_counter() - t0
    pred_args = {}
    for n, (stem, _) in EXAMPLES.items():
        if os.path.exists(os.path.join(dirs[n], "predict.conf")):
            pred_args[n] = ["config=predict.conf", dt]
        else:
            pred_args[n] = ["task=predict", f"data={stem}.test",
                            "input_model=LightGBM_model.txt",
                            "output_result=LightGBM_predict_result.txt",
                            dt]
    t0 = time.perf_counter()
    started = start_clis({n: (a, dirs[n]) for n, a in pred_args.items()})
    ex["started"].append(started)
    wait_clis(started)
    ex["pred_s"] = time.perf_counter() - t0


def phase_surface_examples(torch, lgb, dev, ex, lane):
    """The sklearn wrappers on ``examples/generate_data.py``'s data
    (:func:`_examples_sklearn`) in this process; then, once ``lane`` has
    ended, the four examples' CLI trainings and predictions
    (:func:`examples_clis`, run on the lane): predictions held to a numpy
    walk of the model text and accuracy to ``tests/test_examples.py``'s
    floors."""
    import shutil
    out = {"counts": {}}
    dirs = ex["dirs"]
    try:
        _examples_sklearn(lgb, dev, dirs, out)
        wait_s = lane.join(timeout=2 * PIPE_WAIT_S + 900)
        counts = ex["counts"]
        for n, (stem, floor) in EXAMPLES.items():
            d = dirs[n]
            with open(os.path.join(d, "LightGBM_model.txt")) as f:
                text = f.read()
            trees = _parse_model(text)
            K = 5 if n == "multiclass_classification" else 1
            raw = np.loadtxt(os.path.join(d, f"{stem}.test"), delimiter=",")
            y, X = raw[:, 0], raw[:, 1:]
            preds = np.loadtxt(os.path.join(d, "LightGBM_predict_result.txt"))
            walk = numpy_predict_raw(text, X, K)
            if n == "binary_classification":
                walk = 1.0 / (1.0 + np.exp(-walk))
            elif K > 1:
                e = np.exp(walk - walk.max(axis=1, keepdims=True))
                walk = e / e.sum(axis=1, keepdims=True)
            err = float(np.abs(preds - walk).max())
            q = _example_quality(n, preds, y, os.path.join(d, f"{stem}.test"))
            _check_counts(f"surface_examples {n}", counts[n],
                          [t["num_leaves"] for t in trees], "hist")
            out["counts"][n] = counts[n]
            out[n] = dict(trees=len(trees), walk_err=err, quality=q)
            log(f"[surface_examples] {n}: {len(trees)} trees, predictions "
                f"against the numpy walk max abs err {err:.3g}, quality "
                f"{q:.4f} (floor {floor}), launches={json.dumps(counts[n])}")
            if err > 1e-5 or not q > floor:
                raise AssertionError(f"surface_examples {n}: predictions "
                                     "or quality wrong")
        log(f"[surface_examples] the four CLI trainings at once "
            f"{ex['train_s']:.2f} s, the four predictions "
            f"{ex['pred_s']:.2f} s, on the lane after the pipeline's runs "
            f"(lane: {json.dumps({k: round(v, 1) for k, v in lane.seconds.items()})} s; "
            f"this process waited {wait_s:.1f} s for it)")
    finally:
        shutil.rmtree(ex["tmp"], ignore_errors=True)
    return out


# ---------------------------------------------------------------------
# dist: a world of two ranks on the card (parallel/, launch N)
# ---------------------------------------------------------------------

# world A: the Higgs rows split over two ranks; the smaller worlds and
# the fault runs
DIST_SMALL_ROWS = 1_000_000
DIST_FAULT_ROWS = 100_000
DIST_FAULT_ROUNDS = 6
DIST_DEADLINE = 20
DIST_RESTART_DEADLINE = 10
DIST_LEAVES = 255
DIST_SMALL_QUANT_LEAVES = 63
# the JAX package's int8 exchange on the 1M-row worlds' rows, a mesh of
# two CPU devices (tests/torch_int8_wire_reference.py; its f32 0.842768)
DIST_INT8_JAX_AUC = 0.797624


def _dist_params(device_type, **extra):
    return {"objective": "binary", "num_leaves": DIST_LEAVES,
            "max_bin": BINS, "learning_rate": 0.1, "verbosity": -1,
            "device_type": device_type, **extra}


def _dist_quant(device_type, **extra):
    # no leaf renewal: its float64 sums are atomics, in no fixed order
    return _dist_params(device_type, **{
        "use_quantized_grad": True, "num_grad_quant_bins": 4,
        "stochastic_rounding": True, "seed": 0, "tree_learner": "data",
        **extra})


def _model_trees_text(text):
    return text.split("\nparameters:")[0]


def _dist_run(torch, lgb, rank, tag, params, ds, rounds, Xv, yv, out,
              timed_comm=False):
    """One training of a world's rank: 1 warm-up + ``rounds - 1`` timed
    iterations, the kernels' counts, the model's sha256, the allocator
    peak; rank 0 also scores the held-out rows. ``timed_comm``: one more
    iteration with the collectives timed (wall clock between device
    synchronizes) and recorded, after the model is kept."""
    import hashlib
    dev = ds.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, num_boost_round=1)
    sync()
    warm_s = time.perf_counter() - t0
    iter_s = []
    for _ in range(rounds - 1):
        t0 = time.perf_counter()
        bst.update()
        sync()
        iter_s.append(time.perf_counter() - t0)
    counts = _read_counts()
    text = bst.model_to_string()
    leaves = [t.num_leaves for t in bst._models]
    res = dict(tag=tag, counts=counts, leaves=leaves, warmup_s=warm_s,
               iter_s=iter_s, root=list(_root_split(bst)),
               sha=hashlib.sha256(text.encode()).hexdigest(),
               tree_sha=hashlib.sha256(
                   _model_trees_text(text).encode()).hexdigest(),
               peak=(torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else None))
    eng = bst._engine
    if eng.comm is not None:
        res["mode"] = eng.parallel_mode
        res["hist_comm"] = eng.hist_comm
        res["split_search"] = eng.split_search
    if rank == 0:
        p = bst.predict(Xv, num_iteration=bst.current_iteration())
        from lightgbm_tpu_torch.metrics import auc
        res["auc"] = float(auc(torch.as_tensor(p), torch.as_tensor(yv)))
        with open(os.path.join(out, f"{tag}.txt"), "w") as f:
            f.write(text)
    if timed_comm and eng.comm is not None:
        comm = eng.comm
        comm.reset()
        comm.timing = comm.keep_records = True
        t0 = time.perf_counter()
        bst.update()
        sync()
        it_s = time.perf_counter() - t0
        splits = bst._models[-1].num_leaves - 1
        hist = [r for r in comm.records if r["elems"] > 64]
        res["comm"] = dict(
            splits=splits, iter_s=it_s, seconds=dict(comm.seconds),
            calls=dict(comm.calls), bytes=dict(comm.bytes),
            hist_bytes=sum(r["bytes"] for r in hist),
            hist_calls=len(hist), staged=sorted(
                op for op in comm.calls if comm._staged(
                    op, torch.empty(1, device=dev))))
        comm.timing = comm.keep_records = False
    del bst
    return res


def _quantize_ms(torch, dev, F, B, reps=200):
    """CUDA-event ms of one block quantization of an ``[F, B, 2]`` f32
    histogram (comms._quantize, plain torch), and its bytes."""
    from lightgbm_tpu_torch.parallel import comms
    x = torch.randn(F * B * 2 + (-F * B * 2) % comms.BLOCK, device=dev)
    blocks = x.reshape(-1, comms.BLOCK)
    for _ in range(5):
        comms._quantize(blocks, 127, torch.int8)
    if dev.type != "cuda":
        return None
    return events_ms(lambda: comms._quantize(blocks, 127, torch.int8),
                     reps, torch)


def dist_worker(spec_path):
    """A rank of the dist phase's world (``--dist-worker SPEC``, started
    by ``python -m lightgbm_tpu_torch launch 2``): world A at the Higgs
    rows, then the smaller worlds; writes ``rank<r>.json``."""
    with open(spec_path) as f:
        spec = json.load(f)
    t_start = time.perf_counter()
    import torch
    t_torch = time.perf_counter() - t_start
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    from lightgbm_tpu_torch.parallel import distributed, spmd
    dt = spec["device_type"]
    distributed.init_distributed(device_type=dt)
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel.mesh import world_rank, world_size
    rank, D = world_rank(), world_size()
    dev = distributed.rank_device()
    out = spec["out"]
    global DIST_LEAVES
    DIST_LEAVES = spec["leaves"]
    res = dict(rank=rank, world=D, device=str(dev),
               backend=torch.distributed.get_backend(),
               init_s=distributed.init_seconds(), import_torch_s=t_torch,
               cuda_devices=torch.cuda.device_count())
    X = np.load(spec["X"], mmap_mode="r")
    y = np.load(spec["y"])
    Xv, yv = np.load(spec["Xv"]), np.load(spec["yv"])
    n = spec["rows"]
    per = n // D
    t0 = time.perf_counter()
    ds = spmd.distributed_dataset(
        np.ascontiguousarray(X[rank * per:(rank + 1) * per]),
        label=y[rank * per:(rank + 1) * per],
        params={"max_bin": BINS, "device_type": dt})
    res["construct_s"] = time.perf_counter() - t0
    runs = {}
    it = spec["iters"]
    runs["A_quant"] = _dist_run(torch, lgb, rank, "A_quant",
                                _dist_quant(dt), ds, 1 + it, Xv, yv, out)
    runs["A_float"] = _dist_run(torch, lgb, rank, "A_float",
                                _dist_params(dt, tree_learner="data"), ds,
                                1 + it, Xv, yv, out, timed_comm=True)
    del ds
    if not spec.get("world_a_only"):
        m = spec["small_rows"]
        ps = m // D
        dss = spmd.distributed_dataset(
            np.ascontiguousarray(X[rank * ps:(rank + 1) * ps]),
            label=y[rank * ps:(rank + 1) * ps],
            params={"max_bin": BINS, "device_type": dt})
        rep = lgb.Dataset(np.ascontiguousarray(X[:m]), label=y[:m],
                          params={"max_bin": BINS, "device_type": dt})
        rep.construct()
        # the quantized worlds compare exact trees among themselves, at
        # DIST_SMALL_QUANT_LEAVES (the smoke's time); the float ones stay
        # at DIST_LEAVES, where the int8 wire has its JAX reading
        ql = DIST_SMALL_QUANT_LEAVES
        small = [
            ("data_q", _dist_quant(dt, num_leaves=ql), dss),
            ("voting28_q", _dist_quant(dt, tree_learner="voting",
                                       top_k=FEATURES, num_leaves=ql), dss),
            ("voting_q", _dist_quant(dt, tree_learner="voting",
                                     num_leaves=ql), dss),
            ("feature_q", _dist_quant(dt, tree_learner="feature",
                                      num_leaves=ql), rep),
            ("serial_q", _dist_quant(dt, tree_learner="serial",
                                     num_leaves=ql), rep),
            ("data_f", _dist_params(dt, tree_learner="data"), dss),
            ("int16_f", _dist_params(dt, tree_learner="data",
                                     hist_comm="int16"), dss),
            ("int8_f", _dist_params(dt, tree_learner="data",
                                    hist_comm="int8"), dss),
            ("sharded_f", _dist_params(dt, tree_learner="data",
                                       split_search="sharded"), dss)]
        for tag, params, d in small:
            runs[tag] = _dist_run(torch, lgb, rank, tag, params, d, 2, Xv,
                                  yv, out,
                                  timed_comm=tag in ("int16_f", "int8_f"))
    res["runs"] = runs
    res["quantize_ms"] = _quantize_ms(torch, dev, FEATURES, BINS)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.shutdown_distributed()
    return 0


def dist_chaos(outdir):
    """A rank of the dist phase's fault runs (``--dist-chaos OUTDIR``):
    every setting from the environment (the launch supervisor's world,
    LIGHTGBM_TPU_CHECKPOINT, _FAULT_INJECT, _COLLECTIVE_TIMEOUT);
    ``DIST_FAULT_ROWS`` Higgs-shaped rows split over the world, 63
    leaves, bagging; rank 0 saves the model. A watchdog abort prints
    ``WORKER ABORT`` and exits 13 at once."""
    from lightgbm_tpu_torch.parallel import distributed, spmd
    dt = os.environ.get("LIGHTGBM_TPU_SMOKE_DEVICE", "cuda")
    distributed.init_distributed(device_type=dt)
    from lightgbm_tpu_torch.obs.registry import registry
    print(f"INIT_RETRIES={int(registry.counter('init_retries').value)}",
          flush=True)
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.basic import LightGBMError
    from lightgbm_tpu_torch.parallel.mesh import world_rank, world_size
    rank, D = world_rank(), world_size()
    X, y = make_higgs_like(DIST_FAULT_ROWS, FEATURES, seed=3)
    per = DIST_FAULT_ROWS // D
    try:
        ds = spmd.distributed_dataset(
            X[rank * per:(rank + 1) * per], label=y[rank * per:(rank + 1) * per],
            params={"max_bin": BINS, "device_type": dt})
        bst = lgb.train({"objective": "binary", "num_leaves": 63,
                         "max_bin": BINS, "verbosity": -1,
                         "tree_learner": "data", "bagging_fraction": 0.7,
                         "bagging_freq": 2, "device_type": dt}, ds,
                        num_boost_round=DIST_FAULT_ROUNDS)
    except LightGBMError as e:
        print(f"WORKER ABORT: {e}", flush=True)
        os._exit(13)
    if rank == 0:
        bst.save_model(os.path.join(outdir, "model_elastic.txt"))
    print(f"rank {rank} DONE iterations={bst.current_iteration()}",
          flush=True)
    sys.stdout.flush()
    os._exit(0)


def _launch_cmd(nprocs, logdir, worker, *flags):
    return [sys.executable, "-m", "lightgbm_tpu_torch", "launch",
            str(nprocs), "--log-dir", logdir, *flags, "--",
            sys.executable, os.path.abspath(__file__), *worker]


def _smoke_env(extra=None):
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIGHTGBM_TPU_")}
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(extra or {})
    return env


def _stop_launch(proc):
    """Stop a ``launch`` supervisor and its world: SIGINT (the supervisor
    kills its ranks' process groups on the interrupt), then SIGKILL."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _communicate(proc, timeout):
    """``proc.communicate`` that stops the supervisor's world when the
    timeout passes, then raises."""
    try:
        return proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        _stop_launch(proc)
        raise


def _dist_faults_kill(runs):
    """Stop every fault run (a failure elsewhere in the phase)."""
    import signal
    for p in runs.get("stall", []):
        if p.poll() is None:
            os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            p.wait(timeout=30)
    for tag in ("clean", "faulted"):
        if tag in runs:
            _stop_launch(runs[tag][1])


def _tail(path, n=2000):
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return "(no log)"


def _dist_faults_start(work, device_type):
    """Start the fault runs, all at once: stall_rank@2 on rank 1 of two
    ranks started by hand (a DIST_DEADLINE s watchdog), a clean ``launch
    2`` and ``launch 2`` under ``init_refuse@1,rank_kill@3`` (a
    DIST_RESTART_DEADLINE s watchdog, so the survivor aborts sooner).
    Every rank is on card 0, as on the one-card machine: with a card a
    rank, NCCL's host sync (a collective) could not name the silent
    rank."""
    from lightgbm_tpu_torch.resilience.elastic import _free_port
    base = {"LIGHTGBM_TPU_INIT_BACKOFF": "0.05",
            "LIGHTGBM_TPU_SMOKE_DEVICE": device_type}
    if device_type == "cuda":
        base["CUDA_VISIBLE_DEVICES"] = "0"
    import threading
    runs = {"t0": time.perf_counter(), "ends": {}}

    def watch(tag, proc):
        # the time each run ends: the phase waits for them only after
        # world A and its twins
        def wait():
            proc.wait()
            runs["ends"][tag] = time.perf_counter()
        threading.Thread(target=wait, daemon=True).start()

    sdir = os.path.join(work, "stall")
    os.makedirs(sdir)
    port = _free_port()
    runs["stall"] = []
    for r in (0, 1):
        env = _smoke_env(dict(base, LIGHTGBM_TPU_COORDINATOR=
                              f"127.0.0.1:{port}",
                              LIGHTGBM_TPU_NUM_PROCS="2",
                              LIGHTGBM_TPU_RANK=str(r),
                              LIGHTGBM_TPU_COLLECTIVE_TIMEOUT=
                              str(DIST_DEADLINE),
                              LIGHTGBM_TPU_FAULT_INJECT="stall_rank@2",
                              LIGHTGBM_TPU_FAULT_RANK="1"))
        log_f = open(os.path.join(sdir, f"rank{r}.log"), "wb")
        runs["stall"].append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-chaos",
             sdir], env=env, stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True))
        log_f.close()
    watch("stall", runs["stall"][0])
    for tag, fault, flags in (
            ("clean", "", ("--max-restarts", "0")),
            ("faulted", "init_refuse@1,rank_kill@3",
             ("--max-restarts", "2", "--grace",
              str(DIST_RESTART_DEADLINE + 5)))):
        d = os.path.join(work, tag)
        os.makedirs(d)
        # the supervisor's output to a file: nothing reads a pipe while
        # world A runs
        log_f = open(os.path.join(work, f"{tag}.out"), "wb")
        runs[tag] = (d, subprocess.Popen(
            _launch_cmd(2, d, ["--dist-chaos", d], *flags),
            env=_smoke_env(dict(
                base, LIGHTGBM_TPU_CHECKPOINT=os.path.join(d, "ckpts"),
                LIGHTGBM_TPU_COLLECTIVE_TIMEOUT=str(DIST_RESTART_DEADLINE),
                LIGHTGBM_TPU_FAULT_INJECT=fault,
                LIGHTGBM_TPU_FAULT_RANK="1")),
            stdout=log_f, stderr=subprocess.STDOUT))
        log_f.close()
        watch(tag, runs[tag][1])
    return runs


def _dist_faults_finish(runs):
    """Wait for the fault runs and hold them: the survivor of the stall
    exits 13 in time naming spmd/verify_step and rank 1, the stalled
    rank is alive until killed and nothing is left running; the
    restarted world retried its init once, resumed to its last
    iteration and saved a model byte-equal to the clean run's."""
    import signal
    out = {}
    stall = runs["stall"]
    left_s = DIST_DEADLINE + 120 - (time.perf_counter() - runs["t0"])
    try:
        rc0 = stall[0].wait(timeout=max(1.0, left_s))
    except subprocess.TimeoutExpired:
        rc0 = None
    stall_s = runs["ends"].get("stall", time.perf_counter()) - runs["t0"]
    alive1 = stall[1].poll() is None
    for p in stall:
        if p.poll() is None:
            os.killpg(os.getpgid(p.pid), signal.SIGKILL)
        p.wait(timeout=30)
    sdir = os.path.dirname(runs["clean"][0]) + "/stall"
    text0 = _tail(os.path.join(sdir, "rank0.log"), 4000)
    out["stall"] = dict(rc=rc0, seconds=stall_s, stalled_alive=alive1,
                        left_running=[p.pid for p in stall
                                      if p.poll() is None])
    log(f"[dist] stall_rank@2: survivor rc={rc0} after {stall_s:.1f} s "
        f"(deadline {DIST_DEADLINE} s; start-up included, beside the "
        f"launch runs and world A); the stalled rank was alive until "
        f"killed: {alive1}")
    if rc0 != 13 or "WORKER ABORT" not in text0 \
            or "spmd/verify_step" not in text0 or "rank 1" not in text0:
        raise AssertionError(f"dist: the survivor of stall_rank@2 did not "
                             f"abort naming the collective:\n{text0}")
    if stall_s > DIST_DEADLINE + 90 or out["stall"]["left_running"]:
        raise AssertionError(f"dist: stall_rank@2 took {stall_s:.1f} s or "
                             "left a process running")
    done = {}
    for tag in ("clean", "faulted"):
        d, proc = runs[tag]
        try:
            proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            _stop_launch(proc)
            raise
        text = _tail(os.path.join(os.path.dirname(d), f"{tag}.out"), 20000)
        done[tag] = (d, proc.returncode, text,
                     runs["ends"].get(tag, time.perf_counter()) - runs["t0"])
    (cd, crc, ctext, cs), (fd, frc, ftext, fs) = done["clean"], \
        done["faulted"]
    if crc != 0:
        raise AssertionError(f"dist: the clean launch failed:\n{ctext}")
    g0 = _tail(os.path.join(fd, "elastic_g0_rank0.log"), 4000)
    g1 = _tail(os.path.join(fd, "elastic_g1_rank0.log"), 4000)
    with open(os.path.join(cd, "model_elastic.txt"), "rb") as f:
        m_clean = f.read()
    m_fault = b""
    if os.path.exists(os.path.join(fd, "model_elastic.txt")):
        with open(os.path.join(fd, "model_elastic.txt"), "rb") as f:
            m_fault = f.read()
    out["launch"] = dict(rc=frc, init_retries="INIT_RETRIES=1" in g0,
                         resumed=f"DONE iterations={DIST_FAULT_ROUNDS}" in g1,
                         byte_equal=m_fault == m_clean, seconds=fs,
                         clean_seconds=cs)
    log(f"[dist] launch 2 under init_refuse@1,rank_kill@3: rc={frc}, done "
        f"{fs:.1f} s after the fault runs started (the clean run {cs:.1f} "
        f"s); init retried once: {out['launch']['init_retries']}; resumed "
        f"to {DIST_FAULT_ROUNDS} iterations: {out['launch']['resumed']}; "
        f"model byte-equal to the clean run's: "
        f"{out['launch']['byte_equal']}")
    if not all(out["launch"][k] for k in ("init_retries", "resumed",
                                          "byte_equal")) or frc != 0:
        raise AssertionError(f"dist: the supervised restart failed:\n"
                             f"{ftext}\n{g0}\n{g1}")
    return out


def _dist_world(work, tag, spec, env_extra, nprocs=2):
    """Run the dist worker as a world of ``nprocs`` ranks under
    ``launch``; returns the ranks' results."""
    out = os.path.join(work, tag)
    os.makedirs(out)
    spec = dict(spec, out=out)
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        _launch_cmd(nprocs, out, ["--dist-worker", spec_path],
                    "--max-restarts", "0"), env=_smoke_env(env_extra),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    text = _communicate(proc, 600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(
            f"dist {tag}: launch {nprocs} exited {proc.returncode}:\n"
            f"{text}\n"
            + _tail(os.path.join(out, "elastic_g0_rank0.log"), 6000) + "\n"
            + _tail(os.path.join(out, "elastic_g0_rank1.log"), 6000))
    ranks = []
    for r in range(nprocs):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, wall, out


def _dist_check_world(tag, ranks, twins, out):
    """Both ranks' models equal; world A against its one-rank twins;
    the kernels' counts of each rank."""
    r0 = ranks[0]
    for name, run in r0["runs"].items():
        if any(run["sha"] != rk["runs"][name]["sha"] for rk in ranks[1:]):
            raise AssertionError(f"dist {tag} {name}: the ranks' models "
                                 "differ")
    for name, key in (("A_quant", "hist_int"), ("A_float", "hist")):
        for rk in ranks:
            run = rk["runs"][name]
            _check_counts(f"dist {tag} {name} rank {rk['rank']}",
                          run["counts"], run["leaves"], key)
    with open(os.path.join(out, "A_quant.txt")) as f:
        aq = f.read()
    if _model_trees_text(aq) != _model_trees_text(twins["quant_text"]):
        raise AssertionError(f"dist {tag}: world A's quantized trees differ "
                             "from its one-rank twin's")
    af = r0["runs"]["A_float"]
    if tuple(af["root"]) != twins["float_root"] \
            or abs(af["auc"] - twins["float_auc"]) > 0.002:
        raise AssertionError(
            f"dist {tag}: world A float root {af['root']} auc {af['auc']} "
            f"against the twin's {twins['float_root']} "
            f"{twins['float_auc']}")


def phase_dist(torch, lgb, dev, tr, iters):
    """Distributed training on the card: world A (two ranks on the one
    card, gloo on CUDA tensors, each with half of train's 10.5M rows,
    binary, 255 leaves and bins, 1 + ``iters`` iterations quantized
    then float) against an in-process one-rank twin on the same rows
    with rank 0's mappers; the smaller worlds at DIST_SMALL_ROWS rows;
    the fault runs at DIST_FAULT_ROWS rows; with two cards or more,
    world A again on NCCL, a rank per card."""
    t_phase = time.perf_counter()
    dt = dev.type
    work = tempfile.mkdtemp(prefix="dist_")
    Xt, yt = tr["Xt"], np.asarray(tr["ds"].get_label(), np.float32)
    Xv, yv = tr["Xv"], tr["yv"]
    n = len(yt)
    t0 = time.perf_counter()
    paths = {}
    for key, arr in (("X", Xt), ("y", yt), ("Xv", Xv), ("yv", yv)):
        paths[key] = os.path.join(work, f"{key}.npy")
        np.save(paths[key], arr)
    log(f"[dist] wrote the rows for the ranks in "
        f"{time.perf_counter() - t0:.2f} s")
    spec = dict(paths, rows=n, iters=iters, small_rows=DIST_SMALL_ROWS,
                device_type=dt, leaves=DIST_LEAVES)
    # the fault runs start first and run beside world A and the twins
    fault_runs = _dist_faults_start(work, dt)
    faults = None
    try:
        # world A and the smaller worlds: two ranks on card 0
        ranks, wall, out = _dist_world(work, "gloo", spec,
                                       {"CUDA_VISIBLE_DEVICES": "0"}
                                       if dt == "cuda" else {})
        twins, twin_construct = _dist_twins(torch, lgb, dt, Xt, yt, Xv, yv,
                                            iters, work)
        _dist_checks(ranks, twins, out, twin_construct, wall)
        faults = _dist_faults_finish(fault_runs)
    finally:
        if faults is None:
            _dist_faults_kill(fault_runs)
    r0, r1 = ranks
    nccl = None
    if dt == "cuda" and torch.cuda.device_count() >= 2:
        ranks2, wall2, out2 = _dist_world(
            work, "nccl", dict(spec, world_a_only=True), {})
        _dist_check_world("nccl", ranks2, twins, out2)
        nccl = ranks2
        for name in ("A_quant", "A_float"):
            a = ranks2[0]["runs"][name]
            log(f"[dist] nccl {name}: backend={ranks2[0]['backend']} "
                f"iter_s={[round(s, 4) for s in a['iter_s']]} "
                f"auc={a['auc']:.6f}")
    else:
        log(f"[dist] world A on NCCL not run: {torch.cuda.device_count()} "
            "card(s) visible")
    counts = {}
    for rk in ranks + (nccl or []):
        for run in rk["runs"].values():
            for k, v in run["counts"].items():
                counts[k] = counts.get(k, 0) + v
    log(f"[dist] launches over every world's ranks {json.dumps(counts)}; "
        f"world A launch wall {wall:.1f} s; phase_s="
        f"{time.perf_counter() - t_phase:.1f}")
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    return dict(counts=counts, ranks=ranks, twins={
        k: v for k, v in twins.items() if not k.endswith("_text")},
        faults=faults)


def _dist_twins(torch, lgb, dt, Xt, yt, Xv, yv, iters, work, D=2):
    """World A's one-rank twins: the same rows, the mappers of rank 0's
    rows in a world of ``D``."""
    n = len(yt)
    t0 = time.perf_counter()
    ref = lgb.Dataset(Xt[:n // D], label=yt[:n // D],
                      params={"max_bin": BINS, "device_type": dt})
    ref.construct()
    ds = lgb.Dataset(Xt, label=yt, reference=ref,
                     params={"max_bin": BINS, "device_type": dt})
    ds.construct()
    twin_construct = time.perf_counter() - t0
    twins = {}
    for kind, params in (("quant", _dist_quant(dt, tree_learner="serial")),
                         ("float", _dist_params(dt))):
        r = _dist_run(torch, lgb, 0, f"twin_{kind}", params, ds, 1 + iters,
                      Xv, yv, work)
        twins[f"{kind}_iter_s"] = r["iter_s"]
        twins[f"{kind}_auc"] = r["auc"]
        twins[f"{kind}_root"] = tuple(r["root"])
        with open(os.path.join(work, f"twin_{kind}.txt")) as f:
            twins[f"{kind}_text"] = f.read()
    del ds, ref
    return twins, twin_construct


def _dist_checks(ranks, twins, out, twin_construct, wall):
    """World A against its twins, the smaller worlds against each other,
    and the phase's report lines."""
    _dist_check_world("gloo", ranks, twins, out)
    r0, r1 = ranks
    runs = r0["runs"]
    if _model_trees_text(open(os.path.join(out, "feature_q.txt")).read()) \
            != _model_trees_text(open(os.path.join(out,
                                                   "serial_q.txt")).read()):
        raise AssertionError("dist: feature-parallel trees differ from "
                             "serial ones")
    if runs["voting28_q"]["tree_sha"] != runs["data_q"]["tree_sha"]:
        raise AssertionError("dist: voting with top_k >= 28 differs from "
                             "data-parallel")
    for tag in ("int16_f", "sharded_f"):
        if abs(runs[tag]["auc"] - runs["data_f"]["auc"]) > 0.002:
            raise AssertionError(f"dist: {tag} AUC {runs[tag]['auc']} not "
                                 f"within 0.002 of f32's "
                                 f"{runs['data_f']['auc']}")
    # int8's block-quantized wire falls ~0.045 below f32 in the JAX
    # package too (ROADMAP.md Queue 3, the int8 histogram wire): it is
    # held to the JAX package's own int8 exchange on these rows
    if abs(runs["int8_f"]["auc"] - DIST_INT8_JAX_AUC) > 0.002:
        raise AssertionError(f"dist: int8_f AUC {runs['int8_f']['auc']} "
                             f"not within 0.002 of the JAX package's int8 "
                             f"exchange, {DIST_INT8_JAX_AUC}")
    log(f"[dist] AUC less f32's: int16 "
        f"{runs['int16_f']['auc'] - runs['data_f']['auc']:+.6f} int8 "
        f"{runs['int8_f']['auc'] - runs['data_f']['auc']:+.6f} sharded "
        f"{runs['sharded_f']['auc'] - runs['data_f']['auc']:+.6f}")
    from lightgbm_tpu_torch.parallel import comms
    staged = sorted({op for tag in ("A_float", "int16_f", "int8_f")
                     for op in runs[tag]["comm"]["staged"]})
    log(f"[dist] world A: backend={r0['backend']} (ranks on {r0['device']} "
        f"and {r1['device']}, {r0['cuda_devices']} visible card(s); staged "
        f"through pinned host memory: {', '.join(staged) or 'none'}) "
        f"init_process_group_s={r0['init_s']:.3f}/"
        f"{r1['init_s']:.3f} import_torch_s={r0['import_torch_s']:.2f} "
        f"construct_s={r0['construct_s']:.2f} launch_wall_s={wall:.1f}")
    for name in ("A_quant", "A_float"):
        a, kind = runs[name], name.split("_")[1]
        log(f"[dist] {name}: world iter_s={[round(s, 4) for s in a['iter_s']]}"
            f" twin iter_s={[round(s, 4) for s in twins[kind + '_iter_s']]}"
            f" leaves={a['leaves']} auc={a['auc']:.6f} twin_auc="
            f"{twins[kind + '_auc']:.6f} root={a['root']} sha={a['sha'][:16]}"
            f" (both ranks) launches rank0={json.dumps(a['counts'])} "
            f"rank1={json.dumps(r1['runs'][name]['counts'])} peak_bytes "
            f"rank0={a['peak']} rank1={r1['runs'][name]['peak']} (each "
            f"process's allocator peak; the CUDA context is not counted)")
    for tag in ("A_float", "int16_f", "int8_f"):
        c = runs[tag]["comm"]
        per = {k: round(v * 1e3 / c["splits"], 4)
               for k, v in c["seconds"].items()}
        mode = runs[tag]["hist_comm"]
        log(f"[dist] {tag}: hist_comm={mode} per split: collective ms "
            f"{per} (wall clock between device synchronizes, the wait "
            f"for the other rank included; one extra iteration of "
            f"{c['splits']} splits, {c['iter_s']:.3f} s); histogram wire "
            f"bytes sent per reduction (the root's and one a split) "
            f"{c['hist_bytes'] / (c['splits'] + 1):.0f} against "
            f"comms.payload_bytes "
            f"{comms.payload_bytes('data', FEATURES, BINS, mode)}; all "
            f"bytes sent per split {sum(c['bytes'].values()) / c['splits']:.0f}"
            f"; calls {c['calls']}")
    for tag in ("data_q", "voting28_q", "voting_q", "feature_q", "serial_q",
                "data_f", "int16_f", "int8_f", "sharded_f"):
        r = runs[tag]
        log(f"[dist] {tag} ({r.get('mode', 'serial')}, hist_comm="
            f"{r.get('hist_comm')}, split_search={r.get('split_search')}): "
            f"{DIST_SMALL_ROWS} rows auc={r['auc']:.6f} sha={r['sha'][:16]} "
            f"iter_s={[round(s, 4) for s in r['iter_s']]}")
    log(f"[dist] quantize one [{FEATURES}, {BINS}, 2] histogram to int8: "
        f"{r0['quantize_ms']} ms (CUDA events, plain torch)")
    log(f"[dist] twin construct_s={twin_construct:.2f} (beside what is "
        "left of the fault runs)")


def card_name():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else "nvidia-smi: no output")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=HIGGS_ROWS,
                    help="training rows (default: the Higgs 10.5M)")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed iterations after the warm-up one (at most "
                         "3 in train_goss, 2 in train_regression, "
                         "train_rank and train_airline, 1 in train_valid, "
                         "train_constrained, train_multiclass_dart and "
                         "train_allstate, none in train_multiclass; at "
                         "least 3 for train_goss to sample twice and for "
                         "resilience's 2 + 2)")
    ap.add_argument("--allstate-rows", type=int, default=ALLSTATE_ROWS,
                    help="train_allstate's training rows (default 100,000)")
    ap.add_argument("--airline-rows", type=int, default=AIRLINE_ROWS,
                    help="train_airline's training rows (default "
                         "10,000,000)")
    ap.add_argument("--reps", type=int, default=10,
                    help="launches per kernel timing")
    ap.add_argument("--stream-allstate", type=int, default=0,
                    metavar="ROWS",
                    help="only the streamed construct of ROWS "
                         "Allstate-shaped rows (13,200,000: the full "
                         "set), then exit")
    ap.add_argument("--parent", default=None,
                    help="a copy of the parent commit's lightgbm_tpu_torch "
                         "package: time its K1 and K2 beside this one's in "
                         "turns")
    ap.add_argument("--dist-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-chaos", default=None, metavar="OUTDIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # a rank of the dist phase's worlds (started by launch 2)
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.dist_chaos:
        return dist_chaos(args.dist_chaos)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch as lgb
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing: {exc}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    try:
        import pyarrow
        arrow = pyarrow.__version__
    except ImportError:
        arrow = "none"
    log(f"[env] torch={torch.__version__} cuda={torch.version.cuda} "
        f"python={sys.version.split()[0]} pyarrow={arrow} "
        f"device={torch.cuda.get_device_name(0)}")

    if args.stream_allstate:
        res = stream_allstate_only(torch, lgb, dev, args.stream_allstate)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip(), flush=True)
        print(json.dumps({"stream_allstate": res}), flush=True)
        return 0

    t_start = time.perf_counter()
    t_last = [t_start]

    def done(phase):
        now = time.perf_counter()
        log(f"[time] {phase} {now - t_last[0]:.1f} s (total "
            f"{now - t_start:.1f} s)")
        t_last[0] = now

    # the lint runs use the host's cores beside the build and the kernel
    # phases; the cost phase waits for them
    lint_runs = start_lint()
    try:
        phase_build(torch)
        done("build")
        k1 = phase_k1(torch, dev, args.rows, args.reps)
        done("k1")
        k1i = phase_k1_int(torch, dev, args.rows, args.reps)
        done("k1_int")
        phase_k1_ragged(torch, dev)
        done("k1_ragged")
        k2, k2_alt = phase_k2(torch, dev, args.rows, args.reps)
        done("k2")
        parent = load_parent(args.parent) if args.parent else None
        tr = phase_train(torch, lgb, dev, args.rows, args.iters, args.reps,
                         parent)
        turns = tr["turns"]
        done("train")
        phase_cost(torch, tr, k1, k2, lint_runs, card_name())
    finally:
        stop_lint(lint_runs)
    done("cost")
    trq = phase_train_quant(torch, lgb, dev, tr, args.iters)
    done("train_quant")
    dst = phase_dist(torch, lgb, dev, tr, min(args.iters, 2))
    done("dist")
    trs = phase_resilience(torch, lgb, dev, tr, trq, args.iters)
    done("resilience")
    pipe, pipe_job = phase_pipeline_start(torch, lgb, dev, card_name())
    ex = examples_prepare()
    # the pipeline's runs, then the examples' CLI runs, beside the
    # in-process phases from train_valid on
    lane = Lane([("pipeline", pipe_job),
                 ("examples", lambda: examples_clis(dev, ex))],
                [pipe["root"]], ex["started"])
    done("pipeline_start")
    try:
        return _after_lane_start(torch, lgb, dev, args, done, tr, trq, dst,
                                 trs, turns, k1, k1i, k2, k2_alt, pipe, ex,
                                 lane)
    finally:
        lane.stop()


def _after_lane_start(torch, lgb, dev, args, done, tr, trq, dst, trs,
                      turns, k1, k1i, k2, k2_alt, pipe, ex, lane):
    """The phases after the lane started, the wait for it, and the
    report (``done`` logs a phase's seconds on main's clock)."""
    tv = phase_train_valid(torch, lgb, dev, tr, min(args.iters, 1))
    done("train_valid")
    tg = phase_train_goss(torch, lgb, dev, tr, min(args.iters, 3))
    done("train_goss")
    trg = phase_train_regression(torch, lgb, dev, tr, min(args.iters, 2))
    done("train_regression")
    tc = phase_train_constrained(torch, lgb, dev, tr, min(args.iters, 1))
    done("train_constrained")
    tgr = phase_train_growth(torch, lgb, dev, tr, trq)
    done("train_growth")
    ih = phase_ingest_higgs(torch, lgb, dev, tr)
    done("ingest_higgs")
    sv = phase_serve(torch, lgb, dev, tr)
    done("serve")
    phase_serve_daemon(torch, lgb, dev, tr, sv["latency"])
    done("serve_daemon")
    sh = phase_surface_higgs(torch, lgb, dev, tr, min(args.iters, 3))
    for key in ("ds", "Xt", "target", "target_valid"):
        del tr[key]
    done("surface_higgs")
    phase_train_u16(torch, lgb, dev)
    phase_train_quant_small(torch, lgb, dev)
    small = phase_small_objectives(torch, lgb, dev)
    done("small runs")
    scons = phase_small_constraints(torch, lgb, dev)
    done("small constraint runs")
    trr = phase_train_rank(torch, lgb, dev, min(args.iters, 2))
    done("train_rank")
    trm = phase_train_multiclass(torch, lgb, dev, 0, args.reps)
    done("train_multiclass")
    trd = phase_train_multiclass_dart(torch, lgb, dev, trm,
                                      min(args.iters, 1))
    del trm["ds"]
    done("train_multiclass_dart")
    phase_predict_breadth(torch, lgb, dev, {
        "train": (tr["model_str"], tr["Xv"]),
        "train_multiclass": (trm["model_str"], trm["Xv"])})
    done("predict_breadth")
    tas = phase_train_allstate(torch, lgb, dev, args.allstate_rows,
                               min(args.iters, 1), args.reps)
    done("train_allstate")
    ta = phase_train_airline(torch, lgb, dev, args.airline_rows,
                             min(args.iters, 2), args.reps)
    done("train_airline")
    sc = phase_small_categorical(torch, lgb, dev)
    done("small categorical and monotone runs")
    phase_small_rf_cv(torch, lgb, dev)
    done("small rf and cv runs")
    se = phase_surface_examples(torch, lgb, dev, ex, lane)
    done("surface_examples")
    pl = phase_pipeline_finish(lgb, dev, pipe, lane, card_name())
    done("pipeline_finish")

    print(card_name(), flush=True)

    def entry(name, source, replaces, by_path, shapes, path=None):
        top = shapes[0]  # the root window: the main path's largest launch
        e = dict(name=name, route="cuda", source=source,
                 replaces=replaces, launches=sum(by_path.values()),
                 launches_by_path=by_path,
                 max_abs_err=max(s["max_abs_err"] for s in shapes
                                 if s.get("held_to", "plain") == "plain"),
                 ms=top["ms"], plain_ms=top["plain_ms"],
                 bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                 library_ms=top["library_ms"], shapes=shapes)
        if path is not None:
            mine = [t for t in turns if t["path"] == path]
            e["timing"] = ("ms at >= 2M rows: CUDA events around "
                           "back-to-back launches; below: torch.profiler "
                           "device time (every memset and kernel of a call)")
            change = [t for t in mine if t["impl"] == "change"]
            e["replay"] = dict(
                windows=change[0]["replay_windows"],
                launches=change[0]["replay_launches"],
                device_ms=statistics.mean(t["replay_ms"] for t in change),
                bound_ms=change[0]["replay_bound_ms"], method="profiler")
            e["turns"] = mine
        return e

    def launches(key):
        return {"train": tr["counts"][key], "train_quant": trq["counts"][key],
                "train_rank": trr["counts"][key],
                "train_multiclass": trm["counts"][key],
                "train_valid": tv["counts"][key],
                "train_goss": tg["counts"][key],
                "train_multiclass_dart": trd["counts"][key],
                "train_multiclass_unbundled":
                    trm["unbundled"]["counts"][key],
                "train_regression": trg["counts"][key],
                "resilience": trs["counts"][key],
                "train_allstate": tas["counts"][key],
                "train_airline": ta["counts"][key],
                "train_airline_quant": ta["quant_counts"][key],
                "small_objectives": sum(v["counts"][key]
                                        for v in small.values()),
                "small_categorical": sum(v["counts"][key]
                                         for v in sc.values()),
                "train_intermediate": tc["intermediate"]["counts"][key],
                "train_intermediate_quant":
                    tc["intermediate_quant"]["counts"][key],
                "train_advanced": tc["advanced"]["counts"][key],
                "train_interaction_forced":
                    tc["interaction_forced"]["counts"][key],
                "train_cegb": tc["cegb"]["counts"][key],
                "small_constraints": sum(v["counts"][key]
                                         for v in scons.values()),
                "surface_cli": sh["cli_counts"][key],
                "surface_cli_quant": sh["cli_quant_counts"][key],
                "surface_sklearn": sh["sk_counts"][key],
                "surface_custom": sh["custom_counts"][key],
                "surface_examples": sum(v[key]
                                        for v in se["counts"].values()),
                "pipeline": pl["counts"][key],
                # the ranks of the dist phase's worlds, in processes of
                # their own
                "dist": dst["counts"][key],
                **{f"train_growth_{k}": v["counts"][key]
                   for k, v in tgr.items()},
                **{k: v["counts"][key] for k, v in ih.items()}}

    # the rungs at the bundled widths join each kernel's ladder
    for key, shapes in (("k1", k1), ("k1_int", k1i), ("k2", k2)):
        for ph in (trm, tas, ta):
            extra = ph["kernels"][key]
            shapes.extend(extra if isinstance(extra, list) else [extra])

    part = entry("partition", "lightgbm_tpu_torch/csrc/partition.cu",
                 "lightgbm_tpu/ops/partition_kernel.py:97",
                 launches("partition"), k2)
    # launches: the wrapper's calls; kernel_launches: the kernels they
    # launched (one on the resident path, two on the streaming path)
    part["kernel_launches"] = launches("partition_kernels")
    # the calls that took the membership rule (categorical splits)
    part["member_launches"] = launches("partition_member")
    change = [t for t in tr["k2_turns"] if t["impl"] == "change"]
    part["replay"] = {kind: dict(
        splits=mine[0]["splits"], calls=mine[0]["calls"],
        kernels=mine[0]["kernels"],
        device_ms=statistics.mean(t["replay_ms"] for t in mine),
        bound_ms=mine[0]["replay_bound_ms"], method="profiler",
        buckets=mine[0]["buckets"])
        for kind in ("f32", "int8")
        for mine in [[t for t in change if t["payload"] == kind]]}
    part["turns"] = tr["k2_turns"]
    part["alternatives"] = k2_alt
    print(json.dumps({"kernels": [
        entry("hist", "lightgbm_tpu_torch/csrc/hist.cu",
              "lightgbm_tpu/ops/pallas_hist.py:145", launches("hist"), k1,
              "float"),
        entry("hist_int", "lightgbm_tpu_torch/csrc/hist.cu",
              "lightgbm_tpu/ops/pallas_hist.py:196", launches("hist_int"),
              k1i, "int"),
        part,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
