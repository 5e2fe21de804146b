"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full-width run (one GPU)
    python3 chip_smoke.py --rows N   # the same at N training rows
    python3 chip_smoke.py --allstate-rows N  # train_allstate at N rows
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
             window; with --parent in turns); one profiled iteration;
             AUC against the same training with the kernels' plain
             versions forced;
6. train_quant — quantized-gradient training on the same data
             (use_quantized_grad, 4 bins, stochastic rounding, leaf
             renewal, seed 0): the same measurements, the int path's
             launch counter, and a plain-kernel twin with the same seed
             (first tree identical, AUC within 0.002); AUC not below the
             float path's less 0.01;
6b. train_valid — the main path with this slice's features on the same
             data: a 500k-row valid set binned with the train set's
             mappers, metric=[auc, binary_logloss], bagging 0.8 every
             iteration, feature_fraction 0.8, record_evaluation and
             early_stopping(5); 1 warm-up + 3 timed iterations (iter_s,
             eval_ms, the idle share, the in-bag window sizes); every
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
             noise), 1 warm-up + 3 timed iterations: renew_ms by CUDA
             events, held-out L1; against the plain twin the same root
             splits and L1 within 0.002 relative;
6e. train_constrained — this slice's path on the same Dataset:
             intermediate monotone constraints on features 0-3, float,
             1 warm-up + 2 timed iterations (iter_s, idle share and
             launches per split of one profiled iteration, leaves
             re-searched per tree; the float64-sum twin's root splits and
             AUC within 0.002; one quantized tree equal to its twin's);
             advanced, quantized, one tree of 255 leaves equal to its
             twin's (the bounds' chunk of leaves, peak memory, tree
             seconds); interaction constraints (four groups of seven)
             with three forced splits on group 0, one quantized tree
             equal to its twin's, its first splits the forced ones, every
             path inside one group; CEGB (split, coupled and lazy
             penalties), two quantized trees and the lazy matrix equal to
             the twin's; monotone sweeps of the monotone models;
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
             + 3 timed iterations, the gradient function timed alone
             (grad_ms), held-out NDCG@10, launch counters, one profiled
             iteration; the card's gradients of the first 200 queries at
             the warm-up scores equal to the CPU's (rtol 1e-4); against
             the plain twin the same root split and NDCG@10 within 0.002;
9. train_multiclass — softmax multiclass at Covertype's shape (531,012 +
             50,000 held-out rows x 54 features, 7 classes, 255 leaves,
             EFB at its default: the one-hot indicators bundle; G, B and
             the groups printed): 1 warm-up + 1 timed iteration of 7
             trees, held-out multi_logloss and accuracy, every row's
             probabilities summing to 1, launch counters, one profiled
             iteration; against the plain twin, whose float histograms
             sum in float64 (float32 sums of 531k near-equal hessians
             drift: that twin and the drift of the root histogram are
             printed beside), the first iteration's 7 root splits and
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
9c. predict_breadth — pred_contrib on 10,000 held-out rows of train's
             model and train_multiclass's (each row's contributions sum
             to its raw score; 200 rows of the first iteration equal a
             single-row TreeSHAP of the model text) and pred_early_stop
             (a margin no row passes equals the full walk; the share of
             rows stopped early and the time at the default margin);
9d. train_allstate — EFB at full width: Allstate's shape (500,000 +
             50,000 rows x 4,228 features, 33 one-hot blocks of 128, NaN
             in column 0), binary, 255 leaves: construct and bundling
             seconds, G, B, peak device memory, iter_s, idle share, AUC;
             the device's bundled matrix equal to the numpy build on
             100,000 rows; against the float64-sum plain twin the same
             root split in every tree and AUC within 0.002; K1 and K2 at
             the bundled width;
9e. train_airline — categorical splits at the airline benchmark's shape
             (10,000,000 + 500,000 rows x 8: six categoricals of 7 to
             ~300 categories, DepTime, Distance), binary, 255 leaves,
             1 warm-up + 3 timed iterations: construct_s, the bins per
             mapper, iter_s, the idle share and launches of one
             profiled iteration, the share of categorical splits by
             family, peak memory, AUC; against the float64-sum twin the
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

import numpy as np

# the range rule's "no upper bound" (K2's hi for a plain split)
INT_MAX = 2 ** 31 - 1

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# scalar int32 adds: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the
# data sheet lists no scalar int32 rate; FP32's 67e12 counts an FMA as
# two operations on 128 lanes)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

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


def make_allstate_like(n, f, seed=0, per_group=128):
    """The Allstate-shaped generator of bench.py (make_allstate_like over
    allstate_chunks at its default chunk of 262,144 rows; same draws,
    same seed): ``f // per_group`` one-hot blocks of ``per_group``
    columns, each row one nonzero per block with a value from a fixed
    stream (seed 12345), 10% NaN in column 0, the label the block values'
    sum above its expectation. One float32 matrix, filled chunk by
    chunk."""
    groups = f // per_group
    vals = np.random.RandomState(12345).rand(
        groups, per_group).astype(np.float32) * 2
    thresh = np.float32(groups)
    X = np.empty((n, f), np.float32)
    y = np.empty(n, np.float64)
    start = 0
    while start < n:
        c = min(ALLSTATE_CHUNK, n - start)
        rs = np.random.RandomState((seed * 1_000_003 + start) % (2 ** 31 - 1))
        Xc = X[start:start + c]
        Xc[:] = 0.0
        signal = np.zeros(c, np.float32)
        rows = np.arange(c)
        for g in range(groups):
            pick = rs.randint(0, per_group, c)
            Xc[rows, g * per_group + pick] = vals[g, pick]
            signal += vals[g, pick]
        Xc[rs.rand(c) < 0.1, 0] = np.nan
        y[start:start + c] = (signal > thresh).astype(np.float64)
        start += c
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
        trees.append(t)
    return trees


def numpy_predict_raw(text, X):
    """Raw scores of ``X`` by a numpy walk of a model text: LightGBM's
    NumericalDecision (missing types none, zero and nan) and
    CategoricalDecision (``int(v)`` goes left when its bit is set in the
    node's u32 words; NaN, negative values and values past the words go
    right)."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    raw = np.zeros(n)
    rows = np.arange(n)
    for t in _parse_model(text):
        if t["num_leaves"] <= 1:
            raw += t["leaf_value"][0]
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
        raw += t["leaf_value"][~node]
    return raw


def log(msg):
    print(msg, flush=True)


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


def _device_us(e, DeviceType):
    if getattr(e, "device_type", None) != DeviceType.CUDA:
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


def _k1_bound(S, F, bin_bytes, pay_bytes, B, ops_per_s):
    """(bound_ms, bound_by): each input read once, the [F, B, 2] 4-byte
    output written once; one add per (row, feature, channel)."""
    nbytes = S * F * bin_bytes + S * pay_bytes + F * B * 2 * 4
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, S * F * 2 / ops_per_s
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


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
        bound_ms, bound_by = _k1_bound(S, F, rows.element_size(), 8, B,
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
        bound_ms, bound_by = _k1_bound(S, F, rows.element_size(), 2, B,
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


def _k2_bound(S, F, bin_bytes, pay_bytes):
    """K2's bound: the window's rows (bins, payload, a 4-byte id) read
    once and written once."""
    return 1e3 * 2 * S * (F * bin_bytes + pay_bytes + 4) / HBM_BYTES_PER_S


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
            bound_ms = _k2_bound(S, F, bb, pb)
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
    bound_ms, bound_by = _k1_bound(S, G, bb, 8, B, FP32_OPS_PER_S)
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
    bound_ms, bound_by = _k1_bound(S, G, bb, 2, B, INT32_OPS_PER_S)
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
                bound_ms = _k2_bound(S, G, bb, pb)
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
            bound[bucket_of(sp["cnt"])] += _k2_bound(sp["cnt"], F, bb, pb)
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
        f"median_iter_s={statistics.median(iter_s):.4f} "
        f"predict_s={predict_s:.4f} leaves={leaves} "
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
    r = _drive(torch, lgb, dev, params, ds, Xv, yv, iters, "train")
    _check_counts("train", r["counts"], r["leaves"], "hist")
    tree = r["bst"]._models[0]
    wins = replay_windows(tree)
    turns = phase_k1_turns(torch, dev, ds.device_bins(), wins, reps,
                           parent and parent("ops.histogram"))
    k2_turns = phase_k2_turns(torch, dev, ds.device_bins(), tree,
                              ds.used_feature_indices(), ds.feat_nan_bin(),
                              reps, parent and parent("ops.partition"))
    prof = profile_iteration(torch, r["bst"])

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
                model_str=model_str,
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
    prof = profile_iteration(torch, r["bst"], host=False)

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
    del r["bst"], bst_p
    return dict(r, auc_plain=auc_p, profile=prof, same_trees=same)


def profile_iteration(torch, bst, host=True):
    """One more boosting iteration under torch.profiler: the card's busy
    time (the sum of the device-side events' times; one stream, so they
    do not overlap) against the iteration's wall time, the kernels that
    take most of it, and the host ops that take most of the host's.
    Runs after the model above was scored, so it does not change what
    was checked. ``host=False`` records the device's events only (no
    host ops): the trace of an iteration of ~270k launches takes minutes
    of host time to read back with them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    acts = [ProfilerActivity.CPU] if host else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    rows, host = [], []
    for e in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same time as "self device time"
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
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
                _k1_bound(window_rows(w), F, bins.element_size(),
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
    iterations, the gradient function timed alone, held-out NDCG@10, one
    profiled iteration; the card's gradients of the first 200 queries at
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
    prof = profile_iteration(torch, r["bst"], host=False)
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
    trees, held-out multi_logloss and accuracy, one profiled iteration;
    against the plain twin, the first iteration's 7 root splits and
    multi_logloss within 0.002. The plain twin's float histograms are
    summed in float64 (:func:`exact_float_sums`): at this shape float32
    sums drift far from the exact ones (printed beside, with the twin
    that sums in float32). Then one iteration unbundled
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
    prof = profile_iteration(torch, r["bst"], host=False)
    f32_drift = _f32_drift(torch, ds, yt)

    def roots(bst):
        return [(int(t.split_feature[0]), int(t.threshold_bin[0]))
                for t in bst._models[:COV_CLASSES]]
    # the plain twin as the other phases run it (float32 sums), for the
    # record; then the twin it is held to, whose float sums are exact
    bst_f, m_f = _plain_twin(torch, lgb, dev, params, ds, Xv, yv, 1,
                             "train_multiclass f32 sums (one iteration)",
                             scorer)
    with exact_float_sums(torch):
        bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                                 1 + iters, "train_multiclass", scorer)
    roots_k, roots_p = roots(r["bst"]), roots(bst_p)
    same = [int(_same_structure(a, b))
            for a, b in zip(r["bst"]._models, bst_p._models)]
    log(f"[train_multiclass] first iteration's root splits kernel={roots_k} "
        f"plain={roots_p} (plain with float32 sums: {roots(bst_f)}); "
        f"multi_logloss={r['multi_logloss']:.6f} plain="
        f"{m_p['multi_logloss']:.6f} (float32 sums: "
        f"{m_f['multi_logloss']:.6f}); trees identical in structure to the "
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
    del r["bst"], bst_p, bst_f
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
                multi_logloss_plain_f32=m_f["multi_logloss"],
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
    prof = profile_iteration(torch, bst, host=False)
    log(f"[train_valid] valid set {len(yv)} rows binned with the train "
        f"set's mappers in {valid_construct_s:.3f} s; iter_s="
        f"{[round(x, 4) for x in iter_s]} (the warm-up first; each with "
        f"its valid scoring and metrics) median_timed_iter_s="
        f"{statistics.median(iter_s[1:]):.4f} "
        f"eval_ms={score_ms + metric_ms:.3f} "
        f"(valid scoring of one tree {score_ms:.3f} + metrics "
        f"{metric_ms:.3f}, CUDA events) idle_share="
        f"{prof['idle_share']} in-bag window sizes={in_bag} of "
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
    prof = profile_iteration(torch, r["bst"], host=False)
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



ALLSTATE_ROWS = 500_000
ALLSTATE_VALID = 50_000
ALLSTATE_FEATURES = 4228


def phase_train_allstate(torch, lgb, dev, n_train, iters, reps):
    """EFB at full width: Allstate's shape (``make_allstate_like``, 4,228
    features in 33 one-hot blocks of 128 with NaN in column 0;
    ``n_train`` (500,000) training rows, seed 0, and 50,000 held out,
    seed 1), binary, 255
    leaves, 255 bins, EFB at its default. Reduced: rows 13,200,000 ->
    500,000 (the float32 input alone would be ~223 GB of host memory);
    the bundling sample stays 200,000 rows, so G is that of a larger run.
    Prints construct_s, the bundling seconds, G, B, the peak device
    memory, iter_s (1 warm-up + ``iters`` timed), the idle share and AUC.
    Checks: the bundled matrix built on the device equals the numpy build
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
    prof = profile_iteration(torch, r["bst"], host=False)
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
                roots=roots_k)


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
    prof = profile_iteration(torch, r["bst"], host=False)
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
      one profiled iteration (idle share, launches per split), leaves
      re-searched per tree; against the float64-sum plain twin the same
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
    prof = profile_iteration(torch, r["bst"], host=False)
    splits = r["bst"]._models[-1].num_leaves - 1
    per_split = prof["launches"] / max(1, splits)
    worst = _monotone_sweep(r["bst"], Xv, MONO)
    with exact_float_sums(torch):
        bst_p, m_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                                 1 + iters, "train_intermediate")
    roots_k = [_root_split_of(t) for t in r["bst"]._models[:1 + iters]]
    roots_p = [_root_split_of(t) for t in bst_p._models]
    log(f"[train_intermediate] leaves re-searched per tree {researched:.1f}"
        f"; profiled iteration: {prof['launches']} device events over "
        f"{splits} splits ({per_split:.1f} per split), idle share "
        f"{prof['idle_share']}; root splits kernel={roots_k} plain="
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
                               launches_per_split=per_split,
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


CONTRIB_ROWS = 10_000
ORACLE_ROWS = 200


def phase_predict_breadth(torch, lgb, dev, models):
    """``pred_contrib`` and ``pred_early_stop`` on the boosters of
    ``train`` (4 trees of 255 leaves) and ``train_multiclass`` (2
    iterations of 7 trees), loaded from their model texts; ``models``:
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=HIGGS_ROWS,
                    help="training rows (default: the Higgs 10.5M)")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed iterations after the warm-up one (at most "
                         "3 in train_goss, train_regression, train_rank "
                         "and train_airline, 1 in train_multiclass, "
                         "train_multiclass_dart and train_allstate; at "
                         "least 3 for train_goss to sample twice)")
    ap.add_argument("--allstate-rows", type=int, default=ALLSTATE_ROWS,
                    help="train_allstate's training rows (default 500,000)")
    ap.add_argument("--airline-rows", type=int, default=AIRLINE_ROWS,
                    help="train_airline's training rows (default "
                         "10,000,000)")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per kernel timing")
    ap.add_argument("--parent", default=None,
                    help="a copy of the parent commit's lightgbm_tpu_torch "
                         "package: time its K1 and K2 beside this one's in "
                         "turns")
    args = ap.parse_args(argv)

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
    log(f"[env] torch={torch.__version__} cuda={torch.version.cuda} "
        f"python={sys.version.split()[0]} "
        f"device={torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    t_last = [t_start]

    def done(phase):
        now = time.perf_counter()
        log(f"[time] {phase} {now - t_last[0]:.1f} s (total "
            f"{now - t_start:.1f} s)")
        t_last[0] = now

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
    trq = phase_train_quant(torch, lgb, dev, tr, args.iters)
    done("train_quant")
    tv = phase_train_valid(torch, lgb, dev, tr, args.iters)
    done("train_valid")
    tg = phase_train_goss(torch, lgb, dev, tr, min(args.iters, 3))
    done("train_goss")
    trg = phase_train_regression(torch, lgb, dev, tr, min(args.iters, 3))
    done("train_regression")
    tc = phase_train_constrained(torch, lgb, dev, tr, min(args.iters, 2))
    for key in ("ds", "Xt", "target", "target_valid"):
        del tr[key]
    done("train_constrained")
    phase_train_u16(torch, lgb, dev)
    phase_train_quant_small(torch, lgb, dev)
    small = phase_small_objectives(torch, lgb, dev)
    done("small runs")
    scons = phase_small_constraints(torch, lgb, dev)
    done("small constraint runs")
    trr = phase_train_rank(torch, lgb, dev, min(args.iters, 3))
    done("train_rank")
    trm = phase_train_multiclass(torch, lgb, dev, min(args.iters, 1),
                                 args.reps)
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
                             min(args.iters, 3), args.reps)
    done("train_airline")
    sc = phase_small_categorical(torch, lgb, dev)
    done("small categorical and monotone runs")
    phase_small_rf_cv(torch, lgb, dev)
    done("small rf and cv runs")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)

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
                                         for v in scons.values())}

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
