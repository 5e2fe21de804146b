"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full-width run (one GPU)
    python3 chip_smoke.py --rows N   # the same at N training rows

Phases, in order; any failure exits non-zero:

1. build   — compile the kernels from lightgbm_tpu_torch/csrc/ with nvcc
             (sm_90a), one nvcc per source, all started together;
2. k1      — the histogram kernel's float path against its plain
             version at the main path's shapes (the root window and a
             ~100k-row window, u16 windows): allclose, sibling
             subtraction, bit-identical reruns;
3. k1_int  — the histogram kernel's int path (int8 payload, exact int32
             sums) against its plain version: the root window with
             payloads from discretize(), a 100k window, u16 windows, the
             child windows of a partition (sides 1/2) and a 150k-row
             window of 127s in few bins (past 2^24): bit-exact, and
             bit-identical reruns;
4. k2      — the partition kernel against its plain version (root, mid,
             ragged, all-left and all-right windows, u16 rows, and the
             quantized path's 2-byte int8 payload rows): exact;
5. train   — the main path through the public API at the Higgs shape
             (10.5M x 28 training rows + 500k held out, 255 leaves, 255
             bins, binary): 1 warm-up + 5 timed iterations, predict,
             save/load round trip; launch counters; one profiled
             iteration; AUC against the same training with the kernels'
             plain versions forced;
6. train_quant — quantized-gradient training on the same data
             (use_quantized_grad, 4 bins, stochastic rounding, leaf
             renewal, seed 0): the same measurements, the int path's
             launch counter, and a plain-kernel twin with the same seed
             (first tree identical, AUC within 0.002); AUC not below the
             float path's less 0.01;
7. small runs — uint16 bins (max_bin=400) held to the float standard,
             and a deterministic quantized run (200k x 28, no stochastic
             rounding) whose every tree equals its plain twin's;
8. report  — the card's name and power limit, then one JSON line with
             every kernel's launches, times, bound and library time.

The last line of stdout is {"ok": true, "device": {...}}. Exits non-zero
without printing a result when torch.cuda is unavailable, or when the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# scalar int32 adds: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the
# data sheet lists no scalar int32 rate; FP32's 67e12 counts an FMA as
# two operations on 128 lanes)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

HIGGS_ROWS = 10_500_000
VALID_ROWS = 500_000
FEATURES = 28
BINS = 255


def make_higgs_like(n, f, seed=0):
    """The Higgs-shaped generator of bench.py (same draws, same seed)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f).astype(np.float32)
    coef = rs.randn(f).astype(np.float32)
    logits = X @ coef * 0.5 + 0.5 * rs.randn(n).astype(np.float32)
    y = (logits > 0).astype(np.float32)
    return X, y.astype(np.float64)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, torch):
    """Median milliseconds of ``fn()`` over ``reps`` launches (CUDA
    events around each launch, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    return secs


def _rand_window(torch, dev, S, F, B, gen):
    rows = torch.randint(0, B, (S, F), generator=gen, device=dev,
                         dtype=torch.int32)
    rows = rows.to(torch.uint8 if B <= 256 else torch.uint16)
    pay = torch.stack([torch.randn(S, generator=gen, device=dev),
                       torch.rand(S, generator=gen, device=dev)],
                      dim=1).contiguous()
    return rows, pay


def phase_k1(torch, dev, root_rows, reps):
    from lightgbm_tpu_torch.ops.histogram import hist_plain, window_hist
    from lightgbm_tpu_torch.ops.partition import partition_window
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shapes = []
    # the main path's root and mid-size windows, a u16 window, and a u16
    # window wide enough in F * B to split the features over blocks
    for label, S, F, B in (("root", root_rows, FEATURES, BINS),
                           ("mid", 100_003, FEATURES, BINS),
                           ("u16", 50_000, 8, 300),
                           ("wide_u16", 50_000, 40, 300)):
        rows, pay = _rand_window(torch, dev, S, F, B, gen)
        k = window_hist(rows, pay, B, 0, S)
        p = hist_plain(rows, pay, B)
        tol = 1e-5 * pay.abs().sum(dim=0)[None, None, :] + 1e-6
        err = (k - p).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"K1 {label}: kernel != plain, max err "
                                 f"{float(err.max())}")
        k2 = window_hist(rows, pay, B, 0, S)
        if not torch.equal(k, k2):
            raise AssertionError(f"K1 {label}: two launches differ")
        # sibling subtraction on a partitioned window: parent - left
        # child (kernel, side 1) against the right child (plain, side 2)
        dst_r = torch.empty_like(rows)
        dst_p = torch.empty_like(pay)
        nl = partition_window(rows, dst_r, pay, dst_p, None, None, 0, S, 0,
                              100, False, -1)
        left = window_hist(dst_r, dst_p, B, 0, S, nl, 1)
        right_k = window_hist(dst_r, dst_p, B, 0, S, nl, 2)
        right_p = hist_plain(dst_r[int(nl.item()):], dst_p[int(nl.item()):],
                             B)
        serr = ((k - left) - right_p).abs()
        if not bool((serr <= tol).all()):
            raise AssertionError(f"K1 {label}: parent - child != sibling, "
                                 f"max err {float(serr.max())}")
        if not bool(((right_k - right_p).abs() <= tol).all()):
            raise AssertionError(f"K1 {label}: right-child window != plain")
        ms = cuda_ms(lambda: window_hist(rows, pay, B, 0, S), reps, torch)
        plain_ms = cuda_ms(lambda: hist_plain(rows, pay, B), reps, torch)
        flat = (torch.arange(F, device=dev, dtype=torch.int64) * B)[None] \
            + rows.to(torch.int64)
        flat = flat.reshape(-1)
        weights = [pay[:, c].repeat_interleave(F) for c in range(2)]

        def library():
            for w in weights:
                torch.bincount(flat, weights=w, minlength=F * B)

        lib_ms = cuda_ms(library, max(3, reps // 3), torch)
        nbytes = S * F * rows.element_size() + S * 8 + F * B * 2 * 4
        ops = S * F * 2
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
        shapes.append(dict(shape=label, rows=S, features=F, bins=B,
                           max_abs_err=float(err.max()),
                           sibling_max_abs_err=float(serr.max()),
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms,
                           bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                           >= ops / FP32_OPS_PER_S else "operations"))
        log(f"[k1] {label} S={S} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
            f"max_abs_err={float(err.max()):.3g} bit-identical reruns")
        del rows, pay, k, k2, p, dst_r, dst_p, flat, weights
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
    shapes = []
    for label, S, F, B in (("root", root_rows, FEATURES, BINS),
                           ("mid", 100_003, FEATURES, BINS),
                           ("u16", 50_000, 8, 300),
                           ("wide_u16", 50_000, 40, 300),
                           ("blocked_127", 150_000, 4, 16)):
        rows = torch.randint(0, B, (S, F), generator=gen, device=dev,
                             dtype=torch.int32)
        if label == "blocked_127":
            # 127 in both channels, ~95% of the rows in bin 3: a bin sums
            # past 2^24, where an f32 accumulator stops being exact
            hot = torch.rand((S, F), generator=gen, device=dev) < 0.95
            rows = torch.where(hot, torch.full_like(rows, 3), rows)
            pay = torch.full((S, 2), 127, dtype=torch.int8, device=dev)
        else:
            pay = _quant_pay(torch, dev, S, gen)
        rows = rows.to(torch.uint8 if B <= 256 else torch.uint16)
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
                              B // 2, False, -1)
        n_l = int(nl.item())
        left = window_hist(dst_r, dst_p, B, 0, S, nl, 1)
        right = window_hist(dst_r, dst_p, B, 0, S, nl, 2)
        if not (torch.equal(left, hist_plain(dst_r[:n_l], dst_p[:n_l], B))
                and torch.equal(right, hist_plain(dst_r[n_l:], dst_p[n_l:],
                                                  B))
                and torch.equal(k - left, right)):
            raise AssertionError(f"K1 int {label}: child windows or "
                                 "sibling subtraction inexact")
        ms = cuda_ms(lambda: window_hist(rows, pay, B, 0, S), reps, torch)
        plain_ms = cuda_ms(lambda: hist_plain(rows, pay, B), reps, torch)
        library, lib_out = _int_library(torch, rows, pay, B)
        library()
        if not torch.equal(lib_out.reshape(F, B, 2), k):
            raise AssertionError(f"K1 int {label}: scatter_add_ != kernel")
        lib_ms = cuda_ms(library, max(3, reps // 3), torch)
        nbytes = S * F * rows.element_size() + S * 2 + F * B * 2 * 4
        ops = S * F * 2
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        bound_ms = 1e3 * max(bytes_s, ops_s)
        shapes.append(dict(shape=label, rows=S, features=F, bins=B,
                           max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by="bytes" if bytes_s >= ops_s
                           else "operations"))
        log(f"[k1_int] {label} S={S} F={F} B={B} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound_ms:.4f} exact, sides exact, bit-identical "
            "reruns")
        del rows, pay, k, p, dst_r, dst_p, left, right, library, lib_out
    return shapes


def phase_k2(torch, dev, root_rows, reps):
    from lightgbm_tpu_torch.ops.partition import (partition_plain,
                                                  partition_window)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    shapes = []
    F, B = FEATURES, BINS
    cases = (("root", root_rows, 127, F, B), ("mid", 100_000, 90, F, B),
             ("ragged", 100_003, 200, F, B), ("all_left", 65_537, B, F, B),
             ("all_right", 65_537, -1, F, B),
             # u16 rows of 16 bytes (copied by words) and of 18 (by
             # elements)
             ("u16", 70_001, 150, 8, 300), ("u16_odd", 70_003, 150, 9, 300),
             # the quantized path's rows: a 2-byte int8 (grad, hess) pair
             ("root_int8", root_rows, 127, F, B),
             ("ragged_int8", 100_003, 200, F, B),
             ("u16_int8", 70_001, 150, 8, 300),
             ("u16_odd_int8", 70_003, 150, 9, 300))
    for label, S, thr, F, B in cases:
        pad = 1000  # the window sits inside larger buffers
        n = S + 2 * pad
        rows, pay = _rand_window(torch, dev, n, F, B, gen)
        if label.endswith("_int8"):
            pay = _quant_pay(torch, dev, n, gen)
        ids = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        nan_bin = 7 if label == "mid" else -1
        outs = []
        for fn in (partition_window, partition_plain):
            d_r = torch.zeros_like(rows)
            d_p = torch.zeros_like(pay)
            d_i = torch.zeros_like(ids)
            nl = fn(rows, d_r, pay, d_p, ids, d_i, pad, S, 3, thr, True,
                    nan_bin)
            outs.append((nl, d_r, d_p, d_i))
        (nk, rk, pk, ik), (np_, rp, pp, ip) = outs
        if not (torch.equal(nk, np_) and torch.equal(rk, rp)
                and torch.equal(pk, pp) and torch.equal(ik, ip)):
            raise AssertionError(f"K2 {label}: kernel != plain")
        nl = int(nk.item())
        want = {"all_left": S, "all_right": 0}.get(label)
        if want is not None and nl != want:
            raise AssertionError(f"K2 {label}: n_left={nl}, want {want}")
        d_r, d_p, d_i = torch.empty_like(rows), torch.empty_like(pay), \
            torch.empty_like(ids)

        def run(fn):
            return lambda: fn(rows, d_r, pay, d_p, ids, d_i, pad, S, 3, thr,
                              True, nan_bin)

        ms = cuda_ms(run(partition_window), reps, torch)
        plain_ms = cuda_ms(run(partition_plain), reps, torch)
        nbytes = 2 * S * (F * rows.element_size() + 2 * pay.element_size()
                          + 4)
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        shapes.append(dict(shape=label, rows=S, features=F,
                           payload=str(pay.dtype).replace("torch.", ""),
                           n_left=nl,
                           max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           library_ms=None, bound_ms=bound_ms,
                           bound_by="bytes"))
        log(f"[k2] {label} S={S} n_left={nl} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} exact")
        del rows, pay, ids, d_r, d_p, d_i, outs
    return shapes


def _reset_counts():
    from lightgbm_tpu_torch.ops.histogram import window_hist
    from lightgbm_tpu_torch.ops.partition import partition_window
    window_hist.launches = 0
    window_hist.int_launches = 0
    partition_window.launches = 0


def _read_counts():
    from lightgbm_tpu_torch.ops.histogram import window_hist
    from lightgbm_tpu_torch.ops.partition import partition_window
    return dict(hist=window_hist.launches,
                hist_int=window_hist.int_launches,
                partition=partition_window.launches)


def _drive(torch, lgb, dev, params, ds, Xv, yv, iters, tag):
    """Train 1 warm-up + ``iters`` timed iterations through the public
    API with every launch count set to 0 just before and read just
    after; predict the held-out rows, score them and round-trip the
    model through its text."""
    from lightgbm_tpu_torch.metrics import auc, binary_logloss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, num_boost_round=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    iter_s = []
    for _ in range(iters):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    p = bst.predict(Xv)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    leaves = [t.num_leaves for t in bst._models]
    if p.shape != (len(yv),) or not np.all(np.isfinite(p)):
        raise AssertionError(f"{tag}: predictions are not finite [n] "
                             "values")
    yv_t = torch.as_tensor(yv, device=dev)
    p_t = torch.as_tensor(p, device=dev)
    auc_k = auc(p_t, yv_t)
    ll_k = binary_logloss(p_t, yv_t)
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
        f"auc={auc_k:.6f} logloss={ll_k:.6f} roundtrip_max_abs={rt:.3g}")
    return dict(bst=bst, counts=counts, leaves=leaves, iter_s=iter_s,
                auc=auc_k, logloss=ll_k, peak=peak, predict_s=predict_s)


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


def _plain_twin(torch, lgb, dev, params, ds, Xv, yv, rounds, tag):
    """The same training with both kernels' plain versions forced."""
    from lightgbm_tpu_torch.metrics import auc
    from lightgbm_tpu_torch.ops.histogram import plain_kernels
    t0 = time.perf_counter()
    with plain_kernels():
        bst_p = lgb.train(params, ds, num_boost_round=rounds)
        pp = bst_p.predict(Xv)
    plain_s = time.perf_counter() - t0
    auc_p = auc(torch.as_tensor(pp, device=dev),
                torch.as_tensor(yv, device=dev))
    log(f"[{tag}] plain run: seconds={plain_s:.2f} auc={auc_p:.6f}")
    return bst_p, auc_p


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


def phase_train(torch, lgb, dev, n_train, iters):
    t0 = time.perf_counter()
    X, y = make_higgs_like(n_train + VALID_ROWS, FEATURES)
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
    prof = profile_iteration(torch, r["bst"])

    # the same 6 iterations with both kernels' plain versions forced
    bst_p, auc_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                               1 + iters, "train")
    r_k, r_p = _root_split(r["bst"]), _root_split(bst_p)
    log(f"[train] root_split kernel={r_k} plain={r_p}")
    if r["auc"] < auc_p - 0.002:
        raise AssertionError(f"AUC {r['auc']} below plain {auc_p} - 0.002")
    if r_k != r_p:
        raise AssertionError("the first tree's root split differs from "
                             "the plain run's")
    del r["bst"], bst_p
    return dict(r, auc_plain=auc_p, construct_s=construct_s, profile=prof,
                ds=ds, Xv=Xv, yv=yv)


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
    prof = profile_iteration(torch, r["bst"])

    # the twin: the same seed, so the same rounding draws, and int32
    # histograms that are exact in any order
    bst_p, auc_p = _plain_twin(torch, lgb, dev, params, ds, Xv, yv,
                               1 + iters, "train_quant")
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


def profile_iteration(torch, bst):
    """One more boosting iteration under torch.profiler: the card's busy
    time (the sum of the device-side events' times; one stream, so they
    do not overlap) against the iteration's wall time, the kernels that
    take most of it, and the host ops that take most of the host's.
    Runs after the model above was scored, so it does not change what
    was checked."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / (wall * 1e3) if rows else None,
               top=[dict(name=k[:60], calls=c, ms=ms)
                    for ms, c, k in rows[:10]],
               host_top=[dict(name=k[:60], calls=c, ms=ms)
                         for ms, c, k in host[:8]])
    log("[profile] one iteration under torch.profiler: wall_ms="
        f"{out['wall_ms']:.1f} device_busy_ms={busy_ms:.1f} idle_share="
        + ("not measured (no device time in the trace)"
           if out["idle_share"] is None else f"{out['idle_share']:.3f}"))
    for r in out["top"]:
        log(f"[profile]   {r['ms']:9.3f} ms {r['calls']:6d}x {r['name']}")
    # where the host's time goes: CPU ops by self time (a read-back's
    # wait for the card shows under the op that reads back)
    for r in out["host_top"]:
        log(f"[profile]   host {r['ms']:9.3f} ms {r['calls']:6d}x "
            f"{r['name']}")
    return out


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=HIGGS_ROWS,
                    help="training rows (default: the Higgs 10.5M)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed iterations after the warm-up one")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per kernel timing")
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

    phase_build(torch)
    k1 = phase_k1(torch, dev, args.rows, args.reps)
    k1i = phase_k1_int(torch, dev, args.rows, args.reps)
    k2 = phase_k2(torch, dev, args.rows, args.reps)
    tr = phase_train(torch, lgb, dev, args.rows, args.iters)
    trq = phase_train_quant(torch, lgb, dev, tr, args.iters)
    del tr["ds"]
    phase_train_u16(torch, lgb, dev)
    phase_train_quant_small(torch, lgb, dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)

    def entry(name, source, replaces, by_path, shapes):
        top = shapes[0]  # the root window: the main path's largest launch
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path,
                    max_abs_err=max(s["max_abs_err"] for s in shapes),
                    ms=top["ms"], plain_ms=top["plain_ms"],
                    bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                    library_ms=top["library_ms"], shapes=shapes)

    def launches(key):
        return {"train": tr["counts"][key], "train_quant": trq["counts"][key]}

    print(json.dumps({"kernels": [
        entry("hist", "lightgbm_tpu_torch/csrc/hist.cu",
              "lightgbm_tpu/ops/pallas_hist.py:145", launches("hist"), k1),
        entry("hist_int", "lightgbm_tpu_torch/csrc/hist.cu",
              "lightgbm_tpu/ops/pallas_hist.py:196", launches("hist_int"),
              k1i),
        entry("partition", "lightgbm_tpu_torch/csrc/partition.cu",
              "lightgbm_tpu/ops/partition_kernel.py:97",
              launches("partition"), k2),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
