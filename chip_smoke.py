"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full-width run (one GPU)
    python3 chip_smoke.py --rows N   # the same at N training rows
    python3 chip_smoke.py --parent smoke_checkout/parent/lightgbm_tpu_torch
                                     # also time the parent's K1 in turns

Phases, in order; any failure exits non-zero:

1. build   — compile the kernels from lightgbm_tpu_torch/csrc/ with nvcc
             (sm_90a), one nvcc per source, all started together; the
             wrapper's shared-memory count equals hist.cu's;
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
4. k2      — the partition kernel against its plain version (root, mid,
             ragged, all-left and all-right windows, u16 rows, and the
             quantized path's 2-byte int8 payload rows): exact;
5. train   — the main path through the public API at the Higgs shape
             (10.5M x 28 training rows + 500k held out, 255 leaves, 255
             bins, binary): 1 warm-up + 5 timed iterations, predict,
             save/load round trip; launch counters; then k1_turns (K1 on
             the training data's bins as the main path sees it: the root
             and the ladder's windows, and the per-tree replay — the
             first tree's 255 windows back to back at their offsets and
             sides, its launches counted — both paths; with
             --parent, the parent's K1 in turns: parent, change, change,
             parent); one profiled iteration; AUC against the same
             training with the kernels' plain versions forced;
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


def profiled_ms(fn, reps, torch, by_name=None):
    """Device milliseconds per call under torch.profiler (after one
    warm-up): for every kernel and memset the ``reps`` calls launch, its
    mean device time per recorded launch times its launches per call.
    The host's enqueue is not counted. The trace may drop a few launches
    near its end; the mean per launch does not depend on them, and a
    trace missing more than a tenth of a kernel's launches is taken
    again. ``by_name``, a dict, receives each kernel's milliseconds per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [(e.count, _device_us(e, DeviceType), e.key)
               for e in prof.key_averages()]
        dev = [(c, t, k) for c, t, k in dev if t > 0]
        per_call = [max(1, round(c / reps)) for c, _, _ in dev]
        if dev and all(abs(c - n * reps) <= max(1, n * reps // 10)
                       for (c, _, _), n in zip(dev, per_call)):
            ms = {k: t / c * n / 1e3
                  for (c, t, k), n in zip(dev, per_call)}
            if by_name is not None:
                by_name.update(ms)
            return sum(ms.values())
        log(f"[profiler] incomplete device trace (attempt {attempt + 1}): "
            f"{[c for c, _, _ in dev]} launches for {reps} calls")
    raise AssertionError("torch.profiler recorded no complete device trace")


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
                                     (40, 10, 401, 2, 0, 256, 4)):
        if lib.hist_smem_bytes(F, fg, B, bb, ip, tr, st) != smem_bytes(
                F, fg, B, bb, bool(ip), tr, st):
            raise AssertionError("ops/histogram.py smem_bytes() != "
                                 "csrc/hist.cu layout()")
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
             ("wide_u16", 50_000, 40, 300, False))


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
                              100, False, -1)
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
        d = dict(shape=label, rows=S, features=F, bins=B,
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
            "bit-identical reruns")
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
        d = dict(shape=label, rows=S, features=F, bins=B, max_abs_err=0.0,
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
            "bit-identical reruns")
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

        ms, method = timed_ms(run(partition_window), reps, torch, S)
        plain_ms, _ = timed_ms(run(partition_plain), reps, torch, S)
        nbytes = 2 * S * (F * rows.element_size() + 2 * pay.element_size()
                          + 4)
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        shapes.append(dict(shape=label, rows=S, features=F,
                           payload=str(pay.dtype).replace("torch.", ""),
                           n_left=nl,
                           max_abs_err=0.0, ms=ms, method=method,
                           plain_ms=plain_ms, library_ms=None,
                           bound_ms=bound_ms, bound_by="bytes"))
        log(f"[k2] {label} S={S} n_left={nl} ms={ms:.5f} ({method}) "
            f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} exact")
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


def phase_train(torch, lgb, dev, n_train, iters, reps, parent):
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
    wins = replay_windows(r["bst"]._models[0])
    turns = phase_k1_turns(torch, dev, ds.device_bins(), wins, reps,
                           parent)
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
                ds=ds, Xv=Xv, yv=yv, turns=turns)


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


def load_parent_hist(path):
    """``ops/histogram.py`` of another copy of the port's package (the
    parent commit's, for a before/after), imported under another name;
    it builds its own ``csrc/hist.cu`` into its own ``_build/``."""
    import importlib
    import importlib.util
    name = "k1_parent_pkg"
    path = os.path.abspath(path)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".ops.histogram")


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
            new_float = name == "change" and path == "float"

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=HIGGS_ROWS,
                    help="training rows (default: the Higgs 10.5M)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed iterations after the warm-up one")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per kernel timing")
    ap.add_argument("--parent", default=None,
                    help="a copy of the parent commit's lightgbm_tpu_torch "
                         "package: time its K1 beside this one's in turns")
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
    phase_k1_ragged(torch, dev)
    k2 = phase_k2(torch, dev, args.rows, args.reps)
    parent = load_parent_hist(args.parent) if args.parent else None
    tr = phase_train(torch, lgb, dev, args.rows, args.iters, args.reps,
                     parent)
    turns = tr["turns"]
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
        return {"train": tr["counts"][key], "train_quant": trq["counts"][key]}

    print(json.dumps({"kernels": [
        entry("hist", "lightgbm_tpu_torch/csrc/hist.cu",
              "lightgbm_tpu/ops/pallas_hist.py:145", launches("hist"), k1,
              "float"),
        entry("hist_int", "lightgbm_tpu_torch/csrc/hist.cu",
              "lightgbm_tpu/ops/pallas_hist.py:196", launches("hist_int"),
              k1i, "int"),
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
