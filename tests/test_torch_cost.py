"""Cost attribution of the port (lightgbm_tpu_torch/obs/cost.py) held
against the JAX package's (lightgbm_tpu/obs/cost.py) on the CPU: the
roofline arithmetic, the device peaks and their env overrides, the drain
contract (the 1024-event cap, no append lost under a concurrent drain),
the compile record key for key, and the ``stats`` cost section both
packages render from one telemetry stream; then a small Higgs-shaped run
(3,000 x 28): the main path's three entries emit events within their
declared ``max_signatures``, ``LIGHTGBM_TPU_COST_ATTRIBUTION=0`` emits
none, the model text is byte-equal with attribution on and off and its
trees are the JAX package's; and K1's and K2's analytic model at a few
shapes is the formula ``chip_smoke.py``'s kernels line bounds them by.
"""

import itertools
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.obs import cost as jcost
from lightgbm_tpu.obs import recorder as jrec
from lightgbm_tpu_torch.obs import cost as tcost
from lightgbm_tpu_torch.obs import recorder as trec
from lightgbm_tpu_torch.obs.jit_tracker import jit_declarations
from lightgbm_tpu_torch.ops.histogram import window_hist
from lightgbm_tpu_torch.ops.partition import partition_window

CPU = {"device_type": "cpu", "verbosity": -1}
PEAKS = {"LIGHTGBM_TPU_PEAK_TFLOPS": "67", "LIGHTGBM_TPU_PEAK_GBPS": "3350"}
MAIN_PATH = ("ops/grow_tree", "ops/pallas_hist", "ops/partition")


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled when it ends, so that
    they do not count against the process-wide jit signature budgets
    that later tests on the same worker check."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No pending events, no seen signatures, peaks resolved anew."""
    for k in ("LIGHTGBM_TPU_COST_ATTRIBUTION", "LIGHTGBM_TPU_PEAK_TFLOPS",
              "LIGHTGBM_TPU_PEAK_GBPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jcost, "_peaks", None)
    monkeypatch.setattr(tcost, "_peaks", None)
    jcost.drain_compile_events()
    tcost.drain_compile_events()
    tcost.clear_signatures()
    yield
    jcost.drain_compile_events()
    tcost.drain_compile_events()


def _higgs(n=3000, F=28, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F).astype(np.float32)
    y = ((X[:, :4] @ rs.randn(4) + 0.5 * rs.randn(n)) > 0).astype(
        np.float64)
    return X, y


PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 20}


def _port_train(X, y, rounds=3, **kw):
    return tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(
        X, label=y, params={"max_bin": 63, **CPU}), rounds, **kw)


@pytest.fixture(scope="module")
def attributed(tmp_path_factory):
    """The small Higgs-shaped run with attribution on (the default) and
    the H100's peaks set by env, into a telemetry file: the booster, the
    file, its compile events and the signatures seen."""
    path = str(tmp_path_factory.mktemp("cost") / "t.jsonl")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PEAKS.items():
            mp.setenv(k, v)
        mp.delenv("LIGHTGBM_TPU_COST_ATTRIBUTION", raising=False)
        mp.setattr(tcost, "_peaks", None)
        tcost.drain_compile_events()
        tcost.clear_signatures()
        bst = _port_train(*_higgs(), callbacks=[tlgb.telemetry(path)])
        counts = tcost.signature_counts()
    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    return dict(bst=bst, path=path, counts=counts, events=[
        e for e in events if e["event"] == "compile"],
        kinds={e["event"] for e in events})


# ---- the arithmetic ----------------------------------------------------

def test_roofline_optimal_ms_is_the_jax_packages():
    grid = [None, 0.0, 1.0, 3.5e9, 2.5e12]
    for f, b, pf, pb in itertools.product(grid, repeat=4):
        assert tcost.roofline_optimal_ms(f, b, pf, pb) \
            == jcost.roofline_optimal_ms(f, b, pf, pb), (f, b, pf, pb)


@pytest.mark.parametrize("env", [{}, {"LIGHTGBM_TPU_PEAK_TFLOPS": "67"},
                                 {"LIGHTGBM_TPU_PEAK_GBPS": "3350"}, PEAKS,
                                 {"LIGHTGBM_TPU_PEAK_TFLOPS": "x"}])
def test_peak_env_overrides_behave_like_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tcost.device_peaks() == jcost.device_peaks()


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (67e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (51e12, 2.0e12)),
    ("NVIDIA H100 NVL", (60e12, 3.9e12)),
    ("NVIDIA A100-SXM4-80GB", (None, None))])
def test_device_peaks_of_the_h100_parts(monkeypatch, name, peaks):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    assert tcost.device_peaks() == (name, *peaks)


@pytest.mark.parametrize("S,F,bb,pay,B", [(10_500_000, 28, 1, "f32", 255),
                                          (100_003, 9, 2, "int8", 300),
                                          (7, 3, 1, "f32", 4)])
def test_kernel_models_are_the_bound_formulas(S, F, bb, pay, B):
    pb = {"f32": 8, "int8": 2}[pay]
    assert tcost.k1_work(S, F, bb, pb, B) == (
        S * F * 2, S * F * bb + S * pb + F * B * 2 * 4)
    assert tcost.k2_work(S, F, bb, pb) == (0, 2 * S * (F * bb + pb + 4))
    ms, by = tcost.k1_bound(S, F, bb, pb, B, tcost.H100_FP32_OPS_PER_S)
    nbytes = S * F * bb + S * pb + F * B * 8
    assert ms == 1e3 * max(nbytes / 3.35e12, S * F * 2 / 67e12)
    assert by == ("bytes" if nbytes / 3.35e12 >= S * F * 2 / 67e12
                  else "operations")
    assert tcost.k2_bound(S, F, bb, pb) \
        == 1e3 * 2 * S * (F * bb + pb + 4) / 3.35e12


@pytest.mark.parametrize("bdtype,pdtype,side", [
    (torch.uint8, torch.float32, 0), (torch.uint8, torch.int8, 1),
    (torch.uint16, torch.float32, 2)])
def test_the_kernels_events_carry_their_model(monkeypatch, bdtype, pdtype,
                                              side):
    """K1's and K2's events on a window: bytes and operations of the
    window's rows (a side window's from its left count), the optimal ms
    at the H100 peaks K1's and K2's bounds use."""
    for k, v in PEAKS.items():
        monkeypatch.setenv(k, v)
    g = torch.Generator().manual_seed(3)
    n, F, B, start, cnt = 500, 5, 40, 37, 300
    bins = torch.randint(0, B, (n, F), generator=g).to(bdtype)
    pay = torch.randn(n, 2, generator=g)
    if pdtype == torch.int8:
        pay = (pay * 20).round().clamp(-127, 127).to(torch.int8)
    n_left = torch.tensor([123], dtype=torch.int32)
    window_hist(bins, pay, B, start, cnt, n_left=n_left, side=side)
    rows = {0: cnt, 1: 123, 2: cnt - 123}[side]
    pb, bb = 2 * pay.element_size(), bins.element_size()
    ids = torch.arange(n, dtype=torch.int32)
    partition_window(bins, bins.clone(), pay, pay.clone(), ids, ids.clone(),
                     start, cnt, 2, 0, B // 2, -1, True)
    ev = {e["entry"]: e for e in tcost.drain_compile_events()}
    k1, k2 = ev["ops/pallas_hist"], ev["ops/partition"]
    ops, nbytes = tcost.k1_work(rows, F, bb, pb, B)
    assert (k1["flops"], k1["bytes_accessed"]) == (ops, nbytes)
    rate = tcost.H100_INT32_OPS_PER_S if pdtype == torch.int8 \
        else tcost.H100_FP32_OPS_PER_S
    assert k1["optimal_ms"] == pytest.approx(
        tcost.k1_bound(rows, F, bb, pb, B, rate)[0], rel=1e-12)
    assert k2["flops"] is None
    assert k2["bytes_accessed"] == 2 * cnt * (F * bb + pb + 4)
    assert k2["optimal_ms"] == pytest.approx(
        tcost.k2_bound(cnt, F, bb, pb), rel=1e-12)


# ---- the drain contract ------------------------------------------------

def _port_event(i):
    tcost._enqueue(f"e{i}", "sig", None, None, 1.0, None, "cpu", None,
                   None)


def test_drain_keeps_the_jax_cap():
    not_jitted = object()   # no cost model: the record still counts
    for i in range(1100):
        jcost._capture(f"e{i}", not_jitted, (), {}, 1.0, 1)
        _port_event(i)
    got_j, got_t = jcost.drain_compile_events(), tcost.drain_compile_events()
    assert len(got_t) == len(got_j) == 1024
    assert [e["entry"] for e in got_t] == [e["entry"] for e in got_j]
    assert tcost.drain_compile_events() == []


def test_no_append_is_lost_under_a_concurrent_drain():
    threads, per = 4, 200   # below the cap: nothing may be dropped
    drained = []
    stop = threading.Event()

    def drainer():
        while not stop.is_set():
            drained.extend(tcost.drain_compile_events())

    d = threading.Thread(target=drainer)
    d.start()
    workers = [threading.Thread(target=lambda k=k: [
        _port_event(k * per + i) for i in range(per)])
        for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    d.join()
    drained.extend(tcost.drain_compile_events())
    assert sorted(e["entry"] for e in drained) \
        == sorted(f"e{i}" for i in range(threads * per))


def test_the_compile_record_is_the_jax_packages_key_for_key(attributed):
    jcost._capture("x", jax.jit(lambda v: v + 1), (jnp.ones(2),), {}, 1.0,
                   1)
    (ref,) = jcost.drain_compile_events()
    assert attributed["events"]
    assert all(list(e) == list(ref) for e in attributed["events"])


def test_stats_cost_section_is_the_jax_packages(attributed):
    assert {"compile", "iteration"} <= attributed["kinds"]

    def section(rec):
        table = rec.render_stats_table(rec.summarize_events(
            attributed["path"]))
        return table[table.index("xla cost attribution"):]

    port, ref = section(trec), section(jrec)
    assert port == ref
    assert "ops/grow_tree" in port and "%" in port


# ---- the main path -----------------------------------------------------

def test_a_small_higgs_run_is_attributed(attributed, monkeypatch):
    declared = jit_declarations()
    by = {}
    for e in attributed["events"]:
        by[e["entry"]] = by.get(e["entry"], 0) + 1
        assert e["bytes_accessed"] and e["optimal_ms"], e
    for name in MAIN_PATH:
        assert 1 <= by.get(name, 0) == attributed["counts"][name] \
            <= declared[name], name
    monkeypatch.setenv("LIGHTGBM_TPU_COST_ATTRIBUTION", "0")
    X, y = _higgs()
    off = _port_train(X, y)
    assert tcost.drain_compile_events() == []
    on = attributed["bst"]
    assert on.model_to_string() == off.model_to_string()
    ja = jlgb.train({**PARAMS, "hist_method": "scatter", "verbosity": -1},
                    jlgb.Dataset(X, label=y, params={"max_bin": 63}), 3)
    assert len(ja._models) == len(on._models)
    for a, b in zip(ja._models, on._models):
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


def test_the_daemon_drains_compile_events(attributed, tmp_path):
    """The serving daemon's ``{"event": "serve"}`` line comes after the
    compile events drained since the last one: the warmup's buckets, one
    ``serve/predict`` signature each."""
    from lightgbm_tpu_torch.serve import batcher, compile as scompile
    from lightgbm_tpu_torch.serve import daemon
    cf = scompile.compile_forest(attributed["bst"], max_batch_rows=64)
    assert cf.warmup(64) == 3          # the 16-, 32- and 64-row buckets
    mb = batcher.MicroBatcher(cf, batch_window_ms=0.5, max_batch_rows=64)
    path = str(tmp_path / "serve.jsonl")
    state = daemon.ServeState(mb, cf.model_id, "m", telemetry_path=path)
    try:
        state.emit_serve_event()
    finally:
        state.close()
    with open(path) as fh:
        lines = [json.loads(line) for line in fh]
    # each bucket's walk, and the raw walk it calls (an entry of its own)
    assert [e["event"] for e in lines] == ["compile"] * 6 + ["serve"]
    assert sorted(e["entry"] for e in lines[:6]) \
        == ["prediction/forest_leaves"] * 3 + ["serve/predict"] * 3
    assert tcost.drain_compile_events() == []
