"""The port's world plumbing beside the JAX package's: machine lists,
``init_distributed``'s retry, the collective watchdog, host collectives
over a store, the dataset protocol's named errors, the fault kinds, the
payload models and the parallel-mode chooser; the quantized histogram
primitives in a world of two processes; the chaos runs (``stall_rank``
and ``launch 2`` under ``rank_kill`` + ``init_refuse``); and the repaired
``cv``, whose construct now runs where its params say.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from _torch_world import REPO_DIR, TESTS_DIR, free_port, worker_env
from lightgbm_tpu.parallel import comms as jcomms
from lightgbm_tpu.parallel import distributed as jdist
from lightgbm_tpu.resilience import watchdog as jwatch
from lightgbm_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from lightgbm_tpu_torch.basic import LightGBMError
from lightgbm_tpu_torch.parallel import comms, distributed, hostsync, spmd
from lightgbm_tpu_torch.parallel import mesh, placement
from lightgbm_tpu_torch.resilience import faults, watchdog
from lightgbm_tpu_torch.resilience.faults import FaultPlan

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _drain_port_faults():
    yield
    faults.drain_events(faults.FAULT_EVENTS)
    watchdog.configure(None)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


# ---- machine lists and init_distributed --------------------------------

@pytest.mark.parametrize("spec", [
    "10.0.0.1:12400,10.0.0.2:12401", " a:1 ,, b:2\n c:3 ", "hostA",
    "h1 7,h2 8"])
def test_parse_machines_strings_like_jax(spec):
    assert distributed.parse_machines(spec) == jdist.parse_machines(spec)


def test_parse_machines_files_and_errors_like_jax(tmp_path):
    f = tmp_path / "mlist.txt"
    f.write_text("hostA 500\nhostB:600\n\n")
    assert distributed.parse_machines(machine_list_file=str(f)) \
        == jdist.parse_machines(machine_list_file=str(f)) \
        == [("hostA", 500), ("hostB", 600)]
    for bad in ("a:b", "a:1:2"):
        with pytest.raises(ValueError):
            jdist.parse_machines(bad)
        with pytest.raises(ValueError):
            distributed.parse_machines(bad)


def test_one_machine_and_no_world_join_nothing(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_COORDINATOR", raising=False)
    distributed.init_distributed(machines="localhost:12400",
                                 device_type="cpu")
    distributed.init_distributed(device_type="cpu")
    assert not torch.distributed.is_initialized()
    assert mesh.make_mesh().size == 1
    monkeypatch.delenv("LIGHTGBM_TPU_RANK", raising=False)
    with pytest.raises(ValueError, match="local_rank"):
        distributed.init_distributed(machines="a:1,b:2", device_type="cpu")
    monkeypatch.setenv("LIGHTGBM_TPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="all three"):
        distributed.init_distributed(device_type="cpu")


def test_backend_rule():
    assert distributed.choose_backend("cpu", 4, 0) == "gloo"
    assert distributed.choose_backend("cuda", 2, 2) == "nccl"
    assert distributed.choose_backend("cuda", 4, 8) == "nccl"
    # ranks that share a card: NCCL refuses two ranks on one device
    assert distributed.choose_backend("cuda", 2, 1) == "gloo"
    # the ranks of a host decide: four hosts of one card and one rank each
    hosts = [h for h, _ in distributed.parse_machines("a:1,b:1,c:1,d:1")]
    local, index = distributed.local_layout(hosts, 2, 4)
    assert (local, index) == (1, 0)
    assert distributed.choose_backend("cuda", local, 1) == "nccl"
    # two hosts of two ranks: the second rank of host b is its index 1
    hosts = [h for h, _ in distributed.parse_machines("a:1,a:2,b:1,b:2")]
    assert distributed.local_layout(hosts, 3, 4) == (2, 1)
    # no machine list (launch N, an explicit coordinator): one host
    assert distributed.local_layout(None, 3, 4) == (4, 3)


def _init_one(monkeypatch, spec, retries="10"):
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", spec)
    monkeypatch.setenv("LIGHTGBM_TPU_INIT_BACKOFF", "0.01")
    monkeypatch.setenv("LIGHTGBM_TPU_INIT_RETRIES", retries)
    distributed.init_distributed(coordinator_address=f"127.0.0.1:"
                                 f"{free_port()}", num_processes=1,
                                 process_id=0, device_type="cpu")


def test_init_retry_absorbs_injected_refusals(monkeypatch):
    from lightgbm_tpu_torch.obs.registry import registry
    before = registry.counter("init_retries").value
    try:
        _init_one(monkeypatch, "init_refuse@2")
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert distributed.init_seconds() is not None
    finally:
        distributed.shutdown_distributed()
    assert registry.counter("init_retries").value - before == 2
    assert not torch.distributed.is_initialized()


def test_init_retries_exhausted_and_other_errors_raise(monkeypatch):
    with pytest.raises(LightGBMError, match="still unreachable after 3"):
        _init_one(monkeypatch, "init_refuse@99", retries="2")

    def boom(*a, **k):
        raise RuntimeError("not a network error")
    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="not a network"):
        _init_one(monkeypatch, "")
    assert not torch.distributed.is_initialized()


def test_num_devices_is_the_worlds_size():
    """A rank is one process on one device: num_devices is 0 or the
    world's size (ROADMAP.md Queue 3)."""
    assert mesh.make_mesh(1).size == 1
    X = np.random.RandomState(0).randn(200, 3)
    y = (X[:, 0] > 0) * 1.0
    with pytest.raises(ValueError, match="launch 2"):
        tlgb.train({"objective": "binary", "num_devices": 2, **CPU},
                   tlgb.Dataset(X, label=y, params=CPU), 1)
    b = tlgb.train({"objective": "binary", "tree_learner": "data",
                    "verbosity": -1, **CPU},
                   tlgb.Dataset(X, label=y, params=CPU), 2)
    s = tlgb.train({"objective": "binary", "verbosity": -1, **CPU},
                   tlgb.Dataset(X, label=y, params=CPU), 2)
    # a world of one trains as serial
    assert b.model_to_string().split("parameters:")[0] \
        == s.model_to_string().split("parameters:")[0]


def test_shard_rows_lay_out_as_the_jax_mesh():
    m = mesh.Mesh(rank=0, size=4, device=torch.device("cpu"),
                  backend="gloo")
    bounds = [mesh.shard_rows(m, 10, r) for r in range(4)]
    assert bounds == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert mesh.pad_rows(10, 4) == 2
    plan = placement.ShardPlan(m, 10)
    assert plan.counts == [3, 3, 3, 1]
    rows = np.arange(20).reshape(10, 2)
    assert placement.place_rows(m, rows).tolist() == rows[:3].tolist()
    with pytest.raises(ValueError, match="needs global rows"):
        plan.place(rows[5:], local_offset=5)
    fps = placement.shard_fingerprints(np.arange(10.0)[None], plan.bounds)
    assert [f["index"] for f in fps] == ["rows[0:3]", "rows[3:6]",
                                         "rows[6:9]", "rows[9:10]"]
    assert placement.shard_fingerprints(rows.T, [[0, 10]]) is None
    assert placement.shard_residency("auto", 2, "cuda") == "device"
    assert placement.shard_residency("auto", 2, "cpu") == "host"
    assert placement.shard_residency("auto", 1, "cuda") == "host"


# ---- the watchdog ------------------------------------------------------

def test_watchdog_passthrough_and_heartbeat():
    for wd in (watchdog, jwatch):
        assert wd.guarded("t/ok", lambda a: a + 1, 41, iteration=3,
                          world=2, deadline=5) == 42
        heard = wd.last_heard()
        assert heard["name"] == "t/ok" and heard["iteration"] == 3 \
            and heard["world"] == 2


def test_watchdog_timeout_names_the_collective():
    from lightgbm_tpu_torch.obs.registry import registry
    before = registry.counter("collective_timeouts").value
    t0 = time.monotonic()
    with pytest.raises(LightGBMError) as ei:
        watchdog.guarded("spmd/test_hang", time.sleep, 30, iteration=7,
                         world=2, deadline=0.2)
    assert time.monotonic() - t0 < 5
    msg = str(ei.value)
    assert "'spmd/test_hang' at iteration 7" in msg
    assert "watchdog deadline" in msg and "launch" in msg
    assert registry.counter("collective_timeouts").value - before == 1
    ev = faults.drain_events(faults.FAULT_EVENTS)
    assert [e["kind"] for e in ev] == ["collective_timeout"]


def test_watchdog_wraps_transport_errors_but_not_its_own():
    def transport():
        raise ConnectionResetError("peer went away")

    def divergence():
        raise LightGBMError("SPMD divergence: ...")
    with pytest.raises(LightGBMError, match="failed .*peer went away"):
        watchdog.guarded("t/transport", transport, deadline=5)
    with pytest.raises(LightGBMError, match="^SPMD divergence"):
        watchdog.guarded("t/div", divergence, deadline=5)


def test_watchdog_deadline_resolution(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_COLLECTIVE_TIMEOUT", raising=False)
    for wd in (watchdog, jwatch):
        wd.configure(None)
        assert wd.deadline_seconds() == 300.0
        wd.configure(12.5)
        assert wd.deadline_seconds() == 12.5
        monkeypatch.setenv("LIGHTGBM_TPU_COLLECTIVE_TIMEOUT", "3")
        assert wd.deadline_seconds() == 3.0
        monkeypatch.delenv("LIGHTGBM_TPU_COLLECTIVE_TIMEOUT")
        wd.configure(None)


# ---- host collectives over a store, a thread per rank ------------------

def _ranks(size, fn):
    """Run ``fn(world)`` on ``size`` threads sharing one HashStore; the
    results (or exceptions) in rank order."""
    store = torch.distributed.HashStore()
    out = [None] * size

    def run(r):
        try:
            out[r] = fn(hostsync.HostWorld(store, r, size))
        except Exception as e:  # noqa: BLE001 — returned to the test
            out[r] = e
    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


def test_hostsync_allgather_and_broadcast():
    def fn(w):
        g = hostsync.host_allgather(np.arange(3) + 10 * w.rank, "t/gather",
                                    world=w)
        b = hostsync.host_broadcast_bytes(
            b"from rank 0" if w.rank == 0 else None, "t/bcast", world=w)
        g2 = hostsync.host_allgather(np.asarray([w.rank]), "t/again",
                                     world=w)
        return g, b, g2
    for g, b, g2 in _ranks(3, fn):
        assert g.tolist() == [[0, 1, 2], [10, 11, 12], [20, 21, 22]]
        assert b == b"from rank 0" and g2[:, 0].tolist() == [0, 1, 2]
    assert hostsync.host_allgather(np.ones(2), "t/one").shape == (1, 2)


def test_hostsync_names_a_silent_rank(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_COLLECTIVE_TIMEOUT", "1")

    def fn(w):
        if w.rank == 1:
            return "silent"
        return hostsync.host_allgather(np.zeros(1), "spmd/verify_step",
                                       iteration=4, world=w)
    t0 = time.monotonic()
    err, silent = _ranks(2, fn)
    assert silent == "silent" and time.monotonic() - t0 < 10
    assert isinstance(err, LightGBMError)
    assert "'spmd/verify_step' at iteration 4 timed out" in str(err)
    assert "rank 1 never published" in str(err)


def test_spmd_named_errors_and_step_checks():
    def rows(w):
        return spmd._check_shards(np.asarray([100 + w.rank, -1, 1, 0, 0, 0]),
                                  w)
    errs = _ranks(2, rows)
    assert all(isinstance(e, LightGBMError) for e in errs)
    assert "rank 0: 100 rows, rank 1: 101 rows" in str(errs[0])

    def meta(w):
        return spmd._check_shards(np.asarray([100, -1, 1, w.rank, 0, 0]), w)
    errs = _ranks(2, meta)
    assert "ranks [1] carry 'weight' but ranks [0] do not" in str(errs[0])

    def step(w):
        spmd.verify_step_consistency(3, 3 + w.rank, world=w)
    errs = _ranks(2, step)
    assert "rank 0: iteration=3, trees=3; rank 1: iteration=3, trees=4" \
        in str(errs[0])

    from lightgbm_tpu_torch.ops.binning import BinMapper

    def mappers(w):
        mine = [BinMapper.from_dict({"upper_bounds": [0.5 + w.rank, 1e300],
                                     "num_bins": 2, "bin_type": 0,
                                     "missing_type": 0, "default_bin": 0,
                                     "min_val": 0.0, "max_val": 1.0})]
        return spmd.sync_bin_mappers(mine, world=w)
    got = _ranks(2, mappers)
    assert [m.to_dict() for m in got[1]] == [m.to_dict() for m in got[0]]
    assert got[1][0].upper_bounds[0] == 0.5


def test_phase_skew_is_one_gather():
    snap = {"a": {"total": 1.0, "count": 2}, "b": {"total": 0.0,
                                                   "count": 0}}

    def fn(w):
        s = {k: dict(v, total=v["total"] * (w.rank + 1))
             for k, v in snap.items()}
        return spmd.aggregate_phase_snapshot(s, world=w)
    agg = _ranks(2, fn)[0]
    assert agg["a"] == {"min": 1.0, "max": 2.0, "mean": 1.5, "count": 2}


# ---- fault kinds -------------------------------------------------------

def test_distributed_fault_kinds_parse_like_jax(monkeypatch):
    spec = "rank_kill@3,stall_rank@5,init_refuse@2,nan_grad@1"
    mine, ref = FaultPlan(spec), JaxFaultPlan(spec)
    for kind in ("rank_kill", "stall_rank", "init_refuse", "nan_grad"):
        assert mine.iters(kind) == ref.iters(kind)
    p = FaultPlan("init_refuse@2")
    for _ in range(2):
        with pytest.raises(faults.InjectedInitRefused,
                           match="connection refused"):
            p.maybe_refuse_init()
    p.maybe_refuse_init()   # the budget is spent
    assert [e["kind"] for e in faults.drain_events(faults.FAULT_EVENTS)] \
        == ["init_refuse", "init_refuse"]


def test_fault_rank_gating_reads_the_world(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_RANK", "1")
    assert not FaultPlan._rank_selected()
    monkeypatch.setattr(mesh, "world_rank", lambda: 1)
    assert FaultPlan._rank_selected()
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_RANK", "0,2")
    assert not FaultPlan._rank_selected()


# ---- the payload models and the chooser --------------------------------

@pytest.mark.parametrize("mode", ["data", "voting", "feature"])
@pytest.mark.parametrize("F,B,k", [(28, 255, 20), (64, 16, 3),
                                   (4228, 255, 20), (5, 63, 1)])
@pytest.mark.parametrize("wire", ["f32", "int16", "int8"])
def test_payload_models_equal_jax(mode, F, B, k, wire):
    assert comms.payload_elems(mode, F, B, k) \
        == jcomms.payload_elems(mode, F, B, k)
    assert comms.payload_bytes(mode, F, B, wire, k) \
        == jcomms.payload_bytes(mode, F, B, wire, k)
    for D in (1, 2, 4, 8):
        for ss in ("gathered", "sharded"):
            assert comms.post_reduction_bytes(mode, F, B, D, ss, wire, k) \
                == jcomms.post_reduction_bytes(mode, F, B, D, ss, wire, k)
            assert comms.post_reduction_elems(mode, F, B, D, ss, k) \
                == jcomms.post_reduction_elems(mode, F, B, D, ss, k)
    assert comms.resolve_hist_comm("auto", F, B, mode, k) \
        == jcomms.resolve_hist_comm("auto", F, B, mode, k)


def test_choose_parallel_mode_table_equals_jax():
    for F in (8, 28, 40, 41, 500, 4228):
        for B in (16, 63, 255):
            for rows in (1000, 1 << 16, (1 << 16) + 1, 10_500_000):
                for world in (1, 2, 4, 8):
                    for wire in ("f32", "int16", "int8", "auto"):
                        assert comms.choose_parallel_mode(
                            F, B, rows, world, wire) \
                            == jcomms.choose_parallel_mode(
                                F, B, rows, world, wire)


def test_collective_ledger_in_a_world_of_one():
    c = comms.Comm(mesh.make_mesh())
    x = torch.randn(3, 5, 2)
    recs = comms.collective_payloads(
        c, lambda: comms.hist_allreduce(c, x, "int8"))
    assert recs == []       # a world of one sends nothing
    assert comms.hist_allreduce(c, x, "int8") is x
    qm, use_ef, fn = comms.make_hist_psum_ef(c, "int8")
    assert (qm, use_ef) == ("f32", False) and fn(x, None)[0] is x
    assert comms.collective_summary([]) == {
        "n_collectives": 0, "prims": [], "wire_bytes": 0}


@pytest.mark.parametrize("key,val", [
    ("tree_learner", "mesh"), ("hist_comm", "int4"),
    ("split_search", "scattered"), ("shard_residency", "disk")])
def test_config_refuses_like_jax(key, val):
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu_torch.config import Config
    with pytest.raises(ValueError) as je:
        JaxConfig.from_params({key: val})
    with pytest.raises(ValueError) as pe:
        Config.from_params({key: val})
    assert str(pe.value) == str(je.value)


# ---- the quantized histogram primitives in a world of two --------------

_PRIM = r"""
import json, sys, numpy as np, torch
from lightgbm_tpu_torch.parallel import comms, distributed, mesh
distributed.init_distributed(device_type="cpu")
c = comms.Comm(mesh.make_mesh())
r = c.rank
rs = np.random.RandomState(r)
F, B, out = 9, 31, {}
for mode in ("int16", "int8"):
    for strat in ("psum", "exchange"):
        x = torch.tensor(rs.randn(F, B, 2).astype(np.float32) * 5)
        tot = c.all_reduce(x.clone())
        y = comms.hist_allreduce(c, x, mode, strategy=strat)
        out[f"{mode}_{strat}"] = [float((y - tot).abs().max()
                                        / tot.abs().max()),
                                  y.numpy().tobytes().hex()]
    ef = torch.zeros(F, B, 2)
    acc = torch.zeros(F, B, 2)
    acc_true = torch.zeros(F, B, 2)
    for k in range(12):
        x = torch.tensor(rs.randn(F, B, 2).astype(np.float32))
        acc_true += c.all_reduce(x.clone())
        y, ef = comms.hist_allreduce(c, x, mode, ef, strategy="exchange")
        acc += y
    out[f"{mode}_ef"] = [float((acc - acc_true).abs().max()),
                         float(acc_true.abs().max())]
    x = torch.tensor(rs.randn(2 * F, B, 2).astype(np.float32))
    ch = comms.hist_reduce_scatter(c, x, mode)
    mine = c.all_reduce(x.clone())[r * F:(r + 1) * F]
    out[f"{mode}_rs"] = float((ch - mine).abs().max() / mine.abs().max())
x = torch.tensor(rs.randn(2 * F, B, 2).astype(np.float32))
ch = comms.hist_reduce_scatter(c, x, "f32")
out["f32_rs_bitwise"] = bool((ch == c.all_reduce(x.clone())[r * F:(r + 1)
                                                            * F]).all())
q = torch.randint(-100, 100, (F, B, 2), dtype=torch.int32)
out["int_exact"] = bool((comms.hist_allreduce(c, q, "int8")
                         == c.all_reduce(q.clone())).all())
recs = comms.collective_payloads(
    c, lambda: comms.hist_allreduce(c, torch.randn(F, B, 2), "int8",
                                    strategy="exchange"))
out["exchange_wire"] = [[rec["prim"], rec["itemsize"]] for rec in recs]
# the JAX oracle's inputs and this rank's outputs: an error-feedback
# chain of the default (exchange) wire on an unaligned histogram, and a
# quantized reduce-scatter
chain = {}
for mode in ("int16", "int8"):
    ef = torch.zeros(F, B, 2)
    for k in range(4):
        x = torch.tensor(rs.randn(F, B, 2).astype(np.float32) * 3)
        y, ef = comms.hist_allreduce(c, x, mode, ef)
        chain[f"{mode}_x{k}"], chain[f"{mode}_y{k}"] = x.numpy(), y.numpy()
        chain[f"{mode}_ef{k}"] = ef.numpy()
    x = torch.tensor(rs.randn(2 * F, B, 2).astype(np.float32))
    ch, ef = comms.hist_reduce_scatter(c, x, mode, torch.zeros_like(x))
    chain[f"{mode}_rsx"], chain[f"{mode}_rsy"] = x.numpy(), ch.numpy()
    chain[f"{mode}_rsef"] = ef.numpy()
np.savez(sys.argv[1] + f"/chain{r}.npz", **chain)
json.dump(out, open(sys.argv[1] + f"/prim{r}.json", "w"))
"""


def test_quantized_primitives_in_a_world_of_two(tmp_path):
    """``tests/test_comms.py``'s and ``tests/test_sharding.py``'s
    standards: rank-identical results within 2e-4 (int16) / 2e-2 (int8)
    of the f32 sum, the error feedback's accumulated error bounded by
    one round's quantization, the f32 reduce-scatter chunk equal bit for
    bit to the allreduce's slice, integer histograms exact, and an
    exchange whose wire really is int8."""
    script = tmp_path / "prim.py"
    script.write_text(_PRIM)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path)], env=worker_env({
            "LIGHTGBM_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "LIGHTGBM_TPU_NUM_PROCS": "2", "LIGHTGBM_TPU_RANK": str(r)}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    for p in procs:
        out = p.communicate(timeout=120)[0]
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    a, b = (json.loads((tmp_path / f"prim{r}.json").read_text())
            for r in (0, 1))
    for mode, tol in (("int16", 2e-4), ("int8", 2e-2)):
        for strat in ("psum", "exchange"):
            err, bits = a[f"{mode}_{strat}"]
            assert bits == b[f"{mode}_{strat}"][1], "ranks diverged"
            assert err < tol
        acc_err, scale = a[f"{mode}_ef"]
        assert acc_err < 2 * scale / {"int16": 32767, "int8": 127}[mode] * 2
        assert a[f"{mode}_rs"] < tol
    assert a["f32_rs_bitwise"] and b["f32_rs_bitwise"]
    assert a["int_exact"] and b["int_exact"]
    assert a["exchange_wire"] == [["all_to_all", 1], ["all_gather", 1]]
    _exchange_equals_jax(tmp_path)


def _exchange_equals_jax(tmp_path):
    """The wire a world runs by default (the exchange, with its error
    feedback) and the quantized reduce-scatter give what the JAX
    package's give on a mesh of two devices with the same inputs: the
    reduced histogram and each rank's residual, bit for bit but where
    XLA's CPU compiler fuses the dequantized sum's multiply and add into
    one FMA (the port rounds twice, as numpy does): there the owner's
    requantization may land one step of the wire away (2 of 1,116 values
    in int16's first round on this fixture)."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:  # pragma: no cover - jax>=0.8
        from jax import shard_map
    ch = [np.load(tmp_path / f"chain{r}.npz") for r in (0, 1)]
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))

    def per_rank(fn, *arrays):
        sh = shard_map(lambda *a: tuple(o[None] for o in fn(*(
            v[0] for v in a))), mesh=mesh, in_specs=tuple(
            P("d") for _ in arrays), out_specs=(P("d"), P("d")),
            check_rep=False)
        return [np.asarray(o) for o in jax.jit(sh)(*arrays)]

    def same(got, want, top, qmax):
        # equal to the last bits of values as large as ``top`` (the
        # residual's ``x - q * scale`` is one FMA in XLA), and a rare
        # value one step of the wire away
        diff = np.abs(got - want)
        assert (diff > 4 * np.finfo(np.float32).eps * top).mean() < 0.01
        assert diff.max() <= top / qmax * 1.01

    both = lambda key: np.stack([c[key] for c in ch])  # noqa: E731
    for mode in ("int16", "int8"):
        qmax = jcomms.QMAX[mode]
        ef = np.zeros_like(both(f"{mode}_x0"))
        for k in range(4):
            y, ef = per_rank(lambda x, e: jcomms.hist_allreduce(
                x, "d", mode, e, strategy="exchange"),
                both(f"{mode}_x{k}"), ef)
            top = np.abs(y).max()
            same(both(f"{mode}_y{k}"), y, top, qmax)
            same(both(f"{mode}_ef{k}"), ef, top, qmax)
            ef = both(f"{mode}_ef{k}")    # the next round from the port's
        x = both(f"{mode}_rsx")
        y, ef = per_rank(lambda x, e: jcomms.hist_reduce_scatter(
            x, "d", mode, e), x, np.zeros_like(x))
        top = np.abs(y).max()
        same(both(f"{mode}_rsy"), y, top, qmax)
        same(both(f"{mode}_rsef"), ef, top, qmax)


# ---- the OOM ladder in a world -----------------------------------------

_OOM = r"""
import json, os, sys, numpy as np, torch
from lightgbm_tpu_torch.parallel import distributed, mesh
distributed.init_distributed(device_type="cpu")
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops import grow
r = mesh.world_rank()
rs = np.random.RandomState(3)
X = rs.randn(2000, 6)
y = ((X[:, 0] + 0.5 * rs.randn(2000)) > 0).astype(float)
p = {"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 5,
     "verbosity": -1, "tree_learner": "data", "device_type": "cpu"}
ds = lambda: lgb.Dataset(X, label=y, params={"device_type": "cpu"})
out = {"clean": lgb.train(p, ds(), 3).model_to_string()}
# an injected OOM on rank 1 alone
if r == 1:
    os.environ["LIGHTGBM_TPU_FAULT_INJECT"] = "oom@1"
b = lgb.train(p, ds(), 3)
os.environ.pop("LIGHTGBM_TPU_FAULT_INJECT", None)
out["oom"] = b.model_to_string()
out["slots"] = b._engine.grower.cfg.pool_slots
out["events"] = [[e["kind"], e["iteration"], e["action"]]
                 for e in b._engine.fault_log]
# a real OOM inside rank 1's second grow: rank 1 raises, rank 0 is left
# in the tree's first collective and fails once rank 1 has gone
if r == 1:
    real = grow.Grower.grow
    calls = []
    def failing(self, *a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB")
        return real(self, *a, **k)
    grow.Grower.grow = failing
try:
    lgb.train(p, ds(), 3)
    out["real"] = "trained"
except Exception as e:
    out["real"] = f"{type(e).__name__}: {e}"
json.dump(out, open(sys.argv[1] + f"/oom{r}.json", "w"))
sys.stdout.flush()
os._exit(0)
"""


def test_oom_in_a_world_degrades_every_rank_or_raises(tmp_path):
    """``oom@1`` on rank 1 alone: both ranks take the rung (one flag
    ``all_reduce`` before each grow), so their pools and collectives stay
    in step and the model is the clean run's on both. A real OOM inside
    rank 1's grow raises ``LightGBMError`` there, naming why it cannot
    retry, and rank 0 fails instead of hanging."""
    script = tmp_path / "oom.py"
    script.write_text(_OOM)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path)], env=worker_env({
            "LIGHTGBM_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "LIGHTGBM_TPU_NUM_PROCS": "2", "LIGHTGBM_TPU_RANK": str(r)}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    for p in procs:
        out = p.communicate(timeout=120)[0]
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    a, b = (json.loads((tmp_path / f"oom{r}.json").read_text())
            for r in (0, 1))
    assert a["oom"] == b["oom"] == a["clean"] == b["clean"]
    assert a["slots"] == b["slots"] == 4
    assert a["events"] == b["events"] == [
        ["oom", 1, "histogram pool -> 4 slots"]]
    assert b["real"].startswith("LightGBMError: device RESOURCE_EXHAUSTED "
                                "in grow at iteration 1 on rank 1 of a "
                                "world of 2")
    assert "cannot retry alone" in b["real"]
    assert a["real"] != "trained"


# ---- chaos -------------------------------------------------------------

def _chaos_env(tmp, extra):
    # a deadline that a loaded test machine's ranks keep in step within,
    # short enough for the aborts to come soon
    return worker_env({"LIGHTGBM_TPU_CHECKPOINT": str(tmp / "ckpts"),
                       "LIGHTGBM_TPU_COLLECTIVE_TIMEOUT": "10",
                       "LIGHTGBM_TPU_INIT_BACKOFF": "0.05", **extra})


def _launch(tmp, fault, restarts, **env):
    tmp.mkdir()
    return subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "launch", "2",
         "--max-restarts", str(restarts), "--log-dir", str(tmp),
         "--grace", "15", "--",
         sys.executable, os.path.join(TESTS_DIR, "torch_elastic_worker.py"),
         str(tmp)],
        env=_chaos_env(tmp, {"LIGHTGBM_TPU_FAULT_INJECT": fault,
                             "LIGHTGBM_TPU_FAULT_RANK": "1", **env}),
        cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def test_stall_rank_aborts_the_survivor_and_launch_resumes(tmp_path):
    """stall_rank@2 on rank 1: the survivor raises the watchdog's error
    naming the collective and the silent rank within its deadline, and
    nothing is left running; beside it, ``launch 2`` under rank_kill@3
    and init_refuse@2 restarts the world from its checkpoints and ends
    on a model byte-equal to an uninterrupted run's."""
    sdir = tmp_path / "stall"
    sdir.mkdir()
    port = free_port()
    stall = []
    for r in (0, 1):
        stall.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS_DIR,
                                          "torch_elastic_worker.py"),
             str(sdir)], env=_chaos_env(sdir, {
                 "LIGHTGBM_TPU_COORDINATOR": f"127.0.0.1:{port}",
                 "LIGHTGBM_TPU_NUM_PROCS": "2", "LIGHTGBM_TPU_RANK": str(r),
                 "LIGHTGBM_TPU_FAULT_INJECT": "stall_rank@2",
                 "LIGHTGBM_TPU_FAULT_RANK": "1"}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True))
    clean = _launch(tmp_path / "clean", "", 0)
    faulted = _launch(tmp_path / "faulted", "rank_kill@3,init_refuse@2", 2)
    t0 = time.monotonic()
    try:
        out0 = stall[0].communicate(timeout=120)[0].decode(errors="replace")
    finally:
        elapsed = time.monotonic() - t0
        alive = stall[1].poll() is None
        import signal
        for p in stall:
            if p.poll() is None:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            p.wait(timeout=30)
    assert stall[0].returncode == 13, out0
    assert "WORKER ABORT" in out0 and "spmd/verify_step" in out0
    assert "rank 1" in out0 and alive
    assert elapsed < 60
    assert all(p.poll() is not None for p in stall)
    for proc in (clean, faulted):
        out = proc.communicate(timeout=180)[0].decode(errors="replace")
        assert proc.returncode == 0, out
    g0 = (tmp_path / "faulted" / "elastic_g0_rank0.log").read_text()
    g1 = (tmp_path / "faulted" / "elastic_g1_rank0.log").read_text()
    assert "INIT_RETRIES=2" in g0 and "WORKER ABORT" in g0
    assert "spmd/verify_step" in g0
    assert "rank 0 DONE iterations=8" in g1
    assert (tmp_path / "faulted" / "model_elastic.txt").read_bytes() \
        == (tmp_path / "clean" / "model_elastic.txt").read_bytes()


# ---- the world's snapshot and one rank's, resumed across -------------

def _tree_blocks(text):
    return text.split("\nend of trees")[0].split("\nTree=")[1:]


def _close_models(a, b, same_first):
    """The first ``same_first`` trees byte-equal, the rest equal in
    structure with leaf values within the data-parallel tolerance (a
    world's float histograms are sums of its ranks' ones)."""
    ta, tb = _tree_blocks(a), _tree_blocks(b)
    assert len(ta) == len(tb)
    assert ta[:same_first] == tb[:same_first]
    ma = tlgb.Booster(model_str=a, params=CPU)._models
    mb = tlgb.Booster(model_str=b, params=CPU)._models
    for x, z in zip(ma[same_first:], mb[same_first:]):
        assert x.num_leaves == z.num_leaves
        np.testing.assert_array_equal(x.split_feature, z.split_feature)
        np.testing.assert_allclose(x.leaf_value, z.leaf_value, rtol=2e-4,
                                   atol=2e-4)


def test_world_snapshots_resume_across_world_sizes(tmp_path):
    """A world's snapshot holds the assembled [K, n] score and one
    fingerprint per rank's rows; the JAX package's loader reads it, a
    one-process run of the same rows (rank 0's mappers) resumes from it,
    and a world of two resumes from a one-process run's snapshot."""
    d = tmp_path / "world"
    proc = _launch(d, "", 0, LIGHTGBM_TPU_TELEMETRY=str(tmp_path / "t.jsonl"))
    out = proc.communicate(timeout=180)[0].decode(errors="replace")
    assert proc.returncode == 0, out
    # rank 0 writes the world's telemetry: the phases' skew across ranks
    # and the collectives' payloads (the JAX package's keys)
    events = [json.loads(line) for line in
              (tmp_path / "t.jsonl").read_text().splitlines()]
    iters = [e for e in events if e["event"] == "iteration"]
    assert [e["iteration"] for e in iters] == list(range(8))
    for e in iters:
        assert e["comm"]["world"] == 2 and e["comm"]["sent_bytes"] > 0
        assert e["comm"]["parallel_mode"] == "data"
        grow = e["phases"]["tree_learner/grow"]
        assert grow["min"] <= grow["mean"] <= grow["max"]
    from lightgbm_tpu_torch.resilience.checkpoint import (
        checkpoint, load_latest_snapshot)
    snap = load_latest_snapshot(str(d / "ckpts"))
    assert snap["score"].shape == (1, 600)
    fps = snap["score_shard_fingerprints"]
    assert [f["index"] for f in fps] == ["rows[0:300]", "rows[300:600]"]
    from lightgbm_tpu.resilience.checkpoint import \
        load_latest_snapshot as jax_load
    assert np.array_equal(jax_load(str(d / "ckpts"))["score"],
                          snap["score"])
    rs = np.random.RandomState(7)
    X = rs.randn(600, 5)
    y = X @ rs.randn(5) + 0.05 * rs.randn(600)
    ref = tlgb.Dataset(X[:300], label=y[:300], params=CPU)
    ref.construct()
    p = {"objective": "regression", "num_leaves": 7, "min_data_in_leaf": 5,
         "tree_learner": "data", "bagging_fraction": 0.7, "bagging_freq": 2,
         "verbosity": -1, **CPU}
    world = (d / "model_elastic.txt").read_text()
    six = tmp_path / "six"
    six.mkdir()
    import shutil
    shutil.copy(d / "ckpts" / "ckpt_00000006.npz", six)
    one = tlgb.train(p, tlgb.Dataset(X, label=y, reference=ref, params=CPU),
                     8, resume_from=str(six))
    _close_models(one.model_to_string(), world, 6)
    # the other way round: a one-process run's snapshot, a world resumes
    mine = tmp_path / "mine"
    first = tlgb.train(p, tlgb.Dataset(X, label=y, reference=ref,
                                       params=CPU), 6,
                       callbacks=[checkpoint(str(mine / "ckpts"))])
    env = _chaos_env(mine, {})
    done = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "launch", "2",
         "--max-restarts", "0", "--log-dir", str(mine), "--",
         sys.executable, os.path.join(TESTS_DIR, "torch_elastic_worker.py"),
         str(mine)], env=env, cwd=REPO_DIR, capture_output=True, text=True,
        timeout=180)
    assert done.returncode == 0, done.stdout + done.stderr
    resumed = (mine / "model_elastic.txt").read_text()
    assert _tree_blocks(resumed)[:6] == _tree_blocks(
        first.model_to_string())
    _close_models(resumed, world, 0)


# ---- the surface -------------------------------------------------------

def test_network_methods_and_free_host_bins():
    X = np.random.RandomState(0).randn(300, 3)
    y = (X[:, 0] > 0) * 1.0
    ds = tlgb.Dataset(X, label=y, params=CPU)
    b = tlgb.train({"objective": "binary", "verbosity": -1, **CPU}, ds, 2)
    assert b.set_network("127.0.0.1:12400") is b     # one machine
    assert b.free_network() is b
    assert not torch.distributed.is_initialized()
    digest_before = ds._data_digest
    ds.free_host_bins()
    assert digest_before is None and ds._data_digest is not None
    # on the CPU the host copy is the device copy: it stays
    assert ds.host_bins().shape == (300, 3)


def test_cv_constructs_where_its_params_say():
    """ROADMAP.md Queue 3, repaired: ``cv`` with ``device_type`` in its
    params only (the Dataset has none) trains on this host, with the JAX
    package's per-round means and deviations
    (``tests/test_torch_valid.py``'s standard)."""
    rs = np.random.RandomState(11)
    X = rs.randn(1500, 6)
    X[rs.rand(1500, 6) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rs.randn(6) + 0.3 * rs.randn(1500)) > 0) * 1.0
    p = {"objective": "binary", "num_leaves": 8, "verbosity": -1,
         "metric": "binary_logloss"}
    want = jlgb.cv({**p, "hist_method": "scatter"},
                   jlgb.Dataset(X, label=y, params={"hist_method":
                                                    "scatter"}), 3,
                   nfold=3, seed=4)
    got = tlgb.cv({**p, **CPU}, tlgb.Dataset(X, label=y), 3, nfold=3,
                  seed=4)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
