"""The port's replica fleet (lightgbm_tpu_torch/resilience/elastic.py
``supervise_fleet`` and its helpers, resilience/autoscale.py) held
against the JAX package on the CPU.

Pure functions first, fed the same inputs in both packages: the restart
budget (its sliding window, its total cap and its backoff under a seeded
``random.Random``), ``strip_one_shot_faults``, ``worker_env`` and
``fleet_telemetry_path``, and the autoscale policy and rollback guard,
driven through the scenarios of ``tests/test_fleet.py`` (the same scrape
rows, clock and calls; the same decisions, metrics families and
last-known-good). Then the supervisor with fake replicas (small Python
JSON servers that import neither package): only the dead replica
restarts, in both packages alike, and a wedged replica fails its scrape
within the timeout while the healthy row lands in the same round. The
JAX package's full-size chaos run of an autoscaling fleet under a store
outage and a poisoned publication, through the port's ``pipeline
--device-type cpu``, is marked slow, as it is there. Each subprocess wait
has its own timeout (at most 60 s).
"""

import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from lightgbm_tpu.obs import export as jax_export
from lightgbm_tpu.resilience import autoscale as jax_autoscale
from lightgbm_tpu.resilience import elastic as jax_elastic
from lightgbm_tpu_torch.obs.export import (counter_family, gauge_family,
                                           render_openmetrics)
from lightgbm_tpu_torch.resilience import autoscale as port_autoscale
from lightgbm_tpu_torch.resilience import elastic as port_elastic

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 60.0
ELASTIC = {"jax": jax_elastic, "port": port_elastic}
AUTOSCALE = {"jax": jax_autoscale, "port": port_autoscale}


# ---- the restart budget, fault stripping, the workers' environment -----

def _budget_trace(mod, seed):
    """One fixed sequence of admissions and backoffs on a fake clock."""
    clock = [0.0]
    budget = mod.RestartBudget(max_restarts=4, max_per_window=2,
                               window_sec=60.0, _now=lambda: clock[0],
                               _rng=random.Random(seed))
    out = []
    for t in (0.0, 1.0, 2.0, 61.5, 62.0, 130.0, 200.0):
        clock[0] = t
        out.append(budget.admit())
    out.append(budget.total)
    out.extend(budget.backoff(n) for n in (1, 2, 3, 6, 20))
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_restart_budget_matches_jax(seed):
    """The window refuses the third restart inside 60 s and admits again
    once it slides; the total cap refuses the fifth; the backoff is the
    same jittered curve from the same seed."""
    mine, ref = _budget_trace(port_elastic, seed), \
        _budget_trace(jax_elastic, seed)
    assert mine == ref
    assert mine[0] is None and mine[1] is None
    assert "sliding window" in mine[2]
    assert mine[3] is None and mine[4] is None
    assert "total restart budget" in mine[6]
    assert mine[7] == 4
    for consecutive, delay in zip((1, 2, 3), mine[8:11]):
        base = 0.5 * 2 ** (consecutive - 1)
        assert 0.5 * base <= delay < 1.5 * base
    assert mine[-1] < 15.0 * 1.5


@pytest.mark.parametrize("spec", [
    "serve_kill@25,nan_grad@3,rank_kill@8",
    " rank_kill@-1 , stall_rank@4,publish_torn@1,,oom@2",
    "kill@3,refit_nan@1", ""])
def test_strip_one_shot_faults_matches_jax(spec):
    assert port_elastic.strip_one_shot_faults(spec) == \
        jax_elastic.strip_one_shot_faults(spec)


@pytest.mark.parametrize("generation", [0, 2])
def test_worker_env_matches_jax(generation):
    base = {"LIGHTGBM_TPU_FAULT_INJECT": "serve_kill@5,nan_grad@2",
            "LIGHTGBM_TPU_TELEMETRY": "/t/serve.jsonl", "OTHER": "1"}
    mine = port_elastic.worker_env(base, 1, 3, 4567, generation)
    assert mine == jax_elastic.worker_env(base, 1, 3, 4567, generation)
    assert mine["LIGHTGBM_TPU_RESTART_COUNT"] == str(generation)
    assert base["LIGHTGBM_TPU_FAULT_INJECT"] == "serve_kill@5,nan_grad@2"
    for env in (base, {}):
        assert port_elastic.fleet_telemetry_path(env) == \
            jax_elastic.fleet_telemetry_path(env)


# ---- the autoscale policy and the rollback guard ------------------------

def _rows(qps_each, n=1, p99=10.0, shed=None):
    return [{"rank": r, "alive": True, "qps": qps_each, "p99_ms": p99,
             **({} if shed is None else {"shed_total": shed})}
            for r in range(n)]


# tests/test_fleet.py's scenarios as (time, scrape rows or None, the
# replica count handed to decide)
POLICY_SCENARIOS = {
    "up_signals": (100.0, [
        (100.0, None, 1), (100.0, _rows(25.0), 1), (100.0, None, 2),
        (106.0, _rows(1.0, n=2, p99=500.0), 2),
        (112.0, _rows(1.0, n=3, shed=50), 3),
        (118.0, _rows(1.0, n=2, shed=80), 2),
        (124.0, _rows(1.0, n=2, shed=0), 2)],
        [None, "up", None, "up", None, "up", None]),
    "down_hysteresis": (0.0, [
        (0.0, _rows(20.0), 1), (10.0, _rows(1.0, n=2), 2),
        (16.0, _rows(1.0, n=2), 2), (40.0, _rows(0.0), 1),
        (60.0, _rows(4.0, n=2), 2)],
        ["up", None, "down", None, None]),
}


def _policy_trace(mod, scenario):
    t0, steps, _ = POLICY_SCENARIOS[scenario]
    clock = [t0]
    pol = mod.AutoscalePolicy(1, 3, up_qps=10.0, down_qps=5.0,
                              up_p99_ms=200.0, up_cooldown_sec=5.0,
                              down_cooldown_sec=15.0,
                              _now=lambda: clock[0])
    out = []
    for t, rows, n in steps:
        clock[0] = t
        if rows is not None:
            pol.observe(rows)
        out.append(pol.decide(n))
    return out, (pol.scale_ups, pol.scale_downs), pol.metrics_families()


@pytest.mark.parametrize("scenario", sorted(POLICY_SCENARIOS))
def test_autoscale_policy_matches_jax(scenario):
    """The same decisions (action and reason), the same counts, and the
    same families on the supervisor's /metrics."""
    decisions, counts, fams = _policy_trace(port_autoscale, scenario)
    assert [d and d[0] for d in decisions] == \
        POLICY_SCENARIOS[scenario][2]
    ref = _policy_trace(jax_autoscale, scenario)
    # the families are rendered by each package's own exporter
    assert (decisions, counts) == ref[:2]
    assert render_openmetrics({}, extra=fams) == \
        jax_export.render_openmetrics({}, extra=ref[2])


def _guard_adopt_then_condemn(guard, clock):
    out = [guard.note_publication("model_g0001.txt", "sha1"),
           guard.note_publication("model_g0001.txt", "sha1")]
    guard.observe([{"rank": 0, "sha256": "sha1", "swap_failures_total": 0}])
    out.append(guard.decide())
    clock[0] = 3.0
    out += [guard.decide(), guard.last_known_good,
            guard.note_publication("model_g0002.txt", "sha2")]
    guard.observe([{"rank": 0, "sha256": "sha1", "swap_failures_total": 2}])
    clock[0] = 4.0
    out.append(guard.decide())
    clock[0] = 9.0
    out += [guard.decide(),
            guard.note_publication("model_g0002.txt", "sha2"),
            guard.decide()]
    return out


def _guard_requires_swap_failures(guard, clock):
    out = [guard.note_publication("m.txt", "shaX")]
    guard.observe([{"rank": 0, "sha256": "old", "swap_failures_total": 0}])
    clock[0] = 60.0
    out.append(guard.decide())
    guard.observe([{"rank": 0, "sha256": "old", "swap_failures_total": 3}])
    out.append(guard.decide())
    return out


def _guard_eviction_condemns(guard, clock):
    guard.note_publication("good.txt", "g")
    guard.observe([{"rank": 0, "sha256": "g", "swap_failures_total": 0}])
    out = [guard.decide()]
    clock[0] = 3.0
    out += [guard.decide(), guard.note_publication("next.txt", "n")]
    guard.observe([{"rank": 1, "sha256": "n", "swap_failures_total": 0}])
    guard.note_eviction(1)
    out += [guard.decide(), guard.last_known_good, guard.rollbacks]
    return out


GUARD_SCENARIOS = {
    "adopt_then_condemn": (_guard_adopt_then_condemn, {
        0: True, 1: False, 4: ("model_g0001.txt", "sha1"), 6: None,
        7: {"bad_name": "model_g0002.txt", "bad_sha": "sha2",
            "good_name": "model_g0001.txt", "good_sha": "sha1"},
        8: False, 9: None}),
    "requires_swap_failures": (_guard_requires_swap_failures, {
        1: None, 2: {"bad_name": "m.txt", "bad_sha": "shaX",
                     "good_name": None, "good_sha": None}}),
    "eviction_condemns": (_guard_eviction_condemns, {
        3: {"bad_name": "next.txt", "bad_sha": "n",
            "good_name": "good.txt", "good_sha": "g"}}),
}


@pytest.mark.parametrize("scenario", sorted(GUARD_SCENARIOS))
def test_rollback_guard_matches_jax(scenario):
    """Adoption, condemnation after refused swaps or a post-swap
    eviction, and the last-known-good, call for call."""
    run, expect = GUARD_SCENARIOS[scenario]
    traces = {}
    for name, mod in AUTOSCALE.items():
        clock = [0.0]
        guard = mod.RollbackGuard(refuse_sec=5.0, adopt_sec=2.0,
                                  _now=lambda: clock[0])
        traces[name] = run(guard, clock)
    assert traces["port"] == traces["jax"]
    for i, want in expect.items():
        assert traces["port"][i] == want


# ---- the supervisor with fake replicas ----------------------------------

# a replica that imports neither package: it answers {"cmd": "ping"} on
# health_port + rank, exits 0 on {"cmd": "shutdown"}, and rank 1's
# first life dies with code 5 after its first ping
FAKE_REPLICA = r"""
import json, os, socket, sys
rank = int(os.environ["LIGHTGBM_TPU_RANK"])
life = int(os.environ["LIGHTGBM_TPU_RESTART_COUNT"])
srv = socket.socket()
srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
srv.bind(("127.0.0.1", int(sys.argv[1]) + rank))
srv.listen(16)
while True:
    conn, _ = srv.accept()
    fh = conn.makefile("rw")
    req = json.loads(fh.readline() or "{}")
    fh.write(json.dumps({"ok": True, "pid": os.getpid(), "rank": rank,
                         "life": life}) + "\n")
    fh.flush()
    conn.close()
    if req.get("cmd") == "shutdown":
        sys.exit(0)
    if rank == 1 and life == 0:
        sys.exit(5)
"""


def _two_ports():
    """A base port with base + 1 free too (replica r listens on base +
    r); both are released before the replicas bind them."""
    for _ in range(50):
        s0, s1 = socket.socket(), socket.socket()
        try:
            s0.bind(("127.0.0.1", 0))
            base = s0.getsockname()[1]
            s1.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            pass
        finally:
            s0.close()
            s1.close()
    raise AssertionError("no two contiguous free ports")


def _ping(mod, port):
    return mod.replica_rpc(port, {"cmd": "ping"}, timeout=2.0)


def _run_fleet(mod, tmp_path):
    base = _two_ports()
    logs = tmp_path / "logs"
    result = {}

    def run():
        result["rc"] = mod.supervise_fleet(
            2, [sys.executable, "-c", FAKE_REPLICA, str(base)],
            max_restarts=3, log_dir=str(logs), grace=1.0,
            env={k: v for k, v in os.environ.items()
                 if not k.startswith("LIGHTGBM_TPU_")},
            health_port=base, health_interval=0.2, health_fails=3,
            health_grace=30.0, health_timeout=2.0)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    seen = {0: [], 1: []}
    deadline = time.monotonic() + WAIT_S
    try:
        while time.monotonic() < deadline and not (
                seen[0] and any(r["life"] == 1 for r in seen[1])):
            for rank in (0, 1):
                rep = _ping(mod, base + rank)
                if rep is not None:
                    seen[rank].append(rep)
            time.sleep(0.1)
        last = _ping(mod, base)
    finally:
        for rank in (0, 1):
            mod.replica_rpc(base + rank, {"cmd": "shutdown"}, timeout=2.0)
        th.join(timeout=WAIT_S)
    assert not th.is_alive(), "the fleet supervisor did not return"
    return result["rc"], seen, last, sorted(os.listdir(logs))


def test_supervise_fleet_restarts_only_the_dead_replica(tmp_path):
    """Rank 1 dies after its first answer and comes back in a second
    life; rank 0 keeps its pid throughout; a graceful shutdown of both
    ends the fleet with 0. The JAX supervisor gives the same exit code,
    logs and lives."""
    runs = {name: _run_fleet(mod, tmp_path / name)
            for name, mod in ELASTIC.items()}
    for name, (rc, seen, last, logs) in runs.items():
        assert rc == 0, name
        assert {r["pid"] for r in seen[0]} == {last["pid"]}, name
        assert [r["life"] for r in seen[0]] == [0] * len(seen[0])
        lives = [r["life"] for r in seen[1]]
        assert lives[0] == 0 and lives[-1] == 1 and sorted(lives) == lives
        assert len({r["pid"] for r in seen[1]}) == 2, name
    assert runs["port"][3] == runs["jax"][3] == [
        "elastic_g0_rank0.log", "elastic_g0_rank1.log",
        "elastic_g1_rank1.log"]


class _FakeProc:
    def poll(self):
        return None


def test_wedged_replica_fails_scrape_without_stalling_round():
    """A replica that accepts TCP and never replies is marked ``alive:
    false, responsive: false`` within one bounded health timeout, while
    the healthy replica's row, fetched concurrently, lands in the same
    round; the JAX package's scrape of the same two replicas gives the
    same rows."""
    ls0, ls1 = socket.socket(), socket.socket()
    ls0.bind(("127.0.0.1", 0))
    base = ls0.getsockname()[1]
    try:
        ls1.bind(("127.0.0.1", base + 1))
    except OSError:
        ls0.close()
        ls1.close()
        pytest.fail("port base + 1 is taken; rerun")
    stop = threading.Event()
    metrics = render_openmetrics({}, extra={
        "serve_qps": gauge_family(12.5),
        "serve_p99_ms": gauge_family(8.0),
        "serve_requests_total": counter_family(100),
        "serve_shed_total": counter_family(0),
        "serve_model_info": gauge_family(1, model="m1", sha="abc123"),
    })

    def healthy():
        ls0.listen(8)
        ls0.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = ls0.accept()
            except socket.timeout:
                continue
            conn.recv(65536)
            conn.sendall((json.dumps({"ok": True, "metrics": metrics})
                          + "\n").encode())
            conn.close()

    def wedged():
        ls1.listen(8)
        ls1.settimeout(0.2)
        held = []
        while not stop.is_set():
            try:
                held.append(ls1.accept()[0])
            except socket.timeout:
                continue
        for c in held:
            c.close()

    threads = [threading.Thread(target=healthy, daemon=True),
               threading.Thread(target=wedged, daemon=True)]
    for t in threads:
        t.start()
    try:
        rows = {}
        for name, mod in ELASTIC.items():
            reps = [mod._Replica(0), mod._Replica(1)]
            for rep in reps:
                rep.proc = _FakeProc()
            t0 = time.monotonic()
            record = mod._scrape_fleet(reps, base, health_timeout=1.5)
            elapsed = time.monotonic() - t0
            assert elapsed < 4.0, (name, elapsed)
            assert record["event"] == "fleet"
            rows[name] = record["replicas"]
        assert rows["port"] == rows["jax"]
        by_rank = {r["rank"]: r for r in rows["port"]}
        assert by_rank[0]["alive"] and by_rank[0]["qps"] == 12.5
        assert by_rank[0]["sha256"] == "abc123"
        assert by_rank[0]["model"] == "m1"
        assert by_rank[1]["alive"] is False
        assert by_rank[1]["responsive"] is False
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        ls0.close()
        ls1.close()


# ---- the canary gate at startup (a departure: ROADMAP.md Queue 3) -----

def test_startup_refuses_a_poisoned_newest_publication(tmp_path,
                                                        monkeypatch):
    """A replica started on a publish directory whose newest publication
    fails its canary (``publish_poison``) serves the newest older one
    that passes, with a ``canary_refused`` event; both daemons resolve
    the same newest artifact, which the JAX daemon serves unchecked."""
    import numpy as np

    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu.serve import daemon as jax_daemon
    from lightgbm_tpu_torch.resilience import faults as port_faults
    from lightgbm_tpu_torch.resilience.publisher import publish_model
    from lightgbm_tpu_torch.serve import daemon as port_daemon
    monkeypatch.delenv("LIGHTGBM_TPU_FAULT_INJECT", raising=False)
    rs = np.random.RandomState(0)
    X = rs.randn(300, 4)
    y = (X[:, 0] > 0).astype(float)
    cpu = {"device_type": "cpu", "verbosity": -1}
    bst = tlgb.train({"objective": "binary", "num_leaves": 7, **cpu},
                     tlgb.Dataset(X, label=y, params=cpu), 3)
    rows = X[:8].astype(np.float32).astype(np.float64)
    canary = {"rows": rows.tolist(),
              "scores": bst.predict(rows, raw_score=True).tolist(),
              "tol": 1e-4}
    pub = tmp_path / "publish"
    publish_model(bst, str(pub), "model_g0000.txt", canary=canary)
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "publish_poison@1")
    publish_model(bst, str(pub), "model_g0001.txt", canary=canary,
                  fault_iteration=1)
    monkeypatch.delenv("LIGHTGBM_TPU_FAULT_INJECT")
    newer = os.stat(pub / "model_g0000.txt").st_mtime + 5
    os.utime(pub / "model_g0001.txt", (newer, newer))
    port_faults.drain_events(port_faults.FAULT_EVENTS)
    resolved = {}
    for name, mod in (("jax", jax_daemon), ("port", port_daemon)):
        args = mod.build_parser().parse_args(
            [str(pub), *(["--device-type", "cpu"] if name == "port"
                         else [])])
        resolved[name] = mod._resolve_model(args)[0]
    assert resolved["port"] == resolved["jax"] == \
        str(pub / "model_g0001.txt")
    path, key, manifest, forest, _ = port_daemon._startup_forest(
        args, resolved["port"], {"num_iteration": -1})
    assert path == str(pub / "model_g0000.txt") == key[0]
    assert manifest["file"] == "model_g0000.txt"
    np.testing.assert_allclose(np.reshape(forest.predict_raw(rows), -1),
                               canary["scores"], atol=1e-6)
    events = port_faults.drain_events(port_faults.FAULT_EVENTS)
    assert [(e["kind"], e["action"]) for e in events
            if e["kind"] != "publish_poison"] == \
        [("canary_refused", "refused_load")]


# ---- slow: the JAX package's autoscaling chaos run, on the port --------

def _summary(out):
    summary = None
    for line in out.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("event") == "pipeline_summary":
            summary = obj
    return summary


@pytest.mark.slow
def test_fleet_chaos_end_to_end(tmp_path):
    """``tests/test_fleet.py::test_fleet_chaos_end_to_end`` at its sizes
    through ``python -m lightgbm_tpu_torch pipeline --device-type cpu``:
    a load spike scales the fleet up and back down with no client
    timeout, a store outage mid-publish is retried through, and a
    poisoned generation is refused by the canary gates and rolled back
    to last-known-good."""
    workdir = str(tmp_path / "pipe")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIGHTGBM_TPU_")}
    env["PYTHONPATH"] = str(REPO)
    env["LIGHTGBM_TPU_FAULT_INJECT"] = "store_outage@1,publish_poison@2"
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "pipeline",
         "--device-type", "cpu",
         "--workdir", workdir, "--generations", "3",
         "--rounds", "5", "--rows", "900", "--features", "8",
         "--request-rate", "8", "--request-rows", "4",
         "--replicas", "1", "--max-replicas", "3",
         "--autoscale-up-qps", "15", "--autoscale-down-qps", "6",
         "--spike-rate", "60", "--spike-start", "4",
         "--spike-duration", "12",
         "--retire-grace", "15", "--rollback-grace", "8",
         "--canary-rows", "8", "--publish-keep", "4",
         "--health-interval", "0.5", "--health-grace", "25",
         "--scrape-interval", "1",
         "--swap-timeout", "240", "--grace", "10",
         "--param", "publish_backoff_sec=2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(REPO), start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=800)
    except subprocess.TimeoutExpired:
        port_elastic._kill_group(proc)
        out, _ = proc.communicate(timeout=30)
        pytest.fail(f"pipeline hung; partial output:\n{out[-4000:]}")
    assert proc.returncode == 0, f"pipeline failed:\n{out[-6000:]}"
    summary = _summary(out)
    assert summary is not None, out[-4000:]
    assert summary["failures"] == []
    assert summary["generations_published"] == 3
    lifecycle = summary["fleet_lifecycle"]
    assert lifecycle["scale_ups"] >= 1, lifecycle
    assert lifecycle["scale_downs"] >= 1, lifecycle
    assert lifecycle["replicas_peak"] >= 2, lifecycle
    client = summary["client"]
    assert client["timeout"] == 0 and client["ok"] > 0, client
    rollbacks = summary["rollbacks"]
    assert len(rollbacks) == 1 and lifecycle["rollbacks"] == 1, rollbacks
    bad, good = rollbacks[0]["bad_sha"], rollbacks[0]["good_sha"]
    assert bad and good and bad != good
    assert summary["fleet"] and all(
        st is not None and st["manifest_sha256"] == good
        for st in summary["fleet"])
    telem = os.path.join(workdir, "telemetry")
    serve_kinds = set()
    for suffix in ("", ".rank1", ".rank2"):
        path = os.path.join(telem, "serve.jsonl" + suffix)
        if os.path.exists(path):
            with open(path) as fh:
                serve_kinds |= {ev.get("kind") for ev in map(
                    json.loads, filter(str.strip, fh))
                    if ev.get("event") == "fault"}
    assert "canary_refused" in serve_kinds, serve_kinds
    with open(os.path.join(telem, "train_g0001.jsonl")) as fh:
        train_kinds = {ev.get("kind") for ev in map(
            json.loads, filter(str.strip, fh)) if ev.get("event") == "fault"}
    assert "store_outage" in train_kinds, train_kinds
    st = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "stats", telem,
         "--fleet"], env=env, capture_output=True, text=True,
        timeout=WAIT_S, cwd=str(REPO))
    assert st.returncode == 0, st.stderr[-3000:]
    assert "autoscale" in st.stdout and "rollbacks" in st.stdout, st.stdout
