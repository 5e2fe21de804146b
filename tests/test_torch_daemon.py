"""The port's serving daemon (lightgbm_tpu_torch/serve/daemon.py) held
against the JAX package's on the CPU.

The models are the port's, trained from a seed at 2,000 x 8 rows with 15
leaves; the JAX daemon serves the same model text. Both daemons answer
every request kind alike (predictions within 1e-6 of each other and of
``Booster.predict``), give the same ``model_id`` for the same model file,
and their watchers swap, skip a torn publication, refuse a poisoned
canary and degrade over a ``mem://`` outage with the same fault events,
each on publications of the other package. The JAX package's
``serve/daemon.py`` calls ``batcher.submit(X, trace=...)``, so the fakes
here take ``trace``. Then, in subprocesses: ``serve --help`` and a
missing model import no torch, and a socket daemon on ``--device-type
cpu`` hot-swaps to a JAX publication, drains on SIGTERM, and dies at
``serve_kill@N``. Each subprocess test bounds its own waits (at most 60
s).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import uuid
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.resilience import faults as jax_faults
from lightgbm_tpu.resilience import publisher as jax_pub
from lightgbm_tpu.resilience import store as jax_store
from lightgbm_tpu.serve import batcher as jax_batcher
from lightgbm_tpu.serve import compile as jax_compile
from lightgbm_tpu.serve import daemon as jax_daemon
from lightgbm_tpu_torch.obs import parse_openmetrics
from lightgbm_tpu_torch.obs.trace import drain_span_events
from lightgbm_tpu_torch.resilience import faults as port_faults
from lightgbm_tpu_torch.resilience import publisher as port_pub
from lightgbm_tpu_torch.resilience import store as port_store
from lightgbm_tpu_torch.serve import batcher as port_batcher
from lightgbm_tpu_torch.serve import compile as port_compile
from lightgbm_tpu_torch.serve import daemon as port_daemon

REPO = Path(__file__).resolve().parent.parent
CPU = {"device_type": "cpu", "verbosity": -1}
WAIT_S = 60.0


class _Pkg:
    def __init__(self, daemon, compile_mod, batcher, pub, store, faults,
                 booster):
        self.daemon, self.compile, self.batcher = daemon, compile_mod, \
            batcher
        self.pub, self.store, self.faults = pub, store, faults
        self.booster = booster


PKGS = {
    "jax": _Pkg(jax_daemon, jax_compile, jax_batcher, jax_pub, jax_store,
                jax_faults, lambda text: jlgb.Booster(model_str=text)),
    "port": _Pkg(port_daemon, port_compile, port_batcher, port_pub,
                 port_store, port_faults,
                 lambda text: tlgb.Booster(model_str=text, params=CPU)),
}
OTHER = {"jax": "port", "port": "jax"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_logs(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_FAULT_INJECT", raising=False)
    for p in PKGS.values():
        p.faults.drain_events(p.faults.FAULT_EVENTS)
    drain_span_events()
    yield
    for p in PKGS.values():
        p.faults.drain_events(p.faults.FAULT_EVENTS)


def _train(y_col, X, rs, **params):
    y = ((X[:, y_col] + 0.4 * rs.randn(len(X))) > 0) * 1.0
    p = {"objective": "binary", "num_leaves": 15, **CPU, **params}
    return tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 4)


@pytest.fixture(scope="module")
def models():
    """Model texts A, B, C (other labels), and the rows."""
    rs = np.random.RandomState(11)
    X = rs.randn(2000, 8)
    texts = [_train(c, X, rs).model_to_string() for c in (0, 1, 2)]
    return texts, X


def _state(pkg, text, telemetry=None):
    cf = pkg.compile.compile_forest(pkg.booster(text), max_batch_rows=256)
    cf.warmup(64)
    mb = pkg.batcher.MicroBatcher(cf, batch_window_ms=0.5,
                                  max_batch_rows=256)
    return pkg.daemon.ServeState(mb, cf.model_id, "test-model",
                                 telemetry_path=telemetry), cf


def _events(pkg):
    return [(e["kind"], e["action"])
            for e in pkg.faults.drain_events(pkg.faults.FAULT_EVENTS)]


# ---- the protocol ------------------------------------------------------------

def test_handle_request_answers_like_jax(models):
    texts, X = models
    want = tlgb.Booster(model_str=texts[0], params=CPU)
    rows = X[:3].tolist()
    requests = [
        {"cmd": "ping"}, {"rows": rows}, {"features": X[0].tolist()},
        {"rows": rows, "raw": True}, {"cmd": "nope"}, {"rows": "zzz"},
        {"rows": []}, ["not", "a", "dict"], {}, {"rows": [[1.0, 2.0]]},
    ]
    replies = {}
    for name, pkg in PKGS.items():
        state, cf = _state(pkg, texts[0])
        try:
            replies[name] = [pkg.daemon.handle_request(r, state)
                             for r in requests]
            stats = pkg.daemon.handle_request({"cmd": "stats"}, state)
            replies[name].append(sorted(stats))
            replies[name].append(
                pkg.daemon.handle_request({"cmd": "shutdown"}, state))
            assert state.shutdown_event.is_set()
        finally:
            state.close()
    j, p = replies["jax"], replies["port"]
    assert p[0]["model"] == j[0]["model"] and p[0]["ok"]
    assert p[0]["pid"] == os.getpid()
    for i in (1, 2, 3):
        assert p[i]["model"] == j[i]["model"] and p[i]["n"] == j[i]["n"]
        np.testing.assert_allclose(p[i]["predictions"], j[i]["predictions"],
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p[1]["predictions"], want.predict(X[:3]))
    np.testing.assert_array_equal(p[3]["predictions"],
                                  want.predict(X[:3], raw_score=True))
    for i in (4, 7, 8):
        assert p[i] == j[i]
    for i in (5, 6, 9):
        assert set(p[i]) == set(j[i]) == {"error"}
    assert p[10] == j[10]                   # the stats reply's keys
    assert p[11] == j[11] == {"ok": True, "shutting_down": True}


def test_metrics_and_request_spans(models):
    texts, X = models
    state, cf = _state(PKGS["port"], texts[0])
    try:
        h = port_daemon.handle_request
        r = h({"rows": X[:5].tolist(),
               "trace": {"trace_id": "t" * 16, "span_id": "s" * 16}},
              state)
        assert r["n"] == 5
        spans = [s for s in drain_span_events()
                 if s["trace_id"] == "t" * 16]
        names = sorted(s["name"] for s in spans)
        assert names == ["serve/batch_window", "serve/dispatch",
                         "serve/queue_wait", "serve/reply",
                         "serve/request"]
        root = next(s for s in spans if s["name"] == "serve/request")
        assert root["parent_id"] == "s" * 16
        assert root["attrs"] == {"model": cf.model_id, "rows": 5}
        assert all(s["parent_id"] == root["span_id"] for s in spans
                   if s is not root)
        m = h({"cmd": "metrics"}, state)
        assert m["ok"] and m["content_type"].startswith(
            "application/openmetrics-text")
        fams = parse_openmetrics(m["metrics"])
        info = fams["lightgbm_tpu_serve_model_info"]
        assert info == {(("model", cf.model_id), ("sha", "")): 1.0}
        assert fams["lightgbm_tpu_serve_requests_total"] == {(): 1.0}
        st = h({"cmd": "stats"}, state)
        assert st["recompiles"] == {"delta": 0, "total": 0}
        assert st["hbm"]["bytes_in_use"] is None      # a CPU forest
    finally:
        state.close()


def test_concurrent_requests_and_stats_lose_no_update(models):
    """16 threads x 20 requests while a poller reads ``stats``, with a
    short switch interval: every reply is right, every request ordinal
    is taken once, and the counters add up."""
    import threading
    texts, X = models
    want = tlgb.Booster(model_str=texts[0], params=CPU).predict(X[:64])
    state, _ = _state(PKGS["port"], texts[0])
    errors, stop = [], threading.Event()

    def client(seed):
        r = np.random.RandomState(seed)
        for _ in range(20):
            lo = int(r.randint(0, 60))
            rep = port_daemon.handle_request(
                {"rows": X[lo:lo + 4].tolist()}, state)
            if not np.allclose(rep.get("predictions"), want[lo:lo + 4],
                               rtol=0, atol=1e-6):
                errors.append(rep)

    def poller():
        while not stop.is_set():
            state.stats()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        pt = threading.Thread(target=poller)
        pt.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        stop.set()
        pt.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads + [pt])
        st = state.stats()
    finally:
        sys.setswitchinterval(old)
        state.close()
    assert not errors
    assert st["requests_total"] == 320 and st["rows_total"] == 1280
    assert state.count_request() == 321


def _fake_submit(raises=None, fails=None):
    """A ``submit(rows, trace=None)`` that raises ``raises``, or returns
    a future failed with ``fails``."""
    def submit(rows, trace=None):
        if raises is not None:
            raise raises
        fut = Future()
        fut.set_exception(fails)
        return fut
    return submit


@pytest.mark.parametrize("name", ["jax", "port"])
def test_overload_shed_and_draining_replies(models, name):
    """The typed replies of both daemons, with fakes that take the
    ``trace`` keyword the daemons pass."""
    texts, X = models
    pkg = PKGS[name]
    state, cf = _state(pkg, texts[0])
    real = state.batcher.submit
    try:
        rows = {"rows": X[:2].tolist()}
        state.batcher.submit = _fake_submit(
            raises=pkg.batcher.QueueFullError("serve queue full: test"))
        r = pkg.daemon.handle_request(rows, state)
        assert r == {"error": "serve queue full: test", "overloaded": True}
        state.batcher.submit = _fake_submit(
            fails=pkg.batcher.SheddingError("shed: test"))
        r = pkg.daemon.handle_request(rows, state)
        assert r == {"error": "shed: test", "shed": True,
                     "overloaded": True, "model": cf.model_id}
        assert state.stats()["shed_replies"] == 1
        state.batcher.submit = real
        state.begin_drain()
        r = pkg.daemon.handle_request(rows, state)
        assert r == {"error": "draining", "draining": True,
                     "model": cf.model_id}
        assert pkg.daemon.handle_request({"cmd": "ping"}, state)["ok"]
    finally:
        state.batcher.submit = real
        state.close()


def test_serve_kill_fires_before_the_batcher(models, monkeypatch):
    """``serve_kill@3``: requests 1-2 answer; the third SIGKILLs before
    it is submitted (``os.kill`` replaced here)."""
    texts, X = models
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "serve_kill@3")
    kills = []
    monkeypatch.setattr(port_faults.os, "kill",
                        lambda pid, sig: kills.append((pid, sig)))
    state, _ = _state(PKGS["port"], texts[0])
    try:
        for i in range(1, 5):
            r = port_daemon.handle_request({"rows": X[:1].tolist()}, state)
            assert r["n"] == 1
            assert kills == ([] if i < 3
                             else [(os.getpid(), signal.SIGKILL)])
        monkeypatch.setenv("LIGHTGBM_TPU_RANK", "1")
        assert not port_faults.FaultPlan("serve_kill@1")._replica_selected()
    finally:
        state.close()


# ---- the model id ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "categorical", "linear",
                                  "multiclass"])
def test_model_id_is_the_jax_id(kind, tmp_path):
    rs = np.random.RandomState(5)
    X = rs.randn(2000, 8)
    X[:, 3] = rs.randint(0, 12, 2000)
    extra = {"categorical": {"categorical_feature": [3]},
             "linear": {"linear_tree": True},
             "multiclass": {"objective": "multiclass", "num_class": 3}
             }.get(kind, {})
    if kind == "multiclass":
        y = (X[:, 0] > 0.5) * 1.0 + (X[:, 1] > 0.5)
    else:
        y = ((X[:, 3] % 3 == 0) + X[:, 0] + 0.3 * rs.randn(2000) > 0.5) * 1.
    p = {"objective": "binary", "num_leaves": 15, **CPU, **extra}
    bst = tlgb.train(p, tlgb.Dataset(X, label=y, params=p), 4)
    if kind == "categorical":
        assert any(t.num_cat > 0 for t in bst._models)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    port_id = port_compile.compile_forest(
        tlgb.Booster(model_file=path, params=CPU)).model_id
    jax_id = jax_compile.compile_forest(
        jlgb.Booster(model_file=path)).model_id
    assert port_id == jax_id
    assert port_compile.compile_forest(bst).model_id == port_id
    assert len(port_id) == 16 and port_id != "empty"


# ---- the watcher -------------------------------------------------------------

_COMPILE = dict(num_iteration=-1, min_bucket=16, max_batch_rows=256)


def _bump(path, t):
    os.utime(path, (t, t))


def _watch_run(name, texts, X, d, monkeypatch):
    """One package's watcher over a directory, each artifact published by
    the OTHER package: what each poll returned, the events, and the ids
    and raw scores served."""
    pkg, other = PKGS[name], PKGS[OTHER[name]]
    a = os.path.join(d, "a.txt")
    with open(a, "w") as fh:
        fh.write(texts[0])
    t0 = time.time()
    _bump(a, t0 - 100)
    state, cf = _state(pkg, texts[0])
    w = pkg.daemon._Watcher(state, d, 0.1, _COMPILE,
                            pkg.daemon._artifact_key(a), 64)
    out = []

    def step(tag):
        ok = w.poll_once()
        fut = state.batcher.submit(X[:8].astype(np.float32))
        out.append((tag, ok, state.model_id(), _events(pkg),
                    np.asarray(fut.result(timeout=30)).ravel().tolist()))

    def canary(text):
        raw = tlgb.Booster(model_str=text, params=CPU).predict(
            X[:32], raw_score=True)
        return {"rows": X[:32].tolist(), "scores": raw.tolist(),
                "tol": 1e-4}

    try:
        step("nothing new")
        other.pub.publish_model(texts[1], d, "b.txt",
                                canary=canary(texts[1]))
        _bump(os.path.join(d, "b.txt"), t0 + 2)
        step("swap to b")
        monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "publish_torn@1")
        with pytest.raises(other.pub.PublishError):
            other.pub.publish_model(texts[2], d, "c.txt", retries=0,
                                    fault_iteration=1)
        other.faults.drain_events(other.faults.FAULT_EVENTS)
        _bump(os.path.join(d, "c.txt"), t0 + 4)
        step("torn c")
        step("torn c again")
        monkeypatch.delenv("LIGHTGBM_TPU_FAULT_INJECT")
        other.pub.publish_model(texts[2], d, "c.txt")
        _bump(os.path.join(d, "c.txt"), t0 + 6)
        step("swap to c")
        monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "publish_poison@2")
        other.pub.publish_model(texts[0], d, "d.txt",
                                canary=canary(texts[0]), fault_iteration=2)
        other.faults.drain_events(other.faults.FAULT_EVENTS)
        _bump(os.path.join(d, "d.txt"), t0 + 8)
        step("poisoned d")
        failures = state.stats()["swap_failures"]
    finally:
        state.close()
    return out, failures


def test_watcher_swaps_skips_and_refuses_like_jax(models, tmp_path,
                                                  monkeypatch):
    texts, X = models
    runs = {}
    for name in PKGS:
        d = tmp_path / name
        d.mkdir()
        runs[name] = _watch_run(name, texts, X, str(d), monkeypatch)
    (jax_steps, jax_failures), (steps, failures) = \
        runs["jax"], runs["port"]
    assert failures == jax_failures == 3
    ids = {}
    for (tag, ok, mid, ev, raw), (_, jok, jmid, jev, jraw) in zip(
            steps, jax_steps):
        assert (ok, mid, ev) == (jok, jmid, jev), tag
        np.testing.assert_allclose(raw, jraw, rtol=0, atol=1e-6)
        ids[tag] = mid
    assert [s[1] for s in steps] == [False, True, False, False, True,
                                     False]
    assert [s[3] for s in steps] == [
        [], [], [("swap_failure", "retry_next_poll")], [], [],
        [("canary_refused", "refused_swap"),
         ("swap_failure", "retry_next_poll")]]
    want = {t: tlgb.Booster(model_str=texts[i], params=CPU).predict(
        X[:8], raw_score=True) for t, i in (("swap to b", 1),
                                            ("torn c", 1),
                                            ("swap to c", 2),
                                            ("poisoned d", 2))}
    for tag, _, _, _, raw in steps:
        if tag in want:
            np.testing.assert_array_equal(raw, want[tag])
    assert ids["swap to c"] == port_compile.compile_forest(
        tlgb.Booster(model_str=texts[2], params=CPU)).model_id


def test_mem_store_outage_degrades_like_jax(models):
    texts, X = models
    got = {}
    for name, pkg in PKGS.items():
        spec = f"mem://{uuid.uuid4().hex}"
        pkg.pub.publish_model(texts[1], spec, "b.txt")
        state, _ = _state(pkg, texts[0])
        w = pkg.daemon._Watcher(state, spec, 0.1, _COMPILE, None, 64)
        backend = pkg.store.store_for(spec).backend
        try:
            backend.set_outage(-1)
            polls = [w.poll_once(), w.poll_once()]
            ev = _events(pkg)
            backend.set_outage(0)
            polls.append(w.poll_once())
            got[name] = (polls, ev, state.model_id(),
                         state.model_source().replace(spec, "<spec>"))
        finally:
            state.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == [False, False, True]
    assert got["port"][1] == [("store_outage", "degraded")]
    assert got["port"][3] == "<spec>/b.txt"


def test_a_feature_count_change_is_refused(models, tmp_path):
    texts, X = models
    rs = np.random.RandomState(2)
    X4 = rs.randn(500, 4)
    narrow = tlgb.train({"objective": "binary", **CPU},
                        tlgb.Dataset(X4, label=(X4[:, 0] > 0) * 1.0,
                                     params=CPU), 2).model_to_string()
    state, cf = _state(PKGS["port"], texts[0])
    try:
        w = port_daemon._Watcher(state, str(tmp_path), 0.1, _COMPILE,
                                 None, 64)
        port_pub.publish_model(narrow, str(tmp_path), "n.txt")
        assert not w.poll_once()
        assert _events(PKGS["port"]) == [("swap_failure",
                                          "retry_next_poll")]
        assert state.model_id() == cf.model_id
    finally:
        state.close()


# ---- subprocesses ------------------------------------------------------------

def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "LIGHTGBM_TPU_FAULT_INJECT",
                        "LIGHTGBM_TPU_TELEMETRY",
                        "LIGHTGBM_TPU_METRICS_PORT", "LIGHTGBM_TPU_RANK")}
    env["PYTHONPATH"] = str(REPO)
    env.update(extra)
    return env


@pytest.mark.timeout(60)
def test_serve_help_and_a_missing_model_import_no_torch():
    code = """
import runpy, sys
def run(*args):
    sys.argv = ["lightgbm_tpu_torch", "serve", *args]
    try:
        runpy.run_module("lightgbm_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        return e.code
print("RC", run("--help"), run("/nonexistent/model.txt"),
      run("--device-type", "tpu", "x.txt"))
bad = [m for m in sys.modules if m.split(".")[0] in ("torch", "jax")]
assert not bad, bad
print("TORCHFREE")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=_env(), capture_output=True, text=True,
                         timeout=WAIT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "usage: python -m lightgbm_tpu_torch serve" in out.stdout
    assert "RC 0 1 2" in out.stdout and "TORCHFREE" in out.stdout
    assert "model file not found" in out.stderr


def _start_daemon(tmp_path, model, *flags, **env):
    log = open(tmp_path / f"daemon{len(env)}.out", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "serve", model,
         "--port", "0", "--device-type", "cpu", "--warmup-rows", "64",
         "--max-batch-rows", "256", *flags],
        stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO),
        env=_env(**env), start_new_session=True)
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        log.seek(0)
        for ln in log.read().splitlines():
            if ln.startswith('{"event": "serve_ready"'):
                return proc, json.loads(ln), log
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    proc.kill()
    log.seek(0)
    raise AssertionError(f"no serve_ready line:\n{log.read()[-3000:]}")


def _connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    return s, s.makefile("rw")


def _rpc(fh, obj):
    fh.write(json.dumps(obj) + "\n")
    fh.flush()
    line = fh.readline()
    assert line, "the daemon closed the connection"
    return json.loads(line)


def _stop(proc, log):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=WAIT_S)
    log.close()


@pytest.mark.timeout(60)
def test_socket_daemon_swaps_to_a_jax_publication_and_drains(models,
                                                             tmp_path):
    """Predictions within 1e-6 of ``Booster.predict``; a hot swap to a
    JAX publication; SIGTERM during 200 pipelined requests on 4
    connections: every reply is a prediction (equal to the model it
    names) or ``draining``, every request the batcher took is answered,
    and the daemon exits 0 well inside ``--grace``."""
    texts, X = models
    watch = tmp_path / "watch"
    watch.mkdir()
    model = str(watch / "a.txt")
    with open(model, "w") as fh:
        fh.write(texts[0])
    telem = str(tmp_path / "serve.jsonl")
    proc, ready, log = _start_daemon(
        tmp_path, str(watch), "--telemetry", telem,
        "--stats-interval", "0.3",
        "--watch-interval", "0.1", "--grace", "20", "--window-ms", "2")
    answers = {}
    for i in (0, 1):
        b = tlgb.Booster(model_str=texts[i], params=CPU)
        answers[port_compile.compile_forest(b).model_id] = b
    predicted = 0
    try:
        assert ready["model"] in answers and ready["rank"] == 0
        assert ready["model_source"] == model
        assert ready["watch_dir"] == str(watch)
        s, fh = _connect(ready["port"])
        r = _rpc(fh, {"rows": X[:64].tolist()})
        np.testing.assert_allclose(
            r["predictions"], answers[ready["model"]].predict(X[:64]),
            rtol=0, atol=1e-6)
        predicted += 1
        jax_pub.publish_model(texts[1], str(watch), "b.txt")
        deadline = time.time() + WAIT_S / 2
        while r["model"] == ready["model"] and time.time() < deadline:
            r = _rpc(fh, {"rows": X[:4].tolist()})
            predicted += 1
        assert r["model"] != ready["model"], "no swap to b.txt"
        st = _rpc(fh, {"cmd": "stats"})
        assert st["swaps_total"] == 1 and st["model_source"].endswith(
            "b.txt") and st["manifest"]["file"] == "b.txt"
        s.close()
        conns = [_connect(ready["port"]) for _ in range(4)]
        for i, (_, cfh) in enumerate(conns):
            for k in range(50):
                cfh.write(json.dumps({"rows": X[k:k + 1 + i].tolist()})
                          + "\n")
            cfh.flush()
        time.sleep(0.05)
        t_term = time.time()
        os.kill(proc.pid, signal.SIGTERM)
        replies = []
        for i, (cs, cfh) in enumerate(conns):
            for k, line in enumerate(cfh):
                replies.append((i, k, json.loads(line)))
            cs.close()
        rc = proc.wait(timeout=WAIT_S)
        exit_s = time.time() - t_term
    finally:
        _stop(proc, log)
    assert rc == 0 and exit_s < 20
    assert replies
    for i, k, rep in replies:
        if "predictions" in rep:
            want = answers[rep["model"]].predict(X[k:k + 1 + i])
            np.testing.assert_allclose(rep["predictions"], want, rtol=0,
                                       atol=1e-6)
            predicted += 1
        else:
            assert rep == {"error": "draining", "draining": True,
                           "model": rep["model"]}
    with open(telem) as fh:
        events = [json.loads(ln) for ln in fh if ln.strip()]
    serve = [e for e in events if e.get("event") == "serve"]
    assert max(e["requests_total"] for e in serve) == predicted
    assert any(e["draining"] for e in serve)
    assert serve[-1]["swaps_total"] == 1
    from lightgbm_tpu_torch.cli import main as cli_main
    assert cli_main(["stats", telem]) == 0


@pytest.mark.timeout(60)
def test_serve_kill_daemon_dies_after_its_answers(models, tmp_path):
    texts, X = models
    model = str(tmp_path / "m.txt")
    with open(model, "w") as fh:
        fh.write(texts[0])
    proc, ready, log = _start_daemon(
        tmp_path, model, LIGHTGBM_TPU_FAULT_INJECT="serve_kill@5")
    try:
        s, fh = _connect(ready["port"])
        for _ in range(4):
            assert _rpc(fh, {"rows": X[:2].tolist()})["n"] == 2
        assert _rpc(fh, {"cmd": "ping"})["ok"]      # not a predict
        fh.write(json.dumps({"rows": X[:2].tolist()}) + "\n")
        fh.flush()
        assert fh.readline() == ""
        s.close()
        assert proc.wait(timeout=WAIT_S) == -signal.SIGKILL
    finally:
        _stop(proc, log)


@pytest.mark.timeout(60)
def test_no_gpu_exits_one_naming_the_cpu_flag(models, tmp_path):
    """``--device-type cuda`` (the default) where torch sees no GPU exits
    1; it never serves on the CPU instead."""
    texts, _ = models
    model = str(tmp_path / "m.txt")
    with open(model, "w") as fh:
        fh.write(texts[0])
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from lightgbm_tpu_torch.serve.daemon import main\n"
            f"sys.exit(main([{model!r}, '--port', '0']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=_env(), capture_output=True, text=True,
                         timeout=WAIT_S)
    assert out.returncode == 1
    assert "--device-type cpu" in out.stderr
    assert "serve_ready" not in out.stdout
