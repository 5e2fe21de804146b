"""Run telemetry of the port (lightgbm_tpu_torch: obs/schemas.py,
obs/registry.py, obs/export.py, obs/memory.py, obs/recorder.py,
obs/trace.py, utils/timer.py, the ``telemetry`` callback and the
``stats`` and ``trace`` subcommands) held against the JAX package on the
CPU.

The registries are the JAX package's; the port's ``iteration`` events
carry every required key, and their ``tree`` (leaves exactly, split-gain
sums to 1e-5 relative) and ``eval`` records equal the JAX run's on the
same inputs (the JAX side with ``hist_method="scatter"`` and a valid
set, the port with XLA's float root totals). Each package's
``summarize_events`` reads the other's stream and both render the same
``stats`` table; both ``trace`` commands give the same Chrome trace and
critical paths from one span file; the OpenMetrics render and parser
agree; the ``/metrics`` endpoint serves on an ephemeral localhost port.
"""

import json
import os
import socket
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
from lightgbm_tpu import cli as jax_cli
from lightgbm_tpu.obs import export as jax_export
from lightgbm_tpu.obs import recorder as jax_recorder
from lightgbm_tpu.obs import schemas as jax_schemas
from lightgbm_tpu.obs import trace as jax_trace
from lightgbm_tpu.obs.registry import MetricsRegistry as JaxRegistry
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import cli as port_cli
from lightgbm_tpu_torch.obs import device_memory_stats
from lightgbm_tpu_torch.obs import export as port_export
from lightgbm_tpu_torch.obs import recorder as port_recorder
from lightgbm_tpu_torch.obs import schemas as port_schemas
from lightgbm_tpu_torch.obs import trace as port_trace
from lightgbm_tpu_torch.obs.registry import MetricsRegistry
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.resilience import faults as port_faults
from lightgbm_tpu_torch.utils import timer as port_timer

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}
PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "metric": "auc,binary_logloss"}
ENV = ("LIGHTGBM_TPU_FAULT_INJECT", "LIGHTGBM_TPU_TELEMETRY",
       "LIGHTGBM_TPU_TRACE_TO", "LIGHTGBM_TPU_XPROF",
       "LIGHTGBM_TPU_METRICS_PORT", "LIGHTGBM_TPU_CHECKPOINT",
       "LIGHTGBM_TPU_TRACE_CTX")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the test workers share the machine's cores, and
    these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled when it ends, so that
    they do not count against the process-wide jit signature budgets
    that later tests on the same worker check."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No telemetry variable leaks in or out; the port's process-level
    fault log and span buffer start and end empty."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)

    def drain():
        port_faults.drain_events(port_faults.FAULT_EVENTS)
        port_trace.drain_span_events()
        port_trace.set_current_trace(None)
    drain()
    yield
    drain()


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


def _binary(n=500, f=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    return X, (X[:, 0] + 0.3 * rs.randn(n) > 0).astype(float)


def _lines(path):
    return [json.loads(line) for line in open(path) if line.strip()]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """One telemetry stream from each package: the same data, params and
    valid set, 4 iterations, ``nan_grad@2`` under skip_tree (a fault
    line)."""
    d = tmp_path_factory.mktemp("streams")
    X, y = _binary()
    p = {**PARAMS, "nonfinite_policy": "skip_tree"}
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGHTGBM_TPU_FAULT_INJECT", "nan_grad@2")
    mp.setattr(grow, "root_totals", _jax_root_totals)
    try:
        jpath, tpath = str(d / "jax.jsonl"), str(d / "port.jsonl")
        jlgb.train({**p, **JAX}, jlgb.Dataset(X, label=y), 4,
                   valid_sets=[jlgb.Dataset(X[:100], label=y[:100])],
                   callbacks=[jlgb.telemetry(jpath)])
        tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 4,
                   valid_sets=[tlgb.Dataset(X[:100], label=y[:100],
                                            params=CPU)],
                   callbacks=[tlgb.telemetry(tpath)])
    finally:
        mp.undo()
    return jpath, tpath


# ---- the registries ----------------------------------------------------

@pytest.mark.parametrize("name", ["EVENTS", "METRICS", "EXPORT_FAMILIES",
                                  "ENV_VARS", "FAULT_KINDS",
                                  "FAULT_EVENT_KINDS"])
def test_registries_are_the_jax_packages(name):
    assert getattr(port_schemas, name) == getattr(jax_schemas, name)


# ---- the event stream --------------------------------------------------

def test_iteration_events_have_the_jax_required_keys(streams):
    _, tpath = streams
    events = _lines(tpath)
    iters = [e for e in events if e["event"] == "iteration"]
    assert [e["iteration"] for e in iters] == [0, 1, 2, 3]
    for e in iters:
        assert tuple(e)[:len(jax_recorder.ITERATION_EVENT_KEYS)] == \
            jax_recorder.ITERATION_EVENT_KEYS
        assert e["recompiles"] == {"delta": 0, "total": 0}
        assert e["comm"] is None and e["scan"] is None
        assert set(e["hbm"]) == {"bytes_in_use", "peak_bytes_in_use",
                                 "bytes_limit"}
        assert {"boosting/gradients", "boosting/bagging",
                "tree_learner/grow", "engine/eval"} <= set(e["phases"])
    names = {e["event"] for e in events}
    assert names <= set(port_schemas.EVENT_NAMES)
    for e in events:
        assert set(port_schemas.required_keys(e["event"])) <= set(e)


def test_fault_line_precedes_its_iteration(streams):
    """The guard's event is drained ahead of iteration 2's line, with the
    JAX stream's kind, action and detail."""
    jpath, tpath = streams
    for path in (jpath, tpath):
        events = _lines(path)
        at = [i for i, e in enumerate(events) if e["event"] == "fault"]
        assert len(at) == 1
        it2 = next(i for i, e in enumerate(events)
                   if e["event"] == "iteration" and e["iteration"] == 2)
        assert at[0] < it2
    jf, tf = (next(e for e in _lines(p) if e["event"] == "fault")
              for p in (jpath, tpath))
    assert {k: tf[k] for k in ("kind", "iteration", "action", "detail")} \
        == {k: jf[k] for k in ("kind", "iteration", "action", "detail")}


def test_tree_and_eval_records_equal_the_jax_runs(streams):
    jpath, tpath = streams
    ji, ti = ([e for e in _lines(p) if e["event"] == "iteration"]
              for p in (jpath, tpath))
    assert len(ji) == len(ti) == 4
    for a, b in zip(ji, ti):
        assert b["tree"]["trees"] == a["tree"]["trees"]
        assert b["tree"]["leaves"] == a["tree"]["leaves"]
        assert b["tree"]["split_gain_sum"] == pytest.approx(
            a["tree"]["split_gain_sum"], rel=1e-5)
        assert set(b["eval"]) == set(a["eval"])
        for k in a["eval"]:
            assert b["eval"][k] == pytest.approx(a["eval"][k], rel=1e-5)


def test_each_package_summarizes_the_others_stream(streams, capsys):
    """Either ``summarize_events`` folds either stream to the same
    summary, and both ``stats`` commands print the same rows."""
    for path in streams:
        mine = port_recorder.summarize_events(path)
        ref = jax_recorder.summarize_events(path)
        assert mine == ref
        assert port_recorder.render_stats_table(mine) == \
            jax_recorder.render_stats_table(ref)
        assert mine["iterations"] == 4 and mine["faults"] == {
            "nonfinite": 1}
        assert port_cli.main(["stats", path]) == 0
        out = capsys.readouterr().out
        assert jax_cli.main(["stats", path]) == 0
        assert capsys.readouterr().out == out


def test_stats_reads_a_directory_and_merges_the_fleet_view(streams,
                                                          capsys):
    d = os.path.dirname(streams[0])
    assert port_cli.main(["stats", d, "--fleet"]) == 0
    out = capsys.readouterr().out
    assert jax_cli.main(["stats", d, "--fleet"]) == 0
    assert capsys.readouterr().out == out
    assert "== port.jsonl ==" in out and "fleet (merged view)" in out
    assert port_cli.main(["stats", str(d) + "/missing.jsonl"]) == 1


def test_the_env_var_activates_telemetry_and_restores_the_timer(
        tmp_path, monkeypatch):
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("LIGHTGBM_TPU_TELEMETRY", path)
    X, y = _binary()
    before = port_timer.Timer.enabled()
    tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 2)
    assert port_timer.Timer.enabled() == before
    assert [e["iteration"] for e in _lines(path)
            if e["event"] == "iteration"] == [0, 1]


def test_a_raise_still_closes_the_recorder_with_its_fault_line(
        tmp_path, monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "nan_hess@1")
    path = str(tmp_path / "t.jsonl")
    X, y = _binary()
    with pytest.raises(tlgb.LightGBMError, match="non-finite hessians"):
        tlgb.train({**PARAMS, **CPU},
                   tlgb.Dataset(X, label=y, params=CPU), 3,
                   callbacks=[tlgb.telemetry(path)])
    faults = [e for e in _lines(path) if e["event"] == "fault"]
    assert [(f["iteration"], f["action"]) for f in faults] == \
        [(1, "raise")]
    assert not port_timer.Timer.enabled()


def test_cv_streams_one_event_per_round_over_every_fold(tmp_path):
    path = str(tmp_path / "cv.jsonl")
    X, y = _binary()
    tlgb.cv({**PARAMS, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 2,
            nfold=3, callbacks=[tlgb.telemetry(path)])
    iters = [e for e in _lines(path) if e["event"] == "iteration"]
    assert [e["iteration"] for e in iters] == [0, 1]
    assert all(e["tree"]["trees"] == 3 for e in iters)
    assert all("cv_agg:valid auc" in e["eval"] for e in iters)
    assert not port_timer.Timer.enabled()


def test_memory_gauges_are_null_on_the_cpu():
    assert device_memory_stats(torch.device("cpu")) == {
        "bytes_in_use": None, "peak_bytes_in_use": None,
        "bytes_limit": None}


# ---- spans and the trace command ---------------------------------------

def _lifecycle_spans(path):
    """A span file with one published generation: two iterations, a
    publish, a swap on a replica and a request answered by the new
    model, from two processes (the shape the JAX pipeline writes)."""
    mk = port_trace.make_span
    t = 1000.0
    spans = []
    for it in range(2):
        s = mk("train/iteration", t + it, t + it + 0.5, trace_id="g1",
               attrs={"iteration": it})
        spans.append(s)
    spans.append(mk("publish/model", t + 2, t + 2.2, trace_id="g1",
                    attrs={"generation": 1}))
    for i, name in enumerate(("swap/validate", "swap/load", "swap/stage",
                              "swap/apply")):
        s = mk(name, t + 3 + i * 0.1, t + 3.05 + i * 0.1, trace_id="g1",
               attrs={"model": "m1"})
        s["proc"] = "pid2"
        spans.append(s)
    s = mk("serve/request", t + 4, t + 4.01, trace_id="c1",
           attrs={"model": "m1"})
    s["proc"] = "pid2"
    spans.append(s)
    with open(path, "w") as fh:
        for s in spans:
            fh.write(json.dumps(s) + "\n")


def test_both_trace_commands_agree_on_one_span_file(tmp_path, capsys):
    d = tmp_path / "spans"
    d.mkdir()
    _lifecycle_spans(str(d / "run.jsonl"))
    mine, ref = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert port_cli.main(["trace", str(d), "--out", mine]) == 0
    out = capsys.readouterr().out
    assert jax_cli.main(["trace", str(d), "--out", ref]) == 0
    assert capsys.readouterr().out.replace(ref, mine) == out
    assert json.load(open(mine)) == json.load(open(ref))
    spans = port_trace.load_spans(str(d))
    port_trace.correct_clock_skew(spans)
    jspans = jax_trace.load_spans(str(d))
    jax_trace.correct_clock_skew(jspans)
    paths = port_trace.critical_paths(spans)
    assert paths == jax_trace.critical_paths(jspans)
    assert paths[0]["complete"] and paths[0]["model"] == "m1"
    assert port_cli.main(["trace", str(tmp_path / "none")]) == 1


def test_iteration_spans_reach_the_stream(streams):
    """The recorder derives a train/iteration span and phase children per
    iteration; the trace command merges them."""
    _, tpath = streams
    spans = [e for e in _lines(tpath) if e["event"] == "span"]
    its = [s for s in spans if s["name"] == "train/iteration"]
    assert [s["attrs"]["iteration"] for s in its] == [0, 1, 2, 3]
    kids = {s["parent_id"] for s in spans if s["name"].startswith("phase/")}
    assert kids <= {s["span_id"] for s in its}
    doc = port_trace.chrome_trace(
        port_trace.correct_clock_skew(spans) and spans)
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == \
        len(spans)


# ---- the metrics plane -------------------------------------------------

def _registry(cls):
    reg = cls()
    reg.counter("iterations").inc(3)
    reg.counter("fault_events", kind="nonfinite").inc()
    reg.gauge("hbm_bytes_in_use").set(1234)
    reg.gauge("hbm_bytes_in_use").set(1000)
    reg.histogram("phase_seconds", phase="tree_learner/grow").observe(0.25)
    reg.histogram("phase_seconds", phase="tree_learner/grow").observe(0.5)
    reg.counter("publish_total").inc(2)
    return reg


def test_openmetrics_render_and_parse_agree_with_jax():
    mine = port_export.render_openmetrics(_registry(MetricsRegistry)
                                          .snapshot())
    ref = jax_export.render_openmetrics(_registry(JaxRegistry).snapshot())
    assert mine == ref
    assert port_export.parse_openmetrics(mine) == \
        jax_export.parse_openmetrics(ref)
    parsed = port_export.parse_openmetrics(mine)
    assert parsed["lightgbm_tpu_iterations_total"][()] == 3
    assert parsed["lightgbm_tpu_hbm_bytes_in_use_max"][()] == 1234
    with pytest.raises(ValueError):
        port_export.parse_openmetrics("garbage\n# EOF\n")


def test_the_metrics_endpoint_serves_on_localhost():
    reg = _registry(MetricsRegistry)
    server = port_export.MetricsHTTPServer(0, registry=reg)
    try:
        url = f"http://127.0.0.1:{server.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
        parsed = port_export.parse_openmetrics(body)
        assert parsed["lightgbm_tpu_iterations_total"][()] == 3
        assert parsed["lightgbm_tpu_metrics_scrapes_total"][()] == 1
    finally:
        server.close()


def test_metrics_port_starts_the_processes_endpoint(monkeypatch):
    """``LIGHTGBM_TPU_METRICS_PORT`` (overriding ``metrics_port``) starts
    the one endpoint of the process, which serves the training's
    counters."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(port_export, "_server", None)
    monkeypatch.setenv("LIGHTGBM_TPU_METRICS_PORT", str(port))
    X, y = _binary()
    tlgb.train({**PARAMS, **CPU, "metrics_port": 1},
               tlgb.Dataset(X, label=y, params=CPU), 1,
               callbacks=[tlgb.telemetry(os.devnull)])
    server = port_export._server
    try:
        assert server is not None and server.port == port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            parsed = port_export.parse_openmetrics(resp.read().decode())
        assert parsed["lightgbm_tpu_iterations_total"][()] >= 1
    finally:
        server.close()


# ---- the phase timer and the captures ----------------------------------

def test_a_disabled_timed_section_is_the_shared_no_op(monkeypatch):
    monkeypatch.setattr(port_timer.Timer, "_enabled", False)
    assert port_timer.timed("tree_learner/grow") is port_timer._NULL
    monkeypatch.setattr(port_timer.Timer, "_enabled", True)
    assert port_timer.timed("tree_learner/grow") is not port_timer._NULL


def test_a_timed_section_names_a_range_in_a_profile(monkeypatch):
    monkeypatch.setattr(port_timer.Timer, "_enabled", False)
    from torch.profiler import profile
    with profile() as prof:
        with port_timer.timed("boosting/gradients"):
            torch.ones(4).sum()
    assert "boosting/gradients" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("spec,want", [
    ("d:iters=2-4", ("d", 2, 4)), ("a/b:iters=3", ("a/b", 3, 3))])
def test_xprof_specs_parse_like_jax(spec, want):
    from lightgbm_tpu.utils.timer import parse_xprof_spec
    assert port_timer.parse_xprof_spec(spec) == parse_xprof_spec(spec) \
        == want


@pytest.mark.parametrize("spec", ["d", "d:iters=x", "d:iters=4-2",
                                  ":iters=1"])
def test_bad_xprof_specs_raise(spec):
    with pytest.raises(ValueError):
        port_timer.parse_xprof_spec(spec)


def test_trace_to_captures_the_whole_loop(tmp_path, monkeypatch):
    d = tmp_path / "whole"
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE_TO", str(d))
    X, y = _binary()
    tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 2)
    files = list(d.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    names = [e.get("name") for e in json.load(open(files[0]))
             ["traceEvents"]]
    assert names.count("tree_learner/grow") == 2


def test_the_xprof_window_writes_a_chrome_trace(tmp_path, monkeypatch):
    d = tmp_path / "prof"
    monkeypatch.setenv("LIGHTGBM_TPU_XPROF", f"{d}:iters=1-1")
    X, y = _binary()
    tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 3)
    files = list(d.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    names = {e.get("name") for e in json.load(open(files[0]))
             ["traceEvents"]}
    assert "tree_learner/grow" in names
