"""The port's train -> publish -> serve loop (lightgbm_tpu_torch/
pipeline.py, resilience/elastic.py ``supervise``, the ``rank_kill`` fault
kind) held against the JAX package on the CPU.

- ``rank_kill``: the port's plan accepts it, fires it on the ranks of
  ``LIGHTGBM_TPU_FAULT_RANK`` as the JAX plan does (the port's rank is 0,
  as ``jax.process_index()`` is in a process that joined no world), in
  ``train`` at its iteration and in streaming ingest at -1 (``os.kill``
  is patched to raise).
- The pipeline's pure functions (``_split_faults``, ``_gen_data``,
  ``_auc`` with ties) give the JAX package's results.
- ``supervise``, one rank, with a ``python -c`` worker that imports
  neither package: it fails once and then succeeds, and both supervisors
  give the same exit code, logs and worker environment; a crash loop
  stops at the sliding window in both.
- The training worker of both packages, in process at 900 x 8 and 5
  rounds: generation 0, then generation 1 under ``append`` and under
  ``refit``. The published trees are equal in structure with leaf
  values to rtol=1e-4, atol=1e-5 (ROADMAP.md's standard), and the
  manifests' metadata are equal but for the sha, the size and the
  times.
- Fresh interpreters: ``launch --help`` and ``pipeline --help`` import
  no torch, and ``launch 2 -- cmd`` without ``--health-port`` raises
  naming ROADMAP.md Queue 1 item 20.
- One end-to-end pipeline on ``--device-type cpu`` (2 generations, one
  replica, 900 x 8, 3 rounds) under ``rank_kill@4,publish_torn@1,
  serve_kill@8``, held to the JAX package's chaos assertions. The JAX
  package's full-size chaos run, on the port, is marked slow, as it is
  there.

Each subprocess wait has its own timeout (at most 60 s).
"""

import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import tempfile
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import pipeline as jax_pipeline
from lightgbm_tpu.resilience import elastic as jax_elastic
from lightgbm_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from lightgbm_tpu_torch import pipeline as port_pipeline
from lightgbm_tpu_torch.data import GeneratorChunkSource
from lightgbm_tpu_torch.resilience import elastic as port_elastic
from lightgbm_tpu_torch.resilience import faults as port_faults
from lightgbm_tpu_torch.resilience.faults import FaultPlan
from lightgbm_tpu_torch.resilience.publisher import latest_manifest

REPO = Path(__file__).resolve().parent.parent
CPU = {"device_type": "cpu", "verbosity": -1}
WAIT_S = 60.0
ENV = ("LIGHTGBM_TPU_FAULT_INJECT", "LIGHTGBM_TPU_FAULT_RANK",
       "LIGHTGBM_TPU_CHECKPOINT", "LIGHTGBM_TPU_CHECKPOINT_EVERY",
       "LIGHTGBM_TPU_TELEMETRY", "LIGHTGBM_TPU_TRACE_CTX",
       "LIGHTGBM_TPU_RANK")


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
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    port_faults.drain_events(port_faults.FAULT_EVENTS)
    yield
    port_faults.drain_events(port_faults.FAULT_EVENTS)


class _Killed(Exception):
    """What the patched ``os.kill`` raises instead of killing."""


@pytest.fixture
def no_kill(monkeypatch):
    def kill(pid, sig):
        raise _Killed(sig)
    monkeypatch.setattr(os, "kill", kill)


# ---- rank_kill ----------------------------------------------------------

@pytest.mark.parametrize("ranks", [None, "0", "1", "0,1", "2,3"])
def test_rank_kill_fires_on_the_selected_ranks_like_jax(monkeypatch,
                                                        no_kill, ranks):
    if ranks is not None:
        monkeypatch.setenv("LIGHTGBM_TPU_FAULT_RANK", ranks)
    spec = "rank_kill@-1,rank_kill@3,nan_grad@2"
    fired = {}
    for name, plan in (("jax", JaxFaultPlan(spec)), ("port", FaultPlan(spec))):
        got = []
        for it in (-1, -1, 0, 3, 3):
            try:
                plan.maybe_distributed_fault(it)
                got.append(None)
            except _Killed as e:
                got.append(e.args[0])
        fired[name] = (got, plan.iters("rank_kill"))
    assert fired["port"] == fired["jax"]
    selected = ranks is None or "0" in ranks.split(",")
    kill = signal.SIGKILL if selected else None
    assert fired["port"][0] == [kill, None, None, kill, None]


def _binary(n=600, f=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    return X, (X[:, 0] + 0.3 * rs.randn(n) > 0).astype(float)


def test_rank_kill_fires_in_train_at_its_iteration(monkeypatch, no_kill):
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "rank_kill@2")
    X, y = _binary()
    done = []

    def after(env):
        done.append(env.iteration)

    with pytest.raises(_Killed):
        tlgb.train({"objective": "binary", "num_leaves": 7, **CPU},
                   tlgb.Dataset(X, label=y, params=CPU), 5,
                   callbacks=[after])
    assert done == [0, 1]
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_RANK", "1")
    bst = tlgb.train({"objective": "binary", "num_leaves": 7, **CPU},
                     tlgb.Dataset(X, label=y, params=CPU), 5)
    assert bst.num_trees() == 5


def test_rank_kill_fires_in_streaming_ingest(monkeypatch, no_kill):
    """``rank_kill@-1`` fires in the streamed construct (after pass 1)
    and not in an eager one, as in the JAX package."""
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "rank_kill@-1")
    X, y = _binary()
    params = {**CPU, "ingest_chunk_rows": 128}

    def source():
        return GeneratorChunkSource(
            lambda: ((X[i:i + 128], y[i:i + 128])
                     for i in range(0, len(y), 128)), num_rows=len(y))

    with pytest.raises(_Killed):
        tlgb.Dataset(source(), params=params).construct()
    assert tlgb.Dataset(X, label=y, params=CPU).construct().num_data() \
        == len(y)
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_RANK", "1")
    assert tlgb.Dataset(source(), params=params).construct().num_data() \
        == len(y)


# ---- the pipeline's pure functions --------------------------------------

@pytest.mark.parametrize("spec", [
    "serve_kill@25, rank_kill@8,publish_torn@1,refit_nan@2",
    "rank_kill@7,publish_torn@1,serve_kill@12", "store_outage@1", "", None])
def test_split_faults_matches_jax(spec):
    assert port_pipeline._split_faults(spec) == \
        jax_pipeline._split_faults(spec)


@pytest.mark.parametrize("seed,gen,rows,features",
                         [(7, 0, 900, 8), (7, 2, 333, 28), (3, 1, 50, 5)])
def test_gen_data_is_the_jax_draw(seed, gen, rows, features):
    Xp, yp = port_pipeline._gen_data(seed, gen, rows, features)
    Xj, yj = jax_pipeline._gen_data(seed, gen, rows, features)
    assert np.array_equal(Xp, Xj) and np.array_equal(yp, yj)
    assert Xp.dtype == np.float64 and Xp.shape == (rows, features)


@pytest.mark.parametrize("case", ["ties", "no_ties", "one_class"])
def test_auc_matches_jax(case):
    rs = np.random.RandomState(4)
    y = (rs.rand(400) > 0.4).astype(float)
    s = {"ties": np.round(rs.randn(400), 1),
         "no_ties": rs.randn(400) + y,
         "one_class": rs.randn(400)}[case]
    if case == "one_class":
        y = np.ones(400)
    assert port_pipeline._auc(y, s) == jax_pipeline._auc(y, s)
    if case == "ties":
        assert len(np.unique(s)) < len(s)


# ---- supervise: one rank ------------------------------------------------

# a worker that imports neither package: it records what the supervisor
# exported and fails in its first life
WORKER = r"""
import json, os, sys
keys = ("LIGHTGBM_TPU_NUM_PROCS", "LIGHTGBM_TPU_RANK",
        "LIGHTGBM_TPU_RESTART_COUNT", "LIGHTGBM_TPU_FAULT_INJECT",
        "LIGHTGBM_TPU_CHECKPOINT")
with open(sys.argv[1], "a") as fh:
    fh.write(json.dumps({k: os.environ.get(k) for k in keys}) + "\n")
sys.exit(3 if os.environ["LIGHTGBM_TPU_RESTART_COUNT"] == "0" else 0)
"""


def _worker_base_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIGHTGBM_TPU_")}
    env["LIGHTGBM_TPU_FAULT_INJECT"] = "rank_kill@3,nan_grad@2,serve_kill@1"
    env["LIGHTGBM_TPU_CHECKPOINT"] = "/ckpt/g0001"
    return env


def test_supervise_restarts_a_one_rank_world_like_jax(tmp_path):
    runs = {}
    for name, mod in (("jax", jax_elastic), ("port", port_elastic)):
        out = tmp_path / f"{name}.jsonl"
        logs = tmp_path / f"{name}_logs"
        rc = mod.supervise(1, [sys.executable, "-c", WORKER, str(out)],
                           max_restarts=3, log_dir=str(logs), grace=0.5,
                           env=_worker_base_env())
        runs[name] = (rc, sorted(os.listdir(logs)),
                      [json.loads(ln) for ln in out.read_text().split("\n")
                       if ln])
    assert runs["port"] == runs["jax"]
    rc, logs, lives = runs["port"]
    assert rc == 0
    assert logs == ["elastic_g0_rank0.log", "elastic_g1_rank0.log"]
    assert [life["LIGHTGBM_TPU_FAULT_INJECT"] for life in lives] == [
        "rank_kill@3,nan_grad@2,serve_kill@1", "nan_grad@2"]
    assert {life["LIGHTGBM_TPU_CHECKPOINT"] for life in lives} == \
        {"/ckpt/g0001"}


def test_supervise_respects_sliding_window(tmp_path):
    """A crash-looping world stops at the window cap, well before the
    total budget, in both packages alike."""
    runs = {}
    for name, mod in (("jax", jax_elastic), ("port", port_elastic)):
        logs = tmp_path / name
        rc = mod.supervise(
            1, [sys.executable, "-c", "raise SystemExit(7)"],
            max_restarts=50, log_dir=str(logs), grace=0.5,
            max_restarts_per_window=2, restart_window_sec=3600.0)
        runs[name] = (rc, sorted(os.listdir(logs)))
    assert runs["port"] == runs["jax"] == (
        7, ["elastic_g0_rank0.log", "elastic_g1_rank0.log",
            "elastic_g2_rank0.log"])


# ---- the training worker ------------------------------------------------

WORKER_ARGS = ["--rows", "900", "--features", "8", "--rounds", "5"]


def _run_worker(mod, workdir, gen, warm):
    extra = ["--device-type", "cpu"] if mod is port_pipeline else []
    args = mod.build_parser().parse_args(
        ["--workdir", str(workdir), "--train-worker", str(gen),
         "--warm-start", warm, *WORKER_ARGS, *extra])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod._train_worker(args) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["event"] == "published" and line["generation"] == gen
    return latest_manifest(os.path.join(str(workdir), "publish"))


@pytest.fixture(scope="module")
def generation0(tmp_path_factory):
    """Generation 0 of both packages' workers, in workdirs of their own."""
    root = tmp_path_factory.mktemp("gen0")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ENV:
            mp.delenv(name, raising=False)
        for name, mod in (("jax", jax_pipeline), ("port", port_pipeline)):
            out[name] = (root / name,
                         _run_worker(mod, root / name, 0, "none"))
    return out


def _same_published_model(jax_pub, port_pub):
    (jpath, jman), (tpath, tman) = jax_pub, port_pub
    ja = jlgb.Booster(model_file=jpath)
    tb = tlgb.Booster(model_file=tpath, params=CPU)
    assert len(ja._models) == len(tb._models) > 0
    for a, b in zip(ja._models, tb._models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count",
                     "internal_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    # the metadata; the sha, the size (the parameters block of the model
    # text differs), the time and the trace ids are the run's own
    own = {"sha256", "bytes", "created_unix", "trace", "canary"}
    assert {k: v for k, v in tman.items() if k not in own} == \
        {k: v for k, v in jman.items() if k not in own}
    assert tman["canary"]["rows"] == jman["canary"]["rows"]
    assert tman["canary"]["tol"] == jman["canary"]["tol"]
    np.testing.assert_allclose(tman["canary"]["scores"],
                               jman["canary"]["scores"], rtol=1e-4,
                               atol=1e-5)
    return tman


def test_train_worker_generation0_matches_jax(generation0):
    man = _same_published_model(generation0["jax"][1],
                                generation0["port"][1])
    assert man["generation"] == 0 and man["warm_start"] == "none"
    assert man["num_trees"] == 5 and man["train_auc"] > 0.9


@pytest.mark.parametrize("warm", ["append", "refit"])
def test_train_worker_warm_start_matches_jax(generation0, tmp_path, warm):
    pubs = {}
    for name, mod in (("jax", jax_pipeline), ("port", port_pipeline)):
        work = tmp_path / name
        shutil.copytree(generation0[name][0], work)
        pubs[name] = _run_worker(mod, work, 1, warm)
    man = _same_published_model(pubs["jax"], pubs["port"])
    assert man["generation"] == 1 and man["warm_start"] == warm
    assert man["num_trees"] == 10
    assert (man["refit_auc"] is None) == (warm == "append")


# ---- fresh interpreters -------------------------------------------------

FRESH = {
    "launch_help": ("launch", ["--help"], "rc == 0 and 'usage: python -m "
                    "lightgbm_tpu_torch launch' in out"),
    "pipeline_help": ("pipeline", ["--help"], "rc == 0 and 'usage: python "
                      "-m lightgbm_tpu_torch pipeline' in out"),
    # a world of two ranks: the supervisor spawns them without torch
    # (here a worker command that does not exist)
    "launch_world": ("launch", ["2", "--log-dir", os.path.join(
        tempfile.gettempdir(), "lgbm_torch_launch_world"), "--",
        "no-such-worker-command"], "isinstance(err, FileNotFoundError)"),
}


@pytest.mark.parametrize("case", sorted(FRESH))
def test_supervisors_import_no_torch(case):
    """``python -m lightgbm_tpu_torch launch | pipeline`` in a fresh
    interpreter: what they print, and that torch stayed unloaded."""
    sub, argv, check = FRESH[case]
    code = f"""
import contextlib, io, runpy, sys
sys.argv = ["lightgbm_tpu_torch", {sub!r}, *{argv!r}]
rc = err = None
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    try:
        runpy.run_module("lightgbm_tpu_torch", run_name="__main__")
    except SystemExit as e:
        rc = e.code
    except Exception as e:
        err = e
out = buf.getvalue()
assert {check}, (rc, err, out[-500:])
assert "torch" not in sys.modules and "jax" not in sys.modules
print("CLEAN")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=WAIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLEAN" in proc.stdout


# ---- end to end on the CPU ----------------------------------------------

def _pipeline(tmp_path, faults, args, timeout):
    workdir = str(tmp_path / "pipe")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIGHTGBM_TPU_")}
    env["PYTHONPATH"] = str(REPO)
    env["LIGHTGBM_TPU_FAULT_INJECT"] = faults
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "pipeline",
         "--device-type", "cpu", "--workdir", workdir, *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(REPO), start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        port_elastic._kill_group(proc)
        out, _ = proc.communicate(timeout=30)
        pytest.fail(f"pipeline hung; partial output:\n{out[-4000:]}")
    assert proc.returncode == 0, f"pipeline failed:\n{out[-6000:]}"
    summary = None
    for line in out.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("event") == "pipeline_summary":
            summary = obj
    assert summary is not None, out[-4000:]
    return workdir, summary


def _faults_in(path):
    with open(path) as fh:
        events = [json.loads(ln) for ln in fh if ln.strip()]
    return events, {e.get("kind") for e in events
                    if e.get("event") == "fault"}


def _hold_to_the_chaos_run(workdir, summary, generations):
    """The JAX package's assertions on its chaos pipeline."""
    last = generations - 1
    assert summary["failures"] == []
    assert summary["generations_published"] == generations
    assert summary["swaps_confirmed"] == generations - 1
    fleet = summary["fleet"]
    assert fleet and all(st is not None for st in fleet)
    for st in fleet:
        assert st["manifest_sha256"] == summary["last_published_sha256"]
        assert st["model_source"].endswith(f"model_g{last:04d}.txt")
    client = summary["client"]
    assert client["timeout"] == 0 and client["ok"] > 0, client
    assert client["conn"] >= 1, client
    assert client["max_ok_gap_s"] < 60.0, client
    telem = os.path.join(workdir, "telemetry")
    _, serve_kinds = _faults_in(os.path.join(telem, "serve.jsonl"))
    assert "swap_failure" in serve_kinds, serve_kinds
    events, train_kinds = _faults_in(os.path.join(telem,
                                                  "train_g0001.jsonl"))
    assert "publish_torn" in train_kinds, train_kinds
    assert sum(e.get("event") == "publish" for e in events) == 1
    assert os.path.exists(os.path.join(workdir, "logs", "train_g0001",
                                       "elastic_g1_rank0.log"))
    assert "elastic_g1_rank0.log" in os.listdir(
        os.path.join(workdir, "logs", "fleet"))


def test_pipeline_chaos_on_the_cpu(tmp_path):
    """Generation 1 is killed at iteration 4 (generation 0 trains 0-2)
    and resumes, its first publication is torn, and the replica dies at
    its 8th request and is relaunched; the loop still ends with every
    replica on the last publication and no request lost."""
    workdir, summary = _pipeline(
        tmp_path, "rank_kill@4,publish_torn@1,serve_kill@8",
        ["--generations", "2", "--rounds", "3", "--rows", "900",
         "--features", "8", "--request-rate", "15", "--request-rows", "4",
         "--health-interval", "0.5", "--health-grace", "25",
         "--swap-timeout", "40", "--grace", "5",
         "--param", "publish_backoff_sec=2"], WAIT_S)
    _hold_to_the_chaos_run(workdir, summary, 2)


@pytest.mark.slow
def test_pipeline_chaos_end_to_end(tmp_path):
    """``tests/test_pipeline.py::test_pipeline_chaos_end_to_end`` at its
    sizes, on the port: 3 generations under ``rank_kill@7,
    publish_torn@1,serve_kill@12``."""
    workdir, summary = _pipeline(
        tmp_path, "rank_kill@7,publish_torn@1,serve_kill@12",
        ["--generations", "3", "--rounds", "5", "--rows", "900",
         "--features", "8", "--request-rate", "15", "--request-rows", "4",
         "--health-interval", "0.5", "--health-grace", "25",
         "--swap-timeout", "240", "--grace", "10",
         "--param", "publish_backoff_sec=2"], 800)
    _hold_to_the_chaos_run(workdir, summary, 3)
    tr = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "trace",
         os.path.join(workdir, "telemetry")],
        capture_output=True, text=True, timeout=WAIT_S, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert tr.returncode == 0, tr.stderr[-3000:]
    assert "critical path" in tr.stdout, tr.stdout
