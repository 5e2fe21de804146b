"""Supervised restarts: ``python -m lightgbm_tpu_torch launch``. A copy of
``lightgbm_tpu/resilience/elastic.py`` with its environment variables,
log names and JSONL events.

Two supervision shapes:

- **World restart** (:func:`supervise`, the training shape): the ranks
  form one world, so the first nonzero exit kills the rest and the
  whole world is relaunched; with ``LIGHTGBM_TPU_CHECKPOINT`` exported
  (or ``--checkpoint-dir``) every relaunch resumes from the newest
  snapshot, so the restarted run ends on the model an uninterrupted
  one gives. Each rank's worker joins the world with a bare
  ``parallel.distributed.init_distributed()`` (the exported
  ``LIGHTGBM_TPU_COORDINATOR`` / ``_NUM_PROCS`` / ``_RANK``); one rank
  is a supervised single-process run, which is what ``pipeline`` trains
  each generation under::

      python -m lightgbm_tpu_torch launch 4 --checkpoint-dir ckpt -- python train.py

- **Fleet restart** (:func:`supervise_fleet`, ``--health-port``; the
  serving shape): the ranks are independent replicas, so only the dead
  one is relaunched while the others keep answering. The supervisor
  pings each replica through the daemon's own ``{"cmd": "ping"}`` on
  ``health_port + rank``; a replica that is alive but wedged fails
  ``--health-fails`` pings in a row and is killed and relaunched. With
  ``--max-replicas`` the fleet grows and shrinks: an
  :class:`~.autoscale.AutoscalePolicy` fed by the scrape thread spawns
  replicas under load and retires the highest rank with a SIGTERM drain
  when traffic subsides; with ``--publish-dir`` a
  :class:`~.autoscale.RollbackGuard` rolls the store back to
  last-known-good when the fleet's canary gates refuse the newest
  publication or a replica that swapped onto it fails its pings::

      python -m lightgbm_tpu_torch launch 2 --health-port 8800 -- \
          python -m lightgbm_tpu_torch serve models/ --port 8800

Both shapes draw restarts from one :class:`RestartBudget`: a total cap
(``--max-restarts``) and an optional sliding window
(``--max-restarts-per-window`` within ``--restart-window`` seconds), and
each restart waits out a jittered exponential backoff (0.5 s doubling
per consecutive failure, capped at 15 s), counted in the
``supervisor_restarts`` and ``supervisor_backoff_seconds`` registry
counters. One-shot injected faults (``rank_kill``, ``stall_rank``,
``serve_kill``) are stripped from a relaunch's environment.

This module imports no torch: the supervisor outlives the workers it
restarts and must not hold a CUDA context the workers need.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..log import log_info, log_warning

__all__ = ["main", "supervise", "supervise_fleet", "worker_env",
           "strip_one_shot_faults", "RestartBudget", "replica_ping",
           "replica_rpc", "fleet_telemetry_path"]

#: fault kinds that must not re-fire after a supervised restart —
#: the one_shot classification of obs/schemas.py FAULT_KINDS
from ..obs.schemas import one_shot_fault_kinds as _one_shot_kinds

_ONE_SHOT_KINDS = _one_shot_kinds()

_POLL_SECONDS = 0.2

#: jittered exponential backoff shape between restarts (the JAX
#: package's init_distributed retry curve)
_BACKOFF_BASE_SEC = 0.5
_BACKOFF_CAP_SEC = 15.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL a worker's whole process group (workers run in their own
    session); fall back to killing the process alone."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass


from ..obs.registry import bump_counter as _count


class RestartBudget:
    """Total + sliding-window restart admission, with the jittered
    exponential backoff delay to respect before each admitted restart.

    ``admit()`` returns None when a restart may proceed (recording it
    against both budgets) or a human-readable refusal. ``backoff()``
    returns the pre-restart delay for the ``consecutive``-th failure
    in a row and counts it in ``supervisor_backoff_seconds``.
    """

    def __init__(self, max_restarts: int,
                 max_per_window: int = 0,
                 window_sec: float = 300.0,
                 backoff_base_sec: float = _BACKOFF_BASE_SEC,
                 _now=time.monotonic,
                 _rng: Optional[random.Random] = None):
        self.max_restarts = int(max_restarts)
        self.max_per_window = int(max_per_window)
        self.window_sec = float(window_sec)
        self.backoff_base_sec = float(backoff_base_sec)
        self.total = 0
        self._times: deque = deque()
        self._now = _now
        self._rng = _rng if _rng is not None else random.Random()

    def admit(self) -> Optional[str]:
        now = self._now()
        if self.total >= self.max_restarts:
            return f"the total restart budget ({self.max_restarts}) " \
                   "is spent"
        if self.max_per_window > 0:
            while self._times and now - self._times[0] > self.window_sec:
                self._times.popleft()
            if len(self._times) >= self.max_per_window:
                return (f"{len(self._times)} restarts within the last "
                        f"{self.window_sec:g}s sliding window "
                        f"(--max-restarts-per-window "
                        f"{self.max_per_window}) — this is a crash "
                        "loop, not a transient fault")
        self.total += 1
        self._times.append(now)
        _count("supervisor_restarts")
        return None

    def backoff(self, consecutive: int) -> float:
        """Jittered exponential delay before the ``consecutive``-th
        restart in a row (1-based): base x 2^(n-1), capped, x[0.5,
        1.5) jitter so simultaneously-restarting supervisors do not
        stampede one coordinator/port."""
        exp = max(0, int(consecutive) - 1)
        delay = min(_BACKOFF_CAP_SEC, self.backoff_base_sec * (2 ** exp))
        delay *= 0.5 + self._rng.random()
        _count("supervisor_backoff_seconds", delay)
        return delay


def replica_rpc(port: int, obj: Dict, timeout: float = 5.0,
                host: str = "127.0.0.1") -> Optional[Dict]:
    """One request -> one reply against a serve replica's JSON-lines
    protocol; None on any transport/parse failure, never an exception
    — the callers are supervision/polling loops."""
    try:
        with socket.create_connection((host, port),
                                      timeout=timeout) as s:
            s.settimeout(timeout)
            s.sendall((json.dumps(obj) + "\n").encode("utf-8"))
            fh = s.makefile("r", encoding="utf-8")
            line = fh.readline()
        out = json.loads(line)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def replica_ping(port: int, timeout: float = 5.0,
                 host: str = "127.0.0.1") -> bool:
    """One health probe: the daemon's ``{"cmd": "ping"}`` answered
    with ``ok``."""
    reply = replica_rpc(port, {"cmd": "ping"}, timeout=timeout,
                        host=host)
    return bool(reply and reply.get("ok"))


class _FleetTelemetry:
    """Append-only JSONL writer for the supervisor's ``{"event":
    "fleet"}`` scrape records. The fleet supervisor's SCRAPE thread
    and its main supervision loop (autoscale / rollback events) both
    write, so the file handle sits under a lock — interleaved partial
    lines would corrupt the stream. An unwritable path degrades to
    registry-only scraping, mirroring the recorder's contract."""

    def __init__(self, path: Optional[str]):
        self._lock = threading.Lock()
        # ---- guarded by self._lock ----
        self._file = None
        if not path:
            return
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._file = open(path, "a", encoding="utf-8")
        except OSError as e:
            log_warning(f"elastic: cannot open fleet telemetry "
                        f"{path!r} ({e}); fleet events will not be "
                        "written")

    def write(self, event: Dict) -> None:
        line = json.dumps(event) + "\n"
        with self._lock:
            if self._file is None:
                return
            try:
                self._file.write(line)
                self._file.flush()
            except OSError:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


def _drain_spans_into(telem: "_FleetTelemetry") -> None:
    """Restart spans (obs/trace.py) recorded by the supervision loop
    ride its fleet stream on the scrape cadence, like the scrape
    records themselves. Without a stream the spans stay buffered
    (capped) for an embedding caller — the pipeline supervisor calls
    :func:`supervise` in-process and drains into its own event log."""
    if telem._file is None:
        return
    try:
        from ..obs.trace import drain_span_events
        for ev in drain_span_events():
            telem.write(ev)
    except Exception:
        pass


def fleet_telemetry_path(env: Optional[Dict[str, str]] = None) \
        -> Optional[str]:
    """Where a supervisor writes its scrape records: the run's
    telemetry stream (from ``env``, default ``os.environ``) with a
    ``.fleet`` suffix — the serve replicas own the base path (rank 0)
    and its ``.rankN`` suffixes, and ``lightgbm_tpu_torch stats <dir>
    --fleet`` merges all of them."""
    base = (os.environ if env is None else env).get(
        "LIGHTGBM_TPU_TELEMETRY")
    return f"{base}.fleet" if base else None


#: replica-row field <- OpenMetrics sample of the replica's metrics
#: render (serve/daemon.py metrics_families + its registry counters)
_REPLICA_SAMPLES = (
    ("qps", "lightgbm_tpu_serve_qps"),
    ("p50_ms", "lightgbm_tpu_serve_p50_ms"),
    ("p99_ms", "lightgbm_tpu_serve_p99_ms"),
    ("requests_total", "lightgbm_tpu_serve_requests_total"),
    ("rows_total", "lightgbm_tpu_serve_rows_total"),
    ("shed_total", "lightgbm_tpu_serve_shed_total"),
    ("swaps_total", "lightgbm_tpu_serve_swaps_total"),
    ("swap_failures_total", "lightgbm_tpu_serve_swap_failures_total"),
)


def _replica_metrics_row(port: int, timeout: float) -> Dict:
    """One replica's scrape via the NON-consuming ``{"cmd":
    "metrics"}`` verb — ``{"cmd": "stats"}`` would reset the daemon's
    own qps rate window and steal its recompile deltas (the daemon
    caches its last stats window precisely so metrics reads never
    consume it). Empty dict on any failure."""
    from ..obs.export import parse_openmetrics
    reply = replica_rpc(port, {"cmd": "metrics"}, timeout=timeout)
    if not reply or not reply.get("ok"):
        return {}
    try:
        samples = parse_openmetrics(reply["metrics"])
    except (KeyError, TypeError, ValueError):
        return {}
    row: Dict = {}
    for key, name in _REPLICA_SAMPLES:
        fam = samples.get(name)
        if fam:
            row[key] = next(iter(fam.values()))
    info = samples.get("lightgbm_tpu_serve_model_info")
    if info:
        labels = dict(next(iter(info.keys())))
        if labels.get("model"):
            row["model"] = labels["model"]
        if labels.get("sha"):
            row["sha256"] = labels["sha"]
    return row


def _scrape_fleet(fleet: List["_Replica"], health_port: Optional[int],
                  health_timeout: float) -> Dict:
    """One scrape round over the replica fleet: liveness + restart
    generation from the supervisor's own bookkeeping, QPS/p99/shed
    from each live replica's ``{"cmd": "metrics"}`` protocol verb.
    Feeds the supervisor's registry (its /metrics endpoint) and
    returns the ``{"event": "fleet"}`` record.

    Per-replica fetches run CONCURRENTLY: a wedged replica — one that
    accepts TCP but never replies — costs one ``health_timeout`` in
    its own fetch thread, not one per healthy replica queued behind it
    in a serial round. A replica whose process is up but whose metrics
    fetch failed or timed out is marked ``alive: false`` (with
    ``responsive: false``): "alive" in a fleet record means SERVING,
    and a silent socket is not serving."""
    from ..obs.registry import registry
    live: List = []
    results: Dict[int, Dict] = {}
    results_lock = threading.Lock()
    fetchers: List[threading.Thread] = []
    for rep in fleet:
        alive = (not rep.done and rep.relaunch_at is None
                 and rep.proc is not None and rep.proc.poll() is None)
        live.append((rep, alive))
        if alive and health_port is not None:
            def _fetch(rank: int = rep.rank) -> None:
                row = _replica_metrics_row(health_port + rank,
                                           health_timeout)
                with results_lock:
                    results[rank] = row
            t = threading.Thread(target=_fetch, daemon=True)
            t.start()
            fetchers.append(t)
    deadline = time.monotonic() + health_timeout + 1.0
    for t in fetchers:
        t.join(timeout=max(0.1, deadline - time.monotonic()))
    replicas = []
    restarts_total = 0
    for rep, alive in live:
        row: Dict = {"rank": rep.rank, "alive": alive,
                     "restarts": rep.generation}
        if rep.retiring:
            row["retiring"] = True
        restarts_total += rep.generation
        if alive and health_port is not None:
            with results_lock:
                metrics = results.get(rep.rank)
            if metrics:
                row.update(metrics)
            else:
                row["alive"] = False
                row["responsive"] = False
        replicas.append(row)
        try:
            labels = {"rank": rep.rank}
            registry.gauge("fleet_replica_up", **labels).set(
                1.0 if row["alive"] else 0.0)
            registry.gauge("fleet_replica_restarts", **labels).set(
                rep.generation)
            for key, fam in (("qps", "fleet_replica_qps"),
                             ("p99_ms", "fleet_replica_p99_ms"),
                             ("shed_total", "fleet_replica_shed")):
                if row.get(key) is not None:
                    registry.gauge(fam, **labels).set(row[key])
        except Exception:
            pass                  # telemetry must never kill the loop
    return {"event": "fleet", "shape": "replicas",
            "replicas": replicas, "restarts_total": restarts_total,
            "time": time.time()}


def _scrape_world_ranks(nprocs: int, worker_metrics_base: int,
                        timeout: float = 2.0) -> Optional[Dict]:
    """One scrape round over a TRAINING world's per-rank /metrics
    endpoints (rank r binds ``worker_metrics_base + r``): per-rank
    iteration/recompile counts and the cross-rank iteration skew —
    the straggler signal chip-level phase aggregation cannot see once
    a rank's process is wedged. An unreachable endpoint — a wedged
    rank, or a bind failure — is exactly the condition this scrape
    exists to surface, so it records an ``alive: false`` row instead
    of silently shrinking the rank list. None when NO endpoint
    answered (nothing to distinguish 'all wedged' from 'metrics not
    up yet' on the first cadence)."""
    import urllib.request

    from ..obs.export import parse_openmetrics
    from ..obs.registry import registry
    ranks = []
    iterations = []
    any_alive = False
    for rank in range(nprocs):
        url = (f"http://127.0.0.1:{worker_metrics_base + rank}"
               "/metrics")
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                samples = parse_openmetrics(
                    resp.read().decode("utf-8"))
        except (OSError, ValueError):
            ranks.append({"rank": rank, "alive": False})
            try:
                registry.gauge("fleet_rank_up", rank=rank).set(0.0)
            except Exception:
                pass
            continue

        def sample(name: str) -> Optional[float]:
            fam = samples.get("lightgbm_tpu_" + name)
            if not fam:
                return None
            return next(iter(fam.values()))

        any_alive = True
        row: Dict = {"rank": rank, "alive": True}
        for key, metric in (("iterations", "iterations_total"),
                            ("recompiles", "jit_recompiles_total"),
                            ("hbm_bytes_in_use", "hbm_bytes_in_use")):
            value = sample(metric)
            if value is not None:
                row[key] = value
        ranks.append(row)
        try:
            registry.gauge("fleet_rank_up", rank=rank).set(1.0)
        except Exception:
            pass
        if row.get("iterations") is not None:
            iterations.append(row["iterations"])
            try:
                registry.gauge("fleet_rank_iterations",
                               rank=rank).set(row["iterations"])
            except Exception:
                pass
    if not any_alive:
        return None
    skew = int(max(iterations) - min(iterations)) if iterations \
        else None
    if skew is not None:
        try:
            registry.gauge("fleet_iteration_skew").set(skew)
        except Exception:
            pass
    return {"event": "fleet", "shape": "world", "nprocs": nprocs,
            "ranks": ranks, "iteration_skew": skew,
            "time": time.time()}


def strip_one_shot_faults(spec: str) -> str:
    """Drop ``rank_kill``/``stall_rank``/``serve_kill`` tokens from a
    ``LIGHTGBM_TPU_FAULT_INJECT`` value for a relaunch."""
    kept = [tok for tok in spec.split(",")
            if tok.strip()
            and tok.split("@", 1)[0].strip() not in _ONE_SHOT_KINDS]
    return ",".join(kept)


def worker_env(base: Dict[str, str], rank: int, nprocs: int,
               port: int, generation: int = 0) -> Dict[str, str]:
    """The per-rank environment one generation of workers runs with."""
    env = dict(base)
    env["LIGHTGBM_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
    env["LIGHTGBM_TPU_NUM_PROCS"] = str(nprocs)
    env["LIGHTGBM_TPU_RANK"] = str(rank)
    env["LIGHTGBM_TPU_RESTART_COUNT"] = str(generation)
    if generation > 0 and env.get("LIGHTGBM_TPU_FAULT_INJECT"):
        env["LIGHTGBM_TPU_FAULT_INJECT"] = strip_one_shot_faults(
            env["LIGHTGBM_TPU_FAULT_INJECT"])
    return env


def _launch_generation(cmd: Sequence[str], nprocs: int, port: int,
                       generation: int, log_dir: str,
                       base_env: Dict[str, str]) -> List[subprocess.Popen]:
    procs = []
    try:
        for rank in range(nprocs):
            log_path = os.path.join(
                log_dir, f"elastic_g{generation}_rank{rank}.log")
            log_file = open(log_path, "ab")
            try:
                procs.append(subprocess.Popen(
                    list(cmd),
                    env=worker_env(base_env, rank, nprocs, port,
                                   generation),
                    stdout=log_file, stderr=subprocess.STDOUT,
                    start_new_session=True))
            finally:
                log_file.close()   # the child holds its own fd now
    except BaseException:
        # a mid-loop failure (EMFILE, deleted log dir) must not leave
        # the already-spawned ranks orphaned, waiting on peers that
        # will never come up
        for p in procs:
            _kill_group(p)
        raise
    return procs


def _wait_generation(procs: List[subprocess.Popen],
                     grace: float,
                     on_poll=None) -> int:
    """Block until the generation resolves: 0 when every rank exited
    cleanly, else the first nonzero exit code (the rest of the world is
    killed after ``grace`` seconds — survivors are either hung in a
    collective or about to watchdog-abort; their state is already
    checkpointed). ``on_poll`` (optional zero-arg callable) runs once
    per poll round — the metrics scrape cadence rides the existing
    supervision loop instead of a thread."""
    while True:
        if on_poll is not None:
            on_poll()
        first_bad: Optional[subprocess.Popen] = None
        alive = 0
        for p in procs:
            rc = p.poll()
            if rc is None:
                alive += 1
            elif rc != 0 and first_bad is None:
                first_bad = p
        if first_bad is not None:
            rank = procs.index(first_bad)
            rc = first_bad.returncode
            log_warning(f"elastic: rank {rank} exited with code "
                        f"{rc}; stopping the world")
            deadline = time.monotonic() + max(0.0, grace)
            while time.monotonic() < deadline and any(
                    p.poll() is None for p in procs):
                time.sleep(_POLL_SECONDS)
            for p in procs:
                if p.poll() is None:
                    _kill_group(p)
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    _kill_group(p)
            # signal deaths carry a NEGATIVE returncode; surface them
            # shell-style (128+signum) so SystemExit doesn't truncate
            # -9 into an unrelated 247
            return (128 - rc) if rc and rc < 0 else (rc or 1)
        if alive == 0:
            return 0
        time.sleep(_POLL_SECONDS)


def supervise(nprocs: int, cmd: Sequence[str], max_restarts: int = 3,
              port: Optional[int] = None, log_dir: str = ".",
              grace: float = 5.0,
              env: Optional[Dict[str, str]] = None,
              max_restarts_per_window: int = 0,
              restart_window_sec: float = 300.0,
              metrics_port: Optional[int] = None,
              scrape_interval: float = 0.0) -> int:
    """Run ``cmd`` as an ``nprocs``-rank world under supervision;
    returns the final exit code (0 = a generation completed cleanly).

    Each generation gets a fresh coordinator port — the previous
    coordinator died with its rank-0 worker, and its socket may linger
    in TIME_WAIT. Worker output goes to
    ``{log_dir}/elastic_g{generation}_rank{rank}.log``. Restarts draw
    from a :class:`RestartBudget` (total cap + optional sliding
    window) and each one waits out a jittered exponential backoff so
    a crash-looping world cannot thrash coordinator ports at full
    speed.
    """
    if nprocs < 1:
        raise ValueError("nprocs must be >= 1")
    if not cmd:
        raise ValueError("no worker command given (pass it after --)")
    base_env = dict(os.environ if env is None else env)
    os.makedirs(log_dir, exist_ok=True)
    budget = RestartBudget(max_restarts, max_restarts_per_window,
                           restart_window_sec)
    # fleet metrics plane (docs/OBSERVABILITY.md): the supervisor
    # serves its own torch-free /metrics at the base port, workers bind
    # base+1+rank (engine.py reads LIGHTGBM_TPU_METRICS_PORT and adds
    # its rank), and the supervision loop scrapes the rank endpoints
    # into {"event": "fleet"} records carrying the iteration skew
    if metrics_port:
        from ..obs.export import ensure_metrics_server
        ensure_metrics_server(metrics_port)
        base_env["LIGHTGBM_TPU_METRICS_PORT"] = str(metrics_port + 1)
    # world-shape scraping reads the rank /metrics endpoints, so it
    # needs metrics_port; without it the .fleet file must not even be
    # created (an empty stray artifact per run otherwise)
    telem = _FleetTelemetry(
        fleet_telemetry_path(base_env)
        if scrape_interval > 0 and metrics_port else None)
    next_scrape = time.monotonic() + max(0.0, scrape_interval)

    def _poll_scrape() -> None:
        nonlocal next_scrape
        if scrape_interval <= 0 or not metrics_port:
            return
        now = time.monotonic()
        if now < next_scrape:
            return
        next_scrape = now + scrape_interval
        event = _scrape_world_ranks(nprocs, metrics_port + 1)
        if event is not None:
            telem.write(event)
        _drain_spans_into(telem)

    generation = 0
    consecutive = 0
    while True:
        gen_port = port if port else _free_port()
        log_info(f"elastic: generation {generation}: launching "
                 f"{nprocs} rank(s), coordinator 127.0.0.1:{gen_port}")
        procs = _launch_generation(cmd, nprocs, gen_port, generation,
                                   log_dir, base_env)
        try:
            rc = _wait_generation(procs, grace,
                                  on_poll=_poll_scrape)
        except BaseException:   # ctrl-C etc.: never leak a world
            for p in procs:
                if p.poll() is None:
                    _kill_group(p)
            telem.close()
            raise
        if rc == 0:
            log_info(f"elastic: generation {generation} completed "
                     "cleanly")
            telem.close()
            return 0
        refusal = budget.admit()
        if refusal is not None:
            log_warning(
                f"elastic: generation {generation} failed (exit {rc}) "
                f"and {refusal} — giving up")
            telem.close()
            return rc
        generation += 1
        consecutive += 1
        try:
            from ..obs.registry import registry
            registry.counter("elastic_restarts").inc()
        except Exception:
            pass
        delay = budget.backoff(consecutive)
        log_info(f"elastic: restarting the world (restart {generation}"
                 f"/{max_restarts}) in {delay:.2f}s; training resumes "
                 "from the newest checkpoint if LIGHTGBM_TPU_CHECKPOINT "
                 "is set")
        t_restart = time.perf_counter()
        time.sleep(delay)
        try:
            # the restart's backoff IS lifecycle latency: span it so
            # the merged trace shows where a chaos-killed generation's
            # wall time went (drained into the fleet stream on the
            # scrape cadence, or by the embedding pipeline supervisor)
            from ..obs.trace import current_context, record_span
            ctx = current_context()
            record_span("restart/world", t_restart,
                        trace_id=ctx["trace_id"] if ctx else None,
                        parent_id=ctx["span_id"] if ctx else None,
                        attrs={"restart": generation, "rc": rc,
                               "backoff_s": round(delay, 3)})
        except Exception:
            pass
        _drain_spans_into(telem)


def _term_group(proc: subprocess.Popen) -> None:
    """SIGTERM a replica's whole process group — the graceful-drain
    signal the serve daemon turns into stop-accepting + answer
    backlogged connections with a draining reply + finish in-flight
    work; fall back to terminating the process alone."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.terminate()
        except OSError:
            pass


class _Replica:
    """One independently-supervised fleet member."""

    __slots__ = ("rank", "proc", "generation", "launched_at",
                 "consecutive_restarts", "ping_failures", "done",
                 "relaunch_at", "restart_t0", "retiring",
                 "retire_deadline")

    def __init__(self, rank: int):
        self.rank = rank
        self.proc: Optional[subprocess.Popen] = None
        self.generation = 0
        self.launched_at = 0.0
        self.consecutive_restarts = 0
        self.ping_failures = 0
        self.done = False           # exited 0: intentional, no restart
        # backoff deadline of a scheduled relaunch (None = running):
        # a per-replica NOT-BEFORE time, never an inline sleep — one
        # replica's backoff must not stall supervision of the others
        self.relaunch_at: Optional[float] = None
        # perf_counter when the death/wedge was observed; closes into
        # a restart/replica span (obs/trace.py) at relaunch
        self.restart_t0: Optional[float] = None
        # scale-down drain in progress: SIGTERM sent, any exit code
        # finishes the replica WITHOUT a restart; past the deadline a
        # drain that never ends is killed (a wedge, not a drain)
        self.retiring = False
        self.retire_deadline = 0.0


def _launch_replica(rep: _Replica, cmd: Sequence[str], nprocs: int,
                    log_dir: str, base_env: Dict[str, str]) -> None:
    log_path = os.path.join(
        log_dir, f"elastic_g{rep.generation}_rank{rep.rank}.log")
    log_file = open(log_path, "ab")
    try:
        rep.proc = subprocess.Popen(
            list(cmd),
            env=worker_env(base_env, rep.rank, nprocs, _free_port(),
                           rep.generation),
            stdout=log_file, stderr=subprocess.STDOUT,
            start_new_session=True)
    finally:
        log_file.close()
    rep.launched_at = time.monotonic()
    rep.ping_failures = 0


def supervise_fleet(nprocs: int, cmd: Sequence[str],
                    max_restarts: int = 3,
                    log_dir: str = ".", grace: float = 5.0,
                    env: Optional[Dict[str, str]] = None,
                    max_restarts_per_window: int = 0,
                    restart_window_sec: float = 300.0,
                    health_port: Optional[int] = None,
                    health_interval: float = 2.0,
                    health_fails: int = 3,
                    health_grace: float = 60.0,
                    health_timeout: float = 5.0,
                    metrics_port: Optional[int] = None,
                    scrape_interval: float = 0.0,
                    min_replicas: Optional[int] = None,
                    max_replicas: Optional[int] = None,
                    autoscale_up_qps: float = 0.0,
                    autoscale_down_qps: float = 0.0,
                    autoscale_up_p99_ms: float = 0.0,
                    autoscale_up_cooldown_sec: float = 5.0,
                    autoscale_down_cooldown_sec: float = 15.0,
                    retire_grace_sec: float = 30.0,
                    publish_dir=None,
                    rollback_grace_sec: float = 6.0) -> int:
    """Supervise ``nprocs`` INDEPENDENT replicas (the serving shape):
    a dead or health-check-failing replica is relaunched alone, on a
    per-replica jittered backoff, while the rest keep serving.

    ``health_port``: base port of the replicas' JSON protocol — rank
    ``r`` is pinged on ``health_port + r`` every ``health_interval``
    seconds once its ``health_grace`` startup window (model load +
    compile) has passed; ``health_fails`` consecutive failures mean
    alive-but-wedged, and the replica is killed and relaunched. None
    disables pinging (exit-code supervision only).

    With ``max_replicas`` set (plus ``scrape_interval`` and the QPS /
    p99 thresholds) the fleet AUTOSCALES: the scrape thread feeds an
    :class:`~.autoscale.AutoscalePolicy` and the supervision loop
    spawns fresh replicas on its "up" decisions (``nprocs`` is the
    starting size; ``min_replicas`` defaults to it) and retires the
    highest-rank replica on "down" — a SIGTERM drain, so a scaled-down
    replica answers its in-flight and backlogged requests before
    exiting (``retire_grace_sec`` caps a drain that never ends).
    Scale-ups do not draw from the restart budget, but a fleet whose
    budget is spent (a crash loop) refuses to grow.

    With ``publish_dir`` also set, a :class:`~.autoscale.RollbackGuard`
    watches the newest publication in that store: one that no replica
    adopts while swap failures mount (every canary gate refused it),
    or whose adopter is evicted by post-swap health checks, is rolled
    back to the last-known-good manifest via
    :func:`~.publisher.rollback_publication`
    (``rollback_grace_sec`` is how long the fleet gets to adopt it
    first).

    Returns 0 once every replica has exited cleanly (a graceful
    ``shutdown``), or the last failing exit code when the restart
    budget (shared across the fleet) is exhausted.
    """
    if nprocs < 1:
        raise ValueError("nprocs must be >= 1")
    if not cmd:
        raise ValueError("no worker command given (pass it after --)")
    base_env = dict(os.environ if env is None else env)
    os.makedirs(log_dir, exist_ok=True)
    budget = RestartBudget(max_restarts, max_restarts_per_window,
                           restart_window_sec)
    policy = None
    if max_replicas and int(max_replicas) > 0 \
            and health_port is not None and scrape_interval > 0 \
            and (autoscale_up_qps > 0 or autoscale_up_p99_ms > 0):
        from .autoscale import AutoscalePolicy
        policy = AutoscalePolicy(
            nprocs if min_replicas is None else min_replicas,
            max_replicas,
            up_qps=autoscale_up_qps, down_qps=autoscale_down_qps,
            up_p99_ms=autoscale_up_p99_ms,
            up_cooldown_sec=autoscale_up_cooldown_sec,
            down_cooldown_sec=autoscale_down_cooldown_sec)
    guard = None
    publish_store = None
    if publish_dir and health_port is not None and scrape_interval > 0:
        from .autoscale import RollbackGuard
        from .store import store_for
        publish_store = store_for(publish_dir)
        guard = RollbackGuard(
            refuse_sec=rollback_grace_sec,
            adopt_sec=max(1.0, 2.0 * scrape_interval))
    # fleet metrics plane (docs/OBSERVABILITY.md): the supervisor's
    # own torch-free /metrics at the base port, replica endpoints at
    # base+1+rank via the exported env var; the scrape thread polls
    # each live replica's NON-consuming {"cmd": "metrics"} verb on the
    # scrape cadence into {"event": "fleet"} records (per-replica QPS
    # / p99 / shed / restarts — the autoscaling signal; {"cmd":
    # "stats"} would consume the daemon's own rate window, see
    # _replica_metrics_row)
    if metrics_port:
        from ..obs.export import ensure_metrics_server
        ensure_metrics_server(
            metrics_port,
            extra_families=policy.metrics_families if policy else None)
        base_env["LIGHTGBM_TPU_METRICS_PORT"] = str(metrics_port + 1)
    telem = _FleetTelemetry(
        fleet_telemetry_path(base_env) if scrape_interval > 0
        else None)
    fleet = [_Replica(rank) for rank in range(nprocs)]
    last_rc = 1
    next_ping = time.monotonic() + max(0.0, health_grace)
    next_store_poll = time.monotonic()
    stop_scrape = threading.Event()

    def _scrape_loop() -> None:
        # the SCRAPE THREAD: a wedged replica's fetch timeout lands
        # here, never in the supervision loop; every observation feeds
        # the (lock-guarded) scaling and rollback policies
        while not stop_scrape.wait(max(0.1, scrape_interval)):
            try:
                record = _scrape_fleet(list(fleet), health_port,
                                       health_timeout)
                telem.write(record)
                _drain_spans_into(telem)
                if policy is not None:
                    policy.observe(record["replicas"])
                if guard is not None:
                    guard.observe(record["replicas"])
            except Exception:
                pass             # scraping must never kill the fleet

    scraper = (threading.Thread(target=_scrape_loop, daemon=True,
                                name="fleet-scrape")
               if scrape_interval > 0 else None)

    def _n_active() -> int:
        return sum(1 for rep in fleet
                   if not rep.done and not rep.retiring)

    def _set_active_gauge() -> None:
        try:
            from ..obs.registry import registry
            registry.gauge("fleet_replicas_active").set(_n_active())
        except Exception:
            pass

    def _scale_up(reason: str) -> None:
        if budget.total >= budget.max_restarts:
            log_warning("elastic: autoscale up refused — the restart "
                        "budget is spent; a crash-looping fleet must "
                        "not grow")
            return
        used = {rep.rank for rep in fleet if not rep.done}
        target = next((r for r in range(policy.max_replicas)
                       if r not in used), None)
        if target is None:
            return      # every rank slot is occupied (e.g. draining)
        rep = next((r for r in fleet if r.rank == target), None)
        if rep is None:
            rep = _Replica(target)
            fleet.append(rep)
        else:
            rep.generation += 1          # fresh log file per life
            rep.consecutive_restarts = 0
        rep.done = False
        rep.retiring = False
        rep.relaunch_at = None
        rep.restart_t0 = None
        _launch_replica(rep, cmd, nprocs, log_dir, base_env)
        n_active = _n_active()
        log_info(f"elastic: autoscale up -> {n_active} replicas "
                 f"(spawned rank {target}: {reason})")
        _count("fleet_scale_ups")
        _set_active_gauge()
        telem.write({"event": "autoscale", "action": "up",
                     "rank": target, "replicas": n_active,
                     "reason": reason, "time": time.time()})

    def _scale_down(reason: str, now: float) -> None:
        victims = [rep for rep in fleet
                   if not rep.done and not rep.retiring
                   and rep.relaunch_at is None
                   and rep.proc is not None
                   and rep.proc.poll() is None]
        if not victims:
            return
        rep = max(victims, key=lambda r: r.rank)
        rep.retiring = True
        rep.retire_deadline = now + max(1.0, retire_grace_sec)
        _term_group(rep.proc)
        n_active = _n_active()
        log_info(f"elastic: autoscale down -> {n_active} replicas "
                 f"(draining rank {rep.rank}: {reason})")
        _count("fleet_scale_downs")
        _set_active_gauge()
        telem.write({"event": "autoscale", "action": "down",
                     "rank": rep.rank, "replicas": n_active,
                     "reason": reason, "time": time.time()})

    def _check_rollback() -> None:
        from .publisher import (MANIFEST_SUFFIX, PublishError,
                                latest_manifest_in,
                                rollback_publication)
        try:
            found = latest_manifest_in(publish_store)
        except (OSError, PublishError):
            found = None
        if found is not None:
            guard.note_publication(
                found[0], str(found[1].get("sha256") or ""))
        order = guard.decide()
        if order is None:
            return
        event = {"event": "rollback", "bad_file": order["bad_name"],
                 "bad_sha": order["bad_sha"],
                 "good_file": order["good_name"],
                 "good_sha": order["good_sha"], "time": time.time()}
        log_warning(f"elastic: rolling back publication "
                    f"{order['bad_name']} "
                    f"(sha {str(order['bad_sha'])[:12]}…) — the "
                    "fleet refused or degraded on it")
        try:
            if order["good_name"]:
                new_manifest = rollback_publication(
                    publish_store, order["bad_name"],
                    order["good_name"])
                event["republished"] = new_manifest["file"]
            else:
                # no last-known-good yet: withdrawing the bad
                # publication is all a supervisor can do
                publish_store.delete(order["bad_name"])
                publish_store.delete(
                    order["bad_name"] + MANIFEST_SUFFIX)
                event["republished"] = None
            event["ok"] = True
        except (OSError, PublishError) as e:
            event["ok"] = False
            event["error"] = str(e)
            log_warning(f"elastic: rollback of {order['bad_name']} "
                        f"failed ({e})")
        _count("fleet_rollbacks")
        telem.write(event)

    try:
        for rep in fleet:
            _launch_replica(rep, cmd, nprocs, log_dir, base_env)
        _set_active_gauge()
        if scraper is not None:
            scraper.start()
        while True:
            now = time.monotonic()
            ping_round = health_port is not None and now >= next_ping
            if ping_round:
                next_ping = now + max(0.1, health_interval)
            for rep in list(fleet):
                if rep.done:
                    continue
                if rep.relaunch_at is not None:
                    # backoff pending: relaunch once the per-replica
                    # deadline passes (other replicas keep being
                    # polled/pinged in the meantime)
                    if now >= rep.relaunch_at:
                        rep.relaunch_at = None
                        _launch_replica(rep, cmd, nprocs, log_dir,
                                        base_env)
                        if rep.restart_t0 is not None:
                            t0, rep.restart_t0 = rep.restart_t0, None
                            try:
                                from ..obs.trace import record_span
                                record_span(
                                    "restart/replica", t0,
                                    attrs={"rank": rep.rank,
                                           "generation":
                                               rep.generation})
                            except Exception:
                                pass
                    continue
                if rep.proc is None:
                    continue
                rc = rep.proc.poll()
                needs_restart = False
                if rc is not None:
                    if rep.retiring:
                        # a draining replica's exit ends its life —
                        # never a restart, whatever the code
                        rep.retiring = False
                        rep.done = True
                        if rc == 0:
                            log_info(f"elastic: replica {rep.rank} "
                                     "retired cleanly (drained)")
                        else:
                            log_warning(
                                f"elastic: retiring replica "
                                f"{rep.rank} exited with code {rc} "
                                "during its drain")
                        continue
                    if rc == 0:
                        log_info(f"elastic: replica {rep.rank} exited "
                                 "cleanly")
                        rep.done = True
                        continue
                    last_rc = (128 - rc) if rc < 0 else rc
                    log_warning(f"elastic: replica {rep.rank} exited "
                                f"with code {rc}")
                    needs_restart = True
                elif rep.retiring:
                    # draining: no health pings, no restarts — but a
                    # drain that outlives its deadline is a wedge
                    if now >= rep.retire_deadline:
                        log_warning(
                            f"elastic: replica {rep.rank} did not "
                            f"finish draining within "
                            f"{retire_grace_sec:g}s; killing it")
                        _kill_group(rep.proc)
                        try:
                            rep.proc.wait(timeout=max(1.0, grace))
                        except subprocess.TimeoutExpired:
                            _kill_group(rep.proc)
                        rep.retiring = False
                        rep.done = True
                    continue
                elif ping_round and \
                        now - rep.launched_at >= health_grace:
                    if replica_ping(health_port + rep.rank,
                                    timeout=health_timeout):
                        rep.ping_failures = 0
                        rep.consecutive_restarts = 0
                    else:
                        rep.ping_failures += 1
                        if rep.ping_failures >= max(1, health_fails):
                            log_warning(
                                f"elastic: replica {rep.rank} failed "
                                f"{rep.ping_failures} consecutive "
                                "health checks (alive but wedged); "
                                "killing it for relaunch")
                            if guard is not None:
                                # post-swap health failure: condemn
                                # the publication this replica serves
                                # if it is the one under watch
                                guard.note_eviction(rep.rank)
                            _kill_group(rep.proc)
                            try:
                                rep.proc.wait(timeout=max(1.0, grace))
                            except subprocess.TimeoutExpired:
                                _kill_group(rep.proc)
                            last_rc = 1
                            needs_restart = True
                if not needs_restart:
                    continue
                refusal = budget.admit()
                if refusal is None:
                    # generation bump strips one-shot faults
                    # (worker_env) so an injected serve_kill cannot
                    # re-fire on every relaunch forever
                    rep.generation += 1
                    rep.consecutive_restarts += 1
                    delay = budget.backoff(rep.consecutive_restarts)
                    rep.relaunch_at = now + delay
                    rep.restart_t0 = time.perf_counter()
                    log_info(f"elastic: relaunching replica "
                             f"{rep.rank} (generation "
                             f"{rep.generation}) in {delay:.2f}s")
                else:
                    log_warning(f"elastic: replica {rep.rank} died "
                                f"and {refusal} — stopping the fleet")
                    for other in fleet:
                        if other.proc is not None \
                                and other.proc.poll() is None:
                            _kill_group(other.proc)
                    return last_rc
            if policy is not None:
                decision = policy.decide(_n_active())
                if decision is not None:
                    action, reason = decision
                    if action == "up":
                        _scale_up(reason)
                    else:
                        _scale_down(reason, now)
            if guard is not None and now >= next_store_poll:
                next_store_poll = now + max(0.5, scrape_interval)
                try:
                    _check_rollback()
                except Exception:
                    pass    # rollback must never kill the supervisor
            if all(rep.done for rep in fleet):
                log_info("elastic: every replica exited cleanly")
                if scrape_interval > 0:
                    # final scrape: the restart totals survive into
                    # the stream even when the cadence never fired
                    stop_scrape.set()
                    if scraper is not None:
                        scraper.join(timeout=health_timeout + 2.0)
                    telem.write(_scrape_fleet(fleet, None,
                                              health_timeout))
                    _drain_spans_into(telem)
                return 0
            time.sleep(_POLL_SECONDS)
    except BaseException:          # ctrl-C etc.: never leak replicas
        for rep in fleet:
            if rep.proc is not None and rep.proc.poll() is None:
                _kill_group(rep.proc)
        raise
    finally:
        stop_scrape.set()
        if scraper is not None and scraper.is_alive():
            scraper.join(timeout=2.0)
        telem.close()


_HELP_EPILOG = """\
The worker command runs once per rank with LIGHTGBM_TPU_COORDINATOR /
LIGHTGBM_TPU_NUM_PROCS / LIGHTGBM_TPU_RANK exported. Without
--health-port the ranks form one world (each joins it with
parallel.distributed.init_distributed()). Export
LIGHTGBM_TPU_CHECKPOINT=<dir> (or
pass --checkpoint-dir) so every restart resumes from the newest
snapshot. With --health-port the ranks are independent serve replicas
(python -m lightgbm_tpu_torch serve ... --port <health-port>).

exit codes:
  0  a generation completed cleanly on every rank
  N  the last failing rank's exit code, once restarts are exhausted
     (signal deaths surface shell-style as 128+signum, e.g. 137 for
     SIGKILL)
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch launch",
        usage="python -m lightgbm_tpu_torch launch <nprocs> [options] "
              "-- <worker cmd...>",
        description="Supervised elastic launcher: spawn one training "
                    "process per rank, restart the world from the "
                    "newest checkpoint when a rank dies or a "
                    "collective watchdog aborts.",
        epilog=_HELP_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("nprocs", type=int, help="number of ranks to spawn")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="world restarts before giving up (default 3)")
    p.add_argument("--max-restarts-per-window", type=int, default=0,
                   help="sliding-window restart cap: give up when this "
                        "many restarts land within --restart-window "
                        "seconds (crash-loop brake; 0 = disabled)")
    p.add_argument("--restart-window", type=float, default=300.0,
                   help="width in seconds of the sliding restart "
                        "window (default 300)")
    p.add_argument("--health-port", type=int, default=None,
                   help="FLEET MODE: supervise ranks as independent "
                        "replicas (restart only the dead one) and "
                        "health-check rank r via the serve daemon's "
                        "{\"cmd\": \"ping\"} on this port + r")
    p.add_argument("--health-interval", type=float, default=2.0,
                   help="seconds between health pings (fleet mode)")
    p.add_argument("--health-fails", type=int, default=3,
                   help="consecutive ping failures before a replica "
                        "is declared wedged and relaunched")
    p.add_argument("--health-grace", type=float, default=60.0,
                   help="startup window in seconds during which a "
                        "(re)launched replica is not pinged (model "
                        "load + compile)")
    p.add_argument("--min-replicas", type=int, default=None,
                   help="autoscaling floor (fleet mode; default: "
                        "nprocs)")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="autoscaling ceiling (fleet mode): with this "
                        "set (plus --scrape-interval and an up "
                        "threshold) the supervisor spawns replicas "
                        "under load and SIGTERM-drains the highest "
                        "rank when traffic subsides (0 = fixed fleet)")
    p.add_argument("--autoscale-up-qps", type=float, default=0.0,
                   help="scale up when fleet-total QPS exceeds this "
                        "per active replica (0 = no QPS trigger)")
    p.add_argument("--autoscale-down-qps", type=float, default=0.0,
                   help="scale down when fleet-total QPS would still "
                        "clear this per replica with one replica "
                        "fewer; keep it below --autoscale-up-qps for "
                        "hysteresis (0 = never scale down)")
    p.add_argument("--autoscale-up-p99-ms", type=float, default=0.0,
                   help="scale up when any replica's p99 latency "
                        "exceeds this many ms (0 = no latency "
                        "trigger)")
    p.add_argument("--autoscale-up-cooldown", type=float, default=5.0,
                   help="seconds after any scaling action before the "
                        "next scale-up (default 5)")
    p.add_argument("--autoscale-down-cooldown", type=float,
                   default=15.0,
                   help="seconds after any scaling action before the "
                        "next scale-down (default 15)")
    p.add_argument("--retire-grace", type=float, default=30.0,
                   help="seconds a scaled-down replica gets to finish "
                        "its SIGTERM drain before being killed "
                        "(default 30)")
    p.add_argument("--publish-dir", default=None,
                   help="publication store target the fleet swaps "
                        "from (a directory or mem:// spec): enables "
                        "the rollback guard — a publication the "
                        "fleet's canary gates refuse, or whose "
                        "adopter fails post-swap health checks, is "
                        "rolled back to last-known-good")
    p.add_argument("--rollback-grace", type=float, default=6.0,
                   help="seconds the fleet gets to adopt a new "
                        "publication before mounting swap failures "
                        "condemn it (default 6)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="fleet metrics plane (docs/OBSERVABILITY.md): "
                        "the supervisor serves its own torch-free "
                        "OpenMetrics /metrics at this port and exports "
                        "LIGHTGBM_TPU_METRICS_PORT=<port+1> so worker "
                        "rank r binds port+1+r (0 = disabled)")
    p.add_argument("--scrape-interval", type=float, default=0.0,
                   help="seconds between fleet scrapes written as "
                        "{\"event\": \"fleet\"} records to "
                        "$LIGHTGBM_TPU_TELEMETRY.fleet: per-replica "
                        "QPS/p99/shed/restarts in fleet mode (via "
                        "the replicas' {\"cmd\": \"metrics\"} verb), "
                        "per-rank iteration skew in world mode — "
                        "world mode reads the worker /metrics "
                        "endpoints, so it also needs --metrics-port "
                        "(0 = disabled)")
    p.add_argument("--port", type=int, default=0,
                   help="fixed coordinator port (default: a fresh free "
                        "port per generation)")
    p.add_argument("--log-dir", default=".",
                   help="directory for per-rank worker logs "
                        "(default: .)")
    p.add_argument("--grace", type=float, default=5.0,
                   help="seconds to let surviving ranks exit on their "
                        "own before killing them (default 5)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="export LIGHTGBM_TPU_CHECKPOINT=<dir> to the "
                        "workers (auto-checkpoint + auto-resume)")
    # NOTE: the worker command is NOT an argparse positional — a
    # REMAINDER positional swallows the supervisor's own options, so
    # main() splits on the `--` separator before parsing
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # split on the `--` separator OURSELVES: argparse's REMAINDER is
    # greedy and would swallow the supervisor's own options into the
    # worker command
    if "--" in argv:
        split = argv.index("--")
        head, cmd = argv[:split], argv[split + 1:]
    else:
        head, cmd = argv, []
    args = build_parser().parse_args(head)
    if not cmd:
        print("launch: no worker command given (usage: launch <nprocs> "
              "-- <cmd...>)", file=sys.stderr)
        return 2
    env = dict(os.environ)
    if args.checkpoint_dir:
        env["LIGHTGBM_TPU_CHECKPOINT"] = args.checkpoint_dir
    try:
        if args.health_port is not None:
            return supervise_fleet(
                args.nprocs, cmd, max_restarts=args.max_restarts,
                log_dir=args.log_dir, grace=args.grace, env=env,
                max_restarts_per_window=args.max_restarts_per_window,
                restart_window_sec=args.restart_window,
                health_port=args.health_port,
                health_interval=args.health_interval,
                health_fails=args.health_fails,
                health_grace=args.health_grace,
                metrics_port=args.metrics_port or None,
                scrape_interval=args.scrape_interval,
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas or None,
                autoscale_up_qps=args.autoscale_up_qps,
                autoscale_down_qps=args.autoscale_down_qps,
                autoscale_up_p99_ms=args.autoscale_up_p99_ms,
                autoscale_up_cooldown_sec=args.autoscale_up_cooldown,
                autoscale_down_cooldown_sec=args.autoscale_down_cooldown,
                retire_grace_sec=args.retire_grace,
                publish_dir=args.publish_dir,
                rollback_grace_sec=args.rollback_grace)
        return supervise(args.nprocs, cmd,
                         max_restarts=args.max_restarts,
                         port=args.port or None, log_dir=args.log_dir,
                         grace=args.grace, env=env,
                         max_restarts_per_window=args.max_restarts_per_window,
                         restart_window_sec=args.restart_window,
                         metrics_port=args.metrics_port or None,
                         scrape_interval=args.scrape_interval)
    except KeyboardInterrupt:
        print("launch: interrupted", file=sys.stderr)
        return 130
