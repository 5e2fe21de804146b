"""``python -m lightgbm_tpu_torch pipeline``: the closed production
loop. A copy of ``lightgbm_tpu/pipeline.py`` with its flags, file names
and JSONL events, training and serving on the GPU unless
``--device-type cpu`` is given::

    ingest -> train -> publish -> serve -> (fresh data) -> retrain ...

- **Generations**: each generation streams a fresh, drifting data slice
  through a chunk source (``data/``), warm-starts from the previous
  publication (``--warm-start append``: continued training through
  ``init_model``; ``refit``: the forest's leaf values re-derived from
  the fresh gradients, then continued; ``none``: from scratch), and
  publishes the result manifest-first (``resilience/publisher.py``)
  into the fleet's watch directory.
- **Training runs supervised**: each generation trains in one process
  under :func:`~.resilience.elastic.supervise` with a checkpoint
  directory of its own, so a ``rank_kill`` mid-generation relaunches
  and resumes instead of losing the generation.
- **Serving runs supervised**: the replicas run under ``launch
  --health-port`` (per-replica restarts, ping health checks); swaps
  ride the daemon's watcher, which checks every artifact against its
  manifest and its canary before it swaps.
- **Traffic**: a load generator drives the fleet for the whole run and
  records the client's view (ok, shed, draining, connection errors,
  timeouts, latency, the longest gap between answers) into the
  pipeline's telemetry. ``--spike-rate`` adds a load spike that the
  fleet supervisor scales up into (``--max-replicas``,
  ``resilience/autoscale.py``) and back down out of.
- **Canary-gated rollout**: with ``--canary-rows`` each publication
  carries validation rows and their raw scores; a replica refuses a
  publication whose canary fails, and the fleet supervisor rolls it
  back to last-known-good, which the pipeline counts as a rollback
  (``rollbacks`` in the summary), not a failure.

The CLI's dispatch, the supervisor loop and the load generator import
no torch; torch loads in the spawned training workers (the hidden
``--train-worker`` mode) and serve replicas only.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .log import log_info, log_warning

__all__ = ["main", "build_parser", "LoadGenerator", "replica_stats"]

#: fault kinds routed to the serve fleet's environment; everything
#: else goes to the training workers (docs/PIPELINE.md chaos matrix)
_SERVE_FAULT_KINDS = ("serve_kill",)


# ---------------------------------------------------------------------
# small torch-free protocol clients (supervisor side)
# ---------------------------------------------------------------------

def _rpc(port: int, obj: Dict[str, Any], timeout: float = 10.0,
         host: str = "127.0.0.1") -> Optional[Dict[str, Any]]:
    """One request -> one reply against a serve replica; None on any
    transport/parse failure (the supervisor polls, it never crashes).
    One implementation, shared with the fleet supervisor's health
    probe."""
    from .resilience.elastic import replica_rpc
    return replica_rpc(port, obj, timeout=timeout, host=host)


def replica_stats(port: int, timeout: float = 10.0
                  ) -> Optional[Dict[str, Any]]:
    return _rpc(port, {"cmd": "stats"}, timeout=timeout)


def _split_faults(spec: str) -> Tuple[str, str]:
    """Route a LIGHTGBM_TPU_FAULT_INJECT spec to its side of the
    lifecycle: (train_spec, serve_spec)."""
    train_toks: List[str] = []
    serve_toks: List[str] = []
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        kind = tok.split("@", 1)[0].strip()
        (serve_toks if kind in _SERVE_FAULT_KINDS
         else train_toks).append(tok)
    return ",".join(train_toks), ",".join(serve_toks)


# ---------------------------------------------------------------------
# telemetry writer (supervisor side, shared by the loadgen thread)
# ---------------------------------------------------------------------

class _EventLog:
    """Append-only JSONL writer shared between the supervisor loop and
    the load-generator thread; the file handle is the shared state,
    one lock orders the writes."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        self._file = open(path, "a", encoding="utf-8")

    def write(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event) + "\n"
        with self._lock:
            if self._file is None:
                return
            try:
                self._file.write(line)
                self._file.flush()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            fh, self._file = self._file, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass


# ---------------------------------------------------------------------
# load generator (supervisor side; torch-free)
# ---------------------------------------------------------------------

class LoadGenerator:
    """Constant-rate request generator for the serve fleet.

    One worker thread round-robins the replica ports, keeps one
    persistent connection per replica (reconnecting on failure), and
    classifies every outcome: ``ok``, ``shed`` (typed overload reply),
    ``overloaded`` (hard backpressure), ``draining`` (typed graceful-
    shutdown refusal from a retiring replica — the client's cue to
    fail over, never a dropped request), ``error`` (error reply),
    ``conn`` (connect/reset — a killed or not-yet-scaled-up replica),
    ``timeout`` (a reply that never came: the one class that would
    mean a silently dropped accepted request). A port that failed to
    connect is skipped for a short backoff so traffic concentrates on
    live replicas (an autoscaled fleet has ports that are legitimately
    down). The request rate is adjustable mid-run (``set_rate`` — the
    pipeline's load spike), so it lives under ``self._lock``
    with the stats; all socket I/O happens outside it.
    """

    #: seconds a port sits out after a failed connect (worker-local)
    DEAD_PORT_BACKOFF_SEC = 1.0

    def __init__(self, ports: List[int], n_features: int,
                 rate_per_sec: float = 20.0, rows_per_request: int = 4,
                 reply_timeout: float = 30.0,
                 event_log: Optional[_EventLog] = None,
                 stats_interval: float = 1.0,
                 trace_every: int = 0):
        self.ports = list(ports)
        self.n_features = int(n_features)
        self.rows = max(1, int(rows_per_request))
        self.reply_timeout = float(reply_timeout)
        self.event_log = event_log
        self.stats_interval = max(0.1, float(stats_interval))
        # distributed tracing (obs/trace.py): every Nth request
        # originates a trace — its {"trace": ...} protocol field makes
        # the replica emit queue-wait/batch-window/dispatch spans, and
        # the client-side span lands in the pipeline's own event log
        self.trace_every = max(0, int(trace_every))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # ---- guarded by self._lock ----
        self._rate = max(0.1, float(rate_per_sec))
        self._counts = {"attempts": 0, "ok": 0, "shed": 0,
                        "overloaded": 0, "draining": 0, "error": 0,
                        "conn": 0, "timeout": 0}
        self._latencies: deque = deque(maxlen=4096)
        self._last_ok: Optional[float] = None
        self._max_ok_gap = 0.0
        self._last_model: Optional[str] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="lightgbm-tpu-pipeline-loadgen")

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    def set_rate(self, rate_per_sec: float) -> None:
        """Retarget the request rate mid-run (the load spike);
        the worker picks it up on its next period."""
        with self._lock:
            self._rate = max(0.1, float(rate_per_sec))

    def rate(self) -> float:
        with self._lock:
            return self._rate

    def _note(self, outcome: str, latency: Optional[float] = None,
              model: Optional[str] = None,
              want_stats: bool = False) -> Optional[Dict[str, Any]]:
        """Record one outcome; with ``want_stats`` also returns the
        event-ready stats view, so the worker thread never has to read
        the shared fields outside this one locked section
        (``snapshot()`` below is the supervisor-thread reader of the
        same state). The view — a sort of the latency window — is only
        built on the event cadence, not per request."""
        now = time.monotonic()
        with self._lock:
            self._counts["attempts"] += 1
            self._counts[outcome] += 1
            if latency is not None:
                self._latencies.append(latency)
            if outcome == "ok":
                if self._last_ok is not None:
                    self._max_ok_gap = max(self._max_ok_gap,
                                           now - self._last_ok)
                self._last_ok = now
                if model is not None:
                    self._last_model = model
            if not want_stats:
                return None
            counts = dict(self._counts)
            lat = sorted(self._latencies)
            gap = self._max_ok_gap
            last_ok = self._last_ok
            model_now = self._last_model
        return self._format(counts, lat, gap, last_ok, model_now)

    @staticmethod
    def _format(counts: Dict[str, int], lat: List[float], gap: float,
                last_ok: Optional[float],
                model: Optional[str]) -> Dict[str, Any]:
        out: Dict[str, Any] = {**counts, "max_ok_gap_s": round(gap, 3),
                               "model": model}
        if last_ok is not None:
            out["since_last_ok_s"] = round(
                time.monotonic() - last_ok, 3)
        if lat:
            out["p50_ms"] = round(lat[len(lat) // 2] * 1e3, 3)
            out["p99_ms"] = round(
                lat[min(len(lat) - 1, (len(lat) * 99) // 100)] * 1e3, 3)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Supervisor-side stats view (the summary + swap gating)."""
        with self._lock:
            counts = dict(self._counts)
            lat = sorted(self._latencies)
            gap = self._max_ok_gap
            last_ok = self._last_ok
            model = self._last_model
        return self._format(counts, lat, gap, last_ok, model)

    # -- worker thread -------------------------------------------------
    def _run(self) -> None:
        import random as _random
        rng = _random.Random(1234)
        conns: Dict[int, Any] = {}
        # worker-local failover state: a port that refused a connect
        # sits out a short backoff so traffic concentrates on live
        # replicas (only this thread reads/writes it — no lock)
        dead_until: Dict[int, float] = {}
        next_stats = time.monotonic() + self.stats_interval
        i = 0
        while True:
            with self._lock:
                period = 1.0 / self._rate
            if self._stop.wait(period):
                break
            now = time.monotonic()
            port = None
            for _ in range(len(self.ports)):
                candidate = self.ports[i % len(self.ports)]
                i += 1
                if dead_until.get(candidate, 0.0) <= now:
                    port = candidate
                    break
            if port is None:                 # every port backing off:
                port = self.ports[i % len(self.ports)]
                i += 1                       # probe one anyway
            rows = [[rng.uniform(-2.0, 2.0)
                     for _ in range(self.n_features)]
                    for _ in range(self.rows)]
            payload: Dict[str, Any] = {"rows": rows}
            span_ctx = None
            if self.trace_every and self.event_log is not None \
                    and (i - 1) % self.trace_every == 0:
                from .obs import trace as _trace
                span_ctx = (_trace.new_trace_id(),
                            _trace.new_span_id(),
                            time.perf_counter())
                payload["trace"] = {"trace_id": span_ctx[0],
                                    "span_id": span_ctx[1]}
            t0 = time.monotonic()
            want = self.event_log is not None and t0 >= next_stats
            try:
                fh = conns.get(port)
                if fh is None:
                    s = socket.create_connection(
                        ("127.0.0.1", port), timeout=5.0)
                    s.settimeout(self.reply_timeout)
                    fh = s.makefile("rw", encoding="utf-8")
                    conns[port] = fh
                fh.write(json.dumps(payload) + "\n")
                fh.flush()
                line = fh.readline()
                if not line:
                    raise OSError("connection closed by replica")
                reply = json.loads(line)
            except socket.timeout:
                conns.pop(port, None)
                stats = self._note("timeout", want_stats=want)
            except (OSError, ValueError):
                conns.pop(port, None)
                dead_until[port] = (time.monotonic()
                                    + self.DEAD_PORT_BACKOFF_SEC)
                stats = self._note("conn", want_stats=want)
            else:
                dt = time.monotonic() - t0
                if reply.get("draining"):
                    # typed graceful-shutdown refusal: fail over now —
                    # the replica is retiring and will close
                    conns.pop(port, None)
                    dead_until[port] = (time.monotonic()
                                        + self.DEAD_PORT_BACKOFF_SEC)
                    stats = self._note("draining", want_stats=want)
                elif reply.get("shed"):
                    stats = self._note("shed", want_stats=want)
                elif reply.get("overloaded"):
                    stats = self._note("overloaded", want_stats=want)
                elif "error" in reply:
                    stats = self._note("error", want_stats=want)
                else:
                    stats = self._note("ok", latency=dt,
                                       model=reply.get("model"),
                                       want_stats=want)
                    if span_ctx is not None:
                        # the root client-side span: written straight
                        # to the supervisor's event log (no recorder
                        # drains on this side); the replica's
                        # serve/request span parents to it
                        from .obs import trace as _trace
                        self.event_log.write(_trace.make_span(
                            "client/request", span_ctx[2],
                            trace_id=span_ctx[0],
                            span_id=span_ctx[1],
                            attrs={"model": reply.get("model"),
                                   "port": port,
                                   "outcome": "ok"}))
            if stats is not None:
                next_stats = time.monotonic() + self.stats_interval
                self.event_log.write(
                    {"event": "client", "time": time.time(), **stats})
        for fh in conns.values():
            try:
                fh.close()
            except OSError:
                pass


def _drive_spike(loadgen: "LoadGenerator", events: _EventLog,
                 base_rate: float, spike_rate: float,
                 start_sec: float, duration_sec: float,
                 stop: threading.Event) -> None:
    """One load spike: wait, jump the request rate, hold, fall back —
    the traffic shape the autoscaling chaos drill scales up into and
    back down out of. Runs on its own daemon thread; the stop event
    aborts the wait phases but the rate is ALWAYS restored."""
    if stop.wait(max(0.0, float(start_sec))):
        return
    loadgen.set_rate(spike_rate)
    events.write({"event": "pipeline", "phase": "spike_start",
                  "rate": float(spike_rate), "time": time.time()})
    stop.wait(max(0.0, float(duration_sec)))
    loadgen.set_rate(base_rate)
    events.write({"event": "pipeline", "phase": "spike_end",
                  "rate": float(base_rate), "time": time.time()})


class _ClientMetrics:
    """Bridges the load generator's client-side view into the
    supervisor's /metrics endpoint (obs/export.py extra families).

    The endpoint starts before the load generator exists (the
    bootstrap generation trains first), so the provider holds a slot
    the supervisor fills later; the slot is written by the supervisor
    thread and read by HTTP scrape threads, so both sides go through
    ``self._lock``. The snapshot itself runs outside the
    slot lock — the generator locks its own stats."""

    def __init__(self):
        self._lock = threading.Lock()
        self._loadgen: Optional[LoadGenerator] = None

    def attach(self, loadgen: "LoadGenerator") -> None:
        with self._lock:
            self._loadgen = loadgen

    def families(self) -> Dict[str, Any]:
        with self._lock:
            loadgen = self._loadgen
        if loadgen is None:
            return {}
        from .obs.export import counter_family, gauge_family
        snap = loadgen.snapshot()
        fams: Dict[str, Any] = {}
        for key in ("attempts", "ok", "shed", "overloaded",
                    "draining", "error", "conn", "timeout"):
            fams[f"client_{key}"] = counter_family(snap.get(key, 0))
        for key in ("p50_ms", "p99_ms", "max_ok_gap_s",
                    "since_last_ok_s"):
            if snap.get(key) is not None:
                fams[f"client_{key}"] = gauge_family(snap[key])
        return fams


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------

_HELP_EPILOG = """\
The pipeline drives ingest -> train -> publish -> serve generations
under supervision (docs/PIPELINE.md): training generations run under
the elastic supervisor with per-generation checkpoint auto-resume,
models publish atomically (manifest-first, sha256-validated, retried
with backoff) into the serve fleet's watch directory, and the fleet
runs under `launch --health-port` with per-replica restarts, replica
autoscaling (--max-replicas) and canary-gated rollout with automatic
rollback (--canary-rows / --rollback-grace). Chaos rides
LIGHTGBM_TPU_FAULT_INJECT / --fault-inject: serve_kill@N goes to the
fleet, everything else (rank_kill@I, publish_torn@G, store_outage@G,
publish_poison@G, refit_nan@T, nan_grad@I, ...) to the training
workers.

exit codes:
  0  every generation trained, published, and was confirmed serving
  1  a generation failed, publication failed, or the fleet never
     confirmed the final model
  2  bad command line
"""


def build_parser() -> argparse.ArgumentParser:
    from .config import Config
    p = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch pipeline",
        description="Continuous train -> publish -> serve lifecycle "
                    "under supervision: warm-start retraining on "
                    "fresh data, atomic manifest-validated "
                    "publication, health-checked serve fleet, "
                    "built-in load generator.",
        epilog=_HELP_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device-type", choices=("cuda", "cpu"),
                   default="cuda",
                   help="where every generation trains and every "
                        "replica serves (default cuda: the GPU; a "
                        "worker or replica without one exits 1)")
    p.add_argument("--workdir", required=True,
                   help="working directory (publish/, checkpoints/, "
                        "telemetry/, logs/ are created inside)")
    p.add_argument("--generations", type=int, default=3,
                   help="retrain generations to run (default 3)")
    p.add_argument("--rounds", type=int, default=10,
                   help="boosting iterations added per generation")
    p.add_argument("--rows", type=int, default=4000,
                   help="rows of fresh data per generation")
    p.add_argument("--features", type=int, default=16,
                   help="feature count of the synthetic stream")
    p.add_argument("--num-leaves", type=int, default=15)
    p.add_argument("--warm-start",
                   choices=("append", "refit", "none"),
                   default="append",
                   help="how generation g>0 uses generation g-1's "
                        "published model: append = continued training "
                        "(init_model); refit = re-derive the existing "
                        "forest's leaf values from fresh gradients "
                        "(FitByExistingTree semantics) then append; "
                        "none = from scratch")
    p.add_argument("--refit-decay", type=float, default=0.9,
                   help="refit decay rate (new_leaf = decay*old + "
                        "(1-decay)*fit)")
    p.add_argument("--ingest-chunk-rows", type=int, default=512,
                   help="streaming ingest chunk size (data/ chunk "
                        "sources)")
    p.add_argument("--param", action="append", default=[],
                   metavar="K=V",
                   help="extra training parameter (repeatable), e.g. "
                        "--param nonfinite_policy=skip_tree")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve replicas under the health-checked "
                        "fleet supervisor")
    p.add_argument("--port", type=int, default=0,
                   help="base serve port (default: a free port)")
    p.add_argument("--request-rate", type=float, default=20.0,
                   help="load-generator requests per second (0 "
                        "disables the load generator)")
    p.add_argument("--request-rows", type=int, default=4,
                   help="rows per generated request")
    p.add_argument("--spike-rate", type=float, default=0.0,
                   help="load-spike request rate: after --spike-start "
                        "seconds the load generator jumps to this "
                        "rate for --spike-duration seconds, then "
                        "falls back (0 = no spike; the autoscaling "
                        "chaos drill)")
    p.add_argument("--spike-start", type=float, default=5.0,
                   help="seconds after the fleet is ready before the "
                        "load spike begins")
    p.add_argument("--spike-duration", type=float, default=10.0,
                   help="seconds the load spike lasts")
    p.add_argument("--max-replicas", type=int,
                   default=Config.serve_max_replicas,
                   help="replica autoscaling ceiling: the fleet "
                        "supervisor spawns replicas up to this count "
                        "on load and retires them (graceful drain) "
                        "when it subsides (0 = fixed fleet)")
    p.add_argument("--min-replicas", type=int, default=0,
                   help="autoscaling floor (default: --replicas)")
    p.add_argument("--autoscale-up-qps", type=float,
                   default=Config.autoscale_up_qps,
                   help="scale up when fleet QPS exceeds this per "
                        "active replica")
    p.add_argument("--autoscale-down-qps", type=float,
                   default=Config.autoscale_down_qps,
                   help="scale down when fleet QPS would stay under "
                        "this per replica with one replica fewer "
                        "(hysteresis: keep it below --autoscale-up-"
                        "qps)")
    p.add_argument("--autoscale-up-p99-ms", type=float,
                   default=Config.autoscale_up_p99_ms,
                   help="scale up when any replica's p99 exceeds "
                        "this (0 = QPS/shed signals only)")
    p.add_argument("--retire-grace", type=float, default=10.0,
                   help="seconds a scaled-down replica gets to drain "
                        "in-flight requests before a hard kill")
    p.add_argument("--rollback-grace", type=float, default=6.0,
                   help="seconds the fleet supervisor waits for some "
                        "replica to adopt a new publication before a "
                        "canary-refused one is rolled back")
    p.add_argument("--publish-keep", type=int,
                   default=Config.publish_keep,
                   help="retention: prune publications beyond the N "
                        "newest valid manifests after each publish "
                        "(0 = keep everything; the served and last-"
                        "known-good models are never pruned)")
    p.add_argument("--canary-rows", type=int,
                   default=Config.canary_rows,
                   help="validation rows embedded in each publication "
                        "manifest; replicas score them through the "
                        "real compiled forest BEFORE swapping and "
                        "refuse on mismatch (0 = no canary gate)")
    p.add_argument("--canary-tol", type=float,
                   default=Config.canary_tol,
                   help="absolute tolerance for canary raw-score "
                        "agreement")
    p.add_argument("--trace-every", type=int,
                   default=Config.trace_sample_every,
                   help="originate a distributed trace on every Nth "
                        "load-generator request: the replica answers "
                        "with queue-wait/batch-window/dispatch spans "
                        "joined by `python -m lightgbm_tpu_torch trace` "
                        "(0 disables trace sampling)")
    p.add_argument("--max-restarts", type=int, default=6,
                   help="restart budget for each supervised side")
    p.add_argument("--max-restarts-per-window", type=int, default=0,
                   help="sliding-window restart cap (0 = disabled)")
    p.add_argument("--restart-window", type=float, default=300.0)
    p.add_argument("--grace", type=float, default=5.0,
                   help="teardown grace seconds")
    p.add_argument("--health-interval", type=float, default=1.0)
    p.add_argument("--health-grace", type=float, default=90.0,
                   help="startup window before a replica is pinged")
    p.add_argument("--swap-timeout", type=float, default=180.0,
                   help="seconds to wait for the fleet to confirm a "
                        "published model before failing")
    p.add_argument("--shed-queue-rows", type=int,
                   default=Config.serve_shed_queue_rows)
    p.add_argument("--shed-p99-ms", type=float,
                   default=Config.serve_shed_p99_ms)
    p.add_argument("--metrics-port", type=int,
                   default=Config.metrics_port,
                   help="base port of the fleet metrics plane "
                        "(docs/OBSERVABILITY.md): the pipeline "
                        "supervisor's own torch-free OpenMetrics "
                        "/metrics (loadgen client view + supervisor "
                        "counters) binds here, trainer ranks at +1, "
                        "the fleet supervisor at +2 and serve "
                        "replicas at +3+rank (0 = disabled)")
    p.add_argument("--scrape-interval", type=float,
                   default=Config.metrics_scrape_interval_sec,
                   help="seconds between fleet scrapes: the fleet "
                        "supervisor polls per-replica QPS/p99/shed/"
                        "restarts into {\"event\": \"fleet\"} records "
                        "(telemetry/serve.jsonl.fleet) and the "
                        "training supervisor records per-rank "
                        "iteration skew (0 = disabled)")
    p.add_argument("--fault-inject", default=None,
                   help="chaos spec (default: "
                        "$LIGHTGBM_TPU_FAULT_INJECT)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--keep-fleet", action="store_true",
                   help="leave the serve fleet running on exit "
                        "(default: graceful shutdown)")
    # hidden: the training worker entry point (one
    # generation), spawned under the elastic supervisor
    p.add_argument("--train-worker", type=int, default=None,
                   metavar="GEN", help=argparse.SUPPRESS)
    return p


def _parse_params(pairs: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--param expects K=V, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k.strip()] = v.strip()
    return out


# ---------------------------------------------------------------------
# the training worker (torch side; one generation)
# ---------------------------------------------------------------------

def _gen_data(seed: int, gen: int, rows: int, features: int):
    """Drifting synthetic binary stream: generation g's data comes
    from a slowly rotating weight vector, so retraining on fresh data
    genuinely moves the model (and a stale model measurably decays)."""
    import numpy as np
    rng = np.random.RandomState(seed * 1000 + gen)
    w = np.sin(np.arange(features) * 0.7 + 0.35 * gen)
    X = rng.randn(rows, features).astype(np.float64)
    logits = X @ w + 0.5 * rng.randn(rows)
    y = (logits > 0).astype(np.float64)
    return X, y


def _auc(y, scores) -> float:
    """Rank-based AUC without sklearn."""
    import numpy as np
    y = np.asarray(y).ravel()
    s = np.asarray(scores, np.float64).ravel()
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # average ties
    sorted_s = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1
        i = j + 1
    npos = float((y > 0).sum())
    nneg = float(len(y) - npos)
    if npos == 0 or nneg == 0:
        return 0.5
    return float((ranks[y > 0].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg))


def _train_worker(args) -> int:
    """One supervised retrain generation: ingest fresh chunked data,
    warm-start from the newest published model, train, publish
    atomically. Runs under the elastic supervisor with
    LIGHTGBM_TPU_CHECKPOINT pointing at the generation's checkpoint
    directory, so a mid-train kill relaunches this exact function and
    resumes."""
    gen = int(args.train_worker)
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from .config import Config
    from .data.sources import GeneratorChunkSource
    from .resilience.publisher import latest_manifest, publish_model

    workdir = os.path.abspath(args.workdir)
    publish_dir = os.path.join(workdir, "publish")
    os.makedirs(publish_dir, exist_ok=True)
    X, y = _gen_data(args.seed, gen, args.rows, args.features)
    chunk = max(64, int(args.ingest_chunk_rows))

    def factory():
        for lo in range(0, len(y), chunk):
            yield X[lo:lo + chunk], y[lo:lo + chunk]

    source = GeneratorChunkSource(factory, num_rows=len(y),
                                  num_features=args.features)
    params: Dict[str, Any] = {
        "objective": "binary", "num_leaves": int(args.num_leaves),
        "verbosity": -1, "ingest_chunk_rows": chunk,
        "device_type": args.device_type,
        **_parse_params(args.param)}
    ds = lgb.Dataset(source, params=params)

    init_model = None
    refit_auc = None
    prev = None if (gen == 0 or args.warm_start == "none") \
        else latest_manifest(publish_dir)
    if prev is not None:
        prev_path, prev_manifest = prev
        log_info(f"pipeline[g{gen}]: warm-starting from "
                 f"{prev_path} (generation "
                 f"{prev_manifest.get('generation')})")
        base = lgb.Booster(model_file=prev_path,
                           params={"device_type": params["device_type"]})
        if args.warm_start == "refit":
            # FitByExistingTree: same structures, leaf values
            # re-derived from THIS generation's gradients
            base = base.refit(X, y, decay_rate=args.refit_decay)
            refit_auc = _auc(y, base.predict(X))
            log_info(f"pipeline[g{gen}]: refit AUC on fresh data "
                     f"{refit_auc:.4f}")
        init_model = base
    bst = lgb.train(params, ds, num_boost_round=int(args.rounds),
                    init_model=init_model)
    train_auc = _auc(y, bst.predict(X))
    digest = getattr(ds, "_data_digest", None)
    cfg = Config.from_params(params)
    canary = None
    if int(args.canary_rows) > 0:
        # the serve-side validation batch (docs/SERVING.md): rows are
        # rounded to float32 first — the daemon feeds float32 to the
        # compiled forest, and tree thresholds must see the SAME
        # values here, or a split on the rounding gap would flip a
        # leaf and fail a perfectly good canary
        c_rng = np.random.RandomState(args.seed * 1000 + gen + 777)
        c_rows = c_rng.uniform(
            -2.0, 2.0,
            size=(int(args.canary_rows), int(args.features))
        ).astype(np.float32)
        c_scores = np.asarray(
            bst.predict(c_rows.astype(np.float64), raw_score=True),
            np.float64).reshape(-1)
        canary = {"rows": [[float(v) for v in row] for row in c_rows],
                  "scores": [float(s) for s in c_scores],
                  "tol": float(args.canary_tol)}
    # retention never prunes what the fleet still depends on: the
    # warm-start source (the currently-served / rollback target)
    protect = (prev[1]["sha256"],) \
        if prev is not None and prev[1].get("sha256") else ()
    manifest = publish_model(
        bst, publish_dir, f"model_g{gen:04d}.txt",
        canary=canary, keep=int(args.publish_keep),
        protect_shas=protect,
        metadata={
            "generation": gen,
            "train_auc": round(train_auc, 6),
            "refit_auc": None if refit_auc is None
            else round(refit_auc, 6),
            "data_digest": digest,
            "rounds": int(args.rounds),
            "num_trees": bst.num_trees(),
            "warm_start": args.warm_start if gen else "none",
        },
        retries=cfg.publish_retries,
        backoff_base_sec=cfg.publish_backoff_sec,
        fault_iteration=gen)
    # one {"event": "publish"} JSONL line rides the generation's
    # training telemetry (the recorder closed when train() returned;
    # appends to the same stream keep one post-mortem timeline)
    telem = os.environ.get("LIGHTGBM_TPU_TELEMETRY")
    if telem:
        try:
            # the publish span was recorded AFTER the recorder closed
            # (train() returned before publish_model ran): drain it —
            # and anything else pending — into the same stream
            from .obs.trace import drain_span_events
            spans = drain_span_events()
        except Exception:
            spans = []
        try:
            # fault events taken during publish (store_outage /
            # publish_torn / publish_poison retries) land on the
            # process-level log after the recorder closed — drain them
            # here or the post-mortem loses the retry evidence
            from .resilience.faults import FAULT_EVENTS, drain_events
            faults = drain_events(FAULT_EVENTS)
        except Exception:
            faults = []
        try:
            with open(telem, "a", encoding="utf-8") as fh:
                for ev in spans:
                    fh.write(json.dumps(ev) + "\n")
                for ev in faults:
                    fh.write(json.dumps(ev) + "\n")
                fh.write(json.dumps(
                    {"event": "publish", **manifest}) + "\n")
        except OSError:
            pass
    print(json.dumps({"event": "published", "generation": gen,
                      "file": manifest["file"],
                      "sha256": manifest["sha256"],
                      "train_auc": manifest["train_auc"]}),
          flush=True)
    return 0


# ---------------------------------------------------------------------
# the supervisor (torch-free)
# ---------------------------------------------------------------------

def _worker_cmd(args, gen: int) -> List[str]:
    cmd = [sys.executable, "-m", "lightgbm_tpu_torch", "pipeline",
           "--workdir", args.workdir, "--train-worker", str(gen),
           "--device-type", args.device_type,
           "--rounds", str(args.rounds), "--rows", str(args.rows),
           "--features", str(args.features),
           "--num-leaves", str(args.num_leaves),
           "--warm-start", args.warm_start,
           "--refit-decay", str(args.refit_decay),
           "--ingest-chunk-rows", str(args.ingest_chunk_rows),
           "--publish-keep", str(args.publish_keep),
           "--canary-rows", str(args.canary_rows),
           "--canary-tol", str(args.canary_tol),
           "--seed", str(args.seed)]
    for pair in args.param:
        cmd += ["--param", pair]
    return cmd


def _train_generation(args, gen: int, dirs: Dict[str, str],
                      train_faults: str, events: _EventLog) -> int:
    """One generation under the elastic supervisor (in-process call —
    elastic.supervise is torch-free)."""
    from .obs import trace as _trace
    from .resilience.elastic import supervise
    env = dict(os.environ)
    env["LIGHTGBM_TPU_CHECKPOINT"] = os.path.join(
        dirs["checkpoints"], f"g{gen:04d}")
    env["LIGHTGBM_TPU_TELEMETRY"] = os.path.join(
        dirs["telemetry"], f"train_g{gen:04d}.jsonl")
    # the generation's trace originates HERE: the workers inherit the
    # context through the env var, so their iteration spans and the
    # publisher's publish span (stamped into the manifest, picked up
    # by the serve watchers) all join this one trace
    trace_id, span_id = _trace.new_trace_id(), _trace.new_span_id()
    env[_trace.TRACE_CTX_ENV] = _trace.format_context(trace_id,
                                                      span_id)
    # also the supervisor's OWN current context while this generation
    # runs: the elastic supervisor's restart/world spans join it
    _trace.set_current_trace(trace_id, span_id)
    if train_faults:
        env["LIGHTGBM_TPU_FAULT_INJECT"] = train_faults
    else:
        env.pop("LIGHTGBM_TPU_FAULT_INJECT", None)
    events.write({"event": "pipeline", "phase": "train_start",
                  "generation": gen, "trace_id": trace_id,
                  "time": time.time()})
    t0 = time.perf_counter()
    rc = supervise(
        1, _worker_cmd(args, gen), max_restarts=args.max_restarts,
        # per-generation log dir: the fleet supervisor writes the
        # same elastic_g*_rank*.log names into ITS dir
        log_dir=os.path.join(dirs["logs"], f"train_g{gen:04d}"),
        grace=args.grace, env=env,
        max_restarts_per_window=args.max_restarts_per_window,
        restart_window_sec=args.restart_window,
        # metrics plane: trainer rank endpoints bind metrics_port+1+r
        # (supervise exports the env var); its fleet events (per-rank
        # iteration skew) land next to the generation's telemetry
        metrics_port=args.metrics_port or None,
        scrape_interval=args.scrape_interval
        if args.metrics_port else 0.0)
    _trace.record_span("pipeline/train", t0, trace_id=trace_id,
                       span_id=span_id,
                       attrs={"generation": gen, "rc": rc})
    # the supervisor's own spans land in pipeline.jsonl directly —
    # there is no recorder on this side to drain them
    for ev in _trace.drain_span_events():
        events.write(ev)
    events.write({"event": "pipeline", "phase": "train_done",
                  "generation": gen, "rc": rc, "time": time.time()})
    return rc


def _start_fleet(args, dirs: Dict[str, str], base_port: int,
                 serve_faults: str) -> subprocess.Popen:
    env = dict(os.environ)
    if serve_faults:
        env["LIGHTGBM_TPU_FAULT_INJECT"] = serve_faults
    else:
        env.pop("LIGHTGBM_TPU_FAULT_INJECT", None)
    env["LIGHTGBM_TPU_TELEMETRY"] = os.path.join(
        dirs["telemetry"], "serve.jsonl")
    cmd = [sys.executable, "-m", "lightgbm_tpu_torch", "launch",
           str(args.replicas),
           "--max-restarts", str(args.max_restarts),
           "--max-restarts-per-window",
           str(args.max_restarts_per_window),
           "--restart-window", str(args.restart_window),
           "--health-port", str(base_port),
           "--health-interval", str(args.health_interval),
           "--health-grace", str(args.health_grace),
           "--grace", str(args.grace),
           # rollback guard: the fleet supervisor watches the publish
           # target, adopts publications the fleet serves and rolls a
           # canary-refused one back to last-known-good
           "--publish-dir", dirs["publish"],
           "--rollback-grace", str(args.rollback_grace),
           # fleet scrape cadence: per-replica QPS/p99/shed/restarts
           # into telemetry/serve.jsonl.fleet (docs/OBSERVABILITY.md)
           "--scrape-interval", str(args.scrape_interval),
           "--log-dir", os.path.join(dirs["logs"], "fleet"), "--",
           sys.executable, "-m", "lightgbm_tpu_torch", "serve",
           dirs["publish"],
           "--port", str(base_port),
           "--device-type", args.device_type,
           "--watch-dir", dirs["publish"],
           "--watch-interval", "0.25",
           "--stats-interval", "1.0",
           "--shed-queue-rows", str(args.shed_queue_rows),
           "--shed-p99-ms", str(args.shed_p99_ms),
           "--grace", str(args.grace)]
    if args.max_replicas > 0:
        # replica autoscaling (resilience/autoscale.py): the fleet
        # supervisor spawns/retires replicas from the scrape signal
        idx = cmd.index("--log-dir")
        cmd[idx:idx] = [
            "--min-replicas", str(args.min_replicas or args.replicas),
            "--max-replicas", str(args.max_replicas),
            "--autoscale-up-qps", str(args.autoscale_up_qps),
            "--autoscale-down-qps", str(args.autoscale_down_qps),
            "--autoscale-up-p99-ms", str(args.autoscale_up_p99_ms),
            "--retire-grace", str(args.retire_grace)]
    if args.metrics_port:
        # fleet supervisor /metrics at base+2; it exports base+3 so
        # serve replica r binds base+3+r (the daemon adds its rank)
        idx = cmd.index("--log-dir")
        cmd[idx:idx] = ["--metrics-port", str(args.metrics_port + 2)]
    log_path = os.path.join(dirs["logs"], "fleet_supervisor.log")
    log_file = open(log_path, "ab")
    try:
        proc = subprocess.Popen(cmd, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    finally:
        log_file.close()
    return proc


def _wait_fleet_ready(ports: List[int], timeout: float) -> bool:
    from .resilience.elastic import replica_ping
    deadline = time.monotonic() + timeout
    pending = set(ports)
    while pending and time.monotonic() < deadline:
        for port in sorted(pending):
            if replica_ping(port, timeout=2.0):
                pending.discard(port)
        if pending:
            time.sleep(0.5)
    return not pending


def _confirm_swap(ports: List[int], want_sha: str,
                  timeout: float) -> bool:
    """Every replica reports a manifest-validated swap to the
    publication identified by ``want_sha`` (replicas may briefly
    disagree mid-rollout — or be mid-restart under chaos)."""
    deadline = time.monotonic() + timeout
    pending = set(ports)
    while pending and time.monotonic() < deadline:
        for port in sorted(pending):
            st = replica_stats(port, timeout=5.0)
            manifest = (st or {}).get("manifest") or {}
            if manifest.get("sha256") == want_sha:
                pending.discard(port)
        if pending:
            time.sleep(0.5)
    return not pending


def _read_fleet_events(path: str) -> List[Dict[str, Any]]:
    """Every parseable JSONL event in the fleet supervisor's stream
    (``telemetry/serve.jsonl.fleet``); [] when absent — the reader
    side of the autoscale / rollback confirmation."""
    events: List[Dict[str, Any]] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
    except OSError:
        pass
    return events


def _await_rollback(fleet_stream: str, bad_sha: str,
                    timeout: float) -> Optional[Dict[str, Any]]:
    """The fleet supervisor's ``{"event": "rollback"}`` record for
    ``bad_sha``, polling up to ``timeout`` seconds; None when the
    fleet never rolled that publication back."""
    deadline = time.monotonic() + timeout
    while True:
        for ev in _read_fleet_events(fleet_stream):
            if ev.get("event") == "rollback" \
                    and ev.get("bad_sha") == bad_sha:
                return ev
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.5)


def _fleet_lifecycle_summary(fleet_stream: str) -> Dict[str, Any]:
    """Autoscale / rollback / replica-peak roll-up from the fleet
    stream — the summary's proof that scaling and rollback actually
    happened (or didn't)."""
    ups = downs = rollbacks = 0
    peak = 0
    for ev in _read_fleet_events(fleet_stream):
        kind = ev.get("event")
        if kind == "autoscale":
            if ev.get("action") == "up":
                ups += 1
            elif ev.get("action") == "down":
                downs += 1
            peak = max(peak, int(ev.get("replicas") or 0))
        elif kind == "rollback":
            rollbacks += 1
        elif kind == "fleet":
            alive = sum(1 for r in (ev.get("replicas") or [])
                        if r.get("alive"))
            peak = max(peak, alive)
    return {"scale_ups": ups, "scale_downs": downs,
            "rollbacks": rollbacks, "replicas_peak": peak}


def _shutdown_fleet(fleet: subprocess.Popen, ports: List[int],
                    grace: float) -> None:
    """Graceful: ask every replica to drain and exit 0, so the fleet
    supervisor sees a clean fleet and exits 0 itself."""
    for port in ports:
        _rpc(port, {"cmd": "shutdown"}, timeout=5.0)
    try:
        fleet.wait(timeout=max(30.0, 2 * grace))
        return
    except subprocess.TimeoutExpired:
        pass
    from .resilience.elastic import _kill_group
    _kill_group(fleet)


def main(argv: Optional[List[str]] = None) -> int:
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if args.train_worker is not None:
        # torch side: one supervised retrain generation
        return _train_worker(args)

    workdir = os.path.abspath(args.workdir)
    dirs = {name: os.path.join(workdir, name)
            for name in ("publish", "checkpoints", "telemetry",
                         "logs")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    if args.generations < 1 or args.replicas < 1:
        print("pipeline: --generations and --replicas must be >= 1",
              file=sys.stderr)
        return 2
    fault_spec = args.fault_inject \
        if args.fault_inject is not None \
        else os.environ.get("LIGHTGBM_TPU_FAULT_INJECT", "")
    train_faults, serve_faults = _split_faults(fault_spec)

    from .resilience.elastic import _free_port
    from .resilience.publisher import latest_manifest
    base_port = args.port or _free_port()
    if args.max_replicas > 0:
        # autoscaling fleet: swap confirmation polls only the
        # always-active floor (the autoscaler retires from the top
        # rank down, so ranks below the floor never disappear); the
        # load generator targets the whole potential range and backs
        # off ports that are legitimately down
        floor = min(args.replicas, args.min_replicas or args.replicas)
        span = max(args.replicas, args.max_replicas)
    else:
        floor = span = args.replicas
    ports = [base_port + r for r in range(max(1, floor))]
    ready_ports = [base_port + r for r in range(args.replicas)]
    all_ports = [base_port + r for r in range(span)]
    fleet_stream = os.path.join(dirs["telemetry"],
                                "serve.jsonl.fleet")
    events = _EventLog(os.path.join(dirs["telemetry"],
                                    "pipeline.jsonl"))
    client_metrics = _ClientMetrics()
    if args.metrics_port:
        # the supervisor's own torch-free /metrics: supervisor counters
        # (restart budget, publish totals) + the loadgen client view
        from .obs.export import ensure_metrics_server
        ensure_metrics_server(args.metrics_port,
                              extra_families=client_metrics.families)
    events.write({"event": "pipeline", "phase": "start",
                  "generations": args.generations,
                  "replicas": args.replicas, "ports": all_ports,
                  "max_replicas": args.max_replicas,
                  "warm_start": args.warm_start,
                  "fault_inject": fault_spec, "time": time.time()})
    fleet: Optional[subprocess.Popen] = None
    loadgen: Optional[LoadGenerator] = None
    spike_stop = threading.Event()
    failures: List[str] = []
    rollbacks: List[Dict[str, Any]] = []
    swaps_confirmed = 0
    published: List[Dict[str, Any]] = []
    try:
        # ---- generation 0: bootstrap model, then bring up the fleet
        rc = _train_generation(args, 0, dirs, train_faults, events)
        if rc != 0:
            failures.append(f"generation 0 training failed (exit {rc})")
            return _finish(args, events, failures, published,
                           swaps_confirmed, None, loadgen,
                           rollbacks, fleet_stream)
        first = latest_manifest(dirs["publish"])
        if first is None:
            failures.append("generation 0 published nothing usable")
            return _finish(args, events, failures, published,
                           swaps_confirmed, None, loadgen,
                           rollbacks, fleet_stream)
        published.append(first[1])
        fleet = _start_fleet(args, dirs, base_port, serve_faults)
        if not _wait_fleet_ready(ready_ports,
                                 timeout=args.swap_timeout):
            failures.append(f"serve fleet never became ready on "
                            f"ports {ready_ports}")
            return _finish(args, events, failures, published,
                           swaps_confirmed, None, loadgen,
                           rollbacks, fleet_stream)
        events.write({"event": "pipeline", "phase": "fleet_ready",
                      "ports": ready_ports, "time": time.time()})
        if args.request_rate > 0:
            loadgen = LoadGenerator(
                all_ports, args.features,
                rate_per_sec=args.request_rate,
                rows_per_request=args.request_rows,
                event_log=events, trace_every=args.trace_every)
            loadgen.start()
            client_metrics.attach(loadgen)
            if args.spike_rate > 0:
                threading.Thread(
                    target=_drive_spike,
                    args=(loadgen, events, args.request_rate,
                          args.spike_rate, args.spike_start,
                          args.spike_duration, spike_stop),
                    daemon=True,
                    name="lightgbm-tpu-pipeline-spike").start()
        # the bootstrap model was loaded at startup, not hot-swapped:
        # confirm the fleet serves it before retraining begins
        if not _confirm_swap(ports, first[1]["sha256"],
                             timeout=args.swap_timeout):
            # startup path reports no manifest (the daemon loaded the
            # file directly): fall back to source-path confirmation
            ok = all((replica_stats(p, timeout=5.0) or {})
                     .get("model_source") == first[0] for p in ports)
            if not ok:
                failures.append(
                    "fleet did not confirm the bootstrap model")

        # ---- retrain generations
        for gen in range(1, args.generations):
            rc = _train_generation(args, gen, dirs, train_faults,
                                   events)
            if rc != 0:
                failures.append(
                    f"generation {gen} training failed (exit {rc})")
                break
            latest = latest_manifest(dirs["publish"])
            if latest is None or latest[1].get("generation") != gen:
                failures.append(
                    f"generation {gen} publication missing/invalid")
                break
            published.append(latest[1])
            if _confirm_swap(ports, latest[1]["sha256"],
                             timeout=args.swap_timeout):
                swaps_confirmed += 1
                events.write({"event": "pipeline",
                              "phase": "swap_confirmed",
                              "generation": gen,
                              "sha256": latest[1]["sha256"],
                              "time": time.time()})
                continue
            # the fleet refused the swap: a canary-gated rollback by
            # the fleet supervisor is SUCCESS for the service (the
            # fleet kept last-known-good and superseded the bad
            # publication), not a pipeline failure
            rb = _await_rollback(fleet_stream, latest[1]["sha256"],
                                 timeout=min(60.0, args.swap_timeout))
            if rb is not None:
                rollbacks.append(
                    {"generation": gen,
                     "bad_sha": rb.get("bad_sha"),
                     "good_sha": rb.get("good_sha"),
                     "good_file": rb.get("good_file")})
                events.write({"event": "pipeline",
                              "phase": "rollback_confirmed",
                              "generation": gen, **{
                                  k: rb.get(k)
                                  for k in ("bad_sha", "good_sha",
                                            "good_file")},
                              "time": time.time()})
                good_sha = rb.get("good_sha")
                if good_sha and not _confirm_swap(
                        ports, good_sha, timeout=args.swap_timeout):
                    failures.append(
                        f"fleet rolled generation {gen} back but "
                        "never converged on the last-known-good "
                        f"model {good_sha[:12]}")
                    break
                continue
            failures.append(
                f"fleet never confirmed generation {gen}'s "
                "publication within the swap timeout")
            break
        return _finish(args, events, failures, published,
                       swaps_confirmed, ports, loadgen,
                       rollbacks, fleet_stream)
    finally:
        spike_stop.set()
        if loadgen is not None:
            loadgen.stop()
        if fleet is not None and not args.keep_fleet:
            _shutdown_fleet(fleet, all_ports, args.grace)
        elif fleet is not None:
            log_info(f"pipeline: fleet left running on ports "
                     f"{all_ports} (--keep-fleet)")
        events.close()


def _finish(args, events: _EventLog, failures: List[str],
            published: List[Dict[str, Any]], swaps_confirmed: int,
            ports: Optional[List[int]],
            loadgen: Optional[LoadGenerator],
            rollbacks: Optional[List[Dict[str, Any]]] = None,
            fleet_stream: Optional[str] = None) -> int:
    client = None if loadgen is None else loadgen.snapshot()
    summary: Dict[str, Any] = {
        "event": "pipeline_summary",
        "generations_requested": args.generations,
        "generations_published": len(published),
        "swaps_confirmed": swaps_confirmed,
        "rollbacks": rollbacks or [],
        "last_published_sha256":
            published[-1]["sha256"] if published else None,
        "last_published_generation":
            published[-1].get("generation") if published else None,
        "train_auc_by_generation":
            [m.get("train_auc") for m in published],
        "failures": failures,
        "time": time.time(),
    }
    if ports:
        fleet_stats = [replica_stats(p, timeout=5.0) for p in ports]
        summary["fleet"] = [
            None if st is None else
            {"model": st.get("model"),
             "model_source": st.get("model_source"),
             "manifest_sha256":
                 (st.get("manifest") or {}).get("sha256"),
             "requests_total": st.get("requests_total"),
             "shed_total": st.get("shed_total"),
             "swap_failures": st.get("swap_failures"),
             "swaps_total": st.get("swaps_total")}
            for st in fleet_stats]
    if fleet_stream is not None:
        summary["fleet_lifecycle"] = \
            _fleet_lifecycle_summary(fleet_stream)
    summary["client"] = client
    events.write(summary)
    print(json.dumps(summary), flush=True)
    if failures:
        for f in failures:
            log_warning(f"pipeline: FAILED: {f}")
        return 1
    log_info(f"pipeline: {len(published)} generation(s) trained, "
             f"published and served; last model "
             f"{summary['last_published_sha256'][:12]}…")
    return 0
