"""``python -m lightgbm_tpu_torch serve <model>``: the inference daemon.

Counterpart of ``lightgbm_tpu/serve/daemon.py``: a stdlib-socket
JSON-lines server over one compiled forest (``serve/compile.py``) and
one micro-batcher (``serve/batcher.py``), on the card unless
``--device-type cpu`` is given.

- **Protocol** (one JSON object per line, one JSON reply per line)::

      {"rows": [[...], ...]}            -> {"predictions": [...], "n": n,
                                            "model": id}
      {"features": [...]}               -> one row
      {"rows": [...], "raw": true}      -> raw scores, no objective
                                           transform
      {"rows": [...], "trace": {"trace_id": ..., "span_id": ...}}
                                        -> request spans in the stream
      {"cmd": "ping"}                   -> {"ok": true, "model": ...,
                                            "pid": ...}
      {"cmd": "stats"}                  -> queue/latency/model snapshot
      {"cmd": "metrics"}                -> OpenMetrics text
                                           (obs/export.py)
      {"cmd": "shutdown"}               -> drains, then stops

- **Hot model swap**: ``--watch-dir`` polls a watch target (a local
  directory, or an artifact-store spec such as ``mem://<name>``;
  ``resilience/store.py``) for the newest model artifact: ``*.txt``
  model files, or ``ckpt_*.npz`` training snapshots on a local target.
  The new forest is staged on the host on the watcher's thread and
  written into the old forest's device tensors between batches
  (``CompiledForest.attach``), so in-flight requests finish on the
  model they started with. A publication with a manifest
  (``resilience/publisher.py``) is sha256-checked first: a torn one is
  skipped with a ``swap_failure`` fault event and retried at the next
  poll. A manifest's **canary** (rows and the publisher's raw scores)
  is scored through the real compiled forest before the swap; a
  mismatch refuses it with a ``canary_refused`` fault event. The same
  gates hold at startup: a daemon started on a directory whose newest
  publication fails its canary serves the newest older artifact that
  passes (the JAX daemon loads the newest one unchecked). A store
  outage degrades to serving the current model with a ``store_outage``
  event. A failed load, compile or upload keeps the current model
  serving on its device, with a ``swap_failure`` event: a swap never
  moves serving to the CPU.

- **Overload**: beyond the ``QueueFullError`` admission wall
  (``{"overloaded": true}``), ``--shed-queue-rows`` / ``--shed-p99-ms``
  shed the oldest queued requests with a typed ``{"shed": true}``
  reply.

- **Graceful shutdown**: SIGTERM and ``shutdown`` drain accepted
  requests, bounded by ``--grace``, before the socket closes; during
  the drain new predict requests get a typed ``{"error": "draining"}``.

- **Telemetry**: ``{"event": "serve"}`` lines every
  ``--stats-interval`` seconds (QPS, queue depth, p50/p99, recompiles,
  device memory, swaps), with the fault and span events before them,
  to ``--telemetry`` or ``$LIGHTGBM_TPU_TELEMETRY``; ``python -m
  lightgbm_tpu_torch stats`` folds them.

This module's import, ``--help`` and the bad-model-path errors import
no torch (``__main__`` dispatches ``serve`` before the training CLI
loads); torch loads once a model is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import socketserver
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..log import log_info, log_warning

__all__ = ["main", "build_parser", "handle_request", "ServeState"]


# ---------------------------------------------------------------------
# serving state (model + batcher + telemetry), shared across the
# request-handler, watcher and stats threads
# ---------------------------------------------------------------------

class ServeState:
    """Everything the handler, watcher and stats threads share.

    Threading contract: mutable fields are only touched under
    ``self._lock``; model compilation and device work always happen
    outside it.
    """

    def __init__(self, batcher, model_id: str, model_source: str,
                 registry=None, telemetry_path: Optional[str] = None,
                 manifest: Optional[Dict[str, Any]] = None):
        from ..obs.jit_tracker import RecompileWatcher
        from ..obs.registry import registry as global_registry
        from ..resilience.faults import FaultPlan
        self.batcher = batcher
        self.registry = registry if registry is not None \
            else global_registry
        self._lock = threading.Lock()
        # ---- guarded by self._lock ----
        self._model_id = model_id
        self._model_source = model_source
        self._manifest: Optional[Dict[str, Any]] = \
            dict(manifest) if manifest else None
        self._swap_failures = 0
        self._shed_replies = 0
        self._requests_accepted = 0
        self._active_handlers = 0
        self._draining = False
        self._last_stats: Dict[str, Any] = {}
        # newest computed rates, cached so a /metrics scrape exports
        # them without consuming the stats() rate window
        self._last_rates: Dict[str, Any] = {}
        self._telemetry_file = None
        self.shutdown_event = threading.Event()
        self._t0 = time.monotonic()
        self._watcher = RecompileWatcher()
        self.fault_plan = FaultPlan.from_env()
        if telemetry_path:
            try:
                dirname = os.path.dirname(os.path.abspath(
                    telemetry_path))
                os.makedirs(dirname, exist_ok=True)
                self._telemetry_file = open(telemetry_path, "a",
                                            encoding="utf-8")
            except OSError as e:
                log_warning(f"serve: cannot open telemetry path "
                            f"{telemetry_path!r} ({e}); serve events "
                            "will not be written")

    # -- model identity ------------------------------------------------
    def model_id(self) -> str:
        with self._lock:
            return self._model_id

    def model_source(self) -> str:
        with self._lock:
            return self._model_source

    def note_swap(self, model_id: str, source: str,
                  manifest: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self._model_id = model_id
            self._model_source = source
            self._manifest = dict(manifest) if manifest else None
        self.registry.counter("serve_swaps").inc()

    def note_swap_failure(self) -> None:
        with self._lock:
            self._swap_failures += 1
        self.registry.counter("serve_swap_failures").inc()

    def note_shed(self) -> None:
        with self._lock:
            self._shed_replies += 1
        self.registry.counter("serve_shed_requests").inc()

    def count_request(self) -> int:
        """Ordinal of this accepted predict request (1-based), feeding
        the ``serve_kill@N`` fault hook."""
        with self._lock:
            self._requests_accepted += 1
            return self._requests_accepted

    # -- graceful shutdown bookkeeping ---------------------------------
    # in-flight REQUEST accounting, not connection accounting: a
    # handler blocked reading an idle keep-alive connection has no
    # reply pending and must not make the drain wait out the deadline
    def handler_enter(self) -> None:
        with self._lock:
            self._active_handlers += 1

    def handler_exit(self) -> None:
        with self._lock:
            self._active_handlers -= 1

    def active_handlers(self) -> int:
        with self._lock:
            return self._active_handlers

    def request_shutdown(self) -> None:
        self.shutdown_event.set()

    def begin_drain(self) -> None:
        """Flip predict requests to the typed ``{"error": "draining"}``
        refusal; ``ping``/``stats``/``metrics`` keep answering."""
        with self._lock:
            self._draining = True

    def draining(self) -> bool:
        with self._lock:
            return self._draining

    # -- telemetry -----------------------------------------------------
    def _memory(self) -> Dict[str, Any]:
        """Device memory gauges of the served forest's device (nulls on
        the CPU)."""
        from ..obs.memory import device_memory_stats
        forest = self.batcher._current_forest()
        return device_memory_stats(getattr(forest, "device", None))

    def stats(self) -> Dict[str, Any]:
        """The ``stats`` reply and serve-event payload.

        Rates cover the window since the previous stats() call by any
        consumer. The rate baseline, the recompile watcher and the model
        metadata are read-modify-written inside one locked section, so
        concurrent pollers neither double-count a window nor tear the
        watcher. Device queries stay outside the lock."""
        snap = self.batcher.stats()
        hbm = self._memory()
        with self._lock:
            model_id = self._model_id
            source = self._model_source
            manifest = dict(self._manifest) if self._manifest else None
            failures = self._swap_failures
            shed_replies = self._shed_replies
            draining = self._draining
            last = dict(self._last_stats)
            uptime = time.monotonic() - self._t0
            recompiles = {"delta": self._watcher.delta(),
                          "total": self._watcher.total}
            self._last_stats = {"uptime_s": uptime,
                                "requests_total": snap["requests_total"],
                                "rows_total": snap["rows_total"]}
        dt = uptime - last.get("uptime_s", 0.0)
        dreq = snap["requests_total"] - last.get("requests_total", 0)
        drows = snap["rows_total"] - last.get("rows_total", 0)
        out = dict(snap)
        out["model"] = model_id
        out["model_source"] = source
        out["manifest"] = manifest
        out["swap_failures"] = failures
        out["shed_replies"] = shed_replies
        out["draining"] = draining
        out["uptime_s"] = round(uptime, 3)
        out["qps"] = round(dreq / dt, 3) if dt > 0 else 0.0
        out["rows_per_sec"] = round(drows / dt, 3) if dt > 0 else 0.0
        out["recompiles"] = recompiles
        out["hbm"] = hbm
        self.registry.gauge("serve_queue_depth_rows").set(
            snap["queue_depth_rows"])
        with self._lock:
            self._last_rates = {"qps": out["qps"],
                                "rows_per_sec": out["rows_per_sec"]}
        return out

    # -- OpenMetrics export (obs/export.py) ----------------------------
    def metrics_families(self) -> Dict[str, Any]:
        """Serve-side families merged into the /metrics render and the
        ``{"cmd": "metrics"}`` verb: the batcher's cumulative counters
        and percentiles (non-destructive reads), the newest rate window,
        device memory gauges, and the serving model's id and publication
        sha as an info-style labelled gauge."""
        from ..obs.export import counter_family, gauge_family
        snap = self.batcher.stats()
        hbm = self._memory()
        with self._lock:
            model_id = self._model_id
            rates = dict(self._last_rates)
            sha = (self._manifest or {}).get("sha256") or ""
        fams: Dict[str, Any] = {
            "serve_requests": counter_family(snap["requests_total"]),
            "serve_rows": counter_family(snap["rows_total"]),
            "serve_batches": counter_family(snap["batches_total"]),
            "serve_rejected": counter_family(snap["rejected_total"]),
            "serve_shed": counter_family(snap["shed_total"]),
            "serve_shed_rows": counter_family(snap["shed_rows"]),
            "serve_queue_depth_rows":
                gauge_family(snap["queue_depth_rows"]),
            "serve_p50_ms": gauge_family(snap["p50_ms"]),
            "serve_p99_ms": gauge_family(snap["p99_ms"]),
            "serve_qps": gauge_family(rates.get("qps")),
            "serve_rows_per_sec":
                gauge_family(rates.get("rows_per_sec")),
            "serve_model_info": gauge_family(1, model=str(model_id),
                                             sha=str(sha)),
        }
        for key in ("bytes_in_use", "peak_bytes_in_use"):
            if hbm.get(key) is not None:
                fams[f"hbm_{key}"] = gauge_family(hbm[key])
        return fams

    def render_metrics(self) -> str:
        """OpenMetrics text for the protocol verb: the process registry
        plus the serve families."""
        from ..obs.export import render_openmetrics
        return render_openmetrics(self.registry.snapshot(),
                                  extra=self.metrics_families())

    def emit_serve_event(self) -> None:
        """One ``{"event": "serve"}`` JSONL line, after the process's
        fault events (``swap_failure``, ``canary_refused``, ...), compile
        events and span events drained since the last one. An unwritable file
        stops the stream, never serving."""
        from ..obs.cost import drain_compile_events
        from ..obs.trace import drain_span_events
        from ..resilience.faults import FAULT_EVENTS, drain_events
        # the walk's new signatures carry their cost attribution in
        events = drain_events(FAULT_EVENTS) + drain_compile_events() \
            + drain_span_events()
        payload = {"event": "serve", **self.stats()}
        with self._lock:
            fh = self._telemetry_file
            if fh is None:
                return
            try:
                for ev in events:
                    fh.write(json.dumps(ev) + "\n")
                fh.write(json.dumps(payload) + "\n")
                fh.flush()
            except OSError as e:
                log_warning(f"serve: telemetry write failed ({e}); "
                            "stopping the event stream")
                try:
                    fh.close()
                except OSError:
                    pass
                self._telemetry_file = None

    def close(self) -> None:
        self.request_shutdown()
        self.batcher.close()
        with self._lock:
            fh, self._telemetry_file = self._telemetry_file, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass


# ---------------------------------------------------------------------
# request handling (a function over ServeState: testable without
# sockets)
# ---------------------------------------------------------------------

def handle_request(obj: Any, state: ServeState) -> Dict[str, Any]:
    """One protocol request -> one reply object."""
    if not isinstance(obj, dict):
        return {"error": "request must be a JSON object"}
    if "cmd" in obj:
        cmd = obj["cmd"]
        if cmd == "ping":
            return {"ok": True, "model": state.model_id(),
                    "pid": os.getpid()}
        if cmd == "stats":
            return {"ok": True, **state.stats()}
        if cmd == "metrics":
            from ..obs.export import CONTENT_TYPE
            try:
                body = state.render_metrics()
            except Exception as e:
                return {"error": f"metrics render failed: {e}"}
            return {"ok": True, "content_type": CONTENT_TYPE,
                    "metrics": body}
        if cmd == "shutdown":
            state.request_shutdown()
            return {"ok": True, "shutting_down": True}
        return {"error": f"unknown cmd: {cmd!r}"}
    rows = obj.get("rows", obj.get("features"))
    if rows is None:
        return {"error": "expected 'rows' (list of feature rows), "
                         "'features' (one row) or 'cmd'"}
    if state.draining():
        # a typed refusal, not a hang: the client retries elsewhere
        return {"error": "draining", "draining": True,
                "model": state.model_id()}
    import numpy as np
    try:
        X = np.asarray(rows, np.float32)
    except (TypeError, ValueError) as e:
        return {"error": f"rows are not a numeric matrix: {e}"}
    if X.ndim == 1:
        X = X[None, :]
    if X.ndim != 2 or X.shape[0] == 0:
        return {"error": f"rows must be [n, n_features], got shape "
                         f"{X.shape}"}
    # serve_kill@N fires BEFORE the request enters the batcher: a killed
    # replica never holds an accepted-but-unanswered request
    state.fault_plan.maybe_serve_kill(state.count_request())
    trace_ctx = obj.get("trace")
    if not isinstance(trace_ctx, dict) \
            or not trace_ctx.get("trace_id"):
        trace_ctx = None
    from .batcher import QueueFullError, SheddingError
    try:
        fut = state.batcher.submit(X, trace=trace_ctx)
    except QueueFullError as e:
        return {"error": str(e), "overloaded": True}
    except (ValueError, RuntimeError) as e:
        return {"error": str(e)}
    try:
        raw_scores = fut.result()
    except SheddingError as e:
        state.note_shed()
        return {"error": str(e), "shed": True, "overloaded": True,
                "model": state.model_id()}
    except Exception as e:                       # batch-level failure
        return {"error": f"prediction failed: {e}"}
    # finalize with the forest that produced the scores (stamped by the
    # batcher's worker): a swap completing between dispatch and here
    # must not apply the new model's transform to the old one's scores
    forest = getattr(fut, "serving_forest", None)
    if forest is None:
        forest = state.batcher._current_forest()
    out = forest.finalize(raw_scores,
                          raw_score=bool(obj.get("raw", False)))
    model_id = getattr(forest, "model_id", None) or state.model_id()
    times = getattr(fut, "trace_times", None)
    if trace_ctx is not None and times is not None:
        _record_request_spans(trace_ctx, times, model_id,
                              int(X.shape[0]))
    return {"predictions": out.tolist(), "n": int(X.shape[0]),
            "model": model_id}


def _record_request_spans(trace_ctx: Dict[str, Any], times, model_id,
                          n_rows: int) -> None:
    """Spans of one sampled request: ``serve/request`` over submit ->
    reply, with ``serve/queue_wait``, ``serve/batch_window``,
    ``serve/dispatch`` and ``serve/reply`` children from the batcher's
    ``perf_counter`` stamps. Never raises into the reply."""
    try:
        from ..obs import trace as _trace
        t_submit, t_dequeue, t_dispatch, t_done = times
        now = time.perf_counter()
        tid = trace_ctx.get("trace_id")
        parent = _trace.record_span(
            "serve/request", t_submit, now, trace_id=tid,
            parent_id=trace_ctx.get("span_id"),
            attrs={"model": model_id, "rows": n_rows})
        for name, a, b in (
                ("serve/queue_wait", t_submit, t_dequeue),
                ("serve/batch_window", t_dequeue, t_dispatch),
                ("serve/dispatch", t_dispatch, t_done),
                ("serve/reply", t_done, now)):
            _trace.record_span(name, a, b, trace_id=tid,
                               parent_id=parent)
    except Exception as e:
        log_warning(f"serve: request spans not recorded ({e})")


# ---------------------------------------------------------------------
# socket server
# ---------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        state: ServeState = self.server.state  # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            # the REQUEST is in flight from parse to flushed reply; the
            # drain waits for exactly this window
            state.handler_enter()
            try:
                try:
                    obj = json.loads(line.decode("utf-8"))
                except (UnicodeDecodeError, ValueError):
                    resp = {"error": "malformed JSON line"}
                else:
                    resp = handle_request(obj, state)
                try:
                    self.wfile.write((json.dumps(resp) + "\n")
                                     .encode("utf-8"))
                    self.wfile.flush()
                except OSError:
                    return                  # client went away mid-reply
            finally:
                state.handler_exit()
            if resp.get("shutting_down"):
                return
            if state.shutdown_event.is_set():
                # the reply to every request read so far is on the
                # wire; stop reading and close, so the client sees EOF
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True       # supervised restarts rebind fast
    daemon_threads = True


# ---------------------------------------------------------------------
# model loading + watching
# ---------------------------------------------------------------------

def _is_model_name(name: str, local: bool) -> bool:
    """Artifact names the watcher considers: model text everywhere,
    checkpoint snapshots only on local targets (``load_snapshot`` needs a
    real file)."""
    if name.endswith(".txt"):
        return True
    return local and name.startswith("ckpt_") and name.endswith(".npz")


def _member_id(store, name: str) -> str:
    """Stable identity of one store member: the joined path on a local
    directory, ``url/name`` elsewhere."""
    from ..resilience.store import LocalDirStore
    if isinstance(store, LocalDirStore):
        return os.path.join(store.directory, name)
    return f"{store.url}/{name}"


def _find_model_artifact_in(store) -> Optional[Tuple[float, str]]:
    """Newest model artifact name in ``store``: ``(mtime, name)``.
    Raises ``OSError`` (``StoreError``) when the store cannot be
    listed."""
    from ..resilience.store import LocalDirStore
    local = isinstance(store, LocalDirStore)
    best: Optional[Tuple[float, str]] = None
    for name in store.list_names():
        if not _is_model_name(name, local):
            continue
        st = store.stat(name)
        if st is None:
            continue
        key = (st[0], name)
        if best is None or key > best:
            best = key
    return best


def _find_model_artifact(directory: str) \
        -> Optional[Tuple[float, str]]:
    """Newest model artifact in directory ``directory``:
    ``(mtime, path)``."""
    from ..resilience.store import LocalDirStore
    try:
        found = _find_model_artifact_in(LocalDirStore(directory))
    except OSError:
        return None
    if found is None:
        return None
    mtime, name = found
    return (mtime, os.path.join(directory, name))


def _checked(booster, where: str):
    """Reject a model with no trees: the lenient model-text parser would
    let any stray ``.txt`` replace a good model with a constant one."""
    if not booster._models:
        from ..basic import LightGBMError
        raise LightGBMError(f"{where}: parsed to a model with no trees")
    return booster


def _load_booster(path: str, device_type: str):
    """A Booster on ``device_type`` from a model text file or a
    training checkpoint snapshot."""
    from ..basic import Booster
    params = {"device_type": device_type}
    if path.endswith(".npz"):
        from ..resilience.checkpoint import load_snapshot
        snap = load_snapshot(path)
        booster = Booster(model_str=snap["model_str"], params=params)
    else:
        booster = Booster(model_file=path, params=params)
    return _checked(booster, path)


def _load_booster_in(store, name: str, device_type: str):
    """A Booster from one store member; local targets keep the
    path-based loader (snapshots need a real file)."""
    from ..resilience.store import LocalDirStore
    if isinstance(store, LocalDirStore):
        return _load_booster(os.path.join(store.directory, name),
                             device_type)
    from ..basic import Booster
    booster = Booster(model_str=store.get_bytes(name).decode("utf-8"),
                      params={"device_type": device_type})
    return _checked(booster, _member_id(store, name))


def _artifact_key(path: str) -> Tuple[str, float, int]:
    st = os.stat(path)
    return (path, st.st_mtime, st.st_size)


def _artifact_key_in(store, name: str) -> Tuple[str, float, int]:
    """``(identity, mtime, size)``: the key :func:`_artifact_key` gives
    a local member, so watch state primed from a path keeps matching."""
    st = store.stat(name)
    if st is None:
        raise FileNotFoundError(_member_id(store, name))
    return (_member_id(store, name), st[0], st[1])


class _Watcher:
    """Polls a watch target (a directory, a store spec or an
    ``ArtifactStore``) and hot-swaps the newest model artifact into the
    batcher. Runs on its own thread; the new forest is staged on the
    host here, off the serving path, and the swap itself is applied by
    the batcher's worker between batches. The new model is loaded on
    the served forest's device."""

    def __init__(self, state: ServeState, watch_dir,
                 interval_s: float, compile_kwargs: Dict[str, Any],
                 current_key: Optional[Tuple[str, float, int]],
                 warmup_rows: Optional[int]):
        from ..resilience.store import store_for
        self.state = state
        self.store = store_for(watch_dir)
        self.watch_dir = self.store.url
        self.interval_s = max(0.05, float(interval_s))
        self.compile_kwargs = dict(compile_kwargs)
        self.warmup_rows = warmup_rows
        self._last_key = current_key
        self._failed_key: Optional[Tuple[str, float, int]] = None
        self._degraded = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="lightgbm-tpu-torch-serve-watcher")

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        while not self.state.shutdown_event.wait(self.interval_s):
            self.poll_once()

    def poll_once(self) -> bool:
        """One poll; True when a swap happened."""
        try:
            found = _find_model_artifact_in(self.store)
        except OSError as e:
            # a store outage degrades: keep serving the current model,
            # say so once per outage episode, retry at the next poll
            if not self._degraded:
                self._degraded = True
                log_warning(f"serve: watch target {self.watch_dir!r} "
                            f"unreachable ({e}); serving the current "
                            "model and retrying next poll")
                from ..resilience.faults import record_fault_event
                record_fault_event(
                    "store_outage", action="degraded",
                    detail=f"watch target {self.watch_dir} "
                           f"unreachable: {e}")
            return False
        self._degraded = False
        if found is None:
            return False
        _, name = found
        try:
            key = _artifact_key_in(self.store, name)
        except OSError:
            return False
        path = _member_id(self.store, name)
        # _last_key/_failed_key are only touched on this thread (and in
        # the constructor, before it starts)
        if key == self._last_key:
            return False
        try:
            # a managed artifact whose bytes mismatch its manifest is a
            # torn publication: skipped, never served. Unmanaged
            # artifacts are served once they parse.
            from ..resilience.publisher import validate_artifact_in
            t_poll = time.perf_counter()
            manifest = validate_artifact_in(self.store, name)
            t_valid = time.perf_counter()
            old = self.state.batcher._current_forest()
            booster = _load_booster_in(self.store, name, old.device.type)
            t_load = time.perf_counter()
            from .compile import compile_forest
            # stage on the host on this thread (no device memory, no
            # serving pause); the worker-side attach does the upload
            staged = compile_forest(booster, stage=True,
                                    **self.compile_kwargs)
            if staged.n_features != old.n_features:
                raise ValueError(
                    f"new model expects {staged.n_features} features, "
                    f"the served one {old.n_features} — clients would "
                    "break; refusing the swap")
            canary_forest = self._score_canary(manifest, staged, key)
            # the swap rides the request queue: the worker applies it
            # between batches, where the old forest is idle. On the
            # canary path the new forest is already on the device;
            # otherwise attach() writes it into the old forest's
            # tensors when the layouts match
            t_stage = time.perf_counter()
            if canary_forest is not None:
                fut = self.state.batcher.swap_deferred(
                    lambda old_forest: canary_forest)
            else:
                fut = self.state.batcher.swap_deferred(
                    lambda old_forest: staged.attach(reuse=old_forest))
            try:
                forest = fut.result(timeout=300)
            except Exception:
                # a swap whose outcome we stop observing must not apply
                # later unreported: cancel it; if it raced in, take it
                if not fut.cancel() and fut.done() \
                        and fut.exception() is None:
                    forest = fut.result()
                else:
                    raise
        except Exception as e:
            # a torn, corrupt or refused artifact never takes down the
            # old model: _last_key stays, so the next poll retries. The
            # event and warning fire once per observed key; the counter
            # counts every failed attempt
            first_sighting = key != self._failed_key
            self._failed_key = key
            if first_sighting:
                log_warning(f"serve: hot swap from {path!r} failed "
                            f"({e}); keeping the current model and "
                            "retrying next poll")
                from ..resilience.faults import record_fault_event
                record_fault_event(
                    "swap_failure", action="retry_next_poll",
                    detail=f"hot swap from {path} failed: {e}")
            self.state.note_swap_failure()
            return False
        self._last_key = key
        self._failed_key = None
        # the identity changes the moment the new model serves; warmup
        # is an optimization and its failure is not a failed swap
        self.state.note_swap(forest.model_id, path, manifest=manifest)
        self._record_swap_spans(
            manifest, path, forest.model_id,
            (t_poll, t_valid, t_load, t_stage, time.perf_counter()))
        log_info(f"serve: hot-swapped model from {path} "
                 f"(id {forest.model_id})")
        if self.warmup_rows != 0:
            try:
                forest.warmup(self.warmup_rows)
            except Exception as e:
                log_warning(f"serve: post-swap warmup failed ({e}); "
                            "buckets will be walked on demand")
        return True

    def _score_canary(self, manifest, staged, key):
        """The canary gate: score the manifest's validation rows through
        the real compiled forest before the swap is offered. Returns the
        attached forest on a pass (what was validated is what serves),
        None when there is no canary or a ``--num-iteration`` trim makes
        the publisher's full-model scores inapplicable; raises on a
        mismatch (the ``publish_poison`` shape)."""
        canary = (manifest or {}).get("canary")
        if not canary:
            return None
        trim = self.compile_kwargs.get("num_iteration")
        if trim is not None and int(trim) > 0:
            log_info("serve: skipping canary validation (serving a "
                     f"--num-iteration {int(trim)} trim; the canary "
                     "scores the full published model)")
            return None
        # a plain attach, no reuse: the old forest still serves traffic
        # while the canary runs
        forest = staged.attach()
        bad = _canary_mismatch(manifest, forest, self.compile_kwargs)
        if bad is not None:
            worst, tol, n = bad
            if key != self._failed_key:   # once per observed artifact
                from ..resilience.faults import record_fault_event
                record_fault_event(
                    "canary_refused", action="refused_swap",
                    detail=f"canary mismatch on {key[0]}: worst "
                           f"|raw - expected| {worst:.6g} > tol "
                           f"{tol:g} over {n} rows")
            raise ValueError(
                f"canary validation failed: worst |raw - expected| "
                f"{worst:.6g} exceeds tol {tol:g} — the publication "
                "is byte-valid but scores wrong; refusing the swap")
        return forest

    @staticmethod
    def _record_swap_spans(manifest, path: str, model_id,
                           times) -> None:
        """``swap/validate``, ``swap/load``, ``swap/stage`` and
        ``swap/apply`` spans of one swap, under the trace the publisher
        stamped into the manifest (a fresh one for an unmanaged
        artifact). Never raises: tracing must not fail a swap."""
        try:
            from ..obs import trace as _trace
            ctx = (manifest or {}).get("trace") or {}
            tid = ctx.get("trace_id") or _trace.new_trace_id()
            parent = ctx.get("span_id")
            t_poll, t_valid, t_load, t_stage, t_apply = times
            for name, a, b, attrs in (
                    ("swap/validate", t_poll, t_valid, None),
                    ("swap/load", t_valid, t_load, None),
                    ("swap/stage", t_load, t_stage, None),
                    ("swap/apply", t_stage, t_apply,
                     {"model": model_id, "path": path})):
                _trace.record_span(name, a, b, trace_id=tid,
                                   parent_id=parent, attrs=attrs)
        except Exception as e:
            log_warning(f"serve: swap spans not recorded ({e})")


class _StatsLoop:
    """Periodic ``{"event": "serve"}`` emitter."""

    def __init__(self, state: ServeState, interval_s: float):
        self.state = state
        self.interval_s = max(0.1, float(interval_s))
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="lightgbm-tpu-torch-serve-stats")

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        while not self.state.shutdown_event.wait(self.interval_s):
            self.state.emit_serve_event()


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------

_HELP_EPILOG = """\
The model argument is a model text file, a ckpt_*.npz training
snapshot, or a directory (the newest artifact inside is served and the
directory is watched for hot swaps unless --watch-dir overrides it).
The daemon serves on the GPU (--device-type cuda, the default) and
exits when there is none; --device-type cpu serves on the CPU. With
LIGHTGBM_TPU_RANK=r set, it serves on --port + r, exports /metrics on
--metrics-port + r and writes its telemetry to <path>.rank<r>.

exit codes:
  0  clean shutdown (protocol `shutdown` command, SIGTERM or SIGINT)
  1  bad model path / unservable model / no GPU / socket bind failure
  2  bad command line
"""


def build_parser() -> argparse.ArgumentParser:
    # defaults come from the Config dataclass; importing it is
    # torch-free
    from ..config import Config
    p = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch serve",
        description="JSON-lines inference daemon over a compiled "
                    "forest: shape-bucketed batching (no new device "
                    "shapes after warmup), bounded-window "
                    "micro-batching, atomic hot model swap, serve "
                    "telemetry.",
        epilog=_HELP_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model",
                   help="model .txt / ckpt_*.npz snapshot / directory")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--port", type=int, default=8799,
                   help="base port; a replica adds its rank "
                        "(default 8799, 0 = ephemeral)")
    p.add_argument("--device-type", choices=("cuda", "cpu"),
                   default="cuda",
                   help="where the forest is walked (default cuda: the "
                        "GPU, and exit 1 without one)")
    p.add_argument("--watch-dir", default=None,
                   help="directory or mem:// store to poll for newer "
                        "model artifacts (atomic hot swap; default: the "
                        "model directory when MODEL is a directory)")
    p.add_argument("--watch-interval", type=float,
                   default=Config.serve_watch_interval_sec,
                   help="watch-dir poll period in seconds")
    p.add_argument("--telemetry", default=None,
                   help="JSONL path for {\"event\": \"serve\"} lines "
                        "(default: $LIGHTGBM_TPU_TELEMETRY)")
    p.add_argument("--stats-interval", type=float,
                   default=Config.serve_stats_interval_sec,
                   help="seconds between serve telemetry events")
    p.add_argument("--window-ms", type=float,
                   default=Config.serve_batch_window_ms,
                   help="micro-batching window in milliseconds")
    p.add_argument("--max-batch-rows", type=int,
                   default=Config.serve_max_batch_rows,
                   help="largest device batch (power of two)")
    p.add_argument("--min-bucket-rows", type=int,
                   default=Config.serve_min_bucket_rows,
                   help="smallest row bucket (power of two)")
    p.add_argument("--queue-rows", type=int,
                   default=Config.serve_queue_rows,
                   help="pending-row budget before submits are "
                        "rejected (backpressure)")
    p.add_argument("--shed-queue-rows", type=int,
                   default=Config.serve_shed_queue_rows,
                   help="soft backlog threshold: above it the batcher "
                        "sheds its OLDEST queued requests with a typed "
                        "{\"shed\": true} reply (0 = disabled)")
    p.add_argument("--shed-p99-ms", type=float,
                   default=Config.serve_shed_p99_ms,
                   help="per-request latency budget: a request that "
                        "already waited longer is shed at dequeue "
                        "time (0 = disabled)")
    p.add_argument("--grace", type=float,
                   default=Config.serve_shutdown_grace_sec,
                   help="graceful-shutdown deadline in seconds: on "
                        "SIGTERM / the shutdown command the daemon "
                        "drains already-accepted requests for up to "
                        "this long before closing")
    p.add_argument("--metrics-port", type=int,
                   default=Config.metrics_port,
                   help="base port of the OpenMetrics /metrics HTTP "
                        "endpoint (obs/export.py); a replica adds its "
                        "rank. 0 disables (default: "
                        "$LIGHTGBM_TPU_METRICS_PORT or off)")
    p.add_argument("--warmup-rows", type=int, default=None,
                   help="walk every row bucket up to this many rows at "
                        "startup (default: all buckets; 0 disables)")
    p.add_argument("--num-iteration", type=int, default=-1,
                   help="serve only the first N boosting rounds "
                        "(default: all)")
    return p


def _resolve_model(args) -> Tuple[str, Optional[str]]:
    """-> (model path, effective watch dir). Torch-free."""
    model = args.model
    watch_dir = args.watch_dir
    if os.path.isdir(model):
        if watch_dir is None:
            watch_dir = model
        found = _find_model_artifact(model)
        if found is None:
            raise FileNotFoundError(
                f"no model artifact (ckpt_*.npz or *.txt) in "
                f"directory {model!r}")
        model = found[1]
    elif not os.path.exists(model):
        raise FileNotFoundError(f"model file not found: {model!r}")
    if watch_dir is not None \
            and not str(watch_dir).startswith("mem://") \
            and not os.path.isdir(watch_dir):
        raise FileNotFoundError(
            f"--watch-dir is not a directory: {watch_dir!r}")
    return model, watch_dir


def _canary_mismatch(manifest, forest, compile_kwargs) \
        -> Optional[Tuple[float, float, int]]:
    """Score a manifest's canary rows through ``forest``: ``(worst |raw
    - expected|, tol, rows)`` on a mismatch, None on a pass, without a
    canary, or under a ``--num-iteration`` trim (the publisher's scores
    are the full model's)."""
    canary = (manifest or {}).get("canary")
    trim = compile_kwargs.get("num_iteration")
    if not canary or (trim is not None and int(trim) > 0):
        return None
    import numpy as np
    rows = np.asarray(canary.get("rows"), np.float32)
    if rows.ndim == 1:
        rows = rows[None, :]
    want = np.asarray(canary.get("scores"), np.float64).reshape(-1)
    tol = float(canary.get("tol", 1e-3))
    got = np.asarray(forest.predict_raw(rows), np.float64).reshape(-1)
    if got.shape == want.shape \
            and np.allclose(got, want, rtol=0.0, atol=tol):
        return None
    worst = (float(np.max(np.abs(got - want)))
             if got.shape == want.shape else float("inf"))
    return worst, tol, int(rows.shape[0])


def _startup_candidates(args, model_path: str) -> List[str]:
    """The artifacts a daemon may start on, in order: the one
    :func:`_resolve_model` found, then, when MODEL is a directory, its
    older model artifacts, newest first."""
    if not os.path.isdir(args.model):
        return [model_path]
    from ..resilience.store import LocalDirStore
    store = LocalDirStore(args.model)
    found = []
    for name in store.list_names():
        st = store.stat(name) if _is_model_name(name, True) else None
        if st is not None:
            found.append((st[0], name))
    older = [os.path.join(args.model, name)
             for _, name in sorted(found, reverse=True)]
    return [model_path] + [p for p in older if p != model_path]


def _startup_forest(args, model_path: str, compile_kwargs):
    """Load and compile the artifact to serve at startup, held to the
    same gates as a hot swap: a managed artifact must match its manifest
    and pass its canary. A refused one (``canary_refused``; a torn older
    one is skipped) gives way to the next older artifact of MODEL's
    directory, so a replica started after a poisoned publication serves
    the newest good one and its watcher keeps refusing the poisoned
    one. Returns ``(path, watch key, manifest, forest, load end)``."""
    from ..resilience.faults import record_fault_event
    from ..resilience.publisher import validate_artifact
    from .compile import compile_forest
    candidates = _startup_candidates(args, model_path)
    for i, path in enumerate(candidates):
        last = i == len(candidates) - 1
        try:
            # key the watch state to the artifact BEFORE loading it:
            # stat-then-load can at worst re-swap to identical content
            # on the first poll; load-then-stat could suppress a swap
            key = _artifact_key(path)
            manifest = validate_artifact(path)
            booster = _load_booster(path, args.device_type)
        except Exception:
            if i == 0 or last:
                raise
            continue               # an older torn or broken artifact
        t_load = time.perf_counter()
        forest = compile_forest(booster, **compile_kwargs)
        bad = _canary_mismatch(manifest, forest, compile_kwargs)
        if bad is None:
            return path, key, manifest, forest, t_load
        worst, tol, n = bad
        record_fault_event(
            "canary_refused", action="refused_load",
            detail=f"canary mismatch on {path}: worst |raw - expected| "
                   f"{worst:.6g} > tol {tol:g} over {n} rows")
        if last:
            raise ValueError(f"canary validation failed on {path} and no "
                             "older artifact passes")
        log_warning(f"serve: {path} failed its canary at startup; "
                    "trying the next older artifact")
    raise FileNotFoundError(f"no model artifact for {args.model!r}")


def _startup_device(device_type: str) -> None:
    """Create the CUDA context now (timed apart from the model's load),
    or raise when ``device_type`` is ``cuda`` and there is no GPU."""
    import torch
    if device_type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--device-type cuda (the default) but torch.cuda is not "
            "available; pass --device-type cpu to serve on the CPU")
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()


def main(argv: Optional[List[str]] = None) -> int:
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:       # argparse --help (0) / usage error (2)
        return int(e.code or 0)
    try:
        model_path, watch_dir = _resolve_model(args)
    except (FileNotFoundError, OSError) as e:
        print(f"[LightGBM-TPU] [Fatal] {e}", file=sys.stderr)
        return 1
    # ---- everything below may import torch ----
    rank = int(os.environ.get("LIGHTGBM_TPU_RANK") or 0)
    port = args.port + rank if args.port else 0
    telemetry_path = args.telemetry \
        or os.environ.get("LIGHTGBM_TPU_TELEMETRY")
    if telemetry_path and rank:
        telemetry_path = f"{telemetry_path}.rank{rank}"
    startup: Dict[str, float] = {}
    try:
        t0 = time.perf_counter()
        import torch  # noqa: F401  (timed: most of a cold start)
        t1 = time.perf_counter()
        _startup_device(args.device_type)
        t2 = time.perf_counter()
        from .batcher import MicroBatcher
        compile_kwargs = dict(
            num_iteration=args.num_iteration,
            min_bucket=args.min_bucket_rows,
            max_batch_rows=args.max_batch_rows)
        model_path, watch_key, manifest, forest, t3 = _startup_forest(
            args, model_path, compile_kwargs)
        t4 = time.perf_counter()
        if args.warmup_rows != 0:
            forest.warmup(args.warmup_rows)
        t5 = time.perf_counter()
        # inside the try: bad --window-ms/--queue-rows/bucket values
        # exit with the documented [Fatal] line, not a traceback
        batcher = MicroBatcher(forest, batch_window_ms=args.window_ms,
                               max_batch_rows=args.max_batch_rows,
                               queue_max_rows=args.queue_rows,
                               shed_queue_rows=args.shed_queue_rows,
                               shed_p99_ms=args.shed_p99_ms)
        startup = {"import_torch_s": t1 - t0, "device_s": t2 - t1,
                   "load_s": t3 - t2, "compile_s": t4 - t3,
                   "warmup_s": t5 - t4}
    except Exception as e:
        print(f"[LightGBM-TPU] [Fatal] cannot serve {model_path!r}: "
              f"{e}", file=sys.stderr)
        return 1
    state = ServeState(batcher, forest.model_id, model_path,
                       telemetry_path=telemetry_path,
                       manifest=manifest)
    try:
        server = _Server((args.host, port), _Handler)
    except OSError as e:
        print(f"[LightGBM-TPU] [Fatal] cannot bind "
              f"{args.host}:{port}: {e}", file=sys.stderr)
        state.close()
        return 1
    server.state = state                     # type: ignore[attr-defined]
    bound_port = server.server_address[1]
    metrics_port = args.metrics_port
    if not metrics_port:
        try:
            metrics_port = int(os.environ.get(
                "LIGHTGBM_TPU_METRICS_PORT") or 0)
        except ValueError:
            metrics_port = 0
    metrics_server = None
    if metrics_port:
        from ..obs.export import ensure_metrics_server
        metrics_server = ensure_metrics_server(
            metrics_port + rank,
            extra_families=state.metrics_families)
    if watch_dir:
        _Watcher(state, watch_dir, args.watch_interval, compile_kwargs,
                 watch_key, args.warmup_rows).start()
    _StatsLoop(state, args.stats_interval).start()
    ready = {"event": "serve_ready", "host": args.host,
             "port": bound_port, "pid": os.getpid(), "rank": rank,
             "model": forest.model_id, "model_source": model_path,
             "watch_dir": watch_dir,
             "metrics_port": None if metrics_server is None
             else metrics_server.port,
             "buckets": forest.buckets()}
    print(json.dumps(ready), flush=True)
    log_info(f"serve: listening on {args.host}:{bound_port} "
             f"(model {forest.model_id}, {forest.num_trees} trees, "
             f"K={forest.K}, {forest.device}); startup seconds "
             + json.dumps({k: round(v, 4) for k, v in startup.items()}))
    server_thread = threading.Thread(target=server.serve_forever,
                                     kwargs={"poll_interval": 0.2},
                                     daemon=True,
                                     name="lightgbm-tpu-torch-serve-accept")
    server_thread.start()
    # a supervised restart is a SIGTERM: the drain below still runs
    import signal as _signal
    try:
        _signal.signal(_signal.SIGTERM,
                       lambda *_: state.request_shutdown())
    except ValueError:
        pass      # not the main thread (embedded use): skip the hook
    try:
        # a timed wait: the signal flag is processed by the main thread
        # running bytecode, whichever thread the kernel delivered to
        while not state.shutdown_event.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    # ---- graceful drain (bounded by --grace) ----
    # flip predict requests to the typed draining refusal, drain what
    # was accepted, wait for the replies to reach the wire, and only
    # then stop accepting: a connection parked in the accept backlog is
    # answered {"error": "draining"} instead of being reset
    deadline = time.monotonic() + max(0.0, float(args.grace))
    state.begin_drain()
    state.batcher.close(
        timeout=max(0.1, deadline - time.monotonic()))
    while state.active_handlers() > 0 \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    linger = min(0.5, max(0.0, deadline - time.monotonic()))
    if linger > 0:
        time.sleep(linger)                  # sweep the accept backlog
    server.shutdown()                        # no new connections
    while state.active_handlers() > 0 \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    dropped = state.active_handlers()
    if dropped:
        log_warning(f"serve: {dropped} connection handler(s) still "
                    "busy at the shutdown grace deadline")
    state.emit_serve_event()                 # final snapshot
    server.server_close()
    state.close()
    log_info("serve: shut down cleanly")
    return 0
