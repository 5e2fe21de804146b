"""Shape-bucketed micro-batcher: request queue -> device batches.

Counterpart of ``lightgbm_tpu/serve/batcher.py``. One worker thread owns
the device: requests (arbitrary row counts) are queued by caller
threads, coalesced inside a bounded batching window
(``batch_window_ms``, capped at ``max_batch_rows``), run through the
compiled forest's bucketed walk, and the per-request slices resolve
each caller's Future. Backpressure is a hard row budget
(``queue_max_rows``): a submit that would exceed it fails fast with
:class:`QueueFullError` instead of growing an unbounded queue.

Load shedding sits between healthy operation and that hard wall: when
``shed_queue_rows`` > 0 and the pending backlog exceeds it, the worker
sheds the OLDEST queued requests, resolving their futures with a typed
:class:`SheddingError`, until the backlog is back under the threshold.
``shed_p99_ms`` > 0 also sheds any request that has already waited past
that latency budget at dequeue time. Both default to 0 (disabled).

Threading contract: every mutable field shared between the worker and
callers is touched only under ``self._lock``, the request handoff
rides a ``queue.Queue``, and the device call (``forest.predict_raw``)
always runs OUTSIDE the lock, so a device stall never blocks ``submit``
or ``stats``. The worker selects the forest's CUDA device before it
predicts (a new thread's current device is device 0, whatever the
caller's).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

__all__ = ["MicroBatcher", "QueueFullError", "SheddingError"]

#: latency samples kept for the p50/p99 window (newest-wins ring)
_LATENCY_WINDOW = 4096

_STOP = object()


class QueueFullError(RuntimeError):
    """Backpressure: the batcher's pending-row budget is exhausted."""


class SheddingError(RuntimeError):
    """Load shedding: the request was accepted but dropped by the
    overload policy (queue depth or per-request latency budget breach)
    before reaching the device — the typed signal for "retry later /
    against another replica", distinct from the hard
    :class:`QueueFullError` admission rejection."""


class _Request:
    __slots__ = ("rows", "future", "t_submit", "trace", "t_dequeue")

    def __init__(self, rows: np.ndarray, future: Future,
                 t_submit: float, trace=None):
        self.rows = rows
        self.future = future
        self.t_submit = t_submit
        # optional trace context ({"trace_id", "span_id"}) from the
        # protocol line; when set, the worker stamps dequeue and
        # dispatch times so the daemon can emit queue-wait /
        # batch-window / dispatch spans for exactly the sampled requests
        self.trace = trace
        self.t_dequeue = None


class _SwapCmd:
    """A model swap riding the request queue: applied by the worker in
    FIFO order, i.e. at a point where no batch is in flight — the only
    moment the old forest's device tensors may be written with the new
    model's fields."""

    __slots__ = ("build", "future")

    def __init__(self, build):
        self.build = build          # build(old_forest) -> new forest
        self.future = Future()


class MicroBatcher:
    """Coalesce concurrent predict requests into device batches.

    ``forest`` is anything with ``predict_raw(X) -> [n, K]`` and an
    ``n_features`` attribute — in production a
    :class:`~lightgbm_tpu_torch.serve.compile.CompiledForest`. ``swap()``
    replaces it atomically: requests already dequeued finish on the
    model they started with, everything after answers from the new one,
    and nothing is ever dropped.
    """

    def __init__(self, forest, batch_window_ms: float = 2.0,
                 max_batch_rows: int = 16384,
                 queue_max_rows: int = 131072,
                 shed_queue_rows: int = 0,
                 shed_p99_ms: float = 0.0):
        if batch_window_ms < 0:
            raise ValueError("batch_window_ms must be >= 0")
        if max_batch_rows < 1 or queue_max_rows < 1:
            raise ValueError("max_batch_rows and queue_max_rows must "
                             "be >= 1")
        if shed_queue_rows < 0 or shed_p99_ms < 0:
            raise ValueError("shed_queue_rows and shed_p99_ms must be "
                             ">= 0 (0 disables shedding)")
        if shed_queue_rows and shed_queue_rows >= queue_max_rows:
            # the same invariant Config enforces — re-checked here so
            # the serve CLI's flags (which never build a Config) cannot
            # silently configure shedding that can never fire
            raise ValueError(
                "shed_queue_rows (soft shed threshold) must stay below "
                f"queue_max_rows (hard admission wall) to ever fire "
                f"({shed_queue_rows} >= {queue_max_rows})")
        self._forest = forest
        self._window_s = float(batch_window_ms) / 1e3
        self._max_batch_rows = int(max_batch_rows)
        self._queue_max_rows = int(queue_max_rows)
        self._shed_queue_rows = int(shed_queue_rows)
        self._shed_p99_ms = float(shed_p99_ms)
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        # ---- all fields below are guarded by self._lock ----
        self._pending_rows = 0
        self._requests_total = 0
        self._rows_total = 0
        self._batches_total = 0
        self._swaps_total = 0
        self._rejected_total = 0
        self._shed_total = 0
        self._shed_rows = 0
        self._latencies = deque(maxlen=_LATENCY_WINDOW)
        self._closed = False
        self._worker = threading.Thread(
            target=self._worker_loop, daemon=True,
            name="lightgbm-tpu-torch-serve-batcher")
        self._worker.start()

    # -- caller side ---------------------------------------------------
    def submit(self, rows, trace=None) -> Future:
        """Enqueue ``rows`` ([n, F] or [F]); the Future resolves to the
        raw-score matrix ``[n, K]`` and carries ``serving_forest``, the
        forest that produced it. Raises :class:`QueueFullError` when the
        pending-row budget would be exceeded. ``trace`` is an optional
        span context dict from the protocol: the resolved Future then
        also carries ``trace`` and ``trace_times`` (submit, dequeue,
        dispatch and done ``perf_counter`` stamps) for the daemon's
        per-request spans."""
        rows = np.ascontiguousarray(np.asarray(rows, np.float32))
        if rows.ndim == 1:
            rows = rows[None, :]
        nf = getattr(self._current_forest(), "n_features", None)
        if nf is not None and rows.shape[1] != nf:
            raise ValueError(
                f"request has {rows.shape[1]} features, the served "
                f"model expects {nf}")
        n = rows.shape[0]
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._pending_rows + n > self._queue_max_rows:
                self._rejected_total += 1
                depth = self._pending_rows
                raise QueueFullError(
                    f"serve queue full: {depth} rows pending, request "
                    f"of {n} exceeds the {self._queue_max_rows}-row "
                    "budget")
            self._pending_rows += n
            # enqueue UNDER the lock (put never blocks): a close()
            # racing between the flag check and an unlocked put could
            # drain, join and leave this future unresolved forever
            self._queue.put(_Request(rows, fut, time.perf_counter(),
                                     trace))
        return fut

    def swap(self, forest) -> object:
        """Install ``forest`` as the serving model; returns the old
        one. In-flight batches keep the model they dequeued with (the
        old forest must therefore stay alive — see
        :meth:`swap_deferred` for the in-place variant)."""
        with self._lock:
            old = self._forest
            self._forest = forest
            self._swaps_total += 1
        return old

    def swap_deferred(self, build) -> Future:
        """Enqueue ``build(old_forest) -> new_forest`` to run on the
        worker thread between batches, where the old forest is
        guaranteed idle — pass a staged ``CompiledForest.attach`` here
        so the upload writes the new model into the old model's device
        tensors field by field (never a second resident forest). The
        returned Future resolves to the new forest (or the build
        error; a failed build keeps the old model serving)."""
        cmd = _SwapCmd(build)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put(cmd)    # under the lock, like submit()
        return cmd.future

    def _apply_swap(self, cmd: _SwapCmd) -> None:
        if not cmd.future.set_running_or_notify_cancel():
            return    # requester cancelled (e.g. gave up waiting): a
            #           swap that never reported must never apply late
        old = self._current_forest()
        try:
            new = cmd.build(old)
        except BaseException as e:
            cmd.future.set_exception(e)    # old keeps serving
            return
        with self._lock:
            self._forest = new
            self._swaps_total += 1
        cmd.future.set_result(new)

    def _current_forest(self):
        with self._lock:
            return self._forest

    def stats(self) -> dict:
        """Queue/latency snapshot for telemetry and the ``stats``
        protocol command."""
        with self._lock:
            lat = list(self._latencies)
            out = {
                "queue_depth_rows": self._pending_rows,
                "requests_total": self._requests_total,
                "rows_total": self._rows_total,
                "batches_total": self._batches_total,
                "swaps_total": self._swaps_total,
                "rejected_total": self._rejected_total,
                "shed_total": self._shed_total,
                "shed_rows": self._shed_rows,
            }
        if lat:
            q = np.percentile(np.asarray(lat, np.float64), [50.0, 99.0])
            out["p50_ms"] = round(float(q[0]) * 1e3, 3)
            out["p99_ms"] = round(float(q[1]) * 1e3, 3)
        else:
            out["p50_ms"] = None
            out["p99_ms"] = None
        return out

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, drain everything already queued
        (FIFO: the stop marker sits behind them), and join the
        worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(_STOP)
        self._worker.join(timeout=timeout)
        # a submit that raced the close flag can land behind the stop
        # marker; its future must fail, never hang a caller forever
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not _STOP:     # late _Request or _SwapCmd alike
                req.future.set_exception(
                    RuntimeError("batcher closed before the request "
                                 "was served"))

    # -- worker side ---------------------------------------------------
    def _maybe_shed(self, req: _Request) -> bool:
        """Overload policy at dequeue time: shed ``req`` (resolve its
        future with :class:`SheddingError`, True) when the pending
        backlog exceeds ``shed_queue_rows`` or the request has already
        waited past ``shed_p99_ms``. Runs on the worker thread only;
        the bookkeeping writes share the caller-side lock."""
        reason = None
        age_ms = (time.perf_counter() - req.t_submit) * 1e3
        n = req.rows.shape[0]
        with self._lock:
            # the backlog BEHIND this request decides the queue-depth
            # shed: counting the request's own rows would deterministically
            # shed any single request larger than the threshold even on
            # an idle server
            backlog = self._pending_rows - n
            if 0 < self._shed_queue_rows < backlog:
                reason = (f"{backlog} rows queued behind this request, "
                          f"over the {self._shed_queue_rows}-row shed "
                          "threshold; oldest requests are dropped so "
                          "fresh ones keep bounded latency")
            elif 0 < self._shed_p99_ms < age_ms:
                reason = (f"request waited {age_ms:.1f} ms, past the "
                          f"{self._shed_p99_ms:g} ms latency budget")
            if reason is None:
                return False
            self._pending_rows -= n
            self._shed_total += 1
            self._shed_rows += n
        req.future.set_exception(SheddingError(
            f"request shed under load: {reason} (retry later or "
            "against another replica)"))
        return True

    def _worker_loop(self) -> None:
        while True:
            req = self._queue.get()
            if req is _STOP:
                return
            if isinstance(req, _SwapCmd):
                self._apply_swap(req)
                continue
            if self._maybe_shed(req):
                continue
            if req.trace is not None:
                req.t_dequeue = time.perf_counter()
            batch: List[_Request] = [req]
            n = req.rows.shape[0]
            deadline = time.perf_counter() + self._window_s
            stop_after = False
            pending_swap: Optional[_SwapCmd] = None
            while n < self._max_batch_rows:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                if isinstance(nxt, _SwapCmd):
                    pending_swap = nxt   # close the batch, swap after
                    break
                if self._maybe_shed(nxt):
                    continue
                if nxt.trace is not None:
                    nxt.t_dequeue = time.perf_counter()
                batch.append(nxt)
                n += nxt.rows.shape[0]
            self._run_batch(batch)
            if pending_swap is not None:
                self._apply_swap(pending_swap)
            if stop_after:
                return

    def _run_batch(self, batch: List[_Request]) -> None:
        forest = self._current_forest()
        dev = getattr(forest, "device", None)
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch
            torch.cuda.set_device(dev)
        X = batch[0].rows if len(batch) == 1 else \
            np.concatenate([r.rows for r in batch])
        err: Optional[BaseException] = None
        t_dispatch = time.perf_counter()
        try:
            # device dispatch OUTSIDE the lock: a slow batch must not
            # block submit()/stats() on other threads
            out = forest.predict_raw(X)
        except BaseException as e:
            err = e
            out = None
        done = time.perf_counter()
        with self._lock:
            self._pending_rows -= X.shape[0]
            self._requests_total += len(batch)
            self._rows_total += X.shape[0]
            self._batches_total += 1
            if err is None:
                for r in batch:
                    self._latencies.append(done - r.t_submit)
        off = 0
        for r in batch:
            k = r.rows.shape[0]
            if err is not None:
                r.future.set_exception(err)
            else:
                # stamp which forest produced the scores before
                # resolving (the future's condition orders this write
                # before result() returns): a caller that finalizes
                # raw scores across a hot swap must use the producing
                # model's transform, not the current one
                r.future.serving_forest = forest
                if r.trace is not None:
                    # queue wait = dequeue - submit, batch window =
                    # dispatch - dequeue, device = done - dispatch
                    r.future.trace = r.trace
                    r.future.trace_times = (
                        r.t_submit, r.t_dequeue or t_dispatch,
                        t_dispatch, done)
                r.future.set_result(out[off:off + k])
            off += k
