"""Phase timing: the counterpart of ``lightgbm_tpu/utils/timer.py``.

- ``Timer`` / ``timed(label)``: host wall-clock seconds per label.
  Enabled with env ``LIGHTGBM_TPU_TIMETAG=1`` or ``Timer.enable()`` (the
  telemetry recorder enables it while attached); ``Timer.log_summary()``
  logs the sorted table and ``Timer.snapshot()`` returns it (the recorder
  diffs consecutive snapshots into per-iteration phase times). The card
  runs asynchronously from Python, so an enabled section ends with
  ``torch.cuda.synchronize()``: its seconds are the device's too. The
  train loop has 4-5 sections an iteration (``boosting/gradients``,
  ``boosting/bagging``, ``tree_learner/grow`` per tree,
  ``boosting/update_score`` per tree, ``engine/eval``), against the
  grower's one read-back a split.
- Every active section also opens a ``torch.profiler.record_function``
  range, so the phases show as named ranges in a ``torch.profiler``
  trace: inside :func:`trace_to` and inside a profile the caller started.

When neither timing nor a profile is active, ``timed`` returns a shared
null context: no clock read, no range, no synchronize and no launch.

``EnvCapture`` reads ``LIGHTGBM_TPU_TRACE_TO=<dir>`` (the whole train
loop under one capture) and ``LIGHTGBM_TPU_XPROF=<dir>:iters=A-B`` (only
iterations A..B), as the JAX package does; the port's capture is
``torch.profiler``, written as a Chrome trace JSON into the directory
where the JAX package writes an xprof dump.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterator

import torch

from ..log import log_info

__all__ = ["Timer", "timed", "trace_to", "EnvCapture",
           "parse_xprof_spec"]

# number of live trace_to() captures; touched under Timer._lock
_tracing = 0


class Timer:
    """Process-global label -> accumulated wall seconds."""

    _acc: Dict[str, float] = defaultdict(float)
    _cnt: Dict[str, int] = defaultdict(int)
    _enabled = os.environ.get("LIGHTGBM_TPU_TIMETAG", "") not in ("", "0")
    # callbacks can fire from user threads and the recorder snapshots
    # concurrently with additions
    _lock = threading.Lock()

    @classmethod
    def enable(cls, on: bool = True) -> None:
        cls._enabled = on

    @classmethod
    def enabled(cls) -> bool:
        return cls._enabled

    @classmethod
    def add(cls, label: str, seconds: float) -> None:
        with cls._lock:
            cls._acc[label] += seconds
            cls._cnt[label] += 1

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._acc.clear()
            cls._cnt.clear()

    @classmethod
    def summary(cls) -> Dict[str, float]:
        with cls._lock:
            return dict(cls._acc)

    @classmethod
    def snapshot(cls) -> Dict[str, Dict[str, float]]:
        """Consistent ``{label: {"total": seconds, "count": n}}`` copy."""
        with cls._lock:
            return {label: {"total": sec, "count": cls._cnt[label]}
                    for label, sec in cls._acc.items()}

    @classmethod
    def log_summary(cls) -> None:
        snap = cls.snapshot()
        if not snap:
            return
        grand = sum(v["total"] for v in snap.values()) or 1.0
        log_info("lightgbm_tpu phase timings (host wall):")
        log_info(f"  {'label':32s} {'total s':>10s} {'count':>8s} "
                 f"{'mean ms':>10s} {'%':>6s}")
        for label, v in sorted(snap.items(), key=lambda kv: -kv[1]["total"]):
            sec, cnt = v["total"], int(v["count"])
            mean_ms = sec / cnt * 1e3 if cnt else 0.0
            log_info(f"  {label:32s} {sec:10.3f} {cnt:8d} "
                     f"{mean_ms:10.3f} {100.0 * sec / grand:6.1f}")


# shared no-op context: the disabled cost of a timed() section is two
# flag checks and returning this singleton
_NULL = nullcontext()


def _synchronize() -> None:
    """Wait for the card, when this process has touched one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def _timed_active(label: str) -> Iterator[None]:
    with torch.profiler.record_function(label):
        if not Timer._enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize()
            Timer.add(label, time.perf_counter() - t0)


def _external_trace_active() -> bool:
    """A ``torch.profiler`` capture is recording in this process."""
    return torch._C._autograd._profiler_enabled()


def timed(label: str):
    """Time a phase and, inside a profile (ours or one the caller
    started), name it. The shared null context when neither timing nor
    a profile is active."""
    if not Timer._enabled and not _tracing \
            and not _external_trace_active():
        return _NULL
    return _timed_active(label)


@contextmanager
def trace_to(log_dir: str) -> Iterator[None]:
    """Capture the enclosed work with ``torch.profiler`` (host ops, and
    the card's kernels and copies when CUDA is available) and write it
    as ``<log_dir>/trace_<pid>_<n>.json``, a Chrome trace (Perfetto,
    chrome://tracing). While a capture is live, ``timed`` sections open
    named ranges even with host timing off."""
    global _tracing
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with Timer._lock:
        _tracing += 1
    try:
        with profile(activities=acts) as prof:
            yield
        n = sum(1 for name in os.listdir(log_dir)
                if name.startswith(f"trace_{os.getpid()}_"))
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
    finally:
        with Timer._lock:
            _tracing -= 1


def parse_xprof_spec(spec: str):
    """Parse ``LIGHTGBM_TPU_XPROF=<dir>:iters=A-B`` (or ``:iters=A``
    for a one-iteration window) into ``(log_dir, first, last)``.
    Raises ValueError on a malformed spec — a silently ignored typo
    would cost a run its capture."""
    if ":iters=" not in spec:
        raise ValueError(
            f"LIGHTGBM_TPU_XPROF expects <dir>:iters=A-B, got "
            f"{spec!r}")
    log_dir, window = spec.rsplit(":iters=", 1)
    lo, _, hi = window.partition("-")
    try:
        first = int(lo)
        last = int(hi) if hi else first
    except ValueError:
        raise ValueError(
            f"LIGHTGBM_TPU_XPROF iteration window {window!r} is not "
            "A-B integers") from None
    if not log_dir or first < 0 or last < first:
        raise ValueError(
            f"LIGHTGBM_TPU_XPROF window {spec!r} needs a directory "
            "and 0 <= A <= B")
    return log_dir, first, last


class EnvCapture:
    """Env-driven captures for the train loop (engine.py):

    - ``LIGHTGBM_TPU_TRACE_TO=<dir>`` wraps the WHOLE iteration loop
      in one :func:`trace_to` capture,
    - ``LIGHTGBM_TPU_XPROF=<dir>:iters=A-B`` captures only iterations
      A..B (engine-absolute).

    The engine calls ``before_iteration(i)`` / ``after_iteration(i)``
    per iteration and ``close()`` in its finally; :meth:`from_env`
    returns None when neither variable is set, so an untraced run never
    takes the per-iteration calls."""

    def __init__(self, trace_dir=None, xprof=None, _tracer=None):
        self._trace_dir = trace_dir
        self._xprof = xprof                     # (dir, first, last)
        self._tracer = _tracer or trace_to
        self._whole = None
        self._window = None

    @classmethod
    def from_env(cls, env=None):
        env = os.environ if env is None else env
        trace_dir = env.get("LIGHTGBM_TPU_TRACE_TO") or None
        spec = env.get("LIGHTGBM_TPU_XPROF") or None
        xprof = parse_xprof_spec(spec) if spec else None
        if trace_dir is None and xprof is None:
            return None
        return cls(trace_dir=trace_dir, xprof=xprof)

    def _enter(self, log_dir):
        cm = self._tracer(log_dir)
        cm.__enter__()
        return cm

    def before_iteration(self, i: int) -> None:
        if self._trace_dir is not None and self._whole is None:
            self._whole = self._enter(self._trace_dir)
        if self._xprof is not None and self._window is None \
                and i == self._xprof[1]:
            self._window = self._enter(self._xprof[0])

    def after_iteration(self, i: int) -> None:
        if self._window is not None and i >= self._xprof[2]:
            cm, self._window = self._window, None
            self._xprof = None     # one window per run, never re-armed
            cm.__exit__(None, None, None)

    def close(self) -> None:
        """Idempotent; runs on the engine's finally so an exception
        mid-window still writes the capture."""
        for attr in ("_window", "_whole"):
            cm = getattr(self, attr)
            if cm is not None:
                setattr(self, attr, None)
                try:
                    cm.__exit__(None, None, None)
                except Exception:
                    pass
