"""Collective watchdog: a deadline and a heartbeat around every host
collective of a world of ranks.

A copy of ``lightgbm_tpu/resilience/watchdog.py``. One rank dies
(preemption, OOM kill, segfault) or stalls (swap storm, hung I/O) while
the others are already inside, or about to enter, a host collective
(``parallel/hostsync.py``); the survivors would then wait forever. Every
such call runs through :func:`guarded`, which turns an infinite hang and
a transport error into a ``LightGBMError`` naming the collective, the
iteration and the last sync every rank was heard from: the signal a
supervisor (``python -m lightgbm_tpu_torch launch``,
``resilience/elastic.py``) needs to restart the world from the newest
checkpoint.

Deadline resolution (first hit wins):

1. ``LIGHTGBM_TPU_COLLECTIVE_TIMEOUT`` environment variable (seconds;
   ``0`` disables the watchdog),
2. :func:`configure`, called by ``train()`` with
   ``Config.collective_timeout_sec``,
3. the 300 s default.

Mechanics: the collective runs on a fresh *daemon* thread while the
caller waits on an event with a timeout. On expiry the caller raises and
the stuck thread is abandoned: it can never be unblocked anyway, and as
a daemon it cannot keep the aborting process alive. After a timeout the
world must be restarted. The bookkeeping lock below is only ever held
around dict updates, never across a collective.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..log import log_warning

__all__ = ["guarded", "configure", "deadline_seconds", "last_heard",
           "DEFAULT_DEADLINE_SECONDS"]

DEFAULT_DEADLINE_SECONDS = 300.0

_ENV_DEADLINE = "LIGHTGBM_TPU_COLLECTIVE_TIMEOUT"

#: bookkeeping only — guards _last_ok; NEVER held across a collective
_state_lock = threading.Lock()
_configured: Optional[float] = None
_last_ok: Optional[Dict[str, Any]] = None


def configure(deadline: Optional[float]) -> None:
    """Set the process-wide collective deadline (seconds). ``train()``
    calls this with ``Config.collective_timeout_sec``; the environment
    variable still overrides. ``0`` disables, ``None`` resets to the
    default."""
    global _configured
    with _state_lock:
        _configured = None if deadline is None else float(deadline)


def deadline_seconds() -> float:
    """The effective deadline: env var > configure() > default."""
    env = os.environ.get(_ENV_DEADLINE)
    if env:
        try:
            return float(env)
        except ValueError:
            log_warning(f"{_ENV_DEADLINE}={env!r} is not a number; "
                        "using the configured deadline")
    with _state_lock:
        if _configured is not None:
            return _configured
    return DEFAULT_DEADLINE_SECONDS


def last_heard() -> Optional[Dict[str, Any]]:
    """The most recent completed guarded collective:
    ``{"name", "iteration", "time", "world"}`` — the heartbeat the
    timeout error reports. None before the first sync."""
    with _state_lock:
        return None if _last_ok is None else dict(_last_ok)


def _record_ok(name: str, iteration: Optional[int],
               world: Optional[int]) -> None:
    global _last_ok
    with _state_lock:
        _last_ok = {"name": name,
                    "iteration": None if iteration is None
                    else int(iteration),
                    "time": time.monotonic(),
                    "world": None if world is None else int(world)}


def _heartbeat_clause() -> str:
    heard = last_heard()
    if heard is None:
        return ("no collective has completed yet in this process — the "
                "peers may never have come up")
    ago = time.monotonic() - heard["time"]
    ranks = (f"all {heard['world']} ranks were heard from"
             if heard["world"] else "every rank was heard from")
    at_it = ("" if heard["iteration"] is None
             else f" at iteration {heard['iteration']}")
    return (f"last successful sync was '{heard['name']}'{at_it}, "
            f"{ago:.1f}s ago, when {ranks}")


def _fault(kind: str, iteration: Optional[int], detail: str) -> None:
    from .faults import record_fault_event
    record_fault_event(kind, iteration=-1 if iteration is None
                       else int(iteration),
                       action="raise", detail=detail)


def guarded(name: str, fn: Callable, *args,
            iteration: Optional[int] = None,
            world: Optional[int] = None,
            deadline: Optional[float] = None) -> Any:
    """Run one host-level collective ``fn(*args)`` under the watchdog.

    Returns ``fn``'s result. Raises ``LightGBMError`` when the
    collective exceeds the deadline (a peer died or stalled mid-sync)
    or fails with a transport error — in both cases naming ``name``,
    ``iteration`` and the last completed sync. A ``LightGBMError``
    raised by ``fn`` itself (e.g. a divergence check) passes through
    untouched. Callers gate on a world of more than one rank; this
    module itself imports no torch.
    """
    from ..basic import LightGBMError

    limit = deadline_seconds() if deadline is None else float(deadline)
    if limit <= 0:
        out = fn(*args)
        _record_ok(name, iteration, world)
        return out

    box: Dict[str, Any] = {}
    done = threading.Event()

    # box is written only before done.set() and read only after
    # done.wait() returned True, so the Event establishes the
    # happens-before; on a timeout the abandoned worker's late write is
    # never read (box is per-call and unreachable after the raise).
    # tpulint: threadsafe Event handshake (write, set, wait, read)
    def _run() -> None:
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — ferried to caller
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(target=_run, daemon=True,
                              name=f"collective[{name}]")
    worker.start()
    at_it = "" if iteration is None else f" at iteration {iteration}"
    if not done.wait(limit):
        detail = (f"collective '{name}'{at_it} exceeded the "
                  f"{limit:g}s watchdog deadline")
        try:
            from ..obs.registry import registry
            registry.counter("collective_timeouts").inc()
        except Exception:
            pass
        _fault("collective_timeout", iteration, detail)
        raise LightGBMError(
            f"{detail}: a peer process likely died or stalled before "
            f"joining ({_heartbeat_clause()}). The world must be "
            "restarted — `python -m lightgbm_tpu_torch launch` supervises "
            "exactly this, resuming from the newest checkpoint "
            "(docs/RESILIENCE.md). Deadline knob: "
            f"{_ENV_DEADLINE} / collective_timeout_sec.")
    err = box.get("error")
    if err is not None:
        if isinstance(err, LightGBMError):
            raise err
        # the kv transport surfaces a stalled peer as its own timeout
        # (DEADLINE_EXCEEDED / _StalledRank) before the outer deadline,
        # with per-rank attribution; classify it as the same event
        is_timeout = (getattr(err, "is_timeout", False)
                      or "DEADLINE_EXCEEDED" in str(err))
        detail = (f"collective '{name}'{at_it} "
                  + ("timed out" if is_timeout else "failed")
                  + f" ({type(err).__name__}: {err})")
        if is_timeout:
            try:
                from ..obs.registry import registry
                registry.counter("collective_timeouts").inc()
            except Exception:
                pass
        _fault("collective_timeout" if is_timeout else "collective_error",
               iteration, detail)
        raise LightGBMError(
            f"{detail}: a peer process likely died or stalled "
            f"mid-collective ({_heartbeat_clause()}). Restart the "
            "world from the newest checkpoint — `python -m "
            "lightgbm_tpu_torch launch` supervises exactly this "
            "(docs/RESILIENCE.md).") from err
    _record_ok(name, iteration, world)
    return box.get("value")
