"""Deterministic fault injection and device-error classification: the
counterpart of ``lightgbm_tpu/resilience/faults.py``.

``LIGHTGBM_TPU_FAULT_INJECT`` carries a comma-separated list of
``kind@iteration`` tokens, e.g. ``nan_grad@7,oom@3,kill@12``, parsed as
the JAX package parses them. The kinds of one training process:

- ``nan_grad@N`` / ``nan_hess@N`` — poison iteration ``N``'s gradients /
  hessians with NaN before the trees are grown (the non-finite guard,
  ``nonfinite_policy``);
- ``oom@N`` — raise a synthetic ``RESOURCE_EXHAUSTED`` error at
  iteration ``N``'s grow; consumed on firing, so the OOM ladder's retry
  succeeds (repeat the token for back-to-back exhaustion);
- ``kill@N`` — ``SIGKILL`` this process at the start of iteration
  ``N`` (checkpoint and auto-resume);
- ``refit_nan@T`` — poison tree ``T``'s gradients during
  ``Booster.refit``.

The lifecycle kinds of model publication and serving:

- ``publish_torn@G`` — generation ``G``'s publication
  (``resilience/publisher.py``) first leaves a truncated model blob
  behind, then fails the attempt: the publisher's retry loop and the
  daemon's manifest check must both do their jobs;
- ``store_outage@G`` — the store is down for one publication attempt;
- ``publish_poison@G`` — the publication is byte-valid but its canary
  expectations are garbage; only the daemon's canary gate refuses it;
- ``serve_kill@N`` — ``SIGKILL`` the serving daemon at its ``N``-th
  accepted predict request, before the request enters the batcher,
  when ``LIGHTGBM_TPU_RANK`` is in ``LIGHTGBM_TPU_FAULT_RANK`` (default
  ``0``).

The distributed kinds (a world of ranks, ``parallel/``), gated on
``LIGHTGBM_TPU_FAULT_RANK`` (a comma list of ranks, default ``0``)
against the rank of the world this process joined (0 outside one):

- ``rank_kill@N`` — ``SIGKILL`` the training process at the start of
  iteration ``N`` (``-1``: in streaming ingest, before the mappers are
  found); the supervised restart (``resilience/elastic.py``) strips it
  from the relaunch's environment;
- ``stall_rank@N`` — the selected rank records a fault event and sleeps
  forever at the start of iteration ``N``: alive, so no transport error
  surfaces, and only the peers' collective watchdog
  (``resilience/watchdog.py``) catches it;
- ``init_refuse@K`` — ``init_distributed`` raises a synthetic
  connection-refused error on its first ``K`` attempts (a coordinator
  not up yet), on every rank.

The fault-event log (:data:`FAULT_EVENTS` and each engine's
``fault_log``) keeps the JAX package's event schema, its cap of 512 and
one lock for every append and drain. A missing or empty variable parses
to an inert plan: every query is a dict lookup.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Tuple

from ..obs.schemas import injectable_fault_kinds

__all__ = ["FaultPlan", "InjectedResourceExhausted", "InjectedInitRefused",
           "is_resource_exhausted", "append_fault_event",
           "record_fault_event", "drain_events", "FAULT_EVENTS",
           "NF_CLAMP", "nf_clamp"]

_KNOWN_KINDS = injectable_fault_kinds()

#: the finite ceiling of ``nonfinite_policy=clamp`` (the JAX package's
#: ``_NF_CLAMP``)
NF_CLAMP = 1e30


def nf_clamp(a: torch.Tensor, lo: float = -NF_CLAMP,
             hi: float = NF_CLAMP) -> torch.Tensor:
    """NaN -> 0 and +-Inf -> ``lo``/``hi``, then clipped to them: the
    rule of ``nonfinite_policy=clamp`` for gradients, hessians and leaf
    values."""
    import torch
    return torch.clamp(torch.nan_to_num(a, nan=0.0, posinf=hi, neginf=lo),
                       lo, hi)


#: process-level fault event log for faults that have no engine to hang
#: off; the telemetry recorder drains it with the engines' logs. Capped
#: like them.
FAULT_EVENTS: List[dict] = []

#: one lock for every fault-event log (the global one and the
#: engines'): appends and the recorder's snapshot-and-clear may come
#: from different threads
_EVENTS_LOCK = threading.Lock()


def append_fault_event(log: List[dict], kind: str, iteration: int,
                       action: str, detail: str) -> None:
    """Append one ``{"event": "fault"}`` event to ``log`` (capped at
    512), count it in the ``fault_events{kind}`` registry counter, and
    warn."""
    with _EVENTS_LOCK:
        if len(log) >= 512:
            del log[0]
        log.append({
            "event": "fault", "kind": kind, "iteration": int(iteration),
            "action": action, "detail": detail, "time": time.time()})
    from ..obs.registry import registry
    registry.counter("fault_events", kind=kind).inc()
    from ..log import log_warning
    log_warning(f"fault[{kind}] at iteration {iteration}: {detail}"
                + (f" -> {action}" if action else ""))


def record_fault_event(kind: str, iteration: int = -1, action: str = "",
                       detail: str = "") -> None:
    """Process-level fault event (no engine in scope): goes to
    :data:`FAULT_EVENTS`."""
    append_fault_event(FAULT_EVENTS, kind, iteration, action, detail)


def drain_events(log: List[dict]) -> List[dict]:
    """Atomically snapshot-and-clear a fault-event log, under the lock
    :func:`append_fault_event` takes: an event appended concurrently
    lands either in this drain or in the next."""
    with _EVENTS_LOCK:
        events, log[:] = list(log), []
    return events


class InjectedResourceExhausted(RuntimeError):
    """Synthetic stand-in for a device OOM: carries the
    ``RESOURCE_EXHAUSTED`` marker the classifier keys on."""


class InjectedInitRefused(RuntimeError):
    """Synthetic coordinator-not-up failure: carries the ``connection
    refused`` marker ``init_distributed``'s retry classifier keys on."""


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for the caching allocator's ``torch.OutOfMemoryError``, for
    device allocation failures by message (``RESOURCE_EXHAUSTED``, "out
    of memory"), and for the injected stand-in."""
    import torch
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = str(exc)
    return ("RESOURCE_EXHAUSTED" in msg
            or "Out of memory" in msg
            or "out of memory" in msg)


class FaultPlan:
    """Parsed ``kind@iteration`` schedule with consume-on-fire
    semantics for ``oom`` (so a retry after degradation succeeds)."""

    def __init__(self, spec: str = ""):
        self._events: Dict[str, List[int]] = {}
        for token in (spec or "").split(","):
            token = token.strip()
            if not token:
                continue
            if "@" not in token:
                raise ValueError(
                    f"bad fault-injection token {token!r} "
                    "(expected kind@iteration)")
            kind, it = token.split("@", 1)
            kind = kind.strip()
            if kind not in _KNOWN_KINDS:
                raise ValueError(
                    f"unknown fault-injection kind {kind!r} "
                    f"(known: {', '.join(_KNOWN_KINDS)})")
            self._events.setdefault(kind, []).append(int(it))
        for lst in self._events.values():
            lst.sort()
        # init_refuse@K: refuse the first K connection attempts
        self._init_refusals_left = sum(self._events.get("init_refuse", ()))

    @classmethod
    def from_env(cls) -> "FaultPlan":
        return cls(os.environ.get("LIGHTGBM_TPU_FAULT_INJECT", ""))

    @property
    def active(self) -> bool:
        return bool(self._events)

    def iters(self, kind: str) -> Tuple[int, ...]:
        """All scheduled iterations for ``kind`` (non-consuming)."""
        return tuple(self._events.get(kind, ()))

    def fires(self, kind: str, iteration: int) -> bool:
        """Non-consuming membership test (nan_grad / nan_hess)."""
        return iteration in self._events.get(kind, ())

    def take(self, kind: str, iteration: int) -> bool:
        """Consuming test: True once per scheduled token."""
        lst = self._events.get(kind)
        if lst and iteration in lst:
            lst.remove(iteration)
            return True
        return False

    def maybe_oom(self, iteration: int) -> None:
        """Raise one synthetic RESOURCE_EXHAUSTED if armed for this
        iteration (consumed, so the caller's retry proceeds)."""
        if self.take("oom", iteration):
            raise InjectedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected device OOM at iteration "
                f"{iteration} (LIGHTGBM_TPU_FAULT_INJECT)")

    def maybe_kill(self, iteration: int) -> None:
        """SIGKILL this process if armed for this iteration — no
        cleanup, no atexit: the hard crash the checkpoints must
        survive."""
        if self.take("kill", iteration):
            os.kill(os.getpid(), signal.SIGKILL)

    @staticmethod
    def _rank_selected() -> bool:
        """Is this process one of the fault-target ranks
        (``LIGHTGBM_TPU_FAULT_RANK``, comma list, default ``0``)? Its
        rank is the one of the world it joined (``parallel/``), 0
        outside a world; only queried when a distributed kind is
        armed."""
        targets = {int(r) for r in
                   os.environ.get("LIGHTGBM_TPU_FAULT_RANK",
                                  "0").split(",") if r.strip()}
        from ..parallel.mesh import world_rank
        return world_rank() in targets

    def maybe_distributed_fault(self, iteration: int) -> None:
        """Fire ``rank_kill`` / ``stall_rank`` if armed for this
        iteration and this process is a selected rank. ``rank_kill``
        SIGKILLs (like ``kill``); ``stall_rank`` records a fault event
        and then sleeps forever — the straggler the peers' collective
        watchdog must catch, because no transport error will."""
        if self.fires("rank_kill", iteration) and self._rank_selected():
            self.take("rank_kill", iteration)
            os.kill(os.getpid(), signal.SIGKILL)
        if self.fires("stall_rank", iteration) and self._rank_selected():
            self.take("stall_rank", iteration)
            record_fault_event(
                "stall_rank", iteration=iteration, action="stall",
                detail="injected infinite stall "
                       "(LIGHTGBM_TPU_FAULT_INJECT)")
            while True:
                time.sleep(3600.0)

    def maybe_refuse_init(self) -> None:
        """Raise one synthetic connection-refused error per remaining
        ``init_refuse`` budget — the coordinator-not-up failure
        ``init_distributed``'s retry loop must absorb."""
        if self._init_refusals_left > 0:
            self._init_refusals_left -= 1
            record_fault_event(
                "init_refuse", action="retry",
                detail="injected coordinator connection refusal "
                       "(LIGHTGBM_TPU_FAULT_INJECT)")
            raise InjectedInitRefused(
                "connection refused: injected coordinator-not-up "
                "failure (LIGHTGBM_TPU_FAULT_INJECT)")

    @staticmethod
    def _replica_selected() -> bool:
        """Is this serving replica a fault target? Replicas are told
        apart by ``LIGHTGBM_TPU_RANK`` alone, which the gate compares
        with ``LIGHTGBM_TPU_FAULT_RANK`` (default ``0``)."""
        targets = {int(r) for r in
                   os.environ.get("LIGHTGBM_TPU_FAULT_RANK",
                                  "0").split(",") if r.strip()}
        me = int(os.environ.get("LIGHTGBM_TPU_RANK") or 0)
        return me in targets

    def maybe_serve_kill(self, request_count: int) -> None:
        """SIGKILL the serving daemon when armed for this accepted
        request ordinal and this replica is a target. Fired before the
        request enters the batcher, so no accepted request is silently
        dropped: the dying connection is the client's signal to
        retry."""
        if self.fires("serve_kill", request_count) \
                and self._replica_selected():
            self.take("serve_kill", request_count)
            os.kill(os.getpid(), signal.SIGKILL)
