"""Fleet scaling and rollback policy: decisions from the scrape
signal. A copy of ``lightgbm_tpu/resilience/autoscale.py``.

The fleet supervisor (``resilience/elastic.py`` ``supervise_fleet``)
runs two threads: a scrape thread that polls every replica's
``{"cmd": "metrics"}`` verb into ``{"event": "fleet"}`` records, and
the supervision loop that launches, retires and relaunches replicas.
The scrape thread feeds observations in (:meth:`AutoscalePolicy.observe`,
:meth:`RollbackGuard.observe`), the loop takes decisions out
(:meth:`~AutoscalePolicy.decide`, :meth:`~RollbackGuard.decide`), and
the shared state of each policy sits under its own lock.

**Autoscaling**: scale up when the fleet's total QPS exceeds ``n x
up_qps`` for the current replica count ``n``, when the worst replica
p99 exceeds ``up_p99_ms``, or when a replica shed load since the last
scrape; scale down only when the total QPS would still stay under
``down_qps`` per replica with one replica fewer and nothing else is
degraded. Hysteresis: ``down_qps`` strictly below ``up_qps`` (checked
by ``Config``), a cooldown per direction after any scaling action, and
each decision consumes at most one scrape.

**Rollback**: the guard drives the store's newest publication through
``watching -> adopted | rolled back``. It is adopted as last-known-good
once some replica has served its sha for ``adopt_sec`` without a
health eviction; it is rolled back when no replica serves it after
``refuse_sec`` while the fleet's swap failures grew since it appeared
(every canary gate refused it: ``publish_poison``), or when a replica
that swapped onto it was evicted by the health checks. Rolled-back
shas are remembered, so a rollback cannot loop.

Imports no torch: it runs inside the supervisor process.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["AutoscalePolicy", "RollbackGuard"]


def _alive_rows(rows: List[dict]) -> List[dict]:
    return [r for r in rows if r.get("alive")]


class AutoscalePolicy:
    """Hysteresis scaling decisions from ``{"event": "fleet"}`` rows.

    ``observe`` runs on the supervisor's scrape thread, ``decide`` and
    ``metrics_families`` on other threads — all state is guarded by
    ``self._lock``."""

    def __init__(self, min_replicas: int, max_replicas: int, *,
                 up_qps: float = 0.0, down_qps: float = 0.0,
                 up_p99_ms: float = 0.0,
                 up_cooldown_sec: float = 5.0,
                 down_cooldown_sec: float = 15.0,
                 _now=time.monotonic):
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.up_qps = float(up_qps)
        self.down_qps = float(down_qps)
        self.up_p99_ms = float(up_p99_ms)
        self.up_cooldown_sec = float(up_cooldown_sec)
        self.down_cooldown_sec = float(down_cooldown_sec)
        self._now = _now
        self._lock = threading.Lock()
        # ---- guarded by self._lock ----
        self._seq = 0            # observations ingested (scrape thread)
        self._decided_seq = 0    # observations consumed by decide()
        self._qps = 0.0
        self._p99 = 0.0
        self._shed_delta = 0.0
        self._shed_totals: Dict[Any, float] = {}
        self._last_scale_t: Optional[float] = None
        self.scale_ups = 0
        self.scale_downs = 0

    # -- scrape thread -------------------------------------------------
    def observe(self, rows: List[dict]) -> None:
        """Ingest one fleet scrape (the ``replicas`` rows of a
        ``{"event": "fleet"}`` record)."""
        alive = _alive_rows(rows)
        qps = sum(float(r.get("qps") or 0.0) for r in alive)
        p99 = max((float(r.get("p99_ms") or 0.0) for r in alive),
                  default=0.0)
        with self._lock:
            shed_delta = 0.0
            for r in rows:
                rank, tot = r.get("rank"), r.get("shed_total")
                if rank is None or tot is None:
                    continue
                prev = self._shed_totals.get(rank)
                # a restarted replica resets its counter — only count
                # forward motion
                if prev is not None and tot > prev:
                    shed_delta += tot - prev
                self._shed_totals[rank] = tot
            self._qps, self._p99 = qps, p99
            self._shed_delta = shed_delta
            self._seq += 1

    # -- supervision loop ----------------------------------------------
    def decide(self, n_active: int) -> Optional[Tuple[str, str]]:
        """One scaling decision — ``("up"|"down", reason)`` or None.

        Consumes at most one observation per call: with no scrape
        since the last decision there is nothing new to act on, so a
        tight supervision loop cannot re-fire on stale numbers."""
        now = self._now()
        with self._lock:
            if self._seq == self._decided_seq:
                return None
            self._decided_seq = self._seq
            qps, p99 = self._qps, self._p99
            shed = self._shed_delta
            since = (None if self._last_scale_t is None
                     else now - self._last_scale_t)
            if n_active < self.max_replicas:
                reasons = []
                if self.up_qps > 0 and qps > n_active * self.up_qps:
                    reasons.append(
                        f"qps {qps:.1f} > {n_active}x{self.up_qps:g}")
                if self.up_p99_ms > 0 and p99 > self.up_p99_ms:
                    reasons.append(
                        f"p99 {p99:.1f}ms > {self.up_p99_ms:g}ms")
                if shed > 0:
                    reasons.append(f"shed +{shed:g}")
                if reasons and (since is None
                                or since >= self.up_cooldown_sec):
                    self._last_scale_t = now
                    self.scale_ups += 1
                    return ("up", "; ".join(reasons))
            if n_active > self.min_replicas and self.down_qps > 0:
                calm = (shed == 0
                        and (self.up_p99_ms <= 0
                             or p99 <= self.up_p99_ms)
                        and qps < (n_active - 1) * self.down_qps)
                if calm and (since is None
                             or since >= self.down_cooldown_sec):
                    self._last_scale_t = now
                    self.scale_downs += 1
                    return ("down",
                            f"qps {qps:.1f} < "
                            f"{n_active - 1}x{self.down_qps:g}")
            return None

    def metrics_families(self) -> Dict[str, dict]:
        """Live policy state for the supervisor's /metrics endpoint
        (read from the HTTP handler thread)."""
        from ..obs.export import counter_family, gauge_family
        with self._lock:
            return {
                "fleet_autoscale_up": counter_family(self.scale_ups),
                "fleet_autoscale_down": counter_family(self.scale_downs),
                "fleet_autoscale_qps": gauge_family(self._qps),
                "fleet_autoscale_p99_ms": gauge_family(self._p99),
            }


class RollbackGuard:
    """Last-known-good tracking + rollback decisions for the newest
    publication (state machine above).

    ``observe``/``note_eviction`` run on supervisor threads other than
    the one calling ``note_publication``/``decide`` — all state is
    guarded by ``self._lock``."""

    def __init__(self, *, refuse_sec: float = 5.0,
                 adopt_sec: float = 2.0, _now=time.monotonic):
        self.refuse_sec = float(refuse_sec)
        self.adopt_sec = float(adopt_sec)
        self._now = _now
        self._lock = threading.Lock()
        # ---- guarded by self._lock ----
        self._served: Dict[Any, str] = {}       # rank -> serving sha
        self._fail_totals: Dict[Any, float] = {}
        self._fail_cum = 0.0
        self._watched: Optional[Dict[str, Any]] = None
        self._good: Optional[Tuple[str, str]] = None  # (name, sha)
        self._good_shas: set = set()
        self._bad_shas: set = set()
        self.rollbacks = 0

    # -- scrape thread -------------------------------------------------
    def observe(self, rows: List[dict]) -> None:
        """Ingest per-replica serving shas + swap-failure counters
        from one fleet scrape."""
        with self._lock:
            for r in rows:
                rank = r.get("rank")
                if rank is None:
                    continue
                sha = r.get("sha256")
                if sha:
                    self._served[rank] = sha
                tot = r.get("swap_failures_total")
                if tot is not None:
                    prev = self._fail_totals.get(rank)
                    if prev is not None and tot > prev:
                        self._fail_cum += tot - prev
                    elif prev is None and tot > 0:
                        self._fail_cum += tot
                    self._fail_totals[rank] = tot

    # -- supervision loop ----------------------------------------------
    def note_publication(self, name: str, sha: str) -> bool:
        """Start watching a newly observed publication; True when the
        watch actually changed (known-good / known-bad / already
        watched shas are ignored)."""
        if not sha:
            return False
        with self._lock:
            if sha in self._good_shas or sha in self._bad_shas:
                return False
            if self._watched is not None \
                    and self._watched["sha"] == sha:
                return False
            self._watched = {"name": name, "sha": sha,
                             "t": self._now(),
                             "first_served_t": None,
                             "fail_base": self._fail_cum,
                             "evicted": False}
            return True

    def note_eviction(self, rank) -> None:
        """A replica failed post-swap health checks and is being
        evicted; if it was serving the watched publication, that
        publication is condemned."""
        with self._lock:
            w = self._watched
            if w is not None \
                    and self._served.get(rank) == w["sha"]:
                w["evicted"] = True

    def decide(self) -> Optional[Dict[str, Any]]:
        """Advance the watched publication through the state machine;
        a rollback order ``{"bad_name", "bad_sha", "good_name",
        "good_sha"}`` when it is condemned, else None."""
        now = self._now()
        with self._lock:
            w = self._watched
            if w is None:
                return None
            sha = w["sha"]
            serving = any(s == sha for s in self._served.values())
            if w["evicted"]:
                return self._condemn(w)
            if serving:
                if w["first_served_t"] is None:
                    w["first_served_t"] = now
                elif now - w["first_served_t"] >= self.adopt_sec:
                    # adopted: the fleet runs it — last-known-good
                    self._good = (w["name"], sha)
                    self._good_shas.add(sha)
                    self._watched = None
                return None
            if now - w["t"] >= self.refuse_sec \
                    and self._fail_cum > w["fail_base"]:
                # nobody swapped onto it and swap failures mounted:
                # the fleet's canary gates refused it
                return self._condemn(w)
            return None

    def _condemn(self, w: Dict[str, Any]) -> Dict[str, Any]:
        # caller holds self._lock
        self._bad_shas.add(w["sha"])
        self._watched = None
        self.rollbacks += 1
        good_name, good_sha = self._good or (None, None)
        return {"bad_name": w["name"], "bad_sha": w["sha"],
                "good_name": good_name, "good_sha": good_sha}

    @property
    def last_known_good(self) -> Optional[Tuple[str, str]]:
        with self._lock:
            return self._good
