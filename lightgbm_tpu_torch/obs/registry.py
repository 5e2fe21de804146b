"""Label-keyed, thread-safe metric primitives: a copy of
``lightgbm_tpu/obs/registry.py``.

The shape follows the prometheus client-library contract (counter /
gauge / histogram families keyed by a label set) because that is the
vocabulary every downstream consumer of these numbers already speaks,
but storage is plain Python: a metric family is a dict from a sorted
``(key, value)`` label tuple to one instrument object.

Thread safety: callbacks may fire from user threads and the metrics
endpoint scrapes from its own, so every mutation takes the registry's
single RLock. Instruments are tiny (a few
floats); one lock for the whole registry keeps the disabled/idle cost at
zero and the enabled cost far below any phase being measured.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "bump_counter"]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, object]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counter can only increase")
        with self._lock:
            self.value += amount

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-set value (plus the running max, for peak-style gauges)."""

    __slots__ = ("_lock", "value", "max_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value: Optional[float] = None
        self.max_value: Optional[float] = None

    def set(self, value: Optional[float]) -> None:
        with self._lock:
            self.value = value
            if value is not None and (self.max_value is None
                                      or value > self.max_value):
                self.max_value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value = (self.value or 0.0) + amount
            if self.max_value is None or self.value > self.max_value:
                self.max_value = self.value

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {"value": self.value, "max": self.max_value}


class Histogram:
    """Streaming distribution: count / total / min / max / mean.

    Used for both time histograms (seconds observed per phase) and value
    histograms (leaves per tree, gain per split). Full bucketing is more
    than the consumers need — the stats CLI and the JSONL events report
    count/total/mean — so only the moments are kept.
    """

    __slots__ = ("_lock", "count", "total", "min", "max")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value

    def snapshot(self) -> Dict[str, object]:
        return {"count": self.count, "total": self.total,
                "min": self.min, "max": self.max,
                "mean": (self.total / self.count) if self.count else None}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Process-wide metric store: ``kind:name{labels} -> instrument``."""

    def __init__(self):
        self._lock = threading.RLock()
        # name -> (kind, {label_key -> instrument})
        self._families: Dict[str, Tuple[str, Dict[LabelKey, object]]] = {}

    def _get(self, kind: str, name: str,
             labels: Optional[Dict[str, object]]):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}, "
                    f"requested as {kind}")
            inst = fam[1].get(key)
            if inst is None:
                inst = _KINDS[kind](self._lock)
                fam[1][key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-ready ``{name: {kind, series: [{labels, ...stats}]}}``."""
        out: Dict[str, Dict[str, object]] = {}
        with self._lock:
            for name, (kind, series) in self._families.items():
                rows = []
                for key, inst in series.items():
                    snap = inst.snapshot()
                    if not isinstance(snap, dict):
                        snap = {"value": snap}
                    rows.append({"labels": dict(key), **snap})
                out[name] = {"kind": kind, "series": rows}
        return out


#: process-global default registry (the telemetry recorder feeds it)
registry = MetricsRegistry()


def bump_counter(name: str, value: float = 1, **labels) -> None:
    """Best-effort counter bump for supervision/publishing paths that
    must never fail on telemetry (elastic supervisor, model
    publisher): any registry error is swallowed."""
    try:
        registry.counter(name, **labels).inc(value)
    except Exception:
        pass
