"""Recompile tracking: the port's counterpart of
``lightgbm_tpu/obs/jit_tracker.py``.

The JAX package counts the XLA compiles of every jitted entry point (a
jit cache miss is a compile). The port has no jit cache; two things take
its place, and this module counts both per process under the JAX
names:

- **kernel builds**: each ``nvcc`` build of a ``csrc/<name>.cu``
  (``ops/_cuda.py`` ``build``), as entry ``build/<name>``; a library
  already on disk is not a build;
- **new padded shapes** of the compiled forest's walk
  (``serve/compile.py``), as entry ``serve/predict``: the distinct
  ``(rows, features, trees, K)`` shapes that reached the device, which
  stay flat after ``CompiledForest.warmup`` for any request size.

:class:`RecompileWatcher` turns the counts into per-interval deltas for
the serving daemon's ``stats`` reply and ``{"event": "serve"}`` lines.
This module imports no torch.
"""

from __future__ import annotations

import threading
from typing import Dict, Set, Tuple

__all__ = ["note_build", "note_shape", "shape_count", "jit_cache_sizes",
           "total_recompiles", "RecompileWatcher"]

_lock = threading.Lock()
# ---- guarded by _lock ----
_builds: Dict[str, int] = {}          # entry -> builds in this process
_shapes: Dict[str, Set[tuple]] = {}   # entry -> distinct padded shapes


def note_build(name: str) -> None:
    """Count one ``nvcc`` build of kernel library ``name``."""
    key = f"build/{name}"
    with _lock:
        _builds[key] = _builds.get(key, 0) + 1


def note_shape(entry: str, shape: tuple) -> None:
    """Record that ``shape`` reached entry ``entry``'s device walk."""
    with _lock:
        _shapes.setdefault(entry, set()).add(tuple(shape))


def shape_count(entry: str) -> int:
    """Distinct shapes entry ``entry`` has seen in this process."""
    with _lock:
        return len(_shapes.get(entry, ()))


def jit_cache_sizes() -> Dict[Tuple[str, int], int]:
    """Compiles so far per entry, keyed ``(name, 0)`` like the JAX
    package's ``(name, seq)`` keys (the port never re-registers an
    entry, so its sequence number is always 0)."""
    with _lock:
        out = {(k, 0): v for k, v in _builds.items()}
        out.update({(k, 0): len(v) for k, v in _shapes.items()})
    return out


def total_recompiles() -> int:
    """Kernel builds plus padded shapes, over every entry."""
    return sum(jit_cache_sizes().values())


class RecompileWatcher:
    """Delta view over :func:`jit_cache_sizes`.

    ``delta()`` returns the compiles since the previous ``delta()`` (or
    construction); ``total`` sums the deltas."""

    def __init__(self):
        self._last = jit_cache_sizes()
        self.total = 0

    def delta(self) -> int:
        now = jit_cache_sizes()
        d = 0
        for key, size in now.items():
            d += max(0, size - self._last.get(key, 0))
        self._last = now
        self.total += d
        return d
