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

:func:`register_jit` (the JAX package's name) wraps an entry point in
:class:`~lightgbm_tpu_torch.obs.cost.CostTracked` for cost attribution
and records its declared ``max_signatures`` (:func:`jit_declarations`),
the most distinct call signatures it may see in a process; ``lint --ir``
(TPL014) demands the declaration at every site. Cost signatures are not
compiles: they never enter :func:`jit_cache_sizes`, so the daemon's
recompile deltas keep their meaning. This module imports no torch.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set, Tuple

__all__ = ["note_build", "note_shape", "shape_count", "jit_cache_sizes",
           "total_recompiles", "RecompileWatcher", "register_jit",
           "jit_declarations"]

_lock = threading.Lock()
# ---- guarded by _lock ----
_builds: Dict[str, int] = {}          # entry -> builds in this process
_shapes: Dict[str, Set[tuple]] = {}   # entry -> distinct padded shapes
_declared: Dict[str, int] = {}        # entry -> declared max_signatures


def register_jit(name: str, fn: Callable,
                 max_signatures: Optional[int] = None,
                 signature: Optional[Callable] = None,
                 work: Optional[Callable] = None) -> Callable:
    """Wrap entry point ``fn`` for cost attribution under entry ``name``
    and return the wrapper, so definition sites rebind: ``fn =
    register_jit("name", fn, max_signatures=N)``. ``signature`` and
    ``work`` are :class:`~lightgbm_tpu_torch.obs.cost.CostTracked`'s. A
    repeated declaration keeps the largest one."""
    from .cost import CostTracked
    if max_signatures is not None:
        with _lock:
            prev = _declared.get(name)
            _declared[name] = max_signatures if prev is None \
                else max(prev, max_signatures)
    if isinstance(fn, CostTracked):
        return fn
    return CostTracked(name, fn, signature=signature, work=work)


def jit_declarations() -> Dict[str, int]:
    """Declared ``max_signatures`` per entry name."""
    with _lock:
        return dict(_declared)


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
