"""Artifact-store transport: the publish/serve handoff over any target.

A copy of ``lightgbm_tpu/resilience/store.py``. The manifest-first
publication protocol (``resilience/publisher.py``) and the serving
daemon's watcher (``serve/daemon.py``) ride this interface, so the same
code publishes into a local directory or an object store.

The interface is object-store-shaped (whole-blob put/get/list/delete,
no rename, no partial writes). The one atomicity property the protocol
needs is "a put is all-or-nothing", which object PUTs give natively and
:class:`LocalDirStore` implements with a same-directory tmp file and
``os.replace`` (``utils/atomic.py``).

Failure contract:

- a transient transport failure (outage, timeout) raises
  :class:`StoreError`, an ``OSError``, so the publisher's retry loop and
  the watcher's skip paths catch it without a new exception type;
- an absent blob raises ``FileNotFoundError`` (also ``OSError``);
- a torn blob never comes from the store itself: the chaos kinds
  (``publish_torn``, ``store_outage``; ``resilience/faults.py``) model
  it, and the manifest's sha256 check catches it.

:class:`MemoryBackend` is the test double: an in-memory blob map with
injectable latency, outage and torn-write faults, reachable through
``store_for("mem://<name>")``.

Threading: the daemon's watcher thread and test threads touch one
store at once, so :class:`MemoryBackend` guards its blob map and fault
knobs with one lock; :class:`LocalDirStore` holds no state. This module
imports no torch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.atomic import atomic_write_bytes

__all__ = ["StoreError", "ArtifactStore", "LocalDirStore",
           "ObjectStore", "MemoryBackend", "store_for"]


class StoreError(OSError):
    """A transient artifact-store transport failure (outage, timeout).

    Subclasses ``OSError`` on purpose: the publisher's retry loop and
    the serve watcher's skip-and-retry path already handle ``OSError``
    — a new transport must not need new handling."""


class ArtifactStore:
    """Blob-store verbs the publication protocol rides.

    Names are flat (no directories); a put is all-or-nothing — a
    reader never observes a partial blob from the store itself."""

    #: human-readable target for log lines and error messages
    url: str = "store://"

    def put_bytes(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, name: str) -> bytes:
        raise NotImplementedError

    def list_names(self) -> List[str]:
        """All blob names; ``[]`` when the target does not exist yet
        (a publisher creates it on first put)."""
        raise NotImplementedError

    def stat(self, name: str) -> Optional[Tuple[float, int]]:
        """``(mtime, size)`` of a blob, None when absent/unreadable —
        the serve watcher's newest-artifact ordering key."""
        raise NotImplementedError

    def delete(self, name: str) -> None:
        """Remove a blob; idempotent (an absent name is a no-op)."""
        raise NotImplementedError


class LocalDirStore(ArtifactStore):
    """The shared-filesystem transport: one directory, atomic puts via
    the same-dir-tmp + ``os.replace`` convention."""

    def __init__(self, directory):
        self.directory = os.fspath(directory)
        self.url = self.directory

    def put_bytes(self, name: str, data: bytes) -> None:
        atomic_write_bytes(os.path.join(self.directory, name), data)

    def get_bytes(self, name: str) -> bytes:
        with open(os.path.join(self.directory, name), "rb") as fh:
            return fh.read()

    def list_names(self) -> List[str]:
        try:
            return sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return []

    def stat(self, name: str) -> Optional[Tuple[float, int]]:
        try:
            st = os.stat(os.path.join(self.directory, name))
        except OSError:
            return None
        return (st.st_mtime, st.st_size)

    def delete(self, name: str) -> None:
        try:
            os.remove(os.path.join(self.directory, name))
        except FileNotFoundError:
            pass


class MemoryBackend:
    """In-memory blob map with injectable transport faults (tests).

    Fault knobs (all settable at any time, from any thread):

    - ``latency_sec``: every verb sleeps this long first (a slow NFS
      rename / cross-region put);
    - ``set_outage(n)``: the next ``n`` mutating/reading verbs raise
      :class:`StoreError` (n < 0 = outage until cleared with 0);
    - ``tear_next_put()``: the next put stores only a prefix of the
      payload and then raises — the torn-write shape a crashed
      non-atomic writer leaves, which the manifest validation must
      catch downstream.
    """

    def __init__(self, latency_sec: float = 0.0):
        self._lock = threading.Lock()
        # ---- guarded by self._lock ----
        self._blobs: Dict[str, Tuple[float, bytes]] = {}
        self._outage = 0
        self._torn_puts = 0
        self._clock = 0.0           # monotonic per-backend mtime
        self.latency_sec = float(latency_sec)
        self.puts = 0
        self.gets = 0
        self.faults_injected = 0

    # -- fault injection ----------------------------------------------
    def set_outage(self, n: int) -> None:
        with self._lock:
            self._outage = int(n)

    def tear_next_put(self, n: int = 1) -> None:
        with self._lock:
            self._torn_puts = int(n)

    def _enter(self, verb: str) -> None:
        if self.latency_sec > 0:
            time.sleep(self.latency_sec)
        with self._lock:
            if self._outage != 0:
                if self._outage > 0:
                    self._outage -= 1
                self.faults_injected += 1
                raise StoreError(f"injected store outage ({verb})")

    # -- blob verbs ----------------------------------------------------
    def put(self, name: str, data: bytes) -> None:
        self._enter("put")
        with self._lock:
            self._clock += 1.0
            self.puts += 1
            if self._torn_puts > 0:
                self._torn_puts -= 1
                self.faults_injected += 1
                self._blobs[name] = (self._clock,
                                     data[: max(1, len(data) // 3)])
                raise StoreError(f"injected torn put of {name!r}")
            self._blobs[name] = (self._clock, bytes(data))

    def get(self, name: str) -> bytes:
        self._enter("get")
        with self._lock:
            self.gets += 1
            entry = self._blobs.get(name)
        if entry is None:
            raise FileNotFoundError(name)
        return entry[1]

    def list(self) -> List[str]:
        self._enter("list")
        with self._lock:
            return sorted(self._blobs)

    def stat(self, name: str) -> Optional[Tuple[float, int]]:
        with self._lock:
            entry = self._blobs.get(name)
        if entry is None:
            return None
        return (entry[0], len(entry[1]))

    def delete(self, name: str) -> None:
        self._enter("delete")
        with self._lock:
            self._blobs.pop(name, None)


class ObjectStore(ArtifactStore):
    """The object-store-shaped transport: whole-blob verbs delegated
    to a pluggable ``backend`` (a :class:`MemoryBackend` in tests; an
    rsync spool / KV / bucket client in a real deployment). Atomicity
    comes from the backend's all-or-nothing put."""

    def __init__(self, backend, url: str = "object://"):
        self.backend = backend
        self.url = url

    def put_bytes(self, name: str, data: bytes) -> None:
        self.backend.put(name, data)

    def get_bytes(self, name: str) -> bytes:
        return self.backend.get(name)

    def list_names(self) -> List[str]:
        return self.backend.list()

    def stat(self, name: str) -> Optional[Tuple[float, int]]:
        return self.backend.stat(name)

    def delete(self, name: str) -> None:
        self.backend.delete(name)


# process-wide mem:// registry so every component given the same spec
# (publisher, watcher, tests) lands on ONE faultable backend
_mem_lock = threading.Lock()
# ---- guarded by _mem_lock ----
_mem_backends: Dict[str, MemoryBackend] = {}


def store_for(target) -> ArtifactStore:
    """An :class:`ArtifactStore` from a target spec.

    - an ``ArtifactStore`` passes through unchanged;
    - ``mem://<name>`` names a process-shared :class:`MemoryBackend`
      (created on first use — the faultable test transport);
    - anything else (a str / path-like) is a :class:`LocalDirStore`.
    """
    if isinstance(target, ArtifactStore):
        return target
    spec = os.fspath(target)
    if spec.startswith("mem://"):
        with _mem_lock:
            backend = _mem_backends.get(spec)
            if backend is None:
                backend = _mem_backends[spec] = MemoryBackend()
        return ObjectStore(backend, url=spec)
    return LocalDirStore(spec)
