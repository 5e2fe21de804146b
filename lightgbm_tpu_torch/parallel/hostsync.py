"""Host collectives of a world, under the collective watchdog (the JAX
package's ``parallel/hostsync.py``).

Every cross-rank sync outside the growth loop is a *host* collective:
small numpy vectors (step checks, phase-skew snapshots, dataset
metadata) or byte blobs (rank 0's bin mappers). Two transports carry
them:

``kv``
    The process group's store (the ``TCPStore`` that
    ``init_process_group(init_method="tcp://...")`` stands up on rank
    0), with a key per rank and collective: a stalled peer is named
    exactly ("rank 1 never published ..."), which a collective on the
    process group cannot attribute.
``device``
    A collective on the process group (``all_gather`` /
    ``broadcast`` of byte tensors on the rank's device).

``auto`` (the default) takes ``device`` on an NCCL world and ``kv``
otherwise; ``LIGHTGBM_TPU_HOSTSYNC=kv|device`` overrides. Every
operation runs under :func:`resilience.watchdog.guarded`, so a hang or a
transport error becomes a ``LightGBMError`` naming the collective, the
iteration and the last sync heard from.

A :class:`HostWorld` names the store, the rank and the world's size; the
functions take one (tests build them over a ``HashStore`` with a thread
per rank) and default to the initialized world's.
"""

from __future__ import annotations

import io
import itertools
import os
import threading
import time
from datetime import timedelta
from typing import List, Optional

import numpy as np

from ..resilience import watchdog

__all__ = ["HostWorld", "host_allgather", "host_broadcast_bytes",
           "transport", "default_world"]


class HostWorld:
    """One rank's handle on the host transport: a ``torch.distributed``
    store (None for the device transport), its rank, the world's size,
    and its own collective sequence number. Ranks run the same sequence
    of host collectives (the contract ``spmd.verify_step_consistency``
    checks), so the numbers agree across ranks and every collective's
    keys are unique within a world."""

    def __init__(self, store, rank: int, size: int):
        self.store = store
        self.rank = int(rank)
        self.size = int(size)
        self._seq = itertools.count()
        # this rank's published keys awaiting deletion (below)
        self._pending: List[str] = []
        self._lock = threading.Lock()

    def next_seq(self) -> int:
        return next(self._seq)


_DEFAULT: dict = {}


def default_world() -> HostWorld:
    """The initialized world's :class:`HostWorld` (a world of one
    without ``torch.distributed``)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return HostWorld(None, 0, 1)
    key = id(dist.group.WORLD)
    w = _DEFAULT.get("world")
    if w is None or _DEFAULT.get("key") != key:
        from torch.distributed import distributed_c10d
        w = HostWorld(distributed_c10d._get_default_store(),
                      dist.get_rank(), dist.get_world_size())
        _DEFAULT.update(world=w, key=key)
    return w


def transport(world: Optional[HostWorld] = None) -> str:
    """The effective transport: ``device`` or ``kv``."""
    mode = os.environ.get("LIGHTGBM_TPU_HOSTSYNC", "auto").lower()
    if world is not None and world.store is not None \
            and not _world_is_default(world):
        return "kv"       # a store handed in: only kv can use it
    if mode in ("kv", "device"):
        return mode
    if mode != "auto":
        from ..log import log_warning
        log_warning(f"LIGHTGBM_TPU_HOSTSYNC={mode!r} is not auto|kv|"
                    "device; using auto")
    import torch.distributed as dist
    return "device" if dist.is_initialized() \
        and dist.get_backend() == "nccl" else "kv"


def _world_is_default(world: HostWorld) -> bool:
    return _DEFAULT.get("world") is world


class _StalledRank(RuntimeError):
    """A peer did not publish within the deadline (kv transport). The
    watchdog counts it as a timeout through ``is_timeout``."""

    is_timeout = True


def _deadline_s() -> float:
    limit = watchdog.deadline_seconds()
    if limit <= 0:
        # watchdog disabled: the kv waits block essentially forever
        return 7 * 24 * 3600.0
    return max(1.0, limit)


def _outer_deadline() -> Optional[float]:
    """The watchdog deadline of the thread around a kv collective: the
    kv waits time out at the configured deadline themselves, naming the
    silent rank, so the outer deadline only backstops a hung client."""
    limit = watchdog.deadline_seconds()
    if limit <= 0:
        return limit
    return limit * 1.5 + 10.0


def _is_store_timeout(exc: BaseException) -> bool:
    import torch.distributed as dist
    err = getattr(dist, "DistStoreError", None)
    return (err is not None and isinstance(exc, err)) \
        or "timeout" in str(exc).lower() \
        or "timed out" in str(exc).lower()


def _array_to_bytes(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return buf.getvalue()


def _array_from_bytes(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b), allow_pickle=False)


def _kv_exchange(world: HostWorld, name: str, payload: Optional[bytes],
                 gather: bool) -> List[Optional[bytes]]:
    """One kv collective: every rank publishes (``gather``) or only rank
    0 does (broadcast), then every rank reads the keys it needs. The
    waits share one deadline, so the first silent peer is named with the
    ranks already heard from. This rank's keys are deleted after a later
    gather completes: completing gather E proves every rank finished
    every earlier collective, and with it every read of those keys."""
    store, me, nproc = world.store, world.rank, world.size
    prefix = f"lgbm_hostsync/{world.next_seq()}/{name}"
    deadline = _deadline_s()
    if payload is not None:
        store.set(f"{prefix}/{me}", payload)
    readers = range(nproc) if gather else (0,)
    out: List[Optional[bytes]] = [None] * nproc
    heard: List[int] = []
    t0 = time.monotonic()
    for r in readers:
        if r == me and payload is not None:
            out[r] = payload
            heard.append(r)
            continue
        left = deadline - (time.monotonic() - t0)
        key = f"{prefix}/{r}"
        try:
            store.wait([key], timedelta(seconds=max(0.001, left)))
        except Exception as e:
            if not _is_store_timeout(e):
                raise
            raise _StalledRank(
                f"rank {r} never published its '{name}' payload "
                f"(heard from ranks {heard or 'none'}; "
                f"{nproc} expected)") from e
        out[r] = bytes(store.get(key))
        heard.append(r)
    if payload is not None:
        doomed: List[str] = []
        if gather:
            with world._lock:
                doomed, world._pending[:] = list(world._pending), []
        for key in doomed:
            try:
                store.delete_key(key)
            except Exception:
                pass
        with world._lock:
            world._pending.append(f"{prefix}/{me}")
    return out


def _device_allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's bytes through ``all_gather`` on the process group
    (lengths first, then the blobs padded to the longest)."""
    import torch
    import torch.distributed as dist
    from .distributed import rank_device
    dev = rank_device()
    n = dist.get_world_size()
    ln = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    lens = [torch.zeros_like(ln) for _ in range(n)]
    dist.all_gather(lens, ln)
    lens = [int(x.item()) for x in lens]
    buf = torch.zeros(max(lens), dtype=torch.uint8, device=dev)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8).to(dev)
    parts = [torch.zeros_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf)
    return [bytes(p[:k].cpu().numpy().tobytes())
            for p, k in zip(parts, lens)]


def host_allgather(arr: np.ndarray, name: str,
                   iteration: Optional[int] = None,
                   world: Optional[HostWorld] = None) -> np.ndarray:
    """Allgather one equal-shaped host array: ``[P, *shape]``, under
    the watchdog; a world of one returns ``arr[None]``."""
    world = world or default_world()
    arr = np.asarray(arr)
    if world.size <= 1:
        return arr[None]
    if transport(world) == "device":
        def _run():
            parts = _device_allgather_bytes(_array_to_bytes(arr))
            return np.stack([_array_from_bytes(p) for p in parts])
        return watchdog.guarded(name, _run, iteration=iteration,
                                world=world.size)

    def _run():
        parts = _kv_exchange(world, name, _array_to_bytes(arr), gather=True)
        return np.stack([_array_from_bytes(p) for p in parts])
    return watchdog.guarded(name, _run, iteration=iteration,
                            world=world.size, deadline=_outer_deadline())


def host_broadcast_bytes(payload: Optional[bytes], name: str,
                         iteration: Optional[int] = None,
                         world: Optional[HostWorld] = None) -> bytes:
    """Rank 0's byte blob on every rank (rank 0 passes it, the others
    None), under the watchdog; a world of one returns the payload."""
    world = world or default_world()
    if world.size <= 1:
        return payload if payload is not None else b""
    if transport(world) == "device":
        def _run():
            mine = payload if world.rank == 0 else b""
            return _device_allgather_bytes(mine or b"")[0]
        return watchdog.guarded(name, _run, iteration=iteration,
                                world=world.size)

    def _run():
        parts = _kv_exchange(world, name,
                             payload if world.rank == 0 else None,
                             gather=False)
        return parts[0]
    return watchdog.guarded(name, _run, iteration=iteration,
                            world=world.size, deadline=_outer_deadline())
