"""Row placement over a world, the upload barrier and the world's
snapshot (the JAX package's ``parallel/placement.py``).

In the JAX package a ``ShardPlan`` lays each host's binned rows into its
``NamedSharding`` mesh slice. In the port each rank's bins already live
only on its own device (``spmd.distributed_dataset``, or the engine's
slice of a replicated Dataset), so placement here is:

- :class:`ShardPlan`: the layout of ``n_global`` rows over the world (the
  JAX mesh's ``ceil(n / D)`` rows per rank, the last rank short by the
  padding) and :meth:`ShardPlan.place`, this rank's rows of a host matrix
  on its device;
- :func:`upload_barrier`: the world's sync after placement, a host
  collective under the watchdog that every rank joins;
- :func:`fetch_global`: a row-sharded tensor (the ``[K, n]`` score)
  assembled on every rank, a world collective that every rank joins
  before rank 0 writes a snapshot, and :func:`shard_fingerprints`, one
  sha256 per rank's rows of it, so a resumed world can prove its shard
  equal to what was saved (``resilience/checkpoint.py``);
- :func:`shard_residency`: ``shard_residency=auto`` resolved (``device``
  in a world on CUDA: the Dataset's host copy of its bins is freed,
  ``Dataset.free_host_bins``).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

from .mesh import shard_rows

__all__ = ["ShardPlan", "place_rows", "upload_barrier",
           "fetch_addressable", "fetch_global", "shard_fingerprints",
           "host_bytes_gauge", "shard_residency"]


class ShardPlan:
    """Row layout of ``n_global`` rows over a world (``mesh``, a
    :class:`parallel.mesh.Mesh`): rank ``r`` holds ``bounds[r]``."""

    def __init__(self, mesh, n_global: int):
        self.mesh = mesh
        self.n_global = int(n_global)
        self.bounds = [shard_rows(mesh, self.n_global, r)
                       for r in range(max(1, mesh.size))]
        self.counts = [hi - lo for lo, hi in self.bounds]

    def local_rows(self):
        """``(lo, hi)`` of this rank."""
        return self.bounds[self.mesh.rank]

    def place(self, host_rows, row_axis: int = 0, local_offset: int = 0):
        """This rank's rows of ``host_rows`` (which holds the global rows
        ``[local_offset, local_offset + len)``) as a tensor on its
        device; refuses a host matrix that does not cover them."""
        import torch
        host_rows = np.asarray(host_rows)
        lo, hi = self.local_rows()
        have = host_rows.shape[row_axis]
        if lo < local_offset or hi > local_offset + have:
            raise ValueError(
                f"ShardPlan.place: rank {self.mesh.rank} needs global rows "
                f"[{lo}, {hi}) but the host matrix holds "
                f"[{local_offset}, {local_offset + have})")
        sl = [slice(None)] * host_rows.ndim
        sl[row_axis] = slice(lo - local_offset, hi - local_offset)
        return torch.from_numpy(np.ascontiguousarray(
            host_rows[tuple(sl)])).to(self.mesh.device)


def place_rows(mesh, host_rows, row_axis: int = 0):
    """One-shot :meth:`ShardPlan.place` of a replicated host matrix."""
    host_rows = np.asarray(host_rows)
    return ShardPlan(mesh, host_rows.shape[row_axis]).place(
        host_rows, row_axis=row_axis)


def upload_barrier(what: str = "placement/upload_barrier") -> None:
    """Post-placement world sync: every rank joins unconditionally (a
    rank that skips it deadlocks the world); a world of one returns."""
    from .hostsync import default_world, host_allgather
    world = default_world()
    if world.size <= 1:
        return
    host_allgather(np.asarray([world.rank], np.int64), what, world=world)


def fetch_addressable(arr) -> np.ndarray:
    """Host value of a tensor or array held by this rank (never a
    collective)."""
    if isinstance(arr, np.ndarray):
        return arr
    return arr.detach().cpu().numpy()


def fetch_global(arr, comm=None, counts: Optional[Sequence[int]] = None
                 ) -> np.ndarray:
    """The world's value of a tensor sharded along its last axis (rank
    ``r`` holds ``counts[r]`` of it), on every rank: one ``all_gather``
    on ``comm``, which every rank must join. Without a world, the
    tensor's host value."""
    if comm is None or comm.size <= 1:
        return fetch_addressable(arr)
    import torch
    t = torch.movedim(arr, -1, 0).contiguous()
    full = comm.gather_rows(t, list(counts))
    return torch.movedim(full, 0, -1).cpu().numpy()


def shard_fingerprints(full: np.ndarray, bounds: Sequence[Sequence[int]]
                       ) -> Optional[List[dict]]:
    """One ``{"index", "sha256"}`` per rank's rows ``[lo, hi)`` of an
    assembled ``[..., n]`` array (None for a world of one)."""
    if len(bounds) <= 1:
        return None
    out = []
    for lo, hi in bounds:
        part = np.ascontiguousarray(full[..., lo:hi])
        out.append({"index": f"rows[{lo}:{hi}]",
                    "sha256": hashlib.sha256(part.tobytes()).hexdigest()})
    return out


def host_bytes_gauge(nbytes: int) -> None:
    """Publish the host-resident binned bytes to the telemetry registry."""
    try:
        from ..obs.registry import registry
        registry.gauge("host_binned_bytes").set(float(nbytes))
    except Exception:
        pass


def shard_residency(setting: str, world_size: int, device_type: str) -> str:
    """``shard_residency`` resolved: ``auto`` is ``device`` in a world on
    CUDA (the host copy of the bins is freed), ``host`` otherwise."""
    if setting != "auto":
        return setting
    return "device" if world_size > 1 and device_type == "cuda" else "host"
