"""The world of ranks: the port's counterpart of the JAX device mesh
(``lightgbm_tpu/parallel/mesh.py``).

In the JAX package one process may drive N local devices through a 1-D
mesh. In the port one rank is one process on one device, so the mesh
is the ``torch.distributed`` world: this rank's index, the world's size,
the rank's device, the backend and the process group
(:class:`Mesh`). The world's size is the mesh's size; a world of one
rank trains exactly as ``serial`` does (the JAX ``dp_active`` rule,
``len(jax.devices()) > 1``).

Rows are laid out as the JAX mesh lays them out: equal contiguous shards
of ``ceil(n / D)`` rows in rank order (:func:`shard_rows`); the JAX
package pads the last shard with rows of weight 0 (:func:`pad_rows`),
the port gives the last rank fewer rows instead, since no rows cross
ranks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

__all__ = ["Mesh", "make_mesh", "pad_rows", "shard_rows", "world_size",
           "world_rank"]


class Mesh(NamedTuple):
    """One rank's view of the world."""
    rank: int
    size: int
    device: object          # torch.device of this rank
    backend: str            # "nccl", "gloo", or "none" (no world)
    group: object = None    # the process group (None: the default one)


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """Ranks of the initialized world (1 without one)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def world_rank() -> int:
    """This process's rank (0 without a world)."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def make_mesh(num_devices: int = 0, device=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized world.

    ``num_devices`` is the JAX parameter: there it splits one process
    over N local devices; here it must be 0 or the world's size, since a
    rank is one process on one device."""
    from . import distributed
    size, rank = world_size(), world_rank()
    if num_devices and int(num_devices) != size:
        raise ValueError(
            f"num_devices={num_devices}: a rank of the port is one process "
            f"on one device, so num_devices must be 0 or the world's size "
            f"({size}); start a world of {num_devices} ranks with `python "
            f"-m lightgbm_tpu_torch launch {num_devices} -- <worker>`")
    dist = _dist()
    backend = dist.get_backend() if dist is not None else "none"
    if device is None:
        device = distributed.rank_device()
    return Mesh(rank=rank, size=size, device=device, backend=str(backend))


def pad_rows(n: int, num_devices: int) -> int:
    """Rows of padding the JAX mesh adds so every device holds an equal
    shard."""
    return (-n) % num_devices


def shard_rows(mesh: Mesh, n: int, rank: Optional[int] = None
               ) -> Tuple[int, int]:
    """Global rows ``[lo, hi)`` of rank ``rank`` (this one by default):
    shards of ``ceil(n / D)`` rows in rank order, the last one short by
    the JAX mesh's padding."""
    D = max(1, mesh.size)
    r = mesh.rank if rank is None else rank
    per = -(-n // D)
    lo = min(r * per, n)
    return lo, min(lo + per, n)
