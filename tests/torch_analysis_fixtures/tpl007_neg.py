# port lint fixture: TPL007 negative — the rank picks the arguments,
# every rank joins.
import torch
import torch.distributed as dist

from lightgbm_tpu_torch.parallel.hostsync import HostWorld


def sync(comm, t):
    payload = t if comm.rank == 0 else torch.zeros_like(t)
    return comm.all_reduce(payload)


def world_of(store, n):
    world = HostWorld(store, dist.get_rank(), n)
    if world.size > 1:
        dist.barrier()
    return world
