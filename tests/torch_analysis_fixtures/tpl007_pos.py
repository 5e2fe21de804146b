# port lint fixture: TPL007 positive — collectives reached in
# rank-divergent order.
import torch.distributed as dist


def sync_once(t):
    if dist.get_rank() == 0:
        # EXPECT: TPL007
        dist.all_reduce(t)


def grow(comm, t):
    if comm.rank != 0:
        return t
    # EXPECT: TPL007
    return comm.all_reduce(t)


def recover(comm, t):
    try:
        return t.sum()
    except RuntimeError:
        # EXPECT: TPL007
        comm.all_reduce(t)
