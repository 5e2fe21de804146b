# port lint fixture: TPL010 positive — collectives under branches on
# rank-local read-backs.
import torch.distributed as dist


def maybe_reduce(hist, comm):
    if hist.abs().max().item() > 0:
        # EXPECT: TPL010
        comm.all_reduce(hist)
    return hist


def drain(flag, t):
    done = flag.item()
    while not done:
        # EXPECT: TPL010
        dist.all_reduce(t)
        done = True


def bare_pragma(flag, comm, t):
    # tpulint: replicated-cond
    if flag.item():
        # EXPECT: TPL010
        comm.all_reduce(t)
