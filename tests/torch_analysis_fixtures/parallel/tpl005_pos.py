# port lint fixture: TPL005 positive — set order feeding the order of
# collectives.
import torch.distributed as dist


def reduce_groups(groups, tensors):
    # EXPECT: TPL005
    for g in {"grad", "hess"} | set(groups):
        dist.all_reduce(tensors[g])
