# port lint fixture: TPL005 negative — a sorted order every rank shares.
import torch.distributed as dist


def reduce_groups(groups, tensors):
    for g in sorted({"grad", "hess"} | set(groups)):
        dist.all_reduce(tensors[g])
