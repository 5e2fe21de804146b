# port lint fixture: TPL002 negative — read-backs outside hot code, and
# host values (not tensors) in it.
import numpy as np
import torch


def setup(t: torch.Tensor):
    return t.item(), t.cpu()


# tpulint: hot
def per_split(hist: torch.Tensor, sizes):
    n = int(sizes[0])
    arr = np.asarray(sizes)
    names = sizes.tolist()
    return hist + 1, n, arr, names
