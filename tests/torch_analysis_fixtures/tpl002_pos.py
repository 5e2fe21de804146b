# port lint fixture: TPL002 positive — host syncs in code a hot driver
# reaches.
import numpy as np
import torch


def _helper(t: torch.Tensor):
    # EXPECT: TPL002
    return t.tolist()


# tpulint: hot
def per_split(hist: torch.Tensor, counts):
    # EXPECT: TPL002
    best = hist.argmax().item()
    # EXPECT: TPL002
    host = hist.cpu()
    # EXPECT: TPL002
    n = int(hist.sum())
    # EXPECT: TPL002
    arr = np.asarray(hist)
    # EXPECT: TPL002
    torch.cuda.synchronize()
    # EXPECT: TPL002
    moved = hist.to("cpu")
    return best, host, n, arr, moved, _helper(hist), int(counts[0])
