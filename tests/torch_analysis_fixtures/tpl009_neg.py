# port lint fixture: TPL009 negative — float32 arrays, an explicit
# dtype, and an upload outside hot code.
import numpy as np
import torch


# tpulint: hot
def upload(x, dev):
    w = np.zeros(len(x), dtype=np.float32)
    a = torch.as_tensor(w, device=dev)
    b = torch.from_numpy(np.ones(4)).to(dev, torch.float32)
    c = torch.as_tensor(np.ones(4), dtype=torch.float64, device=dev)
    return a, b, c


def setup(dev):
    return torch.as_tensor(np.zeros(3), device=dev)
