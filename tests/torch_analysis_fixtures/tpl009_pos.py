# port lint fixture: TPL009 positive — float64 numpy values uploaded in
# hot code without a dtype.
import numpy as np
import torch


# tpulint: hot
def upload(x, dev):
    w = np.zeros(len(x))
    # EXPECT: TPL009
    a = torch.as_tensor(w, device=dev)
    # EXPECT: TPL009
    b = torch.from_numpy(np.ones(4)).to(dev)
    return a, b
