# port lint fixture: TPL014 negative — the entry declares its surface.
from lightgbm_tpu_torch.obs.jit_tracker import register_jit


def walk(x):
    return x + 1


walk = register_jit("fixture/walk_declared", walk, max_signatures=4)
