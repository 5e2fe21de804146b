# port lint fixture: TPL014 positive — an entry registered without its
# max_signatures.
from lightgbm_tpu_torch.obs.jit_tracker import register_jit


def walk(x):
    return x + 1


# EXPECT: TPL014
walk = register_jit("fixture/walk", walk)
