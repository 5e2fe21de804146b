# port lint fixture: TPL003 positive — a kernel build, a kernel library
# load and a compiled forest in loops or hot code.
from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.serve.compile import compile_forest


def rebuild_each(names):
    for n in names:
        # EXPECT: TPL003
        _cuda.build(n)


def forests(boosters):
    out = []
    for b in boosters:
        # EXPECT: TPL003
        out.append(compile_forest(b))
    return out


# tpulint: hot
def per_iteration(booster):
    # EXPECT: TPL003
    return _cuda.library("hist")
