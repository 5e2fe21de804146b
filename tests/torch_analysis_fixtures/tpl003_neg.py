# port lint fixture: TPL003 negative — built and compiled once, at
# set-up.
from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.serve.compile import compile_forest


def setup(booster):
    lib = _cuda.library("hist")
    return lib, compile_forest(booster)
