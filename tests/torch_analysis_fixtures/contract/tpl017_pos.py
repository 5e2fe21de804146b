"""TPL017 positives: env reads that drift from the registry."""

import os


def read():
    # EXPECT: TPL017
    a = os.environ.get("LIGHTGBM_TPU_OOPS")
    # EXPECT: TPL017
    b = os.environ.get("LIGHTGBM_TPU_PING", "2")
    # EXPECT: TPL017
    c = os.environ.get("LIGHTGBM_TPU_PONG", "x")
    return a, b, c
