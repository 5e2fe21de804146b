"""TPL017 negatives: declared vars, matching defaults, bare reads."""

import os


def read(env):
    a = os.environ.get("LIGHTGBM_TPU_PING", "1")
    # a declared-default var may still be read bare (caller handles)
    b = os.environ.get("LIGHTGBM_TPU_PING")
    # no-default vars are read bare with a site-local fallback
    c = os.environ.get("LIGHTGBM_TPU_PONG") or "off"
    env["LIGHTGBM_TPU_PONG"] = "on"
    return a, b, c
