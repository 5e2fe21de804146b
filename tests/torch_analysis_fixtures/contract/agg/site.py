"""Exercises exactly half of the agg mini registry, so the unused
half surfaces as aggregate findings anchored in obs/schemas.py."""

import os


def emit(log, registry):
    log.append({"event": "beep", "n": 1})
    registry.counter("beeps").inc()
    return os.environ.get("LIGHTGBM_TPU_BEEP", "5")
