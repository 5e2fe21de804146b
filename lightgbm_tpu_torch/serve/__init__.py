"""Inference serving.

Counterpart of ``lightgbm_tpu/serve/``: a forest is *compiled* once
into device tensors walked in power-of-two row buckets
(:mod:`~lightgbm_tpu_torch.serve.compile`), requests are micro-batched
into those buckets by one worker thread
(:mod:`~lightgbm_tpu_torch.serve.batcher`), and the JSON-lines daemon
(:mod:`~lightgbm_tpu_torch.serve.daemon`: ``main``, ``handle_request``,
``ServeState``; ``python -m lightgbm_tpu_torch serve``) serves them over
a socket with hot swaps from a watch target.

Lazy like the package root: importing this package loads no submodule
(and no torch) until one of its names is used.
"""

from __future__ import annotations

_LAZY = {
    "CompiledForest": "compile", "compile_forest": "compile",
    "bucket_rows": "compile",
    "MicroBatcher": "batcher", "QueueFullError": "batcher",
    "SheddingError": "batcher",
    "main": "daemon", "handle_request": "daemon", "ServeState": "daemon",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{target}", __name__)
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
