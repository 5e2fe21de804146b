"""In-process inference serving.

Counterpart of ``lightgbm_tpu/serve/``: a forest is *compiled* once
into device tensors walked in power-of-two row buckets
(:mod:`~lightgbm_tpu_torch.serve.compile`), and requests are
micro-batched into those buckets by one worker thread
(:mod:`~lightgbm_tpu_torch.serve.batcher`). The JSON-lines daemon
(``main``, ``handle_request``, ``ServeState``) is not in the port yet:
those names raise, naming ROADMAP.md Queue 1 item 19.

Lazy like the package root: importing this package loads neither
submodule until one of its names is used.
"""

from __future__ import annotations

from ..config import _Q1

_LAZY = {
    "CompiledForest": "compile", "compile_forest": "compile",
    "bucket_rows": "compile",
    "MicroBatcher": "batcher", "QueueFullError": "batcher",
    "SheddingError": "batcher",
}

_DAEMON = ("main", "handle_request", "ServeState")

__all__ = sorted(set(_LAZY) | set(_DAEMON))


def _daemon_refused(name):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"serve.{name} (the serving daemon) is not in the port yet "
            f"({_Q1.format(19)})")
    refused.__name__ = name
    return refused


main = _daemon_refused("main")
handle_request = _daemon_refused("handle_request")
ServeState = _daemon_refused("ServeState")


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
