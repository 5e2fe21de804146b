"""lightgbm_tpu_torch: the PyTorch/CUDA port of ``lightgbm_tpu``.

A second package beside the JAX one, with the same public names for
the part that is ported (every objective of the JAX package, on dense
numerical and categorical data, with EFB, basic monotone constraints
and path smoothing, valid sets, metrics, callbacks, ``cv``, bagging,
GOSS, column sampling, DART and random forests; prediction; model
text), running on an NVIDIA GPU by default
(``device_type="cuda"``; ``"cpu"`` on request). The Python surface is
the JAX package's too: files and binary datasets in, custom objectives,
refit, the sklearn wrappers (``LGBMClassifier``, ...), plotting, C++
conversion and the command line (``python -m lightgbm_tpu_torch
config=train.conf``). Large data streams in chunk by chunk (``data/``:
chunk sources, ``Sequence``, ``two_round``, ``ingest_chunk_rows``), and
``Booster.compile()`` gives a forest stacked on the device once for
serving (``serve/``, with a micro-batcher). Long runs checkpoint and
resume (``checkpoint``, ``train(resume_from=)``), train through
non-finite values (``nonfinite_policy``) and device OOMs (the
histogram pool steps down), and stream per-iteration telemetry
(``telemetry``; ``resilience/``, ``obs/``). Its two kernels —
the gradient histogram (K1, ``csrc/hist.cu``) and the stable row
partition (K2, ``csrc/partition.cu``) — are CUDA C++ for ``sm_90a``,
built by ``nvcc`` at first use. It imports neither ``jax`` nor
``lightgbm_tpu``.

    import lightgbm_tpu_torch as lgb
    ds = lgb.Dataset(X, label=y, params={"max_bin": 255})
    bst = lgb.train({"objective": "binary", "num_leaves": 255}, ds, 5)
    p = bst.predict(X_valid); bst.save_model("m.txt")
"""

__all__ = ["Dataset", "Booster", "CVBooster", "LightGBMError",
           "train", "cv",
           "early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter", "telemetry", "checkpoint",
           "EarlyStopException", "CallbackEnv",
           "register_logger", "Config",
           "LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker",
           "plot_importance", "plot_metric", "plot_split_value_histogram",
           "plot_tree", "create_tree_digraph"]
__version__ = "0.1.0"

# every public name is loaded on first access (PEP 562), so importing
# the package imports neither torch nor the optional extras
# (scikit-learn; matplotlib and graphviz when called): `python -m
# lightgbm_tpu_torch serve --help` and the daemon's parse path stay
# torch-free
_LAZY = {
    "Booster": "basic", "Dataset": "basic", "LightGBMError": "basic",
    "Sequence": "basic",
    "CallbackEnv": "callback", "EarlyStopException": "callback",
    "checkpoint": "callback", "early_stopping": "callback",
    "log_evaluation": "callback", "record_evaluation": "callback",
    "reset_parameter": "callback", "telemetry": "callback",
    "Config": "config",
    "CVBooster": "engine", "cv": "engine", "train": "engine",
    "register_logger": "log",
    "LGBMModel": "sklearn", "LGBMClassifier": "sklearn",
    "LGBMRegressor": "sklearn", "LGBMRanker": "sklearn",
    "plot_importance": "plotting", "plot_metric": "plotting",
    "plot_split_value_histogram": "plotting", "plot_tree": "plotting",
    "create_tree_digraph": "plotting",
}


# submodules reachable as attributes (`lightgbm_tpu_torch.basic`, ...)
_SUBMODULES = {
    "basic", "callback", "cli", "config", "convert", "data", "engine",
    "interop", "log", "metrics", "models", "objectives", "obs", "ops",
    "plotting", "prediction", "ranking", "resilience", "serve", "shap",
    "sklearn", "utils",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None and name not in _SUBMODULES:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{target or name}", __name__)
    value = getattr(mod, name) if target is not None else mod
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
