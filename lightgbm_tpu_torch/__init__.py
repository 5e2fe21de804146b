"""lightgbm_tpu_torch: the PyTorch/CUDA port of ``lightgbm_tpu``.

A second package beside the JAX one, with the same public names for
the part that is ported (every objective of the JAX package, on dense
numerical and categorical data, with EFB, basic monotone constraints
and path smoothing, valid sets, metrics, callbacks, ``cv``, bagging,
GOSS, column sampling, DART and random forests; prediction; model
text), running on an NVIDIA GPU by default
(``device_type="cuda"``; ``"cpu"`` on request). Its two kernels —
the gradient histogram (K1, ``csrc/hist.cu``) and the stable row
partition (K2, ``csrc/partition.cu``) — are CUDA C++ for ``sm_90a``,
built by ``nvcc`` at first use. It imports neither ``jax`` nor
``lightgbm_tpu``.

    import lightgbm_tpu_torch as lgb
    ds = lgb.Dataset(X, label=y, params={"max_bin": 255})
    bst = lgb.train({"objective": "binary", "num_leaves": 255}, ds, 5)
    p = bst.predict(X_valid); bst.save_model("m.txt")
"""

from .basic import Booster, Dataset, LightGBMError
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation, reset_parameter)
from .engine import CVBooster, cv, train

__all__ = ["Booster", "Dataset", "LightGBMError", "train", "cv",
           "CVBooster", "CallbackEnv", "EarlyStopException",
           "early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter"]
__version__ = "0.1.0"
