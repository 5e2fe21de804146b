"""Public ``Dataset`` and ``Booster`` of the port.

Counterpart of ``lightgbm_tpu/basic.py`` for the main path: a dense
numerical matrix (NaN allowed) with labels and optional weights is
binned once — mappers found on the host from a row sample, exactly as
the JAX package does, the bin matrix built on the device — and kept as
a row-major ``[n, F]`` u8 tensor (u16 when a feature has more than 256
bins), the layout the grower streams. ``Booster`` trains through
``models/gbdt.py``, predicts through ``prediction.py`` and reads and
writes the JAX package's model text.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config import Config, resolve_params
from .ops.binning import BinType, MissingType, bin_matrix, find_bin

__all__ = ["Dataset", "Booster", "LightGBMError", "resolve_device"]


class LightGBMError(Exception):
    """Error raised by the port's public API."""


def resolve_device(cfg: Config) -> torch.device:
    """``device_type="cuda"`` (the default) is the card and raises when
    there is none; the port never carries on quietly on the CPU."""
    if cfg.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type='cuda' (the default) but torch.cuda is not "
                "available; pass device_type='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Dataset:
    """Binned training data (dense numerical features)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        if group is not None:
            raise NotImplementedError(
                "query groups are not in the port yet (ROADMAP.md Queue 1 "
                "item 10)")
        if init_score is not None:
            raise NotImplementedError(
                "init_score is not in the port yet (ROADMAP.md Queue 1 "
                "item 12)")
        if reference is not None:
            raise NotImplementedError(
                "Datasets aligned to a reference (valid sets) are not in "
                "the port yet (ROADMAP.md Queue 1 item 12)")
        if categorical_feature not in ("auto", None, "", []):
            raise NotImplementedError(
                "categorical features are not in the port yet (ROADMAP.md "
                "Queue 1 item 13)")
        self.data = data
        self.label = label
        self.weight = weight
        self.feature_name = feature_name
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._bins: Optional[torch.Tensor] = None

    # -- construction ---------------------------------------------------
    def construct(self) -> "Dataset":
        if self._bins is not None:
            return self
        cfg = Config.from_params(self.params)
        self.device = resolve_device(cfg)
        X = self.data
        try:
            import pandas as pd
            if isinstance(X, pd.DataFrame):
                if any(isinstance(X[c].dtype, pd.CategoricalDtype)
                       for c in X.columns):
                    raise NotImplementedError(
                        "categorical features are not in the port yet "
                        "(ROADMAP.md Queue 1 item 13)")
                if self.feature_name == "auto":
                    self.feature_name = [str(c) for c in X.columns]
                X = X.to_numpy(dtype=np.float64, na_value=np.nan)
        except ImportError:
            pass
        if hasattr(X, "toarray"):
            X = np.asarray(X.todense(), np.float64)
        if not (isinstance(X, np.ndarray) and X.dtype == np.float32):
            X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        if self.label is None:
            raise LightGBMError("Label should not be None")
        y = np.asarray(self.label, dtype=np.float64).ravel()
        n, F = X.shape
        if len(y) != n:
            raise LightGBMError(
                f"Length of label ({len(y)}) != number of rows ({n})")
        self._n, self._F_total = n, F
        names = self.feature_name
        if not isinstance(names, list):
            names = [f"Column_{i}" for i in range(F)]
        self._feature_names = list(names)

        sample_cnt = min(cfg.bin_construct_sample_cnt, n)
        if sample_cnt < n:
            rng = np.random.RandomState(cfg.data_random_seed)
            rows = rng.choice(n, size=sample_cnt, replace=False)
        else:
            rows = slice(None)
        full = []
        for j in range(F):
            mb = cfg.max_bin
            if cfg.max_bin_by_feature and j < len(cfg.max_bin_by_feature):
                mb = cfg.max_bin_by_feature[j]
            full.append(find_bin(X[rows, j], mb,
                                 min_data_in_bin=cfg.min_data_in_bin,
                                 bin_type=BinType.NUMERICAL,
                                 use_missing=cfg.use_missing,
                                 zero_as_missing=cfg.zero_as_missing))
        used = [j for j, m in enumerate(full) if not m.is_trivial]
        self._used_features = np.asarray(used, dtype=np.int32)
        self.mappers = [full[j] for j in used]
        self._check_bundling(cfg)
        self._bins = bin_matrix(X, self._used_features, self.mappers,
                                device=self.device)
        self._F = len(self.mappers)
        self.label = y
        self.weight = None if self.weight is None else \
            np.asarray(self.weight, np.float64).ravel()
        if self.free_raw_data:
            self.data = None
        return self

    def _check_bundling(self, cfg: Config) -> None:
        """The JAX package bundles mutually exclusive sparse features
        (EFB) when ``enable_bundle`` is on, its default; a feature joins
        a bundle only when at least 80% of its sampled rows sit in its
        zero bin. The port has no EFB yet, so it refuses data on which
        bundling could apply rather than growing different trees."""
        if not cfg.enable_bundle or len(self.mappers) < 3:
            return
        sparse = sum(m.sparse_rate >= 0.8 for m in self.mappers)
        if sparse >= 2:
            raise NotImplementedError(
                f"{sparse} features are >= 80% zeros, so the JAX package "
                "would bundle them (EFB), which is not in the port yet "
                "(ROADMAP.md Queue 1 item 15); pass enable_bundle=False "
                "to train without bundling")

    # -- accessors ------------------------------------------------------
    def device_bins(self) -> torch.Tensor:
        """``[n, F]`` row-major bin tensor on the device."""
        self.construct()
        return self._bins

    def num_total_features(self) -> int:
        self.construct()
        return self._F_total

    def num_total_bins(self) -> int:
        self.construct()
        return max((m.num_bins for m in self.mappers), default=2)

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._feature_names)

    def used_feature_indices(self) -> np.ndarray:
        self.construct()
        return self._used_features

    def feat_num_bins(self) -> np.ndarray:
        self.construct()
        return np.asarray([m.num_bins for m in self.mappers], np.int32)

    def feat_nan_bin(self) -> np.ndarray:
        """The missing bin per feature (-1: none): rows in it follow the
        learned default direction. NaN features keep it as the last bin,
        zero_as_missing features use the zero bin."""
        self.construct()
        nb = []
        for m in self.mappers:
            if m.missing_type == MissingType.NAN:
                nb.append(m.num_bins - 1)
            elif m.missing_type == MissingType.ZERO:
                nb.append(m.default_bin)
            else:
                nb.append(-1)
        return np.asarray(nb, np.int32)

    def feature_infos(self) -> List[str]:
        self.construct()
        out = []
        lut = {int(j): m for j, m in zip(self._used_features, self.mappers)}
        for j in range(self._F_total):
            m = lut.get(j)
            out.append("none" if m is None
                       else f"[{m.min_value:g}:{m.max_value:g}]")
        return out


class Booster:
    """Trains (from a ``train_set``) or loads (``model_file`` /
    ``model_str``) a model; predicts and saves it."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = params or {}
        self.best_iteration = -1
        self.pandas_categorical = None
        self._engine = None
        self._trees: List = []
        self._cfg: Optional[Config] = None
        self._num_class = 1
        self._feature_names: List[str] = []
        self._feature_infos: List[str] = []
        self._objective_str = "none"
        self._avg_output = False
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be a Dataset instance")
            cfg = Config.from_params(params)
            train_set.params = {**resolve_params(train_set.params),
                                **resolve_params(params)}
            train_set.construct()
            self._cfg = cfg
            self._device = train_set.device
            from .models.gbdt import GBDTBooster
            from .objectives import create_objective
            self._engine = GBDTBooster(cfg, train_set,
                                       create_objective(cfg))
            self._feature_names = train_set.get_feature_name()
            self._feature_infos = train_set.feature_infos()
            self._objective_str = self._objective_repr(cfg)
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            cfg = Config.from_params(params)
            self._device = resolve_device(cfg)
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            from .models.model_io import load_model_string
            load_model_string(self, model_str)
        else:
            raise TypeError(
                "At least one of train_set, model_file or model_str "
                "should be not None")

    @property
    def _models(self) -> List:
        return self._engine.models if self._engine is not None \
            else self._trees

    @staticmethod
    def _objective_repr(cfg: Config) -> str:
        if cfg.objective == "binary":
            return f"binary sigmoid:{cfg.sigmoid:g}"
        return cfg.objective

    # -- training -------------------------------------------------------
    def update(self) -> bool:
        """One boosting iteration; True means no tree could grow."""
        return self._engine.train_one_iter()

    def num_trees(self) -> int:
        return len(self._models)

    def num_model_per_iteration(self) -> int:
        return 1

    def num_feature(self) -> int:
        if self._engine is not None:
            return self._engine.train_set.num_total_features()
        return len(self._feature_names)

    # -- prediction -----------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        if pred_contrib or kwargs.get("pred_early_stop"):
            raise NotImplementedError(
                "pred_contrib and pred_early_stop are not in the port yet "
                "(ROADMAP.md Queue 1 item 17)")
        from .prediction import predict_any
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        return predict_any(self, data, start_iteration, num_iteration,
                           raw_score, pred_leaf)

    # -- model io -------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        from .models.model_io import model_to_string
        return model_to_string(self, num_iteration, start_iteration,
                               importance_type)

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        s = self.model_to_string(num_iteration, start_iteration,
                                 importance_type)
        with open(filename, "w") as f:
            f.write(s)
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = np.zeros((self.num_feature(),), np.float64)
        trees = self._models
        if iteration is not None and iteration > 0:
            trees = trees[:iteration]
        for t in trees:
            for i in range(t.num_nodes):
                f = int(t.split_feature[i])
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += max(0.0, float(t.split_gain[i]))
        if importance_type == "split":
            return imp.astype(np.int64)
        return imp
