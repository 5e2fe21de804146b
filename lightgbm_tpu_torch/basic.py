"""Public ``Dataset`` and ``Booster`` of the port.

Counterpart of ``lightgbm_tpu/basic.py`` for the ported paths: a dense
matrix (NaN allowed) or a pandas frame, with categorical features named
by ``categorical_feature`` (indices or names, in the constructor or the
params) or given as pandas category columns (mapped to their codes; the
categories are kept as ``pandas_categorical``), with labels, optional
weights and, for
learning to rank, query groups and result-list positions is binned
once — mappers found on the host from a row sample, exactly as
the JAX package does, or taken from a ``reference`` Dataset (a valid
set), the bin matrix built on the device — and kept as a row-major
``[n, F]`` u8 tensor (u16 when a feature has more than 256 bins), the
layout the grower streams. With ``enable_bundle`` (the default),
``Dataset.bundles`` bundles mutually exclusive sparse features (EFB,
``ops/bundling.py``) into an ``[n, G]`` matrix built on the device;
while the bundled matrix is on the device, the ``[n, F]`` one waits on
the host, and the other way round, so one training matrix at a time
takes device memory. ``Booster`` trains through
``models/gbdt.py`` (with valid sets and their metrics: ``add_valid``,
``eval_train``, ``eval_valid``), predicts through ``prediction.py`` and
reads and writes the JAX package's model text.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


def _extract_pandas(data, categorical_feature, pandas_categorical=None):
    """A pandas frame's matrix: category columns become their codes
    (NaN for a missing value), over ``pandas_categorical``'s categories
    when given (a valid set takes its reference's). Returns ``(X, names,
    categorical column indices, the frame's categories per category
    column)``."""
    import pandas as pd
    names = [str(c) for c in data.columns]
    cat_cols, cats, arrs = [], [], []
    for i, col in enumerate(data.columns):
        s = data[col]
        if isinstance(s.dtype, pd.CategoricalDtype):
            if pandas_categorical is not None \
                    and len(cat_cols) < len(pandas_categorical):
                s = s.cat.set_categories(pandas_categorical[len(cat_cols)])
            cat_cols.append(i)
            cats.append(list(s.cat.categories))
            codes = s.cat.codes.to_numpy().astype(np.float64)
            codes[codes < 0] = np.nan
            arrs.append(codes)
        else:
            arrs.append(s.to_numpy(dtype=np.float64, na_value=np.nan))
    X = np.column_stack(arrs) if arrs else np.zeros((len(data), 0))
    if categorical_feature not in ("auto", None, ""):
        cat_cols = _resolve_cat_indices(categorical_feature, names)
    return X, names, cat_cols, cats


def _resolve_cat_indices(categorical_feature, feature_name) -> List[int]:
    """Sorted column indices of a categorical spec: a list of indices
    or names, or a comma-separated string of them."""
    spec = categorical_feature
    if isinstance(spec, str):
        spec = [c for c in spec.split(",") if c]
    out = []
    for c in spec or []:
        if isinstance(c, str) and not c.strip().lstrip("-").isdigit():
            if c not in feature_name:
                raise LightGBMError(f"Unknown categorical feature {c}")
            out.append(feature_name.index(c))
        else:
            out.append(int(c))
    return sorted(set(out))


class Dataset:
    """Binned training data."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.categorical_feature = categorical_feature
        self.pandas_categorical = None
        self.data = data
        self.label = label
        self.reference = reference
        self.init_score = init_score
        self.weight = weight
        self.group = group
        self.position = position
        self.feature_name = feature_name
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._bins: Optional[torch.Tensor] = None
        self._bundle_cache: Dict[int, Any] = {}
        self._query_boundaries: Optional[np.ndarray] = None

    # -- construction ---------------------------------------------------
    def construct(self) -> "Dataset":
        if self._bins is not None:
            return self
        cfg = Config.from_params(self.params)
        # a valid set lives where its reference does
        self.device = self.reference.construct().device \
            if self.reference is not None else resolve_device(cfg)
        X = self.data
        cat_idx: List[int] = []
        try:
            import pandas as pd
            if isinstance(X, pd.DataFrame):
                ref_pc = None if self.reference is None \
                    else self.reference.pandas_categorical
                X, names, cat_idx, pc = _extract_pandas(
                    X, self.categorical_feature, ref_pc)
                if pc:
                    self.pandas_categorical = pc
                if self.feature_name == "auto":
                    self.feature_name = names
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
        if self.reference is not None:
            # the reference's mappers, so the bins line up with its
            # (LoadFromFileAlignWithOtherDataset)
            ref = self.reference
            if ref.num_total_features() != F:
                raise LightGBMError(
                    f"The number of features in data ({F}) is not the "
                    f"same as it was in the reference ({ref._F_total})")
            self.mappers = ref.mappers
            self._used_features = ref._used_features
            self._feature_names = list(ref._feature_names)
        else:
            names = self.feature_name
            if not isinstance(names, list):
                names = [f"Column_{i}" for i in range(F)]
            self._feature_names = list(names)
            # the constructor's spec first, then the params'
            for spec in (self.categorical_feature, cfg.categorical_feature):
                if cat_idx:
                    break
                if spec not in ("auto", None, "", []):
                    cat_idx = _resolve_cat_indices(spec,
                                                   self._feature_names)
            self._find_mappers(cfg, X, set(cat_idx))
        self._bins = bin_matrix(X, self._used_features, self.mappers,
                                device=self.device)
        self._F = len(self.mappers)
        self.label = y
        self.weight = None if self.weight is None else \
            np.asarray(self.weight, np.float64).ravel()
        self.set_init_score(self.init_score)
        if self.group is not None:
            self.set_group(self.group)
            if self._query_boundaries[-1] != n:
                raise LightGBMError("Sum of group sizes != number of rows")
        if self.free_raw_data:
            self.data = None
        return self

    def _find_mappers(self, cfg: Config, X: np.ndarray,
                      cat_idx: set) -> None:
        n, F = X.shape
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
                                 bin_type=BinType.CATEGORICAL
                                 if j in cat_idx else BinType.NUMERICAL,
                                 use_missing=cfg.use_missing,
                                 zero_as_missing=cfg.zero_as_missing))
        used = [j for j, m in enumerate(full) if not m.is_trivial]
        self._used_features = np.asarray(used, dtype=np.int32)
        self.mappers = [full[j] for j in used]

    # -- accessors ------------------------------------------------------
    def device_bins(self) -> torch.Tensor:
        """``[n, F]`` row-major bin tensor on the device (any bundled
        matrix of this Dataset waits on the host meanwhile)."""
        self.construct()
        if self._bins.device != self.device:
            self._park_bundles()
            self._bins = self._bins.to(self.device)
        return self._bins

    def _park_bundles(self) -> None:
        for cap, info in self._bundle_cache.items():
            if info is not None and info.bins_bundled.device.type != "cpu":
                self._bundle_cache[cap] = info._replace(
                    bins_bundled=info.bins_bundled.cpu())

    def bundles(self, cfg: Config):
        """The exclusive feature bundling of this Dataset
        (``ops/bundling.py`` ``BundleInfo``, its bundled ``[n, G]``
        matrix on the device), or None when ``enable_bundle`` is off or
        bundling would not reduce the column count. Built once per bin
        matrix and ``max_cat_to_onehot``. While the bundled matrix is on
        the device, the ``[n, F]`` one waits on the host."""
        self.construct()
        if not cfg.enable_bundle:
            return None
        cap = cfg.max_cat_to_onehot
        if cap not in self._bundle_cache:
            from .ops.bundling import build_bundles
            self._bundle_cache[cap] = build_bundles(
                self.device_bins(), self.mappers, max_cat_onehot=cap)
        info = self._bundle_cache[cap]
        if info is None:
            return None
        if info.bins_bundled.device != self.device:
            self._park_bundles()
            info = self._bundle_cache[cap] = info._replace(
                bins_bundled=info.bins_bundled.to(self.device))
        self._bins = self._bins.cpu()
        return info

    def num_data(self) -> int:
        self.construct()
        return self._n

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

    def get_init_score(self):
        """The user's initial raw scores: ``[n]``, or ``[K * n]``
        class-major for K trees per iteration (None: none)."""
        return self.init_score

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = None if init_score is None else \
            np.asarray(init_score, np.float64)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None,
                     position=None) -> "Dataset":
        """A valid set binned with this Dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, position=position)

    def get_group(self) -> Optional[np.ndarray]:
        """Query sizes, or None without groups."""
        if self._query_boundaries is None:
            return None
        return np.diff(self._query_boundaries)

    def set_group(self, group) -> "Dataset":
        g = np.asarray(group, np.int64).ravel()
        self._query_boundaries = np.concatenate(
            [[0], np.cumsum(g)]).astype(np.int64)
        return self

    def query_boundaries(self) -> Optional[np.ndarray]:
        """int64 ``[nq + 1]`` row offsets of the queries (None without
        groups)."""
        self.construct()
        return self._query_boundaries

    def get_position(self):
        """Per-row result-list positions for position-debiased learning
        to rank (None: no position bias)."""
        return self.position

    def set_position(self, position) -> "Dataset":
        self.position = None if position is None else \
            np.asarray(position).ravel()
        return self

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._feature_names)

    def used_feature_indices(self) -> np.ndarray:
        self.construct()
        return self._used_features

    def inner_feature_index(self, real_idx) -> np.ndarray:
        """Positions among the used features of real feature indices (-1:
        not used)."""
        self.construct()
        lut = np.full((self._F_total,), -1, np.int32)
        lut[self._used_features] = np.arange(len(self._used_features),
                                             dtype=np.int32)
        return lut[np.asarray(real_idx, np.int64)]

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
            if m.bin_type != BinType.NUMERICAL:
                nb.append(-1)
            elif m.missing_type == MissingType.NAN:
                nb.append(m.num_bins - 1)
            elif m.missing_type == MissingType.ZERO:
                nb.append(m.default_bin)
            else:
                nb.append(-1)
        return np.asarray(nb, np.int32)

    def feat_is_cat(self) -> Optional[np.ndarray]:
        """``[F]`` bool categorical features, or None when there are
        none."""
        self.construct()
        arr = np.asarray([m.bin_type == BinType.CATEGORICAL
                          for m in self.mappers], bool)
        return arr if arr.any() else None

    def monotone_array(self, cfg: Config) -> Optional[np.ndarray]:
        """``[F]`` int8 monotone signs of the used features (None
        without constraints)."""
        mc = cfg.monotone_constraints
        if not mc:
            return None
        self.construct()
        full = np.zeros((self._F_total,), np.int8)
        full[:len(mc)] = mc
        return full[self._used_features]

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if self._bins is not None:
            raise LightGBMError("Cannot set categorical feature after the "
                                "Dataset is constructed")
        self.categorical_feature = categorical_feature
        return self

    def feature_infos(self) -> List[str]:
        self.construct()
        out = []
        lut = {int(j): m for j, m in zip(self._used_features, self.mappers)}
        for j in range(self._F_total):
            m = lut.get(j)
            if m is None:
                out.append("none")
            elif m.bin_type == BinType.CATEGORICAL:
                out.append(":".join(str(int(c)) for c in m.bin_to_cat))
            else:
                out.append(f"[{m.min_value:g}:{m.max_value:g}]")
        return out


class Booster:
    """Trains (from a ``train_set``) or loads (``model_file`` /
    ``model_str``) a model; predicts and saves it."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self._blank(params)
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
            objective = create_objective(cfg)
            if hasattr(objective, "set_dataset"):
                objective.set_dataset(train_set)
            self._engine = GBDTBooster(cfg, train_set, objective)
            from .metrics import create_metrics
            self._metrics = create_metrics(cfg)
            self._num_class = cfg.num_class
            self._feature_names = train_set.get_feature_name()
            self._feature_infos = train_set.feature_infos()
            self.pandas_categorical = train_set.pandas_categorical
            self._objective_str = self._objective_repr(cfg)
            self._avg_output = cfg.boosting == "rf"
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

    def _blank(self, params) -> None:
        """The state of a Booster without trees."""
        self.params = params or {}
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_data_name = "training"
        self._metrics: List = []
        self._valid_names: List[str] = []
        self.pandas_categorical = None
        self._engine = None
        self._trees: List = []
        self._cfg: Optional[Config] = None
        self._num_class = 1
        self._feature_names: List[str] = []
        self._feature_infos: List[str] = []
        self._objective_str = "none"
        self._avg_output = False

    @property
    def _models(self) -> List:
        return self._engine.models if self._engine is not None \
            else self._trees

    @staticmethod
    def _objective_repr(cfg: Config) -> str:
        """The model text's objective line, as the JAX package writes
        it."""
        o = cfg.objective
        if o == "binary":
            return f"binary sigmoid:{cfg.sigmoid:g}"
        if o == "multiclass":
            return f"multiclass num_class:{cfg.num_class}"
        if o == "multiclassova":
            return (f"multiclassova num_class:{cfg.num_class} "
                    f"sigmoid:{cfg.sigmoid:g}")
        return o

    # -- training -------------------------------------------------------
    def _preload(self, base: "Booster") -> None:
        """Continue training from ``base``'s trees (init_model). They are
        taken through a model-text round trip, so their thresholds are
        mapped onto this train set's bins (a bin index is only valid for
        the mappers the tree was grown on)."""
        parsed = Booster(model_str=base.model_to_string(),
                         params={"device_type": self._device.type})
        self._engine.preload_models(parsed._trees)
        self._engine.init_iteration = int(self._engine.iter_)

    def update(self) -> bool:
        """One boosting iteration; True means no tree could grow."""
        return self._engine.train_one_iter()

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score ``data`` (binned with the train set's mappers) after
        every tree, for ``eval_valid``."""
        data.construct()
        self._engine.add_valid(data, name)
        self._valid_names.append(name)
        return self

    # -- evaluation -------------------------------------------------------
    def eval_train(self, feval=None) -> List[Tuple]:
        return self._eval(0, self._train_data_name, feval)

    def eval_valid(self, feval=None) -> List[Tuple]:
        out = []
        for i, name in enumerate(self._valid_names):
            out.extend(self._eval(i + 1, name, feval))
        return out

    def eval(self, data, name: str, feval=None) -> List[Tuple]:
        if data is self.train_set:
            return self._eval(0, self._train_data_name, feval)
        for i, v in enumerate(self._engine.valid_sets):
            if v.dataset is data:
                return self._eval(i + 1, name, feval)
        raise LightGBMError("Data should be added with add_valid first")

    def _eval(self, data_idx: int, name: str, feval=None) -> List[Tuple]:
        """``(data name, metric name, value, higher is better)`` of every
        metric, then of every ``feval(score, dataset)`` (score ``[n]``, or
        ``[K, n]``, as a numpy array)."""
        res = self._engine.eval_metrics(self._metrics, data_idx)
        out = [(name, mname, val, self._metric_higher_better(mname))
               for mname, val in res.items()]
        if feval is not None:
            fevals = feval if isinstance(feval, (list, tuple)) else [feval]
            score = self._engine.current_score(data_idx)
            ds = self._engine.train_set if data_idx == 0 else \
                self._engine.valid_sets[data_idx - 1].dataset
            for f in fevals:
                ret = f(score[0] if self._engine.K == 1 else score, ds)
                for (mn, v, hb) in (ret if isinstance(ret, list)
                                    else [ret]):
                    out.append((name, mn, v, hb))
        return out

    def _metric_higher_better(self, mname: str) -> bool:
        for m in self._metrics:
            if m.name == mname:
                return m.higher_better
        return False

    def num_trees(self) -> int:
        return len(self._models)

    def current_iteration(self) -> int:
        return len(self._models) // self.num_model_per_iteration()

    def num_model_per_iteration(self) -> int:
        """K: trees per iteration (the classes of a multiclass model)."""
        if self._engine is not None:
            return self._engine.K
        return max(1, self._num_class)

    def num_feature(self) -> int:
        if self._engine is not None:
            return self._engine.train_set.num_total_features()
        return len(self._feature_names)

    # -- prediction -----------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        from .prediction import predict_any
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        return predict_any(
            self, data, start_iteration, num_iteration, raw_score,
            pred_leaf, pred_contrib,
            pred_early_stop=bool(kwargs.get("pred_early_stop", False)),
            pred_early_stop_freq=int(kwargs.get("pred_early_stop_freq", 10)),
            pred_early_stop_margin=float(kwargs.get(
                "pred_early_stop_margin", 10.0)))

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
            trees = trees[:iteration * self.num_model_per_iteration()]
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
