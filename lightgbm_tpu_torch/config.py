"""Training parameters of the PyTorch/CUDA port.

A copy of the part of ``lightgbm_tpu/config.py`` that the port reads:
the same parameter names, aliases, defaults and bounds, with one
difference — ``device_type`` defaults to ``"cuda"`` (the JAX package's
is ``"tpu"``). The port keeps its own copy because it imports nothing
of the JAX package.

Three kinds of keys:

- fields of :class:`Config` — implemented;
- keys of :data:`NOT_IMPLEMENTED` — parameters of the JAX package that
  the port does not implement yet. Passing one at a value other than
  its JAX default raises ``NotImplementedError`` naming the ROADMAP.md
  item that brings it; at its default it is accepted, because it then
  changes nothing;
- anything else is kept in ``Config.extra`` and otherwise unused, the
  JAX package's behaviour for unknown keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Config", "ALIASES", "NOT_IMPLEMENTED", "resolve_params"]

# alias -> canonical name (the subset of the JAX package's table whose
# canonical names the port knows)
ALIASES: Dict[str, str] = {
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "loss": "objective",
    "boosting_type": "boosting",
    "boost": "boosting",
    "test": "valid",
    "valid_data": "valid",
    "valid_data_file": "valid",
    "test_data": "valid",
    "test_data_file": "valid",
    "valid_filenames": "valid",
    "num_trees": "num_iterations",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_rounds": "num_iterations",
    "nrounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_iter": "num_iterations",
    "n_estimators": "num_iterations",
    "max_iter": "num_iterations",
    "shrinkage_rate": "learning_rate",
    "eta": "learning_rate",
    "num_leaf": "num_leaves",
    "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "max_leaf_nodes": "num_leaves",
    "tree": "tree_learner",
    "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads",
    "nthread": "num_threads",
    "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed",
    "random_state": "seed",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_samples_leaf": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction",
    "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction",
    "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "extra_tree": "extra_trees",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step",
    "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "l1_regularization": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "l2_regularization": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "mc": "monotone_constraints",
    "monotone_constraint": "monotone_constraints",
    "monotonic_cst": "monotone_constraints",
    "monotone_constraining_method": "monotone_constraints_method",
    "mc_method": "monotone_constraints_method",
    "monotone_splits_penalty": "monotone_penalty",
    "ms_penalty": "monotone_penalty",
    "mc_penalty": "monotone_penalty",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "feature_contrib": "feature_contri",
    "fc": "feature_contri",
    "fp": "feature_contri",
    "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "linear_trees": "linear_tree",
    "max_bins": "max_bin",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "is_enable_bundle": "enable_bundle",
    "bundle": "enable_bundle",
    "two_round_loading": "two_round",
    "use_two_round_loading": "two_round",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "num_classes": "num_class",
    "unbalance": "is_unbalance",
    "unbalanced_sets": "is_unbalance",
    "objective_seed": "seed",
    "metrics": "metric",
    "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "num_machine": "num_machines",
    "ndcg_eval_at": "eval_at",
    "ndcg_at": "eval_at",
    "map_eval_at": "eval_at",
    "map_at": "eval_at",
}

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
}

_Q1 = "ROADMAP.md Queue 1 item {}"
_TPU_KNOB = "a TPU layout knob of the JAX package with no counterpart " \
    "in the port"

# parameter -> (its JAX default, what brings it)
NOT_IMPLEMENTED: Dict[str, tuple] = {
    "linear_tree": (False, _Q1.format(16)),
    "histogram_pool_size": (-1.0, _Q1.format(16)),
    "grower": ("compact", _Q1.format(16)),
    "forcedbins_filename": ("", _Q1.format(18)),
    "two_round": (False, _Q1.format(18)),
    "ingest_chunk_rows": (0, _Q1.format(18)),
    "tree_learner": ("serial", _Q1.format(20)),
    "num_devices": (0, _Q1.format(20)),
    "num_machines": (1, _Q1.format(20)),
    "nonfinite_policy": ("raise", _Q1.format(21)),
    # the JAX package fits raw labels under reg_sqrt (it never calls
    # transform_label) while LightGBM fits transformed ones
    "reg_sqrt": (False, "ROADMAP.md Queue 3, reg_sqrt"),
    "hist_method": ("auto", _TPU_KNOB),
    "hist_precision": ("default", _TPU_KNOB),
    "hist_dtype": ("float32", _TPU_KNOB),
    "hist_comm": ("f32", _TPU_KNOB),
    "chunk_rows": (16384, _TPU_KNOB),
    "big_chunk_rows": (0, _TPU_KNOB),
    "shard_residency": ("auto", _TPU_KNOB),
    "split_search": ("gathered", _TPU_KNOB),
    "sharding_axis": ("data", _TPU_KNOB),
    "fused_scan_iters": ("auto", _TPU_KNOB),
}


def canonical_objective(name: str) -> str:
    key = str(name).strip().lower()
    if key in ("none", "null", "custom", "na"):
        raise NotImplementedError(
            f"objective={name!r} (a custom objective) is not in the port "
            f"yet ({_Q1.format(22)})")
    if key not in _OBJECTIVE_ALIASES:
        raise ValueError(f"Unknown objective: {name}")
    return _OBJECTIVE_ALIASES[key]


def resolve_params(params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Map every aliased key to its canonical name. Canonical keys win."""
    out: Dict[str, Any] = {}
    if not params:
        return out
    aliased: Dict[str, Any] = {}
    for k, v in params.items():
        canon = ALIASES.get(k, k)
        if canon == k:
            out[k] = v
        else:
            aliased.setdefault(canon, v)
    for k, v in aliased.items():
        out.setdefault(k, v)
    return out


def _parse_list(v: Any, typ) -> list:
    if v is None:
        return []
    if isinstance(v, str):
        v = v.replace(";", ",")
        return [typ(x) for x in v.split(",") if x.strip() != ""]
    if isinstance(v, (list, tuple)):
        return [typ(x) for x in v]
    return [typ(v)]


_TRUE = {"true", "1", "yes", "on", "+", "t", "y"}
_FALSE = {"false", "0", "no", "off", "-", "f", "n"}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise ValueError(f"Cannot parse boolean from {v!r}")


def _is_default(value: Any, default: Any) -> bool:
    """Whether a user value equals the JAX default (lists and strings
    compare after parsing, numbers numerically)."""
    if isinstance(default, list):
        return len(_parse_list(value, str)) == 0
    if isinstance(default, bool):
        try:
            return _parse_bool(value) == default
        except ValueError:
            return False
    if isinstance(default, (int, float)):
        try:
            return float(value) == float(default)
        except (TypeError, ValueError):
            return False
    if value is None:
        return default in ("", None)
    return str(value).strip().lower() == str(default)


@dataclass
class Config:
    """The implemented parameters (names and defaults as in the JAX
    package's ``Config``, except ``device_type``)."""

    objective: str = "regression"
    # gbdt | dart | rf ("goss" is gbdt + data_sample_strategy="goss",
    # "random_forest" is rf, as in the JAX package)
    boosting: str = "gbdt"
    data_sample_strategy: str = "bagging"  # bagging | goss
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    # "cuda" runs on the card and raises when there is none; "cpu" is
    # what the CPU tests pass
    device_type: str = "cuda"
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    # row and column sampling
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    # accepted and read by nothing, as in the JAX package
    bagging_by_query: bool = False
    extra_trees: bool = False
    extra_seed: int = 6
    # dart
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    # goss
    top_rate: float = 0.2
    other_rate: float = 0.1
    # evaluation during training
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    early_stopping_round: int = 0
    early_stopping_min_delta: float = 0.0
    first_metric_only: bool = False
    verbosity: int = 1
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    use_missing: bool = True
    zero_as_missing: bool = False
    enable_bundle: bool = True
    # categorical features: indices or names, or "" (pandas category
    # columns only); the search's knobs
    categorical_feature: Any = ""
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    # monotone constraints (basic, intermediate, advanced) and
    # leaf-output smoothing
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    path_smooth: float = 0.0
    # interaction constraints: a list of lists of feature indices or
    # names, or its string form ("[0,1],[2,3]" or "[[0,1],[2,3]]")
    interaction_constraints: Any = ""
    # LightGBM's forced-split JSON
    forcedsplits_filename: str = ""
    # cost-effective gradient boosting (any penalty, or a tradeoff below
    # 1, turns it on)
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    # accepted and read by nothing, as in the JAX package
    feature_contri: List[float] = field(default_factory=list)
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    # learning to rank (lambdarank, rank_xendcg)
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)
    lambdarank_position_bias_regularization: float = 0.0
    # huber / quantile, fair, poisson, tweedie (objectives and metrics)
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)
    # quantized-gradient training (LightGBM's GradientDiscretizer):
    # int8 gradients/hessians, exact int32 histograms
    use_quantized_grad: bool = False
    num_grad_quant_bins: int = 4
    quant_train_renew_leaf: bool = False
    stochastic_rounding: bool = True
    # seeds the stochastic rounding of quantized training (None: 0, as
    # in the JAX package); nothing else reads it yet
    seed: Optional[int] = None
    # accepted and without effect, as in the JAX package
    num_threads: int = 0
    deterministic: bool = False
    feature_pre_filter: bool = True
    is_enable_sparse: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)

    _BOUNDS = {
        "num_iterations": (0, None),
        "learning_rate": (0.0, None, "gt"),
        "num_leaves": (2, 131072),
        "min_data_in_leaf": (0, None),
        "min_sum_hessian_in_leaf": (0.0, None),
        "lambda_l1": (0.0, None),
        "lambda_l2": (0.0, None),
        "min_gain_to_split": (0.0, None),
        "bagging_fraction": (0.0, 1.0, "gt"),
        "pos_bagging_fraction": (0.0, 1.0, "gt"),
        "neg_bagging_fraction": (0.0, 1.0, "gt"),
        "feature_fraction": (0.0, 1.0, "gt"),
        "feature_fraction_bynode": (0.0, 1.0, "gt"),
        "drop_rate": (0.0, 1.0),
        "skip_drop": (0.0, 1.0),
        "top_rate": (0.0, 1.0),
        "other_rate": (0.0, 1.0),
        "metric_freq": (1, None),
        "max_bin": (2, None),
        "max_cat_to_onehot": (1, None),
        "max_cat_threshold": (1, None),
        "cat_l2": (0.0, None),
        "cat_smooth": (0.0, None),
        "monotone_penalty": (0.0, None),
        "path_smooth": (0.0, None),
        "min_data_in_bin": (1, None),
        "bin_construct_sample_cnt": (1, None),
        "sigmoid": (0.0, None, "gt"),
        "alpha": (0.0, None, "gt"),
        "fair_c": (0.0, None, "gt"),
        "poisson_max_delta_step": (0.0, None, "gt"),
        "tweedie_variance_power": (1.0, 2.0),
        "scale_pos_weight": (0.0, None, "gt"),
        "num_grad_quant_bins": (2, None),
        "lambdarank_truncation_level": (1, None),
        "num_class": (1, None),
        "multi_error_top_k": (1, None),
    }

    def __post_init__(self) -> None:
        self.objective = canonical_objective(self.objective)
        if self.boosting in ("gbrt",):
            self.boosting = "gbdt"
        if self.boosting == "goss":
            # legacy spelling: boosting=goss means gbdt + goss sampling
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        if self.boosting == "random_forest":
            self.boosting = "rf"
        if self.boosting not in ("gbdt", "dart", "rf"):
            raise ValueError(f"Unknown boosting type: {self.boosting}")
        if self.data_sample_strategy not in ("bagging", "goss"):
            raise ValueError(
                f"Unknown data_sample_strategy: {self.data_sample_strategy}")
        dev = str(self.device_type).strip().lower()
        self.device_type = "cuda" if dev == "gpu" else dev
        if self.device_type not in ("cuda", "cpu"):
            raise ValueError(
                f"device_type={self.device_type!r}: the port runs on "
                "'cuda' (the default) or 'cpu'")
        for name, spec in self._BOUNDS.items():
            lo, hi = spec[0], spec[1]
            strict = len(spec) > 2 and spec[2] == "gt"
            v = getattr(self, name)
            if lo is not None and (v <= lo if strict else v < lo):
                op = ">" if strict else ">="
                raise ValueError(f"{name} = {v} should be {op} {lo}")
            if hi is not None and v > hi:
                raise ValueError(f"{name} = {v} should be <= {hi}")
        if self.objective in ("multiclass", "multiclassova"):
            if self.num_class < 2:
                raise ValueError(
                    "num_class must be >= 2 for multiclass objectives")
        elif self.num_class != 1:
            raise ValueError(
                f"num_class must be 1 for objective {self.objective}")
        if self.boosting == "rf":
            if not (self.bagging_freq > 0
                    and 0.0 < self.bagging_fraction < 1.0):
                raise ValueError(
                    "Random forest needs bagging_freq > 0 and "
                    "0 < bagging_fraction < 1")
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            raise ValueError(
                "Cannot set is_unbalance and scale_pos_weight at the same "
                "time")
        if self.monotone_constraints_method not in (
                "basic", "intermediate", "advanced"):
            raise ValueError(
                f"Unknown monotone_constraints_method: "
                f"{self.monotone_constraints_method}")

    _LIST_INT = {"eval_at", "max_bin_by_feature", "monotone_constraints"}
    _LIST_FLOAT = {"feature_contri", "label_gain", "auc_mu_weights",
                   "cegb_penalty_feature_lazy",
                   "cegb_penalty_feature_coupled"}
    _LIST_STR = {"valid", "metric"}

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        raw = resolve_params(params)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        for k, v in raw.items():
            if k in NOT_IMPLEMENTED:
                default, where = NOT_IMPLEMENTED[k]
                if not _is_default(v, default):
                    raise NotImplementedError(
                        f"parameter {k}={v!r} is not in the port yet "
                        f"({where})")
                continue
            if k not in fields or k == "extra":
                extra[k] = v
                continue
            f = fields[k]
            try:
                if k in cls._LIST_INT:
                    kwargs[k] = _parse_list(v, int)
                elif k in cls._LIST_FLOAT:
                    kwargs[k] = _parse_list(v, float)
                elif k in cls._LIST_STR:
                    kwargs[k] = _parse_list(v, str)
                elif f.type in ("bool", bool):
                    kwargs[k] = _parse_bool(v)
                elif f.type in ("int", int):
                    kwargs[k] = int(v)
                elif f.type in ("float", float):
                    kwargs[k] = float(v)
                elif f.type in ("Optional[int]",):
                    kwargs[k] = None if v is None else int(v)
                elif k in ("categorical_feature",
                           "interaction_constraints"):
                    kwargs[k] = v
                else:
                    kwargs[k] = str(v)
            except (TypeError, ValueError) as exc:
                raise ValueError(
                    f"Bad value for parameter {k}: {v!r}") from exc
        cfg = cls(**kwargs)
        cfg.extra = extra
        return cfg

    def to_string(self) -> str:
        parts = []
        for f in dataclasses.fields(self):
            if f.name == "extra":
                continue
            v = getattr(self, f.name)
            if isinstance(v, list):
                v = ",".join(str(x) for x in v)
            parts.append(f"[{f.name}: {v}]")
        return "\n".join(parts)
