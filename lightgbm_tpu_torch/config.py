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
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "loss": "objective",
    "boosting_type": "boosting",
    "boost": "boosting",
    "train": "data",
    "train_data": "data",
    "train_data_file": "data",
    "data_filename": "data",
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
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "group_id": "group_column",
    "query_column": "group_column",
    "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "is_save_binary": "save_binary",
    "is_save_binary_file": "save_binary",
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib",
    "contrib": "predict_contrib",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "predict_name": "output_result",
    "prediction_name": "output_result",
    "pred_name": "output_result",
    "name_pred": "output_result",
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
    "local_port": "local_listen_port",
    "port": "local_listen_port",
    "machine_list_filename": "machine_list_file",
    "machine_list": "machine_list_file",
    "mlist": "machine_list_file",
    "workers": "machines",
    "nodes": "machines",
    "topk": "top_k",
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
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
}

_TPU_KNOB = "a TPU layout knob of the JAX package with no counterpart " \
    "in the port"

# parameter -> (its JAX default, what brings it)
NOT_IMPLEMENTED: Dict[str, tuple] = {
    # the JAX package fits raw labels under reg_sqrt (it never calls
    # transform_label) while LightGBM fits transformed ones
    "reg_sqrt": (False, "ROADMAP.md Queue 3, reg_sqrt"),
    "hist_method": ("auto", _TPU_KNOB),
    "hist_precision": ("default", _TPU_KNOB),
    "hist_dtype": ("float32", _TPU_KNOB),
    "chunk_rows": (16384, _TPU_KNOB),
    "big_chunk_rows": (0, _TPU_KNOB),
    "sharding_axis": ("data", _TPU_KNOB),
    "fused_scan_iters": ("auto", _TPU_KNOB),
}


def canonical_objective(name: str) -> str:
    """The canonical objective name; ``none``, ``null``, ``custom`` and
    ``na`` are ``"custom"``: gradients from ``fobj``."""
    key = str(name).strip().lower()
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

    # the command line's task: train | predict | convert_model | refit |
    # save_binary (cli.py)
    task: str = "train"
    # "custom" (objective none): gradients from fobj, raw-score output
    objective: str = "regression"
    # gbdt | dart | rf ("goss" is gbdt + data_sample_strategy="goss",
    # "random_forest" is rf, as in the JAX package)
    boosting: str = "gbdt"
    data_sample_strategy: str = "bagging"  # bagging | goss
    # the command line's training (or predict / refit) file and its
    # valid files
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    # "cuda" runs on the card and raises when there is none; "cpu" is
    # what the CPU tests pass
    device_type: str = "cuda"
    max_depth: int = -1
    # tree growth: compact (leaf-wise, rows grouped by leaf), level
    # (depth-wise, a whole frontier per step) or masked (full-row
    # masked histograms, the JAX package's correctness oracle)
    grower: str = "compact"
    # the leaf histogram cache in MB (-1: every leaf's; the compact
    # grower keeps that many slots and recomputes a missed one)
    histogram_pool_size: float = -1.0
    # linear leaves: a ridge model per leaf on its branch's numerical
    # features, fitted after growth from the second iteration on
    linear_tree: bool = False
    linear_lambda: float = 0.0
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
    # the non-finite guard on gradients, hessians and fitted leaf values
    # (models/gbdt.py): "raise" fails with a LightGBMError, "skip_tree"
    # keeps the iteration's trees as constants and trains on, "clamp"
    # rewrites NaN -> 0 and +-Inf -> +-1e30 and keeps the trees
    nonfinite_policy: str = "raise"
    # the OpenMetrics /metrics endpoint's port (obs/export.py; 0: off;
    # LIGHTGBM_TPU_METRICS_PORT overrides; rank r binds port + r)
    metrics_port: int = 0
    # the serving daemon (serve/daemon.py; its flags take these as
    # defaults): the micro-batching window in ms (0: dispatch at once)
    serve_batch_window_ms: float = 2.0
    # the largest device batch and the smallest row bucket (powers of
    # two): larger requests are split, smaller ones pad up to a bucket
    serve_max_batch_rows: int = 16384
    serve_min_bucket_rows: int = 16
    # pending-row budget: a submit beyond it is rejected (backpressure)
    serve_queue_rows: int = 131072
    # seconds between {"event": "serve"} lines, and between polls of
    # the hot-swap watch target
    serve_stats_interval_sec: float = 10.0
    serve_watch_interval_sec: float = 1.0
    # load shedding: above serve_shed_queue_rows pending rows (0: off;
    # below serve_queue_rows to ever fire) the batcher sheds its oldest
    # requests with a typed {"shed": true} reply; a request that waited
    # longer than serve_shed_p99_ms (0: off) is shed at dequeue
    serve_shed_queue_rows: int = 0
    serve_shed_p99_ms: float = 0.0
    # graceful-shutdown deadline: on SIGTERM or `shutdown` the daemon
    # drains accepted requests for up to this many seconds
    serve_shutdown_grace_sec: float = 15.0
    # the replica fleet's autoscaling floor and ceiling (0: a fixed
    # fleet), read by the fleet supervisor (resilience/autoscale.py)
    serve_min_replicas: int = 1
    serve_max_replicas: int = 0
    # scale up when the fleet's QPS exceeds autoscale_up_qps per active
    # replica or a replica's p99 exceeds autoscale_up_p99_ms (0: that
    # signal is off); scale down when the QPS would stay under
    # autoscale_down_qps per replica with one replica fewer (strictly
    # below autoscale_up_qps: the hysteresis band); the cooldowns are
    # the seconds after any scaling action before the next one
    autoscale_up_qps: float = 0.0
    autoscale_down_qps: float = 0.0
    autoscale_up_p99_ms: float = 0.0
    autoscale_up_cooldown_sec: float = 5.0
    autoscale_down_cooldown_sec: float = 15.0
    # seconds between the supervisors' scrapes into {"event": "fleet"}
    # records (0: off), and the load generator's trace sample rate
    # (every Nth request carries a trace; 0: off)
    metrics_scrape_interval_sec: float = 5.0
    trace_sample_every: int = 16
    # one publication's retries and the base of their jittered
    # exponential backoff; retention (prune beyond the newest N valid
    # manifests, 0: keep all); the canary's rows in each manifest (0:
    # no gate) and its absolute tolerance; the publish target ("": the
    # pipeline's publish/ directory, or a mem:// spec)
    publish_retries: int = 5
    publish_backoff_sec: float = 0.25
    publish_keep: int = 0
    canary_rows: int = 8
    canary_tol: float = 1e-3
    publish_store: str = ""
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
    # distributed training (parallel/): serial | data | feature | voting
    # | auto (comms.choose_parallel_mode); a world of one rank trains as
    # serial
    tree_learner: str = "serial"
    top_k: int = 20  # voting parallel
    # the network (parallel/distributed.py): num_machines > 1 makes the
    # CLI join the world of ``machines`` / ``machine_list_file``
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""
    machines: str = ""
    # deadline (seconds) of every host collective of a world
    # (resilience/watchdog.py); 0 disables; the
    # LIGHTGBM_TPU_COLLECTIVE_TIMEOUT variable overrides
    collective_timeout_sec: float = 300.0
    # one rank is one process on one device: 0 or the world's size
    num_devices: int = 0
    # the histogram allreduce's wire format (parallel/comms.py): f32,
    # int16 / int8 block-quantized with error feedback, or auto
    hist_comm: str = "f32"
    # gathered: every rank searches the allreduced histogram; sharded:
    # a reduce-scatter, each rank searches its feature chunk and the
    # best split is combined (tree_learner=data only)
    split_search: str = "gathered"
    # host: keep the Dataset's host copy of its bins; device: free it
    # once the bins are on the device (parallel/placement.py); auto:
    # device in a world on CUDA, host otherwise
    shard_residency: str = "auto"
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
    # text files (basic.py _load_text_file): a header line, the label
    # column (an index or "name:<column>")
    header: bool = False
    label_column: str = ""
    # streaming ingest (data/): two_round parses a text file in two
    # passes (a sample, then chunks binned on the device);
    # ingest_chunk_rows > 0 streams text and parquet paths through the
    # chunked two-pass pipeline, and is the chunk size of every chunk
    # source
    two_round: bool = False
    ingest_chunk_rows: int = 0
    # accepted and read by nothing, as in the JAX package
    forcedbins_filename: str = ""
    # accepted and read by nothing, as in the JAX package
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False
    parser_config_file: str = ""
    # the command line's model and result files (cli.py)
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    snapshot_freq: int = -1
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"
    refit_decay_rate: float = 0.9
    # task=predict
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)

    _BOUNDS = {
        "num_iterations": (0, None),
        "learning_rate": (0.0, None, "gt"),
        "num_leaves": (2, 131072),
        "min_data_in_leaf": (0, None),
        "min_sum_hessian_in_leaf": (0.0, None),
        "lambda_l1": (0.0, None),
        "lambda_l2": (0.0, None),
        "linear_lambda": (0.0, None),
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
        "ingest_chunk_rows": (0, None),
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
        "top_k": (1, None),
        "num_machines": (1, None),
        "collective_timeout_sec": (0.0, None),
        "num_devices": (0, None),
        "refit_decay_rate": (0.0, 1.0),
        "metrics_port": (0, 65535),
        "serve_batch_window_ms": (0.0, None),
        "serve_max_batch_rows": (1, None),
        "serve_min_bucket_rows": (1, None),
        "serve_queue_rows": (1, None),
        "serve_stats_interval_sec": (0.0, None, "gt"),
        "serve_watch_interval_sec": (0.0, None, "gt"),
        "serve_shed_queue_rows": (0, None),
        "serve_shed_p99_ms": (0.0, None),
        "serve_shutdown_grace_sec": (0.0, None),
        "serve_min_replicas": (1, None),
        "serve_max_replicas": (0, None),
        "autoscale_up_qps": (0.0, None),
        "autoscale_down_qps": (0.0, None),
        "autoscale_up_p99_ms": (0.0, None),
        "autoscale_up_cooldown_sec": (0.0, None, "gt"),
        "autoscale_down_cooldown_sec": (0.0, None, "gt"),
        "publish_retries": (0, None),
        "publish_backoff_sec": (0.0, None),
        "publish_keep": (0, None),
        "canary_rows": (0, None),
        "canary_tol": (0.0, None, "gt"),
        "metrics_scrape_interval_sec": (0.0, None),
        "trace_sample_every": (0, None),
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
        if self.tree_learner not in ("serial", "feature", "data",
                                     "voting", "auto"):
            raise ValueError(f"Unknown tree_learner: {self.tree_learner}")
        if self.hist_comm not in ("f32", "int16", "int8", "auto"):
            raise ValueError(f"Unknown hist_comm: {self.hist_comm} "
                             "(expected f32, int16, int8 or auto)")
        if self.shard_residency not in ("auto", "host", "device"):
            raise ValueError(
                f"Unknown shard_residency: {self.shard_residency} "
                "(expected auto, host or device)")
        if self.split_search not in ("gathered", "sharded"):
            raise ValueError(
                f"Unknown split_search: {self.split_search} "
                "(expected gathered or sharded)")
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
        if self.nonfinite_policy not in ("raise", "skip_tree", "clamp"):
            raise ValueError(
                f"Unknown nonfinite_policy: {self.nonfinite_policy} "
                "(expected raise, skip_tree or clamp)")
        if self.objective in ("multiclass", "multiclassova"):
            if self.num_class < 2:
                raise ValueError(
                    "num_class must be >= 2 for multiclass objectives")
        elif self.objective != "custom" and self.num_class != 1:
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
        if self.grower not in ("compact", "masked", "level"):
            raise ValueError(f"Unknown grower: {self.grower}")
        for name in ("serve_max_batch_rows", "serve_min_bucket_rows"):
            v = getattr(self, name)
            if v < 1 or (v & (v - 1)) != 0:
                raise ValueError(f"{name} must be a power of two >= 1, "
                                 f"got {v}")
        if self.serve_min_bucket_rows > self.serve_max_batch_rows:
            raise ValueError(
                "serve_min_bucket_rows must be <= serve_max_batch_rows "
                f"({self.serve_min_bucket_rows} > "
                f"{self.serve_max_batch_rows})")
        if self.serve_max_replicas \
                and self.serve_min_replicas > self.serve_max_replicas:
            raise ValueError(
                "serve_min_replicas must be <= serve_max_replicas "
                f"({self.serve_min_replicas} > "
                f"{self.serve_max_replicas})")
        if self.autoscale_up_qps > 0 and self.autoscale_down_qps > 0 \
                and self.autoscale_down_qps >= self.autoscale_up_qps:
            raise ValueError(
                "autoscale_down_qps must stay strictly below "
                "autoscale_up_qps — that gap is the hysteresis band "
                "that stops the fleet flapping "
                f"({self.autoscale_down_qps} >= "
                f"{self.autoscale_up_qps})")
        if self.serve_shed_queue_rows \
                and self.serve_shed_queue_rows >= self.serve_queue_rows:
            raise ValueError(
                "serve_shed_queue_rows (soft shed threshold) must stay "
                "below serve_queue_rows (hard admission wall) to ever "
                f"fire ({self.serve_shed_queue_rows} >= "
                f"{self.serve_queue_rows})")

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
