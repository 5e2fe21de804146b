"""``train`` and ``cv``: the training entry points of the port.

Counterpart of ``train`` and ``cv`` in ``lightgbm_tpu/engine.py``, for
one process or one rank of a world (``parallel/``):

- ``train`` runs ``num_boost_round`` iterations (or ``num_iterations``
  from the params) on top of an ``init_model``'s, scores the
  ``valid_sets`` after every tree (a valid set that is the train set
  itself evaluates the train score under its name), evaluates the
  metrics and ``feval`` every ``metric_freq`` iterations and at the
  last one, runs the callbacks before and after each iteration sorted
  by ``order`` (registration order breaks ties), adds
  ``early_stopping_round`` as a callback, and stops when a callback
  raises ``EarlyStopException`` or no tree can grow;
- crash recovery (``resilience/checkpoint.py``): ``resume_from=dir`` —
  or ``LIGHTGBM_TPU_CHECKPOINT=dir``, which also installs the checkpoint
  callback every ``LIGHTGBM_TPU_CHECKPOINT_EVERY`` iterations — restores
  the newest valid snapshot and trains on to the uninterrupted run's end
  iteration (``init_model``'s offset included); ``kill@N``
  (``LIGHTGBM_TPU_FAULT_INJECT``) kills the process at the start of
  iteration N;
- a world of ranks: ``collective_timeout_sec`` configures the collective
  watchdog, and every iteration starts with the ranks' step check
  (``spmd.verify_step_consistency``), so a rank that died or stalls at
  ``rank_kill@N`` / ``stall_rank@N`` is named by the watchdog's error
  before any rank enters a histogram reduction;
- telemetry: ``LIGHTGBM_TPU_TELEMETRY=path`` adds the ``telemetry``
  callback, which is attached before the first iteration and closed on
  exit; ``metrics_port`` (or ``LIGHTGBM_TPU_METRICS_PORT``, plus
  ``LIGHTGBM_TPU_RANK``) starts the ``/metrics`` endpoint;
  ``LIGHTGBM_TPU_TRACE_TO`` / ``LIGHTGBM_TPU_XPROF`` capture the loop with
  ``torch.profiler`` (``utils/timer.py`` ``EnvCapture``); evaluation is
  timed as ``engine/eval``. The non-finite guard resolves inside each
  iteration (``models/gbdt.py``), so nothing is left to drain at the
  end;
- ``cv`` trains one booster per fold (stratified and shuffled folds as
  the JAX package draws them, for the same seed), evaluates each on its
  held-out rows and reports the per-round means and standard
  deviations; it accepts ``init_model`` and reads it not, as the JAX
  package does.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from . import callback as callback_mod
from .basic import Booster, Dataset, LightGBMError
from .config import Config, resolve_params
from .log import log_info, log_warning, scoped_verbosity
from .ops.grow import _take_rows
from .resilience.checkpoint import (Checkpoint, checkpoint,
                                    load_latest_snapshot, restore_booster)
from .parallel import spmd
from .resilience import watchdog
from .resilience.faults import FaultPlan
from .utils.timer import EnvCapture, Timer, timed

__all__ = ["train", "cv", "CVBooster"]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          feval=None, init_model=None, keep_training_booster: bool = False,
          callbacks=None, fobj=None, resume_from=None) -> Booster:
    """``fobj(score, train_set) -> (grad, hess)``: a custom objective
    (``Booster.update(fobj=)`` every iteration); ``objective="none"``
    needs one. ``keep_training_booster`` is accepted and changes
    nothing, as in the JAX package (the returned booster can always
    train on).

    ``resume_from``: a checkpoint directory (``checkpoint`` callback):
    the newest valid snapshot is restored and training continues from
    its iteration toward ``num_boost_round`` total iterations, or
    ``init_iteration + num_boost_round`` when the snapshot's run
    continued an ``init_model`` (a directory without usable snapshots
    trains from scratch)."""
    params = resolve_params(params)
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    cfg = Config.from_params(params)
    with scoped_verbosity(cfg.verbosity):
        return _train_impl(params, cfg, train_set, num_boost_round,
                           valid_sets, valid_names, feval, init_model,
                           callbacks, fobj, resume_from)


def _setup_metrics_endpoint(cfg: Config) -> None:
    """Start the process's OpenMetrics ``/metrics`` endpoint when
    ``metrics_port`` is set; ``LIGHTGBM_TPU_METRICS_PORT`` overrides the
    parameter, and ``LIGHTGBM_TPU_RANK`` r binds port + r (the JAX
    package's precedence). Idempotent per process."""
    port = cfg.metrics_port
    env_port = os.environ.get("LIGHTGBM_TPU_METRICS_PORT")
    if env_port:
        try:
            port = int(env_port)
        except ValueError:
            pass
    if not port:
        return
    rank = 0
    rank_env = os.environ.get("LIGHTGBM_TPU_RANK")
    if rank_env:
        try:
            rank = int(rank_env)
        except ValueError:
            rank = 0
    from .obs.export import ensure_metrics_server
    ensure_metrics_server(port + rank)


def _setup_telemetry(callbacks: List[Callable], model) -> None:
    """Honour ``LIGHTGBM_TPU_TELEMETRY=<path>`` unless a telemetry
    callback is already present, then attach every recorder to the model
    before the first iteration."""
    telem_path = os.environ.get("LIGHTGBM_TPU_TELEMETRY")
    if telem_path and not any(isinstance(cb, callback_mod._Telemetry)
                              for cb in callbacks):
        callbacks.append(callback_mod.telemetry(telem_path))
    for cb in callbacks:
        if isinstance(cb, callback_mod._Telemetry):
            cb.attach(model)


def _finish_callbacks(callbacks: List[Callable]) -> None:
    for cb in callbacks:
        if isinstance(cb, callback_mod._Telemetry):
            cb.finish()


def _checkpoint_every() -> int:
    """``LIGHTGBM_TPU_CHECKPOINT_EVERY`` (default 1)."""
    raw = os.environ.get("LIGHTGBM_TPU_CHECKPOINT_EVERY", "1")
    try:
        return max(1, int(raw or 1))
    except ValueError:
        log_warning(f"LIGHTGBM_TPU_CHECKPOINT_EVERY={raw!r} is not an "
                    "integer; checkpointing every iteration")
        return 1


def _sorted_callbacks(callbacks) -> Tuple[list, list]:
    """(before-iteration, after-iteration) callbacks, each sorted by
    ``order`` with registration order breaking ties."""
    before = [cb for cb in callbacks
              if getattr(cb, "before_iteration", False)]
    after = [cb for cb in callbacks
             if not getattr(cb, "before_iteration", False)]
    return (sorted(before, key=lambda c: getattr(c, "order", 0)),
            sorted(after, key=lambda c: getattr(c, "order", 0)))


def _with_early_stopping(callbacks, cfg: Config, min_delta=0.0) -> list:
    """The user's callbacks plus ``early_stopping_round``'s (``cv`` does
    not pass ``early_stopping_min_delta``, as in the JAX package)."""
    callbacks = list(callbacks) if callbacks else []
    if cfg.early_stopping_round > 0:
        callbacks.append(callback_mod.early_stopping(
            cfg.early_stopping_round,
            first_metric_only=cfg.first_metric_only,
            verbose=cfg.verbosity >= 1, min_delta=min_delta))
    return callbacks


def _train_impl(params, cfg: Config, train_set, num_boost_round: int,
                valid_sets, valid_names, feval, init_model,
                callbacks, fobj=None, resume_from=None) -> Booster:
    if cfg.objective == "custom" and fobj is None:
        raise LightGBMError(
            "objective=none requires a custom objective function (fobj)")
    if not isinstance(train_set, Dataset):
        raise TypeError("train() only accepts Dataset object(s)")
    _setup_metrics_endpoint(cfg)
    booster = Booster(params=params, train_set=train_set)
    # crash recovery: an explicit resume_from wins; LIGHTGBM_TPU_CHECKPOINT
    # both resumes from and checkpoints into one directory
    ckpt_env = os.environ.get("LIGHTGBM_TPU_CHECKPOINT")
    resume_dir = resume_from or ckpt_env
    snap = load_latest_snapshot(resume_dir) if resume_dir else None
    resumed_iteration = 0
    if snap is not None:
        if init_model is not None:
            log_warning("resume_from checkpoint takes precedence over "
                        "init_model")
        resumed_iteration = restore_booster(booster, snap)
        log_info(f"Resumed from checkpoint {snap['path']} at iteration "
                 f"{resumed_iteration}")
    elif init_model is not None:
        if isinstance(init_model, (str, Path)):
            base = Booster(model_file=str(init_model),
                           params={"device_type": cfg.device_type})
        elif isinstance(init_model, Booster):
            base = init_model
        else:
            raise TypeError(
                "init_model should be a str, pathlib.Path or Booster")
        booster._preload(base)
    valid_sets = valid_sets or []
    is_valid_contain_train = False
    for i, vd in enumerate(valid_sets):
        if valid_names is not None and i < len(valid_names):
            name = valid_names[i]
        else:
            name = f"valid_{i}"
        if vd is train_set:
            is_valid_contain_train = True
            booster._train_data_name = name
            continue
        booster.add_valid(vd, name)

    callbacks = _with_early_stopping(callbacks, cfg,
                                     cfg.early_stopping_min_delta)
    if ckpt_env and not any(isinstance(cb, Checkpoint)
                            for cb in callbacks):
        callbacks.append(checkpoint(ckpt_env,
                                    every_n_iters=_checkpoint_every()))
    _setup_telemetry(callbacks, booster)
    cbs_before, cbs_after = _sorted_callbacks(callbacks)
    fault_plan = FaultPlan.from_env()
    # the deadline of this run's host collectives (the variable
    # LIGHTGBM_TPU_COLLECTIVE_TIMEOUT still wins)
    watchdog.configure(cfg.collective_timeout_sec)
    in_world = booster._engine.comm is not None
    # continued training adds num_boost_round iterations on top of the
    # adopted ones; a resume trains on toward the same end; the loop
    # index is the engine's absolute iteration
    init_iteration = booster._engine.init_iteration
    begin_iteration = resumed_iteration if snap is not None \
        else init_iteration
    end_iteration = max(begin_iteration, init_iteration + num_boost_round)
    evaluation_result_list: List[Tuple] = []
    env_capture = EnvCapture.from_env()
    try:
        for i in range(begin_iteration, end_iteration):
            fault_plan.maybe_kill(i)
            fault_plan.maybe_distributed_fault(i)
            if in_world:
                # every rank agrees on the step before the iteration's
                # first collective: a dead or stalled peer surfaces here
                # as the watchdog's error naming it, not as a hang inside
                # a histogram reduction
                spmd.verify_step_consistency(i, len(booster._models))
            if env_capture is not None:
                env_capture.before_iteration(i)
            for cb in cbs_before:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=begin_iteration,
                    end_iteration=end_iteration,
                    evaluation_result_list=None))
            finished = booster.update(fobj=fobj)
            evaluation_result_list = []
            if ((i + 1) % max(1, cfg.metric_freq) == 0
                    or i == end_iteration - 1) \
                    and (valid_sets or is_valid_contain_train):
                with timed("engine/eval"):
                    if is_valid_contain_train:
                        evaluation_result_list.extend(
                            booster.eval_train(feval))
                    evaluation_result_list.extend(
                        booster.eval_valid(feval))
            try:
                for cb in cbs_after:
                    cb(callback_mod.CallbackEnv(
                        model=booster, params=params, iteration=i,
                        begin_iteration=begin_iteration,
                        end_iteration=end_iteration,
                        evaluation_result_list=evaluation_result_list))
            except callback_mod.EarlyStopException as es:
                booster.best_iteration = es.best_iteration + 1
                evaluation_result_list = es.best_score
                break
            if env_capture is not None:
                env_capture.after_iteration(i)
            if finished:
                log_info("Stopped training because there are no more "
                         "leaves that meet the split requirements")
                break
    finally:
        if env_capture is not None:
            env_capture.close()
        _finish_callbacks(callbacks)
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    for item in (evaluation_result_list or []):
        booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    if Timer.enabled():
        Timer.log_summary()
    return booster


class CVBooster:
    """The per-fold boosters of ``cv``; a method call is made on each
    and gives the list of their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name: str):
        def handler_function(*args: Any, **kwargs: Any) -> List[Any]:
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, seed: int,
                  stratified: bool, shuffle: bool):
    """``[(train_idx, test_idx)] * nfold``, drawn as the JAX package
    draws them: whole queries per fold when the data has groups;
    label-sorted striping (rows shuffled within each label first) when
    stratified; else contiguous slices of a (shuffled) order."""
    full_data.construct()
    num_data = full_data.num_data()
    label = np.asarray(full_data.get_label())
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group = full_data.get_group()
            flatted_group = np.zeros(num_data, dtype=np.int64)
            if group is not None:
                flatted_group = np.repeat(range(len(group)), group)
            folds = folds.split(X=np.empty(num_data), y=label,
                                groups=flatted_group)
        return list(folds)
    rng = np.random.RandomState(seed)
    if full_data.get_group() is not None:
        group = np.asarray(full_data.get_group())
        nq = len(group)
        q_idx = np.arange(nq)
        if shuffle:
            rng.shuffle(q_idx)
        q_fold = np.arange(nq) % nfold
        row_fold = np.zeros(num_data, np.int64)
        starts = np.concatenate([[0], np.cumsum(group)])
        for qi, f in zip(q_idx, q_fold):
            row_fold[starts[qi]:starts[qi + 1]] = f
        return [(np.where(row_fold != f)[0], np.where(row_fold == f)[0])
                for f in range(nfold)]
    if stratified:
        order = np.argsort(label, kind="stable")
        if shuffle:
            sorted_labels = label[order]
            block_starts = np.concatenate(
                [[0], np.where(np.diff(sorted_labels) != 0)[0] + 1,
                 [num_data]])
            for a, b in zip(block_starts[:-1], block_starts[1:]):
                perm = rng.permutation(b - a)
                order[a:b] = order[a:b][perm]
        fold_of = np.empty(num_data, np.int64)
        fold_of[order] = np.arange(num_data) % nfold
        return [(np.where(fold_of != f)[0], np.where(fold_of == f)[0])
                for f in range(nfold)]
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    return [(np.concatenate([idx[: (f * num_data) // nfold],
                             idx[((f + 1) * num_data) // nfold:]]),
             idx[(f * num_data) // nfold: ((f + 1) * num_data) // nfold])
            for f in range(nfold)]


def _agg_cv_result(raw_results: List[List[Tuple]]) -> List[Tuple]:
    """``("cv_agg", "<data> <metric>", mean, higher_better, stdv)`` per
    (data, metric) over the folds."""
    cvmap: Dict[str, List[float]] = {}
    metric_type: Dict[str, bool] = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}"
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True,
       metrics=None, feval=None, init_model=None,
       fpreproc=None, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """K-fold cross validation: ``{"<data> <metric>-mean": [...],
    "<data> <metric>-stdv": [...]}`` per round (cut at the best round
    when early stopping ends it), plus ``"cvbooster"`` on request."""
    if not isinstance(train_set, Dataset):
        raise TypeError("cv() only accepts Dataset object(s)")
    # init_model is accepted and read by nothing, as in the JAX package
    # (every fold trains from scratch; ROADMAP.md Queue 3)
    params = resolve_params(params)
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    if metrics is not None:
        params["metric"] = metrics
    cfg = Config.from_params(params)
    with scoped_verbosity(cfg.verbosity):
        return _cv_impl(params, cfg, train_set, num_boost_round, folds,
                        nfold, stratified, shuffle, feval, fpreproc, seed,
                        callbacks, eval_train_metric, return_cvbooster)


def _cv_impl(params, cfg: Config, train_set: Dataset, num_boost_round: int,
             folds, nfold, stratified, shuffle, feval, fpreproc, seed,
             callbacks, eval_train_metric, return_cvbooster):
    # only binary labels are stratified
    stratified = stratified and cfg.objective == "binary"
    # the construct runs where the cv params say (Booster.__init__
    # merges its params into the Dataset's the same way); the bins stay
    # the Dataset's own, as in the JAX package's cv
    if "device_type" in params:
        train_set.params = {**resolve_params(train_set.params),
                            "device_type": params["device_type"]}
    train_set.construct()
    folds = _make_n_folds(train_set, folds, nfold, seed, stratified,
                          shuffle)
    cvbooster = CVBooster()
    results: Dict[str, List[float]] = {}
    boosters = []
    for train_idx, test_idx in folds:
        tr = _subset_dataset(train_set, train_idx)
        te = _subset_dataset(train_set, test_idx)
        if fpreproc is not None:
            tr, te, params = fpreproc(tr, te, params.copy())
        booster = Booster(params=params, train_set=tr)
        booster.add_valid(te, "valid")
        if eval_train_metric:
            booster._train_data_name = "train"
        boosters.append(booster)
        cvbooster._append(booster)

    callbacks = _with_early_stopping(callbacks, cfg)
    _setup_telemetry(callbacks, cvbooster)
    cbs_before, cbs_after = _sorted_callbacks(callbacks)
    try:
        for i in range(num_boost_round):
            for cb in cbs_before:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            for booster in boosters:
                booster.update()
            raw = []
            with timed("engine/eval"):
                for booster in boosters:
                    one = []
                    if eval_train_metric:
                        one.extend(booster.eval_train(feval))
                    one.extend(booster.eval_valid(feval))
                    raw.append(one)
            res = _agg_cv_result(raw)
            for (_, key, mean, _, std) in res:
                results.setdefault(f"{key}-mean", []).append(mean)
                results.setdefault(f"{key}-stdv", []).append(std)
            try:
                for cb in cbs_after:
                    cb(callback_mod.CallbackEnv(
                        model=cvbooster, params=params, iteration=i,
                        begin_iteration=0, end_iteration=num_boost_round,
                        evaluation_result_list=res))
            except callback_mod.EarlyStopException as es:
                cvbooster.best_iteration = es.best_iteration + 1
                for bst in boosters:
                    bst.best_iteration = cvbooster.best_iteration
                for k in results:
                    results[k] = results[k][: cvbooster.best_iteration]
                break
    finally:
        _finish_callbacks(callbacks)
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)


def _subset_dataset(full: Dataset, idx: np.ndarray) -> Dataset:
    """The rows ``idx`` of a constructed Dataset, sharing its mappers
    (Dataset::CopySubrow); whole queries are kept whole."""
    full.construct()
    sub = Dataset.__new__(Dataset)
    sub.__dict__.update(full.__dict__)
    sub.reference = full
    idx = np.asarray(idx, np.int64)
    sub._bins = _take_rows(full._bins, torch.as_tensor(
        idx, device=full._bins.device))
    sub._raw = None if full._raw is None else full._raw[torch.as_tensor(
        idx, device=full._raw.device)]
    sub._bundle_cache = {}
    sub._n = len(idx)
    sub.used_indices = idx
    sub.label = np.asarray(full.get_label())[idx]
    w = full.get_weight()
    sub.weight = None if w is None else np.asarray(w)[idx]
    init = full.get_init_score()
    sub.init_score = None if init is None else np.asarray(init)[idx]
    pos = full.get_position()
    sub.position = None if pos is None else np.asarray(pos)[idx]
    qb = full.query_boundaries()
    if qb is not None:
        row_query = np.searchsorted(qb, idx, side="right") - 1
        _, counts = np.unique(row_query, return_counts=True)
        sub._query_boundaries = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64)
    if len(idx) == 0:
        raise LightGBMError("a cv fold holds no rows")
    return sub
