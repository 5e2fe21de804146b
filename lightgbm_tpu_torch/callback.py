"""Training callbacks of the port.

A copy of ``lightgbm_tpu/callback.py``: the ``CallbackEnv`` protocol,
before/after-iteration ordering by ``order``, ``EarlyStopException``,
and ``log_evaluation`` (the same text), ``record_evaluation``,
``reset_parameter`` (``learning_rate`` reaches the next trees'
shrinkage) and ``early_stopping`` (``first_metric_only``, ``min_delta``;
the train set's own slots never stop training). Evaluation tuples are
``(dataset_name, metric_name, value, higher_is_better)``, with ``,
stdv`` appended for cv aggregates. ``telemetry`` streams one JSONL event
per iteration (``obs/recorder.py``) and ``checkpoint`` writes atomic
snapshots to resume from (``resilience/checkpoint.py``).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from .log import log_info

__all__ = ["EarlyStopException", "CallbackEnv", "log_evaluation",
           "record_evaluation", "reset_parameter", "early_stopping",
           "telemetry", "checkpoint"]


class EarlyStopException(Exception):
    """Raised by the early-stopping callback to unwind the train loop."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _render(entry: Sequence, show_stdv: bool = True) -> str:
    """One evaluation tuple -> 'data's metric: value[ + stdv]'."""
    text = f"{entry[0]}'s {entry[1]}: {entry[2]:g}"
    if show_stdv and len(entry) > 4:
        text += f" + {entry[4]:g}"
    return text


def _render_all(entries: Sequence[Sequence], show_stdv: bool = True) -> str:
    return "\t".join(_render(e, show_stdv) for e in entries)


@dataclass(eq=False)
class _LogEvaluation:
    """Print the evaluation line every ``period`` iterations."""
    period: int = 1
    show_stdv: bool = True
    order: int = 10
    before_iteration: bool = False

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        if (env.iteration + 1) % self.period == 0:
            text = _render_all(env.evaluation_result_list, self.show_stdv)
            log_info(f"[{env.iteration + 1}]\t{text}")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    return _LogEvaluation(period=period, show_stdv=show_stdv)


@dataclass(eq=False)
class _RecordEvaluation:
    """Append every metric value into a user-provided nested dict."""
    eval_result: Dict
    order: int = 20
    before_iteration: bool = False

    def __post_init__(self):
        if not isinstance(self.eval_result, dict):
            raise TypeError("eval_result should be a dictionary")

    def __call__(self, env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            self.eval_result.clear()
        for entry in env.evaluation_result_list:
            data_slot = self.eval_result.setdefault(
                entry[0], collections.OrderedDict())
            data_slot.setdefault(entry[1], []).append(entry[2])
            if len(entry) > 4:
                data_slot.setdefault(f"{entry[1]}-stdv", []).append(entry[4])


def record_evaluation(eval_result: Dict) -> Callable:
    return _RecordEvaluation(eval_result)


@dataclass(eq=False)
class _ResetParameter:
    """Per-iteration parameter schedule: list lookup or callable."""
    schedule: Dict[str, Any]
    order: int = 10
    before_iteration: bool = True

    def __call__(self, env: CallbackEnv) -> None:
        step = env.iteration - env.begin_iteration
        changed: Dict[str, Any] = {}
        for name, spec in self.schedule.items():
            if isinstance(spec, list):
                if len(spec) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {name!r} has to equal to "
                        "'num_boost_round'.")
                value = spec[step]
            elif callable(spec):
                value = spec(step)
            else:
                raise ValueError(
                    "Only list and callable values are supported as a "
                    "mapping from boosting round index to new parameter "
                    "value.")
            if value != env.params.get(name, None):
                changed[name] = value
        if changed:
            if "learning_rate" in changed and env.model is not None:
                # the shrinkage of the next trees
                env.model._engine._shrinkage = changed["learning_rate"]
            env.params.update(changed)


def reset_parameter(**kwargs) -> Callable:
    return _ResetParameter(kwargs)


@dataclass(eq=False)
class _MetricTracker:
    """Best-so-far state for one (dataset, metric) evaluation slot."""
    higher_is_better: bool
    min_delta: float
    best_value: float = 0.0
    best_iteration: int = 0
    best_entries: Optional[List] = None

    def __post_init__(self):
        self.best_value = float("-inf") if self.higher_is_better \
            else float("inf")

    def improved(self, value: float) -> bool:
        if self.higher_is_better:
            return value > self.best_value + self.min_delta
        return value < self.best_value - self.min_delta


@dataclass(eq=False)
class _EarlyStopping:
    """Stop when no tracked slot improves for ``stopping_rounds`` rounds.

    Train-set slots (the Booster's own train data, and cv train-fold
    aggregates) update their trackers but never trigger a stop — only
    held-out data counts, matching the reference's gating.
    """
    stopping_rounds: int
    first_metric_only: bool = False
    verbose: bool = True
    min_delta: Union[float, List[float]] = 0.0
    order: int = 30
    before_iteration: bool = False
    enabled: bool = True
    trackers: List[_MetricTracker] = field(default_factory=list)
    _primary_metric: str = ""

    def __post_init__(self):
        if self.stopping_rounds <= 0:
            raise ValueError("stopping_rounds should be greater than zero.")

    def _deltas_per_slot(self, entries: Sequence) -> List[float]:
        metric_count = len({e[1] for e in entries})
        dataset_count = len(entries) // max(metric_count, 1)
        if isinstance(self.min_delta, list):
            if len(self.min_delta) != metric_count:
                raise ValueError(
                    "Must provide a single value for min_delta or as many "
                    "as metrics.")
            if self.first_metric_only and self.verbose:
                log_info(f"Using only {self.min_delta[0]} as early "
                         "stopping min_delta.")
            return self.min_delta * dataset_count
        if self.min_delta < 0:
            raise ValueError("Early stopping min_delta must be "
                             "non-negative.")
        return [self.min_delta] * (dataset_count * metric_count)

    def _start(self, env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        deltas = self._deltas_per_slot(env.evaluation_result_list)
        self.trackers = [
            _MetricTracker(higher_is_better=bool(entry[3]), min_delta=d)
            for entry, d in zip(env.evaluation_result_list, deltas)]
        self._primary_metric = \
            env.evaluation_result_list[0][1].split(" ")[-1]

    def _is_train_slot(self, env: CallbackEnv, entry: Sequence) -> bool:
        metric_tail = entry[1].split(" ")
        if entry[0] == "cv_agg" and metric_tail[0] == "train":
            return True
        if env.model is not None and entry[0] == env.model._train_data_name:
            return True
        return False

    def _stop(self, tracker: _MetricTracker, reason: str) -> None:
        if self.verbose:
            log_info(f"{reason}, best iteration is:\n"
                     f"[{tracker.best_iteration + 1}]\t"
                     f"{_render_all(tracker.best_entries)}")
            if self.first_metric_only:
                log_info(f"Evaluated only: {self._primary_metric}")
        raise EarlyStopException(tracker.best_iteration,
                                 tracker.best_entries)

    def __call__(self, env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            self._start(env)
        if not self.enabled:
            return
        last_round = env.iteration == env.end_iteration - 1
        for tracker, entry in zip(self.trackers,
                                  env.evaluation_result_list):
            if tracker.best_entries is None \
                    or tracker.improved(entry[2]):
                tracker.best_value = entry[2]
                tracker.best_iteration = env.iteration
                tracker.best_entries = list(env.evaluation_result_list)
            if self.first_metric_only \
                    and entry[1].split(" ")[-1] != self._primary_metric:
                continue
            if self._is_train_slot(env, entry):
                continue
            if env.iteration - tracker.best_iteration \
                    >= self.stopping_rounds:
                self._stop(tracker, "Early stopping")
            if last_round:
                self._stop(tracker, "Did not meet early stopping")


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True,
                   min_delta: Union[float, List[float]] = 0.0) -> Callable:
    return _EarlyStopping(stopping_rounds=stopping_rounds,
                          first_metric_only=first_metric_only,
                          verbose=verbose, min_delta=min_delta)


@dataclass(eq=False)
class _Telemetry:
    """Stream one JSONL telemetry event per iteration (obs/recorder.py).

    Runs after evaluation/logging (order 40) so the event carries the
    iteration's eval results. The train loop calls ``attach`` before the
    first iteration and ``finish`` on exit (including the early-stop
    unwind and a raise).
    """
    recorder: Any
    order: int = 40
    before_iteration: bool = False

    def attach(self, model) -> None:
        self.recorder.attach(model)

    def finish(self) -> None:
        self.recorder.close()

    def __call__(self, env: CallbackEnv) -> None:
        if env.model is not None:
            self.recorder.attach(env.model)
        self.recorder.record_iteration(env.iteration,
                                       env.evaluation_result_list)


def telemetry(path: str, registry=None) -> Callable:
    """Record per-iteration run telemetry to ``path`` (JSONL).

    Equivalent to setting ``LIGHTGBM_TPU_TELEMETRY=<path>``; summarize
    the output with ``python -m lightgbm_tpu_torch stats <path>``.
    """
    from .obs import TelemetryRecorder
    return _Telemetry(TelemetryRecorder(path, registry=registry))


def checkpoint(directory: str, every_n_iters: int = 1,
               keep: int = 3) -> Callable:
    """Atomic periodic training snapshots into ``directory``, to resume
    from with ``train(..., resume_from=directory)``
    (resilience/checkpoint.py). Equivalent to setting
    ``LIGHTGBM_TPU_CHECKPOINT=<directory>``; list snapshots with
    ``python -m lightgbm_tpu_torch checkpoints <directory>``."""
    from .resilience.checkpoint import checkpoint as _checkpoint
    return _checkpoint(directory, every_n_iters=every_n_iters, keep=keep)
