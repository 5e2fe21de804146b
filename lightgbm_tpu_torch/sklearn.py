"""scikit-learn estimator wrappers of the port.

A copy of ``lightgbm_tpu/sklearn.py`` (``LGBMModel``, ``LGBMRegressor``,
``LGBMClassifier``, ``LGBMRanker``, the adapters of callable objectives
and metrics) over the port's ``train``: the same constructor params,
``fit(eval_set=...)``, ``predict``/``predict_proba`` and fitted
attributes. Pass ``device_type="cpu"`` as a keyword to run on the CPU
(the default is the GPU). scikit-learn is optional: without it the
estimators derive from ``object``, ``get_params`` lists the constructor
params itself, labels are encoded with ``np.unique`` (what
``LabelEncoder`` does) and ``class_weight`` ("balanced" or a dict) is
turned into row weights by :func:`_class_sample_weight`, which gives
``sklearn.utils.class_weight.compute_sample_weight``'s weights — so
the port's wrappers behave the same with and without it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .callback import record_evaluation
from .engine import train as engine_train

__all__ = ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]

try:
    from sklearn.base import BaseEstimator as _SKBase
    from sklearn.base import ClassifierMixin as _SKClassifier
    from sklearn.base import RegressorMixin as _SKRegressor
    _SKLEARN = True
except ImportError:
    _SKBase = object

    class _SKClassifier:  # type: ignore
        pass

    class _SKRegressor:  # type: ignore
        pass
    _SKLEARN = False


def _class_sample_weight(class_weight, y: np.ndarray) -> np.ndarray:
    """Per-row weights of ``class_weight``: ``"balanced"`` gives class c
    ``n / (n_classes * count(c))``, a dict its value (1 for a class it
    does not name) — ``compute_sample_weight``'s rule for these two
    forms."""
    classes, enc = np.unique(y, return_inverse=True)
    if class_weight == "balanced":
        per_class = len(y) / (len(classes) * np.bincount(enc))
    elif isinstance(class_weight, dict):
        per_class = np.asarray([float(class_weight.get(c, 1.0))
                                for c in classes.tolist()])
    else:
        raise ValueError(
            "class_weight should be 'balanced', a dict or None")
    return per_class[enc].astype(np.float64)


class _ObjectiveFunctionWrapper:
    """A sklearn-style objective ``func(y_true, y_pred[, weight]) ->
    (grad, hess)`` as ``train``'s ``fobj``."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, train_set):
        labels = train_set.get_label()
        try:
            grad, hess = self.func(labels, preds)
        except TypeError:
            grad, hess = self.func(labels, preds,
                                   train_set.get_weight())
        return grad, hess


class _EvalFunctionWrapper:
    """A sklearn-style metric ``func(y_true, y_pred[, weight]) -> (name,
    value, is_higher_better)`` as ``train``'s ``feval``."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, eval_set):
        labels = eval_set.get_label()
        try:
            return self.func(labels, preds)
        except TypeError:
            return self.func(labels, preds, eval_set.get_weight())


class LGBMModel(_SKBase):
    """The base estimator (LightGBM's ``LGBMModel``)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0,
                 random_state: Optional[int] = None,
                 n_jobs: Optional[int] = None,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._best_score: Dict = {}
        self._objective = objective
        self._class_weight = class_weight
        self.fitted_ = False

    # -- sklearn plumbing --------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep) if _SKLEARN else {}
        if not _SKLEARN:
            for k in ("boosting_type", "num_leaves", "max_depth",
                      "learning_rate", "n_estimators", "subsample_for_bin",
                      "objective", "class_weight", "min_split_gain",
                      "min_child_weight", "min_child_samples", "subsample",
                      "subsample_freq", "colsample_bytree", "reg_alpha",
                      "reg_lambda", "random_state", "n_jobs",
                      "importance_type"):
                params[k] = getattr(self, k)
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, "_other_params") and key not in (
                    "boosting_type", "num_leaves", "max_depth",
                    "learning_rate", "n_estimators", "subsample_for_bin",
                    "objective", "class_weight", "min_split_gain",
                    "min_child_weight", "min_child_samples", "subsample",
                    "subsample_freq", "colsample_bytree", "reg_alpha",
                    "reg_lambda", "random_state", "n_jobs",
                    "importance_type"):
                self._other_params[key] = value
        return self

    def _engine_params(self) -> Dict[str, Any]:
        """The sklearn-style names as ``train``'s params."""
        params = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbose": -1,
        }
        if self.random_state is not None:
            params["seed"] = int(self.random_state)
        if isinstance(self._objective, str):
            params["objective"] = self._objective
        params.update(self._other_params)
        return params

    # -- core fit ----------------------------------------------------------
    def _fit(self, X, y, sample_weight=None, init_score=None, group=None,
             eval_set=None, eval_names=None, eval_sample_weight=None,
             eval_class_weight=None, eval_init_score=None, eval_group=None,
             eval_metric=None, feature_name="auto",
             categorical_feature="auto", callbacks=None) -> "LGBMModel":
        params = self._engine_params()

        fobj = None
        if callable(self._objective):
            fobj = _ObjectiveFunctionWrapper(self._objective)
            params["objective"] = "none"

        feval = None
        if callable(eval_metric):
            feval = _EvalFunctionWrapper(eval_metric)
        elif eval_metric:
            params["metric"] = eval_metric

        train_set = Dataset(X, label=y, weight=sample_weight,
                            group=group, init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)

        valid_sets: List[Dataset] = []
        names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):

                def at(lst, j):
                    return None if lst is None else lst[j]
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    valid_sets.append(train_set.create_valid(
                        vx, label=vy, weight=at(eval_sample_weight, i),
                        group=at(eval_group, i),
                        init_score=at(eval_init_score, i)))
                names.append(
                    eval_names[i] if eval_names and i < len(eval_names)
                    else f"valid_{i}")

        callbacks = list(callbacks) if callbacks else []
        self._evals_result = {}
        callbacks.append(record_evaluation(self._evals_result))

        self._Booster = engine_train(
            params, train_set,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=names,
            feval=feval, fobj=fobj, callbacks=callbacks)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self.n_features_ = self._Booster.num_feature()
        self.n_features_in_ = self.n_features_
        self.fitted_ = True
        return self

    fit = _fit

    def _check_fitted(self):
        if not self.fitted_:
            raise LightGBMError(
                "Estimator not fitted, call fit before exploiting the "
                "model.")

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, validate_features: bool = False,
                **kwargs):
        self._check_fitted()
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, validate_features=validate_features)

    # -- fitted attributes -------------------------------------------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        self._check_fitted()
        return self._best_score

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(
            importance_type=self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()

    @property
    def n_estimators_(self) -> int:
        self._check_fitted()
        return self._best_iteration if self._best_iteration > 0 \
            else self._Booster.current_iteration()

    @property
    def n_iter_(self) -> int:
        return self.n_estimators_


class LGBMRegressor(_SKRegressor, LGBMModel):
    """The regressor (LightGBM's ``LGBMRegressor``)."""

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_init_score=None,
            eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMRegressor":
        if self._objective is None:
            self._objective = "regression"
        return self._fit(X, y, sample_weight=sample_weight,
                         init_score=init_score, eval_set=eval_set,
                         eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_init_score=eval_init_score,
                         eval_metric=eval_metric, feature_name=feature_name,
                         categorical_feature=categorical_feature,
                         callbacks=callbacks)


class LGBMClassifier(_SKClassifier, LGBMModel):
    """The classifier (LightGBM's ``LGBMClassifier``)."""

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_class_weight=None,
            eval_init_score=None, eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMClassifier":
        y = np.asarray(y).ravel()
        self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)

        if callable(self._objective):
            pass  # custom objective keeps user semantics
        elif self._n_classes > 2:
            if self._objective is None or \
                    self._objective in ("binary",):
                self._objective = "multiclass"
            self._other_params.setdefault("num_class", self._n_classes)
        elif self._objective is None:
            self._objective = "binary"

        # class_weight -> per-row weights
        if self.class_weight is not None:
            cw = _class_sample_weight(self.class_weight, y)
            sample_weight = cw if sample_weight is None \
                else np.asarray(sample_weight) * cw

        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            fixed = []
            for vx, vy in eval_set:
                vy = np.searchsorted(self._classes, np.asarray(vy).ravel())
                fixed.append((vx, vy))
            eval_set = fixed

        return self._fit(X, y_enc, sample_weight=sample_weight,
                         init_score=init_score, eval_set=eval_set,
                         eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_class_weight=eval_class_weight,
                         eval_init_score=eval_init_score,
                         eval_metric=eval_metric, feature_name=feature_name,
                         categorical_feature=categorical_feature,
                         callbacks=callbacks)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, validate_features: bool = False,
                **kwargs):
        result = self.predict_proba(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, validate_features=validate_features)
        if callable(self._objective) or raw_score or pred_leaf \
                or pred_contrib:
            return result
        if result.ndim == 1:  # binary
            idx = (result > 0.5).astype(int)
        else:
            idx = np.argmax(result, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      validate_features: bool = False, **kwargs):
        self._check_fitted()
        result = self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, validate_features=validate_features)
        if callable(self._objective) or raw_score or pred_leaf \
                or pred_contrib:
            return result
        if self._n_classes == 2 and result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return self._n_classes


class LGBMRanker(LGBMModel):
    """The ranker (LightGBM's ``LGBMRanker``)."""

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError(
                "Eval_group cannot be None when eval_set is not None")
        if self._objective is None:
            self._objective = "lambdarank"
        self._other_params.setdefault(
            "eval_at", list(eval_at))
        return self._fit(X, y, sample_weight=sample_weight,
                         init_score=init_score, group=group,
                         eval_set=eval_set, eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_init_score=eval_init_score,
                         eval_group=eval_group, eval_metric=eval_metric,
                         feature_name=feature_name,
                         categorical_feature=categorical_feature,
                         callbacks=callbacks)
