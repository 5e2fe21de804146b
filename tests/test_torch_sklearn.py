"""The port's scikit-learn wrappers (lightgbm_tpu_torch/sklearn.py) held
against the JAX package's on the CPU: the same trees, predictions and
fitted attributes for ``LGBMClassifier`` (binary and multiclass, string
labels, ``class_weight``, ``eval_set`` with early stopping),
``LGBMRegressor`` with a callable objective and metric, and
``LGBMRanker``; ``get_params``/``set_params``/``clone``; and the same
results with scikit-learn made unimportable. XLA's float root totals are
handed to the grower (``tests/test_torch_objectives.py`` says why).
"""

import importlib.util
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import grow

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}
KW = {"n_estimators": 3, "num_leaves": 7, "min_child_samples": 10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled when it ends (the
    process-wide jit signature budgets of later tests)."""
    yield
    jax.clear_caches()


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


@pytest.fixture(autouse=True)
def jax_root_totals(monkeypatch):
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)


def _data(n=600, F=5, seed=0, classes=2):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    s = X @ rs.randn(F) + 0.3 * rs.randn(n)
    if classes == 2:
        return X, (s > 0) * 1.0
    return X, np.digitize(s, np.quantile(s, [0.3, 0.7]))


def _same_trees(ja, tb):
    assert len(ja._models) == len(tb._models)
    for a, b in zip(ja._models, tb._models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count",
                     "internal_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


def _same(jm, tm, X, proba=True):
    _same_trees(jm.booster_, tm.booster_)
    if proba:
        np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    else:
        np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=1e-5,
                                   atol=1e-6)
    if proba:
        np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                                   rtol=1e-5, atol=1e-6)
    assert tm.best_iteration_ == jm.best_iteration_
    assert tm.n_features_in_ == jm.n_features_in_
    np.testing.assert_array_equal(tm.feature_importances_,
                                  jm.feature_importances_)
    assert tm.evals_result_.keys() == jm.evals_result_.keys()
    for name, metrics in jm.evals_result_.items():
        for m, vals in metrics.items():
            np.testing.assert_allclose(tm.evals_result_[name][m], vals,
                                       rtol=1e-5)


def test_classifier_with_eval_set_and_early_stopping_matches_jax():
    X, y = _data()
    Xv, yv = _data(seed=1)
    fit = dict(eval_set=[(Xv, yv)], eval_metric="auc")
    jm = jlgb.LGBMClassifier(class_weight={0: 1.0, 1: 2.0}, **KW, **JAX)
    tm = tlgb.LGBMClassifier(class_weight={0: 1.0, 1: 2.0}, **KW, **CPU)
    jm.fit(X, y, callbacks=[jlgb.early_stopping(2, verbose=False)], **fit)
    tm.fit(X, y, callbacks=[tlgb.early_stopping(2, verbose=False)], **fit)
    _same(jm, tm, Xv)
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert "auc" in tm.evals_result_["valid_0"]


def test_multiclass_classifier_with_string_labels_matches_jax():
    X, y = _data(classes=3, seed=2)
    names = np.array(["low", "mid", "high"])[y]
    jm = jlgb.LGBMClassifier(class_weight="balanced", **KW, **JAX)
    tm = tlgb.LGBMClassifier(class_weight="balanced", **KW, **CPU)
    jm.fit(X, names)
    tm.fit(X, names)
    _same(jm, tm, X)
    assert list(tm.classes_) == ["high", "low", "mid"]
    assert tm.n_classes_ == 3 and set(tm.predict(X)) <= set(names)


def _l2(y_true, y_pred):
    return y_pred - y_true, np.ones_like(y_pred)


def _mae(y_true, y_pred):
    return "mae", float(np.mean(np.abs(y_true - y_pred))), False


def test_regressor_with_callable_objective_and_metric_matches_jax():
    X, _ = _data(seed=3)
    y = X @ np.arange(5) / 5.0
    fit = dict(eval_set=[(X[:200], y[:200])], eval_metric=_mae)
    jm = jlgb.LGBMRegressor(objective=_l2, **KW, **JAX).fit(X, y, **fit)
    tm = tlgb.LGBMRegressor(objective=_l2, **KW, **CPU).fit(X, y, **fit)
    _same(jm, tm, X, proba=False)
    assert "mae" in tm.evals_result_["valid_0"]
    # the built-in objective too
    jr = jlgb.LGBMRegressor(**KW, **JAX).fit(X, y)
    tr = tlgb.LGBMRegressor(**KW, **CPU).fit(X, y)
    _same(jr, tr, X, proba=False)


def test_ranker_matches_jax():
    X, y = _data(classes=3, seed=4)
    group = np.full(20, 30)
    fit = dict(group=group, eval_set=[(X[:300], y[:300])],
               eval_group=[group[:10]], eval_at=(1, 3))
    jm = jlgb.LGBMRanker(**KW, **JAX).fit(X, y, **fit)
    tm = tlgb.LGBMRanker(**KW, **CPU).fit(X, y, **fit)
    _same(jm, tm, X, proba=False)
    with pytest.raises(ValueError, match="group"):
        tlgb.LGBMRanker(**CPU).fit(X, y)


def test_params_and_clone_like_jax():
    from sklearn.base import clone
    jm = jlgb.LGBMClassifier(num_leaves=9, reg_alpha=0.5, extra_knob=3)
    tm = tlgb.LGBMClassifier(num_leaves=9, reg_alpha=0.5, extra_knob=3)
    assert tm.get_params() == jm.get_params()
    tm.set_params(num_leaves=11, other=1)
    jm.set_params(num_leaves=11, other=1)
    assert tm.get_params() == jm.get_params()
    c = clone(tm)
    assert c.get_params() == tm.get_params() and c is not tm
    with pytest.raises(tlgb.LightGBMError, match="not fitted"):
        tlgb.LGBMRegressor().predict(np.zeros((2, 2)))


def _port_sklearn_without_sklearn(monkeypatch):
    """A fresh copy of the port's sklearn module imported while
    ``import sklearn`` fails."""
    for name in [m for m in sys.modules
                 if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    path = tlgb.__path__[0] + "/sklearn.py"
    spec = importlib.util.spec_from_file_location(
        "lightgbm_tpu_torch._sklearn_without_sklearn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wrappers_work_without_sklearn(monkeypatch):
    X, y = _data(classes=3, seed=5)
    names = np.array(["a", "b", "c"])[y]
    jm = jlgb.LGBMClassifier(class_weight="balanced", **KW, **JAX)
    jm.fit(X, names, eval_set=[(X[:200], names[:200])])
    bare = _port_sklearn_without_sklearn(monkeypatch)
    assert not bare._SKLEARN
    tm = bare.LGBMClassifier(class_weight="balanced", **KW, **CPU)
    tm.fit(X, names, eval_set=[(X[:200], names[:200])])
    _same(jm, tm, X)
    assert tm.get_params()["class_weight"] == "balanced"
    assert tm.get_params()["device_type"] == "cpu"
    r = bare.LGBMRegressor(**KW, **CPU).fit(X, y * 1.0)
    assert r.predict(X).shape == (len(y),)
