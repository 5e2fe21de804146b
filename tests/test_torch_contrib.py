"""``pred_contrib`` (TreeSHAP, lightgbm_tpu_torch/shap.py) and
``pred_early_stop`` (lightgbm_tpu_torch/prediction.py) of the port held
against the JAX package on the CPU.

Contributions are compared on models that both packages load from each
other's model text (the port's trained model read by the JAX package and
the JAX package's read by the port): the same float64 walk gives the
same numbers to 1e-9. Early-stopped scores are float32 sums in a
different order (the JAX package adds each chunk's trees together before
adding them to the score, the port adds them one after the other), so
they agree to rtol 1e-5; a margin no row passes gives the port's full
walk bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.basic import LightGBMError

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled when it ends, so that
    they do not count against the process-wide jit signature budgets
    that later tests on the same worker check."""
    yield
    jax.clear_caches()


def _data(n=2000, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    X[rs.rand(n) < 0.1, 1] = np.nan
    X[rs.rand(n) < 0.05, 3] = np.nan
    return X, X[:, 0] - 0.7 * np.nan_to_num(X[:, 1]) + 0.5 * X[:, 2] \
        + 0.3 * rs.randn(n)


def _binary():
    X, s = _data()
    return X, (s > 0) * 1.0, {"objective": "binary"}, {}


def _multiclass():
    X, s = _data(seed=1)
    return X, np.digitize(s, [-0.7, 0.7]) * 1.0, \
        {"objective": "multiclass", "num_class": 3}, {}


def _categorical():
    X, s = _data(seed=2)
    rs = np.random.RandomState(2)
    c = rs.randint(0, 12, len(s))
    X = np.column_stack([X, c.astype(float)])
    X[rs.rand(len(s)) < 0.05, 5] = np.nan
    return X, (s + rs.randn(12)[c] > 0) * 1.0, {"objective": "binary"}, \
        {"categorical_feature": [5]}


def _regression_nan():
    X, s = _data(seed=3)
    return X, s, {"objective": "regression"}, {}


MODELS = {"binary": _binary, "multiclass": _multiclass,
          "categorical": _categorical, "regression_nan": _regression_nan}
BASE = {"num_leaves": 15, "learning_rate": 0.3, "verbosity": -1,
        "min_data_in_leaf": 10}


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    """The port's model and the JAX package's, each also loaded by the
    other package from its text."""
    X, y, obj, kw = MODELS[request.param]()
    params = {**BASE, **obj}
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, params=CPU, **kw), 6)
    ja = jlgb.train({**params, **JAX}, jlgb.Dataset(X, label=y, **kw), 6)
    return dict(
        X=X, K=obj.get("num_class", 1), port=tb,
        port_in_jax=jlgb.Booster(model_str=tb.model_to_string()),
        jax=ja, jax_in_port=tlgb.Booster(params=CPU,
                                         model_str=ja.model_to_string()))


def test_contributions_equal_jax_on_each_others_models(models):
    X = models["X"][:300]
    for mine, ref in ((models["port"], models["port_in_jax"]),
                      (models["jax_in_port"], models["jax"])):
        got = mine.predict(X, pred_contrib=True)
        want = ref.predict(X, pred_contrib=True)
        F = X.shape[1]
        assert got.shape == (len(X), (F + 1) * models["K"])
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_contributions_sum_to_the_raw_prediction(models):
    X = models["X"]
    K, F = models["K"], X.shape[1]
    for bst in (models["port"], models["jax_in_port"]):
        contrib = bst.predict(X, pred_contrib=True).reshape(len(X), K,
                                                            F + 1)
        raw = bst.predict(X, raw_score=True).reshape(len(X), K)
        np.testing.assert_allclose(contrib.sum(axis=2), raw, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("freq,margin", [(1, 0.5), (2, 1.5), (3, 4.0),
                                         (10, 2.0)])
@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_early_stop_equals_jax(kind, freq, margin):
    X, y, obj, _ = MODELS[kind]()
    params = {**BASE, **obj, "learning_rate": 0.5}
    ja = jlgb.train({**params, **JAX}, jlgb.Dataset(X, label=y), 8)
    tb = tlgb.Booster(params=CPU, model_str=ja.model_to_string())
    kw = dict(pred_early_stop=True, pred_early_stop_freq=freq,
              pred_early_stop_margin=margin)
    for raw in (True, False):
        got = tb.predict(X, raw_score=raw, **kw)
        want = ja.predict(X, raw_score=raw, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    full = tb.predict(X, raw_score=True)
    stopped = tb.predict(X, raw_score=True, **kw)
    # a chunk that holds every tree freezes rows only after them all
    assert np.allclose(stopped, full, rtol=1e-6) == (freq >= 8)
    np.testing.assert_array_equal(
        tb.predict(X, raw_score=True, pred_early_stop=True,
                   pred_early_stop_margin=1e30), full)


def test_early_stop_is_off_for_random_forests_and_regression():
    X, y, _, _ = _binary()
    rf = tlgb.train({**BASE, **CPU, "objective": "binary", "boosting": "rf",
                     "bagging_fraction": 0.7, "bagging_freq": 1},
                    tlgb.Dataset(X, label=y, params=CPU), 4)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=0.0)
    np.testing.assert_array_equal(rf.predict(X, **kw), rf.predict(X))
    ja_rf = jlgb.Booster(model_str=rf.model_to_string())
    np.testing.assert_allclose(rf.predict(X, **kw), ja_rf.predict(X, **kw),
                               rtol=1e-6)
    X, s, _, _ = _regression_nan()
    reg = tlgb.train({**BASE, **CPU}, tlgb.Dataset(X, label=s, params=CPU),
                     4)
    np.testing.assert_array_equal(reg.predict(X, **kw), reg.predict(X))


def test_linear_trees_stay_refused():
    X, s, _, _ = _regression_nan()
    X = np.nan_to_num(X)
    ja = jlgb.train({**BASE, **JAX, "linear_tree": True},
                    jlgb.Dataset(X, label=s), 2)
    tb = tlgb.Booster(params=CPU, model_str=ja.model_to_string())
    with pytest.raises(LightGBMError, match="linear"):
        tb.predict(X[:10], pred_contrib=True)
