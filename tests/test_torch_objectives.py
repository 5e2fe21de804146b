"""The remaining objectives in the port (lightgbm_tpu_torch: objectives.py,
ops/renew.py, the renewal in models/gbdt.py, the output transforms in
prediction.py) held against the JAX package on the CPU.

The same numpy inputs go through both packages. Gradients, hessians and
output transforms agree to float32 tolerance, init scores exactly,
renewed leaf values exactly (both take the same float32 sums in the
same order), trees exactly in structure and to rtol=1e-4, atol=1e-5 in
leaf values, and model text loads in the other package with the same
predictions. Bagging's draws are handed to the port from ``jax.random``
as ``tests/test_torch_sampling.py`` does, and so are the float root
totals (``ops/grow.py`` ``root_totals``): XLA's float32 sum has an order
torch does not reproduce, and with these objectives' small hessians a
child whose hessian sum is its parent's less a nearly equal sum carries
the last bit of the root total into its output (ROADMAP.md Queue 3;
``test_root_totals_differ_from_xla_only_in_the_last_bits``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.models.tree import Tree as JaxTree
from lightgbm_tpu.objectives import _weighted_percentile_np as jax_pct
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu.ops.renew import renew_leaf_values as jax_renew
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models import gbdt
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.objectives import _weighted_percentile_np as pct
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops.renew import renew_leaf_values

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}
NEW = ("regression_l1", "huber", "fair", "poisson", "quantile", "mape",
       "gamma", "tweedie", "cross_entropy", "cross_entropy_lambda")
RENEW = ("regression_l1", "quantile", "mape")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the test workers share the machine's cores, and
    these tensors are small."""
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


def _jax_uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape,
                                                        jnp.float32)))


_PORT_ROOT_TOTALS = grow.root_totals


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


@pytest.fixture(autouse=True)
def jax_root_totals(monkeypatch):
    """The grower's float root totals summed by XLA, as the JAX grower
    sums them (``jnp.sum`` of the weighted gradients and hessians)."""
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)


@pytest.fixture
def jax_bagging(monkeypatch):
    """The port's bagging draw replaced by the JAX package's (its default
    bagging_seed)."""
    def bag(gen, it, n):
        return _jax_uniform(jax.random.fold_in(jax.random.PRNGKey(3), it),
                            (n,))
    monkeypatch.setattr(gbdt, "bagging_uniform", bag)


def _label(objective, signal, rs):
    """A label in each objective's domain."""
    n = signal.shape[0]
    if objective in ("poisson",):
        return rs.poisson(np.exp(signal / 3)).astype(np.float64)
    if objective == "gamma":
        return rs.gamma(2.0, np.exp(signal / 4))
    if objective == "tweedie":
        return np.where(rs.rand(n) < 0.3, 0.0,
                        rs.gamma(1.5, np.exp(signal / 4)))
    if objective.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-(signal + 0.5 * rs.randn(n))))
    if objective == "mape":
        return 5.0 + signal + rs.standard_t(3, n)
    return signal + rs.standard_t(2, n)


def _data(objective, n=3000, F=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    X[rs.rand(n, F) < 0.05] = np.nan
    signal = 2.0 * np.nan_to_num(X[:, 0]) + np.sin(np.nan_to_num(X[:, 1])) \
        + 0.5 * np.nan_to_num(X[:, 2])
    return X, _label(objective, signal, rs), rs.rand(n) + 0.5


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


def _train_both(params, X, y, rounds, weight=None):
    ja = jlgb.train({**params, **JAX}, jlgb.Dataset(X, label=y,
                                                    weight=weight), rounds)
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, weight=weight, params=CPU),
                    rounds)
    return ja, tb


_PAIRS = {}


def _pair(objective):
    """Both packages trained on one objective (weighted rows, 3 rounds),
    shared by the tree and model-text tests."""
    if objective not in _PAIRS:
        X, y, w = _data(objective)
        p = {"objective": objective, "num_leaves": 15, "verbosity": -1,
             "min_data_in_leaf": 10}
        _PAIRS[objective] = (X,) + _train_both(p, X, y, 3, weight=w)
    return _PAIRS[objective]


# ---- config ---------------------------------------------------------------

def test_objective_aliases_resolve_like_jax():
    for alias in ("l1", "mae", "mean_absolute_error", "regression_l1",
                  "huber", "fair", "poisson", "quantile", "mape",
                  "mean_absolute_percentage_error", "gamma", "tweedie",
                  "xentropy", "cross_entropy", "xentlambda",
                  "cross_entropy_lambda"):
        p = {"objective": alias}
        assert Config.from_params(p).objective == \
            JaxConfig.from_params(p).objective
    with pytest.raises(ValueError, match="Unknown objective"):
        Config.from_params({"objective": "no_such_objective"})
    cfg = Config.from_params({"objective": "poisson"})
    assert cfg.poisson_max_delta_step == JaxConfig().poisson_max_delta_step
    with pytest.raises(ValueError, match="poisson_max_delta_step"):
        Config.from_params({"poisson_max_delta_step": 0.0})


# ---- gradients, init scores, transforms ----------------------------------

@pytest.mark.parametrize("objective", NEW)
@pytest.mark.parametrize("weighted", [False, True])
def test_grad_hess_init_and_transform_match_jax(objective, weighted):
    rs = np.random.RandomState(1)
    n = 1000
    score = (0.5 * rs.randn(n)).astype(np.float32)
    label = _label(objective, rs.randn(n), rs).astype(np.float32)
    w = (rs.rand(n) + 0.5).astype(np.float32) if weighted else None
    params = {"objective": objective, "alpha": 0.7, "fair_c": 0.5,
              "tweedie_variance_power": 1.3}
    jo = jax_objective(JaxConfig.from_params(params))
    to = create_objective(Config.from_params(params))
    assert (to.need_renew, to.renew_alpha) == (jo.need_renew,
                                               jo.renew_alpha)
    jg, jh = jo.grad_hess(jnp.asarray(score), jnp.asarray(label),
                          None if w is None else jnp.asarray(w))
    tg, th = to.grad_hess(torch.from_numpy(score), torch.from_numpy(label),
                          None if w is None else torch.from_numpy(w))
    assert tg.dtype == th.dtype == torch.float32
    # float32: exp and log1p may differ in the last bit between the two
    # libraries, and a gradient like exp(score) - label cancels, so the
    # absolute tolerance is an ulp of the terms (labels up to ~30)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=4e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=4e-6)
    np.testing.assert_array_equal(to.boost_from_score(label, w),
                                  jo.boost_from_score(label, w))
    np.testing.assert_allclose(
        to.convert_output(torch.from_numpy(score)).numpy(),
        np.asarray(jo.convert_output(jnp.asarray(score))), rtol=1e-6,
        atol=1e-7)
    jw = jo.renew_weight(jnp.asarray(label),
                         None if w is None else jnp.asarray(w))
    tw = to.renew_weight(torch.from_numpy(label),
                         None if w is None else torch.from_numpy(w))
    assert (jw is None) == (tw is None)
    if tw is not None:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_percentile_is_the_jax_one(weighted):
    rs = np.random.RandomState(4)
    v = np.round(rs.randn(501), 1)
    w = rs.rand(501) if weighted else None
    for alpha in (0.1, 0.5, 0.9):
        assert pct(v, w, alpha) == jax_pct(v, w, alpha)
    assert pct(v[:0], None, 0.5) == 0.0


# ---- renewal --------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("weights", ["unit", "fractional"])
def test_renew_leaf_values_matches_jax(alpha, weights):
    """Out-of-bag rows (weight 0), an empty leaf and a leaf whose rows
    are all out of bag keep their fallback; ties among residuals are
    common (rounded residuals)."""
    rs = np.random.RandomState(6)
    n, L = 4000, 9
    row_leaf = rs.randint(0, L - 1, n).astype(np.int32)   # leaf 8 empty
    resid = np.round(rs.randn(n), 2).astype(np.float32)
    w = np.ones(n, np.float32) if weights == "unit" \
        else (rs.rand(n) * 1.7 + 0.05).astype(np.float32)
    w[rs.rand(n) < 0.3] = 0.0
    w[row_leaf == 3] = 0.0
    fallback = rs.randn(L).astype(np.float32)
    want = np.asarray(jax_renew(jnp.asarray(row_leaf), jnp.asarray(resid),
                                jnp.asarray(w), L, alpha,
                                jnp.asarray(fallback)))
    got = renew_leaf_values(torch.from_numpy(row_leaf),
                            torch.from_numpy(resid), torch.from_numpy(w), L,
                            alpha, torch.from_numpy(fallback)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[8] == fallback[8] and got[3] == fallback[3]


# ---- end to end -----------------------------------------------------------

@pytest.mark.parametrize("objective", NEW)
def test_trees_match_jax(objective):
    X, ja, tb = _pair(objective)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("objective", NEW)
def test_model_text_loads_across_packages(objective, tmp_path):
    X, ja, tb = _pair(objective)
    tb.save_model(tmp_path / "port.txt")
    ja.save_model(str(tmp_path / "jax.txt"))
    assert f"objective={objective}" in (tmp_path / "port.txt").read_text()
    j_from_t = jlgb.Booster(model_file=str(tmp_path / "port.txt"))
    t_from_j = tlgb.Booster(model_file=str(tmp_path / "jax.txt"),
                            params=CPU)
    np.testing.assert_allclose(j_from_t.predict(X), tb.predict(X),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_from_j.predict(X), ja.predict(X),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_from_j.predict(X, raw_score=True),
                               ja.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("objective", NEW)
def test_interop_carries_the_model_both_ways(objective):
    """The JAX model handed to the port as plain fields (interop.py)
    predicts the same, output transform included; the port's, handed
    back, builds JAX trees that write the same text."""
    X, ja, tb = _pair(objective)
    fields = dict(
        trees=[{f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
               for t in ja._models],
        num_class=ja._num_class, objective=ja._objective_str,
        feature_names=ja._feature_names, feature_infos=ja._feature_infos)
    carried = interop.booster_from_fields(fields, params=CPU)
    np.testing.assert_allclose(carried.predict(X), ja.predict(X),
                               rtol=1e-6, atol=1e-6)
    back = interop.booster_fields(tb)
    assert back["objective"] == ja._objective_str == objective
    for i, (t, d) in enumerate(zip(tb._models, back["trees"])):
        assert JaxTree(**d).to_string(i) == t.to_string(i)


@pytest.mark.parametrize("objective", RENEW)
def test_renewal_with_bagging_matches_jax(objective, jax_bagging):
    """Out-of-bag rows take no part in the percentile; their leaves come
    from the grower's walk."""
    X, y, _ = _data(objective, seed=2)
    p = {"objective": objective, "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 10, "bagging_fraction": 0.6,
         "bagging_freq": 1}
    _same_trees(*_train_both(p, X, y, 4))


@pytest.mark.parametrize("objective", ["regression_l1", "quantile"])
def test_renewal_under_random_forest_matches_jax(objective, jax_bagging):
    """rf renews against the init score, not the running average."""
    X, y, _ = _data(objective, seed=3)
    p = {"objective": objective, "boosting": "rf", "num_leaves": 15,
         "verbosity": -1, "min_data_in_leaf": 10,
         "bagging_fraction": 0.7, "bagging_freq": 1}
    ja, tb = _train_both(p, X, y, 3)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_quantized_l1_renews_after_the_quantized_renewal_like_jax():
    """use_quantized_grad with quant_train_renew_leaf: the grower's
    float-sum renewal first, then the percentile renewal."""
    X, y, _ = _data("regression_l1", seed=4)
    p = {"objective": "regression_l1", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 10, "use_quantized_grad": True,
         "stochastic_rounding": False, "quant_train_renew_leaf": True}
    _same_trees(*_train_both(p, X, y, 3))


def test_custom_objective_and_reg_sqrt_stay_refused():
    """A custom objective needs its fobj (the JAX package's message);
    reg_sqrt stays refused."""
    X, y, _ = _data("regression_l1", n=300)
    with pytest.raises(tlgb.LightGBMError, match="fobj"):
        tlgb.train({"objective": "none", **CPU}, tlgb.Dataset(X, label=y),
                   1)
    with pytest.raises(NotImplementedError, match="reg_sqrt"):
        tlgb.train({"objective": "regression", "reg_sqrt": True, **CPU},
                   tlgb.Dataset(X, label=y), 1)


def test_root_totals_differ_from_xla_only_in_the_last_bits():
    """Without the hand-in, the port's root totals are torch's float32
    sums: within a few ulp of XLA's, and of the exact sums."""
    rs = np.random.RandomState(0)
    for n in (1000, 3000, 10007):
        full = torch.from_numpy(rs.randn(n, 2).astype(np.float32) + 0.5)
        mine = torch.stack(_PORT_ROOT_TOTALS(full)).numpy()
        xla = np.array(_xla_totals(full.numpy()))
        exact = full.numpy().astype(np.float64).sum(axis=0)
        ulp = np.spacing(np.abs(exact).astype(np.float32))
        assert np.all(np.abs(mine - xla) <= 8 * ulp)
        assert np.all(np.abs(mine - exact) <= 8 * ulp)
