"""Basic monotone constraints, ``monotone_penalty`` and ``path_smooth`` in
the port (lightgbm_tpu_torch: the exact-output search in ops/split.py,
the per-leaf bounds, parent outputs and depths in ops/grow.py, the
parameters in config.py) held against the JAX package on the CPU.

The same numpy inputs go through both packages; XLA's float root totals
are handed to the grower (``tests/test_torch_objectives.py`` says why).
Trees are exact in structure and equal to rtol=1e-4, atol=1e-5 in leaf
values, and predictions are monotone along every constrained feature.

Monotone bounds clamp many candidates' outputs to one value, and such
candidates tie in real arithmetic: their float gains differ only in the
last bits. The port's search takes the JAX package's compiled arithmetic
(one FMA in the gain, the reciprocal of ``path_smooth``), so one search
picks the same candidate. Across iterations the float scores of the two
packages can still differ in the last bit (``jax.nn.sigmoid`` against
``torch.sigmoid``; XLA fuses some score updates into an FMA), and a later
tie can then break the other way (ROADMAP.md Queue 3). So the float runs
here are held for a few trees, and the longer runs use quantized
gradients, whose integer histograms leave nothing to round.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.ops.split import SplitParams, monotone_penalty_mult

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


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


@pytest.fixture(autouse=True)
def jax_root_totals(monkeypatch):
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)


def _data(n=3000, seed=0, cat=False):
    """Four informative numerical features (two rising, two falling with
    the label), one noise feature, NaN in feature 4; with ``cat``, a
    categorical feature of 30 categories in front."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    X[rs.rand(n) < 0.05, 4] = np.nan
    logit = X[:, 0] + 0.5 * X[:, 1] - 0.8 * X[:, 2] - 0.3 * X[:, 3] \
        + 0.4 * np.sin(3 * X[:, 0]) + 0.3 * rs.randn(n)
    if cat:
        c = rs.randint(0, 30, n)
        logit = logit + rs.randn(30)[c]
        X = np.column_stack([c.astype(float), X])
    y = (logit > 0).astype(np.float64)
    return X, y


MC = [1, 1, -1, -1, 0]
P = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
     "min_data_in_leaf": 10, "verbosity": -1, "monotone_constraints": MC}
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}
CASES = {
    "basic": ({}, 3),
    "penalty_2": ({"monotone_penalty": 2.0}, 3),
    "penalty_half": ({"monotone_penalty": 0.5}, 3),
    "smooth_1": ({"path_smooth": 1.0}, 3),
    "smooth_3": ({"path_smooth": 3.0}, 3),
    "smooth_alone": ({"path_smooth": 3.0, "monotone_constraints": []}, 5),
    "all": ({"path_smooth": 2.0, "monotone_penalty": 1.5}, 3),
    "basic_quantized": (QUANT, 6),
    "all_quantized": ({**QUANT, "path_smooth": 1.0,
                       "monotone_penalty": 2.0}, 6),
    "regression": ({"objective": "regression", "path_smooth": 1.0}, 4),
    "l1_max_delta": ({"lambda_l1": 0.5, "lambda_l2": 1.0,
                      "max_delta_step": 0.8}, 3),
}


def _same_trees(ja, tb):
    assert len(ja._models) == len(tb._models)
    for a, b in zip(ja._models, tb._models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count",
                     "internal_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        if a.num_cat:
            np.testing.assert_array_equal(a.cat_threshold, b.cat_threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


def _train_both(params, X, y, rounds, cats=()):
    kw = {"categorical_feature": list(cats)} if cats else {}
    ja = jlgb.train({**params, **JAX}, jlgb.Dataset(X, label=y, **kw),
                    rounds)
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, params=CPU, **kw), rounds)
    return ja, tb


def _assert_monotone(bst, X, mc, grid=25):
    """Predictions along each constrained feature, the others fixed, on
    200 rows: never against the constraint."""
    rows = X[:200].copy()
    for f, sign in enumerate(mc):
        if sign == 0:
            continue
        vals = np.linspace(np.nanmin(X[:, f]), np.nanmax(X[:, f]), grid)
        preds = []
        for v in vals:
            rows[:, f] = v
            preds.append(bst.predict(rows, raw_score=True))
        rows[:, f] = X[:200, f]
        assert (sign * np.diff(np.stack(preds), axis=0)).min() >= -1e-7


@pytest.mark.parametrize("case", list(CASES))
def test_trees_match_jax(case):
    extra, rounds = CASES[case]
    X, y = _data()
    params = {**P, **extra}
    if params["objective"] == "regression":
        y = X[:, 0] - X[:, 2] + 0.3 * np.random.RandomState(1).randn(len(y))
    ja, tb = _train_both(params, X, y, rounds)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               ja.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    if params["monotone_constraints"]:
        _assert_monotone(tb, X, MC)


@pytest.mark.parametrize("quantized", [False, True])
def test_with_categorical_features_matches_jax(quantized):
    """Monotone constraints beside a categorical feature: categorical
    splits pass the parent's bounds to both children."""
    X, y = _data(cat=True)
    params = {**P, "monotone_constraints": [0] + MC, "path_smooth": 1.0,
              **(QUANT if quantized else {})}
    ja, tb = _train_both(params, X, y, 5 if quantized else 3, cats=[0])
    assert sum(t.num_cat for t in tb._models) > 0
    _same_trees(ja, tb)
    _assert_monotone(tb, X, [0] + MC)


def test_without_constraints_the_search_keeps_its_formula():
    """No monotone constraints and no smoothing: the records are those of
    the search without the exact-output path, bit for bit (an all-zero
    constraint list takes the exact path, as in the JAX package)."""
    rs = np.random.RandomState(0)
    hist = np.abs(rs.randn(1, 4, 16, 2)).astype(np.float32)
    hist[..., 0] -= 0.5
    tot = hist[0, 0].sum(0)
    args = (torch.from_numpy(hist), torch.tensor([tot[0]]),
            torch.tensor([tot[1]]), torch.tensor([200.0]),
            torch.full((4,), 16), torch.full((4,), -1),
            torch.ones(4, dtype=torch.bool), SplitParams(min_data_in_leaf=1))
    from lightgbm_tpu_torch.ops.split import find_best_split
    a = find_best_split(*args)
    b = find_best_split(*args, parent_output=torch.tensor([0.3]),
                        leaf_depth=3)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def mono_model():
    X, y = _data(n=4000, seed=3)
    params = {**P, "num_leaves": 31, "monotone_penalty": 0.5,
              "path_smooth": 1.0, **CPU}
    return X, tlgb.train(params, tlgb.Dataset(X, label=y, params=CPU), 8)


@settings(max_examples=40, deadline=None)
@given(row=st.integers(0, 3999), f=st.sampled_from([0, 1, 2, 3]),
       a=st.floats(-4, 4), b=st.floats(-4, 4))
def test_predictions_are_monotone_along_constrained_features(mono_model,
                                                             row, f, a, b):
    X, bst = mono_model
    lo, hi = sorted((a, b))
    x = np.repeat(X[row:row + 1], 2, axis=0)
    x[0, f], x[1, f] = lo, hi
    p = bst.predict(x, raw_score=True)
    assert MC[f] * (p[1] - p[0]) >= -1e-7


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_other_monotone_methods_stay_refused(method):
    """The other methods were refused before the port had them; now each
    trains as the JAX package does (more cases in
    tests/test_torch_split_breadth.py) and keeps its constraints."""
    X, y = _data()
    params = {**P, "monotone_constraints_method": method}
    ja, tb = _train_both(params, X, y, 3)
    _same_trees(ja, tb)
    _assert_monotone(tb, X, MC)


def test_parameters_and_aliases_parse_like_jax():
    p = {"mc": "1,-1,0", "mc_method": "basic", "mc_penalty": 1.5,
         "path_smooth": 2, "cat_feature": "0,2", "cat_l2": 3.0,
         "cat_smooth": 4.0, "max_cat_threshold": 8,
         "min_data_per_group": 50}
    mine, ref = Config.from_params(p), JaxConfig.from_params(p)
    for k in ("monotone_constraints", "monotone_constraints_method",
              "monotone_penalty", "path_smooth", "categorical_feature",
              "cat_l2", "cat_smooth", "max_cat_threshold",
              "min_data_per_group"):
        assert getattr(mine, k) == getattr(ref, k), k
    with pytest.raises(ValueError, match="path_smooth"):
        Config.from_params({"path_smooth": -1.0})
    with pytest.raises(ValueError, match="monotone_constraints_method"):
        Config.from_params({"monotone_constraints_method": "strict"})


@pytest.mark.parametrize("pen", [0.0, 0.5, 1.0, 2.0, 3.5])
def test_penalty_multiplier_matches_jax(pen):
    from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
    from lightgbm_tpu.ops.split import monotone_penalty_mult as jax_mult
    for d in range(6):
        want = float(jax.jit(lambda d: jax_mult(
            d, JaxSplitParams(monotone_penalty=pen)))(jnp.int32(d)))
        assert monotone_penalty_mult(d, SplitParams(
            monotone_penalty=pen)) == want
