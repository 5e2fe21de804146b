"""Intermediate and advanced monotone constraints, interaction
constraints, forced splits and cost-effective gradient boosting (CEGB)
in the port (lightgbm_tpu_torch: the re-search, the bounds, the masks
and the penalties in ops/grow.py, ``gain_penalty``, the advanced bounds
and ``forced_result`` in ops/split.py, the parsing in models/gbdt.py and
config.py) held against the JAX package on the CPU.

The same numpy inputs go through both packages; XLA's float root totals
are handed to the grower (``tests/test_torch_objectives.py`` says why),
and the per-node column draws are JAX's (``tests/test_torch_sampling.py``).
Trees are exact in structure and equal to rtol=1e-4, atol=1e-5 in leaf
values. Float runs are held for a few trees and longer runs use
quantized gradients (``tests/test_torch_constraints.py`` says why).
"""

import json
import warnings

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
from lightgbm_tpu.ops.grow import GrowConfig as JaxGrowConfig
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split
from lightgbm_tpu.ops.split import leaf_output as jax_leaf_output
from lightgbm_tpu.ops.split import \
    find_best_split_bundled as jax_find_best_split_bundled
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models import gbdt
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.ops.bundling import build_bundles
from lightgbm_tpu_torch.ops.partition import RangeRules
from lightgbm_tpu_torch.ops.split import (F_, AdvancedBounds, BundleTables,
                                          SplitParams, find_best_split,
                                          find_best_split_bundled,
                                          forced_result)

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}
MC = [1, 1, -1, -1, 0]
P = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
     "min_data_in_leaf": 10, "verbosity": -1}


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


def _jax_uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape,
                                                        jnp.float32)))


@pytest.fixture(autouse=True)
def jax_inputs(monkeypatch):
    """XLA's root totals, and JAX's bagging and per-node draws (the
    packages' default seeds)."""
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)

    def bag(gen, it, n):
        return _jax_uniform(jax.random.fold_in(jax.random.PRNGKey(3), it),
                            (n,))

    def node(gen, it, k, idx, F):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(2), it), k), idx)
        return _jax_uniform(key, (F,))
    monkeypatch.setattr(gbdt, "bagging_uniform", bag)
    monkeypatch.setattr(gbdt, "bynode_uniform", node)


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
    return X, (logit > 0).astype(np.float64)


def _bundled_data(n=3000, seed=0):
    """Four one-hot blocks of six columns (values 1-3, so EFB bundles
    them), then two dense features."""
    rs = np.random.RandomState(seed)
    Z = np.zeros((n, 26))
    Z[:, 24:] = rs.randn(n, 2)
    for g in range(4):
        Z[np.arange(n), 6 * g + rs.randint(0, 6, n)] = rs.randint(1, 4, n)
    y = (Z[:, :12].sum(1) + Z[:, 24] - 0.5 * Z[:, 13]
         + 0.5 * rs.randn(n) > 4) * 1.0
    return Z, y


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


def _train_both(params, X, y, rounds, cats=(), names=None):
    kw = {"categorical_feature": list(cats)} if cats else {}
    if names is not None:
        kw["feature_name"] = names
    ja = jlgb.train({**params, **JAX}, jlgb.Dataset(X, label=y, **kw),
                    rounds)
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, params=CPU, **kw), rounds)
    _same_trees(ja, tb)
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


# ---- intermediate and advanced monotone constraints ----------------------

MONO = {
    "penalty_smooth": ({"monotone_penalty": 1.5, "path_smooth": 1.0}, 3),
    "quantized": (QUANT, 5),
    "quantized_max_depth": ({**QUANT, "max_depth": 3}, 4),
}


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
@pytest.mark.parametrize("case", list(MONO))
def test_monotone_methods_match_jax(method, case):
    extra, rounds = MONO[case]
    X, y = _data()
    params = {**P, "monotone_constraints": MC,
              "monotone_constraints_method": method, **extra}
    _, tb = _train_both(params, X, y, rounds)
    _assert_monotone(tb, X, MC)


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_monotone_methods_with_categorical_features_match_jax(method):
    X, y = _data(cat=True)
    params = {**P, **QUANT, "monotone_constraints": [0] + MC,
              "monotone_constraints_method": method}
    _, tb = _train_both(params, X, y, 4, cats=[0])
    assert sum(t.num_cat for t in tb._models) > 0
    _assert_monotone(tb, X, [0] + MC)


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_monotone_methods_bundled_match_jax(method):
    X, y = _bundled_data()
    mc = [1] * 12 + [0] * 12 + [1, -1]
    params = {**P, **QUANT, "monotone_constraints": mc,
              "monotone_constraints_method": method}
    _, tb = _train_both(params, X, y, 3)
    assert tb._engine.bundle is not None
    _assert_monotone(tb, X, mc, grid=5)


@pytest.fixture(scope="module", params=["intermediate", "advanced"])
def mono_model(request):
    X, y = _data(n=3000, seed=3)
    params = {**P, **QUANT, **CPU, "num_leaves": 31,
              "monotone_constraints": MC,
              "monotone_constraints_method": request.param}
    return X, tlgb.train(params, tlgb.Dataset(X, label=y, params=CPU), 6)


@settings(max_examples=30, deadline=None)
@given(row=st.integers(0, 2999), f=st.sampled_from([0, 1, 2, 3]),
       a=st.floats(-4, 4), b=st.floats(-4, 4))
def test_predictions_are_monotone_along_constrained_features(mono_model,
                                                             row, f, a, b):
    X, bst = mono_model
    lo, hi = sorted((a, b))
    x = np.repeat(X[row:row + 1], 2, axis=0)
    x[0, f], x[1, f] = lo, hi
    p = bst.predict(x, raw_score=True)
    assert MC[f] * (p[1] - p[0]) >= -1e-7


# ---- interaction constraints ----------------------------------------------

NAMES = ["a", "b", "c", "d", "e"]
INTERACTION = {
    "list_by_index": ([[0, 1], [2, 3, 4]], None, {}),
    "string_by_index": ("[0,1],[1,2,3]", None, {}),
    "nested_string": ("[[0,4],[1,2],[3]]", None, {}),
    "list_by_name": ([["a", "b"], ["c", "d", "e"]], NAMES, {}),
    "bynode": ([[0, 1, 2], [2, 3, 4]], None,
               {"feature_fraction_bynode": 0.6}),
}


def _paths(tree):
    """The sets of features on every root-to-leaf path."""
    out = []

    def walk(node, used):
        if node < 0:
            out.append(used)
            return
        u = used | {int(tree.split_feature[node])}
        walk(int(tree.left_child[node]), u)
        walk(int(tree.right_child[node]), u)
    walk(0, frozenset())
    return out


@pytest.mark.parametrize("case", list(INTERACTION))
def test_interaction_constraints_match_jax(case):
    ic, names, extra = INTERACTION[case]
    X, y = _data()
    _, tb = _train_both({**P, "interaction_constraints": ic, **extra}, X,
                        y, 3, names=names)
    groups = ic
    if isinstance(ic, str):
        groups = json.loads(ic if ic.startswith("[[") else f"[{ic}]")
    groups = [{NAMES.index(v) if isinstance(v, str) else v for v in g}
              for g in groups]
    for t in tb._models:
        for used in _paths(t):
            assert any(used <= g for g in groups)


def test_interaction_constraints_bundled_match_jax():
    X, y = _bundled_data()
    ic = [list(range(0, 12)) + [24], list(range(12, 24)) + [25]]
    _train_both({**P, **QUANT, "interaction_constraints": ic}, X, y, 3)


# ---- forced splits -----------------------------------------------------------

def _forced_file(tmp_path, tree):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _medians(X):
    return [float(v) for v in np.nanmedian(X, axis=0)]


def test_forced_splits_match_jax(tmp_path):
    X, y = _data()
    m = _medians(X)
    fs = {"feature": 0, "threshold": m[0],
          "left": {"feature": 1, "threshold": m[1]},
          "right": {"feature": 2, "threshold": m[2],
                    "left": {"feature": 4, "threshold": 0.3}}}
    for extra in ({}, {"monotone_constraints": MC, "path_smooth": 1.0},
                  {"monotone_constraints": MC,
                   "monotone_constraints_method": "intermediate"}):
        _, tb = _train_both({**P, **extra, "forcedsplits_filename":
                             _forced_file(tmp_path, fs)}, X, y, 3)
        for t in tb._models:
            np.testing.assert_array_equal(t.split_feature[:4], [0, 1, 2, 4])


def test_invalid_forced_split_aborts_the_rest(tmp_path):
    """A forced split with an empty child ends the forced splits: the
    ones after it in BFS order are not made either."""
    X, y = _data()
    m = _medians(X)
    fs = {"feature": 0, "threshold": m[0],
          "left": {"feature": 1, "threshold": 100.0},
          "right": {"feature": 2, "threshold": m[2]}}
    _, tb = _train_both({**P, "forcedsplits_filename":
                         _forced_file(tmp_path, fs)}, X, y, 2)
    t = tb._models[0]
    assert t.split_feature[0] == 0
    assert not (t.split_feature[1] == 2
                and t.threshold[1] == pytest.approx(m[2], abs=0.05))


def test_forced_split_on_a_categorical_feature_is_ignored(tmp_path):
    X, y = _data(cat=True)
    m = _medians(X)
    fs = {"feature": 0, "threshold": 3.0,
          "left": {"feature": 1, "threshold": m[1]}}
    path = _forced_file(tmp_path, fs)
    with pytest.warns(UserWarning, match="categorical"):
        tb = tlgb.train({**P, **CPU, "forcedsplits_filename": path},
                        tlgb.Dataset(X, label=y, params=CPU,
                                     categorical_feature=[0]), 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ja = jlgb.train({**P, **JAX, "forcedsplits_filename": path},
                        jlgb.Dataset(X, label=y, categorical_feature=[0]),
                        2)
    _same_trees(ja, tb)


@pytest.mark.parametrize("quantized", [False, True])
def test_forced_split_on_a_bundled_member_matches_jax(tmp_path, quantized):
    """A forced split on a member of a multi-member bundle: the record
    comes from the member's reconstructed histogram and K2 routes it by
    the member's range rule."""
    X, y = _bundled_data()
    fs = {"feature": 7, "threshold": 1.5,
          "left": {"feature": 13, "threshold": 0.5},
          "right": {"feature": 24, "threshold": 0.0}}
    params = {**P, "forcedsplits_filename": _forced_file(tmp_path, fs),
              **(QUANT if quantized else {})}
    _, tb = _train_both(params, X, y, 2)
    info = tb._engine.bundle
    assert not info.is_direct[7]
    for t in tb._models:
        np.testing.assert_array_equal(t.split_feature[:3], [7, 13, 24])


def _forced_jax_tree(hist_bins, g, h, fnb, fnan, f, t, sp):
    jcfg = JaxGrowConfig(num_leaves=2, num_bins=int(fnb.max()),
                         split=JaxSplitParams(**sp), hist_method="scatter")
    forced = (jnp.asarray([0], jnp.int32), jnp.asarray([f], jnp.int32),
              jnp.asarray([t], jnp.int32))
    n = g.shape[0]
    jt, _ = jax_grow_tree(
        jcfg, jnp.asarray(hist_bins.T), jnp.asarray(g), jnp.asarray(h),
        jnp.ones(n, jnp.float32), jnp.ones(len(fnb), bool),
        jnp.asarray(fnb), jnp.asarray(fnan), None, None, None, None, forced)
    return jt


@pytest.mark.parametrize("sp", [
    {"min_data_in_leaf": 5},
    {"min_data_in_leaf": 5, "path_smooth": 2.0, "lambda_l2": 1.0},
    {"min_data_in_leaf": 5, "lambda_l1": 0.3, "max_delta_step": 0.5}])
def test_forced_result_matches_jax(sp):
    """The forced record of a two-leaf tree: its gain, outputs and
    weights are the JAX grower's forced split's."""
    rs = np.random.RandomState(5)
    n, F, B = 600, 3, 16
    bins = rs.randint(0, B, (n, F)).astype(np.uint8)
    bins[rs.rand(n) < 0.1, 2] = B - 1                       # NaN bin
    g = rs.randn(n).astype(np.float32)
    h = (rs.rand(n) + 0.5).astype(np.float32)
    fnb = np.full(F, B, np.int32)
    fnan = np.array([-1, -1, B - 1], np.int32)
    for f, t in ((0, 7), (2, 3)):
        jt = _forced_jax_tree(bins, g, h, fnb, fnan, f, t, sp)
        root = np.float32(jax.jit(lambda a, b: jax_leaf_output(
            jnp.sum(a), jnp.sum(b), JaxSplitParams(**sp)))(g, h))
        jh = np.asarray(jax.jit(lambda a, b: jnp.zeros((F, B, 2)).at[
            jnp.arange(F)[None, :], a].add(b[:, None, :]))(
                bins.astype(np.int32), np.stack([g, h], 1)))
        th = jh[0].sum(0)[1]
        rec = forced_result(
            torch.from_numpy(jh), torch.tensor(float(n)), f, t,
            torch.tensor(float(root), dtype=torch.float32), None,
            SplitParams(**sp), bool(sp.get("path_smooth")),
            RangeRules(fnb, fnan)).numpy()
        assert rec[F_["feature"]] == f and rec[F_["threshold_bin"]] == t
        np.testing.assert_allclose(rec[F_["gain"]],
                                   np.asarray(jt.split_gain)[0], rtol=1e-5)
        np.testing.assert_allclose(
            [rec[F_["left_output"]], rec[F_["right_output"]]],
            np.asarray(jt.leaf_value)[:2], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            [rec[F_["left_sum_h"]], rec[F_["right_sum_h"]]],
            np.asarray(jt.leaf_weight)[:2], rtol=1e-5)
        assert rec[F_["left_sum_h"]] + rec[F_["right_sum_h"]] \
            == pytest.approx(th, rel=1e-6)


# ---- CEGB ------------------------------------------------------------------

CEGB = {
    "split": {"cegb_penalty_split": 0.01},
    "coupled": {"cegb_penalty_feature_coupled": [5.0, 5.0, 0.0, 0.0, 5.0]},
    "lazy": {"cegb_penalty_feature_lazy": [0.01, 0.02, 0.0, 0.0, 0.01]},
    "all_bagged": {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.005,
                   "cegb_penalty_feature_coupled": [2.0, 0.0, 2.0],
                   "cegb_penalty_feature_lazy": [0.0, 0.02, 0.0, 0.02],
                   "bagging_fraction": 0.8, "bagging_freq": 1},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "cegb_penalty_feature_coupled": [3.0, 0.0, 3.0],
                   "cegb_penalty_feature_lazy": [0.0, 0.01, 0.0, 0.01]},
}


@pytest.mark.parametrize("case", list(CEGB))
def test_cegb_matches_jax(case):
    """Trees equal to JAX's, and after every iteration the coupled
    features used and the rows that acquired each lazy feature equal the
    JAX booster's state."""
    X, y = _data()
    params = {**P, **CEGB[case]}
    if params["objective"] == "multiclass":
        y = np.digitize(X[:, 0] - X[:, 2], [-0.5, 0.5]).astype(float)
    ja = jlgb.Booster({**params, **JAX}, jlgb.Dataset(X, label=y))
    tb = tlgb.Booster({**params, **CPU},
                      tlgb.Dataset(X, label=y, params=CPU))
    je, te = ja._engine, tb._engine
    for _ in range(3):
        ja.update()
        tb.update()
        _same_trees(ja, tb)
        np.testing.assert_array_equal(
            te.cegb_state.coupled_used.numpy(), np.asarray(je._cegb_coupled))
        np.testing.assert_array_equal(te.cegb_state.coupled_host,
                                      np.asarray(je._cegb_coupled))
        if je.cegb_lazy:
            np.testing.assert_array_equal(
                te.cegb_state.lazy_used.numpy(),
                np.asarray(je._cegb_lazy_used))


def test_cegb_bundled_matches_jax():
    X, y = _bundled_data()
    lazy = [0.0] * 26
    lazy[24] = lazy[3] = 0.05
    _train_both({**P, **QUANT, "cegb_penalty_split": 0.002,
                 "cegb_penalty_feature_lazy": lazy}, X, y, 3)


def test_cegb_tradeoff_is_a_float_field_that_scales_the_penalties():
    for v in ("0.25", 0.25, 1):
        mine = Config.from_params({"cegb_tradeoff": v})
        assert mine.cegb_tradeoff == JaxConfig.from_params(
            {"cegb_tradeoff": v}).cegb_tradeoff
        assert isinstance(mine.cegb_tradeoff, float)
        assert "cegb_tradeoff" not in mine.extra
    X, y = _data()
    pen = {"cegb_penalty_feature_coupled": [4.0, 4.0, 0.0, 0.0, 4.0],
           "cegb_penalty_split": 0.004}
    _, half = _train_both({**P, **pen, "cegb_tradeoff": 0.5}, X, y, 2)
    # the tradeoff alone turns CEGB on (with nothing to scale)
    _, alone = _train_both({**P, "cegb_tradeoff": 0.5}, X, y, 2)
    assert alone._engine.cegb_state is not None
    full = tlgb.train({**P, **CPU, **pen},
                      tlgb.Dataset(X, label=y, params=CPU), 2)
    assert any(a.num_leaves != b.num_leaves
               or not np.array_equal(a.split_feature, b.split_feature)
               for a, b in zip(half._models, full._models))


def test_parameters_and_aliases_parse_like_jax():
    p = {"fs": "forced.json", "cegb_penalty_split": "0.5",
         "cegb_penalty_feature_lazy": "1,2,0.5",
         "cegb_penalty_feature_coupled": [1, 0, 2],
         "interaction_constraints": "[0,1],[2]",
         "mc_method": "advanced", "feature_contrib": "1,0.5"}
    mine, ref = Config.from_params(p), JaxConfig.from_params(p)
    for k in ("forcedsplits_filename", "cegb_penalty_split",
              "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled",
              "interaction_constraints", "monotone_constraints_method",
              "feature_contri"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert not mine.extra


# ---- the search's new inputs, against the jitted JAX search --------------

def _hist(rs, F, B, nan_feature=None):
    hist = np.zeros((F, B, 2), np.float32)
    hist[..., 1] = rs.rand(F, B).astype(np.float32) * 5 + 0.1
    hist[..., 0] = rs.randn(F, B).astype(np.float32) * hist[..., 1]
    # every feature sums to the same totals (feature 0's)
    for j in range(1, F):
        hist[j, 0] += hist[0].sum(0) - hist[j].sum(0)
    hist[:, 0, 1] = np.abs(hist[:, 0, 1]) + 0.1
    hist[1:, 0, 1] = hist[0].sum(0)[1] - hist[1:, 1:, 1].sum(1)
    return hist


def _adv_bounds(rs, F, B):
    lo = rs.randn(4, F, B).astype(np.float32) * 0.2 - 0.4
    hi = lo + np.abs(rs.randn(4, F, B)).astype(np.float32) * 0.5
    lo[:, :, ::5] = -np.inf
    hi[:, :, ::7] = np.inf
    return (lo[0], hi[0], lo[1], hi[1], np.float32(-0.3), np.float32(0.4))


def _as_torch_adv(b):
    return AdvancedBounds(*(torch.as_tensor(np.asarray(x))[None]
                            if np.ndim(x) else torch.tensor([float(x)])
                            for x in b))


def _check_record(rec, jr):
    assert rec[F_["feature"]] == int(jr.feature)
    assert rec[F_["threshold_bin"]] == int(jr.threshold_bin)
    assert bool(rec[F_["default_left"]]) == bool(jr.default_left)
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "right_sum_g", "right_sum_h", "right_count",
                 "left_output", "right_output"):
        np.testing.assert_array_equal(rec[F_[name]],
                                      np.float32(getattr(jr, name)),
                                      err_msg=name)


@pytest.mark.parametrize("advanced", [False, True])
@pytest.mark.parametrize("penalty", [False, True])
def test_search_records_match_jax(advanced, penalty):
    rs = np.random.RandomState(11 + 2 * advanced + penalty)
    F, B = 5, 16
    hist = _hist(rs, F, B)
    tg, th = (float(v) for v in hist[0].sum(0))
    tc = 800.0
    fnb = np.array([16, 16, 12, 9, 16], np.int32)
    fnan = np.array([-1, 15, -1, 8, -1], np.int32)
    mono = np.array([1, -1, 0, 1, 0], np.int8)
    sp = dict(min_data_in_leaf=5, monotone_penalty=0.5)
    gp = (rs.rand(F) * 3).astype(np.float32) if penalty else None
    bounds = _adv_bounds(rs, F, B) if advanced \
        else (np.float32(-0.5), np.float32(0.6))
    fn = jax.jit(lambda hh, pen, *bb: jax_find_best_split(
        hh, tg, th, tc, jnp.asarray(fnb), jnp.asarray(fnan),
        jnp.ones(F, bool), JaxSplitParams(**sp), jnp.asarray(mono), None,
        pen, jnp.float32(0.05), jnp.int32(2), tuple(bb)))
    jr = fn(hist, gp, *bounds)
    tb = _as_torch_adv(bounds) if advanced else torch.tensor(
        [[bounds[0], bounds[1]]])
    rec = find_best_split(
        torch.from_numpy(hist)[None], torch.tensor([tg]),
        torch.tensor([th]), torch.tensor([tc]), torch.from_numpy(fnb),
        torch.from_numpy(fnan), torch.ones(F, dtype=torch.bool),
        SplitParams(**sp), None, torch.from_numpy(mono),
        torch.tensor([0.05]), [2], tb,
        None if gp is None else torch.from_numpy(gp)[None])[0].numpy()
    _check_record(rec, jr)


@pytest.mark.parametrize("advanced", [False, True])
def test_bundled_search_records_match_jax(advanced):
    X, y = _bundled_data(n=2000, seed=4)
    td = tlgb.Dataset(X, label=y, params=CPU).construct()
    info = build_bundles(td.device_bins(), td.mappers)
    tables = BundleTables.of(info, torch.device("cpu"))
    bb = info.bins_bundled.numpy().astype(np.int64)
    rs = np.random.RandomState(8)
    g = rs.randn(len(y)).astype(np.float32)
    h = (rs.rand(len(y)) + 0.5).astype(np.float32)
    G, B = bb.shape[1], info.num_positions
    hist = np.zeros((G, B, 2), np.float32)
    for j in range(G):
        np.add.at(hist[j], bb[:, j], np.stack([g, h], 1))
    tg, th = (float(v) for v in hist[0].sum(0))
    F = len(td.mappers)
    mono = np.zeros(F, np.int8)
    mono[[1, 7, 24]] = 1
    mono[[13, 25]] = -1
    gp = (rs.rand(F) * 0.5).astype(np.float32)
    bounds = _adv_bounds(rs, F, B) if advanced \
        else (np.float32(-0.4), np.float32(0.5))
    sp = dict(min_data_in_leaf=5, path_smooth=1.0)
    fn = jax.jit(lambda hh, pen, *b2: jax_find_best_split_bundled(
        hh, tg, th, float(len(y)), jnp.asarray(info.member_at),
        jnp.asarray(info.tloc_at), jnp.asarray(info.end_at),
        jnp.asarray(info.is_direct), jnp.asarray(info.nanpos_at),
        jnp.asarray(info.nan_at), jnp.ones(F, bool), JaxSplitParams(**sp),
        gain_penalty=pen, monotone_constraints=jnp.asarray(mono),
        parent_output=jnp.float32(0.02), leaf_depth=jnp.int32(1),
        bounds=tuple(b2)))
    jr = fn(hist, gp, *bounds)
    tb = _as_torch_adv(bounds) if advanced else torch.tensor(
        [[bounds[0], bounds[1]]])
    rec = find_best_split_bundled(
        torch.from_numpy(hist)[None], torch.tensor([tg]),
        torch.tensor([th]), torch.tensor([float(len(y))]), tables,
        torch.ones(F, dtype=torch.bool), SplitParams(**sp), None, None,
        torch.from_numpy(mono), torch.tensor([0.02]), 1, tb,
        torch.from_numpy(gp)[None])[0].numpy()
    _check_record(rec, jr)
