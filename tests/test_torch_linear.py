"""Linear trees in the port (lightgbm_tpu_torch: ops/linear.py, the
linear leaves of models/gbdt.py, prediction.py and models/tree.py, the
raw values of basic.py) held against the JAX package on the CPU.

The JAX package sums each leaf's normal equations in float32 and solves
them in float32; the port sums and solves in float64 and rounds the
solution to float32 (ops/linear.py says why). On these fixtures the JAX
package's float32 sums move a coefficient by up to ~1.2e-3 of itself
from the exact solution, so the coefficients and constants are held to
the JAX package's at rtol=2e-3, atol=1e-5, and to a float64 numpy solve
of the same normal equations at rtol=1e-6 (a coefficient the port drops
as 0 is held to the JAX package's as 0). Trees are held exactly in
structure, leaf values at rtol=1e-4, atol=1e-5, predictions within
1e-5. The features are continuous: a feature that
is constant within a leaf makes its normal equations singular, and
both packages' answers are then rounding noise. XLA's float root totals
are handed to the port (``ops/grow.py`` ``root_totals``;
``tests/test_torch_objectives.py`` says why).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import numpy_predict_raw
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.ops.linear import (branch_features_per_leaf,
                                           fit_leaf_linear,
                                           linear_leaf_values)

CPU = {"device_type": "cpu"}
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
        "min_data_in_leaf": 10, "linear_tree": True, "learning_rate": 0.2}
TREE = ("split_feature", "threshold", "decision_type", "left_child",
        "right_child", "leaf_count", "internal_count")


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


@jax.jit
def _xla_root(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


@pytest.fixture(autouse=True)
def xla_root_totals(monkeypatch):
    def root(full):
        v = torch.from_numpy(np.array(_xla_root(full.numpy())))
        return v[0], v[1]
    monkeypatch.setattr(grow, "root_totals", root)


def _xy(n=2000, F=5, seed=0, nan=0.05):
    """Continuous features with NaN; the tests train on 2,000 rows
    where they can, so the JAX package compiles its programs once."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    X[rs.rand(n, F) < nan] = np.nan
    Z = np.nan_to_num(X)
    y = ((Z[:, 0] + 0.5 * Z[:, 1] - 0.3 * Z[:, 2] * Z[:, 3]
          + 0.3 * rs.randn(n)) > 0) * 1.0
    return X, y


def _both(params, X, y, rounds=3, valid=None):
    jd = jlgb.Dataset(X, label=y, params=params)
    td = tlgb.Dataset(X, label=y, params={**params, **CPU})
    out = []
    for lgb, ds, p in ((jlgb, jd, {"hist_method": "scatter"}),
                       (tlgb, td, CPU)):
        ev = {}
        kw = {}
        if valid is not None:
            kw = dict(valid_sets=[ds.create_valid(*valid)],
                      callbacks=[lgb.record_evaluation(ev)])
        out.append((lgb.train({**params, **p}, ds, rounds, **kw), ev))
    return out


def _assert_linear_like_jax(jb, tb):
    assert len(jb._models) == len(tb._models)
    for a, b in zip(jb._models, tb._models):
        assert a.num_leaves == b.num_leaves
        for k in TREE:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
        assert a.is_linear and b.is_linear
        np.testing.assert_allclose(b.leaf_const, a.leaf_const, rtol=2e-3,
                                   atol=1e-5)
        # a leaf's coefficients by feature (a dropped one is 0: where the
        # exact fit is 0, the JAX package's float32 noise of ~1e-8 stays)
        for fa, ca, fb, cb in zip(a.leaf_features, a.leaf_coeff,
                                  b.leaf_features, b.leaf_coeff):
            da, db = dict(zip(fa, ca)), dict(zip(fb, cb))
            keys = sorted(set(da) | set(db))
            np.testing.assert_allclose([db.get(k, 0.0) for k in keys],
                                       [da.get(k, 0.0) for k in keys],
                                       rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("extra", [{"metric": "binary_logloss"},
                                   {"linear_lambda": 1.0},
                                   {"boosting": "dart", "drop_rate": 0.5,
                                    "skip_drop": 0.0}])
def test_linear_trees_match_jax(extra):
    """Three iterations: the first tree is constant (marked linear, no
    features), the next two carry fitted leaves; predictions agree with
    the JAX package's and with a numpy walk of the model text (NaN rows
    take the leaf value). A valid set (which keeps its raw values since
    its reference does) records the JAX package's metric; DART rescales
    and re-scores linear trees."""
    X, y = _xy(n=2400)
    valid = (X[2000:], y[2000:]) if "metric" in extra else None
    X, y = X[:2000], y[:2000]
    (jb, jev), (tb, tev) = _both({**BASE, **extra}, X, y, valid=valid)
    _assert_linear_like_jax(jb, tb)
    if valid is not None:
        np.testing.assert_allclose(tev["valid_0"]["binary_logloss"],
                                   jev["valid_0"]["binary_logloss"],
                                   rtol=1e-5)
    assert not any(tb._models[0].leaf_features)
    assert any(tb._models[1].leaf_features)
    raw = tb.predict(X, raw_score=True)
    # two fits whose coefficients differ by the JAX package's float32
    # sums (the same model predicts within 1e-5 in both packages:
    # test_model_text_cross_loads_both_ways)
    np.testing.assert_allclose(raw, jb.predict(X, raw_score=True),
                               atol=1e-4)
    np.testing.assert_allclose(raw, numpy_predict_raw(
        tb.model_to_string(), X), atol=1e-5)
    # the train score is the sum of the fitted outputs
    np.testing.assert_allclose(tb._engine.score[0].numpy(), raw, atol=1e-5)


def _fit_reference(raw, row_leaf, g, h, w, feats, lam, leaf_value):
    """The fit in float64 numpy, leaf by leaf."""
    L = len(feats)
    const = np.asarray(leaf_value, np.float64).copy()
    coef = np.zeros((L, max(1, max(len(f) for f in feats))))
    for leaf in range(L):
        f = feats[leaf]
        x = raw[row_leaf == leaf][:, f].astype(np.float64)
        ok = ~np.isnan(x).any(axis=1) & (w[row_leaf == leaf] > 0)
        xa = np.column_stack([x[ok], np.ones(ok.sum())])
        hh = (h * w)[row_leaf == leaf][ok].astype(np.float64)
        gg = (g * w)[row_leaf == leaf][ok].astype(np.float64)
        if ok.sum() < len(f) + 1:
            continue
        A = (xa * hh[:, None]).T @ xa + np.diag([lam] * len(f) + [0.0])
        sol = -np.linalg.solve(A, xa.T @ gg)
        const[leaf] = sol[-1]
        coef[leaf, :len(f)] = sol[:-1]
    return const, coef


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_fit_equals_a_float64_solve(lam):
    """fit_leaf_linear on rows with NaN, out-of-bag rows, a leaf of no
    feature (its constant fit alone), a leaf with fewer rows than
    coefficients (keeps its value), in chunks of rows smaller than the
    data (the chunked sums)."""
    rs = np.random.RandomState(1)
    n, F = 3000, 6
    raw = rs.randn(n, F).astype(np.float32)
    raw[rs.rand(n, F) < 0.03] = np.nan
    row_leaf = rs.randint(0, 4, n)
    row_leaf[:3] = 4                       # a leaf of 3 rows, 3 features
    g = rs.randn(n).astype(np.float32)
    h = (rs.rand(n) + 0.2).astype(np.float32)
    w = (rs.rand(n) > 0.2).astype(np.float32)
    feats = [[0, 2], [], [1, 3, 5], [4], [0, 1, 2]]
    lf = np.zeros((5, 3), np.int64)
    nf = np.array([len(f) for f in feats])
    for i, f in enumerate(feats):
        lf[i, :len(f)] = f
    lv = rs.randn(5).astype(np.float32)
    from lightgbm_tpu_torch.ops import linear
    old = linear.CHUNK_ELEMS
    linear.CHUNK_ELEMS = 4096
    try:
        const, coef, pred = fit_leaf_linear(
            torch.from_numpy(raw), torch.from_numpy(row_leaf),
            torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w),
            torch.from_numpy(lf), torch.from_numpy(nf), torch.from_numpy(lv),
            lam)
    finally:
        linear.CHUNK_ELEMS = old
    want_c, want_k = _fit_reference(raw, row_leaf, g, h, w, feats, lam, lv)
    np.testing.assert_allclose(const.numpy(), want_c, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(coef.numpy(), want_k[:, :3], rtol=1e-6,
                               atol=1e-7)
    assert const[4].item() == lv[4]
    # the train outputs: the model, or the leaf value for a NaN row
    x = raw[np.arange(n)[:, None], lf[row_leaf]]
    act = np.arange(3)[None, :] < nf[row_leaf][:, None]
    nanrow = (np.isnan(x) & act).any(axis=1)
    lin = want_c[row_leaf] + (np.where(act, np.nan_to_num(x), 0.0)
                              * want_k[row_leaf, :3]).sum(axis=1)
    np.testing.assert_allclose(pred.numpy(),
                               np.where(nanrow, lv[row_leaf], lin),
                               rtol=1e-5, atol=1e-6)
    out = linear_leaf_values(const, coef, torch.from_numpy(lf),
                             torch.from_numpy(nf), torch.from_numpy(lv),
                             torch.from_numpy(raw),
                             torch.from_numpy(row_leaf))
    np.testing.assert_array_equal(out.numpy(), pred.numpy())


def test_branch_features_match_jax():
    from lightgbm_tpu.ops.linear import \
        branch_features_per_leaf as jax_branch
    X, y = _xy(n=800)
    b = tlgb.train({**BASE, **CPU, "linear_tree": False},
                   tlgb.Dataset(X, label=y, params=CPU), 1)
    t = b._models[0]
    parent = np.full(t.num_leaves, -1, np.int32)
    for i in range(t.num_nodes):
        for c in (t.left_child[i], t.right_child[i]):
            if c < 0:
                parent[~c] = i
    args = (t.split_feature, t.left_child, t.right_child, parent,
            t.num_leaves, lambda f: f != 2)
    assert branch_features_per_leaf(*args) == jax_branch(*args)


def test_cv_with_linear_trees_matches_jax():
    """cv's folds subset the raw values with the rows."""
    X, y = _xy(n=4000)
    p = {**BASE, "metric": "binary_logloss"}
    cv = {}
    for lgb, extra in ((jlgb, {"hist_method": "scatter"}), (tlgb, CPU)):
        cv[lgb] = lgb.cv({**p, **extra},
                         lgb.Dataset(X, label=y, params={**p, **extra}),
                         num_boost_round=2, nfold=2, stratified=False,
                         seed=0)
    np.testing.assert_allclose(cv[tlgb]["valid binary_logloss-mean"],
                               cv[jlgb]["valid binary_logloss-mean"],
                               rtol=1e-5)


def test_model_text_cross_loads_both_ways():
    X, y = _xy()
    (jb, _), (tb, _) = _both(BASE, X, y)
    for src, dst in ((jb, tlgb), (tb, jlgb)):
        text = src.model_to_string()
        loaded = dst.Booster(model_str=text,
                             params=CPU if dst is tlgb else None)
        np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                                   src.predict(X, raw_score=True),
                                   atol=1e-5)
        again = tlgb.Booster(model_str=text, params=CPU)
        assert again.model_to_string() == tlgb.Booster(
            model_str=again.model_to_string(), params=CPU).model_to_string()
    # the trees of a loaded JAX model are written back as they were
    trees = jb.model_to_string().split("\nTree=", 1)[1].split(
        "end of trees")[0]
    assert trees in tlgb.Booster(model_str=jb.model_to_string(),
                                 params=CPU).model_to_string()


def test_dump_and_convert_of_a_linear_model_follow_jax():
    """``dump_model`` and ``trees_to_dataframe`` hold the constant leaf
    values, and ``convert_model`` writes them (the JAX package's
    ``convert.py`` ignores the coefficients; ROADMAP.md Queue 3)."""
    from lightgbm_tpu.convert import model_to_if_else as jax_convert
    from lightgbm_tpu_torch.convert import model_to_if_else
    X, y = _xy()
    text = jlgb.train({**BASE, "hist_method": "scatter"},
                      jlgb.Dataset(X, label=y, params=BASE),
                      2).model_to_string()
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, params=CPU)
    assert tb.dump_model() == jb.dump_model()
    assert tb.trees_to_dataframe().equals(jb.trees_to_dataframe())
    assert model_to_if_else(tb) == jax_convert(jb)


def test_linear_trees_refuse_what_jax_refuses():
    """Monotone constraints and a Dataset built without raw values
    raise ValueError; refit and pred_contrib of a linear model raise
    LightGBMError, in both packages."""
    X, y = _xy()
    for lgb, p in ((jlgb, {}), (tlgb, CPU)):
        with pytest.raises(ValueError, match="monotone"):
            lgb.train({**BASE, **p, "monotone_constraints": [1] * 5},
                      lgb.Dataset(X, label=y, params={**BASE, **p}), 1)
        ds = lgb.Dataset(X, label=y, params=p).construct()
        with pytest.raises(ValueError, match="raw data"):
            lgb.train({**BASE, **p}, ds, 1)
        b = lgb.train({**BASE, **p}, lgb.Dataset(X, label=y,
                                                  params={**BASE, **p}), 2)
        with pytest.raises(lgb.basic.LightGBMError, match="linear"):
            b.refit(X, y)
        with pytest.raises(lgb.basic.LightGBMError, match="linear"):
            b.predict(X, pred_contrib=True)


def test_raw_values_follow_the_dataset_like_jax(tmp_path):
    X, y = _xy(n=500)
    X[:, 3] = 1.0                                  # a trivial feature
    p = {"linear_tree": True}
    jd = jlgb.Dataset(X, label=y, params=p).construct()
    td = tlgb.Dataset(X, label=y, params={**p, **CPU}).construct()
    np.testing.assert_array_equal(td.raw_numeric(), jd.raw_numeric())
    assert td.device_raw().dtype == torch.float32
    assert tuple(td.device_raw().shape) == (500, td.num_features())
    # a valid set keeps them when its reference does
    v = td.create_valid(X[:50], label=y[:50]).construct()
    np.testing.assert_array_equal(v.raw_numeric(), jd.raw_numeric()[:50])
    idx = np.array([3, 1, 4, 1, 5])
    np.testing.assert_array_equal(td.subset(idx).construct().raw_numeric(),
                                  jd.raw_numeric()[idx])
    other = tlgb.Dataset(X[:, :2] * 2, label=y, params={**p, **CPU})
    both = tlgb.Dataset(X, label=y, params={**p, **CPU}).construct()
    both.add_features_from(other.construct())
    np.testing.assert_array_equal(
        both.raw_numeric(), np.hstack([jd.raw_numeric(),
                                       (X[:, :2] * 2).astype(np.float32)]))
    # without linear_tree, or from a binary file, none are kept
    plain = tlgb.Dataset(X, label=y, params=CPU).construct()
    assert plain.raw_numeric() is None
    with pytest.raises(tlgb.basic.LightGBMError, match="linear_tree"):
        plain.device_raw()
    path = str(tmp_path / "d.bin")
    td.save_binary(path)
    assert tlgb.Dataset(path, params=CPU).construct().raw_numeric() is None


def test_rollback_and_early_stop_of_linear_trees():
    """Rollback takes the last linear tree's outputs out of the train
    score (re-scored on the raw values), and ``pred_early_stop`` with a
    margin no row reaches walks linear leaves as the full predict
    does."""
    X, y = _xy(n=800)
    b = tlgb.train({**BASE, **CPU},
                   tlgb.Dataset(X, label=y, params={**BASE, **CPU}), 3)
    full = b.predict(X, raw_score=True)
    es = b.predict(X, raw_score=True, pred_early_stop=True,
                   pred_early_stop_freq=1, pred_early_stop_margin=1e30)
    np.testing.assert_array_equal(es, full)
    b.rollback_one_iter()
    np.testing.assert_allclose(b._engine.score[0].numpy(),
                               b.predict(X, raw_score=True,
                                         num_iteration=2), atol=1e-5)
