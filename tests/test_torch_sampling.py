"""Row and column sampling in the port (lightgbm_tpu_torch: the grower
under row weights, bagging, GOSS, feature_fraction,
feature_fraction_bynode, DART and random forests in models/gbdt.py, and
the random forest's average_output in prediction.py and interop.py)
held against the JAX package on the CPU.

Bagging, GOSS and per-node sampling draw from ``jax.random`` in the JAX
package, which torch cannot reproduce: the end-to-end tests replace the
port's two draw functions (``models.gbdt.bagging_uniform``,
``bynode_uniform``) with ones that return JAX's draws, as
``tests/test_torch_quant.py`` hands the grower JAX's stochastic-rounding
noise. ``feature_fraction``
and DART draw from numpy in both packages and need no hand-in. Trees
agree exactly in structure (every ``row_leaf`` too, at the grower) and
to rtol=1e-4, atol=1e-5 in leaf values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.grow import GrowConfig as JaxGrowConfig
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.models import gbdt
from lightgbm_tpu_torch.ops.grow import GrowConfig, Grower
from lightgbm_tpu_torch.ops.split import SplitParams

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}
STRUCTURE = ("split_feature", "threshold_bin", "default_left",
             "left_child", "right_child", "leaf_parent", "leaf_depth",
             "leaf_count", "internal_count")


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


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's bagging/GOSS and per-node draws replaced by the JAX
    package's (its default seeds, or the ones passed)."""
    def install(bagging_seed=3, feature_fraction_seed=2):
        def bag(gen, it, n):
            return _jax_uniform(jax.random.fold_in(
                jax.random.PRNGKey(bagging_seed), it), (n,))

        def node(gen, it, k, idx, F):
            key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(feature_fraction_seed), it), k), idx)
            return _jax_uniform(key, (F,))
        monkeypatch.setattr(gbdt, "bagging_uniform", bag)
        monkeypatch.setattr(gbdt, "bynode_uniform", node)
    return install


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
        assert b.shrinkage == pytest.approx(a.shrinkage, rel=1e-12)


def _data(n=2000, F=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    X[rs.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rs.randn(F) + 0.5 * rs.randn(n)) > 0) * 1.0
    return X, y


def _train_both(params, X, y, rounds, K=1):
    ja = jlgb.train({**params, **JAX},
                    jlgb.Dataset(X, label=y, params={"max_bin": 63}),
                    rounds)
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, params={"max_bin": 63, **CPU}),
                    rounds)
    return ja, tb


# ---- the random forest's average_output --------------------------------

RF = {"objective": "binary", "boosting": "rf", "bagging_freq": 1,
      "bagging_fraction": 0.7, "num_leaves": 15, "verbosity": -1}


def test_jax_random_forest_model_predicts_the_same(tmp_path):
    """A JAX-trained random forest (model text with ``average_output``)
    predicts its mean, not its sum, in the port: raw and converted, to
    1e-6, from the file and through interop."""
    X, y = _data(3000, 8, seed=1)
    ja = jlgb.train({**RF, **JAX}, jlgb.Dataset(X, label=y), 5)
    path = tmp_path / "rf.txt"
    ja.save_model(str(path))
    assert "average_output" in path.read_text()
    tb = tlgb.Booster(model_file=str(path), params=CPU)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(X, raw_score=raw),
                                   ja.predict(X, raw_score=raw), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(tb.predict(X, num_iteration=2),
                               ja.predict(X, num_iteration=2), atol=1e-6)
    fields = interop.booster_fields(tb)
    assert fields["average_output"] is True
    again = interop.booster_from_fields(fields, CPU)
    np.testing.assert_allclose(again.predict(X), ja.predict(X), atol=1e-6)


def test_chip_smoke_jax_random_forest_is_what_jax_writes(tmp_path):
    """``chip_smoke.JAX_RF_MODEL``, the JAX package's random forest the
    smoke loads on the card, predicts ``JAX_RF_PRED`` and ``JAX_RF_RAW``
    in both packages."""
    import chip_smoke
    path = tmp_path / "rf.txt"
    path.write_text(chip_smoke.JAX_RF_MODEL)
    X = np.asarray(chip_smoke.JAX_RF_ROWS)
    jb = jlgb.Booster(model_file=str(path))
    tb = tlgb.Booster(model_file=str(path), params=CPU)
    for b in (jb, tb):
        np.testing.assert_allclose(b.predict(X), chip_smoke.JAX_RF_PRED,
                                   atol=1e-7)
        np.testing.assert_allclose(b.predict(X, raw_score=True),
                                   chip_smoke.JAX_RF_RAW, atol=1e-7)


def test_random_forest_matches_jax(jax_draws, tmp_path):
    jax_draws()
    X, y = _data(2000, 6, seed=2)
    ja, tb = _train_both(RF, X, y, 4)
    _same_trees(ja, tb)
    assert tb._avg_output and tb.model_to_string().count(
        "average_output") == 1
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(X, raw_score=raw),
                                   ja.predict(X, raw_score=raw), rtol=1e-5,
                                   atol=1e-5)
    # the train score is the running average of the trees' outputs
    np.testing.assert_allclose(tb._engine.score[0].numpy(),
                               tb.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_random_forest_needs_bagging_like_jax():
    X, y = _data(300)
    for lgb, extra in ((jlgb, JAX), (tlgb, CPU)):
        with pytest.raises(ValueError, match="Random forest needs "
                           "bagging_freq > 0 and 0 < bagging_fraction < 1"):
            lgb.train({"objective": "binary", "boosting": "random_forest",
                       **extra}, lgb.Dataset(X, label=y), 1)


@pytest.mark.parametrize("params", [
    dict(RF),
    {"objective": "binary", "boosting": "dart", "num_leaves": 8,
     "skip_drop": 0.0, "verbosity": -1},
])
def test_model_text_cross_loads_both_ways(params, jax_draws, tmp_path):
    jax_draws()
    X, y = _data(1500, 5, seed=3)
    ja, tb = _train_both(params, X, y, 4)
    ja.save_model(str(tmp_path / "jax.txt"))
    tb.save_model(tmp_path / "port.txt")
    t_from_j = tlgb.Booster(model_file=str(tmp_path / "jax.txt"),
                            params=CPU)
    j_from_t = jlgb.Booster(model_file=str(tmp_path / "port.txt"))
    np.testing.assert_allclose(t_from_j.predict(X), ja.predict(X), atol=1e-6)
    np.testing.assert_allclose(j_from_t.predict(X), tb.predict(X), atol=1e-6)
    a = ja.model_to_string().split("parameters:")[0]
    b = tb.model_to_string().split("parameters:")[0]
    assert [ln.split("=")[0] for ln in a.splitlines()] == \
        [ln.split("=")[0] for ln in b.splitlines()]


# ---- the grower under row weights --------------------------------------

def _mk(n, F, B, seed=0):
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, B, size=(F, n)).astype(np.uint8)
    g = rs.randn(n).astype(np.float32)
    h = (np.abs(rs.randn(n)) + 0.1).astype(np.float32)
    fnb = np.full(F, B, np.int32)
    fnan = np.full(F, -1, np.int32)
    fnan[::2] = B - 1
    return bins, g, h, fnb, fnan


def _weights(kind, n, g, h, seed):
    rs = np.random.RandomState(seed)
    if kind == "bagging":
        return (rs.rand(n) < 0.6).astype(np.float32)
    # GOSS: the top 20% of |g| * h once, 10% of the rest amplified by 8
    m = np.abs(g) * h
    top = m >= np.quantile(m, 0.8)
    other = ~top & (rs.rand(n) < 0.125)
    return top.astype(np.float32) + other.astype(np.float32) * 8.0


@pytest.mark.parametrize("kind,quant", [("bagging", False),
                                        ("goss", False),
                                        ("bagging", True),
                                        ("goss", True)])
def test_grower_with_row_weights_matches_jax(kind, quant):
    n, F, B, L = 3000, 6, 64, 31
    bins, g, h, fnb, fnan = _mk(n, F, B, seed=4)
    w = _weights(kind, n, g, h, 5)
    fm = np.ones(F, bool)
    fm[3] = False
    sp = dict(min_data_in_leaf=5.0)
    key = jax.random.PRNGKey(11) if quant else None
    jt, jrl = jax_grow_tree(
        JaxGrowConfig(num_leaves=L, num_bins=B, split=JaxSplitParams(**sp),
                      grower="compact", hist_method="scatter",
                      quantized=quant, quant_bins=4, renew_leaf=quant,
                      stochastic=quant),
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.asarray(fm), jnp.asarray(fnb), jnp.asarray(fnan),
        quant_key=key)
    noise = None if key is None else _jax_uniform(key, (n, 2))
    t, rl = Grower(GrowConfig(num_leaves=L, num_bins=B,
                              split=SplitParams(**sp), quantized=quant,
                              quant_bins=4, renew_leaf=quant),
                   torch.from_numpy(bins.T.copy()), fnb, fnan).grow(
        torch.from_numpy(g), torch.from_numpy(h), noise,
        torch.from_numpy(w), fm)
    assert t.num_leaves == int(jt.num_leaves) > 10
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    # the root count is the in-bag count
    assert t.leaf_count[:t.num_leaves].sum() == (w > 0).sum()
    assert 3 not in t.split_feature[:t.num_leaves - 1]
    # every row's leaf, out-of-bag rows included
    assert np.array_equal(rl.numpy(), np.asarray(jrl))
    for name in ("leaf_value", "leaf_weight", "internal_value",
                 "internal_weight", "split_gain"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_goss_threshold_is_jax_quantile():
    rs = np.random.RandomState(6)
    for n in (1000, 1001, 4097):
        x = np.abs(rs.randn(n)).astype(np.float32)
        x[::50] = x[1]                              # ties
        for q in (0.8, 0.7, 0.9):
            want = float(jnp.quantile(jnp.asarray(x), 1.0 - (1.0 - q)))
            got = float(gbdt._quantile_f32(torch.from_numpy(x), q))
            assert got == want, (n, q)


# ---- end to end, JAX's draws handed in ---------------------------------

@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.7, "bagging_freq": 2},
    {"bagging_fraction": 0.5, "bagging_freq": 1, "bagging_seed": 9},
    {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.8,
     "bagging_freq": 1},
    {"data_sample_strategy": "goss", "learning_rate": 0.5},
    {"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.3,
     "other_rate": 0.2},
    {"feature_fraction_bynode": 0.5},
    {"feature_fraction_bynode": 0.7, "feature_fraction": 0.8,
     "feature_fraction_seed": 5},
    {"bagging_fraction": 0.6, "bagging_freq": 1,
     "use_quantized_grad": True, "stochastic_rounding": False},
])
def test_sampling_end_to_end_matches_jax(params, jax_draws):
    jax_draws(params.get("bagging_seed", 3),
              params.get("feature_fraction_seed", 2))
    X, y = _data(2000, 6, seed=7)
    p = {"objective": "binary", "num_leaves": 12, "min_data_in_leaf": 10,
         "verbosity": -1, **params}
    ja, tb = _train_both(p, X, y, 4)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-5)


def test_multiclass_bagging_and_goss_match_jax(jax_draws):
    """K trees of an iteration share its bag; GOSS sums |g| * h over
    the classes."""
    jax_draws()
    X, y = _data(1800, 5, seed=8)
    y = np.digitize(np.nan_to_num(X[:, 0] + X[:, 1]), [-0.8, 0.8])
    for extra in ({"bagging_fraction": 0.6, "bagging_freq": 1},
                  {"data_sample_strategy": "goss", "learning_rate": 0.5}):
        p = {"objective": "multiclass", "num_class": 3, "num_leaves": 8,
             "min_data_in_leaf": 10, "verbosity": -1, **extra}
        ja, tb = _train_both(p, X, y, 3)
        _same_trees(ja, tb)


# ---- numpy draws: feature_fraction and DART, no hand-in ----------------

@pytest.mark.parametrize("params", [
    {"feature_fraction": 0.5},
    {"feature_fraction": 0.7, "feature_fraction_seed": 11},
    {"boosting": "dart", "skip_drop": 0.0},
    {"boosting": "dart", "skip_drop": 0.0, "uniform_drop": True,
     "drop_rate": 0.5},
    {"boosting": "dart", "skip_drop": 0.2, "xgboost_dart_mode": True,
     "drop_rate": 0.4, "drop_seed": 7},
    {"boosting": "dart", "skip_drop": 0.0, "max_drop": 1,
     "drop_rate": 0.9, "feature_fraction": 0.8},
])
def test_numpy_draws_match_jax_with_no_hand_in(params):
    X, y = _data(2000, 6, seed=9)
    p = {"objective": "binary", "num_leaves": 10, "verbosity": -1,
         "metric": "auc", **params}
    out = []
    for lgb, extra in ((jlgb, JAX), (tlgb, CPU)):
        d = lgb.Dataset(X[:1600], label=y[:1600], params={"max_bin": 63,
                                                          **extra})
        v = lgb.Dataset(X[1600:], label=y[1600:], reference=d)
        ev = {}
        bst = lgb.train({**p, **extra}, d, 5, valid_sets=[v],
                        callbacks=[lgb.record_evaluation(ev)])
        out.append((bst, ev))
    (ja, je), (tb, te) = out
    _same_trees(ja, tb)
    np.testing.assert_allclose(te["valid_0"]["auc"], je["valid_0"]["auc"],
                               rtol=1e-6)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-5)
    if params.get("boosting") == "dart":
        # DART rescaled earlier trees
        assert any(t.shrinkage < 0.1 - 1e-9 for t in tb._models)


def test_dart_multiclass_matches_jax():
    X, y = _data(1500, 5, seed=10)
    y = np.digitize(np.nan_to_num(X[:, 0] - X[:, 2]), [-0.6, 0.6])
    p = {"objective": "multiclass", "num_class": 3, "boosting": "dart",
         "skip_drop": 0.0, "drop_rate": 0.5, "num_leaves": 6,
         "verbosity": -1}
    ja, tb = _train_both(p, X, y, 4)
    _same_trees(ja, tb)


@pytest.mark.parametrize("params", [{"extra_trees": True},
                                    {"bagging_by_query": True},
                                    {"feature_contri": [1.0, 0.5, 1.0]},
                                    {"forcedbins_filename": "bins.json"}])
def test_accepted_but_unread_parameters_leave_trees_as_jax(params):
    """The JAX package accepts extra_trees, bagging_by_query,
    feature_contri and forcedbins_filename and no module reads them; the
    port does the same."""
    X, y = _data(1500, 5, seed=12)
    p = {"objective": "binary", "num_leaves": 10, "verbosity": -1}
    ja, tb = _train_both({**p, **params}, X, y, 3)
    _same_trees(ja, tb)
    _, plain = _train_both(p, X, y, 3)
    _same_trees(plain, tb)
