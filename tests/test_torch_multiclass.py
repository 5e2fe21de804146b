"""Multiclass training in the port (lightgbm_tpu_torch: the softmax and
one-vs-all objectives, K trees per iteration in the boosting loop, [n, K]
prediction, model text with K trees per iteration, the multiclass
metrics) held against the JAX package on the CPU.

- gradients and hessians of both objectives: allclose at rtol=1e-6;
- ``lgb.train`` end to end, 3 classes, 1500 x 8, 15 leaves, 5 rounds:
  trees identical in ``split_feature``, ``threshold_bin`` and the
  training rows' leaves, leaf values at rtol=1e-4, atol=1e-5, ``[n, 3]``
  predictions allclose, model text that loads across the packages;
- quantized multiclass with round-to-nearest: identical trees;
- the reference model file ``tests/data/multiclass.model.txt``.

Every test passes ``device_type="cpu"`` to the port.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.metrics import AucMu, MultiError, MultiLogloss
from lightgbm_tpu.models.tree import Tree as JaxTree
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.metrics import auc_mu, multi_error, multi_logloss
from lightgbm_tpu_torch.objectives import create_objective

DATA = Path(__file__).resolve().parent / "data"
CPU = {"device_type": "cpu"}
K = 3


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
    """Drop the JAX programs this module compiled (configurations no
    other test uses) when it ends, so that they do not count against the
    process-wide jit signature budgets that later tests on the same
    worker check."""
    yield
    jax.clear_caches()


def _blobs(n=1500, f=8, k=K, seed=3):
    """examples/generate_data.py's multiclass shape: the nearest of k
    random centres."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    centers = rs.randn(k, f) * 1.5
    y = np.argmin(((X[:, None, :] - centers[None]) ** 2).sum(-1),
                  axis=1).astype(np.float64)
    return X, y


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("weighted", [False, True])
def test_grad_hess_matches_jax(objective, weighted):
    rs = np.random.RandomState(1)
    n = 1000
    score = rs.randn(K, n).astype(np.float32) * 2
    label = rs.randint(0, K, n).astype(np.float32)
    w = (rs.rand(n) + 0.5).astype(np.float32) if weighted else None
    p = {"objective": objective, "num_class": K, "sigmoid": 1.7}
    jo = jax_objective(JaxConfig.from_params(p))
    to = create_objective(Config.from_params(p))
    jg, jh = jo.grad_hess(jnp.asarray(score), jnp.asarray(label),
                          None if w is None else jnp.asarray(w))
    tg, th = to.grad_hess(torch.from_numpy(score), torch.from_numpy(label),
                          None if w is None else torch.from_numpy(w))
    assert tg.shape == (K, n)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(to.boost_from_score(label, w),
                                  jo.boost_from_score(label, w))
    np.testing.assert_allclose(
        to.convert_output(torch.from_numpy(score)).numpy(),
        np.asarray(jo.convert_output(jnp.asarray(score))), rtol=1e-6)


@pytest.mark.parametrize("params", [
    {"objective": "multiclass"},
    {"objective": "multiclassova", "num_class": 1},
    {"objective": "binary", "num_class": 3},
])
def test_num_class_rules_match_jax(params):
    with pytest.raises(ValueError) as want:
        JaxConfig.from_params(params)
    with pytest.raises(ValueError) as got:
        Config.from_params(params)
    assert str(got.value) == str(want.value)


def _train_pair(extra, rounds=5):
    X, y = _blobs()
    p = {"num_class": K, "num_leaves": 15, "verbosity": -1, **extra}
    ja = jlgb.train({**p, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y), num_boost_round=rounds)
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y),
                    num_boost_round=rounds)
    return X, ja, tb


@pytest.fixture(scope="module", params=["multiclass", "multiclassova"])
def pair(request):
    return _train_pair({"objective": request.param})


def _assert_same_trees(X, ja, tb):
    assert tb.num_model_per_iteration() == ja.num_model_per_iteration()
    assert len(tb._models) == len(ja._models)
    for a, b in zip(ja._models, tb._models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature", "threshold_bin", "threshold",
                     "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    # every training row in the same leaf of every tree
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True),
                                  ja.predict(X, pred_leaf=True))


def test_end_to_end_trees_match_jax(pair):
    X, ja, tb = pair
    assert len(tb._models) == 5 * K
    _assert_same_trees(X, ja, tb)


def test_end_to_end_predict_matches_jax(pair):
    X, ja, tb = pair
    p = tb.predict(X)
    assert p.shape == (len(X), K)
    np.testing.assert_allclose(p, ja.predict(X), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               ja.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    if tb._objective_str.startswith("multiclass "):
        np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=0, atol=1e-6)


def test_model_text_loads_across_packages(pair, tmp_path):
    X, ja, tb = pair
    assert tb.model_to_string().split("parameters:")[0].splitlines()[:7] \
        == ja.model_to_string().split("parameters:")[0].splitlines()[:7]
    tb.save_model(tmp_path / "port.txt")
    ja.save_model(str(tmp_path / "jax.txt"))
    j_from_t = jlgb.Booster(model_file=str(tmp_path / "port.txt"))
    t_from_j = tlgb.Booster(model_file=str(tmp_path / "jax.txt"),
                            params=CPU)
    assert t_from_j.num_model_per_iteration() == K
    np.testing.assert_allclose(j_from_t.predict(X), tb.predict(X), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t_from_j.predict(X), ja.predict(X), rtol=0,
                               atol=1e-6)


def test_pred_leaf_and_num_iteration_count_iterations(pair):
    X, ja, tb = pair
    leaves = tb.predict(X, pred_leaf=True, num_iteration=2)
    assert leaves.shape == (len(X), 2 * K)
    np.testing.assert_array_equal(
        leaves, ja.predict(X, pred_leaf=True, num_iteration=2))
    for kw in ({"num_iteration": 2}, {"start_iteration": 1,
                                      "num_iteration": 3}):
        np.testing.assert_allclose(tb.predict(X, raw_score=True, **kw),
                                   ja.predict(X, raw_score=True, **kw),
                                   rtol=1e-5, atol=1e-5)
    # three iterations of three trees: the first nine trees by hand
    by_hand = np.zeros((len(X), K))
    lv = tb.predict(X, pred_leaf=True, num_iteration=3)
    for i, t in enumerate(tb._models[:3 * K]):
        by_hand[:, i % K] += t.leaf_value[lv[:, i]]
    np.testing.assert_allclose(tb.predict(X, raw_score=True,
                                          num_iteration=3), by_hand,
                               rtol=1e-5, atol=1e-6)
    assert tb.current_iteration() == 5
    assert tb.model_to_string(num_iteration=2).count("Tree=") == 2 * K


def test_interop_carries_the_model_both_ways(pair):
    """The JAX model's trees, handed over as plain fields, give the same
    predictions in the port; the port's, handed back, give JAX trees
    that write the same text."""
    X, ja, tb = pair
    fields = dict(
        trees=[{f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
               for t in ja._models],
        num_class=ja._num_class, objective=ja._objective_str,
        feature_names=ja._feature_names, feature_infos=ja._feature_infos)
    carried = interop.booster_from_fields(fields, params=CPU)
    assert carried.num_model_per_iteration() == K
    np.testing.assert_allclose(carried.predict(X), ja.predict(X), rtol=0,
                               atol=1e-6)
    back = interop.booster_fields(tb)
    assert back["num_tree_per_iteration"] == K
    assert back["objective"] == ja._objective_str
    for i, (t, d) in enumerate(zip(tb._models, back["trees"])):
        assert JaxTree(**d).to_string(i) == t.to_string(i)


def test_quantized_multiclass_matches_jax():
    X, ja, tb = _train_pair({"objective": "multiclass",
                             "use_quantized_grad": True,
                             "stochastic_rounding": False}, rounds=3)
    _assert_same_trees(X, ja, tb)


def test_reference_model_file_predicts_like_jax():
    path = str(DATA / "multiclass.model.txt")
    jb = jlgb.Booster(model_file=path)
    tb = tlgb.Booster(model_file=path, params=CPU)
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration() == 5
    rs = np.random.RandomState(11)
    X = rs.randn(600, 28) * 1.5
    X[rs.rand(600, 28) < 0.03] = np.nan
    p = tb.predict(X)
    assert p.shape == (600, 5)
    np.testing.assert_allclose(p, jb.predict(X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True,
                                             num_iteration=7),
                                  jb.predict(X, pred_leaf=True,
                                             num_iteration=7))


@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_metrics_match_jax(weighted):
    rs = np.random.RandomState(7)
    n, k = 1200, 4
    raw = np.round(rs.randn(k, n), 1).astype(np.float32)   # ties
    label = rs.randint(0, k, n).astype(np.float32)
    w = (rs.rand(n) + 0.5).astype(np.float32) if weighted else None
    cfg = JaxConfig.from_params({"objective": "multiclass", "num_class": k,
                                 "multi_error_top_k": 2})
    conv = jax_objective(cfg).convert_output
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    prob = conv(jnp.asarray(raw))
    tprob = torch.from_numpy(np.asarray(prob).T.copy())
    tl = torch.from_numpy(label)
    want = float(MultiLogloss(cfg).eval(jnp.asarray(raw), jnp.asarray(label),
                                        jw, conv))
    assert abs(multi_logloss(tprob, tl, tw) - want) < 1e-6
    for top_k in (1, 2):
        c = JaxConfig.from_params({"objective": "multiclass",
                                   "num_class": k,
                                   "multi_error_top_k": top_k})
        want = float(MultiError(c).eval(jnp.asarray(raw), jnp.asarray(label),
                                        jw, conv))
        assert abs(multi_error(tprob, tl, tw, top_k) - want) < 1e-6
    W = rs.rand(k * k).round(2).tolist()
    for mu_w in ([], W):
        c = JaxConfig.from_params({"objective": "multiclass",
                                   "num_class": k, "auc_mu_weights": mu_w})
        want = float(AucMu(c).eval(raw, label, w, conv))
        got = auc_mu(torch.from_numpy(raw.T.copy()), tl, tw, mu_w)
        # the JAX metric returns its float64 sum as a float32 array
        assert abs(got - want) < 1e-6


def test_model_text_trees_per_iteration_must_be_num_class():
    text = (DATA / "multiclass.model.txt").read_text()
    bad = text.replace("num_tree_per_iteration=5", "num_tree_per_iteration=1",
                       1)
    with pytest.raises(ValueError, match="num_tree_per_iteration=1"):
        tlgb.Booster(model_str=bad, params=CPU)
    assert tlgb.Booster(model_str=text,
                        params=CPU).num_model_per_iteration() == 5
