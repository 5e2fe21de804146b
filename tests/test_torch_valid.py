"""Evaluation during training in the port (lightgbm_tpu_torch: metrics.py,
ranking metrics, Dataset(reference=), init_score, valid-set scores,
callback.py, train's valid sets and init_model, cv) held against the
JAX package on the CPU.

The same numpy inputs go through both packages. Metric values agree to
1e-6 relative (both sum float32 scores), recorded histories to 1e-6,
trees exactly in structure and to rtol=1e-4, atol=1e-5 in leaf values.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.metrics import create_metrics as jax_create_metrics
from lightgbm_tpu.utils import log as jax_log
from lightgbm_tpu_torch import log as port_log
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.metrics import METRIC_ALIASES, create_metrics

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}


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


def _same_history(je, te):
    assert list(je) == list(te)
    for data in je:
        assert list(je[data]) == list(te[data]), data
        for metric in je[data]:
            np.testing.assert_allclose(te[data][metric], je[data][metric],
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{data} {metric}")


# ---- metrics ------------------------------------------------------------

class _Queries:
    """A dataset stand-in for the ranking metrics: query boundaries."""

    def __init__(self, qb):
        self.qb = qb

    def query_boundaries(self):
        return self.qb


def _metric_inputs(key, n=600, K=3, seed=0):
    """(raw [K', n] f32, label f32, weight f32, convert name) for a
    metric: probabilities for the binary family, positive predictions
    for the count and positive-valued families, K classes for the
    multiclass ones."""
    rs = np.random.RandomState(seed)
    w = (rs.rand(n) + 0.5).astype(np.float32)
    if key in ("multi_logloss", "multi_error", "auc_mu"):
        return (rs.randn(K, n).astype(np.float32),
                rs.randint(0, K, n).astype(np.float32), w, "softmax")
    raw = np.round(rs.randn(1, n), 1).astype(np.float32)   # some ties
    if key in ("binary_logloss", "binary_error", "auc",
               "average_precision"):
        return raw, (rs.rand(n) > 0.5).astype(np.float32), w, "sigmoid"
    if key in ("cross_entropy", "kldiv"):
        return raw, rs.rand(n).astype(np.float32), w, "sigmoid"
    if key in ("poisson", "gamma", "gamma_deviance", "tweedie",
               "cross_entropy_lambda"):
        return raw, (rs.rand(n) * 3 + 0.1).astype(np.float32), w, "exp"
    if key in ("ndcg", "map"):
        return raw, rs.randint(0, 4, n).astype(np.float32), w, "none"
    return raw, rs.randn(n).astype(np.float32), w, "none"


_JAX_CONVERT = {"sigmoid": jax.nn.sigmoid, "exp": jnp.exp,
                "softmax": lambda s: jax.nn.softmax(s, axis=0),
                "none": lambda s: s}
_PORT_CONVERT = {"sigmoid": torch.sigmoid, "exp": torch.exp,
                 "softmax": lambda s: torch.softmax(s, dim=0),
                 "none": lambda s: s}
_KEYS = sorted({v for v in METRIC_ALIASES.values() if v})


@pytest.mark.parametrize("key", _KEYS)
@pytest.mark.parametrize("weighted", [False, True])
def test_every_metric_matches_jax(key, weighted):
    params = {"metric": key, "eval_at": [1, 3], "alpha": 0.7,
              "fair_c": 0.5, "tweedie_variance_power": 1.3,
              "auc_mu_weights": [0, 1, 2, 1, 0, 1, 2, 1, 0]
              if key == "auc_mu" else []}
    jm = jax_create_metrics(JaxConfig.from_params(params))
    tm = create_metrics(Config.from_params(params))
    assert [(m.name, m.higher_better) for m in tm] == \
        [(m.name, m.higher_better) for m in jm]
    raw, label, w, conv = _metric_inputs(key)
    if not weighted:
        w = None
    qb = np.asarray([0, 7, 30, 31, 90, 200, 400, 600], np.int64)
    for a, b in zip(jm, tm):
        args_j = (jnp.asarray(raw), jnp.asarray(label),
                  None if w is None else jnp.asarray(w))
        args_t = (torch.from_numpy(raw), torch.from_numpy(label),
                  None if w is None else torch.from_numpy(w))
        if hasattr(a, "eval_with_query"):
            want = a.eval_with_query(*args_j, _Queries(qb),
                                     _JAX_CONVERT[conv])
            got = b.eval_with_query(*args_t, _Queries(qb),
                                    _PORT_CONVERT[conv])
        else:
            want = a.eval(*args_j, _JAX_CONVERT[conv])
            got = b.eval(*args_t, _PORT_CONVERT[conv])
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(want), rtol=1e-6, atol=1e-7,
                                   err_msg=f"{a.name} weighted={weighted}")


@pytest.mark.parametrize("params", [
    {"objective": "binary"}, {"objective": "regression"},
    {"objective": "multiclass", "num_class": 3},
    {"objective": "multiclassova", "num_class": 3},
    {"objective": "lambdarank", "eval_at": [2, 4]},
    {"objective": "binary", "metric": "none"},
    {"objective": "binary", "metric": ["auc", "binary", "mae", "l1"]},
    {"objective": "regression", "metrics": "rmse,l2_root,mape"},
    {"objective": "rank_xendcg", "metric": "map,ndcg"},
])
def test_metric_names_and_defaults_match_jax(params):
    jm = jax_create_metrics(JaxConfig.from_params(params))
    tm = create_metrics(Config.from_params(params))
    assert [(m.name, m.higher_better) for m in tm] == \
        [(m.name, m.higher_better) for m in jm]


def test_unknown_metric_raises_like_jax():
    with pytest.raises(ValueError, match="Unknown metric"):
        jax_create_metrics(JaxConfig.from_params({"metric": "nope"}))
    with pytest.raises(ValueError, match="Unknown metric"):
        create_metrics(Config.from_params({"metric": "nope"}))


# ---- Dataset(reference=) and init_score -----------------------------------

def _binary_data(n=1600, F=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    X[rs.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rs.randn(F) + 0.3 * rs.randn(n)) > 0) * 1.0
    return X, y


def test_valid_set_bins_equal_jax():
    X, y = _binary_data()
    Xv = np.random.RandomState(1).randn(500, 6) * 2      # wider range
    Xv[::7, 2] = np.nan
    p = {"max_bin": 31}
    jd = jlgb.Dataset(X, label=y, params=p)
    jv = jlgb.Dataset(Xv, label=y[:500], reference=jd).construct()
    td = tlgb.Dataset(X, label=y, params={**p, **CPU})
    tv = td.create_valid(Xv, label=y[:500]).construct()
    assert np.array_equal(tv.device_bins().to(torch.int64).numpy(),
                          np.asarray(jv.device_bins()).T)
    assert tv.mappers is td.mappers
    assert tv.get_feature_name() == td.get_feature_name()
    assert tv.num_data() == 500


# ---- recorded histories -----------------------------------------------------

def _rank_data(seed=0):
    rs = np.random.RandomState(seed)
    groups = rs.randint(5, 30, 60)
    n = int(groups.sum())
    X = rs.randn(n, 5)
    y = np.clip(np.round(X[:, 0] + 0.5 * rs.randn(n) + 1), 0, 3)
    return X, y, groups


def _train_both(params, X, y, Xv, yv, rounds, group=None, gv=None,
                jax_extra=None, port_extra=None, **kw):
    """The same training in both packages with one valid set and the
    train set in ``valid_sets``; their recorded histories."""
    out = []
    for lgb, extra in ((jlgb, {**JAX, **(jax_extra or {})}),
                       (tlgb, {**CPU, **(port_extra or {})})):
        d = lgb.Dataset(X, label=y, group=group,
                        params={"max_bin": 63, **extra})
        v = lgb.Dataset(Xv, label=yv, group=gv, reference=d)
        ev = {}
        bst = lgb.train({**params, **extra}, d, rounds,
                        valid_sets=[d, v], valid_names=["train", "held"],
                        callbacks=[lgb.record_evaluation(ev)], **kw)
        out.append((bst, ev))
    return out


@pytest.mark.parametrize("case", ["binary", "l2", "multiclass",
                                  "lambdarank"])
def test_record_evaluation_histories_match_jax(case):
    if case == "lambdarank":
        X, y, g = _rank_data()
        cut = int(g[:45].sum())
        args = (X[:cut], y[:cut], X[cut:], y[cut:])
        kw = dict(group=g[:45], gv=g[45:])
        params = {"objective": "lambdarank", "metric": ["ndcg", "map"],
                  "eval_at": [1, 3], "num_leaves": 7,
                  "min_data_in_leaf": 5}
    else:
        X, y = _binary_data(1800)
        kw = {}
        if case == "l2":
            y = np.nan_to_num(X[:, 0]) * 2 + np.nan_to_num(X[:, 1]) ** 2
            params = {"objective": "regression",
                      "metric": ["l2", "l1", "huber"]}
        elif case == "multiclass":
            y = np.digitize(np.nan_to_num(X[:, 0] + X[:, 1]), [-1, 0.5])
            params = {"objective": "multiclass", "num_class": 3,
                      "metric": ["multi_logloss", "multi_error"]}
        else:
            params = {"objective": "binary",
                      "metric": ["auc", "binary_logloss", "binary_error"]}
        params.update(num_leaves=10, verbosity=-1)
        args = (X[:1400], y[:1400], X[1400:], y[1400:])
    params["verbosity"] = -1
    (ja, je), (tb, te) = _train_both(params, *args, 4, **kw)
    _same_trees(ja, tb)
    _same_history(je, te)
    assert set(te) == {"train", "held"}
    assert tb.best_iteration == ja.best_iteration == 4
    assert tb.best_score.keys() == ja.best_score.keys()


def test_recorded_metric_equals_metric_of_predict():
    """The recorded valid AUC and log loss (summed float32 scores) equal
    the metrics of ``predict`` on the same rows to 1e-5."""
    from lightgbm_tpu_torch.metrics import auc, binary_logloss
    X, y = _binary_data(1800, seed=4)
    d = tlgb.Dataset(X[:1400], label=y[:1400], params=CPU)
    v = d.create_valid(X[1400:], label=y[1400:])
    ev = {}
    bst = tlgb.train({"objective": "binary", "num_leaves": 15,
                      "metric": "auc,binary_logloss", "verbosity": -1,
                      **CPU}, d, 6, valid_sets=[v],
                     callbacks=[tlgb.record_evaluation(ev)])
    p = torch.from_numpy(bst.predict(X[1400:]))
    lab = torch.from_numpy(y[1400:])
    assert abs(ev["valid_0"]["auc"][-1] - auc(p, lab)) < 1e-5
    assert abs(ev["valid_0"]["binary_logloss"][-1]
               - binary_logloss(p, lab)) < 1e-5
    # eval / eval_train / eval_valid give the same tuples
    assert bst.eval(v, "valid_0") == bst.eval_valid()
    assert [e[1] for e in bst.eval_train()] == ["auc", "binary_logloss"]


def test_feval_and_metric_freq_match_jax():
    X, y = _binary_data(1500, seed=2)

    def feval(score, ds):
        lab = np.asarray(ds.get_label())
        return [("mean_score", float(np.mean(score)), False),
                ("pos_score", float(np.mean(score[lab > 0])), True)]
    p = {"objective": "binary", "num_leaves": 8, "metric": "auc",
         "metric_freq": 2, "verbosity": -1}
    (ja, je), (tb, te) = _train_both(p, X[:1200], y[:1200], X[1200:],
                                     y[1200:], 5, feval=feval)
    _same_history(je, te)
    assert len(te["held"]["auc"]) == 3          # iterations 2, 4 and 5


# ---- callbacks ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(stopping_rounds=2),
    dict(stopping_rounds=2, first_metric_only=True),
    dict(stopping_rounds=3, min_delta=[0.002, 0.0]),
    dict(stopping_rounds=2, min_delta=0.01),
])
def test_early_stopping_matches_jax(kw):
    X, y = _binary_data(1500, seed=5)
    y = np.where(np.random.RandomState(0).rand(1500) < 0.3, 1 - y, y)
    p = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5,
         "learning_rate": 0.5, "metric": ["binary_logloss", "auc"],
         "verbosity": -1}
    res = []
    for lgb, extra in ((jlgb, JAX), (tlgb, CPU)):
        d = lgb.Dataset(X[:1000], label=y[:1000], params=extra)
        v = lgb.Dataset(X[1000:], label=y[1000:], reference=d)
        ev = {}
        bst = lgb.train({**p, **extra}, d, 12, valid_sets=[v],
                        callbacks=[lgb.record_evaluation(ev),
                                   lgb.early_stopping(verbose=False, **kw)])
        res.append((bst, ev))
    (ja, je), (tb, te) = res
    _same_history(je, te)
    assert tb.best_iteration == ja.best_iteration
    assert tb.best_iteration < 12
    assert tb.best_score.keys() == ja.best_score.keys()
    for data in ja.best_score:
        for m, val in ja.best_score[data].items():
            np.testing.assert_allclose(tb.best_score[data][m], val,
                                       rtol=1e-6)
    # predict uses best_iteration
    np.testing.assert_allclose(tb.predict(X[1000:]), ja.predict(X[1000:]),
                               rtol=1e-5, atol=1e-5)


def test_early_stopping_round_parameter_matches_jax():
    X, y = _binary_data(1500, seed=6)
    y = np.where(np.random.RandomState(1).rand(1500) < 0.3, 1 - y, y)
    p = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 3,
         "learning_rate": 0.8, "early_stopping_round": 2,
         "early_stopping_min_delta": 0.001, "verbosity": -1}
    (ja, _), (tb, _) = _train_both(p, X[:1000], y[:1000], X[1000:],
                                   y[1000:], 15)
    assert tb.best_iteration == ja.best_iteration < 15
    _same_trees(ja, tb)


def test_reset_parameter_gives_the_same_trees():
    X, y = _binary_data(1500, seed=7)
    lrs = [0.3, 0.1, 0.05, 0.2]
    p = {"objective": "binary", "num_leaves": 8, "verbosity": -1}
    (ja, je), (tb, te) = _train_both(
        p, X[:1200], y[:1200], X[1200:], y[1200:], 4)
    out = []
    for lgb, extra in ((jlgb, JAX), (tlgb, CPU)):
        d = lgb.Dataset(X[:1200], label=y[:1200], params=extra)
        v = lgb.Dataset(X[1200:], label=y[1200:], reference=d)
        ev = {}
        bst = lgb.train({**p, **extra}, d, 4, valid_sets=[v],
                        callbacks=[lgb.reset_parameter(learning_rate=lrs),
                                   lgb.record_evaluation(ev)])
        out.append((bst, ev))
    (ja2, je2), (tb2, te2) = out
    _same_trees(ja2, tb2)
    _same_history(je2, te2)
    assert [t.shrinkage for t in tb2._models] == pytest.approx(lrs)
    # the schedule changed the trees
    assert not np.allclose(tb2._models[1].leaf_value[:2],
                           tb._models[1].leaf_value[:2])


def _capture(mod):
    lines = []

    class H(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    logger = logging.getLogger(f"capture_{mod.__name__}")
    logger.handlers = [H()]
    logger.setLevel(logging.INFO)
    logger.propagate = False
    mod.register_logger(logger)
    return lines


def test_log_evaluation_prints_the_same_text():
    X, y = _binary_data(1500, seed=8)
    p = {"objective": "binary", "num_leaves": 8,
         "metric": ["auc", "binary_logloss"], "verbosity": 1}
    texts = []
    for lgb, mod, extra in ((jlgb, jax_log, JAX), (tlgb, port_log, CPU)):
        lines = _capture(mod)
        try:
            d = lgb.Dataset(X[:1200], label=y[:1200], params=extra)
            v = lgb.Dataset(X[1200:], label=y[1200:], reference=d)
            lgb.train({**p, **extra}, d, 6, valid_sets=[v],
                      valid_names=["val"],
                      callbacks=[lgb.log_evaluation(2),
                                 lgb.early_stopping(10)])
        finally:
            mod.register_logger(None)
        texts.append([ln for ln in lines if "[Info] [" in ln
                      or "best iteration" in ln or "'s " in ln])
    want, got = texts
    assert len(got) == len(want) >= 4

    def numbers(line):
        return [float(t) for t in line.replace("\t", " ").split()
                if t.replace(".", "", 1).replace("-", "", 1).isdigit()]
    for a, b in zip(want, got):
        # the same text, the metric values to 6 significant digits (%g)
        assert [t for t in a.split() if not t[0].isdigit()] == \
            [t for t in b.split() if not t[0].isdigit()]
        np.testing.assert_allclose(numbers(b), numbers(a), rtol=2e-5)


# ---- init_score and init_model ----------------------------------------------

@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_init_score_on_train_and_valid_matches_jax(objective):
    X, y = _binary_data(1500, seed=9)
    rs = np.random.RandomState(3)
    K = 1
    p = {"objective": objective, "num_leaves": 8, "verbosity": -1}
    if objective == "multiclass":
        K = 3
        y = np.digitize(np.nan_to_num(X[:, 0] - X[:, 2]), [-0.7, 0.7])
        p.update(num_class=3, metric="multi_logloss")
    init_t = (rs.randn(K * 1200) * 0.3)
    init_v = (rs.randn(K * 300) * 0.3)
    out = []
    for lgb, extra in ((jlgb, JAX), (tlgb, CPU)):
        d = lgb.Dataset(X[:1200], label=y[:1200], init_score=init_t,
                        params=extra)
        v = lgb.Dataset(X[1200:], label=y[1200:], reference=d,
                        init_score=init_v)
        ev = {}
        bst = lgb.train({**p, **extra}, d, 3, valid_sets=[v],
                        callbacks=[lgb.record_evaluation(ev)])
        out.append((bst, ev))
    (ja, je), (tb, te) = out
    _same_trees(ja, tb)
    _same_history(je, te)
    assert tb.train_set.get_init_score() is not None


@pytest.mark.parametrize("as_file", [False, True])
def test_init_model_continues_training_like_jax(as_file, tmp_path):
    X, y = _binary_data(1500, seed=10)
    p = {"objective": "binary", "num_leaves": 8, "metric": "auc",
         "verbosity": -1}
    out = []
    for lgb, extra in ((jlgb, JAX), (tlgb, CPU)):
        d = lgb.Dataset(X[:1200], label=y[:1200], params=extra)
        first = lgb.train({**p, **extra}, d, 2)
        init = first
        if as_file:
            init = str(tmp_path / f"{lgb.__name__}.txt")
            first.save_model(init)
        d2 = lgb.Dataset(X[:1200], label=y[:1200], params=extra)
        v = lgb.Dataset(X[1200:], label=y[1200:], reference=d2)
        ev = {}
        bst = lgb.train({**p, **extra}, d2, 3, valid_sets=[v],
                        init_model=init,
                        callbacks=[lgb.record_evaluation(ev)])
        out.append((bst, ev))
    (ja, je), (tb, te) = out
    assert tb.current_iteration() == 5
    _same_trees(ja, tb)
    _same_history(je, te)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-5)


# ---- cv ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(stratified=True, shuffle=True),
    dict(stratified=False, shuffle=True, eval_train_metric=True),
    dict(stratified=False, shuffle=False, metrics=["auc"]),
])
def test_cv_means_and_stdvs_match_jax(kw):
    X, y = _binary_data(1500, seed=11)
    p = {"objective": "binary", "num_leaves": 8, "verbosity": -1,
         "metric": "binary_logloss"}
    want = jlgb.cv({**p, **JAX}, jlgb.Dataset(X, label=y, params=JAX), 3,
                   nfold=3, seed=4, **kw)
    got = tlgb.cv({**p, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 3,
                  nfold=3, seed=4, **kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_cv_early_stopping_and_folds_match_jax():
    from lightgbm_tpu.engine import _make_n_folds as jax_folds
    from lightgbm_tpu_torch.engine import _make_n_folds as port_folds
    X, y = _binary_data(1200, seed=12)
    y = np.where(np.random.RandomState(2).rand(1200) < 0.35, 1 - y, y)
    jd = jlgb.Dataset(X, label=y, params=JAX)
    td = tlgb.Dataset(X, label=y, params=CPU)
    for strat in (True, False):
        for a, b in zip(jax_folds(jd, None, 4, {}, 7, strat, True),
                        port_folds(td, None, 4, 7, strat, True)):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    p = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 3,
         "learning_rate": 0.8, "verbosity": -1,
         "early_stopping_round": 2}
    want = jlgb.cv({**p, **JAX}, jd, 12, nfold=3, return_cvbooster=True)
    got = tlgb.cv({**p, **CPU}, td, 12, nfold=3, return_cvbooster=True)
    assert got["cvbooster"].best_iteration == \
        want["cvbooster"].best_iteration < 12
    for k in want:
        if k != "cvbooster":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert len(got["cvbooster"].current_iteration()) == 3
