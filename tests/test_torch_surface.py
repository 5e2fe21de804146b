"""The port's Python surface held against the JAX package on the CPU:
text files (CSV, TSV, LibSVM, header, label column, companion files) on
the native and the numpy path, binary datasets across the packages,
custom objectives, the rest of ``Dataset`` and ``Booster`` (rollback,
JSON dump, data frame, leaf outputs, bounds, split histograms,
shuffling, attributes, copies), ``refit``, ``cv(init_model=)`` and the
refusals that name a ROADMAP.md item.

The same numpy inputs go through both packages at a small size. XLA's
float root totals are handed to the grower where trees are compared
(``tests/test_torch_objectives.py`` says why).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu.utils.native as jax_native
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.utils.native as port_native
from lightgbm_tpu.basic import _load_text_file as jax_load_text
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu_torch.basic import _load_text_file as port_load_text
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import grow

CPU = {"device_type": "cpu", "verbosity": -1}
JAX = {"hist_method": "scatter", "verbosity": -1}


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


def _data(n=1200, F=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    X[rs.rand(n, F) < 0.05] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)
    y = ((np.nan_to_num(X) @ rs.randn(F) + 0.3 * rs.randn(n)) > 0) * 1.0
    return X, y


def _trees(bst):
    return bst.model_to_string().split("end of trees")[0]


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


P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10}


# ---- text files ------------------------------------------------------------

def _write_text(tmp_path, fmt):
    rs = np.random.RandomState(1)
    X = np.round(rs.randn(60, 4), 5)
    X[rs.rand(60, 4) < 0.1] = np.nan
    y = (rs.rand(60) > 0.5) * 1.0
    path = str(tmp_path / f"data.{fmt}")
    params = {}
    if fmt == "libsvm":
        with open(path, "w") as f:
            for yi, row in zip(y, np.nan_to_num(X)):
                f.write(f"{yi:g} " + " ".join(
                    f"{j}:{v:g}" for j, v in enumerate(row) if v != 0)
                    + "\n")
    else:
        sep = "\t" if fmt == "tsv" else ","
        arr = np.column_stack([y, X])
        if fmt in ("header", "name"):
            # the label in column 2, named in a header line
            arr = np.column_stack([X[:, :2], y, X[:, 2:]])
            params = {"header": True,
                      "label_column": "name:target" if fmt == "name" else 2}
            hdr = sep.join(["a", "b", "target", "c", "d"])
            np.savetxt(path, arr, delimiter=sep, fmt="%.6g", header=hdr,
                       comments="")
        else:
            np.savetxt(path, arr, delimiter=sep, fmt="%.6g")
    if fmt == "csv":
        np.savetxt(path + ".weight", rs.rand(60) + 0.5, fmt="%.6g")
        np.savetxt(path + ".query", [20, 25, 15], fmt="%d")
    return path, params


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("fmt", ["csv", "tsv", "libsvm", "header", "name"])
def test_text_files_load_like_jax(fmt, native, tmp_path, monkeypatch):
    path, params = _write_text(tmp_path, fmt)
    if not native:
        monkeypatch.setattr(jax_native, "parse_dense_text",
                            lambda *a: None)
        monkeypatch.setattr(port_native, "parse_dense_text",
                            lambda *a: None)
    elif fmt != "libsvm":
        assert port_native.library() is not None
    want = jax_load_text(path, JaxConfig.from_params(params))
    got = port_load_text(path, Config.from_params(params))
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    if fmt == "csv":
        assert got[2] is not None and got[3] is not None


def test_dataset_from_a_file_bins_like_jax(tmp_path):
    path, _ = _write_text(tmp_path, "csv")
    jd = jlgb.Dataset(path).construct()
    td = tlgb.Dataset(path, params=CPU).construct()
    np.testing.assert_array_equal(td.host_bins(), jd._bins)
    np.testing.assert_array_equal(td.get_label(), jd.get_label())
    np.testing.assert_array_equal(td.get_weight(), jd.get_weight())
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    # a valid set from a file, with the train set's mappers
    jv = jd.create_valid(path).construct()
    tv = td.create_valid(path).construct()
    np.testing.assert_array_equal(tv.host_bins(), jv._bins)


def test_name_label_column_needs_a_header(tmp_path):
    path, _ = _write_text(tmp_path, "name")
    with pytest.raises(tlgb.LightGBMError, match="header=true"):
        port_load_text(path, Config.from_params(
            {"label_column": "name:target"}))


# ---- binary files ----------------------------------------------------------

def test_binary_files_cross_load_and_train_alike(tmp_path):
    X, y = _data()
    w = np.random.RandomState(3).rand(len(y)) + 0.5
    jd = jlgb.Dataset(X, label=y, weight=w).construct()
    td = tlgb.Dataset(X, label=y, weight=w, params=CPU).construct()
    jd.save_binary(str(tmp_path / "jax.bin"))
    td.save_binary(str(tmp_path / "port.bin"))
    in_port = tlgb.Dataset(str(tmp_path / "jax.bin"), params=CPU).construct()
    in_jax = jlgb.Dataset(str(tmp_path / "port.bin")).construct()
    np.testing.assert_array_equal(in_port.host_bins(), jd._bins)
    np.testing.assert_array_equal(in_jax._bins, td.host_bins())
    for ds, ref in ((in_port, jd), (in_jax, td)):
        assert [m.to_dict() for m in ds.mappers] == \
            [m.to_dict() for m in ref.mappers]
        np.testing.assert_array_equal(ds.get_weight(), w)
    ja = jlgb.train({**P, **JAX}, in_jax, 3)
    tb = tlgb.train({**P, **CPU}, in_port, 3)
    _same_trees(ja, tb)
    # a valid set saved by one package loads against the other's train
    # set; a differently binned one is refused
    jd.create_valid(X[:300], label=y[:300]).construct().save_binary(
        str(tmp_path / "valid.bin"))
    tv = tlgb.Dataset(str(tmp_path / "valid.bin"), reference=in_port,
                      params=CPU).construct()
    assert tv.num_data() == 300
    other = tlgb.Dataset(X[:, ::-1].copy(), label=y, params=CPU)
    with pytest.raises(tlgb.LightGBMError, match="binned differently"):
        tlgb.Dataset(str(tmp_path / "valid.bin"), reference=other,
                     params=CPU).construct()


# ---- custom objectives -----------------------------------------------------

def _logloss(preds, data):
    y = data.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


def _huberish(preds, data):
    r = preds - data.get_label()
    return np.clip(r, -1.0, 1.0), np.ones_like(r)


@pytest.mark.parametrize("fobj", [_logloss, _huberish])
def test_custom_objective_trees_match_jax(fobj):
    X, y = _data(seed=2)
    p = {**P, "objective": "none"}
    ja = jlgb.train({**p, **JAX}, jlgb.Dataset(X, label=y), 3, fobj=fobj)
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 3,
                    fobj=fobj)
    _same_trees(ja, tb)
    assert _trees(ja) == _trees(tb)
    # objective none: raw scores, no metric
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-6)
    assert tb._metrics == [] and tb._objective_str == "custom"


def test_objective_none_without_fobj_raises_in_both():
    X, y = _data(n=200)
    with pytest.raises(jlgb.LightGBMError, match="fobj"):
        jlgb.train({"objective": "none", **JAX}, jlgb.Dataset(X, label=y), 1)
    with pytest.raises(tlgb.LightGBMError, match="fobj"):
        tlgb.train({"objective": "none", **CPU},
                   tlgb.Dataset(X, label=y, params=CPU), 1)


# ---- Booster methods -------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """A 4-iteration binary model trained by the port, loaded in both
    packages from its text."""
    X, y = _data(seed=4)
    tb = tlgb.train({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 4)
    text = tb.model_to_string()
    return X, y, jlgb.Booster(model_str=text), \
        tlgb.Booster(model_str=text, params=CPU)


def test_dump_and_data_frame_match_jax(pair):
    X, y, jb, tb = pair
    assert tb.dump_model() == jb.dump_model()
    assert tb.dump_model(num_iteration=2, start_iteration=1) == \
        jb.dump_model(num_iteration=2, start_iteration=1)
    import pandas as pd
    pd.testing.assert_frame_equal(tb.trees_to_dataframe(),
                                  jb.trees_to_dataframe())


def test_leaf_outputs_bounds_and_histograms_match_jax(pair):
    X, y, jb, tb = pair
    assert tb.lower_bound() == jb.lower_bound()
    assert tb.upper_bound() == jb.upper_bound()
    assert tb.get_leaf_output(2, 3) == jb.get_leaf_output(2, 3)
    assert tb.feature_name() == jb.feature_name()
    for feat in (0, "Column_3"):
        h1, e1 = tb.get_split_value_histogram(feat, bins=5)
        h2, e2 = jb.get_split_value_histogram(feat, bins=5)
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_array_equal(e1, e2)
    import pandas as pd
    pd.testing.assert_frame_equal(
        tb.get_split_value_histogram(1, xgboost_style=True),
        jb.get_split_value_histogram(1, xgboost_style=True))
    a, b = copy.deepcopy(tb), copy.copy(jb)
    a.set_leaf_output(0, 1, 0.25)
    b.set_leaf_output(0, 1, 0.25)
    np.testing.assert_allclose(a.predict(X), b.predict(X), rtol=1e-6)
    assert tb.get_leaf_output(0, 1) != 0.25          # a copy was edited


def test_shuffle_models_attrs_and_copies_match_jax(pair):
    X, y, jb, tb = pair
    a = tlgb.Booster.model_from_string(tb.model_to_string(), CPU)
    b = jlgb.Booster.model_from_string(tb.model_to_string())
    np.random.seed(7)
    a.shuffle_models(1, 4)
    np.random.seed(7)
    b.shuffle_models(1, 4)
    assert _trees(a) == _trees(b)
    assert _trees(a) != _trees(tb)
    tb.set_attr(note="x", run=1)
    assert (tb.attr("note"), tb.attr("run")) == ("x", "1")
    tb.set_attr(note=None)
    assert tb.attr("note") is None
    c = copy.copy(tb)
    assert _trees(c) == _trees(tb) and c is not tb
    assert tb.free_dataset().train_set is None


def test_rollback_restores_the_scores_like_jax():
    X, y = _data(seed=5)
    Xv, yv = _data(n=300, seed=6)
    p = {**P, "metric": "binary_logloss"}
    jd = jlgb.Dataset(X, label=y)
    td = tlgb.Dataset(X, label=y, params=CPU)
    ja = jlgb.train({**p, **JAX}, jd, 2,
                    valid_sets=[jd.create_valid(Xv, label=yv)])
    tb = tlgb.train({**p, **CPU}, td, 2,
                    valid_sets=[td.create_valid(Xv, label=yv)])
    s0 = tb._engine.score.clone()
    v0 = tb._engine.valid_sets[0].score.clone()
    ja.update()
    tb.update()
    ja.rollback_one_iter()
    tb.rollback_one_iter()
    assert tb.current_iteration() == ja.current_iteration() == 2
    torch.testing.assert_close(tb._engine.score, s0, rtol=0, atol=1e-6)
    torch.testing.assert_close(tb._engine.valid_sets[0].score, v0, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tb._engine.current_score(0),
                               np.asarray(ja._engine.score), atol=1e-6)
    assert [r[2] for r in tb.eval_valid()] == pytest.approx(
        [r[2] for r in ja.eval_valid()], rel=1e-5)
    # both go on to grow the same third tree
    ja.update()
    tb.update()
    _same_trees(ja, tb)
    # rolling back to nothing restores the init score
    for _ in range(3):
        tb.rollback_one_iter()
    init = float(tb._engine.init_score[0])
    torch.testing.assert_close(tb._engine.score,
                               torch.full_like(s0, init), rtol=0, atol=1e-6)


def test_reset_parameter_changes_the_next_trees_like_jax():
    X, y = _data(seed=8)
    ja = jlgb.train({**P, **JAX}, jlgb.Dataset(X, label=y), 1)
    tb = tlgb.train({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 1)
    for b in (ja, tb):
        b.reset_parameter({"learning_rate": 0.3})
        b.update()
    _same_trees(ja, tb)
    assert tb.params["learning_rate"] == 0.3


# ---- refit -----------------------------------------------------------------

@pytest.mark.parametrize("objective", ["binary", "regression",
                                       "multiclass"])
def test_refit_matches_jax(objective):
    X, y = _data(seed=9)
    extra = {}
    if objective == "regression":
        y = np.nan_to_num(X) @ np.arange(6) / 6.0
    elif objective == "multiclass":
        y = (np.nan_to_num(X[:, 0]) > 0) + (np.nan_to_num(X[:, 1]) > 0.5)
        # a loaded model refits from its params: both packages need the
        # class count there
        extra = {"objective": "multiclass", "num_class": 3}
    p = {**P, "objective": objective, **extra}
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 3)
    text = tb.model_to_string()
    Xn, _ = _data(n=500, seed=10)
    yn = y[:500]
    w = np.random.RandomState(11).rand(500) + 0.5
    got = tlgb.Booster(model_str=text, params={**CPU, **extra}).refit(
        Xn, yn, decay_rate=0.7, weight=w)
    want = jlgb.Booster(model_str=text, params=extra).refit(
        Xn, yn, decay_rate=0.7, weight=w)
    for a, b in zip(got._models, want._models):
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-6,
                                   atol=1e-12)
    np.testing.assert_allclose(got.predict(Xn), want.predict(Xn),
                               rtol=1e-5, atol=1e-6)
    # a trained booster refits from its own parameters
    own = tb.refit(Xn, yn, decay_rate=0.7, weight=w)
    assert _trees(own) == _trees(got)


def test_refit_of_a_custom_model_raises():
    X, y = _data(n=300)
    tb = tlgb.train({**P, "objective": "none", **CPU},
                    tlgb.Dataset(X, label=y, params=CPU), 1, fobj=_logloss)
    with pytest.raises(tlgb.LightGBMError, match="built-in objective"):
        tb.refit(X, y)


# ---- Dataset methods -------------------------------------------------------

def test_dataset_methods_match_jax():
    X, y = _data(seed=12)
    jd = jlgb.Dataset(X, label=y, free_raw_data=False).construct()
    td = tlgb.Dataset(X, label=y, params=CPU, free_raw_data=False
                      ).construct()
    assert td.num_features() == jd.num_features()
    for d in (jd, td):
        d.set_field("weight", np.full(len(y), 2.0))
        d.set_field("init_score", np.zeros(len(y)))
    np.testing.assert_array_equal(td.get_field("weight"),
                                  jd.get_field("weight"))
    with pytest.raises(tlgb.LightGBMError):
        td.get_field("nope")
    js, ts = jd.subset(np.arange(100, 400)), td.subset(np.arange(100, 400))
    np.testing.assert_array_equal(ts.host_bins(), js._bins)
    np.testing.assert_array_equal(ts.get_data(), js.get_data())
    assert ts.num_data() == 300 and td in ts.get_ref_chain()
    np.testing.assert_array_equal(
        td.thresholds_to_bins(np.array([0, 2]), np.array([0.1, -0.3])),
        jd.thresholds_to_bins(np.array([0, 2]), np.array([0.1, -0.3])))
    np.testing.assert_array_equal(td.feat_nan_bin(),
                                  np.asarray(jd.device_feat_nan_bin()))
    # two halves of the columns stacked again bin and train as one
    ja, jb = (jlgb.Dataset(X[:, s].copy(), label=y).construct()
              for s in (slice(0, 3), slice(3, 6)))
    ta, tb = (tlgb.Dataset(X[:, s].copy(), label=y, params=CPU).construct()
              for s in (slice(0, 3), slice(3, 6)))
    ja.add_features_from(jb)
    ta.add_features_from(tb)
    np.testing.assert_array_equal(ta.host_bins(), ja._bins)
    assert ta.get_feature_name() == ja.get_feature_name()
    _same_trees(jlgb.train({**P, **JAX}, ja, 2),
                tlgb.train({**P, **CPU}, ta, 2))
    # before construction: names and the reference can change
    nd = tlgb.Dataset(X, label=y, params=CPU)
    nd.set_feature_name([f"f{i}" for i in range(6)]).set_reference(td)
    assert nd.construct().get_feature_name() == td.get_feature_name()
    with pytest.raises(tlgb.LightGBMError, match="constructed"):
        nd.set_reference(td)


def test_cv_accepts_init_model_unread_like_jax():
    """cv(init_model=...) trains every fold from scratch in both packages
    (ROADMAP.md Queue 3)."""
    X, y = _data(n=600, seed=13)
    base = tlgb.train({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 2)
    kw = dict(num_boost_round=2, nfold=3, seed=1)
    t0 = tlgb.cv({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), **kw)
    t1 = tlgb.cv({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU),
                 init_model=base, **kw)
    j1 = jlgb.cv({**P, **JAX}, jlgb.Dataset(X, label=y),
                 init_model=jlgb.Booster(model_str=base.model_to_string()),
                 **kw)
    assert t0 == t1
    for k in t1:
        np.testing.assert_allclose(t1[k], j1[k], rtol=1e-4, atol=1e-7)


def test_predict_accepts_validate_features_unread_like_jax():
    """predict(validate_features=True) predicts as without it in both
    packages (ROADMAP.md Queue 3)."""
    X, y = _data(n=400, seed=14)
    tb = tlgb.train({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 2)
    jb = jlgb.Booster(model_str=tb.model_to_string())
    want = tb.predict(X)
    np.testing.assert_array_equal(tb.predict(X, validate_features=True),
                                  want)
    np.testing.assert_allclose(jb.predict(X, validate_features=True), want,
                               rtol=1e-6, atol=1e-7)


# ---- refusals that name their ROADMAP item ---------------------------------

class _Rows(tlgb.Sequence):
    def __getitem__(self, idx):
        return np.array([[0.0, 1.0]])[idx]

    def __len__(self):
        return 1


def _arrow_dataset():
    pa = pytest.importorskip("pyarrow")
    return tlgb.Dataset(pa.table({"a": [0.0, 1.0], "b": [1.0, 0.0]}),
                        label=[0, 1], params=CPU).construct()


def _pushed():
    ds = tlgb.Dataset.init_streaming(2, 2, params=CPU)
    return ds.push_rows(np.eye(2), label=[0, 1]).mark_finished()


@pytest.mark.parametrize("call,item,match", [
    pytest.param(lambda: tlgb.Dataset(np.zeros((2, 2)), label=[0, 1])
                 .push_rows(np.zeros((1, 2))), "18",
                 "requires a Dataset.init_streaming", id="call0-18"),
    pytest.param(lambda: tlgb.Dataset(np.zeros((2, 2)), label=[0, 1])
                 .mark_finished(), "18",
                 "requires a Dataset.init_streaming", id="call1-18"),
    pytest.param(lambda: tlgb.Dataset.init_streaming(1, 2, params=CPU)
                 .push_rows(np.ones((2, 2))), "18",
                 "beyond the declared num_rows", id="call2-18"),
    pytest.param(lambda: tlgb.Dataset.init_streaming(2, 2, params=CPU)
                 .push_rows(np.ones((1, 2)), label=[1]).mark_finished(),
                 "18", "1 unpushed rows", id="call3-18"),
    pytest.param(lambda: tlgb.Dataset(_Rows(), label=[0], params=CPU,
                                      categorical_feature=["a"])
                 .construct(), "18", "cannot be resolved",
                 id="call4-18"),
])
def test_streaming_and_placement_are_refused(call, item, match):
    """Misuse of the streaming API (item 18, ported) is refused with the
    JAX package's LightGBMError."""
    with pytest.raises(tlgb.LightGBMError, match=match):
        call()


@pytest.mark.parametrize("call", [
    lambda: tlgb.Dataset.init_streaming(10, 2).push_rows(np.ones((1, 2))),
    _pushed,
    lambda: tlgb.Dataset(_Rows(), label=[0], params=CPU).construct(),
    _arrow_dataset,
])
def test_streaming_apis_construct(call):
    """The push API, a Sequence and an Arrow table give a Dataset."""
    assert isinstance(call(), tlgb.Dataset)


def test_booster_refusals_name_their_items(pair, tmp_path):
    X, y, _, tb = pair
    # compile is in the port (item 19, first part), and so is the
    # network (item 20): one machine joins nothing, as in the JAX package
    eager = tb.predict(X)
    cf = tb.compile()
    np.testing.assert_array_equal(cf.predict(X), eager)
    tb._compiled_forest = None
    assert tb.set_network("127.0.0.1:1") is tb
    assert tb.free_network() is tb
    # keep_training_booster is accepted and changes nothing
    a = tlgb.train({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 1,
                   keep_training_booster=True)
    b = tlgb.train({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 1)
    assert _trees(a) == _trees(b)
    # resume_from is in the port (item 21): a directory without
    # snapshots trains from scratch
    r = tlgb.train({**P, **CPU}, tlgb.Dataset(X, label=y, params=CPU), 1,
                   resume_from=str(tmp_path / "ckpt"))
    assert _trees(r) == _trees(b)
