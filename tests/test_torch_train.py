"""The port's public path (lightgbm_tpu_torch: Dataset, train, Booster,
model text, interop) held against the JAX package on the CPU.

Every test passes ``device_type="cpu"`` to the port: its default is the
GPU, and it raises when there is none (tested below).
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.models.tree import tree_from_arrays as jax_tree_from_arrays
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu.ops.grow import GrowConfig as JaxGrowConfig
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models.tree import tree_from_arrays
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops.binning import bin_matrix

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
CPU = {"device_type": "cpu"}


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


def _nan_data(n=3000, F=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    X[rs.rand(n, F) < 0.1] = np.nan
    X[:, 2] = np.round(X[:, 2] * 2)          # few distinct values
    X[rs.rand(n) < 0.3, 4] = 0.0              # many zeros
    y = ((np.nan_to_num(X) @ rs.randn(F)) > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("params", [
    {"max_bin": 63},
    {"max_bin": 255, "zero_as_missing": True},
    {"max_bin": 300, "min_data_in_bin": 1},
    {"max_bin": 31, "bin_construct_sample_cnt": 1000},
])
def test_bins_identical_to_jax(params):
    X, y = _nan_data()
    jds = jlgb.Dataset(X, label=y, params=params).construct()
    tds = tlgb.Dataset(X, label=y, params={**params, **CPU}).construct()
    want = np.asarray(jds.device_bins()).T
    got = tds.device_bins()
    assert got.shape == want.shape
    assert np.array_equal(got.to(torch.int64).numpy(), want)
    assert got.dtype == (torch.uint8 if want.dtype == np.uint8
                         else torch.uint16)
    assert np.array_equal(tds.used_feature_indices(),
                          jds.used_feature_indices())
    for a, b in zip(tds.mappers, jds.mappers):
        assert a.to_dict() == b.to_dict()
    nan_j = np.asarray(jds.device_feat_nan_bin())
    assert np.array_equal(tds.feat_nan_bin(), nan_j)
    assert tds.feature_infos() == jds.feature_infos()


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("weighted", [False, True])
def test_grad_hess_matches_jax(objective, weighted):
    rs = np.random.RandomState(1)
    n = 1000
    score = rs.randn(n).astype(np.float32)
    label = (rs.rand(n) > 0.4).astype(np.float32) if objective == "binary" \
        else rs.randn(n).astype(np.float32)
    w = (rs.rand(n) + 0.5).astype(np.float32) if weighted else None
    extra = {"is_unbalance": True} if objective == "binary" else {}
    jo = jax_objective(JaxConfig.from_params({"objective": objective,
                                              **extra}))
    to = create_objective(Config.from_params({"objective": objective,
                                              **extra}))
    if objective == "binary":
        jo.init_label_weights(label, w)
        to.init_label_weights(label, w)
    jg, jh = jo.grad_hess(jnp.asarray(score), jnp.asarray(label),
                          None if w is None else jnp.asarray(w))
    tg, th = to.grad_hess(torch.from_numpy(score), torch.from_numpy(label),
                          None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(to.boost_from_score(label, w),
                                  jo.boost_from_score(label, w))


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


def test_end_to_end_binary_matches_jax():
    """The test_engine_end_to_end_pallas_matches_scatter setup."""
    rs = np.random.RandomState(9)
    X = rs.randn(2500, 8).astype(np.float32)
    y = ((X @ rs.randn(8)) > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 12, "max_bin": 63,
         "verbosity": -1}
    ja = jlgb.train({**p, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y, params={"max_bin": 63}),
                    num_boost_round=4)
    tb = tlgb.train({**p, **CPU},
                    tlgb.Dataset(X, label=y, params={"max_bin": 63}),
                    num_boost_round=4)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               ja.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_end_to_end_regression_with_nan_matches_jax():
    X, _ = _nan_data(2000, 6, seed=3)
    y = np.nan_to_num(X[:, 0]) * 2 + np.nan_to_num(X[:, 1]) ** 2
    p = {"objective": "regression", "num_leaves": 8, "max_bin": 31,
         "min_data_in_leaf": 10, "learning_rate": 0.3, "verbosity": -1}
    ja = jlgb.train({**p, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y), num_boost_round=3)
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y),
                    num_boost_round=3)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    rs = np.random.RandomState(4)
    X = rs.randn(1500, 5)
    X[rs.rand(1500, 5) < 0.05] = np.nan
    y = ((np.nan_to_num(X) @ rs.randn(5)) > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 10, "verbosity": -1}
    ja = jlgb.train({**p, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y), num_boost_round=3)
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y),
                    num_boost_round=3)
    return X, ja, tb


def test_model_text_loads_across_packages(pair, tmp_path):
    X, ja, tb = pair
    tb.save_model(tmp_path / "port.txt")
    ja.save_model(str(tmp_path / "jax.txt"))
    j_from_t = jlgb.Booster(model_file=str(tmp_path / "port.txt"))
    t_from_j = tlgb.Booster(model_file=str(tmp_path / "jax.txt"),
                            params=CPU)
    np.testing.assert_allclose(j_from_t.predict(X), tb.predict(X),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_from_j.predict(X), ja.predict(X),
                               rtol=0, atol=1e-6)
    # the layout is the same line for line up to the parameters block
    a = ja.model_to_string().split("parameters:")[0]
    b = tb.model_to_string().split("parameters:")[0]
    assert [ln.split("=")[0] for ln in a.splitlines()] == \
        [ln.split("=")[0] for ln in b.splitlines()]


def test_pred_leaf_matches_jax(pair):
    X, ja, tb = pair
    np.testing.assert_array_equal(tb.predict(X, pred_leaf=True),
                                  ja.predict(X, pred_leaf=True))


@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_jax(weighted):
    from lightgbm_tpu.metrics import auc_jnp
    from lightgbm_tpu_torch.metrics import auc, binary_logloss
    rs = np.random.RandomState(2)
    n = 2000
    label = (rs.rand(n) > 0.5).astype(np.float64)
    score = np.round(rs.randn(n) + label, 1)      # ties on purpose
    prob = 1.0 / (1.0 + np.exp(-score))
    w = rs.rand(n) + 0.5 if weighted else None
    want = float(auc_jnp(jnp.asarray(score), jnp.asarray(label),
                         None if w is None else jnp.asarray(w)))
    wt = None if w is None else torch.from_numpy(w)
    got = auc(torch.from_numpy(score), torch.from_numpy(label), wt)
    assert abs(got - want) < 1e-6
    ll = -(label * np.log(prob) + (1 - label) * np.log(1 - prob))
    ref = ll.mean() if w is None else (ll * w).sum() / w.sum()
    got_ll = binary_logloss(torch.from_numpy(prob), torch.from_numpy(label),
                            wt)
    assert abs(got_ll - ref) < 1e-9


def test_reference_model_file_predicts_like_jax():
    path = str(DATA / "binary.model.txt")
    jb = jlgb.Booster(model_file=path)
    tb = tlgb.Booster(model_file=path, params=CPU)
    rs = np.random.RandomState(5)
    X = rs.rand(700, 28) * 4 - 1
    X[rs.rand(700, 28) < 0.05] = np.nan
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_find_bin_is_the_jax_walk(seed):
    """The port's greedy bin search, which finds each bin's end from
    prefix sums of the counts, gives the JAX package's bounds on random
    count vectors: few and many distinct values, values big enough for
    a bin of their own, budgets from 2 to 1024 bins."""
    from lightgbm_tpu.ops.binning import _greedy_find_bin as jax_walk
    from lightgbm_tpu_torch.ops.binning import _greedy_find_bin
    rs = np.random.RandomState(seed)
    for _ in range(150):
        nd = rs.randint(1, 3000)
        counts = rs.randint(1, 5, nd).astype(np.int64)
        kind = rs.randint(3)
        if kind == 1:           # a few values that fill a bin alone
            big = rs.rand(nd) < 0.02
            counts[big] = rs.randint(50, 2000, big.sum())
        elif kind == 2:
            counts = rs.geometric(0.05, nd).astype(np.int64)
        distinct = np.sort(rs.choice(100_000, nd, replace=False)) / 7.0
        max_bin = int(rs.choice([2, 3, 16, 63, 255, 1024]))
        total = int(counts.sum()) + int(rs.randint(0, 50))
        min_data = int(rs.choice([1, 3, 10]))
        want = jax_walk(distinct, counts, nd, max_bin, total, min_data)
        got = _greedy_find_bin(distinct, counts, nd, max_bin, total,
                               min_data)
        assert [float(b) for b in got] == [float(b) for b in want]


def test_threaded_mappers_of_a_large_sample_equal_jax():
    """From 100,000 sampled rows the port finds its mappers in threads,
    reading the sampled rows in ascending order a block of columns at a
    time; the mappers and bins equal the JAX package's (a row sample
    drawn from 120,000 rows; NaNs, negatives, a sparse and a
    categorical column)."""
    rs = np.random.RandomState(11)
    n = 120_000
    X = rs.randn(n, 5).astype(np.float32)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[:, 1] = np.where(rs.rand(n) < 0.01, rs.rand(n) * 3, 0.0)
    X[:, 2] = rs.randint(0, 9, n)
    X[:, 3] = np.round(X[:, 3], 1)
    y = (X[:, 4] > 0) * 1.0
    p = {"bin_construct_sample_cnt": 100_000, "categorical_feature": [2]}
    jd = jlgb.Dataset(X, label=y, params=p).construct()
    td = tlgb.Dataset(X, label=y, params={**p, **CPU}).construct()
    assert [m.to_dict() for m in td.mappers] == \
        [m.to_dict() for m in jd.mappers]
    assert np.array_equal(td.device_bins().numpy(), jd.host_bins())


def test_interop_round_trip():
    """The JAX state, handed over as numpy arrays and plain dicts, gives
    the same bins and the same trees in the port."""
    X, y = _nan_data(1200, 5, seed=7)
    jds = jlgb.Dataset(X, label=y, params={"max_bin": 40}).construct()
    mappers = interop.mappers_from_fields(
        [m.to_dict() for m in jds.mappers])
    bins = bin_matrix(X, jds.used_feature_indices(), mappers)
    assert np.array_equal(bins.to(torch.int64).numpy(),
                          np.asarray(jds.device_bins()).T)

    bT = np.asarray(jds.device_bins())
    n, F = bT.shape[1], bT.shape[0]
    rs = np.random.RandomState(8)
    g = rs.randn(n).astype(np.float32)
    h = (rs.rand(n) + 0.1).astype(np.float32)
    fnb = np.asarray(jds.device_feat_num_bins())
    fnan = np.asarray(jds.device_feat_nan_bin())
    jt, _ = jax_grow_tree(
        JaxGrowConfig(num_leaves=9, num_bins=jds.num_total_bins(),
                      split=JaxSplitParams(min_data_in_leaf=5.0),
                      hist_method="scatter"),
        jnp.asarray(bT), jnp.asarray(g), jnp.asarray(h),
        jnp.ones((n,), jnp.float32), jnp.ones((F,), bool),
        jnp.asarray(fnb), jnp.asarray(fnan))
    arrays = interop.tree_arrays_from_fields(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    mine = tree_from_arrays(arrays, mappers, jds.used_feature_indices())
    ref = jax_tree_from_arrays(jt, jds.mappers, jds.used_feature_indices())
    assert mine.to_string(0) == ref.to_string(0)
    again = interop.tree_from_fields(
        {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})
    assert again.to_string(3) == ref.to_string(3)


def _py_files():
    return sorted((REPO / "lightgbm_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    scanned = {str(p.relative_to(REPO)) for p in _py_files()}
    assert {f"lightgbm_tpu_torch/{m}" for m in (
        "__main__.py", "cli.py", "sklearn.py", "plotting.py", "convert.py",
        "utils/native.py", "ops/linear.py", "data/__init__.py",
        "data/sources.py", "data/ingest.py", "serve/__init__.py",
        "serve/compile.py", "serve/batcher.py", "utils/atomic.py",
        "utils/timer.py", "obs/__init__.py", "obs/schemas.py",
        "obs/registry.py", "obs/export.py", "obs/memory.py",
        "obs/recorder.py", "obs/trace.py", "resilience/__init__.py",
        "resilience/faults.py", "resilience/checkpoint.py",
        "resilience/store.py", "resilience/publisher.py",
        "obs/jit_tracker.py", "serve/daemon.py", "resilience/watchdog.py",
        "parallel/__init__.py", "parallel/mesh.py",
        "parallel/distributed.py", "parallel/hostsync.py",
        "parallel/spmd.py", "parallel/comms.py",
        "parallel/data_parallel.py", "parallel/placement.py",
        "obs/cost.py", "analysis/__init__.py", "analysis/astscan.py",
        "analysis/callgraph.py", "analysis/cfg.py", "analysis/dataflow.py",
        "analysis/rules.py", "analysis/rules_flow.py",
        "analysis/rules_contract.py", "analysis/baseline.py",
        "analysis/report.py", "analysis/engine.py", "analysis/cli.py",
        "analysis/ircheck.py")} <= scanned
    for path in _py_files():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "lightgbm_tpu"), \
                    f"{path.relative_to(REPO)} imports {name}"


def test_import_and_train_leave_jax_unloaded():
    """In a fresh interpreter (this one has jax: tests/conftest.py
    imports it), every module of the port plus a tiny CPU training
    leave jax and lightgbm_tpu out of sys.modules, and importing the
    package leaves the sklearn wrappers and matplotlib unloaded until
    their names are used."""
    code = """
import importlib, pkgutil, sys
import numpy as np
import lightgbm_tpu_torch as lgb
# the optional extras load only when their names are first used
assert "matplotlib" not in sys.modules
assert "lightgbm_tpu_torch.sklearn" not in sys.modules
assert lgb.LGBMRegressor.__module__ == "lightgbm_tpu_torch.sklearn"
assert callable(lgb.plot_importance)
for m in pkgutil.walk_packages(lgb.__path__, "lightgbm_tpu_torch."):
    importlib.import_module(m.name)
assert "matplotlib" not in sys.modules
import chip_smoke
rs = np.random.RandomState(0)
X = rs.randn(300, 4); y = (X[:, 0] > 0).astype(float)
bst = lgb.train({"objective": "binary", "num_leaves": 4,
                 "device_type": "cpu", "verbosity": -1},
                lgb.Dataset(X, label=y), num_boost_round=2)
assert bst.predict(X).shape == (300,)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu")]
assert not bad, bad
print("CLEAN")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


# the JAX package's public Dataset methods that are hooks of its own
# grower, not API: the port has none of them, and says here why
INTERNAL = {
    "Dataset.device_feat_num_bins": "the JAX grower's device copy; the "
                                    "port's grower reads feat_num_bins()",
    "Dataset.device_feat_nan_bin": "the JAX grower's device copy; the "
                                   "port's grower reads feat_nan_bin()",
    "Dataset.device_feat_is_cat": "the JAX grower's device copy; the "
                                  "port's grower reads feat_is_cat()",
    "Dataset.usable_feature_mask": "the JAX grower's feature mask, all "
                                   "True in the JAX package too",
}


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


def test_public_surface_covers_the_jax_package():
    """Every public name of the JAX package (its ``__all__``, its
    ``basic`` module's, and the methods of ``Dataset`` and ``Booster``)
    is in the port, or a grower hook in INTERNAL (which the port must not
    have)."""
    import lightgbm_tpu.basic as jax_basic
    import lightgbm_tpu_torch.basic as port_basic
    missing = (set(jlgb.__all__) - set(tlgb.__all__)) \
        | (set(jax_basic.__all__) - set(port_basic.__all__)) \
        | {f"Dataset.{n}" for n in
           _public(jlgb.Dataset) - _public(tlgb.Dataset)} \
        | {f"Booster.{n}" for n in
           _public(jlgb.Booster) - _public(tlgb.Booster)}
    assert missing == set(INTERNAL), sorted(missing ^ set(INTERNAL))
    for name in tlgb.__all__:
        assert getattr(tlgb, name) is not None


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(0).randn(100, 3)
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(RuntimeError, match="cuda"):
        tlgb.train({"objective": "binary"}, tlgb.Dataset(X, label=y), 1)
    assert Config().device_type == "cuda"


@pytest.mark.parametrize("params", [
    {"chunk_rows": 8192},
    {"hist_method": "pallas"},
    {"reg_sqrt": True},
])
def test_unimplemented_parameters_raise(params):
    X = np.random.RandomState(0).randn(200, 3)
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(NotImplementedError, match="ROADMAP|TPU"):
        tlgb.train({"objective": "binary", **CPU, **params},
                   tlgb.Dataset(X, label=y), 1)


@pytest.mark.parametrize("params", [
    {"two_round": True}, {"ingest_chunk_rows": 1000},
    {"forcedbins_filename": "bins.json"}])
def test_streaming_parameters_are_accepted(params):
    """Streaming ingest is in the port (item 18): on an in-memory matrix
    these parameters change nothing, as in the JAX package."""
    X = np.random.RandomState(0).randn(200, 3)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 4, "verbosity": -1, **CPU}
    a = tlgb.train({**p, **params}, tlgb.Dataset(X, label=y), 2)
    b = tlgb.train(p, tlgb.Dataset(X, label=y), 2)
    assert a.model_to_string().split("parameters:")[0] == \
        b.model_to_string().split("parameters:")[0]


@pytest.mark.parametrize("params", [
    {}, {"use_quantized_grad": True, "quant_train_renew_leaf": True}])
def test_nonfinite_leaf_values_raise_like_jax(params):
    """L2 without boost_from_average on labels near +-1e38: every
    gradient (score - label) is finite, but a leaf's float32 sum of them
    overflows, so its fitted value is not. Both packages' guards flag
    the leaf values (with renewal, the renewed ones) and raise
    ``LightGBMError`` with the same message."""
    rs = np.random.RandomState(0)
    X = rs.randn(500, 4)
    y = np.where(X[:, 0] > 0, 1e38, -1e38) * (0.5 + rs.rand(500))
    p = {"objective": "regression", "boost_from_average": False,
         "num_leaves": 4, "min_data_in_leaf": 5, "verbosity": -1,
         **params}
    with pytest.raises(jlgb.basic.LightGBMError,
                       match="leaf values") as je:
        jlgb.train({**p, "hist_method": "scatter"},
                   jlgb.Dataset(X, label=y), 2)
    with pytest.raises(tlgb.LightGBMError,
                       match="non-finite leaf values detected at "
                             "iteration 0") as te:
        tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y), 2)
    assert str(te.value) == str(je.value)


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


def test_data_that_bundles_trains_bundled_like_jax(monkeypatch):
    """Two sparse, mutually exclusive features: both packages bundle them
    (EFB, the default) and grow the same trees; with enable_bundle=False
    the same Dataset trains unbundled. The grower's float root totals
    are XLA's sums here: torch's differ in the last bit, which flips a
    near tie of this fixture (tests/test_torch_objectives.py)."""
    from lightgbm_tpu_torch.ops import grow
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)
    rs = np.random.RandomState(0)
    X = rs.randn(500, 4)
    X[:, 1:3] = np.abs(X[:, 1:3])      # zero is each one's bin 0
    z = rs.rand(500)
    X[z >= 0.1, 1] = 0.0
    X[(z < 0.1) | (z >= 0.2), 2] = 0.0
    y = (X[:, 0] + X[:, 1] - X[:, 2] > 0).astype(float)
    p = {"objective": "binary", "verbosity": -1, "min_data_in_leaf": 5}
    ja = jlgb.train({**p, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y), 2)
    ds = tlgb.Dataset(X, label=y, params=CPU)
    tb = tlgb.train({**p, **CPU}, ds, 2)
    assert tb._engine.bundle is not None
    assert tb._engine.bundle.groups == ja._engine.bundle.groups
    _same_trees(ja, tb)
    bst = tlgb.train({**p, **CPU, "enable_bundle": False}, ds, 2)
    assert bst._engine.bundle is None and bst.num_trees() == 2
