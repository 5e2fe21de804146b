"""Categorical features in the port (lightgbm_tpu_torch: categorical
mappers and device binning, Dataset's categorical resolution and pandas
category columns, the categorical search in ops/split.py, K2's membership
rule in ops/partition.py, the binned and raw walks, categorical trees in
the model text, interop) held against the JAX package on the CPU.

The same numpy inputs go through both packages. Mappers and bin matrices
are identical (NaN, negative, rare and unseen values included), split
records and masks equal the JAX package's compiled search, the
membership rule takes the JAX grower's ``chunk_goleft`` decision on every
row, and trees are exact in structure (their category bitsets included)
and equal to rtol=1e-4, atol=1e-5 in leaf values. XLA's float root
totals are handed to the grower (``ops/grow.py`` ``root_totals``;
``tests/test_torch_objectives.py`` says why), and so are JAX's bagging
draws where rows are sampled.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models.tree import tree_from_arrays as jax_tree_from_arrays
from lightgbm_tpu.ops.grow import GrowConfig as JaxGrowConfig
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split
from lightgbm_tpu.ops.split import \
    find_best_split_bundled as jax_find_best_split_bundled
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.models import gbdt
from lightgbm_tpu_torch.models.tree import tree_from_arrays
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.ops.binning import _categorical_bins
from lightgbm_tpu_torch.ops.bundling import build_bundles
from lightgbm_tpu_torch.ops.partition import (RangeRules, go_left,
                                              partition_plain)
from lightgbm_tpu_torch.ops.split import (F_, BundleTables, SplitParams,
                                          find_best_split,
                                          find_best_split_bundled)

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


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


@pytest.fixture(autouse=True)
def jax_root_totals(monkeypatch):
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)


def _jax_uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape,
                                                        jnp.float32)))


@pytest.fixture
def jax_bagging(monkeypatch):
    def bag(gen, it, n):
        return _jax_uniform(jax.random.fold_in(jax.random.PRNGKey(3), it),
                            (n,))
    monkeypatch.setattr(gbdt, "bagging_uniform", bag)


# ---- data -------------------------------------------------------------------

def _cat_data(n=3000, seed=0):
    """tests/test_categorical.py's data, with NaN, negative and rare
    categories in the categorical column, and a 4-category one."""
    rs = np.random.RandomState(seed)
    cat = rs.randint(0, 30, n).astype(np.float64)
    num = rs.randn(n)
    cat2 = rs.randint(0, 4, n).astype(np.float64)
    y = ((cat < 10) * 2.0 + 0.3 * num + 0.5 * (cat2 == 2)
         + 0.1 * rs.randn(n) > 1.0).astype(np.float64)
    X = np.column_stack([cat, num, cat2])
    X[rs.rand(n) < 0.05, 0] = np.nan
    X[rs.rand(n) < 0.02, 0] = -3.0
    X[rs.rand(n) < 0.004, 0] = 1000 + rs.randint(0, 40, n)[:1].item()
    return X, y


def _parity_data():
    """tests/test_categorical_accuracy_parity.py's data (6000 rows)."""
    rs = np.random.RandomState(42)
    n = 8000
    c1 = rs.randint(0, 40, n)
    c2 = rs.randint(0, 12, n)
    c3 = rs.randint(0, 100, n)
    cnoise = rs.randint(0, 25, n)
    x1 = rs.randn(n)
    x2 = rs.randn(n)
    logit = (rs.randn(40)[c1] + rs.randn(12)[c2] * 0.7
             + rs.randn(100)[c3] * 0.5 + 0.6 * x1 - 0.4 * x2
             + 0.8 * rs.randn(n))
    y = (logit > 0).astype(float)
    X = np.column_stack([c1, c2, c3, cnoise, x1, x2]).astype(np.float64)
    return X[:6000], y[:6000]


def _sparse_cat_data(n=3000, seed=5):
    """Twelve sparse categoricals of four categories (0 the common one)
    in three mutually exclusive blocks, beside two dense numerical
    features: EFB bundles the categoricals."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n, 14))
    X[:, 12:] = rs.randn(n, 2)
    for blk in range(3):
        col = 4 * blk + rs.randint(0, 4, n)
        on = rs.rand(n) < 0.15
        X[np.nonzero(on)[0], col[on]] = rs.randint(1, 4, int(on.sum()))
    logit = X[:, 12] + 1.2 * (X[:, 1] == 2) - (X[:, 6] == 3) \
        + 0.8 * (X[:, 9] == 1)
    y = (rs.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return X, y


def _same_trees(ja, tb):
    assert len(ja._models) == len(tb._models)
    for a, b in zip(ja._models, tb._models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count",
                     "internal_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        assert a.num_cat == b.num_cat
        if a.num_cat:
            np.testing.assert_array_equal(a.cat_boundaries,
                                          b.cat_boundaries)
            np.testing.assert_array_equal(a.cat_threshold, b.cat_threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


def _train_both(params, X, y, rounds, cats, **kw):
    ja = jlgb.train({**params, **JAX},
                    jlgb.Dataset(X, label=y, categorical_feature=cats, **kw),
                    rounds)
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, categorical_feature=cats,
                                 params=CPU, **kw), rounds)
    return ja, tb


# ---- binning ---------------------------------------------------------------

@pytest.mark.parametrize("data", ["cat", "parity", "sparse"])
def test_categorical_mappers_and_bins_match_jax(data):
    X, y = {"cat": _cat_data, "parity": _parity_data,
            "sparse": _sparse_cat_data}[data]()
    cats = {"cat": [0, 2], "parity": [0, 1, 2, 3],
            "sparse": list(range(12))}[data]
    rs = np.random.RandomState(1)
    Xv = X[:500].copy()
    Xv[rs.rand(500) < 0.1, 0] = 777.0            # unseen
    Xv[rs.rand(500) < 0.1, 0] = np.nan
    Xv[rs.rand(500) < 0.1, 0] = -1.0
    jd = jlgb.Dataset(X, label=y, categorical_feature=cats).construct()
    td = tlgb.Dataset(X, label=y, categorical_feature=cats,
                      params=CPU).construct()
    assert len(jd.mappers) == len(td.mappers)
    for a, b in zip(jd.mappers, td.mappers):
        assert (a.bin_type, a.missing_type, a.num_bins) == \
            (b.bin_type, b.missing_type, b.num_bins)
        if a.bin_type == "categorical":
            np.testing.assert_array_equal(a.bin_to_cat, b.bin_to_cat)
    np.testing.assert_array_equal(td.device_bins().to(torch.int64).numpy(),
                                  np.asarray(jd.device_bins()).T)
    np.testing.assert_array_equal(td.feat_nan_bin(),
                                  np.asarray(jd.device_feat_nan_bin()))
    jv = jlgb.Dataset(Xv, label=y[:500], reference=jd).construct()
    tv = td.create_valid(Xv, label=y[:500]).construct()
    np.testing.assert_array_equal(tv.device_bins().to(torch.int64).numpy(),
                                  np.asarray(jv.device_bins()).T)
    assert td.feature_infos() == jd.feature_infos()


def test_device_categorical_bins_equal_value_to_bin():
    X, y = _cat_data()
    td = tlgb.Dataset(X, label=y, categorical_feature=[0],
                      params=CPU).construct()
    m = td.mappers[0]
    v = np.array([0, 1, 2.7, 29, 29.9, -0.5, -3, np.nan, np.inf, -np.inf,
                  1e6, 2 ** 40, 1000.0] + list(np.arange(-2, 40)),
                 np.float64)
    got = _categorical_bins(torch.from_numpy(v), m).numpy()
    np.testing.assert_array_equal(got, m.value_to_bin(v))
    # a category cut by the 99% rule lands in bin 0
    rs = np.random.RandomState(0)
    w = rs.choice(300, size=20000, p=(1 / np.arange(1, 301) ** 1.1)
                  / (1 / np.arange(1, 301) ** 1.1).sum()).astype(float)
    td = tlgb.Dataset(w[:, None], label=rs.rand(20000),
                      categorical_feature=[0], params=CPU).construct()
    m = td.mappers[0]
    cut = sorted(set(np.unique(w).astype(int)) - set(m.bin_to_cat))
    assert cut
    got = _categorical_bins(torch.tensor(cut, dtype=torch.float64), m)
    assert not got.any()


# ---- the split search ------------------------------------------------------

_jax_search = jax.jit(jax_find_best_split, static_argnums=(7,))


def _random_hist(rs, F, B, fnb):
    cnt = rs.randint(0, 60, (F, B)).astype(np.float32)
    cnt[np.arange(B)[None, :] >= fnb[:, None]] = 0
    h = cnt * 0.25
    h = (h * (h.sum(1).max() / np.maximum(h.sum(1), 1e-9))[:, None])
    g = rs.randn(F, B) * np.sqrt(h + 1e-3) - 0.3
    g[np.arange(B)[None, :] >= fnb[:, None]] = 0
    g = g - ((g.sum(1) - g[0].sum()) / fnb)[:, None] \
        * (np.arange(B)[None, :] < fnb[:, None])
    hist = np.stack([g, h], -1).astype(np.float32)
    hist[np.arange(B)[None, :] >= fnb[:, None]] = 0
    return hist


@pytest.mark.parametrize("seed", range(12))
def test_find_best_split_categorical_matches_jax(seed):
    """Random histograms over numerical and categorical features (one-hot
    and sorted-subset regimes), with and without smoothing, monotone
    signs and bounds: the record and the mask of the JAX package's
    compiled search."""
    rs = np.random.RandomState(seed)
    F, B = 6, 24
    fnb = rs.randint(3, B + 1, F).astype(np.int32)
    fnb[:2] = (3, 4)                       # one-hot regime
    is_cat = np.array([True, True, True, True, False, False])
    fnan = np.where(~is_cat & (rs.rand(F) < 0.5), fnb - 1, -1).astype(
        np.int32)
    hist = _random_hist(rs, F, B, fnb)
    pg, ph = np.float32(hist[0, :, 0].sum()), np.float32(hist[0, :, 1].sum())
    pc = np.float32(4 * ph)
    exact = seed % 3
    kw = dict(min_data_in_leaf=5.0, min_data_per_group=10.0,
              cat_smooth=3.0, path_smooth=[0.0, 2.0, 3.0][exact],
              monotone_penalty=[0.0, 0.5, 2.0][seed % 3])
    mono = rs.choice([-1, 0, 1], F).astype(np.int8) if exact else None
    bounds = (np.float32(-0.01), np.float32(0.01)) if seed % 2 else \
        (np.float32(-0.5), np.float32(0.4))
    use_b = exact and seed % 4 != 1
    p_out, depth = np.float32(0.05 * rs.randn()), seed % 4
    want = _jax_search(
        jnp.asarray(hist), jnp.float32(pg), jnp.float32(ph), jnp.float32(pc),
        jnp.asarray(fnb), jnp.asarray(fnan), jnp.ones(F, bool),
        JaxSplitParams(**kw), None if mono is None else jnp.asarray(mono),
        jnp.asarray(is_cat), None, jnp.float32(p_out), jnp.int32(depth),
        tuple(map(jnp.float32, bounds)) if use_b else None)
    rec, mask = find_best_split(
        torch.from_numpy(hist)[None], torch.tensor([pg]), torch.tensor([ph]),
        torch.tensor([pc]), torch.from_numpy(fnb), torch.from_numpy(fnan),
        torch.ones(F, dtype=torch.bool), SplitParams(**kw),
        torch.from_numpy(is_cat),
        None if mono is None else torch.from_numpy(mono),
        torch.tensor([p_out]), depth,
        torch.tensor([bounds]) if use_b else None)
    rec = rec[0].numpy()
    assert rec[F_["feature"]] == int(want.feature)
    assert rec[F_["threshold_bin"]] == int(want.threshold_bin)
    assert (rec[F_["direction"]] >= 2) == bool(want.is_cat)
    np.testing.assert_array_equal(mask[0].numpy(),
                                  np.asarray(want.cat_mask))
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "left_output", "right_output"):
        np.testing.assert_array_equal(rec[F_[name]],
                                      np.float32(getattr(want, name)),
                                      err_msg=name)


def test_search_finds_both_categorical_families():
    """The random cases above include one-hot and sorted-subset winners
    in both directions."""
    dirs = set()
    for seed in range(40):
        rs = np.random.RandomState(seed)
        F, B = 6, 24
        fnb = rs.randint(3, B + 1, F).astype(np.int32)
        fnb[:2] = (3, 4)
        hist = _random_hist(rs, F, B, fnb)
        ph = hist[0, :, 1].sum()
        rec, _ = find_best_split(
            torch.from_numpy(hist)[None],
            torch.tensor([hist[0, :, 0].sum()]), torch.tensor([ph]),
            torch.tensor([4 * ph]), torch.from_numpy(fnb),
            torch.full((F,), -1), torch.ones(F, dtype=torch.bool),
            SplitParams(min_data_in_leaf=5.0, min_data_per_group=10.0,
                        cat_smooth=3.0), torch.ones(F, dtype=torch.bool))
        dirs.add(int(rec[0, F_["direction"]]))
    assert {2, 3, 4} <= dirs


@pytest.mark.parametrize("onehot", [4, 8])
def test_find_best_split_bundled_with_categorical_members_matches_jax(
        onehot):
    X, y = _sparse_cat_data()
    td = tlgb.Dataset(X, label=y, categorical_feature=list(range(12)),
                      params=CPU).construct()
    info = build_bundles(td.device_bins(), td.mappers, max_cat_onehot=onehot)
    fcat = np.asarray([m.bin_type == "categorical" for m in td.mappers])
    assert any(len(g) > 1 and fcat[g].all() for g in info.groups)
    bb = info.bins_bundled.numpy().astype(np.int64)
    n, G = bb.shape
    B = info.num_positions
    F = len(td.mappers)
    fnb = td.feat_num_bins()
    rs = np.random.RandomState(3)
    kw = dict(min_data_in_leaf=5.0, min_data_per_group=10.0,
              cat_smooth=3.0, max_cat_to_onehot=onehot)
    tables = BundleTables.of(info, torch.device("cpu"))
    for trial in range(4):
        rows = rs.rand(n) < (1.0 if trial == 0 else 0.5)
        g = (rs.randn(n) - 0.2 * (X[:, 1] == 2)).astype(np.float32) * rows
        h = ((rs.rand(n) + 0.1) * rows).astype(np.float32)
        hist = np.zeros((G, B, 2), np.float32)
        for c in range(G):
            np.add.at(hist[c, :, 0], bb[:, c], g)
            np.add.at(hist[c, :, 1], bb[:, c], h)
        tg, th = np.float32(g.sum()), np.float32(h.sum())
        tc = np.float32(rows.sum())
        jr = jax_find_best_split_bundled(
            jnp.asarray(hist), tg, th, tc, jnp.asarray(info.member_at),
            jnp.asarray(info.tloc_at), jnp.asarray(info.end_at),
            jnp.asarray(info.is_direct), jnp.asarray(info.nanpos_at),
            jnp.asarray(info.nan_at), jnp.ones(F, bool),
            JaxSplitParams(**kw), jnp.asarray(fcat), jnp.asarray(fnb))
        rec, mask = find_best_split_bundled(
            torch.from_numpy(hist)[None], torch.tensor([tg]),
            torch.tensor([th]), torch.tensor([tc]), tables,
            torch.ones(F, dtype=torch.bool), SplitParams(**kw),
            torch.from_numpy(fcat), torch.from_numpy(fnb))
        rec = rec[0].numpy()
        assert rec[F_["feature"]] == int(jr.feature)
        assert rec[F_["threshold_bin"]] == int(jr.threshold_bin)
        assert (rec[F_["direction"]] >= 2) == bool(jr.is_cat)
        np.testing.assert_array_equal(mask[0].numpy(),
                                      np.asarray(jr.cat_mask))
        for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                     "left_output", "right_output"):
            np.testing.assert_allclose(rec[F_[name]],
                                       float(getattr(jr, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


# ---- K2's membership rule --------------------------------------------------

def _jax_chunk_goleft_cat(col, f, cm, B, info):
    """The categorical branch of the JAX grower's chunk_goleft
    (lightgbm_tpu/ops/grow.py), as written there: a member's local bin,
    then membership in the [B] mask."""
    if info is None:
        local = col
    else:
        off = jnp.asarray(info.offset_of)[f]
        nb = jnp.asarray(info.nbins)[f]
        local = jnp.where(
            jnp.asarray(info.is_direct)[f], col,
            jnp.where((col >= off) & (col <= off + nb - 2), col - off + 1,
                      0))
    return jnp.any((local[:, None] == jnp.arange(B)[None, :])
                   & cm[None, :], axis=1)


@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("with_nan_bin", [False, True])
def test_membership_rule_is_chunk_goleft_on_every_row(bundled, with_nan_bin):
    """Every categorical feature, direct or a bundle member, with random
    sets (with and without bin 0, where NaN, negative and unseen values
    sit, and with and without a NaN bin in the set): the plain
    membership rule routes every row of the split's column as the JAX
    grower does, and the plain K2 moves the rows that way."""
    X, y = _sparse_cat_data()
    X[::7, 12] = np.nan                         # a NaN bin, numerical
    td = tlgb.Dataset(X, label=y, categorical_feature=list(range(12)),
                      params=CPU).construct()
    fnb, fnan = td.feat_num_bins(), td.feat_nan_bin()
    if bundled:
        info = build_bundles(td.device_bins(), td.mappers)
        bins = info.bins_bundled
        B = info.num_positions
        info_j = dataclasses.make_dataclass("I", ["offset_of", "is_direct",
                                                  "nbins"])(
            info.offset_of, info.is_direct, fnb)
        rules = RangeRules(fnb, fnan, info)
        assert not info.is_direct[:12].all()
    else:
        info = info_j = None
        bins = td.device_bins()
        B = td.num_total_bins()
        rules = RangeRules(fnb, fnan)
    rs = np.random.RandomState(int(bundled) * 2 + int(with_nan_bin))
    for f in list(range(12)) + [12]:
        for _ in range(4):
            cm = rs.rand(B) < 0.5
            cm[0] = rs.rand() < 0.5
            if with_nan_bin:
                cm[max(0, int(fnb[f]) - 1)] = True
            col = int(rules.col[f])
            bits = rules.bitsets([f], torch.from_numpy(cm)[None], B)[0]
            want = np.asarray(_jax_chunk_goleft_cat(
                jnp.asarray(bins[:, col].to(torch.int32).numpy()), f,
                jnp.asarray(cm), B, info_j))
            got = go_left(bins[:, col], 0, 0, -1, False, bits).numpy()
            np.testing.assert_array_equal(got, want)
        dst = torch.empty_like(bins)
        nl = partition_plain(bins, dst, None, None, None, None, 0,
                             bins.shape[0], col, 0, 0, -1, False, bits)
        assert int(nl) == int(want.sum())
        order = np.concatenate([np.flatnonzero(want), np.flatnonzero(~want)])
        np.testing.assert_array_equal(dst.numpy(), bins.numpy()[order])


# ---- trees ------------------------------------------------------------------

P15 = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
       "verbosity": -1}
TREE_CASES = {
    "binary": (_cat_data, [0, 2], P15, 5),
    "quantized": (_cat_data, [0, 2],
                  {**P15, "use_quantized_grad": True,
                   "stochastic_rounding": False}, 5),
    "onehot_wide": (_cat_data, [0, 2], {**P15, "max_cat_to_onehot": 40}, 4),
    "subset_knobs": (_cat_data, [0, 2],
                     {**P15, "max_cat_threshold": 4, "cat_l2": 1.0,
                      "cat_smooth": 5.0, "min_data_per_group": 30}, 4),
    "parity_float": (_parity_data, [0, 1, 2, 3],
                     {"objective": "binary", "num_leaves": 31,
                      "learning_rate": 0.1, "min_data_in_leaf": 20,
                      "verbosity": -1}, 4),
    "parity_quantized": (_parity_data, [0, 1, 2, 3],
                         {"objective": "binary", "num_leaves": 31,
                          "learning_rate": 0.1, "min_data_in_leaf": 20,
                          "verbosity": -1, "use_quantized_grad": True,
                          "stochastic_rounding": False}, 4),
    "multiclass_quantized": (_parity_data, [0, 1, 2, 3],
                             {"objective": "multiclass", "num_class": 3,
                              "num_leaves": 15, "verbosity": -1,
                              "use_quantized_grad": True,
                              "stochastic_rounding": False}, 2),
    "efb_members": (_sparse_cat_data, list(range(12)),
                    {**P15, "min_data_in_leaf": 10}, 4),
    "regression": (_cat_data, [0, 2],
                   {"objective": "regression", "num_leaves": 15,
                    "verbosity": -1}, 4),
}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_trees_match_jax(case):
    make, cats, params, rounds = TREE_CASES[case]
    X, y = make()
    if params["objective"] == "multiclass":
        rs = np.random.RandomState(43)
        z = rs.randn(40)[X[:, 0].astype(int)] + 0.6 * X[:, 4] \
            + 0.5 * rs.randn(len(y))
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float64)
    ja, tb = _train_both(params, X, y, rounds, cats)
    assert sum(t.num_cat for t in tb._models) > 0
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_bagging_out_of_bag_walk_matches_jax(jax_bagging):
    """Bagging: the out-of-bag rows reach their leaves by the binned
    walk with the trees' category masks; train scores and trees equal
    JAX's."""
    X, y = _cat_data()
    p = {**P15, "bagging_fraction": 0.6, "bagging_freq": 1}
    ja, tb = _train_both(p, X, y, 4, [0, 2])
    _same_trees(ja, tb)


def test_dart_matches_jax():
    X, y = _cat_data(seed=2)
    p = {**P15, "boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0}
    ja, tb = _train_both(p, X, y, 4, [0, 2])
    _same_trees(ja, tb)


def test_init_model_continues_like_jax():
    """init_model: the trees' categorical nodes re-score the train set
    over its bins (their bitsets mapped back onto the mappers)."""
    X, y = _cat_data(seed=3)
    ja0, tb0 = _train_both(P15, X, y, 2, [0, 2])
    ja = jlgb.train({**P15, **JAX},
                    jlgb.Dataset(X, label=y, categorical_feature=[0, 2]), 2,
                    init_model=ja0)
    tb = tlgb.train({**P15, **CPU},
                    tlgb.Dataset(X, label=y, categorical_feature=[0, 2],
                                 params=CPU), 2, init_model=tb0)
    _same_trees(ja, tb)


def test_valid_set_scores_match_jax():
    X, y = _cat_data(seed=4)
    Xv, yv = _cat_data(n=800, seed=5)
    Xv[:40, 0] = 555.0                          # unseen in training
    ev_j, ev_t = {}, {}
    jd = jlgb.Dataset(X, label=y, categorical_feature=[0, 2])
    jlgb.train({**P15, **JAX, "metric": "auc"}, jd, 4,
               valid_sets=[jd.create_valid(Xv, label=yv)],
               callbacks=[jlgb.record_evaluation(ev_j)])
    td = tlgb.Dataset(X, label=y, categorical_feature=[0, 2], params=CPU)
    tlgb.train({**P15, **CPU, "metric": "auc"}, td, 4,
               valid_sets=[td.create_valid(Xv, label=yv)],
               callbacks=[tlgb.record_evaluation(ev_t)])
    np.testing.assert_allclose(ev_t["valid_0"]["auc"], ev_j["valid_0"]["auc"],
                               rtol=1e-6)


def test_pandas_category_frame_matches_jax():
    pd = pytest.importorskip("pandas")
    X, y = _cat_data(seed=6)
    cats = np.array(["c%02d" % i for i in range(40)])
    frame = pd.DataFrame({
        "city": pd.Categorical(np.where(np.isnan(X[:, 0]) | (X[:, 0] < 0)
                                        | (X[:, 0] >= 40), None,
                                        cats[np.nan_to_num(X[:, 0]).clip(
                                            0, 39).astype(int)])),
        "x": X[:, 1],
        "kind": pd.Categorical(np.array(list("abcd"))[X[:, 2].astype(int)]),
    })
    ja = jlgb.train({**P15, **JAX}, jlgb.Dataset(frame, label=y), 4)
    tb = tlgb.train({**P15, **CPU}, tlgb.Dataset(frame, label=y,
                                                 params=CPU), 4)
    assert sum(t.num_cat for t in tb._models) > 0
    _same_trees(ja, tb)
    assert tb.pandas_categorical[1] == ["a", "b", "c", "d"]
    np.testing.assert_allclose(tb.predict(frame), ja.predict(frame),
                               rtol=1e-5, atol=1e-6)
    # the categories are kept: a frame with its categories in another
    # order predicts the same
    other = frame.copy()
    other["kind"] = other["kind"].cat.reorder_categories(list("dcba"))
    np.testing.assert_allclose(tb.predict(other), tb.predict(frame))


# ---- model text, prediction, interop ----------------------------------------

@pytest.fixture(scope="module")
def cat_pair():
    X, y = _cat_data(seed=7)
    ja = jlgb.train({**P15, **JAX},
                    jlgb.Dataset(X, label=y, categorical_feature=[0, 2]), 5)
    tb = tlgb.train({**P15, **CPU},
                    tlgb.Dataset(X, label=y, categorical_feature=[0, 2],
                                 params=CPU), 5)
    return X, ja, tb


def _odd_rows():
    rs = np.random.RandomState(9)
    Z = np.column_stack([rs.randint(0, 30, 400).astype(float), rs.randn(400),
                         rs.randint(0, 4, 400).astype(float)])
    Z[:40, 0] = np.nan
    Z[40:80, 0] = -2.0
    Z[80:120, 0] = 5000.0                       # past every bitset
    Z[120:160, 0] = 12.7                        # read as 12
    Z[160:200, 2] = np.nan
    return Z


def test_model_text_cross_loads_both_ways(cat_pair, tmp_path):
    X, ja, tb = cat_pair
    Z = np.vstack([X[:500], _odd_rows()])
    tb.save_model(tmp_path / "t.txt")
    ja.save_model(tmp_path / "j.txt")
    j_from_t = jlgb.Booster(model_file=str(tmp_path / "t.txt"))
    t_from_j = tlgb.Booster(model_file=str(tmp_path / "j.txt"), params=CPU)
    t_from_t = tlgb.Booster(model_file=str(tmp_path / "t.txt"), params=CPU)
    want = ja.predict(Z, raw_score=True)
    for got in (tb.predict(Z, raw_score=True),
                j_from_t.predict(Z, raw_score=True),
                t_from_j.predict(Z, raw_score=True),
                t_from_t.predict(Z, raw_score=True)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tb.predict(Z, pred_leaf=True),
                                  ja.predict(Z, pred_leaf=True))


def test_raw_walk_routes_odd_categories_right(cat_pair):
    """NaN, negative values and values past a node's bitset go right in
    raw prediction (CategoricalDecision), whatever bin 0 does in
    training."""
    _, _, tb = cat_pair
    t = next(t for t in tb._models if t.num_cat > 0)
    node = int(np.flatnonzero(t.decision_type & 1)[0])
    v = np.array([np.nan, -1.0, -0.2, 1e9, 5000.0])
    assert not t.cat_decision(node, v).any()


def test_interop_carries_categorical_tree_arrays():
    """A categorical tree grown by the JAX grower, handed over as numpy
    fields, writes the same model text in the port."""
    X, y = _cat_data(seed=8)
    jds = jlgb.Dataset(X, label=y, categorical_feature=[0, 2]).construct()
    mappers = interop.mappers_from_fields(
        [m.to_dict() for m in jds.mappers])
    bT = np.asarray(jds.device_bins())
    n, F = bT.shape[1], bT.shape[0]
    rs = np.random.RandomState(8)
    g = (rs.randn(n) - (X[:, 0] < 10)).astype(np.float32)
    h = (rs.rand(n) + 0.1).astype(np.float32)
    jt, _ = jax_grow_tree(
        JaxGrowConfig(num_leaves=9, num_bins=jds.num_total_bins(),
                      split=JaxSplitParams(min_data_in_leaf=5.0),
                      hist_method="scatter"),
        jnp.asarray(bT), jnp.asarray(g), jnp.asarray(h),
        jnp.ones((n,), jnp.float32), jnp.ones((F,), bool),
        jds.device_feat_num_bins(), jds.device_feat_nan_bin(), None,
        jds.device_feat_is_cat())
    arrays = interop.tree_arrays_from_fields(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    assert arrays.split_is_cat.any()
    mine = tree_from_arrays(arrays, mappers, jds.used_feature_indices())
    ref = jax_tree_from_arrays(jt, jds.mappers, jds.used_feature_indices())
    assert mine.to_string(0) == ref.to_string(0)
    fields = interop.booster_fields(tlgb.train(
        {**P15, **CPU}, tlgb.Dataset(X, label=y, categorical_feature=[0, 2],
                                     params=CPU), 2))
    again = interop.booster_from_fields(fields, CPU)
    np.testing.assert_allclose(again.predict(X), tlgb.Booster(
        model_str=again.model_to_string(), params=CPU).predict(X))


def test_set_categorical_feature_and_names():
    X, y = _cat_data(seed=10)
    names = ["city", "x", "kind"]
    a = tlgb.Dataset(X, label=y, feature_name=names, params=CPU)
    a.set_categorical_feature(["city", "kind"]).construct()
    b = tlgb.Dataset(X, label=y, feature_name=names,
                     params={**CPU, "categorical_feature": "0,2"}).construct()
    assert [m.bin_type for m in a.mappers] == [m.bin_type for m in b.mappers]
    assert a.feat_is_cat().tolist() == [True, False, True]
    with pytest.raises(tlgb.basic.LightGBMError):
        a.set_categorical_feature([1])
    with pytest.raises(tlgb.basic.LightGBMError, match="Unknown"):
        tlgb.Dataset(X, label=y, feature_name=names, params=CPU,
                     categorical_feature=["nope"]).construct()
