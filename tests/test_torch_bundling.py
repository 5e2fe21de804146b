"""Exclusive feature bundling in the port (lightgbm_tpu_torch:
ops/bundling.py, Dataset.bundles, ops/split.py find_best_split_bundled,
K2's range rule in ops/partition.py, the bundled grower and the binned
walk over bundle columns) held against the JAX package on the CPU.

The same numpy inputs go through both packages. The bundling plan and
the bundled matrix are identical field for field, split records agree
(exactly in the winner, to float32 rounding in the sums), the range rule
takes the JAX grower's ``chunk_goleft`` decision on every row, and
bundled trees equal the JAX package's bundled trees exactly in structure
and to rtol=1e-4, atol=1e-5 in leaf values. Bagging's draws are handed
to the port from ``jax.random`` as ``tests/test_torch_sampling.py``
does, and so are XLA's float root totals (``ops/grow.py``
``root_totals``; ``tests/test_torch_objectives.py`` says why).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import make_allstate_like
from lightgbm_tpu.ops.bundling import build_bundles as jax_build_bundles
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import \
    find_best_split_bundled as jax_find_best_split_bundled
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models import gbdt
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.ops.bundling import (build_bundles, bundle_columns,
                                             bundle_columns_np)
from lightgbm_tpu_torch.ops.partition import (RangeRules, go_left,
                                              partition_plain)
from lightgbm_tpu_torch.ops.split import (F_, BundleTables, SplitParams,
                                          find_best_split_bundled)

CPU = {"device_type": "cpu"}
JAX = {"hist_method": "scatter"}
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 5}


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


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


def _jax_root_totals(full):
    v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
    return v[0], v[1]


@pytest.fixture(autouse=True)
def jax_root_totals(monkeypatch):
    """The grower's float root totals summed by XLA, as the JAX grower
    sums them (tests/test_torch_objectives.py says why)."""
    monkeypatch.setattr(grow, "root_totals", _jax_root_totals)


@pytest.fixture
def jax_bagging(monkeypatch):
    """The port's bagging draw replaced by the JAX package's."""
    def bag(gen, it, n):
        return _jax_uniform(jax.random.fold_in(jax.random.PRNGKey(3), it),
                            (n,))
    monkeypatch.setattr(gbdt, "bagging_uniform", bag)


# ---- the fixtures of tests/test_bundling.py ------------------------------

def _sparse_onehot(n, groups, per_group, seed=0, noise_feats=2):
    """One-hot blocks (mutually exclusive by construction) and a couple
    of dense features (tests/test_bundling.py)."""
    rs = np.random.RandomState(seed)
    cols = []
    signal = np.zeros(n)
    for _ in range(groups):
        pick = rs.randint(0, per_group, n)
        block = np.zeros((n, per_group))
        vals = rs.rand(per_group) * 2
        block[np.arange(n), pick] = vals[pick]
        cols.append(block)
        signal += vals[pick]
    dense = rs.randn(n, noise_feats)
    X = np.hstack(cols + [dense])
    y = (signal + 0.5 * dense[:, 0]
         + 0.3 * rs.randn(n) > np.median(signal)).astype(float)
    return X, y


def _onehot_blocks():
    return _sparse_onehot(4000, groups=6, per_group=8)


def _with_nan_feature():
    rs = np.random.RandomState(13)
    n = 2500
    X, y = _sparse_onehot(n, groups=4, per_group=6, seed=13)
    xnan = rs.randn(n, 1)
    xnan[rs.rand(n) < 0.3] = np.nan
    X = np.hstack([X, xnan])
    return X, ((np.nan_to_num(xnan[:, 0]) > 0.3) ^ (y > 0.5)) * 1.0


def _nan_members():
    rs = np.random.RandomState(7)
    X, y = _sparse_onehot(3000, groups=5, per_group=7, seed=7)
    for j in range(14):
        nzr = np.flatnonzero(X[:, j] != 0)
        X[nzr[rs.rand(len(nzr)) < 0.33], j] = np.nan
    return X, y


def _boundary_slot():
    rs = np.random.RandomState(21)
    n = 4000
    pick = rs.randint(0, 6, n)
    A = np.where(pick == 0, rs.randint(1, 40, n) / 4.0, 0.0)
    A[(pick == 0) & (rs.rand(n) < 0.4)] = np.nan
    Bcol = np.where(pick == 1, 1.0, 0.0)
    X = np.column_stack([A, Bcol, rs.randn(n), rs.randn(n)])
    y = ((np.nan_to_num(A) + Bcol + 0.3 * X[:, 2]) > 0.8) * 1.0
    return X, y


def _allstate_256():
    return make_allstate_like(4000, 256, seed=0)


def _conflicts():
    """Blocks of members with up to 40 bins and a few rows where members
    collide: at 30,000 rows each bundle may spend 3 conflicting rows,
    and bundles fill to their 255 positions."""
    rs = np.random.RandomState(31)
    n, per, blocks = 30_000, 6, 8
    X = np.zeros((n, per * blocks))
    for g in range(blocks):
        pick = rs.randint(0, per * 3, n)
        hit = np.flatnonzero(pick < per)
        X[hit, g * per + pick[hit]] = rs.randint(1, 40, len(hit))
    noise = rs.rand(*X.shape) < 3e-4
    X[noise] = rs.randint(1, 5, noise.sum())
    return X, (X[:, :per].sum(axis=1) > X[:, per:2 * per].sum(axis=1)) * 1.0


FIXTURES = {"onehot_blocks": _onehot_blocks,
            "nan_feature": _with_nan_feature,
            "nan_members": _nan_members,
            "boundary_slot": _boundary_slot,
            "allstate_256": _allstate_256,
            "conflicts": _conflicts}


def _datasets(X, y, params=None):
    p = dict(params or {})
    jd = jlgb.Dataset(X, label=y, params=p).construct()
    td = tlgb.Dataset(X, label=y, params={**p, **CPU}).construct()
    assert np.array_equal(jd.host_bins(), td.device_bins().numpy())
    return jd, td


# ---- the plan and the bundled matrix -------------------------------------

@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_build_bundles_is_the_jax_plan(fixture):
    X, y = FIXTURES[fixture]()
    jd, td = _datasets(X, y)
    want = jax_build_bundles(jd.host_bins(), jd.mappers)
    got = build_bundles(td.device_bins(), td.mappers)
    assert want is not None and got is not None
    assert got.groups == want.groups
    assert got.num_positions == want.num_positions
    for name in ("bundle_of", "offset_of", "is_direct", "member_at",
                 "tloc_at", "end_at", "nanpos_at", "nan_at"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.bins_bundled.dtype == torch.uint8
    np.testing.assert_array_equal(got.bins_bundled.numpy(),
                                  want.bins_bundled)
    # Dataset.bundles is the same plan, built once
    cfg = Config.from_params(CPU)
    info = td.bundles(cfg)
    assert info.groups == want.groups and td.bundles(cfg) is info


@pytest.mark.parametrize("wide", [False, True])
def test_bundle_columns_equal_the_numpy_loop_with_conflicts(wide):
    """Rows where two members of a bundle are nonzero keep the later
    member's position, as in the JAX package's loop; u16 columns past
    2^15 keep their bits."""
    rs = np.random.RandomState(5)
    n, F = 3001, 7
    top = 700 if wide else 40
    bins = np.where(rs.rand(n, F) < 0.7, 0,
                    rs.randint(1, top, (n, F))).astype(
        np.uint16 if wide else np.uint8)
    groups = [[4, 1, 6], [0], [2, 5], [3]]
    offset_of = np.zeros(F, np.int32)
    for g in groups:
        off = 1 if len(g) > 1 else 0
        for j in g:
            offset_of[j] = off
            off += top - 1 if len(g) > 1 else 0
    if wide:
        offset_of[6] += 32000            # positions past 2^15
    dtype = torch.uint16 if wide else torch.uint8
    got = bundle_columns(torch.from_numpy(bins.astype(np.int32)).to(dtype),
                         groups, offset_of, dtype)
    want = bundle_columns_np(bins, groups, offset_of,
                             np.uint16 if wide else np.uint8)
    got = got.view(torch.int16).numpy().view(np.uint16) if wide \
        else got.numpy()
    np.testing.assert_array_equal(got, want)


# ---- the split search -----------------------------------------------------

@pytest.mark.parametrize("fixture", ["nan_members", "boundary_slot",
                                     "allstate_256"])
def test_find_best_split_bundled_matches_jax(fixture):
    X, y = FIXTURES[fixture]()
    jd, td = _datasets(X, y)
    info = build_bundles(td.device_bins(), td.mappers)
    bb = info.bins_bundled.numpy().astype(np.int64)
    n, G = bb.shape
    B = info.num_positions
    rs = np.random.RandomState(3)
    F = len(td.mappers)
    p = SplitParams(min_data_in_leaf=5.0)
    jp = JaxSplitParams(min_data_in_leaf=5.0)
    tables = BundleTables.of(info, torch.device("cpu"))
    for trial in range(4):
        rows = rs.rand(n) < (1.0 if trial == 0 else 0.4)
        g = rs.randn(n).astype(np.float32) * rows
        h = ((rs.rand(n) + 0.1) * rows).astype(np.float32)
        hist = np.zeros((G, B, 2), np.float32)
        for c in range(G):
            np.add.at(hist[c, :, 0], bb[:, c], g)
            np.add.at(hist[c, :, 1], bb[:, c], h)
        tg, th = np.float32(g.sum()), np.float32(h.sum())
        tc = np.float32(rows.sum())
        fmask = np.ones(F, bool) if trial < 2 else rs.rand(F) < 0.5
        jr = jax_find_best_split_bundled(
            jnp.asarray(hist), tg, th, tc, jnp.asarray(info.member_at),
            jnp.asarray(info.tloc_at), jnp.asarray(info.end_at),
            jnp.asarray(info.is_direct), jnp.asarray(info.nanpos_at),
            jnp.asarray(info.nan_at), jnp.asarray(fmask), jp)
        rec = find_best_split_bundled(
            torch.from_numpy(hist)[None], torch.tensor([tg]),
            torch.tensor([th]), torch.tensor([tc]), tables,
            torch.from_numpy(fmask), p)[0].numpy()
        assert rec[F_["feature"]] == int(jr.feature)
        assert rec[F_["threshold_bin"]] == int(jr.threshold_bin)
        assert bool(rec[F_["default_left"]]) == bool(jr.default_left)
        np.testing.assert_allclose(rec[F_["gain"]], float(jr.gain),
                                   rtol=1e-5)
        for name in ("left_sum_g", "left_sum_h", "left_count",
                     "right_sum_g", "right_sum_h", "right_count",
                     "left_output", "right_output"):
            np.testing.assert_allclose(rec[F_[name]],
                                       float(getattr(jr, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


# ---- K2's range rule ------------------------------------------------------

def _jax_chunk_goleft(col, f, t, dl, feat_num_bins, feat_nan_bin, info):
    """The bundled branch of the JAX grower's chunk_goleft
    (lightgbm_tpu/ops/grow.py), as written there."""
    off = jnp.asarray(info.offset_of)[f]
    nb = feat_num_bins[f]
    nanb = feat_nan_bin[f]
    left_direct = jnp.where((nanb >= 0) & (col == nanb), dl, col <= t)
    is_nanrow = (nanb >= 0) & (col == off + nanb - 1)
    right_multi = (col >= off + t) & (col <= off + nb - 2) & ~is_nanrow
    left_multi = jnp.where(is_nanrow, dl, ~right_multi)
    return jnp.where(jnp.asarray(info.is_direct)[f], left_direct,
                     left_multi)


@pytest.mark.parametrize("fixture", ["nan_members", "boundary_slot",
                                     "nan_feature"])
def test_range_rule_is_chunk_goleft_on_every_row(fixture):
    """Every feature (direct members and multi members, with and without
    a NaN bin) at every threshold and both default directions: the
    plain range rule routes every row of its bundle column as the JAX
    grower does, and the plain K2 moves the rows that way."""
    X, y = FIXTURES[fixture]()
    _, td = _datasets(X, y)
    info = build_bundles(td.device_bins(), td.mappers)
    bb = info.bins_bundled
    fnb, fnan = td.feat_num_bins(), td.feat_nan_bin()
    rules = RangeRules(fnb, fnan, info)
    kinds = set()
    for f in range(len(fnb)):
        kinds.add((bool(info.is_direct[f]), bool(fnan[f] >= 0)))
        for t in range(int(fnb[f])):
            col, lo, hi, nan_pos = rules(f, t)
            assert col == info.bundle_of[f]
            for dl in (False, True):
                want = np.asarray(_jax_chunk_goleft(
                    jnp.asarray(bb[:, col].numpy().astype(np.int32)), f, t,
                    dl, jnp.asarray(fnb), jnp.asarray(fnan), info))
                got = go_left(bb[:, col], lo, hi, nan_pos, dl).numpy()
                np.testing.assert_array_equal(got, want)
        dst = torch.empty_like(bb)
        nl = partition_plain(bb, dst, None, None, None, None, 0,
                             bb.shape[0], col, lo, hi, nan_pos, True)
        assert int(nl) == int(want.sum())
        order = np.concatenate([np.flatnonzero(want), np.flatnonzero(~want)])
        np.testing.assert_array_equal(dst.numpy(), bb.numpy()[order])
    assert {d for d, _ in kinds} == {False, True}
    if fixture == "nan_members":
        assert (False, True) in kinds    # multi members with a NaN bin


def test_range_rule_of_a_plain_split_is_the_old_rule():
    rules = RangeRules([64, 64, 300], [-1, 63, 5])
    col = torch.arange(300)
    for f, t in ((0, 10), (1, 62), (2, 4), (2, 5), (2, 299)):
        c, lo, hi, nan_pos = rules(f, t)
        assert c == f and lo == t + 1 and hi == 2 ** 31 - 1
        nb = [-1, 63, 5][f]
        for dl in (False, True):
            old = torch.where((col == nb) & (nb >= 0), torch.tensor(dl),
                              col <= t)
            assert torch.equal(go_left(col, lo, hi, nan_pos, dl), old)


# ---- training ---------------------------------------------------------------

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


def _train_both(params, X, y, rounds, **kw):
    ja = jlgb.train({**params, **JAX}, jlgb.Dataset(X, label=y), rounds,
                    **kw.get("jax", {}))
    tb = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, params=CPU),
                    rounds, **kw.get("port", {}))
    assert ja._engine.bundle is not None and tb._engine.bundle is not None
    assert tb._engine.bundle.groups == ja._engine.bundle.groups
    return ja, tb


@pytest.mark.parametrize("case", ["binary", "multiclass", "quantized",
                                  "bagging", "dart", "l1_renewal"])
def test_bundled_trees_match_jax(case, jax_bagging):
    X, y = _nan_members()
    p = dict(PARAMS)
    if case == "multiclass":
        rs = np.random.RandomState(0)
        y = np.digitize(np.nan_to_num(X[:, :7]).sum(1)
                        + 0.3 * rs.randn(len(y)), [0.4, 1.1]) * 1.0
        p.update(objective="multiclass", num_class=3)
    elif case == "quantized":
        p.update(use_quantized_grad=True, stochastic_rounding=False)
    elif case == "bagging":
        p.update(bagging_fraction=0.6, bagging_freq=1)
    elif case == "dart":
        p.update(boosting="dart", drop_rate=0.5, skip_drop=0.0)
    elif case == "l1_renewal":
        y = np.nan_to_num(X[:, :10]).sum(1) + np.random.RandomState(1) \
            .standard_t(2, len(y))
        p.update(objective="regression_l1")
    ja, tb = _train_both(p, X, y, 4)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_bundled_init_model_continues_like_jax(tmp_path):
    """init_model on bundled data: the train score is rebuilt by walking
    the loaded trees over the bundle columns."""
    X, y = _nan_members()
    ja, tb = _train_both(PARAMS, X, y, 3)
    ja.save_model(str(tmp_path / "jax.txt"))
    tb.save_model(tmp_path / "port.txt")
    ja2, tb2 = _train_both(
        PARAMS, X, y, 2,
        jax={"init_model": str(tmp_path / "jax.txt")},
        port={"init_model": str(tmp_path / "port.txt")})
    _same_trees(ja2, tb2)
    np.testing.assert_allclose(tb2.predict(X), ja2.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_bundled_trees_equal_unbundled_on_zero_conflicts():
    """With no conflicts the bundled search sees the same candidates:
    the same trees, leaf values equal up to the float32 rounding of the
    bin-0 reconstruction (the JAX package's own standard,
    tests/test_bundling.py)."""
    X, y = _sparse_onehot(3000, groups=4, per_group=6, seed=3)
    ds = tlgb.Dataset(X, label=y, params=CPU)
    plain = tlgb.train({**PARAMS, **CPU, "enable_bundle": False}, ds, 6)
    bundled = tlgb.train({**PARAMS, **CPU}, ds, 6)
    assert plain._engine.bundle is None
    assert bundled._engine.bundle is not None
    assert bundled._engine.grower.bins.shape[1] < X.shape[1] / 2
    for a, b in zip(plain._models, bundled._models):
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=5e-3,
                                   atol=1e-5)


def test_cv_and_valid_sets_on_bundled_data():
    """Valid sets keep their unbundled bins (trees name original
    features); cv's folds bundle their own rows."""
    X, y = _nan_members()
    ds = tlgb.Dataset(X[:2400], label=y[:2400], params=CPU)
    v = ds.create_valid(X[2400:], label=y[2400:])
    ev = {}
    bst = tlgb.train({**PARAMS, **CPU, "metric": "auc"}, ds, 4,
                     valid_sets=[v],
                     callbacks=[tlgb.record_evaluation(ev)])
    assert bst._engine.bundle is not None
    assert v.device_bins().shape[1] == X.shape[1]
    from lightgbm_tpu_torch.metrics import auc
    p = bst.predict(X[2400:], raw_score=True)
    assert abs(ev["valid_0"]["auc"][-1] - auc(
        torch.from_numpy(p), torch.from_numpy(y[2400:]), None)) < 1e-6
    res = tlgb.cv({**PARAMS, **CPU, "metric": "auc"},
                  tlgb.Dataset(X, label=y, params=CPU), 3, nfold=3)
    assert len(res["valid auc-mean"]) == 3


@pytest.mark.parametrize("n,f,seed", [(3000, 256, 0), (262_150, 128, 1)])
def test_chip_smoke_allstate_generator_is_bench_py_s(n, f, seed):
    """chip_smoke.py carries a copy of bench.py's Allstate generator (the
    port's smoke may not depend on the bench): the same draws, across a
    chunk boundary too."""
    import bench
    Xa, ya = bench.make_allstate_like(n, f, seed=seed)
    Xb, yb = make_allstate_like(n, f, seed=seed)
    assert np.array_equal(Xa, Xb, equal_nan=True)
    assert np.array_equal(ya, yb)
