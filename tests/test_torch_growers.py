"""The port's growth variants (lightgbm_tpu_torch/ops/grow.py: the level
grower, the masked grower and the histogram pool; models/gbdt.py: their
routing) held against the JAX package on the CPU.

The JAX growers run with ``hist_method="scatter"``, as in
``tests/test_torch_grow.py``: its float sums add the rows in row order,
and so do the port's plain histograms over a window (K2 keeps a
window's rows in row order) or over all rows with a masked payload. The
level grower and the re-search take a leaf's totals from its
histogram's feature-0 row (``ops/grow.py`` ``leaf_totals``) and the
root's from the payload (``root_totals``); both are handed XLA's sums
here, as ``tests/test_torch_objectives.py`` does for the root (torch's
float32 sums differ in the last bit). Trees are held exactly in
structure and ``row_leaf``, leaf values to rtol=1e-4, atol=1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from chip_smoke import fixed_exponent
from lightgbm_tpu.ops.grow import GrowConfig as JaxGrowConfig
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch.ops import grow
from lightgbm_tpu_torch.ops.grow import GrowConfig, Grower, masked_absmax
from lightgbm_tpu_torch.ops.split import SplitParams

CPU = {"device_type": "cpu"}
STRUCTURE = ("split_feature", "threshold_bin", "default_left",
             "left_child", "right_child", "leaf_parent", "leaf_depth",
             "leaf_count", "internal_count")
VALUES = ("leaf_value", "leaf_weight", "internal_value", "internal_weight",
          "split_gain")
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


@jax.jit
def _xla_leaves(hf):
    return hf[:, 0].sum(axis=1)


@pytest.fixture(autouse=True)
def xla_totals(monkeypatch):
    def root(full):
        v = torch.from_numpy(np.array(_xla_root(full.numpy())))
        return v[0], v[1]
    monkeypatch.setattr(grow, "root_totals", root)
    monkeypatch.setattr(grow, "leaf_totals", lambda hf: torch.from_numpy(
        np.array(_xla_leaves(hf.numpy()))))


def _fixture(n=6000, F=6, B=31, seed=1, weighted=False, nan=False):
    """The fixture of tests/test_level_grower.py (random bins, gradients
    and hessians), as numpy; ``weighted``: bagging-style 0 / 1.3 row
    weights; ``nan``: every other feature's last bin is its missing
    bin."""
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, B, (F, n)).astype(np.uint8)
    g = rs.randn(n).astype(np.float32)
    h = (np.abs(rs.randn(n)) + 0.1).astype(np.float32)
    w = ((rs.rand(n) > 0.4) * 1.3).astype(np.float32) if weighted \
        else np.ones(n, np.float32)
    fnan = np.full(F, -1, np.int32)
    if nan:
        fnan[::2] = B - 1
    return bins, g, h, w, np.full(F, B, np.int32), fnan


def _jax_tree(grower, L, B, data, max_depth=-1, cat=None, min_data=5.0):
    bins, g, h, w, fnb, fnan = data
    cfg = JaxGrowConfig(num_leaves=L, num_bins=B, max_depth=max_depth,
                        split=JaxSplitParams(min_data_in_leaf=min_data),
                        grower=grower, hist_method="scatter", chunk=1024)
    t, rl = jax_grow_tree(cfg, jnp.asarray(bins), jnp.asarray(g),
                          jnp.asarray(h), jnp.asarray(w),
                          jnp.ones((bins.shape[0],), bool), jnp.asarray(fnb),
                          jnp.asarray(fnan), None,
                          None if cat is None else jnp.asarray(cat))
    return t, np.asarray(rl)


def _port_grower(grower, L, B, data, max_depth=-1, cat=None, min_data=5.0,
                 pool_slots=0):
    bins, g, h, w, fnb, fnan = data
    cfg = GrowConfig(num_leaves=L, num_bins=B, max_depth=max_depth,
                     split=SplitParams(min_data_in_leaf=min_data),
                     grower=grower, pool_slots=pool_slots)
    return Grower(cfg, torch.from_numpy(bins.T.copy()), fnb, fnan,
                  feat_is_cat=cat)


def _port_tree(grower, L, B, data, **kw):
    gr = _port_grower(grower, L, B, data, **kw)
    _, g, h, w, _, _ = data
    weighted = not np.all(w == 1.0)
    t, rl = gr.grow(torch.from_numpy(g), torch.from_numpy(h),
                    row_weight=torch.from_numpy(w) if weighted else None)
    return t, rl.numpy(), gr


def _assert_same(jt, jrl, t, rl):
    nl = int(jt.num_leaves)
    assert t.num_leaves == nl
    for name in STRUCTURE:
        size = nl if name.startswith("leaf") else nl - 1
        np.testing.assert_array_equal(
            getattr(t, name)[:size], np.asarray(getattr(jt, name))[:size],
            err_msg=name)
    np.testing.assert_array_equal(rl, jrl)
    for name in VALUES:
        size = nl if name.startswith("leaf") else nl - 1
        np.testing.assert_allclose(
            getattr(t, name)[:size], np.asarray(getattr(jt, name))[:size],
            rtol=1e-4, atol=1e-5, err_msg=name)


LEVEL_CASES = {
    # a budget that does not bind under the depth cap
    "depth_cap": dict(L=16, max_depth=4),
    # the budget binds mid-level: the election ranks the frontier
    "binding_budget": dict(L=11),
    "nan_bins": dict(L=24, data=dict(nan=True)),
    "bagging_weights": dict(L=8, max_depth=3, data=dict(weighted=True)),
    "categorical": dict(L=16, cat=True),
}


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_level_grower_matches_jax(case):
    c = LEVEL_CASES[case]
    data = _fixture(**c.get("data", {}))
    cat = (np.arange(6) % 3 == 0) if c.get("cat") else None
    kw = dict(max_depth=c.get("max_depth", -1), cat=cat)
    jt, jrl = _jax_tree("level", c["L"], 31, data, **kw)
    t, rl, gr = _port_tree("level", c["L"], 31, data, **kw)
    _assert_same(jt, jrl, t, rl)
    # two read-backs per level after the root's one (and one of the
    # categorical masks)
    levels = int(t.leaf_depth[:t.num_leaves].max())
    assert gr.readbacks == 1 + 2 * levels + int(t.split_is_cat.any())


def test_level_equals_compact_when_the_budget_does_not_bind():
    """A depth cap the budget never reaches: both policies split the
    same leaves, so every row's output agrees (node numbering
    differs)."""
    data = _fixture()
    tl, rll, _ = _port_tree("level", 16, 31, data, max_depth=4)
    tc, rlc, gc = _port_tree("compact", 16, 31, data, max_depth=4)
    assert tl.num_leaves == tc.num_leaves
    np.testing.assert_allclose(tl.leaf_value[rll], tc.leaf_value[rlc],
                               atol=1e-5)
    assert gc.readbacks == tc.num_leaves


MASKED_CASES = {
    "plain": dict(L=31),
    "nan_bins": dict(L=31, data=dict(nan=True)),
    "bagging_weights": dict(L=15, data=dict(weighted=True)),
    "categorical": dict(L=16, cat=True),
    "max_depth": dict(L=31, max_depth=3),
}


@pytest.mark.parametrize("case", sorted(MASKED_CASES))
def test_masked_grower_matches_jax_and_the_compact_grower(case):
    c = MASKED_CASES[case]
    data = _fixture(n=4000, **c.get("data", {}))
    cat = (np.arange(6) % 3 == 0) if c.get("cat") else None
    kw = dict(max_depth=c.get("max_depth", -1), cat=cat)
    jt, jrl = _jax_tree("masked", c["L"], 31, data, **kw)
    t, rl, gr = _port_tree("masked", c["L"], 31, data, **kw)
    _assert_same(jt, jrl, t, rl)
    assert gr.readbacks == t.num_leaves + int(t.split_is_cat.any())
    tc, rlc, _ = _port_tree("compact", c["L"], 31, data, **kw)
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(t, name), getattr(tc, name),
                                      err_msg=name)
    np.testing.assert_array_equal(rl, rlc)
    np.testing.assert_allclose(t.leaf_value, tc.leaf_value, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("grower,cfg", [
    ("level", dict(quantized=True)),
    ("level", dict(bynode=0.5)),
    ("level", dict(split=SplitParams(path_smooth=1.0))),
    ("level", dict(pool_slots=4)),
    ("masked", dict(bynode=0.5)),
    ("masked", dict(split=SplitParams(path_smooth=1.0))),
])
def test_growers_refuse_what_jax_refuses(grower, cfg):
    """The JAX ``grow_tree_impl`` raises NotImplementedError outside each
    grower's core set; the port's Grower does too."""
    data = _fixture(n=500)
    jcfg = dict(cfg)
    if "pool_slots" in jcfg:
        jcfg["hist_pool_slots"] = jcfg.pop("pool_slots")
    if "split" in jcfg:
        jcfg["split"] = JaxSplitParams(path_smooth=1.0)
    with pytest.raises(NotImplementedError):
        bins, g, h, w, fnb, fnan = data
        jax_grow_tree(JaxGrowConfig(num_leaves=4, num_bins=31,
                                    grower=grower, **jcfg),
                      jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                      jnp.asarray(w), jnp.ones((6,), bool),
                      jnp.asarray(fnb), jnp.asarray(fnan))
    with pytest.raises(NotImplementedError):
        Grower(GrowConfig(num_leaves=4, num_bins=31, grower=grower, **cfg),
               torch.from_numpy(data[0].T.copy()), data[4], data[5])


def _xy(n=2500, F=8, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, F)
    X[rs.rand(n, F) < 0.05] = np.nan
    y = ((np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
          - 0.3 * np.nan_to_num(X[:, 2]) + 0.3 * rs.randn(n)) > 0) * 1.0
    return X, y


BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
        "min_data_in_leaf": 10, "seed": 3}


def _train_both(params, rounds=3, X=None, y=None):
    if X is None:
        X, y = _xy()
    jb = jlgb.train({**params, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y, params=params), rounds)
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, params={**params, **CPU}),
                    rounds)
    return jb, tb


def _same_trees(a, b, exact_values=False):
    assert len(a._models) == len(b._models)
    for x, z in zip(a._models, b._models):
        assert x.num_leaves == z.num_leaves
        for k in TREE:
            np.testing.assert_array_equal(getattr(x, k), getattr(z, k),
                                          err_msg=k)
        np.testing.assert_allclose(x.leaf_value, z.leaf_value,
                                   rtol=0 if exact_values else 1e-4,
                                   atol=0 if exact_values else 1e-5)


@pytest.mark.parametrize("grower", ["level", "masked"])
def test_train_with_a_grower_matches_jax(grower):
    jb, tb = _train_both({**BASE, "grower": grower})
    assert tb._engine.grower.cfg.grower == grower
    _same_trees(jb, tb)
    X, _ = _xy()
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), atol=1e-6)


@pytest.mark.parametrize("extra", [
    {"use_quantized_grad": True, "stochastic_rounding": False},
    {"path_smooth": 1.0},
    {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0]},
    {"interaction_constraints": [[0, 1], [2, 3, 4, 5, 6, 7]]},
    {"cegb_penalty_split": 1e-4},
    {"feature_fraction_bynode": 0.5},
])
def test_runs_outside_the_core_set_move_to_compact_like_jax(extra):
    """The JAX booster moves quantized, path-smoothed, monotone,
    interaction-constrained, CEGB and bynode runs (and forced splits) to
    the compact grower without a word; so does the port, whose trees are
    then the compact grower's."""
    X, y = _xy(n=1500)
    params = {**BASE, "grower": "level", **extra}
    jb = jlgb.Booster(params=params, train_set=jlgb.Dataset(
        X, label=y, params=params))
    assert jb._engine.grow_cfg.grower == "compact"
    tb = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, params=CPU), 2)
    assert tb._engine.grower.cfg.grower == "compact"
    tc = tlgb.train({**params, **CPU, "grower": "compact"},
                    tlgb.Dataset(X, label=y, params=CPU), 2)
    _same_trees(tc, tb, exact_values=True)


def test_masked_grower_warns_on_large_data(monkeypatch):
    X, y = _xy(n=600)
    seen = []
    from lightgbm_tpu_torch.models import gbdt
    monkeypatch.setattr(gbdt, "log_warning", seen.append)
    tlgb.train({**BASE, **CPU, "grower": "masked", "num_leaves": 100000},
               tlgb.Dataset(X, label=y, params=CPU), 1)
    assert seen and "grower=masked" in seen[0]


def test_unknown_grower_raises_like_jax():
    X, y = _xy(n=300)
    for lgb, p in ((jlgb, {}), (tlgb, CPU)):
        with pytest.raises(ValueError, match="Unknown grower"):
            lgb.train({**BASE, **p, "grower": "wide"},
                      lgb.Dataset(X, label=y, params=p), 1)


def _pool_mb(slots, F=8, bins=256):
    """``histogram_pool_size`` (MB) that gives ``slots`` slots."""
    return (slots + 0.4) * F * bins * 2 * 4 / 2 ** 20


QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}
POOL_CASES = {
    "quantized": QUANT,
    "float": {},
    "cegb": {**QUANT, "cegb_penalty_split": 1e-4, "cegb_tradeoff": 0.5,
             "cegb_penalty_feature_coupled": [0.01] * 8},
    "intermediate_monotone": {
        **QUANT, "monotone_constraints": [1, -1] + [0] * 6,
        "monotone_constraints_method": "intermediate"},
    "forced": {**QUANT, "forcedsplits_filename": "FORCED"},
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooled_trees_equal_unpooled(case, tmp_path):
    """The cases of tests/test_hist_pool.py: a pool of 6 slots under 31
    leaves equals the full cache tree for tree (quantized histograms are
    exact; on this float fixture no recomputed histogram flips a split).
    The re-search (CEGB, intermediate monotone) and the forced splits
    read evicted leaves through the pool. The quantized and float runs
    also equal the JAX package's pooled ones; two iterations, since by
    the third the last bit of the JAX package's sigmoid moves a quantized
    gradient's rounding on this data (ROADMAP.md Queue 3, "XLA's
    arithmetic"), with or without the pool."""
    extra = dict(POOL_CASES[case])
    if extra.get("forcedsplits_filename") == "FORCED":
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({"feature": 0, "threshold": 0.0,
                                    "left": {"feature": 1,
                                             "threshold": 0.0}}))
        extra["forcedsplits_filename"] = str(path)
    params = {**BASE, "num_leaves": 31, **extra}
    X, y = _xy()
    full = tlgb.train({**params, **CPU},
                      tlgb.Dataset(X, label=y, params=CPU), 2)
    pooled_params = {**params, "histogram_pool_size": _pool_mb(6)}
    pooled = tlgb.train({**pooled_params, **CPU},
                        tlgb.Dataset(X, label=y, params=CPU), 2)
    g = pooled._engine.grower
    assert g.cfg.pool_slots == 6 and g.pooled and g.pool_misses > 0
    _same_trees(full, pooled, exact_values=case != "float")
    if case in ("quantized", "float"):
        jb = jlgb.train({**pooled_params, "hist_method": "scatter"},
                        jlgb.Dataset(X, label=y), 2)
        assert jb._engine.grow_cfg.hist_pool_slots == 6
        _same_trees(jb, pooled)


def test_pool_is_off_when_the_budget_suffices():
    X, y = _xy(n=800)
    params = {**BASE, "num_leaves": 7, "histogram_pool_size": 512.0}
    jb = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, label=y))
    assert jb._engine.grow_cfg.hist_pool_slots == 0
    tb = tlgb.Booster(params={**params, **CPU},
                      train_set=tlgb.Dataset(X, label=y, params=CPU))
    assert tb._engine.grower.cfg.pool_slots == 0
    assert not tb._engine.grower.pooled


@pytest.mark.parametrize("cnt,n", [(1, 10_500_000), (2, 7), (100, 4000),
                                   (2 ** 20, 2 ** 20 + 1),
                                   (3000, 10_500_000), (4000, 4000)])
def test_masked_bound_gives_the_windows_fixed_point_scale(cnt, n):
    """K1's float path scales its fixed point by the rows of the pass
    (``fixed_exponent``); the masked pass over ``n`` rows, with the
    bound of :func:`masked_absmax`, takes the scale of a window of the
    ``cnt`` rows that carry payload, so its sums are the window's."""
    for amax in (0.25, 0.7310586, 3.0e-3, 117.5):
        a = torch.tensor([amax, amax / 3], dtype=torch.float32)
        got = masked_absmax(a, torch.tensor(cnt), n)
        for c in range(2):
            assert fixed_exponent(float(got[c]), n) == \
                fixed_exponent(float(a[c]), cnt)
