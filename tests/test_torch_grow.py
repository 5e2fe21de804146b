"""The port's split search and grower (lightgbm_tpu_torch/ops/split.py,
grow.py, predict.py) held against the JAX package on the CPU.

- find_best_split: the same (feature, threshold_bin, default_left) and
  gains within 1e-5, over the parameters the main path reads;
- the grower against the JAX compact grower with the scatter histogram
  on the tests/test_grower_equivalence.py fixtures (with and without a
  NaN bin, windows larger than one chunk): structure and row_leaf
  exact, leaf values to rtol=1e-4, atol=1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.grow import GrowConfig as JaxGrowConfig
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.histogram import build_histogram as jax_build_hist
from lightgbm_tpu.ops.predict import \
    predict_leaf_binned as jax_predict_leaf_binned
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split
from lightgbm_tpu_torch.ops.grow import GrowConfig, grow_tree
from lightgbm_tpu_torch.ops.predict import predict_leaf_binned
from lightgbm_tpu_torch.ops.split import F_, SplitParams, find_best_split

STRUCTURE = ("split_feature", "threshold_bin", "default_left",
             "left_child", "right_child", "leaf_parent", "leaf_depth",
             "leaf_count", "internal_count")
VALUES = ("leaf_value", "leaf_weight", "internal_value", "internal_weight",
          "split_gain")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the test workers share the machine's cores, and
    these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(n, F, B, seed=0, with_nan_bin=False):
    """The fixture of tests/test_grower_equivalence.py, as numpy."""
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, B, size=(F, n)).astype(np.uint8)
    g = rs.randn(n).astype(np.float32)
    h = (np.abs(rs.randn(n)) + 0.1).astype(np.float32)
    fnb = np.full(F, B, np.int32)
    fnan = np.full(F, -1, np.int32)
    if with_nan_bin:
        fnan[::2] = B - 1
    return bins, g, h, fnb, fnan


PARAMS = [
    dict(),
    dict(min_data_in_leaf=5.0, lambda_l2=1.0),
    dict(lambda_l1=0.5, min_gain_to_split=0.1, min_data_in_leaf=1.0),
    dict(max_delta_step=0.3, min_sum_hessian_in_leaf=5.0),
]


@pytest.mark.parametrize("with_nan", [False, True])
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_find_best_split_matches_jax(with_nan, pi):
    bins, g, h, fnb, fnan = _mk(3000, 7, 32, seed=pi, with_nan_bin=with_nan)
    F, n = bins.shape
    rs = np.random.RandomState(10 + pi)
    mask = rs.rand(n) < 0.6
    fmask = np.ones(F, bool)
    fmask[3] = False
    hist = np.asarray(jax_build_hist(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        jnp.ones((n,), jnp.float32), jnp.asarray(mask), 32, "scatter"))
    pg, ph = g[mask].sum(dtype=np.float32), h[mask].sum(dtype=np.float32)
    pc = np.float32(mask.sum())
    want = jax_find_best_split(jnp.asarray(hist), jnp.float32(pg),
                               jnp.float32(ph), jnp.float32(pc),
                               jnp.asarray(fnb), jnp.asarray(fnan),
                               jnp.asarray(fmask),
                               JaxSplitParams(**PARAMS[pi]))
    rec = find_best_split(torch.from_numpy(hist.copy())[None],
                          torch.tensor([pg]), torch.tensor([ph]),
                          torch.tensor([pc]), torch.from_numpy(fnb),
                          torch.from_numpy(fnan), torch.from_numpy(fmask),
                          SplitParams(**PARAMS[pi]))[0].numpy()
    assert int(rec[F_["feature"]]) == int(want.feature)
    assert int(rec[F_["threshold_bin"]]) == int(want.threshold_bin)
    assert bool(rec[F_["default_left"]]) == bool(want.default_left)
    for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                 "right_sum_g", "right_sum_h", "right_count",
                 "left_output", "right_output"):
        np.testing.assert_allclose(rec[F_[name]],
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_find_best_split_no_valid_split_gives_minus_inf():
    hist = torch.zeros((1, 3, 8, 2))
    hist[0, :, 0, 1] = 1.0
    rec = find_best_split(hist, torch.tensor([0.0]), torch.tensor([1.0]),
                          torch.tensor([10.0]), torch.full((3,), 8),
                          torch.full((3,), -1), torch.ones(3, dtype=bool),
                          SplitParams())
    assert rec[0, F_["gain"]].item() == float("-inf")


def _grow_both(n, F, B, L, seed, with_nan, chunk, max_depth=-1,
               min_data=5.0):
    bins, g, h, fnb, fnan = _mk(n, F, B, seed=seed, with_nan_bin=with_nan)
    jcfg = JaxGrowConfig(num_leaves=L, num_bins=B, max_depth=max_depth,
                         split=JaxSplitParams(min_data_in_leaf=min_data),
                         grower="compact", hist_method="scatter",
                         chunk=chunk)
    jt, jrl = jax_grow_tree(jcfg, jnp.asarray(bins), jnp.asarray(g),
                            jnp.asarray(h), jnp.ones((n,), jnp.float32),
                            jnp.ones((F,), bool), jnp.asarray(fnb),
                            jnp.asarray(fnan))
    cfg = GrowConfig(num_leaves=L, num_bins=B, max_depth=max_depth,
                     split=SplitParams(min_data_in_leaf=min_data))
    t, rl = grow_tree(cfg, torch.from_numpy(bins.T.copy()),
                      torch.from_numpy(g), torch.from_numpy(h), fnb, fnan)
    return jt, np.asarray(jrl), t, rl.numpy(), bins, fnan


@pytest.mark.parametrize("n,F,B,L,seed,with_nan,chunk", [
    (3000, 6, 64, 15, 1, False, 16384),    # one chunk
    (3000, 6, 64, 15, 1, True, 16384),     # NaN bins
    (3000, 6, 64, 31, 2, True, 256),       # windows span many chunks
    (4096, 9, 64, 31, 0, False, 512),      # test_route_partition shape
])
def test_grower_matches_jax_compact_grower(n, F, B, L, seed, with_nan,
                                           chunk):
    jt, jrl, t, rl, _, _ = _grow_both(n, F, B, L, seed, with_nan, chunk)
    nl = int(jt.num_leaves)
    assert t.num_leaves == nl and nl > 2
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    for name in VALUES:
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert np.array_equal(rl, jrl)


def test_grower_tie_divergence_is_an_equivalent_threshold():
    """The fixture of a former divergence (ROADMAP.md Queue 3): two
    thresholds that cut a leaf's rows identically (the bins between
    them are empty in that leaf) tie in real arithmetic, and the
    float32 rounding of the split scan's prefix sums picks the winner.
    The port used to sum them in another order than the JAX package
    (torch's CPU cumsum accumulates in float64) and picked other,
    equivalent thresholds at nodes 17 and 27; it now sums in the order
    of XLA's CPU cumsum (ops/split.py ``_prefix_sums``), so on this
    fixture the trees are identical, threshold_bin included."""
    jt, jrl, t, rl, _, _ = _grow_both(5000, 9, 64, 31, 0, False, 512)
    assert np.array_equal(rl, jrl)
    assert t.num_leaves == int(jt.num_leaves) == 31
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    # not the hessian weights: a small leaf's is the difference of two
    # large float sums, which the packages take in different row chunks
    # (a few ulps of the parent's sum apart)
    for name in ("leaf_value", "internal_value", "split_gain"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape,dim", [((40, 7), 1), ((40, 64), 1),
                                       ((9, 64, 3), 1), ((2, 9, 64, 3), 2),
                                       ((2, 5, 255, 3), 2),
                                       ((3, 300, 3), 1)])
def test_prefix_sums_are_bit_identical_to_jax_cumsum(shape, dim):
    """The split scan's prefix sums round exactly as the JAX package's
    ``jnp.cumsum`` on the CPU (XLA's 16-element blocked order)."""
    from lightgbm_tpu_torch.ops.split import _prefix_sums
    rs = np.random.RandomState(len(shape) * 100 + shape[dim])
    x = (rs.randn(*shape) * 1000).astype(np.float32) * np.float32(0.37)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=dim))
    got = _prefix_sums(torch.from_numpy(x), dim).numpy()
    assert np.array_equal(got, want)


def test_grower_honours_max_depth():
    jt, jrl, t, rl, _, _ = _grow_both(3000, 6, 64, 31, 3, False, 16384,
                                      max_depth=3)
    assert t.num_leaves == int(jt.num_leaves) <= 8
    assert t.leaf_depth.max() <= 3
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert np.array_equal(rl, jrl)


def test_predict_leaf_binned_matches_jax_and_row_leaf():
    jt, jrl, t, rl, bins, fnan = _grow_both(3000, 6, 64, 31, 2, True, 256)
    nn = t.num_leaves - 1
    want = np.asarray(jax_predict_leaf_binned(
        jt.split_feature[:nn], jt.threshold_bin[:nn], jt.default_left[:nn],
        jt.left_child[:nn], jt.right_child[:nn], jnp.asarray(fnan),
        jnp.asarray(bins)))
    got = predict_leaf_binned(t.split_feature[:nn], t.threshold_bin[:nn],
                              t.default_left[:nn], t.left_child[:nn],
                              t.right_child[:nn], fnan,
                              torch.from_numpy(bins.T.copy()),
                              depth=int(t.leaf_depth.max()) + 1).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, rl)
