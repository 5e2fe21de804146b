"""Quantized-gradient training in the port (lightgbm_tpu_torch:
ops/quantize.py, the int path of K1 in ops/histogram.py, the int8
payload of K2 in ops/partition.py, the quantized Grower and the boosting
loop) held against the JAX package on the CPU.

- K1's int path, plain version: bit-exact (``np.array_equal``) against
  the JAX ``hist_from_rows_int`` through the Pallas kernel in interpret
  mode and through the scatter path, u8 and u16, window sides, sibling
  subtraction and the blocked 127-magnitude case;
- the grower: with JAX's uniform draw handed in as ``noise`` (or the
  deterministic rounding), trees identical in structure and
  ``row_leaf``, leaf values to rtol=1e-4, atol=1e-5;
- ``lgb.train`` end to end with ``stochastic_rounding=False``: identical
  trees, predictions within 1e-5, model text that loads across the
  packages; the port's own stochastic rounding is unbiased and seeded.
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
from lightgbm_tpu.ops.histogram import hist_from_rows_int as jax_hist_int
from lightgbm_tpu.ops.pallas_hist import INT_BLOCK, hist_from_rows_pallas
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch.ops.grow import GrowConfig, Grower
from lightgbm_tpu_torch.ops.histogram import (hist_from_rows_int,
                                              hist_plain, window_hist)
from lightgbm_tpu_torch.ops.partition import INT_MAX, partition_window
from lightgbm_tpu_torch.ops.quantize import dequantize, discretize
from lightgbm_tpu_torch.ops.split import SplitParams

CPU = {"device_type": "cpu"}
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


def _rows_q(S, F, B, dtype, seed):
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, B, (S, F)).astype(dtype)
    pay = rs.randint(-127, 128, (S, 2)).astype(np.int8)
    return rows, pay


def _port_int(rows, pay, B):
    out = hist_from_rows_int(torch.from_numpy(rows), torch.from_numpy(pay),
                             B)
    assert out.dtype == torch.int32
    return out.numpy()


# ---- K1, int path -----------------------------------------------------

@pytest.mark.parametrize("S,F,B,dtype", [(5000, 11, 67, np.uint8),
                                         (4097, 9, 255, np.uint8),
                                         (130, 1, 2, np.uint8),
                                         (3000, 5, 300, np.uint16)])
def test_k1_int_plain_matches_pallas_and_scatter(S, F, B, dtype):
    rows, pay = _rows_q(S, F, B, dtype, 3)
    got = _port_int(rows, pay, B)
    assert got.shape == (F, B, 2)
    pallas = np.asarray(jax_hist_int(jnp.asarray(rows), jnp.asarray(pay),
                                     B, method="pallas"))
    scatter = np.asarray(jax_hist_int(jnp.asarray(rows), jnp.asarray(pay),
                                      B, method="scatter"))
    assert pallas.dtype == scatter.dtype == np.int32
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, scatter)


def test_k1_int_plain_blocked_worst_case_matches_pallas():
    """More rows than one int-exact super-block of the TPU kernel, every
    payload 127: an f32 accumulator over all rows would lose exactness
    past 2^24, the int32 sum keeps it."""
    rs = np.random.RandomState(6)
    S, F, B = INT_BLOCK + 9000, 2, 16
    rows = rs.randint(0, B, (S, F)).astype(np.uint8)
    pay = np.full((S, 2), 127, np.int8)
    got = _port_int(rows, pay, B)
    want = np.asarray(hist_from_rows_pallas(jnp.asarray(rows),
                                            jnp.asarray(pay), B,
                                            int_exact=True))
    assert np.array_equal(got, want)
    # every row lands in one bin of each feature: the bins of a feature
    # sum to S * 127, past 2^24
    assert np.array_equal(got.astype(np.int64).sum(axis=1),
                          np.full((F, 2), S * 127))


@pytest.mark.parametrize("side", [0, 1, 2])
def test_k1_int_window_sides_match_jax(side):
    rows, pay = _rows_q(2000, 6, 40, np.uint8, 5)
    start, cnt, nl = 150, 1500, 620
    got = window_hist(torch.from_numpy(rows), torch.from_numpy(pay), 40,
                      start, cnt, torch.tensor([nl], dtype=torch.int32),
                      side).numpy()
    lo, hi = {0: (start, start + cnt), 1: (start, start + nl),
              2: (start + nl, start + cnt)}[side]
    want = np.asarray(jax_hist_int(jnp.asarray(rows[lo:hi]),
                                   jnp.asarray(pay[lo:hi]), 40,
                                   method="scatter"))
    assert np.array_equal(got, want)


def test_k1_int_sibling_subtraction_is_exact():
    rs = np.random.RandomState(7)
    rows, pay = _rows_q(6000, 9, 63, np.uint8, 7)
    left = rs.rand(6000) < 0.37
    h_all = _port_int(rows, pay, 63)
    h_left = _port_int(rows[left], pay[left], 63)
    want = np.asarray(hist_from_rows_pallas(
        jnp.asarray(rows[~left]), jnp.asarray(pay[~left]), 63,
        int_exact=True))
    assert np.array_equal(h_all - h_left, want)


# ---- K2, int8 payload -------------------------------------------------

@pytest.mark.parametrize("dtype,F", [(np.uint8, 6), (np.uint16, 8),
                                     (np.uint16, 9)])
def test_partition_moves_int8_payload_rows(dtype, F):
    rs = np.random.RandomState(13)
    n, B = 5000, 300 if dtype == np.uint16 else 64
    bins = rs.randint(0, B, (n, F)).astype(dtype)
    pay = rs.randint(-127, 128, (n, 2)).astype(np.int8)
    ids = rs.permutation(n).astype(np.int32)
    begin, cnt, f, t = 700, 3001, 2, B // 3
    src = [torch.from_numpy(a.copy()) for a in (bins, pay, ids)]
    dst = [torch.full_like(a, 7) for a in src]
    nl = partition_window(src[0], dst[0], src[1], dst[1], src[2], dst[2],
                          begin, cnt, f, t + 1, INT_MAX, -1, False)
    gl = bins[begin:begin + cnt, f].astype(np.int64) <= t
    order = np.concatenate([np.nonzero(gl)[0], np.nonzero(~gl)[0]])
    assert int(nl.item()) == int(gl.sum())
    for a, d in zip((bins, pay, ids), dst):
        d = d.numpy()
        assert np.array_equal(d[begin:begin + cnt],
                              a[begin:begin + cnt][order])
        assert np.all(d[:begin] == 7) and np.all(d[begin + cnt:] == 7)


# ---- discretization ---------------------------------------------------

def test_discretize_is_unbiased_and_seeded():
    """Stochastic rounding: E[floor(x + u)] = x, so the mean of the
    dequantized values is the float mean up to sampling noise (3 sigma
    of the rounding's own variance); one generator seed gives one
    draw."""
    rs = np.random.RandomState(0)
    n = 20000
    g = torch.from_numpy(rs.randn(n).astype(np.float32))
    h = torch.from_numpy((rs.rand(n) + 0.1).astype(np.float32))

    def draw(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return discretize(g, h, None, 4, torch.rand((n, 2), generator=gen))

    q, scale = draw(3)
    q2, scale2 = draw(3)
    assert q.dtype == torch.int8 and torch.equal(q, q2) \
        and torch.equal(scale, scale2)
    assert not torch.equal(q, draw(4)[0])
    deq = dequantize(q.to(torch.int32), scale).double()
    for c, x in enumerate((g.double(), h.double())):
        frac = x / float(scale[c]) - torch.floor(x / float(scale[c]))
        sigma = float(scale[c]) * float(
            torch.sqrt((frac * (1 - frac)).sum())) / n
        assert abs(float(deq[:, c].mean() - x.mean())) <= 3 * sigma
    # the deterministic rounding is round-half-up of the same values
    qd, _ = discretize(g, h, None, 4, None)
    want = torch.floor(g / scale[0] + 0.5).clamp(-127, 127)
    assert torch.equal(qd[:, 0].to(torch.float32), want)


# ---- the grower against the JAX compact grower ------------------------

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


def _grow_quant_both(n, F, B, L, seed, with_nan, chunk, stochastic,
                     renew, hist_method="scatter", key_seed=7):
    bins, g, h, fnb, fnan = _mk(n, F, B, seed=seed, with_nan_bin=with_nan)
    sp = dict(min_data_in_leaf=5.0)
    key = jax.random.PRNGKey(key_seed) if stochastic else None
    jcfg = JaxGrowConfig(num_leaves=L, num_bins=B,
                         split=JaxSplitParams(**sp), grower="compact",
                         hist_method=hist_method, chunk=chunk,
                         quantized=True, quant_bins=4, renew_leaf=renew,
                         stochastic=stochastic)
    jt, jrl = jax_grow_tree(jcfg, jnp.asarray(bins), jnp.asarray(g),
                            jnp.asarray(h), jnp.ones((n,), jnp.float32),
                            jnp.ones((F,), bool), jnp.asarray(fnb),
                            jnp.asarray(fnan), quant_key=key)
    # the grower's draw: jax.random.uniform(key, (n, 2)) in float32
    noise = None if key is None else torch.from_numpy(
        np.array(jax.random.uniform(key, (n, 2), jnp.float32)))
    cfg = GrowConfig(num_leaves=L, num_bins=B, split=SplitParams(**sp),
                     quantized=True, quant_bins=4, renew_leaf=renew)
    t, rl = Grower(cfg, torch.from_numpy(bins.T.copy()), fnb,
                   fnan).grow(torch.from_numpy(g), torch.from_numpy(h),
                              noise)
    return jt, np.asarray(jrl), t, rl.numpy()


def _assert_same_tree(jt, jrl, t, rl):
    assert t.num_leaves == int(jt.num_leaves) > 2
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert np.array_equal(rl, jrl)
    for name in ("leaf_value", "leaf_weight", "internal_value",
                 "internal_weight", "split_gain"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("renew", [False, True])
@pytest.mark.parametrize("with_nan", [False, True])
def test_quantized_grower_matches_jax(stochastic, renew, with_nan):
    _assert_same_tree(*_grow_quant_both(3000, 6, 64, 31, 2, with_nan, 256,
                                        stochastic, renew))


def test_quantized_grower_matches_jax_pallas_hist():
    """The JAX grower's histograms through the Pallas kernel (interpret
    mode) instead of the scatter path."""
    _assert_same_tree(*_grow_quant_both(3000, 6, 64, 15, 1, True, 16384,
                                        True, True, hist_method="pallas"))


@pytest.mark.parametrize("stochastic", [False, True])
def test_quantized_grower_is_exact_on_the_tie_fixture(stochastic):
    """The fixture of the float path's former equivalent-threshold
    divergence (ROADMAP.md Queue 3): exact int32 histograms leave the
    empty bins between equivalent thresholds at exactly zero, and the
    split scan sums in the JAX package's order, so every threshold is
    the JAX package's."""
    _assert_same_tree(*_grow_quant_both(5000, 9, 64, 31, 0, False, 512,
                                        stochastic, False))


# ---- end to end ---------------------------------------------------------

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


QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}


def _binary_data():
    rs = np.random.RandomState(9)
    X = rs.randn(2500, 8).astype(np.float32)
    y = ((X @ rs.randn(8)) > 0).astype(np.float64)
    return X, y


def _nan_regression_data():
    rs = np.random.RandomState(3)
    X = rs.randn(2000, 6)
    X[rs.rand(2000, 6) < 0.1] = np.nan
    y = np.nan_to_num(X[:, 0]) * 2 + np.nan_to_num(X[:, 1]) ** 2
    return X, y


@pytest.mark.parametrize("renew", [False, True])
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_end_to_end_quantized_matches_jax(objective, renew):
    X, y = _binary_data() if objective == "binary" \
        else _nan_regression_data()
    p = {"objective": objective, "num_leaves": 12, "max_bin": 63,
         "min_data_in_leaf": 10, "verbosity": -1, **QUANT,
         "quant_train_renew_leaf": renew}
    ja = jlgb.train({**p, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y, params={"max_bin": 63}),
                    num_boost_round=4)
    tb = tlgb.train({**p, **CPU},
                    tlgb.Dataset(X, label=y, params={"max_bin": 63}),
                    num_boost_round=4)
    _same_trees(ja, tb)
    np.testing.assert_allclose(tb.predict(X), ja.predict(X), rtol=1e-5,
                               atol=1e-5)


def test_quantized_model_text_loads_across_packages(tmp_path):
    X, y = _binary_data()
    p = {"objective": "binary", "num_leaves": 10, "verbosity": -1,
         **QUANT, "quant_train_renew_leaf": True}
    ja = jlgb.train({**p, "hist_method": "scatter"},
                    jlgb.Dataset(X, label=y), num_boost_round=3)
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(X, label=y),
                    num_boost_round=3)
    tb.save_model(tmp_path / "port.txt")
    ja.save_model(str(tmp_path / "jax.txt"))
    j_from_t = jlgb.Booster(model_file=str(tmp_path / "port.txt"))
    t_from_j = tlgb.Booster(model_file=str(tmp_path / "jax.txt"),
                            params=CPU)
    np.testing.assert_allclose(j_from_t.predict(X), tb.predict(X),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_from_j.predict(X), ja.predict(X),
                               rtol=0, atol=1e-6)


def test_stochastic_rounding_is_seeded_end_to_end():
    X, y = _binary_data()
    p = {"objective": "binary", "num_leaves": 10, "verbosity": -1,
         "use_quantized_grad": True, **CPU}

    def model(**extra):
        bst = tlgb.train({**p, **extra}, tlgb.Dataset(X, label=y), 3)
        return bst.model_to_string().split("parameters:")[0]

    assert model(seed=5) == model(seed=5)
    assert model(seed=5) != model(seed=6)
    # the default seed is 0, as in the JAX package
    assert model() == model(seed=0)


def test_quantized_parameters_are_checked():
    X, y = _binary_data()
    with pytest.raises(ValueError, match="num_grad_quant_bins"):
        tlgb.train({"objective": "binary", "use_quantized_grad": True,
                    "num_grad_quant_bins": 1, **CPU},
                   tlgb.Dataset(X, label=y), 1)


def test_hist_plain_int_path_is_exact_at_int8_extremes():
    rows = torch.zeros((1000, 1), dtype=torch.uint8)
    pay = torch.full((1000, 2), -127, dtype=torch.int8)
    pay[:, 1] = 127
    out = hist_plain(rows, pay, 2)
    assert out.dtype == torch.int32
    assert out[0, 0].tolist() == [-127000, 127000]
    assert out[0, 1].tolist() == [0, 0]
