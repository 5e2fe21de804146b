"""The port's kernels (lightgbm_tpu_torch/ops/histogram.py, partition.py)
held against the JAX package on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version; these tests
hold those against the JAX package's Pallas kernels run in interpret
mode (as the JAX package's own tests run them) and its XLA paths, at the
shapes of tests/test_pallas_hist.py and tests/test_route_partition.py.
The CUDA kernels themselves are held against the same plain versions on
the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.ops.histogram import _hist_scatter
from lightgbm_tpu.ops.pallas_hist import hist_from_rows_pallas
from lightgbm_tpu.ops.partition_kernel import (route_concentrate,
                                               route_pair as jax_route_pair,
                                               stack_cols, unstack_cols)
from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.ops.histogram import (build_histogram,
                                              hist_from_rows, hist_plain,
                                              window_hist)
from lightgbm_tpu_torch.ops.partition import (partition_window,
                                              route_pair)

# float sums taken in a different order than the JAX paths
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the test workers share the machine's cores, and
    these tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows_pay(S, F, B, dtype, seed):
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, B, (S, F)).astype(dtype)
    pay = np.stack([rs.randn(S), rs.rand(S)], axis=1).astype(np.float32)
    return rows, pay


def _port_hist(rows, pay, B):
    return hist_from_rows(torch.from_numpy(rows), torch.from_numpy(pay),
                          B).numpy()


@pytest.mark.parametrize("S,F,B", [(5000, 11, 67), (512, 8, 128),
                                   (130, 1, 2), (4097, 9, 255)])
def test_k1_plain_matches_pallas_and_scatter_u8(S, F, B):
    rows, pay = _rows_pay(S, F, B, np.uint8, 3)
    got = _port_hist(rows, pay, B)
    assert got.shape == (F, B, 2) and got.dtype == np.float32
    pallas = np.asarray(hist_from_rows_pallas(
        jnp.asarray(rows), jnp.asarray(pay), B, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    scatter = np.asarray(_hist_scatter(jnp.asarray(rows.T),
                                       jnp.asarray(pay), B))
    np.testing.assert_allclose(got, scatter, **TOL)


def test_k1_plain_matches_pallas_u16_wide_bins():
    S, F, B = 3000, 5, 300
    rows, pay = _rows_pay(S, F, B, np.uint16, 4)
    got = _port_hist(rows, pay, B)
    pallas = np.asarray(hist_from_rows_pallas(
        jnp.asarray(rows), jnp.asarray(pay), B, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    scatter = np.asarray(_hist_scatter(jnp.asarray(rows.T),
                                       jnp.asarray(pay), B))
    np.testing.assert_allclose(got, scatter, **TOL)


def test_k1_sibling_subtraction_matches_pallas():
    rs = np.random.RandomState(7)
    S, F, B = 6000, 9, 63
    rows = rs.randint(0, B, (S, F)).astype(np.uint8)
    left = rs.rand(S) < 0.37
    pay = np.stack([rs.randn(S), rs.rand(S)], axis=1).astype(np.float32)
    h_all = _port_hist(rows, pay, B)
    h_left = _port_hist(rows, pay * left[:, None], B)
    sib = h_all - h_left
    ref = np.asarray(hist_from_rows_pallas(
        jnp.asarray(rows), jnp.asarray(pay * ~left[:, None]), B,
        interpret=True))
    np.testing.assert_allclose(sib, ref, rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("side", [0, 1, 2])
def test_window_hist_sides_select_the_child_windows(side):
    rows, pay = _rows_pay(900, 4, 17, np.uint8, 5)
    r, p = torch.from_numpy(rows), torch.from_numpy(pay)
    start, cnt, nl = 100, 700, 260
    got = window_hist(r, p, 17, start, cnt,
                      torch.tensor([nl], dtype=torch.int32), side)
    lo, hi = {0: (start, start + cnt), 1: (start, start + nl),
              2: (start + nl, start + cnt)}[side]
    want = hist_plain(r[lo:hi], p[lo:hi], 17)
    assert torch.equal(got, want)


def test_build_histogram_masks_and_weights_rows():
    rs = np.random.RandomState(6)
    n, F, B = 800, 3, 9
    bins_T = rs.randint(0, B, (F, n)).astype(np.uint8)
    g, h = rs.randn(n).astype(np.float32), rs.rand(n).astype(np.float32)
    w = (rs.rand(n) * 2).astype(np.float32)
    mask = rs.rand(n) < 0.5
    from lightgbm_tpu.ops.histogram import build_histogram as jax_build
    ref = np.asarray(jax_build(jnp.asarray(bins_T), jnp.asarray(g),
                               jnp.asarray(h), jnp.asarray(w),
                               jnp.asarray(mask), B, "scatter"))
    got = build_histogram(torch.from_numpy(bins_T.T.copy()),
                          torch.from_numpy(g), torch.from_numpy(h),
                          torch.from_numpy(w), torch.from_numpy(mask),
                          B).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


# ---- K2 -------------------------------------------------------------

def _port_route_pair(cols_np, mark_l, mark_r):
    A, spec = stack_cols(tuple(jnp.asarray(c) for c in cols_np))
    L, R = route_pair(torch.from_numpy(np.array(A)),
                      torch.from_numpy(mark_l), torch.from_numpy(mark_r))
    return (unstack_cols(jnp.asarray(L.numpy()), spec),
            unstack_cols(jnp.asarray(R.numpy()), spec))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_route_pair_plain_matches_route_concentrate_exhaustive(k):
    f = jax.jit(route_concentrate)
    col = np.arange(k, dtype=np.int32)
    for bits in range(2 ** k):
        mark = np.array([(bits >> i) & 1 for i in range(k)], bool)
        lc, rc = int(mark.sum()), int((~mark).sum())
        (L,), (R,) = _port_route_pair((col,), mark, ~mark)
        (wl,) = f((jnp.asarray(col),), jnp.asarray(mark), jnp.int32(0))
        (wr,) = f((jnp.asarray(col),), jnp.asarray(~mark),
                  jnp.int32(k - rc))
        assert np.array_equal(np.asarray(L)[:lc], np.asarray(wl)[:lc])
        assert np.array_equal(np.asarray(R)[k - rc:],
                              np.asarray(wr)[k - rc:])


def test_route_pair_plain_matches_route_concentrate_randomized():
    f = jax.jit(route_concentrate)
    rs = np.random.RandomState(7)
    for _ in range(40):
        k = 2 ** rs.randint(5, 13)
        r = rs.rand(k)
        frac = rs.rand()
        ml = r < frac * 0.5
        mr = (r >= frac * 0.5) & (r < frac * 0.5 + 0.4)
        lc, rc = int(ml.sum()), int(mr.sum())
        cols = (np.arange(k, dtype=np.int32),
                rs.randint(0, 2 ** 31, size=k).astype(np.uint32),
                rs.randn(k).astype(np.float32))
        Ls, Rs = _port_route_pair(cols, ml, mr)
        jl = f(tuple(jnp.asarray(c) for c in cols), jnp.asarray(ml),
               jnp.int32(0))
        jr = f(tuple(jnp.asarray(c) for c in cols), jnp.asarray(mr),
               jnp.int32(k - rc))
        for c, a, b in zip(cols, Ls, jl):
            assert np.array_equal(np.asarray(a)[:lc], np.asarray(b)[:lc])
            assert np.array_equal(np.asarray(a)[:lc], c[ml])
        for c, a, b in zip(cols, Rs, jr):
            assert np.array_equal(np.asarray(a)[k - rc:],
                                  np.asarray(b)[k - rc:])
            assert np.array_equal(np.asarray(a)[k - rc:], c[mr])


@pytest.mark.parametrize("k", [256, 1024])
def test_route_pair_plain_matches_pallas_route_pair(k):
    rs = np.random.RandomState(11)
    cols = (rs.randint(0, 2 ** 31, size=k).astype(np.uint32),
            rs.randn(k).astype(np.float32))
    r = rs.rand(k)
    vl, vr = r < 0.35, (r >= 0.35) & (r < 0.9)
    lc, rc = int(vl.sum()), int(vr.sum())
    A, spec = stack_cols(tuple(jnp.asarray(c) for c in cols))
    JL, JR = jax_route_pair(A, jnp.asarray(vl), jnp.asarray(vr),
                            interpret=True)
    L, R = route_pair(torch.from_numpy(np.array(A)), torch.from_numpy(vl),
                      torch.from_numpy(vr))
    assert np.array_equal(L.numpy()[:, :lc], np.asarray(JL)[:, :lc])
    assert np.array_equal(R.numpy()[:, k - rc:], np.asarray(JR)[:, k - rc:])


@pytest.mark.parametrize("dtype,nan_bin,dl", [(np.uint8, -1, False),
                                              (np.uint8, 5, True),
                                              (np.uint16, 299, False)])
def test_partition_window_matches_numpy_stable_partition(dtype, nan_bin,
                                                         dl):
    rs = np.random.RandomState(13)
    n, F, B = 5000, 6, 300 if dtype == np.uint16 else 64
    bins = rs.randint(0, B, (n, F)).astype(dtype)
    pay = rs.randn(n, 2).astype(np.float32)
    ids = rs.permutation(n).astype(np.int32)
    begin, cnt, f, t = 700, 3001, 2, B // 3
    src = [torch.from_numpy(a.copy()) for a in (bins, pay, ids)]
    dst = [torch.full_like(a, 7) for a in src]
    nl = partition_window(src[0], dst[0], src[1], dst[1], src[2], dst[2],
                          begin, cnt, f, t, dl, nan_bin)
    col = bins[begin:begin + cnt, f].astype(np.int64)
    gl = np.where((nan_bin >= 0) & (col == nan_bin), dl, col <= t)
    order = np.concatenate([np.nonzero(gl)[0], np.nonzero(~gl)[0]])
    assert int(nl.item()) == int(gl.sum()) and nl.dtype == torch.int32
    for a, d in zip((bins, pay, ids), dst):
        d = d.numpy()
        assert np.array_equal(d[begin:begin + cnt],
                              a[begin:begin + cnt][order])
        assert np.all(d[:begin] == 7) and np.all(d[begin + cnt:] == 7)


def test_wrappers_raise_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain fallback, and on a machine without nvcc the kernels' build
    raises instead of handing back a plain path."""
    rows = torch.zeros((8, 2), dtype=torch.uint8, device="meta")
    pay = torch.zeros((8, 2), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no histogram kernel"):
        window_hist(rows, pay, 4, 0, 8)
    with pytest.raises(ValueError, match="no partition kernel"):
        partition_window(rows, torch.empty_like(rows), None, None, None,
                         None, 0, 8, 0, 1, False, -1)
    # the int path (int8 payload) and the int8-payload partition too
    qpay = torch.zeros((8, 2), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no histogram kernel"):
        window_hist(rows, qpay, 4, 0, 8)
    with pytest.raises(ValueError, match="no partition kernel"):
        partition_window(rows, torch.empty_like(rows), qpay,
                         torch.empty_like(qpay), None, None, 0, 8, 0, 1,
                         False, -1)
    import shutil
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nvcc"):
            _cuda.library("hist")
