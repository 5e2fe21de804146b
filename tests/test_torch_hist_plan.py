"""K1's launch plan and fixed-point float path (lightgbm_tpu_torch/ops/
histogram.py, csrc/hist.cu), checked on the CPU.

The kernel itself runs only on the card, where chip_smoke.py holds the
float path bit for bit against ``chip_smoke.emulate_fixed``, the
emulation of its arithmetic. Here, on the CPU:

- :func:`launch_plan` at every window size of chip_smoke.py's ladder and
  at u16 widths: its shared memory fits one block's 227 KB, its feature
  groups cover every feature and its blocks every row;
- that same emulation (the scale choice, one rounding per row, exact
  int64 sums, one conversion) on inputs made with numpy: no int64 sum
  can overflow at 2^31 / 127 rows, the result agrees with the plain
  version and with the JAX package's Pallas kernel (interpret mode) at
  the shapes of tests/test_pallas_hist.py, tiny payloads do not
  underflow, a non-finite channel is NaN, and it is the same under any
  permutation of the rows. So kernel == emulation ~ JAX is one chain.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import emulate_fixed as _emulate
from chip_smoke import fixed_exponent
from lightgbm_tpu.ops.pallas_hist import hist_from_rows_pallas
from lightgbm_tpu_torch.ops.histogram import (MAX_STAGES, SMEM_BLOCK,
                                              SMEM_RESERVED, SMEM_SM,
                                              hist_plain, launch_plan,
                                              smem_bytes)

H100_SMS = 132
# chip_smoke.py's window ladder: the Higgs root, 1M (also the hot-bin
# window's size), ~100k, ~10k and ~1k rows, and the smallest windows
LADDER = (10_500_000, 1_000_000, 100_003, 10_007, 1_009, 33, 1)
# float sums taken in a different order than the JAX paths
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled when it ends, so that
    they do not count against the process-wide jit signature budgets
    that later tests on the same worker check."""
    yield
    jax.clear_caches()


def _check_plan(plan, cnt, F, B, bin_bytes, int_path):
    assert plan.smem == smem_bytes(F, plan.fg, B, bin_bytes, int_path,
                                   plan.tile_rows, plan.stages)
    assert plan.smem <= SMEM_BLOCK
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert 2 <= plan.stages <= MAX_STAGES
    assert 1 <= plan.fg <= F and plan.fg * -(-F // plan.fg) >= F
    # resident at once: the blocks never outnumber what the card holds
    per_sm = min(2048 // plan.threads,
                 SMEM_SM // (plan.smem + SMEM_RESERVED))
    assert per_sm >= 1 and 1 <= plan.nblocks <= per_sm * H100_SMS
    # the kernel's split of the window's tiles over the blocks
    tiles = -(-cnt // plan.tile_rows)
    per_block = -(-tiles // plan.nblocks)
    covered = set()
    for b in range(plan.nblocks):
        covered.update(range(b * per_block, min(tiles, (b + 1) * per_block)))
    assert covered == set(range(tiles))
    assert tiles * plan.tile_rows >= cnt


@pytest.mark.parametrize("int_path", [False, True])
@pytest.mark.parametrize("cnt", LADDER)
def test_launch_plan_fits_and_covers_the_ladder(cnt, int_path):
    plan = launch_plan(cnt, 28, 255, 1, H100_SMS, int_path)
    _check_plan(plan, cnt, 28, 255, 1, int_path)
    assert plan.fg == 28   # the Higgs shape takes all features at once


@pytest.mark.parametrize("int_path", [False, True])
@pytest.mark.parametrize("F", [8, 40])
@pytest.mark.parametrize("cnt", [10_500_000, 100_003, 1_009])
def test_launch_plan_fits_u16_widths(F, cnt, int_path):
    # max_bin=400: up to 401 bins with the NaN bin, u16 bins
    plan = launch_plan(cnt, F, 401, 2, H100_SMS, int_path)
    _check_plan(plan, cnt, F, 401, 2, int_path)


def test_launch_plan_refuses_bins_too_wide():
    with pytest.raises(ValueError, match="too wide"):
        launch_plan(1000, 4, 70_000, 2, H100_SMS, False)


# ---- the float path's fixed-point arithmetic (csrc/hist.cu) ----

def emulate_fixed(rows, pay, B, absmax=None):
    """chip_smoke.emulate_fixed on CPU tensors of numpy ``rows`` and
    ``pay``, by default at the window's own max |payload| (the wrapper's
    default scale bound), as a numpy array."""
    pay_t = torch.from_numpy(pay)
    if absmax is None:
        absmax = pay_t.abs().amax(dim=0)
    return _emulate(torch, torch.from_numpy(rows), pay_t, B,
                    absmax).numpy()


@pytest.mark.parametrize("cnt,amax", [
    (16_909_320, 1.0),            # 2^31 / 127 rows, binary gradients
    (16_909_320, 0.25),           # binary hessians
    (16_909_320, np.float32(np.nextafter(np.float32(1), np.float32(0)))),
    (1 << 24, 1.0),               # a power of two of rows
    ((1 << 24) + 1, 3.5e8),
    (1, 1e-30),
])
def test_fixed_point_sums_cannot_overflow(cnt, amax):
    """Every row rounded at the largest magnitude, all in one bin: the
    sum stays below 2^62, so no int64 sum (a block's or the window's)
    overflows."""
    k = fixed_exponent(amax, cnt)
    row = int(np.rint(np.float64(np.float32(amax)) * 2.0 ** k))
    assert row * cnt <= 2 ** 62 < 2 ** 63 - 1
    # and little of the range is wasted: 2^k is at most 4x too small
    # (amax >= 2^(e-1), cnt > 2^(lc-1))
    assert row * cnt >= 2 ** 60 or cnt == 1


@pytest.mark.parametrize("S,F,B", [(5000, 11, 67), (512, 8, 128),
                                   (130, 1, 2), (4097, 9, 255)])
def test_fixed_point_matches_plain_and_pallas(S, F, B):
    rs = np.random.RandomState(3)
    rows = rs.randint(0, B, (S, F)).astype(np.uint8)
    pay = np.stack([rs.randn(S), rs.rand(S)], axis=1).astype(np.float32)
    got = emulate_fixed(rows, pay, B)
    plain = hist_plain(torch.from_numpy(rows), torch.from_numpy(pay),
                       B).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    pallas = np.asarray(hist_from_rows_pallas(
        jnp.asarray(rows), jnp.asarray(pay), B, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_fixed_point_matches_plain_u16_wide_bins():
    rs = np.random.RandomState(4)
    S, F, B = 3000, 5, 300
    rows = rs.randint(0, B + 3, (S, F)).astype(np.uint16)  # some out of range
    pay = np.stack([rs.randn(S) * 1e3, rs.rand(S)], 1).astype(np.float32)
    got = emulate_fixed(rows, pay, B)
    plain = hist_plain(torch.from_numpy(rows.astype(np.int64)),
                       torch.from_numpy(pay), B).numpy()
    # |g| up to ~4e3: the plain version's own f32 rounding is ~1e-3
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_point_is_the_same_in_any_row_order(seed):
    """Exact integer sums: any order of the rows (any split over blocks,
    any order of atomics) gives the same bits; an f32 sum does not."""
    rs = np.random.RandomState(seed)
    S, F, B = 20_000, 6, 31
    rows = rs.randint(0, B, (S, F)).astype(np.uint8)
    rows[: S // 2, 2] = 7                          # a hot bin
    pay = np.stack([rs.randn(S) * 10.0 ** rs.randint(-6, 3, S),
                    rs.rand(S) * 0.25], 1).astype(np.float32)
    base = emulate_fixed(rows, pay, B)
    for _ in range(3):
        p = rs.permutation(S)
        assert np.array_equal(emulate_fixed(rows[p], pay[p], B), base)


def test_fixed_point_tiny_payloads_do_not_underflow():
    """At |payload| ~ 1e-30 the scale is 2^k with k > 149, where 2^-k is
    no float32: the conversion still gives the sums (hist.cu: ldexpf past
    the normal range)."""
    rs = np.random.RandomState(5)
    S, F, B = 300, 3, 7
    rows = rs.randint(0, B, (S, F)).astype(np.uint8)
    pay = (np.stack([rs.randn(S), rs.rand(S)], 1) * 1e-30).astype(np.float32)
    assert fixed_exponent(np.abs(pay).max(), S) > 149
    got = emulate_fixed(rows, pay, B)
    plain = hist_plain(torch.from_numpy(rows), torch.from_numpy(pay),
                       B).numpy()
    assert np.abs(plain).max() > 0
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-36)


def test_fixed_point_non_finite_channel_is_nan():
    """A non-finite max |payload| makes its channel NaN (so a non-finite
    gradient reaches the booster's guard) and leaves the other as it was."""
    rs = np.random.RandomState(6)
    S, F, B = 500, 4, 9
    rows = rs.randint(0, B, (S, F)).astype(np.uint8)
    pay = np.stack([rs.randn(S), rs.rand(S)], 1).astype(np.float32)
    pay[17, 0] = np.inf
    got = emulate_fixed(rows, pay, B)
    assert np.isnan(got[..., 0]).all()
    finite = pay.copy()
    finite[17, 0] = 0.0
    np.testing.assert_array_equal(got[..., 1],
                                  emulate_fixed(rows, finite, B)[..., 1])
