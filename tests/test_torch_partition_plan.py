"""K2's launch plan (lightgbm_tpu_torch/ops/partition.py, csrc/partition.cu),
checked on the CPU.

The kernel itself runs only on the card, where chip_smoke.py holds both of
its paths bit for bit against ``partition_plain``. Here, on the CPU, with
no kernel run:

- :func:`partition_plan` over window sizes from 1 row to the Higgs root,
  the resident capacity and one row past it, at widths of 1 to 1000 bins
  (u8 and u16) and payloads of 0, 2 and 8 bytes: its shared memory is the
  kernel's layout and fits one block's 227 KB; its slices or tiles cover
  ``[0, cnt)`` exactly; the resident grid never exceeds the SMs times the
  occupancy the plan assumes; the path switches exactly at the capacity;
  wide rows (F up to 4096) get a plan, and a row that cannot fit raises;
- the kernel's arithmetic under a plan (slices or tiles ranked on their
  own, lefts before each slice by a scan over the slices, left and right
  spans), emulated in numpy at a small shared-memory limit so that small
  windows take both paths, equals ``partition_plain``.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops.partition import (INT_MAX, MAX_ROWS,
                                              SMEM_BLOCK, STAGES,
                                              partition_plain,
                                              partition_plan,
                                              resident_capacity, smem_bytes)

H100_SMS = 132
WIDTHS = (1, 8, 9, 13, 28, 1000)
PAYLOADS = (0, 2, 8)
SIZES = (1, 33, 1_009, 10_007, 100_003, 10_500_000)


def _windows(F, bin_bytes, pay_bytes):
    cap = resident_capacity(F, bin_bytes, pay_bytes, H100_SMS)
    return SIZES + (cap, cap + 1)


def _check_plan(plan, cnt, F, bin_bytes, pay_bytes, num_sms=H100_SMS,
                limit=SMEM_BLOCK):
    assert plan.smem == smem_bytes(plan.rows, F, bin_bytes, pay_bytes,
                                   plan.stages)
    assert plan.smem <= limit
    assert 1 <= plan.rows <= MAX_ROWS
    # csrc/partition.cu takes up to 512 threads (its launch bound)
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    assert plan.per_sm >= 1
    if plan.path == "resident":
        assert plan.stages == 1 and plan.tiles == plan.nblocks
        # one cooperative launch: every block resident at once
        assert 1 <= plan.nblocks <= min(num_sms, plan.per_sm * num_sms)
        # the slices [b * rows, (b + 1) * rows) cover [0, cnt), none empty
        assert (plan.nblocks - 1) * plan.rows < cnt \
            <= plan.nblocks * plan.rows
    else:
        assert plan.path == "stream" and plan.stages == STAGES
        assert (plan.tiles - 1) * plan.rows < cnt <= plan.tiles * plan.rows
        assert 1 <= plan.nblocks <= min(plan.tiles, plan.per_sm * num_sms)
        # part_move's runs of tiles: each tile in exactly one block's run
        per = -(-plan.tiles // plan.nblocks)
        runs = [range(b * per, min(plan.tiles, (b + 1) * per))
                for b in range(plan.nblocks)]
        assert sum(len(r) for r in runs) == plan.tiles
        assert [t for r in runs for t in r] == list(range(plan.tiles))


@pytest.mark.parametrize("bin_bytes", [1, 2])
@pytest.mark.parametrize("F", WIDTHS)
def test_plan_fits_and_covers_every_window(F, bin_bytes):
    for pay_bytes in PAYLOADS:
        for cnt in _windows(F, bin_bytes, pay_bytes):
            plan = partition_plan(cnt, F, bin_bytes, pay_bytes, H100_SMS)
            _check_plan(plan, cnt, F, bin_bytes, pay_bytes)


@pytest.mark.parametrize("pay_bytes", PAYLOADS)
@pytest.mark.parametrize("F,bin_bytes", [(28, 1), (13, 1), (9, 2),
                                         (1000, 2)])
def test_path_switches_exactly_at_the_capacity(F, bin_bytes, pay_bytes):
    cap = resident_capacity(F, bin_bytes, pay_bytes, H100_SMS)
    at = partition_plan(cap, F, bin_bytes, pay_bytes, H100_SMS)
    past = partition_plan(cap + 1, F, bin_bytes, pay_bytes, H100_SMS)
    assert at.path == "resident" and past.path == "stream"
    # at the capacity every SM's block is full: one more row would not fit
    assert at.nblocks == H100_SMS
    assert smem_bytes(at.rows + 1, F, bin_bytes, pay_bytes,
                      1) > SMEM_BLOCK or at.rows == MAX_ROWS


def test_capacity_at_the_higgs_shape():
    """About 730k rows of 28 u8 bins and an f32 pair: every window of a
    Higgs tree but the root and the first few levels is resident."""
    assert 700_000 < resident_capacity(28, 1, 8, H100_SMS) < 750_000
    assert resident_capacity(28, 1, 2, H100_SMS) \
        > resident_capacity(28, 1, 8, H100_SMS)
    assert partition_plan(10_500_000, 28, 1, 8, H100_SMS).path == "stream"
    assert partition_plan(100_000, 28, 1, 8, H100_SMS).path == "resident"


@pytest.mark.parametrize("bin_bytes", [1, 2])
@pytest.mark.parametrize("F", [1000, 2048, 4096])
def test_wide_rows_get_a_plan(F, bin_bytes):
    for pay_bytes in PAYLOADS:
        for cnt in _windows(F, bin_bytes, pay_bytes):
            plan = partition_plan(cnt, F, bin_bytes, pay_bytes, H100_SMS)
            _check_plan(plan, cnt, F, bin_bytes, pay_bytes)


def test_rows_that_cannot_fit_raise():
    # a row must fit twice beside the rank table
    with pytest.raises(ValueError, match="too wide"):
        partition_plan(10, 60_000, 2, 8, H100_SMS)
    with pytest.raises(ValueError, match="too wide"):
        partition_plan(10, 5_000, 1, 0, H100_SMS, smem_limit=8_000)
    with pytest.raises(ValueError, match="windows of 1"):
        partition_plan(0, 28, 1, 8, H100_SMS)


def test_small_window_takes_few_blocks():
    assert partition_plan(1, 28, 1, 8, H100_SMS).nblocks == 1
    assert partition_plan(33, 28, 1, 8, H100_SMS).nblocks == 1
    assert partition_plan(1_009, 28, 1, 8, H100_SMS).nblocks == 8
    assert partition_plan(100_003, 28, 1, 8, H100_SMS).nblocks == H100_SMS
    # small slices take fewer threads
    assert partition_plan(10_007, 28, 1, 8, H100_SMS).threads == 256
    assert partition_plan(100_003, 28, 1, 8, H100_SMS).threads == 512


# ---- the kernel's arithmetic under a plan ----

def _emulate(plan, bins, pay, ids, begin, cnt, f, t, dl, nan_bin):
    """csrc/partition.cu's arithmetic in numpy: the window cut into the
    plan's slices (resident) or tiles (stream), each ranked stably on its
    own; the lefts before each (resident: the blocks' counts after the
    grid barrier; stream: the tiles' inclusive prefixes from the column
    pass); a slice's left run to ``before + k`` and its right run to
    ``n_left + (row0 - before) + k``."""
    col = bins[begin:begin + cnt, f].astype(np.int64)
    gl = np.where((nan_bin >= 0) & (col == nan_bin), dl, col <= t)
    n = plan.nblocks if plan.path == "resident" else plan.tiles
    counts = [int(gl[s * plan.rows:(s + 1) * plan.rows].sum())
              for s in range(n)]
    before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_left = int(sum(counts))
    outs = [None if a is None else a.copy() for a in (bins, pay, ids)]
    for s in range(n):
        r0 = s * plan.rows
        g = gl[r0:r0 + plan.rows]
        perm = np.concatenate([np.nonzero(g)[0], np.nonzero(~g)[0]])
        nl = int(g.sum())
        dest = np.where(np.arange(len(perm)) < nl,
                        before[s] + np.arange(len(perm)),
                        n_left + (r0 - before[s]) + np.arange(len(perm))
                        - nl)
        for src, out in zip((bins, pay, ids), outs):
            if src is not None:
                out[begin + dest] = src[begin + r0 + perm]
    return n_left, outs


@pytest.mark.parametrize("pay_dtype", [None, np.int8, np.float32])
@pytest.mark.parametrize("bin_dtype,F", [(np.uint8, 13), (np.uint16, 5)])
def test_emulated_kernel_matches_plain_on_both_paths(bin_dtype, F,
                                                     pay_dtype):
    rs = np.random.RandomState(5)
    n, B = 9_000, 300 if bin_dtype == np.uint16 else 200
    bins = rs.randint(0, B, (n, F)).astype(bin_dtype)
    pay = None if pay_dtype is None else \
        (rs.randn(n, 2) * 50).astype(pay_dtype)
    ids = rs.permutation(n).astype(np.int32)
    bb = np.dtype(bin_dtype).itemsize
    pb = 0 if pay is None else 2 * pay.itemsize
    # a small card (4 SMs of 6 KB) so that small windows take both paths
    sms, limit = 4, 6_000
    cap = resident_capacity(F, bb, pb, sms, limit)
    paths = set()
    for begin, cnt, t, nan_bin in ((3, cap, B // 2, 7), (0, cap + 1, B // 3,
                                                         -1),
                                   (101, 7_777, B // 4, 0),
                                   (17, 1, B // 2, -1), (5, 33, -1, -1),
                                   (9, 2_000, B, -1)):
        plan = partition_plan(cnt, F, bb, pb, sms, smem_limit=limit)
        _check_plan(plan, cnt, F, bb, pb, sms, limit)
        paths.add(plan.path)
        n_left, outs = _emulate(plan, bins, pay, ids, begin, cnt, 2, t,
                                True, nan_bin)
        src = [None if a is None else torch.from_numpy(a.copy())
               for a in (bins, pay, ids)]
        dst = [None if a is None else torch.from_numpy(a.copy())
               for a in (bins, pay, ids)]
        nl = partition_plain(src[0], dst[0], src[1], dst[1], src[2], dst[2],
                             begin, cnt, 2, t + 1, INT_MAX, nan_bin, True)
        assert int(nl.item()) == n_left
        for got, want in zip(outs, dst):
            if want is not None:
                assert np.array_equal(got, want.numpy())
    assert paths == {"resident", "stream"}


# ---- the wrapper's rules around the launch ----

class _FakeLib:
    """Stands in for the built csrc/partition.cu: records the calls and
    returns the given codes."""

    def __init__(self, cooperative=1, err=0):
        self.cooperative, self.err, self.calls = cooperative, err, 0

    def partition_cooperative(self, device):
        return self.cooperative

    def partition_window(self, *args):
        self.calls += 1
        return self.err


def _window(n=5_000, F=28):
    rows = torch.zeros((n, F), dtype=torch.uint8)
    pay = torch.zeros((n, 2), dtype=torch.float32)
    ids = torch.zeros((n,), dtype=torch.int32)
    return (rows, torch.empty_like(rows), pay, torch.empty_like(pay), ids,
            torch.empty_like(ids))


def _fake(monkeypatch, lib):
    from lightgbm_tpu_torch.ops import partition as P
    monkeypatch.setattr(P._cuda, "library", lambda name: lib)
    monkeypatch.setattr(P._cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(P, "_cooperative", {})
    monkeypatch.setattr(P, "_scratch", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(P.partition_window, "launches", 0)
    monkeypatch.setattr(P.partition_window, "kernels", 0)
    return P


def test_no_cooperative_launch_raises_instead_of_streaming(monkeypatch):
    P = _fake(monkeypatch, _FakeLib(cooperative=0))
    plan = partition_plan(5_000, 28, 1, 8, H100_SMS)
    assert plan.path == "resident"
    with pytest.raises(RuntimeError, match="cooperative"):
        P._launch(*_window(), 0, 5_000, 3, 101, INT_MAX, -1, False, plan)


def test_a_failed_launch_drops_the_status_words(monkeypatch):
    """The streaming path's status words must be zero at the start of a
    call; after a failed call they may not be, so the wrapper forgets
    them and the next call zeroes new ones."""
    lib = _FakeLib(err=1)
    P = _fake(monkeypatch, lib)
    plan = partition_plan(1_000_000, 28, 1, 8, H100_SMS)._replace(tiles=3)
    assert plan.path == "stream"
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        P._launch(*_window(), 0, 5_000, 3, 101, INT_MAX, -1, False, plan)
    assert lib.calls == 1 and not P._scratch
    lib.err = 0
    P._launch(*_window(), 0, 5_000, 3, 101, INT_MAX, -1, False, plan)
    status = P._scratch[torch.device("cpu")]["status"]
    assert status.dtype == torch.int64 and status.numel() >= 3
    assert not status.any()
    # a counted call of the streaming path: two kernels
    assert P.partition_window.launches == 1
    assert P.partition_window.kernels == 2
