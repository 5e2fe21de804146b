"""Stable two-way partition of a row window — kernel K2 and its plain
version.

Counterpart of ``lightgbm_tpu/ops/partition_kernel.py`` (the Pallas
``route_pair`` kernel) and of the per-split partition of the JAX compact
grower (``ops/grow.py`` ``part_apply``).

- :func:`partition_window` — moves the rows of one leaf's window
  ``[begin, begin + cnt)`` from the source buffers of a ping-pong pair
  into the same window of the destination buffers: rows that go left to
  the front, the others to the back, each side in its original order.
  The decision is on one bin column (:func:`go_left`, the JAX grower's
  ``chunk_goleft``): a range rule, which covers numerical splits of
  plain columns and of the members of EFB bundles, or a membership rule,
  a bitset over the column's values, for categorical splits;
  :class:`RangeRules` turns a split record into either. A row is its
  bins, its (grad, hess) payload — an f32 pair (8 bytes) or, in
  quantized training, an int8 pair (2 bytes) — and its row id. Returns
  the window's left count as a one-element int32 tensor on the device
  (no read-back). On a CUDA tensor it launches ``csrc/partition.cu``
  (or raises); on a CPU tensor it runs :func:`partition_plain`.
- :func:`partition_plan` — the kernel's path and launch for a window:
  resident (one cooperative launch, the window held in the blocks'
  shared memory) up to the card's capacity, streaming (a column pass
  and a move pass) above it.
- :func:`route_pair` — the JAX kernel's ``(L, R)`` contract over a
  stacked ``[NC, K]`` int32 matrix, through the same kernel.

``partition_window.launches`` counts the calls that launched the kernel,
``partition_window.kernels`` the kernels they launched (one on the
resident path, two on the streaming path),
``partition_window.member_launches`` the calls with a membership rule.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .histogram import SMEM_BLOCK, SMEM_RESERVED, SMEM_SM, THREADS_SM, \
    _Force, _num_sms

__all__ = ["partition_window", "partition_plain", "partition_plan",
           "resident_capacity", "smem_bytes", "PartitionPlan",
           "route_pair", "go_left", "RangeRules", "INT_MAX"]

# the plan's constants (csrc/partition.cu; chosen by timing plans on an
# H100, PERF.md): threads per block, SMALL_THREADS for resident slices of
# fewer than SMALL_ROWS rows; rows per resident block at least, so that a
# small window takes few blocks; the streaming path's rows per tile at
# most and its ring depth
THREADS = 512
SMALL_THREADS = 256
SMALL_ROWS = 512
MIN_BLOCK_ROWS = 128
TILE_ROWS = 2048
STAGES = 2
MAX_ROWS = 65535          # rows per block or tile (u16 ranks)
ID_BYTES = 4              # a row id; always budgeted in shared memory
REGS_SM = 65536           # 32-bit registers of one SM
REGS_THREAD = 64          # what __launch_bounds__(512, 2) lets a thread use


class PartitionPlan(NamedTuple):
    path: str        # "resident" (one launch) or "stream" (two)
    nblocks: int     # resident: blocks, a slice each; stream: move blocks
    rows: int        # rows per slice (resident) or per tile (stream)
    stages: int      # tile buffers in the move pass's ring (resident 1)
    tiles: int       # stream: tiles, a column-pass block each
    threads: int
    per_sm: int      # blocks one SM holds at once at this shared memory
    smem: int        # dynamic shared memory per block, bytes


INT_MAX = 2 ** 31 - 1


def go_left(col: torch.Tensor, lo, hi, nan_pos, dl, bits=None):
    """The split decision on one bin column.

    Range rule (``bits`` None): a bin equal to ``nan_pos`` follows the
    default direction ``dl``; any other goes right iff ``lo <= bin <=
    hi``. The arguments are ints, or tensors that broadcast against
    ``col`` (one rule per row).

    Membership rule (a categorical split): ``bits`` is a uint8 bitset
    over the column's values (bit ``v & 7`` of byte ``v >> 3``); a bin
    goes left iff its bit is set, and a bin past the bitset goes
    right."""
    c = col.to(torch.int64)
    if bits is not None:
        nbits = bits.numel() * 8
        byte = bits[torch.clamp(c >> 3, 0, bits.numel() - 1)].to(torch.int64)
        return (c < nbits) & (((byte >> (c & 7)) & 1) != 0)
    right = (c >= lo) & (c <= hi)
    dl = torch.as_tensor(dl, dtype=torch.bool, device=c.device)
    return torch.where(c == nan_pos, dl, ~right)


def _pack_bits(member: torch.Tensor) -> torch.Tensor:
    """``[..., n]`` bool (``n`` a multiple of 8) to ``[..., n // 8]``
    uint8 bitsets: bit ``v & 7`` of byte ``v >> 3`` is ``member[v]``."""
    m = member.reshape(member.shape[:-1] + (-1, 8)).to(torch.int32)
    shift = torch.arange(8, dtype=torch.int32, device=member.device)
    return (m << shift).sum(dim=-1).to(torch.uint8)


class RangeRules:
    """Turns a split record into the decision of the bin column it
    routes on, for K2, the out-of-bag walk and binned scoring.

    A numerical split of (original feature ``f``, threshold bin ``t``)
    gives the range rule ``(col, lo, hi, nan_pos)`` (``dl`` passes
    through): for a plain matrix, or a direct (singleton) bundle, ``(f's
    column, t + 1, INT_MAX, f's missing bin or -1)``, so the rule is the
    plain one (the missing bin follows ``dl``, any other goes left when
    ``bin <= t``); for a member of a multi-member bundle at offset
    ``off`` with ``nb`` bins, ``(its bundle, off + t, off + nb - 2, off +
    nb - 2 or -1)``: its bins above ``t`` sit at positions ``[off + t,
    off + nb - 2]``, its NaN bin (its last) at ``off + nb - 2``. The JAX
    grower's ``chunk_goleft`` decision. Scalars give ints, arrays give
    int64 arrays.

    A categorical split's ``[B]`` mask of the member's local bins sent
    left gives a bitset over the column's values (:meth:`bitsets`), with
    the bundle layout folded in: a direct column stores the local bin as
    is; a multi-member column holds local bins ``1 .. nb - 1`` at
    ``[off, off + nb - 2]``, and every other value is the member's bin
    0. So the kernels test one bit and never learn the layout."""

    def __init__(self, feat_num_bins, feat_nan_bin, bundle=None):
        self.nb = np.asarray(feat_num_bins, np.int64)
        self.nan = np.asarray(feat_nan_bin, np.int64)
        F = self.nb.shape[0]
        if bundle is None:
            self.col = np.arange(F, dtype=np.int64)
            self.off = np.zeros(F, np.int64)
            self.direct = np.ones(F, bool)
        else:
            self.col = np.asarray(bundle.bundle_of, np.int64)
            self.off = np.asarray(bundle.offset_of, np.int64)
            self.direct = np.asarray(bundle.is_direct, bool)

    def __call__(self, f, t):
        f = np.asarray(f, np.int64)
        t = np.asarray(t, np.int64)
        nb, nan, off = self.nb[f], self.nan[f], self.off[f]
        direct = self.direct[f]
        lo = np.where(direct, t + 1, off + t)
        hi = np.where(direct, INT_MAX, off + nb - 2)
        nan_pos = np.where(direct, nan, np.where(nan >= 0, off + nan - 1,
                                                 -1))
        out = (self.col[f], lo, hi, nan_pos)
        if f.ndim == 0:
            return tuple(int(x) for x in out)
        return tuple(np.asarray(x, np.int64) for x in out)

    def bitsets(self, f, masks: torch.Tensor, nvalues: int) -> torch.Tensor:
        """``[N, ceil(nvalues / 8)]`` uint8 bitsets over the column values
        ``0 .. nvalues - 1`` (the bins, or bundle positions, of the matrix
        routed) of the splits on original features ``f`` ``[N]`` whose
        local bins ``b`` go left where ``masks[:, b]`` (``[N, W]`` bool;
        a bin past ``W`` goes right), built on the masks' device."""
        dev = masks.device
        N, W = masks.shape
        f = np.asarray(f, np.int64).reshape(N)
        nbits = -(-nvalues // 8) * 8

        def col(a):
            return torch.as_tensor(a[f], device=dev)[:, None]
        off, nb, direct = col(self.off), col(self.nb), col(self.direct)
        pos = torch.arange(nbits, device=dev)[None, :]
        local = torch.where(direct, pos,
                            torch.where((pos >= off) & (pos <= off + nb - 2),
                                        pos - off + 1, 0))
        member = masks.gather(1, torch.clamp_max(local, W - 1)) \
            & (local < W) & (pos < nvalues)
        return _pack_bits(member)


def partition_plain(bins_src, bins_dst, pay_src, pay_dst, ids_src,
                    ids_dst, begin: int, cnt: int, col: int, lo: int,
                    hi: int, nan_pos: int, dl: bool,
                    bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A stable argsort of ``~go_left`` followed by gathers."""
    sl = slice(begin, begin + cnt)
    rows = bins_src[sl]
    gl = go_left(rows[:, col], lo, hi, nan_pos, dl, bits)
    order = torch.argsort((~gl).to(torch.int8), stable=True)
    # gathers of uint16 are not implemented on CUDA: move the same bits
    # as int16
    if rows.dtype == torch.uint16:
        bins_dst[sl] = rows.view(torch.int16)[order].view(torch.uint16)
    else:
        bins_dst[sl] = rows[order]
    if pay_src is not None:
        pay_dst[sl] = pay_src[sl][order]
    if ids_src is not None:
        ids_dst[sl] = ids_src[sl][order]
    return gl.sum().to(torch.int32).reshape(1)


def _up(x: int) -> int:
    return -(-x // 128) * 128


def smem_bytes(rows: int, F: int, bin_bytes: int, pay_bytes: int,
               stages: int) -> int:
    """Dynamic shared memory of one block; mirrors ``layout()`` in
    ``csrc/partition.cu``: ``stages`` buffers of (bins, payload, ids)
    slots with 16 bytes of slack each, the u16 rank table, the scan's
    ints and the barriers."""
    stage = _up(rows * F * bin_bytes + 16) \
        + (_up(rows * pay_bytes + 16) if pay_bytes else 0) \
        + _up(rows * ID_BYTES + 16)
    return stages * stage + _up(rows * 2) + 256 + 128


@functools.lru_cache(maxsize=256)
def _max_rows(F, bin_bytes, pay_bytes, stages, limit):
    """The most rows (up to MAX_ROWS) whose ``stages`` buffers fit one
    block's shared memory; 0 if not even one row does."""
    per_row = stages * (F * bin_bytes + pay_bytes + ID_BYTES) + 2
    r = min(MAX_ROWS, max(0, limit // per_row))
    while r > 0 and smem_bytes(r, F, bin_bytes, pay_bytes, stages) > limit:
        r -= 1
    return r


def _per_sm(threads, smem):
    """Blocks one SM holds at once: by threads, registers at the
    kernels' launch bound, and shared memory."""
    return min(THREADS_SM // threads, REGS_SM // (threads * REGS_THREAD),
               SMEM_SM // (smem + SMEM_RESERVED))


def resident_capacity(F: int, bin_bytes: int, pay_bytes: int,
                      num_sms: int, smem_limit: int = SMEM_BLOCK) -> int:
    """The most rows the resident path takes: one block per SM, each
    holding as many rows as fit its shared memory."""
    return num_sms * _max_rows(F, bin_bytes, pay_bytes, 1, smem_limit)


def partition_plan(cnt: int, F: int, bin_bytes: int, pay_bytes: int,
                   num_sms: int,
                   smem_limit: int = SMEM_BLOCK) -> PartitionPlan:
    """K2's path and launch for a window of ``cnt >= 1`` rows of ``F``
    bins of ``bin_bytes`` bytes and ``pay_bytes`` of payload (8, 2 or 0;
    a row id is always budgeted).

    Up to :func:`resident_capacity` rows, the resident path: at most one
    block per SM, each holding a slice of at least ``MIN_BLOCK_ROWS`` rows
    where the row width allows it (small windows take fewer blocks, down
    to one), of ``THREADS`` threads (``SMALL_THREADS`` for a slice of
    fewer than ``SMALL_ROWS`` rows). Above it, the streaming path: tiles
    of up to ``TILE_ROWS`` rows (fewer where ``STAGES`` of them do not
    fit), one column-pass block per tile, and as many move-pass blocks
    as the card holds at once, each taking an equal run of tiles. Raises ``ValueError`` for a
    row that does not fit twice in one block's shared memory."""
    if cnt < 1 or cnt > 2 ** 31 - 1:
        raise ValueError(f"K2 takes windows of 1 to 2^31 - 1 rows, not {cnt}")
    if _max_rows(F, bin_bytes, pay_bytes, STAGES, smem_limit) < 1:
        raise ValueError(f"rows of {F} x {bin_bytes}-byte bins are too wide "
                         "for K2's shared-memory staging")
    rmax = _max_rows(F, bin_bytes, pay_bytes, 1, smem_limit)
    if cnt <= resident_capacity(F, bin_bytes, pay_bytes, num_sms,
                                smem_limit):
        nb = min(num_sms, max(-(-cnt // MIN_BLOCK_ROWS), -(-cnt // rmax)))
        rows = -(-cnt // nb)
        nb = -(-cnt // rows)
        smem = smem_bytes(rows, F, bin_bytes, pay_bytes, 1)
        threads = SMALL_THREADS if rows < SMALL_ROWS else THREADS
        return PartitionPlan("resident", nb, rows, 1, nb, threads,
                             _per_sm(threads, smem), smem)
    rows = min(TILE_ROWS, _max_rows(F, bin_bytes, pay_bytes, STAGES,
                                    smem_limit))
    smem = smem_bytes(rows, F, bin_bytes, pay_bytes, STAGES)
    tiles = -(-cnt // rows)
    per_sm = _per_sm(THREADS, smem)
    return PartitionPlan("stream", min(tiles, per_sm * num_sms), rows,
                         STAGES, tiles, THREADS, per_sm, smem)


def _check(bins_src, bins_dst, pay_src, pay_dst, ids_src, ids_dst):
    for b in (bins_src, bins_dst):
        if b.dim() != 2 or not b.is_contiguous() \
                or b.dtype not in (torch.uint8, torch.uint16):
            raise ValueError("bins buffers must be contiguous [n, F] "
                             "uint8/uint16 tensors")
    if bins_src.shape != bins_dst.shape or bins_src.dtype != bins_dst.dtype:
        raise ValueError("bins buffers differ in shape or dtype")
    n = bins_src.shape[0]
    for a, b, shape, dts in ((pay_src, pay_dst, (n, 2),
                              (torch.float32, torch.int8)),
                             (ids_src, ids_dst, (n,), (torch.int32,))):
        if (a is None) != (b is None):
            raise ValueError("a source buffer needs its destination")
        if a is None:
            continue
        for x in (a, b):
            if x.shape != shape or x.dtype not in dts \
                    or x.dtype != a.dtype or not x.is_contiguous():
                raise ValueError(f"expected contiguous {shape} tensors of "
                                 f"one of {dts}")
    devs = {x.device for x in (bins_src, bins_dst, pay_src, pay_dst,
                               ids_src, ids_dst) if x is not None}
    if len(devs) != 1:
        raise ValueError("partition buffers are on different devices")


def partition_window(bins_src: torch.Tensor, bins_dst: torch.Tensor,
                     pay_src: Optional[torch.Tensor],
                     pay_dst: Optional[torch.Tensor],
                     ids_src: Optional[torch.Tensor],
                     ids_dst: Optional[torch.Tensor],
                     begin: int, cnt: int, col: int, lo: int, hi: int,
                     nan_pos: int, dl: bool,
                     bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stably partition window ``[begin, begin + cnt)`` of the source
    buffers into the destination buffers by the decision on bin column
    ``col`` (:func:`go_left`): the range rule ``(lo, hi, nan_pos, dl)``,
    or with ``bits`` (a contiguous uint8 bitset on the buffers' device,
    :meth:`RangeRules.bitsets`) the membership rule, which ignores the
    range rule's arguments. Returns ``n_left`` (int32 ``[1]`` on the
    device). ``pay_*`` (``[n, 2]`` f32 or int8) and ``ids_*`` may be
    None."""
    _check(bins_src, bins_dst, pay_src, pay_dst, ids_src, ids_dst)
    if bits is not None and (bits.dtype != torch.uint8 or bits.dim() != 1
                             or not bits.is_contiguous()
                             or bits.device != bins_src.device
                             or bits.numel() * 8 > INT_MAX):
        raise ValueError("the membership rule's bitset must be a "
                         "contiguous 1-D uint8 tensor on the buffers' "
                         "device")
    n, F = bins_src.shape
    if not 0 <= begin <= begin + cnt <= n or not 0 <= col < F:
        raise ValueError("window or column out of range")
    if not all(-2 ** 31 <= v <= INT_MAX for v in (lo, hi, nan_pos)):
        raise ValueError("the range rule's bounds must fit an int32")
    dev = bins_src.device
    if dev.type == "cpu" or (_Force.plain and dev.type == "cuda"):
        return partition_plain(bins_src, bins_dst, pay_src, pay_dst,
                               ids_src, ids_dst, begin, cnt, col, lo, hi,
                               nan_pos, dl, bits)
    if dev.type != "cuda":
        raise ValueError(f"no partition kernel for device {dev}")
    if cnt == 0:
        return torch.zeros((1,), dtype=torch.int32, device=dev)
    pay_bytes = 0 if pay_src is None else 2 * pay_src.element_size()
    plan = partition_plan(cnt, F, bins_src.element_size(), pay_bytes,
                          _num_sms(dev))
    return _launch(bins_src, bins_dst, pay_src, pay_dst, ids_src, ids_dst,
                   begin, cnt, col, lo, hi, nan_pos, dl, plan, bits)


# per CUDA device: the resident path's block counts and the streaming
# path's tile status words (zeroed once here, left zeroed by every call)
_scratch: Dict[torch.device, Dict[str, torch.Tensor]] = {}
_cooperative: Dict[int, bool] = {}


def _scratch_for(dev: torch.device, name: str, n: int, dtype):
    bufs = _scratch.setdefault(dev, {})
    buf = bufs.get(name)
    if buf is None or buf.numel() < n:
        buf = bufs[name] = torch.zeros((n,), dtype=dtype, device=dev)
    return buf


def _launch(bins_src, bins_dst, pay_src, pay_dst, ids_src, ids_dst, begin,
            cnt, col, lo, hi, nan_pos, dl, plan: PartitionPlan,
            bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/partition.cu`` on a checked window of CUDA tensors
    by ``plan``."""
    dev = bins_src.device
    lib = _cuda.library("partition")
    counts = status = None
    if plan.path == "resident":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        if idx not in _cooperative:
            _cooperative[idx] = bool(lib.partition_cooperative(idx))
        if not _cooperative[idx]:
            raise RuntimeError(f"{dev} does not support cooperative "
                               "launches, which K2's resident path needs")
        counts = _scratch_for(dev, "counts", plan.nblocks, torch.int32)
    else:
        status = _scratch_for(dev, "status", plan.tiles, torch.int64)
    n_left = torch.empty((1,), dtype=torch.int32, device=dev)
    F = bins_src.shape[1]

    def at(x, row_elems):
        if x is None:
            return None
        return x.data_ptr() + begin * row_elems * x.element_size()

    pay_bytes = 0 if pay_src is None else 2 * pay_src.element_size()
    err = lib.partition_window(
        at(bins_src, F), at(bins_dst, F), bins_src.element_size(),
        at(pay_src, 2), at(pay_dst, 2), pay_bytes, at(ids_src, 1),
        at(ids_dst, 1), int(cnt), F, int(col), int(lo), int(hi),
        int(nan_pos), int(bool(dl)),
        None if bits is None else bits.data_ptr(),
        0 if bits is None else bits.numel() * 8,
        0 if plan.path == "resident" else 1,
        plan.nblocks,
        plan.rows, plan.stages, plan.tiles, plan.threads, plan.smem,
        None if counts is None else counts.data_ptr(),
        None if status is None else status.data_ptr(), n_left.data_ptr(),
        _cuda.stream_ptr(dev))
    if err != 0:
        # a failed call may leave status words set: zero them anew
        _scratch.pop(dev, None)
    _cuda.check(err, "partition_window")
    partition_window.launches += 1
    partition_window.kernels += 1 if plan.path == "resident" else 2
    if bits is not None:
        partition_window.member_launches += 1
    return n_left


partition_window.launches = 0
partition_window.kernels = 0
partition_window.member_launches = 0


def _compact(A: torch.Tensor, key: torch.Tensor) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Rows (columns of ``A``) with ``key == 0`` to the front, the rest
    to the back, both stable — one partition_window over the byte rows
    of ``A.T`` with the key as an extra bin column."""
    nc, k = A.shape
    cols = A.t().contiguous().reshape(-1).view(torch.uint8)
    rows = torch.cat([cols.reshape(k, 4 * nc),
                      key.to(torch.uint8)[:, None]], dim=1).contiguous()
    dst = torch.empty_like(rows)
    nl = partition_window(rows, dst, None, None, None, None, 0, k,
                          rows.shape[1] - 1, 1, INT_MAX, -1, False)
    out = dst[:, :4 * nc].contiguous().view(torch.int32).t().contiguous()
    return out, nl


def route_pair(A: torch.Tensor, mark_left: torch.Tensor,
               mark_right: torch.Tensor):
    """The ``(L, R)`` contract of the JAX ``route_pair``: ``A`` is a
    ``[NC, K]`` int32 matrix of stacked row columns; the left-marked
    columns are compacted stably to ``[0, n_left)`` of ``L``, the
    right-marked ones to ``[K - n_right, K)`` of ``R``. Other positions
    are don't-cares (here: the remaining columns in order)."""
    if A.dtype != torch.int32 or A.dim() != 2:
        raise ValueError("A must be an [NC, K] int32 matrix")
    L, _ = _compact(A, ~mark_left.to(torch.bool))
    R, _ = _compact(A, mark_right.to(torch.bool))
    return L, R
