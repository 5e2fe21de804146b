"""Stable two-way partition of a row window — kernel K2 and its plain
version.

Counterpart of ``lightgbm_tpu/ops/partition_kernel.py`` (the Pallas
``route_pair`` kernel) and of the per-split partition of the JAX compact
grower (``ops/grow.py`` ``part_apply``).

- :func:`partition_window` — moves the rows of one leaf's window
  ``[begin, begin + cnt)`` from the source buffers of a ping-pong pair
  into the same window of the destination buffers: rows that go left
  (the numerical split rule of ``chunk_goleft``) to the front, the
  others to the back, each side in its original order. A row is its
  bins, its (grad, hess) payload — an f32 pair (8 bytes) or, in
  quantized training, an int8 pair (2 bytes) — and its row id. Returns
  the window's left count as a one-element int32 tensor on the device
  (no read-back). On a CUDA tensor it launches ``csrc/partition.cu``
  (or raises); on a CPU tensor it runs :func:`partition_plain`.
- :func:`route_pair` — the JAX kernel's ``(L, R)`` contract over a
  stacked ``[NC, K]`` int32 matrix, through the same kernel.

``partition_window.launches`` counts the kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .histogram import _Force

__all__ = ["partition_window", "partition_plain", "route_pair",
           "go_left"]


def go_left(col: torch.Tensor, t: int, dl: bool, nan_bin: int):
    """The split rule for one bin column: the missing bin follows the
    default direction, every other bin goes left when ``bin <= t``."""
    c = col.to(torch.int64)
    gl = c <= t
    if nan_bin >= 0:
        gl = torch.where(c == nan_bin, torch.full_like(gl, bool(dl)), gl)
    return gl


def partition_plain(bins_src, bins_dst, pay_src, pay_dst, ids_src,
                    ids_dst, begin: int, cnt: int, f: int, t: int,
                    dl: bool, nan_bin: int) -> torch.Tensor:
    """A stable argsort of ``~go_left`` followed by gathers."""
    sl = slice(begin, begin + cnt)
    rows = bins_src[sl]
    gl = go_left(rows[:, f], t, dl, nan_bin)
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
                     begin: int, cnt: int, f: int, t: int, dl: bool,
                     nan_bin: int) -> torch.Tensor:
    """Stably partition window ``[begin, begin + cnt)`` of the source
    buffers into the destination buffers; returns ``n_left`` (int32
    ``[1]`` on the device). ``pay_*`` (``[n, 2]`` f32 or int8) and
    ``ids_*`` may be None."""
    _check(bins_src, bins_dst, pay_src, pay_dst, ids_src, ids_dst)
    n, F = bins_src.shape
    if not 0 <= begin <= begin + cnt <= n or not 0 <= f < F:
        raise ValueError("window or feature out of range")
    dev = bins_src.device
    if dev.type == "cpu" or (_Force.plain and dev.type == "cuda"):
        return partition_plain(bins_src, bins_dst, pay_src, pay_dst,
                               ids_src, ids_dst, begin, cnt, f, t, dl,
                               nan_bin)
    if dev.type != "cuda":
        raise ValueError(f"no partition kernel for device {dev}")
    lib = _cuda.library("partition")
    tile = lib.partition_tile_rows()
    nb = max(1, -(-cnt // tile))
    scratch = torch.empty((nb,), dtype=torch.int32, device=dev)
    n_left = torch.empty((1,), dtype=torch.int32, device=dev)
    bb = bins_src.element_size()

    def at(x, row_elems):
        if x is None:
            return None
        return x.data_ptr() + begin * row_elems * x.element_size()

    pay_bytes = 0 if pay_src is None else 2 * pay_src.element_size()
    err = lib.partition_window(
        at(bins_src, F), at(bins_dst, F), bb, at(pay_src, 2),
        at(pay_dst, 2), pay_bytes, at(ids_src, 1), at(ids_dst, 1),
        int(cnt), F, int(f), int(t), int(bool(dl)), int(nan_bin),
        scratch.data_ptr(), nb, n_left.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, "partition_window")
    partition_window.launches += 1
    return n_left


partition_window.launches = 0


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
                          rows.shape[1] - 1, 0, False, -1)
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
