"""Gradient/hessian histograms — kernel K1 and its plain version.

Counterpart of ``lightgbm_tpu/ops/histogram.py`` (``hist_from_rows``,
``build_histogram``, ``subtract_histogram``) and of the Pallas kernel in
``lightgbm_tpu/ops/pallas_hist.py``. The histogram holds (sum_grad,
sum_hess) per (feature, bin) only; counts are estimated downstream from
the hessian ratio, as in the JAX package.

- :func:`window_hist` — the histogram of one row window of a row-major
  ``[n, F]`` bin buffer and its ``[n, 2]`` payload: an f32 payload gives
  an f32 histogram, an int8 payload (quantized-gradient training) an
  exact int32 one (the JAX ``int_exact`` path). On a CUDA tensor it
  launches ``csrc/hist.cu`` (or raises); on a CPU tensor it runs
  :func:`hist_plain`. The window is ``[start, start + cnt)``, or the
  left (``side=1``) or right (``side=2``) child of such a window once it
  was partitioned, with the left count read from the device tensor
  ``n_left`` — so the grower needs no read-back in between. The kernel
  sums the float path in fixed point scaled by the payload's max
  magnitude (``pay_absmax``, see ``csrc/hist.cu``), so its result is the
  same from run to run.
- :func:`launch_plan` — the kernel's launch by window size.
- :func:`hist_from_rows` / :func:`hist_from_rows_int` — the same for a
  whole ``[S, F]`` block.
- :func:`hist_plain` — a flat ``index_add_`` over ``f * B + bin`` (in
  float32, or exactly in int32 for an int8 payload), the counterpart of
  the JAX ``_hist_scatter``.

``window_hist.launches`` and ``window_hist.int_launches`` count the
kernel's launches on the float and the int path (one per call on a CUDA
tensor). ``window_hist`` is the cost-attribution entry ``ops/pallas_hist``
(``obs/cost.py``): its signature is the launch plan without the row
count, its cost K1's model of the window (``cost.k1_work``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..obs.jit_tracker import register_jit
from . import _cuda

__all__ = ["window_hist", "hist_from_rows", "hist_from_rows_int",
           "build_histogram", "hist_plain", "subtract_histogram",
           "Plan", "launch_plan", "smem_bytes", "plain_kernels"]

SMEM_BLOCK = 232_448      # dynamic shared memory one block may use (H100)
SMEM_SM = 233_472         # shared memory of one SM
SMEM_RESERVED = 1024      # what the card reserves per resident block
THREADS_SM = 2048
MAX_STAGES = 4
# the launch plan's constants, chosen by timing plans on the window ladder
# of an H100 (PERF.md): threads per block, tile buffers in the ring, and
# rows per tile, from TILE_ROWS halved down to MIN_TILE_ROWS for windows
# of fewer than num_sms / 2 tiles
THREADS = 1024
STAGES = 2
TILE_ROWS = 1024
MIN_TILE_ROWS = 128


class Plan(NamedTuple):
    fg: int          # features per block (blockIdx.y takes a group)
    tile_rows: int   # rows per staged tile
    stages: int      # tile buffers in the ring
    nblocks: int     # blocks along the rows
    threads: int
    smem: int        # dynamic shared memory per block, bytes


class _Force:
    plain = False


@contextlib.contextmanager
def plain_kernels():
    """Run both kernels' plain versions even on CUDA tensors, for the
    lifetime of the ``with`` block. Only ``chip_smoke.py`` uses it, to
    train the comparison model; nothing on the main path does."""
    old = _Force.plain
    _Force.plain = True
    try:
        yield
    finally:
        _Force.plain = old


def _acc_dtype(payload: torch.Tensor) -> torch.dtype:
    return torch.int32 if payload.dtype == torch.int8 else torch.float32


def hist_plain(rows: torch.Tensor, payload: torch.Tensor,
               num_bins: int) -> torch.Tensor:
    """``[S, F]`` bins, ``[S, 2]`` payload -> ``[F, B, 2]``: f32 for an
    f32 payload, exact int32 for an int8 one."""
    S, F = rows.shape
    C = payload.shape[1]
    acc = _acc_dtype(payload)
    out = torch.zeros((F * num_bins, C), dtype=acc, device=rows.device)
    if S == 0:
        return out.reshape(F, num_bins, C)
    b = rows.to(torch.int64)
    keep = b < num_bins           # out-of-range bins are dropped
    idx = (torch.arange(F, device=rows.device) * num_bins)[None, :] + b
    pay = payload.to(acc)[:, None, :].expand(S, F, C)
    out.index_add_(0, idx[keep], pay[keep])
    return out.reshape(F, num_bins, C)


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def smem_bytes(F: int, fg: int, B: int, bin_bytes: int, int_path: bool,
               tile_rows: int, stages: int) -> int:
    """Dynamic shared memory of one block; mirrors ``layout()`` in
    ``csrc/hist.cu``: the ``[fg, B, 2]`` table (4-byte entries on the int
    path, 8-byte on the float path), the ring of (bins, payload) tile
    buffers, the float path's fixed-point tile payload, the barriers."""
    table = _up(fg * B * 2 * (4 if int_path else 8), 128)
    bins_slot = _up(tile_rows * F * bin_bytes + 16, 128)
    pay_slot = _up(tile_rows * (2 if int_path else 8) + 16, 128)
    cpay = 0 if int_path else _up(tile_rows * 16, 128)
    return table + stages * (bins_slot + pay_slot) + cpay + 128


def launch_plan(cnt: int, F: int, B: int, bin_bytes: int, num_sms: int,
                int_path: bool = False) -> Plan:
    """K1's launch for a window of at most ``cnt`` rows: ``THREADS``
    threads, a ring of ``STAGES`` tiles of ``TILE_ROWS`` rows unless the
    window has fewer than ``num_sms / 2`` of them, then halved down to
    ``MIN_TILE_ROWS`` so that small windows still spread over many
    blocks. The features per block are as many as fit beside the ring;
    the blocks are one per tile up to as many as the card holds at once,
    and each takes an equal share of the window's tiles."""
    st, th, tr = STAGES, THREADS, TILE_ROWS
    while tr > MIN_TILE_ROWS and -(-cnt // tr) < num_sms // 2:
        tr //= 2

    def fits(fg, t):
        return smem_bytes(F, fg, B, bin_bytes, int_path, t, st) <= SMEM_BLOCK

    while not fits(1, tr) and tr > 32:
        tr //= 2
    if not fits(1, tr):
        raise ValueError(
            f"num_bins={B} is too wide for K1's shared-memory histogram")
    fg = F
    while not fits(fg, tr):
        fg -= 1
    groups = -(-F // fg)
    fg = -(-F // groups)          # even groups
    smem = smem_bytes(F, fg, B, bin_bytes, int_path, tr, st)
    per_sm = max(1, min(THREADS_SM // th,
                        SMEM_SM // (smem + SMEM_RESERVED)))
    tiles = max(1, -(-cnt // tr))
    nblocks = max(1, min(tiles, per_sm * num_sms))
    return Plan(fg, tr, st, nblocks, th, smem)


def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_args(bins, payload, n_left, side):
    if bins.dim() != 2 or not bins.is_contiguous():
        raise ValueError("bins must be a contiguous [n, F] tensor")
    if bins.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"bins must be uint8 or uint16, got {bins.dtype}")
    if payload.dtype not in (torch.float32, torch.int8) \
            or payload.dim() != 2 \
            or payload.shape != (bins.shape[0], 2) \
            or not payload.is_contiguous():
        raise ValueError("payload must be a contiguous [n, 2] float32 or "
                         "int8 tensor with the rows of bins")
    if payload.device != bins.device:
        raise ValueError("bins and payload are on different devices")
    if side not in (0, 1, 2):
        raise ValueError(f"side must be 0, 1 or 2, got {side}")
    if side and (n_left is None or n_left.dtype != torch.int32
                 or n_left.numel() != 1 or n_left.device != bins.device):
        raise ValueError("side 1/2 needs n_left: a one-element int32 "
                         "tensor on the bins' device")


def window_hist(bins: torch.Tensor, payload: torch.Tensor, num_bins: int,
                start: int, cnt: int, n_left: torch.Tensor = None,
                side: int = 0,
                pay_absmax: torch.Tensor = None) -> torch.Tensor:
    """Histogram ``[F, B, 2]`` of a window of ``bins``/``payload``: f32
    for an f32 payload, exact int32 for an int8 one.

    ``side`` 0: rows ``[start, start + cnt)``; 1: rows
    ``[start, start + n_left)``; 2: rows ``[start + n_left, start +
    cnt)``, with ``n_left`` a one-element int32 tensor on the device.
    ``pay_absmax`` (float path, kernel only): a ``[2]`` f32 device tensor
    at least the window's max ``|payload[:, c]|`` per channel, such as
    the grower's one amax over the tree's payload; by default the wrapper
    takes it over rows ``[start, start + cnt)``."""
    _check_args(bins, payload, n_left, side)
    F = bins.shape[1]
    if not 0 <= start <= start + cnt <= bins.shape[0]:
        raise ValueError("window out of range")
    if bins.device.type == "cpu" or (_Force.plain
                                     and bins.device.type == "cuda"):
        if side:
            nl = int(n_left.item())
            start, cnt = (start, nl) if side == 1 else (start + nl,
                                                        cnt - nl)
        return hist_plain(bins[start:start + cnt],
                          payload[start:start + cnt], num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {bins.device}")
    int_path = payload.dtype == torch.int8
    acc = _acc_dtype(payload)
    out = torch.empty((F, num_bins, 2), dtype=acc, device=bins.device)
    if cnt == 0:
        return out.zero_()
    bb = bins.element_size()
    plan = launch_plan(cnt, F, num_bins, bb, _num_sms(bins.device),
                       int_path)
    lib = _cuda.library("hist")
    scratch = None
    if not int_path:
        if pay_absmax is None:
            pay_absmax = payload[start:start + cnt].abs().amax(dim=0)
        if pay_absmax.dtype != torch.float32 or pay_absmax.numel() != 2 \
                or pay_absmax.device != bins.device:
            raise ValueError("pay_absmax must be a [2] float32 tensor on "
                             "the bins' device")
        pay_absmax = pay_absmax.contiguous()
        # the window's int64 sums
        scratch = torch.empty((F * num_bins * 2,), dtype=torch.int64,
                              device=bins.device)
    err = lib.hist_build(
        bins.data_ptr(), bb, payload.data_ptr(), int(int_path),
        int(start), int(cnt),
        n_left.data_ptr() if side else None, side, F, num_bins, plan.fg,
        plan.tile_rows, plan.stages, plan.nblocks, plan.threads,
        None if int_path else pay_absmax.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        _cuda.stream_ptr(bins.device))
    _cuda.check(err, "hist_build")
    if int_path:
        window_hist.int_launches += 1
    else:
        window_hist.launches += 1
    return out


# kernel launches on CUDA tensors: float path / int path
window_hist.launches = 0
window_hist.int_launches = 0

_HIST_ARGS = ("bins", "payload", "num_bins", "start", "cnt", "n_left",
              "side", "pay_absmax")
_sms = {}


def _hist_call(args, kwargs) -> dict:
    a = dict(zip(_HIST_ARGS, args))
    a.update(kwargs)
    return a


def _hist_signature(args, kwargs) -> tuple:
    """A K1 call's cost signature: the launch plan without its block
    count (the one field that grows with the window's rows); on the CPU,
    the shapes and dtypes the plain version runs on."""
    a = _hist_call(args, kwargs)
    bins, payload = a["bins"], a["payload"]
    F, B = bins.shape[1], a["num_bins"]
    head = (bins.device.type, F, B, str(bins.dtype), str(payload.dtype))
    if bins.device.type != "cuda" or _Force.plain or a["cnt"] == 0:
        return head
    idx = bins.device.index
    if idx not in _sms:
        _sms[idx] = _num_sms(bins.device)
    plan = launch_plan(a["cnt"], F, B, bins.element_size(), _sms[idx],
                       payload.dtype == torch.int8)
    return head + tuple(plan._replace(nblocks=0))


def _hist_work(args, kwargs, out) -> tuple:
    """K1's work item for ``obs/cost.py``: the window and its left
    count, whose rows the model costs."""
    a = _hist_call(args, kwargs)
    bins, payload = a["bins"], a["payload"]
    side = a.get("side", 0)
    return ("k1", bins.shape[1], bins.element_size(),
            2 * payload.element_size(), a["num_bins"],
            payload.dtype == torch.int8, a["start"], a["cnt"], side,
            a.get("n_left") if side else None)


window_hist = register_jit("ops/pallas_hist", window_hist,
                           max_signatures=16, signature=_hist_signature,
                           work=_hist_work)


def hist_from_rows(rows: torch.Tensor, payload: torch.Tensor,
                   num_bins: int) -> torch.Tensor:
    """Histogram of a whole ``[S, F]`` row block (``hist_from_rows`` /
    ``hist_from_rows_pallas`` of the JAX package, float path)."""
    return window_hist(rows, payload, num_bins, 0, rows.shape[0])


def hist_from_rows_int(rows: torch.Tensor, payload: torch.Tensor,
                       num_bins: int) -> torch.Tensor:
    """Quantized histogram of a whole ``[S, F]`` row block: int8
    ``[S, 2]`` payload, exact int32 ``[F, B, 2]`` result
    (``hist_from_rows_int`` of the JAX package)."""
    if payload.dtype != torch.int8:
        raise TypeError(f"hist_from_rows_int takes an int8 payload, got "
                        f"{payload.dtype}")
    return window_hist(rows, payload, num_bins, 0, rows.shape[0])


def build_histogram(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, row_weight: torch.Tensor,
                    mask: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Histogram of the rows selected by ``mask`` (``[n]`` bool) with
    per-row weights, over a row-major ``[n, F]`` bin matrix."""
    m = mask.to(grad.dtype) * row_weight.to(grad.dtype)
    payload = torch.stack([grad * m, hess * m], dim=-1).contiguous()
    return hist_from_rows(bins, payload, num_bins)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """The histogram-subtraction trick: sibling = parent - child (exact
    on int32 histograms)."""
    return parent - child
