"""Histogram collectives, the payload models and the parallel-mode
chooser (the JAX package's ``parallel/comms.py``), on
``torch.distributed``.

:class:`Comm` is a rank's collectives on its process group. Each call
counts its calls and the bytes this rank sends (every input tensor's
``numel * itemsize``: the counterpart of the JAX module's jaxpr payload
audit, :func:`collective_payloads`), and with ``timing`` on, the wall
seconds between a device synchronize before and after it. On a gloo
world whose tensors live on a CUDA device, ``all_reduce`` runs on the
CUDA tensors; ``all_gather``,
``reduce_scatter`` and ``all_to_all`` are staged through pinned host
memory in explicit code (:data:`GLOO_CUDA_STAGED`).

:func:`hist_allreduce` reduces a histogram under ``mode``:

- ``"f32"`` (and any integer histogram, e.g. the exact int32 ones of
  quantized-gradient training): one ``all_reduce``;
- ``"int16"`` / ``"int8"``: EQuARX-style block quantization. The
  histogram is cut into 256-element blocks, each quantized with one f32
  scale (packed into the integer payload, so the wire really is
  int8/int16). Two strategies:

  - ``exchange``: ``all_to_all`` sends chunk ``i`` of every rank's
    payload to rank ``i``, which dequantizes and sums, requantizes its
    reduced chunk and ``all_gather`` sends it to all;
  - ``psum``: the block maxima are shared with a max ``all_reduce``,
    every rank quantizes with the same scales and one int32
    ``all_reduce`` sums the integers (the voting exchange asks for it);
  - ``auto`` is ``exchange`` on every device. (The JAX package takes
    ``psum`` on the CPU to dodge a collective stall of its CPU runtime
    that gloo does not have, so the port's CPU worlds run the wire the
    card runs.)

  The result every rank consumes is an all-gather or an integer sum, so
  it is bit-identical on every rank, and split decisions stay
  replicated. With an error-feedback buffer ``ef`` the quantization
  consumes ``x + ef`` and the new residual is what the wire did not
  carry (plus, on the exchange path, this rank's requantization error
  of the chunk it owns), so the accumulated error stays one round's.

:func:`hist_reduce_scatter` is the reduction of ``split_search=
"sharded"``: each rank receives only its chunk of the feature axis.

:func:`payload_bytes` / :func:`post_reduction_bytes` model the wire
bytes of one split search per parallel mode; :func:`resolve_hist_comm`
and :func:`choose_parallel_mode` are ``hist_comm="auto"`` and
``tree_learner="auto"``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

__all__ = [
    "BLOCK", "QMAX", "WIRE_ITEMSIZE", "Comm", "GLOO_CUDA_STAGED",
    "hist_allreduce", "hist_reduce_scatter", "make_hist_psum_ef",
    "resolve_hist_comm", "payload_elems", "payload_bytes",
    "splitinfo_elems", "post_reduction_elems", "post_reduction_bytes",
    "choose_parallel_mode", "collective_payloads", "collective_summary",
]

#: quantization block size: one f32 scale per BLOCK elements
BLOCK = 256

QMAX = {"int8": 127, "int16": 32767}
_WIRE_DTYPE = {"int8": torch.int8, "int16": torch.int16}

#: wire bytes per histogram element per hist_comm mode
WIRE_ITEMSIZE = {"f32": 4, "int16": 2, "int8": 1}

#: floor on block scales so an all-zero block quantizes to zeros
_TINY = 1e-30

#: auto hist_comm: quantize once the per-reduction f32 payload crosses
#: this many bytes
AUTO_QUANT_BYTES = 1 << 20

#: auto tree_learner: replicate rows (feature-parallel) only below this
#: many global rows
FEATURE_MAX_ROWS = 1 << 16

#: auto tree_learner: stay data-parallel while one histogram reduction
#: is at most this many bytes
DATA_MAX_BYTES = 1 << 20

#: the collectives a gloo world stages through pinned host memory when
#: its tensors are on a CUDA device
GLOO_CUDA_STAGED = frozenset({"all_gather", "reduce_scatter", "all_to_all"})


class Comm:
    """A rank's collectives on the world of ``mesh`` (a
    :class:`parallel.mesh.Mesh`), with a ledger of calls, bytes sent
    and (``timing=True``) wall seconds per operation."""

    def __init__(self, mesh, timing: bool = False):
        import torch.distributed as dist
        self.dist = dist
        self.mesh = mesh
        self.rank, self.size = mesh.rank, mesh.size
        self.group = mesh.group
        self.backend = mesh.backend
        self.timing = timing
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}
        self.records: List[dict] = []
        self.keep_records = False

    # -- the ledger ------------------------------------------------------
    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.seconds.clear()
        self.records.clear()

    def _staged(self, op: str, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda \
            and op in GLOO_CUDA_STAGED

    def _run(self, op: str, t: torch.Tensor, fn):
        sync = self.timing and t.is_cuda
        if self.timing:
            if sync:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
        out = fn()
        if self.timing:
            if sync:
                torch.cuda.synchronize(t.device)
            self.seconds[op] = self.seconds.get(op, 0.0) \
                + time.perf_counter() - t0
        nb = t.numel() * t.element_size()
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + nb
        if self.keep_records:
            self.records.append({"prim": op, "elems": int(t.numel()),
                                 "itemsize": int(t.element_size()),
                                 "bytes": int(nb)})
        return out

    @staticmethod
    def _as_bytes(t: torch.Tensor) -> torch.Tensor:
        """An int16 payload moves as its bytes: neither gloo nor NCCL
        has an int16 type, and a move needs no arithmetic."""
        return t.view(torch.int8) if t.dtype == torch.int16 else t

    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    # -- the collectives -------------------------------------------------
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place ``sum`` or ``max`` over the world; returns ``t``."""
        rop = self.dist.ReduceOp.SUM if op == "sum" else self.dist.ReduceOp.MAX
        if self.size <= 1:
            return t
        return self._run("all_reduce", t, lambda: (
            self.dist.all_reduce(t, op=rop, group=self.group), t)[1])

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[D, *t.shape]``: every rank's ``t`` in rank order."""
        t = t.contiguous()
        if self.size <= 1:
            return t[None]

        def go():
            b = self._as_bytes(t)
            src = self._host(b) if self._staged("all_gather", b) else b
            # flat, in rank order: the layout every backend takes
            out = torch.empty(self.size * b.numel(), dtype=b.dtype,
                              device=src.device)
            gather = getattr(self.dist, "all_gather_single", None) \
                or self.dist.all_gather_into_tensor
            gather(out, src.reshape(-1), group=self.group)
            return out.to(t.device).view(t.dtype).reshape(
                (self.size,) + tuple(t.shape))
        return self._run("all_gather", t, go)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of dim 0 of the world's sum
        (``t.shape[0]`` a multiple of the world's size)."""
        t = t.contiguous()
        if self.size <= 1:
            return t

        def go():
            src = self._host(t) if self._staged("reduce_scatter", t) else t
            out = torch.empty(t.numel() // self.size, dtype=t.dtype,
                              device=src.device)
            scatter = getattr(self.dist, "reduce_scatter_single", None) \
                or self.dist.reduce_scatter_tensor
            scatter(out, src.reshape(-1), group=self.group)
            return out.to(t.device).reshape(
                (t.shape[0] // self.size,) + tuple(t.shape[1:]))
        return self._run("reduce_scatter", t, go)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Chunk ``i`` of dim 0 goes to rank ``i``; returns the chunks
        received, in rank order."""
        t = t.contiguous()
        if self.size <= 1:
            return t

        def go():
            b = self._as_bytes(t)
            src = self._host(b) if self._staged("all_to_all", b) else b
            out = torch.empty_like(src)
            self.dist.all_to_all_single(out, src, group=self.group)
            return out.to(t.device).view(t.dtype)
        return self._run("all_to_all", t, go)

    def gather_rows(self, t: torch.Tensor, counts: List[int]) -> torch.Tensor:
        """Every rank's rows of ``t`` (dim 0; rank ``r`` holds
        ``counts[r]``), concatenated in rank order, on every rank."""
        if self.size <= 1:
            return t
        top = max(counts)
        pad = t.new_zeros((top,) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        g = self.all_gather(pad)
        return torch.cat([g[r, :c] for r, c in enumerate(counts)])


# ---------------------------------------------------------------------
# the quantized allreduce
# ---------------------------------------------------------------------

def _quantize(blocks: torch.Tensor, qmax: int, wire_dtype):
    """Per-block symmetric quantization: ``[nblk, BLOCK] -> (q, scale)``
    with ``scale = amax / qmax``."""
    amax = blocks.abs().amax(dim=1)
    scale = torch.clamp_min(amax, _TINY) / qmax
    q = torch.clamp(torch.round(blocks / scale[:, None]), -qmax, qmax)
    return q.to(wire_dtype), scale


def _pack_scales(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Append each block's f32 scale, its bytes viewed as wire-dtype
    lanes, to its integer payload: ``[nblk, BLOCK + s]``."""
    sw = scale.to(torch.float32).contiguous()[:, None].view(q.dtype)
    return torch.cat([q, sw], dim=1)


def _unpack_scales(packed: torch.Tensor):
    """Inverse of :func:`_pack_scales` -> ``(q [.., BLOCK], scale [..])``."""
    q = packed[..., :BLOCK]
    scale = packed[..., BLOCK:].contiguous().view(torch.float32)
    return q, scale[..., 0]


def _allreduce_exchange(comm: Comm, q, scale, qmax, wire, D):
    """Two-phase quantized allreduce of pre-quantized blocks: the
    ``all_to_all`` reduce-scatter, then the owner's requantized chunk
    ``all_gather``-ed. Returns ``(reduced [nblk, BLOCK] f32, phase-2
    requantization error of this rank's chunk [cb * BLOCK])``."""
    nblk = q.shape[0]
    cb = nblk // D
    px = comm.all_to_all(_pack_scales(q, scale))     # [nblk, BLOCK + s]
    qx, sx = _unpack_scales(px.reshape(D, cb, -1))
    red = (qx.to(torch.float32) * sx[..., None]).sum(dim=0)   # [cb, BLOCK]
    q2, scale2 = _quantize(red, qmax, wire)
    deq2 = q2.to(torch.float32) * scale2[:, None]
    err2 = (red - deq2).reshape(-1)
    pg = comm.all_gather(_pack_scales(q2, scale2))   # [D, cb, BLOCK + s]
    qg, sg = _unpack_scales(pg)
    out = qg.reshape(nblk, BLOCK).to(torch.float32) \
        * sg.reshape(nblk)[:, None]
    return out, err2


def _allreduce_shared_psum(comm: Comm, blocks, qmax, wire):
    """Shared-scale quantized allreduce: the block maxima's max over the
    world gives every rank the same scales, so ``sum_r q_r * scale =
    scale * sum_r q_r`` exactly (int32 on the wire). Returns
    ``(reduced, this rank's contribution as sent)``."""
    amax = comm.all_reduce(blocks.abs().amax(dim=-1).contiguous(), "max")
    scale = torch.clamp_min(amax, _TINY) / qmax
    q = torch.clamp(torch.round(blocks / scale[..., None]), -qmax, qmax)
    q = q.to(wire)
    total = comm.all_reduce(q.to(torch.int32))
    out = total.to(torch.float32) * scale[..., None]
    sent = q.to(torch.float32) * scale[..., None]
    return out, sent


def hist_allreduce(comm: Optional[Comm], x: torch.Tensor, mode: str = "f32",
                   error_feedback: Optional[torch.Tensor] = None,
                   strategy: str = "auto"):
    """Allreduce a histogram over ``comm``'s world under ``mode`` (see
    the module docstring). With ``error_feedback`` (``x``'s shape)
    returns ``(reduced, new_error_feedback)``, else ``reduced``. The
    input is not modified."""
    has_ef = error_feedback is not None

    def ret(y, ef):
        return (y, ef) if has_ef else y

    if comm is None or comm.size <= 1:
        return ret(x, error_feedback)
    if mode not in ("int8", "int16") or not x.is_floating_point():
        return ret(comm.all_reduce(x.clone()), error_feedback)
    D = comm.size
    if strategy == "auto":
        strategy = "exchange"
    qmax, wire = QMAX[mode], _WIRE_DTYPE[mode]
    shape, n = x.shape, x.numel()
    xe = x if not has_ef else x + error_feedback
    if strategy == "psum":
        pad = (-n) % BLOCK
        blocks = torch.nn.functional.pad(xe.reshape(-1), (0, pad)) \
            .reshape(-1, BLOCK)
        out_b, sent_b = _allreduce_shared_psum(comm, blocks, qmax, wire)
        y = out_b.reshape(-1)[:n].reshape(shape)
        new_ef = None
        if has_ef:
            new_ef = xe - sent_b.reshape(-1)[:n].reshape(shape)
        return ret(y, new_ef)
    step = D * BLOCK
    np_ = -(-n // step) * step
    flat = torch.nn.functional.pad(xe.reshape(-1), (0, np_ - n))
    blocks = flat.reshape(np_ // BLOCK, BLOCK)
    q, scale = _quantize(blocks, qmax, wire)
    out_b, err2 = _allreduce_exchange(comm, q, scale, qmax, wire, D)
    y = out_b.reshape(-1)[:n].reshape(shape)
    if not has_ef:
        return y
    sent = q.to(torch.float32) * scale[:, None]
    ef_flat = (blocks - sent).reshape(-1)
    cbe = np_ // D
    off = comm.rank * cbe
    ef_flat[off:off + cbe] += err2
    return y, ef_flat[:n].reshape(shape)


def make_hist_psum_ef(comm: Optional[Comm], hist_comm: str,
                      quantize: bool = True):
    """The wire-mode decision every grower shares: returns ``(qm,
    use_ef, hist_psum_ef)``, the resolved wire mode, whether an
    error-feedback buffer is carried, and ``hist_psum_ef(x, ef) ->
    (reduced, new_ef)``. ``quantize=False`` pins the wire to exact f32
    (quantized-gradient histograms are exact int32 already)."""
    active = comm is not None and comm.size > 1
    qm = hist_comm if (active and quantize
                       and hist_comm in ("int8", "int16")) else "f32"
    use_ef = qm != "f32"

    def hist_psum_ef(x, ef):
        if not active:
            return x, ef
        if not use_ef:
            return comm.all_reduce(x.clone()), ef
        return hist_allreduce(comm, x, qm, ef)

    return qm, use_ef, hist_psum_ef


def hist_reduce_scatter(comm: Optional[Comm], x: torch.Tensor,
                        mode: str = "f32",
                        error_feedback: Optional[torch.Tensor] = None,
                        scatter_axis: int = 0):
    """Reduce ``x`` over the world and return this rank's chunk of
    ``scatter_axis`` (``x.shape[scatter_axis] = D * chunk``): the
    reference data-parallel learner's ``ReduceScatter``, the reduction
    of ``split_search="sharded"``. f32 and integer histograms take one
    ``reduce_scatter``; ``int8``/``int16`` take the exchange's
    ``all_to_all`` of per-chunk quantized blocks and the owner's
    requantized (dequantized) chunk, without the broadcast. With
    ``error_feedback`` returns ``(chunk, new_error_feedback)``."""
    has_ef = error_feedback is not None

    def ret(y, ef):
        return (y, ef) if has_ef else y

    if comm is None or comm.size <= 1:
        return ret(x, error_feedback)
    xm = torch.movedim(x, scatter_axis, 0).contiguous()
    D = comm.size
    if mode not in ("int8", "int16") or not x.is_floating_point():
        chunk = comm.reduce_scatter(xm)
        return ret(torch.movedim(chunk, 0, scatter_axis), error_feedback)
    qmax, wire = QMAX[mode], _WIRE_DTYPE[mode]
    xe = xm if not has_ef else \
        xm + torch.movedim(error_feedback, scatter_axis, 0)
    cs = xm.shape[0] // D
    per = xe.numel() // D
    pad = (-per) % BLOCK
    fl = torch.nn.functional.pad(xe.reshape(D, per), (0, pad))
    cb = (per + pad) // BLOCK
    blocks = fl.reshape(D * cb, BLOCK)
    q, scale = _quantize(blocks, qmax, wire)
    px = comm.all_to_all(_pack_scales(q, scale))
    qx, sx = _unpack_scales(px.reshape(D, cb, -1))
    red = (qx.to(torch.float32) * sx[..., None]).sum(dim=0)
    q2, scale2 = _quantize(red, qmax, wire)
    deq2 = q2.to(torch.float32) * scale2[:, None]
    chunk = deq2.reshape(-1)[:per].reshape((cs,) + tuple(xm.shape[1:]))
    chunk = torch.movedim(chunk, 0, scatter_axis)
    if not has_ef:
        return chunk
    sent = q.to(torch.float32) * scale[:, None]
    ef_full = (blocks - sent).reshape(D, per + pad)[:, :per].clone()
    ef_full[comm.rank] += (red - deq2).reshape(-1)[:per]
    new_ef = torch.movedim(ef_full.reshape(xm.shape), 0, scatter_axis)
    return chunk, new_ef


# ---------------------------------------------------------------------
# the payload models
# ---------------------------------------------------------------------

def payload_elems(mode: str, F: int, B: int, top_k: int = 20) -> int:
    """Largest per-reduction payload (elements) of one split search
    under parallelism ``mode``: ``data`` the full ``[F, B, 2]``
    histogram; ``voting`` the elected ``[2k, B, 2]`` buffer of both
    children; ``feature`` the SplitInfo combine, bounded by ``2B``."""
    if mode == "data":
        return F * B * 2
    if mode == "voting":
        return 2 * min(2 * top_k, F) * B * 2
    if mode == "feature":
        return 2 * B
    raise ValueError(f"unknown parallel mode: {mode}")


def payload_bytes(mode: str, F: int, B: int, hist_comm: str = "f32",
                  top_k: int = 20) -> int:
    """Wire bytes of :func:`payload_elems`, with the per-block f32 scales
    of the quantized modes (the feature-mode SplitInfo stays f32)."""
    elems = payload_elems(mode, F, B, top_k)
    if mode == "feature" or hist_comm not in ("int8", "int16"):
        return elems * 4
    scales = -(-elems // BLOCK) * 4
    return elems * WIRE_ITEMSIZE[hist_comm] + scales


def splitinfo_elems(B: int) -> int:
    """Elements of one SplitInfo record: scalars plus the ``[B]``
    categorical mask, bounded by ``2B``."""
    return 2 * B


def post_reduction_elems(mode: str, F: int, B: int, D: int = 1,
                         split_search: str = "gathered",
                         top_k: int = 20) -> int:
    """What each rank receives after the reduce phase of one split
    search: the full histogram (gathered), its ``ceil(F/D)`` chunk plus
    ``D`` SplitInfo records (sharded), or :func:`payload_elems`."""
    if mode == "data" and split_search == "sharded" and D > 1:
        return -(-F // D) * B * 2 + D * splitinfo_elems(B)
    return payload_elems(mode, F, B, top_k)


def post_reduction_bytes(mode: str, F: int, B: int, D: int = 1,
                         split_search: str = "gathered",
                         hist_comm: str = "f32", top_k: int = 20) -> int:
    """Wire bytes of :func:`post_reduction_elems`."""
    if mode == "data" and split_search == "sharded" and D > 1:
        chunk = -(-F // D) * B * 2
        if hist_comm in ("int8", "int16"):
            scales = -(-chunk // BLOCK) * 4
            hist_b = chunk * WIRE_ITEMSIZE[hist_comm] + scales
        else:
            hist_b = chunk * 4
        return hist_b + D * splitinfo_elems(B) * 4
    return payload_bytes(mode, F, B, hist_comm, top_k)


def resolve_hist_comm(hist_comm: str, F: int, B: int,
                      parallel_mode: str = "data",
                      top_k: int = 20) -> str:
    """``hist_comm="auto"``: int16 once one f32 reduction of the active
    mode crosses ``AUTO_QUANT_BYTES``, exact f32 below."""
    if hist_comm != "auto":
        return hist_comm
    wire_f32 = payload_bytes(parallel_mode, F, B, "f32", top_k)
    return "int16" if wire_f32 >= AUTO_QUANT_BYTES else "f32"


def choose_parallel_mode(F: int, B: int, rows: int, world: int,
                         hist_comm: str = "f32", top_k: int = 20) -> str:
    """``tree_learner=auto`` from the payload model: ``feature`` when the
    rows are few enough to replicate, ``data`` while one histogram
    reduction stays under ``DATA_MAX_BYTES`` (or voting cannot elect
    fewer features than exist), ``voting`` beyond."""
    if world <= 1:
        return "data"
    if rows <= FEATURE_MAX_ROWS:
        return "feature"
    if F <= 2 * top_k:
        return "data"
    wire = resolve_hist_comm(hist_comm, F, B)
    if payload_bytes("data", F, B, wire, top_k) <= DATA_MAX_BYTES:
        return "data"
    return "voting"


# ---------------------------------------------------------------------
# the payload audit: what the port's collectives really sent
# ---------------------------------------------------------------------

def collective_payloads(comm: Comm, fn, *args):
    """Run ``fn(*args)`` and return one record per collective ``comm``
    issued meanwhile: ``{"prim", "elems", "itemsize", "bytes"}``, the
    bytes this rank sent (the JAX function traces a jaxpr; the port
    counts what ran)."""
    was = comm.keep_records
    comm.keep_records = True
    start = len(comm.records)
    try:
        fn(*args)
    finally:
        comm.keep_records = was
    out = comm.records[start:]
    del comm.records[start:]
    return out


def collective_summary(records: List[dict]) -> dict:
    """``{"n_collectives", "prims", "wire_bytes"}`` of a record list."""
    return {"n_collectives": len(records),
            "prims": sorted({r["prim"] for r in records}),
            "wire_bytes": sum(r["bytes"] for r in records)}
