"""Two-pass streaming ingest: chunks -> BinMappers -> device bin matrix.

Counterpart of ``lightgbm_tpu/data/ingest.py``, the construct behind
``Dataset(chunked_source | path, params={"ingest_chunk_rows": N})``:

pass 1
    Stream the source once: count rows, check the feature width, and
    gather the bin-construction sample. When the source declares its
    row count the sample is the EXACT row draw the eager constructor
    makes (``rng.choice(n, sample_cnt)`` under ``data_random_seed``), so
    the BinMappers are bit-identical to an in-memory construct of the
    same data (``find_bin`` reduces through ``np.unique``, so the order
    of the rows does not matter). Unknown-length sources sample by a
    reservoir under the same seed; the two agree when
    ``bin_construct_sample_cnt`` covers the whole stream.

pass 2
    Stream the source again: each chunk goes to the device once and is
    binned there (``ops/binning.py`` ``bin_matrix``) straight into the
    preallocated ``[n, F_used]`` u8/u16 device tensor; the binned matrix
    never exists on the host. ``keep_raw`` fills a preallocated
    ``[n, F_used]`` float32 device tensor the same way (linear trees).
    The data digest is accumulated over the label chunks as they pass.

Peak host memory is one chunk plus the sample (kept in the chunks'
dtype) plus the label and weight vectors, never the float matrix.

``LIGHTGBM_TPU_FAULT_INJECT=rank_kill@-1`` kills the process after
pass 1 has found the mappers, where the JAX package fires it before
its mapper broadcast. In a world of ranks the port broadcasts no
mappers here: ``parallel/spmd.py`` ``distributed_dataset`` constructs
rank 0's shard first and hands its mappers to the other ranks'
constructs as their ``reference``. Chunks and rows
are counted in the metrics registry (``obs/registry.py``) as the JAX
package counts them.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from .sources import DEFAULT_CHUNK_ROWS, RowChunkSource, _as_chunk, _err

__all__ = ["ingest_dataset", "IngestResult", "dataset_digest",
           "INGEST_FAULT_ITERATION"]

#: the pseudo-iteration ``rank_kill`` fires at during ingest
#: (``rank_kill@-1``), as in the JAX package
INGEST_FAULT_ITERATION = -1


class IngestResult(NamedTuple):
    bins: Any                      # [n, F_used] u8/u16 device tensor
    mappers: List                  # used-feature BinMappers
    used: np.ndarray               # [F_used] int32 original indices
    full_mappers: List             # one per original feature
    n: int
    F: int
    label: Optional[np.ndarray]    # [n] float64, None if source had none
    weight: Optional[np.ndarray]   # [n] float64, None if source had none
    digest: Optional[str]          # data digest (source labels)
    raw: Any                       # [n, F_used] f32 device, keep_raw only
    stats: Dict[str, Any]          # the JAX package's `ingest` payload


def dataset_digest(label: np.ndarray, bins: np.ndarray) -> str:
    """The training data's identity hash, as the JAX package defines it:
    sha256 over the float64 label vector followed by the first 64 binned
    rows (host ``[n, F]`` bins). The streamed construct accumulates the
    same hash chunk by chunk, so both constructs of the same data
    agree."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(
        np.asarray(label, np.float64)).tobytes())
    h.update(np.ascontiguousarray(bins[:64]).tobytes())
    return h.hexdigest()


def _chunk_rows_of(source: RowChunkSource, cfg) -> int:
    return int(getattr(cfg, "ingest_chunk_rows", 0) or 0) \
        or int(getattr(source, "chunk_rows", 0) or 0) \
        or DEFAULT_CHUNK_ROWS


class _SampleAccumulator:
    """Collect the pass-1 bin-construction sample from streamed chunks.

    ``n_declared`` known: gather exactly the eager constructor's
    ``rng.choice`` row set (or every row when the budget covers n) into
    one buffer allocated at the first chunk. Unknown: a reservoir over
    the stream, capacity ``bin_construct_sample_cnt``, under
    ``RandomState(data_random_seed)``. The buffer keeps the chunks'
    dtype (``find_bin`` reads float64 either way), so a float32 source
    is sampled at 4 bytes a value."""

    def __init__(self, cfg, n_declared: Optional[int]):
        self._cap = max(int(cfg.bin_construct_sample_cnt), 2)
        self._rs = np.random.RandomState(cfg.data_random_seed)
        self._wanted: Optional[np.ndarray] = None
        self._reservoir = n_declared is None
        if n_declared is not None:
            sample_cnt = min(self._cap, n_declared)
            self._wanted = np.sort(self._rs.choice(
                n_declared, size=sample_cnt, replace=False)) \
                if sample_cnt < n_declared else None
            self._size = sample_cnt
        else:
            self._size = self._cap
        self._buf: Optional[np.ndarray] = None
        self._filled = 0

    def _store(self, F: int, dtype) -> np.ndarray:
        if self._buf is None:
            self._buf = np.empty((self._size, F), dtype)
        elif np.dtype(dtype).itemsize > self._buf.dtype.itemsize:
            self._buf = self._buf.astype(dtype)
        return self._buf

    def add(self, Xc: np.ndarray, start: int) -> None:
        c = Xc.shape[0]
        buf = self._store(Xc.shape[1], Xc.dtype)
        if not self._reservoir:
            if self._wanted is None:
                # a stream longer than declared fails its count check
                take = max(0, min(c, self._size - start))
                buf[start:start + take] = Xc[:take]
                self._filled = start + take
                return
            lo = int(np.searchsorted(self._wanted, start))
            hi = int(np.searchsorted(self._wanted, start + c))
            if hi > lo:
                rows = self._wanted[lo:hi] - start
                if buf.dtype == Xc.dtype:
                    # gathered straight into the buffer: mode="clip"
                    # (the rows are in range) keeps np.take from
                    # buffering the whole output first
                    np.take(Xc, rows, axis=0, out=buf[lo:hi], mode="clip")
                else:
                    buf[lo:hi] = Xc[rows]
                self._filled = hi
            return
        # reservoir: head-fill to capacity, then uniform replacement
        head = min(max(self._cap - self._filled, 0), c)
        if head:
            buf[self._filled:self._filled + head] = Xc[:head]
        if c > head:
            seen = np.arange(start + head, start + c, dtype=np.int64)
            j = (self._rs.random_sample(len(seen))
                 * (seen + 1)).astype(np.int64)
            repl = j < self._cap
            if repl.any():
                buf[j[repl]] = Xc[head:][repl]
        self._filled = min(self._filled + c, self._cap)

    def sample(self) -> np.ndarray:
        if self._buf is None:
            return np.zeros((0, 0), np.float64)
        return self._buf[:self._filled]


def _stream_count(source: RowChunkSource,
                  sampler: Optional[_SampleAccumulator]):
    """One pass over the source: (n, F, chunk_count), feeding the
    sampler when bin mappers are being found."""
    n = 0
    F: Optional[int] = source.num_features()
    chunks = 0
    for obj in source.chunks():
        # a custom RowChunkSource may yield unnormalized chunks;
        # _as_chunk is idempotent for the built-in adapters
        Xc = _as_chunk(obj).X
        if F is None:
            F = int(Xc.shape[1])
        elif Xc.shape[1] != F:
            raise _err(
                f"ingest: chunk {chunks} has {Xc.shape[1]} features, "
                f"expected {F}")
        if sampler is not None:
            sampler.add(Xc, n)
        n += Xc.shape[0]
        chunks += 1
        # one chunk at a time: drop it before the source makes the next
        del obj, Xc
    if n == 0:
        raise _err("ingest: the chunk source produced no rows")
    n_decl = source.num_rows()
    if n_decl is not None and n != n_decl:
        raise _err(
            f"ingest: source declared {n_decl} rows but streamed {n}")
    return n, int(F), chunks


# sampled rows from which the mapper loop runs in threads
_THREADED_ROWS = 100_000


def _find_chunk_mappers(sample: np.ndarray, cfg, cat_idx_set,
                        rows=slice(None)) -> List:
    """The mapper loop of every construct: one ``find_bin`` per column
    of ``sample[rows]``, with the per-feature budget and missing
    handling. ``rows`` picks the eager construct's sample a block of
    columns at a time, so the sampled matrix is never gathered whole.
    From ``_THREADED_ROWS`` sampled rows, the columns of a block go to a
    thread per core: ``find_bin`` is then mostly numpy work on its own
    column (below, mostly Python, and threads only contend for the
    interpreter)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..ops.binning import BinType, column_blocks, find_bin

    def one(j, values):
        mb = cfg.max_bin
        if cfg.max_bin_by_feature and j < len(cfg.max_bin_by_feature):
            mb = cfg.max_bin_by_feature[j]
        return find_bin(values, mb,
                        min_data_in_bin=cfg.min_data_in_bin,
                        bin_type=(BinType.CATEGORICAL if j in cat_idx_set
                                  else BinType.NUMERICAL),
                        use_missing=cfg.use_missing,
                        zero_as_missing=cfg.zero_as_missing)

    nr = sample.shape[0] if isinstance(rows, slice) else len(rows)
    workers = (os.cpu_count() or 1) if nr >= _THREADED_ROWS else 1
    full_mappers = []
    with ThreadPoolExecutor(workers) as pool:
        # find_bin reads its values in any order: the sampled rows go in
        # ascending order, a block of columns at a time
        for blk in column_blocks(sample, np.arange(sample.shape[1]),
                                 None if isinstance(rows, slice) else rows):
            j = len(full_mappers)
            full_mappers.extend(pool.map(one, range(j, j + len(blk)), blk))
    return full_mappers


def used_mappers(full_mappers: List):
    """The used (non-trivial) feature indices and their mappers."""
    used = np.asarray([j for j, m in enumerate(full_mappers)
                       if not m.is_trivial], np.int32)
    return used, [full_mappers[j] for j in used]


def alloc_bins(n: int, mappers: List, device):
    """The preallocated ``[n, F_used]`` u8 (u16 above 256 bins) device
    matrix that pass 2 bins into."""
    import torch
    max_bins = max((m.num_bins for m in mappers), default=2)
    bdtype = torch.uint8 if max_bins <= 256 else torch.uint16
    return torch.empty((n, len(mappers)), dtype=bdtype, device=device)


def bin_chunk(Xc: np.ndarray, used: np.ndarray, mappers: List, bins,
              row: int, raw=None, used_t=None) -> None:
    """Send a host chunk to the device once (in its own dtype; a
    read-only or strided chunk is made contiguous first) and bin it
    into ``bins[row:row + c]``; with ``raw`` also keep its used columns
    there as float32 (``used_t``: ``used`` as a device index)."""
    import torch

    from ..ops.binning import bin_matrix
    if not len(used):
        return
    c = Xc.shape[0]
    Xd = torch.from_numpy(np.require(Xc, requirements=["C", "W"])) \
        .to(bins.device)
    bin_matrix(Xd, used, mappers, out=bins[row:row + c])
    if raw is not None:
        raw[row:row + c] = Xd.index_select(1, used_t).float()


def ingest_dataset(source: RowChunkSource, cfg, cat_idx_set,
                   reference=None, keep_raw: bool = False,
                   device=None) -> IngestResult:
    """Run the two-pass pipeline over ``source``, binning on ``device``.

    ``reference`` (a constructed Dataset) skips pass-1 mapper finding:
    a valid set bins against the training set's mappers, so only the
    row count (skipped when the source declares it) and the binning
    pass remain. ``keep_raw`` also keeps the used columns' raw values as
    an ``[n, F_used]`` float32 device tensor (linear trees).

    The stats dict has the JAX package's keys. Its ``host_binned_bytes``
    is 0: the bins are written on the device chunk by chunk and never
    held on the host. ``world`` is 1: each rank's construct is its own
    (``parallel/spmd.py``).
    """
    import torch

    chunk_rows = _chunk_rows_of(source, cfg)
    t0 = time.perf_counter()
    sampled_rows = 0

    # ---- pass 1: count + sample -> mappers ----
    if reference is not None:
        full_mappers = reference._full_mappers
        used = np.asarray(reference._used_features, np.int32)
        mappers = list(reference.mappers)
        n_known = source.num_rows()
        if n_known is not None:
            n, F = int(n_known), len(full_mappers)
        else:
            n, F, _ = _stream_count(source, sampler=None)
        if F != len(full_mappers):
            raise _err(
                f"ingest: source has {F} features, the reference "
                f"dataset has {len(full_mappers)}")
    else:
        sampler = _SampleAccumulator(cfg, source.num_rows())
        n, F, _ = _stream_count(source, sampler=sampler)
        sample = sampler.sample()
        sampled_rows = int(sample.shape[0])
        full_mappers = _find_chunk_mappers(sample, cfg, cat_idx_set)
        del sample, sampler
        from ..resilience.faults import FaultPlan
        plan = FaultPlan.from_env()
        if plan.active:
            plan.maybe_distributed_fault(INGEST_FAULT_ITERATION)
        # (the JAX package broadcasts process 0's mappers here in a
        # world; the port's ranks take rank 0's as their reference,
        # parallel/spmd.py distributed_dataset)
        used, mappers = used_mappers(full_mappers)
    t1 = time.perf_counter()

    # ---- pass 2: bin chunks on the device into the preallocated
    # device matrix ----
    bins = alloc_bins(n, mappers, device)
    raw = used_t = None
    if keep_raw:
        raw = torch.empty((n, len(used)), dtype=torch.float32,
                          device=device)
        used_t = torch.as_tensor(used.astype(np.int64), device=device)
    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    label_hash = hashlib.sha256()
    row = 0
    chunks = 0
    for obj in source.chunks():
        # normalized here too: the digest hashes the label BYTES, so a
        # source yielding float32 labels is widened to float64 first
        Xc, yc, wc = _as_chunk(obj)
        c = Xc.shape[0]
        if Xc.shape[1] != F:
            raise _err(
                f"ingest: pass-2 chunk {chunks} has {Xc.shape[1]} "
                f"features, expected {F}")
        if row + c > n:
            raise _err(
                f"ingest: second pass produced more rows than the "
                f"first ({row + c} > {n}); chunk sources must be "
                "re-iterable over identical data")
        bin_chunk(Xc, used, mappers, bins, row, raw, used_t)
        if yc is not None:
            if label is None:
                if row != 0:
                    raise _err(
                        "ingest: labels appeared mid-stream; every "
                        "chunk must carry them or none may")
                label = np.zeros(n, np.float64)
            label[row:row + c] = yc
            label_hash.update(np.ascontiguousarray(yc).tobytes())
        elif label is not None:
            raise _err(
                "ingest: labels disappeared mid-stream; every "
                "chunk must carry them or none may")
        if wc is not None:
            if weight is None:
                if row != 0:
                    raise _err(
                        "ingest: weights appeared mid-stream; "
                        "every chunk must carry them or none may")
                weight = np.zeros(n, np.float64)
            weight[row:row + c] = wc
        elif weight is not None:
            raise _err(
                "ingest: weights disappeared mid-stream; every "
                "chunk must carry them or none may")
        row += c
        chunks += 1
        del obj, Xc, yc, wc
    if row != n:
        raise _err(
            f"ingest: second pass streamed {row} rows, first pass {n}")
    if bins.is_cuda:
        torch.cuda.synchronize(bins.device)
    t2 = time.perf_counter()

    digest = None
    if label is not None:
        label_hash.update(np.ascontiguousarray(
            bins[:64].cpu().numpy()).tobytes())
        digest = label_hash.hexdigest()

    stats = {
        "rows": int(n),
        "features": int(F),
        "used_features": int(len(used)),
        "chunks": int(chunks),
        "chunk_rows": int(chunk_rows),
        "sample_rows": int(sampled_rows),
        "pass1_s": round(t1 - t0, 6),
        "pass2_s": round(t2 - t1, 6),
        # the bins go to the device chunk by chunk: none on the host
        "host_binned_bytes": 0,
        "source": type(source).__name__,
        "world": 1,
    }
    from ..obs.registry import registry
    registry.counter("ingest_chunks").inc(chunks)
    registry.counter("ingest_rows").inc(n)
    registry.gauge("host_binned_bytes").set(0.0)
    return IngestResult(bins, mappers, used, full_mappers, n, F,
                        label, weight, digest, raw, stats)
