"""Row-chunk sources: the raw-data side of streaming ingest.

Counterpart of ``lightgbm_tpu/data/sources.py``. A
:class:`RowChunkSource` is a RE-ITERABLE producer of bounded row chunks:
``chunks()`` can be called twice, because construction is a two-pass
pipeline (:mod:`.ingest`): pass 1 streams to count rows and gather the
bin-finding sample, pass 2 streams again and bins every chunk on the
device straight into the preallocated device bin matrix. The dense
float matrix therefore never exists; peak host memory is one chunk plus
the bounded bin-construction sample.

The adapters: numpy arrays, ``Sequence`` objects, generator factories,
CSV/TSV files (parsed chunk by chunk by the native parser,
``utils/native.py``, as the eager loader parses whole files; numpy when
it cannot be built) and, when pyarrow is installed, Arrow tables and
parquet files. Nothing here imports pyarrow until an Arrow source is
built, or torch.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, NamedTuple, Optional

import numpy as np

__all__ = ["RowChunk", "RowChunkSource", "ArrayChunkSource",
           "GeneratorChunkSource", "SequenceChunkSource",
           "CSVChunkSource", "ArrowChunkSource", "coerce_chunk_source",
           "DEFAULT_CHUNK_ROWS"]

#: chunk size when neither ``ingest_chunk_rows`` nor the source pins one
DEFAULT_CHUNK_ROWS = 65536


def _err(msg: str) -> Exception:
    """A ``LightGBMError``, imported at raise time (``basic`` imports
    this module)."""
    from ..basic import LightGBMError
    return LightGBMError(msg)


class RowChunk(NamedTuple):
    """One bounded batch of raw rows (+ optional per-row metadata)."""

    X: np.ndarray                       # [c, F] float
    label: Optional[np.ndarray] = None  # [c]
    weight: Optional[np.ndarray] = None  # [c]


def _as_chunk(obj) -> RowChunk:
    """Normalize what an adapter yielded into a :class:`RowChunk`:
    a bare array, an ``(X,)`` / ``(X, y)`` / ``(X, y, w)`` tuple, or an
    already-built RowChunk. X keeps float32 or float64 (anything else
    becomes float64); labels and weights become float64."""
    if isinstance(obj, RowChunk):
        X, y, w = obj
    elif isinstance(obj, np.ndarray):
        X, y, w = obj, None, None
    elif isinstance(obj, (tuple, list)):
        if not 1 <= len(obj) <= 3:
            raise _err(
                f"chunk tuples must be (X[, label[, weight]]), got "
                f"{len(obj)} elements")
        X = obj[0]
        y = obj[1] if len(obj) > 1 else None
        w = obj[2] if len(obj) > 2 else None
    else:
        raise _err(f"cannot interpret chunk of type {type(obj)}")
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    if X.ndim == 1:
        X = X[:, None]
    if y is not None:
        y = np.asarray(y, np.float64).ravel()
        if len(y) != X.shape[0]:
            raise _err(
                f"chunk label length {len(y)} != chunk rows {X.shape[0]}")
    if w is not None:
        w = np.asarray(w, np.float64).ravel()
        if len(w) != X.shape[0]:
            raise _err(
                f"chunk weight length {len(w)} != chunk rows {X.shape[0]}")
    return RowChunk(X, y, w)


class RowChunkSource:
    """Protocol for chunked row producers.

    Subclasses implement :meth:`chunks`; every call must start a FRESH
    iteration over the same data (the ingest pipeline streams twice).
    ``num_rows`` / ``num_features`` return ``None`` when unknown ahead
    of the first pass: the pipeline then counts during pass 1 and
    samples by a reservoir instead of the eager row draw."""

    #: advisory chunk size; ``ingest_chunk_rows`` overrides when set
    chunk_rows: int = DEFAULT_CHUNK_ROWS

    def num_rows(self) -> Optional[int]:
        return None

    def num_features(self) -> Optional[int]:
        return None

    def feature_names(self) -> Optional[List[str]]:
        return None

    def chunks(self) -> Iterator[RowChunk]:  # pragma: no cover - abstract
        raise NotImplementedError("RowChunkSource.chunks")


class ArrayChunkSource(RowChunkSource):
    """Slice an in-memory ``[n, F]`` array into row-chunk views (no
    copies)."""

    def __init__(self, X, label=None, weight=None,
                 chunk_rows: Optional[int] = None):
        self._X = np.asarray(X)
        if self._X.ndim == 1:
            self._X = self._X[:, None]
        self._label = None if label is None else \
            np.asarray(label, np.float64).ravel()
        self._weight = None if weight is None else \
            np.asarray(weight, np.float64).ravel()
        # checked up front: slices of a LONGER metadata vector match
        # every X slice, so a truncation would pass silently
        n = self._X.shape[0]
        if self._label is not None and len(self._label) != n:
            raise _err(f"Length of label ({len(self._label)}) != "
                       f"number of rows ({n})")
        if self._weight is not None and len(self._weight) != n:
            raise _err(f"Length of weight ({len(self._weight)}) != "
                       f"number of rows ({n})")
        if chunk_rows is not None:
            self.chunk_rows = int(chunk_rows)

    def num_rows(self) -> int:
        return int(self._X.shape[0])

    def num_features(self) -> int:
        return int(self._X.shape[1])

    def chunks(self) -> Iterator[RowChunk]:
        n = self._X.shape[0]
        step = max(1, int(self.chunk_rows))
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            yield _as_chunk((
                self._X[lo:hi],
                None if self._label is None else self._label[lo:hi],
                None if self._weight is None else self._weight[lo:hi]))


class GeneratorChunkSource(RowChunkSource):
    """Wrap a zero-argument factory returning a fresh chunk iterator
    per call. Items may be arrays, ``(X[, y[, w]])`` tuples, or
    RowChunks."""

    def __init__(self, factory: Callable[[], Iterator],
                 num_rows: Optional[int] = None,
                 num_features: Optional[int] = None,
                 feature_names: Optional[List[str]] = None,
                 chunk_rows: Optional[int] = None):
        if not callable(factory):
            raise _err(
                "GeneratorChunkSource needs a zero-argument factory "
                "returning a fresh chunk iterator per call (a generator "
                "OBJECT can only be consumed once, and ingestion "
                "streams twice)")
        self._factory = factory
        self._n = None if num_rows is None else int(num_rows)
        self._F = None if num_features is None else int(num_features)
        self._names = list(feature_names) if feature_names else None
        if chunk_rows is not None:
            self.chunk_rows = int(chunk_rows)

    def num_rows(self) -> Optional[int]:
        return self._n

    def num_features(self) -> Optional[int]:
        return self._F

    def feature_names(self) -> Optional[List[str]]:
        return self._names

    def chunks(self) -> Iterator[RowChunk]:
        for obj in self._factory():
            yield _as_chunk(obj)
            # drop this chunk before the factory makes the next one
            del obj


class SequenceChunkSource(RowChunkSource):
    """Adapter over ``Sequence`` objects (or a list of them): rows are
    pulled ``batch_size`` at a time."""

    def __init__(self, seqs, chunk_rows: Optional[int] = None):
        self._seqs = list(seqs)
        if chunk_rows is not None:
            self.chunk_rows = int(chunk_rows)
        else:
            self.chunk_rows = max(
                int(getattr(s, "batch_size", 0) or 0)
                for s in self._seqs) or DEFAULT_CHUNK_ROWS

    def num_rows(self) -> int:
        return int(sum(len(s) for s in self._seqs))

    def chunks(self) -> Iterator[RowChunk]:
        for s in self._seqs:
            n = len(s)
            bs = max(1, int(getattr(s, "batch_size", 0) or 0)
                     or self.chunk_rows)
            for lo in range(0, n, bs):
                yield _as_chunk(np.atleast_2d(np.asarray(
                    s[lo:min(lo + bs, n)], dtype=np.float64)))


def _text_sep(first: str) -> Optional[str]:
    """The delimiter of a text file from its first line: a tab, else a
    comma, else whitespace (None)."""
    return "\t" if "\t" in first else ("," if "," in first else None)


def parse_text_lines(lines: List[bytes], sep: Optional[str],
                     cols: Optional[int] = None) -> np.ndarray:
    """Non-empty text lines (bytes) as a ``[rows, cols]`` float64 matrix,
    by the native parser (``cols``: the file's column count; by default
    the first line's), or numpy's when it cannot be built."""
    from ..utils.native import parse_dense_rows
    if cols is None:
        first = lines[0].decode()
        cols = len(first.split(sep) if sep else first.split())
    arr = parse_dense_rows(b"".join(lines), len(lines), cols, sep)
    if arr is not None:
        return arr
    text = [ln.decode() for ln in lines]
    try:
        arr = np.loadtxt(text, delimiter=sep, ndmin=2)
    except ValueError:
        arr = np.genfromtxt(text, delimiter=sep)
        if arr.ndim == 1:
            arr = arr[None, :] if len(lines) == 1 else arr[:, None]
    return arr


class CSVChunkSource(RowChunkSource):
    """Stream a dense CSV/TSV/whitespace text file in row chunks; the
    label column is split out per chunk (``label_column`` index or
    ``name:<col>`` against the header). LibSVM files are ragged and
    not supported here (the eager loader handles them)."""

    def __init__(self, path: str, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 header: bool = False, label_column: str = ""):
        self.path = os.fspath(path)
        self.chunk_rows = max(1, int(chunk_rows))
        self.header = bool(header)
        with open(self.path, "r") as f:
            first = f.readline().strip()
        if not first:
            raise _err(f"empty data file {self.path}")
        self._sep = _text_sep(first)
        tokens = first.replace(",", " ").replace("\t", " ").split()
        if any(":" in t for t in tokens[1:]):
            raise _err(
                "chunked ingestion does not support LibSVM files "
                "(ragged rows); drop ingest_chunk_rows to use the "
                "eager loader")
        self._cols = len(first.split(self._sep) if self._sep
                         else first.split())
        self._header_names = None
        if self.header:
            self._header_names = [
                t.strip() for t in (first.split(self._sep) if self._sep
                                    else first.split())]
        self.label_col = self._resolve_label_col(str(label_column))

    def _resolve_label_col(self, lc: str) -> int:
        if lc.startswith("name:"):
            want = lc[len("name:"):]
            if not self._header_names:
                raise _err(
                    "label_column='name:...' requires header=true")
            if want not in self._header_names:
                raise _err(
                    f"label column '{want}' not found in header: "
                    f"{self._header_names}")
            return self._header_names.index(want)
        return int(lc) if lc else 0

    def feature_names(self) -> Optional[List[str]]:
        if not self._header_names:
            return None
        return [c for i, c in enumerate(self._header_names)
                if i != self.label_col]

    def chunks(self) -> Iterator[RowChunk]:
        with open(self.path, "rb") as f:
            if self.header:
                f.readline()
            buf: List[bytes] = []
            for line in f:
                if not line.strip():
                    continue
                buf.append(line)
                if len(buf) == self.chunk_rows:
                    yield self._emit(buf)
                    buf = []
            if buf:
                yield self._emit(buf)

    def _emit(self, buf: List[bytes]) -> RowChunk:
        arr = parse_text_lines(buf, self._sep, self._cols)
        y = arr[:, self.label_col].copy()
        X = np.delete(arr, self.label_col, axis=1)
        return RowChunk(X, y, None)


class ArrowChunkSource(RowChunkSource):
    """Optional pyarrow adapter: an in-memory ``pyarrow.Table`` /
    ``RecordBatch`` or a parquet file path, streamed as record
    batches. Constructing one without pyarrow raises a
    :class:`LightGBMError`; nothing else in the package imports
    pyarrow."""

    def __init__(self, data, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 label_column: Optional[str] = None):
        try:
            import pyarrow as pa  # noqa: F401
        except ImportError as e:
            raise _err(
                "ArrowChunkSource requires pyarrow, which is not "
                "installed") from e
        self.chunk_rows = max(1, int(chunk_rows))
        self.label_column = label_column
        self._path = None
        self._table = None
        if isinstance(data, (str, os.PathLike)):
            self._path = os.fspath(data)
        else:
            import pyarrow as pa
            if isinstance(data, pa.RecordBatch):
                data = pa.Table.from_batches([data])
            if not isinstance(data, pa.Table):
                raise _err(
                    f"ArrowChunkSource needs a pyarrow Table/"
                    f"RecordBatch or a parquet path, got {type(data)}")
            self._table = data

    def _schema_names(self) -> List[str]:
        if self._table is not None:
            return list(self._table.column_names)
        import pyarrow.parquet as pq
        return list(pq.ParquetFile(self._path).schema_arrow.names)

    def num_rows(self) -> Optional[int]:
        if self._table is not None:
            return int(self._table.num_rows)
        import pyarrow.parquet as pq
        return int(pq.ParquetFile(self._path).metadata.num_rows)

    def num_features(self) -> int:
        names = self._schema_names()
        return len(names) - (1 if self.label_column in names else 0)

    def feature_names(self) -> List[str]:
        return [c for c in self._schema_names() if c != self.label_column]

    def _batches(self):
        if self._table is not None:
            yield from self._table.to_batches(
                max_chunksize=self.chunk_rows)
            return
        import pyarrow.parquet as pq
        yield from pq.ParquetFile(self._path).iter_batches(
            batch_size=self.chunk_rows)

    def chunks(self) -> Iterator[RowChunk]:
        for batch in self._batches():
            cols, y = [], None
            for name in batch.schema.names:
                np_col = np.asarray(batch.column(name).to_numpy(
                    zero_copy_only=False), dtype=np.float64)
                if name == self.label_column:
                    y = np_col
                else:
                    cols.append(np_col)
            X = np.column_stack(cols) if cols else \
                np.zeros((batch.num_rows, 0))
            yield _as_chunk((X, y))


def _resolve_arrow_label(src: "ArrowChunkSource",
                         lc: str) -> Optional[str]:
    """Map ``label_column`` (``name:<col>`` or an index, as the text
    loaders read it) onto an Arrow schema column name; ignoring it
    would train on the label as a feature."""
    names = src._schema_names()
    if lc.startswith("name:"):
        want = lc[len("name:"):]
        if want not in names:
            raise _err(f"label column '{want}' not found in the "
                       f"Arrow schema: {names}")
        return want
    idx = int(lc) if lc else 0
    if not 0 <= idx < len(names):
        raise _err(f"label_column index {idx} out of range for the "
                   f"{len(names)}-column Arrow schema")
    return names[idx]


def coerce_chunk_source(data, cfg) -> Optional[RowChunkSource]:
    """Map ``Dataset(data=...)`` inputs onto a chunk source, or return
    None for inputs the eager constructor keeps handling.

    Streams unconditionally: RowChunkSource instances, zero-arg chunk
    factories (callables), and ``Sequence`` objects / lists of them.
    Streams when ``ingest_chunk_rows > 0``: text-file paths (CSV/TSV;
    LibSVM keeps the eager loader) and parquet paths / pyarrow tables.
    """
    chunk_rows = int(getattr(cfg, "ingest_chunk_rows", 0) or 0)

    if isinstance(data, RowChunkSource):
        if chunk_rows > 0:
            data.chunk_rows = chunk_rows
        return data
    # basic.py imports this module: Sequence is looked up at call time
    from ..basic import Sequence
    if isinstance(data, Sequence):
        return SequenceChunkSource([data],
                                   chunk_rows=chunk_rows or None)
    if isinstance(data, (list, tuple)) and data \
            and all(isinstance(s, Sequence) for s in data):
        return SequenceChunkSource(list(data),
                                   chunk_rows=chunk_rows or None)
    if callable(data) and not isinstance(data, type):
        return GeneratorChunkSource(data,
                                    chunk_rows=chunk_rows or None)
    if chunk_rows <= 0:
        return None
    if isinstance(data, (str, os.PathLike)):
        path = os.fspath(data)
        if path.endswith((".parquet", ".pq")):
            src = ArrowChunkSource(path, chunk_rows=chunk_rows)
            src.label_column = _resolve_arrow_label(
                src, str(cfg.label_column))
            return src
        try:
            with open(path, "r") as f:
                first = f.readline().strip()
        except OSError:
            # a missing file: the eager loader raises its usual error
            return None
        tokens = first.replace(",", " ").replace("\t", " ").split()
        if any(":" in t for t in tokens[1:]):
            return None  # LibSVM rows are ragged; eager loader handles
        if getattr(cfg, "two_round", False):
            from ..log import log_warning
            log_warning(
                "ingest_chunk_rows > 0 streams this file through the "
                "chunked two-pass pipeline; two_round=true is "
                "superseded (the loaders sample differently, so bin "
                "boundaries may differ from previous two_round runs)")
        return CSVChunkSource(path, chunk_rows=chunk_rows,
                              header=bool(cfg.header),
                              label_column=str(cfg.label_column))
    if type(data).__module__.split(".")[0] == "pyarrow":
        src = ArrowChunkSource(data, chunk_rows=chunk_rows)
        if cfg.label_column:
            src.label_column = _resolve_arrow_label(
                src, str(cfg.label_column))
        return src
    return None
