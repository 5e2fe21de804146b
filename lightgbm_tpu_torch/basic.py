"""Public ``Dataset`` and ``Booster`` of the port.

Counterpart of ``lightgbm_tpu/basic.py`` for the ported paths: a dense
matrix (NaN allowed) or a pandas frame, with categorical features named
by ``categorical_feature`` (indices or names, in the constructor or the
params) or given as pandas category columns (mapped to their codes; the
categories are kept as ``pandas_categorical``), with labels, optional
weights and, for
learning to rank, query groups and result-list positions is binned
once — mappers found on the host from a row sample, exactly as
the JAX package does, or taken from a ``reference`` Dataset (a valid
set), the bin matrix built on the device — and kept as a row-major
``[n, F]`` u8 tensor (u16 when a feature has more than 256 bins), the
layout the grower streams. With ``enable_bundle`` (the default),
``Dataset.bundles`` bundles mutually exclusive sparse features (EFB,
``ops/bundling.py``) into an ``[n, G]`` matrix built on the device;
while the bundled matrix is on the device, the ``[n, F]`` one waits on
the host, and the other way round, so one training matrix at a time
takes device memory. ``Booster`` trains through
``models/gbdt.py`` (with valid sets and their metrics: ``add_valid``,
``eval_train``, ``eval_valid``), predicts through ``prediction.py`` and
reads and writes the JAX package's model text.

A Dataset is also built from a file (:func:`_load_text_file`: CSV, TSV
or LibSVM, sniffed from the first line, with ``header`` and
``label_column``, and ``<file>.weight`` / ``<file>.query`` beside it;
dense text through the native parser, ``utils/native.py``, with numpy
as the fallback) or from a binary file written by ``save_binary`` in
either package (an npz: the ``[n, F]`` bins, the mappers as
``BinMapper.to_dict()``, the metadata), whose bins go straight to the
device. ``Booster`` trains with a custom objective too (``update(fobj=)``:
one copy of the score to the host and one of the gradients back per
iteration), refits its leaves on new data (:meth:`Booster.refit`), and
has the rest of the JAX package's ``Booster`` surface (rollback, leaf
outputs, JSON dump, attributes, ...).

Streaming input (``data/``): a chunk source, a chunk factory, a
``Sequence`` or a list of them, and with ``ingest_chunk_rows > 0`` a
text or parquet path or an Arrow table, is built in two passes (a
sample for the mappers, then chunk by chunk binned on the device into
the preallocated device matrix); ``two_round`` loads a text file so
too; ``init_streaming`` / ``push_rows`` / ``mark_finished`` stage rows
on the host and construct once. ``Booster.compile`` gives a
``serve.CompiledForest``, which ``predict`` then rides.
``Booster.set_network`` / ``free_network`` join and leave a world of
ranks (``parallel/distributed.py``), and ``Dataset.free_host_bins``
drops a host copy of the bins (``parallel/placement.py``).
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import Config, resolve_params
from .data.ingest import _find_chunk_mappers, used_mappers
from .ops.binning import BinMapper, BinType, MissingType, bin_matrix

__all__ = ["Dataset", "Booster", "LightGBMError", "Sequence",
           "resolve_device"]

# the nesting depth of Dataset.construct on this thread
_CONSTRUCT_TL = threading.local()


class LightGBMError(Exception):
    """Error raised by the port's public API."""


def resolve_device(cfg: Config) -> torch.device:
    """``device_type="cuda"`` (the default) is the card and raises when
    there is none; the port never carries on quietly on the CPU."""
    if cfg.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type='cuda' (the default) but torch.cuda is not "
                "available; pass device_type='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _load_text_file(path: str, cfg: Config
                    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                               Optional[np.ndarray]]:
    """A CSV, TSV or LibSVM file as ``(X, label, weight, group)``, as the
    JAX package's ``_load_text_file`` reads it: the format sniffed from
    the first line (tabs, commas, ``index:value`` pairs), ``header``,
    ``label_column`` (an index, or ``name:<column>`` against the header),
    and ``<path>.weight`` / ``<path>.query`` when they exist."""
    with open(path, "r") as f:
        first = f.readline().strip()
    header = cfg.header
    sep = None
    if "\t" in first:
        sep = "\t"
    elif "," in first:
        sep = ","
    tokens = first.replace(",", " ").replace("\t", " ").split()
    is_libsvm = any(":" in t for t in tokens[1:])

    label_col = 0
    lc = str(cfg.label_column)
    if lc.startswith("name:"):
        want = lc[len("name:"):]
        if not header:
            raise LightGBMError(
                "label_column='name:...' requires header=true")
        names = [t.strip() for t in
                 (first.split(sep) if sep else first.split())]
        if want not in names:
            raise LightGBMError(
                f"label column '{want}' not found in header: {names}")
        label_col = names.index(want)
    elif lc != "":
        label_col = int(lc)

    if is_libsvm:
        labels, rows = [], []
        max_idx = -1
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = {}
                for tok in parts[1:]:
                    if ":" not in tok:
                        continue
                    i, v = tok.split(":")
                    i = int(i)
                    row[i] = float(v)
                    max_idx = max(max_idx, i)
                rows.append(row)
        X = np.zeros((len(rows), max_idx + 1))
        for r, row in enumerate(rows):
            for i, v in row.items():
                X[r, i] = v
        y = np.asarray(labels)
    else:
        from .utils.native import parse_dense_text
        raw = parse_dense_text(path, bool(header))
        if raw is None:
            raw = np.genfromtxt(path, delimiter=sep,
                                skip_header=1 if header else 0)
        if raw.ndim == 1:
            raw = raw[:, None]
        y = raw[:, label_col].copy()
        X = np.delete(raw, label_col, axis=1)

    weight = None
    group = None
    if os.path.exists(path + ".weight"):
        weight = np.loadtxt(path + ".weight")
    if os.path.exists(path + ".query"):
        group = np.loadtxt(path + ".query").astype(np.int64)
    return X, y, weight, group


def _two_round_load(path: str, cfg: Config, cat_idx_set, device):
    """Two-round text loading (``two_round=true``), as the JAX package's
    ``_two_round_load``: round 1 streams the file once, counting rows
    and reservoir-sampling up to ``bin_construct_sample_cnt`` raw lines
    (``RandomState(data_random_seed)``), and the mappers come from the
    sample only; round 2 parses the file in chunks of 16,384 lines and
    bins each on the device straight into the preallocated device
    matrix, so the float matrix never exists. Lines are parsed by the
    native parser (numpy without it). None for a LibSVM file (the eager
    loader takes it).

    Returns (bins [n, F_used] on ``device``, mappers, used,
    full_mappers, n, F, label, weight, group)."""
    from .data.ingest import alloc_bins, bin_chunk
    from .data.sources import _text_sep, parse_text_lines

    with open(path, "r") as f:
        first = f.readline().strip()
    sep = _text_sep(first)
    tokens = first.replace(",", " ").replace("\t", " ").split()
    if any(":" in t for t in tokens[1:]):
        return None
    header = bool(cfg.header)
    label_col = 0
    lc = str(cfg.label_column)
    if lc.startswith("name:"):
        # resolved here: the mode exists for files too large for the
        # eager loader, so it must not fall back to it
        want = lc[len("name:"):]
        if not header:
            raise LightGBMError(
                "label_column='name:...' requires header=true")
        names = [t.strip() for t in
                 (first.split(sep) if sep else first.split())]
        if want not in names:
            raise LightGBMError(
                f"label column '{want}' not found in header: {names}")
        label_col = names.index(want)
    elif lc:
        label_col = int(lc)
    cols = len(first.split(sep) if sep else first.split())

    # ---- round 1: count + reservoir sample of raw lines ----
    rs = np.random.RandomState(cfg.data_random_seed)
    cap = max(int(cfg.bin_construct_sample_cnt), 2)
    sample_lines: List[bytes] = []
    n = 0
    with open(path, "rb") as f:
        if header:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            if n < cap:
                sample_lines.append(line)
            else:
                j = int(rs.randint(0, n + 1))
                if j < cap:
                    sample_lines[j] = line
            n += 1
    if n == 0:
        raise LightGBMError(f"empty data file {path}")
    sample = parse_text_lines(sample_lines, sep, cols)
    del sample_lines
    F = sample.shape[1] - 1
    Xs = np.delete(sample, label_col, axis=1)
    del sample
    full_mappers = _find_chunk_mappers(Xs, cfg, cat_idx_set)
    del Xs
    used, mappers = used_mappers(full_mappers)

    # ---- round 2: chunked parse -> bin on the device in place ----
    CHUNK = 16384
    bins = alloc_bins(n, mappers, device)
    label = np.zeros(n, np.float64)
    row = 0

    def flush(buf):
        arr = parse_text_lines(buf, sep, cols)
        label[row:row + len(buf)] = arr[:, label_col]
        bin_chunk(np.delete(arr, label_col, axis=1), used, mappers, bins,
                  row)
        return row + len(buf)

    with open(path, "rb") as f:
        if header:
            f.readline()
        buf: List[bytes] = []
        for line in f:
            if not line.strip():
                continue
            buf.append(line)
            if len(buf) == CHUNK:
                row = flush(buf)
                buf = []
        if buf:
            row = flush(buf)
    if row != n:
        raise LightGBMError(
            f"two_round: second pass read {row} rows, first pass {n}")
    weight = None
    group = None
    if os.path.exists(path + ".weight"):
        weight = np.loadtxt(path + ".weight")
    if os.path.exists(path + ".query"):
        group = np.loadtxt(path + ".query").astype(np.int64)
    return (bins, mappers, used, full_mappers, n, F, label, weight, group)


class Sequence:
    """Generic chunked data source (the reference's abstract streaming
    Sequence): subclass with ``__getitem__`` (row index or slice -> numpy
    rows), ``__len__``, and optionally ``batch_size``. A Sequence (or a
    list of them) is a valid ``Dataset(data=...)``: rows are pulled
    batch by batch through the streaming construct (``data/``)."""

    batch_size = 4096

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError("Sequence.__getitem__")

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError("Sequence.__len__")


def _extract_arrow(data):
    """A pyarrow Table / RecordBatch / Array as ``[n, F]`` float64 and
    its column names, as the JAX package's ``_extract_arrow`` reads
    it."""
    import pyarrow as pa

    if isinstance(data, pa.RecordBatch):
        data = pa.Table.from_batches([data])
    if isinstance(data, (pa.ChunkedArray, pa.Array)):
        col = data.combine_chunks() if isinstance(data, pa.ChunkedArray) \
            else data
        return np.asarray(col, dtype=np.float64)[:, None], []
    if not isinstance(data, pa.Table):
        raise LightGBMError(
            f"Unsupported pyarrow input {type(data)}; pass a Table, "
            "RecordBatch or Array")
    cols = [np.asarray(data.column(name).to_numpy(zero_copy_only=False),
                       dtype=np.float64) for name in data.column_names]
    X = np.column_stack(cols) if cols else np.zeros((data.num_rows, 0))
    return X, list(data.column_names)


_BIN_MAGIC = "lightgbm_tpu.dataset.v1"


def _is_binary_file(path: str) -> bool:
    """A binary dataset of either package: a zip whose members hold
    ``meta_json``. A text file that merely starts with ``PK`` is
    text."""
    try:
        with open(path, "rb") as f:
            if f.read(4) != b"PK\x03\x04":
                return False
        with np.load(path, allow_pickle=False) as z:
            return "meta_json" in z.files
    except (OSError, ValueError, KeyError):
        return False


def _extract_pandas(data, categorical_feature, pandas_categorical=None):
    """A pandas frame's matrix: category columns become their codes
    (NaN for a missing value), over ``pandas_categorical``'s categories
    when given (a valid set takes its reference's). Returns ``(X, names,
    categorical column indices, the frame's categories per category
    column)``."""
    import pandas as pd
    names = [str(c) for c in data.columns]
    cat_cols, cats, arrs = [], [], []
    for i, col in enumerate(data.columns):
        s = data[col]
        if isinstance(s.dtype, pd.CategoricalDtype):
            if pandas_categorical is not None \
                    and len(cat_cols) < len(pandas_categorical):
                s = s.cat.set_categories(pandas_categorical[len(cat_cols)])
            cat_cols.append(i)
            cats.append(list(s.cat.categories))
            codes = s.cat.codes.to_numpy().astype(np.float64)
            codes[codes < 0] = np.nan
            arrs.append(codes)
        else:
            arrs.append(s.to_numpy(dtype=np.float64, na_value=np.nan))
    X = np.column_stack(arrs) if arrs else np.zeros((len(data), 0))
    if categorical_feature not in ("auto", None, ""):
        cat_cols = _resolve_cat_indices(categorical_feature, names)
    return X, names, cat_cols, cats


def _resolve_cat_indices(categorical_feature, feature_name) -> List[int]:
    """Sorted column indices of a categorical spec: a list of indices
    or names, or a comma-separated string of them."""
    spec = categorical_feature
    if isinstance(spec, str):
        spec = [c for c in spec.split(",") if c]
    out = []
    for c in spec or []:
        if isinstance(c, str) and not c.strip().lstrip("-").isdigit():
            if c not in feature_name:
                raise LightGBMError(f"Unknown categorical feature {c}")
            out.append(feature_name.index(c))
        else:
            out.append(int(c))
    return sorted(set(out))


class Dataset:
    """Binned training data."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.categorical_feature = categorical_feature
        self.pandas_categorical = None
        self.data = data
        self.label = label
        self.reference = reference
        self.init_score = init_score
        self.weight = weight
        self.group = group
        self.position = position
        self.feature_name = feature_name
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._bins: Optional[torch.Tensor] = None
        # [n, F_used] float32 raw values on the device, kept for linear
        # trees (None: not kept)
        self._raw: Optional[torch.Tensor] = None
        self._bundle_cache: Dict[int, Any] = {}
        self._query_boundaries: Optional[np.ndarray] = None
        # the rows of the parent's raw data a subset holds
        self.used_indices: Optional[np.ndarray] = None
        # a streamed construct's data digest and its ingest stats
        self._data_digest: Optional[str] = None
        self._ingest_stats: Optional[Dict[str, Any]] = None
        self._host_bins_freed = False

    # -- construction ---------------------------------------------------
    def construct(self) -> "Dataset":
        if self._bins is not None:
            return self
        # a valid set constructs its reference inside its own construct:
        # time the outermost one only, so no second counts under one label
        tl = _CONSTRUCT_TL
        if getattr(tl, "depth", 0):
            return self._construct()
        from .utils.timer import timed
        tl.depth = 1
        try:
            with timed("dataset/construct"):
                return self._construct()
        finally:
            tl.depth = 0

    def _construct(self) -> "Dataset":
        cfg = Config.from_params(self.params)
        # a valid set lives where its reference does
        self.device = self.reference.construct().device \
            if self.reference is not None else resolve_device(cfg)
        X = self.data
        if isinstance(X, (str, Path)) and _is_binary_file(str(X)):
            return self._construct_from_binary(str(X))
        # chunk sources always stream; text and parquet paths and Arrow
        # tables stream when ingest_chunk_rows > 0 (data/)
        from .data.sources import coerce_chunk_source
        src = coerce_chunk_source(X, cfg)
        if src is not None:
            return self._construct_streaming(cfg, src)
        if isinstance(X, (str, Path)):
            if cfg.two_round and self.reference is None:
                cat_set = self._resolve_streaming_cats(cfg,
                                                       two_round=True)
                out = None if cat_set is None else _two_round_load(
                    str(X), cfg, cat_set, self.device)
                if out is not None:
                    return self._finish_two_round(cfg, out, cat_set)
            X, y, w, q = _load_text_file(str(X), cfg)
            if self.label is None:
                self.label = y
            if self.weight is None and w is not None:
                self.weight = w
            if self.group is None and q is not None:
                self.group = q
        cat_idx: List[int] = []
        try:
            import pandas as pd
            if isinstance(X, pd.DataFrame):
                ref_pc = None if self.reference is None \
                    else self.reference.pandas_categorical
                X, names, cat_idx, pc = _extract_pandas(
                    X, self.categorical_feature, ref_pc)
                if pc:
                    self.pandas_categorical = pc
                if self.feature_name == "auto":
                    self.feature_name = names
        except ImportError:
            pass
        if type(X).__module__.split(".")[0] == "pyarrow":
            X, names = _extract_arrow(X)
            if self.feature_name == "auto" and names:
                self.feature_name = names
        if hasattr(X, "toarray"):
            X = np.asarray(X.todense(), np.float64)
        if not (isinstance(X, np.ndarray) and X.dtype == np.float32):
            X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[:, None]
        if self.label is None:
            raise LightGBMError("Label should not be None")
        y = np.asarray(self.label, dtype=np.float64).ravel()
        n, F = X.shape
        if len(y) != n:
            raise LightGBMError(
                f"Length of label ({len(y)}) != number of rows ({n})")
        self._n, self._F_total = n, F
        if self.reference is not None:
            # the reference's mappers, so the bins line up with its
            # (LoadFromFileAlignWithOtherDataset)
            ref = self.reference
            if ref.num_total_features() != F:
                raise LightGBMError(
                    f"The number of features in data ({F}) is not the "
                    f"same as it was in the reference ({ref._F_total})")
            self.mappers = ref.mappers
            self._used_features = ref._used_features
            self._full_mappers = ref._full_mappers
            self._feature_names = list(ref._feature_names)
            self._cat_idx = set(ref._cat_idx)
        else:
            names = self.feature_name
            if not isinstance(names, list):
                names = [f"Column_{i}" for i in range(F)]
            self._feature_names = list(names)
            # the constructor's spec first, then the params'
            for spec in (self.categorical_feature, cfg.categorical_feature):
                if cat_idx:
                    break
                if spec not in ("auto", None, "", []):
                    cat_idx = _resolve_cat_indices(spec,
                                                   self._feature_names)
            self._cat_idx = set(cat_idx)
            self._find_mappers(cfg, X, self._cat_idx)
        self._bins = bin_matrix(X, self._used_features, self.mappers,
                                device=self.device)
        self._F = len(self.mappers)
        # linear trees fit on the raw values of the used features
        # (LightGBM's raw_data_); a valid set keeps them when its
        # reference does, so a linear model can score it
        self._raw = None
        if cfg.linear_tree or (self.reference is not None
                               and self.reference._raw is not None):
            self._raw = torch.empty((n, len(self._used_features)),
                                    dtype=torch.float32, device=self.device)
            for i, j in enumerate(self._used_features):
                self._raw[:, i] = torch.from_numpy(np.ascontiguousarray(
                    X[:, j], np.float32)).to(self.device)
        self.label = y
        return self._install_metadata()

    def _install_metadata(self) -> "Dataset":
        """The tail of a construct: weights, init scores and groups
        normalised and checked against the rows."""
        n = self._n
        self.weight = None if self.weight is None else \
            np.asarray(self.weight, np.float64).ravel()
        self.set_init_score(self.init_score)
        if self.group is not None:
            self.set_group(self.group)
            if self._query_boundaries[-1] != n:
                raise LightGBMError("Sum of group sizes != number of rows")
        if self.free_raw_data:
            self.data = None
        return self

    # -- binary files (the JAX package's save_binary layout) -------------
    def save_binary(self, filename) -> "Dataset":
        """Write the binned matrix, the mappers and the metadata as the
        JAX package's npz container (magic ``lightgbm_tpu.dataset.v1``),
        so either package loads it. The bins come to the host for the
        write. An EFB plan is not stored: a load recomputes it."""
        self.construct()
        meta = {
            "magic": _BIN_MAGIC,
            "mappers": [m.to_dict() for m in self.mappers],
            "full_mappers": [m.to_dict() if m is not None else None
                             for m in self._full_mappers],
            "feature_names": self._feature_names,
            "F_total": int(self._F_total),
            "cat_idx": sorted(int(c) for c in self._cat_idx),
        }
        arrays = {
            "bins": self._bins.cpu().numpy(),
            "used_features": np.asarray(self._used_features),
            "meta_json": np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8),
        }
        if self.label is not None:
            arrays["label"] = np.asarray(self.label, np.float64)
        if self.weight is not None:
            arrays["weight"] = np.asarray(self.weight, np.float64)
        if self._query_boundaries is not None:
            arrays["query_boundaries"] = self._query_boundaries
        if self.init_score is not None:
            arrays["init_score"] = np.asarray(self.init_score, np.float64)
        with open(filename, "wb") as f:
            np.savez(f, **arrays)
        return self

    def _construct_from_binary(self, path: str) -> "Dataset":
        """A Dataset from a binary file of either package: its bins go
        straight to the device; metadata given to the constructor wins
        over the stored copies. A valid set must carry its reference's
        mappers."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            if meta.get("magic") != _BIN_MAGIC:
                raise LightGBMError(f"{path} is not a lightgbm_tpu "
                                    "binary dataset")
            self._bins = torch.from_numpy(z["bins"]).to(self.device)
            self._used_features = z["used_features"].astype(np.int32)
            if "label" in z.files and self.label is None:
                self.label = z["label"]
            if "weight" in z.files and self.weight is None:
                self.weight = z["weight"]
            if "query_boundaries" in z.files:
                self._query_boundaries = z["query_boundaries"]
            if "init_score" in z.files and self.init_score is None:
                self.init_score = z["init_score"]
        self.mappers = [BinMapper.from_dict(d) for d in meta["mappers"]]
        self._feature_names = meta["feature_names"]
        self._F_total = meta["F_total"]
        self._cat_idx = set(meta["cat_idx"])
        self._full_mappers = [None if d is None else BinMapper.from_dict(d)
                              for d in meta["full_mappers"]]
        self._n = self._bins.shape[0]
        self._F = len(self.mappers)
        # a binary file holds no raw values, in either package
        self._raw = None
        if self.reference is not None:
            ref = self.reference.construct()
            if [m.to_dict() for m in ref.mappers] != \
                    [m.to_dict() for m in self.mappers]:
                raise LightGBMError(
                    f"Binary dataset {path} was binned differently from "
                    "its reference dataset; rebuild it from text against "
                    "the same training data")
        if self.label is None:
            raise LightGBMError("Label should not be None")
        self.label = np.asarray(self.label, np.float64).ravel()
        if len(self.label) != self._n:
            raise LightGBMError(
                f"Length of label ({len(self.label)}) != number of rows "
                f"({self._n})")
        return self._install_metadata()

    # -- streaming constructs (data/) -------------------------------------
    def _resolve_streaming_cats(self, cfg: Config, names=None,
                                two_round: bool = False) -> Optional[set]:
        """Categorical features of a streamed construct: integer indices
        always; names through the source's column ``names`` (a CSV
        header, an Arrow schema) when it has any. The
        ``categorical_feature`` argument wins, the params' spec is the
        fallback, as in the eager construct. A ``two_round`` text load
        takes the union of both specs and gives None for a name (the
        eager loader resolves it against the parsed header), as the
        JAX package does."""
        cat_set = set()
        for spec in (self.categorical_feature, cfg.categorical_feature):
            if cat_set and not two_round:
                break
            if spec in ("auto", "", None):
                continue
            if isinstance(spec, str):
                spec = [c for c in spec.split(",") if c]
            for c in spec or []:
                try:
                    cat_set.add(int(c))
                    continue
                except (TypeError, ValueError):
                    pass
                if two_round:
                    return None
                if names and str(c) in names:
                    cat_set.add(names.index(str(c)))
                else:
                    raise LightGBMError(
                        f"categorical feature {c!r} cannot be resolved "
                        "for a chunked source without column names; "
                        "pass integer indices (or a header/Arrow "
                        "schema)")
        return cat_set

    def _construct_streaming(self, cfg: Config, src) -> "Dataset":
        """The two-pass construct of a chunk source (``data/ingest.py``):
        a sample for the mappers, then chunk by chunk binned on the
        device. The float matrix never exists; peak host memory scales
        with ``ingest_chunk_rows`` times the features, not the rows."""
        from .data.ingest import dataset_digest, ingest_dataset
        cat_set = self._resolve_streaming_cats(cfg, src.feature_names())
        ref = None if self.reference is None \
            else self.reference.construct()
        # linear trees fit on raw values: pass 2 keeps the used columns
        # on the device; a valid set keeps them when its reference does
        keep_raw = bool(cfg.linear_tree) or (
            ref is not None and ref._raw is not None)
        res = ingest_dataset(src, cfg, cat_set, reference=ref,
                             keep_raw=keep_raw, device=self.device)
        y = res.label
        if self.label is not None:
            y = np.asarray(self.label, np.float64).ravel()
        if y is None:
            raise LightGBMError("Label should not be None")
        if len(y) != res.n:
            raise LightGBMError(
                f"Length of label ({len(y)}) != number of rows "
                f"({res.n})")
        if self.weight is None and res.weight is not None:
            self.weight = res.weight
        # a streamed text path's companion files, as the eager loader
        # reads them
        path = getattr(src, "path", None)
        if path is not None:
            if self.weight is None and os.path.exists(path + ".weight"):
                self.weight = np.loadtxt(path + ".weight")
            if self.group is None and os.path.exists(path + ".query"):
                self.group = np.loadtxt(path + ".query").astype(np.int64)
        self._n, self._F_total = res.n, res.F
        fn = self.feature_name
        names = src.feature_names()
        if ref is not None:
            self._feature_names = list(ref._feature_names)
            self._cat_idx = set(ref._cat_idx)
        else:
            if isinstance(fn, list) and len(fn) == res.F:
                self._feature_names = list(fn)
            elif names and len(names) == res.F:
                self._feature_names = [str(c) for c in names]
            else:
                self._feature_names = [f"Column_{i}"
                                       for i in range(res.F)]
            self._cat_idx = set(cat_set)
        self.mappers = res.mappers
        self._used_features = res.used
        self._full_mappers = res.full_mappers
        self._bins = res.bins
        self._F = len(res.mappers)
        self._raw = res.raw
        # the digest accumulated over the source's labels, unless a
        # label argument replaced them
        if self.label is not None or res.digest is None:
            self._data_digest = dataset_digest(y, res.bins[:64].cpu()
                                               .numpy())
        else:
            self._data_digest = res.digest
        self._ingest_stats = res.stats
        self.label = y
        return self._install_metadata()

    def _finish_two_round(self, cfg: Config, out, cat_set) -> "Dataset":
        """Install a two-round load's device bins (the tail of
        construct without a float matrix)."""
        (bins, mappers, used, full_mappers, n, F, y, w, q) = out
        if self.label is not None:
            y = np.asarray(self.label, np.float64).ravel()
        if self.weight is None and w is not None:
            self.weight = w
        if self.group is None and q is not None:
            self.group = q
        if len(y) != n:
            raise LightGBMError(
                f"Length of label ({len(y)}) != number of rows ({n})")
        if cfg.linear_tree:
            raise LightGBMError(
                "two_round loading cannot retain raw data for "
                "linear_tree (the reference's two-pass loader has the "
                "same restriction on raw-data consumers)")
        self._n, self._F_total = n, F
        fn = self.feature_name
        self._feature_names = list(fn) if isinstance(fn, list) \
            and len(fn) == F else [f"Column_{i}" for i in range(F)]
        self._cat_idx = set(cat_set)
        self.mappers = mappers
        self._used_features = used
        self._full_mappers = full_mappers
        self._bins = bins
        self._F = len(mappers)
        self._raw = None
        self.label = y
        return self._install_metadata()

    # -- streaming push ingest (LGBM_DatasetInitStreaming / PushRows /
    # MarkFinished): rows and their metadata arrive in batches, in any
    # order, into a host staging matrix; construct runs once, at
    # mark_finished ------------------------------------------------------
    @classmethod
    def init_streaming(cls, num_rows: int, num_features: int,
                       **dataset_kwargs) -> "Dataset":
        ds = cls(data=np.zeros((0, num_features)), **dataset_kwargs)
        ds.data = np.full((num_rows, num_features), np.nan, np.float64)
        ds._stream_label = np.zeros(num_rows, np.float64)
        ds._stream_weight = None
        ds._stream_filled = np.zeros(num_rows, bool)
        ds._stream_total = num_rows
        return ds

    def push_rows(self, mat, start_row: int = None, label=None,
                  weight=None) -> "Dataset":
        """Append (or place, with ``start_row``) a batch of raw rows,
        with their labels and weights when given."""
        if getattr(self, "_stream_filled", None) is None:
            raise LightGBMError(
                "push_rows requires a Dataset.init_streaming dataset")
        mat = np.atleast_2d(np.asarray(mat, np.float64))
        if start_row is None:
            filled = np.flatnonzero(~self._stream_filled)
            start_row = int(filled[0]) if len(filled) else \
                self._stream_total
        end = start_row + mat.shape[0]
        if end > self._stream_total:
            raise LightGBMError("push_rows beyond the declared num_rows")
        self.data[start_row:end] = mat
        self._stream_filled[start_row:end] = True
        if label is not None:
            self._stream_label[start_row:end] = np.asarray(label).ravel()
        if weight is not None:
            if self._stream_weight is None:
                self._stream_weight = np.ones(self._stream_total,
                                              np.float64)
            self._stream_weight[start_row:end] = \
                np.asarray(weight).ravel()
        return self

    def mark_finished(self) -> "Dataset":
        """Every row pushed: bin and construct."""
        if getattr(self, "_stream_filled", None) is None:
            raise LightGBMError(
                "mark_finished requires a Dataset.init_streaming dataset")
        if not self._stream_filled.all():
            missing = int((~self._stream_filled).sum())
            raise LightGBMError(
                f"streaming dataset has {missing} unpushed rows")
        if self.label is None:
            self.label = self._stream_label
        if self.weight is None and self._stream_weight is not None:
            self.weight = self._stream_weight
        self._stream_filled = None
        return self.construct()

    def _find_mappers(self, cfg: Config, X: np.ndarray,
                      cat_idx: set) -> None:
        n, F = X.shape
        sample_cnt = min(cfg.bin_construct_sample_cnt, n)
        if sample_cnt < n:
            rng = np.random.RandomState(cfg.data_random_seed)
            rows = rng.choice(n, size=sample_cnt, replace=False)
        else:
            rows = slice(None)
        full = _find_chunk_mappers(X, cfg, cat_idx, rows=rows)
        self._used_features, self.mappers = used_mappers(full)
        self._full_mappers = full

    # -- accessors ------------------------------------------------------
    def device_bins(self) -> torch.Tensor:
        """``[n, F]`` row-major bin tensor on the device (any bundled
        matrix of this Dataset waits on the host meanwhile)."""
        self.construct()
        if self._bins.device != self.device:
            self._park_bundles()
            self._bins = self._bins.to(self.device)
        return self._bins

    def _park_bundles(self) -> None:
        for cap, info in self._bundle_cache.items():
            if info is not None and info.bins_bundled.device.type != "cpu":
                self._bundle_cache[cap] = info._replace(
                    bins_bundled=info.bins_bundled.cpu())

    def bundles(self, cfg: Config):
        """The exclusive feature bundling of this Dataset
        (``ops/bundling.py`` ``BundleInfo``, its bundled ``[n, G]``
        matrix on the device), or None when ``enable_bundle`` is off or
        bundling would not reduce the column count. Built once per bin
        matrix and ``max_cat_to_onehot``. While the bundled matrix is on
        the device, the ``[n, F]`` one waits on the host."""
        self.construct()
        if not cfg.enable_bundle:
            return None
        cap = cfg.max_cat_to_onehot
        if cap not in self._bundle_cache:
            from .ops.bundling import build_bundles
            self._bundle_cache[cap] = build_bundles(
                self.device_bins(), self.mappers, max_cat_onehot=cap)
        info = self._bundle_cache[cap]
        if info is None:
            return None
        if info.bins_bundled.device != self.device:
            self._park_bundles()
            info = self._bundle_cache[cap] = info._replace(
                bins_bundled=info.bins_bundled.to(self.device))
        self._bins = self._bins.cpu()
        return info

    def raw_numeric(self) -> Optional[np.ndarray]:
        """``[n, F_used]`` float32 raw values (NaN kept), a host copy of
        :meth:`device_raw`; None when the Dataset keeps none (it keeps
        them under ``linear_tree``, or when its reference does)."""
        self.construct()
        return None if self._raw is None else self._raw.cpu().numpy()

    def device_raw(self) -> torch.Tensor:
        """``[n, F_used]`` float32 raw values on the Dataset's device
        (linear trees)."""
        self.construct()
        if self._raw is None:
            raise LightGBMError(
                "linear tree evaluation needs raw data; construct the "
                "Dataset with the linear_tree parameter")
        return self._raw

    def num_data(self) -> int:
        self.construct()
        return self._n

    def num_total_features(self) -> int:
        self.construct()
        return self._F_total

    def num_total_bins(self) -> int:
        self.construct()
        return max((m.num_bins for m in self.mappers), default=2)

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_init_score(self):
        """The user's initial raw scores: ``[n]``, or ``[K * n]``
        class-major for K trees per iteration (None: none)."""
        return self.init_score

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = None if init_score is None else \
            np.asarray(init_score, np.float64)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None,
                     position=None) -> "Dataset":
        """A valid set binned with this Dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, position=position)

    def get_group(self) -> Optional[np.ndarray]:
        """Query sizes, or None without groups."""
        if self._query_boundaries is None:
            return None
        return np.diff(self._query_boundaries)

    def set_group(self, group) -> "Dataset":
        g = np.asarray(group, np.int64).ravel()
        self._query_boundaries = np.concatenate(
            [[0], np.cumsum(g)]).astype(np.int64)
        return self

    def query_boundaries(self) -> Optional[np.ndarray]:
        """int64 ``[nq + 1]`` row offsets of the queries (None without
        groups)."""
        self.construct()
        return self._query_boundaries

    def get_position(self):
        """Per-row result-list positions for position-debiased learning
        to rank (None: no position bias)."""
        return self.position

    def set_position(self, position) -> "Dataset":
        self.position = None if position is None else \
            np.asarray(position).ravel()
        return self

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._feature_names)

    def used_feature_indices(self) -> np.ndarray:
        self.construct()
        return self._used_features

    def inner_feature_index(self, real_idx) -> np.ndarray:
        """Positions among the used features of real feature indices (-1:
        not used)."""
        self.construct()
        lut = np.full((self._F_total,), -1, np.int32)
        lut[self._used_features] = np.arange(len(self._used_features),
                                             dtype=np.int32)
        return lut[np.asarray(real_idx, np.int64)]

    def feat_num_bins(self) -> np.ndarray:
        self.construct()
        return np.asarray([m.num_bins for m in self.mappers], np.int32)

    def feat_nan_bin(self) -> np.ndarray:
        """The missing bin per feature (-1: none): rows in it follow the
        learned default direction. NaN features keep it as the last bin,
        zero_as_missing features use the zero bin."""
        self.construct()
        nb = []
        for m in self.mappers:
            if m.bin_type != BinType.NUMERICAL:
                nb.append(-1)
            elif m.missing_type == MissingType.NAN:
                nb.append(m.num_bins - 1)
            elif m.missing_type == MissingType.ZERO:
                nb.append(m.default_bin)
            else:
                nb.append(-1)
        return np.asarray(nb, np.int32)

    def feat_is_cat(self) -> Optional[np.ndarray]:
        """``[F]`` bool categorical features, or None when there are
        none."""
        self.construct()
        arr = np.asarray([m.bin_type == BinType.CATEGORICAL
                          for m in self.mappers], bool)
        return arr if arr.any() else None

    def monotone_array(self, cfg: Config) -> Optional[np.ndarray]:
        """``[F]`` int8 monotone signs of the used features (None
        without constraints)."""
        mc = cfg.monotone_constraints
        if not mc:
            return None
        self.construct()
        full = np.zeros((self._F_total,), np.int8)
        full[:len(mc)] = mc
        return full[self._used_features]

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if self._bins is not None:
            raise LightGBMError("Cannot set categorical feature after the "
                                "Dataset is constructed")
        self.categorical_feature = categorical_feature
        return self

    def feature_infos(self) -> List[str]:
        self.construct()
        out = []
        lut = {int(j): m for j, m in zip(self._used_features, self.mappers)}
        for j in range(self._F_total):
            m = lut.get(j)
            if m is None:
                out.append("none")
            elif m.bin_type == BinType.CATEGORICAL:
                out.append(":".join(str(int(c)) for c in m.bin_to_cat))
            else:
                out.append(f"[{m.min_value:g}:{m.max_value:g}]")
        return out

    # -- the rest of the JAX package's Dataset surface --------------------
    def num_features(self) -> int:
        """The number of used (non-trivial) features."""
        self.construct()
        return self._F

    def set_label(self, label) -> "Dataset":
        self.label = np.asarray(label, np.float64).ravel()
        # a streamed construct's digest described the old labels
        self._data_digest = None
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = None if weight is None else \
            np.asarray(weight, np.float64).ravel()
        return self

    _FIELD_GETTERS = {"label": "get_label", "weight": "get_weight",
                      "init_score": "get_init_score",
                      "position": "get_position", "group": "get_group"}

    def get_field(self, field_name: str):
        getter = self._FIELD_GETTERS.get(field_name)
        if getter is None:
            raise LightGBMError(f"Unknown field {field_name}")
        return getattr(self, getter)()

    def set_field(self, field_name: str, data) -> "Dataset":
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "init_score": self.set_init_score,
                  "position": self.set_position,
                  "group": self.set_group}.get(field_name)
        if setter is None:
            raise LightGBMError(f"Unknown field {field_name}")
        return setter(data)

    def get_data(self):
        """The raw data this Dataset was built from (a subset's rows of
        it; None once freed by ``free_raw_data``)."""
        if self.data is not None and self.used_indices is not None:
            idx = np.asarray(self.used_indices)
            if hasattr(self.data, "iloc"):
                return self.data.iloc[idx]
            return np.asarray(self.data)[idx]
        return self.data

    def get_ref_chain(self, ref_limit: int = 100):
        """The set of Datasets along the reference chain."""
        chain = set()
        node, hops = self, 0
        while node is not None and hops < ref_limit:
            chain.add(node)
            node = node.reference
            hops += 1
        return chain

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if self._bins is not None:
            raise LightGBMError(
                "Cannot set reference after the Dataset is constructed")
        self.reference = reference
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        if feature_name == "auto":
            return self
        if self._bins is not None and feature_name is not None:
            if len(feature_name) != self._F_total:
                raise LightGBMError(
                    f"Expected {self._F_total} feature names, got "
                    f"{len(feature_name)}")
            self._feature_names = [str(f) for f in feature_name]
        else:
            self.feature_name = feature_name
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` of this Dataset, binned with its
        mappers (the rows gathered on the device)."""
        from .engine import _subset_dataset
        return _subset_dataset(self, np.asarray(used_indices, np.int64))

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append another constructed Dataset's features (its bins beside
        this one's on the device; u16 when either is)."""
        self.construct()
        other.construct()
        if other._n != self._n:
            raise LightGBMError(
                "Cannot add features from a Dataset with a different "
                "number of rows")
        a, b = self.device_bins(), other.device_bins()
        if a.dtype != b.dtype:
            a, b = a.to(torch.uint16), b.to(torch.uint16)
        self._bins = torch.cat([a, b], dim=1)
        self._bundle_cache = {}
        self.mappers = list(self.mappers) + list(other.mappers)
        self._full_mappers = list(self._full_mappers) \
            + list(other._full_mappers)
        self._used_features = np.concatenate(
            [self._used_features,
             other._used_features + self._F_total]).astype(np.int32)
        self._feature_names = list(self._feature_names) \
            + list(other._feature_names)
        self._cat_idx = set(self._cat_idx) | {
            c + self._F_total for c in other._cat_idx}
        self._F += other._F
        self._F_total += other._F_total
        self._raw = None if self._raw is None or other._raw is None \
            else torch.cat([self._raw, other._raw.to(self._raw.device)],
                           dim=1)
        return self

    def host_bins(self) -> np.ndarray:
        """The ``[n, F]`` bins copied to the host."""
        self.construct()
        if self._host_bins_freed and self._bins.numel() == 0:
            raise LightGBMError(
                "host_bins(): the host copy of the bins was released by "
                "free_host_bins() (shard_residency=device)")
        return self._bins.cpu().numpy()

    def free_host_bins(self) -> None:
        """Release the host copy of the binned matrix once the bins live
        on the device (``shard_residency=device``,
        ``parallel/placement.py``). The checkpoint's data fingerprint is
        computed first and kept (``_data_digest``). A Dataset on a CUDA
        device keeps its bins there and drops only a copy parked on the
        host (the unbundled bins while the bundled matrix trains); on the
        CPU the host copy is the device copy, and it stays."""
        if self._bins is None:
            return
        if self._data_digest is None and self.label is not None \
                and getattr(self, "_shard", None) is None:
            from .data.ingest import dataset_digest
            self._data_digest = dataset_digest(
                np.asarray(self.label, np.float64),
                self._bins[:64].cpu().numpy())
        from .parallel.placement import host_bytes_gauge
        host_bytes_gauge(0)
        if self._bins.device.type == "cpu" and self.device.type != "cpu":
            self._bins = self._bins[:0]
        self._host_bins_freed = True

    def thresholds_to_bins(self, real_feat: np.ndarray,
                           thresholds: np.ndarray) -> np.ndarray:
        """The bin of each real-valued threshold under the mapper of its
        real feature."""
        inner = self.inner_feature_index(real_feat)
        out = np.zeros(len(thresholds), np.int32)
        for i, (f, t) in enumerate(zip(inner, thresholds)):
            out[i] = int(np.searchsorted(self.mappers[f].upper_bounds, t,
                                         side="left"))
        return out


class Booster:
    """Trains (from a ``train_set``) or loads (``model_file`` /
    ``model_str``) a model; predicts and saves it."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self._blank(params)
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be a Dataset instance")
            cfg = Config.from_params(params)
            train_set.params = {**resolve_params(train_set.params),
                                **resolve_params(params)}
            train_set.construct()
            self._cfg = cfg
            self._device = train_set.device
            from .models.gbdt import GBDTBooster
            from .objectives import create_objective
            objective = create_objective(cfg)
            if objective is not None and hasattr(objective, "set_dataset"):
                objective.set_dataset(train_set)
            self._engine = GBDTBooster(cfg, train_set, objective)
            from .metrics import create_metrics
            self._metrics = create_metrics(cfg)
            self._num_class = cfg.num_class
            self._feature_names = train_set.get_feature_name()
            self._feature_infos = train_set.feature_infos()
            self.pandas_categorical = train_set.pandas_categorical
            self._objective_str = self._objective_repr(cfg)
            self._avg_output = cfg.boosting == "rf"
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            cfg = Config.from_params(params)
            self._device = resolve_device(cfg)
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            from .models.model_io import load_model_string
            load_model_string(self, model_str)
        else:
            raise TypeError(
                "At least one of train_set, model_file or model_str "
                "should be not None")

    def _blank(self, params) -> None:
        """The state of a Booster without trees."""
        self.params = params or {}
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_data_name = "training"
        self._metrics: List = []
        self._valid_names: List[str] = []
        self.pandas_categorical = None
        self._engine = None
        self._trees: List = []
        self._cfg: Optional[Config] = None
        self._num_class = 1
        self._feature_names: List[str] = []
        self._feature_infos: List[str] = []
        self._objective_str = "none"
        self._avg_output = False
        self._attrs: Dict[str, str] = {}
        self.train_set: Optional[Dataset] = None
        self._compiled_forest = None

    @property
    def _models(self) -> List:
        return self._engine.models if self._engine is not None \
            else self._trees

    @staticmethod
    def _objective_repr(cfg: Config) -> str:
        """The model text's objective line, as the JAX package writes
        it."""
        o = cfg.objective
        if o == "binary":
            return f"binary sigmoid:{cfg.sigmoid:g}"
        if o == "multiclass":
            return f"multiclass num_class:{cfg.num_class}"
        if o == "multiclassova":
            return (f"multiclassova num_class:{cfg.num_class} "
                    f"sigmoid:{cfg.sigmoid:g}")
        return o

    # -- training -------------------------------------------------------
    def _preload(self, base: "Booster") -> None:
        """Continue training from ``base``'s trees (init_model). They are
        taken through a model-text round trip, so their thresholds are
        mapped onto this train set's bins (a bin index is only valid for
        the mappers the tree was grown on)."""
        parsed = Booster(model_str=base.model_to_string(),
                         params={"device_type": self._device.type})
        self._engine.preload_models(parsed._trees)
        self._engine.init_iteration = int(self._engine.iter_)

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True means no tree could grow. With
        ``fobj(score, train_set) -> (grad, hess)`` the gradients come
        from the host: the train score ``[n]`` (``[K, n]`` for K > 1)
        copied to numpy once, the returned arrays (``[n]`` or ``[K, n]``
        / ``[K * n]``, class-major) copied to the device once."""
        if train_set is not None:
            raise LightGBMError(
                "Resetting train_set mid-training is not supported yet")
        if fobj is not None:
            K = self._engine.K
            score = self._engine.current_score(0)
            grad, hess = fobj(score[0] if K == 1 else score,
                              self._engine.train_set)
            self._compiled_forest = None
            return self._engine.train_one_iter(np.asarray(grad),
                                               np.asarray(hess))
        self._compiled_forest = None
        return self._engine.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and take their outputs out of
        the train and valid scores on the device."""
        self._engine.rollback_one_iter()
        self._compiled_forest = None
        return self

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score ``data`` (binned with the train set's mappers) after
        every tree, for ``eval_valid``."""
        data.construct()
        self._engine.add_valid(data, name)
        self._valid_names.append(name)
        return self

    # -- evaluation -------------------------------------------------------
    def eval_train(self, feval=None) -> List[Tuple]:
        return self._eval(0, self._train_data_name, feval)

    def eval_valid(self, feval=None) -> List[Tuple]:
        out = []
        for i, name in enumerate(self._valid_names):
            out.extend(self._eval(i + 1, name, feval))
        return out

    def eval(self, data, name: str, feval=None) -> List[Tuple]:
        if data is self.train_set:
            return self._eval(0, self._train_data_name, feval)
        for i, v in enumerate(self._engine.valid_sets):
            if v.dataset is data:
                return self._eval(i + 1, name, feval)
        raise LightGBMError("Data should be added with add_valid first")

    def _eval(self, data_idx: int, name: str, feval=None) -> List[Tuple]:
        """``(data name, metric name, value, higher is better)`` of every
        metric, then of every ``feval(score, dataset)`` (score ``[n]``, or
        ``[K, n]``, as a numpy array)."""
        res = self._engine.eval_metrics(self._metrics, data_idx)
        out = [(name, mname, val, self._metric_higher_better(mname))
               for mname, val in res.items()]
        if feval is not None:
            fevals = feval if isinstance(feval, (list, tuple)) else [feval]
            score = self._engine.current_score(data_idx)
            ds = self._engine.train_set if data_idx == 0 else \
                self._engine.valid_sets[data_idx - 1].dataset
            for f in fevals:
                ret = f(score[0] if self._engine.K == 1 else score, ds)
                for (mn, v, hb) in (ret if isinstance(ret, list)
                                    else [ret]):
                    out.append((name, mn, v, hb))
        return out

    def _metric_higher_better(self, mname: str) -> bool:
        for m in self._metrics:
            if m.name == mname:
                return m.higher_better
        return False

    def num_trees(self) -> int:
        return len(self._models)

    def current_iteration(self) -> int:
        return len(self._models) // self.num_model_per_iteration()

    def num_model_per_iteration(self) -> int:
        """K: trees per iteration (the classes of a multiclass model)."""
        if self._engine is not None:
            return self._engine.K
        return max(1, self._num_class)

    def num_feature(self) -> int:
        if self._engine is not None:
            return self._engine.train_set.num_total_features()
        return len(self._feature_names)

    # -- prediction -----------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, validate_features: bool = False,
                **kwargs) -> np.ndarray:
        from .prediction import predict_any
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        return predict_any(
            self, data, start_iteration, num_iteration, raw_score,
            pred_leaf, pred_contrib,
            pred_early_stop=bool(kwargs.get("pred_early_stop", False)),
            pred_early_stop_freq=int(kwargs.get("pred_early_stop_freq", 10)),
            pred_early_stop_margin=float(kwargs.get(
                "pred_early_stop_margin", 10.0)))

    # -- model io -------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        from .models.model_io import model_to_string
        return model_to_string(self, num_iteration, start_iteration,
                               importance_type)

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        """Write the model text atomically (``utils/atomic.py``): a
        crash mid-save leaves the previous file or none, never a
        truncated one."""
        from .utils.atomic import atomic_write_text
        atomic_write_text(filename, self.model_to_string(
            num_iteration, start_iteration, importance_type))
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        imp = np.zeros((self.num_feature(),), np.float64)
        trees = self._models
        if iteration is not None and iteration > 0:
            trees = trees[:iteration * self.num_model_per_iteration()]
        for t in trees:
            for i in range(t.num_nodes):
                f = int(t.split_feature[i])
                if importance_type == "split":
                    imp[f] += 1
                else:
                    imp[f] += max(0.0, float(t.split_gain[i]))
        if importance_type == "split":
            return imp.astype(np.int64)
        return imp

    def feature_name(self) -> List[str]:
        return list(self._feature_names)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict:
        """The model as the JSON-ready dict of ``GBDT::DumpModel``."""
        from .models.model_io import dump_model_dict
        return dump_model_dict(self, num_iteration, start_iteration,
                               importance_type)

    def trees_to_dataframe(self):
        """Every node of every tree as a row of a pandas DataFrame."""
        from .models.model_io import trees_to_dataframe
        return trees_to_dataframe(self)

    @classmethod
    def model_from_string(cls, model_str: str,
                          params: Optional[Dict[str, Any]] = None
                          ) -> "Booster":
        """A Booster of a model text (``params``: its ``device_type``)."""
        return cls(model_str=model_str, params=params)

    def attr(self, key: str) -> Optional[str]:
        return self._attrs.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """Set (a value) or delete (None) string attributes."""
        for k, v in kwargs.items():
            if v is None:
                self._attrs.pop(k, None)
            else:
                self._attrs[k] = str(v)
        return self

    def lower_bound(self) -> float:
        """The sum over the trees of each one's smallest leaf value."""
        return float(sum(np.min(t.leaf_value[:t.num_leaves])
                         for t in self._models) or 0.0)

    def upper_bound(self) -> float:
        """The sum over the trees of each one's largest leaf value."""
        return float(sum(np.max(t.leaf_value[:t.num_leaves])
                         for t in self._models) or 0.0)

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change ``learning_rate`` and the sampling fractions between
        iterations (they apply from the next one)."""
        self.params = {**self.params, **params}
        eng = self._engine
        if eng is None:
            return self
        if "learning_rate" in params:
            eng._shrinkage = float(params["learning_rate"])
        for k, typ in (("bagging_fraction", float), ("bagging_freq", int),
                       ("feature_fraction", float),
                       ("feature_fraction_bynode", float)):
            if k in params:
                setattr(eng.cfg, k, typ(params[k]))
        if "feature_fraction_bynode" in params:
            eng.grower.cfg = eng.grower.cfg._replace(
                bynode=float(params["feature_fraction_bynode"]))
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        return float(self._models[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        self._models[tree_id].leaf_value[leaf_id] = value
        self._compiled_forest = None
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute the iterations in ``[start, end)`` with numpy's global
        random state (as the JAX package does)."""
        models = self._models
        K = self.num_model_per_iteration()
        n_iters = len(models) // K
        end = n_iters if end_iteration < 0 else min(end_iteration, n_iters)
        idx = np.arange(start_iteration, end)
        np.random.shuffle(idx)
        order = list(range(n_iters))
        order[start_iteration:end] = idx.tolist()
        reordered = []
        for it in order:
            reordered.extend(models[it * K: (it + 1) * K])
        models[:] = reordered
        self._compiled_forest = None
        return self

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """``np.histogram`` of a feature's numerical split thresholds
        (a pandas frame of the non-empty bins with ``xgboost_style``)."""
        if isinstance(feature, str):
            fidx = self.feature_name().index(feature)
        else:
            fidx = int(feature)
        values = []
        for t in self._models:
            for i in range(t.num_nodes):
                if int(t.split_feature[i]) == fidx \
                        and not t.is_categorical_node(i):
                    values.append(float(t.threshold[i]))
        hist, bin_edges = np.histogram(values, bins=bins or "auto")
        if xgboost_style:
            import pandas as pd
            ret = np.column_stack((bin_edges[1:], hist))
            ret = ret[ret[:, 1] > 0]
            return pd.DataFrame(ret, columns=["SplitValue", "Count"])
        return hist, bin_edges

    def refit(self, data, label, decay_rate: float = 0.9, weight=None,
              **kwargs) -> "Booster":
        """A copy of the model whose leaf values are refitted on new data,
        tree by tree in boosting order: ``new = decay_rate * old + (1 -
        decay_rate) * fit``, ``fit = -learning_rate * sum(g) / (sum(h) +
        lambda_l2)`` over each leaf's rows, with the gradients of the
        model's objective at the refitted trees' running score. Leaf
        indices come from the device walk of ``predict(pred_leaf=True)``;
        the gradients are the objective's float32 ones, the leaf sums
        ``index_add_`` in float64 on the device. A non-finite fit is
        handled by ``nonfinite_policy``: ``raise`` raises, ``skip_tree``
        keeps the tree's leaf values, ``clamp`` rewrites the fit (NaN ->
        0, +-Inf -> +-1e30); the last two record ``refit_nan`` fault
        events (``new_booster._refit_fault_log``). ``refit_nan@T``
        (``LIGHTGBM_TPU_FAULT_INJECT``) poisons every seventh row's
        gradient of tree ``T``."""
        if not self._models:
            raise LightGBMError("Cannot refit an empty model")
        if any(t.is_linear and t.leaf_coeff and any(
                len(c) for c in t.leaf_coeff) for t in self._models):
            raise LightGBMError(
                "refit is not yet supported for linear trees (the "
                "reference's is_refit CalculateLinear path)")
        from .objectives import create_objective
        from .ops.predict import predict_leaf_raw
        from .prediction import stack_trees
        new_bst = self.__deepcopy__(None)
        X = np.asarray(data, np.float64)
        y = np.asarray(label, np.float64).ravel()
        w = None if weight is None else np.asarray(weight, np.float64)
        cfg = self._cfg or Config.from_params(self.params)
        objective = create_objective(Config.from_params(
            {**self.params, "objective": (self._objective_str or
                                          "regression").split()[0]}))
        if objective is None:
            raise LightGBMError("Cannot refit without a built-in objective")
        if hasattr(objective, "init_label_weights"):
            objective.init_label_weights(y, w)
        dev = self._device
        trees = new_bst._models
        K = self.num_model_per_iteration()
        n = len(y)
        f64 = torch.float64
        leaves = predict_leaf_raw(stack_trees(trees, dev), torch.as_tensor(
            X, dtype=torch.float32, device=dev))               # [T, n]
        yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
        wt = None if w is None else torch.as_tensor(
            w, dtype=torch.float32, device=dev)
        score = torch.zeros((K, n), dtype=f64, device=dev)
        from .resilience.faults import (NF_CLAMP, FaultPlan,
                                        append_fault_event)
        fault_plan = FaultPlan.from_env()
        policy = cfg.nonfinite_policy
        fault_log: List[Dict] = []
        for ti, tree in enumerate(trees):
            k = ti % K
            s32 = score.float()
            g, h = objective.grad_hess(s32[0] if K == 1 else s32, yt, wt)
            g = g.to(f64).reshape(K, n)[k]
            h = h.to(f64).reshape(K, n)[k]
            if fault_plan.take("refit_nan", ti):
                g = torch.where(torch.arange(n, device=dev) % 7 == 0,
                                float("nan"), g)
            lv = leaves[ti]
            L = tree.num_leaves
            sg = torch.zeros(L, dtype=f64, device=dev).index_add_(0, lv, g)
            sh = torch.zeros(L, dtype=f64, device=dev).index_add_(0, lv, h)
            fit = -sg / (sh + cfg.lambda_l2) * cfg.learning_rate
            if not bool(torch.isfinite(fit).all()):
                if policy == "raise":
                    raise LightGBMError(
                        f"refit: non-finite leaf values fitted for tree "
                        f"{ti} (nonfinite_policy=raise)")
                if policy == "skip_tree":
                    append_fault_event(
                        fault_log, "refit_nan", ti, "skip_tree",
                        f"non-finite refit values for tree {ti}; "
                        "keeping its existing leaf values")
                    score[k] += torch.as_tensor(
                        tree.leaf_value, dtype=f64, device=dev)[lv]
                    continue
                append_fault_event(
                    fault_log, "refit_nan", ti, "clamp",
                    f"non-finite refit values for tree {ti} clamped")
                # only the non-finite values, as the JAX package's
                # refit does: a finite fit beyond 1e30 stays
                fit = torch.nan_to_num(fit, nan=0.0, posinf=NF_CLAMP,
                                       neginf=-NF_CLAMP)
            new = decay_rate * torch.as_tensor(
                tree.leaf_value, dtype=f64, device=dev) \
                + (1.0 - decay_rate) * fit
            tree.leaf_value = new.cpu().numpy()
            score[k] += new[lv]
        new_bst._refit_fault_log = fault_log
        return new_bst

    def free_dataset(self) -> "Booster":
        self.train_set = None
        return self

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        """A copy through the model text, on the same device."""
        return Booster(model_str=self.model_to_string(),
                       params={"device_type": self._device.type})

    def compile(self, num_iteration: Optional[int] = None,
                start_iteration: int = 0, **kwargs):
        """Stack the forest on the device once (``serve/compile.py``):
        the returned :class:`~lightgbm_tpu_torch.serve.compile.CompiledForest`
        predicts in power-of-two row buckets, and later :meth:`predict`
        calls over the same iteration range ride it too. It is bypassed
        when another range is asked for, and dropped when the trees
        change (``update``, ``rollback_one_iter``, ``set_leaf_output``,
        ``shuffle_models``), so ``predict`` never answers from a stale
        forest; the JAX package keeps it and bypasses it only when the
        tree count changes. ``kwargs``: ``min_bucket`` / ``max_batch_rows`` (powers of
        two)."""
        if num_iteration is None:
            num_iteration = self.best_iteration \
                if self.best_iteration > 0 else -1
        from .serve.compile import compile_forest
        cf = compile_forest(self, num_iteration=num_iteration,
                            start_iteration=start_iteration, **kwargs)
        self._compiled_forest = cf
        return cf

    # -- refused: the network ---------------------------------------------

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Join the world of ``machines`` (``LGBM_NetworkInit``; the
        first entry is rank 0's, and ``LIGHTGBM_TPU_RANK`` names this
        process's rank), on this Booster's device type. One machine
        joins nothing."""
        from .parallel.distributed import init_distributed
        if num_machines > 1:
            init_distributed(machines=machines if isinstance(machines, str)
                             else ",".join(machines),
                             device_type=self._device.type)
        return self

    def free_network(self) -> "Booster":
        """Leave the world (``LGBM_NetworkFree``)."""
        from .parallel.distributed import shutdown_distributed
        shutdown_distributed()
        return self
