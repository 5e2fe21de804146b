"""Host-side feature binning (quantile sketch).

A copy of ``lightgbm_tpu/ops/binning.py`` (``BinMapper``, ``find_bin``,
``bin_values``), kept byte-for-byte in its arithmetic so that both
packages produce identical bin boundaries from identical samples. The
port does not import the JAX package, so it carries its own copy.

What differs: ``bin_matrix`` maps every column with
``torch.searchsorted`` on the target device instead of the JAX package's
native C++ helper and its per-category loop: numerical columns over
their upper bounds (float64, the same ``side="left"`` rule and NaN
handling as ``BinMapper.value_to_bin``), categorical columns over their
sorted category values (the values cast to int64 after NaN and
infinities become -1; NaN, negative, cut and unseen values all land in
bin 0). The bins are identical (tests/test_torch_train.py and
tests/test_torch_categorical.py hold them against the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["BinMapper", "BinType", "MissingType", "find_bin", "bin_values"]

# Matches LightGBM's kZeroThreshold (bin.h): |v| <= kZero is "zero".
K_ZERO_THRESHOLD = 1e-35
K_SPARSE_THRESHOLD = 0.8


class BinType:
    NUMERICAL = "numerical"
    CATEGORICAL = "categorical"


class MissingType:
    NONE = "none"
    ZERO = "zero"
    NAN = "nan"


@dataclasses.dataclass
class BinMapper:
    """Per-feature value->bin mapping."""

    bin_type: str = BinType.NUMERICAL
    missing_type: str = MissingType.NONE
    num_bins: int = 1
    # numerical: ascending upper bounds, one per bin (last = +inf).
    upper_bounds: Optional[np.ndarray] = None
    # categorical: category value for each bin index.
    bin_to_cat: Optional[np.ndarray] = None
    cat_to_bin: Optional[Dict[int, int]] = None
    default_bin: int = 0       # the bin containing 0.0
    most_freq_bin: int = 0
    sparse_rate: float = 0.0
    min_value: float = 0.0
    max_value: float = 0.0

    @property
    def is_trivial(self) -> bool:
        return self.num_bins <= 1

    # -- mapping ---------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (the ValueToBin analog, bin.h:193).

        Pass-count matters: this maps every cell of the training matrix
        (4228 columns at Allstate width), so NaN handling is gated on
        the mapper's missing_type instead of paying isnan+where passes
        on clean columns, and the searchsorted result is clamped/cast
        in one pass."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BinType.CATEGORICAL:
            out = np.zeros(values.shape, dtype=np.int32)
            iv = np.where(np.isfinite(values), values, -1).astype(np.int64)
            for cat, b in (self.cat_to_bin or {}).items():
                out[iv == cat] = b
            return out
        if self.missing_type == MissingType.NAN:
            nan_mask = np.isnan(values)
            bins = np.searchsorted(self.upper_bounds, values, side="left")
            np.minimum(bins, len(self.upper_bounds) - 1, out=bins)
            bins = np.where(nan_mask, self.num_bins - 1, bins)
            return bins.astype(np.int32)
        # MissingType.NONE/ZERO: NaN cells map to the bin of 0.0 (the
        # where -> searchsorted(0.0) below). A clean column pays one
        # isnan read pass but skips the where copy.
        nan_mask = np.isnan(values)
        if nan_mask.any():
            values = np.where(nan_mask, 0.0, values)
        bins = np.searchsorted(self.upper_bounds, values, side="left")
        np.minimum(bins, len(self.upper_bounds) - 1, out=bins)
        return bins.astype(np.int32)

    def bin_to_value(self, b: int) -> float:
        """Representative value of a bin (used for threshold realization)."""
        if self.bin_type == BinType.CATEGORICAL:
            return float(self.bin_to_cat[b]) if b < len(self.bin_to_cat) else 0.0
        return float(self.upper_bounds[min(b, len(self.upper_bounds) - 1)])

    def bin_upper_bound(self, b: int) -> float:
        """Real-valued split threshold for 'bin <= b'."""
        if b >= len(self.upper_bounds):
            return float("inf")
        return float(self.upper_bounds[b])

    def to_dict(self) -> dict:
        return {
            "bin_type": self.bin_type,
            "missing_type": self.missing_type,
            "num_bins": int(self.num_bins),
            "upper_bounds": None if self.upper_bounds is None
            else [float(x) for x in self.upper_bounds],
            "bin_to_cat": None if self.bin_to_cat is None
            else [int(x) for x in self.bin_to_cat],
            "default_bin": int(self.default_bin),
            "most_freq_bin": int(self.most_freq_bin),
            "sparse_rate": float(self.sparse_rate),
            "min_value": float(self.min_value),
            "max_value": float(self.max_value),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls(
            bin_type=d["bin_type"],
            missing_type=d["missing_type"],
            num_bins=d["num_bins"],
            upper_bounds=None if d.get("upper_bounds") is None
            else np.asarray(d["upper_bounds"], dtype=np.float64),
            bin_to_cat=None if d.get("bin_to_cat") is None
            else np.asarray(d["bin_to_cat"], dtype=np.int64),
            default_bin=d.get("default_bin", 0),
            most_freq_bin=d.get("most_freq_bin", 0),
            sparse_rate=d.get("sparse_rate", 0.0),
            min_value=d.get("min_value", 0.0),
            max_value=d.get("max_value", 0.0),
        )
        if m.bin_to_cat is not None:
            m.cat_to_bin = {int(c): i for i, c in enumerate(m.bin_to_cat)}
        return m


def _greedy_find_bin(distinct: np.ndarray, counts: np.ndarray,
                     num_distinct: int, max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Equal-count greedy bin boundaries over sorted distinct values.

    Semantics follow the reference's GreedyFindBin (bin.cpp:78): when few
    distinct values, one bin per value (merging tiny bins per
    min_data_in_bin); otherwise greedy equal-count packing where any value
    holding >= mean-bin-size data is pinned to its own bin.
    Returns upper bounds; the caller appends/uses +inf as the last bound.
    """
    bounds: List[float] = []
    if num_distinct == 0:
        return bounds
    distinct = distinct[:num_distinct]
    counts = counts[:num_distinct]
    if num_distinct <= max_bin:
        cur = 0
        for i in range(num_distinct - 1):
            cur += counts[i]
            if cur >= min_data_in_bin:
                bounds.append((distinct[i] + distinct[i + 1]) / 2.0)
                cur = 0
        bounds.append(float("inf"))
        return bounds

    max_bin = max(1, max_bin)
    mean_bin_size = total_cnt / max_bin
    # values that alone exceed the mean bin size get private bins
    is_big = counts >= mean_bin_size
    rest_cnt = total_cnt - counts[is_big].sum()
    rest_bins = max_bin - int(is_big.sum())
    if rest_bins > 0:
        mean_bin_size = rest_cnt / rest_bins

    bin_cnt = 0
    cur = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_cnt -= counts[i]
        cur += counts[i]
        # close the current bin if: value is big, bin is full, or the next
        # value is big (so it must start its own bin)
        if (is_big[i] or cur >= mean_bin_size or
                (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            bounds.append((distinct[i] + distinct[i + 1]) / 2.0)
            bin_cnt += 1
            cur = 0
            if bin_cnt >= max_bin - 1:
                break
            if not is_big[i] and rest_bins > bin_cnt:
                # re-balance remaining budget over remaining small values
                remaining_small_bins = rest_bins - (
                    bin_cnt - int(is_big[: i + 1].sum()))
                if remaining_small_bins > 0:
                    mean_bin_size = rest_cnt / remaining_small_bins
    bounds.append(float("inf"))
    return bounds


def _find_bounds_zero_as_one_bin(values: np.ndarray, max_bin: int,
                                 min_data_in_bin: int,
                                 total_sample_cnt: int) -> List[float]:
    """Numerical bounds where zero always occupies its own bin
    (FindBinWithZeroAsOneBin analog, bin.cpp:242)."""
    left = values[values < -K_ZERO_THRESHOLD]
    right = values[values > K_ZERO_THRESHOLD]
    left_cnt, right_cnt = len(left), len(right)
    non_zero = left_cnt + right_cnt
    zero_cnt = max(0, total_sample_cnt - non_zero)

    bounds: List[float] = []
    eff = max(1, non_zero + zero_cnt)
    left_max_bin = 0
    if left_cnt > 0:
        left_max_bin = max(1, int(round((max_bin - 1) * left_cnt / eff)))
        dl, cl = np.unique(left, return_counts=True)
        lb = _greedy_find_bin(dl, cl, len(dl), left_max_bin, left_cnt,
                              min_data_in_bin)
        if lb:
            lb[-1] = -K_ZERO_THRESHOLD
        bounds.extend(lb)
    if right_cnt > 0 or zero_cnt > 0:
        bounds.append(K_ZERO_THRESHOLD)
    if right_cnt > 0:
        right_max_bin = max_bin - 1 - len(bounds) + 1
        right_max_bin = max(1, right_max_bin)
        dr, cr = np.unique(right, return_counts=True)
        rb = _greedy_find_bin(dr, cr, len(dr), right_max_bin, right_cnt,
                              min_data_in_bin)
        bounds.extend(rb)
    if not bounds or bounds[-1] != float("inf"):
        bounds.append(float("inf"))
    # dedupe while preserving order (zero bounds can collide on tiny data)
    out: List[float] = []
    for b in bounds:
        if not out or b > out[-1]:
            out.append(b)
    return out


def find_bin(values: np.ndarray,
             max_bin: int,
             min_data_in_bin: int = 3,
             bin_type: str = BinType.NUMERICAL,
             use_missing: bool = True,
             zero_as_missing: bool = False,
             total_sample_cnt: Optional[int] = None,
             min_data_per_group: int = 100,
             max_cat: int = 0x7FFFFFFF) -> BinMapper:
    """Build a BinMapper for one feature from (a sample of) its values.

    ``values`` may contain NaN. ``total_sample_cnt`` can exceed
    ``len(values)`` when sparse rows were skipped — the difference is
    treated as implicit zeros (matching BinMapper::FindBin, bin.cpp:311).
    """
    values = np.asarray(values, dtype=np.float64).ravel()
    if total_sample_cnt is None:
        total_sample_cnt = len(values)
    nan_mask = np.isnan(values)
    na_cnt = int(nan_mask.sum())
    finite = values[~nan_mask]

    if bin_type == BinType.CATEGORICAL:
        return _find_bin_categorical(finite, max_bin, na_cnt, use_missing,
                                     total_sample_cnt, min_data_in_bin)

    # missing policy (BinMapper::FindBin missing-type selection)
    if not use_missing:
        missing_type = MissingType.NONE
    elif zero_as_missing:
        missing_type = MissingType.ZERO
    elif na_cnt > 0:
        missing_type = MissingType.NAN
    else:
        missing_type = MissingType.NONE

    if missing_type == MissingType.NONE and na_cnt > 0:
        # NaN folded into zero when missing handling disabled
        finite = np.concatenate([finite, np.zeros(na_cnt)])
        na_cnt = 0

    budget = max_bin - 1 if missing_type == MissingType.NAN else max_bin
    budget = max(budget, 1)
    n_total_for_bounds = total_sample_cnt - na_cnt
    bounds = _find_bounds_zero_as_one_bin(
        finite, budget, min_data_in_bin, n_total_for_bounds)
    upper = np.asarray(bounds, dtype=np.float64)
    num_bins = len(upper) + (1 if missing_type == MissingType.NAN else 0)

    m = BinMapper(
        bin_type=BinType.NUMERICAL,
        missing_type=missing_type,
        num_bins=int(num_bins),
        upper_bounds=upper,
        min_value=float(finite.min()) if len(finite) else 0.0,
        max_value=float(finite.max()) if len(finite) else 0.0,
    )
    m.default_bin = int(np.searchsorted(upper, 0.0, side="left"))
    # most_freq_bin from the sample histogram (incl. implicit zeros)
    if len(finite) or total_sample_cnt > 0:
        bin_ids = np.searchsorted(upper, finite, side="left")
        bin_ids = np.minimum(bin_ids, len(upper) - 1)
        cnt = np.bincount(bin_ids, minlength=num_bins).astype(np.int64)
        cnt[m.default_bin] += total_sample_cnt - na_cnt - len(finite)
        if missing_type == MissingType.NAN:
            cnt[num_bins - 1] += na_cnt
        m.most_freq_bin = int(cnt.argmax())
        m.sparse_rate = float(cnt[m.default_bin]) / max(1, total_sample_cnt)
    return m


def _find_bin_categorical(finite: np.ndarray, max_bin: int, na_cnt: int,
                          use_missing: bool, total_sample_cnt: int,
                          min_data_in_bin: int) -> BinMapper:
    iv = finite.astype(np.int64)
    if (iv < 0).any():
        import warnings
        warnings.warn("Met negative categorical value, converted to NaN",
                      stacklevel=3)
        na_cnt += int((iv < 0).sum())
        iv = iv[iv >= 0]
    cats, counts = np.unique(iv, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    cats, counts = cats[order], counts[order]
    # keep categories covering 99% of data, capped at max_bin-1 bins
    # (bin 0 additionally absorbs unseen values)
    cut = int(len(cats))
    if len(cats) > max_bin - 1:
        cut = max_bin - 1
    total = counts.sum()
    if total > 0 and len(cats) > 2:
        cum = np.cumsum(counts)
        cut99 = int(np.searchsorted(cum, 0.99 * total) + 1)
        cut = min(cut, max(cut99, 1))
    cats, counts = cats[:cut], counts[:cut]
    missing_type = MissingType.NAN if (use_missing and na_cnt > 0) \
        else MissingType.NONE
    m = BinMapper(
        bin_type=BinType.CATEGORICAL,
        missing_type=missing_type,
        num_bins=int(len(cats)) if len(cats) else 1,
        bin_to_cat=cats.copy(),
        cat_to_bin={int(c): i for i, c in enumerate(cats)},
        most_freq_bin=0,
    )
    if len(counts):
        m.sparse_rate = 1.0 - counts.sum() / max(1, total_sample_cnt)
    return m


def bin_values(columns: Sequence[np.ndarray], mappers: Sequence[BinMapper],
               dtype=None) -> np.ndarray:
    """Bin a list of feature columns into a dense [n, F] matrix."""
    n = len(columns[0]) if columns else 0
    max_bins = max((m.num_bins for m in mappers), default=2)
    if dtype is None:
        dtype = np.uint8 if max_bins <= 256 else np.uint16
    out = np.zeros((n, len(columns)), dtype=dtype)
    for j, (col, m) in enumerate(zip(columns, mappers)):
        out[:, j] = m.value_to_bin(col).astype(dtype)
    return out


def bin_matrix(X: np.ndarray, col_indices, mappers: Sequence[BinMapper],
               device=None, dtype=None):
    """Bin selected columns of a row-major ``[n, F]`` values matrix into
    a dense row-major ``[n, C]`` bin tensor on ``device``.

    Numerical columns are mapped on the device, one column at a time,
    with ``torch.searchsorted`` in float64 — the rule of
    ``BinMapper.value_to_bin``: ``side="left"``, clamped to the last
    bound, NaN to the last bin for ``MissingType.NAN`` and to the bin of
    0.0 otherwise. Categorical columns by :func:`_categorical_bins`. The
    result is u8 when every mapper has at most 256 bins, else u16
    (``torch.uint16``)."""
    import torch
    col_indices = np.asarray(col_indices, np.int64)
    max_bins = max((m.num_bins for m in mappers), default=2)
    if dtype is None:
        dtype = torch.uint8 if max_bins <= 256 else torch.uint16
    n = X.shape[0]
    out = torch.empty((n, len(mappers)), dtype=dtype, device=device)
    for i, m in enumerate(mappers):
        col = X[:, col_indices[i]]
        v = torch.from_numpy(np.ascontiguousarray(col)).to(
            device=device, dtype=torch.float64)
        if m.bin_type != BinType.NUMERICAL:
            out[:, i] = _categorical_bins(v, m).to(dtype)
            continue
        nan = torch.isnan(v)
        ub = torch.from_numpy(m.upper_bounds).to(device=device,
                                                 dtype=torch.float64)
        if m.missing_type != MissingType.NAN:
            v = torch.where(nan, torch.zeros_like(v), v)
        b = torch.searchsorted(ub, v, side="left")
        b = torch.clamp_max_(b, len(m.upper_bounds) - 1)
        if m.missing_type == MissingType.NAN:
            b = torch.where(nan, torch.full_like(b, m.num_bins - 1), b)
        out[:, i] = b.to(dtype)
    return out


def _categorical_bins(v, m: BinMapper):
    """int64 bins of float64 values ``v`` (a tensor) under categorical
    mapper ``m``: ``value_to_bin``'s rule by one ``searchsorted`` over the
    sorted category values, on ``v``'s device."""
    import torch
    cats = np.asarray(list((m.cat_to_bin or {}).keys()), np.int64)
    bins = np.asarray(list((m.cat_to_bin or {}).values()), np.int64)
    order = np.argsort(cats)
    iv = torch.where(torch.isfinite(v), v, -1.0).to(torch.int64)
    if len(cats) == 0:
        return torch.zeros_like(iv)
    c = torch.as_tensor(cats[order], device=v.device)
    at = torch.clamp_max(torch.searchsorted(c, iv), len(cats) - 1)
    hit = c[at] == iv
    return torch.where(hit, torch.as_tensor(bins[order],
                                            device=v.device)[at], 0)
