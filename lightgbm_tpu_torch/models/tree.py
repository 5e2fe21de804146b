"""Host-side tree model and its LightGBM-compatible text form.

A copy of ``lightgbm_tpu/models/tree.py`` without its JAX pieces: trees
are plain numpy arrays on the host, written and read in the same text
layout, so a model saved by either package loads in the other.
Linear-leaf fields are parsed and written back as they are (so any
model text round-trips), but the port grows and predicts constant leaves
only. Categorical splits are written as LightGBM writes them: a bitset of
raw category values per split (``cat_boundaries`` / ``cat_threshold``,
``threshold`` the split's index among them, ``decision_type`` bit 0).

decision_type byte layout (LightGBM tree.h kCategoricalMask /
kDefaultLeftMask): bit0 = categorical split, bit1 = default_left,
bits2-3 = missing_type (0 = none, 1 = zero, 2 = nan).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.binning import BinMapper, BinType, MissingType

__all__ = ["Tree", "tree_from_arrays"]

_MISSING_CODE = {MissingType.NONE: 0, MissingType.ZERO: 1, MissingType.NAN: 2}
CAT_MASK = 1
DEFAULT_LEFT_MASK = 2


@dataclasses.dataclass
class Tree:
    num_leaves: int
    split_feature: np.ndarray       # [L-1] i32
    split_gain: np.ndarray          # [L-1] f32
    threshold: np.ndarray           # [L-1] f64 (real-valued)
    threshold_bin: np.ndarray       # [L-1] i32 (bin-space; -1 if unknown)
    decision_type: np.ndarray       # [L-1] u8
    left_child: np.ndarray          # [L-1] i32
    right_child: np.ndarray         # [L-1] i32
    leaf_value: np.ndarray          # [L] f64
    leaf_weight: np.ndarray         # [L] f64
    leaf_count: np.ndarray          # [L] i64
    internal_value: np.ndarray      # [L-1] f64
    internal_weight: np.ndarray     # [L-1] f64
    internal_count: np.ndarray      # [L-1] i64
    shrinkage: float = 1.0
    # categorical splits: threshold_bin indexes into cat_threshold via
    # cat_boundaries (bitset spans), like tree.h cat_boundaries_
    num_cat: int = 0
    cat_boundaries: Optional[np.ndarray] = None
    cat_threshold: Optional[np.ndarray] = None
    # linear leaves (tree.h leaf_const_/leaf_coeff_/leaf_features_)
    is_linear: bool = False
    leaf_const: Optional[np.ndarray] = None      # [L] f64
    leaf_features: Optional[list] = None         # per-leaf real feature ids
    leaf_coeff: Optional[list] = None            # per-leaf coefficients

    @property
    def num_nodes(self) -> int:
        return max(self.num_leaves - 1, 0)

    def cat_decision(self, node: int, values: np.ndarray) -> np.ndarray:
        """CategoricalDecision of categorical node ``node`` over raw
        values: ``int(v)`` goes left when its bit is set; NaN, negative
        values and values past the bitset go right."""
        v = np.asarray(values, np.float64)
        ok = np.isfinite(v) & (v >= 0)
        iv = np.where(ok, v, 0).astype(np.int64)
        k = int(self.threshold[node])
        words = np.asarray(self.cat_threshold[self.cat_boundaries[k]:
                                              self.cat_boundaries[k + 1]],
                           np.int64)
        w = iv >> 5
        inside = ok & (w < len(words))
        bit = (words[np.minimum(w, max(len(words) - 1, 0))] >> (iv & 31)) & 1 \
            if len(words) else np.zeros_like(iv)
        return inside & (bit != 0)

    def apply_shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:188), for the constant-leaf trees the
        port grows."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        self.shrinkage *= rate

    # -- text format ------------------------------------------------------
    def to_string(self, index: int) -> str:
        def fmt(arr, f):
            return " ".join(f % x for x in arr)

        L = self.num_leaves
        lines = [f"Tree={index}", f"num_leaves={L}",
                 f"num_cat={self.num_cat}"]
        if L > 1:
            lines += [
                "split_feature=" + fmt(self.split_feature, "%d"),
                "split_gain=" + fmt(self.split_gain, "%g"),
                "threshold=" + fmt(self.threshold, "%.17g"),
                "decision_type=" + fmt(self.decision_type, "%d"),
                "left_child=" + fmt(self.left_child, "%d"),
                "right_child=" + fmt(self.right_child, "%d"),
                "leaf_value=" + fmt(self.leaf_value, "%.17g"),
                "leaf_weight=" + fmt(self.leaf_weight, "%g"),
                "leaf_count=" + fmt(self.leaf_count, "%d"),
                "internal_value=" + fmt(self.internal_value, "%g"),
                "internal_weight=" + fmt(self.internal_weight, "%g"),
                "internal_count=" + fmt(self.internal_count, "%d"),
            ]
            if self.num_cat > 0:
                lines += [
                    "cat_boundaries=" + fmt(self.cat_boundaries, "%d"),
                    "cat_threshold=" + fmt(self.cat_threshold, "%d"),
                ]
        else:
            lines += ["leaf_value=" + fmt(self.leaf_value[:1], "%.17g")]
        lines += [f"is_linear={int(self.is_linear)}"]
        if self.is_linear and self.leaf_const is not None:
            L = self.num_leaves
            nf = [len(self.leaf_features[i]) if self.leaf_features else 0
                  for i in range(L)]
            lines += ["leaf_const=" + fmt(self.leaf_const[:L], "%.17g"),
                      "num_features=" + fmt(nf, "%d")]
            feat_toks, coef_toks = [], []
            for i in range(L):
                if nf[i]:
                    feat_toks += ["%d" % f for f in self.leaf_features[i]]
                    coef_toks += ["%.17g" % c for c in self.leaf_coeff[i]]
            lines += ["leaf_features=" + " ".join(feat_toks),
                      "leaf_coeff=" + " ".join(coef_toks)]
        lines += [f"shrinkage={self.shrinkage:g}"]
        return "\n".join(lines) + "\n\n"

    @classmethod
    def from_lines(cls, kv: Dict[str, str]) -> "Tree":
        L = int(kv["num_leaves"])
        num_cat = int(kv.get("num_cat", "0"))

        def arr(key, dtype, size, default=0):
            if key not in kv or size == 0:
                return np.full(size, default, dtype)
            vals = kv[key].split()
            return np.asarray(vals, dtype=dtype)

        n_nodes = max(L - 1, 0)
        t = cls(
            num_leaves=L,
            split_feature=arr("split_feature", np.int32, n_nodes),
            split_gain=arr("split_gain", np.float64, n_nodes),
            threshold=arr("threshold", np.float64, n_nodes),
            threshold_bin=np.full(n_nodes, -1, np.int32),
            decision_type=arr("decision_type", np.uint8, n_nodes),
            left_child=arr("left_child", np.int32, n_nodes),
            right_child=arr("right_child", np.int32, n_nodes),
            leaf_value=arr("leaf_value", np.float64, L),
            leaf_weight=arr("leaf_weight", np.float64, L),
            leaf_count=arr("leaf_count", np.int64, L),
            internal_value=arr("internal_value", np.float64, n_nodes),
            internal_weight=arr("internal_weight", np.float64, n_nodes),
            internal_count=arr("internal_count", np.int64, n_nodes),
            num_cat=num_cat,
            shrinkage=float(kv.get("shrinkage", "1")),
            is_linear=bool(int(kv.get("is_linear", "0"))),
        )
        # the batched predictor sweeps nodes in index order and relies
        # on internal children having LARGER indices than their parent
        # (ops/predict.py _traverse; Tree::Split numbering guarantees
        # this for every model LightGBM or this package writes) —
        # reject third-party model strings that violate it rather than
        # silently mispredicting
        for i in range(n_nodes):
            for c in (int(t.left_child[i]), int(t.right_child[i])):
                if 0 <= c <= i:
                    raise ValueError(
                        f"model tree node {i} has internal child {c} "
                        "<= its own index; node numbering must be "
                        "topological (parent before child)")
        if num_cat > 0:
            t.cat_boundaries = np.asarray(kv["cat_boundaries"].split(),
                                          np.int64)
            t.cat_threshold = np.asarray(kv["cat_threshold"].split(),
                                         np.uint32)
        if t.is_linear and "leaf_const" in kv:
            t.leaf_const = np.asarray(kv["leaf_const"].split(), np.float64)
            nf = np.asarray(kv.get("num_features", "").split() or [0] * L,
                            np.int64)
            feat_toks = kv.get("leaf_features", "").split()
            coef_toks = kv.get("leaf_coeff", "").split()
            t.leaf_features, t.leaf_coeff = [], []
            pos = 0
            for i in range(L):
                k = int(nf[i]) if i < len(nf) else 0
                t.leaf_features.append(
                    [int(v) for v in feat_toks[pos: pos + k]])
                t.leaf_coeff.append(
                    [float(v) for v in coef_toks[pos: pos + k]])
                pos += k
        return t


def tree_from_arrays(arrays, mappers: Sequence[BinMapper],
                     used_features: Optional[np.ndarray] = None) -> Tree:
    """Host ``TreeArrays`` (ops/grow.py) to a :class:`Tree`, realising
    bin-space thresholds as real values through the BinMappers, and a
    categorical split's mask of bins as a u32 bitset over the raw
    category values of its bins (``bin_to_cat``), as the JAX
    ``tree_from_arrays`` does."""
    L = int(arrays.num_leaves)
    nn = max(L - 1, 0)
    inner_sf = np.asarray(arrays.split_feature)[:nn].astype(np.int32)
    sf = used_features[inner_sf].astype(np.int32) \
        if used_features is not None else inner_sf
    tb = np.asarray(arrays.threshold_bin)[:nn].astype(np.int32)
    dl = np.asarray(arrays.default_left)[:nn]
    is_cat_node = np.asarray(arrays.split_is_cat)[:nn]
    cat_masks = np.asarray(arrays.split_cat_mask)[:nn]
    thr = np.zeros(nn, np.float64)
    dtypes = np.zeros(nn, np.uint8)
    cat_boundaries = [0]
    cat_threshold: List[int] = []
    num_cat = 0
    for i in range(nn):
        # mappers are one-per-used-feature: index by the inner id
        m = mappers[inner_sf[i]]
        code = _MISSING_CODE[m.missing_type] << 2
        if m.bin_type == BinType.CATEGORICAL:
            if is_cat_node[i]:
                member = np.nonzero(cat_masks[i][:len(m.bin_to_cat)])[0]
            else:  # a prefix split "bin <= t"
                member = np.arange(min(int(tb[i]) + 1, len(m.bin_to_cat)))
            cats = np.asarray(m.bin_to_cat, np.int64)[member]
            nwords = (int(cats.max()) // 32 + 1) if len(cats) else 1
            words = np.zeros(nwords, np.uint32)
            for c in cats:
                words[c // 32] |= np.uint32(1) << np.uint32(c % 32)
            thr[i] = float(num_cat)
            code |= CAT_MASK
            cat_threshold.extend(int(x) for x in words)
            cat_boundaries.append(len(cat_threshold))
            num_cat += 1
        else:
            thr[i] = m.bin_upper_bound(int(tb[i]))
            if dl[i]:
                code |= DEFAULT_LEFT_MASK
        dtypes[i] = code
    return Tree(
        num_cat=num_cat,
        cat_boundaries=np.asarray(cat_boundaries, np.int64)
        if num_cat else None,
        cat_threshold=np.asarray(cat_threshold, np.uint32)
        if num_cat else None,
        num_leaves=L,
        split_feature=sf,
        split_gain=np.asarray(arrays.split_gain)[:nn].astype(np.float64),
        threshold=thr,
        threshold_bin=tb,
        decision_type=dtypes,
        left_child=np.asarray(arrays.left_child)[:nn].astype(np.int32),
        right_child=np.asarray(arrays.right_child)[:nn].astype(np.int32),
        leaf_value=np.asarray(arrays.leaf_value)[:L].astype(np.float64),
        leaf_weight=np.asarray(arrays.leaf_weight)[:L].astype(np.float64),
        leaf_count=np.asarray(arrays.leaf_count)[:L].astype(np.int64),
        internal_value=np.asarray(
            arrays.internal_value)[:nn].astype(np.float64),
        internal_weight=np.asarray(
            arrays.internal_weight)[:nn].astype(np.float64),
        internal_count=np.asarray(
            arrays.internal_count)[:nn].astype(np.int64),
    )
