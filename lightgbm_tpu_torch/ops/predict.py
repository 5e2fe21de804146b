"""Leaf assignment: route rows through trees, as torch ops.

Counterpart of ``lightgbm_tpu/ops/predict.py`` (``predict_leaf_binned``,
``predict_leaf_raw``, ``StackedTrees``). The JAX package sweeps the
nodes in creation order because a TPU serialises per-row gathers; on a
GPU a gather is cheap, so rows walk down the tree one level per step,
all trees of a forest at once, for as many steps as the deepest tree
has levels. The decisions are the JAX package's:

- binned: K2's decision (``ops/partition.py`` ``go_left``,
  ``RangeRules``) on each node's bin column — for a plain matrix, the
  missing bin follows ``default_left`` and any other bin goes left when
  ``bin <= threshold_bin``; over an EFB-bundled matrix, the rule of the
  split feature's bundle column; a categorical node sends a bin left
  when its bit is set in the node's bitset over column values, made
  from its mask of local bins (NaN, negative, rare and unseen
  categories all sit in bin 0 and follow bin 0's membership);
- raw (``NumericalDecision``): missing type ``nan`` — NaN follows
  ``default_left``; ``zero`` — NaN or ``|v| <= 1e-35`` follows it;
  ``none`` — NaN is read as 0.0; then ``v <= threshold``; a categorical
  node (``CategoricalDecision``) sends ``int(v)`` left when its bit is
  set in the node's u32 bitset over category values, and NaN, negative
  values and values past the bitset go right.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..obs.jit_tracker import register_jit
from .partition import RangeRules, go_left

__all__ = ["StackedTrees", "predict_leaf_binned", "predict_leaf_raw",
           "K_ZERO_THRESHOLD", "MISSING_NONE", "MISSING_ZERO",
           "MISSING_NAN"]

K_ZERO_THRESHOLD = 1e-35
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class StackedTrees(NamedTuple):
    """A forest as ``[T, ...]`` tensors; children store ``~leaf`` for
    leaves, and a stump has ``left_child[0] == right_child[0] == -1``."""
    split_feature: torch.Tensor   # [T, N] int64
    threshold: torch.Tensor       # [T, N] f32 real-valued thresholds
    default_left: torch.Tensor    # [T, N] bool
    missing_type: torch.Tensor    # [T, N] int64
    left_child: torch.Tensor      # [T, N] int64
    right_child: torch.Tensor     # [T, N] int64
    leaf_value: torch.Tensor      # [T, L] f32
    depth: int                    # levels of the deepest tree
    is_categorical: torch.Tensor = None   # [T, N] bool (None: no cat)
    cat_bitset: torch.Tensor = None       # [T, N, W] int64 u32 words
    # linear leaves (None: a forest of constant leaves)
    lin_const: torch.Tensor = None        # [T, L] f32
    lin_nfeat: torch.Tensor = None        # [T, L] int64
    lin_feats: torch.Tensor = None        # [T, L, k] int64 real ids
    lin_coef: torch.Tensor = None         # [T, L, k] f32


def _walk(T, n, device, decide, left_child, right_child, depth):
    """``[T, n]`` leaf index of every row in every tree."""
    node = torch.zeros((T, n), dtype=torch.int64, device=device)
    for _ in range(depth):
        inner = node >= 0
        cur = torch.clamp_min(node, 0)
        gl = decide(cur)
        nxt = torch.where(gl, left_child.gather(1, cur),
                          right_child.gather(1, cur))
        node = torch.where(inner, nxt, node)
    return ~node


def predict_leaf_binned(split_feature, threshold_bin, default_left,
                        left_child, right_child, feat_nan_bin,
                        bins: torch.Tensor, depth: int,
                        rules: RangeRules = None, is_cat=None,
                        cat_masks=None, nvalues: int = None) -> torch.Tensor:
    """Leaf per row of ONE tree over a row-major bin tensor (node arrays
    ``[N]`` of original features and thresholds); ``depth`` bounds the
    levels walked. Without ``rules``, ``bins`` is the plain ``[n, F]``
    matrix and ``feat_nan_bin`` its missing bins; with them (a bundled
    ``[n, G]`` matrix), each node's ``(column, lo, hi, nan_pos)``.
    ``is_cat`` ``[N]`` bool marks categorical nodes, whose rows go left
    where ``cat_masks`` ``[N, W]`` (bool, a tensor or array) holds their
    local bin; ``nvalues`` is the count of values a column holds
    (default ``W``)."""
    n = bins.shape[0]
    dev = bins.device
    if rules is None:
        fnan = np.asarray(feat_nan_bin, np.int64)
        rules = RangeRules(np.zeros_like(fnan), fnan)
    col, lo, hi, nan_pos = (
        torch.as_tensor(a, device=dev)[None]
        for a in rules(np.asarray(split_feature, np.int64),
                       np.asarray(threshold_bin, np.int64)))
    dl = torch.as_tensor(default_left, device=dev).to(torch.bool)[None]
    flat = None
    if is_cat is not None and np.any(is_cat):
        masks = torch.as_tensor(cat_masks, device=dev).to(torch.bool)
        bits = rules.bitsets(np.asarray(split_feature, np.int64), masks,
                             nvalues or masks.shape[1])
        nbytes = bits.shape[1]
        flat = bits.reshape(-1).to(torch.int64)
        isc = torch.as_tensor(np.asarray(is_cat, bool), device=dev)[None]
    lc = torch.as_tensor(left_child, device=dev).to(torch.int64)[None]
    rc = torch.as_tensor(right_child, device=dev).to(torch.int64)[None]
    rows = torch.arange(n, device=dev)[None]
    # gathers of uint16 are not implemented on CUDA: read the bits as
    # int16 and mask them back to 0..65535
    wide = bins.dtype == torch.uint16
    src = bins.view(torch.int16) if wide else bins

    def decide(cur):
        v = src[rows, col.gather(1, cur)].to(torch.int64)
        if wide:
            v = v & 0xFFFF
        gl = go_left(v, lo.gather(1, cur), hi.gather(1, cur),
                     nan_pos.gather(1, cur), dl.gather(1, cur))
        if flat is None:
            return gl
        byte = flat[cur * nbytes + torch.clamp(v >> 3, max=nbytes - 1)]
        member = (v < nbytes * 8) & (((byte >> (v & 7)) & 1) != 0)
        return torch.where(isc.gather(1, cur), member, gl)

    return _walk(1, n, dev, decide, lc, rc, depth)[0]


def predict_leaf_raw(trees: StackedTrees, X: torch.Tensor) -> torch.Tensor:
    """``[T, n]`` leaf of every row of raw features ``X`` ``[n, F]``
    (float32) in every tree."""
    T = trees.left_child.shape[0]
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)[None]

    def decide(cur):
        v = X[rows, trees.split_feature.gather(1, cur)]
        mt = trees.missing_type.gather(1, cur)
        is_nan = torch.isnan(v)
        v0 = torch.where(is_nan, torch.zeros_like(v), v)
        is_zero = torch.abs(v0) <= K_ZERO_THRESHOLD
        missing = torch.where(mt == MISSING_NAN, is_nan,
                              torch.where(mt == MISSING_ZERO,
                                          is_zero | is_nan,
                                          torch.zeros_like(is_nan)))
        gl = torch.where(missing, trees.default_left.gather(1, cur),
                         v0 <= trees.threshold.gather(1, cur))
        if trees.is_categorical is None:
            return gl
        # membership of int(v) in the node's bitset
        W = trees.cat_bitset.shape[2]
        iv = torch.where(is_nan | (v < 0), -1.0, v).to(torch.int64)
        word = torch.clamp(iv >> 5, 0, W - 1)
        words = trees.cat_bitset.reshape(T, -1).gather(1, cur * W + word)
        member = (iv >= 0) & ((iv >> 5) < W) & (((words >> (iv & 31)) & 1)
                                                != 0)
        return torch.where(trees.is_categorical.gather(1, cur), member, gl)

    return _walk(T, n, X.device, decide, trees.left_child,
                 trees.right_child, trees.depth)


predict_leaf_raw = register_jit("prediction/forest_leaves", predict_leaf_raw,
                                max_signatures=16)
