"""Leaf assignment: route rows through trees, as torch ops.

Counterpart of ``lightgbm_tpu/ops/predict.py`` (``predict_leaf_binned``,
``predict_leaf_raw``, ``StackedTrees``). The JAX package sweeps the
nodes in creation order because a TPU serialises per-row gathers; on a
GPU a gather is cheap, so rows walk down the tree one level per step,
all trees of a forest at once, for as many steps as the deepest tree
has levels. The decisions are the JAX package's:

- binned: the missing bin follows ``default_left``, any other bin goes
  left when ``bin <= threshold_bin``;
- raw (``NumericalDecision``): missing type ``nan`` — NaN follows
  ``default_left``; ``zero`` — NaN or ``|v| <= 1e-35`` follows it;
  ``none`` — NaN is read as 0.0; then ``v <= threshold``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
                        bins: torch.Tensor, depth: int) -> torch.Tensor:
    """Leaf per row of ONE tree over a row-major ``[n, F]`` bin tensor
    (node arrays ``[N]``); ``depth`` bounds the levels walked."""
    n = bins.shape[0]
    dev = bins.device
    sf = torch.as_tensor(split_feature, device=dev).to(torch.int64)[None]
    tb = torch.as_tensor(threshold_bin, device=dev).to(torch.int64)[None]
    dl = torch.as_tensor(default_left, device=dev).to(torch.bool)[None]
    lc = torch.as_tensor(left_child, device=dev).to(torch.int64)[None]
    rc = torch.as_tensor(right_child, device=dev).to(torch.int64)[None]
    fnan = torch.as_tensor(feat_nan_bin, device=dev).to(torch.int64)
    rows = torch.arange(n, device=dev)[None]
    # gathers of uint16 are not implemented on CUDA: read the bits as
    # int16 and mask them back to 0..65535
    wide = bins.dtype == torch.uint16
    src = bins.view(torch.int16) if wide else bins

    def decide(cur):
        f = sf.gather(1, cur)
        v = src[rows, f].to(torch.int64)
        if wide:
            v = v & 0xFFFF
        nb = fnan[f]
        return torch.where((nb >= 0) & (v == nb), dl.gather(1, cur),
                           v <= tb.gather(1, cur))

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
        return torch.where(missing, trees.default_left.gather(1, cur),
                           v0 <= trees.threshold.gather(1, cur))

    return _walk(T, n, X.device, decide, trees.left_child,
                 trees.right_child, trees.depth)
