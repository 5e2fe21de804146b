"""Batch prediction from raw features.

Counterpart of ``predict_any`` and ``convert_raw_scores`` in
``lightgbm_tpu/prediction.py``, for forests of numerical splits with
constant leaves: the forest is stacked into device tensors, every row
walks every tree (:func:`ops.predict.predict_leaf_raw`) in float32 —
thresholds rounded down to float32 so that a float32 feature keeps its
training-time side, as in the JAX package — and the raw scores are
converted by the objective named in the model (a sigmoid for binary).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .models.tree import Tree
from .ops.predict import StackedTrees, predict_leaf_raw

__all__ = ["predict_any", "stack_trees", "convert_raw_scores"]


def _tree_depth(t: Tree) -> int:
    if t.num_nodes == 0:
        return 1
    depth = np.zeros(t.num_nodes, np.int64)
    out = 1
    for i in range(t.num_nodes):          # parents precede children
        for c in (t.left_child[i], t.right_child[i]):
            if c >= 0:
                depth[c] = depth[i] + 1
            else:
                out = max(out, int(depth[i]) + 1)
    return out


def stack_trees(trees: List[Tree], device) -> StackedTrees:
    """Stack a forest into ``[T, ...]`` device tensors."""
    for t in trees:
        if t.num_cat > 0 or t.is_linear:
            raise NotImplementedError(
                "categorical splits and linear leaves are not in the "
                "port's predictor yet (ROADMAP.md Queue 1 items 13, 16)")
    T = len(trees)
    N = max(1, max((t.num_nodes for t in trees), default=1))
    Lm = max((t.num_leaves for t in trees), default=1)
    sf = np.zeros((T, N), np.int64)
    thr = np.zeros((T, N), np.float64)
    dl = np.zeros((T, N), bool)
    mt = np.zeros((T, N), np.int64)
    lc = np.full((T, N), -1, np.int64)
    rc = np.full((T, N), -1, np.int64)
    lv = np.zeros((T, Lm), np.float64)
    for i, t in enumerate(trees):
        nn = t.num_nodes
        if nn > 0:
            sf[i, :nn] = t.split_feature
            thr[i, :nn] = t.threshold
            dl[i, :nn] = (t.decision_type & 2) != 0
            mt[i, :nn] = (t.decision_type >> 2) & 3
            lc[i, :nn] = t.left_child
            rc[i, :nn] = t.right_child
        lv[i, :t.num_leaves] = t.leaf_value
    # f32-safe thresholds: round DOWN to the nearest f32
    thr32 = thr.astype(np.float32)
    bad = thr32.astype(np.float64) > thr
    thr32[bad] = np.nextafter(thr32[bad], np.float32(-np.inf))

    def dev(a):
        return torch.as_tensor(a, device=device)

    return StackedTrees(
        split_feature=dev(sf), threshold=dev(thr32), default_left=dev(dl),
        missing_type=dev(mt), left_child=dev(lc), right_child=dev(rc),
        leaf_value=dev(lv.astype(np.float32)),
        depth=max((_tree_depth(t) for t in trees), default=1))


def predict_any(booster, data, start_iteration: int = 0,
                num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False) -> np.ndarray:
    from .basic import Dataset, LightGBMError
    if isinstance(data, Dataset):
        raise LightGBMError(
            "Cannot use Dataset instance for prediction, please use raw "
            "data instead")
    X = np.asarray(data, dtype=np.float64)
    if X.ndim == 1:
        X = X[None, :]
    n_feat = booster.num_feature()
    if n_feat and X.shape[1] != n_feat:
        raise LightGBMError(
            f"The number of features in data ({X.shape[1]}) is not the "
            f"same as it was in training data ({n_feat}).")
    trees = booster._models
    total = len(trees)
    if num_iteration is None or num_iteration <= 0:
        num_iteration = total - start_iteration
    num_iteration = min(num_iteration, total - start_iteration)
    sel = trees[start_iteration:start_iteration + num_iteration]
    n = X.shape[0]
    if not sel:
        return np.zeros((n,), np.float64)
    device = booster._device
    stacked = stack_trees(sel, device)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=device)
    leaves = predict_leaf_raw(stacked, Xd)                     # [T, n]
    if pred_leaf:
        return leaves.T.to(torch.int32).cpu().numpy()
    vals = stacked.leaf_value.gather(1, leaves)
    out = vals.sum(dim=0).cpu().numpy().astype(np.float64)
    if not raw_score:
        out = convert_raw_scores(booster._objective_str, out)
    return out


def convert_raw_scores(objective_str: Optional[str],
                       out: np.ndarray) -> np.ndarray:
    """Objective-specific output transform, driven by the objective
    string of the model header."""
    obj = (objective_str or "none").split()
    name = obj[0] if obj else "none"
    kv = dict(t.split(":", 1) for t in obj[1:] if ":" in t)
    flags = {t for t in obj[1:] if ":" not in t}
    if name == "binary":
        sig = float(kv.get("sigmoid", 1.0))
        return 1.0 / (1.0 + np.exp(-sig * out))
    if name in ("regression", "regression_l2") and "sqrt" in flags:
        return np.sign(out) * out * out
    if name in ("regression", "regression_l2", "none", "custom"):
        return out
    raise NotImplementedError(
        f"output transform of objective {name!r} is not in the port yet "
        "(ROADMAP.md Queue 1 items 10, 11)")
