"""SHAP feature contributions (TreeSHAP), for ``pred_contrib``.

The row-vectorized walk of ``lightgbm_tpu/shap.py`` (the reference's
PredictContrib and the TreeSHAP recursion of LightGBM's tree.cpp): only
the binary ``one_fraction`` entries of the decision path depend on the
row; the cover ratios (``zero_fraction``) and the path's features are
the node's. So the walk visits each node once and carries the path
state as ``[n, depth]`` float64 tensors, doing the extend and unwind
algebra on whole row batches; at a leaf the unwound sums of every path
element are taken together. The rows' tensors live on the booster's
device; each operation is one IEEE float64 operation per element, in
the JAX package's order, so the contributions are its numbers. The
decisions read the port's :class:`models.tree.Tree` (the categorical
bitsets, the missing type in ``decision_type``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["predict_contrib"]

F64 = torch.float64


class _VecPath:
    """Decision-path state for a batch of rows at one recursion depth:
    ``feat`` and ``zero`` per element (host, shared by all rows),
    ``one`` and ``pw`` ``[n, cap]`` per row."""

    __slots__ = ("feat", "zero", "one", "pw")

    def __init__(self, n: int, cap: int, device):
        self.feat = np.full(cap, -1, np.int64)
        self.zero = np.zeros(cap, np.float64)
        self.one = torch.zeros((n, cap), dtype=F64, device=device)
        self.pw = torch.zeros((n, cap), dtype=F64, device=device)

    def clone(self) -> "_VecPath":
        out = _VecPath.__new__(_VecPath)
        out.feat = self.feat.copy()
        out.zero = self.zero.copy()
        out.one = self.one.clone()
        out.pw = self.pw.clone()
        return out


def _vec_extend(path: _VecPath, d: int, zero: float, one: torch.Tensor,
                feat: int) -> None:
    path.feat[d] = feat
    path.zero[d] = zero
    path.one[:, d] = one
    path.pw[:, d] = 1.0 if d == 0 else 0.0
    for i in range(d - 1, -1, -1):
        path.pw[:, i + 1] += one * path.pw[:, i] * (i + 1) / (d + 1)
        path.pw[:, i] *= zero * (d - i) / (d + 1)


def _vec_unwind(path: _VecPath, d: int, idx: int) -> None:
    one = path.one[:, idx]
    zero = float(path.zero[idx])
    nz = one != 0
    next_one = path.pw[:, d].clone()
    for i in range(d - 1, -1, -1):
        tmp = path.pw[:, i].clone()
        pw_nz = next_one * (d + 1) / ((i + 1) * one)
        pw_z = tmp * (d + 1) / (zero * (d - i)) if zero * (d - i) != 0 \
            else torch.zeros_like(tmp)
        path.pw[:, i] = torch.where(nz, pw_nz, pw_z)
        next_one = torch.where(
            nz, tmp - path.pw[:, i] * zero * (d - i) / (d + 1), next_one)
    path.feat[idx:d] = path.feat[idx + 1:d + 1]
    path.zero[idx:d] = path.zero[idx + 1:d + 1]
    path.one[:, idx:d] = path.one[:, idx + 1:d + 1].clone()


def _vec_unwound_sums(path: _VecPath, d: int) -> torch.Tensor:
    """``[n, d]``: the unwound path sum of every element ``1 .. d`` (the
    JAX package's ``_vec_unwound_sum`` of each, the same operations per
    element), the walk over the path taken once for all of them."""
    one = path.one[:, 1:d + 1]
    zero = torch.as_tensor(path.zero[1:d + 1], device=one.device)
    nz = one != 0
    total = torch.zeros_like(one)
    next_one = path.pw[:, d:d + 1].expand(-1, d)
    for i in range(d - 1, -1, -1):
        tmp = torch.where(nz, next_one * (d + 1) / ((i + 1) * one), 0.0)
        total = total + tmp
        next_one = torch.where(
            nz, path.pw[:, i:i + 1] - tmp * zero * (d - i) / (d + 1),
            next_one)
        zd = zero * (d - i)
        part = path.pw[:, i:i + 1] / (zd / (d + 1))
        total = total + torch.where(nz | (zd == 0), 0.0, part)
    return total


def _vec_tree_shap(tree, X: torch.Tensor, phi: torch.Tensor, node: int,
                   d: int, parent: _VecPath, pzero: float,
                   pone: torch.Tensor, pfeat: int) -> None:
    """Visit ``node`` carrying all rows at once; rows whose
    one_fraction chain has hit zero contribute nothing downstream but
    stay in the batch for shape stability."""
    path = parent.clone()
    _vec_extend(path, d, pzero, pone, pfeat)

    if node < 0:  # leaf
        leaf_v = float(tree.leaf_value[~node])
        if d > 0:
            # the path's features are distinct (a repeated one was
            # unwound), so each column takes one add
            w = _vec_unwound_sums(path, d)
            zero = torch.as_tensor(path.zero[1:d + 1], device=X.device)
            feat = torch.as_tensor(path.feat[1:d + 1], device=X.device)
            phi.index_add_(1, feat,
                           w * (path.one[:, 1:d + 1] - zero) * leaf_v)
        return

    f = int(tree.split_feature[node])
    l, r = int(tree.left_child[node]), int(tree.right_child[node])
    go_left = _decide_left_rows(tree, node, X[:, f])
    w_node = float(tree.internal_count[node])
    lz = _child_count(tree, l) / w_node if w_node > 0 else 0.0
    rz = _child_count(tree, r) / w_node if w_node > 0 else 0.0

    inc_zero = 1.0
    inc_one = torch.ones(X.shape[0], dtype=F64, device=X.device)
    path_index = 0
    while path_index <= d:
        if path.feat[path_index] == f:
            break
        path_index += 1
    if path_index != d + 1:
        inc_zero = float(path.zero[path_index])
        inc_one = path.one[:, path_index].clone()
        _vec_unwind(path, d, path_index)
        d -= 1

    _vec_tree_shap(tree, X, phi, l, d + 1, path, lz * inc_zero,
                   inc_one * go_left, f)
    _vec_tree_shap(tree, X, phi, r, d + 1, path, rz * inc_zero,
                   inc_one * (1.0 - go_left), f)


def _decide_left_rows(tree, node: int, v: torch.Tensor) -> torch.Tensor:
    """Tree::Decision over a column of raw values, as float64 0/1: a
    categorical node by its u32 bitset over category values (``int(v)``
    goes left when its bit is set; NaN, negative values and values past
    the bitset go right), a numerical one by its missing type and
    default direction (``decision_type`` bits 2-3 and 1)."""
    dt = int(tree.decision_type[node])
    if dt & 1:
        k = int(tree.threshold[node])
        words = torch.as_tensor(np.asarray(
            tree.cat_threshold[tree.cat_boundaries[k]:
                               tree.cat_boundaries[k + 1]], np.int64),
            device=v.device)
        ok = torch.isfinite(v) & (v >= 0)
        iv = torch.where(ok, v, 0.0).to(torch.int64)
        w = iv >> 5
        inside = ok & (w < words.numel())
        if words.numel() == 0:
            return torch.zeros_like(v)
        bit = (words[torch.clamp(w, max=words.numel() - 1)]
               >> (iv & 31)) & 1
        return (inside & (bit != 0)).to(F64)
    mt = (dt >> 2) & 3
    dl = bool(dt & 2)
    isnan = torch.isnan(v)
    vv = torch.where(isnan, 0.0, v) if mt != 2 else v
    out = vv <= float(tree.threshold[node])
    if mt == 2:
        out = torch.where(isnan, dl, out)
    elif mt == 1:
        out = torch.where(vv.abs() <= 1e-35, dl, out)
    return out.to(F64)


def _child_count(tree, node: int) -> float:
    if node < 0:
        return float(tree.leaf_count[~node])
    return float(tree.internal_count[node])


def _expected_value(tree) -> float:
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0])
    total = float(tree.internal_count[0])
    if total <= 0:
        return 0.0
    return float(np.sum(tree.leaf_value[: tree.num_leaves]
                        * tree.leaf_count[: tree.num_leaves]) / total)


def _max_depth(tree) -> int:
    depth = np.zeros(max(tree.num_nodes, 1), np.int64)
    best = 1
    for i in range(tree.num_nodes):
        for c in (int(tree.left_child[i]), int(tree.right_child[i])):
            if c >= 0:
                depth[c] = depth[i] + 1
                best = max(best, int(depth[c]) + 1)
            else:
                best = max(best, int(depth[i]) + 2)
    return best


def predict_contrib(booster, X: np.ndarray, trees, K: int,
                    row_chunk: int = 65536) -> np.ndarray:
    """Per-feature SHAP values and the expected value, ``[n, (F + 1) *
    K]`` float64 (LGBM_BoosterPredictForMat's contrib layout), walked on
    the booster's device."""
    n, _ = X.shape
    F = booster.num_feature()
    dev = booster._device
    Xd = torch.as_tensor(np.asarray(X, np.float64), device=dev)
    out = torch.zeros((n, (F + 1) * K), dtype=F64, device=dev)
    for ti, tree in enumerate(trees):
        k = ti % K
        base = k * (F + 1)
        if tree.num_leaves <= 1:
            out[:, base + F] += float(tree.leaf_value[0])
            continue
        ev = _expected_value(tree)
        cap = _max_depth(tree) + 2
        # up to `cap` recursion frames each clone [chunk, cap] float64
        # path state; the chunk shrinks for deep trees so that peak
        # memory stays bounded (~cap^2 * chunk * 16 bytes)
        chunk = min(row_chunk, max(256, 8_000_000 // (cap * cap)))
        for r0 in range(0, n, chunk):
            Xc = Xd[r0: r0 + chunk]
            nc = Xc.shape[0]
            phi = torch.zeros((nc, F + 1), dtype=F64, device=dev)
            root = _VecPath(nc, cap, dev)
            _vec_tree_shap(tree, Xc, phi, 0, 0, root, 1.0,
                           torch.ones(nc, dtype=F64, device=dev), -1)
            phi[:, F] += ev
            out[r0: r0 + nc, base: base + F + 1] += phi
    return out.cpu().numpy()
