"""Linear leaves (``linear_tree``): fit and evaluation, as torch ops.

Counterpart of ``lightgbm_tpu/ops/linear.py`` (LightGBM's
LinearTreeLearner::CalculateLinear). Each leaf of a grown tree gets a
ridge model on the numerical features of its branch: ``beta = -(X^T H X
+ lambda I)^-1 X^T g`` with ``X = [branch features | 1]``. The semantics
are the JAX package's:

- rows with NaN in any of the leaf's features are left out of the fit,
  and at prediction they take the leaf's constant value;
- rows out of the bag (weight 0) are left out of the fit;
- a leaf with fewer fitted rows than coefficients, or whose solution is
  not finite, keeps its constant value;
- ``linear_lambda`` goes on the features' diagonal only, not on the
  bias's.

The JAX package builds the ``[n, k + 1, k + 1]`` outer products of all
rows at once, in float32. Here the rows go in chunks whose products
take at most ``CHUNK_ELEMS`` elements, each chunk added to its leaves'
normal equations with ``index_add_``, so the fit's extra device memory
does not grow with the rows. The sums and the batched solve
(``torch.linalg.solve_ex``, which gives a non-finite solution for a
singular system instead of raising) are in float64, and the solution is
rounded to float32: the float32 sums of a large leaf in the card's
atomic order, through a solve, would move a coefficient far more than
the JAX package's own rounding does. Evaluation
(:func:`linear_leaf_values`) also runs in chunks of rows and adds a
row's terms one feature after the other, in float32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..obs.jit_tracker import register_jit

__all__ = ["branch_features_per_leaf", "fit_leaf_linear",
           "linear_leaf_values", "CHUNK_ELEMS"]

# elements of the largest temporary of one chunk of rows ([rows, k1, k1]
# float64 in the fit, [rows, k] in evaluation): 128 MB of float64
CHUNK_ELEMS = 1 << 24


def branch_features_per_leaf(split_feature: np.ndarray,
                             left_child: np.ndarray,
                             right_child: np.ndarray,
                             leaf_parent: np.ndarray, num_leaves: int,
                             is_numerical) -> List[List[int]]:
    """Sorted distinct numerical features on each leaf's root path
    (Tree::branch_features; on the host, trees are small)."""
    nn = max(num_leaves - 1, 0)
    parent_of_node = np.full(nn, -1, np.int64)
    for i in range(nn):
        for c in (left_child[i], right_child[i]):
            if c >= 0:
                parent_of_node[c] = i
    out = []
    for leaf in range(num_leaves):
        feats = set()
        node = int(leaf_parent[leaf])
        while node >= 0:
            f = int(split_feature[node])
            if is_numerical(f):
                feats.add(f)
            node = int(parent_of_node[node])
        out.append(sorted(feats))
    return out


def _chunks(n: int, width: int):
    step = max(1, CHUNK_ELEMS // max(width, 1))
    for a in range(0, n, step):
        yield a, min(n, a + step)


def linear_leaf_values(const: torch.Tensor, coef: torch.Tensor,
                       feats: torch.Tensor, nfeat: torch.Tensor,
                       fallback: torch.Tensor, X: torch.Tensor,
                       leaves: torch.Tensor) -> torch.Tensor:
    """``[n]`` float32 outputs of linear leaves (PredictionFunLinear):
    ``const[l] + sum_j coef[l, j] * X[:, feats[l, j]]`` over the leaf's
    ``nfeat[l]`` features, or ``fallback[l]`` for a row with NaN in one
    of them. ``const``, ``fallback`` ``[L]``; ``coef``, ``feats`` (column
    ids into ``X``) ``[L, k]``; ``X`` ``[n, F]`` float32; ``leaves``
    ``[n]``."""
    k = feats.shape[1]
    leaves = leaves.to(torch.int64)
    if k == 0:
        return const[leaves]
    n = X.shape[0]
    out = torch.empty(n, dtype=const.dtype, device=X.device)
    cols = torch.arange(k, device=X.device)
    for a, b in _chunks(n, k):
        lv = leaves[a:b]
        act = cols[None, :] < nfeat[lv][:, None]
        x = X[a:b].gather(1, feats[lv].to(torch.int64))
        nanrow = (torch.isnan(x) & act).any(dim=1)
        term = torch.where(act, torch.nan_to_num(x) * coef[lv],
                           torch.zeros((), dtype=x.dtype, device=x.device))
        s = term[:, 0]
        for j in range(1, k):
            s = s + term[:, j]
        out[a:b] = torch.where(nanrow, fallback[lv], const[lv] + s)
    return out


def _linear_signature(args, kwargs) -> tuple:
    """The linear walk's cost signature: the rows' shape and device (a
    forest's leaf count and features per leaf are its data)."""
    X = args[5] if len(args) > 5 else kwargs["X"]
    return tuple(X.shape), str(X.dtype), str(X.device)


linear_leaf_values = register_jit("gbdt/linear_eval", linear_leaf_values,
                                  max_signatures=8,
                                  signature=_linear_signature)


def fit_leaf_linear(raw: torch.Tensor, row_leaf: torch.Tensor,
                    grad: torch.Tensor, hess: torch.Tensor,
                    row_weight: torch.Tensor, leaf_feats: torch.Tensor,
                    leaf_nfeat: torch.Tensor, leaf_value: torch.Tensor,
                    linear_lambda: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every leaf's linear model. ``raw`` ``[n, F]`` float32 (NaN kept);
    ``row_leaf`` ``[n]``; ``grad``, ``hess`` ``[n]`` float32;
    ``row_weight`` ``[n]`` (None: every row once); ``leaf_feats`` ``[L,
    k]`` column ids (0-padded), ``leaf_nfeat`` ``[L]``; ``leaf_value``
    ``[L]`` the constant outputs. Returns ``(const [L], coeff [L, k],
    train_pred [n])``, all float32 on ``raw``'s device."""
    n = raw.shape[0]
    L, k = leaf_feats.shape
    k1 = k + 1
    f32 = grad.dtype
    dev, dt = raw.device, torch.float64
    row_leaf = row_leaf.to(torch.int64)
    feats = leaf_feats.to(torch.int64)
    if row_weight is not None:
        grad, hess = grad * row_weight, hess * row_weight
    grad, hess = grad.to(dt), hess.to(dt)
    cols = torch.arange(k, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    XtHX = torch.zeros((L, k1 * k1), dtype=dt, device=dev)
    Xtg = torch.zeros((L, k1), dtype=dt, device=dev)
    cnt_ok = torch.zeros(L, dtype=dt, device=dev)
    for a, b in _chunks(n, k1 * k1):
        lv = row_leaf[a:b]
        act = cols[None, :] < leaf_nfeat[lv][:, None]
        x = raw[a:b].gather(1, feats[lv])
        row_ok = ~(torch.isnan(x) & act).any(dim=1)
        x = torch.where(act & row_ok[:, None], torch.nan_to_num(x).to(dt),
                        zero)
        in_fit = row_ok if row_weight is None \
            else row_ok & (row_weight[a:b] > 0)
        xa = torch.cat([x, torch.ones((b - a, 1), dtype=dt, device=dev)],
                       dim=1) * in_fit[:, None].to(dt)
        h = hess[a:b]
        outer = xa[:, :, None] * (xa * h[:, None])[:, None, :]
        XtHX.index_add_(0, lv, outer.reshape(b - a, k1 * k1))
        Xtg.index_add_(0, lv, xa * grad[a:b, None])
        cnt_ok.index_add_(0, lv, in_fit.to(dt))
    active = cols[None, :] < leaf_nfeat[:, None]                 # [L, k]
    act1 = torch.cat([active, torch.ones((L, 1), dtype=torch.bool,
                                         device=dev)], dim=1)
    pair = act1[:, :, None] & act1[:, None, :]
    # lambda on the active features' diagonal, 0 on the bias's, 1 on
    # the padding's so that every system stays regular
    lam = torch.cat([torch.full((k,), float(linear_lambda), dtype=dt,
                                device=dev), torch.zeros(1, dtype=dt,
                                                         device=dev)])
    diag = torch.where(act1, lam[None, :], torch.ones((), dtype=dt,
                                                      device=dev))
    A = torch.where(pair, XtHX.reshape(L, k1, k1), zero) \
        + torch.eye(k1, dtype=dt, device=dev)[None] * diag[:, None, :]
    rhs = torch.where(act1, Xtg, zero)
    sol = -torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]    # [L, k1]
    sol = sol.to(f32)
    finite = torch.isfinite(sol).all(dim=1)
    ok = (cnt_ok >= (leaf_nfeat + 1).to(dt)) & finite
    const = torch.where(ok, sol[:, -1], leaf_value.to(f32))
    coeff = torch.where(ok[:, None] & active, sol[:, :k],
                        torch.zeros((), dtype=f32, device=dev))
    pred = linear_leaf_values(const, coeff, feats, leaf_nfeat,
                              leaf_value.to(f32), raw, row_leaf)
    return const, coeff, pred
