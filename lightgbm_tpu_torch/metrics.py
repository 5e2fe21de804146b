"""Evaluation metrics: binary log loss and AUC; multiclass log loss,
error and AUC-mu.

Counterpart of ``_binary_logloss``, ``auc_jnp``, ``MultiLogloss``,
``MultiError`` and ``AucMu`` in ``lightgbm_tpu/metrics.py``, as torch
functions on ``[n]`` tensors (binary) and ``[n, K]`` tensors
(multiclass: probabilities, or raw scores for AUC-mu); AUC and AUC-mu in
float64 with the JAX package's tie handling. The ranking metrics are
``ranking.ndcg_at_k`` and ``ranking.map_at_k``. Evaluation during
training (the ``metric`` parameter, valid sets) is ROADMAP.md Queue 1
item 12.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["binary_logloss", "auc", "multi_logloss", "multi_error",
           "auc_mu"]


def _mean(x: torch.Tensor, weight: Optional[torch.Tensor]) -> float:
    if weight is None:
        return float(x.mean())
    return float((x * weight).sum() / weight.sum())


def binary_logloss(prob: torch.Tensor, label: torch.Tensor,
                   weight: Optional[torch.Tensor] = None) -> float:
    eps = 1e-15
    p = torch.clamp(prob, eps, 1.0 - eps)
    y = (label > 0).to(p.dtype)
    return _mean(-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)),
                 weight)


def auc(score: torch.Tensor, label: torch.Tensor,
        weight: Optional[torch.Tensor] = None) -> float:
    y = (label > 0).to(torch.float64)
    w = torch.ones_like(y) if weight is None else weight.to(torch.float64)
    order = torch.argsort(score, stable=True)
    s = score[order]
    pw = (y * w)[order]
    nw = ((1.0 - y) * w)[order]
    new_group = torch.ones_like(s, dtype=torch.int64)
    new_group[1:] = (s[1:] != s[:-1]).to(torch.int64)
    gid = torch.cumsum(new_group, 0) - 1
    g_neg = torch.zeros_like(nw).index_add_(0, gid, nw)
    neg_below = torch.cumsum(g_neg, 0)[gid] - g_neg[gid]
    area = (pw * (neg_below + 0.5 * g_neg[gid])).sum()
    tp, tn = pw.sum(), nw.sum()
    if tp <= 0 or tn <= 0:
        return 1.0
    return float(area / (tp * tn))


def _prob_of_label(prob: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return prob.gather(1, label.to(torch.int64)[:, None])[:, 0]


def multi_logloss(prob: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None) -> float:
    """Mean ``-log p[label]`` of ``[n, K]`` probabilities, each row first
    normalized to sum 1."""
    p = prob / prob.sum(dim=1, keepdim=True).clamp_min(1e-15)
    py = _prob_of_label(p, label)
    return _mean(-torch.log(py.clamp(1e-15, 1.0)), weight)


def multi_error(prob: torch.Tensor, label: torch.Tensor,
                weight: Optional[torch.Tensor] = None,
                top_k: int = 1) -> float:
    """Top-k error of ``[n, K]`` probabilities (``multi_error_top_k``): a
    row is right when fewer than ``top_k`` classes score strictly above
    its label."""
    py = _prob_of_label(prob, label)
    rank = (prob > py[:, None]).sum(dim=1)
    return _mean((rank >= top_k).to(prob.dtype), weight)


def auc_mu(score: torch.Tensor, label: torch.Tensor,
           weight: Optional[torch.Tensor] = None,
           auc_mu_weights=()) -> float:
    """AUC-mu (Kleiman & Page) of ``[n, K]`` raw scores: the separability
    of every class pair along ``v = W[i] - W[j]``, averaged over the
    pairs. ``auc_mu_weights`` is the flattened ``[K, K]`` cost matrix W
    (default: ones off the diagonal); scores within 1e-15 of each other
    count half a concordance, as in the JAX package."""
    s = score.to(torch.float64)
    dev = s.device
    y = label.to(torch.int64)
    K = s.shape[1]
    if K < 2:
        return float("nan")
    if len(auc_mu_weights):
        if len(auc_mu_weights) != K * K:
            raise ValueError(f"auc_mu_weights must have {K * K} elements")
        W = torch.as_tensor(auc_mu_weights, dtype=torch.float64,
                            device=dev).reshape(K, K)
        W.fill_diagonal_(0.0)
    else:
        W = 1.0 - torch.eye(K, dtype=torch.float64, device=dev)
    w = None if weight is None else weight.to(torch.float64)
    cls_w = [float((y == c).sum()) if w is None else float(w[y == c].sum())
             for c in range(K)]
    total = 0.0
    for i in range(K):
        for j in range(i + 1, K):
            sel = (y == i) | (y == j)
            v = W[i] - W[j]
            d = (v[i] - v[j]) * (s[sel] @ v)
            is_j = (y[sel] == j).to(torch.float64)
            ww = torch.ones_like(d) if w is None else w[sel]
            # order by d, class j first among equal d (np.lexsort)
            o1 = torch.argsort(-is_j, stable=True)
            order = o1[torch.argsort(d[o1], stable=True)]
            d_s, j_s, w_s = d[order], is_j[order], ww[order]
            j_mass = torch.cumsum(j_s * w_s, 0)
            lo = torch.searchsorted(d_s, d_s - 1e-15, side="left")
            hi = torch.searchsorted(d_s, d_s + 1e-15, side="right")
            before = torch.where(lo > 0, j_mass[(lo - 1).clamp_min(0)], 0.0)
            tied = j_mass[hi - 1] - before
            s_ij = (w_s * (before + 0.5 * tied))[j_s == 0].sum()
            total += float(s_ij) / (cls_w[i] * cls_w[j])
    return 2.0 * total / (K * (K - 1))
