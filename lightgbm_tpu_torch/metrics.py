"""Evaluation metrics of the main path: binary log loss and AUC.

Counterpart of ``_binary_logloss`` and ``auc_jnp`` in
``lightgbm_tpu/metrics.py``, as torch functions on ``[n]`` tensors; AUC
in float64 with the JAX package's tie handling (a positive sees half of
the negatives that share its score). Evaluation during training (the
``metric`` parameter, valid sets) is ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["binary_logloss", "auc"]


def binary_logloss(prob: torch.Tensor, label: torch.Tensor,
                   weight: Optional[torch.Tensor] = None) -> float:
    eps = 1e-15
    p = torch.clamp(prob, eps, 1.0 - eps)
    y = (label > 0).to(p.dtype)
    loss = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    if weight is None:
        return float(loss.mean())
    return float((loss * weight).sum() / weight.sum())


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
