"""Evaluation metrics.

Counterpart of ``lightgbm_tpu/metrics.py``: every metric of its registry
as an object with ``eval(raw_score, label, weight, convert_fn) -> float``
(``raw_score`` a ``[K, n]`` float32 tensor, ``convert_fn`` the
objective's output transform) and ``higher_better``, built by
:func:`create_metrics` from the ``metric`` parameter (names and aliases
as in the JAX package; with none given, the objective's default). The
ranking metrics are ``ranking.NDCGMetric`` and ``ranking.MapMetric``.

The formulas run in the score's dtype (float32 during training, as the
JAX package's), except AUC and AUC-mu, which sort and sum in float64
with the JAX package's tie handling. The plain functions
(:func:`binary_logloss`, :func:`auc`, :func:`multi_logloss`,
:func:`multi_error`, :func:`auc_mu`) take ``[n]`` tensors (binary) and
``[n, K]`` tensors (multiclass).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from .config import Config

__all__ = ["binary_logloss", "auc", "multi_logloss", "multi_error",
           "auc_mu", "average_precision", "Metric", "METRIC_ALIASES",
           "create_metrics"]

METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2",
    "regression": "l2", "regression_l2": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc",
    "average_precision": "average_precision",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "auc_mu": "auc_mu",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "": "",
    "none": "", "null": "", "na": "", "custom": "",
}


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


def average_precision(score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor] = None) -> float:
    """Weighted average precision of ``[n]`` scores, rows taken in
    descending score order (a stable sort)."""
    y = (label > 0).to(torch.float64)
    w = torch.ones_like(y) if weight is None else weight.to(torch.float64)
    order = torch.argsort(-score, stable=True)
    yw = (y * w)[order]
    precision = torch.cumsum(yw, 0) / torch.cumsum(w[order], 0).clamp_min(
        1e-15)
    return float((precision * yw).sum() / yw.sum().clamp_min(1e-15))


# ---------------------------------------------------------------------------
# metric objects
# ---------------------------------------------------------------------------
class Metric:
    name: str = ""
    higher_better: bool = False

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def eval(self, raw_score: torch.Tensor, label: torch.Tensor,
             weight: Optional[torch.Tensor],
             convert_fn: Callable) -> float:
        raise NotImplementedError


def _simple(name_, higher=False):
    """A metric of the converted ``[n]`` prediction (``[K, n]`` with K =
    1 is squeezed) by the formula ``fn(cfg, pred, label, w)``."""
    def deco(fn):
        class _M(Metric):
            name = name_
            higher_better = higher

            def eval(self, raw_score, label, weight, convert_fn):
                pred = convert_fn(raw_score)
                if pred.dim() == 2 and pred.shape[0] == 1:
                    pred = pred[0]
                return float(fn(self.cfg, pred, label, weight))
        _M.__name__ = f"Metric_{name_}"
        return _M
    return deco


@_simple("l1")
def _l1(cfg, pred, label, w):
    return _mean(torch.abs(pred - label), w)


@_simple("l2")
def _l2(cfg, pred, label, w):
    return _mean((pred - label) ** 2, w)


@_simple("rmse")
def _rmse(cfg, pred, label, w):
    return math.sqrt(_mean((pred - label) ** 2, w))


@_simple("quantile")
def _quantile(cfg, pred, label, w):
    d = label - pred
    a = cfg.alpha
    return _mean(torch.where(d >= 0, a * d, (a - 1.0) * d), w)


@_simple("huber")
def _huber(cfg, pred, label, w):
    d = torch.abs(pred - label)
    a = cfg.alpha
    return _mean(torch.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a)), w)


@_simple("fair")
def _fair(cfg, pred, label, w):
    d = torch.abs(pred - label)
    c = cfg.fair_c
    return _mean(c * c * (d / c - torch.log1p(d / c)), w)


@_simple("poisson")
def _poisson(cfg, pred, label, w):
    return _mean(pred - label * torch.log(pred.clamp_min(1e-10)), w)


@_simple("mape")
def _mape(cfg, pred, label, w):
    return _mean(torch.abs(pred - label)
                  / torch.abs(label).clamp_min(1.0), w)


@_simple("gamma")
def _gamma(cfg, pred, label, w):
    eps, psi = 1e-10, 1.0
    theta = -1.0 / pred.clamp_min(eps)
    a = -torch.log(-theta)
    return _mean(label * (-theta) + a - (psi - 1.0)
                  * torch.log(label.clamp_min(eps)), w)


@_simple("gamma_deviance")
def _gamma_dev(cfg, pred, label, w):
    eps = 1e-10
    r = label / pred.clamp_min(eps)
    return 2.0 * _mean(-torch.log(r.clamp_min(eps)) + r - 1.0, w)


@_simple("tweedie")
def _tweedie(cfg, pred, label, w):
    rho = cfg.tweedie_variance_power
    p = pred.clamp_min(1e-10)
    a = label * torch.pow(p, 1.0 - rho) / (1.0 - rho)
    b = torch.pow(p, 2.0 - rho) / (2.0 - rho)
    return _mean(-a + b, w)


@_simple("binary_logloss")
def _binary_logloss(cfg, prob, label, w):
    return binary_logloss(prob, label, w)


@_simple("binary_error")
def _binary_error(cfg, prob, label, w):
    y = (label > 0).to(prob.dtype)
    pred = (prob > 0.5).to(prob.dtype)
    return _mean((pred != y).to(prob.dtype), w)


@_simple("cross_entropy")
def _xentropy(cfg, prob, label, w):
    p = torch.clamp(prob, 1e-15, 1.0 - 1e-15)
    return _mean(-(label * torch.log(p)
                    + (1.0 - label) * torch.log(1.0 - p)), w)


@_simple("cross_entropy_lambda")
def _xentlambda(cfg, z, label, w):
    # z > 0 is the converted output of cross_entropy_lambda
    eps = 1e-15
    zz = z.clamp_min(eps)
    return _mean(zz - label * torch.log((-torch.expm1(-zz)).clamp_min(eps)),
                  w)


@_simple("kldiv")
def _kldiv(cfg, prob, label, w):
    eps = 1e-15
    p = torch.clamp(prob, eps, 1.0 - eps)
    y = torch.clamp(label, eps, 1.0 - eps)
    kl = y * torch.log(y / p) + (1.0 - y) * torch.log((1.0 - y) / (1.0 - p))
    return _mean(kl, w)


def _first_row(raw_score):
    return raw_score[0] if raw_score.dim() == 2 else raw_score


class AUC(Metric):
    name = "auc"
    higher_better = True

    def eval(self, raw_score, label, weight, convert_fn):
        return auc(_first_row(raw_score), label, weight)


class AveragePrecision(Metric):
    name = "average_precision"
    higher_better = True

    def eval(self, raw_score, label, weight, convert_fn):
        return average_precision(_first_row(raw_score), label, weight)


class MultiLogloss(Metric):
    name = "multi_logloss"

    def eval(self, raw_score, label, weight, convert_fn):
        return multi_logloss(convert_fn(raw_score).T, label, weight)


class MultiError(Metric):
    name = "multi_error"

    def eval(self, raw_score, label, weight, convert_fn):
        return multi_error(convert_fn(raw_score).T, label, weight,
                           self.cfg.multi_error_top_k)


class AucMu(Metric):
    name = "auc_mu"
    higher_better = True

    def eval(self, raw_score, label, weight, convert_fn):
        return auc_mu(raw_score.T, label, weight, self.cfg.auc_mu_weights)


_REGISTRY = {
    "l1": _l1, "l2": _l2, "rmse": _rmse, "quantile": _quantile,
    "huber": _huber, "fair": _fair, "poisson": _poisson, "mape": _mape,
    "gamma": _gamma, "gamma_deviance": _gamma_dev, "tweedie": _tweedie,
    "binary_logloss": _binary_logloss, "binary_error": _binary_error,
    "auc": AUC, "average_precision": AveragePrecision,
    "multi_logloss": MultiLogloss, "multi_error": MultiError,
    "auc_mu": AucMu,
    "cross_entropy": _xentropy, "cross_entropy_lambda": _xentlambda,
    "kldiv": _kldiv,
}

_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def create_metrics(cfg: Config) -> List[Metric]:
    """The metric objects of ``cfg.metric`` in order, each once (the
    objective's default when the list is empty; ``"none"`` and its
    aliases drop a name). ``ndcg`` and ``map`` give one object per
    ``eval_at`` position."""
    names = list(cfg.metric)
    if not names:
        default = _DEFAULT_FOR_OBJECTIVE.get(cfg.objective)
        names = [default] if default else []
    out: List[Metric] = []
    seen = set()
    for raw in names:
        key = METRIC_ALIASES.get(raw.strip().lower())
        if key is None:
            raise ValueError(f"Unknown metric {raw}")
        if key == "" or key in seen:
            continue
        seen.add(key)
        if key in ("ndcg", "map"):
            from .ranking import create_ranking_metric
            out.extend(create_ranking_metric(key, cfg))
            continue
        out.append(_REGISTRY[key](cfg))
    return out
