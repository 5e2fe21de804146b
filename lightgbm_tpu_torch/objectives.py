"""Objective functions of the port: gradients, init scores, output
transforms, leaf renewal.

Counterpart of ``lightgbm_tpu/objectives.py`` (the ranking objectives
are in ``ranking.py``), with the same interface: ``grad_hess(score,
label, weight) -> (grad, hess)`` on float32 tensors — ``[n]``, or ``[K,
n]`` for the K classes of a multiclass objective —
``boost_from_score(label, weight)`` on host arrays (``[K]`` init
scores), and ``convert_output(score)``. The formulas are the JAX
package's, step for step in float32. Per-row weights multiply the
gradients and hessians after the formula, as in the JAX package, except
in ``CrossEntropyLambda``, whose formula takes the weight inside.

The L1 family (``RegressionL1``, ``Quantile``, ``MAPE``) sets
``need_renew``: after each tree the engine refits every leaf's output as
the weighted ``renew_alpha``-percentile of the residuals
``renew_residual(score, label)`` of its rows (``ops/renew.py``), with
row weights ``renew_weight(label, weight)`` times the bagging weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config

__all__ = ["Objective", "RegressionL2", "RegressionL1", "Huber", "Fair",
           "Poisson", "Quantile", "MAPE", "Gamma", "Tweedie", "Binary",
           "MulticlassSoftmax", "MulticlassOVA", "CrossEntropy",
           "CrossEntropyLambda", "create_objective"]


def _weighted_percentile_np(values: np.ndarray, weights: Optional[np.ndarray],
                            alpha: float) -> float:
    """Host-side weighted percentile of the init scores (the JAX
    package's ``_weighted_percentile_np``): linear interpolation without
    weights, the first cumulative weight at or past ``alpha`` of the
    total with them."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values, kind="stable")
    v = values[order]
    if weights is None:
        idx = alpha * (len(v) - 1)
        lo = int(np.floor(idx))
        hi = min(lo + 1, len(v) - 1)
        frac = idx - lo
        return float(v[lo] * (1 - frac) + v[hi] * frac)
    w = weights[order]
    cw = np.cumsum(w)
    cutoff = alpha * cw[-1]
    i = int(np.searchsorted(cw, cutoff))
    return float(v[min(i, len(v) - 1)])


def _apply_weight(g, h, weight):
    if weight is None:
        return g, h
    return g * weight, h * weight


def _mean(label, weight) -> float:
    if weight is None:
        return float(np.mean(label))
    return float(np.sum(label * weight) / np.sum(weight))


class Objective:
    name = "custom"
    num_model_per_iteration = 1
    need_renew = False          # L1-family per-leaf percentile refit
    renew_alpha = 0.5           # the percentile renewal takes

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def renew_residual(self, score, label):
        """The residual renewal takes the percentile of."""
        return label - score

    def renew_weight(self, label, weight):
        """Renewal's row weights (None: every row once)."""
        return weight

    def grad_hess(self, score: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def convert_output(self, score):
        return score

    def boost_from_score(self, label: np.ndarray,
                         weight: Optional[np.ndarray]) -> np.ndarray:
        return np.zeros((self.num_model_per_iteration,), np.float64)


class RegressionL2(Objective):
    name = "regression"

    def grad_hess(self, score, label, weight):
        g = 2.0 * (score - label)
        h = torch.full_like(score, 2.0)
        return _apply_weight(g, h, weight)

    def boost_from_score(self, label, weight):
        return np.array([_mean(label, weight)])


class RegressionL1(Objective):
    name = "regression_l1"
    need_renew = True
    renew_alpha = 0.5

    def grad_hess(self, score, label, weight):
        g = torch.sign(score - label)
        h = torch.ones_like(score)
        return _apply_weight(g, h, weight)

    def boost_from_score(self, label, weight):
        return np.array([_weighted_percentile_np(label, weight, 0.5)])


class Huber(Objective):
    name = "huber"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.alpha = cfg.alpha

    def grad_hess(self, score, label, weight):
        g = torch.clamp(score - label, -self.alpha, self.alpha)
        h = torch.ones_like(score)
        return _apply_weight(g, h, weight)

    def boost_from_score(self, label, weight):
        return np.array([_weighted_percentile_np(label, weight, 0.5)])


class Fair(Objective):
    name = "fair"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.c = cfg.fair_c

    def grad_hess(self, score, label, weight):
        x = score - label
        denom = torch.abs(x) + self.c
        g = self.c * x / denom
        h = self.c * self.c / (denom * denom)
        return _apply_weight(g, h, weight)


class Poisson(Objective):
    """The hessian is ``exp(score + poisson_max_delta_step)``, as in the
    JAX package."""

    name = "poisson"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.max_delta = cfg.poisson_max_delta_step

    def grad_hess(self, score, label, weight):
        g = torch.exp(score) - label
        h = torch.exp(score + self.max_delta)
        return _apply_weight(g, h, weight)

    def convert_output(self, score):
        return torch.exp(score)

    def boost_from_score(self, label, weight):
        return np.array([np.log(max(_mean(label, weight), 1e-20))])


class Quantile(Objective):
    name = "quantile"
    need_renew = True

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.alpha = cfg.alpha
        self.renew_alpha = cfg.alpha

    def grad_hess(self, score, label, weight):
        g = torch.where(score < label,
                        torch.full_like(score, -self.alpha),
                        torch.full_like(score, 1.0 - self.alpha))
        h = torch.ones_like(score)
        return _apply_weight(g, h, weight)

    def boost_from_score(self, label, weight):
        return np.array([_weighted_percentile_np(label, weight, self.alpha)])


class MAPE(Objective):
    """Gradients and renewal weights scaled by ``1 / max(1, |label|)``."""

    name = "mape"
    need_renew = True
    renew_alpha = 0.5

    @staticmethod
    def _scale(label):
        return 1.0 / torch.clamp_min(torch.abs(label), 1.0)

    def grad_hess(self, score, label, weight):
        scale = self._scale(label)
        g = torch.sign(score - label) * scale
        return _apply_weight(g, scale, weight)

    def renew_weight(self, label, weight):
        scale = self._scale(label)
        return scale if weight is None else weight * scale

    def boost_from_score(self, label, weight):
        w = 1.0 / np.maximum(1.0, np.abs(label))
        if weight is not None:
            w = w * weight
        return np.array([_weighted_percentile_np(label, w, 0.5)])


class Gamma(Objective):
    name = "gamma"

    def grad_hess(self, score, label, weight):
        e = torch.exp(-score)
        g = 1.0 - label * e
        h = label * e
        return _apply_weight(g, h, weight)

    def convert_output(self, score):
        return torch.exp(score)

    def boost_from_score(self, label, weight):
        return np.array([np.log(max(_mean(label, weight), 1e-20))])


class Tweedie(Objective):
    name = "tweedie"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.rho = cfg.tweedie_variance_power

    def grad_hess(self, score, label, weight):
        rho = self.rho
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        g = -label * e1 + e2
        h = -label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return _apply_weight(g, h, weight)

    def convert_output(self, score):
        return torch.exp(score)

    def boost_from_score(self, label, weight):
        return np.array([np.log(max(_mean(label, weight), 1e-20))])


class Binary(Objective):
    name = "binary"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.sigmoid = cfg.sigmoid
        self.is_unbalance = cfg.is_unbalance
        self.scale_pos_weight = cfg.scale_pos_weight
        self._label_weights = (1.0, 1.0)  # (neg, pos)

    def init_label_weights(self, label: np.ndarray,
                           weight: Optional[np.ndarray]) -> None:
        """is_unbalance reweighting: scale the minority class so the
        classes contribute equally."""
        cnt_pos = float(np.sum(label > 0))
        cnt_neg = float(len(label) - cnt_pos)
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self._label_weights = (cnt_pos / cnt_neg, 1.0)
            else:
                self._label_weights = (1.0, cnt_neg / cnt_pos)
        else:
            self._label_weights = (1.0, self.scale_pos_weight)

    def grad_hess(self, score, label, weight):
        wneg, wpos = self._label_weights
        sig = self.sigmoid
        p = torch.sigmoid(sig * score)
        is_pos = label > 0
        lw = torch.where(is_pos, torch.full_like(score, wpos),
                         torch.full_like(score, wneg))
        y = is_pos.to(score.dtype)
        g = sig * (p - y) * lw
        h = sig * sig * p * (1.0 - p) * lw
        return _apply_weight(g, h, weight)

    def convert_output(self, score):
        return torch.sigmoid(self.sigmoid * score)

    def boost_from_score(self, label, weight):
        y = (label > 0).astype(np.float64)
        if weight is None:
            pavg = float(np.mean(y))
        else:
            pavg = float(np.sum(y * weight) / np.sum(weight))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return np.array([np.log(pavg / (1.0 - pavg)) / self.sigmoid])


def _one_hot(label: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """``[K, n]`` one-hot of integer class labels (all zeros out of
    range, as ``jax.nn.one_hot``)."""
    cls = torch.arange(K, device=label.device)[:, None]
    return (label.to(torch.int32)[None, :] == cls).to(dtype)


class MulticlassSoftmax(Objective):
    """Softmax over K classes; hessians scaled by ``K / (K - 1)``. No
    boost from average: the init scores are zeros, as in the JAX
    package."""

    name = "multiclass"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.num_class = cfg.num_class
        self.num_model_per_iteration = cfg.num_class

    def grad_hess(self, score, label, weight):
        p = self.convert_output(score)
        K = self.num_class
        y = _one_hot(label, K, score.dtype)
        factor = K / (K - 1.0)
        g = p - y
        h = factor * p * (1.0 - p)
        if weight is not None:
            g = g * weight[None, :]
            h = h * weight[None, :]
        return g, h

    def convert_output(self, score):
        e = torch.exp(score - score.amax(dim=0, keepdim=True))
        return e / e.sum(dim=0, keepdim=True)


class MulticlassOVA(Objective):
    """One binary (sigmoid) objective per class. The JAX package does not
    boost OVA from the class averages (LightGBM does): the init scores
    are zeros here too."""

    name = "multiclassova"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.num_class = cfg.num_class
        self.num_model_per_iteration = cfg.num_class
        self.sigmoid = cfg.sigmoid

    def grad_hess(self, score, label, weight):
        sig = self.sigmoid
        p = torch.sigmoid(sig * score)
        y = _one_hot(label, self.num_class, score.dtype)
        g = sig * (p - y)
        h = sig * sig * p * (1.0 - p)
        if weight is not None:
            g = g * weight[None, :]
            h = h * weight[None, :]
        return g, h

    def convert_output(self, score):
        return torch.sigmoid(self.sigmoid * score)


class CrossEntropy(Objective):
    """Cross-entropy with labels in [0, 1]."""

    name = "cross_entropy"

    def grad_hess(self, score, label, weight):
        p = torch.sigmoid(score)
        g = p - label
        h = p * (1.0 - p)
        return _apply_weight(g, h, weight)

    def convert_output(self, score):
        return torch.sigmoid(score)

    def boost_from_score(self, label, weight):
        pavg = min(max(_mean(label, weight), 1e-15), 1.0 - 1e-15)
        return np.array([np.log(pavg / (1.0 - pavg))])


class CrossEntropyLambda(Objective):
    """The parameterisation ``z = log(1 + exp(score))``; the weight
    enters the formula (not a factor after it), and the hessian is the
    JAX package's Gauss-Newton form, floored at 1e-15."""

    name = "cross_entropy_lambda"

    def grad_hess(self, score, label, weight):
        w = weight if weight is not None else torch.ones_like(score)
        es = torch.exp(score)
        log1pes = torch.log1p(es)
        sig = es / (1.0 + es)
        emz = torch.exp(-log1pes)          # exp(-z) = 1 / (1 + e^s)
        one_memz = 1.0 - emz               # 1 - exp(-z) = sigmoid(s)
        g = sig * (w - label * emz / torch.clamp_min(one_memz, 1e-15))
        h = sig * (1.0 - sig) * (
            w + label * emz / torch.clamp_min(one_memz * one_memz, 1e-15)
            * sig) \
            + sig * sig * label * emz / torch.clamp_min(one_memz, 1e-15)
        h = torch.clamp_min(h, 1e-15)
        return g, h

    def convert_output(self, score):
        return torch.log1p(torch.exp(score))


_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": MAPE,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": Binary,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}


def create_objective(cfg: Config) -> Objective:
    if cfg.objective in ("lambdarank", "rank_xendcg"):
        from .ranking import create_ranking_objective
        return create_ranking_objective(cfg)
    return _REGISTRY[cfg.objective](cfg)
