"""Objective functions of the port: gradients, init scores, output
transforms.

Counterpart of ``lightgbm_tpu/objectives.py`` for ``Binary``,
``RegressionL2``, ``MulticlassSoftmax`` and ``MulticlassOVA`` (the
ranking objectives are in ``ranking.py``), with the same interface:
``grad_hess(score, label, weight) -> (grad, hess)`` on float32 tensors —
``[n]``, or ``[K, n]`` for the K classes of a multiclass objective —
``boost_from_score(label, weight)`` on host arrays (``[K]`` init
scores), and ``convert_output(score)``. Per-row weights multiply the
gradients and hessians after the formula, as in the JAX package. The
other objectives are ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config

__all__ = ["Objective", "RegressionL2", "Binary", "MulticlassSoftmax",
           "MulticlassOVA", "create_objective"]


def _apply_weight(g, h, weight):
    if weight is None:
        return g, h
    return g * weight, h * weight


class Objective:
    name = "custom"
    num_model_per_iteration = 1

    def __init__(self, cfg: Config):
        self.cfg = cfg

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
        if weight is None:
            avg = float(np.mean(label))
        else:
            avg = float(np.sum(label * weight) / np.sum(weight))
        return np.array([avg])


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


def create_objective(cfg: Config) -> Objective:
    if cfg.objective in ("lambdarank", "rank_xendcg"):
        from .ranking import create_ranking_objective
        return create_ranking_objective(cfg)
    if cfg.objective == "binary":
        return Binary(cfg)
    if cfg.objective == "multiclass":
        return MulticlassSoftmax(cfg)
    if cfg.objective == "multiclassova":
        return MulticlassOVA(cfg)
    return RegressionL2(cfg)
