"""Objective functions of the port: gradients, init scores, output
transforms.

Counterpart of ``lightgbm_tpu/objectives.py`` for the two objectives of
the main path, ``Binary`` and ``RegressionL2``, with the same interface:
``grad_hess(score, label, weight) -> (grad, hess)`` on ``[n]`` float32
tensors, ``boost_from_score(label, weight)`` on host arrays, and
``convert_output(score)``. The other objectives are ROADMAP.md Queue 1
items 10 and 11.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config

__all__ = ["Objective", "RegressionL2", "Binary", "create_objective"]


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
        return np.zeros((1,), np.float64)


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


def create_objective(cfg: Config) -> Objective:
    if cfg.objective == "binary":
        return Binary(cfg)
    return RegressionL2(cfg)
