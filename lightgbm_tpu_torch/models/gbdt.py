"""The boosting loop of the port.

Counterpart of ``GBDTBooster`` in ``lightgbm_tpu/models/gbdt.py`` for
plain gradient boosting with one tree per iteration, with the semantics
of its fused step (``_fused_iter_step``):

- boost_from_average: the objective's initial score starts every row's
  score and is folded into the first iteration's tree as a leaf-value
  bias, so a saved model is self-contained;
- each iteration: gradients from the current score, one tree
  (:class:`ops.grow.Grower`), the non-finite guard of the default
  ``nonfinite_policy="raise"`` over the gradients, the hessians and the
  tree's fitted leaf values (as the JAX package's ``_leaf_value_guard``;
  it raises naming what was not finite), shrinkage by
  ``learning_rate``, and the score update ``score += learning_rate *
  leaf_value[row_leaf]``;
- quantized-gradient training (``use_quantized_grad``): with
  ``stochastic_rounding`` each iteration draws one ``[n, 2]`` uniform
  tensor for the rounding from a ``torch.Generator`` on the training
  device seeded from ``seed`` (0 when unset, the JAX default). JAX's
  threefry stream (``fold_in(base_key, iteration)``) cannot be
  reproduced in torch, so the draws differ from the JAX package's; the
  tests hand the grower JAX's draw instead;
- a tree that cannot split ends training; it is kept as a constant tree
  that carries only the folded bias (AsConstantTree).

There is no fused/scan program, OOM ladder or resilience machinery: the
loop is plain PyTorch on the device, driven from the host.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..ops.grow import GrowConfig, Grower
from ..ops.split import SplitParams
from .tree import Tree, tree_from_arrays

__all__ = ["GBDTBooster"]

# the non-finite guard's flag bits (the JAX package's _NF_* bits)
_NF_GRAD, _NF_HESS, _NF_LEAF = 1, 2, 4
_NF_KINDS = ((_NF_GRAD, "gradients"), (_NF_HESS, "hessians"),
             (_NF_LEAF, "leaf values"))


class GBDTBooster:
    """Gradient boosting over a constructed :class:`~basic.Dataset`."""

    def __init__(self, cfg: Config, train_set, objective):
        self.cfg = cfg
        self.train_set = train_set
        self.objective = objective
        dev = train_set.device
        self.device = dev
        self.models: List[Tree] = []
        self.iter_ = 0
        label = np.asarray(train_set.get_label())
        w = train_set.get_weight()
        self.label = torch.as_tensor(label, dtype=torch.float32, device=dev)
        self.weight = None if w is None else torch.as_tensor(
            w, dtype=torch.float32, device=dev)
        self.n = len(label)
        if hasattr(objective, "init_label_weights"):
            objective.init_label_weights(label, w)
        init = np.zeros((1,), np.float64)
        self._fold_bias = cfg.boost_from_average
        if cfg.boost_from_average:
            init = np.asarray(objective.boost_from_score(label, w),
                              np.float64).reshape(1)
        self.init_score = init
        self.score = torch.full((self.n,), float(np.float32(init[0])),
                                dtype=torch.float32, device=dev)
        self.grower = Grower(
            GrowConfig(
                num_leaves=cfg.num_leaves,
                num_bins=train_set.num_total_bins(),
                max_depth=cfg.max_depth,
                split=SplitParams(
                    lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
                    max_delta_step=cfg.max_delta_step,
                    min_data_in_leaf=float(cfg.min_data_in_leaf),
                    min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
                    min_gain_to_split=cfg.min_gain_to_split),
                quantized=cfg.use_quantized_grad,
                quant_bins=cfg.num_grad_quant_bins,
                renew_leaf=cfg.quant_train_renew_leaf),
            train_set.device_bins(), train_set.feat_num_bins(),
            train_set.feat_nan_bin())
        self._rounding_gen = None
        if cfg.use_quantized_grad and cfg.stochastic_rounding:
            self._rounding_gen = torch.Generator(device=dev)
            self._rounding_gen.manual_seed(
                cfg.seed if cfg.seed is not None else 0)

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when no tree could grow (the
        constant tree is kept and training should stop)."""
        cfg = self.cfg
        g, h = self.objective.grad_hess(self.score, self.label, self.weight)
        gh_flag = torch.where(torch.isfinite(g).all(), 0, _NF_GRAD) \
            | torch.where(torch.isfinite(h).all(), 0, _NF_HESS)
        noise = None
        if self._rounding_gen is not None:
            noise = torch.rand((self.n, 2), generator=self._rounding_gen,
                               device=self.device)
        arrays, row_leaf = self.grower.grow(g, h, noise)
        # the iteration's one read-back of the guard
        flag = int(gh_flag.item()) \
            | (0 if np.isfinite(arrays.leaf_value).all() else _NF_LEAF)
        if flag:
            kinds = ", ".join(name for bit, name in _NF_KINDS if flag & bit)
            raise FloatingPointError(
                f"non-finite {kinds} detected at iteration {self.iter_} "
                "(nonfinite_policy='raise')")
        tree = tree_from_arrays(arrays, self.train_set.mappers,
                                self.train_set.used_feature_indices())
        bias = float(self.init_score[0]) \
            if self.iter_ == 0 and self._fold_bias else 0.0
        self.iter_ += 1
        if tree.num_leaves <= 1:
            tree.leaf_value[:] = bias
            self.models.append(tree)
            return True
        leaf_value = torch.as_tensor(arrays.leaf_value, device=self.device)
        self.score += leaf_value[row_leaf] * cfg.learning_rate
        tree.apply_shrinkage(cfg.learning_rate)
        if bias:
            tree.leaf_value = tree.leaf_value + bias
            tree.internal_value = tree.internal_value + bias
        self.models.append(tree)
        return False
