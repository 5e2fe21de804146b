"""The boosting loop of the port.

Counterpart of ``GBDTBooster`` in ``lightgbm_tpu/models/gbdt.py`` for
plain gradient boosting with K trees per iteration (K = ``num_class``
for a multiclass objective, else 1), with the semantics of its fused
step (``_fused_iter_step``) and of its eager path for ranking:

- the score is ``[K, n]``; a ranking objective gets the dataset once
  (``set_dataset``, from ``Booster``) and ``[n]`` scores;
- boost_from_average: the objective's ``[K]`` initial scores start every
  row's score and ``init_score[k]`` is folded into the first
  iteration's tree k as a leaf-value bias, so a saved model is
  self-contained (multiclass and ranking objectives start from zeros,
  as in the JAX package);
- each iteration: gradients ``[K, n]`` from the current score, then K
  trees (:class:`ops.grow.Grower`, one grower for all of them), the
  non-finite guard of the default ``nonfinite_policy="raise"`` over the
  gradients, the hessians and every tree's fitted leaf values (as the
  JAX package's ``_leaf_value_guard``; it raises naming what was not
  finite, before any tree of the iteration is kept), shrinkage by
  ``learning_rate``, and the score update ``score[k] += learning_rate *
  leaf_value[row_leaf]``;
- quantized-gradient training (``use_quantized_grad``): with
  ``stochastic_rounding`` each iteration draws one ``[n, 2]`` uniform
  tensor per class, in class order, for the rounding from a
  ``torch.Generator`` on the training device seeded from ``seed`` (0
  when unset, the JAX default). JAX's threefry stream
  (``fold_in(fold_in(base_key, iteration), k)``) cannot be reproduced
  in torch, so the draws differ from the JAX package's; the tests hand
  the grower JAX's draw instead;
- a tree that cannot split is kept as a constant tree that carries only
  the folded bias (AsConstantTree); when no tree of an iteration grew,
  training ends.

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
        self.K = K = objective.num_model_per_iteration
        if hasattr(objective, "init_label_weights"):
            objective.init_label_weights(label, w)
        init = np.zeros((K,), np.float64)
        self._fold_bias = cfg.boost_from_average
        if cfg.boost_from_average:
            init = np.asarray(objective.boost_from_score(label, w),
                              np.float64).reshape(K)
        self.init_score = init
        self.score = torch.as_tensor(
            init.astype(np.float32), device=dev)[:, None].repeat(1, self.n)
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
        """One boosting iteration (K trees); True when no tree could grow
        (the constant trees are kept and training should stop)."""
        cfg, K = self.cfg, self.K
        g, h = self.objective.grad_hess(
            self.score if K > 1 else self.score[0], self.label, self.weight)
        if K == 1:
            g, h = g[None, :], h[None, :]
        gh_flag = torch.where(torch.isfinite(g).all(), 0, _NF_GRAD) \
            | torch.where(torch.isfinite(h).all(), 0, _NF_HESS)
        grown = []
        for k in range(K):
            noise = None
            if self._rounding_gen is not None:
                noise = torch.rand((self.n, 2), generator=self._rounding_gen,
                                   device=self.device)
            grown.append(self.grower.grow(g[k], h[k], noise))
        # the iteration's one read-back of the guard
        flag = int(gh_flag.item())
        if not all(np.isfinite(a.leaf_value).all() for a, _ in grown):
            flag |= _NF_LEAF
        if flag:
            kinds = ", ".join(name for bit, name in _NF_KINDS if flag & bit)
            raise FloatingPointError(
                f"non-finite {kinds} detected at iteration {self.iter_} "
                "(nonfinite_policy='raise')")
        grew_any = False
        for k, (arrays, row_leaf) in enumerate(grown):
            tree = tree_from_arrays(arrays, self.train_set.mappers,
                                    self.train_set.used_feature_indices())
            bias = float(self.init_score[k]) \
                if self.iter_ == 0 and self._fold_bias else 0.0
            if tree.num_leaves <= 1:
                tree.leaf_value[:] = bias
                self.models.append(tree)
                continue
            grew_any = True
            leaf_value = torch.as_tensor(arrays.leaf_value,
                                         device=self.device)
            self.score[k] += leaf_value[row_leaf] * cfg.learning_rate
            tree.apply_shrinkage(cfg.learning_rate)
            if bias:
                tree.leaf_value = tree.leaf_value + bias
                tree.internal_value = tree.internal_value + bias
            self.models.append(tree)
        self.iter_ += 1
        return not grew_any
