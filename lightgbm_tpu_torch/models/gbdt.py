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
  finite, before any tree of the iteration is kept), for the L1 family
  the leaf values renewed as percentiles of the residuals
  (``ops/renew.py``, after the quantized path's own renewal), shrinkage by
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

Validation and sampling (the eager path of the JAX ``train_one_iter``):

- valid sets (``add_valid``): each keeps a ``[K, n_valid]`` float32 score,
  to which every new tree's output over the set's bins
  (``predict_leaf_binned``) is added as it is kept, so recorded metrics
  come from summed float32 scores, as in the JAX package; a user
  ``init_score`` (``[n]`` or ``[K * n]``, class-major) starts the train
  and valid scores and turns off boost_from_average;
- bagging: every ``bagging_freq`` iterations an ``[n]`` uniform draw
  gives 0/1 row weights (``u < bagging_fraction``, or the
  ``pos_``/``neg_bagging_fraction`` of ``label > 0``), kept in between;
  GOSS (``data_sample_strategy="goss"``, from iteration ``int(1 /
  learning_rate)``) keeps the rows with ``|g| * h`` at or above its
  ``1 - top_rate`` quantile and the others with probability ``other_rate
  / (1 - top_rate)``, weighted ``(1 - top_rate) / other_rate``. Both
  draws come from a ``torch.Generator`` on the training device seeded
  from ``bagging_seed`` through :func:`bagging_uniform`; per-node column
  sampling draws through :func:`bynode_uniform` from one seeded from
  ``feature_fraction_seed``. JAX's threefry streams cannot be reproduced
  in torch, so the CPU tests replace these two functions with JAX's
  draws;
- ``feature_fraction``: one numpy ``RandomState(feature_fraction_seed)``
  choice per iteration, shared by its K trees, bit for bit the JAX
  package's;
- DART: before the gradients, whole iterations are dropped (numpy
  ``RandomState(drop_seed)``, ``uniform_drop``, ``max_drop``,
  ``skip_drop``) by subtracting their trees' outputs from the train and
  valid scores; after the iteration the new and the dropped trees are
  rescaled (``xgboost_dart_mode``) and added back;
- random forest: gradients from the init scores, shrinkage 1, the init
  score folded into every tree, the scores the running average of the
  trees' outputs; the model predicts with ``average_output``;
- ``preload_models`` continues training from a model's trees (the train
  score rebuilt from the set's bins).

Split constraints (the JAX booster's ``_parse_interaction_constraints``,
``_load_forced_splits`` and ``_init_cegb``): ``interaction_constraints``
become ``[G, F]`` group masks over the used features (features outside
every group are unusable); the forced-split JSON becomes BFS-ordered
``(leaf slot, feature, bin)`` triples, a split on a categorical or
unused feature dropped with its subtree and a warning; CEGB's penalties
become per-feature arrays, and its state (:class:`ops.grow.CegbState`:
the coupled features used, the rows that acquired each lazy feature)
lives on the booster and carries across trees and iterations.

There is no fused/scan program, OOM ladder or resilience machinery: the
loop is plain PyTorch on the device, driven from the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.binning import BinType
from ..ops.grow import CegbConfig, CegbState, GrowConfig, Grower
from ..ops.partition import RangeRules
from ..ops.predict import predict_leaf_binned
from ..ops.renew import renew_leaf_values
from ..ops.split import SplitParams
from .tree import Tree, tree_from_arrays

__all__ = ["GBDTBooster", "bagging_uniform", "bynode_uniform"]

# the non-finite guard's flag bits (the JAX package's _NF_* bits)
_NF_GRAD, _NF_HESS, _NF_LEAF = 1, 2, 4
_NF_KINDS = ((_NF_GRAD, "gradients"), (_NF_HESS, "hessians"),
             (_NF_LEAF, "leaf values"))




def bagging_uniform(gen: torch.Generator, it: int, n: int) -> torch.Tensor:
    """The ``[n]`` float32 uniform draw of bagging and GOSS at iteration
    ``it`` (the JAX package's ``uniform(fold_in(PRNGKey(bagging_seed),
    it), (n,))``)."""
    return torch.rand(n, generator=gen, device=gen.device)


def bynode_uniform(gen: torch.Generator, it: int, k: int, node: int,
                   F: int) -> torch.Tensor:
    """The ``[F]`` float32 uniform draw of node ``node`` of class ``k``'s
    tree at iteration ``it`` (the JAX package's
    ``uniform(fold_in(fold_in(fold_in(PRNGKey(feature_fraction_seed),
    it), k), node), (F,))``)."""
    return torch.rand(F, generator=gen, device=gen.device)


def _cat_masks(tree: Tree, dataset) -> np.ndarray:
    """``[N, B]`` bool: the bins of ``dataset``'s mappers that each
    categorical node sends left, from its bitset over category values
    (bin ``b`` stands for category ``bin_to_cat[b]``; the inverse of
    ``tree_from_arrays``)."""
    inner = dataset.inner_feature_index(tree.split_feature)
    masks = np.zeros((tree.num_nodes, dataset.num_total_bins()), bool)
    for i in np.nonzero((tree.decision_type & 1) != 0)[0]:
        cats = dataset.mappers[inner[i]].bin_to_cat
        masks[i, :len(cats)] = tree.cat_decision(i, cats)
    return masks


def _tree_leaves(tree: Tree, dataset, bundle=None) -> torch.Tensor:
    """``[n]`` leaf of every row of ``dataset`` in a host tree, routed
    over its bins: the tree's bin thresholds when it was grown on these
    mappers, else its real thresholds mapped onto them (a loaded
    model); categorical nodes by the bins their category bitsets hold.
    With ``bundle`` (the dataset's EFB plan) the walk runs on the
    bundled matrix, by each split's rule."""
    bins = dataset.device_bins() if bundle is None else bundle.bins_bundled
    nn = tree.num_nodes
    inner = dataset.inner_feature_index(tree.split_feature)
    is_cat = (tree.decision_type & 1) != 0
    tb = np.asarray(tree.threshold_bin, np.int64).copy()
    for i in np.nonzero((tb < 0) & ~is_cat)[0]:
        tb[i] = int(np.searchsorted(dataset.mappers[inner[i]].upper_bounds,
                                    tree.threshold[i], side="left"))
    depth = np.zeros(max(nn, 1), np.int64)
    deepest = 1
    for i in range(nn):                   # parents precede children
        for c in (tree.left_child[i], tree.right_child[i]):
            if c >= 0:
                depth[c] = depth[i] + 1
            else:
                deepest = max(deepest, int(depth[i]) + 1)
    rules = RangeRules(dataset.feat_num_bins(), dataset.feat_nan_bin(),
                       bundle)
    cat = is_cat.any()
    return predict_leaf_binned(
        inner, np.maximum(tb, 0), (tree.decision_type & 2) != 0,
        tree.left_child, tree.right_child, dataset.feat_nan_bin(), bins,
        deepest, rules, is_cat if cat else None,
        _cat_masks(tree, dataset) if cat else None,
        dataset.num_total_bins() if bundle is None
        else bundle.num_positions)


def tree_values(tree: Tree, dataset, bundle=None) -> torch.Tensor:
    """``[n]`` float32 output of a host tree on every row of
    ``dataset`` (its leaf values rounded to float32, as the JAX
    package's ``_predict_tree_binned_host``); ``bundle``: route over the
    dataset's bundled matrix."""
    n = dataset.num_data()
    dev = dataset.device
    lv = torch.as_tensor(np.asarray(tree.leaf_value, np.float32),
                         device=dev)
    if tree.num_leaves <= 1:
        return torch.full((n,), float(lv[0]), dtype=torch.float32,
                          device=dev)
    return lv[_tree_leaves(tree, dataset, bundle)]


class _ValidData:
    def __init__(self, dataset, score: torch.Tensor, name: str):
        self.dataset = dataset
        self.score = score
        self.name = name


class GBDTBooster:
    """Gradient boosting over a constructed :class:`~basic.Dataset`."""

    def __init__(self, cfg: Config, train_set, objective):
        self.cfg = cfg
        self.train_set = train_set
        self.objective = objective
        dev = train_set.device
        self.device = dev
        self.models: List[Tree] = []
        self.valid_sets: List[_ValidData] = []
        self.iter_ = 0
        # iterations adopted from an init_model (continued training adds
        # num_boost_round new ones on top)
        self.init_iteration = 0
        # learning_rate as reset_parameter may change it between
        # iterations
        self._shrinkage = cfg.learning_rate
        label = np.asarray(train_set.get_label())
        w = train_set.get_weight()
        self.label = torch.as_tensor(label, dtype=torch.float32, device=dev)
        self.weight = None if w is None else torch.as_tensor(
            w, dtype=torch.float32, device=dev)
        self.n = len(label)
        self.K = K = objective.num_model_per_iteration
        if hasattr(objective, "init_label_weights"):
            objective.init_label_weights(label, w)
        # boost_from_average: folded into the first iteration's trees
        # (every tree for rf, whose score is a running average); a user
        # init_score turns it off
        init = np.zeros((K,), np.float64)
        user_init = train_set.get_init_score()
        self._fold_bias = False
        if cfg.boost_from_average and user_init is None:
            self._fold_bias = cfg.boosting != "rf"
            init = np.asarray(objective.boost_from_score(label, w),
                              np.float64).reshape(K)
        self.init_score = init
        self.score = self._base_score(self.n, user_init, True)
        # EFB: train on the bundled matrix when the Dataset bundles
        self.bundle = train_set.bundles(cfg)
        self.monotone = train_set.monotone_array(cfg)
        self.grower = Grower(
            GrowConfig(
                num_leaves=cfg.num_leaves,
                num_bins=train_set.num_total_bins() if self.bundle is None
                else self.bundle.num_positions,
                max_depth=cfg.max_depth,
                split=SplitParams(
                    lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
                    max_delta_step=cfg.max_delta_step,
                    min_data_in_leaf=float(cfg.min_data_in_leaf),
                    min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
                    min_gain_to_split=cfg.min_gain_to_split,
                    cat_smooth=cfg.cat_smooth, cat_l2=cfg.cat_l2,
                    max_cat_threshold=cfg.max_cat_threshold,
                    max_cat_to_onehot=cfg.max_cat_to_onehot,
                    min_data_per_group=float(cfg.min_data_per_group),
                    path_smooth=cfg.path_smooth,
                    monotone_penalty=cfg.monotone_penalty
                    if self.monotone is not None else 0.0),
                quantized=cfg.use_quantized_grad,
                quant_bins=cfg.num_grad_quant_bins,
                renew_leaf=cfg.quant_train_renew_leaf,
                bynode=cfg.feature_fraction_bynode,
                monotone_method=cfg.monotone_constraints_method),
            None if self.bundle is not None else train_set.device_bins(),
            train_set.feat_num_bins(), train_set.feat_nan_bin(),
            bundle=self.bundle, feat_is_cat=train_set.feat_is_cat(),
            monotone=self.monotone,
            interaction_groups=self._interaction_groups(cfg),
            forced=self._forced_splits(cfg), cegb=self._cegb_config(cfg))
        self.cegb_state = None
        if self.grower.cegb is not None:
            self.cegb_state = CegbState(
                self.n, self.grower.F, self.grower.cegb.lazy, dev)
        self._rounding_gen = None
        if cfg.use_quantized_grad and cfg.stochastic_rounding:
            self._rounding_gen = self._generator(
                cfg.seed if cfg.seed is not None else 0)
        self._bag_gen = self._generator(cfg.bagging_seed)
        self._bynode_gen = self._generator(cfg.feature_fraction_seed)
        self._cached_bag: Optional[torch.Tensor] = None
        self._feature_rng = np.random.RandomState(cfg.feature_fraction_seed)
        self._dart_rng = np.random.RandomState(cfg.drop_seed)

    # -- split constraints ----------------------------------------------
    def _interaction_groups(self, cfg: Config) -> Optional[np.ndarray]:
        """``interaction_constraints`` -> ``[G, F]`` bool group masks over
        the used features, by index or by name (None: none)."""
        ic = cfg.interaction_constraints
        if ic is None or ic == "" or ic == []:
            return None
        if isinstance(ic, str):
            import ast
            ic = list(ast.literal_eval(ic if ic.startswith("[[")
                                       else "[" + ic + "]"))
        ds = self.train_set
        names = ds.get_feature_name()
        inner_of = {int(r): i for i, r in
                    enumerate(ds.used_feature_indices())}
        groups = np.zeros((len(ic), len(inner_of)), bool)
        for gi, grp in enumerate(ic):
            for item in grp:
                real = names.index(item) if isinstance(item, str) \
                    else int(item)
                if real in inner_of:
                    groups[gi, inner_of[real]] = True
        return groups

    def _forced_splits(self, cfg: Config) -> Optional[tuple]:
        """``forcedsplits_filename`` -> BFS-ordered ``(leaf slots,
        features, bins)``: forced splits run first and in order, so the
        split at index ``i`` sends its right child to slot ``i + 1``. A
        split on a categorical or unused feature is dropped with its
        subtree, with a warning (None: no forced splits)."""
        fn = cfg.forcedsplits_filename
        if not fn:
            return None
        import json
        import warnings
        from collections import deque
        with open(fn) as fh:
            root = json.load(fh)
        if not root:
            return None
        ds = self.train_set
        inner_of = {int(r): i for i, r in
                    enumerate(ds.used_feature_indices())}
        leaves, feats, bins = [], [], []
        q = deque([(root, 0)])
        while q:
            node, slot = q.popleft()
            real = int(node["feature"])
            inner = inner_of.get(real)
            if inner is None or \
                    ds.mappers[inner].bin_type != BinType.NUMERICAL:
                warnings.warn(
                    f"forced split on unusable/categorical feature {real} "
                    "ignored (with its subtree)")
                continue
            leaves.append(slot)
            feats.append(inner)
            bins.append(int(ds.mappers[inner].value_to_bin(
                np.asarray([float(node["threshold"])]))[0]))
            right_slot = len(leaves)
            if node.get("left"):
                q.append((node["left"], slot))
            if node.get("right"):
                q.append((node["right"], right_slot))
        if not leaves:
            return None
        return leaves, feats, bins

    def _cegb_config(self, cfg: Config) -> Optional[CegbConfig]:
        """CEGB's penalties over the used features (None when no penalty
        is set and the tradeoff is 1)."""
        if not (cfg.cegb_tradeoff < 1.0 or cfg.cegb_penalty_split > 0.0
                or cfg.cegb_penalty_feature_coupled
                or cfg.cegb_penalty_feature_lazy):
            return None
        used = self.train_set.used_feature_indices()

        def per_feature(lst):
            out = np.zeros(len(used), np.float32)
            for i, r in enumerate(used):
                if int(r) < len(lst):
                    out[i] = lst[int(r)]
            return out
        return CegbConfig(
            tradeoff=cfg.cegb_tradeoff, split=cfg.cegb_penalty_split,
            pen_coupled=per_feature(cfg.cegb_penalty_feature_coupled),
            pen_lazy=per_feature(cfg.cegb_penalty_feature_lazy),
            lazy=len(cfg.cegb_penalty_feature_lazy) > 0,
            coupled=len(cfg.cegb_penalty_feature_coupled) > 0)

    def _base_score(self, nrows: int, user_init,
                    with_init: bool) -> torch.Tensor:
        """``[K, nrows]`` float32: the init score (``with_init``) plus a
        user ``init_score`` (``[nrows]`` or ``[K * nrows]``)."""
        init = self.init_score if with_init else np.zeros(self.K)
        score = torch.as_tensor(init.astype(np.float32),
                                device=self.device)[:, None].repeat(1, nrows)
        if user_init is not None:
            score = score + torch.as_tensor(
                np.asarray(user_init, np.float32).reshape(self.K, nrows),
                device=self.device)
        return score

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # -- valid sets and continued training -------------------------------
    def add_valid(self, dataset, name: str) -> None:
        self.valid_sets.append(
            _ValidData(dataset, self._score_dataset_binned(dataset), name))

    def _score_dataset_binned(self, dataset) -> torch.Tensor:
        """``[K, n]`` raw scores of a dataset from the current trees (the
        init score only where it is not folded into them)."""
        is_rf = self.cfg.boosting == "rf"
        score = self._base_score(dataset.num_data(),
                                 dataset.get_init_score(),
                                 not (self._fold_bias or is_rf))
        for i, tree in enumerate(self.models):
            score[i % self.K] += self._tree_values(tree, dataset)
        if is_rf and self.iter_ > 0:
            score = score / self.iter_
        return score

    def preload_models(self, trees: List[Tree]) -> None:
        """Adopt a model's trees (init_model) and rebuild the train score
        from them; the init score is not folded again."""
        self.models = list(trees)
        self.iter_ = len(self.models) // self.K
        self.score = self._score_dataset_binned(self.train_set)

    # -- sampling --------------------------------------------------------
    def _row_weights(self, it: int, grad: torch.Tensor,
                     hess: torch.Tensor) -> Optional[torch.Tensor]:
        """Bagging or GOSS row weights ``[n]`` f32 (None: every row
        once)."""
        cfg, n = self.cfg, self.n
        f32 = torch.float32
        if cfg.data_sample_strategy == "goss":
            if it < max(1, int(1.0 / cfg.learning_rate)):
                return None
            metric = (grad.abs() * hess).sum(dim=0)           # [n]
            thresh = _quantile_f32(metric, 1.0 - cfg.top_rate)
            top = metric >= thresh
            rest_prob = cfg.other_rate / max(1e-12, 1.0 - cfg.top_rate)
            amplify = (1.0 - cfg.top_rate) / max(1e-12, cfg.other_rate)
            u = bagging_uniform(self._bag_gen, it, n)
            other = ~top & (u < torch.tensor(rest_prob, dtype=f32,
                                             device=self.device))
            return top.to(f32) + other.to(f32) * torch.tensor(
                amplify, dtype=f32, device=self.device)
        if cfg.bagging_freq > 0 and (
                cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
                or cfg.neg_bagging_fraction < 1.0):
            if it % cfg.bagging_freq != 0 and self._cached_bag is not None:
                return self._cached_bag
            u = bagging_uniform(self._bag_gen, it, n)
            if cfg.pos_bagging_fraction < 1.0 \
                    or cfg.neg_bagging_fraction < 1.0:
                frac = torch.where(
                    self.label > 0,
                    torch.tensor(cfg.pos_bagging_fraction, dtype=f32),
                    torch.tensor(cfg.neg_bagging_fraction, dtype=f32))
            else:
                frac = torch.tensor(cfg.bagging_fraction, dtype=f32)
            self._cached_bag = (u < frac.to(self.device)).to(f32)
            return self._cached_bag
        return None

    def _feature_mask(self) -> np.ndarray:
        """Per-tree column sampling (ColSampler::ResetByTree)."""
        cfg = self.cfg
        F = self.train_set.feat_num_bins().shape[0]
        if cfg.feature_fraction >= 1.0:
            return np.ones((F,), bool)
        k = max(1, int(round(F * cfg.feature_fraction)))
        chosen = self._feature_rng.choice(np.arange(F), size=k,
                                          replace=False)
        mask = np.zeros((F,), bool)
        mask[chosen] = True
        return mask

    # -- one iteration ---------------------------------------------------
    def train_one_iter(self) -> bool:
        """One boosting iteration (K trees); True when no tree could grow
        (the constant trees are kept and training should stop)."""
        cfg, K, it = self.cfg, self.K, self.iter_
        is_rf = cfg.boosting == "rf"
        drop_idx: List[int] = []
        if cfg.boosting == "dart" and self.models:
            drop_idx = self._dart_select_drop()
            if drop_idx:
                self._dart_apply_drop(drop_idx)
        # rf's trees are independent: gradients from the init score
        base = self._base_score(self.n, None, True) if is_rf else self.score
        g, h = self.objective.grad_hess(
            base if K > 1 else base[0], self.label, self.weight)
        if K == 1:
            g, h = g[None, :], h[None, :]
        gh_flag = torch.where(torch.isfinite(g).all(), 0, _NF_GRAD) \
            | torch.where(torch.isfinite(h).all(), 0, _NF_HESS)
        row_w = self._row_weights(it, g, h)
        fmask = self._feature_mask()
        shrinkage = 1.0 if is_rf else self._shrinkage
        F = fmask.shape[0]
        grown = []
        for k in range(K):
            noise = None
            if self._rounding_gen is not None:
                noise = torch.rand((self.n, 2), generator=self._rounding_gen,
                                   device=self.device)
            node_u = None
            if cfg.feature_fraction_bynode < 1.0:
                def node_u(node, k=k):
                    return bynode_uniform(self._bynode_gen, it, k, node, F)
            grown.append(self.grower.grow(g[k], h[k], noise, row_w, fmask,
                                          node_u, self.cegb_state))
        # the iteration's one read-back of the guard
        flag = int(gh_flag.item())
        if not all(np.isfinite(a.leaf_value).all() for a, _ in grown):
            flag |= _NF_LEAF
        if flag:
            kinds = ", ".join(name for bit, name in _NF_KINDS if flag & bit)
            raise FloatingPointError(
                f"non-finite {kinds} detected at iteration {it} "
                "(nonfinite_policy='raise')")
        grew_any = False
        for k, (arrays, row_leaf) in enumerate(grown):
            if arrays.num_leaves > 1 and self.objective.need_renew:
                arrays = arrays._replace(leaf_value=self._renewed(
                    arrays, row_leaf, k, row_w))
            tree = tree_from_arrays(arrays, self.train_set.mappers,
                                    self.train_set.used_feature_indices())
            fold_now = is_rf or (it == 0 and self._fold_bias)
            bias = float(self.init_score[k]) if fold_now else 0.0
            if tree.num_leaves <= 1:
                # AsConstantTree: only the folded bias, at iteration 0
                bias = bias if it == 0 else 0.0
                tree.leaf_value[:] = bias
                self.models.append(tree)
                if is_rf:
                    self._average_in(k, it, bias, lambda v: bias)
                elif bias != 0.0:
                    for v in self.valid_sets:
                        v.score[k] += bias
                continue
            grew_any = True
            leaf_value = torch.as_tensor(arrays.leaf_value,
                                         device=self.device)
            contrib = leaf_value[row_leaf]
            tree.apply_shrinkage(shrinkage)
            if bias:
                tree.leaf_value = tree.leaf_value + bias
                tree.internal_value = tree.internal_value + bias
            self.models.append(tree)
            if is_rf:
                self._average_in(k, it, contrib + float(self.init_score[k]),
                                 lambda v, t=tree: tree_values(t, v.dataset))
            else:
                self.score[k] += contrib * shrinkage
                for v in self.valid_sets:
                    v.score[k] += tree_values(tree, v.dataset)
        if cfg.boosting == "dart" and drop_idx and grew_any:
            self._dart_normalize(drop_idx)
        self.iter_ += 1
        return not grew_any

    def _tree_values(self, tree: Tree, dataset) -> torch.Tensor:
        """:func:`tree_values`, over the bundled matrix for the train
        set of a bundled run."""
        bundle = self.bundle if dataset is self.train_set else None
        return tree_values(tree, dataset, bundle)

    def _renewed(self, arrays, row_leaf: torch.Tensor, k: int,
                 row_w: Optional[torch.Tensor]) -> np.ndarray:
        """RenewTreeOutput of the L1 family: the tree's leaf values as
        percentiles of the residuals against the current score (the init
        score under rf), weighted by the objective's renewal weights
        times the bagging weights; leaves without weight keep theirs."""
        obj = self.objective
        if self.cfg.boosting == "rf":
            base = torch.full((self.n,), float(self.init_score[k]),
                              dtype=torch.float32, device=self.device)
        else:
            base = self.score[k]
        rw = obj.renew_weight(self.label, self.weight)
        if row_w is None:
            row_w = torch.ones(self.n, dtype=torch.float32,
                               device=self.device)
        rw = row_w if rw is None else row_w * rw
        out = renew_leaf_values(
            row_leaf, obj.renew_residual(base, self.label), rw,
            self.cfg.num_leaves, obj.renew_alpha,
            torch.as_tensor(arrays.leaf_value, device=self.device))
        return out.cpu().numpy()

    def _average_in(self, k: int, it: int, train_out, valid_out) -> None:
        """rf: the scores are the running average of the trees' outputs
        (``train_out`` on the train rows, ``valid_out(v)`` on a valid
        set's)."""
        self.score[k] = (self.score[k] * it + train_out) / (it + 1)
        for v in self.valid_sets:
            v.score[k] = (v.score[k] * it + valid_out(v)) / (it + 1)

    # -- DART (dart.hpp) -------------------------------------------------
    def _dart_select_drop(self) -> List[int]:
        cfg = self.cfg
        n_iters = len(self.models) // self.K
        if self._dart_rng.rand() < cfg.skip_drop or n_iters == 0:
            return []
        if cfg.uniform_drop:
            mask = self._dart_rng.rand(n_iters) < cfg.drop_rate
            drop_iters = np.where(mask)[0]
        else:
            k = min(max(1, int(round(n_iters * cfg.drop_rate))),
                    cfg.max_drop)
            drop_iters = self._dart_rng.choice(n_iters, size=min(k, n_iters),
                                               replace=False)
        if len(drop_iters) > cfg.max_drop > 0:
            drop_iters = drop_iters[:cfg.max_drop]
        out = []
        for i in drop_iters:
            out.extend(range(i * self.K, (i + 1) * self.K))
        return sorted(out)

    def _add_tree(self, i: int, factor: float) -> None:
        """Add ``factor`` times tree ``i``'s output to the train score and
        every valid score."""
        k = i % self.K
        tree = self.models[i]

        def scaled(ds):
            out = self._tree_values(tree, ds)
            return out if factor == 1.0 else out * factor
        self.score[k] += scaled(self.train_set)
        for v in self.valid_sets:
            v.score[k] += scaled(v.dataset)

    def _dart_apply_drop(self, drop_idx: List[int]) -> None:
        """Remove the dropped trees' outputs from every score."""
        for i in drop_idx:
            self._add_tree(i, -1.0)

    def _dart_normalize(self, drop_idx: List[int]) -> None:
        """Shrink the new trees and the dropped ones, and add the dropped
        ones back (dart.hpp Normalize)."""
        kd = len(drop_idx) // self.K
        if self.cfg.xgboost_dart_mode:
            new_w = self._shrinkage / (kd + self._shrinkage)
            old_factor = kd / (kd + self._shrinkage)
        else:
            new_w = 1.0 / (kd + 1.0)
            old_factor = kd / (kd + 1.0)
        for i in range(len(self.models) - self.K, len(self.models)):
            if self.models[i].num_leaves > 1:
                self._add_tree(i, new_w - 1.0)
                self.models[i].apply_shrinkage(new_w)
        for i in drop_idx:
            self.models[i].apply_shrinkage(old_factor)
            self._add_tree(i, 1.0)

    # -- evaluation ------------------------------------------------------
    def eval_metrics(self, metrics, data_idx: int) -> Dict[str, float]:
        """``{name: value}`` of every metric on the train set
        (``data_idx`` 0) or valid set ``data_idx - 1``."""
        if data_idx == 0:
            score, ds = self.score, self.train_set
        else:
            v = self.valid_sets[data_idx - 1]
            score, ds = v.score, v.dataset
        label = torch.as_tensor(np.asarray(ds.get_label()),
                                dtype=torch.float32, device=self.device)
        w = ds.get_weight()
        weight = None if w is None else torch.as_tensor(
            np.asarray(w), dtype=torch.float32, device=self.device)
        convert = self.objective.convert_output
        out = {}
        for m in metrics:
            if hasattr(m, "eval_with_query"):
                val = m.eval_with_query(score, label, weight, ds, convert)
            else:
                val = m.eval(score, label, weight, convert)
            out[m.name] = float(val)
        return out

    def current_score(self, data_idx: int) -> np.ndarray:
        score = self.score if data_idx == 0 \
            else self.valid_sets[data_idx - 1].score
        return score.cpu().numpy()


def _quantile_f32(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a float32 ``[n]`` tensor (linear
    interpolation) with its float32 arithmetic: position ``q * (n - 1)``,
    ``low * (1 - w) + high * w``. A sort, so any n."""
    n = x.shape[0]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    lw = np.float32(1.0) - hw
    srt = torch.sort(x).values
    return srt[lo] * float(lw) + srt[hi] * float(hw)
