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
  non-finite guard over the gradients, the hessians and every tree's
  fitted leaf values (below), for the L1 family
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
  score rebuilt from the set's bins), and ``rollback_one_iter`` takes
  the last iteration's trees out of the train and valid scores;
- a custom objective (``objective`` None, ``objective="none"``) grows
  one tree per iteration from zero scores, without boost_from_average
  or renewal, on gradients handed to ``train_one_iter`` from the host
  (the non-finite guard checks them as it checks the objective's).

Split constraints (the JAX booster's ``_parse_interaction_constraints``,
``_load_forced_splits`` and ``_init_cegb``): ``interaction_constraints``
become ``[G, F]`` group masks over the used features (features outside
every group are unusable); the forced-split JSON becomes BFS-ordered
``(leaf slot, feature, bin)`` triples, a split on a categorical or
unused feature dropped with its subtree and a warning; CEGB's penalties
become per-feature arrays, and its state (:class:`ops.grow.CegbState`:
the coupled features used, the rows that acquired each lazy feature)
lives on the booster and carries across trees and iterations.

Growth variants (the JAX booster's routing): ``grower`` ``compact``
(the default), ``level`` or ``masked`` (:class:`ops.grow.Grower`);
quantized gradients, interaction constraints, forced splits, CEGB,
``path_smooth``, ``feature_fraction_bynode`` and monotone constraints
move a run to the compact grower without a word, and the masked grower
warns above 50M row-leaf products. Only the compact grower bundles
(EFB) and takes ``histogram_pool_size``: its cache then holds ``max(2,
MB * 2^20 // (C * B * 8))`` leaf histograms (C bin columns, B bins) when
that is fewer than ``num_leaves``.

Linear trees (``linear_tree``, ``linear_lambda``; LinearTreeLearner):
no bundling; after growth, every tree from the second iteration on gets
a ridge model per leaf on the train set's raw values
(:func:`ops.linear.fit_leaf_linear`), and the train score adds the
fitted outputs; the first iteration's trees stay constant (marked
linear, with no features). The models are shrunk with the tree, the
folded bias goes into ``leaf_const`` too, and coefficients of magnitude
at most 1e-35 are dropped. Valid sets, DART, random forests and
rollback score a linear tree on the set's raw values (the Dataset keeps
them when its reference does).

Resilience (the JAX booster's ``_gh_flag_clamp``, ``_leaf_value_guard``,
``_apply_guard_flag``, ``_run_with_oom_degrade``; ``resilience/``):

- the non-finite guard: ``nan_grad@N`` / ``nan_hess@N``
  (``LIGHTGBM_TPU_FAULT_INJECT``) poison the iteration's gradients or
  hessians; a flag of non-finite gradients, hessians and (per tree)
  fitted leaf values is read back once per iteration, after growing and
  before any tree is kept. ``nonfinite_policy`` ``raise`` records a
  ``nonfinite`` fault event and raises ``LightGBMError``; ``skip_tree``
  keeps each flagged tree as a constant tree and trains on; ``clamp``
  rewrites the gradients and hessians before growth (NaN -> 0, +-Inf ->
  +-1e30, hessians at least 0; no read-back) and the leaf values after
  it. A guarded iteration never counts as "no more leaves";
- the OOM ladder: a device OOM (``torch.OutOfMemoryError``, or
  ``oom@N``) in a grow halves the histogram pool (``num_leaves`` or
  ``histogram_pool_size``'s slots, down to 2), frees the old grower's
  buffers, rebuilds it, restores the rounding and per-node generators to
  their state before the failed grow and retries, so the retry draws the
  same randomness; with no rung left it raises ``LightGBMError``. No rung
  swaps a kernel for its plain version;
- fault events go to ``fault_log`` (drained by the telemetry recorder);
  the phases ``boosting/gradients``, ``boosting/bagging``,
  ``tree_learner/grow`` and ``boosting/update_score`` are ``timed``
  (``utils/timer.py``).

A world of ranks (``parallel/``; the JAX booster's ``dp_active`` block,
``_setup_world``): with ``tree_learner`` ``data``, ``feature``,
``voting`` or ``auto`` (the payload model) and more than one rank, the
grower gets a ``DistGrow``. A Dataset of one rank's shard
(``spmd.distributed_dataset``) trains its own rows; a whole Dataset
passed on every rank trains this rank's ``ceil(n / D)`` rows (all of
them under ``feature``). The labels of ``boost_from_average`` and the
objective's label statistics, GOSS's threshold, leaf renewal and the
train set's metrics are the world's (gathered); bagging, GOSS and the
stochastic rounding draw the world's vector on every rank and take this
rank's rows, so the bag is the one-process run's. The JAX package's
refusals and warnings come along (CEGB, voting with forced splits,
voting's basic monotone method, the sharded search under EFB), and
``linear_tree`` trains serially only.

The loop is plain PyTorch on the device, driven from the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..log import log_info, log_warning
from ..obs.jit_tracker import register_jit
from ..resilience.faults import (FaultPlan, InjectedResourceExhausted,
                                 append_fault_event, is_resource_exhausted,
                                 nf_clamp)
from ..utils.timer import timed
from ..ops.binning import BinType
from ..ops.grow import CegbConfig, CegbState, GrowConfig, Grower
from ..ops.linear import (branch_features_per_leaf, fit_leaf_linear,
                          linear_leaf_values)
from ..ops.partition import RangeRules
from ..ops.predict import predict_leaf_binned
from ..ops.renew import renew_leaf_values
from ..ops.split import SplitParams
from .tree import Tree, tree_from_arrays

__all__ = ["GBDTBooster", "bagging_uniform", "bynode_uniform"]

# the non-finite guard's flag bits (the JAX package's _NF_* constants)
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
    linear = tree.is_linear and tree.leaf_const is not None
    if tree.num_leaves <= 1:
        base = tree.leaf_const[0] if linear else tree.leaf_value[0]
        return torch.full((n,), float(np.float32(base)),
                          dtype=torch.float32, device=dev)
    leaves = _tree_leaves(tree, dataset, bundle)
    if linear:
        return _linear_values(tree, dataset, leaves)
    lv = torch.as_tensor(np.asarray(tree.leaf_value, np.float32),
                         device=dev)
    return lv[leaves]


def _binned_signature(args, kwargs) -> tuple:
    """A binned walk's cost signature: the dataset's rows and columns,
    its device and whether the walk runs on the bundled matrix (a
    tree's size is its data, as the JAX walk pads it to ``num_leaves``)."""
    dataset = args[1]
    bundle = args[2] if len(args) > 2 else kwargs.get("bundle")
    return (dataset.num_data(), len(dataset.feat_num_bins()),
            str(dataset.device), bundle is not None)


_tree_leaves = register_jit("gbdt/tree_leaves_binned", _tree_leaves,
                            max_signatures=8, signature=_binned_signature)
tree_values = register_jit("gbdt/tree_values_binned", tree_values,
                           max_signatures=8, signature=_binned_signature)


def _linear_values(tree: Tree, dataset, leaves: torch.Tensor):
    """``[n]`` float32 outputs of a linear tree's leaves ``leaves`` on
    ``dataset``'s raw values (the JAX ``_linear_values_binned``)."""
    L = tree.num_leaves
    dev = dataset.device
    const = torch.as_tensor(np.asarray(tree.leaf_const[:L], np.float32),
                            device=dev)
    km = max((len(f) for f in tree.leaf_features), default=0)
    if km == 0:
        return const[leaves]
    lf = np.zeros((L, km), np.int64)
    nf = np.zeros(L, np.int64)
    cf = np.zeros((L, km), np.float64)
    for i in range(L):
        inner = dataset.inner_feature_index(
            np.asarray(tree.leaf_features[i], np.int64))
        lf[i, :len(inner)] = inner
        nf[i] = len(inner)
        cf[i, :len(inner)] = tree.leaf_coeff[i]

    def dv(a, dt=None):
        return torch.as_tensor(a if dt is None else a.astype(dt), device=dev)
    return linear_leaf_values(
        const, dv(cf, np.float32), dv(lf), dv(nf),
        dv(np.asarray(tree.leaf_value[:L]), np.float32),
        dataset.device_raw(), leaves)


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
        # split constraints and the grower's routing, which the world's
        # parallel mode (below) reads
        self.monotone = train_set.monotone_array(cfg)
        # linear trees fit on the train set's raw values
        self.raw = None
        if cfg.linear_tree:
            if self.monotone is not None:
                raise ValueError(
                    "linear_tree does not support monotone constraints "
                    "(reference config check)")
            if train_set._raw is None:
                raise ValueError(
                    "linear_tree requires the Dataset to be constructed "
                    "with the linear_tree parameter (raw data retained)")
            self.raw = train_set._raw
        groups = self._interaction_groups(cfg)
        forced = self._forced_splits(cfg)
        cegb = self._cegb_config(cfg)
        grower = cfg.grower
        if cfg.use_quantized_grad or groups is not None \
                or forced is not None or cegb is not None \
                or cfg.path_smooth > 0.0 \
                or cfg.feature_fraction_bynode < 1.0 \
                or self.monotone is not None:
            grower = "compact"
        n_rows = train_set.num_data()
        if grower == "masked" and n_rows * cfg.num_leaves > 50_000_000:
            log_warning(
                "grower=masked rebuilds every histogram with a full-row "
                "pass: O(num_leaves * rows * features) per tree "
                f"(~{n_rows * cfg.num_leaves / 1e9:.1f}B row-visits "
                "here). Use grower=compact (the default) for data of "
                "this size.")
        # EFB: train on the bundled matrix when the Dataset bundles (the
        # compact grower only, not under linear trees, and not on one
        # rank's shard, whose bundles would differ from its peers')
        local_shard = getattr(train_set, "_shard", None) is not None
        self.bundle = train_set.bundles(cfg) \
            if grower == "compact" and not cfg.linear_tree \
            and not local_shard else None
        num_bins = train_set.num_total_bins() if self.bundle is None \
            else self.bundle.num_positions
        ncols = len(train_set.mappers) if self.bundle is None \
            else self.bundle.bins_bundled.shape[1]
        # the histogram cache's slots (histogram_pool_size MB)
        pool = 0
        if cfg.histogram_pool_size > 0 and grower == "compact":
            slots = max(2, int(cfg.histogram_pool_size * 2 ** 20
                               // (ncols * num_bins * 2 * 4)))
            if slots < cfg.num_leaves:
                pool = slots
        split = SplitParams(
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
            if self.monotone is not None else 0.0)
        gcfg = GrowConfig(
            num_leaves=cfg.num_leaves, num_bins=num_bins,
            max_depth=cfg.max_depth, split=split,
            quantized=cfg.use_quantized_grad,
            quant_bins=cfg.num_grad_quant_bins,
            renew_leaf=cfg.quant_train_renew_leaf,
            bynode=cfg.feature_fraction_bynode,
            monotone_method=cfg.monotone_constraints_method,
            grower=grower, pool_slots=pool)
        # a world of ranks (parallel/): this rank's rows, the parallel
        # mode and the grower's side of the collectives
        gcfg, dist = self._setup_world(cfg, train_set, gcfg, ncols,
                                       forced, cegb)
        label = np.asarray(train_set.get_label())
        w = train_set.get_weight()
        glabel, gw = self._global_rows(label), self._global_rows(w)
        # the world's labels (the snapshot's data fingerprint)
        self._glabel = glabel
        label, w = self._local_rows(label), self._local_rows(w)
        self.label = torch.as_tensor(label, dtype=torch.float32, device=dev)
        self.weight = None if w is None else torch.as_tensor(
            w, dtype=torch.float32, device=dev)
        self.n = len(label)
        # a custom objective (None: gradients from fobj) grows one tree
        # per iteration, from zero scores, as in the JAX package
        self.K = K = objective.num_model_per_iteration \
            if objective is not None else 1
        if hasattr(objective, "init_label_weights"):
            objective.init_label_weights(glabel, gw)
        # boost_from_average: folded into the first iteration's trees
        # (every tree for rf, whose score is a running average); a user
        # init_score turns it off. In a world: the world's labels
        init = np.zeros((K,), np.float64)
        user_init = train_set.get_init_score()
        self._fold_bias = False
        if objective is not None and cfg.boost_from_average \
                and user_init is None:
            self._fold_bias = cfg.boosting != "rf"
            init = np.asarray(objective.boost_from_score(glabel, gw),
                              np.float64).reshape(K)
        self.init_score = init
        if user_init is not None and self._rows is not None:
            ui = np.asarray(user_init).reshape(-1, self.n_global)
            user_init = ui[:, self._rows[0]:self._rows[1]].reshape(-1)
        self.score = self._base_score(self.n, user_init, True)
        # kept to rebuild the grower with fewer pool slots (OOM ladder)
        bins = None if self.bundle is not None else train_set.device_bins()
        bundle = self.bundle
        if self._rows is not None:
            lo, hi = self._rows
            if bundle is not None:
                bundle = bundle._replace(
                    bins_bundled=bundle.bins_bundled[lo:hi])
            else:
                bins = bins[lo:hi]
        self._grower_args = (bins, train_set.feat_num_bins(),
                             train_set.feat_nan_bin())
        self._grower_kw = dict(
            bundle=bundle, feat_is_cat=train_set.feat_is_cat(),
            monotone=self.monotone, interaction_groups=groups,
            forced=forced, cegb=cegb, dist=dist)
        self.grower = Grower(gcfg, *self._grower_args, **self._grower_kw)
        from ..parallel import placement
        if self.comm is not None:
            # every rank holds its rows on its device: the world's sync
            # point after placement, where a rank lost in its construct
            # is named
            placement.upload_barrier()
        # shard_residency=device (auto in a world on CUDA): the grower
        # holds the device bins, so the Dataset's host copy goes
        if placement.shard_residency(cfg.shard_residency,
                                     1 if self.comm is None
                                     else self.comm.size,
                                     dev.type) == "device":
            train_set.free_host_bins()
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
        # resilience: the guard's policy, the injected faults, the fault
        # events (drained by obs/recorder.py), the last iteration grew
        # nothing (a checkpoint's "stalled"), and a restored snapshot's
        # stall still to honour
        self._nf_policy = cfg.nonfinite_policy
        self._fault_plan = FaultPlan.from_env()
        self.fault_log: List[dict] = []
        self._finished_natural = False
        self._resume_stalled = False

    # -- the world of ranks (parallel/) ---------------------------------
    def _setup_world(self, cfg: Config, ts, gcfg: GrowConfig, ncols: int,
                     forced, cegb):
        """Join the grower to the world when it trains in one (the JAX
        booster's ``dp_active`` block): the parallel mode (``auto`` from
        the payload model), the wire format, the JAX package's refusals
        and warnings, and this rank's rows. Returns ``(GrowConfig,
        DistGrow or None)``. Sets ``comm`` (None: serial), ``_rows``
        (the slice of a replicated Dataset this rank trains, or None),
        ``row_lo``, ``n_global`` and ``row_counts``."""
        from ..basic import LightGBMError
        from ..parallel.mesh import make_mesh, shard_rows
        mesh = make_mesh(cfg.num_devices, device=ts.device)
        want = cfg.tree_learner in ("data", "feature", "voting", "auto") \
            or cfg.num_devices > 1
        shard = getattr(ts, "_shard", None)
        n = ts.num_data()
        self.comm, self._rows, self.row_lo = None, None, 0
        self.n_global = n if shard is None else int(shard[1])
        self.row_counts = [n]
        self.parallel_mode = "serial"
        if not (want and mesh.size > 1):
            if shard is not None and mesh.size > 1:
                raise LightGBMError(
                    "this Dataset holds one rank's rows "
                    "(spmd.distributed_dataset): train it with "
                    "tree_learner=data, voting or auto in its world")
            return gcfg, None
        from ..parallel import comms
        from ..parallel.data_parallel import DistGrow
        D = mesh.size
        mode = {"feature": "feature",
                "voting": "voting"}.get(cfg.tree_learner, "data")
        if cfg.tree_learner == "auto":
            mode = comms.choose_parallel_mode(
                ncols, gcfg.num_bins, self.n_global, D, cfg.hist_comm,
                cfg.top_k)
            if mode == "voting" and forced is not None:
                mode = "data"
            if mode != "data" and gcfg.grower != "compact":
                # feature and voting gate their reductions per search,
                # which only the compact grower does
                mode = "data"
            log_info(f"tree_learner=auto -> {mode}-parallel (F={ncols}, "
                     f"B={gcfg.num_bins}, rows={self.n_global}, world={D}, "
                     f"hist_comm={cfg.hist_comm})")
        if cegb is not None:
            raise ValueError("CEGB is not supported with multi-device "
                             "training yet")
        if cfg.linear_tree:
            raise ValueError("linear_tree trains with the serial tree "
                             "learner only (the reference's config check)")
        if mode != "data" and gcfg.grower != "compact":
            raise NotImplementedError(
                f"grower={gcfg.grower!r} with tree_learner={mode}: feature "
                "and voting need grower='compact'")
        wire = comms.resolve_hist_comm(cfg.hist_comm, ncols, gcfg.num_bins,
                                       mode, cfg.top_k)
        if cfg.use_quantized_grad or mode == "feature":
            # exact int32 histograms, or no histogram reduction at all
            wire = "f32"
        if mode == "voting" and forced is not None:
            raise ValueError(
                "tree_learner=voting does not support forced splits or "
                "CEGB (their gathers read the local histogram cache as if "
                "it were global)")
        if mode == "voting" and self.monotone is not None \
                and gcfg.monotone_method != "basic":
            log_warning("tree_learner=voting forces "
                        "monotone_constraints_method=basic")
            gcfg = gcfg._replace(monotone_method="basic")
        ss = cfg.split_search
        if ss == "sharded" and (mode != "data" or self.bundle is not None):
            if self.bundle is not None and mode == "data":
                log_warning("split_search=sharded does not cover EFB-"
                            "bundled matrices yet; using the gathered "
                            "search")
            ss = "gathered"
        if ss == "sharded" and gcfg.grower != "compact":
            log_warning(f"split_search=sharded runs on the compact grower "
                        f"only; grower={gcfg.grower} uses the gathered "
                        "search")
            ss = "gathered"
        if mode == "feature":
            if shard is not None:
                raise LightGBMError(
                    "feature-parallel growth replicates the full row set "
                    "on every rank, but this Dataset holds one rank's "
                    "shard (spmd.distributed_dataset) — use "
                    "tree_learner=data, or give every rank the whole "
                    "Dataset for feature-parallel")
        elif shard is None:
            if ts.query_boundaries() is not None:
                raise LightGBMError(
                    "a ranking Dataset in a world is built per rank with "
                    "spmd.distributed_dataset (whole query groups per "
                    "shard); a replicated one would cut queries")
            bounds = [shard_rows(mesh, n, r) for r in range(D)]
            self._rows = bounds[mesh.rank]
            self.row_lo = self._rows[0]
            self.row_counts = [hi - lo for lo, hi in bounds]
        else:
            self.row_lo = int(shard[0])
            self.row_counts = [n] * D
        self.comm = comms.Comm(mesh)
        self.parallel_mode = mode
        self.hist_comm = wire
        self.split_search = ss
        self._ncols = ncols
        self._comm_sent = 0
        return gcfg, DistGrow(self.comm, mode, ncols, wire, ss, cfg.top_k,
                              cfg.use_quantized_grad)

    @property
    def _sharded_rows(self) -> bool:
        """The rows are split over the world (data, voting)."""
        return self.comm is not None and self.parallel_mode != "feature"

    def _global_rows(self, a):
        """The world's rows of a host per-row array of the train set (its
        own rows when the Dataset is replicated)."""
        if a is None or not self._sharded_rows or self._rows is not None:
            return a
        t = torch.as_tensor(np.asarray(a, np.float64), device=self.device)
        return self.comm.gather_rows(t, self.row_counts).cpu().numpy()

    def _local_rows(self, a):
        """This rank's rows of a host per-row array of the train set."""
        if a is None or self._rows is None:
            return a
        return np.asarray(a)[self._rows[0]:self._rows[1]]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """The world's rows (last axis) of a per-row device tensor."""
        if not self._sharded_rows:
            return t
        moved = torch.movedim(t, -1, 0).contiguous()
        return torch.movedim(self.comm.gather_rows(moved, self.row_counts),
                             0, -1)

    def _draw_rows(self, draw: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a draw over the world's rows (every rank
        draws the whole vector, so a bag equals the serial one)."""
        if not self._sharded_rows:
            return draw
        return draw[self.row_lo:self.row_lo + self.n]

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
        rows, init = dataset.num_data(), dataset.get_init_score()
        if dataset is self.train_set and self._rows is not None:
            # this rank's rows of a replicated train set
            rows = self.n
            if init is not None:
                init = np.asarray(init).reshape(-1, self.n_global)[
                    :, self._rows[0]:self._rows[1]].reshape(-1)
        score = self._base_score(rows, init, not (self._fold_bias or is_rf))
        for i, tree in enumerate(self.models):
            score[i % self.K] += self._tree_values(tree, dataset)
        if is_rf and self.iter_ > 0:
            score = score / self.iter_
        return score

    def preload_models(self, trees: List[Tree],
                       score: Optional[np.ndarray] = None) -> None:
        """Adopt a model's trees (init_model) and rebuild the train score
        from them (the init score is not folded again), or install
        ``score`` (``[K, n]`` float32, a checkpoint's) verbatim."""
        self.models = list(trees)
        self.iter_ = len(self.models) // self.K
        self._finished_natural = False
        self.score = self._score_dataset_binned(self.train_set) \
            if score is None else torch.tensor(
                np.asarray(score, np.float32), device=self.device)

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
            # a world's threshold is over the world's rows
            thresh = _quantile_f32(self._gather(metric), 1.0 - cfg.top_rate)
            top = metric >= thresh
            rest_prob = cfg.other_rate / max(1e-12, 1.0 - cfg.top_rate)
            amplify = (1.0 - cfg.top_rate) / max(1e-12, cfg.other_rate)
            u = self._draw_rows(bagging_uniform(self._bag_gen, it,
                                                self.n_global))
            other = ~top & (u < torch.tensor(rest_prob, dtype=f32,
                                             device=self.device))
            return top.to(f32) + other.to(f32) * torch.tensor(
                amplify, dtype=f32, device=self.device)
        if cfg.bagging_freq > 0 and (
                cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
                or cfg.neg_bagging_fraction < 1.0):
            if it % cfg.bagging_freq != 0 and self._cached_bag is not None:
                return self._cached_bag
            u = self._draw_rows(bagging_uniform(self._bag_gen, it,
                                                self.n_global))
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
    def train_one_iter(self,  # tpulint: hot
                       custom_grad: Optional[np.ndarray] = None,
                       custom_hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration (K trees); True when no tree could grow
        (the constant trees are kept and training should stop).
        ``custom_grad``/``custom_hess`` (host arrays of ``K * n`` values,
        class-major) take the place of the objective's gradients; each
        is copied to the device once."""
        cfg, K, it = self.cfg, self.K, self.iter_
        # a restored snapshot whose last iteration grew nothing: the
        # uninterrupted run stopped here without growing again
        if self._resume_stalled:
            self._resume_stalled = False
            if custom_grad is None:
                self._finished_natural = True
                return True
        is_rf = cfg.boosting == "rf"
        drop_idx: List[int] = []
        if cfg.boosting == "dart" and self.models:
            drop_idx = self._dart_select_drop()
            if drop_idx:
                self._dart_apply_drop(drop_idx)
        with timed("boosting/gradients"):
            if custom_grad is not None:
                g, h = (torch.as_tensor(
                    np.asarray(a, np.float32).reshape(K, self.n),
                    device=self.device) for a in (custom_grad, custom_hess))
            else:
                # rf's trees are independent: gradients from the init
                # score
                base = self._base_score(self.n, None, True) if is_rf \
                    else self.score
                g, h = self.objective.grad_hess(
                    base if K > 1 else base[0], self.label, self.weight)
                if K == 1:
                    g, h = g[None, :], h[None, :]
        g, h, gh_flag = self._gh_guard(it, g, h)
        with timed("boosting/bagging"):
            row_w = self._row_weights(it, g, h)
            fmask = self._feature_mask()
        shrinkage = 1.0 if is_rf else self._shrinkage
        F = fmask.shape[0]
        grown = []
        for k in range(K):
            def grow_k(k=k):
                noise = None
                if self._rounding_gen is not None:
                    noise = self._draw_rows(torch.rand(
                        (self.n_global, 2), generator=self._rounding_gen,
                        device=self.device))
                node_u = None
                if cfg.feature_fraction_bynode < 1.0:
                    def node_u(node):
                        return bynode_uniform(self._bynode_gen, it, k, node,
                                              F)
                return self.grower.grow(g[k], h[k], noise, row_w, fmask,
                                        node_u, self.cegb_state)
            with timed("tree_learner/grow"):
                grown.append(self._run_with_oom_degrade(grow_k))
        grown, flag = self._leaf_guard(it, gh_flag, grown)
        grew_any = False
        for k, (arrays, row_leaf) in enumerate(grown):
            if arrays.num_leaves > 1 and self.objective is not None \
                    and self.objective.need_renew:
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
                if cfg.linear_tree:
                    tree.is_linear = True
                    tree.leaf_const = tree.leaf_value.copy()
                    tree.leaf_features = [[] for _ in range(tree.num_leaves)]
                    tree.leaf_coeff = [[] for _ in range(tree.num_leaves)]
                self.models.append(tree)
                if is_rf:
                    self._average_in(k, it, bias, lambda v: bias)
                elif bias != 0.0:
                    for v in self.valid_sets:
                        v.score[k] += bias
                continue
            grew_any = True
            lin = None
            if cfg.linear_tree:
                lin = self._fit_linear(arrays, row_leaf, g[k], h[k], row_w,
                                       len(self.models) < K)
                contrib = lin[2]
            else:
                contrib = torch.as_tensor(arrays.leaf_value,
                                          device=self.device)[row_leaf]
            tree.apply_shrinkage(shrinkage)
            if lin is not None:
                self._attach_linear(tree, lin, shrinkage)
            if bias:
                tree.leaf_value = tree.leaf_value + bias
                tree.internal_value = tree.internal_value + bias
                if tree.is_linear:
                    # Tree::AddBias moves leaf_const too
                    tree.leaf_const = tree.leaf_const + bias
            self.models.append(tree)
            if is_rf:
                self._average_in(k, it, contrib + float(self.init_score[k]),
                                 lambda v, t=tree: tree_values(t, v.dataset))
            else:
                with timed("boosting/update_score"):
                    self.score[k] += contrib * shrinkage
                for v in self.valid_sets:
                    v.score[k] += tree_values(tree, v.dataset)
        if cfg.boosting == "dart" and drop_idx and grew_any:
            self._dart_normalize(drop_idx)
        self.iter_ += 1
        # a guarded iteration's constant trees are not "no more leaves"
        finished = not grew_any and not flag
        if finished:
            self._finished_natural = True
        return finished

    # -- resilience: the non-finite guard and the OOM ladder -------------
    def _gh_guard(self, it: int, g: torch.Tensor, h: torch.Tensor):
        """Fault injection, the gradients' and hessians' flag bits as a
        device scalar (no read-back here), and the clamp policy."""
        if self._fault_plan.fires("nan_grad", it):
            g = torch.full_like(g, float("nan"))
        if self._fault_plan.fires("nan_hess", it):
            h = torch.full_like(h, float("nan"))
        flag = torch.where(torch.isfinite(g).all(), 0, _NF_GRAD) \
            | torch.where(torch.isfinite(h).all(), 0, _NF_HESS)
        if self._nf_policy == "clamp":
            g = nf_clamp(g)
            h = nf_clamp(h, lo=0.0)
        return g, h, flag

    def _leaf_guard(self, it: int, gh_flag: torch.Tensor, grown: list):
        """The iteration's one read-back of the guard: each tree's flag is
        the gradients' and hessians' bits plus its own leaf bit. Records
        and enforces the policy (clamp rewrites the leaf values, skip_tree
        demotes a flagged tree to a constant) and returns the trees and
        the iteration's flag."""
        gh = int(gh_flag.item())
        flags = [gh | (0 if np.isfinite(a.leaf_value).all() else _NF_LEAF)
                 for a, _ in grown]
        flag = int(np.bitwise_or.reduce(flags)) if flags else 0
        if not flag:
            return grown, 0
        self._apply_guard_flag(it, flag)
        out = []
        for (arrays, row_leaf), fl in zip(grown, flags):
            if self._nf_policy == "clamp":
                arrays = arrays._replace(
                    leaf_value=nf_clamp(torch.as_tensor(
                        arrays.leaf_value)).numpy())
            elif fl:
                arrays = arrays._replace(
                    num_leaves=1,
                    leaf_value=np.zeros_like(arrays.leaf_value))
            out.append((arrays, row_leaf))
        return out, flag

    def _apply_guard_flag(self, it: int, flag: int) -> None:
        """Record the policy for one iteration's flag; raise under
        ``raise``."""
        kinds = [name for bit, name in _NF_KINDS if flag & bit]
        detail = "non-finite " + ", ".join(kinds)
        append_fault_event(self.fault_log, "nonfinite", it,
                           self._nf_policy, detail)
        if self._nf_policy == "raise":
            from ..basic import LightGBMError
            raise LightGBMError(
                f"{detail} detected at iteration {it} "
                "(nonfinite_policy=raise; use skip_tree or clamp to "
                "train through transient numerical faults)")

    def _next_pool_slots(self) -> Optional[int]:
        """The ladder's next histogram pool (half the current one, at
        least 2), or None when no rung is left (the pool is the compact
        grower's)."""
        cfg = self.grower.cfg
        if cfg.grower != "compact":
            return None
        cur = cfg.pool_slots if cfg.pool_slots > 0 else cfg.num_leaves
        slots = max(2, cur // 2)
        return slots if slots < cur else None

    def _run_with_oom_degrade(self, thunk):
        """Run a grow with graceful OOM degradation: on a device OOM
        (or an injected one), halve the histogram pool, rebuild the
        grower and retry from the generators' states before the failed
        grow; raise ``LightGBMError`` once no rung is left.

        In a world the ranks agree before each grow, with one ``max``
        ``all_reduce`` of a flag: an injected OOM on any rank (it fires
        before the grow's first collective) degrades every rank, so their
        pools, pool misses and collectives stay in step. A real OOM inside
        a grow raises ``LightGBMError`` on its rank: its peers are already
        in the tree's collectives, so no rank can retry alone."""
        gens = [gen for gen in (self._rounding_gen, self._bynode_gen)
                if gen is not None]
        states = [gen.get_state() for gen in gens]
        while True:
            err = None
            try:
                self._fault_plan.maybe_oom(self.iter_)
            except InjectedResourceExhausted as e:
                err = str(e)
            if self.comm is not None:
                err = self._world_oom(err)
            if err is None:
                try:
                    return thunk()
                except Exception as e:
                    if not is_resource_exhausted(e):
                        raise
                    self._raise_unless_degradable(str(e), e)
            else:
                self._raise_unless_degradable(err)
            # outside the handler: the failed grow's frames (and the
            # tensors they hold) are released by now
            self._degrade_after_oom()
            for gen, state in zip(gens, states):
                gen.set_state(state)

    def _world_oom(self, err: Optional[str]) -> Optional[str]:
        """Every rank's view of the injected OOMs before a grow: this
        rank's message, a peer's stand-in, or None."""
        flag = torch.tensor([0 if err is None else 1], dtype=torch.int32,
                            device=self.device)
        if int(self.comm.all_reduce(flag, "max").item()) and err is None:
            err = (f"RESOURCE_EXHAUSTED: injected device OOM at iteration "
                   f"{self.iter_} on another rank of the world")
        return err

    def _raise_unless_degradable(self, msg: str, exc=None) -> None:
        """Raise ``LightGBMError`` for an OOM no rung can absorb: one
        raised inside a world's grow (``exc``), or any once the pool
        is down to its last rung."""
        from ..basic import LightGBMError
        if exc is not None and self.comm is not None:
            raise LightGBMError(
                f"device RESOURCE_EXHAUSTED in grow at iteration "
                f"{self.iter_} on rank {self.comm.rank} of a world of "
                f"{self.comm.size}: the other ranks are inside the "
                f"tree's collectives, so this rank cannot retry alone "
                f"with a smaller histogram pool (set histogram_pool_size "
                f"and restart the world): {msg}") from exc
        if self._next_pool_slots() is None:
            raise LightGBMError(
                f"device RESOURCE_EXHAUSTED in grow at iteration "
                f"{self.iter_} and no degradation left to try: "
                f"{msg}") from exc

    def _degrade_after_oom(self) -> None:
        """One rung: a grower with half the pool slots, built after the
        old one's buffers are freed."""
        slots = self._next_pool_slots()
        gcfg = self.grower.cfg._replace(pool_slots=slots)
        self.grower = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.grower = Grower(gcfg, *self._grower_args, **self._grower_kw)
        append_fault_event(
            self.fault_log, "oom", self.iter_,
            f"histogram pool -> {slots} slots",
            "RESOURCE_EXHAUSTED in grow; retrying after downgrade")

    def telemetry_comm_stats(self, leaves: Optional[int] = None
                             ) -> Optional[Dict[str, object]]:
        """The iteration's collective payloads for the telemetry recorder:
        the JAX package's modeled bytes (``comms.payload_bytes`` per
        reduction, one reduction per leaf grown; ``leaves`` defaults to
        the ``num_leaves`` budget) and, beside them, ``sent_bytes``: what
        this rank's collectives sent since the last call. None on one
        card."""
        if self.comm is None:
            return None
        from ..parallel import comms
        B, k = self.grower.cfg.num_bins, self.cfg.top_k
        n_red = int(leaves) if leaves is not None \
            else self.cfg.num_leaves * self.K
        per = comms.payload_bytes(self.parallel_mode, self._ncols, B,
                                  self.hist_comm, k)
        post = comms.post_reduction_bytes(
            self.parallel_mode, self._ncols, B, self.comm.size,
            self.split_search, self.hist_comm, k)
        total = sum(self.comm.bytes.values())
        sent, self._comm_sent = total - self._comm_sent, total
        return {"payload_bytes": int(per) * n_red,
                "post_reduction_bytes": int(post) * n_red,
                "hist_comm": self.hist_comm,
                "parallel_mode": self.parallel_mode,
                "split_search": self.split_search,
                "world": self.comm.size, "sent_bytes": int(sent)}

    def telemetry_tree_stats(self) -> Optional[Dict[str, float]]:
        """Leaves grown and split-gain sum of the last iteration's K
        trees (host trees: no device read), for obs/recorder.py; None
        before the first iteration."""
        if self.iter_ <= 0 or len(self.models) < self.K:
            return None
        leaves, gain = 0, 0.0
        for tree in self.models[-self.K:]:
            nl = int(tree.num_leaves)
            leaves += nl
            gain += float(np.sum(
                np.asarray(tree.split_gain)[: max(nl - 1, 0)]))
        return {"trees": self.K, "leaves": leaves, "split_gain_sum": gain}

    # -- linear leaves (LinearTreeLearner::CalculateLinear) ---------------
    def _fit_linear(self, arrays, row_leaf: torch.Tensor,
                    grad: torch.Tensor, hess: torch.Tensor,
                    row_w: Optional[torch.Tensor], is_first: bool):
        """The leaves' linear models of a grown tree: ``(const [L],
        coeff [L, k] or None, train outputs [n], per-leaf inner
        features)``. The first iteration's trees keep their constants."""
        L = arrays.num_leaves
        lv = torch.as_tensor(arrays.leaf_value[:L], device=self.device)
        mappers = self.train_set.mappers
        feats = [[] for _ in range(L)] if is_first \
            else branch_features_per_leaf(
                arrays.split_feature, arrays.left_child,
                arrays.right_child, arrays.leaf_parent, L,
                lambda f: mappers[f].bin_type == BinType.NUMERICAL)
        kmax = max(len(f) for f in feats)
        if kmax == 0:
            return lv, None, lv[row_leaf], feats
        lf = np.zeros((L, kmax), np.int64)
        nf = np.zeros(L, np.int64)
        for i, f in enumerate(feats):
            lf[i, :len(f)] = f
            nf[i] = len(f)
        const, coeff, pred = fit_leaf_linear(
            self.raw, row_leaf, grad, hess, row_w,
            torch.as_tensor(lf, device=self.device),
            torch.as_tensor(nf, device=self.device), lv,
            self.cfg.linear_lambda)
        return const, coeff, pred, feats

    def _attach_linear(self, tree: Tree, lin, shrinkage: float) -> None:
        """The fit into the host tree: real feature ids, scaled by the
        shrinkage in float64, coefficients of magnitude at most 1e-35
        dropped (the JAX ``_attach_linear``)."""
        const, coeff, _, feats = lin
        used = self.train_set.used_feature_indices()
        tree.is_linear = True
        tree.leaf_const = const.cpu().numpy().astype(np.float64) \
            * shrinkage
        cnp = None if coeff is None \
            else coeff.cpu().numpy().astype(np.float64)
        tree.leaf_features, tree.leaf_coeff = [], []
        for i, fl in enumerate(feats):
            fs, cs = [], []
            for j, f in enumerate(fl):
                c = 0.0 if cnp is None else cnp[i, j]
                if abs(c) > 1e-35:
                    fs.append(int(used[f]))
                    cs.append(c * shrinkage)
            tree.leaf_features.append(fs)
            tree.leaf_coeff.append(cs)

    def _tree_values(self, tree: Tree, dataset) -> torch.Tensor:
        """:func:`tree_values`, over the bundled matrix for the train
        set of a bundled run."""
        if dataset is not self.train_set:
            return tree_values(tree, dataset)
        out = tree_values(tree, dataset, self.bundle)
        return out if self._rows is None else out[self._rows[0]:
                                                  self._rows[1]]

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
        resid = obj.renew_residual(base, self.label)
        # a world's percentiles are over the world's rows
        out = renew_leaf_values(
            self._gather(row_leaf), self._gather(resid), self._gather(rw),
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

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's K trees and take their outputs out
        of the train and valid scores (RollbackOneIter); random forests
        undo one step of the running average."""
        if not self.models:
            return
        is_rf = self.cfg.boosting == "rf"
        m = self.iter_ - 1              # iterations left after it
        for k in reversed(range(self.K)):
            tree = self.models.pop()
            if is_rf:
                dv = self._tree_values(tree, self.train_set)
                self.score[k] = (self.score[k] * (m + 1) - dv) / m if m \
                    else torch.full_like(self.score[k],
                                         float(self.init_score[k]))
                for v in self.valid_sets:
                    vv = self._tree_values(tree, v.dataset)
                    v.score[k] = (v.score[k] * (m + 1) - vv) / m if m \
                        else torch.zeros_like(v.score[k])
                continue
            if tree.num_leaves > 1 or tree.leaf_value[0] != 0.0:
                self.score[k] -= self._tree_values(tree, self.train_set)
                if m == 0 and self._fold_bias:
                    # the tree carried the folded init score, which the
                    # train score started from
                    self.score[k] += float(self.init_score[k])
                for v in self.valid_sets:
                    v.score[k] -= self._tree_values(tree, v.dataset)
        self.iter_ -= 1
        self._finished_natural = False

    # -- evaluation ------------------------------------------------------
    def eval_metrics(self, metrics, data_idx: int) -> Dict[str, float]:
        """``{name: value}`` of every metric on the train set
        (``data_idx`` 0) or valid set ``data_idx - 1``."""
        if data_idx == 0:
            score, ds = self.score, self.train_set
            # a world's train metrics are over the world's rows (valid
            # sets are replicated: every rank scores the whole set)
            label = self._gather(self.label)
            weight = None if self.weight is None \
                else self._gather(self.weight)
            if self._sharded_rows:
                score = self._gather(score)
                ds = self._world_queries()
        else:
            v = self.valid_sets[data_idx - 1]
            score, ds = v.score, v.dataset
            label = torch.as_tensor(np.asarray(ds.get_label()),
                                    dtype=torch.float32, device=self.device)
            w = ds.get_weight()
            weight = None if w is None else torch.as_tensor(
                np.asarray(w), dtype=torch.float32, device=self.device)
        convert = self.objective.convert_output \
            if self.objective is not None else (lambda s: s)
        out = {}
        for m in metrics:
            if hasattr(m, "eval_with_query"):
                val = m.eval_with_query(score, label, weight, ds, convert)
            else:
                val = m.eval(score, label, weight, convert)
            out[m.name] = float(val)
        return out

    def _world_queries(self):
        """The world's query boundaries of the train set, for ranking
        metrics (each rank holds whole queries of its shard)."""
        if getattr(self, "_wq", None) is None:
            qb = self.train_set.query_boundaries()

            class _Queries:
                def __init__(self, b):
                    self.b = b

                def query_boundaries(self):
                    return self.b
            glob = None
            if qb is not None:
                from ..parallel.hostsync import host_allgather
                sizes = np.diff(np.asarray(qb, np.int64))
                ng = host_allgather(np.asarray([len(sizes)], np.int64),
                                    "gbdt/train_queries")[:, 0]
                pad = np.zeros(int(ng.max()), np.int64)
                pad[:len(sizes)] = sizes
                g = host_allgather(pad, "gbdt/train_query_sizes")
                allsz = np.concatenate([g[r, :int(c)]
                                        for r, c in enumerate(ng)])
                glob = np.concatenate([[0], np.cumsum(allsz)])
            self._wq = _Queries(glob)
        return self._wq

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
