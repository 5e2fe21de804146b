"""Leaf-wise tree growth with rows kept physically grouped by leaf.

Counterpart of the JAX compact grower (``lightgbm_tpu/ops/grow.py``
``_grow_compact_impl``): ``num_leaves``, ``num_bins``, ``max_depth``,
the numerical and categorical split search and basic monotone bounds.
Its semantics are the JAX
grower's; its mechanics are a GPU's:

- Every leaf owns a contiguous window ``[leaf_begin, leaf_begin +
  leaf_count)`` of one buffer of a ping-pong pair (``leaf_buf``). A
  buffer row is the row's bins, its (grad, hess) payload and its row id.
- A split moves the parent's window into the other buffer with kernel
  K2 (:func:`ops.partition.partition_window`): the left child keeps the
  front of the window, the right child the back. The sibling windows of
  other leaves are untouched.
- Kernel K1 (:func:`ops.histogram.window_hist`) builds the histogram of
  the child that the search-time count estimates call smaller (the JAX
  ``est_left_small`` rule); the other child's is the parent's minus it.
  On the float path K1 sums in fixed point scaled by the payload's max
  magnitude: one amax over the tree's payload at the root, kept on the
  device, serves every window of the tree.
- Both children are searched in one batched call
  (:func:`ops.split.find_best_split`) and their records are read back
  with the exact left count in ONE transfer — the only host
  synchronisation per split. The host keeps the tree arrays and picks
  the next leaf (first maximum of the stored gains, as ``jnp.argmax``).
- ``row_leaf`` comes from the row ids of the final windows.

Quantized-gradient training (``GrowConfig.quantized``, the JAX
``cfg.quantized`` path) runs the same loop on int8 pairs:

- :func:`ops.quantize.discretize` scales and rounds the tree's
  gradients and hessians to an int8 ``[n, 2]`` payload (stochastically
  with the caller's ``noise``); the ping-pong payload buffers hold int8
  pairs (2 bytes a row, moved by K2 as one 16-bit word), K1 runs its int
  path and the histogram cache is int32, so sibling subtraction is exact;
- the root totals are the dequantized feature-0 row of the root
  histogram (every row hits feature 0 once), not float sums, as in JAX;
- every split search gets dequantized histograms;
- with ``renew_leaf`` the leaf outputs are refitted at the end from the
  float (not quantized) gradient and hessian sums of each leaf's rows
  (RenewIntGradTreeOutput).

Row weights (bagging, GOSS; the JAX ``row_weight`` argument): the
payload is ``(g * w, h * w)``, and before the root the in-bag rows
(``w > 0``) are gathered, in row order, to the front of the first
buffer, so the tree grows over the window ``[0, n_in_bag)`` (LightGBM's
``bag_data_indices_``). Every count (the root's, the children's from
K2, every ``min_data_in_leaf`` test) is then an in-bag count, as the JAX
grower's ``_IB_BIT`` counts are, and K1 and K2 run unchanged on smaller
windows. The float root totals stay sums over all ``n`` weighted rows,
as in JAX (out-of-bag rows add +0.0). Quantization and its noise run
over all ``n`` rows before the gather, as in JAX. Out-of-bag rows get
their leaf by routing their bins through the finished tree
(:func:`ops.predict.predict_leaf_binned`).

Exclusive feature bundling (the JAX grower's ``bundled`` branches): with
a ``bundle`` (``ops/bundling.py`` ``BundleInfo``) the grower runs on the
bundled ``[n, G]`` matrix — K1 at ``G`` columns and ``B =
num_positions``, the histogram cache ``[L, G, B, 2]``, the search
:func:`ops.split.find_best_split_bundled`, and K2 and the out-of-bag walk
on the range rule of each split's bundle column
(:class:`ops.partition.RangeRules`). The records, ``TreeArrays`` and
``row_leaf`` keep original feature ids and member-local thresholds, so
the model does not depend on the bundling.

Categorical splits (``feat_is_cat``, the JAX grower's ``has_cat``
branches): the search returns each candidate's ``[B]`` mask of the local
bins sent left beside its record; the grower keeps the leaves' masks and
the splits' (``[L - 1, B]``) on the device, K2 routes a categorical
split by a bitset made from its mask on the device
(:meth:`ops.partition.RangeRules.bitsets`), and the splits' masks come
to the host once per tree, when the tree is written. The record's
``direction`` (>= 2 for a categorical winner) tells the host which rule
to use, so a split still takes one read-back.

Monotone constraints (``monotone``, the ``basic`` method) and
``path_smooth``: each leaf keeps its output bounds ``(min, max)`` as
host float32 (``BasicLeafConstraints``: after a numerical split on a
constrained feature, the children's bounds meet at ``(wl + wr) / 2``;
categorical splits pass the parent's bounds down), and each child's
search gets the two children's ``[2, 2]`` bounds, their own outputs as
the parents of smoothing (from the device record, no read-back) and
their depth (the monotone penalty).

Column sampling: ``grow`` takes the tree's ``feature_mask``
(``feature_fraction``) and, with ``GrowConfig.bynode < 1``, a function
giving the uniform ``[F]`` draw of node ``i`` (0 for the root, ``2 *
ns + 1`` and ``2 * ns + 2`` for the children of split ``ns``): each node
searches the ``max(1, round(bynode * |usable|))`` usable features of
smallest draw (the JAX ``node_feature_mask``).

Int32 range: an entry of a window's histogram is at most ``cnt *
quant_bins`` in magnitude (``cnt * 127`` for any int8 payload), so the
exact int32 sums hold for ``n < 2**31 / quant_bins`` rows (16.9M for any
payload), the JAX package's limit too.

The TPU workarounds of the JAX grower (packed u32 bin words, group
sorts, K-row chunking, the nibble-matmul histogram) have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .histogram import subtract_histogram, window_hist
from .partition import RangeRules, partition_window
from .predict import predict_leaf_binned
from .quantize import dequantize, discretize
from .split import (F_, FIELDS, BundleTables, SplitParams, find_best_split,
                    find_best_split_bundled, leaf_output)

__all__ = ["GrowConfig", "TreeArrays", "Grower", "grow_tree", "root_totals"]

NF = len(FIELDS)


class GrowConfig(NamedTuple):
    num_leaves: int
    num_bins: int
    max_depth: int = -1
    split: SplitParams = SplitParams()
    # quantized-gradient training (use_quantized_grad,
    # num_grad_quant_bins, quant_train_renew_leaf)
    quantized: bool = False
    quant_bins: int = 4
    renew_leaf: bool = False
    # feature_fraction_bynode
    bynode: float = 1.0


class TreeArrays(NamedTuple):
    """Flat host tree, the fields of the JAX ``TreeArrays``. Sizes: L
    leaves, L-1 internal nodes, B bins."""
    split_feature: np.ndarray    # [L-1] i32
    threshold_bin: np.ndarray    # [L-1] i32
    default_left: np.ndarray     # [L-1] bool
    left_child: np.ndarray       # [L-1] i32 (~leaf for leaves)
    right_child: np.ndarray      # [L-1] i32
    split_gain: np.ndarray       # [L-1] f32
    internal_value: np.ndarray   # [L-1] f32
    internal_weight: np.ndarray  # [L-1] f32
    internal_count: np.ndarray   # [L-1] f32
    leaf_value: np.ndarray       # [L] f32
    leaf_weight: np.ndarray      # [L] f32
    leaf_count: np.ndarray       # [L] f32
    leaf_parent: np.ndarray      # [L] i32
    leaf_depth: np.ndarray       # [L] i32
    num_leaves: int
    split_is_cat: np.ndarray     # [L-1] bool categorical membership split
    split_cat_mask: np.ndarray   # [L-1, B] bool local bins sent left


def _init_tree(L: int) -> dict:
    f32 = np.float32
    return dict(
        split_feature=np.zeros(L - 1, np.int32),
        threshold_bin=np.zeros(L - 1, np.int32),
        default_left=np.zeros(L - 1, bool),
        left_child=np.zeros(L - 1, np.int32),
        right_child=np.zeros(L - 1, np.int32),
        split_gain=np.zeros(L - 1, f32),
        internal_value=np.zeros(L - 1, f32),
        internal_weight=np.zeros(L - 1, f32),
        internal_count=np.zeros(L - 1, f32),
        leaf_value=np.zeros(L, f32),
        leaf_weight=np.zeros(L, f32),
        leaf_count=np.zeros(L, f32),
        leaf_parent=np.full(L, -1, np.int32),
        leaf_depth=np.zeros(L, np.int32),
        num_leaves=1,
        split_is_cat=np.zeros(L - 1, bool),
    )


def _take_rows(src: torch.Tensor, idx: torch.Tensor,
               out: torch.Tensor = None) -> torch.Tensor:
    """``src[idx]`` along rows; uint16 is gathered through its int16 bits
    (gathers of uint16 are not implemented on CUDA)."""
    wide = src.dtype == torch.uint16
    s = src.view(torch.int16) if wide else src
    if out is None:
        got = s.index_select(0, idx)
        return got.view(torch.uint16) if wide else got
    torch.index_select(s, 0, idx,
                       out=out.view(torch.int16) if wide else out)
    return out


def _apply_split(t: dict, rec: np.ndarray, leaf: int, R: int, ns: int,
                 lcnt: float, rcnt: float) -> None:
    """Record split ``ns`` of leaf slot ``leaf`` (Tree::Split): the left
    child keeps the slot, the right child takes slot ``R``; the counts
    are the exact partition counts."""
    parent = t["leaf_parent"][leaf]
    lc, rc = t["left_child"], t["right_child"]
    if parent >= 0:
        if lc[parent] == ~leaf:
            lc[parent] = ns
        if rc[parent] == ~leaf:
            rc[parent] = ns
    lc[ns] = ~leaf
    rc[ns] = ~R
    t["split_feature"][ns] = int(rec[F_["feature"]])
    t["threshold_bin"][ns] = int(rec[F_["threshold_bin"]])
    t["default_left"][ns] = bool(rec[F_["default_left"]])
    t["split_is_cat"][ns] = rec[F_["direction"]] >= 2
    t["split_gain"][ns] = rec[F_["gain"]]
    t["internal_value"][ns] = rec[F_["parent_output"]]
    t["internal_weight"][ns] = rec[F_["left_sum_h"]] + rec[F_["right_sum_h"]]
    t["internal_count"][ns] = np.float32(lcnt) + np.float32(rcnt)
    t["leaf_value"][leaf] = rec[F_["left_output"]]
    t["leaf_value"][R] = rec[F_["right_output"]]
    t["leaf_weight"][leaf] = rec[F_["left_sum_h"]]
    t["leaf_weight"][R] = rec[F_["right_sum_h"]]
    t["leaf_count"][leaf] = lcnt
    t["leaf_count"][R] = rcnt
    t["leaf_parent"][leaf] = ns
    t["leaf_parent"][R] = ns
    depth = t["leaf_depth"][leaf] + 1
    t["leaf_depth"][leaf] = depth
    t["leaf_depth"][R] = depth
    t["num_leaves"] += 1


def root_totals(full: torch.Tensor):
    """The float path's root totals: the sums of the weighted gradients
    and hessians ``[n, 2]`` over every row, in float32. The order of the
    sum is torch's, not XLA's, so the totals can differ from the JAX
    package's by an ulp; a child whose hessian sum is the parent's less
    a nearly equal sum carries that ulp into its output (ROADMAP.md
    Queue 3). The CPU tests hand in XLA's sums through this function."""
    return full[:, 0].sum(), full[:, 1].sum()


class Grower:
    """Grows trees over one dataset's row-major ``[n, F]`` bin tensor, or
    with a ``bundle``, over its bundled ``[n, G]`` matrix
    (``bundle.bins_bundled``; ``bins`` is then None).

    The ping-pong buffers (``2 * n * (C + 12)`` bytes, ``2 * n * (C + 6)``
    when quantized, for ``C`` bin columns) and the per-leaf histogram
    cache (``L * C * B * 8`` bytes, f32 or int32) are allocated once and
    reused by every tree."""

    def __init__(self, cfg: GrowConfig, bins: torch.Tensor,
                 feat_num_bins, feat_nan_bin, feature_mask=None,
                 bundle=None, feat_is_cat=None, monotone=None):
        if bundle is not None:
            bins = bundle.bins_bundled
        n, C = bins.shape
        dev = bins.device
        L, B = cfg.num_leaves, cfg.num_bins
        F = len(feat_num_bins)
        self.cfg, self.n, self.F, self.dev = cfg, n, F, dev
        self.bins = bins
        self.bundled = bundle is not None
        self.tables = BundleTables.of(bundle, dev) if self.bundled else None
        self.rules = RangeRules(feat_num_bins, feat_nan_bin, bundle)
        self.fnb = torch.as_tensor(np.asarray(feat_num_bins, np.int64),
                                   device=dev)
        self.fnan_host = np.asarray(feat_nan_bin, np.int64)
        self.fnan = torch.as_tensor(self.fnan_host, device=dev)
        fm = np.ones(F, bool) if feature_mask is None \
            else np.asarray(feature_mask, bool)
        self.fmask_host = fm
        self.fmask = torch.as_tensor(fm, device=dev)
        self.bins2 = torch.empty((2, n, C), dtype=bins.dtype, device=dev)
        q = cfg.quantized
        self.pay2 = torch.empty((2, n, 2), device=dev,
                                dtype=torch.int8 if q else torch.float32)
        self.ids2 = torch.empty((2, n), dtype=torch.int32, device=dev)
        self.hists = torch.empty((L, C, B, 2), device=dev,
                                 dtype=torch.int32 if q else torch.float32)
        self.best = torch.empty((L, NF), dtype=torch.float32, device=dev)
        self.row_ids = torch.arange(n, dtype=torch.int32, device=dev)
        # categorical features: the leaves' and the splits' masks
        self.fcat = None
        if feat_is_cat is not None and np.any(feat_is_cat):
            self.fcat = torch.as_tensor(np.asarray(feat_is_cat, bool),
                                        device=dev)
            self.best_mask = torch.zeros((L, B), dtype=torch.bool,
                                         device=dev)
            self.split_mask = torch.zeros((max(L - 1, 1), B),
                                          dtype=torch.bool, device=dev)
        # monotone signs (None: unconstrained; all zeros still takes the
        # exact-output search, as in the JAX grower)
        self.mono_host = self.mono = None
        if monotone is not None:
            self.mono_host = np.asarray(monotone, np.int8)
            self.mono = torch.as_tensor(self.mono_host, device=dev)

    def _search(self, slot, hist2, g, h, c, fmask, p_out, depth, bounds):
        """Search the ``C`` leaves of ``hist2`` and store their records
        (and masks) at leaf slots ``slot``; returns the records."""
        p = self.cfg.split
        if self.bundled:
            out = find_best_split_bundled(
                hist2, g, h, c, self.tables, fmask, p, self.fcat, self.fnb,
                self.mono, p_out, depth, bounds)
        else:
            out = find_best_split(hist2, g, h, c, self.fnb, self.fnan,
                                  fmask, p, self.fcat, self.mono, p_out,
                                  depth, bounds)
        if self.fcat is not None:
            out, masks = out
            for i, leaf in enumerate(slot):
                self.best_mask[leaf] = masks[i]
        for i, leaf in enumerate(slot):
            self.best[leaf] = out[i]
        return out

    def _node_mask(self, u: torch.Tensor, fmask: torch.Tensor,
                   usable: int) -> torch.Tensor:
        """ColSampler::GetByNode as the JAX ``node_feature_mask``: the
        ``max(round(bynode * usable), min(1, usable))`` features of
        ``fmask`` with the smallest draws ``u`` (float32 product, ties
        to the lower feature)."""
        u = torch.where(fmask, u.to(self.dev), torch.inf)
        rank = torch.argsort(torch.argsort(u, stable=True), stable=True)
        k = max(int(np.round(np.float32(usable)
                             * np.float32(self.cfg.bynode))), min(1, usable))
        return (rank < k) & fmask

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             noise: torch.Tensor = None, row_weight: torch.Tensor = None,
             feature_mask=None, node_uniform=None):
        """Grow one tree on f32 ``[n]`` gradients/hessians. ``noise`` is
        the ``[n, 2]`` uniform draw of stochastic rounding when quantized
        (None: round to nearest). ``row_weight``: f32 ``[n]`` bagging or
        GOSS weights (None: every row once). ``feature_mask``: the
        tree's usable features (None: the grower's). ``node_uniform(i)``:
        the ``[F]`` uniform draw of node ``i`` when ``cfg.bynode < 1``.
        Returns ``(TreeArrays, row_leaf [n] int64 tensor on the
        device)``."""
        cfg, n, p = self.cfg, self.n, self.cfg.split
        L, B = cfg.num_leaves, cfg.num_bins
        fm = self.fmask_host if feature_mask is None \
            else np.asarray(feature_mask, bool)
        fmask = self.fmask if feature_mask is None \
            else torch.as_tensor(fm, device=self.dev)
        usable = int(fm.sum())
        bynode = cfg.bynode < 1.0
        pay = self.pay2[0]
        if row_weight is not None:
            grad, hess = grad * row_weight, hess * row_weight
        # the tree's payload over all n rows, in row order
        if cfg.quantized:
            full, scale2 = discretize(grad, hess, None, cfg.quant_bins,
                                      noise)
        else:
            full = torch.stack([grad, hess], dim=1)

        def hist_f(h):
            return dequantize(h, scale2) if cfg.quantized else h
        if row_weight is None:
            m, oob = n, None
            self.bins2[0].copy_(self.bins)
            pay.copy_(full)
            self.ids2[0].copy_(self.row_ids)
        else:
            # the in-bag rows, in row order, to the front of buffer 0
            inbag = torch.nonzero(row_weight > 0)[:, 0]
            m = int(inbag.numel())
            _take_rows(self.bins, inbag, self.bins2[0, :m])
            _take_rows(full, inbag, pay[:m])
            self.ids2[0, :m] = inbag.to(torch.int32)
            oob = torch.nonzero(row_weight <= 0)[:, 0] if m < n else None

        # ---- root ----
        # the float path's fixed-point scale bound for every window of the
        # tree: one amax, kept on the device
        absmax = None if cfg.quantized or m == 0 \
            else pay[:m].abs().amax(dim=0)
        root_hist = window_hist(self.bins2[0], pay, B, 0, m,
                                pay_absmax=absmax)
        self.hists[0] = root_hist
        if cfg.quantized:
            # every row hits feature 0 once
            tg, th = hist_f(root_hist[0]).sum(dim=0).unbind()
        else:
            tg, th = root_totals(full)
        tc = torch.full((), float(m), dtype=torch.float32, device=self.dev)
        root_mask = self._node_mask(node_uniform(0), fmask, usable) \
            if bynode else fmask
        root_out = leaf_output(tg, th, p)
        # monotone output bounds per leaf, on the host (basic method)
        has_mono = self.mono is not None
        lmin = np.full(L, -np.inf, np.float32)
        lmax = np.full(L, np.inf, np.float32)
        rec = self._search([0], hist_f(root_hist)[None], tg[None], th[None],
                           tc[None], root_mask, root_out[None], 0,
                           self._bounds([0], lmin, lmax) if has_mono
                           else None)
        host = torch.cat([rec[0], torch.stack([root_out, th])
                          ]).cpu().numpy()
        t = _init_tree(L)
        t["leaf_value"][0] = host[NF]
        t["leaf_weight"][0] = host[NF + 1]
        t["leaf_count"][0] = m
        best_h = np.zeros((L, NF), np.float32)
        best_h[0] = host[:NF]
        gains = np.full(L, -np.inf, np.float32)
        gains[0] = best_h[0, F_["gain"]]
        leaf_buf = np.zeros(L, np.int64)
        leaf_begin = np.zeros(L, np.int64)
        leaf_count = np.zeros(L, np.int64)
        leaf_count[0] = m

        ns = 0
        while ns < L - 1 and gains.max() > 0.0:
            leaf = int(np.argmax(gains))
            R = ns + 1
            r = best_h[leaf]
            src = int(leaf_buf[leaf])
            dst = 1 - src
            begin, cnt = int(leaf_begin[leaf]), int(leaf_count[leaf])
            f_split = int(r[F_["feature"]])
            is_cat = r[F_["direction"]] >= 2
            col, lo, hi, nan_pos = self.rules(f_split,
                                              int(r[F_["threshold_bin"]]))
            bits = None
            if is_cat:
                self.split_mask[ns] = self.best_mask[leaf]
                bits = self.rules.bitsets([f_split],
                                          self.best_mask[leaf][None], B)[0]
            nl = partition_window(
                self.bins2[src], self.bins2[dst], self.pay2[src],
                self.pay2[dst], self.ids2[src], self.ids2[dst], begin, cnt,
                col, lo, hi, nan_pos, bool(r[F_["default_left"]]), bits)
            est_left_small = r[F_["left_count"]] <= r[F_["right_count"]]
            small = window_hist(self.bins2[dst], self.pay2[dst], B, begin,
                                cnt, nl, 1 if est_left_small else 2,
                                pay_absmax=absmax)
            other = subtract_histogram(self.hists[leaf], small)
            lh, rh = (small, other) if est_left_small else (other, small)
            self.hists[leaf] = lh
            self.hists[R] = rh
            nlf = nl.to(torch.float32)
            cnt2 = torch.cat([nlf, float(cnt) - nlf])
            pb = self.best[leaf]
            mask2 = fmask
            if bynode:
                mask2 = torch.stack([
                    self._node_mask(node_uniform(2 * ns + 1), fmask, usable),
                    self._node_mask(node_uniform(2 * ns + 2), fmask,
                                    usable)])
            bounds2 = None
            if has_mono:
                self._update_bounds(lmin, lmax, leaf, R, r, f_split, is_cat)
                bounds2 = self._bounds([leaf, R], lmin, lmax)
            rec2 = self._search(
                [leaf, R], hist_f(torch.stack([lh, rh])),
                torch.stack([pb[F_["left_sum_g"]], pb[F_["right_sum_g"]]]),
                torch.stack([pb[F_["left_sum_h"]], pb[F_["right_sum_h"]]]),
                cnt2, mask2,
                torch.stack([pb[F_["left_output"]], pb[F_["right_output"]]]),
                int(t["leaf_depth"][leaf]) + 1, bounds2)
            host = torch.cat([rec2.reshape(-1).double(),
                              nl.double()]).cpu().numpy()
            n_left = int(host[2 * NF])
            _apply_split(t, r, leaf, R, ns, n_left, cnt - n_left)
            leaf_buf[leaf] = leaf_buf[R] = dst
            leaf_count[leaf] = n_left
            leaf_begin[R] = begin + n_left
            leaf_count[R] = cnt - n_left
            best_h[leaf] = host[:NF]
            best_h[R] = host[NF:2 * NF]
            depth_ok = cfg.max_depth <= 0 \
                or t["leaf_depth"][leaf] < cfg.max_depth
            gains[leaf] = best_h[leaf, F_["gain"]] if depth_ok else -np.inf
            gains[R] = best_h[R, F_["gain"]] if depth_ok else -np.inf
            ns += 1

        nleaves = t["num_leaves"]
        nn = nleaves - 1
        cat_masks = None
        if self.fcat is not None and t["split_is_cat"][:nn].any():
            # the tree's one read-back of its masks
            cat_masks = self.split_mask[:nn]
            t["split_cat_mask"] = np.zeros((L - 1, B), bool)
            t["split_cat_mask"][:nn] = cat_masks.cpu().numpy()
        else:
            t["split_cat_mask"] = np.zeros((L - 1, B), bool)
        row_leaf = self._row_leaf(nleaves, leaf_buf, leaf_begin,
                                  leaf_count, m)
        if oob is not None and nleaves > 1:
            row_leaf[oob] = predict_leaf_binned(
                t["split_feature"][:nn], t["threshold_bin"][:nn],
                t["default_left"][:nn], t["left_child"][:nn],
                t["right_child"][:nn], self.fnan_host,
                _take_rows(self.bins, oob),
                int(t["leaf_depth"][:nleaves].max()), rules=self.rules,
                is_cat=t["split_is_cat"][:nn], cat_masks=cat_masks)
        if cfg.quantized and cfg.renew_leaf:
            t["leaf_value"][:nleaves] = self._renewed_leaf_values(
                grad, hess, row_leaf, nleaves)
        return TreeArrays(**t), row_leaf

    def _bounds(self, leaves, lmin, lmax) -> torch.Tensor:
        """``[C, 2]`` f32 ``(min, max)`` output bounds of ``leaves``."""
        return torch.as_tensor(np.stack([lmin[leaves], lmax[leaves]], 1),
                               device=self.dev)

    def _update_bounds(self, lmin, lmax, leaf, R, r, f, is_cat) -> None:
        """BasicLeafConstraints::Update for split record ``r`` of ``leaf``
        (children ``leaf`` and ``R``): a numerical split on an increasing
        feature caps the left child and floors the right one at ``(wl +
        wr) / 2``, a decreasing one the other way round; otherwise both
        children keep the parent's bounds."""
        pmin, pmax = lmin[leaf], lmax[leaf]
        mc = 0 if is_cat else int(self.mono_host[f])
        mid = (r[F_["left_output"]] + r[F_["right_output"]]) \
            * np.float32(0.5)
        lmin[leaf] = max(pmin, mid) if mc < 0 else pmin
        lmax[leaf] = min(pmax, mid) if mc > 0 else pmax
        lmin[R] = max(pmin, mid) if mc > 0 else pmin
        lmax[R] = min(pmax, mid) if mc < 0 else pmax

    def _row_leaf(self, nleaves, leaf_buf, leaf_begin, leaf_count, m):
        """Leaf of every row of the final windows (which partition ``[0,
        m)``: every row, or the in-bag ones), from their row ids; the
        other rows' entries are left for the caller."""
        if nleaves <= 1:
            return torch.zeros(self.n, dtype=torch.int64, device=self.dev)
        leaves = np.argsort(leaf_begin[:nleaves], kind="stable")
        counts = torch.as_tensor(leaf_count[leaves], device=self.dev)
        buf = torch.repeat_interleave(
            torch.as_tensor(leaf_buf[leaves], device=self.dev), counts,
            output_size=m)
        lid = torch.repeat_interleave(
            torch.as_tensor(leaves.astype(np.int64), device=self.dev),
            counts, output_size=m)
        ids = torch.where(buf == 0, self.ids2[0, :m], self.ids2[1, :m]).to(
            torch.int64)
        row_leaf = torch.empty(self.n, dtype=torch.int64, device=self.dev)
        row_leaf[ids] = lid
        return row_leaf

    def _renewed_leaf_values(self, grad, hess, row_leaf, nleaves):
        """RenewIntGradTreeOutput (the end of the JAX grower): every
        leaf's output from the float sums of its rows' gradients and
        hessians. The sums are taken in float64 (atomics on CUDA, so in
        no fixed order): their float32 roundings do not depend on the
        order short of a tie at a rounding boundary."""
        gh = torch.stack([grad, hess], dim=1).to(torch.float64)
        sums = torch.zeros((nleaves, 2), dtype=torch.float64,
                           device=self.dev).index_add_(0, row_leaf, gh)
        sums = sums.to(torch.float32)
        out = leaf_output(sums[:, 0], sums[:, 1], self.cfg.split)
        return out.cpu().numpy()


def grow_tree(cfg: GrowConfig, bins: torch.Tensor, grad: torch.Tensor,
              hess: torch.Tensor, feat_num_bins, feat_nan_bin,
              feature_mask=None):
    """One tree over row-major ``bins`` ``[n, F]``: ``(TreeArrays,
    row_leaf)``."""
    g = Grower(cfg, bins, feat_num_bins, feat_nan_bin, feature_mask)
    return g.grow(grad, hess)
