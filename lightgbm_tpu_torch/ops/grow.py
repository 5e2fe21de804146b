"""Leaf-wise tree growth with rows kept physically grouped by leaf.

Counterpart of the JAX compact grower (``lightgbm_tpu/ops/grow.py``
``_grow_compact_impl``) for the main path: ``num_leaves``, ``num_bins``,
``max_depth`` and the numerical split search. Its semantics are the JAX
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
from .partition import partition_window
from .quantize import dequantize, discretize
from .split import F_, FIELDS, SplitParams, find_best_split, leaf_output

__all__ = ["GrowConfig", "TreeArrays", "Grower", "grow_tree"]

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


class TreeArrays(NamedTuple):
    """Flat host tree, the fields of the JAX ``TreeArrays`` (numerical
    splits only). Sizes: L leaves, L-1 internal nodes."""
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
    )


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


class Grower:
    """Grows trees over one dataset's row-major ``[n, F]`` bin tensor.

    The ping-pong buffers (``2 * n * (F + 12)`` bytes, ``2 * n * (F + 6)``
    when quantized) and the per-leaf histogram cache (``L * F * B * 8``
    bytes, f32 or int32) are allocated once and reused by every tree."""

    def __init__(self, cfg: GrowConfig, bins: torch.Tensor,
                 feat_num_bins, feat_nan_bin, feature_mask=None):
        n, F = bins.shape
        dev = bins.device
        L, B = cfg.num_leaves, cfg.num_bins
        self.cfg, self.n, self.F, self.dev = cfg, n, F, dev
        self.bins = bins
        self.fnb = torch.as_tensor(np.asarray(feat_num_bins, np.int64),
                                   device=dev)
        self.fnan_host = np.asarray(feat_nan_bin, np.int64)
        self.fnan = torch.as_tensor(self.fnan_host, device=dev)
        fm = np.ones(F, bool) if feature_mask is None \
            else np.asarray(feature_mask, bool)
        self.fmask = torch.as_tensor(fm, device=dev)
        self.bins2 = torch.empty((2, n, F), dtype=bins.dtype, device=dev)
        q = cfg.quantized
        self.pay2 = torch.empty((2, n, 2), device=dev,
                                dtype=torch.int8 if q else torch.float32)
        self.ids2 = torch.empty((2, n), dtype=torch.int32, device=dev)
        self.hists = torch.empty((L, F, B, 2), device=dev,
                                 dtype=torch.int32 if q else torch.float32)
        self.best = torch.empty((L, NF), dtype=torch.float32, device=dev)
        self.row_ids = torch.arange(n, dtype=torch.int32, device=dev)

    def _search(self, hist2, g, h, c):
        return find_best_split(hist2, g, h, c, self.fnb, self.fnan,
                               self.fmask, self.cfg.split)

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             noise: torch.Tensor = None):
        """Grow one tree on f32 ``[n]`` gradients/hessians. ``noise`` is
        the ``[n, 2]`` uniform draw of stochastic rounding when quantized
        (None: round to nearest). Returns ``(TreeArrays, row_leaf [n]
        int64 tensor on the device)``."""
        cfg, n, p = self.cfg, self.n, self.cfg.split
        L, B = cfg.num_leaves, cfg.num_bins
        self.bins2[0].copy_(self.bins)
        pay = self.pay2[0]
        self.ids2[0].copy_(self.row_ids)

        # ---- root ----
        if cfg.quantized:
            q, scale2 = discretize(grad, hess, None, cfg.quant_bins, noise)
            pay.copy_(q)

            def hist_f(h):
                return dequantize(h, scale2)
        else:
            pay[:, 0] = grad
            pay[:, 1] = hess

            def hist_f(h):
                return h
        # the float path's fixed-point scale bound for every window of the
        # tree: one amax, kept on the device
        absmax = None if cfg.quantized else pay.abs().amax(dim=0)
        root_hist = window_hist(self.bins2[0], pay, B, 0, n,
                                pay_absmax=absmax)
        self.hists[0] = root_hist
        if cfg.quantized:
            # every row hits feature 0 once
            tg, th = hist_f(root_hist[0]).sum(dim=0).unbind()
        else:
            tg = pay[:, 0].sum()
            th = pay[:, 1].sum()
        tc = torch.full((), float(n), dtype=torch.float32, device=self.dev)
        rec = self._search(hist_f(root_hist)[None], tg[None], th[None],
                           tc[None])
        self.best[0] = rec[0]
        host = torch.cat([rec[0], torch.stack([leaf_output(tg, th, p), th])
                          ]).cpu().numpy()
        t = _init_tree(L)
        t["leaf_value"][0] = host[NF]
        t["leaf_weight"][0] = host[NF + 1]
        t["leaf_count"][0] = n
        best_h = np.zeros((L, NF), np.float32)
        best_h[0] = host[:NF]
        gains = np.full(L, -np.inf, np.float32)
        gains[0] = best_h[0, F_["gain"]]
        leaf_buf = np.zeros(L, np.int64)
        leaf_begin = np.zeros(L, np.int64)
        leaf_count = np.zeros(L, np.int64)
        leaf_count[0] = n

        ns = 0
        while ns < L - 1 and gains.max() > 0.0:
            leaf = int(np.argmax(gains))
            R = ns + 1
            r = best_h[leaf]
            src = int(leaf_buf[leaf])
            dst = 1 - src
            begin, cnt = int(leaf_begin[leaf]), int(leaf_count[leaf])
            f = int(r[F_["feature"]])
            nl = partition_window(
                self.bins2[src], self.bins2[dst], self.pay2[src],
                self.pay2[dst], self.ids2[src], self.ids2[dst], begin, cnt,
                f, int(r[F_["threshold_bin"]]),
                bool(r[F_["default_left"]]), int(self.fnan_host[f]))
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
            rec2 = self._search(
                hist_f(torch.stack([lh, rh])),
                torch.stack([pb[F_["left_sum_g"]], pb[F_["right_sum_g"]]]),
                torch.stack([pb[F_["left_sum_h"]], pb[F_["right_sum_h"]]]),
                cnt2)
            self.best[leaf] = rec2[0]
            self.best[R] = rec2[1]
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
        row_leaf = self._row_leaf(nleaves, leaf_buf, leaf_begin,
                                  leaf_count)
        if cfg.quantized and cfg.renew_leaf:
            t["leaf_value"][:nleaves] = self._renewed_leaf_values(
                grad, hess, row_leaf, nleaves)
        return TreeArrays(**t), row_leaf

    def _row_leaf(self, nleaves, leaf_buf, leaf_begin, leaf_count):
        """Leaf of every row, from the row ids of the final windows (the
        windows partition ``[0, n)``)."""
        if nleaves <= 1:
            return torch.zeros(self.n, dtype=torch.int64, device=self.dev)
        leaves = np.argsort(leaf_begin[:nleaves], kind="stable")
        counts = torch.as_tensor(leaf_count[leaves], device=self.dev)
        buf = torch.repeat_interleave(
            torch.as_tensor(leaf_buf[leaves], device=self.dev), counts,
            output_size=self.n)
        lid = torch.repeat_interleave(
            torch.as_tensor(leaves.astype(np.int64), device=self.dev),
            counts, output_size=self.n)
        ids = torch.where(buf == 0, self.ids2[0], self.ids2[1]).to(
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
