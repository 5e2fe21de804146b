"""Tree growth: leaf-wise with rows kept physically grouped by leaf, and
its variants (a bounded histogram cache, depth-wise and masked growth).

Counterpart of the JAX compact grower (``lightgbm_tpu/ops/grow.py``
``_grow_compact_impl``): ``num_leaves``, ``num_bins``, ``max_depth``,
the numerical and categorical split search, the three monotone methods,
interaction constraints, forced splits and CEGB. Its semantics are the
JAX grower's; its mechanics are a GPU's:

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

Intermediate and advanced monotone constraints (the JAX grower's
``research_all``): after every split the bounds of every leaf are
refreshed on the host from the current leaf outputs (intermediate: each
leaf under a numerical split on a constrained feature is bounded by the
extreme output of the other subtree, through a ``[L, L - 1]`` ancestry
matrix; advanced: per-threshold bounds from the leaves' bin-space boxes,
:func:`advanced_bounds`, batched over chunks of leaves on the device),
and every leaf is searched again from the histogram cache in one batched
search (:meth:`Grower._research`): its totals from its histogram's
column 0, its exact count (kept on the device), its output as the
parent of smoothing and its depth. The records of every leaf then come
back in the split's one read-back.

Interaction constraints: each leaf keeps the set of features on its
path (host ``[L, F]``); a leaf searches the union of the groups that
hold its whole set (:func:`allowed_features`). Forced splits (the
JSON's nodes in BFS order, leaf slots precomputed) run first: each
takes its record from the leaf's cached histogram
(:func:`ops.split.forced_result`, one read-back) and goes through the
same split body; one with an empty child ends them. CEGB
(:class:`CegbConfig`): each search subtracts a ``[C, F]`` penalty — the
split penalty per in-bag row, the coupled penalty until the model first
uses the feature, the lazy penalty per row of the leaf that has not yet
used it. The rows of a split leaf's window (its in-bag rows) acquire the
split feature in the model's ``[n, F]`` bool matrix
(:class:`CegbState`), read through the row ids K2 wrote, and the
smaller child's count of rows still to acquire is summed from them; a
coupled feature's first use re-searches every leaf.

Column sampling: ``grow`` takes the tree's ``feature_mask``
(``feature_fraction``) and, with ``GrowConfig.bynode < 1``, a function
giving the uniform ``[F]`` draw of node ``i`` (0 for the root, ``2 *
ns + 1`` and ``2 * ns + 2`` for the children of split ``ns``): each node
searches the ``max(1, round(bynode * |usable|))`` usable features of
smallest draw (the JAX ``node_feature_mask``).

The histogram pool (``GrowConfig.pool_slots``, ``histogram_pool_size``;
the JAX grower's ``hist_pool_slots``): the cache holds ``PS <
num_leaves`` histograms; the host maps leaves to slots (``leaf2slot``,
``slot2leaf``) and stamps each slot with the split that last stored in
it. A split whose leaf has no slot recomputes the leaf's histogram from
its window with K1 (at the tree's fixed-point bound) before K2 moves the
rows; its left child keeps the leaf's slot (or takes the least recently
stamped one), its right child the least recently stamped other slot,
whose leaf loses it. Forced splits and the re-search read an evicted
leaf's histogram the same way. Quantized histograms are exact, so a
pooled quantized tree equals the unpooled one; a recomputed float
histogram can differ from a cached difference in the last bit, as in
the JAX package.

The level grower (``GrowConfig.grower="level"``, the JAX
``_grow_level_impl``) grows depth-wise on the same layout: per level it
elects the frontier leaves of positive gain, the best first (a stable
sort, ties to the lower slot) while the leaf budget lasts; K2 partitions
every elected leaf's window (the right child of the ``j``-th elected
leaf, in slot order, takes slot ``ns + 1 + j`` and node ``ns + j``); one
read-back brings the level's left counts; K1 builds every smaller child
(by the exact counts) and its sibling is the parent less it; the whole
new frontier is searched in one batched call, its totals from each
histogram's feature-0 row (:func:`leaf_totals`), and a second read-back
brings its records: two read-backs per level instead of one per split.
It covers the core set (numerical and categorical splits, row weights,
``max_depth``) and refuses the rest, as the JAX grower does.

The masked grower (``grower="masked"``, the JAX ``_grow_masked_impl``,
its correctness oracle) keeps the rows in row order and their leaves in
a device ``row_leaf``: a split routes the leaf's rows by the same
decision K2 applies (:func:`ops.partition.go_left` on the split's rule),
counts the in-bag rows going left, and K1 sums all ``n`` rows with the
payload masked to the smaller child (by the exact counts); the sibling
is the parent less it. One read-back per split, as the compact grower.
K1's float path scales its fixed point by the window's row count; the
masked pass hands K1 a bound scaled by ``2^(lc(cnt) - lc(n))`` (``lc``
the bit length of ``count - 1``, ``cnt`` the child's in-bag rows), so
each row is rounded as in the child's own window and the sums equal the
compact grower's bit for bit.

Int32 range: an entry of a window's histogram is at most ``cnt *
quant_bins`` in magnitude (``cnt * 127`` for any int8 payload), so the
exact int32 sums hold for ``n < 2**31 / quant_bins`` rows (16.9M for any
payload), the JAX package's limit too.

A world of ranks (``dist``, a ``parallel/data_parallel.py``
``DistGrow``; the JAX grower's ``axis_name`` branches): each rank grows
the same tree over its own rows. K1 and K2 run on the rank's windows;
the histograms are reduced where the JAX grower psums them (the root and
every smaller child before it is stored or subtracted; a pool miss's
recomputed one) or, under ``split_search="sharded"``, reduce-scattered
to the rank's chunk of columns; ``feature`` (replicated rows) and
``voting`` (a local cache, elected columns reduced per search) reduce
inside :meth:`Grower._search`. The root totals, the in-bag count and
every split's left count are summed over the world, the quantization
scales are its maxima, and the tree records the world's counts
(``st.gcount``) while the windows keep the rank's (``st.leaf_count``).
The smaller child is chosen by the split record's counts, which every
rank holds alike.

The TPU workarounds of the JAX grower (packed u32 bin words, group
sorts, K-row chunking, the nibble-matmul histogram) have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..obs.jit_tracker import register_jit
from .histogram import subtract_histogram, window_hist
from .partition import RangeRules, go_left, partition_window
from .predict import predict_leaf_binned
from .quantize import dequantize, discretize
from .split import (F_, FIELDS, AdvancedBounds, BundleTables, SplitParams,
                    find_best_split, find_best_split_bundled, forced_result,
                    leaf_output)

__all__ = ["GrowConfig", "TreeArrays", "Grower", "grow_tree", "root_totals",
           "leaf_totals", "masked_absmax", "CegbConfig", "CegbState",
           "allowed_features", "advanced_bounds"]

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
    # monotone_constraints_method: basic, intermediate or advanced
    monotone_method: str = "basic"
    # compact, level or masked
    grower: str = "compact"
    # histogram cache slots (0: one per leaf)
    pool_slots: int = 0


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


def leaf_totals(hf: torch.Tensor) -> torch.Tensor:
    """``[S, 2]`` (sum_grad, sum_hess) of ``S`` leaves from their float
    histograms ``[S, C, B, 2]``: every row hits column 0 once. The
    re-search and the level grower take a leaf's totals from it, as the
    JAX growers do; the CPU tests hand in XLA's sums through this
    function."""
    return hf[:, 0].sum(dim=1)


def _bit_length(c: torch.Tensor) -> torch.Tensor:
    """``(c - 1).bit_length()`` of int64 counts ``c >= 1`` (0 for 1)."""
    x = (c - 1).clamp_min(0).to(torch.float64)
    return torch.where(c > 1, torch.frexp(x).exponent.to(torch.int64), 0)


def masked_absmax(absmax: torch.Tensor, cnt: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The fixed-point bound of a K1 pass over ``n`` rows of which only
    ``cnt`` (an int64 device scalar) carry payload: ``absmax`` times
    ``2^(lc(cnt) - lc(n))``, so that K1's scale (``fixed_exponent`` of
    ``csrc/hist.cu``: ``62 - lc(rows) - frexp exponent``) is the one of
    a window of ``cnt`` rows."""
    shift = _bit_length(cnt) - _bit_length(torch.tensor(n, device=cnt.device))
    return torch.ldexp(absmax, shift.to(absmax.dtype))


class CegbConfig(NamedTuple):
    """Cost-effective gradient boosting (the JAX grower's ``cegb_*``
    knobs): ``tradeoff`` scales every penalty; ``split`` is charged per
    row of a split leaf, ``pen_coupled[f]`` once per model on a feature's
    first use, ``pen_lazy[f]`` per row that has not yet used the
    feature (``[F]`` float32 over the used features)."""
    tradeoff: float
    split: float
    pen_coupled: np.ndarray
    pen_lazy: np.ndarray
    lazy: bool
    coupled: bool


class CegbState:
    """CEGB's model-level state, carried across trees and iterations:
    ``coupled_used`` ``[F]`` bool (a host copy beside the device one) and,
    with lazy penalties, ``lazy_used`` ``[n, F]`` bool on the device
    (the rows that have acquired each feature)."""

    def __init__(self, n: int, F: int, lazy: bool, device):
        self.coupled_host = np.zeros(F, bool)
        self.coupled_used = torch.zeros(F, dtype=torch.bool, device=device)
        self.lazy_used = torch.zeros((n, F), dtype=torch.bool,
                                     device=device) if lazy else None


def allowed_features(groups: np.ndarray, branch: np.ndarray) -> np.ndarray:
    """``[F]`` bool features usable below a node whose path used the
    features ``branch`` (the JAX ``allowed_features``): the union of the
    interaction groups (``[G, F]`` bool) that hold the whole branch
    set."""
    contains = ~np.any(branch[None, :] & ~groups, axis=1)
    return np.any(groups & contains[:, None], axis=0)


def advanced_bounds(box_lo: torch.Tensor, box_hi: torch.Tensor,
                    values: torch.Tensor, num_leaves: int, leaves,
                    monotone: torch.Tensor, B: int) -> AdvancedBounds:
    """Advanced monotone bounds of the children of each leaf in
    ``leaves`` (the JAX ``advanced_bounds``, AdvancedLeafConstraints as
    box algebra, batched over the queried leaves): ``box_lo``/``box_hi``
    ``[L, F]`` are every leaf slot's bin-space box ``[lo, hi)``,
    ``values`` ``[L]`` their outputs; the first ``num_leaves`` slots are
    leaves. A leaf whose box overlaps the queried one's in every feature
    but one constrained feature ``m``, where the two are ordered, bounds
    its children: with ``m != j`` wherever its ``j``-interval overlaps
    the child's, with ``m == j`` by its order against the child's own
    ``j``-interval. Peak memory: about ``Q * L * F * B * 12`` bytes for
    ``Q`` queried leaves."""
    dev = box_lo.device
    q = torch.as_tensor(np.asarray(leaves, np.int64), device=dev)
    L = box_lo.shape[0]
    act = torch.arange(L, device=dev) < num_leaves
    bl, bh = box_lo[q][:, None, :], box_hi[q][:, None, :]     # [Q, 1, F]
    lo, hi = box_lo[None], box_hi[None]                       # [1, L, F]
    nonov = ~((lo < bh) & (hi > bl))
    cnt_no = nonov.sum(dim=2, keepdim=True)
    only_m = (cnt_no - nonov.to(cnt_no.dtype)) == 0           # [Q, L, F]
    above = lo >= bh
    below = hi <= bl
    inc = (monotone > 0)[None, None, :]
    dec = (monotone < 0)[None, None, :]
    up_any = ((only_m & ((inc & above) | (dec & below))).any(dim=2)
              & act[None])                                    # [Q, L]
    dn_any = ((only_m & ((inc & below) | (dec & above))).any(dim=2)
              & act[None])
    t = torch.arange(B, device=dev)
    lo4, hi4 = lo[..., None], hi[..., None]                   # [1, L, F, 1]
    ovl_l = (lo4 <= t) & (hi4 > bl[..., None])                # [Q, L, F, B]
    ovl_r = (lo4 < bh[..., None]) & (hi4 > t + 1)
    oj = (only_m & act[None, :, None])[..., None]
    above_l = lo4 >= t + 1
    below_r = hi4 <= t + 1
    inc4, dec4 = inc[..., None], dec[..., None]
    u_any = up_any[:, :, None, None]
    d_any = dn_any[:, :, None, None]
    up_l = (u_any & ovl_l) | (oj & ((inc4 & above_l)
                                    | (dec & below)[..., None]))
    dn_l = (d_any & ovl_l) | (oj & ((inc & below)[..., None]
                                    | (dec4 & above_l)))
    up_r = (u_any & ovl_r) | (oj & ((inc & above)[..., None]
                                    | (dec4 & below_r)))
    dn_r = (d_any & ovl_r) | (oj & ((inc4 & below_r)
                                    | (dec & above)[..., None]))
    inf = torch.tensor(float("inf"), dtype=values.dtype, device=dev)
    v4 = values[None, :, None, None]

    def vmin(mask):
        return torch.where(mask, v4, inf).amin(dim=1)

    def vmax(mask):
        return torch.where(mask, v4, -inf).amax(dim=1)
    v2 = values[None, :]
    return AdvancedBounds(
        lmin_l=vmax(dn_l), lmax_l=vmin(up_l),
        lmin_r=vmax(dn_r), lmax_r=vmin(up_r),
        smin=torch.where(dn_any, v2, -inf).amax(dim=1),
        smax=torch.where(up_any, v2, inf).amin(dim=1))


def _check_grower(cfg: GrowConfig, bundle, interaction_groups, forced,
                  cegb) -> None:
    """The JAX ``grow_tree_impl``'s refusals: the level and masked
    growers cover the core set only, and the pool is the compact
    grower's. (A world's refusals are the booster's,
    ``models/gbdt.py`` ``_setup_world``.)"""
    if cfg.grower not in ("compact", "level", "masked"):
        raise ValueError(f"Unknown grower: {cfg.grower}")
    if cfg.grower == "level":
        if bundle is not None or interaction_groups is not None \
                or forced is not None or cegb is not None \
                or cfg.quantized or cfg.bynode < 1.0 \
                or cfg.split.path_smooth > 0.0 or cfg.pool_slots > 0:
            raise NotImplementedError(
                "grower='level' covers the core feature set only (no "
                "EFB/interaction/forced/CEGB/quantized/bynode/"
                "path-smooth/histogram-pool; data-parallel sharding "
                "only) — use grower='compact'")
    elif cfg.grower == "masked":
        if bundle is not None:
            raise NotImplementedError(
                "EFB bundling requires the compact grower")
        if interaction_groups is not None or forced is not None \
                or cegb is not None:
            raise NotImplementedError(
                "interaction_constraints/forced splits/CEGB require the "
                "compact grower")
        if cfg.bynode < 1.0 or cfg.split.path_smooth > 0.0:
            raise NotImplementedError(
                "path_smooth/feature_fraction_bynode require the compact "
                "grower")
        if cfg.quantized or cfg.pool_slots > 0:
            raise NotImplementedError(
                "quantized gradients and the histogram pool require the "
                "compact grower")


# bytes of advanced_bounds' temporaries per queried leaf and (leaf,
# feature, bin) cell: the chunk of queried leaves is sized from them
_ADV_BYTES_PER_CELL = 12


class _TreeState:
    """The host (and small device) state of the tree being grown."""


class Grower:
    """Grows trees over one dataset's row-major ``[n, F]`` bin tensor, or
    with a ``bundle``, over its bundled ``[n, G]`` matrix
    (``bundle.bins_bundled``; ``bins`` is then None).

    The ping-pong buffers (``2 * n * (C + 12)`` bytes, ``2 * n * (C + 6)``
    when quantized, for ``C`` bin columns; none for the masked grower)
    and the histogram cache (``L * C * B * 8`` bytes, f32 or int32;
    ``pool_slots`` instead of ``L`` under the pool) are allocated once
    and reused by every tree.

    ``interaction_groups``: ``[G, F]`` bool interaction constraints.
    ``forced``: ``(leaf_slots, features, bins)`` of the forced splits in
    BFS order (:meth:`GBDTBooster` builds them from the JSON). ``cegb``:
    a :class:`CegbConfig`; each ``grow`` then takes the model's
    :class:`CegbState`."""

    def __init__(self, cfg: GrowConfig, bins: torch.Tensor,
                 feat_num_bins, feat_nan_bin, feature_mask=None,
                 bundle=None, feat_is_cat=None, monotone=None,
                 interaction_groups=None, forced=None, cegb=None,
                 dist=None):
        if bundle is not None:
            bins = bundle.bins_bundled
        n, C = bins.shape
        dev = bins.device
        L, B = cfg.num_leaves, cfg.num_bins
        F = len(feat_num_bins)
        _check_grower(cfg, bundle, interaction_groups, forced, cegb)
        self.cfg, self.n, self.F, self.dev = cfg, n, F, dev
        # the world's side (parallel/data_parallel.py DistGrow; None:
        # serial)
        self.dist = dist
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
        q = cfg.quantized
        if cfg.grower != "masked":
            self.bins2 = torch.empty((2, n, C), dtype=bins.dtype, device=dev)
            self.pay2 = torch.empty((2, n, 2), device=dev,
                                    dtype=torch.int8 if q else torch.float32)
            self.ids2 = torch.empty((2, n), dtype=torch.int32, device=dev)
        self.pooled = 0 < cfg.pool_slots < L
        # the cached histograms' columns: a sharded search keeps its own
        # chunk of them
        Cc = C if dist is None else dist.cache_columns()
        self.hists = torch.empty(
            (cfg.pool_slots if self.pooled else L, Cc, B, 2), device=dev,
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
        has_mono = self.mono is not None
        self.advanced = has_mono and cfg.monotone_method == "advanced"
        # advanced keeps intermediate's re-search after every split
        self.intermediate = has_mono and cfg.monotone_method in (
            "intermediate", "advanced")
        self.igroups = None if interaction_groups is None \
            else np.asarray(interaction_groups, bool)
        self.forced = forced
        self.cegb = cegb
        if cegb is not None:
            self.cegb_split = float(np.float32(cegb.tradeoff * cegb.split))
            tr = np.float32(cegb.tradeoff)
            self.cegb_coupled = torch.as_tensor(
                tr * np.asarray(cegb.pen_coupled, np.float32), device=dev)
            self.cegb_lazy = torch.as_tensor(
                tr * np.asarray(cegb.pen_lazy, np.float32), device=dev)
        # the leaves' exact counts on the device (the re-search's and
        # CEGB's; the host learns them one split late)
        self.track_counts = self.intermediate or cegb is not None
        # summed over the trees grown (the smoke prints them per tree):
        # leaves re-searched, the host's read-backs, the histograms a
        # pool miss recomputed
        self.researched = 0
        self.readbacks = 0
        self.pool_misses = 0
        self.adv_chunk = None

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """A read-back of the growth loop (counted)."""
        self.readbacks += 1
        return t.cpu().numpy()

    # -- the histogram cache ---------------------------------------------
    def _leaf_hist(self, st, leaf: int) -> torch.Tensor:
        """Leaf ``leaf``'s cached histogram; under the pool, an evicted
        one recomputed from its window (K1 at the tree's bound)."""
        if not self.pooled:
            return self.hists[leaf]
        slot = st.leaf2slot[leaf]
        if slot >= 0:
            return self.hists[slot]
        self.pool_misses += 1
        b = int(st.leaf_buf[leaf])
        h = window_hist(self.bins2[b], self.pay2[b], self.cfg.num_bins,
                        int(st.leaf_begin[leaf]), int(st.leaf_count[leaf]),
                        pay_absmax=st.absmax)
        # every rank misses at the same split: the LRU state is the same
        return h if self.dist is None else self.dist.reduce_hist_once(h)

    def _store_children(self, st, leaf: int, R: int, lh, rh) -> None:
        """Cache the children of split ``R - 1`` of ``leaf``; under the
        pool, the left child keeps ``leaf``'s slot or takes the least
        recently stamped one, the right child the least recently stamped
        other slot (HistogramPool's LRU, the JAX grower's ``alloc``)."""
        if not self.pooled:
            self.hists[leaf] = lh
            self.hists[R] = rh
            return
        l2s, s2l, lru = st.leaf2slot, st.slot2leaf, st.lru

        def victim(forbid: int) -> int:
            score = lru.copy()
            if forbid >= 0:
                score[forbid] = 2 ** 30
            v = int(np.argmin(score))
            if s2l[v] >= 0:
                l2s[s2l[v]] = -1
            return v
        s_l = int(l2s[leaf]) if l2s[leaf] >= 0 else victim(-1)
        s2l[s_l] = leaf
        lru[s_l] = R
        s_r = victim(s_l)
        s2l[s_r] = R
        lru[s_r] = R
        l2s[leaf] = s_l
        l2s[R] = s_r
        self.hists[s_l] = lh
        self.hists[s_r] = rh

    # -- the search ------------------------------------------------------
    def _find(self, hf, g, h, c, fmask, p_out, depth, bounds, pen=None,
              p=None, col_mask=None, gains=False):
        """The plain or bundled search of float histograms ``hf``;
        returns ``(records, masks, per-column gains)`` (masks None
        without categorical features, gains None unless asked)."""
        p = self.cfg.split if p is None else p
        if self.bundled:
            out = find_best_split_bundled(
                hf, g, h, c, self.tables, fmask, p, self.fcat, self.fnb,
                self.mono, p_out, depth, bounds, pen, col_mask=col_mask,
                feature_gains=gains)
        else:
            if col_mask is not None:
                fmask = fmask & col_mask
            out = find_best_split(hf, g, h, c, self.fnb, self.fnan,
                                  fmask, p, self.fcat, self.mono, p_out,
                                  depth, bounds, pen, feature_gains=gains)
        out = out if isinstance(out, tuple) else (out,)
        masks = out[1] if self.fcat is not None else None
        return out[0], masks, (out[-1] if gains else None)

    def _search(self, hist2, g, h, c, fmask, p_out, depth, bounds,
                pen=None):
        """Search the ``S`` leaves of the cached histograms ``hist2``
        (int32 when quantized: dequantized here); returns ``(records,
        masks)`` (masks None without categorical features). In a world
        (``parallel/data_parallel.py``): ``feature`` searches the owned
        columns and combines the records, a sharded search its chunk,
        ``voting`` elects columns from the local histograms and searches
        the world's histograms of the elected ones."""
        d = self.dist
        hf = self._hf(hist2)
        if d is None or (d.mode == "data" and not d.sharded):
            return self._find(hf, g, h, c, fmask, p_out, depth, bounds,
                              pen)[:2]
        if d.fp:
            rec, masks, _ = self._find(hf, g, h, c, fmask, p_out, depth,
                                       bounds, pen,
                                       col_mask=d.owned(self.dev))
            return d.combine(rec, masks) if masks is not None \
                else (d.combine(rec), None)
        if d.sharded:
            return self._search_chunk(hf, g, h, c, fmask, p_out, depth,
                                      bounds, pen)
        # voting: the local ballot (local totals, per-rank data limits)
        p = self.cfg.split
        tot = hf[:, 0].sum(dim=1)
        c_loc = torch.round(c * tot[:, 1] / torch.clamp_min(h, 1e-15))
        p_loc = p._replace(
            min_data_in_leaf=p.min_data_in_leaf / d.D,
            min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf / d.D)
        fg = self._find(hf, tot[:, 0], tot[:, 1], c_loc, fmask, p_out,
                        depth, bounds, pen, p=p_loc, gains=True)[2]
        idx = d.elect(fg)
        elected = torch.zeros(fg.shape, dtype=torch.bool, device=self.dev)
        elected.scatter_(1, idx, True)
        ghf = self._hf(d.exchange_elected(hist2, idx))
        return self._find(ghf, g, h, c, fmask, p_out, depth, bounds, pen,
                          col_mask=elected)[:2]

    def _search_chunk(self, hf, g, h, c, fmask, p_out, depth, bounds,
                      pen):
        """The sharded search: this rank's columns ``[c_start, c_start +
        Cl)`` of every per-feature input, its feature ids made global,
        and the records combined."""
        d = self.dist
        cs = d.chunk_slice
        real = cs(torch.ones(self.F, dtype=torch.bool, device=self.dev),
                  False)
        fm = cs(fmask, False) & real
        if isinstance(bounds, AdvancedBounds):
            def bsl(b):
                return torch.movedim(cs(torch.movedim(b, 1, -1), 0.0),
                                     -1, 1)
            bounds = AdvancedBounds(*(bsl(b) for b in bounds[:4]),
                                    bounds.smin, bounds.smax)
        out = find_best_split(
            hf, g, h, c, cs(self.fnb, 1), cs(self.fnan, -1), fm,
            self.cfg.split, cs(self.fcat, False),
            cs(self.mono, 0), p_out, depth, bounds,
            cs(pen, 0.0))
        rec, masks = out if self.fcat is not None else (out, None)
        rec = rec.clone()
        rec[:, F_["feature"]] += float(d.c_start)
        return d.combine(rec, masks) if masks is not None \
            else (d.combine(rec), None)

    def _store(self, slots, rec, masks) -> None:
        """Store records (and categorical masks) at leaf slots: a slice
        ``range(S)`` in one copy, else one row at a time."""
        if isinstance(slots, range):
            self.best[:len(slots)] = rec
            if masks is not None:
                self.best_mask[:len(slots)] = masks
            return
        for i, leaf in enumerate(slots):
            self.best[leaf] = rec[i]
            if masks is not None:
                self.best_mask[leaf] = masks[i]

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

    def _cegb_pen(self, cnt: torch.Tensor, state: CegbState,
                  nu: torch.Tensor) -> torch.Tensor:
        """``[C, F]`` CEGB DeltaGain of leaves with ``cnt`` ``[C]`` in-bag
        rows and ``nu`` ``[C, F]`` rows that have not used each feature
        (the JAX ``cegb_penalty``, in its float32 steps)."""
        pen = self.cegb_split * cnt[:, None].expand(-1, self.F)
        pen = pen + torch.where(state.coupled_used, 0.0, self.cegb_coupled)
        if self.cegb.lazy:
            pen = pen + self.cegb_lazy * nu
        return pen

    def _leaf_masks(self, st, slots) -> torch.Tensor:
        """The usable features of leaf slots (``[S, F]``, or ``[F]`` when
        they share the tree's): the tree's mask, the interaction groups'
        allowed set for each leaf's branch and its per-node draw."""
        mask = st.fmask
        if self.igroups is not None:
            allowed = np.stack([allowed_features(self.igroups,
                                                 st.branch[s])
                                for s in slots])
            mask = mask & torch.as_tensor(allowed, device=self.dev)
        if st.nmask is not None:
            mask = mask & st.nmask[torch.as_tensor(list(slots),
                                                   device=self.dev)]
        return mask

    def _adv_chunk(self) -> int:
        """Queried leaves per :func:`advanced_bounds` call: the
        temporaries of a chunk in a quarter of the device memory free at
        the first call (256 MiB on the CPU)."""
        if self.adv_chunk is None:
            cfg = self.cfg
            per_leaf = cfg.num_leaves * self.F * cfg.num_bins \
                * _ADV_BYTES_PER_CELL
            free = torch.cuda.mem_get_info(self.dev)[0] // 4 \
                if self.dev.type == "cuda" else 256 << 20
            self.adv_chunk = int(max(1, min(cfg.num_leaves,
                                            free // per_leaf)))
        return self.adv_chunk

    def _adv_bounds(self, st, slots) -> AdvancedBounds:
        """:func:`advanced_bounds` of ``slots``, in chunks of leaves."""
        B = self.cfg.num_bins
        slots = list(slots)
        chunk = self._adv_chunk()
        lo = torch.as_tensor(st.box_lo, device=self.dev)
        hi = torch.as_tensor(st.box_hi, device=self.dev)
        vals = torch.as_tensor(st.t["leaf_value"], device=self.dev)
        parts = [advanced_bounds(lo, hi, vals, st.t["num_leaves"],
                                 slots[i:i + chunk], self.mono, B)
                 for i in range(0, len(slots), chunk)]
        if len(parts) == 1:
            return parts[0]
        return AdvancedBounds(*(torch.cat(x) for x in zip(*parts)))

    def _research(self, st, S: int):
        """Re-search every leaf slot ``0 .. S-1`` from the cached
        histograms under the current masks, penalties, parent outputs,
        depths and bounds (the JAX ``research_all``): the leaves' totals
        are their histograms' column-0 sums, their counts the exact
        ones. Stores the records (and categorical masks) at the slots
        and returns the records."""
        t = st.t
        slots = range(S)
        raw = torch.stack([self._leaf_hist(st, s) for s in slots]) \
            if self.pooled else self.hists[:S]
        hf = st.hist_f(raw)
        sums = leaf_totals(hf) if self.dist is None \
            or not self.dist.sharded else self.dist.chunk_totals(hf)
        cnt = st.cnt_dev[:S]
        p_out = torch.as_tensor(t["leaf_value"][:S], device=self.dev)
        bounds = None
        if self.advanced:
            bounds = self._adv_bounds(st, slots)
        elif self.mono is not None:
            bounds = torch.as_tensor(np.stack([st.lmin[:S], st.lmax[:S]],
                                              1), device=self.dev)
        pen = None
        if self.cegb is not None:
            pen = self._cegb_pen(cnt, st.cegb, st.lazy_nu[:S])
        rec, masks = self._search(raw, sums[:, 0], sums[:, 1], cnt,
                                  self._leaf_masks(st, slots), p_out,
                                  t["leaf_depth"][:S], bounds, pen)
        self._store(slots, rec, masks)
        self.researched += S
        return rec

    # -- growing ---------------------------------------------------------
    def grow(self, grad: torch.Tensor, hess: torch.Tensor,  # tpulint: hot
             noise: torch.Tensor = None, row_weight: torch.Tensor = None,
             feature_mask=None, node_uniform=None, cegb_state=None):
        """Grow one tree (:meth:`_grow`) through its cost-attribution
        entry: ``ops/grow_tree``, or ``parallel/dp_grow`` in a world."""
        entry = _grow_tree if self.dist is None else _dp_grow
        return entry(self, grad, hess, noise, row_weight, feature_mask,
                     node_uniform, cegb_state)

    def _grow(self, grad: torch.Tensor, hess: torch.Tensor,  # tpulint: hot
              noise: torch.Tensor = None, row_weight: torch.Tensor = None,
              feature_mask=None, node_uniform=None, cegb_state=None):
        """Grow one tree on f32 ``[n]`` gradients/hessians. ``noise`` is
        the ``[n, 2]`` uniform draw of stochastic rounding when quantized
        (None: round to nearest). ``row_weight``: f32 ``[n]`` bagging or
        GOSS weights (None: every row once). ``feature_mask``: the
        tree's usable features (None: the grower's). ``node_uniform(i)``:
        the ``[F]`` uniform draw of node ``i`` when ``cfg.bynode < 1``.
        ``cegb_state``: the model's :class:`CegbState` (with ``cegb``),
        updated in place. Returns ``(TreeArrays, row_leaf [n] int64
        tensor on the device)``."""
        cfg, n, p = self.cfg, self.n, self.cfg.split
        L, B, F = cfg.num_leaves, cfg.num_bins, self.F
        dev = self.dev
        st = _TreeState()
        fm = self.fmask_host if feature_mask is None \
            else np.asarray(feature_mask, bool)
        st.fmask = self.fmask if feature_mask is None \
            else torch.as_tensor(fm, device=dev)
        if cfg.grower == "masked":
            return self._grow_masked(st, grad, hess, row_weight)
        st.usable = int(fm.sum())
        st.node_uniform = node_uniform if cfg.bynode < 1.0 else None
        st.cegb = cegb_state
        pay = self.pay2[0]
        if row_weight is not None:
            grad, hess = grad * row_weight, hess * row_weight
        # the tree's payload over all n rows, in row order
        scale2 = None
        d = self.dist
        if cfg.quantized:
            # a world's scales are its maxima, so int histograms sum
            full, scale2 = discretize(grad, hess, None, cfg.quant_bins,
                                      noise, None if d is None else d.max)
        else:
            full = torch.stack([grad, hess], dim=1)

        def hist_f(h):
            return dequantize(h, scale2) if cfg.quantized else h
        st.hist_f = self._hf = hist_f
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
        st.absmax = None if cfg.quantized or m == 0 \
            else pay[:m].abs().amax(dim=0)
        root_hist = window_hist(self.bins2[0], pay, B, 0, m,
                                pay_absmax=st.absmax)
        # a world's histogram: reduced (data), its chunk (sharded) or the
        # rank's own (feature, voting); the error feedback of a quantized
        # wire is carried through the tree
        st.ef = None
        if d is not None:
            shape = d.ef_shape(B)
            if shape is not None:
                st.ef = torch.zeros(shape, dtype=torch.float32, device=dev)
            local_root = root_hist
            root_hist, st.ef = d.reduce_hist(root_hist, st.ef)
        self.hists[0] = root_hist
        if cfg.quantized:
            # every row hits feature 0 once; a world sums the int row
            row0 = root_hist[0]
            if d is not None and d.vp:
                row0 = d.sum(local_root[0])
            elif d is not None and d.sharded:
                row0 = d.comm.all_reduce(
                    root_hist[0] if d.rank == 0
                    else torch.zeros_like(root_hist[0]))
            tg, th = hist_f(row0).sum(dim=0).unbind()
        else:
            tg, th = root_totals(full)
            if d is not None:
                tg, th = d.sum(torch.stack([tg, th])).unbind()
        tc64 = torch.full((), float(m), dtype=torch.float64, device=dev)
        if d is not None:
            tc64 = d.sum(tc64)
        tc = tc64.float()
        root_out = leaf_output(tg, th, p)
        t = _init_tree(L)
        st.t = t
        # per-leaf state on the host: monotone output bounds, the
        # intermediate method's ancestry (1 left, 2 right subtree of
        # each node), the advanced method's bin-space boxes, the
        # interaction constraints' branch sets
        has_mono = self.mono is not None
        st.lmin = np.full(L, -np.inf, np.float32)
        st.lmax = np.full(L, np.inf, np.float32)
        if self.intermediate:
            st.anc = np.zeros((L, max(L - 1, 1)), np.int8)
        if self.advanced:
            st.box_lo = np.zeros((L, F), np.int64)
            st.box_hi = np.full((L, F), B, np.int64)
        st.branch = np.zeros((L, F), bool)
        st.nmask = None
        if st.node_uniform is not None:
            st.nmask = torch.zeros((L, F), dtype=torch.bool, device=dev)
            st.nmask[0] = self._node_mask(st.node_uniform(0), st.fmask,
                                          st.usable)
        st.cnt_dev = None
        if self.track_counts:
            st.cnt_dev = torch.zeros(L, dtype=torch.float32, device=dev)
            st.cnt_dev[0] = tc
        root_pen = None
        if self.cegb is not None:
            cs = cegb_state
            st.lazy_nu = torch.zeros((L, F), dtype=torch.float32,
                                     device=dev)
            if self.cegb.lazy:
                used = cs.lazy_used if row_weight is None \
                    else cs.lazy_used | (row_weight <= 0)[:, None]
                st.lazy_nu[0] = (~used).sum(dim=0).to(torch.float32)
            root_pen = self._cegb_pen(tc[None], cs, st.lazy_nu[:1])
        root_bounds = None
        if self.advanced:
            t["leaf_value"][0] = float(root_out)
            root_bounds = self._adv_bounds(st, [0])
        elif has_mono:
            root_bounds = torch.as_tensor(
                np.stack([st.lmin[:1], st.lmax[:1]], 1), device=dev)
        rec, masks = self._search(
            root_hist[None], tg[None], th[None], tc[None],
            self._leaf_masks(st, [0]), root_out[None], 0, root_bounds,
            root_pen)
        self._store([0], rec, masks)
        host = self._host(torch.cat([rec[0].double(),
                                     torch.stack([root_out, th]).double(),
                                     tc64[None]]))
        t["leaf_value"][0] = host[NF]
        t["leaf_weight"][0] = host[NF + 1]
        # the tree's counts are the world's; the windows the rank's
        m_all = int(host[NF + 2])
        t["leaf_count"][0] = m_all
        st.gcount = np.zeros(L, np.int64)
        st.gcount[0] = m_all
        st.best_h = np.zeros((L, NF), np.float32)
        st.best_h[0] = host[:NF]
        st.gains = np.full(L, -np.inf, np.float32)
        st.gains[0] = st.best_h[0, F_["gain"]]
        st.leaf_buf = np.zeros(L, np.int64)
        st.leaf_begin = np.zeros(L, np.int64)
        st.leaf_count = np.zeros(L, np.int64)
        st.leaf_count[0] = m
        st.ns = 0
        if self.pooled:
            st.leaf2slot = np.full(L, -1, np.int64)
            st.slot2leaf = np.full(cfg.pool_slots, -1, np.int64)
            st.lru = np.zeros(cfg.pool_slots, np.int64)
            st.leaf2slot[0] = st.slot2leaf[0] = 0

        # ---- forced splits: the first ones of the tree, in BFS order;
        # an invalid one (an empty child) ends them all ----
        if self.forced is not None:
            exact = p.path_smooth > 0.0 or has_mono
            for leaf, f, tb in zip(*self.forced):
                if st.ns >= L - 1:
                    break
                lh = self._leaf_hist(st, int(leaf))
                if d is not None and d.sharded:
                    lh = d.full_from_chunk(lh)
                rec = forced_result(
                    hist_f(lh),
                    torch.tensor(float(st.gcount[leaf]),
                                 dtype=torch.float32, device=dev),
                    int(f), int(tb),
                    torch.tensor(float(t["leaf_value"][leaf]),
                                 dtype=torch.float32, device=dev),
                    (st.lmin[leaf], st.lmax[leaf]) if has_mono else None,
                    p, exact, self.rules)
                r = self._host(rec)
                if not (r[F_["left_count"]] > 0 and r[F_["right_count"]] > 0):
                    break
                self.best[leaf] = rec
                st.best_h[leaf] = r
                self._split(st, int(leaf), r)

        if cfg.grower == "level":
            self._grow_levels(st)
        while st.ns < L - 1 and st.gains.max() > 0.0:
            leaf = int(np.argmax(st.gains))
            self._split(st, leaf, st.best_h[leaf])

        nleaves = t["num_leaves"]
        nn = nleaves - 1
        cat_masks = self._cat_masks(t)
        row_leaf = self._row_leaf(nleaves, st.leaf_buf, st.leaf_begin,
                                  st.leaf_count, m)
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

    def _rule(self, leaf: int, r: np.ndarray, node: int):
        """The decision of split ``node`` of ``leaf`` by its host record
        ``r``: ``(col, lo, hi, nan_pos, bits)``, the range rule, or with
        ``bits`` the membership rule of a categorical split, whose mask
        the split keeps (:class:`ops.partition.RangeRules`)."""
        f = int(r[F_["feature"]])
        col, lo, hi, nan_pos = self.rules(f, int(r[F_["threshold_bin"]]))
        bits = None
        if r[F_["direction"]] >= 2:
            self.split_mask[node] = self.best_mask[leaf]
            bits = self.rules.bitsets([f], self.best_mask[leaf][None],
                                      self.cfg.num_bins)[0]
        return col, lo, hi, nan_pos, bits

    def _cat_masks(self, t: dict):
        """The splits' categorical masks on the device (None without a
        categorical split), with the tree's one read-back of them into
        ``t["split_cat_mask"]``."""
        L, B = self.cfg.num_leaves, self.cfg.num_bins
        nn = t["num_leaves"] - 1
        t["split_cat_mask"] = np.zeros((L - 1, B), bool)
        if self.fcat is None or not t["split_is_cat"][:nn].any():
            return None
        cat_masks = self.split_mask[:nn]
        t["split_cat_mask"][:nn] = self._host(cat_masks)
        return cat_masks

    def _split(self, st, leaf: int, r: np.ndarray) -> None:  # tpulint: hot
        """Split leaf slot ``leaf`` by its host record ``r``: K2 moves its
        window, K1 builds the smaller child's histogram, the per-leaf
        state follows, and the children (or, after a split that changes
        other leaves' bounds or penalties, every leaf) are searched; the
        records come back with the left count in one read-back."""
        cfg, p = self.cfg, self.cfg.split
        L, B = cfg.num_leaves, cfg.num_bins
        t, dev = st.t, self.dev
        ns = st.ns
        R = ns + 1
        src = int(st.leaf_buf[leaf])
        dst = 1 - src
        begin, cnt = int(st.leaf_begin[leaf]), int(st.leaf_count[leaf])
        f_split = int(r[F_["feature"]])
        t_bin = int(r[F_["threshold_bin"]])
        is_cat = r[F_["direction"]] >= 2
        col, lo, hi, nan_pos, bits = self._rule(leaf, r, ns)
        # the parent's histogram before K2 moves its rows (a pool miss
        # recomputes it from the window)
        parent = self._leaf_hist(st, leaf)
        nl = partition_window(
            self.bins2[src], self.bins2[dst], self.pay2[src],
            self.pay2[dst], self.ids2[src], self.ids2[dst], begin, cnt,
            col, lo, hi, nan_pos, bool(r[F_["default_left"]]), bits)
        # the smaller child by the record's counts, which every rank
        # holds alike (a rank's own window could pick the other side)
        est_left_small = r[F_["left_count"]] <= r[F_["right_count"]]
        small = window_hist(self.bins2[dst], self.pay2[dst], B, begin,
                            cnt, nl, 1 if est_left_small else 2,
                            pay_absmax=st.absmax)
        d = self.dist
        nl_all = nl
        if d is not None:
            small, st.ef = d.reduce_hist(small, st.ef)
            nl_all = d.sum(nl.to(torch.int64))
        other = subtract_histogram(parent, small)
        lh, rh = (small, other) if est_left_small else (other, small)
        self._store_children(st, leaf, R, lh, rh)
        nlf = nl_all.to(torch.float32)
        cnt2 = torch.cat([nlf, float(st.gcount[leaf]) - nlf])
        if st.cnt_dev is not None:
            st.cnt_dev[leaf] = cnt2[0]
            st.cnt_dev[R] = cnt2[1]
        # the host tree now (its counts after the read-back): the
        # re-search reads the children's outputs and depths
        _apply_split(t, r, leaf, R, ns, 0.0, 0.0)
        depth = int(t["leaf_depth"][leaf])
        # interaction constraints: both children's branch sets
        if self.igroups is not None:
            nb = st.branch[leaf].copy()
            nb[f_split] = True
            st.branch[leaf] = st.branch[R] = nb
        if st.nmask is not None:
            for node, slot in ((2 * ns + 1, leaf), (2 * ns + 2, R)):
                st.nmask[slot] = self._node_mask(st.node_uniform(node),
                                                 st.fmask, st.usable)
        # CEGB: the coupled feature's first use, the rows' lazy
        # acquisition and the children's counts of rows still to acquire
        research = self.intermediate
        pen2 = None
        if self.cegb is not None:
            cs = st.cegb
            first_use = not cs.coupled_host[f_split] \
                and self.cegb.pen_coupled[f_split] > 0
            cs.coupled_host[f_split] = True
            cs.coupled_used[f_split] = True
            if self.cegb.lazy:
                ids = self.ids2[dst, begin:begin + cnt].to(torch.int64)
                cs.lazy_used[ids, f_split] = True
                on_left = torch.arange(cnt, device=dev) < nl
                small_rows = on_left if est_left_small else ~on_left
                est_nu = ((~cs.lazy_used[ids]) & small_rows[:, None]).sum(
                    dim=0).to(torch.float32)
                est_nu[f_split] = 0.0
                parent_nu = st.lazy_nu[leaf].clone()
                parent_nu[f_split] = 0.0
                big = torch.clamp_min(parent_nu - est_nu, 0.0)
                st.lazy_nu[leaf] = est_nu if est_left_small else big
                st.lazy_nu[R] = big if est_left_small else est_nu
            research = research or (self.cegb.coupled and first_use)
            if not research:
                pen2 = self._cegb_pen(cnt2, cs, st.lazy_nu[[leaf, R]])
        # monotone bounds
        if self.intermediate:
            st.anc[R] = st.anc[leaf]
            st.anc[leaf, ns] = 1
            st.anc[R, ns] = 2
            if self.advanced and not is_cat:
                l_hi = min(st.box_hi[leaf, f_split], t_bin + 1)
                st.box_lo[R] = st.box_lo[leaf]
                st.box_hi[R] = st.box_hi[leaf]
                st.box_lo[R, f_split] = max(st.box_lo[leaf, f_split],
                                            t_bin + 1)
                st.box_hi[leaf, f_split] = l_hi
            elif self.advanced:
                st.box_lo[R] = st.box_lo[leaf]
                st.box_hi[R] = st.box_hi[leaf]
            self._refresh_bounds(st, ns)
        elif self.mono is not None:
            self._update_bounds(st.lmin, st.lmax, leaf, R, r, f_split,
                                is_cat)
        if research:
            S = ns + 2
            rec = self._research(st, S)
            slots = range(S)
        else:
            mask2 = self._leaf_masks(st, [leaf, R])
            pb = self.best[leaf]
            bounds2 = None if self.mono is None else torch.as_tensor(
                np.stack([st.lmin[[leaf, R]], st.lmax[[leaf, R]]], 1),
                device=dev)
            rec, masks = self._search(
                torch.stack([lh, rh]),
                torch.stack([pb[F_["left_sum_g"]], pb[F_["right_sum_g"]]]),
                torch.stack([pb[F_["left_sum_h"]], pb[F_["right_sum_h"]]]),
                cnt2, mask2,
                torch.stack([pb[F_["left_output"]],
                             pb[F_["right_output"]]]),
                depth, bounds2, pen2)
            slots = [leaf, R]
            self._store(slots, rec, masks)
        tail = [nl.double()] if d is None \
            else [nl.double(), nl_all.double()]
        host = self._host(torch.cat([rec.reshape(-1).double(), *tail]))
        # the rank's window, and the world's counts for the tree
        n_left = int(host[-len(tail)])
        g_left = int(host[-1])
        g_right = int(st.gcount[leaf]) - g_left
        t["leaf_count"][leaf] = g_left
        t["leaf_count"][R] = g_right
        t["internal_count"][ns] = np.float32(g_left) + np.float32(g_right)
        st.gcount[leaf], st.gcount[R] = g_left, g_right
        st.leaf_buf[leaf] = st.leaf_buf[R] = dst
        st.leaf_count[leaf] = n_left
        st.leaf_begin[R] = begin + n_left
        st.leaf_count[R] = cnt - n_left
        recs = host[:-len(tail)].reshape(len(slots), NF)
        for i, s in enumerate(slots):
            st.best_h[s] = recs[i]
            ok = cfg.max_depth <= 0 or t["leaf_depth"][s] < cfg.max_depth
            st.gains[s] = recs[i, F_["gain"]] if ok else -np.inf
        st.ns = ns + 1

    # -- the level grower -----------------------------------------------
    def _grow_levels(self, st) -> None:
        """Depth-wise growth from the root's record (the JAX
        ``level_step`` loop): each level elects, partitions, histograms
        and searches its whole frontier with two read-backs."""
        cfg = self.cfg
        L, B = cfg.num_leaves, cfg.num_bins
        t, dev = st.t, self.dev
        level = 0
        while st.ns < L - 1 and st.gains.max() > 0.0:
            S = t["num_leaves"]
            gains = st.gains[:S]
            cand = gains > 0.0
            order = np.argsort(np.where(cand, -gains, np.inf),
                               kind="stable")
            rank = np.empty(S, np.int64)
            rank[order] = np.arange(S)
            elected = np.nonzero(cand & (rank < L - 1 - st.ns))[0]
            ns0 = st.ns
            # K2 on every elected leaf's window, no read-back between
            moves, nls = [], []
            for j, leaf in enumerate(elected):
                leaf = int(leaf)
                r = st.best_h[leaf]
                node, R = ns0 + j, ns0 + 1 + j
                src = int(st.leaf_buf[leaf])
                begin, cnt = int(st.leaf_begin[leaf]), int(st.leaf_count[leaf])
                col, lo, hi, nan_pos, bits = self._rule(leaf, r, node)
                nls.append(partition_window(
                    self.bins2[src], self.bins2[1 - src], self.pay2[src],
                    self.pay2[1 - src], self.ids2[src], self.ids2[1 - src],
                    begin, cnt, col, lo, hi, nan_pos,
                    bool(r[F_["default_left"]]), bits))
                _apply_split(t, r, leaf, R, node, 0.0, 0.0)
                moves.append((leaf, R, node, 1 - src, begin, cnt))
            st.ns = ns0 + len(elected)
            # the level's one read-back of its counts (the rank's and,
            # in a world, the world's), then K1 on every smaller child
            # (exact counts) and the siblings by subtraction
            d = self.dist
            nls = torch.cat(nls).to(torch.int64)
            both = nls if d is None else torch.cat([nls, d.sum(nls)])
            host = self._host(both).astype(np.int64)
            n_left, g_lefts = host[:len(moves)], host[-len(moves):]
            slots = []
            for (leaf, R, node, dst, begin, cnt), nl, gl in zip(
                    moves, n_left, g_lefts):
                nl, gl = int(nl), int(gl)
                nr = cnt - nl
                gr = int(st.gcount[leaf]) - gl
                t["leaf_count"][leaf], t["leaf_count"][R] = gl, gr
                t["internal_count"][node] = np.float32(gl) + np.float32(gr)
                st.gcount[leaf], st.gcount[R] = gl, gr
                st.leaf_buf[leaf] = st.leaf_buf[R] = dst
                st.leaf_count[leaf], st.leaf_count[R] = nl, nr
                st.leaf_begin[R] = begin + nl
                # the smaller child by the world's counts
                left_small = gl <= gr
                small = window_hist(
                    self.bins2[dst], self.pay2[dst], B,
                    begin if left_small else begin + nl,
                    nl if left_small else nr, pay_absmax=st.absmax)
                if d is not None:
                    small, st.ef = d.reduce_hist(small, st.ef)
                other = subtract_histogram(self.hists[leaf], small)
                lh, rh = (small, other) if left_small else (other, small)
                self.hists[leaf] = lh
                self.hists[R] = rh
                slots += [leaf, R]
            # the new frontier in one search, totals from feature 0
            idx = torch.as_tensor(slots, device=dev)
            hf = self.hists[idx]
            sums = leaf_totals(hf)
            cnt = torch.as_tensor(t["leaf_count"][slots], dtype=torch.float32,
                                  device=dev)
            rec, masks = self._search(hf, sums[:, 0], sums[:, 1], cnt,
                                      st.fmask, None, level + 1, None)
            self._store(slots, rec, masks)
            recs = self._host(rec)
            st.gains[:] = -np.inf
            deeper = cfg.max_depth <= 0 or level + 1 < cfg.max_depth
            for i, sl in enumerate(slots):
                st.best_h[sl] = recs[i]
                if deeper:
                    st.gains[sl] = recs[i, F_["gain"]]
            level += 1

    # -- the masked grower ----------------------------------------------
    def _grow_masked(self, st, grad, hess, row_weight):
        """One tree by full-row masked histograms (the JAX
        ``_grow_masked_impl``): ``row_leaf`` on the device, one K1 pass
        over every row per split, one read-back per split."""
        cfg, n, p = self.cfg, self.n, self.cfg.split
        L, B = cfg.num_leaves, cfg.num_bins
        dev = self.dev
        d = self.dist
        self._hf = _identity
        inbag = None
        if row_weight is not None:
            grad, hess = grad * row_weight, hess * row_weight
            inbag = row_weight > 0
        full = torch.stack([grad, hess], dim=1)
        st.absmax = full.abs().amax(dim=0)
        tg, th = root_totals(full)
        m_dev = torch.tensor(n, device=dev) if inbag is None \
            else inbag.sum()
        m_all = m_dev
        ef = None
        if d is not None:
            tg, th = d.sum(torch.stack([tg, th])).unbind()
            m_all = d.sum(m_dev.to(torch.int64))
            shape = d.ef_shape(B)
            ef = None if shape is None else torch.zeros(
                shape, dtype=torch.float32, device=dev)
        tc = m_all.to(torch.float32)
        root_hist = window_hist(self.bins, full, B, 0, n, pay_absmax=(
            st.absmax if inbag is None
            else masked_absmax(st.absmax, m_dev, n)))
        if d is not None:
            root_hist, ef = d.reduce_hist(root_hist, ef)
        self.hists[0] = root_hist
        root_out = leaf_output(tg, th, p)
        rec, masks = self._search(root_hist[None], tg[None], th[None],
                                  tc[None], st.fmask, root_out[None], 0,
                                  None)
        self._store([0], rec, masks)
        host = self._host(torch.cat([
            rec[0].double(), torch.stack([root_out, th]).double(),
            torch.stack([m_all, m_dev]).double()]))
        t = _init_tree(L)
        t["leaf_value"][0] = host[NF]
        t["leaf_weight"][0] = host[NF + 1]
        t["leaf_count"][0] = m = int(host[NF + 2])
        st.best_h = np.zeros((L, NF), np.float32)
        st.best_h[0] = host[:NF]
        st.gains = np.full(L, -np.inf, np.float32)
        st.gains[0] = st.best_h[0, F_["gain"]]
        # the world's counts (the tree's) and the rank's (K1's bound)
        counts = np.zeros(L, np.int64)
        counts[0] = m
        local = np.zeros(L, np.int64)
        local[0] = int(host[NF + 3])
        row_leaf = torch.zeros(n, dtype=torch.int64, device=dev)
        ns = 0
        while ns < L - 1 and st.gains.max() > 0.0:
            leaf = int(np.argmax(st.gains))
            r = st.best_h[leaf]
            R = ns + 1
            col, lo, hi, nan_pos, bits = self._rule(leaf, r, ns)
            gl = go_left(self.bins[:, col], lo, hi, nan_pos,
                         bool(r[F_["default_left"]]), bits)
            on_leaf = row_leaf == leaf
            go = on_leaf & gl
            nl_loc = (go if inbag is None else go & inbag).sum()
            nr_loc = int(local[leaf]) - nl_loc
            nl = nl_loc if d is None else d.sum(nl_loc.to(torch.int64))
            nr = int(counts[leaf]) - nl
            row_leaf.masked_fill_(on_leaf & ~gl, R)
            left_small = nl <= nr
            small_slot = torch.where(left_small, leaf, R)
            pay = full * (row_leaf == small_slot)[:, None].to(full.dtype)
            small = window_hist(self.bins, pay, B, 0, n,
                                pay_absmax=masked_absmax(
                                    st.absmax, torch.where(
                                        left_small, nl_loc, nr_loc), n))
            if d is not None:
                small, ef = d.reduce_hist(small, ef)
            other = subtract_histogram(self.hists[leaf], small)
            lh = torch.where(left_small, small, other)
            rh = torch.where(left_small, other, small)
            self.hists[leaf] = lh
            self.hists[R] = rh
            pb = self.best[leaf]
            cnt2 = torch.stack([nl, nr]).to(torch.float32)
            rec, masks = self._search(
                torch.stack([lh, rh]),
                torch.stack([pb[F_["left_sum_g"]], pb[F_["right_sum_g"]]]),
                torch.stack([pb[F_["left_sum_h"]], pb[F_["right_sum_h"]]]),
                cnt2, st.fmask,
                torch.stack([pb[F_["left_output"]], pb[F_["right_output"]]]),
                int(t["leaf_depth"][leaf]) + 1, None)
            self._store([leaf, R], rec, masks)
            host = self._host(torch.cat([rec.reshape(-1).double(),
                                         nl.double()[None],
                                         nl_loc.double()[None]]))
            n_left = int(host[-2])
            _apply_split(t, r, leaf, R, ns, n_left, counts[leaf] - n_left)
            counts[R] = counts[leaf] - n_left
            counts[leaf] = n_left
            local[R] = local[leaf] - int(host[-1])
            local[leaf] = int(host[-1])
            recs = host[:-2].reshape(2, NF)
            ok = cfg.max_depth <= 0 or t["leaf_depth"][leaf] < cfg.max_depth
            for i, sl in enumerate((leaf, R)):
                st.best_h[sl] = recs[i]
                st.gains[sl] = recs[i, F_["gain"]] if ok else -np.inf
            ns += 1
        self._cat_masks(t)
        return TreeArrays(**t), row_leaf

    def _refresh_bounds(self, st, ns: int) -> None:
        """Intermediate bounds of every leaf after split ``ns`` (the JAX
        grower's batch fixed point of GoUpToFindLeavesToUpdate): under
        each numerical split on a constrained feature, a leaf of the
        left subtree of an increasing node is capped by the smallest
        output of the right subtree and a leaf of the right subtree is
        floored by the largest output of the left one (the other way
        round for a decreasing node)."""
        t = st.t
        L = self.cfg.num_leaves
        v = t["leaf_value"]
        N = st.anc.shape[1]
        active = np.arange(L) < t["num_leaves"]
        node_mc = self.mono_host[t["split_feature"]].astype(np.int64)
        node_on = (np.arange(N) < ns + 1) & ~t["split_is_cat"][:N] \
            & (node_mc[:N] != 0)
        in_l = (st.anc == 1) & active[:, None] & node_on[None, :]
        in_r = (st.anc == 2) & active[:, None] & node_on[None, :]
        inf = np.float32(np.inf)
        vc = v[:, None]
        lmax_sub = np.where(in_l, vc, -inf).max(axis=0)
        lmin_sub = np.where(in_l, vc, inf).min(axis=0)
        rmax_sub = np.where(in_r, vc, -inf).max(axis=0)
        rmin_sub = np.where(in_r, vc, inf).min(axis=0)
        inc_n = (node_mc[:N] > 0)[None, :]
        st.lmax = np.minimum(
            np.where(in_l & inc_n, rmin_sub[None, :], inf).min(axis=1),
            np.where(in_r & ~inc_n, lmin_sub[None, :], inf).min(axis=1)
        ).astype(np.float32)
        st.lmin = np.maximum(
            np.where(in_r & inc_n, lmax_sub[None, :], -inf).max(axis=1),
            np.where(in_l & ~inc_n, rmax_sub[None, :], -inf).max(axis=1)
        ).astype(np.float32)

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
        if self.dist is not None:
            sums = self.dist.sum(sums)
        sums = sums.to(torch.float32)
        out = leaf_output(sums[:, 0], sums[:, 1], self.cfg.split)
        return out.cpu().numpy()


def _grow_signature(args, kwargs) -> tuple:
    """A tree's cost signature: ``(n, F, B, num_leaves, payload dtype)``
    and the device."""
    g = args[0]
    return (g.n, g.F, g.cfg.num_bins, g.cfg.num_leaves,
            "int8" if g.cfg.quantized else "float32", str(g.dev))


_grow_tree = register_jit("ops/grow_tree", Grower._grow, max_signatures=8,
                          signature=_grow_signature)
_dp_grow = register_jit("parallel/dp_grow", Grower._grow, max_signatures=8,
                        signature=_grow_signature)


def _identity(h):
    return h


def grow_tree(cfg: GrowConfig, bins: torch.Tensor, grad: torch.Tensor,
              hess: torch.Tensor, feat_num_bins, feat_nan_bin,
              feature_mask=None):
    """One tree over row-major ``bins`` ``[n, F]``: ``(TreeArrays,
    row_leaf)``."""
    g = Grower(cfg, bins, feat_num_bins, feat_nan_bin, feature_mask)
    return g.grow(grad, hess)
