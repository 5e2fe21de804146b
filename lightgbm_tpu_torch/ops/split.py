"""Best-split search over histograms, as torch ops.

Counterpart of ``lightgbm_tpu/ops/split.py`` (``find_best_split``,
``find_best_split_bundled``, ``_cat_split_eval``, the exact-output
helpers, ``SplitParams``), batched over a leading candidate axis so the
two children of a split are searched in one pass. The arithmetic follows
the JAX functions step for step in float32:

- the per-bin count channel is estimated from the hessian ratio,
  ``round(hess * parent_cnt / parent_hess)`` (round half to even);
- the dual missing-direction scan: the missing (NaN) bin is taken out of
  the prefix scan and joins the right side (direction 0) or the left
  side (direction 1, only for features with a missing bin);
- ``min_data_in_leaf``, ``min_sum_hessian_in_leaf``, L1/L2,
  ``max_delta_step`` and ``min_gain_to_split`` (through the parent-gain
  shift);
- categorical features (``feat_is_cat``): their numerical candidates are
  masked, and three more directions join the stack — one-hot (2),
  forward (3) and backward (4) sorted subsets (:func:`_cat_split_eval`);
  a categorical winner carries its ``[B]`` mask of the bins sent left;
- the exact-output path (``path_smooth > 0`` or monotone ``bounds``):
  every candidate's gain is taken at its smoothed, clamped output
  (:func:`constrained_output`, :func:`gain_at_output`), and the shift at
  the parent's smoothed output; monotone signs reject numerical
  candidates whose outputs break their direction, and
  ``monotone_penalty`` scales the net gains of constrained features by
  the depth multiplier;
- advanced monotone bounds (:class:`AdvancedBounds`): each candidate's
  children clamp into their own bounds at its ``(feature, threshold)``,
  categorical candidates into scalar fallbacks;
- a per-feature ``gain_penalty`` (CEGB) subtracted from the net gains;
- the winner is the first maximum of the flattened ``[direction,
  feature, bin]`` gains — the JAX flat-argmax tie-break.

:func:`forced_result` builds the record of a given ``(feature, bin)``
(forced splits).

The result is one float32 record per candidate (:data:`FIELDS`), so a
whole split's search comes back to the host in one transfer; with
``feat_is_cat`` the searches also return each candidate's ``[C, B]``
membership mask, which stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SplitParams", "FIELDS", "AdvancedBounds", "find_best_split",
           "find_best_split_bundled", "forced_result", "BundleTables",
           "leaf_output", "leaf_gain", "gain_at_output", "smooth_output",
           "constrained_output", "monotone_penalty_mult"]

K_EPS = 1e-15

# columns of a split record; ``direction`` is the winner's stack index:
# 0/1 numerical (default right/left), 2 one-hot, 3/4 sorted subsets
FIELDS = ("gain", "feature", "threshold_bin", "default_left",
          "left_sum_g", "left_sum_h", "left_count",
          "right_sum_g", "right_sum_h", "right_count",
          "left_output", "right_output", "parent_output", "direction")
F_ = {name: i for i, name in enumerate(FIELDS)}


class SplitParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    # categorical splits (feature_histogram.cpp categorical path)
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    # leaf-output smoothing toward the parent's output
    path_smooth: float = 0.0
    # depth-based gain penalty on monotone-feature splits
    monotone_penalty: float = 0.0


def _threshold_l1(s, l1):
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp_min(torch.abs(s) - l1, 0.0)


def leaf_output(sum_g, sum_h, p: SplitParams):
    """-T_l1(g) / (h + l2), clipped by max_delta_step."""
    w = -_threshold_l1(sum_g, p.lambda_l1) / (sum_h + p.lambda_l2 + K_EPS)
    if p.max_delta_step > 0.0:
        w = torch.clamp(w, -p.max_delta_step, p.max_delta_step)
    return w


def leaf_gain(sum_g, sum_h, p: SplitParams):
    """Gain of a leaf at its optimal (possibly clipped) output."""
    if p.max_delta_step > 0.0:
        w = leaf_output(sum_g, sum_h, p)
        t = _threshold_l1(sum_g, p.lambda_l1)
        return -(2.0 * t * w + (sum_h + p.lambda_l2) * w * w)
    t = _threshold_l1(sum_g, p.lambda_l1)
    return t * t / (sum_h + p.lambda_l2 + K_EPS)


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32 (through float64)."""
    return (a.double() * b.double() + c.double()).float()


def gain_at_output(sum_g, sum_h, w, p: SplitParams):
    """Leaf gain at a fixed (smoothed or clamped) output,
    ``-(2 t w + (h + l2) w^2)``. The JAX package's compiled search fuses
    the outer multiply-add (XLA contracts it into one FMA), so it is
    taken here with one rounding too: ties between candidates whose
    outputs are clamped to the same bound are broken as there."""
    t = _threshold_l1(sum_g, p.lambda_l1)
    return -_fma(2.0 * t, w, (sum_h + p.lambda_l2) * w * w)


def smooth_output(w, cnt, parent_output, p: SplitParams):
    """``w*(n/s)/(n/s+1) + parent/(n/s+1)`` with ``s = path_smooth``;
    ``n/s`` as ``n * float32(1/s)``, XLA's form of a division by a
    constant."""
    if p.path_smooth <= 0.0:
        return w
    a = cnt * float(np.float32(1.0) / np.float32(p.path_smooth))
    return w * a / (a + 1.0) + parent_output / (a + 1.0)


def constrained_output(sum_g, sum_h, cnt, parent_output, bounds,
                       p: SplitParams):
    """Optimal output, then smoothing, then the monotone clamp into
    ``bounds = (min, max)`` (tensors that broadcast; None: no clamp)."""
    w = leaf_output(sum_g, sum_h, p)
    w = smooth_output(w, cnt, parent_output, p)
    if bounds is not None:
        w = torch.minimum(torch.maximum(w, bounds[0]), bounds[1])
    return w


def monotone_penalty_mult(leaf_depth: int, p: SplitParams) -> float:
    """The gain multiplier of monotone-feature splits at a depth, in the
    JAX function's float32 steps."""
    pen = np.float32(p.monotone_penalty)
    d = np.float32(leaf_depth)
    one, eps = np.float32(1.0), np.float32(K_EPS)
    if pen <= 0.0:
        return 1.0
    if pen >= d + one:
        return float(eps)
    if pen <= 1.0:
        return float(one - pen / np.exp2(d) + eps)
    return float(one - np.exp2(pen - one - d) + eps)


def _parent_gain_shifted(total, p: SplitParams, p_out):
    """``[C]``: the parent gain at its (smoothed) output plus
    ``min_gain_to_split``, subtracted from every candidate."""
    if p.path_smooth > 0.0:
        w_parent = smooth_output(leaf_output(total[:, 0], total[:, 1], p),
                                 total[:, 2], p_out, p)
        parent_gain = gain_at_output(total[:, 0], total[:, 1], w_parent, p)
    else:
        parent_gain = leaf_gain(total[:, 0], total[:, 1], p)
    return parent_gain + p.min_gain_to_split


def _winner_outputs(sel, total, is_sorted_cat, exact, p: SplitParams,
                    p_out, b_lw, b_rw):
    """The winners' child outputs (``sel`` ``[C, 3]`` left sums):
    sorted-subset winners take ``l2 + cat_l2``; the exact path smooths
    and clamps, the left child into ``b_lw`` and the right one into
    ``b_rw`` (``[C]`` ``(min, max)`` pairs, or None)."""
    p_cat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
    out = []
    for s, bw in ((sel, b_lw), (total - sel, b_rw)):
        g, h, c = s[:, 0], s[:, 1], s[:, 2]
        if exact:
            a = constrained_output(g, h, c, p_out, bw, p)
            b = constrained_output(g, h, c, p_out, bw, p_cat)
        else:
            a, b = leaf_output(g, h, p), leaf_output(g, h, p_cat)
        out.append(torch.where(is_sorted_cat, b, a))
    return out


class AdvancedBounds(NamedTuple):
    """Advanced monotone bounds of ``C`` leaves (the JAX 6-tuple of
    ``split_bounds_lrc``): each numerical candidate ``(f, t)`` clamps its
    left child into ``(lmin_l, lmax_l)[c, f, t]`` and its right child
    into ``(lmin_r, lmax_r)[c, f, t]`` (``[C, F, B]`` over original
    features and their local bins); categorical candidates clamp both
    children into ``(smin, smax)[c]``."""
    lmin_l: torch.Tensor
    lmax_l: torch.Tensor
    lmin_r: torch.Tensor
    lmax_r: torch.Tensor
    smin: torch.Tensor
    smax: torch.Tensor


def _bound_sets(bounds):
    """``(left, right, cat)`` ``(min, max)`` pairs that broadcast over
    ``[C, F, B]``: one pair for all three from a ``[C, 2]`` tensor
    (basic and intermediate), per-threshold pairs from
    :class:`AdvancedBounds`; None without bounds."""
    if bounds is None:
        return None, None, None
    if isinstance(bounds, AdvancedBounds):
        return ((bounds.lmin_l, bounds.lmax_l),
                (bounds.lmin_r, bounds.lmax_r),
                (bounds.smin[:, None, None], bounds.smax[:, None, None]))
    b = (bounds[:, 0, None, None], bounds[:, 1, None, None])
    return b, b, b


def _winner_bounds(bounds, is_cat, at):
    """The winners' ``[C]`` (left, right) bound pairs: ``at(arr)`` reads
    a ``[C, F, B]`` advanced bound at each winner's cell; categorical
    winners take the scalar fallbacks."""
    if bounds is None:
        return None, None
    if not isinstance(bounds, AdvancedBounds):
        b = (bounds[:, 0], bounds[:, 1])
        return b, b

    def pick(arr, fallback):
        return torch.where(is_cat, fallback, at(arr))
    return ((pick(bounds.lmin_l, bounds.smin),
             pick(bounds.lmax_l, bounds.smax)),
            (pick(bounds.lmin_r, bounds.smin),
             pick(bounds.lmax_r, bounds.smax)))


_SCAN_BLOCK = 16


def _prefix_sums(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums along ``dim``, taken in the order of XLA's
    CPU cumsum (a reduce-window that XLA rewrites into 16-element
    blocks): sequential within each block, the blocks' totals summed the
    same way (recursively), and each block's carry added to its sums.

    Float sums of different orders round differently, and two
    thresholds that cut a leaf's rows identically tie exactly in real
    arithmetic — common with quantized gradients, whose histograms hold
    few distinct integer sums — so the order decides which one wins.
    This order makes the port pick the JAX package's threshold on the
    CPU."""
    n = x.shape[dim]
    if n <= _SCAN_BLOCK:
        return _sequential_cumsum(x, dim)
    x = x.movedim(dim, -2)                        # [..., n, k]
    nb = -(-n // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))],
                      dim=-2)
    blocks = x.reshape(x.shape[:-2] + (nb, _SCAN_BLOCK, x.shape[-1]))
    within = _sequential_cumsum(blocks, -2)
    carry = _prefix_sums(within[..., -1, :], dim=-2)   # [..., nb, k]
    excl = torch.cat([torch.zeros_like(carry[..., :1, :]),
                      carry[..., :-1, :]], dim=-2)
    out = (within + excl[..., None, :]).reshape(x.shape)
    return out[..., :n, :].movedim(-2, dim)


def _sequential_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Float32 prefix sums along ``dim`` (not the innermost dimension),
    each output the previous one plus the next input. ``torch.cumsum``
    is exactly that on CUDA (one thread walks the dimension with a
    float32 sum), but on the CPU it sums in float64 and rounds each
    output, so there the adds are written out."""
    if x.device.type != "cpu":
        return torch.cumsum(x, dim=dim)
    out = x.clone()
    o = out.movedim(dim, 0)
    for i in range(1, o.shape[0]):
        o[i] += o[i - 1]
    return out


class _CatEval(NamedTuple):
    gains_oh: torch.Tensor     # [C, F, B] one-hot candidates (bin t)
    gains_fwd: torch.Tensor    # [C, F, B] forward prefixes (size t + 1)
    gains_bwd: torch.Tensor    # [C, F, B] backward prefixes
    csum_f: torch.Tensor       # [C, F, B, 3] prefix sums, forward
    csum_b: torch.Tensor       # [C, F, B, 3] prefix sums, backward
    inv: torch.Tensor          # [C, F, B] bin -> rank in the sort
    used: torch.Tensor         # [C, F] participating bins
    participate: torch.Tensor  # [C, F, B]


def _cat_split_eval(h3, parent_g, parent_h, parent_cnt, feat_num_bins,
                    p: SplitParams, parent_output=None,
                    bd=None) -> _CatEval:
    """Categorical candidates of ``C`` leaves over ``[C, F, B, 3]``
    (g, h, estimated count) histograms, every feature at once: features
    of at most ``max_cat_to_onehot`` bins take the one-hot scan (each bin
    alone on the left, plain ``lambda_l2``); the others sort their bins
    with ``count >= cat_smooth`` stably by ``g / (h + cat_smooth)`` and
    scan prefixes from both ends, the left set at most
    ``min(max_cat_threshold, (used + 1) // 2)`` bins, with ``l2 +
    cat_l2``. As in the JAX function, LightGBM's sequential
    ``min_data_per_group`` regrouping is relaxed to ``left_count >=
    min_data_per_group`` (and the right side at least ``max(
    min_data_in_leaf, min_data_per_group)``). ``bd``: the ``(min, max)``
    bounds of the categorical candidates' outputs."""
    C, F, B, _ = h3.shape
    dev = h3.device
    neg_inf = torch.tensor(float("-inf"), dtype=h3.dtype, device=dev)
    bins = torch.arange(B, device=dev)
    fnb = feat_num_bins.to(device=dev, dtype=torch.int64)
    in_range = (bins[None, :] < fnb[:, None])[None]          # [1, F, B]
    h3 = torch.where(in_range[..., None], h3, torch.zeros_like(h3))
    g, h, c = h3[..., 0], h3[..., 1], h3[..., 2]
    pg, ph, pc = (x[:, None, None] for x in (parent_g, parent_h,
                                              parent_cnt))
    p_cat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
    exact = p.path_smooth > 0.0 or bd is not None
    po = parent_output[:, None, None]

    def pair_gain(lg, lh, lc, rg, rh, rc, pp):
        if not exact:
            return leaf_gain(lg, lh, pp) + leaf_gain(rg, rh, pp)
        wl = constrained_output(lg, lh, lc, po, bd, pp)
        wr = constrained_output(rg, rh, rc, po, bd, pp)
        return gain_at_output(lg, lh, wl, pp) + gain_at_output(rg, rh, wr,
                                                               pp)

    # one-hot: the left side is one bin
    rg, rh, rc = pg - g, ph - h, pc - c
    valid_oh = (in_range
                & (c >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                & (h >= p.min_sum_hessian_in_leaf)
                & (rh >= p.min_sum_hessian_in_leaf) & (c > 0) & (rc > 0))
    use_onehot = (fnb <= p.max_cat_to_onehot)[None, :, None]
    gains_oh = torch.where(use_onehot & valid_oh,
                           pair_gain(g, h, c, rg, rh, rc, p), neg_inf)

    # sorted subsets
    participate = in_range & (c >= p.cat_smooth)              # [C, F, B]
    ratio = torch.where(participate, g / (h + p.cat_smooth),
                        torch.tensor(float("inf"), dtype=h3.dtype,
                                     device=dev))
    order = torch.argsort(ratio, dim=2, stable=True)
    inv = torch.argsort(order, dim=2, stable=True)
    used = participate.sum(dim=2)                             # [C, F]
    part_sorted = participate.gather(2, order)
    idx3 = order[..., None].expand(-1, -1, -1, 3)
    stats_sorted = h3.gather(2, idx3) * part_sorted[..., None].to(h3.dtype)
    csum_f = _prefix_sums(stats_sorted, dim=2)
    rev_pos = torch.clamp(used[..., None] - 1 - bins, 0, B - 1)
    stats_rev = stats_sorted.gather(2, rev_pos[..., None].expand(-1, -1,
                                                                  -1, 3))
    csum_b = _prefix_sums(stats_rev, dim=2)
    max_num_cat = torch.clamp_max((used + 1) // 2, p.max_cat_threshold)
    pos_ok = (bins < max_num_cat[..., None]) & (bins < used[..., None])
    right_min = max(p.min_data_in_leaf, p.min_data_per_group)

    def prefix_gains(csum):
        lg, lh, lc = csum[..., 0], csum[..., 1], csum[..., 2]
        rg_, rh_, rc_ = pg - lg, ph - lh, pc - lc
        valid = (pos_ok
                 & (lc >= p.min_data_in_leaf) & (lc >= p.min_data_per_group)
                 & (lh >= p.min_sum_hessian_in_leaf)
                 & (rc_ >= right_min) & (rh_ >= p.min_sum_hessian_in_leaf)
                 & (lc > 0) & (rc_ > 0))
        gain = pair_gain(lg, lh, lc, rg_, rh_, rc_, p_cat)
        return torch.where(valid & ~use_onehot, gain, neg_inf)

    return _CatEval(gains_oh, prefix_gains(csum_f), prefix_gains(csum_b),
                    csum_f, csum_b, inv, used, participate)


def _cat_masks(ce: _CatEval, d, col, t, oh_bin):
    """``[C, B]`` bins sent left by each winner: the one-hot bin
    ``oh_bin``, or the forward/backward prefix of column ``col`` at
    position ``t``; none for a numerical winner."""
    C, _, B = ce.inv.shape
    ci = torch.arange(C, device=d.device)
    bins = torch.arange(B, device=d.device)
    inv, part = ce.inv[ci, col], ce.participate[ci, col]      # [C, B]
    used = ce.used[ci, col][:, None]
    t = t[:, None]
    fwd = part & (inv <= t)
    bwd = part & (inv >= used - 1 - t)
    d = d[:, None]
    mask = torch.where(d == 2, bins[None, :] == oh_bin[:, None],
                       torch.where(d == 3, fwd, bwd))
    return mask & (d >= 2)


def _with_counts(hist, parent_cnt, parent_h):
    cnt_factor = parent_cnt / torch.clamp_min(parent_h, K_EPS)
    return torch.cat([hist, torch.round(hist[..., 1:2]
                                        * cnt_factor[:, None, None, None])],
                     dim=-1)


def _mono_pen(nets, is_mono, leaf_depth, p):
    """The depth penalty on the net gains of constrained features (all
    stacks, as in the JAX functions); ``leaf_depth`` is the candidates'
    common depth or one depth per candidate."""
    if np.ndim(leaf_depth) == 0:
        mult = torch.tensor(monotone_penalty_mult(int(leaf_depth), p),
                            dtype=nets.dtype, device=nets.device)
    else:
        mult = torch.tensor([monotone_penalty_mult(int(d), p)
                             for d in leaf_depth], dtype=nets.dtype,
                            device=nets.device)[:, None, None, None]
    return torch.where(is_mono, nets * mult, nets)


def find_best_split(hist: torch.Tensor, parent_g: torch.Tensor,
                    parent_h: torch.Tensor, parent_cnt: torch.Tensor,
                    feat_num_bins: torch.Tensor, feat_nan_bin: torch.Tensor,
                    feature_mask: torch.Tensor, p: SplitParams,
                    feat_is_cat: torch.Tensor = None,
                    monotone: torch.Tensor = None,
                    parent_output: torch.Tensor = None, leaf_depth=0,
                    bounds=None, gain_penalty: torch.Tensor = None,
                    feature_gains: bool = False):
    """Best split of each of ``C`` leaves.

    Args:
      hist: ``[C, F, B, 2]`` f32 (sum_grad, sum_hess).
      parent_g, parent_h, parent_cnt: ``[C]`` f32 leaf totals
        (``parent_cnt`` is the exact row count).
      feat_num_bins, feat_nan_bin: ``[F]`` int (missing bin or -1).
      feature_mask: ``[F]`` bool usable features, or ``[C, F]``: one
        mask per leaf (per-node column sampling).
      feat_is_cat: ``[F]`` bool categorical features (None: none).
      monotone: ``[F]`` int8 signs in {-1, 0, +1} (None: unconstrained).
      parent_output: ``[C]`` f32 each leaf's current output (path
        smoothing's parent; None: 0).
      leaf_depth: the leaves' depth (the monotone penalty), or a
        sequence of ``C`` depths.
      bounds: ``[C, 2]`` f32 each leaf's monotone output ``(min, max)``,
        or :class:`AdvancedBounds` (None: no bounds).
      gain_penalty: ``[C, F]`` f32 subtracted from every candidate's net
        gain of each feature (CEGB; None: none).
      feature_gains: also return each feature's best net gain ``[C, F]``
        (the voting learner's local ballot), as the last element.
    Returns:
      ``[C, len(FIELDS)]`` f32 records. ``gain`` is net of the parent
      gain and ``min_gain_to_split`` (> 0 means worth splitting) and
      ``-inf`` when no split is valid; counts are hessian-ratio
      estimates. With ``feat_is_cat``, ``(records, masks)``: ``masks``
      ``[C, B]`` bool are the bins a categorical winner sends left.
    """
    C, F, B, _ = hist.shape
    dev = hist.device
    neg_inf = torch.tensor(float("-inf"), dtype=hist.dtype, device=dev)
    h3 = _with_counts(hist, parent_cnt, parent_h)           # [C, F, B, 3]
    total = torch.stack([parent_g, parent_h, parent_cnt], dim=-1)  # [C, 3]

    fnb = feat_num_bins.to(device=dev, dtype=torch.int64)
    fnan = feat_nan_bin.to(device=dev, dtype=torch.int64)
    has_nan = fnan >= 0
    nan_idx = torch.clamp_min(fnan, 0)
    at_nan = h3[:, torch.arange(F, device=dev), nan_idx, :]   # [C, F, 3]
    nan_stats = torch.where(has_nan[None, :, None], at_nan,
                            torch.zeros_like(at_nan))
    bins = torch.arange(B, device=dev)
    miss = ((bins[None, :] == nan_idx[:, None])
            & has_nan[:, None]).to(hist.dtype)              # [F, B]
    cum = _prefix_sums(h3 - miss[None, :, :, None]
                       * nan_stats[:, :, None, :], dim=2)

    exact = p.path_smooth > 0.0 or bounds is not None
    p_out = torch.zeros_like(parent_g) if parent_output is None \
        else parent_output
    po = p_out[:, None, None]
    bl, br, bc = _bound_sets(bounds)
    mc = None if monotone is None \
        else monotone.to(device=dev, dtype=torch.int64)[None, :, None]

    def eval_dir(left, t_valid):
        right = total[:, None, None, :] - left
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = right[..., 0], right[..., 1], right[..., 2]
        valid = (t_valid[None]
                 & (lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                 & (lh >= p.min_sum_hessian_in_leaf)
                 & (rh >= p.min_sum_hessian_in_leaf)
                 & (lc > 0) & (rc > 0))
        if exact:
            lo = constrained_output(lg, lh, lc, po, bl, p)
            ro = constrained_output(rg, rh, rc, po, br, p)
            gain = gain_at_output(lg, lh, lo, p) + gain_at_output(rg, rh,
                                                                 ro, p)
        else:
            gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p)
        if mc is not None:
            if not exact:
                lo, ro = leaf_output(lg, lh, p), leaf_output(rg, rh, p)
            valid = valid & ~((mc > 0) & (lo > ro)) & ~((mc < 0) & (lo < ro))
        return torch.where(valid, gain, neg_inf)

    gains_r = eval_dir(cum, bins[None, :] < fnb[:, None])
    left_l = cum + nan_stats[:, :, None, :]
    gains_l = eval_dir(left_l, has_nan[:, None]
                       & (bins[None, :] < (fnb - 1)[:, None]))
    fmask = feature_mask.to(device=dev, dtype=torch.bool)
    fmask = fmask[None, :, None] if fmask.dim() == 1 else fmask[:, :, None]
    gains_r = torch.where(fmask, gains_r, neg_inf)
    gains_l = torch.where(fmask, gains_l, neg_inf)
    stacks = [gains_r, gains_l]
    ce = None
    if feat_is_cat is not None:
        is_cat = feat_is_cat.to(device=dev, dtype=torch.bool)[None, :, None]
        stacks = [torch.where(is_cat, neg_inf, s) for s in stacks]
        ce = _cat_split_eval(h3, parent_g, parent_h, parent_cnt, fnb, p,
                             p_out, bc)
        cmask = fmask & is_cat
        stacks += [torch.where(cmask, s, neg_inf)
                   for s in (ce.gains_oh, ce.gains_fwd, ce.gains_bwd)]

    shift = _parent_gain_shifted(total, p, p_out)[:, None, None, None]
    nets = torch.stack(stacks, dim=1) - shift              # [C, D, F, B]
    if gain_penalty is not None:
        gp = gain_penalty.to(device=dev, dtype=nets.dtype)
        nets = nets - (gp[None, None, :, None] if gp.dim() == 1
                       else gp[:, None, :, None])
    if mc is not None and p.monotone_penalty > 0.0:
        nets = _mono_pen(nets, (mc != 0)[:, None], leaf_depth, p)
    flat = nets.reshape(C, -1)
    idx = torch.argmax(flat, dim=1)                          # first max
    best = flat.gather(1, idx[:, None])[:, 0]
    d = idx // (F * B)
    f = (idx // B) % F
    t = idx % B
    ci = torch.arange(C, device=dev)
    num_left = cum[ci, f, t, :]
    cands = [num_left, num_left + nan_stats[ci, f, :]]
    if ce is not None:
        cands += [h3[ci, f, t, :], ce.csum_f[ci, f, t, :],
                  ce.csum_b[ci, f, t, :]]
    sel = torch.stack(cands, dim=1)[ci, d]                   # [C, 3]
    gain = torch.where(torch.isfinite(best), best, neg_inf)
    b_lw, b_rw = _winner_bounds(bounds, d >= 2, lambda a: a[ci, f, t])
    lo, ro = _winner_outputs(sel, total, d >= 3, exact, p, p_out, b_lw,
                             b_rw)
    rec = _record(gain, f, t, d, sel, total, lo, ro, p)
    out = (rec,) if ce is None else (rec, _cat_masks(ce, d, f, t, t))
    if feature_gains:
        out = out + (nets.amax(dim=(1, 3)),)
    return out[0] if len(out) == 1 else out


def _record(gain, f, t, d, sel, total, lo, ro, p):
    ftype = sel.dtype
    lg, lh, lc = sel[:, 0], sel[:, 1], sel[:, 2]
    rg, rh, rc = total[:, 0] - lg, total[:, 1] - lh, total[:, 2] - lc
    return torch.stack([
        gain, f.to(ftype), t.to(ftype), (d == 1).to(ftype),
        lg, lh, lc, rg, rh, rc, lo, ro,
        leaf_output(lg + rg, lh + rh, p), d.to(ftype),
    ], dim=1)


class BundleTables(NamedTuple):
    """The bundling plan's search tables on the device (``BundleInfo``
    fields): ``member_at``, ``tloc_at``, ``end_at``, ``nanpos_at`` and
    ``nan_at`` ``[G, B]``, ``is_direct`` ``[F]``."""
    member_at: torch.Tensor
    tloc_at: torch.Tensor
    end_at: torch.Tensor
    nanpos_at: torch.Tensor
    nan_at: torch.Tensor
    is_direct: torch.Tensor

    @classmethod
    def of(cls, info, device) -> "BundleTables":
        def dev(a, dtype):
            return torch.as_tensor(a, device=device).to(dtype)
        i64 = torch.int64
        return cls(dev(info.member_at, i64), dev(info.tloc_at, i64),
                   dev(info.end_at, i64), dev(info.nanpos_at, i64),
                   dev(info.nan_at, torch.bool),
                   dev(info.is_direct, torch.bool))


def find_best_split_bundled(hist: torch.Tensor, parent_g: torch.Tensor,
                            parent_h: torch.Tensor,
                            parent_cnt: torch.Tensor, tables: BundleTables,
                            feature_mask: torch.Tensor,
                            p: SplitParams, feat_is_cat: torch.Tensor = None,
                            feat_num_bins: torch.Tensor = None,
                            monotone: torch.Tensor = None,
                            parent_output: torch.Tensor = None,
                            leaf_depth=0, bounds=None,
                            gain_penalty: torch.Tensor = None,
                            col_mask: torch.Tensor = None,
                            feature_gains: bool = False):
    """Best split of each of ``C`` leaves over bundled histograms.

    Every candidate is one (bundle, position) cell. A direct (singleton)
    bundle is scanned as the plain search scans a feature. A member of a
    multi-member bundle has its thresholds at its positions, with
    ``left = total - (range_end_cum - cum)``: its bin-0 mass is the leaf
    total less its range. Members with a NaN bin get the dual
    missing-direction scan: the NaN position (``nan_at``) is left out of
    the prefix sums, and its mass (``nanpos_at``) joins the side the
    direction sends missing rows to.

    Categorical members (``feat_is_cat``, with ``feat_num_bins``): a
    member of a multi-member bundle is in the one-hot regime (bundling
    admits only those), so its candidates are one-hot per position — the
    position's own mass, or the reconstructed bin-0 mass at its ``t =
    0`` cut; a direct categorical column runs the plain categorical
    search (one-hot and sorted subsets) on its row of the histogram.
    Monotone signs apply to numerical candidates only; the depth penalty
    to every candidate of a constrained feature. Advanced bounds and the
    CEGB penalty, given over original features, are read per candidate
    through the position's member (and its local threshold).

    Args:
      hist: ``[C, G, B, 2]`` f32 bundle histograms.
      parent_g, parent_h, parent_cnt: ``[C]`` f32 leaf totals.
      tables: the plan's tables on the device.
      feature_mask: ``[F]`` bool usable original features, or ``[C, F]``.
      feat_is_cat, feat_num_bins, monotone, parent_output, leaf_depth,
        bounds, gain_penalty: as :func:`find_best_split`'s, over original
        features.
    Returns:
      ``[C, len(FIELDS)]`` f32 records, as :func:`find_best_split`'s,
      with the original feature and its member-local threshold bin;
      with ``feat_is_cat``, ``(records, masks)``, the masks over the
      member's local bins.
    """
    C, G, B, _ = hist.shape
    dev = hist.device
    dtype = hist.dtype
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, device=dev)
    h3 = _with_counts(hist, parent_cnt, parent_h)            # [C, G, B, 3]
    total = torch.stack([parent_g, parent_h, parent_cnt], dim=-1)  # [C, 3]
    tot = total[:, None, None, :]

    has_member = tables.member_at >= 0
    member_ix = torch.clamp_min(tables.member_at, 0)
    direct_pos = (tables.is_direct[member_ix] & has_member)[None, :, :, None]
    has_nan = tables.nanpos_at >= 0                          # [G, B]
    cum = _prefix_sums(h3 * (~tables.nan_at)[None, :, :, None].to(dtype),
                       dim=2)
    end = torch.clamp(tables.end_at, 0, G * B - 1).reshape(-1)
    e = cum.reshape(C, G * B, 3)[:, end].reshape(C, G, B, 3)
    npos = torch.clamp(tables.nanpos_at, 0, G * B - 1).reshape(-1)
    nan_stats = h3.reshape(C, G * B, 3)[:, npos].reshape(C, G, B, 3) \
        * has_nan[None, :, :, None].to(dtype)

    fmask = feature_mask.to(device=dev, dtype=torch.bool)
    fmask = fmask[member_ix][None] if fmask.dim() == 1 \
        else fmask[:, member_ix]                             # [C', G, B]
    if col_mask is not None:
        # the bundle columns a distributed search may use: [G] or [C, G]
        cm = col_mask.to(device=dev, dtype=torch.bool)
        fmask = fmask & (cm[None, :, None] if cm.dim() == 1
                         else cm[:, :, None])
    if feat_is_cat is not None:
        fcat = feat_is_cat.to(device=dev, dtype=torch.bool)
        is_cat_pos = fcat[member_ix] & has_member            # [G, B]
    else:
        is_cat_pos = torch.zeros_like(has_member)
    exact = p.path_smooth > 0.0 or bounds is not None
    p_out = torch.zeros_like(parent_g) if parent_output is None \
        else parent_output
    po = p_out[:, None, None]
    if isinstance(bounds, AdvancedBounds):
        # [C, F, Bf] -> per candidate [C, G, B]: the member's bound at its
        # local threshold (cells without a member are masked anyway)
        tl = torch.clamp(tables.tloc_at, 0, bounds.lmin_l.shape[2] - 1)
        bounds = AdvancedBounds(*(a[:, member_ix, tl] for a in bounds[:4]),
                                bounds.smin, bounds.smax)
    bl, br, bc = _bound_sets(bounds)
    mc_pos = None
    if monotone is not None:
        mono = monotone.to(device=dev, dtype=torch.int64)[member_ix]
        mc_pos = torch.where(is_cat_pos, 0, mono)[None]     # [1, G, B]
        mono_pos = ((mono != 0) & has_member)[None, None]

    def eval_left(left, extra_valid, bl=bl, br=br):
        right = tot - left
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = right[..., 0], right[..., 1], right[..., 2]
        valid = (extra_valid[None] & fmask
                 & (lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                 & (lh >= p.min_sum_hessian_in_leaf)
                 & (rh >= p.min_sum_hessian_in_leaf)
                 & (lc > 0) & (rc > 0))
        if exact:
            lo = constrained_output(lg, lh, lc, po, bl, p)
            ro = constrained_output(rg, rh, rc, po, br, p)
            gain = gain_at_output(lg, lh, lo, p) + gain_at_output(rg, rh,
                                                                 ro, p)
        else:
            gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p)
        if mc_pos is not None:
            if not exact:
                lo, ro = leaf_output(lg, lh, p), leaf_output(rg, rh, p)
            valid = valid & ~((mc_pos > 0) & (lo > ro)) \
                & ~((mc_pos < 0) & (lo < ro))
        return torch.where(valid, gain, neg_inf)

    # direction 0: missing goes right; a member's right side is its
    # positions after t plus its NaN mass
    left1 = torch.where(direct_pos, cum, tot - (e - cum) - nan_stats)
    g1 = eval_left(left1, has_member & ~is_cat_pos)
    # direction 1: missing joins the left side (NaN members only)
    left2 = torch.where(direct_pos, cum + nan_stats, tot - (e - cum))
    g2 = eval_left(left2, has_member & has_nan & ~is_cat_pos)
    stacks = [g1, g2]
    cands = [left1, left2]
    ce = None
    if feat_is_cat is not None:
        tloc, end_at = tables.tloc_at, tables.end_at
        # a member's bins: nb = end - pos + tloc + 1 in both layouts
        end_pos = end_at - (torch.arange(G, device=dev) * B)[:, None]
        nb_at = end_pos - torch.arange(B, device=dev)[None, :] + tloc + 1
        use_oh = nb_at <= p.max_cat_to_onehot
        # one-hot: the position's own mass; a multi member's t = 0 cut
        # is its reconstructed bin-0 mass
        left_oh = torch.where(((tloc == 0) & ~tables.is_direct[member_ix]
                               )[None, :, :, None], tot - (e - cum), h3)
        g_oh = eval_left(left_oh, has_member & is_cat_pos & use_oh, bc, bc)
        # sorted subsets on direct categorical columns, whose histogram
        # rows are their features'
        direct_member = member_ix[:, 0]
        col_cat = tables.is_direct[direct_member] & fcat[direct_member] \
            & (tables.member_at[:, 0] >= 0)
        col_nb = torch.where(col_cat, feat_num_bins.to(dev, torch.int64)
                             [direct_member], 0)
        ce = _cat_split_eval(h3, parent_g, parent_h, parent_cnt, col_nb, p,
                             p_out, bc)
        # a direct column's position 0 holds its feature's mask
        cmask = (col_cat[None, :] & fmask[:, :, 0])[:, :, None]
        stacks += [g_oh, torch.where(cmask, ce.gains_fwd, neg_inf),
                   torch.where(cmask, ce.gains_bwd, neg_inf)]
        cands += [left_oh, ce.csum_f, ce.csum_b]

    shift = _parent_gain_shifted(total, p, p_out)[:, None, None, None]
    if gain_penalty is not None:
        # CEGB per original feature, through the position's member
        gp = gain_penalty.to(device=dev, dtype=dtype)
        gp = gp[None] if gp.dim() == 1 else gp
        shift = shift + torch.where(has_member[None], gp[:, member_ix],
                                    0.0)[:, None]
    net = torch.stack(stacks, dim=1) - shift                 # [C, D, G, B]
    if mc_pos is not None and p.monotone_penalty > 0.0:
        net = _mono_pen(net, mono_pos, leaf_depth, p)
    net = torch.where(torch.isfinite(net), net, neg_inf)
    flat = net.reshape(C, -1)
    idx = torch.argmax(flat, dim=1)                          # first max
    best = flat.gather(1, idx[:, None])[:, 0]
    d = idx // (G * B)
    g = (idx // B) % G
    pos = idx % B
    ci = torch.arange(C, device=dev)
    sel = torch.stack([c[ci, g, pos] for c in cands], dim=1)[ci, d]
    gain = torch.where(torch.isfinite(best), best, neg_inf)
    b_lw, b_rw = _winner_bounds(bounds, d >= 2, lambda a: a[ci, g, pos])
    lo, ro = _winner_outputs(sel, total, d >= 3, exact, p, p_out, b_lw,
                             b_rw)
    tl = tables.tloc_at[g, pos]
    rec = _record(gain, tables.member_at[g, pos], tl, d, sel, total, lo, ro,
                  p)
    out = (rec,) if ce is None else (rec, _cat_masks(ce, d, g, pos, tl))
    if feature_gains:
        out = out + (net.amax(dim=(1, 3)),)
    return out[0] if len(out) == 1 else out


def forced_result(hist: torch.Tensor, leaf_cnt: torch.Tensor, f: int,
                  t: int, parent_output: torch.Tensor, bounds,
                  p: SplitParams, exact: bool, rules) -> torch.Tensor:
    """The record of a forced split of feature ``f`` at bin ``t`` (the
    JAX grower's ``forced_result``, ForceSplits): missing rows go right,
    the children's counts are hessian-ratio estimates from the leaf's
    exact count ``leaf_cnt``, and with ``exact`` (path smoothing or
    monotone constraints) the outputs are smoothed and clamped into
    ``bounds`` (``(min, max)`` floats, or None) and the gain taken at
    them, against the parent's gain at ``parent_output``.

    ``hist`` is the leaf's ``[C, B, 2]`` f32 histogram over the grower's
    columns; ``rules`` (:class:`ops.partition.RangeRules`) places ``f``
    in them: its own column, or a bundle column where a member of a
    multi-member bundle has its left side reconstructed from the leaf
    totals (the FixHistogram algebra). Returns one ``[len(FIELDS)]``
    f32 record (``direction`` 0)."""
    dev = hist.device
    B = hist.shape[1]
    tg, th = hist[0].sum(dim=0).unbind()        # every row hits column 0
    h = hist[int(rules.col[f])]
    bins = torch.arange(B, device=dev)
    nanb = int(rules.nan[f])
    sel = bins <= t
    if nanb >= 0:
        sel = sel & (bins != nanb)
    if rules.direct[f]:
        left = (h * sel[:, None].to(h.dtype)).sum(dim=0)
    else:
        off, nb = int(rules.off[f]), int(rules.nb[f])
        rsel = (bins >= off + t) & (bins <= off + nb - 2)
        left = torch.stack([tg, th]) \
            - (h * rsel[:, None].to(h.dtype)).sum(dim=0)
    lg, lh = left[0], left[1]
    tc = leaf_cnt.to(torch.float32)
    lc = torch.round(lh * tc / torch.clamp_min(th, K_EPS))
    rg, rh, rc = tg - lg, th - lh, tc - lc
    if exact:
        bd = None if bounds is None else tuple(
            torch.tensor(b, dtype=torch.float32, device=dev)
            for b in bounds)
        wl = constrained_output(lg, lh, lc, parent_output, bd, p)
        wr = constrained_output(rg, rh, rc, parent_output, bd, p)
        gain = gain_at_output(lg, lh, wl, p) + gain_at_output(rg, rh, wr, p) \
            - gain_at_output(tg, th, parent_output, p)
    else:
        wl, wr = leaf_output(lg, lh, p), leaf_output(rg, rh, p)
        gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p) \
            - leaf_gain(tg, th, p)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack([
        gain, zero + f, zero + t, zero, lg, lh, lc, rg, rh, rc, wl, wr,
        leaf_output(lg + rg, lh + rh, p), zero])
