"""Best-split search over histograms, numerical path, as torch ops.

Counterpart of ``lightgbm_tpu/ops/split.py`` (``find_best_split``,
``leaf_output``, ``leaf_gain``, ``SplitParams``), batched over a leading
candidate axis so the two children of a split are searched in one pass.
The arithmetic follows the JAX function step for step in float32:

- the per-bin count channel is estimated from the hessian ratio,
  ``round(hess * parent_cnt / parent_hess)`` (round half to even);
- the dual missing-direction scan: the missing (NaN) bin is taken out of
  the prefix scan and joins the right side (direction 0) or the left
  side (direction 1, only for features with a missing bin);
- ``min_data_in_leaf``, ``min_sum_hessian_in_leaf``, L1/L2,
  ``max_delta_step`` and ``min_gain_to_split`` (through the parent-gain
  shift);
- the winner is the first maximum of the flattened ``[direction,
  feature, bin]`` gains — the JAX flat-argmax tie-break.

The result is one float32 record per candidate (:data:`FIELDS`), so a
whole split's search comes back to the host in one transfer.

:func:`find_best_split_bundled` is the search over EFB-bundled
histograms (``ops/bundling.py`` layout), the JAX function of the same
name without its categorical, monotone, CEGB and parallel branches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SplitParams", "FIELDS", "find_best_split",
           "find_best_split_bundled", "BundleTables", "leaf_output",
           "leaf_gain"]

K_EPS = 1e-15

# columns of a split record
FIELDS = ("gain", "feature", "threshold_bin", "default_left",
          "left_sum_g", "left_sum_h", "left_count",
          "right_sum_g", "right_sum_h", "right_count",
          "left_output", "right_output", "parent_output")
F_ = {name: i for i, name in enumerate(FIELDS)}


class SplitParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0


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


def find_best_split(hist: torch.Tensor, parent_g: torch.Tensor,
                    parent_h: torch.Tensor, parent_cnt: torch.Tensor,
                    feat_num_bins: torch.Tensor, feat_nan_bin: torch.Tensor,
                    feature_mask: torch.Tensor,
                    p: SplitParams) -> torch.Tensor:
    """Best split of each of ``C`` leaves.

    Args:
      hist: ``[C, F, B, 2]`` f32 (sum_grad, sum_hess).
      parent_g, parent_h, parent_cnt: ``[C]`` f32 leaf totals
        (``parent_cnt`` is the exact row count).
      feat_num_bins, feat_nan_bin: ``[F]`` int (missing bin or -1).
      feature_mask: ``[F]`` bool usable features, or ``[C, F]``: one
        mask per leaf (per-node column sampling).
    Returns:
      ``[C, len(FIELDS)]`` f32 records. ``gain`` is net of the parent
      gain and ``min_gain_to_split`` (> 0 means worth splitting) and
      ``-inf`` when no split is valid; counts are hessian-ratio
      estimates.
    """
    C, F, B, _ = hist.shape
    dev = hist.device
    neg_inf = torch.tensor(float("-inf"), dtype=hist.dtype, device=dev)
    cnt_factor = parent_cnt / torch.clamp_min(parent_h, K_EPS)
    h3 = torch.cat([hist, torch.round(hist[..., 1:2]
                                      * cnt_factor[:, None, None, None])],
                   dim=-1)                                  # [C, F, B, 3]
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

    def eval_dir(left, t_valid):
        right = total[:, None, None, :] - left
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = right[..., 0], right[..., 1], right[..., 2]
        valid = (t_valid[None]
                 & (lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                 & (lh >= p.min_sum_hessian_in_leaf)
                 & (rh >= p.min_sum_hessian_in_leaf)
                 & (lc > 0) & (rc > 0))
        gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p)
        return torch.where(valid, gain, neg_inf)

    gains_r = eval_dir(cum, bins[None, :] < fnb[:, None])
    left_l = cum + nan_stats[:, :, None, :]
    gains_l = eval_dir(left_l, has_nan[:, None]
                       & (bins[None, :] < (fnb - 1)[:, None]))
    fmask = feature_mask.to(device=dev, dtype=torch.bool)
    fmask = fmask[None, :, None] if fmask.dim() == 1 else fmask[:, :, None]
    gains_r = torch.where(fmask, gains_r, neg_inf)
    gains_l = torch.where(fmask, gains_l, neg_inf)

    shift = leaf_gain(total[:, 0], total[:, 1], p) + p.min_gain_to_split
    nets = torch.stack([gains_r - shift[:, None, None],
                        gains_l - shift[:, None, None]], dim=1)
    flat = nets.reshape(C, -1)
    idx = torch.argmax(flat, dim=1)                          # first max
    best = flat.gather(1, idx[:, None])[:, 0]
    d = idx // (F * B)
    f = (idx // B) % F
    t = idx % B
    ci = torch.arange(C, device=dev)
    sel = cum[ci, f, t, :]
    sel = torch.where((d == 0)[:, None], sel, sel + nan_stats[ci, f, :])
    lg, lh, lc = sel[:, 0], sel[:, 1], sel[:, 2]
    rg, rh, rc = total[:, 0] - lg, total[:, 1] - lh, total[:, 2] - lc
    gain = torch.where(torch.isfinite(best), best, neg_inf)
    ftype = hist.dtype
    return torch.stack([
        gain, f.to(ftype), t.to(ftype), (d == 1).to(ftype),
        lg, lh, lc, rg, rh, rc,
        leaf_output(lg, lh, p), leaf_output(rg, rh, p),
        leaf_output(lg + rg, lh + rh, p),
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
                            p: SplitParams) -> torch.Tensor:
    """Best split of each of ``C`` leaves over bundled histograms.

    Every candidate is one (bundle, position) cell. A direct (singleton)
    bundle is scanned as the plain search scans a feature. A member of a
    multi-member bundle has its thresholds at its positions, with
    ``left = total - (range_end_cum - cum)``: its bin-0 mass is the leaf
    total less its range. Members with a NaN bin get the dual
    missing-direction scan: the NaN position (``nan_at``) is left out of
    the prefix sums, and its mass (``nanpos_at``) joins the side the
    direction sends missing rows to.

    Args:
      hist: ``[C, G, B, 2]`` f32 bundle histograms.
      parent_g, parent_h, parent_cnt: ``[C]`` f32 leaf totals.
      tables: the plan's tables on the device.
      feature_mask: ``[F]`` bool usable original features, or ``[C, F]``.
    Returns:
      ``[C, len(FIELDS)]`` f32 records, as :func:`find_best_split`'s,
      with the original feature and its member-local threshold bin.
    """
    C, G, B, _ = hist.shape
    dev = hist.device
    dtype = hist.dtype
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, device=dev)
    cnt_factor = parent_cnt / torch.clamp_min(parent_h, K_EPS)
    h3 = torch.cat([hist, torch.round(hist[..., 1:2]
                                      * cnt_factor[:, None, None, None])],
                   dim=-1)                                  # [C, G, B, 3]
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

    def eval_left(left, extra_valid):
        right = tot - left
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = right[..., 0], right[..., 1], right[..., 2]
        valid = (extra_valid[None] & fmask
                 & (lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                 & (lh >= p.min_sum_hessian_in_leaf)
                 & (rh >= p.min_sum_hessian_in_leaf)
                 & (lc > 0) & (rc > 0))
        gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p)
        return torch.where(valid, gain, neg_inf)

    # direction 0: missing goes right; a member's right side is its
    # positions after t plus its NaN mass
    left1 = torch.where(direct_pos, cum, tot - (e - cum) - nan_stats)
    g1 = eval_left(left1, has_member)
    # direction 1: missing joins the left side (NaN members only)
    left2 = torch.where(direct_pos, cum + nan_stats, tot - (e - cum))
    g2 = eval_left(left2, has_member & has_nan)

    shift = (leaf_gain(total[:, 0], total[:, 1], p)
             + p.min_gain_to_split)[:, None, None]
    net = torch.stack([g1 - shift, g2 - shift], dim=1)       # [C, 2, G, B]
    net = torch.where(torch.isfinite(net), net, neg_inf)
    flat = net.reshape(C, -1)
    idx = torch.argmax(flat, dim=1)                          # first max
    best = flat.gather(1, idx[:, None])[:, 0]
    d = idx // (G * B)
    g = (idx // B) % G
    pos = idx % B
    ci = torch.arange(C, device=dev)
    sel = torch.where((d == 0)[:, None], left1[ci, g, pos], left2[ci, g, pos])
    lg, lh, lc = sel[:, 0], sel[:, 1], sel[:, 2]
    rg, rh, rc = total[:, 0] - lg, total[:, 1] - lh, total[:, 2] - lc
    gain = torch.where(torch.isfinite(best), best, neg_inf)
    return torch.stack([
        gain, tables.member_at[g, pos].to(dtype),
        tables.tloc_at[g, pos].to(dtype), (d == 1).to(dtype),
        lg, lh, lc, rg, rh, rc,
        leaf_output(lg, lh, p), leaf_output(rg, rh, p),
        leaf_output(lg + rg, lh + rh, p),
    ], dim=1)
