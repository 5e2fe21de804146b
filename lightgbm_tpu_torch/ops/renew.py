"""Per-leaf output refinement of the L1-family objectives.

Counterpart of ``lightgbm_tpu/ops/renew.py`` ``renew_leaf_values`` (the
RenewTreeOutput analog): every leaf's output becomes the weighted
``alpha``-percentile of the residuals of its rows. As in the JAX
package, it is one stable sort of (leaf, residual) over all rows — the
rows of weight 0 (out of bag) in a dummy segment after the last leaf —
then, per leaf, the first row whose cumulative weight within the leaf
reaches ``alpha`` times the leaf's total weight. The percentile is that
row's residual (the first crossing, not LightGBM's interpolating
``PercentileFun``); a leaf without weight keeps its ``fallback`` value.

The arithmetic is the JAX function's in float32: one cumulative sum over
all sorted weights, taken in XLA's order (:func:`ops.split._prefix_sums`,
so that fractional weights pick the JAX package's row on the CPU), less
each segment's offset (the cumulative sum of the segments' totals), and
the test ``cum_in_seg >= alpha * total - 1e-12``. On the card it is plain
torch: two stable sorts, a scan and segment reductions, none of them
with float atomics, so a rerun renews to the same values.
"""

from __future__ import annotations

import torch

from .split import _prefix_sums

__all__ = ["renew_leaf_values"]


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    return _prefix_sums(x[:, None], 0)[:, 0]


def renew_leaf_values(row_leaf: torch.Tensor, residual: torch.Tensor,
                      row_weight: torch.Tensor, num_leaves: int,
                      alpha: float, fallback: torch.Tensor) -> torch.Tensor:
    """Weighted ``alpha``-percentile of ``residual`` per leaf.

    Args:
      row_leaf: ``[n]`` int leaf of every row.
      residual: ``[n]`` f32 (label - score).
      row_weight: ``[n]`` f32; rows of weight 0 are ignored.
      num_leaves: L.
      alpha: the percentile, in (0, 1).
      fallback: ``[L]`` f32 values of leaves without weight.
    Returns ``[L]`` f32 leaf outputs.
    """
    n = row_leaf.shape[0]
    dev = residual.device
    L = num_leaves
    active = row_weight > 0
    seg = torch.where(active, row_leaf.to(torch.int64),
                      torch.full_like(row_leaf, L, dtype=torch.int64))
    # lexsort((residual, seg)): by residual, then stably by segment
    o1 = torch.sort(residual, stable=True).indices
    o2 = torch.sort(seg[o1], stable=True).indices
    order = o1[o2]
    seg_s = seg[order]
    res_s = residual[order]
    w_s = torch.where(active, row_weight,
                      torch.zeros_like(row_weight))[order]
    # per-segment totals of the sorted weights: a segmented sum, in row
    # order on the CPU (JAX's scatter-add order) and without atomics on
    # the card, so that reruns select the same rows
    totals = torch.segment_reduce(
        w_s, "sum", lengths=torch.bincount(seg_s, minlength=L + 1))
    cumw = _cumsum_f32(w_s)
    seg_offsets = torch.cat([torch.zeros(1, dtype=w_s.dtype, device=dev),
                             _cumsum_f32(totals)])[:-1]
    cum_in_seg = cumw - seg_offsets[seg_s]
    target = alpha * totals[seg_s]
    hit = cum_in_seg >= target - 1e-12
    idx = torch.arange(n, device=dev)
    cand = torch.where(hit, idx, torch.full_like(idx, n))
    first = torch.full((L + 1,), n, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, seg_s, cand, reduce="amin")[:L]
    valid = (first < n) & (totals[:L] > 0)
    vals = res_s[torch.clamp_max(first, n - 1)]
    return torch.where(valid, vals, fallback.to(vals.dtype))
