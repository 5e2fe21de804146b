"""Gradient discretization for quantized-gradient training.

Counterpart of the inline GradientDiscretizer block of the JAX compact
grower (``lightgbm_tpu/ops/grow.py`` ``_grow_compact_impl``, the
``if quant:`` block and ``hist_f``), itself the analog of LightGBM's
``gradient_discretizer.hpp``. Per tree, the weighted gradients and
hessians are scaled onto a few integer levels and rounded to int8:

- ``gs = max(max|g·w|, 1e-30) / max(1, bins // 2)``;
- ``hs = max(max h·w, 1e-30) / max(1, bins)``;
- ``gq = clip(floor(g·w / gs + u), -127, 127)``;
- ``hq = clip(floor(h·w / hs + u), 0, 127)``;

with ``u`` a uniform draw per row and channel (stochastic rounding) or
0.5 (round to nearest), the same float32 expressions as the JAX
package. Histograms of the int8 pairs are exact int32 sums
(:func:`ops.histogram.window_hist`); :func:`dequantize` turns one back
into float statistics for the split search.

Since ``|gq| <= bins // 2`` and ``0 <= hq <= bins``, a histogram entry
of a window of ``n`` rows is at most ``n * bins`` in magnitude (and at
most ``n * 127`` for any int8 payload), so int32 holds it exactly up to
``2**31 / bins`` rows (``2**31 / 127``, 16.9M rows, for any payload);
the JAX package has the same int32 limit.

Plain torch: in the JAX package this is XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["discretize", "dequantize"]


def discretize(grad: torch.Tensor, hess: torch.Tensor,
               row_weight: Optional[torch.Tensor], quant_bins: int,
               noise: Optional[torch.Tensor] = None,
               amax_reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[n]`` f32 gradients and hessians -> ``(int8 [n, 2], scale2 f32
    [2])``.

    ``row_weight`` (``[n]`` f32, or None for all ones) scales both
    channels first. ``noise`` is an ``[n, 2]`` f32 uniform draw in
    ``[0, 1)`` for stochastic rounding, or None for the deterministic
    ``u = 0.5``. ``amax_reduce`` (a world's max over ranks of a ``[2]``
    tensor) makes the scales the world's, so every rank's integer
    histograms sum exactly (the JAX grower's ``pmax``)."""
    g = grad.to(torch.float32)
    h = hess.to(torch.float32)
    if row_weight is not None:
        w = row_weight.to(torch.float32)
        g, h = g * w, h * w
    half = max(1, quant_bins // 2)
    amax = torch.stack([g.abs().max(), h.max()]) if g.numel() \
        else torch.zeros(2, dtype=torch.float32, device=g.device)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    gs = torch.clamp_min(amax[0], 1e-30) / half
    hs = torch.clamp_min(amax[1], 1e-30) / max(1, quant_bins)
    if noise is None:
        ug = uh = 0.5
    else:
        if noise.shape != (g.shape[0], 2):
            raise ValueError(f"noise must be [n, 2], got "
                             f"{tuple(noise.shape)}")
        noise = noise.to(device=g.device, dtype=torch.float32)
        ug, uh = noise[:, 0], noise[:, 1]
    gq = torch.clamp(torch.floor(g / gs + ug), -127, 127)
    hq = torch.clamp(torch.floor(h / hs + uh), 0, 127)
    q = torch.stack([gq, hq], dim=-1).to(torch.int8)
    return q, torch.stack([gs, hs])


def dequantize(hist: torch.Tensor, scale2: torch.Tensor) -> torch.Tensor:
    """An int32 ``[..., 2]`` histogram -> float32 (sum_grad, sum_hess)."""
    return hist.to(torch.float32) * scale2
