"""Stage 4: winner-take-all disparity + parabola subpixel, both views.

Port of ``adcensus_tpu/stages/wta.py`` (ADCensusStereo::ComputeDisparity /
ComputeDisparityRight, ADCensusStereo.cpp:188-310), with the reference's
asymmetric edge cases:

* left view: border winners (d == min or max-1) are Invalid_Float;
* right view: cost_r(d, y, x) = cost_l(d, y, x + d), Large_Float out of
  range, and border winners keep their integer disparity
  (ADCensusStereo.cpp:290-293);
* zero parabola curvature falls back to the integer disparity;
* ties break to the smallest disparity (first minimum).

``wta`` computes both views: kernel W1 (``ops/wta.py``, ``csrc/wta.cu``)
for CUDA tensors, the plain ``wta_left`` and ``wta_right`` for CPU
tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from adcensus_torch.config import INVALID_FLOAT, LARGE_FLOAT, ADCensusOptions
from adcensus_torch.ops import wta as wta_ops
from adcensus_torch.ops.basic import kernels_for, shift2d


def wta(cost: torch.Tensor, opts: ADCensusOptions,
        real_w: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D, H, W) volume -> the (H, W) float32 left and right disparity
    maps. Columns at or beyond ``real_w`` (default W; the sharded layer's
    padded columns) read as Large_Float for both views."""
    w = cost.shape[2]
    real_w = w if real_w is None else real_w
    if kernels_for(cost):
        return wta_ops.wta(cost, opts.min_disparity, real_w)
    if real_w < w:
        pad = torch.arange(w, device=cost.device) >= real_w
        cost = torch.where(pad, LARGE_FLOAT, cost)
    return wta_left(cost, opts), wta_right(cost, opts)


def _parabola(best, c_min, c1, c2, opts: ADCensusOptions) -> torch.Tensor:
    """d* = d + (c1 - c2) / (2 (c1 + c2 - 2 c_min))
    (ADCensusStereo.cpp:228-240)."""
    denom = c1 + c2 - 2.0 * c_min
    best_d = (best + opts.min_disparity).to(torch.float32)
    return torch.where(denom != 0.0, best_d + (c1 - c2) / (denom * 2.0), best_d)


def _neighbours(vol: torch.Tensor, best: torch.Tensor):
    """Costs at the winner and at its two neighbour planes (clamped at
    the ends, where callers discard them)."""
    d_range = vol.shape[0]

    def at(idx):
        return torch.gather(vol, 0, idx.clamp(0, d_range - 1)[None])[0]

    return at(best), at(best - 1), at(best + 1)


def wta_left(cost: torch.Tensor, opts: ADCensusOptions) -> torch.Tensor:
    """(D, H, W) volume -> (H, W) float32 left disparity."""
    d_range = cost.shape[0]
    best = cost.argmin(dim=0)  # first minimum
    c_min, c1, c2 = _neighbours(cost, best)
    disp = _parabola(best, c_min, c1, c2, opts)
    border = (best == 0) | (best == d_range - 1)
    return torch.where(border, INVALID_FLOAT, disp)


def _right_plane(cost: torch.Tensor, di: int, opts: ADCensusOptions):
    """cost_r(di) = cost_l(di) at x + d, with d = di + min_disparity;
    Large_Float out of range (ADCensusStereo.cpp:277-286)."""
    return shift2d(cost[di], 0, -(di + opts.min_disparity), LARGE_FLOAT)


def wta_right(cost: torch.Tensor, opts: ADCensusOptions) -> torch.Tensor:
    """(D, H, W) *left* volume -> (H, W) float32 right disparity.

    A running first-minimum scan over the right view's planes, one plane
    at a time, so the right volume is never materialized."""
    d_range, h, w = cost.shape
    best = torch.zeros((h, w), dtype=torch.long, device=cost.device)
    c_min = torch.full((h, w), LARGE_FLOAT, device=cost.device)
    for di in range(d_range):
        c = _right_plane(cost, di, opts)
        is_new = c < c_min
        best = torch.where(is_new, di, best)
        c_min = torch.where(is_new, c, c_min)
    # neighbour planes of the winner: cost_l(d, y, x + d), Large_Float
    # out of range
    y = torch.arange(h, device=cost.device)[:, None]
    x = torch.arange(w, device=cost.device)[None, :]
    flat = cost.reshape(-1)

    def at(idx):
        idx = idx.clamp(0, d_range - 1)
        col = x + idx + opts.min_disparity
        inside = (col >= 0) & (col < w)
        v = flat[(idx * h + y) * w + col.clamp(0, w - 1)]
        return torch.where(inside, v, LARGE_FLOAT)

    disp = _parabola(best, c_min, at(best - 1), at(best + 1), opts)
    border = (best == 0) | (best == d_range - 1)
    # border winners stay valid with their integer disparity
    return torch.where(
        border, (best + opts.min_disparity).to(torch.float32), disp
    )
