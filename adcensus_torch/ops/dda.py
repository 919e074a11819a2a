"""Kernel M2: depth-discontinuity adjustment of edge pixels.

Port of ``adcensus_tpu/stages/refine.py:depth_discontinuity_adjustment``
(multistep_refiner.cpp:307-352), without its Sobel mask, which the caller
computes (``stages/refine.py:edge_detect``). At each edge pixel of the
interior, the disparity of the left or right neighbour replaces the
pixel's own where the neighbour's cost at its own disparity is lower. The
row scan reads the *updated* left neighbour, so an adjustment can chain
rightward through consecutive edge pixels: a first-order recurrence along
x, which the JAX package runs as a ``lax.scan`` over columns (not a Pallas
kernel). ``dda`` launches ``csrc/dda.cu`` for a CUDA tensor and runs
``dda_plain``, the same scan as a torch loop over columns, for a CPU
tensor.

The cost volume is indexed by lround(d) without subtracting
min_disparity, as the reference does; a disparity whose index falls
outside [0, D) is skipped, as a pixel and as a candidate.
"""
from __future__ import annotations

from typing import Tuple

import torch

from adcensus_torch.config import INVALID_FLOAT, LARGE_FLOAT
from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for, lround, shift2d


def _rounded_idx(dmap: torch.Tensor, d_range: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lround(d) clamped to [0, D), whether d is finite and its index is
    in [0, D) unclamped)."""
    v = torch.isfinite(dmap)
    di = lround(torch.where(v, dmap, 0.0))
    ok = v & (di >= 0) & (di < d_range)
    return di.clamp(0, d_range - 1).long(), ok


def dda_plain(disp: torch.Tensor, cost: torch.Tensor,
              edge: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel M2: the JAX package's scan over columns,
    vectorised over rows. The carry is column x-1's final disparity, its
    cost at that disparity and whether its index is in range; every
    right-neighbour read is of original values (x + 1 is unprocessed
    when x is written)."""
    d_range, h, w = cost.shape
    if not disp.numel():
        return disp.clone()
    idx, own_ok = _rounded_idx(disp, d_range)
    own_cost = torch.gather(cost, 0, idx[None])[0]
    rd = shift2d(disp, 0, -1, INVALID_FLOAT)  # original right neighbour
    rc = shift2d(own_cost, 0, -1, LARGE_FLOAT)
    _, r_ok = _rounded_idx(rd, d_range)
    prev_d = disp.new_full((h,), INVALID_FLOAT)
    prev_c = disp.new_full((h,), LARGE_FLOAT)
    prev_ok = torch.zeros((h,), dtype=torch.bool, device=disp.device)
    cols = []
    for x in range(w):
        act = edge[:, x] & own_ok[:, x] & (1 <= x <= w - 2)
        d, c0 = disp[:, x], own_cost[:, x]
        take_l = act & prev_ok & (prev_c < c0)
        new_d = torch.where(take_l, prev_d, d)
        c0 = torch.where(take_l, prev_c, c0)
        take_r = act & r_ok[:, x] & (rc[:, x] < c0)
        new_d = torch.where(take_r, rd[:, x], new_d)
        out_d = torch.where(act, new_d, d)
        i, ok = _rounded_idx(out_d, d_range)
        prev_d, prev_ok = out_d, ok
        prev_c = torch.gather(cost[:, :, x], 0, i[None])[0]
        cols.append(out_d)
    return torch.stack(cols, dim=1)


def dda(disp: torch.Tensor, cost: torch.Tensor,
        edge: torch.Tensor) -> torch.Tensor:
    """The adjusted (H, W) float32 map, as a new tensor.

    disp: (H, W) float32, +inf = invalid; cost: (D, H, W) float32, indexed
    by lround(disparity); edge: (H, W) bool, the pixels to adjust (only
    those of the interior, 1 <= x <= W - 2, are)."""
    if disp.ndim != 2 or cost.ndim != 3:
        raise ValueError(f"dda takes an (H, W) map and a (D, H, W) cost, "
                         f"got {tuple(disp.shape)} and {tuple(cost.shape)}")
    h, w = disp.shape
    d_range = cost.shape[0]
    for name, t, dtype, shape in (
        ("disp", disp, torch.float32, (h, w)),
        ("cost", cost, torch.float32, (d_range, h, w)),
        ("edge", edge, torch.bool, (h, w)),
    ):
        _build.check(name, t, dtype, shape, disp.device)
    if not kernels_for(disp):
        return dda_plain(disp, cost, edge)
    out = torch.empty_like(disp)
    if h * w:
        _build.launch(
            "dda", disp.data_ptr(), cost.data_ptr(), edge.data_ptr(),
            out.data_ptr(), d_range, h, w,
            torch.cuda.current_stream(disp.device).cuda_stream,
        )
    return out
