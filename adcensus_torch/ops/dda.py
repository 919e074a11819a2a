"""Kernel M2: depth-discontinuity adjustment of edge pixels.

Port of ``adcensus_tpu/stages/refine.py:depth_discontinuity_adjustment``
(multistep_refiner.cpp:307-352), Sobel mask included: the pixels to
adjust are the interior edge pixels of ``edge_detect``. At each of them,
the disparity of the left or right neighbour replaces the pixel's own
where the neighbour's cost at its own disparity is lower. The row scan
reads the *updated* left neighbour, so an adjustment can chain rightward
through consecutive edge pixels: a first-order recurrence along x, which
the JAX package runs as a ``lax.scan`` over columns (not a Pallas
kernel). ``dda`` launches ``csrc/dda.cu`` (a warp a row, 32 columns a
chunk) for a CUDA tensor and runs ``dda_plain``, the Sobel and the same
scan as a torch loop over columns, for a CPU tensor.

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

# csrc/dda.cu holds the same constants (with a k)
WARP = 32       # columns a chunk: lane j of a row's warp on column x0 + j
WARPS = 4       # warps (rows) a block
THRESHOLD = 5.0  # the Sobel magnitude above which a pixel is an edge


def edge_detect(disp: torch.Tensor, threshold: float = THRESHOLD
                ) -> torch.Tensor:
    """Sobel edge mask (multistep_refiner.cpp:354-371), in the JAX
    package's order of float32 operations; border rows and columns are
    False."""
    h, w = disp.shape

    def s(dy, dx):
        return shift2d(disp, -dy, -dx, 0.0)

    gx = (
        -s(-1, -1) + s(-1, 1) - 2 * s(0, -1) + 2 * s(0, 1) - s(1, -1) + s(1, 1)
    )
    gy = (
        -s(-1, -1) - 2 * s(-1, 0) - s(-1, 1)
        + s(1, -1) + 2 * s(1, 0) + s(1, 1)
    )
    mask = (gx.abs() + gy.abs()) > threshold
    interior = torch.zeros((h, w), dtype=torch.bool, device=disp.device)
    interior[1 : h - 1, 1 : w - 1] = True
    return mask & interior


def _rounded_idx(dmap: torch.Tensor, d_range: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lround(d) clamped to [0, D), whether d is finite and its index is
    in [0, D) unclamped)."""
    v = torch.isfinite(dmap)
    di = lround(torch.where(v, dmap, 0.0))
    ok = v & (di >= 0) & (di < d_range)
    return di.clamp(0, d_range - 1).long(), ok


def dda_plain(disp: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel M2: ``edge_detect``, then the JAX
    package's scan over columns, vectorised over rows. The carry is
    column x-1's final disparity, its cost at that disparity and whether
    its index is in range; every right-neighbour read is of original
    values (x + 1 is unprocessed when x is written)."""
    d_range, h, w = cost.shape
    if not disp.numel():
        return disp.clone()
    edge = edge_detect(disp)
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


def dda(disp: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """The adjusted (H, W) float32 map, as a new tensor.

    disp: (H, W) float32, +inf = invalid; cost: (D, H, W) float32, indexed
    by lround(disparity). The pixels adjusted are the interior pixels of
    ``edge_detect(disp)`` whose own index is in [0, D)."""
    if disp.ndim != 2 or cost.ndim != 3:
        raise ValueError(f"dda takes an (H, W) map and a (D, H, W) cost, "
                         f"got {tuple(disp.shape)} and {tuple(cost.shape)}")
    h, w = disp.shape
    d_range = cost.shape[0]
    _build.check("disp", disp, torch.float32, (h, w), disp.device)
    _build.check("cost", cost, torch.float32, (d_range, h, w), disp.device)
    if not kernels_for(disp):
        return dda_plain(disp, cost)
    out = torch.empty_like(disp)
    if h * w:
        _build.launch(
            "dda", disp.data_ptr(), cost.data_ptr(), out.data_ptr(),
            d_range, h, w,
            torch.cuda.current_stream(disp.device).cuda_stream,
        )
    return out
