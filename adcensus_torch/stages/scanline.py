"""Stage 3: 4-direction scanline (SGM-style) optimization.

Port of ``adcensus_tpu/stages/scanline.py``: four sequential directional
passes (scanline_optimizer.cpp:40-279), each a call of kernel B2
(``ops/scanline.py``) fed a compact (D, H, W) uint8 penalty-code volume
(0: both gradients < tso, 1: exactly one >= tso, 2: both >= tso;
scanline_optimizer.cpp:128-141).

The reference's d2 lookup is sticky: d2 keeps its previous-d value when
the right-image column xr = x - d - min_disp leaves (0, w-1)
(scanline_optimizer.cpp:116-126, d2 initialized to d1). Because xr is
strictly decreasing in d, stickiness has a closed form:

    d2(d, y, x) = d1(y, x)            if xr >= w-1 or x - min_disp <= 0
                  rd(y, max(xr, 1))   otherwise

The JAX package pads W to the TPU's 128-lane tile before the passes; the
CUDA kernel takes strides, so the port runs at the image's own width.
"""
from __future__ import annotations

from typing import Optional

import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops.basic import color_dist, shift2d
from adcensus_torch.ops.scanline import (
    FLAG_NORMAL,
    FLAG_PAD,
    FLAG_SEED,
    scanline_pass as scanline_kernel_pass,
)


def penalty_code(
    left: torch.Tensor,
    right: torch.Tensor,
    opts: ADCensusOptions,
    axis: str,
    forward: bool,
) -> torch.Tensor:
    """(D, H, W) uint8 penalty-code volume for one pass direction."""
    h, w, _ = left.shape
    dev = left.device
    direction = 1 if forward else -1
    dy, dx = (0, direction) if axis == "x" else (direction, 0)
    # d1[y, x] = dist(left[p], left[p - step]); the seed column is never read
    d1 = color_dist(left, shift2d(left, dy, dx, 0))
    # rd[y, x] = dist(right[y, x], right at p - step in the right image)
    rd = color_dist(right, shift2d(right, dy, dx, 0))
    rd_col1 = rd[:, 1:2] if w > 1 else rd

    x = torch.arange(w, device=dev)[None, :]
    d_abs = torch.arange(opts.disp_range, device=dev)[:, None] + opts.min_disparity
    xr = x - d_abs  # (D, W)
    use_d1 = (xr >= w - 1) | ((x - opts.min_disparity) <= 0)
    # rd at column xr (out-of-range columns are never selected below)
    shifted = rd[:, xr.clamp(0, w - 1)].permute(1, 0, 2)  # (D, H, W)
    sticky = torch.where((xr < 1)[:, None, :], rd_col1[None], shifted)
    d2 = torch.where(use_d1[:, None, :], d1[None], sticky)
    tso = opts.so_tso
    code = (d1[None] >= tso).to(torch.uint8) + (d2 >= tso).to(torch.uint8)
    # the gather above leaves a (H, D, W) memory layout; the kernel reads
    # the code volume through the cost volume's strides
    return code.contiguous()


def _scan_flags(
    s_len: int, valid: Optional[torch.Tensor] = None, device=None
) -> torch.Tensor:
    """Per-step flags in scan order: FLAG_PAD where the step is image
    padding, FLAG_SEED at the first real step, FLAG_NORMAL after."""
    if valid is None:
        valid = torch.ones((s_len,), dtype=torch.bool, device=device)
    first = torch.argmax(valid.to(torch.int32))  # index of first True
    ids = torch.arange(s_len, device=valid.device)
    return torch.where(
        ~valid,
        FLAG_PAD,
        torch.where(ids == first, FLAG_SEED, FLAG_NORMAL),
    ).to(torch.int32)


def scanline_pass(
    cost: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    opts: ADCensusOptions,
    axis: str,
    forward: bool,
) -> torch.Tensor:
    """One directional pass over a (D, H, W) volume."""
    code = penalty_code(left, right, opts, axis, forward)
    s_len = cost.shape[2] if axis == "x" else cost.shape[1]
    flags = _scan_flags(s_len, device=cost.device)
    return scanline_kernel_pass(
        cost, code, flags, opts.so_p1, opts.so_p2, axis, reverse=not forward
    )


def scanline_optimize(
    cost: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    opts: ADCensusOptions,
) -> torch.Tensor:
    """Four sequential passes, L->R, R->L, U->D, D->U, each consuming the
    previous pass's output (scanline_optimizer.cpp:53-60)."""
    for axis, fwd in (("x", True), ("x", False), ("y", True), ("y", False)):
        cost = scanline_pass(cost, left, right, opts, axis, fwd)
    return cost
