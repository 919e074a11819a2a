"""Stage 3: 4-direction scanline (SGM-style) optimization.

Port of ``adcensus_tpu/stages/scanline.py``: four sequential directional
passes (scanline_optimizer.cpp:40-279), each a call of kernel B2
(``ops/scanline.py``) given the pass's two (H, W) color-distance maps,
from which it derives each cell's penalty code (0: both gradients < tso,
1: exactly one >= tso, 2: both >= tso; scanline_optimizer.cpp:128-141)
with the reference's sticky d2 lookup (``ops/scanline.py:penalty_codes``).

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
    penalty_codes,
    scanline_pass as scanline_kernel_pass,
)


def distances(
    left: torch.Tensor, right: torch.Tensor, axis: str, forward: bool
) -> tuple:
    """(d1, rd), int32 (H, W): d1[y, x] = dist(left[p], left[p - step]),
    whose seed column is never read, and rd the same of the right image."""
    direction = 1 if forward else -1
    dy, dx = (0, direction) if axis == "x" else (direction, 0)
    d1 = color_dist(left, shift2d(left, dy, dx, 0))
    rd = color_dist(right, shift2d(right, dy, dx, 0))
    return d1, rd


def penalty_code(
    left: torch.Tensor,
    right: torch.Tensor,
    opts: ADCensusOptions,
    axis: str,
    forward: bool,
) -> torch.Tensor:
    """(D, H, W) uint8 penalty-code volume for one pass direction."""
    d1, rd = distances(left, right, axis, forward)
    return code_volume(d1, rd, opts, left.shape[1], 0)


def code_volume(
    d1: torch.Tensor,
    rd: torch.Tensor,
    opts: ADCensusOptions,
    real_w: int,
    col0: int,
) -> torch.Tensor:
    """(D, rows, out_w) uint8 penalty codes of columns [col0, col0 + out_w)
    of an image ``real_w`` wide (``ops/scanline.py:penalty_codes``). The
    sharded pipeline's ``_code_volume``."""
    return penalty_codes(d1, rd, opts.disp_range, opts.so_tso,
                         opts.min_disparity, col0, real_w)


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
    d1, rd = distances(left, right, axis, forward)
    s_len = cost.shape[2] if axis == "x" else cost.shape[1]
    flags = _scan_flags(s_len, device=cost.device)
    return scanline_kernel_pass(
        cost, d1, rd, flags, opts.so_tso, opts.so_p1, opts.so_p2, axis,
        reverse=not forward, min_disparity=opts.min_disparity,
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
