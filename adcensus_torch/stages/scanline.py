"""Stage 3: 4-direction scanline (SGM-style) optimization.

Port of ``adcensus_tpu/stages/scanline.py``: four sequential directional
passes (scanline_optimizer.cpp:40-279), each a call of kernel B2
(``ops/scanline.py``) given the pass's two (H, W) color-distance maps,
from which it derives each cell's penalty code (0: both gradients < tso,
1: exactly one >= tso, 2: both >= tso; scanline_optimizer.cpp:128-141)
with the reference's sticky d2 lookup (``ops/scanline.py:penalty_codes``).

The JAX package pads W to the TPU's 128-lane tile before the passes; the
CUDA kernel takes strides, so the port runs at the image's own width.
``scanline_pass`` takes the distances and the steps in the image, so the
sharded layer runs it on its padded row and column slabs.
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
    of an image ``real_w`` wide (``ops/scanline.py:penalty_codes``): what
    B2 derives in the kernel, built as a volume for the tests."""
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
    dists: tuple,
    opts: ADCensusOptions,
    axis: str,
    forward: bool,
    valid: Optional[torch.Tensor] = None,
    col0: int = 0,
    real_w: Optional[int] = None,
) -> torch.Tensor:
    """One directional pass over a (D, H, W) volume, given the pass's
    (d1, rd) color distances (``distances``). ``valid``: the (S,) bool
    steps along ``axis`` that lie in the image, in array order (None:
    every step); the others are PAD steps. The volume's column 0 is
    column ``col0`` of an image ``real_w`` wide (default: the volume's
    width), as the sharded layer's padded and column slabs have it."""
    s_len = cost.shape[2] if axis == "x" else cost.shape[1]
    if valid is not None and not forward:
        valid = valid.flip(0)
    flags = _scan_flags(s_len, valid, device=cost.device)
    return scanline_kernel_pass(
        cost, *dists, flags, opts.so_tso, opts.so_p1, opts.so_p2, axis,
        reverse=not forward, min_disparity=opts.min_disparity, col0=col0,
        real_w=real_w,
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
        cost = scanline_pass(cost, distances(left, right, axis, fwd), opts,
                             axis, fwd)
    return cost
