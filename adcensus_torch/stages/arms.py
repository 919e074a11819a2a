"""Stage 2a: cross-arm construction.

Port of ``adcensus_tpu/stages/arms.py``. The reference grows each arm with
a per-pixel break loop (cross_aggregator.cpp:135-269) of at most
min(L1, 255) steps; as in the JAX package it is a cumulative AND over the
candidate offsets, here over all offsets of a direction at once.
"""
from __future__ import annotations

import torch

from adcensus_torch.config import MAX_ARM_LENGTH, ADCensusOptions
from adcensus_torch.ops.basic import color_dist


def _arm_length(
    img: torch.Tensor,
    dy: int,
    dx: int,
    opts: ADCensusOptions,
    row_offset: int = 0,
    full_h: int | None = None,
    full_w: int | None = None,
) -> torch.Tensor:
    """Arm length toward (dy, dx) for every pixel, (H, W) int32.

    Candidate n (0-based) sits at offset (n+1)*(dy, dx). It extends the
    arm iff (cross_aggregator.cpp:151-198):
      * it is inside the image;
      * color_dist(candidate, anchor) < t1;
      * color_dist(candidate, previous) < t1 (the previous of n == 0 is the
        anchor, so this repeats the first condition there);
      * n + 1 <= L2 or color_dist(candidate, anchor) < t2.
    The arm is the count of leading passing candidates.

    ``row_offset``/``full_h``/``full_w`` are the sharded pipeline's slab
    mode: ``img`` is then a slab whose row 0 is row ``row_offset`` of a
    ``full_h`` x ``full_w`` image, and "inside the image" is judged in
    the image's coordinates. Callers supply min(L1, 255) rows of true
    context around any row they keep.
    """
    h, w, _ = img.shape
    full_h = h if full_h is None else full_h
    full_w = w if full_w is None else full_w
    steps = min(opts.cross_L1, MAX_ARM_LENGTH)
    dev = img.device
    if steps == 0:
        return torch.zeros((h, w), dtype=torch.int32, device=dev)
    s = steps
    padded = torch.zeros((h + 2 * s, w + 2 * s, 3), dtype=torch.int32,
                         device=dev)
    padded[s : s + h, s : s + w] = img.to(torch.int32)
    # stack[k] = image at offset k*(dy, dx), k = 0 .. steps
    stack = torch.stack([
        padded[s + dy * k : s + dy * k + h, s + dx * k : s + dx * k + w]
        for k in range(steps + 1)
    ])
    off = torch.arange(1, steps + 1, device=dev)[:, None, None]
    ny = row_offset + torch.arange(h, device=dev)[None, :, None] + dy * off
    nx = torch.arange(w, device=dev)[None, None, :] + dx * off
    in_bounds = (ny >= 0) & (ny < full_h) & (nx >= 0) & (nx < full_w)
    cand = stack[1:]
    dist1 = color_dist(cand, stack[:1])
    ok = (
        in_bounds
        & (dist1 < opts.cross_t1)
        & (color_dist(cand, stack[:-1]) < opts.cross_t1)
        & ((off <= opts.cross_L2) | (dist1 < opts.cross_t2))
    )
    alive = torch.cumprod(ok.to(torch.int32), dim=0)
    return alive.sum(dim=0, dtype=torch.int32)


def build_arms(
    left: torch.Tensor,
    opts: ADCensusOptions,
    row_offset: int = 0,
    full_h: int | None = None,
    full_w: int | None = None,
) -> torch.Tensor:
    """Per-pixel cross arms on the left image, (H, W, 4) int32 ordered
    [left, right, top, bottom] (cross_aggregator.cpp:76-86). The slab
    mode's arguments are ``_arm_length``'s."""
    slab = (row_offset, full_h, full_w)
    return torch.stack(
        [
            _arm_length(left, 0, -1, opts, *slab),
            _arm_length(left, 0, 1, opts, *slab),
            _arm_length(left, -1, 0, opts, *slab),
            _arm_length(left, 1, 0, opts, *slab),
        ],
        dim=-1,
    )
