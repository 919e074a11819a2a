"""Stage 2b: cross-based cost aggregation.

Port of ``adcensus_tpu/stages/aggregate.py`` on its bit-exact kernel
backend: 4 iterations alternating horizontal-first and vertical-first,
each a call of kernel B1 (``ops/cross_sum.py``) normalized by its own
support count (cross_aggregator.cpp:89-118, 327-394). The JAX package's
MXU band-matrix backend (``ops/cross_matmul.py``) exists to feed the TPU's
matrix unit; a direct arm sum is the natural kernel on a GPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from adcensus_torch.config import MAX_ARM_LENGTH, ADCensusOptions
from adcensus_torch.ops.cross_sum import cross_pass


def _arm_sum(
    vals: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, axis: int,
    max_arm: int,
) -> torch.Tensor:
    """sum_{t=-lo..hi} vals[i + t] along ``axis`` of an (H, W) int32
    plane, with offsets capped at ``max_arm`` and zeros beyond the border,
    as a difference of prefix sums (integer sums are exact in any order)."""
    n = vals.shape[axis]
    csum = torch.cumsum(vals, dim=axis, dtype=torch.int64)
    zero = torch.zeros_like(csum.narrow(axis, 0, 1))
    prefix = torch.cat([zero, csum], dim=axis)  # prefix[k] = sum vals[:k]
    idx = torch.arange(n, device=vals.device)
    idx = idx[:, None] if axis == 0 else idx[None, :]
    end = (idx + hi.clamp(max=max_arm) + 1).clamp(0, n)
    start = (idx - lo.clamp(max=max_arm)).clamp(0, n)
    total = torch.gather(prefix, axis, end) - torch.gather(prefix, axis, start)
    return total.to(torch.int32)


def support_counts(
    arms: torch.Tensor, max_arm: int = MAX_ARM_LENGTH
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Support-region pixel counts (horizontal-first, vertical-first),
    each (H, W) int32 (cross_aggregator.cpp:271-325)."""
    al, ar, at, ab = (arms[..., k].long() for k in range(4))
    max_arm = min(max_arm, MAX_ARM_LENGTH)
    h_extent = (al + ar + 1).to(torch.int32)
    v_extent = (at + ab + 1).to(torch.int32)
    sup_h = _arm_sum(h_extent, at, ab, 0, max_arm)  # horizontal-first
    sup_v = _arm_sum(v_extent, al, ar, 1, max_arm)  # vertical-first
    return sup_h, sup_v


def aggregate(
    cost: torch.Tensor,
    arms: torch.Tensor,
    opts: ADCensusOptions,
    num_iters: int = 4,
) -> torch.Tensor:
    """Aggregate a (D, H, W) cost volume over cross support regions:
    ``num_iters`` iterations (the reference calls Aggregate(4),
    ADCensusStereo.cpp:164) alternating horizontal-first and
    vertical-first, each normalized by the matching support count."""
    max_arm = min(opts.cross_L1, MAX_ARM_LENGTH)
    sup_h, sup_v = support_counts(arms, max_arm)
    sup_h = sup_h.to(torch.float32)
    sup_v = sup_v.to(torch.float32)
    horizontal_first = True
    for _ in range(num_iters):
        cost = cross_pass(
            cost, arms, sup_h if horizontal_first else sup_v,
            horizontal_first, max_arm, normalize=True,
        )
        horizontal_first = not horizontal_first
    return cost
