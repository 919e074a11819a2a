"""Stage 2b: cross-based cost aggregation.

Port of ``adcensus_tpu/stages/aggregate.py``: 4 iterations alternating
horizontal-first and vertical-first, each normalized by its own support
count (cross_aggregator.cpp:89-118, 327-394). Backends:

* ``cross_backend="roll"`` (default): kernel B1 (``ops/cross_sum.py``),
  bitwise in the reference's summation order;
* ``cross_backend="matmul"``: dense band matrices
  (``ops/cross_matmul.py``), built once for all iterations, or with
  ``agg_impl="banded"`` the blocked-band kernel B5 (``ops/band_mm.py``)
  where ``banded_fits`` takes the shape. Both split the volume into
  bfloat16 hi/lo parts and differ from the reference by ~2^-17 relative.

``agg_impl="skip"`` returns the cost unchanged (the JAX package's
``ADC_AGG_IMPL=skip`` ablation).

The sharded layer runs the same loop on its row slabs (``stages/slab.py``:
each iteration on the volume haloed by ``max_arm`` rows), with support
counts it built itself; ``banded`` and ``skip`` are one-card routes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from adcensus_torch.config import MAX_ARM_LENGTH, ADCensusOptions
from adcensus_torch.ops.band_mm import aggregate_banded, banded_fits
from adcensus_torch.ops.basic import check_cross_options
from adcensus_torch.ops.cross_matmul import band_masks, cross_pass_matmul
from adcensus_torch.ops.cross_sum import cross_pass
from adcensus_torch.stages.slab import WHOLE, Slab


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
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
    support: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    slab: Slab = WHOLE,
) -> torch.Tensor:
    """Aggregate a (D, H, W) cost volume over cross support regions:
    ``num_iters`` iterations (the reference calls Aggregate(4),
    ADCensusStereo.cpp:164) alternating horizontal-first and
    vertical-first, each normalized by the matching support count.
    Routes as the JAX ``aggregate`` does (see the module docstring).
    ``support``: float32 (sup_h, sup_v) of ``arms`` (None: counted here);
    on a ``slab`` both cover the volume's ``max_arm`` halo."""
    check_cross_options(cross_backend, agg_impl)
    max_arm = min(opts.cross_L1, MAX_ARM_LENGTH)
    if support is None:
        sup_h, sup_v = support_counts(arms, max_arm)
        support = (sup_h.to(torch.float32), sup_v.to(torch.float32))
    sup_h, sup_v = support
    if agg_impl == "skip":
        return cost
    if cross_backend == "matmul" and agg_impl == "banded":
        if banded_fits(*cost.shape, max_arm):
            return aggregate_banded(cost, arms, sup_h, sup_v, max_arm,
                                    num_iters)
    masks = band_masks(arms, max_arm) if cross_backend == "matmul" else None
    horizontal_first = True
    for _ in range(num_iters):
        args = (slab.halo(cost, max_arm, 1), arms,
                sup_h if horizontal_first else sup_v, horizontal_first,
                max_arm)
        if masks is None:
            out = cross_pass(*args, normalize=True)
        else:
            out = cross_pass_matmul(*args, normalize=True, masks=masks)
        cost = slab.own(out, max_arm, 1)
        horizontal_first = not horizontal_first
    return cost
