"""Stage 5: multi-step disparity refinement, dense formulation.

Port of ``adcensus_tpu/stages/refine.py`` (multistep_refiner.cpp:60-87):

* Outlier detection is exact, including the raster-order effect of the
  reference's in-place invalidation on the occlusion/mismatch split.
* Iterative region voting runs 5 iterations x (mismatch phase, occlusion
  phase) of simultaneous histogram voting (kernel B3,
  ``ops/region_vote.py``).
* Proper interpolation marches the 16 rays (kernel B4, ``ops/interp.py``);
  mismatch fills are written before the occlusion search runs.
* The final 3x3 median is out of place.

Not ported yet: ``depth_discontinuity_adjustment`` and the in-place median
``median_filter_3x3_inplace``; their options raise NotImplementedError.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from adcensus_torch.config import (
    INVALID_FLOAT,
    MAX_ARM_LENGTH,
    ADCensusOptions,
)
from adcensus_torch.ops.basic import f32, lround, shift2d
from adcensus_torch.ops.interp import ray_interp
from adcensus_torch.ops.region_vote import region_vote_stats


def _gather_cols(fields, col, ok, defaults):
    """f[y, col[y, x]] where ``ok``, the default elsewhere, per field."""
    w = col.shape[1]
    idx = col.long().clamp(0, w - 1)
    return [
        torch.where(ok, torch.gather(f, 1, idx), dflt)
        for f, dflt in zip(fields, defaults)
    ]


def outlier_detection(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    opts: ADCensusOptions,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LR consistency check (multistep_refiner.cpp:90-151), exact.

    Returns (new_disp_left, occlusion_mask, mismatch_mask). The JAX
    package gathers by unrolled masked shifts over the offsets in range;
    here each lookup is one column gather, restricted to the same offset
    range, so the outputs are equal."""
    h, w = disp_left.shape
    x = torch.arange(w, device=disp_left.device)[None, :]
    orig_valid = torch.isfinite(disp_left)
    d = disp_left

    col_right = lround(x - torch.where(orig_valid, d, 0.0))
    cr_in = (col_right >= 0) & (col_right < w)
    offs = x - col_right
    (d_r,) = _gather_cols(
        (disp_right,),
        col_right,
        cr_in
        & (offs >= opts.min_disparity - 1)
        & (offs <= opts.max_disparity + 1),
        (INVALID_FLOAT,),
    )
    lr_fail = orig_valid & cr_in & ((d - d_r).abs() > f32(opts.lrcheck_thres))

    outlier = (~orig_valid) | (~cr_in) | lr_fail
    new_disp = torch.where(outlier, INVALID_FLOAT, d)

    # classification of lr_fail pixels via reprojection. col_rl is only
    # read where lr_fail & rl_in (finite d and d_r); a non-finite d_r
    # gives col_rl = 0, which is not rl_in.
    col_rl = lround(
        torch.where(torch.isfinite(d_r), col_right + d_r, 0.0)
    )
    rl_in = (col_rl > 0) & (col_rl < w)
    span = opts.max_disparity - opts.min_disparity + 2
    offs = x - col_rl
    d_l_orig, rl_outlier, rl_valid = _gather_cols(
        (d, outlier, orig_valid),
        col_rl,
        (col_rl >= 0) & (col_rl < w) & (offs >= -span) & (offs <= span),
        (INVALID_FLOAT, False, False),
    )
    # the reference reads disp_left_ mid-scan: (y, col_rl) is already
    # invalidated iff col_rl < x and it is an outlier itself
    seen_invalid = (rl_outlier & (col_rl < x)) | ~rl_valid
    d_l_eff = torch.where(seen_invalid, INVALID_FLOAT, d_l_orig)

    occlusion = lr_fail & rl_in & (d_l_eff > d)
    mismatch = outlier & ~occlusion
    return new_disp, occlusion, mismatch


def vote_indices(
    disp: torch.Tensor, opts: ADCensusOptions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rounded 0-based disparity indices, validity mask) for voting
    (multistep_refiner.cpp:187-197 uses rounded disparities)."""
    valid = torch.isfinite(disp)
    di = (
        lround(torch.where(valid, disp, 0.0)) - opts.min_disparity
    ).clamp(0, opts.disp_range - 1).to(torch.int32)
    return di, valid


def apply_vote_fill(
    disp: torch.Tensor,
    target: torch.Tensor,
    best: torch.Tensor,
    max_ht: torch.Tensor,
    count: torch.Tensor,
    opts: ADCensusOptions,
) -> torch.Tensor:
    """Fill ``target`` pixels whose region histogram passes the ts/th
    thresholds (multistep_refiner.cpp:199-214)."""
    ratio_ok = (
        max_ht.to(torch.float32) / count.to(torch.float32)
    ) > f32(opts.irv_th)
    fill = target & (max_ht > 0) & (count > opts.irv_ts) & ratio_ok
    return torch.where(
        fill, (best + opts.min_disparity).to(torch.float32), disp
    )


def region_vote_phase(
    disp: torch.Tensor,
    arms: torch.Tensor,
    target: torch.Tensor,
    opts: ADCensusOptions,
) -> torch.Tensor:
    """One voting phase; skipped when it has no target."""
    if not bool(target.any()):
        return disp
    di, valid = vote_indices(disp, opts)
    best, max_ht, count = region_vote_stats(
        di, valid, arms, opts.disp_range, min(opts.cross_L1, MAX_ARM_LENGTH)
    )
    return apply_vote_fill(disp, target, best, max_ht, count, opts)


def iterative_region_voting(
    disp: torch.Tensor,
    arms: torch.Tensor,
    occlusion: torch.Tensor,
    mismatch: torch.Tensor,
    opts: ADCensusOptions,
    num_iters: int = 5,
) -> torch.Tensor:
    """5 iterations x (mismatches, then occlusions) of dense histogram
    voting (multistep_refiner.cpp:153-227)."""
    for _ in range(num_iters):
        for phase_mask in (mismatch, occlusion):
            target = phase_mask & ~torch.isfinite(disp)
            disp = region_vote_phase(disp, arms, target, opts)
    return disp


@functools.lru_cache(maxsize=8)
def ray_offset_table(max_search: int) -> np.ndarray:
    """Static (16, max_search-1, 2) table of (dy, dx) integer offsets for
    the 16 interpolation rays over [0, pi), double-precision trig +
    lround, matching multistep_refiner.cpp:253-269. Cached: callers must
    not modify it."""
    steps = max(max_search - 1, 1)
    table = np.zeros((16, steps, 2), dtype=np.int32)
    ang = 0.0
    for s in range(16):
        sina, cosa = math.sin(ang), math.cos(ang)
        for m in range(1, max_search):
            yy = math.floor(m * sina + 0.5) if m * sina >= 0 else math.ceil(m * sina - 0.5)
            xx = math.floor(m * cosa + 0.5) if m * cosa >= 0 else math.ceil(m * cosa - 0.5)
            table[s, m - 1] = (int(yy), int(xx))
        ang += 3.1415926 / 16
    return table


def interpolation_fills(
    disp: torch.Tensor,
    left: torch.Tensor,
    opts: ADCensusOptions,
    is_mismatch: bool,
    target: torch.Tensor | None = None,
) -> torch.Tensor:
    """16-ray interpolation fill values (multistep_refiner.cpp:229-305).

    Mismatches: disparity of the ray hit with the closest color (sum of
    absolute channel differences, first minimum in ray order). Occlusions:
    minimum collected disparity. No hit -> 0.0 (the reference's
    zero-initialized fill_disps). ``target`` marks the pixels whose fills
    will be read (None = all); other outputs are 0.0.
    """
    h, w = disp.shape
    max_search = max(abs(opts.max_disparity), abs(opts.min_disparity))
    offsets = torch.as_tensor(ray_offset_table(max_search), device=disp.device)
    if target is None:
        target = torch.ones((h, w), dtype=torch.bool, device=disp.device)
    _, fill = ray_interp(
        disp.contiguous(), left.contiguous(), offsets, target.contiguous(),
        is_mismatch,
    )
    return fill


def proper_interpolation(
    disp: torch.Tensor,
    left: torch.Tensor,
    occlusion: torch.Tensor,
    mismatch: torch.Tensor,
    opts: ADCensusOptions,
) -> torch.Tensor:
    """Both phases over the full map: mismatch fills are written before
    the occlusion search runs, as in the reference."""
    mism_target = mismatch & ~torch.isfinite(disp)
    fill_m = interpolation_fills(disp, left, opts, True, target=mism_target)
    disp = torch.where(mism_target, fill_m, disp)
    occl_target = occlusion & ~torch.isfinite(disp)
    fill_o = interpolation_fills(disp, left, opts, False, target=occl_target)
    return torch.where(occl_target, fill_o, disp)


def median_filter_3x3(disp: torch.Tensor) -> torch.Tensor:
    """Out-of-place 3x3 median with border-clipped windows
    (adcensus_util.cpp:55-81). Out-of-image slots are +inf, which sorts
    last; the median index is (in-image window population) // 2, so
    invalid (inf) disparities inside the image count toward the
    population, like the reference's clipped window.

    Deviation kept from the JAX package: the reference calls this with
    in == out, so its reads mix filtered and unfiltered neighbours.
    """
    h, w = disp.shape
    dev = disp.device
    rows = 1 + (torch.arange(h, device=dev) > 0).long() + (
        torch.arange(h, device=dev) < h - 1
    ).long()
    cols = 1 + (torch.arange(w, device=dev) > 0).long() + (
        torch.arange(w, device=dev) < w - 1
    ).long()
    counts = rows[:, None] * cols[None, :]
    stack = torch.stack([
        shift2d(disp, -dy, -dx, float("inf"))
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    ])
    s = torch.sort(stack, dim=0).values
    idx = counts.clamp(min=1) // 2
    return torch.gather(s, 0, idx[None])[0]


def multistep_refine(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    left: torch.Tensor,
    cost: torch.Tensor,
    arms: torch.Tensor,
    opts: ADCensusOptions,
) -> Dict[str, torch.Tensor]:
    """Full refinement chain (multistep_refiner.cpp:60-87)."""
    if opts.do_discontinuity_adjustment:
        raise NotImplementedError(
            "depth discontinuity adjustment is not ported yet"
        )
    if opts.exact_median:
        raise NotImplementedError("the in-place median is not ported yet")
    out: Dict[str, torch.Tensor] = {}
    disp = disp_left
    occl = torch.zeros_like(disp, dtype=torch.bool)
    mism = torch.zeros_like(disp, dtype=torch.bool)
    if opts.do_lr_check:
        disp, occl, mism = outlier_detection(disp, disp_right, opts)
        out["after_lr_check"] = disp
    if opts.do_filling:
        disp = iterative_region_voting(disp, arms, occl, mism, opts)
        out["after_voting"] = disp
        disp = proper_interpolation(disp, left, occl, mism, opts)
        out["after_interpolation"] = disp
    out["final"] = median_filter_3x3(disp)
    return out
