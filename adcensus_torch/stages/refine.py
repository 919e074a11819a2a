"""Stage 5: multi-step disparity refinement, dense formulation.

Port of ``adcensus_tpu/stages/refine.py`` (multistep_refiner.cpp:60-87):

* Outlier detection is exact, including the raster-order effect of the
  reference's in-place invalidation on the occlusion/mismatch split.
* Iterative region voting runs 5 iterations x (mismatch phase, occlusion
  phase) of simultaneous histogram voting (kernel B3,
  ``ops/region_vote.py``, one launch a phase, or band matrices with
  ``cross_backend="matmul"``).
* Proper interpolation marches the 16 rays (kernel B4, ``ops/interp.py``);
  mismatch fills are written before the occlusion search runs.
* Depth-discontinuity adjustment (``do_discontinuity_adjustment``) is
  exact, including the reference's in-place x-propagation (kernel M2,
  ``ops/dda.py``, on the Sobel mask of ``edge_detect``).
* The final 3x3 median is out of place, or with ``exact_median`` the
  reference's in-place raster-order median (kernel M1,
  ``ops/median.py``).

``multistep_refine`` is the one chain, gated by the options, for one card
and the sharded layer alike. On a ``slab`` (``stages/slab.py``) voting
runs on a ``max_arm`` halo without targets in it, interpolation fills
from the gathered map, the adjustment and the out-of-place median run on
a 1-row halo, the in-place median on the gathered map.
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
from adcensus_torch.ops.cross_matmul import vote_band_masks
from adcensus_torch.ops.dda import dda, edge_detect  # noqa: F401
from adcensus_torch.ops.interp import ray_interp
from adcensus_torch.ops.median import median_inplace
from adcensus_torch.ops import region_vote
from adcensus_torch.stages.slab import WHOLE, Slab
from adcensus_torch.utils.profiling import span


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
    real_w: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LR consistency check (multistep_refiner.cpp:90-151), exact.

    Returns (new_disp_left, occlusion_mask, mismatch_mask). The JAX
    package gathers by unrolled masked shifts over the offsets in range;
    here each lookup is one column gather, restricted to the same offset
    range, so the outputs are equal. ``real_w`` bounds the in-image
    column checks of a map padded on the right (the sharded pipeline);
    None is the map's width."""
    h, w = disp_left.shape
    rw = w if real_w is None else real_w
    x = torch.arange(w, device=disp_left.device)[None, :]
    orig_valid = torch.isfinite(disp_left)
    d = disp_left

    col_right = lround(x - torch.where(orig_valid, d, 0.0))
    cr_in = (col_right >= 0) & (col_right < rw)
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
    rl_in = (col_rl > 0) & (col_rl < rw)
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
    return region_vote.vote_indices(disp, opts.min_disparity,
                                    opts.disp_range)


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
    return region_vote.vote_fill(disp, target, best, max_ht, count,
                                 opts.min_disparity, opts.irv_ts,
                                 f32(opts.irv_th))


def region_vote_phase(
    disp: torch.Tensor,
    arms: torch.Tensor,
    target: torch.Tensor,
    opts: ADCensusOptions,
    cross_backend: str = "roll",
    masks=None,
    slab: Slab = WHOLE,
) -> torch.Tensor:
    """One voting phase at the pixels of ``target`` whose disparity is not
    finite. It runs whatever its target, so that nothing is read back to
    the host: with no such pixel it returns ``disp`` bit for bit. The
    roll backend runs the whole phase as one launch of kernel B3, which
    visits the target pixels only (``region_vote.region_vote_fill``).
    ``masks`` are the matmul backend's prebuilt band matrices. On a
    ``slab``, ``arms`` covers the ``max_arm`` halo the histograms run
    on."""
    max_arm = min(opts.cross_L1, MAX_ARM_LENGTH)
    halo = slab.halo(disp, max_arm)
    if cross_backend == "roll":
        return slab.own(region_vote.region_vote_fill(
            halo.contiguous(), arms, slab.pad(target, max_arm).contiguous(),
            opts.disp_range, max_arm, opts.min_disparity, opts.irv_ts,
            f32(opts.irv_th)), max_arm)
    target = target & ~torch.isfinite(disp)
    di, valid = vote_indices(halo, opts)
    stats = region_vote.region_vote_stats(
        di, valid, arms, opts.disp_range, max_arm, cross_backend, masks,
        target=slab.pad(target, max_arm),
    )
    best, max_ht, count = (slab.own(s, max_arm) for s in stats)
    return apply_vote_fill(disp, target, best, max_ht, count, opts)


def iterative_region_voting(
    disp: torch.Tensor,
    arms: torch.Tensor,
    occlusion: torch.Tensor,
    mismatch: torch.Tensor,
    opts: ADCensusOptions,
    num_iters: int = 5,
    cross_backend: str = "roll",
    slab: Slab = WHOLE,
) -> torch.Tensor:
    """5 iterations x (mismatches, then occlusions) of dense histogram
    voting (multistep_refiner.cpp:153-227). The matmul backend's band
    matrices are built once and shared by all 10 phases."""
    masks = (
        vote_band_masks(arms, min(opts.cross_L1, MAX_ARM_LENGTH))
        if cross_backend == "matmul"
        else None
    )
    for _ in range(num_iters):
        for phase_mask in (mismatch, occlusion):
            disp = region_vote_phase(disp, arms, phase_mask, opts,
                                     cross_backend, masks, slab)
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


@functools.lru_cache(maxsize=16)
def ray_offsets(max_search: int, device: torch.device) -> torch.Tensor:
    """ray_offset_table on ``device``, copied there on first use only, so
    that the interpolation stage makes no host-to-device copy (and no
    host sync) a call. Cached: callers must not modify it."""
    return torch.as_tensor(ray_offset_table(max_search), device=device)


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
    offsets = ray_offsets(max_search, disp.device)
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
    slab: Slab = WHOLE,
) -> torch.Tensor:
    """Both phases: mismatch fills are written before the occlusion
    search runs, as in the reference. Each fills the own rows' targets
    from ``slab.gather`` of the map; ``left`` is the whole image."""
    for is_mismatch, phase_mask in ((True, mismatch), (False, occlusion)):
        target = phase_mask & ~torch.isfinite(disp)
        fill = interpolation_fills(slab.gather(disp), left, opts,
                                   is_mismatch, target=slab.place(target))
        disp = torch.where(target, slab.scatter(fill), disp)
    return disp


def depth_discontinuity_adjustment(
    disp: torch.Tensor,
    cost: torch.Tensor,
    opts: ADCensusOptions,
    slab: Slab = WHOLE,
) -> torch.Tensor:
    """Edge-pixel disparity adjustment (multistep_refiner.cpp:307-352),
    exact: kernel M2 (``ops/dda.py``), the Sobel mask of ``disp``
    (``edge_detect``) included. The (D, H, W) ``cost`` is indexed by
    lround(d) without subtracting ``opts.min_disparity``, as the
    reference does. On a slab it runs on a 1-row halo of map and volume;
    the image's border keeps its values, as ``edge_detect`` leaves them."""
    adj = dda(slab.halo(disp, 1).contiguous(),
              slab.halo(cost, 1, 1).contiguous())
    return slab.interior(slab.own(adj, 1), disp)


def median_filter_3x3_inplace(disp: torch.Tensor) -> torch.Tensor:
    """The reference's exact in-place 3x3 median (adcensus_util.cpp:55-81
    called with in == out at multistep_refiner.cpp:86): kernel M1
    (``ops/median.py``). The input tensor is left as it is."""
    return median_inplace(disp.contiguous())


def median_filter_3x3(
    disp: torch.Tensor, in_image: torch.Tensor | None = None
) -> torch.Tensor:
    """Out-of-place 3x3 median with border-clipped windows
    (adcensus_util.cpp:55-81). Out-of-image slots are +inf, which sorts
    last; the median index is (in-image window population) // 2, so
    invalid (inf) disparities inside the image count toward the
    population, like the reference's clipped window.

    ``in_image``: an (H, W) bool mask of the real pixels of a padded map
    (the sharded pipeline's slabs); None is the whole map. Slots outside
    it are +inf, and the population counts the window's pixels in it.

    Deviation kept from the JAX package: the reference calls this with
    in == out, so its reads mix filtered and unfiltered neighbours.
    """
    h, w = disp.shape
    dev = disp.device
    if in_image is None:
        rows = 1 + (torch.arange(h, device=dev) > 0).long() + (
            torch.arange(h, device=dev) < h - 1
        ).long()
        cols = 1 + (torch.arange(w, device=dev) > 0).long() + (
            torch.arange(w, device=dev) < w - 1
        ).long()
        counts = rows[:, None] * cols[None, :]
        masked = disp
    else:
        masked = torch.where(in_image, disp, float("inf"))
        inside = in_image.long()
        counts = sum(
            shift2d(inside, -dy, -dx, 0)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        )
    stack = torch.stack([
        shift2d(masked, -dy, -dx, float("inf"))
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
    cross_backend: str = "roll",
    slab: Slab = WHOLE,
) -> Dict[str, torch.Tensor]:
    """Full refinement chain (multistep_refiner.cpp:60-87);
    ``cross_backend`` picks the voting histograms' backend. On a
    ``slab`` the maps and ``cost`` hold the own rows, ``left`` is the
    whole image and ``arms`` covers the rows of a ``max_arm`` halo; the
    final map reads +inf outside the image. The adjustment and the
    in-place median run in spans of their own, ``refine.dda`` and
    ``refine.median``, opened only where their options are on."""
    out: Dict[str, torch.Tensor] = {}
    disp = disp_left
    occl = torch.zeros_like(disp, dtype=torch.bool)
    mism = torch.zeros_like(disp, dtype=torch.bool)
    if opts.do_lr_check:
        disp, occl, mism = outlier_detection(disp, disp_right, opts,
                                             real_w=slab.real_w)
        out["after_lr_check"] = disp
    disp = slab.mask(disp, INVALID_FLOAT)
    occl = slab.mask(occl, False)
    mism = slab.mask(mism, False)
    if opts.do_filling:
        disp = iterative_region_voting(disp, arms, occl, mism, opts,
                                       cross_backend=cross_backend,
                                       slab=slab)
        out["after_voting"] = disp
        disp = proper_interpolation(disp, left, occl, mism, opts, slab)
        out["after_interpolation"] = disp
    if opts.do_discontinuity_adjustment:
        with span("refine.dda"):
            disp = depth_discontinuity_adjustment(disp, cost, opts, slab)
        out["after_discontinuity"] = disp
    if opts.exact_median:
        with span("refine.median"):
            final = slab.scatter(median_filter_3x3_inplace(
                slab.crop(slab.gather(disp))))
    else:
        final = slab.own(median_filter_3x3(
            slab.halo(disp, 1), slab.halo(slab.in_image, 1)), 1)
    out["final"] = slab.mask(final, INVALID_FLOAT)
    return out
