"""Kernel A1's loop (csrc/arms.cu: a thread a pixel and direction, the
reference's break loop), emulated in numpy pixel-parallel, against the
plain stage it replaces (stages/arms.py:build_arms_plain), bit for bit:
random, near-constant, noisy and blocky images (tests/_arms_cases.py),
arm caps of 0, 1, 34, 200 and 300 (255 steps), L2 below and above the
cap, thresholds that are not integers, one-pixel-wide and -high images,
and the sharded layer's slab mode (rows offset into a taller image, a
slab wider than the image, context rows missing above or below). The card test (tests/test_torch_arms_cuda.py)
holds the kernel itself to the same plain stage."""
import numpy as np
import pytest
import torch

from _arms_cases import CAPS, KINDS, SLABS, SMALL, THRESHOLDS, image
from adcensus_torch.config import MAX_ARM_LENGTH, ADCensusOptions
from adcensus_torch.stages import arms as arms_stage

# [left, right, top, bottom], as csrc/arms.cu numbers them
DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def arms_loop(img, steps, l2, t1, t2, row_offset, full_h, full_w):
    """csrc/arms.cu's per-thread loop, all pixels of a direction at once:
    candidate k extends a live arm iff it is inside the image (rows at
    row_offset), both color distances are below t1 and k <= l2 or the
    anchor's distance is below t2, compared in float32; a candidate
    outside the array reads as color 0."""
    h, w, _ = img.shape
    im = img.astype(np.int64)
    yy, xx = np.mgrid[:h, :w]
    f = np.float32
    out = np.zeros((h, w, 4), np.int32)
    for r, (dy, dx) in enumerate(DIRS):
        alive = np.ones((h, w), bool)
        n = np.zeros((h, w), np.int32)
        prev = im
        for k in range(1, steps + 1):
            cy, cx = yy + k * dy, xx + k * dx
            ny = row_offset + cy
            inside = (ny >= 0) & (ny < full_h) & (cx >= 0) & (cx < full_w)
            in_array = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            cand = np.zeros_like(im)
            cand[in_array] = im[cy[in_array], cx[in_array]]
            d1 = np.abs(cand - im).max(-1).astype(f)
            dp = np.abs(cand - prev).max(-1).astype(f)
            ok = (inside & (d1 < f(t1)) & (dp < f(t1))
                  & ((f(k) <= f(l2)) | (d1 < f(t2))))
            alive &= ok
            n += alive
            prev = cand
        out[..., r] = n
    return out


def _check(img, opts, row_offset=0, full_h=None, full_w=None):
    h, w, _ = img.shape
    want = arms_stage.build_arms_plain(torch.as_tensor(img), opts,
                                       row_offset, full_h, full_w).numpy()
    got = arms_loop(img, min(opts.cross_L1, MAX_ARM_LENGTH), opts.cross_L2,
                    opts.cross_t1, opts.cross_t2, row_offset,
                    h if full_h is None else full_h,
                    w if full_w is None else full_w)
    np.testing.assert_array_equal(got, want)
    return want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("l1,l2", CAPS)
def test_loop_equals_plain(kind, l1, l2):
    h, w = (40, 300) if l1 > 34 else (33, 47)
    img = image(kind, h, w, seed=l1 + l2)
    arms = _check(img, ADCensusOptions(cross_L1=l1, cross_L2=l2))
    if kind == "smooth" and l1 > 0:
        assert arms.max() == min(l1, MAX_ARM_LENGTH, w - 1)


@pytest.mark.parametrize("t1,t2", THRESHOLDS)
def test_loop_thresholds(t1, t2):
    img = image("blocks", 30, 40, seed=3)
    _check(img, ADCensusOptions(cross_t1=t1, cross_t2=t2))


@pytest.mark.parametrize("h,w", SMALL)
def test_loop_small_shapes(h, w):
    _check(image("smooth", h, w, seed=h * w), ADCensusOptions())


@pytest.mark.parametrize("row_offset,full_h,full_w,extra_w", SLABS)
def test_loop_slab_mode(row_offset, full_h, full_w, extra_w):
    img = image("smooth", 60, full_w + extra_w, seed=row_offset + 100)
    _check(img, ADCensusOptions(), row_offset, full_h, full_w)
