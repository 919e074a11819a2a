"""The plain reference with the reference C++'s whole refinement: the
benchmark's reference for ``correct`` where depth-discontinuity
adjustment (``do_discontinuity_adjustment``) and the in-place median
(``exact_median``) are on.

The chain is that of Mei et al., "On building an accurate stereo
matching system on graphics hardware" (ICCV-W 2011), multi-step
refinement, in the AD-Census C++ reference's order
(multistep_refiner.cpp:60-87): LR check, region voting, interpolation,
then

* ``depth_discontinuity_adjustment`` (multistep_refiner.cpp:307-352):
  the Sobel edge mask of the map, threshold 5.0 (``EdgeDetect``,
  :354-371); at each interior edge pixel the disparity of the left, then
  the right neighbour replaces the pixel's own where that neighbour's
  cost at its own rounded disparity is lower than the pixel's best so
  far. The row is updated in place, so the left neighbour's value is
  already adjusted. The post-scanline (D, H, W) volume is indexed by
  lround(d) without subtracting ``min_disparity``, as the C++ does; a
  disparity whose index falls outside [0, D) is skipped;
* ``median_3x3_inplace`` (adcensus_util.cpp:55-81, called with in ==
  out at multistep_refiner.cpp:86): windows clipped at the border, the
  sorted window's element ``size // 2``, visited in raster order on one
  buffer, so a pixel reads the filtered values above it and on its left.

Everything up to the WTA, the LR check, voting and interpolation are
``adcensus.py``'s own functions, which this file leaves as they are;
unlike ``adcensus.match``, ``match`` keeps the volume after the WTA for
the adjustment. Both steps above are written as the C++ writes them,
literal loops over pixels, on host copies of the map and the volume;
only the Sobel mask, whose pixels depend on none of the others, is
computed for the whole map at once in float32, in the C++'s order of
operations. At Cone size (450x375, D 64) the two loops take about 0.26 s
a pair on the host of an H100 machine (the adjustment 0.07, the median
0.19), and the whole ``match`` about 0.8 s a pair with its volume stages
on the H100.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from stereo_bench.reference import adcensus as plain

EDGE_THRESHOLD = 5.0


def lround(v: float) -> int:
    """C lround of a finite float: round half away from zero, exactly
    (a float32 value plus 0.5 is exact in double precision)."""
    return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))


def edge_mask(disp: np.ndarray) -> np.ndarray:
    """(H, W) bool Sobel mask of a float32 map: |gx| + |gy| >
    EDGE_THRESHOLD, each sum taken left to right in float32; the border
    rows and columns are False. A window holding +inf gives inf or NaN,
    which is an edge only where the sum is +inf."""
    d = np.asarray(disp, dtype=np.float32)
    h, w = d.shape
    mask = np.zeros((h, w), dtype=bool)
    if h < 3 or w < 3:
        return mask

    def at(dy, dx):
        return d[1 + dy: h - 1 + dy, 1 + dx: w - 1 + dx]

    with np.errstate(invalid="ignore", over="ignore"):
        gx = (-at(-1, -1) + at(-1, 1) - 2 * at(0, -1) + 2 * at(0, 1)
              - at(1, -1) + at(1, 1))
        gy = (-at(-1, -1) - 2 * at(-1, 0) - at(-1, 1)
              + at(1, -1) + 2 * at(1, 0) + at(1, 1))
        mask[1:-1, 1:-1] = (np.abs(gx) + np.abs(gy)) > EDGE_THRESHOLD
    return mask


def depth_discontinuity_adjustment(disp: np.ndarray, cost: np.ndarray
                                   ) -> np.ndarray:
    """The adjusted (H, W) float32 map, a new array. ``disp``: (H, W)
    float32, +inf where invalid; ``cost``: the (D, H, W) volume after
    scanline optimisation, read at [lround(d), y, x]. Only +inf marks an
    invalid disparity in a map; any value that is not finite is skipped,
    as a pixel and as a candidate."""
    d_range = cost.shape[0]
    mask = edge_mask(disp)
    h, w = disp.shape
    rows = np.asarray(disp, dtype=np.float32).tolist()
    for y in range(h):
        row = rows[y]
        for x in range(1, w - 1):
            if not mask[y, x]:
                continue
            d = row[x]
            if not math.isfinite(d):
                continue
            di = lround(d)
            if not 0 <= di < d_range:
                continue
            c0 = cost[di, y, x]
            for x2 in (x - 1, x + 1):
                d2 = row[x2]
                if not math.isfinite(d2):
                    continue
                d2i = lround(d2)
                if not 0 <= d2i < d_range:
                    continue
                c = cost[d2i, y, x2]
                if c < c0:
                    row[x] = d2
                    c0 = c
    return np.asarray(rows, dtype=np.float32).reshape(h, w)


def median_3x3_inplace(disp: np.ndarray) -> np.ndarray:
    """The in-place 3x3 median of an (H, W) float32 map without NaN, a
    new array: in raster order on one buffer, each pixel's window
    clipped at the border, sorted, and its element ``size // 2``
    written back at once."""
    h, w = disp.shape
    rows = np.asarray(disp, dtype=np.float32).tolist()
    for y in range(h):
        band = rows[max(y - 1, 0): y + 2]
        for x in range(w):
            x0, x1 = max(x - 1, 0), x + 2
            vals = [v for r in band for v in r[x0:x1]]
            vals.sort()
            rows[y][x] = vals[len(vals) // 2]
    return np.asarray(rows, dtype=np.float32).reshape(h, w)


def check_options(opts: dict) -> dict:
    """The options with ``disp_range``."""
    out = dict(opts)
    out["disp_range"] = opts["max_disparity"] - opts["min_disparity"]
    return out


@torch.no_grad()
def match(left: np.ndarray, right: np.ndarray, opts: dict, device="cpu",
          vol_dtype=torch.float32) -> np.ndarray:
    """(H, W, 3) uint8 RGB pair -> (H, W) float32 disparity, +inf where
    invalid: ``adcensus.match``'s stages on ``device`` up to the
    interpolation, then the adjustment and the median on the host, each
    where its option is on (the out-of-place median where
    ``exact_median`` is off)."""
    o = check_options(opts)
    lt = torch.as_tensor(np.ascontiguousarray(left), device=device)
    rt = torch.as_tensor(np.ascontiguousarray(right), device=device)
    cost = plain.cost_volume(lt, rt, plain.census_9x7(plain.gray(lt)),
                             plain.census_9x7(plain.gray(rt)), o)
    cost = cost.to(vol_dtype)
    arms = plain.build_arms(lt, o)
    cost = plain.aggregate(cost, arms, o)
    cost = plain.scanline_optimize(cost, lt, rt, o)
    disp_l, disp_r = plain.wta_left(cost, o), plain.wta_right(cost, o)
    disp = disp_l
    if o["do_lr_check"]:
        disp, occl, mism = plain.outlier_detection(disp_l, disp_r, o)
    else:
        occl = mism = torch.zeros_like(disp, dtype=torch.bool)
    if o["do_filling"]:
        disp = plain.iterative_region_voting(disp, arms, occl, mism, o)
        disp = plain.proper_interpolation(disp, lt, occl, mism, o)
    disp = disp.cpu().numpy()
    if o.get("do_discontinuity_adjustment"):
        # a bfloat16 volume (the control) widens to float32 exactly
        disp = depth_discontinuity_adjustment(
            disp, cost.to(torch.float32).cpu().numpy())
    del cost
    if o.get("exact_median"):
        return median_3x3_inplace(disp)
    return plain.median_3x3(torch.as_tensor(disp)).numpy()
