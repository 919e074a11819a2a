"""The plain reference computed in blocks, so that one card holds it at
sizes where ``adcensus.py``'s whole-volume temporaries do not fit.

``match`` equals ``adcensus.match`` value for value. It holds one whole
(D, H, W) volume in ``vol_dtype`` and computes each volume stage in
blocks along an axis on which the plain computation is independent:

* d-planes for the cost, the aggregation and the region voting;
* rows for the x scanline passes and both winner-take-alls;
* columns for the y scanline passes.

Every block runs ``adcensus.py``'s own functions wherever a block is a
valid input to them. The functions below exist only where it is not,
and say why. The 2-D stages run whole. ``block_bytes`` bounds one
block's volume in float32; a stage's temporaries are a small multiple of
it (about ten, in the cost and the scanline passes).
"""
from __future__ import annotations

import functools
import types

import numpy as np
import torch

from stereo_bench.reference import adcensus as plain

# One block's float32 volume: 1 GiB keeps a 2632x1988, D = 640 match
# (a 13.4 GB volume) within 40 GB of one card.
BLOCK_BYTES = 1 << 30


def block_len(n: int, unit_bytes: int, block_bytes: int) -> int:
    """How many of ``n`` slices of ``unit_bytes`` each one block holds:
    as many as ``block_bytes`` takes, at least one."""
    return max(1, min(n, block_bytes // unit_bytes))


def blocks(n: int, unit_bytes: int, block_bytes: int):
    """[start, stop) ranges that cover ``n`` slices, in order."""
    step = block_len(n, unit_bytes, block_bytes)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _rebound(fn, **names):
    """``fn`` with the module globals in ``names`` bound to others: the
    plain function's own arithmetic around the one step that a block
    has to take differently."""
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names},
                              fn.__name__, fn.__defaults__, fn.__closure__)


def y_penalty_code(left, right, opts, forward: bool, c0: int, c1: int):
    """``adcensus._penalty_code(left, right, opts, "y", forward)`` at
    columns [c0, c1) only. ``_penalty_code`` cannot take a block of
    columns: its right-image term reads columns x - d outside the block
    (and column 1), and its edge cases ask for the whole width."""
    h, w, _ = left.shape
    dev = left.device
    direction = 1 if forward else -1
    d1 = plain.color_dist(left[:, c0:c1],
                          plain.shift2d(left, direction, 0, 0)[:, c0:c1])
    rd = plain.color_dist(right, plain.shift2d(right, direction, 0, 0))
    rd_col1 = rd[:, 1:2] if w > 1 else rd
    x = torch.arange(c0, c1, device=dev)[None, :]
    d_abs = (torch.arange(opts["disp_range"], device=dev)[:, None]
             + opts["min_disparity"])
    xr = x - d_abs
    use_d1 = (xr >= w - 1) | ((x - opts["min_disparity"]) <= 0)
    shifted = rd[:, xr.clamp(0, w - 1)].permute(1, 0, 2)
    sticky = torch.where((xr < 1)[:, None, :], rd_col1[None], shifted)
    d2 = torch.where(use_d1[:, None, :], d1[None], sticky)
    tso = opts["so_tso"]
    return ((d1[None] >= tso).to(torch.uint8)
            + (d2 >= tso).to(torch.uint8)).contiguous()


def region_vote_stats(di, valid, arms, d_range: int, max_arm: int, target,
                      block_bytes: int):
    """``adcensus._region_vote_stats`` over blocks of d-planes, each
    voting with ``di - d0``. Merging the blocks is new: the counts are
    summed and the maxima taken, and the argmax comes from the first
    block that holds the maximum, so that ties go to the lowest d as
    ``argmax`` over all planes gives them. A block that holds no valid
    vote counts 0 everywhere, which changes none of the three, so it is
    not computed."""
    best, top, total = (torch.zeros(di.shape, dtype=torch.int32,
                                    device=di.device) for _ in range(3))
    for d0, d1 in blocks(d_range, di.numel() * 4, block_bytes):
        if not bool((valid & (di >= d0) & (di < d1)).any()):
            continue
        b, m, s = plain._region_vote_stats(di - d0, valid, arms, d1 - d0,
                                           max_arm, target)
        new = m > top
        best = torch.where(new, b + d0, best)
        top = torch.where(new, m, top)
        total = total + s
    return best, top, total


@torch.no_grad()
def match(left: np.ndarray, right: np.ndarray, opts: dict, device="cpu",
          vol_dtype=torch.float32, block_bytes: int = BLOCK_BYTES
          ) -> np.ndarray:
    """(H, W, 3) uint8 RGB pair -> (H, W) float32 disparity, +inf where
    invalid, computed on ``device``: ``adcensus.match``'s result."""
    o = plain.check_options(opts)
    lt = torch.as_tensor(np.ascontiguousarray(left), device=device)
    rt = torch.as_tensor(np.ascontiguousarray(right), device=device)
    h, w, _ = lt.shape
    d_range = o["disp_range"]
    census_l = plain.census_9x7(plain.gray(lt))
    census_r = plain.census_9x7(plain.gray(rt))
    arms = plain.build_arms(lt, o)

    vol = torch.empty((d_range, h, w), dtype=vol_dtype, device=lt.device)
    for d0, d1 in blocks(d_range, h * w * 4, block_bytes):
        ob = dict(o, min_disparity=o["min_disparity"] + d0,
                  disp_range=d1 - d0)
        cost = plain.cost_volume(lt, rt, census_l, census_r, ob)
        vol[d0:d1] = plain.aggregate(cost.to(vol_dtype), arms, o)
        del cost
    rows = blocks(h, d_range * w * 4, block_bytes)
    for forward in (True, False):
        for r0, r1 in rows:
            vol[:, r0:r1] = plain.scanline_pass(
                vol[:, r0:r1], lt[r0:r1], rt[r0:r1], o, "x", forward)
    for forward in (True, False):
        for c0, c1 in blocks(w, d_range * h * 4, block_bytes):
            code = y_penalty_code(lt, rt, o, forward, c0, c1)
            y_pass = _rebound(plain.scanline_pass,
                              _penalty_code=lambda *_: code)
            vol[:, :, c0:c1] = y_pass(vol[:, :, c0:c1], lt, rt, o, "y",
                                      forward)
            del code, y_pass
    disp_l = torch.empty((h, w), dtype=torch.float32, device=lt.device)
    disp_r = torch.empty_like(disp_l)
    for r0, r1 in rows:
        disp_l[r0:r1] = plain.wta_left(vol[:, r0:r1], o)
        disp_r[r0:r1] = plain.wta_right(vol[:, r0:r1], o)
    del vol

    if o["do_lr_check"]:
        disp, occl, mism = plain.outlier_detection(disp_l, disp_r, o)
    else:
        disp = disp_l
        occl = mism = torch.zeros_like(disp, dtype=torch.bool)
    if o["do_filling"]:
        voting = _rebound(plain.iterative_region_voting,
                          _region_vote_stats=functools.partial(
                              region_vote_stats, block_bytes=block_bytes))
        disp = voting(disp, arms, occl, mism, o)
        disp = plain.proper_interpolation(disp, lt, occl, mism, o)
    return plain.median_3x3(disp).cpu().numpy()
