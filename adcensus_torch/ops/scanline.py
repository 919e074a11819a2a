"""Kernel B2: one directional scanline-optimization pass.

Port of ``adcensus_tpu/ops/scanline_pallas.py``. ``scanline_pass`` takes
the (D, H, W) volume as it lies: for a CUDA tensor it launches
``csrc/scanline.cu``, which walks the volume through strides (no
transposed copy), one warp per path, with the launch geometry of
``scanline_geometry``; for a CPU tensor it runs ``scanline_pass_plain``,
the port of ``stages/scanline.py:scanline_pass_scan``.

Recurrence (scanline_optimizer.cpp:143-151; no min subtraction, /2):
    Lr(p,d) = (C(p,d) + min(Lr(p-r,d), Lr(p-r,d-1)+P1,
                            Lr(p-r,d+1)+P1, min_d' Lr(p-r,d') + P2)) / 2
with Large_Float at d = -1 and d = D.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from adcensus_torch.config import LARGE_FLOAT
from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for, shift_last

# Per-step flags in scan order: image padding (carry passes through), the
# first real step (copies its costs), every later step.
FLAG_PAD = 0
FLAG_SEED = 1
FLAG_NORMAL = 2

MAX_D = 1024
SMEM_LIMIT = 232_448          # shared memory one H100 block may use
PATHS_PER_BLOCK = 4           # compute warps per block, one per path
MIN_BLOCKS = 64               # fewer paths per block below this grid
# Launch geometry measured fastest on the H100 at 64x375x450 (see
# sweep_scanline.py): 32-step chunks on x passes, 16 on y passes, and
# enough ring slots to copy 64 steps ahead of the compute warps.
STEPS_PER_CHUNK = {"x": 32, "y": 16}
LOOKAHEAD_STEPS = 64
MAX_STAGES = 6                # ring slots


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def scanline_layout(d: int, pb: int, k: int, axis: str):
    """One ring slot of kernel B2 in bytes, as csrc/scanline.cu lays it
    out: a (D, outer, inner) f32 cost tile whose inner axis is the
    volume's contiguous one (steps on x passes, paths on y passes) and
    whose rows hold exactly their cells; the chunk's left-image flags,
    ``outer`` rows each the grain-aligned window that covers its
    ``inner`` flags (16-byte grains on x passes, 4-byte on y passes); the
    right-image flags that the chunk's codes look up, ``outer`` rows (x:
    paths, y: steps) each the 16-byte grains that cover ``inner + D - 1``
    columns; and K int32 step flags. An odd number of 8-byte units
    between the cost tile's d-planes spreads the lanes of a warp, one d
    apart, over the banks.

    Returns (inner, outer, cost d-stride, left grain, left grains per
    row, right grains per row, slot bytes)."""
    inner, outer = (k, pb) if axis == "x" else (pb, k)
    cost_ds = -(-outer * inner * 4 // 8) * 8
    if cost_ds // 8 % 2 == 0:
        cost_ds += 8
    grain = 16 if axis == "x" else 4
    groups = (2 * grain - 2 + inner) // grain
    right_groups = (30 + inner + d - 1) // 16
    slot = (_round16(d * cost_ds) + _round16(outer * groups * grain)
            + outer * right_groups * 16 + _round16(4 * k))
    return inner, outer, cost_ds, grain, groups, right_groups, slot


@functools.lru_cache(maxsize=None)
def scanline_geometry(d: int, s: int, p: int, axis: str):
    """Launch geometry of kernel B2 for a (D, S steps, P paths) pass:
    (paths per block PB, steps per chunk K, ring slots, shared bytes).

    PB is PATHS_PER_BLOCK, halved while the grid would have fewer than
    MIN_BLOCKS blocks; K is STEPS_PER_CHUNK[axis], halved while it is
    twice the scan. The ring takes 1 + LOOKAHEAD_STEPS / K slots (2 to
    MAX_STAGES), fewer where SMEM_LIMIT is short; where even two do not
    fit, K halves, then PB. Raises ValueError for what no geometry fits."""
    if axis not in ("x", "y"):
        raise ValueError(f"axis must be 'x' or 'y', got {axis!r}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"scanline kernel takes 1 <= D <= {MAX_D}, got {d}")
    if s < 1 or p < 1:
        raise ValueError(f"scanline needs S >= 1 and P >= 1, got {s}, {p}")
    pb = PATHS_PER_BLOCK
    while pb > 1 and -(-p // pb) < MIN_BLOCKS:
        pb //= 2
    k = STEPS_PER_CHUNK[axis]
    while k > 1 and k >= 2 * s:
        k //= 2
    while True:
        slot = scanline_layout(d, pb, k, axis)[-1]
        stages = min(MAX_STAGES, 1 + -(-LOOKAHEAD_STEPS // k),
                     SMEM_LIMIT // slot)
        if stages >= 2:
            return pb, k, stages, stages * slot
        if k > 1:
            k //= 2
        elif pb > 1:
            pb //= 2
        else:
            raise ValueError(f"no scanline geometry fits D={d} in "
                             f"{SMEM_LIMIT} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def penalty_table(p1: float, p2: float):
    """float32 (P1, P2) for penalty codes 0, 1, 2: (p1, p2), (p1, p2)/4,
    (p1, p2)/10, each an f32 division (scanline_optimizer.cpp:128-141)."""
    f = np.float32
    return (
        (f(p1), f(f(p1) / f(4)), f(f(p1) / f(10))),
        (f(p2), f(f(p2) / f(4)), f(f(p2) / f(10))),
    )


def scanline_pass_scan(
    cost_s: torch.Tensor,
    P1_s: torch.Tensor,
    P2_s: torch.Tensor,
    flags: torch.Tensor,
) -> torch.Tensor:
    """DP over (S, P, D) tensors, one step at a time (port of
    ``scanline_pass_scan``): padding passes the carry through, the seed
    step copies costs unchanged (scanline_optimizer.cpp:99-100)."""
    p, d = cost_s.shape[1:]
    lr_prev = torch.full((p, d), LARGE_FLOAT, device=cost_s.device)
    min_prev = torch.full((p,), LARGE_FLOAT, device=cost_s.device)
    half = torch.tensor(0.5, dtype=torch.float32, device=cost_s.device)
    outs = []
    for k, flag in enumerate(flags.tolist()):
        c = cost_s[k]
        if flag == FLAG_NORMAL:
            l2 = shift_last(lr_prev, 1, LARGE_FLOAT) + P1_s[k]
            l3 = shift_last(lr_prev, -1, LARGE_FLOAT) + P1_s[k]
            l4 = min_prev[:, None] + P2_s[k]
            m = torch.minimum(
                torch.minimum(lr_prev, l2), torch.minimum(l3, l4)
            )
            lr = (c + m) * half
        else:
            lr = c
        if flag != FLAG_PAD:
            lr_prev = lr
            min_prev = lr.amin(dim=-1)
        outs.append(lr)
    return torch.stack(outs)


def scanline_pass_plain(
    cost: torch.Tensor,
    code: torch.Tensor,
    flags: torch.Tensor,
    p1: float,
    p2: float,
    axis: str,
    reverse: bool,
) -> torch.Tensor:
    """Plain version of kernel B2: decode the penalties, lay the volume
    out as (S, P, D) in scan order, run the scan, and undo the layout."""
    t1, t2 = penalty_table(p1, p2)
    idx = code.long()
    P1 = torch.tensor(t1, device=cost.device)[idx]
    P2 = torch.tensor(t2, device=cost.device)[idx]
    perm = (2, 1, 0) if axis == "x" else (1, 2, 0)
    vols = [v.permute(perm) for v in (cost, P1, P2)]
    if reverse:
        vols = [v.flip(0) for v in vols]
    out = scanline_pass_scan(*vols, flags)
    if reverse:
        out = out.flip(0)
    if axis == "x":
        return out.permute(2, 1, 0).contiguous()
    return out.permute(2, 0, 1).contiguous()


def penalty_codes(
    d1: torch.Tensor,
    rd: torch.Tensor,
    d: int,
    tso: int,
    min_disparity: int = 0,
    col0: int = 0,
    real_w: Optional[int] = None,
) -> torch.Tensor:
    """(D, rows, out_w) uint8 penalty codes of columns [col0, col0 + out_w)
    (0: both gradients < tso, 1: exactly one >= tso, 2: both >= tso;
    scanline_optimizer.cpp:128-141) from their left-image distances ``d1``
    (rows, out_w) and the right image's ``rd`` (rows, W) at full width,
    since the epipolar lookup rd[y, x - d] crosses any split of the
    columns; ``real_w`` (default W) is the image's width.

    The reference's d2 lookup is sticky (scanline_optimizer.cpp:116-126,
    d2 initialized to d1). As xr = x - d - min_disparity falls with d,
    that has a closed form:

        d2 = d1[y, x]           if xr >= real_w - 1 or x - min_disparity <= 0
             rd[y, max(xr, 1)]  otherwise (column 1 is column 0 if W is 1)

    Kernel B2 decodes the same codes per cell from ``d1 >= tso`` and
    ``rd >= tso``; this is the plain version's volume."""
    out_w = d1.shape[1]
    w_full = rd.shape[1]
    real_w = w_full if real_w is None else real_w
    dev = rd.device
    rd_col1 = rd[:, 1:2] if w_full > 1 else rd
    x = col0 + torch.arange(out_w, device=dev)[None, :]
    d_abs = torch.arange(d, device=dev)[:, None] + min_disparity
    xr = x - d_abs  # (D, out_w)
    use_d1 = (xr >= real_w - 1) | ((x - min_disparity) <= 0)
    # rd at column xr (out-of-range columns are never selected below)
    shifted = rd[:, xr.clamp(0, w_full - 1)].permute(1, 0, 2)  # (D, rows, out_w)
    sticky = torch.where((xr < 1)[:, None, :], rd_col1[None], shifted)
    d2 = torch.where(use_d1[:, None, :], d1[None], sticky)
    code = (d1[None] >= tso).to(torch.uint8) + (d2 >= tso).to(torch.uint8)
    # the gather above leaves a (rows, D, out_w) memory layout
    return code.contiguous()


def scanline_pass(
    cost: torch.Tensor,
    d1: torch.Tensor,
    rd: torch.Tensor,
    flags: torch.Tensor,
    tso: int,
    p1: float,
    p2: float,
    axis: str,
    reverse: bool,
    min_disparity: int = 0,
    col0: int = 0,
    real_w: Optional[int] = None,
) -> torch.Tensor:
    """One pass over a (D, H, W) float32 volume along ``axis`` ("x": rows,
    S = W; "y": columns, S = H), backward when ``reverse``.

    The penalty codes are ``penalty_codes(d1, rd, D, tso, min_disparity,
    col0, real_w)``: d1 (H, W) and rd (H, W_full) int32 color distances,
    the volume's column 0 being the image's column ``col0``. Kernel B2
    derives each cell's code from the two maps' flags (``>= tso``), so
    no (D, H, W) code volume is built on the card; the plain version
    takes the volume. flags: (S,) int32 FLAG_* values in scan order (the
    first entry is the first step scanned).
    """
    if axis not in ("x", "y"):
        raise ValueError(f"axis must be 'x' or 'y', got {axis!r}")
    d, h, w = cost.shape
    s_len, paths = (w, h) if axis == "x" else (h, w)
    w_full = rd.shape[1] if rd.dim() == 2 else 0
    if w_full < 1:
        raise ValueError(f"rd must be (H, W_full) with W_full >= 1, got "
                         f"{tuple(rd.shape)}")
    for name, t, dtype, shape in (
        ("cost", cost, torch.float32, (d, h, w)),
        ("d1", d1, torch.int32, (h, w)),
        ("rd", rd, torch.int32, (h, w_full)),
        ("flags", flags, torch.int32, (s_len,)),
    ):
        _build.check(name, t, dtype, shape, cost.device)
    real_w = w_full if real_w is None else real_w
    if not kernels_for(cost):
        code = penalty_codes(d1, rd, d, tso, min_disparity, col0, real_w)
        return scanline_pass_plain(cost, code, flags, p1, p2, axis, reverse)
    return launch_pass(cost, d1 >= tso, rd >= tso, flags, p1, p2, axis,
                       reverse, min_disparity, col0, real_w,
                       scanline_geometry(d, s_len, paths, axis))


def launch_pass(cost, left, right, flags, p1, p2, axis, reverse,
                min_disparity, col0, real_w, geometry):
    """Launch kernel B2 on checked CUDA tensors: ``left`` (H, W) and
    ``right`` (H, W_full) the bool flags ``d1 >= tso`` and ``rd >= tso``
    of ``scanline_pass``, with ``geometry`` = (PB, K, ring slots, shared
    bytes); ``scanline_pass`` gives it ``scanline_geometry``'s, the card
    tests and the geometry sweep others."""
    d, h, w = cost.shape
    s_len, paths = (w, h) if axis == "x" else (h, w)
    s_stride, p_stride = (1, w) if axis == "x" else (w, 1)
    _build.check("left", left, torch.bool, (h, w), cost.device)
    _build.check("right", right, torch.bool, (h, right.shape[1]),
                 cost.device)
    (a0, a1, a2), (b0, b1, b2) = penalty_table(p1, p2)
    out = torch.empty_like(cost)
    _build.launch(
        "scanline",
        cost.data_ptr(), left.data_ptr(), right.data_ptr(), flags.data_ptr(),
        out.data_ptr(), d, s_len, paths, h * w, s_stride, p_stride,
        right.shape[1], col0, min_disparity, real_w,
        float(a0), float(a1), float(a2), float(b0), float(b1), float(b2),
        int(reverse), int(axis == "x"), *geometry,
        torch.cuda.current_stream(cost.device).cuda_stream,
    )
    return out
