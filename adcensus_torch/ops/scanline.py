"""Kernel B2: one directional scanline-optimization pass.

Port of ``adcensus_tpu/ops/scanline_pallas.py``. ``scanline_pass`` takes
the (D, H, W) volume as it lies: for a CUDA tensor it launches
``csrc/scanline.cu``, which walks the volume through strides (no
transposed copy); for a CPU tensor it runs ``scanline_pass_plain``, the
port of ``stages/scanline.py:scanline_pass_scan``.

Recurrence (scanline_optimizer.cpp:143-151; no min subtraction, /2):
    Lr(p,d) = (C(p,d) + min(Lr(p-r,d), Lr(p-r,d-1)+P1,
                            Lr(p-r,d+1)+P1, min_d' Lr(p-r,d') + P2)) / 2
with Large_Float at d = -1 and d = D.
"""
from __future__ import annotations

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


def scanline_pass(
    cost: torch.Tensor,
    code: torch.Tensor,
    flags: torch.Tensor,
    p1: float,
    p2: float,
    axis: str,
    reverse: bool,
) -> torch.Tensor:
    """One pass over a (D, H, W) float32 volume along ``axis`` ("x": rows,
    S = W; "y": columns, S = H), backward when ``reverse``.

    code: (D, H, W) uint8 penalty codes; flags: (S,) int32 FLAG_* values
    in scan order (the first entry is the first step scanned).
    """
    if axis not in ("x", "y"):
        raise ValueError(f"axis must be 'x' or 'y', got {axis!r}")
    d, h, w = cost.shape
    s_len, paths = (w, h) if axis == "x" else (h, w)
    s_stride, p_stride = (1, w) if axis == "x" else (w, 1)
    for name, t, dtype, shape in (
        ("cost", cost, torch.float32, (d, h, w)),
        ("code", code, torch.uint8, (d, h, w)),
        ("flags", flags, torch.int32, (s_len,)),
    ):
        _build.check(name, t, dtype, shape, cost.device)
    if not kernels_for(cost):
        return scanline_pass_plain(cost, code, flags, p1, p2, axis, reverse)
    (a0, a1, a2), (b0, b1, b2) = penalty_table(p1, p2)
    out = torch.empty_like(cost)
    _build.launch(
        "scanline",
        cost.data_ptr(), code.data_ptr(), flags.data_ptr(), out.data_ptr(),
        d, s_len, paths, h * w, s_stride, p_stride,
        float(a0), float(a1), float(a2), float(b0), float(b1), float(b2),
        int(reverse),
        torch.cuda.current_stream(cost.device).cuda_stream,
    )
    return out
