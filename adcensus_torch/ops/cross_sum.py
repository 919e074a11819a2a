"""Kernel B1: one cross-aggregation iteration (variable-arm window sums).

Port of ``adcensus_tpu/ops/cross_sum_pallas.py``. ``cross_pass`` launches
``csrc/cross_sum.cu`` for a CUDA tensor and runs ``cross_pass_plain`` (the
port of ``cross_pass_ref``) for a CPU tensor. Both add the terms of each
arm in ascending offset from 0.0 (cross_aggregator.cpp:362-383), so they
agree bitwise.
"""
from __future__ import annotations

import torch

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for


def _masked_roll_sum(p, lo_arm, hi_arm, axis: int, max_arm: int):
    """sum_{t=-lo_arm..hi_arm} p[i + t] along ``axis``, as masked rolls
    in ascending t (port of ``_masked_roll_sum_jnp``). Masked terms add
    0.0, an exact identity; wrapped values are masked off because arms
    never cross the image border."""
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    acc = torch.zeros_like(p)
    for t in range(-max_arm, max_arm + 1):
        if t == 0:
            acc = acc + p
            continue
        rolled = torch.roll(p, -t, dims=axis)
        cond = lo_arm >= -t if t < 0 else hi_arm >= t
        acc = acc + torch.where(cond, rolled, zero)
    return acc


def cross_pass_plain(
    vol: torch.Tensor,
    arms: torch.Tensor,
    sup: torch.Tensor,
    horizontal_first: bool,
    max_arm: int,
    normalize: bool = True,
) -> torch.Tensor:
    """Plain version of kernel B1 (port of ``cross_pass_ref``)."""
    al, ar, at, ab = (arms[..., k].to(torch.int32) for k in range(4))
    if horizontal_first:
        tmp = _masked_roll_sum(vol, al, ar, 2, max_arm)
        res = _masked_roll_sum(tmp, at, ab, 1, max_arm)
    else:
        tmp = _masked_roll_sum(vol, at, ab, 1, max_arm)
        res = _masked_roll_sum(tmp, al, ar, 2, max_arm)
    if normalize:
        res = res / sup.to(torch.float32)
    return res


def cross_pass(
    vol: torch.Tensor,
    arms: torch.Tensor,
    sup: torch.Tensor,
    horizontal_first: bool,
    max_arm: int,
    normalize: bool = True,
) -> torch.Tensor:
    """One cross-aggregation iteration over a (D, H, W) float32 volume.

    arms: (H, W, 4) int32 (left, right, top, bottom); sup: (H, W) float32
    support counts matching ``horizontal_first``.
    """
    d, h, w = vol.shape
    for name, t, dtype, shape in (
        ("vol", vol, torch.float32, (d, h, w)),
        ("arms", arms, torch.int32, (h, w, 4)),
        ("sup", sup, torch.float32, (h, w)),
    ):
        _build.check(name, t, dtype, shape, vol.device)
    if not kernels_for(vol):
        return cross_pass_plain(
            vol, arms, sup, horizontal_first, max_arm, normalize
        )
    tmp = torch.empty_like(vol)
    out = torch.empty_like(vol)
    _build.launch(
        "cross_sum",
        vol.data_ptr(), arms.data_ptr(), sup.data_ptr(),
        tmp.data_ptr(), out.data_ptr(),
        d, h, w, int(max_arm), int(horizontal_first), int(normalize),
        torch.cuda.current_stream(vol.device).cuda_stream,
    )
    return out

