"""Kernel B4: the 16-ray proper-interpolation fill search.

Port of ``adcensus_tpu/ops/interp_pallas.py``. ``ray_interp`` launches
``csrc/ray_interp.cu`` for a CUDA tensor and runs ``ray_interp_plain``
for a CPU tensor: the port of ``stages/refine.py:_first_valid_along_rays``
plus the cross-ray selection at ``stages/refine.py:490-502``
(multistep_refiner.cpp:229-305).
"""
from __future__ import annotations

from typing import Tuple

import torch

from adcensus_torch.config import LARGE_FLOAT
from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import color_absdiff_sum, kernels_for


def _first_valid_along_rays(
    disp: torch.Tensor,
    left: torch.Tensor,
    offsets: torch.Tensor,
    target: torch.Tensor,
    need_color: bool,
):
    """For each pixel and each ray, the first finite disparity along the
    ray and the color distance (sum of absolute channel differences to
    the center pixel) at the hit. Rays start only at target pixels; the
    march stops once every ray of every target pixel is done.

    Returns (found, val, dist), each (n_rays, H, W)."""
    h, w = disp.shape
    n_rays, n_steps, _ = offsets.shape
    dev = disp.device
    # step m of a ray is at most m cells away, so a moat of n_steps + 1
    # cells holds every probe. NaN beyond the border: a ray landing there
    # has left the image and ends (multistep_refiner.cpp:255-260); +inf
    # cells are in-image invalids the ray marches through.
    pad = n_steps + 1
    disp_pad = torch.full((h + 2 * pad, w + 2 * pad), float("nan"), device=dev)
    disp_pad[pad : pad + h, pad : pad + w] = disp
    left_pad = torch.zeros((h + 2 * pad, w + 2 * pad, 3), dtype=torch.int32,
                           device=dev)
    left_pad[pad : pad + h, pad : pad + w] = left.to(torch.int32)
    center = left_pad[pad : pad + h, pad : pad + w]
    rows = torch.arange(h, device=dev)[None, :, None] + pad
    cols = torch.arange(w, device=dev)[None, None, :] + pad
    offs = offsets.to(device=dev, dtype=torch.long)

    done = (~target)[None].expand(n_rays, h, w).clone()
    hit = torch.zeros((n_rays, h, w), dtype=torch.bool, device=dev)
    val = torch.zeros((n_rays, h, w), device=dev)
    dist = torch.zeros((n_rays, h, w), dtype=torch.int32, device=dev)
    for i in range(n_steps):
        if bool(done.all()):
            break
        ri = rows + offs[:, i, 0][:, None, None]
        ci = cols + offs[:, i, 1][:, None, None]
        cand = disp_pad[ri, ci]
        cand_valid = torch.isfinite(cand)
        take = cand_valid & ~done
        val = torch.where(take, cand, val)
        if need_color:  # occlusion fills never read colors
            d = color_absdiff_sum(left_pad[ri, ci], center[None])
            dist = torch.where(take, d, dist)
        done = done | cand_valid | torch.isnan(cand)
        hit = hit | take
    return hit, val, dist


def ray_interp_plain(
    disp: torch.Tensor,
    left: torch.Tensor,
    offsets: torch.Tensor,
    target: torch.Tensor,
    is_mismatch: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B4: (found_any, fill) with fill 0.0 where
    no ray hit. Mismatch: the hit with the least color distance, first
    minimum in ray order; occlusion: the least hit disparity."""
    found, val, dist = _first_valid_along_rays(
        disp, left, offsets, target, need_color=is_mismatch
    )
    if is_mismatch:
        dist = torch.where(found, dist, 10**9)
        ray = dist.argmin(dim=0)  # first minimum in ray order
        fill = torch.gather(val, 0, ray[None])[0]
    else:
        fill = torch.where(found, val, LARGE_FLOAT).amin(dim=0)
    any_found = found.any(dim=0)
    return any_found, torch.where(any_found, fill, 0.0)


def ray_interp(
    disp: torch.Tensor,
    left: torch.Tensor,
    offsets: torch.Tensor,
    target: torch.Tensor,
    is_mismatch: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found_any, fill) for every pixel of ``disp``.

    disp: (H, W) float32, +inf = invalid; left: (H, W, 3) uint8;
    offsets: (n_rays, n_steps, 2) int32 (dy, dx) ray table; target:
    (H, W) bool, the pixels whose fills are read. Non-target pixels get
    found = False, fill = 0.0.
    """
    h, w = disp.shape
    n_rays, n_steps, _ = offsets.shape
    for name, t, dtype, shape in (
        ("disp", disp, torch.float32, (h, w)),
        ("left", left, torch.uint8, (h, w, 3)),
        ("offsets", offsets, torch.int32, (n_rays, n_steps, 2)),
        ("target", target, torch.bool, (h, w)),
    ):
        _build.check(name, t, dtype, shape, disp.device)
    if not kernels_for(disp):
        return ray_interp_plain(disp, left, offsets, target, is_mismatch)
    found = torch.empty((h, w), dtype=torch.bool, device=disp.device)
    fill = torch.empty((h, w), dtype=torch.float32, device=disp.device)
    _build.launch(
        "ray_interp",
        disp.data_ptr(), left.data_ptr(), target.data_ptr(),
        offsets.data_ptr(), found.data_ptr(), fill.data_ptr(),
        h, w, n_rays, n_steps, int(is_mismatch),
        torch.cuda.current_stream(disp.device).cuda_stream,
    )
    return found, fill
