"""Kernels C1 (census) and C2 (the AD-Census cost volume): launches.

``csrc/cost.cu`` holds both. They replace the plain PyTorch bodies of
``stages/cost.py`` (``census_transform_9x7_plain``,
``compute_cost_planes_plain``), ports of ``adcensus_tpu/stages/cost.py``,
which is ``jnp`` and not a Pallas kernel. The stage routes: a CUDA tensor
launches these, a CPU tensor runs the plain bodies.

C2 takes two float32 tables that the stage builds with the plain
version's own operations (``stages/cost.py:cost_tables``): the cost of a
pixel and plane is ``ad_table[|dR| + |dG| + |dB|] - cen_table[hamming]``,
one float32 subtraction, as the plain version's last operation, so the
volume is bitwise the plain version's.
"""
from __future__ import annotations

import torch

from adcensus_torch.ops import _build

# csrc/cost.cu holds the same constants (with a k)
CENSUS_TX, CENSUS_TY = 64, 4  # C1: columns and rows a block, a thread a pixel
TILE = 512                    # C2: columns a block
PLANES = 16                   # C2: planes a block at most
AD_VALUES = 766               # |dR| + |dG| + |dB| in 0..765
CEN_VALUES = 64               # the popcount of 63 bits in 0..63


def cost_volume_geometry(w: int):
    """C2's launch geometry for images ``w`` wide: (columns a thread,
    threads a block). A thread takes V consecutive columns, V the largest
    of 4, 2, 1 that divides ``w``, so its V outputs of a plane are one
    aligned store; TILE / V threads cover the block's TILE columns."""
    v = 4 if w % 4 == 0 else 2 if w % 2 == 0 else 1
    return v, TILE // v


def census(gray: torch.Tensor, row_offset: int, full_h: int,
           full_w: int) -> torch.Tensor:
    """Kernel C1: the (H, W) int64 signatures of a CUDA (H, W) uint8
    gray image, as ``stages/cost.py:census_transform_9x7`` defines them."""
    gray = gray.contiguous()
    h, w = gray.shape
    _build.check("gray", gray, torch.uint8, (h, w), gray.device)
    out = torch.empty((h, w), dtype=torch.int64, device=gray.device)
    if h * w:
        _build.launch(
            "census", gray.data_ptr(), out.data_ptr(), h, w, row_offset,
            full_h, full_w,
            torch.cuda.current_stream(gray.device).cuda_stream,
        )
    return out


def cost_volume(left: torch.Tensor, right: torch.Tensor,
                census_l: torch.Tensor, census_r: torch.Tensor,
                ad_table: torch.Tensor, cen_table: torch.Tensor,
                d_first: int, d_count: int, real_w: int) -> torch.Tensor:
    """Kernel C2: ``d_count`` (H, W) float32 planes; plane i samples the
    right image at xr = x - (d_first + i), and costs 1.0 where xr < 0 or
    xr >= ``real_w``. Inputs on one CUDA device: (H, W, 3) uint8 images,
    (H, W) int64 census, tables of AD_VALUES and CEN_VALUES float32."""
    left, right = left.contiguous(), right.contiguous()
    census_l, census_r = census_l.contiguous(), census_r.contiguous()
    h, w, _ = left.shape
    dev = left.device
    _build.check("left", left, torch.uint8, (h, w, 3), dev)
    _build.check("right", right, torch.uint8, (h, w, 3), dev)
    _build.check("census_l", census_l, torch.int64, (h, w), dev)
    _build.check("census_r", census_r, torch.int64, (h, w), dev)
    _build.check("ad_table", ad_table, torch.float32, (AD_VALUES,), dev)
    _build.check("cen_table", cen_table, torch.float32, (CEN_VALUES,), dev)
    out = torch.empty((d_count, h, w), dtype=torch.float32, device=dev)
    if d_count * h * w:
        cols, _ = cost_volume_geometry(w)
        _build.launch(
            "cost_volume", left.data_ptr(), right.data_ptr(),
            census_l.data_ptr(), census_r.data_ptr(), ad_table.data_ptr(),
            cen_table.data_ptr(), out.data_ptr(), h, w, d_count, d_first,
            real_w, cols, torch.cuda.current_stream(dev).cuda_stream,
        )
    return out
