"""Stage 1: AD + Census cost initialization.

Port of ``adcensus_tpu/stages/cost.py`` (reference: cost_computor.cpp:58-137,
adcensus_util.cpp:10-53). The 63-bit census signature is packed into one
int64 per pixel (bit 63 stays 0, so the value is never negative); the
Hamming distance is a SWAR popcount on int64.

``census_transform_9x7`` and ``compute_cost_planes`` launch kernels C1
and C2 (``ops/cost.py``, ``csrc/cost.cu``) for CUDA tensors and run their
plain versions, ``census_transform_9x7_plain`` and
``compute_cost_planes_plain``, for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import cost as cost_ops
from adcensus_torch.ops.basic import f32, kernels_for, shift2d

# 9x7 census window offsets in reference bit order: row -4..4 outer,
# col -3..3 inner, MSB first (adcensus_util.cpp:25-32). Bit k (0 = first
# comparison) goes to position 62-k of the packed signature.
_CENSUS_OFFSETS = [(r, c) for r in range(-4, 5) for c in range(-3, 4)]


def compute_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB (H, W, 3) uint8 -> gray uint8, r*0.299+g*0.587+b*0.114
    truncated (cost_computor.cpp:58-73), in float32 with the JAX
    package's multiply-add order."""
    f = img.to(torch.float32)
    v = f[..., 0] * f32(0.299) + f[..., 1] * f32(0.587) + f[..., 2] * f32(0.114)
    return torch.floor(v).to(torch.uint8)


def compute_gray_host64(img: np.ndarray) -> np.ndarray:
    """Bit-exact double-precision gray conversion (host-side NumPy)."""
    r = img[..., 0].astype(np.float64)
    g = img[..., 1].astype(np.float64)
    b = img[..., 2].astype(np.float64)
    return (r * 0.299 + g * 0.587 + b * 0.114).astype(np.uint8)


def census_transform_9x7(
    gray: torch.Tensor,
    row_offset: int = 0,
    full_h: int | None = None,
    full_w: int | None = None,
) -> torch.Tensor:
    """63-bit census signature per pixel, (H, W) int64.

    Border pixels (rows < 4 or >= h-4, cols < 3 or >= w-3) are zero, and so
    is every pixel of an image no wider than 9 or taller than 7, as in the
    reference (adcensus_util.cpp:17-18 loop bounds).

    ``row_offset``/``full_h``/``full_w`` are the sharded pipeline's slab
    mode: ``gray`` is then a slab whose row 0 is row ``row_offset`` of a
    ``full_h`` x ``full_w`` image, and the border is judged in the image's
    coordinates. Callers supply 4 rows of true context around any row
    they keep."""
    h, w = gray.shape
    full_h = h if full_h is None else full_h
    full_w = w if full_w is None else full_w
    if kernels_for(gray):
        return cost_ops.census(gray, row_offset, full_h, full_w)
    return census_transform_9x7_plain(gray, row_offset, full_h, full_w)


def census_transform_9x7_plain(gray: torch.Tensor, row_offset: int,
                               full_h: int, full_w: int) -> torch.Tensor:
    """Plain version of kernel C1: one shifted comparison a window
    offset; neighbours outside the array read 0."""
    h, w = gray.shape
    sig = torch.zeros((h, w), dtype=torch.int64, device=gray.device)
    if not (full_w > 9 and full_h > 7):
        return sig
    for k, (r, c) in enumerate(_CENSUS_OFFSETS):
        # out[y, x] reads gray[y + r, x + c]
        neigh = shift2d(gray, -r, -c, 0)
        sig |= (neigh < gray).to(torch.int64) << (62 - k)
    gy = row_offset + torch.arange(h, device=gray.device)
    x = torch.arange(w, device=gray.device)
    valid = ((gy >= 4) & (gy < full_h - 4))[:, None] & (
        (x >= 3) & (x < full_w - 3)
    )[None, :]
    return torch.where(valid, sig, 0)


def census_to_u64(census: torch.Tensor) -> np.ndarray:
    """Host-side: int64 signatures -> uint64, the layout of the JAX
    package's ``census_packed_to_u64``."""
    return census.cpu().numpy().astype(np.uint64)


_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def popcount63(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 values (SWAR; no multiply, so no
    signed overflow), as int32."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def hamming63(census_a: torch.Tensor, census_b: torch.Tensor) -> torch.Tensor:
    """Hamming distance of census signatures (adcensus_util.cpp:42-53)."""
    return popcount63(census_a ^ census_b)


def compute_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    census_l: torch.Tensor,
    census_r: torch.Tensor,
    opts: ADCensusOptions,
) -> torch.Tensor:
    """Initial AD-Census cost volume, (D, H, W) float32.

    cost = (1 - exp(-C_ad/lambda_ad)) + (1 - exp(-C_census/lambda_census))
    with C_ad the mean per-channel absolute difference, and out-of-image
    columns costed exactly 1.0 (cost_computor.cpp:82-121). Plane d samples
    the right image at xr = x - (d + min_disparity), all planes at once.
    """
    return compute_cost_planes(left, right, census_l, census_r, opts, 0,
                               opts.disp_range)


def compute_cost_planes(
    left: torch.Tensor,
    right: torch.Tensor,
    census_l: torch.Tensor,
    census_r: torch.Tensor,
    opts: ADCensusOptions,
    d0: int,
    d_count: int,
    real_w: int | None = None,
) -> torch.Tensor:
    """``d_count`` planes of the cost volume from disparity index ``d0``,
    (d_count, H, W) float32: the sharded pipeline's disp layout, where
    each rank builds its own block of planes. Every plane is computed as
    ``compute_cost_volume`` computes it. ``real_w`` is the image's width
    when the images are padded on the right (the sharded pipeline):
    columns xr at or beyond it are out of the image. None is the
    images' width."""
    rw = left.shape[1] if real_w is None else real_w
    if not kernels_for(left):
        return compute_cost_planes_plain(left, right, census_l, census_r,
                                         opts, d0, d_count, rw)
    ad_table, cen_table = cost_tables(opts, left.device)
    return cost_ops.cost_volume(left, right, census_l, census_r, ad_table,
                                cen_table, d0 + opts.min_disparity, d_count,
                                rw)


def ad_term(ad: torch.Tensor, lam_ad: float) -> torch.Tensor:
    """The part of a cost that depends on the AD term alone, 2 -
    exp(-ad / lam_ad), in the plain version's order of operations."""
    return 1.0 - torch.exp(-ad / lam_ad) + 1.0


def census_term(cen: torch.Tensor, lam_cen: float) -> torch.Tensor:
    """The part that depends on the Hamming distance alone; a cost is
    ``ad_term(...) - census_term(...)``."""
    return torch.exp(-cen / lam_cen)


def cost_tables(opts: ADCensusOptions, device) -> tuple:
    """Kernel C2's tables, built on ``device`` with the plain version's
    operations: ``ad_term`` of every AD sum k in 0..765 (k / 3 in
    float32) and ``census_term`` of every Hamming distance in 0..63. A
    cost is then one float32 subtraction of two entries, as the plain
    version's last operation. Built per call: eleven small launches,
    which a CUDA graph captures."""
    # float32 holds these integers exactly, as the plain version's int32
    # sums converted
    ad = torch.arange(cost_ops.AD_VALUES, dtype=torch.float32,
                      device=device) / 3.0
    cen = torch.arange(cost_ops.CEN_VALUES, dtype=torch.float32,
                       device=device)
    return (ad_term(ad, float(opts.lambda_ad)),
            census_term(cen, float(opts.lambda_census)))


def compute_cost_planes_plain(
    left: torch.Tensor,
    right: torch.Tensor,
    census_l: torch.Tensor,
    census_r: torch.Tensor,
    opts: ADCensusOptions,
    d0: int,
    d_count: int,
    rw: int,
) -> torch.Tensor:
    """Plain version of kernel C2: the right image and census gathered
    for all planes at once, columns xr at or beyond ``rw`` out of the
    image."""
    h, w, _ = left.shape
    dev = left.device
    d_abs = torch.arange(d0, d0 + d_count, device=dev) + opts.min_disparity
    xr = torch.arange(w, device=dev)[None, :] - d_abs[:, None]  # (D, W)
    oob = (xr < 0) | (xr >= rw)
    xc = xr.clamp(0, w - 1)
    r_shift = right[:, xc].permute(1, 0, 2, 3).to(torch.int32)  # (D,H,W,3)
    ad = (left.to(torch.int32)[None] - r_shift).abs().sum(
        dim=-1, dtype=torch.int32
    ).to(torch.float32) / 3.0
    cen = hamming63(census_l[None], census_r[:, xc].permute(1, 0, 2)).to(
        torch.float32
    )
    cost = (ad_term(ad, float(opts.lambda_ad))
            - census_term(cen, float(opts.lambda_census)))
    # the kernels take a contiguous (D, H, W) volume; the epipolar gather
    # above may leave another memory layout
    return torch.where(oob[:, None, :], 1.0, cost).contiguous()
