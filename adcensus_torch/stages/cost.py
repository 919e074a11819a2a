"""Stage 1: AD + Census cost initialization.

Port of ``adcensus_tpu/stages/cost.py`` (reference: cost_computor.cpp:58-137,
adcensus_util.cpp:10-53). The 63-bit census signature is packed into one
int64 per pixel (bit 63 stays 0, so the value is never negative); the
Hamming distance is a SWAR popcount on int64.
"""
from __future__ import annotations

import numpy as np
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops.basic import f32, shift2d

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


def census_transform_9x7(gray: torch.Tensor) -> torch.Tensor:
    """63-bit census signature per pixel, (H, W) int64.

    Border pixels (rows < 4 or >= h-4, cols < 3 or >= w-3) are zero, and so
    is every pixel of an image no wider than 9 or taller than 7, as in the
    reference (adcensus_util.cpp:17-18 loop bounds)."""
    h, w = gray.shape
    sig = torch.zeros((h, w), dtype=torch.int64, device=gray.device)
    for k, (r, c) in enumerate(_CENSUS_OFFSETS):
        # out[y, x] reads gray[y + r, x + c]
        neigh = shift2d(gray, -r, -c, 0)
        sig |= (neigh < gray).to(torch.int64) << (62 - k)
    if not (w > 9 and h > 7):
        return torch.zeros_like(sig)
    out = torch.zeros_like(sig)
    out[4 : h - 4, 3 : w - 3] = sig[4 : h - 4, 3 : w - 3]
    return out


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
    h, w, _ = left.shape
    dev = left.device
    d_abs = torch.arange(opts.disp_range, device=dev) + opts.min_disparity
    xr = torch.arange(w, device=dev)[None, :] - d_abs[:, None]  # (D, W)
    oob = (xr < 0) | (xr >= w)
    xc = xr.clamp(0, w - 1)
    r_shift = right[:, xc].permute(1, 0, 2, 3).to(torch.int32)  # (D,H,W,3)
    ad = (left.to(torch.int32)[None] - r_shift).abs().sum(
        dim=-1, dtype=torch.int32
    ).to(torch.float32) / 3.0
    cen = hamming63(census_l[None], census_r[:, xc].permute(1, 0, 2)).to(
        torch.float32
    )
    lam_ad = float(opts.lambda_ad)
    lam_cen = float(opts.lambda_census)
    cost = 1.0 - torch.exp(-ad / lam_ad) + 1.0 - torch.exp(-cen / lam_cen)
    # the kernels take a contiguous (D, H, W) volume; the epipolar gather
    # above may leave another memory layout
    return torch.where(oob[:, None, :], 1.0, cost).contiguous()
