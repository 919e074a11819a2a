"""Kernel B1: one cross-aggregation iteration (variable-arm window sums).

Port of ``adcensus_tpu/ops/cross_sum_pallas.py``. ``cross_pass`` launches
``csrc/cross_sum.cu`` for a CUDA tensor, once per iteration with the
launch geometry of ``cross_sum_geometry``, and runs ``cross_pass_plain``
(the port of ``cross_pass_ref``) for a CPU tensor. Both add the terms of
each arm in ascending offset from 0.0 (cross_aggregator.cpp:362-383), so
they agree bitwise.
"""
from __future__ import annotations

import functools

import torch

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for

SMEM_LIMIT = 232_448 - 256    # an H100 block's shared memory, less the
                              # kernel's static reduction buffer
PLANE_CHOICES = (8, 4, 2, 1)  # the kernel's template instances
# By horizontal_first: the output tile (x side, y side), the d-planes a
# block sums together (at most) and its threads. The halo lies along y
# when horizontal-first and along x otherwise, so the tile is long on
# that axis. Measured fastest on the H100 at 64x375x450 (PERF.md).
GEOMETRY = {True: (32, 32, 8, 512), False: (64, 8, 8, 256)}


def plane_capacity(h: int, w: int, max_arm: int, horizontal_first: bool,
                   tile_x: int, tile_y: int) -> int:
    """Cells of one plane of kernel B1's first-pass buffer: the output
    tile widened by halos of up to ``max_arm`` along the second axis (y
    when horizontal-first), never beyond the image's extent on it. The
    same formula is in csrc/cross_sum.cu."""
    m = max(max_arm, 0)
    if horizontal_first:
        return tile_x * min(tile_y + 2 * m, h)
    return tile_y * min(tile_x + 2 * m, w)


@functools.lru_cache(maxsize=None)
def cross_sum_geometry(d: int, h: int, w: int, max_arm: int,
                       horizontal_first: bool):
    """Launch geometry of kernel B1 for a (D, H, W) volume: (tile_x,
    tile_y, planes a block sums together, threads, dynamic shared bytes).

    GEOMETRY[horizontal_first], with the tile cut to the image and the
    planes to D; the planes halve while the first-pass buffer exceeds
    SMEM_LIMIT, then the tile's first-axis side. Raises ValueError for
    what no geometry fits: an empty volume, H * W of 2^31 or more, or an
    arm cap whose halos do not fit a one-pixel tile."""
    if d < 1 or h < 1 or w < 1:
        raise ValueError(f"cross_sum needs D, H, W >= 1, got {d}, {h}, {w}")
    if h * w >= 2 ** 31:
        raise ValueError(f"cross_sum indexes a plane in 32 bits: H*W = "
                         f"{h * w} is too large")
    tile_x, tile_y, planes, threads = GEOMETRY[horizontal_first]
    tile_x, tile_y = min(tile_x, w), min(tile_y, h)
    planes = next(p for p in PLANE_CHOICES if p <= min(planes, d))

    def smem():
        return 4 * planes * plane_capacity(h, w, max_arm, horizontal_first,
                                           tile_x, tile_y)

    while smem() > SMEM_LIMIT:
        if planes > 1:
            planes //= 2
        elif horizontal_first and tile_x > 1:
            tile_x //= 2
        elif not horizontal_first and tile_y > 1:
            tile_y //= 2
        else:
            raise ValueError(f"no cross_sum geometry fits max_arm={max_arm} "
                             f"in {SMEM_LIMIT} bytes of shared memory")
    if -(-d // planes) > 65535:
        raise ValueError(f"cross_sum takes at most {65535 * planes} planes")
    return tile_x, tile_y, planes, threads, smem()


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
    geometry = cross_sum_geometry(d, h, w, int(max_arm),
                                  bool(horizontal_first))
    return launch_pass(vol, arms, sup, horizontal_first, max_arm, normalize,
                       geometry)


def launch_pass(vol, arms, sup, horizontal_first, max_arm, normalize,
                geometry):
    """Launch kernel B1 on checked CUDA tensors with ``geometry`` =
    (tile_x, tile_y, planes, threads, shared bytes);
    ``cross_pass`` gives it ``cross_sum_geometry``'s, the card tests
    others."""
    d, h, w = vol.shape
    out = torch.empty_like(vol)
    _build.launch(
        "cross_sum",
        vol.data_ptr(), arms.data_ptr(), sup.data_ptr(), out.data_ptr(),
        d, h, w, int(max_arm), int(horizontal_first), int(normalize),
        *geometry, torch.cuda.current_stream(vol.device).cuda_stream,
    )
    return out

