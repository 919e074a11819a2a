"""Kernel B3: region-voting histogram statistics.

Port of ``adcensus_tpu/ops/region_vote_pallas.py``. For each target pixel,
the (argmax d, max height, total count) of the disparity histogram over its
horizontal-first cross support region (multistep_refiner.cpp:183-197);
(0, 0, 0) elsewhere. ``region_vote_stats`` launches ``csrc/region_vote.cu``
for a CUDA tensor, with the launch geometry of ``region_vote_geometry``,
and runs ``region_vote_stats_plain`` (the one-hot branch of the JAX
``region_vote_stats``, masked by the target) for a CPU tensor. Ties go to
the lowest d. With ``cross_backend="matmul"`` it computes the same
statistics at every pixel by band matrices (``ops/cross_matmul.py``) on
either device instead.

``region_vote_fill`` runs a whole voting phase of the roll backend: the
map's voting indices (``vote_indices``), the statistics at the phase's
targets and the fill (``vote_fill``), on CUDA as one launch of B3 in its
fill mode, on the CPU as those three plain steps.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import check_cross_options, kernels_for, lround
from adcensus_torch.ops.cross_matmul import region_vote_stats_matmul
from adcensus_torch.ops.cross_sum import cross_pass_plain

SMEM_LIMIT = 232_448 - 16  # an H100 block's shared memory, less the
                           # kernel's static list length
# A block's run of pixels and its warps, one target at a time each.
# Measured fastest on the H100 at the Cone size's voting phases (PERF.md).
GEOMETRY = (256, 16)


def region_vote_smem(pixels: int, warps: int, d: int) -> int:
    """Dynamic shared bytes of kernel B3 at a geometry: the block's target
    list and one histogram of ``d`` int32 counts a warp. The same formula
    is in csrc/region_vote.cu."""
    return 4 * (pixels + warps * d)


@functools.lru_cache(maxsize=None)
def region_vote_geometry(d_range: int, h: int, w: int):
    """Launch geometry of kernel B3 for an (H, W) map and ``d_range``
    bins: (pixels a block, warps a block, dynamic shared bytes).

    GEOMETRY, with the warps halved while their histograms exceed
    SMEM_LIMIT. Raises ValueError for what no geometry fits: an empty map
    or no bins, H * W of 2^31 or more, or a ``d_range`` whose histogram
    does not fit even one warp."""
    if d_range < 1 or h < 1 or w < 1:
        raise ValueError(f"region_vote needs D, H, W >= 1, got {d_range}, "
                         f"{h}, {w}")
    if h * w >= 2 ** 31:
        raise ValueError(f"region_vote indexes the map in 32 bits: H*W = "
                         f"{h * w} is too large")
    pixels, warps = GEOMETRY
    while warps > 1 and region_vote_smem(pixels, warps, d_range) > SMEM_LIMIT:
        warps //= 2
    smem = region_vote_smem(pixels, warps, d_range)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a region_vote histogram of {d_range} counts does "
                         f"not fit {SMEM_LIMIT} bytes of shared memory")
    return pixels, warps, smem


def region_vote_stats_plain(
    di: torch.Tensor,
    valid: torch.Tensor,
    arms: torch.Tensor,
    d_range: int,
    max_arm: int,
    target: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel B3: a (D, H, W) one-hot volume through the
    plain horizontal-first cross sum, then argmax / max / sum over D, set
    to 0 where ``target`` is False."""
    planes = torch.arange(d_range, device=di.device)[:, None, None]
    onehot = ((di[None] == planes) & valid[None]).to(torch.float32)
    hist = cross_pass_plain(
        onehot,
        arms,
        torch.ones(di.shape, device=di.device),
        horizontal_first=True,
        max_arm=max_arm,
        normalize=False,
    ).to(torch.int32)
    stats = (
        hist.argmax(dim=0).to(torch.int32),
        hist.amax(dim=0),
        hist.sum(dim=0, dtype=torch.int32),
    )
    if target is None:
        return stats
    zero = torch.zeros((), dtype=torch.int32, device=di.device)
    return tuple(torch.where(target, s, zero) for s in stats)


def region_vote_stats(
    di: torch.Tensor,
    valid: torch.Tensor,
    arms: torch.Tensor,
    d_range: int,
    max_arm: int,
    cross_backend: str = "roll",
    masks=None,
    target: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_index, max_ht, count), each (H, W) int32.

    di: (H, W) int32 rounded disparity indices in [0, d_range); valid:
    (H, W) bool; arms: (H, W, 4) int32; target: (H, W) bool, or None for
    every pixel. At a target pixel all backends give the same statistics
    bit for bit; the roll backend gives (0, 0, 0) elsewhere, the matmul
    backend, which ignores ``target``, the statistics of every pixel.
    ``masks`` are prebuilt band matrices (``cross_matmul.vote_band_masks``)
    for the matmul backend.
    """
    check_cross_options(cross_backend)
    h, w = di.shape
    checks = [
        ("di", di, torch.int32, (h, w)),
        ("valid", valid, torch.bool, (h, w)),
        ("arms", arms, torch.int32, (h, w, 4)),
    ]
    if target is not None:
        checks.append(("target", target, torch.bool, (h, w)))
    for name, t, dtype, shape in checks:
        _build.check(name, t, dtype, shape, di.device)
    if cross_backend == "matmul":
        return region_vote_stats_matmul(di, valid, arms, d_range, max_arm,
                                        masks=masks)
    if not kernels_for(di):
        return region_vote_stats_plain(di, valid, arms, d_range, max_arm,
                                       target)
    geometry = region_vote_geometry(int(d_range), h, w)
    return launch_pass(di, valid, arms, d_range, max_arm, target, geometry)


def launch_pass(di, valid, arms, d_range, max_arm, target, geometry):
    """Launch kernel B3 on checked CUDA tensors with ``geometry`` =
    (pixels a block, warps a block, shared bytes); ``region_vote_stats``
    gives it ``region_vote_geometry``'s, the card tests others."""
    h, w = di.shape
    out = torch.empty((3, h, w), dtype=torch.int32, device=di.device)
    _build.launch(
        "region_vote",
        di.data_ptr(), valid.data_ptr(), arms.data_ptr(),
        None if target is None else target.data_ptr(), out.data_ptr(),
        int(d_range), h, w, int(max_arm), *geometry,
        torch.cuda.current_stream(di.device).cuda_stream,
    )
    return out[0], out[1], out[2]


def vote_indices(
    disp: torch.Tensor, min_d: int, d_range: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rounded 0-based disparity indices, validity mask) of a map for
    voting (multistep_refiner.cpp:187-197 uses rounded disparities)."""
    valid = torch.isfinite(disp)
    di = (
        lround(torch.where(valid, disp, 0.0)) - min_d
    ).clamp(0, d_range - 1).to(torch.int32)
    return di, valid


def vote_fill(
    disp: torch.Tensor,
    target: torch.Tensor,
    best: torch.Tensor,
    max_ht: torch.Tensor,
    count: torch.Tensor,
    min_d: int,
    ts: int,
    th: float,
) -> torch.Tensor:
    """Fill the ``target`` pixels whose region histogram passes the ts/th
    thresholds (multistep_refiner.cpp:199-214); ``th`` is a float32
    value."""
    ratio_ok = (max_ht.to(torch.float32) / count.to(torch.float32)) > th
    fill = target & (max_ht > 0) & (count > ts) & ratio_ok
    return torch.where(fill, (best + min_d).to(torch.float32), disp)


def region_vote_fill(
    disp: torch.Tensor,
    arms: torch.Tensor,
    phase: torch.Tensor,
    d_range: int,
    max_arm: int,
    min_d: int,
    ts: int,
    th: float,
) -> torch.Tensor:
    """One voting phase of the roll backend: the (H, W) float32 map with
    each target filled where its histogram passes ``ts``/``th``. The
    targets are the pixels of the (H, W) bool ``phase`` mask whose
    disparity is not finite; every other pixel keeps its value. ``th`` is
    a float32 value. On CUDA one launch of kernel B3 in its fill mode
    (into a new map: every target reads the map the phase starts from),
    bitwise the plain steps it replaces on the CPU."""
    h, w = disp.shape
    for name, t, dtype, shape in (
        ("disp", disp, torch.float32, (h, w)),
        ("arms", arms, torch.int32, (h, w, 4)),
        ("phase", phase, torch.bool, (h, w)),
    ):
        _build.check(name, t, dtype, shape, disp.device)
    if not kernels_for(disp):
        target = phase & ~torch.isfinite(disp)
        di, valid = vote_indices(disp, min_d, d_range)
        stats = region_vote_stats_plain(di, valid, arms, d_range, max_arm,
                                        target)
        return vote_fill(disp, target, *stats, min_d, ts, th)
    pixels, warps, smem = region_vote_geometry(int(d_range), h, w)
    out = torch.empty_like(disp)
    _build.launch(
        "region_vote_fill",
        disp.data_ptr(), arms.data_ptr(), phase.data_ptr(), out.data_ptr(),
        int(d_range), h, w, int(max_arm), int(min_d), int(ts), float(th),
        pixels, warps, smem,
        torch.cuda.current_stream(disp.device).cuda_stream,
    )
    return out
