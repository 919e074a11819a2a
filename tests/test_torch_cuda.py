"""The CUDA kernels of adcensus_torch against their plain PyTorch
versions on the card, bitwise, at shapes and options the main path of
chip_smoke.py does not reach: arms beyond 127, D from 1 to 1024, padded
scan steps and B2's partial chunks and blocks at several launch
geometries, rays longer than the image, a negative min_disparity, B5's
window margins of 64 to 256, D padded to 8 and masks that are not
intervals (tests/_band_cases.py); and the whole match on
each backend against its plain-version pipeline. B1's cases cover its
tiles: partial and one-pixel tiles, data-dependent halos that change
from tile to tile, launch geometries other than the default. B3's cover a
voting phase's targets: empty, sparse, clustered and full, partial runs
of pixels, other launch geometries, and the voting stage under sync debug
mode "error". B4's cover the CPU emulation's grid of targets, searches
and map shapes, in-image NaN, other ray counts and launch geometries, the
Cone-size pair's own phases, and the interpolation stage under sync debug
mode "error". M1's (the in-place median) and M2's (discontinuity
adjustment) cover one-pixel-wide and -high maps, the Cone, Wood2 and
1100x64 sizes (more rows than a block has threads), M1 at its design's
boundaries (heights of 32k +- 1, two and three bands of rows, widths
below a refill's chunk, bands wider than the block's lead, rows all
+inf, the height limit), M2 at its design's boundaries (widths of 32k
+- 1, runs of edge pixels across chunks whose value propagates or
changes at every pixel), maps all +inf,
disparities whose cost index falls outside [0, D), the Cone-size pair's
own refinement maps, both stages under sync debug mode "error", the match
with both flags and a batched graph with both flags. The sharded layer
at world size 1 on NCCL: both layouts, the flags and the matmul backend
bitwise match_device with its launches, the batched call, no host sync;
and B1 and B3 on a rank's haloed row slab. C1's (census) cover random
grays at the Cone and KITTI sizes, images 9 wide and 7 tall, one pixel,
and the sharded layer's row slabs; C2's (the cost volume) both
configurations, a negative min_disparity, the sharded layer's disp blocks
and padded slabs, odd widths and D beyond W; and match_core's cost_init
and disparity with both against the plain cost stage, eager and in a
batched graph.

Needs a CUDA card and nvcc; skips without a card. This file imports no
JAX, so on the GPU host it runs without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""
from unittest import mock

import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import (
    _build, band_mm, cross_sum, dda, interp, median, region_vote, scanline,
)
from adcensus_torch.stages import aggregate, arms, pipeline, refine
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.stages import scanline as scan_stage
from adcensus_torch.synthetic import two_layer_pair
from chip_smoke import plain_versions
from _band_cases import CASES as BAND_MASK_CASES
from _band_cases import case_inputs as band_case_inputs
from _ray_cases import CASES as RAY_CASES
from _ray_cases import case_inputs as ray_case_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_bitwise(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), f"differ at {int((a != b).sum())} cells"


def _smooth_image(h, w, seed):
    """Near-constant RGB (+-2 per channel): arms run to the cap or the
    border."""
    rng = np.random.default_rng(seed)
    return (100 + rng.integers(-2, 3, size=(h, w, 3))).astype(np.uint8)


def _long_arms(dev, h=40, w=300, cap=200):
    opts = ADCensusOptions(cross_L1=cap, cross_L2=cap // 2)
    a = arms.build_arms(torch.as_tensor(_smooth_image(h, w, 0), device=dev),
                        opts)
    assert int(a[..., :2].max()) > 127
    return a


@pytest.mark.parametrize("horizontal_first", [True, False])
def test_cross_sum_long_arms(dev, horizontal_first):
    cap = 200
    a = _long_arms(dev, cap=cap)
    rng = np.random.default_rng(1)
    vol = torch.as_tensor(rng.random((6,) + a.shape[:2], np.float32),
                          device=dev)
    sup_h, sup_v = aggregate.support_counts(a, cap)
    sup = (sup_h if horizontal_first else sup_v).float()
    args = (vol, a, sup, horizontal_first, cap)
    _assert_bitwise(cross_sum.cross_pass(*args),
                    cross_sum.cross_pass_plain(*args))


def _cross_inputs(dev, d, h, w, max_arm, kind, horizontal_first):
    """Seeded volume in [-1, 1), arms up to ``max_arm`` clipped to the
    border (random, or max_arm and 1 on alternate 32x64 squares, so that
    neighbouring tiles need different halos), and the matching sup."""
    rng = np.random.default_rng(d * 7 + h + w + max_arm)
    vol = torch.as_tensor(rng.random((d, h, w), np.float32) * 2 - 1,
                          device=dev)
    a = _random_arms(rng, h, w, max_arm)
    if kind == "squares":
        yy, xx = np.mgrid[:h, :w]
        big = (yy // 32 + xx // 64) % 2 == 1
        border = (xx, w - 1 - xx, yy, h - 1 - yy)
        a = np.stack([np.minimum(np.where(big, max_arm, 1), border[k])
                      for k in range(4)], axis=-1).astype(np.int32)
    a = torch.as_tensor(a, device=dev)
    sup_h, sup_v = aggregate.support_counts(a, max_arm)
    return vol, a, (sup_h if horizontal_first else sup_v).float()


# (D, H, W, max_arm, arms, normalize): partial tiles on both axes (the
# tiles are 32x32 horizontal-first and 64x16 vertical-first), images
# smaller than a tile, D of 1, 3 and 256, arm caps of 0, 34 and above the
# tile sides, halos that change sharply from tile to tile, no division
CROSS_CASES = {
    "partial_tiles": (5, 37, 70, 10, "random", True),
    "smaller_than_tile": (3, 5, 7, 4, "random", True),
    "h1": (3, 1, 50, 6, "random", True),
    "w1": (3, 50, 1, 6, "random", True),
    "one_pixel": (2, 1, 1, 3, "random", True),
    "d1": (1, 40, 70, 10, "random", True),
    "d3": (3, 40, 70, 10, "random", True),
    "d256": (256, 30, 50, 10, "random", True),
    "arm0": (4, 40, 70, 0, "random", True),
    "arm34": (4, 60, 100, 34, "random", True),
    "arm_over_tile": (4, 100, 170, 100, "random", True),
    "sharp_halos": (6, 96, 200, 30, "squares", True),
    "unnormalized": (5, 37, 70, 10, "random", False),
}


@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_cross_sum_cases(dev, case, horizontal_first):
    d, h, w, max_arm, kind, normalize = CROSS_CASES[case]
    vol, a, sup = _cross_inputs(dev, d, h, w, max_arm, kind,
                                horizontal_first)
    args = (vol, a, sup, horizontal_first, max_arm, normalize)
    _build.reset_launches()
    out = cross_sum.cross_pass(*args)
    assert _build.launches["cross_sum"] == 1
    _assert_bitwise(out, cross_sum.cross_pass_plain(*args))


@pytest.mark.parametrize("tile_x,tile_y,planes,threads", [
    (8, 8, 1, 32), (16, 4, 2, 64), (5, 3, 8, 96), (200, 1, 4, 512),
    (7, 9, 1, 128),
])
@pytest.mark.parametrize("horizontal_first", [True, False])
def test_cross_sum_other_geometries(dev, tile_x, tile_y, planes, threads,
                                    horizontal_first):
    """B1 at launch geometries cross_sum_geometry does not pick: odd and
    one-row tiles, 1 to 8 planes a block (D=5 leaves a partial plane
    group), 32 to 512 threads, halos longer than the tile."""
    d, h, w, max_arm = 5, 45, 75, 12
    vol, a, sup = _cross_inputs(dev, d, h, w, max_arm, "squares",
                                horizontal_first)
    smem = 4 * planes * cross_sum.plane_capacity(
        h, w, max_arm, horizontal_first, tile_x, tile_y)
    args = (vol, a, sup, horizontal_first, max_arm, True)
    geometry = (tile_x, tile_y, planes, threads, smem)
    _assert_bitwise(cross_sum.launch_pass(*args, geometry),
                    cross_sum.cross_pass_plain(*args))


def test_cross_sum_refuses_short_shared_memory(dev):
    vol, a, sup = _cross_inputs(dev, 2, 20, 30, 5, "random", True)
    smem = 4 * cross_sum.plane_capacity(20, 30, 5, True, 8, 8)
    with pytest.raises(RuntimeError, match="cross_sum"):
        cross_sum.launch_pass(vol, a, sup, True, 5, True,
                              (8, 8, 1, 64, smem - 4))


# (D, H, W, padding): D from 1 to 1024 (lane runs of 1 to 32); S of 1,
# 7 and 33 against K (x: S = W, y: S = H); P of 1 and 5, and 375 and 450
# paths in blocks of 4 with a partial last block; PAD runs that cross the
# chunk boundary at step 32 and a SEED at step 33.
SCAN_CASES = {
    "d1": (1, 24, 40, "edges"), "d5": (5, 24, 40, "edges"),
    "d31": (31, 24, 40, "edges"), "d33": (33, 24, 40, "edges"),
    "d64": (64, 24, 40, "edges"), "d256": (256, 24, 40, "edges"),
    "d1024": (1024, 9, 12, "edges"),
    "s1p1": (64, 1, 1, "none"), "s7p5": (64, 5, 7, "none"),
    "s33p1": (64, 1, 33, "none"), "s33p5": (64, 33, 5, "none"),
    "p375": (8, 375, 10, "edges"), "p450": (8, 10, 450, "edges"),
    "pad_across_chunk": (16, 70, 70, "middle"),
    "late_seed": (16, 70, 70, "late"),
}
PADDING = {"none": (), "edges": ((0, 3), (-2, None)),
           "middle": ((0, 3), (30, 36)), "late": ((0, 33),)}


SCAN_TSO = 15


def _scan_inputs(dev, case, axis, negative):
    """Seeded cost and (d1, rd) distance maps about half of whose pixels
    reach SCAN_TSO, and the case's flags."""
    d, h, w, padding = SCAN_CASES[case]
    rng = np.random.default_rng(d + h + w)
    cost = rng.random((d, h, w), np.float32) * 2 - (1.0 if negative else 0.0)
    d1, rd = (rng.integers(0, 2 * SCAN_TSO, (h, w), np.int32)
              for _ in range(2))
    s_len = w if axis == "x" else h
    valid = torch.ones(s_len, dtype=torch.bool, device=dev)
    for lo, hi in PADDING[padding]:
        valid[lo:hi] = False
    return (torch.as_tensor(cost, device=dev), torch.as_tensor(d1, device=dev),
            torch.as_tensor(rd, device=dev),
            scan_stage._scan_flags(s_len, valid))


def _scan_plain(cost, d1, rd, flags, axis, reverse):
    """Plain B2 on the code volume of (d1, rd)."""
    code = scanline.penalty_codes(d1, rd, cost.shape[0], SCAN_TSO)
    return scanline.scanline_pass_plain(cost, code, flags, 1.0, 3.0, axis,
                                        reverse)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
@pytest.mark.parametrize("axis,forward",
                         [("x", True), ("x", False), ("y", True), ("y", False)])
def test_scanline_padded_steps(dev, case, axis, forward, negative):
    cost, d1, rd, flags = _scan_inputs(dev, case, axis, negative)
    _build.reset_launches()
    out = scanline.scanline_pass(cost, d1, rd, flags, SCAN_TSO, 1.0, 3.0,
                                 axis, not forward)
    assert _build.launches["scanline"] == 1
    _assert_bitwise(out, _scan_plain(cost, d1, rd, flags, axis, not forward))


@pytest.mark.parametrize("pb,k,stages", [(1, 1, 2), (2, 4, 2), (8, 8, 3),
                                         (4, 16, 2)])
@pytest.mark.parametrize("axis,forward",
                         [("x", True), ("x", False), ("y", True), ("y", False)])
def test_scanline_other_geometries(dev, pb, k, stages, axis, forward):
    """B2 at launch geometries scanline_geometry does not pick for these
    shapes: more paths per block than the grid wants, short chunks, two
    ring slots; partial blocks and chunks, negative costs."""
    cost, d1, rd, flags = _scan_inputs(dev, "pad_across_chunk", axis, True)
    d, h, w = cost.shape
    smem = stages * scanline.scanline_layout(d, pb, k, axis)[-1]
    _assert_bitwise(
        scanline.launch_pass(cost, d1 >= SCAN_TSO, rd >= SCAN_TSO, flags,
                             1.0, 3.0, axis, not forward, 0, 0, w,
                             (pb, k, stages, smem)),
        _scan_plain(cost, d1, rd, flags, axis, not forward))


@pytest.mark.parametrize("cost_shift,flag_shift", [(1, 3), (2, 1), (3, 2)])
@pytest.mark.parametrize("axis,forward",
                         [("x", True), ("x", False), ("y", True), ("y", False)])
def test_scanline_misaligned_inputs(dev, cost_shift, flag_shift, axis,
                                    forward):
    """B2 on contiguous views that start 4 to 12 bytes (cost) and 1 to 3
    bytes (flag maps) past a 16-byte boundary: cost rows move in 4-byte
    grains and flag windows follow the maps' own alignment."""
    cost, d1, rd, flags = _scan_inputs(dev, "pad_across_chunk", axis, True)
    d, h, w = cost.shape
    n = cost.numel()
    cost_v = torch.empty(n + cost_shift, device=dev)[cost_shift:]
    cost_v = cost_v.view(cost.shape).copy_(cost)
    maps = []
    for m in (d1, rd):
        v = torch.empty(m.numel() + flag_shift, dtype=torch.bool,
                        device=dev)[flag_shift:]
        maps.append(v.view(m.shape).copy_(m >= SCAN_TSO))
    geometry = scanline.scanline_geometry(d, w if axis == "x" else h,
                                          h if axis == "x" else w, axis)
    _assert_bitwise(
        scanline.launch_pass(cost_v, *maps, flags, 1.0, 3.0, axis,
                             not forward, 0, 0, w, geometry),
        _scan_plain(cost, d1, rd, flags, axis, not forward))


@pytest.mark.parametrize("d", [3, 64, 256])
def test_region_vote_wide_and_long(dev, d):
    """Every pixel a target (target=None), arms beyond 127."""
    a = _long_arms(dev, h=30, w=160, cap=150)
    rng = np.random.default_rng(d)
    di = torch.as_tensor(rng.integers(0, d, a.shape[:2], np.int32),
                         device=dev)
    valid = torch.as_tensor(rng.random(a.shape[:2]) < 0.7, device=dev)
    args = (di, valid, a, d, 150)
    for k, p in zip(region_vote.region_vote_stats(*args),
                    region_vote.region_vote_stats_plain(*args)):
        _assert_bitwise(k, p)


def _vote_inputs(dev, d, h, w, max_arm, target_kind, seed):
    """Seeded di in [0, d), 70 % valid, arms up to ``max_arm`` (those of a
    near-constant image for caps beyond 127, else random) and a target:
    "empty", a density such as "0.1%", "all", or a filled rectangle."""
    rng = np.random.default_rng(seed)
    if max_arm > 127:
        a = _long_arms(dev, h, w, cap=max_arm)
    else:
        a = torch.as_tensor(_random_arms(rng, h, w, max_arm), device=dev)
    di = torch.as_tensor(rng.integers(0, d, (h, w), np.int32), device=dev)
    valid = torch.as_tensor(rng.random((h, w)) < 0.7, device=dev)
    if target_kind == "rectangle":
        target = np.zeros((h, w), bool)
        target[h // 4:3 * h // 4 + 1, w // 3:2 * w // 3 + 1] = True
    else:
        density = {"empty": 0.0, "all": 1.0}.get(target_kind)
        if density is None:
            density = float(target_kind.rstrip("%")) / 100
        target = rng.random((h, w)) < density
    return di, valid, a, torch.as_tensor(target, device=dev)


@pytest.mark.parametrize("max_arm", [0, 34, 200])
@pytest.mark.parametrize("d", [1, 3, 64, 256])
@pytest.mark.parametrize("target_kind",
                         ["empty", "0.1%", "5%", "all", "rectangle"])
def test_region_vote_targets(dev, target_kind, d, max_arm):
    """B3 at a phase's targets: statistics there, zeros elsewhere, on
    maps that end in a partial run of pixels (37x70 and 40x300)."""
    h, w = (40, 300) if max_arm > 127 else (37, 70)
    di, valid, a, target = _vote_inputs(dev, d, h, w, max_arm, target_kind,
                                        seed=d + max_arm)
    args = (di, valid, a, d, max_arm)
    _build.reset_launches()
    out = region_vote.region_vote_stats(*args, target=target)
    assert _build.launches["region_vote"] == 1
    for k, p in zip(out, region_vote.region_vote_stats_plain(*args,
                                                              target=target)):
        _assert_bitwise(k, p)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 50), (50, 1), (5, 7), (17, 259)])
def test_region_vote_odd_shapes(dev, h, w):
    di, valid, a, target = _vote_inputs(dev, 64, h, w, 10, "5%", seed=h + w)
    target[0, 0] = True
    args = (di, valid, a, 64, 10)
    for k, p in zip(region_vote.region_vote_stats(*args, target=target),
                    region_vote.region_vote_stats_plain(*args,
                                                        target=target)):
        _assert_bitwise(k, p)


@pytest.mark.parametrize("pixels,warps", [(32, 1), (100, 3), (64, 2),
                                          (300, 7), (1024, 32)])
@pytest.mark.parametrize("target_kind", ["5%", "rectangle", "all"])
def test_region_vote_other_geometries(dev, pixels, warps, target_kind):
    """B3 at launch geometries region_vote_geometry does not pick: runs of
    pixels that are not a multiple of 32, more warps than a run's steps,
    one warp for many targets."""
    d, max_arm = 40, 34
    di, valid, a, target = _vote_inputs(dev, d, 45, 75, max_arm,
                                        target_kind, seed=pixels)
    args = (di, valid, a, d, max_arm)
    geometry = (pixels, warps, region_vote.region_vote_smem(pixels, warps, d))
    for k, p in zip(region_vote.launch_pass(*args, target, geometry),
                    region_vote.region_vote_stats_plain(*args,
                                                        target=target)):
        _assert_bitwise(k, p)


def test_region_vote_refuses_what_does_not_fit(dev):
    """No fallback: a histogram too long for one warp's shared memory
    raises in the wrapper, and a geometry short of shared memory is
    refused by the kernel's entry point."""
    di, valid, a, target = _vote_inputs(dev, 8, 20, 30, 5, "5%", seed=0)
    with pytest.raises(ValueError, match="region_vote"):
        region_vote.region_vote_stats(di, valid, a, 60_000, 5, target=target)
    smem = region_vote.region_vote_smem(64, 2, 8)
    with pytest.raises(RuntimeError, match="region_vote"):
        region_vote.launch_pass(di, valid, a, 8, 5, target,
                                (64, 2, smem - 4))


def test_region_vote_stage_syncs_no_host(dev):
    """The voting stage on the card makes no device-to-host transfer: it
    runs under sync debug mode "error", launches B3 in all ten phases,
    and equals the plain versions bitwise."""
    left, right, _ = two_layer_pair(60, 200, 4, 9, seed=3)
    opts = ADCensusOptions(max_disparity=16)
    lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
    inter = pipeline.match_core(
        lt, rt, cost_stage.compute_gray(lt), cost_stage.compute_gray(rt),
        opts, return_intermediates=True,
    )
    _, occl, mism = refine.outlier_detection(
        inter["disp_left_raw"], inter["disp_right_raw"], opts)
    args = (inter["after_lr_check"], inter["arms"], occl, mism, opts)
    _build.build(["region_vote"])
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = refine.iterative_region_voting(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launches["region_vote"] == 10
    with plain_versions():
        _assert_bitwise(out, refine.iterative_region_voting(*args))


def _ray_args(dev, case, seed=None, nan_share=0.0):
    """B4's inputs for a case of the CPU emulation's grid, on the card."""
    return tuple(torch.as_tensor(a, device=dev)
                 for a in ray_case_inputs(case, seed, nan_share))


@pytest.mark.parametrize("is_mismatch", [True, False])
@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_ray_interp_sparse_map(dev, case, is_mismatch):
    """B4 on the CPU emulation's grid (tests/_ray_cases.py): target
    densities of 0 to 100 %, a strip, max_search 1 to 256, 1xN and Nx1
    maps, maps without and with only finite cells. No -0.0 / +0.0 tie:
    the plain version's amin does not define which zero it returns."""
    args = _ray_args(dev, case) + (is_mismatch,)
    _build.reset_launches()
    out = interp.ray_interp(*args)
    assert _build.launches["ray_interp"] == 1
    for k, p in zip(out, interp.ray_interp_plain(*args)):
        _assert_bitwise(k, p)


@pytest.mark.parametrize("is_mismatch", [True, False])
def test_ray_interp_nan_and_ray_counts(dev, is_mismatch):
    """An in-image NaN ends a ray; 40 rays (three a lane) and 8 (half the
    lanes idle)."""
    args = _ray_args(dev, "search64", seed=5, nan_share=0.1)
    for k, p in zip(interp.ray_interp(*args, is_mismatch),
                    interp.ray_interp_plain(*args, is_mismatch)):
        _assert_bitwise(k, p)
    disp, left, _, target = _ray_args(dev, "sparse30", seed=2)
    rng = np.random.default_rng(3)
    for n_rays in (40, 8):
        offsets = torch.as_tensor(
            rng.integers(-3, 4, (n_rays, 6, 2)).astype(np.int32), device=dev)
        args = (disp, left, offsets, target, is_mismatch)
        for k, p in zip(interp.ray_interp(*args),
                        interp.ray_interp_plain(*args)):
            _assert_bitwise(k, p)


@pytest.mark.parametrize("pixels,warps,k", [
    (32, 1, 1), (100, 3, 8), (64, 2, 2), (1024, 32, 4), (256, 8, 1),
    (77, 5, 8),
])
@pytest.mark.parametrize("case", ["sparse30", "all", "strip", "search256"])
def test_ray_interp_other_geometries(dev, pixels, warps, k, case):
    """B4 at launch geometries ray_interp_geometry does not pick: runs of
    pixels that are not a multiple of 32, one warp for many targets, 1 to
    8 probes in flight."""
    disp, left, offsets, target = _ray_args(dev, case)
    geometry = (pixels, warps, k, interp.ray_interp_smem(pixels))
    for is_mismatch in (True, False):
        args = (disp, left, offsets, target, is_mismatch)
        for a, b in zip(interp.launch_pass(*args, geometry),
                        interp.ray_interp_plain(*args)):
            _assert_bitwise(a, b)


def test_ray_interp_misaligned_offsets(dev):
    """A contiguous offset table that starts 4 bytes past an 8-byte
    boundary: the wrapper hands the kernel an aligned copy."""
    disp, left, offsets, target = _ray_args(dev, "strip")
    view = torch.empty(offsets.numel() + 1, dtype=torch.int32,
                       device=dev)[1:].view(offsets.shape).copy_(offsets)
    assert view.data_ptr() % 8 == 4
    for is_mismatch in (True, False):
        args = (disp, left, view, target, is_mismatch)
        for k, p in zip(interp.ray_interp(*args),
                        interp.ray_interp_plain(*args)):
            _assert_bitwise(k, p)


def test_ray_interp_refuses_what_does_not_fit(dev):
    """No fallback: a geometry short of its list's shared memory, or with
    a K the kernel does not compile, is refused by the entry point."""
    disp, left, offsets, target = _ray_args(dev, "sparse30")
    args = (disp, left, offsets, target, True)
    for geometry in ((64, 2, 4, 4 * 64 - 4), (64, 2, 3, 4 * 64)):
        with pytest.raises(RuntimeError, match="ray_interp"):
            interp.launch_pass(*args, geometry)


def _cone_refine_inputs(dev, h=375, w=450, max_d=64):
    """The synthetic Cone-size pair's refinement inputs as chip_smoke.py
    makes them: (after_voting, left, occlusion, mismatch, opts)."""
    left, right, _ = two_layer_pair(h, w, 16, 32, seed=0)
    opts = ADCensusOptions(max_disparity=max_d)
    lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
    inter = pipeline.match_core(
        lt, rt, cost_stage.compute_gray(lt), cost_stage.compute_gray(rt),
        opts, return_intermediates=True,
    )
    _, occl, mism = refine.outlier_detection(
        inter["disp_left_raw"], inter["disp_right_raw"], opts)
    return inter["after_voting"], lt, occl, mism, opts


def test_ray_interp_cone_phases(dev):
    """B4 on the Cone-size synthetic pair's own interpolation inputs:
    the mismatch phase, then the occlusion phase on the map it filled."""
    disp, left, occl, mism, opts = _cone_refine_inputs(dev)
    offsets = refine.ray_offsets(opts.max_disparity, disp.device)
    mism_target = mism & ~torch.isfinite(disp)
    found, fill = interp.ray_interp(disp, left, offsets, mism_target, True)
    assert int(mism_target.sum()) > 1000 and bool(found.any())
    for k, p in zip((found, fill), interp.ray_interp_plain(
            disp, left, offsets, mism_target, True)):
        _assert_bitwise(k, p)
    disp = torch.where(mism_target, fill, disp)
    occl_target = occl & ~torch.isfinite(disp)
    args = (disp, left, offsets, occl_target, False)
    for k, p in zip(interp.ray_interp(*args), interp.ray_interp_plain(*args)):
        _assert_bitwise(k, p)


def test_interpolation_stage_syncs_no_host(dev):
    """The interpolation stage on the card makes no host transfer: it
    runs under sync debug mode "error", launches B4 for both phases, and
    equals the plain versions bitwise."""
    args = _cone_refine_inputs(dev, h=60, w=200, max_d=16)
    refine.proper_interpolation(*args)  # builds B4, caches the table
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = refine.proper_interpolation(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launches["ray_interp"] == 2
    with plain_versions():
        _assert_bitwise(out, refine.proper_interpolation(*args))


def test_match_device_equals_plain_pipeline(dev):
    """Kernels and plain versions give the same match on the card, with a
    negative min_disparity and an arm cap beyond 127."""
    left, right, _ = two_layer_pair(60, 200, 4, 9, seed=3)
    opts = ADCensusOptions(min_disparity=-2, max_disparity=14,
                           cross_L1=150, cross_L2=60)
    _build.reset_launches()
    disp = pipeline.match_device(left, right, opts, device=dev)
    launches = dict(_build.launches)
    for name in ("band_mm", "median_inplace", "dda"):
        assert launches.pop(name) == 0, name
    assert all(launches.values()), launches
    with plain_versions():
        _build.reset_launches()
        plain = pipeline.match_device(left, right, opts, device=dev)
        assert not any(_build.launches.values())
    _assert_bitwise(disp, plain)


# Kernels M1 (the in-place median) and M2 (discontinuity adjustment)

FLAG_SHAPES = {"1x50": (1, 50), "50x1": (50, 1), "2x2": (2, 2),
               "1x1": (1, 1), "9x11": (9, 11), "cone": (375, 450),
               "wood2": (555, 653), "1100x64": (1100, 64)}
# M1's design boundaries: heights of 32k +- 1 (a warp boundary inside the
# block or just past it), the first height with two rows a thread (1025),
# widths below a refill's 16-column chunk and its lead, bands of 64 to
# 1024 rows, and bands whose rows are wider than twice the block
# (E = W - 2 * threads + 2 > LAG)
MEDIAN_SHAPES = {
    **FLAG_SHAPES, "31x40": (31, 40), "33x40": (33, 40), "63x17": (63, 17),
    "65x17": (65, 17), "95x9": (95, 9), "97x130": (97, 130),
    "1023x20": (1023, 20), "1025x50": (1025, 50), "1025x3": (1025, 3),
    "3x2000": (3, 2000), "2x5000": (2, 5000), "1x3000": (1, 3000),
    "2049x64": (2049, 64), "1025x2100": (1025, 2100),
    "1500x1": (1500, 1), "3000x2300": (3000, 2300),
}


def _holey_map(dev, h, w, seed, share=0.15):
    """Disparities in [0.5, 60) with ``share`` +inf: no zeros, so no
    -0.0 / +0.0 tie, whose order neither torch.sort nor the kernel's
    network defines."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.5, 60.0, (h, w)).astype(np.float32)
    src[rng.random((h, w)) < share] = np.inf
    return torch.as_tensor(src, device=dev)


@pytest.mark.parametrize("shape", sorted(MEDIAN_SHAPES))
def test_median_inplace_bitwise(dev, shape):
    """M1, one launch, against its plain version."""
    h, w = MEDIAN_SHAPES[shape]
    src = _holey_map(dev, h, w, seed=h + w)
    _build.reset_launches()
    out = median.median_inplace(src)
    assert _build.launches["median_inplace"] == 1
    _assert_bitwise(out, median.median_inplace_plain(src))


@pytest.mark.parametrize("shape", ["2x2", "cone", "1100x64", "33x40",
                                   "1025x50", "1025x2100"])
def test_median_inplace_all_invalid(dev, shape):
    src = torch.full(MEDIAN_SHAPES[shape], float("inf"), device=dev)
    out = median.median_inplace(src)
    _assert_bitwise(out, median.median_inplace_plain(src))
    assert bool(torch.isinf(out).all())


def test_median_inplace_checks_its_input(dev):
    src = _holey_map(dev, 8, 10, seed=0)
    with pytest.raises(TypeError):
        median.median_inplace(src.double())
    with pytest.raises(ValueError):
        median.median_inplace(src.t())


@pytest.mark.parametrize("shape", ["33x40", "1025x50", "1025x2100"])
def test_median_inplace_rows_all_invalid(dev, shape):
    """Every third row all +inf."""
    h, w = MEDIAN_SHAPES[shape]
    src = _holey_map(dev, h, w, seed=h + 3 * w)
    src[::3] = float("inf")
    _assert_bitwise(median.median_inplace(src),
                    median.median_inplace_plain(src))


def test_median_inplace_refuses_past_its_height(dev):
    _build.reset_launches()
    with pytest.raises(ValueError):
        median.median_inplace(torch.zeros((median.MAX_HEIGHT + 1, 1),
                                          device=dev))
    assert _build.launches["median_inplace"] == 0


def _dda_inputs(dev, h, w, min_disparity, seed, d_range=16):
    """A map of disparities from min_disparity - 2 to min_disparity + D +
    3 with halves and 10 % +inf, and a random (D, H, W) cost: the cost is
    indexed by lround(d) without subtracting min_disparity, so indices
    fall outside [0, D) on both sides."""
    rng = np.random.default_rng(seed)
    disp = (rng.integers(min_disparity - 2, min_disparity + d_range + 4,
                         (h, w))
            + rng.choice([0.0, 0.25, 0.5, -0.5], (h, w))).astype(np.float32)
    disp[rng.random((h, w)) < 0.1] = np.inf
    cost = rng.random((d_range, h, w)).astype(np.float32)
    opts = ADCensusOptions(min_disparity=min_disparity,
                           max_disparity=min_disparity + d_range)
    return (torch.as_tensor(disp, device=dev),
            torch.as_tensor(cost, device=dev), opts)


# M2's design boundaries: widths of 32k +- 1 (a chunk's edge column from
# the chunk before or the extra load), a row of one chunk and of three
DDA_SHAPES = {**FLAG_SHAPES, "9x31": (9, 31), "9x32": (9, 32),
              "9x33": (9, 33), "9x65": (9, 65), "40x97": (40, 97)}


@pytest.mark.parametrize("min_disparity", [-4, 3])
@pytest.mark.parametrize("shape", sorted(DDA_SHAPES))
def test_dda_bitwise(dev, shape, min_disparity):
    """M2, one launch with its Sobel mask, against its plain version."""
    h, w = DDA_SHAPES[shape]
    disp, cost, opts = _dda_inputs(dev, h, w, min_disparity, seed=h * w)
    _build.reset_launches()
    out = refine.depth_discontinuity_adjustment(disp, cost, opts)
    assert _build.launches["dda"] == 1
    _assert_bitwise(out, dda.dda_plain(disp, cost))
    if h > 2 and w > 2:
        assert not torch.equal(out, disp)


def _dda_run_case(dev, w, kind):
    """Row 2 an edge along its whole interior (rows 1 and 3 far apart),
    and the outputs expected at its columns 1 to W - 2. Propagating:
    column 0's value is the cheapest everywhere, so it runs to column
    W - 2 across every chunk boundary. Changing: own costs fall rightward,
    so each pixel takes its right neighbour's value. Alternating: even
    columns keep their value and odd ones take it, so every other lane
    starts a round with a gather."""
    h = 5
    x = np.arange(w)
    disp = np.zeros((h, w), np.float32)
    disp[3] = 100.0
    cost = np.full((128, h, w), 0.9, np.float32)
    if kind == "propagating":
        disp[2] = np.where(x % 2, 4.0, 5.0)
        disp[2, 0] = 2.0
        cost[2, 2] = 0.25
        expect = np.full(w - 2, 2.0, np.float32)
    else:
        disp[2] = x % 100 + 1
        for c in x:
            own = (0.7 if c % 2 else 0.5) if kind == "alternating" else (
                0.5 - 0.001 * c)
            cost[int(disp[2, c]), 2, c] = np.float32(own)
            if c and kind == "changing":
                cost[int(disp[2, c]), 2, c - 1] = np.float32(0.8)
        inner = x[1:-1]
        expect = disp[2, inner + 1] if kind == "changing" else disp[
            2, inner - inner % 2]
    return (torch.as_tensor(disp, device=dev),
            torch.as_tensor(cost, device=dev),
            torch.as_tensor(expect, device=dev))


@pytest.mark.parametrize("w", [70, 100, 1000])
@pytest.mark.parametrize("kind", ["propagating", "changing", "alternating"])
def test_dda_long_runs(dev, w, kind):
    """A run across many chunks whose value propagates, one whose value
    changes at every pixel, and the rounds' worst case."""
    disp, cost, expect = _dda_run_case(dev, w, kind)
    out = dda.dda(disp, cost)
    _assert_bitwise(out, dda.dda_plain(disp, cost))
    _assert_bitwise(out[2, 1:-1].contiguous(), expect)


def test_flag_stages_on_cone_maps(dev):
    """M2 on the Cone-size pair's interpolated map and cost_scan, M1 on
    what M2 gives, as the [flags] path runs them."""
    left, right, _ = two_layer_pair(375, 450, 16, 32, seed=0)
    opts = ADCensusOptions(max_disparity=64)
    lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
    inter = pipeline.match_core(
        lt, rt, cost_stage.compute_gray(lt), cost_stage.compute_gray(rt),
        opts, return_intermediates=True,
    )
    disp, cost = inter["after_interpolation"], inter["cost_scan"]
    adjusted = refine.depth_discontinuity_adjustment(disp, cost, opts)
    _assert_bitwise(adjusted, dda.dda_plain(disp, cost))
    assert not torch.equal(adjusted, disp)
    _assert_bitwise(median.median_inplace(adjusted),
                    median.median_inplace_plain(adjusted))


def test_flag_stages_sync_no_host(dev):
    """Discontinuity adjustment and the in-place median on the card make
    no host transfer: both run under sync debug mode "error", one launch
    each, equal to the plain versions."""
    disp, cost, opts = _dda_inputs(dev, 60, 200, -2, seed=5)
    refine.median_filter_3x3_inplace(
        refine.depth_discontinuity_adjustment(disp, cost, opts))
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adjusted = refine.depth_discontinuity_adjustment(disp, cost, opts)
        out = refine.median_filter_3x3_inplace(adjusted)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launches["dda"] == _build.launches["median_inplace"] == 1
    with plain_versions():
        _assert_bitwise(adjusted,
                        refine.depth_discontinuity_adjustment(disp, cost,
                                                              opts))
        _assert_bitwise(out, refine.median_filter_3x3_inplace(adjusted))


FLAGS = dict(exact_median=True, do_discontinuity_adjustment=True)


def test_match_device_with_flags_equals_plain_pipeline(dev):
    """The [flags] match: one launch of M1 and M2 besides B1-B4, the same
    disparity as the plain pipeline on the card."""
    left, right, _ = two_layer_pair(60, 200, 4, 9, seed=3)
    opts = ADCensusOptions(min_disparity=-2, max_disparity=14, **FLAGS)
    _build.reset_launches()
    disp = pipeline.match_device(left, right, opts, device=dev)
    launches = dict(_build.launches)
    assert launches["median_inplace"] == launches["dda"] == 1
    assert launches.pop("band_mm") == 0 and all(launches.values())
    with plain_versions():
        _build.reset_launches()
        plain = pipeline.match_device(left, right, opts, device=dev)
        assert not any(_build.launches.values())
    _assert_bitwise(disp, plain)


@pytest.mark.parametrize("group", [4, 2])
def test_batched_graph_with_flags_equals_match_device(dev, group):
    """A batched graph with both flags: each output bitwise match_device,
    M1 and M2 captured once a pair."""
    from adcensus_torch.utils import graphs

    lefts, rights = _stacks(dev, 4)
    opts = ADCensusOptions(max_disparity=16, **FLAGS)
    graphs.clear()
    out = pipeline.match_batched_device(lefts, rights, opts, group=group,
                                        device=dev)
    (entry,) = graphs.cached()
    assert entry.launches["median_inplace"] == entry.launches["dda"] == group
    for i in range(4):
        _assert_bitwise(out[i], pipeline.match_device(lefts[i], rights[i],
                                                      opts, device=dev))
    graphs.clear()


def _random_arms(rng, h, w, max_arm):
    """Random int32 arms up to ``max_arm``, clipped to the border."""
    yy = np.arange(h)[:, None] * np.ones((1, w), int)
    xx = np.arange(w)[None, :] * np.ones((h, 1), int)
    return np.stack([
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), xx),
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), w - 1 - xx),
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), yy),
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), h - 1 - yy),
    ], axis=-1).astype(np.int32)


# (D, H, W, max_arm): the Cone size at the default arm cap (PAD 64); the
# odd shape of tests/test_aggregate.py (PAD 128); PAD 256; D=3 -> Dp=8
BAND_CASES = {
    "cone": (64, 375, 450, 34),
    "odd": (12, 37, 141, 70),
    "pad256": (8, 60, 300, 200),
    "d3": (3, 50, 130, 20),
}


def _band_passes(dev, case):
    """(volume, mask, PAD) of each pass of a case: for BAND_CASES both
    directions, on the padded volume and masks aggregate_banded gives B5;
    for a case of tests/_band_cases.py its one pass (a random mask that is
    not an interval, or an interval mask, on a signed volume with
    +-0.0)."""
    if case in BAND_MASK_CASES:
        vol_m, mask, pad = band_case_inputs(case)
        return [(torch.as_tensor(vol_m, device=dev),
                 torch.as_tensor(mask, device=dev), pad)]
    d, h, w, max_arm = BAND_CASES[case]
    rng = np.random.default_rng(d + h)
    cost = torch.as_tensor(rng.random((d, h, w), np.float32) * 2, device=dev)
    arms_t = torch.as_tensor(_random_arms(rng, h, w, max_arm), device=dev)
    dp, hp, wp = band_mm.padded_dims(d, h, w)
    masks = band_mm.make_blocked_masks(arms_t, max_arm, hp, wp)
    vol = torch.nn.functional.pad(cost, (0, wp - w, 0, hp - h, 0, dp - d))
    return [
        (band_mm.with_margins(vol, wp, masks.pad_w), masks.mh, masks.pad_w),
        (band_mm.with_margins(vol.transpose(1, 2).contiguous(), hp,
                              masks.pad_h), masks.mv, masks.pad_h),
    ]


@pytest.mark.parametrize("case", sorted(BAND_CASES) + sorted(BAND_MASK_CASES))
def test_band_mm_bitwise(dev, case):
    """B5 against band_pass_plain: both directions of aggregate_banded's
    inputs, and random masks of densities 0 to 1 that are not intervals,
    at PAD 64 to 256."""
    for vm, mask, pad in _band_passes(dev, case):
        _build.reset_launches()
        out = band_mm.band_pass(vm, mask, pad)
        assert _build.launches["band_mm"] == 1
        _assert_bitwise(out, band_mm.band_pass_plain(vm, mask, pad))


def test_band_mm_misaligned_inputs(dev):
    """A contiguous volume 4 bytes and a mask 1 byte past a 16-byte
    boundary: the wrapper hands the kernel aligned copies."""
    vm, mask, pad = _band_passes(dev, "density30")[0]
    vm_v = torch.empty(vm.numel() + 1, device=dev)[1:].view(vm.shape)
    mask_v = torch.empty(mask.numel() + 1, dtype=torch.int8,
                         device=dev)[1:].view(mask.shape)
    vm_v.copy_(vm)
    mask_v.copy_(mask)
    assert vm_v.data_ptr() % 16 == 4 and mask_v.data_ptr() % 16 == 1
    _assert_bitwise(band_mm.band_pass(vm_v, mask_v, pad),
                    band_mm.band_pass_plain(vm, mask, pad))


@pytest.mark.parametrize("pad", [320, 8])
def test_band_mm_refuses_what_it_was_not_built_for(dev, pad):
    """No fallback: a window wider than MAX_WK (PAD 320), or a PAD that is
    not a multiple of 16, raises on the card."""
    vol_m = torch.zeros((8, 2, 256 + 2 * pad), device=dev)
    mask = torch.zeros((2, 256 + 2 * pad, 128), dtype=torch.int8,
                       device=dev)
    _build.reset_launches()
    with pytest.raises(ValueError, match="band_pass"):
        band_mm.band_pass(vol_m, mask, pad)
    assert _build.launches["band_mm"] == 0


def test_aggregate_banded_close_to_plain_cross_sum(dev):
    d, h, w, max_arm = 16, 100, 200, 34
    rng = np.random.default_rng(11)
    cost = torch.as_tensor(rng.random((d, h, w), np.float32) * 2, device=dev)
    a = torch.as_tensor(_random_arms(rng, h, w, max_arm), device=dev)
    sup_h, sup_v = (s.float() for s in aggregate.support_counts(a, max_arm))
    _build.reset_launches()
    out = band_mm.aggregate_banded(cost, a, sup_h, sup_v, max_arm)
    assert _build.launches["band_mm"] == 8
    ref = cost
    for it in range(4):
        hf = it % 2 == 0
        ref = cross_sum.cross_pass_plain(ref, a, sup_h if hf else sup_v, hf,
                                         max_arm)
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=0)


@pytest.mark.parametrize("agg_impl", [None, "banded"])
def test_match_device_matmul_equals_plain_pipeline(dev, agg_impl):
    """The matmul backend on the card: the kernels it runs (B5 only when
    banded; never B1 or B3) give the same match as the plain versions."""
    left, right, _ = two_layer_pair(60, 200, 4, 9, seed=3)
    opts = ADCensusOptions(min_disparity=-2, max_disparity=14)
    kwargs = dict(device=dev, cross_backend="matmul", agg_impl=agg_impl)
    _build.reset_launches()
    disp = pipeline.match_device(left, right, opts, **kwargs)
    assert _build.launches["band_mm"] == (8 if agg_impl else 0)
    assert _build.launches["cross_sum"] == _build.launches["region_vote"] == 0
    assert _build.launches["scanline"] == 4
    with plain_versions():
        _build.reset_launches()
        plain = pipeline.match_device(left, right, opts, **kwargs)
        assert not any(_build.launches.values())
    _assert_bitwise(disp, plain)


# The multi-pair pipelines: each group a CUDA graph replay

GRAPH_PATHS = {"roll": ("roll", None), "matmul": ("matmul", None),
               "banded": ("matmul", "banded")}


def _stacks(dev, n, h=60, w=200):
    """``n`` distinct synthetic pairs as (n, h, w, 3) uint8 stacks on the
    card."""
    pairs = [two_layer_pair(h, w, 4, 9, seed=s)[:2] for s in range(n)]
    return tuple(torch.as_tensor(np.stack(side), device=dev)
                 for side in zip(*pairs))


@pytest.mark.parametrize("group", [4, 2])
@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_batched_graph_equals_match_device(dev, path, group):
    """Each output of a graph replay is bitwise ``match_device`` on its
    pair, at g = B (one replay) and g < B (two); the capture counts g
    times one match's launches, and the graph holds no more memory than
    ``pair_bytes`` says."""
    from adcensus_torch.utils import graphs

    cross_backend, agg_impl = GRAPH_PATHS[path]
    kwargs = dict(device=dev, cross_backend=cross_backend, agg_impl=agg_impl)
    lefts, rights = _stacks(dev, 4)
    opts = ADCensusOptions(max_disparity=16)
    graphs.clear()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(dev)
    out = pipeline.match_batched_device(lefts, rights, opts, group=group,
                                        **kwargs)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(dev) - reserved
    assert held <= group * pipeline.pair_bytes(60, 200, opts, dev,
                                               cross_backend), held
    _build.reset_launches()
    singles = [pipeline.match_device(lefts[i], rights[i], opts, **kwargs)
               for i in range(4)]
    per_match = {k: v // 4 for k, v in _build.launches.items()}
    (entry,) = graphs.cached()
    assert entry.launches == {k: group * v for k, v in per_match.items()}
    for i in range(4):
        _assert_bitwise(out[i], singles[i])


@pytest.mark.parametrize("group", [None, 2])
def test_batched_spans_a_replay_a_group(dev, group):
    """Under a profiler, a batched call records its root, the group rule
    (unless a group is given), the stacks' copy in, and one entry.replay
    a group; the first call's eager warm-up records its stages, the
    capture none."""
    from torch.profiler import ProfilerActivity, profile

    from adcensus_torch.utils import graphs, profiling

    lefts, rights = _stacks(dev, 4)
    lefts, rights = lefts.cpu().numpy(), rights.cpu().numpy()
    opts = ADCensusOptions(max_disparity=16)
    graphs.clear()
    profiling.clear()
    calls = []
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(2):
            out = pipeline.match_batched_device(lefts, rights, opts,
                                                device=dev, group=group)
            calls.append(profiling.spans())
            profiling.clear()
    g = int(graphs.cached()[-1].outputs.shape[0])
    rule = ["entry.group_rule"] if group is None else []
    for k, spans in enumerate(calls):
        (root,) = [s for s in spans if s.parent is None]
        assert root.name == "match_batched_device"
        assert {s.request for s in spans} == {root.request}
        warm = list(profiling.STAGES) if k == 0 else []
        assert [s.name for s in sorted(spans, key=lambda s: s.start_ns)
                if s.parent == root.id] == (
            rule + ["entry.h2d"] + warm + ["entry.replay"] * (4 // g))
    want = pipeline.match_batched_device(lefts, rights, opts, device=dev,
                                         group=group)
    _assert_bitwise(out, want)


def test_hetero_graph_equals_per_pair(dev):
    """Pairs of two shapes and disparity ranges in one graph, bitwise
    equal to ``match_device`` on each."""
    (l1,), (r1,) = _stacks(dev, 1)
    l2, r2, _ = two_layer_pair(48, 150, 2, 5, seed=7)
    pairs = ((l1, r1), (l2, r2))
    opts_seq = (ADCensusOptions(max_disparity=16),
                ADCensusOptions(max_disparity=8, cross_L1=12))
    outs = pipeline.match_hetero_device(pairs, opts_seq, device=dev)
    assert [tuple(o.shape) for o in outs] == [(60, 200), (48, 150)]
    for (left, right), opts, out in zip(pairs, opts_seq, outs):
        _assert_bitwise(out, pipeline.match_device(left, right, opts,
                                                   device=dev))


def test_second_call_captures_no_graph(dev):
    """A call whose key is cached replays that graph: no capture, no
    launch counted, and the same result for the same inputs."""
    from adcensus_torch.utils import graphs

    lefts, rights = _stacks(dev, 2)
    opts = ADCensusOptions(max_disparity=16)
    first = pipeline.match_batched_device(lefts, rights, opts, device=dev)
    n = graphs.captures
    _build.reset_launches()
    again = pipeline.match_batched_device(lefts, rights, opts, device=dev)
    assert graphs.captures == n
    assert not any(_build.launches.values())
    _assert_bitwise(again, first)


def test_batched_replay_syncs_no_host(dev):
    """With its inputs on the card, a call of a cached group makes no
    host transfer: it runs under sync debug mode "error"."""
    lefts, rights = _stacks(dev, 2)
    opts = ADCensusOptions(max_disparity=16)
    first = pipeline.match_batched_device(lefts, rights, opts, device=dev,
                                          group=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipeline.match_batched_device(lefts, rights, opts, device=dev,
                                            group=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_bitwise(out, first)


def test_capture_on_a_side_stream(dev):
    """A call made on a stream other than the default captures and
    replays there and gives ``match_device``'s result."""
    from adcensus_torch.utils import graphs

    lefts, rights = _stacks(dev, 2)
    opts = ADCensusOptions(max_disparity=16)
    graphs.clear()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        out = pipeline.match_batched_device(lefts, rights, opts, device=dev)
        assert torch.cuda.current_stream(dev) == side
    torch.cuda.current_stream(dev).wait_stream(side)
    for i in range(2):
        _assert_bitwise(out[i], pipeline.match_device(lefts[i], rights[i],
                                                      opts, device=dev))


def test_failed_capture_raises_with_its_stage(dev, monkeypatch):
    """A stage that syncs the host breaks the capture: the call raises,
    naming the stage, retries nothing, and leaves the caller's stream
    current."""
    from adcensus_torch.utils import graphs

    median = refine.median_filter_3x3

    def syncing_median(disp, in_image=None):
        disp.sum().item()
        return median(disp, in_image)

    lefts, rights = _stacks(dev, 1)
    graphs.clear()
    monkeypatch.setattr(refine, "median_filter_3x3", syncing_median)
    stream = torch.cuda.current_stream(dev)
    with pytest.raises(RuntimeError,
                       match="capture failed in stage refine.multistep_refine"):
        pipeline.match_batched_device(lefts, rights,
                                      ADCensusOptions(max_disparity=16),
                                      device=dev)
    assert torch.cuda.current_stream(dev) == stream
    assert not graphs.cached()


# The sharded layer (adcensus_torch/parallel/) at world size 1 on NCCL:
# one card takes one rank. label -> (volume_axis, cross_backend, options)
SHARDED_CASES = {
    "rows": ("rows", "roll", {}),
    "disp": ("disp", "roll", {}),
    "rows_flags": ("rows", "roll", FLAGS),
    "rows_matmul": ("rows", "matmul", {}),
    "disp_matmul": ("disp", "matmul", {}),
}


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A (1, 1) mesh over a world of one on NCCL, torn down after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from adcensus_torch.parallel import distributed
    from adcensus_torch.parallel.mesh import make_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    distributed.initialize(store.as_uri(), world_size=1, rank=0)
    assert dist.get_backend() == "nccl"
    yield make_mesh(1, 1)
    dist.destroy_process_group()


def _sharded_pair(dev, seed=3):
    left, right, _ = two_layer_pair(60, 200, 4, 9, seed=seed)
    lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
    return lt, rt, cost_stage.compute_gray(lt), cost_stage.compute_gray(rt)


def _launches_of(fn):
    torch.cuda.synchronize()
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.launches)


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_world_of_one_equals_match_device(nccl_mesh, case):
    """match_sharded at world size 1: bitwise match_device on the same
    device grays, with the same kernel launches (B1 4 and B3 10 on roll,
    B2 4, B4 2, M1 and M2 1 with the flags)."""
    from adcensus_torch.parallel import sharded

    dev = torch.device("cuda")
    axis, backend, extra = SHARDED_CASES[case]
    opts = ADCensusOptions(max_disparity=32, **extra)
    lt, rt, gl, gr = _sharded_pair(dev)
    want, want_launches = _launches_of(lambda: pipeline.match_core(
        lt, rt, gl, gr, opts, cross_backend=backend)["disparity"])
    out, launches = _launches_of(lambda: sharded.match_sharded(
        lt, rt, gl, gr, opts, nccl_mesh, backend, axis))
    _assert_bitwise(out, want)
    assert launches == want_launches
    assert launches["scanline"] == 4 and launches["ray_interp"] == 2
    roll = backend == "roll"
    assert launches["cross_sum"] == 4 * roll
    assert launches["region_vote"] == 10 * roll
    assert launches["median_inplace"] == launches["dda"] == int(bool(extra))


def test_sharded_batched_world_of_one(nccl_mesh):
    from adcensus_torch.parallel import sharded

    dev = torch.device("cuda")
    opts = ADCensusOptions(max_disparity=32)
    pairs = [_sharded_pair(dev, seed) for seed in (3, 4)]
    stacks = [torch.stack(t) for t in zip(*pairs)]
    out = sharded.match_sharded_batched(*stacks, opts, nccl_mesh)
    assert out.shape == (2, 60, 200)
    for b, pair in enumerate(pairs):
        _assert_bitwise(out[b], pipeline.match_core(*pair, opts)["disparity"])


def test_sharded_syncs_no_host(nccl_mesh):
    """The sharded body reads nothing back from the card: a match at
    world size 1 runs under sync debug mode "error"."""
    from adcensus_torch.parallel import sharded

    dev = torch.device("cuda")
    opts = ADCensusOptions(max_disparity=32, **FLAGS)
    args = _sharded_pair(dev)
    want = sharded.match_sharded(*args, opts, nccl_mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sharded.match_sharded(*args, opts, nccl_mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_bitwise(out, want)


# (first own row, own rows) of a rank's slab in a 90-row image with a
# 12-row halo: the first, a middle and the last rank, and a slab thinner
# than its halo (a multi-hop exchange's)
SLABS = [(0, 30), (30, 30), (60, 30), (40, 7)]
SLAB_HALO = 12


def _haloed(t, r0, rows, fill=0):
    """Rows [r0 - SLAB_HALO, r0 + rows + SLAB_HALO) of ``t`` (rows on
    dim 0), ``fill`` beyond the image: what the rows layout gives a
    kernel."""
    pad = t.new_full((SLAB_HALO,) + tuple(t.shape[1:]), fill)
    return torch.cat([pad, t, pad])[r0 : r0 + rows + 2 * SLAB_HALO]


@pytest.mark.parametrize("horizontal_first", [True, False])
def test_cross_sum_on_haloed_slab(dev, horizontal_first):
    """B1 on a rank's haloed slab with max_arm = halo: the own rows are
    bitwise the plain version's on the slab and the full image's."""
    opts = ADCensusOptions(cross_L1=SLAB_HALO, cross_L2=6)
    left = torch.as_tensor(two_layer_pair(90, 120, 3, 7, seed=6)[0],
                           device=dev)
    a = arms.build_arms(left, opts)
    rng = np.random.default_rng(6)
    vol = torch.as_tensor(rng.random((8, 90, 120), np.float32), device=dev)
    sup = aggregate.support_counts(a, SLAB_HALO)[0 if horizontal_first
                                                 else 1].float()
    full = cross_sum.cross_pass(vol, a, sup, horizontal_first, SLAB_HALO)
    for r0, rows in SLABS:
        args = (_haloed(vol.transpose(0, 1), r0, rows).transpose(0, 1)
                .contiguous(), _haloed(a, r0, rows),
                _haloed(sup, r0, rows, 1.0), horizontal_first, SLAB_HALO)
        own = slice(SLAB_HALO, SLAB_HALO + rows)
        out = cross_sum.cross_pass(*args)[:, own]
        _assert_bitwise(out, cross_sum.cross_pass_plain(*args)[:, own])
        _assert_bitwise(out, full[:, r0 : r0 + rows])


def test_region_vote_on_haloed_slab(dev):
    """B3 on a rank's haloed slab, no target in the halo rows: bitwise
    the plain version everywhere, and the full image's statistics on
    the own rows."""
    d_range = 16
    opts = ADCensusOptions(max_disparity=d_range, cross_L1=SLAB_HALO,
                           cross_L2=6)
    left = torch.as_tensor(two_layer_pair(90, 120, 3, 7, seed=7)[0],
                           device=dev)
    a = arms.build_arms(left, opts)
    rng = np.random.default_rng(7)
    disp = rng.uniform(0, d_range, (90, 120)).astype(np.float32)
    disp[rng.random((90, 120)) < 0.3] = np.inf
    disp = torch.as_tensor(disp, device=dev)
    target = torch.as_tensor(rng.random((90, 120)) < 0.2, device=dev)
    di, valid = refine.vote_indices(disp, opts)
    full = region_vote.region_vote_stats(di, valid, a, d_range, SLAB_HALO,
                                         target=target)
    for r0, rows in SLABS:
        own = slice(SLAB_HALO, SLAB_HALO + rows)
        sdi, svalid = refine.vote_indices(_haloed(disp, r0, rows), opts)
        t = _haloed(target, r0, rows, False)
        t[: SLAB_HALO] = False
        t[SLAB_HALO + rows :] = False
        args = (sdi, svalid, _haloed(a, r0, rows), d_range, SLAB_HALO)
        out = region_vote.region_vote_stats(*args, target=t)
        plain = region_vote.region_vote_stats_plain(*args, target=t)
        for k, p, f in zip(out, plain, full):
            _assert_bitwise(k, p)
            _assert_bitwise(k[own], f[r0 : r0 + rows])


# Kernels C1 (census) and C2 (the cost volume)

def _gray(dev, h, w, seed):
    rng = np.random.default_rng(seed)
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    gray[h // 3 : h // 3 + 3, w // 4 : w // 4 + 5] = 128  # ties
    return torch.as_tensor(gray, device=dev)


CENSUS_SHAPES = {"cone": (375, 450), "kitti": (375, 1242), "1x1": (1, 1),
                 "7x30": (7, 30), "8x30": (8, 30), "20x9": (20, 9),
                 "20x10": (20, 10), "33x65": (33, 65), "5x300": (5, 300)}


@pytest.mark.parametrize("shape", sorted(CENSUS_SHAPES))
def test_census_bitwise(dev, shape):
    """C1 on random grays (a flat patch for ties), one launch, bitwise
    its plain version; all zero for images 9 wide or 7 tall."""
    h, w = CENSUS_SHAPES[shape]
    gray = _gray(dev, h, w, h * 1000 + w)
    _build.reset_launches()
    out = cost_stage.census_transform_9x7(gray)
    assert _build.launches["census"] == 1
    _assert_bitwise(out, cost_stage.census_transform_9x7_plain(gray, 0, h, w))
    if w <= 9 or h <= 7:
        assert not out.any()


# (row_offset, rows, full_h, full_w) of slabs of a 90x120 gray: the first
# rank's (4 zero rows of context above, as the sharded layer pads), a
# middle one, the last one, one reaching into padding rows, and padded
# columns
CENSUS_SLABS = [(-4, 38, 90, 120), (26, 38, 90, 120), (56, 38, 90, 120),
                (66, 28, 90, 120), (10, 20, 90, 112)]


@pytest.mark.parametrize("r0,rows,full_h,full_w", CENSUS_SLABS)
def test_census_row_slabs(dev, r0, rows, full_h, full_w):
    """C1 in the sharded layer's slab mode: bitwise its plain version on
    the slab, and the full image's signatures on the rows 4 or more from
    the slab's edges."""
    gray = _gray(dev, 90, 120, 5)
    ctx = torch.cat([torch.zeros_like(gray[:4]), gray,
                     torch.zeros_like(gray[:4])])[r0 + 4 : r0 + 4 + rows]
    assert ctx.shape[0] == rows
    out = cost_stage.census_transform_9x7(ctx, row_offset=r0, full_h=full_h,
                                          full_w=full_w)
    _assert_bitwise(out, cost_stage.census_transform_9x7_plain(
        ctx, r0, full_h, full_w))
    full = cost_stage.census_transform_9x7(
        gray[:full_h, :full_w].contiguous())
    inner = slice(max(4, -r0), rows - 4)
    rows_full = slice(r0 + inner.start, r0 + inner.stop)
    _assert_bitwise(out[inner, :full_w], full[rows_full])


def _cost_inputs(dev, h, w, seed, pad=0):
    """A seeded pair (the right image the left moved 3 columns, plus
    noise) with its census, padded on the right by ``pad`` zero columns
    as the sharded layer pads."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    right = np.clip(np.roll(left, -3, axis=1).astype(np.int64)
                    + rng.integers(-8, 9, (h, w, 3)), 0, 255).astype(np.uint8)
    lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
    cl, cr = (cost_stage.census_transform_9x7(cost_stage.compute_gray(x))
              for x in (lt, rt))
    if pad:
        lt, rt = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (lt, rt))
        cl, cr = (torch.nn.functional.pad(x, (0, pad)) for x in (cl, cr))
    return lt, rt, cl, cr


# (H, W, min_disparity, max_disparity, d0, d_count, pad): both
# configurations; a negative min_disparity; the sharded layer's disp
# blocks (d0, D / n) and padded rows slabs (real_w = W); odd widths and
# widths of each vector size; D beyond W
COST_CASES = {
    "cone": (375, 450, 0, 64, 0, 64, 0),
    "kitti": (375, 1242, 0, 256, 0, 256, 0),
    "negative min": (60, 200, -20, 44, 0, 64, 0),
    "disp block 2 of 4": (60, 200, 0, 64, 16, 16, 0),
    "disp block 4 of 4, negative min": (60, 200, -8, 56, 48, 16, 0),
    "rows slab padded": (15, 197, -3, 29, 0, 32, 3),
    "disp block padded": (60, 197, -5, 59, 32, 32, 3),
    "odd width": (30, 257, 0, 40, 0, 40, 0),
    "odd width, two tiles": (20, 517, -7, 33, 0, 40, 0),
    "width 4k": (30, 260, 0, 70, 0, 70, 0),
    "width 4k, two tiles": (20, 1028, 0, 70, 0, 70, 0),
    "D beyond W": (9, 20, -4, 60, 0, 64, 0),
    "one column": (3, 1, -2, 3, 0, 5, 0),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_volume_bitwise(dev, case):
    """C2, one launch, bitwise its plain version; out-of-image columns
    exactly 1.0."""
    h, w, d_min, d_max, d0, d_count, pad = COST_CASES[case]
    opts = ADCensusOptions(min_disparity=d_min, max_disparity=d_max)
    args = (*_cost_inputs(dev, h, w, len(case), pad), opts, d0, d_count)
    _build.reset_launches()
    out = cost_stage.compute_cost_planes(*args, real_w=w)
    assert _build.launches["cost_volume"] == 1
    _assert_bitwise(out, cost_stage.compute_cost_planes_plain(*args, w))
    xr = (torch.arange(w + pad, device=dev)[None]
          - torch.arange(d0 + d_min, d0 + d_min + d_count, device=dev)[:, None])
    oob = ((xr < 0) | (xr >= w))[:, None, :].expand_as(out)
    assert (out[oob] == 1.0).all()


def _plain_cost():
    return mock.patch("adcensus_torch.stages.cost.kernels_for",
                      lambda t: False)


@pytest.mark.parametrize("d_min,d_max", [(0, 64), (-6, 26)])
def test_match_core_cost_kernels_equal_plain_cost(dev, d_min, d_max):
    """match_core with C1 and C2 gives the plain cost stage's cost_init
    and disparity bitwise, the other kernels on in both; C1 launches
    twice and C2 once."""
    left, right, _ = two_layer_pair(120, 300, 5, 12, seed=4)
    lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
    opts = ADCensusOptions(min_disparity=d_min, max_disparity=d_max)
    args = (lt, rt, cost_stage.compute_gray(lt), cost_stage.compute_gray(rt),
            opts)
    _build.reset_launches()
    out = pipeline.match_core(*args, return_intermediates=True)
    assert (_build.launches["census"], _build.launches["cost_volume"]) == (
        2, 1)
    with _plain_cost():
        _build.reset_launches()
        plain = pipeline.match_core(*args, return_intermediates=True)
        assert _build.launches["census"] == _build.launches["cost_volume"] == 0
    _assert_bitwise(out["cost_init"], plain["cost_init"])
    _assert_bitwise(out["disparity"], plain["disparity"])


def test_batched_graph_cost_kernels_equal_plain_cost(dev):
    """Inside a match_batched_device graph, C1 and C2 are captured (twice
    and once a pair) and each output is bitwise match_device with the
    plain cost stage."""
    from adcensus_torch.utils import graphs

    lefts, rights = _stacks(dev, 4)
    opts = ADCensusOptions(min_disparity=-2, max_disparity=30)
    graphs.clear()
    out = pipeline.match_batched_device(lefts, rights, opts, device=dev,
                                        group=2)
    (entry,) = graphs.cached()
    assert (entry.launches["census"], entry.launches["cost_volume"]) == (4, 2)
    with _plain_cost():
        for i in range(4):
            _assert_bitwise(out[i], pipeline.match_device(
                lefts[i], rights[i], opts, device=dev))
