"""Kernel B2 with its penalty codes derived in the kernel, on the card,
bitwise against ``scanline_pass_plain`` fed ``code_volume``'s volume, in
both directions on both axes: at the Cone (D 64) and KITTI (D 256) sizes,
on a D-640 slab cut in rows and width at the geometry scanline_geometry
gives and at (4, 8, 2), with a nonzero min_disparity, on a column slab of
a wider image with its full-width right map (the sharded y passes), and
at an odd width. Also: the scanline stage at the KITTI size allocates no
(D, H, W) temporary beside the passes' outputs.

Needs a CUDA card and nvcc; skips without a card. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_scanline_codes_cuda.py
"""
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import _build, scanline
from adcensus_torch.stages import scanline as scan_stage

pytestmark = pytest.mark.cuda

TSO = 15
PASSES = [("x", True), ("x", False), ("y", True), ("y", False)]
# (D, rows, out_w, W_full, col0, min_disparity, real_w)
CASES = {
    "cone": (64, 375, 450, 450, 0, 0, 450),
    "kitti": (256, 375, 1242, 1242, 0, 0, 1242),
    "d640_slab": (640, 40, 700, 700, 0, 0, 700),
    "min_d_neg": (96, 60, 300, 300, 0, -13, 300),
    "min_d_pos": (96, 60, 300, 300, 0, 21, 300),
    "col_slab": (128, 90, 157, 628, 314, 0, 620),
    "col_slab_min_d": (128, 90, 157, 628, 471, -5, 623),
    "odd_w": (80, 33, 451, 451, 0, 0, 451),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, case):
    d, rows, out_w, w_full, col0, d_min, real_w = CASES[case]
    rng = np.random.default_rng(d + rows + out_w + col0)
    cost = torch.as_tensor(rng.random((d, rows, out_w), np.float32) * 2 - 1,
                           device=dev)
    d1 = torch.as_tensor(rng.integers(0, 2 * TSO, (rows, out_w), np.int32),
                         device=dev)
    rd = torch.as_tensor(rng.integers(0, 2 * TSO, (rows, w_full), np.int32),
                         device=dev)
    opts = ADCensusOptions(min_disparity=d_min, max_disparity=d_min + d,
                           so_tso=TSO)
    return cost, d1, rd, opts, col0, real_w


def _plain(cost, d1, rd, flags, opts, col0, real_w, axis, reverse):
    code = scan_stage.code_volume(d1, rd, opts, real_w, col0)
    return scanline.scanline_pass_plain(cost, code, flags, opts.so_p1,
                                        opts.so_p2, axis, reverse)


def _assert_bitwise(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("axis,forward", PASSES)
def test_scanline_codes_in_kernel(dev, case, axis, forward):
    cost, d1, rd, opts, col0, real_w = _inputs(dev, case)
    s_len = cost.shape[2] if axis == "x" else cost.shape[1]
    flags = scan_stage._scan_flags(s_len, device=dev)
    _build.reset_launches()
    out = scanline.scanline_pass(cost, d1, rd, flags, opts.so_tso,
                                 opts.so_p1, opts.so_p2, axis, not forward,
                                 opts.min_disparity, col0, real_w)
    assert _build.launches["scanline"] == 1
    _assert_bitwise(out, _plain(cost, d1, rd, flags, opts, col0, real_w,
                                axis, not forward))


@pytest.mark.parametrize("axis,forward", PASSES)
def test_scanline_codes_d640_at_4_8_2(dev, axis, forward):
    """The D-640 slab at the geometry a rank's full-size slabs get."""
    cost, d1, rd, opts, col0, real_w = _inputs(dev, "d640_slab")
    d = cost.shape[0]
    assert scanline.scanline_geometry(d, 2632, 497, "x")[:3] == (4, 8, 2)
    s_len = cost.shape[2] if axis == "x" else cost.shape[1]
    flags = scan_stage._scan_flags(s_len, device=dev)
    geometry = (4, 8, 2, 2 * scanline.scanline_layout(d, 4, 8, axis)[-1])
    out = scanline.launch_pass(cost, d1 >= TSO, rd >= TSO, flags,
                               opts.so_p1, opts.so_p2, axis, not forward,
                               opts.min_disparity, col0, real_w, geometry)
    _assert_bitwise(out, _plain(cost, d1, rd, flags, opts, col0, real_w,
                                axis, not forward))


def test_scanline_optimize_no_volume_temporaries(dev):
    """scanline_optimize at the KITTI size peaks at its input and two
    passes' outputs (a pass's input and output) plus a few (H, W) maps:
    no (D, H, W) code volume or gather."""
    d, h, w = 256, 375, 1242
    rng = np.random.default_rng(3)
    left, right = (torch.as_tensor(rng.integers(0, 256, (h, w, 3), np.uint8),
                                   device=dev) for _ in range(2))
    cost = torch.as_tensor(rng.random((d, h, w), np.float32), device=dev)
    opts = ADCensusOptions(max_disparity=d)
    scan_stage.scanline_optimize(cost, left, right, opts)  # kernels built
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = scan_stage.scanline_optimize(cost, left, right, opts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    vol, plane = cost.numel() * 4, h * w * 4
    assert out.shape == cost.shape
    assert peak <= 2 * vol + 32 * plane, (peak, vol)
