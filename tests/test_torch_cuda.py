"""The four CUDA kernels of adcensus_torch against their plain PyTorch
versions on the card, bitwise, at shapes and options the main path of
chip_smoke.py does not reach: arms beyond 127, D from 5 to 256, padded
scan steps, rays longer than the image, a negative min_disparity.

Needs a CUDA card and nvcc; skips without a card. This file imports no
JAX, so on the GPU host it runs without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import _build, cross_sum, interp, region_vote, scanline
from adcensus_torch.stages import aggregate, arms, pipeline, refine
from adcensus_torch.stages import scanline as scan_stage
from adcensus_torch.synthetic import two_layer_pair

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


@pytest.mark.parametrize("d", [5, 64, 256])
@pytest.mark.parametrize("axis,forward",
                         [("x", True), ("x", False), ("y", True), ("y", False)])
def test_scanline_padded_steps(dev, d, axis, forward):
    h, w = 24, 40
    rng = np.random.default_rng(d)
    cost = torch.as_tensor(rng.random((d, h, w), np.float32) * 2, device=dev)
    code = torch.as_tensor(rng.integers(0, 3, (d, h, w), np.uint8),
                           device=dev)
    s_len = w if axis == "x" else h
    valid = torch.ones(s_len, dtype=torch.bool, device=dev)
    valid[:3] = False
    valid[-2:] = False
    flags = scan_stage._scan_flags(s_len, valid)
    args = (cost, code, flags, 1.0, 3.0, axis, not forward)
    _assert_bitwise(scanline.scanline_pass(*args),
                    scanline.scanline_pass_plain(*args))


@pytest.mark.parametrize("d", [3, 64, 256])
def test_region_vote_wide_and_long(dev, d):
    a = _long_arms(dev, h=30, w=160, cap=150)
    rng = np.random.default_rng(d)
    di = torch.as_tensor(rng.integers(0, d, a.shape[:2], np.int32),
                         device=dev)
    valid = torch.as_tensor(rng.random(a.shape[:2]) < 0.7, device=dev)
    args = (di, valid, a, d, 150)
    for k, p in zip(region_vote.region_vote_stats(*args),
                    region_vote.region_vote_stats_plain(*args)):
        _assert_bitwise(k, p)


@pytest.mark.parametrize("max_search", [8, 256])
@pytest.mark.parametrize("is_mismatch", [True, False])
def test_ray_interp_sparse_map(dev, max_search, is_mismatch):
    h, w = 50, 70
    rng = np.random.default_rng(max_search)
    disp = rng.random((h, w), np.float32) * 64
    disp[rng.random((h, w)) < 0.6] = np.inf
    left = rng.integers(0, 256, (h, w, 3), np.uint8)
    target = rng.random((h, w)) < 0.3
    offsets = torch.as_tensor(refine.ray_offset_table(max_search), device=dev)
    args = (torch.as_tensor(disp, device=dev),
            torch.as_tensor(left, device=dev), offsets,
            torch.as_tensor(target, device=dev), is_mismatch)
    for k, p in zip(interp.ray_interp(*args), interp.ray_interp_plain(*args)):
        _assert_bitwise(k, p)


def test_match_device_equals_plain_pipeline(dev):
    """Kernels and plain versions give the same match on the card, with a
    negative min_disparity and an arm cap beyond 127."""
    left, right, _ = two_layer_pair(60, 200, 4, 9, seed=3)
    opts = ADCensusOptions(min_disparity=-2, max_disparity=14,
                           cross_L1=150, cross_L2=60)
    _build.reset_launches()
    disp = pipeline.match_device(left, right, opts, device=dev)
    assert all(_build.launches.values()), _build.launches
    with ExitStack() as stack:
        for mod in ("cross_sum", "scanline", "region_vote", "interp"):
            stack.enter_context(mock.patch(
                f"adcensus_torch.ops.{mod}.kernels_for", lambda t: False
            ))
        _build.reset_launches()
        plain = pipeline.match_device(left, right, opts, device=dev)
        assert not any(_build.launches.values())
    _assert_bitwise(disp, plain)
