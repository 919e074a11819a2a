"""Kernel A1 (csrc/arms.cu, the cross arms of every pixel and direction)
on the card, bitwise against the plain stage it replaces
(stages/arms.py:build_arms_plain) on the same card: the cases of its CPU
emulation (tests/_arms_cases.py: random, near-constant, noisy and blocky
images, arm caps of 0 to 300, thresholds that are not integers, small
shapes, the sharded layer's slab mode), the Cone, KITTI and full-size
Middlebury 2014 images, and the synthetic pair's left image. Also: one
launch a build, none under the plain versions.

Needs a CUDA card and nvcc; skips without a card. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_arms_cuda.py
"""
import pytest
import torch

from _arms_cases import CAPS, KINDS, SLABS, SMALL, THRESHOLDS, image
from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import _build
from adcensus_torch.stages import arms as arms_stage
from adcensus_torch.synthetic import two_layer_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check(dev, img, opts, row_offset=0, full_h=None, full_w=None):
    t = torch.as_tensor(img, device=dev)
    _build.reset_launches()
    got = arms_stage.build_arms(t, opts, row_offset, full_h, full_w)
    assert _build.launches["arms"] == (1 if img.size else 0)
    want = arms_stage.build_arms_plain(t, opts, row_offset, full_h, full_w)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want), f"differ at {int((got != want).sum())}"
    return got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("l1,l2", CAPS)
def test_arms_equal_plain(dev, kind, l1, l2):
    h, w = (40, 300) if l1 > 34 else (33, 47)
    _check(dev, image(kind, h, w, seed=l1 + l2),
           ADCensusOptions(cross_L1=l1, cross_L2=l2))


@pytest.mark.parametrize("t1,t2", THRESHOLDS)
def test_arms_thresholds(dev, t1, t2):
    _check(dev, image("blocks", 30, 40, seed=3),
           ADCensusOptions(cross_t1=t1, cross_t2=t2))


@pytest.mark.parametrize("h,w", SMALL)
def test_arms_small_shapes(dev, h, w):
    _check(dev, image("smooth", h, w, seed=h * w), ADCensusOptions())


@pytest.mark.parametrize("row_offset,full_h,full_w,extra_w", SLABS)
def test_arms_slab_mode(dev, row_offset, full_h, full_w, extra_w):
    _check(dev, image("smooth", 60, full_w + extra_w, seed=row_offset + 100),
           ADCensusOptions(), row_offset, full_h, full_w)


@pytest.mark.parametrize("h,w", [(375, 450), (375, 1242), (1988, 2632)])
@pytest.mark.parametrize("kind", ["blocks", "noisy"])
def test_arms_at_the_cells_sizes(dev, h, w, kind):
    _check(dev, image(kind, h, w, seed=h), ADCensusOptions())


def test_arms_of_the_synthetic_pair(dev):
    left, _, _ = two_layer_pair(375, 450, 16, 32, seed=5)
    arms = _check(dev, left, ADCensusOptions())
    assert int(arms.max()) > 1


def test_arms_plain_launches_nothing(dev):
    from chip_smoke import plain_versions

    t = torch.as_tensor(image("noisy", 20, 30, seed=0), device=dev)
    with plain_versions():
        _build.reset_launches()
        arms_stage.build_arms(t, ADCensusOptions())
        assert not any(_build.launches.values())
