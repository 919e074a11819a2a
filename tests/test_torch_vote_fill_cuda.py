"""Kernel B3 in its fill mode (csrc/region_vote.cu, adc_region_vote_fill:
a whole voting phase in one launch) on the card, bitwise against the
plain steps it replaces (ops/region_vote.py: vote_indices, the plain
statistics, vote_fill) on the same card: seeded maps with +inf and NaN
pixels, disparities on and between the rounding's half steps, beyond the
range at both ends and a negative min_disparity; D of 1, 3, 64 and 256;
arms of 0, 34 and 200; phase masks empty, sparse, full and a rectangle;
one-pixel-wide and -high maps and the Cone size. Also: one launch a phase,
counted as B3's, and the voting stage's ten phases bitwise the plain
stage on the Cone-size pair's own maps, on a row slab of the sharded
layer too.

Needs a CUDA card and nvcc; skips without a card. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_vote_fill_cuda.py
"""
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import _build, region_vote
from adcensus_torch.stages import arms as arms_stage
from adcensus_torch.stages import pipeline, refine
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.synthetic import two_layer_pair
from chip_smoke import plain_versions

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_bitwise(a, b):
    """Bitwise, NaN payloads included."""
    assert a.shape == b.shape and a.dtype == b.dtype
    a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), f"differ at {int((a != b).sum())} cells"


def _random_arms(rng, h, w, max_arm):
    """(H, W, 4) int32 arms up to ``max_arm``, clipped to the border."""
    yy, xx = np.mgrid[:h, :w]
    border = (xx, w - 1 - xx, yy, h - 1 - yy)
    a = rng.integers(0, max_arm + 1, (4, h, w))
    return np.stack([np.minimum(a[k], border[k]) for k in range(4)],
                    axis=-1).astype(np.int32)


def _map(rng, h, w, d, min_d):
    """A float32 map: a third of it +inf, 2 % NaN, the rest integers,
    half steps and values between them over the range and 3 beyond each
    end, with a few far outside it."""
    lo, hi = min_d - 3, min_d + d + 3
    base = rng.integers(lo, hi, (h, w)).astype(np.float32)
    frac = rng.choice(np.float32([0.0, 0.5, -0.5, 0.25, 0.4999999, 0.75]),
                      (h, w))
    m = base + frac
    m[rng.random((h, w)) < 0.01] = 1e6
    m[rng.random((h, w)) < 0.01] = -1e6
    m[rng.random((h, w)) < 1 / 3] = np.inf
    m[rng.random((h, w)) < 0.02] = np.nan
    return m.astype(np.float32)


def _phase(rng, h, w, kind):
    if kind == "rectangle":
        p = np.zeros((h, w), bool)
        p[h // 4:3 * h // 4 + 1, w // 3:2 * w // 3 + 1] = True
        return p
    density = {"empty": 0.0, "all": 1.0}.get(kind)
    if density is None:
        density = float(kind.rstrip("%")) / 100
    return rng.random((h, w)) < density


def _fill_both(dev, disp, a, phase, d, max_arm, min_d, ts=20, th=0.4):
    """(kernel's map, plain map) of one phase, and the kernel's launches."""
    args = [torch.as_tensor(x, device=dev) for x in (disp, a, phase)]
    th = float(np.float32(th))
    _build.reset_launches()
    got = region_vote.region_vote_fill(*args, d, max_arm, min_d, ts, th)
    n = dict(_build.launches)
    with plain_versions():
        want = region_vote.region_vote_fill(*args, d, max_arm, min_d, ts, th)
    return got, want, n


@pytest.mark.parametrize("max_arm", [0, 34, 200])
@pytest.mark.parametrize("d", [1, 3, 64, 256])
@pytest.mark.parametrize("kind", ["empty", "5%", "all", "rectangle"])
def test_fill_equals_plain(dev, kind, d, max_arm):
    """One phase, bitwise, on maps that end in a partial run of pixels;
    thresholds low enough that targets fill (ts 0) and the reference's."""
    h, w = (40, 300) if max_arm > 127 else (37, 70)
    rng = np.random.default_rng(d * 11 + max_arm)
    disp = _map(rng, h, w, d, 0)
    a = _random_arms(rng, h, w, max_arm)
    phase = _phase(rng, h, w, kind)
    for ts, th in ((20, 0.4), (0, 0.1)):
        got, want, n = _fill_both(dev, disp, a, phase, d, max_arm, 0, ts, th)
        assert n["region_vote"] == 1
        _assert_bitwise(got, want)
    if kind == "empty":
        _assert_bitwise(got, torch.as_tensor(disp, device=dev))


@pytest.mark.parametrize("min_d", [-4, 3])
def test_fill_min_disparity(dev, min_d):
    """A map over [min_d, min_d + D): the indices and the filled values
    both shift by min_d; some targets fill."""
    h, w, d = 45, 75, 40
    rng = np.random.default_rng(7 - min_d)
    disp = _map(rng, h, w, d, min_d)
    a = _random_arms(rng, h, w, 34)
    phase = _phase(rng, h, w, "all")
    got, want, _ = _fill_both(dev, disp, a, phase, d, 34, min_d, 0, 0.1)
    _assert_bitwise(got, want)
    assert int((got.view(torch.int32) !=
                torch.as_tensor(disp, device=dev).view(torch.int32)).sum())


@pytest.mark.parametrize("h,w", [(1, 1), (1, 50), (50, 1), (5, 7),
                                 (17, 259), (375, 450)])
def test_fill_shapes(dev, h, w):
    rng = np.random.default_rng(h + w)
    disp = _map(rng, h, w, 64, 0)
    a = _random_arms(rng, h, w, 10)
    phase = _phase(rng, h, w, "5%")
    phase[0, 0] = True
    got, want, _ = _fill_both(dev, disp, a, phase, 64, 10, 0, 0, 0.1)
    _assert_bitwise(got, want)


def _cone_inter(dev, opts):
    left, right, _ = two_layer_pair(375, 450, 16, 32, seed=5)
    lt, rt = (torch.as_tensor(x, device=dev) for x in (left, right))
    inter = pipeline.match_core(
        lt, rt, cost_stage.compute_gray(lt), cost_stage.compute_gray(rt),
        opts, return_intermediates=True,
    )
    _, occl, mism = refine.outlier_detection(
        inter["disp_left_raw"], inter["disp_right_raw"], opts)
    return inter, occl, mism


def test_voting_stage_on_cone_pair(dev):
    """The ten phases on the Cone-size pair's LR-checked map: ten launches
    of B3, bitwise the plain stage, and holes filled."""
    opts = ADCensusOptions()
    inter, occl, mism = _cone_inter(dev, opts)
    args = (inter["after_lr_check"], inter["arms"], occl, mism, opts)
    _build.reset_launches()
    out = refine.iterative_region_voting(*args)
    assert _build.launches["region_vote"] == 10
    with plain_versions():
        want = refine.iterative_region_voting(*args)
    _assert_bitwise(out, want)
    assert int(torch.isfinite(out).sum()) > int(
        torch.isfinite(inter["after_lr_check"]).sum())


def test_voting_on_a_row_slab(dev):
    """A voting phase on a row slab's max_arm halo, as the sharded layer
    runs it (the halo's targets are padded away): the slab's own rows of
    the whole map's phase, bitwise."""
    from adcensus_torch.stages.slab import WHOLE

    opts = ADCensusOptions()
    inter, occl, mism = _cone_inter(dev, opts)
    disp, a = inter["after_lr_check"], inter["arms"]
    max_arm = min(opts.cross_L1, 255)
    whole = refine.region_vote_phase(disp, a, mism, opts, slab=WHOLE)
    y0, y1 = 120, 240
    lo, hi = y0 - max_arm, y1 + max_arm
    phase = torch.zeros_like(mism)
    phase[y0:y1] = mism[y0:y1]
    got = region_vote.region_vote_fill(
        disp[lo:hi].contiguous(), a[lo:hi].contiguous(),
        phase[lo:hi].contiguous(), opts.disp_range, max_arm,
        opts.min_disparity, opts.irv_ts, float(np.float32(opts.irv_th)))
    _assert_bitwise(got[max_arm:-max_arm].contiguous(),
                    whole[y0:y1].contiguous())
    assert not torch.equal(whole[y0:y1], disp[y0:y1])


def test_arms_of_build_arms(dev):
    """A phase on arms that build_arms makes from a near-constant image,
    running to the cap of 200 or the border."""
    h, w = 40, 300
    rng = np.random.default_rng(3)
    img = (100 + rng.integers(-2, 3, size=(h, w, 3))).astype(np.uint8)
    opts = ADCensusOptions(cross_L1=200, cross_L2=100)
    a = arms_stage.build_arms(torch.as_tensor(img, device=dev), opts)
    disp = _map(rng, h, w, 64, 0)
    phase = _phase(rng, h, w, "5%")
    got, want, _ = _fill_both(dev, disp, a.cpu().numpy(), phase, 64, 200, 0)
    _assert_bitwise(got, want)
