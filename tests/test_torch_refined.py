"""The benchmark's refined reference (stereo_bench/reference/
adcensus_refined.py) and the port's refinement with discontinuity
adjustment and the in-place median, on the CPU: the reference's Sobel
mask, adjustment (M2) and in-place median (M1) bitwise the numpy
oracle's on seeded maps with +inf pixels, ties, out-of-range disparities
and borders; ``pipeline.match`` with both options bitwise the
reference's match; each option changes the map, so a check against the
reference sees each; and ``refine.dda`` and ``refine.median`` are
recorded inside ``refine`` only where their options are on."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.stages import pipeline
from adcensus_torch.utils import profiling
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.oracle import numpy_ref
from stereo_bench.reference import adcensus as plain
from stereo_bench.reference import adcensus_refined as refined
from stereo_bench.scenes import two_layer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(1, 1), (1, 9), (9, 1), (2, 2), (3, 3), (3, 17), (7, 11),
          (16, 23)]
H, W, MAX_D, CROSS_L1 = 48, 64, 16, 8
SCENE = {"d_bg": 4, "d_fg": 9}


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _map(rng, shape, lo, hi, step=0.25, inf_share=0.15):
    """Disparities on a grid of ``step`` in [lo, hi) (so that windows
    hold ties), +inf at a share of the pixels."""
    m = (rng.integers(int(lo / step), int(hi / step), shape)
         * step).astype(np.float32)
    m[rng.random(shape) < inf_share] = np.inf
    return m


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_median_equals_the_oracle(shape):
    rng = np.random.default_rng(sum(shape))
    for _ in range(3):
        m = _map(rng, shape, 0.0, 2.0)
        kept = m.copy()
        got = refined.median_3x3_inplace(m)
        np.testing.assert_array_equal(_bits(m), _bits(kept))
        np.testing.assert_array_equal(
            _bits(got), _bits(numpy_ref.median_filter_inplace(m)))


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_edge_mask_equals_the_oracle(shape):
    rng = np.random.default_rng(100 + sum(shape))
    m = _map(rng, shape, 0.0, 12.0, step=0.125)
    with np.errstate(invalid="ignore"):
        want = numpy_ref.edge_detect(m, refined.EDGE_THRESHOLD).astype(bool)
    np.testing.assert_array_equal(refined.edge_mask(m), want)


@pytest.mark.parametrize("d_range", [1, 3, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_dda_equals_the_oracle(shape, d_range):
    """Disparities from -1 to d_range + 1 (some indices out of range),
    +inf at 10 %, costs on a grid of four values (ties)."""
    rng = np.random.default_rng(1000 * d_range + sum(shape))
    opts = JaxOptions(min_disparity=0, max_disparity=d_range)
    for _ in range(3):
        m = _map(rng, shape, -1.0, d_range + 1.0, inf_share=0.1)
        cost = (rng.integers(0, 4, (d_range,) + shape) * 0.25
                ).astype(np.float32)
        with np.errstate(invalid="ignore"):
            want = numpy_ref.depth_discontinuity_adjustment(
                m, np.ascontiguousarray(cost.transpose(1, 2, 0)), opts)
        got = refined.depth_discontinuity_adjustment(m, cost)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _options(**change):
    """The refined Cones configuration's options at the tests' size."""
    cfg = json.loads((ROOT / "stereo_bench/configs/"
                      "middlebury2003-cones-refined.json").read_text())
    o = dict(cfg["options"], min_disparity=0, max_disparity=MAX_D,
             cross_L1=CROSS_L1)
    o.update(change)
    return o


def _pair(seed):
    left, right, _ = two_layer.make(H, W, SCENE, np.random.default_rng(seed))
    return left, right


@pytest.mark.parametrize("seed, change", [
    (0, {}), (1, {}), (2, {}), (3, {"min_disparity": 2, "max_disparity": 18}),
])
def test_port_match_equals_the_refined_reference(seed, change):
    o = _options(**change)
    assert o["exact_median"] and o["do_discontinuity_adjustment"]
    left, right = _pair(seed)
    port = pipeline.match(left, right, ADCensusOptions(**o),
                          device="cpu")["disparity"]
    np.testing.assert_array_equal(_bits(port),
                                  _bits(refined.match(left, right, o)))


@pytest.mark.parametrize("flag", ["exact_median",
                                  "do_discontinuity_adjustment"])
def test_each_option_changes_the_refined_map(flag):
    """With either option off the map differs from the refined one, on
    several pixels of every pair, so a check against the refined
    reference fails if either mechanism is dropped."""
    for seed in (0, 1):
        left, right = _pair(seed)
        want = refined.match(left, right, _options())
        off = refined.match(left, right, _options(**{flag: False}))
        assert int((off != want).sum()) >= 50
        port = pipeline.match(
            left, right, ADCensusOptions(**_options(**{flag: False})),
            device="cpu")["disparity"]
        np.testing.assert_array_equal(_bits(port), _bits(off))


def test_with_both_options_off_it_is_the_plain_reference():
    left, right = _pair(4)
    o = _options(exact_median=False, do_discontinuity_adjustment=False)
    np.testing.assert_array_equal(_bits(refined.match(left, right, o)),
                                  _bits(plain.match(left, right, o)))


@pytest.mark.parametrize("dda, median", [(True, True), (False, False),
                                         (True, False), (False, True)])
def test_refine_spans_open_under_their_options(dda, median):
    left, right = _pair(5)
    opts = dataclasses.replace(
        ADCensusOptions(**_options()), do_discontinuity_adjustment=dda,
        exact_median=median)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pipeline.match(left, right, opts, device="cpu")
        spans = profiling.spans()
    finally:
        profiling.clear()
    (refine,) = [s for s in spans if s.name == profiling.REFINE]
    inner = [s for s in spans if s.name.startswith("refine.")]
    want = ["refine.dda"] * dda + ["refine.median"] * median
    assert [s.name for s in sorted(inner, key=lambda s: s.start_ns)] == want
    for s in inner:
        assert s.parent == refine.id and s.request == refine.request
        assert refine.start_ns <= s.start_ns <= s.end_ns <= refine.end_ns
