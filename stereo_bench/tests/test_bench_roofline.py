"""roofline.py reproduces the kernel table's bound column at Cone size,
and the bytes bound is the larger at both configurations' sizes."""
import pytest

from stereo_bench import roofline

CONE = (375, 450, 64)
KITTI = (375, 1242, 256)


def test_cone_bounds_match_the_kernel_table():
    # PERF.md's kernel table: B1 0.0268 ms, B2 0.0290 ms (bytes)
    assert round(roofline.BOUNDS["B1"](*CONE) * 1e3, 4) == 0.0268
    assert round(roofline.BOUNDS["B2"](*CONE) * 1e3, 4) == 0.0290
    assert roofline.b1_bytes(*CONE) == 8 * 64 * 375 * 450 + 20 * 375 * 450


@pytest.mark.parametrize("shape", [CONE, KITTI])
def test_bytes_bound_the_work_whatever_the_arms(shape):
    b1 = roofline.bytes_bound_s(roofline.b1_bytes(*shape))
    b2 = roofline.bytes_bound_s(roofline.b2_bytes(*shape))
    assert roofline.ops_bound_s(roofline.b1_ops_max(*shape)) < b1
    assert roofline.ops_bound_s(roofline.b2_ops(*shape)) < b2
    assert roofline.BOUNDS["B1"](*shape) == b1
    assert roofline.BOUNDS["B2"](*shape) == b2


def test_kitti_is_eleven_cones():
    h, w, d = KITTI
    ratio = (h * w * d) / (375 * 450 * 64)
    assert ratio == pytest.approx(11.04, abs=0.01)
    assert 4 * h * w * d == 476_928_000  # one float32 volume, bytes
