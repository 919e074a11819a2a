"""Both scenes at their configurations' sizes: for every left pixel
visible in both views, right(y, x - gt) = left(y, x)."""
import json

import numpy as np
import pytest

from conftest import ROOT
from stereo_bench import harness


def visible_in_both(gt: np.ndarray) -> np.ndarray:
    """Left pixels whose surface the right view shows: inside the right
    image, and nearest (largest gt) of the left pixels that map to the
    same right pixel."""
    h, w = gt.shape
    d = gt.astype(np.int64)
    xr = np.arange(w)[None, :] - d
    inside = xr >= 0
    nearest = np.full((h, w), -1, np.int64)
    rows = np.broadcast_to(np.arange(h)[:, None], (h, w))
    np.maximum.at(nearest, (rows[inside], xr[inside]), d[inside])
    vis = np.zeros((h, w), bool)
    vis[inside] = nearest[rows[inside], xr[inside]] == d[inside]
    return vis


def pool(config: str, n: int = 2):
    spec = harness.load_spec(ROOT)
    cell = next(harness.Cell.from_spec(spec, w["name"])
                for w in spec["workloads"] if w["config"] == config)
    cell.traffic = dict(cell.traffic, pool_pairs=n)
    return cell, harness.make_pool(cell, 2 ** 31 + 11)


@pytest.mark.parametrize("config", ["middlebury2003-cones", "kitti2015"])
def test_right_view_matches_left_where_visible(config):
    cell, (lefts, rights, gts) = pool(config)
    h, w = cell.config["height"], cell.config["width"]
    for left, right, gt in zip(lefts, rights, gts):
        assert left.shape == right.shape == (h, w, 3)
        assert left.dtype == right.dtype == np.uint8
        assert gt.dtype == np.float32 and np.all(gt == np.floor(gt))
        assert gt.max() < cell.config["max_disparity"] - 1
        vis = visible_in_both(gt)
        y, x = np.nonzero(vis)
        np.testing.assert_array_equal(right[y, x - gt[y, x].astype(int)],
                                      left[y, x])
        assert 0.5 < vis.mean() < 1.0  # real occlusions, mostly visible
    assert not np.array_equal(lefts[0], lefts[1])


def test_street_has_its_layers():
    """The rig's geometry: the road rises B / h = 0.327 px a row below the
    principal row, to 65 at the bottom; the background at 60 m is d 6; the
    nearest car, 8 m away, is d 48, 151 px wide and 133 tall."""
    from stereo_bench.scenes import street
    cell, (lefts, _, gts) = pool("kitti2015", 1)
    p = cell.config["scene_params"]
    gt = gts[0]
    assert gt.max() == 65 and gt.min() == 6
    assert street.background_disparity(p) == 6
    assert np.all(gt[:175, 1240] == 6)                     # background
    assert np.all(np.diff(gt[:, 1240]) >= 0)
    assert gt[374, 1240] == np.floor((374 - 172.854) * 0.54 / 1.65)
    near = street.vehicles(375, 1242, p)[0]
    assert near == (189, 322, 40, 191, 48)
    assert gt[250, 100] == 48
    assert len(np.unique(gt[200])) == 6  # the road and five cars


def test_street_refuses_overlapping_vehicles():
    from stereo_bench.scenes import street
    cfg = json.loads((ROOT / "stereo_bench/configs/kitti2015.json").read_text())
    p = dict(cfg["scene_params"], vehicles=[[100, 12.0], [150, 12.0]])
    with pytest.raises(ValueError, match="overlap"):
        street.vehicles(375, 1242, p)
    with pytest.raises(ValueError, match="outside"):
        street.vehicles(375, 1242, dict(p, vehicles=[[100, 2.0]]))


def test_two_layer_is_the_ports_synthetic_pair():
    from adcensus_torch.synthetic import two_layer_pair
    from stereo_bench.scenes import two_layer
    got = two_layer.make(375, 450, {"d_bg": 16, "d_fg": 32},
                         np.random.default_rng(0))
    for a, b in zip(got, two_layer_pair(375, 450, 16, 32, seed=0)):
        np.testing.assert_array_equal(a, b)
