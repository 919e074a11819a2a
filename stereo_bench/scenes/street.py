"""A street seen from a car, at the KITTI 2015 frame size, with its
geometry taken from the rig's calibration: ``focal_px`` and
``principal_row`` of the rectified left camera, the ``baseline_m``
between the cameras and the cameras' height above the road,
``camera_height_m``.

* The road is a flat plane under cameras looking along it: at row y
  below the principal row its disparity is ``baseline_m /
  camera_height_m * (y - principal_row)``, floored to whole pixels, so
  that every surface maps exactly onto the other view.
* A far background (buildings, trees) stands at ``background_distance_m``
  at disparity floor(focal_px * baseline_m / distance); it covers every
  row where the road would lie farther than it, the sky included.
* ``vehicles``: boxes given as [first column, distance in m]. A box
  stands on the road at the row where the road is that far (the
  principal row + focal_px * camera_height_m / distance), at the road's
  disparity there, ``vehicle_width_m`` wide and ``vehicle_height_m``
  tall at that disparity, cut at the image's edges.

Nearer surfaces are drawn over farther ones in both views, so the right
view has real occlusions beside every vehicle. right(y, x - gt) =
left(y, x) for every left pixel visible in both views. The vehicles may
not overlap in either view (a ValueError says which do): then the
nearest surface in the left view at a right pixel is the one the right
view shows.
"""
from __future__ import annotations

import numpy as np

from stereo_bench.scenes import texture as _tex


def background_disparity(params: dict) -> int:
    return int(np.floor(params["focal_px"] * params["baseline_m"]
                        / params["background_distance_m"]))


def base_disparity(params: dict, rows: np.ndarray) -> np.ndarray:
    """Whole-pixel disparity of the road, or of the background where the
    road lies beyond it, at ``rows``."""
    slope = params["baseline_m"] / params["camera_height_m"]
    road = np.floor((np.asarray(rows, np.float64) - params["principal_row"])
                    * slope).astype(np.int64)
    return np.maximum(road, background_disparity(params))


def vehicles(h: int, w: int, params: dict):
    """[(row0, row1, col0, col1, d)] of each vehicle, rows and columns
    half-open, in the left view."""
    out = []
    per_disparity = 1.0 / params["baseline_m"]   # metres to pixels at d
    for x0, distance in params["vehicles"]:
        foot = int(params["principal_row"]
                   + params["focal_px"] * params["camera_height_m"] / distance)
        if not 0 <= foot < h:
            raise ValueError(f"a vehicle at {distance} m stands on row "
                             f"{foot}, outside the image")
        d = int(base_disparity(params, np.array(foot)))
        width = int(round(params["vehicle_width_m"] * per_disparity * d))
        height = int(round(params["vehicle_height_m"] * per_disparity * d))
        out.append((max(0, foot - height + 1), foot + 1,
                    max(0, x0), min(w, x0 + width), d))
    for view, shift in (("left", 0), ("right", 1)):
        spans = sorted((c0 - shift * d, c1 - shift * d)
                       for _, _, c0, c1, d in out)
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            if b0 < a1:
                raise ValueError(f"vehicles overlap in the {view} view: "
                                 f"columns [{a0}, {a1}) and [{b0}, {b1})")
    return out


def make(h: int, w: int, params: dict, rng: np.random.Generator):
    """(left, right, gt): two (h, w, 3) uint8 images and the (h, w)
    float32 left-view ground-truth disparity."""
    rows = np.arange(h)
    d_base = base_disparity(params, rows)
    if d_base.min() < 0:
        raise ValueError("negative disparity")
    boxes = vehicles(h, w, params)
    base = _tex.texture(rng, h, w + int(d_base.max()) + 1)
    boxtex = _tex.texture(rng, h, w)

    cols = np.arange(w)
    left = base[:, :w].copy()
    gt = np.broadcast_to(d_base[:, None], (h, w)).astype(np.float32)
    # right view: the base surface at x = xr + d_base(y), then vehicles
    right = base[rows[:, None], cols[None, :] + d_base[:, None]]
    for r0, r1, c0, c1, d in boxes:
        left[r0:r1, c0:c1] = boxtex[r0:r1, c0:c1]
        gt[r0:r1, c0:c1] = d
        lo, hi = max(0, c0 - d), c1 - d
        if hi > lo:
            right[r0:r1, lo:hi] = boxtex[r0:r1, lo + d:hi + d]
    return (np.ascontiguousarray(left), np.ascontiguousarray(right),
            np.ascontiguousarray(gt))
