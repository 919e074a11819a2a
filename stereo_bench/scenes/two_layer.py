"""Two fronto-parallel layers: a textured background at disparity
``d_bg`` and a rectangle of another texture at ``d_fg`` in front of it,
over the middle third of the columns and the middle half of the rows.
A copy of ``adcensus_torch/synthetic.py:two_layer_pair``, the scene the
port's kernel table was measured on.

The right image is rendered so that right(y, x - d) = left(y, x) for
every left pixel visible in both views; background pixels just left of
the rectangle are hidden in the right view, so the pair has real
occlusions for the LR check, voting and interpolation to act on.
"""
from __future__ import annotations

import numpy as np

from stereo_bench.scenes import texture as _tex


def make(h: int, w: int, params: dict, rng: np.random.Generator):
    """(left, right, gt): two (h, w, 3) uint8 images and the (h, w)
    float32 left-view ground-truth disparity."""
    d_bg, d_fg = int(params["d_bg"]), int(params["d_fg"])
    bg = _tex.texture(rng, h, w + d_bg)
    fg = _tex.texture(rng, h, w + d_fg)
    y0, y1 = h // 4, (3 * h) // 4
    x0, x1 = w // 3, (2 * w) // 3

    in_rect = np.zeros((h, w), bool)
    in_rect[y0:y1, x0:x1] = True
    left = np.where(in_rect[..., None], fg[:, :w], bg[:, :w])
    gt = np.where(in_rect, np.float32(d_fg), np.float32(d_bg))

    xr = np.arange(w)
    rect_cols = (xr + d_fg >= x0) & (xr + d_fg < x1)
    rect_r = np.zeros((h, w), bool)
    rect_r[y0:y1] = rect_cols[None, :]
    right = np.where(rect_r[..., None], fg[:, xr + d_fg], bg[:, xr + d_bg])
    return (np.ascontiguousarray(left, dtype=np.uint8),
            np.ascontiguousarray(right, dtype=np.uint8),
            gt.astype(np.float32))
