"""A seeded synthetic stereo scene with known ground truth.

Two fronto-parallel layers: a smoothed random-RGB background at disparity
``d_bg`` and a rectangle of another texture at disparity ``d_fg`` in front
of it. The right image is rendered so that right(y, x - d) = left(y, x)
for every left pixel visible in both views; background pixels just right
of the rectangle are hidden in the right view, so the pair has real
occlusions for the LR check, voting and interpolation to act on.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


BLOCK = 8       # side of the texture's constant-color blocks
NOISE = 8       # per-channel noise amplitude on top of the blocks


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Random RGB in BLOCK x BLOCK blocks plus +-NOISE per channel: the
    blocks stay under the arms' color threshold (cross_t1 = 20), so cross
    arms and voting regions span several pixels, while the noise gives
    the census windows texture."""
    c = rng.integers(0, 256, size=(h // BLOCK + 1, w // BLOCK + 1, 3))
    c = np.repeat(np.repeat(c, BLOCK, 0), BLOCK, 1)[:h, :w]
    n = rng.integers(-NOISE, NOISE + 1, size=(h, w, 3))
    return np.clip(c + n, 0, 255).astype(np.uint8)


def two_layer_pair(
    h: int, w: int, d_bg: int, d_fg: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left, right, gt): two (h, w, 3) uint8 images and the (h, w)
    float32 left-view ground-truth disparity."""
    rng = np.random.default_rng(seed)
    # textures are indexed by left-image column; the right view reads the
    # background up to d_bg columns beyond the left's right edge
    bg = _texture(rng, h, w + d_bg)
    fg = _texture(rng, h, w + d_fg)
    y0, y1 = h // 4, (3 * h) // 4
    x0, x1 = w // 3, (2 * w) // 3

    in_rect = np.zeros((h, w), bool)
    in_rect[y0:y1, x0:x1] = True
    left = np.where(in_rect[..., None], fg[:, :w], bg[:, :w])
    gt = np.where(in_rect, np.float32(d_fg), np.float32(d_bg))

    xr = np.arange(w)
    # right(y, xr) shows the rectangle where xr + d_fg falls inside it
    rect_cols = (xr + d_fg >= x0) & (xr + d_fg < x1)
    rect_r = np.zeros((h, w), bool)
    rect_r[y0:y1] = rect_cols[None, :]
    right = np.where(
        rect_r[..., None], fg[:, xr + d_fg], bg[:, xr + d_bg]
    )
    return (
        np.ascontiguousarray(left, dtype=np.uint8),
        np.ascontiguousarray(right, dtype=np.uint8),
        gt.astype(np.float32),
    )


def bad_pct(disp: np.ndarray, gt: np.ndarray, delta: float = 2.0) -> float:
    """Percentage of pixels with |disp - gt| > delta; invalid (non-finite)
    disparities count as bad (the Middlebury bad-delta convention)."""
    valid = np.isfinite(disp)
    bad = ~valid | (np.abs(np.where(valid, disp, 0.0) - gt) > delta)
    return float(bad.mean()) * 100.0
