"""Kernel B5's grid of test cases and their seeded inputs, shared by the
CPU emulation tests (test_torch_band_mm_geometry.py) and the card tests
(test_torch_cuda.py). Imports numpy, torch and the port only."""
import numpy as np
import torch

from adcensus_torch.ops import band_mm

# (Dp, Np, Mp, PAD, mask): a random 0/1 mask of that density, not an
# interval, or "intervals" (make_blocked_masks on random arms up to the
# largest arm of the PAD). Mp 384 ends in a 128-wide tail block, Mp 200
# in a block of rows that are not a multiple of 16 bytes; Dp 12 leaves
# the last 8-plane group half full; PAD 64, 128 and 256 give WK 384, 512
# and 768.
CASES = {
    "density0": (8, 3, 384, 64, 0.0),
    "density3": (12, 4, 384, 64, 0.03),
    "density30": (12, 3, 384, 128, 0.3),
    "density100": (8, 2, 384, 64, 1.0),
    "density30_pad256": (8, 2, 256, 256, 0.3),
    "density30_width200": (8, 3, 200, 64, 0.3),
    "intervals64": (12, 8, 384, 64, "intervals"),
    "intervals128": (8, 8, 256, 128, "intervals"),
    "intervals256": (12, 4, 384, 256, "intervals"),
}


def signed_volume(rng, shape):
    """float32 values of both signs over six decades, with 10 % +0.0 and
    10 % -0.0."""
    v = (rng.random(shape, np.float32) * 2 - 1) * np.float32(10.0) ** (
        rng.integers(-3, 3, shape)).astype(np.float32)
    u = rng.random(shape)
    v[u < 0.1] = 0.0
    v[u > 0.9] = -0.0
    return v.astype(np.float32)


def interval_mask(rng, np_, mp, pad):
    """make_blocked_masks' horizontal mask for random arms of an np_ x mp
    image: arms up to the largest the PAD covers, clipped to the border."""
    max_arm = pad
    xx = np.arange(mp)[None, :] * np.ones((np_, 1), int)
    left = np.minimum(rng.integers(0, max_arm + 1, (np_, mp)), xx)
    right = np.minimum(rng.integers(0, max_arm + 1, (np_, mp)), mp - 1 - xx)
    zeros = np.zeros((np_, mp), int)
    arms = torch.as_tensor(
        np.stack([left, right, zeros, zeros], axis=-1).astype(np.int32))
    masks = band_mm.make_blocked_masks(arms, max_arm, np_, mp)
    assert masks.pad_w == pad
    return masks.mh.numpy()


def case_inputs(case, seed=None):
    """(vol_m, mask, pad) of a case of CASES as numpy arrays, seeded by its
    size unless ``seed`` is given: a signed margined volume (margins
    included, since a random mask selects them) and its int8 mask."""
    dp, np_, mp, pad, kind = CASES[case]
    rng = np.random.default_rng(dp * np_ + mp + pad if seed is None else seed)
    length = -(-mp // 256) * 256 + 2 * pad
    vol_m = signed_volume(rng, (dp, np_, length))
    if kind == "intervals":
        mask = interval_mask(rng, np_, mp, pad)
    else:
        wk = 256 + 2 * pad
        mask = (rng.random((np_, wk, mp)) < kind).astype(np.int8)
    return vol_m, mask, pad
