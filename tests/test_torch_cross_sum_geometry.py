"""Launch geometry of kernel B1 (ops/cross_sum.py:cross_sum_geometry) on
the CPU: the first-pass buffer fits the H100's shared memory and holds
halos of max_arm, the grid fills the card at Cone size, what cannot fit
raises; and a tile-by-tile emulation of csrc/cross_sum.cu (data-dependent
halos, the first pass kept per tile, terms skipped outside each arm)
equals cross_pass_plain bitwise."""
import numpy as np
import pytest
import torch

from adcensus_torch.ops.cross_sum import (
    SMEM_LIMIT, cross_pass_plain, cross_sum_geometry, plane_capacity,
)
from adcensus_torch.stages.aggregate import support_counts

H, W, D = 375, 450, 64
SHAPES = [(H, W), (1, 1), (1, 450), (375, 1), (7, 5), (600, 2000)]


@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("max_arm", [0, 7, 34, 100, 255])
@pytest.mark.parametrize("d", [1, 3, 64, 1024])
def test_geometry_fits_and_holds_halos(d, max_arm, horizontal_first):
    for h, w in SHAPES:
        tx, ty, planes, threads, smem = cross_sum_geometry(
            d, h, w, max_arm, horizontal_first)
        assert 1 <= tx <= w and 1 <= ty <= h
        assert planes in (1, 2, 4, 8) and planes <= d
        assert threads % 32 == 0 and 32 <= threads <= 512
        cap = plane_capacity(h, w, max_arm, horizontal_first, tx, ty)
        assert smem == 4 * planes * cap <= SMEM_LIMIT
        # the first-pass buffer holds the tile and max_arm on both sides of
        # it along the second axis, or that whole axis of the image
        if horizontal_first:
            assert cap >= tx * min(ty + 2 * max_arm, h)
        else:
            assert cap >= ty * min(tx + 2 * max_arm, w)


@pytest.mark.parametrize("horizontal_first", [True, False])
def test_geometry_fills_the_card_at_cone_size(horizontal_first):
    tx, ty, planes = cross_sum_geometry(D, H, W, 34, horizontal_first)[:3]
    blocks = -(-W // tx) * -(-H // ty) * -(-D // planes)
    assert blocks >= 132


@pytest.mark.parametrize("args", [
    (0, H, W, 34, True), (D, 0, W, 34, False), (D, H, 0, 34, True),
    (1, 2 ** 16, 2 ** 15, 34, True),       # H*W = 2^31
    (1, 60_000, 10, 30_000, True),         # halos too long for any tile
    (1, 10, 60_000, 30_000, False),
])
def test_geometry_rejects_impossible(args):
    with pytest.raises(ValueError):
        cross_sum_geometry(*args)


def test_geometry_takes_the_longest_arms_on_large_images():
    """MAX_ARM_LENGTH (255) fits large and long images in either order,
    and halos of 30,000 fit where the image is short along the second
    axis."""
    for h, w in ((4000, 4000), (60_000, 30), (30, 60_000)):
        for hf in (True, False):
            assert cross_sum_geometry(8, h, w, 255, hf)[-1] <= SMEM_LIMIT
    assert cross_sum_geometry(1, 10, 60_000, 30_000, True)[:3] == (32, 10, 1)


def _window_sum(src, lo, hi, origin, axis):
    """For each cell of a (rows, cols) region whose top-left cell is
    ``origin`` in the (D, n_y, n_x) ``src``: the sum of ``src`` along
    ``axis`` (1: y, 2: x) at offsets -lo .. hi, from +0.0 in ascending
    offset, skipping every offset outside the cell's arm. Asserts that no
    term lies outside ``src``."""
    rows, cols = lo.shape
    r = torch.arange(rows)[:, None] + origin[0]
    c = torch.arange(cols)[None, :] + origin[1]
    acc = torch.zeros(src.shape[0], rows, cols)
    for t in range(-int(lo.max()), int(hi.max()) + 1):
        take = (t >= -lo) & (t <= hi)
        y = (r + t if axis == 1 else r).expand(rows, cols)
        x = (c + t if axis == 2 else c).expand(rows, cols)
        inside = (y >= 0) & (y < src.shape[1]) & (x >= 0) & (x < src.shape[2])
        assert inside[take].all()
        val = src[:, y.clamp(0, src.shape[1] - 1), x.clamp(0, src.shape[2] - 1)]
        acc = torch.where(take, acc + val, acc)
    return acc


def emulate_kernel(vol, arms, sup, horizontal_first, max_arm, normalize,
                   geometry):
    """csrc/cross_sum.cu, one output tile at a time: the tile's halo from
    its second-axis arms; the first-axis sums of the tile and halo from
    the volume into a buffer no larger than the kernel's; the second-axis
    sums from that buffer alone (``_window_sum`` asserts it)."""
    d, h, w = vol.shape
    tile_x, tile_y = geometry[:2]
    cap = plane_capacity(h, w, max_arm, horizontal_first, tile_x, tile_y)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    lr = (arms[..., 0].clamp(max=max_arm).minimum(xx),
          arms[..., 1].clamp(max=max_arm).minimum(w - 1 - xx))
    tb = (arms[..., 2].clamp(max=max_arm).minimum(yy),
          arms[..., 3].clamp(max=max_arm).minimum(h - 1 - yy))
    (lo1, hi1), (lo2, hi2) = (lr, tb) if horizontal_first else (tb, lr)
    ax1, ax2 = (2, 1) if horizontal_first else (1, 2)  # axes of (D, H, W)
    out = torch.empty_like(vol)
    for y0 in range(0, h, tile_y):
        for x0 in range(0, w, tile_x):
            tile = (slice(y0, y0 + tile_y), slice(x0, x0 + tile_x))
            th, tw = lo2[tile].shape
            # how far the second-axis arms reach beyond the tile
            pos = torch.arange(lo2[tile].shape[ax2 - 1])
            pos = pos[:, None] if ax2 == 1 else pos[None, :]
            halo_lo = max(int((lo2[tile] - pos).max()), 0)
            halo_hi = max(int((hi2[tile] - (pos.max() - pos)).max()), 0)
            if horizontal_first:
                ry0, rx0 = y0 - halo_lo, x0
                rows, cols = th + halo_lo + halo_hi, tw
                inner = (halo_lo, 0)
            else:
                ry0, rx0 = y0, x0 - halo_lo
                rows, cols = th, tw + halo_lo + halo_hi
                inner = (0, halo_lo)
            assert rows * cols <= cap
            region = (slice(ry0, ry0 + rows), slice(rx0, rx0 + cols))
            buf = _window_sum(vol, lo1[region], hi1[region], (ry0, rx0), ax1)
            res = _window_sum(buf, lo2[tile], hi2[tile], inner, ax2)
            if normalize:
                res = res / sup[tile]
            out[(slice(None),) + tile] = res
    return out


def _arms(rng, h, w, max_arm, kind):
    """int32 (H, W, 4) arms up to ``max_arm``, clipped to the border:
    random, or 0 and max_arm on alternate 8x8 squares (sharp changes of
    halo from tile to tile)."""
    yy, xx = np.mgrid[:h, :w]
    if kind == "random":
        raw = rng.integers(0, max_arm + 1, (4, h, w))
    else:
        raw = np.broadcast_to(((yy // 8 + xx // 8) % 2) * max_arm, (4, h, w))
    border = (xx, w - 1 - xx, yy, h - 1 - yy)
    return torch.as_tensor(np.stack(
        [np.minimum(raw[k], border[k]) for k in range(4)], axis=-1
    ).astype(np.int32))


# (D, H, W, max_arm, arms, normalize, (tile_x, tile_y) or None for the
# default geometry)
EMULATION_CASES = {
    "partial_tiles": (3, 37, 70, 9, "random", True, None),
    "smaller_than_tile": (2, 5, 7, 4, "random", True, None),
    "one_row": (2, 1, 40, 5, "random", True, None),
    "one_column": (2, 40, 1, 5, "random", True, None),
    "sharp_halos": (2, 40, 70, 12, "squares", True, (8, 8)),
    "arm_over_tile": (2, 50, 60, 40, "random", True, (8, 8)),
    "arm_zero": (2, 20, 30, 0, "random", True, (8, 4)),
    "unnormalized": (3, 29, 41, 6, "random", False, (16, 8)),
}


@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_emulated_kernel_equals_plain(case, horizontal_first):
    d, h, w, max_arm, kind, normalize, tile = EMULATION_CASES[case]
    rng = np.random.default_rng(d + h + w)
    vol = torch.as_tensor(rng.random((d, h, w), np.float32) * 2)
    arms = _arms(rng, h, w, max_arm, kind)
    sup_h, sup_v = support_counts(arms, max_arm)
    sup = (sup_h if horizontal_first else sup_v).float()
    geometry = cross_sum_geometry(d, h, w, max_arm, horizontal_first)
    if tile is not None:
        geometry = tile + geometry[2:]
    args = (vol, arms, sup, horizontal_first, max_arm, normalize)
    ours = emulate_kernel(*args, geometry)
    ref = cross_pass_plain(*args)
    assert torch.equal(ours.view(torch.int32), ref.view(torch.int32))
