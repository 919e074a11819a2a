"""Kernels C1 (census) and C2 (the cost volume), csrc/cost.cu, on the CPU:
C2's tables reproduce every cost of the plain version bitwise; a
block-by-block emulation of C2 (the right columns and census words each
block stages, clamped, in the kernel's layout; each thread's window of
right pixels shifted plane by plane; out-of-image planes; d0, d_count,
real_w and a negative min_disparity) and a block-by-block emulation of C1
(the tile and its halo, zero outside the array, the border judged in the
image's coordinates) are bitwise the plain versions and within
test_torch_cost.py's tolerance of the JAX package's functions."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import cost as cost_ops
from adcensus_torch.stages import cost as torch_cost
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import cost as jax_cost

SOURCE = (Path(cost_ops.__file__).resolve().parent.parent / "csrc"
          / "cost.cu").read_text()
MASK63 = np.uint64((1 << 63) - 1)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_emulation_constants_are_the_kernels():
    assert (_constant("kCensusTx"), _constant("kCensusTy"),
            _constant("kTile"), _constant("kPlanes"), _constant("kAdValues"),
            _constant("kCenValues")) == (
        cost_ops.CENSUS_TX, cost_ops.CENSUS_TY, cost_ops.TILE,
        cost_ops.PLANES, cost_ops.AD_VALUES, cost_ops.CEN_VALUES)


@pytest.mark.parametrize("lam_ad,lam_cen", [(10, 30), (3, 50), (25, 7)])
def test_tables_give_the_plain_cost(lam_ad, lam_cen):
    """For every AD sum k in 0..765 and Hamming distance h in 0..63,
    ad_table[k] - cen_table[h] is compute_cost_planes_plain's cost
    bitwise: one plane whose pixel (k, h) has those two values."""
    k = np.arange(cost_ops.AD_VALUES)
    h = np.arange(cost_ops.CEN_VALUES)
    # left - right = k spread over the channels; right is 0
    chans = np.stack([np.clip(k - 255 * c, 0, 255) for c in range(3)], -1)
    left = np.broadcast_to(chans[:, None, :], (k.size, h.size, 3))
    census_l = np.broadcast_to(((1 << h) - 1)[None, :], (k.size, h.size))
    opts = ADCensusOptions(min_disparity=0, max_disparity=1,
                           lambda_ad=lam_ad, lambda_census=lam_cen)
    plain = torch_cost.compute_cost_planes_plain(
        torch.as_tensor(left.astype(np.uint8)),
        torch.zeros((k.size, h.size, 3), dtype=torch.uint8),
        torch.as_tensor(census_l.astype(np.int64)),
        torch.zeros((k.size, h.size), dtype=torch.int64), opts, 0, 1,
        h.size)[0]
    ad_table, cen_table = torch_cost.cost_tables(opts, "cpu")
    assert ad_table.shape == (cost_ops.AD_VALUES,)
    assert cen_table.shape == (cost_ops.CEN_VALUES,)
    tables = ad_table[:, None] - cen_table[None, :]
    assert torch.equal(tables.view(torch.int32), plain.view(torch.int32))


def _rgb_words(img):
    """(..., 3) uint8 -> the kernel's packed RGB words, R in the low
    byte."""
    img = img.astype(np.uint32)
    return img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)


def _abs_sum(a, b):
    """__vsadu4 of two packed words: the sum of the bytes' |differences|."""
    return sum(np.abs(((a >> s) & 255).astype(np.int64)
                      - ((b >> s) & 255).astype(np.int64))
               for s in (0, 8, 16, 24))


def emulate_cost_volume(left, right, census_l, census_r, ad_table, cen_table,
                        d_first, d_count, real_w):
    """csrc/cost.cu cost_volume_kernel, block by block; each block's
    threads at once. Returns the volume and, for every output, the image
    column whose staged pixel and census word it read."""
    h, w, _ = left.shape
    v, threads = cost_ops.cost_volume_geometry(w)
    tile, planes = cost_ops.TILE, cost_ops.PLANES
    span = tile + planes - 1
    lane = -(-span // v)
    out = np.full((d_count, h, w), np.nan, np.float32)
    read = np.full((d_count, h, w), -1, np.int64)
    l_rgb, r_rgb = _rgb_words(left), _rgb_words(right)
    cen_l = census_l.astype(np.uint64)
    cen_r = census_r.astype(np.uint64)

    def at(s):
        assert (s >= 0).all() and (s < span).all()
        return (s % v) * lane + s // v

    for y in range(h):
        for tx0 in range(0, w, tile):
            for i0 in range(0, d_count, planes):
                n_planes = min(planes, d_count - i0)
                # staging: column s of the block is lo + s, clamped
                lo = tx0 - (d_first + i0) - (planes - 1)
                s = np.arange(span)
                s_col = np.full(v * lane, -1, np.int64)
                s_col[at(s)] = np.clip(lo + s, 0, w - 1)
                s_rgb = np.zeros(v * lane, np.uint32)
                s_cen = np.zeros(v * lane, np.uint64)
                s_rgb[at(s)] = r_rgb[y, s_col[at(s)]]
                s_cen[at(s)] = cen_r[y, s_col[at(s)]]
                t = np.arange(threads)
                xg = tx0 + v * t
                t, xg = t[xg < w], xg[xg < w]
                j = np.arange(v)
                cols = xg[:, None] + j[None, :]  # (threads, V)
                assert (cols < w).all()  # V divides w
                s0 = v * t + (planes - 1)
                win = at(s0[:, None] + j[None, :])
                for i in range(n_planes):
                    d = d_first + i0 + i
                    xr = cols - d
                    k = _abs_sum(l_rgb[y, cols], s_rgb[win])
                    hd = np.bitwise_count(
                        (cen_l[y, cols] ^ s_cen[win]) & MASK63)
                    cost = ad_table[k] - cen_table[hd]
                    out[i0 + i, y, cols] = np.where(
                        (xr < 0) | (xr >= real_w), np.float32(1.0), cost)
                    read[i0 + i, y, cols] = s_col[win]
                    # the window shifts one column left, one new read
                    win = np.concatenate(
                        [at(np.maximum(s0 - (i + 1), 0))[:, None],
                         win[:, :-1]], axis=1)
    assert not np.isnan(out).any()
    return out, read


def _images(h, w, seed):
    """Seeded RGB pairs whose right image is the left moved by 3 columns
    plus noise, so that costs span both low and high values."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1).astype(np.int64)
    right = np.clip(right + rng.integers(-8, 9, right.shape), 0, 255)
    return left, right.astype(np.uint8)


# (H, W, min_disparity, max_disparity, d0, d_count, real_w or None):
# widths of each kind of V, tiles with a partial last one, plane chunks
# with a partial last one, negative disparities, a rank's block of
# planes, padded images, images narrower than a chunk's reach
COST_CASES = {
    "w%4 two tiles": (2, 520, 0, 40, 0, 40, None),
    "w%2 three tiles": (2, 1030, 0, 70, 0, 70, None),
    "w%2 one tile": (3, 298, 0, 20, 0, 20, None),
    "odd width": (2, 513, -5, 27, 0, 32, None),
    "negative min": (3, 64, -20, 12, 0, 32, None),
    "planes from d0": (3, 130, 0, 64, 17, 20, None),
    "negative min from d0": (2, 97, -9, 55, 33, 31, None),
    "padded real_w": (3, 136, -3, 29, 0, 32, 130),
    "padded odd real_w": (2, 140, -6, 40, 5, 30, 133),
    "narrow": (3, 6, 0, 10, 0, 10, None),
    "one column": (2, 1, -2, 3, 0, 5, None),
    "D beyond W": (2, 20, 0, 40, 0, 40, None),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_volume_emulation(case):
    h, w, d_min, d_max, d0, d_count, real_w = COST_CASES[case]
    left, right = _images(h, w, seed=len(case))
    gl = torch_cost.compute_gray_host64(left)
    gr = torch_cost.compute_gray_host64(right)
    cl = torch_cost.census_transform_9x7(torch.as_tensor(gl))
    cr = torch_cost.census_transform_9x7(torch.as_tensor(gr))
    opts = ADCensusOptions(min_disparity=d_min, max_disparity=d_max)
    rw = w if real_w is None else real_w
    ad_table, cen_table = torch_cost.cost_tables(opts, "cpu")
    ours, read = emulate_cost_volume(
        left, right, cl.numpy(), cr.numpy(), ad_table.numpy(),
        cen_table.numpy(), d0 + d_min, d_count, rw)
    xr = (np.arange(w)[None, :]
          - (np.arange(d0, d0 + d_count) + d_min)[:, None])
    assert (read == np.clip(xr, 0, w - 1)[:, None, :]).all()
    plain = torch_cost.compute_cost_planes(
        torch.as_tensor(left), torch.as_tensor(right), cl, cr, opts, d0,
        d_count, real_w).numpy()
    np.testing.assert_array_equal(ours.view(np.int32), plain.view(np.int32))
    oob = (xr < 0) | (xr >= rw)
    assert (ours[np.broadcast_to(oob[:, None, :], ours.shape)] == 1.0).all()
    if real_w is None:  # JAX's planes take no real_w
        ref = np.asarray(jax_cost.compute_cost_planes(
            jnp.asarray(left), jnp.asarray(right),
            jax_cost.census_transform_9x7(jnp.asarray(gl)),
            jax_cost.census_transform_9x7(jnp.asarray(gr)),
            JaxOptions(min_disparity=d_min, max_disparity=d_max), d0,
            d_count))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def emulate_census(gray, row_offset, full_h, full_w):
    """csrc/cost.cu census_kernel, block by block: the block's tile and
    its halo staged, zero outside the array, then each thread's 63
    comparisons, the first at bit 62."""
    h, w = gray.shape
    tx, ty = cost_ops.CENSUS_TX, cost_ops.CENSUS_TY
    out = np.full((h, w), -1, np.int64)
    for y0 in range(0, h, ty):
        for x0 in range(0, w, tx):
            tile = np.zeros((ty + 8, tx + 6), np.uint8)
            gy = y0 - 4 + np.arange(ty + 8)[:, None]
            gx = x0 - 3 + np.arange(tx + 6)[None, :]
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            tile[inside] = gray[np.broadcast_to(gy, inside.shape)[inside],
                                np.broadcast_to(gx, inside.shape)[inside]]
            center = tile[4 : 4 + ty, 3 : 3 + tx]
            sig = np.zeros((ty, tx), np.int64)
            for r in range(9):
                for c in range(7):
                    less = tile[r : r + ty, c : c + tx] < center
                    sig = (sig << 1) | less.astype(np.int64)
            y = y0 + np.arange(ty)[:, None]
            x = x0 + np.arange(tx)[None, :]
            iy = row_offset + y
            valid = ((full_w > 9) & (full_h > 7) & (iy >= 4)
                     & (iy < full_h - 4) & (x >= 3) & (x < full_w - 3))
            sig = np.where(valid, sig, 0)
            keep = (y < h) & (x < w)
            out[np.broadcast_to(y, keep.shape)[keep],
                np.broadcast_to(x, keep.shape)[keep]] = sig[keep]
    assert (out >= 0).all()
    return out


# (H, W, row_offset, full_h, full_w): whole images, among them 9 wide and
# 7 tall (all zero) and one pixel; several blocks with partial last ones;
# row slabs of a 40x70 image at the top (4 rows of zero context above, as
# the sharded layer pads), in the middle and at the bottom; padded columns
CENSUS_CASES = {
    "7 tall": (7, 30, 0, 7, 30),
    "8 tall": (8, 30, 0, 8, 30),
    "9 wide": (20, 9, 0, 20, 9),
    "10 wide": (20, 10, 0, 20, 10),
    "one pixel": (1, 1, 0, 1, 1),
    "blocks": (13, 130, 0, 13, 130),
    "partial blocks": (33, 65, 0, 33, 65),
    "slab top": (18, 70, -4, 40, 70),
    "slab middle": (16, 70, 10, 40, 70),
    "slab bottom": (14, 70, 30, 40, 70),
    "padded columns": (20, 72, 0, 20, 66),
}


@pytest.mark.parametrize("case", sorted(CENSUS_CASES))
def test_census_emulation(case):
    h, w, row_offset, full_h, full_w = CENSUS_CASES[case]
    rng = np.random.default_rng(h * 1000 + w)
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    # ties too: a flat patch
    gray[h // 3 : h // 3 + 3, w // 4 : w // 4 + 5] = 128
    ours = emulate_census(gray, row_offset, full_h, full_w)
    plain = torch_cost.census_transform_9x7_plain(
        torch.as_tensor(gray), row_offset, full_h, full_w).numpy()
    np.testing.assert_array_equal(ours, plain)
    ref = jax_cost.census_packed_to_u64(np.asarray(
        jax_cost.census_transform_9x7(jnp.asarray(gray),
                                      row_offset=row_offset, full_h=full_h,
                                      full_w=full_w)))
    np.testing.assert_array_equal(ours.astype(np.uint64), ref)
    if full_w <= 9 or full_h <= 7:
        assert not ours.any()
