"""Launch geometry of kernel B3 (ops/region_vote.py:region_vote_geometry)
on the CPU: the histograms and the target list fit the H100's shared
memory, what cannot fit raises; and a warp-by-warp emulation of
csrc/region_vote.cu (targets listed by runs of pixels, region rows taken
32 at a time, their cells walked as one flat run by a search over the
rows' starts, the lane-wise reduction) equals region_vote_stats_plain
bitwise."""
import numpy as np
import pytest
import torch

from adcensus_torch.ops.region_vote import (
    GEOMETRY, SMEM_LIMIT, region_vote_geometry, region_vote_smem,
    region_vote_stats, region_vote_stats_plain,
)

H, W = 375, 450
UNROLL = 2           # csrc/region_vote.cu kUnroll
NO_BIN = 2 ** 31 - 1
LANES = np.arange(32)


@pytest.mark.parametrize("d", [1, 3, 64, 256, 1024, 7000, 57_000])
def test_geometry_fits(d):
    for h, w in ((H, W), (1, 1), (7, 5), (600, 2000)):
        pixels, warps, smem = region_vote_geometry(d, h, w)
        assert pixels == GEOMETRY[0] and 1 <= warps <= GEOMETRY[1]
        assert smem == region_vote_smem(pixels, warps, d) <= SMEM_LIMIT
    # the default warps while they fit, fewer only for long histograms
    fits = region_vote_smem(GEOMETRY[0], GEOMETRY[1], d) <= SMEM_LIMIT
    assert (warps == GEOMETRY[1]) == fits
    assert fits == (d <= 1024)


@pytest.mark.parametrize("args", [
    (0, H, W), (64, 0, W), (64, H, 0),
    (1, 2 ** 16, 2 ** 15),     # H*W = 2^31
    (60_000, H, W),            # one warp's histogram does not fit
])
def test_geometry_rejects_impossible(args):
    with pytest.raises(ValueError):
        region_vote_geometry(*args)


def test_wrapper_checks_the_target():
    di = torch.zeros((4, 5), dtype=torch.int32)
    valid = torch.ones((4, 5), dtype=torch.bool)
    arms = torch.zeros((4, 5, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        region_vote_stats(di, valid, arms, 3, 2,
                          target=torch.ones((4, 5), dtype=torch.uint8))
    with pytest.raises(ValueError):
        region_vote_stats(di, valid, arms, 3, 2,
                          target=torch.ones((5, 4), dtype=torch.bool))


def _clamp(arm, max_arm, room):
    return np.maximum(np.minimum(np.minimum(arm, max_arm), room), 0)


def _emulate_target(p, di, valid, arms, d, max_arm):
    """One warp's work on target ``p``: (best, max, count)."""
    h, w = di.shape
    y, x = divmod(p, w)
    hist = np.zeros(d, np.int64)
    top = _clamp(arms[y, x, 2], max_arm, y)
    bottom = _clamp(arms[y, x, 3], max_arm, h - 1 - y)
    n_rows = top + bottom + 1
    for r0 in range(0, n_rows, 32):
        active = LANES < n_rows - r0
        rows = np.where(active, y - top + r0 + LANES, 0)
        lo = _clamp(arms[rows, x, 0], max_arm, x)
        hi = _clamp(arms[rows, x, 1], max_arm, w - 1 - x)
        width = np.where(active, lo + hi + 1, 0)
        first = np.where(active, rows * w + x - lo, 0)
        end = np.cumsum(width)
        total, start = end[31], end - width
        for k0 in range(0, total, 32 * UNROLL):
            for u in range(UNROLL):
                if k0 + u * 32 >= total:
                    continue
                kc = k0 + u * 32 + LANES
                j = np.zeros(32, int)
                for step in (16, 8, 4, 2, 1):
                    j = np.where(start[j + step] <= kc, j + step, j)
                q = (first[j] + kc - start[j])[kc < total]
                # every cell of the batch once, on its own row
                assert (q // w == rows[j][kc < total]).all()
                v = di.reshape(-1)[q]
                vote = valid.reshape(-1)[q] & (v >= 0) & (v < d)
                np.add.at(hist, v[vote], 1)
    best_c = np.full(32, -1)
    best_d = np.full(32, NO_BIN)
    sums = np.zeros(32, np.int64)
    for b in range(d):
        lane = b % 32
        if hist[b] > best_c[lane]:
            best_c[lane], best_d[lane] = hist[b], b
        sums[lane] += hist[b]
    max_c = best_c.max()
    best = np.where(best_c == max_c, best_d, NO_BIN).min()
    return best, max(max_c, 0), sums.sum()


def emulate_kernel(di, valid, arms, d, max_arm, target, geometry):
    """csrc/region_vote.cu: a block per run of ``pixels`` pixels lists
    its targets 32 pixels at a time and writes zeros elsewhere; each
    target goes through ``_emulate_target``. Every output is written
    once."""
    pixels, warps, smem = geometry
    assert smem >= region_vote_smem(pixels, warps, d)
    h, w = di.shape
    hw = h * w
    out = np.full((3, hw), -1, np.int64)
    for p0 in range(0, hw, pixels):
        n_here = min(pixels, hw - p0)
        listed = []
        for c in range(0, n_here, 32):
            p = p0 + c + LANES
            inside = c + LANES < n_here
            is_target = inside & (
                True if target is None else target.reshape(-1)[
                    np.minimum(p, hw - 1)])
            assert (out[:, p[inside]] == -1).all()
            out[:, p[inside & ~is_target]] = 0
            listed.extend(p[is_target])
        assert len(listed) <= pixels
        for p in listed:
            out[:, p] = _emulate_target(p, di, valid, arms, d, max_arm)
    assert (out >= 0).all()
    return out.reshape(3, h, w)


# (D, H, W, max_arm, target density): partial runs of pixels, D below and
# above a warp's 32 lanes, rows of more than 32 cells and regions of more
# than 32 rows, a cap of 0, empty and full targets
EMULATION_CASES = {
    "sparse": (16, 23, 37, 6, 0.1),
    "d1": (1, 20, 30, 5, 0.2),
    "d3_full": (3, 9, 13, 4, 1.0),
    "d40_long_rows": (40, 12, 90, 40, 0.05),
    "tall_regions": (8, 90, 12, 40, 0.05),
    "arm0": (5, 10, 20, 0, 0.3),
    "empty": (8, 10, 20, 3, 0.0),
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_emulated_kernel_equals_plain(case):
    d, h, w, max_arm, density = EMULATION_CASES[case]
    rng = np.random.default_rng(d + h + w)
    di = rng.integers(0, d, (h, w)).astype(np.int32)
    valid = rng.random((h, w)) < 0.7
    yy, xx = np.mgrid[:h, :w]
    border = (xx, w - 1 - xx, yy, h - 1 - yy)
    arms = np.stack([np.minimum(rng.integers(0, max_arm + 1, (h, w)),
                                border[k]) for k in range(4)],
                    axis=-1).astype(np.int32)
    target = rng.random((h, w)) < density
    pixels, warps, _ = region_vote_geometry(d, h, w)
    for geometry in ((pixels, warps), (32, 1), (100, 3)):
        geometry = geometry + (region_vote_smem(*geometry, d),)
        ours = emulate_kernel(di, valid, arms, d, max_arm, target, geometry)
        ref = region_vote_stats_plain(
            torch.as_tensor(di), torch.as_tensor(valid),
            torch.as_tensor(arms), d, max_arm, torch.as_tensor(target))
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r.numpy())
