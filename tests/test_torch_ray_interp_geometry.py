"""Launch geometry of kernel B4 (ops/interp.py:ray_interp_geometry) on the
CPU: the target list fits the H100's shared memory, what the kernel cannot
index raises, the wrapper checks its inputs; and a lane-by-lane
emulation of csrc/ray_interp.cu (targets listed by runs of pixels, 16
lanes a target, K-step chunks that stop at a ray's first exit, the
(key, ray) shuffle reduction) equals ray_interp_plain bitwise."""
import numpy as np
import pytest
import torch

from adcensus_torch.config import LARGE_FLOAT
from adcensus_torch.ops.interp import (
    CHUNKS, GEOMETRY, ray_interp, ray_interp_geometry, ray_interp_plain,
    ray_interp_smem,
)
from adcensus_torch.stages.refine import ray_offset_table

from _ray_cases import CASES, case_inputs, ray_inputs

LANES = np.arange(32)
SUB = np.arange(16)
NO_RAY = 2 ** 31 - 1
H100_SMEM = 232_448 - 16  # a block's shared memory, less the static count


@pytest.mark.parametrize("h,w", [(375, 450), (1, 1), (7, 5), (1, 333),
                                 (333, 1), (481, 707)])
def test_geometry_fits(h, w):
    for n_steps in (*range(0, 256), 20_000):
        pixels, warps, k, smem = ray_interp_geometry(h, w, 16, n_steps)
        assert (pixels, warps, k) == GEOMETRY and k in CHUNKS
        assert 1 <= warps <= 32 and pixels >= 1
        assert smem == ray_interp_smem(pixels) <= H100_SMEM


@pytest.mark.parametrize("args", [
    (0, 450, 16, 63), (375, 0, 16, 63), (375, 450, 0, 63),
    (375, 450, 16, -1),
    (2 ** 16, 2 ** 15, 16, 63),    # H*W = 2^31
    (375, 450, 16, 2 ** 26),       # 2^30 offsets
])
def test_geometry_rejects_impossible(args):
    with pytest.raises(ValueError):
        ray_interp_geometry(*args)


def test_wrapper_checks_dtypes_and_shapes():
    h, w = 4, 5
    good = dict(
        disp=torch.zeros((h, w)), left=torch.zeros((h, w, 3), dtype=torch.uint8),
        offsets=torch.as_tensor(ray_offset_table(4)),
        target=torch.ones((h, w), dtype=torch.bool),
    )
    bad = [
        ("disp", torch.zeros((h, w), dtype=torch.float64), TypeError),
        ("left", torch.zeros((h, w, 3), dtype=torch.int32), TypeError),
        ("left", torch.zeros((h, w + 1, 3), dtype=torch.uint8), ValueError),
        ("offsets", torch.zeros((16, 3, 2), dtype=torch.int64), TypeError),
        ("offsets", torch.zeros((16, 3, 3), dtype=torch.int32), ValueError),
        ("target", torch.ones((h, w), dtype=torch.uint8), TypeError),
        ("target", torch.ones((w, h), dtype=torch.bool), ValueError),
        ("target", torch.ones((h, 2 * w), dtype=torch.bool)[:, ::2],
         ValueError),  # not contiguous
    ]
    for name, t, err in bad:
        with pytest.raises(err):
            ray_interp(**dict(good, **{name: t}), is_mismatch=True)
    found, fill = ray_interp(**good, is_mismatch=True)
    assert found.shape == fill.shape == (h, w)


def _march(disp, color, tab, y, x, center, rays, k, is_mismatch):
    """One chunked march for T targets at (y, x), lane l of target t on
    ray rays[l]: per lane (hit, key, val), as the kernel's inner loop."""
    h, w = disp.shape
    n_rays, n_steps = tab.shape[:2]
    t = len(y)
    live = np.broadcast_to(rays < n_rays, (t, 16)).copy()
    hit = np.zeros((t, 16), bool)
    val = np.zeros((t, 16), np.float32)
    hit_q = np.zeros((t, 16), np.int64)
    r = np.minimum(rays, n_rays - 1)
    for j in range(0, n_steps, k):
        if not live.any():
            break
        # the disparities of K steps, loaded before any test
        s = j + np.arange(k)
        o = tab[r[:, None], np.minimum(s, n_steps - 1)[None, :]]  # (16, K, 2)
        yy = y[:, None, None] + o[None, ..., 0]
        xx = x[:, None, None] + o[None, ..., 1]
        inside = ((s < n_steps)[None, None, :] & (yy >= 0) & (yy < h)
                  & (xx >= 0) & (xx < w))
        q = np.where(inside, yy * w + xx, 0)
        v = np.where(inside, disp.reshape(-1)[q], np.float32(0))
        for u in range(k):  # the chunk's first step that ends the ray
            ends = live & (~inside[..., u] | np.isnan(v[..., u]))
            hits = live & ~ends & np.isfinite(v[..., u])
            val = np.where(hits, v[..., u], val)
            hit_q = np.where(hits, q[..., u], hit_q)
            hit |= hits
            live &= ~(ends | hits)
    if is_mismatch:  # the color of the hit only
        d = np.abs(color.reshape(-1, 3)[hit_q] - center[:, None]).sum(-1)
        key = np.where(hit, d.astype(np.float32), np.float32(0))
    else:
        key = val = np.where(hit, np.minimum(val, np.float32(LARGE_FLOAT)),
                             np.float32(0))
    return hit, key, val


def _emulate_targets(p, disp, color, tab, k, is_mismatch):
    """Half-warp work on targets ``p``: (found, fill) each."""
    h, w = disp.shape
    n_rays = tab.shape[0]
    t = len(p)
    y, x = p // w, p % w
    center = color.reshape(-1, 3)[p]
    best_key = np.full((t, 16), np.inf, np.float32)
    best_val = np.zeros((t, 16), np.float32)
    best_ray = np.full((t, 16), NO_RAY, np.int64)
    for r0 in range(0, n_rays, 16):  # lane l takes rays l, l + 16, ...
        rays = r0 + SUB
        hit, key, val = _march(disp, color, tab, y, x, center, rays, k,
                               is_mismatch)
        better = hit & (key < best_key)  # strict: a lane's rays ascend
        best_key = np.where(better, key, best_key)
        best_val = np.where(better, val, best_val)
        best_ray = np.where(better, rays[None], best_ray)
    for o in (8, 4, 2, 1):  # __shfl_xor_sync, width 16
        ok, ov, orr = (a[:, SUB ^ o] for a in (best_key, best_val, best_ray))
        take = (ok < best_key) | ((ok == best_key) & (orr < best_ray))
        best_key = np.where(take, ok, best_key)
        best_val = np.where(take, ov, best_val)
        best_ray = np.where(take, orr, best_ray)
    assert (best_ray == best_ray[:, :1]).all()  # every lane holds the winner
    any_hit = best_ray[:, 0] != NO_RAY
    return any_hit, np.where(any_hit, best_val[:, 0], np.float32(0))


def emulate_kernel(disp, color, offsets, target, is_mismatch, geometry):
    """csrc/ray_interp.cu: a block per run of ``pixels`` pixels lists its
    targets 32 pixels at a time and writes (0, 0.0) elsewhere; half-warp
    2 * warp + half takes targets 2 * warp + half, + 2 * warps, ....
    Every output is written once."""
    pixels, warps, k, smem = geometry
    assert k in CHUNKS and smem >= ray_interp_smem(pixels)
    h, w = disp.shape
    hw = h * w
    color = color.astype(np.int64)
    found = np.full(hw, -1, np.int64)
    fill = np.full(hw, np.nan, np.float32)
    for p0 in range(0, hw, pixels):
        n_here = min(pixels, hw - p0)
        listed = []
        for c in range(0, n_here, 32):
            p = p0 + c + LANES
            inside = c + LANES < n_here
            is_target = inside & target.reshape(-1)[np.minimum(p, hw - 1)]
            assert (found[p[inside]] == -1).all()
            found[p[inside & ~is_target]] = 0
            fill[p[inside & ~is_target]] = 0.0
            listed.extend(p[is_target])
        assert len(listed) <= pixels
        if not listed:
            continue
        order = [k0 + half for w_ in range(warps)
                 for k0 in range(2 * w_, len(listed), 2 * warps)
                 for half in (0, 1) if k0 + half < len(listed)]
        assert sorted(order) == list(range(len(listed)))
        p = np.asarray(listed)[order]
        found[p], fill[p] = _emulate_targets(p, disp, color, offsets, k,
                                             is_mismatch)
    assert (found >= 0).all()
    return found.astype(bool).reshape(h, w), fill.reshape(h, w)


def _geometries(h, w, offsets):
    """The default geometry and three others: one warp and one probe a
    step on runs of 32 pixels; K = 8 and 3 warps on runs of 100; K = 2
    and 2 warps on runs of 64."""
    n_rays, n_steps, _ = offsets.shape
    return [ray_interp_geometry(h, w, n_rays, n_steps),
            *((p, wp, k, ray_interp_smem(p))
              for p, wp, k in ((32, 1, 1), (100, 3, 8), (64, 2, 2)))]


def _assert_emulation_equals_plain(disp, color, offsets, target,
                                   is_mismatch):
    ref = ray_interp_plain(torch.as_tensor(disp), torch.as_tensor(color),
                           torch.as_tensor(offsets), torch.as_tensor(target),
                           is_mismatch)
    h, w = disp.shape
    for geometry in _geometries(h, w, offsets):
        found, fill = emulate_kernel(disp, color, offsets, target,
                                     is_mismatch, geometry)
        np.testing.assert_array_equal(found, ref[0].numpy())
        np.testing.assert_array_equal(fill.view(np.uint32),
                                      ref[1].numpy().view(np.uint32))
    return ref


@pytest.mark.parametrize("is_mismatch", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_equals_plain(case, is_mismatch):
    _assert_emulation_equals_plain(*case_inputs(case), is_mismatch)


@pytest.mark.parametrize("is_mismatch", [True, False])
def test_emulated_kernel_stops_at_nan(is_mismatch):
    """An in-image NaN ends a ray with nothing found, as the plain
    version's NaN moat does; +inf is marched through."""
    args = ray_inputs(20, 30, 64, "30%", seed=5, inf_share=0.8,
                      nan_share=0.1)
    _assert_emulation_equals_plain(*args, is_mismatch)


@pytest.mark.parametrize("is_mismatch", [True, False])
def test_emulated_kernel_more_rays_than_lanes(is_mismatch):
    """40 rays: lane l takes rays l, l + 16 and l + 32; 8 rays: half the
    lanes idle."""
    disp, color, _, target = ray_inputs(15, 21, 8, "30%", seed=2)
    rng = np.random.default_rng(3)
    for n_rays in (40, 8):
        offsets = rng.integers(-3, 4, (n_rays, 6, 2)).astype(np.int32)
        _assert_emulation_equals_plain(disp, color, offsets, target,
                                       is_mismatch)


def test_emulated_kernel_equal_color_distances():
    """Every hit at color distance 0 (one flat color), and two rays at the
    same nonzero distance: a mismatch takes the first ray's disparity."""
    disp, _, offsets, target = ray_inputs(16, 24, 16, "30%", seed=4,
                                          inf_share=0.7)
    flat = np.full(disp.shape + (3,), 77, np.uint8)
    ref = _assert_emulation_equals_plain(disp, flat, offsets, target, True)
    assert ref[0].any()
    disp = np.full((5, 9), np.inf, np.float32)
    disp[2, 6] = 7.0    # ray 0 (angle 0) hits at its step (0, +2)
    disp[2, 2] = 3.0    # ray 15 (angle 15 pi/16) hits at its step (0, -2)
    color = np.zeros((5, 9, 3), np.uint8)
    color[2, 6] = (10, 0, 0)
    color[2, 2] = (0, 4, 6)
    target = np.zeros((5, 9), bool)
    target[2, 4] = True
    found, fill = _assert_emulation_equals_plain(
        disp, color, ray_offset_table(8), target, True)
    assert found[2, 4] and fill[2, 4] == 7.0


@pytest.mark.parametrize("first", [-0.0, 0.0])
def test_emulated_kernel_signed_zero_tie(first):
    """Occlusion, -0.0 and +0.0 hit on two rays: the kernel takes the
    first ray's zero, bit for bit, at every geometry. The plain version
    agrees up to the sign of zero only: which zero its amin returns is
    not defined (it differs with the map's size and the torch build), so
    only the value is held against it, and the tie stays out of the card
    tests."""
    disp = np.full((5, 5), np.inf, np.float32)
    disp[2, 4] = first                          # ray 0, step (0, +2)
    disp[2, 0] = -0.0 if first == 0.0 else 0.0  # ray 15, step (0, -2)
    color = np.zeros((5, 5, 3), np.uint8)
    target = np.zeros((5, 5), bool)
    target[2, 2] = True
    offsets = ray_offset_table(8)
    ref_found, ref_fill = ray_interp_plain(
        torch.as_tensor(disp), torch.as_tensor(color),
        torch.as_tensor(offsets), torch.as_tensor(target), False)
    for geometry in _geometries(5, 5, offsets):
        found, fill = emulate_kernel(disp, color, offsets, target, False,
                                     geometry)
        np.testing.assert_array_equal(found, ref_found.numpy())
        np.testing.assert_array_equal(fill, ref_fill.numpy())  # -0.0 == 0.0
        assert found[2, 2]
        assert fill[2, 2].view(np.uint32) == np.float32(first).view(
            np.uint32)
