"""The port's refinement (adcensus_torch/stages/refine.py and the plain
versions of kernels B3, ops/region_vote.py, B4, ops/interp.py, M1,
ops/median.py, and M2, ops/dda.py) against the JAX package and the numpy
oracle, on the CPU, from JAX-produced inputs; and a line-by-line
emulation of kernel M1 against its plain version (M2's is in
tests/test_torch_dda_geometry.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import dda as torch_dda
from adcensus_torch.ops import interp as torch_interp
from adcensus_torch.ops import median as torch_median
from adcensus_torch.ops import region_vote as torch_vote
from adcensus_torch.stages import refine as torch_refine
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.oracle import numpy_ref
from adcensus_tpu.ops import region_vote_pallas as jax_vote
from adcensus_tpu.stages import cost as jax_cost
from adcensus_tpu.stages import pipeline as jax_pipeline
from adcensus_tpu.stages import refine as jax_refine

OPTS = dict(max_disparity=16, cross_L1=8, cross_L2=4)
MAX_ARM = 8


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def scene():
    """One eager JAX match of a seeded 32x48 pair, with intermediates,
    plus the LR-check masks of its raw disparities."""
    left, right, _ = two_layer_pair(32, 48, 4, 9, seed=1)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    opts = JaxOptions(**OPTS)
    out = jax_pipeline.match_core(
        jl, jr, jax_cost.compute_gray(jl), jax_cost.compute_gray(jr),
        opts, return_intermediates=True, use_pallas=False,
    )
    inter = {k: np.array(v) for k, v in out.items()}
    _, occl, mism = jax_refine.outlier_detection(
        out["disp_left_raw"], out["disp_right_raw"], opts
    )
    inter["occlusion"], inter["mismatch"] = np.array(occl), np.array(mism)
    return left, inter


def _random_disparities(seed, h=24, w=40, d_range=16):
    """Left/right maps with sub-pixel values, +inf holes and border
    winners, so that every LR-check branch is taken."""
    rng = np.random.default_rng(seed)
    dl = (rng.integers(0, d_range, (h, w)) + rng.choice(
        [0.0, 0.25, 0.5, -0.5], (h, w))).astype(np.float32)
    dr = (dl + rng.choice([0.0, 0.0, 0.5, 3.0, -4.0], (h, w))).astype(
        np.float32)
    dl[rng.random((h, w)) < 0.15] = np.inf
    return dl, dr


@pytest.mark.parametrize("case", ["scene", "random0", "random1"])
def test_outlier_detection_exact(scene, case):
    if case == "scene":
        _, inter = scene
        dl, dr = inter["disp_left_raw"], inter["disp_right_raw"]
    else:
        dl, dr = _random_disparities(int(case[-1]))
    ref = jax_refine.outlier_detection(
        jnp.asarray(dl), jnp.asarray(dr), JaxOptions(**OPTS)
    )
    ours = torch_refine.outlier_detection(_t(dl), _t(dr),
                                          ADCensusOptions(**OPTS))
    np.testing.assert_array_equal(_bits(ours[0].numpy()), _bits(ref[0]))
    for o, r in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert np.asarray(ref[1]).any() and np.asarray(ref[2]).any()


def _vote_inputs(scene):
    _, inter = scene
    disp = inter["after_lr_check"]
    di, valid = jax_refine.vote_indices(jnp.asarray(disp), JaxOptions(**OPTS))
    return np.array(di), np.array(valid), inter["arms"]


def test_vote_indices_exact(scene):
    _, inter = scene
    disp = inter["after_lr_check"]
    ours = torch_refine.vote_indices(_t(disp), ADCensusOptions(**OPTS))
    ref = jax_refine.vote_indices(jnp.asarray(disp), JaxOptions(**OPTS))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _long_vote_inputs():
    """A 12x160 map with arms up to 150, clipped to the border."""
    rng = np.random.default_rng(150)
    h, w = 12, 160
    xx = np.arange(w)[None, :].repeat(h, 0)
    yy = np.arange(h)[:, None].repeat(w, 1)
    border = (xx, w - 1 - xx, yy, h - 1 - yy)
    arms = np.stack([np.minimum(rng.integers(0, 151, (h, w)), border[k])
                     for k in range(4)], axis=-1).astype(np.int32)
    assert arms[..., :2].max() > 127
    return (rng.integers(0, 16, (h, w)).astype(np.int32),
            rng.random((h, w)) < 0.7, arms)


# (target, max_arm, d_range): the whole map (target=None), the scene's
# first mismatch phase, a seeded 5 % random target, no target, every
# pixel; arms up to 150 (JAX's Pallas route takes its jnp branch past 127);
# a single disparity
VOTE_CASES = {
    "none": ("none", MAX_ARM, 16),
    "mismatch": ("mismatch", MAX_ARM, 16),
    "random5": ("random5", MAX_ARM, 16),
    "empty": ("empty", MAX_ARM, 16),
    "all": ("all", MAX_ARM, 16),
    "arm150": ("random5", 150, 16),
    "d1": ("random5", MAX_ARM, 1),
}


@pytest.mark.parametrize("case", sorted(VOTE_CASES))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_region_vote_plain_exact(scene, use_pallas, case):
    """Plain B3 == region_vote_stats' one-hot branch (use_pallas=False)
    and == the Pallas kernel in interpret mode (use_pallas=True) at the
    target pixels, with zeros elsewhere."""
    kind, max_arm, d_range = VOTE_CASES[case]
    if max_arm > MAX_ARM:
        di, valid, arms = _long_vote_inputs()
    else:
        di, valid, arms = _vote_inputs(scene)
    di = np.minimum(di, d_range - 1)
    target = {
        "none": lambda: None,
        "mismatch": lambda: scene[1]["mismatch"] & ~valid,
        "random5": lambda: np.random.default_rng(5).random(di.shape) < 0.05,
        "empty": lambda: np.zeros(di.shape, bool),
        "all": lambda: np.ones(di.shape, bool),
    }[kind]()
    assert target is None or kind in ("empty", "all") or (
        target.any() and not target.all())
    ref = jax_vote.region_vote_stats(
        jnp.asarray(di), jnp.asarray(valid), jnp.asarray(arms), d_range,
        max_arm, use_pallas=use_pallas,
    )
    ours = torch_vote.region_vote_stats(
        _t(di), _t(valid), _t(arms), d_range, max_arm,
        target=None if target is None else _t(target),
    )
    for o, r in zip(ours, ref):
        assert o.dtype == torch.int32
        want = np.asarray(r) if target is None else np.where(target, r, 0)
        np.testing.assert_array_equal(o.numpy(), want)


@pytest.mark.parametrize("kind", ["empty", "sparse"])
def test_region_vote_phase_exact(scene, kind):
    """One phase == JAX's region_vote_phase bit for bit. The port runs the
    phase whatever its target; an empty target returns ``disp``
    unchanged, as JAX's lax.cond skip does."""
    _, inter = scene
    disp, arms = inter["after_lr_check"], inter["arms"]
    target = inter["mismatch"] & np.isinf(disp)
    if kind == "empty":
        target = np.zeros_like(target)
    ref = np.asarray(jax_refine.region_vote_phase(
        jnp.asarray(disp), jnp.asarray(arms), jnp.asarray(target),
        JaxOptions(**OPTS), use_pallas=False,
    ))
    ours = torch_refine.region_vote_phase(
        _t(disp), _t(arms), _t(target), ADCensusOptions(**OPTS)
    ).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    filled = (_bits(ours) != _bits(disp)).sum()
    assert (filled == 0) if kind == "empty" else (filled > 0)


def test_iterative_region_voting_exact(scene):
    _, inter = scene
    ours = torch_refine.iterative_region_voting(
        _t(inter["after_lr_check"]), _t(inter["arms"]),
        _t(inter["occlusion"]), _t(inter["mismatch"]),
        ADCensusOptions(**OPTS),
    )
    np.testing.assert_array_equal(_bits(ours.numpy()),
                                  _bits(inter["after_voting"]))
    # voting fills some holes of this scene, not all
    holes_before = np.isinf(inter["after_lr_check"]).sum()
    holes_after = np.isinf(inter["after_voting"]).sum()
    assert 0 < holes_after < holes_before


@pytest.mark.parametrize("max_search", [2, 16, 64, 256])
def test_ray_offset_table_equal(max_search):
    np.testing.assert_array_equal(
        torch_refine.ray_offset_table(max_search),
        jax_refine.ray_offset_table(max_search),
    )


@pytest.mark.parametrize("is_mismatch", [True, False])
def test_interpolation_fills_exact_at_targets(scene, is_mismatch):
    """Plain B4 through interpolation_fills == use_pallas=False at the
    target pixels; elsewhere the port writes 0.0."""
    left, inter = scene
    disp = inter["after_voting"]
    mask = inter["mismatch"] if is_mismatch else inter["occlusion"]
    target = mask & np.isinf(disp)
    assert target.any()
    ref = np.asarray(jax_refine.interpolation_fills(
        jnp.asarray(disp), jnp.asarray(left), JaxOptions(**OPTS),
        is_mismatch, use_pallas=False, target=jnp.asarray(target),
    ))
    ours = torch_refine.interpolation_fills(
        _t(disp), _t(left), ADCensusOptions(**OPTS), is_mismatch,
        target=_t(target),
    ).numpy()
    np.testing.assert_array_equal(_bits(ours[target]), _bits(ref[target]))
    assert (ours[~target] == 0.0).all()


def test_ray_interp_first_ray_wins_ties():
    """Two rays hit at the same colour distance: a mismatch takes the
    first ray's disparity (strict '<'), as the JAX selection does; an
    occlusion takes the least disparity."""
    disp = np.full((5, 9), np.inf, np.float32)
    disp[2, 6] = 7.0    # ray 0 (angle 0) hits at its step (0, +2)
    disp[2, 2] = 3.0    # ray 15 (angle 15 pi/16) hits at its step (0, -2)
    left = np.zeros((5, 9, 3), np.uint8)
    target = np.zeros((5, 9), bool)
    target[2, 4] = True
    offsets = torch.as_tensor(torch_refine.ray_offset_table(8))
    for is_mismatch, want in ((True, 7.0), (False, 3.0)):
        found, fill = torch_interp.ray_interp(
            _t(disp), _t(left), offsets, _t(target), is_mismatch
        )
        assert found[2, 4] and fill[2, 4] == want
        assert found.sum() == 1
        ref = jax_refine.interpolation_fills(
            jnp.asarray(disp), jnp.asarray(left),
            JaxOptions(max_disparity=8), is_mismatch, use_pallas=False,
            target=jnp.asarray(target),
        )
        assert float(ref[2, 4]) == want


def test_proper_interpolation_exact(scene):
    left, inter = scene
    ours = torch_refine.proper_interpolation(
        _t(inter["after_voting"]), _t(left), _t(inter["occlusion"]),
        _t(inter["mismatch"]), ADCensusOptions(**OPTS),
    )
    np.testing.assert_array_equal(_bits(ours.numpy()),
                                  _bits(inter["after_interpolation"]))


@pytest.mark.parametrize("case", ["scene", "random"])
def test_median_filter_exact(scene, case):
    if case == "scene":
        disp = scene[1]["after_interpolation"]
    else:
        disp, _ = _random_disparities(7, h=9, w=13)
    ours = torch_refine.median_filter_3x3(_t(disp)).numpy()
    ref = jax_refine.median_filter_3x3(jnp.asarray(disp))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


@pytest.mark.parametrize("do_lr_check,do_filling",
                         [(True, True), (True, False), (False, True)])
def test_multistep_refine_exact(scene, do_lr_check, do_filling):
    left, inter = scene
    opts = dict(OPTS, do_lr_check=do_lr_check, do_filling=do_filling)
    args = (inter["disp_left_raw"], inter["disp_right_raw"], left,
            inter["cost_scan"], inter["arms"])
    ref = jax_refine.multistep_refine(
        *map(jnp.asarray, args), JaxOptions(**opts), use_pallas=False
    )
    ours = torch_refine.multistep_refine(*map(_t, args),
                                         ADCensusOptions(**opts))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(_bits(ours[k].numpy()),
                                      _bits(ref[k]), err_msg=k)


@pytest.mark.parametrize("flag", ["exact_median",
                                  "do_discontinuity_adjustment"])
def test_unported_options_raise(scene, flag):
    """The two options that raised NotImplementedError before their
    stages were ported now run: the chain's stage outputs equal JAX's bit
    for bit, "after_discontinuity" included."""
    left, inter = scene
    opts = dict(OPTS, **{flag: True})
    args = (inter["disp_left_raw"], inter["disp_right_raw"], left,
            inter["cost_scan"], inter["arms"])
    ref = jax_refine.multistep_refine(
        *map(jnp.asarray, args), JaxOptions(**opts), use_pallas=False
    )
    ours = torch_refine.multistep_refine(*map(_t, args),
                                         ADCensusOptions(**opts))
    assert set(ours) == set(ref)
    assert ("after_discontinuity" in ours) == (
        flag == "do_discontinuity_adjustment")
    for k in ref:
        np.testing.assert_array_equal(_bits(ours[k].numpy()),
                                      _bits(ref[k]), err_msg=k)


# The in-place median (kernel M1's plain version) and the discontinuity
# adjustment (kernel M2's)

MEDIAN_SHAPES = [(9, 11), (24, 17), (33, 64), (40, 9), (1, 7), (7, 1),
                 (2, 2)]


def _holey_map(seed, h, w, lo=0.0, hi=60.0, share=0.15):
    """Uniform float32 disparities in [lo, hi) with ``share`` +inf."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(lo, hi, (h, w)).astype(np.float32)
    src[rng.random((h, w)) < share] = np.inf
    return src


@pytest.mark.parametrize("h,w", [(5, 7), (17, 33), (36, 52), (1, 4)])
def test_shear_roundtrip(h, w):
    """_shear is S[y, t] = a[y, t - 2y] (+inf outside), JAX's bit for bit,
    and _unshear inverts it."""
    a = np.random.default_rng(3).uniform(0, 9, (h, w)).astype(np.float32)
    t_cols = w + 2 * h
    s = torch_median._shear(_t(a), t_cols, np.inf).numpy()
    for y in range(h):
        np.testing.assert_array_equal(s[y, 2 * y : 2 * y + w], a[y])
        assert np.isinf(s[y, : 2 * y]).all()
        assert np.isinf(s[y, 2 * y + w :]).all()
    np.testing.assert_array_equal(
        s, np.asarray(jax_refine._shear(jnp.asarray(a), t_cols, np.inf)))
    np.testing.assert_array_equal(
        torch_median._unshear(_t(s), w, np.inf).numpy(), a)


@pytest.mark.parametrize("h,w", MEDIAN_SHAPES)
def test_median_inplace_exact(h, w):
    """The plain in-place median on maps with 15 % +inf equals JAX's
    median_filter_3x3_inplace and the oracle's raster loop bit for bit."""
    src = _holey_map(7 + h * w, h, w)
    ours = torch_refine.median_filter_3x3_inplace(_t(src)).numpy()
    ref = np.asarray(jax_refine.median_filter_3x3_inplace(jnp.asarray(src)))
    oracle = numpy_ref.median_filter_inplace(src.copy(), 3)
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    np.testing.assert_array_equal(_bits(ours), _bits(oracle))
    assert np.isinf(src).any() and not np.array_equal(ours, src)


def test_median_inplace_scene(scene):
    """On the scene's interpolated map, and different from the
    out-of-place median there (the raster order matters)."""
    src = scene[1]["after_interpolation"]
    ours = torch_refine.median_filter_3x3_inplace(_t(src)).numpy()
    ref = np.asarray(jax_refine.median_filter_3x3_inplace(jnp.asarray(src)))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    dense = torch_refine.median_filter_3x3(_t(src)).numpy()
    assert not np.array_equal(ours, dense)


def _median_kernel_emulation(src):
    """The wavefront order of kernel M1, pixel by pixel: wavefront
    t = x + 2y in order, the nine reads of each pixel (filtered from the
    output buffer, original from the input), the odd-even transposition
    network of min/max pairs, the rank from the border distances (the
    kernel's first design; tests/test_torch_median_geometry.py emulates
    the present one lane by lane). The output starts as NaN, so a read of
    a pixel not yet written shows."""
    h, w = src.shape
    out = np.full_like(src, np.nan)
    inf = np.float32(np.inf)
    for t in range(w + 2 * (h - 1)):
        for y in range(h):
            x = t - 2 * y
            if not 0 <= x < w:
                continue
            up, down, left, right = y > 0, y < h - 1, x > 0, x < w - 1
            v = [out[y, x - 1] if left else inf,
                 out[y - 1, x + 1] if up and right else inf,
                 out[y - 1, x] if up else inf,
                 out[y - 1, x - 1] if up and left else inf,
                 src[y, x],
                 src[y, x + 1] if right else inf,
                 src[y + 1, x - 1] if down and left else inf,
                 src[y + 1, x] if down else inf,
                 src[y + 1, x + 1] if down and right else inf]
            assert not np.isnan(v).any(), (y, x)
            for rnd in range(9):
                for i in range(rnd % 2, 8, 2):
                    v[i], v[i + 1] = min(v[i], v[i + 1]), max(v[i], v[i + 1])
            out[y, x] = v[((1 + up + down) * (1 + left + right)) // 2]
    return out


@pytest.mark.parametrize("h,w", MEDIAN_SHAPES + [(3, 1), (1, 1)])
def test_median_kernel_emulation_equals_plain(h, w):
    src = _holey_map(11 + h + w, h, w, lo=0.5)
    np.testing.assert_array_equal(
        _bits(_median_kernel_emulation(src)),
        _bits(torch_median.median_inplace_plain(_t(src)).numpy()))


def test_median_inplace_all_invalid():
    src = np.full((6, 8), np.inf, np.float32)
    assert np.isinf(torch_refine.median_filter_3x3_inplace(_t(src))).all()
    assert np.isinf(_median_kernel_emulation(src)).all()


def test_median_inplace_leaves_input():
    src = _holey_map(1, 10, 12)
    t = _t(src.copy())
    torch_refine.median_filter_3x3_inplace(t)
    np.testing.assert_array_equal(t.numpy(), src)


@pytest.mark.parametrize("case", ["scene", "random0", "random1"])
def test_edge_detect_exact(scene, case):
    if case == "scene":
        disp = scene[1]["after_interpolation"]
    else:
        disp, _ = _random_disparities(int(case[-1]))
    ours = torch_refine.edge_detect(_t(disp)).numpy()
    ref = np.asarray(jax_refine.edge_detect(jnp.asarray(disp)))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, numpy_ref.edge_detect(disp) == 1)
    assert ours.any() and not ours[0].any() and not ours[:, -1].any()


def _dda_chain_case():
    """tests/test_refine.py's chain: a staircase row of edge pixels whose
    own costs fall leftward, so the leftmost disparity propagates."""
    h, w, d_range = 5, 10, 8
    disp = np.zeros((h, w), np.float32)
    disp[2] = np.array([7, 0, 5, 6, 7, 6, 5, 6, 7, 0], np.float32)
    cost = np.full((d_range, h, w), 9.0, np.float32)
    for x in range(w):
        cost[int(disp[2, x]), 2, x] = float(x)
    return disp, cost, 0


def _dda_random_case(seed, h=16, w=27, d_range=8, min_disparity=-4):
    """Disparities from min_disparity - 1 to d_range + 3 (indices out of
    [0, D) on both sides), with halves that lround rounds away from zero
    and 10 % +inf; a random cost volume."""
    rng = np.random.default_rng(seed)
    disp = (rng.integers(min_disparity - 1, d_range + 4, (h, w))
            + rng.choice([0.0, 0.25, 0.5, -0.5], (h, w))).astype(np.float32)
    disp[rng.random((h, w)) < 0.1] = np.inf
    cost = rng.random((d_range, h, w)).astype(np.float32)
    return disp, cost, min_disparity


DDA_CASES = ["chain", "random0", "random1", "random2"]


def _dda_case(case):
    return _dda_chain_case() if case == "chain" else _dda_random_case(
        int(case[-1]))


@pytest.mark.parametrize("case", DDA_CASES)
def test_dda_exact(case):
    """The plain adjustment equals JAX's and the oracle's bit for bit,
    and changes the map."""
    disp, cost, min_d = _dda_case(case)
    d_range = cost.shape[0]
    kw = dict(min_disparity=min_d, max_disparity=min_d + d_range)
    ours = torch_refine.depth_discontinuity_adjustment(
        _t(disp), _t(cost), ADCensusOptions(**kw)).numpy()
    ref = np.asarray(jax_refine.depth_discontinuity_adjustment(
        jnp.asarray(disp), jnp.asarray(cost), JaxOptions(**kw)))
    oracle = numpy_ref.depth_discontinuity_adjustment(
        disp, np.transpose(cost, (1, 2, 0)), JaxOptions(**kw))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    np.testing.assert_array_equal(_bits(ours), _bits(oracle))
    assert not np.array_equal(ours, disp)


def test_dda_checks_its_inputs():
    disp, cost, _ = _dda_random_case(0)
    with pytest.raises(ValueError):
        torch_dda.dda(_t(disp), _t(cost[:, :-1]))
    with pytest.raises(ValueError):
        torch_dda.dda(_t(disp[0]), _t(cost))
    with pytest.raises(TypeError):
        torch_dda.dda(_t(disp), _t(cost).double())
    with pytest.raises(TypeError):
        torch_median.median_inplace(_t(disp).double())
