"""The port's refinement (adcensus_torch/stages/refine.py and the plain
versions of kernels B3, ops/region_vote.py, and B4, ops/interp.py)
against the JAX package, on the CPU, from JAX-produced inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import interp as torch_interp
from adcensus_torch.ops import region_vote as torch_vote
from adcensus_torch.stages import refine as torch_refine
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
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


@pytest.mark.parametrize("use_pallas", [False, True])
def test_region_vote_plain_exact(scene, use_pallas):
    """Plain B3 == region_vote_stats' one-hot branch (use_pallas=False)
    and == the Pallas kernel in interpret mode (use_pallas=True)."""
    di, valid, arms = _vote_inputs(scene)
    ref = jax_vote.region_vote_stats(
        jnp.asarray(di), jnp.asarray(valid), jnp.asarray(arms), 16, MAX_ARM,
        use_pallas=use_pallas,
    )
    ours = torch_vote.region_vote_stats(_t(di), _t(valid), _t(arms), 16,
                                        MAX_ARM)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


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
    left, inter = scene
    opts = dataclasses.replace(ADCensusOptions(**OPTS), **{flag: True})
    with pytest.raises(NotImplementedError):
        torch_refine.multistep_refine(
            _t(inter["disp_left_raw"]), _t(inter["disp_right_raw"]),
            _t(left), _t(inter["cost_scan"]), _t(inter["arms"]), opts,
        )
