"""The port's blocked-band aggregation (adcensus_torch/ops/band_mm.py: the
masks, the routing rule, the plain version of kernel B5 and
aggregate_banded) against the JAX package, on the CPU. JAX's Pallas
kernel runs in interpret mode here, as the JAX package's tests run it."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import band_mm as torch_band
from adcensus_torch.ops import cross_sum as torch_cross
from adcensus_torch.stages import aggregate as torch_agg
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.ops import band_mm_pallas as jax_band
from adcensus_tpu.stages import aggregate as jax_agg
from adcensus_tpu.stages import arms as jax_arms
from adcensus_tpu.stages import cost as jax_cost

OPTS = dict(max_disparity=16, cross_L1=8, cross_L2=4)
# float32 sums of up to WK = 512 terms below 2 in two orders (the plain
# version's sequential one and XLA's dot): a few ulp of the sum
SUM_TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module")
def scene():
    """JAX arms and initial cost volume of a seeded 32x48 pair."""
    left, right, _ = two_layer_pair(32, 48, 4, 9, seed=1)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    opts = JaxOptions(**OPTS)
    cost_init = jax_cost.compute_cost_volume(
        jl, jr,
        jax_cost.census_transform_9x7(jax_cost.compute_gray(jl)),
        jax_cost.census_transform_9x7(jax_cost.compute_gray(jr)), opts,
    )
    return {
        "arms": np.array(jax_arms.build_arms(jl, opts)),
        "cost_init": np.array(cost_init),
    }


def _random_arms(rng, h, w, max_arm):
    """Random arms clipped to the border, as in
    tests/test_aggregate.py:test_aggregate_banded_long_arms_and_shapes."""
    yy = np.arange(h)[:, None] * np.ones((1, w), int)
    xx = np.arange(w)[None, :] * np.ones((h, 1), int)
    return np.stack(
        [
            np.minimum(rng.integers(0, max_arm + 1, (h, w)), xx),
            np.minimum(rng.integers(0, max_arm + 1, (h, w)), w - 1 - xx),
            np.minimum(rng.integers(0, max_arm + 1, (h, w)), yy),
            np.minimum(rng.integers(0, max_arm + 1, (h, w)), h - 1 - yy),
        ],
        axis=-1,
    ).astype(np.int32)


def _odd_case():
    """The odd (D, H, W) = (12, 37, 141), max_arm 70 (PAD 128) case of
    test_aggregate_banded_long_arms_and_shapes, same seed and order."""
    rng = np.random.default_rng(7)
    d, h, w, max_arm = 12, 37, 141, 70
    vol = rng.random((d, h, w), dtype=np.float32) * 2.0
    return vol, _random_arms(rng, h, w, max_arm), max_arm


def _arms_case(name, scene):
    if name == "scene":
        return scene["arms"], 8
    if name == "odd":
        _, arms, max_arm = _odd_case()
        return arms, max_arm
    return _random_arms(np.random.default_rng(5), 20, 30, 200), 200


@pytest.mark.parametrize("case", ["scene", "odd", "pad256"])
def test_make_blocked_masks_bitwise(scene, case):
    arms, max_arm = _arms_case(case, scene)
    h, w = arms.shape[:2]
    _, hp, wp = torch_band.padded_dims(1, h, w)
    ours = torch_band.make_blocked_masks(torch.as_tensor(arms), max_arm,
                                         hp, wp)
    ref = jax_band.make_blocked_masks(jnp.asarray(arms), max_arm, hp, wp)
    for name in ("pad_w", "pad_h", "hp", "wp"):
        assert getattr(ours, name) == getattr(ref, name), name
    for name in ("mh", "mv"):
        o, r = getattr(ours, name), np.asarray(getattr(ref, name))
        assert o.dtype == torch.int8 and o.is_contiguous()
        np.testing.assert_array_equal(o.numpy(), r)
    assert ours.pad_w == {"scene": 64, "odd": 128, "pad256": 256}[case]


def test_banded_fits_equals_jax():
    grid = list(itertools.product(
        (3, 17, 64, 128, 256), (37, 375, 1080), (141, 450, 1920, 4000),
        (8, 34, 70, 200, 255),
    ))
    ours = [torch_band.banded_fits(*g) for g in grid]
    assert ours == [jax_band.banded_fits(*g) for g in grid]
    assert any(ours) and not all(ours)


def _band_inputs(seed, dp, np_, mp, pad):
    """A random margined volume and a random 0/1 int8 mask."""
    rng = np.random.default_rng(seed)
    wk = 256 + 2 * pad
    length = -(-mp // 256) * 256 + 2 * pad
    vol_m = (rng.random((dp, np_, length), dtype=np.float32) * 2.0)
    mask = (rng.random((np_, wk, mp)) < 0.3).astype(np.int8)
    return vol_m, mask


# (Dp, Np, Mp, PAD): a 128-wide tail block; a 256-wide block and PAD 128
BAND_SHAPES = [(8, 8, 384, 64), (16, 8, 256, 128)]


@pytest.mark.parametrize("dp,np_,mp,pad", BAND_SHAPES)
def test_band_pass_plain_close_to_jax_kernel(dp, np_, mp, pad):
    vol_m, mask = _band_inputs(0, dp, np_, mp, pad)
    db, yb = jax_band._pick_blocks(dp, mp, pad)
    ref = np.array(jax_band._band_pass(
        jnp.asarray(vol_m), jnp.asarray(mask), pad, db, yb
    ))
    ours = torch_band.band_pass(torch.as_tensor(vol_m),
                                torch.as_tensor(mask), pad)
    assert ours.shape == (dp, np_, mp)
    np.testing.assert_allclose(ours.numpy(), ref, **SUM_TOL)


@pytest.mark.parametrize("dp,np_,mp,pad", BAND_SHAPES)
def test_band_pass_plain_close_to_library(dp, np_, mp, pad):
    """The plain version against chip_smoke's unfold/einsum yardstick."""
    vol_m, mask = _band_inputs(1, dp, np_, mp, pad)
    vol_m, mask = torch.as_tensor(vol_m), torch.as_tensor(mask)
    ours = torch_band.band_pass_plain(vol_m, mask, pad)
    lib = chip_smoke.band_pass_library(torch, vol_m, mask, pad)
    np.testing.assert_allclose(ours.numpy(), lib.numpy(), **SUM_TOL)


def test_band_pass_rejects_bad_inputs():
    vol_m, mask = (torch.as_tensor(a) for a in _band_inputs(2, 8, 8, 128, 64))
    with pytest.raises(TypeError):
        torch_band.band_pass(vol_m.double(), mask, 64)
    with pytest.raises(TypeError):
        torch_band.band_pass(vol_m, mask.bool(), 64)
    with pytest.raises(ValueError):
        torch_band.band_pass(vol_m, mask, 128)  # wrong window for PAD
    with pytest.raises(ValueError):
        torch_band.band_pass(vol_m[..., :-1], mask, 64)
    strided = mask.transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        torch_band.band_pass(vol_m, strided, 64)


def test_aggregate_banded_scene(scene, monkeypatch):
    """aggregate(cross_backend="matmul", agg_impl="banded") against JAX's
    ADC_AGG_IMPL=banded aggregation and the port's bitwise roll
    aggregation, at the tolerance of tests/test_aggregate.py:70,118."""
    monkeypatch.setenv("ADC_AGG_IMPL", "banded")
    ref = np.array(jax_agg.aggregate(
        jnp.asarray(scene["cost_init"]), jnp.asarray(scene["arms"]),
        JaxOptions(**OPTS), use_pallas="matmul",
    ))
    args = (torch.as_tensor(scene["cost_init"]),
            torch.as_tensor(scene["arms"]), ADCensusOptions(**OPTS))
    ours = torch_agg.aggregate(*args, cross_backend="matmul",
                               agg_impl="banded").numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(ours, torch_agg.aggregate(*args).numpy(),
                               atol=5e-4)


def test_aggregate_banded_odd_shape_long_arms():
    """The odd 12x37x141, max_arm 70 case against JAX's aggregate_banded
    and against two iterations of the port's plain cross sum."""
    vol, arms, max_arm = _odd_case()
    assert torch_band.banded_fits(*vol.shape, max_arm)
    sup_h, sup_v = jax_agg.support_counts(jnp.asarray(arms), max_arm)
    sup_h = np.array(sup_h, np.float32)
    sup_v = np.array(sup_v, np.float32)
    ref = np.array(jax_band.aggregate_banded(
        jnp.asarray(vol), jnp.asarray(arms), jnp.asarray(sup_h),
        jnp.asarray(sup_v), max_arm, num_iters=2,
    ))
    t_arms, t_sh, t_sv = (torch.as_tensor(a) for a in (arms, sup_h, sup_v))
    ours = torch_band.aggregate_banded(
        torch.as_tensor(vol), t_arms, t_sh, t_sv, max_arm, num_iters=2
    ).numpy()
    np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-4)
    plain = torch.as_tensor(vol)
    for horizontal_first in (True, False):
        plain = torch_cross.cross_pass_plain(
            plain, t_arms, t_sh if horizontal_first else t_sv,
            horizontal_first, max_arm,
        )
    np.testing.assert_allclose(ours, plain.numpy(), atol=5e-4, rtol=1e-4)


def test_banded_falls_back_to_dense_when_it_does_not_fit(scene,
                                                         monkeypatch):
    args = (torch.as_tensor(scene["cost_init"]),
            torch.as_tensor(scene["arms"]), ADCensusOptions(**OPTS))
    dense = torch_agg.aggregate(*args, cross_backend="matmul")
    monkeypatch.setattr(torch_agg, "banded_fits", lambda *a: False)
    routed = torch_agg.aggregate(*args, cross_backend="matmul",
                                 agg_impl="banded")
    np.testing.assert_array_equal(routed.numpy(), dense.numpy())
    # the roll backend never takes the banded route
    roll = torch_agg.aggregate(*args, agg_impl="banded")
    np.testing.assert_array_equal(roll.numpy(),
                                  torch_agg.aggregate(*args).numpy())
