"""The port's band-matrix ("matmul") backend (adcensus_torch/ops/
cross_matmul.py, and its routes in stages/aggregate.py and
ops/region_vote.py) against the JAX package, on the CPU, from the same
seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import cross_matmul as torch_mm
from adcensus_torch.ops import cross_sum as torch_cross
from adcensus_torch.ops import region_vote as torch_vote
from adcensus_torch.stages import aggregate as torch_agg
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.ops import cross_matmul as jax_mm
from adcensus_tpu.stages import aggregate as jax_agg
from adcensus_tpu.stages import arms as jax_arms
from adcensus_tpu.stages import cost as jax_cost

# the default arm cap (cross_L1=34) on a small seeded pair
OPTS = dict(max_disparity=16)
MAX_ARM = 34


@pytest.fixture(scope="module")
def scene():
    """JAX arms and initial cost volume of a seeded 32x48 pair at the
    default arm options."""
    left, right, _ = two_layer_pair(32, 48, 4, 9, seed=1)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    opts = JaxOptions(**OPTS)
    cost_init = jax_cost.compute_cost_volume(
        jl, jr,
        jax_cost.census_transform_9x7(jax_cost.compute_gray(jl)),
        jax_cost.census_transform_9x7(jax_cost.compute_gray(jr)), opts,
    )
    arms = np.array(jax_arms.build_arms(jl, opts))
    assert arms.max() > 1  # the arms span more than one pixel
    return {"arms": arms, "cost_init": np.array(cost_init)}


def _clip_to_border(arms):
    """(H, W, 4) arms clipped to the border, as build_arms clips them."""
    h, w = arms.shape[:2]
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    arms[..., 0] = np.minimum(arms[..., 0], xs)
    arms[..., 1] = np.minimum(arms[..., 1], w - 1 - xs)
    arms[..., 2] = np.minimum(arms[..., 2], ys)
    arms[..., 3] = np.minimum(arms[..., 3], h - 1 - ys)
    return arms.astype(np.int32)


def _random_arms(rng, h, w, max_arm):
    return _clip_to_border(rng.integers(0, max_arm + 1, size=(h, w, 4)))


@pytest.mark.parametrize("max_arm", [MAX_ARM, 3])
def test_band_masks_equal_jax(scene, max_arm):
    ours = torch_mm.band_masks(torch.as_tensor(scene["arms"]), max_arm)
    ref = jax_mm.band_masks(jnp.asarray(scene["arms"]), max_arm)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(),
                                      np.asarray(r, np.float32))
    assert ours[0].sum() > 0


@pytest.mark.parametrize("horizontal_first", [True, False])
def test_cross_pass_matmul_default_arm(scene, horizontal_first):
    """Against JAX's cross_pass_matmul and the port's bitwise roll sum,
    at the tolerance of tests/test_aggregate.py:48."""
    arms, vol = scene["arms"], scene["cost_init"]
    sup_h, sup_v = jax_agg.support_counts(jnp.asarray(arms), MAX_ARM)
    sup = np.array(sup_h if horizontal_first else sup_v, np.float32)
    ref = np.array(jax_mm.cross_pass_matmul(
        jnp.asarray(vol), jnp.asarray(arms), jnp.asarray(sup),
        horizontal_first, MAX_ARM,
    ))
    args = (torch.as_tensor(vol), torch.as_tensor(arms),
            torch.as_tensor(sup), horizontal_first, MAX_ARM)
    ours = torch_mm.cross_pass_matmul(*args).numpy()
    np.testing.assert_allclose(ours, ref, atol=5e-4)
    np.testing.assert_allclose(
        ours, torch_cross.cross_pass_plain(*args).numpy(), atol=5e-4
    )


@pytest.mark.parametrize("horizontal_first", [True, False])
def test_cross_pass_matmul_long_arms(horizontal_first):
    """Random arms up to 130, past the 127 of the JAX roll kernel, at the
    tolerance of tests/test_aggregate.py:154."""
    rng = np.random.default_rng(3)
    h, w, d, max_arm = 40, 55, 12, 130
    arms = _random_arms(rng, h, w, max_arm)
    vol = rng.uniform(0, 2, size=(d, h, w)).astype(np.float32)
    sup = np.ones((h, w), np.float32)
    ref = np.array(jax_mm.cross_pass_matmul(
        jnp.asarray(vol), jnp.asarray(arms), jnp.asarray(sup),
        horizontal_first, max_arm, normalize=False,
    ))
    args = (torch.as_tensor(vol), torch.as_tensor(arms),
            torch.as_tensor(sup), horizontal_first, max_arm, False)
    ours = torch_mm.cross_pass_matmul(*args).numpy()
    np.testing.assert_allclose(ours, ref, rtol=5e-5, atol=5e-2)
    np.testing.assert_allclose(
        ours, torch_cross.cross_pass_plain(*args).numpy(),
        rtol=5e-5, atol=5e-2,
    )


def _vote_case(branch):
    """(di, valid, arms, d, max_arm) for one of JAX's voting branches.

    int8: the worst case of test_region_vote_matmul_int8_branch (full
    127-wide rows of one disparity); bf16: arms up to 130, whose row
    counts pass 255 and take JAX's hi/lo split."""
    if branch == "int8":
        rng = np.random.default_rng(7)
        h, w, d, max_arm = 140, 150, 9, 63
        arms = np.full((h, w, 4), max_arm, np.int32)
        arms[h // 2 :] = rng.integers(0, max_arm + 1,
                                      size=(h - h // 2, w, 4))
        arms = _clip_to_border(arms)
        di = np.zeros((h, w), np.int32)
        di[h // 2 :] = rng.integers(0, d, size=(h - h // 2, w))
        valid = np.ones((h, w), bool)
        valid[h // 2 :] = rng.random((h - h // 2, w)) > 0.3
        return di, valid, arms, d, max_arm
    rng = np.random.default_rng(3)
    h, w, d, max_arm = 40, 55, 12, 130
    arms = _random_arms(rng, h, w, max_arm)
    di = rng.integers(0, d, size=(h, w)).astype(np.int32)
    valid = rng.random((h, w)) > 0.3
    return di, valid, arms, d, max_arm


@pytest.mark.parametrize("branch", ["int8", "bf16"])
def test_region_vote_stats_matmul_bitwise(branch):
    """Bitwise JAX's region_vote_stats_matmul in both of its branches,
    and bitwise the port's plain (roll) statistics."""
    di, valid, arms, d, max_arm = _vote_case(branch)
    ref = jax_mm.region_vote_stats_matmul(
        jnp.asarray(di), jnp.asarray(valid), jnp.asarray(arms), d, max_arm
    )
    args = (torch.as_tensor(di), torch.as_tensor(valid),
            torch.as_tensor(arms), d, max_arm)
    ours = torch_mm.region_vote_stats_matmul(*args)
    routed = torch_vote.region_vote_stats(*args, cross_backend="matmul")
    plain = torch_vote.region_vote_stats_plain(*args)
    for o, r, t, p in zip(ours, ref, routed, plain):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        np.testing.assert_array_equal(t.numpy(), o.numpy())
        np.testing.assert_array_equal(p.numpy(), o.numpy())
    assert int(ours[2].max()) > 127  # regions wider than one int8 row


def test_aggregate_matmul_close_to_jax(scene, monkeypatch):
    """aggregate(cross_backend="matmul") against JAX's dense matmul
    aggregation (ADC_AGG_IMPL=xla) and the port's bitwise roll
    aggregation, at the tolerance of tests/test_aggregate.py:48."""
    monkeypatch.setenv("ADC_AGG_IMPL", "xla")
    ref = np.array(jax_agg.aggregate(
        jnp.asarray(scene["cost_init"]), jnp.asarray(scene["arms"]),
        JaxOptions(**OPTS), use_pallas="matmul",
    ))
    args = (torch.as_tensor(scene["cost_init"]),
            torch.as_tensor(scene["arms"]), ADCensusOptions(**OPTS))
    ours = torch_agg.aggregate(*args, cross_backend="matmul").numpy()
    np.testing.assert_allclose(ours, ref, atol=5e-4)
    np.testing.assert_allclose(ours, torch_agg.aggregate(*args).numpy(),
                               atol=5e-4)


@pytest.mark.parametrize("cross_backend", ["roll", "matmul"])
def test_aggregate_skip_equals_jax(scene, cross_backend, monkeypatch):
    monkeypatch.setenv("ADC_AGG_IMPL", "skip")
    ref = jax_agg.aggregate(
        jnp.asarray(scene["cost_init"]), jnp.asarray(scene["arms"]),
        JaxOptions(**OPTS), use_pallas="matmul",
    )
    ours = torch_agg.aggregate(
        torch.as_tensor(scene["cost_init"]), torch.as_tensor(scene["arms"]),
        ADCensusOptions(**OPTS), cross_backend=cross_backend,
        agg_impl="skip",
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_unknown_backends_raise(scene):
    cost = torch.as_tensor(scene["cost_init"])
    arms = torch.as_tensor(scene["arms"])
    opts = ADCensusOptions(**OPTS)
    with pytest.raises(ValueError, match="cross_backend"):
        torch_agg.aggregate(cost, arms, opts, cross_backend="pallas")
    with pytest.raises(ValueError, match="agg_impl"):
        torch_agg.aggregate(cost, arms, opts, agg_impl="xla")
    di = torch.zeros(arms.shape[:2], dtype=torch.int32)
    valid = torch.ones(arms.shape[:2], dtype=torch.bool)
    with pytest.raises(ValueError, match="cross_backend"):
        torch_vote.region_vote_stats(di, valid, arms, 4, MAX_ARM,
                                     cross_backend="jnp")
