"""The port's cross arms and aggregation (adcensus_torch/stages/arms.py,
stages/aggregate.py, the plain version of kernel B1 in ops/cross_sum.py)
against the JAX package, on the CPU, from JAX-produced inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import cross_sum as torch_cross
from adcensus_torch.stages import aggregate as torch_agg
from adcensus_torch.stages import arms as torch_arms
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.ops import cross_sum_pallas as jax_cross
from adcensus_tpu.stages import aggregate as jax_agg
from adcensus_tpu.stages import arms as jax_arms
from adcensus_tpu.stages import cost as jax_cost

OPTS = dict(max_disparity=16, cross_L1=8, cross_L2=4)
MAX_ARM = 8


def _bits(a):
    return np.asarray(a).view(np.uint32)


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
        "left": left,
        "arms": np.array(jax_arms.build_arms(jl, opts)),
        "cost_init": np.array(cost_init),
    }


def test_arms_bitwise(scene):
    ours = torch_arms.build_arms(
        torch.as_tensor(scene["left"]), ADCensusOptions(**OPTS)
    )
    assert ours.dtype == torch.int32 and ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), scene["arms"])
    assert scene["arms"].max() > 1  # the arms span more than one pixel


@pytest.mark.parametrize("max_arm", [MAX_ARM, 3])
def test_support_counts_bitwise(scene, max_arm):
    ours = torch_agg.support_counts(torch.as_tensor(scene["arms"]), max_arm)
    ref = jax_agg.support_counts(jnp.asarray(scene["arms"]), max_arm)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("horizontal_first", [True, False])
def test_cross_pass_plain_bitwise(scene, horizontal_first):
    """Plain B1 == cross_pass_ref, bitwise, normalized and not."""
    arms, vol = scene["arms"], scene["cost_init"]
    sup_h, sup_v = jax_agg.support_counts(jnp.asarray(arms), MAX_ARM)
    sup = np.array(sup_h if horizontal_first else sup_v, np.float32)
    for normalize in (True, False):
        ref = jax_cross.cross_pass_ref(
            jnp.asarray(vol), jnp.asarray(arms), jnp.asarray(sup),
            horizontal_first, MAX_ARM, normalize,
        )
        ours = torch_cross.cross_pass(
            torch.as_tensor(vol), torch.as_tensor(arms),
            torch.as_tensor(sup), horizontal_first, MAX_ARM, normalize,
        )
        np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_cross_pass_plain_matches_pallas_interpret(scene):
    """Plain B1 == the Pallas kernel in interpret mode, bitwise, on four
    planes of the volume."""
    arms, vol = scene["arms"], scene["cost_init"][:4]
    sup_h, _ = jax_agg.support_counts(jnp.asarray(arms), MAX_ARM)
    sup = np.array(sup_h, np.float32)
    ref = jax_cross.cross_pass(
        jnp.asarray(vol), jnp.asarray(arms), jnp.asarray(sup), True,
        MAX_ARM, use_pallas=True,
    )
    ours = torch_cross.cross_pass(
        torch.as_tensor(vol), torch.as_tensor(arms), torch.as_tensor(sup),
        True, MAX_ARM,
    )
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_aggregate_bitwise(scene):
    ref = jax_agg.aggregate(
        jnp.asarray(scene["cost_init"]), jnp.asarray(scene["arms"]),
        JaxOptions(**OPTS), use_pallas=False,
    )
    ours = torch_agg.aggregate(
        torch.as_tensor(scene["cost_init"]), torch.as_tensor(scene["arms"]),
        ADCensusOptions(**OPTS),
    )
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_cross_pass_rejects_bad_inputs(scene):
    vol = torch.as_tensor(scene["cost_init"])
    arms = torch.as_tensor(scene["arms"])
    sup = torch.ones(vol.shape[1:])
    with pytest.raises(TypeError):
        torch_cross.cross_pass(vol.double(), arms, sup, True, MAX_ARM)
    with pytest.raises(ValueError):
        torch_cross.cross_pass(vol, arms[:-1], sup, True, MAX_ARM)
    strided = vol.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        torch_cross.cross_pass(strided, arms, sup, True, MAX_ARM)
