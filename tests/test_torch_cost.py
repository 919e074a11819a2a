"""The port's cost stage (adcensus_torch/stages/cost.py) against the JAX
package's (adcensus_tpu/stages/cost.py) on seeded synthetic images, on
the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import basic as torch_basic
from adcensus_torch.stages import cost as torch_cost
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.ops import basic as jax_basic
from adcensus_tpu.stages import cost as jax_cost

H, W = 32, 48


@pytest.fixture(scope="module")
def pair():
    left, right, _ = two_layer_pair(H, W, 4, 9, seed=1)
    return left, right


def _gray_pair(left, right):
    return (
        np.array(jax_cost.compute_gray(jnp.asarray(left))),
        np.array(jax_cost.compute_gray(jnp.asarray(right))),
    )


def test_gray_bitwise():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(64, 97, 3), dtype=np.uint8)
    ours = torch_cost.compute_gray(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jax_cost.compute_gray(jnp.asarray(img)))
    )
    np.testing.assert_array_equal(
        torch_cost.compute_gray_host64(img), jax_cost.compute_gray_host64(img)
    )


@pytest.mark.parametrize("shape", [(H, W), (7, 30), (20, 9), (8, 10)])
def test_census_bitwise(shape):
    """Signatures equal census_packed_to_u64 of the JAX (2, H, W) words,
    including the all-zero images of <= 9 columns or <= 7 rows."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    gray = rng.integers(0, 256, size=shape, dtype=np.uint8)
    ours = torch_cost.census_to_u64(
        torch_cost.census_transform_9x7(torch.as_tensor(gray))
    )
    ref = jax_cost.census_packed_to_u64(
        np.asarray(jax_cost.census_transform_9x7(jnp.asarray(gray)))
    )
    np.testing.assert_array_equal(ours, ref)


def test_hamming_bitwise():
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 256, size=(24, 40), dtype=np.uint8)
            for _ in range(2))
    ca, cb = (jax_cost.census_transform_9x7(jnp.asarray(g)) for g in (a, b))
    ta, tb = (torch_cost.census_transform_9x7(torch.as_tensor(g))
              for g in (a, b))
    np.testing.assert_array_equal(
        torch_cost.hamming63(ta, tb).numpy(),
        np.asarray(jax_cost.hamming63(ca, cb)),
    )
    # every bit position counts once
    x = torch.tensor([0, 1, (1 << 63) - 1, 0x5555555555555555 >> 1])
    assert torch_cost.popcount63(x).tolist() == [0, 1, 63, 31]


def test_lround_half_away_from_zero():
    x = np.array([-2.5, -1.5, -0.5, -0.49, 0.0, 0.5, 1.5, 2.5, 3.49, 7.5],
                 np.float32)
    ours = torch_basic.lround(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_basic.lround(x)))
    assert ours.tolist() == [-3, -2, -1, 0, 0, 1, 2, 3, 3, 8]


@pytest.mark.parametrize("d_min,d_max", [(0, 16), (2, 14), (-4, 8)])
def test_cost_volume_close(pair, d_min, d_max):
    """atol 1e-6: torch's and XLA's float32 exp differ by one ulp (6e-8)
    on a few percent of inputs; everything else is the same arithmetic.
    Out-of-range columns cost exactly 1.0 in both."""
    left, right = pair
    gl, gr = _gray_pair(left, right)
    jax_opts = JaxOptions(min_disparity=d_min, max_disparity=d_max)
    opts = ADCensusOptions(min_disparity=d_min, max_disparity=d_max)
    ref = np.asarray(jax_cost.compute_cost_volume(
        jnp.asarray(left), jnp.asarray(right),
        jax_cost.census_transform_9x7(jnp.asarray(gl)),
        jax_cost.census_transform_9x7(jnp.asarray(gr)), jax_opts,
    ))
    ours = torch_cost.compute_cost_volume(
        torch.as_tensor(left), torch.as_tensor(right),
        torch_cost.census_transform_9x7(torch.as_tensor(gl)),
        torch_cost.census_transform_9x7(torch.as_tensor(gr)), opts,
    )
    assert ours.is_contiguous()
    ours = ours.numpy()
    assert ours.shape == ref.shape == (d_max - d_min, H, W)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    xr = np.arange(W)[None, :] - np.arange(d_min, d_max)[:, None]
    oob = np.broadcast_to(((xr < 0) | (xr >= W))[:, None, :], ours.shape)
    assert oob.any()
    assert (ours[oob] == 1.0).all() and (ref[oob] == 1.0).all()
