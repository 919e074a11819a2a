"""The port's scanline optimization and WTA (adcensus_torch/stages/
scanline.py, stages/wta.py, the plain version of kernel B2 in
ops/scanline.py) against the JAX package, on the CPU, from JAX-produced
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import scanline as torch_scan_op
from adcensus_torch.stages import scanline as torch_scan
from adcensus_torch.stages import wta as torch_wta
from adcensus_torch.synthetic import two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import cost as jax_cost
from adcensus_tpu.stages import pipeline as jax_pipeline
from adcensus_tpu.stages import scanline as jax_scan
from adcensus_tpu.stages import wta as jax_wta

OPTS = dict(max_disparity=16, cross_L1=8, cross_L2=4)
PASSES = [("x", True), ("x", False), ("y", True), ("y", False)]


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.fixture(scope="module")
def scene():
    """One eager JAX match of a seeded 32x48 pair, with intermediates."""
    left, right, _ = two_layer_pair(32, 48, 4, 9, seed=1)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    out = jax_pipeline.match_core(
        jl, jr, jax_cost.compute_gray(jl), jax_cost.compute_gray(jr),
        JaxOptions(**OPTS), return_intermediates=True, use_pallas=False,
    )
    return left, right, {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize("d_min,d_max", [(0, 16), (3, 12), (-4, 8)])
@pytest.mark.parametrize("axis,forward", PASSES)
def test_penalty_code_bitwise(scene, axis, forward, d_min, d_max):
    left, right, _ = scene
    ref = jax_scan.penalty_code(
        jnp.asarray(left), jnp.asarray(right),
        JaxOptions(min_disparity=d_min, max_disparity=d_max), axis, forward,
    )
    ours = torch_scan.penalty_code(
        torch.as_tensor(left), torch.as_tensor(right),
        ADCensusOptions(min_disparity=d_min, max_disparity=d_max),
        axis, forward,
    )
    assert ours.dtype == torch.uint8 and ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis,forward", PASSES)
def test_scanline_pass_plain_bitwise(scene, axis, forward):
    """Plain B2 == scanline_pass(use_pallas=False), each direction."""
    left, right, inter = scene
    vol = inter["cost_aggr"]
    ref = jax_scan.scanline_pass(
        jnp.asarray(vol), jnp.asarray(left), jnp.asarray(right),
        JaxOptions(**OPTS), axis, forward, use_pallas=False,
    )
    ours = torch_scan.scanline_pass(
        torch.as_tensor(vol),
        torch_scan.distances(torch.as_tensor(left), torch.as_tensor(right),
                             axis, forward),
        ADCensusOptions(**OPTS), axis, forward,
    )
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_scanline_pass_plain_matches_pallas_interpret(scene):
    """Plain B2 == the Pallas kernel in interpret mode, one backward
    pass along x."""
    left, right, inter = scene
    vol = inter["cost_aggr"]
    ref = jax_scan.scanline_pass(
        jnp.asarray(vol), jnp.asarray(left), jnp.asarray(right),
        JaxOptions(**OPTS), "x", False, use_pallas=True,
    )
    ours = torch_scan.scanline_pass(
        torch.as_tensor(vol),
        torch_scan.distances(torch.as_tensor(left), torch.as_tensor(right),
                             "x", False),
        ADCensusOptions(**OPTS), "x", False,
    )
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_scanline_flags_pad_and_seed(scene):
    """PAD steps pass the carry through and emit the raw cost; SEED
    copies its cost; the same flags drive the JAX scan. Backward along
    x, so the flags' first steps are the last columns."""
    _, _, inter = scene
    vol = inter["cost_aggr"]
    d, h, w = vol.shape
    valid = np.ones(w, bool)
    valid[:3] = valid[-2:] = False
    rng = np.random.default_rng(5)
    d1, rd = (torch.as_tensor(rng.integers(0, 30, (h, w), np.int32))
              for _ in range(2))
    opts = ADCensusOptions(**OPTS)
    code = torch_scan.code_volume(d1, rd, opts, w, 0).numpy()
    flags = torch_scan._scan_flags(w, torch.as_tensor(valid))
    assert flags.tolist()[:5] == [0, 0, 0, 1, 2]
    np.testing.assert_array_equal(
        flags.numpy(), np.asarray(jax_scan._scan_flags(w, jnp.asarray(valid)))
    )
    ours = torch_scan_op.scanline_pass(
        torch.as_tensor(vol), d1, rd, flags, opts.so_tso, 1.0, 3.0, "x",
        True,
    )
    # the JAX scan on the same (S, P, D) layout, codes and flags
    p1, p2 = jax_scan._decode_penalties(jnp.asarray(code), JaxOptions())
    perm = (2, 1, 0)
    ref = jax_scan.scanline_pass_scan(
        *(jnp.flip(jnp.transpose(v, perm), 0)
          for v in (jnp.asarray(vol), p1, p2)),
        jnp.asarray(flags.numpy()),
    )
    ref = jnp.transpose(jnp.flip(ref, 0), (2, 1, 0))
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))
    np.testing.assert_array_equal(_bits(ours.numpy()[:, :, -4:]),
                                  _bits(vol[:, :, -4:]))


def test_scanline_optimize_bitwise(scene):
    left, right, inter = scene
    ours = torch_scan.scanline_optimize(
        torch.as_tensor(inter["cost_aggr"]), torch.as_tensor(left),
        torch.as_tensor(right), ADCensusOptions(**OPTS),
    )
    np.testing.assert_array_equal(_bits(ours.numpy()),
                                  _bits(inter["cost_scan"]))


def test_wta_left_bitwise(scene):
    _, _, inter = scene
    ours = torch_wta.wta_left(torch.as_tensor(inter["cost_scan"]),
                              ADCensusOptions(**OPTS))
    np.testing.assert_array_equal(_bits(ours.numpy()),
                                  _bits(inter["disp_left_raw"]))
    assert np.isinf(inter["disp_left_raw"]).any()


@pytest.mark.parametrize("d_min", [0, 2])
def test_wta_right_bitwise(scene, d_min):
    _, _, inter = scene
    vol = inter["cost_scan"]
    opts = dict(OPTS, min_disparity=d_min, max_disparity=16 + d_min)
    ref = jax_wta.wta_right(jnp.asarray(vol), JaxOptions(**opts))
    ours = torch_wta.wta_right(torch.as_tensor(vol),
                               ADCensusOptions(**opts))
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))
