"""The port's one-pair pipeline (adcensus_torch/stages/pipeline.py)
against the JAX package's, on the CPU: the chained stages from the same
initial cost volume, the whole match from raw images, and the entry
points' options, input checks and device rule."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions, options_from_jax
from adcensus_torch.stages import aggregate as torch_agg
from adcensus_torch.stages import pipeline as torch_pipeline
from adcensus_torch.stages import refine as torch_refine
from adcensus_torch.stages import scanline as torch_scan
from adcensus_torch.stages import wta as torch_wta
from adcensus_torch.synthetic import bad_pct, two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import cost as jax_cost
from adcensus_tpu.stages import pipeline as jax_pipeline

OPTS = dict(max_disparity=16, cross_L1=8, cross_L2=4)


@pytest.fixture(scope="module")
def scene():
    """One eager JAX match of a seeded 32x48 pair, with intermediates."""
    left, right, gt = two_layer_pair(32, 48, 4, 9, seed=1)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    out = jax_pipeline.match_core(
        jl, jr, jax_cost.compute_gray(jl), jax_cost.compute_gray(jr),
        JaxOptions(**OPTS), return_intermediates=True, use_pallas=False,
    )
    return left, right, gt, {k: np.array(v) for k, v in out.items()}


def test_chained_stages_bitwise_from_jax_cost(scene):
    """From JAX's cost_init, the port's aggregation, scanline, WTA and
    refinement give JAX's final disparity bit for bit."""
    left, right, _, inter = scene
    opts = ADCensusOptions(**OPTS)
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    arms = torch.as_tensor(inter["arms"])
    vol = torch_agg.aggregate(torch.as_tensor(inter["cost_init"]), arms, opts)
    vol = torch_scan.scanline_optimize(vol, lt, rt, opts)
    refined = torch_refine.multistep_refine(
        torch_wta.wta_left(vol, opts), torch_wta.wta_right(vol, opts), lt,
        vol, arms, opts,
    )
    np.testing.assert_array_equal(
        refined["final"].numpy().view(np.uint32),
        inter["disparity"].view(np.uint32),
    )


def test_match_core_close_from_images(scene):
    """The port's own match from raw images. Its cost volume differs
    from XLA's by one-ulp exp differences, which can move a few
    winners: validity agrees on >= 99 % of pixels, and >= 99 % of the
    jointly valid pixels agree within 1e-3."""
    left, right, gt, inter = scene
    ours = torch_pipeline.match(left, right, ADCensusOptions(**OPTS),
                                return_intermediates=True, device="cpu")
    assert set(ours) == set(inter)
    for k in inter:
        assert ours[k].shape == inter[k].shape, k
        assert ours[k].dtype == inter[k].dtype, k
    a, b = ours["disparity"], inter["disparity"]
    va, vb = np.isfinite(a), np.isfinite(b)
    assert (va == vb).mean() >= 0.99
    both = va & vb
    assert (np.abs(a[both] - b[both]) <= 1e-3).mean() >= 0.99
    assert va.mean() > 0.9
    assert bad_pct(a, gt, 2.0) < 10.0


def test_match_device_and_gray_modes(scene):
    left, right, _, _ = scene
    opts = ADCensusOptions(**OPTS)
    disp = torch_pipeline.match_device(left, right, opts, device="cpu")
    assert disp.shape == (32, 48) and disp.dtype == torch.float32
    out = torch_pipeline.match(left, right, opts, device="cpu")
    np.testing.assert_array_equal(out["disparity"], disp.numpy())
    host64 = torch_pipeline.match(left, right, opts, gray_mode="host64",
                                  device="cpu")
    assert host64["disparity"].shape == (32, 48)
    with pytest.raises(ValueError):
        torch_pipeline.match(left, right, opts, gray_mode="gpu",
                             device="cpu")


def test_options_from_jax_round_trip():
    for jax_opts in (JaxOptions(), JaxOptions(min_disparity=-3, **OPTS),
                     JaxOptions(do_lr_check=False, irv_th=0.5)):
        ours = options_from_jax(dataclasses.asdict(jax_opts))
        assert dataclasses.asdict(ours) == dataclasses.asdict(jax_opts)
        assert ours.disp_range == jax_opts.disp_range
    assert options_from_jax(dataclasses.asdict(JaxOptions())) == \
        ADCensusOptions()
    bad = dict(dataclasses.asdict(JaxOptions()), unknown=1)
    with pytest.raises(ValueError):
        options_from_jax(bad)


def _bad_inputs():
    ok = np.zeros((12, 16, 3), np.uint8)
    return {
        "gray": (ok[..., 0], ok, ADCensusOptions()),
        "four_channels": (np.zeros((12, 16, 4), np.uint8),) * 2
        + (ADCensusOptions(),),
        "float": (ok.astype(np.float32), ok, ADCensusOptions()),
        "shapes_differ": (ok, ok[:, :8], ADCensusOptions()),
        "empty": (ok[:0], ok[:0], ADCensusOptions()),
        "no_range": (ok, ok, ADCensusOptions(min_disparity=8,
                                             max_disparity=8)),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_validate_inputs_rejects_what_jax_rejects(case):
    left, right, opts = _bad_inputs()[case]
    jax_opts = JaxOptions(**dataclasses.asdict(opts))
    with pytest.raises((ValueError, TypeError)) as ref:
        jax_pipeline.validate_inputs(left, right, jax_opts)
    with pytest.raises(ref.type):
        torch_pipeline.validate_inputs(left, right, opts)
    with pytest.raises(ref.type):
        torch_pipeline.validate_inputs(
            torch.as_tensor(left), torch.as_tensor(right), opts
        )
    with pytest.raises(ref.type):
        torch_pipeline.match(left, right, opts, device="cpu")


def test_entry_points_need_cuda_by_default(scene, monkeypatch):
    """Without a card the default device raises; only device="cpu" runs
    on the host."""
    left, right, _, _ = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = ADCensusOptions(**OPTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_pipeline.match_device(left, right, opts)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_pipeline.match(left, right, opts)
