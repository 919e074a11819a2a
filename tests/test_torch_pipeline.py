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
from adcensus_torch.stages import cost as torch_cost
from adcensus_torch.stages import pipeline as torch_pipeline
from adcensus_torch.stages import refine as torch_refine
from adcensus_torch.stages import scanline as torch_scan
from adcensus_torch.stages import wta as torch_wta
from adcensus_torch.synthetic import bad_pct, two_layer_pair
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import cost as jax_cost
from adcensus_tpu.stages import pipeline as jax_pipeline

OPTS = dict(max_disparity=16, cross_L1=8, cross_L2=4)


def _jax_match(left, right, opts):
    """One eager JAX match_core with intermediates, as numpy arrays."""
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    out = jax_pipeline.match_core(
        jl, jr, jax_cost.compute_gray(jl), jax_cost.compute_gray(jr),
        JaxOptions(**opts), return_intermediates=True, use_pallas=False,
    )
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def scene():
    """One eager JAX match of a seeded 32x48 pair, with intermediates."""
    left, right, gt = two_layer_pair(32, 48, 4, 9, seed=1)
    return left, right, gt, _jax_match(left, right, OPTS)


# Option sets of the chained-stage test, each one eager JAX match of the
# scene's pair: today's options, a negative min_disparity (same D), and
# voting thresholds low enough that voting fills more pixels
CHAINED_CASES = {
    "default": OPTS,
    "negative_min_disparity": dict(OPTS, min_disparity=-3, max_disparity=13),
    "low_voting_thresholds": dict(OPTS, irv_ts=2, irv_th=0.2),
}


@pytest.mark.parametrize("case", sorted(CHAINED_CASES))
def test_chained_stages_bitwise_from_jax_cost(scene, case):
    """From JAX's cost_init, the port's aggregation, scanline, WTA and
    refinement give JAX's final disparity bit for bit."""
    left, right, _, inter = scene
    opts_kw = CHAINED_CASES[case]
    if case != "default":
        default_holes = np.isinf(inter["after_voting"]).sum()
        inter = _jax_match(left, right, opts_kw)
        if case == "low_voting_thresholds":
            assert np.isinf(inter["after_voting"]).sum() < default_holes
    opts = ADCensusOptions(**opts_kw)
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


# The flag-gated refinement stages: the in-place median (kernel M1's plain
# version) and discontinuity adjustment (kernel M2's), each and both
FLAG_CASES = {
    "exact_median": dict(exact_median=True),
    "discontinuity": dict(do_discontinuity_adjustment=True),
    "both": dict(exact_median=True, do_discontinuity_adjustment=True),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_flags_stages_bitwise_from_jax_cost(scene, case):
    """From JAX's cost_init, every stage output of the port's chain with
    the flags on, "after_discontinuity" included, is JAX's eager
    match_core's bit for bit."""
    left, right, _, default = scene
    opts_kw = dict(OPTS, **FLAG_CASES[case])
    inter = _jax_match(left, right, opts_kw)
    opts = ADCensusOptions(**opts_kw)
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    arms = torch.as_tensor(inter["arms"])
    ours = {"cost_aggr": torch_agg.aggregate(
        torch.as_tensor(inter["cost_init"]), arms, opts)}
    ours["cost_scan"] = torch_scan.scanline_optimize(ours["cost_aggr"], lt,
                                                     rt, opts)
    ours["disp_left_raw"] = torch_wta.wta_left(ours["cost_scan"], opts)
    ours["disp_right_raw"] = torch_wta.wta_right(ours["cost_scan"], opts)
    refined = torch_refine.multistep_refine(
        ours["disp_left_raw"], ours["disp_right_raw"], lt, ours["cost_scan"],
        arms, opts,
    )
    ours["disparity"] = refined.pop("final")
    ours.update(refined)
    assert set(ours) == set(inter) - {"cost_init", "arms"}
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      inter[k].view(np.uint32), err_msg=k)
    assert not np.array_equal(inter["disparity"], default["disparity"])
    if "do_discontinuity_adjustment" in FLAG_CASES[case]:
        assert not np.array_equal(inter["after_discontinuity"],
                                  inter["after_interpolation"])


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_match_with_flags_close_from_images(scene, case):
    """The port's own match from images with the flags on against JAX's,
    to the tolerance of test_match_core_close_from_images."""
    left, right, gt, _ = scene
    opts_kw = dict(OPTS, **FLAG_CASES[case])
    ours = torch_pipeline.match(left, right, ADCensusOptions(**opts_kw),
                                device="cpu")["disparity"]
    _assert_close_match(ours, _jax_match(left, right, opts_kw)["disparity"],
                        gt)


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
    _assert_close_match(ours["disparity"], inter["disparity"], gt)


def _assert_close_match(a, b, gt):
    """The port's disparity ``a`` against JAX's ``b`` from the same
    images: validity agrees on >= 99 % of pixels, >= 99 % of the jointly
    valid pixels agree within 1e-3, and the map is dense and good."""
    va, vb = np.isfinite(a), np.isfinite(b)
    assert (va == vb).mean() >= 0.99
    both = va & vb
    assert (np.abs(a[both] - b[both]) <= 1e-3).mean() >= 0.99
    assert va.mean() > 0.9
    assert bad_pct(a, gt, 2.0) < 10.0


@pytest.mark.parametrize("agg_impl", [None, "banded"])
def test_match_core_matmul_close_to_jax(scene, agg_impl, monkeypatch):
    """The matmul backend, dense or banded (kernel B5's plain version),
    against JAX's match_core(use_pallas="matmul") with ADC_AGG_IMPL set
    to match, eagerly, from the same images."""
    left, right, gt, _ = scene
    monkeypatch.setenv("ADC_AGG_IMPL", agg_impl or "xla")
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    ref = jax_pipeline.match_core(
        jl, jr, jax_cost.compute_gray(jl), jax_cost.compute_gray(jr),
        JaxOptions(**OPTS), use_pallas="matmul",
    )["disparity"]
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    ours = torch_pipeline.match_core(
        lt, rt, torch_cost.compute_gray(lt), torch_cost.compute_gray(rt),
        ADCensusOptions(**OPTS), cross_backend="matmul", agg_impl=agg_impl,
    )["disparity"]
    _assert_close_match(ours.numpy(), np.asarray(ref), gt)


def test_entry_points_reject_unknown_backends(scene):
    left, right, _, _ = scene
    opts = ADCensusOptions(**OPTS)
    lt, rt = torch.as_tensor(left), torch.as_tensor(right)
    gray = torch_cost.compute_gray(lt)
    for kwargs in (dict(cross_backend="pallas"), dict(cross_backend=True),
                   dict(agg_impl="xla"), dict(agg_impl="")):
        with pytest.raises(ValueError):
            torch_pipeline.match_core(lt, rt, gray, gray, opts, **kwargs)
        with pytest.raises(ValueError):
            torch_pipeline.match_device(left, right, opts, device="cpu",
                                        **kwargs)
        with pytest.raises(ValueError):
            torch_pipeline.match(left, right, opts, device="cpu", **kwargs)


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
