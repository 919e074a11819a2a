"""The port's metrics (adcensus_torch/eval/metrics.py) against the JAX
package's on seeded maps with NaN ground truth and invalid
predictions."""
import numpy as np
import pytest

from adcensus_torch.eval import metrics
from adcensus_tpu.eval import metrics as jax_metrics


def _maps(seed, h=40, w=60):
    """(prediction with 10 % +inf and one NaN, ground truth with 15 %
    NaN), disparities near each other."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 64, (h, w)).astype(np.float32)
    disp = (gt + rng.normal(0, 1.5, (h, w))).astype(np.float32)
    disp[rng.random((h, w)) < 0.1] = np.inf
    disp[0, 0] = np.nan
    gt[rng.random((h, w)) < 0.15] = np.nan
    return disp, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_equals_jax(seed):
    disp, gt = _maps(seed)
    ours = metrics.evaluate(disp, gt)
    assert ours == jax_metrics.evaluate(disp, gt)
    assert set(ours) == {"density_pct", "bad_0_5_pct", "bad_1_0_pct",
                         "bad_2_0_pct", "bad_4_0_pct", "rms"}
    assert 0 < ours["bad_2_0_pct"] < 100
    assert metrics.evaluate(disp, None) == {"density_pct":
                                            metrics.density(disp)}


@pytest.mark.parametrize("count_invalid", [True, False])
def test_bad_delta_and_rms_equal_jax(count_invalid):
    disp, gt = _maps(3)
    for delta in (0.5, 2.0):
        assert metrics.bad_delta(disp, gt, delta, count_invalid) == \
            jax_metrics.bad_delta(disp, gt, delta, count_invalid)
    assert metrics.rms_error(disp, gt) == jax_metrics.rms_error(disp, gt)
    none = np.full_like(disp, np.inf)
    assert np.isnan(metrics.rms_error(none, gt))


@pytest.mark.parametrize("seed", [0, 1])
def test_disparity_agreement_equals_jax(seed):
    a, _ = _maps(seed)
    b = a.copy()
    rng = np.random.default_rng(seed + 10)
    b[rng.random(b.shape) < 0.05] = np.inf
    b[rng.random(b.shape) < 0.05] += 0.5
    ours = metrics.disparity_agreement(a, b)
    assert ours == jax_metrics.disparity_agreement(a, b)
    assert ours["validity_agreement"] < 1.0 and ours["max_abs_diff"] > 0
    empty = np.full((3, 3), np.inf, np.float32)
    assert metrics.disparity_agreement(empty, empty) == \
        jax_metrics.disparity_agreement(empty, empty)
