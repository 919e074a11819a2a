"""Kernel W1 (csrc/wta.cu, winner-take-all of both views) on the CPU: a
numpy emulation of its single scan over d, a thread's work on every
column at once, held bitwise to the JAX package's wta_left and wta_right
and to the port's plain versions (through stages/wta.py:wta, which runs
them for CPU tensors). The scan tracks the running first minimum and
takes the winner's neighbours from the previous and the next value it
sees. Cases: D of 1, 2, 3 and 64, W below D, min_disparity -4, 0 and 3,
columns at or beyond real_w read as Large_Float, constant planes, exact
ties at d and d + 1, integer costs (flat parabolas), and columns whose
right-view planes all lie outside the image; and NaN cells, which
argmin takes first (the plain left view; JAX's scan skips them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _wta_cases import CASES, volume
from adcensus_torch.config import ADCensusOptions
from adcensus_torch.stages import wta as torch_wta
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import wta as jax_wta

LARGE = np.float32(99999.0)  # csrc/common.cuh ADC_LARGE_FLOAT


def w1_emulated(cost: np.ndarray, min_d: int, real_w: int):
    """csrc/wta.cu on every (y, x) at once: one scan over d a view, as a
    thread runs it, then the parabola and the border rule."""
    d_range, h, w = cost.shape
    x = np.arange(w)
    out = []
    for left in (True, False):
        best = np.zeros((h, w), np.int64)
        cmin = np.full((h, w), np.inf if left else LARGE, np.float32)
        c1 = np.zeros((h, w), np.float32)
        c2 = np.zeros((h, w), np.float32)
        prev = np.full((h, w), 0.0 if left else LARGE, np.float32)
        taken = np.zeros((h, w), bool)
        for d in range(d_range):
            if left:
                v = np.where(x < real_w, cost[d], LARGE)
            else:
                xr = x + d + min_d
                ok = (xr >= 0) & (xr < real_w)
                v = np.where(ok, cost[d][:, np.clip(xr, 0, w - 1)], LARGE)
            c2 = np.where(taken, v, c2)
            take = v < cmin
            if left:  # argmin: the first NaN, kept
                take |= np.isnan(v) & ~np.isnan(cmin)
            best = np.where(take, d, best)
            cmin = np.where(take, v, cmin)
            c1 = np.where(take, prev, c1)
            taken, prev = take, v
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = (c1 + c2) - np.float32(2.0) * cmin
            best_d = (best + min_d).astype(np.float32)
            para = np.where(denom != 0,
                            best_d + (c1 - c2) / (denom * np.float32(2.0)),
                            best_d)
        border = (best == 0) | (best == d_range - 1)
        out.append(np.where(border, np.float32(np.inf) if left else best_d,
                            para).astype(np.float32))
    return tuple(out)


def masked(cost: np.ndarray, real_w: int) -> np.ndarray:
    """The volume with columns at or beyond ``real_w`` set to Large_Float,
    as the sharded layer fed the plain views before W1."""
    return np.where(np.arange(cost.shape[2]) >= real_w, LARGE, cost)


def _case(name):
    d, _, w, min_d, real_w, _ = CASES[name]
    return volume(name), min_d, w if real_w is None else real_w, dict(
        min_disparity=min_d, max_disparity=min_d + d)


def _same(a, b):
    """Bitwise, with NaN equal to NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.uint32),
                                  b[~nan].view(np.uint32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_w1_bitwise_jax(name):
    cost, min_d, real_w, opts = _case(name)
    ours = w1_emulated(cost, min_d, real_w)
    vol = jnp.asarray(masked(cost, real_w))
    _same(ours[0], jax_wta.wta_left(vol, JaxOptions(**opts)))
    _same(ours[1], jax_wta.wta_right(vol, JaxOptions(**opts)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_w1_bitwise_plain(name):
    cost, min_d, real_w, opts = _case(name)
    ours = w1_emulated(cost, min_d, real_w)
    left, right = torch_wta.wta(torch.as_tensor(cost),
                                ADCensusOptions(**opts), real_w=real_w)
    _same(ours[0], left.numpy())
    _same(ours[1], right.numpy())


def test_emulated_w1_nan_as_argmin():
    """NaN cells: the left view takes the first NaN, as argmin does; the
    right view's strict comparison skips them."""
    cost, min_d, real_w, opts = _case("min_d_neg")
    rng = np.random.default_rng(5)
    cost[rng.random(cost.shape) < 0.02] = np.nan
    ours = w1_emulated(cost, min_d, real_w)
    assert np.isnan(ours[0]).any()
    left, right = torch_wta.wta(torch.as_tensor(cost),
                                ADCensusOptions(**opts))
    _same(ours[0], left.numpy())
    _same(ours[1], right.numpy())
