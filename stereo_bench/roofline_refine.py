"""Least device time of kernels M1 (the in-place 3x3 median) and M2
(depth-discontinuity adjustment) from the shape of their work, whatever
implements it, on one NVIDIA H100 SXM (data sheet, 700 W).

* **M1** takes the larger of two times. Its bytes: the (H, W) float32
  map read and written, 8 B a pixel, at the memory rate. Its dependence:
  under t = x + 2y a pixel reads filtered values of wavefronts t-1 to t-3
  only, so the W + 2H - 2 wavefronts come one after another, and each
  takes at least one step of the recurrence: the new value merged into
  the sorted window of the other eight and the median read out, two
  dependent min/max (``M1_STEP_CYCLES``). An implementation that keeps
  the raster order's results cannot take less; a hand-off between rows
  (a shuffle, a barrier) or a memory access on the path only adds.
* **M2**: bytes only, the map read and written. Its chain along a row
  (an adjusted value taken again by the pixel on its right) depends on
  the data, which the trace does not show, so it is left out; the costs
  it reads at edge pixels are left out too.
"""
from __future__ import annotations

from stereo_bench.roofline import bytes_bound_s

# Cycles of one step of M1's recurrence: max(min(v, s4), s3) chained on
# one warp, timed in clock64 cycles by tools/median_step_probe.py (two
# dependent float min/max; no memory access, no barrier in the loop):
# 8.1249 in three runs on an NVIDIA H100 80GB HBM3, 700.00 W, 1,980 MHz,
# torch 2.11.0+cu128, CUDA 12.8 (the kernel's own chain, with its block
# barrier, takes 76.8).
M1_STEP_CYCLES = 8.1249
# The card's top SM clock (nvidia-smi clocks.max.sm), at which the
# cycles are counted: the fastest a step can be.
SM_CLOCK_HZ = 1.980e9


def map_bytes(h: int, w: int) -> int:
    """The (H, W) float32 map read once and written once."""
    return 8 * h * w


def m1_wavefronts(h: int, w: int) -> int:
    """Wavefronts t = x + 2y of an (H, W) map: W + 2H - 2."""
    return w + 2 * h - 2


def m1_step_s() -> float:
    return M1_STEP_CYCLES / SM_CLOCK_HZ


def m1_bound_s(h: int, w: int) -> float:
    return max(bytes_bound_s(map_bytes(h, w)),
               m1_wavefronts(h, w) * m1_step_s())


def m2_bound_s(h: int, w: int) -> float:
    return bytes_bound_s(map_bytes(h, w))


# kernel id (hand_kernels.json) -> least seconds of one launch at (H, W, D)
BOUNDS = {
    "M1": lambda h, w, d: m1_bound_s(h, w),
    "M2": lambda h, w, d: m2_bound_s(h, w),
}


def bound_pct(trace, kid: str):
    """The summed least time of the stretch's launches of kernel ``kid``
    over their summed device time, in %; None where none ran."""
    h, w, d = trace.shape
    bound_s = measured_us = 0.0
    for s, e, n in trace.kernels():
        if trace.kernel_id(n) == kid:
            bound_s += BOUNDS[kid](h, w, d)
            measured_us += e - s
    if measured_us <= 0:
        return None
    return 100.0 * bound_s / (measured_us / 1e6)
