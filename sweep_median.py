#!/usr/bin/env python3
"""Time kernel M1 (adcensus_torch/csrc/median_inplace.cu) over map shapes
on one CUDA card.

Run from the root of a checkout: ``python3 sweep_median.py``. For each
(H, W), on a seeded map of disparities in [0.5, 128) with 15 % +inf (as
``chip_smoke.median_extra_cases`` makes them), it holds the kernel
bitwise against ``median_inplace_plain`` and prints the median
CUDA-event ms of ``chip_smoke.time_ms``, the ns a wavefront (W + 2H - 2
of them), the SM cycles a step of the kernel's walk (band delays, head
start and tail included) at the card's top SM clock, the block and its
rows a thread, and the recurrence bound of ``chip_smoke.median_recurrence``.
A map of 32 rows runs one warp, so its cycles a step are one warp's
step alone. Needs a card; imports no JAX.
"""
from __future__ import annotations

import subprocess
import sys

SHAPES = ((32, 4000), (40, 3000), (375, 450), (555, 653), (1000, 64),
          (1100, 64), (1025, 2100), (1988, 2964))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from adcensus_torch.ops import median

    if not torch.cuda.is_available():
        print("sweep_median: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    mhz = cs.sm_clock_mhz()
    print(f"[sweep] {card}, top SM clock {mhz:.0f} MHz")
    rng = np.random.default_rng(cs.SEED)
    for h, w in SHAPES:
        src = rng.uniform(0.5, 128.0, (h, w)).astype(np.float32)
        src[rng.random((h, w)) < 0.15] = np.inf
        disp = torch.as_tensor(src, device="cuda")
        cs.max_abs_err(torch, median.median_inplace(disp),
                       median.median_inplace_plain(disp))  # bitwise
        ms = cs.time_ms(torch, lambda: median.median_inplace(disp))
        threads, rows, _ = median.median_inplace_geometry(h, w)
        _, _, last = median.median_inplace_schedule(h, w)
        walk = last + median.TAIL - median.FIRST_STEP + 1
        waves = w + 2 * h - 2
        rec_ms, per_step, _ = cs.median_recurrence(torch, threads, waves)
        print(f"[sweep] {h}x{w}: {ms:.4f} ms, {ms * 1e6 / waves:.1f} ns a "
              f"wavefront, {ms * 1e3 * mhz / walk:.0f} cycles a step of "
              f"{walk}; {threads} threads, {rows} row(s) a thread; "
              f"recurrence bound {rec_ms:.4f} ms ({per_step:.1f} cycles a "
              "step); bitwise")
    return 0


if __name__ == "__main__":
    sys.exit(main())
