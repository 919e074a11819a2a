#!/usr/bin/env python3
"""Time kernel B2 (adcensus_torch/csrc/scanline.cu) at several launch
geometries on one CUDA card, at the main path's size and at D 640.

Run from the root of a checkout: ``python3 sweep_scanline.py``. On a
seeded (64, 375, 450) cost volume with seeded distance maps (its four
pass directions), and on a rank's slabs of the full-size Middlebury 2014
cell (D 640: the x pass on a 497x2632 row slab, the y pass on a 1988x658
column slab), for each (PB paths per block, K steps per chunk, ring
slots) that fits, it holds the result bitwise against
``scanline_pass_plain`` fed ``penalty_codes``' volume and prints the
median CUDA-event ms of its launches and the ns per scan step, beside the
geometry ``scanline_geometry`` picks. Needs a card; imports no JAX.
"""
from __future__ import annotations

import subprocess
import sys

SEED, TSO = 0, 15
PASSES = (("x", True), ("x", False), ("y", True), ("y", False))
# (label, D, H, W, passes, PB grid, K grid)
CASES = (
    ("cone", 64, 375, 450, PASSES, (2, 4, 8), (16, 32, 64)),
    ("d640 rows", 640, 497, 2632, PASSES[:1], (1, 2, 4), (2, 4, 8, 16)),
    ("d640 cols", 640, 1988, 658, PASSES[2:3], (1, 2, 4), (2, 4, 8, 16)),
)


def main() -> int:
    import numpy as np
    import torch

    from adcensus_torch.ops import scanline
    from adcensus_torch.stages.scanline import _scan_flags
    from chip_smoke import time_ms

    if not torch.cuda.is_available():
        print("sweep_scanline: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[sweep] {card}")
    dev = torch.device("cuda")
    for label, D, H, W, passes, pbs, ks in CASES:
        rng = np.random.default_rng(SEED + D)
        cost = torch.as_tensor(rng.random((D, H, W), np.float32) * 2,
                               device=dev)
        d1, rd = (torch.as_tensor(rng.integers(0, 2 * TSO, (H, W), np.int32),
                                  device=dev) for _ in range(2))
        code = scanline.penalty_codes(d1, rd, D, TSO)
        left, right = d1 >= TSO, rd >= TSO
        for axis, fwd in passes:
            s, p = (W, H) if axis == "x" else (H, W)
            flags = _scan_flags(s, device=dev)
            ref = scanline.scanline_pass_plain(cost, code, flags, 1.0, 3.0,
                                               axis, not fwd)
            args = (cost, left, right, flags, 1.0, 3.0, axis, not fwd, 0, 0,
                    W)
            chosen = scanline.scanline_geometry(D, s, p, axis)
            for pb in pbs:
                for k in ks:
                    slot = scanline.scanline_layout(D, pb, k, axis)[-1]
                    for stages in range(2, scanline.MAX_STAGES + 1):
                        smem = stages * slot
                        if smem > scanline.SMEM_LIMIT:
                            continue
                        geo = (pb, k, stages, smem)
                        out = scanline.launch_pass(*args, geo)
                        if not torch.equal(out.view(torch.int32),
                                           ref.view(torch.int32)):
                            raise AssertionError(
                                f"{label} {axis} {fwd} {geo} differs")
                        del out
                        ms = time_ms(torch, lambda: scanline.launch_pass(
                            *args, geo))
                        mark = ("  <- scanline_geometry" if geo == chosen
                                else "")
                        print(f"[sweep] {label} {axis} "
                              f"{'forward' if fwd else 'backward'} PB={pb} "
                              f"K={k} slots={stages} smem={smem}: "
                              f"{ms:.4f} ms, {ms * 1e6 / s:.1f} ns/step; "
                              f"bitwise{mark}", flush=True)
            del ref
        del cost, code
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
