#!/usr/bin/env python3
"""Time kernel B2 (adcensus_torch/csrc/scanline.cu) at several launch
geometries on one CUDA card, at the main path's size.

Run from the root of a checkout: ``python3 sweep_scanline.py``. On a
seeded (64, 375, 450) cost and code volume, for each pass direction and
each (PB paths per block, K steps per chunk, ring slots) that fits, it
holds the result bitwise against ``scanline_pass_plain`` and prints the
median CUDA-event ms of 20 launches and the ns per scan step, beside the
geometry ``scanline_geometry`` picks. Needs a card; imports no JAX.
"""
from __future__ import annotations

import subprocess
import sys

D, H, W, SEED = 64, 375, 450, 0


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
    rng = np.random.default_rng(SEED)
    cost = torch.as_tensor(rng.random((D, H, W), np.float32) * 2, device=dev)
    code = torch.as_tensor(rng.integers(0, 3, (D, H, W), np.uint8),
                           device=dev)
    for axis, fwd in (("x", True), ("x", False), ("y", True), ("y", False)):
        s, p = (W, H) if axis == "x" else (H, W)
        flags = _scan_flags(s, device=dev)
        args = (cost, code, flags, 1.0, 3.0, axis, not fwd)
        ref = scanline.scanline_pass_plain(*args)
        chosen = scanline.scanline_geometry(D, s, p, axis)
        for pb in (2, 4, 8):
            for k in (16, 32, 64):
                for stages in range(2, scanline.MAX_STAGES + 1):
                    smem = stages * scanline.scanline_layout(D, pb, k, axis)[-1]
                    if smem > scanline.SMEM_LIMIT:
                        continue
                    geo = (pb, k, stages, smem)
                    out = scanline.launch_pass(*args, geo)
                    if not torch.equal(out.view(torch.int32),
                                       ref.view(torch.int32)):
                        raise AssertionError(f"{axis} {fwd} {geo} differs")
                    ms = time_ms(torch, lambda: scanline.launch_pass(
                        *args, geo))
                    mark = "  <- scanline_geometry" if geo == chosen else ""
                    print(f"[sweep] {axis} {'forward' if fwd else 'backward'}"
                          f" PB={pb} K={k} slots={stages} smem={smem}: "
                          f"{ms:.4f} ms, {ms * 1e6 / s:.1f} ns/step; "
                          f"bitwise{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
