#!/usr/bin/env python3
"""Time kernel B4 (adcensus_torch/csrc/ray_interp.cu) at several launch
geometries on one CUDA card, on the main path's inputs.

Run from the root of a checkout: ``python3 sweep_ray_interp.py``. On the
synthetic 375x450, d in [0, 64) pair of ``chip_smoke.py``, for B4's two
interpolation phases and its long-ray case, and for each (pixels a block,
warps a block, probes in flight K), it holds the result bitwise against
``ray_interp_plain`` and
prints the median CUDA-event ms of ``chip_smoke.time_ms``, beside the
geometry ``ray_interp_geometry`` picks. Needs a card; imports no JAX.
"""
from __future__ import annotations

import itertools
import subprocess
import sys


def main() -> int:
    import torch

    import chip_smoke as cs
    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.ops import interp
    from adcensus_torch.stages import refine
    from adcensus_torch.synthetic import two_layer_pair

    if not torch.cuda.is_available():
        print("sweep_ray_interp: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[sweep] {card}")
    dev = torch.device("cuda")
    opts = ADCensusOptions(max_disparity=cs.MAX_D)
    left, right, _ = two_layer_pair(cs.H, cs.W, cs.D_BG, cs.D_FG,
                                    seed=cs.SEED)
    left = torch.as_tensor(left, device=dev)
    right = torch.as_tensor(right, device=dev)
    inter = cs.main_intermediates(torch, left, right, opts)
    offsets = refine.ray_offsets(cs.MAX_D, dev)
    phases = [(label, disp, target, offsets, is_mismatch)
              for label, disp, target, is_mismatch in cs.interp_phases(
                  torch, inter, left, opts)]
    phases.append(cs.long_ray_phase(torch, *phases[0][:3]) + (True,))
    for label, disp, target, offs, is_mismatch in phases:
        args = (disp, left, offs, target, is_mismatch)
        h, w = disp.shape
        n_rays, n_steps, _ = offs.shape
        ref = interp.ray_interp_plain(*args)
        chosen = interp.ray_interp_geometry(h, w, n_rays, n_steps)
        for pixels, warps, k in itertools.product(
                (64, 128, 256, 512), (4, 8, 16), interp.CHUNKS):
            geo = (pixels, warps, k, interp.ray_interp_smem(pixels))
            for a, b in zip(interp.launch_pass(*args, geo), ref):
                cs.max_abs_err(torch, a, b)  # raises unless bitwise
            ms = cs.time_ms(torch, lambda: interp.launch_pass(*args, geo))
            mark = "  <- ray_interp_geometry" if geo == chosen else ""
            print(f"[sweep] {label} ({int(target.sum())} targets) "
                  f"pixels={pixels} warps={warps} K={k}: {ms:.4f} ms; "
                  f"bitwise{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
