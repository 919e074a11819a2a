#!/usr/bin/env python3
"""Time the least step of the in-place median's recurrence on the card.

    python3 tools/median_step_probe.py

from the root of the repository, on a machine with an NVIDIA card and
nvcc. It builds ``tools/median_step_probe.cu`` with the port's nvcc
flags into ``build/probe/``, runs its chain on one warp (the new value
merged into a sorted window and the median read out: two dependent
min/max a step) for two numbers of steps, and prints one JSON line: the
cycles a step (the difference of the two runs over the difference of
their steps, so that the fixed cost of the timing cancels), the card's
top SM clock and its name and power limit from ``nvidia-smi``, and a step in
ns at that clock. ``stereo_bench/roofline_refine.py`` keeps the first
as M1_STEP_CYCLES.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SOURCE = ROOT / "tools" / "median_step_probe.cu"
LIBRARY = ROOT / "build" / "probe" / "libmedian_step_probe.so"
ROUNDS = (1 << 12, 1 << 13)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build() -> ctypes.CDLL:
    from adcensus_torch.ops import _build

    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(LIBRARY),
                    str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(LIBRARY))
    lib.median_step_cycles.argtypes = (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p)
    lib.median_step_cycles.restype = ctypes.c_int
    lib.median_step_probe_steps.restype = ctypes.c_int
    return lib


def cycles_a_step(torch, lib) -> float:
    steps = lib.median_step_probe_steps()
    gen = torch.Generator().manual_seed(13)
    lo = torch.rand((steps, 32), generator=gen) * 32
    hi = lo + torch.rand((steps, 32), generator=gen) * 32
    windows = torch.cat([torch.stack([lo, hi], 1).reshape(-1, 32),
                         torch.rand((1, 32), generator=gen) * 64]).cuda()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    taken = []
    for rounds in ROUNDS:
        best = None
        for _ in range(3):  # the least of three warm runs
            err = lib.median_step_cycles(cycles.data_ptr(), sink.data_ptr(),
                                         windows.data_ptr(), rounds, stream)
            if err:
                raise RuntimeError(f"median_step_cycles failed: {err}")
            c = int(cycles.item())
            best = c if best is None else min(best, c)
        taken.append(best)
    return (taken[1] - taken[0]) / ((ROUNDS[1] - ROUNDS[0]) * steps)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    lib = build()
    mhz = float(smi("clocks.max.sm").split()[0])
    chain = cycles_a_step(torch, lib)
    print(json.dumps({
        "card": smi("name,power.limit"), "clocks_max_sm_mhz": mhz,
        "cycles_a_step": chain, "ns_a_step": chain / mhz * 1e3,
        "torch": torch.__version__,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
