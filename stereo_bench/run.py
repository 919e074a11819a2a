#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 stereo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, the program
(``adcensus_torch``) and one NVIDIA card or more. With ``--trace 0`` the
run measures the cell's end-to-end metrics over a window of ``--seconds``;
with ``--trace 1`` its per-layer metrics over a profiled stretch of
requests. Either way it then compares a sample of the outputs with the
plain reference. The last line of standard output is the result as one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error. Without a CUDA card, or with fewer cards than
the cell asks for, it prints no result and exits 2; if JAX or the JAX
package is loaded once the window has closed, it exits 3.
"""
import os
import time

_T0 = time.perf_counter()


def _age_at_start() -> float:
    """Seconds the process had run when this module started, from
    /proc (0 where there is none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _age_at_start()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def process_age() -> float:
    return _AGE0 + time.perf_counter() - _T0


def card() -> str:
    """The card's name, power limit and top SM clock from nvidia-smi."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return out.stdout.strip().replace("\n", "; ") or "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from stereo_bench import harness
    cell = harness.Cell.from_spec(harness.load_spec(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print(f"[bench] card {card()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", process_age=process_age)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"error: the process holds {loaded} once the window has "
              "closed", file=sys.stderr)
        return 3
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(out.line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
