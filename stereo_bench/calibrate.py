#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, in one process
on the card: the program on many seeds, each a short window at the
cell's own load, and the control (the reference in bfloat16, in the
program's place) on a few.

    python3 stereo_bench/calibrate.py --workload <cell> --seeds 11-22 \\
        --control-seeds 31-33 --seconds 3 [--out <file.jsonl>]

Each run prints one JSON line: its kind, seed, ``correct``, the numbers
compared and the end-to-end metrics. The benchmark's own runs do not run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from stereo_bench import harness
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.from_spec(harness.load_spec(ROOT), args.workload)
    out = open(args.out, "a") if args.out else None
    control = harness.control_entry(cell, "cuda", torch.bfloat16)
    runs = ([("program", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds])
    for kind, seed in runs:
        t0 = time.perf_counter()
        r = harness.run_cell(
            cell, seed, args.seconds if kind == "program" else 0.0, False,
            device="cuda", entry=control if kind == "control" else None,
            warmup=1 if kind == "program" else 0,
            log=lambda *a: print(*a, file=sys.stderr))
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                           "correct": r.correct, "attempted": r.attempted,
                           "checks": r.checks, "metrics": r.metrics,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
