"""Command-line interface of the PyTorch/CUDA port, mirroring the reference
app (main.cpp:26-145) and ``adcensus_tpu/cli.py``.

Usage:
    python -m adcensus_torch.cli LEFT.png RIGHT.png [MIN_DISP] [MAX_DISP]
    python -m adcensus_torch.cli --pair Cone        # Data/Cone/ at the repo root
    python -m adcensus_torch.cli L.png R.png 0 64 --device cpu   # no card

Saves <prefix>-d.png (normalized gray) and <prefix>-c.png (JET colormap),
like SaveDisparityMap (main.cpp:180-210), prints the match time or, with
--timing, per-stage times, and the metrics (bad-delta where ground truth
is known). It runs on the GPU by default and raises without one; only
--device cpu runs on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.eval.metrics import evaluate
from adcensus_torch.io.image import (
    get_pair,
    load_image_rgb,
    save_disparity_cloud,
    save_disparity_map,
)
from adcensus_torch.ops.basic import resolve_device
from adcensus_torch.stages.pipeline import match

# --backend keeps the JAX CLI's choices: its bit-exact masked-roll
# backends ("pallas", "jnp") are the port's "roll" (kernels B1/B3), its
# band-matrix backend is "matmul".
BACKENDS = {"pallas": "roll", "jnp": "roll", "matmul": "matmul"}


def run_pair(
    left: np.ndarray,
    right: np.ndarray,
    opts: ADCensusOptions,
    out_prefix: str | None = None,
    gt: np.ndarray | None = None,
    verbose: bool = True,
    gray_mode: str = "device",
    cross_backend: str = "roll",
    device="cuda",
):
    """One match through ``stages.pipeline.match``: (disparity, metrics,
    seconds). Saves the two PNGs under ``out_prefix`` if given."""
    h, w, _ = left.shape
    if verbose:
        print(f"w = {w}, h = {h}, d = [{opts.min_disparity},"
              f"{opts.max_disparity}]")
    t0 = time.perf_counter()
    res = match(left, right, opts, gray_mode=gray_mode, device=device,
                cross_backend=cross_backend)
    t1 = time.perf_counter()
    disp = res["disparity"]
    mpix_ds = h * w * opts.disp_range / (t1 - t0) / 1e6
    if verbose:
        print(f"match: {t1 - t0:.3f} s  ({mpix_ds:.1f} Mpix*disp/s, incl. "
              "kernel builds on first call)")
    metrics = evaluate(disp, gt)
    if verbose:
        print(json.dumps(metrics, indent=2))
    if out_prefix:
        save_disparity_map(disp, out_prefix)
    return disp, metrics, t1 - t0


def _parser():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("left", nargs="?", help="left image path")
    ap.add_argument("right", nargs="?", help="right image path")
    ap.add_argument("min_disp", nargs="?", type=int, default=0)
    ap.add_argument("max_disp", nargs="?", type=int, default=64)
    ap.add_argument("--pair",
                    help="Middlebury pair name (Cone/Cloth3/Wood2/Piano) "
                    "under Data/ at the repository root")
    ap.add_argument("--out", help="output prefix (default: left image path)")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument(
        "--parity",
        action="store_true",
        help="reference-parity mode: the bit-exact roll backend, host "
        "float64 grayscale and the in-place raster-order median (kernel "
        "M1), as close to the reference C++ output as the engine gets",
    )
    ap.add_argument(
        "--backend",
        choices=tuple(BACKENDS),
        default=None,
        help="cross-operator backend, with the JAX CLI's names: 'pallas' "
        "and 'jnp' are the bit-exact roll kernels (B1/B3, the default), "
        "'matmul' the band matrices. Overrides the backend part of "
        "--parity",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default: cuda; 'cpu' runs the "
        "kernels' plain versions on the host)",
    )
    ap.add_argument(
        "--timing",
        action="store_true",
        help="run stage by stage with device fences and print per-stage "
        "times and Mpix*disp/s (the reference's per-stage printf, "
        "ADCensusStereo.cpp:81-129)",
    )
    ap.add_argument(
        "--dump-stages",
        metavar="PATH.npz",
        help="save every intermediate volume/map to an npz for debugging",
    )
    ap.add_argument(
        "--cloud",
        metavar="PATH.txt",
        help="save a point cloud (x,y,d,r,g,b) like SaveDisparityCloud "
        "(main.cpp:212-230)",
    )
    # every other ADCensusOptions tunable (adcensus_types.h:45-75) as a
    # flag; None keeps the reference default
    tunables = [
        f
        for f in dataclasses.fields(ADCensusOptions)
        if f.name not in ("min_disparity", "max_disparity")
    ]
    grp = ap.add_argument_group("pipeline tunables (reference defaults)")
    for f in tunables:
        flag = "--" + f.name.replace("_", "-").lower()
        if f.type == "bool":
            grp.add_argument(flag, dest=f.name,
                             action=argparse.BooleanOptionalAction,
                             default=None, help=f"(default: {f.default})")
        else:
            grp.add_argument(flag, dest=f.name,
                             type=float if f.type == "float" else int,
                             default=None, help=f"(default: {f.default})")
    return ap, tunables


def main(argv=None) -> None:
    """Parse ``argv`` (default: the command line) and run one pair."""
    ap, tunables = _parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    if args.pair:
        try:
            pair = get_pair(args.pair)
        except ValueError as e:
            ap.error(str(e))
        left, right, gt = pair.load()
        # with --pair the two leading positionals (if present) are the
        # disparity range, overriding the pair's d_range.txt:
        #   cli --pair Piano 0 256
        try:
            dmin = int(args.left) if args.left is not None else pair.dmin
            dmax = int(args.right) if args.right is not None else pair.dmax
        except ValueError:
            ap.error("--pair takes an optional MIN_DISP MAX_DISP override")
        opts = ADCensusOptions(min_disparity=dmin, max_disparity=dmax)
        prefix = args.out or os.path.join("out", pair.name)
    else:
        if not (args.left and args.right):
            ap.error("provide LEFT RIGHT paths or --pair NAME")
        left = load_image_rgb(args.left)
        right = load_image_rgb(args.right)
        gt = None
        opts = ADCensusOptions(
            min_disparity=args.min_disp, max_disparity=args.max_disp
        )
        prefix = args.out or args.left
    overrides = {
        f.name: getattr(args, f.name)
        for f in tunables
        if getattr(args, f.name) is not None
    }
    if overrides:
        opts = dataclasses.replace(opts, **overrides)
    if args.parity and "exact_median" not in overrides:
        opts = dataclasses.replace(opts, exact_median=True)
    cross_backend = BACKENDS[args.backend] if args.backend else "roll"
    gray_mode = "host64" if args.parity else "device"
    opts.validate()
    if left.shape != right.shape:
        raise SystemExit("left/right image sizes differ")
    if not args.no_save:
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    if args.timing or args.dump_stages:
        from adcensus_torch.utils.profiling import match_staged

        res = match_staged(left, right, opts, cross_backend=cross_backend,
                           dump_path=args.dump_stages, device=device)
        for k, t in res["timings"].items():
            thr = res["throughput"].get(k, 0.0)
            print(f"{k:>12}: {t * 1000:8.2f} ms   {thr:9.1f} Mpix*disp/s")
        disp = res["disparity"]
        print(json.dumps(evaluate(disp, gt), indent=2))
        if not args.no_save:
            save_disparity_map(disp, prefix)
    else:
        disp, _, _ = run_pair(
            left, right, opts, None if args.no_save else prefix, gt,
            gray_mode=gray_mode, cross_backend=cross_backend, device=device,
        )
    if args.cloud:
        save_disparity_cloud(left, disp, args.cloud)


if __name__ == "__main__":
    main()
