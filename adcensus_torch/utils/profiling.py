"""Per-stage timing of one match, the port's copy of
``adcensus_tpu/utils/profiling.py``: the reference's per-stage timing
printfs (ADCensusStereo.cpp:81-129), with each stage fenced so that its
time is the device's. On a CUDA device a stage runs between two CUDA
events after ``torch.cuda.synchronize()`` and is read after another; on
the CPU it is timed by ``time.perf_counter``. Throughput is Mpix*disp/s
per stage.

``match_staged`` can also dump every intermediate volume and map to an
``.npz`` for debugging, and ``trace`` runs a call under
``torch.profiler``.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops.basic import check_cross_options, resolve_device
from adcensus_torch.stages import aggregate as agg_stage
from adcensus_torch.stages import arms as arms_stage
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.stages import refine as refine_stage
from adcensus_torch.stages import scanline as scan_stage
from adcensus_torch.stages import wta as wta_stage

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "adcensus_trace"


def _timed(fn, args, dev: torch.device):
    """(fn(*args), seconds), fenced on ``dev``."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end) / 1e3


def match_staged(
    left: np.ndarray,
    right: np.ndarray,
    opts: Optional[ADCensusOptions] = None,
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
    warmup: bool = True,
    dump_path: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Run the pipeline stage by stage with device fences.

    Returns {"disparity" (numpy), "timings": {stage: seconds},
    "throughput": {stage: Mpix*disp/s}}, the stages being cost, arms,
    aggregation, scanline, wta and refine, plus their "total". With
    ``warmup`` each stage runs once untimed first (kernel builds, the
    allocator's first blocks). The gray images are computed on the
    device, as the JAX package's ``match_staged`` does, whatever gray
    mode the caller uses elsewhere.
    """
    opts = opts or ADCensusOptions()
    opts.validate()
    check_cross_options(cross_backend, agg_impl)
    dev = resolve_device(device)
    h, w, _ = left.shape
    work = h * w * opts.disp_range

    left_d = torch.as_tensor(np.asarray(left), device=dev)
    right_d = torch.as_tensor(np.asarray(right), device=dev)
    gray_l = cost_stage.compute_gray(left_d)
    gray_r = cost_stage.compute_gray(right_d)

    timings = {}

    def run(name, fn, *args):
        if warmup:
            _timed(fn, args, dev)
        out, timings[name] = _timed(fn, args, dev)
        return out

    def stage_cost(left_t, right_t, g_l, g_r):
        census_l = cost_stage.census_transform_9x7(g_l)
        census_r = cost_stage.census_transform_9x7(g_r)
        return cost_stage.compute_cost_volume(left_t, right_t, census_l,
                                              census_r, opts)

    cost_init = run("cost", stage_cost, left_d, right_d, gray_l, gray_r)
    arms = run("arms", arms_stage.build_arms, left_d, opts)
    cost_aggr = run(
        "aggregation",
        lambda c, a: agg_stage.aggregate(c, a, opts,
                                         cross_backend=cross_backend,
                                         agg_impl=agg_impl),
        cost_init, arms,
    )
    cost_scan = run("scanline", scan_stage.scanline_optimize, cost_aggr,
                    left_d, right_d, opts)
    disp_l, disp_r = run(
        "wta",
        lambda c: (wta_stage.wta_left(c, opts), wta_stage.wta_right(c, opts)),
        cost_scan,
    )
    disp = run(
        "refine",
        lambda *a: refine_stage.multistep_refine(
            *a, opts, cross_backend=cross_backend)["final"],
        disp_l, disp_r, left_d, cost_scan, arms,
    )

    throughput = {k: work / t / 1e6 for k, t in timings.items()}
    timings["total"] = sum(timings.values())
    throughput["total"] = work / timings["total"] / 1e6

    if dump_path:
        np.savez_compressed(
            dump_path,
            cost_init=cost_init.cpu().numpy(),
            arms=arms.cpu().numpy(),
            cost_aggr=cost_aggr.cpu().numpy(),
            cost_scan=cost_scan.cpu().numpy(),
            disp_left_raw=disp_l.cpu().numpy(),
            disp_right_raw=disp_r.cpu().numpy(),
            disparity=disp.cpu().numpy(),
        )

    return {
        "disparity": disp.cpu().numpy(),
        "timings": timings,
        "throughput": throughput,
    }


def trace(fn, *args, trace_dir=TRACE_DIR):
    """Run ``fn(*args)`` under ``torch.profiler`` (the CPU, and the card
    when there is one) and write its Chrome trace to
    ``trace_dir``/trace.json. Returns (the result, the trace's path)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = Path(trace_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return out, path
