#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the AD-Census engine on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvidia-smi`` and ``nvcc`` (the kernels are built from
``adcensus_torch/csrc`` into ``build/adcensus_torch/`` on first use), and
imports nothing of JAX. Phases, each raising on failure:

1. device: the card's name and power limit;
2. build: the four CUDA kernels, timed;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and on the main path's own inputs, bitwise,
   timed with CUDA events beside its bound;
4. main path: ``match_device`` on a seeded synthetic 375x450 pair with
   d in [0, 64) and default options (the Middlebury Cone size), with the
   launch counts of one match, the match time, bitwise equality with the
   plain-version pipeline on the same card, and bad-2.0 against the
   scene's ground truth;
5. stages: where one match's time goes, stage by stage (CUDA events),
   and the device's busy time and heaviest kernels (torch.profiler).

The last two lines of its output are a JSON object of per-kernel numbers
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

H, W, MAX_D = 375, 450, 64
D_BG, D_FG, SEED = 16, 32, 0
KERNEL_RUNS = 10
MATCH_RUNS = 7
MEM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
BAD2_LIMIT_PCT = 10.0

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "cross_sum": ("adcensus_torch/csrc/cross_sum.cu",
                  "adcensus_tpu/ops/cross_sum_pallas.py:77"),
    "scanline": ("adcensus_torch/csrc/scanline.cu",
                 "adcensus_tpu/ops/scanline_pallas.py:75"),
    "region_vote": ("adcensus_torch/csrc/region_vote.cu",
                    "adcensus_tpu/ops/region_vote_pallas.py:47"),
    "ray_interp": ("adcensus_torch/csrc/ray_interp.cu",
                   "adcensus_tpu/ops/interp_pallas.py:56"),
}


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work: bytes over the memory rate or operations
    over the scalar rate, whichever is larger."""
    t_bytes = n_bytes / MEM_BYTES_PER_S
    t_ops = n_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, runs: int = KERNEL_RUNS) -> float:
    """Median CUDA-event time of ``fn()`` after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(torch, a, b) -> float:
    """Raise unless ``a`` and ``b`` are bitwise equal; return the largest
    absolute difference (0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.dtype == torch.float32:
        same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        err = float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else 0.0
    else:
        same = torch.equal(a, b)
        err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    if not same:
        raise AssertionError(f"kernel and plain version differ (max {err})")
    return err


def plain_versions():
    """Context that routes every kernel wrapper to its plain version, so
    the whole pipeline can run on the card without the kernels."""
    stack = ExitStack()
    for mod in ("cross_sum", "scanline", "region_vote", "interp"):
        stack.enter_context(mock.patch(
            f"adcensus_torch.ops.{mod}.kernels_for", lambda t: False
        ))
    return stack


def ray_steps(torch, disp, target, offsets):
    """Ray steps the B4 march needs on these inputs: for every target
    pixel and ray, the steps up to and including the first finite hit or
    the last in-image cell."""
    h, w = disp.shape
    ys = torch.arange(h, device=disp.device)[None, :, None]
    xs = torch.arange(w, device=disp.device)[None, None, :]
    alive = target[None].expand(offsets.shape[0], h, w).clone()
    steps = torch.zeros((), dtype=torch.long, device=disp.device)
    for i in range(offsets.shape[1]):
        yy = ys + offsets[:, i, 0].long()[:, None, None]
        xx = xs + offsets[:, i, 1].long()[:, None, None]
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        alive = alive & inside
        steps += alive.sum()
        v = disp[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        alive = alive & ~torch.isfinite(v)
    return int(steps)


def kernel_cases(torch, inter, left, opts):
    """Per kernel: the calls one match makes, as (label, kernel call,
    plain call, bytes, operations), on the main path's own inputs."""
    from adcensus_torch.ops import cross_sum, interp, region_vote, scanline
    from adcensus_torch.stages import aggregate, refine
    from adcensus_torch.stages import scanline as scan_stage

    d, h, w = inter["cost_init"].shape
    hw, dhw = h * w, d * h * w
    arms = inter["arms"]
    max_arm = min(opts.cross_L1, 255)
    sup_h, sup_v = (s.float() for s in aggregate.support_counts(arms, max_arm))
    ext = (arms[..., 0] + arms[..., 1] + 1).sum() + (
        arms[..., 2] + arms[..., 3] + 1
    ).sum()
    cases = {"cross_sum": [], "scanline": [], "region_vote": [],
             "ray_interp": []}

    vol = inter["cost_init"]
    for hf, sup in ((True, sup_h), (False, sup_v)):
        args = (vol, arms, sup, hf, max_arm)
        cases["cross_sum"].append((
            f"{'horizontal' if hf else 'vertical'}-first",
            lambda a=args: cross_sum.cross_pass(*a),
            lambda a=args: cross_sum.cross_pass_plain(*a),
            dhw * 8 + hw * 20, d * (int(ext) + hw),
        ))

    vol = inter["cost_aggr"]
    for axis, fwd in (("x", True), ("x", False), ("y", True), ("y", False)):
        code = scan_stage.penalty_code(left, inter["right"], opts, axis, fwd)
        flags = scan_stage._scan_flags(
            w if axis == "x" else h, device=vol.device
        )
        args = (vol, code, flags, opts.so_p1, opts.so_p2, axis, not fwd)
        cases["scanline"].append((
            f"{axis} {'forward' if fwd else 'backward'}",
            lambda a=args: scanline.scanline_pass(*a),
            lambda a=args: scanline.scanline_pass_plain(*a),
            dhw * 9 + len(flags) * 4, dhw * 9,
        ))

    disp = inter["after_lr_check"]
    di, valid = refine.vote_indices(disp, opts)
    args = (di, valid, arms, opts.disp_range, max_arm)
    cells = int(sup_h.sum())  # horizontal-first region cells
    cases["region_vote"].append((
        "first phase",
        lambda a=args: region_vote.region_vote_stats(*a),
        lambda a=args: region_vote.region_vote_stats_plain(*a),
        hw * 33, cells + 2 * d * hw,
    ))

    max_search = max(abs(opts.max_disparity), abs(opts.min_disparity))
    offsets = torch.as_tensor(
        refine.ray_offset_table(max_search), device=vol.device
    )
    occl, mism = inter["occlusion"], inter["mismatch"]
    disp = inter["after_voting"]
    mism_target = mism & ~torch.isfinite(disp)
    fill_m = refine.interpolation_fills(disp, left, opts, True, mism_target)
    disp_o = torch.where(mism_target, fill_m, disp)
    occl_target = occl & ~torch.isfinite(disp_o)
    for label, dmap, target, is_mismatch in (
        ("mismatch", disp, mism_target, True),
        ("occlusion", disp_o, occl_target, False),
    ):
        args = (dmap, left, offsets, target, is_mismatch)
        steps = ray_steps(torch, dmap, target, offsets)
        cases["ray_interp"].append((
            f"{label} ({int(target.sum())} targets)",
            lambda a=args: interp.ray_interp(*a),
            lambda a=args: interp.ray_interp_plain(*a),
            hw * 13 + offsets.numel() * 4, steps * 4,
        ))
    return cases


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.ops import _build
    from adcensus_torch.stages import cost as cost_stage
    from adcensus_torch.stages import pipeline
    from adcensus_torch.stages import refine
    from adcensus_torch.synthetic import bad_pct, two_layer_pair

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    dev = torch.device("cuda:0")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] 4 kernels in {time.perf_counter() - t0:.1f} s")

    opts = ADCensusOptions(max_disparity=MAX_D)
    left_np, right_np, gt = two_layer_pair(H, W, D_BG, D_FG, seed=SEED)
    left = torch.as_tensor(left_np, device=dev)
    right = torch.as_tensor(right_np, device=dev)

    # 3. kernels against their plain versions, on the main path's inputs
    inter = pipeline.match_core(
        left, right, cost_stage.compute_gray(left),
        cost_stage.compute_gray(right), opts, return_intermediates=True,
    )
    inter["right"] = right
    _, inter["occlusion"], inter["mismatch"] = refine.outlier_detection(
        inter["disp_left_raw"], inter["disp_right_raw"], opts
    )
    results = {}
    for name, cases in kernel_cases(torch, inter, left, opts).items():
        errs, ks, ps, bs, bound_kinds = [], [], [], [], []
        for label, kern, plain, n_bytes, n_ops in cases:
            out_k, out_p = kern(), plain()
            outs = (out_k, out_p) if isinstance(out_k, tuple) else (
                (out_k,), (out_p,))
            errs += [max_abs_err(torch, a, b) for a, b in zip(*outs)]
            k_ms = time_ms(torch, kern)
            p_ms = time_ms(torch, plain)
            b_ms, b_kind = bound_ms(n_bytes, n_ops)
            ks.append(k_ms)
            ps.append(p_ms)
            bs.append(b_ms)
            bound_kinds.append(b_kind)
            print(f"[kernel] {name} {label}: {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_kind}); bitwise")
        results[name] = {
            "max_abs_err": max(errs),
            "ms": statistics.mean(ks),
            "plain_ms": statistics.mean(ps),
            "bound_ms": statistics.mean(bs),
            "bound_by": max(set(bound_kinds), key=bound_kinds.count),
        }

    # 4. main path
    torch.cuda.synchronize()
    _build.reset_launches()
    disp = pipeline.match_device(left, right, opts, device=dev)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    print(f"[main] launches in one match: {launches}")

    times = []
    for _ in range(MATCH_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.match_device(left, right, opts, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(out.view(torch.int32), disp.view(torch.int32)):
        raise AssertionError("match_device is not deterministic")
    with plain_versions():
        _build.reset_launches()
        plain_disp = pipeline.match_device(left, right, opts, device=dev)
        torch.cuda.synchronize()
        if any(_build.launches.values()):
            raise AssertionError("the plain pipeline launched a kernel")
    if not torch.equal(disp.view(torch.int32), plain_disp.view(torch.int32)):
        n = int((disp != plain_disp).sum())
        raise AssertionError(f"kernel and plain pipelines differ at {n} px")
    disp_np = disp.cpu().numpy()
    if disp_np.shape != (H, W) or disp_np.dtype != np.float32:
        raise AssertionError(f"bad output {disp_np.shape} {disp_np.dtype}")
    density = float(np.isfinite(disp_np).mean()) * 100.0
    bad2 = bad_pct(disp_np, gt, 2.0)
    if not density > 0.0:
        raise AssertionError("no valid disparity")
    if not bad2 < BAD2_LIMIT_PCT:
        raise AssertionError(f"bad-2.0 {bad2} % >= {BAD2_LIMIT_PCT} %")
    ms = statistics.median(times)
    print(f"[main] match_device {H}x{W} d=[0,{MAX_D}): median {ms:.3f} ms "
          f"of {MATCH_RUNS} (min {min(times):.3f}, max {max(times):.3f}), "
          f"{H * W * MAX_D / ms / 1e3:.1f} Mpix*disp/s; density "
          f"{density:.2f} %, bad-2.0 {bad2:.3f} %; equals the plain "
          f"pipeline bitwise; card {card}")

    # 5. where one match's time goes
    stage_ms = stage_breakdown(torch, left, right, opts, disp)
    print("[stages] " + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()))
    prof = device_profile(torch, left, right, opts, dev)
    if prof is None:
        print("[profile] not measured: the profiler recorded no device "
              "activity")
    else:
        busy_ms, top = prof
        print(f"[profile] device busy {busy_ms:.3f} ms of the {ms:.3f} ms "
              f"median match ({100.0 * (1.0 - busy_ms / ms):.1f} % idle); "
              "by kernel: "
              + "; ".join(f"{n} {t:.3f} ms x{c}" for n, t, c in top))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        print(f"[kernel] {name}: {r['ms']:.4f} ms per launch, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {launches[name]} launches per match")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


def device_profile(torch, left, right, opts, dev, top_n: int = 12):
    """Device time of one match from torch.profiler: the union of its
    kernels' intervals (ms), and the ``top_n`` kernels by total device
    time as (name, ms, calls); None when the profiler sees no device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adcensus_torch.stages import pipeline

    pipeline.match_device(left, right, opts, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipeline.match_device(left, right, opts, device=dev)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    per_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        t, c = per_name.get(name, (0.0, 0))
        per_name[name] = (t + (e - s) / 1e3, c + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return busy_us / 1e3, [(n[:60], t, c) for n, (t, c) in top]


def stage_breakdown(torch, left, right, opts, expect):
    """CUDA-event time of each stage of one match, in match_core's order;
    the chained result must equal ``expect``."""
    from adcensus_torch.stages import aggregate, arms, cost, refine, scanline, wta

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    for _ in range(2):  # the second run is the timed one
        marks.clear()
        mark("start")
        gl, gr = cost.compute_gray(left), cost.compute_gray(right)
        cen_l = cost.census_transform_9x7(gl)
        cen_r = cost.census_transform_9x7(gr)
        vol = cost.compute_cost_volume(left, right, cen_l, cen_r, opts)
        mark("cost")
        a = arms.build_arms(left, opts)
        mark("arms")
        vol = aggregate.aggregate(vol, a, opts)
        mark("aggregate")
        vol = scanline.scanline_optimize(vol, left, right, opts)
        mark("scanline")
        dl, dr = wta.wta_left(vol, opts), wta.wta_right(vol, opts)
        mark("wta")
        disp, occl, mism = refine.outlier_detection(dl, dr, opts)
        mark("lr_check")
        disp = refine.iterative_region_voting(disp, a, occl, mism, opts)
        mark("voting")
        disp = refine.proper_interpolation(disp, left, occl, mism, opts)
        mark("interpolation")
        disp = refine.median_filter_3x3(disp)
        mark("median")
        torch.cuda.synchronize()
    if not torch.equal(disp.view(torch.int32), expect.view(torch.int32)):
        raise AssertionError("stage chain differs from match_device")
    return {
        name: prev.elapsed_time(ev)
        for (_, prev), (name, ev) in zip(marks, marks[1:])
    }


if __name__ == "__main__":
    sys.exit(main())
