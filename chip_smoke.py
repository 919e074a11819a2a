#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the AD-Census engine on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvidia-smi`` and ``nvcc`` (the kernels are built from
``adcensus_torch/csrc`` into ``build/adcensus_torch/`` on first use), and
imports nothing of JAX. Phases, each raising on failure:

1. device: the card's name and power limit;
2. build: the nine CUDA kernels (eight libraries), timed;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the path that runs it and on that path's own inputs,
   bitwise, timed with CUDA events over runs of back-to-back calls
   (``time_ms``) beside its bound (and, for B5, one PyTorch library call
   of the same function; for B2, the time per scan step); B3 on the first
   iteration's mismatch and occlusion phases at their targets, and also
   on every pixel, the work of its earlier design, beside that work's
   bound, and on a phase without targets; B4 on the two interpolation
   phases, each with its ray-step total and longest ray, and also on a
   phase without targets, on every pixel (its earlier design's work) and
   on long rays (D = 256 on a map 98 % +inf); B5 on both passes, each
   with its mean and largest count of selected slots a column; B1, B3
   and B5 also at Cone size with arms that reach the cap, beside their
   own bounds; one dense band-matrix aggregation iteration beside B1, not
   bitwise; M2 (discontinuity adjustment, its Sobel mask included) on
   the main path's interpolated map and cost_scan, and M1 (the in-place
   median) on what M2 gives, as the [flags] path runs them, with M1's
   time per wavefront and its recurrence bound (the wavefronts times the
   cycles of its critical chain of one step, timed by a probe on the
   card, over the top SM clock) and M2's time per 32-column chunk and
   its chain bound (the longest run of pixels that take the value on
   their left times the cycles of a chained gather, timed by a probe)
   beside the bytes bound; M1 also at the Wood2 size and on 1100x64
   (more rows than a block has threads), M2 also at the Wood2 size on a
   random map and on a striped map whose edges run along whole rows; C1
   (census) on the pair's two grays and C2 (the cost volume) on its images
   and census, as every path runs them, and both also at the KITTI size
   (375x1242, D = 256) on seeded random images;
4. main path: ``match_device`` on a seeded synthetic 375x450 pair with
   d in [0, 64) and default options (the Middlebury Cone size, the roll
   backend), with the launch counts of one match, the match time, bitwise
   equality with the plain-version pipeline on the same card, and bad-2.0
   against the scene's ground truth;
5. backends: the same match with ``cross_backend="matmul"``, dense
   (``[matmul]``) and with kernel B5 (``[banded]``), each held as in
   phase 4 and compared with the main path's disparity; and ``[flags]``:
   the roll backend with ``exact_median`` and
   ``do_discontinuity_adjustment`` on (one launch of M1 and of M2 a
   match), held the same way;
6. batched: ``match_batched_device`` on 8 distinct seeded Cone-size pairs
   (seeds 0 to 7) on the roll and banded paths, each group a CUDA graph
   replay: the group the budget picks, the first call's peak allocated
   memory, the memory the graph holds against ``pipeline.pair_bytes``,
   the launches counted at capture (g times one match's), each output
   bitwise equal to ``match_device`` on its pair, host-clock ms a pair
   against a loop of ``match_device``, the device's busy time in a
   profiled call, and a call with group 4 (two replays); and the same on
   the [flags] path;
7. hetero: ``match_hetero_device`` on a Wood2-size pair (555x653, D=128)
   and the Cone-size pair in one graph, held as in phase 6, and the
   call's ms against two ``match_device`` calls;
8. cli: the Cone-size pair written as PNGs under ``build/cli/`` with the
   port's own I/O, ``python3 -m adcensus_torch.cli ... --parity`` run as
   a subprocess (exit 0, its metrics, the two PNGs' shapes, the point
   cloud's lines against the parity map's valid pixels), the same with
   ``--timing`` (its stage lines printed), ``cli.run_pair`` in parity
   mode bitwise equal to ``match(..., gray_mode="host64")`` with the
   in-place median, and which image loader ran.

9. sharded: the sharded layer (``adcensus_torch/parallel/``) at world
   size 1: ``distributed.initialize`` on NCCL with a ``file://``
   rendezvous under ``build/``, a (1, 1) mesh, then ``match_sharded`` on
   the rows and disp layouts (roll), the rows layout with the [flags]
   options and on the matmul backend, and ``match_sharded_batched`` of 2
   pairs, each bitwise equal to ``match_device`` on the same device
   grays, with the launches of one match (equal to the same path's
   ``match_device``), host-clock ms a match beside ``match_device``'s,
   timed in turns, and the device's busy time in a profiled call of each;
   the process group is destroyed after. One card runs
   one rank: NCCL takes no two ranks on a card, so the collectives run
   at one rank, and the tests run 2 and 4 ranks on the CPU over gloo.

Per-stage device time is the benchmark's (``stereo_bench/``, read from
the program's spans), not this script's.

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
from pathlib import Path
from unittest import mock

H, W, MAX_D = 375, 450, 64
D_BG, D_FG, SEED = 16, 32, 0
TIMING_RUNS = 5                    # runs of back-to-back calls per time
RUN_TARGET_MS = 5.0                # about this long a run
MAX_CALLS = 200                    # calls per run at most
SLEEP_CYCLES_PER_S = 2.0e9         # above the H100's top SM clock
MATCH_RUNS = 7
PROFILE_TRIES = 3                  # profiled calls until one records kernels
MEM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BAD2_LIMIT_PCT = 10.0
BATCH = 8                          # [batched]: pairs of seeds 0 .. BATCH-1
HALF_GROUP = 4                     # [batched]: the group of two replays
WOOD2 = (555, 653, 32, 64, 8, 128)  # [hetero]: H, W, d_bg, d_fg, seed, D
KITTI = (375, 1242, 256)  # C1 and C2 beside the JSON's case: H, W, D
# [flags]: the two flag-gated refinement stages, on the roll backend
FLAGS = dict(exact_median=True, do_discontinuity_adjustment=True)
MEDIAN_EXTRA = ((555, 653), (1100, 64))  # M1 beside the JSON's case
SORT_OPS = 2 * 25  # min and max of the fewest comparators that sort 9
CLI_DIR = Path(__file__).resolve().parent / "build" / "cli"
CLI_TIMEOUT_S = 300
SHARDED_STORE = Path(__file__).resolve().parent / "build" / "sharded_store"
# [sharded]: (label, volume_axis, cross_backend, path whose options and
# match_device launches it is held to)
SHARDED_CASES = (("rows", "rows", "roll", "main"),
                 ("disp", "disp", "roll", "main"),
                 ("rows flags", "rows", "roll", "flags"),
                 ("rows matmul", "rows", "matmul", "matmul"))
SHARDED_BATCH = 2

KERNELS = {  # name -> (source, TPU kernel it replaces, path that runs it,
             #          the CUDA function the profiler names)
    "cross_sum": ("adcensus_torch/csrc/cross_sum.cu",
                  "adcensus_tpu/ops/cross_sum_pallas.py:77", "main",
                  "cross_pass_kernel"),
    "scanline": ("adcensus_torch/csrc/scanline.cu",
                 "adcensus_tpu/ops/scanline_pallas.py:75", "main",
                 "scanline_kernel"),
    "region_vote": ("adcensus_torch/csrc/region_vote.cu",
                    "adcensus_tpu/ops/region_vote_pallas.py:47", "main",
                    "region_vote_kernel"),
    "ray_interp": ("adcensus_torch/csrc/ray_interp.cu",
                   "adcensus_tpu/ops/interp_pallas.py:56", "main",
                   "ray_interp_kernel"),
    "band_mm": ("adcensus_torch/csrc/band_mm.cu",
                "adcensus_tpu/ops/band_mm_pallas.py:132", "banded",
                "band_kernel"),
    # M1 and M2 replace lax.scan functions, not Pallas kernels
    "median_inplace": ("adcensus_torch/csrc/median_inplace.cu",
                       "adcensus_tpu/stages/refine.py:665", "flags",
                       "median_inplace_kernel"),
    "dda": ("adcensus_torch/csrc/dda.cu",
            "adcensus_tpu/stages/refine.py:525", "flags", "dda_kernel"),
    # C1 and C2 replace jnp functions, not Pallas kernels
    "census": ("adcensus_torch/csrc/cost.cu",
               "adcensus_tpu/stages/cost.py:52", "main", "census_kernel"),
    "cost_volume": ("adcensus_torch/csrc/cost.cu",
                    "adcensus_tpu/stages/cost.py:153", "main",
                    "cost_volume_kernel"),
}

# path -> (cross_backend, agg_impl, launches one match must show: a count,
# or None for at least one); [flags] runs with FLAGS set. Every path runs
# C1 on both grays and C2 once.
COST_LAUNCHES = {"census": 2, "cost_volume": 1}
PATHS = {
    "main": ("roll", None, {"cross_sum": None, "scanline": None,
                            "region_vote": 10, "ray_interp": 2,
                            "band_mm": 0, "median_inplace": 0, "dda": 0,
                            **COST_LAUNCHES}),
    "matmul": ("matmul", None, {"cross_sum": 0, "region_vote": 0,
                                "band_mm": 0, "scanline": 4,
                                "ray_interp": 2, "median_inplace": 0,
                                "dda": 0, **COST_LAUNCHES}),
    "banded": ("matmul", "banded", {"cross_sum": 0, "region_vote": 0,
                                    "band_mm": 8, "scanline": 4,
                                    "ray_interp": 2, "median_inplace": 0,
                                    "dda": 0, **COST_LAUNCHES}),
    "flags": ("roll", None, {"cross_sum": None, "scanline": None,
                             "region_vote": 10, "ray_interp": 2,
                             "band_mm": 0, "median_inplace": 1, "dda": 1,
                             **COST_LAUNCHES}),
}


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work: bytes over the memory rate or float32
    operations over the scalar rate, whichever is larger."""
    t_bytes = n_bytes / MEM_BYTES_PER_S
    t_ops = n_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, runs: int = TIMING_RUNS) -> float:
    """CUDA-event ms of one ``fn()``: the median over ``runs`` runs of the
    time of n back-to-back calls between one pair of events, over n.

    After two warm-up calls, n is chosen so that a run takes about
    RUN_TARGET_MS (1 to MAX_CALLS calls). Each run starts behind a device
    sleep longer than the host takes to queue its n calls (measured on a
    warm-up run), so the card runs the calls back to back and the
    wrappers' host work stays outside the window. The inputs stay the
    same from call to call, so what fits the 50 MB L2 stays there."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    n = max(1, min(MAX_CALLS, int(RUN_TARGET_MS / one_ms)))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(int(2 * queue_s * SLEEP_CYCLES_PER_S) + 1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
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
    for mod in ("ops.cross_sum", "ops.scanline", "ops.region_vote",
                "ops.interp", "ops.band_mm", "ops.median", "ops.dda",
                "stages.cost"):
        stack.enter_context(mock.patch(
            f"adcensus_torch.{mod}.kernels_for", lambda t: False
        ))
    return stack


def band_pass_library(torch, vol_m, mask, pad):
    """Kernel B5's function as PyTorch library calls, the yardstick of its
    ``library_ms`` (the port never calls it): the bfloat16 hi/lo split,
    one float32 einsum per split term over the unfolded 256-column
    windows, and their sum."""
    nb = 256
    dp, np_, _ = vol_m.shape
    wk, mp = mask.shape[1], mask.shape[2]
    n_ob = -(-mp // nb)
    m = torch.nn.functional.pad(mask.float(), (0, n_ob * nb - mp))
    m = m.view(np_, wk, n_ob, nb)
    hi = vol_m.to(torch.bfloat16).float()
    lo = (vol_m - hi).to(torch.bfloat16).float()
    sums = [
        torch.einsum("dnbk,nkbj->dnbj", part.unfold(2, wk, nb), m)
        for part in (hi, lo)
    ]
    return (sums[0] + sums[1]).reshape(dp, np_, n_ob * nb)[..., :mp]


def ray_steps(torch, disp, target, offsets):
    """What the B4 march needs on these inputs, as (total ray steps,
    longest ray, (H, W) mask of the cells whose disparity a step reads,
    (H, W) mask of the cells where a ray hit). A ray's steps run up to and
    including its first finite hit or in-image NaN, or its last in-image
    cell. B4 takes a target's 16 rays at once, so a target waits for its
    longest ray."""
    h, w = disp.shape
    hw = h * w
    flat = disp.reshape(-1)
    ys = torch.arange(h, device=disp.device)[None, :, None]
    xs = torch.arange(w, device=disp.device)[None, None, :]
    alive = target[None].expand(offsets.shape[0], h, w).clone()
    steps = torch.zeros(alive.shape, dtype=torch.int32, device=disp.device)
    # one slot past the map takes the writes of lanes that read nothing
    probed = torch.zeros(hw + 1, dtype=torch.bool, device=disp.device)
    hits = torch.zeros(hw + 1, dtype=torch.bool, device=disp.device)
    for i in range(offsets.shape[1]):
        yy = ys + offsets[:, i, 0].long()[:, None, None]
        xx = xs + offsets[:, i, 1].long()[:, None, None]
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        alive = alive & inside
        steps += alive
        q = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = flat[q]
        probed[torch.where(alive, q, hw)] = True
        hits[torch.where(alive & torch.isfinite(v), q, hw)] = True
        alive = alive & torch.isinf(v)  # +inf is marched through
    return (int(steps.sum()), int(steps.max()) if steps.numel() else 0,
            probed[:hw].view(h, w), hits[:hw].view(h, w))


def kernel_cases(torch, inter, left, opts):
    """Per kernel: the calls one match makes, as (label, kernel call,
    plain call, library call or None, bytes, operations), on the inputs
    of the path that runs it. B5's are the [banded] path's: the Cone-size
    cost_init and masks from the path's own arms (band_mm_cases)."""
    from adcensus_torch.ops import scanline
    from adcensus_torch.stages import refine
    from adcensus_torch.stages import scanline as scan_stage

    d, h, w = inter["cost_init"].shape
    dhw = d * h * w
    arms = inter["arms"]
    max_arm = min(opts.cross_L1, 255)
    cases = {name: [] for name in KERNELS}
    cases["cross_sum"] = cross_sum_cases(torch, inter["cost_init"], arms,
                                         max_arm, "")

    vol = inter["cost_aggr"]
    for axis, fwd in (("x", True), ("x", False), ("y", True), ("y", False)):
        # B2 alone, on the flag maps scanline_pass makes from the pass's
        # distances; the plain version on the code volume
        code = scan_stage.penalty_code(left, inter["right"], opts, axis, fwd)
        d1, rd = scan_stage.distances(left, inter["right"], axis, fwd)
        s_len, paths = (w, h) if axis == "x" else (h, w)
        flags = scan_stage._scan_flags(s_len, device=vol.device)
        args = (vol, d1 >= opts.so_tso, rd >= opts.so_tso, flags, opts.so_p1,
                opts.so_p2, axis, not fwd, opts.min_disparity, 0, w,
                scanline.scanline_geometry(d, s_len, paths, axis))
        plain_args = (vol, code, flags, opts.so_p1, opts.so_p2, axis,
                      not fwd)
        cases["scanline"].append((
            f"{axis} {'forward' if fwd else 'backward'}",
            lambda a=args: scanline.launch_pass(*a),
            lambda a=plain_args: scanline.scanline_pass_plain(*a), None,
            dhw * 8 + 2 * h * w + s_len * 4, dhw * 9,
            (s_len, "scan step", None),
        ))

    cases["region_vote"] = [
        region_vote_case(torch, label, disp, arms, target, opts)
        for label, disp, target in first_vote_phases(torch, inter, opts)
    ]

    max_search = max(abs(opts.max_disparity), abs(opts.min_disparity))
    offsets = refine.ray_offsets(max_search, vol.device)
    cases["ray_interp"] = [
        ray_interp_case(torch, label, dmap, left, offsets, target, is_mismatch)
        for label, dmap, target, is_mismatch in interp_phases(torch, inter,
                                                              left, opts)
    ]

    cases["band_mm"] = band_mm_cases(torch, inter["cost_init"], arms,
                                     max_arm, "")
    cases["dda"], cases["median_inplace"] = flag_cases(torch, inter)
    cases["census"], cases["cost_volume"] = cost_cases(
        torch, "", left, inter["right"], opts)
    return cases


def cost_cases(torch, label, left, right, opts):
    """C1's cases (the two grays) and C2's (one volume) on a pair, as
    match_core runs them. C1's bytes bound: the gray read and the
    signatures written (9 B a pixel), 63 comparisons a pixel. C2's: both
    images and both census read (22 B a pixel) and the volume written (4 B
    an output); 8 operations an output. The label gives C2's columns a
    thread, threads and blocks."""
    from adcensus_torch.ops import cost as cost_ops
    from adcensus_torch.stages import cost

    h, w, _ = left.shape
    d = opts.disp_range
    censuses = []
    for side, img in (("left", left), ("right", right)):
        gray = cost.compute_gray(img)
        censuses.append((
            f"{label}{side} gray {h}x{w}",
            lambda g=gray: cost.census_transform_9x7(g),
            lambda g=gray: cost.census_transform_9x7_plain(g, 0, h, w),
            None, h * w * 9, h * w * 63,
        ))
    cen_l, cen_r = (cost.census_transform_9x7(cost.compute_gray(img))
                    for img in (left, right))
    args = (left, right, cen_l, cen_r)
    tables = cost.cost_tables(opts, left.device)
    v, threads = cost_ops.cost_volume_geometry(w)
    blocks = -(-w // cost_ops.TILE) * h * -(-d // cost_ops.PLANES)
    volume = (
        f"{label}{h}x{w}, D={d} ({v} columns a thread, {threads} threads, "
        f"{blocks} blocks; its tables built beforehand)",
        lambda: cost_ops.cost_volume(*args, *tables, opts.min_disparity, d,
                                     w),
        lambda: cost.compute_cost_planes_plain(*args, opts, 0, d, w),
        None, h * w * 22 + d * h * w * 4, d * h * w * 8,
    )
    return censuses, [volume]


def cost_tables_note(torch, dev, opts):
    """CUDA-event ms of building C2's two tables (cost_tables), which
    compute_cost_planes does on every call before C2."""
    from adcensus_torch.stages import cost

    ms = time_ms(torch, lambda: cost.cost_tables(opts, dev))
    print(f"[note] C2's tables (cost_tables, 11 small PyTorch launches): "
          f"{ms:.4f} ms a call, before each C2 launch")


def cost_extra_cases(torch, dev):
    """C1 and C2 beside the JSON's cases: at the KITTI size (KITTI) on
    seeded random images."""
    import numpy as np

    from adcensus_torch.config import ADCensusOptions

    h, w, d = KITTI
    rng = np.random.default_rng(SEED)
    left, right = (torch.as_tensor(rng.integers(0, 256, (h, w, 3),
                                                dtype=np.uint8), device=dev)
                   for _ in range(2))
    censuses, volumes = cost_cases(torch, "KITTI size, ", left, right,
                                   ADCensusOptions(max_disparity=d))
    return [("census", c) for c in censuses] + [
        ("cost_volume", c) for c in volumes]


def flag_cases(torch, inter):
    """M2's and M1's cases as the [flags] path runs them: M2 on the main
    path's interpolated map and cost_scan (the stages before it do not
    depend on the flags), M1 on what M2 gives."""
    from adcensus_torch.ops import dda

    disp, cost = inter["after_interpolation"], inter["cost_scan"]
    adjusted = dda.dda(disp, cost)
    return ([dda_case(torch, "interpolated map", disp, cost, adjusted)],
            [median_case(torch, "adjusted map", adjusted)])


def dda_case(torch, label, disp, cost, adjusted):
    """M2's case, labelled with its edge pixels, those it may adjust and
    those it changed, and the longest run of pixels that each take the
    value on their left (take_left_run), with its time per 32-column chunk
    and its chain bound (dda_chain). Its bytes bound: the map read and
    written (8 B a pixel; the Sobel reads the map too), and at each
    adjustable pixel (an interior edge pixel whose own index is in range)
    the cost cells it compares: its own, the left neighbour's final
    value's and the right neighbour's where their indices are in range
    (4 B each). Operations: the Sobel's 20 a pixel of the interior, two
    comparisons a candidate."""
    from adcensus_torch.ops import dda

    d_range, h, w = cost.shape
    edge = dda.edge_detect(disp)
    _, own_ok = dda._rounded_idx(disp, d_range)
    _, right_ok = dda._rounded_idx(disp[:, 1:], d_range)
    _, left_ok = dda._rounded_idx(adjusted[:, :-1], d_range)
    act = (edge & own_ok)[:, 1:-1]
    cells = int(act.sum()) + int((act & left_ok[:, :-1]).sum()) + int(
        (act & right_ok[:, 1:]).sum())
    run = take_left_run(torch, disp, cost, adjusted)
    chunks = -(-w // 32)
    scans, gathers = dda_counts(torch, disp, cost, adjusted)
    busiest = int((scans + gathers).argmax())
    args = (disp, cost)
    return (
        f"{label} {h}x{w}, D={d_range} ({int(edge.sum())} edge pixels, "
        f"{int(act.sum())} adjustable, {int((adjusted != disp).sum())} "
        f"changed; longest run taking the left value {run}; {chunks} "
        f"chunks a row; {int(scans.sum())} scans and {int(gathers.sum())} "
        f"gather rounds in all, {int(scans[busiest])} and "
        f"{int(gathers[busiest])} in the busiest row)",
        lambda: dda.dda(*args), lambda: dda.dda_plain(*args), None,
        h * w * 8 + cells * 4,
        max(h - 2, 0) * max(w - 2, 0) * 20 + 2 * cells,
        (chunks, "chunk", dda_chain(torch, run)),
    )


def dda_counts(torch, disp, cost, adjusted):
    """Each row's scans (one a round: the first round of each chunk with
    an adjustable pixel, and each round with a gather) and its rounds with
    a gather in M2's kernel, from ``adc_dda_counts`` (the same kernel,
    which also writes the counts; its launch is not counted), as two int64
    tensors on the host; its map must equal ``adjusted``."""
    import ctypes

    from adcensus_torch.ops import _build

    entry = _build.entry("dda", "adc_dda_counts", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    d_range, h, w = cost.shape
    out = torch.empty_like(disp)
    counts = torch.zeros((h, 2), dtype=torch.int32, device=disp.device)
    err = entry(disp.data_ptr(), cost.data_ptr(), out.data_ptr(),
                counts.data_ptr(), d_range, h, w,
                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adc_dda_counts failed: {err}")
    max_abs_err(torch, out, adjusted)
    counts = counts.long().cpu()
    return counts[:, 0], counts[:, 1]


def take_left_run(torch, disp, cost, adjusted) -> int:
    """The longest run along a row of pixels that each take the value on
    their left, from the plain scan's own rule applied to the adjusted
    map: an adjustable pixel whose left neighbour's final value is cheaper
    in the left column than its own, and whose right neighbour does not
    then undercut it."""
    import numpy as np

    from adcensus_torch.ops import dda

    d_range = cost.shape[0]
    if disp.shape[1] < 3:
        return 0
    own_i, own_ok = dda._rounded_idx(disp, d_range)
    act = dda.edge_detect(disp) & own_ok
    own_c = torch.gather(cost, 0, own_i[None])[0]
    left_i, left_ok = dda._rounded_idx(adjusted[:, :-2], d_range)
    left_c = torch.gather(cost[:, :, :-2], 0, left_i[None])[0]
    c0 = own_c[:, 1:-1]
    take_l = act[:, 1:-1] & left_ok & (left_c < c0)
    c = torch.where(take_l, left_c, c0)
    _, right_ok = dda._rounded_idx(disp[:, 2:], d_range)
    take_r = right_ok & (own_c[:, 2:] < c)
    chain = (take_l & ~take_r).cpu().numpy().astype(np.int8)
    edges = np.diff(np.pad(chain, ((0, 0), (1, 1))), axis=1)
    starts, ends = np.nonzero(edges == 1)[1], np.nonzero(edges == -1)[1]
    return int((ends - starts).max()) if len(starts) else 0


def dda_chain(torch, run, steps=4096):
    """M2's chain bound: ``run`` chained steps, each an L2 gather at a
    carried index, a compare, a select and an lround, timed by
    ``adc_dda_chain_cycles`` in clock64 cycles on one warp, over the
    card's top SM clock (``nvidia-smi`` clocks.max.sm). Returns ("chain",
    bound ms, cycles a step, the step's name, MHz)."""
    import ctypes

    from adcensus_torch.ops import _build

    probe = _build.entry("dda", "adc_dda_chain_cycles", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))
    d_range, stride = 64, 4096
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    table = torch.randint(0, d_range, (d_range, stride), generator=gen,
                          device="cuda").float()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.empty(32, device="cuda")
    for _ in range(2):  # the second run, warm
        err = probe(cycles.data_ptr(), table.data_ptr(), d_range, stride,
                    steps, sink.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"adc_dda_chain_cycles failed: {err}")
    per_step = int(cycles.item()) / steps
    mhz = sm_clock_mhz()
    return ("chain", run * per_step / (mhz * 1e3), per_step, "chained step",
            mhz)


def dda_extra_cases(torch, dev):
    """M2 beside the JSON's case: at the Wood2 size (555x653, D = 128) on
    a seeded map of disparities in [0, 128) with 15 % +inf and a uniform
    cost, and at the Cone size on horizontal stripes 6 rows high of
    disparities 12 and 40 with halves and whole steps of jitter, whose
    boundary rows are edges along the whole row, under a cost that rises
    with the index (d / D plus 1 % noise), so that low values propagate
    along them."""
    import numpy as np

    from adcensus_torch.ops import dda

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    h, w, d_range = WOOD2[0], WOOD2[1], WOOD2[5]
    src = rng.uniform(0.0, d_range, (h, w)).astype(np.float32)
    src[rng.random((h, w)) < 0.15] = np.inf
    disp = torch.as_tensor(src, device=dev)
    cost = torch.rand((d_range, h, w), generator=gen, device=dev)
    cases.append(dda_case(torch, "random map", disp, cost,
                          dda.dda(disp, cost)))
    stripes = np.where((np.arange(H) // 6) % 2, 40.0, 12.0)[:, None]
    src = (stripes + rng.choice([0.0, 0.5, 1.0], (H, W))).astype(np.float32)
    disp = torch.as_tensor(src, device=dev)
    rise = torch.arange(MAX_D, device=dev, dtype=torch.float32) / MAX_D
    cost = rise[:, None, None] + 0.01 * torch.rand(
        (MAX_D, H, W), generator=gen, device=dev)
    cases.append(dda_case(torch, "striped map", disp, cost,
                          dda.dda(disp, cost)))
    return cases


def median_case(torch, label, disp):
    """M1's case, with its time per wavefront (W + 2H - 2 of them) and
    its recurrence bound (median_recurrence). Its bytes bound: the map
    read and written (8 B a pixel) and SORT_OPS a pixel. The label gives
    the kernel's block, rows a thread and walk (its steps, band delays,
    head start and tail included)."""
    from adcensus_torch.ops import median

    h, w = disp.shape
    waves = w + 2 * h - 2
    threads, rows, _ = median.median_inplace_geometry(h, w)
    _, _, last = median.median_inplace_schedule(h, w)
    walk = last + median.TAIL - median.FIRST_STEP + 1
    rec_ms, per_step, mhz = median_recurrence(torch, threads, waves)
    return (
        f"{label} {h}x{w} ({waves} wavefronts; {threads} threads, {rows} "
        f"row(s) a thread, a walk of {walk} steps)",
        lambda: median.median_inplace(disp),
        lambda: median.median_inplace_plain(disp), None,
        h * w * 8, h * w * SORT_OPS,
        (waves, "wavefront",
         ("recurrence", rec_ms, per_step, "wavefront", mhz)),
    )


def median_recurrence(torch, threads, waves, steps=4096):
    """M1's recurrence bound: ``waves`` wavefronts, each no shorter than
    the kernel's critical chain of one step (the up-right value merged
    by two min/max and handed on by shuffle and the warp-boundary ring,
    then the barrier), timed by ``adc_median_chain_cycles`` in clock64
    cycles on a block of ``threads`` threads that runs only that chain,
    over the card's top SM clock (``nvidia-smi`` clocks.max.sm). Returns
    (bound ms, cycles a step, MHz)."""
    import ctypes

    from adcensus_torch.ops import _build

    probe = _build.entry("median_inplace", "adc_median_chain_cycles", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p))
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.empty(threads, device="cuda")
    for _ in range(2):  # the second run, warm
        err = probe(cycles.data_ptr(), sink.data_ptr(), threads, steps,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"adc_median_chain_cycles failed: {err}")
    per_step = int(cycles.item()) / steps
    mhz = sm_clock_mhz()
    return waves * per_step / (mhz * 1e3), per_step, mhz


def sm_clock_mhz() -> float:
    """The card's top SM clock in MHz (``nvidia-smi`` clocks.max.sm)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return float(smi.stdout.strip().splitlines()[0].split()[0])


def median_extra_cases(torch, dev):
    """M1 at MEDIAN_EXTRA's sizes on seeded maps of disparities in
    [0.5, 128) with 15 % +inf (no zeros: the order of -0.0 and +0.0 is
    defined by neither version)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    cases = []
    for h, w in MEDIAN_EXTRA:
        src = rng.uniform(0.5, 128.0, (h, w)).astype(np.float32)
        src[rng.random((h, w)) < 0.15] = np.inf
        cases.append(median_case(torch, "random map",
                                 torch.as_tensor(src, device=dev)))
    return cases


def band_mm_cases(torch, cost, arms, max_arm, label):
    """B5's cases, both passes of one aggregation iteration as
    aggregate_banded runs them: ``cost`` padded as it pads it, the masks
    of ``arms``. Each label gives the mean (over the columns that select
    any slot) and largest count of selected window slots a column, the
    slots B5's walk visits. Its bound: the int8 mask and the margined
    volume read,
    the output written; two adds (hi and lo) per selected slot and output
    plane, and one per output."""
    from adcensus_torch.ops import band_mm

    d, h, w = cost.shape
    dp, hp, wp = band_mm.padded_dims(d, h, w)
    masks = band_mm.make_blocked_masks(arms, max_arm, hp, wp)
    vol = torch.nn.functional.pad(cost, (0, wp - w, 0, hp - h, 0, dp - d))
    cases = []
    for direction, vm, mask, pad in (
        ("horizontal", band_mm.with_margins(vol, wp, masks.pad_w),
         masks.mh, masks.pad_w),
        ("vertical", band_mm.with_margins(
            vol.transpose(1, 2).contiguous(), hp, masks.pad_h),
         masks.mv, masks.pad_h),
    ):
        args = (vm, mask, pad)
        n_out = dp * mask.shape[0] * mask.shape[2]
        sel = (mask != 0).sum(1)
        cases.append((
            f"{label}{direction} pass (selected slots a column: mean "
            f"{float(sel[sel > 0].float().mean()):.2f}, largest "
            f"{int(sel.max())} of {mask.shape[1]})",
            lambda a=args: band_mm.band_pass(*a),
            lambda a=args: band_mm.band_pass_plain(*a),
            lambda a=args: band_pass_library(torch, *a),
            mask.numel() + vm.numel() * 4 + n_out * 4,
            2 * dp * int(sel.sum()) + n_out,
        ))
    return cases


def cross_sum_cases(torch, vol, arms, max_arm, label):
    """B1's cases on ``vol`` and ``arms``, one per order, as kernel_cases
    gives them. Its bound: the volume read and written, the arms and sup
    read; one add per term of this run's arms and one division per
    cell."""
    from adcensus_torch.ops import cross_sum
    from adcensus_torch.stages import aggregate

    d, h, w = vol.shape
    hw = h * w
    terms = (arms[..., 0] + arms[..., 1] + 1).sum() + (
        arms[..., 2] + arms[..., 3] + 1
    ).sum()
    longest = int(arms.max())
    sups = (s.float() for s in aggregate.support_counts(arms, max_arm))
    cases = []
    for hf, sup in zip((True, False), sups):
        args = (vol, arms, sup, hf, max_arm)
        cases.append((
            f"{label}{'horizontal' if hf else 'vertical'}-first (arms up "
            f"to {longest})",
            lambda a=args: cross_sum.cross_pass(*a),
            lambda a=args: cross_sum.cross_pass_plain(*a), None,
            d * hw * 8 + hw * 20, d * (int(terms) + hw),
        ))
    return cases


def first_vote_phases(torch, inter, opts):
    """(label, disparity, target) of the first iteration's two voting
    phases on the main path's intermediates, as iterative_region_voting
    runs them: the mismatch phase on the LR-checked map, then the
    occlusion phase on the map the mismatch phase filled."""
    from adcensus_torch.stages import refine

    disp, arms = inter["after_lr_check"], inter["arms"]
    mism_target = inter["mismatch"] & ~torch.isfinite(disp)
    filled = refine.region_vote_phase(disp, arms, mism_target, opts)
    occl_target = inter["occlusion"] & ~torch.isfinite(filled)
    return [("first mismatch phase", disp, mism_target),
            ("first occlusion phase", filled, occl_target)]


def region_vote_case(torch, label, disp, arms, target, opts):
    """B3's case for one voting phase on ``disp`` at ``target`` (None:
    every pixel, the old design's work), as kernel_cases gives it. Its
    bound with a target: the mask read and the three outputs written over
    the map (13 B a pixel), each target's di, valid and arms read (21 B);
    one add per region cell of the targets and 2 * D a target for the
    reduction. With every pixel a target: 33 B a pixel, one add per region
    cell and 2 * D a pixel."""
    from adcensus_torch.ops import region_vote
    from adcensus_torch.stages import aggregate, refine

    h, w = disp.shape
    d = opts.disp_range
    max_arm = min(opts.cross_L1, 255)
    di, valid = refine.vote_indices(disp, opts)
    cells = aggregate.support_counts(arms, max_arm)[0]  # horizontal-first
    if target is None:
        n = h * w
        n_bytes, n_ops = n * 33, int(cells.sum()) + 2 * d * n
    else:
        n = int(target.sum())
        n_bytes = h * w * 13 + n * 21
        n_ops = int(cells[target].sum()) + 2 * d * n
    args = (di, valid, arms, d, max_arm)
    return (
        f"{label} ({n} targets, arms up to {int(arms.max())})",
        lambda: region_vote.region_vote_stats(*args, target=target),
        lambda: region_vote.region_vote_stats_plain(*args, target=target),
        None, n_bytes, n_ops,
    )


def interp_phases(torch, inter, left, opts):
    """(label, disparity, target, is_mismatch) of the two interpolation
    phases on the main path's intermediates, as proper_interpolation runs
    them: the mismatch phase on the voted map, then the occlusion phase
    on the map the mismatch phase filled."""
    from adcensus_torch.stages import refine

    disp = inter["after_voting"]
    mism_target = inter["mismatch"] & ~torch.isfinite(disp)
    fill_m = refine.interpolation_fills(disp, left, opts, True, mism_target)
    disp_o = torch.where(mism_target, fill_m, disp)
    occl_target = inter["occlusion"] & ~torch.isfinite(disp_o)
    return [("mismatch", disp, mism_target, True),
            ("occlusion", disp_o, occl_target, False)]


def ray_interp_case(torch, label, disp, left, offsets, target, is_mismatch):
    """B4's case for one phase, as kernel_cases gives it, labelled with
    its targets, ray-step total, cells probed and longest ray. Its bound
    counts what the function must touch: the target mask read and both
    outputs written over the map (6 B a pixel); the disparity of each
    distinct cell a ray step reads (4 B); the offset table, if there is a
    target; in a mismatch phase the color of each target and of each
    distinct hit cell (3 B); and 4 operations per ray step."""
    from adcensus_torch.ops import interp

    h, w = disp.shape
    steps, longest, probed, hits = ray_steps(torch, disp, target, offsets)
    n_targets, n_probed = int(target.sum()), int(probed.sum())
    n_bytes = h * w * 6 + n_probed * 4
    if n_targets:
        n_bytes += offsets.numel() * 4
    if is_mismatch:
        n_bytes += int((target | hits).sum()) * 3
    args = (disp, left, offsets, target, is_mismatch)
    return (
        f"{label} ({n_targets} targets, {steps} ray steps over {n_probed} "
        f"cells, longest ray {longest} of {offsets.shape[1]})",
        lambda: interp.ray_interp(*args),
        lambda: interp.ray_interp_plain(*args), None,
        n_bytes, steps * 4,
    )


def long_ray_phase(torch, label, disp, target):
    """(label, disparity, target, offsets) of B4 on long rays: D = 256 at
    a phase's targets in its map with every cell +inf but for a seeded
    2 %."""
    import numpy as np

    from adcensus_torch.stages import refine

    keep = np.random.default_rng(SEED).random(tuple(disp.shape)) < 0.02
    sparse = torch.where(torch.as_tensor(keep, device=disp.device), disp,
                         float("inf"))
    return (f"long rays, D=256, {label} targets, 98 % +inf", sparse, target,
            refine.ray_offsets(256, disp.device))


def ray_interp_extra_cases(torch, inter, left, opts):
    """B4 beyond the main path's two phases: a phase without targets (one
    pass over the mask), every pixel a target of the mismatch phase (the
    old design's work), and long rays (long_ray_phase)."""
    from adcensus_torch.stages import refine

    label, disp, target, _ = interp_phases(torch, inter, left, opts)[0]
    offsets = refine.ray_offsets(max(abs(opts.max_disparity),
                                     abs(opts.min_disparity)), disp.device)
    long_label, sparse, long_target, long_offsets = long_ray_phase(
        torch, label, disp, target)
    return [
        ray_interp_case(torch, f"empty {label} phase", disp, left, offsets,
                        torch.zeros_like(target), True),
        ray_interp_case(torch, f"every pixel, {label} map", disp, left,
                        offsets, torch.ones_like(target), True),
        ray_interp_case(torch, long_label, sparse, left, long_offsets,
                        long_target, True),
    ]


def main_intermediates(torch, left, right, opts):
    """The main path's stage outputs on one pair (match_core's
    intermediates), with the right image and the LR check's occlusion
    and mismatch masks."""
    from adcensus_torch.stages import cost as cost_stage
    from adcensus_torch.stages import pipeline, refine

    inter = pipeline.match_core(
        left, right, cost_stage.compute_gray(left),
        cost_stage.compute_gray(right), opts, return_intermediates=True,
    )
    inter["right"] = right
    _, inter["occlusion"], inter["mismatch"] = refine.outlier_detection(
        inter["disp_left_raw"], inter["disp_right_raw"], opts
    )
    return inter


def long_arm_cases(torch, dev, opts, inter):
    """B1, B3 and B5 at Cone size where the arms reach the cap, the arms of
    a near-constant image (100 +- 2 a channel), which run to cross_L1 or
    the border: B1 and B5 on a seeded random (MAX_D, H, W) float32 volume
    (B5's columns then select up to 69 slots), B3 on the main path's first
    mismatch phase, whose regions grow as (2 * arm + 1)^2."""
    import numpy as np

    from adcensus_torch.stages import arms as arms_stage

    rng = np.random.default_rng(SEED)
    image = (100 + rng.integers(-2, 3, size=(H, W, 3))).astype(np.uint8)
    arms = arms_stage.build_arms(torch.as_tensor(image, device=dev), opts)
    vol = torch.as_tensor(rng.random((MAX_D, H, W), np.float32), device=dev)
    label, disp, target = first_vote_phases(torch, inter, opts)[0]
    return {
        "cross_sum": cross_sum_cases(torch, vol, arms,
                                     min(opts.cross_L1, 255), "long arms, "),
        "region_vote": [region_vote_case(torch, f"long arms, {label}", disp,
                                         arms, target, opts)],
        "band_mm": band_mm_cases(torch, vol, arms, min(opts.cross_L1, 255),
                                 "long arms, "),
    }


def measure_case(torch, name, case):
    """Hold one kernel case bitwise against its plain version (and its
    library call, if any, within 1e-4), time all three, print a line;
    return (max |diff|, kernel ms, plain ms, library ms or None, bound ms,
    bound kind)."""
    label, kern, plain, library, n_bytes, n_ops, *steps = case
    out_k, out_p = kern(), plain()
    outs = (out_k, out_p) if isinstance(out_k, tuple) else (
        (out_k,), (out_p,))
    err = max(max_abs_err(torch, a, b) for a, b in zip(*outs))
    k_ms = time_ms(torch, kern)
    p_ms = time_ms(torch, plain)
    b_ms, b_kind = bound_ms(n_bytes, n_ops)
    l_ms, lib_note = None, ""
    if library is not None:
        lib_err = float((library() - out_k).abs().max())
        if not lib_err <= 1e-4:
            raise AssertionError(
                f"{name} {label}: the library call differs by {lib_err}"
            )
        l_ms = time_ms(torch, library)
        lib_note = f", library {l_ms:.4f} ms (max |diff| {lib_err:.3g})"
    if steps:  # a recurrence's latency a step, against its bound
        (n_steps, unit, chain), = steps
        lib_note += f", {k_ms * 1e6 / n_steps:.1f} ns per {unit}"
        if chain is not None:
            kind, rec_ms, per_step, step, mhz = chain
            which = kind if rec_ms > b_ms else b_kind
            lib_note += (f", {kind} bound {rec_ms:.4f} ms ({per_step:.1f} "
                         f"cycles a {step} at {mhz:.0f} MHz; {which} "
                         "bounds it)")
    print(f"[kernel] {name} {label}: {k_ms:.4f} ms, plain {p_ms:.4f} ms"
          f"{lib_note}, bound {b_ms:.4f} ms ({b_kind}, "
          f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} G operations); "
          "bitwise")
    return err, k_ms, p_ms, l_ms, b_ms, b_kind


def dense_matmul_note(torch, inter, opts):
    """CUDA-event ms of one dense cross_pass_matmul iteration per
    direction on the main path's cost_init (band matrices prebuilt, as
    aggregate builds them once), and its largest difference from B1's
    result. Not bitwise: the sums run in the matrix product's order."""
    from adcensus_torch.ops import cross_matmul, cross_sum
    from adcensus_torch.stages import aggregate

    vol, arms = inter["cost_init"], inter["arms"]
    max_arm = min(opts.cross_L1, 255)
    sup_h, sup_v = (s.float() for s in aggregate.support_counts(arms, max_arm))
    masks = cross_matmul.band_masks(arms, max_arm)
    out = []
    for hf, sup in ((True, sup_h), (False, sup_v)):
        args = (vol, arms, sup, hf, max_arm)
        dense = cross_matmul.cross_pass_matmul(*args, masks=masks)
        err = float((dense - cross_sum.cross_pass(*args)).abs().max())
        ms = time_ms(torch, lambda a=args: cross_matmul.cross_pass_matmul(
            *a, masks=masks))
        out.append((hf, ms, err))
    return out


def check_launches(tag: str, launches: dict) -> None:
    """Raise unless one match on path ``tag`` launched what PATHS says."""
    for name, want in PATHS[tag][2].items():
        got = launches[name]
        if (got == 0) if want is None else (got != want):
            raise AssertionError(
                f"[{tag}] launched {name} {got} times in one match, "
                f"expected {'at least one' if want is None else want}"
            )


def drive_path(torch, tag, left, right, opts, dev, gt):
    """One path of ``match_device``: launches of one match (counts reset
    just before and read just after), the median host-clock ms of
    MATCH_RUNS matches, determinism, bitwise equality with the same
    backend's plain-version pipeline, and bad-2.0 < BAD2_LIMIT_PCT."""
    import numpy as np

    from adcensus_torch.ops import _build
    from adcensus_torch.stages import pipeline
    from adcensus_torch.synthetic import bad_pct

    cross_backend, agg_impl, _ = PATHS[tag]
    kwargs = dict(device=dev, cross_backend=cross_backend, agg_impl=agg_impl)
    torch.cuda.synchronize()
    _build.reset_launches()
    disp = pipeline.match_device(left, right, opts, **kwargs)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    check_launches(tag, launches)

    times = []
    for _ in range(MATCH_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.match_device(left, right, opts, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(out.view(torch.int32), disp.view(torch.int32)):
        raise AssertionError(f"[{tag}] match_device is not deterministic")
    with plain_versions():
        _build.reset_launches()
        plain_disp = pipeline.match_device(left, right, opts, **kwargs)
        torch.cuda.synchronize()
        if any(_build.launches.values()):
            raise AssertionError(f"[{tag}] the plain pipeline launched a "
                                 "kernel")
    if not torch.equal(disp.view(torch.int32), plain_disp.view(torch.int32)):
        n = int((disp != plain_disp).sum())
        raise AssertionError(
            f"[{tag}] kernel and plain pipelines differ at {n} px"
        )
    disp_np = disp.cpu().numpy()
    if disp_np.shape != (H, W) or disp_np.dtype != np.float32:
        raise AssertionError(
            f"[{tag}] bad output {disp_np.shape} {disp_np.dtype}"
        )
    density = float(np.isfinite(disp_np).mean()) * 100.0
    bad2 = bad_pct(disp_np, gt, 2.0)
    if not density > 0.0:
        raise AssertionError(f"[{tag}] no valid disparity")
    if not bad2 < BAD2_LIMIT_PCT:
        raise AssertionError(f"[{tag}] bad-2.0 {bad2} % >= {BAD2_LIMIT_PCT} %")
    ms = statistics.median(times)
    print(f"[{tag}] launches in one match: {launches}")
    print(f"[{tag}] match_device {H}x{W} d=[0,{MAX_D}) cross_backend="
          f"{cross_backend!r} agg_impl={agg_impl!r}: median {ms:.3f} ms of "
          f"{MATCH_RUNS} (min {min(times):.3f}, max {max(times):.3f}), "
          f"{H * W * MAX_D / ms / 1e3:.1f} Mpix*disp/s; density "
          f"{density:.2f} %, bad-2.0 {bad2:.3f} %; equals the plain "
          "pipeline bitwise")
    return disp, launches


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.ops import _build
    from adcensus_torch.synthetic import two_layer_pair

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
    print(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s")

    opts = ADCensusOptions(max_disparity=MAX_D)
    left_np, right_np, gt = two_layer_pair(H, W, D_BG, D_FG, seed=SEED)
    left = torch.as_tensor(left_np, device=dev)
    right = torch.as_tensor(right_np, device=dev)

    # 3. kernels against their plain versions, on their paths' inputs
    inter = main_intermediates(torch, left, right, opts)
    results = {}
    for name, cases in kernel_cases(torch, inter, left, opts).items():
        rows = [measure_case(torch, name, case) for case in cases]
        errs, ks, ps, ls, bs, kinds = zip(*rows)
        ls = [v for v in ls if v is not None]
        results[name] = {
            "max_abs_err": max(errs),
            "ms": statistics.mean(ks),
            "plain_ms": statistics.mean(ps),
            "library_ms": statistics.mean(ls) if ls else None,
            "bound_ms": statistics.mean(bs),
            "bound_by": max(set(kinds), key=kinds.count),
        }
    # printed, not in the JSON: B3 and B4 on their old designs' work and
    # on a phase without targets (one pass over the mask), B4 on long
    # rays, and B1, B3 and B5 at long arms
    no_target = torch.zeros_like(inter["mismatch"])
    for label, target in (("every pixel", None), ("empty phase", no_target)):
        measure_case(torch, "region_vote", region_vote_case(
            torch, label, inter["after_lr_check"], inter["arms"], target,
            opts))
    for case in ray_interp_extra_cases(torch, inter, left, opts):
        measure_case(torch, "ray_interp", case)
    for name, cases in long_arm_cases(torch, dev, opts, inter).items():
        for case in cases:
            measure_case(torch, name, case)
    for case in median_extra_cases(torch, dev):
        measure_case(torch, "median_inplace", case)
    for case in dda_extra_cases(torch, dev):
        measure_case(torch, "dda", case)
    for name, case in cost_extra_cases(torch, dev):
        measure_case(torch, name, case)
    cost_tables_note(torch, dev, opts)
    for hf, ms, err in dense_matmul_note(torch, inter, opts):
        print(f"[note] dense cross_pass_matmul, "
              f"{'horizontal' if hf else 'vertical'}-first: {ms:.4f} ms "
              f"per iteration, not bitwise (max |diff| vs B1 {err:.3g})")
    del inter

    # 4. main path
    disp, launches = drive_path(torch, "main", left, right, opts, dev, gt)
    path_launches = {"main": launches}
    print(f"[main] card {card}")

    # 5. the matmul backend, dense and banded (B5)
    for tag in ("matmul", "banded"):
        disp_b, path_launches[tag] = drive_path(
            torch, tag, left, right, opts, dev, gt
        )
        fin, fin_b = torch.isfinite(disp), torch.isfinite(disp_b)
        same = (disp_b == disp) | (~fin & ~fin_b)
        near = (fin & fin_b & ((disp_b - disp).abs() <= 1e-3)) | (
            ~fin & ~fin_b)
        print(f"[{tag}] agrees with [main] on "
              f"{100.0 * float(same.float().mean()):.2f} % of pixels "
              f"bitwise, {100.0 * float(near.float().mean()):.2f} % within "
              "1e-3 (validity included)")

    # 5. [flags]: the in-place median (M1) and discontinuity adjustment (M2)
    opts_flags = ADCensusOptions(max_disparity=MAX_D, **FLAGS)
    disp_f, path_launches["flags"] = drive_path(
        torch, "flags", left, right, opts_flags, dev, gt)
    print(f"[flags] changes {int((disp_f != disp).sum())} of {H * W} pixels "
          "of [main]'s disparity")

    # 6. the batched pipeline, each group a CUDA graph replay
    drive_batched(torch, dev, opts, opts_flags, path_launches, card)

    # 7. the mixed-shape pipeline: Wood2-size and Cone-size in one graph
    drive_hetero(torch, dev, left, right, opts, path_launches, card)

    # 8. the CLI in parity mode, as a user runs it
    drive_cli(torch, dev, left_np, right_np, gt, card)

    # 9. the sharded layer at world size 1 on NCCL
    drive_sharded(torch, dev, left, right, {"main": opts, "matmul": opts,
                                            "flags": opts_flags},
                  path_launches, card)

    kernels = []
    for name, (source, replaces, path, _) in KERNELS.items():
        r = results[name]
        n = path_launches[path][name]
        print(f"[kernel] {name}: {r['ms']:.4f} ms per launch, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {n} launches per "
              f"[{path}] match")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


def host_ms(torch, fn, runs: int = MATCH_RUNS):
    """(median, min, max) host-clock ms of ``fn()`` over ``runs`` calls
    after one warm-up, each ended by ``torch.cuda.synchronize()``."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def assert_bitwise(torch, tag, a, b):
    if a.shape != b.shape or not torch.equal(a.view(torch.int32),
                                             b.view(torch.int32)):
        raise AssertionError(f"{tag} differs from match_device")


def first_call_memory(torch, dev, fn):
    """(result, peak allocated bytes, bytes reserved after) of a first
    ``fn()`` with no graph cached: the graph's pool stays reserved."""
    from adcensus_torch.utils import graphs

    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reserved = torch.cuda.memory_reserved(dev)
    out = fn()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated(dev) - base,
            torch.cuda.memory_reserved(dev) - reserved)


def print_call_profile(torch, tag, ms, pairs, fn):
    """Print the device's busy time in one ``fn()`` of ``pairs`` pairs
    against its median ``ms``, and its heaviest kernels."""
    prof = device_profile(torch, fn, top_n=6)
    if prof is None:
        print(f"[profile {tag}] not measured: the profiler recorded no "
              "device activity")
        return
    busy_ms, top, hand, call_ms = prof
    print(f"[profile {tag}] device busy {busy_ms:.3f} ms in a profiled call "
          f"of {call_ms:.3f} ms ({100.0 * (1.0 - busy_ms / call_ms):.1f} % "
          f"idle; the median call takes {ms:.3f} ms), {busy_ms / pairs:.3f} "
          "ms a pair; by kernel: "
          + "; ".join(f"{n} {t:.3f} ms x{c}" for n, t, c in top)
          + "; hand-written: "
          + "; ".join(f"{n} {t:.4f} ms x{c}" for n, (t, c) in hand.items()))


def drive_batched(torch, dev, opts, opts_flags, path_launches, card):
    """Phase 6 on the [main], [banded] and [flags] paths (the last with
    ``opts_flags``): 8 Cone-size pairs through match_batched_device, each
    group one CUDA graph replay. Raises unless every output is bitwise
    match_device on its pair and the capture launched g times what one
    match of the path launched."""
    import numpy as np

    from adcensus_torch.stages import pipeline
    from adcensus_torch.synthetic import two_layer_pair
    from adcensus_torch.utils import graphs

    pairs = [two_layer_pair(H, W, D_BG, D_FG, seed=s)[:2]
             for s in range(BATCH)]
    lefts, rights = (torch.as_tensor(np.stack(side), device=dev)
                     for side in zip(*pairs))
    volume = opts.disp_range * H * W * 4
    for tag, opts in (("main", opts), ("banded", opts),
                      ("flags", opts_flags)):
        cross_backend, agg_impl, _ = PATHS[tag]
        kwargs = dict(device=dev, cross_backend=cross_backend,
                      agg_impl=agg_impl)
        graphs.clear()
        g = pipeline._batch_group_size(BATCH, H, W, opts, dev,
                                       cross_backend=cross_backend)
        print(f"[batched {tag}] {BATCH} pairs {H}x{W} d=[0,{MAX_D}): group "
              f"{g} of {BATCH} in a budget of "
              f"{pipeline.group_budget(dev) / 2**30:.2f} GiB "
              f"({pipeline.GROUP_MEMORY_SHARE} of the free memory); card "
              f"{card}")
        held_bound = g * pipeline.pair_bytes(H, W, opts, dev, cross_backend)
        out, peak, held = first_call_memory(
            torch, dev, lambda: pipeline.match_batched_device(
                lefts, rights, opts, **kwargs))
        if held > held_bound:
            raise AssertionError(
                f"[batched {tag}] the graph holds {held / 2**20:.1f} MiB, "
                f"above the estimate {held_bound / 2**20:.1f} MiB")
        (entry,) = graphs.cached()
        want = {k: g * n for k, n in path_launches[tag].items()}
        if entry.launches != want:
            raise AssertionError(f"[batched {tag}] the capture launched "
                                 f"{entry.launches}, expected {want}")
        for i in range(BATCH):
            assert_bitwise(torch, f"[batched {tag}] pair {i}", out[i],
                           pipeline.match_device(lefts[i], rights[i], opts,
                                                 **kwargs))
        half = pipeline.match_batched_device(lefts, rights, opts,
                                             group=HALF_GROUP, **kwargs)
        assert_bitwise(torch, f"[batched {tag}] group {HALF_GROUP}", half,
                       out)
        graph_ms = host_ms(torch, lambda: pipeline.match_batched_device(
            lefts, rights, opts, **kwargs))
        loop_ms = host_ms(torch, lambda: [
            pipeline.match_device(lefts[i], rights[i], opts, **kwargs)
            for i in range(BATCH)])
        print(f"[batched {tag}] first call: peak allocated {peak / 2**20:.1f}"
              f" MiB ({peak / volume:.1f} volumes of {volume / 2**20:.1f} "
              "MiB: one pair's, as the capture frees a branch's tensors "
              "before the next branch runs; JAX's rule takes "
              f"{pipeline.GROUP_VOLUMES} a pair); the graph holds "
              f"{held / 2**20:.1f} MiB ({held / g / volume:.1f} volumes a "
              f"pair), within the card's estimate {held_bound / 2**20:.1f} "
              "MiB (pipeline.pair_bytes)")
        print(f"[batched {tag}] launches at capture: {entry.launches} "
              f"({g} x one match)")
        print(f"[batched {tag}] graph: median {graph_ms[0] / BATCH:.3f} ms a "
              f"pair (min {graph_ms[1] / BATCH:.3f}, max "
              f"{graph_ms[2] / BATCH:.3f}) of {MATCH_RUNS} calls of "
              f"{BATCH} pairs; loop of match_device: median "
              f"{loop_ms[0] / BATCH:.3f} ms a pair (min "
              f"{loop_ms[1] / BATCH:.3f}, max {loop_ms[2] / BATCH:.3f}); "
              f"each output bitwise match_device, also with group "
              f"{HALF_GROUP}")
        print_call_profile(torch, f"batched {tag}", graph_ms[0], BATCH,
                           lambda: pipeline.match_batched_device(
                               lefts, rights, opts, **kwargs))
    graphs.clear()


def drive_hetero(torch, dev, left, right, opts, path_launches, card):
    """Phase 7: a Wood2-size pair at D=128 and the Cone-size pair in one
    match_hetero_device graph, each output bitwise match_device on its
    pair, the capture's launches twice one [main] match's."""
    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.stages import pipeline
    from adcensus_torch.synthetic import two_layer_pair
    from adcensus_torch.utils import graphs

    h2, w2, d_bg, d_fg, seed, d2 = WOOD2
    wl, wr, _ = two_layer_pair(h2, w2, d_bg, d_fg, seed=seed)
    pairs = ((torch.as_tensor(wl, device=dev),
              torch.as_tensor(wr, device=dev)), (left, right))
    opts_seq = (ADCensusOptions(max_disparity=d2), opts)
    outs, _, held = first_call_memory(
        torch, dev, lambda: pipeline.match_hetero_device(pairs, opts_seq,
                                                         device=dev))
    held_bound = sum(pipeline.pair_bytes(l.shape[0], l.shape[1], o, dev)
                     for (l, _), o in zip(pairs, opts_seq))
    if held > held_bound:
        raise AssertionError(f"[hetero] the graph holds {held / 2**20:.1f} "
                             f"MiB, above {held_bound / 2**20:.1f} MiB")
    (entry,) = graphs.cached()
    want = {k: 2 * n for k, n in path_launches["main"].items()}
    if entry.launches != want:
        raise AssertionError(f"[hetero] the capture launched "
                             f"{entry.launches}, expected {want}")
    for (l, r), o, out in zip(pairs, opts_seq, outs):
        assert_bitwise(torch, f"[hetero] {tuple(l.shape[:2])}", out,
                       pipeline.match_device(l, r, o, device=dev))
    graph_ms = host_ms(torch, lambda: pipeline.match_hetero_device(
        pairs, opts_seq, device=dev))
    loop_ms = host_ms(torch, lambda: [
        pipeline.match_device(l, r, o, device=dev)
        for (l, r), o in zip(pairs, opts_seq)])
    vols = [o.disp_range * l.shape[0] * l.shape[1] * 4
            for (l, _), o in zip(pairs, opts_seq)]
    print(f"[hetero] {h2}x{w2} d=[0,{d2}) with {H}x{W} d=[0,{MAX_D}) in one "
          f"graph: median {graph_ms[0]:.3f} ms a call (min "
          f"{graph_ms[1]:.3f}, max {graph_ms[2]:.3f}); two match_device "
          f"calls: median {loop_ms[0]:.3f} ms (min {loop_ms[1]:.3f}, max "
          f"{loop_ms[2]:.3f}); launches at capture {entry.launches}; the "
          f"graph holds {held / 2**20:.1f} MiB ({held / sum(vols):.1f} "
          f"volumes of the two pairs), within the card's estimate "
          f"{held_bound / 2**20:.1f}; each output bitwise match_device; card "
          f"{card}")
    print_call_profile(torch, "hetero", graph_ms[0], len(pairs),
                       lambda: pipeline.match_hetero_device(
                           pairs, opts_seq, device=dev))
    graphs.clear()


def run_cli(args):
    """``python3 -m adcensus_torch.cli`` with ``args`` from the checkout's
    root; raises unless it exits 0. Returns its standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", "adcensus_torch.cli", *args],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S,
    )
    if proc.returncode != 0:
        raise AssertionError(f"[cli] exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def drive_cli(torch, dev, left_np, right_np, gt, card):
    """Phase 8: the Cone-size pair as PNGs through the CLI's parity mode
    in a subprocess, the same with --timing, and cli.run_pair in parity
    mode in process, bitwise equal to match(..., gray_mode="host64") with
    the in-place median."""
    import dataclasses

    import numpy as np

    from adcensus_torch import cli
    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.io import image, native_png
    from adcensus_torch.stages import pipeline
    from adcensus_torch.synthetic import bad_pct

    CLI_DIR.mkdir(parents=True, exist_ok=True)
    lp, rp = str(CLI_DIR / "L.png"), str(CLI_DIR / "R.png")
    image.save_png(left_np, lp)
    image.save_png(right_np, rp)
    loader = "native codec" if native_png.decode(lp) is not None else "PIL"
    if not np.array_equal(image.load_image_rgb(lp), left_np):
        raise AssertionError("[cli] the left PNG does not read back")

    opts = ADCensusOptions(max_disparity=MAX_D, exact_median=True)
    disp, _, _ = cli.run_pair(left_np, right_np, opts, verbose=False,
                              gray_mode="host64", device=dev)
    want = pipeline.match(left_np, right_np, opts, gray_mode="host64",
                          device=dev)["disparity"]
    if not np.array_equal(disp.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("[cli] run_pair in parity mode differs from "
                             "match(gray_mode='host64', exact_median=True)")
    default = pipeline.match(left_np, right_np,
                             dataclasses.replace(opts, exact_median=False),
                             device=dev)["disparity"]

    prefix, cloud = str(CLI_DIR / "cone"), str(CLI_DIR / "cone.txt")
    t0 = time.perf_counter()
    out = run_cli([lp, rp, "0", str(MAX_D), "--parity", "--out", prefix,
                   "--cloud", cloud])
    cli_s = time.perf_counter() - t0
    if "density_pct" not in out:
        raise AssertionError(f"[cli] no metrics in its output: {out}")
    for suffix in ("-d.png", "-c.png"):
        shape = image.load_image_rgb(prefix + suffix).shape
        if shape != (H, W, 3):
            raise AssertionError(f"[cli] {prefix + suffix} is {shape}")
    with open(cloud) as f:
        points = [line.split() for line in f]
    if len(points) != int(np.isfinite(disp).sum()) or any(
            len(p) != 6 for p in points):
        raise AssertionError(f"[cli] the cloud has {len(points)} points, "
                             f"the parity map {int(np.isfinite(disp).sum())}"
                             " valid pixels")
    stages = [line for line in run_cli([lp, rp, "0", str(MAX_D), "--parity",
                                        "--timing", "--no-save"]).splitlines()
              if "Mpix*disp/s" in line]
    if len(stages) != 7:
        raise AssertionError(f"[cli] --timing printed {stages}")
    print(f"[cli] image loader: {loader}; {H}x{W} d=[0,{MAX_D}) --parity: "
          f"exit 0 in {cli_s:.1f} s (process start, kernel load and one "
          f"match), {len(points)} cloud points, PNGs {H}x{W}; run_pair "
          "--parity equals match(gray_mode='host64', exact_median=True) "
          f"bitwise; bad-2.0 {bad_pct(disp, gt, 2.0):.3f} % (device gray, "
          f"out-of-place median: {bad_pct(default, gt, 2.0):.3f} %), "
          f"{int((disp != default).sum())} pixels differ; card {card}")
    for line in stages:
        print(f"[cli --parity --timing] {line.strip()}")


def drive_sharded(torch, dev, left, right, path_opts, path_launches, card):
    """Phase 9: ``match_sharded`` and ``match_sharded_batched`` at world
    size 1 on NCCL, each bitwise ``match_device`` with the same launches
    a match, and ms a match beside ``match_device``'s in turns. A failed
    NCCL start or any mismatch raises; nothing falls back."""
    import torch.distributed as dist

    from adcensus_torch.ops import _build
    from adcensus_torch.parallel import distributed, sharded
    from adcensus_torch.parallel.mesh import make_mesh
    from adcensus_torch.stages import cost as cost_stage
    from adcensus_torch.stages import pipeline
    from adcensus_torch.synthetic import two_layer_pair

    SHARDED_STORE.parent.mkdir(parents=True, exist_ok=True)
    SHARDED_STORE.unlink(missing_ok=True)
    t0 = time.perf_counter()
    distributed.initialize(init_method=SHARDED_STORE.as_uri(), world_size=1,
                           rank=0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"[sharded] backend {dist.get_backend()}")
        mesh = make_mesh(1, 1)
        init_s = time.perf_counter() - t0
        gray_l = cost_stage.compute_gray(left)
        gray_r = cost_stage.compute_gray(right)
        for label, axis, backend, path in SHARDED_CASES:
            opts = path_opts[path]

            def one():
                return sharded.match_sharded(left, right, gray_l, gray_r,
                                             opts, mesh, backend, axis)

            def device():
                return pipeline.match_device(left, right, opts, device=dev,
                                             cross_backend=backend)

            torch.cuda.synchronize()
            _build.reset_launches()
            out = one()
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            if launches != path_launches[path]:
                raise AssertionError(
                    f"[sharded {label}] launched {launches} in one match, "
                    f"[{path}] {path_launches[path]}")
            assert_bitwise(torch, f"[sharded {label}]", out, device())
            ms_d1, ms_s1, ms_s2, ms_d2 = (host_ms(torch, f) for f in
                                          (device, one, one, device))
            print(f"[sharded {label}] world 1 (NCCL), volume_axis={axis!r} "
                  f"cross_backend={backend!r}: median {ms_s1[0]:.3f} / "
                  f"{ms_s2[0]:.3f} ms a match of {MATCH_RUNS} (min "
                  f"{min(ms_s1[1], ms_s2[1]):.3f}); match_device "
                  f"{ms_d1[0]:.3f} / {ms_d2[0]:.3f} (in turns D S S D); "
                  f"launches {launches} as [{path}]; bitwise match_device; "
                  f"card {card}")
            print_call_profile(torch, f"sharded {label}", ms_s1[0], 1, one)
            print_call_profile(torch, f"sharded {label} match_device",
                               ms_d1[0], 1, device)

        pairs = [two_layer_pair(H, W, D_BG, D_FG, seed=s)[:2]
                 for s in range(SHARDED_BATCH)]
        lefts = torch.stack([torch.as_tensor(l, device=dev) for l, _ in pairs])
        rights = torch.stack([torch.as_tensor(r, device=dev)
                              for _, r in pairs])
        opts = path_opts["main"]
        torch.cuda.synchronize()
        _build.reset_launches()
        out = sharded.match_sharded_batched(
            lefts, rights, cost_stage.compute_gray(lefts),
            cost_stage.compute_gray(rights), opts, mesh)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        want = {k: SHARDED_BATCH * v for k, v in path_launches["main"].items()}
        if launches != want:
            raise AssertionError(f"[sharded batched] launched {launches}, "
                                 f"expected {want}")
        if tuple(out.shape) != (SHARDED_BATCH, H, W):
            raise AssertionError(f"[sharded batched] shape {out.shape}")
        for b in range(SHARDED_BATCH):
            assert_bitwise(torch, f"[sharded batched] pair {b}", out[b],
                           pipeline.match_device(lefts[b], rights[b], opts,
                                                 device=dev))
        print(f"[sharded batched] {SHARDED_BATCH} pairs on a (1, 1) mesh: "
              f"launches {launches} ({SHARDED_BATCH} x [main]); each pair "
              f"bitwise match_device; NCCL start and mesh {init_s:.2f} s")
    finally:
        dist.destroy_process_group()


def device_profile(torch, fn, top_n: int = 12):
    """Device time of one ``fn()`` (after a warm-up call) from
    torch.profiler: the union of its kernels' intervals (ms), the
    ``top_n`` kernels by total device time as (name, ms, calls),
    {kernel: (ms, calls)} summed for each hand-written kernel of KERNELS,
    in or out of the top, and the profiled call's host-clock ms; None
    when the profiler sees no device in PROFILE_TRIES calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):  # the profiler at times records nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA
        )
        if spans:
            break
    else:
        return None
    busy_us, end = 0.0, float("-inf")
    per_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        t, c = per_name.get(name, (0.0, 0))
        per_name[name] = (t + (e - s) / 1e3, c + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    hand = {}
    for kernel, (*_, symbol) in KERNELS.items():
        runs = [(t, c) for n, (t, c) in per_name.items() if symbol in n]
        hand[kernel] = (sum(t for t, _ in runs), sum(c for _, c in runs))
    return (busy_us / 1e3, [(n[:60], t, c) for n, (t, c) in top], hand,
            call_ms)


if __name__ == "__main__":
    sys.exit(main())
