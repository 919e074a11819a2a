"""End-to-end AD-Census pipeline: one stereo pair, or many.

Port of ``adcensus_tpu/stages/pipeline.py`` (ADCensusStereo::Match,
ADCensusStereo.cpp:69-132): cost init -> cross aggregation -> 4-direction
scanline -> left/right WTA -> multi-step refinement. One pair
(``match_device``, ``match``) runs eagerly on the device the images lie
on. The multi-pair entry points (``match_batched_device``,
``match_hetero_device``, ``match_batched``) run each group of pairs on a
CUDA device as one replay of a CUDA graph of ``match_core``
(``utils/graphs.py``), the counterpart of the JAX package's jitted,
statically unrolled groups, and on the CPU as an eager loop. Either way
each output is bitwise that pair's ``match_device``.

Each entry point runs in a span named after it, and each stage of
``match_core`` in a span of its own (``utils/profiling.py``); they are
recorded only while ``torch.profiler`` runs.

Every entry point takes ``cross_backend`` ("roll", the default: kernels
B1/B3, bitwise in the reference's order; or "matmul": band matrices for
aggregation and voting) and ``agg_impl`` (None: dense band matrices;
"banded": kernel B5 where it fits; "skip": no aggregation), in place of
the JAX package's ``use_pallas`` modes and ``ADC_AGG_IMPL``. The scanline
and interpolation kernels (B2, B4) run on CUDA with either backend.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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
from adcensus_torch.utils import graphs
from adcensus_torch.utils.profiling import (
    AGGREGATION, ARMS, COST, REFINE, SCANLINE, WTA, span, spanned,
)


def match_core(
    left: torch.Tensor,
    right: torch.Tensor,
    gray_l: torch.Tensor,
    gray_r: torch.Tensor,
    opts: ADCensusOptions,
    return_intermediates: bool = False,
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Full pipeline on (H, W, 3) uint8 RGB tensors; gray images are
    supplied separately so callers can choose the exact-parity host path.
    Returns the JAX package's keys: "disparity", and with
    ``return_intermediates`` the stage outputs. Each stage runs in a span
    named from ``profiling.STAGES``."""
    check_cross_options(cross_backend, agg_impl)
    with span(COST):
        census_l = cost_stage.census_transform_9x7(gray_l)
        census_r = cost_stage.census_transform_9x7(gray_r)
        cost_init = cost_stage.compute_cost_volume(
            left, right, census_l, census_r, opts
        )
    with span(ARMS):
        arms = arms_stage.build_arms(left, opts)
    with span(AGGREGATION):
        cost_aggr = agg_stage.aggregate(
            cost_init, arms, opts, cross_backend=cross_backend,
            agg_impl=agg_impl
        )
    with span(SCANLINE):
        cost_scan = scan_stage.scanline_optimize(cost_aggr, left, right, opts)
    with span(WTA):
        disp_left, disp_right = wta_stage.wta(cost_scan, opts)
    with span(REFINE):
        refined = refine_stage.multistep_refine(
            disp_left, disp_right, left, cost_scan, arms, opts,
            cross_backend=cross_backend,
        )
    out = {"disparity": refined["final"]}
    if return_intermediates:
        out.update(
            cost_init=cost_init,
            arms=arms,
            cost_aggr=cost_aggr,
            cost_scan=cost_scan,
            disp_left_raw=disp_left,
            disp_right_raw=disp_right,
            **{k: v for k, v in refined.items() if k != "final"},
        )
    return out


@spanned
def match_device(
    left,
    right,
    opts: Optional[ADCensusOptions] = None,
    device="cuda",
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
) -> torch.Tensor:
    """One pair, gray conversion on the device: (H, W, 3) uint8 images
    (tensors or arrays) -> (H, W) float32 disparity tensor on ``device``,
    +inf where invalid. The default device is the GPU; without one this
    raises, and only ``device="cpu"`` runs on the host."""
    opts = opts or ADCensusOptions()
    dev = resolve_device(device)
    with span("entry.h2d"):
        left = torch.as_tensor(left, device=dev)
        right = torch.as_tensor(right, device=dev)
    validate_inputs(left, right, opts)
    gray_l = cost_stage.compute_gray(left)
    gray_r = cost_stage.compute_gray(right)
    return match_core(left, right, gray_l, gray_r, opts,
                      cross_backend=cross_backend,
                      agg_impl=agg_impl)["disparity"]


def validate_inputs(left, right, opts: ADCensusOptions) -> None:
    """Fail fast on malformed inputs, mirroring the reference's guards
    (ADCensusStereo.cpp:71-76 rejects null/absent data, Initialize rejects
    non-positive dims, main.cpp:36-57 rejects mismatched loads)."""
    for name, img in (("left", left), ("right", right)):
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(
                f"{name} image must be (H, W, 3) RGB, got shape "
                f"{tuple(img.shape)}"
            )
        uint8 = torch.uint8 if isinstance(img, torch.Tensor) else np.uint8
        if img.dtype != uint8:
            raise TypeError(f"{name} image must be uint8, got {img.dtype}")
    if tuple(left.shape) != tuple(right.shape):
        raise ValueError(
            f"left/right shapes differ: {tuple(left.shape)} vs "
            f"{tuple(right.shape)}"
        )
    h, w = left.shape[:2]
    if h <= 0 or w <= 0:
        raise ValueError(f"image dimensions must be positive, got {w}x{h}")
    opts.validate()


@spanned
def match(
    left: np.ndarray,
    right: np.ndarray,
    opts: Optional[ADCensusOptions] = None,
    gray_mode: str = "device",
    return_intermediates: bool = False,
    device="cuda",
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Host-facing entry point: numpy images in, numpy arrays out.

    gray_mode:
      * "device" (default): float32 gray conversion on the device;
      * "host64": bit-exact double-precision gray on the host
        (cost_computor.cpp:69 truncates a double) for parity runs.
    """
    opts = opts or ADCensusOptions()
    left = np.asarray(left)
    right = np.asarray(right)
    validate_inputs(left, right, opts)
    if gray_mode not in ("device", "host64"):
        raise ValueError(f"unknown gray_mode {gray_mode!r}")
    dev = resolve_device(device)
    host = [left, right]
    if gray_mode == "host64":
        host += [cost_stage.compute_gray_host64(left),
                 cost_stage.compute_gray_host64(right)]
    with span("entry.h2d"):
        left_t, right_t, *grays = [torch.as_tensor(a, device=dev)
                                   for a in host]
    if grays:
        gray_l, gray_r = grays
    else:
        gray_l = cost_stage.compute_gray(left_t)
        gray_r = cost_stage.compute_gray(right_t)
    res = match_core(left_t, right_t, gray_l, gray_r, opts,
                     return_intermediates, cross_backend, agg_impl)
    with span("entry.d2h"):
        return {k: v.cpu().numpy() for k, v in res.items()}


# Bytes a pair of a group holds. JAX's rule is 6 (D, H, W) float32
# volumes (XLA's schedule kept 5.2 at B = 8 Cone on the v5e); off the card
# the port keeps it, so that the CPU picks JAX's groups. On the card each
# branch of a graph keeps pool segments of its own, one eager match's
# worth and more, and the matmul backend adds its (H, W, W) and (W, H, H)
# float32 band matrices: chip_smoke.py prints what a Cone-size group and a
# Wood2-size pair hold. The fixed share covers the pool's rounding of
# segments, which outweighs the volumes at small sizes.
GROUP_VOLUMES = 6
CUDA_GROUP_VOLUMES = 18
CUDA_PAIR_OVERHEAD = 256 * 2**20
# The share of the card's free memory a group may take. The rest is left
# for the caller's tensors and the estimate's error (JAX's 10 GiB of the
# v5e's 16 GB is a larger share, of a card that holds nothing else).
GROUP_MEMORY_SHARE = 0.5
# The budget off the card: JAX's, so that the CPU picks JAX's groups.
CPU_GROUP_BUDGET = 10 * 1024**3


def group_budget(device) -> int:
    """Bytes a group may take on ``device``: GROUP_MEMORY_SHARE of what is
    free on a CUDA card, counting what PyTorch's allocator holds unused
    (the cached graphs' pools among it: a key that is cached already
    needs no new memory), or CPU_GROUP_BUDGET elsewhere."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return CPU_GROUP_BUDGET
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(GROUP_MEMORY_SHARE * free)


def pair_bytes(h: int, w: int, opts: ADCensusOptions, device="cpu",
               cross_backend: str = "roll") -> int:
    """Bytes one (h, w) pair of a group is taken to hold on ``device``
    (see GROUP_VOLUMES)."""
    volume = opts.disp_range * h * w * 4
    if torch.device(device).type != "cuda":
        return GROUP_VOLUMES * volume
    band = h * w * (h + w) * 4 if cross_backend == "matmul" else 0
    return CUDA_GROUP_VOLUMES * volume + band + CUDA_PAIR_OVERHEAD


def _batch_group_size(b: int, h: int, w: int, opts: ADCensusOptions,
                      device="cpu", budget: Optional[int] = None,
                      cross_backend: str = "roll") -> int:
    """Largest divisor of ``b`` whose group of (h, w) pairs fits
    ``budget`` bytes (default: ``group_budget(device)``) at ``pair_bytes``
    a pair (``adcensus_tpu/stages/pipeline.py:158-168``)."""
    if budget is None:
        budget = group_budget(device)
    per_pair = pair_bytes(h, w, opts, device, cross_backend)
    g = max(1, min(b, int(budget // max(per_pair, 1))))
    while b % g:
        g -= 1
    return g


@spanned
def match_batched_device(
    lefts,
    rights,
    opts: Optional[ADCensusOptions] = None,
    device="cuda",
    group: Optional[int] = None,
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
) -> torch.Tensor:
    """Batched pipeline, gray conversion on the device: (B, H, W, 3) uint8
    stacks (tensors or arrays) -> (B, H, W) float32 disparities on
    ``device``. Groups of ``group`` pairs (default: the largest divisor of
    B in ``group_budget``) run as one CUDA graph replay each; a group that
    does not divide B raises ValueError before any work."""
    return _match_stacks((lefts, rights), opts, device, group,
                         cross_backend, agg_impl)


@spanned
def match_batched(
    lefts,
    rights,
    grays_l,
    grays_r,
    opts: Optional[ADCensusOptions] = None,
    device="cuda",
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
) -> torch.Tensor:
    """``match_batched_device`` with precomputed (B, H, W) uint8 grays
    (e.g. ``compute_gray_host64``'s), grouped by the default rule."""
    return _match_stacks((lefts, rights, grays_l, grays_r), opts, device,
                         None, cross_backend, agg_impl)


@spanned
def match_hetero_device(
    pairs: Sequence,
    opts_seq: Sequence[ADCensusOptions],
    device="cuda",
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """Pairs of different shapes and options in one dispatch (e.g. a
    Wood2-size pair at D = 128 with a Cone-size pair at D = 64, BASELINE
    config 3's mixed stream): a tuple of (left, right) (H_i, W_i, 3) uint8
    images and a tuple of their options -> a tuple of (H_i, W_i) float32
    disparities. On a CUDA device all pairs are one graph, a branch each
    at its own shape: nothing is padded to the largest."""
    check_cross_options(cross_backend, agg_impl)
    pairs, opts_seq = tuple(pairs), tuple(opts_seq)
    if not pairs or len(pairs) != len(opts_seq):
        raise ValueError(
            f"need one options per pair and at least one pair, got "
            f"{len(pairs)} pairs and {len(opts_seq)} options"
        )
    for (left, right), opts in zip(pairs, opts_seq):
        validate_inputs(left, right, opts)
    dev = resolve_device(device)
    with span("entry.h2d"):
        pairs = tuple((torch.as_tensor(l, device=dev),
                       torch.as_tensor(r, device=dev)) for l, r in pairs)

    def run(i, inputs):
        left, right = inputs[i]
        return match_core(
            left, right, cost_stage.compute_gray(left),
            cost_stage.compute_gray(right), opts_seq[i],
            cross_backend=cross_backend, agg_impl=agg_impl,
        )["disparity"]

    if dev.type != "cuda":
        return tuple(run(i, pairs) for i in range(len(pairs)))
    shapes = tuple(tuple(left.shape) for left, _ in pairs)
    kinds = list(zip(shapes, opts_seq))
    warm_up = [i for i, kind in enumerate(kinds) if kinds.index(kind) == i]

    def buffers():
        inputs = tuple(
            tuple(torch.zeros(s, dtype=torch.uint8, device=dev)
                  for _ in range(2))
            for s in shapes
        )
        outputs = tuple(torch.empty(s[:2], dtype=torch.float32, device=dev)
                        for s in shapes)
        return inputs, outputs

    entry = graphs.captured(
        ("hetero", shapes, opts_seq, cross_backend, agg_impl), dev, buffers,
        run, len(pairs), warm_up,
    )
    for static, pair in zip(entry.inputs, pairs):
        for buf, img in zip(static, pair):
            buf.copy_(img)
    entry.graph.replay()
    return tuple(out.clone() for out in entry.outputs)


def _match_stacks(stacks, opts, device, group, cross_backend,
                  agg_impl) -> torch.Tensor:
    """The batched pipelines on ``stacks``: (lefts, rights), or with
    (grays_l, grays_r)."""
    opts = opts or ADCensusOptions()
    check_cross_options(cross_backend, agg_impl)
    _validate_stacks(stacks, opts)
    b, h, w = stacks[0].shape[:3]
    if group is not None and (group < 1 or b % group):
        raise ValueError(f"group {group} must divide the batch of {b}")
    dev = resolve_device(device)
    if group is None:
        with span("entry.group_rule"):
            g = _batch_group_size(b, h, w, opts, dev,
                                  cross_backend=cross_backend)
    else:
        g = group
    with span("entry.h2d"):
        stacks = tuple(torch.as_tensor(s, device=dev) for s in stacks)

    def run(i, inputs):
        left, right = inputs[0][i], inputs[1][i]
        if len(inputs) == 4:
            gray_l, gray_r = inputs[2][i], inputs[3][i]
        else:
            gray_l = cost_stage.compute_gray(left)
            gray_r = cost_stage.compute_gray(right)
        return match_core(left, right, gray_l, gray_r, opts,
                          cross_backend=cross_backend,
                          agg_impl=agg_impl)["disparity"]

    if dev.type != "cuda":
        return torch.stack([run(i, stacks) for i in range(b)])

    def buffers():
        inputs = tuple(torch.zeros((g,) + tuple(s.shape[1:]),
                                   dtype=torch.uint8, device=dev)
                       for s in stacks)
        return inputs, torch.empty((g, h, w), dtype=torch.float32,
                                   device=dev)

    entry = graphs.captured(
        ("batched", len(stacks), g, h, w, opts, cross_backend, agg_impl),
        dev, buffers, run, g, (0,),
    )
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    for k in range(0, b, g):
        with span("entry.replay"):
            for buf, s in zip(entry.inputs, stacks):
                buf.copy_(s[k:k + g])
            entry.graph.replay()
            out[k:k + g].copy_(entry.outputs)
    return out


def _validate_stacks(stacks, opts: ADCensusOptions) -> None:
    """Raise unless ``stacks`` are (B, H, W, 3) uint8 image stacks of one
    shape, B >= 1, with (B, H, W) uint8 grays if given, each pair valid
    for ``validate_inputs`` (one pair stands for all: a stack has one
    shape and type)."""
    lefts, rights = stacks[:2]
    for name, s in (("lefts", lefts), ("rights", rights)):
        if s.ndim != 4:
            raise ValueError(
                f"{name} must be a (B, H, W, 3) stack, got shape "
                f"{tuple(s.shape)}"
            )
    if tuple(lefts.shape) != tuple(rights.shape):
        raise ValueError(
            f"lefts/rights shapes differ: {tuple(lefts.shape)} vs "
            f"{tuple(rights.shape)}"
        )
    if lefts.shape[0] == 0:
        raise ValueError("the batch is empty")
    validate_inputs(lefts[0], rights[0], opts)
    for name, s in zip(("grays_l", "grays_r"), stacks[2:]):
        if tuple(s.shape) != tuple(lefts.shape[:3]):
            raise ValueError(
                f"{name} must have shape {tuple(lefts.shape[:3])}, got "
                f"{tuple(s.shape)}"
            )
        uint8 = torch.uint8 if isinstance(s, torch.Tensor) else np.uint8
        if s.dtype != uint8:
            raise TypeError(f"{name} must be uint8, got {s.dtype}")
