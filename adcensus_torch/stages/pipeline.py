"""End-to-end AD-Census pipeline for one stereo pair.

Port of ``adcensus_tpu/stages/pipeline.py`` (ADCensusStereo::Match,
ADCensusStereo.cpp:69-132): cost init -> cross aggregation -> 4-direction
scanline -> left/right WTA -> multi-step refinement, run eagerly on the
device the images lie on. The batched and mixed-shape entry points are not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops.basic import resolve_device
from adcensus_torch.stages import aggregate as agg_stage
from adcensus_torch.stages import arms as arms_stage
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.stages import refine as refine_stage
from adcensus_torch.stages import scanline as scan_stage
from adcensus_torch.stages import wta as wta_stage


def match_core(
    left: torch.Tensor,
    right: torch.Tensor,
    gray_l: torch.Tensor,
    gray_r: torch.Tensor,
    opts: ADCensusOptions,
    return_intermediates: bool = False,
) -> Dict[str, torch.Tensor]:
    """Full pipeline on (H, W, 3) uint8 RGB tensors; gray images are
    supplied separately so callers can choose the exact-parity host path.
    Returns the JAX package's keys: "disparity", and with
    ``return_intermediates`` the stage outputs."""
    census_l = cost_stage.census_transform_9x7(gray_l)
    census_r = cost_stage.census_transform_9x7(gray_r)
    cost_init = cost_stage.compute_cost_volume(
        left, right, census_l, census_r, opts
    )
    arms = arms_stage.build_arms(left, opts)
    cost_aggr = agg_stage.aggregate(cost_init, arms, opts)
    cost_scan = scan_stage.scanline_optimize(cost_aggr, left, right, opts)
    disp_left = wta_stage.wta_left(cost_scan, opts)
    disp_right = wta_stage.wta_right(cost_scan, opts)
    refined = refine_stage.multistep_refine(
        disp_left, disp_right, left, cost_scan, arms, opts
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


def match_device(
    left,
    right,
    opts: Optional[ADCensusOptions] = None,
    device="cuda",
) -> torch.Tensor:
    """One pair, gray conversion on the device: (H, W, 3) uint8 images
    (tensors or arrays) -> (H, W) float32 disparity tensor on ``device``,
    +inf where invalid. The default device is the GPU; without one this
    raises, and only ``device="cpu"`` runs on the host."""
    opts = opts or ADCensusOptions()
    dev = resolve_device(device)
    left = torch.as_tensor(left, device=dev)
    right = torch.as_tensor(right, device=dev)
    validate_inputs(left, right, opts)
    gray_l = cost_stage.compute_gray(left)
    gray_r = cost_stage.compute_gray(right)
    return match_core(left, right, gray_l, gray_r, opts)["disparity"]


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


def match(
    left: np.ndarray,
    right: np.ndarray,
    opts: Optional[ADCensusOptions] = None,
    gray_mode: str = "device",
    return_intermediates: bool = False,
    device="cuda",
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
    left_t = torch.as_tensor(left, device=dev)
    right_t = torch.as_tensor(right, device=dev)
    if gray_mode == "host64":
        gray_l = torch.as_tensor(cost_stage.compute_gray_host64(left), device=dev)
        gray_r = torch.as_tensor(cost_stage.compute_gray_host64(right), device=dev)
    else:
        gray_l = cost_stage.compute_gray(left_t)
        gray_r = cost_stage.compute_gray(right_t)
    res = match_core(left_t, right_t, gray_l, gray_r, opts, return_intermediates)
    return {k: v.cpu().numpy() for k, v in res.items()}
