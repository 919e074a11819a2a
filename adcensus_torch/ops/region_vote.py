"""Kernel B3: region-voting histogram statistics.

Port of ``adcensus_tpu/ops/region_vote_pallas.py``. For every pixel, the
(argmax d, max height, total count) of the disparity histogram over its
horizontal-first cross support region (multistep_refiner.cpp:183-197).
``region_vote_stats`` launches ``csrc/region_vote.cu`` for a CUDA tensor
and runs ``region_vote_stats_plain`` (the one-hot branch of the JAX
``region_vote_stats``) for a CPU tensor. Ties go to the lowest d.
"""
from __future__ import annotations

from typing import Tuple

import torch

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for
from adcensus_torch.ops.cross_sum import cross_pass_plain


def region_vote_stats_plain(
    di: torch.Tensor,
    valid: torch.Tensor,
    arms: torch.Tensor,
    d_range: int,
    max_arm: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel B3: a (D, H, W) one-hot volume through the
    plain horizontal-first cross sum, then argmax / max / sum over D."""
    planes = torch.arange(d_range, device=di.device)[:, None, None]
    onehot = ((di[None] == planes) & valid[None]).to(torch.float32)
    hist = cross_pass_plain(
        onehot,
        arms,
        torch.ones(di.shape, device=di.device),
        horizontal_first=True,
        max_arm=max_arm,
        normalize=False,
    ).to(torch.int32)
    return (
        hist.argmax(dim=0).to(torch.int32),
        hist.amax(dim=0),
        hist.sum(dim=0, dtype=torch.int32),
    )


def region_vote_stats(
    di: torch.Tensor,
    valid: torch.Tensor,
    arms: torch.Tensor,
    d_range: int,
    max_arm: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_index, max_ht, count), each (H, W) int32.

    di: (H, W) int32 rounded disparity indices in [0, d_range); valid:
    (H, W) bool; arms: (H, W, 4) int32.
    """
    h, w = di.shape
    for name, t, dtype, shape in (
        ("di", di, torch.int32, (h, w)),
        ("valid", valid, torch.bool, (h, w)),
        ("arms", arms, torch.int32, (h, w, 4)),
    ):
        _build.check(name, t, dtype, shape, di.device)
    if not kernels_for(di):
        return region_vote_stats_plain(di, valid, arms, d_range, max_arm)
    out = torch.empty((3, h, w), dtype=torch.int32, device=di.device)
    _build.launch(
        "region_vote",
        di.data_ptr(), valid.data_ptr(), arms.data_ptr(), out.data_ptr(),
        int(d_range), h, w, int(max_arm),
        torch.cuda.current_stream(di.device).cuda_stream,
    )
    return out[0], out[1], out[2]
