"""Kernel W1 (winner-take-all, both views): launch.

``csrc/wta.cu`` reads the (D, H, W) volume once and writes both views'
maps, bitwise ``stages/wta.py``'s plain ``wta_left`` and ``wta_right``.
Those port ``adcensus_tpu/stages/wta.py``, which is ``jnp`` and not a
Pallas kernel: no TPU kernel corresponds to W1. The stage routes
(``stages/wta.py:wta``): a CUDA tensor launches W1, a CPU tensor runs the
plain bodies.
"""
from __future__ import annotations

import torch

from adcensus_torch.ops import _build


def wta(cost: torch.Tensor, min_disparity: int, real_w: int):
    """Kernel W1: the (H, W) float32 left and right disparity maps of a
    CUDA (D, H, W) float32 volume. Columns at or beyond ``real_w`` (and
    below 0) read as Large_Float, for both views."""
    cost = cost.contiguous()
    d, h, w = cost.shape
    _build.check("cost", cost, torch.float32, (d, h, w), cost.device)
    if d < 1:
        raise ValueError("the volume needs at least one plane")
    if not 0 <= real_w <= w:
        raise ValueError(f"real_w {real_w} must lie in [0, {w}]")
    out_l = torch.empty((h, w), dtype=torch.float32, device=cost.device)
    out_r = torch.empty((h, w), dtype=torch.float32, device=cost.device)
    if h * w:
        _build.launch(
            "wta", cost.data_ptr(), out_l.data_ptr(), out_r.data_ptr(), d, h,
            w, min_disparity, real_w,
            torch.cuda.current_stream(cost.device).cuda_stream,
        )
    return out_l, out_r
