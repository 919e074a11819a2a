"""Kernel A1 (cross arms, the four directions): launch.

``csrc/arms.cu`` reads the (H, W, 3) image once and writes the (H, W, 4)
arms, bitwise ``stages/arms.py``'s plain ``build_arms_plain``. That ports
``adcensus_tpu/stages/arms.py``, which is ``jnp`` and not a Pallas
kernel: no TPU kernel corresponds to A1. The stage routes
(``stages/arms.py:build_arms``): a CUDA tensor launches A1, a CPU tensor
runs the plain body.
"""
from __future__ import annotations

import torch

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import f32


def arms(img: torch.Tensor, steps: int, l2, t1, t2, row_offset: int,
         full_h: int, full_w: int) -> torch.Tensor:
    """Kernel A1: the (H, W, 4) int32 arms [left, right, top, bottom] of a
    CUDA (H, W, 3) uint8 image, at most ``steps`` long, with the plain
    version's thresholds (``cross_L2``, ``cross_t1``, ``cross_t2``) and
    its slab mode (row 0 of ``img`` is row ``row_offset`` of a ``full_h``
    x ``full_w`` image)."""
    img = img.contiguous()
    h, w, _ = img.shape
    _build.check("img", img, torch.uint8, (h, w, 3), img.device)
    if steps < 0:
        raise ValueError(f"steps must be at least 0, got {steps}")
    out = torch.empty((h, w, 4), dtype=torch.int32, device=img.device)
    if h * w:
        _build.launch(
            "arms", img.data_ptr(), out.data_ptr(), h, w, row_offset,
            full_h, full_w, steps, f32(l2), f32(t1), f32(t2),
            torch.cuda.current_stream(img.device).cuda_stream,
        )
    return out
