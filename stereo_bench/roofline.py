"""Least device time of kernels B1 (a cross-aggregation pass) and B2 (a
scanline pass) from the shape of their work, as ``chip_smoke.py``
counts it: each input read once and each output written once, over the
published peaks of one NVIDIA H100 SXM (data sheet, 700 W).

Both are bound by bytes. B1's float32 additions, one a term of every
arm at its longest (arms capped at 34: 2 * 69 + 1 a cell) and one
division a cell, and B2's nine operations a cell take less time at the
scalar rate than their bytes at the memory rate, whatever the arms
(``ops_bound_s`` gives that time, and a test holds it below).
"""
from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12      # HBM3
SCALAR_OPS_PER_S = 67e12       # float32 outside the tensor cores
MAX_ARM = 34                   # the configurations' cross_L1


def b1_bytes(h: int, w: int, d: int) -> int:
    """One B1 launch: the (D, H, W) float32 volume read and written, the
    (H, W, 4) int32 arms and (H, W) float32 support counts read."""
    return 8 * d * h * w + 20 * h * w


def b1_ops_max(h: int, w: int, d: int, max_arm: int = MAX_ARM) -> int:
    """One B1 launch with every arm at ``max_arm``: two passes of
    2 * max_arm + 1 terms a cell, and a division."""
    return d * h * w * (2 * (2 * max_arm + 1) + 1)


def b2_bytes(h: int, w: int, d: int) -> int:
    """One B2 launch, averaged over a match's four passes (two along
    rows, S = W; two along columns, S = H): the float32 volume read and
    written, the uint8 penalty codes read, and S int32 step flags."""
    return 9 * d * h * w + 2 * (h + w)


def b2_ops(h: int, w: int, d: int) -> int:
    return 9 * d * h * w


def bytes_bound_s(n_bytes: float) -> float:
    return n_bytes / MEM_BYTES_PER_S


def ops_bound_s(n_ops: float) -> float:
    return n_ops / SCALAR_OPS_PER_S


# kernel id (hand_kernels.json) -> least seconds of one launch at (H, W, D)
BOUNDS = {
    "B1": lambda h, w, d: bytes_bound_s(b1_bytes(h, w, d)),
    "B2": lambda h, w, d: bytes_bound_s(b2_bytes(h, w, d)),
}
