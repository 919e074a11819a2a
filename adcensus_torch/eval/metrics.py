"""Disparity evaluation metrics, numpy on the host.

The port's own copy of ``adcensus_tpu/eval/metrics.py``. The reference
publishes no numeric metrics; these are the standard Middlebury bad-delta
and RMS evaluators.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def bad_delta(
    disp: np.ndarray,
    gt: np.ndarray,
    delta: float = 2.0,
    count_invalid_as_bad: bool = True,
) -> float:
    """Fraction (%) of GT-valid pixels with |disp - gt| > delta.

    Invalid predictions (inf/NaN) count as bad by default.
    """
    gt_valid = np.isfinite(gt)
    pred_valid = np.isfinite(disp)
    if count_invalid_as_bad:
        bad = gt_valid & (~pred_valid | (np.abs(np.where(pred_valid, disp, 0) - gt) > delta))
    else:
        gt_valid = gt_valid & pred_valid
        bad = gt_valid & (np.abs(disp - gt) > delta)
    n = gt_valid.sum()
    return float(bad.sum()) / max(int(n), 1) * 100.0


def rms_error(disp: np.ndarray, gt: np.ndarray) -> float:
    """RMS disparity error over pixels valid in both maps."""
    m = np.isfinite(gt) & np.isfinite(disp)
    if not m.any():
        return float("nan")
    return float(np.sqrt(np.mean((disp[m] - gt[m]) ** 2)))


def density(disp: np.ndarray) -> float:
    """Fraction (%) of pixels with a valid (finite) disparity."""
    return float(np.isfinite(disp).mean()) * 100.0


def evaluate(
    disp: np.ndarray, gt: Optional[np.ndarray]
) -> Dict[str, float]:
    out = {"density_pct": density(disp)}
    if gt is not None:
        out.update(
            bad_0_5_pct=bad_delta(disp, gt, 0.5),
            bad_1_0_pct=bad_delta(disp, gt, 1.0),
            bad_2_0_pct=bad_delta(disp, gt, 2.0),
            bad_4_0_pct=bad_delta(disp, gt, 4.0),
            rms=rms_error(disp, gt),
        )
    return out


def disparity_agreement(
    a: np.ndarray, b: np.ndarray, tol: float = 1e-4
) -> Dict[str, float]:
    """Agreement stats between two disparity maps (validity-aware)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    both = fa & fb
    same_valid = float((fa == fb).mean())
    close = np.abs(a[both] - b[both]) <= tol if both.any() else np.array([])
    return {
        "validity_agreement": same_valid,
        "value_agreement": float(close.mean()) if close.size else 1.0,
        "max_abs_diff": float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0,
    }
