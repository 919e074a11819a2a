"""Small shared tensor ops: device choice, rounding, color distance,
shifts. Port of ``adcensus_tpu/ops/basic.py``."""
from __future__ import annotations

import numpy as np
import torch


def f32(x) -> float:
    """The float32 value nearest ``x``, as a Python float. Scalars of the
    JAX package are float32 (``jnp.float32(0.4)``); a tensor op with this
    scalar rounds the same whether it runs in float32 or float64."""
    return float(np.float32(x))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain versions on the host"
        )
    return dev


CROSS_BACKENDS = ("roll", "matmul")
AGG_IMPLS = (None, "banded", "skip")


def check_cross_options(cross_backend: str, agg_impl=None) -> None:
    """Raise ValueError unless ``cross_backend`` is "roll" (kernels B1/B3,
    bitwise in the reference's summation order) or "matmul" (band
    matrices), and ``agg_impl`` is None (dense band matrices), "banded"
    (kernel B5) or "skip" (no aggregation, an ablation). These replace the
    JAX package's ``use_pallas`` string modes and ``ADC_AGG_IMPL``."""
    if cross_backend not in CROSS_BACKENDS:
        raise ValueError(
            f"unknown cross_backend {cross_backend!r}; expected one of "
            f"{CROSS_BACKENDS}"
        )
    if agg_impl not in AGG_IMPLS:
        raise ValueError(
            f"unknown agg_impl {agg_impl!r}; expected one of {AGG_IMPLS}"
        )


def kernels_for(t: torch.Tensor) -> bool:
    """Route of a kernel wrapper: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (run the plain version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def lround(x: torch.Tensor) -> torch.Tensor:
    """C lround on float32: round half away from zero, as int32.

    (``torch.round`` rounds half to even and disagrees on *.5 values.)
    """
    return torch.where(
        x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)
    ).to(torch.int32)


def color_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Max-over-channels absolute difference of two (..., 3) images
    (cross_aggregator.h:78-80), int32 (...)."""
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return d.amax(dim=-1)


def color_absdiff_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum-over-channels absolute difference, int32 (...)."""
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return d.sum(dim=-1, dtype=torch.int32)


def shift2d(img: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Shift a (H, W, ...) tensor so out[y, x] = img[y - dy, x - dx],
    with ``fill`` in the vacated cells."""
    h, w = img.shape[0], img.shape[1]
    out = torch.full_like(img, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(dy, 0) : h + min(dy, 0), max(dx, 0) : w + min(dx, 0)] = img[
        max(-dy, 0) : h - max(dy, 0), max(-dx, 0) : w - max(dx, 0)
    ]
    return out


def shift_last(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """Shift along the last axis: out[..., i] = x[..., i - s]."""
    n = x.shape[-1]
    out = torch.full_like(x, fill)
    if abs(s) >= n:
        return out
    out[..., max(s, 0) : n + min(s, 0)] = x[..., max(-s, 0) : n - max(s, 0)]
    return out
