"""Kernel M1: the reference's in-place 3x3 median.

Port of ``adcensus_tpu/stages/refine.py:median_filter_3x3_inplace``
(adcensus_util.cpp:55-81 called with in == out at
multistep_refiner.cpp:86): pixel (y, x) reads already-filtered values at
(y-1, x-1..x+1) and (y, x-1) and original values elsewhere, in raster
order. The JAX package runs it as a ``lax.scan`` over the W + 2H columns
of the map sheared by t = x + 2y, not as a Pallas kernel.
``median_inplace`` launches ``csrc/median_inplace.cu`` for a CUDA tensor
and runs ``median_inplace_plain``, the same scan as a torch loop, for a
CPU tensor.

Window populations count in-image +inf disparities, like the reference's
clipped window; out-of-image slots are +inf, which sorts last, and the
median is the (population // 2)-th smallest of the nine.
"""
from __future__ import annotations

import torch

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for


def _shear(a: torch.Tensor, t_cols: int, fill) -> torch.Tensor:
    """S[y, t] = a[y, t - 2y] (``fill`` outside) without gathers: pad the
    rows to pitch P = t_cols + 2, flatten, and read back with pitch
    t_cols; flat index y * t_cols + t = y * P + (t - 2y) lands on
    a_padded[y, t - 2y], and t - 2y < 0 wraps into the previous row's
    fill."""
    h, w = a.shape
    p = t_cols + 2
    ap = torch.full((h + 1, p), fill, dtype=a.dtype, device=a.device)
    ap[:h, :w] = a
    return ap.reshape(-1)[: h * t_cols].reshape(h, t_cols)


def _unshear(s: torch.Tensor, w: int, fill) -> torch.Tensor:
    """Inverse of _shear: b[y, x] = s[y, x + 2y] (the same pitch trick)."""
    h, t_cols = s.shape
    p = t_cols + 2
    sp = torch.full((h + 1, t_cols), fill, dtype=s.dtype, device=s.device)
    sp[:h] = s
    return sp.reshape(-1)[: h * p].reshape(h, p)[:, :w]


def window_counts(h: int, w: int, device) -> torch.Tensor:
    """(H, W) int64 in-image population of each 3x3 window."""
    ys, xs = torch.arange(h, device=device), torch.arange(w, device=device)
    rows = 1 + (ys > 0).long() + (ys < h - 1).long()
    cols = 1 + (xs > 0).long() + (xs < w - 1).long()
    return rows[:, None] * cols[None, :]


def median_inplace_plain(disp: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel M1: the JAX package's scan over sheared
    columns, one torch step a column. Step t holds every pixel with
    x + 2y = t; its filtered dependencies lie in sheared columns t-1 to
    t-3, carried as c1, c2, c3."""
    h, w = disp.shape
    if not disp.numel():
        return disp.clone()
    inf = float("inf")
    t_cols = w + 2 * h  # covers x + 2y for all pixels
    s_orig = _shear(disp, t_cols, inf)
    s_idx = _shear(window_counts(h, w, disp.device).clamp(min=1) // 2,
                   t_cols, 0)
    s_act = _shear(torch.ones((h, w), dtype=torch.bool, device=disp.device),
                   t_cols, False)

    def down(col):  # col[y] -> col[y-1] (the row above), +inf at y = 0
        return torch.cat([col.new_full((1,), inf), col[:-1]])

    def col_at(s, off):  # S[:, t + off], +inf past the end
        out = torch.full_like(s, inf)
        out[:, : t_cols - off] = s[:, off:]
        return out

    below = torch.cat([s_orig[1:], s_orig.new_full((1, t_cols), inf)])
    originals = (
        s_orig,               # (y, x)     original
        col_at(s_orig, 1),    # (y, x+1)   original
        col_at(below, 1),     # (y+1, x-1) original
        col_at(below, 2),     # (y+1, x)   original
        col_at(below, 3),     # (y+1, x+1) original
    )
    c1 = c2 = c3 = disp.new_full((h,), inf)  # filtered columns t-1..t-3
    cols = []
    for t in range(t_cols):
        nine = torch.stack([
            c1,         # (y, x-1)   filtered
            down(c1),   # (y-1, x+1) filtered
            down(c2),   # (y-1, x)   filtered
            down(c3),   # (y-1, x-1) filtered
            *(o[:, t] for o in originals),
        ])
        srt = torch.sort(nine, dim=0).values
        med = torch.gather(srt, 0, s_idx[None, :, t])[0]
        col = torch.where(s_act[:, t], med, inf)
        c1, c2, c3 = col, c1, c2
        cols.append(col)
    return _unshear(torch.stack(cols, dim=1), w, inf)


def median_inplace(disp: torch.Tensor) -> torch.Tensor:
    """The in-place 3x3 median of an (H, W) float32 map, +inf = invalid,
    as a new tensor; ``disp`` is left as it is. Maps with -0.0 and +0.0
    in one window may differ in the sign of a median zero between the
    kernel and the plain version (neither ``torch.sort`` nor the kernel's
    min/max network orders the two)."""
    if disp.ndim != 2:
        raise ValueError(f"disp must be (H, W), got {tuple(disp.shape)}")
    h, w = disp.shape
    _build.check("disp", disp, torch.float32, (h, w), disp.device)
    if not kernels_for(disp):
        return median_inplace_plain(disp)
    if h * w >= 2 ** 31:
        raise ValueError(f"median_inplace indexes the map in 32 bits: "
                         f"H*W = {h * w} is too large")
    out = torch.empty_like(disp)
    if h * w:
        _build.launch(
            "median_inplace", disp.data_ptr(), out.data_ptr(), h, w,
            torch.cuda.current_stream(disp.device).cuda_stream,
        )
    return out
