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

``median_inplace_geometry`` and ``median_inplace_schedule`` give the
kernel's launch geometry and its walk over the wavefronts (one block, a
thread a row, rows striding by the block's threads in bands); the CPU
tests emulate the kernel from them lane by lane.
"""
from __future__ import annotations

import torch

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for

# csrc/median_inplace.cu's constants (the kernel's k-prefixed names)
WARP = 32
MAX_THREADS = 1024  # one block
MAX_HEIGHT = 2 ** 22  # banded virtual columns stay below 2^24 (float-exact)
IN_RING = 32  # columns of originals a stream keeps in shared memory
CHUNK = 16  # columns a refill brings; streams refilled each step: 2
LEAD = 16  # a refill's first column, ahead of its stream's own column
LAG = 12  # steps between a refill's issue and its first read
OUT_RING = 16  # filtered columns a row keeps before they are stored
HANDOFF = 4  # steps of the warp-boundary ring, indexed t mod 4
WRAP = 32  # slots of the band-boundary queue
MARGIN = 2  # steps before a row's first pixel that belong to its band
FIRST_STEP = -(LEAD + CHUNK)  # the refills' head start
TAIL = CHUNK  # steps after the last pixel that store the last chunk


def median_inplace_geometry(h: int, w: int, max_threads: int = MAX_THREADS):
    """Launch geometry of kernel M1 for an (H, W) map: (threads, rows a
    thread, dynamic shared bytes). One block: a thread a row up to
    ``max_threads`` rows (the CPU emulation passes fewer than the
    kernel's MAX_THREADS); a taller map in bands of about W / 2 + 64
    rows (the rows a band has at work at once), at most ``max_threads``;
    thread i owns rows i, i + threads, ... Raises ValueError for what the
    kernel cannot index: an empty map, H * W of 2^31 or more, more than
    MAX_HEIGHT rows, or a walk of 2^31 steps or more (a single-row map
    within 64 pixels of 2^31)."""
    if h < 1 or w < 1:
        raise ValueError(f"median_inplace needs H, W >= 1, got {h}, {w}")
    if h * w >= 2 ** 31:
        raise ValueError(f"median_inplace indexes the map in 32 bits: "
                         f"H*W = {h * w} is too large")
    if h > MAX_HEIGHT:
        raise ValueError(f"median_inplace takes at most {MAX_HEIGHT} rows, "
                         f"got {h}")
    if h <= max_threads:
        threads = -(-h // WARP) * WARP
    else:
        threads = min((w // 2 + 2 * WARP) // WARP * WARP, max_threads)
    rows = -(-h // threads)
    if _last_step(h, w, threads) + TAIL + LEAD + CHUNK >= 2 ** 31:
        raise ValueError(f"median_inplace counts its steps in 32 bits: "
                         f"{h}x{w} is too wide")
    ring_floats = (WARP + 1) * (IN_RING + 1) + WARP * (OUT_RING + 1)
    smem = 4 * (threads // WARP * (ring_floats + HANDOFF) + WRAP)
    return threads, rows, smem


def _band_delay(w: int, threads: int, rows: int) -> int:
    """E: a thread's rows must not overlap (P - MARGIN >= W), and a band's
    first row reads the row above from the output LAG steps before its
    use, a step after the last band's thread stored it."""
    return max(w - 2 * threads + MARGIN, LAG) if rows > 1 else 0


def _last_step(h: int, w: int, threads: int) -> int:
    rows = -(-h // threads)
    period = 2 * threads + _band_delay(w, threads, rows)
    return w - 1 + 2 * ((h - 1) % threads) + (h - 1) // threads * period


def median_inplace_schedule(h: int, w: int, max_threads: int = MAX_THREADS):
    """Kernel M1's walk: (band delay E, band period P, last pixel step).

    Thread i is at virtual column v = t - 2i at step t: row
    k * threads + i at column x = v - k * P, P = 2 * threads + E, so that
    pixel (y, x) of band k runs at step x + 2y + k * E. Within a band a
    row runs two steps behind the row above (t = x + 2y); each further
    band starts E steps later than that: E >= W - 2 * threads + MARGIN
    so that a thread's rows do not overlap, and E >= LAG so that the
    band's first row reads the row above it from the output LAG steps
    ahead, after it was stored. One band (H <= threads): E = 0. The walk
    runs from FIRST_STEP to the last pixel's step plus TAIL."""
    threads, rows, _ = median_inplace_geometry(h, w, max_threads)
    delay = _band_delay(w, threads, rows)
    return delay, 2 * threads + delay, _last_step(h, w, threads)


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
    if not h * w:
        return torch.empty_like(disp)
    median_inplace_geometry(h, w)  # raises on what the kernel refuses
    out = torch.empty_like(disp)
    _build.launch(
        "median_inplace", disp.data_ptr(), out.data_ptr(), h, w,
        torch.cuda.current_stream(disp.device).cuda_stream,
    )
    return out
