"""Plain PyTorch AD-Census: the benchmark's reference for ``correct``.

A frozen copy of the plain versions of the engine's stages (cost, arms,
aggregation, scanline, WTA, LR check, region voting, 16-ray
interpolation and the out-of-place 3x3 median), after Mei et al., "On
building an accurate stereo matching system on graphics hardware"
(ICCV-W 2011), in the reference C++ implementation's order of float32
operations. It imports nothing of the engine under test: it computes its
own gray images and census signatures from the RGB pair it is given.

``vol_dtype`` is the type of the cost volume through aggregation,
scanline optimisation and winner-take-all: float32 as the configuration
states, or a lower precision (bfloat16) for the benchmark's control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

INVALID_FLOAT = float(np.float32(np.inf))
LARGE_FLOAT = float(np.float32(99999.0))
MAX_ARM_LENGTH = 255
FLAG_PAD, FLAG_SEED, FLAG_NORMAL = 0, 1, 2

_CENSUS_OFFSETS = [(r, c) for r in range(-4, 5) for c in range(-3, 4)]
_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def f32(x) -> float:
    return float(np.float32(x))


def lround(x: torch.Tensor) -> torch.Tensor:
    """C lround: round half away from zero, as int32."""
    return torch.where(
        x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)
    ).to(torch.int32)


def color_dist(a, b):
    return (a.to(torch.int32) - b.to(torch.int32)).abs().amax(dim=-1)


def color_absdiff_sum(a, b):
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return d.sum(dim=-1, dtype=torch.int32)


def shift2d(img, dy: int, dx: int, fill):
    """out[y, x] = img[y - dy, x - dx], ``fill`` in the vacated cells."""
    h, w = img.shape[0], img.shape[1]
    out = torch.full_like(img, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)] = img[
        max(-dy, 0): h - max(dy, 0), max(-dx, 0): w - max(dx, 0)
    ]
    return out


def shift_last(x, s: int, fill):
    n = x.shape[-1]
    out = torch.full_like(x, fill)
    if abs(s) >= n:
        return out
    out[..., max(s, 0): n + min(s, 0)] = x[..., max(-s, 0): n - max(s, 0)]
    return out


# --- cost -----------------------------------------------------------------

def gray(img):
    """r*0.299 + g*0.587 + b*0.114 in float32, truncated to uint8."""
    f = img.to(torch.float32)
    v = f[..., 0] * f32(0.299) + f[..., 1] * f32(0.587) + f[..., 2] * f32(0.114)
    return torch.floor(v).to(torch.uint8)


def census_9x7(g):
    """63-bit census signature a pixel, (H, W) int64; zero on the border."""
    h, w = g.shape
    sig = torch.zeros((h, w), dtype=torch.int64, device=g.device)
    if not (w > 9 and h > 7):
        return sig
    for k, (r, c) in enumerate(_CENSUS_OFFSETS):
        neigh = shift2d(g, -r, -c, 0)
        sig |= (neigh < g).to(torch.int64) << (62 - k)
    y = torch.arange(h, device=g.device)
    x = torch.arange(w, device=g.device)
    valid = ((y >= 4) & (y < h - 4))[:, None] & ((x >= 3) & (x < w - 3))[None]
    return torch.where(valid, sig, 0)


def popcount63(x):
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def cost_volume(left, right, census_l, census_r, opts):
    """(D, H, W) float32 AD-Census cost; out-of-image columns cost 1.0."""
    h, w, _ = left.shape
    dev = left.device
    d_abs = torch.arange(opts["disp_range"], device=dev) + opts["min_disparity"]
    xr = torch.arange(w, device=dev)[None, :] - d_abs[:, None]
    oob = (xr < 0) | (xr >= w)
    xc = xr.clamp(0, w - 1)
    r_shift = right[:, xc].permute(1, 0, 2, 3).to(torch.int32)
    ad = (left.to(torch.int32)[None] - r_shift).abs().sum(
        dim=-1, dtype=torch.int32
    ).to(torch.float32) / 3.0
    del r_shift
    cen = popcount63(census_l[None] ^ census_r[:, xc].permute(1, 0, 2)).to(
        torch.float32
    )
    cost = (1.0 - torch.exp(-ad / float(opts["lambda_ad"])) + 1.0
            - torch.exp(-cen / float(opts["lambda_census"])))
    return torch.where(oob[:, None, :], 1.0, cost).contiguous()


# --- arms and aggregation -------------------------------------------------

def _arm_length(img, dy: int, dx: int, opts):
    h, w, _ = img.shape
    s = min(opts["cross_L1"], MAX_ARM_LENGTH)
    dev = img.device
    if s == 0:
        return torch.zeros((h, w), dtype=torch.int32, device=dev)
    padded = torch.zeros((h + 2 * s, w + 2 * s, 3), dtype=torch.int32,
                         device=dev)
    padded[s: s + h, s: s + w] = img.to(torch.int32)
    stack = torch.stack([
        padded[s + dy * k: s + dy * k + h, s + dx * k: s + dx * k + w]
        for k in range(s + 1)
    ])
    off = torch.arange(1, s + 1, device=dev)[:, None, None]
    ny = torch.arange(h, device=dev)[None, :, None] + dy * off
    nx = torch.arange(w, device=dev)[None, None, :] + dx * off
    in_bounds = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    cand = stack[1:]
    dist1 = color_dist(cand, stack[:1])
    ok = (in_bounds & (dist1 < opts["cross_t1"])
          & (color_dist(cand, stack[:-1]) < opts["cross_t1"])
          & ((off <= opts["cross_L2"]) | (dist1 < opts["cross_t2"])))
    return torch.cumprod(ok.to(torch.int32), dim=0).sum(dim=0,
                                                       dtype=torch.int32)


def build_arms(left, opts):
    """(H, W, 4) int32 arms: left, right, top, bottom."""
    return torch.stack([_arm_length(left, 0, -1, opts),
                        _arm_length(left, 0, 1, opts),
                        _arm_length(left, -1, 0, opts),
                        _arm_length(left, 1, 0, opts)], dim=-1)


def _arm_sum(vals, lo, hi, axis: int, max_arm: int):
    n = vals.shape[axis]
    csum = torch.cumsum(vals, dim=axis, dtype=torch.int64)
    zero = torch.zeros_like(csum.narrow(axis, 0, 1))
    prefix = torch.cat([zero, csum], dim=axis)
    idx = torch.arange(n, device=vals.device)
    idx = idx[:, None] if axis == 0 else idx[None, :]
    end = (idx + hi.clamp(max=max_arm) + 1).clamp(0, n)
    start = (idx - lo.clamp(max=max_arm)).clamp(0, n)
    return (torch.gather(prefix, axis, end)
            - torch.gather(prefix, axis, start)).to(torch.int32)


def support_counts(arms, max_arm: int):
    al, ar, at, ab = (arms[..., k].long() for k in range(4))
    h_extent = (al + ar + 1).to(torch.int32)
    v_extent = (at + ab + 1).to(torch.int32)
    return (_arm_sum(h_extent, at, ab, 0, max_arm),
            _arm_sum(v_extent, al, ar, 1, max_arm))


def _masked_roll_sum(p, lo_arm, hi_arm, axis: int, max_arm: int):
    """sum_{t=-lo..hi} p[i + t] along ``axis``, in ascending t from 0."""
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    acc = torch.zeros_like(p)
    for t in range(-max_arm, max_arm + 1):
        if t == 0:
            acc = acc + p
            continue
        rolled = torch.roll(p, -t, dims=axis)
        cond = lo_arm >= -t if t < 0 else hi_arm >= t
        acc = acc + torch.where(cond, rolled, zero)
    return acc


def cross_pass(vol, arms, sup, horizontal_first: bool, max_arm: int,
               normalize: bool = True):
    al, ar, at, ab = (arms[..., k].to(torch.int32) for k in range(4))
    if horizontal_first:
        res = _masked_roll_sum(_masked_roll_sum(vol, al, ar, 2, max_arm),
                               at, ab, 1, max_arm)
    else:
        res = _masked_roll_sum(_masked_roll_sum(vol, at, ab, 1, max_arm),
                               al, ar, 2, max_arm)
    if normalize:
        res = res / sup.to(vol.dtype)
    return res


def aggregate(cost, arms, opts, num_iters: int = 4):
    max_arm = min(opts["cross_L1"], MAX_ARM_LENGTH)
    sup_h, sup_v = (s.to(torch.float32) for s in support_counts(arms, max_arm))
    horizontal_first = True
    for _ in range(num_iters):
        cost = cross_pass(cost, arms, sup_h if horizontal_first else sup_v,
                          horizontal_first, max_arm)
        horizontal_first = not horizontal_first
    return cost


# --- scanline optimisation ------------------------------------------------

def _penalty_code(left, right, opts, axis: str, forward: bool):
    h, w, _ = left.shape
    direction = 1 if forward else -1
    dy, dx = (0, direction) if axis == "x" else (direction, 0)
    d1 = color_dist(left, shift2d(left, dy, dx, 0))
    rd = color_dist(right, shift2d(right, dy, dx, 0))
    dev = rd.device
    rd_col1 = rd[:, 1:2] if w > 1 else rd
    x = torch.arange(w, device=dev)[None, :]
    d_abs = (torch.arange(opts["disp_range"], device=dev)[:, None]
             + opts["min_disparity"])
    xr = x - d_abs
    use_d1 = (xr >= w - 1) | ((x - opts["min_disparity"]) <= 0)
    shifted = rd[:, xr.clamp(0, w - 1)].permute(1, 0, 2)
    sticky = torch.where((xr < 1)[:, None, :], rd_col1[None], shifted)
    d2 = torch.where(use_d1[:, None, :], d1[None], sticky)
    tso = opts["so_tso"]
    return ((d1[None] >= tso).to(torch.uint8)
            + (d2 >= tso).to(torch.uint8)).contiguous()


def _penalty_table(p1: float, p2: float):
    f = np.float32
    return ((f(p1), f(f(p1) / f(4)), f(f(p1) / f(10))),
            (f(p2), f(f(p2) / f(4)), f(f(p2) / f(10))))


def _scan(cost_s, P1_s, P2_s, n_steps: int):
    """The DP over (S, P, D) tensors in scan order: the first step copies
    its costs, every later one takes
    Lr = (C + min(Lr', Lr'(d-1)+P1, Lr'(d+1)+P1, min Lr' + P2)) / 2."""
    p, d = cost_s.shape[1:]
    dt, dev = cost_s.dtype, cost_s.device
    half = torch.tensor(0.5, dtype=dt, device=dev)
    outs = []
    lr_prev = min_prev = None
    for k in range(n_steps):
        c = cost_s[k]
        if k == 0:
            lr = c
        else:
            l2 = shift_last(lr_prev, 1, LARGE_FLOAT) + P1_s[k]
            l3 = shift_last(lr_prev, -1, LARGE_FLOAT) + P1_s[k]
            l4 = min_prev[:, None] + P2_s[k]
            m = torch.minimum(torch.minimum(lr_prev, l2),
                              torch.minimum(l3, l4))
            lr = (c + m) * half
        lr_prev = lr
        min_prev = lr.amin(dim=-1)
        outs.append(lr)
    return torch.stack(outs)


def scanline_pass(cost, left, right, opts, axis: str, forward: bool):
    code = _penalty_code(left, right, opts, axis, forward)
    t1, t2 = _penalty_table(opts["so_p1"], opts["so_p2"])
    idx = code.long()
    P1 = torch.tensor(t1, device=cost.device).to(cost.dtype)[idx]
    P2 = torch.tensor(t2, device=cost.device).to(cost.dtype)[idx]
    del code, idx
    perm = (2, 1, 0) if axis == "x" else (1, 2, 0)
    vols = [v.permute(perm) for v in (cost, P1, P2)]
    if not forward:
        vols = [v.flip(0) for v in vols]
    out = _scan(*vols, vols[0].shape[0])
    if not forward:
        out = out.flip(0)
    if axis == "x":
        return out.permute(2, 1, 0).contiguous()
    return out.permute(2, 0, 1).contiguous()


def scanline_optimize(cost, left, right, opts):
    for axis, fwd in (("x", True), ("x", False), ("y", True), ("y", False)):
        cost = scanline_pass(cost, left, right, opts, axis, fwd)
    return cost


# --- winner-take-all ------------------------------------------------------

def _parabola(best, c_min, c1, c2, opts):
    denom = c1 + c2 - 2.0 * c_min
    best_d = (best + opts["min_disparity"]).to(c_min.dtype)
    return torch.where(denom != 0.0, best_d + (c1 - c2) / (denom * 2.0),
                       best_d)


def wta_left(cost, opts):
    d_range = cost.shape[0]
    best = cost.argmin(dim=0)

    def at(idx):
        return torch.gather(cost, 0, idx.clamp(0, d_range - 1)[None])[0]

    disp = _parabola(best, at(best), at(best - 1), at(best + 1), opts)
    border = (best == 0) | (best == d_range - 1)
    return torch.where(border, INVALID_FLOAT, disp.to(torch.float32))


def wta_right(cost, opts):
    d_range, h, w = cost.shape
    dev = cost.device
    best = torch.zeros((h, w), dtype=torch.long, device=dev)
    c_min = torch.full((h, w), LARGE_FLOAT, dtype=cost.dtype, device=dev)
    for di in range(d_range):
        c = shift2d(cost[di], 0, -(di + opts["min_disparity"]), LARGE_FLOAT)
        is_new = c < c_min
        best = torch.where(is_new, di, best)
        c_min = torch.where(is_new, c, c_min)
    y = torch.arange(h, device=dev)[:, None]
    x = torch.arange(w, device=dev)[None, :]
    flat = cost.reshape(-1)

    def at(idx):
        idx = idx.clamp(0, d_range - 1)
        col = x + idx + opts["min_disparity"]
        inside = (col >= 0) & (col < w)
        v = flat[(idx * h + y) * w + col.clamp(0, w - 1)]
        return torch.where(inside, v, LARGE_FLOAT)

    disp = _parabola(best, c_min, at(best - 1), at(best + 1), opts)
    border = (best == 0) | (best == d_range - 1)
    return torch.where(border, (best + opts["min_disparity"]).to(torch.float32),
                       disp.to(torch.float32))


# --- refinement -----------------------------------------------------------

def _gather_cols(fields, col, ok, defaults):
    w = col.shape[1]
    idx = col.long().clamp(0, w - 1)
    return [torch.where(ok, torch.gather(f, 1, idx), dflt)
            for f, dflt in zip(fields, defaults)]


def outlier_detection(disp_left, disp_right, opts):
    """LR check: (disparity with outliers invalid, occlusion, mismatch)."""
    h, w = disp_left.shape
    x = torch.arange(w, device=disp_left.device)[None, :]
    orig_valid = torch.isfinite(disp_left)
    d = disp_left
    col_right = lround(x - torch.where(orig_valid, d, 0.0))
    cr_in = (col_right >= 0) & (col_right < w)
    offs = x - col_right
    (d_r,) = _gather_cols(
        (disp_right,), col_right,
        cr_in & (offs >= opts["min_disparity"] - 1)
        & (offs <= opts["max_disparity"] + 1),
        (INVALID_FLOAT,))
    lr_fail = orig_valid & cr_in & ((d - d_r).abs() > f32(opts["lrcheck_thres"]))
    outlier = (~orig_valid) | (~cr_in) | lr_fail
    new_disp = torch.where(outlier, INVALID_FLOAT, d)
    col_rl = lround(torch.where(torch.isfinite(d_r), col_right + d_r, 0.0))
    rl_in = (col_rl > 0) & (col_rl < w)
    span = opts["max_disparity"] - opts["min_disparity"] + 2
    offs = x - col_rl
    d_l_orig, rl_outlier, rl_valid = _gather_cols(
        (d, outlier, orig_valid), col_rl,
        (col_rl >= 0) & (col_rl < w) & (offs >= -span) & (offs <= span),
        (INVALID_FLOAT, False, False))
    seen_invalid = (rl_outlier & (col_rl < x)) | ~rl_valid
    d_l_eff = torch.where(seen_invalid, INVALID_FLOAT, d_l_orig)
    occlusion = lr_fail & rl_in & (d_l_eff > d)
    return new_disp, occlusion, outlier & ~occlusion


def _region_vote_stats(di, valid, arms, d_range: int, max_arm: int, target):
    planes = torch.arange(d_range, device=di.device)[:, None, None]
    onehot = ((di[None] == planes) & valid[None]).to(torch.float32)
    hist = cross_pass(onehot, arms, torch.ones(di.shape, device=di.device),
                      True, max_arm, normalize=False).to(torch.int32)
    del onehot
    zero = torch.zeros((), dtype=torch.int32, device=di.device)
    return tuple(torch.where(target, s, zero) for s in (
        hist.argmax(dim=0).to(torch.int32), hist.amax(dim=0),
        hist.sum(dim=0, dtype=torch.int32)))


def iterative_region_voting(disp, arms, occlusion, mismatch, opts,
                            num_iters: int = 5):
    max_arm = min(opts["cross_L1"], MAX_ARM_LENGTH)
    d_range = opts["disp_range"]
    for _ in range(num_iters):
        for phase_mask in (mismatch, occlusion):
            target = phase_mask & ~torch.isfinite(disp)
            valid = torch.isfinite(disp)
            di = (lround(torch.where(valid, disp, 0.0))
                  - opts["min_disparity"]).clamp(0, d_range - 1).to(torch.int32)
            best, max_ht, count = _region_vote_stats(di, valid, arms, d_range,
                                                     max_arm, target)
            ratio_ok = (max_ht.to(torch.float32) / count.to(torch.float32)
                        ) > f32(opts["irv_th"])
            fill = (target & (max_ht > 0) & (count > opts["irv_ts"])
                    & ratio_ok)
            disp = torch.where(
                fill, (best + opts["min_disparity"]).to(torch.float32), disp)
    return disp


def ray_offset_table(max_search: int) -> np.ndarray:
    """(16, max_search - 1, 2) (dy, dx) offsets of the 16 rays over [0, pi),
    double-precision trig and lround."""
    steps = max(max_search - 1, 1)
    table = np.zeros((16, steps, 2), dtype=np.int32)
    ang = 0.0
    for s in range(16):
        sina, cosa = math.sin(ang), math.cos(ang)
        for m in range(1, max_search):
            a, b = m * sina, m * cosa
            yy = math.floor(a + 0.5) if a >= 0 else math.ceil(a - 0.5)
            xx = math.floor(b + 0.5) if b >= 0 else math.ceil(b - 0.5)
            table[s, m - 1] = (int(yy), int(xx))
        ang += 3.1415926 / 16
    return table


def _interp_fills(disp, left, offsets, target, is_mismatch: bool):
    """Fill of each target pixel from the first valid disparity along each
    of 16 rays: the hit of the closest color (mismatch) or the least hit
    (occlusion); 0.0 where no ray hits."""
    h, w = disp.shape
    n_rays, n_steps, _ = offsets.shape
    dev = disp.device
    pad = n_steps + 1
    disp_pad = torch.full((h + 2 * pad, w + 2 * pad), float("nan"), device=dev)
    disp_pad[pad: pad + h, pad: pad + w] = disp
    left_pad = torch.zeros((h + 2 * pad, w + 2 * pad, 3), dtype=torch.int32,
                           device=dev)
    left_pad[pad: pad + h, pad: pad + w] = left.to(torch.int32)
    center = left_pad[pad: pad + h, pad: pad + w]
    rows = torch.arange(h, device=dev)[None, :, None] + pad
    cols = torch.arange(w, device=dev)[None, None, :] + pad
    offs = offsets.to(device=dev, dtype=torch.long)
    done = (~target)[None].expand(n_rays, h, w).clone()
    hit = torch.zeros((n_rays, h, w), dtype=torch.bool, device=dev)
    val = torch.zeros((n_rays, h, w), device=dev)
    dist = torch.zeros((n_rays, h, w), dtype=torch.int32, device=dev)
    for i in range(n_steps):
        if bool(done.all()):
            break
        ri = rows + offs[:, i, 0][:, None, None]
        ci = cols + offs[:, i, 1][:, None, None]
        cand = disp_pad[ri, ci]
        cand_valid = torch.isfinite(cand)
        take = cand_valid & ~done
        val = torch.where(take, cand, val)
        if is_mismatch:
            dist = torch.where(take, color_absdiff_sum(left_pad[ri, ci],
                                                       center[None]), dist)
        done = done | cand_valid | torch.isnan(cand)
        hit = hit | take
    if is_mismatch:
        ray = torch.where(hit, dist, 10 ** 9).argmin(dim=0)
        fill = torch.gather(val, 0, ray[None])[0]
    else:
        fill = torch.where(hit, val, LARGE_FLOAT).amin(dim=0)
    found = hit.any(dim=0)
    return torch.where(target & found, fill, 0.0)


def proper_interpolation(disp, left, occlusion, mismatch, opts):
    max_search = max(abs(opts["max_disparity"]), abs(opts["min_disparity"]))
    offsets = torch.as_tensor(ray_offset_table(max_search), device=disp.device)
    mism_target = mismatch & ~torch.isfinite(disp)
    disp = torch.where(mism_target,
                       _interp_fills(disp, left, offsets, mism_target, True),
                       disp)
    occl_target = occlusion & ~torch.isfinite(disp)
    return torch.where(occl_target,
                       _interp_fills(disp, left, offsets, occl_target, False),
                       disp)


def median_3x3(disp):
    """Out-of-place 3x3 median, windows clipped at the border."""
    h, w = disp.shape
    dev = disp.device
    rows = 1 + (torch.arange(h, device=dev) > 0).long() + (
        torch.arange(h, device=dev) < h - 1).long()
    cols = 1 + (torch.arange(w, device=dev) > 0).long() + (
        torch.arange(w, device=dev) < w - 1).long()
    counts = rows[:, None] * cols[None, :]
    stack = torch.stack([shift2d(disp, -dy, -dx, float("inf"))
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    s = torch.sort(stack, dim=0).values
    return torch.gather(s, 0, (counts.clamp(min=1) // 2)[None])[0]


# --- the whole match ------------------------------------------------------

def check_options(opts: dict) -> dict:
    """The options with ``disp_range``; raises for the paths this
    reference does not hold (discontinuity adjustment, in-place median)."""
    if opts.get("do_discontinuity_adjustment") or opts.get("exact_median"):
        raise ValueError("the reference holds neither discontinuity "
                         "adjustment nor the in-place median")
    out = dict(opts)
    out["disp_range"] = opts["max_disparity"] - opts["min_disparity"]
    return out


@torch.no_grad()
def match(left: np.ndarray, right: np.ndarray, opts: dict, device="cpu",
          vol_dtype=torch.float32) -> np.ndarray:
    """(H, W, 3) uint8 RGB pair -> (H, W) float32 disparity, +inf where
    invalid, computed on ``device``."""
    o = check_options(opts)
    lt = torch.as_tensor(np.ascontiguousarray(left), device=device)
    rt = torch.as_tensor(np.ascontiguousarray(right), device=device)
    cost = cost_volume(lt, rt, census_9x7(gray(lt)), census_9x7(gray(rt)), o)
    cost = cost.to(vol_dtype)
    arms = build_arms(lt, o)
    cost = aggregate(cost, arms, o)
    cost = scanline_optimize(cost, lt, rt, o)
    disp_l, disp_r = wta_left(cost, o), wta_right(cost, o)
    del cost
    disp, occl, mism = disp_l, None, None
    if o["do_lr_check"]:
        disp, occl, mism = outlier_detection(disp_l, disp_r, o)
    else:
        occl = mism = torch.zeros_like(disp, dtype=torch.bool)
    if o["do_filling"]:
        disp = iterative_region_voting(disp, arms, occl, mism, o)
        disp = proper_interpolation(disp, lt, occl, mism, o)
    return median_3x3(disp).cpu().numpy()
