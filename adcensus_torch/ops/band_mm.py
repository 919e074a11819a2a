"""Kernel B5: the blocked-band window sum of the "banded" aggregation.

Port of ``adcensus_tpu/ops/band_mm_pallas.py``. The dense band matrices of
``ops/cross_matmul.py`` are ~90 % zeros. Here the mask entry of output
column o and window slot ii depends only on o % 256: the window of the
256-column output block ``ob`` is the input slice
[ob*256 - PAD, ob*256 - PAD + WK) with WK = 256 + 2*PAD, so

    out[d, n, o] = sum_ii mask[n, ii, o] * vol[d, n, ob*256 + ii]

with an (N, WK, M) int8 mask, on a volume whose contraction axis carries
PAD-wide margins. The float32 volume is split into bfloat16 hi and lo
parts, as in the dense backend. The vertical pass runs the same kernel on
the (D, W, H)-transposed volume.

``band_pass`` launches ``csrc/band_mm.cu`` for a CUDA tensor and runs
``band_pass_plain`` for a CPU tensor; the two agree bitwise, for any
mask. The kernel takes PAD a multiple of 16 up to 256 (WK up to
``MAX_WK``); the wrapper raises for another on the card. The padding
geometry (H and W to multiples of 128, D to 8, PAD, margins) is JAX's, so
the masks are bitwise JAX's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import kernels_for


def _pad_for(max_arm: int) -> int:
    """Window margin: a multiple of 64 covering any |offset| <= max_arm."""
    return max(-(-max_arm // 64) * 64, 64)


class BlockedMasks(NamedTuple):
    """Blocked int8 band masks for both directions, at padded dims."""

    mh: torch.Tensor  # (Hp, WKw, Wp) int8, K-major
    mv: torch.Tensor  # (Wp, WKh, Hp) int8, K-major
    pad_w: int
    pad_h: int
    hp: int
    wp: int


_NB = 256  # output-block width: the columns that share one window
MAX_WK = 768  # the widest window csrc/band_mm.cu takes (PAD 256)


def _blocked_mask(
    lo: torch.Tensor, hi: torch.Tensor, pad: int, nb: int = _NB
) -> torch.Tensor:
    """(N, WK, M) int8 mask from per-pixel window extents.

    lo/hi: (N, M) int32, window [o - lo[n,o], o + hi[n,o]] along the M
    axis; entries < 0 give an all-zero column (used for padding).
    mask[n, ii, o] = 1 iff -lo <= ii - pad - o%nb <= hi.
    """
    m = lo.shape[1]
    wk = nb + 2 * pad
    dev = lo.device
    rel = (
        torch.arange(wk, dtype=torch.int32, device=dev)[:, None]
        - pad
        - (torch.arange(m, dtype=torch.int32, device=dev) % nb)[None, :]
    )  # (WK, M)
    ok = (rel[None] >= -lo[:, None, :]) & (rel[None] <= hi[:, None, :])
    return ok.to(torch.int8).contiguous()


def make_blocked_masks(
    arms: torch.Tensor, max_arm: int, hp: int, wp: int
) -> BlockedMasks:
    """Blocked masks from (H, W, 4) arms, padded to (hp, wp) with
    all-zero rows and columns (padded pixels give and get nothing)."""
    a = arms.to(torch.int32).clamp(max=max_arm)
    h, w = a.shape[:2]

    def put(x):
        out = torch.full((hp, wp), -1, dtype=torch.int32, device=a.device)
        out[:h, :w] = x
        return out

    pad_w = _pad_for(max_arm)
    pad_h = _pad_for(max_arm)
    mh = _blocked_mask(put(a[..., 0]), put(a[..., 1]), pad_w, _NB)
    mv = _blocked_mask(put(a[..., 2]).T, put(a[..., 3]).T, pad_h, _NB)
    return BlockedMasks(mh, mv, pad_w, pad_h, hp, wp)


# The routing rule is the TPU's: blocks that fit its 11 MB VMEM budget
# (band_mm_pallas.py:_VMEM_BUDGET), kept so that both packages send the
# same shapes to B5. A rule of the card's own is later work.
_VMEM_BUDGET = 11e6


def _mp_ceil(mp: int) -> int:
    return -(-mp // _NB) * _NB


def _margins(mp: int, pad: int) -> Tuple[int, int]:
    """(left, right) contraction-axis margins so that every output
    block's WK-wide window stays in bounds (the tail block reads
    zeros)."""
    return pad, pad + (_mp_ceil(mp) - mp)


def _pick_blocks(dp: int, mp: int, pad: int):
    """The TPU kernel's (db, yb) blocks that fit the VMEM budget, or
    None."""
    wk = _NB + 2 * pad
    mpad = _mp_ceil(mp) + 2 * pad
    for yb in (8, 4):
        for db in (64, 32, 16, 8):
            if dp % db:
                continue
            ybs = max(yb, 8)
            bytes_ = (
                yb * mp * wk  # mask int8
                + db * ybs * mpad * 4
                + db * ybs * mp * 4
            ) * 2
            if bytes_ <= _VMEM_BUDGET:
                return db, yb
    return None


def padded_dims(d: int, h: int, w: int) -> Tuple[int, int, int]:
    """(Dp, Hp, Wp): D to a multiple of 8, H and W to multiples of 128
    (each spatial axis is the blocked output axis of one direction)."""
    return -(-d // 8) * 8, -(-h // 128) * 128, -(-w // 128) * 128


def banded_fits(d: int, h: int, w: int, max_arm: int) -> bool:
    """Whether the blocked-band aggregation takes this shape."""
    dp, hp, wp = padded_dims(d, h, w)
    pad = _pad_for(max_arm)
    return (
        _pick_blocks(dp, wp, pad) is not None
        and _pick_blocks(dp, hp, pad) is not None
    )


def with_margins(vol: torch.Tensor, mp: int, pad: int) -> torch.Tensor:
    """(Dp, Np, Mp) volume -> (Dp, Np, mp_ceil + 2*pad), the input of
    one pass, with zero margins on the contraction axis."""
    lm, rm = _margins(mp, pad)
    return F.pad(vol, (lm, rm))


def band_pass_plain(
    vol_m: torch.Tensor, mask: torch.Tensor, pad: int
) -> torch.Tensor:
    """Plain version of kernel B5. For each output: the sum over
    ascending ii of the hi parts its mask selects, from 0.0; the same
    for the lo parts; then hi sum + lo sum. Mask entries are 0/1, so a
    selected term adds the part itself and an unselected one adds 0.0
    (the sums start at +0.0 and so never become -0.0, and adding +0.0 is
    then exact)."""
    dp, np_, _ = vol_m.shape
    wk, mp = mask.shape[1], mask.shape[2]
    hi = vol_m.to(torch.bfloat16).to(torch.float32)
    lo = (vol_m - hi).to(torch.bfloat16).to(torch.float32)
    base = (torch.arange(mp, device=vol_m.device) // _NB) * _NB
    sel = mask != 0
    zero = torch.zeros((), dtype=torch.float32, device=vol_m.device)
    acc_hi = torch.zeros((dp, np_, mp), dtype=torch.float32,
                         device=vol_m.device)
    acc_lo = torch.zeros_like(acc_hi)
    for ii in range(wk):
        cols = base + ii
        m = sel[:, ii, :]  # (Np, Mp)
        acc_hi += torch.where(m, hi.index_select(2, cols), zero)
        acc_lo += torch.where(m, lo.index_select(2, cols), zero)
    return acc_hi + acc_lo


def band_pass(vol_m: torch.Tensor, mask: torch.Tensor, pad: int) -> torch.Tensor:
    """One directional pass: (Dp, Np, mp_ceil + 2*pad) float32 volume with
    margins (see :func:`with_margins`) and (Np, 256 + 2*pad, Mp) int8 mask
    -> (Dp, Np, Mp) float32."""
    if mask.dim() != 3 or vol_m.dim() != 3:
        raise ValueError("band_pass takes a 3-D volume and a 3-D mask")
    dp, np_, length = vol_m.shape
    mp = mask.shape[2]
    wk = _NB + 2 * pad
    for name, t, dtype, shape in (
        ("vol_m", vol_m, torch.float32, (dp, np_, _mp_ceil(mp) + 2 * pad)),
        ("mask", mask, torch.int8, (np_, wk, mp)),
    ):
        _build.check(name, t, dtype, shape, vol_m.device)
    if not kernels_for(vol_m):
        return band_pass_plain(vol_m, mask, pad)
    if pad % 16 or wk > MAX_WK:
        raise ValueError(
            f"band_pass on the card takes PAD a multiple of 16 with "
            f"256 + 2*PAD <= {MAX_WK}, got PAD {pad}"
        )
    # the kernel copies 16-byte grains: aligned inputs, and mask rows of
    # a multiple of 16 columns (zero columns select nothing)
    mp16 = -(-mp // 16) * 16
    if mp16 != mp:
        mask = F.pad(mask, (0, mp16 - mp))
    elif mask.data_ptr() % 16:
        mask = mask.clone()
    if vol_m.data_ptr() % 16:
        vol_m = vol_m.clone()
    out = torch.empty((dp, np_, mp16), dtype=torch.float32,
                      device=vol_m.device)
    _build.launch(
        "band_mm",
        mask.data_ptr(), vol_m.data_ptr(), out.data_ptr(),
        dp, np_, mp16, length, wk,
        torch.cuda.current_stream(vol_m.device).cuda_stream,
    )
    return out if mp16 == mp else out[..., :mp].contiguous()


def aggregate_banded(
    cost: torch.Tensor,
    arms: torch.Tensor,
    sup_h: torch.Tensor,
    sup_v: torch.Tensor,
    max_arm: int,
    num_iters: int = 4,
) -> torch.Tensor:
    """The aggregation stage (cross_aggregator.cpp:89-118: ``num_iters``
    iterations alternating horizontal-first and vertical-first, each
    divided by its support count) on kernel B5.

    Pads once to (Dp, Hp, Wp) and runs every pass in padded space: padded
    pixels have all-zero mask rows, so they stay 0. The volume stays in
    whichever (D, H, W) / (D, W, H) orientation the next pass needs, so
    it is transposed only at 4 of the 8 pass boundaries.
    """
    d, h, w = cost.shape
    dp, hp, wp = padded_dims(d, h, w)
    masks = make_blocked_masks(arms, max_arm, hp, wp)
    sup_h_p = torch.ones((hp, wp), dtype=torch.float32, device=cost.device)
    sup_h_p[:h, :w] = sup_h.to(torch.float32)
    sup_v_p = torch.ones_like(sup_h_p)
    sup_v_p[:h, :w] = sup_v.to(torch.float32)

    vol = F.pad(cost, (0, wp - w, 0, hp - h, 0, dp - d))
    in_hw = True  # current orientation: True = (Dp, Hp, Wp)
    horizontal_first = True
    for _ in range(num_iters):
        for direction in ("h", "v") if horizontal_first else ("v", "h"):
            want_hw = direction == "h"
            if in_hw != want_hw:
                vol = vol.transpose(1, 2).contiguous()
                in_hw = want_hw
            if want_hw:
                vm = with_margins(vol, wp, masks.pad_w)
                vol = band_pass(vm, masks.mh, masks.pad_w)
            else:
                vm = with_margins(vol, hp, masks.pad_h)
                vol = band_pass(vm, masks.mv, masks.pad_h)
        sup = sup_h_p if horizontal_first else sup_v_p
        vol = vol / (sup if in_hw else sup.T)
        horizontal_first = not horizontal_first
    if not in_hw:
        vol = vol.transpose(1, 2)
    return vol[:d, :h, :w].contiguous()
