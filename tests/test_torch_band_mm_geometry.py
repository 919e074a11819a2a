"""Kernel B5's traversal (csrc/band_mm.cu) on the CPU: a block-by-block
emulation of the kernel (each column's mask packed into 32-bit words,
each column's set bits walked low word to high and by lowest set bit, a
warp's lanes in step through a word, a lane without a bit left adding a
zero row; 8-plane groups whose window is split into one word a slot and
plane, hi's bfloat16 bits high and lo's low) equals band_pass_plain
bitwise on random masks that are not intervals, on make_blocked_masks'
interval masks, at PAD 64 to 256, on volumes of both signs with +0.0
and -0.0, with a half-full last plane group and a 128-wide tail block."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from adcensus_torch.ops import band_mm
from adcensus_torch.ops.band_mm import MAX_WK, _pad_for, band_pass_plain
from _band_cases import CASES, case_inputs

SOURCE = (Path(band_mm.__file__).resolve().parent.parent / "csrc"
          / "band_mm.cu").read_text()
NB, DG = 256, 8  # csrc/band_mm.cu: output block (threads) and plane group


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_emulation_constants_are_the_kernels():
    assert (_constant("NB"), _constant("DG")) == (NB, DG)
    assert _constant("kMaxWK") == MAX_WK == 256 + 2 * _pad_for(255)


def _u32_to_f32(x):
    """int64 holding an unsigned 32-bit pattern -> float32 of that
    pattern."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.float32)


def _bf16_bits(v):
    return v.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def pack_pairs(v):
    """The kernel's split word of each float32: bf16(v) in the high half,
    bf16(v - hi) in the low half."""
    hb = _bf16_bits(v)
    hi = _u32_to_f32(hb << 16)
    return (hb << 16) | _bf16_bits(v - hi)


def unpack_pairs(p):
    """(hi, lo) float32 of split words, as the kernel reads them back."""
    return (_u32_to_f32(p & 0xFFFF0000),
            _u32_to_f32((p << 16) & 0xFFFFFFFF))


def test_split_words_round_trip():
    """Packing and unpacking give band_pass_plain's hi and lo exactly:
    both signs, +-0.0, subnormals, huge values."""
    rng = np.random.default_rng(0)
    v = torch.as_tensor(np.concatenate([
        (rng.random(4000, np.float32) * 2 - 1)
        * np.float32(10.0) ** rng.integers(-40, 38, 4000).astype(np.float32),
        np.array([0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38], np.float32),
    ]).astype(np.float32))
    hi, lo = unpack_pairs(pack_pairs(v))
    ref_hi = v.to(torch.bfloat16).to(torch.float32)
    ref_lo = (v - ref_hi).to(torch.bfloat16).to(torch.float32)
    assert torch.equal(hi.view(torch.int32), ref_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), ref_lo.view(torch.int32))


def emulate_kernel(vol_m, mask, pad):
    """csrc/band_mm.cu, all blocks (row n, output block ob) at once, one
    column a lane. Returns (out, slots, trips): the output, NaN where no
    block writes; each column's slots found in one plane group; and each
    warp's trips in one plane group (a warp steps through a word while
    any of its lanes has a bit left there; a lane without one adds the
    zero row)."""
    dp, np_, length = vol_m.shape
    wk, mp = mask.shape[1], mask.shape[2]
    n_ob, nw = -(-mp // NB), wk // 32
    assert wk == NB + 2 * pad and wk % 32 == 0 and wk <= MAX_WK
    assert length == n_ob * NB + 2 * pad
    cols = n_ob * NB
    # column packing: bit r of word w is slot 32w + r; columns at or past
    # Mp stage zero bytes
    sel = torch.zeros((np_, wk, cols), dtype=torch.int64)
    sel[..., :mp] = (mask != 0).to(torch.int64)
    words = (sel.view(np_, nw, 32, cols)
             << torch.arange(32)[:, None]).sum(2)  # (Np, nw, cols)
    block = torch.arange(cols) // NB
    out = torch.full((dp, np_, mp), float("nan"))
    for d0 in range(0, dp, DG):
        # the group's window, planes past Dp zero-filled, split to words,
        # and the zero row after each block's WK rows
        win = torch.zeros((DG, np_, length))
        win[:dp - d0] = vol_m[d0:d0 + DG]
        pairs = torch.nn.functional.pad(
            pack_pairs(win.unfold(2, wk, NB)), (0, 1)
        ).reshape(DG, np_, n_ob * (wk + 1))
        acc_hi = torch.zeros((DG, np_, cols))
        acc_lo = torch.zeros_like(acc_hi)
        slots = torch.zeros((np_, cols), dtype=torch.int64)
        trips = torch.zeros((np_, cols // 32), dtype=torch.int64)
        for w in range(nw):
            bits = words[:, w].clone()
            while True:
                # while (__any_sync(~0u, bits != 0)): per warp of 32 lanes
                warp_on = (bits != 0).view(np_, -1, 32).any(-1)
                if not bool(warp_on.any()):
                    break
                trips += warp_on
                on = warp_on.repeat_interleave(32, dim=1)
                have = bits != 0
                low = bits & -bits
                b = torch.log2(low.clamp(min=1).double()).round().long()
                ii = torch.where(have, w * 32 + b, wk)
                bits = torch.where(have, bits & (bits - 1), bits)
                slots += have
                idx = (block[None, :] * (wk + 1) + ii)[None].expand(DG, -1,
                                                                    -1)
                hi, lo = unpack_pairs(pairs.gather(2, idx))
                acc_hi = torch.where(on, acc_hi + hi, acc_hi)
                acc_lo = torch.where(on, acc_lo + lo, acc_lo)
        n_d = min(DG, dp - d0)
        out[d0:d0 + n_d] = (acc_hi + acc_lo)[:n_d, :, :mp]
    return out, slots[:, :mp], trips


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_equals_plain(case):
    vol_m, mask, pad = (torch.as_tensor(a) if isinstance(a, np.ndarray)
                        else a for a in case_inputs(case))
    ours, slots, trips = emulate_kernel(vol_m, mask, pad)
    ref = band_pass_plain(vol_m, mask, pad)
    assert not ours.isnan().any()  # every output written once
    assert torch.equal(ours.view(torch.int32), ref.view(torch.int32))
    # the walk finds each selected slot once and no other; a warp's trips
    # in a word are the largest popcount of that word among its columns
    selected = (mask != 0).to(torch.int64)
    assert torch.equal(slots, selected.sum(1))
    wk, mp = mask.shape[1:]
    cols = -(-mp // NB) * NB
    per_word = torch.nn.functional.pad(selected, (0, cols - mp)).view(
        mask.shape[0], wk // 32, 32, cols // 32, 32).sum(2)
    assert torch.equal(trips, per_word.amax(-1).sum(1))


def test_plain_takes_windows_the_kernel_refuses():
    """On the CPU band_pass runs its plain version at any PAD, also one
    the card refuses (not a multiple of 16, or WK above MAX_WK)."""
    rng = np.random.default_rng(4)
    for pad in (8, 320):
        wk, mp = NB + 2 * pad, 128
        vol_m = torch.as_tensor(rng.random((2, 2, 256 + 2 * pad), np.float32))
        mask = torch.as_tensor((rng.random((2, wk, mp)) < 0.1).astype(np.int8))
        out = band_mm.band_pass(vol_m, mask, pad)
        assert torch.equal(out, band_pass_plain(vol_m, mask, pad))
