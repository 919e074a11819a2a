"""Kernel B2's penalty codes on the CPU: ``ops/scanline.py:scanline_pass``
takes the two per-pixel distance maps in place of a code volume, and the
kernel derives each cell's code from their flags. Holds the new
signature's plain path to the code-volume path bit for bit, and a
chunk-by-chunk emulation of what csrc/scanline.cu copies into a ring slot
(the left flags' and the right flags' grain-aligned windows at any
address alignment) and reads back per cell, to ``code_volume``."""
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import scanline
from adcensus_torch.stages import scanline as scan_stage

TSO = 15

# (D, rows, out_w, W_full, col0, min_disparity, real_w): the one-card
# pass (col0 0, W_full the width), an odd width, D beyond the width, a
# negative and a positive min_disparity, column slabs of a wider image
# with its full-width right map (the sharded y passes), a padded row slab
# wider than the image (the sharded x passes) and a one-column image.
CASES = {
    "plain": (16, 9, 40, 40, 0, 0, 40),
    "odd_w": (33, 7, 37, 37, 0, 0, 37),
    "d_beyond_w": (48, 5, 21, 21, 0, 0, 21),
    "neg_min_d": (20, 6, 30, 30, 0, -7, 30),
    "pos_min_d": (12, 6, 30, 30, 0, 5, 30),
    "col_slab": (24, 8, 13, 52, 26, 0, 50),
    "col_slab_min_d": (24, 8, 13, 52, 39, -3, 51),
    "padded_rows": (16, 5, 48, 48, 0, 2, 45),
    "one_col": (4, 6, 1, 1, 0, 0, 1),
}


def _maps(case):
    d, rows, out_w, w_full, col0, d_min, real_w = CASES[case]
    rng = np.random.default_rng(sum(CASES[case]) + 7)
    d1 = torch.as_tensor(rng.integers(0, 2 * TSO, (rows, out_w), np.int32))
    rd = torch.as_tensor(rng.integers(0, 2 * TSO, (rows, w_full), np.int32))
    opts = ADCensusOptions(min_disparity=d_min, max_disparity=d_min + d,
                           so_tso=TSO)
    return d1, rd, opts, col0, real_w


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("axis,reverse", [("x", False), ("x", True),
                                          ("y", False), ("y", True)])
def test_pass_equals_code_volume_path(case, axis, reverse):
    """scanline_pass(cost, d1, rd, ...) on CPU tensors equals the plain
    version fed code_volume's volume, bit for bit."""
    d1, rd, opts, col0, real_w = _maps(case)
    rows, out_w = d1.shape
    d = opts.disp_range
    rng = np.random.default_rng(d + rows)
    cost = torch.as_tensor(rng.random((d, rows, out_w), np.float32) * 2 - 1)
    s_len = out_w if axis == "x" else rows
    flags = scan_stage._scan_flags(s_len)
    code = scan_stage.code_volume(d1, rd, opts, real_w, col0)
    want = scanline.scanline_pass_plain(cost, code, flags, opts.so_p1,
                                        opts.so_p2, axis, reverse)
    got = scanline.scanline_pass(cost, d1, rd, flags, opts.so_tso,
                                 opts.so_p1, opts.so_p2, axis, reverse,
                                 opts.min_disparity, col0, real_w)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_pass_rejects_bad_maps():
    cost = torch.zeros((4, 3, 5))
    flags = scan_stage._scan_flags(5)
    d1 = torch.zeros((3, 5), dtype=torch.int32)
    args = (flags, TSO, 1.0, 3.0, "x", False)
    with pytest.raises(ValueError, match="rd"):
        scanline.scanline_pass(cost, d1, torch.zeros((3, 0),
                                                     dtype=torch.int32), *args)
    with pytest.raises(ValueError, match="d1"):
        scanline.scanline_pass(cost, d1[:, :4].contiguous(), d1, *args)
    with pytest.raises(TypeError, match="rd"):
        scanline.scanline_pass(cost, d1, d1.float(), *args)


def _kernel_codes(d1, rd, opts, col0, real_w, pb, k, axis, reverse,
                  left_base, right_base):
    """The codes csrc/scanline.cu computes, chunk by chunk: the producer
    copies each row's grain-aligned words of the flag maps (stored from
    byte addresses ``left_base`` and ``right_base``) into the slot's left
    and right flag rows, and each compute lane reads its cells' flags back
    at their byte offsets. Unloaded slot bytes read 9, so a read outside
    what was copied shows as a wrong code."""
    d, md = opts.disp_range, opts.min_disparity
    rows, out_w = d1.shape
    w_full = rd.shape[1]
    f1 = (d1.numpy() >= opts.so_tso).astype(np.uint8)
    fr = (rd.numpy() >= opts.so_tso).astype(np.uint8)
    inner, outer, _, grain, groups, rgroups, _ = scanline.scanline_layout(
        d, pb, k, axis)
    lmem = np.zeros(left_base + f1.size + 64, np.uint8)
    lmem[left_base:left_base + f1.size] = f1.ravel()
    rmem = np.zeros(right_base + fr.size + 64, np.uint8)
    rmem[right_base:right_base + fr.size] = fr.ravel()
    x_pass = axis == "x"
    s_len, paths = (out_w, rows) if x_pass else (rows, out_w)
    s_stride, p_stride = (1, out_w) if x_pass else (out_w, 1)

    def right_col(xr):
        return min(max(xr, 1), w_full - 1)

    code = np.full((d, rows, out_w), 99, np.uint8)
    n_chunks = -(-s_len // k)
    for p0 in range(0, paths, pb):
        pn = min(pb, paths - p0)
        for c in range(n_chunks):
            kn = min(k, s_len - c * k)
            lo = s_len - c * k - kn if reverse else c * k
            # producer: left rows (x: paths, y: steps) of n cells
            lslot = np.full((outer, groups * grain), 9, np.uint8)
            n = kn if x_pass else pn
            for o in range(outer):
                q0, pb0 = (0, o) if x_pass else (o, 0)
                if pb0 >= pn or q0 >= kn:
                    continue
                src = left_base + (lo + q0) * s_stride + (p0 + pb0) * p_stride
                off = src % grain
                for grp in range(groups):
                    if grp * grain < off + n:
                        a = src - off + grain * grp
                        lslot[o, grp * grain:(grp + 1) * grain] = \
                            lmem[a:a + grain]
            # producer: right rows, the columns [ra, ra + rn)
            x0, xn = (lo, kn) if x_pass else (p0, pn)
            ra = right_col(col0 + x0 - md - (d - 1))
            rn = right_col(col0 + x0 + xn - 1 - md) - ra + 1
            rslot = np.full((outer, rgroups * 16), 9, np.uint8)
            for o in range(pn if x_pass else kn):
                src = right_base + ((p0 + o) if x_pass else (lo + o)) * \
                    w_full + ra
                off = src % 16
                for grp in range(rgroups):
                    if grp * 16 < off + rn:
                        a = src - off + 16 * grp
                        rslot[o, grp * 16:(grp + 1) * 16] = rmem[a:a + 16]
            # compute warps: path p0 + w, step lo + q
            for w in range(pn):
                for q in range(kn):
                    o = w if x_pass else q
                    if x_pass:
                        lrow0 = left_base + lo + (p0 + w) * out_w
                        f = lslot[o, lrow0 % 16 + q]
                    else:
                        lrow0 = left_base + (lo + q) * out_w + p0
                        f = lslot[o, lrow0 % 4 + w]
                    row = (p0 + w) if x_pass else (lo + q)
                    roff = (right_base + row * w_full + ra) % 16
                    xs = col0 + ((lo + q) if x_pass else (p0 + w)) - md
                    # the warp's chunk at an image edge runs the sticky
                    # rule; elsewhere the code is f1 + g, unclamped
                    xc = col0 + (lo if x_pass else p0 + w) - md
                    x_hi = xc + kn - 1 if x_pass else xc
                    edge = (xc - (d - 1) < 1 or x_hi >= real_w - 1
                            or x_hi > w_full - 1)
                    below = (2 ** 31 - 1 if xs <= 0
                             else xs - (real_w - 1))
                    y, x = (p0 + w, lo + q) if x_pass else (lo + q, p0 + w)
                    for dd in range(d):
                        xr = xs - dd
                        at = roff + (right_col(xr) if edge else xr) - ra
                        assert 0 <= at < rgroups * 16
                        g = rslot[o, at]
                        sticky = edge and dd <= below
                        code[dd, y, x] = 2 * f if sticky else f + g
    return torch.as_tensor(code)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pb,k", [(4, 8), (2, 16), (1, 1)])
@pytest.mark.parametrize("axis,reverse", [("x", False), ("x", True),
                                          ("y", False), ("y", True)])
def test_kernel_codes_emulated(case, pb, k, axis, reverse):
    """The emulated kernel's codes, with the maps at addresses 3 and 13
    bytes past a 16-byte boundary, equal code_volume's."""
    d1, rd, opts, col0, real_w = _maps(case)
    want = scan_stage.code_volume(d1, rd, opts, real_w, col0)
    got = _kernel_codes(d1, rd, opts, col0, real_w, pb, k, axis, reverse,
                        left_base=16 * 5 + 3, right_base=16 * 7 + 13)
    assert torch.equal(got, want)
