"""Launch geometry of kernel B2 (ops/scanline.py:scanline_geometry) on
the CPU: the ring fits the H100's shared memory, the tile layout covers
every cell the kernel indexes, and what cannot fit raises."""
import numpy as np
import pytest

from adcensus_torch.ops.scanline import (
    MAX_D, MAX_STAGES, MIN_BLOCKS, SMEM_LIMIT, scanline_geometry,
    scanline_layout,
)

H, W = 375, 450


def _pow2(v):
    return v > 0 and v & (v - 1) == 0


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("d", [1, 3, 33, 64, 256, 1024])
def test_geometry_fits_and_covers(d, axis):
    s, p = (W, H) if axis == "x" else (H, W)
    pb, k, stages, smem = scanline_geometry(d, s, p, axis)
    assert _pow2(pb) and pb <= 8 and _pow2(k)
    assert 2 <= stages <= MAX_STAGES
    assert smem <= SMEM_LIMIT
    inner, outer, cost_ds, grain, groups, code_ds, slot = scanline_layout(
        d, pb, k, axis)
    assert smem == stages * slot and slot % 16 == 0
    assert (inner, outer) == ((k, pb) if axis == "x" else (pb, k))
    # every cost cell the kernel indexes, (d, o, r) at d * cost_ds +
    # (o * inner + r) * 4, is distinct and inside the cost tile
    dd, oo, rr = np.meshgrid(np.arange(d), np.arange(outer),
                             np.arange(inner), indexing="ij")
    at = dd * cost_ds + (oo * inner + rr) * 4
    assert len(np.unique(at)) == d * pb * k
    cost_bytes = -(-d * cost_ds // 16) * 16
    assert at.max() + 4 <= cost_bytes
    # rows start on 8 bytes (8-byte grains) and d-planes are an odd
    # number of 8-byte units apart
    assert cost_ds % 8 == 0 and cost_ds // 8 % 2 == 1
    # code byte (d, o, r) at offset off < grain of its row's window: inside
    # its own row and the code tile
    dd, oo, off, rr = np.meshgrid(np.arange(d), np.arange(outer),
                                  np.arange(grain), np.arange(inner),
                                  indexing="ij")
    row = dd * code_ds + oo * groups * grain
    assert (off + rr < groups * grain).all()
    assert (row + off + rr).max() < d * code_ds
    assert code_ds >= outer * groups * grain and code_ds // grain % 2 == 1
    code_bytes = -(-d * code_ds // 16) * 16
    assert slot == cost_bytes + code_bytes + -(-4 * k // 16) * 16


def test_geometry_at_cone_size():
    """D=64 at 375x450, as measured fastest on the H100: four paths a
    block; 32 steps a chunk in 3 ring slots on x passes, 16 in 5 on y
    passes, 64 steps ahead either way."""
    assert scanline_geometry(64, W, H, "x")[:3] == (4, 32, 3)
    assert scanline_geometry(64, H, W, "y")[:3] == (4, 16, 5)


@pytest.mark.parametrize("s,p", [(1, 1), (7, 5), (33, 1), (450, 5)])
def test_geometry_small_scans_and_grids(s, p):
    for axis in ("x", "y"):
        pb, k, _, _ = scanline_geometry(64, s, p, axis)
        assert k < 2 * s or k == 1
        assert pb == 1 or -(-p // pb) >= MIN_BLOCKS


@pytest.mark.parametrize("args", [
    (0, 450, 375, "x"), (MAX_D + 1, 450, 375, "x"), (64, 0, 375, "y"),
    (64, 450, 0, "x"), (64, 450, 375, "z"),
])
def test_geometry_rejects_impossible(args):
    with pytest.raises(ValueError):
        scanline_geometry(*args)
