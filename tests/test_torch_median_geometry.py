"""Launch geometry of kernel M1 (ops/median.py:median_inplace_geometry and
median_inplace_schedule) on the CPU, and a lane-by-lane emulation of
csrc/median_inplace.cu held bitwise to median_inplace_plain and to the
JAX package's median_filter_3x3_inplace.

The emulation runs the kernel's dataflow step by step: each warp's rings
of originals refilled CHUNK columns at a time LEAD columns ahead (landing
either at once or at the last step LAG allows), a thread a row with the
rows of later bands LAG or more steps behind, the row above's filtered
values passed up the warp by a shuffle and across a warp boundary through
the ring indexed by t mod 4, a band's first row reading the row above it
from the output, the early sort of six and insertion of the seventh value,
the late merge of the left and up-right values at rank 4 (out-of-image
slots padded with -inf or +inf by the map's class), filtered values staged
a row at a time and stored in half-warp chunks. Rings and output start as
NaN, so a read of a value not yet written shows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.ops import median as torch_median
from adcensus_torch.ops.median import (
    CHUNK, FIRST_STEP, HANDOFF, IN_RING, LAG, LEAD, MARGIN, MAX_HEIGHT,
    MAX_THREADS, OUT_RING, TAIL, WARP, WRAP, median_inplace_geometry,
    median_inplace_plain, median_inplace_schedule,
)
from adcensus_tpu.stages import refine as jax_refine

H100_SMEM = 232_448
INF = np.float32(np.inf)
# Pads of the eight out-of-image slots (True: -inf), by map class: the
# kernel takes rank 4 of the nine always, so a window of population n
# needs 4 - n // 2 of its 9 - n out-of-image slots at -inf
SLOTS = ("ul", "u", "ur", "lf", "r", "bl", "b", "br")
NEG_PADS = {
    "general": {"u", "lf", "r", "b"},  # H, W >= 2: the edge middles
    "one row": {"ul", "u", "ur"},
    "one column": {"ul", "lf", "bl"},
    "one pixel": {"ul", "u", "ur", "lf"},
}
SORT6 = ((0, 5), (1, 3), (2, 4), (1, 2), (3, 4), (0, 3), (2, 5), (0, 1),
         (2, 3), (4, 5), (1, 2), (3, 4))


def _map_class(h, w):
    return {(False, False): "general", (True, False): "one row",
            (False, True): "one column", (True, True): "one pixel"}[
                (h == 1, w == 1)]


def _pads(h, w):
    neg = NEG_PADS[_map_class(h, w)]
    return {s: (-INF if s in neg else INF) for s in SLOTS}


def _window_padding_is_exact(h, w):
    """Every border window of an (H, W) map gets exactly 4 - n // 2 -inf
    pads among its out-of-image slots."""
    pads = _pads(h, w)
    for y in range(h):
        for x in range(w):
            up, down, left, right = y > 0, y < h - 1, x > 0, x < w - 1
            inside = {"ul": up and left, "u": up, "ur": up and right,
                      "lf": left, "r": right, "bl": down and left,
                      "b": down, "br": down and right}
            n = (1 + up + down) * (1 + left + right)
            neg = sum(pads[s] < 0 for s in SLOTS if not inside[s])
            if neg != 4 - n // 2:
                return False
    return True


class _Warp:
    """One warp's registers (numpy arrays of 32 lanes), position, and the
    cp.async copies it has in flight."""

    def __init__(self, tid, first_x):
        nan = np.full(WARP, np.nan, np.float32)
        self.tid = tid
        self.b = nan.copy()  # up-right value received by the shuffle
        self.u = nan.copy()  # the up-right value of the step before
        self.win = [nan.copy() for _ in range(5)]  # own x, x+1; below x-1..x+1
        self.v3 = nan.copy()
        self.v4 = nan.copy()
        self.x = first_x
        self.k = np.zeros(WARP, np.int64)
        self.pending = []  # (issue step, ring, index, value)


def _divmod(v, period, banded):
    return np.divmod(v, period) if banded else (np.zeros_like(v), v)


def _emulate(src, max_threads=MAX_THREADS, landing="late", order=1):
    """csrc/median_inplace.cu, lane by lane, on the (H, W) float32 map
    ``src``. Between two barriers (one a step) the warps run in order
    (``order=1``) or in reverse (-1), so that a read of another warp's
    value not ordered by a barrier shows. cp.async copies land at once
    (``landing="early"``) or at the last step LAG allows (``"late"``)."""
    h, w = src.shape
    threads, _, _ = median_inplace_geometry(h, w, max_threads)
    _, period, last = median_inplace_schedule(h, w, max_threads)
    rows = -(-h // threads)
    banded = rows > 1
    warps = threads // WARP
    pads = _pads(h, w)
    ur_inf = pads["ur"] > 0
    inp = src.ravel()
    out = np.full(h * w, np.nan, np.float32)
    in_ring = np.full((warps, WARP + 1, IN_RING), np.nan, np.float32)
    out_ring = np.full((warps, WARP, OUT_RING), np.nan, np.float32)
    handoff = np.full((warps, HANDOFF), np.nan, np.float32)
    wrapq = np.full(WRAP, np.nan, np.float32)
    lane = np.arange(WARP)
    half, i16 = lane // 16, lane % 16
    tid = np.arange(threads).reshape(warps, WARP)
    state = [_Warp(tid[wi], FIRST_STEP - 2 * tid[wi]) for wi in range(warps)]

    def step(wi, t):
        r = state[wi]
        x, k = r.x, r.k
        y = k * threads + r.tid
        active = (x >= 0) & (x < w) & (y < h)
        busy = (x >= -MARGIN) & (x <= w + 1) & (y < h)
        xn, kn = x + 1, k.copy()
        if banded:
            wrap = xn == period - MARGIN
            xn[wrap], kn[wrap] = -MARGIN, kn[wrap] + 1
        yn = kn * threads + r.tid
        v = t - 2 * r.tid

        def issue(ring, index, value):
            if landing == "early":
                ring[index] = value
            else:
                r.pending.append((t, ring, index, value))

        # a warp whose 33 streams have no column in the image within reach
        # of this step's refills and stores skips both (one band only)
        v0 = t - WARP * 2 * wi
        io = banded or (v0 + LEAD + CHUNK - 1 >= 0 and v0 - 2 * WARP
                        - CHUNK < w)
        # the stores' values first: streams p and p + 16, the 16 columns up
        # to the step before, read before this step's writes
        rho = t % CHUNK + 16 * half
        vv = t - 2 * (WARP * wi + rho) - CHUNK + i16
        kk, xx = _divmod(vv, period, banded)
        g = kk * threads + WARP * wi + rho
        ok = (vv >= 0) & (xx < w) & (g < h)
        assert io or not ok.any(), (t, wi, "skipped a store")
        stored = out_ring[wi, rho[ok], vv[ok] % OUT_RING]
        assert not np.isnan(stored).any(), (t, "store of an unset value")
        at = g[ok] * w + xx[ok]
        # refills: the same two streams (half-warps), and at p = 0 stream 32
        # (the first half-warp), a column outside the image filled with
        # zero; the band-boundary queue (thread 0)
        streams = [(rho, t - 2 * (WARP * wi + rho) + LEAD + i16)]
        if t % CHUNK == 0:
            streams.append((np.full(16, WARP), t - 2 * (WARP * wi + WARP)
                            + LEAD + i16[:16]))
        for rho_s, vs in streams:
            kk, xx = _divmod(vs, period, banded)
            gr = kk * threads + WARP * wi + rho_s
            okr = (vs >= 0) & (xx < w) & (gr < h)
            assert io or not okr.any(), (t, wi, "skipped a refill")
            if not io:
                continue
            for rs, vr, ok, gv, xv in zip(rho_s, vs, okr, gr, xx):
                issue(in_ring, (wi, rs, vr % IN_RING),
                      inp[gv * w + xv] if ok else np.float32(0.0))
        if banded and wi == 0:
            tt = t + LAG
            kk = (tt + MARGIN) // period
            xx = tt - kk * period
            val = np.float32(0.0)
            if 1 <= kk and kk * threads < h and 0 <= xx + 1 < w:
                val = out[(kk * threads - 1) * w + xx + 1]
                assert not np.isnan(val), (t, "wrap read before store")
            issue(wrapq, tt % WRAP, val)
        if busy.any():
            # the late merge: left and up-right (both from step t-1)
            b = r.b.copy()
            b[0] = handoff[wi - 1, (t - 1) % HANDOFF] if wi else \
                wrapq[t % WRAP]
            z = np.fmax(np.fmin(r.v4, b), r.v3)
            out_ring[wi, lane, v % OUT_RING] = z
            handoff[wi, t % HANDOFF] = z[-1]
            if banded and wi == warps - 1 and active[-1]:
                out[y[-1] * w + x[-1]] = z[-1]
            r.b = np.concatenate([z[:1], z[:-1]])  # __shfl_up_sync
            # prepare pixel x+1: two new originals, the sort of six, then
            # insert the up value (b) and the left value (z)
            own = in_ring[wi, lane, (v + 2) % IN_RING]
            below = in_ring[wi, lane + 1, (v + 2) % IN_RING]
            win = [r.win[1], own, r.win[3], r.win[4], below]
            r.win = win
            up, down = yn > 0, yn < h - 1
            left, right = xn > 0, xn < w - 1
            e = [np.where(up & left, r.u, pads["ul"]), win[0],
                 np.where(right, win[1], pads["r"]),
                 np.where(down & left, win[2], pads["bl"]),
                 np.where(down, win[3], pads["b"]),
                 np.where(down & right, win[4], pads["br"])]
            for p, q in SORT6:
                e[p], e[q] = np.fmin(e[p], e[q]), np.fmax(e[p], e[q])
            u = np.where(up, b, pads["u"])
            s = {j: np.fmax(np.fmin(e[j], u), e[j - 1]) for j in (2, 3, 4)}
            a = np.where(left, z, pads["lf"])
            v3 = np.fmax(np.fmin(s[3], a), s[2])
            v4 = np.fmax(np.fmin(s[4], a), s[3])
            ur_out = ~(up & right)
            r.v3 = np.where(ur_out & ur_inf, v4, v3)
            r.v4 = np.where(ur_out & ~ur_inf, v3, v4)
            r.u = b
        out[at] = stored
        # cp.async.wait_group(LAG - 1)
        keep = []
        for item in r.pending:
            if item[0] <= t - LAG + 1:
                item[1][item[2]] = item[3]
            else:
                keep.append(item)
        r.pending = keep
        r.x, r.k = xn, kn

    for t in range(FIRST_STEP, last + TAIL + 1):  # __syncthreads a step
        for wi in range(warps)[::order]:
            step(wi, t)
    assert not np.isnan(out).any(), "pixels never stored"
    return out.reshape(h, w)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _holey_map(seed, h, w, share=0.15):
    """Disparities in [0.5, 60) with ``share`` +inf: no zeros, so no
    -0.0 / +0.0 tie, whose order neither version defines."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.5, 60.0, (h, w)).astype(np.float32)
    src[rng.random((h, w)) < share] = np.inf
    return src


# (H, W, threads the emulated block may have): one-pixel-wide and -high
# and small maps at the kernel's own block size, then blocks of 32 to 128
# threads, so that maps of a few hundred pixels stride rows over bands
# (W < 2 * threads: E = LAG; W > 2 * threads: E = W - 2 * threads +
# MARGIN) and cross warp boundaries
EMULATED = [(1, 1, MAX_THREADS), (1, 50, MAX_THREADS), (50, 1, MAX_THREADS),
            (2, 2, MAX_THREADS), (9, 11, MAX_THREADS), (40, 23, MAX_THREADS),
            (70, 9, 32), (75, 20, 64), (33, 90, 32), (65, 3, 32),
            (97, 70, 64), (130, 1, 64), (150, 20, 128)]


@pytest.mark.parametrize("h,w,max_threads", EMULATED)
def test_emulation_equals_plain_and_jax(h, w, max_threads):
    src = _holey_map(5 + h * w, h, w)
    plain = median_inplace_plain(torch.as_tensor(src)).numpy()
    jax_out = np.asarray(jax_refine.median_filter_3x3_inplace(
        jnp.asarray(src)))
    np.testing.assert_array_equal(_bits(plain), _bits(jax_out))
    for landing, order in (("early", 1), ("late", -1)):
        np.testing.assert_array_equal(
            _bits(_emulate(src, max_threads, landing, order)),
            _bits(plain), err_msg=f"{landing}, order {order}")


@pytest.mark.parametrize("h,w,max_threads", [(2, 2, MAX_THREADS),
                                             (70, 9, 32), (33, 90, 32)])
def test_emulation_all_invalid(h, w, max_threads):
    src = np.full((h, w), np.inf, np.float32)
    assert np.isinf(_emulate(src, max_threads)).all()


@pytest.mark.parametrize("h,w", [(1, 1), (1, 7), (7, 1), (2, 2), (3, 3),
                                 (2, 5), (6, 2), (5, 4)])
def test_pads_give_rank_four(h, w):
    """The map classes' -inf pads make rank 4 the (population // 2)-th
    smallest at every border window."""
    assert _window_padding_is_exact(h, w)


@pytest.mark.parametrize("h,w", [(375, 450), (555, 653), (1100, 64),
                                 (1, 1), (1, 50), (50, 1), (2, 2), (9, 11),
                                 (1025, 3), (3, 2000), (1025, 2100),
                                 (8192, 8192 // 8), (MAX_HEIGHT, 1)])
def test_geometry_fits(h, w):
    threads, rows, smem = median_inplace_geometry(h, w)
    assert threads % WARP == 0 and WARP <= threads <= MAX_THREADS
    assert threads * rows >= h > threads * (rows - 1)
    assert smem <= H100_SMEM
    delay, period, last = median_inplace_schedule(h, w)
    if rows == 1:  # the W + 2H - 2 wavefronts
        assert delay == 0 and last == w + 2 * h - 3
    else:  # a thread's rows do not overlap; a band waits LAG or more
        assert delay >= LAG and period - MARGIN >= w
        assert last + LEAD + CHUNK < 2 ** 24


def test_geometry_at_the_height_limit():
    threads, rows, _ = median_inplace_geometry(MAX_HEIGHT, 1)
    assert threads == 2 * WARP and rows == MAX_HEIGHT // threads
    assert MAX_HEIGHT >= 8192
    with pytest.raises(ValueError):
        median_inplace_geometry(MAX_HEIGHT + 1, 1)


@pytest.mark.parametrize("h,w", [(0, 5), (5, 0), (2 ** 16, 2 ** 15),
                                 (1, 2 ** 31 - 40)])
def test_geometry_rejects_impossible(h, w):
    with pytest.raises(ValueError):
        median_inplace_geometry(h, w)


def test_wrapper_refuses_before_launch():
    """The wrapper checks shape and dtype on any device, and a CPU tensor
    takes the plain version whatever its height."""
    with pytest.raises(TypeError):
        torch_median.median_inplace(torch.zeros((4, 5), dtype=torch.float64))
    with pytest.raises(ValueError):
        torch_median.median_inplace(torch.zeros((4, 5, 1)))
    src = _holey_map(3, 6, 7)
    np.testing.assert_array_equal(
        torch_median.median_inplace(torch.as_tensor(src)).numpy(),
        median_inplace_plain(torch.as_tensor(src)).numpy())
