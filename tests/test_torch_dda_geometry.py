"""A lane-by-lane emulation of csrc/dda.cu (kernel M2) on the CPU, held
bitwise to dda_plain and to the JAX package's
depth_discontinuity_adjustment.

The emulation runs the kernel's dataflow: a warp a row, lane j on column
x0 + j of 32-column chunks; each chunk's three rows of the map loaded two
chunks ahead (lane 0 also loads column x0 + 32), the row's neighbours
taken by shuffle with the chunk's edge columns from the chunk before
(kept by lane 31) and the extra load; the Sobel in the port's order of
float32 operations; the gathers off the chain (own cost, the right
neighbour's, and in the left column the left neighbour's original
value's and the own value's), all lanes at once, for the next chunk
before this one is resolved; each lane's map from its input's symbol to
its output's, composed by a warp scan (shuffles up by 1, 2, 4, 8, 16);
the rounds of frontier, gather at the frontier's value and ballot for
the lanes whose input is a value passed on from the left; the final
value of lane 31 carried into the next chunk. Registers start as NaN
where the kernel would leave them unset, so a read of one that is not
loaded shows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import dda as torch_dda
from adcensus_torch.ops.dda import THRESHOLD, WARP, WARPS
from adcensus_tpu.config import ADCensusOptions as JaxOptions
from adcensus_tpu.stages import refine as jax_refine
from test_torch_refine import _dda_chain_case, _dda_random_case

LANES = np.arange(WARP)
FULL = (1 << WARP) - 1
HALF = np.float32(0.5)
TWO = np.float32(2.0)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _ballot(pred):
    return int(sum(1 << int(j) for j in np.flatnonzero(pred)))


def _lanes_of(mask):
    return np.array([(mask >> int(j)) & 1 for j in LANES], bool)


def _shfl(v, src):
    """__shfl_sync(FULL, v, src): lane j reads lane src[j]."""
    return v[np.asarray(src) & (WARP - 1)]


def _index_of(v, d_range):
    """csrc/dda.cu index_of, lane-wise: (lround(v), whether v is finite
    and its index is in [0, D))."""
    fin = np.isfinite(v)
    vv = np.where(fin, v, np.float32(0.0))
    r = np.where(vv >= 0, np.floor(vv + HALF), np.ceil(vv - HALF))
    ok = fin & (r >= 0) & (r < d_range)
    return np.where(ok, r, 0).astype(np.int64), ok


# Symbols of a lane's input, in the terms of that lane: the frontier's
# value (V), the left neighbour's original value (L), the own value (O),
# or another (U). A lane's map from its input's symbol to its output's
# symbol in the next lane's terms is 4 bytes, byte s the image of s
V, L, O, U = 0, 1, 2, 3
IDENTITY = 0x03020100
CONST_L = 0x01010101


def _byte_perm(a, sel):
    """__byte_perm(a, 0, sel), lane-wise: byte i of the result is byte
    (nibble i of sel) of a, or 0 for a nibble of 4 to 7."""
    r = np.zeros_like(a)
    for i in range(4):
        k = (sel >> (4 * i)) & 0xF
        byte = np.where(k < 4, (a >> (8 * (k & 3))) & 0xFF, 0)
        r |= byte << (8 * i)
    return r


def _after(a, b):
    """The map a after b, lane-wise: a permuted by b's bytes packed into
    nibbles."""
    x = b | (b >> 4)
    return _byte_perm(a, (x & 0xFF) | ((x >> 8) & 0xFF00))


def _shfl_up(v, d):
    """__shfl_up_sync(FULL, v, d): lanes below d keep their own."""
    return np.where(LANES >= d, v[np.maximum(LANES - d, 0)], v)


def _symbol(p, t):
    """The symbol, in the next lane's terms, of output t: L where it is
    this lane's value, O where it is the next lane's, else U."""
    return np.where(_bits(t) == _bits(p["m"]), L,
                    np.where(_bits(t) == _bits(p["rd"]), O, U))


def _pick(p, v, vok, vc):
    """csrc/dda.cu pick: the lane's output when its left neighbour's
    final value is v, at cost vc in the left column."""
    t = p["m"].copy()
    c = p["c0"].copy()
    take_l = vok & (vc < c)
    t = np.where(take_l, v, t)
    c = np.where(take_l, vc, c)
    return np.where(p["rok"] & (p["rc"] < c), p["rd"], t)


class _RowWarp:
    """One warp's walk of row y: its two register sets of raw loads, the
    chunk halo kept from the last prepare, and the final value carried
    from the last resolve; the rounds each chunk took."""

    def __init__(self, disp, cost, y):
        self.disp, self.cost, self.y = disp, cost, y
        self.d_range, self.h, self.w = cost.shape
        self.inner = 1 <= y <= self.h - 2
        nan = np.full(WARP, np.nan, np.float32)
        self.raw = [dict(u=nan, m=nan, b=nan, eu=nan, em=nan, eb=nan)
                    for _ in range(2)]
        zero = np.zeros(WARP, np.float32)
        self.prev = dict(u=zero, m=zero, b=zero,
                         adj=np.zeros(WARP, bool))
        self.carry = np.float32(np.nan)
        self.rounds = []
        self.gather_rounds = 0

    def _row(self, dy, cols):
        """Loads of row y + dy at ``cols``, 0 where a lane loads nothing
        (past the row's end, or a row above or below a border row)."""
        out = np.zeros(len(cols), np.float32)
        if dy and not self.inner:
            return out
        ok = cols < self.w
        out[ok] = self.disp[self.y + dy, cols[ok]]
        return out

    def load(self, k):
        """Chunk k's three rows into register set k % 2, and column
        x0 + 32's into lane 0's extra registers."""
        x = k * WARP + LANES
        e = np.full(WARP, (k + 1) * WARP)
        e[1:] = self.w  # only lane 0 loads the extra column
        raw = self.raw[k % 2]
        for name, dy in (("u", -1), ("m", 0), ("b", 1)):
            raw[name] = self._row(dy, x)
            raw["e" + name] = np.where(LANES == 0, self._row(dy, e),
                                       np.float32(np.nan))

    def _gather(self, want, idx, cols):
        out = np.full(WARP, np.nan, np.float32)
        out[want] = self.cost[idx[want], self.y, cols[want]]
        return out

    def prepare(self, k):
        """Sobel, adjustable lanes and their gathers for chunk k, from
        register set k % 2; then the halo kept and chunk k + 2 loaded
        into the same set."""
        raw, prev = self.raw[k % 2], self.prev
        x = k * WARP + LANES
        up, dn = (LANES - 1) & 31, (LANES + 1) & 31
        left = {n: _shfl(np.where(LANES == 31, prev[n], raw[n]), up)
                for n in "umb"}
        right = {n: _shfl(np.where(LANES == 0, raw["e" + n], raw[n]), dn)
                 for n in "umb"}
        ul, l, bl = left["u"], left["m"], left["b"]
        ur, r, br = right["u"], right["m"], right["b"]
        u, m, b = raw["u"], raw["m"], raw["b"]
        with np.errstate(invalid="ignore", over="ignore"):
            gx = ((((-ul + ur) - TWO * l) + TWO * r) - bl) + br
            gy = ((((-ul - TWO * u) - ur) + bl) + TWO * b) + br
            edge = (np.abs(gx) + np.abs(gy)) > np.float32(THRESHOLD)
        di, own_ok = _index_of(m, self.d_range)
        adj = self.inner & (x >= 1) & (x <= self.w - 2) & edge & own_ok
        ladj = _shfl(np.where(LANES == 31, prev["adj"], adj), up)
        li, lok = _index_of(l, self.d_range)
        ri, rok = _index_of(r, self.d_range)
        p = dict(
            m=m, adj=adj, ladj=ladj, lm=l, lok=lok, rd=r, rok=rok,
            c0=self._gather(adj, di, x),
            lc=self._gather(adj & lok, li, x - 1),
            rc=self._gather(adj & rok, ri, x + 1),
            clo=self._gather(adj & ladj, di, x - 1),
        )
        self.prev = dict(u=u, m=m, b=b, adj=adj)
        self.load(k + 2)
        return p

    def resolve(self, p, k, out):
        """Chunk k's outputs from its prepared lanes and the carry: the
        outputs for the left neighbour's original value (L) and for the
        own value (O), then rounds of a scan over the lanes' symbol maps
        from a frontier, and a gather at the frontier's value (V) in every
        round but a first one that starts from L or O."""
        x = k * WARP + LANES
        adj = p["adj"]
        res = p["m"].copy()
        pend = _ballot(adj)
        if pend:
            val_l = _pick(p, p["lm"], p["lok"], p["lc"])
            val_o = _pick(p, p["m"], np.ones(WARP, bool), p["clo"])
            code_lo = np.where(
                adj, (_symbol(p, val_l) << 8) | (_symbol(p, val_o) << 16)
                | (U << 24), CONST_L)
            f, v = -1, np.float32(self.carry)
            s = L
            if adj[0] and p["ladj"][0]:
                s = (O if _bits(v) == _bits(p["m"][0]) else
                     L if _bits(v) == _bits(p["lm"][0]) else V)
            while True:
                mine = _lanes_of(pend)
                val_v = np.full(WARP, np.nan, np.float32)
                t_v = np.full(WARP, U)
                if s == V:
                    self.gather_rounds += 1
                    vi, vok = _index_of(np.full(WARP, v), self.d_range)
                    vc = self._gather(mine & vok, vi, x - 1)
                    val_v = np.where(mine, _pick(p, v, vok, vc), val_v)
                    t_v = np.where(~mine, U, np.where(
                        _bits(val_v) == _bits(v), V, _symbol(p, val_v)))
                code = np.where(LANES <= f, IDENTITY,
                                np.where(adj, code_lo | t_v, CONST_L))
                acc = code.copy()
                for d in (1, 2, 4, 8, 16):
                    other = _shfl_up(acc, d)
                    acc = np.where(LANES >= d, _after(acc, other), acc)
                ex = np.where(LANES == 0, IDENTITY, _shfl_up(acc, 1))
                sym_in = (ex >> (8 * s)) & 0xFF
                got = mine & (sym_in != U)
                res = np.where(got, np.where(
                    sym_in == V, val_v, np.where(sym_in == L, val_l, val_o)),
                    res)
                pend &= ~_ballot(got)
                if not pend:
                    break
                f = (pend & -pend).bit_length() - 2  # lowest pending - 1
                v, s = res[f], V
        self.rounds.append(self.gather_rounds)
        self.gather_rounds = 0
        keep = x < self.w
        out[self.y, x[keep]] = res[keep]
        self.carry = res[31]


def emulate(disp, cost):
    """csrc/dda.cu on the CPU: the adjusted map and the rounds each
    (row, chunk) took, as a dict."""
    h, w = disp.shape
    out = np.full((h, w), np.nan, np.float32)
    rounds = {}
    n = -(-w // WARP)
    for y in range(h):
        warp = _RowWarp(disp, cost, y)
        warp.load(0)
        warp.load(1)
        ps = [warp.prepare(0), None]
        for k in range(n):
            if k + 1 < n:
                ps[(k + 1) % 2] = warp.prepare(k + 1)
            warp.resolve(ps[k % 2], k, out)
        rounds.update({(y, k): r for k, r in enumerate(warp.rounds)})
    return out, rounds


# ---------------------------------------------------------------- cases

def _random_case(seed, h=16, w=27, d_range=8, min_disparity=-4):
    """tests/test_torch_refine.py's random maps: indices out of [0, D) on
    both sides, halves and 10 % +inf."""
    return _dda_random_case(seed, h, w, d_range, min_disparity)[:2]


def _nan_sobel_case():
    """+inf beside +inf: the Sobel's inf - inf is NaN, which compares
    false, so those pixels are not edges; finite pixels beside them are
    (an inf magnitude)."""
    disp, cost = _random_case(7, h=9, w=40)
    disp[3:6, 10:14] = np.inf
    disp[4, 20:30] = np.inf
    return disp, cost


def _propagating_run_case(w=100):
    """Row 2 is an edge from column 1 to W - 2 (rows 1 and 3 differ by
    more than the threshold), with a cost that falls rightward at every
    pixel's left neighbour's value: column 1 takes column 0's value, and
    it propagates over 98 columns, across the chunk boundaries at 32 and
    64, in one round a chunk."""
    h, d_range = 5, 8
    disp = np.zeros((h, w), np.float32)
    disp[1] = 0.0
    disp[3] = 7.0
    disp[2] = np.where(np.arange(w) % 2, 4.0, 5.0)
    disp[2, 0] = 2.0
    cost = np.full((d_range, h, w), 0.5, np.float32)
    cost[2, 2] = 0.25  # value 2 is cheaper than any own cost
    return disp, cost


def _changing_run_case(w=70):
    """A run whose value changes at every pixel: own costs fall
    rightward, so every pixel of row 2 takes its right neighbour's
    original value (a value dearer in the left column) and no output
    equals the one on its left. A frontier's rounds would settle one lane
    each; the lanes' outputs for the O input settle the run without a
    gather."""
    h, d_range = 5, 128
    disp = np.zeros((h, w), np.float32)
    disp[3] = 100.0
    disp[2] = (np.arange(w) % 100 + 1).astype(np.float32)
    cost = np.full((d_range, h, w), 0.9, np.float32)
    for x in range(w):
        # own, at its own column; dearer at the column on its left
        cost[int(disp[2, x]), 2, x] = np.float32(0.5 - 0.001 * x)
        if x:
            cost[int(disp[2, x]), 2, x - 1] = np.float32(0.8)
    return disp, cost


def _alternating_run_case(w=70):
    """The worst case for the rounds: along row 2 (distinct values), even
    columns keep their own value and odd columns take it, cheaper in its
    own column than theirs. So every odd column passes on a value that is
    neither the next column's nor the one after, and the next round
    starts there: two lanes a round."""
    h, d_range = 5, 128
    disp = np.zeros((h, w), np.float32)
    disp[3] = 100.0
    disp[2] = (np.arange(w) % 100 + 1).astype(np.float32)
    cost = np.full((d_range, h, w), 0.9, np.float32)
    for x in range(w):
        cost[int(disp[2, x]), 2, x] = 0.7 if x % 2 else 0.5
    return disp, cost


def _shape_case(h, w, seed=11):
    """A holey random map of (h, w) with a Sobel edge at most pixels."""
    return _random_case(seed + 13 * h + w, h=h, w=w)


NAMED = {
    "chain": lambda: _dda_chain_case()[:2],
    "random0": lambda: _random_case(0),
    "random1": lambda: _random_case(1),
    "random2": lambda: _random_case(2),
    "random_wide": lambda: _random_case(3, h=6, w=130, d_range=16),
    "min_disparity_3": lambda: _random_case(4, min_disparity=3),
    "inf_minus_inf": _nan_sobel_case,
    "propagating_run": _propagating_run_case,
    "changing_run": _changing_run_case,
    "alternating_run": _alternating_run_case,
    "all_inf": lambda: (np.full((6, 40), np.inf, np.float32),
                        np.zeros((4, 6, 40), np.float32)),
}
SHAPES = [(5, 1), (5, 2), (5, 3), (5, 31), (5, 32), (5, 33), (5, 65),
          (1, 40), (2, 40), (1, 1), (2, 2), (3, 3), (4, 64)]
CASES = list(NAMED) + [f"{h}x{w}" for h, w in SHAPES]


def _case(name):
    if name in NAMED:
        return NAMED[name]()
    h, w = (int(v) for v in name.split("x"))
    return _shape_case(h, w)


def _jax(disp, cost):
    d_range = cost.shape[0]
    return np.asarray(jax_refine.depth_discontinuity_adjustment(
        jnp.asarray(disp), jnp.asarray(cost),
        JaxOptions(min_disparity=0, max_disparity=d_range)))


@pytest.mark.parametrize("case", CASES)
def test_emulation_equals_plain_and_jax(case):
    """The emulated kernel, dda_plain and JAX agree bit for bit."""
    disp, cost = _case(case)
    ours, _ = emulate(disp, cost)
    plain = torch_dda.dda_plain(torch.as_tensor(disp),
                                torch.as_tensor(cost)).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(plain))
    np.testing.assert_array_equal(_bits(ours), _bits(_jax(disp, cost)))


@pytest.mark.parametrize("case", ["chain", "random0", "random_wide",
                                  "propagating_run", "changing_run",
                                  "alternating_run"])
def test_cases_adjust_something(case):
    """The cases change the map, and some adjustable pixel has an
    adjustable left neighbour, so its input waits on the order."""
    disp, cost = _case(case)
    out, _ = emulate(disp, cost)
    assert not np.array_equal(_bits(out), _bits(disp))
    t = torch.as_tensor(disp)
    adj = (torch_dda.edge_detect(t)
           & torch_dda._rounded_idx(t, cost.shape[0])[1]).numpy()
    assert (adj[:, 1:] & adj[:, :-1]).any()


@pytest.mark.parametrize("h,w", [(1, 40), (2, 40), (2, 2), (1, 1), (5, 2)])
def test_no_interior_copies_the_map(h, w):
    """Without interior pixels the mask is empty: the map comes back as
    it is, with no round."""
    disp, cost = _shape_case(h, w)
    out, rounds = emulate(disp, cost)
    np.testing.assert_array_equal(_bits(out), _bits(disp))
    assert not any(rounds.values())


def test_propagating_run_crosses_chunks_in_one_round_each():
    """Column 0's value reaches column W - 2 through both chunk
    boundaries, each chunk settling it in one round."""
    disp, cost = _propagating_run_case()
    out, rounds = emulate(disp, cost)
    assert (out[2, 1:-1] == 2.0).all() and out[2, -1] == disp[2, -1]
    assert [rounds[(2, k)] for k in range(4)] == [1, 1, 1, 1]


def test_changing_run_needs_no_gather_round():
    """Each pixel takes its right neighbour's value: the lanes' outputs
    for their O input settle all 68, and the carry into the second chunk
    is lane 0's own value, so no round gathers."""
    disp, cost = _changing_run_case()
    out, rounds = emulate(disp, cost)
    np.testing.assert_array_equal(out[2, 1:-1], disp[2, 2:])
    assert [rounds[(2, k)] for k in range(3)] == [0, 0, 0]


def test_alternating_run_takes_a_round_two_lanes():
    """The worst case settles two lanes a gather round: 15 rounds in the
    first chunk (column 1 settles in the first pass from L), 16 in the
    next, whose lane 0 starts from the carry's value (V)."""
    disp, cost = _alternating_run_case()
    out, rounds = emulate(disp, cost)
    x = np.arange(1, disp.shape[1] - 1)
    np.testing.assert_array_equal(out[2, x], disp[2, x - x % 2])
    assert rounds[(2, 0)] == 15 and rounds[(2, 1)] == 16


def test_changing_run_is_adjusted_by_the_stage():
    """The stage gives the changing run's outputs, the right neighbours'
    values, on the CPU."""
    from adcensus_torch.stages import refine as torch_refine

    disp, cost = _changing_run_case()
    ours = torch_refine.depth_discontinuity_adjustment(
        torch.as_tensor(disp), torch.as_tensor(cost),
        ADCensusOptions(max_disparity=cost.shape[0])).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(emulate(disp, cost)[0]))


def test_block_holds_whole_warps():
    """A block is WARPS whole warps, a row each."""
    assert WARP == 32 and 4 <= WARPS <= 8
