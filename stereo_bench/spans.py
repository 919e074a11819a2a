"""The program's spans laid on the device trace: where each stage's
device time and the device's idle time fall.

The program records spans while the profiler runs
(``adcensus_torch.utils.profiling.spans()``: request, id, parent, name,
start and end in Unix ns of CLOCK_REALTIME, the clock of the profiler's
host events). The profiler's Chrome trace gives times in microseconds
from its base time, ``baseTimeNanoseconds``: the wall time floored to
periods of ``BASE_PERIOD_NS`` (libkineto's rule, which the exporters of
torch 2.11 and 2.13 follow). ``to_trace_us`` applies it, so the spans
and the trace's host calls share one time line. The device's
operations are off it (on an H100, by up to 0.65 ms where the profiler
starts, drifting up to 4.4 ms a second): ``on_host_clock`` brings them
back, anchored where the device wakes from idling at a kernel launch and
where a wait returns on a copy to the device (``clock_anchors``).

On that line, the host's *innermost* open span at each instant is the
span less the parts its children cover (its self time). Then:

* a device operation belongs to the span in which the host called into
  CUDA to start it. ``TraceData`` keeps no correlation ids, so launch
  calls (``LAUNCHES``) are matched to device operations in order, kind
  by kind: right on one stream, where operations run in the order they
  were issued;
* an idle stretch of the device belongs to the innermost span open on
  the host during it, split by overlap where several are; time outside
  every span is the caller's.

The stretch is read request by request: a request's window runs from
its root span's start to the next request's (``requests``). The
profiler drops records now and then (on an H100, the first few
operations of a stretch, and once a burst of some hundred), so a
request whose launch calls and device operations differ in number, in
any kind, is left out whole, its idle time too, and the readings are
per pair of the requests read. Where a graph replay launches operations
with no call of their own, nothing is matched and every request is read
for its idle time. Every reading returns None where the program
recorded no span (a program without the recorder) or the trace has no
device operation.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

from stereo_bench.trace import covered, union

BASE_PERIOD_NS = 7_889_238 * 10**9
# device operation category -> prefixes of the host calls that start one
LAUNCHES = (("kernel", ("cudaLaunchKernel", "cuLaunchKernel")),
            ("gpu_memcpy", ("cudaMemcpy",)),
            ("gpu_memset", ("cudaMemsetAsync",)))
# host calls that wait on the device: the waits, and the blocking copy
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
SYNCS = WAITS + ("cudaMemcpy",)
# the clocks' alignment (clock_anchors): the idle gaps it reads; how far
# a gap's end may lie from where the last anchors foresee it, a fixed
# slack and a share of the time since the last anchor (the trend's change
# of rate); the stretch whose gaps vote on the offset (short, so that the
# drift within it stays inside the slack), the fewest gaps that vote, and
# how far from no offset they may look; the trend's stretch; gaps missed
# in a row before the offset is voted again; anchors whose median is
# taken
ANCHOR_GAP_US = 50.0
ANCHOR_SLACK_US = 20.0
ANCHOR_DRIFT = 0.002
ANCHOR_VOTE_US = 5_000.0
ANCHOR_VOTES = 4
ANCHOR_SEARCH_US = 5_000.0
ANCHOR_TREND_US = 100_000.0
ANCHOR_LOST = 8
ANCHOR_MEDIAN = 7
# how far from a request's start its operations' boundary may be moved
# to the device's idle gap (requests())
SNAP_US = 500.0
OUTSIDE = None  # the key of time in no span
# host calls that start device work, a graph replay's among them
WAKES = tuple(p for _, ps in LAUNCHES for p in ps) + ("cudaGraphLaunch",)


class TSpan(NamedTuple):
    """A span on the trace's time line (microseconds)."""

    request: int
    id: int
    parent: Optional[int]
    name: str
    start: float
    end: float


def to_trace_us(t_ns: int) -> float:
    """Unix ns -> the Chrome trace's microseconds."""
    return (t_ns - t_ns // BASE_PERIOD_NS * BASE_PERIOD_NS) / 1e3


def recorded() -> List:
    """The program's spans, or [] where it records none."""
    try:
        from adcensus_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def extent(trace) -> Optional[Tuple[float, float]]:
    """The first and last instant that the trace recorded, host calls
    and device operations alike."""
    times = [t for s, e, *_ in trace.runtime + trace.device_ops
             for t in (s, e)]
    return (min(times), max(times)) if times else None


def trace_spans(trace, raw=None) -> List[TSpan]:
    """The spans (``raw``: default the program's) that lie in the
    traced stretch, on the trace's time line."""
    ext = extent(trace)
    if ext is None:
        return []
    out = []
    for s in recorded() if raw is None else raw:
        sp = TSpan(s.request, s.id, s.parent, s.name,
                   to_trace_us(s.start_ns), to_trace_us(s.end_ns))
        if ext[0] <= sp.start and sp.end <= ext[1]:
            out.append(sp)
    return out


def self_segments(spans: List[TSpan]) -> List[Tuple[float, float, TSpan]]:
    """(start, end, span) of each span's self time, sorted: the
    innermost span open at each instant covered by one."""
    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    segs = []
    for s in spans:
        t = s.start
        for c in sorted(kids[s.id], key=lambda c: c.start):
            if c.start > t:
                segs.append((t, c.start, s))
            t = max(t, c.end)
        if s.end > t:
            segs.append((t, s.end, s))
    segs.sort(key=lambda g: g[0])
    return segs


def key_of(span: TSpan) -> str:
    """The name time is filed under: an entry point's root span files
    under "root", every other span under its own name."""
    return "root" if span.parent is None else span.name


class _Timeline:
    """Lookup of the innermost span at an instant."""

    def __init__(self, segs):
        self.segs = segs
        self.starts = [g[0] for g in segs]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.segs[i][1]:
            return key_of(self.segs[i][2])
        return OUTSIDE


def _wake_offsets(gap, kernels, wakes, lo, hi):
    """Offsets (host less device time) in [lo, hi] that put a kernel
    launch call (``kernels``, sorted starts) at the end of ``gap``
    (device time) with no call of ``wakes`` inside the gap, nearest the
    middle of [lo, hi] first."""
    g0, g1 = gap
    mid = (lo + hi) / 2
    first = bisect.bisect_left(kernels, g1 + lo)
    last = bisect.bisect_right(kernels, g1 + hi)
    out = []
    for c in sorted(kernels[first:last], key=lambda c: abs(c - g1 - mid)):
        o = c - g1
        if (bisect.bisect_right(wakes, g0 + o + ANCHOR_SLACK_US)
                == bisect.bisect_left(wakes, c)):
            out.append(o)
    return out


def _vote(gaps, kernels, wakes) -> Optional[float]:
    """The offset that most of ``gaps`` agree on, to ANCHOR_SLACK_US (of
    equals, the smallest: the clocks are set to agree), or None if fewer
    than a third of them do."""
    votes = sorted(o for g in gaps
                   for o in _wake_offsets(g, kernels, wakes,
                                          -ANCHOR_SEARCH_US,
                                          ANCHOR_SEARCH_US))
    best, lo = None, 0
    for hi in range(len(votes)):
        while votes[hi] - votes[lo] > 2 * ANCHOR_SLACK_US:
            lo += 1
        median = votes[(lo + hi) // 2]
        key = (hi - lo + 1, -abs(median))
        if best is None or key > best[0]:
            best = (key, median)
    if best is None or 3 * best[0][0] < len(gaps):
        return None
    return best[1]


def _copy_anchors(trace, spans: List[TSpan]) -> List[Tuple[float, float]]:
    """(device time, host less device time) at the end of each copy to
    the device that a wait in its ``entry.h2d`` span waited for: the
    copy ends just before the wait returns. A copy's call and its
    operation are paired in order, from the last (the profiler drops
    records where it starts)."""
    h2d = sorted((s.start, s.end) for s in spans if s.name == "entry.h2d")
    starts = [h[0] for h in h2d]
    calls = sorted(trace.runtime)
    copies = []
    for k, (s, e, n) in enumerate(calls):
        i = bisect.bisect_right(starts, s) - 1
        if not n.startswith("cudaMemcpy") or i < 0 or s > h2d[i][1]:
            continue
        wait = next((c for c in calls[k + 1:k + 8]
                     if c[2] in WAITS and c[0] >= e and c[1] <= h2d[i][1]),
                    None)
        copies.append(wait[1] if wait else None)
    ops = sorted(o for o in trace.device_ops
                 if o[3] == "gpu_memcpy" and "HtoD" in o[2])
    return [(op[1], wait - op[1]) for wait, op in zip(copies[::-1], ops[::-1])
            if wait is not None]


def clock_anchors(trace, spans: List[TSpan] = ()
                  ) -> List[Tuple[float, float]]:
    """(device time, host less device time), sorted: where the device
    woke from an idle gap of at least ``ANCHOR_GAP_US`` at a kernel
    launch, and where a wait returned on a copy to the device
    (``_copy_anchors``, from ``spans``).

    The trace stamps host calls on the host's clock and device
    operations on the device's, converted apart: on an H100 the two
    differed by up to 0.65 ms where the profiler started and drifted by
    up to 4.4 ms a second, in either direction. An idle device runs a
    kernel just after the host's call that launches it, and the host
    made no launch call while the device idled (``WAKES``; a copy's or a
    graph's operations start long after their calls, so they bound the
    gap but anchor nothing). The offset is first the one that most gaps
    of the next ``ANCHOR_VOTE_US`` (at least ``ANCHOR_VOTES`` gaps) agree
    on; then each gap takes the call nearest the offset foreseen from the
    last anchors' trend, within ``ANCHOR_SLACK_US`` and ``ANCHOR_DRIFT``
    of the time since the last anchor; after ``ANCHOR_LOST`` gaps in a
    row with none, the offset is voted again. Each offset then becomes
    the median of the ``ANCHOR_MEDIAN`` anchors around it."""
    busy = trace.busy()
    wakes = sorted(s for s, _, n in trace.runtime if n.startswith(WAKES))
    kernels = sorted(s for s, _, n in trace.runtime
                     if n.startswith(LAUNCHES[0][1]))
    gaps = [(g0, g1) for (_, g0), (g1, _) in zip(busy, busy[1:])
            if g1 - g0 >= ANCHOR_GAP_US]
    anchors: List[Tuple[float, float]] = []
    found: List[Tuple[float, float]] = []  # since the last vote
    misses, guess = ANCHOR_LOST, None
    for k, gap in enumerate(gaps):
        if misses >= ANCHOR_LOST:
            ahead = [g for g in gaps[k:] if g[1] <= gap[1] + ANCHOR_VOTE_US]
            if len(ahead) < ANCHOR_VOTES:
                ahead = gaps[k:k + ANCHOR_VOTES]
            guess, found, misses = _vote(ahead, kernels, wakes), [], 0
            if guess is None:
                misses = ANCHOR_LOST
                continue
        if found:
            t1, o1 = found[-1]
            rate = 0.0
            early = [a for a in found if a[0] >= t1 - ANCHOR_TREND_US]
            if len(early) >= 2 and t1 > early[0][0]:
                rate = (o1 - early[0][1]) / (t1 - early[0][0])
            mid = o1 + rate * (gap[1] - t1)
            tol = ANCHOR_SLACK_US + ANCHOR_DRIFT * (gap[1] - t1)
        else:
            mid, tol = guess, 2 * ANCHOR_SLACK_US
        offsets = _wake_offsets(gap, kernels, wakes, mid - tol, mid + tol)
        if offsets:
            found.append((gap[1], offsets[0]))
            anchors.append(found[-1])
            misses = 0
        else:
            misses += 1
    anchors = sorted(anchors + _copy_anchors(trace, spans))
    out = []
    for k, (t, _) in enumerate(anchors):
        h = min(ANCHOR_MEDIAN // 2, k, len(anchors) - 1 - k)
        near = sorted(o for _, o in anchors[k - h:k + h + 1])
        out.append((t, near[h]))
    return out


def on_host_clock(trace, spans: List[TSpan] = ()
                  ) -> List[Tuple[float, float, str, str]]:
    """The trace's device operations moved onto the host's clock by the
    offset interpolated between ``clock_anchors`` (the nearest one's
    beyond them), each whole, so that durations stay as measured."""
    anchors = clock_anchors(trace, spans)
    if not anchors:
        return sorted(trace.device_ops)
    at = [a[0] for a in anchors]

    def offset(t):
        i = bisect.bisect_right(at, t)
        if i == 0:
            return anchors[0][1]
        if i == len(anchors):
            return anchors[-1][1]
        (t0, o0), (t1, o1) = anchors[i - 1], anchors[i]
        return o0 + (o1 - o0) * (t - t0) / (t1 - t0) if t1 > t0 else o1

    return sorted((s + offset(s), e + offset(s), n, c)
                  for s, e, n, c in trace.device_ops)


class Launch(NamedTuple):
    """A device operation with the host call matched to it."""

    call_start: float
    call_end: float
    start: float
    end: float
    name: str


def matched_launches(calls, ops) -> Optional[List[Launch]]:
    """Each device operation of ``ops`` ((start, end, name, category))
    with the launch call of ``calls`` ((start, end, name)) matched to it
    in order, kind by kind; None if a kind's counts of calls and
    operations differ."""
    out = []
    for cat, prefixes in LAUNCHES:
        kind_calls = sorted(c for c in calls if c[2].startswith(prefixes))
        kind_ops = sorted(o for o in ops if o[3] == cat)
        if len(kind_calls) != len(kind_ops):
            return None
        out += [Launch(c[0], c[1], o[0], o[1], o[2])
                for c, o in zip(kind_calls, kind_ops)]
    return out


class Request(NamedTuple):
    """One request's window on the host's clock, its host calls, and its
    launches (None where a graph replay leaves them unmatched)."""

    start: float
    end: float
    calls: list
    launches: Optional[List[Launch]]


def windows(spans: List[TSpan], last_end: float) -> List[Tuple[float, float]]:
    """Each request's window: from its root span's start to the next
    root's start, so that the caller's time after a request, and device
    work the request left queued, count with it; the last ends at the
    later of its root's end and ``last_end``."""
    starts = sorted(s.start for s in spans if s.parent is None)
    ends = starts[1:] + [max(last_end, max(s.end for s in spans))]
    return list(zip(starts, ends))


def _slice(items, starts, lo, hi):
    return items[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]


def requests(trace, spans: List[TSpan], ops) -> Tuple[int, List[Request]]:
    """The number of requests in the stretch, and those read: whole, or
    not at all. Where no graph replay hides its operations' launches, a
    request whose launch calls and device operations (``ops``, on the
    host's clock) differ in number, kind by kind, is left out (the
    profiler drops records now and then); with a graph replay every
    request is read, unmatched."""
    calls = sorted(trace.runtime)
    call_starts = [c[0] for c in calls]
    op_starts = [o[0] for o in ops]
    wins = windows(spans, max(e for _, e, _, _ in ops))
    matchable = not any(n.startswith("cudaGraphLaunch") for *_, n in calls)
    gaps = _gaps(union([(s, e) for s, e, _, _ in ops]), wins[0][0],
                 wins[-1][1])[1]
    # the operations' boundaries: the windows' inner ones moved to the
    # device's idle gaps
    cuts = ([wins[0][0]] + [_snap(gaps, lo) for lo, _ in wins[1:]]
            + [wins[-1][1]])
    read = []
    for k, (lo, hi) in enumerate(wins):
        w_calls = _slice(calls, call_starts, lo, hi)
        launches = None
        if matchable:
            w_ops = _slice(ops, op_starts, cuts[k], cuts[k + 1])
            launches = matched_launches(w_calls, w_ops)
            if launches is None:
                continue
        read.append(Request(lo, hi, w_calls, launches))
    return len(wins), read


def _snap(gaps, t: float) -> float:
    """The middle of the device's idle gap that holds ``t``, or of the
    one nearest it within ``SNAP_US``; else ``t``. A request's
    operations are split from the next's there: the device idles between
    one-pair requests, and the clocks' alignment may err by some tens of
    microseconds at the boundary."""
    i = bisect.bisect_right([g[0] for g in gaps], t)

    def off(g):
        return 0.0 if g[0] <= t <= g[1] else min(abs(t - g[0]), abs(t - g[1]))

    near = min(gaps[max(i - 1, 0):i + 1], key=off, default=None)
    if near is None or off(near) > SNAP_US:
        return t
    return (near[0] + near[1]) / 2


@dataclass
class Attribution:
    """Device and idle time of the requests read, by innermost span
    (key_of; OUTSIDE for none), in microseconds, and the host's waits on
    the device inside spans."""

    requests: int                   # requests in the traced stretch
    read: int                       # requests read
    pairs: float                    # pairs of the requests read
    busy_us: float = 0.0            # device busy in their windows
    idle_us: float = 0.0            # their windows less busy_us
    idle: Dict[Optional[str], float] = field(default_factory=dict)
    device: Optional[Dict[Optional[str], float]] = None  # None: unmatched
    syncs: int = 0


def _gaps(busy, lo, hi):
    """``busy`` clipped to [lo, hi), and the gaps between."""
    busy = [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi]
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return busy, gaps


_last: list = []  # (trace, its spans, the attribution) of the last call


def attribute(trace, raw=None) -> Optional[Attribution]:
    """The attribution of the traced stretch's requests read
    (``requests``), or None without spans, device operations or a
    request read. The readers of one trace share one computation."""
    raw = recorded() if raw is None else list(raw)
    if _last and _last[0] is trace and _last[1] == (raw, trace.pairs):
        return _last[2]
    out = _attribute(trace, raw)
    _last[:] = [trace, (raw, trace.pairs), out]
    return out


def _attribute(trace, raw) -> Optional[Attribution]:
    spans = trace_spans(trace, raw)
    if not trace.device_ops or not any(s.parent is None for s in spans):
        return None
    ops = on_host_clock(trace, spans)
    n, read = requests(trace, spans, ops)
    if not read:
        return None
    out = Attribution(n, len(read), trace.pairs * len(read) / n)
    line = _Timeline(self_segments(spans))
    segs = line.segs
    idle: Dict[Optional[str], float] = defaultdict(float)
    device: Dict[Optional[str], float] = defaultdict(float)
    busy_all = union([(s, e) for s, e, _, _ in ops])
    busy_starts = [b[0] for b in busy_all]
    for req in read:
        first = max(bisect.bisect_left(busy_starts, req.start) - 1, 0)
        last = bisect.bisect_left(busy_starts, req.end)
        busy, gaps = _gaps(busy_all[first:last], req.start, req.end)
        out.busy_us += covered(busy)
        out.idle_us += covered(gaps)
        # idle by innermost span: sweep the gaps against the segments
        j = max(bisect.bisect_left(line.starts, req.start) - 1, 0)
        for g0, g1 in gaps:
            inside = 0.0
            while j < len(segs) and segs[j][1] <= g0:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < g1:
                s0, s1, sp = segs[k]
                part = min(g1, s1) - max(g0, s0)
                if part > 0:
                    idle[key_of(sp)] += part
                    inside += part
                k += 1
            idle[OUTSIDE] += (g1 - g0) - inside
        for launch in req.launches or ():
            device[line.at(launch.call_start)] += launch.end - launch.start
        out.syncs += sum(1 for s, _, n in req.calls
                         if n in SYNCS and line.at(s) is not OUTSIDE)
    out.idle = dict(idle)
    out.device = dict(device) if read[0].launches is not None else None
    return out


def device_ms(trace, name: str) -> Optional[float]:
    """Device ms a pair of the operations launched in spans ``name``."""
    a = attribute(trace)
    if a is None or a.device is None or a.pairs == 0:
        return None
    return a.device.get(name, 0.0) / 1e3 / a.pairs


def idle_ms(trace, *names: str) -> Optional[float]:
    """Device idle ms a pair while the host's innermost span was one of
    ``names``."""
    a = attribute(trace)
    if a is None or a.pairs == 0:
        return None
    return sum(a.idle.get(n, 0.0) for n in names) / 1e3 / a.pairs


def syncs(trace) -> Optional[float]:
    """Host calls a pair that wait on the device, inside spans."""
    a = attribute(trace)
    if a is None or a.pairs == 0:
        return None
    return a.syncs / a.pairs
