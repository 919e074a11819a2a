"""The four-card cell's spans against the card's trace: full-size pairs
through ``ShardedMatcher`` on 4 cards, traced on card 0 as the benchmark
traces them. The launch calls that ``spans.py`` matches to device
operations by order are held against the raw trace's correlation ids,
NCCL's kernels among them; every launch call lies in a stage, a
collective's or an entry span; and every per-layer reader of the cell
reads. Prints the counts.

    python -m pytest --noconftest -p no:cacheprovider -q -s -m cuda \\
        stereo_bench/tests/test_bench_sharded_cuda.py

from the root of a checkout on a machine with 4 cards; it skips without
them.
"""
import bisect
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "mb2014-full.sharded4"
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine")
SHARD = ("shard.broadcast", "shard.halo", "shard.all_gather",
         "shard.all_to_all")
ENTRY = ("root", "entry.h2d", "entry.d2h")
REQUESTS = 8
_run = []


@pytest.fixture
def traced():
    """(TraceData, the raw trace's events, the program's spans) of
    REQUESTS full-size pairs after two warm ones, made once."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    if _run:
        return _run[0]
    import numpy as np

    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.parallel.serve import ShardedMatcher
    from adcensus_torch.utils import profiling
    from stereo_bench import harness
    from stereo_bench import trace as trace_mod

    cell = harness.Cell.from_spec(harness.load_spec(ROOT), CELL)
    cell.traffic = dict(cell.traffic, pool_pairs=2)
    lefts, rights, _ = harness.make_pool(cell, 2 ** 31 + 41)
    events = []
    from_events = trace_mod.TraceData.__dict__["from_events"]

    def keep(evs):
        events.extend(evs)
        return from_events.__func__(trace_mod.TraceData, evs)

    with ShardedMatcher(ADCensusOptions(**cell.options()),
                        **cell.traffic["entry_args"]) as m:
        for k in range(2):
            m.match(lefts[k % 2], rights[k % 2])
        torch.cuda.synchronize()
        profiling.clear()
        trace_mod.TraceData.from_events = staticmethod(keep)
        try:
            pairs = [(np.array(lefts[k % 2]), np.array(rights[k % 2]))
                     for k in range(REQUESTS)]
            tracer = trace_mod.Tracer(torch, True)
            tracer.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for left, right in pairs:
                m.match(left, right)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
            trace = tracer.stop()
        finally:
            trace_mod.TraceData.from_events = from_events
    trace.window = window
    trace.pairs = REQUESTS
    trace.shape = (1988, 2632, 640)
    _run.append((trace, events, profiling.spans()))
    return _run[0]


def _offset_of(trace, sp):
    """``spans.on_host_clock``'s offset at a device time."""
    from stereo_bench import spans
    anchors = spans.clock_anchors(trace, sp)
    at = [a[0] for a in anchors]

    def offset(t):
        if not anchors:
            return 0.0
        i = bisect.bisect_right(at, t)
        if i == 0:
            return anchors[0][1]
        if i == len(anchors):
            return anchors[-1][1]
        (t0, o0), (t1, o1) = anchors[i - 1], anchors[i]
        return o0 + (o1 - o0) * (t - t0) / (t1 - t0) if t1 > t0 else o1

    return offset


@pytest.mark.cuda
def test_matched_launches_agree_with_correlation_ids(traced):
    from stereo_bench import spans
    from stereo_bench.trace import DEVICE_CATS, RUNTIME_CATS

    trace, events, raw = traced
    call_of = {}   # correlation id -> the launch call's start
    corr_of = {}   # (start, end, name) of a device operation -> its id
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = e.get("args", {}).get("correlation")
        s = float(e["ts"])
        if e.get("cat") in RUNTIME_CATS:
            call_of[corr] = s
        elif e.get("cat") in DEVICE_CATS:
            corr_of[(s, s + float(e["dur"]), e.get("name", ""))] = corr
    sp = spans.trace_spans(trace, raw)
    offset = _offset_of(trace, sp)
    raw_of = {(s + offset(s), e + offset(s), n): (s, e, n)
              for s, e, n, _ in trace.device_ops}
    n, read = spans.requests(trace, sp, spans.on_host_clock(trace, sp))
    wrong = nccl = nccl_wrong = total = 0
    for req in read:
        for launch in req.launches:
            key = raw_of[(launch.start, launch.end, launch.name)]
            total += 1
            bad = call_of.get(corr_of.get(key)) != launch.call_start
            wrong += bad
            if "nccl" in launch.name.lower():
                nccl += 1
                nccl_wrong += bad
    kinds = sorted({c[2] for c in trace.runtime
                    if c[2].startswith(spans.WAKES)})
    print(f"\n[spans] {CELL}: {len(read)} of {n} requests read; "
          f"{total} operations matched, {wrong} to a wrong call; NCCL "
          f"kernels {nccl}, {nccl_wrong} to a wrong call; launch calls "
          f"{kinds}")
    assert len(read) >= 0.75 * n
    assert nccl > 0
    assert wrong == 0


@pytest.mark.cuda
def test_every_launch_lies_in_a_stage_collective_or_entry_span(traced):
    from stereo_bench import spans

    trace, _, raw = traced
    sp = spans.trace_spans(trace, raw)
    line = spans._Timeline(spans.self_segments(sp))
    lo, hi = min(s.start for s in sp), max(s.end for s in sp)
    calls = [c for c in trace.runtime if c[2].startswith(spans.WAKES)
             and lo <= c[0] <= hi]
    keys = {line.at(c[0]) for c in calls}
    print(f"\n[spans] {CELL}: {len(calls)} launch calls under {sorted(keys)}")
    assert keys <= set(STAGES) | set(SHARD) | set(ENTRY)
    assert {"shard.halo", "shard.all_to_all", "shard.all_gather"} <= keys


@pytest.mark.cuda
def test_every_reader_of_the_cell_reads(traced):
    from stereo_bench import harness

    trace, _, _ = traced
    cell = harness.Cell.from_spec(harness.load_spec(ROOT), CELL)
    got = {m["name"]: harness._load_module(harness.find_reader(
        "metrics", m["name"])).read(trace) for m in cell.per_layer}
    print(f"\n[spans] {CELL}: {got}")
    assert all(v is not None for v in got.values()), got
    assert got["shard.link_pct.sharded4"] <= 100.0
