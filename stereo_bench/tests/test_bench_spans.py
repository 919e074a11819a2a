"""The readers of the program's spans (stereo_bench/spans.py and the
metrics that use it) on synthetic traces and spans, on the CPU: launch
calls matched to device operations in order, kind by kind, and nothing
matched when the counts differ; idle time split by overlap among the
innermost spans; both closures; None on an empty trace and on a program
that records no spans; and the trace's time line against the installed
torch's exporter."""
import json
import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_bench import harness, spans
from stereo_bench.trace import TraceData, covered

from adcensus_torch.utils import profiling

BASE = 227 * spans.BASE_PERIOD_NS  # a base time of the exporter's rule
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine")


def span(request, sid, parent, name, start_us, end_us):
    return profiling.Span(request, sid, parent, name,
                          BASE + int(start_us * 1000),
                          BASE + int(end_us * 1000))


# Two requests of `match` (µs on the trace's time line). The first:
# copies in, cost with two kernels (the second launched while the first
# runs), wta with one, the copy back and its sync; the caller's own time
# between the two; the second: one cost kernel.
SPANS = [
    span(1, 2, 1, "entry.h2d", 105, 110),
    span(1, 3, 1, "cost", 110, 140),
    span(1, 4, 1, "wta", 140, 170),
    span(1, 5, 1, "entry.d2h", 180, 195),
    span(1, 1, None, "match", 100, 200),
    span(2, 7, 6, "cost", 225, 255),
    span(2, 6, None, "match", 220, 260),
]
RUNTIME = [
    (50, 51, "cudaDeviceSynchronize"),      # the caller's, before
    (106, 106.5, "cudaMemcpyAsync"),
    (115, 116, "cudaLaunchKernel"),
    (120, 121, "cudaLaunchKernel"),
    (145, 146, "cudaLaunchKernelExC"),
    (181, 182, "cudaMemcpyAsync"),
    (182, 194, "cudaStreamSynchronize"),
    (230, 231, "cuLaunchKernel"),
    (300, 301, "cudaDeviceSynchronize"),    # the caller's, after
]
OPS = [
    (107, 109, "Memcpy HtoD", "gpu_memcpy"),
    (116, 125, "k1", "kernel"),
    (125, 138, "k2", "kernel"),
    (150, 160, "k3", "kernel"),
    (190, 192, "Memcpy DtoH", "gpu_memcpy"),
    (231, 250, "k4", "kernel"),
]
# idle (µs) by innermost span: worked out by hand from the above
IDLE = {"root": 5 + 10 + 5 + 5 + 5, "entry.h2d": 2 + 1, "cost": 6 + 2 + 6 + 5,
        "wta": 10 + 10, "entry.d2h": 10 + 3, None: 20}
DEVICE = {"entry.h2d": 2, "cost": 9 + 13 + 19, "wta": 10, "entry.d2h": 2}


def trace_of(runtime=RUNTIME, ops=OPS, pairs=2):
    t = TraceData(list(ops), list(runtime))
    t.pairs = pairs
    return t


@pytest.fixture
def recorded(monkeypatch):
    """The program's spans are SPANS."""
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))


def test_time_line_is_the_exporters(tmp_path):
    """A span's stamps, put on the trace's time line, hold the host ops
    the profiler recorded inside it; the rule gives the exporter's base."""
    profiling.clear()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            (x + 1).sum()
    (s,) = profiling.spans()
    profiling.clear()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    base = int(raw["baseTimeNanoseconds"])
    assert base == s.start_ns // spans.BASE_PERIOD_NS * spans.BASE_PERIOD_NS
    ops = [e for e in raw["traceEvents"]
           if e.get("ph") == "X" and e.get("name") in ("aten::add",
                                                       "aten::sum")]
    assert {e["name"] for e in ops} == {"aten::add", "aten::sum"}
    start, end = spans.to_trace_us(s.start_ns), spans.to_trace_us(s.end_ns)
    for e in ops:
        assert start <= float(e["ts"]) <= float(e["ts"]) + e["dur"] <= end


def test_launches_match_operations_in_order_kind_by_kind():
    m = [(x.call_start, x.start, x.end, x.name)
         for x in spans.matched_launches(RUNTIME, OPS)]
    assert m == [(115, 116, 125, "k1"), (120, 125, 138, "k2"),
                 (145, 150, 160, "k3"), (230, 231, 250, "k4"),
                 (106, 107, 109, "Memcpy HtoD"),
                 (181, 190, 192, "Memcpy DtoH")]
    # the second kernel starts after the third's launch: order, not
    # start time, files it under cost
    a = spans.attribute(trace_of(), SPANS)
    assert (a.requests, a.read, a.pairs) == (2, 2, 2)
    assert a.device == pytest.approx(DEVICE)


@pytest.mark.parametrize("drop", [
    (145, 146, "cudaLaunchKernelExC"), (181, 182, "cudaMemcpyAsync")])
def test_unequal_counts_leave_the_request_out(drop):
    runtime = [r for r in RUNTIME if r != drop]
    assert spans.matched_launches(runtime, OPS) is None
    a = spans.attribute(trace_of(runtime), SPANS)
    assert (a.requests, a.read, a.pairs) == (2, 1, 1)
    assert a.device == pytest.approx({"cost": 19})
    assert a.idle == pytest.approx({"root": 10, "cost": 11, None: 0})
    assert a.busy_us + a.idle_us == pytest.approx(40)


def test_a_graph_replay_is_read_for_idle_time_only():
    runtime = RUNTIME + [(146, 147, "cudaGraphLaunch")]
    ops = OPS + [(160, 161, "k5", "kernel")]
    a = spans.attribute(trace_of(runtime, ops), SPANS)
    assert a.device is None and a.read == 2
    assert sum(a.idle.values()) == pytest.approx(a.idle_us)
    assert a.idle["wta"] == pytest.approx(19)


def test_a_memset_is_a_kind_of_its_own():
    runtime = RUNTIME + [(150, 151, "cudaMemsetAsync")]
    ops = OPS + [(170.5, 171, "Memset (Device)", "gpu_memset")]
    a = spans.attribute(trace_of(runtime, ops), SPANS)
    assert a.device["wta"] == pytest.approx(10.5)
    ops = OPS + [(170.5, 171, "k5", "kernel")]
    assert spans.matched_launches(runtime, ops) is None


def test_idle_is_split_by_overlap_among_innermost_spans():
    a = spans.attribute(trace_of(), SPANS)
    assert a.idle == pytest.approx(IDLE)


def test_both_closures_hold():
    a = spans.attribute(trace_of(), SPANS)
    assert a.busy_us == pytest.approx(covered(trace_of().busy()))
    assert sum(a.device.values()) == pytest.approx(a.busy_us)
    assert sum(a.idle.values()) == pytest.approx(a.idle_us)
    assert a.busy_us + a.idle_us == pytest.approx(160)


def test_syncs_count_inside_spans_only():
    a = spans.attribute(trace_of(), SPANS)
    assert a.syncs == 1
    assert spans.self_segments([]) == []


def test_readers_give_ms_a_pair(recorded):
    t = trace_of()
    read = {m: harness._load_module(harness.find_reader("metrics", m)).read
            for m in [f"stages.{s}.{q}.stream" for s in STAGES
                      for q in ("device_ms", "idle_ms")]
            + ["entry.idle_ms.stream", "device.syncs.stream",
               "entry.group_rule.idle_ms.batch", "entry.h2d.idle_ms.batch",
               "entry.replay.idle_ms.batch"]}
    got = {m: r(t) for m, r in read.items()}
    assert got["stages.cost.device_ms.stream"] == pytest.approx(41 / 2e3)
    assert got["stages.wta.device_ms.stream"] == pytest.approx(10 / 2e3)
    assert got["stages.arms.device_ms.stream"] == 0.0
    assert got["stages.cost.idle_ms.stream"] == pytest.approx(19 / 2e3)
    assert got["stages.wta.idle_ms.stream"] == pytest.approx(20 / 2e3)
    assert got["entry.idle_ms.stream"] == pytest.approx((30 + 3 + 13) / 2e3)
    assert got["entry.h2d.idle_ms.batch"] == pytest.approx(3 / 2e3)
    assert got["entry.replay.idle_ms.batch"] == 0.0
    assert got["device.syncs.stream"] == pytest.approx(0.5)
    stage_idle = sum(got[f"stages.{s}.idle_ms.stream"] for s in STAGES)
    outside = IDLE[None] / 2e3
    assert stage_idle + got["entry.idle_ms.stream"] + outside == \
        pytest.approx(105 / 2e3)
    stage_dev = sum(got[f"stages.{s}.device_ms.stream"] for s in STAGES)
    assert stage_dev + 4 / 2e3 == pytest.approx(55 / 2e3)


def test_none_on_an_empty_trace(recorded):
    for t in (trace_of([], []), trace_of(ops=[]), trace_of(pairs=0)):
        assert spans.device_ms(t, "cost") is None
        assert spans.syncs(t) is None
    assert spans.idle_ms(trace_of(ops=[]), "cost") is None


def test_none_without_the_programs_spans(monkeypatch):
    """A program that records no spans, or has no recorder at all (the
    parent of the recorder), reads None and raises nothing."""
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert spans.idle_ms(trace_of(), "cost") is None
    monkeypatch.delattr(profiling, "spans")
    assert spans.recorded() == []
    assert spans.device_ms(trace_of(), "cost") is None
    assert spans.syncs(trace_of()) is None


def test_spans_outside_the_traced_stretch_are_left_out():
    early = span(9, 90, None, "match", 10, 40)  # before the first call
    a = spans.attribute(trace_of(), SPANS + [early])
    assert (a.requests, a.read) == (2, 2)
    assert a.idle == pytest.approx(IDLE)


def test_a_cpu_traced_run_leaves_the_span_metrics_out():
    """The tiny cell traced on the CPU: the profiler sees no device, so
    the new metrics are absent and nothing raises."""
    from conftest import run_tiny

    out = run_tiny("cones.stream", trace=True)
    assert out.correct
    assert not any(m.startswith(("stages.cost.", "entry.idle", "device.syncs"))
                   for m in out.metrics)


def _drifting(rate, offset=0.0):
    """Twenty requests of 1 ms, kernels launched at seeded irregular
    times in cost and wta, each running 20 µs from its launch on the
    host's clock; the device's clock is ``offset`` behind the host's at
    the start and runs ``rate`` faster."""
    rng = random.Random(7)
    raw, runtime, ops, sid = [], [], [], 0
    for k in range(20):
        t = 1000.0 + 1200.0 * k
        sid += 3
        raw += [span(k + 1, sid + 1, sid, "cost", t + 10, t + 500),
                span(k + 1, sid + 2, sid, "wta", t + 500, t + 990),
                span(k + 1, sid, None, "match", t, t + 1000)]
        host = t + 20
        while host < t + 960:
            runtime.append((host, host + 3, "cudaLaunchKernel"))
            dev = host - offset + rate * (host - 1000.0)
            ops.append((dev, dev + 20, "k", "kernel"))
            host += rng.uniform(60.0, 140.0)
    runtime += [(0.0, 1.0, "cudaDeviceSynchronize"),
                (30000.0, 30001.0, "cudaDeviceSynchronize")]
    t = trace_of(runtime, ops, pairs=20)
    return t, raw


@pytest.mark.parametrize("rate, offset", [
    (0.0025, 0.0), (-0.0025, 0.0), (-0.0044, 650.0)])
def test_the_device_clock_is_aligned_to_the_hosts(rate, offset):
    """A device clock drifting 2.5 ms a second, or starting 0.65 ms
    behind and drifting 4.4 ms a second (what an H100 showed), is brought
    back onto the host's at the device's wake-ups, and time is attributed
    as without the drift."""
    still, raw = _drifting(0.0)
    drifted, _ = _drifting(rate, offset)
    anchors = spans.clock_anchors(drifted)
    assert len(anchors) > 100
    for dev, o in anchors:
        host = (dev + offset + rate * 1000.0) / (1 + rate)
        assert o == pytest.approx(host - dev, abs=1e-6)
    want, got = spans.attribute(still, raw), spans.attribute(drifted, raw)
    assert got.read == want.read == 20
    assert got.device == pytest.approx(want.device)
    assert got.idle == pytest.approx(want.idle, abs=0.5)


def test_without_the_alignment_drift_misfiles_time(monkeypatch):
    still, raw = _drifting(0.0)
    drifted, _ = _drifting(0.01)
    want = spans.attribute(still, raw)
    monkeypatch.setattr(spans, "clock_anchors", lambda trace, sp=(): [])
    got = spans.attribute(drifted, raw)
    assert got.idle != pytest.approx(want.idle, abs=0.5)


def test_request_boundaries_snap_to_the_devices_idle_gap():
    gaps = [(100.0, 300.0), (400.0, 410.0)]
    assert spans._snap(gaps, 150.0) == 200.0      # inside a gap
    assert spans._snap(gaps, 350.0) in (200.0, 405.0)
    assert spans._snap(gaps, 320.0) == 200.0      # the nearest gap
    assert spans._snap(gaps, 410.0 + spans.SNAP_US + 1) == \
        410.0 + spans.SNAP_US + 1                 # none near: unmoved
    assert spans._snap([], 5.0) == 5.0
