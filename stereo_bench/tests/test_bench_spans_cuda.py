"""The program's spans against the card's trace, on both stream cells,
traced as the benchmark traces them: every host-to-device copy of a
request lies in its entry.h2d span and every launch call in a stage or
entry span; launch calls and device operations agree in number in the
requests read, so every new stream metric reads; the device time of the
spans closes on the busy time, and their idle time on the idle time,
within 1 %. Prints the largest misalignment seen between span edges and
runtime calls.

    python -m pytest --noconftest -p no:cacheprovider -q -s -m cuda \\
        stereo_bench/tests/test_bench_spans_cuda.py

from the root of a checkout on a machine with a card; it skips without
one.
"""
import bisect
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

STREAM = ["cones.stream", "kitti.stream"]
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine")
ENTRY = ("root", "entry.h2d", "entry.d2h")
METRICS = [f"stages.{s}.{q}.stream" for s in STAGES
           for q in ("device_ms", "idle_ms")] + [
    "entry.idle_ms.stream", "device.syncs.stream"]
_runs = {}


@pytest.fixture
def traced():
    """cell -> (outcome, TraceData, the program's spans) of one --trace 1
    run of the cell, made once."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from adcensus_torch.utils import profiling
    from stereo_bench import harness
    from stereo_bench import trace as trace_mod

    def run(name):
        if name in _runs:
            return _runs[name]
        kept = []
        stop = trace_mod.Tracer.stop

        def keep(self):
            kept.append(stop(self))
            return kept[-1]

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        trace_mod.Tracer.stop = keep
        try:
            profiling.clear()
            cell = harness.Cell.from_spec(harness.load_spec(ROOT), name)
            out = harness.run_cell(cell, 2 ** 31 + 23, 2.0, True,
                                   device="cuda", log=lambda *a: None)
        finally:
            trace_mod.Tracer.stop = stop
        _runs[name] = (out, kept[0], profiling.spans())
        return _runs[name]

    return run


def _on_line(trace, raw):
    from stereo_bench import spans
    return spans.trace_spans(trace, raw)


def _outside(call, span):
    """How far the call (start, end, ...) sticks out of ``span``."""
    return max(0.0, span.start - call[0], call[1] - span.end)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", STREAM)
def test_every_new_metric_reads(traced, cell):
    out, _, _ = traced(cell)
    assert out.correct, out.checks
    missing = [m for m in METRICS if out.metrics.get(m, {}).get("value")
               is None]
    assert missing == []


@pytest.mark.cuda
@pytest.mark.parametrize("cell", STREAM)
def test_copies_to_the_card_lie_in_entry_h2d(traced, cell):
    from stereo_bench import spans

    _, trace, raw = traced(cell)
    sp = _on_line(trace, raw)
    n, read = spans.requests(trace, sp, spans.on_host_clock(trace, sp))
    h2d = [s for s in sp if s.name == "entry.h2d"]
    worst, copies = 0.0, 0
    for req in read:
        for launch in req.launches:
            if "HtoD" not in launch.name:
                continue
            copies += 1
            call = (launch.call_start, launch.call_end)
            worst = max(worst, min(_outside(call, s) for s in h2d))
    print(f"\n[spans] {cell}: {copies} copies to the card in {len(read)} "
          f"of {n} requests; the farthest outside entry.h2d: {worst:.3f} us")
    assert copies >= 2 * len(read)
    assert worst == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", STREAM)
def test_every_launch_lies_in_a_stage_or_entry_span(traced, cell):
    from stereo_bench import spans

    _, trace, raw = traced(cell)
    sp = _on_line(trace, raw)
    line = spans._Timeline(spans.self_segments(sp))
    lo = min(s.start for s in sp)
    hi = max(s.end for s in sp)
    calls = [c for c in trace.runtime if c[2].startswith(spans.WAKES)
             and lo <= c[0] <= hi]
    keys = {line.at(c[0]) for c in calls} | {line.at(c[1]) for c in calls}
    # the misalignment: how far a launch call sticks out of the innermost
    # span its start lies in, and the least room between a call and the
    # edges of that span
    worst, room = 0.0, float("inf")
    for c in calls:
        i = max(0, bisect.bisect_right(line.starts, c[0]) - 1)
        s0, s1, _ = line.segs[i]
        worst = max(worst, c[1] - s1, s0 - c[0])
        room = min(room, c[0] - s0, s1 - c[1])
    print(f"\n[spans] {cell}: {len(calls)} launch calls; the farthest out "
          f"of its span {max(worst, 0.0):.3f} us; the least room to a span "
          f"edge {room:.3f} us")
    assert keys <= set(STAGES) | set(ENTRY)
    assert len(calls) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("cell", STREAM)
def test_launches_and_operations_agree(traced, cell):
    from stereo_bench import spans

    out, trace, raw = traced(cell)
    a = spans.attribute(trace, raw)
    print(f"\n[spans] {cell}: {a.read} of {a.requests} requests read, "
          f"{len(spans.clock_anchors(trace, _on_line(trace, raw)))} clock "
          "anchors")
    assert a.device is not None
    assert a.read >= 0.75 * a.requests
    assert all(out.metrics[f"stages.{s}.device_ms.stream"]["value"] is not None
               for s in STAGES)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", STREAM)
def test_both_closures_hold(traced, cell):
    from stereo_bench import spans

    out, trace, raw = traced(cell)
    a = spans.attribute(trace, raw)
    m = {k: v["value"] for k, v in out.metrics.items()}
    busy = a.busy_us / 1e3 / a.pairs
    idle = a.idle_us / 1e3 / a.pairs
    stage_dev = sum(m[f"stages.{s}.device_ms.stream"] for s in STAGES)
    entry_dev = sum(a.device.get(k, 0.0) for k in ENTRY) / 1e3 / a.pairs
    stage_idle = sum(m[f"stages.{s}.idle_ms.stream"] for s in STAGES)
    outside = a.idle.get(spans.OUTSIDE, 0.0) / 1e3 / a.pairs
    print(f"\n[spans] {cell}: busy {busy:.4f} ms a pair = stages "
          f"{stage_dev:.4f} + entry {entry_dev:.4f}; idle {idle:.4f} = "
          f"stages {stage_idle:.4f} + entry {m['entry.idle_ms.stream']:.4f}"
          f" + outside {outside:.4f}; whole stretch busy "
          f"{trace.busy_s() * 1e3 / trace.pairs:.4f} ms a pair")
    assert stage_dev + entry_dev == pytest.approx(busy, rel=0.01)
    assert stage_idle + m["entry.idle_ms.stream"] + outside == \
        pytest.approx(idle, rel=0.01)
