"""The refined Cones cell on the card, traced as the benchmark traces it:
the run is correct; launch calls and device operations agree in number
in at least three quarters of the requests; every launch call lies in a
stage or entry span, or in ``refine.median`` or ``refine.dda``, which
each launch their kernel (M1, M2) once a pair; the cell's four metrics
read, the two spans' device time is at least their kernels' and the two
bound shares lie in (0, 100].

    python -m pytest --noconftest -p no:cacheprovider -q -s -m cuda \\
        stereo_bench/tests/test_bench_refined_cuda.py

from the root of a checkout on a machine with a card; it skips without
one.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "cones.stream-refined"
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine")
ENTRY = ("root", "entry.h2d", "entry.d2h")
REFINED = ("refine.median", "refine.dda")
METRICS = ("refine.median.device_ms.refined", "refine.dda.device_ms.refined",
           "kernels.m1_bound_pct.refined", "kernels.m2_bound_pct.refined")
_run = []


@pytest.fixture
def traced():
    """(outcome, TraceData, the program's spans) of one --trace 1 run of
    the cell, made once."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if _run:
        return _run[0]
    from adcensus_torch.utils import profiling
    from stereo_bench import harness
    from stereo_bench import trace as trace_mod

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
        cell = harness.Cell.from_spec(harness.load_spec(ROOT), CELL)
        out = harness.run_cell(cell, 2 ** 31 + 29, 2.0, True, device="cuda",
                               log=lambda *a: None)
    finally:
        trace_mod.Tracer.stop = stop
    _run.append((out, kept[0], profiling.spans()))
    return _run[0]


@pytest.mark.cuda
def test_refined_launches_and_operations_agree(traced):
    from stereo_bench import spans

    out, trace, raw = traced
    assert out.correct, out.checks
    sp = spans.trace_spans(trace, raw)
    a = spans.attribute(trace, raw)
    print(f"\n[spans] {CELL}: {a.read} of {a.requests} requests read, "
          f"{len(spans.clock_anchors(trace, sp))} clock anchors")
    assert a.device is not None
    assert a.read >= 0.75 * a.requests
    line = spans._Timeline(spans.self_segments(sp))
    lo, hi = min(s.start for s in sp), max(s.end for s in sp)
    calls = [c for c in trace.runtime if c[2].startswith(spans.WAKES)
             and lo <= c[0] <= hi]
    keys = {line.at(c[0]) for c in calls} | {line.at(c[1]) for c in calls}
    assert keys <= set(STAGES) | set(ENTRY) | set(REFINED)
    # one M1 and one M2 launch a pair, each in its own span
    for name, kid in zip(REFINED, ("M1", "M2")):
        launches = [ln for req in spans.requests(
            trace, sp, spans.on_host_clock(trace, sp))[1]
            for ln in req.launches if trace.kernel_id(ln.name) == kid]
        assert launches
        assert {line.at(ln.call_start) for ln in launches} == {name}


@pytest.mark.cuda
def test_refined_metrics_read(traced):
    out, trace, _ = traced
    m = {k: out.metrics.get(k, {}).get("value") for k in METRICS}
    print(f"\n[metrics] {CELL}: {m}")
    assert None not in m.values()
    kernel_ms = {kid: sum(e - s for s, e, n in trace.kernels()
                          if trace.kernel_id(n) == kid) / 1e3 / trace.pairs
                 for kid in ("M1", "M2")}
    assert m["refine.median.device_ms.refined"] >= 0.9 * kernel_ms["M1"]
    assert m["refine.dda.device_ms.refined"] >= 0.9 * kernel_ms["M2"]
    for k in ("kernels.m1_bound_pct.refined", "kernels.m2_bound_pct.refined"):
        assert 0.0 < m[k] <= 100.0
