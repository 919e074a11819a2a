"""The refined Cones cell's files on the CPU: M1's and M2's bounds
(roofline_refine.py) against the measured kernel table, their shares and
the span readers on synthetic traces (None from a program that records
no such span), the refined reference's imports, and a tiny copy of the
cell run end to end, traced and not."""
import ast
import copy
import json
import subprocess
import sys

import pytest

from conftest import ROOT
from stereo_bench import harness, roofline, roofline_refine, spans
from stereo_bench.trace import TraceData, hand_kernels

from adcensus_torch.utils import profiling

CELL = "cones.stream-refined"
CONE = (375, 450, 64)
METRICS = {"refine.median.device_ms.refined", "refine.dda.device_ms.refined",
           "kernels.m1_bound_pct.refined", "kernels.m2_bound_pct.refined"}
# M1 at Cone size as measured on an H100 (PERF.md's kernel table): 0.3354
# ms a launch, 1,198 wavefronts, the kernel's own chain 76.8 cycles a step
M1_MS, M1_CHAIN_CYCLES = 0.3354, 76.8


def test_m1_bound_is_its_recurrence_below_every_measured_time():
    h, w, _ = CONE
    waves = roofline_refine.m1_wavefronts(h, w)
    assert waves == 1198
    step = roofline_refine.m1_step_s()
    assert 0.0 < roofline_refine.M1_STEP_CYCLES < M1_CHAIN_CYCLES
    # a step below the kernel's time a wavefront, the whole below its launch
    assert step < M1_MS * 1e-3 / waves
    assert waves * step < M1_MS * 1e-3
    dep = waves * step
    bytes_s = roofline.bytes_bound_s(roofline_refine.map_bytes(h, w))
    assert roofline_refine.m1_bound_s(h, w) == max(dep, bytes_s) == dep
    assert roofline_refine.BOUNDS["M1"](*CONE) == dep


@pytest.mark.parametrize("shape", [(1, 1), (1, 5000), (5000, 1), CONE[:2]])
def test_bounds_count_the_map_read_and_written(shape):
    h, w = shape
    assert roofline_refine.map_bytes(h, w) == 8 * h * w
    assert roofline_refine.m2_bound_s(h, w) == pytest.approx(
        8 * h * w / roofline.MEM_BYTES_PER_S)
    assert roofline_refine.m1_bound_s(h, w) >= roofline_refine.m2_bound_s(
        h, w)
    assert roofline_refine.m1_wavefronts(h, w) == w + 2 * h - 2


def test_bound_ids_are_hand_kernels():
    assert set(roofline_refine.BOUNDS) <= set(hand_kernels())


def _trace(ops, shape=CONE):
    t = TraceData(list(ops), [])
    t.shape = shape
    return t


def test_bound_shares_on_a_synthetic_trace():
    m1 = "void (anonymous namespace)::median_inplace_kernel<false, 0>(Map)"
    m2 = "void (anonymous namespace)::dda_kernel(float const*)"
    ops = [(0.0, 300.0, m1, "kernel"), (400.0, 700.0, m1, "kernel"),
           (800.0, 815.0, m2, "kernel"), (900.0, 950.0, "other", "kernel")]
    t = _trace(ops)
    want1 = 100.0 * 2 * roofline_refine.BOUNDS["M1"](*CONE) / 600e-6
    want2 = 100.0 * roofline_refine.BOUNDS["M2"](*CONE) / 15e-6
    assert roofline_refine.bound_pct(t, "M1") == pytest.approx(want1)
    assert roofline_refine.bound_pct(t, "M2") == pytest.approx(want2)
    for name, want in (("kernels.m1_bound_pct.refined", want1),
                       ("kernels.m2_bound_pct.refined", want2)):
        reader = harness._load_module(harness.find_reader("metrics", name))
        assert reader.read(t) == pytest.approx(want)
    empty = _trace([(0.0, 5.0, "other", "kernel")])
    assert roofline_refine.bound_pct(empty, "M1") is None


BASE = 227 * spans.BASE_PERIOD_NS


def _span(sid, parent, name, start_us, end_us):
    return profiling.Span(1, sid, parent, name, BASE + int(start_us * 1e3),
                          BASE + int(end_us * 1e3))


# One `match` request: the refine stage launches one kernel itself, one
# in refine.dda and one in refine.median (µs on the trace's time line).
SPANS = [
    _span(2, 1, "refine", 110, 190),
    _span(3, 2, "refine.dda", 130, 140),
    _span(4, 2, "refine.median", 150, 170),
    _span(1, None, "match", 100, 200),
]
RUNTIME = [(50, 51, "cudaDeviceSynchronize"),      # the caller's, before
           (115, 116, "cudaLaunchKernel"), (131, 132, "cudaLaunchKernel"),
           (151, 152, "cudaLaunchKernel"),
           (300, 301, "cudaDeviceSynchronize")]    # the caller's, after
OPS = [(116, 120, "k", "kernel"), (132, 135, "dda_kernel", "kernel"),
       (152, 182, "median_inplace_kernel", "kernel")]


def _span_trace():
    t = TraceData(list(OPS), list(RUNTIME))
    t.pairs = 1
    return t


@pytest.mark.parametrize("name, want_us", [
    ("refine.median.device_ms.refined", 30.0),
    ("refine.dda.device_ms.refined", 3.0),
])
def test_span_readers(monkeypatch, name, want_us):
    reader = harness._load_module(harness.find_reader("metrics", name))
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert reader.read(_span_trace()) == pytest.approx(want_us / 1e3)
    # a program that opens no such span (the flags off, or the parent's)
    gone = name.split(".device_ms")[0]
    monkeypatch.setattr(profiling, "spans",
                        lambda: [s for s in SPANS if s.name != gone])
    assert reader.read(_span_trace()) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(_span_trace()) is None


def test_the_refined_reference_imports_nothing_of_the_program():
    path = ROOT / "stereo_bench" / "reference" / "adcensus_refined.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "math", "numpy", "torch",
                     "stereo_bench.reference"}
    code = ("import sys, json; sys.modules['jax'] = None;"
            "sys.modules['jaxlib'] = None;"
            "from stereo_bench.reference import adcensus_refined;"
            "print(json.dumps(sorted({m.split('.')[0] for m, v in"
            " sys.modules.items() if v is not None})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & {"adcensus_torch", "adcensus_tpu", "jax", "jaxlib"}


def test_the_cell_reports_its_metrics(spec):
    cell = harness.Cell.from_spec(spec, CELL)
    assert cell.chips == 1 and cell.traffic["entry"] == "match"
    assert cell.config["reference"] == "adcensus_refined"
    assert cell.config["options"]["exact_median"]
    assert cell.config["options"]["do_discontinuity_adjustment"]
    assert {m["name"] for m in cell.e2e} == {
        "latency_ms", "latency_ms.p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS
    cones = harness.Cell.from_spec(spec, "cones.stream")
    for key in ("height", "width", "min_disparity", "max_disparity",
                "scene", "scene_params", "check", "precision"):
        assert cell.config[key] == cones.config[key], key
    assert {k: v for k, v in cell.config["options"].items()
            if cones.config["options"][k] != v} == {
        "exact_median": True, "do_discontinuity_adjustment": True}


def _tiny():
    cell = harness.Cell.from_spec(harness.load_spec(ROOT), CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(height=24, width=40, max_disparity=8,
               scene_params={"d_bg": 2, "d_fg": 5})
    cfg["options"]["cross_L1"] = 6
    cfg["check"]["pairs"] = 2
    cell.config = cfg
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_copy_of_the_cell_is_correct(trace):
    out = harness.run_cell(_tiny(), seed=2 ** 33 + 11, seconds=0.0,
                           trace=trace, device="cpu", warmup=0,
                           log=lambda *a: None)
    assert out.correct, out.checks
    assert out.checks["mismatch_pct"]["value"] == 0.0
    if not trace:
        assert {"latency_ms", "latency_ms.p95", "setup_s"} <= set(out.metrics)
