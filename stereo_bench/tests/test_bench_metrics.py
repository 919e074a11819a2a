"""The arithmetic of the end-to-end metrics on fixed timings, the last
line's keys, and the per-layer readers on a made-up trace."""
import json
import math

import pytest

from stereo_bench import harness
from stereo_bench.trace import TraceData, union


def read(kind, name, obj):
    return harness._load_module(harness.find_reader(kind, name)).read(obj)


def window(latencies, per_request=1, pair_work=450 * 375 * 64, due=None):
    """A window of requests of ``per_request`` pairs; ``due`` adds each
    request's wait from its due time to its sending."""
    n = len(latencies) * per_request
    service = list(latencies)
    lat = [t + (due[i] if due else 0.0) for i, t in enumerate(latencies)]
    return harness.Window(lat, service, n, n * pair_work, 12.5)


def test_latency_is_the_mean_over_every_request():
    lat = [0.02] * 90 + [0.05] * 10        # 100 requests, 2.3 s
    win = window(lat)
    assert read("e2e", "latency_ms", win) == pytest.approx(2300.0 / 100)
    # nearest rank: the 95th of 100 sorted values
    assert read("e2e", "latency_ms.p95", win) == pytest.approx(50.0)
    assert read("e2e", "setup_s", win) == 12.5


def test_open_loop_latency_counts_from_the_due_time():
    lat = [0.02] * 20
    win = window(lat, due=[0.01 * i for i in range(20)])   # falling behind
    assert read("e2e", "latency_ms", win) == pytest.approx(
        20.0 + 10.0 * 19 / 2)
    assert read("e2e", "latency_ms.p95", win) == pytest.approx(20.0 + 180.0)


def test_p95_takes_every_request_not_chunks():
    lat = [0.001 * (i + 1) for i in range(200)]  # 1 .. 200 ms
    assert read("e2e", "latency_ms.p95", window(lat)) == pytest.approx(190.0)
    lat = [0.01] * 19 + [1.0]                    # one slow request of 20
    assert read("e2e", "latency_ms.p95", window(lat)) == pytest.approx(10.0)
    lat = [0.01] * 18 + [1.0, 1.0]
    assert read("e2e", "latency_ms.p95", window(lat)) == pytest.approx(1000.0)


def test_throughput_counts_every_pair_of_the_window():
    lat = [0.1] * 30 + [0.5]               # 31 requests of 8 pairs in 3.5 s
    win = window(lat, per_request=8, pair_work=1242 * 375 * 256)
    want = 248 * 1242 * 375 * 256 / 3.5 / 1e6
    assert read("e2e", "throughput", win) == pytest.approx(want)
    # waits for a due time are not the system's time
    win = window(lat, per_request=8, pair_work=1242 * 375 * 256,
                 due=[1.0] * 31)
    assert read("e2e", "throughput", win) == pytest.approx(want)


def test_outcome_line_has_the_contract_keys_checks_last():
    out = harness.Outcome(True, 8, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                          {"platform": "gpu", "kind": "x", "count": 1,
                           "memory_peak_bytes": 5},
                          {"mismatch_pct": {"value": 0.0, "limit": 0.0}},
                          breakdown={"device_ops": [], "idle_gaps": []})
    line = json.loads(out.line())
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]


def _trace():
    """Two pairs in a profiled stretch of 300 us on the host's clock,
    after an unprofiled stretch of 120 us a pair; device ops and host
    calls into CUDA within it."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "args": args})

    x("kernel", "void cross_pass_kernel<8>(...)", 10, 20, correlation=1)
    x("kernel", "at::native::elementwise_kernel", 25, 25, correlation=2)
    x("kernel", "scanline_kernel", 120, 30, correlation=3)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 200, 10,
      correlation=4)
    x("cuda_runtime", "cudaMemcpyAsync", 150, 62, correlation=4)
    x("cuda_runtime", "cudaStreamSynchronize", 212, 8, correlation=5)
    x("cuda_runtime", "cudaLaunchKernel", 0, 3, correlation=1)
    x("cpu_op", "aten::add", 60, 10)      # not recorded on a card; ignored
    t = TraceData.from_events(ev)
    t.window = 300e-6
    t.pairs = 2
    t.plain_s_a_pair = 120e-6
    t.shape = (375, 450, 64)
    return t


def test_trace_readers():
    t = _trace()
    assert t.window_s() == pytest.approx(300e-6)
    # busy: 10-50, 120-150, 200-210 -> 80 us
    assert t.busy_s() == pytest.approx(80e-6)
    # 40 us busy a pair of the 120 us a pair takes unprofiled
    assert read("metrics", "device.idle_pct.stream", t) == \
        pytest.approx(100 * (1 - 40 / 120))
    # 80 us busy of the profiled stretch's 300
    assert read("metrics", "device.idle_pct.batch", t) == \
        pytest.approx(100 * (1 - 80 / 300))
    # 120 us a pair unprofiled, 40 us of it busy on the device
    assert read("metrics", "entry.host_ms.stream", t) == \
        pytest.approx((120 - 40) / 1e3)
    assert read("metrics", "stages.torch_ms.batch", t) == \
        pytest.approx(25 / 1e3 / 2)
    assert read("metrics", "kernels.hand_ms.stream", t) == \
        pytest.approx(50 / 1e3 / 2)
    from stereo_bench import roofline
    bound = (roofline.BOUNDS["B1"](375, 450, 64)
             + roofline.BOUNDS["B2"](375, 450, 64))
    assert read("metrics", "kernels.roofline_pct.stream", t) == \
        pytest.approx(100 * bound / 50e-6)


def test_readers_find_nothing_in_an_empty_trace():
    t = TraceData.from_events([])
    for name in ("device.idle_pct.stream", "device.idle_pct.batch",
                 "entry.host_ms.stream",
                 "stages.torch_ms.stream", "kernels.hand_ms.stream",
                 "kernels.roofline_pct.stream"):
        assert read("metrics", name, t) is None
    assert t.breakdown() == {"device_ops": [], "idle_gaps": []}


def test_breakdown_names_gaps_by_the_host_call_or_the_next_op():
    b = _trace().breakdown()
    assert b["device_ops"][0][0] == "scanline_kernel"
    assert len(b["device_ops"]) == 4
    gaps = dict((round(s * 1e6), n) for n, s in b["idle_gaps"])
    assert gaps[10] == "host, before void cross_pass_kernel<8>(...)"  # 0-10
    assert gaps[70] == "host, before scanline_kernel"   # 50-120, mid 85
    assert gaps[50] == "cudaMemcpyAsync"                # 150-200, mid 175
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(130e-6)


def test_union_merges_and_sorts():
    assert union([(10, 12), (0, 5), (3, 8), (9, 9)]) == [(0, 8), (10, 12)]


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["adcensus_torch", "adcensus_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "adcensus_tpu.ops", "flax"]) == [
            "adcensus_tpu", "flax", "jax"]


def test_reservoir_is_uniform_and_seeded():
    import numpy as np
    counts = np.zeros(20)
    for s in range(2000):
        r = harness.Reservoir(4, np.random.default_rng(s))
        for i in range(20):
            r.offer(i)
        counts[r.items] += 1
        assert len(set(r.items)) == 4
    assert counts.min() > 0.8 * 400 and counts.max() < 1.2 * 400
    a, b = (harness.Reservoir(3, np.random.default_rng([7, 1]))
            for _ in range(2))
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_mismatch_count_and_bad_pct():
    import numpy as np
    a = np.array([[1.0, np.inf], [np.nan, 2.0]], np.float32)
    b = np.array([[1.0, np.inf], [np.nan, 2.5]], np.float32)
    assert harness.mismatch_count(a, b) == 1
    gt = np.array([[1.0, 3.0], [0.0, 5.0]], np.float32)
    assert harness.bad_pct(b, gt) == 75.0
    assert math.isclose(harness.bad_pct(gt, gt), 0.0)
