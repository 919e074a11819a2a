"""The four-card cell mb2014-full.sharded4 on the CPU: its configuration,
mix and entry load by name with the metrics it reports; its readers on a
synthetic trace of NCCL kernels and shard.* spans; and a tiny copy of
the cell through the whole harness, worker ranks on gloo."""
import copy
import json

import pytest

from stereo_bench import comm, harness, spans
from stereo_bench.trace import TraceData

from adcensus_torch.utils import profiling

CELL = "mb2014-full.sharded4"
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine")
BASE = 227 * spans.BASE_PERIOD_NS


def test_the_cell_loads_with_its_metrics(spec):
    cell = harness.Cell.from_spec(spec, CELL)
    assert cell.chips == 4
    assert cell.config["name"] == "middlebury2014-jadeplant-full"
    assert (cell.config["height"], cell.config["width"]) == (1988, 2632)
    assert cell.pair_work() == 1988 * 2632 * 640
    assert cell.config["check"] == {"pairs": 1,
                                    "limits": {"mismatch_pct": 0.0}}
    assert cell.reference().__name__.endswith("adcensus_blocked_py")
    assert cell.traffic["entry"] == "match_sharded"
    assert cell.traffic["entry_args"] == {"volume_axis": "rows",
                                          "cross_backend": "roll"}
    assert {m["name"] for m in cell.e2e} == {
        "latency_ms", "latency_ms.p95", "setup_s"}
    want = {"shard.comm.device_ms.sharded4", "shard.comm.idle_ms.sharded4",
            "shard.link_pct.sharded4", "device.idle_pct.sharded4",
            "kernels.hand_ms.sharded4"}
    want |= {f"stages.{s}.device_ms.sharded4" for s in STAGES}
    assert {m["name"] for m in cell.per_layer} == want
    readers = {m["name"]: harness.find_reader("metrics", m["name"]).name
               for m in cell.per_layer}
    # the device's and the hand-written kernels' readers of every cell;
    # no roofline of B1 and B2, whose reader counts the whole image
    assert readers["device.idle_pct.sharded4"] == "device.idle_pct.py"
    assert readers["kernels.hand_ms.sharded4"] == "kernels.hand_ms.py"
    assert "kernels.roofline_pct.sharded4" not in readers
    assert comm.cell_geometry(CELL) == (1988, 2632, 640, 4, 34)


def _span(sid, parent, name, start_us, end_us):
    return profiling.Span(1, sid, parent, name, BASE + int(start_us * 1e3),
                          BASE + int(end_us * 1e3))


# One request (µs): the pair's copy in (its end, where the wait returns,
# aligns the clocks at no offset) and broadcast, then one span a
# stage, each with a kernel of its own and a collective's NCCL kernel in
# a shard.* span nested in it, then the copy back; host calls before and
# after, so that the trace's extent holds the request.
SPANS = [_span(2, 1, "entry.h2d", 101, 110),
         _span(3, 1, "shard.broadcast", 110, 120)]
RUNTIME = [(99, 100, "cudaGetDevice"),
           (102, 103, "cudaMemcpyAsync"), (103, 109, "cudaStreamSynchronize"),
           (111, 112, "cuLaunchKernelEx")]
OPS = [(104, 109, "Memcpy HtoD", "gpu_memcpy"),
       (112, 118, "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage)",
        "kernel")]
for k, stage in enumerate(STAGES):
    t = 120 + 20 * k
    SPANS += [_span(10 + 2 * k, 1, stage, t, t + 20),
              _span(11 + 2 * k, 10 + 2 * k, "shard.all_gather", t + 10,
                    t + 18)]
    RUNTIME += [(t + 1, t + 2, "cudaLaunchKernel"),
                (t + 11, t + 12, "cuLaunchKernelEx")]
    OPS += [(t + 2, t + 6, f"kernel_{stage}", "kernel"),
            (t + 12, t + 15, "ncclDevKernel_AllGather_RING_LL", "kernel")]
SPANS += [_span(30, 1, "entry.d2h", 240, 250),
          _span(1, None, "match", 100, 250)]
RUNTIME += [(241, 242, "cudaMemcpyAsync"),
            (242, 249, "cudaStreamSynchronize"), (250, 251, "cudaGetDevice")]
OPS += [(243, 247, "Memcpy DtoH", "gpu_memcpy")]


def test_readers_on_nccl_kernels_and_shard_spans(monkeypatch, spec):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    trace = TraceData(list(OPS), list(RUNTIME))
    trace.pairs = 1
    trace.window = 150e-6
    cell = harness.Cell.from_spec(spec, CELL)
    got = {m["name"]: harness._load_module(
        harness.find_reader("metrics", m["name"])).read(trace)
        for m in cell.per_layer}
    nccl_ms = (6 + 6 * 3) / 1e3
    assert got["shard.comm.device_ms.sharded4"] == pytest.approx(nccl_ms)
    # idle under the broadcast (110-112, 118-120) and each gather
    # (t+10-t+12, t+15-t+18)
    assert got["shard.comm.idle_ms.sharded4"] == pytest.approx(
        (4 + 6 * 5) / 1e3)
    for stage in STAGES:
        assert got[f"stages.{stage}.device_ms.sharded4"] == pytest.approx(
            4 / 1e3)
    received = comm.received_bytes(1988, 2632, 640, 4, 34, rank=0)
    assert got["shard.link_pct.sharded4"] == pytest.approx(
        100 * received / (nccl_ms / 1e3) / (18 * 26.562e9))
    assert got["kernels.hand_ms.sharded4"] is None   # no B-kernel here
    busy = 5 + 6 + 6 * (4 + 3) + 4
    assert got["device.idle_pct.sharded4"] == pytest.approx(
        100 * (1 - busy / 150))


def test_readers_find_nothing_without_nccl_kernels(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    trace = TraceData([(0, 5, "kernel_cost", "kernel")], [])
    trace.pairs = 1
    for name in ("shard.comm.device_ms", "shard.link_pct.sharded4",
                 "shard.comm.idle_ms", "stages.cost.device_ms"):
        module = harness._load_module(harness.find_reader("metrics", name))
        assert module.read(trace) is None


def test_received_bytes_of_full_size():
    """About 6 GB a pair on rank 0: two all-to-alls of 3/4 of its 3.35 GB
    slab, four one-sided 34-row halos of the volume, and the gathers."""
    volume = 640 * 497 * 2632 * 4
    got = comm.received_bytes(1988, 2632, 640, 4, 34, rank=0)
    assert 2 * volume * 3 // 4 + 4 * 34 * 2632 * 640 * 4 < got < 6.2e9
    # inner ranks have two neighbours, and every rank but 0 takes the pair
    assert comm.received_bytes(1988, 2632, 640, 4, 34, rank=1) > got
    assert comm.halo_received(8, 12, 1, 4, 1) == 8 + 8 + 4  # no rank -1
    assert comm.halo_received(8, 12, 0, 4, 1) == 8 + 4


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_copy_runs_through_the_harness_on_the_cpu(spec, trace):
    cell = harness.Cell.from_spec(spec, CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(height=24, width=40, max_disparity=12,
               scene_params={"d_bg": 2, "d_fg": 6})
    cfg["options"]["cross_L1"] = 8
    cell.config = cfg
    cell.traffic = dict(cell.traffic, pool_pairs=2, warmup_requests=1,
                        trace_requests=2,
                        entry_args=dict(cell.traffic["entry_args"], world=2))
    lines = []
    out = harness.run_cell(cell, seed=2 ** 40 + 11, seconds=0.2, trace=trace,
                           device="cpu", log=lines.append)
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted >= 1
    assert out.device["memory_peak_bytes_by_card"] == [0, 0]
    if not trace:
        assert {"latency_ms", "latency_ms.p95", "setup_s"} <= set(out.metrics)
    json.loads(out.line())
