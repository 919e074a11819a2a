"""A whole run on the CPU but for the look for a card: sound, it is
correct and reports its metrics; with the timed path broken underneath,
or with the lower-precision control in the program's place, ``correct``
comes out false."""
import numpy as np
import pytest
import torch

from conftest import run_tiny, tiny_cell
from stereo_bench import harness

CELLS = ["cones.stream", "kitti.stream", "cones.batch8", "kitti.batch8"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = run_tiny(workload, seconds=0.05, warmup=1)
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted >= 1
    assert out.checks["mismatch_pct"]["value"] == 0.0
    # the entries of one card report card 0's peak alone
    assert "memory_peak_bytes_by_card" not in out.device
    names = set(out.metrics)
    if workload.endswith(".stream"):
        assert names == {"latency_ms", "latency_ms.p95", "setup_s"}
    else:
        assert names == {"throughput", "setup_s"}
        assert out.attempted % 8 == 0
    assert all(m["value"] > 0 or n == "setup_s"
               for n, m in out.metrics.items())


def test_a_traced_run_is_correct_and_reads_the_trace():
    out = run_tiny("cones.stream", trace=True)
    assert out.correct, out.checks
    # an unprofiled stretch, then a profiled one, of trace_requests each
    assert out.attempted == 2 * tiny_cell("cones.stream").traffic[
        "trace_requests"]
    assert out.device["window_s"] > 0
    # no device on the CPU: the device readers find nothing to read
    assert out.metrics == {}
    assert set(out.breakdown) == {"device_ops", "idle_gaps"}


def _unchanged(cost, *args, **kwargs):
    return cost


def _altered(fn):
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        final = out["final"].clone()
        h, w = final.shape
        v = final[h // 2, w // 2]
        final[h // 2, w // 2] = torch.where(torch.isfinite(v), v + 1, 0.0)
        out["final"] = final
        return out
    return run


def _half_left_out(fn):
    def run(lefts, rights, *args, **kwargs):
        half = lefts.shape[0] // 2
        done = fn(lefts[:half], rights[:half], *args, **kwargs)
        mean = done.mean(dim=0, keepdim=True).expand_as(done)
        return torch.cat([done, mean])
    return run


@pytest.mark.parametrize("workload", CELLS)
def test_a_stage_that_returns_its_state_unchanged_fails(workload,
                                                        monkeypatch):
    from adcensus_torch.stages import scanline
    monkeypatch.setattr(scanline, "scanline_optimize", _unchanged)
    out = run_tiny(workload)
    assert not out.correct
    assert out.checks["mismatch_pct"]["value"] > 1.0


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_produced_fails(workload, monkeypatch):
    from adcensus_torch.stages import refine
    monkeypatch.setattr(refine, "multistep_refine",
                        _altered(refine.multistep_refine))
    out = run_tiny(workload)
    assert not out.correct
    assert 0 < out.checks["mismatch_pct"]["value"] < 1.0


@pytest.mark.parametrize("workload", ["cones.batch8", "kitti.batch8"])
def test_half_the_batch_left_out_fails(workload, monkeypatch):
    from adcensus_torch.stages import pipeline
    monkeypatch.setattr(pipeline, "match_batched_device",
                        _half_left_out(pipeline.match_batched_device))
    out = run_tiny(workload)
    assert not out.correct


@pytest.mark.parametrize("workload", ["cones.stream", "kitti.batch8"])
def test_the_control_in_bfloat16_fails(workload):
    control = harness.control_entry(tiny_cell(workload), "cpu",
                                    torch.bfloat16)
    out = run_tiny(workload, entry=control)
    assert not out.correct
    assert out.checks["mismatch_pct"]["value"] > 5.0


def test_an_output_of_the_wrong_shape_counts_as_failed():
    def wrong(lefts, rights):
        return np.zeros((lefts.shape[0], 2, 2), np.float32)
    out = run_tiny("cones.stream", entry=wrong)
    assert out.failed == out.attempted and not out.correct
