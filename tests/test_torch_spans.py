"""The port's span recorder (adcensus_torch/utils/profiling.py) at the
entry and stage boundaries of stages/pipeline.py, on the CPU: nothing is
recorded, and nothing allocated, without a torch.profiler session; under
one, each entry point records a root span and its stages and copies,
nested in time, sharing a request id, closed even when a stage raises;
the disparity is the same bit for bit either way."""
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.stages import pipeline, staged
from adcensus_torch.stages import wta as wta_stage
from adcensus_torch.synthetic import two_layer_pair
from adcensus_torch.utils import profiling

H, W, MAX_D = 16, 24, 6
OPTS = ADCensusOptions(max_disparity=MAX_D)


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _pair(seed=1):
    left, right, _ = two_layer_pair(H, W, 2, 4, seed=seed)
    return left, right


def _profiled(fn, *args, **kwargs):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn(*args, **kwargs)


def _bits(t):
    return np.asarray(t).view(np.uint32)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def _check_nesting(spans):
    """Every span lies within its parent in time and shares its request;
    siblings follow one another without overlap."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert p.request == s.request
    for p in spans:
        kids = sorted((s for s in spans if s.parent == p.id),
                      key=lambda s: s.start_ns)
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns


def test_nothing_is_recorded_without_a_profiler():
    left, right = _pair()
    pipeline.match_device(left, right, OPTS, device="cpu")
    pipeline.match(left, right, OPTS, device="cpu")
    assert profiling.spans() == []
    assert profiling.span("a") is profiling.span("b")


def test_a_span_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    def spin(n):
        for _ in range(n):
            with profiling.span("x") as s:
                assert s is None
                assert profiling.span("y") is profiling.span("z")

    def no_clock():
        raise AssertionError("a span off read the clock")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    spin(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spin(10_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__
             and d.size_diff > 0]
    assert grown == []
    assert profiling.spans() == []


def test_match_device_records_a_root_and_the_six_stages():
    left, right = _pair()
    _profiled(pipeline.match_device, left, right, OPTS, device="cpu")
    spans = profiling.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["match_device"]
    root = roots[0]
    assert _children(spans, root) == ["entry.h2d", *profiling.STAGES]
    assert {s.request for s in spans} == {root.request}
    assert len({s.id for s in spans}) == len(spans) == 8
    _check_nesting(spans)


def test_match_records_its_copies_both_ways():
    left, right = _pair()
    _profiled(pipeline.match, left, right, OPTS, device="cpu")
    _profiled(pipeline.match, left, right, OPTS, gray_mode="host64",
              device="cpu")
    spans = profiling.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["match", "match"]
    assert roots[0].request != roots[1].request
    for root in roots:
        assert _children(spans, root) == [
            "entry.h2d", *profiling.STAGES, "entry.d2h"]
    _check_nesting(spans)


def test_spans_close_when_a_stage_raises(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("stage failed")

    left, right = _pair()
    monkeypatch.setattr(wta_stage, "wta_right", broken)
    with pytest.raises(RuntimeError, match="stage failed"):
        _profiled(pipeline.match_device, left, right, OPTS, device="cpu")
    spans = profiling.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert _children(spans, root) == ["entry.h2d", *profiling.STAGES[:5]]
    _check_nesting(spans)
    # nothing is left open: the next call opens a request of its own
    monkeypatch.undo()
    profiling.clear()
    _profiled(pipeline.match_device, left, right, OPTS, device="cpu")
    roots = [s for s in profiling.spans() if s.parent is None]
    assert [r.name for r in roots] == ["match_device"]
    assert roots[0].request != root.request


def test_disparity_with_recording_is_bitwise_without():
    left, right = _pair(seed=3)
    off = pipeline.match_device(left, right, OPTS, device="cpu")
    on = _profiled(pipeline.match_device, left, right, OPTS, device="cpu")
    assert profiling.spans()
    np.testing.assert_array_equal(_bits(on), _bits(off))
    off = pipeline.match(left, right, OPTS, device="cpu")["disparity"]
    on = _profiled(pipeline.match, left, right, OPTS,
                   device="cpu")["disparity"]
    np.testing.assert_array_equal(_bits(on), _bits(off))


def test_match_staged_times_the_stages():
    left, right = _pair()
    res = staged.match_staged(left, right, OPTS, device="cpu",
                                 warmup=False)
    assert tuple(res["timings"]) == profiling.STAGES + ("total",)
    assert tuple(res["throughput"]) == profiling.STAGES + ("total",)


@pytest.mark.parametrize("group", [None, 1])
def test_batched_records_the_group_rule_and_each_pair(group):
    pairs = [_pair(seed) for seed in (1, 2)]
    lefts = np.stack([l for l, _ in pairs])
    rights = np.stack([r for _, r in pairs])
    out = _profiled(pipeline.match_batched_device, lefts, rights, OPTS,
                    device="cpu", group=group)
    spans = profiling.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "match_batched_device"
    rule = ["entry.group_rule"] if group is None else []
    assert _children(spans, root) == (
        rule + ["entry.h2d"] + 2 * list(profiling.STAGES))
    _check_nesting(spans)
    want = pipeline.match_batched_device(lefts, rights, OPTS, device="cpu",
                                         group=group)
    np.testing.assert_array_equal(_bits(out), _bits(want))


def test_hetero_and_match_batched_open_a_root():
    left, right = _pair()
    _profiled(pipeline.match_hetero_device, [(left, right)], [OPTS],
              device="cpu")
    grays = np.stack([np.zeros((H, W), np.uint8)])
    _profiled(pipeline.match_batched, left[None], right[None], grays, grays,
              OPTS, device="cpu")
    spans = profiling.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["match_hetero_device", "match_batched"]
    assert _children(spans, roots[0]) == ["entry.h2d", *profiling.STAGES]
    assert _children(spans, roots[1]) == [
        "entry.group_rule", "entry.h2d", *profiling.STAGES]
    _check_nesting(spans)


def test_an_entry_inside_a_span_joins_its_request():
    left, right = _pair()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("caller"):
            pipeline.match_device(left, right, OPTS, device="cpu")
    spans = profiling.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "caller"
    assert _children(spans, root) == ["match_device"]
    assert {s.request for s in spans} == {root.request}


def test_nothing_is_recorded_during_a_graph_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("captured"):
            pass
    assert profiling.spans() == []


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    from collections import deque

    monkeypatch.setattr(profiling, "_done", deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for name in "abcde":
            with profiling.span(name):
                pass
    assert [s.name for s in profiling.spans()] == ["c", "d", "e"]
