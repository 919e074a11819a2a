"""The served entry of the sharded layer (adcensus_torch/parallel/serve.py)
on the CPU: this test's process is rank 0 and the other ranks are started
as ``python -m adcensus_torch.parallel.serve``, all on gloo, as on the
card. Each map equals the blocked plain reference's; a matcher serves
request after request; ``close`` ends every worker and a later ``match``
raises; a killed worker makes the next ``match`` raise at once; under a
profiler the spans nest; and the bytes the program counts equal the
benchmark's count from the geometry.

One matcher lives at a time (it owns the process's default process
group): ``_matcher`` keeps the last one open and closes it before
another starts, so the file starts five matchers in all."""
import dataclasses
import os
import signal
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.parallel import serve, sharded
from adcensus_torch.utils import profiling
from stereo_bench import comm
from stereo_bench.reference import adcensus_blocked
from stereo_bench.scenes import two_layer

# 46 x 62 pads to 48 x 64 at 4 ranks; an 8-row halo reaches into the
# neighbours' 12-row (4 ranks) and 23-row (2 ranks) slabs
H, W = 46, 62
OPTS = ADCensusOptions(max_disparity=24, cross_L1=8, cross_L2=4)
SEEDS = (3, 2 ** 33 + 1, 2 ** 40 + 7)
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine")
# how long a killed worker may take to make match raise
RAISE_S = 10.0

_open = {}


def _matcher(world: int) -> serve.ShardedMatcher:
    """An open matcher of ``world`` ranks on the CPU, kept for the next
    test that asks for the same world."""
    if world not in _open:
        _close_all()
        _open[world] = serve.ShardedMatcher(OPTS, world=world, device="cpu")
    return _open[world]


def _close_all():
    for m in _open.values():
        m.close()
    _open.clear()


@pytest.fixture(scope="module", autouse=True)
def one_thread_a_rank():
    """Rank 0 computes on one thread, as the workers do, and every
    matcher is closed at the end: ranks that wait on each other at every
    collective lose most to a busy machine's scheduling."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    _close_all()
    torch.set_num_threads(threads)


def _pair(seed):
    rng = np.random.default_rng(seed)
    left, right, _ = two_layer.make(H, W, {"d_bg": 4, "d_fg": 13}, rng)
    return left, right


def _reference(left, right):
    # blocks of about a fifth of the volume: several on every axis
    return adcensus_blocked.match(
        left, right, dataclasses.asdict(OPTS), "cpu",
        block_bytes=OPTS.disp_range * H * W * 4 // 5)


def _assert_same(got, want):
    assert got.dtype == np.float32 and got.shape == (H, W)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("world, seed",
                         [(w, s) for w in (2, 4) for s in SEEDS])
def test_each_map_equals_the_blocked_reference(world, seed):
    left, right = _pair(seed)
    _assert_same(_matcher(world).match(left, right), _reference(left, right))


def test_a_second_match_on_the_same_matcher_agrees():
    m = _matcher(4)
    left, right = _pair(SEEDS[0])
    first = m.match(left, right)
    left2, right2 = _pair(SEEDS[1])
    _assert_same(m.match(left2, right2), _reference(left2, right2))
    _assert_same(m.match(left, right), first)
    assert m.peak_bytes() == [0, 0, 0, 0]


@pytest.mark.parametrize("world", [4, 2])
def test_comm_bytes_equal_the_benchmarks_count(world):
    m = _matcher(world)
    left, right = _pair(SEEDS[2])
    sharded.reset_comm_bytes()
    m.match(left, right)
    received = sum(k["received"] for k in sharded.comm_bytes.values())
    assert received == comm.received_bytes(
        H, W, OPTS.disp_range, world, OPTS.cross_L1, rank=0)
    assert sharded.comm_bytes["broadcast"] == {
        "sent": (world - 1) * 2 * H * W * 3, "received": 0}
    # rank 0 has one row neighbour: it sends the halo rows it receives
    assert (sharded.comm_bytes["halo"]["sent"]
            == sharded.comm_bytes["halo"]["received"] > 0)


def test_spans_come_in_order_and_nest():
    m = _matcher(2)
    left, right = _pair(SEEDS[0])
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = m.match(left, right)
    spans = profiling.spans()
    profiling.clear()
    _assert_same(got, _reference(left, right))
    by_id = {s.id: s for s in spans}
    root = [s for s in spans if s.parent is None]
    assert [s.name for s in root] == ["match"]
    top = sorted((s for s in spans if s.parent == root[0].id),
                 key=lambda s: s.start_ns)
    names = [s.name for s in top]
    assert names == (["entry.h2d", "shard.broadcast", *STAGES,
                      "shard.all_gather", "entry.d2h"])
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns
    for s in spans:
        assert s.request == root[0].request
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # every collective but the broadcast and the map's gather lies in a
    # stage: halos in aggregation and refine, both reshards in scanline
    inner = [s for s in spans if s.name.startswith("shard.")
             and s.parent != root[0].id]
    assert {by_id[s.parent].name for s in inner} == {
        "arms", "aggregation", "scanline", "refine"}
    kinds = {(by_id[s.parent].name, s.name) for s in inner}
    assert ("aggregation", "shard.halo") in kinds
    assert ("scanline", "shard.all_to_all") in kinds
    assert ("refine", "shard.halo") in kinds


def test_close_ends_every_worker_and_match_then_raises():
    _close_all()
    m = serve.ShardedMatcher(OPTS, world=2, device="cpu")
    left, right = _pair(SEEDS[1])
    m.match(left, right)
    procs = list(m._procs)
    m.close()
    m.close()
    assert all(p.poll() is not None for p in procs)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="closed"):
        m.match(left, right)


def test_a_killed_worker_makes_the_next_match_raise():
    _close_all()
    m = serve.ShardedMatcher(OPTS, world=2, device="cpu")
    try:
        left, right = _pair(SEEDS[2])
        m.match(left, right)
        os.kill(m._procs[0].pid, signal.SIGKILL)
        m._procs[0].wait(timeout=RAISE_S)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 exited"):
            m.match(left, right)
        assert time.monotonic() - t0 < RAISE_S
    finally:
        m.close()
    assert not dist.is_initialized()
