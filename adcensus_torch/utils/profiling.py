"""The port's tracing: spans at the entry and stage boundaries of the
pipeline, and per-stage timing of one match.

**Spans.** ``span(name)`` is a context manager that records one
``Span``: its request id, its own id, the id of the span it opened
inside (None for a request's outermost span), its name, and its start
and end. The outermost span of a thread opens a request and takes a new
request id; every span opened inside it shares that id. The entry points
of ``stages/pipeline.py`` open a span named after themselves
(``spanned``), and inside it ``entry.h2d`` (the images' copies to the
device), ``entry.d2h`` (``match``'s copies back), ``entry.group_rule``
and ``entry.replay`` (the batched path's group rule and each group's
graph replay), and one span per stage of ``match_core``, named from
``STAGES``. Spans are kept in memory, the newest ``SPAN_CAPACITY``, and
read with ``spans()``.

Recording is on exactly while a ``torch.profiler`` session is active
in the process: torch keeps a flag for it
(``torch.autograd.profiler._is_profiler_enabled``). Off, ``span`` reads
that flag and returns one shared no-op context: it reads no clock and
allocates nothing. A span opened while the current stream is capturing
a CUDA graph is not recorded: it would time the capture, not a request.
Start and end are Unix nanoseconds of ``CLOCK_REALTIME``
(``time.time_ns``), the clock on which the profiler stamps its host
events (``c10::getTime``), so spans lie on the same time line as the
profiler's trace of the device.

**Per-stage timing.** ``match_staged`` is the port's copy of
``adcensus_tpu/utils/profiling.py``: the reference's per-stage timing
printfs (ADCensusStereo.cpp:81-129), with each stage fenced so that its
time is the device's. On a CUDA device a stage runs between two CUDA
events after ``torch.cuda.synchronize()`` and is read after another; on
the CPU it is timed by ``time.perf_counter``. Throughput is Mpix*disp/s
per stage. It can also dump every intermediate volume and map to an
``.npz`` for debugging.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops.basic import check_cross_options, resolve_device
from adcensus_torch.stages import aggregate as agg_stage
from adcensus_torch.stages import arms as arms_stage
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.stages import refine as refine_stage
from adcensus_torch.stages import scanline as scan_stage
from adcensus_torch.stages import wta as wta_stage

# The stages of match_core, in order: the names of its spans and of
# match_staged's timings. "cost" holds both census transforms.
STAGES = ("cost", "arms", "aggregation", "scanline", "wta", "refine")
COST, ARMS, AGGREGATION, SCANLINE, WTA, REFINE = STAGES
# Spans kept; the oldest go first.
SPAN_CAPACITY = 1 << 16


class Span(NamedTuple):
    """One recorded span; times in Unix ns (CLOCK_REALTIME)."""

    request: int
    id: int
    parent: Optional[int]  # None for a request's outermost span
    name: str
    start_ns: int
    end_ns: int


class _Open:
    """A span being recorded: stamps its start on entry, its end and
    record on exit (an exception passes through)."""

    __slots__ = ("name", "request", "id", "parent", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        if stack:
            self.request, self.parent = stack[-1].request, stack[-1].id
        else:
            self.request, self.parent = next(_request_ids), None
        self.id = next(_span_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _local.stack.pop()
        _done.append(Span(self.request, self.id, self.parent, self.name,
                          self.start_ns, end_ns))
        return False


class _Local(threading.local):
    """A thread's open spans, innermost last."""

    def __init__(self):
        self.stack: List[_Open] = []


_OFF = contextlib.nullcontext()
_done: deque = deque(maxlen=SPAN_CAPACITY)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = _Local()


def span(name: str):
    """A context that records a span named ``name`` while a
    ``torch.profiler`` session is active, outside a CUDA graph capture;
    otherwise a shared no-op context."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    if (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        return _OFF
    return _Open(name)


def spanned(fn):
    """``fn`` run inside a span named after it: an entry point's."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapper


def spans() -> List[Span]:
    """The recorded spans, oldest first, each closed."""
    return list(_done)


def clear() -> None:
    """Forget every recorded span."""
    _done.clear()


def _timed(fn, args, dev: torch.device):
    """(fn(*args), seconds), fenced on ``dev``."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end) / 1e3


def match_staged(
    left: np.ndarray,
    right: np.ndarray,
    opts: Optional[ADCensusOptions] = None,
    cross_backend: str = "roll",
    agg_impl: Optional[str] = None,
    warmup: bool = True,
    dump_path: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Run the pipeline stage by stage with device fences.

    Returns {"disparity" (numpy), "timings": {stage: seconds},
    "throughput": {stage: Mpix*disp/s}}, the stages being cost, arms,
    aggregation, scanline, wta and refine, plus their "total". With
    ``warmup`` each stage runs once untimed first (kernel builds, the
    allocator's first blocks). The gray images are computed on the
    device, as the JAX package's ``match_staged`` does, whatever gray
    mode the caller uses elsewhere.
    """
    opts = opts or ADCensusOptions()
    opts.validate()
    check_cross_options(cross_backend, agg_impl)
    dev = resolve_device(device)
    h, w, _ = left.shape
    work = h * w * opts.disp_range

    left_d = torch.as_tensor(np.asarray(left), device=dev)
    right_d = torch.as_tensor(np.asarray(right), device=dev)
    gray_l = cost_stage.compute_gray(left_d)
    gray_r = cost_stage.compute_gray(right_d)

    timings = {}

    def run(name, fn, *args):
        if warmup:
            _timed(fn, args, dev)
        out, timings[name] = _timed(fn, args, dev)
        return out

    def stage_cost(left_t, right_t, g_l, g_r):
        census_l = cost_stage.census_transform_9x7(g_l)
        census_r = cost_stage.census_transform_9x7(g_r)
        return cost_stage.compute_cost_volume(left_t, right_t, census_l,
                                              census_r, opts)

    cost_init = run(COST, stage_cost, left_d, right_d, gray_l, gray_r)
    arms = run(ARMS, arms_stage.build_arms, left_d, opts)
    cost_aggr = run(
        AGGREGATION,
        lambda c, a: agg_stage.aggregate(c, a, opts,
                                         cross_backend=cross_backend,
                                         agg_impl=agg_impl),
        cost_init, arms,
    )
    cost_scan = run(SCANLINE, scan_stage.scanline_optimize, cost_aggr,
                    left_d, right_d, opts)
    disp_l, disp_r = run(WTA, lambda c: wta_stage.wta(c, opts), cost_scan)
    disp = run(
        REFINE,
        lambda *a: refine_stage.multistep_refine(
            *a, opts, cross_backend=cross_backend)["final"],
        disp_l, disp_r, left_d, cost_scan, arms,
    )

    throughput = {k: work / t / 1e6 for k, t in timings.items()}
    timings["total"] = sum(timings.values())
    throughput["total"] = work / timings["total"] / 1e6

    if dump_path:
        np.savez_compressed(
            dump_path,
            cost_init=cost_init.cpu().numpy(),
            arms=arms.cpu().numpy(),
            cost_aggr=cost_aggr.cpu().numpy(),
            cost_scan=cost_scan.cpu().numpy(),
            disp_left_raw=disp_l.cpu().numpy(),
            disp_right_raw=disp_r.cpu().numpy(),
            disparity=disp.cpu().numpy(),
        )

    return {
        "disparity": disp.cpu().numpy(),
        "timings": timings,
        "throughput": throughput,
    }

