"""The port's tracing: spans at the entry and stage boundaries of the
pipeline.

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
``STAGES``; inside ``refine``, ``refine.dda`` and ``refine.median``
around kernels M2 and M1 where their options are on. Spans are kept in
memory, the newest ``SPAN_CAPACITY``, and read with ``spans()``.

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

Per-stage timing with device fences is ``stages/staged.py:match_staged``.
This module imports no stage: the stages import ``span`` from it.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler

# The stages of match_core, in order: the names of its spans and of
# stages/staged.py's timings. "cost" holds both census transforms.
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
