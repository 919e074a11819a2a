"""CUDA graphs of the multi-pair pipelines: the port's counterpart of
``jax.jit`` and its compile cache for ``match_batched_device``,
``match_hetero_device`` and ``match_batched`` (``stages/pipeline.py``).

One eager match dispatches hundreds of small PyTorch ops and the card
waits on the host between them. A group of pairs is therefore captured
once into one graph and replayed for every later group with the same
key. Each pair of the group is a branch of the graph: it runs on its own
stream, forked from the capture stream and joined back to it, so the card
may overlap the pairs' kernels, as XLA's scheduler overlaps the JAX
package's statically unrolled group (``adcensus_tpu/stages/
pipeline.py:180-199``). Each branch runs the same code as ``match_device``
on its pair, so its output is the same bit for bit.

Inputs and outputs are static device buffers: the caller copies a group
into ``inputs``, replays, and copies ``outputs`` out before the next
replay overwrites them. The kernels' launch counts
(``ops/_build.launches``) rise while a group is captured, never on a
replay; ``GroupGraph.launches`` keeps what the capture added.

Before a capture, the kernels are built and each distinct pair of the
group (shape and options) runs once eagerly on the capture stream. That
fills ``stages/refine.ray_offsets``' cache (a host-to-device copy) and,
on the matmul paths, cuBLAS's handle, none of which may be made during a
capture. A capture that fails raises, naming the stage it failed in;
nothing retries eagerly.
"""
from __future__ import annotations

import traceback
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Hashable, NamedTuple, Sequence

import torch

from adcensus_torch.ops import _build

# Graphs kept at once. Each holds its whole group's intermediates in a
# memory pool of its own (stages/pipeline.py: pair_bytes a pair), so the
# cache stays small; clear() frees them all.
CACHE_SIZE = 4

_STAGES = Path(__file__).resolve().parent.parent / "stages"

_cache: "OrderedDict[Hashable, GroupGraph]" = OrderedDict()
captures = 0  # graphs captured since import; a cache hit adds none


class GroupGraph(NamedTuple):
    """One captured group. ``graph.replay()`` runs it on the current
    stream."""

    graph: object  # torch.cuda.CUDAGraph
    inputs: object  # static device buffers, made by make_buffers
    outputs: object  # static device buffers, indexed by branch
    launches: dict  # kernel launches the capture counted


def captured(
    key: Hashable,
    device: torch.device,
    make_buffers: Callable[[], tuple],
    run_branch: Callable[[int, object], torch.Tensor],
    n_branches: int,
    warm_up: Sequence[int],
) -> GroupGraph:
    """The graph of ``key`` on ``device``, from the cache or captured now.

    On a miss, ``make_buffers()`` returns (inputs, outputs), static device
    buffers; branch i of the graph writes ``run_branch(i, inputs)`` into
    ``outputs[i]``. ``warm_up`` lists the branches to run eagerly first,
    one of each distinct shape and options."""
    global captures
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    full_key = (key, device)
    entry = _cache.get(full_key)
    if entry is not None:
        _cache.move_to_end(full_key)
        return entry
    while len(_cache) >= CACHE_SIZE:  # free a pool before making one
        _cache.popitem(last=False)
    entry = _capture(device, make_buffers, run_branch, n_branches, warm_up)
    _cache[full_key] = entry
    captures += 1
    return entry


def cached() -> tuple:
    """The cached graphs, least recently used first."""
    return tuple(_cache.values())


def clear() -> None:
    """Drop every cached graph and return their pools to the card."""
    _cache.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _capture(device, make_buffers, run_branch, n, warm_up):
    _build.build()
    inputs, outputs = make_buffers()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for i in warm_up:
            run_branch(i, inputs)
    graph = torch.cuda.CUDAGraph()
    before = dict(_build.launches)
    # The outer context puts the caller's stream back even when a failed
    # capture leaves torch.cuda.graph's own stream context open.
    with torch.cuda.stream(torch.cuda.current_stream(device)):
        try:
            with torch.cuda.graph(graph, stream=stream):
                forks = [torch.cuda.Stream(device) for _ in range(n)]
                for i, fork in enumerate(forks):
                    fork.wait_stream(stream)
                    with torch.cuda.stream(fork):
                        outputs[i].copy_(run_branch(i, inputs))
                for fork in forks:
                    stream.wait_stream(fork)
        except RuntimeError as err:
            raise RuntimeError(
                f"CUDA graph capture failed{_stage_of(err)}: {err}"
            ) from err
    launches = {k: _build.launches[k] - before[k] for k in before}
    return GroupGraph(graph, inputs, outputs, launches)


def _stage_of(err: BaseException) -> str:
    """' in stage <module>.<function>', the innermost frame of
    ``adcensus_torch/stages`` that ``err`` or the error it arose from
    passed through, or '' if none did."""
    stage = ""
    while err is not None:
        for frame in traceback.extract_tb(err.__traceback__):
            path = Path(frame.filename).resolve()
            if path.parent == _STAGES:
                stage = f" in stage {path.stem}.{frame.name}"
        if stage:
            return stage
        err = err.__cause__ or err.__context__
    return stage
