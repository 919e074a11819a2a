"""A served entry of the sharded layer: one caller sends numpy pairs and
gets one disparity map a pair back, over ranks that stay up from request
to request.

Rank 0 is the caller's own process, on the device it is given. Ranks 1
to world - 1 are worker processes that ``ShardedMatcher`` starts as

    python -m adcensus_torch.parallel.serve --rank i --world n \\
        --init-method file:///... --device cuda --options '{...}' ...

each on card i (``distributed.initialize``), and stops in ``close``. All
ranks join one process group, the mesh of ``distributed.pod_mesh`` (one
host: (1, world)) and a gloo group of their own on the CPU. A request:

1. rank 0 sends a header (command, height, width) on the gloo group,
   where the workers wait between requests, so that no NCCL kernel waits
   on a card between requests;
2. rank 0 copies the pair to its device (span ``entry.h2d``) and
   broadcasts it on the mesh's tile group (``shard.broadcast``);
3. every rank computes the grays on its device and runs
   ``sharded.match_sharded``; rank 0 copies the gathered map back
   (``entry.d2h``).

The same header asks every rank for its card's peak reserved bytes, or
tells the workers to stop. A worker exits by itself when rank 0's process
ends. A collective whose peers do not answer gives up after
``TIMEOUT_S``; ``match`` raises at once when a worker has exited.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from adcensus_torch.config import ADCensusOptions
from adcensus_torch.ops import _build
from adcensus_torch.ops.basic import check_cross_options, resolve_device
from adcensus_torch.parallel import distributed, sharded
from adcensus_torch.stages import cost as cost_stage
from adcensus_torch.stages.pipeline import validate_inputs
from adcensus_torch.utils.profiling import span, spanned

# How long a collective, and the rendezvous, wait for their peers before
# they give up: a rank that died or hangs mid-request. A full-size pair
# takes well under a second; the first one's NCCL set-up a few seconds.
TIMEOUT_S = 120.0
# How long the workers wait for the next request, idle, on the gloo group.
IDLE_TIMEOUT = timedelta(days=30)
# How long the workers may take to start (import torch, load the kernels:
# about 8 s each on the card machine) before the matcher gives up.
START_S = 300.0
# How long close() waits for a worker to exit before it kills it.
JOIN_S = 30.0
# Commands of the header.
MATCH, PEAK, STOP = 0, 1, 2
# The directory from which `python -m adcensus_torch...` finds the package.
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class _Rank:
    """One rank's part: its options, device and groups."""

    opts: ADCensusOptions
    volume_axis: str
    cross_backend: str
    device: torch.device
    mesh: object = None
    cpu_group: object = None

    def join(self, init_method: str, world: int, rank: int) -> None:
        """Join the process group, the mesh and the gloo group; every rank
        makes these calls in this order."""
        cuda = self.device.type == "cuda"
        distributed.initialize(init_method, world, rank,
                               "nccl" if cuda else "gloo",
                               timeout=timedelta(seconds=TIMEOUT_S))
        self.mesh = distributed.pod_mesh()
        self.cpu_group = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)

    def header(self, command: int = MATCH, h: int = 0, w: int = 0):
        """The request's (command, height, width): rank 0's, sent to
        every rank."""
        out = torch.tensor([command, h, w], dtype=torch.int64)
        dist.broadcast(out, src=0, group=self.cpu_group)
        return [int(v) for v in out]

    def match(self, pair: torch.Tensor) -> torch.Tensor:
        """The (H, W) disparity of the (2, H, W, 3) pair that rank 0
        holds, on every rank."""
        sharded._broadcast(pair, self.mesh.get_group("tile"))
        left, right = pair[0], pair[1]
        return sharded.match_sharded(
            left, right, cost_stage.compute_gray(left),
            cost_stage.compute_gray(right), self.opts, self.mesh,
            self.cross_backend, self.volume_axis)

    def peak_bytes(self) -> List[int]:
        """Each rank's peak reserved bytes of its device, in rank order
        (0 off a card)."""
        mine = (torch.cuda.max_memory_reserved(self.device)
                if self.device.type == "cuda" else 0)
        out = [torch.zeros(1, dtype=torch.int64)
               for _ in range(dist.get_world_size())]
        dist.all_gather(out, torch.tensor([mine], dtype=torch.int64),
                        group=self.cpu_group)
        return [int(t) for t in out]


class ShardedMatcher:
    """``match(left, right)``: (H, W, 3) uint8 numpy images in, the (H,
    W) float32 disparity out (+inf where invalid), as ``pipeline.match``
    returns it, computed by ``sharded.match_sharded`` over ``world``
    ranks. Rank 0 is this process, on ``device`` (card 0 with CUDA: rank
    i takes card i); the others are worker processes that live until
    ``close``. ``init_method`` names the rendezvous (default: a file
    under a new temporary directory). One matcher a process at a time:
    it owns the process's default process group."""

    def __init__(self, opts: Optional[ADCensusOptions] = None,
                 world: int = 4, volume_axis: str = "rows",
                 cross_backend: str = "roll", device="cuda",
                 init_method: Optional[str] = None):
        opts = opts or ADCensusOptions()
        opts.validate()
        check_cross_options(cross_backend)
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        # the layout's checks, before any process starts
        sharded._body(volume_axis, opts, world, cross_backend)
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dev.index not in (None, 0):
                raise ValueError("rank 0 runs on card 0 and rank i on card "
                                 f"i; got device {dev}")
            if torch.cuda.device_count() < world:
                raise ValueError(f"{world} ranks need {world} cards, "
                                 f"{torch.cuda.device_count()} present")
            dev = torch.device("cuda", 0)
            _build.build()  # every rank then loads what is built here
        if dist.is_initialized():
            raise RuntimeError("this process already has a process group: "
                               "one ShardedMatcher a process at a time")
        self.opts, self.world, self.device = opts, world, dev
        self._rank = _Rank(opts, volume_axis, cross_backend, dev)
        self._closed = False
        self._tmp = Path(tempfile.mkdtemp(prefix="adcensus-serve-"))
        init_method = init_method or "file://" + str(self._tmp / "store")
        self._procs: List[subprocess.Popen] = []
        try:
            for rank in range(1, world):
                self._procs.append(subprocess.Popen(
                    [sys.executable, "-m", "adcensus_torch.parallel.serve",
                     "--rank", str(rank), "--world", str(world),
                     "--init-method", init_method,
                     "--device", dev.type,
                     "--options", json.dumps(dataclasses.asdict(opts)),
                     "--volume-axis", volume_axis,
                     "--cross-backend", cross_backend,
                     "--ready", str(self._tmp / f"ready.{rank}")],
                    cwd=_PACKAGE_ROOT, stdin=subprocess.DEVNULL))
            self._wait_ready()
            self._rank.join(init_method, world, 0)
        except BaseException:
            self.close()
            raise

    def _wait_ready(self) -> None:
        """Return once every worker has started; raise if one exits or
        ``START_S`` passes first."""
        deadline = time.monotonic() + START_S
        while not all((self._tmp / f"ready.{r}").exists()
                      for r in range(1, self.world)):
            self._check_workers()
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers did not start in {START_S} s")
            time.sleep(0.05)

    def _check_workers(self) -> None:
        for rank, proc in enumerate(self._procs, 1):
            code = proc.poll()
            if code is not None:
                raise RuntimeError(f"rank {rank} exited with code {code}")

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("the ShardedMatcher is closed")
        self._check_workers()

    @spanned
    def match(self, left, right) -> np.ndarray:
        self._check_open()
        left = np.ascontiguousarray(left)
        right = np.ascontiguousarray(right)
        validate_inputs(left, right, self.opts)
        h, w = left.shape[:2]
        self._rank.header(MATCH, h, w)
        with span("entry.h2d"):
            pair = torch.empty((2, h, w, 3), dtype=torch.uint8,
                               device=self.device)
            pair[0].copy_(torch.from_numpy(left))
            pair[1].copy_(torch.from_numpy(right))
        disp = self._rank.match(pair)
        with span("entry.d2h"):
            return disp.cpu().numpy()

    def peak_bytes(self) -> List[int]:
        """Each card's peak reserved bytes (``max_memory_reserved``), in
        rank order."""
        self._check_open()
        self._rank.header(PEAK)
        return self._rank.peak_bytes()

    def close(self) -> None:
        """Stop the workers (killing any that do not exit within
        ``JOIN_S``) and end the process groups; a second call does
        nothing."""
        if self._closed:
            return
        self._closed = True
        try:
            if dist.is_initialized():
                try:
                    if all(p.poll() is None for p in self._procs):
                        self._rank.header(STOP)
                finally:
                    dist.destroy_process_group()
        finally:
            for proc in self._procs:
                try:
                    proc.wait(timeout=JOIN_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "ShardedMatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _exit_with(parent: int) -> None:
    """End this process once ``parent`` is no longer its parent."""
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(1)


def main(argv=None) -> int:
    """A worker rank: join, then serve requests until told to stop."""
    p = argparse.ArgumentParser(description="A worker rank of "
                                "ShardedMatcher; started by it.")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    p.add_argument("--options", required=True)
    p.add_argument("--volume-axis", required=True)
    p.add_argument("--cross-backend", required=True)
    p.add_argument("--ready", required=True)
    args = p.parse_args(argv)
    threading.Thread(target=_exit_with, args=(os.getppid(),),
                     daemon=True).start()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
        _build.build()
    else:
        torch.set_num_threads(1)
    rank = _Rank(ADCensusOptions(**json.loads(args.options)),
                 args.volume_axis, args.cross_backend, dev)
    Path(args.ready).touch()
    rank.join(args.init_method, args.world, args.rank)
    try:
        while True:
            command, h, w = rank.header()
            if command == STOP:
                return 0
            if command == PEAK:
                rank.peak_bytes()
            else:
                rank.match(torch.empty((2, h, w, 3), dtype=torch.uint8,
                                       device=dev))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
