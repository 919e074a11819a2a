"""The traced stretch: one torch.profiler pass that records the device's
activity alone (kernels, copies, sets, and the host's calls into the
CUDA runtime that start them), read back from the profiler's Chrome
trace into intervals that the per-layer readers take.

The profiler records no PyTorch op on the host: recording every op
slows a host-bound request about twofold, and the device's idle share
and the host's time would read that slowdown. The host's own time comes
from an unprofiled stretch of as many requests, run just before
(``plain_s_a_pair``).

The reading of device busy time and time by kernel follows
``chip_smoke.py:device_profile``: the union of the device's intervals,
and durations summed by kernel name.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10

Interval = Tuple[float, float]


def hand_kernels(bench: Path = BENCH) -> Dict[str, str]:
    """Kernel id -> the CUDA function name of each hand-written kernel."""
    with open(bench / "hand_kernels.json") as f:
        return json.load(f)


class Tracer:
    """Profiles the device's activity between start() and stop() (off a
    card, where there is none, the host's ops, so that the path runs)."""

    def __init__(self, torch, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        self._torch, self._cuda = torch, cuda
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        self._prof = profile(activities=acts)

    def start(self):
        self._prof.__enter__()

    def stop(self) -> "TraceData":
        if self._cuda:
            self._torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return TraceData.from_events(events)


def union(intervals: List[Interval]) -> List[Interval]:
    """The union of ``intervals``, sorted."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def covered(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


class TraceData:
    """Intervals in microseconds of one traced stretch, with what the
    harness adds: the stretch's length on the host's clock, the pairs it
    completed, and the host's seconds a pair in the unprofiled stretch."""

    def __init__(self, device_ops, runtime):
        # (start, end, name, category) of each device operation
        self.device_ops: List[Tuple[float, float, str, str]] = device_ops
        # (start, end, name) of each host call into CUDA
        self.runtime: List[Tuple[float, float, str]] = runtime
        self.window = 0.0               # s, host clock, synchronised
        self.pairs = 0                  # pairs the stretch completed
        self.plain_s_a_pair = 0.0       # s a pair, unprofiled
        self.shape = (0, 0, 0)          # (H, W, D) of a pair
        self.hand = hand_kernels()

    @classmethod
    def from_events(cls, events: List[dict]) -> "TraceData":
        device_ops, runtime = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat"), e.get("name", "")
            s = float(e["ts"])
            iv = (s, s + float(e["dur"]))
            if cat in DEVICE_CATS:
                device_ops.append((*iv, name, cat))
            elif cat in RUNTIME_CATS:
                runtime.append((*iv, name))
        return cls(device_ops, runtime)

    # --- the window -----------------------------------------------------
    def window_s(self) -> float:
        return self.window

    def busy(self) -> List[Interval]:
        return union([(s, e) for s, e, _, _ in self.device_ops])

    def busy_s(self) -> float:
        return covered(self.busy()) / 1e6

    # --- device time by kind -------------------------------------------
    def kernel_id(self, name: str) -> Optional[str]:
        """The hand-written kernel's id if ``name`` is one, else None."""
        for kid, symbol in self.hand.items():
            if symbol in name:
                return kid
        return None

    def kernels(self):
        return [(s, e, n) for s, e, n, c in self.device_ops if c == "kernel"]

    # --- the breakdown --------------------------------------------------
    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps between the first host call into CUDA and the device's last
        operation, each named by the host's call into CUDA around its
        middle, or else by the device operation that ends it."""
        by_name: Dict[str, float] = {}
        for s, e, name, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy()
        if not busy:
            return {"device_ops": [], "idle_gaps": []}
        lo = min([s for s, _, _ in self.runtime] + [busy[0][0]])
        gaps, last = [], lo
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        starts = sorted((s, n) for s, _, n, _ in self.device_ops)
        named = []
        for s, e in gaps:
            mid = (s + e) / 2
            around = [(ce - cs, n) for cs, ce, n in self.runtime
                      if cs <= mid <= ce]
            if around:
                what = min(around)[1]
            else:
                after = next((n for t, n in starts if t >= e), "the end")
                what = f"host, before {after}"
            named.append([what[:100], (e - s) / 1e6])
        return {"device_ops": [[n[:100], t / 1e6] for n, t in ops],
                "idle_gaps": named}
