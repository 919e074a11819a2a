"""One run of one benchmark cell, driven by files.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. Everything that belongs to one of them,
or to one metric, is a file found by its name:

* ``configs/<name>.json`` (the path that ``BENCHMARK.json`` gives): the
  deployment's sizes, tunables, scene and the limits of ``correct``;
* ``scenes/<scene>.py``: ``make(height, width, params, rng)`` -> (left,
  right, ground truth);
* ``traffic/<name>.json``: the mix, data only (``TRAFFIC_KEYS``): the
  program entry a request calls and its keyword arguments, the pairs a
  request carries, the pool of distinct pairs, the loop (closed, or open
  at a fixed rate), the warm-up requests and the traced stretch;
* ``entries/<entry>.py``: ``make(device, opts, **entry_args)`` -> the
  call a request makes into the program;
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: ``read(window)`` and
  ``read(trace)``, each returning a number or None. A metric named
  ``a.b`` falls back to ``a.py`` when ``a.b.py`` is absent, so one
  reader serves the variants of one quantity.

The program under test is ``adcensus_torch``: the harness imports it
only inside ``run_cell`` and the entries. The reference that decides
``correct`` is ``reference/adcensus.py``, which imports nothing of the
program.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that no process of the benchmark may hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "adcensus_tpu")
# Every key a traffic mix may hold, and the loops the harness runs. A mix
# with another key or loop is refused, so that no setting is silently
# ignored.
TRAFFIC_KEYS = {"entry", "entry_args", "pairs_per_request", "pool_pairs",
                "loop", "rate_hz", "warmup_requests", "trace_requests",
                "about"}
LOOPS = ("closed", "open")


# --- finding files by name -----------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_module(path: Path):
    name = "stereo_bench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_reader(kind: str, name: str, bench: Path = BENCH) -> Path:
    """``<kind>/<name>.py``, else ``<kind>/<name less its last dotted
    part>.py``; FileNotFoundError if neither exists."""
    candidates = [bench / kind / f"{name}.py"]
    if "." in name:
        candidates.append(bench / kind / f"{name.rsplit('.', 1)[0]}.py")
    for path in candidates:
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for {kind} metric {name!r}: "
                            f"looked for {[str(p) for p in candidates]}")


def check_traffic(name: str, traffic: dict, bench: Path = BENCH) -> dict:
    """``traffic`` if the harness runs every setting it holds; ValueError
    (or FileNotFoundError for a missing entry) if not."""
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic {name!r}: keys {sorted(unknown)} are not "
                         f"read by the harness (it reads {sorted(TRAFFIC_KEYS)})")
    if traffic.get("loop") not in LOOPS:
        raise ValueError(f"traffic {name!r}: loop must be one of {LOOPS}")
    if (traffic["loop"] == "open") != ("rate_hz" in traffic):
        raise ValueError(f"traffic {name!r}: rate_hz is given with, and "
                         "only with, the open loop")
    if traffic["loop"] == "open" and not traffic["rate_hz"] > 0:
        raise ValueError(f"traffic {name!r}: rate_hz must be positive")
    for key in ("pairs_per_request", "pool_pairs", "trace_requests"):
        if not (isinstance(traffic.get(key), int) and traffic[key] >= 1):
            raise ValueError(f"traffic {name!r}: {key} must be a whole "
                             "number of at least 1")
    if not (isinstance(traffic.get("warmup_requests"), int)
            and traffic["warmup_requests"] >= 0):
        raise ValueError(f"traffic {name!r}: warmup_requests must be a "
                         "whole number")
    if not isinstance(traffic.get("entry_args", {}), dict):
        raise ValueError(f"traffic {name!r}: entry_args must be an object")
    entry = bench / "entries" / f"{traffic.get('entry')}.py"
    if not entry.is_file():
        raise FileNotFoundError(f"traffic {name!r}: no entry {entry}")
    return traffic


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    e2e: List[dict]          # end-to-end metric entries it reports
    per_layer: List[dict]    # per-layer metric entries it reports
    bench: Path = BENCH

    @classmethod
    def from_spec(cls, spec: dict, workload: str, root: Path = ROOT,
                  bench: Path = BENCH) -> "Cell":
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"unknown workload {workload!r}; the cells are "
                           f"{sorted(cells)}")
        w = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        with open(root / configs[w["config"]]["file"]) as f:
            config = json.load(f)
        with open(bench / "traffic" / f"{w['traffic']}.json") as f:
            traffic = check_traffic(w["traffic"], json.load(f), bench)

        def applies(m):
            return "workloads" not in m or workload in m["workloads"]

        return cls(workload, int(w["chips"]), config, traffic,
                   [m for m in spec["end_to_end"] if applies(m)],
                   [m for m in spec["per_layer"] if applies(m)], bench)

    def scene(self):
        return _load_module(self.bench / "scenes" / f"{self.config['scene']}.py")

    def options(self) -> dict:
        o = dict(self.config["options"])
        o["min_disparity"] = self.config["min_disparity"]
        o["max_disparity"] = self.config["max_disparity"]
        return o

    def pair_work(self, shape=None) -> int:
        """H * W * D of one pair of ``shape`` (default: the
        configuration's): pixel-disparities."""
        c = self.config
        h, w = shape[:2] if shape is not None else (c["height"], c["width"])
        return h * w * (c["max_disparity"] - c["min_disparity"])


# --- inputs ---------------------------------------------------------------

def seed_words(seed: int, *more: int) -> list:
    """Entropy for numpy's SeedSequence: any Python int as its two's
    complement in 64 bits, then ``more``."""
    return [seed & (2 ** 64 - 1), *more]


def make_pool(cell: Cell, seed: int):
    """The cell's pool of distinct pairs, each made from (seed, i):
    lists of lefts, rights and ground truths."""
    c = cell.config
    scene = cell.scene()
    lefts, rights, gts = [], [], []
    for i in range(cell.traffic["pool_pairs"]):
        rng = np.random.default_rng(seed_words(seed, i))
        left, right, gt = scene.make(c["height"], c["width"],
                                     c["scene_params"], rng)
        lefts.append(left)
        rights.append(right)
        gts.append(gt)
    return lefts, rights, gts


# Offsets into the bank of flipped bits: a prime, so that pool pair
# g mod P and offset g mod FLIP_PERIOD repeat together only after
# P * FLIP_PERIOD pairs, far more than a window serves.
FLIP_PERIOD = 4093


class Requests:
    """The pairs that requests carry, made fresh for each request.

    Request k carries pairs g = k * B + j, j < B. Pair g is pool pair
    g mod P with the least significant bit of each image's values flipped
    where a seeded bank of bits says, read from offset g mod FLIP_PERIOD
    (the left image) and (g + FLIP_PERIOD // 2) mod FLIP_PERIOD (the
    right): sensor noise of one grey level, so that no two pairs of a
    window hold the same bytes, and every request comes in new arrays. A
    result kept from an earlier request, by address or by content, is
    then wrong for this one."""

    def __init__(self, lefts, rights, per_request: int,
                 rng: np.random.Generator):
        self.lefts, self.rights = lefts, rights
        self.p, self.b = len(lefts), per_request
        n = max(img.size for img in lefts + rights)
        self.bank = rng.integers(0, 2, size=n + FLIP_PERIOD, dtype=np.uint8)

    def pair_ids(self, k: int) -> list:
        return [k * self.b + j for j in range(self.b)]

    def pool_index(self, g: int) -> int:
        return g % self.p

    def _noisy(self, img: np.ndarray, offset: int, out=None) -> np.ndarray:
        flips = self.bank[offset:offset + img.size].reshape(img.shape)
        return np.bitwise_xor(img, flips, out=out)

    def pair(self, g: int, out_left=None, out_right=None):
        """Pair g as (left, right), new arrays unless ``out_*`` is given."""
        i, m = g % self.p, FLIP_PERIOD
        return (self._noisy(self.lefts[i], g % m, out_left),
                self._noisy(self.rights[i], (g + m // 2) % m, out_right))

    def inputs(self, k: int, stacked: bool):
        """Request k's pairs: (B, H, W, 3) stacks of left and right
        images, or, unless ``stacked``, a list of (left, right)."""
        ids = self.pair_ids(k)
        if not stacked:
            return [self.pair(g) for g in ids]
        shape = (self.b,) + self.lefts[0].shape
        lefts = np.empty(shape, self.lefts[0].dtype)
        rights = np.empty(shape, self.rights[0].dtype)
        for j, g in enumerate(ids):
            self.pair(g, lefts[j], rights[j])
        return lefts, rights


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length
    (Algorithm R), drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


# --- program entries ------------------------------------------------------

def load_entry(cell: Cell, device, opts):
    """The call that a request makes: ``entries/<entry>.py``'s
    ``make(device, opts, **entry_args)``. It takes the request's pairs
    as the module's ``INPUTS`` says ("stacks": (B, H, W, 3) arrays of
    lefts and rights; "pairs": a list of (left, right)) and returns B
    float32 disparity maps on the host."""
    module = _load_module(cell.bench / "entries" / f"{cell.traffic['entry']}.py")
    inputs = getattr(module, "INPUTS", "stacks")
    if inputs not in ("stacks", "pairs"):
        raise ValueError(f"entry {cell.traffic['entry']!r}: INPUTS must be "
                         f"'stacks' or 'pairs', not {inputs!r}")
    call = module.make(device, opts, **cell.traffic.get("entry_args", {}))
    return call, inputs == "stacks"


def control_entry(device, vol_dtype, options: dict):
    """The reference in the program's place, in ``vol_dtype``: the
    benchmark's control. Takes (B, H, W, 3) stacks."""
    from stereo_bench.reference import adcensus as ref

    def run(lefts, rights):
        return np.stack([ref.match(l, r, options, device, vol_dtype)
                         for l, r in zip(lefts, rights)])

    return run


# --- results --------------------------------------------------------------

@dataclass
class Window:
    """What the measured window saw, for the end-to-end readers. Times in
    seconds, one entry a request."""

    latencies_s: List[float]   # from when it was due to its maps in hand
    service_s: List[float]     # from when it was sent to its maps in hand
    pairs: int                 # pairs completed
    work: int                  # H * W * D summed over them
    setup_s: float


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    breakdown: Optional[dict] = None

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return json.dumps(out)


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of ``modules`` (default: sys.modules) that are in
    FORBIDDEN_MODULES, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def mismatch_count(out: np.ndarray, ref: np.ndarray) -> int:
    """Pixels whose disparity differs from the reference's, bit for bit
    in value (+inf equals +inf; NaN equals NaN)."""
    same = (out == ref) | (np.isnan(out) & np.isnan(ref))
    return int(same.size - same.sum())


def bad_pct(disp: np.ndarray, gt: np.ndarray, delta: float = 2.0) -> float:
    """Share of pixels with |disp - gt| > delta, invalid ones bad, in %."""
    valid = np.isfinite(disp)
    bad = ~valid | (np.abs(np.where(valid, disp, 0.0) - gt) > delta)
    return float(bad.mean()) * 100.0


def outputs_ok(out, shapes) -> bool:
    """One float32 map a pair, of the pair's height and width."""
    return (len(out) == len(shapes) and all(
        isinstance(o, np.ndarray) and o.dtype == np.float32
        and o.shape == tuple(s[:2]) for o, s in zip(out, shapes)))


def host_state() -> str:
    """What the host's speed may depend on: a fixed Python loop's time,
    the CPUs' clock as the kernel reports it, the frequency governor, the
    NUMA nodes and the CPUs this process may run on."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i * i
    loop_ms = (time.perf_counter() - t0) * 1e3
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        mhz_text = f"{min(mhz):.0f}-{max(mhz):.0f} MHz" if mhz else "no MHz"
    except OSError:
        mhz_text = "no /proc/cpuinfo"

    def first_line(path):
        try:
            return Path(path).read_text().split("\n")[0]
        except OSError:
            return "none"

    nodes = len(list(Path("/sys/devices/system/node").glob("node[0-9]*")))
    return (f"python loop {loop_ms:.3f} ms; cpu {mhz_text}; governor "
            f"{first_line('/sys/devices/system/cpu/cpu0/cpufreq/scaling_governor')}"
            f"; NUMA nodes {nodes}; CPUs allowed {len(os.sched_getaffinity(0))}")


def dispatch_us(torch, dev, n: int = 2000) -> float:
    """Host microseconds a small PyTorch op takes to issue on ``dev``:
    ``n`` in-place adds to one value, then one synchronisation."""
    x = torch.zeros(1, device=dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    _sync(torch, dev)
    return (time.perf_counter() - t0) * 1e6 / n


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", process_age: Callable[[], float] = lambda: 0.0,
             entry: Optional[Callable] = None, warmup: Optional[int] = None,
             log=print) -> Outcome:
    """Set up the cell, run its window (or, with ``trace``, its traced
    stretch), then judge the sampled outputs against the reference.

    ``process_age()`` gives the seconds since the process started;
    ``entry`` replaces the mix's program entry with a call that takes
    (B, H, W, 3) stacks (the control); ``warmup`` replaces the mix's
    count of warm-up requests."""
    import torch

    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.ops import _build
    from adcensus_torch.utils import graphs
    from stereo_bench.reference import adcensus as ref

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tr = cell.traffic
    opts = ADCensusOptions(**cell.options())
    lefts, rights, gts = make_pool(cell, seed)
    requests = Requests(lefts, rights, tr["pairs_per_request"],
                        np.random.default_rng(seed_words(seed, 1 << 21)))
    if entry is None:
        call, stacked = load_entry(cell, dev, opts)
    else:
        call, stacked = entry, True
    rate = tr.get("rate_hz")

    def request(k, inputs=None):
        if inputs is None:
            inputs = requests.inputs(k, stacked)
        shapes = ([x.shape for x in inputs[0]] if stacked
                  else [l.shape for l, _ in inputs])
        t_sent = time.perf_counter()
        out = call(*inputs) if stacked else call(inputs)
        t_done = time.perf_counter()
        return out, outputs_ok(out, shapes), shapes, t_sent, t_done

    n_warm = tr["warmup_requests"] if warmup is None else warmup
    for k in range(n_warm):
        request(k)
    _sync(torch, dev)
    _build.reset_launches()
    setup_s = process_age()

    sample = Reservoir(cell.config["check"]["pairs"],
                       np.random.default_rng(seed_words(seed, 1 << 20)))
    counts = {"attempted": 0, "failed": 0, "pairs": 0, "work": 0}
    k = n_warm

    def stretch(stop, latencies, service, made=None):
        """Requests until ``stop(requests done, seconds since start)``; in
        an open loop request i of the stretch is due ``i / rate`` s after
        its start and waits for that, and its latency counts from then.
        ``made`` holds inputs made beforehand, by request number."""
        nonlocal k
        t_first = time.perf_counter()
        i = 0
        while True:  # at least one request
            if rate:
                due = t_first + i / rate
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            out, ok, shapes, t_sent, t_done = request(
                k, made.pop(k) if made else None)
            latencies.append(t_done - (due if rate else t_sent))
            service.append(t_done - t_sent)
            counts["attempted"] += len(shapes)
            if not ok:
                counts["failed"] += len(shapes)
            else:
                counts["pairs"] += len(shapes)
                counts["work"] += sum(cell.pair_work(s) for s in shapes)
                for j, g in enumerate(requests.pair_ids(k)):
                    sample.offer((g, out[j]))
            k += 1
            i += 1
            if stop(i, time.perf_counter() - t_first):
                return time.perf_counter() - t_first

    latencies, service = [], []
    trace_data = None
    if trace:
        # The same number of requests unprofiled, then profiled: the host's
        # own time comes from the first, the device's from the second,
        # whose inputs are made before the profiler starts.
        n_tr = tr["trace_requests"]
        stretch(lambda i, _: i >= n_tr, latencies, service)
        plain_pairs = counts["pairs"]
        made = {k + i: requests.inputs(k + i, stacked) for i in range(n_tr)}
        from stereo_bench import trace as trace_mod
        tracer = trace_mod.Tracer(torch, cuda)
        tracer.start()
        _sync(torch, dev)
        t0 = time.perf_counter()
        stretch(lambda i, _: i >= n_tr, [], [], made)
        _sync(torch, dev)
        traced_s = time.perf_counter() - t0
        trace_data = tracer.stop()
        trace_data.window = traced_s
        trace_data.pairs = counts["pairs"] - plain_pairs
        trace_data.plain_s_a_pair = (sum(service) / plain_pairs
                                     if plain_pairs else 0.0)
    else:
        stretch(lambda i, t: t >= seconds, latencies, service)
    window_s = sum(service)

    # what the process held of the card at its fullest: a graph's pools
    # stay reserved after its capture, so allocated memory undercounts it
    memory_peak = int(torch.cuda.max_memory_reserved(dev)) if cuda else 0
    allocated_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    launches = dict(_build.launches)
    group = None
    cached = graphs.cached()
    if cached:
        group = int(cached[-1].outputs.shape[0])
        launches = dict(cached[-1].launches)
        launch_pairs = group
    else:
        launch_pairs = max(counts["pairs"], 1)
    log(f"[bench] {cell.name} seed {seed}: {len(latencies)} requests, "
        f"{counts['pairs']} pairs in {window_s:.6f} s of service; group "
        f"{group}; launches a pair "
        + json.dumps({n: c / launch_pairs for n, c in launches.items() if c}))
    q = np.quantile(latencies, [0.05, 0.5, 0.95]) * 1e3
    log(f"[bench] request ms p5 {q[0]:.3f} p50 {q[1]:.3f} p95 {q[2]:.3f} "
        f"max {max(latencies) * 1e3:.3f}; mean by third of the run "
        + " ".join(f"{np.mean(t) * 1e3:.3f}"
                   for t in np.array_split(latencies, 3) if len(t)))
    log(f"[bench] peak reserved {memory_peak} bytes, peak allocated "
        f"{allocated_peak} bytes")
    log(f"[bench] host after the run: {host_state()}; "
        f"{dispatch_us(torch, dev):.3f} us to issue a small op")

    # free the program's state before the reference runs on the device
    del call
    graphs.clear()
    if cuda:
        torch.cuda.empty_cache()

    opt_dict = cell.options()
    mismatched, pixels, bads = 0, 0, []
    for g, out in sample.items:
        left, right = requests.pair(g)
        want = ref.match(left, right, opt_dict, dev)
        mismatched += mismatch_count(out, want)
        pixels += out.size
        bads.append(bad_pct(out, gts[requests.pool_index(g)]))
    mismatch_pct = 100.0 * mismatched / pixels if pixels else 100.0
    limits = cell.config["check"]["limits"]
    checks = {
        "mismatch_pct": {"value": mismatch_pct,
                         "limit": limits["mismatch_pct"]},
        "failed_pairs": {"value": counts["failed"], "limit": 0},
    }
    correct = bool(sample.items) and all(
        c["value"] <= c["limit"] for c in checks.values())
    log(f"[bench] compared {len(sample.items)} sampled pairs with the "
        f"reference; bad-2.0 against the scene's ground truth "
        f"{json.dumps(bads)}")

    if cuda:
        props = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": cell.chips}
    else:
        props = {"platform": "cpu", "kind": "cpu", "count": 1}
    props["memory_peak_bytes"] = memory_peak

    metrics, breakdown = {}, None
    if trace:
        props["busy_s"] = trace_data.busy_s()
        props["window_s"] = trace_data.window_s()
        trace_data.shape = (lefts[0].shape[0], lefts[0].shape[1],
                            cell.config["max_disparity"]
                            - cell.config["min_disparity"])
        for m in cell.per_layer:
            reader = _load_module(find_reader("metrics", m["name"], cell.bench))
            value = reader.read(trace_data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace_data.breakdown()
    else:
        win = Window(latencies, service, counts["pairs"], counts["work"],
                     setup_s)
        for m in cell.e2e:
            reader = _load_module(find_reader("e2e", m["name"], cell.bench))
            value = reader.read(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return Outcome(correct, counts["attempted"], counts["failed"], metrics,
                   props, checks, breakdown)
