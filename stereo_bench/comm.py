"""Bytes that one rank of ``adcensus_torch.parallel.serve`` receives from
the others in one pair, from the cell's geometry alone: the numerator of
``shard.link_pct``. A test holds it equal to the program's own counter
(``sharded.comm_bytes``), so that a change to what the program moves
shows as a failing test, not as a reading that drifts.

The pair runs ``match_sharded`` in the rows layout with the default
refinement (LR check, voting and interpolation on; neither the
discontinuity adjustment nor the in-place median), on a (1, n) mesh. A
collective counts as its meaning has it, not as its algorithm routes it:
the broadcast of the pair reaches each rank but the first once, an
all-gather gives each rank the n - 1 blocks of the others, an all-to-all
the n - 1 blocks the others hold for it, and a halo exchange the rows its
row neighbours send.

The link's peak, for the share: one direction of one card's NVLink on
the card host, as ``nvidia-smi nvlink -s`` printed it there (NVIDIA H100
80GB HBM3, 4 cards through NVSwitch): 18 links at 26.562 GB/s, 478.1
GB/s. NVIDIA's data sheet gives 450 GB/s a direction (900 GB/s both
ways); the larger is taken, so that the share cannot read high from the
peak's side. ``nvidia-smi topo -m`` printed no matrix there.
"""
from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
LINK_BYTES_PER_S = 18 * 26.562e9   # one direction of one card's NVLink
F32 = I32 = 4
I64 = 8
AGG_ITERS = 4              # cross-aggregation passes, a halo exchange each
VOTE_PASSES = 10           # region voting: 5 rounds of 2 phases
INTERP_PASSES = 2          # interpolation phases, a gather of the map each


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def halo_received(rows: int, halo: int, rank: int, n: int,
                  row_bytes: int) -> int:
    """Bytes rank ``rank`` receives in one halo exchange of ``halo`` rows
    of ``row_bytes`` each around its ``rows``-row slab: from each
    neighbour within reach, the rows it keeps (several hops where the
    halo is deeper than a slab)."""
    total, s = 0, 1
    while (s - 1) * rows < halo:
        kept = min(rows, halo - (s - 1) * rows)
        total += kept * row_bytes * ((rank - s >= 0) + (rank + s < n))
        s += 1
    return total


def received_bytes(h: int, w: int, d: int, n: int, halo: int,
                   rank: int = 0) -> int:
    """Bytes rank ``rank`` of ``n`` receives in one (h, w) pair at ``d``
    disparities with ``halo``-row halos (``min(cross_L1, 255)``)."""
    hp, wp = _ceil_to(h, n), _ceil_to(w, n)
    h_local, w_local = hp // n, wp // n
    others = n - 1
    total = 0 if rank == 0 else 2 * h * w * 3          # the pair, uint8
    total += others * 4 * h_local * wp * I32            # arms
    total += others * 2 * h_local * wp * I32            # support counts
    total += others * 2 * hp * w_local * I32            # right y distances
    total += AGG_ITERS * halo_received(h_local, halo, rank, n, d * wp * F32)
    total += 2 * others * (d * h_local * wp * F32 // n)  # both reshards
    total += VOTE_PASSES * halo_received(h_local, halo, rank, n, wp * F32)
    total += INTERP_PASSES * others * h_local * wp * F32
    # the out-of-place median: a row of the map and of the in-image mask
    total += halo_received(h_local, 1, rank, n, wp * (F32 + 1))
    total += others * h_local * wp * F32                # the map
    return total


def nccl_ms(trace):
    """Device ms a pair in NCCL's kernels ("nccl" in the name, any case),
    their durations summed; None without one."""
    ks = [e - s for s, e, n in trace.kernels() if "nccl" in n.lower()]
    if not ks or trace.pairs == 0:
        return None
    return sum(ks) / 1e3 / trace.pairs


def cell_geometry(workload: str, root: Path = BENCH.parent):
    """(h, w, d, n, halo) of a cell of ``BENCHMARK.json``: n is its
    chips, one rank a card."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(c for c in spec["workloads"] if c["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    d = cfg["max_disparity"] - cfg["min_disparity"]
    return (cfg["height"], cfg["width"], d, cell["chips"],
            min(cfg["options"]["cross_L1"], 255))
