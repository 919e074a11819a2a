"""Cases of the sharded layer's CPU tests (tests/test_torch_sharded*.py).

``run(world, names, tmp_path)`` starts ``world`` ranks with
``torch.multiprocessing.spawn``, each one process on gloo with a
``file://`` rendezvous under ``tmp_path`` (no TCP port, so xdist workers
cannot clash). Every rank runs the named cases in order and saves what
it got; ``run`` returns each rank's results. This module imports torch
and the port only, so the spawned ranks load no JAX.
"""
from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

SIZE = (30, 44)
ODD = (31, 43)       # neither side a multiple of 2 or 4
OPTS = dict(max_disparity=8, cross_L1=8, cross_L2=4)
FLAGS = dict(OPTS, do_lr_check=False, do_discontinuity_adjustment=True,
             exact_median=True)

# name -> (image size, options, volume_axis, cross_backend, data size,
#          pairs); a batched case has pairs > 1
CASES = {
    "rows": (SIZE, OPTS, "rows", "roll", 1, 1),
    "rows_odd": (ODD, OPTS, "rows", "roll", 1, 1),
    # at 4 ranks H = 30 gives 8 rows a rank, fewer than the 12-row halo
    "rows_multi_hop": (SIZE, dict(OPTS, cross_L1=12), "rows", "roll", 1, 1),
    "rows_negative_min": (ODD, dict(OPTS, min_disparity=-3, max_disparity=5),
                          "rows", "roll", 1, 1),
    "rows_flags": (SIZE, FLAGS, "rows", "roll", 1, 1),
    # padded columns under discontinuity adjustment, which reads them
    "rows_flags_odd": (ODD, FLAGS, "rows", "roll", 1, 1),
    "rows_matmul": (SIZE, OPTS, "rows", "matmul", 1, 1),
    "disp": (SIZE, OPTS, "disp", "roll", 1, 1),
    "disp_odd": (ODD, OPTS, "disp", "roll", 1, 1),
    "disp_flags": (ODD, FLAGS, "disp", "roll", 1, 1),
    "disp_matmul": (ODD, OPTS, "disp", "matmul", 1, 1),
    "batched_rows": (SIZE, OPTS, "rows", "roll", 2, 2),
    "batched_disp": (ODD, OPTS, "disp", "roll", 2, 2),
    # D = 7 is a multiple of neither 2 nor 4 tiles
    "disp_indivisible": (SIZE, dict(OPTS, max_disparity=7), "disp", "roll",
                         1, 1),
}


def pairs(name: str):
    """The case's seeded synthetic pairs: (lefts, rights, grays_l,
    grays_r) numpy stacks with the host64 grays."""
    from adcensus_torch.stages.cost import compute_gray_host64
    from adcensus_torch.synthetic import two_layer_pair

    (h, w), _, _, _, _, n = CASES[name]
    made = [two_layer_pair(h, w, 2, 5, seed=s)[:2] for s in range(n)]
    lefts = np.stack([l for l, _ in made])
    rights = np.stack([r for _, r in made])
    return (lefts, rights,
            np.stack([compute_gray_host64(x) for x in lefts]),
            np.stack([compute_gray_host64(x) for x in rights]))


def options(name: str):
    from adcensus_torch.config import ADCensusOptions

    return ADCensusOptions(**CASES[name][1])


def _rank(rank: int, world: int, tmp: str, names) -> None:
    import torch.distributed as dist

    from adcensus_torch.parallel import distributed, sharded
    from adcensus_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    distributed.initialize("file://" + str(tmp / "store"), world, rank)
    try:
        meshes = {}
        out = {"pod_mesh": tuple(distributed.pod_mesh().shape)}
        try:
            make_mesh(world + 1, 1, "cpu")
        except ValueError as e:
            out["make_mesh_error"] = str(e)
        for name in names:
            _, _, axis, backend, n_data, n_pairs = CASES[name]
            if n_data not in meshes:
                meshes[n_data] = make_mesh(n_data, world // n_data, "cpu")
            stacks = [torch.as_tensor(a) for a in pairs(name)]
            try:
                if n_pairs > 1:
                    res = sharded.match_sharded_batched(
                        *stacks, options(name), meshes[n_data], backend,
                        axis)
                else:
                    res = sharded.match_sharded(
                        *(s[0] for s in stacks), options(name),
                        meshes[n_data], backend, axis)
            except ValueError as e:
                res = str(e)
            out[name] = res
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run(world: int, names, tmp_path, timeout_s: float = 180.0) -> list:
    """Each rank's results of the named cases at ``world`` ranks. Ranks
    still running after ``timeout_s`` (a collective that never matched)
    are killed and the run raises TimeoutError."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_rank, args=(world, str(tmp_path), list(names)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{timeout_s} s")
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
