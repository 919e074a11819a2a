"""Device mesh of the sharded AD-Census pipeline.

Port of ``adcensus_tpu/parallel/mesh.py``. Mesh dims:

* ``data``: the batch of stereo pairs (no communication within a pair);
* ``tile``: image rows within a pair (halo exchanges, gathers and the
  volume's reshards run over this dim's process group).

Each rank is one process with one device, so the mesh is laid over the
ranks of the default process group (``distributed.initialize``).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(
    n_data: int = 1,
    n_tile: int | None = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A (data, tile) mesh over every rank of the process group, which
    must be initialized. ``n_tile`` defaults to the world size over
    ``n_data``; a mesh that does not cover the world exactly raises
    ValueError."""
    world = dist.get_world_size()
    if n_tile is None:
        n_tile = world // n_data
    if n_data < 1 or n_tile < 1 or n_data * n_tile != world:
        raise ValueError(
            f"mesh {n_data}x{n_tile} does not match the world of {world} "
            "ranks"
        )
    return init_device_mesh(
        device_type, (n_data, n_tile), mesh_dim_names=("data", "tile")
    )
