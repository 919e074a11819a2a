"""Process bring-up of the sharded layer.

Port of ``adcensus_tpu/parallel/distributed.py``. The compute path never
talks to the network itself: its collectives are ``torch.distributed``
calls on the mesh's process groups (``parallel/sharded.py``). This module
starts the process group and checks its arguments before anything can
hang. It reads no variable of the shell: the caller names the rendezvous
(``tcp://host:port`` or ``file:///path``), the world size and the rank.
"""
from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from adcensus_torch.parallel.mesh import make_mesh


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
) -> None:
    """Start this rank's process group. ``world_size`` and ``rank`` come
    together; without them the process is a world of one. More than one
    process needs ``init_method``; one process without it rendezvous in
    memory. ``backend`` defaults to "nccl" with a CUDA device (the rank
    then takes device ``rank % device_count``) and "gloo" without.
    ``timeout`` bounds the rendezvous and each collective's wait for its
    peers (default: torch's).
    Every argument is checked before any call into torch.distributed,
    so a bad configuration raises ValueError instead of hanging."""
    if (world_size is None) != (rank is None):
        raise ValueError(
            "world_size and rank must be given together "
            f"(got world_size={world_size}, rank={rank})"
        )
    if world_size is not None:
        if world_size <= 0:
            raise ValueError(f"world_size must be > 0, got {world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(
                f"rank {rank} out of range [0, {world_size})"
            )
    else:
        world_size, rank = 1, 0
    if world_size > 1 and not init_method:
        raise ValueError(
            "multi-process initialization needs an init_method naming "
            "the coordinator (tcp://host:port or file:///path)"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if init_method:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=timeout)


def pod_mesh(n_data: Optional[int] = None) -> DeviceMesh:
    """Mesh over every rank: pairs (data) over hosts, row tiles over the
    devices of a host. ``n_data`` defaults to the number of hosts (the
    world size over this host's CUDA devices; one host without CUDA);
    a value that does not divide the world falls back to 1."""
    world = dist.get_world_size()
    cuda = dist.get_backend() == "nccl"
    if n_data is None:
        per_host = torch.cuda.device_count() if cuda else world
        n_data = max(1, world // max(per_host, 1))
    if world % n_data:
        n_data = 1
    return make_mesh(n_data, world // n_data, "cuda" if cuda else "cpu")
