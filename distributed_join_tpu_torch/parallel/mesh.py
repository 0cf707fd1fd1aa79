"""Rank -> device: the port's counterpart of the JAX package's 1-D device
mesh (``distributed_join_tpu/parallel/mesh.py`` ``make_mesh``, :32-45).

The reference binds one process to one GPU (``cudaSetDevice(local_rank)``);
so does the port. A rank of a ``torch.distributed`` process group lives
on ``cuda:<local rank>`` under NCCL and on the CPU under gloo, and the
rank axis is the group itself. Several ranks on one card are not a
process group (NCCL refuses two ranks on one device): they remain the
job of ``EmulatedCommunicator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group as a 1-D rank axis: its backend (``nccl`` or
    ``gloo``), its size, this process's rank and the rank's device."""

    backend: str
    n_ranks: int
    rank: int
    device: torch.device


def local_device(backend: str, process_id: int) -> torch.device:
    """The device of process ``process_id`` on its host: the CPU under
    gloo; under NCCL card ``process_id % cards on the host`` (one
    process a card; a host runs processes 0..cards-1, or one process
    with the ``--process-id`` launcher). Raises without a card."""
    if backend == "gloo":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            f"the {backend} backend needs a CUDA device and none is "
            "visible; run gloo on the CPU (--cpu-devices-per-process 1)")
    return torch.device("cuda", process_id % count)


def make_mesh(n_ranks: Optional[int] = None) -> Mesh:
    """The 1-D mesh over the initialized process group (every rank; a
    group cannot be cut to fewer ranks than it has)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with python -m "
            "distributed_join_tpu_torch.benchmarks.launch, or call "
            "parallel.bootstrap.initialize first")
    world = dist.get_world_size()
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"asked for {n_ranks} ranks; the process group "
                         f"has {world}")
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" else torch.device("cpu"))
    return Mesh(backend, world, dist.get_rank(), device)


def make_hierarchical_mesh(*args, **kwargs):
    """The 2-D (slice, chip) mesh of the hierarchical shuffle is not part
    of the port yet."""
    raise NotImplementedError(
        "make_hierarchical_mesh: the hierarchical (slice, chip) mesh is "
        "not part of the port; use the flat process group")
