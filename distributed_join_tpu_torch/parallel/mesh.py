"""Rank -> device: the port's counterpart of the JAX package's 1-D device
mesh (``distributed_join_tpu/parallel/mesh.py`` ``make_mesh``, :32-45).

The reference binds one process to one GPU (``cudaSetDevice(local_rank)``);
so does the port. A rank of a ``torch.distributed`` process group lives
on ``cuda:<local rank>`` under NCCL and on the CPU under gloo, and the
rank axis is the group itself. Several ranks on one card are not a
process group (NCCL refuses two ranks on one device): they remain the
job of ``EmulatedCommunicator``.

:func:`make_hierarchical_mesh` splits the ranks into ``(slice, chip)``
for the hierarchical shuffle (JAX ``make_hierarchical_mesh``, :46-108),
slice-major: the chip axis is the fast tier, the slice axis the slow one.
"""

from __future__ import annotations

import dataclasses
import os
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


def device_slice_id(rank: int) -> int:
    """The slow-tier group (node) of process ``rank``: ``rank //
    LOCAL_WORLD_SIZE`` where the launcher sets ``LOCAL_WORLD_SIZE`` (the
    processes of one node), else 0 (one node; the counterpart of the JAX
    package's ``process_index`` fallback)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    return rank // local if local > 0 else 0


@dataclasses.dataclass(frozen=True)
class HierarchicalMesh:
    """The 2-D (slice, chip) split of ``n_slices * chips_per_slice``
    ranks, slice-major: rank ``r`` is ``(r // chips_per_slice, r %
    chips_per_slice)``, so a table row-sharded over it shards as over the
    flat rank axis. ``real_topology``: the ranks are a process group's
    and the slices are its nodes (``device_slice_id``), so the chip axis
    stays inside a node and the slice axis crosses nodes; otherwise the
    ranks are nested as they are, as the JAX package's CPU mesh is."""

    n_slices: int
    chips_per_slice: int
    real_topology: bool = False

    def coords(self, rank: int) -> tuple:
        return divmod(rank, self.chips_per_slice)

    def chip_group(self, slice_id: int) -> list:
        """The ranks of one slice (the fast, intra-slice tier)."""
        c = self.chips_per_slice
        return list(range(slice_id * c, (slice_id + 1) * c))

    def slice_group(self, chip: int) -> list:
        """The ranks holding chip ``chip`` of every slice (the slow,
        cross-slice tier)."""
        return [t * self.chips_per_slice + chip
                for t in range(self.n_slices)]


def make_hierarchical_mesh(n_slices: int,
                           n_ranks: Optional[int] = None,
                           process_group: bool = True
                           ) -> HierarchicalMesh:
    """The (slice, chip) mesh over ``n_ranks`` ranks: those of the
    process group (whose size ``n_ranks`` must then equal), or, with no
    process group or ``process_group=False``, ``n_ranks`` ranks of one
    process. A slice count below 1 or not dividing the rank count
    refuses (JAX ``parallel/mesh.py:46-108``)."""
    flat = None
    if process_group and dist.is_initialized():
        flat = make_mesh(n_ranks)
        n = flat.n_ranks
    elif n_ranks is None:
        raise RuntimeError(
            "no process group and no n_ranks: a hierarchical mesh over "
            "the ranks of one process needs n_ranks")
    else:
        n = n_ranks
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if n % n_slices:
        raise ValueError(
            f"n_slices={n_slices} does not divide the rank count {n}; "
            "a hierarchical mesh needs equal-size slices: pick a divisor "
            "(or drop --slices for the flat 1-D mesh)")
    chips = n // n_slices
    real = flat is not None and all(
        device_slice_id(r) == r // chips for r in range(n))
    return HierarchicalMesh(n_slices, chips, real)
