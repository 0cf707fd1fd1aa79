"""distributed_join_tpu_torch — the distributed equi-join on PyTorch and
CUDA, ported from the JAX package ``distributed_join_tpu`` beside it.

The pipeline is the JAX package's: Murmur3 hash -> radix hash partition
(stable bucket sort) -> capacity-padded all-to-all shuffle over a
``Communicator`` (one rank, emulated ranks in one process, or one
process a rank over ``torch.distributed``: NCCL between cards, gloo on
the CPU) -> local sort-merge join (inner, and the left, right,
full outer, semi and anti joins of ``join_type``). The local join's Pallas
kernels (fused scans, stream compaction, expand-gather) are hand-written
CUDA kernels for Hopper (``csrc/``), each with a plain PyTorch twin that
CPU tensors take.

Entry points that create tensors run on ``cuda`` unless the caller
passes ``device="cpu"``; without a GPU and without that request they
raise. Nothing here imports JAX or the JAX package.
"""

from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.ops.join import JoinResult, sort_merge_inner_join
from distributed_join_tpu_torch.parallel.communicator import (
    Communicator,
    EmulatedCommunicator,
    LocalCommunicator,
    ProcessGroupCommunicator,
    make_communicator,
)
from distributed_join_tpu_torch.parallel.distributed_join import (
    distributed_inner_join,
    make_join_step,
)

__all__ = [
    "Communicator",
    "EmulatedCommunicator",
    "JoinResult",
    "LocalCommunicator",
    "ProcessGroupCommunicator",
    "Table",
    "distributed_inner_join",
    "make_communicator",
    "make_join_step",
    "resolve_device",
    "sort_merge_inner_join",
]
