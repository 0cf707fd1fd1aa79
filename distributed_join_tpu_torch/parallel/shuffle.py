"""Two-phase all-to-all table shuffle over capacity-padded blocks.

Port of ``distributed_join_tpu/parallel/shuffle.py`` ``shuffle_padded``
(:46): phase 1 exchanges the (n_ranks,) count vector, phase 2 each
column laid out (n_ranks, capacity); the received block flattens into a
validity-masked Table. The ragged, compressed, segmented and
hierarchical variants are not part of the port.
"""

from __future__ import annotations

import torch

from distributed_join_tpu_torch.ops.partition import unpad
from distributed_join_tpu_torch.parallel.communicator import Communicator
from distributed_join_tpu_torch.table import Table


def shuffle_padded(comm: Communicator, padded_columns, counts: torch.Tensor,
                   capacity: int) -> tuple[Table, torch.Tensor]:
    """Shuffle a pre-padded (n_ranks, capacity) block; returns the
    received rows as a masked Table plus the received counts."""
    recv_counts = comm.all_to_all(counts)
    recv_cols = {n: comm.all_to_all(c) for n, c in padded_columns.items()}
    return unpad(recv_cols, recv_counts, capacity), recv_counts
