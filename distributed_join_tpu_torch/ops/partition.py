"""Radix hash partition: hash -> bucket id -> stable sort of row
indices by bucket -> offsets. The port of
``distributed_join_tpu/ops/partition.py``; the sort carries only the
bucket id and the row order (and, for the byte-exact string wire, a
within-bucket order column), and ``to_padded`` gathers every column
once, straight into its padded layout.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.ops.hashing import bucket_ids
from distributed_join_tpu_torch.table import Table


INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8, torch.uint16, torch.uint32, torch.uint64)


@dataclasses.dataclass(frozen=True)
class PartitionedTable:
    """A bucket-sorted view of ``source``.

    order:   (capacity,) int32 stable bucket-sorted row permutation;
             invalid rows sort after every real bucket.
    offsets: (n_buckets + 1,) int32; bucket b is
             ``order[offsets[b]:offsets[b+1]]``.
    counts:  (n_buckets,) int32 == diff(offsets).
    """

    source: Table
    order: torch.Tensor
    offsets: torch.Tensor
    counts: torch.Tensor

    @property
    def n_buckets(self) -> int:
        return self.counts.shape[0]

    def to_padded(self, capacity: int, bucket_start: int = 0,
                  n_buckets: int | None = None):
        """Dense (n_buckets, capacity) layout for the fixed-shape
        all-to-all, over the bucket range ``[bucket_start, +n_buckets)``.

        Returns (padded columns, counts clipped to capacity, overflow:
        0-d bool, True iff a selected bucket exceeded the capacity,
        row_valid: (n_buckets, capacity) bool)."""
        nb = self.n_buckets if n_buckets is None else n_buckets
        offs = self.offsets[bucket_start:bucket_start + nb]
        counts = self.counts[bucket_start:bucket_start + nb]
        lane = torch.arange(capacity, dtype=torch.int32,
                            device=offs.device)
        pos = offs[:, None] + lane[None, :]
        row_valid = lane[None, :] < counts[:, None]
        idx = self.order[pos.clamp(0, self.source.capacity - 1).long()]
        idx = idx.long()
        padded = {n: c[idx] for n, c in self.source.columns.items()}
        overflow = (counts > capacity).any()
        return padded, counts.clamp(max=capacity), overflow, row_valid


def radix_hash_partition(table: Table, key_cols: Sequence[str],
                         n_buckets: int,
                         order_within: str | None = None,
                         sub_buckets: int = 1) -> PartitionedTable:
    """Partition ``table`` into ``n_buckets`` by the hash of
    ``key_cols``. ``sub_buckets`` > 1 partitions at the fine
    granularity of ``bucket_ids``.

    ``order_within`` names a 1-D integer column: rows within each
    bucket then sort by it descending (cast to int32, as in the JAX
    package), the row index last. The byte-exact string wire
    (``parallel/shuffle.shuffle_ragged``) needs each bucket's rows by
    length descending, so that the rows alive at a u32 word plane form
    a prefix of the bucket. Two stable sorts give the JAX package's
    two-key stable sort: the column first, then the bucket id. The
    hash and the bucket ids run in the ``partition_hash`` phase; the
    sorts and the offsets follow it."""
    if sub_buckets > 1 and order_within is not None:
        raise ValueError(
            "sub_buckets and order_within are mutually exclusive: the "
            "within-bucket order slot is either the segment id or the "
            "varwidth length, never both")
    with telemetry.phase("partition_hash"):
        b = bucket_ids([table.columns[c] for c in key_cols], n_buckets,
                       sub_buckets=sub_buckets)
        n_buckets = n_buckets * max(int(sub_buckets), 1)
        # Padding rows get bucket n_buckets: they sort after every real one.
        b = torch.where(table.valid, b, torch.full_like(b, n_buckets))
    if order_within is None:
        sorted_b, order = torch.sort(b, stable=True)
    else:
        oc = table.columns[order_within]
        if oc.ndim != 1 or oc.dtype not in INT_DTYPES:
            raise TypeError(
                f"order_within column {order_within!r} must be a 1-D "
                f"integer column, got ndim={oc.ndim} dtype={oc.dtype}")
        _, by_col = torch.sort(-oc.to(torch.int32), stable=True)
        sorted_b, within = torch.sort(b[by_col], stable=True)
        order = by_col[within]
    offsets = torch.searchsorted(
        sorted_b,
        torch.arange(n_buckets + 1, dtype=torch.int32, device=b.device),
        side="left",
    ).to(torch.int32)
    return PartitionedTable(table, order.to(torch.int32), offsets,
                            torch.diff(offsets))


def unpad(padded_columns, counts: torch.Tensor, capacity: int) -> Table:
    """Flatten an (n_src, capacity) block received from n_src peers into
    a Table whose mask marks the first counts[s] rows of each stripe."""
    lane = torch.arange(capacity, dtype=torch.int32, device=counts.device)
    valid = (lane[None, :] < counts[:, None]).reshape(-1)
    cols = {n: c.reshape((-1,) + tuple(c.shape[2:]))
            for n, c in padded_columns.items()}
    return Table(cols, valid)
