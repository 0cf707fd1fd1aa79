"""The table shuffle: the padded two-phase all-to-all, its compressed
form, and the exact-size (ragged) exchange with its byte-exact string
wire.

Port of ``distributed_join_tpu/parallel/shuffle.py``:

- :func:`shuffle_padded` (JAX :46): phase 1 exchanges the (n_ranks,)
  count vector, phase 2 each column laid out (n_ranks, capacity), by one
  ``all_to_all`` or (``via='ppermute'``) by the communicator's chain of
  point-to-point steps; the received block flattens into a
  validity-masked Table.
- :func:`shuffle_padded_compressed` (JAX :97): the same with every
  eligible integer column FoR + bit-packed (``ops/compression.py``) a
  destination block at a time; a residual wider than ``bits`` raises the
  codec's overflow flag, and the ladder retries wider.
- :func:`shuffle_ragged` (JAX :524): the reference's exact-size exchange.
  Phase 1 all-gathers each rank's counts, so every rank holds the (n, n)
  count matrix and computes the same plan: sizes, where each block lands
  in its receiver's buffer, and a deterministic clamp when a receiver's
  buffer would overflow. Phase 2 moves exactly the planned rows with
  ``Communicator.ragged_all_to_all``. 2-D uint8 string columns named in
  ``varwidth`` ship byte-exactly, one u32 word plane at a time.

The plan is computed on the host: every rank's bucket counts and
offsets are gathered and read back in one read a partition (all its
batches), and each string column's plane counts in one more, so the
process-group exchange gets host lists and reads nothing itself.
The emulated and local backends' results are those of the JAX
package's emulation.

- :func:`shuffle_segmented` (JAX :203): the fine-partitioned padded
  blocks of the segmented sort, one block a destination.
- :func:`shuffle_hierarchical` (JAX :326): the two-level exchange over a
  ``(slice, chip)`` communicator, intra-slice then cross-slice
  (:func:`_hier_route`), with the codec on the cross-slice tier alone.

Every shuffle takes a ``tape`` (a ``telemetry.metrics.MetricsTape``
view, or None), which receives the JAX package's wire accounting:
``rows_shuffled`` and ``rows_received`` (the actual rows, from the count
vectors, or from the host plans on the ragged wire), ``wire_bytes`` (the
data-plane bytes handed to the exchange, the padded block whole, pad
included; the count exchange is not billed), ``wire_bytes_saved`` where
the codec or the byte-exact string wire saved bytes, and the
hierarchical wire's ``wire_bytes_ici`` and ``wire_bytes_dcn``. The
counts stay on the device; nothing is read to the host for the tape.

Every shuffle also takes a ``digest_tape`` (a tape view, or None): the
wire-integrity digests of ``parallel/integrity.py`` (JAX :48-682). The
sender digests, per destination, the rows it routes there, from its
true local counts; the receiver digests, per source, the rows it
believes it received, under its own received counts or plan; the pairs
land on the tape as ``sent_to_j`` and ``recv_from_j``, and
``integrity.verify_digests`` checks them on the host after the step.
The padded, ppermute and compressed wires digest the padded blocks (the
compressed wire's sender before the codec, its receiver after it), the
segmented wire its fine blocks under their validity masks, the
hierarchical wire end to end over both hops, and the ragged wire its
bucket-sorted rows by the sender's device offsets and counts against the
receiver's planned windows, string planes included. With
``digest_tape`` None a shuffle runs exactly what it ran without it.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from distributed_join_tpu_torch.ops.compression import (
    decode_rows,
    encode_rows,
)
from distributed_join_tpu_torch.ops.partition import PartitionedTable, unpad
from distributed_join_tpu_torch.parallel import faults, integrity
from distributed_join_tpu_torch.parallel.communicator import Communicator
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils.strings import LEN_SUFFIX, _WORD_PREFIX

VIAS = ("all_to_all", "ppermute")
CODEC_DTYPES = (torch.int32, torch.int64, torch.uint32, torch.uint64)


def _mover(comm: Communicator, via: str):
    if via not in VIAS:
        raise ValueError(f"via={via!r}: expected one of {VIAS}")
    return comm.ppermute_all_to_all if via == "ppermute" else comm.all_to_all


def _bill_rows(tape, counts: torch.Tensor, recv_counts: torch.Tensor) -> None:
    """The actual rows a shuffle sent and received, as device scalars;
    nothing without a tape."""
    if tape is not None:
        tape.add("rows_shuffled", counts.sum(dtype=torch.int64))
        tape.add("rows_received", recv_counts.sum(dtype=torch.int64))


def _pad_digests(digest_tape, sent_cols, counts, recv_cols,
                 recv_counts) -> None:
    """The padded wires' digest pairs: the sender's blocks under its
    counts, the receiver's under the counts it received."""
    if digest_tape is not None:
        integrity.record_pair_digests(
            digest_tape, integrity.padded_block_digests(sent_cols, counts),
            integrity.padded_block_digests(recv_cols, recv_counts))


def shuffle_padded(comm: Communicator, padded_columns, counts: torch.Tensor,
                   capacity: int, via: str = "all_to_all", tape=None,
                   digest_tape=None) -> tuple[Table, torch.Tensor]:
    """Shuffle a pre-padded (n_ranks, capacity) block; returns the
    received rows as a masked Table plus the received counts.
    ``via='ppermute'`` moves the data blocks by the communicator's
    point-to-point chain: the same bytes and result."""
    a2a = _mover(comm, via)
    recv_counts = comm.all_to_all(counts)
    recv_cols = {n: a2a(c) for n, c in padded_columns.items()}
    _pad_digests(digest_tape, padded_columns, counts, recv_cols, recv_counts)
    nbytes = sum(c.nbytes for c in padded_columns.values())
    comm.count_wire(counts.shape[0] * capacity, nbytes)
    if tape is not None:
        _bill_rows(tape, counts, recv_counts)
        tape.add("wire_bytes", nbytes)
    return unpad(recv_cols, recv_counts, capacity), recv_counts


def _codec_eligible(name: str, col: torch.Tensor) -> bool:
    """The compressed wire's columns (JAX :448): (n_ranks, capacity)
    integer blocks of 4- or 8-byte lanes, except the packed string-key
    word columns, whose byte packs span more than any packable width and
    ride raw."""
    return (col.ndim == 2 and col.dtype in CODEC_DTYPES
            and not name.startswith(_WORD_PREFIX))


def shuffle_padded_compressed(comm: Communicator, padded_columns,
                              counts: torch.Tensor, capacity: int,
                              bits: int, block: int = 256,
                              via: str = "all_to_all", tape=None,
                              digest_tape=None):
    """The padded shuffle with the FoR + bit-pack codec on the wire:
    each eligible column's destination block is encoded as one row
    (its own frames, so no codec block straddles two destinations), the
    int32 word and int64 frame planes ride the exchange, and the
    receiver decodes. Other columns ride raw. The eligible columns of
    one dtype are encoded, moved and decoded together, as (n_ranks,
    columns) rows: the same rows, so the same words, as one by one.

    Padding slots would mix a neighbouring bucket's rows into a block's
    span, so they are filled with the bucket's last valid row first
    (residual 0 against a real frame). Returns ``(received table,
    received counts, compression overflow)``: the flag fires when a
    block's residuals need more than ``bits``; rows are then wrong, and
    the caller retries wider. The digests: the sender's on the block
    before the codec, the receiver's on the decoded one (a lossy encode
    would disagree too, but it raises the flag, and an overflowed result
    is not verified)."""
    a2a = _mover(comm, via)
    recv_counts = comm.all_to_all(counts)
    n = counts.shape[0]
    c_ovf = torch.zeros((), dtype=torch.bool, device=counts.device)
    recv_cols = {}
    groups: dict = {}
    sent = 0
    for name, col in padded_columns.items():
        if _codec_eligible(name, col):
            groups.setdefault(col.dtype, []).append(name)
        else:
            recv_cols[name] = a2a(col)
            sent += col.nbytes
    for dtype, names in groups.items():
        cols = _pad_fill(torch.stack([padded_columns[m] for m in names],
                                     dim=2), counts)
        g = len(names)
        rows = cols.transpose(1, 2).reshape(n * g, capacity)
        words, frames, ovf, _ = encode_rows(rows, bits, block,
                                            required_bits=False)
        c_ovf = c_ovf | ovf.any()
        sent += words.nbytes + frames.nbytes
        rw = a2a(words.reshape(n, -1)).reshape(n * g, -1)
        rf = a2a(frames.reshape(n, -1)).reshape(n * g, -1)
        got = decode_rows(rw, rf, capacity, bits, block, dtype)
        for name, col in zip(names, got.reshape(n, g, capacity).unbind(1)):
            recv_cols[name] = col
    comm.count_wire(n * capacity, sent)
    _pad_digests(digest_tape, padded_columns, counts, recv_cols, recv_counts)
    if tape is not None:
        _bill_rows(tape, counts, recv_counts)
        tape.add("wire_bytes", sent)
        tape.add("wire_bytes_saved",
                 sum(c.nbytes for c in padded_columns.values()) - sent)
    recv_cols = {name: recv_cols[name] for name in padded_columns}
    return unpad(recv_cols, recv_counts, capacity), recv_counts, c_ovf


def _pad_fill(cols: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(n, capacity, ...) blocks with every padding slot filled with its
    block's last valid row (residual 0 against a real frame)."""
    n, capacity = cols.shape[:2]
    lane = torch.arange(capacity, dtype=torch.int32, device=counts.device)
    row_valid = (lane[None, :] < counts[:, None]).reshape(
        (n, capacity) + (1,) * (cols.ndim - 2))
    last = (counts.to(torch.int64) - 1).clamp(min=0)
    fill = cols[torch.arange(n, device=counts.device), last]
    return torch.where(row_valid, cols, fill[:, None])


# -- the segmented and hierarchical shuffles -----------------------------


def shuffle_segmented(comm: Communicator, padded_fine, fine_counts:
                      torch.Tensor, seg_cap: int, segments: int,
                      via: str = "all_to_all", tape=None, digest_tape=None):
    """The padded shuffle of a fine-partitioned block for the segmented
    sort (JAX :203-290): ``padded_fine`` holds ``(n_ranks * segments,
    seg_cap, ...)`` blocks, destination-major and segment-minor (the
    layout of ``radix_hash_partition(sub_buckets=)``), ``fine_counts``
    the ``(n_ranks * segments,)`` counts. Each destination's ``segments
    * seg_cap`` slots ride as one block (``via``: ``all_to_all``,
    ``ppermute`` or ``hierarchical``, whose route moves both tiers raw),
    the fine counts as metadata over ``all_to_all`` (the hierarchical
    route on a multi-slice communicator).

    Returns ``(recv_cols, recv_counts)``: columns ``(n_src, segments,
    seg_cap, ...)`` and counts ``(n_src, segments)``. The wire counters
    bill the full block, on both tiers of a multi-slice hierarchical
    route. The digests are the flat wires' pairs, each block taken under
    its fine counts' mask (``integrity.masked_block_digests``)."""
    n, s = comm.n_ranks, segments
    hier = via == "hierarchical" and comm.n_slices > 1
    if hier:
        route = route_meta = functools.partial(_hier_route, comm)
    else:
        # one slice: the hierarchical route is the flat padded one
        route = _mover(comm, "all_to_all" if via == "hierarchical" else via)
        route_meta = comm.all_to_all
    recv_counts = route_meta(fine_counts.reshape(n, s))
    recv_cols = {}
    block_bytes = 0
    for name, col in padded_fine.items():
        block = col.reshape((n, s * seg_cap) + tuple(col.shape[2:]))
        block_bytes += block.nbytes
        recv_cols[name] = route(block).reshape(
            (n, s, seg_cap) + tuple(col.shape[2:]))
    comm.count_wire(n * s * seg_cap, 2 * block_bytes if hier else block_bytes)
    if digest_tape is not None:
        lane = torch.arange(seg_cap, dtype=torch.int32,
                            device=fine_counts.device)
        sent_mask = (lane[None, :] < fine_counts[:, None]).reshape(
            n, s * seg_cap)
        recv_mask = (lane[None, None, :] < recv_counts[:, :, None]).reshape(
            n, s * seg_cap)
        integrity.record_pair_digests(
            digest_tape,
            integrity.masked_block_digests(
                {nm: c.reshape((n, s * seg_cap) + tuple(c.shape[2:]))
                 for nm, c in padded_fine.items()}, sent_mask),
            integrity.masked_block_digests(
                {nm: c.reshape((n, s * seg_cap) + tuple(c.shape[3:]))
                 for nm, c in recv_cols.items()}, recv_mask))
    if hier:
        comm.count_tiers(block_bytes, block_bytes)
    if tape is not None:
        _bill_rows(tape, fine_counts, recv_counts)
        tape.add("wire_bytes", 2 * block_bytes if hier else block_bytes)
        if hier:
            tape.add("wire_bytes_ici", block_bytes)
            tape.add("wire_bytes_dcn", block_bytes)
    return recv_cols, recv_counts


def _hier_route(comm: Communicator, x: torch.Tensor) -> torch.Tensor:
    """Two-level routing of an ``(n_ranks, ...)`` destination-major block
    (JAX :293-311): the intra-slice exchange, then the cross-slice one.
    Returns the ``(n_ranks, ...)`` block received, in sender-rank order,
    as one global ``all_to_all`` of it would. Phase 1 regroups the
    ``s * c`` destination blocks by destination chip, so after it chip j
    holds everything its slice sends to chip j of any slice, as
    ``(dest slice, src chip)``; phase 2 exchanges over the slice axis,
    and ``(src slice, src chip)`` is sender-rank order."""
    z = comm.all_to_all_slice(_hier_phase1(comm, x).contiguous())
    return z.reshape(x.shape)


def _hier_phase1(comm: Communicator, x: torch.Tensor) -> torch.Tensor:
    """The intra-slice hop of :func:`_hier_route` alone: the ``(dest
    slice, src chip, ...)`` block the cross-slice hop exchanges (split
    out so that the DCN codec encodes exactly that payload)."""
    s, c = comm.n_slices, comm.chips_per_slice
    tail = tuple(x.shape[1:])
    y = x.reshape((s, c) + tail).transpose(0, 1).contiguous()
    return comm.all_to_all_chip(y).transpose(0, 1)


def shuffle_hierarchical(comm: Communicator, padded_columns,
                         counts: torch.Tensor, capacity: int,
                         dcn_bits: int | None = None, block: int = 256,
                         tape=None, digest_tape=None):
    """The two-level shuffle of a pre-padded ``(n_ranks, capacity)``
    block over a ``(slice, chip)`` communicator (JAX :326-443): every
    block rides the intra-slice exchange raw, then the cross-slice one,
    with the FoR + bit-pack codec on that tier alone when ``dcn_bits``
    is set. A codec column's padding slots are filled with the bucket's
    last valid row before routing, and each destination slice's payload
    is one frame stream (rows flattened chip-major), so no codec block
    straddles two destinations.

    Returns ``(received table, received counts, codec overflow)``; the
    table is :func:`shuffle_padded`'s for the same input, and the flag
    fires when a cross-slice residual needs more than ``dcn_bits``. The
    counters take both tiers: the full block on the intra-slice one,
    the codec's planes (or the full block) on the cross-slice one, and
    what the codec saved. The digests run end to end over both hops (the
    sender's block before the routing, the receiver's assembled one), so
    a corruption on either tier disagrees."""
    s, c = comm.n_slices, comm.chips_per_slice
    n = s * c
    if counts.shape[0] != n:
        raise ValueError(f"hierarchical shuffle needs {n} destination "
                         f"buckets, got {counts.shape[0]}")
    recv_counts = _hier_route(comm, counts)
    c_ovf = torch.zeros((), dtype=torch.bool, device=counts.device)
    recv_cols = {}
    groups: dict = {}
    ici = dcn_raw = dcn_sent = 0
    for name, col in padded_columns.items():
        ici += col.nbytes
        dcn_raw += col.nbytes
        if dcn_bits is not None and _codec_eligible(name, col):
            groups.setdefault(col.dtype, []).append(name)
        else:
            dcn_sent += col.nbytes
            recv_cols[name] = _hier_route(comm, col)
    for dtype, names in groups.items():
        g = len(names)
        cols = _pad_fill(torch.stack([padded_columns[m] for m in names],
                                     dim=2), counts)
        staged = _hier_phase1(comm, cols)          # (s, c, capacity, g)
        rows = staged.permute(0, 3, 1, 2).reshape(s * g, c * capacity)
        words, frames, ovf, _ = encode_rows(rows, dcn_bits, block,
                                            required_bits=False)
        c_ovf = c_ovf | ovf.any()
        dcn_sent += words.nbytes + frames.nbytes
        rw = comm.all_to_all_slice(words.reshape(s, -1)).reshape(s * g, -1)
        rf = comm.all_to_all_slice(frames.reshape(s, -1)).reshape(s * g, -1)
        got = decode_rows(rw, rf, c * capacity, dcn_bits, block, dtype)
        got = got.reshape(s, g, c, capacity).permute(0, 2, 3, 1).reshape(
            n, capacity, g)
        for name, col in zip(names, got.unbind(2)):
            recv_cols[name] = col
    comm.count_wire(n * capacity, ici + dcn_sent)
    comm.count_tiers(ici, dcn_sent,
                     dcn_raw - dcn_sent if dcn_bits is not None else 0)
    _pad_digests(digest_tape, padded_columns, counts, recv_cols, recv_counts)
    if tape is not None:
        _bill_rows(tape, counts, recv_counts)
        tape.add("wire_bytes", ici + dcn_sent)
        tape.add("wire_bytes_ici", ici)
        tape.add("wire_bytes_dcn", dcn_sent)
        if dcn_bits is not None:
            tape.add("wire_bytes_saved", dcn_raw - dcn_sent)
    recv_cols = {name: recv_cols[name] for name in padded_columns}
    return unpad(recv_cols, recv_counts, capacity), recv_counts, c_ovf


# -- the ragged (exact-size) exchange ------------------------------------


@dataclasses.dataclass(frozen=True)
class RaggedPlan:
    """One (table, batch) transfer plan, on the host (JAX
    ``_ragged_plan_matrices`` :480). ``counts[j][i]``: rows rank j sends
    rank i; ``start[j][i]``: where rank j's block starts in rank i's
    buffer (the exclusive prefix down column i); ``allowed[j][i]``: the
    rows of it that fit ``out_capacity``. ``row_clamped``: a row bound
    for this rank was dropped; ``overflow`` also fires when a bucket
    exceeds ``capacity_per_bucket`` (the padded wire's contract), which
    drops nothing. ``in_offsets``: this rank's buckets in its
    bucket-sorted rows."""

    me: int
    counts: list
    start: list
    allowed: list
    in_offsets: list
    row_clamped: bool
    overflow: bool

    @property
    def send_sizes(self) -> list:
        return list(self.allowed[self.me])

    @property
    def recv_sizes(self) -> list:
        return [a[self.me] for a in self.allowed]

    @property
    def output_offsets(self) -> list:
        return list(self.start[self.me])

    @property
    def recv_offsets(self) -> list:
        return [s[self.me] for s in self.start]

    @property
    def total_recv(self) -> int:
        return sum(self.recv_sizes)


def _plan(me: int, m: list, in_offsets: list, out_capacity: int,
          capacity_per_bucket: int | None = None) -> RaggedPlan:
    """The plan from the (n, n) count matrix on the host: plain
    arithmetic, the same on every rank."""
    n = len(m)
    start = [[0] * n for _ in range(n)]
    allowed = [[0] * n for _ in range(n)]
    for i in range(n):
        at = 0
        for j in range(n):
            start[j][i] = at
            allowed[j][i] = min(max(out_capacity - at, 0), m[j][i])
            at += m[j][i]
    row_clamped = any(allowed[j][me] < m[j][me] for j in range(n))
    overflow = row_clamped or (capacity_per_bucket is not None and any(
        c > capacity_per_bucket for row in m for c in row))
    return RaggedPlan(me, m, start, allowed, list(in_offsets), row_clamped,
                      overflow)


def _host_cache(pt: PartitionedTable) -> dict:
    """What the ragged shuffles of one partition read to the host, kept
    on ``pt`` (as :func:`varwidth_sort_plan`'s cache is): every batch of
    the partition plans from the same reads."""
    cache = getattr(pt, "_ragged_host_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(pt, "_ragged_host_cache", cache)
    return cache


def _sorted_lens(pt: PartitionedTable, names: tuple, i: int):
    """The i-th varwidth column's bucket-sorted row order and lengths in
    that order: the partition's own for the first (its ``order_within``),
    :func:`varwidth_sort_plan`'s for the others."""
    if i:
        return varwidth_sort_plan(pt, names)[names[i]]
    cache = _host_cache(pt)
    if ("lens", names[0]) not in cache:
        cache[("lens", names[0])] = pt.source.columns[
            names[0] + LEN_SUFFIX][pt.order.to(torch.int64)]
    return pt.order, cache[("lens", names[0])]


def _plane_counts(pt: PartitionedTable, lens: torch.Tensor,
                  planes: int) -> torch.Tensor:
    """(n_buckets, W): the rows of each bucket alive at u32 plane w
    (``len > 4w``), ``lens`` in the column's bucket-sorted order. Each
    plane counts by a 1-D cumulative sum (a cumsum down the rows of a 2-D
    tensor runs one thread a column on CUDA)."""
    dev = lens.device
    nb = pt.n_buckets
    starts = pt.offsets[:nb].to(torch.int64)
    ends = pt.offsets[1:nb + 1].to(torch.int64)
    ln = lens.to(torch.int32)
    k = []
    for w in range(planes):
        cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum((ln > 4 * w).to(torch.int64), 0)])
        k.append(cs[ends] - cs[starts])
    return torch.stack(k, dim=1)


def prefetch_ragged_plans(comm: Communicator, parts) -> None:
    """Read to the host, in one read, what the ragged shuffles of the
    partitions ``parts`` (``(pt, varwidth names)`` pairs) plan from:
    every rank's counts and start offsets of all of a partition's
    buckets, ``(n, 2 * n_buckets)``, and each string column's plane
    counts ``k[j][b][w]`` (:func:`_plane_counts`), ``(n, n_buckets, W)``.
    Each is all-gathered and kept on its ``pt`` (:func:`_host_cache`), so
    every batch of a join plans from the same read; what a ``pt`` holds
    already is not read again. The join step calls this once both sides
    are partitioned; :func:`shuffle_ragged` calls it for its own
    partition."""
    wanted = []
    for pt, names in parts:
        cache = _host_cache(pt)
        nb = pt.n_buckets
        if "buckets" not in cache:
            wanted.append((cache, "buckets", torch.cat(
                [pt.counts, pt.offsets[:nb]]).to(torch.int64)[None]))
        for i, name in enumerate(names):
            if ("planes", name) not in cache:
                _, lens = _sorted_lens(pt, tuple(names), i)
                planes = pt.source.columns[name].shape[1] // 4
                wanted.append((cache, ("planes", name),
                               _plane_counts(pt, lens, planes)[None]))
    if wanted:
        # the count rows through the count seam, the plane counts plain
        got = comm.host_ints(*(
            (comm.all_gather_counts if key == "buckets" else comm.all_gather)
            (t) for _, key, t in wanted))
        for (cache, key, _), value in zip(wanted, got):
            cache[key] = value


def _vec(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


def ragged_plan(comm: Communicator, counts: torch.Tensor, out_capacity: int,
                capacity_per_bucket: int | None = None):
    """Phase 1 of the exact-size shuffle (JAX :465): ``(send_sizes,
    recv_sizes, output_offsets, total_recv, overflow)``, entry i of
    ``output_offsets`` being where this rank's block starts in rank i's
    buffer. Sizes are clamped so that no write passes
    ``out_capacity``; a clamp raises the flag on the receiver it
    affects, and so, with ``capacity_per_bucket``, does any bucket above
    it."""
    (m,) = comm.host_ints(
        comm.all_gather_counts(counts.to(torch.int64)[None]))
    plan = _plan(comm.axis_index(), m, [0] * comm.n_ranks, out_capacity,
                 capacity_per_bucket)
    dev = counts.device
    return (_vec(plan.send_sizes, dev), _vec(plan.recv_sizes, dev),
            _vec(plan.output_offsets, dev),
            torch.full((), plan.total_recv, dtype=torch.int32, device=dev),
            torch.full((), plan.overflow, dtype=torch.bool, device=dev))


def _exchange(comm: Communicator, operand: torch.Tensor, out_capacity: int,
              in_offsets, send_sizes, plan: RaggedPlan,
              recv_sizes) -> torch.Tensor:
    out = operand.new_zeros((out_capacity,) + tuple(operand.shape[1:]))
    return comm.ragged_all_to_all(operand, out, in_offsets, send_sizes,
                                  plan.output_offsets, recv_sizes,
                                  recv_offsets=plan.recv_offsets)


def shuffle_ragged(comm: Communicator, pt: PartitionedTable,
                   out_capacity: int, bucket_start: int = 0,
                   capacity_per_bucket: int | None = None,
                   varwidth=None, tape=None,
                   digest_tape=None) -> tuple[Table, torch.Tensor]:
    """Exact-size shuffle of the ``n_ranks`` buckets from
    ``bucket_start``: the wire carries the rows, not padded blocks.

    Returns (received table, overflow flag). The received rows fill a
    prefix of the ``out_capacity``-row buffer in sender-rank order; the
    valid mask marks that prefix. Rows a clamp dropped raise the flag.

    ``varwidth`` names 2-D uint8 string columns (a name or a sequence)
    to ship byte-exactly: each of a column's width/4 u32 word planes
    ships as its own ragged slice of the rows still alive at that plane
    (``len > 4w``), so the column costs ``sum(ceil(len / 4) * 4)`` bytes
    instead of ``rows * width``. The planes form prefixes of a bucket
    only when its rows are ordered by length descending:
    - the first name's order is the caller's (``radix_hash_partition``'s
      ``order_within``), and its planes land row-aligned;
    - every further column is length-sorted within its bucket on the
      sender (:func:`varwidth_sort_plan`) and un-sorted on the receiver
      from the received ``#len`` companion, the same stable sort on both
      sides. Under an actual clamp the row exchange and a re-sorted
      column drop different rows, so such a column arrives all zero on
      the clamping receiver; a ``capacity_per_bucket`` trip clamps
      nothing and leaves it intact.

    With plan validation on (``faults.plan_validation_enabled``) the
    plan is checked across ranks first, and a violation trips the flag.
    The tape's counters come from the host plan: the rows planned, and
    the bytes of those rows at their fixed widths plus each string
    column's live planes.

    ``digest_tape``: the sender digests its batch's bucket-sorted rows
    (every column, strings in bucket order) by its TRUE device offsets
    and counts, committed before any count exchange could lie; the
    receiver digests its buffer by the windows it planned
    (``plan.recv_offsets``, ``plan.recv_sizes``), so a lie in the
    gathered count matrix, which plan validation cannot see, still
    disagrees. An actual clamp misaligns the extra string columns by
    design, but it raises the flag, and an overflowed result is not
    verified.
    """
    n, me = comm.n_ranks, comm.axis_index()
    nb = pt.n_buckets
    dev = pt.order.device
    vw = (varwidth,) if isinstance(varwidth, str) else tuple(varwidth or ())
    for name in vw:
        if pt.source.columns[name].shape[1] % 4:
            raise ValueError(
                f"varwidth column {name!r} width "
                f"{pt.source.columns[name].shape[1]} must be 4-aligned")
    prefetch_ragged_plans(comm, [(pt, vw)])
    g = _host_cache(pt)["buckets"]
    batch = slice(bucket_start, bucket_start + n)
    plan = _plan(me, [row[batch] for row in g],
                 g[me][nb + bucket_start:nb + bucket_start + n],
                 out_capacity, capacity_per_bucket)
    overflow = torch.full((), plan.overflow, dtype=torch.bool, device=dev)
    if faults.plan_validation_enabled():
        tok = faults.validate_ragged_plan(
            comm, _vec(plan.send_sizes, dev), _vec(plan.recv_sizes, dev),
            _vec(plan.output_offsets, dev), out_capacity)
        overflow = overflow | (tok > 0)
    # Only this batch's rows of the bucket-sorted layout are gathered:
    # [lo, hi) of ``order``, with the input offsets rebased onto it.
    my_counts = plan.counts[plan.me]
    lo = plan.in_offsets[0]
    hi = plan.in_offsets[-1] + my_counts[-1]
    rel = [o - lo for o in plan.in_offsets]
    rows = pt.order[lo:hi].to(torch.int64)
    out_cols = {}
    sent = sum(plan.send_sizes)
    comm.count_wire(sent, 0)
    if tape is not None:
        tape.add("rows_shuffled", sent)
        tape.add("rows_received", plan.total_recv)
    sent_cols = {}
    for name, col in pt.source.columns.items():
        if name not in vw:
            sent_cols[name] = col[rows]
            out_cols[name] = _exchange(comm, sent_cols[name], out_capacity,
                                       rel, plan.send_sizes, plan,
                                       plan.recv_sizes)
            nbytes = sent * col.element_size() * math.prod(col.shape[1:])
            comm.count_wire(0, nbytes)
            if tape is not None:
                tape.add("wire_bytes", nbytes)
    for i, name in enumerate(vw):
        order, _ = _sorted_lens(pt, vw, i)
        k = _host_cache(pt)[("planes", name)]
        raw = _varwidth_exchange(
            comm, pt.source.columns[name][order[lo:hi].to(torch.int64)],
            [row[batch] for row in k], rel, plan, out_capacity, tape=tape)
        if i == 0:
            out_cols[name] = raw
            continue
        if plan.row_clamped:
            out_cols[name] = torch.zeros_like(raw)
        else:
            out_cols[name] = _receiver_unsort(
                raw, out_cols[name + LEN_SUFFIX], plan.recv_offsets,
                plan.total_recv)
    if digest_tape is not None:
        for name in vw:
            sent_cols[name] = pt.source.columns[name][rows]
        batch_offsets = pt.offsets[batch]
        integrity.record_pair_digests(
            digest_tape,
            integrity.segment_digests(integrity.row_digests(sent_cols),
                                      batch_offsets - batch_offsets[0],
                                      pt.counts[batch]),
            integrity.segment_digests(integrity.row_digests(out_cols),
                                      plan.recv_offsets, plan.recv_sizes))
    valid = torch.arange(out_capacity, device=dev) < plan.total_recv
    return (Table({name: out_cols[name] for name in pt.source.columns},
                  valid), overflow)


def varwidth_sort_plan(pt: PartitionedTable, names) -> dict:
    """For every varwidth column after the first: ``{name: (order2,
    lens2)}``, the bucket-sorted row order with each bucket's rows by
    that column's length descending, and the lengths in that order.
    It covers all buckets at once, so it is computed once a partition
    and cached on ``pt``. Only the int32 order and the lengths are
    cached (the JAX package's eager rule): the wide column is gathered
    by each call, so the cache never pins a sorted copy of it. ``pt``
    must not outlive the tables its order refers to;
    ``radix_hash_partition`` makes a new one a step."""
    names = tuple(names or ())[1:]
    if not names:
        return {}
    cache = getattr(pt, "_varwidth_sort_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(pt, "_varwidth_sort_cache", cache)
    for name in names:
        if name not in cache:
            lens_sorted = pt.source.columns[name + LEN_SUFFIX][
                pt.order.to(torch.int64)]
            perm = _within_bucket_len_order(pt.offsets, lens_sorted)
            cache[name] = (pt.order[perm], lens_sorted[perm])
    return {name: cache[name] for name in names}


def _stable_two_key_order(major: torch.Tensor,
                          minor: torch.Tensor) -> torch.Tensor:
    """The permutation of a stable sort on (major, minor): two stable
    sorts, the less significant key first."""
    _, by_minor = torch.sort(minor, stable=True)
    _, by_major = torch.sort(major[by_minor], stable=True)
    return by_minor[by_major]


def _within_bucket_len_order(all_offsets: torch.Tensor,
                             lens: torch.Tensor) -> torch.Tensor:
    """The permutation putting each bucket's rows in length-descending
    order, buckets in place: a stable sort on (bucket, -len)."""
    idx = torch.arange(lens.shape[0], dtype=torch.int32, device=lens.device)
    bid = torch.searchsorted(all_offsets.to(torch.int32), idx,
                             right=True) - 1
    return _stable_two_key_order(bid, -lens.to(torch.int32))


def _receiver_unsort(raw: torch.Tensor, recv_lens: torch.Tensor,
                     recv_offsets, total_recv: int) -> torch.Tensor:
    """Undo the sender's within-bucket length sort: the receiver holds
    the same lengths (the ``#len`` companion rode the row exchange, in
    bucket order, per sender block), so the same stable (block, len
    desc) sort rebuilds the sender's permutation with no extra bytes.
    Row i of ``raw`` belongs at row ``perm[i]``."""
    dev = raw.device
    idx = torch.arange(raw.shape[0], dtype=torch.int32, device=dev)
    rb = torch.searchsorted(_vec(recv_offsets, dev), idx, right=True) - 1
    # Rows past the received prefix take length -1: they sort after
    # their block's real rows and take raw's zero tail.
    key_len = torch.where(idx < total_recv, recv_lens.to(torch.int32),
                          torch.full_like(idx, -1))
    perm = _stable_two_key_order(rb, -key_len)
    out = torch.zeros_like(raw)
    out[perm] = raw
    return out


def _varwidth_exchange(comm: Communicator, col: torch.Tensor, k: list,
                       in_offsets, plan: RaggedPlan,
                       out_capacity: int, tape=None) -> torch.Tensor:
    """Byte-exact exchange of one batch's bucket-sorted (rows, L) uint8
    column whose buckets are ordered by length descending. Plane ``w``
    of the u32 view is alive for the first ``k[j][i][w]`` rows of rank
    j's bucket for rank i (:func:`_plane_counts`). A clamp drops each
    bucket's tail, its shortest rows, so ``min(k, allowed)`` keeps every
    plane consistent with the row exchange. The tape takes the exact
    plane bytes and what they save against the same rows at full
    width."""
    n, me = comm.n_ranks, plan.me
    rows, width = col.shape
    planes = width // 4
    w32 = col.contiguous().view(torch.int32)            # (rows, W)
    kw = [[[min(k[j][i][w], plan.allowed[j][i]) for w in range(planes)]
           for i in range(n)] for j in range(n)]
    exact = 4 * sum(map(sum, kw[me]))
    comm.count_wire(0, exact)
    if tape is not None:
        tape.add("wire_bytes", exact)
        tape.add("varwidth_bytes", exact)
        tape.add("wire_bytes_saved", sum(plan.allowed[me]) * width - exact)
    out = [_exchange(comm, w32[:, w], out_capacity, in_offsets,
                     [kw[me][i][w] for i in range(n)], plan,
                     [kw[j][me][w] for j in range(n)])
           for w in range(planes)]
    return torch.stack(out, dim=1).view(torch.uint8).reshape(
        out_capacity, width)


def shuffle_partitioned(comm: Communicator, pt: PartitionedTable,
                        capacity: int, tape=None, digest_tape=None
                        ) -> tuple[Table, torch.Tensor]:
    """Shuffle a table partitioned into exactly n_ranks buckets (JAX
    :843); returns (received table, overflow flag). ``tape`` and
    ``digest_tape`` are :func:`shuffle_padded`'s."""
    if pt.n_buckets != comm.n_ranks:
        raise ValueError(f"partitioned into {pt.n_buckets} buckets but "
                         f"{comm.n_ranks} ranks")
    padded, counts, overflow, _ = pt.to_padded(capacity)
    table, _ = shuffle_padded(comm, padded, counts, capacity, tape=tape,
                              digest_tape=digest_tape)
    return table, overflow
