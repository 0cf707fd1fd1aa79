"""Wire integrity: per-(source, destination) digests of the shuffles,
computed in the step and checked on the host.

Port of ``distributed_join_tpu/parallel/integrity.py`` (JAX :74-342).
The transport is trusted nowhere else: a delivered shuffle is assumed
right. This module lets a completed join prove it:

- every sender digests the rows it routes to each destination, from its
  TRUE local counts (:func:`padded_block_digests` over the padded
  layout, :func:`masked_block_digests` over the segmented sort's fine
  blocks, :func:`segment_digests` over the ragged wire's bucket-sorted
  rows);
- every receiver digests the rows it believes it received from each
  source, with its own (possibly corrupted) counts or plan, so a
  truncated, duplicated, bit-flipped or misrouted delivery disagrees
  with what its sender committed to;
- the ``2 n`` digests a side ride the metrics tape
  (``telemetry/metrics.py``) under ``<side>.integrity.sent_to_j`` and
  ``recv_from_j``, and so its one step-end ``all_gather``: no other
  collective, no host read inside the step;
- :func:`verify_digests` checks on the host that rank s's ``sent_to_d``
  equals rank d's ``recv_from_s`` for every pair, into an
  :class:`IntegrityReport`; ``distributed_inner_join(verify_integrity=
  True)`` raises :class:`IntegrityError` rather than return corrupt rows.

A digest is the Murmur3-finalizer hash of each row over every column
(``ops/hashing.py``, the primitives that route the rows), combined in
sorted-name order and finalized once more, then SUMMED over the rows of
each (source, destination) bucket: a sum does not see row order, which
receivers change, while a changed, missing, duplicated or foreign row
moves it. The sum wraps mod 2^64 and is masked to 63 bits, so it travels
exactly in the tape's int64 lanes, and sums over batches wrap the same on
both sides. Every value here is an int64 bit pattern (``ops/lanes.py``):
no ``torch.uint64`` and no floating point.

The digests cover the shuffle's data plane, string planes included. The
skew sidecar's heavy-hitter broadcast and the local join are outside it,
and a check means something only on a result that did not overflow (an
overflow clamps rows by design and asks for a retry anyway).

Known departures from the JAX package's bits, all in its hashes: the
port's float32 hash folds -0.0 onto 0.0 (the JAX package's does not), and
the JAX package's float64 hash is inexact on XLA:CPU; every other dtype
digests bit for bit as JAX does. The numpy mirrors (``*_np``) are built
on the port's own (``parallel/out_of_core.py``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import torch

from distributed_join_tpu_torch.ops.hashing import (
    _hash_one,
    fmix32,
    fmix64,
    hash_combine,
)

# The digests ride the tape's int64 lanes: the top bit is masked, so the
# value is the same read as signed or unsigned.
_FOLD63 = (1 << 63) - 1

_SENT_RE = re.compile(r"^(?P<channel>.+)\.integrity\.sent_to_(?P<dst>\d+)$")


class IntegrityError(RuntimeError):
    """A completed shuffle delivered rows its senders did not commit to:
    corruption crossed the wire. ``.report`` is the
    :class:`IntegrityReport`. Unlike an overflow (a sizing problem that
    a larger capacity fixes), its retry runs the SAME sizing: the data
    was wrong, not too big."""

    def __init__(self, report: "IntegrityReport"):
        self.report = report
        pairs = ", ".join(f"{m['channel']}[{m['src']}->{m['dst']}]"
                          for m in report.mismatches[:4])
        more = ("" if len(report.mismatches) <= 4
                else f" (+{len(report.mismatches) - 4} more)")
        super().__init__(
            f"wire integrity violated on {len(report.mismatches)} of "
            f"{report.checked_pairs} (src,dst) digest pairs: {pairs}"
            f"{more} — the shuffle delivered rows its senders did not "
            "send; do not trust this result")


@dataclasses.dataclass(frozen=True)
class IntegrityReport:
    """The host's verdict on one verified join or exchange.

    ``mismatches`` holds one dict a failed (source, destination) pair,
    ``{"channel", "src", "dst", "sent", "recv"}``, ``channel`` being the
    digest scope (``build``/``probe`` for the join's shuffles).
    ``checked_pairs`` counts the pairs compared; 0 means the program
    carried no digests (one rank has no wire), and the report is
    vacuously ok."""

    ok: bool
    checked_pairs: int
    channels: tuple
    mismatches: tuple

    def as_record(self) -> dict:
        """The JSON record the drivers put under ``"integrity"``."""
        return {"ok": self.ok, "checked_pairs": self.checked_pairs,
                "channels": list(self.channels),
                "mismatches": [dict(m) for m in self.mismatches]}


# -- the device digests -------------------------------------------------


def _digest_column(col: torch.Tensor) -> torch.Tensor:
    """A uint64 hash (int64 bits) a row of one column. A 1-D column
    takes the join's own hash of its dtype; a wider one (string bytes,
    word planes) folds every trailing lane through ``hash_combine`` with
    its index, so a byte that moves within a row changes the digest. A
    byte column of a width divisible by 4 folds 4x fewer lanes, as u32
    words."""
    if col.ndim == 1:
        return _hash_one(col)
    flat = col.reshape(col.shape[0], -1)
    if flat.dtype == torch.uint8 and flat.shape[1] % 4 == 0:
        flat = flat.contiguous().view(torch.int32)
    acc = None
    for w in range(flat.shape[1]):
        lane = flat[:, w]
        h = fmix32(lane) if lane.element_size() < 8 else fmix64(lane)
        h = hash_combine(h, h.new_full((), w + 1))
        acc = h if acc is None else hash_combine(acc, h)
    return fmix64(acc)


def row_digests(columns: dict) -> torch.Tensor:
    """(rows,) uint64 bits in int64: one digest a row over EVERY
    column, combined in sorted-name order (both ends of an exchange hold
    the same column set, so they share the order)."""
    acc = None
    for name in sorted(columns):
        h = _digest_column(columns[name])
        acc = h if acc is None else hash_combine(acc, h)
    return fmix64(acc)


def fold63(digest: torch.Tensor) -> torch.Tensor:
    """A digest as a tape lane: the top bit masked."""
    return digest & _FOLD63


def _block_rows(columns: dict):
    """``(n, capacity, row digests (n, capacity))`` of an ``(n,
    capacity, ...)`` block layout."""
    n, capacity = next(iter(columns.values())).shape[:2]
    flat = {name: c.reshape((n * capacity,) + tuple(c.shape[2:]))
            for name, c in columns.items()}
    return n, capacity, row_digests(flat).reshape(n, capacity)


def padded_block_digests(columns: dict, counts: torch.Tensor
                         ) -> torch.Tensor:
    """(n,) int64 digests of a padded ``(n, capacity, ...)`` block:
    entry j sums the row digests of block j's first ``counts[j]`` rows
    (a sender's rows routed to destination j, or a receiver's rows
    believed received from source j). Padding slots hold whatever the
    gather left there, and the count mask leaves them out."""
    _, capacity, rd = _block_rows(columns)
    lane = torch.arange(capacity, dtype=torch.int32, device=rd.device)
    valid = lane[None, :] < counts[:, None]
    return fold63(torch.where(valid, rd, 0).sum(dim=1))


def masked_block_digests(columns: dict, row_valid: torch.Tensor
                         ) -> torch.Tensor:
    """(n,) int64 digests of an ``(n, capacity, ...)`` block under an
    explicit ``(n, capacity)`` validity mask: the segmented sort's
    layout, whose blocks interleave a valid prefix a segment, so no one
    count describes a block. The same sums and contract as
    :func:`padded_block_digests`."""
    _, _, rd = _block_rows(columns)
    return fold63(torch.where(row_valid, rd, 0).sum(dim=1))


def segment_digests(digests: torch.Tensor, starts, sizes) -> torch.Tensor:
    """(n,) int64 digests of the row segments ``[starts[j], starts[j] +
    sizes[j])`` of a per-row digest vector (the ragged layouts: a
    sender's buckets, a receiver's sender blocks): differences of one
    exclusive prefix sum, wrapping. ``starts`` and ``sizes`` are tensors
    or host sequences; a segment out of range is clamped to the rows."""
    rows = digests.shape[0]
    dev = digests.device
    starts = torch.as_tensor(starts, device=dev).to(torch.int64)
    sizes = torch.as_tensor(sizes, device=dev).to(torch.int64)
    cs = torch.cat([digests.new_zeros(1), torch.cumsum(digests, 0)])
    lo = starts.clamp(0, rows)
    hi = torch.maximum(torch.minimum(starts + sizes,
                                     torch.full_like(starts, rows)), lo)
    return fold63(cs[hi] - cs[lo])


def record_pair_digests(digest_tape, sent: torch.Tensor,
                        recv: torch.Tensor) -> None:
    """Add one exchange's digest vectors to the tape, as ``sent_to_j``
    and ``recv_from_j`` under its scope. The over-decomposition's
    batches sum into the same lanes: the digest does not see order, so
    the pair check holds over the whole step."""
    for j in range(sent.shape[0]):
        digest_tape.add(f"sent_to_{j}", sent[j])
        digest_tape.add(f"recv_from_{j}", recv[j])


# -- the host's check ---------------------------------------------------


def verify_digests(metrics, channels: Optional[Sequence[str]] = None
                   ) -> IntegrityReport:
    """Every ``<channel>.integrity.sent_to_d`` against its
    ``recv_from_s`` partner in the gathered block. ``metrics`` is a
    ``telemetry.metrics.Metrics`` (read to the host once, here) or its
    ``to_dict()``. The digest rank s reports for (s -> d) must equal the
    one rank d reports for it; a pair that differs names the exact
    (channel, source, destination) where rows changed in flight."""
    d = metrics.to_dict() if hasattr(metrics, "to_dict") else metrics
    per_rank = d["per_rank"]
    n = int(d["n_ranks"])
    found = sorted({m.group("channel") for name in per_rank
                    for m in (_SENT_RE.match(name),) if m is not None})
    if channels is not None:
        found = [c for c in found if c in set(channels)]
    mismatches = []
    checked = 0
    for channel in found:
        for src in range(n):
            for dst in range(n):
                sent = per_rank[f"{channel}.integrity.sent_to_{dst}"][src]
                recv = per_rank[f"{channel}.integrity.recv_from_{src}"][dst]
                checked += 1
                if sent != recv:
                    mismatches.append({"channel": channel, "src": src,
                                       "dst": dst, "sent": int(sent),
                                       "recv": int(recv)})
    return IntegrityReport(ok=not mismatches, checked_pairs=checked,
                           channels=tuple(found),
                           mismatches=tuple(mismatches))


def verify_join_result(res) -> IntegrityReport:
    """Check a result built with ``with_integrity=True``: its metrics
    block (``res.telemetry``) carries the digests."""
    metrics = getattr(res, "telemetry", None)
    if metrics is None:
        raise ValueError(
            "result carries no metrics block — build the join with "
            "with_integrity=True (or verify_integrity=True on "
            "distributed_inner_join)")
    return verify_digests(metrics)


# -- numpy mirrors ------------------------------------------------------


def row_digests_np(columns: dict):
    """numpy :func:`row_digests` (uint64), for oracles that grade a
    fetched table as an order-free multiset without the device. Equal to
    the device digest on integer and byte columns, and on float32 without
    -0.0; float64 follows ``out_of_core._hash_one_np``'s decomposition."""
    import numpy as np

    from distributed_join_tpu_torch.parallel.out_of_core import (
        _hash_one_np,
        fmix32_np,
        fmix64_np,
        hash_combine_np,
    )

    acc = None
    for name in sorted(columns):
        col = np.asarray(columns[name])
        if col.ndim == 1:
            h = _hash_one_np(col)
        else:
            flat = col.reshape(col.shape[0], -1)
            if flat.dtype == np.uint8 and flat.shape[1] % 4 == 0:
                flat = np.ascontiguousarray(flat).view(np.uint32)
            h = None
            for w in range(flat.shape[1]):
                lane = flat[:, w]
                lh = (fmix32_np(lane).astype(np.uint64)
                      if lane.dtype.itemsize < 8 else fmix64_np(lane))
                lh = hash_combine_np(lh, np.uint64(w + 1))
                h = lh if h is None else hash_combine_np(h, lh)
            h = fmix64_np(h)
        acc = h if acc is None else hash_combine_np(acc, h)
    return fmix64_np(acc)


def table_digest_np(columns: dict) -> int:
    """The order-free 63-bit multiset digest of a host table (a dict of
    equal-length numpy columns)."""
    import numpy as np

    if not columns or next(iter(columns.values())).shape[0] == 0:
        return 0
    rd = row_digests_np(columns)
    return int(np.sum(rd, dtype=np.uint64) & np.uint64(_FOLD63))
