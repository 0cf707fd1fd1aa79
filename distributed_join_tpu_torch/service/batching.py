"""Micro-batching: K small joins as one step.

Port of ``distributed_join_tpu/service/batching.py``: ``MicroBatch``
(:49), ``_check_uniform``, ``_stack``, ``combine`` (:92) and ``split``
(:133). :func:`combine` packs K same-schema requests into one build and
probe pair, each request padded to a uniform slot (so the combined shape,
and with it the cached program, depends on the slot and K only), with an
int32 ``#batch`` segment column on both sides. The segment column joins
as an extra key column (the composite-key path), so two rows match only
when their keys are equal and they belong to the same request: matches
never cross requests. :func:`split` unpacks the result per request on
the host.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from distributed_join_tpu_torch.table import Table

# not '__'-prefixed: the join reserves that namespace for its internal
# lanes; '#' keeps the name out of user schemas, as the '#len'
# companions of string columns
SEGMENT_COLUMN = "#batch"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """One combined build and probe pair and the plan to unpack it."""

    build: Table
    probe: Table
    key: tuple                  # the combined key, SEGMENT_COLUMN last
    n_requests: int
    slot_build_rows: int
    slot_probe_rows: int


def _check_uniform(tables: Sequence[Table], side: str) -> None:
    want = {n: (c.dtype, tuple(c.shape[1:]))
            for n, c in tables[0].columns.items()}
    for i, t in enumerate(tables[1:], start=1):
        got = {n: (c.dtype, tuple(c.shape[1:]))
               for n, c in t.columns.items()}
        if got != want:
            raise ValueError(
                f"micro-batch {side} schemas differ: request 0 has "
                f"{sorted(want)}, request {i} has {sorted(got)} — a "
                "batch shares one compiled program, so every request "
                "must share one schema")
    if SEGMENT_COLUMN in want:
        raise ValueError(
            f"{side} tables already carry {SEGMENT_COLUMN!r} — the "
            "segment column is batching-internal")


def _stack(tables: Sequence[Table], slot: int) -> Table:
    padded = [t.pad_to(slot) for t in tables]
    cols = {name: torch.cat([t.columns[name] for t in padded])
            for name in padded[0].column_names}
    # padding rows carry their slot's segment id too, but are not valid
    cols[SEGMENT_COLUMN] = torch.arange(
        len(tables), dtype=torch.int32,
        device=padded[0].device).repeat_interleave(slot)
    return Table(cols, torch.cat([t.valid for t in padded]))


def combine(requests: Sequence, key="key", *, slot_build_rows=None,
            slot_probe_rows=None) -> MicroBatch:
    """Pack ``requests``, a sequence of ``(build, probe)`` table pairs
    joining on the same ``key``, into one :class:`MicroBatch`. Slots
    default to the largest request (rounded up to 8); pin them with
    ``slot_*_rows`` so that calls whose largest request varies share one
    cached program."""
    if not requests:
        raise ValueError("micro-batch needs at least one request")
    builds = [b for b, _ in requests]
    probes = [p for _, p in requests]
    _check_uniform(builds, "build")
    _check_uniform(probes, "probe")
    keys = [key] if isinstance(key, str) else list(key)
    for kname in keys:
        if kname not in builds[0].columns \
                or kname not in probes[0].columns:
            raise ValueError(f"key column {kname!r} missing from the "
                             "batched tables")
    b_slot = _round_up(slot_build_rows or max(b.capacity for b in builds),
                       8)
    p_slot = _round_up(slot_probe_rows or max(p.capacity for p in probes),
                       8)
    if any(b.capacity > b_slot for b in builds) \
            or any(p.capacity > p_slot for p in probes):
        raise ValueError(f"a request exceeds the batch slot (build "
                         f"{b_slot}, probe {p_slot} rows)")
    return MicroBatch(build=_stack(builds, b_slot),
                      probe=_stack(probes, p_slot),
                      key=tuple(keys) + (SEGMENT_COLUMN,),
                      n_requests=len(requests),
                      slot_build_rows=b_slot, slot_probe_rows=p_slot)


def split(res, batch: MicroBatch, with_rows: bool = False) -> list:
    """Unpack a batched ``JoinResult`` per request: one dict a request
    with ``matches`` (its match count), ``overflow`` (the shared flag:
    the output block is pooled, so an overflow taints every request)
    and, with ``with_rows``, its rows as numpy columns (the segment
    column dropped)."""
    valid = res.table.valid.cpu().numpy()
    seg = res.table.columns[SEGMENT_COLUMN].cpu().numpy()
    counts = np.bincount(seg[valid], minlength=batch.n_requests)
    overflow = bool(res.overflow)
    host = ({name: col.cpu().numpy()
             for name, col in res.table.columns.items()
             if name != SEGMENT_COLUMN} if with_rows else None)
    out = []
    for i in range(batch.n_requests):
        entry = {"matches": int(counts[i]), "overflow": overflow}
        if with_rows:
            take = valid & (seg == i)
            entry["rows"] = {name: col[take] for name, col in host.items()}
        out.append(entry)
    return out
