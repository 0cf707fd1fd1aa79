"""The harness's own collectives over the run's process group (plain
``torch.distributed``), used after the window: sums of the comparison's
numbers, the exchange of rows to the rank that owns them, and the
gathering of each rank's readings. With one process each is the
identity."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist


@dataclass
class RankContext:
    rank: int
    world: int
    device: torch.device
    tmpdir: Path

    @property
    def distributed(self) -> bool:
        return self.world > 1


def all_sum(ctx: RankContext, values: list) -> list:
    """Each integer summed over the ranks."""
    if not ctx.distributed:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=ctx.device)
    dist.all_reduce(t)
    return [int(v) for v in t.tolist()]


def gather(ctx: RankContext, obj) -> list:
    """Every rank's ``obj`` (picklable), on every rank, in rank order."""
    if not ctx.distributed:
        return [obj]
    out = [None] * ctx.world
    dist.all_gather_object(out, obj)
    return out


def exchange_rows(ctx: RankContext, cols: dict, dest: torch.Tensor) -> dict:
    """Send each row of ``cols`` (int64 columns) to rank ``dest[row]``
    (clamped to the ranks: a row whose owner is out of range is wrong
    wherever it lands); returns the rows this rank received."""
    if not ctx.distributed:
        return cols
    dest = dest.clamp(0, ctx.world - 1)
    names = list(cols)
    order = torch.sort(dest, stable=True).indices
    rows = torch.stack([cols[n].to(torch.int64)[order] for n in names], 1)
    send = torch.bincount(dest, minlength=ctx.world).to(torch.int64)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    send_l, recv_l = send.tolist(), recv.tolist()
    out = rows.new_empty((sum(recv_l), len(names)))
    dist.all_to_all_single(out.view(-1), rows.reshape(-1).contiguous(),
                           [c * len(names) for c in recv_l],
                           [c * len(names) for c in send_l])
    return {n: out[:, i] for i, n in enumerate(names)}
