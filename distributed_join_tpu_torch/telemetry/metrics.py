"""Device metrics: counters that ride the join step and come back to the
host once, after it.

Port of ``distributed_join_tpu/telemetry/metrics.py``: ``Metrics`` and
``MetricsTape``. A step with the tape on accumulates its counters while
it runs, as Python ints (what the host knows already: padded wire bytes,
the ragged wire's host plans, the retry rung) or 0-d device tensors
(partition counts, match totals), stacks them into one int64 vector at
step end and all-gathers it with ONE ``Communicator.all_gather``. The
host reads the ``(n_ranks, n_metrics)`` block once, in
:meth:`Metrics.to_dict`, after the timed region: the step itself reads
nothing back (no ``.item()``), so the tape adds no synchronisation to
the kernel pipeline.

Names use dotted scopes (``build.rows_shuffled``, ``probe.wire_bytes``);
the reduction across ranks is a sum unless the name ends in ``_min`` or
``_max``. The catalog is the JAX package's (``docs/OBSERVABILITY.md``).

Tape off (``with_metrics=False``, the default) constructs no tape: the
step launches exactly what it launches without this module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Metrics:
    """The step's metrics block: ``values[r, i]`` is metric ``names[i]``
    on rank ``r``, gathered, so every rank holds the whole block."""

    names: tuple
    values: torch.Tensor  # (n_ranks, n_metrics) int64

    def to_dict(self) -> dict:
        """One read of the block to the host: per-rank values and each
        metric's reduction over the ranks (sum, or min/max by the name's
        suffix). Integrity digest lanes (``*.integrity.*``) keep no
        reduction."""
        vals = self.values.cpu().tolist()
        per_rank = {n: [int(row[i]) for row in vals]
                    for i, n in enumerate(self.names)}
        reduced = {}
        for n in sorted(per_rank):
            v = per_rank[n]
            if ".integrity." in n:
                continue
            if n.endswith("_min"):
                reduced[n] = min(v)
            elif n.endswith("_max"):
                reduced[n] = max(v)
            else:
                reduced[n] = sum(v)
        return {"n_ranks": len(vals),
                "per_rank": dict(sorted(per_rank.items())),
                "reduced": reduced}


class MetricsTape:
    """The step's accumulator. A value is a Python int or a 0-d tensor;
    ``scoped("build")`` is a view writing ``build.``-prefixed names into
    the same storage, so a shuffle need not know its side."""

    def __init__(self, _store: Optional[dict] = None, _prefix: str = ""):
        self._store = {} if _store is None else _store
        self._prefix = _prefix

    def scoped(self, prefix: str) -> "MetricsTape":
        return MetricsTape(self._store, f"{self._prefix}{prefix}.")

    def add(self, name: str, value) -> None:
        """Sum ``value`` into ``name`` (per rank)."""
        key = self._prefix + name
        prev = self._store.get(key)
        self._store[key] = value if prev is None else prev + value

    def record_min(self, name: str, value) -> None:
        """Keep the least value seen; ``name`` ends in ``_min`` so the
        reduction over ranks takes the least too."""
        key = self._prefix + name
        prev = self._store.get(key)
        if prev is None:
            self._store[key] = value
        elif isinstance(prev, int) and isinstance(value, int):
            self._store[key] = min(prev, value)
        else:
            self._store[key] = torch.minimum(torch.as_tensor(prev),
                                             torch.as_tensor(value))

    def gathered(self, comm, device) -> Metrics:
        """Step end: the rank's vector (the host's ints moved in one copy,
        the device scalars stacked) and one all-gather of it."""
        names = sorted(self._store)
        host = [n for n in names if not isinstance(self._store[n],
                                                   torch.Tensor)]
        dev = [n for n in names if n not in host]
        parts = []
        if host:
            parts.append(torch.tensor(
                [int(self._store[n]) for n in host],
                dtype=torch.int64).to(device, non_blocking=True))
        if dev:
            parts.append(torch.stack([
                self._store[n].to(device=device,
                                  dtype=torch.int64).reshape(())
                for n in dev]))
        vec = parts[0] if len(parts) == 1 else torch.cat(parts)
        return Metrics(names=tuple(host + dev),
                       values=comm.all_gather(vec[None]))
