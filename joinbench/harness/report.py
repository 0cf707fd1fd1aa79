"""Rank 0's line: the metrics read by their readers from the ranks'
reports, the device, the breakdown, and the numbers compared."""

from __future__ import annotations

from dataclasses import dataclass, field

from joinbench.harness import spec as spec_mod


@dataclass
class ReadContext:
    """What a metric's ``read(ctx)`` sees.

    ``ranks``: every rank's report (rank 0 first): ``setup_s``,
    ``window_s`` (untraced), ``ops``, ``latencies`` (s), ``retries``
    (one an operation), ``failed``, ``window_peak`` (bytes, reset at the
    window's start), ``trace`` (traced: ``harness.trace.reduce_events``'s
    numbers), ``work`` (one operation's counts, over every rank, from the
    reference) and ``rows_per_op``. ``kernels``: the kernel files' specs
    (``layers/kernels/*.json``). ``chips``: the cell's chips."""

    cell: str
    chips: int
    ranks: list
    kernels: dict = field(default_factory=dict)

    @property
    def rank0(self) -> dict:
        return self.ranks[0]

    @property
    def traces(self) -> list:
        return [r["trace"] for r in self.ranks
                if r.get("trace", {}).get("n_ops")]


def read_metrics(entries, kind: str, ctx: ReadContext) -> dict:
    """``{name: {"value", "unit"}}`` for every entry whose reader found
    something to read."""
    out = {}
    for m in entries:
        value = spec_mod.reader(kind, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def numbers(ranks: list) -> dict:
    """The numbers compared (identical on every rank: each is summed over
    the ranks where the system compares) as ``{name: (value, limit)}``,
    with the forbidden modules found on any rank."""
    out = dict(ranks[0]["numbers"])
    found = sorted({m for r in ranks for m in r["forbidden"]})
    out["forbidden_modules"] = (len(found), 0)
    return out


def breakdown(ctx: ReadContext):
    t = ctx.rank0.get("trace") or {}
    if not t.get("n_ops"):
        return None
    return {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
