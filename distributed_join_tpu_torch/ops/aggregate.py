"""Fused join+aggregate: group reductions in the join's merged domain.

Port of ``distributed_join_tpu/ops/aggregate.py``. The spec layer
(``AggregateSpec``, ``resolve_agg_mode``, ``partial_lane_schema``,
``wire_columns``, ``partial_columns``, ``resolve_groups_capacity``) is a
copy of the reference's pure-Python contract, refusal messages word for
word. The device layer keeps the reference's algebra: after the join's
merged sort every equal-key run holds B build rows, then P probe rows,
and its inner join is the B x P cross product, so per run

- ``COUNT(*) = B * P``, ``SUM(probe col) = B * sum(col over probes)``,
  ``SUM(build col) = P * sum(col over builds)``;
- MIN/MAX over the column's own side; a carry takes any (here the
  first) flagged row's value;
- ``MEAN = SUM / COUNT``, two combinable lanes divided after the last
  combine (:func:`finalize_groups`).

Group by the join keys ("key" mode) reduces in the merged order, and
hash partitioning has put each group on one rank already. Probe-side or
build-side group columns ("probe" and "build" modes) reduce each
contributing row's values once more by group (:func:`_reduce_sorted`),
and the step exchanges these per-group partials across ranks.

Where the reference runs log-shift segmented scans (``ceil(log2 n)``
full passes a lane), the port reads every value it needs as a per-run
result: run ids are a 1-D cumsum of the run starts, an integer run total
is a 1-D cumsum read at each run's last position less the one before
(exact in wrapping arithmetic), a float run total is a segment sum by
run id (``index_add_``; its summation order differs from the reference's
scans, so float lanes agree within a tolerance, not bit for bit), and a
run minimum or maximum is a ``scatter_reduce`` by run id. The surviving
groups compact into a dense prefix through :func:`compact_groups`, the
order-preserving stream compaction (``csrc/stream_compact.cu`` on CUDA
tensors, its plain twin on CPU tensors), where the reference sorts the
whole domain by a running index: the same contract, ``pos ==
cumsum(mask) - 1``, survivors in order, those past the capacity
dropped. Slots past the groups total are undefined.

The host oracles (:func:`group_reduce_frame`, :func:`aggregate_oracle`,
:func:`frames_equal`, :func:`groups_frame`) are numpy: a "frame" is a
dict of equal-length numpy columns in output order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.ops.compact import stream_compact
from distributed_join_tpu_torch.ops.join import (
    _lexsort,
    _masked_keys,
    _run_starts,
)
from distributed_join_tpu_torch.ops.lanes import from_u64_lane, to_u64_lane
from distributed_join_tpu_torch.table import Table

AGG_OPS = ("sum", "count", "min", "max", "mean")

# Internal partial-lane suffixes: a mean rides as two combinable lanes
# until the last combine divides them.
SUM_SUFFIX = "#sum"
CNT_SUFFIX = "#cnt"


class AggregatePushdownUnsupported(ValueError):
    """This (spec, schema) shape cannot ride the fused pushdown; the
    message names the reason. Run the materializing join instead."""


@dataclasses.dataclass(frozen=True)
class AggExpr:
    """One aggregate output: ``op`` over ``column`` (None for count),
    emitted as output column ``name``."""

    op: str
    column: Optional[str]
    name: str


@dataclasses.dataclass(frozen=True)
class AggregateSpec:
    """The pushdown contract of one fused join+aggregate query.

    ``group_keys``: the GROUP BY columns; exactly the join keys is key
    mode, probe-side (build-side) columns probe (build) mode. ``aggs``:
    the :class:`AggExpr` outputs. ``carry``: columns functionally
    dependent on the group key, carried as any value of the group.
    ``groups_per_rank``: the per-rank partial-groups capacity; None
    derives it from the join's output capacity (enough, since groups <=
    matches)."""

    group_keys: tuple
    aggs: tuple
    carry: tuple = ()
    groups_per_rank: Optional[int] = None

    @classmethod
    def of(cls, group_by, aggs, carry=(), groups_per_rank=None
           ) -> "AggregateSpec":
        """Normalize loose forms: ``group_by`` a name or sequence;
        ``aggs`` entries may be ``AggExpr``, ``"count"``, ``(op,
        column)`` or ``(op, column, name)``."""
        gk = ((group_by,) if isinstance(group_by, str)
              else tuple(group_by))
        out = []
        for a in aggs:
            if isinstance(a, AggExpr):
                out.append(a)
                continue
            if isinstance(a, str):
                a = (a, None)
            op = a[0]
            column = a[1] if len(a) > 1 else None
            name = a[2] if len(a) > 2 else (
                "count" if op == "count" else f"{op}_{column}")
            out.append(AggExpr(op=op, column=column, name=name))
        return cls(group_keys=gk, aggs=tuple(out), carry=tuple(carry),
                   groups_per_rank=(int(groups_per_rank)
                                    if groups_per_rank else None))

    @classmethod
    def from_wire(cls, spec: dict) -> "AggregateSpec":
        """The wire form: ``{"group_by": [...], "aggs": [["sum", "col"],
        ["count"], ...], "carry": [...], "groups_per_rank": N}``."""
        return cls.of(
            spec["group_by"],
            [tuple(a) if not isinstance(a, str) else a
             for a in spec.get("aggs") or ()],
            carry=tuple(spec.get("carry") or ()),
            groups_per_rank=spec.get("groups_per_rank"),
        )

    def as_record(self) -> dict:
        return {
            "group_keys": list(self.group_keys),
            "aggs": [[a.op, a.column, a.name] for a in self.aggs],
            "carry": list(self.carry),
            "groups_per_rank": self.groups_per_rank,
        }


# -- spec validation (schema level) --------------------------------------


def _refuse(reason: str):
    raise AggregatePushdownUnsupported(
        f"aggregate pushdown unsupported: {reason}")


def resolve_agg_mode(spec: AggregateSpec, keys: Sequence[str],
                     build_cols: dict, probe_cols: dict) -> str:
    """Validate ``spec`` against the join and return the fused mode:
    ``"key"`` (group keys == join keys), ``"probe"`` (probe-side group
    columns) or ``"build"`` (build-side group columns).
    ``build_cols``/``probe_cols`` map column name -> ``(dtype_str,
    ndim)``. Every refusal names its reason."""
    keys = list(keys)
    if not spec.group_keys:
        _refuse("empty group_keys")
    if not spec.aggs:
        _refuse("no aggregate expressions")
    if len(set(spec.group_keys)) != len(spec.group_keys):
        _refuse("duplicate group_keys")
    names = [a.name for a in spec.aggs]
    out_names = list(spec.group_keys) + names + list(spec.carry)
    if len(set(out_names)) != len(out_names):
        _refuse(f"output name collision in {sorted(out_names)}")
    for nm in names:
        if nm.startswith("__") or "#" in nm:
            _refuse(f"aggregate name {nm!r} uses reserved characters")
    if spec.groups_per_rank is not None and spec.groups_per_rank < 1:
        _refuse("groups_per_rank must be >= 1")

    def side_of(col: str, what: str) -> str:
        if col in keys:
            _refuse(f"{what} {col!r} is a join key column; join keys "
                    "ride as group keys, not aggregate inputs")
        b, p = col in build_cols, col in probe_cols
        if b and p:
            _refuse(f"{what} {col!r} exists on BOTH sides — rename "
                    "one side")
        if not (b or p):
            _refuse(f"{what} {col!r} not found on either side")
        dtype, ndim = (build_cols if b else probe_cols)[col]
        if ndim != 1:
            _refuse(f"{what} {col!r} is {ndim}-D; pushdown covers "
                    "scalar columns")
        return "b" if b else "p"

    for a in spec.aggs:
        if a.op not in AGG_OPS:
            _refuse(f"unknown aggregate op {a.op!r} (have {AGG_OPS})")
        if a.op == "count":
            if a.column is not None:
                _refuse("count takes no column")
            continue
        if a.column is None:
            _refuse(f"{a.op} needs a column")
        side_of(a.column, "aggregate column")

    if tuple(spec.group_keys) == tuple(keys):
        for c in spec.carry:
            side_of(c, "carry column")
        return "key"

    # probe/build mode: every group key resolves to ONE side's scalar
    # integer columns (join keys exist on the probe side too, so key
    # subsets route to probe mode)
    g_sides = set()
    for g in spec.group_keys:
        if g in keys:
            if g not in probe_cols:
                _refuse(f"group key {g!r} (a join key) has no "
                        "probe-side column to regroup by")
            dtype, ndim = probe_cols[g]
            g_sides.add("p")
        elif g in probe_cols and g in build_cols:
            _refuse(f"group key {g!r} exists on BOTH sides — rename "
                    "one side")
        elif g in probe_cols:
            dtype, ndim = probe_cols[g]
            g_sides.add("p")
        elif g in build_cols:
            dtype, ndim = build_cols[g]
            g_sides.add("b")
        else:
            _refuse(f"group key {g!r} not found")
        if ndim != 1:
            _refuse(f"group key {g!r} is {ndim}-D")
        if not str(dtype).startswith(("int", "uint")):
            _refuse(f"group key {g!r} has dtype {dtype}; non-key "
                    "group keys must be integers (hash-partitioned "
                    "partials exchange)")
    if g_sides == {"b", "p"}:
        _refuse("group keys span BOTH sides "
                f"({sorted(spec.group_keys)}); mixed-side group-bys "
                "are unimplemented — group by one side and carry the "
                "other side's column when it is key-functional")
    mode = "build" if g_sides == {"b"} else "probe"
    want = "p" if mode == "probe" else "b"
    for c in spec.carry:
        if side_of(c, "carry column") != want:
            _refuse(f"carry column {c!r} lives on the "
                    f"{'build' if want == 'p' else 'probe'} side; "
                    f"under a {mode}-side group-by only "
                    f"{'probe' if want == 'p' else 'build'}-side "
                    "carries are functionally sound")
    return mode


def partial_lane_schema(spec: AggregateSpec, build_cols: dict,
                        probe_cols: dict) -> tuple:
    """The combinable partial lanes, in output order: ``((lane_name,
    combine_op, source_column_or_None, dtype_str), ...)``, combine_op
    in {"sum", "min", "max", "first"}."""
    def dtype_of(col):
        d, _ = build_cols.get(col) or probe_cols[col]
        return str(d)

    def acc_dtype(col):
        d = dtype_of(col)
        return d if d.startswith("float") else "int64"

    lanes = []
    for a in spec.aggs:
        if a.op == "count":
            lanes.append((a.name, "sum", None, "int64"))
        elif a.op == "sum":
            lanes.append((a.name, "sum", a.column, acc_dtype(a.column)))
        elif a.op in ("min", "max"):
            lanes.append((a.name, a.op, a.column, dtype_of(a.column)))
        elif a.op == "mean":
            lanes.append((a.name + SUM_SUFFIX, "sum", a.column,
                          acc_dtype(a.column)))
            lanes.append((a.name + CNT_SUFFIX, "sum", None, "int64"))
    for c in spec.carry:
        lanes.append((c, "first", c, dtype_of(c)))
    return tuple(lanes)


def wire_columns(spec: AggregateSpec, mode: str, keys: Sequence[str],
                 build_cols: dict, probe_cols: dict) -> tuple:
    """The columns each side partitions and shuffles under pushdown: the
    join keys plus exactly the columns the reduction reads (aggregate
    inputs, probe or build group keys, carries). Returns
    ``(build_names, probe_names)``, keys first, the rest name-sorted."""
    keys = list(keys)
    need_b, need_p = set(), set()
    for a in spec.aggs:
        if a.column is None:
            continue
        (need_b if a.column in build_cols else need_p).add(a.column)
    for c in spec.carry:
        (need_b if c in build_cols else need_p).add(c)
    if mode == "probe":
        for g in spec.group_keys:
            need_p.add(g)
    elif mode == "build":
        for g in spec.group_keys:
            need_b.add(g)
    return (tuple(keys) + tuple(sorted(need_b - set(keys))),
            tuple(keys) + tuple(sorted(need_p - set(keys))))


def partial_columns(spec: AggregateSpec, mode: str, keys: Sequence[str],
                    build_cols: dict, probe_cols: dict) -> tuple:
    """The physical columns of the per-rank partials table (group key
    columns, then the combinable lanes) as ``((name, dtype_str),
    ...)``: the wire schema of the partials exchange."""
    group_names = (tuple(keys) if mode == "key"
                   else tuple(spec.group_keys))
    cols = []
    for g in group_names:
        d, _ = (probe_cols.get(g) if mode == "probe"
                else build_cols.get(g) if mode == "build"
                else build_cols.get(g) or probe_cols.get(g))
        cols.append((g, str(d)))
    for name, _op, _col, dt in partial_lane_schema(spec, build_cols,
                                                   probe_cols):
        cols.append((name, str(dt)))
    return tuple(cols)


def resolve_groups_capacity(spec: AggregateSpec, out_cap: int) -> int:
    """The per-rank partial-groups capacity: the caller's
    ``groups_per_rank``, or the join's output capacity (groups <=
    matches, so the derived value doubles with the ladder's
    out-capacity rung), rounded up to 8."""
    g = spec.groups_per_rank if spec.groups_per_rank else out_cap
    return max((int(g) + 7) // 8 * 8, 8)


def dtype_name(dt: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``int64``, ``float32``,
    ``bool``): the spelling the JAX package's schemas and refusal
    messages use."""
    return str(dt).replace("torch.", "")


def table_schema(table: Table) -> dict:
    """{name: (dtype_str, ndim)} of a Table: the validation basis."""
    return {name: (dtype_name(c.dtype), int(c.ndim))
            for name, c in table.columns.items()}


# -- per-run reductions over a sorted domain -----------------------------


def _identity(dt: torch.dtype, op: str):
    """The identity of ``op`` ("min" or "max") in ``dt``."""
    if dt.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    if dt == torch.bool or dt.is_complex:
        raise TypeError(f"unsupported aggregate dtype {dt}")
    info = torch.iinfo(dt)
    return info.max if op == "min" else info.min


@dataclasses.dataclass(frozen=True)
class _Runs:
    """The run structure of a sorted domain of n positions. Per-run
    arrays have n entries, run r at index r; entries past the last run
    are not runs (``live`` is False there)."""

    rid: torch.Tensor     # (n,) int64: the run of each position
    last: torch.Tensor    # (n,) bool: the run's last position
    start: torch.Tensor   # (n,) int64: run r's first position (0 past the runs)
    live: torch.Tensor    # (n,) bool: r is a run

    @staticmethod
    def of(first: torch.Tensor) -> "_Runs":
        n = first.shape[0]
        rid = torch.cumsum(first, 0, dtype=torch.int64) - 1
        last = torch.ones_like(first)
        last[:-1] = first[1:]
        iota = torch.arange(n, dtype=torch.int64, device=first.device)
        start = _per_run(iota, first, rid, 0)
        return _Runs(rid, last, start, iota <= rid[-1])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Run totals of ``x``. Integers: the 1-D inclusive cumsum at
        each run's last position less the previous run's (wrapping, so
        exact); past the runs the difference is 0. Floats: a segment
        sum by run id, accumulated in float64 and rounded once to the
        lane's dtype, so a float32 sum's error does not grow with its
        run's length nor, but for a rounding tie, depend on the order
        of the atomic adds."""
        n = x.shape[0]
        if x.dtype.is_floating_point:
            acc = x.new_zeros(n, dtype=torch.float64)
            return acc.index_add_(0, self.rid, x.double()).to(x.dtype)
        c = torch.cumsum(x, 0, dtype=x.dtype)
        ends = _per_run(c, self.last, self.rid, c[-1])
        return ends - torch.cat([ends.new_zeros(1), ends[:-1]])

    def reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """Run minima or maxima of ``x`` (positions that must not
        count already hold the identity)."""
        out = torch.full_like(x, _identity(x.dtype, op))
        return out.scatter_reduce_(0, self.rid, x,
                                   reduce="amin" if op == "min" else "amax",
                                   include_self=True)

    def at_start(self, x: torch.Tensor, offset=None) -> torch.Tensor:
        """``x`` at each run's first position (plus ``offset``, clamped
        into the domain)."""
        idx = self.start if offset is None else (
            self.start + offset).clamp(max=x.shape[0] - 1)
        return x[idx]


def _per_run(x: torch.Tensor, mark: torch.Tensor, rid: torch.Tensor,
             fill) -> torch.Tensor:
    """A per-run array holding ``x`` at the positions ``mark`` flags
    (one a run) and ``fill`` (a number or a 0-d tensor) past the runs.
    Every other position writes a slot of its own past the n kept ones:
    sent to one shared slot instead, the writes contend for it (a
    scatter of 82.5 M positions took 2.4 ms on an H100)."""
    n = x.shape[0]
    out = torch.empty(2 * n, dtype=x.dtype, device=x.device)
    out[:n] = fill
    iota = torch.arange(n, n + n, dtype=torch.int64, device=x.device)
    out.scatter_(0, torch.where(mark, rid, iota), x)
    return out[:n]


def compact_groups(mask, pos, cols, capacity):
    """The groups compaction of the fused aggregate:
    :func:`~.compact.stream_compact` with its launches counted on this
    call site."""
    return stream_compact(mask, pos, cols, capacity,
                          launch_counter=compact_groups)


compact_groups.launches = 0


def _to_lane(c: torch.Tensor) -> torch.Tensor:
    if c.dtype == torch.bool:
        return c.to(torch.int64)
    lane = to_u64_lane(c)
    if lane is None:
        raise TypeError(f"unsupported aggregate dtype {c.dtype}")
    return lane.contiguous()


def _from_lane(lane: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return lane.to(torch.bool) if dt == torch.bool else from_u64_lane(lane,
                                                                       dt)


def _compact_runs(is_rec: torch.Tensor, cols: list, capacity: int):
    """Compact the records ``is_rec`` flags (of a per-run domain) into
    a dense prefix of ``capacity`` slots, in order, through
    :func:`compact_groups`. ``cols`` is ``[(name, (n,) tensor), ...]``;
    returns ``(dict name -> (capacity,) tensor, valid, groups_total,
    overflow)``."""
    pos = torch.cumsum(is_rec, 0, dtype=torch.int32) - 1
    g_total = is_rec.sum(dtype=torch.int64)
    lanes = compact_groups(is_rec, pos, [_to_lane(c) for _, c in cols],
                           capacity)
    out = {name: _from_lane(lane, c.dtype)
           for (name, c), lane in zip(cols, lanes)}
    j = torch.arange(capacity, dtype=torch.int64, device=is_rec.device)
    valid = j < g_total.clamp(max=capacity)
    return out, valid, g_total, g_total > capacity


def _reduce_sorted(group_vals: list, lanes: list, part: torch.Tensor,
                   capacity: int):
    """Group-reduce rows that are not yet grouped: one lexsort by
    (participation tag, group columns), a per-run reduction of each lane
    by its op, and the groups compaction. ``group_vals`` is ``[(name,
    tensor)]`` (sort keys and output columns); ``lanes`` is ``[(name,
    op, tensor)]`` with op in {"sum", "min", "max", "first"}; ``part``
    marks the contributing rows. Shared by the probe and build modes'
    local reduction, the cross-batch combine and the post-exchange
    combine."""
    tag = (~part).to(torch.int8)
    perm = _lexsort([tag, *[g for _, g in group_vals]])
    stag = tag[perm]
    sgroups = [g[perm] for _, g in group_vals]
    runs = _Runs.of(_run_starts([stag, *sgroups]))
    spart = stag == 0
    reduced = []
    for name, op, v in lanes:
        sv = v[perm]
        if op == "sum":
            x = runs.sum(torch.where(spart, sv, torch.zeros_like(sv)))
        elif op in ("min", "max"):
            x = runs.reduce(torch.where(
                spart, sv, torch.full_like(sv, _identity(sv.dtype, op))), op)
        else:  # first: a run is all contributing rows or none
            x = runs.at_start(sv)
        reduced.append((name, x))
    is_rec = runs.live & runs.at_start(spart)
    cols = ([(nm, runs.at_start(g)) for (nm, _), g in zip(group_vals,
                                                           sgroups)]
            + reduced)
    return _compact_runs(is_rec, cols, capacity)


# -- the local fused op --------------------------------------------------


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def local_join_aggregate(build: Table, probe: Table, keys: Sequence[str],
                         spec: AggregateSpec, mode: str,
                         groups_capacity: int):
    """One shard's fused join+aggregate (JAX ``ops/aggregate.py:540``):
    the join's merged sort with every needed column riding as a value,
    per-run totals in place of the output expansion, and the groups
    compaction. Returns ``(partials: Table, total, groups_total,
    overflow)``: ``partials`` carries the combinable lanes of
    :func:`partial_lane_schema` (finalize with :func:`finalize_groups`
    after the last combine), ``total`` the rows the materializing join
    would emit. The sort runs in the ``merged_sort`` phase, the run
    reductions and the compaction in ``agg_reduce``."""
    keys = list(keys)
    bcols, pcols = table_schema(build), table_schema(probe)
    lanes_schema = partial_lane_schema(spec, bcols, pcols)

    def side_of(col):
        return "b" if col in build.columns else "p"

    # every column the reduction reads, one lane per (side, column)
    needed = {}
    for _, op, col, _dt in lanes_schema:
        if col is not None:
            needed[(side_of(col), col)] = None
    if mode in ("probe", "build"):
        for g in spec.group_keys:
            needed[(mode[0], g)] = None

    nb = build.capacity
    with telemetry.phase("merged_sort"):
        m_ops, tag = _masked_keys(build, probe, keys)
        perm = _lexsort([*m_ops, tag])
        skeys = [op[perm] for op in m_ops]
        stag = tag[perm]
        svals = {}
        for side, col in needed:
            c = (build if side == "b" else probe).columns[col]
            other = (probe if side == "b" else build).capacity
            pad = c.new_zeros(other)
            svals[(side, col)] = torch.cat([c, pad] if side == "b"
                                           else [pad, c])[perm]
        del perm

    with telemetry.phase("agg_reduce"):
        runs = _Runs.of(_run_starts(skeys))
        is_build, is_probe = stag == 0, stag == 1
        b_cnt = runs.sum(is_build.to(torch.int32))
        p_cnt = runs.sum(is_probe.to(torch.int32))
        # the join total the materializing pipeline would produce
        total = (b_cnt.to(torch.int64) * p_cnt.to(torch.int64)).sum()

        def side_total(side, col, op, adt=None):
            """Run totals (sum, min or max) of one side's column."""
            v = svals[(side, col)]
            on = is_build if side == "b" else is_probe
            if op == "sum":
                v = v.to(adt)
                return runs.sum(torch.where(on, v, torch.zeros_like(v)))
            return runs.reduce(torch.where(
                on, v, torch.full_like(v, _identity(v.dtype, op))), op)

        if mode == "key":
            reduced = []
            for lane_name, op, col, dt in lanes_schema:
                adt = _torch_dtype(dt)
                if op == "sum" and col is None:       # a count lane
                    x = b_cnt.to(adt) * p_cnt.to(adt)
                elif op == "sum":
                    other = b_cnt if side_of(col) == "p" else p_cnt
                    x = (side_total(side_of(col), col, "sum", adt)
                         * other.to(adt))
                elif op in ("min", "max"):
                    x = side_total(side_of(col), col, op)
                else:  # first: builds open a run, its probes follow them
                    sd = side_of(col)
                    x = runs.at_start(svals[(sd, col)],
                                      None if sd == "b" else b_cnt)
                reduced.append((lane_name, x))
            is_rec = (b_cnt > 0) & (p_cnt > 0)
            cols = ([(kname, runs.at_start(sk))
                     for kname, sk in zip(keys, skeys)] + reduced)
            groups, valid, g_total, overflow = _compact_runs(
                is_rec, cols, groups_capacity)
            group_names = keys
        else:
            # probe (build) mode: each contributing probe (build) row's
            # share of its run, then one regroup by the group columns
            own, other = ("p", "b") if mode == "probe" else ("b", "p")
            mine = is_probe if mode == "probe" else is_build
            other_cnt = (b_cnt if mode == "probe" else p_cnt)[runs.rid]
            part = mine & (other_cnt > 0)
            lanes = []
            for lane_name, op, col, dt in lanes_schema:
                adt = _torch_dtype(dt)
                if op == "sum" and col is None:
                    contrib = other_cnt.to(adt)
                elif op == "sum":
                    if side_of(col) == own:
                        contrib = (svals[(own, col)].to(adt)
                                   * other_cnt.to(adt))
                    else:
                        contrib = side_total(other, col, "sum", adt)[runs.rid]
                elif op in ("min", "max"):
                    if side_of(col) == own:
                        contrib = svals[(own, col)]
                    else:
                        contrib = side_total(other, col, op)[runs.rid]
                else:  # first: a carry of the grouped side
                    contrib = svals[(own, col)]
                lanes.append((lane_name, op, contrib))
            group_vals = [(g, svals[(own, g)]) for g in spec.group_keys]
            groups, valid, g_total, overflow = _reduce_sorted(
                group_vals, lanes, part, groups_capacity)
            group_names = list(spec.group_keys)

    cols = {nm: groups[nm] for nm in group_names}
    for lane_name, _, _, _ in lanes_schema:
        cols[lane_name] = groups[lane_name]
    return Table(cols, valid), total, g_total, overflow


def combine_partials(tables: Sequence[Table], spec: AggregateSpec,
                     group_names: Sequence[str], lanes_schema,
                     out_capacity: int):
    """Merge partial-groups tables (across batches, or the received
    block of the partials exchange): concatenate, regroup, combine each
    lane by its op (sums add, minima take the least, carries any) and
    compact. Returns ``(partials, groups_total, overflow)``."""
    cat = tables[0] if len(tables) == 1 else Table(
        {nm: torch.cat([t.columns[nm] for t in tables])
         for nm in tables[0].column_names},
        torch.cat([t.valid for t in tables]))
    group_vals = [(nm, cat.columns[nm]) for nm in group_names]
    lanes = [(nm, op, cat.columns[nm]) for nm, op, _, _ in lanes_schema]
    groups, valid, g_total, overflow = _reduce_sorted(
        group_vals, lanes, cat.valid, out_capacity)
    cols = {nm: groups[nm] for nm in group_names}
    for nm, _, _, _ in lanes_schema:
        cols[nm] = groups[nm]
    return Table(cols, valid), g_total, overflow


def finalize_groups(partials: Table, spec: AggregateSpec,
                    group_names: Sequence[str]) -> Table:
    """The last step after every combine: divide the mean lanes (in the
    sum's float dtype, float32 for an integer sum), drop the internal
    lanes, order the columns (group keys, aggregates, carries)."""
    cols = {nm: partials.columns[nm] for nm in group_names}
    for a in spec.aggs:
        if a.op == "mean":
            s = partials.columns[a.name + SUM_SUFFIX]
            c = partials.columns[a.name + CNT_SUFFIX]
            fdt = s.dtype if s.dtype.is_floating_point else torch.float32
            cols[a.name] = s.to(fdt) / c.clamp(min=1).to(fdt)
        else:
            cols[a.name] = partials.columns[a.name]
    for c in spec.carry:
        cols[c] = partials.columns[c]
    return Table(cols, partials.valid)


# -- host oracles (numpy) -------------------------------------------------


def _group_starts(cols: list):
    """The lexicographic order of the rows of ``cols`` (numpy columns,
    most significant first) and the first sorted row of each group."""
    n = len(cols[0])
    order = np.lexsort(cols[::-1])
    first = np.zeros(n, bool)
    if n:
        first[0] = True
        for c in cols:
            s = c[order]
            first[1:] |= s[1:] != s[:-1]
    return order, np.flatnonzero(first)


def group_reduce_frame(joined: dict, spec: AggregateSpec) -> dict:
    """Host group-by of an already-joined frame (numpy columns): one row
    per group (group keys, aggregates, carries), sorted by the group
    keys. Sums of integer columns are int64, a mean is float64, a carry
    takes the group's first row."""
    gk = list(spec.group_keys)
    order, starts = _group_starts([np.asarray(joined[g]) for g in gk])
    sizes = np.diff(np.append(starts, len(order)))
    out = {g: np.asarray(joined[g])[order][starts] for g in gk}

    def reduce(col, ufunc):
        v = np.asarray(joined[col])[order]
        if ufunc is np.add and v.dtype.kind in "iub":
            v = v.astype(np.int64)
        if not len(starts):
            return v[:0]
        return ufunc.reduceat(v, starts)

    for a in spec.aggs:
        if a.op == "count":
            out[a.name] = sizes.astype(np.int64)
        elif a.op == "sum":
            out[a.name] = reduce(a.column, np.add)
        elif a.op == "mean":
            out[a.name] = reduce(a.column, np.add) / sizes
        else:
            out[a.name] = reduce(a.column, {"min": np.minimum,
                                            "max": np.maximum}[a.op])
    for c in spec.carry:
        out[c] = np.asarray(joined[c])[order][starts]
    return out


def aggregate_oracle(build: Table, probe: Table, keys,
                     spec: AggregateSpec) -> dict:
    """The numpy reference of the fused pipeline: the inner join of the
    valid rows, grouped by ``spec.group_keys`` and reduced. Columns in
    the pushdown's output order, rows sorted by the group keys."""
    from distributed_join_tpu_torch.utils.tpch_host import _merge_oracle

    keys = [keys] if isinstance(keys, str) else list(keys)
    joined = _merge_oracle(probe.to_host(), build.to_host(), keys,
                           "inner")
    return group_reduce_frame(joined, spec)


def frames_equal(got: dict, want: dict) -> bool:
    """Equality of a pushdown groups frame and the oracle's: the same
    columns in the same order and rows, integer columns exactly, float
    columns within ``numpy.allclose``'s rtol 1e-5 and atol 1e-8 (as the
    JAX package grades)."""
    if list(got) != list(want):
        return False
    if len({len(v) for v in (*got.values(), *want.values())}) > 1:
        return False
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            if not np.allclose(g.astype(float), w.astype(float)):
                return False
        elif not (g.astype(np.int64) == w.astype(np.int64)).all():
            return False
    return True


def groups_frame(table: Table, spec: AggregateSpec, group_names) -> dict:
    """A finalized pushdown result (``JoinResult.table`` of an aggregate
    query) as a host frame in oracle order: columns (group keys,
    aggregates, carries), rows sorted by the group keys."""
    rows = table.to_host()
    gk = list(group_names)
    order = np.lexsort([rows[g] for g in gk][::-1])
    names = gk + [a.name for a in spec.aggs] + list(spec.carry)
    return {nm: rows[nm][order] for nm in names}
