"""Multi-operator query plans: the join-type family composed into one
per-rank program.

Port of ``distributed_join_tpu/planning/query.py``: ``QueryOp``,
``QueryPlan`` (``of``, ``from_wire``, ``canonical``, ``digest``,
``infer_schemas``, ``n_operators``, ``output``, ``aggregate``),
``tpch_query_plan`` (:641), ``TPCH_QUERIES``, ``OP_OPTION_KEYS`` and
``QUERY_SCHEMA_VERSION``. A plan is a wire-able chain over named base
tables: ``join`` operators of any join type plus at most one
``aggregate`` node, fused into the terminal join as the aggregate
pushdown (``ops/aggregate.py``). Plans are left-deep chains by
construction; any other wiring refuses at plan time with
``ValueError("query plan unsupported: ...")``, the reference's words.

``digest()`` is ``service.programs.spec_digest`` of the canonical
record, the port's own copy of the reference's canonicalizer, so a
plan's digest equals the JAX package's. ``explain_query`` (JAX :469-620)
prices a plan per operator without running it: each operator's
``planning.plan.explain_join`` plan over its inputs (an intermediate
sized as the upstream step materializes it, padding included, so the
downstream wire bytes stay exact), the cost model's verdict, the summed
critical path, and every other left-deep order of an all-inner chain,
priced by the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = [
    "QueryOp",
    "QueryPlan",
    "QUERY_SCHEMA_VERSION",
    "explain_query",
    "tpch_query_plan",
    "TPCH_QUERIES",
]

QUERY_SCHEMA_VERSION = 1

# Per-operator knobs a plan may carry (everything else refuses: the
# wiring fields have slots of their own).
OP_OPTION_KEYS = (
    "over_decomposition",
    "shuffle_capacity_factor",
    "out_capacity_factor",
    "out_rows_per_rank",
    "shuffle",
    "compression_bits",
    "skew_threshold",
    "sort_mode",
    "sort_segments",
    "dcn_codec",
)


def _refuse(reason: str):
    raise ValueError(f"query plan unsupported: {reason}")


@dataclasses.dataclass(frozen=True)
class QueryOp:
    """One normalized join operator: ``build``/``probe`` name a base
    table or an earlier operator's output; ``aggregate`` (a wire dict,
    terminal operator only) fuses the group-by into this join."""

    op_id: str
    build: str
    probe: str
    keys: tuple
    join_type: str = "inner"
    options: tuple = ()          # name-sorted (knob, value) pairs
    aggregate: Optional[dict] = None

    def opts(self) -> dict:
        return dict(self.options)

    def as_record(self) -> dict:
        rec = {
            "id": self.op_id,
            "op": "join",
            "build": self.build,
            "probe": self.probe,
            "key": list(self.keys),
            "join_type": self.join_type,
            "options": dict(self.options),
        }
        if self.aggregate is not None:
            rec["aggregate"] = dict(self.aggregate)
        return rec


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """The validated, normalized plan. Build with :meth:`of` (or
    :meth:`from_wire`); the raw constructor validates nothing."""

    tables: tuple                # base table names, execution arg order
    ops: tuple                   # QueryOp chain, topological order

    @classmethod
    def of(cls, ops: Sequence[dict], tables=None) -> "QueryPlan":
        """Normalize a loose op list. Each entry is a dict:
        ``{"op": "join", "id": ..., "build": ref, "probe": ref, "key":
        name-or-list, "join_type": ..., "options": {...}}`` or
        ``{"op": "aggregate", "id": ..., "input": join-id, "spec":
        AggregateSpec-or-wire-dict}``. The aggregate node fuses into its
        input join, which must be the terminal one; ``tables`` fixes the
        execution argument order (default: first reference)."""
        from distributed_join_tpu_torch.ops import aggregate as agg_ops
        from distributed_join_tpu_torch.ops.join import JOIN_TYPES

        if not ops:
            _refuse("empty operator list")
        seen_ids: set = set()
        joins: list = []
        agg_nodes: list = []
        for entry in ops:
            if not isinstance(entry, dict):
                _refuse(f"operator entry {entry!r} is not a mapping")
            kind = entry.get("op")
            op_id = entry.get("id")
            if not op_id or not isinstance(op_id, str):
                _refuse(f"operator {entry!r} is missing an 'id'")
            if op_id in seen_ids:
                _refuse(f"duplicate operator id {op_id!r}")
            seen_ids.add(op_id)
            if kind == "join":
                key = entry.get("key")
                keys = ((key,) if isinstance(key, str)
                        else tuple(key or ()))
                if not keys:
                    _refuse(f"join {op_id!r} has no key")
                jt = entry.get("join_type") or "inner"
                if jt not in JOIN_TYPES:
                    _refuse(f"join {op_id!r} join_type {jt!r} is not "
                            f"one of {JOIN_TYPES}")
                raw_opts = dict(entry.get("options") or {})
                for knob in raw_opts:
                    if knob not in OP_OPTION_KEYS:
                        _refuse(
                            f"join {op_id!r} option {knob!r} is not a "
                            f"plan-settable knob {OP_OPTION_KEYS}")
                joins.append(QueryOp(
                    op_id=op_id,
                    build=str(entry.get("build")),
                    probe=str(entry.get("probe")),
                    keys=keys,
                    join_type=jt,
                    options=tuple(sorted(raw_opts.items())),
                ))
            elif kind == "aggregate":
                spec = entry.get("spec")
                if isinstance(spec, agg_ops.AggregateSpec):
                    wire = _agg_wire(spec)
                elif isinstance(spec, dict):
                    # round trip, so a malformed wire spec refuses here
                    wire = _agg_wire(agg_ops.AggregateSpec.from_wire(spec))
                else:
                    _refuse(f"aggregate {op_id!r} has no spec")
                agg_nodes.append((op_id, str(entry.get("input")), wire))
            else:
                _refuse(f"operator {op_id!r} kind {kind!r} is not "
                        "'join' or 'aggregate'")

        if not joins:
            _refuse("plan has no join operators")
        if len(agg_nodes) > 1:
            _refuse("more than one aggregate node; compose further "
                    "reductions on the host")
        if agg_nodes:
            agg_id, agg_input, wire = agg_nodes[0]
            if agg_input != joins[-1].op_id:
                _refuse(
                    f"aggregate {agg_id!r} consumes {agg_input!r}, "
                    f"but only the terminal join "
                    f"({joins[-1].op_id!r}) supports the fused "
                    "pushdown — standalone group-by nodes are "
                    "unimplemented")
            joins[-1] = dataclasses.replace(joins[-1], aggregate=wire)

        plan = cls(tables=(), ops=tuple(joins))
        plan = dataclasses.replace(plan,
                                   tables=plan._resolve_tables(tables))
        plan._validate_wiring()
        return plan

    @classmethod
    def from_wire(cls, doc: dict) -> "QueryPlan":
        """Rebuild from :meth:`canonical` (the wire form)."""
        if not isinstance(doc, dict):
            _refuse("wire plan is not a mapping")
        ops = []
        for rec in doc.get("ops") or ():
            rec = dict(rec)
            agg = rec.pop("aggregate", None)
            rec.setdefault("op", "join")
            ops.append(rec)
            if agg is not None:
                ops.append({"op": "aggregate", "id": f"__agg_{rec['id']}",
                            "input": rec["id"], "spec": agg})
        return cls.of(ops, tables=doc.get("tables"))

    # -- identity --------------------------------------------------------

    def canonical(self) -> dict:
        return {
            "schema_version": QUERY_SCHEMA_VERSION,
            "tables": list(self.tables),
            "ops": [op.as_record() for op in self.ops],
            "output": self.ops[-1].op_id,
        }

    def digest(self) -> str:
        from distributed_join_tpu_torch.service.programs import spec_digest

        return spec_digest(self.canonical())

    @property
    def output(self) -> str:
        return self.ops[-1].op_id

    @property
    def aggregate(self):
        from distributed_join_tpu_torch.ops.aggregate import AggregateSpec

        wire = self.ops[-1].aggregate
        return None if wire is None else AggregateSpec.from_wire(wire)

    def n_operators(self) -> int:
        agg = 1 if self.ops[-1].aggregate is not None else 0
        return len(self.ops) + agg

    # -- validation ------------------------------------------------------

    def _resolve_tables(self, tables) -> tuple:
        op_ids = {op.op_id for op in self.ops}
        referenced = []
        for op in self.ops:
            for ref in (op.build, op.probe):
                if ref not in op_ids and ref not in referenced:
                    referenced.append(ref)
        if tables is None:
            return tuple(referenced)
        tables = tuple(tables)
        if sorted(tables) != sorted(referenced):
            _refuse(f"declared tables {sorted(tables)} != referenced "
                    f"base tables {sorted(referenced)}")
        return tables

    def _validate_wiring(self) -> None:
        available = set(self.tables)
        consumers: dict = {}
        for op in self.ops:
            for ref in (op.build, op.probe):
                if ref not in available:
                    _refuse(
                        f"join {op.op_id!r} input {ref!r} is neither "
                        "a base table nor an earlier operator (plans "
                        "are topologically ordered)")
                consumers.setdefault(ref, []).append(op.op_id)
            if op.build == op.probe:
                _refuse(f"join {op.op_id!r} joins {op.build!r} with "
                        "itself on the same reference; alias the "
                        "table under two names for a self-join")
            available.add(op.op_id)
        op_ids = {op.op_id for op in self.ops}
        for ref, users in consumers.items():
            if ref in op_ids and len(users) > 1:
                _refuse(
                    f"intermediate {ref!r} feeds {sorted(users)}; "
                    "DAG fan-out of an operator output is "
                    "unimplemented — plans are left-deep chains")
        terminal = [op.op_id for op in self.ops if op.op_id not in consumers]
        if terminal != [self.ops[-1].op_id]:
            _refuse(f"plan has dangling operators {sorted(terminal)}; "
                    "exactly the last op may be unconsumed")

    # -- schema inference ------------------------------------------------

    def infer_schemas(self, table_schemas: dict) -> dict:
        """Propagate column schemas through the chain. Input and output
        are ``{name: {column: (dtype_str, trailing_shape)}}``; refusals
        (missing keys, dtype mismatches, cross-side column collisions)
        name the operator. The result also holds every intermediate
        under its op id."""
        from distributed_join_tpu_torch.ops import aggregate as agg_ops
        from distributed_join_tpu_torch.ops.join import (
            BUILD_VALID,
            OUTER_TYPES,
            PROBE_VALID,
        )

        env = {name: dict(cols) for name, cols in table_schemas.items()}
        for name in self.tables:
            if name not in env:
                _refuse(f"no schema given for base table {name!r}")
        for op in self.ops:
            b, p = env[op.build], env[op.probe]
            for kname in op.keys:
                if kname not in b or kname not in p:
                    _refuse(f"join {op.op_id!r} key {kname!r} missing "
                            f"on {'build' if kname not in b else 'probe'}"
                            f" side")
                if b[kname] != p[kname]:
                    _refuse(f"join {op.op_id!r} key {kname!r} dtype "
                            f"mismatch: build {b[kname]} vs probe "
                            f"{p[kname]}")
            out = {kname: p[kname] for kname in op.keys}
            b_pay = {c: s for c, s in b.items() if c not in op.keys}
            p_pay = {c: s for c, s in p.items() if c not in op.keys}
            clash = sorted(set(b_pay) & set(p_pay))
            if clash and op.join_type not in ("semi", "anti"):
                _refuse(f"join {op.op_id!r} payload column(s) {clash} "
                        "exist on both sides — rename before "
                        "planning")
            if op.join_type in ("semi", "anti"):
                out.update(p_pay)
            else:
                out.update(b_pay)
                out.update(p_pay)
                if op.join_type in OUTER_TYPES:
                    if op.join_type in ("left", "full_outer"):
                        out[BUILD_VALID] = ("bool", ())
                    if op.join_type in ("right", "full_outer"):
                        out[PROBE_VALID] = ("bool", ())
            if op.aggregate is not None:
                spec = agg_ops.AggregateSpec.from_wire(op.aggregate)
                # the step's contract, checked at plan time
                agg_ops.resolve_agg_mode(
                    spec, list(op.keys),
                    {c: (dt, 1 + len(sh)) for c, (dt, sh) in b.items()},
                    {c: (dt, 1 + len(sh)) for c, (dt, sh) in p.items()})
                out = _agg_out_schema(spec, b, p)
            env[op.op_id] = out
        return env


def _agg_wire(spec) -> dict:
    return {
        "group_by": list(spec.group_keys),
        "aggs": [[a.op, a.column, a.name] for a in spec.aggs],
        "carry": list(spec.carry),
        "groups_per_rank": spec.groups_per_rank,
    }


def _agg_out_schema(spec, bcols, pcols) -> dict:
    def side(col):
        return bcols.get(col) or pcols.get(col) or ("int64", ())

    out = {g: side(g) for g in spec.group_keys}
    for a in spec.aggs:
        if a.op in ("count", "sum"):
            out[a.name] = ("int64", ())
        elif a.op == "mean":
            out[a.name] = ("float64", ())
        else:                      # min / max keep the input dtype
            out[a.name] = side(a.column)
    for c in spec.carry:
        out[c] = side(c)
    return out


def _est_out_rows(op: QueryOp, b_rows: int, p_rows: int) -> int:
    """The chain's FK-join cardinality estimate of an intermediate (the
    preserved probe bounds inner, left, semi and anti; right and full
    outer add the unmatched builds). Shown only: operator plans size
    their inputs by :func:`_materialized_capacity`."""
    if op.join_type in ("right", "full_outer"):
        return p_rows + b_rows
    return p_rows


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _materialized_capacity(op: QueryOp, p_global: int, n: int,
                           defaults: dict) -> int:
    """The global capacity of this operator's output table: k blocks of
    ``out_cap`` rows a rank (plus the skew sidecar's block), the step's
    arithmetic. The next operator partitions this block, padding
    included, so its wire bytes predict exactly."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_OUT_CAPACITY_FACTOR,
        resolve_probe_capacities,
        skew_capacities,
    )

    opts = dict(defaults)
    opts.update(op.opts())
    k = int(opts.get("over_decomposition") or 1)
    out_f = float(opts.get("out_capacity_factor")
                  or DEFAULT_OUT_CAPACITY_FACTOR)
    p_local = _round_up(p_global, n) // n
    _, out_cap = resolve_probe_capacities(p_local, n, k, 1.0, out_f,
                                          opts.get("out_rows_per_rank"))
    per_rank = k * out_cap
    if opts.get("skew_threshold") is not None:
        per_rank += skew_capacities(
            p_local, hh_out_capacity=opts.get("hh_out_capacity"))[2]
    return n * per_rank


def explain_query(plan: QueryPlan, comm, tables: dict, cost_model=None,
                  defaults: Optional[dict] = None,
                  orders: bool = True) -> dict:
    """Price ``plan`` per operator without running anything. ``tables``
    maps a base table's name to a Table (real or ``meta`` tensors).
    Returns the ``kind: "queryplan"`` record: each operator's
    ``explain_join`` plan digest, wire and ``cost.predict`` verdict, the
    summed critical path, and (``orders``, all-inner chains only) every
    left-deep join order priced by the same model, the cheapest
    flagged."""
    from distributed_join_tpu_torch.planning import cost as cost_mod
    from distributed_join_tpu_torch.planning.plan import (
        abstract_table,
        column_schema,
        explain_join,
    )

    defaults = dict(defaults or {})
    schemas = {name: column_schema(t) for name, t in tables.items()}
    inferred = plan.infer_schemas(schemas)
    rows = {name: int(t.capacity) for name, t in tables.items()}

    op_records = []
    total_s = 0.0
    for op in plan.ops:
        b_rows, p_rows = rows[op.build], rows[op.probe]
        b_tbl = (tables[op.build] if op.build in tables
                 else abstract_table(inferred[op.build], b_rows))
        p_tbl = (tables[op.probe] if op.probe in tables
                 else abstract_table(inferred[op.probe], p_rows))
        opts = dict(defaults)
        opts.update(op.opts())
        if op.aggregate is not None:
            from distributed_join_tpu_torch.ops import aggregate as agg_ops

            opts["aggregate"] = agg_ops.AggregateSpec.from_wire(op.aggregate)
        opts["join_type"] = op.join_type
        key = list(op.keys) if len(op.keys) > 1 else op.keys[0]
        jplan = explain_join(b_tbl, p_tbl, comm, key=key,
                             cost_model=cost_model, **opts)
        verdict = cost_mod.predict(jplan, cost_model)
        total_s += float(verdict.get("total_s") or 0.0)
        rows[op.op_id] = _materialized_capacity(op, p_rows,
                                                int(comm.n_ranks), defaults)
        op_records.append({
            "id": op.op_id,
            "build": op.build,
            "probe": op.probe,
            "key": list(op.keys),
            "join_type": op.join_type,
            "aggregate": (dict(op.aggregate)
                          if op.aggregate is not None else None),
            "build_rows": b_rows,
            "probe_rows": p_rows,
            "est_out_rows": _est_out_rows(op, b_rows, p_rows),
            "out_capacity": rows[op.op_id],
            "digest": jplan.digest,
            "wire": jplan.wire,
            "cost": verdict,
        })

    record = {
        "schema_version": QUERY_SCHEMA_VERSION,
        "kind": "queryplan",
        "digest": plan.digest(),
        "n_ranks": int(comm.n_ranks),
        "plan": plan.canonical(),
        "operators": op_records,
        "n_operators": plan.n_operators(),
        "total_s": total_s,
    }
    if orders:
        record["orders"] = _priced_orders(plan, comm, tables, cost_model,
                                          defaults, total_s)
    return record


def _priced_orders(plan, comm, tables, cost_model, defaults,
                   own_total) -> list:
    """Every left-deep order of an all-inner chain, priced (outer, semi
    and anti joins do not commute: they pin the submitted order)."""
    if any(op.join_type != "inner" for op in plan.ops):
        return [{"tables": list(_chain_order(plan)),
                 "total_s": own_total, "chosen": True,
                 "note": "non-inner joins pin the submitted order"}]
    base = list(plan.tables)
    if len(base) != len(plan.ops) + 1 or len(base) > 6:
        return [{"tables": list(_chain_order(plan)),
                 "total_s": own_total, "chosen": True,
                 "note": "order enumeration covers simple chains of "
                         "up to 6 tables"}]
    import itertools

    from distributed_join_tpu_torch.planning.plan import column_schema

    schemas = {name: column_schema(t) for name, t in tables.items()}
    key_universe = sorted({k for op in plan.ops for k in op.keys})
    own = tuple(_chain_order(plan))
    priced = []
    for perm in itertools.permutations(base):
        chain = _chain_plan(plan, perm, key_universe, schemas)
        if chain is None:
            continue
        if perm == own:
            priced.append({"tables": list(perm), "total_s": own_total,
                           "chosen": True})
            continue
        try:
            rec = explain_query(chain, comm, tables, cost_model=cost_model,
                                defaults=defaults, orders=False)
            priced.append({"tables": list(perm),
                           "total_s": rec["total_s"], "chosen": False})
        except ValueError as exc:
            priced.append({"tables": list(perm), "total_s": None,
                           "chosen": False, "note": str(exc)})
    viable = [o for o in priced if o["total_s"] is not None]
    viable.sort(key=lambda o: o["total_s"])
    if viable:
        viable[0]["cheapest"] = True
    return priced


def _chain_order(plan: QueryPlan) -> list:
    """Base tables in the order the submitted chain takes them in."""
    seen: list = []
    op_ids = {op.op_id for op in plan.ops}
    for op in plan.ops:
        for ref in (op.build, op.probe):
            if ref not in op_ids and ref not in seen:
                seen.append(ref)
    return seen


def _chain_plan(plan, order, key_universe, schemas):
    """``plan`` as the left-deep chain taking ``order``'s tables in
    turn, the first as build; None where a step shares no join key with
    what came before."""
    avail = dict(schemas[order[0]])
    ops = []
    prev = order[0]
    for i, name in enumerate(order[1:]):
        keys = [k for k in key_universe if k in avail and k in schemas[name]]
        if not keys:
            return None
        ops.append({"op": "join", "id": f"o{i}", "build": prev,
                    "probe": name, "key": keys, "join_type": "inner"})
        for col, sig in schemas[name].items():
            avail.setdefault(col, sig)
        prev = f"o{i}"
    if plan.ops[-1].aggregate is not None:
        ops.append({"op": "aggregate", "id": "__agg",
                    "input": ops[-1]["id"],
                    "spec": dict(plan.ops[-1].aggregate)})
    try:
        return QueryPlan.of(ops)
    except ValueError:
        return None


# -- the TPC-H plans -------------------------------------------------------

TPCH_QUERIES = ("q3", "q10")


def tpch_query_plan(query: str) -> QueryPlan:
    """The 3-table TPC-H chains: ``customer ⋈ orders`` on ``custkey``,
    that ⋈ ``lineitem`` on ``orderkey``, the group-by fused into the
    second join. Q3 groups by the join key (key mode); Q10 by the
    build-side customer key (build mode)."""
    from distributed_join_tpu_torch.ops.aggregate import AggregateSpec

    if query == "q3":
        agg = AggregateSpec.of(
            "orderkey",
            [("sum", "l_extendedprice", "revenue"),
             ("count", None, "n_lines")],
            carry=("o_orderdate",))
    elif query == "q10":
        agg = AggregateSpec.of(
            "custkey",
            [("sum", "l_extendedprice", "revenue"),
             ("count", None, "n_lines")],
            carry=("c_acctbal",))
    else:
        raise ValueError(
            f"unknown TPC-H query {query!r}; pick one of {TPCH_QUERIES}")
    return QueryPlan.of([
        {"op": "join", "id": "j_cust_ord", "build": "customer",
         "probe": "orders", "key": "custkey", "join_type": "inner"},
        {"op": "join", "id": "j_ord_line", "build": "j_cust_ord",
         "probe": "lineitem", "key": "orderkey", "join_type": "inner"},
        {"op": "aggregate", "id": "groupby", "input": "j_ord_line",
         "spec": agg},
    ])
