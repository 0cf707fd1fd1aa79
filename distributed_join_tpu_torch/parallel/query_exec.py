"""Run a ``planning.query.QueryPlan`` as one per-rank program.

Port of ``distributed_join_tpu/parallel/query_exec.py``: ``QueryResult``
(:55), ``make_query_step`` (:95), ``query_sharded_out`` (:149),
``make_distributed_query`` (:158) and ``distributed_query`` (:235).
Every ``make_join_step`` step is a per-rank function over collectives,
so a plan runs by calling the operators' steps in turn inside one
function under ``comm.spmd``: each intermediate is an ordinary table of
the rank's rows that stays on the device, and each operator's own
partition and shuffle re-shards it by the next key.

``distributed_query`` pads the base tables to a rank-divisible capacity
and, on overflow anywhere in the chain, doubles every operator's
``shuffle_capacity_factor`` and ``out_capacity_factor`` together, up to
``auto_retry`` times (the JAX package's ladder for whole queries). With
a ``program_cache`` (``service.programs.JoinProgramCache``) each rung's
program is keyed by a ``QuerySignature`` (JAX :191-233): the plan's
digest, the base tables' shapes, the rung's options and the mesh.

``with_metrics`` (JAX :77-181): every operator's step keeps the metrics
tape, and the program returns one ``Metrics`` block an operator, in plan
order, hung on the result as ``res.telemetry``; ``None`` resolves from
the telemetry session, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.parallel.distributed_join import (
    DEFAULT_OUT_CAPACITY_FACTOR,
    DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    make_join_step,
    with_telemetry,
)
from distributed_join_tpu_torch.table import Table

__all__ = [
    "QueryResult",
    "QuerySignature",
    "make_query_step",
    "make_distributed_query",
    "distributed_query",
]


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """The terminal operator's output and the chain's health: ``total``
    is the last operator's count (the would-be join rows of a fused
    aggregate, as its step reports them; matches otherwise),
    ``op_totals`` each operator's, in plan order, and ``overflow`` the
    OR over every operator, so a retry re-runs the whole query.
    ``distributed_query`` attaches ``plan_digest`` and
    ``retry_attempts`` as attributes."""

    table: Table
    total: torch.Tensor
    overflow: torch.Tensor
    op_totals: tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _op_steps(comm, plan, defaults, with_metrics=False, metrics_static=None):
    from distributed_join_tpu_torch.ops import aggregate as agg_ops

    steps = []
    for op in plan.ops:
        opts = dict(defaults)
        opts.update(op.opts())
        if op.aggregate is not None:
            opts["aggregate"] = agg_ops.AggregateSpec.from_wire(op.aggregate)
        key = list(op.keys) if len(op.keys) > 1 else op.keys[0]
        steps.append(make_join_step(comm, key=key, join_type=op.join_type,
                                    with_metrics=with_metrics,
                                    metrics_static=metrics_static, **opts))
    return steps


def make_query_step(comm, plan, *, defaults: Optional[dict] = None,
                    with_metrics: bool = False,
                    metrics_static: Optional[dict] = None):
    """The per-rank step of the whole plan, ``step(*tables) ->
    QueryResult``, the tables in ``plan.tables`` order; run it under
    ``comm.spmd`` with :func:`query_sharded_out`. ``defaults`` are join
    options of every operator (an operator's own plan options win).
    With ``with_metrics`` the step returns ``(QueryResult, (Metrics,
    ...))``, one block an operator."""
    op_steps = _op_steps(comm, plan, dict(defaults or {}), with_metrics,
                         metrics_static)
    names = tuple(plan.tables)
    ops = plan.ops

    def step(*tables):
        if len(tables) != len(names):
            raise TypeError(f"query step takes {len(names)} tables "
                            f"{list(names)}, got {len(tables)}")
        env = dict(zip(names, tables))
        op_totals = []
        metrics = []
        overflow = None
        res = None
        for op, op_step in zip(ops, op_steps):
            res = op_step(env[op.build], env[op.probe])
            if with_metrics:
                res, m = res
                metrics.append(m)
            env[op.op_id] = res.table
            op_totals.append(res.total)
            overflow = res.overflow if overflow is None \
                else overflow | res.overflow
        result = QueryResult(table=res.table, total=res.total,
                             overflow=overflow, op_totals=tuple(op_totals))
        return (result, tuple(metrics)) if with_metrics else result

    return step


def query_sharded_out(plan, with_metrics: bool = False):
    """The ``comm.spmd`` out-spec of :func:`make_query_step`: the table
    row-sharded, every summed count and the flag replicated (and the
    metrics blocks, gathered in the step)."""
    res = QueryResult(table=False, total=True, overflow=True,
                      op_totals=(True,) * len(plan.ops))
    return (res, (True,) * len(plan.ops)) if with_metrics else res


def make_distributed_query(comm, plan, with_metrics=None,
                           metrics_static: Optional[dict] = None,
                           **defaults):
    """``fn(*tables) -> QueryResult`` over row-sharded global tables
    (capacities divisible by the rank count) in ``plan.tables`` order:
    the whole chain as one per-rank program. ``defaults`` are join
    options of every operator. ``with_metrics=None`` resolves from the
    telemetry session; with metrics on the result carries the
    operators' blocks as ``res.telemetry``."""
    if with_metrics is None:
        with_metrics = telemetry.enabled()
    program = comm.spmd(
        make_query_step(comm, plan, defaults=defaults,
                        with_metrics=with_metrics,
                        metrics_static=metrics_static),
        sharded_out=query_sharded_out(plan, with_metrics))
    return with_telemetry(program) if with_metrics else program


@dataclasses.dataclass(frozen=True)
class QuerySignature:
    """The cache identity of one query program: the plan's digest, the
    padded base tables' schemas and capacities (in plan order), the
    name-sorted executor options (the rung among them) and the mesh."""

    n_ranks: int
    plan_digest: str
    tables: tuple            # (name, schema triples, capacity) a table
    options: tuple           # name-sorted (knob, value) pairs
    n_slices: int = 1

    @classmethod
    def of(cls, comm, plan, tables, **options) -> "QuerySignature":
        from distributed_join_tpu_torch.service.programs import _schema_of

        return cls(
            n_ranks=int(comm.n_ranks),
            plan_digest=plan.digest(),
            tables=tuple((name, _schema_of(tables[name]),
                          int(tables[name].capacity))
                         for name in plan.tables),
            options=tuple(sorted(options.items())),
            n_slices=int(comm.n_slices))

    def canonical(self) -> dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        from distributed_join_tpu_torch.service.programs import _digest

        return _digest(self.canonical())


def distributed_query(tables: Mapping[str, Table], plan, comm,
                      auto_retry: int = 0, program_cache=None,
                      with_metrics=None, **defaults) -> QueryResult:
    """Run the whole plan: pad each base table to a rank-divisible
    capacity, run the one program, and on overflow anywhere in the
    chain double every operator's ``shuffle_capacity_factor`` and
    ``out_capacity_factor`` and run again, up to ``auto_retry`` times.
    With ``program_cache`` each rung's program comes from the cache, so
    a repeat query, or a rung seen before, builds none. The result
    carries ``plan_digest``, ``cache_hit`` (the first attempt's) and
    ``retry_attempts``; with metrics on (``None``: the telemetry
    session's state) also ``telemetry``, the final attempt's blocks."""
    if program_cache is not None and program_cache.comm is not comm:
        raise ValueError(
            "program_cache was built for a different communicator")
    if with_metrics is None:
        with_metrics = telemetry.enabled()
    n = comm.n_ranks
    missing = [name for name in plan.tables if name not in tables]
    if missing:
        raise ValueError(
            f"plan references base tables {missing} not supplied "
            f"(have {sorted(tables)})")
    padded = {name: tables[name].pad_to(
        _round_up(tables[name].capacity, n)) for name in plan.tables}
    args = tuple(padded[name] for name in plan.tables)
    defaults = dict(defaults)
    shuffle_f = float(defaults.pop("shuffle_capacity_factor",
                                   DEFAULT_SHUFFLE_CAPACITY_FACTOR))
    out_f = float(defaults.pop("out_capacity_factor",
                               DEFAULT_OUT_CAPACITY_FACTOR))
    first_hit = None
    for attempt in range(auto_retry + 1):
        scale = 2 ** attempt
        sizing = dict(defaults, shuffle_capacity_factor=shuffle_f * scale,
                      out_capacity_factor=out_f * scale)
        static = {"retry_attempt_max": attempt}
        if program_cache is not None:
            sig = QuerySignature.of(comm, plan, padded,
                                    with_metrics=bool(with_metrics),
                                    rung=attempt, **sizing)
            fn, hit = program_cache.get_keyed(
                sig, lambda sizing=sizing, static=static:
                make_distributed_query(comm, plan, with_metrics=with_metrics,
                                       metrics_static=static, **sizing),
                persist=True)
        else:
            fn, hit = make_distributed_query(
                comm, plan, with_metrics=with_metrics, metrics_static=static,
                **sizing), False
        if first_hit is None:
            first_hit = hit
        res = fn(*args)
        if not bool(res.overflow):
            break
    object.__setattr__(res, "plan_digest", plan.digest())
    object.__setattr__(res, "cache_hit", bool(first_hit))
    object.__setattr__(res, "retry_attempts", attempt)
    return res
