"""The port's query layer (planning/query.py, parallel/query_exec.py, the
query tables and the numpy oracles) against the JAX package's, on the
CPU.

The JAX package generates the TPC-H query tables (SF 0.004: 600
customers, 6,000 orders, ~24,000 lines); they reach the port through
numpy. Held against the reference: Q3 (key mode) and Q10 (build mode,
the partials exchange) through ``distributed_query`` on 1, 4 and 8
emulated ranks, at over-decomposition 2 and on an emulated 2 x 2
hierarchy, each equal to JAX's ``distributed_query`` on its 8-device
mesh and to its pandas ``query_oracle``; the port's numpy oracles
against the pandas ones (every join type); plan digests; every plan
refusal's message. Group columns and integer aggregates compare exactly.
"""

import numpy as np
import pytest

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import aggregate as ja
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import query_exec as jq
from distributed_join_tpu.planning import query as jplan
from distributed_join_tpu.service.programs import spec_digest as jdigest
from distributed_join_tpu.utils import tpch as jtpch
from distributed_join_tpu.utils import tpch_host as jhost
from distributed_join_tpu_torch.ops import aggregate as ta
from distributed_join_tpu_torch.parallel import query_exec as tq
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.planning import query as tplan
from distributed_join_tpu_torch.service.programs import (
    spec_digest as tdigest,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils import tpch as ttpch
from distributed_join_tpu_torch.utils import tpch_host as thost

SF = 0.004


def _frame(df) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def _to_port(jtables: dict) -> dict:
    return {name: Table.from_numpy(
        {c: np.asarray(v) for c, v in t.columns.items()},
        np.asarray(t.valid), device="cpu") for name, t in jtables.items()}


@pytest.fixture(scope="module")
def queries():
    """Per query: the filtered tables (JAX and port), JAX's
    ``distributed_query`` groups on its 8-device mesh and its pandas
    oracle (module-scoped: JAX compiles each plan once)."""
    base = jtpch.generate_tpch_query_tables(seed=7, scale_factor=SF)
    comm = jcomm.make_communicator("tpu", n_ranks=8)
    out = {}
    for q in jplan.TPCH_QUERIES:
        tables = jtpch.query_filters(base, q)
        plan = jplan.tpch_query_plan(q)
        res = jq.distributed_query(tables, plan, comm, auto_retry=4)
        spec = plan.aggregate
        out[q] = dict(
            jtables=tables, tables=_to_port(tables),
            want=_frame(ja.groups_frame(res.table, spec,
                                        list(spec.group_keys))),
            oracle=_frame(jhost.query_oracle(
                plan, {k: t.to_pandas() for k, t in tables.items()})),
            op_totals=[int(t) for t in res.op_totals],
            overflow=bool(res.overflow), attempts=res.retry_attempts)
    return out


def _run(tables, q, comm, **opts):
    plan = tplan.tpch_query_plan(q)
    res = tq.distributed_query(tables, plan, comm, auto_retry=4, **opts)
    spec = plan.aggregate
    return res, ta.groups_frame(res.table, spec, list(spec.group_keys))


@pytest.mark.parametrize("q", ["q3", "q10"])
@pytest.mark.parametrize("ranks,opts", [
    (1, {}), (4, {}), (8, {}), (4, {"over_decomposition": 2}),
    (4, {"shuffle": "ragged"})], ids=["1", "4", "8", "4-k2", "4-ragged"])
def test_query_equals_jax_and_its_oracle(queries, q, ranks, opts):
    c = queries[q]
    comm = LocalCommunicator() if ranks == 1 else EmulatedCommunicator(ranks)
    res, got = _run(c["tables"], q, comm, **opts)
    assert not bool(res.overflow) and not c["overflow"]
    assert len(got[next(iter(got))]) > 0
    assert ta.frames_equal(got, c["want"])
    assert ta.frames_equal(got, c["oracle"])
    assert [int(t) for t in res.op_totals] == c["op_totals"]
    assert res.plan_digest == tplan.tpch_query_plan(q).digest()
    if ranks == 8 and not opts:
        assert res.retry_attempts == c["attempts"]


@pytest.mark.parametrize("q", ["q3", "q10"])
def test_query_on_an_emulated_hierarchy_equals_jax(queries, q):
    """2 slices x 2 ranks: every shuffle, and Q10's partials exchange,
    take the two-hop route."""
    c = queries[q]
    res, got = _run(c["tables"], q, EmulatedCommunicator(4, n_slices=2),
                    shuffle="hierarchical", dcn_codec="off")
    assert not bool(res.overflow)
    assert ta.frames_equal(got, c["want"])


@pytest.mark.parametrize("q", ["q3", "q10"])
def test_numpy_query_oracle_equals_pandas(queries, q):
    c = queries[q]
    plan = tplan.tpch_query_plan(q)
    got = thost.query_oracle(plan, {k: t.to_host()
                                    for k, t in c["tables"].items()})
    assert list(got) == list(c["oracle"])
    assert ta.frames_equal(got, c["oracle"])


@pytest.mark.parametrize("join_type", ["inner", "left", "right",
                                       "full_outer", "semi", "anti"])
@pytest.mark.parametrize("composite", [False, True], ids=["key", "k1k2"])
def test_merge_oracle_equals_pandas(join_type, composite):
    import pandas as pd
    rng = np.random.default_rng(4)
    nb, npr = 60, 90
    build = {"k": rng.integers(0, 30, nb), "k2": rng.integers(0, 2, nb),
             "bv": rng.integers(0, 100, nb).astype(np.int32)}
    probe = {"k": rng.integers(0, 40, npr), "k2": rng.integers(0, 2, npr),
             "pv": rng.random(npr)}
    keys = ["k", "k2"] if composite else ["k"]
    if not composite:
        del build["k2"], probe["k2"]
    want = _frame(jhost._merge_oracle(pd.DataFrame(probe),
                                      pd.DataFrame(build), keys, join_type))
    got = thost._merge_oracle(probe, build, keys, join_type)
    assert sorted(got) == sorted(want)
    names = sorted(want)

    def rows(f):
        a = np.stack([np.asarray(f[n], np.float64) for n in names], 1)
        return a[np.lexsort(a.T[::-1])]

    np.testing.assert_array_equal(rows(got), rows(want))
    for n in names:
        assert got[n].dtype.kind == want[n].dtype.kind, n


# -- plans -------------------------------------------------------------------


WIRE_PLAN = {
    "tables": ["c", "o", "l"],
    "ops": [
        {"id": "j1", "build": "c", "probe": "o", "key": "custkey",
         "join_type": "left",
         "options": {"over_decomposition": 2, "shuffle": "ragged",
                     "out_capacity_factor": 2.5}},
        {"id": "j2", "build": "j1", "probe": "l", "key": ["orderkey"],
         "options": {"shuffle_capacity_factor": 3.0},
         "aggregate": {"group_by": ["orderkey"],
                       "aggs": [["sum", "l_extendedprice"], ["count"],
                                ["mean", "l_extendedprice", "avg"]],
                       "carry": ["o_orderdate"], "groups_per_rank": 64}},
    ],
}


@pytest.mark.parametrize("which", ["q3", "q10", "wire"])
def test_plan_digest_equals_jax(which):
    if which == "wire":
        jp = jplan.QueryPlan.from_wire(WIRE_PLAN)
        tp = tplan.QueryPlan.from_wire(WIRE_PLAN)
    else:
        jp, tp = jplan.tpch_query_plan(which), tplan.tpch_query_plan(which)
    assert tp.canonical() == jp.canonical()
    assert tp.digest() == jp.digest()
    assert tp.n_operators() == jp.n_operators() and tp.output == jp.output
    assert tp.tables == jp.tables
    assert tp.aggregate.as_record() == jp.aggregate.as_record()
    # the canonical record round-trips to the same digest
    assert tplan.QueryPlan.from_wire(tp.canonical()).digest() == tp.digest()


def test_spec_digest_equals_jax():
    for doc in ({"a": [1, 2.5, None, True], "b": {"z": "s", "y": (3,)}},
                [], "x", {"nested": [{"k": 1}, {"k": 2}]}):
        assert tdigest(doc) == jdigest(doc)


def _join(op_id="j1", build="b", probe="p", key="k", **kw):
    return {"op": "join", "id": op_id, "build": build, "probe": probe,
            "key": key, **kw}


def _agg(mod, op_id, inp, spec=None):
    return {"op": "aggregate", "id": op_id, "input": inp,
            "spec": spec or mod.AggregateSpec.of("k", [("count", None)])}


def _plans(mod):
    """JAX test_query.py's refused plans, each built with ``mod``'s
    AggregateSpec."""
    return [
        [],
        [_join(key=[])],
        [_join(join_type="cross")],
        [_join(options={"skew": 1})],
        [_join(), _join()],
        [_agg(mod, "a", "j")],
        [{"op": "scan", "id": "s"}],
        [{"op": "join"}],
        ["not a mapping"],
        [_join("j1"), _join("j2", build="j1", probe="q"),
         _agg(mod, "a", "j1")],
        [_join("j1"), _agg(mod, "a1", "j1"), _agg(mod, "a2", "j1")],
        [_join("j1", build="j2", probe="p"),
         _join("j2", build="b", probe="q")],
        [_join(build="t", probe="t")],
        [_join("j1"), _join("j2", build="j1", probe="q"),
         _join("j3", build="j1", probe="r")],
        [_join("j1"), _join("j2", build="x", probe="y")],
        [_join(), {"op": "aggregate", "id": "a", "input": "j1"}],
    ]


@pytest.mark.parametrize("i", range(len(_plans(ta))))
def test_plan_refusals_equal_jax(i):
    msgs = []
    for mod, agg in ((jplan, ja), (tplan, ta)):
        with pytest.raises(ValueError) as exc:
            mod.QueryPlan.of(_plans(agg)[i])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("query plan unsupported: ")


def test_declared_tables_and_schemas_equal_jax():
    i64 = ("int64", ())
    schemas = {"b": {"k": i64, "v": i64}, "p": {"k": i64, "v": i64},
               "q": {"k": ("int32", ()), "w": i64}}
    for ops, tables, call in (
            ([_join()], ["b", "x"], None),
            ([_join()], None, lambda p: p.infer_schemas(schemas)),
            ([_join(probe="q")], None, lambda p: p.infer_schemas(schemas)),
            ([_join(key="z")], None, lambda p: p.infer_schemas(schemas)),
            ([_join()], None, lambda p: p.infer_schemas({"b": {"k": i64}}))):
        msgs = []
        for mod in (jplan, tplan):
            with pytest.raises(ValueError) as exc:
                plan = mod.QueryPlan.of(ops, tables=tables)
                call(plan)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    # semi/anti emit probe columns only; a fused aggregate's schema
    for mod in (jplan, tplan):
        semi = mod.QueryPlan.of([_join(join_type="semi")])
        assert set(semi.infer_schemas(schemas)["j1"]) == {"k", "v"}
    schemas = {"b": {"k": i64, "bv": ("int32", ())},
               "p": {"k": i64, "pv": ("float32", ())}}
    outs = []
    for mod, agg in ((jplan, ja), (tplan, ta)):
        plan = mod.QueryPlan.of([_join(join_type="full_outer"), _agg(
            agg, "a", "j1", agg.AggregateSpec.of(
                "k", [("count", None), ("sum", "pv"), ("min", "bv"),
                      ("mean", "pv")], carry=("bv",)))])
        outs.append(plan.infer_schemas(schemas))
    assert outs[0] == outs[1]
    # the fused aggregate is mode-checked at plan time, in the same words
    msgs = []
    for mod, agg in ((jplan, ja), (tplan, ta)):
        bad = mod.QueryPlan.of([_join(), _agg(
            agg, "a", "j1", agg.AggregateSpec.of("nope", [("count", None)]))])
        with pytest.raises(agg.AggregatePushdownUnsupported) as exc:
            bad.infer_schemas(schemas)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_unported_query_options_refuse_by_name(queries):
    """The metrics and explain surfaces are ported (one block an operator,
    and the queryplan record); what the query layer refuses, it refuses
    as the JAX package does."""
    c = queries["q3"]
    plan = tplan.tpch_query_plan("q3")
    res = tq.distributed_query(c["tables"], plan, LocalCommunicator(),
                               with_metrics=True)
    assert len(res.telemetry) == len(plan.ops)
    for op_total, m in zip(res.op_totals, res.telemetry):
        assert m.to_dict()["reduced"]["matches"] == int(op_total)
    # the program cache is ported: a cache of another communicator
    # refuses, as the JAX package's does
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    with pytest.raises(ValueError, match="different communicator"):
        tq.distributed_query(c["tables"], plan, LocalCommunicator(),
                             program_cache=JoinProgramCache(
                                 LocalCommunicator()))
    doc = tplan.explain_query(plan, LocalCommunicator(), c["tables"])
    assert doc["kind"] == "queryplan" and doc["digest"] == plan.digest()
    assert [o["id"] for o in doc["operators"]] == [op.op_id
                                                   for op in plan.ops]
    # the skew sidecar refuses on the fused operator, as in the JAX package
    with pytest.raises(ValueError):
        tq.distributed_query(c["tables"], plan, LocalCommunicator(),
                             skew_threshold=8)
    with pytest.raises(ValueError, match="not supplied"):
        tq.distributed_query({"customer": c["tables"]["customer"]}, plan,
                             LocalCommunicator())


def test_unknown_tpch_query_refuses_like_jax():
    for mod in (jplan, tplan):
        with pytest.raises(ValueError, match="unknown TPC-H query"):
            mod.tpch_query_plan("q5")
    for fn in (jtpch.query_filters, ttpch.query_filters):
        with pytest.raises(ValueError, match="unknown query"):
            fn({"customer": None, "orders": None, "lineitem": None}, "q5")


# -- the query tables ----------------------------------------------------------


def test_query_tables_have_jax_structure():
    """The port's generator draws from ``torch.Generator``, so only the
    structure is compared: constants, row counts, schemas, key ranges,
    the dense customer keys and the filters' predicates."""
    for name in ("CUSTOMERS_PER_SF", "N_MKT_SEGMENTS", "ORDERS_PER_SF",
                 "DATE_RANGE_DAYS"):
        assert getattr(ttpch, name) == getattr(jtpch, name)
    got = ttpch.generate_tpch_query_tables(3, 0.01, device="cpu")
    want = jtpch.generate_tpch_query_tables(3, 0.01)
    for name in ("customer", "orders", "lineitem"):
        assert ta.table_schema(got[name]) == ja.table_schema(want[name])
    assert got["customer"].capacity == want["customer"].capacity == 1500
    assert got["orders"].capacity == want["orders"].capacity
    c, o = got["customer"].columns, got["orders"].columns
    np.testing.assert_array_equal(c["custkey"].numpy(),
                                  np.arange(1, 1501))
    for col, lo, hi in ((c["c_mktsegment"], 0, 4),
                        (c["c_acctbal"], -99_999, 999_999),
                        (c["c_nationkey"], 0, 24),
                        (o["custkey"], 1, 1500)):
        assert int(col.min()) >= lo and int(col.max()) <= hi
    for q in ("q3", "q10"):
        f = ttpch.query_filters(got, q)
        fc, fo, fl = (f[n].valid.numpy() for n in ("customer", "orders",
                                                   "lineitem"))
        seg = c["c_mktsegment"].numpy()
        date = o["o_orderdate"].numpy()
        ship = got["lineitem"].columns["l_shipdate"].numpy()
        cut = ttpch.DATE_RANGE_DAYS // 2
        if q == "q3":
            np.testing.assert_array_equal(fc, seg == 1)
            np.testing.assert_array_equal(fo, date < cut)
            np.testing.assert_array_equal(fl, ship > cut)
        else:
            assert fc.all() and fl.all()
            np.testing.assert_array_equal(fo, (date >= cut)
                                          & (date < cut + 90))
