"""The port's fused join+aggregate (ops/aggregate.py and
make_join_step(aggregate=)) against the JAX package's, on the CPU.

The same numpy-made tables go through both packages. Held against the
reference: the spec layer (modes, lane schemas, wire columns, capacities,
every refusal's message), ``local_join_aggregate`` in key, probe and
build modes (duplicate-heavy builds, composite keys, every op and
carries), the distributed step on 1, 4 and 8 emulated ranks, at
over-decomposition 2, on the ragged wire and on an emulated 2 x 2
hierarchy, the ladder's retry trail, and the numpy oracles against the
JAX package's pandas ones. Integer lanes compare exactly; float lanes
(sums and means) within numpy.allclose's rtol 1e-5, atol 1e-8, because
the port sums floats by run id where the reference scans; rows compare
over the valid prefix only (slots past the groups total are undefined
in the port).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import aggregate as ja
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import aggregate as ta
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.table import Table

GROUPS_CAP = 1024


def _tables(seed, nb, npr, kmax, gmax, valid_frac=0.9):
    """Build and probe sides with duplicate keys on both, a build-side
    and a probe-side group column with carries functionally dependent
    on them, int64, int32 and float columns, some invalid rows."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, kmax, nb).astype(np.int64)
    pk = rng.integers(0, kmax, npr).astype(np.int64)
    bg = rng.integers(0, gmax, nb).astype(np.int64)
    pg = (pk % 7).astype(np.int32)
    build = {"key": bk, "bgroup": bg, "bcarry": bg * 10 + 3,
             "b_val": rng.integers(-500, 1000, nb).astype(np.int64),
             "b_small": rng.integers(0, 100, nb).astype(np.int32),
             "b_f": rng.random(nb)}
    probe = {"key": pk, "grp": pg, "grp_tag": pg * 11,
             "p_val": rng.integers(-500, 1000, npr).astype(np.int64),
             "p_f": rng.random(npr).astype(np.float32)}
    return ((build, rng.random(nb) < valid_frac),
            (probe, rng.random(npr) < valid_frac))


def _jt(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _tt(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _jframe(df) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


AGGS = {
    "key": [("count", None), ("sum", "p_val"), ("sum", "b_val"),
            ("sum", "b_small"), ("min", "p_val"), ("max", "b_val"),
            ("min", "b_small"), ("mean", "p_val"), ("sum", "b_f"),
            ("max", "p_f"), ("mean", "b_f")],
    "probe": [("count", None), ("sum", "p_val"), ("sum", "b_val"),
              ("min", "b_val"), ("max", "p_val"), ("mean", "b_val"),
              ("sum", "b_f"), ("min", "p_f")],
    "build": [("count", None), ("sum", "p_val"), ("sum", "b_val"),
              ("min", "p_val"), ("max", "b_val"), ("mean", "p_val"),
              ("sum", "p_f"), ("max", "b_f")],
}
GROUP_BY = {"key": "key", "probe": "grp", "build": "bgroup"}
CARRY = {"key": ("grp_tag", "bcarry"), "probe": ("grp_tag",),
         "build": ("bcarry",)}


def _specs(mode):
    args = (GROUP_BY[mode], AGGS[mode])
    return (ja.AggregateSpec.of(*args, carry=CARRY[mode]),
            ta.AggregateSpec.of(*args, carry=CARRY[mode]))


@pytest.fixture(scope="module")
def local_cases():
    """Module-scoped: JAX compiles each (shape, spec) once. Two table
    pairs: mixed duplicates, and a duplicate-heavy one (32 hot keys
    under 4 build groups)."""
    out = {}
    for name, args in (("mixed", (3, 300, 700, 100, 5)),
                       ("dup_heavy", (8, 64, 2048, 32, 4))):
        (bc, bv), (pc, pv) = _tables(*args)
        for mode in ("key", "probe", "build"):
            js, tsp = _specs(mode)
            jb, jp = _jt(bc, bv), _jt(pc, pv)
            jpart, jtotal, jg, jovf = ja.local_join_aggregate(
                jb, jp, ["key"], js, mode, GROUPS_CAP)
            gn = ["key"] if mode == "key" else list(js.group_keys)
            want = _jframe(ja.groups_frame(
                ja.finalize_groups(jpart, js, gn), js, gn))
            out[(name, mode)] = dict(
                tables=(bc, bv, pc, pv), spec=tsp, group_names=gn,
                want=want, total=int(jtotal), groups=int(jg),
                overflow=bool(jovf),
                oracle=_jframe(ja.aggregate_oracle(jb, jp, "key", js)))
    return out


@pytest.mark.parametrize("mode", ["key", "probe", "build"])
@pytest.mark.parametrize("case", ["mixed", "dup_heavy"])
def test_local_join_aggregate_equals_jax(local_cases, case, mode):
    c = local_cases[(case, mode)]
    bc, bv, pc, pv = c["tables"]
    tb, tp = _tt(bc, bv), _tt(pc, pv)
    spec, gn = c["spec"], c["group_names"]
    assert ta.resolve_agg_mode(spec, ["key"], ta.table_schema(tb),
                               ta.table_schema(tp)) == mode
    part, total, groups, overflow = ta.local_join_aggregate(
        tb, tp, ["key"], spec, mode, GROUPS_CAP)
    assert (int(total), int(groups), bool(overflow)) == (
        c["total"], c["groups"], c["overflow"])
    got = ta.groups_frame(ta.finalize_groups(part, spec, gn), spec, gn)
    assert list(got) == list(c["want"])
    assert ta.frames_equal(got, c["want"])
    # the numpy oracle: equal to the JAX package's pandas oracle and to
    # the pushdown
    oracle = ta.aggregate_oracle(tb, tp, "key", spec)
    assert ta.frames_equal(oracle, c["oracle"])
    assert ta.frames_equal(got, oracle)
    # integer sums widen to int64 (pandas keeps an int32 column's
    # dtype); every column keeps its kind
    for col in oracle:
        assert oracle[col].dtype.kind == c["oracle"][col].dtype.kind, col


def test_local_groups_overflow_keeps_the_first_groups():
    """A groups block smaller than the groups: the flag rises, the
    total counts every group, and the block holds the first groups in
    key order, as the reference's compaction keeps them."""
    (bc, bv), (pc, pv) = _tables(3, 300, 700, 100, 5)
    js, tsp = _specs("key")
    jpart, _, jg, jovf = ja.local_join_aggregate(
        _jt(bc, bv), _jt(pc, pv), ["key"], js, "key", 16)
    part, _, g, ovf = ta.local_join_aggregate(
        _tt(bc, bv), _tt(pc, pv), ["key"], tsp, "key", 16)
    assert bool(ovf) and bool(jovf) and int(g) == int(jg) > 16
    want = _jframe(ja.groups_frame(
        ja.finalize_groups(jpart, js, ["key"]), js, ["key"]))
    got = ta.groups_frame(ta.finalize_groups(part, tsp, ["key"]), tsp,
                          ["key"])
    assert len(got["key"]) == 16 and ta.frames_equal(got, want)


def test_composite_key_mode_equals_jax():
    rng = np.random.default_rng(5)
    n = 400
    cols = {"k1": rng.integers(0, 12, n).astype(np.int64),
            "k2": rng.integers(0, 9, n).astype(np.int32)}
    bc = dict(cols, b_val=rng.integers(0, 50, n).astype(np.int64))
    pc = {"k1": rng.integers(0, 12, n).astype(np.int64),
          "k2": rng.integers(0, 9, n).astype(np.int32),
          "p_val": rng.integers(0, 50, n).astype(np.int64)}
    v = np.ones(n, bool)
    aggs = [("count", None), ("sum", "p_val"), ("max", "b_val")]
    js = ja.AggregateSpec.of(["k1", "k2"], aggs)
    tsp = ta.AggregateSpec.of(["k1", "k2"], aggs)
    jpart, jt_, _, _ = ja.local_join_aggregate(
        _jt(bc, v), _jt(pc, v), ["k1", "k2"], js, "key", GROUPS_CAP)
    part, tt_, _, _ = ta.local_join_aggregate(
        _tt(bc, v), _tt(pc, v), ["k1", "k2"], tsp, "key", GROUPS_CAP)
    want = _jframe(ja.groups_frame(ja.finalize_groups(
        jpart, js, ["k1", "k2"]), js, ["k1", "k2"]))
    got = ta.groups_frame(ta.finalize_groups(part, tsp, ["k1", "k2"]),
                          tsp, ["k1", "k2"])
    assert int(tt_) == int(jt_) and ta.frames_equal(got, want)


def test_float32_sums_over_large_groups_hold_the_tolerance():
    """Two probe-side groups of about 10^6 float32 rows each: the run
    sums and means equal the reference's within rtol 1e-5 and lie
    within 1e-6 (relative) of the exact float64 sums, so the error does
    not grow with the group's size."""
    rng = np.random.default_rng(11)
    nb, npr = 64, 1 << 21
    bc = {"key": np.arange(nb, dtype=np.int64)}
    pk = rng.integers(0, nb, npr).astype(np.int64)
    pc = {"key": pk, "grp": (pk % 2).astype(np.int32),
          "p_f": rng.random(npr).astype(np.float32)}
    bv, pv = np.ones(nb, bool), np.ones(npr, bool)
    aggs = [("count", None), ("sum", "p_f"), ("mean", "p_f")]
    js = ja.AggregateSpec.of("grp", aggs)
    tsp = ta.AggregateSpec.of("grp", aggs)
    jpart, _, _, _ = ja.local_join_aggregate(
        _jt(bc, bv), _jt(pc, pv), ["key"], js, "probe", 8)
    part, _, groups, ovf = ta.local_join_aggregate(
        _tt(bc, bv), _tt(pc, pv), ["key"], tsp, "probe", 8)
    assert int(groups) == 2 and not bool(ovf)
    want = _jframe(ja.groups_frame(ja.finalize_groups(jpart, js, ["grp"]),
                                   js, ["grp"]))
    got = ta.groups_frame(ta.finalize_groups(part, tsp, ["grp"]), tsp,
                          ["grp"])
    assert ta.frames_equal(got, want)
    exact = np.array([pc["p_f"][pc["grp"] == g].astype(np.float64).sum()
                      for g in (0, 1)])
    assert got["count"].min() > 10 ** 6 - 10 ** 4
    np.testing.assert_allclose(got["sum_p_f"].astype(np.float64), exact,
                               rtol=1e-6)


# -- the spec layer ---------------------------------------------------------


SCHEMA_B = {"key": ("int64", 1), "b_val": ("int64", 1),
            "bgroup": ("int64", 1), "bf": ("float64", 1),
            "bstr": ("uint8", 2), "dup": ("int64", 1)}
SCHEMA_P = {"key": ("int64", 1), "p_val": ("int32", 1),
            "grp": ("int32", 1), "pf": ("float32", 1),
            "dup": ("int64", 1)}

REFUSED_SPECS = [
    ((), [("count", None)], ()),
    ("key", [], ()),
    (["grp", "grp"], [("count", None)], ()),
    ("key", [("count", None, "key")], ()),
    ("key", [("count", None, "__x")], ()),
    ("key", [("count", None, "a#b")], ()),
    ("key", [("median", "p_val")], ()),
    ("key", [("count", "p_val")], ()),
    ("key", [("sum", None)], ()),
    ("key", [("sum", "key")], ()),
    ("key", [("sum", "dup")], ()),
    ("key", [("sum", "nope")], ()),
    ("key", [("sum", "bstr")], ()),
    ("key", [("count", None)], ("nope",)),
    ("pf", [("count", None)], ()),
    ("bstr", [("count", None)], ()),
    ("nope", [("count", None)], ()),
    ("dup", [("count", None)], ()),
    (["grp", "bgroup"], [("count", None)], ()),
    ("grp", [("count", None)], ("b_val",)),
    ("bgroup", [("count", None)], ("p_val",)),
]


@pytest.mark.parametrize("group_by,aggs,carry", REFUSED_SPECS)
def test_every_mode_refusal_names_jax_reason(group_by, aggs, carry):
    results = []
    for mod in (ja, ta):
        spec = mod.AggregateSpec.of(group_by, aggs, carry=carry)
        with pytest.raises(mod.AggregatePushdownUnsupported) as exc:
            mod.resolve_agg_mode(spec, ["key"], SCHEMA_B, SCHEMA_P)
        results.append(str(exc.value))
    assert results[0] == results[1]
    assert results[0].startswith("aggregate pushdown unsupported: ")


@pytest.mark.parametrize("group_by,aggs,carry", [
    ("key", [("count", None), ("sum", "p_val"), ("sum", "b_val"),
             ("min", "pf"), ("mean", "bf"), ("max", "p_val")],
     ("grp", "bgroup")),
    ("grp", [("count", None), ("mean", "bf"), ("min", "p_val")],
     ("pf",)),
    ("bgroup", [("sum", "p_val"), ("max", "bf"), ("mean", "pf")],
     ("b_val",)),
    (["grp", "key"], [("count", None)], ()),
])
def test_spec_layer_equals_jax(group_by, aggs, carry):
    js = ja.AggregateSpec.of(group_by, aggs, carry=carry,
                             groups_per_rank=20)
    tsp = ta.AggregateSpec.of(group_by, aggs, carry=carry,
                              groups_per_rank=20)
    assert tsp.as_record() == js.as_record()
    assert ta.AggregateSpec.from_wire(js.as_record() | {
        "group_by": js.as_record()["group_keys"]}) == tsp
    b = {k: v for k, v in SCHEMA_B.items() if k != "dup"}
    p = {k: v for k, v in SCHEMA_P.items() if k != "dup"}
    mode = ja.resolve_agg_mode(js, ["key"], b, p)
    assert ta.resolve_agg_mode(tsp, ["key"], b, p) == mode
    assert (ta.partial_lane_schema(tsp, b, p)
            == ja.partial_lane_schema(js, b, p))
    assert (ta.wire_columns(tsp, mode, ["key"], b, p)
            == ja.wire_columns(js, mode, ["key"], b, p))
    assert (ta.partial_columns(tsp, mode, ["key"], b, p)
            == ja.partial_columns(js, mode, ["key"], b, p))
    for cap in (1, 7, 8, 1000):
        assert (ta.resolve_groups_capacity(tsp, cap)
                == ja.resolve_groups_capacity(js, cap))
    spec0 = ta.AggregateSpec.of(group_by, aggs, carry=carry)
    assert ta.resolve_groups_capacity(spec0, 1001) == 1008


def test_table_schema_spells_dtypes_as_jax():
    (bc, bv), (pc, pv) = _tables(1, 16, 16, 8, 2)
    assert (ta.table_schema(_tt(bc, bv))
            == ja.table_schema(_jt(bc, bv)))
    assert (ta.table_schema(_tt(pc, pv))
            == ja.table_schema(_jt(pc, pv)))


# -- the distributed step ---------------------------------------------------


STEP_AGGS = {
    "key": [("count", None), ("sum", "p_val"), ("min", "b_val"),
            ("mean", "p_val")],
    "probe": [("count", None), ("sum", "b_val"), ("max", "p_val"),
              ("mean", "b_val")],
    "build": [("count", None), ("sum", "p_val"), ("min", "p_val"),
              ("mean", "p_val")],
}


@pytest.fixture(scope="module")
def step_cases():
    """The JAX package's distributed pushdown on its 8-device mesh, one
    run a mode (module-scoped: one compile each), with its retry
    trail."""
    (bc, bv), (pc, pv) = _tables(11, 800, 2400, 256, 8)
    comm = jcomm.make_communicator("tpu", n_ranks=8)
    out = {}
    for mode in ("key", "probe", "build"):
        carry = CARRY[mode][:1]
        js = ja.AggregateSpec.of(GROUP_BY[mode], STEP_AGGS[mode],
                                 carry=carry)
        res = jdist.distributed_inner_join(
            _jt(bc, bv), _jt(pc, pv), comm, key="key", aggregate=js,
            auto_retry=4)
        gn = ["key"] if mode == "key" else [GROUP_BY[mode]]
        out[mode] = dict(
            spec=ta.AggregateSpec.of(GROUP_BY[mode], STEP_AGGS[mode],
                                     carry=carry),
            group_names=gn, total=int(res.total),
            overflow=bool(res.overflow),
            attempts=res.retry_report.n_attempts,
            want=_jframe(ja.groups_frame(res.table, js, gn)))
    return (bc, bv, pc, pv), out


@pytest.mark.parametrize("mode", ["key", "probe", "build"])
@pytest.mark.parametrize("ranks,opts", [
    (1, {}), (4, {}), (8, {}), (4, {"over_decomposition": 2}),
    (4, {"shuffle": "ragged"}), (8, {"shuffle": "ppermute"})],
    ids=["1", "4", "8", "4-k2", "4-ragged", "8-ppermute"])
def test_step_equals_jax(step_cases, mode, ranks, opts):
    (bc, bv, pc, pv), cases = step_cases
    c = cases[mode]
    comm = LocalCommunicator() if ranks == 1 else EmulatedCommunicator(ranks)
    res = tdist.distributed_inner_join(
        _tt(bc, bv), _tt(pc, pv), comm, key="key", aggregate=c["spec"],
        auto_retry=4, **opts)
    assert not bool(res.overflow) and not c["overflow"]
    assert int(res.total) == c["total"]
    got = ta.groups_frame(res.table, c["spec"], c["group_names"])
    assert ta.frames_equal(got, c["want"])
    if ranks == 8 and not opts:
        # the same ladder: the derived groups block and the partials
        # exchange overflow on the same rungs
        assert res.retry_report.n_attempts == c["attempts"]


def test_hierarchical_partials_exchange_equals_jax(step_cases):
    """2 slices x 2 emulated ranks: the shuffles and the probe-mode
    partials exchange take the two-hop route."""
    (bc, bv, pc, pv), cases = step_cases
    for mode in ("probe", "key"):
        c = cases[mode]
        comm = EmulatedCommunicator(4, n_slices=2)
        res = tdist.distributed_inner_join(
            _tt(bc, bv), _tt(pc, pv), comm, key="key",
            aggregate=c["spec"], auto_retry=4, shuffle="hierarchical",
            dcn_codec="off")
        assert not bool(res.overflow) and int(res.total) == c["total"]
        got = ta.groups_frame(res.table, c["spec"], c["group_names"])
        assert ta.frames_equal(got, c["want"])


def test_ladder_grows_the_derived_groups_block_like_jax():
    (bc, bv), (pc, pv) = _tables(7, 512, 1024, 128, 4)
    aggs = [("count", None), ("sum", "p_val")]
    js = ja.AggregateSpec.of("key", aggs)
    tsp = ta.AggregateSpec.of("key", aggs)
    want = jdist.distributed_inner_join(
        _jt(bc, bv), _jt(pc, pv), jcomm.make_communicator("tpu", n_ranks=4),
        key="key", aggregate=js, auto_retry=6, out_capacity_factor=0.02)
    got = tdist.distributed_inner_join(
        _tt(bc, bv), _tt(pc, pv), EmulatedCommunicator(4), key="key",
        aggregate=tsp, auto_retry=6, out_capacity_factor=0.02)
    fields = ("attempt", "action", "overflow", "out_capacity_factor")
    trail = [[{f: getattr(a, f) for f in fields}
              for a in r.retry_report.attempts] for r in (got, want)]
    assert len(trail[0]) > 1 and trail[0] == trail[1]
    assert not bool(got.overflow)
    assert ta.frames_equal(
        ta.groups_frame(got.table, tsp, ["key"]),
        _jframe(ja.groups_frame(want.table, js, ["key"])))


def test_explicit_groups_overflow_is_loud():
    (bc, bv), (pc, pv) = _tables(7, 512, 1024, 128, 4)
    spec = ta.AggregateSpec.of("key", [("count", None)], groups_per_rank=8)
    res = tdist.distributed_inner_join(
        _tt(bc, bv), _tt(pc, pv), EmulatedCommunicator(4), key="key",
        aggregate=spec, auto_retry=1)
    assert bool(res.overflow)


# -- the step's refusals ----------------------------------------------------


def _refusal(mod, make_table, comm, exc_type, **opts):
    (bc, bv), (pc, pv) = _tables(1, 64, 64, 16, 2)
    with pytest.raises(exc_type) as exc:
        mod.distributed_inner_join(make_table(bc, bv), make_table(pc, pv),
                                   comm, key="key", **opts)
    return str(exc.value)


SPEC_OPTS = [
    dict(skew_threshold=0.001),
    dict(build_payload=["b_val"]),
    dict(kernel_config="plain"),
    dict(sort_mode="segmented"),
]


@pytest.mark.parametrize("opts", SPEC_OPTS,
                         ids=["skew", "payloads", "kernel_config",
                              "segmented"])
def test_step_refusals_name_jax_reasons(opts):
    jspec = ja.AggregateSpec.of("key", [("count", None)])
    tspec = ta.AggregateSpec.of("key", [("count", None)])
    jc = jcomm.make_communicator("local")
    want = _refusal(jdist, _jt, jc, ja.AggregatePushdownUnsupported,
                    aggregate=jspec, **opts)
    got = _refusal(tdist, _tt, LocalCommunicator(),
                   ta.AggregatePushdownUnsupported, aggregate=tspec, **opts)
    assert got == want


@pytest.mark.parametrize("opts,exc", [
    (dict(aggregate=object()), TypeError),
    (dict(join_type="left"), ValueError),
    (dict(join_type="semi"), ValueError),
])
def test_step_type_refusals_equal_jax(opts, exc):
    jc = jcomm.make_communicator("local")
    want = _refusal(jdist, _jt, jc, exc, **dict(
        {"aggregate": ja.AggregateSpec.of("key", [("count", None)])},
        **opts))
    got = _refusal(tdist, _tt, LocalCommunicator(), exc, **dict(
        {"aggregate": ta.AggregateSpec.of("key", [("count", None)])},
        **opts))
    assert got == want


def test_string_key_refused_like_jax():
    from distributed_join_tpu.utils.strings import encode_strings
    jb, jl = encode_strings(["aa", "bb", "cc", "dd"] * 2, max_len=8)
    msgs = []
    for mod, agg, mk in (
            (jdist, ja, lambda c: JTable.from_dense(c)),
            (tdist, ta, lambda c: Table.from_numpy(
                {k: np.asarray(v) for k, v in c.items()}, np.ones(8, bool),
                device="cpu"))):
        b = mk({"skey": jb, "skey#len": jl,
                "v": np.arange(8, dtype=np.int64)})
        p = mk({"skey": jb, "skey#len": jl,
                "w": np.arange(8, dtype=np.int64)})
        comm = (jcomm.make_communicator("local") if mod is jdist
                else LocalCommunicator())
        with pytest.raises(agg.AggregatePushdownUnsupported) as exc:
            mod.distributed_inner_join(
                b, p, comm, key="skey",
                aggregate=agg.AggregateSpec.of("skey", [("count", None)]))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "2-D" in msgs[0]


# -- the host oracles -------------------------------------------------------


def test_group_reduce_frame_equals_pandas():
    import pandas as pd
    rng = np.random.default_rng(2)
    n = 500
    joined = {"g1": rng.integers(0, 6, n).astype(np.int32),
              "g2": rng.integers(0, 4, n).astype(np.int64),
              "x": rng.integers(-100, 100, n).astype(np.int32),
              "y": rng.random(n), "c": rng.integers(0, 3, n)}
    aggs = [("count", None), ("sum", "x"), ("sum", "y"), ("min", "x"),
            ("max", "y"), ("mean", "x"), ("mean", "y")]
    js = ja.AggregateSpec.of(["g1", "g2"], aggs, carry=("c",))
    tsp = ta.AggregateSpec.of(["g1", "g2"], aggs, carry=("c",))
    want = _jframe(ja.group_reduce_frame(pd.DataFrame(joined), js))
    got = ta.group_reduce_frame(joined, tsp)
    assert list(got) == list(want) and ta.frames_equal(got, want)
    for col in want:
        assert got[col].dtype.kind == want[col].dtype.kind, col
    # an empty join: no groups, the same columns
    empty = {k: v[:0] for k, v in joined.items()}
    got = ta.group_reduce_frame(empty, tsp)
    assert list(got) == list(want) and all(len(v) == 0
                                           for v in got.values())


def test_frames_equal_grades_like_jax():
    a = {"k": np.array([1, 2]), "s": np.array([1.0, 2.0])}
    assert ta.frames_equal(a, {"k": np.array([1, 2]),
                               "s": np.array([1.0, 2.0 + 1e-9])})
    assert not ta.frames_equal(a, {"k": np.array([1, 3]),
                                   "s": np.array([1.0, 2.0])})
    assert not ta.frames_equal(a, {"s": a["s"], "k": a["k"]})
    assert not ta.frames_equal(a, {"k": a["k"][:1], "s": a["s"][:1]})
    assert not ta.frames_equal(a, {"k": a["k"],
                                   "s": np.array([1.0, 2.1])})
