"""The port's device metrics tape (telemetry/metrics.py) on the CPU.

The JAX package cannot run its own metrics programs on this toolchain
(its ``with_metrics`` step raises shard_map's ``out_specs`` replication
error), so the port's counters are held against what the JAX package
committed and against numpy:

- the ``signature.counters`` of ``results/baselines/cpu_mesh_smoke.json``,
  ``hier_smoke.json``, ``agg_smoke.json`` and ``query_smoke.json``, each
  at its recorded configuration, the tables made by the JAX package's
  own generators (seed 42) and passed through numpy; that the inputs are
  the committed run's is shown by the JAX package's live plain join
  (``matches`` equal). The baselines were drawn with JAX's earlier
  random-bits default, which these tests set around the generators
  (``jax_threefry_partitionable=False``): the installed jax draws other
  tables from the same seed;
- a numpy oracle from the JAX package's live ``bucket_ids``: each rank's
  partition counts, the headroom under the shuffle capacity, the padded
  block's bytes and the ragged wire's rows;
- the plan's predicted wire bytes (``planning.build_plan``), equal to
  the counters on every wire whose bytes are static;
- the tape off: the step's result and its torch op sequence unchanged.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import hashing as jhash
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.utils import generators as jgen
from distributed_join_tpu.utils import tpch as jtpch
from distributed_join_tpu_torch.ops.aggregate import AggregateSpec
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import query_exec as tq
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.planning.query import tpch_query_plan
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.telemetry import baselines
from distributed_join_tpu_torch.telemetry.metrics import Metrics, MetricsTape

BASELINES = os.path.join(os.path.dirname(__file__), "..", "results",
                         "baselines")


@pytest.fixture
def committed_bits():
    """JAX's random bits as the committed baselines drew them."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _baseline(name: str) -> dict:
    with open(os.path.join(BASELINES, f"{name}.json")) as f:
        return json.load(f)


def _port(jt) -> Table:
    return Table.from_numpy({c: np.asarray(v) for c, v in jt.columns.items()},
                            np.asarray(jt.valid), device="cpu")


def _jax_tables(rows: int, **kw):
    jb, jp = jgen.generate_build_probe_tables(seed=42, build_nrows=rows,
                                              probe_nrows=rows, **kw)
    return (jb, jp), (_port(jb), _port(jp))


def _reduced(res) -> dict:
    return res.telemetry.to_dict()["reduced"]


# -- the committed signatures -------------------------------------------------


@pytest.mark.parametrize("name", ["cpu_mesh_smoke", "hier_smoke"])
def test_join_counters_equal_the_committed_signature(name, committed_bits):
    """The config driver's smokes (8000 x 8000, unique build keys,
    selectivity 0.3, 8 ranks, k = 1): the ragged wire, and the 2 x 4
    hierarchical wire with the codec on its cross-slice hop (JAX's
    ``auto`` resolved on by its TPU model: passed as ``on``)."""
    base = _baseline(name)
    cfg, want = base["config"], base["signature"]["counters"]
    (jb, jp), (tb, tp) = _jax_tables(cfg["build_table_nrows"],
                                     selectivity=cfg["selectivity"],
                                     unique_build_keys=True)
    n = cfg["n_ranks"]
    # the inputs are the committed run's: JAX's live plain join
    jres = jdist.distributed_inner_join(
        jb, jp, jcomm.make_communicator("tpu", n_ranks=n),
        with_metrics=False)
    assert int(jres.total) == want["matches"]
    if cfg["shuffle"] == "hierarchical":
        comm, opts = EmulatedCommunicator(n, n_slices=2), dict(
            shuffle="hierarchical", dcn_codec="on")
    else:
        comm, opts = EmulatedCommunicator(n), dict(shuffle=cfg["shuffle"])
    res = tdist.distributed_inner_join(tb, tp, comm, with_metrics=True,
                                       **opts)
    assert _reduced(res) == want
    sig = baselines.counter_signature(res.telemetry)
    assert sig == base["signature"]


def test_agg_counters_equal_the_committed_signature(committed_bits):
    """The aggregate pushdown smoke (16000 x 16000, duplicate build keys,
    keys below 1000, 8 ranks): a count and the sum of each side's
    payload, grouped by the key."""
    base = _baseline("agg_smoke")
    want = base["signature"]["counters"]
    (jb, jp), (tb, tp) = _jax_tables(16000, rand_max=1000)
    jres = jdist.distributed_inner_join(
        jb, jp, jcomm.make_communicator("tpu", n_ranks=8),
        with_metrics=False, out_capacity_factor=30.0)
    assert int(jres.total) == want["matches"]
    spec = AggregateSpec.of("key", [("count", None, "n_rows"),
                                    ("sum", "build_payload",
                                     "sum_build_payload"),
                                    ("sum", "probe_payload",
                                     "sum_probe_payload")])
    res = tdist.distributed_inner_join(tb, tp, EmulatedCommunicator(8),
                                       with_metrics=True, aggregate=spec,
                                       out_capacity_factor=30.0)
    red = _reduced(res)
    red.pop("retry_attempt_max")
    assert red == want


def test_query_counters_equal_the_committed_signature(committed_bits):
    """``tpch_join --query q3`` at SF 0.01 on 8 ranks: every operator's
    counters under its op id."""
    base = _baseline("query_smoke")
    want = base["signature"]["counters"]
    tables = jtpch.query_filters(
        jtpch.generate_tpch_query_tables(seed=42, scale_factor=0.01), "q3")
    port = {name: _port(t) for name, t in tables.items()}
    plan = tpch_query_plan("q3")
    res = tq.distributed_query(port, plan, EmulatedCommunicator(8),
                               with_metrics=True, over_decomposition=1,
                               shuffle_capacity_factor=1.6,
                               out_capacity_factor=1.5)
    got = {f"{op.op_id}.{k}": v
           for op, m in zip(plan.ops, res.telemetry)
           for k, v in m.to_dict()["reduced"].items()}
    assert got == want
    # the plan of each operator predicts its wire bytes exactly
    doc = tplan_query(plan, port)
    for orec, m in zip(doc["operators"], res.telemetry):
        red = m.to_dict()["reduced"]
        for side in ("build", "probe"):
            assert orec["wire"][side]["bytes_total"] == \
                red[f"{side}.wire_bytes"]


def tplan_query(plan, tables):
    from distributed_join_tpu_torch.planning.query import explain_query

    return explain_query(plan, EmulatedCommunicator(8), tables,
                         defaults=dict(over_decomposition=1,
                                       shuffle_capacity_factor=1.6,
                                       out_capacity_factor=1.5))


# -- the numpy oracle from the JAX package's live partition ------------------


def _oracle_tables(seed=11, rows_b=512, rows_p=1024):
    rng = np.random.default_rng(seed)
    cb = {"key": rng.integers(0, 700, rows_b).astype(np.int64),
          "build_payload": rng.integers(0, 9, rows_b).astype(np.int64)}
    cp = {"key": rng.integers(0, 700, rows_p).astype(np.int64),
          "probe_payload": rng.integers(0, 9, rows_p).astype(np.int32)}
    vb = rng.random(rows_b) < 0.9
    vp = np.ones(rows_p, bool)
    return (cb, vb), (cp, vp)


def _per_rank_counts(keys, valid, n, k):
    """``(n, n*k)``: each rank's valid rows a bucket, by the JAX
    package's live bucket ids."""
    ids = np.asarray(jhash.bucket_ids([jnp.asarray(keys)], n * k))
    out = np.zeros((n, n * k), np.int64)
    for r, (ir, vr) in enumerate(zip(np.split(ids, n), np.split(valid, n))):
        out[r] = np.bincount(ir[vr], minlength=n * k)
    return out


@pytest.mark.parametrize("shuffle", ["padded", "ragged", "ppermute"])
@pytest.mark.parametrize("n,k", [(4, 1), (8, 1), (4, 3)])
def test_counters_match_the_numpy_oracle(shuffle, n, k):
    (cb, vb), (cp, vp) = _oracle_tables()
    tb = Table.from_numpy(cb, vb, device="cpu")
    tp = Table.from_numpy(cp, vp, device="cpu")
    factor = 2.0
    res = tdist.distributed_inner_join(
        tb, tp, EmulatedCommunicator(n), shuffle=shuffle,
        over_decomposition=k, shuffle_capacity_factor=factor,
        out_capacity_factor=8.0, with_metrics=True)
    assert not bool(res.overflow)
    m = res.telemetry.to_dict()
    r, per_rank = m["reduced"], m["per_rank"]
    bk, pk = cb["key"][vb], cp["key"][vp]
    want = int(sum((pk == x).sum() for x in bk))
    assert r["matches"] == want == sum(per_rank["matches"])
    for side, cols, valid, row_bytes in (("build", cb, vb, 16),
                                         ("probe", cp, vp, 12)):
        counts = _per_rank_counts(cols["key"], valid, n, k)
        rows = int(valid.sum())
        cap = math.ceil(len(valid) // n / (n * k) * factor)
        cap += (-cap) % 8
        assert per_rank[f"{side}.rows_partitioned"] == list(counts.sum(1))
        assert r[f"{side}.rows_shuffled"] == r[f"{side}.rows_received"] \
            == rows
        # a rank receives the rows of its destination buckets
        dest = counts.reshape(n, k, n).sum(axis=(0, 1))
        assert per_rank[f"{side}.rows_received"] == list(dest)
        assert r[f"{side}.overflow_margin_min"] == cap - int(counts.max())
        if shuffle == "ragged":
            assert r[f"{side}.wire_bytes"] == rows * row_bytes
        else:
            assert r[f"{side}.wire_bytes"] == n * k * n * cap * row_bytes
    assert r["retry_attempt_max"] == 0


# -- the plan against the tape --------------------------------------------------


WIRES = [
    dict(n=4, shuffle="padded"),
    dict(n=4, shuffle="ppermute", over_decomposition=2),
    dict(n=4, shuffle="padded", compression_bits=16),
    dict(n=4, shuffle="ppermute", compression_bits=32),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="off"),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="on"),
    dict(n=8, slices=2, shuffle="hierarchical", dcn_codec="auto",
         over_decomposition=2),
    dict(n=4, sort_mode="segmented", sort_segments=4),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="off",
         sort_mode="segmented", sort_segments=2),
    dict(n=4, shuffle="ragged"),
    dict(n=4, agg="probe"),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="off",
         agg="probe"),
]


@pytest.mark.parametrize("case", WIRES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_measured_wire_bytes_equal_the_plan(case):
    """On emulated ranks the counters equal the plan's prediction to the
    byte on every static wire, each tier apart; the ragged wire's plan is
    an upper bound, labelled an estimate."""
    case = dict(case)
    n, s, agg = case.pop("n"), case.pop("slices", 1), case.pop("agg", None)
    (cb, vb), (cp, vp) = _oracle_tables(rows_b=1024, rows_p=2048)
    cp["probe_payload"] = cp["probe_payload"].astype(np.int64)
    tb = Table.from_numpy(cb, vb, device="cpu")
    tp = Table.from_numpy(cp, vp, device="cpu")
    comm = EmulatedCommunicator(n, n_slices=s)
    if agg:
        case["aggregate"] = AggregateSpec.of("probe_payload",
                                             [("count", None, "n")])
    res = tdist.distributed_inner_join(tb, tp, comm, with_metrics=True,
                                       explain=True, out_capacity_factor=8.0,
                                       **case)
    assert not bool(res.overflow)
    red, plan = _reduced(res), res.plan
    assert plan.with_metrics
    sides = ("build", "probe") + (("partials",) if agg else ())
    if case.get("shuffle") == "ragged":
        assert plan.wire["exact"] is False
        for side in sides:
            assert red[f"{side}.wire_bytes"] <= \
                plan.wire[side]["bytes_total"]
        return
    assert plan.wire["exact"] is True
    for side in sides:
        w = plan.wire[side]
        assert red[f"{side}.wire_bytes"] == w["bytes_total"], side
        if "ici_bytes_per_rank" in w:
            assert red[f"{side}.wire_bytes_ici"] == \
                w["ici_bytes_per_rank"] * n
            assert red[f"{side}.wire_bytes_dcn"] == \
                w["dcn_bytes_per_rank"] * n
    if "sort_segments" in case:
        # a constant of every rank, summed over the ranks
        assert red["sort_segments"] == plan.capacities["sort_segments"] * n


def test_skew_and_probe_only_counters():
    """The skew sidecar's ``skew.hh_matches`` and the resident step's
    ``resident.rows``, as the JAX steps put them on the tape."""
    rng = np.random.default_rng(2)
    cb = {"key": np.arange(1024, dtype=np.int64),
          "build_payload": rng.integers(0, 9, 1024).astype(np.int64)}
    keys = np.where(rng.random(4096) < 0.5, 7, rng.integers(0, 1024, 4096))
    cp = {"key": keys.astype(np.int64),
          "probe_payload": rng.integers(0, 9, 4096).astype(np.int64)}
    tb = Table.from_numpy(cb, np.ones(1024, bool), device="cpu")
    tp = Table.from_numpy(cp, np.ones(4096, bool), device="cpu")
    comm = EmulatedCommunicator(4)
    res = tdist.distributed_inner_join(
        tb, tp, comm, with_metrics=True, skew_threshold=0.05,
        out_capacity_factor=4.0, hh_out_capacity=4096)
    red = _reduced(res)
    assert red["skew.hh_matches"] == int((keys == 7).sum())
    assert red["matches"] == int(res.total) == 4096
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    reg = ResidentTableRegistry(comm, JoinProgramCache(comm))
    reg.register("dim", tb)
    po = reg.join("dim", tp, with_metrics=True, explain=True,
                  over_decomposition=2)
    red = _reduced(po)
    assert red["resident.rows"] == 1024 and red["matches"] == 4096
    assert red["probe.wire_bytes"] == po.plan.wire["probe"]["bytes_total"]
    assert "build.wire_bytes" not in red


# -- the tape off ---------------------------------------------------------------


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("opts", [
    dict(), dict(over_decomposition=2, shuffle="ragged"),
    dict(compression_bits=16), dict(join_type="anti"),
    dict(aggregate="key"),
], ids=str)
def test_tape_off_runs_the_same_step(opts):
    """``with_metrics=False`` (the default) builds no tape: the same
    result and the same torch op sequence as the step built without the
    switch (``metrics_static`` ignored); the tape on only adds ops (the
    step's own are a subsequence of its ops) and leaves the result as it
    was. ``scripts/tape_off_census.py`` holds the tape-off ops against
    the tree before the tape. One rank at k = 2 (a
    dispatch mode sees its own thread only, so not emulated ranks'),
    which partitions and shuffles."""
    opts = dict(opts)
    opts.setdefault("over_decomposition", 2)
    if opts.get("aggregate"):
        opts["aggregate"] = AggregateSpec.of("key", [("count", None, "n")])
    (cb, vb), (cp, vp) = _oracle_tables()
    tb = Table.from_numpy(cb, vb, device="cpu")
    tp = Table.from_numpy(cp, vp, device="cpu")
    comm = LocalCommunicator()
    runs = {}
    for label, kw in (("plain", {}), ("off", dict(with_metrics=False)),
                      ("static", dict(metrics_static={
                          "retry_attempt_max": 3})),
                      ("on", dict(with_metrics=True))):
        fn = tdist.make_distributed_join(comm, out_capacity_factor=8.0,
                                         **kw, **opts)
        mode = _Ops()
        with mode:
            res = fn(tb, tp)
        runs[label] = (res, mode.ops)
    plain_res, plain_ops = runs["plain"]
    for label in ("off", "static"):
        res, ops = runs[label]
        assert ops == plain_ops, label
        assert not hasattr(res, "telemetry")
        assert torch.equal(res.total, plain_res.total)
        for c in plain_res.table.columns:
            assert torch.equal(res.table.columns[c],
                               plain_res.table.columns[c])
    on_res, on_ops = runs["on"]
    assert len(on_ops) > len(plain_ops)
    # the tape only adds ops: the step's own run in the same order
    rest = iter(on_ops)
    assert all(op in rest for op in plain_ops)
    assert torch.equal(on_res.total, plain_res.total)
    assert _reduced(on_res)["matches"] == int(plain_res.total)


def test_tape_views_share_one_store():
    tape = MetricsTape()
    tape.add("retry_attempt_max", 2)
    b = tape.scoped("build")
    b.add("wire_bytes", 10)
    b.add("wire_bytes", torch.tensor(5))
    b.record_min("overflow_margin_min", 9)
    b.record_min("overflow_margin_min", torch.tensor(4))
    tape.scoped("probe").record_min("overflow_margin_min", 3)
    tape.scoped("probe").record_min("overflow_margin_min", 8)
    m = tape.gathered(LocalCommunicator(), torch.device("cpu"))
    assert m.to_dict() == {
        "n_ranks": 1,
        "per_rank": {"build.overflow_margin_min": [4],
                     "build.wire_bytes": [15],
                     "probe.overflow_margin_min": [3],
                     "retry_attempt_max": [2]},
        "reduced": {"build.overflow_margin_min": 4, "build.wire_bytes": 15,
                    "probe.overflow_margin_min": 3, "retry_attempt_max": 2}}
    two = Metrics(names=("a.x_max", "b.integrity.d", "c_min", "n"),
                  values=torch.tensor([[1, 5, 7, 2], [3, 6, 4, 2]]))
    d = two.to_dict()
    assert d["reduced"] == {"a.x_max": 3, "c_min": 4, "n": 4}
    assert d["per_rank"]["b.integrity.d"] == [5, 6]
