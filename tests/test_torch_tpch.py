"""BASELINE config 4 on the port against the JAX package, on the CPU: the
TPC-H generators (device and host), the numpy hash twins and key-range
batch ids, the out-of-core batch loop (totals, overflow and fetched
rows, on one rank and on 8 emulated ranks), the resume manifest under
injected batch failures, and the tpch driver's flags, refusals and
record.

The same inputs go through both packages as numpy arrays. The host
generator is numpy in both, so its batches must be equal bit for bit;
the device generators draw from different sources (``jax.random``,
``torch.Generator``), so only their structure is compared.
"""

import json

import numpy as np
import pytest
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.benchmarks import tpch_join as jdriver
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import faults as jfaults
from distributed_join_tpu.parallel import out_of_core as jooc
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils import tpch as jtpch
from distributed_join_tpu.utils import tpch_host as jhost
from distributed_join_tpu.utils.generators import (
    generate_build_probe_tables as jgenerate,
)
from distributed_join_tpu_torch.benchmarks import stamp_record
from distributed_join_tpu_torch.benchmarks import tpch_join as tdriver
from distributed_join_tpu_torch.ops.hashing import bucket_ids, hash_columns
from distributed_join_tpu_torch.parallel import faults as tfaults
from distributed_join_tpu_torch.parallel import out_of_core as tooc
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils import tpch as ttpch
from distributed_join_tpu_torch.utils import tpch_host as thost

SF = 0.004          # 6,000 orders, ~24,000 lines
CHUNK = 1_000       # orders a chunk: six chunks
OOC_OPTS = dict(out_capacity_factor=3.0, shuffle_capacity_factor=3.0)


def _jcomm(n: int):
    return (jcomm.make_communicator("local") if n == 1
            else jcomm.make_communicator("tpu", n_ranks=n))


def _tcomm(n: int):
    return LocalCommunicator() if n == 1 else EmulatedCommunicator(n)


def _rows(columns: dict, valid) -> np.ndarray:
    """Valid rows as an int64 matrix, columns in name order, sorted (a
    multiset: row order inside a key run is free)."""
    valid = np.asarray(valid)
    cols = [np.asarray(columns[n])[valid].astype(np.int64)
            for n in sorted(columns)]
    rows = np.stack(cols, axis=1) if cols else np.zeros((0, 0), np.int64)
    return rows[np.lexsort(rows.T[::-1])]


def _multiset(parts) -> np.ndarray:
    rows = np.concatenate(parts)
    return rows[np.lexsort(rows.T[::-1])]


# -- the generators ------------------------------------------------------


@pytest.mark.parametrize("n_batches", [1, 3, 5])
@pytest.mark.parametrize("q3", [False, True], ids=["all", "q3"])
@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "wide"])
def test_host_batches_equal_jax_bit_for_bit(narrow, q3, n_batches):
    """Same seed, chunking and draw order: every batch, column, dtype and
    value equal to the JAX package's."""
    got = thost.generate_tpch_host_batches(
        7, SF, n_batches, chunk_orders=CHUNK, q3_filters=q3,
        narrow_wire=narrow)
    want = jhost.generate_tpch_host_batches(
        7, SF, n_batches, chunk_orders=CHUNK, q3_filters=q3,
        narrow_wire=narrow)
    for side_got, side_want in zip(got, want):
        assert len(side_got) == len(side_want) == n_batches
        for bg, bw in zip(side_got, side_want):
            assert list(bg) == list(bw)
            for name in bg:
                assert bg[name].dtype == bw[name].dtype, name
                np.testing.assert_array_equal(bg[name], bw[name])


def test_host_generator_constants_and_limits_equal_jax():
    for name in ("ORDERS_DTYPES", "LINEITEM_DTYPES", "NARROW_ORDERS_DTYPES",
                 "NARROW_LINEITEM_DTYPES", "MAX_NARROW_ORDERS",
                 "DEFAULT_CHUNK_ORDERS"):
        assert getattr(thost, name) == getattr(jhost, name), name
    for name in ("ORDERS_PER_SF", "DATE_RANGE_DAYS", "MAX_SHIP_LAG_DAYS",
                 "MAX_LINES_PER_ORDER"):
        assert getattr(ttpch, name) == getattr(jtpch, name), name
    # the narrow wire refuses where order keys reach 2^31 (SF ~358)
    with pytest.raises(ValueError, match="narrow_wire"):
        thost.generate_tpch_host_batches(1, 400, 2)
    with pytest.raises(ValueError, match="n_batches"):
        thost.generate_tpch_host_batches(1, SF, 0)


def test_rename_batches_equals_jax():
    ob, _ = thost.generate_tpch_host_batches(3, SF, 2, chunk_orders=CHUNK)
    got = thost.rename_batches(ob, {"o_orderkey": "key"})
    want = jhost.rename_batches(ob, {"o_orderkey": "key"})
    assert [list(b) for b in got] == [list(b) for b in want]
    assert all(g["key"] is w["key"] for g, w in zip(got, want))


@pytest.mark.parametrize("n", [1, 8, 20, 4097])
def test_sparse_order_keys_exact(n):
    got = ttpch.sparse_order_keys(n, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jtpch.sparse_order_keys(n)))
    if n >= 20:
        assert got[:8].tolist() == [1, 2, 3, 4, 5, 6, 7, 8]
        assert got[8:16].tolist() == [33, 34, 35, 36, 37, 38, 39, 40]
        assert got[16:20].tolist() == [65, 66, 67, 68]


def test_device_generator_structure():
    """JAX ``tests/test_tpch.py:29-56`` on the port's generator: 1,500
    orders at SF 0.001, every line joins an order, 1..7 lines an order
    with mean near 4, ship dates 1..121 days after the order date, and
    the column dtypes of the JAX tables."""
    orders, lineitem = ttpch.generate_tpch_join_tables(7, 0.001,
                                                       device="cpu")
    jorders, jlineitem = jtpch.generate_tpch_join_tables(7, 0.001)
    assert orders.capacity == jorders.capacity == 1500
    for t, j in ((orders, jorders), (lineitem, jlineitem)):
        assert list(t.columns) == list(j.columns)
        for name in t.columns:
            assert (t.columns[name].numpy().dtype
                    == np.asarray(j.columns[name]).dtype), name
    lk = lineitem.columns["l_orderkey"].numpy()
    ok = orders.columns["o_orderkey"].numpy()
    assert np.isin(lk, ok).all()
    counts = np.bincount(lk)[ok]
    assert counts.min() >= 1 and counts.max() <= 7
    assert 3.5 < counts.mean() < 4.5
    od = dict(zip(ok.tolist(), orders.columns["o_orderdate"].tolist()))
    lag = (lineitem.columns["l_shipdate"].numpy()
           - np.array([od[k] for k in lk.tolist()]))
    assert lag.min() >= 1 and lag.max() <= 121
    q = lineitem.columns["l_quantity"].numpy()
    d = lineitem.columns["l_discount"].numpy()
    assert q.min() >= 1 and q.max() <= 50 and d.min() >= 0 and d.max() <= 10
    again = ttpch.generate_tpch_join_tables(7, 0.001, device="cpu")[1]
    assert torch.equal(again.columns["l_shipdate"],
                       lineitem.columns["l_shipdate"])


def test_q3_filter_masks_equal_jax():
    """The same tables through both packages' ``q3_filter``: equal
    validity masks (and ``num_valid``), columns untouched."""
    jo, jl = jtpch.generate_tpch_join_tables(3, 0.002)
    to = Table.from_numpy({k: np.asarray(v) for k, v in jo.columns.items()},
                          np.asarray(jo.valid), device="cpu")
    tl = Table.from_numpy({k: np.asarray(v) for k, v in jl.columns.items()},
                          np.asarray(jl.valid), device="cpu")
    for cutoff in (0, 1203, 2406):
        wo, wl = jtpch.q3_filter(jo, jl, cutoff)
        go, gl = ttpch.q3_filter(to, tl, cutoff)
        for g, w in ((go, wo), (gl, wl)):
            np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
            assert int(g.num_valid()) == int(w.num_valid())


def test_table_rename_and_num_valid_equal_jax():
    cols = {"a": np.arange(6, dtype=np.int64), "b": np.arange(6) * 2}
    valid = np.array([1, 0, 1, 1, 0, 1], bool)
    t = Table.from_numpy(cols, valid, device="cpu").rename({"a": "key"})
    j = JTable({k: np.asarray(v) for k, v in cols.items()},
               np.asarray(valid)).rename({"a": "key"})
    assert list(t.columns) == list(j.columns) == ["key", "b"]
    assert int(t.num_valid()) == int(j.num_valid()) == 4
    assert t.num_valid().dtype == torch.int64


# -- hashing and batch routing -------------------------------------------


def _keys(kind: str, n: int = 20_000):
    rng = np.random.default_rng(11)
    if kind == "int64":
        return [rng.integers(-(1 << 62), 1 << 62, n)]
    if kind == "int32":
        return [rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)]
    if kind == "composite":
        return [rng.integers(0, 1 << 40, n),
                rng.integers(0, 1 << 20, n).astype(np.int32)]
    if kind == "float32":
        return [rng.normal(0, 1e6, n).astype(np.float32)]
    if kind == "float64":
        return [rng.normal(0, 1e9, n)]
    if kind == "tpch_narrow":
        return [np.asarray(jtpch.sparse_order_keys(n)).astype(np.int32)]
    raise ValueError(kind)


KINDS = ["int64", "int32", "composite", "float32", "float64", "tpch_narrow"]


@pytest.mark.parametrize("kind", KINDS)
def test_hash_columns_np_equals_jax(kind):
    keys = _keys(kind)
    np.testing.assert_array_equal(tooc.hash_columns_np(keys),
                                  jooc.hash_columns_np(keys))
    for k in keys:
        if k.dtype.kind == "i":
            np.testing.assert_array_equal(tooc.fmix64_np(k),
                                          jooc.fmix64_np(k))
            np.testing.assert_array_equal(tooc.fmix32_np(k),
                                          jooc.fmix32_np(k))


@pytest.mark.parametrize("n_batches", [1, 4, 7, 24])
@pytest.mark.parametrize("kind", KINDS)
def test_key_batch_ids_equal_jax(kind, n_batches):
    keys = _keys(kind)
    arg = keys if len(keys) > 1 else keys[0]
    got = tooc.key_batch_ids(arg, n_batches)
    np.testing.assert_array_equal(got, jooc.key_batch_ids(arg, n_batches))
    assert got.dtype == np.int64
    assert set(got.tolist()) == set(range(n_batches))


@pytest.mark.parametrize("kind", ["int64", "int32", "composite",
                                  "tpch_narrow"])
def test_batch_ids_compose_with_the_device_bucket_routing(kind):
    """The host's numpy hash is the port's device hash bit for bit (int64
    and the narrow int32 keys), so the device's ``hash % n`` buckets and
    the host's upper-bit batches are two independent splits: every
    (batch, bucket) cell is filled evenly, and equal keys share both."""
    keys = _keys(kind, 64_000)
    tk = [torch.from_numpy(np.ascontiguousarray(k)) for k in keys]
    h_np = tooc.hash_columns_np(keys)
    h_dev = hash_columns(tk).numpy().view(np.uint64)
    np.testing.assert_array_equal(h_dev, h_np)
    n_buckets, n_batches = 8, 4
    bucket = bucket_ids(tk, n_buckets).numpy()
    np.testing.assert_array_equal(bucket, (h_np % np.uint64(n_buckets))
                                  .astype(np.int32))
    batch = tooc.key_batch_ids(keys if len(keys) > 1 else keys[0], n_batches)
    cells = np.bincount(batch * n_buckets + bucket,
                        minlength=n_batches * n_buckets)
    mean = len(batch) / cells.size
    assert cells.min() > 0.85 * mean and cells.max() < 1.15 * mean
    # a batch holds every bucket, and a duplicated key lands where its
    # first copy did
    dup = [np.concatenate([k, k[:100]]) for k in keys]
    dbatch = tooc.key_batch_ids(dup if len(dup) > 1 else dup[0], n_batches)
    np.testing.assert_array_equal(dbatch[-100:], dbatch[:100])


# -- the batch loop against the JAX package ------------------------------


def _host_join_batches(seed=5, sf=SF, n_batches=4, q3=True):
    ob, lb = jhost.generate_tpch_host_batches(seed, sf, n_batches,
                                              chunk_orders=CHUNK,
                                              q3_filters=q3)
    return (jhost.rename_batches(ob, {"o_orderkey": "key"}),
            jhost.rename_batches(lb, {"l_orderkey": "key"}))


@pytest.mark.parametrize("n", [1, 8])
def test_batched_join_host_equals_jax(n):
    """The same numpy batches through both batch loops: totals, overflow
    and stats' capacities equal, and the fetched rows equal as sorted
    multisets, batch by batch."""
    bb, pb = _host_join_batches()
    fetched = {"jax": {}, "port": {}}

    def jconsume(b, res):
        fetched["jax"][b] = _rows(res.table.columns, res.table.valid)

    def tconsume(b, res):
        fetched["port"][b] = _rows(
            {k: v.numpy() for k, v in res.table.columns.items()},
            res.table.valid.numpy())

    jstats, tstats = {}, {}
    want = jooc.batched_join_host(bb, pb, _jcomm(n), stats=jstats,
                                  on_batch_result=jconsume, **OOC_OPTS)
    got = tooc.batched_join_host(bb, pb, _tcomm(n), device="cpu",
                                 stats=tstats, on_batch_result=tconsume,
                                 **OOC_OPTS)
    assert got == (int(want[0]), bool(want[1]))
    assert not got[1] and got[0] > 0
    assert set(tstats) == set(jstats)
    for k in ("build_capacity", "probe_capacity", "resumed_batches",
              "failed_batches"):
        assert tstats[k] == jstats[k], k
    assert sorted(fetched["port"]) == sorted(fetched["jax"]) == [0, 1, 2, 3]
    for b in range(4):
        np.testing.assert_array_equal(fetched["port"][b], fetched["jax"][b])


def test_batched_total_equals_the_numpy_count():
    """A line matches when its order survived Q3's filters: a sparse key
    maps back to its order's index, so numpy counts the matches without
    a join."""
    bb, pb = _host_join_batches(seed=9, sf=0.01, n_batches=3)
    present = np.zeros(int(ttpch.ORDERS_PER_SF * 0.01), bool)

    def index(keys):
        k = keys.astype(np.int64) - 1
        return (k // 32) * 8 + k % 32

    for b in bb:
        present[index(b["key"])] = True
    want = sum(int(present[index(b["key"])].sum()) for b in pb)
    assert 0 < want < sum(len(b["key"]) for b in pb)
    total, overflow = tooc.batched_join_host(bb, pb, LocalCommunicator(),
                                             device="cpu", **OOC_OPTS)
    assert total == want and not overflow


@pytest.mark.parametrize("n", [1, 8])
def test_keyrange_batched_join_equals_jax_and_single_shot(n):
    """JAX's device tables (SF 0.002, Q3 filters) through both packages'
    key-range loops, 4 batches: equal totals and row multisets, equal
    to a single-shot join of the port."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    jo, jl = jtpch.q3_filter(*jtpch.generate_tpch_join_tables(4, 0.002))
    jb, jp = jo.rename({"o_orderkey": "key"}), jl.rename({"l_orderkey": "key"})
    tb, tp = (Table.from_numpy({k: np.asarray(v) for k, v in t.columns.items()},
                               np.asarray(t.valid), device="cpu")
              for t in (jb, jp))
    jparts, tparts = [], []
    want = jooc.keyrange_batched_join(
        jb, jp, _jcomm(n), n_batches=4, warmup=False, **OOC_OPTS,
        on_batch_result=lambda b, r: jparts.append(
            _rows(r.table.columns, r.table.valid)))
    got = tooc.keyrange_batched_join(
        tb, tp, _tcomm(n), n_batches=4, warmup=False, **OOC_OPTS,
        on_batch_result=lambda b, r: tparts.append(_rows(
            {k: v.numpy() for k, v in r.table.columns.items()},
            r.table.valid.numpy())))
    single = distributed_inner_join(tb, tp, _tcomm(n), out_capacity_factor=2.0)
    assert got == (int(want[0]), bool(want[1])) == (int(single.total), False)
    np.testing.assert_array_equal(_multiset(tparts), _multiset(jparts))
    np.testing.assert_array_equal(
        _multiset(tparts),
        _rows({k: v.numpy() for k, v in single.table.columns.items()},
              single.table.valid.numpy()))


def test_overflow_is_reported_as_in_jax():
    """A per-rank output block of 8 rows overflows every batch in both
    packages; the totals stay exact."""
    bb, pb = _host_join_batches()
    opts = dict(out_rows_per_rank=8, shuffle_capacity_factor=3.0)
    want = jooc.batched_join_host(bb, pb, _jcomm(8), **opts)
    got = tooc.batched_join_host(bb, pb, _tcomm(8), device="cpu", **opts)
    assert got == (int(want[0]), True)


def test_batch_loop_refuses_what_the_port_lacks():
    bb, pb = _host_join_batches()
    comm = LocalCommunicator()
    # the wire digests are ported: a verified run is the plain run (its
    # raise and degrade modes are tests/test_torch_integrity.py's)
    assert tooc.batched_join_host(bb, pb, comm, device="cpu",
                                  verify_integrity=True) == \
        tooc.batched_join_host(bb, pb, comm, device="cpu")
    # the watchdog is ported: a batch deadline bounds each settle, and a
    # run inside it is the plain run
    assert tooc.batched_join_host(bb, pb, comm, device="cpu",
                                  batch_deadline_s=30.0) == \
        tooc.batched_join_host(bb, pb, comm, device="cpu")
    with pytest.raises(ValueError, match="on_batch_failure"):
        tooc.batched_join_host(bb, pb, comm, device="cpu",
                               on_batch_failure="skip")
    with pytest.raises(ValueError, match="batch counts"):
        tooc.batched_join_host(bb[:2], pb, comm, device="cpu")


def test_the_loop_stages_only_this_process_rows(monkeypatch):
    """Each staged table holds ``comm.local_rows`` of the batch capacity:
    on a single-process backend every row; the join reads them through
    ``spmd(..., local_inputs=True)``."""
    bb, pb = _host_join_batches()
    seen = []
    real = tooc.make_distributed_join

    def factory(comm, **opts):
        assert opts.pop("local_inputs") is True
        fn = real(comm, local_inputs=True, **opts)

        def each(bt, pt):
            seen.append((bt.capacity, pt.capacity))
            return fn(bt, pt)
        return each

    monkeypatch.setattr(tooc, "make_distributed_join", factory)
    stats = {}
    tooc.batched_join_host(bb, pb, EmulatedCommunicator(4), device="cpu",
                           stats=stats, **OOC_OPTS)
    assert seen and set(seen) == {(stats["build_capacity"],
                                   stats["probe_capacity"])}
    assert stats["build_capacity"] % 4 == stats["probe_capacity"] % 4 == 0


# -- failures, retries and the resume manifest ----------------------------
#
# JAX tests/test_faults.py:442-540, :543, :603, :688, :699, with the
# failures injected by a wrapper around the port's join factory (the port
# has no FaultInjectingCommunicator yet).


@pytest.fixture(scope="module")
def ooc_tables():
    b, p = jgenerate(seed=29, build_nrows=1500, probe_nrows=3000,
                     rand_max=700, selectivity=0.5)
    return tuple(
        Table.from_numpy({k: np.asarray(v) for k, v in t.columns.items()},
                         np.asarray(t.valid), device="cpu") for t in (b, p))


@pytest.fixture(scope="module")
def ooc_reference(ooc_tables):
    """The uninterrupted run's total and per-batch totals (port), which
    must equal the JAX package's total on the same tables."""
    b, p = ooc_tables
    per_batch = {}
    total, overflow = tooc.keyrange_batched_join(
        b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
        on_batch_result=lambda i, res: per_batch.__setitem__(
            i, int(res.total)), **OOC_OPTS)
    jb, jp = (JTable({k: v.numpy() for k, v in t.columns.items()},
                     t.valid.numpy()) for t in (b, p))
    want, _ = jooc.keyrange_batched_join(jb, jp, _jcomm(8), n_batches=4,
                                         warmup=False, **OOC_OPTS)
    assert not overflow and total == int(want)
    assert sum(per_batch.values()) == total
    return total, per_batch


class _Injected(RuntimeError):
    pass


def _inject(monkeypatch, fail_dispatches=0, fail_after_dispatches=None):
    """Make the batch loop's joins fail as JAX's ``FaultPlan`` does: the
    first ``fail_dispatches`` dispatches, or every dispatch after the
    first ``fail_after_dispatches``."""
    real = tooc.make_distributed_join
    count = {"n": 0}

    def factory(*args, **kwargs):
        fn = real(*args, **kwargs)

        def each(*tables):
            count["n"] += 1
            if count["n"] <= fail_dispatches:
                raise _Injected(f"injected dispatch failure #{count['n']}")
            if (fail_after_dispatches is not None
                    and count["n"] > fail_after_dispatches):
                raise _Injected("persistent outage")
            return fn(*tables)
        return each

    monkeypatch.setattr(tooc, "make_distributed_join", factory)


def test_batch_retry_recovers_a_transient_failure(monkeypatch, ooc_tables,
                                                  ooc_reference):
    b, p = ooc_tables
    _inject(monkeypatch, fail_dispatches=1)
    stats = {}
    total, overflow = tooc.keyrange_batched_join(
        b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
        batch_retries=1, batch_retry_backoff_s=0.0, stats=stats, **OOC_OPTS)
    assert total == ooc_reference[0] and not overflow
    assert stats["failed_batches"] == []


def test_graceful_degradation_reports_partial_totals(
        monkeypatch, ooc_tables, ooc_reference):
    b, p = ooc_tables
    total0, per_batch = ooc_reference
    _inject(monkeypatch, fail_dispatches=2)
    stats = {}
    total, _ = tooc.keyrange_batched_join(
        b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
        batch_retries=1, batch_retry_backoff_s=0.0,
        on_batch_failure="continue", stats=stats, **OOC_OPTS)
    assert stats["failed_batches"] == [0]
    assert total == total0 - per_batch[0]
    with pytest.warns(UserWarning, match="PARTIAL"):
        _inject(monkeypatch, fail_dispatches=2)
        tooc.keyrange_batched_join(
            b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
            batch_retries=1, batch_retry_backoff_s=0.0,
            on_batch_failure="continue", **OOC_OPTS)


def test_killed_run_resumes_bit_exact_from_manifest(
        tmp_path, monkeypatch, ooc_tables, ooc_reference):
    """JAX :498-540: a run killed after two dispatches leaves batch 0
    settled in the manifest (settled at the backpressure point of batch
    1's dispatch); the same call again resumes from batch 1, skips batch
    0 (the consumer never sees it) and gives the uninterrupted total."""
    b, p = ooc_tables
    total0, per_batch = ooc_reference
    path = str(tmp_path / "join_manifest.json")
    _inject(monkeypatch, fail_after_dispatches=2)
    with pytest.raises(_Injected, match="persistent outage"):
        tooc.keyrange_batched_join(b, p, EmulatedCommunicator(8),
                                   n_batches=4, warmup=False,
                                   manifest_path=path, **OOC_OPTS)
    data = json.load(open(path))
    assert set(data["batches"]) == {"0"}
    assert data["batches"]["0"]["total"] == per_batch[0]
    assert data["failures"], "the injected failure must be logged"

    monkeypatch.undo()
    seen, stats = [], {}
    with pytest.warns(UserWarning, match="resuming from a manifest"):
        total, overflow = tooc.keyrange_batched_join(
            b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
            manifest_path=path, stats=stats,
            on_batch_result=lambda i, res: seen.append(i), **OOC_OPTS)
    assert total == total0 and not overflow
    assert stats["resumed_batches"] == [0]
    assert seen == [1, 2, 3], "completed batch 0 must not re-run"
    data = json.load(open(path))
    assert set(data["batches"]) == {"0", "1", "2", "3"}
    assert sum(v["total"] for v in data["batches"].values()) == total0

    # a manifest that covers every batch: no join runs at all
    _inject(monkeypatch, fail_after_dispatches=0)
    total, overflow = tooc.keyrange_batched_join(
        b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
        manifest_path=path, **OOC_OPTS)
    assert total == total0 and not overflow


def test_overflowed_manifest_batches_rerun_on_resume(
        tmp_path, ooc_tables, ooc_reference):
    """JAX :543: batches recorded with overflow run again on resume with
    larger capacities, and their entries come back clean."""
    b, p = ooc_tables
    total0, _ = ooc_reference
    path = str(tmp_path / "m.json")
    total, overflow = tooc.keyrange_batched_join(
        b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
        manifest_path=path, out_rows_per_rank=8, shuffle_capacity_factor=3.0)
    assert total == total0 and overflow
    assert all(v["overflow"] for v in json.load(open(path))["batches"]
               .values())
    stats = {}
    total, overflow = tooc.keyrange_batched_join(
        b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
        manifest_path=path, stats=stats, **OOC_OPTS)
    assert total == total0 and not overflow
    assert stats["resumed_batches"] == []
    stats = {}
    tooc.keyrange_batched_join(
        b, p, EmulatedCommunicator(8), n_batches=4, warmup=False,
        manifest_path=path, stats=stats, **OOC_OPTS)
    assert stats["resumed_batches"] == [0, 1, 2, 3]


def test_manifest_refuses_resume_after_capacity_change(
        tmp_path, monkeypatch, ooc_tables):
    """JAX :603: more probe rows change the per-batch rows and the padded
    capacity; resuming against the old manifest refuses."""
    b, p = ooc_tables
    path = str(tmp_path / "m.json")
    _inject(monkeypatch, fail_after_dispatches=2)
    with pytest.raises(_Injected):
        tooc.keyrange_batched_join(b, p, EmulatedCommunicator(8),
                                   n_batches=4, warmup=False,
                                   manifest_path=path, **OOC_OPTS)
    monkeypatch.undo()
    _, p2 = jgenerate(seed=29, build_nrows=1500, probe_nrows=3200,
                      rand_max=700, selectivity=0.5)
    p2 = Table.from_numpy({k: np.asarray(v) for k, v in p2.columns.items()},
                          np.asarray(p2.valid), device="cpu")
    with pytest.raises(tfaults.ManifestMismatchError, match="different"):
        tooc.keyrange_batched_join(b, p2, EmulatedCommunicator(8),
                                   n_batches=4, warmup=False,
                                   manifest_path=path, **OOC_OPTS)


def test_manifest_refuses_mismatched_config(tmp_path, ooc_tables):
    """JAX :688."""
    b, p = ooc_tables
    path = str(tmp_path / "m.json")
    tfaults.JoinManifest(path, {"n_batches": 999})
    with pytest.raises(tfaults.ManifestMismatchError, match="different"):
        tooc.keyrange_batched_join(b, p, EmulatedCommunicator(8),
                                   n_batches=4, warmup=False,
                                   manifest_path=path, **OOC_OPTS)
    # the refusal leaves the other run's manifest as it was
    assert json.load(open(path))["config"] == {"n_batches": 999}


def test_manifest_atomic_roundtrip_and_failure_log(tmp_path):
    """JAX :699, and the failure log's bound."""
    path = str(tmp_path / "m.json")
    m = tfaults.JoinManifest(path, {"n_batches": 2})
    m.record_batch(0, 123, False)
    m.record_failure(1, "RuntimeError: boom", 0)
    m2 = tfaults.JoinManifest(path, {"n_batches": 2})
    assert m2.completed == {0: {"total": 123, "overflow": False}}
    assert m2.failures[0]["batch"] == 1
    for i in range(tfaults.JoinManifest.MAX_FAILURES + 5):
        m2.record_failure(1, f"e{i}", i)
    assert len(m2.failures) == tfaults.JoinManifest.MAX_FAILURES
    assert m2.failures[-1]["error"] == f"e{tfaults.JoinManifest.MAX_FAILURES + 4}"
    assert not (tmp_path / "m.json.tmp").exists()


def test_manifests_cross_between_the_packages(tmp_path):
    """``batch_config_fingerprint`` equal to JAX's, and a manifest either
    package writes the other reads, to the same completed batches and
    failures."""
    bb, pb = _host_join_batches()
    for key in ("key", ["key", "x"]):
        fp = tfaults.batch_config_fingerprint(bb, pb, 8, key, 1024, 4096)
        assert fp == jfaults.batch_config_fingerprint(bb, pb, 8, key, 1024,
                                                      4096)
    for writer, reader in ((jfaults, tfaults), (tfaults, jfaults)):
        path = str(tmp_path / f"{writer.__name__}.json")
        w = writer.JoinManifest(path, fp)
        w.record_batch(2, 77, False)
        w.record_batch(0, 5, True)
        w.record_failure(1, "RuntimeError: x", 3)
        r = reader.JoinManifest(path, fp)
        assert r.completed == w.completed == {
            2: {"total": 77, "overflow": False},
            0: {"total": 5, "overflow": True}}
        assert r.failures == w.failures
        with pytest.raises(reader.ManifestMismatchError):
            reader.JoinManifest(path, dict(fp, n_ranks=4))


# -- the driver -------------------------------------------------------------


JAX_FLAGS = {
    # every flag of the JAX driver: a value to pass, or None for a switch
    "--scale-factor": "0.002", "--communicator": "local", "--n-ranks": "1",
    "--iterations": "1", "--q3-filters": None, "--agg": None,
    "--query": "q3", "--batches": "2", "--host-generator": None,
    "--wide-wire": None, "--fetch-results": None, "--manifest": "m.json",
    "--batch-retries": "1", "--continue-on-batch-failure": None,
    "--over-decomposition-factor": "1", "--shuffle-capacity-factor": "1.6",
    "--out-capacity-factor": "1.5", "--json-output": "r.json",
    "--platform": "cpu", "--telemetry": "t", "--trace": None,
    "--diagnose": None, "--history": "h", "--stage-profile": "3",
    "--explain": None, "--verify-integrity": None, "--chaos-seed": "1",
    "--guard-deadline-s": "5", "--sort-mode": "flat",
    "--sort-segments": "4", "--auto-tune": None,
}


def test_driver_flags_cover_the_jax_driver():
    """Every flag of the JAX driver is either the port's, with the same
    destination and default, or refused by name."""
    jargs, targs = vars(jdriver.parse_args([])), vars(tdriver.parse_args([]))
    for flag in JAX_FLAGS:
        dest = flag[2:].replace("-", "_")
        assert dest in jargs, flag
        if flag in tdriver._REFUSED:
            assert dest not in targs, flag
            continue
        assert dest in targs, flag
        if flag != "--communicator":  # JAX's is tpu, the port's local
            assert targs[dest] == jargs[dest], flag
    assert set(targs) <= set(jargs)


# flags the driver takes and its run refuses, in the JAX driver's words
RUN_REFUSED = {"--auto-tune": "does not consult the history store"}
# flags the driver takes and its --query run refuses, in the JAX
# driver's words
QUERY_REFUSED = {"--verify-integrity": "--query composes its own plan"}


@pytest.mark.parametrize("flag", [f for f in JAX_FLAGS
                                  if f in tdriver._REFUSED
                                  or f in RUN_REFUSED
                                  or f in QUERY_REFUSED])
def test_driver_refuses_what_the_port_lacks(flag, capsys):
    argv = [flag] + ([JAX_FLAGS[flag]] if JAX_FLAGS[flag] else [])
    jargs = jdriver.parse_args(argv)  # the JAX driver takes it
    if flag in QUERY_REFUSED:
        # ported: taken as the JAX driver takes it, and refused with
        # --query in its words
        assert getattr(tdriver.parse_args(argv), flag[2:].replace(
            "-", "_")) == getattr(jargs, flag[2:].replace("-", "_"))
        argv += ["--query", "q3"]
        for drv in (jdriver, tdriver):
            with pytest.raises(SystemExit, match=QUERY_REFUSED[flag]):
                drv.run(drv.parse_args(argv))
        return
    if flag in RUN_REFUSED:
        targs = tdriver.parse_args(argv)
        for run, args in ((jdriver.run, jargs), (tdriver.run, targs)):
            with pytest.raises(SystemExit, match=RUN_REFUSED[flag]):
                run(args)
        return
    with pytest.raises(SystemExit):
        tdriver.parse_args(argv)
    err = capsys.readouterr().err
    assert flag in err and "not part of the port" in err


@pytest.mark.parametrize("argv,match", [
    (["--manifest", "m.json"], "apply to the batched paths"),
    (["--batch-retries", "2"], "apply to the batched paths"),
    (["--continue-on-batch-failure"], "apply to the batched paths"),
    (["--fetch-results"], "--fetch-results applies"),
    (["--sort-mode", "segmented"], "--sort-ab"),
    (["--sort-mode", "auto", "--sort-segments", "4"], "--sort-ab"),
    (["--query", "q3", "--agg"], "--query composes its own plan"),
    (["--query", "q10", "--batches", "2", "--q3-filters"],
     "--batches > 1, --q3-filters do"),
    (["--agg", "--host-generator"], "--agg covers the single-shot path"),
])
def test_driver_guards_equal_jax(argv, match):
    with pytest.raises(SystemExit, match=match):
        jdriver.run(jdriver.parse_args(argv))
    with pytest.raises(SystemExit, match=match):
        tdriver.run(tdriver.parse_args(argv), device="cpu")


@pytest.mark.parametrize("path", [
    ["--host-generator", "--batches", "3", "--fetch-results"],
    ["--host-generator", "--batches", "2", "--q3-filters", "--wide-wire"],
    ["--batches", "3", "--fetch-results"],
    ["--iterations", "1"],
], ids=["host_fetch", "host_q3_wide", "keyrange", "single_shot"])
def test_driver_record_equals_jax(path, tmp_path):
    """Each path of the driver on the CPU against the JAX driver's record:
    every JAX field present; on the host generator (numpy in both) the
    row counts and matches equal; on the device generators every line
    matches its order in both."""
    base = ["--scale-factor", "0.002"]
    want = jdriver.run(jdriver.parse_args(
        base + ["--communicator", "local"] + path))
    got = stamp_record(tdriver.run(tdriver.parse_args(
        base + path + ["--json-output", str(tmp_path / "r.json")]),
        device="cpu"))
    assert set(want) <= set(got), set(want) - set(got)
    for k in ("benchmark", "n_ranks", "scale_factor", "q3_filters",
              "batches", "overflow", "host_generator", "narrow_wire",
              "fetch_results", "manifest", "resumed_batches",
              "failed_batches", "verify_integrity"):
        if k in want:
            assert got[k] == want[k], k
    assert not got["overflow"]
    if "--host-generator" in path:
        for k in ("orders_nrows", "lineitem_nrows", "matches_per_join",
                  "batch_build_capacity", "batch_probe_capacity",
                  "fetched_bytes"):
            assert got[k] == want[k], k
        rss = got["host_rss_bytes"]
        assert set(rss) == {"before_generate", "after_generate",
                            "after_loop"} and all(v > 0 for v in rss.values())
        assert 0 < got["peak_host_rss_generate_bytes"] \
            <= got["peak_host_rss_bytes"]
    else:
        assert got["matches_per_join"] == got["lineitem_nrows"]
        assert want["matches_per_join"] == want["lineitem_nrows"]
        assert got["orders_nrows"] == want["orders_nrows"] == 3000
    assert got["device"] == "cpu" and got["peak_host_rss_bytes"] > 0


def test_driver_manifest_resume_through_the_driver(tmp_path):
    """``--manifest`` through the host-generator path: a second run of
    the same command resumes every batch and reports the same total."""
    argv = ["--scale-factor", "0.002", "--host-generator", "--batches", "3",
            "--manifest", str(tmp_path / "m.json")]
    first = tdriver.run(tdriver.parse_args(argv), device="cpu")
    second = tdriver.run(tdriver.parse_args(argv), device="cpu")
    assert first["resumed_batches"] == []
    assert second["resumed_batches"] == [0, 1, 2]
    assert first["matches_per_join"] == second["matches_per_join"] > 0


# the JAX --query record's fields (benchmarks/tpch_join.py:553-572)
JAX_QUERY_FIELDS = {
    "kind", "query", "counter_signature", "plan_digest", "n_operators",
    "customer_nrows", "op_totals", "groups", "oracle_equal",
    "retry_attempts", "programs_traced", "warm_new_traces",
    "warm_cache_hit", "wire_exact", "wire", "cost_total_s",
    "order_candidates", "aggregate", "stage_profile"}


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("q", ["q3", "q10"])
def test_driver_query_cache_fields_equal_jax(q, n):
    """``--query``'s ``programs_traced``, ``warm_new_traces`` and
    ``warm_cache_hit`` come from the program cache the plan runs
    through (JAX :466-487, :574-576): one program a rung of the cold
    run, none for a warm one, the warm run a hit. The JAX driver's
    ``--query`` itself raises the shard_map ``out_specs`` replication
    error on the installed jax (its cached rungs carry a
    ``metrics_static`` tape), so its count is taken as it defines it, one
    trace a rung of its ``distributed_query``, on the same tables as the
    port's cache-backed run."""
    from distributed_join_tpu.parallel import query_exec as jq
    from distributed_join_tpu.planning.query import tpch_query_plan as jplan
    from distributed_join_tpu_torch.parallel.query_exec import (
        distributed_query,
    )
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    from distributed_join_tpu_torch.service.programs import JoinProgramCache

    jtables = jtpch.query_filters(
        jtpch.generate_tpch_query_tables(seed=7, scale_factor=0.004), q)
    jres = jq.distributed_query(jtables, jplan(q), jcomm.make_communicator(
        "tpu", n_ranks=n), auto_retry=4)
    comm = LocalCommunicator() if n == 1 else EmulatedCommunicator(n)
    cache = JoinProgramCache(comm)
    tables = {k: Table.from_numpy(
        {c: np.asarray(v) for c, v in t.columns.items()},
        np.asarray(t.valid), device="cpu") for k, t in jtables.items()}
    cold = distributed_query(tables, tpch_query_plan(q), comm, auto_retry=4,
                             program_cache=cache)
    traced = cache.traces
    warm = distributed_query(tables, tpch_query_plan(q), comm, auto_retry=4,
                             program_cache=cache)
    assert cold.retry_attempts == jres.retry_attempts
    assert traced == jres.retry_attempts + 1
    assert cache.traces == traced and warm.cache_hit and not cold.cache_hit

    base = ["--scale-factor", "0.004", "--iterations", "2", "--query", q]
    rec = tdriver.run(tdriver.parse_args(
        base + (["--communicator", "emulated", "--n-ranks", "4"] if n > 1
                else [])), device="cpu")
    for f in ("programs_traced", "warm_new_traces", "warm_cache_hit"):
        assert f in rec and f not in rec.get("not_ported", ()), f
    assert rec["programs_traced"] == rec["retry_attempts"] + 1
    assert rec["warm_new_traces"] == 0 and rec["warm_cache_hit"] is True


@pytest.mark.parametrize("q", ["q3", "q10"])
def test_driver_query_record(q, tmp_path, monkeypatch):
    """``--query`` on the CPU, one rank and 4 emulated ranks: every
    field of the JAX record present (``stage_profile`` where
    ``--stage-profile`` ran, as in the JAX driver) and nothing
    ``not_ported``, the plan's digest and aggregate equal to JAX's, the
    groups equal to the numpy oracle, and the same groups on both rank
    counts."""
    from distributed_join_tpu.planning.query import tpch_query_plan
    # without a session the profile's file lands in the working directory
    monkeypatch.chdir(tmp_path)
    base = ["--scale-factor", "0.004", "--iterations", "2", "--query", q]
    one = tdriver.run(tdriver.parse_args(base), device="cpu")
    four = tdriver.run(tdriver.parse_args(
        base + ["--communicator", "emulated", "--n-ranks", "4",
                "--stage-profile", "1"]),
        device="cpu")
    plan = tpch_query_plan(q)
    assert "stage_profile" not in one
    assert set(four["stage_profile"]["wall_s"]) == {
        op.op_id for op in plan.ops}
    assert json.load(open(tmp_path / "query_stageprofile.json"))[
        "kind"] == "query_stageprofile"
    for rec in (one, four):
        assert JAX_QUERY_FIELDS - {"stage_profile"} <= set(rec)
        assert "not_ported" not in rec
        assert rec["plan_digest"] == plan.digest()
        assert rec["aggregate"] == plan.aggregate.as_record()
        assert rec["kind"] == "query_smoke" and rec["n_operators"] == 3
        assert rec["oracle_equal"] and rec["groups"] > 0
        assert rec["op_totals"][-1] == rec["matches_per_join"]
        assert len(rec["query_s"]) == 2 and not rec["overflow"]
    assert one["groups_digest"] == four["groups_digest"]
    assert one["op_totals"] == four["op_totals"]
    assert one["customer_nrows"] == (600 if q == "q10" else
                                     one["customer_nrows"]) > 0


def test_driver_agg_record():
    """``--agg`` on the single-shot path: JAX's spec, groups equal to the
    numpy oracle."""
    from distributed_join_tpu.ops.aggregate import AggregateSpec
    rec = tdriver.run(tdriver.parse_args([
        "--scale-factor", "0.004", "--iterations", "2", "--agg",
        "--q3-filters"]), device="cpu")
    want = AggregateSpec.of(
        "key", [("sum", "l_extendedprice", "revenue"),
                ("count", None, "n_lines"),
                ("max", "l_shipdate", "last_ship")],
        carry=("o_orderdate",)).as_record()
    agg = rec["aggregate"]
    assert rec["agg"] and {k: agg[k] for k in want} == want
    assert agg["oracle_equal"] and agg["groups"] > 0 and not rec["overflow"]
