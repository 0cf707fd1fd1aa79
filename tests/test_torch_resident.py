"""The port's resident build tables (service/resident.py), its probe-only
steps (make_probe_join_step, the probe-only aggregate) and the join
driver's ``--resident-ab`` against the JAX package's, on the CPU.

The same numpy-made tables go through both packages, on 1 rank and on 4
emulated ranks (the JAX package's 4-device mesh). Held against the
reference exactly: totals and overflow, retry trails, the program
cache's counters (hits, misses, traces, evictions by reason),
generations and the conservation pairs (global valid rows and the
uint64 key-hash sum), refusal counts and messages, and the result rows
as sorted multisets (the two packages return columns in different
orders, so rows are compared by column name). Groups of the probe-only
aggregate compare exactly for integers and within rtol 1e-5, atol 1e-8
for floats. The JAX package's integrity and metrics variants are red on
this toolchain; the port's cases assert that they refuse by name.
"""

import json
import os
import tempfile

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import aggregate as ja
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.service import programs as jprog
from distributed_join_tpu.service import resident as jres
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import aggregate as ta
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.service import programs as tprog
from distributed_join_tpu_torch.service import resident as tres
from distributed_join_tpu_torch.table import Table

RANKS = [1, 4]


class _JCounting(jcomm.TpuCommunicator):
    """The JAX side's program counter (its tests' CountingComm)."""

    def __init__(self, n_ranks):
        super().__init__(n_ranks=n_ranks)
        self.programs_built = 0

    def spmd(self, fn, *, sharded_out=None):
        self.programs_built += 1
        return super().spmd(fn, sharded_out=sharded_out)


class _JCorrupting(jcomm.TpuCommunicator):
    """Adds 1 to the first block of every int64 all-to-all when armed
    (the JAX tests' CorruptingComm)."""

    def __init__(self, n_ranks):
        super().__init__(n_ranks=n_ranks)
        self.corrupt = False

    def all_to_all(self, x):
        out = super().all_to_all(x)
        if self.corrupt and x.dtype == jnp.int64:
            out = out.at[0].add(jnp.int64(1))
        return out


def _counting(base):
    class Counting(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.programs_built = 0

        def spmd(self, fn, **kw):
            self.programs_built += 1
            return super().spmd(fn, **kw)
    return Counting


class _TCorrupting(EmulatedCommunicator):
    def __init__(self, n_ranks):
        super().__init__(n_ranks)
        self.corrupt = False

    def all_to_all(self, x):
        out = super().all_to_all(x)
        if self.corrupt and x.dtype == __import__("torch").int64:
            out = out.clone()
            out[0] += 1
        return out


def _comms(n, counting=False):
    """(JAX communicator, port communicator) of ``n`` ranks."""
    if n == 1:
        j = jcomm.make_communicator("local")
        t = _counting(LocalCommunicator)() if counting \
            else LocalCommunicator()
        return j, t
    j = _JCounting(n) if counting else jcomm.make_communicator(
        "tpu", n_ranks=n)
    t = _counting(EmulatedCommunicator)(n) if counting \
        else EmulatedCommunicator(n)
    return j, t


def _side(seed, rows, kmax, payload, valid_frac=1.0):
    rng = np.random.default_rng(seed)
    cols = {"key": rng.integers(0, kmax, rows).astype(np.int64),
            payload: rng.integers(-(1 << 40), 1 << 40, rows).astype(np.int64)}
    return cols, rng.random(rows) < valid_frac


def _tables(seed=11, build=512, probe=1024, kmax=256):
    return (_side(seed, build, kmax, "build_payload"),
            _side(seed + 1000, probe, kmax, "probe_payload"))


def _delta(seed, rows=256, kmax=256):
    return _side(seed, rows, kmax, "build_payload")


def _both(side):
    cols, valid = side
    return (JTable({k: jnp.asarray(v) for k, v in cols.items()},
                   jnp.asarray(valid)),
            Table.from_numpy(cols, valid, device="cpu"))


def _rows_of(cols: dict, valid) -> tuple:
    """Column names (sorted) and the valid rows as a sorted int64 array."""
    names = sorted(cols)
    valid = np.asarray(valid)
    a = np.stack([np.asarray(cols[n])[valid].astype(np.int64)
                  for n in names], 1)
    return names, a[np.lexsort(a.T[::-1])] if len(a) else a


def _jrows(res):
    return _rows_of({k: np.asarray(v) for k, v in res.table.columns.items()},
                    res.table.valid)


def _trows(res):
    cols, valid = res.table.to_numpy()
    return _rows_of(cols, valid)


def _oracle(builds, probe) -> tuple:
    """The inner join of the valid rows by numpy, as ``_rows_of``."""
    bcols = {k: np.concatenate([c[k][v] for c, v in builds])
             for k in builds[0][0]}
    pcols = {k: c[probe[1]] for k, c in probe[0].items()}
    order = np.argsort(bcols["key"], kind="stable")
    sk = bcols["key"][order]
    lo = np.searchsorted(sk, pcols["key"], "left")
    hi = np.searchsorted(sk, pcols["key"], "right")
    cnt = hi - lo
    p_idx = np.repeat(np.arange(len(cnt)), cnt)
    starts = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
    b_idx = order[starts + np.arange(cnt.sum())]
    cols = {k: v[b_idx] for k, v in bcols.items()}
    cols.update({k: v[p_idx] for k, v in pcols.items() if k != "key"})
    return _rows_of(cols, np.ones(len(p_idx), bool))


def _same_rows(a, b):
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def _trail(report):
    return [(a.action, a.overflow, a.shuffle_capacity_factor,
             a.out_capacity_factor) for a in report.attempts]


def _handle_state(h):
    return (h.rows, h.key_digest, h.generation, h.capacity_per_rank,
            len(h.pending_runs), h.merges, h.appends, h.poisoned)


def _registries(n, counting=False, **kw):
    jc, tc = _comms(n, counting)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    return ((jc, jcache, jres.ResidentTableRegistry(jc, jcache, **kw)),
            (tc, tcache, tres.ResidentTableRegistry(tc, tcache, **kw)))


# -- the sorted run and the conservation pair ------------------------------


def test_key_sorted_prefix_and_accounting_equal_jax():
    """The run layout: the valid rows key-sorted first, a valid row whose
    key is the sentinel (int64 max) before every invalid row; and the
    conservation pair equal to JAX's uint64 sum bit for bit."""
    cols, valid = _side(3, 300, 50, "v", valid_frac=0.7)
    cols["key"][:5] = np.iinfo(np.int64).max
    valid[:5] = True
    jt, tt = _both((cols, valid))
    jrun = jres._key_sorted_prefix(jt, ["key"])
    trun = tres._key_sorted_prefix(tt, ["key"])
    nv = int(valid.sum())
    tv = trun.valid.numpy()
    np.testing.assert_array_equal(tv, np.asarray(jrun.valid))
    assert tv[:nv].all() and not tv[nv:].any()
    np.testing.assert_array_equal(trun.columns["key"].numpy()[:nv],
                                  np.asarray(jrun.columns["key"])[:nv])
    assert (trun.columns["key"].numpy()[nv - 5:nv]
            == np.iinfo(np.int64).max).all()
    _same_rows(_rows_of(*trun.to_numpy()), _rows_of(
        {k: np.asarray(v) for k, v in jrun.columns.items()}, jrun.valid))
    jrows, jdig = jres._run_accounting(jcomm.make_communicator("local"), jt,
                                       ["key"])
    trows, tdig = tres._run_accounting(LocalCommunicator(), tt, ["key"])
    assert int(trows) == int(jrows) == nv
    assert tres._unsigned(tdig) == int(np.asarray(jdig))


# -- probe-only correctness --------------------------------------------------


@pytest.mark.parametrize("n", RANKS)
def test_probe_only_matches_oracle_and_full_join(n):
    """Probe-only rows equal JAX's, the numpy oracle's and the full
    join's multiset; the warm repeat builds no program, reports warm,
    and the cache counters equal JAX's."""
    bs, ps = _tables()
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    (jc, jcache, jreg), (tc, tcache, treg) = _registries(n, counting=True)
    jreg.register("dim", jb)
    treg.register("dim", tb)
    jr = jreg.join("dim", jp, with_metrics=False, out_capacity_factor=4.0)
    tr = treg.join("dim", tp, out_capacity_factor=4.0)
    _same_rows(_trows(tr), _jrows(jr))
    _same_rows(_trows(tr), _oracle([bs], ps))
    assert not bool(tr.overflow)
    full = tdist.distributed_inner_join(tb, tp, tc, out_capacity_factor=4.0)
    assert int(full.total) == int(tr.total) == int(jr.total)
    built = tc.programs_built
    tr2 = treg.join("dim", tp, out_capacity_factor=4.0)
    jreg.join("dim", jp, with_metrics=False, out_capacity_factor=4.0)
    assert tc.programs_built == built
    assert int(tr2.total) == int(tr.total)
    assert tr2.resident["warm"] is True and tr.resident["warm"] is False
    assert treg.stats()["warm_probe_joins"] == 1
    assert tcache.stats() == jcache.stats()
    assert _handle_state(treg.get("dim")) == _handle_state(jreg.get("dim"))
    assert {k: v for k, v in treg.stats().items() if k != "tables"} \
        == {k: v for k, v in jreg.stats().items() if k != "tables"}
    # the generation-free workload identity is JAX's, digit for digit
    opts = {"out_capacity_factor": 4.0, "over_decomposition": 2}
    assert treg.workload_signature("dim", tp, opts) == \
        jreg.workload_signature("dim", jp, opts)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("k", [2, 3])
def test_probe_only_over_decomposition_routes_correctly(n, k):
    """Registration buckets by h % n, the probe by h % (k * n): every
    probe row meets its build rows ((h % kn) % n == h % n), at every k;
    the total and rows equal JAX's and the oracle's."""
    bs, ps = _tables(seed=13)
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    (_, _, jreg), (_, _, treg) = _registries(n)
    jreg.register("dim", jb)
    treg.register("dim", tb)
    jr = jreg.join("dim", jp, with_metrics=False, over_decomposition=k,
                   out_capacity_factor=4.0)
    tr = treg.join("dim", tp, over_decomposition=k, out_capacity_factor=4.0)
    assert int(tr.total) == int(jr.total) == len(_oracle([bs], ps)[1])
    _same_rows(_trows(tr), _jrows(jr))


@pytest.mark.parametrize("n", RANKS)
def test_probe_ladder_escalates_on_overflow(n):
    """An undersized output block overflows; the probe-side ladder
    escalates with JAX's trail, and the answer is the oracle's."""
    bs, ps = _tables(seed=17)
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    (_, jcache, jreg), (_, tcache, treg) = _registries(n)
    jreg.register("dim", jb)
    treg.register("dim", tb)
    jr = jreg.join("dim", jp, with_metrics=False, auto_retry=4,
                   out_capacity_factor=0.05)
    tr = treg.join("dim", tp, auto_retry=4, out_capacity_factor=0.05)
    assert tr.retry_report.n_attempts > 1
    assert _trail(tr.retry_report) == _trail(jr.retry_report)
    assert int(tr.total) == int(jr.total) == len(_oracle([bs], ps)[1])
    _same_rows(_trows(tr), _jrows(jr))
    # the same query again walks both rungs from the cache
    treg.join("dim", tp, auto_retry=4, out_capacity_factor=0.05)
    jreg.join("dim", jp, with_metrics=False, auto_retry=4,
              out_capacity_factor=0.05)
    assert tcache.stats() == jcache.stats()


# -- LSM ingestion -----------------------------------------------------------


@pytest.mark.parametrize("n", RANKS)
def test_lsm_appends_merge_to_oracle(n):
    """Two appends, each merged: rows equal the oracle's after the
    merges, generations and conservation pairs equal JAX's after every
    step, old-generation entries evicted with JAX's counts, and the
    repeat after the merges is warm."""
    bs, ps = _tables()
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    (jc, jcache, jreg), (tc, tcache, treg) = _registries(
        n, counting=True, capacity_factor=3.0)
    jreg.register("dim", jb)
    treg.register("dim", tb)
    jreg.join("dim", jp, with_metrics=False, out_capacity_factor=4.0)
    treg.join("dim", tp, out_capacity_factor=4.0)
    deltas = [_delta(21), _delta(22)]
    for d in deltas:
        jd, td = _both(d)
        jreg.append("dim", jd, maintain=True)
        treg.append("dim", td, maintain=True)
        assert _handle_state(treg.get("dim")) == \
            _handle_state(jreg.get("dim"))
        assert tcache.stats() == jcache.stats()
    assert tcache.generation_evictions >= 1
    h = treg.get("dim")
    assert h.generation == 3 and h.merges == 2
    jr = jreg.join("dim", jp, with_metrics=False, out_capacity_factor=4.0)
    tr = treg.join("dim", tp, out_capacity_factor=4.0)
    _same_rows(_trows(tr), _oracle([bs, *deltas], ps))
    _same_rows(_trows(tr), _jrows(jr))
    built = tc.programs_built
    treg.join("dim", tp, out_capacity_factor=4.0)
    jreg.join("dim", jp, with_metrics=False, out_capacity_factor=4.0)
    assert tc.programs_built == built
    assert tcache.stats() == jcache.stats()


@pytest.mark.parametrize("n", RANKS)
def test_pending_runs_merge_on_read(n):
    """A queued delta is merged by the next join: appended rows are
    always visible."""
    bs, ps = _tables(seed=23)
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    (_, _, jreg), (_, _, treg) = _registries(n, maintain_runs=16)
    jreg.register("dim", jb)
    treg.register("dim", tb)
    d = _delta(24)
    jd, td = _both(d)
    jreg.append("dim", jd, maintain=False)
    treg.append("dim", td, maintain=False)
    assert treg.get("dim").pending_runs
    assert treg.get("dim").bytes_resident == jreg.get("dim").bytes_resident
    jr = jreg.join("dim", jp, with_metrics=False, out_capacity_factor=4.0)
    tr = treg.join("dim", tp, out_capacity_factor=4.0)
    assert not treg.get("dim").pending_runs
    assert int(tr.total) == int(jr.total) == len(_oracle([bs, d], ps)[1])
    assert _handle_state(treg.get("dim")) == _handle_state(jreg.get("dim"))


@pytest.mark.parametrize("n", RANKS)
def test_generation_evicts_only_that_handles_entries(n):
    """An append to one table evicts that table's probe-only programs
    only: the other table's repeat stays warm, as in the JAX package."""
    bs, ps = _tables(seed=41)
    cs, _ = _tables(seed=42)
    (jb, tb), (jb2, tb2), (jp, tp) = _both(bs), _both(cs), _both(ps)
    (_, jcache, jreg), (_, tcache, treg) = _registries(n)
    for reg, b, b2, p, kw in ((jreg, jb, jb2, jp, {"with_metrics": False}),
                              (treg, tb, tb2, tp, {})):
        reg.register("a", b)
        reg.register("b", b2)
        reg.join("a", p, out_capacity_factor=4.0, **kw)
        reg.join("b", p, out_capacity_factor=4.0, **kw)
    for reg, d in ((jreg, _both(_delta(43))[0]), (treg, _both(_delta(43))[1])):
        reg.append("a", d, maintain=True)
    assert tcache.generation_evictions == 1
    tr = treg.join("b", tp, out_capacity_factor=4.0)
    jr = jreg.join("b", jp, with_metrics=False, out_capacity_factor=4.0)
    assert tr.resident["warm"] and jr.resident["warm"]
    assert not treg.join("a", tp, out_capacity_factor=4.0).resident["warm"]
    jreg.join("a", jp, with_metrics=False, out_capacity_factor=4.0)
    assert tcache.stats() == jcache.stats()
    treg.drop("a")
    jreg.drop("a")
    assert tcache.stats() == jcache.stats()
    assert treg.names() == jreg.names() == ["b"]


# -- refusals ----------------------------------------------------------------


def _raises_same(fj, ft, exc=Exception):
    """Both calls raise ``exc`` (a class of each package's where the
    packages define their own), of one class name, with one message."""
    with pytest.raises(exc) as je:
        fj()
    with pytest.raises(exc) as te:
        ft()
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("n", RANKS)
def test_refusals_never_wrong_rows(n):
    bs, ps = _tables(seed=25)
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    (_, _, jreg), (_, _, treg) = _registries(n)
    _raises_same(lambda: jreg.join("ghost", jp),
                 lambda: treg.join("ghost", tp))
    assert treg.refused == jreg.refused == 1
    jreg.register("dim", jb)
    treg.register("dim", tb)
    for reg, b in ((jreg, jb), (treg, tb)):
        with pytest.raises(Exception, match="already exists"):
            reg.register("dim", b)
    # a schema-mismatched delta refuses, the handle untouched
    bad = ({"key": np.arange(64, dtype=np.int64),
            "other_payload": np.zeros(64, np.int64)}, np.ones(64, bool))
    jbad, tbad = _both(bad)
    gen = treg.get("dim").generation
    _raises_same(lambda: jreg.append("dim", jbad),
                 lambda: treg.append("dim", tbad))
    assert treg.get("dim").generation == gen
    # 2-D columns and float keys go through the full join
    strings = ({"key": np.arange(64, dtype=np.int64),
                "s": np.zeros((64, 8), np.uint8),
                "s#len": np.full(64, 8, np.int32)}, np.ones(64, bool))
    floaty = ({"key": np.arange(64, dtype=np.float32),
               "v": np.zeros(64, np.int64)}, np.ones(64, bool))
    for table, match in ((strings, "scalar"), (floaty, "integer")):
        jt, tt = _both(table)
        for reg, t in ((jreg, jt), (treg, tt)):
            with pytest.raises(tres.ResidentError if reg is treg
                               else jres.ResidentError, match=match):
                reg.register("x", t)
    # the skew sidecar is not a probe-only knob
    _raises_same(lambda: jreg.join("dim", jp, skew_threshold=0.001),
                 lambda: treg.join("dim", tp, skew_threshold=0.001))
    # the wire digests are ported: the probe side's n^2 pairs (one rank
    # has no wire); the step's own switch follows verify_integrity
    res = treg.join("dim", tp, verify_integrity=True)
    assert res.integrity_report.ok
    assert res.integrity_report.checked_pairs == (n * n if n > 1 else 0)
    assert res.integrity_report.channels == (("probe",) if n > 1 else ())
    with pytest.raises(TypeError, match="with_integrity"):
        treg.join("dim", tp, with_integrity=True)
    # the metrics tape, the plan and the autotuner are ported
    from distributed_join_tpu_torch.planning.tuner import JoinTuner
    assert treg.join("dim", tp, tuner=JoinTuner()).tuned["source"] == \
        "static"
    res = treg.join("dim", tp, with_metrics=True, explain=True)
    assert res.telemetry.to_dict()["reduced"]["matches"] == int(res.total)
    assert res.plan.probe_only and res.plan.pipeline == "probe_join"
    # the cache's disk tier is ported (tests/test_torch_persist.py): a
    # persist_dir is taken, not refused, and the probe-only program of
    # this handle enters it
    with tempfile.TemporaryDirectory() as d:
        cache = tprog.JoinProgramCache(treg.comm, persist_dir=d,
                                       device="cpu")
        disk = tres.ResidentTableRegistry(treg.comm, cache)
        disk.register("dim", tb)
        assert int(disk.join("dim", tp).total) == \
            int(treg.join("dim", tp).total)
        entries = [f for f in os.listdir(d) if f.endswith(".joinprog")]
        assert len(entries) == cache.stats()["disk_persists"] >= 1
    jreg.drop("dim")
    treg.drop("dim")
    _raises_same(lambda: jreg.join("dim", jp),
                 lambda: treg.join("dim", tp))
    assert treg.refused == jreg.refused >= 5
    assert {k: v for k, v in treg.stats().items() if k != "tables"} \
        == {k: v for k, v in jreg.stats().items() if k != "tables"}


@pytest.mark.parametrize("n", [2, 4])
def test_corrupt_delta_refuses_loudly(n):
    """A value-corrupting transport fails the key-hash conservation
    check: the append refuses with JAX's message, the handle keeps its
    generation and rows, and later joins serve the clean image."""
    bs, ps = _tables(seed=27)
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    jc, tc = _JCorrupting(n), _TCorrupting(n)
    jreg = jres.ResidentTableRegistry(jc, jprog.JoinProgramCache(jc))
    tcache = tprog.JoinProgramCache(tc)
    treg = tres.ResidentTableRegistry(tc, tcache)
    jreg.register("dim", jb)
    treg.register("dim", tb)
    before = _handle_state(treg.get("dim"))
    jc.corrupt = tc.corrupt = True
    jd, td = _both(_delta(28))
    with pytest.raises(jres.ResidentError, match="conservation") as je:
        jreg.append("dim", jd)
    with pytest.raises(tres.ResidentError, match="conservation") as te:
        treg.append("dim", td)
    assert str(te.value).split(":")[0] == str(je.value).split(":")[0]
    jc.corrupt = tc.corrupt = False
    assert _handle_state(treg.get("dim")) == before
    assert tcache.integrity_evictions == 1
    jr = jreg.join("dim", jp, with_metrics=False, out_capacity_factor=4.0)
    tr = treg.join("dim", tp, out_capacity_factor=4.0)
    assert int(tr.total) == int(jr.total) == len(_oracle([bs], ps)[1])
    _same_rows(_trows(tr), _oracle([bs], ps))


@pytest.mark.parametrize("n", [2, 4])
def test_poisoned_registration_refuses_loudly(n):
    """A corrupting transport at registration refuses it outright: no
    handle is made; a clean transport registers."""
    bs, _ = _tables(seed=29)
    jb, tb = _both(bs)
    jc, tc = _JCorrupting(n), _TCorrupting(n)
    jreg = jres.ResidentTableRegistry(jc, jprog.JoinProgramCache(jc))
    tcache = tprog.JoinProgramCache(tc)
    treg = tres.ResidentTableRegistry(tc, tcache)
    jc.corrupt = tc.corrupt = True
    with pytest.raises(jres.ResidentError, match="conservation"):
        jreg.register("dim", jb)
    with pytest.raises(tres.ResidentError, match="conservation"):
        treg.register("dim", tb)
    assert "dim" not in treg and "dim" not in jreg
    assert tcache.integrity_evictions == 1
    jc.corrupt = tc.corrupt = False
    treg.register("dim", tb)
    jreg.register("dim", jb)
    assert _handle_state(treg.get("dim")) == _handle_state(jreg.get("dim"))


@pytest.mark.parametrize("n", RANKS)
def test_overflowing_merge_poisons_handle(n):
    """Appends past the resident capacity overflow the merge: the handle
    poisons after as many appends as JAX's, joins refuse, and drop plus
    re-register recovers."""
    bs, ps = _tables(seed=31)
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    (_, _, jreg), (_, _, treg) = _registries(
        n, capacity_factor=1.0, delta_slot_rows=512)
    appended = {}
    for name, reg, side in (("jax", jreg, 0), ("port", treg, 1)):
        reg.register("dim", (jb, tb)[side])
        count = 0
        with pytest.raises(Exception, match="overflow|capacity"):
            while True:
                reg.append("dim", _both(_delta(100 + count, rows=512))[side],
                           maintain=True)
                count += 1
                assert count < 64
        appended[name] = count
        with pytest.raises(Exception, match="poisoned"):
            reg.join("dim", (jp, tp)[side])
        assert reg.peek("dim").poisoned
    assert appended["port"] == appended["jax"]
    treg.drop("dim")
    treg.register("dim", tb)
    assert int(treg.join("dim", tp, out_capacity_factor=4.0).total) == \
        len(_oracle([bs], ps)[1])


# -- the probe-only steps -----------------------------------------------------


def test_probe_only_step_refusals_match_jax():
    """The probe-only step refuses what JAX's refuses, with its exception
    types and messages; the metrics tape and the integrity digests are
    taken."""
    jc, tc = jcomm.make_communicator("tpu", n_ranks=4), EmulatedCommunicator(4)
    for opts, exc in (({"sort_mode": "segmented"}, ValueError),
                      ({"shuffle": "hierarchical"}, ValueError),
                      ({"shuffle": "ragged", "compression_bits": 16},
                       ValueError),
                      ({"over_decomposition": 0}, ValueError)):
        _raises_same(lambda: jdist.make_probe_join_step(jc, **opts),
                     lambda: tdist.make_probe_join_step(tc, **opts), exc)
    spec = ("key", [("count", None)])
    for opts in ({"build_payload": ["v"]}, {"kernel_config": object()}):
        with pytest.raises(ja.AggregatePushdownUnsupported) as je:
            jdist.make_probe_join_step(
                jc, aggregate=ja.AggregateSpec.of(*spec), **opts)
        with pytest.raises(ta.AggregatePushdownUnsupported) as te:
            tdist.make_probe_join_step(
                tc, aggregate=ta.AggregateSpec.of(*spec), **opts)
        assert str(te.value) == str(je.value)
    step = tdist.make_probe_join_step(tc, with_integrity=True)
    assert callable(step)
    tdist.make_probe_join_step(tc, with_metrics=True)
    # the multi-slice mesh
    with pytest.raises(ValueError, match="multi-slice"):
        tdist.make_probe_join_step(EmulatedCommunicator(4, n_slices=2))
    # in the step: 2-D columns, a key dtype mismatch, build-mode groups
    lc = LocalCommunicator()
    two_d = Table.from_numpy({"key": np.arange(8, dtype=np.int64),
                              "s": np.zeros((8, 4), np.uint8)},
                             np.ones(8, bool), device="cpu")
    narrow = Table.from_numpy({"key": np.arange(8, dtype=np.int32)},
                              np.ones(8, bool), device="cpu")
    wide = Table.from_numpy({"key": np.arange(8, dtype=np.int64),
                             "g": np.arange(8, dtype=np.int64)},
                            np.ones(8, bool), device="cpu")
    step = tdist.make_probe_join_step(lc)
    with pytest.raises(TypeError, match="2-D"):
        step(two_d, wide)
    with pytest.raises(TypeError, match="dtype mismatch"):
        step(wide, narrow)
    agg = tdist.make_probe_join_step(
        lc, aggregate=ta.AggregateSpec.of("g", [("count", None)]))
    keys_only = Table.from_numpy({"key": np.arange(8, dtype=np.int64)},
                                 np.ones(8, bool), device="cpu")
    with pytest.raises(ta.AggregatePushdownUnsupported, match="RESIDENT"):
        agg(wide, keys_only)


def _groups(frame):
    return {k: np.asarray(v) for k, v in frame.items()}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("mode", ["key", "probe"])
def test_resident_aggregate_probe_only(n, mode):
    """The probe-only fused aggregate through the registry: groups equal
    JAX's (integers exactly, floats within rtol 1e-5) and the numpy
    oracle's; the repeat is warm; the materializing probe-only join keys
    a program of its own; the cache counters equal JAX's. Probe mode
    groups by a probe column and runs the cross-batch combine (k = 2)
    and, on 4 ranks, the partials exchange."""
    rng = np.random.default_rng(5)
    bcols = {"key": rng.permutation(400).astype(np.int64),
             "build_payload": rng.integers(-500, 500, 400).astype(np.int64),
             "bf": rng.random(400)}
    pcols = {"key": rng.integers(0, 600, 900).astype(np.int64),
             "probe_payload": rng.integers(-500, 500, 900).astype(np.int64),
             "grp": rng.integers(0, 16, 900).astype(np.int64)}
    bs, ps = (bcols, np.ones(400, bool)), (pcols, rng.random(900) < 0.9)
    (jb, tb), (jp, tp) = _both(bs), _both(ps)
    group = "key" if mode == "key" else "grp"
    aggs = [("count", None), ("sum", "probe_payload"),
            ("sum", "build_payload"), ("sum", "bf")]
    jspec, tspec = ja.AggregateSpec.of(group, aggs), \
        ta.AggregateSpec.of(group, aggs)
    (_, jcache, jreg), (_, tcache, treg) = _registries(n)
    jreg.register("t", jb)
    treg.register("t", tb)
    k = 2 if mode == "probe" else 1
    jr = jreg.join("t", jp, aggregate=jspec, with_metrics=False,
                   over_decomposition=k)
    tr = treg.join("t", tp, aggregate=tspec, over_decomposition=k)
    gb = [group]
    got = ta.groups_frame(tr.table, tspec, gb)
    want = _groups(ja.groups_frame(jr.table, jspec, gb))
    assert ta.frames_equal(got, want)
    assert ta.frames_equal(got, ta.aggregate_oracle(tb, tp, "key", tspec))
    assert int(tr.total) == int(jr.total)
    t0 = tcache.traces
    tr2 = treg.join("t", tp, aggregate=tspec, over_decomposition=k)
    assert tcache.traces == t0 and tr2.resident["warm"]
    treg.join("t", tp, out_capacity_factor=8.0)
    assert tcache.traces == t0 + 1
    jreg.join("t", jp, aggregate=jspec, with_metrics=False,
              over_decomposition=k)
    jreg.join("t", jp, with_metrics=False, out_capacity_factor=8.0)
    assert tcache.stats() == jcache.stats()


# -- the driver ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_resident_record(tmp_path_factory):
    from distributed_join_tpu.benchmarks.distributed_join import main

    out = tmp_path_factory.mktemp("rab") / "rec.json"
    assert main(["--platform", "cpu", "--n-ranks", "4",
                 "--build-table-nrows", "4096", "--probe-table-nrows",
                 "1024", "--iterations", "1", "--out-capacity-factor",
                 "3.0", "--resident-ab", "2", "--json-output",
                 str(out)]) == 0
    return json.loads(out.read_text())["resident_ab"]


@pytest.mark.parametrize("n", RANKS)
def test_driver_resident_ab(n, jax_resident_record):
    """``--resident-ab N``: one record with JAX's keys, equal matches and
    row digests, no warm probe-only build, and the registration."""
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    comm = ["--communicator", "local"] if n == 1 else [
        "--communicator", "emulated", "--n-ranks", str(n)]
    rec = tdriver.run(tdriver.parse_args(comm + [
        "--build-table-nrows", "4096", "--probe-table-nrows", "1024",
        "--iterations", "1", "--out-capacity-factor", "3.0",
        "--resident-ab", "2"]), device="cpu")
    ab = rec["resident_ab"]
    assert set(jax_resident_record) <= set(ab)
    assert set(ab["resident"]) == set(jax_resident_record["resident"])
    assert ab["matches_equal"] is True and ab["digest_equal"] is True
    assert ab["matches_cold"] == rec["matches_per_join"] > 0
    assert ab["warm_probe_new_traces"] == 0
    assert ab["n_joins"] == 2 and not ab["overflow"]
    assert ab["resident"]["rows"] == 4096
    assert ab["resident"]["joins_served"] == \
        jax_resident_record["resident"]["joins_served"] == 3
    assert ab["cold_wall_min_s"] > 0 and ab["probe_only_wall_min_s"] > 0


def test_driver_resident_ab_skips_string_payloads():
    """Shapes the resident tables refuse skip with JAX's reasons: string
    payloads (the registry's refusal), composite keys and the
    hierarchical wire."""
    from distributed_join_tpu.benchmarks import distributed_join as jdriver
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    base = ["--communicator", "emulated", "--n-ranks", "2",
            "--build-table-nrows", "1024", "--probe-table-nrows", "1024",
            "--iterations", "1", "--out-capacity-factor", "3.0",
            "--resident-ab", "1"]
    rec = tdriver.run(tdriver.parse_args(base + ["--string-payload-bytes",
                                                 "8"]), device="cpu")
    assert "skipped" in rec["resident_ab"]
    assert "not a scalar column" in rec["resident_ab"]["skipped"]
    rec = tdriver.run(tdriver.parse_args(base + ["--key-columns", "2"]),
                      device="cpu")
    assert rec["resident_ab"] == jdriver._resident_ab(
        None, None, None, ["k0", "k1"], 1, {})
    hier = tdriver.resident_ab(None, None, None, "key", 1,
                               {"shuffle": "hierarchical"})
    assert hier == jdriver._resident_ab(None, None, None, "key", 1,
                                        {"shuffle": "hierarchical"})
