"""The port's program cache (service/programs.py), micro-batching
(service/batching.py) and the query program cache against the JAX
package's, on the CPU.

The same calls, on the same numpy-made tables, go through both packages
on 1 rank and on 4 emulated ranks (the JAX package's 4-device mesh).
Held against the reference exactly: which calls share a program (the
cache's hits, misses, traces and evictions by reason), the retry trails,
totals, the per-request matches and rows of a micro-batch (as sorted
multisets), every refusal's message, and the query groups. The JAX
package's metrics, integrity and ``metrics_static`` variants are not
part of the port's signatures: the port's cases assert that they refuse
by name.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import aggregate as ja
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.parallel import query_exec as jq
from distributed_join_tpu.parallel.faults import (
    FaultInjectingCommunicator,
    FaultPlan,
)
from distributed_join_tpu.planning import query as jplan
from distributed_join_tpu.service import batching as jbatch
from distributed_join_tpu.service import programs as jprog
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils import tpch as jtpch
from distributed_join_tpu_torch.ops import aggregate as ta
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import query_exec as tq
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.planning import query as tplan
from distributed_join_tpu_torch.service import batching as tbatch
from distributed_join_tpu_torch.service import programs as tprog
from distributed_join_tpu_torch.table import Table

RANKS = [1, 4]


class _JCounting(jcomm.TpuCommunicator):
    def __init__(self, n_ranks):
        super().__init__(n_ranks=n_ranks)
        self.programs_built = 0

    def spmd(self, fn, *, sharded_out=None):
        self.programs_built += 1
        return super().spmd(fn, sharded_out=sharded_out)


def _squeezing(base):
    """A port communicator that counts built programs and makes the
    first ``overflow_programs`` of them report an overflow (the JAX
    package's ``FaultPlan(overflow_programs=)``)."""
    class Squeezing(base):
        def __init__(self, *a, overflow_programs=0, **k):
            super().__init__(*a, **k)
            self.programs_built = 0
            self.overflow_programs = overflow_programs

        def spmd(self, fn, **kw):
            squeeze = self.programs_built < self.overflow_programs
            self.programs_built += 1

            def wrapped(*args):
                res = fn(*args)
                if squeeze:
                    res = dataclasses.replace(res,
                                              overflow=res.overflow | True)
                return res

            return super().spmd(wrapped, **kw)
    return Squeezing


def _comms(n, overflow_programs=0):
    """(JAX communicator, its program counter, port communicator)."""
    if n == 1:
        jc = jcomm.make_communicator("local")
        counter = None
        tc = _squeezing(LocalCommunicator)(
            overflow_programs=overflow_programs)
    else:
        jc = counter = _JCounting(n)
        tc = _squeezing(EmulatedCommunicator)(
            n, overflow_programs=overflow_programs)
    if overflow_programs:
        jc = FaultInjectingCommunicator(
            jc, FaultPlan(overflow_programs=overflow_programs))
    return jc, counter, tc


def _side(seed, rows, kmax, payload):
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, kmax, rows).astype(np.int64),
            payload: rng.integers(-(1 << 40), 1 << 40, rows).astype(np.int64)}


def _tables(seed=11):
    b = _side(seed, 512, 256, "build_payload")
    p = _side(seed + 1000, 1024, 256, "probe_payload")
    return _both(b), _both(p), _oracle(b, p)


def _both(cols, valid=None):
    valid = np.ones(len(cols["key"]), bool) if valid is None else valid
    return (JTable({k: jnp.asarray(v) for k, v in cols.items()},
                   jnp.asarray(valid)),
            Table.from_numpy(cols, valid, device="cpu"))


def _oracle(b, p) -> int:
    counts = np.bincount(b["key"], minlength=int(max(b["key"].max(),
                                                     p["key"].max())) + 1)
    return int(counts[p["key"]].sum())


def _rows(cols: dict) -> np.ndarray:
    names = sorted(cols)
    a = np.stack([np.asarray(cols[n]).astype(np.int64) for n in names], 1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


# -- signatures ---------------------------------------------------------------

BASE = dict(key="key", out_capacity_factor=4.0)
VARIANTS = [
    dict(BASE),
    dict(BASE, shuffle="ragged"),               # the wire
    dict(BASE, shuffle="ppermute"),
    dict(BASE, out_capacity_factor=8.0),        # a ladder rung's sizing
    dict(BASE, shuffle_capacity_factor=3.2),
    dict(BASE, over_decomposition=2),
    dict(BASE, compression_bits=16),            # the codec's bits
    dict(BASE, skew_threshold=0.01),            # the skew policy
]


@pytest.mark.parametrize("n", RANKS)
def test_distinct_signatures_distinct_entries(n):
    """Every serving knob keys its own entry, as in the JAX package: the
    same builds, and a repeat of every variant is a pure hit. The ladder
    rung keys an entry (``rung``; JAX keys it through
    ``metrics_static``), a schema does, and table contents do not. An
    unknown option is a TypeError; the integrity and metrics switches
    key entries of their own, as in the JAX package."""
    (jb, tb), (jp, tp), _ = _tables()
    jc, _, tc = _comms(n)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    sigs = []
    for i, opts in enumerate(VARIANTS, start=1):
        sigs.append(tcache.signature(tb, tp, **opts))
        assert not tcache.get(tb, tp, **opts)[1]
        assert not jcache.get(jb, jp, **opts)[1]
        assert tc.programs_built == i
    assert len(set(sigs)) == len(VARIANTS)
    rung = tcache.signature(tb, tp, rung=1, **BASE)
    assert rung not in sigs
    jrung = jcache.signature(jb, jp, metrics_static={"retry_attempt_max": 1},
                             **BASE)
    assert jrung != jcache.signature(jb, jp, **BASE)
    # a schema keys an entry; contents do not
    import torch
    tb2 = Table(dict(tb.columns, extra=torch.zeros(tb.capacity,
                                                   dtype=torch.int32)),
                tb.valid)
    assert tcache.signature(tb2, tp, **BASE) != sigs[0]
    (_, tb3), (_, tp3), _ = _tables(seed=12)
    assert tcache.signature(tb3, tp3, **BASE) == sigs[0]
    with pytest.raises(TypeError):
        tprog.JoinSignature.of(tc, tb, tp, not_a_join_option=1)
    with pytest.raises(TypeError):
        jprog.JoinSignature.of(jc, jb, jp, not_a_join_option=1)
    # the integrity switch keys a (JoinResult, Metrics) program of its own
    assert not tcache.get(tb, tp, with_integrity=True, **BASE)[1]
    assert not jcache.get(jb, jp, with_integrity=True, **BASE)[1]
    assert tcache.get(tb, tp, with_integrity=True, **BASE)[1]
    assert jcache.get(jb, jp, with_integrity=True, **BASE)[1]
    metered = {tcache.signature(tb, tp, with_metrics=True, **BASE),
               tcache.signature(tb, tp, **BASE,
                                metrics_static={"retry_attempt_max": 1}),
               tcache.signature(tb, tp, with_integrity=True, **BASE)}
    assert len(metered) == 3 and not metered & set(sigs)
    built = tc.programs_built
    for opts in VARIANTS:
        assert tcache.get(tb, tp, **opts)[1]
        assert jcache.get(jb, jp, **opts)[1]
    assert tc.programs_built == built
    assert tcache.stats() == jcache.stats()
    digest = sigs[0].digest()
    assert tcache.predict_hit(digest) == {
        "resident": True, "persisted": False, "would_trace": False}
    assert tcache.predict_hit("0" * 64)["would_trace"]


@pytest.mark.parametrize("n", RANKS)
def test_cache_lru_bound(n):
    """A bounded cache evicts the least recently used entry; the counters
    equal JAX's."""
    (jb, tb), (jp, tp), _ = _tables()
    jc, _, tc = _comms(n)
    jcache = jprog.JoinProgramCache(jc, max_entries=2)
    tcache = tprog.JoinProgramCache(tc, max_entries=2)
    opts = [dict(key="key", out_capacity_factor=f) for f in (2.0, 3.0, 4.0)]
    for o in opts:
        tcache.get(tb, tp, **o)
        jcache.get(jb, jp, **o)
    assert len(tcache) == 2 and tcache.lru_evictions == 1
    assert tcache.get(tb, tp, **opts[2])[1]
    assert not tcache.get(tb, tp, **opts[0])[1]
    jcache.get(jb, jp, **opts[2])
    jcache.get(jb, jp, **opts[0])
    assert tcache.stats() == jcache.stats()
    assert tcache.stats()["occupancy"] == 1.0
    tcache.clear()
    assert len(tcache) == 0


@pytest.mark.parametrize("n", RANKS)
def test_repeat_query_is_run_only(n):
    """A second identical join through the cache builds no program."""
    (jb, tb), (jp, tp), want = _tables()
    jc, _, tc = _comms(n)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    r1 = tdist.distributed_inner_join(tb, tp, tc, program_cache=tcache,
                                      out_capacity_factor=4.0)
    assert tc.programs_built == 1
    r2 = tdist.distributed_inner_join(tb, tp, tc, program_cache=tcache,
                                      out_capacity_factor=4.0)
    assert tc.programs_built == 1
    assert int(r1.total) == int(r2.total) == want
    for _ in range(2):
        jr = jdist.distributed_inner_join(jb, jp, jc, program_cache=jcache,
                                          out_capacity_factor=4.0)
    assert int(jr.total) == want
    assert tcache.stats() == jcache.stats()
    assert tcache.stats()["hits"] == 1
    # a cache built for another communicator refuses, as JAX's does
    other = tprog.JoinProgramCache(LocalCommunicator())
    with pytest.raises(ValueError, match="different communicator"):
        tdist.distributed_inner_join(tb, tp, tc, program_cache=other)


@pytest.mark.parametrize("n", RANKS)
def test_retry_rung_reuses_cached_executable(n):
    """A squeeze built into the first program drives the ladder through
    two rungs (two programs); the same query again walks both rungs from
    the cache, building none, with JAX's trail and counters."""
    (jb, tb), (jp, tp), want = _tables()
    jc, jcount, tc = _comms(n, overflow_programs=1)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    trails = []
    for _ in range(2):
        tr = tdist.distributed_inner_join(tb, tp, tc, auto_retry=2,
                                          program_cache=tcache,
                                          out_capacity_factor=4.0)
        jr = jdist.distributed_inner_join(jb, jp, jc, auto_retry=2,
                                          program_cache=jcache,
                                          out_capacity_factor=4.0)
        assert tr.retry_report.n_attempts == jr.retry_report.n_attempts == 2
        assert tc.programs_built == 2
        if jcount is not None:
            assert jcount.programs_built == 2
        assert int(tr.total) == int(jr.total) == want
        trails.append([(a.action, a.overflow, a.out_capacity_factor)
                       for a in tr.retry_report.attempts])
        assert trails[-1] == [(a.action, a.overflow, a.out_capacity_factor)
                              for a in jr.retry_report.attempts]
    assert trails[0] == trails[1]
    assert tcache.stats() == jcache.stats()


# -- micro-batching -----------------------------------------------------------


def _request(i: int):
    """Request i: build keys 0..63, probe keys 0..95 cycling: every
    request has the same keys (the colliding case) and payloads tagged
    by the request."""
    build = {"key": np.arange(64, dtype=np.int64),
             "build_payload": np.arange(64, dtype=np.int64) + 1000 * i}
    probe = {"key": np.arange(128, dtype=np.int64) % 96,
             "probe_payload": np.arange(128, dtype=np.int64) + 5000 * i}
    return build, probe


def _batched(requests, jc, tc, jcache, tcache):
    jmb = jbatch.combine([(_both(b)[0], _both(p)[0]) for b, p in requests],
                         key="key", slot_build_rows=64, slot_probe_rows=128)
    tmb = tbatch.combine([(_both(b)[1], _both(p)[1]) for b, p in requests],
                         key="key", slot_build_rows=64, slot_probe_rows=128)
    assert tmb.key == jmb.key == ("key", "#batch")
    assert tmb.build.columns["#batch"].dtype.__str__() == "torch.int32"
    jres = jdist.distributed_inner_join(
        jmb.build, jmb.probe, jc, key=list(jmb.key), auto_retry=1,
        program_cache=jcache, out_capacity_factor=4.0)
    tres = tdist.distributed_inner_join(
        tmb.build, tmb.probe, tc, key=list(tmb.key), auto_retry=1,
        program_cache=tcache, out_capacity_factor=4.0)
    return (jbatch.split(jres, jmb, with_rows=True),
            tbatch.split(tres, tmb, with_rows=True))


@pytest.mark.parametrize("n", RANKS)
def test_batching_oracle_isolation_and_program_reuse(n):
    """K colliding requests in one step: each request's matches and rows
    equal its own oracle's and JAX's, every row pairs payloads of one
    request (no match crosses requests), and a second batch of other
    data in the same slots is a cache hit, as JAX's is."""
    jc, _, tc = _comms(n)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    requests = [_request(i) for i in range(3)]
    oracles = [_oracle(b, p) for b, p in requests]
    jout, tout = _batched(requests, jc, tc, jcache, tcache)
    built = tc.programs_built
    assert [r["matches"] for r in tout] == [r["matches"] for r in jout] \
        == oracles
    for i, (t, j) in enumerate(zip(tout, jout)):
        rows = t["rows"]
        assert "#batch" not in rows and set(rows) == set(j["rows"])
        assert rows["build_payload"].size == oracles[i]
        np.testing.assert_array_equal(_rows(rows), _rows(j["rows"]))
        assert np.all((rows["build_payload"] >= 1000 * i)
                      & (rows["build_payload"] < 1000 * i + 64))
        assert np.all((rows["probe_payload"] >= 5000 * i)
                      & (rows["probe_payload"] < 5000 * i + 128))
        assert not t["overflow"]
    shifted = [_request(i + 7) for i in range(3)]
    jout, tout = _batched(shifted, jc, tc, jcache, tcache)
    assert tc.programs_built == built
    assert [r["matches"] for r in tout] == [r["matches"] for r in jout] \
        == [_oracle(b, p) for b, p in shifted]
    assert tcache.stats() == jcache.stats()
    assert tcache.stats()["hits"] == 1


def test_batching_validation():
    """combine refuses what JAX's refuses, with its messages."""
    b0, p0 = _request(0)
    jb0, tb0 = _both(b0)
    jp0, tp0 = _both(p0)
    other = {"key": np.arange(64, dtype=np.int64),
             "other": np.arange(64, dtype=np.int32)}
    seg = {"key": np.arange(64, dtype=np.int64),
           "#batch": np.arange(64, dtype=np.int32)}
    (jo, to), (js, ts) = _both(other), _both(seg)
    cases = [
        (lambda m, b, p, o, s: m.combine([], key="key")),
        (lambda m, b, p, o, s: m.combine([(b, p), (o, p)], key="key")),
        (lambda m, b, p, o, s: m.combine([(s, p)], key="key")),
        (lambda m, b, p, o, s: m.combine([(b, p)], key="key",
                                         slot_build_rows=32)),
        (lambda m, b, p, o, s: m.combine([(b, p)], key="nokey")),
    ]
    for case in cases:
        with pytest.raises(ValueError) as je:
            case(jbatch, jb0, jp0, jo, js)
        with pytest.raises(ValueError) as te:
            case(tbatch, tb0, tp0, to, ts)
        assert str(te.value) == str(je.value)


def test_mixed_dtype_composite_key_joins_like_jax():
    """The segment column is an int32 key beside an int64 key: the
    composite-key path takes keys of mixed dtypes on 1 and 4 ranks, at
    over-decomposition 2, with JAX's totals and rows."""
    rng = np.random.default_rng(9)
    b = {"key": rng.integers(0, 40, 300).astype(np.int64),
         "k2": rng.integers(0, 3, 300).astype(np.int32),
         "bv": rng.integers(0, 1000, 300).astype(np.int64)}
    p = {"key": rng.integers(0, 40, 500).astype(np.int64),
         "k2": rng.integers(0, 3, 500).astype(np.int32),
         "pv": rng.integers(0, 1000, 500).astype(np.int64)}
    (jb, tb), (jp, tp) = _both(b), _both(p)
    for n in RANKS:
        jc, _, tc = _comms(n)
        jr = jdist.distributed_inner_join(jb, jp, jc, key=["key", "k2"],
                                          over_decomposition=2,
                                          out_capacity_factor=4.0)
        tr = tdist.distributed_inner_join(tb, tp, tc, key=["key", "k2"],
                                          over_decomposition=2,
                                          out_capacity_factor=4.0)
        assert int(tr.total) == int(jr.total) > 0
        tcols, tv = tr.table.to_numpy()
        np.testing.assert_array_equal(
            _rows({k: v[tv] for k, v in tcols.items()}),
            _rows({k: np.asarray(v)[np.asarray(jr.table.valid)]
                   for k, v in jr.table.columns.items()}))


# -- the query program cache --------------------------------------------------


@pytest.fixture(scope="module")
def q3_tables():
    base = jtpch.generate_tpch_query_tables(seed=7, scale_factor=0.004)
    jt = jtpch.query_filters(base, "q3")
    tt = {name: Table.from_numpy(
        {c: np.asarray(v) for c, v in t.columns.items()},
        np.asarray(t.valid), device="cpu") for name, t in jt.items()}
    return jt, tt


@pytest.mark.parametrize("n", RANKS)
def test_query_program_cache_equals_jax(n, q3_tables):
    """``distributed_query(program_cache=)`` on Q3: the repeat is a hit
    (``cache_hit``) with the groups unchanged, a rung keys its own
    entry, and the counters equal JAX's; a cache of another
    communicator refuses as JAX's does."""
    jt, tt = q3_tables
    jc, _, tc = _comms(n)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    jplan_, tplan_ = jplan.tpch_query_plan("q3"), tplan.tpch_query_plan("q3")
    spec = tplan_.aggregate
    gk = list(spec.group_keys)
    frames = []
    for _ in range(2):
        tr = tq.distributed_query(tt, tplan_, tc, auto_retry=4,
                                  program_cache=tcache)
        jr = jq.distributed_query(jt, jplan_, jc, auto_retry=4,
                                  program_cache=jcache, with_metrics=False)
        assert tr.cache_hit == jr.cache_hit
        assert tr.retry_attempts == jr.retry_attempts
        frames.append(ta.groups_frame(tr.table, spec, gk))
        want = ja.groups_frame(jr.table, jplan_.aggregate, gk)
        assert ta.frames_equal(frames[-1], {c: want[c].to_numpy()
                                            for c in want.columns})
    assert ta.frames_equal(frames[0], frames[1])
    assert tr.cache_hit is True
    # another rung's sizing keys another program
    tq.distributed_query(tt, tplan_, tc, program_cache=tcache,
                         out_capacity_factor=2.4)
    jq.distributed_query(jt, jplan_, jc, program_cache=jcache,
                         with_metrics=False, out_capacity_factor=2.4)
    assert tcache.stats() == jcache.stats()
    sig = tq.QuerySignature.of(tc, tplan_, tt, rung=0)
    assert sig.plan_digest == jplan_.digest()
    with pytest.raises(ValueError, match="different communicator") as te:
        tq.distributed_query(tt, tplan_, tc, program_cache=tprog.
                             JoinProgramCache(LocalCommunicator()))
    with pytest.raises(ValueError) as je:
        jq.distributed_query(jt, jplan_, jc, program_cache=jprog.
                             JoinProgramCache(jcomm.make_communicator(
                                 "local")))
    assert str(te.value) == str(je.value)
