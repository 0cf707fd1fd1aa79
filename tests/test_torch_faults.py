"""PyTorch port vs the JAX package: fault injection on the CPU.

Mirrors the non-corruption cases of ``tests/test_faults.py`` on the
port's ``FaultInjectingCommunicator`` and ``FaultPlan``
(``parallel/faults.py``), run on ``EmulatedCommunicator`` against the
JAX package's wrapper on its 8 virtual CPU devices (tests/conftest.py):
the same plans give the same outcomes — the same errors and messages,
the same ladder trails rung for rung, the same batch-loop totals and
failed batches, the same plan-validation verdicts. The corruption modes
build a wrapper and their verified joins recover (the modes against the
wire digests, seam by seam, are ``tests/test_torch_integrity.py``); an
unknown mode refuses by name. The gloo cases are in
``tests/test_torch_multiprocess.py``.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu as jdj
from distributed_join_tpu.parallel import faults as jfaults
from distributed_join_tpu.parallel import out_of_core as jooc
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils.generators import (
    generate_build_probe_tables as jgenerate,
)
from distributed_join_tpu_torch.ops.partition import radix_hash_partition
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import faults as tfaults
from distributed_join_tpu_torch.parallel import out_of_core as tooc
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
)
from distributed_join_tpu_torch.parallel.faults import (
    FaultInjectedError,
    FaultInjectingCommunicator,
    FaultPlan,
    plan_from_record,
)
from distributed_join_tpu_torch.parallel.shuffle import shuffle_ragged
from distributed_join_tpu_torch.table import Table

LADDER_FIELDS = ("attempt", "action", "overflow", "shuffle_capacity_factor",
                 "out_capacity_factor", "out_rows_per_rank",
                 "compression_bits", "hh_build_capacity",
                 "hh_probe_capacity", "hh_out_capacity")
OOC_OPTS = dict(out_capacity_factor=3.0, shuffle_capacity_factor=3.0)


def _tables(seed=11, build=512, probe=1024, rand_max=256):
    """The JAX test's tables (its generator), as numpy."""
    b, p = jgenerate(seed=seed, build_nrows=build, probe_nrows=probe,
                     rand_max=rand_max, selectivity=0.5)
    return ({k: np.asarray(v) for k, v in b.columns.items()},
            np.asarray(b.valid),
            {k: np.asarray(v) for k, v in p.columns.items()},
            np.asarray(p.valid))


def _jt(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _tt(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _jcomm(plan=None):
    inner = jdj.make_communicator("tpu", n_ranks=8)
    return inner if plan is None else jfaults.FaultInjectingCommunicator(
        inner, jfaults.FaultPlan(**dataclasses.asdict(plan)))


def _tcomm(plan=None):
    inner = EmulatedCommunicator(8)
    return inner if plan is None else FaultInjectingCommunicator(inner, plan)


def _trail(report):
    return [{f: getattr(a, f) for f in LADDER_FIELDS}
            for a in report.attempts]


def _both(plan, seed=11, build=512, probe=1024, rand_max=256, **opts):
    """One ``distributed_inner_join`` through each package's wrapper."""
    bc, bv, pc, pv = _tables(seed, build, probe, rand_max)
    want = jdj.distributed_inner_join(_jt(bc, bv), _jt(pc, pv),
                                      _jcomm(plan), **opts)
    got = tdist.distributed_inner_join(_tt(bc, bv), _tt(pc, pv),
                                       _tcomm(plan), **opts)
    return got, want


# -- the auto_retry ladder, branch by branch ----------------------------------


def test_injected_overflow_drives_capacity_doubling():
    got, want = _both(FaultPlan(overflow_programs=2), auto_retry=3,
                      out_capacity_factor=3.0)
    assert not bool(got.overflow)
    assert int(got.total) == int(want.total) > 0
    assert _trail(got.retry_report) == _trail(want.retry_report)
    assert [a.action for a in got.retry_report.attempts] == [
        "initial", "double_capacities", "double_capacities"]
    assert [a.overflow for a in got.retry_report.attempts] == [
        True, True, False]
    rec = got.retry_report.as_record()
    assert rec["n_attempts"] == 3 and rec["resolved"]
    json.dumps(rec)


def test_injected_overflow_widens_compression_bits_first():
    got, want = _both(FaultPlan(overflow_programs=2), seed=7, auto_retry=4,
                      out_capacity_factor=3.0, shuffle_capacity_factor=2.5,
                      compression_bits=8)
    assert not bool(got.overflow)
    assert int(got.total) == int(want.total) > 0
    assert _trail(got.retry_report) == _trail(want.retry_report)
    assert [a.compression_bits for a in got.retry_report.attempts] == [
        8, 16, 32]


def test_injected_overflow_jumps_skew_capacities():
    got, want = _both(FaultPlan(overflow_programs=1), seed=9, build=512,
                      probe=2048, rand_max=128, auto_retry=1,
                      out_capacity_factor=4.0, shuffle_capacity_factor=4.0,
                      skew_threshold=0.05)
    assert not bool(got.overflow)
    assert int(got.total) == int(want.total) > 0
    assert _trail(got.retry_report) == _trail(want.retry_report)
    a0, a1 = got.retry_report.attempts
    assert a1.hh_probe_capacity >= 2048 // 8
    assert a1.hh_out_capacity >= 2048 // 8


def test_injected_overflow_is_a_device_flag():
    """The squeeze ORs a device True into ``overflow``: the step's
    result stays a tensor on the tables' device, nothing read back."""
    bc, bv, pc, pv = _tables()
    fn = tdist.make_distributed_join(
        _tcomm(FaultPlan(overflow_programs=1)), out_capacity_factor=3.0)
    res = fn(_tt(bc, bv), _tt(pc, pv))
    assert isinstance(res.overflow, torch.Tensor)
    assert res.overflow.dtype == torch.bool and bool(res.overflow)


# -- dispatch faults ----------------------------------------------------------


@pytest.mark.parametrize("plan", [
    FaultPlan(fail_dispatches=1),
    FaultPlan(drop_dispatches=(1,)),
    FaultPlan(fail_after_dispatches=0),
])
def test_fault_injected_dispatch_failure_raises(plan):
    """The same plan raises the same error with the same message in both
    packages."""
    bc, bv, pc, pv = _tables(seed=17)
    msgs = []
    with pytest.raises(jfaults.FaultInjectedError) as jerr:
        jdj.distributed_inner_join(_jt(bc, bv), _jt(pc, pv), _jcomm(plan),
                                   out_capacity_factor=3.0)
    with pytest.raises(FaultInjectedError, match="injected") as terr:
        tdist.distributed_inner_join(_tt(bc, bv), _tt(pc, pv), _tcomm(plan),
                                     out_capacity_factor=3.0)
    msgs = str(terr.value), str(jerr.value)
    assert msgs[0] == msgs[1]


def test_drop_dispatches_drops_exactly_those():
    class Stub:
        n_ranks = 2
        name = "stub"

        def spmd(self, fn, *, sharded_out=None, local_inputs=False):
            return fn

    comm = FaultInjectingCommunicator(Stub(), FaultPlan(drop_dispatches=(2,)))
    prog = comm.spmd(lambda: 1)
    assert prog() == 1
    with pytest.raises(FaultInjectedError, match="drop #2"):
        prog()
    assert prog() == 1


def test_dispatch_delay_defers_until_after_n_dispatches():
    """The first N dispatches run at full speed, every later one sleeps
    (a replica that serves and then wedges)."""
    class Stub:
        n_ranks = 2
        name = "stub"

        def spmd(self, fn, *, sharded_out=None, local_inputs=False):
            return fn

    comm = FaultInjectingCommunicator(
        Stub(), FaultPlan(dispatch_delay_s=0.25, delay_after_dispatches=2))
    prog = comm.spmd(lambda: 1)
    for _ in range(2):
        t0 = time.perf_counter()
        assert prog() == 1
        assert time.perf_counter() - t0 < 0.2
    t0 = time.perf_counter()
    assert prog() == 1
    assert time.perf_counter() - t0 >= 0.25


def test_plan_from_record_roundtrip_and_unknown_key_refusal():
    plan = FaultPlan(seed=7, dispatch_delay_s=1.5, delay_after_dispatches=3,
                     drop_dispatches=(2, 5), corrupt_mode="bit_flip",
                     corrupt_collectives=2)
    rec = dataclasses.asdict(plan)
    assert plan_from_record(rec) == plan
    assert plan_from_record(json.loads(json.dumps(rec))) == plan
    # the JAX package's plan has exactly these fields, and reads the record
    assert rec == dataclasses.asdict(jfaults.plan_from_record(rec))
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError, match="unknown FaultPlan field"):
            mod.plan_from_record({"dispatch_delay": 1.0})
    assert tfaults.CORRUPTION_MODES == jfaults.CORRUPTION_MODES


@pytest.mark.parametrize("plan", [FaultPlan(corrupt_mode="bit_flip",
                                            corrupt_collectives=1),
                                  FaultPlan(corrupt_mode="misroute"),
                                  FaultPlan(corrupt_collectives=2)])
def test_corruption_modes_refuse_by_name(plan):
    """The corruption modes are ported: each plan builds a wrapper, and a
    verified join through it returns the clean rows (a live budget
    through the ``retry_integrity`` rung, an empty one on its first
    attempt); only an unknown mode refuses, by name."""
    comm = FaultInjectingCommunicator(EmulatedCommunicator(2), plan)
    with pytest.raises(ValueError, match="unknown corrupt_mode"):
        FaultInjectingCommunicator(EmulatedCommunicator(2),
                                   FaultPlan(corrupt_mode="bogus"))
    bc, bv, pc, pv = _tables()
    clean = tdist.distributed_inner_join(
        _tt(bc, bv), _tt(pc, pv), EmulatedCommunicator(2), **OOC_OPTS)
    res = tdist.distributed_inner_join(
        _tt(bc, bv), _tt(pc, pv), comm, verify_integrity=True,
        auto_retry=2, **OOC_OPTS)
    live = plan.corrupt_mode is not None and plan.corrupt_collectives > 0
    assert [a.action for a in res.retry_report.attempts] == (
        ["initial", "retry_integrity"] if live else ["initial"])
    assert [a.integrity_ok for a in res.retry_report.attempts] == (
        [False, True] if live else [True])
    assert res.integrity_report.ok
    assert res.integrity_report.checked_pairs == 2 * 2 * 2
    assert int(res.total) == int(clean.total)


def test_wrapper_forwards_the_counters_and_host_reads():
    """A ragged join through the wrapper counts its wire and its one plan
    read on the wrapped communicator, as without it."""
    bc, bv, pc, pv = _tables()
    counts = {}
    for name, comm in (("plain", EmulatedCommunicator(4)),
                       ("wrapped", None)):
        inner = EmulatedCommunicator(4) if comm is None else comm
        c = FaultInjectingCommunicator(inner, FaultPlan()) \
            if comm is None else comm
        res = tdist.distributed_inner_join(
            _tt(bc, bv), _tt(pc, pv), c, shuffle="ragged",
            out_capacity_factor=4.0)
        counts[name] = (int(res.total), c.counters(), inner.counters())
    assert counts["wrapped"][0] == counts["plain"][0] > 0
    assert counts["wrapped"][1] == counts["wrapped"][2] == counts["plain"][1]
    assert counts["plain"][1]["host_reads"] == 4  # one plan read a rank


# -- the ragged plan's validation ---------------------------------------------


def _ragged_total(comm, cols, valid, out_capacity):
    def run(t):
        pt = radix_hash_partition(t, ["key"], comm.n_ranks)
        got, ovf = shuffle_ragged(comm, pt, out_capacity)
        return got.valid.sum()[None], ovf[None]

    nvalid, ovf = comm.spmd(run)(_tt(cols, valid))
    return int(nvalid.sum()), bool(ovf.any())


def test_plan_validation_catches_rank_inconsistent_counts():
    """A corrupted plan gather gives the ranks different plans; the
    port's validation records it, trips the flag and raises at the
    check, as the JAX package's does."""
    bc, bv, _, _ = _tables(seed=23, build=1024, probe=8)
    comm = _tcomm(FaultPlan(corrupt_plan_gathers=1, seed=3))
    with tfaults.validate_plans():
        _, ovf = _ragged_total(comm, bc, bv, 4 * 1024 // 8)
    assert ovf
    with pytest.raises(tfaults.PlanValidationError,
                       match="ragged plan inconsistent"):
        tfaults.check_plan_violations()
    tfaults.check_plan_violations()   # cleared by the raise
    # the clean wrapper's plan passes
    with tfaults.validate_plans():
        n, ovf = _ragged_total(_tcomm(FaultPlan()), bc, bv, 4 * 1024 // 8)
    tfaults.check_plan_violations()
    assert n == int(bv.sum()) and not ovf


def test_plan_validation_raises_through_distributed_inner_join():
    for seed in (1, 5):
        plan = FaultPlan(corrupt_plan_gathers=1, seed=seed)
        bc, bv, pc, pv = _tables(seed=37)
        with jfaults.validate_plans(), pytest.raises(
                jfaults.PlanValidationError):
            jdj.distributed_inner_join(_jt(bc, bv), _jt(pc, pv),
                                       _jcomm(plan), shuffle="ragged",
                                       auto_retry=2, out_capacity_factor=3.0)
        with tfaults.validate_plans(), pytest.raises(
                tfaults.PlanValidationError):
            tdist.distributed_inner_join(_tt(bc, bv), _tt(pc, pv),
                                         _tcomm(plan), shuffle="ragged",
                                         auto_retry=2,
                                         out_capacity_factor=3.0)


# -- the out-of-core batch loop -----------------------------------------------


@pytest.fixture(scope="module")
def ooc_tables():
    return _tables(seed=29, build=1500, probe=3000, rand_max=700)


@pytest.fixture(scope="module")
def ooc_reference(ooc_tables):
    bc, bv, pc, pv = ooc_tables
    per_batch = {}
    total, overflow = tooc.keyrange_batched_join(
        _tt(bc, bv), _tt(pc, pv), _tcomm(), n_batches=4, warmup=False,
        on_batch_result=lambda i, res: per_batch.__setitem__(
            i, int(res.total)), **OOC_OPTS)
    assert not overflow and sum(per_batch.values()) == total
    jtotal, _ = jooc.keyrange_batched_join(
        _jt(bc, bv), _jt(pc, pv), _jcomm(), n_batches=4, warmup=False,
        **OOC_OPTS)
    assert int(jtotal) == total
    return total, per_batch


def _loops(tables, plan, **kw):
    bc, bv, pc, pv = tables
    out = []
    for loop, t, comm in ((tooc.keyrange_batched_join, _tt, _tcomm(plan)),
                          (jooc.keyrange_batched_join, _jt, _jcomm(plan))):
        stats = {}
        total, overflow = loop(t(bc, bv), t(pc, pv), comm, n_batches=4,
                               warmup=False, stats=stats, **kw, **OOC_OPTS)
        out.append((int(total), bool(overflow), stats["failed_batches"]))
    return out


def test_batch_retry_recovers_transient_dispatch_failure(ooc_tables,
                                                         ooc_reference):
    got, want = _loops(ooc_tables, FaultPlan(fail_dispatches=1),
                       batch_retries=1, batch_retry_backoff_s=0.01)
    assert got == want == (ooc_reference[0], False, [])


def test_graceful_degradation_reports_partial_totals(ooc_tables,
                                                     ooc_reference):
    total0, per_batch = ooc_reference
    got, want = _loops(ooc_tables, FaultPlan(fail_dispatches=2),
                       batch_retries=1, batch_retry_backoff_s=0.01,
                       on_batch_failure="continue")
    assert got == want
    assert got[2] == [0] and got[0] == total0 - per_batch[0]


def test_killed_run_resumes_bit_exact_from_manifest(tmp_path, ooc_tables,
                                                    ooc_reference):
    """A persistent outage after two dispatches kills the run with batch
    0 recorded; the same call on a healthy communicator resumes from
    batch 1 and reproduces the uninterrupted total."""
    total0, per_batch = ooc_reference
    bc, bv, pc, pv = ooc_tables
    path = str(tmp_path / "m.json")
    with pytest.raises(FaultInjectedError, match="persistent outage"):
        tooc.keyrange_batched_join(
            _tt(bc, bv), _tt(pc, pv),
            _tcomm(FaultPlan(fail_after_dispatches=2)), n_batches=4,
            warmup=False, manifest_path=path, **OOC_OPTS)
    data = json.load(open(path))
    assert set(data["batches"]) == {"0"} and data["failures"]
    assert data["batches"]["0"]["total"] == per_batch[0]
    seen, stats = [], {}
    total, overflow = tooc.keyrange_batched_join(
        _tt(bc, bv), _tt(pc, pv), _tcomm(), n_batches=4, warmup=False,
        manifest_path=path, stats=stats,
        on_batch_result=lambda i, res: seen.append(i), **OOC_OPTS)
    assert total == total0 and not overflow
    assert stats["resumed_batches"] == [0] and seen == [1, 2, 3]


def test_batch_deadline_fails_a_batch_that_does_not_settle(
        ooc_tables, ooc_reference, monkeypatch):
    """``batch_deadline_s``: a batch whose total does not reach the host
    in time fails with ``HangError`` under the degradation contract and
    the others settle: the partial total, as a failed dispatch gives.
    (On the CPU a batch settles at once, so its settle is delayed here;
    on a card the delay is a device stall, chip_smoke phase 19.)"""
    total0, per_batch = ooc_reference
    bc, bv, pc, pv = ooc_tables
    real_get = tooc._Scalars.get
    calls = []

    def slow_get(self):
        calls.append(1)
        if len(calls) == 3:   # the third batch's settle
            time.sleep(1.0)
        return real_get(self)

    monkeypatch.setattr(tooc._Scalars, "get", slow_get)
    stats = {}
    total, overflow = tooc.keyrange_batched_join(
        _tt(bc, bv), _tt(pc, pv), _tcomm(), n_batches=4, warmup=False,
        batch_deadline_s=0.3, on_batch_failure="continue", stats=stats,
        **OOC_OPTS)
    assert stats["failed_batches"] == [2]
    assert total == total0 - per_batch[2] and not overflow
    time.sleep(1.0)   # the abandoned settle's worker finishes
    monkeypatch.setattr(tooc._Scalars, "get", real_get)
    # a clean run under the deadline is the plain run
    clean = tooc.keyrange_batched_join(
        _tt(bc, bv), _tt(pc, pv), _tcomm(), n_batches=4, warmup=True,
        batch_deadline_s=30.0, **OOC_OPTS)
    assert clean == (total0, False)
