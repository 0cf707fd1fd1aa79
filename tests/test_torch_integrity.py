"""The port's wire integrity (parallel/integrity.py) on the CPU.

The JAX package's step-level integrity programs do not run on this
toolchain (their ``with_integrity`` step raises shard_map's
``out_specs`` replication error), but its digest functions are plain
``jnp`` and numpy and do. So:

- every digest function is held bit for bit against the JAX package's
  (``row_digests``, ``padded_block_digests``, ``masked_block_digests``,
  ``segment_digests``, ``row_digests_np``, ``table_digest_np``) on seeded
  numpy inputs: int64, int32, int8, uint8 byte planes (the u32 word fold)
  and odd-width byte planes, float32 without -0.0 (the port folds -0.0
  onto 0.0, the JAX package does not), with sums that wrap past 2^63;
  float64 against the port's own numpy mirror (the JAX package's f64
  hash is inexact on XLA:CPU);
- each rank's sent digests in a verified step equal the JAX package's
  ``padded_block_digests`` over its own ``to_padded`` of that rank's
  partition;
- the host check (``verify_digests``, ``IntegrityError``) against the
  JAX package's on the same metric blocks;
- step-level detection against the written expectations of
  ``tests/test_faults.py``, ``tests/test_hierarchy.py``,
  ``tests/test_sortpath.py``, ``tests/test_aggregate.py``,
  ``tests/test_resident.py``, ``tests/test_service.py`` and
  ``tests/test_chaos.py``: clean verification on every wire at 4 and 8
  emulated ranks and at 2 x 2, every corruption mode caught on every
  seam, the ``retry_integrity`` rung recovering, the last attempt
  raising and evicting, and integrity off running the step it ran
  before.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.parallel import integrity as jint
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils.generators import (
    generate_build_probe_tables as jgenerate,
)
from distributed_join_tpu_torch.ops.aggregate import AggregateSpec
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import integrity as tint
from distributed_join_tpu_torch.parallel import out_of_core as tooc
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.parallel.faults import (
    CORRUPTION_MODES,
    FaultInjectingCommunicator,
    FaultPlan,
)
from distributed_join_tpu_torch.parallel.integrity import (
    IntegrityError,
    IntegrityReport,
)
from distributed_join_tpu_torch.service.programs import JoinProgramCache
from distributed_join_tpu_torch.service.resident import (
    ResidentTableRegistry,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils.generators import (
    generate_build_probe_tables,
    generate_composite_build_probe_tables,
)

OUT = dict(out_capacity_factor=3.0)


def _u64(x) -> np.ndarray:
    """Digests as uint64 (the port's int64 bit patterns viewed)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint64) if a.dtype == np.int64 else a


def _host_columns(seed=3, rows=256) -> dict:
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal(rows).astype(np.float32)
    f32[f32 == 0] = 1.0          # no -0.0 (nor 0.0): see the docstring
    return {
        "k64": rng.integers(-2**63, 2**63 - 1, rows, dtype=np.int64),
        "k32": rng.integers(-2**31, 2**31 - 1, rows, dtype=np.int32),
        "k8": rng.integers(-128, 127, rows, dtype=np.int8),
        "u8": rng.integers(0, 255, rows, dtype=np.uint8),
        "f32": f32,
        "words": rng.integers(0, 256, (rows, 16), dtype=np.uint8),
        "odd": rng.integers(0, 256, (rows, 3), dtype=np.uint8),
    }


def _both(cols: dict):
    return ({k: jnp.asarray(v) for k, v in cols.items()},
            {k: torch.from_numpy(v) for k, v in cols.items()})


# -- the digest functions, bit for bit ----------------------------------


@pytest.mark.parametrize("names", [("k64",), ("k32",), ("k8",), ("u8",),
                                   ("f32",), ("words",), ("odd",),
                                   ("k64", "k32", "words", "f32", "odd")],
                         ids="+".join)
def test_row_digests_equal_jax(names):
    cols = {n: _host_columns()[n] for n in names}
    j, t = _both(cols)
    want = np.asarray(jint.row_digests(j))
    got = _u64(tint.row_digests(t))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tint.row_digests_np(cols), want)
    np.testing.assert_array_equal(jint.row_digests_np(cols), want)


def test_float64_digests_equal_the_port_numpy_mirror():
    rng = np.random.default_rng(9)
    f64 = rng.uniform(-1e6, 1e6, 512)
    cols = {"f64": f64, "k": rng.integers(0, 1 << 40, 512, dtype=np.int64)}
    got = _u64(tint.row_digests({k: torch.from_numpy(v)
                                 for k, v in cols.items()}))
    np.testing.assert_array_equal(got, tint.row_digests_np(cols))


def test_block_and_segment_digests_equal_jax_and_wrap():
    cols = _host_columns(seed=5, rows=8 * 64)
    blocks = {k: v.reshape((8, 64) + v.shape[1:]) for k, v in cols.items()}
    j, t = _both(blocks)
    counts = np.array([0, 1, 17, 64, 63, 32, 5, 40], np.int32)
    want = np.asarray(jint.padded_block_digests(j, jnp.asarray(counts)))
    got = tint.padded_block_digests(t, torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and (got >= 0).all()
    # the block sums wrap: the unreduced sums pass 2^64
    rd = jint.row_digests_np({k: v.reshape((512,) + v.shape[2:])
                              for k, v in blocks.items()}).reshape(8, 64)
    assert sum(int(x) for x in rd[3]) > 1 << 64
    mask = np.random.default_rng(6).random((8, 64)) < 0.5
    np.testing.assert_array_equal(
        tint.masked_block_digests(t, torch.from_numpy(mask)).numpy(),
        np.asarray(jint.masked_block_digests(j, jnp.asarray(mask))))
    flat = tint.row_digests({k: torch.from_numpy(v) for k, v in cols.items()})
    starts = np.array([0, 10, 100, 500, 600, 3])
    sizes = np.array([10, 90, 400, 20, 5, 0])
    np.testing.assert_array_equal(
        tint.segment_digests(flat, starts, sizes).numpy(),
        np.asarray(jint.segment_digests(jnp.asarray(_u64(flat)),
                                        jnp.asarray(starts),
                                        jnp.asarray(sizes))))
    # host sequences and tensors give one answer
    np.testing.assert_array_equal(
        tint.segment_digests(flat, list(starts), list(sizes)).numpy(),
        tint.segment_digests(flat, torch.from_numpy(starts),
                             torch.from_numpy(sizes)).numpy())
    assert int(tint.fold63(torch.tensor([-1]))[0]) == (1 << 63) - 1


def test_table_digest_np_equals_jax_order_free_and_content_bound():
    cols = _host_columns(seed=7, rows=64)
    d0 = tint.table_digest_np(cols)
    assert d0 == jint.table_digest_np(cols)
    perm = np.random.default_rng(5).permutation(64)
    assert tint.table_digest_np({k: v[perm] for k, v in cols.items()}) == d0
    tampered = {k: v.copy() for k, v in cols.items()}
    tampered["k64"][17] ^= 1
    assert tint.table_digest_np(tampered) != d0
    assert tint.table_digest_np({k: v[1:] for k, v in cols.items()}) != d0
    assert tint.table_digest_np({}) == jint.table_digest_np({}) == 0


# -- the host check -----------------------------------------------------


def test_verify_digests_pairs_and_attribution():
    """JAX's hand-built 2-rank block (tests/test_chaos.py:70-95): rank
    s's sent_to_d meets rank d's recv_from_s; one changed lane names its
    (channel, src, dst), in both packages."""
    per_rank = {"t.integrity.sent_to_0": [10, 20],
                "t.integrity.sent_to_1": [11, 21],
                "t.integrity.recv_from_0": [10, 11],
                "t.integrity.recv_from_1": [20, 21],
                "t.rows_shuffled": [5, 5]}
    for mod in (tint, jint):
        rep = mod.verify_digests({"n_ranks": 2, "per_rank": per_rank})
        assert rep.ok and rep.checked_pairs == 4 and rep.channels == ("t",)
    bad = dict(per_rank, **{"t.integrity.recv_from_1": [20, 99]})
    reps = [mod.verify_digests({"n_ranks": 2, "per_rank": bad})
            for mod in (tint, jint)]
    assert reps[0].as_record() == reps[1].as_record()
    assert reps[0].mismatches == ({"channel": "t", "src": 1, "dst": 1,
                                   "sent": 21, "recv": 99},)
    json.dumps(reps[0].as_record())
    assert tint.verify_digests({"n_ranks": 2, "per_rank": bad},
                               channels=["u"]).checked_pairs == 0


def test_integrity_error_message_names_pairs():
    mism = tuple({"channel": "build", "src": i, "dst": i + 1, "sent": 1,
                  "recv": 2} for i in range(6))
    for n in (1, 6):
        args = dict(ok=False, checked_pairs=128, channels=("build",),
                    mismatches=mism[:n])
        got = str(IntegrityError(IntegrityReport(**args)))
        assert got == str(jint.IntegrityError(jint.IntegrityReport(**args)))
        assert "build[0->1]" in got and "do not trust this result" in got
    assert "(+2 more)" in got
    with pytest.raises(ValueError, match="with_integrity=True"):
        tint.verify_join_result(object())


# -- the step's sent digests against the JAX package's partition --------


@pytest.mark.parametrize("n", [4, 8])
def test_sent_digests_equal_jax_padded_blocks(n):
    """Each rank's ``build.integrity.sent_to_j`` in a verified step is
    the JAX package's ``padded_block_digests`` over its own
    ``radix_hash_partition(...).to_padded`` of that rank's rows."""
    b, p = jgenerate(seed=21, build_nrows=2048, probe_nrows=4096,
                     rand_max=1024, selectivity=0.5)
    bc = {k: np.asarray(v) for k, v in b.columns.items()}
    bv = np.asarray(b.valid)
    pc = {k: np.asarray(v) for k, v in p.columns.items()}
    pv = np.asarray(p.valid)
    fn = tdist.make_distributed_join(EmulatedCommunicator(n),
                                     with_integrity=True, **OUT)
    res = fn(Table.from_numpy(bc, bv, device="cpu"),
             Table.from_numpy(pc, pv, device="cpu"))
    per_rank = res.telemetry.to_dict()["per_rank"]
    m = 2048 // n
    for r in range(n):
        local = JTable({k: jnp.asarray(v[r * m:(r + 1) * m])
                        for k, v in bc.items()},
                       jnp.asarray(bv[r * m:(r + 1) * m]))
        pt = jpart.radix_hash_partition(local, ["key"], n)
        padded, counts, overflow, _ = pt.to_padded(m)
        assert not bool(overflow)
        want = np.asarray(jint.padded_block_digests(padded, counts))
        got = [per_rank[f"build.integrity.sent_to_{j}"][r] for j in range(n)]
        np.testing.assert_array_equal(np.array(got, np.int64), want)
    assert tint.verify_join_result(res).ok


# -- clean verification on every wire -----------------------------------


def _tables(seed=3, rows=2048):
    return generate_build_probe_tables(
        seed=seed, build_nrows=rows, probe_nrows=2 * rows, rand_max=rows,
        selectivity=0.5, device="cpu")


def _multiset(res) -> np.ndarray:
    cols, valid = res.table.to_numpy()
    return np.sort(tint.row_digests_np(
        {k: v[valid] for k, v in cols.items()}))


WIRES = {
    "padded": dict(),
    "padded_k2": dict(over_decomposition=2, out_capacity_factor=4.0),
    "ppermute": dict(shuffle="ppermute"),
    "compressed": dict(compression_bits=16, auto_retry=2),
    "ragged": dict(shuffle="ragged", over_decomposition=2,
                   out_capacity_factor=4.0),
    "segmented": dict(sort_mode="segmented", sort_segments=4,
                      shuffle_capacity_factor=3.0, out_capacity_factor=4.0),
}


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("n", [4, 8])
def test_clean_verification_on_every_wire(n, wire):
    b, p = _tables()
    opts = dict(OUT, **WIRES[wire])
    plain = tdist.distributed_inner_join(b, p, EmulatedCommunicator(n), **opts)
    res = tdist.distributed_inner_join(b, p, EmulatedCommunicator(n),
                                       verify_integrity=True, **opts)
    rep = res.integrity_report
    assert rep.ok and rep.checked_pairs == 2 * n * n
    assert rep.channels == ("build", "probe")
    assert int(res.total) == int(plain.total)
    np.testing.assert_array_equal(_multiset(res), _multiset(plain))
    assert [a.integrity_ok for a in res.retry_report.attempts][-1] is True


@pytest.mark.parametrize("codec", ["off", "on"])
def test_clean_verification_hierarchical_2x2(codec):
    b, p = _tables()
    opts = dict(OUT, shuffle="hierarchical", dcn_codec=codec, auto_retry=3)
    plain = tdist.distributed_inner_join(
        b, p, EmulatedCommunicator(4, n_slices=2), **opts)
    res = tdist.distributed_inner_join(
        b, p, EmulatedCommunicator(4, n_slices=2), verify_integrity=True,
        **opts)
    assert res.integrity_report.ok
    assert res.integrity_report.checked_pairs == 2 * 4 * 4
    np.testing.assert_array_equal(_multiset(res), _multiset(plain))


def test_clean_verification_strings_on_the_ragged_wire():
    """String payloads ride the byte-exact wire: their planes are
    digested (the JAX coverage contract), two string columns included."""
    b, p, keys = generate_composite_build_probe_tables(
        seed=4, build_nrows=2048, probe_nrows=2048, string_payload_len=16,
        string_payload_columns=2, variable_length_strings=True,
        device="cpu")
    opts = dict(key=keys, shuffle="ragged", out_capacity_factor=4.0)
    plain = tdist.distributed_inner_join(b, p, EmulatedCommunicator(4),
                                         **opts)
    res = tdist.distributed_inner_join(b, p, EmulatedCommunicator(4),
                                       verify_integrity=True, **opts)
    assert res.integrity_report.ok
    np.testing.assert_array_equal(_multiset(res), _multiset(plain))


def test_aggregate_partials_exchange_is_a_channel():
    """The probe-mode aggregate exchanges partials on a digest channel of
    its own (JAX :952-956)."""
    b, p = _tables()
    spec = AggregateSpec.of("probe_payload", [("count", None, "n")])
    res = tdist.distributed_inner_join(b, p, EmulatedCommunicator(4),
                                       aggregate=spec, verify_integrity=True,
                                       **OUT)
    assert res.integrity_report.ok
    assert res.integrity_report.channels == ("build", "partials", "probe")


# -- corruption: every mode, every seam ---------------------------------

CORRUPT_WIRES = {
    "padded": dict(),
    "ppermute": dict(shuffle="ppermute"),
    "compressed": dict(compression_bits=32),
    "ragged": dict(shuffle="ragged"),
    "hierarchical": dict(shuffle="hierarchical", dcn_codec="on",
                         compression_bits=32),
}


def _faulty(mode, budget, wire):
    inner = (EmulatedCommunicator(4, n_slices=2) if wire == "hierarchical"
             else EmulatedCommunicator(4))
    return FaultInjectingCommunicator(inner, FaultPlan(
        seed=5, corrupt_mode=mode, corrupt_collectives=budget))


@pytest.mark.parametrize("wire", sorted(CORRUPT_WIRES))
@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_corruption_detected_and_recovered(mode, wire):
    """Each mode on each seam: an unbounded budget raises IntegrityError
    (never a result), a budget of one recovers through one
    ``retry_integrity`` rung of the same sizing, with the clean rows
    (tests/test_faults.py:251-312, tests/test_hierarchy.py:357-384)."""
    b, p = _tables()
    opts = dict(OUT, **CORRUPT_WIRES[wire])
    clean = tdist.distributed_inner_join(
        b, p, _faulty(None, 0, wire), **opts)
    with pytest.raises(IntegrityError, match="wire integrity"):
        tdist.distributed_inner_join(b, p, _faulty(mode, 1 << 30, wire),
                                     verify_integrity=True, **opts)
    res = tdist.distributed_inner_join(b, p, _faulty(mode, 1, wire),
                                       verify_integrity=True, auto_retry=2,
                                       **opts)
    att = res.retry_report.attempts
    assert [a.action for a in att] == ["initial", "retry_integrity"]
    assert [a.integrity_ok for a in att] == [False, True]
    assert att[0].shuffle_capacity_factor == att[1].shuffle_capacity_factor
    assert att[0].out_capacity_factor == att[1].out_capacity_factor
    assert res.integrity_report.ok and not bool(res.overflow)
    np.testing.assert_array_equal(_multiset(res), _multiset(clean))


def test_corrupted_program_does_not_heal_and_the_ladder_evicts():
    """The budget is decided once a program (the JAX package decides at
    trace time): the same program corrupts on every call, so only an
    eviction and a new program runs clean (tests/test_service.py:223-244).
    The last attempt's program is evicted too before the raise."""
    b, p = _tables()
    comm = _faulty("bit_flip", 1, "padded")
    fn = tdist.make_distributed_join(comm, with_integrity=True, **OUT)
    assert not tint.verify_join_result(fn(b, p)).ok
    assert not tint.verify_join_result(fn(b, p)).ok   # never heals
    comm = _faulty("bit_flip", 1, "padded")
    cache = JoinProgramCache(comm)
    res = tdist.distributed_inner_join(b, p, comm, auto_retry=2,
                                       verify_integrity=True,
                                       program_cache=cache, **OUT)
    assert [a.action for a in res.retry_report.attempts] == [
        "initial", "retry_integrity"]
    assert cache.traces == 2 and cache.integrity_evictions == 1
    assert len(cache) == 1
    comm = _faulty("misroute", 1 << 30, "padded")
    cache = JoinProgramCache(comm)
    with pytest.raises(IntegrityError) as exc:
        tdist.distributed_inner_join(b, p, comm, auto_retry=1,
                                     verify_integrity=True,
                                     program_cache=cache, **OUT)
    assert cache.integrity_evictions == 2 and len(cache) == 0
    assert not exc.value.report.ok and exc.value.report.mismatches


def test_segmented_and_aggregate_corruption_refuse_wrong_rows():
    """The segmented wire (tests/test_sortpath.py:411) and the fused
    aggregate (tests/test_aggregate.py:596-628): a corrupted data block
    raises, a budget recovers to the clean answer."""
    b, p = _tables()
    spec = AggregateSpec.of("key", [("count", None, "n")])
    for opts in (WIRES["segmented"], dict(aggregate=spec)):
        opts = dict(OUT, **opts)
        clean = tdist.distributed_inner_join(b, p, EmulatedCommunicator(4),
                                             **opts)
        with pytest.raises(IntegrityError):
            tdist.distributed_inner_join(
                b, p, _faulty("bit_flip", 1 << 30, "padded"),
                verify_integrity=True, **opts)
        res = tdist.distributed_inner_join(
            b, p, _faulty("bit_flip", 2, "padded"), verify_integrity=True,
            auto_retry=3, **opts)
        assert res.integrity_report.ok
        np.testing.assert_array_equal(_multiset(res), _multiset(clean))


def test_rearm_and_budget_are_counted_once_a_collective():
    """The emulated ranks are threads: one corrupted collective spends
    one unit of the budget, whatever the rank count, and a rearm lets the
    next program draw again."""
    b, p = _tables()
    comm = _faulty("bit_flip", 1, "padded")
    fn = tdist.make_distributed_join(comm, with_integrity=True, **OUT)
    assert not tint.verify_join_result(fn(b, p)).ok
    assert comm._corruptions == 1
    fresh = tdist.make_distributed_join(comm, with_integrity=True, **OUT)
    assert tint.verify_join_result(fresh(b, p)).ok
    comm.rearm_corruption()
    again = tdist.make_distributed_join(comm, with_integrity=True, **OUT)
    assert not tint.verify_join_result(again(b, p)).ok


def test_budget_holds_under_thread_contention():
    """16 rank threads switching every microsecond race for the budget's
    lock: the budget is spent exactly (a lost update would spend more or
    less), every rank reads one decision a collective (the program's
    second call names the same mismatching pairs), and no rank blocks."""
    import sys

    b, p = _tables(rows=4096)
    comm = FaultInjectingCommunicator(EmulatedCommunicator(16, timeout_s=60),
                                      FaultPlan(seed=7, corrupt_mode="misroute",
                                                corrupt_collectives=3))
    fn = tdist.make_distributed_join(comm, with_integrity=True, **OUT)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        first = tint.verify_join_result(fn(b, p))
        second = tint.verify_join_result(fn(b, p))
    finally:
        sys.setswitchinterval(before)
    assert comm._corruptions == 3
    assert not first.ok and first.mismatches == second.mismatches


# -- the serving surfaces and the batch loop ----------------------------


def test_resident_join_retries_and_terminal_evicts():
    """tests/test_aggregate.py's probe-only rungs: registration runs
    clean (budget 0), then the probe-only program meets one corrupted
    collective, is evicted and rerun clean; an unbounded budget raises
    and leaves no program of it behind."""
    b, p = _tables(seed=31)
    plan = FaultPlan(seed=3, corrupt_mode="bit_flip", corrupt_collectives=0)
    comm = FaultInjectingCommunicator(EmulatedCommunicator(4), plan)
    cache = JoinProgramCache(comm)
    reg = ResidentTableRegistry(comm, cache)
    reg.register("t", b)
    want = int(tdist.distributed_inner_join(b, p, EmulatedCommunicator(4),
                                            **OUT).total)
    plan.corrupt_collectives = 1
    comm.rearm_corruption()
    res = reg.join("t", p, auto_retry=3, verify_integrity=True, **OUT)
    assert res.integrity_report.ok
    assert res.integrity_report.channels == ("probe",)
    assert [a.action for a in res.retry_report.attempts] == [
        "initial", "retry_integrity"]
    assert int(res.total) == want and cache.integrity_evictions == 1
    plan.corrupt_collectives = 1 << 30
    comm.rearm_corruption()
    before = len(cache)
    with pytest.raises(IntegrityError):
        reg.join("t", p, auto_retry=1, verify_integrity=True,
                 out_capacity_factor=2.0)
    assert cache.integrity_evictions == 3 and len(cache) == before


def test_service_counts_integrity_evictions():
    """A verify-integrity service serves wire and resident joins with
    clean reports (tests/test_resident.py:586), and a corrupted wire is
    an eviction the stats and the metrics count."""
    from distributed_join_tpu_torch.service.server import (
        JoinService,
        ServiceConfig,
    )

    b, p = _tables(seed=37)
    plan = FaultPlan(seed=5, corrupt_mode="misroute", corrupt_collectives=0)
    comm = FaultInjectingCommunicator(EmulatedCommunicator(4), plan)
    svc = JoinService(comm, ServiceConfig(verify_integrity=True),
                      device="cpu")
    svc.register_table("dim", b)
    res = svc.resident_join("dim", p, **OUT)
    assert res.integrity_report.ok
    plan.corrupt_collectives = 1
    comm.rearm_corruption()
    res = svc.join(b, p, key="key", **OUT)
    assert res.integrity_report.ok
    stats = svc.stats()
    assert stats["cache"]["integrity_evictions"] == 1
    assert svc.live.snapshot()["ops"]["join"]["integrity_retries"] == 1
    prom = [ln for ln in svc.prometheus_metrics().splitlines()
            if "program_cache_integrity_evictions" in ln
            and not ln.startswith("#")]
    assert len(prom) == 1 and prom[0].split()[-1] in ("1", "1.0")


@pytest.fixture(scope="module")
def ooc_tables():
    return _tables(seed=13, rows=4096)


def test_out_of_core_integrity_raise_and_degrade(ooc_tables):
    """tests/test_faults.py:629-653: the one batch program carries the
    corruption into every batch; ``raise`` surfaces IntegrityError,
    ``continue`` abandons every batch and never counts its total; a
    clean verified loop is the plain loop, and a corrupt batch's rows
    never reach the consumer."""
    b, p = ooc_tables
    opts = dict(n_batches=4, warmup=False, out_capacity_factor=3.0,
                shuffle_capacity_factor=3.0)
    plan = FaultPlan(seed=5, corrupt_mode="bit_flip", corrupt_collectives=1)
    with pytest.raises(IntegrityError):
        tooc.keyrange_batched_join(
            b, p, FaultInjectingCommunicator(EmulatedCommunicator(4), plan),
            verify_integrity=True, **opts)
    stats, seen = {}, []
    total, overflow = tooc.keyrange_batched_join(
        b, p, FaultInjectingCommunicator(EmulatedCommunicator(4), plan),
        verify_integrity=True, on_batch_failure="continue", stats=stats,
        on_batch_result=lambda bi, res: seen.append(bi), **opts)
    assert stats["failed_batches"] == [0, 1, 2, 3]
    assert total == 0 and not overflow and seen == []
    want = tooc.keyrange_batched_join(b, p, EmulatedCommunicator(4), **opts)
    assert tooc.keyrange_batched_join(b, p, EmulatedCommunicator(4),
                                      verify_integrity=True, **opts) == want


# -- the drivers --------------------------------------------------------


def test_drivers_verify_integrity_records():
    from distributed_join_tpu_torch.benchmarks import all_to_all as ta2a
    from distributed_join_tpu_torch.benchmarks import collect_integrity
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )

    args = tdriver.parse_args(
        ["--communicator", "emulated", "--n-ranks", "4",
         "--build-table-nrows", "4000", "--probe-table-nrows", "4000",
         "--iterations", "1", "--verify-integrity"])
    rec = tdriver.run(args, device="cpu")
    assert rec["integrity"]["ok"] and rec["integrity"]["checked_pairs"] == 32
    assert tdriver.run(tdriver.parse_args(
        ["--communicator", "emulated", "--n-ranks", "2",
         "--build-table-nrows", "2000", "--probe-table-nrows", "2000",
         "--iterations", "1"]), device="cpu")["integrity"] is None
    a2a = ta2a.parse_args(["--communicator", "emulated", "--n-ranks", "4",
                           "--buffer-size", "4096", "--iterations", "2",
                           "--verify-integrity"])
    rec, _ = ta2a.run(a2a, device="cpu")
    assert rec["integrity"] == {"ok": True, "checked_pairs": 16,
                                "channels": ["wire"], "mismatches": []}
    x = torch.arange(4 * 64, dtype=torch.float32)
    plan = FaultPlan(seed=7, corrupt_mode="bit_flip", corrupt_collectives=1)
    faulty = FaultInjectingCommunicator(EmulatedCommunicator(4), plan)
    with pytest.raises(IntegrityError, match=r"wire\["):
        ta2a.verified_exchange(faulty, x)
    # the verified step rearms a spent budget, so it faces the schedule
    b, p = _tables()
    assert faulty._corruptions == 1
    with pytest.raises(IntegrityError):
        collect_integrity(faulty, b, p, dict(OUT))
    rec = collect_integrity(faulty, b, p, dict(OUT), raise_on_mismatch=False)
    assert rec["ok"] is False and rec["mismatches"]


# -- integrity off ------------------------------------------------------


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _subsequence(short, long) -> bool:
    it = iter(long)
    return all(op in it for op in short)


@pytest.mark.parametrize("opts", [
    dict(), dict(shuffle="ragged"), dict(compression_bits=16),
    dict(sort_mode="segmented", sort_segments=2,
         shuffle_capacity_factor=3.0),
], ids=str)
def test_integrity_off_runs_the_same_step(opts):
    """``with_integrity=False`` (the default) runs the step built without
    the switch: the same torch op sequence and the same result; with it
    on, the step's own ops are a subsequence of its ops and the result is
    unchanged. One rank at k = 2 (a dispatch mode sees its own thread),
    which partitions and shuffles. ``scripts/tape_off_census.py`` holds
    the switch-off ops against the tree before it."""
    b, p = _tables(rows=1024)
    comm = LocalCommunicator()
    opts = dict(OUT, over_decomposition=2, **opts)
    runs = []
    for step in (tdist.make_join_step(comm, **opts),
                 tdist.make_join_step(comm, with_integrity=False, **opts),
                 tdist.make_join_step(comm, with_integrity=True, **opts)):
        with _Ops() as rec:
            out = comm.spmd(step)(b, p)
        res = out[0] if isinstance(out, tuple) else out
        runs.append((rec.ops, res))
    (plain_ops, plain), (off_ops, off), (on_ops, on) = runs
    assert off_ops == plain_ops
    assert len(on_ops) > len(plain_ops) and _subsequence(plain_ops, on_ops)
    for res in (off, on):
        assert int(res.total) == int(plain.total)
        np.testing.assert_array_equal(_multiset(res), _multiset(plain))
    sig = JoinProgramCache(comm).signature
    assert sig(b, p, **opts) == sig(b, p, with_integrity=False, **opts)
    assert sig(b, p, **opts) != sig(b, p, with_integrity=True, **opts)
