"""The port's autotuner (planning/tuner.py) and every surface that
consults it, against the JAX package's ``JoinTuner``, on the CPU.

The decision: the same history files (synthetic signatures: the two
packages' program digests differ by design) go through both tuners, and
``recommend(...).as_record()``, ``apply``, ``dry_run()``, ``format_tune``
and ``stats()`` must be equal, clause by clause: no history,
``min_entries``, failures only, counter drift, an adopted rung that
overrides explicit sizing, the headroom bump, the skew fill (and its
guards), the ragged and hierarchical wire fills, the DCN codec, the
segmented-sort fill with each of its guards, tenant namespaces, legacy
entries without ``rung`` and ``resolve_resident``'s dropped structurals.

The surfaces: ``distributed_inner_join(tuner=)`` over 8 emulated ranks
(the JAX package's 8-device mesh) on numpy-made tables, whose warm
repeat builds no program and runs one ``tuned_presize`` attempt at the
cold run's absolute rung with JAX's total; the service with
``auto_tune=True`` against the JAX service; the resident join; the
drivers' ``--auto-tune`` (parse, the launcher's forwarding,
``resolve_tuner``'s usage errors, two driver runs through one store, the
tpch and all_to_all refusals); ``analyze tune`` (text, ``--json`` and
exit codes equal to JAX's). With the tuner off, rung labels and retry
records are unchanged.
"""

import argparse
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu import benchmarks as jbench
from distributed_join_tpu import telemetry as jtel
from distributed_join_tpu.benchmarks import distributed_join as jdriver
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.planning import tuner as jtuner
from distributed_join_tpu.service import programs as jprog
from distributed_join_tpu.service import resident as jres
from distributed_join_tpu.service import server as js
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.telemetry import analyze as janalyze
from distributed_join_tpu.telemetry import history as jhist
from distributed_join_tpu_torch import bench as tbenchpy
from distributed_join_tpu_torch import benchmarks as tbench
from distributed_join_tpu_torch import telemetry as ttel
from distributed_join_tpu_torch.benchmarks import distributed_join as tdriver
from distributed_join_tpu_torch.benchmarks import launch as tlaunch
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.parallel.faults import CapacityLadder
from distributed_join_tpu_torch.planning import tuner as ttuner
from distributed_join_tpu_torch.service import programs as tprog
from distributed_join_tpu_torch.service import resident as tres
from distributed_join_tpu_torch.service import server as ts
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.telemetry import analyze as tanalyze
from distributed_join_tpu_torch.telemetry import history as thist


@pytest.fixture(autouse=True)
def _no_leaked_session():
    jtel.finalize()
    ttel.finalize()
    yield
    jtel.finalize()
    ttel.finalize()


# -- history lines and the two tuners ---------------------------------------


def _escalated(sig, *, shuffle_f=6.4, out_f=0.8, rung=2, outcome="served",
               **extra):
    """A history line shaped like a request whose ladder escalated."""
    entry = {
        "kind": "request", "signature": sig, "outcome": outcome,
        "wall_s": 0.5, "op": "join",
        "retry": {"n_attempts": rung + 1, "escalations": rung,
                  "integrity_retries": 0},
        "resolved_knobs": {"shuffle_capacity_factor": shuffle_f,
                           "out_capacity_factor": out_f},
        "rung": rung,
    }
    entry.update(extra)
    return entry


def _clean(sig, **extra):
    """A history line of a request that ran once, clean, at the
    defaults."""
    entry = {
        "kind": "request", "signature": sig, "outcome": "served",
        "wall_s": 0.25, "op": "join",
        "retry": {"n_attempts": 1, "escalations": 0,
                  "integrity_retries": 0},
        "resolved_knobs": {"shuffle_capacity_factor": 1.6,
                           "out_capacity_factor": 1.2},
        "rung": 0,
    }
    entry.update(extra)
    return entry


def _geometry(rows=1024, n=8, k=1, slices=1, row_bytes=16):
    return {"nb": n * k, "n_ranks": n, "n_slices": slices,
            "b_local": rows, "p_local": rows,
            "row_bytes": {"build": row_bytes, "probe": row_bytes}}


def _write(path, entries):
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    return str(path)


def _tuners(path, **kw):
    return jtuner.JoinTuner(path, **kw), ttuner.JoinTuner(path, **kw)


WIRE_COUNTERS = {"counters": {
    "build.wire_bytes": 160000, "build.rows_shuffled": 1000,
    "probe.wire_bytes": 64000, "probe.rows_shuffled": 2000}}
DCN_COUNTERS = {"counters": {
    "build.wire_bytes": 1000, "build.wire_bytes_dcn": 600,
    "probe.wire_bytes": 1000, "probe.wire_bytes_dcn": 500,
    "build.rows_shuffled": 1000, "probe.rows_shuffled": 1000}}
SKEW = {"matches": {"gini": 0.5, "max_over_mean": 3.0},
        "build.rows_received": {"gini": 0.2, "max_over_mean": 1.4}}
JOIN_HEAVY = {"wall_s": {"partition": 0.1, "shuffle": 0.1, "join": 0.6}}

# name -> (history lines, tuner kwargs, [(signature, user options,
# geometry, tenant)])
SCENARIOS = {
    "no_history": ([], {}, [("deadbeef", None, None, None),
                            ("deadbeef", {}, _geometry(), None)]),
    "min_entries": ([_escalated("s1")], {"min_entries": 2},
                    [("s1", None, None, None)]),
    "failures_only": ([_escalated("s1", outcome="failed"),
                       _escalated("s1", outcome="hang")], {},
                      [("s1", None, _geometry(), None)]),
    "counter_drift": ([_escalated("s1", counter_signature={
                          "counters": {"matches": 100}}),
                       _escalated("s1", counter_signature={
                           "counters": {"matches": 200}})], {},
                      [("s1", None, _geometry(), None)]),
    "no_drift_across_rungs": (
        [_escalated("s1", counter_signature={"counters": {"matches": 1}}),
         _escalated("s1", rung=3, counter_signature={
             "counters": {"matches": 2}})], {},
        [("s1", None, None, None)]),
    "adopted_rung_overrides_explicit_sizing": (
        [_escalated("s1", shuffle_f=3.2, out_f=0.4, rung=3)], {},
        [("s1", {"out_capacity_factor": 0.1, "shuffle": "padded"}, None,
          None),
         ("s1", {"out_capacity_factor": 0.1}, _geometry(), None)]),
    "adopted_hh_blocks": (
        [_escalated("s1", resolved_knobs={
            "out_capacity_factor": 0.8, "hh_probe_capacity": 4096,
            "hh_out_capacity": 8192, "out_rows_per_rank": None})], {},
        [("s1", {}, None, None), ("s1", {"skew_threshold": 0.05}, None,
                                  None)]),
    "headroom_bump": (
        [_clean("s1", indicators={"build.overflow_margin_min": 10,
                                  "probe.overflow_margin_min": 150})], {},
        [("s1", {}, _geometry(), None),
         ("s1", {"shuffle_capacity_factor": 3.0}, _geometry(), None),
         ("s1", {}, _geometry(n=1), None),
         ("s1", {}, None, None)]),
    "headroom_roomy": (
        [_clean("s1", indicators={"build.overflow_margin_min": 150})], {},
        [("s1", {}, _geometry(), None)]),
    "skew_fill_and_guards": (
        [_clean("s1", indicators=SKEW)], {},
        [("s1", {}, None, None),
         ("s1", {"skew_threshold": 0.05}, None, None),
         ("s1", {"aggregate": "groups"}, None, None)]),
    "skew_warn_threshold": (
        [_clean("s1", indicators=SKEW)], {"skew_gini_warn": 0.6},
        [("s1", {}, None, None)]),
    "ragged_wire": (
        [_clean("s1", counter_signature=WIRE_COUNTERS)], {},
        [("s1", {}, _geometry(), None),
         ("s1", {"shuffle": "padded"}, _geometry(), None),
         ("s1", {"compression_bits": 8}, _geometry(), None),
         ("s1", {}, None, None)]),
    "hierarchical_wire_over_slices": (
        [_clean("s1", counter_signature=WIRE_COUNTERS)], {},
        [("s1", {}, _geometry(slices=2), None)]),
    "dcn_codec": (
        [_clean("s1", counter_signature=DCN_COUNTERS)], {},
        [("s1", {}, None, None), ("s1", {"dcn_codec": "off"}, None, None),
         ("s1", {"shuffle": "hierarchical"}, _geometry(slices=2), None)]),
    "dcn_codec_was_on": (
        [_clean("s1", counter_signature={"counters": dict(
            DCN_COUNTERS["counters"], **{"build.wire_bytes_saved": 100})})],
        {}, [("s1", {}, None, None)]),
    "segmented_fill": (
        [_clean("s1", stages=JOIN_HEAVY)], {},
        [("s1", {}, _geometry(rows=100_000, n=4), None),
         ("s1", {}, _geometry(rows=100_000, n=4, k=2), None),
         ("s1", {"sort_segments": 4}, _geometry(rows=1000, n=4), None),
         ("s1", {"shuffle": "hierarchical", "dcn_codec": "off"},
          _geometry(rows=100_000, n=4, slices=2), None)]),
    "segmented_guards": (
        [_clean("s1", stages=JOIN_HEAVY)], {},
        [("s1", {"shuffle": "ragged"}, _geometry(rows=100_000, n=4), None),
         ("s1", {"compression_bits": 8}, _geometry(rows=100_000, n=4),
          None),
         ("s1", {"aggregate": "groups"}, _geometry(rows=100_000, n=4),
          None),
         ("s1", {"kernel_config": "flags"}, _geometry(rows=100_000, n=4),
          None),
         ("s1", {"sort_mode": "flat"}, _geometry(rows=100_000, n=4), None),
         ("s1", {"shuffle": "hierarchical", "dcn_codec": "on"},
          _geometry(rows=100_000, n=4, slices=2), None),
         ("s1", {"shuffle": "hierarchical"},
          _geometry(rows=100_000, n=4, slices=2), None),
         ("s1", {"shuffle": "hierarchical", "dcn_codec": "bogus"},
          _geometry(rows=100_000, n=4, slices=2), None),
         ("s1", {}, _geometry(rows=1000, n=4), None),
         ("s1", {}, None, None)]),
    "segmented_under_filled_ragged": (
        [_clean("s1", stages=JOIN_HEAVY, counter_signature=WIRE_COUNTERS)],
        {}, [("s1", {}, _geometry(rows=100_000, n=4), None)]),
    "segmented_join_not_dominant": (
        [_clean("s1", stages={"wall_s": {"partition": 0.4, "shuffle": 0.4,
                                         "join": 0.3}})], {},
        [("s1", {}, _geometry(rows=100_000, n=4), None)]),
    "tenants_never_cross": (
        [_escalated("s1", tenant="acme"), _escalated("s2")], {},
        [("s1", None, None, "acme"), ("s1", None, None, "globex"),
         ("s1", None, None, None), ("s2", None, None, "default"),
         ("s2", None, None, "acme")]),
    "legacy_entry_without_rung": (
        [{k: v for k, v in _escalated("old").items() if k != "rung"}], {},
        [("old", None, None, None)]),
    "every_clause": (
        [_escalated("s1", indicators=dict(SKEW, **{
            "build.overflow_margin_min": 1}),
            counter_signature=WIRE_COUNTERS, stages=JOIN_HEAVY),
         _clean("s2", indicators=SKEW, counter_signature=DCN_COUNTERS)],
        {}, [("s1", {}, _geometry(rows=100_000, n=4), None),
             ("s2", {}, _geometry(rows=100_000, n=4, slices=2), None)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recommend_equals_jax(name, tmp_path):
    """Each clause's verdict, what ``apply`` makes of it, the dry run,
    its text and the counters, as the JAX package's tuner gives them on
    the same history file."""
    entries, kw, calls = SCENARIOS[name]
    path = _write(tmp_path / "history.jsonl", entries)
    jt, tt = _tuners(path, **kw)
    for sig, user_opts, geometry, tenant in calls:
        jc = jt.recommend(sig, user_opts, side_geometry=geometry,
                          tenant=tenant)
        tc = tt.recommend(sig, user_opts, side_geometry=geometry,
                          tenant=tenant)
        assert tc.as_record() == jc.as_record(), (sig, user_opts)
        assert tc.apply(dict(user_opts or {})) == \
            jc.apply(dict(user_opts or {}))
        assert tc.applied == jc.applied
    jd, td = jt.dry_run(), tt.dry_run()
    assert td == jd
    assert ttuner.format_tune(td) == jtuner.format_tune(jd)
    assert tt.stats() == jt.stats()


def test_clauses_fill_what_jax_fills(tmp_path):
    """The scenarios reach every clause (not only equal no-ops)."""
    want = {
        "adopted_rung_overrides_explicit_sizing": "adopted_rung",
        "headroom_bump": "headroom", "skew_fill_and_guards": "skew",
        "ragged_wire": "wire", "dcn_codec": "dcn_codec",
        "segmented_fill": "sort_mode"}
    for name, kind in want.items():
        entries, kw, calls = SCENARIOS[name]
        tt = ttuner.JoinTuner(_write(tmp_path / f"{name}.jsonl", entries),
                              **kw)
        sig, user_opts, geometry, tenant = calls[0]
        cfg = tt.recommend(sig, user_opts, side_geometry=geometry,
                           tenant=tenant)
        assert cfg.source == "history" and kind in cfg.basis, name
    tt = ttuner.JoinTuner(_write(tmp_path / "h.jsonl",
                                 SCENARIOS["hierarchical_wire_over_slices"][0]))
    assert tt.recommend("s1", {}, side_geometry=_geometry(
        slices=2)).structural == {"shuffle": "hierarchical"}


def test_active_tenant_scopes_the_lookup(tmp_path):
    path = _write(tmp_path / "h.jsonl", [_escalated("s1", tenant="acme")])
    jt, tt = _tuners(path)
    for t in (jt, tt):
        t.active_tenant = "acme"
    assert tt.recommend("s1").as_record() == jt.recommend("s1").as_record()
    assert tt.recommend("s1").source == "history"
    assert tt.recommend("s1", tenant="globex").source == "static"
    tt.active_tenant = None
    assert tt.recommend("s1").source == "static"


def test_dry_run_one_signature_and_min_entries(tmp_path):
    path = _write(tmp_path / "h.jsonl",
                  [_escalated("a"), _escalated("a", rung=3),
                   _escalated("b")])
    for kw in ({}, {"min_entries": 2}, {"min_entries": 3}):
        jt, tt = _tuners(path, **kw)
        for sig in (None, "a", "b", "missing"):
            jd, td = jt.dry_run(signature=sig), tt.dry_run(signature=sig)
            assert td == jd
            assert ttuner.format_tune(td) == jtuner.format_tune(jd)
    # a missing store is an empty tuner, as in the JAX package
    jt, tt = _tuners(str(tmp_path / "none.jsonl"))
    assert tt.dry_run() == jt.dry_run()
    assert tt.stats() == jt.stats() and tt.stats()["signatures"] == 0


def test_constants_and_static_defaults_equal_jax():
    for name in ("TUNER_SCHEMA_VERSION", "SIZING_KNOBS", "STRUCTURAL_KNOBS",
                 "SORT_STAGE_SHARE_WARN", "DCN_SHARE_WARN",
                 "DEFAULT_SKEW_THRESHOLD", "HEADROOM_BUMP"):
        assert getattr(ttuner, name) == getattr(jtuner, name), name
    assert ttuner._static_defaults() == jtuner._static_defaults()
    t, j = ttuner.JoinTuner(), jtuner.JoinTuner()
    assert (t.skew_gini_warn, t.wire_efficiency_warn,
            t.headroom_ratio_warn) == (j.skew_gini_warn,
                                       j.wire_efficiency_warn,
                                       j.headroom_ratio_warn)
    from distributed_join_tpu_torch import planning

    assert planning.JoinTuner is ttuner.JoinTuner
    assert planning.TunedConfig is ttuner.TunedConfig
    assert planning.format_tune is ttuner.format_tune


# -- tables of both packages --------------------------------------------------


def _both(cols, valid=None):
    valid = np.ones(len(next(iter(cols.values()))), bool) \
        if valid is None else valid
    return (JTable({k: jnp.asarray(v) for k, v in cols.items()},
                   jnp.asarray(valid)),
            Table.from_numpy(cols, valid, device="cpu"))


def _side(seed, rows, kmax, payload):
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, kmax, rows).astype(np.int64),
            payload: rng.integers(-(1 << 40), 1 << 40, rows).astype(
                np.int64)}


def _tables(seed=11, b_rows=512, p_rows=1024, kmax=256):
    b = _side(seed, b_rows, kmax, "build_payload")
    p = _side(seed + 1000, p_rows, kmax, "probe_payload")
    counts = np.bincount(b["key"], minlength=kmax)
    return _both(b), _both(p), int(counts[p["key"]].sum())


def test_fixed_row_bytes_equal_jax():
    rng = np.random.default_rng(3)
    cols = {"key": np.arange(16, dtype=np.int64),
            "a": np.arange(16, dtype=np.int32),
            "f": rng.random(16).astype(np.float32),
            "s": rng.integers(0, 255, (16, 12)).astype(np.uint8),
            "s#len": np.full(16, 12, np.int32)}
    jt, tt = _both(cols)
    assert ttuner._fixed_row_bytes(tt) == jtuner._fixed_row_bytes(jt) == 28
    jt, tt = _both({"key": np.arange(4, dtype=np.int64)})
    assert ttuner._fixed_row_bytes(tt) == jtuner._fixed_row_bytes(jt) == 8
    # a column without a fixed width gives None
    assert ttuner._fixed_row_bytes(argparse.Namespace(
        columns={"v": object()})) is None


@pytest.mark.parametrize("n", [1, 4])
def test_resolve_geometry_equals_jax(n, tmp_path, monkeypatch):
    """``resolve`` derives the shape geometry from real tables (ranks,
    over-decomposition, slices, row widths): with both packages' digests
    pinned to one synthetic signature, the verdicts are equal."""
    monkeypatch.setattr(jtuner, "workload_signature",
                        lambda *a, **k: "sigR")
    monkeypatch.setattr(ttuner, "workload_signature",
                        lambda *a, **k: "sigR")
    path = _write(tmp_path / "h.jsonl", [_clean(
        "sigR", counter_signature=WIRE_COUNTERS, stages=JOIN_HEAVY,
        indicators=dict(SKEW, **{"probe.overflow_margin_min": 2}))])
    jt, tt = _tuners(path)
    (jb, tb), (jp, tp), _ = _tables(b_rows=4000, p_rows=40_000, kmax=4096)
    jc = jcomm.make_communicator("local") if n == 1 else \
        jcomm.TpuCommunicator(n_ranks=n)
    tc = LocalCommunicator() if n == 1 else EmulatedCommunicator(n)
    for opts in ({}, {"over_decomposition": 2}, {"shuffle": "padded"},
                 {"aggregate": "groups", "with_metrics": False}):
        jr = jt.resolve(jc, jb, jp, opts=dict(opts)).as_record()
        tr = tt.resolve(tc, tb, tp, opts=dict(opts)).as_record()
        assert tr == jr, opts


@pytest.mark.parametrize("n", [1, 4])
def test_resolve_resident_drops_structurals_as_jax(n, tmp_path):
    path = _write(tmp_path / "h.jsonl", [
        _escalated("res-w", indicators=SKEW,
                   counter_signature=WIRE_COUNTERS, stages=JOIN_HEAVY)])
    jt, tt = _tuners(path)
    _, (jp, tp), _ = _tables(p_rows=40_000)
    jc = jcomm.make_communicator("local") if n == 1 else \
        jcomm.TpuCommunicator(n_ranks=n)
    tc = LocalCommunicator() if n == 1 else EmulatedCommunicator(n)
    jr = jt.resolve_resident(jc, 200_000, jp, signature="res-w", opts={})
    tr = tt.resolve_resident(tc, 200_000, tp, signature="res-w", opts={})
    assert tr.as_record() == jr.as_record()
    assert tr.structural == {} and "skew_threshold" in \
        tr.basis["structural_dropped"]
    assert tr.rung == 2 and tr.source == "history"


# -- the ladder's seeding -------------------------------------------------------


def test_seeded_ladder_labels_rungs_absolutely():
    from distributed_join_tpu.parallel.faults import (
        CapacityLadder as JLadder,
    )

    kw = dict(shuffle_capacity_factor=1.6, out_capacity_factor=0.4)
    for mk in (lambda: CapacityLadder(**kw), lambda: JLadder(**kw)):
        lad = mk()
        assert lad.base_rung == 0 and lad.next_rung == 0
        lad.seed_rung(0)
        lad.note(False)
        assert lad.report().as_record() is None   # unseeded: unchanged
    trails = []
    for mk in (lambda: CapacityLadder(base_rung=3, **kw),
               lambda: JLadder(base_rung=3, **kw)):
        lad = mk()
        assert lad.next_rung == 3
        lad.note(True)
        lad.escalate()
        assert lad.next_rung == 4
        lad.note(False)
        trails.append([a.as_record() for a in lad.report().attempts])
    assert trails[0] == trails[1]
    assert [(a["attempt"], a["action"]) for a in trails[0]] == [
        (3, "tuned_presize"), (4, "double_capacities")]
    for mk in (lambda: CapacityLadder(**kw), lambda: JLadder(**kw)):
        lad = mk()
        lad.seed_rung(5)
        lad.note(False)
        rec = lad.report().as_record()
        # one clean seeded attempt keeps its record (the store needs it)
        assert rec["n_attempts"] == 1 and rec["attempts"][0]["attempt"] == 5
        assert rec["attempts"][0]["action"] == "tuned_presize"


# -- the library path -----------------------------------------------------------


class _TCounting(EmulatedCommunicator):
    def __init__(self, n):
        super().__init__(n)
        self.programs_built = 0

    def spmd(self, fn, **kw):
        self.programs_built += 1
        return super().spmd(fn, **kw)


class _JCounting(jcomm.TpuCommunicator):
    def __init__(self, n_ranks):
        super().__init__(n_ranks=n_ranks)
        self.programs_built = 0

    def spmd(self, fn, *, sharded_out=None):
        self.programs_built += 1
        return super().spmd(fn, sharded_out=sharded_out)


def _trail(report):
    return [(a.attempt, a.action, a.overflow, a.shuffle_capacity_factor,
             a.out_capacity_factor) for a in report.attempts]


def _warm_contract(dist, comm, cache, tuner, store, b, p, hist):
    r1 = dist.distributed_inner_join(
        b, p, comm, auto_retry=6, program_cache=cache, tuner=tuner,
        out_capacity_factor=0.1)
    store.append(hist.request_entry(
        request_id="r1", op="join", signature=r1.tuned["signature"],
        outcome="served", wall_s=0.1,
        retry_record=r1.retry_report.as_record(), tuned=r1.tuned))
    tuner.load(store.path)
    built = comm.programs_built
    r2 = dist.distributed_inner_join(
        b, p, comm, auto_retry=6, program_cache=cache, tuner=tuner,
        out_capacity_factor=0.1)
    return r1, r2, comm.programs_built - built


def test_library_warm_contract_over_8_ranks_equals_jax(tmp_path):
    """The cold join escalates (out_capacity_factor 0.1); fed its own
    history line, the tuned repeat builds no program, runs one
    ``tuned_presize`` attempt at the cold run's final rung label, and
    returns the total of the JAX package's on the same tables."""
    (jb, tb), (jp, tp), want = _tables()
    jc, tc = _JCounting(8), _TCounting(8)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    jstore = jhist.WorkloadHistory(str(tmp_path / "j.jsonl"))
    tstore = thist.WorkloadHistory(str(tmp_path / "t.jsonl"))
    jr1, jr2, jbuilt = _warm_contract(
        jdist, jc, jcache, jtuner.JoinTuner(jstore.path), jstore, jb, jp,
        jhist)
    traces = tcache.traces
    tr1, tr2, tbuilt = _warm_contract(
        tdist, tc, tcache, ttuner.JoinTuner(tstore.path), tstore, tb, tp,
        thist)
    assert tr1.retry_report.n_attempts > 2
    assert _trail(tr1.retry_report) == _trail(jr1.retry_report)
    assert tr1.tuned["source"] == "static"
    assert tbuilt == jbuilt == 0
    assert tcache.traces - traces == tr1.retry_report.n_attempts
    final = tr1.retry_report.attempts[-1].attempt
    assert [(a.attempt, a.action) for a in tr2.retry_report.attempts] == [
        (final, "tuned_presize")]
    assert _trail(tr2.retry_report) == _trail(jr2.retry_report)
    assert int(tr1.total) == int(tr2.total) == int(jr2.total) == want
    rec = {k: v for k, v in tr2.tuned.items() if k != "signature"}
    assert rec == {k: v for k, v in jr2.tuned.items() if k != "signature"}
    assert rec["source"] == "history" and rec["rung"] == final


def test_tuner_off_rung_labels_and_retry_records_unchanged():
    (_, tb), (_, tp), want = _tables()
    comm = EmulatedCommunicator(8)
    res = tdist.distributed_inner_join(tb, tp, comm,
                                       out_capacity_factor=4.0)
    assert res.retry_report.as_record() is None
    assert res.retry_report.attempts[0].attempt == 0
    assert res.retry_report.attempts[0].action == "initial"
    assert not hasattr(res, "tuned") and int(res.total) == want
    res = tdist.distributed_inner_join(tb, tp, comm, auto_retry=6,
                                       out_capacity_factor=0.1)
    assert [a.attempt for a in res.retry_report.attempts] == list(
        range(res.retry_report.n_attempts))
    assert not hasattr(res, "tuned")
    # a tuner with no history for the workload: the static resolution
    tuned = tdist.distributed_inner_join(
        tb, tp, comm, auto_retry=6, tuner=ttuner.JoinTuner(),
        out_capacity_factor=0.1)
    assert _trail(tuned.retry_report) == _trail(res.retry_report)
    assert tuned.tuned["source"] == "static" and tuned.tuned["rung"] == 0


def test_structural_fill_applies_on_the_library_path(tmp_path):
    """A skew-Gini history fills ``skew_threshold`` for a caller that
    left it unset: the program switches to the skew sidecar, with the
    oracle's total, and an explicit choice is never overridden."""
    (_, tb), (_, tp), want = _tables()
    comm = EmulatedCommunicator(4)
    sig = ttuner.workload_signature(comm, tb, tp, with_metrics=False)
    tuner = ttuner.JoinTuner(_write(tmp_path / "h.jsonl",
                                    [_clean(sig, indicators=SKEW)]))
    res = tdist.distributed_inner_join(tb, tp, comm, tuner=tuner,
                                       auto_retry=4, explain=True)
    assert res.tuned["applied"] == {"skew_threshold": 0.001}
    assert res.plan.as_record()["skew"] is not None
    assert int(res.total) == want
    sig2 = ttuner.workload_signature(comm, tb, tp, with_metrics=False,
                                     skew_threshold=None)
    tuner.observe_entry(_clean(sig2, indicators=SKEW))
    res = tdist.distributed_inner_join(tb, tp, comm, tuner=tuner,
                                       skew_threshold=None)
    assert res.tuned["applied"] == {} and int(res.total) == want


# -- the service ----------------------------------------------------------------


def _services(n, **cfg):
    if n == 1:
        jc, tc = jcomm.make_communicator("local"), LocalCommunicator()
    else:
        jc, tc = jcomm.TpuCommunicator(n_ranks=n), EmulatedCommunicator(n)
    return (js.JoinService(jc, js.ServiceConfig(**cfg)),
            ts.JoinService(tc, ts.ServiceConfig(**cfg), device="cpu"))


_RECORD_FIELDS = ("op", "outcome", "matches", "overflow", "new_traces",
                  "cache_hits", "rung_path", "tuned")


@pytest.mark.parametrize("n", [1, 4])
def test_service_warm_contract_equals_jax(n, tmp_path):
    """``JoinService(auto_tune=True)``: the second identical request runs
    pre-sized (zero new programs, one attempt, ``tuned.source ==
    "history"``); the history entries, the flight records and
    ``stats()["tuner"]`` carry it, as in the JAX service."""
    jsvc, tsvc = _services(n, auto_retry=6, auto_tune=True,
                           history_dir=str(tmp_path / "hist"))
    (jb, tb), (jp, tp), want = _tables()
    out = []
    for svc, b, p in ((jsvc, jb, jp), (tsvc, tb, tp)):
        r1 = svc.join(b, p, out_capacity_factor=0.1)
        r2 = svc.join(b, p, out_capacity_factor=0.1)
        out.append((r1, r2))
    (jr1, jr2), (tr1, tr2) = out
    assert tr1.retry_report.n_attempts == jr1.retry_report.n_attempts > 1
    assert tr2.new_traces == jr2.new_traces == 0
    assert tr2.retry_report.n_attempts == 1
    assert tr2.tuned["source"] == jr2.tuned["source"] == "history"
    assert tr2.tuned["rung"] == jr2.tuned["rung"] == \
        tr1.retry_report.attempts[-1].attempt
    assert int(tr2.total) == int(jr2.total) == want
    tent, _ = thist.load_history(str(tmp_path / "hist"))
    assert tent[-1]["tuned"] == {
        k: tr2.tuned[k] for k in ("source", "rung", "applied")}
    assert tent[-1]["rung"] == tr2.tuned["rung"]
    for j, t in zip(jsvc.recorder.snapshot()["records"],
                    tsvc.recorder.snapshot()["records"]):
        assert {k: t.get(k) for k in _RECORD_FIELDS} == {
            k: j.get(k) for k in _RECORD_FIELDS}
    js_, ts_ = jsvc.stats()["tuner"], tsvc.stats()["tuner"]
    assert {k: v for k, v in ts_.items() if k != "history_path"} == {
        k: v for k, v in js_.items() if k != "history_path"}
    assert ts_["history_hits"] >= 1
    assert tsvc.metrics_snapshot()["stats"]["tuner"] == tsvc.stats()["tuner"]
    # a restarted service preloads the store and starts warm at the rung
    again = ts.JoinService(tsvc.comm, ts.ServiceConfig(
        auto_retry=6, auto_tune=True, history_dir=str(tmp_path / "hist")),
        device="cpu")
    r3 = again.join(tb, tp, out_capacity_factor=0.1)
    assert r3.retry_report.attempts[0].action == "tuned_presize"
    assert r3.tuned["rung"] == tr2.tuned["rung"]


def test_service_explain_and_tenants_and_tuner_history(tmp_path):
    """The explain op's ``tuned`` block before and after the ladder paid;
    a tenant's history pre-sizes only that tenant; ``tuner_history``
    preloads another store. The JAX service gives the same verdicts."""
    jsvc, tsvc = _services(4, auto_retry=6, auto_tune=True)
    (jb, tb), (jp, tp), _ = _tables()
    for svc, b, p in ((jsvc, jb, jp), (tsvc, tb, tp)):
        assert svc.explain(b, p, out_capacity_factor=0.1)["tuned"][
            "source"] == "static"
        r = svc.join(b, p, out_capacity_factor=0.1, tenant="acme")
        assert r.tuned["source"] == "static"
        r = svc.join(b, p, out_capacity_factor=0.1, tenant="acme")
        assert r.tuned["source"] == "history" and r.new_traces == 0
        r = svc.join(b, p, out_capacity_factor=0.1)
        assert r.tuned["source"] == "static"
        out = svc.explain(b, p, out_capacity_factor=0.1)["tuned"]
        assert out["source"] == "history" and out["rung"] >= 1
    assert {k: v for k, v in tsvc.stats()["tuner"].items()
            if k != "history_path"} == {
        k: v for k, v in jsvc.stats()["tuner"].items()
        if k != "history_path"}
    # tuner_history: a store written by another process preloads
    store = str(tmp_path / "pre.jsonl")
    sig = tsvc._workload_signature(tb, tp, "key",
                                   {"out_capacity_factor": 0.1})
    _write(store, [_escalated(sig, rung=2)])
    svc = ts.JoinService(EmulatedCommunicator(4), ts.ServiceConfig(
        auto_tune=True, tuner_history=store), device="cpu")
    assert svc.stats()["tuner"]["observed"] == 1
    assert svc.explain(tb, tp, out_capacity_factor=0.1)["tuned"]["rung"] == 2
    plain = ts.JoinService(EmulatedCommunicator(4), device="cpu")
    assert plain.stats()["tuner"] is None
    assert "tuned" not in plain.explain(tb, tp)


def test_daemon_auto_tune_flag():
    for argv, auto, hist in (([], False, None), (["--auto-tune"], True, None),
                             (["--auto-tune", "h.jsonl"], True, "h.jsonl")):
        args = ts.parse_args(argv + ["--device", "cpu", "--communicator",
                                     "emulated", "--n-ranks", "2"])
        args.request_deadline_s = None   # main() resolves it from the guard
        svc = ts._service_from_args(args)
        assert svc.config.auto_tune is auto
        assert svc.config.tuner_history == hist
        assert (svc.tuner is not None) is auto


# -- the resident join ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4])
def test_resident_join_tuner_equals_jax(n, tmp_path):
    """The probe-only ladder pre-sized from the registry's
    generation-free signature: the warm repeat climbs no rung, builds no
    program and keeps the total; a structural recommendation is dropped
    into ``basis["structural_dropped"]``."""
    (jb, tb), (jp, tp), want = _tables(seed=17)
    if n == 1:
        jc, tc = jcomm.make_communicator("local"), LocalCommunicator()
    else:
        jc, tc = jcomm.TpuCommunicator(n_ranks=n), EmulatedCommunicator(n)
    jcache, tcache = jprog.JoinProgramCache(jc), tprog.JoinProgramCache(tc)
    jreg = jres.ResidentTableRegistry(jc, jcache)
    treg = tres.ResidentTableRegistry(tc, tcache)
    jreg.register("dim", jb)
    treg.register("dim", tb)
    out = []
    for reg, p, cache, hist, tuner_cls, extra in (
            (jreg, jp, jcache, jhist, jtuner.JoinTuner,
             {"with_metrics": False}),
            (treg, tp, tcache, thist, ttuner.JoinTuner, {})):
        tuner = tuner_cls()
        opts = {"out_capacity_factor": 0.05}
        r1 = reg.join("dim", p, auto_retry=6, tuner=tuner, **extra, **opts)
        wsig = reg.workload_signature("dim", p, dict(opts, **extra))
        tuner.observe_entry(hist.request_entry(
            request_id="r", op="resident_join", signature=wsig,
            outcome="served", wall_s=0.1,
            retry_record=r1.retry_report.as_record(), tuned=r1.tuned))
        traces = cache.stats()["traces"]
        r2 = reg.join("dim", p, auto_retry=6, tuner=tuner, **extra, **opts)
        out.append((r1, r2, cache.stats()["traces"] - traces))
    (jr1, jr2, jnew), (tr1, tr2, tnew) = out
    assert tr1.retry_report.n_attempts > 1 and tr1.retry_report.resolved
    assert _trail(tr1.retry_report) == _trail(jr1.retry_report)
    assert tnew == jnew == 0
    assert [(a.attempt, a.action) for a in tr2.retry_report.attempts] == [
        (tr1.retry_report.attempts[-1].attempt, "tuned_presize")]
    assert int(tr2.total) == int(jr2.total) == int(tr1.total)
    strip = lambda r: {k: v for k, v in r.tuned.items()  # noqa: E731
                       if k != "signature"}
    assert strip(tr2) == strip(jr2)
    assert tr2.tuned["signature"].startswith("res-")


def test_resident_join_drops_structural_fills(tmp_path):
    (_, tb), (_, tp), _ = _tables(seed=17)
    comm = EmulatedCommunicator(4)
    treg = tres.ResidentTableRegistry(comm, tprog.JoinProgramCache(comm))
    treg.register("dim", tb)
    wsig = treg.workload_signature("dim", tp, {})
    tuner = ttuner.JoinTuner(_write(tmp_path / "h.jsonl", [_clean(
        wsig, indicators=SKEW, counter_signature=WIRE_COUNTERS)]))
    res = treg.join("dim", tp, tuner=tuner)
    assert res.tuned["structural"] == {}
    assert res.tuned["basis"]["structural_dropped"] == {
        "skew_threshold": 0.001, "shuffle": "ragged"}
    assert res.tuned["applied"] == {}
    assert res.retry_report.attempts[0].action == "initial"


# -- the drivers ---------------------------------------------------------------


def test_auto_tune_parse_and_forwarding_equal_jax():
    for argv in ([], ["--auto-tune"], ["--auto-tune", "h.jsonl"],
                 ["--auto-tune", "", "--history", "h.jsonl"]):
        assert tdriver.parse_args(argv).auto_tune == \
            jdriver.parse_args(argv).auto_tune
    args = argparse.Namespace(
        telemetry=None, trace=False, diagnose=False, history="h.jsonl",
        explain=False, auto_tune="", verify_integrity=False,
        chaos_seed=None, guard_deadline_s=None, slices=None,
        stage_profile=None, sort_mode=None, sort_segments=None)
    jextra = jbench.extract_forwarded_flags(args, ["drv"])
    targs = tlaunch.parse_args(["--num-processes", "2", "--history",
                                "h.jsonl", "--auto-tune", "--", "drv"])
    assert targs.command == ["drv", *jextra]
    assert targs.command[targs.command.index("--auto-tune") + 1] == ""
    # the command's own flag wins
    targs = tlaunch.parse_args(["--num-processes", "2", "--auto-tune",
                                "a.jsonl", "--", "drv", "--auto-tune=b"])
    assert targs.command == ["drv", "--auto-tune=b"]
    assert ("--auto-tune", "auto_tune", True) in tbench.FORWARDED_CHILD_FLAGS
    assert "--auto-tune" not in tbench.UNPORTED_FLAGS


def test_resolve_tuner_usage_errors_equal_jax(tmp_path):
    for mod in (tbench, jbench):
        assert mod.resolve_tuner(argparse.Namespace(auto_tune=None)) is None
    msgs = []
    for mod in (tbench, jbench):
        with pytest.raises(SystemExit) as exc:
            mod.resolve_tuner(argparse.Namespace(auto_tune="",
                                                 history=None))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    t = tbench.resolve_tuner(argparse.Namespace(
        auto_tune="", history=str(tmp_path / "missing.jsonl")))
    assert isinstance(t, ttuner.JoinTuner) and t.stats()["signatures"] == 0


def test_tuned_driver_record_equals_jax(tmp_path):
    wl = {"benchmark": "distributed_join", "n_ranks": 4,
          "build_table_nrows": 8000, "probe_table_nrows": 8000,
          "selectivity": 0.3, "shuffle": "padded"}
    sig = thist.run_signature(wl)
    assert sig == jhist.run_signature(wl)
    path = _write(tmp_path / "h.jsonl", [_escalated(
        sig, indicators=SKEW, counter_signature=WIRE_COUNTERS)])
    jt, tt = _tuners(path)
    assert tbench.tuned_driver_record(tt, wl) == \
        jbench.tuned_driver_record(jt, wl)
    sizing, rung, rec = tbench.tuned_driver_record(tt, wl)
    assert rung == 2 and "structural" not in rec and rec["workload"] == wl
    assert tbench.tuned_driver_record(tt, dict(wl, n_ranks=8)) == \
        jbench.tuned_driver_record(jt, dict(wl, n_ranks=8))


DRIVER_ARGV = ["--communicator", "emulated", "--n-ranks", "4",
               "--build-table-nrows", "8000", "--probe-table-nrows", "8000",
               "--out-capacity-factor", "0.1", "--auto-retry", "6",
               "--iterations", "1"]


def test_join_driver_auto_tune_through_one_store(tmp_path, capsys,
                                               monkeypatch):
    """Two runs with ``--history F --auto-tune``: run 1 (an empty store,
    the static resolution) escalates; run 2 looks up the identity run 1
    was filed under (the pre-tuned workload its record carries), starts
    at run 1's final rung and climbs none; ``analyze tune F --json``
    passes ``analyze check``. (As in the JAX package, a run without
    ``--auto-tune`` files under the identity its flags back-fill, where
    ``dcn_codec`` is set: the flag is meant for every run of a
    workload.)"""
    monkeypatch.chdir(tmp_path)   # the session's default directory
    monkeypatch.setattr(tdriver, "rank_device",
                        lambda comm, device=None: torch.device("cpu"))
    hist = str(tmp_path / "history.jsonl")
    rc = tbench.run_guarded(tdriver._main, tdriver.parse_args(
        DRIVER_ARGV + ["--history", hist, "--auto-tune", "--json-output",
                       str(tmp_path / "r1.json")]), "distributed_join")
    assert rc == 0
    r1 = json.load(open(tmp_path / "r1.json"))
    assert r1["tuned"]["source"] == "static"
    assert r1["retry"]["n_attempts"] > 1
    final = r1["retry"]["attempts"][-1]
    args = tdriver.parse_args(DRIVER_ARGV + [
        "--history", hist, "--auto-tune", "--json-output",
        str(tmp_path / "r2.json")])
    assert tbench.run_guarded(tdriver._main, args, "distributed_join") == 0
    r2 = json.load(open(tmp_path / "r2.json"))
    assert r2["tuned"]["source"] == "history"
    assert r2["tuned"]["rung"] == final["attempt"]
    assert r2["tuned"]["workload"]["benchmark"] == "distributed_join"
    assert r2["retry"]["n_attempts"] == 1
    att = r2["retry"]["attempts"][0]
    assert (att["attempt"], att["action"], att["overflow"]) == (
        final["attempt"], "tuned_presize", False)
    assert att["out_capacity_factor"] == final["out_capacity_factor"]
    assert r2["matches_per_join"] == r1["matches_per_join"]
    assert "auto-tune: pre-sizing from history rung" in \
        capsys.readouterr().err
    entries, _ = thist.load_history(hist)
    assert len({e["signature"] for e in entries}) == 1
    assert entries[-1]["rung"] == final["attempt"]
    assert entries[-1]["tuned"]["source"] == "history"
    # the dry run of the store, checked as an artifact
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tanalyze.main(["tune", hist, "--json"]) == 0
    tune = tmp_path / "tune.json"
    tune.write_text(out.getvalue())
    assert tanalyze.check_file(str(tune)) == []
    assert janalyze.check_file(str(tune)) == []
    doc = json.loads(out.getvalue())
    (sig, v), = doc["signatures"].items()
    assert v["rung"] == final["attempt"] and v["source"] == "history"


def test_bench_auto_tune_presizes_both_ladders(tmp_path):
    """bench.py's ``--auto-tune``: the protocol's workload identity,
    looked up in the store, seeds both measured ladders (the
    match-sized one keeps its own output size)."""
    rec0 = tbenchpy.run(nrows=20_000, iters=1, device="cpu")
    assert rec0["tuned"] is None and rec0["benchmark"] == "bench"
    wl = {k: rec0[k] for k in thist.WORKLOAD_KEYS
          if rec0.get(k) is not None}
    path = _write(tmp_path / "h.jsonl", [_escalated(
        thist.run_signature(wl), shuffle_f=3.2, out_f=2.4, rung=1)])
    args = argparse.Namespace(auto_tune=path, history=None,
                              stage_profile=None)
    rec = tbenchpy.run(nrows=20_000, iters=1, device="cpu", args=args)
    assert rec["tuned"]["source"] == "history" and rec["tuned"]["rung"] == 1
    assert rec["tuned"]["workload"] == wl
    for trail in rec["retry"].values():
        att = trail["attempts"][0]
        assert (att["attempt"], att["action"]) == (1, "tuned_presize")
        assert att["shuffle_capacity_factor"] == 3.2
    assert rec["retry"]["capacity_contract"]["attempts"][0][
        "out_capacity_factor"] == 2.4
    assert rec["matches_per_join"] == rec0["matches_per_join"]
    # the line's --history entry files under the identity looked up
    assert thist.run_entry(rec)["signature"] == thist.run_signature(wl)


@pytest.mark.parametrize("driver,match", [
    ("tpch_join", "does not consult the history store"),
    ("all_to_all", "no capacity contract to pre-size")])
def test_tpch_and_all_to_all_refuse_auto_tune_as_jax(driver, match):
    import importlib

    tmod = importlib.import_module(
        f"distributed_join_tpu_torch.benchmarks.{driver}")
    jmod = importlib.import_module(f"distributed_join_tpu.benchmarks.{driver}")
    msgs = []
    for mod in (tmod, jmod):
        args = mod.parse_args(["--auto-tune"])
        assert args.auto_tune == ""
        with pytest.raises(SystemExit, match=match) as exc:
            mod.run(args)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# -- analyze tune ---------------------------------------------------------------


def test_analyze_tune_equals_jax(tmp_path, capsys):
    path = _write(tmp_path / "history.jsonl", [
        _escalated("sigZ"), _clean("sigS", indicators=SKEW),
        _escalated("sigT", tenant="acme"),
        _escalated("sigF", outcome="failed"),
        _clean("sigH", indicators={"build.overflow_margin_min": 1})])
    for argv in (["tune", path], ["tune", path, "--json"],
                 ["tune", str(tmp_path)], ["tune", path, "--signature",
                                           "sigZ"],
                 ["tune", path, "--signature", "nope", "--json"],
                 ["tune", path, "--min-entries", "2"],
                 ["tune", str(tmp_path / "missing.jsonl")]):
        rcs, outs = [], []
        for main in (tanalyze.main, janalyze.main):
            rcs.append(main(list(argv)))
            outs.append(capsys.readouterr().out)
        assert rcs[0] == rcs[1] == 0, argv
        assert outs[0] == outs[1], argv
    assert tanalyze.main(["tune", path, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["kind"] == "tune" and doc["n_signatures"] == 5
    assert doc["signatures"]["sigZ"]["delta"]["out_capacity_factor"][
        "tuned"] == 0.8
    with pytest.raises(SystemExit) as exc:
        tanalyze.main(["tune"])
    with pytest.raises(SystemExit) as jexc:
        janalyze.main(["tune"])
    assert exc.value.code == jexc.value.code
    tuned = tmp_path / "tuner_snapshot.json"
    tuned.write_text(json.dumps(ttuner.JoinTuner(path).dry_run()))
    assert tanalyze.check_file(str(tuned)) == \
        janalyze.check_file(str(tuned)) == []
