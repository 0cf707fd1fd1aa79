"""The port's join service (service/server.py) against the JAX package's,
on the CPU, at 1 rank and at 4 emulated ranks (the JAX package's 4-device
mesh).

The same numpy-made tables go to a JAX ``JoinService`` and a port
``JoinService``, both embedded. Held against the reference exactly: the
totals and the result rows (as sorted multisets), the program cache's
traces, hits and misses, the retry trails, ``join_batched``'s per-request
matches, ``resident_join`` after ``append_rows``, the ``query`` groups,
the stats counters, the live metrics' outcomes, the grouping of the
``workload_signature`` digests (and the digest itself where it falls back
to the shared sha256), the flight records' fields, the history entries'
keys, and every refusal's type and message. Over TCP the port's daemon
answers every op of ``results/contracts/wire_ops.json`` with the JAX
daemon's response keys (the wire's generated tables are each package's
own draws, so their matches are not compared), and refuses ``explain`` naming ROADMAP A5; the
client's reconnect, the ``--watch`` console, request ids, the shutdown's
wait on the exec lock, the drain and SIGTERM run as the JAX package's
tests have them. Where the JAX package's own test is red on this jax (the
history store with a telemetry session, the TCP request id), the port is
held to that test's written expectations.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu import telemetry as jtel
from distributed_join_tpu.ops import aggregate as ja
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel.faults import (
    FaultInjectingCommunicator as JFaulty,
    FaultPlan as JFaultPlan,
)
from distributed_join_tpu.planning import query as jplan
from distributed_join_tpu.planning import tuner as jtuner
from distributed_join_tpu.service import server as js
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils import tpch as jtpch
from distributed_join_tpu_torch import telemetry as ttel
from distributed_join_tpu_torch.ops import aggregate as ta
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
    ProcessGroupCommunicator,
)
from distributed_join_tpu_torch.parallel.faults import (
    FaultInjectingCommunicator as TFaulty,
    FaultPlan as TFaultPlan,
)
from distributed_join_tpu_torch.parallel.mesh import Mesh
from distributed_join_tpu_torch.planning import query as tplan
from distributed_join_tpu_torch.planning import tuner as ttuner
from distributed_join_tpu_torch.service import server as ts
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.telemetry import history as thist
from distributed_join_tpu_torch.utils.generators import (
    generate_build_probe_tables,
)

RANKS = [1, 4]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRE_OPS = json.load(open(os.path.join(REPO, "results", "contracts",
                                       "wire_ops.json")))


@pytest.fixture(autouse=True)
def _no_leaked_session():
    jtel.finalize()
    ttel.finalize()
    yield
    jtel.finalize()
    ttel.finalize()


def _squeezing(base):
    """A port communicator whose first ``overflow_programs`` programs
    report an overflow (the JAX package's ``FaultPlan(
    overflow_programs=)``)."""
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
    """(JAX communicator, port communicator) over ``n`` ranks."""
    if n == 1:
        jc = jcomm.make_communicator("local")
        tc = _squeezing(LocalCommunicator)(
            overflow_programs=overflow_programs)
    else:
        jc = jcomm.TpuCommunicator(n_ranks=n)
        tc = _squeezing(EmulatedCommunicator)(
            n, overflow_programs=overflow_programs)
    if overflow_programs:
        jc = JFaulty(jc, JFaultPlan(overflow_programs=overflow_programs))
    return jc, tc


def _services(n, overflow_programs=0, **cfg):
    jc, tc = _comms(n, overflow_programs)
    return (js.JoinService(jc, js.ServiceConfig(**cfg)),
            ts.JoinService(tc, ts.ServiceConfig(**cfg), device="cpu"))


def _both(cols, valid=None):
    valid = np.ones(len(cols["key"]), bool) if valid is None else valid
    return (JTable({k: jnp.asarray(v) for k, v in cols.items()},
                   jnp.asarray(valid)),
            Table.from_numpy(cols, valid, device="cpu"))


def _side(seed, rows, kmax, payload):
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, kmax, rows).astype(np.int64),
            payload: rng.integers(-(1 << 40), 1 << 40, rows).astype(np.int64)}


def _tables(seed=11, b_rows=512, p_rows=1024, kmax=256):
    b = _side(seed, b_rows, kmax, "build_payload")
    p = _side(seed + 1000, p_rows, kmax, "probe_payload")
    return _both(b), _both(p), _oracle(b, p)


def _oracle(b, p) -> int:
    counts = np.bincount(b["key"], minlength=int(max(b["key"].max(),
                                                     p["key"].max())) + 1)
    return int(counts[p["key"]].sum())


def _rows(table) -> np.ndarray:
    """The valid rows of a result table (either package) as a sorted
    (rows, columns) int64 matrix, columns in name order."""
    valid = np.asarray(table.valid).astype(bool)
    names = sorted(table.columns)
    a = np.stack([np.asarray(table.columns[n])[valid].astype(np.int64)
                  for n in names], 1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def _request(i: int):
    """Request i of a micro-batch: the same keys in every request (the
    colliding case), payloads tagged by the request."""
    build = {"key": np.arange(64, dtype=np.int64),
             "build_payload": np.arange(64, dtype=np.int64) + 1000 * i}
    probe = {"key": np.arange(128, dtype=np.int64) % 96,
             "probe_payload": np.arange(128, dtype=np.int64) + 5000 * i}
    return build, probe


# the flight record's fields held equal value for value (the signature
# digests differ with the packages' program signatures, and the times,
# ids and trace are each package's own)
_RECORD_FIELDS = ("op", "outcome", "matches", "overflow", "new_traces",
                  "cache_hits", "rung_path", "resident", "reason", "tuned")


def _records(service):
    return service.recorder.snapshot()["records"]


def _assert_records_equal(jsvc, tsvc):
    jr, tr = _records(jsvc), _records(tsvc)
    assert len(tr) == len(jr)
    for j, t in zip(jr, tr):
        assert set(t) == set(j)
        assert {k: t.get(k) for k in _RECORD_FIELDS} == {
            k: j.get(k) for k in _RECORD_FIELDS}
        assert t["request_id"] and j["request_id"]
    # one signature class a workload in both packages
    jsig = [r["signature"] for r in jr]
    tsig = [r["signature"] for r in tr]
    assert [jsig.index(s) for s in jsig] == [tsig.index(s) for s in tsig]


_STATS_KEYS = ("served", "failed", "rejected", "pending", "inflight",
               "pending_hwm", "poisoned", "draining", "aggregate", "query")


def _no_rid(v):
    """A value with its minted request ids masked (their nonce is each
    service's own)."""
    return re.sub(r"req-\w+-\d+", "<rid>", v) if isinstance(v, str) else v


def _assert_stats_equal(jsvc, tsvc):
    jst, tst = jsvc.stats(), tsvc.stats()
    assert set(tst) == set(jst)
    assert {k: _no_rid(tst[k]) for k in _STATS_KEYS} == {
        k: _no_rid(jst[k]) for k in _STATS_KEYS}
    for k in ("hits", "misses", "traces", "entries"):
        assert tst["cache"][k] == jst["cache"][k], k
    jops = jsvc.live.snapshot()["ops"]
    tops = tsvc.live.snapshot()["ops"]
    assert {o: s["outcomes"] for o, s in tops.items()} == {
        o: s["outcomes"] for o, s in jops.items()}
    for o in tops:
        for k in ("cache_hits", "new_traces", "retry_rungs"):
            assert tops[o][k] == jops[o][k], (o, k)
        assert tops[o]["latency"]["count"] == jops[o]["latency"]["count"]


# -- the embedded service -------------------------------------------------


@pytest.mark.parametrize("n", RANKS)
def test_join_equals_jax(n):
    """Cold, warm and a second workload: totals, rows, the warm repeat's
    zero builds, the cache, the stats, the live outcomes and the flight
    records as the JAX service's."""
    jsvc, tsvc = _services(n, auto_retry=1)
    (jb, tb), (jp, tp), want = _tables()
    (jb2, tb2), (jp2, tp2), want2 = _tables(seed=12, b_rows=256, p_rows=512)
    for jbuild, tbuild, jprobe, tprobe, w in (
            (jb, tb, jp, tp, want), (jb, tb, jp, tp, want),
            (jb2, tb2, jp2, tp2, want2)):
        jr = jsvc.join(jbuild, jprobe, out_capacity_factor=4.0)
        tr = tsvc.join(tbuild, tprobe, out_capacity_factor=4.0)
        assert int(tr.total) == tr.matches == int(jr.total) == w
        assert tr.new_traces == jr.new_traces
        np.testing.assert_array_equal(_rows(tr.table), _rows(jr.table))
        assert tr.retry_report.n_attempts == jr.retry_report.n_attempts
        assert tr.request_id.startswith("req-")
    assert tsvc.cache.stats()["traces"] == 2
    _assert_stats_equal(jsvc, tsvc)
    _assert_records_equal(jsvc, tsvc)


@pytest.mark.parametrize("n", RANKS)
def test_retry_trail_equals_jax(n):
    """A squeeze in the first program drives the ladder through two
    rungs; the repeat walks both from the cache. The trails, the rung
    paths in the flight records and the live retry counters are JAX's."""
    jsvc, tsvc = _services(n, overflow_programs=1, auto_retry=2)
    (jb, tb), (jp, tp), want = _tables()
    for _ in range(2):
        jr = jsvc.join(jb, jp, out_capacity_factor=4.0)
        tr = tsvc.join(tb, tp, out_capacity_factor=4.0)
        assert int(tr.total) == int(jr.total) == want
        assert [(a.action, a.overflow, a.out_capacity_factor)
                for a in tr.retry_report.attempts] == [
            (a.action, a.overflow, a.out_capacity_factor)
            for a in jr.retry_report.attempts]
        assert tr.retry_report.n_attempts == 2
    assert tsvc.cache.stats()["traces"] == 2
    _assert_stats_equal(jsvc, tsvc)
    _assert_records_equal(jsvc, tsvc)


@pytest.mark.parametrize("n", RANKS)
def test_join_batched_equals_jax(n):
    """K colliding requests in one step: per-request matches and rows
    equal JAX's, one request id across the batch, a second batch a cache
    hit; an oversize batch refuses and a malformed one fails, each with
    JAX's type, message and flight record."""
    jsvc, tsvc = _services(n, auto_retry=1, max_batch_requests=4)
    reqs = [_request(i) for i in range(3)]
    pairs = [(_both(b), _both(p)) for b, p in reqs]
    for _ in range(2):
        jout = jsvc.join_batched([(jb, jp) for (jb, _), (jp, _) in pairs],
                                 slot_build_rows=64, slot_probe_rows=128,
                                 with_rows=True, out_capacity_factor=4.0)
        tout = tsvc.join_batched([(tb, tp) for (_, tb), (_, tp) in pairs],
                                 slot_build_rows=64, slot_probe_rows=128,
                                 with_rows=True, out_capacity_factor=4.0)
        assert [r["matches"] for r in tout] == [r["matches"] for r in jout] \
            == [_oracle(b, p) for b, p in reqs]
        assert [r["new_traces"] for r in tout] == [r["new_traces"]
                                                   for r in jout]
        assert len({r["request_id"] for r in tout}) == 1
        for t, j in zip(tout, jout):
            names = sorted(t["rows"])
            assert names == sorted(j["rows"])
            ta_ = np.stack([t["rows"][c] for c in names], 1)
            ja_ = np.stack([np.asarray(j["rows"][c]) for c in names], 1)
            np.testing.assert_array_equal(ta_[np.lexsort(ta_.T[::-1])],
                                          ja_[np.lexsort(ja_.T[::-1])])
    (jb, tb), (jp, tp) = pairs[0]
    with pytest.raises(js.AdmissionError) as je:
        jsvc.join_batched([(jb, jp)] * 5)
    with pytest.raises(ts.AdmissionError) as te:
        tsvc.join_batched([(tb, tp)] * 5)
    assert str(te.value) == str(je.value)
    other = {"key": np.arange(64, dtype=np.int64),
             "other": np.arange(64, dtype=np.int32)}
    jo, to = _both(other)
    with pytest.raises(ValueError) as je:
        jsvc.join_batched([(jb, jp), (jo, jp)])
    with pytest.raises(ValueError) as te:
        tsvc.join_batched([(tb, tp), (to, tp)])
    assert str(te.value) == str(je.value)
    _assert_stats_equal(jsvc, tsvc)
    _assert_records_equal(jsvc, tsvc)
    assert _records(tsvc)[-1]["reason"] == "batch_combine"
    assert _records(tsvc)[-2]["reason"] == "batch_size"


@pytest.mark.parametrize("n", RANKS)
def test_resident_join_after_append_equals_jax(n):
    """register, a probe-only join, an append merged at once, and the
    join again: totals and rows equal JAX's and the oracle over the
    combined build; the table's stats, the resident stamps of the flight
    records and the counters as JAX's."""
    jsvc, tsvc = _services(n, auto_retry=1)
    b = _side(21, 512, 256, "build_payload")
    p = _side(22, 1024, 256, "probe_payload")
    d = _side(23, 128, 256, "build_payload")
    (jb, tb), (jp, tp), (jd, td) = _both(b), _both(p), _both(d)
    regs = (jsvc.register_table("dim", jb), tsvc.register_table("dim", tb))
    assert regs[1] == {k: regs[0][k] for k in regs[1]}
    for want in (_oracle(b, p), None):
        if want is None:
            apps = (jsvc.append_rows("dim", jd, maintain=True),
                    tsvc.append_rows("dim", td, maintain=True))
            assert apps[1] == {k: apps[0][k] for k in apps[1]}
            comb = {c: np.concatenate([b[c], d[c]]) for c in b}
            want = _oracle(comb, p)
        jr = jsvc.resident_join("dim", jp, out_capacity_factor=4.0)
        tr = tsvc.resident_join("dim", tp, out_capacity_factor=4.0)
        assert int(tr.total) == int(jr.total) == want
        np.testing.assert_array_equal(_rows(tr.table), _rows(jr.table))
        assert tr.resident == jr.resident
    jst, tst = jsvc.resident.stats(), tsvc.resident.stats()
    assert tst["tables"]["dim"] == jst["tables"]["dim"]
    assert (tsvc.drop_table("dim") == jsvc.drop_table("dim")
            == {"table": "dim", "dropped": True})
    _assert_stats_equal(jsvc, tsvc)
    _assert_records_equal(jsvc, tsvc)
    assert [r["resident"]["generation"] for r in _records(tsvc)] == [
        1, 1, 2, 2, None]


@pytest.fixture(scope="module")
def q3_tables():
    """TPC-H Q3's filtered tables at SF 0.01, the JAX package's
    generator's draws, held by both packages."""
    jt = jtpch.query_filters(
        jtpch.generate_tpch_query_tables(seed=5, scale_factor=0.01), "q3")
    tt = {name: Table.from_numpy(
        {c: np.asarray(v) for c, v in t.columns.items()},
        np.asarray(t.valid), device="cpu") for name, t in jt.items()}
    return jt, tt


@pytest.mark.parametrize("n", RANKS)
def test_query_equals_jax(n, q3_tables):
    """The ``query`` path on Q3: the groups equal JAX's, the repeat is
    warm, and the plan counters and the flight records' aggregate stamps
    are JAX's."""
    jt, tt = q3_tables
    jsvc, tsvc = _services(n, auto_retry=3)
    jp_, tp_ = jplan.tpch_query_plan("q3"), tplan.tpch_query_plan("q3")
    gk = list(tp_.aggregate.group_keys)
    for _ in range(2):
        jr = jsvc.query(jt, jp_)
        tr = tsvc.query(tt, tp_)
        assert tr.groups == jr.groups > 0
        assert tr.new_traces == jr.new_traces
        want = ja.groups_frame(jr.table, jp_.aggregate, gk)
        assert ta.frames_equal(
            ta.groups_frame(tr.table, tp_.aggregate, gk),
            {c: want[c].to_numpy() for c in want.columns})
    assert tr.new_traces == 0
    _assert_stats_equal(jsvc, tsvc)
    _assert_records_equal(jsvc, tsvc)
    assert _records(tsvc)[0]["aggregate"] == _records(jsvc)[0]["aggregate"]
    assert _records(tsvc)[0]["signature"] == (
        f"queryplan-{tp_.digest()[:16]}")


@pytest.mark.parametrize("n", RANKS)
def test_workload_signature_digests(n):
    """``planning.tuner.workload_signature``: one workload one digest
    across contents and rungs, each knob its own, in both packages; an
    option set that resolves to no signature falls back to the same
    sha256 in both, digit for digit."""
    jc, tc = _comms(n)
    (jb, tb), (jp, tp), _ = _tables()
    (jb3, tb3), (jp3, tp3), _ = _tables(seed=31)
    variants = [dict(out_capacity_factor=4.0),
                dict(out_capacity_factor=8.0),
                dict(shuffle="ragged"),
                dict(over_decomposition=2),
                dict(skew_threshold=0.01)]
    jd = [jtuner.workload_signature(jc, jb, jp, with_metrics=False, **o)
          for o in variants]
    td = [ttuner.workload_signature(tc, tb, tp, **o) for o in variants]
    assert len(set(td)) == len(set(jd)) == len(variants)
    assert all(re.fullmatch("[0-9a-f]{16}", d) for d in td)
    assert ttuner.workload_signature(tc, tb3, tp3, **variants[0]) == td[0]
    assert jtuner.workload_signature(jc, jb3, jp3, with_metrics=False,
                                     **variants[0]) == jd[0]
    # the service's own key is the same function's
    tsvc = ts.JoinService(tc, device="cpu")
    assert tsvc._workload_signature(tb, tp, "key", variants[0]) == td[0]
    for bad in (dict(not_a_join_option=1), dict(hh_slots="x" * 3,
                                                not_a_join_option=2)):
        assert ttuner.workload_signature(tc, tb, tp, **bad) == \
            jtuner.workload_signature(jc, jb, jp, with_metrics=False, **bad)


# -- refusals -------------------------------------------------------------


def test_admission_draining_and_bad_input_refuse_as_jax(tmp_path):
    """The pending bound, the drain and a malformed input: JAX's types,
    messages and counters; a failing request never leaks its slot."""
    jsvc, tsvc = _services(1, max_pending=2, flight_recorder_path=None)
    (jb, tb), (jp, tp), _ = _tables()
    for svc, b, p, mod in ((jsvc, jb, jp, js), (tsvc, tb, tp, ts)):
        svc._pending = 2
        with pytest.raises(mod.AdmissionError) as e:
            svc.join(b, p)
        svc._pending = 0
        svc.msg = [str(e.value)]
        for _ in range(3):
            with pytest.raises(Exception):
                svc.join(object(), object())
        assert svc._pending == 0 and svc.failed == 3
        svc.join(b, p, out_capacity_factor=4.0)
        svc.config.flight_recorder_path = str(tmp_path / f"{mod.__name__}"
                                              / "fr.json")
        rec = svc.drain(reason="test drain", settle_timeout_s=5.0)
        assert rec["drained"] and rec["pending"] == 0
        assert os.path.exists(rec["flightrecorder"])
        with pytest.raises(mod.DrainingError, match="draining") as e:
            svc.join(b, p, out_capacity_factor=4.0)
        svc.msg.append(str(e.value))
        assert issubclass(mod.DrainingError, mod.AdmissionError)
    assert tsvc.msg == jsvc.msg
    _assert_stats_equal(jsvc, tsvc)
    _assert_records_equal(jsvc, tsvc)
    assert [r.get("reason") for r in _records(tsvc)
            if r["outcome"] == "rejected"] == ["pending", "draining"]


def _drain_workers():
    for t in threading.enumerate():
        if t.name.startswith("watchdog-"):
            t.join(timeout=60.0)


def test_hung_request_poisons_as_jax(tmp_path):
    """A request past its deadline poisons the service: the next one is
    refused, the flight recorder dumps a schema-valid postmortem, and
    counts, live outcomes and record fields are JAX's. The JAX package's
    hang check is ``tests/test_service.py``'s."""
    from distributed_join_tpu.telemetry.analyze import check_file

    (jb, tb), (jp, tp), _ = _tables()
    msgs = []
    svcs = []
    for mod, faulty, plan, comm, tabs in (
            (js, JFaulty, JFaultPlan, jcomm.make_communicator("local"),
             (jb, jp)),
            (ts, TFaulty, TFaultPlan, LocalCommunicator(), (tb, tp))):
        path = str(tmp_path / mod.__name__ / "flightrecorder.json")
        kw = {} if mod is js else {"device": "cpu"}
        svc = mod.JoinService(
            faulty(comm, plan(dispatch_delay_s=2.0)),
            mod.ServiceConfig(request_deadline_s=0.5, auto_retry=0,
                              flight_recorder_path=path), **kw)
        with pytest.raises(Exception) as e:
            svc.join(*tabs, out_capacity_factor=4.0)
        assert type(e.value).__name__ == "HangError"
        assert svc.stats()["poisoned"]
        with pytest.raises(mod.AdmissionError) as e:
            svc.join(*tabs, out_capacity_factor=4.0)
        msgs.append(_no_rid(str(e.value)))
        assert svc.failed == 1 and svc.rejected == 1
        assert svc.flight_recorder_dumped == path
        assert check_file(path) == []
        doc = json.load(open(path))
        assert doc["kind"] == "flightrecorder"
        assert "poisoned" in doc["reason"]
        (rec,) = doc["records"]
        assert rec["outcome"] == "hang" and rec["elapsed_s"] >= 0.5
        svcs.append(svc)
        _drain_workers()
    assert msgs[0] == msgs[1]
    assert isinstance(svcs[1].poisoned, str)
    _assert_stats_equal(*svcs)
    _assert_records_equal(*svcs)
    assert svcs[1].live.snapshot()["ops"]["join"]["outcomes"] == {
        "hang": 1, "rejected": 1}


def test_port_refusals_by_name(tmp_path):
    """What the port lacks refuses by name: a multi-rank process group
    (served by the fleet instead) and ``--platform``. ``--chaos-seed`` is
    ported: the daemon wraps its communicator in the seed's schedule (the
    JAX package's draw), and ``--fault-plan`` goes on top of it. The disk tier (``persist_dir``, ``--persist-dir``),
    ``explain``, the autotuner (``auto_tune``, ``tuner_history``,
    ``--auto-tune``) and the integrity digests (``verify_integrity``,
    ``--verify-integrity``) are ported: a persisted program restarts with
    no new trace, a dry run is served, a malformed one fails, each
    counted; a verified service serves verified joins."""
    tc = LocalCommunicator()
    d = str(tmp_path / "programs")
    (_, tb), (_, tp), want = _tables()
    for restart in range(2):
        disk = ts.JoinService(tc, ts.ServiceConfig(persist_dir=d),
                              device="cpu")
        res = disk.join(tb, tp, out_capacity_factor=4.0)
        assert res.matches == want
        assert res.new_traces == 1 - restart
        assert disk.cache.stats()["disk_loads"] == restart
        assert disk.history.path == os.path.join(d, "history.jsonl")
        disk.history.close()
    verified = ts.JoinService(EmulatedCommunicator(2),
                              ts.ServiceConfig(verify_integrity=True),
                              device="cpu")
    vb, vp = generate_build_probe_tables(seed=3, build_nrows=512,
                                         probe_nrows=512, device="cpu")
    res = verified.join(vb, vp, key="key", out_capacity_factor=3.0)
    assert res.integrity_report.ok
    assert res.integrity_report.checked_pairs == 2 * 2 * 2
    assert verified.explain(vb, vp)["plan"]["with_integrity"]
    for cfg in ({"auto_tune": True}, {"auto_tune": True,
                                      "tuner_history": "missing.jsonl"}):
        tuned = ts.JoinService(tc, ts.ServiceConfig(**cfg), device="cpu")
        assert tuned.stats()["tuner"]["signatures"] == 0
    svc = ts.JoinService(tc, device="cpu")
    from distributed_join_tpu_torch.planning.plan import abstract_tables
    out = svc.explain(*abstract_tables(256, 512))
    assert out["cache"]["would_trace"] and out["plan"]["signature_digest"]
    with pytest.raises(AttributeError):
        svc.explain(None, None)
    assert svc.live.snapshot()["ops"]["explain"]["outcomes"] == {
        "served": 1, "failed": 1}
    pg = ProcessGroupCommunicator(Mesh("gloo", 2, 0, torch.device("cpu")))
    for comm in (pg, TFaulty(pg, TFaultPlan())):
        with pytest.raises(NotImplementedError, match="fleet"):
            ts.JoinService(comm, device="cpu")
    one = ProcessGroupCommunicator(Mesh("gloo", 1, 0, torch.device("cpu")))
    assert ts.JoinService(one).device == torch.device("cpu")
    assert ts.parse_args(["--auto-tune", "1"]).auto_tune == "1"
    args = ts.parse_args(["--verify-integrity", "--device", "cpu"])
    args.request_deadline_s = None   # the daemon's main resolves it
    assert ts._service_from_args(args).config.verify_integrity
    assert not ts.parse_args([]).verify_integrity
    for flag, item in (("--platform", "--device"),):
        err = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            ts.parse_args([flag, "1"])
        assert flag in err.getvalue() and item in err.getvalue()
    from distributed_join_tpu.parallel import chaos as jchaos
    want = dataclasses.asdict(jchaos.random_fault_plan(
        jchaos._trial_rng(1, 0), dispatch_failures=False))
    for extra in ([], ["--fault-plan", '{"seed": 5}']):
        args = ts.parse_args(["--chaos-seed", "1", "--device", "cpu",
                              *extra])
        args.request_deadline_s = None
        comm = ts._service_from_args(args).comm
        assert isinstance(comm, TFaulty)
        if extra:   # the scripted plan wraps the seeded one
            assert comm.plan == TFaultPlan(seed=5)
            comm = comm._inner
        assert dataclasses.asdict(comm.plan) == want
    assert ts.parse_args([]).chaos_seed is None
    assert ts.parse_args(["--persist-dir", d]).persist_dir == d
    # the run diagnosis is ported: the daemon takes --diagnose, as the JAX
    # daemon does
    assert ts.parse_args(["--diagnose"]).diagnose


def test_concurrent_requests_keep_every_count():
    """32 threads, more than the cores, send 4 joins each at a shortened
    switch interval against a service that admits 3 at a time: every
    request is served or refused (none lost, none counted twice), the
    admission slots all come back, the live metrics and the flight
    records count each request once, and every id is unique."""
    (_, tb), (_, tp), want = _tables()
    svc = ts.JoinService(LocalCommunicator(), ts.ServiceConfig(
        max_pending=3, flight_records=1024), device="cpu")
    svc.join(tb, tp, out_capacity_factor=4.0)       # the build, outside
    outcomes, lock = [], threading.Lock()

    def client(k):
        for i in range(4):
            try:
                res = svc.join(tb, tp, out_capacity_factor=4.0,
                               request_id=f"c{k}-{i}")
                got = ("served", res.request_id, res.matches)
            except ts.AdmissionError as exc:
                got = ("rejected", f"c{k}-{i}", str(exc))
            with lock:
                outcomes.append(got)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    served = [o for o in outcomes if o[0] == "served"]
    assert len(outcomes) == 128 and served
    assert all(o[2] == want for o in served)
    assert all("max_pending=3" in o[2] for o in outcomes
               if o[0] == "rejected")
    st = svc.stats()
    assert st["served"] == len(served) + 1
    assert st["rejected"] == 128 - len(served) and st["failed"] == 0
    assert st["pending"] == 0 and 1 <= st["pending_hwm"] <= 3
    assert sum(svc.live.snapshot()["ops"]["join"]["outcomes"].values()) \
        == 129
    rids = [r["request_id"] for r in _records(svc)]
    assert len(rids) == 129 and len(set(rids)) == 129


def test_minted_ids_unique_and_capped():
    """Minted ids carry a per-service nonce, so a client id shaped like
    one never aliases a minted id; long client ids are capped to 64
    characters without aliasing, as JAX's are."""
    jsvc, tsvc = _services(1)
    for svc in (jsvc, tsvc):
        with svc._admit_lock:
            client_style = svc._mint_request_id("req-000002")
            minted = [svc._mint_request_id(None) for _ in range(3)]
            long_a = svc._mint_request_id("x" * 80 + "a")
            long_b = svc._mint_request_id("x" * 80 + "b")
        assert client_style == "req-000002" and client_style not in minted
        assert len(set(minted)) == 3
        assert long_a != long_b and len(long_a) <= 64
        svc.longs = (long_a, long_b)
    assert tsvc.longs == jsvc.longs


# -- the history store (the JAX test is red on this jax) -----------------


def test_history_store_records_requests(tmp_path):
    """``tests/test_service.py::test_history_store_records_requests``'s
    expectations: one line a request, the same signature for a warm
    repeat, two signatures in the summary, no drift, a file the JAX
    package's schema check passes. With the session on the joins run the
    metrics tape, so each entry's counter signature holds its matches,
    and each carries the cost model's prediction. The entries' keys are
    those of the JAX service's entries (written without a session, where
    its path runs)."""
    from distributed_join_tpu.telemetry import history as jhist
    from distributed_join_tpu.telemetry.analyze import check_file

    tc = EmulatedCommunicator(4)
    tsvc = ts.JoinService(tc, ts.ServiceConfig(
        auto_retry=1, history_dir=str(tmp_path / "hist")), device="cpu")
    (jb1, tb1), (jp1, tp1), _ = _tables()
    (_, tb2), (_, tp2) = map(_both, _request(0))
    with ttel.session(str(tmp_path / "tel")):
        tsvc.join(tb1, tp1, out_capacity_factor=4.0)
        tsvc.join(tb1, tp1, out_capacity_factor=4.0)
        tsvc.join(tb2, tp2, out_capacity_factor=4.0)
    entries, malformed = thist.load_history(str(tmp_path / "hist"))
    assert malformed == 0 and len(entries) == 3
    assert all(e["kind"] == "request" and e["request_id"]
               and e["wall_s"] > 0 for e in entries)
    assert entries[0]["signature"] == entries[1]["signature"]
    assert entries[1]["new_traces"] == 0
    for e in entries:
        assert e["counter_signature"]["counters"]["matches"] == e["matches"]
        assert e["prediction"]["predicted_wall_s"] > 0
        assert e["prediction"]["wall_ratio"] > 0
    assert entries[0]["platform"] == "cpu"
    summary = thist.summarize(entries)
    assert summary["n_signatures"] == 2
    sig0 = summary["signatures"][entries[0]["signature"]]
    assert sig0["entries"] == 2 and sig0["outcomes"] == {"served": 2}
    assert not sig0["counter_drift"]
    assert sig0["prediction"]["n"] == 2
    assert check_file(tsvc.history.path) == []
    jsvc = js.JoinService(jcomm.make_communicator("local"), js.ServiceConfig(
        auto_retry=1, history_dir=str(tmp_path / "jhist")))
    jsvc.join(jb1, jp1, out_capacity_factor=4.0)
    (jentry,), _ = jhist.load_history(str(tmp_path / "jhist"))
    assert set(entries[0]) == set(jentry)


# -- over TCP --------------------------------------------------------------


def _wire_ops(n_rows=256):
    q = {"op": "join", "build_nrows": n_rows, "probe_nrows": n_rows,
         "seed": 7, "selectivity": 0.5, "out_capacity_factor": 4.0}
    small = [{k: v for k, v in dict(q, seed=20 + i).items() if k != "op"}
             for i in range(3)]
    return [
        {"op": "ping"},
        q,
        {"op": "batch", "requests": small, "out_capacity_factor": 4.0},
        {"op": "register", "name": "dim", "rows": 512, "seed": 9},
        {"op": "join", "table": "dim", "probe_nrows": 256, "seed": 9,
         "out_capacity_factor": 4.0},
        {"op": "append", "name": "dim", "rows": 64, "seed": 10},
        {"op": "tables"},
        {"op": "query", "query": "q3", "scale_factor": 0.01},
        {"op": "drop", "name": "dim"},
        {"op": "explain", "build_nrows": 256, "probe_nrows": 256},
        {"op": "metrics"},
        {"op": "metrics", "format": "prometheus"},
        {"op": "stats"},
        {"op": "shutdown"},
    ]


def _answers(service, payloads):
    server, port = (js if isinstance(service, js.JoinService)
                    else ts).start_daemon(service)
    client = ts.ServiceClient("127.0.0.1", port)
    try:
        return [client.send(dict(p)) for p in payloads]
    finally:
        client.close()
        server.server_close()


@pytest.mark.parametrize("n", RANKS)
def test_daemon_answers_every_wire_op_with_jax_keys(n, tmp_path):
    """Every ``daemon_ops`` op over TCP: the port's daemon answers with
    the JAX daemon's response keys (``explain`` with the JAX plan's
    record fields), and an unknown op answers the client with JAX's
    error. The builds and hits are JAX's; the matches are not compared
    (the generators differ)."""
    jsvc, tsvc = _services(n, auto_retry=1)
    payloads = _wire_ops()
    assert {p["op"] for p in payloads} | {"drain"} == set(
        WIRE_OPS["daemon_ops"])
    jresp = _answers(jsvc, payloads)
    tresp = _answers(tsvc, payloads)
    for p, j, t in zip(payloads, jresp, tresp):
        op = p["op"]
        assert t["ok"] and j["ok"], (op, t, j)
        if op == "explain":
            assert set(t["plan"]) == set(j["plan"])
            assert set(t["cache"]) == set(j["cache"])
            assert t["plan"]["capacities"] == j["plan"]["capacities"]
            assert t["plan"]["wire"] == j["plan"]["wire"]
        assert set(t) == set(j), (op, set(t) ^ set(j))
        if op == "metrics" and "metrics" in t:
            assert set(t["metrics"]) == set(j["metrics"])
            assert set(t["metrics"]["stats"]) == set(j["metrics"]["stats"])
        if op in ("join", "batch"):
            # the generators' bits differ (torch.Generator, jax.random):
            # the wire's tables are each package's own draws
            assert t["new_traces"] == j["new_traces"]
    drain = {"op": "drain", "reason": "test", "settle_timeout_s": 5.0}
    jsvc2, tsvc2 = _services(n)
    for svc, name in ((jsvc2, "j"), (tsvc2, "t")):
        svc.config.flight_recorder_path = str(tmp_path / name / "fr.json")
    (jd,), (td,) = _answers(jsvc2, [drain]), _answers(tsvc2, [drain])
    assert td["ok"] and set(td) == set(jd)
    bad = _answers(ts.JoinService(LocalCommunicator(), device="cpu"),
                   [{"op": "nope"}])[0]
    jbad = _answers(js.JoinService(jcomm.make_communicator("local")),
                    [{"op": "nope"}])[0]
    assert {k: bad[k] for k in ("ok", "error", "message")} == {
        k: jbad[k] for k in ("ok", "error", "message")}


def test_resident_wire_probe_is_the_generators(tmp_path):
    """A resident wire ``join`` at the registration seed draws exactly
    ``generate_build_probe_tables(seed)``'s probe (the generator's state
    after the build is kept at registration), so its matches are the
    full join's; another seed draws a probe of its own."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )

    svc = ts.JoinService(LocalCommunicator(), device="cpu")
    server, port = ts.start_daemon(svc)
    client = ts.ServiceClient("127.0.0.1", port)
    try:
        for unique in (False, True):
            name = f"dim{int(unique)}"
            reg = {"op": "register", "name": name, "rows": 3000, "seed": 17,
                   "unique_keys": unique}
            assert client.send(reg)["ok"]
            handle = svc.resident.get(name)
            build, probe = generate_build_probe_tables(
                seed=17, build_nrows=3000, probe_nrows=1000,
                unique_build_keys=unique, device="cpu")
            assert torch.equal(handle.wire_build_keys, build.columns["key"])
            spec = {"op": "join", "table": name, "probe_nrows": 1000,
                    "seed": 17}
            drawn = ts._probe_from_spec(spec, handle, "cpu")
            for c in probe.columns:
                assert torch.equal(drawn.columns[c], probe.columns[c])
            resp = client.send(spec)
            want = int(distributed_inner_join(build, probe,
                                              LocalCommunicator()).total)
            assert resp["ok"] and resp["matches"] == want > 0
            other = ts._probe_from_spec(dict(spec, seed=18), handle, "cpu")
            assert not torch.equal(other.columns["key"], probe.columns["key"])
    finally:
        client.send({"op": "shutdown"})
        client.close()
        server.server_close()


def test_client_reconnects_with_backoff_and_surfaces_attempts():
    """``ServiceClient(retries=)``: a torn connection is reconnected and
    the payload resent; a dead port raises ``ConnectionError`` with the
    attempt count; a mutating op is not resent after a tear."""
    state = {"conns": 0}

    class FlakyHandler(socketserver.StreamRequestHandler):
        def handle(self):
            state["conns"] += 1
            if state["conns"] <= 2:
                return  # tear the connection without answering
            for raw in self.rfile:
                line = raw.strip()
                if not line:
                    continue
                req = json.loads(line)
                if req.get("op") == "append" and state["conns"] == 3:
                    return  # tear after a mutating op's write
                self.wfile.write((json.dumps(
                    {"ok": True, "op": req.get("op")}) + "\n").encode())
                self.wfile.flush()

    class S(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = S(("127.0.0.1", 0), FlakyHandler)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        client = ts.ServiceClient("127.0.0.1", port, retries=3,
                                  backoff_s=0.01)
        with pytest.raises(ConnectionError, match="not resending"):
            client.send({"op": "append", "name": "t", "rows": 1})
        assert client.send({"op": "ping"})["ok"]
        client.close()
    finally:
        srv.shutdown()
        srv.server_close()
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(ConnectionError, match="after 2 attempt"):
        ts.ServiceClient("127.0.0.1", dead_port, retries=1, backoff_s=0.01)
    with pytest.raises(ConnectionError, match="after 1 attempt"):
        ts.ServiceClient("127.0.0.1", dead_port)
    assert ts.ServiceClient.RESENDABLE_OPS == frozenset(
        WIRE_OPS["resendable_ops"]) == js.ServiceClient.RESENDABLE_OPS


def test_watch_renders_like_jax():
    """The console's line for one canned ``metrics`` answer (per-op and
    per-tenant segments, a poisoned service) is JAX's character for
    character; against a live daemon it polls ``count`` times; an
    unreachable daemon is one line and rc 1."""
    canned = {"ok": True, "op": "metrics", "metrics": {
        "uptime_s": 12.5, "qps_60s": 3.25, "stats": {
            "served": 40, "failed": 2, "rejected": 1, "inflight": 1,
            "latency": {"p50_s": 0.0042, "p95_s": 0.01, "p99_s": 0.03},
            "cache": {"hits": 37, "traces": 3},
            "latency_by_op": {"join": {"p50_s": 0.004, "p95_s": 0.009,
                                       "p99_s": 0.02},
                              "batch": {"p50_s": None, "p95_s": 0.1,
                                        "p99_s": 0.2}},
            "tenants": {"acme": {"qps_60s": 1.5, "shed": 2,
                                 "latency": {"p95_s": 0.005}}},
            "poisoned": "request req-1 did not complete"}}}

    class Canned(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                if raw.strip():
                    self.wfile.write((json.dumps(canned) + "\n").encode())
                    self.wfile.flush()

    class S(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = S(("127.0.0.1", 0), Canned)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        outs = []
        for mod in (js, ts):
            out = io.StringIO()
            assert mod.watch("127.0.0.1", port, interval_s=0.01, count=2,
                             out=out) == 0
            outs.append(out.getvalue())
        assert outs[0] == outs[1]
        assert "acme{qps 1.50 shed 2" in outs[1] and "POISONED" in outs[1]
    finally:
        srv.shutdown()
        srv.server_close()
    svc = ts.JoinService(LocalCommunicator(), device="cpu")
    server, port = ts.start_daemon(svc)
    try:
        out = io.StringIO()
        assert ts.watch("127.0.0.1", port, interval_s=0.05, count=2,
                        out=out) == 0
        lines = out.getvalue().strip().splitlines()
        assert len(lines) == 2 and "served" in lines[0] and "p99" in lines[0]
        assert "{qps" not in lines[0]
        client = ts.ServiceClient("127.0.0.1", port)
        q = {"op": "join", "build_nrows": 256, "probe_nrows": 256,
             "seed": 7, "selectivity": 0.5, "out_capacity_factor": 4.0,
             "tenant": "acme"}
        assert client.send(q)["ok"]
        client.close()
        out = io.StringIO()
        assert ts.watch("127.0.0.1", port, interval_s=0.05, count=1,
                        out=out) == 0
        assert "acme{qps" in out.getvalue()
    finally:
        server.shutdown()
        server.server_close()
    out = io.StringIO()
    assert ts.watch("127.0.0.1", 1, interval_s=0.05, count=1, out=out) == 1
    assert "cannot reach daemon" in out.getvalue()


def test_request_id_propagation_over_tcp(tmp_path):
    """``tests/test_service.py::test_request_id_propagation_over_tcp``'s
    expectations: a minted id and a client id come back on the wire, and
    each tags the request span and the events of its execution in the
    event log and the Chrome trace."""
    svc = ts.JoinService(EmulatedCommunicator(4), ts.ServiceConfig(
        auto_retry=1), device="cpu")
    server, port = ts.start_daemon(svc)
    client = ts.ServiceClient("127.0.0.1", port)
    try:
        with ttel.session(str(tmp_path / "tel")) as sink:
            q = {"op": "join", "build_nrows": 256, "probe_nrows": 256,
                 "seed": 7, "selectivity": 0.5, "out_capacity_factor": 4.0}
            r1 = client.send(q)
            r2 = client.send(dict(q, request_id="client-abc"))
            events_path, trace_path = sink.events_path, sink.trace_path
        assert r1["ok"] and r1["request_id"]
        assert r2["ok"] and r2["request_id"] == "client-abc"
        assert r1["request_id"] != r2["request_id"]
    finally:
        client.close()
        server.server_close()
    events = [json.loads(line) for line in open(events_path)]
    for rid in (r1["request_id"], "client-abc"):
        tagged = [e for e in events if e.get("request_id") == rid]
        assert any(e["kind"] == "span" and e["name"] == "request"
                   for e in tagged), rid
        assert any(e["kind"] == "event" for e in tagged), rid
    trace = json.load(open(trace_path))
    span_args = [e["args"] for e in trace["traceEvents"]
                 if e["name"] == "request" and e["ph"] == "X"]
    assert {a["request_id"] for a in span_args} == {
        r1["request_id"], "client-abc"}


def _delayed_daemon(tmp_path=None):
    comm = TFaulty(EmulatedCommunicator(2),
                   TFaultPlan(dispatch_delay_s=1.0, delay_after_dispatches=1))
    cfg = ts.ServiceConfig(flight_recorder_path=(
        str(tmp_path / "fr.json") if tmp_path else None))
    svc = ts.JoinService(comm, cfg, device="cpu")
    server, port = ts.start_daemon(svc)
    return svc, server, port


_Q = {"op": "join", "build_nrows": 256, "probe_nrows": 256, "seed": 7,
      "selectivity": 0.5, "out_capacity_factor": 4.0}


def test_shutdown_waits_on_exec_lock_before_ack():
    """``shutdown``'s reply waits (bounded) for a join still dispatching
    on another connection, and reports ``quiesced``."""
    svc, server, port = _delayed_daemon()
    c1 = ts.ServiceClient("127.0.0.1", port)
    c2 = ts.ServiceClient("127.0.0.1", port)
    done = {}
    try:
        assert c1.send(dict(_Q))["ok"]

        def slow_join():
            done["resp"] = c1.send(dict(_Q))

        t = threading.Thread(target=slow_join)
        t.start()
        time.sleep(0.3)
        t_sent = time.monotonic()
        resp = c2.send({"op": "shutdown", "quiesce_timeout_s": 10.0})
        t_ack = time.monotonic()
        t.join(timeout=30.0)
        assert resp["ok"] and resp["quiesced"] is True
        assert done["resp"]["ok"]
        assert t_ack - t_sent >= 0.4
    finally:
        c1.close()
        c2.close()
        server.server_close()


def test_drain_wire_op_settles_inflight_then_refuses(tmp_path):
    """``drain``: an in-flight join on another connection completes
    before the acknowledgement, the flight recorder lands, and a
    connection opened before the drain is then refused with
    ``DrainingError``."""
    svc, server, port = _delayed_daemon(tmp_path)
    c1 = ts.ServiceClient("127.0.0.1", port)
    c2 = ts.ServiceClient("127.0.0.1", port)
    c3 = ts.ServiceClient("127.0.0.1", port)
    done = {}
    try:
        assert c1.send(dict(_Q))["ok"]

        def slow_join():
            done["resp"] = c1.send(dict(_Q))
            done["t"] = time.monotonic()

        t = threading.Thread(target=slow_join)
        t.start()
        time.sleep(0.3)
        resp = c2.send({"op": "drain", "reason": "test",
                        "settle_timeout_s": 10.0})
        t_drained = time.monotonic()
        t.join(timeout=30.0)
        assert resp["ok"] and resp["drained"] and resp["pending"] == 0
        assert done["resp"]["ok"] and t_drained >= done["t"]
        assert resp["flightrecorder"] == str(tmp_path / "fr.json")
        late = c3.send(dict(_Q))
        assert not late["ok"] and late["error"] == "DrainingError"
    finally:
        for c in (c1, c2, c3):
            c.close()
        server.server_close()
    assert svc.draining == "test"


def _module_env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("DJTPU_GUARD_DEADLINE_S", None)
    return env


def test_sigterm_drains_daemon_and_exits_zero(tmp_path):
    """SIGTERM on the serving daemon: drain, flush the flight recorder,
    exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_join_tpu_torch.service.server",
         "--host", "127.0.0.1", "--port", "0", "--communicator", "emulated",
         "--n-ranks", "2", "--device", "cpu",
         "--flight-recorder-path", str(tmp_path / "fr.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=_module_env())
    try:
        port = None
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"daemon exited early rc={proc.poll()}")
            if "listening on " in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port is not None
        client = ts.ServiceClient("127.0.0.1", port)
        assert client.send(dict(_Q))["ok"]
        client.close()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60.0)
        assert rc == 0, f"SIGTERM exit was rc={rc}"
        doc = json.load(open(tmp_path / "fr.json"))
        assert doc["reason"] == "drained: SIGTERM"
        assert [r["outcome"] for r in doc["records"]] == ["served"]
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


def test_smoke_cli_exits_zero(tmp_path):
    """``--smoke`` through the real TCP loop on the CPU: rc 0, a run-only
    warm repeat, two or more history signatures, the drills, and the
    explain step (the warm query's program predicted resident); the
    baseline gate reports the committed 8-rank baselines as drawn
    elsewhere (this run is one rank), and nothing is ``not_ported``."""
    out = subprocess.run(
        [sys.executable, "-m", "distributed_join_tpu_torch.service.server",
         "--smoke", "--device", "cpu", "--smoke-no-wall-gate",
         "--history-dir", str(tmp_path / "hist"),
         "--flight-recorder-path", str(tmp_path / "fr.json")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_module_env())
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["benchmark"] == "service_smoke"
    assert rec["warm_new_traces"] == 0 and not rec["violations"]
    assert rec["history"]["n_signatures"] >= 2
    assert "not_ported" not in rec
    for name in ("service_smoke", "resident_smoke"):
        assert "drawn at" in rec["baseline_gate"][name]["skipped"]
    assert rec["counter_signature"]["n_ranks"] == 1
    assert rec["explain"]["cache"]["resident"]
    assert rec["explain"]["predicted_wall_s"] > 0
    assert rec["poison_drill"]["rejected_after_poison"] == 1
    assert (rec["resident_drill"]["matches_after_appends"]
            > rec["resident_drill"]["matches_probe_only"])
