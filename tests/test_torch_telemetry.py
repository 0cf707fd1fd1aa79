"""PyTorch port vs the JAX package: the telemetry session on the CPU.

Mirrors the host-side cases of ``tests/test_telemetry.py`` on the port's
``telemetry`` package, and holds the port's records against the JAX
package's on the same calls: the event logs and Chrome traces (counter
tracks, request tags), the span sequences of the join steps (names,
paths and ``batch`` payloads; the JAX steps run with
``with_metrics=False``, whose metrics tape the port does not have), the
out-of-core loop's counters and events, the history store's lines, and
the driver records with the session off and on. Stripped before a
comparison, and nothing else: timestamps and durations (``ts_us``,
``dur_us``, ``ts``, ``dur``, the phase seconds), the session epoch, thread
ids, pids and file paths of the two sessions.
"""

import contextlib
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu as jdj
from distributed_join_tpu import telemetry as jtel
from distributed_join_tpu.benchmarks import distributed_join as jdriver
from distributed_join_tpu.ops import aggregate as jagg
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.parallel import out_of_core as jooc
from distributed_join_tpu.service import programs as jprog
from distributed_join_tpu.service import resident as jres
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.telemetry import history as jhist
from distributed_join_tpu.telemetry.analyze import check_file
from distributed_join_tpu_torch import telemetry as ttel
from distributed_join_tpu_torch.benchmarks import distributed_join as tdriver
from distributed_join_tpu_torch.benchmarks import report, run_guarded
from distributed_join_tpu_torch.ops import aggregate as tagg
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import out_of_core as tooc
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.service import programs as tprog
from distributed_join_tpu_torch.service import resident as tres
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.telemetry import history as thist

TIME_KEYS = ("ts_us", "dur_us", "ts", "dur", "tid", "epoch_s")


@pytest.fixture(autouse=True)
def _no_leaked_session():
    jtel.finalize()
    ttel.finalize()
    yield
    jtel.finalize()
    ttel.finalize()


@pytest.fixture(scope="module")
def jcomms():
    return {n: jcomm.make_communicator("tpu", n_ranks=n) for n in (1, 4)}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in TIME_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _tables(seed=11, build=512, probe=1024, rand_max=256):
    rng = np.random.default_rng(seed)
    b = {"key": rng.integers(0, rand_max, build),
         "build_payload": rng.integers(0, 1 << 20, build)}
    p = {"key": rng.integers(0, rand_max, probe),
         "probe_payload": rng.integers(0, 1 << 20, probe)}
    bv, pv = np.ones(build, bool), rng.random(probe) >= 0.05
    return b, bv, p, pv


def _jt(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _tt(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


# -- the sink: counter tracks, request tags -----------------------------------


def _counter_session(tel, d):
    with tel.session(d, rank=0) as sink:
        tel.counter_add("demo.rows", 5)
        tel.counter_add("demo.rows", 7)
        tel.counter_add("demo.bytes", 100)
        trace_path = sink.trace_path
    return json.load(open(trace_path)), trace_path


def test_counter_track_events_in_chrome_trace(tmp_path):
    got, path = _counter_session(ttel, str(tmp_path / "t"))
    want, _ = _counter_session(jtel, str(tmp_path / "j"))
    assert _strip(got["traceEvents"]) == _strip(want["traceEvents"])
    assert set(got["otherData"]) == set(want["otherData"])
    counters = [e for e in got["traceEvents"] if e["ph"] == "C"]
    assert [e["args"]["value"] for e in counters
            if e["name"] == "demo.rows"] == [5, 12]
    assert check_file(path) == []   # the JAX package's reader


def _request_session(tel, d):
    with tel.session(d, rank=0) as sink:
        tel.event("before")
        with tel.request_scope("req-000042"):
            tel.event("inside")
            with tel.span("request_stage"):
                pass
            t = threading.Thread(target=lambda: tel.event("from_worker"))
            t.start()
            t.join(30)
            assert not t.is_alive()
        tel.event("after")
        paths = sink.events_path, sink.trace_path
    return _events(paths[0]), json.load(open(paths[1]))


def test_request_scope_tags_events_and_spans(tmp_path):
    events, trace = _request_session(ttel, str(tmp_path / "t"))
    jevents, jtrace = _request_session(jtel, str(tmp_path / "j"))
    assert _strip(events) == _strip(jevents)
    assert _strip(trace["traceEvents"]) == _strip(jtrace["traceEvents"])
    by_name = {e["name"]: e for e in events}
    for name in ("inside", "from_worker", "request_stage"):
        assert by_name[name]["request_id"] == "req-000042"
    assert "request_id" not in by_name["before"]
    assert "request_id" not in by_name["after"]


def test_request_scope_noop_when_off():
    assert not ttel.enabled()
    with ttel.request_scope("req-1"):
        ttel.event("ignored")


def test_payload_request_id_wins_over_scope(tmp_path):
    out = {}
    for name, tel in (("t", ttel), ("j", jtel)):
        with tel.session(str(tmp_path / name), rank=0) as sink:
            with tel.request_scope("req-A"):
                tel.event("request_rejected", request_id="req-B")
                tel.event("scoped_event")
            path = sink.events_path
        out[name] = _events(path)
    assert _strip(out["t"]) == _strip(out["j"])
    by_name = {e["name"]: e for e in out["t"]}
    assert by_name["request_rejected"]["request_id"] == "req-B"
    assert by_name["scoped_event"]["request_id"] == "req-A"


def test_summary_keys_are_jax(tmp_path):
    """The summary has every key of the JAX package's (``metrics`` None:
    no metrics tape), plus the device trace's file where one ran."""
    with ttel.session(str(tmp_path / "t"), rank=0):
        ttel.counter_add("c", 1)
        with ttel.span("s"):
            pass
        got = ttel.summary()
    with jtel.session(str(tmp_path / "j"), rank=0):
        jtel.counter_add("c", 1)
        with jtel.span("s"):
            pass
        want = jtel.summary()
    assert set(got) == set(want)
    assert got["counters"] == want["counters"] and got["metrics"] is None
    assert got["spans"]["s"]["count"] == want["spans"]["s"]["count"] == 1
    assert json.load(open(tmp_path / "t" / "summary.json"))["rank"] == 0
    with ttel.session(str(tmp_path / "d"), rank=0, trace=True):
        assert ttel.summary()["device_trace_path"] is None


def test_metrics_and_stage_profile_refuse_by_name(tmp_path):
    """``emit_metrics`` folds a device metrics block into the session
    (the tape is ported); ``stage_profile`` draws a record into the
    session's trace (ported too) and is a no-op without a session."""
    import torch

    from distributed_join_tpu_torch.telemetry.metrics import Metrics

    assert ttel.emit_metrics(None) is None
    ttel.stage_profile(None)
    block = Metrics(names=("matches", "probe.overflow_margin_min"),
                    values=torch.tensor([[3, 7], [4, 5]]))
    want = {"n_ranks": 2,
            "per_rank": {"matches": [3, 4],
                         "probe.overflow_margin_min": [7, 5]},
            "reduced": {"matches": 7, "probe.overflow_margin_min": 5}}
    assert ttel.emit_metrics(block) == want
    with ttel.session(str(tmp_path)) as sink:
        ttel.emit_metrics(block)
        assert ttel.summary()["metrics"] == want
    assert [e["payload"] for e in _events(sink.events_path)
            if e["name"] == "metrics"] == [{"reduced": want["reduced"]}]
    ttel.stage_profile({"stages": {}})      # no session: nothing drawn
    rec = {"stages": {"join": {"ran": True, "wall_s": 0.002,
                               "counters": {"matches": 7}}},
           "monolithic": {"wall_s": 0.001}}
    with ttel.session(str(tmp_path / "sp"), rank=0):
        ttel.stage_profile(rec)
    trace = json.load(open(tmp_path / "sp" / "trace.rank0.json"))
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "stageprof" and e["ph"] == "X"}
    assert names == {"join", "join counters", "monolithic"}


# -- the steps' spans ---------------------------------------------------------


def _spans(path):
    return [(e["name"], e["path"], e["payload"]) for e in _events(path)
            if e["kind"] == "span"]


def _spans_of(tel, d, fn):
    with tel.session(d, rank=0) as sink:
        fn()
        path = sink.events_path
    return _spans(path)


STEP_CASES = {
    "1_padded": (1, dict()),
    "1_ragged": (1, dict(shuffle="ragged")),
    "4_padded": (4, dict()),
    "4_ragged": (4, dict(shuffle="ragged")),
    "4_padded_k2": (4, dict(over_decomposition=2)),
    "4_ragged_k2": (4, dict(shuffle="ragged", over_decomposition=2)),
    "4_ppermute_k2": (4, dict(shuffle="ppermute", over_decomposition=2)),
    "4_compressed": (4, dict(compression_bits=32)),
    "4_skew": (4, dict(skew_threshold=0.05)),
    "4_segmented": (4, dict(sort_mode="segmented", sort_segments=2)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_spans_equal_jax(tmp_path, jcomms, case):
    """One call of the port's step with a session on records the span
    names, paths and ``batch`` payloads of one trace of the JAX step, on
    rank 0 only under the emulated communicator."""
    n, opts = STEP_CASES[case]
    b, bv, p, pv = _tables()
    opts = dict(opts, key="key", out_capacity_factor=4.0)
    jfn = jdist.make_distributed_join(jcomms[n], with_metrics=False, **opts)
    tcomm = LocalCommunicator() if n == 1 else EmulatedCommunicator(n)
    tfn = tdist.make_distributed_join(tcomm, **opts)
    jb, jp, tb, tp = _jt(b, bv), _jt(p, pv), _tt(b, bv), _tt(p, pv)
    want = _spans_of(jtel, str(tmp_path / "j"), lambda: jfn(jb, jp))
    got = _spans_of(ttel, str(tmp_path / "t"), lambda: tfn(tb, tp))
    assert got == want and got
    # per call, not per compile: a second call records them again
    twice = _spans_of(ttel, str(tmp_path / "t2"),
                      lambda: (tfn(tb, tp), tfn(tb, tp)))
    assert twice == got + got


@pytest.mark.parametrize("n,group", [(1, "key"), (4, "key"),
                                     (4, "probe_payload")])
def test_aggregate_step_spans_equal_jax(tmp_path, jcomms, n, group):
    """The fused join+aggregate step: ``join_agg`` (a batch's), and in
    probe mode ``agg_combine`` and ``partials_exchange``."""
    b, bv, p, pv = _tables(rand_max=64)
    p["probe_payload"] = p["probe_payload"] % 16
    spec = {"group_by": [group], "aggs": [["count", None, "n"],
                                          ["sum", "build_payload", "s"]]}
    opts = dict(key="key", out_capacity_factor=8.0, over_decomposition=2)
    jfn = jdist.make_distributed_join(
        jcomms[n], with_metrics=False,
        aggregate=jagg.AggregateSpec.of(spec["group_by"], spec["aggs"]),
        **opts)
    tcomm = LocalCommunicator() if n == 1 else EmulatedCommunicator(n)
    tfn = tdist.make_distributed_join(
        tcomm, aggregate=tagg.AggregateSpec.of(spec["group_by"],
                                               spec["aggs"]), **opts)
    want = _spans_of(jtel, str(tmp_path / "j"),
                     lambda: jfn(_jt(b, bv), _jt(p, pv)))
    got = _spans_of(ttel, str(tmp_path / "t"),
                    lambda: tfn(_tt(b, bv), _tt(p, pv)))
    assert got == want
    names = {s[0] for s in got}
    assert "join_agg" in names
    if group != "key":
        assert "agg_combine" in names
        assert ("partials_exchange" in names) == (n > 1)


@pytest.mark.parametrize("n", [1, 4])
def test_resident_spans_and_events_equal_jax(tmp_path, jcomms, n):
    """Registration's ``partition``/``shuffle``/``sort``, the served
    join's ``resident_join`` around the probe-only step's spans (its
    payload's ``sync_value`` the fetched total), an append and its
    maintenance (``merge_sort``), and the ``resident_*`` and
    ``program_cache_trace`` events."""
    b, bv, p, pv = _tables()
    delta = {k: v[:64] for k, v in b.items()}
    tcomm = LocalCommunicator() if n == 1 else EmulatedCommunicator(n)

    def jrun():
        reg = jres.ResidentTableRegistry(jcomms[n],
                                         jprog.JoinProgramCache(jcomms[n]))
        reg.register("dim", _jt(b, bv))
        reg.join("dim", _jt(p, pv), with_metrics=False,
                 out_capacity_factor=4.0)
        reg.append("dim", _jt(delta, np.ones(64, bool)), maintain=True)
        reg.drop("dim")

    def trun():
        reg = tres.ResidentTableRegistry(tcomm, tprog.JoinProgramCache(tcomm))
        reg.register("dim", _tt(b, bv))
        reg.join("dim", _tt(p, pv), out_capacity_factor=4.0)
        reg.append("dim", _tt(delta, np.ones(64, bool)), maintain=True)
        reg.drop("dim")

    logs = {}
    for name, tel, fn in (("j", jtel, jrun), ("t", ttel, trun)):
        with tel.session(str(tmp_path / name), rank=0) as sink:
            fn()
            logs[name] = _events(sink.events_path)
    spans = {k: [(e["name"], e["path"], e["payload"]) for e in v
                 if e["kind"] == "span"] for k, v in logs.items()}
    assert spans["t"] == spans["j"]
    assert any(s[0] == "resident_join" and s[2]["sync_value"] > 0
               for s in spans["t"])
    kinds = ("resident_register", "resident_append", "resident_maintain",
             "resident_drop", "program_cache_trace")
    events = {k: [(e["name"], {kk: vv for kk, vv in e["payload"].items()
                               if kk not in ("bytes", "digest")})
                  for e in v if e["name"] in kinds]
              for k, v in logs.items()}
    assert events["t"] == events["j"] and events["t"]


def test_with_metrics_none_runs_the_step_with_a_session(tmp_path):
    """With a session on, ``with_metrics=None`` (what the JAX drivers
    leave it at) resolves to the session's state, as in the JAX package:
    the join runs with the tape, and its counters reach the summary.
    Without a session it resolves to False."""
    b, bv, p, pv = _tables()
    res = tdist.distributed_inner_join(_tt(b, bv), _tt(p, pv),
                                       LocalCommunicator(),
                                       with_metrics=None,
                                       out_capacity_factor=4.0)
    assert not hasattr(res, "telemetry")
    with ttel.session(str(tmp_path)):
        res = tdist.distributed_inner_join(_tt(b, bv), _tt(p, pv),
                                           LocalCommunicator(),
                                           with_metrics=None,
                                           out_capacity_factor=4.0)
        assert int(res.total) > 0
        red = res.telemetry.to_dict()["reduced"]
        assert red == {"matches": int(res.total), "retry_attempt_max": 0}
        assert ttel.summary()["metrics"]["reduced"] == red


def test_retry_attempt_events_as_jax(tmp_path, jcomms):
    """An overflowing first rung and its relief stream ``retry_attempt``
    events, rung for rung as the JAX package's."""
    b, bv, p, pv = _tables()
    out = {}
    for name, tel, run in (
            ("j", jtel, lambda: jdist.distributed_inner_join(
                _jt(b, bv), _jt(p, pv), jcomms[4], auto_retry=3,
                with_metrics=False, out_rows_per_rank=128)),
            ("t", ttel, lambda: tdist.distributed_inner_join(
                _tt(b, bv), _tt(p, pv), EmulatedCommunicator(4),
                auto_retry=3, out_rows_per_rank=128))):
        with tel.session(str(tmp_path / name)) as sink:
            run()
            out[name] = [e["payload"] for e in _events(sink.events_path)
                         if e["name"] == "retry_attempt"]
    assert out["t"] == out["j"]
    assert [a["overflow"] for a in out["t"]][-1] is False
    assert len(out["t"]) > 1


# -- phases: device-trace ranges inside the steps ----------------------------

PHASES = ("entry", "merged_sort", "agg_reduce", "partition_hash")


def _children(ranges, parent):
    """The names of the ranges directly inside each ``parent`` range, in
    start order (``ranges``: ``(name, start, end)`` of one thread)."""
    def inside(a, b):
        return a is not b and b[1] <= a[1] and a[2] <= b[2]

    out = []
    for p in (r for r in ranges if r[0] == parent):
        kids = [r for r in ranges if inside(r, p)]
        out.append([r[0] for r in sorted(kids, key=lambda r: r[1])
                    if not any(inside(r, k) for k in kids)])
    return out


def _phase_agg_join(comm):
    spec = tagg.AggregateSpec.of(["key"], [["count", None, "n"],
                                           ["sum", "build_payload", "s"]])
    return tdist.make_distributed_join(comm, aggregate=spec, key="key",
                                       out_capacity_factor=8.0,
                                       with_metrics=False)


PHASE_CASES = {
    # a one-rank join: the entry, its step's join span and the overflow
    # read; the CPU takes the plain join, whose step 2 is the merged sort
    "join": (lambda tb, tp: tdist.distributed_inner_join(
        tb, tp, LocalCommunicator(), with_metrics=False,
        out_capacity_factor=4.0),
        {"entry": [["join", "sync.overflow"]], "join": [["merged_sort"]]}),
    # a one-rank fused aggregate: the sort, then the run reductions
    "aggregate": (lambda tb, tp: _phase_agg_join(LocalCommunicator())(
        tb, tp), {"join_agg": [["merged_sort", "agg_reduce"]]}),
}


@pytest.mark.parametrize("case", sorted(PHASE_CASES))
def test_phases_nest_in_the_device_trace(tmp_path, case):
    """Under a CPU ``torch.profiler`` with a session on, the phases are
    ``record_function`` ranges inside the spans of the work they name,
    and the session's event log holds none of them."""
    call, want = PHASE_CASES[case]
    b, bv, p, pv = _tables(rand_max=64)
    tb, tp = _tt(b, bv), _tt(p, pv)
    with ttel.session(str(tmp_path / "tel"), rank=0) as sink:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            call(tb, tp)
        events_path = sink.events_path
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    with open(tmp_path / "prof.json") as f:
        ranges = [(e["name"], e["ts"], e["ts"] + e["dur"])
                  for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    for parent, kids in want.items():
        assert _children(ranges, parent) == kids, parent
    logged = {e["name"] for e in _events(events_path)}
    assert logged and not logged & {*PHASES, "sync.overflow"}


def test_phases_on_rank0_only_under_emulation(tmp_path, monkeypatch):
    """Under the emulated communicator the ranks are threads: rank 0's
    records the partition's hash inside ``partition`` and no phase inside
    ``shuffle`` (the wire's kernels are named in a device trace by
    themselves); the muted ranks record nothing. (A profiler
    records only the thread that started it, so the ranges are taken
    where they are entered, in entry order.)"""
    from distributed_join_tpu_torch.telemetry import spans as tspans

    real, lock = tspans._device_range, threading.Lock()
    ranges, clock = {}, iter(range(1 << 30))

    @contextlib.contextmanager
    def taken(name):
        with lock:
            r = [name, next(clock), None]
            ranges.setdefault(threading.current_thread().name, []).append(r)
        with real(name):
            yield
        with lock:
            r[2] = next(clock)

    monkeypatch.setattr(tspans, "_device_range", taken)
    b, bv, p, pv = _tables()
    with ttel.session(str(tmp_path), rank=0):
        tdist.distributed_inner_join(_tt(b, bv), _tt(p, pv),
                                     EmulatedCommunicator(4),
                                     with_metrics=False,
                                     out_capacity_factor=4.0)
    assert set(ranges) == {threading.current_thread().name, "rank0"}
    rank0 = ranges["rank0"]
    assert _children(rank0, "partition") == [["partition_hash"] * 2]
    assert _children(rank0, "shuffle") == [[]]
    assert _children(rank0, "join") == [["merged_sort"]]
    assert [r[0] for r in ranges[threading.current_thread().name]] == [
        "entry", "sync.overflow"]


@pytest.mark.parametrize("where", ["off", "muted"])
def test_phase_is_the_shared_nullcontext(tmp_path, where):
    """With no session, or on a muted thread (an emulated rank other
    than 0), a phase is the shared ``nullcontext`` that ``span`` returns
    there."""
    from distributed_join_tpu_torch.telemetry import spans as tspans

    if where == "off":
        assert ttel.phase("merged_sort") is ttel.span("join")
        return
    got = {}
    with ttel.session(str(tmp_path), rank=0):
        assert ttel.phase("merged_sort") is not ttel.span("join")
        with tspans.adopted(tspans.thread_context(), mute=True):
            got["phase"], got["span"] = (ttel.phase("merged_sort"),
                                         ttel.span("join"))
    assert got["phase"] is got["span"]
    assert isinstance(got["phase"], contextlib.nullcontext)
# -- the out-of-core loop -----------------------------------------------------


def test_out_of_core_phase_counters_and_events(tmp_path, jcomms):
    """The phase dict keeps its keys while the same increments land as
    ``out_of_core.*`` counters; every settled batch leaves a
    ``batch_complete`` event (JAX's payloads), the window its
    ``out_of_core_measured_window``; each batch is staged in a ``stage``
    span and fetched in a ``fetch`` span."""
    b, bv, p, pv = _tables()
    runs = {}
    for name, tel, loop, bt, pt, comm in (
            ("j", jtel, jooc.keyrange_batched_join, _jt(b, bv), _jt(p, pv),
             jcomms[4]),
            ("t", ttel, tooc.keyrange_batched_join, _tt(b, bv), _tt(p, pv),
             EmulatedCommunicator(4))):
        stats = {}
        with tel.session(str(tmp_path / name)) as sink:
            total, overflow = loop(
                bt, pt, comm, n_batches=2, stats=stats,
                on_batch_result=lambda i, res: None,
                out_capacity_factor=4.0, shuffle_capacity_factor=3.0)
            summ = tel.summary()
            events = _events(sink.events_path)
        runs[name] = (total, overflow, stats, summ, events)
    (total, overflow, stats, summ, events) = runs["t"]
    assert (total, overflow) == runs["j"][:2] and not overflow
    for key in ("pad_s", "put_s", "dispatch_s", "fetch_s", "fetch_wait_s",
                "elapsed_s"):
        assert key in stats
    assert set(summ["counters"]) == set(runs["j"][3]["counters"]) >= {
        "out_of_core.pad_s", "out_of_core.put_s", "out_of_core.dispatch_s"}

    def marks(evs):
        return [(e["name"], e["payload"]) for e in evs
                if e["name"] in ("batch_complete",
                                 "out_of_core_measured_window")]

    assert marks(events) == marks(runs["j"][4])
    assert sorted(e["payload"]["batch"] for e in events
                  if e["name"] == "batch_complete") == [0, 1]

    def loop_spans(evs):
        return sorted((e["name"], e["payload"]["batch"]) for e in evs
                      if e["kind"] == "span"
                      and e["name"] in ("stage", "fetch"))

    assert loop_spans(events) == loop_spans(runs["j"][4])


# -- the history store --------------------------------------------------------

RECORDS = [
    {"benchmark": "distributed_join", "n_ranks": 4, "build_table_nrows": 8000,
     "probe_table_nrows": 8000, "shuffle": "ragged", "selectivity": 0.3,
     "elapsed_per_join_s": 0.0125, "matches_per_join": 2400,
     "retry": {"n_attempts": 2, "resolved": True, "attempts": [
         {"attempt": 0, "action": "initial", "overflow": True,
          "shuffle_capacity_factor": 1.6, "out_capacity_factor": 1.2,
          "out_rows_per_rank": None, "compression_bits": None,
          "hh_build_capacity": None, "hh_probe_capacity": None,
          "hh_out_capacity": None},
         {"attempt": 1, "action": "double_capacities", "overflow": False,
          "shuffle_capacity_factor": 3.2, "out_capacity_factor": 2.4,
          "out_rows_per_rank": None, "compression_bits": None,
          "hh_build_capacity": None, "hh_probe_capacity": None,
          "hh_out_capacity": None}]}},
    {"benchmark": "tpch_join", "scale_factor": 0.01, "n_ranks": 1,
     "elapsed_per_join_s": 0.5, "matches_per_join": 60175},
    {"benchmark": "all_to_all", "n_ranks": 2, "elapsed_per_exchange_s": 0.001},
    {"benchmark": "distributed_join", "error": "HangError: x did not "
                                               "complete within 1s"},
    {"benchmark": "distributed_join", "n_ranks": 4, "shuffle": "padded",
     "elapsed_per_join_s": 0.02, "agg": True,
     "aggregate": {"group_by": ["key"], "groups": 12}},
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_run_entry_equals_jax(i):
    summary = {"counters": {"out_of_core.pad_s": 0.1}, "metrics": None}
    for platform in (None, "cuda"):
        got = thist.run_entry(record=RECORDS[i], summary=summary,
                              platform=platform)
        assert got == jhist.run_entry(record=RECORDS[i], summary=summary,
                                      platform=platform)
    assert got["signature"] == thist.run_signature(got["workload"])


@pytest.mark.parametrize("kw", [
    dict(request_id="r1", op="join", signature="abc", outcome="served",
         wall_s=0.0123456789, new_traces=1, cache_hits=0, matches=7),
    dict(request_id="r2", op="join", signature="abc", outcome="failed",
         wall_s=1.5, error="HangError: x", tenant="gold",
         trace={"trace_id": "t-1", "span_id": "s", "parent_span_id": None},
         retry_record=RECORDS[0]["retry"], predicted_wall_s=1.0),
    dict(request_id="r3", op="batch", signature="def", outcome="ok",
         wall_s=0.2, resident={"table": "dim", "generation": 2},
         metrics={"per_rank": {"matches": [1, 2, 3, 10]},
                  "reduced": {"build.overflow_margin_min": 5}}),
])
def test_request_entry_equals_jax(kw):
    assert thist.request_entry(**kw) == jhist.request_entry(**kw)


def test_history_compaction_and_summary_equal_jax(tmp_path):
    """The same appends into a bounded store give JAX's file, line for
    line, and the same summary and text."""
    entries = []
    for k in range(14):
        rec = dict(RECORDS[k % 3], elapsed_per_join_s=0.01 * (k + 1))
        entries.append(thist.run_entry(record=rec, platform="cuda"))
    entries.append(thist.request_entry(
        request_id="q", op="join", signature="sig", outcome="served",
        wall_s=0.3, tenant="gold"))
    paths = {}
    for name, mod in (("t", thist), ("j", jhist)):
        store = mod.WorkloadHistory(str(tmp_path / name / "h.jsonl"),
                                    max_entries_per_signature=2)
        for e in entries:
            store.append(e)
        store.compact()
        store.close()
        assert store.compactions >= 2
        paths[name] = store.path
    assert open(paths["t"]).read() == open(paths["j"]).read()
    got, bad = thist.load_history(paths["t"])
    want, _ = jhist.load_history(paths["j"])
    assert bad == 0 and got == want
    summary = thist.summarize(got)
    assert summary == jhist.summarize(want)
    assert thist.format_summary(summary, "h") == \
        jhist.format_summary(summary, "h")
    assert set(thist.trends_of(got)) == set(jhist.trends_of(want))
    assert "gold/sig" in summary["signatures"]
    with thist.tenant_scope("acme"):
        assert thist.current_tenant() == "acme"
    assert thist.current_tenant() is None
    assert thist.tenant_key("s", "acme") == jhist.tenant_key("s", "acme")


def test_gini_and_imbalance_equal_jax():
    from distributed_join_tpu.telemetry import analyze
    for vals in ([1, 1, 1, 1], [0, 0, 0, 8], [3, 1, 4, 1, 5], [0, 0], [7]):
        assert thist.gini(vals) == analyze.gini(vals)
        assert thist.imbalance(vals) == analyze.imbalance(vals)


# -- the driver records -------------------------------------------------------

DRIVER_ARGV = ["--build-table-nrows", "4096", "--probe-table-nrows", "4096",
               "--iterations", "1", "--out-capacity-factor", "3.0"]


def test_driver_record_off_mode_unchanged():
    """Without a session the record has no ``telemetry`` key, in both
    packages, and the port's has no ``not_ported`` ``metrics``."""
    assert not ttel.enabled()
    rec = tdriver.run(tdriver.parse_args(
        ["--communicator", "emulated", "--n-ranks", "4", *DRIVER_ARGV]),
        device="cpu")
    report(rec, None)
    jrec = jdriver.run(jdriver.parse_args(
        ["--communicator", "tpu", "--n-ranks", "4", *DRIVER_ARGV]))
    for r in (rec, jrec):
        assert r["schema_version"] == 2 and r["rank"] == 0
        assert "telemetry" not in r
    assert "not_ported" not in rec
    # the two packages' generators draw different tables from one seed
    assert rec["matches_per_join"] > 0 and jrec["matches_per_join"] > 0


def test_driver_telemetry_acceptance(tmp_path, capsys):
    """One ``--telemetry DIR --history FILE`` run of the port's driver
    through ``run_guarded``: the record carries the session's summary
    (its ``metrics`` the counters of the untimed metrics join, which
    equal the record's matches), the event log has the stage
    spans under the driver's ``generate`` and ``timed_join``, the Chrome
    trace passes the JAX package's check, and the history has one entry
    under the signature the JAX package gives the same record."""
    tel_dir, hist = str(tmp_path / "tel"), str(tmp_path / "h.jsonl")
    args = tdriver.parse_args(["--communicator", "emulated", "--n-ranks",
                               "4", "--shuffle", "ragged", *DRIVER_ARGV,
                               "--telemetry", tel_dir, "--history", hist])
    out = {}

    def body(a):
        out["record"] = tdriver.run(a, device="cpu")
        report(out["record"], None)
        return out["record"]

    assert run_guarded(body, args, "distributed_join") == 0
    assert not ttel.enabled()
    record = out["record"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["telemetry"]["events_path"] == \
        record["telemetry"]["events_path"]
    assert "not_ported" not in record
    red = record["telemetry"]["metrics"]["reduced"]
    assert red["matches"] == record["matches_per_join"]
    assert red["build.rows_shuffled"] == red["build.rows_received"] == \
        record["build_table_nrows"]
    assert {"collect_metrics", "timed_join"} <= {
        e["name"] for e in _events(record["telemetry"]["events_path"])
        if e["kind"] == "span"}
    events = _events(record["telemetry"]["events_path"])
    names = {e["name"] for e in events if e["kind"] == "span"}
    assert {"generate", "partition", "shuffle", "join",
            "timed_join"} <= names
    assert check_file(record["telemetry"]["trace_path"]) == []
    trace = json.load(open(record["telemetry"]["trace_path"]))
    assert {"partition", "shuffle", "join"} <= {
        e["name"] for e in trace["traceEvents"]}
    entries, _ = thist.load_history(hist)
    assert len(entries) == 1 and entries[0]["outcome"] == "ok"
    # the JAX package's hook on the same args, record and session
    # summary files the same line (its workload back-filled from the args
    # alike; its indicators read from the summary's metrics)
    from distributed_join_tpu import benchmarks as jbench
    args.history = str(tmp_path / "jh.jsonl")
    jbench.maybe_history(args, record["telemetry"], record=record)
    assert entries == jhist.load_history(args.history)[0]


def test_driver_trace_writes_a_device_trace_with_the_spans(tmp_path):
    """``--trace`` on the CPU: a ``torch.profiler`` session around the
    run (CPU activity only: no card), exported under
    ``DIR/device_trace/``, holds the spans as ``record_function``
    ranges."""
    tel_dir = str(tmp_path / "tel")
    args = tdriver.parse_args(["--communicator", "local", *DRIVER_ARGV,
                               "--trace", "--telemetry", tel_dir])
    assert args.trace
    out = {}

    def body(a):
        out["record"] = tdriver.run(a, device="cpu")
        return out["record"]

    run_guarded(body, args, "distributed_join")
    summ = json.load(open(os.path.join(tel_dir, "summary.json")))
    path = summ["device_trace_path"]
    assert path == os.path.join(tel_dir, "device_trace", "trace.rank0.json")
    doc = json.load(open(path))
    ranges = {e["name"] for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert "join" in ranges
    with pytest.raises(SystemExit):
        tdriver.parse_args(["--trace", "--profile", "3"])


def test_device_trace_kernels_reads_span_nesting(tmp_path):
    """The device trace's reader: a kernel counts as inside a span when
    its launch (matched by correlation id) falls in a ``record_function``
    range of that name on the launching thread."""
    from distributed_join_tpu_torch.telemetry.export import (
        device_trace_kernels,
    )
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "join", "pid": 1,
         "tid": 7, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "shuffle", "pid": 1,
         "tid": 7, "ts": 10.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 120.0, "dur": 2.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 20.0, "dur": 2.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 8, "ts": 130.0, "dur": 2.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "f_pass", "pid": 0, "tid": 7,
         "ts": 300.0, "dur": 9.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "f_pass", "pid": 0, "tid": 7,
         "ts": 310.0, "dur": 9.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "compact_kernel", "pid": 0,
         "tid": 7, "ts": 320.0, "dur": 9.0, "args": {"correlation": 3}},
        {"ph": "i", "cat": "event", "name": "x", "ts": 1.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert device_trace_kernels(str(path), "join") == {
        "f_pass": {"launches": 2, "inside": 1},
        "compact_kernel": {"launches": 1, "inside": 0}}
    assert device_trace_kernels(str(path), "shuffle")["f_pass"] == {
        "launches": 2, "inside": 1}
