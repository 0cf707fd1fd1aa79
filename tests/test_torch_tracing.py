"""PyTorch port vs the JAX package: distributed tracing on the CPU.

Mirrors ``tests/test_tracing.py`` on the port's ``telemetry/tracectx.py``,
its sink's stamping (``telemetry.request_scope``) and
``telemetry/timeline.py``: the same calls go through both packages and
their outputs are compared exactly. What differs by nature is stripped
and nothing else: timestamps (``ts_us``, ``dur_us``, ``ts``, ``dur``),
the session's wall-clock epoch (``epoch_s``), thread ids (``tid``) and
ids minted at random (compared by shape). The JAX package's readers
(``telemetry.analyze.check_file``, ``telemetry.timeline.assemble``)
also read the port's files.
"""

import json
import os

import pytest

from distributed_join_tpu import telemetry as jtel
from distributed_join_tpu.telemetry import timeline as jtimeline
from distributed_join_tpu.telemetry import tracectx as jctx
from distributed_join_tpu.telemetry.analyze import check_file
from distributed_join_tpu_torch import telemetry as ttel
from distributed_join_tpu_torch.telemetry import timeline as ttimeline
from distributed_join_tpu_torch.telemetry import tracectx as tctx

PACKAGES = {"jax": (jtel, jctx, jtimeline), "port": (ttel, tctx, ttimeline)}
TIME_KEYS = ("ts_us", "dur_us", "ts", "dur", "tid", "epoch_s")


@pytest.fixture(autouse=True)
def _no_leaked_session():
    """Both packages' sessions are process-global."""
    jtel.finalize()
    ttel.finalize()
    yield
    jtel.finalize()
    ttel.finalize()


def _strip(obj):
    """``obj`` without the keys that hold times, thread ids or epochs."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in TIME_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _read_events(session_dir):
    with open(os.path.join(session_dir, "events.rank0.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- the context algebra ------------------------------------------------------


def test_mint_is_a_root():
    for ctx in (tctx.mint(), jctx.mint()):
        assert ctx["trace_id"].startswith("t-")
        assert len(ctx["trace_id"]) == 2 + 32
        assert len(ctx["span_id"]) == 16
        assert ctx["parent_span_id"] is None
    assert tctx.mint()["trace_id"] != tctx.mint()["trace_id"]


@pytest.mark.parametrize("raw", ["my-trace", "x" * 64, "x" * 65, "x" * 100,
                                 "x" * 99 + "y", 12345])
def test_cap_id_and_client_ids_match_jax(raw):
    assert tctx.cap_id(raw) == jctx.cap_id(raw)
    assert tctx.mint(raw)["trace_id"] == jctx.mint(raw)["trace_id"]
    assert len(tctx.cap_id(raw)) <= tctx.MAX_ID_LEN == jctx.MAX_ID_LEN
    assert tctx.TRACE_FIELD == jctx.TRACE_FIELD
    assert tctx.TRACE_KEYS == jctx.TRACE_KEYS


def test_child_parents_on_the_minter_span():
    root = tctx.mint()
    c = tctx.child(root)
    assert c["trace_id"] == root["trace_id"]
    assert c["parent_span_id"] == root["span_id"]
    assert c["span_id"] != root["span_id"]
    assert tctx.child(None) is None and jctx.child(None) is None
    assert tctx.child({}) is None and jctx.child({}) is None
    attempts = [tctx.child(root) for _ in range(3)]
    assert {a["trace_id"] for a in attempts} == {root["trace_id"]}
    assert len({a["span_id"] for a in attempts}) == 3


def test_wire_round_trip_matches_jax():
    root = tctx.mint()
    assert tctx.to_wire(root) == jctx.to_wire(root) == {
        "trace_id": root["trace_id"], "span_id": root["span_id"]}
    req = tctx.attach({"op": "join"}, root)
    assert req == jctx.attach({"op": "join"}, root)
    assert tctx.from_wire(req) == jctx.from_wire(req)
    adopted = tctx.child_of_wire(req)
    assert adopted["trace_id"] == root["trace_id"]
    assert adopted["parent_span_id"] == root["span_id"]
    assert adopted["span_id"] != root["span_id"]
    # a context minted by one package is adopted by the other alike
    jroot = jctx.mint()
    assert tctx.from_wire(jctx.attach({}, jroot)) == \
        jctx.from_wire(jctx.attach({}, jroot))


@pytest.mark.parametrize("req", [{}, {"trace": "not-a-dict"},
                                 {"trace": {"span_id": "x"}},
                                 "not-a-request",
                                 {"trace": {"trace_id": "y" * 80,
                                            "span_id": "s" * 70}}])
def test_from_wire_refusals_match_jax(req):
    assert tctx.from_wire(req) == jctx.from_wire(req)
    got = tctx.child_of_wire(req)
    want = jctx.child_of_wire(req)
    assert (got is None) == (want is None)
    if got is not None:
        assert got["trace_id"] == want["trace_id"]
        assert got["parent_span_id"] == want["parent_span_id"]


def test_attach_copies_and_passes_through():
    req = {"op": "join", "seed": 7}
    ctx = tctx.mint()
    attached = tctx.attach(req, ctx)
    assert tctx.TRACE_FIELD not in req and attached is not req
    assert attached == jctx.attach(req, ctx)
    assert tctx.attach(req, None) is req


def test_stamp_matches_jax():
    ctx = tctx.mint()
    for c in (None, {}, ctx, tctx.child(ctx)):
        assert tctx.stamp(c) == jctx.stamp(c)
    assert set(tctx.stamp(ctx)) == set(tctx.TRACE_KEYS)


# -- the sink's stamping ------------------------------------------------------


def _scoped_session(pkg, d, outer, inner):
    tel, _, _ = PACKAGES[pkg]
    tel.configure(str(d), rank=0)
    try:
        tel.event("before_scope")
        with tel.request_scope("req-1", trace=outer):
            tel.event("outer_event")
            assert tel.current_trace() == outer
            with tel.request_scope("req-1", trace=inner):
                tel.event("inner_event")
                assert tel.current_trace() == inner
            assert tel.current_trace() == outer
            tel.span_complete("outer_span", 0.0, 0.001)
        assert tel.current_trace() is None
        tel.event("after_scope")
    finally:
        tel.finalize()
    return _read_events(d)


def test_request_scope_stamps_and_restores_as_jax(tmp_path):
    outer = tctx.mint()
    inner = tctx.child(outer)
    got = _scoped_session("port", tmp_path / "t", outer, inner)
    want = _scoped_session("jax", tmp_path / "j", outer, inner)
    assert _strip(got) == _strip(want)
    recs = {r["name"]: r for r in got}
    for name in ("before_scope", "after_scope"):
        assert "trace_id" not in recs[name]
    assert recs["inner_event"]["parent_span_id"] == outer["span_id"]
    assert recs["outer_span"]["trace_id"] == outer["trace_id"]
    assert recs["outer_event"]["request_id"] == "req-1"


def test_link_event_payload_wins_over_scope(tmp_path):
    scope_ctx = tctx.mint()
    attempt = tctx.child(scope_ctx)
    out = {}
    for pkg in PACKAGES:
        tel = PACKAGES[pkg][0]
        tel.configure(str(tmp_path / pkg), rank=0)
        try:
            with tel.request_scope("req-1", trace=scope_ctx):
                tel.event("attempt_failed", **tctx.stamp(attempt))
        finally:
            tel.finalize()
        out[pkg] = _read_events(tmp_path / pkg)
    assert _strip(out["port"]) == _strip(out["jax"])
    rec = {r["name"]: r for r in out["port"]}["attempt_failed"]
    assert rec["span_id"] == attempt["span_id"]
    assert rec["parent_span_id"] == scope_ctx["span_id"]


def test_tracing_off_is_a_noop(tmp_path):
    assert not ttel.enabled()
    with ttel.request_scope("req-1", trace=tctx.mint()):
        assert ttel.current_trace() is None
    ttel.event("dropped")
    ttel.counter_add("dropped", 1)
    ttel.span_complete("dropped", 0.0, 1.0)
    assert ttel.span("dropped") is ttel.span("other")  # the shared null
    assert ttel.summary() is None and ttel.finalize() is None
    assert not os.listdir(tmp_path)


# -- timeline assembly --------------------------------------------------------

T0_EPOCH = 1_700_000_000.0


def _write_stream(dirpath, records, epoch_s=T0_EPOCH, torn_tail=None):
    os.makedirs(dirpath, exist_ok=True)
    lines = [{"kind": "event", "name": "session_start", "ts_us": 0.0,
              "rank": 0, "payload": {"epoch_s": epoch_s}}]
    lines += records
    path = os.path.join(dirpath, "events.rank0.jsonl")
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
        if torn_tail is not None:
            f.write(torn_tail)
    return path


def _two_proc_fleet(tmp_path, *, replica_epoch=T0_EPOCH, torn_tail=None):
    """router + replica, one request crossing the wire (the JAX test's
    fixture)."""
    trace = "t-feed"
    _write_stream(tmp_path / "router", [
        {"kind": "span", "name": "fleet_dispatch", "ts_us": 100.0,
         "dur_us": 900.0, "rank": 0, "request_id": "q1",
         "trace_id": trace, "span_id": "r1"},
        {"kind": "event", "name": "fleet_attempt_failed", "ts_us": 300.0,
         "rank": 0, "request_id": "q1", "trace_id": trace,
         "span_id": "r2", "parent_span_id": "r1"},
        {"kind": "event", "name": "retry", "ts_us": 400.0, "rank": 0,
         "request_id": "q1", "trace_id": trace, "span_id": "r3",
         "parent_span_id": "r1"},
    ])
    _write_stream(tmp_path / "replica0", [
        {"kind": "span", "name": "service_request", "ts_us": 500.0,
         "dur_us": 300.0, "rank": 0, "request_id": "q1",
         "trace_id": trace, "span_id": "s1", "parent_span_id": "r3"},
    ], epoch_s=replica_epoch, torn_tail=torn_tail)
    return trace, [str(tmp_path / "router"), str(tmp_path / "replica0")]


def _views(mod, dirs, **kw):
    """An assembly's deterministic renderings: its record, its report and
    its continuity probe."""
    asm = mod.assemble(dirs, **kw)
    return (mod.as_record(asm), mod.format_report(asm),
            mod.trace_ids_for_request(asm, "q1"), asm)


@pytest.mark.parametrize("replica_epoch", [T0_EPOCH, T0_EPOCH - 0.002])
def test_assemble_two_process_trace_as_jax(tmp_path, replica_epoch):
    trace, dirs = _two_proc_fleet(tmp_path, replica_epoch=replica_epoch)
    rec, text, ids, asm = _views(ttimeline, dirs)
    jrec, jtext, jids, _ = _views(jtimeline, dirs)
    assert (rec, text, ids) == (jrec, jtext, jids)
    assert len(asm["hops"]) == 1 and asm["hops"][0]["parent_span_id"] == "r3"
    assert asm["focus_trace"] == trace and ids == {trace}
    if replica_epoch == T0_EPOCH:
        assert asm["skew_bound_us"] == 0.0
    else:  # the replica's clock runs 2 ms early: the inversion bounds it
        assert 0.0 < asm["skew_bound_us"] <= 2000.0
    path_names = [n["rec"]["name"] for n in asm["critical_path"]]
    assert path_names[0] == "fleet_dispatch"
    assert "service_request" in path_names


def test_torn_final_line_is_tolerated(tmp_path):
    trace, dirs = _two_proc_fleet(
        tmp_path, torn_tail='{"kind": "event", "name": "half')
    rec, _, _, asm = _views(ttimeline, dirs)
    assert asm["focus_trace"] == trace
    assert rec == _views(jtimeline, dirs)[0]


def test_torn_middle_line_raises(tmp_path):
    _, dirs = _two_proc_fleet(tmp_path)
    path = os.path.join(dirs[1], "events.rank0.jsonl")
    with open(path) as f:
        lines = f.readlines()
    lines.insert(1, '{"kind": "event", "name": "half\n')
    with open(path, "w") as f:
        f.writelines(lines)
    for mod in (ttimeline, jtimeline):
        with pytest.raises(ValueError, match="unparseable line"):
            mod.assemble(dirs)


def test_unanchored_stream_is_kept_but_excluded(tmp_path):
    trace, dirs = _two_proc_fleet(tmp_path)
    lost = tmp_path / "lost"
    os.makedirs(lost)
    with open(lost / "events.rank0.jsonl", "w") as f:
        f.write(json.dumps({"kind": "event", "name": "orphan", "ts_us": 1.0,
                            "rank": 0, "trace_id": trace,
                            "span_id": "zz"}) + "\n")
    rec, _, _, asm = _views(ttimeline, dirs + [str(lost)])
    assert rec == _views(jtimeline, dirs + [str(lost)])[0]
    assert len(asm["procs"]) == 3 and not asm["procs"][2]["anchored"]
    assert all(pid != 2 for _t, pid, _r in asm["merged"])
    with pytest.raises(ValueError, match="clock anchor"):
        ttimeline.assemble([str(lost)])


def test_not_a_session_dir_refuses(tmp_path):
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(ValueError, match="no events"):
        ttimeline.assemble([str(empty)])
    with pytest.raises(ValueError, match="no such file"):
        ttimeline.assemble([str(tmp_path / "missing")])
    with pytest.raises(ValueError, match="no telemetry streams"):
        ttimeline.assemble([])


def test_perfetto_export_and_record_schema(tmp_path):
    trace, dirs = _two_proc_fleet(tmp_path)
    paths = {}
    for name, mod in (("port", ttimeline), ("jax", jtimeline)):
        asm = mod.assemble(dirs, trace_id=trace)
        paths[name] = mod.write_perfetto(
            asm, str(tmp_path / f"{name}.trace.json"))
        record = mod.as_record(asm, trace_file="fleet_timeline.trace.json")
        rec_path = tmp_path / f"{name}_fleet_timeline.json"
        with open(rec_path, "w") as f:
            json.dump(record, f)
        assert check_file(str(rec_path)) == []
    docs = [json.load(open(paths[k])) for k in ("port", "jax")]
    assert docs[0] == docs[1]
    flows = [e for e in docs[0]["traceEvents"]
             if e.get("cat") == "trace_hop"]
    assert {e["ph"] for e in flows} == {"s", "f"}
    starts = {e["id"]: e["ts"] for e in flows if e["ph"] == "s"}
    assert all(e["ts"] >= starts[e["id"]] for e in flows if e["ph"] == "f")


def test_real_sink_streams_assemble_in_both_readers(tmp_path):
    """End to end through the port's writer: the JAX package's and the
    port's assembly of two port sessions (two ranks of one run) agree,
    and the port's Chrome traces pass the JAX package's check."""
    ctx = tctx.mint()
    dirs = []
    for rank in (0, 1):
        d = str(tmp_path / f"proc{rank}")
        ttel.configure(d, rank=0)
        try:
            with ttel.request_scope("req-9", trace=tctx.child(ctx)):
                with ttel.span("serve", rank=rank):
                    ttel.event("inside")
        finally:
            s = ttel.finalize()
        assert check_file(s["trace_path"]) == []
        dirs.append(d)
    rec, text, _, asm = _views(ttimeline, dirs)
    jrec, jtext, _, _ = _views(jtimeline, dirs)
    assert (rec, text) == (jrec, jtext)
    assert asm["focus_trace"] == ctx["trace_id"]
    assert ttimeline.trace_ids_for_request(asm, "req-9") == {ctx["trace_id"]}
