"""The port's serving fleet (distributed_join_tpu_torch/service/fleet.py)
against the JAX package's router, on the CPU: one port test for each
test of ``tests/test_fleet.py``, under its name.

Where the JAX router runs, the same scripted requests and faults go
through both routers (over fake wire replicas, or over in-process fleets
of real services: JAX over disjoint device subsets of its 8-device CPU
runtime, the port over per-slot communicators on the CPU), and the
outcomes are compared exactly: each request's ``ok``, error class,
matches, ``shed``/``tenant`` stamps, attempts and failovers, and its
serving replica; the drain reasons (request ids masked), the router's
counters, and the fleet's Prometheus gauges by name and value. Two
things differ by design and are compared as what they mean: a join
spec's affinity key is the port's own workload signature (so its ring
start is the port's ``affine_replica``, and the serving replica is
compared relative to it), and the wire's tables are each package's own
generator's draws (so ``matches`` is compared with each package's own
oracle). The JAX package's two red cases on jax 0.9.0
(``test_kill_failover_oracle_exact_and_replacement_warm`` at
``tests/test_fleet.py:596``, ``test_corrupt_refuses_loudly_through_
router_never_wrong_rows`` at ``:726``) are held to the reference tests'
written expectations (``:559-628``, ``:701-740``).
"""

import json
import re
import socket
import socketserver
import subprocess
import sys
import threading
import time

import pytest

from distributed_join_tpu.parallel import faults as jfaults
from distributed_join_tpu.service import fleet as jfleet
from distributed_join_tpu.service import server as jserver
from distributed_join_tpu_torch.parallel import faults as tfaults
from distributed_join_tpu_torch.service import fleet as tfleet
from distributed_join_tpu_torch.service import server as tserver

MODS = {"jax": jfleet, "torch": tfleet}

# One canonical wire query for every fleet test (the reference's).
Q = {"op": "join", "build_nrows": 1024, "probe_nrows": 1024,
     "seed": 5, "selectivity": 0.4, "rand_max": 512,
     "out_capacity_factor": 3.0}


def _server_of(mod):
    return jserver if mod is jfleet else tserver


def _faults_of(mod):
    return jfaults if mod is jfleet else tfaults


def oracle_matches(mod, spec) -> int:
    """Each package's oracle over its own generator's tables."""
    if mod is tfleet:
        return tfleet.wire_oracle_matches(spec, "cpu")
    build, probe = jserver._tables_from_spec(spec)
    return len(build.to_pandas().merge(probe.to_pandas(), on="key"))


def make_fleet(mod, tmp_path, *, comm_wrap=None, service_config=None,
               probe_interval_s=0.2, **cfg_overrides):
    cfg = mod.FleetConfig(
        n_replicas=2, replica_ranks=2,
        probe_interval_s=probe_interval_s,
        suspect_strikes=1, retry_budget=2,
        **cfg_overrides)
    kw = {"device": "cpu"} if mod is tfleet else {}
    factory = mod.in_process_fleet_factory(
        2, 2, service_config=service_config, comm_wrap=comm_wrap,
        persist_dir=str(tmp_path / "programs"), **kw)
    router = mod.FleetRouter(factory, cfg)
    router.start()
    server, port = mod.start_router_daemon(router)
    client = _server_of(mod).ServiceClient("127.0.0.1", port)
    return router, server, client


def teardown_fleet(router, server, client):
    client.close()
    server.shutdown()
    server.server_close()
    router.stop()


def outcome(resp, start=None, matches=True) -> dict:
    """The comparable part of a response. ``start`` (the request's ring
    start in its own package) turns the serving replica into its offset
    from the start, where the ring start itself differs by design;
    ``matches=False`` leaves out the match count (a real replica's,
    which each package draws from its own generator)."""
    fl = resp.get("fleet") or {}
    rep = fl.get("replica")
    if rep is not None and start is not None:
        rep = (rep - start) % 2
    return {"ok": resp.get("ok"), "error": resp.get("error"),
            "matches": resp.get("matches") if matches else None,
            "shed": resp.get("shed"),
            "tenant": resp.get("tenant"), "replica": rep,
            "attempts": fl.get("attempts"),
            "failovers": fl.get("failovers")}


_RID = re.compile(r"flt-[0-9a-f]{6}-\d+")
_ADDR = re.compile(r"127\.0\.0\.1:\d+")


def masked(text):
    """A reason with its minted request id and its ephemeral port
    masked."""
    if text is None:
        return None
    return _ADDR.sub("127.0.0.1:*", _RID.sub("flt-*", str(text)))


def fleet_gauges(router) -> dict:
    """The router's Prometheus lines by name, less the clock's (uptime,
    QPS, latency histograms); the label of ``Q``'s signature (its own
    package's key) reads ``Q``."""
    out = {}
    text = router.prometheus_metrics().replace(
        f'signature="{router.affinity_key(Q)}"', 'signature="Q"')
    for line in text.splitlines():
        if line.startswith("#") or not line.startswith("djtpu_"):
            continue
        if any(w in line for w in ("latency", "uptime", "qps")):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = value
    return out


def both(scenario):
    """``scenario(mod)`` for the JAX router and the port's; returns
    (jax record, port record)."""
    return scenario(jfleet), scenario(tfleet)


# -- affinity ----------------------------------------------------------


def test_affinity_key_matches_replica_side_signature():
    """The router-side key (meta tables from the wire spec) IS the
    digest a port replica computes over its real generated tables, as
    the JAX key is a JAX replica's: the contract holds in both
    packages."""
    from distributed_join_tpu.planning.tuner import (
        workload_signature as jws,
    )
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
    )
    from distributed_join_tpu_torch.planning.tuner import (
        workload_signature as tws,
    )

    class Stub:
        n_ranks = 2
        n_slices = 1

    spec = dict(Q)
    build, probe = tserver._tables_from_spec(spec, "cpu")
    replica_side = tws(Stub(), build, probe, with_metrics=False,
                       **tserver._join_opts_from_spec(spec))
    assert tfleet.affinity_key(spec, replica_ranks=2) == replica_side
    # the signature a live replica's own service keys its request under
    svc = tserver.JoinService(EmulatedCommunicator(2), device="cpu")
    assert svc._workload_signature(
        build, probe, "key", tserver._join_opts_from_spec(spec)) \
        == replica_side
    jb, jp = jserver._tables_from_spec(spec)
    assert jfleet.affinity_key(spec, replica_ranks=2) == jws(
        Stub(), jb, jp, with_metrics=False,
        **jserver._join_opts_from_spec(spec))


TABLE_OPS = [
    {"op": "register", "name": "dim", "rows": 512},
    {"op": "append", "name": "dim", "rows": 64},
    {"op": "drop", "name": "dim"},
    {"op": "join", "table": "dim", "probe_nrows": 256},
    {"op": "register", "name": "a table/with spaces", "rows": 8},
]
QUERY_OPS = [{"op": "query", "query": "q3"},
             {"op": "query", "query": "q10", "scale_factor": 0.01}]
FALLBACK_OPS = [{"op": "ping"}, {"op": "tables"},
                {"op": "query", "query": "q99"},
                {"op": "batch", "requests": [{"build_nrows": 8}],
                 "request_id": "ignored"},
                {"op": "join", "probe_nrows": 64}]


def test_affinity_key_deterministic_and_spec_sensitive():
    """The port's keys are deterministic and spec-sensitive, table ops
    co-locate by handle name; and the table-op, query-plan and JSON
    fallback keys, with their ``affine_replica`` slots, equal the JAX
    router's bit for bit."""
    f = tfleet
    assert f.affinity_key(Q, 2) == f.affinity_key(dict(Q), 2)
    other = {**Q, "build_nrows": 2048}
    assert f.affinity_key(other, 2) != f.affinity_key(Q, 2)
    reg = {"op": "register", "name": "dim", "rows": 512}
    join = {"op": "join", "table": "dim", "probe_nrows": 256}
    assert f.affinity_key(reg, 2) == f.affinity_key(join, 2)
    assert f.affinity_key(reg, 2) != f.affinity_key(
        {"op": "register", "name": "dim2", "rows": 512}, 2)
    assert f.affine_replica(Q, 2, 2) == int(
        f.affinity_key(Q, 2)[:8], 16) % 2
    for req in TABLE_OPS + QUERY_OPS + FALLBACK_OPS:
        for ranks in (1, 2, 4):
            assert f.affinity_key(req, ranks) == \
                jfleet.affinity_key(req, ranks), req
        for n in (1, 2, 3, 5):
            assert f.affine_replica(req, 2, n) == \
                jfleet.affine_replica(req, 2, n), (req, n)


# -- fake replicas: the state machine without a service -----------------


class FakeReplica:
    """A wire-protocol replica with a pluggable handler: the state
    machine and shedding tests without any join (shared by both
    routers)."""

    def __init__(self, handler):
        outer = self

        class H(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    line = raw.strip()
                    if not line:
                        continue
                    resp = outer.handler(json.loads(line))
                    self.wfile.write(
                        (json.dumps(resp) + "\n").encode())
                    self.wfile.flush()

        class S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            allow_reuse_port = True     # for the tombstone, see kill
            daemon_threads = True

        self.handler = handler
        self.server = S(("127.0.0.1", 0), H)
        self.host, self.port = ("127.0.0.1",
                                self.server.server_address[1])
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self._dead = False

    def alive(self):
        return not self._dead

    def kill(self):
        """A dead replica refuses every connect. Its port stays bound,
        not listening, by a tombstone socket taken before the listener
        closes: no other process of a parallel test run can take the
        port and answer (or reset) a connect meant for the dead one."""
        if not self._dead:
            self._dead = True
            self._tomb = socket.socket()
            self._tomb.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._tomb.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            self._tomb.bind((self.host, self.port))
            self.server.shutdown()
            self.server.server_close()

    def stop(self, timeout_s=10.0):  # noqa: ARG002 - backend API
        self.kill()


def _ok_handler(req):
    op = req.get("op")
    if op == "stats":
        return {"ok": True, "poisoned": None, "draining": None,
                "qps_60s": 0.0, "latency": {}}
    if op == "drain":
        return {"ok": True, "op": "drain", "drained": True}
    return {"ok": True, "op": op, "matches": 7, "new_traces": 0,
            "overflow": False, "request_id": req.get("request_id")}


def test_probe_drains_poisoned_replica_and_replaces():
    """stats showing ``poisoned`` -> drained within one probe interval
    -> replaced at generation 1; the drain is flight-recorded with a
    replica stamp. The drain reason, the counters and the fleet gauges
    equal the JAX router's."""
    def scenario(mod):
        poisoned = {"flag": False}

        def sick_handler(req):
            resp = _ok_handler(req)
            if req.get("op") == "stats" and poisoned["flag"]:
                resp["poisoned"] = "request req-x blew its deadline"
            return resp

        def factory(index, generation):
            if index == 0 and generation == 0:
                return FakeReplica(sick_handler)
            return FakeReplica(_ok_handler)

        cfg = mod.FleetConfig(n_replicas=2, replica_ranks=2,
                              probe_interval_s=0.1)
        router = mod.FleetRouter(factory, cfg)
        router.start()
        try:
            poisoned["flag"] = True
            t0 = time.monotonic()
            assert router.wait_replaced(0, timeout_s=10.0)
            rep = router.replicas[0]
            assert rep.drained_at - t0 <= 5 * cfg.probe_interval_s + 1.0
            recs = router.recorder.snapshot()["records"]
            drains = [r for r in recs if r["op"] == "drain_replica"]
            st = router.stats()
            return {"generation": rep.generation, "state": rep.state,
                    "reason": rep.drained_reason,
                    "drains": st["drains_total"],
                    "replaced": st["replaced_total"],
                    "drain_record": (drains[0]["replica"]["index"],
                                     drains[0]["reason"]),
                    "gauges": fleet_gauges(router)}
        finally:
            router.stop()

    j, t = both(scenario)
    assert t == j
    assert (t["generation"], t["state"], t["drains"], t["replaced"]) == \
        (1, "healthy", 1, 1)
    assert t["reason"] == "probe saw poisoned: request req-x blew its " \
        "deadline"
    assert t["gauges"]["djtpu_fleet_replaced_total"] == "1"


def test_dead_connection_strikes_to_drain_and_failover():
    """A torn connection mid-request: strike -> drained (strikes bound
    1) -> the request fails over to the sibling and serves;
    failovers_total counts it. Outcome, drain reason (ids masked) and
    counters equal the JAX router's."""
    def scenario(mod):
        cfg = mod.FleetConfig(n_replicas=2, replica_ranks=2,
                              probe_interval_s=30.0, suspect_strikes=1,
                              retry_budget=2, retry_backoff_s=0.01,
                              respawn=False)
        router = mod.FleetRouter(lambda i, g: FakeReplica(_ok_handler),
                                 cfg)
        router.start()
        try:
            victim = mod.affine_replica(Q, 2, 2)
            router.replicas[victim].backend.kill()
            resp = router.dispatch(dict(Q))
            st = router.stats()
            return {"resp": outcome(resp, victim),
                    "victim_state": router.replicas[victim].state,
                    "reason": masked(router.replicas[victim]
                                     .drained_reason),
                    "failovers": st["failovers_total"],
                    "gauges": fleet_gauges(router)}
        finally:
            router.stop()

    j, t = both(scenario)
    assert t == j
    assert t["resp"] == {"ok": True, "error": None, "matches": 7,
                         "shed": None, "tenant": None, "replica": 1,
                         "attempts": 2, "failovers": 1}
    assert t["victim_state"] == "drained" and t["failovers"] == 1
    assert "ConnectionRefusedError" in t["reason"]


def test_admission_sheds_structured_never_queues():
    """No admittable replica (inflight bound 0) -> a structured
    AdmissionError with ``shed: true``, at once; the p95 policy sheds
    from the probed stats snapshot alone. As the JAX router."""
    def scenario(mod):
        cfg = mod.FleetConfig(n_replicas=2, replica_ranks=2,
                              probe_interval_s=30.0,
                              max_inflight_per_replica=0)
        router = mod.FleetRouter(lambda i, g: FakeReplica(_ok_handler),
                                 cfg)
        router.start()
        out = []
        try:
            out.append(router.dispatch(dict(Q)))
            shed_after_first = router.stats()["shed_total"]
            router.config.max_inflight_per_replica = 4
            router.config.shed_p95_s = 0.5
            for rep in router.replicas:
                rep.last_stats = {"qps_60s": 1.0,
                                  "latency": {"p95_s": 2.0}}
            out.append(router.dispatch(dict(Q)))
            router.config.shed_p95_s = None
            out.append(router.dispatch(dict(Q)))
            return {"resps": [outcome(r) for r in out],
                    "messages": [r.get("message") for r in out],
                    "shed_after_first": shed_after_first,
                    "gauges": fleet_gauges(router)}
        finally:
            router.stop()

    j, t = both(scenario)
    # the served request's replica is its own package's ring start
    for rec, mod in ((j, jfleet), (t, tfleet)):
        assert rec["resps"][2]["replica"] == mod.affine_replica(Q, 2, 2)
        rec["resps"][2]["replica"] = "start"
    assert t == j
    first, p95, served = t["resps"]
    assert first["error"] == "AdmissionError" and first["shed"]
    assert t["shed_after_first"] == 1
    assert not p95["ok"] and p95["shed"]
    assert served["ok"]


def test_duplicate_request_id_parks_never_dispatches_concurrently():
    """The duplicate-dispatch fence: a resend of an id still in flight
    PARKS until the original settles, then serves; the two never
    overlap on a replica; a duplicate still blocked past the request
    deadline is refused with a structured error. As the JAX router."""
    def scenario(mod):
        release = threading.Event()
        concurrency = {"now": 0, "max": 0}
        lock = threading.Lock()

        def slow_handler(req):
            if req.get("op") == "join":
                with lock:
                    concurrency["now"] += 1
                    concurrency["max"] = max(concurrency["max"],
                                             concurrency["now"])
                release.wait(timeout=10.0)
                with lock:
                    concurrency["now"] -= 1
            return _ok_handler(req)

        cfg = mod.FleetConfig(n_replicas=2, replica_ranks=2,
                              probe_interval_s=30.0,
                              request_deadline_s=30.0)
        router = mod.FleetRouter(lambda i, g: FakeReplica(slow_handler),
                                 cfg)
        router.start()
        try:
            out = {}

            def send(slot):
                out[slot] = router.dispatch({**Q, "request_id": "dup-1"})

            def wait_registered():
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    with router._lock:
                        if "dup-1" in router._inflight_ids:
                            return
                    time.sleep(0.01)
                raise AssertionError("original never registered")

            t1 = threading.Thread(target=send, args=("first",))
            t1.start()
            wait_registered()
            t2 = threading.Thread(target=send, args=("dup",))
            t2.start()
            time.sleep(0.3)
            parked = "dup" not in out
            release.set()
            t1.join(timeout=10.0)
            t2.join(timeout=10.0)
            max_overlap = concurrency["max"]

            release.clear()
            t3 = threading.Thread(target=send, args=("slow",))
            t3.start()
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                with lock:
                    if concurrency["now"] == 1:
                        break
                time.sleep(0.01)
            router.config.request_deadline_s = 0.3
            late = router.dispatch({**Q, "request_id": "dup-1"})
            release.set()
            t3.join(timeout=10.0)
            return {"parked": parked, "max_overlap": max_overlap,
                    "first": outcome(out["first"])["ok"],
                    "dup": outcome(out["dup"])["ok"],
                    "late": outcome(late), "late_msg": late["message"],
                    "rejected": router.stats()["rejected"]}
        finally:
            release.set()
            router.stop()

    j, t = both(scenario)
    assert t == j
    assert t["parked"] and t["first"] and t["dup"]
    assert t["max_overlap"] == 1
    assert t["late"]["error"] == "FleetError"
    assert "still in flight" in t["late_msg"]


# -- multi-tenant admission: quotas, priority shed, autoscaling --------


def _tenant_rows(stats: dict) -> dict:
    """The per-tenant stats less the clock's (qps, latency)."""
    return {name: {k: v for k, v in row.items()
                   if k not in ("qps_60s", "latency")}
            for name, row in stats["tenants"].items()}


def test_tenant_quota_refusals_structured_and_named():
    """Each per-tenant bound refuses with a structured QuotaExceededError
    naming the bound (QPS bucket, inflight cap, p95), stamped with
    ``shed`` and the tenant; an unstamped request keeps the pre-tenant
    contract. Every response, message and per-tenant row equals the JAX
    router's."""
    def scenario(mod):
        cfg = mod.FleetConfig(
            n_replicas=2, replica_ranks=2, probe_interval_s=30.0,
            tenants={"b": {"qps": 0.001, "burst_s": 1.0},
                     "c": {"max_inflight": 0},
                     "d": {"shed_p95_s": 0.5}})
        router = mod.FleetRouter(lambda i, g: FakeReplica(_ok_handler),
                                 cfg)
        router.start()
        try:
            start = mod.affine_replica(Q, 2, 2)
            resps = [router.dispatch({**Q, "tenant": "b"}),
                     router.dispatch({**Q, "tenant": "b"}),
                     router.dispatch({**Q, "tenant": "c"})]
            for rep in router.replicas:
                rep.last_stats = {"qps_60s": 1.0,
                                  "latency": {"p95_s": 2.0}}
            resps.append(router.dispatch({**Q, "tenant": "d"}))
            legacy = router.dispatch(dict(Q))
            return {"resps": [outcome(r, start) for r in resps],
                    "messages": [r.get("message") for r in resps],
                    "legacy": outcome(legacy, start),
                    "legacy_has_tenant": "tenant" in legacy,
                    "tenants": _tenant_rows(router.stats()),
                    "gauges": fleet_gauges(router)}
        finally:
            router.stop()

    j, t = both(scenario)
    assert t == j
    first, second, capped, slow = t["resps"]
    assert first["ok"]
    assert second["error"] == "QuotaExceededError" and second["shed"]
    assert second["tenant"] == "b" and "QPS quota" in t["messages"][1]
    assert capped["error"] == "QuotaExceededError"
    assert "max_inflight" in t["messages"][2]
    assert slow["error"] == "QuotaExceededError"
    assert "p95" in t["messages"][3]
    st = t["tenants"]
    assert st["b"]["quota_sheds"] == st["c"]["quota_sheds"] == \
        st["d"]["quota_sheds"] == 1
    assert st["b"]["shed"] == 1 and st["b"]["inflight"] == 0
    assert t["legacy"]["ok"] and not t["legacy_has_tenant"]
    assert set(st) == {"b", "c", "d"}


def test_tenant_state_take_token_under_a_fake_clock():
    """``_TenantState``'s token bucket (refill, cap, a negative delta on
    the creating admission) gives the JAX router's verdicts and token
    levels on one scripted clock."""
    quotas = [{"qps": 2.0, "burst_s": 1.5}, {"qps": 0.5},
              {"qps": 0.001, "burst_s": 1.0}, {"qps": 10.0, "burst_s": 0}]
    clock = [0.0, 0.0, 0.1, 0.2, 0.2, 0.9, 1.0, 3.0, 2.5, 2.5, 10.0,
             10.01, 10.02, 10.5]
    for quota in quotas:
        runs = []
        for mod in (jfleet, tfleet):
            st = mod._TenantState("t", quota)
            st.last_refill_monotonic = 0.05   # the creating stamp
            runs.append([(st.take_token(now), round(st.tokens, 12))
                         for now in clock])
        assert runs[0] == runs[1], quota
    unconfigured = tfleet._TenantState("u", None)
    assert (unconfigured.priority, unconfigured.tokens) == (1, 0.0)


def test_priority_shed_order_low_yields_first():
    """Under the SAME fleet pressure the low-priority tenant's headroom
    runs out first: it sheds with ShedError naming the priority bound
    while the high-priority tenant, and the low one once the pressure is
    gone, serve. As the JAX router."""
    def scenario(mod):
        cfg = mod.FleetConfig(
            n_replicas=2, replica_ranks=2, probe_interval_s=30.0,
            max_inflight_per_replica=2,
            tenants={"low": {"priority": 1}, "high": {"priority": 2}})
        router = mod.FleetRouter(lambda i, g: FakeReplica(_ok_handler),
                                 cfg)
        router.start()
        try:
            start = mod.affine_replica(Q, 2, 2)
            with router._lock:
                for rep in router.replicas:
                    rep.inflight += 1
            low = router.dispatch({**Q, "tenant": "low"})
            high = router.dispatch({**Q, "tenant": "high"})
            with router._lock:
                for rep in router.replicas:
                    rep.inflight = max(rep.inflight - 1, 0)
            relieved = router.dispatch({**Q, "tenant": "low"})
            return {"low": outcome(low, start),
                    "low_msg": low.get("message"),
                    "high": outcome(high, start),
                    "relieved": outcome(relieved, start),
                    "tenants": _tenant_rows(router.stats())}
        finally:
            router.stop()

    j, t = both(scenario)
    assert t == j
    assert not t["low"]["ok"] and t["low"]["error"] == "ShedError"
    assert t["low"]["shed"] and t["low"]["tenant"] == "low"
    assert "priority" in t["low_msg"]
    assert t["high"]["ok"] and t["relieved"]["ok"]
    assert t["tenants"]["low"]["priority_sheds"] == 1


def test_autoscaler_spawns_warm_verified_then_drains_idle(tmp_path):
    """The control loop: sustained probed QPS over the up bound spawns
    replica 2, pre-warm gated on a replay of the hottest retained spec
    with zero new traces before rotation; a sustained idle fleet drains
    it back, never below the base count. The decision log equals the
    JAX router's, and the port's record passes the port's ``analyze
    check``."""
    from distributed_join_tpu_torch.telemetry.analyze import check_file

    def scenario(mod):
        cfg = mod.FleetConfig(
            n_replicas=2, replica_ranks=2, probe_interval_s=30.0,
            autoscale=True, autoscale_max_replicas=3,
            autoscale_up_qps=0.5, autoscale_interval_s=0.05,
            autoscale_sustain=2, autoscale_down_qps=0.1,
            autoscale_idle_s=0.3)
        router = mod.FleetRouter(lambda i, g: FakeReplica(_ok_handler),
                                 cfg)
        router.start()
        try:
            served = router.dispatch(dict(Q))
            with router._lock:
                for rep in router.replicas:
                    rep.last_stats = {"qps_60s": 5.0,
                                      "latency": {"p95_s": 0.01}}
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                with router._lock:
                    if router.autoscale_spawns_total >= 1:
                        break
                time.sleep(0.02)
            with router._lock:
                scaled = [r.state for r in router.replicas
                          if r.index == 2]
            time.sleep(0.3)
            spawns_after_heat = router.autoscale_spawns_total
            with router._lock:
                for rep in router.replicas:
                    rep.last_stats = {"qps_60s": 0.0, "latency": {}}
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                record = router.autoscale_record()
                if any(e["action"] == "drain" for e in record["events"]):
                    break
                time.sleep(0.02)
            with router._lock:
                live = sorted(r.index for r in router.replicas
                              if r.state in ("healthy", "suspect"))
            time.sleep(0.5)
            events = [{k: v for k, v in e.items()
                       if k not in ("unix_s", "qps_60s", "p95_s",
                                    "reason")}
                      for e in record["events"]]
            for e in events:
                if e.get("signature") == mod.affinity_key(Q, 2):
                    e["signature"] = "the hottest spec's key"
            return {"served": served["ok"], "scaled": scaled,
                    "spawns_after_heat": spawns_after_heat,
                    "events": events, "live": live,
                    "drains": router.autoscale_drains_total,
                    "record": record}
        finally:
            router.stop()

    j, t = both(scenario)
    record = t.pop("record")
    j.pop("record")
    assert t == j
    assert t["served"] and t["scaled"] == ["healthy"]
    spawn, drain = t["events"]
    assert spawn == {"action": "spawn", "replica": 2,
                     "warm_verified": True, "new_traces": 0,
                     "signature": "the hottest spec's key"}
    assert drain == {"action": "drain", "replica": 2}
    assert t["spawns_after_heat"] == 1 and t["drains"] == 1
    assert t["live"] == [0, 1]
    out = tmp_path / "autoscale.json"
    out.write_text(json.dumps(record))
    assert check_file(str(out)) == []


# -- real replicas -----------------------------------------------------


def test_kill_failover_oracle_exact_and_replacement_warm(tmp_path):
    """The full kill story on the port's in-process fleet (the JAX run is
    red on jax 0.9.0 at its replacement's replay, so the port is held to
    the reference test's written expectations): affinity holds warm, the
    killed replica's repeat fails over oracle-exact within the budget,
    the slot is drained and replaced, the replacement serves the repeat
    with zero new traces from its slot's persisted entry; history lines
    carry validated replica stamps and the fleet gauges ride
    Prometheus."""
    from distributed_join_tpu_torch.telemetry.analyze import check_file

    router, server, client = make_fleet(
        tfleet, tmp_path, history_dir=str(tmp_path / "hist"),
        probe_interval_s=10.0)
    try:
        expected = oracle_matches(tfleet, Q)
        cold = client.send(Q)
        warm = client.send(Q)
        assert cold["ok"] and warm["ok"]
        assert cold["matches"] == warm["matches"] == expected
        assert cold["fleet"]["replica"] == tfleet.affine_replica(Q, 2, 2)
        assert warm["fleet"]["replica"] == cold["fleet"]["replica"]
        assert warm["new_traces"] == 0

        victim = router.replicas[cold["fleet"]["replica"]]
        victim.backend.kill()
        failover = client.send(Q)
        assert failover["ok"], failover
        assert failover["matches"] == expected
        assert failover["fleet"]["replica"] != victim.index
        assert failover["fleet"]["attempts"] <= \
            router.config.retry_budget + 1

        assert router.wait_replaced(victim.index, timeout_s=60.0)
        direct = tserver.ServiceClient(*victim.addr())
        try:
            replay = direct.send(Q)
        finally:
            direct.close()
        assert replay["ok"] and replay["matches"] == expected
        assert replay["new_traces"] == 0, replay["cache"]
        assert replay["cache"]["disk_loads"] == 1

        stats = router.stats()
        assert stats["healthy"] == 2
        assert stats["replaced_total"] == 1
        assert stats["failovers_total"] >= 1
        prom = router.prometheus_metrics()
        for gauge in ("djtpu_fleet_replicas 2",
                      "djtpu_fleet_healthy 2",
                      "djtpu_fleet_drained 0",
                      "djtpu_fleet_failovers_total",
                      "djtpu_fleet_shed_total",
                      "djtpu_fleet_replaced_total 1"):
            assert gauge in prom, (gauge, prom)
    finally:
        teardown_fleet(router, server, client)

    hist = tmp_path / "hist" / "history.jsonl"
    assert check_file(str(hist)) == []
    entries = [json.loads(ln) for ln in hist.read_text().splitlines()]
    stamped = [e for e in entries if e.get("replica")]
    assert stamped, "router history must stamp serving replicas"
    assert {"index", "generation"} <= set(stamped[0]["replica"])


def _join_watchdog_workers():
    for t in threading.enumerate():
        if t.name.startswith("watchdog-request"):
            t.join(timeout=120.0)


def test_hang_drains_replaces_and_followup_is_warm(tmp_path):
    """A FaultPlan dispatch delay blows the victim's watchdog deadline:
    the HangError (or the prober's view of the poisoned replica) drains
    and replaces it, the hung request itself fails over and serves, and
    the replacement serves the repeat. The same script through both
    routers gives the same outcomes."""
    def scenario(mod):
        victim_index = mod.affine_replica(Q, 2, 2)
        fl = _faults_of(mod)

        def wrap(index, generation, comm):
            if index == victim_index and generation == 0:
                return fl.FaultInjectingCommunicator(
                    comm, fl.FaultPlan(dispatch_delay_s=10.0,
                                       delay_after_dispatches=2))
            return comm

        sub = tmp_path / mod.__name__.split(".")[0]
        router, server, client = make_fleet(
            mod, sub, comm_wrap=wrap,
            service_config=_server_of(mod).ServiceConfig(
                request_deadline_s=8.0))
        try:
            expected = oracle_matches(mod, Q)
            cold = client.send(Q)
            warm = client.send(Q)
            hung = client.send(Q)
            assert router.wait_replaced(victim_index, timeout_s=60.0)
            rep = router.replicas[victim_index]
            reason = rep.drained_reason or ""
            direct = _server_of(mod).ServiceClient(*rep.addr())
            try:
                replay = direct.send(Q)
            finally:
                direct.close()
            return {"cold": outcome(cold, victim_index, False),
                    "warm": outcome(warm, victim_index, False),
                    "warm_traces": warm["new_traces"],
                    "hung": {**outcome(hung, victim_index, False),
                             "failovers": hung["fleet"]["failovers"] >= 1},
                    "for_the_hang": ("hang" in reason.lower()
                                     or "did not complete" in reason),
                    "generation": rep.generation,
                    "replay_ok": replay["ok"],
                    "oracle": [r.get("matches") == expected
                               for r in (cold, warm, hung, replay)]}
        finally:
            teardown_fleet(router, server, client)
            _join_watchdog_workers()

    j, t = both(scenario)
    assert t == j
    assert t["cold"]["replica"] == 0 and t["warm_traces"] == 0
    assert t["hung"]["ok"] and t["hung"]["replica"] == 1
    assert t["hung"]["failovers"] and t["for_the_hang"]
    assert t["generation"] == 1 and t["replay_ok"]
    assert t["oracle"] == [True] * 4


def test_corrupt_refuses_loudly_through_router_never_wrong_rows(tmp_path):
    """An armed corruption mode with ``verify_integrity`` and no retry
    budget, on the port's fleet (the JAX run is red on jax 0.9.0: the
    shard_map ``out_specs`` error of its integrity programs), held to
    the reference test's written expectations: the IntegrityError passes
    THROUGH the router (a refusal, never wrong rows), the replica is not
    drained, and the repeat, whose program the failed check evicted,
    serves oracle-exact on the same replica."""
    victim_index = tfleet.affine_replica(Q, 2, 2)

    def wrap(index, generation, comm):
        if index == victim_index and generation == 0:
            return tfaults.FaultInjectingCommunicator(
                comm, tfaults.FaultPlan(seed=7, corrupt_mode="bit_flip",
                                        corrupt_collectives=1))
        return comm

    router, server, client = make_fleet(
        tfleet, tmp_path, comm_wrap=wrap,
        service_config=tserver.ServiceConfig(verify_integrity=True,
                                             auto_retry=0))
    try:
        expected = oracle_matches(tfleet, Q)
        first = client.send(Q)
        assert not first["ok"], \
            "the corrupted exchange must refuse, not answer"
        assert first["error"] == "IntegrityError", first
        assert router.replicas[victim_index].state != "drained"
        second = client.send(Q)
        assert second["ok"], second
        assert second["matches"] == expected
        assert second["fleet"]["replica"] == victim_index
        assert router.stats()["drains_total"] == 0
        # the corrupted program never entered the slot's disk tier
        assert not (tmp_path / "programs" / f"r{victim_index}").exists() \
            or not list((tmp_path / "programs"
                         / f"r{victim_index}").glob("*.joinprog"))
    finally:
        teardown_fleet(router, server, client)


def test_program_cache_is_tenant_free_history_is_not(tmp_path):
    """The program cache stays shared across tenants (keyed by workload
    signature alone): tenant beta's first request for alpha's signature
    is a warm hit on the same affine replica, while the router's history
    stamps each entry with its tenant and the trend table keys
    ``tenant/signature``. The same outcomes as the JAX fleet's."""
    from distributed_join_tpu_torch.telemetry import history as hist_mod
    from distributed_join_tpu_torch.telemetry.analyze import check_file

    def scenario(mod):
        sub = tmp_path / mod.__name__.split(".")[0]
        router, server, client = make_fleet(
            mod, sub, history_dir=str(sub / "hist"), probe_interval_s=10.0)
        start = mod.affine_replica(Q, 2, 2)
        try:
            cold = client.send({**Q, "tenant": "alpha"})
            warm = client.send({**Q, "tenant": "beta"})
        finally:
            teardown_fleet(router, server, client)
        hist = sub / "hist" / "history.jsonl"
        reqs = [e for e in (json.loads(ln) for ln in
                            hist.read_text().splitlines())
                if e.get("kind") == "request"]
        return {"cold": outcome(cold, start, False),
                "warm": outcome(warm, start, False),
                "warm_traces": warm["new_traces"],
                "tenants": sorted(e.get("tenant") for e in reqs),
                "oracle": cold["matches"] == oracle_matches(mod, Q)}, hist

    (j, _), (t, hist) = both(scenario)
    assert t == j
    assert t["warm"]["replica"] == t["cold"]["replica"] == 0
    assert t["warm_traces"] == 0 and t["oracle"]
    assert t["tenants"] == ["alpha", "beta"]
    assert check_file(str(hist)) == []
    reqs = [e for e in (json.loads(ln) for ln in
                        hist.read_text().splitlines())
            if e.get("kind") == "request"]
    sig = tfleet.affinity_key(Q, 2)
    assert hist_mod.tenant_key(sig, "alpha") == f"alpha/{sig}"
    assert hist_mod.tenant_key(sig, None) == sig
    trends = hist_mod.trends_of(reqs)
    assert f"alpha/{sig}" in trends and f"beta/{sig}" in trends


# -- artifacts ---------------------------------------------------------


def test_tenant_artifact_schemas(tmp_path):
    """The port's ``analyze check`` recognises the three tenancy
    artifact kinds by their stamps and flags gutted ones, as the JAX
    package's does."""
    from distributed_join_tpu.telemetry.analyze import (
        check_file as jcheck,
    )
    from distributed_join_tpu_torch.telemetry.analyze import check_file

    docs = {
        "soak.json": {
            "kind": "fleet_tenant_soak", "schema_version": 1,
            "harness_seed": 7, "slice": "tenants", "victim": 1,
            "replica_ranks": 2, "trials": 4,
            "verdicts": {"ok": 4},
            "noisy": {"sent": 40, "quota_shed": 33},
            "quiet": {"trials": 4, "shed_responses": 0},
            "failures": 0},
        "autoscale.json": {
            "kind": "fleet_autoscale", "schema_version": 1,
            "enabled": True, "spawns_total": 1, "drains_total": 0,
            "replicas": 3,
            "events": [{"action": "spawn", "replica": 2,
                        "reason": "sustained load",
                        "warm_verified": True, "new_traces": 0}]},
        "smoke.json": {
            "kind": "fleet_tenant_smoke", "n_ranks": 2,
            "replicas": 2,
            "counter_signature": {"signature_version": 1,
                                  "n_ranks": 2,
                                  "counters": {"replicas": 2}},
            "tenants": {"gold": {}}, "autoscale": {}},
    }
    gut = {"fleet_tenant_soak": "noisy",
           "fleet_autoscale": "events",
           "fleet_tenant_smoke": "counter_signature"}
    for name, doc in docs.items():
        p = tmp_path / name
        p.write_text(json.dumps(doc))
        assert check_file(str(p)) == jcheck(str(p)) == [], name
        gutted = dict(doc)
        gutted.pop(gut[doc["kind"]])
        bad = tmp_path / ("bad_" + name)
        bad.write_text(json.dumps(gutted))
        assert check_file(str(bad)), \
            f"a gutted {doc['kind']} artifact must be flagged"
        assert check_file(str(bad)) == jcheck(str(bad))


def test_fleet_soak_artifact_schema(tmp_path):
    """The port's ``analyze check`` recognises the ``fleet_soak``
    artifact kind by its stamp (any file name) and flags a verdict-less
    one, as the JAX package's does."""
    from distributed_join_tpu.telemetry.analyze import (
        check_file as jcheck,
    )
    from distributed_join_tpu_torch.telemetry.analyze import check_file

    doc = {"kind": "fleet_soak", "schema_version": 1,
           "harness_seed": 42, "slice": "fleet", "fault": "kill",
           "victim": 0, "replica_ranks": 2, "trials": 20,
           "verdicts": {"ok": 19, "recovered": 1}, "answered": 20,
           "failures": 0,
           "drain_replace": {"required": True, "drained": True,
                             "replaced": True}}
    path = tmp_path / "any_name.json"
    path.write_text(json.dumps(doc))
    assert check_file(str(path)) == jcheck(str(path)) == []
    bad = dict(doc)
    bad.pop("verdicts")
    bad_path = tmp_path / "other_name.json"
    bad_path.write_text(json.dumps(bad))
    assert check_file(str(bad_path)), \
        "a verdict-less fleet_soak artifact must be flagged"


def test_fleet_module_exports():
    """The reference's public names, and an import that pulls in neither
    ``jax`` nor the JAX package (a fresh interpreter)."""
    names = ("FleetConfig", "FleetRouter", "RouterHA", "RouterLease",
             "affinity_key", "affine_replica", "process_fleet_factory",
             "in_process_fleet_factory", "run_fleet_smoke",
             "run_tenant_smoke", "run_tracing_smoke",
             "run_fleet_ha_smoke", "main", "start_router_daemon",
             "table_manifest_doc", "load_table_manifest",
             "load_router_directory", "FleetError", "NoHolderError",
             "QuotaExceededError", "ShedError")
    for name in names:
        assert hasattr(tfleet, name) and hasattr(jfleet, name), name
    assert callable(tfleet.process_fleet_factory)
    code = ("import sys, distributed_join_tpu_torch.service.fleet; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'distributed_join_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=tfleet._replica_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_process_factory_places_replicas_and_the_cli_refuses_platform(
        monkeypatch):
    """The process factory starts the port's daemon (never the JAX
    module) with ``--communicator local`` at one rank or ``emulated
    --n-ranks k``, ``--device`` placed replica by replica
    (``cuda:{i mod device_count}`` on the GPU), the shared
    ``--persist-dir`` unless a generation-0 override keeps the victim
    out; the fleet CLI refuses ``--platform`` and takes ``--device``."""
    import contextlib
    import io

    seen = []

    class Captured:
        def __init__(self, argv, spawn_timeout_s=180.0, env=None):
            seen.append((argv, env))

    monkeypatch.setattr(tfleet, "ProcessReplica", Captured)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 4)
    for ranks in (1, 2):
        cfg = tfleet.FleetConfig(replica_ranks=ranks, persist_dir="/p")
        factory = tfleet.process_fleet_factory(
            cfg, device=None, extra_args=["--auto-retry", "1"],
            replica_overrides={5: {"persist": False,
                                   "fault_plan": {"seed": 1}}})
        for index in (0, 5):
            factory(index, 0)
        factory(5, 1)
    argvs = [a for a, _ in seen]
    for argv in argvs:
        assert argv[1:3] == ["-m", "distributed_join_tpu_torch.service.server"]
        assert "--platform" not in argv
    assert argvs[0][argvs[0].index("--communicator") + 1] == "local"
    assert argvs[3][argvs[3].index("--communicator"):][:4] == [
        "--communicator", "emulated", "--n-ranks", "2"]
    devices = [a[a.index("--device") + 1] for a in argvs]
    assert devices == ["cuda:0", "cuda:1", "cuda:1"] * 2
    assert "--persist-dir" in argvs[0] and "--persist-dir" not in argvs[1]
    assert "--fault-plan" in argvs[1] and "--fault-plan" not in argvs[2]
    assert "--persist-dir" in argvs[2]          # the replacement is clean
    assert all(a[-2:] == ["--auto-retry", "1"] for a in argvs[::3])
    env = seen[0][1]
    assert env["PYTHONPATH"].split(":")[0] == tfleet._replica_env()[
        "PYTHONPATH"].split(":")[0]
    assert tfleet.replica_device("cpu", 3) == "cpu"
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    with pytest.raises(tfleet.FleetError, match="--device cpu"):
        tfleet.replica_device(None, 0)
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        tfleet.parse_args(["--platform", "cpu"])
    assert "--platform" in err.getvalue() and "--device" in err.getvalue()
    args = tfleet.parse_args(["--device", "cpu", "--replicas", "3",
                              "--replica-ranks", "1", "--persist-dir", "d",
                              "--table-replication", "2",
                              "--coord-dir", "c", "--standby"])
    assert (args.device, args.replicas, args.replica_ranks,
            args.persist_dir, args.table_replication, args.coord_dir,
            args.standby) == ("cpu", 3, 1, "d", 2, "c", True)


def test_retry_with_backoff_retries_only_retry_on_like_jax():
    """The failover loop's ``retry_with_backoff(retry_on=...)``: the
    listed errors are retried with the doubling backoff (the trail and
    the sleeps equal the JAX helper's), any other error propagates at
    once with no trail."""
    class Flaky(RuntimeError):
        pass

    def script(helper):
        calls, sleeps = [], []

        def fn():
            calls.append(len(calls))
            if len(calls) < 3:
                raise Flaky(f"try {len(calls)}")
            return "ok"

        out, trail = helper(fn, max_attempts=4, backoff_s=0.5,
                            retry_on=(Flaky,), sleep=sleeps.append,
                            clock=lambda: 0.0)
        errors = [a["error"] for a in trail]

        def other():
            raise KeyError("not retried")

        with pytest.raises(KeyError) as info:
            helper(other, max_attempts=4, backoff_s=0.5, retry_on=(Flaky,),
                   sleep=sleeps.append, clock=lambda: 0.0)
        return (out, errors, sleeps, len(calls),
                hasattr(info.value, "_retry_attempts"))

    got = script(tfaults.retry_with_backoff)
    assert got == script(jfaults.retry_with_backoff)
    assert got == ("ok", ["Flaky: try 1", "Flaky: try 2", None],
                   [0.5, 1.0], 3, False)
