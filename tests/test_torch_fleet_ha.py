"""Replicated resident state and router HA of the port's fleet
(distributed_join_tpu_torch/service/fleet.py) against the JAX package's,
on the CPU: one port test for each test of ``tests/test_fleet_ha.py``,
under its name, and the durable documents bit for bit.

Each scenario runs the same requests and faults through a K=2 JAX fleet
(disjoint device subsets of its 8-device CPU runtime) and a K=2 port
fleet (per-slot communicators on the CPU) and compares the outcomes
exactly: ``ok``, error class, the serving replica and the holder sets
(table-op keys are JAX's bit for bit, so the slots are the same),
generations, attempts and failovers, the directory's holder states;
``matches`` is compared with each package's own oracle (each draws its
own tables). The table manifest and the router directory are compared
as documents, bit for bit, with the clock fixed; ``RouterLease``'s
fencing on one script.
"""

import dataclasses
import json
import os
import time

import pytest

from distributed_join_tpu.parallel import faults as jfaults
from distributed_join_tpu.service import fleet as jfleet
from distributed_join_tpu.service import server as jserver
from distributed_join_tpu_torch.parallel import faults as tfaults
from distributed_join_tpu_torch.service import fleet as tfleet
from distributed_join_tpu_torch.service import server as tserver
from distributed_join_tpu_torch.telemetry import tracectx
from distributed_join_tpu_torch.telemetry.analyze import check_file

TABLE = "ha_t"
REG = {"op": "register", "name": TABLE, "rows": 1024, "seed": 5,
       "rand_max": 2048, "unique_keys": True}
DELTA = {"op": "append", "name": TABLE, "rows": 256, "seed": 7,
         "rand_max": 2048}
Q = {"op": "join", "table": TABLE, "probe_nrows": 512, "seed": 5,
     "selectivity": 0.4, "rand_max": 2048,
     "out_capacity_factor": 3.0}

# The table's primary holder slot, the same in both packages (table-op
# keys are equal bit for bit).
VICTIM = tfleet.affine_replica({"op": "join", "table": TABLE}, 2, 2)


def _server_of(mod):
    return jserver if mod is jfleet else tserver


def _faults_of(mod):
    return jfaults if mod is jfleet else tfaults


def oracle_matches(mod, deltas=()) -> int:
    """Each package's oracle over its own generator's draws."""
    if mod is tfleet:
        return tfleet.resident_oracle_matches(REG, deltas, Q, "cpu")
    import pandas as pd

    base = jserver._build_from_spec(REG)
    frames = [base.to_pandas()]
    frames += [jserver._build_from_spec(d).to_pandas() for d in deltas]

    class _Stub:
        wire_spec = {k: REG[k] for k in
                     ("rows", "seed", "rand_max", "unique_keys")}
        wire_build_keys = base.columns["key"]

    probe = jserver._probe_from_spec(Q, _Stub)
    return len(pd.concat(frames, ignore_index=True)
               .merge(probe.to_pandas(), on="key"))


def make_ha_fleet(mod, tmp_path, *, comm_wrap=None, probe_interval_s=5.0,
                  **cfg_overrides):
    """A K=2 in-process fleet with the durable coord dir armed (the long
    probe interval keeps fault discovery on the request path)."""
    cfg = mod.FleetConfig(
        n_replicas=2, replica_ranks=2,
        probe_interval_s=probe_interval_s,
        suspect_strikes=2, retry_budget=2,
        table_replication=2,
        coord_dir=str(tmp_path / "coord"),
        **cfg_overrides)
    kw = {"device": "cpu"} if mod is tfleet else {}
    factory = mod.in_process_fleet_factory(
        2, 2, comm_wrap=comm_wrap,
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


def outcome(resp) -> dict:
    fl = resp.get("fleet") or {}
    return {"ok": resp.get("ok"), "error": resp.get("error"),
            "generation": resp.get("generation"),
            "resident_generation": (resp.get("resident") or {})
            .get("generation"),
            "replica": fl.get("replica"), "attempts": fl.get("attempts"),
            "failovers": fl.get("failovers"),
            "holders": fl.get("holders"), "applied": fl.get("applied"),
            "table_generation": fl.get("table_generation"),
            "table": resp.get("table")}


def holder_states(router) -> dict:
    return {i: dict(h) for i, h in
            router.stats()["tables"].get(TABLE, {}).get("holders",
                                                        {}).items()}


def run_both(tmp_path, scenario):
    """``scenario(mod, dir)`` for the JAX fleet and the port's, each in
    a directory of its own."""
    return (scenario(jfleet, tmp_path / "jax"),
            scenario(tfleet, tmp_path / "torch"))


# -- durable artifacts -------------------------------------------------


def test_replicated_register_writes_manifest_and_directory(tmp_path):
    """K=2 register lands on both ring slots and records the table
    durably: a versioned manifest and the fence-counted router directory,
    both passing the port's ``analyze check``; outcomes and holder states
    equal the JAX fleet's."""
    def scenario(mod, d):
        router, server, client = make_ha_fleet(mod, d)
        coord = str(d / "coord")
        try:
            r = client.send(REG)
            a = client.send(DELTA)
            man = mod.load_table_manifest(coord, TABLE)
            doc = mod.load_router_directory(coord)
            st = router.stats()
            # a manifest keeps the wire spec as sent, the client's
            # minted trace context with it
            spec = {k: v for k, v in man["register"].items()
                    if k != tracectx.TRACE_FIELD}
            deltas = [{k: v for k, v in x.items()
                       if k != tracectx.TRACE_FIELD}
                      for x in man["deltas"]]
            return {"register": outcome(r), "append": outcome(a),
                    "manifest": {k: man[k] for k in
                                 ("kind", "schema_version", "generation",
                                  "name", "key")},
                    "manifest_register": spec,
                    "deltas": deltas, "prep": man["prep"],
                    "digest": man["payload_digest"] == mod.spec_digest(
                        {"register": man["register"],
                         "deltas": man["deltas"]}),
                    "directory": {k: doc[k] for k in
                                  ("kind", "schema_version",
                                   "table_replication", "lease_epoch")},
                    "fence": doc["fence"] >= 1,
                    "dir_tables": doc["tables"],
                    "holders": holder_states(router),
                    "replication": st["table_replication"]}, coord
        finally:
            teardown_fleet(router, server, client)

    (j, _), (t, coord) = run_both(tmp_path, scenario)
    assert t == j
    assert t["register"]["ok"] and t["register"]["generation"] == 1
    assert sorted(t["register"]["holders"]) == [0, 1]
    assert t["append"]["generation"] == 2
    assert sorted(t["append"]["applied"]) == [0, 1]
    assert t["manifest"]["generation"] == 2 and len(t["deltas"]) == 1
    assert t["manifest_register"]["name"] == TABLE and t["digest"]
    assert check_file(tfleet.table_manifest_path(coord, TABLE)) == []
    assert check_file(os.path.join(coord, "router_directory.json")) == []
    assert {h["state"] for h in t["holders"].values()} == {"serving"}
    assert {h["generation"] for h in t["holders"].values()} == {2}


def test_table_manifest_doc_and_directory_equal_jax_bit_for_bit(
        tmp_path, monkeypatch):
    """The durable documents: ``table_manifest_doc`` (its payload digest
    through ``spec_digest``), the manifest path and slug, and the router
    directory a primary writes for one replica set and table directory,
    byte for byte with the JAX router's under one fixed clock."""
    for mod in (jfleet, tfleet):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
    for name in (TABLE, "a table/with spaces", "x" * 80):
        docs = [mod.table_manifest_doc(
            name, dict(REG, name=name), "key", 3,
            [DELTA, dict(DELTA, seed=8)],
            {"replica_ranks": 2, "table_replication": 2})
            for mod in (jfleet, tfleet)]
        assert docs[0] == docs[1]
        assert jfleet.table_manifest_path("c", name) == \
            tfleet.table_manifest_path("c", name)

    class Backend:
        def __init__(self, port):
            self.host, self.port = "127.0.0.1", port

        def alive(self):
            return True

        def stop(self, timeout_s=10.0):  # noqa: ARG002 - backend API
            pass

    texts = []
    for mod in (jfleet, tfleet):
        coord = tmp_path / mod.__name__.split(".")[0]
        cfg = mod.FleetConfig(table_replication=2, coord_dir=str(coord),
                              router_id="router-a")
        router = mod.FleetRouter(lambda i, g: None, cfg)
        router.replicas = [mod._Replica(index=i, backend=Backend(7000 + i),
                                        generation=i, state=s)
                           for i, s in enumerate(("healthy", "drained"))]
        router._tables = {TABLE: {"generation": 2, "key": "key",
                                  "holders": {0: {"state": "serving",
                                                  "generation": 2},
                                              1: {"state": "stale",
                                                  "generation": 1}}}}
        router._save_directory()
        router._save_directory()
        texts.append((coord / "router_directory.json").read_text())
        doc = json.loads(texts[-1])
        assert doc["fence"] == 2 and doc["written_by"] == "router-a"
    assert texts[0] == texts[1]


# -- generation fencing ------------------------------------------------


def test_missed_append_fences_holder_and_fails_over(tmp_path):
    """One fan-out leg of the append is dropped on the table's primary
    holder (dispatch #2 of its communicator: the register's prep is #1,
    the append's delta prep #2). The router fences that holder at its
    stale generation; the probe-only join that ring-starts there fails
    over to the up-to-date sibling; the stale holder refuses a fenced
    join with ``StaleGenerationError`` and, unfenced, serves its own
    generation. As the JAX fleet."""
    def scenario(mod, d):
        fl = _faults_of(mod)

        def wrap(index, generation, comm):
            if index == VICTIM and generation == 0:
                return fl.FaultInjectingCommunicator(
                    comm, fl.FaultPlan(drop_dispatches=(2,)))
            return comm

        router, server, client = make_ha_fleet(mod, d, comm_wrap=wrap)
        try:
            r = client.send(REG)
            a = client.send(DELTA)
            holders = holder_states(router)
            j = client.send(Q)
            direct = _server_of(mod).ServiceClient(
                *router.replicas[VICTIM].addr())
            try:
                refusal = direct.send({**Q, "min_generation": 2})
                old = direct.send(Q)
            finally:
                direct.close()
            return {"register": outcome(r), "append": outcome(a),
                    "holders": holders, "join": outcome(j),
                    "join_oracle": j["matches"] == oracle_matches(
                        mod, [DELTA]),
                    "refusal": outcome(refusal),
                    "refusal_msg": refusal.get("message"),
                    "old": outcome(old),
                    "old_oracle": old["matches"] == oracle_matches(mod)}
        finally:
            teardown_fleet(router, server, client)

    j, t = run_both(tmp_path, scenario)
    assert t == j
    assert t["register"]["ok"] and t["append"]["ok"]
    assert t["append"]["generation"] == 2
    assert t["append"]["applied"] == [1 - VICTIM]
    assert t["holders"][str(VICTIM)] == {"state": "stale", "generation": 1}
    assert t["holders"][str(1 - VICTIM)] == {"state": "serving",
                                            "generation": 2}
    assert t["join"]["ok"] and t["join_oracle"]
    assert t["join"]["replica"] == 1 - VICTIM
    assert t["join"]["resident_generation"] == 2
    assert t["refusal"]["error"] == "StaleGenerationError"
    assert "generation 1" in t["refusal_msg"]
    assert t["old"]["ok"] and t["old_oracle"]


# -- holder-set routing ------------------------------------------------


def test_no_live_holder_is_a_structured_refusal(tmp_path):
    """Table ops route by holder set; when the set is empty (never
    registered) or every holder is drained, the router refuses with
    ``NoHolderError``, never a misroute. As the JAX fleet."""
    def scenario(mod, d):
        router, server, client = make_ha_fleet(mod, d)
        try:
            a = client.send({"op": "append", "name": "ghost", "rows": 8,
                             "seed": 1, "rand_max": 64})
            r = client.send(REG)
            for rep in router.replicas:
                rep.state = "drained"
            j = client.send(Q)
            return {"ghost": outcome(a), "register": outcome(r),
                    "join": outcome(j)}
        finally:
            teardown_fleet(router, server, client)

    j, t = run_both(tmp_path, scenario)
    assert t == j
    assert t["ghost"]["error"] == "NoHolderError"
    assert t["ghost"]["table"] == "ghost"
    assert t["register"]["ok"]
    assert t["join"]["error"] == "NoHolderError"
    assert t["join"]["table"] == TABLE


def test_rebuilding_holder_is_not_routed(tmp_path):
    """A slot mid-rebuild has no image yet: probe-only joins route round
    it to the serving sibling. As the JAX fleet."""
    def scenario(mod, d):
        router, server, client = make_ha_fleet(mod, d)
        try:
            out = [outcome(client.send(REG))]
            want = oracle_matches(mod)
            entry = router._tables[TABLE]
            for hidden in (0, 1):
                entry["holders"][hidden]["state"] = "rebuilding"
                j = client.send(Q)
                out.append({**outcome(j), "oracle": j["matches"] == want})
                entry["holders"][hidden]["state"] = "serving"
            return out
        finally:
            teardown_fleet(router, server, client)

    j, t = run_both(tmp_path, scenario)
    assert t == j
    assert t[0]["ok"]
    for hidden, rec in zip((0, 1), t[1:]):
        assert rec["ok"] and rec["oracle"]
        assert rec["replica"] == 1 - hidden


def test_holder_without_image_fails_over_not_passthrough(tmp_path):
    """The directory says a slot holds the image, the replica says it
    does not (dropped behind the router's back): the holder is parked
    stale and the request fails over, never passing the replica's
    ``ResidentError`` through; the next request gets the structured
    no-serving-holder refusal. As the JAX fleet."""
    def scenario(mod, d):
        router, server, client = make_ha_fleet(mod, d)
        try:
            r = client.send(REG)
            for rep in router.replicas:
                c = _server_of(mod).ServiceClient(*rep.addr())
                try:
                    assert c.send({"op": "drop", "name": TABLE})["ok"]
                finally:
                    c.close()
            j = client.send(Q)
            states = {i: h["state"] for i, h
                      in router._tables[TABLE]["holders"].items()}
            j2 = client.send(Q)
            return {"register": outcome(r), "join": outcome(j),
                    "states": states, "again": outcome(j2),
                    "again_msg": "no serving holder" in j2["message"]}
        finally:
            teardown_fleet(router, server, client)

    j, t = run_both(tmp_path, scenario)
    assert t == j
    assert not t["join"]["ok"] and t["join"]["error"] != "ResidentError"
    assert t["join"]["attempts"] >= 2
    assert set(t["states"].values()) == {"stale"}
    assert t["again"]["error"] == "NoHolderError" and t["again_msg"]


# -- holder kill -> manifest rebuild -----------------------------------


def test_killed_holder_rebuilds_from_manifest(tmp_path):
    """Kill the table's primary holder after an append: the probe-only
    join fails over within budget; the replacement replays the durable
    manifest (register, then the delta with the merge folded in), walks
    ``rebuilding -> serving``, and a fenced replay on it answers
    oracle-exact at the directory's generation, its probe-only program
    bound from the slot's persisted entry. As the JAX fleet."""
    def scenario(mod, d):
        router, server, client = make_ha_fleet(mod, d)
        try:
            assert client.send(REG)["ok"]
            assert client.send(DELTA)["ok"]
            expected = oracle_matches(mod, [DELTA])
            pre = None
            if mod is tfleet:
                # the probe-only program, persisted in the victim's slot
                # (a JAX blob of a device subset does not run on jax
                # 0.9.0: the reference's own red case at
                # tests/test_fleet.py:596, so its run skips this request)
                pre = outcome(client.send(Q))
            router.replicas[VICTIM].backend.kill()
            j = client.send(Q)
            replaced = router.wait_replaced(VICTIM, timeout_s=60.0)
            deadline = time.monotonic() + 60.0
            holder = None
            while time.monotonic() < deadline:
                holder = (router.stats()["tables"][TABLE]["holders"]
                          .get(str(VICTIM)))
                if holder and holder["state"] == "serving":
                    break
                time.sleep(0.1)
            direct = _server_of(mod).ServiceClient(
                *router.replicas[VICTIM].addr())
            try:
                replay = direct.send({**Q, "min_generation": 2})
            finally:
                direct.close()
            return {"pre": pre, "join": outcome(j),
                    "join_oracle": j["matches"] == expected,
                    "replaced": replaced, "holder": holder,
                    "rebuilds": router.stats()["rebuilds_total"] >= 1,
                    "replay": outcome(replay),
                    "replay_oracle": replay["matches"] == expected,
                    "replay_traces": replay["new_traces"]}
        finally:
            teardown_fleet(router, server, client)

    j, t = run_both(tmp_path, scenario)
    j.pop("replay_traces")
    traces = t.pop("replay_traces")
    pre = t.pop("pre")
    assert j.pop("pre") is None
    assert t == j
    assert pre["ok"] and pre["replica"] == VICTIM
    assert t["join"]["ok"] and t["join_oracle"]
    assert t["join"]["replica"] == 1 - VICTIM
    assert t["join"]["failovers"] >= 1
    assert t["replaced"] and t["rebuilds"]
    assert t["holder"] == {"state": "serving", "generation": 2}
    assert t["replay"]["ok"] and t["replay_oracle"]
    assert t["replay"]["resident_generation"] == 2
    assert traces == 0


# -- router HA ---------------------------------------------------------


def test_lease_is_fenced(tmp_path):
    """The lease file is a fence, not a lock: a second owner acquires
    only a stale lease, and the fenced-out first owner's renew fails.
    The same script gives the JAX lease's verdicts, and the documents
    the two write carry the same fields."""
    def script(mod, d):
        a = mod.RouterLease(str(d), owner="a", ttl_s=0.3)
        b = mod.RouterLease(str(d), owner="b", ttl_s=0.3)
        out = [a.acquire(), b.acquire(), a.renew()]
        time.sleep(0.5)  # a's lease expires un-renewed
        out += [b.acquire(), a.renew(), b.renew(), b.epoch]
        doc = a.read()
        b.release()
        out += [sorted(doc), doc["owner"], doc["epoch"], b.stale()]
        return out

    j, t = run_both(tmp_path, script)
    assert t == j
    assert t[:7] == [True, False, True, True, False, True, 2]
    assert t[8:] == ["b", 2, True]


def test_router_takeover_serves_resend_and_single_apply(tmp_path):
    """Kill the primary router mid-stream: the standby takes the fenced
    lease, adopts the fleet from the directory, re-binds the same
    advertised endpoint, and the retrying client's resend of the same
    request id is served (same answer, no new trace); a post-takeover
    append applies exactly once, on both holders. As the JAX fleet."""
    def scenario(mod, d):
        cfg = mod.FleetConfig(
            n_replicas=2, replica_ranks=2,
            probe_interval_s=5.0, suspect_strikes=2, retry_budget=2,
            table_replication=2,
            coord_dir=str(d / "coord"),
            lease_ttl_s=1.0, lease_renew_s=0.2)
        kw = {"device": "cpu"} if mod is tfleet else {}
        factory = mod.in_process_fleet_factory(
            2, 2, persist_dir=str(d / "programs"), **kw)
        router = mod.FleetRouter(factory, cfg)
        ha1 = mod.RouterHA(router, owner="router-a")
        port = ha1.start_primary()
        client = _server_of(mod).ServiceClient("127.0.0.1", port,
                                               retries=8)
        standby = mod.FleetRouter(factory, dataclasses.replace(cfg))
        ha2 = None
        try:
            assert client.send(REG)["ok"]
            expected = oracle_matches(mod)
            pre = client.send({**Q, "request_id": "ha-pin"})
            ha2 = mod.RouterHA(standby, owner="router-b")
            ha2.start_standby()
            ha1.crash()
            took = ha2.took_over.wait(timeout=30.0)
            again = client.send({**Q, "request_id": "ha-pin"})
            a = client.send(DELTA)
            holders = {i: h["generation"] for i, h in
                       standby.stats()["tables"][TABLE]["holders"]
                       .items()}
            return {"pre": outcome(pre),
                    "pre_oracle": pre["matches"] == expected,
                    "took": took, "role": standby.role,
                    "takeovers": standby.takeovers_total,
                    "again": outcome(again),
                    "again_same": again["matches"] == pre["matches"],
                    "again_traces": again["new_traces"],
                    "append": outcome(a), "holders": holders}
        finally:
            client.close()
            if ha2 is not None:
                ha2.stop(drain=False)
            seen = set()
            for rep in list(router.replicas) + list(standby.replicas):
                if id(rep.backend) in seen:
                    continue
                seen.add(id(rep.backend))
                try:
                    rep.backend.stop()
                except Exception:  # noqa: BLE001 - teardown boundary
                    pass

    j, t = run_both(tmp_path, scenario)
    assert t == j
    assert t["pre"]["ok"] and t["pre_oracle"]
    assert t["took"] and t["role"] == "primary" and t["takeovers"] == 1
    assert t["again"]["ok"] and t["again_same"]
    assert t["again_traces"] == 0
    assert t["append"]["ok"] and t["append"]["generation"] == 2
    assert sorted(t["append"]["applied"]) == [0, 1]
    assert set(t["holders"].values()) == {2}


@pytest.mark.parametrize("kind", ["fleet_smoke", "fleet_ha_smoke"])
def test_smoke_baselines_gate_at_their_own_rank_count_and_device(
        kind, tmp_path):
    """The committed ``results/baselines_torch/<kind>.json`` gate a
    smoke record of their own (rank count, device type) exactly, and
    skip a record drawn elsewhere (a CPU run, another rank count): the
    port's generators draw other bits on a card than on the CPU."""
    from distributed_join_tpu_torch.telemetry import baselines

    base = baselines.load_baseline(kind, tserver.SMOKE_BASELINE_DIR)
    sig = base["signature"]
    platform = base["config"]["platform"]

    class Args:
        smoke_baseline_dir = tserver.SMOKE_BASELINE_DIR

    rec = {"counter_signature": json.loads(json.dumps(sig)),
           "platform": platform, "violations": []}
    tfleet._gate_counters(rec, kind, Args)
    assert rec["baseline_gate"]["ok"] and rec["violations"] == []
    drifted = json.loads(json.dumps(sig))
    first = sorted(drifted["counters"])[0]
    drifted["counters"][first] += 1
    rec = {"counter_signature": drifted, "platform": platform,
           "violations": []}
    tfleet._gate_counters(rec, kind, Args)
    assert rec["baseline_gate"]["ok"] is False
    assert rec["violations"] and first in rec["violations"][0]
    for other in ({"platform": "cpu" if platform != "cpu" else "cuda"},
                  {"n_ranks": sig["n_ranks"] + 1}):
        s2 = dict(sig, n_ranks=other.get("n_ranks", sig["n_ranks"]))
        rec = {"counter_signature": s2,
               "platform": other.get("platform", platform),
               "violations": []}
        tfleet._gate_counters(rec, kind, Args)
        assert "skipped" in rec["baseline_gate"] and not rec["violations"]
