"""The port's tenant and tracing smokes as their CLI runs them, on the
CPU (``--tenant-smoke``, ``--tracing-smoke`` with subprocess daemon
replicas and ``--device cpu``), each in a process group of its own that
the test kills on the way out.

``--tenant-smoke``: two configured tenants, the bronze tenant's QPS
quota refusal and priority shed while gold is served exactly, and the
autoscaler's third replica pre-warm verified with no new trace (its
program bound from the shared persist dir). ``--tracing-smoke``: one
trace id across the router and two replica processes through a
scripted kill, assembled into one timeline that ``analyze check``
accepts. Counts are exact.
"""

import json

from distributed_join_tpu_torch.telemetry.analyze import check_file
from test_torch_fleet_smoke import run_fleet_cli


def test_tenant_smoke_cli_quota_priority_and_warm_autoscale(tmp_path):
    rc, rec, err = run_fleet_cli(tmp_path, "--tenant-smoke",
                                 "--replica-ranks", "1")
    assert rc == 0, err[-3000:]
    assert rec["kind"] == "fleet_tenant_smoke" and rec["violations"] == []
    sig = rec["counter_signature"]["counters"]
    assert sig == {"replicas": 2,
                   "matches_gold_cold": rec["matches_expected"],
                   "matches_gold_warm": rec["matches_expected"],
                   "gold_warm_new_traces": 0, "bronze_quota_refused": 1,
                   "bronze_priority_shed": 1,
                   "gold_served_under_pressure": 1, "autoscale_spawned": 1,
                   "autoscale_warm_verified": 1}
    spawn = [e for e in rec["autoscale"]["events"]
             if e["action"] == "spawn"][0]
    assert spawn["replica"] == 2 and spawn["new_traces"] == 0
    assert rec["tenants"]["gold"].get("shed", 0) == 0
    path = tmp_path / "tenant_smoke.json"
    path.write_text(json.dumps(rec))
    assert check_file(str(path)) == []


def test_tracing_smoke_cli_one_trace_across_the_failover(tmp_path):
    rc, rec, err = run_fleet_cli(tmp_path, "--tracing-smoke",
                                 "--replica-ranks", "1")
    assert rc == 0, err[-3000:]
    assert rec["kind"] == "tracing_smoke" and rec["violations"] == []
    sig = rec["counter_signature"]["counters"]
    assert sig["failover_trace_ids"] == 1
    assert sig["failed_attempt_on_trace"] == 1
    assert sig["timeline_processes"] == 3
    assert sig["focus_trace_processes"] >= 2
    assert sig["warm_new_traces"] == 0
    assert sig["matches_cold"] == sig["matches_warm"] \
        == sig["matches_failover"] > 0
    assert rec["attempt_failed_records"] >= 1
    path = tmp_path / "tracing_smoke.json"
    path.write_text(json.dumps(rec))
    assert check_file(str(path)) == []
