"""The port's fleet smokes as their CLI runs them, on the CPU:
``python -m distributed_join_tpu_torch.service.fleet --smoke`` and
``--ha-smoke`` with subprocess daemon replicas (``--device cpu``), each
in a process group of its own that the test kills on the way out, so
no replica outlives it.

``--smoke`` is where the disk tier crosses processes: the SIGKILLed
replica's replacement is a fresh process that binds the program its
predecessor persisted in the shared directory (0 new traces, 1 disk
load), and one more replica, started from an empty directory, builds
the program instead. ``--ha-smoke``
rebuilds a killed holder from the manifest and takes over a killed
router. Each record passes the port's ``analyze check``; the
counter-signature baselines are the card's
(``results/baselines_torch``), so the CPU run's gate reports
``skipped``. Counts are exact.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

from distributed_join_tpu_torch.telemetry.analyze import check_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_fleet_cli(tmp_path, *flags, timeout=240):
    """The fleet CLI in a session of its own: (rc, record, stderr)."""
    out = tmp_path / "record.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_join_tpu_torch.service.fleet",
         *flags, "--device", "cpu", "--persist-dir", str(tmp_path / "work"),
         "--json-output", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path), start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        else:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    rec = json.loads(out.read_text()) if out.exists() else None
    return proc.returncode, rec, err


def test_fleet_smoke_cli_replacement_binds_from_disk(tmp_path):
    """The scripted kill: failover within the budget, the replacement
    process serving the repeat from the shared persist dir with no new
    trace, the fresh-dir replica building it, the burst shed, no request
    lost; the record passes ``analyze check``."""
    rc, rec, err = run_fleet_cli(tmp_path, "--smoke", "--replica-ranks", "1")
    assert rc == 0, err[-3000:]
    assert rec["kind"] == "fleet_smoke" and rec["violations"] == []
    sig = rec["counter_signature"]["counters"]
    assert sig["warm_new_traces"] == sig["replacement_new_traces"] == 0
    assert sig["requests_lost"] == 0
    assert sig["matches_cold"] == sig["matches_failover"] \
        == sig["matches_replacement"] == rec["matches_expected"] > 0
    cache = rec["replacement_cache"]
    assert (cache["traces"], cache["disk_loads"],
            cache["disk_load_failures"]) == (0, 1, 0)
    assert rec["cold_replica"]["new_traces"] >= 1
    assert rec["cold_replica"]["cache"]["disk_loads"] == 0
    assert rec["failover_attempts"] == 2
    assert rec["kill_to_serving_s"] >= rec["replaced_after_s"] > 0
    assert rec["platform"] == "cpu" and rec["n_ranks"] == 1
    assert "skipped" in rec["baseline_gate"]
    assert rec["stats"]["replaced_total"] == 1
    path = tmp_path / "fleet_smoke.json"
    path.write_text(json.dumps(rec))
    assert check_file(str(path)) == []


def test_fleet_ha_smoke_cli_rebuild_and_takeover(tmp_path):
    """K = 2: the holder kill fails over and the replacement rebuilds
    from the manifest, warm; the router kill hands the lease to the
    standby, whose resend is served warm at the right generation; the
    post-takeover append reaches both holders."""
    rc, rec, err = run_fleet_cli(tmp_path, "--ha-smoke")
    assert rc == 0, err[-3000:]
    assert rec["kind"] == "fleet_ha_smoke" and rec["violations"] == []
    sig = rec["counter_signature"]["counters"]
    assert (sig["register_holders"], sig["register_generation"],
            sig["append_generation"], sig["append_applied"]) == (2, 1, 2, 2)
    assert sig["rebuilt_replay_new_traces"] == 0
    assert sig["takeover_new_traces"] == 0 and sig["takeovers_total"] == 1
    assert (sig["post_takeover_append_generation"],
            sig["post_takeover_append_applied"]) == (3, 2)
    assert sig["matches_final"] == rec["matches_expected_final"] > \
        sig["matches_cold"] == rec["matches_expected"] > 0
    assert len(rec["rebuild_s"]) == 1 and rec["takeover_s"] > 0
    assert "skipped" in rec["baseline_gate"]
    path = tmp_path / "fleet_ha_smoke.json"
    path.write_text(json.dumps(rec))
    assert check_file(str(path)) == []
    coord = rec["coord_dir"]
    assert check_file(os.path.join(coord, "router_directory.json")) == []


@pytest.mark.parametrize("flag", ["--platform", "--chaos-seed"])
def test_fleet_cli_refusals(flag, tmp_path):
    """``--platform`` refuses by name (the fleet places its replicas by
    ``--device``), and so does any flag the fleet does not know."""
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_join_tpu_torch.service.fleet",
         flag, "cpu"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=str(tmp_path))
    assert proc.returncode == 2 and flag in proc.stderr
