"""The port's fleet chaos soaks (parallel/chaos.py ``--fleet``,
``--fleet-fault``, ``--tenants``) on the CPU: two daemon replicas
(``python -m distributed_join_tpu_torch.service.server --device cpu``)
behind the port's router, one of them faulted mid-soak.

- ``--fleet 4 --fleet-fault kill`` through the CLI, and the corrupt,
  resident-kill and tenant soaks in process: every summary grades 0
  failures and passes the port's ``analyze check`` (its ``fleet_soak``
  and ``fleet_tenant_soak`` validators);
- the hang soak stalls its victim 30 s by design, so here only its
  arming is held: the victim is the replica the port's ``affine_replica``
  picks for trial 0's spec, and its first generation's argv carries
  ``--fault-plan`` with ``dispatch_delay_s`` and ``--guard-deadline-s
  10.0`` (a replacement respawns clean). It runs live on the card.

The victims follow the port's ``affine_replica`` (the port's join-spec
signatures), not the JAX package's index; the draws are the JAX
package's (``tests/test_torch_chaos.py``). Every test carries its own
time limit (``test_torch_chaos.time_limit``).
"""

import json
import os
import signal
import subprocess
import sys

import pytest

from distributed_join_tpu.parallel import chaos as jchaos
from distributed_join_tpu_torch.parallel import chaos as tchaos
from distributed_join_tpu_torch.service import fleet as tfleet
from distributed_join_tpu_torch.telemetry.analyze import check_file
from test_torch_chaos import time_limit

pytestmark = pytest.mark.chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checked(tmp_path, summary: dict) -> dict:
    """The summary as the CLI's ``--json-output`` writes it, through the
    port's ``analyze check``."""
    path = tmp_path / f"{summary['kind']}.json"
    path.write_text(json.dumps(summary))
    assert check_file(str(path)) == []
    return summary


@pytest.fixture
def one_thread(monkeypatch):
    # the replicas inherit it: four torch processes on a few cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@time_limit(100)
def test_fleet_kill_soak_cli(tmp_path):
    """``--fleet 4 --fleet-fault kill --device cpu``: the midpoint trial's
    affine replica is SIGKILLed before its dispatch, the router fails
    over (``recovered``), the victim is drained and replaced, the
    replacement serves a pre-fault signature with zero new traces, and
    the failed attempt shares its trace with the served answer."""
    out = tmp_path / "fleet_soak.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_join_tpu_torch.parallel.chaos",
         "--fleet", "4", "--fleet-fault", "kill", "--seed", "42",
         "--device", "cpu", "--json-output", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path), start_new_session=True,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    try:
        so, se = proc.communicate(timeout=90)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.communicate()
    assert proc.returncode == 0, so[-3000:] + se[-3000:]
    s = json.loads(out.read_text())
    assert check_file(str(out)) == []
    assert s["failures"] == 0 and s["fault"] == "kill" and s["trials"] == 4
    assert s["victim"] == tfleet.affine_replica(
        tchaos._fleet_trial_spec(42, 2), 2, 2)
    assert s["answered"] == 4 and s["device"] == "cpu"
    assert s["drain_replace"]["replaced"]
    assert s["drain_replace"]["drained_within_probe_interval"]
    assert s["post_replacement_new_traces"] == 0
    tc = s["trace_continuity"]
    assert tc["required"] and not tc["broken"]
    assert tc["failed_attempts"] >= 1 or tc["prober_won_race"]


@time_limit(90)
def test_fleet_corrupt_soak(tmp_path, one_thread):
    """The corrupt victim (``--verify-integrity --auto-retry 0``, out of
    the shared persist dir) refuses its corrupted join with
    ``IntegrityError`` through the router (``detected``); every answer
    that comes back is oracle-exact."""
    s = _checked(tmp_path, tchaos.fleet_slice(42, 4, fault="corrupt",
                                              device="cpu"))
    assert s["failures"] == 0 and s["answered"] == 4
    assert s["victim"] == tfleet.affine_replica(
        tchaos._fleet_trial_spec(42, 0), 2, 2)
    assert s["verdicts"].get("detected", 0) >= 1
    assert not s["drain_replace"]["required"]
    for rec in s["records"]:
        if rec["verdict"] == "detected":
            assert "IntegrityError" in rec["error"]


@time_limit(90)
def test_fleet_resident_kill_soak(tmp_path, one_thread):
    """``--fleet-fault resident-kill``: the table's primary holder dies
    mid-soak; every answer equals the numpy oracle over register +
    delta, the replacement rebuilds from the manifest to the directory
    generation and serves a fenced pre-fault replay with zero new
    traces."""
    s = _checked(tmp_path, tchaos.fleet_resident_slice(42, 4,
                                                       device="cpu"))
    assert s["failures"] == 0 and s["trials"] == 4
    assert s["slice"] == "fleet_resident" and s["generation"] >= 1
    assert s["rebuild"]["holder"]["state"] == "serving"
    assert s["rebuild"]["replay"]["new_traces"] == 0
    assert s["rebuild"]["replay"]["generation"] == s["generation"]
    assert s["drain_replace"]["replaced"]


@time_limit(90)
def test_fleet_tenant_soak(tmp_path, one_thread):
    """``--tenants 2``: the noisy tenant is quota-shed, the quiet one
    never; trend keys stay tenant-namespaced; the killed replica is
    replaced and serves a pre-kill quiet signature with zero new
    traces."""
    s = _checked(tmp_path, tchaos.fleet_tenant_slice(42, 2, device="cpu"))
    assert s["failures"] == 0 and s["trials"] == 2
    assert s["quiet"]["shed_responses"] == 0 == s["quiet"]["router_shed"]
    assert s["noisy"]["quota_shed"] >= 1 and s["noisy"]["other"] == 0
    assert s["noisy"]["sent"] == 20
    assert s["drain_replace"]["replaced"]
    assert s["post_replacement_new_traces"] == 0
    assert s["autoscale"]["enabled"]


@pytest.mark.parametrize("seed", [42, 7])
@time_limit(30)
def test_fleet_hang_and_corrupt_arming(seed, tmp_path, monkeypatch):
    """What the hang and corrupt soaks arm, without running a fleet: the
    fault draw and the corrupt mode are the JAX package's
    (``_trial_rng(seed, 555_000)``), the victim is the port's affine
    replica for trial 0's spec, and only the victim's first generation
    carries the fault."""
    argvs = {}

    class Recorder:
        def __init__(self, argv, spawn_timeout_s=None, env=None):
            argvs[len(argvs)] = list(argv)

    monkeypatch.setattr(tfleet, "ProcessReplica", Recorder)
    work = str(tmp_path)
    jrng = jchaos._trial_rng(seed, 555_000)
    want_fault = jrng.choice(("kill", "hang", "corrupt"))
    assert tchaos.fleet_arming(seed, 8, None, 2, work)[0] == want_fault

    fault, victim, overrides = tchaos.fleet_arming(seed, 8, "hang", 2, work)
    assert fault == "hang"
    assert victim == tfleet.affine_replica(tchaos._fleet_trial_spec(seed, 0),
                                           2, 2)
    cfg = tchaos._fleet_config(work, 2)
    factory = tfleet.process_fleet_factory(cfg, device="cpu",
                                           replica_overrides=overrides)
    factory(victim, 0)
    factory(1 - victim, 0)
    factory(victim, 1)
    hung, sibling, respawn = argvs[0], argvs[1], argvs[2]
    plan = json.loads(hung[hung.index("--fault-plan") + 1])
    assert plan == {"seed": seed % (1 << 16), "dispatch_delay_s": 30.0,
                    "delay_after_dispatches": 3}
    assert hung[hung.index("--guard-deadline-s") + 1] == "10.0"
    assert hung[hung.index("--device") + 1] == "cpu"
    assert hung[hung.index("--flight-recorder-path") + 1].endswith(
        f"replica{victim}_fr.json")
    for argv in (sibling, respawn):
        assert "--fault-plan" not in argv
        assert "--guard-deadline-s" not in argv

    _, cvictim, cover = tchaos.fleet_arming(seed, 8, "corrupt", 2, work)
    jrng = jchaos._trial_rng(seed, 555_000)
    assert cover[cvictim]["fault_plan"] == {
        "seed": seed % (1 << 16), "corrupt_mode": jrng.choice(
            jchaos.CORRUPTION_MODES), "corrupt_collectives": 1}
    assert cover[cvictim]["persist"] is False
    assert cover[cvictim]["extra_args"][-3:] == ["--verify-integrity",
                                                 "--auto-retry", "0"]
    _, kvictim, kover = tchaos.fleet_arming(seed, 8, "kill", 2, work)
    assert kvictim == tfleet.affine_replica(
        tchaos._fleet_trial_spec(seed, 4), 2, 2)
    assert all("fault_plan" not in o for o in kover.values())
