"""The port's recorded collective schedules
(distributed_join_tpu_torch/analysis/schedule.py): the fourteen key
programs over eight emulated ranks against the committed goldens in
results/schedules_torch/, against the JAX package's goldens in
results/schedules/ where the two packages issue the same calls, and the
checks' own failure modes (a reordered, added or missing golden, a
divergent rank, telemetry in a telemetry-off program)."""

import json
import os

import pytest

from distributed_join_tpu_torch.analysis import lint as cli
from distributed_join_tpu_torch.analysis import schedule as S

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE_DIR = os.path.join(REPO, S.DEFAULT_SCHEDULE_DIR)
JAX_SCHEDULE_DIR = os.path.join(REPO, S.JAX_SCHEDULE_DIR)
PROGRAMS = sorted(
    f[:-len(".json")] for f in os.listdir(JAX_SCHEDULE_DIR)
    if f.endswith(".json"))


@pytest.fixture(scope="module")
def recorded():
    """Every key program recorded once for the module (CPU, 8 ranks)."""
    return {name: S.record_program(name, prog)
            for name, prog in S.key_programs("cpu").items()}


def test_the_fourteen_programs_of_the_jax_package(recorded):
    assert len(PROGRAMS) == 14
    assert sorted(recorded) == PROGRAMS
    assert sorted(f[:-5] for f in os.listdir(SCHEDULE_DIR)
                  if f.endswith(".json")) == PROGRAMS


@pytest.mark.parametrize("name", PROGRAMS)
def test_recorded_program_equals_the_port_golden(recorded, name):
    sched = recorded[name]
    assert S.check_program(sched, SCHEDULE_DIR) == []
    assert sched.collectives, "a program with no cross-rank call"


@pytest.mark.parametrize("name", PROGRAMS)
def test_every_rank_issues_one_sequence(recorded, name):
    seqs = recorded[name].rank_sequences
    assert sorted(seqs) == list(range(S.N_RANKS))
    assert all(seqs[r] == seqs[0] for r in seqs)


@pytest.mark.parametrize("name", PROGRAMS)
def test_against_the_jax_golden(recorded, name):
    want = json.load(open(os.path.join(JAX_SCHEDULE_DIR, f"{name}.json")))
    got = recorded[name]
    assert got.n_ranks == want["n_ranks"]
    assert got.telemetry_off == want["telemetry_off"]
    if name in S.JAX_DIFFERENCES:
        # the wire is split into other calls than the JAX primitives:
        # the listed reason, and the same settle (the two psums) at the
        # end
        assert got.collectives != want["collectives"]
        assert got.collectives[-2:] == want["collectives"][-2:] == [
            "psum", "psum"]
    else:
        assert got.collectives == want["collectives"]


def test_the_listed_differences_and_their_reasons():
    assert sorted(S.JAX_DIFFERENCES) == [
        "join_step_hier_2x4", "join_step_ppermute", "join_step_ragged"]
    for reason in S.JAX_DIFFERENCES.values():
        assert len(reason) > 60


def test_metrics_program_adds_exactly_one_gather(recorded):
    off = recorded["join_step_padded"].collectives
    on = recorded["join_step_metrics"].collectives
    assert on.count("all_gather") == off.count("all_gather") + 1
    assert [c for c in on if c != "all_gather"] == off


def test_telemetry_off_programs_record_no_telemetry(recorded):
    for name, sched in recorded.items():
        if sched.telemetry_off:
            assert sched.telemetry == {"tapes": 0}, name
    assert recorded["join_step_metrics"].telemetry["tapes"] > 0


def test_reordered_golden_fails(recorded, tmp_path):
    sched = recorded["join_step_padded"]
    path = S.write_golden(sched, str(tmp_path))
    golden = json.load(open(path))
    golden["collectives"] = list(reversed(golden["collectives"]))
    json.dump(golden, open(path, "w"))
    violations = S.check_program(sched, str(tmp_path))
    assert any("drifted" in v and "join_step_padded" in v
               for v in violations), violations


def test_added_call_fails(recorded, tmp_path):
    sched = recorded["join_step_ragged"]
    path = S.write_golden(sched, str(tmp_path))
    golden = json.load(open(path))
    golden["collectives"] = golden["collectives"][:-1]
    json.dump(golden, open(path, "w"))
    violations = S.check_program(sched, str(tmp_path))
    assert any("added" in v for v in violations), violations


def test_missing_golden_fails(recorded, tmp_path):
    violations = S.check_program(recorded["join_step_skew"], str(tmp_path))
    assert any("no committed golden" in v for v in violations)


def test_divergent_rank_fails(recorded):
    sched = recorded["join_step_padded"]
    seqs = {r: list(s) for r, s in sched.rank_sequences.items()}
    seqs[3] = seqs[3][:-1]
    bad = S.ProgramSchedule(sched.program, sched.n_ranks, True,
                            sched.collectives, seqs, sched.telemetry)
    violations = S.invariant_violations(bad)
    assert any("rank 3" in v and "SPMD divergence" in v
               for v in violations), violations


def test_telemetry_in_a_telemetry_off_program_fails(tmp_path):
    """A metrics step run as if it were a telemetry-off program: the
    tapes it builds fail the invariant, even against a regenerated
    golden."""
    progs = S.key_programs("cpu")
    prog = progs["join_step_metrics"]
    fake = {"join_step_padded": S.Program(prog.run, telemetry_off=True)}
    sched = S.record_program("join_step_padded", fake["join_step_padded"])
    assert sched.telemetry["tapes"] > 0
    assert any("TELEMETRY-OFF" in v for v in S.check_program(
        sched, SCHEDULE_DIR))
    vs, _ = S.check_schedules(schedule_dir=str(tmp_path), update=True,
                              programs=fake)
    assert any("TELEMETRY-OFF" in v for v in vs), vs


def test_update_roundtrip_reproduces_committed(recorded, tmp_path):
    for name, sched in recorded.items():
        fresh = open(S.write_golden(sched, str(tmp_path))).read()
        committed = open(os.path.join(SCHEDULE_DIR, f"{name}.json")).read()
        assert fresh == committed, f"{name} golden is stale"


def test_cli_schedules_exit_codes(tmp_path, capsys):
    assert cli.main(["--update-schedules", "--schedule-dir",
                     str(tmp_path)]) == 0
    for name in PROGRAMS:
        assert open(tmp_path / f"{name}.json").read() == open(
            os.path.join(SCHEDULE_DIR, f"{name}.json")).read()
    path = tmp_path / "join_step_anti.json"
    golden = json.load(open(path))
    golden["collectives"].insert(0, "barrier")
    json.dump(golden, open(path, "w"))
    assert cli.main(["--schedules-only", "--schedule-dir",
                     str(tmp_path)]) == 1
    assert "join_step_anti" in capsys.readouterr().out
    assert cli.main(["--update-schedules", "--rules-only"]) == 2
