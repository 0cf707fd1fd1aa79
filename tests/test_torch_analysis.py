"""The port's run analysis and baseline gate (telemetry/analyze.py,
telemetry/baselines.py) on the CPU.

``analyze`` reads artifacts and never a device, so both packages' copies
run live here on the same files, and their outputs must be equal: the
diagnosis dict, the report, the stage and explain grades, ``check``'s
problem lists and the CLI's exit codes. The files are the port's own: a
telemetry directory of its join driver over 4 emulated ranks (a uniform
run and a Zipf alpha 1.5 run with the skew sidecar off), a
``stageprofile.json``, an ``explain.json`` and a ``history.jsonl``.

The gate: the port's counters on the JAX package's tables (the generators
at the committed runs' random-bits setting, as in
``tests/test_torch_metrics.py``) pass ``compare`` against the JAX
package's committed ``results/baselines/cpu_mesh_smoke.json`` and
``hier_smoke.json``; the port's daemon smoke over 8 emulated ranks
passes its own ``results/baselines_torch/`` gate.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.telemetry import analyze as janalyze
from distributed_join_tpu.telemetry import baselines as jbaselines
from distributed_join_tpu.utils import generators as jgen
from distributed_join_tpu_torch import telemetry as ttel
from distributed_join_tpu_torch.benchmarks import (
    distributed_join as tdriver,
    load_record,
    report,
    run_guarded,
)
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.telemetry import analyze, baselines
from distributed_join_tpu_torch.telemetry import history as thist

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
JAX_BASELINES = os.path.join(REPO, "results", "baselines")
PORT_BASELINES = os.path.join(REPO, "results", "baselines_torch")
DRIVER = ["--communicator", "emulated", "--n-ranks", "4",
          "--build-table-nrows", "100000", "--probe-table-nrows", "100000",
          "--iterations", "1", "--auto-retry", "2"]


@pytest.fixture(autouse=True)
def _no_leaked_session():
    ttel.finalize()
    yield
    ttel.finalize()


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _drive(d: str, extra) -> dict:
    """One run of the port's join driver through ``run_guarded`` into the
    session directory ``d`` (its record also at ``d/record.json``)."""
    args = tdriver.parse_args([*DRIVER, "--telemetry", d, "--json-output",
                               os.path.join(d, "record.json"), *extra])
    out = {}

    def body(a):
        out["record"] = tdriver.run(a, device="cpu")
        report(out["record"], a.json_output)
        return out["record"]

    assert run_guarded(body, args, "distributed_join") == 0
    return out["record"]


@pytest.fixture(scope="module")
def balanced_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tel_balanced"))
    return d, _drive(d, ["--stage-profile", "2", "--explain"])


@pytest.fixture(scope="module")
def skewed_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tel_zipf"))
    return d, _drive(d, ["--zipf-alpha", "1.5", "--skew-threshold", "0"])


def _both(fn_name, *args):
    return (getattr(analyze, fn_name)(*args),
            getattr(janalyze, fn_name)(*args))


# -- diagnose: the same dict and report from both packages --------------------


@pytest.mark.parametrize("which", ["balanced", "skewed"])
def test_diagnosis_equals_jax_on_the_ports_run(which, balanced_run,
                                               skewed_run):
    d, record = balanced_run if which == "balanced" else skewed_run
    got = analyze.diagnose(analyze.load_run(d, record=record))
    want = janalyze.diagnose(janalyze.load_run(d, record=record))
    assert got == want
    assert analyze.format_report(got) == janalyze.format_report(want)
    skew = got["indicators"]["key_skew"]
    if which == "balanced":
        assert got["status"] == "ok" and got["recommendations"] == []
        assert skew["status"] == "ok"
    else:
        assert skew["status"] == "warn"
        assert skew["counters"]["probe.rows_received"]["gini"] > \
            analyze.SKEW_GINI_WARN
        recs = {r["id"]: r for r in got["recommendations"]}
        assert recs["skew_enable_prpd"]["module"] == "parallel/skew.py"
        assert any("--skew-threshold" in f
                   for f in recs["skew_enable_prpd"]["flags"])
    assert got["signature"] == baselines.counter_signature(record)


def test_driver_diagnose_flag_writes_diagnosis(balanced_run):
    """``--diagnose`` through ``run_guarded``: ``diagnosis.json`` in the
    session directory, from the run's own record (the wire indicator's
    dtypes), passing both packages' ``check``."""
    d = balanced_run[0] + "_diag"
    os.makedirs(d)
    record = _drive(d, ["--diagnose"])
    diag = json.load(open(os.path.join(d, "diagnosis.json")))
    assert diag["schema_version"] == analyze.DIAGNOSIS_SCHEMA_VERSION
    assert diag["signature"]["counters"]["matches"] == \
        record["matches_per_join"]
    wire = diag["indicators"]["wire_efficiency"]
    assert wire["shuffle_mode"] == "padded"
    assert wire["sides"]["build"]["ideal_row_bytes"] == 16
    for check in (analyze.check_file, janalyze.check_file):
        assert check(os.path.join(d, "diagnosis.json")) == []


def test_diagnose_alone_implies_telemetry(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the default directory is ./telemetry
    for argv in (["--diagnose"], ["--stage-profile"]):
        args = tdriver.parse_args(argv)
        assert ttel.configure_from_args(args)
        assert ttel.sink().dir == "telemetry"
        ttel.finalize()


# -- check: the same problem lists --------------------------------------------


def test_check_equals_jax_on_every_artifact(balanced_run, tmp_path):
    d, _ = balanced_run
    analyze.diagnose_run(d)
    names = ["summary.json", "diagnosis.json", "trace.rank0.json",
             "events.rank0.jsonl", "stageprofile.json", "explain.json",
             "record.json"]
    for name in names:
        got, want = _both("check_file", os.path.join(d, name))
        assert got == want, name
        assert got == [] or name == "record.json", (name, got)
    bad = {
        "summary.json": {"rank": 0},
        "stageprofile.bad.json": {"kind": "stageprofile", "stages": {}},
        "explain.json": {"kind": "explain", "plan": {}, "cost": 1},
        "flightrecorder.json": {"kind": "flightrecorder", "records": [{}]},
        "diagnosis.json": {"schema_version": 1},
        "query_stageprofile.json": {"kind": "query_stageprofile",
                                    "order": ["op1"], "operators": {}},
    }
    for name, doc in bad.items():
        path = tmp_path / name
        path.write_text(json.dumps(doc))
        got, want = _both("check_file", str(path))
        assert got == want and got, name
    torn = tmp_path / "events.rank1.jsonl"
    torn.write_text('{"kind": "span", "name": "b", "dur_us\n'
                    '{"kind": "event", "name": "a"}\n')
    got, want = _both("check_file", str(torn))
    assert got == want and got


def test_history_store_checks_and_summarizes_alike(balanced_run, tmp_path):
    d, record = balanced_run
    hist = str(tmp_path / "history.jsonl")
    store = thist.WorkloadHistory(hist)
    for _ in range(2):
        store.append(thist.run_entry(record=record, summary=json.load(
            open(os.path.join(d, "summary.json"))), platform="cpu"))
    store.close()
    got, want = _both("check_file", hist)
    assert got == want == []
    entries = thist.load_history(hist)[0]
    assert entries[0]["stages"] is not None
    assert _cli_rc(["history", hist]) == janalyze.main(["history", hist]) \
        == 0


# -- the grades ---------------------------------------------------------------


def test_stage_and_explain_grades_equal_jax(balanced_run):
    d, record = balanced_run
    prof = json.load(open(os.path.join(d, "stageprofile.json")))
    got, want = _both("grade_stages", prof)
    assert got == want
    assert got["worst_stage"] in ("partition", "shuffle", "join")
    assert record["stage_profile"]["plan_digest"] == prof["plan_digest"]
    explain = json.load(open(os.path.join(d, "explain.json")))
    assert explain["plan"]["signature_digest"] == prof["plan_digest"]
    metrics = baselines._find_metrics(record)
    got, want = _both("grade_explain", explain, metrics, record)
    assert got == want
    assert all(s["match"] for s in got["wire"].values())
    assert got["wall"]["measured_s"] == record["elapsed_per_join_s"]


def _cli_rc(argv) -> int:
    return analyze.main(argv)


def test_cli_exit_codes_equal_jax(balanced_run, skewed_run, tmp_path,
                                  capsys):
    """Every subcommand on the same files: the same exit codes."""
    d, record = balanced_run
    d_skew, _ = skewed_run
    rec_path = os.path.join(d, "record.json")
    prof = os.path.join(d, "stageprofile.json")
    explain = os.path.join(d, "explain.json")
    bdir = {"port": str(tmp_path / "port_bl"), "jax": str(tmp_path / "jbl")}
    mains = {"port": analyze.main, "jax": janalyze.main}

    def both(argv, side_dirs=False):
        rcs = {}
        for side, main in mains.items():
            extra = ["--baseline-dir", bdir[side]] if side_dirs else []
            rcs[side] = main(list(argv) + extra)
        capsys.readouterr()
        assert rcs["port"] == rcs["jax"], (argv, rcs)
        return rcs["port"]

    assert both(["report", d]) == 0
    assert both(["diagnose", d_skew, "--record",
                 os.path.join(d_skew, "record.json")]) == 0
    assert both(["compare", rec_path, "--baseline", "gate", "--write"],
                True) == 0
    assert both(["compare", rec_path, "--baseline", "gate"], True) == 0
    assert both(["compare", d, "--baseline", "gate", "--record", rec_path],
                True) == 0
    assert both(["compare", rec_path, "--baseline", "nope"], True) == 1
    assert both(["compare", os.path.join(d_skew, "record.json"),
                 "--baseline", "gate"], True) == 2
    assert both(["stages", prof]) == 0
    assert both(["stages", prof, "--json"]) == 0
    assert both(["stages", explain]) == 1
    assert both(["explain", explain, "--record", rec_path]) == 0
    assert both(["explain", explain, "--record", rec_path,
                 "--gate-wire-bytes"]) == 0
    assert both(["explain", explain, "--gate-wire-bytes"]) == 1
    assert both(["check", prof, explain]) == 0
    bad = tmp_path / "summary.json"
    bad.write_text("{}")
    assert both(["check", str(bad)]) == 1
    assert both(["tune", d]) == 0
    assert both(["tune", d, "--json"]) == 0


def test_stages_cli_renders_the_grade(balanced_run):
    d, _ = balanced_run
    prof = os.path.join(d, "stageprofile.json")
    r = subprocess.run([sys.executable, "-m",
                        "distributed_join_tpu_torch.telemetry.analyze",
                        "stages", prof], capture_output=True, text=True,
                       env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr
    assert "worst-mispredicted" in r.stdout
    assert "overlap credit" in r.stdout
    r = subprocess.run([sys.executable, "-m",
                        "distributed_join_tpu_torch.telemetry.analyze",
                        "stages", prof, "--json"], capture_output=True,
                       text=True, env=_env(), timeout=120)
    grade = json.loads(r.stdout)
    assert grade["kind"] == "stages_grade" and grade["worst_constants"]


# -- baselines ----------------------------------------------------------------


def test_baseline_path_forms(tmp_path):
    bdir = str(tmp_path)
    for name in ("foo", "foo.json", str(tmp_path / "explicit.json")):
        assert baselines.baseline_path(name, bdir) == \
            jbaselines.baseline_path(name, bdir)
    assert baselines.DEFAULT_BASELINE_DIR == os.path.join(
        "results", "baselines_torch")
    assert baselines.baseline_path("x") == os.path.join(
        "results", "baselines_torch", "x.json")


def test_baseline_roundtrip_and_drift(balanced_run, skewed_run, tmp_path):
    bdir = str(tmp_path / "bl")
    d_bal, rec_bal = balanced_run
    _, rec_skew = skewed_run
    path = baselines.write_baseline("cpu_test", rec_bal, baseline_dir=bdir,
                                    record=rec_bal)
    assert janalyze.check_file(path) == analyze.check_file(path) == []
    base = baselines.load_baseline("cpu_test", bdir)
    assert base["wall_time_s"] is None       # a CPU wall never gates
    assert base["config"]["build_table_nrows"] == 100000
    same = baselines.compare(base, rec_bal, record=rec_bal)
    assert same.ok and not same.drifted and same.wall is None
    drifted = baselines.compare(base, load_record(
        os.path.join(skewed_run[0], "record.json")))
    assert not drifted.ok and "matches" in drifted.drifted
    assert "DRIFT matches" in drifted.format()
    jdrift = jbaselines.compare(base, rec_skew)
    assert jdrift.as_record() == drifted.as_record()
    sig = baselines.counter_signature(rec_bal)
    sig["counters"]["brand.new_counter"] = 1
    fwd = baselines.compare(base, sig, record=rec_bal)
    assert fwd.ok and fwd.extra == ["brand.new_counter"]
    sig2 = baselines.counter_signature(rec_bal)
    del sig2["counters"]["matches"]
    assert not baselines.compare(base, sig2).ok
    with pytest.raises(ValueError, match="no device counters"):
        baselines.write_baseline("x", {"benchmark": "x"}, baseline_dir=bdir)


def test_wall_time_noise_band(balanced_run, tmp_path):
    """JAX ``test_wall_time_noise_band`` on the port's record: a wall
    gates only where both sides carry one, within the band."""
    _, rec = balanced_run
    bdir = str(tmp_path / "bl")
    base = json.load(open(baselines.write_baseline(
        "hw", rec, baseline_dir=bdir, record=rec)))
    base["wall_time_s"] = 1.0
    within = dict(rec, elapsed_per_join_s=1.2)
    beyond = dict(rec, elapsed_per_join_s=1.3)
    assert baselines.compare(base, rec, record=within).ok
    slow = baselines.compare(base, rec, record=beyond)
    assert not slow.ok and slow.signature_ok
    assert slow.wall["regressed"] and "REGRESSED" in slow.format()
    assert baselines.compare(base, rec, record=beyond, noise_band=0.5).ok
    assert slow.as_record() == jbaselines.compare(
        base, rec, record=beyond).as_record()
    with_wall = json.load(open(baselines.write_baseline(
        "hw2", rec, baseline_dir=bdir, record=rec, with_wall=True)))
    assert with_wall["wall_time_s"] == rec["elapsed_per_join_s"]


@pytest.fixture
def committed_bits():
    """JAX's random bits as the committed baselines drew them."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


@pytest.mark.parametrize("name", ["cpu_mesh_smoke", "hier_smoke"])
def test_port_counters_pass_the_committed_jax_baselines(name, committed_bits,
                                                        tmp_path):
    """The port's tape on the JAX package's tables passes ``compare``
    against the JAX package's committed baseline, through the function
    and through both CLIs on a record file."""
    base = baselines.load_baseline(name, JAX_BASELINES)
    cfg = base["config"]
    jb, jp = jgen.generate_build_probe_tables(
        seed=42, build_nrows=cfg["build_table_nrows"],
        probe_nrows=cfg["probe_table_nrows"], selectivity=cfg["selectivity"],
        unique_build_keys=True)
    tb, tp = (Table.from_numpy({c: np.asarray(v) for c, v in t.columns.items()},
                               np.asarray(t.valid), device="cpu")
              for t in (jb, jp))
    n = cfg["n_ranks"]
    if cfg["shuffle"] == "hierarchical":
        comm, opts = EmulatedCommunicator(n, n_slices=2), dict(
            shuffle="hierarchical", dcn_codec="on")
    else:
        comm, opts = EmulatedCommunicator(n), dict(shuffle=cfg["shuffle"])
    res = tdist.distributed_inner_join(tb, tp, comm, with_metrics=True,
                                       **opts)
    cmp = baselines.compare(base, res.telemetry)
    assert cmp.ok, cmp.format()
    assert int(jdist.distributed_inner_join(
        jb, jp, jcomm.make_communicator("tpu", n_ranks=n),
        with_metrics=False).total) == base["signature"]["counters"][
            "matches"]
    rec = tmp_path / "record.json"
    rec.write_text(json.dumps({"benchmark": "distributed_join",
                               "counter_signature":
                                   baselines.counter_signature(
                                       res.telemetry)}))
    for main in (analyze.main, janalyze.main):
        assert main(["compare", str(rec), "--baseline", name,
                     "--baseline-dir", JAX_BASELINES]) == 0


def test_load_record_stamps_v1(tmp_path):
    from distributed_join_tpu.benchmarks import load_record as jload
    p = tmp_path / "old.json"
    p.write_text(json.dumps({"benchmark": "x", "elapsed_per_join_s": 0.5}))
    assert load_record(str(p)) == jload(str(p))
    assert load_record(str(p))["schema_version"] == 1
    assert load_record({"schema_version": 2})["schema_version"] == 2
    arr = tmp_path / "arr.json"
    arr.write_text("[1]")
    with pytest.raises(ValueError, match="not a JSON record object"):
        load_record(str(arr))


# -- the daemon smoke's gate ---------------------------------------------------


def test_smoke_gates_against_the_ports_own_baselines(tmp_path):
    """``--smoke`` over 8 emulated CPU ranks: both counter signatures
    pass the committed ``results/baselines_torch`` files; a doctored
    baseline fails the smoke with rc != 0."""
    argv = [sys.executable, "-m", "distributed_join_tpu_torch.service.server",
            "--smoke", "--device", "cpu", "--communicator", "emulated",
            "--n-ranks", "8", "--smoke-no-wall-gate",
            "--flight-recorder-path", str(tmp_path / "fr.json")]
    out = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                         cwd=str(tmp_path), env=_env())
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("service_smoke", "resident_smoke"):
        assert rec["baseline_gate"][name]["ok"] is True, rec["baseline_gate"]
    assert "not_ported" not in rec and not rec["violations"]
    bl = json.load(open(os.path.join(PORT_BASELINES, "service_smoke.json")))
    assert rec["counter_signature"] == bl["signature"]
    # the JAX package's committed service baseline: the same wire bytes
    # (the byte contract), other matches (the generators' bits differ)
    jbl = baselines.load_baseline("service_smoke", JAX_BASELINES)
    cmp = baselines.compare(jbl, rec["counter_signature"])
    assert set(cmp.drifted) <= {"matches", "build.overflow_margin_min",
                                "probe.overflow_margin_min"}
    assert "build.wire_bytes" not in cmp.drifted
    doctored = tmp_path / "bl"
    doctored.mkdir()
    for name in ("service_smoke", "resident_smoke"):
        doc = json.load(open(os.path.join(PORT_BASELINES, f"{name}.json")))
        if name == "service_smoke":
            doc["signature"]["counters"]["matches"] += 1
        (doctored / f"{name}.json").write_text(json.dumps(doc))
    bad = subprocess.run([*argv, "--smoke-baseline-dir", str(doctored)],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(tmp_path), env=_env())
    assert bad.returncode != 0
    assert "baseline gate service_smoke" in bad.stdout + bad.stderr


def test_committed_port_baselines_pass_check():
    for name in ("service_smoke", "resident_smoke"):
        path = os.path.join(PORT_BASELINES, f"{name}.json")
        assert janalyze.check_file(path) == analyze.check_file(path) == []
        doc = json.load(open(path))
        assert doc["config"] == {"benchmark": name, "n_ranks": 8,
                                 "platform": "cpu"}
        assert doc["wall_time_s"] is None


# -- the launcher --------------------------------------------------------------


def test_launch_forwards_diagnose_and_stage_profile():
    from distributed_join_tpu_torch.benchmarks import launch
    args = launch.parse_args([
        "--num-processes", "2", "--telemetry", "teldir", "--diagnose",
        "--stage-profile", "5", "--", "drv", "--iterations", "1"])
    cmd = args.command
    assert cmd[:3] == ["drv", "--iterations", "1"]
    assert "--diagnose" in cmd
    assert cmd[cmd.index("--stage-profile") + 1] == "5"
    assert not ttel.configure_from_args(
        launch.parse_args(["--num-processes", "2", "--", "drv"]))
    bare = launch.parse_args(["--num-processes", "2", "--stage-profile",
                              "--", "drv", "--stage-profile", "7"])
    assert bare.command.count("--stage-profile") == 1
    assert bare.command[-1] == "7"
