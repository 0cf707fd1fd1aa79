"""PyTorch port vs the JAX package: the watchdog and the guarded run.

The port's ``parallel/watchdog.py`` (``HangError``, ``call_with_deadline``,
``resolve_guard_deadline``, ``shutdown_bounded``) and the drivers'
``benchmarks.run_guarded`` with ``--guard-deadline-s``, held against the
JAX package's on the same calls: the same errors, records, telemetry
events and history entries, with timestamps, thread ids and the
workload's rank count (the JAX package reads its 8 virtual devices, the
port its process group) stripped. Also: the drivers' flags that stay
refused name what they wait for, and the accepted ones parse as the JAX
drivers'.
"""

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from distributed_join_tpu import benchmarks as jbench
from distributed_join_tpu import telemetry as jtel
from distributed_join_tpu.benchmarks import all_to_all as ja2a
from distributed_join_tpu.benchmarks import distributed_join as jdriver
from distributed_join_tpu.benchmarks import tpch_join as jtpch
from distributed_join_tpu.parallel import watchdog as jwd
from distributed_join_tpu.telemetry import history as jhist
from distributed_join_tpu_torch import bench as tbench
from distributed_join_tpu_torch import benchmarks as tbench_mod
from distributed_join_tpu_torch import telemetry as ttel
from distributed_join_tpu_torch.benchmarks import all_to_all as ta2a
from distributed_join_tpu_torch.benchmarks import distributed_join as tdriver
from distributed_join_tpu_torch.benchmarks import launch as tlaunch
from distributed_join_tpu_torch.benchmarks import tpch_join as ttpch
from distributed_join_tpu_torch.parallel import bootstrap as tboot
from distributed_join_tpu_torch.parallel import watchdog as twd
from distributed_join_tpu_torch.telemetry import history as thist

TIME_KEYS = ("ts_us", "dur_us", "ts", "dur", "tid", "epoch_s")


@pytest.fixture(autouse=True)
def _no_leaked_session():
    jtel.finalize()
    ttel.finalize()
    yield
    jtel.finalize()
    ttel.finalize()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in TIME_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- call_with_deadline -------------------------------------------------------


def test_call_with_deadline_times_out():
    release = threading.Event()
    try:
        with pytest.raises(twd.HangError, match="0.2s") as got:
            twd.call_with_deadline(release.wait, 0.2, what="backend init")
        with pytest.raises(jwd.HangError) as want:
            jwd.call_with_deadline(release.wait, 0.2, what="backend init")
    finally:
        release.set()   # un-hang the watchdogs' workers
    assert got.value.record() == want.value.record() == {
        "error": "HangError", "what": "backend init", "deadline_s": 0.2,
        "message": "backend init did not complete within 0.2s"}


def test_call_with_deadline_passes_results_and_errors():
    assert twd.call_with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(KeyError, match="boom"):
        twd.call_with_deadline(lambda: {}["boom"], 5.0)
    # a finished worker is released: no thread is left behind
    before = threading.active_count()
    for _ in range(5):
        twd.call_with_deadline(lambda: None, 5.0)
    time.sleep(0.2)
    assert threading.active_count() <= before + 1


def test_watchdog_events_equal_jax(tmp_path):
    release = threading.Event()
    out = {}
    try:
        for name, tel, wd in (("t", ttel, twd), ("j", jtel, jwd)):
            with tel.session(str(tmp_path / name), rank=0) as sink:
                wd.call_with_deadline(lambda: 1, 5.0, what="fetch")
                with pytest.raises(wd.HangError):
                    wd.call_with_deadline(release.wait, 0.1, what="fetch")
                path = sink.events_path
            out[name] = _events(path)
    finally:
        release.set()
    assert _strip(out["t"]) == _strip(out["j"])
    assert [e["name"] for e in out["t"][1:]] == [
        "watchdog_armed", "watchdog_armed", "watchdog_timeout"]


@pytest.mark.parametrize("flag,env,want", [
    (None, None, None), (None, "120", 120.0), (60.0, "120", 60.0),
    (0.0, "120", None), (None, "0", None), (None, "", None)])
def test_resolve_guard_deadline_flag_env_precedence(monkeypatch, flag, env,
                                                    want):
    if env is None:
        monkeypatch.delenv(twd.ENV_GUARD_DEADLINE, raising=False)
    else:
        monkeypatch.setenv(twd.ENV_GUARD_DEADLINE, env)

    class A:
        guard_deadline_s = flag

    assert twd.ENV_GUARD_DEADLINE == jwd.ENV_GUARD_DEADLINE
    assert twd.resolve_guard_deadline(A()) == jwd.resolve_guard_deadline(
        A()) == want
    assert twd.resolve_guard_deadline(None) == jwd.resolve_guard_deadline(
        None)


def test_shutdown_bounded_detaches_a_wedged_worker(tmp_path):
    release = threading.Event()
    out = {}
    try:
        for name, tel, wd in (("t", ttel, twd), ("j", jtel, jwd)):
            ex = ThreadPoolExecutor(1, thread_name_prefix=f"wedged-{name}")
            ex.submit(release.wait)
            with tel.session(str(tmp_path / name), rank=0) as sink:
                with pytest.warns(UserWarning, match="did not exit"):
                    assert not wd.shutdown_bounded(ex, "out_of_core.stage",
                                                   timeout_s=0.1)
                path = sink.events_path
            out[name] = [e["payload"] for e in _events(path)
                         if e["name"] == "worker_shutdown_timeout"]
            clean = ThreadPoolExecutor(1)
            clean.submit(lambda: None).result()
            assert wd.shutdown_bounded(clean, "out_of_core.fetch")
    finally:
        release.set()
    assert len(out["t"]) == 1
    assert out["t"][0]["thread"].startswith("wedged-t")
    for rec in out.values():
        rec[0].pop("thread")
    assert out["t"] == out["j"]


# -- run_guarded --------------------------------------------------------------


class Exited(Exception):
    pass


def _guard_args(tmp_path, name, deadline, history=True):
    class A:
        telemetry = str(tmp_path / f"tel_{name}")
        trace = False
        diagnose = False
        guard_deadline_s = deadline
        json_output = str(tmp_path / f"{name}.json")
        build_table_nrows = 4096
        shuffle = "ragged"

    A.history = str(tmp_path / f"{name}.jsonl") if history else None
    return A()


def test_guard_hang_exits_1_with_a_hang_record(tmp_path, monkeypatch,
                                               capsys):
    """A run past ``--guard-deadline-s`` prints one HangError record,
    writes it to ``--json-output`` and the history, and exits hard with
    rc 1, as the JAX package's run_guarded does."""
    codes = []

    def fake_exit(code):
        codes.append(code)
        raise Exited(str(code))

    monkeypatch.setattr(os, "_exit", fake_exit)
    release = threading.Event()
    records = {}
    try:
        for name, mod in (("t", tbench_mod), ("j", jbench)):
            args = _guard_args(tmp_path, name, 0.2)
            t0 = time.monotonic()
            with pytest.raises(Exited):
                mod.run_guarded(lambda a: release.wait(30), args,
                                benchmark="demo")
            assert time.monotonic() - t0 < 5.0
            out = capsys.readouterr().out.strip().splitlines()
            records[name] = (json.loads(out[-1]),
                             json.load(open(args.json_output)),
                             jhist.load_history(args.history)[0])
    finally:
        release.set()
    assert codes == [1, 1]
    (rec, written, hist), (jrec, _, jh) = records["t"], records["j"]
    assert rec == written
    assert rec["failure"] == jrec["failure"] == {
        "error": "HangError", "what": "demo run", "deadline_s": 0.2,
        "message": "demo run did not complete within 0.2s"}
    assert rec["error"] == jrec["error"]
    assert "telemetry" in rec and "telemetry" in jrec
    assert hist and all(e["outcome"] == "failed" for e in hist)
    assert "HangError" in hist[0]["error"]
    for e in (hist[0], jh[0]):
        e["workload"].pop("n_ranks", None)
        e.pop("signature")
        e.pop("platform")
    assert hist[0] == jh[0]


def test_guard_bootstrap_outage_exits_0(tmp_path, monkeypatch, capsys):
    codes = []
    monkeypatch.setattr(os, "_exit", lambda code: (codes.append(code),
                                                   (_ for _ in ()).throw(
                                                       Exited())))

    def outage(args):
        raise tboot.BootstrapError("handshake failed", phase="handshake",
                                   deadline_s=1.0, coordinator="h:1")

    with pytest.raises(Exited):
        tbench_mod.run_guarded(outage, _guard_args(tmp_path, "b", None),
                               benchmark="demo")
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert codes == [0]
    assert rec["failure"]["error"] == "BootstrapError"
    assert rec["failure"]["coordinator"] == "h:1"


def test_guard_failure_record_and_reraise(tmp_path, capsys):
    """Any other failure: the one-line record (as JAX's), then the error
    propagates; ``SystemExit`` passes untouched."""
    recs = {}
    for name, mod in (("t", tbench_mod), ("j", jbench)):
        args = _guard_args(tmp_path, name, 0, history=False)
        with pytest.raises(ValueError, match="nope"):
            mod.run_guarded(lambda a: (_ for _ in ()).throw(
                ValueError("nope")), args, benchmark="demo")
        recs[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        with pytest.raises(SystemExit):
            mod.run_guarded(lambda a: (_ for _ in ()).throw(
                SystemExit(3)), args, benchmark="demo")
    for r in recs.values():
        r["failure"].pop("traceback")
        r.pop("telemetry")
    # no field of the port's record waits for another slice any more
    assert "not_ported" not in recs["t"]
    assert recs["t"] == recs["j"]
    assert not ttel.enabled()


def test_guarded_run_returns_0_and_finalizes(tmp_path):
    args = _guard_args(tmp_path, "ok", 30.0)
    seen = {}

    def body(a):
        seen["enabled"] = ttel.enabled()
        return {"benchmark": "demo", "n_ranks": 1,
                "elapsed_per_join_s": 0.5}

    assert tbench_mod.run_guarded(body, args, benchmark="demo") == 0
    assert seen["enabled"] and not ttel.enabled()
    entries, _ = thist.load_history(args.history)
    assert [e["outcome"] for e in entries] == ["ok"]
    assert entries[0]["wall_s"] == 0.5
    assert os.path.exists(os.path.join(args.telemetry, "summary.json"))


# -- the drivers' flags -------------------------------------------------------

DRIVERS = {"distributed_join": (tdriver, jdriver),
           "tpch_join": (ttpch, jtpch), "all_to_all": (ta2a, ja2a)}
STILL_REFUSED = {"--auto-tune": ([], None),
                 "--verify-integrity": ([], None),
                 "--chaos-seed": (["3"], "A7")}
# --auto-tune and --verify-integrity are ported (queue None): every driver
# takes --verify-integrity; the join driver takes --auto-tune, the tpch
# and all_to_all drivers take it and their runs refuse it in the JAX
# drivers' words
AUTO_TUNE_RUN_REFUSAL = {"distributed_join": None,
                         "tpch_join": "does not consult the history store",
                         "all_to_all": "no capacity contract to pre-size"}


@pytest.mark.parametrize("flag", sorted(STILL_REFUSED))
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_drivers_refuse_what_waits_by_name(driver, flag, capsys):
    tmod, jmod = DRIVERS[driver]
    extra, queue = STILL_REFUSED[flag]
    jargs = jmod.parse_args([flag, *extra])   # the JAX driver takes it
    if queue is None:
        targs = tmod.parse_args([flag, *extra])
        if flag == "--verify-integrity":
            # ported: every driver takes the switch, as the JAX drivers do
            assert targs.verify_integrity and jargs.verify_integrity
            return
        assert targs.auto_tune == jargs.auto_tune == ""
        match = AUTO_TUNE_RUN_REFUSAL[driver]
        if match is not None:
            for mod, args in ((jmod, jargs), (tmod, targs)):
                with pytest.raises(SystemExit, match=match):
                    mod.run(args)
        return
    with pytest.raises(SystemExit):
        tmod.parse_args([flag, *extra])
    err = capsys.readouterr().err
    assert flag in err and "not part of the port" in err and queue in err


@pytest.mark.parametrize("flag", sorted(STILL_REFUSED))
def test_launcher_refuses_what_waits_by_name(flag, capsys):
    extra, queue = STILL_REFUSED[flag]
    if queue is None:
        # ported: handed on to every process's command
        args = tlaunch.parse_args(["--num-processes", "2", flag, *extra,
                                   "--", "drv"])
        # a switch goes on bare, a value-taking flag with its value
        assert args.command == (["drv", flag] if flag == "--verify-integrity"
                                else ["drv", flag, ""])
        return
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--num-processes", "2", flag, *extra, "--",
                            "drv"])
    err = capsys.readouterr().err
    assert flag in err and queue in err


TELEMETRY_ARGV = [["--telemetry"], ["--telemetry", "d"], ["--trace"],
                  ["--history", "h.jsonl"], ["--guard-deadline-s", "7.5"],
                  ["--guard-deadline-s", "0"], ["--diagnose"],
                  ["--stage-profile"], ["--stage-profile", "5"]]


@pytest.mark.parametrize("argv", TELEMETRY_ARGV)
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_drivers_take_the_telemetry_flags_as_jax(driver, argv):
    tmod, jmod = DRIVERS[driver]
    t, j = tmod.parse_args(argv), jmod.parse_args(argv)
    for dest in ("telemetry", "trace", "history", "guard_deadline_s",
                 "diagnose", "stage_profile"):
        assert getattr(t, dest) == getattr(j, dest), dest


def test_trace_with_profile_refuses_as_a_pair(capsys):
    for parse in (tdriver.parse_args,
                  lambda a: tbench.main(a)):
        with pytest.raises(SystemExit):
            parse(["--trace", "--profile", "3"])
        assert "--trace with --profile" in capsys.readouterr().err
    assert tdriver.parse_args(["--profile", "3"]).profile == 3
    assert tdriver.parse_args(["--trace"]).trace


def test_launcher_forwards_the_telemetry_and_guard_flags():
    args = tlaunch.parse_args([
        "--num-processes", "2", "--telemetry", "tel", "--trace",
        "--history", "h.jsonl", "--guard-deadline-s", "30", "--", "drv",
        "--history=mine.jsonl"])
    assert args.command == ["drv", "--history=mine.jsonl", "--telemetry",
                            "tel", "--trace", "--guard-deadline-s", "30.0"]
    bare = tlaunch.parse_args(["--num-processes", "2", "--telemetry", "--",
                               "drv"])
    assert bare.command == ["drv", "--telemetry", "telemetry"]
