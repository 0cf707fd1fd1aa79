"""The port's chaos soak (parallel/chaos.py) and the drivers'
``--chaos-seed`` on the CPU.

The JAX package's soak bodies do not run on this toolchain (its
integrity programs raise shard_map's ``out_specs`` replication error,
so every live JAX trial grades ``FAILED:crash``), but its draws are
plain Python and do. So:

- every draw is held bit for bit against the live JAX functions: the
  fault plans (``random_fault_plan``, ``fault_label``, ``_plan_record``)
  over ``_trial_rng`` on a grid of seeds and trials, with and without
  corruption and dispatch failures; ``run_trial``'s, ``run_hier_trial``'s
  and ``run_tuner_trial``'s ``config``/``fault``/``fault_plan`` (the
  JAX bodies stubbed, or failing before they run); the fleet and
  resident specs; the ``--chaos-seed`` plans for seeds 0-15;
- ``_grade_result`` against JAX's on the same numpy columns, and the
  numpy oracle against the JAX package's pandas merge;
- the verdicts against the written expectations of
  ``tests/test_chaos.py``, ``tests/test_hierarchy.py`` and
  ``tests/test_tuner.py``: ``soak(42, 4)`` grades 0 failures over the
  four config families, the repro contract, the crash verdict, the
  CLI's exit codes, the replay of ``--trial K``, 2 hierarchical trials
  and the poisoned-history tuner slice clean;
- the drivers: ``--chaos-seed`` on every driver and through the
  launcher once, a chaos-seeded join never reporting another row digest
  than the clean run's, and ``--expand-kernel``'s modes giving equal
  digests.

Every test carries its own time limit (``time_limit``).
"""

import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.parallel import chaos as jchaos
from distributed_join_tpu_torch.benchmarks import (
    collect_integrity,
    maybe_chaos_communicator,
)
from distributed_join_tpu_torch.parallel import chaos as tchaos
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
)
from distributed_join_tpu_torch.parallel.faults import (
    CORRUPTION_MODES,
    FaultInjectingCommunicator,
    FaultPlan,
)
from distributed_join_tpu_torch.parallel.integrity import IntegrityError
from distributed_join_tpu_torch.parallel.watchdog import call_with_deadline
from distributed_join_tpu_torch.utils.generators import (
    generate_build_probe_tables,
)

pytestmark = pytest.mark.chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_limit(seconds: float):
    """Fail the test past ``seconds``: a ``SIGALRM`` timer on the main
    thread (pandas on pyarrow strings crashes outside it), else the
    port's watchdog (``HangError``)."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if threading.current_thread() is not threading.main_thread():
                return call_with_deadline(lambda: fn(*args, **kwargs),
                                          seconds, what=fn.__name__)

            def expire(signum, frame):
                raise TimeoutError(
                    f"{fn.__name__} ran past its {seconds} s limit")

            old = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return run
    return deco


def _plan(plan) -> dict:
    return dataclasses.asdict(plan)


# -- the draws, bit for bit against the JAX functions ----------------------


@pytest.mark.parametrize("corruption", [True, False])
@pytest.mark.parametrize("dispatch_failures", [True, False])
@time_limit(30)
def test_fault_plan_draws_equal_jax(corruption, dispatch_failures):
    for seed in (0, 1, 7, 9, 11, 42, 123, 65535):
        for trial in range(40):
            kw = dict(corruption=corruption,
                      dispatch_failures=dispatch_failures)
            want = jchaos.random_fault_plan(jchaos._trial_rng(seed, trial),
                                            **kw)
            got = tchaos.random_fault_plan(tchaos._trial_rng(seed, trial),
                                           **kw)
            assert _plan(got) == _plan(want), (seed, trial)
            assert tchaos.fault_label(got) == jchaos.fault_label(want)
            assert tchaos._plan_record(got) == jchaos._plan_record(want)
    # drop_dispatches: () survives the record's filter, as in JAX
    assert tchaos._plan_record(FaultPlan(seed=3)) == {
        "seed": 3, "drop_dispatches": ()}
    assert tchaos.fault_label(FaultPlan(fail_after_dispatches=0)) == \
        "transient_dispatch"


def _stub_bodies(monkeypatch):
    monkeypatch.setattr(jchaos, "_run_trial_body",
                        lambda c, p, n: jchaos.TrialOutcome("ok"))
    monkeypatch.setattr(tchaos, "_run_trial_body",
                        lambda c, p, n, d: tchaos.TrialOutcome("ok"))
    monkeypatch.setattr(jchaos, "_run_hier_trial_body",
                        lambda c, p, n: jchaos.TrialOutcome("ok"))
    monkeypatch.setattr(tchaos, "_run_hier_trial_body",
                        lambda c, p, n, d: tchaos.TrialOutcome("ok"))


DRAWN = ("config", "fault", "fault_plan")


@pytest.mark.parametrize("corruption", [True, False])
@time_limit(60)
def test_run_trial_draws_equal_jax(corruption, monkeypatch):
    _stub_bodies(monkeypatch)
    for seed in (0, 42, 123):
        for k in range(24):
            want = jchaos.run_trial(seed, k, corruption=corruption,
                                    deadline_s=None)
            got = tchaos.run_trial(seed, k, corruption=corruption,
                                   deadline_s=None, device="cpu")
            assert {f: got[f] for f in DRAWN} == {f: want[f] for f in DRAWN}
            assert got["verdict"] == want["verdict"] == "ok"
            assert got["device"] == "cpu"


@time_limit(30)
def test_seed_42_draws_every_family_and_fault(monkeypatch):
    """Seed 42's first 20 main-soak trials: every config family and every
    fault kind, in the JAX package's counts; trial 0 as JAX draws it."""
    _stub_bodies(monkeypatch)
    recs = [tchaos.run_trial(42, k, deadline_s=None, device="cpu")
            for k in range(20)]
    hist = {}
    for r in recs:
        hist[r["fault"]] = hist.get(r["fault"], 0) + 1
    assert hist == {"none": 4, "bit_flip": 3, "row_duplicate": 3,
                    "misroute": 3, "transient_dispatch": 3, "overflow": 3,
                    "row_truncate": 1}
    assert {r["config"]["mode"] for r in recs} == set(tchaos.CONFIGS)
    assert recs[0]["config"] == {
        "mode": "padded", "build_rows": 1024, "probe_rows": 2048,
        "rand_max": 5000, "selectivity": 0.3, "table_seed": 19912,
        "auto_retry": 2}
    assert recs[0]["fault_plan"] == {
        "seed": 65500, "drop_dispatches": (), "corrupt_mode": "bit_flip",
        "corrupt_collectives": 1}


@time_limit(30)
def test_hier_trial_draws_equal_jax(monkeypatch):
    _stub_bodies(monkeypatch)
    for seed in (0, 42, 99):
        for k in range(12):
            for n in (8, 6, 4, 3):
                want = jchaos.run_hier_trial(seed, k, n_ranks=n,
                                             deadline_s=None)
                got = tchaos.run_hier_trial(seed, k, n_ranks=n,
                                            deadline_s=None, device="cpu")
                assert {f: got[f] for f in DRAWN} == \
                    {f: want[f] for f in DRAWN}


@time_limit(60)
def test_tuner_trial_draws_equal_jax(monkeypatch):
    """The JAX tuner body is inline: both bodies fail at their first step
    (the table generator), so each records its draws and a crash."""
    from distributed_join_tpu.utils import generators as jgen

    def boom(*a, **k):
        raise ValueError("stubbed generator")

    monkeypatch.setattr(jgen, "generate_build_probe_tables", boom)
    monkeypatch.setattr(tchaos, "_tables", boom)
    for seed in (7, 42):
        for k in range(9):
            want = jchaos.run_tuner_trial(seed, k, deadline_s=None)
            got = tchaos.run_tuner_trial(seed, k, deadline_s=None,
                                         device="cpu")
            assert {f: got[f] for f in DRAWN} == {f: want[f] for f in DRAWN}
            assert got["poisoned_history"] and want["poisoned_history"]
            assert got["verdict"] == want["verdict"] == "FAILED:crash"
            assert "tuner_presized" not in got


@time_limit(30)
def test_fleet_and_resident_specs_equal_jax():
    for seed in (0, 42, 1234, 65537):
        for k in range(16):
            assert tchaos._fleet_trial_spec(seed, k) == \
                jchaos._fleet_trial_spec(seed, k)
            assert tchaos._resident_trial_spec(seed, k, "t") == \
                jchaos._resident_trial_spec(seed, k, "t")
    assert tchaos.poisoned_history_entry("abc", rung=2) == \
        jchaos.poisoned_history_entry("abc", rung=2)


@time_limit(30)
def test_chaos_seed_plans_equal_jax():
    """``--chaos-seed`` 0-15: the wrapped communicator's plan is the JAX
    package's draw (3 none, 7 overflow at 1 program, 2 misroute, 0 a
    bit flip on 2 collectives)."""
    comm = EmulatedCommunicator(2)
    for seed in range(16):
        want = jchaos.random_fault_plan(jchaos._trial_rng(seed, 0),
                                        dispatch_failures=False)
        wrapped = tchaos.wrap_communicator(comm, seed)
        assert isinstance(wrapped, FaultInjectingCommunicator)
        assert _plan(wrapped.plan) == _plan(want), seed
        args = type("A", (), {"chaos_seed": seed})()
        assert _plan(maybe_chaos_communicator(comm, args).plan) == \
            _plan(want)
    label = {s: tchaos.fault_label(tchaos.wrap_communicator(comm, s).plan)
             for s in (0, 2, 3, 7)}
    assert label == {0: "bit_flip", 2: "misroute", 3: "none",
                     7: "overflow"}
    assert tchaos.wrap_communicator(comm, 7).plan.overflow_programs == 1
    assert tchaos.wrap_communicator(comm, 0).plan.corrupt_collectives == 2
    plan = FaultPlan(seed=1, overflow_programs=1)
    assert tchaos.wrap_communicator(comm, 0, plan).plan is plan


# -- grading and the oracle ------------------------------------------------


def _cols(seed=3, n=64):
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, 1 << 40, n, dtype=np.int64),
            "build_payload": rng.integers(-9, 9, n, dtype=np.int64),
            "probe_payload": rng.integers(0, 1 << 20, n, dtype=np.int64)}


@pytest.mark.parametrize("case", ["clean", "permuted", "flipped", "short",
                                  "total"])
@pytest.mark.parametrize("corrupting", [True, False])
@pytest.mark.parametrize("retries", [0, 2])
@time_limit(30)
def test_grade_result_equals_jax(case, corrupting, retries):
    oracle = _cols()
    got = {k: v.copy() for k, v in oracle.items()}
    total = 64
    if case == "permuted":
        perm = np.random.default_rng(5).permutation(64)
        got = {k: v[perm] for k, v in got.items()}
    elif case == "flipped":
        got["build_payload"][17] ^= 1 << 3
    elif case == "short":
        got = {k: v[:-1] for k, v in got.items()}
        total = 63
    elif case == "total":
        total = 65
    want = jchaos._grade_result(got, total, oracle, 64, corrupting, retries)
    have = tchaos._grade_result(got, total, oracle, 64, corrupting, retries)
    assert dataclasses.asdict(have) == dataclasses.asdict(want)
    assert have.failed == want.failed == (case not in ("clean",
                                                       "permuted"))


class _Frame:
    """A stand-in for a JAX table: what ``_oracle_frame`` reads."""

    def __init__(self, cols):
        self.cols = cols

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self.cols)


@pytest.mark.parametrize("seed", [0, 19912, 42650])
@time_limit(30)
def test_numpy_oracle_equals_the_pandas_merge(seed):
    b, p = generate_build_probe_tables(seed=seed, build_nrows=1024,
                                       probe_nrows=2048, rand_max=256,
                                       selectivity=0.5, device="cpu")
    cols, total = tchaos._oracle(b, p)
    frame = jchaos._oracle_frame(_Frame(tchaos._host_columns(b)),
                                 _Frame(tchaos._host_columns(p)))
    want = jchaos._frame_columns(frame, list(tchaos._OUT_NAMES))
    assert total == len(frame)
    assert tchaos._content_digest(cols) == jchaos._content_digest(want)


# -- the soak's verdicts, against the JAX tests' written expectations ------


@time_limit(100)
def test_soak_slice_survives_and_grades():
    """Four trials (one a config family) on the CPU: no FAILED verdict,
    every record carries its replay identity, the histogram accounts
    for every trial (JAX ``tests/test_chaos.py:175-188``)."""
    summary = tchaos.soak(42, 4, repro_out=None, device="cpu")
    assert summary["failures"] == 0 and summary["trials"] == 4
    assert sum(summary["verdicts"].values()) == 4
    assert summary["device"] == "cpu"
    assert [r["config"]["mode"] for r in summary["records"]] == \
        list(tchaos.CONFIGS)
    for rec in summary["records"]:
        assert rec["verdict"] in ("ok", "recovered", "detected")
        json.dumps(rec)


@time_limit(60)
def test_run_trial_is_deterministic_and_replays():
    """The same (seed, trial) on one device type draws and grades the
    same; ``--trial K`` replays trial K of the seed."""
    for k in (0, 3):
        r1 = tchaos.run_trial(123, k, deadline_s=None, device="cpu")
        r2 = tchaos.run_trial(123, k, deadline_s=None, device="cpu")
        for f in (*DRAWN, "verdict", "expected_total", "got_total"):
            assert r1[f] == r2[f], f
        replay = tchaos.soak(123, 1, only_trial=k, device="cpu",
                             repro_out=None)
        (rec,) = replay["records"]
        assert rec["trial"] == k
        for f in (*DRAWN, "verdict", "expected_total", "got_total"):
            assert rec[f] == r1[f], f


@time_limit(30)
def test_failed_trial_writes_minimal_repro(tmp_path, monkeypatch):
    """The repro contract: seed, trial, config, plan, device and the
    replay command naming the port's module and the device."""
    def fake_run_trial(seed, trial, **kw):
        return {"trial": trial, "config": {"mode": "padded"},
                "fault": "bit_flip", "fault_plan": {"seed": 1},
                "device": kw["device"].type,
                "verdict": "FAILED:silent_corruption",
                "error": None, "expected_total": 1, "got_total": 2,
                "retries": 0, "elapsed_s": 0.0}

    monkeypatch.setattr(tchaos, "run_trial", fake_run_trial)
    out = str(tmp_path / "repro.json")
    summary = tchaos.soak(7, 1, repro_out=out, device="cpu")
    assert summary["failures"] == 1
    repro = json.load(open(tmp_path / "repro_7_0.json"))
    assert repro["harness_seed"] == 7 and repro["device"] == "cpu"
    assert "--seed 7 --trial 0" in repro["replay"]
    assert "distributed_join_tpu_torch.parallel.chaos" in repro["replay"]
    assert "--device cpu" in repro["replay"]
    assert repro["verdict"] == "FAILED:silent_corruption"


@time_limit(30)
def test_unstructured_trial_error_grades_as_crash(monkeypatch):
    """An exception the body did not convert to a structured refusal is a
    FAILED:crash verdict, never a soak abort, and the soak exits 1."""
    def boom(config, plan, n_ranks, device):
        raise ValueError("unexpected")

    monkeypatch.setattr(tchaos, "_run_trial_body", boom)
    rec = tchaos.run_trial(5, 1, deadline_s=None, device="cpu")
    assert rec["verdict"] == "FAILED:crash" and "ValueError" in rec["error"]
    assert tchaos.main(["--trials", "2", "--device", "cpu",
                        "--repro-out", ""]) == 1


@time_limit(30)
def test_chaos_cli_rejects_bad_usage_and_never_falls_back(monkeypatch,
                                                          capsys):
    assert tchaos.main(["--trials", "0", "--device", "cpu"]) == 2
    assert tchaos.main(["--n-ranks", "1", "--device", "cpu"]) == 2
    # no GPU and no --device cpu: refused before any trial runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tchaos.main(["--trials", "1"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    for fn in (lambda: tchaos.soak(42, 1),
               lambda: tchaos.run_trial(42, 0),
               lambda: tchaos.hier_slice(42, 1),
               lambda: tchaos.tuner_slice(42, 1),
               lambda: tchaos.fleet_slice(42, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


@time_limit(110)
def test_chaos_cli_on_the_cpu(tmp_path):
    """``python -m distributed_join_tpu_torch.parallel.chaos --device cpu
    --trials 4 --seed 42`` exits 0 with 0 failures, and its summary
    line and file agree."""
    out = tmp_path / "soak.json"
    r = subprocess.run(
        [sys.executable, "-m", "distributed_join_tpu_torch.parallel.chaos",
         "--device", "cpu", "--trials", "4", "--seed", "42",
         "--json-output", str(out)],
        capture_output=True, text=True, timeout=100, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["failures"] == 0 and line["trials"] == 4
    assert line["device"] == "cpu" and "records" not in line
    assert len(json.loads(out.read_text())["records"]) == 4


@time_limit(60)
def test_chaos_hier_slice_fixed_seed():
    """Two hierarchical trials (JAX ``tests/test_hierarchy.py:386``):
    never a FAILED verdict."""
    summary = tchaos.hier_slice(42, 2, n_ranks=8, device="cpu",
                                deadline_s=240.0)
    assert summary["failures"] == 0, summary
    for rec in summary["records"]:
        assert not rec["verdict"].startswith("FAILED"), rec
        assert rec["config"]["n_slices"] in (2, 4)


@time_limit(60)
def test_poisoned_history_chaos_slice_grades_clean():
    """JAX ``tests/test_tuner.py:307``: a history claiming a too-small
    rung still yields oracle-exact rows through the ladder, and the
    post-run store records the escalated rung."""
    summary = tchaos.tuner_slice(seed=7, trials=2, device="cpu")
    assert summary["failures"] == 0, summary
    for rec in summary["records"]:
        assert rec["verdict"] in ("ok", "recovered"), rec
        assert rec["tuner_presized"] and rec["tuner_corrected"], rec


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
@time_limit(60)
def test_every_corruption_mode_is_detected_or_recovered(mode):
    """One verified join a corruption mode on the padded and ragged
    wires: detected or recovered, never silently joined (the grading a
    chaos-seeded trial gets)."""
    config = {"build_rows": 1024, "probe_rows": 2048, "rand_max": 700,
              "selectivity": 0.5, "table_seed": 11, "auto_retry": 2}
    for shuffle in ("padded", "ragged"):
        plan = FaultPlan(seed=5, corrupt_mode=mode, corrupt_collectives=1,
                         corrupt_rank=1)
        b, p = tchaos._tables(config, "cpu")
        cols, total = tchaos._oracle(b, p)
        comm = FaultInjectingCommunicator(EmulatedCommunicator(4), plan)
        out = tchaos._graded_join(
            b, p, comm, config,
            dict(out_capacity_factor=3.0, shuffle_capacity_factor=3.0,
                 shuffle=shuffle), cols, total, True,
            tchaos._loud(True, total))
        assert out.verdict in ("detected", "recovered", "ok"), out
        assert comm._corruptions == 1


# -- the drivers ---------------------------------------------------------


@time_limit(30)
def test_chaos_seed_parses_on_every_driver_and_forwards_once():
    """JAX ``tests/test_chaos.py:308-319`` and ``tests/test_analysis.py:
    413-440``: the robustness flags parse on every driver; the launcher
    hands ``--chaos-seed`` on once (a flag the command carries wins)."""
    from distributed_join_tpu_torch.benchmarks import (
        all_to_all,
        distributed_join,
        launch,
        tpch_join,
    )
    from distributed_join_tpu_torch.service import server

    for mod in (distributed_join, tpch_join, all_to_all, server):
        args = mod.parse_args(["--verify-integrity", "--chaos-seed", "3",
                               "--guard-deadline-s", "900"])
        assert args.verify_integrity is True
        assert args.chaos_seed == 3
        assert args.guard_deadline_s == 900.0
    args = launch.parse_args([
        "--num-processes", "2", "--verify-integrity",
        "--chaos-seed", "7", "--guard-deadline-s", "30",
        "--", "drv", "--iterations", "1"])
    cmd = args.command
    assert "--verify-integrity" in cmd
    assert cmd[cmd.index("--chaos-seed") + 1] == "7"
    assert cmd[cmd.index("--guard-deadline-s") + 1] == "30.0"
    args2 = launch.parse_args(["--num-processes", "2", "--chaos-seed", "7",
                               "--", "drv", "--chaos-seed", "9"])
    assert args2.command.count("--chaos-seed") == 1
    assert "7" not in args2.command


JOIN_ARGV = ["--communicator", "emulated", "--n-ranks", "4",
             "--build-table-nrows", "40000", "--probe-table-nrows",
             "40000", "--iterations", "1", "--verify-integrity",
             "--auto-retry", "1"]


@pytest.fixture(scope="module")
def clean_join_record():
    from distributed_join_tpu_torch.benchmarks import distributed_join as d
    return d.run(d.parse_args(JOIN_ARGV), device="cpu")


@pytest.mark.parametrize("seed", [3, 7, 2, 0])
@time_limit(60)
def test_chaos_seeded_join_driver_never_reports_another_digest(
        seed, clean_join_record):
    """``--chaos-seed N --verify-integrity`` on the join driver: a run
    either refuses with ``IntegrityError`` or reports the clean run's row
    digest, never a record with another one. Seed 3 draws no fault;
    seed 7's one overflowed program is the timed loop's (whose output is
    no JoinResult, as in the JAX package), so the run matches the clean
    one; seed 2 misroutes rows and seed 0 flips two bits."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as d

    clean = clean_join_record
    assert clean["row_digest"] is not None and clean["chaos_seed"] is None
    try:
        rec = d.run(d.parse_args(JOIN_ARGV + ["--chaos-seed", str(seed)]),
                    device="cpu")
    except IntegrityError:
        assert seed in (2, 0), seed
        return
    assert rec["chaos_seed"] == seed
    assert rec["communicator"] == "faulty(emulated)"
    assert rec["row_digest"] == clean["row_digest"]
    assert rec["matches_per_join"] == clean["matches_per_join"]
    if seed == 3:
        assert rec["integrity"]["ok"]


@pytest.mark.parametrize("flag", ["xla", "pallas"])
@time_limit(60)
def test_expand_kernel_modes_give_equal_digests(flag, clean_join_record):
    """``--expand-kernel`` maps the JAX driver's names onto
    ``KernelConfig.expand``; every mode joins the same rows as ``auto``
    (on the CPU ``auto`` is the plain join, ``pallas`` the kernel
    pipeline on the kernels' plain twins)."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as d

    rec = d.run(d.parse_args(JOIN_ARGV + ["--expand-kernel", flag]),
                device="cpu")
    assert rec["expand_kernel"] == d.EXPAND_KERNEL[flag]
    assert clean_join_record["expand_kernel"] == "auto"
    assert rec["row_digest"] == clean_join_record["row_digest"]
    assert rec["matches_per_join"] == clean_join_record["matches_per_join"]


@time_limit(60)
def test_collect_integrity_rearms_spent_corruption_budget():
    """JAX ``tests/test_chaos.py:263-288``: a budget spent by an earlier
    (timed) program is rearmed, so the verification faces the schedule
    and refuses; a chaos-seeded driver never blesses corrupt numbers."""
    import distributed_join_tpu_torch as dj

    b, p = generate_build_probe_tables(
        seed=11, build_nrows=512, probe_nrows=1024, rand_max=256,
        selectivity=0.5, device="cpu")
    plan = FaultPlan(seed=5, corrupt_mode="bit_flip", corrupt_collectives=1)
    comm = FaultInjectingCommunicator(EmulatedCommunicator(8), plan)
    dj.distributed_inner_join(b, p, comm, out_capacity_factor=3.0)
    assert comm._corruptions == plan.corrupt_collectives
    with pytest.raises(IntegrityError):
        collect_integrity(comm, b.pad_to(512), p.pad_to(1024),
                          dict(key="key", out_capacity_factor=3.0))
