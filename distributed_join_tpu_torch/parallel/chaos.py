"""Seeded chaos soak: randomized fault schedules x join configs, every
trial graded against a host oracle.

``python -m distributed_join_tpu_torch.parallel.chaos --trials 25
--seed 42`` runs 25 deterministic trials over 8 emulated ranks on the
GPU (``--device cpu`` runs them on the CPU). Each trial derives its OWN
rng from ``(seed, trial_index)``, draws a join config (padded / ragged /
skew / out-of-core) and a fault schedule (nothing, capacity squeezes,
transient dispatch failures, or one of the
:data:`..faults.CORRUPTION_MODES` data corruptions), runs the join with
``verify_integrity=True``, and grades the outcome against ground truth
computed with numpy on the host (``utils.tpch_host.inner_match``):

- ``ok`` / ``recovered`` — the result is oracle-exact (full content
  comparison via the order-invariant table digest, not just the match
  count — a flipped payload byte with an intact key count would fool
  a count oracle); ``recovered`` means the retry ladder worked for it;
- ``detected`` — the run refused to return corrupt rows: a structured
  ``IntegrityError`` / ``PlanValidationError`` / ``FaultInjectedError``
  surfaced. For a corrupting schedule this is a PASS — the acceptance
  bar is "injected corruption is detected and survived, never silently
  joined";
- ``FAILED:silent_corruption`` — a trial RETURNED rows that disagree
  with the oracle: the one unforgivable outcome;
- ``FAILED:hang`` — the trial blew its watchdog deadline
  (:mod:`..watchdog`); ``FAILED:crash`` — an unstructured error, or
  any error on a fault-free trial.

Every failure writes a minimal-repro JSON (``--repro-out``) holding
the harness seed, the trial index, the exact config + fault plan, the
device type and the replay command — ``--trial K`` reruns exactly trial
K of a seed, bit for bit on the same device type (the config and
schedule draws are plain Python and device-free; the tables come from
the port's generator on the trial's device, and a CUDA
``torch.Generator`` draws other bits than a CPU one).

Port of ``distributed_join_tpu/parallel/chaos.py``, whole and in its
order: the draws and the grading (JAX :59-190), ``wrap_communicator``
(:116), the main soak (``run_trial``, ``_run_trial_body``,
``_run_out_of_core``, ``soak``: :192-362, :1705), the tuner slice
(:365-558, :716), the hierarchical slice (:561-713), the fleet slices
(``fleet_slice`` with the kill, hang and corrupt faults, the tenant
slice, the resident-kill slice: :753-1699) and the CLI (:1750-1883).
The draws are the JAX package's bit for bit: the same calls on the same
``random.Random``, the same tuples. The departures:

- The oracle is numpy, not pandas (the card's machine has none): the
  same multiset of ``(key, build_payload, probe_payload)`` rows by a
  sort-and-searchsorted merge; the content digest stays
  ``integrity.table_digest_np``.
- A trial runs over ``make_communicator("emulated", n_ranks=...)``
  (with ``n_slices`` on the hierarchical slice) on the trial's device:
  the counterpart of the JAX package's CPU mesh. ``soak``, the slices
  and the CLI run on the GPU unless the caller asks for the CPU by name
  (``device="cpu"``, ``--device cpu``); without a GPU they raise
  before any trial runs, never falling back to the CPU. On the card
  every trial's join launches B1 (``csrc/join_scans.cu``), both B2 sites
  (``csrc/stream_compact.cu``) and B3 (``csrc/expand_gather.cu``). The
  skew trials' sidecar takes the sort, not B5's skew site: at a trial's
  64-256 rows a rank the extract's branch rule (the kernel only where a
  rank's rows are twice its capacity, as in the JAX package) picks it.
- A fleet replica is the port's daemon on ``--device``
  (``service.fleet.process_fleet_factory(cfg, device=...)``). The
  victim is the replica the port's ``affine_replica`` picks (the port's
  join-spec signatures, so not always the JAX package's index), and the
  expected matches come from the spec's tables drawn on the replicas'
  device type (``fleet.wire_oracle_matches``,
  ``fleet.resident_oracle_matches``).
- The fleet slices' "zero new traces" gates keep their JAX semantics,
  with the port's meaning: on a port replica ``new_traces == 0`` after
  a start says that the shared persist dir's entry was found and
  checked, not that the replica is warm (``service/fleet.py``'s
  docstring).

Exit code 0 = every trial survived, 1 = at least one failure (repro
files written), 2 = bad usage or no device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time
from typing import Optional

from distributed_join_tpu_torch.parallel.faults import (
    CORRUPTION_MODES,
    FaultInjectedError,
    FaultInjectingCommunicator,
    FaultPlan,
    PlanValidationError,
    retry_with_backoff,
)

CONFIGS = ("padded", "ragged", "skew", "out_of_core")

# Discrete, small parameter sets: trials stay fast and programs repeat
# across trials. rand_max stays >= 256 so key duplication can't
# organically overflow a 3x-sized output block — organic overflow on a
# fault-free trial would read as a phantom harness failure (the retry
# budget still absorbs moderate skew).
_BUILD_ROWS = (512, 1024)
_PROBE_ROWS = (1024, 2048)
_RAND_MAX = (256, 700, 5000)
_SELECTIVITY = (0.3, 0.5)

_OUT_NAMES = ("key", "build_payload", "probe_payload")
_MODULE = "distributed_join_tpu_torch.parallel.chaos"


def random_fault_plan(rng: random.Random, *, corruption: bool = True,
                      dispatch_failures: bool = True) -> FaultPlan:
    """One seeded fault schedule. ``corruption=False`` restricts to
    the recoverable faults (squeezes/transients) — the knob behind the
    soak's ``--no-corruption`` control arm; the drivers' ``--chaos-seed``
    draws with ``dispatch_failures=False``."""
    kinds = ["none", "overflow"]
    if dispatch_failures:
        kinds.append("transient_dispatch")
    if corruption:
        kinds += ["corruption", "corruption"]  # corruption-heavy soak
    kind = rng.choice(kinds)
    seed = rng.randrange(1 << 16)
    if kind == "overflow":
        return FaultPlan(seed=seed,
                         overflow_programs=rng.choice((1, 2)))
    if kind == "transient_dispatch":
        return FaultPlan(seed=seed, fail_dispatches=1)
    if kind == "corruption":
        return FaultPlan(
            seed=seed,
            corrupt_mode=rng.choice(CORRUPTION_MODES),
            corrupt_collectives=rng.choice((1, 2)),
        )
    return FaultPlan(seed=seed)


def _trial_rng(seed: int, trial: int) -> random.Random:
    """Deterministic ACROSS processes: integer-mixed seeding (tuple/
    str seeds route through PYTHONHASHSEED-randomized hashing)."""
    return random.Random(seed * 1_000_003 + trial)


def fault_label(plan: FaultPlan) -> str:
    if plan.corrupt_mode is not None:
        return plan.corrupt_mode
    if plan.overflow_programs:
        return "overflow"
    if plan.fail_dispatches or plan.fail_after_dispatches is not None:
        return "transient_dispatch"
    return "none"


def wrap_communicator(comm, seed: int,
                      plan: Optional[FaultPlan] = None):
    """Driver seam (``--chaos-seed N``): wrap a communicator in a
    seeded fault schedule. Corruption modes are INCLUDED — pair with
    ``--verify-integrity`` so a corrupted run is detected, not reported
    as a clean benchmark number."""
    if plan is None:
        plan = random_fault_plan(_trial_rng(seed, 0),
                                 dispatch_failures=False)
    return FaultInjectingCommunicator(comm, plan)


def _plan_record(plan: FaultPlan) -> dict:
    return {k: v for k, v in dataclasses.asdict(plan).items()
            if v not in (None, 0, 0.0)}


def _host_columns(table) -> dict:
    """Valid rows of a (possibly device) table as host numpy."""
    valid = table.valid
    return {n: c[valid].cpu().numpy() for n, c in table.columns.items()}



def _oracle(build, probe) -> tuple:
    """Ground truth on the host: ``(columns, total)`` of the inner join
    on ``key`` — the multiset of rows the JAX package's pandas merge
    gives, by a sort-and-searchsorted merge
    (``utils.tpch_host.inner_match``)."""
    from distributed_join_tpu_torch.utils.tpch_host import inner_match

    b, p = _host_columns(build), _host_columns(probe)
    p_idx, b_idx, _ = inner_match(b["key"], p["key"])
    cols = {"key": p["key"][p_idx],
            "build_payload": b["build_payload"][b_idx],
            "probe_payload": p["probe_payload"][p_idx]}
    return cols, int(p_idx.shape[0])


def _content_digest(columns: dict) -> int:
    from distributed_join_tpu_torch.parallel.integrity import table_digest_np

    return table_digest_np(columns)


@dataclasses.dataclass
class TrialOutcome:
    verdict: str
    error: Optional[str] = None
    expected_total: Optional[int] = None
    got_total: Optional[int] = None
    retries: int = 0

    @property
    def failed(self) -> bool:
        return self.verdict.startswith("FAILED")


def _grade_result(got_cols, got_total, oracle_cols, oracle_total,
                  corrupting: bool, retries: int) -> TrialOutcome:
    content_ok = (
        got_total == oracle_total
        and _content_digest(got_cols) == _content_digest(oracle_cols)
    )
    if content_ok:
        return TrialOutcome("recovered" if retries else "ok",
                            expected_total=oracle_total,
                            got_total=got_total, retries=retries)
    return TrialOutcome(
        "FAILED:silent_corruption" if corrupting
        else "FAILED:wrong_result",
        expected_total=oracle_total, got_total=got_total,
        retries=retries,
    )


def _soak_device(device):
    """The trials' device: the GPU unless the CPU is asked for by name
    (``resolve_device`` raises without one)."""
    from distributed_join_tpu_torch.device import resolve_device

    return resolve_device(device)


def _tables(config: dict, device):
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    return generate_build_probe_tables(
        seed=config["table_seed"],
        build_nrows=config["build_rows"],
        probe_nrows=config["probe_rows"],
        rand_max=config["rand_max"],
        selectivity=config["selectivity"],
        device=device,
    )


def _guarded(body, deadline_s: Optional[float], what: str
             ) -> TrialOutcome:
    """``body()`` under the watchdog (no deadline: called directly); a
    hang or any exception it did not convert to a structured refusal
    becomes a FAILED verdict, never a soak abort."""
    from distributed_join_tpu_torch.parallel.watchdog import (
        HangError,
        call_with_deadline,
    )

    try:
        if deadline_s is not None:
            return call_with_deadline(body, deadline_s, what=what)
        return body()
    except HangError as exc:
        return TrialOutcome("FAILED:hang", error=str(exc))
    except Exception as exc:  # noqa: BLE001 — grading seam
        # Anything the trial body did not convert to a structured
        # refusal is a crash VERDICT: the trial is graded FAILED, its
        # repro JSON is written, and the remaining trials still run.
        return TrialOutcome(
            "FAILED:crash", error=f"{type(exc).__name__}: {exc}")


def run_trial(harness_seed: int, trial: int, n_ranks: int = 8,
              corruption: bool = True,
              deadline_s: Optional[float] = 300.0,
              device=None) -> dict:
    """Run one trial; returns its JSON-shaped record. Deterministic in
    (harness_seed, trial) on one device type: the config draw, the
    generators, and the fault schedule all derive from the trial rng."""
    dev = _soak_device(device)
    rng = _trial_rng(harness_seed, trial)
    config = {
        "mode": CONFIGS[trial % len(CONFIGS)],
        "build_rows": rng.choice(_BUILD_ROWS),
        "probe_rows": rng.choice(_PROBE_ROWS),
        "rand_max": rng.choice(_RAND_MAX),
        "selectivity": rng.choice(_SELECTIVITY),
        "table_seed": rng.randrange(1 << 16),
    }
    plan = random_fault_plan(rng, corruption=corruption)
    # Corrupting schedules sometimes run with NO retry budget — the
    # IntegrityError raise path must soak too. Every other schedule
    # keeps budget to absorb injected squeezes + moderate skew.
    config["auto_retry"] = (
        rng.choice((0, 2)) if plan.corrupt_mode is not None else 3
    )
    record = {
        "trial": trial,
        "config": config,
        "fault": fault_label(plan),
        "fault_plan": _plan_record(plan),
        "device": dev.type,
    }
    t0 = time.perf_counter()
    out = _guarded(lambda: _run_trial_body(config, plan, n_ranks, dev),
                   deadline_s, f"chaos trial {trial}")
    record.update(dataclasses.asdict(out))
    record["verdict"] = out.verdict
    record["elapsed_s"] = round(time.perf_counter() - t0, 3)
    from distributed_join_tpu_torch import telemetry

    telemetry.event("chaos_trial", trial=trial,
                    verdict=out.verdict, mode=config["mode"])
    return record


def _loud(injected: bool, oracle_total: int):
    def loud(kind: str, detail: Optional[str] = None) -> TrialOutcome:
        # A structured refusal (IntegrityError, a still-flagged
        # overflow, a surfaced injected fault) PASSES a trial whose
        # schedule injected something — corruption detected, never
        # silently joined. On a fault-free trial the same outcome is
        # a harness catch: a false alarm or an organic failure.
        return TrialOutcome(
            "detected" if injected else f"FAILED:{kind}",
            error=detail or kind, expected_total=oracle_total)
    return loud


def _graded_join(build, probe, comm, config: dict, join_opts: dict,
                 oracle_cols, oracle_total, corrupting: bool,
                 loud) -> TrialOutcome:
    """One verified ``distributed_inner_join`` under the drivers'
    transient-retry contract, graded against the oracle."""
    import distributed_join_tpu_torch as dj
    from distributed_join_tpu_torch.parallel import integrity

    try:
        def attempt():
            return dj.distributed_inner_join(
                build, probe, comm,
                auto_retry=config["auto_retry"],
                verify_integrity=True, **join_opts,
            )

        # Driver-level transient retry (the drivers' own contract):
        # injected dispatch failures are retried a couple of times
        # before counting as a loud structured failure.
        res, _ = retry_with_backoff(
            attempt, max_attempts=3, backoff_s=0.01,
            retry_on=(FaultInjectedError,),
        )
        retries = res.retry_report.n_attempts - 1
        if bool(res.overflow):
            return loud("overflow_after_ladder")
        return _grade_result(
            _host_columns(res.table), int(res.total),
            oracle_cols, oracle_total, corrupting, retries,
        )
    except integrity.IntegrityError as exc:
        return loud("false_integrity_alarm", f"IntegrityError: {exc}")
    except (PlanValidationError, FaultInjectedError) as exc:
        return loud("structured_error",
                    f"{type(exc).__name__}: {exc}")


def _run_trial_body(config, plan: FaultPlan, n_ranks: int, device
                    ) -> TrialOutcome:
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )

    build, probe = _tables(config, device)
    oracle_cols, oracle_total = _oracle(build, probe)
    corrupting = plan.corrupt_mode is not None
    comm = FaultInjectingCommunicator(
        make_communicator("emulated", n_ranks=n_ranks), plan)
    mode = config["mode"]
    loud = _loud(fault_label(plan) != "none", oracle_total)
    if mode == "out_of_core":
        from distributed_join_tpu_torch.parallel import integrity

        try:
            return _run_out_of_core(build, probe, comm, oracle_cols,
                                    oracle_total, corrupting, loud, plan)
        except integrity.IntegrityError as exc:
            return loud("false_integrity_alarm", f"IntegrityError: {exc}")
        except (PlanValidationError, FaultInjectedError) as exc:
            return loud("structured_error",
                        f"{type(exc).__name__}: {exc}")
    join_opts = dict(
        out_capacity_factor=3.0,
        shuffle_capacity_factor=3.0,
        shuffle="ragged" if mode == "ragged" else "padded",
    )
    if mode == "skew":
        join_opts["skew_threshold"] = 0.05
    return _graded_join(build, probe, comm, config, join_opts,
                        oracle_cols, oracle_total, corrupting, loud)


def _run_out_of_core(build, probe, comm, oracle_cols, oracle_total,
                     corrupting: bool, loud,
                     plan: FaultPlan) -> TrialOutcome:
    import numpy as np

    from distributed_join_tpu_torch.parallel.out_of_core import (
        keyrange_batched_join,
    )

    fetched = []

    def consumer(_b, res):
        fetched.append(_host_columns(res.table))

    total, overflow = keyrange_batched_join(
        build, probe, comm, n_batches=3, warmup=False,
        batch_retries=2, batch_retry_backoff_s=0.01,
        verify_integrity=True, on_batch_result=consumer,
        out_capacity_factor=3.0, shuffle_capacity_factor=3.0,
    )
    if overflow:
        return loud("overflow_flagged")
    got = {
        n: np.concatenate([c[n] for c in fetched])
        for n in (fetched[0] if fetched else {})
    }
    # A clean finish over an injected transient necessarily consumed a
    # batch retry — grade it "recovered" so the verdict histogram
    # reflects the retry machinery (the batch loop doesn't surface
    # attempt counts).
    retries = 1 if plan.fail_dispatches else 0
    return _grade_result(got, int(total), oracle_cols, oracle_total,
                         corrupting, retries=retries)


# -- the tuner slice (poisoned-history grading) -----------------------


def poisoned_history_entry(signature: str, *,
                           shuffle_capacity_factor: float = 0.4,
                           out_capacity_factor: float = 0.2,
                           rung: int = 1) -> dict:
    """A history line CLAIMING a workload resolved at a rung whose
    capacities are far too small — the lying-history adversary the
    tuner slice feeds the autotuner. Shaped like a real request entry
    (escalations recorded, resolved knobs at the bogus sizing) so the
    trend aggregation adopts it exactly as it would a genuine one."""
    return {
        "schema_version": 1,
        "kind": "request",
        "request_id": "poisoned",
        "op": "join",
        "signature": signature,
        "outcome": "served",
        "wall_s": 0.01,
        "new_traces": 1,
        "cache_hits": 0,
        "matches": 1,
        "retry": {"n_attempts": 2, "escalations": 1,
                  "integrity_retries": 0},
        "resolved_knobs": {
            "shuffle_capacity_factor": shuffle_capacity_factor,
            "out_capacity_factor": out_capacity_factor,
        },
        "rung": rung,
        "tuned": None,
        "error": None,
    }


def run_tuner_trial(harness_seed: int, trial: int,
                    n_ranks: int = 8,
                    deadline_s: Optional[float] = 300.0,
                    device=None) -> dict:
    """One poisoned-history trial: seed a temp history store with
    capacities claiming a too-small rung for EXACTLY the workload
    signature the tuner will compute, run the join with the tuner
    armed, and grade:

    - the result must be oracle-exact (the retry ladder catches the
      mis-size — a self-tuned config must never trade correctness for
      speed);
    - the post-run history must record the ESCALATED rung with
      capacities strictly above the poisoned claim (the tuner
      *learns* the corrected rung for the next run).
    """
    import tempfile

    import distributed_join_tpu_torch as dj
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )
    from distributed_join_tpu_torch.planning.tuner import (
        JoinTuner,
        workload_signature,
    )
    from distributed_join_tpu_torch.telemetry import history as tel_history

    dev = _soak_device(device)
    rng = _trial_rng(harness_seed, 1_000 + trial)
    config = {
        "mode": ("padded", "ragged", "skew")[trial % 3],
        "build_rows": rng.choice(_BUILD_ROWS),
        "probe_rows": rng.choice(_PROBE_ROWS),
        "rand_max": rng.choice(_RAND_MAX),
        "selectivity": rng.choice(_SELECTIVITY),
        "table_seed": rng.randrange(1 << 16),
    }
    # Recoverable faults only: the poisoned store is this slice's
    # adversary; corruption grading is the main soak's job.
    plan = random_fault_plan(rng, corruption=False)
    record = {
        "trial": trial,
        "config": config,
        "fault": fault_label(plan),
        "fault_plan": _plan_record(plan),
        "poisoned_history": True,
        "device": dev.type,
    }
    t0 = time.perf_counter()
    verdict: dict = {}

    def body():
        build, probe = _tables(config, dev)
        oracle_cols, oracle_total = _oracle(build, probe)
        comm = FaultInjectingCommunicator(
            make_communicator("emulated", n_ranks=n_ranks), plan)
        join_opts = dict(
            shuffle="ragged" if config["mode"] == "ragged"
            else "padded",
        )
        if config["mode"] == "skew":
            join_opts["skew_threshold"] = 0.05
        # The poison must land on EXACTLY the signature the tuner
        # will look up (same function, same tables, same opts).
        sig = workload_signature(comm, build, probe, key="key",
                                 with_integrity=True, **join_opts)
        poison = poisoned_history_entry(sig)
        with tempfile.TemporaryDirectory() as tmp:
            store = tel_history.WorkloadHistory(
                tmp + "/history.jsonl")
            store.append(poison)
            store.close()
            tuner = JoinTuner(store.path)

            def attempt():
                return dj.distributed_inner_join(
                    build, probe, comm, auto_retry=6,
                    verify_integrity=True, tuner=tuner,
                    **join_opts)

            res, _ = retry_with_backoff(
                attempt, max_attempts=3, backoff_s=0.01,
                retry_on=(FaultInjectedError,),
            )
            if bool(res.overflow):
                return TrialOutcome(
                    "FAILED:overflow_after_ladder",
                    expected_total=oracle_total)
            # Grade content against the oracle, THEN verify the
            # corrected rung landed back in the store.
            out = _grade_result(
                _host_columns(res.table), int(res.total),
                oracle_cols, oracle_total, corrupting=False,
                retries=res.retry_report.n_attempts - 1,
            )
            store2 = tel_history.WorkloadHistory(store.path)
            store2.append(tel_history.request_entry(
                request_id=f"tuner-trial-{trial}", op="join",
                signature=sig, outcome="served",
                wall_s=time.perf_counter() - t0,
                retry_record=res.retry_report.as_record(),
                tuned=getattr(res, "tuned", None)))
            store2.close()
            entries, _ = tel_history.load_history(store.path)
            trend = tel_history.trends_of(entries)[sig].as_dict()
            learned = trend["resolved_knobs_last"] or {}
            corrected = (
                (trend["resolved_rung_last"] or 0)
                > poison["rung"]
                and learned.get("out_capacity_factor", 0)
                > poison["resolved_knobs"]["out_capacity_factor"]
            )
            tuned_rec = getattr(res, "tuned", None) or {}
            verdict.update(
                tuner_presized=(tuned_rec.get("source") == "history"),
                tuner_corrected=corrected,
                learned_rung=trend["resolved_rung_last"],
                learned_knobs=learned)
            return out

    out = _guarded(body, deadline_s, f"tuner trial {trial}")
    if verdict and not out.verdict.startswith(("FAILED:hang",
                                               "FAILED:crash")):
        record.update(verdict)
        if not out.failed and not (verdict["tuner_presized"]
                                   and verdict["tuner_corrected"]):
            # Oracle-clean but the loop didn't close: either the
            # poisoned sizing never applied (the slice tested
            # nothing) or the corrected rung never landed — both are
            # harness failures, loudly.
            out = TrialOutcome(
                "FAILED:tuner_loop_open",
                error=str(verdict),
                expected_total=out.expected_total,
                got_total=out.got_total, retries=out.retries)
    record.update(dataclasses.asdict(out))
    record["verdict"] = out.verdict
    record["elapsed_s"] = round(time.perf_counter() - t0, 3)
    return record


# -- the hierarchical slice -------------------------------------------


def run_hier_trial(harness_seed: int, trial: int, n_ranks: int = 8,
                   deadline_s: Optional[float] = 300.0,
                   device=None) -> dict:
    """One hierarchical-shuffle chaos trial: a two-level
    ``shuffle="hierarchical"`` join over emulated ranks nested as
    (slice, chip), with the fault schedule injected at the communicator
    seams — including the cross-slice exchange
    (``FaultInjectingCommunicator.all_to_all_slice``) — graded against
    the oracle with wire digests on. Deterministic in
    ``(harness_seed, trial)`` like every other trial."""
    dev = _soak_device(device)
    rng = _trial_rng(harness_seed, 10_000 + trial)
    slices = rng.choice([s for s in (2, 4) if n_ranks % s == 0]
                        or [1])
    config = {
        "mode": "hierarchical",
        "n_slices": slices,
        "dcn_codec": rng.choice(("auto", "on", "off")),
        "build_rows": rng.choice(_BUILD_ROWS),
        "probe_rows": rng.choice(_PROBE_ROWS),
        "rand_max": rng.choice(_RAND_MAX),
        "selectivity": rng.choice(_SELECTIVITY),
        "table_seed": rng.randrange(1 << 16),
        "auto_retry": 3,
    }
    plan = random_fault_plan(rng, corruption=True)
    record = {
        "trial": trial,
        "config": config,
        "fault": fault_label(plan),
        "fault_plan": _plan_record(plan),
        "device": dev.type,
    }
    t0 = time.perf_counter()
    out = _guarded(lambda: _run_hier_trial_body(config, plan, n_ranks, dev),
                   deadline_s, f"hier chaos trial {trial}")
    record.update(dataclasses.asdict(out))
    record["verdict"] = out.verdict
    record["elapsed_s"] = round(time.perf_counter() - t0, 3)
    return record


def _run_hier_trial_body(config, plan: FaultPlan, n_ranks: int, device
                         ) -> TrialOutcome:
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )

    build, probe = _tables(config, device)
    oracle_cols, oracle_total = _oracle(build, probe)
    comm = FaultInjectingCommunicator(
        make_communicator("emulated", n_ranks=n_ranks,
                          n_slices=config["n_slices"]), plan)
    join_opts = dict(
        out_capacity_factor=3.0,
        shuffle_capacity_factor=3.0,
        shuffle="hierarchical",
        dcn_codec=config["dcn_codec"],
    )
    return _graded_join(build, probe, comm, config, join_opts,
                        oracle_cols, oracle_total,
                        plan.corrupt_mode is not None,
                        _loud(fault_label(plan) != "none", oracle_total))


def _verdicts(records) -> dict:
    verdicts: dict = {}
    for rec in records:
        verdicts[rec["verdict"]] = verdicts.get(rec["verdict"], 0) + 1
    return verdicts


def _write_repro(path: str, rec: dict, seed: int,
                 replay: Optional[str] = None) -> None:
    repro = {**rec, "harness_seed": seed}
    if replay is not None:
        repro["replay"] = replay
    with open(path, "w") as f:
        json.dump(repro, f, indent=2)
    print(f"  repro written: {path}", flush=True)


def hier_slice(seed: int, trials: int, n_ranks: int = 8,
               deadline_s: Optional[float] = 300.0,
               repro_out: Optional[str] = None, device=None) -> dict:
    """The --hier-slice soak: N hierarchical-shuffle trials; exit
    contract mirrors the main soak (0 failures = pass)."""
    dev = _soak_device(device)
    records, failures = [], []
    for k in range(trials):
        rec = run_hier_trial(seed, k, n_ranks=n_ranks,
                             deadline_s=deadline_s, device=dev)
        records.append(rec)
        print(f"hier trial {k:3d} [{rec['config']['n_slices']}x"
              f"{n_ranks // rec['config']['n_slices']} "
              f"codec={rec['config']['dcn_codec']:4s}] "
              f"fault={rec['fault']:17s} -> {rec['verdict']} "
              f"({rec['elapsed_s']}s)", flush=True)
        if rec["verdict"].startswith("FAILED"):
            failures.append(rec)
            if repro_out:
                _write_repro(f"{repro_out}_hier_{seed}_{k}.json", rec,
                             seed)
    return {
        "harness_seed": seed,
        "slice": "hierarchical_shuffle",
        "n_ranks": n_ranks,
        "device": dev.type,
        "trials": len(records),
        "verdicts": _verdicts(records),
        "failures": len(failures),
        "records": records,
    }


def tuner_slice(seed: int, trials: int, n_ranks: int = 8,
                deadline_s: Optional[float] = 300.0,
                repro_out: Optional[str] = None, device=None) -> dict:
    """The --tuner-slice soak: N poisoned-history trials; exit
    contract mirrors the main soak (0 failures = pass)."""
    dev = _soak_device(device)
    records, failures = [], []
    for k in range(trials):
        rec = run_tuner_trial(seed, k, n_ranks=n_ranks,
                              deadline_s=deadline_s, device=dev)
        records.append(rec)
        print(f"tuner trial {k:3d} [{rec['config']['mode']:7s}] "
              f"fault={rec['fault']:17s} -> {rec['verdict']} "
              f"(presized={rec.get('tuner_presized')}, "
              f"corrected={rec.get('tuner_corrected')}, "
              f"{rec['elapsed_s']}s)", flush=True)
        if rec["verdict"].startswith("FAILED"):
            failures.append(rec)
            if repro_out:
                _write_repro(f"{repro_out}_tuner_{seed}_{k}.json", rec,
                             seed)
    return {
        "harness_seed": seed,
        "slice": "tuner_poisoned_history",
        "n_ranks": n_ranks,
        "device": dev.type,
        "trials": len(records),
        "verdicts": _verdicts(records),
        "failures": len(failures),
        "records": records,
    }


# -- the fleet slice (kill/hang/corrupt one replica mid-soak) ---------


def _fleet_trial_spec(seed: int, trial: int) -> dict:
    """One trial's wire join spec, deterministic in (seed, trial).
    Small discrete shape sets so the fleet shares few programs (the
    shared persist dir absorbs repeats); rand_max stays >= 256 for the
    usual organic-overflow reason."""
    trng = _trial_rng(seed, 555_100 + trial)
    return {
        "op": "join",
        "build_nrows": trng.choice((512, 1024)),
        "probe_nrows": 1024,
        "rand_max": 512,
        "selectivity": trng.choice((0.3, 0.5)),
        "seed": trng.randrange(1 << 16),
        "out_capacity_factor": 3.0,
    }


def _fleet_config(workdir: str, replica_ranks: int, **extra):
    from distributed_join_tpu_torch.service import fleet as fleet_mod

    return fleet_mod.FleetConfig(
        n_replicas=2,
        replica_ranks=replica_ranks,
        persist_dir=os.path.join(workdir, "programs"),
        history_dir=os.path.join(workdir, "history"),
        probe_interval_s=0.5,
        suspect_strikes=2,
        retry_budget=2,
        request_deadline_s=120.0,
        **extra,
    )


def _recorder_overrides(workdir: str) -> dict:
    """Per-INDEX flight-recorder paths in the soak's workdir: a shared
    path would let the sibling's stop-time dump clobber the victim's
    postmortem (respawned generations default to the persist dir —
    still inside the workdir, never the cwd)."""
    return {
        i: {"extra_args": ["--flight-recorder-path",
                           os.path.join(workdir, f"replica{i}_fr.json")]}
        for i in (0, 1)
    }


def fleet_arming(seed: int, trials: int, fault: Optional[str],
                 replica_ranks: int, workdir: str) -> tuple:
    """The fleet soak's draws and its victim's arming: ``(fault,
    victim, replica_overrides)``. The fault is drawn from the harness
    seed unless pinned; the victim is the replica AFFINE to the
    workload that will face the fault (the router's routing is
    deterministic given the spec) — an rng-drawn index could land on a
    replica the whole soak never routes to. hang/corrupt arm a
    FaultPlan at spawn, so trial 0's replica faces it; the kill lands
    right before the MIDPOINT trial's dispatch, so THAT trial's replica
    is the victim — the router's first post-kill attempt is then
    guaranteed to hit the dead backend, producing the failed-attempt/
    failover-retry pair the trace-continuity gate walks."""
    from distributed_join_tpu_torch.service import fleet as fleet_mod

    rng = _trial_rng(seed, 555_000)
    fault = fault or rng.choice(("kill", "hang", "corrupt"))
    victim = fleet_mod.affine_replica(
        _fleet_trial_spec(seed, trials // 2) if fault == "kill"
        else _fleet_trial_spec(seed, 0),
        replica_ranks, 2)
    overrides = _recorder_overrides(workdir)
    if fault == "hang":
        overrides[victim]["fault_plan"] = {
            "seed": seed % (1 << 16),
            "dispatch_delay_s": 30.0,
            "delay_after_dispatches": 3}
        # The per-request watchdog must cover the victim's cold
        # builds (its first dispatches are delay-free) but trip well
        # inside the 30s injected stall.
        overrides[victim]["extra_args"] += ["--guard-deadline-s", "10.0"]
    elif fault == "corrupt":
        overrides[victim]["fault_plan"] = {
            "seed": seed % (1 << 16),
            "corrupt_mode": rng.choice(CORRUPTION_MODES),
            "corrupt_collectives": 1}
        overrides[victim]["extra_args"] += ["--verify-integrity",
                                            "--auto-retry", "0"]
        overrides[victim]["persist"] = False
    return fault, victim, overrides


def _send(client, spec: dict) -> dict:
    try:
        return client.send(spec)
    except (OSError, ValueError) as exc:
        # The ROUTER must never die under a replica fault.
        return {"ok": False, "error": "RouterLost",
                "message": f"{type(exc).__name__}: {exc}"}


def _direct(rep, spec: dict) -> dict:
    """``spec`` sent straight to one replica, past the router."""
    from distributed_join_tpu_torch.service.server import ServiceClient

    try:
        direct = ServiceClient(*rep.addr(), timeout_s=120.0)
        try:
            return direct.send(spec)
        finally:
            direct.close()
    except (OSError, ValueError) as exc:
        return {"ok": False, "error": "RouterLost",
                "message": f"{type(exc).__name__}: {exc}"}


def _fleet(cfg, device, overrides: dict):
    """A started router over process replicas on ``device``, its TCP
    daemon and a client: ``(router, server, client)``."""
    from distributed_join_tpu_torch.service import fleet as fleet_mod
    from distributed_join_tpu_torch.service.server import ServiceClient

    if device != "cpu":
        # Build the kernel libraries the replicas load (one nvcc a
        # source, in parallel) before they start: a replica would build
        # them one by one inside its first request, past the hang
        # slice's 10 s per-request watchdog.
        from distributed_join_tpu_torch.ops import _kernels

        _kernels.build()
    router = fleet_mod.FleetRouter(
        fleet_mod.process_fleet_factory(
            cfg, device=device, replica_overrides=overrides), cfg)
    router.start()
    server, port = fleet_mod.start_router_daemon(router)
    return router, server, ServiceClient("127.0.0.1", port)


def _close_fleet(router, server, client) -> None:
    client.close()
    server.shutdown()
    server.server_close()
    router.stop()


def _keep_or_remove(workdir: str, failures, what: str) -> None:
    if failures:
        # Keep the workdir: the per-replica flight dumps and the
        # shared program dir ARE the postmortem.
        print(f"{what} artifacts kept at {workdir}", flush=True)
    else:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)


def _fleet_device(device) -> str:
    """The replicas' ``--device`` (the GPU unless the CPU is asked for)
    and, through ``replica_device``, where the oracle draws their
    tables: replica 0's device (the same type as every replica's)."""
    if device is None or str(device) == "cuda":
        _soak_device(None)
        return "cuda"
    return str(_soak_device(device))


def fleet_slice(seed: int, trials: int, *, replica_ranks: int = 2,
                fault: Optional[str] = None,
                repro_out: Optional[str] = None, device=None) -> dict:
    """The ``--fleet`` soak: a 2-replica subprocess fleet behind the
    signature-affinity router, N seeded join trials through the router's
    TCP wire, ONE replica faulted mid-soak — ``kill`` (SIGKILL at the
    midpoint trial), ``hang`` (``FaultPlan.dispatch_delay_s`` armed
    after a few dispatches via ``--fault-plan``, turning into a
    replica-side HangError + poison), or ``corrupt`` (a corruption-mode
    plan + ``--verify-integrity --auto-retry 0``, so the integrity rung
    refuses loudly through the router; the victim is excluded from the
    shared persist dir so its corrupted program can never enter the
    distribution tier). Replicas are the port's daemons on ``device``
    (the GPU unless the CPU is asked for).

    Gates:

    - every non-refused answer grades oracle-clean against the numpy
      oracle over the spec's tables drawn on the replicas' device type
      (a wrong match count through the router is ``FAILED:wrong_result``
      — the one unforgivable outcome);
    - a refusal is only a PASS when it is structured AND the schedule
      injected something (kill/hang failovers absorb transparently;
      the corrupt victim's IntegrityError passes through);
    - for kill/hang: the faulted replica is DRAINED within one probe
      interval (+ scheduling slack) of the fault surfacing and
      REPLACED (healthy at a higher generation), and the
      post-replacement repeat of a PRE-FAULT workload signature
      dispatches with ZERO new traces — on a port replica that says the
      shared persist dir's entry was found and checked, not that the
      replacement is warm (``service/fleet.py``'s docstring);
    - no request is lost: served + structured refusals == trials
      (the router answers everything; the failover budget bounds the
      retries behind each answer).
    """
    import tempfile

    from distributed_join_tpu_torch.service import fleet as fleet_mod

    dev = _fleet_device(device)
    workdir = tempfile.mkdtemp(prefix="djtpu_fleet_soak_")
    fault, victim, overrides = fleet_arming(seed, trials, fault,
                                            replica_ranks, workdir)
    cfg = _fleet_config(workdir, replica_ranks)
    oracle_device = fleet_mod.replica_device(dev, 0)
    router, server, client = _fleet(cfg, dev, overrides)
    kill_at = trials // 2

    def refusal_injected(k: int, err: str) -> bool:
        """Whether a structured refusal is attributable to THE armed
        fault — anything else (a spurious shed, a bogus overflow
        refusal from the healthy sibling) must grade FAILED even on a
        faulted soak, or the acceptance gate would mask regressions.
        corrupt injects exactly an IntegrityError; hang surfaces as
        HangError/poisoned (raw, or folded into the router's
        failover-exhausted FleetError message); a post-kill refusal
        must chain from the dead replica's connection (a spurious
        shed from the healthy sibling is a failure even then)."""
        if fault == "kill":
            return k >= kill_at and ("connection" in err
                                     or "FleetError" in err)
        if fault == "corrupt":
            return "IntegrityError" in err
        return any(tag in err for tag in ("Hang", "hang", "poisoned"))

    records, failures = [], []
    pre_fault_spec = None
    fault_seen_at: Optional[float] = None
    kill_send_at: Optional[float] = None

    def grade(resp, expected, k: int) -> TrialOutcome:
        if resp.get("ok"):
            if resp.get("overflow"):
                return TrialOutcome("FAILED:overflow",
                                    expected_total=expected)
            got = resp.get("matches")
            failovers = (resp.get("fleet") or {}).get("failovers", 0)
            if got == expected:
                return TrialOutcome(
                    "recovered" if failovers else "ok",
                    expected_total=expected, got_total=got,
                    retries=failovers)
            return TrialOutcome(
                "FAILED:wrong_result", expected_total=expected,
                got_total=got, retries=failovers)
        err = f"{resp.get('error')}: {resp.get('message')}"
        return TrialOutcome(
            "detected" if refusal_injected(k, err)
            else "FAILED:refused",
            error=err, expected_total=expected)

    drain_replace = {"required": fault in ("kill", "hang")}
    post_replacement_new_traces = None
    trace_continuity = {"required": False}
    try:
        for k in range(trials):
            spec = _fleet_trial_spec(seed, k)
            if pre_fault_spec is None:
                pre_fault_spec = dict(spec)
            expected = fleet_mod.wire_oracle_matches(spec, oracle_device)
            if fault == "kill" and k == kill_at:
                # SIGKILL right before THIS dispatch (the oracle is
                # already computed): the victim is this trial's
                # affine replica, so the router's next attempt dials
                # the dead backend unless the 0.5s prober wins the
                # microsecond race (detected below via drained_at
                # and excused by the trace-continuity gate).
                router.replicas[victim].backend.kill()
                fault_seen_at = time.monotonic()
            t_send = time.monotonic()
            if fault == "kill" and k == kill_at:
                kill_send_at = t_send
            t0 = time.perf_counter()
            resp = _send(client, spec)
            t_resp = time.monotonic()
            out = grade(resp, expected, k)
            rep = router.replicas[victim]
            if fault in ("hang", "corrupt") \
                    and fault_seen_at is None \
                    and (rep.drained_at or 0) >= t_send:
                # The armed fault surfaced during THIS trial: it
                # became OBSERVABLE when the replica's HangError
                # answer (its own watchdog deadline — the in-flight
                # request 'deadlines out' by design) reached the
                # router, which is no later than our response. The
                # drain-latency gate measures from there.
                fault_seen_at = min(t_resp, rep.drained_at)
            rec = {"trial": k, "spec": spec, "fault": fault,
                   **dataclasses.asdict(out),
                   "verdict": out.verdict,
                   "elapsed_s": round(time.perf_counter() - t0, 3)}
            records.append(rec)
            print(f"fleet trial {k:3d} fault={fault:7s} -> "
                  f"{rec['verdict']} ({rec['elapsed_s']}s)",
                  flush=True)
            if out.failed:
                failures.append(rec)
                if repro_out:
                    _write_repro(
                        f"{repro_out}_fleet_{seed}_{k}.json", rec, seed,
                        f"python -m {_MODULE} --fleet {trials} "
                        f"--fleet-fault {fault} --seed {seed} "
                        f"--device {dev}")

        if fault in ("kill", "hang"):
            rep = router.replicas[victim]
            replaced = router.wait_replaced(
                victim, timeout_s=cfg.spawn_timeout_s)
            drained_after_s = (
                (rep.drained_at - fault_seen_at)
                if rep.drained_at is not None
                and fault_seen_at is not None else None)
            within = (drained_after_s is not None
                      and drained_after_s
                      <= 3 * cfg.probe_interval_s + 5.0)
            drain_replace.update(
                drained=rep.drained_at is not None,
                drained_after_s=(round(drained_after_s, 3)
                                 if drained_after_s is not None
                                 else None),
                drained_within_probe_interval=within,
                replaced=replaced,
                generation=rep.generation)
            if rep.drained_at is not None and rep.replaced_at is not None:
                # the port's addition: fault to serving again, seconds
                drain_replace["replaced_after_s"] = round(
                    rep.replaced_at - (fault_seen_at or rep.drained_at), 3)
            if not (replaced and within):
                failures.append({"gate": "drain_replace",
                                 **drain_replace})
            # Zero-trace repeat of a PRE-FAULT signature on the
            # replacement (the shared persist dir at work) — only
            # when a replacement is actually up; dialing the dead
            # backend's old port would crash the harness instead of
            # recording the gate failure above.
            if replaced:
                replay = _direct(rep, dict(pre_fault_spec))
                post_replacement_new_traces = replay.get("new_traces")
                if not replay.get("ok") \
                        or replay.get("new_traces") != 0:
                    failures.append({
                        "gate": "post_replacement_warm",
                        "response": {kk: replay.get(kk) for kk in
                                     ("ok", "error", "message",
                                      "new_traces", "matches")}})
        # Distributed-tracing continuity through the kill: every failed
        # join-dispatch attempt the flight ring recorded must share its
        # trace_id with the SAME request's final served record — the
        # victim hop and the winning failover retry are ONE causal
        # trace, never two. The scripted SIGKILL guarantees at least one
        # mid-soak failover, so an empty attempt ring here means trace
        # stamping broke, not a quiet soak.
        if fault == "kill":
            ring = router.recorder.snapshot()["records"]
            failed_attempts = [
                r for r in ring
                if r.get("outcome") == "attempt_failed"
                and r.get("op") == "join"
                and (r.get("trace") or {}).get("trace_id")]
            served_by_rid = {
                r.get("request_id"): r for r in ring
                if r.get("outcome") == "served"}
            broken = []
            for r in failed_attempts:
                final = served_by_rid.get(r.get("request_id"))
                f_tid = (r.get("trace") or {}).get("trace_id")
                s_tid = ((final or {}).get("trace")
                         or {}).get("trace_id")
                if final is None or f_tid != s_tid:
                    broken.append({"request_id": r.get("request_id"),
                                   "attempt_trace": f_tid,
                                   "served_trace": s_tid})
            # The prober can (rarely) drain the freshly killed victim
            # in the microseconds between the SIGKILL and the
            # midpoint dispatch — then the router routes straight to
            # the sibling and no attempt ever fails. Observable as
            # drained_at preceding the dispatch; excused, because
            # there was no failover whose continuity COULD be graded.
            rep = router.replicas[victim]
            prober_won = bool(
                not failed_attempts
                and rep.drained_at is not None
                and kill_send_at is not None
                and rep.drained_at <= kill_send_at)
            trace_continuity = {
                "required": True,
                "failed_attempts": len(failed_attempts),
                "broken": broken,
                "prober_won_race": prober_won,
            }
            if broken or (not failed_attempts and not prober_won):
                failures.append({"gate": "trace_continuity",
                                 **trace_continuity})
    finally:
        _close_fleet(router, server, client)

    answered = sum(1 for r in records
                   if not r["verdict"].startswith("FAILED"))
    _keep_or_remove(workdir, failures, "fleet soak")
    return {
        "kind": "fleet_soak",
        "schema_version": 1,
        "harness_seed": seed,
        "slice": "fleet",
        "fault": fault,
        "victim": victim,
        "replica_ranks": replica_ranks,
        "device": dev,
        "trials": len(records),
        "verdicts": _verdicts(records),
        "answered": answered,
        "failures": len(failures),
        "failure_records": failures,
        "drain_replace": drain_replace,
        "post_replacement_new_traces": post_replacement_new_traces,
        "trace_continuity": trace_continuity,
        "fleet_stats": router.stats(),
        "records": records,
    }


# -- the multi-tenant fleet slice -------------------------------------


def fleet_tenant_slice(seed: int, trials: int, *,
                       replica_ranks: int = 2,
                       repro_out: Optional[str] = None,
                       device=None) -> dict:
    """The ``--tenants`` soak: a 2-replica subprocess fleet with two
    configured tenants — ``noisy`` (QPS-quota'd, priority 1) FLOODS at
    ~5x its quota while ``quiet`` (no quota, priority 2) runs
    oracle-graded joins; one replica is SIGKILLed at the midpoint
    trial.

    Gates:

    - the quiet tenant's every answer grades oracle-EXACT and its shed
      count is ZERO (router-side and response-side): the noisy
      tenant's flood is shed, never the quiet tenant;
    - the noisy tenant IS shed — structured ``QuotaExceededError`` /
      ``ShedError`` refusals naming the bound, with the router's
      per-tenant shed counters agreeing;
    - tenant isolation in the tuner namespace: every router history
      entry carries its sender's tenant stamp and the trend table
      keys stay ``tenant/signature``-namespaced — the noisy flood
      never moves the quiet tenant's knobs;
    - the killed replica is drained and REPLACED, and the replacement
      serves a pre-kill quiet signature with ZERO new traces (the
      shared persist dir's entry found and checked, as in
      :func:`fleet_slice`); the router's ``fleet_autoscale`` record
      stays well-formed with the control loop live the whole soak.
    """
    import tempfile

    from distributed_join_tpu_torch.service import fleet as fleet_mod
    from distributed_join_tpu_torch.telemetry import history as tel_history

    dev = _fleet_device(device)
    noisy_qps = 2.0
    flood_per_trial = 10  # ~5x the one-second bucket capacity
    workdir = tempfile.mkdtemp(prefix="djtpu_tenant_soak_")
    cfg = _fleet_config(
        workdir, replica_ranks,
        tenants={
            "noisy": {"qps": noisy_qps, "burst_s": 1.0,
                      "priority": 1},
            "quiet": {"priority": 2},
        },
        # The control loop runs the whole soak (its record must stay
        # well-formed under fault); the up bound is out of reach so
        # the scripted kill's respawn is the one lifecycle event.
        autoscale=True,
        autoscale_up_qps=1e9,
        autoscale_interval_s=0.5,
    )
    kill_at = trials // 2
    victim = fleet_mod.affine_replica(
        _fleet_trial_spec(seed, kill_at), replica_ranks, 2)
    oracle_device = fleet_mod.replica_device(dev, 0)
    router, server, client = _fleet(cfg, dev, _recorder_overrides(workdir))

    records, failures = [], []
    noisy_counts = {"sent": 0, "ok": 0, "quota_shed": 0,
                    "priority_shed": 0, "excused": 0, "other": 0}
    quiet_shed_responses = 0
    pre_kill_spec = None
    killed = False
    st, quiet_st, noisy_st = {}, {}, {}
    drain_replace: dict = {"required": True}
    post_replacement_new_traces = None
    autoscale: dict = {}

    try:
        for k in range(trials):
            spec = _fleet_trial_spec(seed, k)
            expected = fleet_mod.wire_oracle_matches(spec, oracle_device)
            if k == kill_at:
                router.replicas[victim].backend.kill()
                killed = True
            # The noisy flood rides FIRST each round: back-to-back
            # sends far over the bucket — the quiet trial right
            # after must be untouched by it.
            for j in range(flood_per_trial):
                nresp = _send(client, {**_fleet_trial_spec(seed, k),
                                       "tenant": "noisy",
                                       "request_id":
                                           f"noisy-{seed}-{k}-{j}"})
                noisy_counts["sent"] += 1
                if nresp.get("ok"):
                    noisy_counts["ok"] += 1
                elif nresp.get("error") == "QuotaExceededError":
                    noisy_counts["quota_shed"] += 1
                elif nresp.get("error") == "ShedError":
                    noisy_counts["priority_shed"] += 1
                elif killed and nresp.get("error") in (
                        "FleetError", "AdmissionError"):
                    # An ADMITTED noisy request can land on the dead
                    # backend before the prober drains it — that is
                    # the scripted kill, not a quota bug.
                    noisy_counts["excused"] += 1
                else:
                    noisy_counts["other"] += 1
                    failures.append({"gate": "noisy_outcome",
                                     "trial": k, "flood": j,
                                     "error": nresp.get("error"),
                                     "message": nresp.get("message")})
            t0 = time.perf_counter()
            resp = _send(client, {**spec, "tenant": "quiet",
                                  "request_id": f"quiet-{seed}-{k}"})
            if resp.get("shed"):
                quiet_shed_responses += 1
            got = resp.get("matches")
            failovers = (resp.get("fleet") or {}).get("failovers", 0)
            if resp.get("ok") and got == expected:
                verdict = "recovered" if failovers else "ok"
            elif resp.get("ok"):
                verdict = "FAILED:wrong_result"
            else:
                verdict = "FAILED:refused"
            rec = {"trial": k, "spec": spec, "verdict": verdict,
                   "expected_total": expected, "got_total": got,
                   "retries": failovers,
                   "error": (None if resp.get("ok") else
                             f"{resp.get('error')}: "
                             f"{resp.get('message')}"),
                   "elapsed_s": round(time.perf_counter() - t0, 3)}
            records.append(rec)
            print(f"tenant trial {k:3d} -> {verdict} "
                  f"({rec['elapsed_s']}s)", flush=True)
            if verdict.startswith("FAILED"):
                failures.append(rec)
                if repro_out:
                    _write_repro(
                        f"{repro_out}_tenant_{seed}_{k}.json", rec, seed,
                        f"python -m {_MODULE} --tenants {trials} "
                        f"--seed {seed} --device {dev}")
            if not verdict.startswith("FAILED") and k < kill_at:
                pre_kill_spec = dict(spec)

        st = router.stats()
        tenants_st = st.get("tenants") or {}
        quiet_st = tenants_st.get("quiet") or {}
        noisy_st = tenants_st.get("noisy") or {}
        # Gate: the quiet tenant was NEVER shed — zero shed answers
        # on the wire AND a zero router-side shed counter.
        if quiet_shed_responses or (quiet_st.get("shed") or 0) != 0:
            failures.append({
                "gate": "quiet_never_shed",
                "shed_responses": quiet_shed_responses,
                "router_shed": quiet_st.get("shed")})
        # Gate: the noisy tenant WAS shed, with the router's counter
        # agreeing that sheds happened.
        if noisy_counts["quota_shed"] == 0 \
                or (noisy_st.get("shed") or 0) == 0:
            failures.append({
                "gate": "noisy_shed",
                "counts": dict(noisy_counts),
                "router_shed": noisy_st.get("shed")})
        # Gate: tenant isolation in the tuner namespace — every
        # history entry stamped with its sender's tenant, every
        # trend key tenant/signature-namespaced.
        entries, _ = tel_history.load_history(cfg.history_dir)
        request_entries = [e for e in entries
                           if e.get("kind") == "request"]
        unstamped = [e for e in request_entries
                     if e.get("tenant") not in ("noisy", "quiet")]
        bare = [key for key in tel_history.trends_of(request_entries)
                if "/" not in key]
        if unstamped or bare:
            failures.append({
                "gate": "tenant_namespace",
                "unstamped_entries": len(unstamped),
                "bare_trend_keys": bare})
        # Gate: drain + replace + the zero-trace contract on the
        # replacement (the autoscaler's own rotation gate).
        rep = router.replicas[victim]
        replaced = router.wait_replaced(victim,
                                        timeout_s=cfg.spawn_timeout_s)
        drain_replace.update(drained=rep.drained_at is not None,
                             replaced=replaced,
                             generation=rep.generation)
        if not replaced:
            failures.append({"gate": "drain_replace", **drain_replace})
        elif pre_kill_spec is not None:
            replay = _direct(rep, {**pre_kill_spec, "tenant": "quiet"})
            post_replacement_new_traces = replay.get("new_traces")
            if not replay.get("ok") or replay.get("new_traces") != 0:
                failures.append({
                    "gate": "post_replacement_warm",
                    "response": {kk: replay.get(kk) for kk in
                                 ("ok", "error", "message",
                                  "new_traces", "matches")}})
        autoscale = router.autoscale_record()
        from distributed_join_tpu_torch.telemetry.analyze import check_file

        as_path = os.path.join(workdir, "fleet_autoscale.json")
        with open(as_path, "w") as f:
            json.dump(autoscale, f, indent=2)
        as_problems = check_file(as_path)
        if as_problems:
            failures.append({"gate": "autoscale_record",
                             "problems": as_problems})
    finally:
        _close_fleet(router, server, client)

    _keep_or_remove(workdir, failures, "tenant soak")
    return {
        "kind": "fleet_tenant_soak",
        "schema_version": 1,
        "harness_seed": seed,
        "slice": "tenants",
        "victim": victim,
        "replica_ranks": replica_ranks,
        "device": dev,
        "trials": len(records),
        "verdicts": _verdicts(records),
        "noisy": {"quota_qps": noisy_qps,
                  "flood_per_trial": flood_per_trial,
                  **noisy_counts,
                  "router_shed": noisy_st.get("shed"),
                  "quota_sheds": noisy_st.get("quota_sheds"),
                  "priority_sheds": noisy_st.get("priority_sheds")},
        "quiet": {"trials": len(records),
                  "shed_responses": quiet_shed_responses,
                  "router_shed": quiet_st.get("shed") or 0},
        "failures": len(failures),
        "failure_records": failures,
        "drain_replace": drain_replace,
        "post_replacement_new_traces": post_replacement_new_traces,
        "autoscale": {"enabled": autoscale.get("enabled"),
                      "spawns_total": autoscale.get("spawns_total"),
                      "drains_total": autoscale.get("drains_total")},
        "fleet_stats": st,
        "records": records,
    }


# -- the resident-kill fleet slice ------------------------------------


def _resident_trial_spec(seed: int, trial: int, table: str) -> dict:
    """One probe-only trial spec, deterministic in (seed, trial).
    The table name pins the signature ring slot, so every trial
    ring-starts at the table's primary holder — the victim faces
    ALL the traffic."""
    trng = _trial_rng(seed, 555_200 + trial)
    return {
        "op": "join",
        "table": table,
        "probe_nrows": trng.choice((512, 1024)),
        "rand_max": 4096,
        "selectivity": trng.choice((0.3, 0.5)),
        "seed": trng.randrange(1 << 16),
        "out_capacity_factor": 3.0,
    }


def fleet_resident_slice(seed: int, trials: int, *,
                         replica_ranks: int = 2,
                         repro_out: Optional[str] = None,
                         device=None) -> dict:
    """The ``--fleet-fault resident-kill`` soak: a K=2 fleet holds ONE
    resident table (register + one append, so generation fencing is
    live), N probe-only trials ring-start at the table's PRIMARY
    holder, and that holder is SIGKILLed at the midpoint.

    Gates:

    - **zero wrong rows from any holder** — every non-refused answer
      must equal the numpy oracle over register + delta, drawn on the
      replicas' device type (``fleet.resident_oracle_matches``; stale
      or rebuilt images either serve the full image or refuse; a wrong
      match count is the unforgivable ``FAILED:wrong_result``);
    - **failover within the retry budget** — post-kill probe-only
      trials are answered by the surviving holder within
      ``retry_budget + 1`` attempts (a refusal only passes when
      attributable to the kill);
    - **rebuild** — the replacement walks ``rebuilding -> serving``
      at the directory generation by replaying the durable manifest,
      and a generation-FENCED replay of a pre-fault probe-only
      signature on it answers oracle-exact with ZERO new traces (the
      shared persist dir's entry found and checked, as in
      :func:`fleet_slice`).
    """
    import tempfile

    from distributed_join_tpu_torch.service import fleet as fleet_mod

    dev = _fleet_device(device)
    table = "soak_residents"
    reg = {"op": "register", "name": table, "rows": 2048,
           "seed": seed % 9973 + 11, "rand_max": 4096,
           "unique_keys": True}
    delta = {"op": "append", "name": table, "rows": 256,
             "seed": seed % 9973 + 13, "rand_max": 4096}
    victim = fleet_mod.affine_replica({"op": "join", "table": table},
                                      replica_ranks, 2)
    workdir = tempfile.mkdtemp(prefix="djtpu_fleet_resident_soak_")
    cfg = _fleet_config(workdir, replica_ranks,
                        coord_dir=os.path.join(workdir, "coord"),
                        table_replication=2)
    oracle_device = fleet_mod.replica_device(dev, 0)
    router, server, client = _fleet(cfg, dev, _recorder_overrides(workdir))
    kill_at = trials // 2

    def expected_matches(spec: dict) -> int:
        # The resident oracle: register + delta, the probe drawn as the
        # holder draws it, on the replicas' device type.
        return fleet_mod.resident_oracle_matches(reg, [delta], spec,
                                                 oracle_device)

    def refusal_injected(k: int, err: str) -> bool:
        return k >= kill_at and ("connection" in err
                                 or "FleetError" in err
                                 or "StaleGeneration" in err)

    records, failures = [], []
    pre_fault_spec = None
    generation = None
    drain_replace: dict = {"required": True}
    rebuild: dict = {"required": True}
    try:
        r = client.send(reg)
        if not r.get("ok"):
            raise RuntimeError(f"soak register failed: {r}")
        a = client.send(delta)
        if not a.get("ok"):
            raise RuntimeError(f"soak append failed: {a}")
        generation = int(a.get("generation", 0))

        for k in range(trials):
            spec = _resident_trial_spec(seed, k, table)
            if pre_fault_spec is None:
                pre_fault_spec = dict(spec)
            if k == kill_at:
                router.replicas[victim].backend.kill()
            expected = expected_matches(spec)
            t0 = time.perf_counter()
            resp = _send(client, spec)
            if resp.get("ok"):
                got = resp.get("matches")
                fl = resp.get("fleet") or {}
                if resp.get("overflow"):
                    out = TrialOutcome("FAILED:overflow",
                                       expected_total=expected)
                elif got != expected:
                    # The unforgivable outcome: a holder served rows
                    # that exclude the delta (or worse).
                    out = TrialOutcome("FAILED:wrong_result",
                                       expected_total=expected,
                                       got_total=got,
                                       retries=fl.get("failovers", 0))
                elif fl.get("attempts", 1) > cfg.retry_budget + 1:
                    out = TrialOutcome(
                        "FAILED:budget",
                        expected_total=expected, got_total=got,
                        retries=fl.get("failovers", 0))
                else:
                    out = TrialOutcome(
                        "recovered" if fl.get("failovers") else "ok",
                        expected_total=expected, got_total=got,
                        retries=fl.get("failovers", 0))
            else:
                err = f"{resp.get('error')}: {resp.get('message')}"
                out = TrialOutcome(
                    "detected" if refusal_injected(k, err)
                    else "FAILED:refused",
                    error=err, expected_total=expected)
            rec = {"trial": k, "spec": spec,
                   "fault": "resident-kill",
                   **dataclasses.asdict(out),
                   "verdict": out.verdict,
                   "elapsed_s": round(time.perf_counter() - t0, 3)}
            records.append(rec)
            print(f"resident trial {k:3d} -> {rec['verdict']} "
                  f"({rec['elapsed_s']}s)", flush=True)
            if out.failed:
                failures.append(rec)
                if repro_out:
                    _write_repro(
                        f"{repro_out}_resident_{seed}_{k}.json", rec,
                        seed,
                        f"python -m {_MODULE} --fleet {trials} "
                        f"--fleet-fault resident-kill --seed {seed} "
                        f"--device {dev}")

        # -- the rebuild gate -----------------------------------------
        replaced = router.wait_replaced(victim,
                                        timeout_s=cfg.spawn_timeout_s)
        drain_replace.update(
            replaced=replaced,
            generation=router.replicas[victim].generation)
        if not replaced:
            failures.append({"gate": "drain_replace", **drain_replace})
        holder = None
        deadline = time.monotonic() + cfg.spawn_timeout_s
        while time.monotonic() < deadline:
            holder = (router.stats()["tables"]
                      .get(table, {}).get("holders", {})
                      .get(str(victim)))
            if holder and holder["state"] == "serving":
                break
            time.sleep(0.2)
        rebuild.update(holder=holder,
                       rebuilds_total=router.stats()["rebuilds_total"])
        if not (holder and holder["state"] == "serving"
                and holder["generation"] == generation):
            failures.append({"gate": "rebuild_serving", **rebuild})
        elif replaced:
            # The FENCED replay of a pre-fault signature on the
            # rebuilt image: oracle-exact, correct generation, zero
            # new traces.
            replay = _direct(router.replicas[victim],
                             {**pre_fault_spec,
                              "min_generation": generation})
            rebuild["replay"] = {kk: replay.get(kk) for kk in
                                 ("ok", "error", "message",
                                  "new_traces", "matches")}
            rebuild["replay"]["generation"] = \
                (replay.get("resident") or {}).get("generation")
            if (not replay.get("ok")
                    or replay.get("new_traces") != 0
                    or replay.get("matches")
                    != expected_matches(pre_fault_spec)
                    or rebuild["replay"]["generation"] != generation):
                failures.append({"gate": "rebuilt_replay_warm",
                                 **rebuild})
    finally:
        _close_fleet(router, server, client)

    _keep_or_remove(workdir, failures, "resident soak")
    return {
        "kind": "fleet_soak",
        "schema_version": 1,
        "harness_seed": seed,
        "slice": "fleet_resident",
        "fault": "resident-kill",
        "victim": victim,
        "table": table,
        "generation": generation,
        "replica_ranks": replica_ranks,
        "device": dev,
        "trials": len(records),
        "verdicts": _verdicts(records),
        "failures": len(failures),
        "failure_records": failures,
        "drain_replace": drain_replace,
        "rebuild": rebuild,
        "fleet_stats": router.stats(),
        "records": records,
    }


# -- the soak loop ----------------------------------------------------


def soak(seed: int, trials: int, n_ranks: int = 8,
         corruption: bool = True, only_trial: Optional[int] = None,
         deadline_s: Optional[float] = 300.0,
         repro_out: Optional[str] = None, device=None) -> dict:
    """Run the soak (or one replayed trial); returns the summary
    record and writes a minimal-repro JSON per failed trial. ``device``
    defaults to the GPU (raising without one, before any trial)."""
    dev = _soak_device(device)
    indices = ([only_trial] if only_trial is not None
               else list(range(trials)))
    records, failures = [], []
    for k in indices:
        rec = run_trial(seed, k, n_ranks=n_ranks,
                        corruption=corruption, deadline_s=deadline_s,
                        device=dev)
        records.append(rec)
        line = (f"trial {k:3d} [{rec['config']['mode']:11s}] "
                f"fault={rec['fault']:17s} -> {rec['verdict']} "
                f"({rec['elapsed_s']}s)")
        print(line, flush=True)
        if rec["verdict"].startswith("FAILED"):
            failures.append(rec)
            if repro_out:
                path = repro_out.replace(
                    ".json", f"_{seed}_{k}.json") if repro_out.endswith(
                    ".json") else f"{repro_out}_{seed}_{k}.json"
                _write_repro(path, rec, seed,
                             f"python -m {_MODULE} --seed {seed} "
                             f"--trial {k} --n-ranks {n_ranks} "
                             f"--device {dev.type}"
                             + ("" if corruption else " --no-corruption"))
    return {
        "harness_seed": seed,
        "n_ranks": n_ranks,
        "device": dev.type,
        "trials": len(records),
        "verdicts": _verdicts(records),
        "failures": len(failures),
        "records": records,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trials", type=int, default=25)
    p.add_argument("--seed", type=int, default=42,
                   help="harness seed; every trial derives its own "
                        "rng from (seed, trial) so any trial replays "
                        "exactly (on the same device type)")
    p.add_argument("--trial", type=int, default=None,
                   help="replay ONE trial of this seed (the repro "
                        "workflow)")
    p.add_argument("--n-ranks", type=int, default=8,
                   help="emulated ranks of each trial's communicator")
    p.add_argument("--device", default=None,
                   help="where the trials (and the fleet slices' "
                        "replicas) run: default the GPU (refused "
                        "without one); 'cpu' runs on the CPU")
    p.add_argument("--no-corruption", action="store_true",
                   help="restrict schedules to recoverable faults "
                        "(squeezes/transients) — the control arm")
    p.add_argument("--hier-slice", type=int, default=None,
                   metavar="N",
                   help="instead of the main soak: N hierarchical-"
                        "shuffle trials (shuffle='hierarchical' over "
                        "emulated ranks nested as (slice, chip), fault "
                        "schedules including the cross-slice exchange "
                        "seam, oracle graded with wire digests on)")
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="instead of the main soak: N join trials "
                        "through a 2-replica subprocess fleet behind "
                        "the signature-affinity router "
                        "(service/fleet.py), ONE replica killed/"
                        "hung/corrupted mid-soak — every non-refused "
                        "answer oracle-graded, drain+replace and the "
                        "zero-trace replacement gated")
    p.add_argument("--fleet-fault", default=None,
                   choices=("kill", "hang", "corrupt",
                            "resident-kill"),
                   help="pin the fleet soak's fault (default: drawn "
                        "from the harness seed); resident-kill runs "
                        "the REPLICATED-table slice instead (K=2 "
                        "holders, the table's primary holder "
                        "SIGKILLed mid-soak, manifest rebuild + "
                        "fenced zero-trace replay gated)")
    p.add_argument("--replica-ranks", type=int, default=2,
                   help="emulated ranks of each fleet replica")
    p.add_argument("--tenants", type=int, default=None, metavar="N",
                   help="instead of the main soak: N oracle-graded "
                        "quiet-tenant trials through a 2-replica "
                        "fleet while a noisy tenant floods at ~5x "
                        "its QPS quota and one replica is killed "
                        "mid-soak — the quiet tenant must stay "
                        "exact with ZERO sheds, the noisy tenant "
                        "must be quota-shed, the tuner namespace "
                        "must stay tenant-isolated, and the "
                        "replacement must serve with zero new traces")
    p.add_argument("--tuner-slice", type=int, default=None,
                   metavar="N",
                   help="instead of the main soak: N poisoned-history "
                        "autotuner trials (a history file claims a "
                        "too-small rung; every trial must still grade "
                        "oracle-clean via the retry ladder, and the "
                        "post-run history must record the escalated "
                        "rung)")
    p.add_argument("--trial-deadline-s", type=float, default=300.0,
                   help="hang watchdog per trial (0 disables)")
    p.add_argument("--repro-out", default="chaos_repro.json",
                   help="minimal-repro JSON path stem for failed "
                        "trials")
    p.add_argument("--json-output", default=None,
                   help="write the full soak summary record here")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.trials < 1 or args.n_ranks < 2:
        print("chaos: need --trials >= 1 and --n-ranks >= 2",
              file=sys.stderr)
        return 2
    try:
        _soak_device(args.device)
    except RuntimeError as exc:
        # no fallback to the CPU: a soak runs where it was asked to
        print(f"chaos: {exc} (--device cpu)", file=sys.stderr)
        return 2
    deadline_s = args.trial_deadline_s or None
    if args.tenants:
        summary = fleet_tenant_slice(
            args.seed, args.tenants,
            replica_ranks=args.replica_ranks,
            repro_out=args.repro_out, device=args.device)
    elif args.fleet and args.fleet_fault == "resident-kill":
        summary = fleet_resident_slice(
            args.seed, args.fleet,
            replica_ranks=args.replica_ranks,
            repro_out=args.repro_out, device=args.device)
    elif args.fleet:
        summary = fleet_slice(args.seed, args.fleet,
                              replica_ranks=args.replica_ranks,
                              fault=args.fleet_fault,
                              repro_out=args.repro_out,
                              device=args.device)
    elif args.hier_slice:
        summary = hier_slice(args.seed, args.hier_slice,
                             n_ranks=args.n_ranks,
                             deadline_s=deadline_s,
                             repro_out=args.repro_out,
                             device=args.device)
    elif args.tuner_slice:
        summary = tuner_slice(args.seed, args.tuner_slice,
                              n_ranks=args.n_ranks,
                              deadline_s=deadline_s,
                              repro_out=args.repro_out,
                              device=args.device)
    else:
        summary = soak(
            args.seed, args.trials, n_ranks=args.n_ranks,
            corruption=not args.no_corruption,
            only_trial=args.trial,
            deadline_s=deadline_s,
            repro_out=args.repro_out, device=args.device,
        )
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "records"}))
    if args.json_output:
        with open(args.json_output, "w") as f:
            json.dump(summary, f, indent=2)
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
