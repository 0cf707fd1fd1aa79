"""Benchmark drivers of the port, and what they share: the record stamp,
rank-0-only reporting, the telemetry and guard flags with the guarded
run, and the refusal of the JAX drivers' flags the port does not have
(port of ``distributed_join_tpu/benchmarks/__init__.py``: ``load_record``
:37, ``stamp_record`` :20, ``report`` :59, ``run_guarded`` :81-185,
``maybe_diagnose`` :187-216, ``maybe_stage_profile`` and
``maybe_query_stage_profile`` :275-345, ``maybe_history`` :360-419,
``write_explain`` and ``explain_summary`` :219-274,
``collect_join_metrics`` :745, ``collect_integrity`` :705-741,
``add_telemetry_args`` :431-490, ``--verify-integrity``,
``--guard-deadline-s`` and ``--auto-tune`` of ``add_robustness_args``
:492-575, and the autotuner's driver seam ``resolve_tuner`` and
``tuned_driver_record`` :608-652).

Every driver's ``main`` runs its body through :func:`run_guarded`:
``--telemetry[=DIR]``, ``--trace``, ``--diagnose``, ``--history FILE``
and ``--stage-profile`` open the telemetry session around the run
(``--trace`` adds a ``torch.profiler`` device trace under
``DIR/device_trace/``; ``--diagnose`` leaves ``DIR/diagnosis.json`` and a
printed report after it, :func:`maybe_diagnose`), and
``--guard-deadline-s`` (or ``DJTPU_GUARD_DEADLINE_S``) bounds the whole
run with the watchdog.
A failure leaves a one-line JSON failure record; a hang exits hard with
rc 1, a handshake outage with rc 0, as in the JAX package. With a
session on, a driver runs one untimed metrics join after its timed loop
(:func:`collect_join_metrics`), so the record's ``telemetry.metrics``
holds the device counters of one join on the unshifted tables;
``--explain`` writes the plan of the timed program (:func:`write_explain`)
and puts its summary in the record, and ``--stage-profile [N]`` profiles
the timed program stage by stage (:func:`maybe_stage_profile`, an
operator at a time on the query path) into ``DIR/stageprofile.json``.
``--verify-integrity`` runs one untimed join with the wire digests after
the timed loop (:func:`collect_integrity`): the record's ``"integrity"``
is its report, and a mismatch fails the run rather than report a number
computed from corrupt rows.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.parallel.bootstrap import (
    BootstrapError,
    is_coordinator,
    maybe_initialize_from_env,
    process_id,
)
from distributed_join_tpu_torch.parallel.communicator import (
    ProcessGroupCommunicator,
)
from distributed_join_tpu_torch.parallel.watchdog import (
    HangError,
    call_with_deadline,
    resolve_guard_deadline,
)
from distributed_join_tpu_torch.table import Table

# The JAX package's record layout version, whose optional "telemetry"
# block is the session summary.
SCHEMA_VERSION = 2

# Flags of every JAX driver and of its launcher that wait for other parts
# of the port, each naming what it waits for.
UNPORTED_FLAGS = {
    "--chaos-seed": "chaos injection (parallel/chaos.py, whose plans "
                    "draw the corruption modes; ROADMAP A7)",
}


def load_record(source) -> dict:
    """A driver or bench JSON record read back (``stamp_record``'s
    inverse; JAX :37): ``source`` a path or a parsed dict. A record
    without ``schema_version`` is stamped version 1 with rank 0, as the
    JAX package stamps its early records."""
    if isinstance(source, dict):
        record = dict(source)
    else:
        with open(source) as f:
            record = json.load(f)
        if not isinstance(record, dict):
            raise ValueError(f"{source}: not a JSON record object")
    record.setdefault("schema_version", 1)
    record.setdefault("rank", 0)
    return record


def refuse_flags(parser, argv, refused: dict) -> None:
    """``parser.error`` naming the first flag of ``argv`` in ``refused``
    (flag -> what the port lacks)."""
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in refused:
            parser.error(f"{flag}: {refused[flag]} is not part of the port")


def rank_device(comm, device=None) -> torch.device:
    """Where a driver's tensors live: ``device`` when given, else the
    rank's own device under a process group (its card under NCCL, the
    CPU under gloo), else the GPU (``resolve_device``)."""
    if device is None and isinstance(comm, ProcessGroupCommunicator):
        return comm.device
    return resolve_device(device)


def global_table(comm, table: Table) -> Table:
    """Every rank's rows of a row-sharded result. Under a process group
    ``spmd`` hands each process its own rank's part, so the parts are
    all-gathered (every rank's part has the same capacity); an
    in-process communicator's result holds every rank's rows already."""
    if not isinstance(comm, ProcessGroupCommunicator):
        return table
    return Table({n: comm.all_gather(c) for n, c in table.columns.items()},
                 comm.all_gather(table.valid))


def stamp_record(record: dict) -> dict:
    """``schema_version`` and ``rank`` on every record and, iff a
    telemetry session is on, its summary under ``"telemetry"`` (key
    presence is the signal; its ``metrics`` the device counters folded
    in by :func:`collect_join_metrics`). Mutated and returned."""
    record.setdefault("schema_version", SCHEMA_VERSION)
    record.setdefault("rank", process_id())
    if telemetry.enabled():
        record.setdefault("telemetry", telemetry.summary())
    return record


def collect_join_metrics(comm, build, probe, join_opts: dict,
                         attempt: int = 0):
    """One untimed join with the metrics tape on, on the unshifted
    tables, after the timed loop (JAX :745): its counters folded into the
    session (``telemetry.emit_metrics``) and returned. The timed loop
    stays the tape-off program. None, and no join, without a session."""
    if not telemetry.enabled():
        return None
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_distributed_join,
    )

    with telemetry.span("collect_metrics") as sp:
        res = make_distributed_join(
            comm, with_metrics=True,
            metrics_static={"retry_attempt_max": attempt},
            **join_opts)(build, probe)
        d = telemetry.emit_metrics(res.telemetry)
        if sp is not None:
            sp.sync_on(res.total)
    return d


def add_integrity_arg(parser) -> None:
    """``--verify-integrity`` (JAX ``add_robustness_args`` :496-503)."""
    parser.add_argument(
        "--verify-integrity", action="store_true",
        help="verify the shuffle wire with the per-(src, dst) digests "
             "(parallel/integrity.py): one extra untimed verified join "
             "after the timed loop (which stays the plain program); a "
             "mismatch raises IntegrityError instead of reporting a "
             "number computed from corrupt rows. The verdict lands in "
             "the JSON record under 'integrity'")


def collect_integrity(comm, build, probe, join_opts: dict,
                      raise_on_mismatch: bool = True):
    """The drivers' ``--verify-integrity`` (JAX :705-741): ONE join with
    the wire digests on the unshifted tables, untimed, after the timed
    loop, and its report's record. A mismatch raises
    ``integrity.IntegrityError`` unless ``raise_on_mismatch`` is off; an
    overflowed join is not checked, and the record says so. A
    fault-injecting communicator's corruption budget is rearmed first:
    the timed program spent it, and a clean verification would bless
    numbers the corruption touched."""
    from distributed_join_tpu_torch.parallel import integrity
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_distributed_join,
    )

    rearm = getattr(comm, "rearm_corruption", None)
    if rearm is not None:
        rearm()
    with telemetry.span("verify_integrity") as sp:
        res = make_distributed_join(comm, with_metrics=False,
                                    with_integrity=True,
                                    **join_opts)(build, probe)
        if sp is not None:
            sp.sync_on(res.total)
    if bool(res.overflow):
        return {"ok": None, "skipped": "overflow", "checked_pairs": 0}
    report = integrity.verify_join_result(res)
    if not report.ok and raise_on_mismatch:
        raise integrity.IntegrityError(report)
    return report.as_record()


def write_explain(args, explain_record, label: str = ""):
    """The drivers' ``--explain`` sink: write the explain record (a
    ``JoinPlan.explain_record()``, an ``explain_query`` record or a
    ``build_exchange_plan`` dict) as ``explain[.label].json`` in the
    telemetry session's directory (the working directory without one),
    keys sorted, no timestamps: the same query spec writes the same
    bytes. Rank 0 only; returns the path (None elsewhere)."""
    if not is_coordinator():
        return None
    s = telemetry.sink()
    out_dir = s.dir if s is not None else "."
    path = os.path.join(out_dir, f"explain.{label}.json" if label
                        else "explain.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(explain_record, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    plan = explain_record.get("plan", {})
    digest = plan.get("signature_digest") or explain_record.get(
        "digest") or "?"
    print(f"explain: plan {digest[:16]} -> {path}", file=sys.stderr)
    return path


def explain_summary(explain_record) -> dict:
    """The compact prediction block a record carries under ``explain``:
    the plan digest, the predicted wall, whether the wire bytes are
    exact, and the predicted bytes a side (what ``telemetry.history``
    grades a measured wall against)."""
    plan = explain_record.get("plan", {})
    cost = explain_record.get("cost", {})
    wire = plan.get("wire", {})
    predicted = {side: wire.get(side, {}).get("bytes_total")
                 for side in ("build", "probe") if side in wire}
    if not predicted and "bytes_total" in wire:
        predicted = {"total": wire["bytes_total"]}   # exchange plan
    return {
        "plan_digest": plan.get("signature_digest"),
        "predicted_wall_s": cost.get("total_s"),
        "wire_exact": wire.get("exact"),
        "predicted_wire_bytes": predicted,
    }


def add_explain_arg(parser) -> None:
    """``--explain`` (JAX ``add_telemetry_args``)."""
    parser.add_argument(
        "--explain", action="store_true",
        help="write the resolved plan of the timed program (capacities, "
             "wire bytes, memory, the cost model's prediction, the "
             "program-cache digest) to explain.json in the telemetry "
             "directory (else the working directory) and its summary "
             "into the record; host arithmetic, no extra join")


def report(record: dict, json_output: str | None,
           headline: str | None = None) -> None:
    """Stamp ``record``; on rank 0 only, print the headline (if any) and
    the record as one JSON line, and write it to ``json_output``. Other
    ranks print nothing to stdout, so the line a caller parses is never
    interleaved."""
    stamp_record(record)
    if not is_coordinator():
        return
    line = json.dumps(record)
    if json_output:
        with open(json_output, "w") as f:
            f.write(line + "\n")
    if headline:
        print(headline)
    print(line, flush=True)


def resolve_sort_mode(args, n_ranks: int, k: int, b_local: int,
                      p_local: int, shuffle_factor: float, shuffle: str,
                      n_slices: int = 1, dcn_codec: str = "auto",
                      compression_bits=None, kernel_config=None) -> str:
    """The drivers' ``--sort-mode`` (JAX :654-691): ``flat`` and
    ``segmented`` pass as they are (the step refuses what does not
    combine); ``auto`` is ``segmented`` exactly when
    ``resolve_sort_segments`` would segment this shape and the
    combination runs: never over the ragged or compressed wire, with
    kernel flags, or on a multi-slice mesh with the DCN codec on. Unset
    is ``flat``."""
    from distributed_join_tpu_torch.ops.segmented import (
        resolve_sort_segments,
    )
    from distributed_join_tpu_torch.planning.cost import resolve_dcn_codec

    mode = getattr(args, "sort_mode", None) or "flat"
    if mode != "auto":
        return mode
    if (shuffle == "ragged" or n_ranks * k <= 1
            or compression_bits is not None or kernel_config is not None):
        return "flat"
    if (shuffle == "hierarchical" and n_slices > 1
            and resolve_dcn_codec(dcn_codec or "auto")):
        return "flat"
    segs = resolve_sort_segments(getattr(args, "sort_segments", None),
                                 max(b_local, p_local), n_ranks, k,
                                 shuffle_factor)
    return "segmented" if segs > 1 else "flat"


def add_telemetry_args(parser) -> None:
    """The shared telemetry flags (JAX :431-490); :func:`run_guarded`
    consumes them, and a driver's ``run`` ``--stage-profile``."""
    parser.add_argument(
        "--telemetry", nargs="?", const="telemetry", default=None,
        metavar="DIR",
        help="activate the telemetry session: JSONL event log and "
             "Perfetto-loadable Chrome trace per rank under DIR (default "
             "./telemetry), the session summary in the JSON record. Off "
             "changes nothing on the join's path")
    parser.add_argument(
        "--trace", action="store_true",
        help="also record a torch.profiler device trace (CPU and CUDA "
             "activity) of the run under DIR/device_trace/; the spans' "
             "names line up with the kernels in it. Implies --telemetry; "
             "not with --profile (two profiler sessions cannot nest)")
    parser.add_argument(
        "--diagnose", action="store_true",
        help="at the end of the run, read the telemetry directory back "
             "(telemetry/analyze.py): straggler, key-skew, headroom and "
             "wire indicators with the knobs that relieve them, written "
             "to DIR/diagnosis.json and printed on rank 0. Implies "
             "--telemetry")
    parser.add_argument(
        "--history", default=None, metavar="FILE",
        help="at the end of the run, append one workload-history entry "
             "(telemetry/history.py: workload signature, outcome, "
             "resolved retry knobs, wall time) to FILE. Implies "
             "--telemetry; rank 0 only")
    parser.add_argument(
        "--stage-profile", nargs="?", const=3, type=int, default=None,
        metavar="N",
        help="after the timed region, profile the timed program stage by "
             "stage (telemetry/stageprof.py): partition, shuffle and join "
             "each its own program at the plan's capacities, timed with "
             "a barrier, N repeats (default 3), the median, beside the "
             "monolithic step; the difference is the measured overlap "
             "credit. Writes DIR/stageprofile.json (graded by "
             "`telemetry.analyze stages`) and the summary into the "
             "record. The timed loop is unchanged. Implies --telemetry")


def add_guard_arg(parser) -> None:
    """``--guard-deadline-s`` (JAX ``add_robustness_args`` :492-575)."""
    parser.add_argument(
        "--guard-deadline-s", type=float, default=None, metavar="S",
        help="run the whole benchmark under the hang watchdog "
             "(parallel/watchdog.py): a run that does not return within S "
             "seconds becomes a HangError record and exits with rc 1. "
             "Default: DJTPU_GUARD_DEADLINE_S, else unguarded; 0 = "
             "unguarded")


def add_auto_tune_arg(parser) -> None:
    """``--auto-tune[=HISTORY]`` (JAX ``add_robustness_args``)."""
    parser.add_argument(
        "--auto-tune", nargs="?", const="", default=None,
        metavar="HISTORY",
        help="consult the history-driven autotuner (planning/tuner.py) "
             "before sizing: a repeat workload whose retry ladder "
             "escalated before starts at the final rung it resolved to, "
             "with no overflow rebuilds. HISTORY is the workload-history "
             "store to read (bare flag: --history FILE on the drivers, "
             "the service's own store on the daemon). A workload's first "
             "run stays the static resolution")


def resolve_tuner(args):
    """The drivers' ``--auto-tune[=HISTORY]`` (JAX :608-625): a
    ``planning.tuner.JoinTuner`` over the named store (bare flag: the
    run's ``--history FILE``), or None with the flag off. A missing
    store file is an empty tuner; no path at all is a usage error."""
    val = getattr(args, "auto_tune", None)
    if val is None:
        return None
    path = val or getattr(args, "history", None)
    if not path:
        raise SystemExit(
            "--auto-tune needs a workload-history store: pass "
            "--auto-tune HISTORY or pair the bare flag with "
            "--history FILE")
    from distributed_join_tpu_torch.planning.tuner import JoinTuner

    return JoinTuner(path)


def tuned_driver_record(tuner, workload: dict):
    """Capacity pre-sizing on the driver path (JAX :627-652): the
    workload identity looked up in the tuner, returning ``(sizing
    overrides, rung, record)``: the knobs for the driver's ladder, the
    absolute rung label to seed it with, and the block the record
    carries under ``tuned``, which holds the pre-tuned ``workload`` so
    that ``history.run_entry`` hashes the run to the signature the
    lookup used. Structural knobs are not applied here: the driver store
    keys a run by its flags (``history.WORKLOAD_KEYS``, ``shuffle`` and
    ``skew_threshold`` among them), where a mode switch would fork the
    signature away from its own history."""
    from distributed_join_tpu_torch.telemetry.history import run_signature

    sig = run_signature(workload)
    cfg = tuner.recommend(sig)
    rec = cfg.as_record()
    rec["workload"] = workload
    rec["applied"] = dict(cfg.sizing)
    rec.pop("structural", None)
    return dict(cfg.sizing), cfg.rung, rec


def refuse_trace_with_profile(parser, args) -> None:
    """``--trace`` and a driver's ``--profile`` both open a
    ``torch.profiler`` session, and two sessions cannot nest."""
    if getattr(args, "trace", False) and getattr(args, "profile", 0):
        parser.error("--trace with --profile: both open a torch.profiler "
                     "session, and two sessions cannot nest; pick one")


# Launcher flags handed on to every process's command, as (flag, dest,
# takes a value): the JAX launcher's FORWARDED_CHILD_FLAGS (JAX :559) that
# the port has.
FORWARDED_CHILD_FLAGS = (
    ("--slices", "slices", True),
    ("--telemetry", "telemetry", True),
    ("--trace", "trace", False),
    ("--diagnose", "diagnose", False),
    ("--history", "history", True),
    ("--stage-profile", "stage_profile", True),
    ("--explain", "explain", False),
    ("--sort-mode", "sort_mode", True),
    ("--sort-segments", "sort_segments", True),
    ("--auto-tune", "auto_tune", True),
    ("--verify-integrity", "verify_integrity", False),
    ("--guard-deadline-s", "guard_deadline_s", True),
)


def run_guarded(body, args, benchmark: str) -> int:
    """Run a driver's ``body(args)`` (which reports its own record and
    returns it) under the contract every driver shares (JAX :81-185):

    - the telemetry session of ``--telemetry``/``--trace``/``--history``
      opens first; then, inside the guarded call, the handshake of a
      launched process (``maybe_initialize_from_env``), the session's
      rank, and the device trace, which starts and stops on the thread
      that runs the body;
    - ``--guard-deadline-s`` runs all of that under the watchdog;
    - any failure prints a one-line JSON failure record (and writes it to
      ``--json-output``). A ``BootstrapError`` (an outage, not a result)
      exits 0 and a ``HangError`` exits 1, both hard (``os._exit``: the
      wedged worker may hold locks), after the telemetry files and the
      history entry are written; any other failure re-raises;
    - the session is finalized, then ``--diagnose`` reads it back
      (:func:`maybe_diagnose`; not after an outage or a hang, which
      leave no settled join to read), and ``--history`` is appended
      either way.

    Returns 0."""
    telemetry.configure_from_args(args)
    guard_s = resolve_guard_deadline(args)
    result = None
    failure_record = None

    def guarded():
        maybe_initialize_from_env()
        telemetry.refresh_rank()
        telemetry.maybe_start_device_trace()
        try:
            return body(args)
        finally:
            telemetry.stop_device_trace()

    try:
        if guard_s is None:
            result = guarded()
        else:
            result = call_with_deadline(guarded, guard_s,
                                        what=f"{benchmark} run")
        return 0
    except Exception as exc:  # the failure record is the contract
        is_bootstrap = isinstance(exc, BootstrapError)
        is_hang = isinstance(exc, HangError)
        record = stamp_record({
            "benchmark": benchmark,
            "error": f"{type(exc).__name__}: {exc}",
            "failure": (exc.record() if (is_bootstrap or is_hang) else {
                "error": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exc().splitlines()[-3:],
            }),
        })
        failure_record = record
        print(json.dumps(record), flush=True)
        json_output = getattr(args, "json_output", None)
        if json_output:
            try:
                with open(json_output, "w") as f:
                    json.dump(record, f, indent=2)
            except OSError as io_exc:
                print(f"note: could not write {json_output}: {io_exc}",
                      file=sys.stderr)
        if is_bootstrap or is_hang:
            maybe_history(args, telemetry.finalize(), record=record)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0 if is_bootstrap else 1)
        raise
    finally:
        # the traces and the summary even on failure: a run that died is
        # the run whose trace is wanted
        summary = telemetry.finalize()
        maybe_diagnose(args, summary, record=result)
        maybe_history(args, summary,
                      record=result if isinstance(result, dict)
                      else failure_record)


def maybe_diagnose(args, summary, record=None) -> None:
    """``--diagnose`` (JAX :187-216): read the finalized session's
    directory back through ``telemetry.analyze`` and leave
    ``diagnosis.json`` and the report, printed to stderr (the record
    stays the last line of stdout). ``record``, the run's own
    record where it produced one, gives the workload's dtypes and wire
    to the wire-efficiency indicator. Rank 0 only; a peer still closing
    its files may miss its last events (``analyze diagnose DIR`` later
    gives the settled view). An analysis failure never masks the run's
    own outcome."""
    if not getattr(args, "diagnose", False) or summary is None:
        return
    if not is_coordinator():
        return
    try:
        from distributed_join_tpu_torch.telemetry.analyze import (
            diagnose_run,
            format_report,
        )

        diag = diagnose_run(summary["dir"],
                            record=record if isinstance(record, dict)
                            else None)
        print(format_report(diag), file=sys.stderr)
    except Exception as exc:  # noqa: BLE001 — the diagnosis is best effort
        print(f"note: --diagnose failed: {type(exc).__name__}: {exc}",
              file=sys.stderr)


def _write_stage_record(rec: dict, name: str) -> str:
    """``rec`` as ``name`` in the session's directory (the working
    directory without one), keys sorted."""
    s = telemetry.sink()
    path = os.path.join(s.dir if s is not None else ".", name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def maybe_stage_profile(args, comm, build, probe, join_opts: dict):
    """``--stage-profile N`` (JAX :275-310): profile the timed program
    stage by stage (``telemetry.stageprof.profile_join_stages``) on the
    run's own tables, after the timed region, as
    :func:`collect_join_metrics` runs; draw its tracks into the trace
    (``telemetry.stage_profile``), write ``stageprofile.json`` and print
    the table (rank 0), and return the summary the record carries under
    ``stage_profile`` (``history.run_entry`` keeps it as the entry's
    ``stages``). None with the flag off. Every rank runs the
    programs."""
    repeats = getattr(args, "stage_profile", None)
    if not repeats:
        return None
    from distributed_join_tpu_torch.telemetry import stageprof

    opts = dict(join_opts)
    key = opts.pop("key", "key")
    prof = stageprof.profile_join_stages(
        comm, build, probe, key=key, repeats=int(repeats), **opts)
    rec = prof.as_record()
    telemetry.stage_profile(rec)
    if is_coordinator():
        path = _write_stage_record(rec, "stageprofile.json")
        print(prof.format(), file=sys.stderr)
        print(f"stage profile: plan {rec['plan_digest'][:16]} -> {path}",
              file=sys.stderr)
    return prof.summary()


def maybe_query_stage_profile(args, comm, plan, tables, defaults: dict):
    """``--stage-profile N`` on the query path (JAX :312-345): each
    operator its own program against the one query program
    (``telemetry.stageprof.profile_query_stages``), after the timed
    region; ``query_stageprofile.json`` in the session's directory, the
    trace's tracks, and the summary (op ids as the stage keys) for the
    record. None with the flag off."""
    repeats = getattr(args, "stage_profile", None)
    if not repeats:
        return None
    from distributed_join_tpu_torch.telemetry import stageprof

    prof = stageprof.profile_query_stages(
        comm, plan, tables, repeats=int(repeats), **dict(defaults))
    rec = prof.as_record()
    telemetry.stage_profile(rec)
    if is_coordinator():
        path = _write_stage_record(rec, "query_stageprofile.json")
        print(prof.format(), file=sys.stderr)
        print(f"query stage profile: plan {rec['plan_digest'][:16]} "
              f"-> {path}", file=sys.stderr)
    return prof.summary()


def maybe_history(args, summary, record=None) -> None:
    """``--history FILE``: append one ``history.run_entry`` line for the
    run (rank 0 only; best effort, as in the JAX package :360-419). A
    failure record is filed under the workload its flags name, so a
    failed run shares its healthy runs' signature."""
    path = getattr(args, "history", None)
    if not path or not isinstance(record, dict) or not is_coordinator():
        return
    from distributed_join_tpu_torch.telemetry import history

    try:
        record = dict(record)
        for key in history.WORKLOAD_KEYS:
            if record.get(key) is None:
                val = getattr(args, key, None)
                if val is not None:
                    record[key] = val
        if record.get("n_ranks") is None:
            import torch.distributed as dist

            record["n_ranks"] = (dist.get_world_size()
                                 if dist.is_initialized() else 1)
        device = str(record.get("device") or "")
        platform = device.split(":")[0] or (
            "cuda" if torch.cuda.is_available() else "cpu")
        store = history.WorkloadHistory(path)
        try:
            store.append(history.run_entry(
                record=record, summary=summary, platform=platform))
        finally:
            store.close()
    except Exception as exc:  # noqa: BLE001 — history is best effort
        print(f"note: --history failed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
