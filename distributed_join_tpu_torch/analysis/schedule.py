"""Level-2 joinlint over the port: the recorded collective schedule.

Port of ``distributed_join_tpu/analysis/schedule.py``. The JAX package
traces its programs and reads each jaxpr's collective primitives; the
port runs eagerly and has no trace, so the schedule is RECORDED: a
:class:`RecordingCommunicator` (an ``EmulatedCommunicator`` of
:data:`N_RANKS` ranks) logs each rank's calls of the ``Communicator``'s
cross-rank methods (:data:`CROSS_RANK_METHODS`) while one of the key
programs (:func:`key_programs`, the JAX package's fourteen) runs on
small seeded tables. A call made inside another recorded call (the
default ``all_gather_counts`` calls ``all_gather``) is not logged again:
the schedule is what the program asks of the communicator. Three checks:

1. **every rank's sequence is identical** — the SPMD invariant itself;
   on real ranks a divergence deadlocks (the counterpart of the JAX
   check that no ``cond`` carries branch-divergent collectives);
2. **golden schedule** — the sequence equals the committed
   ``results/schedules_torch/<program>.json`` (the JAX schema: the
   ``collectives``, ``n_ranks``, ``program``, ``schema_version`` and
   ``telemetry_off`` keys). Intentional changes regenerate with
   ``analysis.lint --update-schedules`` and show up in review;
3. **a telemetry-off program builds no metrics tape** — the counterpart
   of "no host callback in a telemetry-off program": a ``MetricsTape``
   is how a step hands device values to the host, as JAX's callbacks
   do. Spans and events are not part of the check: they are recorded by
   the telemetry session around eager host code, for a telemetry-off
   step as for a metrics step, and are inert without a session, so they
   do not tell the two programs apart. Regeneration cannot bless a
   violation.

The port splits some wires into other calls than the JAX package's
primitives (:data:`JAX_DIFFERENCES`); the other programs' sequences
equal the JAX package's goldens in ``results/schedules/`` name for name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
)
from distributed_join_tpu_torch.table import Table

SCHEDULE_SCHEMA_VERSION = 1
DEFAULT_SCHEDULE_DIR = os.path.join("results", "schedules_torch")
JAX_SCHEDULE_DIR = os.path.join("results", "schedules")
N_RANKS = 8
ROWS = 1024  # global rows per side: 128 a rank on 8 emulated ranks
SEED = 7

# The Communicator's cross-rank methods (parallel/communicator.py).
CROSS_RANK_METHODS = (
    "all_to_all", "all_gather", "all_gather_counts", "psum",
    "ppermute_all_to_all", "all_to_all_chip", "all_to_all_slice",
    "ragged_all_to_all", "host_ints", "host_max", "barrier",
)

# Programs whose port schedule differs from the JAX golden, and why: a
# wire the JAX package lowers to other primitives. Every other program's
# sequence equals the JAX golden.
JAX_DIFFERENCES = {
    "join_step_ragged": (
        "the JAX CPU mesh emulates ragged_all_to_all by all-gathers (18 x "
        "all_gather); the port gathers each side's plan (all_gather_counts), "
        "reads both plans to the host once (host_ints) and calls "
        "ragged_all_to_all a column"),
    "join_step_ppermute": (
        "JAX lowers the chain to one ppermute a step and column (30 x "
        "ppermute); the port calls ppermute_all_to_all once a column, its "
        "counts riding all_to_all"),
    "join_step_hier_2x4": (
        "JAX emits every tier's exchange as an all_to_all over an axis; "
        "the port names the two tiers (all_to_all_chip, all_to_all_slice)"),
}


# -- recording ----------------------------------------------------------


def _recorded(name: str):
    def method(self, *args, **kwargs):
        depth = getattr(self._rec, "depth", 0)
        if depth == 0:
            self._log(name)
        self._rec.depth = depth + 1
        try:
            return getattr(super(RecordingCommunicator, self), name)(
                *args, **kwargs)
        finally:
            self._rec.depth = depth

    method.__name__ = name
    return method


class RecordingCommunicator(EmulatedCommunicator):
    """``EmulatedCommunicator`` that logs each rank's calls of
    :data:`CROSS_RANK_METHODS`, outermost calls only. ``calls`` maps a
    rank to its sequence; calls outside ``spmd`` log under ``"host"``."""

    def __init__(self, n_ranks: int, n_slices: int = 1):
        super().__init__(n_ranks, n_slices=n_slices)
        self._rec = threading.local()
        self._calls_lock = threading.Lock()
        self.calls: Dict = {}

    def _log(self, name: str) -> None:
        rank = getattr(self._local, "rank", None)
        with self._calls_lock:
            self.calls.setdefault("host" if rank is None else rank,
                                  []).append(name)

    def reset(self) -> None:
        with self._calls_lock:
            self.calls = {}


for _name in CROSS_RANK_METHODS:
    setattr(RecordingCommunicator, _name, _recorded(_name))


@contextlib.contextmanager
def telemetry_probe():
    """Count the metrics tapes built while the block runs (every
    thread): ``{"tapes": n}``."""
    from distributed_join_tpu_torch.telemetry import metrics

    counts = {"tapes": 0}
    lock = threading.Lock()
    orig_tape = metrics.MetricsTape.__init__

    def tape_init(self, *a, **k):
        with lock:
            counts["tapes"] += 1
        return orig_tape(self, *a, **k)

    metrics.MetricsTape.__init__ = tape_init
    try:
        yield counts
    finally:
        metrics.MetricsTape.__init__ = orig_tape


# -- the key programs ---------------------------------------------------


def _table(cols, device, seed: int, rows: int = ROWS):
    """A seeded table of ``rows`` rows: ``cols`` is (name, dtype, high)
    triples; values uniform in [0, high), every row valid."""
    rng = np.random.default_rng(seed)
    return Table.from_numpy({nm: rng.integers(0, high, rows).astype(dt)
                             for nm, dt, high in cols},
                            np.ones(rows, dtype=bool), device=device)


def _join_tables(device):
    b = _table((("key", "int64", ROWS), ("build_payload", "int32", 1000)),
               device, SEED)
    p = _table((("key", "int64", 2 * ROWS), ("probe_payload", "int32", 1000)),
               device, SEED + 1)
    return b, p


def _q3_tables(device):
    """customer, orders, lineitem with the Q3 plan's columns (the JAX
    package's abstract tables)."""
    n = ROWS
    customer = _table((("custkey", "int64", n // 4),
                       ("c_acctbal", "int64", 10_000)), device, SEED + 2)
    orders = _table((("custkey", "int64", n // 4),
                     ("orderkey", "int64", n),
                     ("o_orderdate", "int32", 2_500)), device, SEED + 3)
    lineitem = _table((("orderkey", "int64", n),
                       ("l_extendedprice", "int64", 100_000)),
                      device, SEED + 4)
    return customer, orders, lineitem


@dataclasses.dataclass
class Program:
    """One key program: ``run(comm)`` drives it once on ``comm`` (a
    :class:`RecordingCommunicator` of ``n_slices`` slices); ``setup``,
    where given, runs first and is not recorded."""

    run: object
    telemetry_off: bool = True
    n_slices: int = 1
    setup: object = None


def key_programs(device="cpu") -> Dict[str, Program]:
    """name -> :class:`Program` for the fourteen programs the JAX
    package's schedule check guards, on seeded tables on ``device``."""
    from distributed_join_tpu_torch.ops.aggregate import AggregateSpec
    from distributed_join_tpu_torch.parallel.distributed_join import (
        JOIN_METRICS_SHARDED_OUT,
        JOIN_SHARDED_OUT,
        make_join_step,
        make_probe_join_step,
    )
    from distributed_join_tpu_torch.parallel.query_exec import (
        make_query_step,
        query_sharded_out,
    )
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    from distributed_join_tpu_torch.service.resident import (
        PREP_SHARDED_OUT,
        make_resident_prep_step,
    )

    build, probe = _join_tables(device)
    payloads = dict(build_payload=["build_payload"],
                    probe_payload=["probe_payload"])

    def join(metrics=False, **opts):
        def run(comm):
            out = JOIN_METRICS_SHARDED_OUT if metrics else JOIN_SHARDED_OUT
            return comm.spmd(make_join_step(comm, **opts),
                             sharded_out=out)(build, probe)
        return run

    progs = {}
    for mode in ("padded", "ragged", "ppermute"):
        progs[f"join_step_{mode}"] = Program(join(shuffle=mode, **payloads))
    progs["join_step_metrics"] = Program(
        join(metrics=True, with_metrics=True, **payloads),
        telemetry_off=False)
    progs["join_step_skew"] = Program(join(skew_threshold=0.2, **payloads))
    for join_type in ("left", "full_outer", "anti"):
        pl = (dict(probe_payload=["probe_payload"])
              if join_type == "anti" else payloads)
        progs[f"join_step_{join_type}"] = Program(
            join(join_type=join_type, **pl))
    progs["join_step_segmented"] = Program(
        join(sort_mode="segmented", sort_segments=8, **payloads))
    agg_key = AggregateSpec.of(
        "key", [("sum", "probe_payload", "probe_sum"),
                ("count", None, "n_rows")])
    progs["join_step_agg_key"] = Program(join(aggregate=agg_key))
    agg_probe = AggregateSpec.of(
        "probe_payload", [("sum", "build_payload", "build_sum"),
                          ("count", None, "n_rows")])
    progs["join_step_agg_probe"] = Program(join(aggregate=agg_probe))

    # the probe-only step against a resident build: the build is
    # registered (partitioned, shuffled and key-sorted) first, unrecorded
    resident = {}

    def prep(comm):
        # room for the probe's whole shuffle receive block
        rows = 2 * ROWS // comm.n_ranks
        step = make_resident_prep_step(comm, resident_rows_per_rank=rows)
        resident["run"] = comm.spmd(step, sharded_out=PREP_SHARDED_OUT)(
            build)[0]

    def probe_only(comm):
        step = make_probe_join_step(comm, **payloads)
        return comm.spmd(step, sharded_out=JOIN_SHARDED_OUT)(
            resident["run"], probe)

    progs["probe_join_step"] = Program(probe_only, setup=prep)
    progs["join_step_hier_2x4"] = Program(
        join(shuffle="hierarchical", **payloads), n_slices=2)
    q3 = tpch_query_plan("q3")
    q3_tables = _q3_tables(device)

    def query(comm):
        return comm.spmd(make_query_step(comm, q3),
                         sharded_out=query_sharded_out(q3))(*q3_tables)

    progs["query_plan_q3"] = Program(query)
    return progs


@dataclasses.dataclass
class ProgramSchedule:
    """One recorded program's schedule facts."""

    program: str
    n_ranks: int
    telemetry_off: bool
    collectives: List[str]         # rank 0's sequence
    rank_sequences: Dict           # rank -> sequence ("host": outside spmd)
    telemetry: Dict                # tapes built while it ran

    def golden(self) -> dict:
        return {
            "schema_version": SCHEDULE_SCHEMA_VERSION,
            "program": self.program,
            "n_ranks": self.n_ranks,
            "telemetry_off": self.telemetry_off,
            "collectives": self.collectives,
        }


def record_program(name: str, prog: Program) -> ProgramSchedule:
    """Run one program over a fresh :class:`RecordingCommunicator` with
    no telemetry session, and collect its schedule facts."""
    comm = RecordingCommunicator(N_RANKS, n_slices=prog.n_slices)
    if prog.setup is not None:
        prog.setup(comm)
    comm.reset()
    active = telemetry._active
    telemetry._active = None   # its spans stay out of a caller's session
    try:
        with telemetry_probe() as counts:
            prog.run(comm)
    finally:
        telemetry._active = active
    seqs = {r: list(s) for r, s in comm.calls.items()}
    return ProgramSchedule(
        program=name, n_ranks=N_RANKS,
        telemetry_off=bool(prog.telemetry_off),
        collectives=list(seqs.get(0, [])), rank_sequences=seqs,
        telemetry=dict(counts))


# -- golden registry + the check ----------------------------------------


def golden_path(name: str, schedule_dir: Optional[str] = None) -> str:
    return os.path.join(schedule_dir or DEFAULT_SCHEDULE_DIR, f"{name}.json")


def write_golden(sched: ProgramSchedule,
                 schedule_dir: Optional[str] = None) -> str:
    d = schedule_dir or DEFAULT_SCHEDULE_DIR
    os.makedirs(d, exist_ok=True)
    path = golden_path(sched.program, d)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(sched.golden(), f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def _diff_sequences(want: List[str], got: List[str]) -> str:
    """A readable first-divergence diff of two call sequences."""
    n = min(len(want), len(got))
    for i in range(n):
        if want[i] != got[i]:
            return (f"first divergence at position {i}: committed "
                    f"{want[i]!r} vs recorded {got[i]!r} "
                    f"(committed has {len(want)} calls, recorded "
                    f"{len(got)})")
    return (f"committed has {len(want)} calls, recorded has {len(got)}; "
            f"the first {n} agree — a call was "
            + ("dropped" if len(got) < len(want) else "added")
            + " at the tail")


def invariant_violations(sched: ProgramSchedule) -> List[str]:
    """The unconditional checks (regeneration cannot bless them): every
    rank issued one identical sequence, nothing ran outside ``spmd``,
    and a telemetry-off program built no metrics tape."""
    v = []
    seqs = sched.rank_sequences
    if "host" in seqs:
        v.append(f"{sched.program}: cross-rank call(s) {seqs['host']} "
                 "outside spmd")
    ranks = [r for r in seqs if r != "host"]
    if sorted(ranks) != list(range(sched.n_ranks)) and any(
            seqs[r] for r in ranks):
        v.append(f"{sched.program}: ranks {sorted(ranks)} of "
                 f"{sched.n_ranks} issued cross-rank calls — a rank that "
                 "issues none leaves the others blocked")
    for r in ranks:
        if seqs[r] != sched.collectives:
            v.append(f"{sched.program}: rank {r}'s sequence differs from "
                     "rank 0's (SPMD divergence): "
                     + _diff_sequences(sched.collectives, seqs[r]))
    t = sched.telemetry
    if sched.telemetry_off and t["tapes"]:
        v.append(f"{sched.program}: a TELEMETRY-OFF program built "
                 f"{t['tapes']} metrics tape(s) — with telemetry off the "
                 "step must be the seed step")
    return v


def golden_violations(sched: ProgramSchedule, schedule_dir: Optional[str]
                      = None, regen_hint: bool = True) -> List[str]:
    """The recorded sequence against the golden under ``schedule_dir``."""
    path = golden_path(sched.program, schedule_dir)
    if not os.path.exists(path):
        return [f"{sched.program}: no committed golden schedule at {path}"
                + (" — run `python -m distributed_join_tpu_torch.analysis."
                   "lint --update-schedules` and commit the result"
                   if regen_hint else "")]
    with open(path) as f:
        golden = json.load(f)
    if golden.get("schema_version") != SCHEDULE_SCHEMA_VERSION:
        return [f"{sched.program}: golden schema_version "
                f"{golden.get('schema_version')} != "
                f"{SCHEDULE_SCHEMA_VERSION}"]
    v = []
    if golden.get("n_ranks") != sched.n_ranks:
        v.append(f"{sched.program}: golden n_ranks {golden.get('n_ranks')} "
                 f"!= recorded {sched.n_ranks}")
    want = list(golden.get("collectives", []))
    if want != sched.collectives:
        v.append(f"{sched.program}: collective schedule drifted from "
                 f"{path}: " + _diff_sequences(want, sched.collectives))
    return v


def check_program(sched: ProgramSchedule,
                  schedule_dir: Optional[str] = None) -> List[str]:
    """Violations for one recorded program: the invariants plus the
    golden comparison."""
    return invariant_violations(sched) + golden_violations(sched,
                                                           schedule_dir)


def check_schedules(schedule_dir: Optional[str] = None, update: bool = False,
                    programs: Optional[Dict[str, Program]] = None,
                    device="cpu"):
    """Record every key program and check (or, with ``update``, rewrite)
    its golden. Returns ``(violations, schedules)``; the CLI's gate is
    ``not violations``."""
    progs = programs if programs is not None else key_programs(device)
    violations: List[str] = []
    schedules: List[ProgramSchedule] = []
    for name, prog in progs.items():
        sched = record_program(name, prog)
        schedules.append(sched)
        if update:
            write_golden(sched, schedule_dir)
            violations.extend(invariant_violations(sched))
        else:
            violations.extend(check_program(sched, schedule_dir))
    return violations, schedules
