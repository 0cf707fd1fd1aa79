"""Resident build tables: register once, serve probe-only joins.

Port of ``distributed_join_tpu/service/resident.py``: ``ResidentError``,
``StaleGenerationError``, ``ResidentSignature`` (:109-165),
``_key_sorted_prefix`` (:167-190), ``_run_accounting`` (:193-201),
``make_resident_prep_step`` (:204-256), ``make_run_merge_step``
(:259-294), ``ResidentTable`` (:297-349, with the wire data plane's
``wire_spec`` and ``wire_build_keys``, :326-327) and
``ResidentTableRegistry`` (:352-936).

Serving traffic joins many probes against a few large build tables that
change slowly. Registration runs the build side's share of a join once:
hash-partition into ``n_ranks`` buckets, shuffle, and key-sort the
received rows into a valid-prefix run, held on the device under a name
with a generation stamp. Each join after it is probe-only
(``parallel.distributed_join.make_probe_join_step``): only the probe
partitions, shuffles and sorts, each batch against the resident run,
through the program cache. Appends land LSM-style: a delta is prepared
into a small sorted run, and a maintenance pass merges the pending runs
into the base (concatenation and one stable sort, as the JAX package
does with ``lax.sort``). A generation bump evicts only that table's
probe-only programs.

Every prep and merge is conservation-checked: the global valid rows and
the order-invariant sum of the key hashes (a wrapping uint64 sum, summed
here as int64 bits: the two's-complement wrap is the same) must come
through exactly, or the operation refuses (``ResidentError``); a failed
merge poisons the handle.

Under a process group each process holds its rank's shard of a resident
table: the programs take it as a local input (``Communicator.spmd``'s
``local_inputs``) beside the global probe.

``join`` takes the JAX package's ``with_metrics`` (the probe-only
step's metrics tape, ``None`` resolving from the telemetry session,
folded into it by ``telemetry.emit_metrics``) and ``explain`` (the
result's ``plan``, ``planning.build_probe_plan`` with the cached
program's ``ResidentSignature`` digest) and ``tuner`` (JAX :784-911: the
autotuner's probe-only verdict, ``JoinTuner.resolve_resident``, keyed by
the registry's generation-free workload signature; it pre-sizes the
probe ladder and labels its rungs absolutely, and drops structural
fills) and ``verify_integrity`` (JAX :786-935: the probe side's wire
digests, checked after each attempt; a mismatch evicts the probe-only
program and reruns the same sizing as the ``retry_integrity`` rung, and
the last attempt evicts and raises ``integrity.IntegrityError``).

Telemetry (JAX :240-279, :615-713, :869-873): the prep step's
``partition``, ``shuffle`` and ``sort`` spans and the merge's
``merge_sort``; the ``resident_register``, ``resident_append``,
``resident_maintain`` and ``resident_drop`` events; and each served
join in a ``resident_join`` span (``table``, ``generation``) that ends
on a fetch of the total (``sync_on``, the one sync of a request).
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import math
import threading
from typing import Optional, Sequence

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.ops.hashing import hash_columns
from distributed_join_tpu_torch.ops.join import _lexsort, _sentinel_max
from distributed_join_tpu_torch.ops.partition import radix_hash_partition
from distributed_join_tpu_torch.parallel import integrity
from distributed_join_tpu_torch.parallel.distributed_join import (
    DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    _batch_shuffle,
    make_probe_join_step,
    resolve_join_ladder,
    spmd_join,
)
from distributed_join_tpu_torch.service.programs import (
    JoinProgramCache,
    _canon,
    _digest,
    _schema_of,
    step_options,
)
from distributed_join_tpu_torch.table import Table

# (table row-sharded, rows, digest, overflow replicated); the prep
# program adds the input's (rows, digest) pair
MERGE_SHARDED_OUT = (False, True, True, True)
PREP_SHARDED_OUT = (False, True, True, True, True, True)

# make_probe_join_step's own keywords, defaults filled: the probe-only
# signature's option basis, read from the function itself
_PROBE_STEP_DEFAULTS = {
    name: p.default
    for name, p in inspect.signature(
        make_probe_join_step).parameters.items()
    if p.default is not inspect.Parameter.empty
}

# the ladder's sizing keys that the probe-only step takes (the skew
# capacities are not part of the probe-only program)
_PROBE_SIZING_KEYS = (
    "shuffle_capacity_factor", "out_capacity_factor",
    "out_rows_per_rank", "compression_bits",
)

_U64 = 1 << 64


class ResidentError(RuntimeError):
    """A resident-table operation refused: an unknown or poisoned handle,
    a schema mismatch, a capacity overflow, or a failed conservation
    check on a prep or merge pass. Never a wrong answer."""


class StaleGenerationError(ResidentError):
    """This holder's image is at a lower generation than its caller
    requires (it missed an append): probe-only work refuses rather than
    serve rows without the missed delta."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ResidentSignature:
    """The identity of one resident-subsystem program. ``kind`` is
    ``prep`` (a build or delta preparation), ``merge`` (the maintenance
    pass) or ``probe_join`` (the serving path), which also binds the
    handle, its generation and the ladder rung, so a generation bump can
    never serve a program of the old image."""

    kind: str
    n_ranks: int
    build_schema: tuple
    build_capacity: int
    probe_schema: Optional[tuple]
    probe_capacity: Optional[int]
    handle: Optional[str]
    generation: Optional[int]
    options: tuple
    rung: Optional[int] = None

    def canonical(self) -> dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        return _digest(self.canonical())


# -- the sorted-run programs -------------------------------------------


def _key_sorted_prefix(table: Table, keys: Sequence[str]) -> Table:
    """The table with its valid rows as a key-sorted prefix: the
    resident run layout. One stable lexsort on the keys (invalid rows
    masked to the dtype's max) and a validity tag, every column gathered
    by it. The tag breaks sentinel ties: a valid row whose key equals
    the sentinel still sorts before every invalid row."""
    ops = [torch.where(table.valid, table.columns[k],
                       torch.full_like(table.columns[k],
                                       _sentinel_max(table.columns[k].dtype)))
           for k in keys]
    tag = (~table.valid).to(torch.int8)
    perm = _lexsort([*ops, tag])
    cols = {n: c[perm] for n, c in table.columns.items()}
    return Table(cols, table.valid[perm])


def _run_accounting(comm, table: Table, keys: Sequence[str]):
    """``(rows, key_digest)``: the global valid rows and the wrapping
    sum of the valid rows' key hashes (uint64 bits in int64). A dropped,
    duplicated or changed key row moves one of them."""
    h = hash_columns([table.columns[k] for k in keys])
    digest = torch.where(table.valid, h, torch.zeros_like(h)).sum()
    rows = table.valid.sum(dtype=torch.int64)
    return comm.psum(rows), comm.psum(digest)


def make_resident_prep_step(comm, key="key",
                            resident_rows_per_rank: int = 0,
                            shuffle_capacity_factor: float =
                            DEFAULT_SHUFFLE_CAPACITY_FACTOR,
                            shuffle: str = "padded"):
    """The register and append preparation: hash-partition the build
    shard into ``n_ranks`` buckets, shuffle, and key-sort the received
    rows into a valid-prefix run of ``resident_rows_per_rank`` rows.
    ``step(build_local) -> (run_local, rows, key_digest, rows_in,
    digest_in, overflow)``: the input pair is measured before the
    shuffle and the output pair after the sort, so the caller's check
    brackets the data movement."""
    n = comm.n_ranks
    if shuffle not in ("padded", "ppermute"):
        raise ValueError(f"resident prep supports the padded/ppermute "
                         f"shuffles, not {shuffle!r}")
    keys = [key] if isinstance(key, str) else list(key)

    def step(build_local: Table):
        for name, c in build_local.columns.items():
            if c.ndim != 1:
                raise TypeError(f"resident column {name!r} is {c.ndim}-D; "
                                "resident tables cover scalar columns")
        in_rows, in_digest = _run_accounting(comm, build_local, keys)
        if n == 1:
            recv = build_local
            ovf = torch.zeros((), dtype=torch.bool, device=build_local.device)
        else:
            b_cap = _round_up(int(math.ceil(
                build_local.capacity / n * shuffle_capacity_factor)), 8)
            with telemetry.span("partition"):
                pt = radix_hash_partition(build_local, keys, n)
            with telemetry.span("shuffle"):
                recv, ovf = _batch_shuffle(comm, pt, 0, n, b_cap,
                                           mode=shuffle)
        if recv.capacity > resident_rows_per_rank:
            raise ValueError(
                f"resident capacity {resident_rows_per_rank} below the "
                f"shuffle receive block {recv.capacity}")
        with telemetry.span("sort"):
            run = _key_sorted_prefix(recv.pad_to(resident_rows_per_rank),
                                     keys)
        rows, digest = _run_accounting(comm, run, keys)
        overflow = comm.psum(ovf.to(torch.int32)) > 0
        return run, rows, digest, in_rows, in_digest, overflow

    return step


def make_run_merge_step(comm, key="key"):
    """The maintenance pass: merge one pending sorted run into the base
    run. ``step(base_local, run_local) -> (merged_local, rows,
    key_digest, overflow)``: concatenation and one stable sort, cut back
    to the base capacity; ``overflow`` fires when the valid rows exceed
    it (rows would be lost: the caller refuses)."""
    keys = [key] if isinstance(key, str) else list(key)

    def step(base_local: Table, run_local: Table):
        base_cap = base_local.capacity
        merged = Table(
            {n: torch.cat([base_local.columns[n], run_local.columns[n]])
             for n in base_local.column_names},
            torch.cat([base_local.valid, run_local.valid]))
        with telemetry.span("merge_sort"):
            sorted_ = _key_sorted_prefix(merged, keys)
        ovf = sorted_.valid.sum(dtype=torch.int64) > base_cap
        out = Table({n: c[:base_cap] for n, c in sorted_.columns.items()},
                    sorted_.valid[:base_cap])
        rows, digest = _run_accounting(comm, out, keys)
        overflow = comm.psum(ovf.to(torch.int32)) > 0
        return out, rows, digest, overflow

    return step


def _unsigned(digest) -> int:
    """A digest tensor as the JAX package's uint64 value."""
    return int(digest) % _U64


# -- the registry --------------------------------------------------------


class ResidentTable:
    """One registered build table: the resident image and its LSM
    state. Mutated only by the registry."""

    def __init__(self, name: str, keys: tuple, table: Table,
                 rows: int, key_digest: int, capacity_per_rank: int,
                 row_bytes: int, n_ranks: int):
        self.name = name
        self.keys = keys
        self.table = table              # row-sharded (a process: its shard)
        self.rows = rows                # global valid rows
        self.key_digest = key_digest    # uint64 key-hash sum
        self.capacity_per_rank = capacity_per_rank
        self.row_bytes = row_bytes
        self.n_ranks = n_ranks
        self.generation = 1
        # (run table, rows, digest, capacity per rank)
        self.pending_runs: list = []
        self.poisoned: Optional[str] = None
        self.joins_served = 0
        self.warm_joins = 0             # probe-only joins that built none
        self.appends = 0
        self.merges = 0
        # probe-only signatures of the current generation, evicted on
        # a bump
        self.cached_sigs: set = set()
        # the wire data plane's (service/server.py): the register
        # request's generator spec, the base key column the probe of a
        # resident wire join is drawn against, and the generator's state
        # after the build was drawn (a probe drawn from it at the
        # registration seed is generate_build_probe_tables' probe)
        self.wire_spec: Optional[dict] = None
        self.wire_build_keys: Optional[torch.Tensor] = None
        self.wire_probe_state: Optional[torch.Tensor] = None

    @property
    def bytes_resident(self) -> int:
        total = self.capacity_per_rank * self.n_ranks * self.row_bytes
        for _, _, _, cap in self.pending_runs:
            total += cap * self.n_ranks * self.row_bytes
        return total

    def stats(self) -> dict:
        return {
            "rows": self.rows,
            "generation": self.generation,
            "capacity_per_rank": self.capacity_per_rank,
            "bytes_resident": self.bytes_resident,
            "pending_runs": len(self.pending_runs),
            "joins_served": self.joins_served,
            "warm_joins": self.warm_joins,
            "appends": self.appends,
            "merges": self.merges,
            "poisoned": self.poisoned,
            "key": list(self.keys),
        }


def _is_integer(dt: torch.dtype) -> bool:
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


class ResidentTableRegistry:
    """Named resident build tables over one communicator.

    Programs go through ``cache`` (a ``JoinProgramCache``), a private
    unbounded one when none is given. One caller at a time,
    as in the JAX package (its server serialises every call).
    """

    def __init__(self, comm, cache=None, *, max_tables: int = 8,
                 capacity_factor: float = 1.5,
                 shuffle_capacity_factor: float =
                 DEFAULT_SHUFFLE_CAPACITY_FACTOR,
                 delta_slot_rows: int = 1024,
                 maintain_runs: int = 4,
                 prep_retries: int = 2):
        self.comm = comm
        self.cache = cache if cache is not None else JoinProgramCache(comm)
        self.max_tables = int(max_tables)
        self.capacity_factor = float(capacity_factor)
        self.shuffle_capacity_factor = float(shuffle_capacity_factor)
        self.delta_slot_rows = int(delta_slot_rows)
        self.maintain_runs = int(maintain_runs)
        self.prep_retries = int(prep_retries)
        self._tables: dict = {}
        self.registered = 0
        self.dropped = 0
        self.refused = 0
        self._lock = threading.Lock()     # the name table only

    # -- lookup ------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._tables

    def names(self):
        return sorted(self._tables)

    def peek(self, name: str) -> Optional[ResidentTable]:
        """The handle if registered, poisoned or not, else None."""
        return self._tables.get(name)

    def _refuse(self, msg: str):
        self.refused += 1
        raise ResidentError(msg)

    def get(self, name: str) -> ResidentTable:
        handle = self._tables.get(name)
        if handle is None:
            self._refuse(f"no resident table {name!r} (registered: "
                         f"{self.names() or 'none'})")
        if handle.poisoned:
            self._refuse(f"resident table {name!r} is poisoned "
                         f"({handle.poisoned}); drop and re-register")
        return handle

    def stats(self) -> dict:
        tables = {n: h.stats() for n, h in sorted(self._tables.items())}
        hs = self._tables.values()
        return {
            "count": len(self._tables),
            "max_tables": self.max_tables,
            "bytes_resident": sum(h.bytes_resident for h in hs),
            "generation_max": max((h.generation for h in hs), default=0),
            "probe_joins": sum(h.joins_served for h in hs),
            "warm_probe_joins": sum(h.warm_joins for h in hs),
            "registered": self.registered,
            "dropped": self.dropped,
            "refused": self.refused,
            "tables": tables,
        }

    # -- program admission ---------------------------------------------------

    def _program(self, sig: ResidentSignature, builder):
        """``(program, hit)`` through the cache."""
        return self.cache.get_keyed(sig, builder)

    def _evict_program(self, sig: ResidentSignature) -> None:
        """Drop a program whose run failed a conservation or a
        wire-integrity check: a clean re-run builds it again."""
        self.cache.evict(sig, reason="integrity")

    def _prep_program(self, schema: tuple, capacity: int, keys: tuple,
                      resident_rows: int, factor: float):
        sig = ResidentSignature(
            kind="prep", n_ranks=self.comm.n_ranks, build_schema=schema,
            build_capacity=capacity, probe_schema=None, probe_capacity=None,
            handle=None, generation=None,
            options=(("resident_rows_per_rank", resident_rows),
                     ("shuffle_capacity_factor", factor)))

        def build():
            step = make_resident_prep_step(
                self.comm, key=list(keys),
                resident_rows_per_rank=resident_rows,
                shuffle_capacity_factor=factor)
            return self.comm.spmd(step, sharded_out=PREP_SHARDED_OUT)

        fn, _ = self._program(sig, build)
        return fn, sig

    def _merge_program(self, schema: tuple, base_cap: int, run_cap: int,
                       keys: tuple):
        sig = ResidentSignature(
            kind="merge", n_ranks=self.comm.n_ranks, build_schema=schema,
            build_capacity=base_cap, probe_schema=schema,
            probe_capacity=run_cap, handle=None, generation=None,
            options=())

        def build():
            # both runs are resident shards
            return self.comm.spmd(make_run_merge_step(self.comm,
                                                      key=list(keys)),
                                  sharded_out=MERGE_SHARDED_OUT,
                                  local_inputs=True)

        fn, _ = self._program(sig, build)
        return fn, sig

    # -- registration and ingestion ------------------------------------------

    def _validate(self, table: Table, keys: tuple) -> None:
        for k in keys:
            if k not in table.columns:
                self._refuse(f"key column {k!r} missing from the build "
                             "table")
            if not _is_integer(table.columns[k].dtype):
                self._refuse(
                    f"resident key {k!r} must be an integer column (got "
                    f"{table.columns[k].dtype}); string/float keys go "
                    "through the full join")
        for name, c in table.columns.items():
            if c.ndim != 1 or name.endswith("#len"):
                self._refuse(f"resident column {name!r} is not a scalar "
                             "column; 2-D/string payloads go through the "
                             "full join")

    def _prep(self, table: Table, keys: tuple, resident_rows: int):
        """Run the prep program (doubling the shuffle factor on
        overflow) and check its output pair against its input pair.
        Returns ``(run, rows, digest, capacity_per_rank)``."""
        n = self.comm.n_ranks
        padded = table.pad_to(_round_up(table.capacity, n))
        factor = self.shuffle_capacity_factor
        schema = _schema_of(padded)
        for _ in range(self.prep_retries + 1):
            b_cap = _round_up(int(math.ceil(
                padded.capacity / n / n * factor)), 8) if n > 1 else 0
            rows_needed = max(n * b_cap, padded.capacity // n)
            cap = max(resident_rows, _round_up(rows_needed, 8))
            fn, sig = self._prep_program(schema, padded.capacity, keys, cap,
                                         factor)
            run, rows, digest, rows_in, digest_in, overflow = fn(padded)
            if not bool(overflow):
                rows, want_rows = int(rows), int(rows_in)
                digest, want = _unsigned(digest), _unsigned(digest_in)
                if rows != want_rows or digest != want:
                    self._evict_program(sig)
                    self._refuse(
                        "prep conservation check failed: "
                        f"{rows} rows / digest {digest:#x} out vs "
                        f"{want_rows} rows / digest {want:#x} in — "
                        "refusing to bless a corrupt resident image")
                return run, rows, digest, cap
            factor *= 2.0
        self._refuse(
            f"prep shuffle overflowed after {self.prep_retries + 1} factor "
            f"escalations (final {factor:g}); the key distribution is too "
            "skewed for resident registration")

    def register(self, name: str, build: Table, key="key", *,
                 replace: bool = False) -> ResidentTable:
        """Run the build side's partition, shuffle and sort once and hold
        the run under ``name``. An existing name refuses unless
        ``replace``."""
        keys = (key,) if isinstance(key, str) else tuple(key)
        if self.comm.n_ranks > 1 and self.comm.n_slices > 1:
            self._refuse(
                "resident tables are served by flat global collectives; "
                "hierarchical (multi-slice) probe-only serving is not "
                "implemented yet — register on a flat 1-D communicator")
        if name in self._tables and not replace:
            self._refuse(f"resident table {name!r} already exists (pass "
                         "replace=True to re-register)")
        if name not in self._tables and len(self._tables) >= self.max_tables:
            self._refuse(f"{len(self._tables)} resident tables already held "
                         f"(max_tables={self.max_tables}); drop one first")
        self._validate(build, keys)
        n = self.comm.n_ranks
        b_local = _round_up(build.capacity, n) // n
        # headroom for deltas, floored at one shuffle receive block
        resident_rows = _round_up(
            int(math.ceil(b_local * self.capacity_factor)), 8)
        run, rows, digest, cap = self._prep(build, keys, resident_rows)
        row_bytes = sum(c.element_size() for c in build.columns.values())
        handle = ResidentTable(name, keys, run, rows, digest, cap,
                               row_bytes, n)
        old = self._tables.get(name)
        with self._lock:
            self._tables[name] = handle
        if old is not None:
            self._evict_generation(old)
        self.registered += 1
        telemetry.event("resident_register", table=name, rows=rows,
                        capacity_per_rank=cap,
                        bytes=handle.bytes_resident)
        return handle

    def append(self, name: str, delta: Table, *,
               maintain: Optional[bool] = None) -> ResidentTable:
        """Land ``delta`` as a sorted run on ``name``'s queue and bump
        the generation. ``maintain=None`` merges once the queue holds
        ``maintain_runs`` runs, True merges now, False only queues;
        every join merges the queue first (merge on read)."""
        handle = self.get(name)
        keys = handle.keys
        self._validate(delta, keys)
        if _schema_of(delta) != _schema_of(handle.table):
            self._refuse(f"delta schema does not match resident table "
                         f"{name!r} — refusing the append")
        # a fixed slot, so repeat appends share one prep and one merge
        # program
        n = self.comm.n_ranks
        slot = _round_up(max(delta.capacity, n), self.delta_slot_rows)
        run, rows, digest, cap = self._prep(
            delta.pad_to(slot), keys, _round_up(max(slot // n, 8), 8))
        handle.pending_runs.append((run, rows, digest, cap))
        handle.appends += 1
        self._bump_generation(handle)
        telemetry.event("resident_append", table=name,
                        delta_rows=rows, generation=handle.generation,
                        pending_runs=len(handle.pending_runs))
        if maintain or (maintain is None
                        and len(handle.pending_runs) >= self.maintain_runs):
            self.maintain(name)
        return handle

    def maintain(self, name: str) -> int:
        """Merge every pending run into ``name``'s base, one merge a run.
        Returns the runs merged. An overflow or a failed conservation
        check poisons the handle: the base may be half merged."""
        handle = self.get(name)
        merged = 0
        while handle.pending_runs:
            run, run_rows, run_digest, run_cap = handle.pending_runs[0]
            fn, msig = self._merge_program(
                _schema_of(handle.table), handle.capacity_per_rank,
                run_cap * handle.n_ranks, handle.keys)
            out, rows, digest, overflow = fn(handle.table, run)
            if bool(overflow):
                handle.poisoned = (
                    "maintenance overflow: merged rows exceed the resident "
                    f"capacity {handle.capacity_per_rank}/rank")
                self._refuse(f"resident table {name!r}: {handle.poisoned} "
                             "— re-register with a larger capacity_factor")
            rows, digest = int(rows), _unsigned(digest)
            want_rows = handle.rows + run_rows
            want_digest = (handle.key_digest + run_digest) % _U64
            if rows != want_rows or digest != want_digest:
                handle.poisoned = (
                    f"merge conservation check failed ({rows} rows / "
                    f"digest {digest:#x} vs expected {want_rows} / "
                    f"{want_digest:#x})")
                self._evict_program(msig)
                self._refuse(f"resident table {name!r}: {handle.poisoned} "
                             "— refusing to bless a corrupt merge")
            handle.table = out
            handle.rows = rows
            handle.key_digest = digest
            handle.pending_runs.pop(0)
            handle.merges += 1
            merged += 1
        if merged:
            telemetry.event("resident_maintain", table=name,
                            runs_merged=merged, rows=handle.rows,
                            generation=handle.generation)
        return merged

    def drop(self, name: str) -> None:
        handle = self._tables.get(name)
        if handle is None:
            self._refuse(f"no resident table {name!r}")
        with self._lock:
            del self._tables[name]
        self._evict_generation(handle)
        self.dropped += 1
        telemetry.event("resident_drop", table=name)

    def _bump_generation(self, handle: ResidentTable) -> None:
        self._evict_generation(handle)
        handle.generation += 1

    def _evict_generation(self, handle: ResidentTable) -> None:
        """Evict the probe-only programs of ``handle``'s current image,
        and no other entry."""
        for sig in handle.cached_sigs:
            self.cache.evict(sig, reason="generation")
        handle.cached_sigs = set()

    # -- the serving path -----------------------------------------------------

    def probe_signature(self, handle: ResidentTable, probe: Table,
                        opts: dict, rung: int = 0) -> ResidentSignature:
        merged = step_options(opts, _PROBE_STEP_DEFAULTS,
                              "make_probe_join_step")
        return ResidentSignature(
            kind="probe_join", n_ranks=self.comm.n_ranks,
            build_schema=_schema_of(handle.table),
            build_capacity=handle.capacity_per_rank * self.comm.n_ranks,
            probe_schema=_schema_of(probe), probe_capacity=probe.capacity,
            handle=handle.name, generation=handle.generation,
            options=tuple(sorted((name, _canon(v))
                                 for name, v in merged.items())),
            rung=rung)

    def workload_signature(self, name: str, probe: Table,
                           opts: dict) -> str:
        """The generation-free identity of a probe-only workload: appends
        move the data, not the workload."""
        basis = json.dumps(
            {"handle": name, "n_ranks": self.comm.n_ranks,
             "probe": _schema_of(probe), "probe_capacity": probe.capacity,
             "opts": sorted((k, repr(v)) for k, v in opts.items()
                            if k != "with_metrics")},
            sort_keys=True, default=str)
        return "res-" + hashlib.sha256(basis.encode()).hexdigest()[:13]

    def join(self, name: str, probe: Table, *, auto_retry: int = 2,
             tuner=None, with_metrics=None, explain: bool = False,
             verify_integrity: bool = False, **opts):
        """One probe-only join against resident table ``name``: merge
        any pending runs first (every join sees every append), then
        partition, shuffle and sort the probe only, through the program
        cache, with the probe side's ladder (``auto_retry`` rungs). The
        result carries ``retry_report`` and a ``resident`` record; with
        metrics on (``None``: the session's state) ``telemetry``, the
        step's block, and with ``explain`` the ``plan`` of the program
        that produced it (its digest the cache key). With ``tuner`` (a
        ``planning.tuner.JoinTuner``) the probe ladder starts at the
        sizing and the absolute rung label the workload's history
        resolved to, and the result carries ``tuned``.

        ``verify_integrity``: the probe shuffle's wire digests
        (``make_probe_join_step(with_integrity=True)``), checked on the
        host after each attempt that did not overflow, as
        ``distributed_inner_join`` checks them: a mismatch evicts the
        probe-only program and reruns the same sizing
        (``retry_integrity``); the last attempt evicts and raises
        ``integrity.IntegrityError``. A clean result carries
        ``integrity_report``."""
        if "with_integrity" in opts:
            # the step's switch follows verify_integrity; taking both
            # would let one silently override the other
            raise TypeError("join() got an unexpected keyword argument "
                            "'with_integrity' (pass verify_integrity)")
        handle = self.get(name)
        # hashed first, on the unpadded probe and the caller's options:
        # the basis the service keys its history lines on; only the
        # tuner reads it, so a join without one skips the hash
        wsig = (self.workload_signature(name, probe, opts)
                if tuner is not None else None)
        if opts.pop("skew_threshold", None) is not None or any(
                opts.get(k) is not None for k in
                ("hh_build_capacity", "hh_probe_capacity",
                 "hh_out_capacity")):
            self._refuse("the skew sidecar is not part of the probe-only "
                         "program; run skewed workloads through the full "
                         "join")
        opts.pop("hh_slots", None)
        if self.maintain(name):
            handle = self.get(name)
        if with_metrics is None:
            with_metrics = telemetry.enabled()
        n = self.comm.n_ranks
        probe = probe.pad_to(_round_up(probe.capacity, n))
        tuned = None
        if tuner is not None:
            tuned = tuner.resolve_resident(
                self.comm, handle.capacity_per_rank, probe,
                signature=wsig, opts=opts)
            opts = tuned.apply(opts)
        ladder = resolve_join_ladder(handle.table, probe, n, opts,
                                     n_slices=self.comm.n_slices)
        if tuned is not None:
            ladder.seed_rung(tuned.rung)
        key_opt = (list(handle.keys) if len(handle.keys) > 1
                   else handle.keys[0])
        with_aux = bool(with_metrics or verify_integrity)
        for attempt in range(auto_retry + 1):
            # the absolute rung label (a seeded ladder starts above 0)
            rung = ladder.base_rung + attempt
            sizing = {k: v for k, v in ladder.sizing().items()
                      if k in _PROBE_SIZING_KEYS}
            step_opts = dict(opts, key=key_opt, with_metrics=with_metrics,
                             with_integrity=verify_integrity,
                             metrics_static={"retry_attempt_max": rung},
                             **sizing)
            sig = self.probe_signature(handle, probe, step_opts, rung=rung)

            def build(step_opts=step_opts):
                # the resident shard is local, the probe global
                return spmd_join(
                    self.comm, make_probe_join_step(self.comm, **step_opts),
                    with_aux, local_inputs=(True, False))

            fn, hit = self._program(sig, build)
            handle.cached_sigs.add(sig)
            with telemetry.span("resident_join", table=name,
                                generation=handle.generation) as sp:
                res = fn(handle.table, probe)
                if sp is not None:
                    # the one sync of a served request (JAX :869-873)
                    sp.sync_on(res.total)
            overflow = bool(res.overflow)
            report = None
            if verify_integrity and not overflow:
                report = integrity.verify_join_result(res)
            ladder.note(overflow,
                        integrity_ok=None if report is None else report.ok)
            corrupt = report is not None and not report.ok
            if corrupt:
                # a program that delivered corrupt rows serves no more
                self._evict_program(sig)
                handle.cached_sigs.discard(sig)
            if attempt == auto_retry or not (overflow or corrupt):
                if corrupt:
                    raise integrity.IntegrityError(report)
                handle.joins_served += 1
                if hit:
                    handle.warm_joins += 1
                object.__setattr__(res, "retry_report", ladder.report())
                if report is not None:
                    object.__setattr__(res, "integrity_report", report)
                object.__setattr__(res, "resident", {
                    "table": name, "generation": handle.generation,
                    "rows": handle.rows, "warm": bool(hit)})
                if tuned is not None:
                    object.__setattr__(res, "tuned", tuned.as_record())
                if explain:
                    from distributed_join_tpu_torch.planning.plan import (
                        abstract_table,
                        build_probe_plan,
                        column_schema,
                    )

                    image = abstract_table(
                        column_schema(handle.table),
                        handle.capacity_per_rank * n)
                    object.__setattr__(res, "plan", build_probe_plan(
                        self.comm, image, probe, key=key_opt,
                        digest=sig.digest(), with_metrics=with_metrics,
                        **dict(opts, **sizing)))
                telemetry.emit_metrics(getattr(res, "telemetry", None))
                return res
            if overflow:
                ladder.escalate()
            else:
                ladder.hold("retry_integrity")
        raise AssertionError("unreachable")
