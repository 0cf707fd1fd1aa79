"""Join as a service: the resident daemon that keeps the programs warm.

Port of ``distributed_join_tpu/service/server.py``: ``AdmissionError`` and
``DrainingError`` (:76-88), ``ServiceConfig`` (:119), ``JoinService``
(:169-1290), the wire data plane (:1297-1437), ``_Handler`` (:1439-1700),
``_Server``/``start_daemon`` (:1703-1719), ``ServiceClient`` (:1722),
``watch`` (:1846) and the CLI: ``parse_args``, ``_service_from_args``,
``run``, ``_poison_drill``, ``_resident_drill``, ``run_smoke`` and
``main`` (:1942-2594). Run it as ``python -m
distributed_join_tpu_torch.service.server``.

- :class:`JoinService`, the in-process engine: one communicator, one
  :class:`~.programs.JoinProgramCache` (a warm request is a lookup and a
  dispatch), admission (a bounded pending count: loud
  :class:`AdmissionError` refusals, not an unbounded queue), per-request
  watchdog deadlines (a hung request poisons the service: every later
  request refuses until a restart), drain, per-request telemetry spans,
  and the live layer: a request id minted at admission, the
  :class:`~..telemetry.live.LiveMetrics` behind the ``metrics`` op, the
  :class:`~..telemetry.live.FlightRecorder` ring dumped on poison, and
  the :class:`~..telemetry.history.WorkloadHistory` store.
- the TCP daemon: one JSON object per line in, one per line out, the JAX
  package's ops and response keys (``results/contracts/wire_ops.json``
  ``daemon_ops``). The wire carries generator specs, not table bytes.
- :class:`ServiceClient` (reconnect with jittered backoff, resending
  only the idempotent ops) and the read-only ``--watch`` console.

Where the port differs:

- The tables live on the service's device, the GPU unless the caller
  names another (``device="cpu"``, ``--device cpu``): the entry points
  take it as the drivers do (``benchmarks.rank_device``). A connection
  thread of the daemon sees CUDA's device 0 and default stream, so every
  request binds the service's device and the stream the service was
  made on (:meth:`JoinService.on_device`).
- The wire's generator draws from one ``torch.Generator`` stream, where
  the JAX package splits one PRNG key into a build key and a probe key.
  A ``register`` keeps the generator's state after the build, so a
  resident ``join`` whose probe seed equals the registration seed draws
  exactly the probe of ``generate_build_probe_tables(seed)``.
- The ``explain`` op and :meth:`JoinService.explain` (JAX :911-975) dry-
  run a join spec through ``planning.explain_join`` over ``meta``
  tables: the plan, the cost model's prediction and the program cache's
  verdict, no admission, no device. Every join request's history line
  carries the plan's predicted wall (``_predicted_wall``, JAX :977) and
  its ``prediction`` grade, and the flight record the plan's digest.
- ``--smoke`` gates its counter signatures (the micro-batched join's
  device counters, and the resident drill's integer counters) against
  ``results/baselines_torch/service_smoke.json`` and
  ``resident_smoke.json`` (``--smoke-baseline-dir``), the port's own
  files: its generators draw other bits than the JAX package's, and
  other bits on a card than on the CPU, so a baseline gates only a run
  at its own rank count and device type.
- ``auto_tune`` and ``tuner_history`` (JAX :134-154, :220-231) arm the
  history-driven autotuner (``planning/tuner.py``'s ``JoinTuner``),
  preloaded from ``tuner_history`` or the service's own history file and
  fed every request's history entry after it is written; wire and
  resident joins pass it as ``tuner=``, so a repeat of an escalated
  workload runs pre-sized at its final rung. The history entry and the
  flight record carry ``tuned``, ``explain`` its ``tuned`` block and
  ``stats()`` a ``tuner`` block. The daemon's ``--auto-tune[=HISTORY]``
  sets them.
- ``ServiceConfig.verify_integrity`` and the daemon's
  ``--verify-integrity`` (JAX :418, :596-604, :945-1015, :2088): every
  wire and resident join runs ``verify_integrity`` (the wire digests,
  checked after each attempt; a mismatch evicts the program and reruns
  the same sizing, counted in the cache's ``integrity_evictions`` and
  the live metrics' ``integrity_retries``), and ``explain`` plans the
  verified program, so its digest is the key the join runs under.
- ``ServiceConfig.persist_dir`` and the daemon's ``--persist-dir``
  (JAX :125-150, :179, :213) arm the program cache's disk tier
  (``service/programs.py``: an entry binds the step's resolved options,
  the backend and the kernels' digests; a restarted daemon binds it
  with no new trace), and ``history_dir`` defaults to it, as in the JAX
  package. The kernels of every good entry are loaded before the first
  request (``JoinProgramCache.preload``).
- ``--chaos-seed N`` (JAX :2067-2080) wraps the daemon's communicator in
  the seed's fault schedule (``benchmarks.maybe_chaos_communicator``)
  before ``--fault-plan`` applies its scripted one on top.
- Refused by name: ``--platform`` (the daemon serves on ``--device``),
  and a daemon over a process group of
  more than one rank: the JAX daemon is one controller over its mesh,
  and a port daemon over N processes would need every rank to follow
  rank 0's stream of requests. Serving across cards is the fleet
  (``service/fleet.py``): one daemon a card behind its router. The
  daemon serves on ``local`` (one card, the default), ``emulated``, and
  ``nccl``/``gloo`` as a world of 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import socket
import socketserver
import statistics
import sys
import threading
import time
from typing import Optional

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.service import batching
from distributed_join_tpu_torch.service.programs import JoinProgramCache
from distributed_join_tpu_torch.telemetry import baselines
from distributed_join_tpu_torch.telemetry import history as tel_history
from distributed_join_tpu_torch.telemetry import live as tel_live
from distributed_join_tpu_torch.telemetry import tracectx

# The smoke's baselines: the repository's results/baselines_torch.
SMOKE_BASELINE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), baselines.DEFAULT_BASELINE_DIR)

MULTI_RANK_REFUSAL = (
    "a daemon over a process group of more than one rank: the JAX daemon "
    "is one controller, and a port daemon over N processes would need "
    "every rank to follow rank 0's stream of requests; serve one replica "
    "a card behind the fleet's router instead (python -m "
    "distributed_join_tpu_torch.service.fleet --device cuda)")


class AdmissionError(RuntimeError):
    """The service refused the request at admission (pending queue or
    batch size over the configured bound, or a poisoned service): a
    structured, retryable refusal instead of an unbounded queue."""


class DrainingError(AdmissionError):
    """The service is draining (the ``drain`` wire op or SIGTERM): new
    admissions refuse while in-flight requests finish. An
    :class:`AdmissionError`, so retrying clients try another replica."""


def _count_groups(valid) -> int:
    """Host count of the fused pipeline's valid groups (groups-sized)."""
    return int(valid.sum())


def _host_total(res) -> tuple:
    """``(total, overflow)`` of a result on the host, in one copy."""
    pair = torch.stack([res.total.to(torch.int64).reshape(()),
                        res.overflow.to(torch.int64).reshape(())])
    total, overflow = pair.tolist()
    return int(total), bool(overflow)


@dataclasses.dataclass
class ServiceConfig:
    """Serving policy knobs (the per-run driver flags, made resident).

    ``request_deadline_s`` is the per-request watchdog bound (None =
    unguarded); ``auto_retry`` the capacity ladder's budget, applied to
    every request; ``persist_dir`` arms the program cache's disk tier.
    ``history_dir`` (default: ``persist_dir``) arms the per-request
    workload-history store, bounded by ``history_max_entries`` live
    entries a signature;
    ``flight_records`` sizes the postmortem ring, and
    ``flight_recorder_path`` pins where a poison or drain dump lands
    (default: the telemetry session's directory, else the history
    directory, else the persist directory, else the working
    directory). The resident knobs size the
    registry (``service/resident.py``). ``auto_tune`` arms the
    autotuner, preloaded from ``tuner_history`` (default: the history
    store's file, so a restarted service keeps its tuning).
    ``verify_integrity`` applies ``distributed_inner_join``'s
    wire-integrity contract to every wire and resident join."""

    auto_retry: int = 2
    verify_integrity: bool = False
    request_deadline_s: Optional[float] = None
    max_pending: int = 8
    max_batch_requests: int = 64
    max_programs: int = 128
    persist_dir: Optional[str] = None
    history_dir: Optional[str] = None
    history_max_entries: Optional[int] = None
    auto_tune: bool = False
    tuner_history: Optional[str] = None
    flight_records: int = 256
    flight_recorder_path: Optional[str] = None
    max_resident_tables: int = 8
    resident_capacity_factor: float = 1.5
    delta_slot_rows: int = 1024
    maintain_runs: int = 4


class _Request:
    """One admitted request's accounting, filled in as it runs."""

    def __init__(self, rid: str, op: str, sig: Optional[str] = None):
        self.rid = rid
        self.op = op
        self.sig = sig
        self.outcome = "failed"
        self.res = None
        self.err: Optional[BaseException] = None
        self.new_traces = 0
        self.cache_hits = 0
        self.matches: Optional[int] = None
        self.overflow: Optional[bool] = None
        self.predicted_wall_s: Optional[float] = None
        self.t_start = time.perf_counter()


class JoinService:
    """The in-process serving engine. Thread-safe: admission is a bounded
    counter, execution serialises on one lock (the ranks run one program
    at a time; queueing beyond ``max_pending`` is refused, not
    buffered)."""

    def __init__(self, comm, config: Optional[ServiceConfig] = None,
                 device=None):
        from distributed_join_tpu_torch.benchmarks import (
            innermost,
            rank_device,
        )
        from distributed_join_tpu_torch.parallel.communicator import (
            ProcessGroupCommunicator,
        )
        from distributed_join_tpu_torch.service.resident import (
            ResidentTableRegistry,
        )

        self.config = config or ServiceConfig()
        inner = innermost(comm)
        if isinstance(inner, ProcessGroupCommunicator) and comm.n_ranks > 1:
            raise NotImplementedError(
                f"{comm.n_ranks} ranks over {inner.name}: "
                f"{MULTI_RANK_REFUSAL}")
        self.comm = comm
        self.device = rank_device(inner, device)
        # the stream every request runs on: the creating thread's (a
        # connection thread's own would be the device's default stream)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.cache = JoinProgramCache(
            comm, persist_dir=self.config.persist_dir,
            max_entries=self.config.max_programs, device=self.device)
        # the kernels of every persisted program, loaded before the
        # first request
        self.cache.preload()
        # (predicted wall, plan digest) a workload signature
        self._pred_cache: dict = {}
        self._exec_lock = threading.Lock()
        self._admit_lock = threading.Lock()
        self._pending = 0
        self._pending_hwm = 0
        self._request_seq = 0
        # a per-service nonce in every minted id: a client-supplied id
        # (echoed verbatim) can never collide with the minted namespace
        self._id_stamp = os.urandom(3).hex()
        self.served = 0
        self.rejected = 0
        self.failed = 0
        self.agg_queries = 0
        self.agg_warm_hits = 0
        self.agg_groups_emitted = 0
        self.query_plans = 0
        self.query_warm_hits = 0
        self.query_operators_max = 0
        self.live = tel_live.LiveMetrics()
        self.recorder = tel_live.FlightRecorder(self.config.flight_records)
        self.flight_recorder_dumped: Optional[str] = None
        hist_dir = self.config.history_dir or self.config.persist_dir
        self.history = (tel_history.WorkloadHistory(
            os.path.join(hist_dir, tel_history.HISTORY_FILENAME),
            max_entries_per_signature=self.config.history_max_entries)
            if hist_dir else None)
        # the autotuner: preloaded from the persisted history, fed each
        # request's entry by _observe (JAX :220-231)
        self.tuner = None
        if self.config.auto_tune:
            from distributed_join_tpu_torch.planning.tuner import JoinTuner

            preload = self.config.tuner_history or (
                self.history.path if self.history is not None else None)
            self.tuner = JoinTuner(preload)
        self.resident = ResidentTableRegistry(
            comm, self.cache,
            max_tables=self.config.max_resident_tables,
            capacity_factor=self.config.resident_capacity_factor,
            delta_slot_rows=self.config.delta_slot_rows,
            maintain_runs=self.config.maintain_runs)
        # set (to the HangError's text) when a request blew its deadline:
        # its join runs on in the detached watchdog worker, so every later
        # request refuses until a restart (ping and stats still answer)
        self.poisoned: Optional[str] = None
        # set (to the reason) by drain() or SIGTERM
        self.draining: Optional[str] = None

    @contextlib.contextmanager
    def on_device(self):
        """Make the service's device and stream current on this thread."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    # -- admission -----------------------------------------------------

    def _mint_request_id(self, request_id) -> str:
        """Admission-lock-held: the one place request ids come from. A
        client-supplied id is honoured, capped to 64 characters without
        aliasing (a 48-character prefix and a sha256 tail)."""
        self._request_seq += 1
        if request_id:
            rid = str(request_id)
            if len(rid) > 64:
                rid = (rid[:48] + "-"
                       + hashlib.sha256(rid.encode()).hexdigest()[:15])
            return rid
        return f"req-{self._id_stamp}-{self._request_seq:06d}"

    def _refuse_admission(self, rid, op, tenant, reason, exc, **payload):
        """Admission-lock-held: count and record a refusal, then raise."""
        self.rejected += 1
        telemetry.event("request_rejected", reason=reason, request_id=rid,
                        **payload)
        self.live.record_request(op, "rejected", tenant=tenant)
        self.recorder.record(request_id=rid, op=op, signature=None,
                             outcome="rejected", reason=reason,
                             **({"tenant": tenant} if tenant is not None
                                else {}))
        raise exc

    def _poisoned_error(self) -> AdmissionError:
        return AdmissionError("mesh poisoned by a hung request "
                              f"({self.poisoned}); restart the server")

    def _admit(self, op: str, request_id=None) -> str:
        tenant = tel_history.current_tenant()
        with self._admit_lock:
            rid = self._mint_request_id(request_id)
            if self.poisoned is not None:
                self._refuse_admission(rid, op, tenant, "poisoned",
                                       self._poisoned_error())
            if self.draining is not None:
                self._refuse_admission(
                    rid, op, tenant, "draining", DrainingError(
                        f"service draining ({self.draining}); retry on "
                        "another replica"))
            if self._pending >= self.config.max_pending:
                self._refuse_admission(
                    rid, op, tenant, "pending", AdmissionError(
                        f"{self._pending} requests already pending "
                        f"(max_pending={self.config.max_pending}); retry "
                        "with backoff"), pending=self._pending)
            self._pending += 1
            self._pending_hwm = max(self._pending_hwm, self._pending)
        return rid

    def _release(self):
        with self._admit_lock:
            self._pending -= 1

    def _execute(self, req: _Request, fn, **span_payload):
        """Run ``fn`` for an admitted request under the exec lock, on the
        service's device, with the poisoned re-check (a request parked on
        the lock while another hung must not dispatch beside the detached
        worker), the deadline, the request's span and its trace
        accounting. A result with a ``total`` is read to the host inside
        the span: the request's one wait on the device."""
        from distributed_join_tpu_torch.parallel.watchdog import (
            HangError,
            call_with_deadline,
        )

        with self.on_device(), self._exec_lock:
            with self._admit_lock:
                if self.poisoned is not None:
                    self.rejected += 1
                    req.outcome = "rejected"
                    telemetry.event("request_rejected", reason="poisoned",
                                    request_id=req.rid)
                    raise self._poisoned_error()
            if self.tuner is not None:
                # the tuner's read namespace for this request, pinned while
                # the exec lock serialises dispatch: the watchdog's worker
                # thread cannot see this thread's tenant scope
                self.tuner.active_tenant = tel_history.current_tenant()
            deadline = self.config.request_deadline_s
            traces0, hits0 = self.cache.traces, self.cache.hits
            try:
                with telemetry.request_scope(req.rid), telemetry.span(
                        "request", request_id=req.rid, op=req.op,
                        **span_payload):
                    out = (fn() if deadline is None else call_with_deadline(
                        fn, deadline, what=f"request {req.rid}"))
                    if hasattr(out, "total"):
                        req.matches, req.overflow = _host_total(out)
            except Exception as exc:
                req.new_traces = self.cache.traces - traces0
                req.cache_hits = self.cache.hits - hits0
                if isinstance(exc, HangError):
                    req.outcome = "hang"
                    with self._admit_lock:
                        self.poisoned = str(exc)
                raise
            self.served += 1
            # captured under the exec lock: another connection's build is
            # never billed to this request
            req.new_traces = self.cache.traces - traces0
            req.cache_hits = self.cache.hits - hits0
            req.outcome = "served"
            req.res = out
            return out

    def _failed(self, req: _Request, exc: BaseException) -> None:
        """Count a request that raised: a failure, unless it was refused
        (counted already) or aborted (Ctrl-C, SystemExit: not a failure
        of the workload)."""
        req.err = exc
        if req.outcome != "rejected":
            if isinstance(exc, Exception):
                with self._admit_lock:
                    self.failed += 1
            else:
                req.outcome = "aborted"

    def _stamp(self, res, req: _Request) -> None:
        object.__setattr__(res, "new_traces", req.new_traces)
        object.__setattr__(res, "request_id", req.rid)
        object.__setattr__(res, "matches", req.matches)

    def _note_aggregate(self, res, req: _Request, agg_rec):
        """A fused aggregate's groups, counted (None: no aggregate)."""
        if agg_rec is None:
            return None
        groups = _count_groups(res.table.valid)
        with self._admit_lock:
            self.agg_queries += 1
            if req.new_traces == 0:
                self.agg_warm_hits += 1
            self.agg_groups_emitted += groups
        object.__setattr__(res, "agg_groups", groups)
        return dict(agg_rec, groups=groups)

    # -- the request paths --------------------------------------------

    def join(self, build, probe, key="key", *, request_id=None,
             op: str = "join", tenant: Optional[str] = None, **opts):
        """One admitted, watchdog-guarded, span-wrapped join through the
        program cache. Returns the ``JoinResult`` with ``retry_report``,
        ``new_traces``, ``request_id`` and the host ``matches``.
        ``tenant`` (None = the wire handler's scope) stamps the request's
        accounting; it never reaches the program."""
        with tel_history.tenant_scope(
                tenant if tenant is not None
                else tel_history.current_tenant()):
            return self._join_scoped(build, probe, key,
                                     request_id=request_id, op=op, **opts)

    def _join_scoped(self, build, probe, key="key", *, request_id=None,
                     op: str = "join", **opts):
        from distributed_join_tpu_torch.parallel.distributed_join import (
            distributed_inner_join,
        )

        req = _Request(self._admit(op, request_id), op)
        agg_spec = opts.get("aggregate")
        agg_rec = agg_spec.as_record() if agg_spec is not None else None
        plan_digest = None
        try:
            # inside the try: anything raising after admission still
            # releases the slot
            req.sig = self._workload_signature(build, probe, key, opts)
            req.predicted_wall_s, plan_digest = self._predicted_wall(
                req.sig, build, probe, key, opts)

            def run_once():
                return distributed_inner_join(
                    build, probe, self.comm, key=key,
                    auto_retry=self.config.auto_retry,
                    verify_integrity=self.config.verify_integrity,
                    program_cache=self.cache, tuner=self.tuner, **opts)

            res = self._execute(req, run_once, signature=req.sig)
            agg_rec = self._note_aggregate(res, req, agg_rec)
            self._stamp(res, req)
            return res
        except BaseException as exc:
            self._failed(req, exc)
            raise
        finally:
            # the slot goes back before the bookkeeping's file I/O
            self._release()
            self._observe(req, plan_digest=plan_digest, aggregate=agg_rec)

    def join_batched(self, requests, key="key", *, slot_build_rows=None,
                     slot_probe_rows=None, with_rows: bool = False,
                     request_id=None, **opts):
        """Micro-batch ``requests`` (``(build, probe)`` pairs sharing one
        schema and ``key``) into one step and unpack per request. Returns
        ``batching.split``'s per-request records."""
        if len(requests) > self.config.max_batch_requests:
            with self._admit_lock:
                rid = self._mint_request_id(request_id)
                self.rejected += 1
            telemetry.event("request_rejected", reason="batch_size",
                            batch=len(requests), request_id=rid)
            self.live.record_request("batch", "rejected")
            self.recorder.record(request_id=rid, op="batch", signature=None,
                                 outcome="rejected", reason="batch_size")
            raise AdmissionError(
                f"batch of {len(requests)} exceeds max_batch_requests="
                f"{self.config.max_batch_requests}")
        try:
            with self.on_device():
                mb = batching.combine(
                    requests, key=key, slot_build_rows=slot_build_rows,
                    slot_probe_rows=slot_probe_rows)
        except Exception as exc:
            # a malformed batch dies before join's accounting: it must
            # still show as a failure to operators
            with self._admit_lock:
                rid = self._mint_request_id(request_id)
                self.failed += 1
            error = f"{type(exc).__name__}: {exc}"
            telemetry.event("request_failed", reason="batch_combine",
                            request_id=rid, error=error)
            self.live.record_request("batch", "failed")
            self.recorder.record(request_id=rid, op="batch", signature=None,
                                 outcome="failed", reason="batch_combine",
                                 error=error)
            raise
        res = self.join(mb.build, mb.probe, key=list(mb.key),
                        request_id=request_id, op="batch", **opts)
        with self.on_device():
            results = batching.split(res, mb, with_rows=with_rows)
        for r in results:
            # one program resolution for the batch, repeated per request
            r["new_traces"] = res.new_traces
            r["request_id"] = res.request_id
        return results

    def resident_join(self, table: str, probe, *, request_id=None, **opts):
        """One probe-only join against resident table ``table``, with
        admission, deadline, span and accounting as :meth:`join`; pending
        LSM runs merge first. The history entry is stamped ``resident``
        (a cold full join's carries ``resident: null``)."""
        req = _Request(self._admit("resident_join", request_id),
                       "resident_join")
        resident_rec = None
        agg_spec = opts.get("aggregate")
        agg_rec = agg_spec.as_record() if agg_spec is not None else None
        try:
            req.sig = self.resident.workload_signature(table, probe,
                                                       dict(opts))

            def run_once():
                # the probe-only program's digests: the full join's
                # contract on the resident path
                return self.resident.join(
                    table, probe, auto_retry=self.config.auto_retry,
                    verify_integrity=self.config.verify_integrity,
                    tuner=self.tuner, **opts)

            res = self._execute(req, run_once, signature=req.sig,
                                table=table)
            resident_rec = getattr(res, "resident", None)
            agg_rec = self._note_aggregate(res, req, agg_rec)
            self._stamp(res, req)
            return res
        except BaseException as exc:
            self._failed(req, exc)
            raise
        finally:
            self._release()
            if resident_rec is None:
                # a failed request still names the table it targeted
                resident_rec = {"table": table, "generation": None}
            self._observe(req, resident=resident_rec, aggregate=agg_rec)

    def query(self, tables: dict, plan, *, request_id=None, **opts):
        """One admitted multi-operator plan through the program cache:
        the whole plan is one program keyed on the plan digest, so a
        repeat over same-shaped tables builds none. Returns the
        ``QueryResult`` with ``groups``, ``new_traces`` and
        ``request_id``."""
        from distributed_join_tpu_torch.parallel.query_exec import (
            distributed_query,
        )

        plan_digest = plan.digest()
        # the digest folds in tables, operators and options: it IS the
        # workload
        req = _Request(self._admit("query", request_id), "query",
                       sig=f"queryplan-{plan_digest[:16]}")
        agg_rec = None
        try:
            def run_once():
                return distributed_query(
                    tables, plan, self.comm,
                    auto_retry=self.config.auto_retry,
                    program_cache=self.cache, **opts)

            res = self._execute(req, run_once, signature=req.sig)
            groups = None
            agg_wire = plan.ops[-1].aggregate
            if agg_wire is not None:
                groups = _count_groups(res.table.valid)
                agg_rec = dict(agg_wire, groups=groups)
            with self._admit_lock:
                self.query_plans += 1
                if req.new_traces == 0:
                    self.query_warm_hits += 1
                self.query_operators_max = max(self.query_operators_max,
                                               plan.n_operators())
                if groups is not None:
                    self.agg_groups_emitted += groups
            object.__setattr__(res, "groups", groups)
            self._stamp(res, req)
            return res
        except BaseException as exc:
            self._failed(req, exc)
            raise
        finally:
            self._release()
            self._observe(req, plan_digest=plan_digest, aggregate=agg_rec)

    def _table_op(self, op: str, table: str, fn, request_id=None):
        """Admission, exec lock and accounting for the resident table
        ops (register, append, drop): they run prep and merge programs,
        so they carry a join's request semantics."""
        req = _Request(self._admit(op, request_id), op,
                       sig=f"res-tbl-{table}")
        try:
            return self._execute(req, fn, table=table)
        except BaseException as exc:
            self._failed(req, exc)
            raise
        finally:
            self._release()
            req.cache_hits = 0    # a table op's record counts no hits
            handle = self.resident.peek(table)
            self._observe(req, resident={
                "table": table,
                "generation": handle.generation if handle else None})

    def note_refused_resident(self, table: str, request_id,
                              exc: BaseException) -> str:
        """Account a resident request refused before admission (the wire
        handler's handle lookup: an unknown, poisoned or stale table)."""
        with self._admit_lock:
            rid = self._mint_request_id(request_id)
            self.failed += 1
        req = _Request(rid, "resident_join", sig=f"res-tbl-{table}")
        req.err = exc
        self._observe(req, resident={"table": table, "generation": None})
        return rid

    def register_table(self, name: str, build, key="key", *,
                       replace: bool = False, request_id=None,
                       wire_spec=None, wire_probe_state=None) -> dict:
        """Run the build side's partition, shuffle and sort once and hold
        the result resident under ``name`` (the ``register`` op). The wire
        data plane passes its generator spec and the generator's state
        after the build, from which resident joins draw their probes."""
        def doit():
            handle = self.resident.register(name, build, key=key,
                                            replace=replace)
            if wire_spec is not None:
                handle.wire_spec = dict(wire_spec)
                kname = key if isinstance(key, str) else key[0]
                handle.wire_build_keys = build.columns[kname]
                handle.wire_probe_state = wire_probe_state
            return {"table": name, **handle.stats()}

        return self._table_op("register", name, doit, request_id=request_id)

    def append_rows(self, name: str, delta, *,
                    maintain: Optional[bool] = None,
                    request_id=None) -> dict:
        """Land a delta as a sorted run on ``name``'s LSM queue (the
        ``append`` op), merged per ``maintain_runs`` (or now with
        ``maintain=True``)."""
        def doit():
            handle = self.resident.append(name, delta, maintain=maintain)
            return {"table": name, **handle.stats()}

        return self._table_op("append", name, doit, request_id=request_id)

    def drop_table(self, name: str, *, request_id=None) -> dict:
        def doit():
            self.resident.drop(name)
            return {"table": name, "dropped": True}

        return self._table_op("drop", name, doit, request_id=request_id)

    def explain(self, build, probe, key="key", **opts) -> dict:
        """The admission-free dry run (the ``explain`` op): the plan and
        the cost model's prediction of exactly the program a ``join``
        with these tables and options would dispatch at its first rung,
        and the program cache's verdict for it (resident, or a build);
        with the autotuner on, its verdict for the workload (``tuned``).
        Host arithmetic over shapes (the tables may be ``meta``): no
        admission slot, no exec lock, no device. The plan's digest is
        the cache key of that join. Served and failed dry runs show in
        the live metrics, never in the flight recorder."""
        t0 = time.perf_counter()
        try:
            plan = self._plan_for(build, probe, key, opts)
            out = {"plan": plan.as_record(), "cost": plan.cost,
                   "cache": self.cache.predict_hit(plan.digest)}
            if self.tuner is not None:
                # the verdict a join with these tables and options would
                # dispatch under, resolved as the join resolves it (the
                # plan above is the static resolution's)
                out["tuned"] = self.tuner.resolve(
                    self.comm, build, probe, key=key,
                    with_integrity=self.config.verify_integrity,
                    opts=opts).as_record()
        except BaseException:
            self.live.record_request("explain", "failed")
            raise
        self.live.record_request("explain", "served",
                                 latency_s=time.perf_counter() - t0)
        return out

    def _plan_for(self, build, probe, key, opts):
        """The one plan construction of the explain op and of a join's
        prediction: the options as :meth:`join` dispatches them
        (``with_metrics`` passed on, session-resolved when None;
        ``with_integrity`` the service's policy unless given), so the
        digest equals the cache key the join dispatches under."""
        from distributed_join_tpu_torch.planning.plan import explain_join

        o = dict(opts)
        wi = o.pop("with_integrity", self.config.verify_integrity)
        return explain_join(build, probe, self.comm, key=key,
                            verify_integrity=wi, **o)

    def _predicted_wall(self, sig, build, probe, key, opts):
        """``(predicted wall s, plan digest[:16])`` of a request,
        memoized a workload signature. Never fails a request: an option
        set with no plan predicts ``(None, None)``."""
        if sig in self._pred_cache:
            return self._pred_cache[sig]
        try:
            plan = self._plan_for(build, probe, key, opts)
            val = (plan.cost.get("total_s"), plan.digest[:16])
        except Exception:
            val = (None, None)
        if len(self._pred_cache) >= 512:
            self._pred_cache.clear()
        self._pred_cache[sig] = val
        return val

    # -- live observability -------------------------------------------

    def _workload_signature(self, build, probe, key, opts) -> str:
        """The rung-stable workload identity the live layer keys on
        (``planning.tuner.workload_signature``)."""
        from distributed_join_tpu_torch.planning.tuner import (
            workload_signature,
        )

        o = dict(opts)
        wm = o.pop("with_metrics", None)
        wi = o.pop("with_integrity", self.config.verify_integrity)
        return workload_signature(self.comm, build, probe, key=key,
                                  with_metrics=wm, with_integrity=wi, **o)

    def _observe(self, req: _Request, plan_digest=None, resident=None,
                 aggregate=None):
        """Per-request fan-out: live metrics, the flight-recorder ring,
        the history store and the poison-time dump. Guarded whole:
        observability never turns a served request into a failure."""
        try:
            trace = telemetry.current_trace()
            tenant = tel_history.current_tenant()
            elapsed_s = time.perf_counter() - req.t_start
            retry_rec = rung_path = None
            served = req.outcome == "served"
            if served and req.res is not None:
                rr = getattr(req.res, "retry_report", None)
                if rr is not None:
                    retry_rec = rr.as_record()
                    rung_path = [a.action for a in rr.attempts]
            matches = req.matches if served else None
            overflow = req.overflow if served else None
            tuned = (getattr(req.res, "tuned", None)
                     if req.res is not None else None)
            counts = tel_history.retry_counts(retry_rec)
            error = (f"{type(req.err).__name__}: {req.err}"
                     if req.err is not None else None)
            new_traces = req.new_traces
            cache_hits = req.cache_hits or 0
            self.live.record_request(
                req.op, req.outcome,
                latency_s=elapsed_s if served else None,
                signature=req.sig, cache_hits=cache_hits,
                new_traces=new_traces,
                retry_rungs=max(counts["n_attempts"] - 1, 0),
                integrity_retries=counts["integrity_retries"],
                tenant=tenant)
            self.recorder.record(
                request_id=req.rid, op=req.op, signature=req.sig,
                **({"tenant": tenant} if tenant is not None else {}),
                plan_digest=plan_digest, outcome=req.outcome,
                elapsed_s=round(elapsed_s, 6), matches=matches,
                overflow=overflow, new_traces=new_traces,
                cache_hits=cache_hits, rung_path=rung_path,
                tuned=tel_history.tuned_summary(tuned),
                resident=resident, aggregate=aggregate, error=error,
                trace=trace)
            if self.history is not None or self.tuner is not None:
                tel = (getattr(req.res, "telemetry", None)
                       if served and req.res is not None else None)
                metrics = (tel.to_dict() if hasattr(tel, "to_dict")
                           else None)
                entry = tel_history.request_entry(
                    request_id=req.rid, op=req.op, signature=req.sig,
                    outcome=req.outcome, wall_s=elapsed_s,
                    new_traces=new_traces, cache_hits=cache_hits,
                    matches=matches, retry_record=retry_rec,
                    metrics=metrics,
                    predicted_wall_s=req.predicted_wall_s, tuned=tuned,
                    platform=self.device.type, resident=resident,
                    aggregate=aggregate, error=error, trace=trace,
                    tenant=tenant)
                if self.history is not None:
                    self.history.append(entry)
                if self.tuner is not None:
                    # the next request of this signature sees this
                    # outcome, a corrected rung after a mis-sized pre-size
                    self.tuner.observe_entry(entry)
            if req.outcome == "hang":
                self.dump_flight_recorder(
                    f"poisoned: request {req.rid} blew its deadline")
        except Exception as exc:  # noqa: BLE001 - bookkeeping boundary
            telemetry.event("observability_error", request_id=req.rid,
                            error=f"{type(exc).__name__}: {exc}")

    def dump_flight_recorder(self, reason: str) -> Optional[str]:
        """Dump the last-N request ring as ``flightrecorder.json`` (on
        poison, drain and a terminal daemon error; safe any time)."""
        path = self.config.flight_recorder_path
        if path is None:
            s = telemetry.sink()
            base = (s.dir if s is not None
                    else self.config.history_dir
                    or self.config.persist_dir or ".")
            path = os.path.join(base, tel_live.FLIGHT_RECORDER_FILENAME)
        try:
            path = self.recorder.dump(path, reason,
                                      trace=telemetry.current_trace())
        except OSError as exc:
            telemetry.event("flightrecorder_dump_failed", path=path,
                            error=f"{type(exc).__name__}: {exc}")
            return None
        self.flight_recorder_dumped = path
        telemetry.event("flightrecorder_dumped", path=path, reason=reason)
        return path

    # -- lifecycle (drain / quiesce) ----------------------------------

    def quiesce(self, timeout_s: float = 30.0,
                settle_admissions: bool = False) -> bool:
        """Wait (bounded) until no request holds the exec lock; with
        ``settle_admissions``, first until no request is admitted (one
        parked on the lock would dispatch right after a free lock was
        seen). False: something was still running at the bound."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        if settle_admissions:
            while True:
                with self._admit_lock:
                    pending = self._pending
                if pending == 0:
                    break
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.05)
        acquired = self._exec_lock.acquire(
            timeout=max(deadline - time.monotonic(), 0.0))
        if acquired:
            self._exec_lock.release()
        return acquired

    def drain(self, reason: str = "drain requested",
              settle_timeout_s: float = 60.0) -> dict:
        """Graceful drain (the ``drain`` op and SIGTERM): refuse new
        admissions with :class:`DrainingError`, let in-flight requests
        finish (bounded), close the history store and dump the flight
        recorder. Idempotent; returns the settle record."""
        with self._admit_lock:
            first = self.draining is None
            if first:
                self.draining = reason
        if first:
            telemetry.event("service_draining", reason=reason)
        settled = self.quiesce(timeout_s=settle_timeout_s,
                               settle_admissions=True)
        if self.history is not None:
            self.history.close()
        path = self.dump_flight_recorder(f"drained: {reason}")
        with self._admit_lock:
            pending = self._pending
        telemetry.event("service_drained", reason=reason, settled=settled,
                        pending=pending)
        return {"draining": True, "drained": settled, "pending": pending,
                "reason": reason, "flightrecorder": path}

    def stats(self) -> dict:
        """The ``stats`` op's body, the JAX package's keys; on a card also
        ``device_memory`` (this process's allocated and peak bytes on the
        service's device, the fleet's per-replica memory)."""
        with self._admit_lock:
            pending = self._pending
            hwm = self._pending_hwm
        out = {
            "served": self.served,
            "failed": self.failed,
            "rejected": self.rejected,
            "pending": pending,
            "inflight": pending,
            "pending_hwm": hwm,
            "uptime_s": round(self.live.uptime_s(), 3),
            "qps_60s": round(self.live.qps(), 3),
            "latency": self.live.overall_latency(),
            "latency_by_op": self.live.latency_by_op(),
            "poisoned": self.poisoned,
            "draining": self.draining,
            "cache": self.cache.stats(),
            "resident": self.resident.stats(),
            "aggregate": {
                "queries": self.agg_queries,
                "warm_hits": self.agg_warm_hits,
                "groups_emitted": self.agg_groups_emitted,
            },
            "query": {
                "plans": self.query_plans,
                "warm_hits": self.query_warm_hits,
                "operators_max": self.query_operators_max,
            },
            "tuner": (self.tuner.stats() if self.tuner is not None
                      else None),
            "tenants": self.live.tenants_summary(),
        }
        if self.device.type == "cuda":
            out["device_memory"] = {
                "allocated_bytes": torch.cuda.memory_allocated(self.device),
                "peak_bytes": torch.cuda.max_memory_allocated(self.device)}
        return out

    def metrics_snapshot(self) -> dict:
        """The ``metrics`` op's JSON body: the live accumulator plus the
        service and cache counters."""
        snap = self.live.snapshot()
        snap["stats"] = self.stats()
        snap["flight_records"] = len(self.recorder)
        snap["history_path"] = (self.history.path
                                if self.history is not None else None)
        return snap

    def prometheus_metrics(self) -> str:
        """Prometheus text exposition of the same state (the ``metrics``
        op with ``format: "prometheus"``), the JAX package's gauges."""
        st = self.stats()
        cache = st["cache"]
        resident = st["resident"]
        return self.live.to_prometheus(gauges={
            "pending": st["pending"],
            "pending_high_water": st["pending_hwm"],
            "poisoned": int(bool(st["poisoned"])),
            "draining": int(bool(st["draining"])),
            "served_requests": st["served"],
            "failed_requests": st["failed"],
            "rejected_requests": st["rejected"],
            "program_cache_entries": cache["entries"],
            "program_cache_max_entries": cache["max_entries"],
            "program_cache_occupancy": cache["occupancy"],
            "program_cache_hits": cache["hits"],
            "program_cache_misses": cache["misses"],
            "program_cache_traces": cache["traces"],
            "program_cache_disk_loads": cache["disk_loads"],
            "program_cache_disk_load_failures":
                cache["disk_load_failures"],
            "program_cache_disk_persists": cache["disk_persists"],
            "program_cache_lru_evictions": cache["lru_evictions"],
            "program_cache_integrity_evictions":
                cache["integrity_evictions"],
            "program_cache_generation_evictions":
                cache["generation_evictions"],
            "resident_tables": resident["count"],
            "resident_bytes": resident["bytes_resident"],
            "resident_generation_max": resident["generation_max"],
            "resident_probe_joins_total": resident["probe_joins"],
            "resident_warm_probe_joins_total": resident["warm_probe_joins"],
            "resident_refused_total": resident["refused"],
            "agg_queries_total": st["aggregate"]["queries"],
            "agg_warm_hits_total": st["aggregate"]["warm_hits"],
            "agg_groups_emitted_total": st["aggregate"]["groups_emitted"],
            "query_plans_total": st["query"]["plans"],
            "query_warm_hits_total": st["query"]["warm_hits"],
            "query_operators_max": st["query"]["operators_max"],
        })


# -- the wire protocol -------------------------------------------------

# Join options a wire request may set (everything else is server policy).
_WIRE_JOIN_OPTS = (
    "shuffle", "over_decomposition", "shuffle_capacity_factor",
    "out_capacity_factor", "compression_bits", "skew_threshold",
    "dcn_codec", "aggregate", "sort_mode", "sort_segments",
)

# Plan-level defaults a `query` request may set, applied to every
# operator (a plan carries its own fused aggregate).
_WIRE_QUERY_OPTS = (
    "shuffle", "over_decomposition", "shuffle_capacity_factor",
    "out_capacity_factor", "compression_bits", "skew_threshold",
    "dcn_codec",
)


def _tables_from_spec(spec: dict, device):
    """The (build, probe) pair a wire query names: the demo data plane's
    deterministic generator tables, keyed by the request's seed."""
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    return generate_build_probe_tables(
        seed=int(spec.get("seed", 42)),
        build_nrows=int(spec["build_nrows"]),
        probe_nrows=int(spec["probe_nrows"]),
        rand_max=(int(spec["rand_max"]) if spec.get("rand_max") else None),
        selectivity=float(spec.get("selectivity", 0.3)),
        unique_build_keys=bool(spec.get("unique_build_keys", False)),
        device=device)


def _query_from_spec(spec: dict, device):
    """The ``(tables, plan)`` pair a ``query`` request names: the
    canonical TPC-H plan and generator tables keyed by the seed, filtered
    by the query's predicates."""
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_query_tables,
        query_filters,
    )

    q = str(spec.get("query", "q3"))
    plan = tpch_query_plan(q)
    tables = generate_tpch_query_tables(
        seed=int(spec.get("seed", 42)),
        scale_factor=float(spec.get("scale_factor", 0.01)), device=device)
    return query_filters(tables, q), plan


def _join_opts_from_spec(spec: dict) -> dict:
    opts = {k: spec[k] for k in _WIRE_JOIN_OPTS if spec.get(k) is not None}
    if "aggregate" in opts:
        from distributed_join_tpu_torch.ops.aggregate import AggregateSpec

        opts["aggregate"] = AggregateSpec.from_wire(opts["aggregate"])
    return opts


def _build_from_spec(spec: dict, device):
    """The build table a ``register``/``append`` request names, and the
    generator's state after drawing it: the draw is
    ``generate_build_probe_tables(seed=...)``'s build, and its generator
    left in that state draws that call's probe next
    (:func:`_probe_from_spec`)."""
    from distributed_join_tpu_torch.device import resolve_device
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_table,
    )

    rows = int(spec["rows"])
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(spec.get("seed", 42)))
    build = generate_build_table(
        g, rows, int(spec.get("rand_max") or rows),
        unique_keys=bool(spec.get("unique_keys", False)))
    return build, g.get_state()


def _probe_from_spec(spec: dict, handle, device):
    """The probe of a resident ``join`` request, drawn against the
    registered table's base key column, so ``selectivity`` keeps its
    hit-fraction meaning without regenerating the build a request. At
    the registration seed the draw starts from the generator's state
    after the build: the probe ``generate_build_probe_tables`` draws;
    any other seed seeds a generator of its own. A table registered in
    process (no wire spec) falls back to the combined generator at the
    probe's own scale."""
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
        generate_probe_table,
    )

    base = handle.wire_spec or {}
    rows = int(spec["probe_nrows"])
    seed = int(spec.get("seed", base.get("seed", 42)))
    rand_max = (int(spec.get("rand_max") or base.get("rand_max") or 0)
                or int(base.get("rows", rows)))
    selectivity = float(spec.get("selectivity", 0.3))
    keys = handle.wire_build_keys
    if keys is not None:
        g = torch.Generator(device=keys.device)
        if (seed == int(base.get("seed", 42))
                and handle.wire_probe_state is not None):
            g.set_state(handle.wire_probe_state)
        else:
            g.manual_seed(seed)
        return generate_probe_table(g, rows, rand_max, selectivity, keys)
    _, probe = generate_build_probe_tables(
        seed=seed, build_nrows=int(base.get("rows", rows)),
        probe_nrows=rows, rand_max=rand_max, selectivity=selectivity,
        unique_build_keys=bool(base.get("unique_keys", False)),
        device=device)
    return probe


class _Handler(socketserver.StreamRequestHandler):
    """One JSON object per line in -> one JSON object per line out."""

    def handle(self):
        for raw in self.rfile:
            line = raw.decode("utf-8").strip()
            if not line:
                continue
            req = None
            ctx = None
            try:
                req = json.loads(line)
                # adopt the wire-carried trace (a fresh span parented on
                # the sender's) and the request's tenant for its scope
                ctx = tracectx.child_of_wire(req)
                with telemetry.request_scope(None, trace=ctx), \
                        tel_history.tenant_scope(req.get("tenant")), \
                        self.server.service.on_device():
                    resp = self._dispatch(req)
            except Exception as exc:  # noqa: BLE001 - wire boundary: a
                # bad request answers that client, not the daemon
                resp = {"ok": False, "error": type(exc).__name__,
                        "message": str(exc)}
            if ctx is not None and isinstance(resp, dict):
                resp.setdefault(tracectx.TRACE_FIELD, tracectx.to_wire(ctx))
            self.wfile.write((json.dumps(resp) + "\n").encode("utf-8"))
            self.wfile.flush()
            if isinstance(req, dict) \
                    and req.get("op") in ("shutdown", "drain") \
                    and resp.get("ok"):
                return

    def _dispatch(self, req: dict) -> dict:
        service: JoinService = self.server.service
        dev = service.device
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "op": "ping"}
        if op == "stats":
            return {"ok": True, **service.stats()}
        if op == "metrics":
            if req.get("format") == "prometheus":
                return {"ok": True, "op": "metrics", "format": "prometheus",
                        "prometheus": service.prometheus_metrics()}
            return {"ok": True, "op": "metrics",
                    "metrics": service.metrics_snapshot()}
        if op == "shutdown":
            # close the admission window, then wait (bounded) for any
            # request still dispatching on another connection before the
            # reply; shutdown() joins serve_forever, so not on this thread
            with service._admit_lock:
                if service.draining is None:
                    service.draining = "shutdown"
            quiesced = service.quiesce(
                timeout_s=float(req.get("quiesce_timeout_s", 30.0)),
                settle_admissions=True)
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            return {"ok": True, "op": "shutdown", "quiesced": quiesced}
        if op == "drain":
            rec = service.drain(
                reason=str(req.get("reason", "drain wire op")),
                settle_timeout_s=float(req.get("settle_timeout_s", 60.0)))
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            return {"ok": True, "op": "drain", **rec}
        if op == "explain":
            # the spec's shapes as meta tables: no data, no device
            from distributed_join_tpu_torch.planning.plan import (
                abstract_tables,
            )

            build, probe = abstract_tables(int(req["build_nrows"]),
                                           int(req["probe_nrows"]))
            out = service.explain(build, probe, **_join_opts_from_spec(req))
            return {"ok": True, "op": "explain", **out}
        if op == "register":
            build, state = _build_from_spec(req, dev)
            rec = service.register_table(
                str(req["name"]), build,
                replace=bool(req.get("replace", False)),
                request_id=req.get("request_id"),
                wire_spec={k: req[k] for k in
                           ("rows", "seed", "rand_max", "unique_keys")
                           if req.get(k) is not None},
                wire_probe_state=state)
            return {"ok": True, "op": "register", **rec}
        if op == "append":
            delta, _ = _build_from_spec(req, dev)
            rec = service.append_rows(str(req["name"]), delta,
                                      maintain=req.get("maintain"),
                                      request_id=req.get("request_id"))
            return {"ok": True, "op": "append", **rec}
        if op == "drop":
            rec = service.drop_table(str(req["name"]),
                                     request_id=req.get("request_id"))
            return {"ok": True, "op": "drop", **rec}
        if op == "tables":
            return {"ok": True, "op": "tables", **service.resident.stats()}
        if op == "join" and req.get("table"):
            return self._resident_join(service, req)
        if op == "join":
            build, probe = _tables_from_spec(req, dev)
            t0 = time.perf_counter()
            res = service.join(build, probe,
                               request_id=req.get("request_id"),
                               **_join_opts_from_spec(req))
            return {
                "ok": True,
                "request_id": res.request_id,
                "matches": res.matches,
                "groups": getattr(res, "agg_groups", None),
                "overflow": bool(res.overflow),
                "elapsed_s": time.perf_counter() - t0,
                "new_traces": res.new_traces,
                "retry": res.retry_report.as_record(),
                "cache": service.cache.stats(),
            }
        if op == "batch":
            specs = req.get("requests") or []
            pairs = [_tables_from_spec(s, dev) for s in specs]
            t0 = time.perf_counter()
            results = service.join_batched(
                pairs, request_id=req.get("request_id"),
                slot_build_rows=req.get("slot_build_rows"),
                slot_probe_rows=req.get("slot_probe_rows"),
                **_join_opts_from_spec(req))
            return {
                "ok": True,
                "request_id": results[0]["request_id"] if results else None,
                "requests": results,
                "matches": sum(r["matches"] for r in results),
                "elapsed_s": time.perf_counter() - t0,
                "new_traces": results[0]["new_traces"] if results else 0,
                "cache": service.cache.stats(),
            }
        if op == "query":
            tables, plan = _query_from_spec(req, dev)
            opts = {k: req[k] for k in _WIRE_QUERY_OPTS
                    if req.get(k) is not None}
            t0 = time.perf_counter()
            res = service.query(tables, plan,
                                request_id=req.get("request_id"), **opts)
            return {
                "ok": True,
                "request_id": res.request_id,
                "query": req.get("query", "q3"),
                "digest": plan.digest(),
                "n_operators": plan.n_operators(),
                "rows": res.matches,
                "op_totals": [int(t) for t in res.op_totals],
                "groups": res.groups,
                "overflow": bool(res.overflow),
                "retry_attempts": getattr(res, "retry_attempts", 0),
                "elapsed_s": time.perf_counter() - t0,
                "new_traces": res.new_traces,
                "cache": service.cache.stats(),
            }
        raise ValueError(f"unknown op {op!r} (ops: ping, stats, metrics, "
                         "explain, join, batch, query, register, append, "
                         "tables, drop, drain, shutdown)")

    @staticmethod
    def _resident_join(service: JoinService, req: dict) -> dict:
        """Probe-only serving against a registered table: the wire ships
        the probe spec only."""
        from distributed_join_tpu_torch.service.resident import (
            ResidentError,
            StaleGenerationError,
        )

        name = str(req["table"])
        try:
            handle = service.resident.get(name)
        except ResidentError as exc:
            # refused before admission, and still observed
            service.note_refused_resident(name, req.get("request_id"), exc)
            raise
        ming = req.get("min_generation")
        if ming is not None and handle.generation < int(ming):
            # generation fence: this holder missed an append
            exc = StaleGenerationError(
                f"resident table {name!r} is at generation "
                f"{handle.generation} < required {int(ming)} (this holder "
                "missed an append); probe-only serving refused — retry on "
                "an up-to-date holder")
            service.note_refused_resident(name, req.get("request_id"), exc)
            raise exc
        probe = _probe_from_spec(req, handle, service.device)
        t0 = time.perf_counter()
        res = service.resident_join(name, probe,
                                    request_id=req.get("request_id"),
                                    **_join_opts_from_spec(req))
        return {
            "ok": True,
            "request_id": res.request_id,
            "table": name,
            "resident": getattr(res, "resident", None),
            "matches": res.matches,
            "groups": getattr(res, "agg_groups", None),
            "overflow": bool(res.overflow),
            "elapsed_s": time.perf_counter() - t0,
            "new_traces": res.new_traces,
            "retry": res.retry_report.as_record(),
            "cache": service.cache.stats(),
        }


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service: JoinService):
        super().__init__(addr, _Handler)
        self.service = service


def start_daemon(service: JoinService, host: str = "127.0.0.1",
                 port: int = 0):
    """Bind and serve on a background thread; returns ``(server, port)``.
    ``server.shutdown()`` (or the wire ``shutdown`` op) stops it."""
    server = _Server((host, port), service)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


class ServiceClient:
    """Line-protocol client over one persistent connection (the smoke,
    the ``--watch`` console and tests; a template for real callers).

    ``retries`` arms bounded reconnect with jittered exponential backoff:
    a torn connection, a half-written response line or a restarting
    daemon is reconnected and the payload resent, but only for the
    idempotent ops (:data:`RESENDABLE_OPS`). A mutating op whose
    connection tears after the write may have been applied, so it fails
    loudly instead. The terminal :class:`ConnectionError` gives the
    attempt count; ``retries=0`` fails on the first tear."""

    RESENDABLE_OPS = frozenset(
        ("ping", "stats", "metrics", "explain", "tables", "join", "batch"))

    def __init__(self, host: str, port: int, timeout_s: float = 600.0, *,
                 retries: int = 0, backoff_s: float = 0.2):
        self._addr = (host, port)
        self._timeout_s = timeout_s
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._sock = None
        self._file = None
        self._with_retries(self._connect, "connect to")

    def _connect(self):
        self.close()
        self._sock = socket.create_connection(self._addr, self._timeout_s)
        self._file = self._sock.makefile("rw", encoding="utf-8",
                                         newline="\n")

    def _with_retries(self, fn, what: str):
        import random

        attempts = 0
        delay = self.backoff_s
        while True:
            attempts += 1
            try:
                return fn()
            except (OSError, ValueError) as exc:
                # OSError: refused, reset, timeout; ValueError: a torn
                # response line. _no_resend marks the mutating-op guard.
                self.close()
                if attempts > self.retries \
                        or getattr(exc, "_no_resend", False):
                    raise ConnectionError(
                        f"cannot {what} {self._addr[0]}:{self._addr[1]} "
                        f"after {attempts} attempt(s): "
                        f"{type(exc).__name__}: {exc}") from exc
                time.sleep(delay * random.uniform(0.5, 1.5))
                delay *= 2

    def send(self, payload: dict) -> dict:
        # every op carries a trace context: the caller's, or one minted
        # here once per logical send, so a resend joins the same trace
        if payload.get(tracectx.TRACE_FIELD) is None:
            payload = tracectx.attach(payload, tracectx.mint())
        ctx = tracectx.from_wire(payload)
        resendable = payload.get("op") in self.RESENDABLE_OPS
        wrote = {"flag": False}

        def once():
            if self._file is None:
                self._connect()
            if wrote["flag"]:
                telemetry.event("client_resend", op=payload.get("op"),
                                request_id=payload.get("request_id"),
                                **tracectx.stamp(ctx))
            if wrote["flag"] and not resendable:
                err = ConnectionError(
                    f"connection torn after sending mutating op "
                    f"{payload.get('op')!r}; not resending (the op may "
                    "already have been applied)")
                err._no_resend = True
                raise err
            wrote["flag"] = True
            self._file.write(json.dumps(payload) + "\n")
            self._file.flush()
            line = self._file.readline()
            if not line:
                raise ConnectionError("service closed the connection")
            return json.loads(line)

        return self._with_retries(once, "reach")

    def close(self) -> None:
        for h in (self._file, self._sock):
            try:
                if h is not None:
                    h.close()
            except OSError:  # pragma: no cover - teardown boundary
                pass
        self._file = self._sock = None


# -- the operator watch console ----------------------------------------


def watch(host: str, port: int, interval_s: float = 2.0, count: int = 0,
          out=None, retries: int = 3, trace_id: Optional[str] = None) -> int:
    """Poll a running daemon's ``metrics`` op and print one console line
    a poll (read only: no device, works from any machine that reaches
    the port). ``count=0`` polls until interrupted. A daemon gone past
    the client's reconnect budget yields one line and rc 1."""
    out = out or sys.stdout
    try:
        client = ServiceClient(host, port, timeout_s=30.0, retries=retries)
    except OSError as exc:
        print(f"cannot reach daemon at {host}:{port}: {exc}", file=out,
              flush=True)
        return 1
    polls = 0

    def ms(v):
        return f"{v * 1e3:.1f}ms" if v else "-"

    try:
        while True:
            poll: dict = {"op": "metrics"}
            if trace_id:
                poll = tracectx.attach(poll, tracectx.mint(trace_id))
            resp = client.send(poll)
            if not resp.get("ok"):
                print(f"metrics op failed: {resp}", file=out, flush=True)
                return 1
            m = resp["metrics"]
            st = m["stats"]
            lat = st.get("latency") or {}
            line = (
                f"up {m['uptime_s']:8.1f}s  "
                f"qps {m['qps_60s']:6.2f}  "
                f"served {st['served']:6d}  "
                f"failed {st['failed']:4d}  "
                f"rejected {st['rejected']:4d}  "
                f"inflight {st['inflight']:2d}  "
                f"p50 {ms(lat.get('p50_s'))}  "
                f"p95 {ms(lat.get('p95_s'))}  "
                f"p99 {ms(lat.get('p99_s'))}  "
                f"cache {st['cache']['hits']}h/"
                f"{st['cache']['traces']}t"
            )
            for opname, ol in sorted(
                    (st.get("latency_by_op") or {}).items()):
                line += (f"  {opname}[{ms(ol.get('p50_s'))}/"
                         f"{ms(ol.get('p95_s'))}/"
                         f"{ms(ol.get('p99_s'))}]")
            for tname, ts in sorted((st.get("tenants") or {}).items()):
                tlat = ts.get("latency") or {}
                line += (f"  {tname}{{qps {ts.get('qps_60s') or 0:.2f} "
                         f"shed {ts.get('shed') or 0} p95 "
                         f"{ms(tlat.get('p95_s'))}}}")
            if st.get("poisoned"):
                line += f"  POISONED: {st['poisoned']}"
            print(line, file=out, flush=True)
            polls += 1
            if count and polls >= count:
                return 0
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0
    except (OSError, ValueError) as exc:
        print(f"lost daemon at {host}:{port}: {exc}", file=out, flush=True)
        return 1
    finally:
        client.close()


# -- the CLI daemon ----------------------------------------------------

def _refused_flags() -> dict:
    return {
        "--platform": "platform selection (the JAX package's backend "
                      "choice; the daemon serves on --device)",
    }


def parse_args(argv=None):
    from distributed_join_tpu_torch.benchmarks import (
        add_auto_tune_arg,
        add_chaos_arg,
        add_guard_arg,
        add_telemetry_args,
        refuse_flags,
    )

    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    refuse_flags(p, argv, _refused_flags())
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = ephemeral; the bound port is printed "
                        "on the 'listening' line)")
    p.add_argument("--communicator",
                   choices=["local", "emulated", "nccl", "gloo"],
                   default="local",
                   help="local = one rank (one card); emulated = --n-ranks "
                        "ranks in one process on one device; nccl / gloo "
                        "= a process group of one rank (more refuse)")
    p.add_argument("--n-ranks", type=int, default=None,
                   help="ranks of the emulated communicator")
    p.add_argument("--slices", type=int, default=None,
                   help="serve on a (slice, chip) hierarchical mesh; wire "
                        "joins may then request shuffle='hierarchical'")
    p.add_argument("--device", default=None,
                   help="where the tables live: default the GPU; 'cpu' "
                        "only for rehearsals and tests")
    p.add_argument("--auto-retry", type=int, default=2,
                   help="capacity-ladder budget applied to every request "
                        "(rungs reuse cached programs)")
    p.add_argument("--verify-integrity", action="store_true",
                   help="verify every request's shuffle wire with the "
                        "per-(src, dst) digests (parallel/integrity.py): a "
                        "mismatch evicts the program and reruns the same "
                        "sizing within --auto-retry, then fails the "
                        "request with IntegrityError instead of returning "
                        "corrupt rows")
    p.add_argument("--max-pending", type=int, default=8,
                   help="admission bound: requests beyond this many "
                        "pending are refused, not queued")
    p.add_argument("--max-batch-requests", type=int, default=64)
    p.add_argument("--max-programs", type=int, default=128,
                   help="program cache bound (least recently used out "
                        "first): every table shape is a program")
    p.add_argument("--max-resident-tables", type=int, default=8,
                   help="resident build tables held at once (register "
                        "refuses beyond this)")
    p.add_argument("--resident-capacity-factor", type=float, default=1.5,
                   help="delta headroom a registration sizes its resident "
                        "shards with")
    p.add_argument("--maintain-runs", type=int, default=4,
                   help="pending LSM delta runs that trigger the "
                        "maintenance merge on append")
    p.add_argument("--persist-dir", default=None, metavar="DIR",
                   help="the program cache's disk tier: one entry a "
                        "built program (its signature, backend and "
                        "kernel digests) under DIR, so a restarted "
                        "daemon, or a replica sharing DIR, binds it with "
                        "no new trace")
    p.add_argument("--history-dir", default=None, metavar="DIR",
                   help="append one workload-history line a request to "
                        "DIR/history.jsonl (telemetry/history.py). "
                        "Default: --persist-dir when set")
    p.add_argument("--history-max-entries", type=int, default=None,
                   metavar="N",
                   help="keep the last N live entries a workload "
                        "signature, rolling older ones up. Default: "
                        "unbounded")
    p.add_argument("--flight-records", type=int, default=256,
                   help="flight-recorder ring size")
    p.add_argument("--flight-recorder-path", default=None, metavar="FILE",
                   help="where the flight-recorder dump lands (default: "
                        "the telemetry session dir, else the history dir, "
                        "else ./flightrecorder.json)")
    p.add_argument("--watch", action="store_true",
                   help="do not serve: poll the running daemon at "
                        "--host/--port and print one metrics line a poll")
    p.add_argument("--watch-interval-s", type=float, default=2.0)
    p.add_argument("--watch-count", type=int, default=0,
                   help="stop --watch after N polls (0 = until "
                        "interrupted)")
    p.add_argument("--trace-id", default=None, metavar="ID",
                   help="client-minted trace id attached to every --watch "
                        "poll and smoke request")
    p.add_argument("--smoke", action="store_true",
                   help="run the smoke protocol against an in-process "
                        "daemon instead of serving: warm-cache discipline, "
                        "batched against sequential, metrics scrape, "
                        "resident and poison drills; JSON record on "
                        "stdout")
    p.add_argument("--smoke-small-rows", type=int, default=256)
    p.add_argument("--smoke-batch", type=int, default=16)
    p.add_argument("--smoke-resident-joins", type=int, default=3)
    p.add_argument("--smoke-no-wall-gate", action="store_true",
                   help="report the smoke's wall clocks but do not fail on "
                        "them")
    p.add_argument("--smoke-baseline-dir", default=SMOKE_BASELINE_DIR,
                   metavar="DIR",
                   help="where the smoke's counter-signature baselines "
                        "(service_smoke.json, resident_smoke.json) live; "
                        "a baseline gates a run at its own rank count and "
                        "device type, and a missing one is reported as "
                        "skipped (default: the repository's "
                        "results/baselines_torch)")
    p.add_argument("--fault-plan", default=None, metavar="JSON",
                   help="wrap the communicator in a scripted FaultPlan "
                        "(parallel/faults.py fields as one JSON object, "
                        "e.g. '{\"dispatch_delay_s\": 3.0}')")
    p.add_argument("--json-output", default=None)
    add_telemetry_args(p)
    add_guard_arg(p)
    add_auto_tune_arg(p)
    add_chaos_arg(p)
    return p.parse_args(argv)


def _service_from_args(args) -> JoinService:
    from distributed_join_tpu_torch.benchmarks import (
        maybe_chaos_communicator,
    )
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )

    comm = maybe_chaos_communicator(
        make_communicator(args.communicator, n_ranks=args.n_ranks,
                          n_slices=args.slices), args)
    if args.fault_plan:
        from distributed_join_tpu_torch.parallel.faults import (
            FaultInjectingCommunicator,
            plan_from_record,
        )

        comm = FaultInjectingCommunicator(
            comm, plan_from_record(json.loads(args.fault_plan)))
    cfg = ServiceConfig(
        auto_retry=args.auto_retry,
        verify_integrity=args.verify_integrity,
        request_deadline_s=args.request_deadline_s,
        max_pending=args.max_pending,
        max_batch_requests=args.max_batch_requests,
        max_programs=args.max_programs,
        persist_dir=args.persist_dir,
        history_dir=args.history_dir,
        history_max_entries=args.history_max_entries,
        # bare --auto-tune learns from the service's own history store; a
        # PATH also preloads that file's trends (JAX :2096-2100)
        auto_tune=args.auto_tune is not None,
        tuner_history=(args.auto_tune or None),
        flight_records=args.flight_records,
        flight_recorder_path=args.flight_recorder_path,
        max_resident_tables=args.max_resident_tables,
        resident_capacity_factor=args.resident_capacity_factor,
        maintain_runs=args.maintain_runs,
    )
    return JoinService(comm, cfg, device=args.device)


def run(args) -> dict:
    from distributed_join_tpu_torch.benchmarks import report

    service = _service_from_args(args)
    if args.smoke:
        record = run_smoke(service, args)
    else:
        server = _Server((args.host, args.port), service)
        port = server.server_address[1]

        def _drain_and_stop():
            service.drain(reason="SIGTERM")
            server.shutdown()

        def _on_sigterm(signum, frame):  # noqa: ARG001 - signal API
            # drain off the signal frame, then stop serving: rc 0
            threading.Thread(target=_drain_and_stop, daemon=True).start()

        try:
            import signal

            # before the listening line: a supervisor that signals the
            # moment the port is announced must hit the graceful path
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # pragma: no cover - non-main thread
            pass
        print(f"join-service listening on {args.host}:{port}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        except BaseException:
            service.dump_flight_recorder("daemon terminal error")
            raise
        finally:
            server.server_close()
        record = {"benchmark": "service", **service.stats()}
    report(record, args.json_output, headline=(
        f"join-service: {record.get('served', 0)} request(s) served, "
        f"{record['cache']['traces']} trace(s), "
        f"{record['cache']['hits']} cache hit(s)"))
    return record


def _join_watchdog_workers(timeout_s: float = 120.0) -> None:
    """Join the detached workers of hung requests: each still runs its
    join, and must not overlap the next work or the interpreter's
    exit."""
    for t in threading.enumerate():
        if t.name.startswith("watchdog-request"):
            t.join(timeout=timeout_s)


def _poison_drill(args, device) -> dict:
    """The smoke's fail-stop rehearsal on a throwaway service (its own
    communicator and cache): a fault-delayed request blows its deadline,
    the service is poisoned, the next request refuses, and the flight
    recorder dumps ``flightrecorder.json``."""
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )
    from distributed_join_tpu_torch.parallel.watchdog import HangError
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    comm = FaultInjectingCommunicator(
        make_communicator(args.communicator, n_ranks=args.n_ranks),
        FaultPlan(dispatch_delay_s=3.0))
    drill = JoinService(comm, ServiceConfig(
        auto_retry=0, request_deadline_s=0.75,
        flight_recorder_path=args.flight_recorder_path), device=device)
    with drill.on_device():
        b, p = generate_build_probe_tables(
            seed=11, build_nrows=512, probe_nrows=1024, rand_max=256,
            selectivity=0.5, device=drill.device)
    try:
        try:
            drill.join(b, p, out_capacity_factor=4.0)
        except HangError:
            pass
        else:
            raise RuntimeError(
                "poison drill: the delayed request did not hang")
        if not drill.poisoned:
            raise RuntimeError("poison drill: service was not poisoned")
        try:
            drill.join(b, p, out_capacity_factor=4.0)
        except AdmissionError:
            pass
        else:
            raise RuntimeError(
                "poison drill: the poisoned service accepted a join")
        path = drill.flight_recorder_dumped
        if not path or not os.path.exists(path):
            raise RuntimeError("poison drill: no flightrecorder.json was "
                               "dumped on poison")
    finally:
        _join_watchdog_workers()
    return {
        "poisoned": True,
        "flightrecorder": path,
        "flight_records": len(drill.recorder),
        "rejected_after_poison": drill.rejected,
    }


def _resident_drill(service: JoinService, args, violations) -> dict:
    """The smoke's resident A/B, in process: register a build once, then
    N pairs of one cold full join and one probe-only join of the same
    query, run back to back, the side that goes first alternating from
    pair to pair. The warm probe-only joins build no program and, unless
    ``--smoke-no-wall-gate``, beat the warm full joins pair by pair: the
    median over the pairs of the full join's wall over the probe-only
    join's must exceed 1. A pair's two joins share the host's speed of
    the moment, so its ratio cancels a drift that the two sides'
    separate medians do not (at the drill's ~2 ms a join the host's
    speed wanders by more than the two sides differ). After two LSM
    delta merges the probe-only answer equals the numpy oracle over the
    combined build."""
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
        generate_build_table,
    )
    from distributed_join_tpu_torch.utils.tpch_host import inner_match

    n_joins = args.smoke_resident_joins
    dev = service.device
    with service.on_device():
        build, probe = generate_build_probe_tables(
            seed=7, build_nrows=16384, probe_nrows=2048, rand_max=8192,
            selectivity=0.5, device=dev)
        deltas = []
        for s in (8, 9):
            g = torch.Generator(device=dev)
            g.manual_seed(s)
            deltas.append(generate_build_table(g, 1024, 8192))
    opts = dict(out_capacity_factor=3.0)
    name = "smoke_dim"

    reg = service.register_table(name, build)

    sides = {"cold": lambda: service.join(build, probe, **opts),
             "probe_only": lambda: service.resident_join(name, probe,
                                                         **opts)}
    walls = {side: [] for side in sides}
    matches = {side: [] for side in sides}
    traces = dict.fromkeys(sides, 0)
    # both programs built outside the timing
    for fn in sides.values():
        fn()
    order = list(sides)
    for i in range(n_joins):
        # neither side always runs right after the other
        for side in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            res = sides[side]()
            walls[side].append(time.perf_counter() - t0)
            matches[side].append(res.matches)
            traces[side] += res.new_traces
    cold_walls, po_walls = walls["cold"], walls["probe_only"]
    cold_matches, po_matches = matches["cold"], matches["probe_only"]
    cold_traces, po_traces = traces["cold"], traces["probe_only"]
    cold_med = statistics.median(cold_walls)
    po_med = statistics.median(po_walls)
    pair_ratios = [c / p for c, p in zip(cold_walls, po_walls)]
    pair_ratio = statistics.median(pair_ratios)
    pair_wins = sum(r > 1 for r in pair_ratios)
    if po_traces or cold_traces:
        violations.append(
            f"resident drill: timed warm passes traced programs "
            f"(probe-only {po_traces}, cold {cold_traces})")
    if po_matches != cold_matches:
        violations.append(
            f"resident drill: probe-only matches {po_matches} != cold "
            f"full-join matches {cold_matches}")
    if pair_ratio <= 1 and not args.smoke_no_wall_gate:
        violations.append(
            f"resident drill: warm probe-only won {pair_wins} of "
            f"{len(pair_ratios)} pairs against the warm cold full join "
            f"(median full / probe-only wall {pair_ratio:.4f}; medians "
            f"{cold_med:.4f}s full, {po_med:.4f}s probe-only)")

    for d in deltas:
        service.append_rows(name, d, maintain=True)
    handle = service.resident.get(name)
    res_after = service.resident_join(name, probe, **opts)
    res_warm = service.resident_join(name, probe, **opts)
    if res_warm.new_traces:
        violations.append("resident drill: post-append warm repeat traced "
                          f"{res_warm.new_traces} program(s)")
    combined = torch.cat([build.columns["key"]]
                         + [d.columns["key"] for d in deltas])
    _, _, cnt = inner_match(combined.cpu().numpy(),
                            probe.columns["key"].cpu().numpy())
    oracle_after = int(cnt.sum())
    if res_after.matches != oracle_after:
        violations.append(
            f"resident drill: matches after {len(deltas)} LSM merges = "
            f"{res_after.matches} != numpy oracle {oracle_after}")
    if handle.generation != 1 + len(deltas):
        violations.append(
            f"resident drill: generation {handle.generation} != "
            f"{1 + len(deltas)} after {len(deltas)} appends")

    stats = service.resident.stats()
    return {
        "kind": "resident_drill",
        "benchmark": "resident_smoke",
        "n_ranks": service.comm.n_ranks,
        "table": name,
        "registered_rows": reg["rows"],
        "joins_per_side": n_joins,
        "cold_wall_min_s": min(cold_walls),
        "probe_only_wall_min_s": min(po_walls),
        "cold_wall_median_s": cold_med,
        "probe_only_wall_median_s": po_med,
        # the gated ratio: the median over the pairs of full / probe-only
        "probe_only_speedup": pair_ratio,
        "probe_only_pair_wins": pair_wins,
        "matches_cold": cold_matches[0],
        "matches_probe_only": po_matches[0],
        "matches_after_appends": res_after.matches,
        "resident": stats["tables"][name],
        "platform": dev.type,
        # the gate's body: integer counters only, never walls (JAX
        # :2322-2338)
        "counter_signature": {
            "signature_version": baselines.SIGNATURE_SCHEMA_VERSION,
            "n_ranks": service.comm.n_ranks,
            "counters": {
                "base_rows": reg["rows"],
                "delta_rows_appended": sum(d.capacity for d in deltas),
                "generation": handle.generation,
                "lsm_merges": stats["tables"][name]["merges"],
                "matches_cold": cold_matches[0],
                "matches_probe_only": po_matches[0],
                "matches_after_appends": res_after.matches,
                "warm_probe_new_traces": po_traces,
                "resident_bytes": stats["tables"][name]["bytes_resident"],
            },
        },
    }


def _batched_signature(service: JoinService, small: list) -> dict:
    """The counter signature of the smoke's micro-batched join: the same
    requests combined as the ``batch`` op combines them, joined once
    with the metrics tape, outside the service's accounting (the JAX
    lane's session block of that join)."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )

    with service.on_device():
        pairs = [_tables_from_spec(s, service.device) for s in small]
        mb = batching.combine(pairs, key="key")
        res = distributed_inner_join(
            mb.build, mb.probe, service.comm, key=list(mb.key),
            auto_retry=service.config.auto_retry, with_metrics=True,
            out_capacity_factor=3.0)
    return baselines.counter_signature(res.telemetry)


def _baseline_gate(name: str, sig: dict, platform: str,
                   baseline_dir: str) -> dict:
    """``sig`` against ``<baseline_dir>/<name>.json``: the comparison's
    record, or ``{"skipped": why}`` when there is no baseline or it was
    drawn at another rank count or device type (its counters come from
    other tables)."""
    path = baselines.baseline_path(name, baseline_dir)
    if not os.path.exists(path):
        return {"skipped": f"no baseline at {path}"}
    base = baselines.load_baseline(name, baseline_dir)
    cfg = base.get("config") or {}
    want = (base["signature"].get("n_ranks"), cfg.get("platform"))
    got = (sig.get("n_ranks"), platform)
    if want != got:
        return {"skipped": f"{path} was drawn at (n_ranks, platform) "
                           f"{want}, this run is {got}"}
    return baselines.compare(base, sig).as_record()


def run_smoke(service: JoinService, args) -> dict:
    """The acceptance protocol, end to end through the daemon's TCP loop:

    1. a cold query builds its program; the identical warm repeat builds
       none, and the two responses carry distinct request ids; an
       ``explain`` of the same query builds none and predicts its
       program as resident;
    2. N small joins, warmed, timed sequentially against micro-batched
       (one dispatch): equal per-request matches, and the batch must win
       the wall clock (unless ``--smoke-no-wall-gate``);
    3. the ``metrics`` op gives ordered, non-degenerate latency
       quantiles and a Prometheus text with ``djtpu_requests_total``;
       ``stats`` carries the uptime and the pending high-water mark;
    4. the resident drill, then the poison drill on a throwaway service;
       with ``--history-dir``, the history holds >= 2 signatures;
    5. the baseline gate: the micro-batched join's counter signature
       (one more join of the batch, with the metrics tape) and the
       resident drill's against ``--smoke-baseline-dir``'s
       ``service_smoke`` and ``resident_smoke`` (:func:`_baseline_gate`);
       a drift is a violation.

    Raises RuntimeError on any violation."""
    server, port = start_daemon(service, "127.0.0.1", 0)
    client = ServiceClient("127.0.0.1", port, retries=2)
    violations = []

    def send_ok(payload, what):
        if getattr(args, "trace_id", None):
            payload = tracectx.attach(payload,
                                      tracectx.mint(args.trace_id))
        resp = client.send(payload)
        if not resp.get("ok"):
            raise RuntimeError(f"{what} failed: {resp}")
        return resp

    try:
        q = {"op": "join", "build_nrows": 4096, "probe_nrows": 4096,
             "seed": 42, "selectivity": 0.3, "out_capacity_factor": 3.0}
        cold = send_ok(q, "cold query")
        warm = send_ok(q, "warm query")
        if warm["new_traces"] != 0:
            violations.append(
                f"warm repeat traced {warm['new_traces']} new program(s); "
                "the warm path must be run-only")
        if warm["matches"] != cold["matches"]:
            violations.append("warm matches != cold matches")
        if not cold.get("request_id") or not warm.get("request_id"):
            violations.append("join responses did not echo a request_id")
        elif warm["request_id"] == cold["request_id"]:
            violations.append("request ids are not unique per request")

        # the explain dry run of the query just served: no build, and
        # its program predicted resident
        traces_before = client.send({"op": "stats"})["cache"]["traces"]
        exp = send_ok({**{kk: v for kk, v in q.items() if kk != "op"},
                       "op": "explain"}, "explain dry-run")
        traces_after = client.send({"op": "stats"})["cache"]["traces"]
        if traces_after != traces_before:
            violations.append(
                f"explain op built {traces_after - traces_before} "
                "program(s); the dry run must build none")
        if not exp.get("plan", {}).get("signature_digest"):
            violations.append("explain response carries no plan digest")
        if not exp.get("cache", {}).get("resident"):
            violations.append(
                "explain did not predict the warm query's program as "
                f"resident: {exp.get('cache')}")

        rows = args.smoke_small_rows
        small = [
            {"op": "join", "build_nrows": rows, "probe_nrows": rows,
             "seed": 100 + i, "selectivity": 0.5,
             "rand_max": max(rows // 2, 1), "out_capacity_factor": 3.0}
            for i in range(args.smoke_batch)
        ]
        batch_req = {
            "op": "batch", "out_capacity_factor": 3.0,
            "requests": [{k: v for k, v in s.items() if k != "op"}
                         for s in small],
        }
        seq_warm = [send_ok(s, "sequential warm-up") for s in small]
        send_ok(batch_req, "batch warm-up")
        t0 = time.perf_counter()
        seq = [send_ok(s, "timed sequential") for s in small]
        seq_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batched = send_ok(batch_req, "timed batch")
        batched_s = time.perf_counter() - t0
        if any(r["new_traces"] for r in seq) or batched["new_traces"]:
            violations.append("timed pass traced new programs")
        seq_matches = [r["matches"] for r in seq]
        batch_matches = [r["matches"] for r in batched["requests"]]
        if seq_matches != batch_matches:
            violations.append(
                f"batched per-request matches {batch_matches} != "
                f"sequential {seq_matches}: cross-request contamination "
                "or lost rows")
        if batched_s >= seq_s and not args.smoke_no_wall_gate:
            violations.append(
                f"batched step ({batched_s:.4f}s) did not beat "
                f"{len(small)} sequential warm calls ({seq_s:.4f}s)")

        met = send_ok({"op": "metrics"}, "metrics scrape")
        join_lat = met["metrics"]["ops"]["join"]["latency"]
        p50, p95, p99 = (join_lat.get("p50_s"), join_lat.get("p95_s"),
                         join_lat.get("p99_s"))
        if not p50 or not p95 or not p99 or not (p50 <= p95 <= p99):
            violations.append(
                "degenerate latency quantiles after warm traffic: "
                f"p50={p50} p95={p95} p99={p99}")
        prom = send_ok({"op": "metrics", "format": "prometheus"},
                       "prometheus scrape")
        if "djtpu_requests_total" not in prom.get("prometheus", ""):
            violations.append("prometheus exposition is missing "
                              "djtpu_requests_total")

        stats = client.send({"op": "stats"})
        if stats.get("uptime_s") is None or \
                stats.get("pending_hwm", 0) < 1:
            violations.append(
                "stats is missing uptime/admission high-water mark")
        client.send({"op": "shutdown"})
    finally:
        client.close()
        server.server_close()

    history_info = None
    if service.history is not None:
        entries, _ = tel_history.load_history(service.history.path)
        hsum = tel_history.summarize(entries)
        history_info = {"path": service.history.path,
                        "n_entries": hsum["n_entries"],
                        "n_signatures": hsum["n_signatures"]}
        if hsum["n_signatures"] < 2:
            violations.append(
                f"history store holds {hsum['n_signatures']} "
                "signature(s); the smoke's traffic spans >= 2")

    # the wire shutdown closed the admission window; the in-process
    # drills stand in for a fresh incarnation sharing the warm caches
    with service._admit_lock:
        service.draining = None
    resident_drill = _resident_drill(service, args, violations)
    service_sig = _batched_signature(service, small)
    platform = service.device.type
    baseline_dir = getattr(args, "smoke_baseline_dir", None) \
        or SMOKE_BASELINE_DIR
    gate = {name: _baseline_gate(name, sig, platform, baseline_dir)
            for name, sig in (
                ("service_smoke", service_sig),
                ("resident_smoke", resident_drill["counter_signature"]))}
    for name, verdict in gate.items():
        if verdict.get("ok") is False:
            violations.append(
                f"baseline gate {name}: drifted {verdict['drifted']}, "
                f"missing {verdict['missing']}")
    drill = _poison_drill(args, service.device)

    record = {
        "benchmark": "service_smoke",
        "n_ranks": service.comm.n_ranks,
        "device": str(service.device),
        "platform": platform,
        "counter_signature": service_sig,
        "baseline_gate": gate,
        "warm_new_traces": warm["new_traces"],
        "matches_per_join": cold["matches"],
        "explain": {
            "plan_digest": exp.get("plan", {}).get("signature_digest"),
            "predicted_wall_s": exp.get("cost", {}).get("total_s"),
            "cache": exp.get("cache"),
        },
        "small_rows": args.smoke_small_rows,
        "batch_requests": args.smoke_batch,
        "sequential_s": seq_s,
        "batched_s": batched_s,
        "batched_speedup": seq_s / batched_s if batched_s else None,
        "batch_matches": batch_matches,
        "served": stats["served"],
        "uptime_s": stats.get("uptime_s"),
        "latency": stats.get("latency"),
        "qps_60s": stats.get("qps_60s"),
        "pending_hwm": stats.get("pending_hwm"),
        "cache": stats["cache"],
        "history": history_info,
        "resident_drill": resident_drill,
        "poison_drill": drill,
        "violations": violations,
        "warmup_sequential_matches": [r["matches"] for r in seq_warm],
    }
    if violations:
        from distributed_join_tpu_torch.benchmarks import report

        report(record, args.json_output, headline="service smoke FAILED")
        raise RuntimeError("service smoke violations: "
                           + "; ".join(violations))
    return record


def main(argv=None):
    from distributed_join_tpu_torch.benchmarks import run_guarded
    from distributed_join_tpu_torch.parallel.watchdog import (
        resolve_guard_deadline,
    )

    args = parse_args(argv)
    if args.watch:
        # read-only console against a running daemon: no device
        if not args.port:
            print("--watch needs the --port of a running daemon",
                  file=sys.stderr)
            return 2
        return watch(args.host, args.port, interval_s=args.watch_interval_s,
                     count=args.watch_count, trace_id=args.trace_id)
    # --guard-deadline-s bounds each request, not the daemon: resolve it
    # now, then zero it so run_guarded leaves the server unguarded
    args.request_deadline_s = resolve_guard_deadline(args)
    args.guard_deadline_s = 0
    return run_guarded(run, args, benchmark="service")


if __name__ == "__main__":
    sys.exit(main())
