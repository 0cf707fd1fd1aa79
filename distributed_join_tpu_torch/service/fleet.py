"""The serving fleet: a signature-affinity router over N join daemons.

Port of ``distributed_join_tpu/service/fleet.py``, whole and in the
reference's order: the errors and the durable-state constants
(:125-165), ``FleetConfig`` (:167-250), the table manifests and the
router directory (:251-307), ``RouterLease`` (:309-386), the replica
backends ``ProcessReplica``, ``InProcessReplica`` and
``AttachedReplica`` (:388-508), the two factories (:509-602),
``_Replica``, ``_AffinityStub``, ``affinity_key`` and ``affine_replica``
(:604-710), ``_TenantState`` (:712-757), ``FleetRouter`` (:758-2723:
lifecycle, probe, strike, drain and replace; tenant admission and the
priority shed; the autoscaler and its pre-warm gate; dispatch and
failover; the K-replica register, append and drop fan-out with
generation fencing and the manifest-driven holder rebuild; the flight
recorder, ``stats`` and Prometheus), ``_route`` and
``start_router_daemon`` (:2734-2843), ``RouterHA`` (:2844-3024), the
four smokes ``run_fleet_smoke``, ``run_tenant_smoke``,
``run_tracing_smoke`` and ``run_fleet_ha_smoke`` (:3025-4294), and the
CLI (:4295-4537). The router is host Python over the line-JSON wire:
it makes the same routing, lifecycle, admission, replication and HA
decisions as the JAX router for the same requests and faults, and
serves the same protocol as one daemon
(``python -m distributed_join_tpu_torch.service.fleet``).

- **Routing is signature-affine.** A join or ``explain`` spec hashes
  through ``planning.tuner.workload_signature`` over ``meta`` tables of
  the spec's shapes (no data, no device): the digest a replica computes
  over its real tables, so a repeat lands where its program is cached.
  The port's signatures differ from the JAX package's by design
  (``service/programs.py``), so these keys differ from JAX's; the
  table-op keys (``sha256("table:<name>")``), the query keys (the plan
  digest, equal to JAX's) and the JSON fallback are JAX's bit for bit.
  A shared ``persist_dir`` is the program distribution tier: a
  replacement replica binds a sibling's programs from their entries
  with no new trace (``JoinProgramCache``'s disk tier).
- **Zero traces is not warmth here.** In the JAX package a zero-trace
  replacement skips an XLA compile. A port program is a bound closure,
  so on a port replica ``new_traces == 0`` after a start (the smoke's
  ``replacement_new_traces``, the autoscaler's ``warm_verified``, the
  HA smoke's ``rebuilt_replay_new_traces``) says that the shared tier
  handed the replica a checked entry, nothing more: the replica's first
  run of the program still pays CUDA's lazy module loading and its
  allocator's first blocks (``--smoke`` records that first request's
  ms with the tier and from an empty persist dir). A replica is warm
  once it has run the program: the autoscaler's pre-warm replay is
  such a run, before the replica rotates in.
- **Lifecycle, failover, admission, tenants and the autoscaler**: the
  reference's state machine (healthy, suspect, drained, failed),
  bounded failover through ``parallel.faults.retry_with_backoff`` with
  the duplicate-id fence, the inflight and probed p95/QPS shed, the
  per-tenant token buckets and priority shed, and the pre-warm gated
  autoscaler.
- **Replicated resident state** (``table_replication`` K > 1): durable
  table manifests and a fence-counted router directory in the coord
  dir, the K-holder fan-out with generation fencing
  (``min_generation`` -> ``StaleGenerationError`` -> failover), and the
  manifest replay that rebuilds a replacement holder.
- **Router HA**: the fenced lease file elects one primary; a standby
  adopts the directory and re-binds the advertised endpoint.

**Replicas on the card.** A JAX replica is a mesh of ``replica_ranks``
devices. A port replica is a daemon
(``python -m distributed_join_tpu_torch.service.server``) with
``--communicator local`` at one rank or ``--communicator emulated
--n-ranks k`` for k ranks on one device; the workload signature binds
``n_ranks``, so ``replica_ranks`` keeps its meaning. The process
factory passes ``--device``: replica i of a fleet on the GPU runs on
``cuda:{i mod device_count}`` (every replica shares the one card of a
one-card machine; on four cards each has its own), and a replica runs
on the CPU only when asked for (``--device cpu``); one that fails to
start is a failed spawn, never a CPU fallback. The in-process factory
builds ``JoinService`` s over per-slot communicators on the caller's
device, each slot with its own persist subdirectory. On a card the
replicas' joins launch B1 (``csrc/join_scans.cu``), both B2 sites
(``csrc/stream_compact.cu``) and B3 (``csrc/expand_gather.cu``); the
router adds no kernel.

The smokes grade against the numpy oracle (``utils.tpch_host``) over
the port's own generator draws (on the replicas' device: a card draws
other bits than the CPU), and ``--smoke`` and ``--ha-smoke`` gate their
counter signatures against ``results/baselines_torch/fleet_smoke.json``
and ``fleet_ha_smoke.json`` (a baseline gates only a run at its own
rank count and device type). ``--platform`` refuses, as the daemon's
does: the fleet takes the daemon's ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.service.programs import (
    atomic_write_json,
    spec_digest,
)
from distributed_join_tpu_torch.service.server import (
    AdmissionError,
    ServiceClient,
    _join_opts_from_spec,
)
from distributed_join_tpu_torch.telemetry import history as tel_history
from distributed_join_tpu_torch.telemetry import live as tel_live
from distributed_join_tpu_torch.telemetry import tracectx


class FleetError(RuntimeError):
    """A fleet-level structured failure (failover budget exhausted,
    duplicate in-flight request id) — answered on the wire, never an
    unstructured crash of the router."""


class NoHolderError(FleetError):
    """A table op or probe-only join found NO live holder for its
    table (replication on): answered as a structured refusal — never
    silently misrouted to a replica that would invent an 'unknown
    table' answer for state the fleet actually owns."""


class QuotaExceededError(FleetError):
    """A tenant crossed one of ITS OWN admission bounds (the
    ``tenants`` config map: QPS token bucket, per-tenant inflight
    cap, or per-tenant ``shed_p95_s``): answered as a structured
    ``shed`` refusal NAMING the bound — the over-quota tenant is shed
    while within-quota tenants keep being served
    (docs/FLEET.md "Multi-tenancy & autoscaling")."""


class ShedError(FleetError):
    """Priority-weighted overload shed: under fleet-wide pressure a
    LOW-PRIORITY tenant's per-replica inflight headroom (its
    priority's share of ``max_inflight_per_replica``) ran out while
    higher-priority traffic still fits — the low-priority request is
    shed FIRST, with a structured refusal naming the priority bound,
    so the quiet high-priority tenant is never the one refused."""


# Durable-state artifact versions (docs/FAILURE_SEMANTICS.md,
# "Replication & durability contract"). `analyze check` validates
# both kinds.
TABLE_MANIFEST_SCHEMA_VERSION = 1
ROUTER_DIRECTORY_SCHEMA_VERSION = 1
ROUTER_DIRECTORY_FILENAME = "router_directory.json"
ROUTER_LEASE_FILENAME = "router_lease.json"
MANIFEST_SUFFIX = ".manifest.json"


@dataclasses.dataclass
class FleetConfig:
    """Router policy knobs (docs/FLEET.md).

    ``replica_ranks`` is each replica's rank count (the affinity hash
    binds it — the workload signature covers ``n_ranks``);
    ``persist_dir`` is the SHARED program distribution tier
    (a replacement replica cold-loads its predecessor's programs with
    no new trace). ``probe_interval_s`` paces the health prober;
    ``suspect_strikes`` is how many consecutive probe/request
    failures turn suspicion into a drain. ``retry_budget`` bounds
    failover attempts per request (total attempts = budget + 1) and
    ``request_deadline_s`` bounds the whole request across attempts.
    ``max_inflight_per_replica`` plus the optional ``shed_p95_s`` /
    ``shed_qps`` bounds (read from the replicas' probed LiveMetrics
    snapshots) drive admission — beyond them the router sheds with a
    structured ``AdmissionError``.

    ``table_replication`` (K) is the resident-table holder count:
    K=1 (default) is the exact pre-replication behavior — table ops
    route by affinity hash alone, no manifests, no directory. K>1
    turns on durable manifests, holder fan-out, and generation
    fencing. ``coord_dir`` holds the manifests + the router
    directory + the HA lease (defaults to ``persist_dir``);
    ``lease_ttl_s``/``lease_renew_s`` pace the HA lease,
    ``router_id`` names this router in the lease/directory files.
    """

    n_replicas: int = 2
    replica_ranks: int = 2
    persist_dir: Optional[str] = None
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 5.0
    spawn_timeout_s: float = 180.0
    drain_settle_s: float = 10.0
    suspect_strikes: int = 2
    retry_budget: int = 2
    retry_backoff_s: float = 0.1
    request_deadline_s: float = 300.0
    max_inflight_per_replica: int = 4
    shed_p95_s: Optional[float] = None
    shed_qps: Optional[float] = None
    respawn: bool = True
    history_dir: Optional[str] = None
    flight_records: int = 256
    flight_recorder_path: Optional[str] = None
    table_replication: int = 1
    coord_dir: Optional[str] = None
    lease_ttl_s: float = 3.0
    lease_renew_s: float = 0.5
    router_id: Optional[str] = None
    # Multi-tenant admission (docs/FLEET.md "Multi-tenancy &
    # autoscaling"): ``tenants`` maps a tenant name to its bounds —
    # ``{"qps": float, "burst_s": float, "max_inflight": int,
    # "priority": int, "shed_p95_s": float}`` (every key optional).
    # Unconfigured tenants (including the implicit default tenant of
    # unstamped requests) keep the exact pre-tenant behavior: no
    # quota, full priority. A configured ``shed_p95_s`` is the
    # per-tenant replacement for the global knob above: the tenant is
    # shed when even the BEST live replica's probed p95 exceeds it.
    tenants: Optional[dict] = None
    # Signature-level autoscaler: a router-side control loop over the
    # probed per-replica LiveMetrics. Sustained (``autoscale_sustain``
    # consecutive ticks, ``autoscale_interval_s`` apart) fleet QPS
    # over ``autoscale_up_qps`` or worst probed p95 over
    # ``autoscale_up_p95_s`` spawns ONE replica (up to
    # ``autoscale_max_replicas``), pre-warm verified against the
    # hottest retained join spec (zero new traces via the shared
    # persist dir) BEFORE entering rotation; fleet QPS at or below
    # ``autoscale_down_qps`` sustained for ``autoscale_idle_s``
    # drains the highest-index scaled-up idle replica (never below
    # the configured base ``n_replicas``).
    autoscale: bool = False
    autoscale_max_replicas: int = 4
    autoscale_up_qps: Optional[float] = None
    autoscale_up_p95_s: Optional[float] = None
    autoscale_down_qps: float = 0.0
    autoscale_idle_s: float = 30.0
    autoscale_interval_s: float = 1.0
    autoscale_sustain: int = 3


# -- durable state: table manifests, router directory, HA lease --------


def _table_slug(name: str) -> str:
    """Filesystem-safe manifest stem for a table name (verbatim when
    it is already safe, content-hashed otherwise — two distinct names
    can never collide on disk)."""
    if name and all(c.isalnum() or c in "._-" for c in name):
        return name
    return hashlib.sha256(name.encode()).hexdigest()[:24]


def table_manifest_path(coord_dir: str, name: str) -> str:
    return os.path.join(coord_dir, "tables",
                        _table_slug(name) + MANIFEST_SUFFIX)


def table_manifest_doc(name: str, register_spec: dict, key: str,
                       generation: int, deltas: list,
                       prep: dict) -> dict:
    """The versioned table manifest (kind ``table_manifest``): enough
    to rebuild a holder's image byte-for-byte — the register spec,
    every append delta spec IN ORDER, the generation they sum to, and
    a payload digest over both (through the same canonicalizer the
    program-cache signatures use, so a rebuilt holder can prove it
    replayed the rows the original held)."""
    return {
        "kind": "table_manifest",
        "schema_version": TABLE_MANIFEST_SCHEMA_VERSION,
        "name": name,
        "key": key,
        "generation": int(generation),
        "register": register_spec,
        "deltas": list(deltas),
        "payload_digest": spec_digest(
            {"register": register_spec, "deltas": list(deltas)}),
        "prep": prep,
        "updated_unix_s": time.time(),
    }


def load_table_manifest(coord_dir: str, name: str) -> Optional[dict]:
    try:
        with open(table_manifest_path(coord_dir, name)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def router_directory_path(coord_dir: str) -> str:
    return os.path.join(coord_dir, ROUTER_DIRECTORY_FILENAME)


def load_router_directory(coord_dir: str) -> Optional[dict]:
    try:
        with open(router_directory_path(coord_dir)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


class RouterLease:
    """The fenced lease file behind router HA: ONE
    serving router at a time, no consensus — a shared filesystem
    plays coordinator. The file carries ``{owner, epoch,
    renewed_unix_s, addr}``. Acquisition is EPOCH-FENCED: a taker
    writes ``epoch + 1``, settles, and re-reads — if another
    contender's write landed last, the taker lost and stands down.
    Renewal re-reads before every write: an owner that finds a higher
    epoch (someone took over while it stalled) is FENCED OUT and must
    stop serving rather than split-brain the directory."""

    def __init__(self, path: str, owner: str, ttl_s: float = 3.0,
                 settle_s: float = 0.2):
        self.path = path
        self.owner = owner
        self.ttl_s = ttl_s
        self.settle_s = settle_s
        self.epoch = 0

    def read(self) -> Optional[dict]:
        try:
            with open(self.path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _write(self, epoch: int, addr=None) -> None:
        atomic_write_json(self.path, {
            "kind": "router_lease",
            "owner": self.owner,
            "epoch": int(epoch),
            "ttl_s": self.ttl_s,
            "renewed_unix_s": time.time(),
            "addr": addr,
        })

    def stale(self, doc: Optional[dict] = None) -> bool:
        doc = doc if doc is not None else self.read()
        if doc is None:
            return True
        age = time.time() - float(doc.get("renewed_unix_s") or 0.0)
        return age > self.ttl_s

    def acquire(self, addr=None) -> bool:
        doc = self.read()
        if doc is not None and not self.stale(doc) \
                and doc.get("owner") != self.owner:
            return False
        epoch = int((doc or {}).get("epoch") or 0) + 1
        self._write(epoch, addr=addr)
        time.sleep(self.settle_s)
        doc = self.read()
        if doc is None or doc.get("owner") != self.owner \
                or int(doc.get("epoch") or -1) != epoch:
            return False
        self.epoch = epoch
        return True

    def renew(self) -> bool:
        doc = self.read()
        if doc is None or doc.get("owner") != self.owner \
                or int(doc.get("epoch") or -1) != self.epoch:
            return False
        self._write(self.epoch, addr=doc.get("addr"))
        return True

    def release(self) -> None:
        """Hand off immediately: stamp the lease stale so a standby
        takes over without waiting out the TTL."""
        doc = self.read()
        if doc is not None and doc.get("owner") == self.owner \
                and int(doc.get("epoch") or -1) == self.epoch:
            atomic_write_json(self.path,
                              {**doc, "renewed_unix_s": 0.0})


# -- replica backends --------------------------------------------------


class ProcessReplica:
    """One join daemon subprocess (the production backend: one a card,
    or CPU daemons in tests). The constructor blocks until the daemon's
    ``listening`` line names its port. ``env`` is the child's
    environment (default: this process's)."""

    def __init__(self, argv: list, spawn_timeout_s: float = 180.0,
                 env: Optional[dict] = None):
        self.argv = list(argv)
        self.proc = subprocess.Popen(
            self.argv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
        # One reader thread owns stdout for the process's lifetime:
        # it resolves the 'listening' line AND keeps the pipe from
        # filling afterwards (a bare readline-with-timeout would race
        # Python's stream buffering).
        self._listening = threading.Event()
        self._addr: Optional[tuple] = None
        self._reader = threading.Thread(target=self._read_stdout,
                                        daemon=True)
        self._reader.start()
        if not self._listening.wait(spawn_timeout_s) \
                or self._addr is None:
            rc = self.proc.poll()
            self.proc.kill()
            self.proc.wait(timeout=30.0)
            raise FleetError(
                f"replica did not report a listening port within "
                f"{spawn_timeout_s}s (rc={rc}): "
                f"{' '.join(self.argv)}")
        self.host, self.port = self._addr

    def _read_stdout(self):
        try:
            for line in self.proc.stdout:
                if self._addr is None and "listening on " in line:
                    addr = line.rsplit("listening on ",
                                       1)[1].strip()
                    host, port = addr.rsplit(":", 1)
                    self._addr = (host, int(port))
                    self._listening.set()
        except (OSError, ValueError):  # pragma: no cover - teardown
            pass
        finally:
            # EOF before the listening line = the replica died at
            # spawn; release the constructor immediately.
            self._listening.set()

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """Hard stop (SIGKILL) — the chaos harness's scripted death."""
        if self.alive():
            self.proc.kill()
        self.proc.wait(timeout=30.0)

    def stop(self, timeout_s: float = 10.0) -> None:
        """Reap after a graceful drain attempt: SIGTERM (the daemon's
        handler drains and exits 0), bounded wait, then SIGKILL."""
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30.0)


class InProcessReplica:
    """One in-process :class:`~.server.JoinService` behind a real TCP
    daemon: the fleet's test backend (per-slot communicators in one
    process, spawn and kill in milliseconds, no subprocess bootstrap).
    ``kill`` closes the listening socket (connection-refused to the
    router, what a dead process looks like on the wire)."""

    def __init__(self, service):
        from distributed_join_tpu_torch.service.server import start_daemon

        self.service = service
        self.server, self.port = start_daemon(service)
        self.host = "127.0.0.1"
        self._dead = False

    def alive(self) -> bool:
        return not self._dead

    def kill(self) -> None:
        self._dead = True
        self.server.shutdown()
        self.server.server_close()

    def stop(self, timeout_s: float = 10.0) -> None:  # noqa: ARG002
        if not self._dead:
            self.kill()


class AttachedReplica:
    """A replica endpoint ADOPTED from the router directory at
    standby takeover: the daemon process belongs to the dead router's
    spawn tree, so this incarnation has no process handle — liveness
    is judged on the wire (health probes + request strikes), and
    ``stop`` deliberately leaves the process running (a router
    takeover must not reap the serving fleet)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = int(port)
        self._dead = False

    def alive(self) -> bool:
        return not self._dead

    def kill(self) -> None:
        # No process handle: mark it dead so the state machine treats
        # the slot as gone (the wire is already refusing).
        self._dead = True

    def stop(self, timeout_s: float = 10.0) -> None:  # noqa: ARG002
        pass


def in_process_fleet_factory(n_replicas: int, ranks_per_replica: int,
                             service_config=None,
                             comm_wrap: Optional[Callable] = None,
                             persist_dir: Optional[str] = None,
                             device=None):
    """A replica factory of in-process services: replica ``i`` is a
    :class:`~.server.JoinService` over a communicator of its own
    (``LocalCommunicator`` at one rank, ``EmulatedCommunicator(k)``
    above) on ``device`` (the caller's; the GPU by default, ``"cpu"``
    in the tests). ``comm_wrap`` (index, generation, comm) -> comm lets
    tests arm one replica with a
    :class:`~..parallel.faults.FaultInjectingCommunicator`.

    ``persist_dir`` arms per-slot persist subdirectories (``r0/``,
    ``r1/``, ...), as the JAX factory does (its blobs bind their device
    assignment): a replacement respawned on a slot binds its
    predecessor's programs from the slot's entries. Sharing one
    directory across replicas is the process factory's (the subprocess
    smoke)."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.service.server import (
        JoinService,
        ServiceConfig,
    )

    if n_replicas < 1 or ranks_per_replica < 1:
        raise ValueError(
            f"{n_replicas} replicas x {ranks_per_replica} ranks: both "
            "must be >= 1")

    def factory(index: int, generation: int) -> InProcessReplica:
        comm = (LocalCommunicator() if ranks_per_replica == 1
                else EmulatedCommunicator(ranks_per_replica))
        if comm_wrap is not None:
            comm = comm_wrap(index, generation, comm)
        cfg = service_config or ServiceConfig()
        if persist_dir is not None:
            cfg = dataclasses.replace(
                cfg, persist_dir=os.path.join(persist_dir,
                                              f"r{index}"))
        return InProcessReplica(JoinService(comm, cfg, device=device))

    return factory


def replica_device(device, index: int) -> str:
    """The ``--device`` of replica ``index``: the GPU (``None`` or
    ``"cuda"``) places it on ``cuda:{index mod device_count}``; any
    other device (``"cpu"``, an explicit ``"cuda:1"``) is passed as it
    is."""
    if device in (None, "cuda"):
        import torch

        count = torch.cuda.device_count()
        if count < 1:
            raise FleetError(
                "a fleet on the GPU needs a CUDA device; pass --device "
                "cpu to run the replicas on the CPU explicitly")
        return f"cuda:{index % count}"
    return str(device)


def _replica_env() -> dict:
    """The children's environment: this one, with the package's root
    first on ``PYTHONPATH`` (the replicas import it by module name)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def process_fleet_factory(config: FleetConfig,
                          device=None,
                          extra_args: Optional[list] = None,
                          replica_overrides: Optional[dict] = None):
    """The default replica factory: one daemon subprocess
    (``python -m distributed_join_tpu_torch.service.server``) a replica,
    sharing ``config.persist_dir``: ``--communicator local`` at
    ``replica_ranks`` 1, ``--communicator emulated --n-ranks k`` above,
    and ``--device`` by :func:`replica_device`.

    ``replica_overrides`` maps a replica index to a dict applied ONLY on
    generation 0 (a scripted outage; every replacement respawns clean):
    ``"fault_plan"`` (a FaultPlan JSON record, forwarded as
    ``--fault-plan``), ``"extra_args"`` (extra argv tokens, e.g. a hang
    scenario's ``--guard-deadline-s``), and ``"persist": False`` (keep
    the victim out of the shared persist dir: a corruption-armed replica
    must build its programs, and a corrupted program must never enter
    the fleet's distribution tier)."""
    env = _replica_env()

    def factory(index: int, generation: int) -> ProcessReplica:
        override = ((replica_overrides or {}).get(index) or {}
                    if generation == 0 else {})
        argv = [
            sys.executable, "-m",
            "distributed_join_tpu_torch.service.server",
            "--host", "127.0.0.1", "--port", "0",
        ]
        if config.replica_ranks == 1:
            argv += ["--communicator", "local"]
        else:
            argv += ["--communicator", "emulated",
                     "--n-ranks", str(config.replica_ranks)]
        argv += ["--device", replica_device(device, index)]
        if config.persist_dir and override.get("persist", True):
            argv += ["--persist-dir", config.persist_dir]
        plan = override.get("fault_plan")
        if plan is not None:
            argv += ["--fault-plan", json.dumps(plan)]
        argv += list(extra_args or [])
        argv += list(override.get("extra_args") or [])
        return ProcessReplica(argv,
                              spawn_timeout_s=config.spawn_timeout_s,
                              env=env)

    return factory


# -- the router --------------------------------------------------------


@dataclasses.dataclass
class _Replica:
    """Router-side replica bookkeeping (the state machine's subject).
    ``state``: starting -> healthy -> suspect -> drained (-> healthy
    again after replacement; ``failed`` when a respawn itself died)."""

    index: int
    backend: object
    generation: int = 0
    state: str = "healthy"
    strikes: int = 0
    inflight: int = 0
    last_stats: Optional[dict] = None
    drained_reason: Optional[str] = None
    drained_at: Optional[float] = None
    replaced_at: Optional[float] = None

    def addr(self):
        return self.backend.host, self.backend.port


class _AffinityStub:
    """The n_ranks/n_slices view :func:`workload_signature` needs —
    the router hashes signatures without a communicator or devices."""

    def __init__(self, n_ranks: int, n_slices: int = 1):
        self.n_ranks = n_ranks
        self.n_slices = n_slices


def affinity_key(req: dict, replica_ranks: int) -> str:
    """THE canonical routing digest of one wire request (module-level
    so harnesses can predict routing before a fleet exists). Join and
    explain specs hash through the workload-signature function the
    program cache and tuner key on (abstract tables from the spec's
    shapes — no data, no devices); table-management ops hash the
    table name so one handle's traffic co-locates; anything else
    hashes its canonical JSON."""
    op = req.get("op")
    table = req.get("table") or (
        req.get("name") if op in ("register", "append", "drop")
        else None)
    if table is not None:
        return hashlib.sha256(
            f"table:{table}".encode()).hexdigest()[:16]
    if op == "query":
        # Multi-operator plans route by the PLAN DIGEST — the same
        # key the replicas' program caches hold the built
        # whole-plan program under, so a repeated query lands warm
        # on the same replica (docs/QUERY.md).
        try:
            from distributed_join_tpu_torch.planning.query import (
                tpch_query_plan,
            )

            digest = tpch_query_plan(
                str(req.get("query", "q3"))).digest()
            return hashlib.sha256(
                f"queryplan:{digest}".encode()).hexdigest()[:16]
        except Exception as exc:  # noqa: BLE001 - fall to JSON hash
            telemetry.event(
                "fleet_affinity_fallback", op=op,
                error=f"{type(exc).__name__}: {exc}")
    if op in ("join", "explain") and req.get("build_nrows"):
        try:
            from distributed_join_tpu_torch.planning.plan import (
                abstract_tables,
            )
            from distributed_join_tpu_torch.planning.tuner import (
                workload_signature,
            )

            build, probe = abstract_tables(
                int(req["build_nrows"]), int(req["probe_nrows"]))
            stub = _AffinityStub(replica_ranks)
            return workload_signature(
                stub, build, probe, with_metrics=False,
                **_join_opts_from_spec(req))
        except Exception as exc:  # noqa: BLE001 - fall to JSON hash
            # Loud: routing by the JSON fallback still works, but it
            # no longer matches the replicas' program-cache digests —
            # warm repeats would scatter. A silent fallback here made
            # that near-undiagnosable.
            telemetry.event(
                "fleet_affinity_fallback", op=op,
                error=f"{type(exc).__name__}: {exc}")
    basis = json.dumps(
        {k: repr(v) for k, v in req.items()
         if k not in ("request_id",)}, sort_keys=True)
    return hashlib.sha256(basis.encode()).hexdigest()[:16]


def affine_replica(req: dict, replica_ranks: int,
                   n_replicas: int) -> int:
    """The ring-walk START slot for ``req`` — the replica a healthy
    fleet serves it from (the chaos harness arms its victim here)."""
    key = affinity_key(req, replica_ranks)
    return int(key[:8], 16) % max(n_replicas, 1)


# Per-tenant admission state is bounded: unconfigured tenant names
# seen on the wire get counters up to this cap (configured tenants
# are never evicted — their quota buckets must not reset under churn).
MAX_TENANT_STATES = 64
# Retained warm join specs (newest = hottest) for the autoscaler's
# pre-warm rotation gate.
WARM_SPECS_MAX = 32
AUTOSCALE_EVENTS_MAX = 256
AUTOSCALE_SCHEMA_VERSION = 1


class _TenantState:
    """Router-side per-tenant admission state: a QPS token bucket,
    an inflight counter, and shed/served tallies. Mutated only under
    the router lock."""

    __slots__ = ("name", "quota", "priority", "tokens",
                 "last_refill_monotonic", "inflight", "served",
                 "quota_sheds", "priority_sheds")

    def __init__(self, name: str, quota: Optional[dict]):
        self.name = name
        self.quota = dict(quota) if quota else {}
        self.priority = int(self.quota.get("priority", 1) or 1)
        qps = self.quota.get("qps")
        burst = float(self.quota.get("burst_s", 1.0) or 1.0)
        # The bucket starts FULL (one burst window's worth, never
        # below one token) so a tenant's first requests are not shed
        # by an empty bucket it never filled.
        self.tokens = max(float(qps) * burst, 1.0) if qps else 0.0
        self.last_refill_monotonic = time.monotonic()
        self.inflight = 0
        self.served = 0
        self.quota_sheds = 0
        self.priority_sheds = 0

    def take_token(self, now: float) -> bool:
        """Refill-then-take; False = over the QPS quota. Only called
        when the quota configures ``qps``. Caller holds the lock."""
        qps = float(self.quota["qps"])
        cap = max(qps * float(self.quota.get("burst_s", 1.0) or 1.0),
                  1.0)
        # now is sampled before the router lock — on the admission
        # that CREATES this state it can precede the constructor's
        # refill stamp, and a negative delta must not drain the
        # fresh bucket below its first token.
        self.tokens = min(
            cap,
            self.tokens
            + max(now - self.last_refill_monotonic, 0.0) * qps)
        self.last_refill_monotonic = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class FleetRouter:
    """The thin line-JSON TCP router fronting N replicas. Owns the
    replica set (spawn, probe, drain, replace), the affinity routing,
    the bounded failover loop, admission/shedding (global AND
    per-tenant), the signature-level autoscaler, and the fleet-level
    observability surfaces."""

    def __init__(self, replica_factory: Callable,
                 config: Optional[FleetConfig] = None):
        self.config = config or FleetConfig()
        self.factory = replica_factory
        self._lock = threading.Lock()
        self.replicas: list = []
        self.live = tel_live.LiveMetrics()
        self.recorder = tel_live.FlightRecorder(
            self.config.flight_records)
        self.history = (tel_history.WorkloadHistory(os.path.join(
            self.config.history_dir, tel_history.HISTORY_FILENAME))
            if self.config.history_dir else None)
        self.failovers_total = 0
        self.shed_total = 0
        self.replaced_total = 0
        self.drains_total = 0
        self.rebuilds_total = 0
        self.takeovers_total = 0
        self.served = 0
        self.failed = 0
        self.rejected = 0
        # Multi-tenant admission (config.tenants): per-tenant token
        # buckets / inflight counters / shed tallies, created lazily
        # per observed tenant name (bounded; configured tenants are
        # never evicted).
        self._tenant_states: OrderedDict = OrderedDict()
        # Signature-level autoscaler (config.autoscale): decision
        # counters, the bounded event log behind the fleet_autoscale
        # artifact, and the retained hot join specs its pre-warm
        # rotation gate replays.
        self.autoscale_spawns_total = 0
        self.autoscale_drains_total = 0
        self._autoscale_events: list = []
        self._autoscaler: Optional[threading.Thread] = None
        self._warm_specs: OrderedDict = OrderedDict()
        # Replicated-state tier (table_replication > 1): the in-memory
        # table directory (name -> generation/key/holder set) the
        # durable router_directory.json mirrors; `role` is the HA
        # role ("single" outside RouterHA pairing).
        self.role = "single"
        self._tables: dict = {}
        self._lease: Optional[RouterLease] = None
        self._directory_fence = 0
        self._request_seq = 0
        self._id_stamp = os.urandom(3).hex()
        self._inflight_ids: set = set()
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._replace_threads: list = []
        # Set by the wire `shutdown` op; the serving loop (main) and
        # embedding harnesses watch it to tear the fleet down.
        self.shutdown_requested = threading.Event()

    @property
    def _coord_dir(self) -> Optional[str]:
        return self.config.coord_dir or self.config.persist_dir

    @property
    def _replicated(self) -> bool:
        return self.config.table_replication > 1

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        """Spawn the replica set and start the health prober. The
        replicas start together (a daemon on a card takes seconds to
        import torch and reach it); a spawn that fails raises, as in the
        reference, after the others are reaped."""
        backends: list = [None] * self.config.n_replicas
        errors: list = []

        def spawn(i):
            try:
                backends[i] = self.factory(i, 0)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=spawn, args=(i,), daemon=True,
                                    name=f"fleet-spawn-{i}")
                   for i in range(self.config.n_replicas)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for b in backends:
                if b is not None:
                    b.stop()
            raise errors[0]
        for i, backend in enumerate(backends):
            self.replicas.append(_Replica(index=i, backend=backend))
        telemetry.event("fleet_started",
                        replicas=len(self.replicas))
        self._prober = threading.Thread(target=self._probe_loop,
                                        daemon=True,
                                        name="fleet-prober")
        self._prober.start()
        if self.config.autoscale:
            self._autoscaler = threading.Thread(
                target=self._autoscale_loop, daemon=True,
                name="fleet-autoscaler")
            self._autoscaler.start()

    def stop(self, drain: bool = True) -> None:
        """Stop probing, settle any in-flight replacement, and reap
        every replica (graceful drain op first when ``drain``)."""
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=self.config.probe_interval_s
                              + self.config.probe_timeout_s + 5.0)
        if self._autoscaler is not None:
            # A tick mid-spawn holds the thread up to the spawn
            # timeout; its own _stop checks keep a late backend from
            # leaking past this reap loop.
            self._autoscaler.join(
                timeout=self.config.autoscale_interval_s + 5.0)
        # A _replace thread may be mid-spawn: join it (bounded) so
        # the freshly spawned backend lands in self.replicas and is
        # reaped below instead of leaking past shutdown.
        for t in self._replace_threads:
            t.join(timeout=self.config.spawn_timeout_s
                   + self.config.drain_settle_s + 10.0)
        for rep in self.replicas:
            if drain and rep.backend.alive():
                self._send_drain(rep)
            rep.backend.stop()
        if self.history is not None:
            self.history.close()
        if self.config.flight_recorder_path:
            self.dump_flight_recorder("fleet stopped")

    # -- affinity -----------------------------------------------------

    def affinity_key(self, req: dict) -> str:
        """The canonical routing digest of one wire request — see the
        module-level :func:`affinity_key`."""
        return affinity_key(req, self.config.replica_ranks)

    def _admittable(self, rep: _Replica,
                    inflight_bound: Optional[int] = None) -> bool:
        """Admission policy: state + inflight bound + the optional
        p95/QPS bounds read from the replica's probed LiveMetrics
        snapshot (stale by at most one probe interval — shedding is a
        pressure valve, not an exact gate). ``inflight_bound`` is a
        TIGHTER per-tenant priority cap (never looser than the fleet
        bound) — how low-priority tenants shed first under
        pressure."""
        if rep.state not in ("healthy", "suspect"):
            return False
        bound = self.config.max_inflight_per_replica
        if inflight_bound is not None:
            bound = min(bound, inflight_bound)
        if rep.inflight >= bound:
            return False
        st = rep.last_stats or {}
        if self.config.shed_p95_s is not None:
            p95 = (st.get("latency") or {}).get("p95_s")
            if p95 is not None and p95 > self.config.shed_p95_s:
                return False
        if self.config.shed_qps is not None:
            qps = st.get("qps_60s")
            if qps is not None and qps > self.config.shed_qps:
                return False
        return True

    # -- the health prober + state machine ----------------------------

    def _probe_loop(self):
        while not self._stop.wait(self.config.probe_interval_s):
            for rep in list(self.replicas):
                if self._stop.is_set():
                    return
                # drained = replacement in progress; failed = respawn
                # itself died and the fleet serves on with n-1 — the
                # prober leaves both alone (re-striking a failed slot
                # would churn doomed respawns forever).
                if rep.state in ("drained", "failed"):
                    continue
                self._probe_one(rep)

    def _probe_one(self, rep: _Replica):
        try:
            client = ServiceClient(
                *rep.addr(), timeout_s=self.config.probe_timeout_s)
            try:
                # Probes root their own (tiny) trace so a probe-
                # triggered drain is causally linkable to the probe.
                st = client.send(tracectx.attach(
                    {"op": "stats"}, tracectx.mint()))
            finally:
                client.close()
        except (OSError, ValueError) as exc:
            self._strike(rep, f"probe: {type(exc).__name__}: {exc}")
            return
        rep.last_stats = st
        if st.get("poisoned"):
            self._drain(rep, f"probe saw poisoned: {st['poisoned']}")
        elif st.get("draining"):
            # Someone (an operator, SIGTERM) is draining it out from
            # under the fleet: stop routing to it and replace.
            self._drain(rep, "probe saw draining")
        else:
            with self._lock:
                rep.strikes = 0
                if rep.state == "suspect":
                    rep.state = "healthy"
                    telemetry.event("fleet_replica_recovered",
                                    replica=rep.index)

    def _strike(self, rep: _Replica, reason: str):
        """One probe/request failure: healthy -> suspect; strikes
        beyond the bound (or a dead process) -> drained."""
        with self._lock:
            rep.strikes += 1
            strikes = rep.strikes
            if rep.state == "healthy":
                rep.state = "suspect"
                telemetry.event("fleet_replica_suspect",
                                replica=rep.index, reason=reason)
        if strikes >= self.config.suspect_strikes \
                or not rep.backend.alive():
            self._drain(rep, reason)

    def _drain(self, rep: _Replica, reason: str):
        """drained + replacement kick-off; idempotent per incident
        (a failed slot is terminal until an operator intervenes)."""
        with self._lock:
            if rep.state in ("drained", "failed"):
                return
            rep.state = "drained"
            rep.drained_reason = reason
            rep.drained_at = time.monotonic()
            self.drains_total += 1
        telemetry.event("fleet_replica_drained", replica=rep.index,
                        reason=reason)
        self.recorder.record(
            request_id=f"fleet-replica-{rep.index}",
            op="drain_replica", signature=None, outcome="drained",
            reason=reason,
            replica={"index": rep.index,
                     "generation": rep.generation})
        if self.config.respawn and not self._stop.is_set():
            t = threading.Thread(target=self._replace, args=(rep,),
                                 daemon=True,
                                 name=f"fleet-replace-{rep.index}")
            with self._lock:
                self._replace_threads = [x for x in
                                         self._replace_threads
                                         if x.is_alive()] + [t]
            t.start()

    def _send_drain(self, rep: _Replica):
        """Best-effort graceful drain wire op (in-flight completes or
        deadlines out replica-side before the reap)."""
        try:
            client = ServiceClient(
                *rep.addr(), timeout_s=self.config.drain_settle_s
                + self.config.probe_timeout_s)
            try:
                client.send({"op": "drain",
                             "reason": "fleet drain",
                             "settle_timeout_s":
                                 self.config.drain_settle_s})
            finally:
                client.close()
        except (OSError, ValueError):
            pass

    def _replace(self, rep: _Replica):
        """Reap the drained replica and respawn its slot (same index,
        same device subset, next generation): its programs bound from
        the shared persist dir (no trace; warm once each has run). A
        replacement failure marks the slot ``failed``
        (the fleet serves on with n-1; the prober leaves it alone)."""
        if rep.backend.alive():
            self._send_drain(rep)
        try:
            rep.backend.stop()
        except Exception as exc:  # noqa: BLE001 - reap boundary
            telemetry.event("fleet_replica_reap_error",
                            replica=rep.index, error=str(exc))
        if self._stop.is_set():
            # Teardown in progress: the old backend is reaped, but a
            # fresh spawn would only leak past stop() — leave the
            # slot drained.
            return
        try:
            backend = self.factory(rep.index, rep.generation + 1)
        except Exception as exc:  # noqa: BLE001 - respawn boundary
            with self._lock:
                rep.state = "failed"
            telemetry.event("fleet_replica_respawn_failed",
                            replica=rep.index,
                            error=f"{type(exc).__name__}: {exc}")
            return
        with self._lock:
            rep.backend = backend
            rep.generation += 1
            rep.state = "healthy"
            rep.strikes = 0
            rep.inflight = 0
            rep.last_stats = None
            rep.replaced_at = time.monotonic()
            self.replaced_total += 1
        telemetry.event("fleet_replica_replaced", replica=rep.index,
                        generation=rep.generation)
        if self._replicated:
            try:
                self._rebuild_holder_tables(rep)
            except Exception as exc:  # noqa: BLE001 - rebuild boundary
                telemetry.event("fleet_rebuild_error",
                                replica=rep.index,
                                error=f"{type(exc).__name__}: {exc}")
            self._save_directory()

    # -- multi-tenant admission (config.tenants) ----------------------

    def _tenant_state_locked(self, name: str) -> _TenantState:
        """Lazily created per-tenant state (caller holds the lock).
        Bounded: when over the cap, evict one UNCONFIGURED tenant's
        counters — configured quota buckets never reset under name
        churn."""
        st = self._tenant_states.get(name)
        if st is None:
            st = _TenantState(name,
                              (self.config.tenants or {}).get(name))
            self._tenant_states[name] = st
            if len(self._tenant_states) > MAX_TENANT_STATES:
                cfg = self.config.tenants or {}
                for k in list(self._tenant_states):
                    if k not in cfg and k != name:
                        del self._tenant_states[k]
                        break
        return st

    def _tenant_admit(self, tenant: Optional[str],
                      op: str) -> Optional[_TenantState]:
        """Per-tenant admission (docs/FLEET.md "Multi-tenancy &
        autoscaling"): the inflight cap, the QPS token bucket, and
        the per-tenant p95 bound, each refusing with a
        QuotaExceededError NAMING the bound it enforces. Returns the
        tenant's state with its inflight slot RESERVED (the dispatch
        finally releases it); None when no tenant accounting applies
        (control-plane op, or an unstamped request with no quota
        configured for the default tenant)."""
        if op in ("ping", "stats", "metrics"):
            return None
        name = (tenant if tenant is not None
                else tel_history.DEFAULT_TENANT)
        if tenant is None \
                and name not in (self.config.tenants or {}):
            return None
        now = time.monotonic()
        with self._lock:
            st = self._tenant_state_locked(name)
            q = st.quota
            if q.get("max_inflight") is not None \
                    and st.inflight >= int(q["max_inflight"]):
                st.quota_sheds += 1
                raise QuotaExceededError(
                    f"tenant {name!r} over its inflight quota "
                    f"(max_inflight={int(q['max_inflight'])}, "
                    f"inflight={st.inflight}); shed — retry with "
                    "backoff")
            if q.get("qps") is not None \
                    and not st.take_token(now):
                st.quota_sheds += 1
                raise QuotaExceededError(
                    f"tenant {name!r} over its QPS quota "
                    f"(qps={float(q['qps'])}/s, "
                    f"burst_s={float(q.get('burst_s', 1.0) or 1.0)})"
                    "; shed — retry with backoff")
            st.inflight += 1
        bound = st.quota.get("shed_p95_s")
        if bound is not None:
            best = self._best_live_p95()
            if best is not None and best > float(bound):
                with self._lock:
                    st.inflight = max(st.inflight - 1, 0)
                    st.quota_sheds += 1
                raise QuotaExceededError(
                    f"tenant {name!r} shed on its p95 bound "
                    f"(shed_p95_s={float(bound)}, best live replica "
                    f"p95={best:.3f}s); retry with backoff")
        return st

    def _best_live_p95(self) -> Optional[float]:
        """The BEST probed p95 across live replicas — the latency the
        fleet could serve a request at right now. A tenant's
        ``shed_p95_s`` sheds only when even this exceeds its bound
        (one slow replica must not shed a tenant the others can
        serve in time)."""
        with self._lock:
            reps = list(self.replicas)
        vals = []
        for rep in reps:
            if rep.state not in ("healthy", "suspect"):
                continue
            p95 = ((rep.last_stats or {}).get("latency")
                   or {}).get("p95_s")
            if p95 is not None:
                vals.append(float(p95))
        return min(vals) if vals else None

    def _priority_fraction(
            self, tstate: Optional[_TenantState]) -> float:
        """A configured tenant's share of the per-replica inflight
        bound: its priority over the MAX configured priority.
        Unconfigured (and default) tenants keep the full bound — the
        exact pre-tenant admission behavior."""
        if tstate is None or not tstate.quota:
            return 1.0
        cfg = self.config.tenants or {}
        max_p = max([int((q or {}).get("priority", 1) or 1)
                     for q in cfg.values()] + [1])
        if max_p <= 0:
            return 1.0
        return min(max(tstate.priority / max_p, 0.0), 1.0)

    # -- signature-level autoscaler (config.autoscale) ----------------

    def _retain_warm_spec(self, key: str, req: dict) -> None:
        """Retain the wire spec of a served generic join keyed by its
        affinity signature (LRU, newest = hottest): the autoscaler's
        pre-warm gate replays the hottest one against a fresh replica
        before it enters rotation."""
        spec = {k: v for k, v in req.items()
                if k not in ("request_id", "tenant",
                             tracectx.TRACE_FIELD)}
        with self._lock:
            self._warm_specs.pop(key, None)
            self._warm_specs[key] = spec
            while len(self._warm_specs) > WARM_SPECS_MAX:
                self._warm_specs.popitem(last=False)

    def _autoscale_loop(self):
        over = 0
        idle_since = None
        while not self._stop.wait(self.config.autoscale_interval_s):
            try:
                over, idle_since = self._autoscale_tick(over,
                                                        idle_since)
            except Exception as exc:  # noqa: BLE001 - control loop
                telemetry.event(
                    "fleet_autoscale_error",
                    error=f"{type(exc).__name__}: {exc}")

    def _autoscale_tick(self, over, idle_since):
        """One control-loop decision over the probed per-replica
        LiveMetrics: sustained fleet QPS / worst-p95 over the up
        bounds spawns a replica; fleet QPS at/below the down bound
        with nothing in flight, sustained for ``autoscale_idle_s``,
        drains one scaled-up replica."""
        cfg = self.config
        with self._lock:
            live = [r for r in self.replicas
                    if r.state in ("healthy", "suspect")]
            n_live = len(live)
            any_inflight = any(r.inflight > 0 for r in live)
            total_qps = 0.0
            worst_p95 = None
            for r in live:
                st = r.last_stats or {}
                q = st.get("qps_60s")
                if q:
                    total_qps += float(q)
                p95 = (st.get("latency") or {}).get("p95_s")
                if p95 is not None and (worst_p95 is None
                                        or float(p95) > worst_p95):
                    worst_p95 = float(p95)
        hot = ((cfg.autoscale_up_qps is not None
                and total_qps > cfg.autoscale_up_qps)
               or (cfg.autoscale_up_p95_s is not None
                   and worst_p95 is not None
                   and worst_p95 > cfg.autoscale_up_p95_s))
        now = time.monotonic()
        if hot:
            over += 1
            idle_since = None
            if over >= max(cfg.autoscale_sustain, 1) \
                    and n_live < cfg.autoscale_max_replicas:
                self._autoscale_spawn(total_qps, worst_p95)
                over = 0
            return over, idle_since
        over = 0
        if total_qps <= cfg.autoscale_down_qps and not any_inflight:
            if idle_since is None:
                idle_since = now
            elif now - idle_since >= cfg.autoscale_idle_s:
                if self._autoscale_drain_one(total_qps):
                    idle_since = now
        else:
            idle_since = None
        return over, idle_since

    def _autoscale_spawn(self, qps, p95):
        """Spawn one scaled-up replica on a fresh index and PRE-WARM
        VERIFY it BEFORE it enters rotation: the hottest retained
        join spec replayed directly (it is not routable yet) must be
        SERVED, and is warm-verified when it cost zero new traces
        (the shared persist dir did its job: the program came from its
        entry). The replay is the replica's first run of the program,
        which is what warms a port replica; ``warm_verified`` adds only
        that no build was needed. A replica that cannot serve the probe
        never rotates in."""
        with self._lock:
            index = max((r.index for r in self.replicas),
                        default=-1) + 1
        reason = (f"sustained load (fleet qps_60s={qps:.2f}, "
                  f"worst p95={p95})")
        try:
            backend = self.factory(index, 0)
        except Exception as exc:  # noqa: BLE001 - spawn boundary
            self._autoscale_event(
                "spawn_failed", index,
                reason=f"{type(exc).__name__}: {exc}",
                qps=qps, p95_s=p95)
            return
        rep = _Replica(index=index, backend=backend)
        warm = self._prewarm(rep)
        if self._stop.is_set() or not warm.get("served"):
            try:
                backend.stop()
            except Exception:  # noqa: BLE001 - reap boundary
                pass
            if not self._stop.is_set():
                self._autoscale_event(
                    "spawn_failed", index,
                    reason="pre-warm probe failed: "
                           f"{warm.get('error')}",
                    qps=qps, p95_s=p95)
            return
        with self._lock:
            self.replicas.append(rep)
            self.autoscale_spawns_total += 1
        self._autoscale_event(
            "spawn", index, reason=reason, qps=qps, p95_s=p95,
            warm_verified=warm.get("verified"),
            new_traces=warm.get("new_traces"),
            signature=warm.get("signature"))

    def _prewarm(self, rep: _Replica) -> dict:
        """The rotation gate probe: replay the hottest retained join
        spec against the fresh replica; fall back to a ping when no
        spec has been retained yet (served, but not warm-verified)."""
        with self._lock:
            sig, spec = (next(reversed(self._warm_specs.items()))
                         if self._warm_specs else (None, None))
        probe = dict(spec) if spec else {"op": "ping"}
        probe["request_id"] = f"autoscale-warm-{rep.index}"
        try:
            client = ServiceClient(
                *rep.addr(), timeout_s=self.config.spawn_timeout_s)
            try:
                resp = client.send(tracectx.attach(
                    probe, tracectx.mint()))
            finally:
                client.close()
        except (OSError, ValueError) as exc:
            return {"served": False,
                    "error": f"{type(exc).__name__}: {exc}"}
        if not resp.get("ok"):
            return {"served": False,
                    "error": str(resp.get("message")
                                 or resp.get("error"))}
        new_traces = int(resp.get("new_traces") or 0)
        return {"served": True,
                "verified": spec is not None and new_traces == 0,
                "new_traces": (new_traces if spec is not None
                               else None),
                "signature": sig}

    def _autoscale_drain_one(self, qps) -> bool:
        """Scale down: drain the HIGHEST-INDEX idle scaled-up
        replica — never below the configured base ``n_replicas`` —
        and reap it with NO respawn (this drain is the point)."""
        with self._lock:
            live = [r for r in self.replicas
                    if r.state in ("healthy", "suspect")]
            candidates = [r for r in live
                          if r.index >= self.config.n_replicas
                          and r.inflight == 0]
            if len(live) <= self.config.n_replicas \
                    or not candidates:
                return False
            rep = max(candidates, key=lambda r: r.index)
            rep.state = "drained"
            rep.drained_reason = "autoscale: idle"
            rep.drained_at = time.monotonic()
            self.drains_total += 1
            self.autoscale_drains_total += 1
        self._send_drain(rep)
        try:
            rep.backend.stop()
        except Exception as exc:  # noqa: BLE001 - reap boundary
            telemetry.event("fleet_replica_reap_error",
                            replica=rep.index, error=str(exc))
        self._autoscale_event("drain", rep.index,
                              reason="idle past autoscale_idle_s",
                              qps=qps)
        return True

    def _autoscale_event(self, action, replica, *, reason,
                         qps=None, p95_s=None, warm_verified=None,
                         new_traces=None, signature=None):
        event = {"action": action, "replica": int(replica),
                 "reason": reason, "unix_s": time.time()}
        if qps is not None:
            event["qps_60s"] = round(float(qps), 4)
        if p95_s is not None:
            event["p95_s"] = round(float(p95_s), 6)
        if warm_verified is not None:
            event["warm_verified"] = bool(warm_verified)
        if new_traces is not None:
            event["new_traces"] = int(new_traces)
        if signature is not None:
            event["signature"] = signature
        with self._lock:
            self._autoscale_events.append(event)
            del self._autoscale_events[:-AUTOSCALE_EVENTS_MAX]
        telemetry.event("fleet_autoscale_" + action,
                        replica=int(replica), reason=reason)
        self.recorder.record(
            request_id=f"fleet-autoscale-{replica}",
            op="autoscale", signature=signature,
            outcome=action, reason=reason)

    def autoscale_record(self) -> dict:
        """The ``fleet_autoscale`` artifact (``analyze check``
        validates it): the autoscaler's decision log plus its
        counters."""
        with self._lock:
            return {
                "kind": "fleet_autoscale",
                "schema_version": AUTOSCALE_SCHEMA_VERSION,
                "enabled": bool(self.config.autoscale),
                "spawns_total": int(self.autoscale_spawns_total),
                "drains_total": int(self.autoscale_drains_total),
                "replicas": len(self.replicas),
                "events": [dict(e)
                           for e in self._autoscale_events],
            }

    # -- dispatch -----------------------------------------------------

    def _mint_request_id(self, request_id) -> str:
        with self._lock:
            self._request_seq += 1
            seq = self._request_seq
        if request_id:
            rid = str(request_id)
            if len(rid) > 64:
                # Cap length WITHOUT aliasing (the JoinService
                # scheme): two long ids sharing a 64-char prefix must
                # stay distinct — the duplicate-dispatch fence keys
                # on rid.
                rid = (rid[:48] + "-"
                       + hashlib.sha256(
                           rid.encode()).hexdigest()[:15])
            return rid
        return f"flt-{self._id_stamp}-{seq:06d}"

    def dispatch(self, req: dict) -> dict:
        """Route one wire request: affinity ring walk, admission,
        bounded failover, duplicate-id fencing, and the observability
        fan-out. Always returns a response dict (structured errors
        included) — the router never crashes a client."""
        from distributed_join_tpu_torch.parallel.faults import (
            retry_with_backoff,
        )

        op = req.get("op", "?")
        # The optional wire tenant (default tenant = absent field —
        # every pre-tenant wire contract preserved byte-for-byte):
        # threaded like request_id through admission, history,
        # flight records, and Prometheus.
        tenant = req.get("tenant")
        if tenant is not None:
            tenant = str(tenant)
        rid = self._mint_request_id(req.get("request_id"))
        key = self.affinity_key(req)
        # The router is the trace ROOT when the client sent no
        # context; a client-minted context makes this dispatch a
        # child hop, so the whole fleet hop chain shares the
        # client's trace_id (docs/OBSERVABILITY.md "Distributed
        # tracing").
        ctx = tracectx.child_of_wire(req) or tracectx.mint()
        t0 = time.perf_counter()
        # The duplicate-dispatch fence: one id, one in-flight dispatch
        # at a time. A resend that arrives while the original is still
        # running PARKS until the original settles (the documented
        # reconnect-and-resend client pattern — its first answer was
        # lost with the torn connection, so the resend must be served,
        # idempotently, not refused), bounded by the request deadline.
        fence_deadline = time.monotonic() \
            + self.config.request_deadline_s
        while True:
            with self._lock:
                if rid not in self._inflight_ids:
                    self._inflight_ids.add(rid)
                    break
            if time.monotonic() >= fence_deadline:
                with self._lock:
                    self.rejected += 1
                self.live.record_request(op, "rejected",
                                         tenant=tenant)
                # Every refusal lands in the postmortem ring — this
                # is the one path that bypasses _observe's fan-out.
                self.recorder.record(
                    request_id=rid, op=op, signature=key,
                    outcome="rejected", reason="duplicate_fence",
                    trace=tracectx.stamp(ctx) or None)
                return {"ok": False, "error": "FleetError",
                        "message": f"request id {rid!r} still in "
                                   "flight past the request deadline "
                                   "(duplicate fenced)",
                        "request_id": rid,
                        tracectx.TRACE_FIELD: tracectx.to_wire(ctx)}
            time.sleep(0.05)
        state = {"attempts": 0, "failovers": 0, "replica": None,
                 "trace": ctx}
        outcome = "failed"
        resp = None
        tstate = None
        scope = telemetry.request_scope(None, trace=tracectx.stamp(ctx)
                                        or None)
        scope.__enter__()
        try:
            # Per-tenant admission FIRST: an over-quota tenant is
            # shed before it can touch a replica slot or the holder
            # fan-out — the quiet tenant's capacity is never burned
            # probing on the noisy tenant's behalf.
            tstate = self._tenant_admit(tenant, op)
            tenant_frac = self._priority_fraction(tstate)
            if self._replicated and op in ("register", "append",
                                           "drop"):
                # Replicated table ops never ride the single-replica
                # path: they fan out to the holder set (register
                # picks it, append/drop route BY it).
                resp = self._table_fanout(req, rid, key, state)
                outcome = "served" if resp.get("ok") else "failed"
                return resp
            allowed = None
            if op == "join" and req.get("table"):
                with self._lock:
                    entry = self._tables.get(str(req["table"]))
                if entry is not None:
                    # Probe-only joins route by HOLDER SET, fenced at
                    # the directory generation: a stale holder must
                    # refuse, not serve rows missing a delta. Only
                    # SERVING holders are routable — a slot mid-
                    # rebuild has no image yet (its replica would
                    # answer ResidentError), and a stale slot would
                    # only burn an attempt on a guaranteed fence
                    # refusal.
                    with self._lock:
                        allowed = {
                            idx for idx, h
                            in entry["holders"].items()
                            if h["state"] == "serving"}
                        states = {idx: h["state"] for idx, h
                                  in entry["holders"].items()}
                    if not allowed:
                        raise NoHolderError(
                            f"no serving holder for table "
                            f"{req['table']!r} (holder states "
                            f"{states}); rebuilds in flight heal "
                            "this — retry with backoff")
                    req = {**req,
                           "min_generation": entry["generation"]}
            resp = self._dispatch_attempts(
                req, rid, key, state, retry_with_backoff,
                allowed=allowed, tenant=tenant,
                tenant_frac=tenant_frac)
            outcome = "served" if resp.get("ok") else "failed"
            if outcome == "served" and op == "join" \
                    and not req.get("table"):
                self._retain_warm_spec(key, req)
            return resp
        except AdmissionError as exc:
            outcome = "rejected"
            with self._lock:
                self.shed_total += 1
                self.rejected += 1
            resp = {"ok": False, "error": "AdmissionError",
                    "message": str(exc), "shed": True,
                    "request_id": rid,
                    "fleet": {"attempts": state["attempts"]}}
            return resp
        except QuotaExceededError as exc:
            outcome = "rejected"
            with self._lock:
                self.shed_total += 1
                self.rejected += 1
            resp = {"ok": False, "error": "QuotaExceededError",
                    "message": str(exc), "shed": True,
                    "tenant": tenant, "request_id": rid,
                    "fleet": {"attempts": state["attempts"]}}
            return resp
        except ShedError as exc:
            outcome = "rejected"
            with self._lock:
                self.shed_total += 1
                self.rejected += 1
                if tstate is not None:
                    tstate.priority_sheds += 1
            resp = {"ok": False, "error": "ShedError",
                    "message": str(exc), "shed": True,
                    "tenant": tenant, "request_id": rid,
                    "fleet": {"attempts": state["attempts"]}}
            return resp
        except NoHolderError as exc:
            resp = {"ok": False, "error": "NoHolderError",
                    "message": str(exc), "request_id": rid,
                    "table": req.get("table") or req.get("name"),
                    "fleet": {"attempts": state["attempts"],
                              "failovers": state["failovers"]}}
            return resp
        except FleetError as exc:
            resp = {"ok": False, "error": "FleetError",
                    "message": str(exc), "request_id": rid,
                    "fleet": {"attempts": state["attempts"],
                              "failovers": state["failovers"]}}
            return resp
        finally:
            with self._lock:
                self._inflight_ids.discard(rid)
                if tstate is not None:
                    tstate.inflight = max(tstate.inflight - 1, 0)
                    if outcome == "served":
                        tstate.served += 1
            self._observe(rid, op, key, outcome, state,
                          time.perf_counter() - t0, resp,
                          tenant=tenant)
            scope.__exit__(None, None, None)
            if isinstance(resp, dict):
                # Echo the router's span on the wire so the client
                # can parent its own follow-up spans on this hop.
                resp.setdefault(tracectx.TRACE_FIELD,
                                tracectx.to_wire(ctx))

    def _dispatch_attempts(self, req, rid, key, state,
                           retry_with_backoff, allowed=None,
                           tenant=None, tenant_frac=1.0):
        deadline = time.monotonic() + self.config.request_deadline_s
        # index -> generation at HARD-failure time (dead connection,
        # hang, poison): a later attempt may return to the slot only
        # once it has been REPLACED. Transient busy/draining refusals
        # go in `soft_failed` instead — skipped on the first ring
        # pass but re-eligible on the fallback pass (the replica-side
        # pending bound drains between backoffs; fencing it on
        # generation would starve a small fleet into shedding).
        last_failed: dict = {}
        soft_failed: set = set()

        def attempt_once():
            state["attempts"] += 1
            # Priority-weighted headroom: a low-priority tenant sees
            # only its priority's share of the per-replica inflight
            # bound (recomputed per attempt — the bound is a live
            # knob). Full-priority and unconfigured tenants keep the
            # exact pre-tenant bound.
            bound = None
            if tenant_frac < 1.0:
                bound = max(
                    1, int(self.config.max_inflight_per_replica
                           * tenant_frac))
                if bound >= self.config.max_inflight_per_replica:
                    bound = None
            rep = self._pick(key, last_failed, soft_failed,
                             allowed=allowed, inflight_bound=bound)
            if rep is None:
                if allowed is not None:
                    with self._lock:
                        live = [r for r in self.replicas
                                if r.index in allowed
                                and r.state in ("healthy",
                                                "suspect")]
                    if not live:
                        raise NoHolderError(
                            f"no live holder for table "
                            f"{req.get('table')!r} (holder set "
                            f"{sorted(allowed)} all dead/drained); "
                            "refusing rather than misrouting to a "
                            "replica without the image")
                if bound is not None and self._pick(
                        key, last_failed, soft_failed,
                        allowed=allowed, reserve=False) is not None:
                    # A replica WOULD admit at the full fleet bound:
                    # this is a priority shed, not fleet-wide
                    # overload — the low-priority tenant yields its
                    # headroom first, named as such.
                    raise ShedError(
                        f"tenant {tenant!r} shed under fleet "
                        f"pressure: priority weight "
                        f"{tenant_frac:.2f} caps its per-replica "
                        f"inflight at {bound} (fleet bound "
                        f"{self.config.max_inflight_per_replica}); "
                        "higher-priority tenants keep the remaining "
                        "headroom")
                raise AdmissionError(
                    "fleet admission: no admittable replica "
                    f"(inflight bound "
                    f"{self.config.max_inflight_per_replica}"
                    " or p95/QPS shed policy); retry with backoff")
            state["replica"] = rep
            # Every attempt — including the ones that fail and fail
            # over — is its own child span of the dispatch, carried
            # on the wire to the replica, so one trace shows the
            # whole causal chain victim-attempt included.
            attempt_ctx = tracectx.child(state.get("trace"))
            telemetry.event(
                "fleet_attempt", request_id=rid,
                op=req.get("op"), replica=rep.index,
                attempt=state["attempts"],
                **tracectx.stamp(attempt_ctx))
            gen0 = rep.generation
            try:
                remaining = max(deadline - time.monotonic(), 0.1)
                client = ServiceClient(*rep.addr(),
                                       timeout_s=remaining)
                try:
                    resp = client.send(tracectx.attach(
                        {**req, "request_id": rid}, attempt_ctx))
                finally:
                    # Superseded attempts are abandoned with their
                    # connection — a late answer is never read.
                    client.close()
            except (OSError, ValueError) as exc:
                self._strike(
                    rep, f"request {rid}: "
                         f"{type(exc).__name__}: {exc}")
                last_failed[rep.index] = gen0
                self._record_attempt_failed(
                    rid, req, key, rep, gen0, state["attempts"],
                    attempt_ctx,
                    f"{type(exc).__name__}: {exc}")
                raise _AttemptFailed(
                    f"replica {rep.index} connection failed: "
                    f"{type(exc).__name__}: {exc}") from exc
            finally:
                with self._lock:
                    if rep.generation == gen0:
                        rep.inflight = max(rep.inflight - 1, 0)
            fault = self._replica_fault(resp)
            if fault is None and allowed is not None \
                    and not resp.get("ok") \
                    and resp.get("error") == "ResidentError":
                # Holder-routed probe-only join answered "no resident
                # table": the directory says this slot holds the
                # image, the replica says it does not (a replacement
                # whose rebuild has not started yet, or an image lost
                # with a prior incarnation). That inconsistency is
                # the FLEET's, not the client's answer — park the
                # slot stale (the rebuild's completion overwrites
                # this) and fail over to another holder.
                fault = "stale"
            if fault is not None:
                if fault in ("hang", "poisoned"):
                    self._drain(rep, f"request {rid}: {fault}")
                    last_failed[rep.index] = gen0
                elif fault == "stale":
                    # Generation fence fired: this holder missed an
                    # append. Hard-exclude the incarnation (it can
                    # never catch up short of a rebuild) and record
                    # the staleness in the table directory — the
                    # retry lands on an up-to-date holder.
                    last_failed[rep.index] = gen0
                    self._mark_holder_stale(req.get("table"),
                                            rep.index)
                else:
                    # busy/draining: transient — steer the next
                    # attempt elsewhere, but stay re-eligible on the
                    # fallback pass.
                    soft_failed.add(rep.index)
                self._record_attempt_failed(
                    rid, req, key, rep, gen0, state["attempts"],
                    attempt_ctx,
                    f"{fault}: {resp.get('message') or resp.get('error')}")
                raise _AttemptFailed(
                    f"replica {rep.index} {fault}: "
                    f"{resp.get('message') or resp.get('error')}")
            return self._augment(resp, rep, state)

        try:
            resp, attempts = retry_with_backoff(
                attempt_once,
                max_attempts=self.config.retry_budget + 1,
                backoff_s=self.config.retry_backoff_s,
                deadline_s=self.config.request_deadline_s,
                retry_on=(_AttemptFailed,),
            )
            state["failovers"] = len(attempts) - 1
            with self._lock:
                self.failovers_total += state["failovers"]
            return resp
        except _AttemptFailed as exc:
            trail = getattr(exc, "_retry_attempts", [])
            state["failovers"] = max(len(trail) - 1, 0)
            with self._lock:
                self.failovers_total += state["failovers"]
            raise FleetError(
                f"request {rid} failed after {len(trail)} attempt(s) "
                f"(retry_budget={self.config.retry_budget}): "
                f"{exc}") from exc

    def _pick(self, key: str, exclude: dict,
              soft: Optional[set] = None,
              allowed: Optional[set] = None,
              inflight_bound: Optional[int] = None,
              reserve: bool = True) -> Optional[_Replica]:
        """Pick AND reserve (inflight slot taken under the one lock,
        so two concurrent dispatches can never both pass the
        admission bound). The caller releases the slot in its
        dispatch finally. ``exclude`` maps a HARD-failed replica's
        index to its generation AT failure: that slot becomes
        eligible again only once REPLACED (generation moved) — never
        handed the same request back while still the known-bad
        incarnation. ``soft`` holds transiently-refusing (busy/
        draining) indices: preferred-against on the first pass,
        re-eligible on the fallback pass. ``allowed`` (replicated
        resident traffic) restricts the walk to the table's holder
        set — a non-holder never sees the request.
        ``inflight_bound`` tightens the per-replica inflight cap for
        low-priority tenants; ``reserve=False`` is a dry-run probe
        (no slot taken) used to tell a priority shed apart from a
        fleet-wide one."""
        with self._lock:
            n = len(self.replicas)
            if not n:
                return None
            start = int(key[:8], 16) % n
            order = [self.replicas[(start + k) % n]
                     for k in range(n)]
            for second_pass in (False, True):
                for rep in order:
                    if allowed is not None \
                            and rep.index not in allowed:
                        continue
                    if rep.index in exclude:
                        if not second_pass:
                            continue
                        if rep.generation <= exclude[rep.index]:
                            continue
                    if not second_pass and soft \
                            and rep.index in soft:
                        continue
                    if self._admittable(rep, inflight_bound):
                        if reserve:
                            rep.inflight += 1
                        return rep
        return None

    @staticmethod
    def _replica_fault(resp: dict) -> Optional[str]:
        """Classify an error response: replica-fatal (failover-able)
        vs a client error passed through untouched. HangError and
        poisoned refusals mean the REPLICA is gone for serving
        purposes; draining/pending refusals mean try a sibling; any
        other error (ValueError, IntegrityError, ...) is the CLIENT's
        answer — a refusal the fleet must not mask."""
        if resp.get("ok"):
            return None
        err = resp.get("error")
        msg = str(resp.get("message", ""))
        if err == "HangError":
            return "hang"
        if err == "StaleGenerationError":
            # The holder-side generation fence: failover-able (an
            # up-to-date holder can serve), never the client's
            # answer.
            return "stale"
        if err in ("AdmissionError", "DrainingError"):
            if "poisoned" in msg:
                return "poisoned"
            if "draining" in msg or err == "DrainingError":
                return "draining"
            return "busy"
        return None

    def _augment(self, resp: dict, rep: _Replica, state) -> dict:
        resp = dict(resp)
        resp["fleet"] = {
            "replica": rep.index,
            "generation": rep.generation,
            "attempts": state["attempts"],
            "failovers": state["attempts"] - 1,
        }
        return resp

    def _record_attempt_failed(self, rid, req, key, rep, gen0,
                               attempt, attempt_ctx, error) -> None:
        """A failed dispatch attempt lands in the flight ring WITH
        its replica/trace pair — before this, only the final attempt
        was visible postmortem, so a failover's victim hop could not
        be tied to the retry that served. Never fails the dispatch."""
        try:
            telemetry.event(
                "fleet_attempt_failed", request_id=rid,
                op=req.get("op"), replica=rep.index,
                attempt=attempt, error=error,
                **tracectx.stamp(attempt_ctx))
            self.recorder.record(
                request_id=rid, op=req.get("op", "?"),
                signature=key, outcome="attempt_failed",
                attempt=attempt, error=error,
                replica={"index": rep.index, "generation": gen0},
                trace=tracectx.stamp(attempt_ctx) or None)
        except Exception as exc:  # noqa: BLE001 - bookkeeping boundary
            telemetry.event("fleet_observability_error",
                            request_id=rid,
                            error=f"{type(exc).__name__}: {exc}")

    def _observe(self, rid, op, key, outcome, state, elapsed_s,
                 resp, tenant=None):
        """Fleet-side accounting fan-out (live metrics, flight ring,
        history line stamped with the serving replica and, when the
        wire named one, the tenant). Never fails a request."""
        try:
            rep = state.get("replica")
            stamp = ({"index": rep.index,
                      "generation": rep.generation,
                      "port": rep.backend.port}
                     if rep is not None else None)
            resident = self._resident_stamp(resp)
            trace = tracectx.stamp(state.get("trace")) or None
            with self._lock:
                if outcome == "served":
                    self.served += 1
                elif outcome == "failed":
                    self.failed += 1
            # The router's own dispatch span — the hop the fleet
            # timeline hangs admission/route/failover walls on.
            telemetry.span_complete(
                "fleet_dispatch", time.perf_counter() - elapsed_s,
                elapsed_s, request_id=rid, op=op, outcome=outcome,
                attempts=state.get("attempts", 0),
                failovers=state.get("failovers", 0),
                replica=(state["replica"].index
                         if state.get("replica") is not None
                         else None),
                **(trace or {}))
            tstamp = ({"tenant": tenant} if tenant is not None
                      else {})
            self.live.record_request(
                op, outcome,
                latency_s=elapsed_s if outcome == "served" else None,
                signature=key,
                new_traces=int((resp or {}).get("new_traces") or 0),
                tenant=tenant,
                shed=bool((resp or {}).get("shed")))
            self.recorder.record(
                request_id=rid, op=op, signature=key,
                outcome=outcome, elapsed_s=round(elapsed_s, 6),
                matches=(resp or {}).get("matches"),
                new_traces=(resp or {}).get("new_traces"),
                failovers=state.get("failovers", 0),
                replica=stamp,
                resident=resident,
                trace=trace,
                error=(None if (resp or {}).get("ok")
                       else (resp or {}).get("message")),
                **tstamp)
            if self.history is not None and op not in ("ping",
                                                       "stats",
                                                       "metrics"):
                self.history.append(tel_history.request_entry(
                    request_id=rid, op=op, signature=key,
                    outcome=outcome, wall_s=elapsed_s,
                    new_traces=int((resp or {}).get("new_traces")
                                   or 0),
                    matches=(resp or {}).get("matches"),
                    error=(None if (resp or {}).get("ok")
                           else str((resp or {}).get("message"))),
                    resident=resident,
                    replica=stamp, trace=trace,
                    tenant=tenant))
        except Exception as exc:  # noqa: BLE001 - bookkeeping boundary
            telemetry.event("fleet_observability_error",
                            request_id=rid,
                            error=f"{type(exc).__name__}: {exc}")

    def _resident_stamp(self, resp) -> Optional[dict]:
        """The holder/generation stamp for history + flight records:
        the replica's own resident stamp when present, else the table
        info of a fan-out response; holder set attached from the
        directory so `analyze history` can attribute a latency step
        to a rebuild."""
        r = (resp or {}).get("resident")
        fl = (resp or {}).get("fleet") or {}
        stamp = None
        if isinstance(r, dict) and r.get("table") is not None \
                and r.get("generation") is not None:
            stamp = dict(r)
        elif fl.get("table") is not None \
                and fl.get("table_generation") is not None:
            stamp = {"table": fl["table"],
                     "generation": fl["table_generation"]}
        if stamp is not None:
            with self._lock:
                entry = self._tables.get(stamp["table"])
                if entry is not None:
                    stamp["holders"] = sorted(entry["holders"])
        return stamp

    # -- replicated resident state (table_replication > 1) ------------

    def _holder_slots(self, key: str) -> list:
        """Ring order for a table key — registration picks the first
        K LIVE slots from here, so the primary holder is exactly the
        slot probe-only joins ring-start on."""
        n = len(self.replicas)
        start = int(key[:8], 16) % max(n, 1)
        return [(start + k) % n for k in range(n)]

    def _send_table_op(self, rep: _Replica, req: dict,
                       rid: str,
                       trace: Optional[dict] = None
                       ) -> Optional[dict]:
        """One table-op leg of a fan-out: direct wire send to one
        holder. ``None`` = connection-dead (struck, failover-able);
        a dict is the holder's answer, structured refusals
        included. ``trace`` (a per-leg child context) rides the
        wire so the holder's spans join the fan-out's trace."""
        with self._lock:
            rep.inflight += 1
        gen0 = rep.generation
        try:
            client = ServiceClient(
                *rep.addr(),
                timeout_s=self.config.request_deadline_s)
            try:
                return client.send(tracectx.attach(
                    {**req, "request_id": rid}, trace))
            finally:
                client.close()
        except (OSError, ValueError) as exc:
            self._strike(rep, f"table op {req.get('op')} {rid}: "
                              f"{type(exc).__name__}: {exc}")
            return None
        finally:
            with self._lock:
                if rep.generation == gen0:
                    rep.inflight = max(rep.inflight - 1, 0)

    def _table_fanout(self, req: dict, rid: str, key: str,
                      state: dict) -> dict:
        op = req["op"]
        name = str(req["name"])
        if op == "register":
            return self._register_fanout(req, rid, name, key, state)
        if op == "append":
            return self._append_fanout(req, rid, name, key, state)
        return self._drop_fanout(req, rid, name, key, state)

    def _register_fanout(self, req, rid, name, key, state) -> dict:
        """Register on the first K live ring slots; write the durable
        manifest; record the holder set in the directory. A
        structured refusal from any holder (duplicate name, schema)
        aborts the fan-out, rolls back the holders already
        registered, and passes the refusal through — registration is
        all-or-nothing."""
        want = min(self.config.table_replication,
                   len(self.replicas))
        results: list = []
        for idx in self._holder_slots(key):
            if len(results) >= want:
                break
            rep = self.replicas[idx]
            with self._lock:
                if rep.state not in ("healthy", "suspect"):
                    continue
            state["attempts"] += 1
            state["replica"] = rep
            leg = tracectx.child(state.get("trace"))
            telemetry.event("fleet_fanout_leg", op="register",
                            table=name, replica=rep.index,
                            request_id=rid, **tracectx.stamp(leg))
            resp = self._send_table_op(rep, req, rid, trace=leg)
            if resp is None:
                continue
            if not resp.get("ok"):
                for prep, _ in results:
                    self._send_table_op(
                        prep, {"op": "drop", "name": name},
                        f"{rid}-rollback",
                        trace=tracectx.child(state.get("trace")))
                return {**resp, "request_id": rid}
            results.append((rep, resp))
        if not results:
            raise NoHolderError(
                f"register {name!r}: no live replica accepted the "
                f"registration (wanted {want} holder(s) of "
                f"{len(self.replicas)} slots)")
        holders = {rep.index: {"state": "serving",
                               "generation":
                                   int(r.get("generation", 1))}
                   for rep, r in results}
        gen = max(h["generation"] for h in holders.values())
        primary = results[0][1]
        with self._lock:
            self._tables[name] = {
                "generation": gen,
                "key": primary.get("key", "key"),
                "holders": holders,
            }
        self._write_manifest_register(name, req, primary)
        self._save_directory()
        telemetry.event("fleet_table_registered", table=name,
                        holders=sorted(holders), generation=gen)
        resp = dict(primary)
        resp["fleet"] = {
            "table": name,
            "holders": sorted(holders),
            "table_generation": gen,
            "attempts": state["attempts"],
            "failovers": 0,
        }
        return resp

    def _append_fanout(self, req, rid, name, key, state) -> dict:
        """Apply one delta to EVERY holder. A holder the delta does
        not reach (dead, injected fault, mid-rebuild) is fenced
        STALE — it can never catch up by later appends, so it stops
        serving probe-only work until a rebuild replays the manifest.
        The delta also lands in the manifest, so rebuilds and
        late-joining holders replay it."""
        with self._lock:
            entry = self._tables.get(name)
        if entry is None:
            raise NoHolderError(
                f"append to {name!r}: table is not in the fleet "
                "directory (never registered through this router, "
                "or already dropped)")
        outcomes: dict = {}
        for idx in sorted(entry["holders"]):
            rep = self.replicas[idx]
            hstate = entry["holders"][idx]
            with self._lock:
                live = rep.state in ("healthy", "suspect")
            if not live or hstate["state"] == "rebuilding":
                # Unreachable or mid-rebuild: the manifest carries
                # the delta to it (rebuild replays; a dead slot's
                # replacement rebuilds on arrival).
                continue
            state["attempts"] += 1
            state["replica"] = rep
            leg = tracectx.child(state.get("trace"))
            telemetry.event("fleet_fanout_leg", op="append",
                            table=name, replica=rep.index,
                            request_id=rid, **tracectx.stamp(leg))
            outcomes[idx] = self._send_table_op(rep, req, rid,
                                                trace=leg)
        ok_items = {i: r for i, r in outcomes.items()
                    if r is not None and r.get("ok")}
        if not ok_items:
            refusals = [r for r in outcomes.values()
                        if r is not None]
            if refusals:
                # Deterministic client refusal (schema mismatch,
                # unknown table): every holder answered the same —
                # pass it through, fence nothing.
                return {**refusals[0], "request_id": rid}
            raise NoHolderError(
                f"append to {name!r}: no live holder reachable "
                f"(holder set {sorted(entry['holders'])})")
        gen = max(int(r.get("generation", 0))
                  for r in ok_items.values())
        for idx, hstate in entry["holders"].items():
            if idx in ok_items:
                hstate["state"] = "serving"
                hstate["generation"] = \
                    int(ok_items[idx]["generation"])
            elif hstate["state"] not in ("rebuilding", "stale"):
                hstate["state"] = "stale"
                telemetry.event("fleet_holder_stale", table=name,
                                replica=idx,
                                holder_generation=
                                hstate["generation"],
                                required_generation=gen)
                self.recorder.record(
                    request_id=rid, op="append", signature=key,
                    outcome="holder_stale",
                    replica={"index": idx,
                             "generation":
                                 self.replicas[idx].generation},
                    resident={"table": name,
                              "generation": hstate["generation"]})
        entry["generation"] = gen
        self._append_manifest_delta(name, req, gen)
        self._save_directory()
        if len(ok_items) < len(entry["holders"]):
            telemetry.event("fleet_append_partial", table=name,
                            applied=sorted(ok_items),
                            holders=sorted(entry["holders"]),
                            generation=gen)
        primary = ok_items[min(ok_items)]
        resp = dict(primary)
        resp["fleet"] = {
            "table": name,
            "holders": sorted(entry["holders"]),
            "applied": sorted(ok_items),
            "table_generation": gen,
            "attempts": state["attempts"],
            "failovers": 0,
        }
        return resp

    def _drop_fanout(self, req, rid, name, key, state) -> dict:
        with self._lock:
            entry = self._tables.pop(name, None)
        if entry is None:
            raise NoHolderError(
                f"drop {name!r}: table is not in the fleet "
                "directory")
        dropped = []
        for idx in sorted(entry["holders"]):
            rep = self.replicas[idx]
            with self._lock:
                live = rep.state in ("healthy", "suspect")
            if not live:
                continue
            state["attempts"] += 1
            state["replica"] = rep
            leg = tracectx.child(state.get("trace"))
            telemetry.event("fleet_fanout_leg", op="drop",
                            table=name, replica=rep.index,
                            request_id=rid, **tracectx.stamp(leg))
            resp = self._send_table_op(rep, req, rid, trace=leg)
            if resp is not None and resp.get("ok"):
                dropped.append(idx)
        self._drop_manifest(name)
        self._save_directory()
        telemetry.event("fleet_table_dropped", table=name,
                        holders=sorted(entry["holders"]),
                        reached=dropped)
        # Idempotent by intent: the directory entry and manifest are
        # gone even if a dead holder could not be reached — its
        # replacement rebuilds from the manifest set, which no
        # longer includes this table.
        return {"ok": True, "op": "drop", "table": name,
                "dropped": True, "request_id": rid,
                "fleet": {"table": name,
                          "holders": sorted(entry["holders"]),
                          "applied": dropped,
                          "attempts": state["attempts"],
                          "failovers": 0}}

    def _mark_holder_stale(self, table, index: int) -> None:
        if table is None:
            return
        with self._lock:
            entry = self._tables.get(str(table))
            if entry is None:
                return
            hstate = entry["holders"].get(index)
            if hstate is None or hstate["state"] == "stale":
                return
            hstate["state"] = "stale"
        telemetry.event("fleet_holder_stale", table=str(table),
                        replica=index,
                        holder_generation=hstate["generation"],
                        required_generation=entry["generation"])
        self._save_directory()

    def _rebuild_holder_tables(self, rep: _Replica) -> None:
        """Replacement arrived on a holder slot: replay every table
        the slot holds from its durable manifest (rebuilding ->
        serving lifecycle). Warm probe-only programs reload from the
        persist dir, so the rebuilt image serves repeat
        signatures with zero new traces."""
        with self._lock:
            todo = [name for name, e in self._tables.items()
                    if rep.index in e["holders"]]
        for name in todo:
            self._rebuild_one(rep, name)

    def _rebuild_one(self, rep: _Replica, name: str) -> None:
        with self._lock:
            entry = self._tables.get(name)
            holder = (entry or {}).get("holders",
                                       {}).get(rep.index)
            if holder is None:
                return
            holder["state"] = "rebuilding"
        self._save_directory()
        # Rebuilds have no client: the router roots a fresh trace so
        # the manifest replay's spans (router legs + holder-side
        # register/append spans) assemble into one causal chain in
        # the fleet timeline.
        ctx = tracectx.mint()
        telemetry.event("fleet_holder_rebuilding", table=name,
                        replica=rep.index,
                        generation_target=entry["generation"],
                        **tracectx.stamp(ctx))
        manifest = (load_table_manifest(self._coord_dir, name)
                    if self._coord_dir else None)
        if manifest is None:
            with self._lock:
                holder["state"] = "stale"
            telemetry.event("fleet_rebuild_no_manifest",
                            table=name, replica=rep.index)
            self._save_directory()
            return
        t0 = time.perf_counter()
        # Deltas replay with maintain=True: the LSM merge runs INSIDE
        # the rebuild, so the rebuilt image is the same merged shape
        # the surviving holders serve (merge programs stay out of the
        # disk tier, and a merge deferred to the first probe-only join
        # would cost that join its zero-trace warm gate).
        ops = ([dict(manifest["register"], replace=True)]
               + [dict(d, maintain=True)
                  for d in manifest.get("deltas", [])])
        gen = 0
        step = 0
        for _catchup_round in range(3):
            for op_req in ops:
                rid = (f"rebuild-{_table_slug(name)}-r{rep.index}"
                       f"g{rep.generation}-{step}")
                step += 1
                resp = self._send_table_op(
                    rep, op_req, rid, trace=tracectx.child(ctx))
                if resp is None or not resp.get("ok"):
                    with self._lock:
                        holder["state"] = "stale"
                    telemetry.event(
                        "fleet_rebuild_failed", table=name,
                        replica=rep.index, step=step - 1,
                        error=(resp or {}).get("message")
                        or (resp or {}).get("error")
                        or "connection failed")
                    self._save_directory()
                    return
                gen = int(resp.get("generation", 0))
            with self._lock:
                target = entry["generation"]
            if gen >= target:
                break
            # An append fanned out WHILE we replayed: it skipped this
            # rebuilding slot (the fan-out never waits on a rebuild)
            # but landed in the manifest. Reload and replay the tail
            # instead of parking the fresh image stale — stale here
            # would silently degrade the table to K-1 durability for
            # the rest of this incarnation. deltas[k] produces
            # generation k+2 (register is 1), so after reaching
            # ``gen`` the unapplied tail starts at deltas[gen-1].
            manifest = (load_table_manifest(self._coord_dir, name)
                        if self._coord_dir else None)
            tail = (manifest or {}).get("deltas",
                                        [])[max(gen - 1, 0):]
            if not tail:
                break
            ops = [dict(d, maintain=True) for d in tail]
        elapsed = time.perf_counter() - t0
        with self._lock:
            holder["generation"] = gen
            if gen >= entry["generation"]:
                holder["state"] = "serving"
            else:
                # The manifest was behind the directory (a lost
                # write): refuse to serve a silently-short image.
                holder["state"] = "stale"
            self.rebuilds_total += 1
        telemetry.event("fleet_holder_rebuilt", table=name,
                        replica=rep.index, generation=gen,
                        state=holder["state"],
                        elapsed_s=round(elapsed, 3),
                        **tracectx.stamp(ctx))
        self.recorder.record(
            request_id=f"rebuild-{_table_slug(name)}-r{rep.index}",
            trace=tracectx.stamp(ctx) or None,
            op="rebuild",
            signature=self.affinity_key({"op": "register",
                                         "name": name}),
            outcome="rebuilt", elapsed_s=round(elapsed, 6),
            resident={"table": name, "generation": gen,
                      "holders": sorted(entry["holders"])},
            replica={"index": rep.index,
                     "generation": rep.generation})
        if self.history is not None:
            self.history.append(tel_history.request_entry(
                request_id=(f"rebuild-{_table_slug(name)}"
                            f"-r{rep.index}"),
                op="rebuild",
                signature=self.affinity_key({"op": "register",
                                             "name": name}),
                outcome="rebuilt", wall_s=elapsed,
                resident={"table": name, "generation": gen,
                          "holders": sorted(entry["holders"])},
                replica={"index": rep.index,
                         "generation": rep.generation,
                         "port": getattr(rep.backend, "port",
                                         None)},
                trace=tracectx.stamp(ctx) or None))
        self._save_directory()

    # -- the durable router directory + HA adoption -------------------

    def _save_directory(self) -> None:
        """Mirror the in-memory replica/table directory to the coord
        dir (kind ``router_directory``), fence-counted and stamped
        with the lease epoch. Only an actively-serving router writes
        — a standby or fenced-out incarnation never clobbers the
        primary's view."""
        coord = self._coord_dir
        if coord is None:
            return
        if not (self._replicated or self._lease is not None):
            return
        if self.role in ("standby", "fenced"):
            return
        if self._lease is not None:
            # Write-time fence: re-read the lease file. A crashed or
            # stalled ex-primary whose renewer hasn't (or can never)
            # flip its role must not clobber the directory the NEW
            # primary is writing — ownership at the moment of the
            # write is what authorizes the write.
            doc0 = self._lease.read()
            if doc0 is not None and (
                    doc0.get("owner") != self._lease.owner
                    or int(doc0.get("epoch") or 0)
                    != self._lease.epoch):
                self.role = "fenced"
                telemetry.event(
                    "fleet_directory_write_fenced",
                    owner=self._lease.owner,
                    lease_owner=doc0.get("owner"),
                    lease_epoch=doc0.get("epoch"))
                return
        with self._lock:
            self._directory_fence += 1
            doc = {
                "kind": "router_directory",
                "schema_version": ROUTER_DIRECTORY_SCHEMA_VERSION,
                "fence": self._directory_fence,
                "lease_epoch": (self._lease.epoch
                                if self._lease is not None else 0),
                "written_by": self.config.router_id or "router",
                "table_replication":
                    self.config.table_replication,
                "updated_unix_s": time.time(),
                "tables": {
                    name: {
                        "generation": e["generation"],
                        "key": e.get("key", "key"),
                        "holders": {str(i): dict(h) for i, h
                                    in e["holders"].items()},
                    } for name, e in self._tables.items()
                },
                "replicas": [
                    {"index": r.index,
                     "host": getattr(r.backend, "host", None),
                     "port": getattr(r.backend, "port", None),
                     "generation": r.generation,
                     "state": r.state}
                    for r in self.replicas
                ],
            }
        try:
            atomic_write_json(router_directory_path(coord), doc)
        except OSError as exc:
            telemetry.event("fleet_directory_write_failed",
                            error=f"{type(exc).__name__}: {exc}")

    def adopt_from_directory(self) -> bool:
        """Standby takeover: rebuild the replica set and table
        directory from the durable ``router_directory.json`` written
        by the dead primary. Replica endpoints attach WITHOUT process
        handles (:class:`AttachedReplica`) — liveness is re-judged on
        the wire by the prober, and a dead slot drains and respawns
        through this router's own factory."""
        coord = self._coord_dir
        doc = load_router_directory(coord) if coord else None
        if doc is None:
            return False
        with self._lock:
            self.replicas = [
                _Replica(
                    index=int(spec["index"]),
                    backend=AttachedReplica(
                        spec.get("host") or "127.0.0.1",
                        int(spec["port"])),
                    generation=int(spec.get("generation") or 0),
                    state=str(spec.get("state") or "healthy"))
                for spec in doc.get("replicas", [])
                if spec.get("port") is not None
            ]
            self._tables = {
                name: {
                    "generation": int(e["generation"]),
                    "key": e.get("key", "key"),
                    "holders": {int(i): dict(h) for i, h
                                in (e.get("holders") or {}).items()},
                } for name, e in (doc.get("tables") or {}).items()
            }
            self._directory_fence = int(doc.get("fence") or 0)
        telemetry.event("fleet_directory_adopted",
                        replicas=len(self.replicas),
                        tables=sorted(self._tables),
                        fence=self._directory_fence)
        self._prober = threading.Thread(target=self._probe_loop,
                                        daemon=True,
                                        name="fleet-prober")
        self._prober.start()
        return True

    def _write_manifest_register(self, name, req, resp) -> None:
        if not self._coord_dir:
            return
        spec = {k: v for k, v in req.items() if k != "request_id"}
        doc = table_manifest_doc(
            name, spec, resp.get("key", "key"),
            int(resp.get("generation", 1)), [],
            {"replica_ranks": self.config.replica_ranks,
             "table_replication": self.config.table_replication})
        try:
            atomic_write_json(
                table_manifest_path(self._coord_dir, name), doc)
        except OSError as exc:
            telemetry.event("fleet_manifest_write_failed",
                            table=name,
                            error=f"{type(exc).__name__}: {exc}")

    def _append_manifest_delta(self, name, req,
                               generation: int) -> None:
        if not self._coord_dir:
            return
        man = load_table_manifest(self._coord_dir, name)
        if man is None:
            # Without the register spec the delta cannot be made
            # durable — loud, because a rebuild of this table now
            # CANNOT reach the new generation.
            telemetry.event("fleet_manifest_missing", table=name,
                            generation=generation)
            return
        spec = {k: v for k, v in req.items() if k != "request_id"}
        doc = table_manifest_doc(
            name, man["register"], man.get("key", "key"),
            generation, list(man.get("deltas") or []) + [spec],
            man.get("prep") or {})
        try:
            atomic_write_json(
                table_manifest_path(self._coord_dir, name), doc)
        except OSError as exc:
            telemetry.event("fleet_manifest_write_failed",
                            table=name,
                            error=f"{type(exc).__name__}: {exc}")

    def _drop_manifest(self, name) -> None:
        if not self._coord_dir:
            return
        try:
            os.remove(table_manifest_path(self._coord_dir, name))
        except OSError:
            pass

    # -- operator surfaces --------------------------------------------

    def dump_flight_recorder(self, reason: str) -> Optional[str]:
        """Dump the router's request ring (the daemon's postmortem
        contract, fleet-side): to ``flight_recorder_path``, else
        ``history_dir``. Called at stop when a path is configured;
        safe to call any time for a live snapshot."""
        path = self.config.flight_recorder_path
        if path is None:
            if self.config.history_dir is None:
                return None
            path = os.path.join(self.config.history_dir,
                                tel_live.FLIGHT_RECORDER_FILENAME)
        try:
            path = self.recorder.dump(path, reason)
        except OSError as exc:
            telemetry.event("fleet_flightrecorder_dump_failed",
                            path=path,
                            error=f"{type(exc).__name__}: {exc}")
            return None
        telemetry.event("fleet_flightrecorder_dumped", path=path,
                        reason=reason)
        return path

    def stats(self) -> dict:
        with self._lock:
            reps = [{
                "index": r.index,
                "generation": r.generation,
                "state": r.state,
                "port": getattr(r.backend, "port", None),
                "inflight": r.inflight,
                "strikes": r.strikes,
                "qps_60s": (r.last_stats or {}).get("qps_60s"),
                "p95_s": ((r.last_stats or {}).get("latency")
                          or {}).get("p95_s"),
                "poisoned": (r.last_stats or {}).get("poisoned"),
            } for r in self.replicas]
            counts: dict = {}
            for r in self.replicas:
                counts[r.state] = counts.get(r.state, 0) + 1
            return {
                "role": "fleet",
                "replicas": len(self.replicas),
                "healthy": counts.get("healthy", 0),
                "suspect": counts.get("suspect", 0),
                "drained": counts.get("drained", 0),
                "failed": counts.get("failed", 0),
                "failovers_total": self.failovers_total,
                "shed_total": self.shed_total,
                "replaced_total": self.replaced_total,
                "drains_total": self.drains_total,
                "rebuilds_total": self.rebuilds_total,
                "takeovers_total": self.takeovers_total,
                "router_role": self.role,
                "table_replication":
                    self.config.table_replication,
                "tables": {
                    name: {"generation": e["generation"],
                           "holders": {str(i): dict(h) for i, h
                                       in e["holders"].items()}}
                    for name, e in self._tables.items()},
                "served": self.served,
                "failed_requests": self.failed,
                "rejected": self.rejected,
                "qps_60s": round(self.live.qps(), 3),
                "uptime_s": round(self.live.uptime_s(), 3),
                "latency": self.live.overall_latency(),
                "replica_detail": reps,
                "tenants": self._tenant_stats_locked(),
                "autoscale": {
                    "enabled": bool(self.config.autoscale),
                    "spawns_total": self.autoscale_spawns_total,
                    "drains_total": self.autoscale_drains_total,
                },
            }

    def _tenant_stats_locked(self) -> dict:
        """Per-tenant stats block ({} when no tenant has been seen):
        the router LiveMetrics tenant summary (requests/outcomes/
        shed/qps/latency — the shape ``--watch`` renders) merged with
        the admission-side state (inflight, priority, quota,
        shed-by-kind tallies). Caller holds the router lock."""
        out = self.live.tenants_summary()
        for name, st in self._tenant_states.items():
            t = out.setdefault(name, {"requests": 0, "outcomes": {},
                                      "shed": 0, "qps_60s": 0.0,
                                      "latency": {}})
            t["inflight"] = st.inflight
            t["priority"] = st.priority
            t["quota_sheds"] = st.quota_sheds
            t["priority_sheds"] = st.priority_sheds
            if st.quota:
                t["quota"] = dict(st.quota)
        return out

    def prometheus_metrics(self) -> str:
        st = self.stats()
        text = self.live.to_prometheus(gauges={
            "fleet_replicas": st["replicas"],
            "fleet_healthy": st["healthy"],
            "fleet_suspect": st["suspect"],
            "fleet_drained": st["drained"],
            "fleet_failovers_total": st["failovers_total"],
            "fleet_shed_total": st["shed_total"],
            "fleet_replaced_total": st["replaced_total"],
            "fleet_drains_total": st["drains_total"],
            "fleet_rebuilds_total": st["rebuilds_total"],
            "router_takeovers_total": st["takeovers_total"],
            # 1 = actively serving (single/primary), 0 = standby or
            # fenced out.
            "router_role": (1 if st["router_role"] in ("single",
                                                       "primary")
                            else 0),
            "autoscale_enabled": (1 if st["autoscale"]["enabled"]
                                  else 0),
            "autoscale_spawns_total":
                st["autoscale"]["spawns_total"],
            "autoscale_drains_total":
                st["autoscale"]["drains_total"],
        })
        if st["tenants"]:
            # Labeled per-tenant admission gauges (the request/shed
            # counter series ride the shared LiveMetrics tenant
            # exposition above).
            lines = [text.rstrip("\n"),
                     "# TYPE djtpu_tenant_inflight gauge"]
            for name in sorted(st["tenants"]):
                t = st["tenants"][name]
                lines.append(
                    f'djtpu_tenant_inflight{{tenant="{name}"}} '
                    f'{t.get("inflight") or 0}')
            lines.append("# TYPE djtpu_tenant_priority gauge")
            for name in sorted(st["tenants"]):
                t = st["tenants"][name]
                lines.append(
                    f'djtpu_tenant_priority{{tenant="{name}"}} '
                    f'{t.get("priority") or 1}')
            text = "\n".join(lines) + "\n"
        if st["tables"]:
            # Labeled per-table gauge: serving-holder count (the
            # fleet's effective replication factor per table, live).
            lines = [text.rstrip("\n"),
                     "# TYPE djtpu_fleet_resident_holders gauge"]
            for name in sorted(st["tables"]):
                holders = st["tables"][name]["holders"]
                serving = sum(1 for h in holders.values()
                              if h.get("state") == "serving")
                lines.append(
                    f'djtpu_fleet_resident_holders'
                    f'{{table="{name}"}} {serving}')
            text = "\n".join(lines) + "\n"
        # One scrape sees the whole fleet: the replica metrics
        # fan-out merged into per-replica-labeled counters plus the
        # bucket-wise-summed latency histogram.
        return text + tel_live.fleet_prometheus(
            self._replica_metrics())

    def _replica_metrics(self) -> dict:
        """Best-effort ``metrics`` fan-out to every LIVE replica:
        index -> LiveMetrics snapshot (None for a slot that is
        drained/failed or did not answer — the fleet exposition
        reports it ``replica_up 0`` rather than stalling the
        scrape)."""
        with self._lock:
            reps = list(self.replicas)
        out: dict = {}
        for rep in reps:
            with self._lock:
                live = rep.state in ("healthy", "suspect")
            snap = None
            if live:
                try:
                    client = ServiceClient(
                        *rep.addr(),
                        timeout_s=self.config.probe_timeout_s)
                    try:
                        resp = client.send(tracectx.attach(
                            {"op": "metrics"}, tracectx.mint()))
                    finally:
                        client.close()
                    if resp.get("ok"):
                        snap = resp.get("metrics")
                except (OSError, ValueError):
                    snap = None
            out[rep.index] = snap
        return out

    def metrics_snapshot(self) -> dict:
        snap = self.live.snapshot()
        snap["stats"] = self.stats()
        snap["flight_records"] = len(self.recorder)
        snap["history_path"] = (self.history.path
                                if self.history is not None else None)
        per_replica = self._replica_metrics()
        snap["replicas"] = {str(i): s for i, s
                            in per_replica.items()}
        snap["fleet"] = tel_live.merge_snapshots(
            [s for s in per_replica.values() if s is not None])
        return snap

    def drain_replica(self, index: int,
                      reason: str = "operator drain") -> dict:
        """The operator op: drain (and replace) one replica by
        index."""
        with self._lock:
            if not 0 <= index < len(self.replicas):
                raise ValueError(f"no replica {index}")
            rep = self.replicas[index]
        self._drain(rep, reason)
        return {"replica": index, "state": rep.state,
                "reason": reason}

    def wait_replaced(self, index: int, timeout_s: float = 60.0
                      ) -> bool:
        """Block until replica ``index`` is healthy at a HIGHER
        generation than when it was last drained (test/smoke
        helper)."""
        rep = self.replicas[index]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if rep.state == "healthy" \
                        and rep.replaced_at is not None \
                        and (rep.drained_at is None
                             or rep.replaced_at >= rep.drained_at):
                    return True
            time.sleep(0.05)
        return False


class _AttemptFailed(RuntimeError):
    """One failover-able dispatch attempt failed (connection death or
    a replica-fatal response) — retried by the bounded
    retry_with_backoff loop, never surfaced raw."""


# -- the router TCP daemon ---------------------------------------------


def _route(router: FleetRouter, req: dict) -> dict:
    op = req.get("op")
    if op == "ping":
        return {"ok": True, "op": "ping", "role": "fleet"}
    if op == "stats":
        return {"ok": True, **router.stats()}
    if op == "metrics":
        if req.get("format") == "prometheus":
            return {"ok": True, "op": "metrics",
                    "format": "prometheus",
                    "prometheus": router.prometheus_metrics()}
        return {"ok": True, "op": "metrics",
                "metrics": router.metrics_snapshot()}
    if op == "drain":
        if req.get("replica") is None:
            # Refuse rather than proxy: routing a bare drain to an
            # affinity-chosen replica would silently recycle one warm
            # replica while telling the operator the service drained.
            raise ValueError(
                "fleet drain needs \"replica\": <index> (drain one "
                "slot, which is then replaced); to stop the whole "
                "fleet use {\"op\": \"shutdown\"}")
        rec = router.drain_replica(
            int(req["replica"]),
            reason=str(req.get("reason", "operator drain")))
        return {"ok": True, "op": "drain", **rec}
    if op == "shutdown":
        # FLEET-level shutdown: stop the router (replicas drained and
        # reaped by the serving loop) — never routed to a replica,
        # which would just kill one daemon and watch it be replaced.
        router.shutdown_requested.set()
        return {"ok": True, "op": "shutdown", "role": "fleet"}
    return router.dispatch(req)


def start_router_daemon(router: FleetRouter, host: str = "127.0.0.1",
                        port: int = 0):
    """Bind + serve the fleet wire on a background thread; returns
    ``(server, port)``. Same line-JSON protocol as one daemon."""
    import socket
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def setup(self):
            super().setup()
            with self.server._conns_lock:
                self.server._conns.add(self.connection)

        def finish(self):
            with self.server._conns_lock:
                self.server._conns.discard(self.connection)
            super().finish()

        def handle(self):
            for raw in self.rfile:
                line = raw.decode("utf-8").strip()
                if not line:
                    continue
                req = None
                try:
                    req = json.loads(line)
                    resp = _route(router, req)
                except Exception as exc:  # noqa: BLE001 - wire edge
                    resp = {"ok": False,
                            "error": type(exc).__name__,
                            "message": str(exc)}
                self.wfile.write(
                    (json.dumps(resp) + "\n").encode("utf-8"))
                self.wfile.flush()
                if isinstance(req, dict) \
                        and req.get("op") == "shutdown":
                    return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._conns: set = set()
            self._conns_lock = threading.Lock()

        def close_connections(self) -> None:
            """Sever every ESTABLISHED connection. ``shutdown()``
            only stops the accept loop — handler threads keep
            serving open sockets, which is exactly wrong for the
            crash() path (a killed process tears its sockets, and
            clients must observe the tear to fail over)."""
            with self._conns_lock:
                conns = list(self._conns)
            for sock in conns:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass

    server = Server((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              daemon=True)
    thread.start()
    return server, server.server_address[1]


# -- router HA: fenced lease + standby takeover ------------------------


class RouterHA:
    """Primary/standby pairing for the fleet router.

    N router processes share the PURE affinity function, the durable
    table manifests, and the generation-fenced directory file; the
    fenced lease file (:class:`RouterLease`) elects the ONE serving
    primary — no consensus protocol. The primary renews the lease on
    ``lease_renew_s``; a standby polls it and, when it goes stale
    past ``lease_ttl_s`` (the primary died, or was fenced out),
    acquires the lease, ADOPTS the replica/table directory, binds the
    ADVERTISED endpoint, and serves. Clients ride the same
    reconnect+resend contract as replica failover: idempotent ops
    resend through their bounded backoff; the duplicate-request fence
    answers a resent id idempotently on whichever router serves it.
    """

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0, owner: Optional[str] = None):
        self.router = router
        self.host = host
        self.port = port
        cfg = router.config
        self.owner = (owner or cfg.router_id
                      or f"router-{os.getpid()}-"
                         f"{os.urandom(2).hex()}")
        cfg.router_id = self.owner
        coord = router._coord_dir
        if coord is None:
            raise FleetError(
                "router HA needs a coord_dir (or persist_dir) for "
                "the lease + directory files")
        os.makedirs(coord, exist_ok=True)
        self.lease = RouterLease(
            os.path.join(coord, ROUTER_LEASE_FILENAME),
            self.owner, ttl_s=cfg.lease_ttl_s)
        self.server = None
        self.bound_port: Optional[int] = None
        self.took_over = threading.Event()
        self._stop = threading.Event()
        self._threads: list = []

    # -- primary ------------------------------------------------------

    def start_primary(self, spawn: bool = True) -> int:
        """Acquire the lease, spawn (or keep) the replica set, bind,
        advertise the serving addr in the lease, start renewing.
        Returns the bound port."""
        if not self.lease.acquire():
            raise FleetError(
                f"router {self.owner!r} could not acquire the lease "
                f"at {self.lease.path} (a live primary holds it)")
        self.router._lease = self.lease
        self.router.role = "primary"
        if spawn:
            self.router.start()
        self.server, self.bound_port = start_router_daemon(
            self.router, self.host, self.port)
        self.lease._write(self.lease.epoch,
                          addr=[self.host, self.bound_port])
        self.router._save_directory()
        self._start_renewer()
        telemetry.event("router_primary", owner=self.owner,
                        port=self.bound_port,
                        epoch=self.lease.epoch)
        return self.bound_port

    def _start_renewer(self):
        t = threading.Thread(target=self._renew_loop, daemon=True,
                             name=f"router-lease-{self.owner}")
        self._threads.append(t)
        t.start()

    def _renew_loop(self):
        while not self._stop.wait(self.router.config.lease_renew_s):
            if not self.lease.renew():
                # Fenced out: a higher epoch landed (another router
                # took over while this one stalled). Serving on
                # would split-brain the directory — stand down.
                self.router.role = "fenced"
                telemetry.event("router_fenced", owner=self.owner,
                                epoch=self.lease.epoch)
                self.router.shutdown_requested.set()
                return

    # -- standby ------------------------------------------------------

    def start_standby(self) -> None:
        """Watch the lease; take over when it goes stale."""
        self.router.role = "standby"
        t = threading.Thread(target=self._standby_loop, daemon=True,
                             name=f"router-standby-{self.owner}")
        self._threads.append(t)
        t.start()
        telemetry.event("router_standby", owner=self.owner)

    def _standby_loop(self):
        while not self._stop.wait(self.router.config.lease_renew_s):
            doc = self.lease.read()
            if doc is not None and not self.lease.stale(doc):
                continue
            addr = (doc or {}).get("addr")
            if not self.lease.acquire(addr=addr):
                continue  # lost the race to another standby
            try:
                self._take_over(addr)
            except Exception as exc:  # noqa: BLE001 - takeover edge
                telemetry.event(
                    "router_takeover_failed", owner=self.owner,
                    error=f"{type(exc).__name__}: {exc}")
            return

    def _take_over(self, addr):
        from distributed_join_tpu_torch.parallel.faults import (
            retry_with_backoff,
        )

        r = self.router
        r._lease = self.lease
        r.adopt_from_directory()
        r.role = "primary"
        with r._lock:
            r.takeovers_total += 1
        host = addr[0] if addr else self.host
        port = int(addr[1]) if addr else self.port

        def bind():
            return start_router_daemon(r, host, port)

        # The dead primary's socket may linger a beat — retry the
        # bind under the same bounded backoff clients use.
        (self.server, self.bound_port), _ = retry_with_backoff(
            bind, max_attempts=20, backoff_s=0.1,
            retry_on=(OSError,))
        self.lease._write(self.lease.epoch,
                          addr=[host, self.bound_port])
        r._save_directory()
        self._start_renewer()
        self.took_over.set()
        telemetry.event("router_takeover", owner=self.owner,
                        port=self.bound_port,
                        epoch=self.lease.epoch)

    # -- lifecycle ----------------------------------------------------

    def crash(self) -> None:
        """Die like a killed process (test/smoke/chaos helper): stop
        renewing, close the listening socket, stop the prober —
        WITHOUT draining, reaping, or releasing anything. The lease
        goes stale on its own; the replicas belong to the fleet, not
        to this router incarnation."""
        self._stop.set()
        self.router._stop.set()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            # A killed process tears its ESTABLISHED sockets too —
            # without this, in-process handler threads would keep
            # serving connected clients from beyond the grave (and
            # those clients would never fail over).
            self.server.close_connections()
            self.server = None
        telemetry.event("router_crashed", owner=self.owner)

    def stop(self, drain: bool = True) -> None:
        """Graceful teardown: release the lease (instant standby
        handoff), close the wire, stop the router."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None
        if self.router.role == "primary":
            self.lease.release()
        self.router.stop(drain=drain)


# -- the CI smoke ------------------------------------------------------


def _valid_keys(table, key: str = "key"):
    return table.columns[key][table.valid].cpu().numpy()


def _oracle_matches(build, probe, key: str = "key") -> int:
    """The numpy oracle's inner-join match count of two tables
    (``utils.tpch_host.inner_match`` over their valid keys)."""
    from distributed_join_tpu_torch.utils.tpch_host import inner_match

    _, _, cnt = inner_match(_valid_keys(build, key), _valid_keys(probe, key))
    return int(cnt.sum())


def wire_oracle_matches(spec: dict, device) -> int:
    """The oracle's match count of a wire ``join`` spec, over the
    tables the replicas draw for it on ``device``."""
    from distributed_join_tpu_torch.service.server import _tables_from_spec

    return _oracle_matches(*_tables_from_spec(spec, device))


def resident_oracle_matches(reg: dict, deltas, probe_spec: dict,
                            device) -> int:
    """The oracle's match count of a probe-only wire join against a
    table registered by ``reg`` and appended by ``deltas``: the probe
    is drawn as the holder draws it (from the generator's state after
    the registration's build at the registration seed)."""
    import numpy as np

    from distributed_join_tpu_torch.service.server import (
        _build_from_spec,
        _probe_from_spec,
    )
    from distributed_join_tpu_torch.utils.tpch_host import inner_match

    base, state = _build_from_spec(reg, device)

    class _Handle:
        wire_spec = {k: reg[k] for k in
                     ("rows", "seed", "rand_max", "unique_keys")
                     if reg.get(k) is not None}
        wire_build_keys = base.columns["key"]
        wire_probe_state = state

    probe = _probe_from_spec(probe_spec, _Handle, device)
    keys = np.concatenate([_valid_keys(base)] + [
        _valid_keys(_build_from_spec(d, device)[0]) for d in deltas])
    _, _, cnt = inner_match(keys, _valid_keys(probe))
    return int(cnt.sum())


def _gate_counters(record: dict, name: str, args) -> None:
    """Gate ``record``'s counter signature against
    ``<--smoke-baseline-dir>/<name>.json`` (``server._baseline_gate``:
    skipped where the baseline was drawn at another rank count or
    device type); the verdict lands in ``record["baseline_gate"]`` and
    a drift is a violation."""
    from distributed_join_tpu_torch.service.server import (
        SMOKE_BASELINE_DIR,
        _baseline_gate,
    )

    verdict = _baseline_gate(
        name, record["counter_signature"], record["platform"],
        getattr(args, "smoke_baseline_dir", None) or SMOKE_BASELINE_DIR)
    record["baseline_gate"] = verdict
    if verdict.get("ok") is False:
        record["violations"].append(
            f"baseline gate {name}: drifted {verdict['drifted']}, "
            f"missing {verdict['missing']}")


def run_fleet_smoke(args) -> dict:
    """The fleet's acceptance protocol (docs/FLEET.md), end to end
    through real subprocess replicas and the router TCP loop:

    1. 2 replicas share one persist dir; a cold query Q builds on
       its affine replica, the warm repeat must land on the SAME
       replica with zero new traces;
    2. ONE SCRIPTED KILL (SIGKILL) of that replica; the immediate
       repeat of Q must fail over to the sibling within the bounded
       retry budget and answer with the SAME match count (graded
       against the numpy oracle);
    3. the killed replica must be drained and a replacement spawned
       (healthy at generation 1) — observed, with the drain stamped
       within one probe interval of the kill;
    4. the post-replacement repeat of Q must dispatch on the
       replacement with ZERO new traces (the shared persist dir is
       the distribution tier: the program is bound from the entry its
       predecessor wrote; on the port this proves the entry loaded,
       not that the replacement is warm, see the module docstring);
    5. a concurrent burst at inflight bound 1 must shed >= 1 request
       with a structured AdmissionError (and never queue unboundedly);
    6. fleet Prometheus gauges and the flight/history stamps are
       emitted for ``analyze check``.
    7. the same first request on a replica started from an empty
       persist dir, timed beside the replacement's: what the disk tier
       saves a replacement (the port's addition).

    Returns the JSON record (kind ``fleet_smoke``) whose deterministic
    counter signature ``--smoke`` gates against
    ``results/baselines_torch/fleet_smoke.json``.
    """
    import tempfile

    violations: list = []
    workdir_owned = args.persist_dir is None
    workdir = args.persist_dir or tempfile.mkdtemp(
        prefix="djtpu_fleet_smoke_")
    cfg = FleetConfig(
        n_replicas=2,
        replica_ranks=args.replica_ranks,
        persist_dir=os.path.join(workdir, "programs"),
        history_dir=(args.history_dir
                     or os.path.join(workdir, "history")),
        # The failover gate (failovers_total >= 1) needs the REQUEST
        # path to discover the scripted kill: a sub-second prober
        # could drain the victim first and serve the repeat on
        # attempt 1, tripping the gate spuriously. Drain latency is
        # gated from the kill either way (the strike path drains in
        # milliseconds).
        probe_interval_s=max(args.probe_interval_s, 5.0),
        retry_budget=2,
        max_inflight_per_replica=args.max_inflight,
        flight_recorder_path=args.flight_recorder_path,
        spawn_timeout_s=args.spawn_timeout_s,
    )
    platform = _platform(args.device)
    router = FleetRouter(
        process_fleet_factory(cfg, device=args.device),
        cfg)
    router.start()
    server, port = start_router_daemon(router)
    client = ServiceClient("127.0.0.1", port, retries=2)

    q = {"op": "join", "build_nrows": 2048, "probe_nrows": 2048,
         "seed": 17, "selectivity": 0.4, "rand_max": 1024,
         "out_capacity_factor": 3.0}

    def oracle_matches():
        return wire_oracle_matches(q, replica_device(args.device, 0))

    try:
        expected = oracle_matches()
        cold = client.send(q)
        if not cold.get("ok"):
            raise RuntimeError(f"cold query failed: {cold}")
        warm = client.send(q)
        if not warm.get("ok"):
            raise RuntimeError(f"warm query failed: {warm}")
        if warm["fleet"]["replica"] != cold["fleet"]["replica"]:
            violations.append(
                "affinity broke: warm repeat routed to replica "
                f"{warm['fleet']['replica']}, cold ran on "
                f"{cold['fleet']['replica']}")
        if warm["new_traces"] != 0:
            violations.append(
                f"warm repeat traced {warm['new_traces']} new "
                "program(s)")
        for name, resp in (("cold", cold), ("warm", warm)):
            if resp["matches"] != expected:
                violations.append(
                    f"{name} matches {resp['matches']} != numpy "
                    f"oracle {expected}")

        # THE scripted kill: SIGKILL the affine replica mid-traffic.
        victim = router.replicas[cold["fleet"]["replica"]]
        victim_index = victim.index
        t_kill = time.monotonic()
        victim.backend.kill()
        failover = client.send(q)
        if not failover.get("ok"):
            violations.append(
                f"failover repeat was not served: {failover}")
        else:
            if failover["matches"] != expected:
                violations.append(
                    f"failover matches {failover['matches']} != "
                    f"oracle {expected}")
            if failover["fleet"]["replica"] == victim_index:
                violations.append(
                    "failover answered from the killed replica")
            if failover["fleet"]["attempts"] > cfg.retry_budget + 1:
                violations.append(
                    f"failover took {failover['fleet']['attempts']} "
                    f"attempts > budget {cfg.retry_budget + 1}")

        # Drain observed within one probe interval (+ scheduling
        # slack), replacement healthy at generation 1.
        replaced = router.wait_replaced(victim_index,
                                        timeout_s=cfg.spawn_timeout_s)
        replaced_after_s = time.monotonic() - t_kill
        if not replaced:
            violations.append(
                f"killed replica {victim_index} was not replaced "
                f"within {cfg.spawn_timeout_s}s")
        drained_after_s = ((victim.drained_at or time.monotonic())
                           - t_kill)
        if victim.drained_at is None or drained_after_s > \
                3 * cfg.probe_interval_s + 5.0:
            violations.append(
                f"kill -> drained took {drained_after_s:.2f}s "
                f"(> probe interval {cfg.probe_interval_s}s + slack)")

        # Post-replacement repeat: the replacement must serve the
        # pre-fault signature WARM (zero traces via the shared
        # persist dir). Route directly at the replacement to pin the
        # assertion on it — only when a replacement is actually up
        # (dialing the SIGKILLed backend's old port would crash the
        # harness instead of reporting the violation above).
        replay: dict = {}
        replay_ms = kill_to_serving_s = None
        if replaced:
            try:
                direct = ServiceClient(
                    *router.replicas[victim_index].addr(),
                    timeout_s=120.0)
                try:
                    t_replay = time.perf_counter()
                    replay = direct.send(
                        {**q, "request_id": "smoke-replay"})
                    replay_ms = (time.perf_counter() - t_replay) * 1e3
                    kill_to_serving_s = time.monotonic() - t_kill
                finally:
                    direct.close()
            except (OSError, ValueError) as exc:
                violations.append(
                    "replacement replica unreachable for the "
                    f"replay: {type(exc).__name__}: {exc}")
            if replay and not replay.get("ok"):
                violations.append(
                    f"replacement replica refused the replay: "
                    f"{replay}")
            elif replay:
                if replay["matches"] != expected:
                    violations.append(
                        f"replacement matches {replay['matches']} "
                        f"!= oracle {expected}")
                if replay["new_traces"] != 0:
                    violations.append(
                        "replacement built the program: "
                        f"{replay['new_traces']} new trace(s) — the "
                        "shared persist dir must hand it the "
                        "program's entry")

        # The same first request on a replica started from a FRESH
        # persist dir (no entry to bind): what the disk tier saves a
        # replacement.
        cold_replica = _first_request_without_tier(
            cfg, args, q, victim_index, workdir, expected, violations)

        # Synthetic overload: a concurrent burst at inflight bound 1
        # must shed with structured errors, never queue unboundedly.
        router.config.max_inflight_per_replica = 1
        burst_n = 8
        results = [None] * burst_n

        def fire(i):
            c = ServiceClient("127.0.0.1", port)
            try:
                results[i] = c.send(
                    {**q, "request_id": f"burst-{i}"})
            finally:
                c.close()

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(burst_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        shed = [r for r in results
                if r is not None and r.get("shed")]
        served = [r for r in results
                  if r is not None and r.get("ok")]
        if not shed:
            violations.append(
                f"burst of {burst_n} at inflight bound 1 shed "
                "nothing — admission is queueing unboundedly")
        for r in served:
            if r["matches"] != expected:
                violations.append(
                    f"burst answer {r['matches']} != oracle "
                    f"{expected}")
        if len(shed) + len(served) != burst_n:
            violations.append(
                f"burst lost requests: {len(served)} served + "
                f"{len(shed)} shed != {burst_n}")
        router.config.max_inflight_per_replica = args.max_inflight

        replica_memory = _replica_memory(router)
        prom = router.prometheus_metrics()
        for gauge in ("djtpu_fleet_replicas", "djtpu_fleet_healthy",
                      "djtpu_fleet_drained",
                      "djtpu_fleet_failovers_total",
                      "djtpu_fleet_shed_total"):
            if gauge not in prom:
                violations.append(
                    f"prometheus exposition missing {gauge}")

        stats = router.stats()
        if stats["replaced_total"] < 1:
            violations.append("no replacement counted")
        if stats["failovers_total"] < 1:
            violations.append("no failover counted")
        if stats["healthy"] != 2:
            violations.append(
                f"fleet did not return to 2 healthy replicas: "
                f"{stats}")
    finally:
        client.close()
        server.shutdown()
        server.server_close()
        router.stop()

    record = {
        "kind": "fleet_smoke",
        "benchmark": "fleet_smoke",
        "n_ranks": cfg.replica_ranks,
        "replicas": cfg.n_replicas,
        "matches_expected": expected,
        "killed_replica": victim_index,
        "platform": platform,
        "drained_after_s": round(drained_after_s, 3),
        "replaced_after_s": replaced_after_s,
        "kill_to_serving_s": kill_to_serving_s,
        "replacement_first_request_ms": replay_ms,
        "replacement_first_request_server_s": replay.get("elapsed_s"),
        "replacement_cache": replay.get("cache"),
        "cold_replica": cold_replica,
        "replica_memory": replica_memory,
        "failover_attempts": (failover.get("fleet", {})
                              .get("attempts")),
        "burst_served": len(served),
        "burst_shed": len(shed),
        "stats": stats,
        "history_path": (router.history.path
                         if router.history is not None else None),
        "violations": violations,
        # The deterministic gate body (integer counters only; shed/
        # failover TIMINGS and counts beyond the gates above are
        # load-dependent and stay outside the signature).
        "counter_signature": {
            "signature_version": 1,
            "n_ranks": cfg.replica_ranks,
            "counters": {
                "replicas": cfg.n_replicas,
                "matches_cold": cold["matches"],
                "matches_warm": warm["matches"],
                "matches_failover": failover.get("matches", -1),
                "matches_replacement": replay.get("matches", -1),
                "warm_new_traces": warm["new_traces"],
                "replacement_new_traces": replay.get("new_traces",
                                                     -1),
                "requests_lost": burst_n - len(served) - len(shed),
            },
        },
    }
    _gate_counters(record, "fleet_smoke", args)
    if violations:
        # Keep the workdir (program entries, history, flight dumps) —
        # it IS the postmortem of a failed smoke.
        record["workdir"] = workdir
        raise FleetSmokeError(
            "fleet smoke violations: " + "; ".join(violations),
            record)
    if workdir_owned:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return record


def _replica_memory(router) -> dict:
    """Each live replica's ``device_memory`` from its own ``stats`` (its
    process's allocated and peak bytes on a card; None on the CPU)."""
    out = {}
    for rep in list(router.replicas):
        if rep.state not in ("healthy", "suspect"):
            continue
        try:
            client = ServiceClient(*rep.addr(),
                                   timeout_s=router.config.probe_timeout_s)
            try:
                out[rep.index] = client.send(
                    {"op": "stats"}).get("device_memory")
            finally:
                client.close()
        except (OSError, ValueError):
            out[rep.index] = None
    return out


def _platform(device) -> str:
    """The device type the replicas draw their tables on (the
    baselines' ``platform``)."""
    return "cpu" if str(replica_device(device, 0)).startswith("cpu") \
        else "cuda"


def _first_request_without_tier(cfg, args, q, index, workdir, expected,
                                violations) -> dict:
    """Start one more replica on slot ``index``'s device with an empty
    persist dir of its own, time its first request of ``q`` (it builds
    the program: no entry to bind), and stop it."""
    fresh = os.path.join(workdir, "programs_fresh")
    backend = process_fleet_factory(
        dataclasses.replace(cfg, persist_dir=fresh),
        device=args.device)(index, 1)
    try:
        direct = ServiceClient(backend.host, backend.port,
                               timeout_s=120.0)
        try:
            t0 = time.perf_counter()
            resp = direct.send({**q, "request_id": "smoke-cold-replica"})
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            direct.close()
    finally:
        backend.stop()
    if not resp.get("ok") or resp.get("matches") != expected:
        violations.append(f"the fresh-dir replica's first request: {resp}")
    elif not resp.get("new_traces"):
        violations.append("the fresh-dir replica built no program")
    return {"first_request_ms": ms,
            "first_request_server_s": resp.get("elapsed_s"),
            "new_traces": resp.get("new_traces"),
            "cache": resp.get("cache")}


class FleetSmokeError(RuntimeError):
    def __init__(self, msg, record):
        super().__init__(msg)
        self.record = record


def run_tenant_smoke(args) -> dict:
    """The fleet's multi-tenancy + autoscaling acceptance
    protocol (docs/FLEET.md "Multi-tenancy & autoscaling"), end to
    end through real subprocess replicas and the router TCP loop:

    1. two configured tenants — ``gold`` (priority 2, no quota) and
       ``bronze`` (priority 1, 0.5 QPS token bucket); gold's cold +
       warm query Q is oracle-graded and must repeat with zero new
       traces, its responses and the replica's own stats carrying
       the tenant stamp;
    2. QUOTA REFUSAL: a back-to-back bronze burst must shed with a
       structured ``QuotaExceededError`` naming the QPS bound (and
       ``shed: true`` + the tenant echoed on the wire);
    3. PRIORITY SHED ORDER: with every replica's inflight pinned at
       bronze's priority share of the bound, a bronze request must
       shed with ``ShedError`` while the SAME-instant gold request
       is served — the low-priority tenant yields first, never the
       quiet one;
    4. AUTOSCALE SPAWN, WARM: the control loop (low QPS bound, short
       sustain) must spawn a third replica whose pre-warm rotation
       gate replayed the hottest retained signature with ZERO new
       traces (``warm_verified``) BEFORE entering rotation;
    5. the per-tenant + autoscale Prometheus series are emitted and
       the ``fleet_autoscale`` record is well-formed.

    Returns the JSON record (kind ``fleet_tenant_smoke``) for
    ``analyze check``.
    """
    import tempfile

    violations: list = []
    workdir_owned = args.persist_dir is None
    workdir = args.persist_dir or tempfile.mkdtemp(
        prefix="djtpu_tenant_smoke_")
    cfg = FleetConfig(
        n_replicas=2,
        replica_ranks=args.replica_ranks,
        persist_dir=os.path.join(workdir, "programs"),
        history_dir=(args.history_dir
                     or os.path.join(workdir, "history")),
        probe_interval_s=0.5,
        retry_budget=2,
        max_inflight_per_replica=2,
        flight_recorder_path=args.flight_recorder_path,
        spawn_timeout_s=args.spawn_timeout_s,
        tenants={
            "gold": {"priority": 2},
            "bronze": {"qps": 0.5, "burst_s": 1.0, "priority": 1},
        },
        autoscale=True,
        autoscale_max_replicas=3,
        autoscale_up_qps=0.01,
        autoscale_interval_s=0.5,
        autoscale_sustain=2,
    )
    router = FleetRouter(
        process_fleet_factory(cfg, device=args.device),
        cfg)
    router.start()
    server, port = start_router_daemon(router)
    client = ServiceClient("127.0.0.1", port, retries=2)

    q = {"op": "join", "build_nrows": 2048, "probe_nrows": 2048,
         "seed": 17, "selectivity": 0.4, "rand_max": 1024,
         "out_capacity_factor": 3.0}

    def oracle_matches():
        return wire_oracle_matches(q, replica_device(args.device, 0))

    bronze_refused = gold_pressure = None
    autoscale = {}
    try:
        expected = oracle_matches()
        cold = client.send({**q, "tenant": "gold"})
        if not cold.get("ok"):
            raise RuntimeError(f"gold cold query failed: {cold}")
        warm = client.send({**q, "tenant": "gold"})
        if not warm.get("ok"):
            raise RuntimeError(f"gold warm query failed: {warm}")
        for name, resp in (("cold", cold), ("warm", warm)):
            if resp["matches"] != expected:
                violations.append(
                    f"gold {name} matches {resp['matches']} != "
                    f"numpy oracle {expected}")
        if warm["new_traces"] != 0:
            violations.append(
                f"gold warm repeat traced {warm['new_traces']} new "
                "program(s)")
        # The tenant stamp rides the wire to the REPLICA: its own
        # stats must account the gold traffic per-tenant.
        serving = router.replicas[cold["fleet"]["replica"]]
        try:
            direct = ServiceClient(*serving.addr(), timeout_s=30.0)
            try:
                rep_stats = direct.send(
                    tracectx.attach({"op": "stats"},
                                    tracectx.mint()))
            finally:
                direct.close()
        except (OSError, ValueError) as exc:
            rep_stats = {}
            violations.append(
                "serving replica unreachable for the tenant-stamp "
                f"check: {type(exc).__name__}: {exc}")
        if "gold" not in (rep_stats.get("tenants") or {}):
            violations.append(
                "replica stats carry no 'gold' tenant slot — the "
                "tenant field did not ride the wire to the replica")

        # Quota refusal: bronze's 0.5 QPS bucket holds ONE token —
        # back-to-back sends must shed with the bound named.
        bronze_results = []
        for i in range(6):
            bronze_results.append(client.send(
                {**q, "tenant": "bronze",
                 "request_id": f"bronze-burst-{i}"}))
        bronze_refused = [
            r for r in bronze_results
            if r.get("error") == "QuotaExceededError"]
        if not bronze_refused:
            violations.append(
                "bronze burst of 6 over a 0.5 QPS quota was never "
                "quota-refused")
        for r in bronze_refused:
            if not r.get("shed") or r.get("tenant") != "bronze":
                violations.append(
                    "quota refusal missing shed/tenant stamps: "
                    f"{r}")
            if "QPS quota" not in str(r.get("message")):
                violations.append(
                    "quota refusal does not name the QPS bound: "
                    f"{r.get('message')}")
        leaked = [r for r in bronze_results
                  if not r.get("ok")
                  and r.get("error") not in ("QuotaExceededError",
                                             "ShedError")]
        if leaked:
            violations.append(
                f"bronze burst leaked unstructured errors: "
                f"{leaked[:2]}")

        # Autoscale spawn: the sustained (tiny) QPS bound must spawn
        # replica 2, pre-warm verified with zero new traces BEFORE
        # rotation. Waiting for it FIRST also settles the fleet at
        # autoscale_max_replicas so the priority-shed gate below
        # pins a stable replica set.
        deadline = time.monotonic() + cfg.spawn_timeout_s
        while time.monotonic() < deadline:
            with router._lock:
                if router.autoscale_spawns_total >= 1:
                    break
            # Keep the probed qps_60s above the bound while waiting.
            client.send({**q, "tenant": "gold",
                         "request_id":
                             f"keepwarm-{int(time.monotonic())}"})
            time.sleep(0.5)
        autoscale = router.autoscale_record()
        spawns = [e for e in autoscale["events"]
                  if e["action"] == "spawn"]
        if not spawns:
            violations.append(
                "autoscaler never spawned under sustained load "
                f"(events: {autoscale['events']})")
        else:
            ev = spawns[0]
            if not ev.get("warm_verified"):
                violations.append(
                    f"autoscale spawn was not warm-verified: {ev}")
            if ev.get("new_traces") != 0:
                violations.append(
                    "autoscale pre-warm replay traced "
                    f"{ev.get('new_traces')} new program(s)")
            with router._lock:
                scaled = [r for r in router.replicas
                          if r.index == ev["replica"]
                          and r.state in ("healthy", "suspect")]
            if not scaled:
                violations.append(
                    f"spawned replica {ev['replica']} is not in "
                    "rotation")

        # Priority shed order: pin every replica's inflight at
        # bronze's share (priority 1 of max 2 -> bound 1 of 2). The
        # SAME pressure must shed bronze with ShedError and still
        # serve gold.
        time.sleep(2.5)  # refill bronze's bucket past one token
        with router._lock:
            pinned = [r for r in router.replicas
                      if r.state in ("healthy", "suspect")]
            for r in pinned:
                r.inflight += 1
        try:
            bronze_pressure = client.send(
                {**q, "tenant": "bronze",
                 "request_id": "bronze-pressure"})
            gold_pressure = client.send(
                {**q, "tenant": "gold",
                 "request_id": "gold-pressure"})
        finally:
            with router._lock:
                for r in pinned:
                    r.inflight = max(r.inflight - 1, 0)
        if bronze_pressure.get("error") != "ShedError":
            violations.append(
                "bronze under pressure was not priority-shed "
                f"(ShedError): {bronze_pressure}")
        elif "priority" not in str(
                bronze_pressure.get("message")):
            violations.append(
                "priority shed does not name the priority bound: "
                f"{bronze_pressure.get('message')}")
        if not gold_pressure.get("ok") \
                or gold_pressure.get("matches") != expected:
            violations.append(
                "gold under the SAME pressure was not served "
                f"exactly: {gold_pressure}")

        prom = router.prometheus_metrics()
        for series in ("djtpu_tenant_requests_total",
                       "djtpu_tenant_shed_total",
                       "djtpu_tenant_inflight",
                       "djtpu_tenant_priority",
                       "djtpu_autoscale_enabled",
                       "djtpu_autoscale_spawns_total",
                       "djtpu_autoscale_drains_total"):
            if series not in prom:
                violations.append(
                    f"prometheus exposition missing {series}")
        stats = router.stats()
        for name in ("gold", "bronze"):
            if name not in (stats.get("tenants") or {}):
                violations.append(
                    f"router stats missing tenant {name!r}")
        if (stats["tenants"].get("gold") or {}).get("shed"):
            violations.append(
                "gold (the quiet tenant) was shed "
                f"{stats['tenants']['gold']['shed']} time(s)")
    finally:
        client.close()
        server.shutdown()
        server.server_close()
        router.stop()

    record = {
        "kind": "fleet_tenant_smoke",
        "benchmark": "fleet_tenant_smoke",
        "n_ranks": cfg.replica_ranks,
        "replicas": cfg.n_replicas,
        "matches_expected": expected,
        "tenants": stats.get("tenants"),
        "autoscale": {
            "enabled": autoscale.get("enabled"),
            "spawns_total": autoscale.get("spawns_total"),
            "drains_total": autoscale.get("drains_total"),
            "events": autoscale.get("events"),
        },
        "stats": stats,
        "history_path": (router.history.path
                         if router.history is not None else None),
        "violations": violations,
        # Deterministic gate body: indicator counters only (shed
        # COUNTS are timing-dependent and stay outside).
        "counter_signature": {
            "signature_version": 1,
            "n_ranks": cfg.replica_ranks,
            "counters": {
                "replicas": cfg.n_replicas,
                "matches_gold_cold": cold["matches"],
                "matches_gold_warm": warm["matches"],
                "gold_warm_new_traces": warm["new_traces"],
                "bronze_quota_refused":
                    int(bool(bronze_refused)),
                "bronze_priority_shed": int(
                    bronze_pressure.get("error") == "ShedError"),
                "gold_served_under_pressure": int(
                    bool(gold_pressure
                         and gold_pressure.get("ok"))),
                "autoscale_spawned": int(bool(spawns)),
                "autoscale_warm_verified": int(
                    bool(spawns
                         and spawns[0].get("warm_verified"))),
            },
        },
    }
    if violations:
        record["workdir"] = workdir
        raise FleetSmokeError(
            "tenant smoke violations: " + "; ".join(violations),
            record)
    if workdir_owned:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return record


def run_tracing_smoke(args) -> dict:
    """The distributed-tracing acceptance protocol
    (docs/OBSERVABILITY.md "Distributed tracing"): ONE causal
    timeline across the router and real subprocess replicas, through
    one scripted SIGKILL.

    1. 2 subprocess replicas, each writing its OWN telemetry session
       dir; the router (and the harness client) run an in-process
       session beside them — three per-process JSONL streams;
    2. a cold join Q and its warm repeat flow end to end (client mint
       -> router child span -> replica adoption);
    3. ONE SCRIPTED SIGKILL of the affine replica, then the repeat of
       Q under a harness-minted trace context: the router's FAILED
       attempt and the winning failover retry must share that ONE
       trace_id — in the flight ring (per-attempt records) and in the
       merged timeline (``trace_ids_for_request``);
    4. the per-process session dirs assemble into ONE Perfetto
       timeline (``telemetry/timeline.py``) whose focus trace spans
       both surviving processes with >= 1 cross-process hop and a
       non-empty critical path; both artifacts must pass
       ``analyze check``;
    5. the record (kind ``tracing_smoke``) carries the deterministic
       counter signature (the JAX package's
       ``results/baselines/tracing_smoke.json`` is drawn from its own tables).
    """
    import tempfile

    from distributed_join_tpu_torch.telemetry import timeline
    from distributed_join_tpu_torch.telemetry.analyze import check_file

    violations: list = []
    workdir_owned = args.persist_dir is None
    workdir = args.persist_dir or tempfile.mkdtemp(
        prefix="djtpu_tracing_smoke_")
    tel_root = os.path.join(workdir, "telemetry")
    router_dir = os.path.join(tel_root, "router")
    rep_dirs = {i: os.path.join(tel_root, f"replica{i}")
                for i in range(2)}
    cfg = FleetConfig(
        n_replicas=2,
        replica_ranks=args.replica_ranks,
        persist_dir=os.path.join(workdir, "programs"),
        history_dir=(args.history_dir
                     or os.path.join(workdir, "history")),
        # Same rationale as run_fleet_smoke: the REQUEST path (not
        # the prober) must discover the scripted kill, so the failed
        # attempt actually happens and lands on the trace.
        probe_interval_s=max(args.probe_interval_s, 5.0),
        retry_budget=2,
        max_inflight_per_replica=args.max_inflight,
        spawn_timeout_s=args.spawn_timeout_s,
    )
    # DISTINCT per-slot session dirs (generation 0 only — a
    # replacement must never append into its predecessor's stream).
    overrides = {i: {"extra_args": ["--telemetry", rep_dirs[i]]}
                 for i in rep_dirs}
    router = FleetRouter(
        process_fleet_factory(cfg, device=args.device,
                              replica_overrides=overrides),
        cfg)
    sink = telemetry.configure(router_dir, rank=0)
    router.start()
    server, port = start_router_daemon(router)
    client = ServiceClient("127.0.0.1", port, retries=2)

    q = {"op": "join", "build_nrows": 2048, "probe_nrows": 2048,
         "seed": 17, "selectivity": 0.4, "rand_max": 1024,
         "out_capacity_factor": 3.0}
    rid = "tracing-failover"
    root = tracectx.mint()
    root_tid = root["trace_id"]

    try:
        cold = client.send(q)
        if not cold.get("ok"):
            raise RuntimeError(f"cold query failed: {cold}")
        warm = client.send(q)
        if not warm.get("ok"):
            raise RuntimeError(f"warm query failed: {warm}")
        # The response must echo the trace the client minted — the
        # wire-propagation contract, asserted before any fault.
        for name, resp in (("cold", cold), ("warm", warm)):
            if not (resp.get(tracectx.TRACE_FIELD) or {}) \
                    .get("trace_id"):
                violations.append(
                    f"{name} response carries no trace context")

        # THE scripted kill, then the repeat under a KNOWN root
        # trace: the failed attempt and the failover retry must both
        # be children of it.
        victim = router.replicas[cold["fleet"]["replica"]]
        victim_index = victim.index
        victim.backend.kill()
        failover = client.send(
            tracectx.attach({**q, "request_id": rid}, root))
        if not failover.get("ok"):
            violations.append(
                f"failover repeat was not served: {failover}")
        else:
            if failover["fleet"]["replica"] == victim_index:
                violations.append(
                    "failover answered from the killed replica")
            if failover["matches"] != cold["matches"]:
                violations.append(
                    f"failover matches {failover['matches']} != "
                    f"cold {cold['matches']}")
            if (failover.get(tracectx.TRACE_FIELD) or {}) \
                    .get("trace_id") != root_tid:
                violations.append(
                    "failover response does not echo the "
                    "harness-minted trace id")

        # Flight-ring continuity: every per-attempt record for rid —
        # the failed dispatch included — must resolve to the ONE
        # root trace id.
        ring = [r for r in router.recorder.snapshot()["records"]
                if r.get("request_id") == rid]
        failed = [r for r in ring
                  if r.get("outcome") == "attempt_failed"]
        ring_tids = {(r.get("trace") or {}).get("trace_id")
                     for r in ring}
        if not failed:
            violations.append(
                "no attempt_failed flight record for the killed "
                "dispatch — the failed attempt left no trace")
        if ring_tids != {root_tid}:
            violations.append(
                f"flight records for {rid!r} carry trace ids "
                f"{sorted(map(str, ring_tids))} != the one root "
                f"{root_tid}")
    finally:
        client.close()
        server.shutdown()
        server.server_close()
        router.stop()
        if telemetry.sink() is sink:
            telemetry.finalize()

    # -- assemble the fleet timeline from the per-process streams ----
    tl_record: dict = {}
    n_timeline_procs = 0
    focus_procs: list = []
    check_problems: list = []
    tids: set = set()
    try:
        asm = timeline.assemble(
            [router_dir] + [rep_dirs[i] for i in sorted(rep_dirs)],
            trace_id=root_tid)
        n_timeline_procs = len(asm["procs"])
        tids = timeline.trace_ids_for_request(asm, rid)
        if tids != {root_tid}:
            violations.append(
                f"timeline records for {rid!r} resolve to trace ids "
                f"{sorted(map(str, tids))} != the one root")
        agg = asm["traces"].get(root_tid)
        focus_procs = sorted(agg["procs"]) if agg else []
        if len(focus_procs) < 2:
            violations.append(
                "the failover trace does not span 2 processes "
                f"(saw {focus_procs}) — no cross-process causal "
                "chain")
        if not asm["hops"]:
            violations.append(
                "no cross-process hop detected in the merged "
                "timeline")
        if not asm["critical_path"]:
            violations.append("empty cross-process critical path")

        trace_path = os.path.join(tel_root,
                                  "fleet_timeline.trace.json")
        timeline.write_perfetto(asm, trace_path)
        tl_record = timeline.as_record(asm, trace_file=trace_path)
        tl_path = os.path.join(tel_root, "fleet_timeline.json")
        with open(tl_path, "w") as f:
            json.dump(tl_record, f, indent=1, sort_keys=True)
            f.write("\n")
        for p in (tl_path, trace_path):
            probs = check_file(p)
            if probs:
                check_problems.extend(
                    f"{os.path.basename(p)}: {x}" for x in probs)
        if check_problems:
            violations.append(
                "analyze check rejected the timeline artifacts: "
                + "; ".join(check_problems))
    except (OSError, ValueError) as exc:
        violations.append(
            f"timeline assembly failed: {type(exc).__name__}: {exc}")

    record = {
        "kind": "tracing_smoke",
        "benchmark": "tracing_smoke",
        "n_ranks": cfg.replica_ranks,
        "replicas": cfg.n_replicas,
        "killed_replica": victim_index,
        "root_trace_id": root_tid,
        "failover_attempts": (failover.get("fleet", {})
                              .get("attempts")),
        "attempt_failed_records": len(failed),
        "timeline_processes": n_timeline_procs,
        "focus_trace_processes": focus_procs,
        "timeline": {k: tl_record.get(k)
                     for k in ("n_spans", "n_events", "n_traces",
                               "hops", "skew_bound_us")},
        "violations": violations,
        # Integer gates only: counts that depend on load/timing
        # (span totals, hop totals, skew) stay outside the signature.
        "counter_signature": {
            "signature_version": 1,
            "n_ranks": cfg.replica_ranks,
            "counters": {
                "replicas": cfg.n_replicas,
                "matches_cold": cold["matches"],
                "matches_warm": warm["matches"],
                "matches_failover": failover.get("matches", -1),
                "warm_new_traces": warm["new_traces"],
                "failover_trace_ids": len(tids),
                "failed_attempt_on_trace": int(bool(
                    failed and ring_tids == {root_tid})),
                "timeline_processes": n_timeline_procs,
                "focus_trace_processes": len(focus_procs),
            },
        },
    }
    if violations:
        record["workdir"] = workdir
        raise FleetSmokeError(
            "tracing smoke violations: " + "; ".join(violations),
            record)
    if workdir_owned:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return record


def run_fleet_ha_smoke(args) -> dict:
    """The replication and HA acceptance protocol (docs/FLEET.md
    "Replication & HA"), end to end through subprocess replicas, the
    durable coord dir, and TWO router incarnations:

    1. K=2 registration: both replicas hold the table (directory +
       versioned manifest on disk), one append lands on both holders
       (generation 2 everywhere);
    2. probe-only cold/warm discipline: the warm repeat adds zero
       traces at the correct generation;
    3. ONE SCRIPTED HOLDER KILL (SIGKILL of the table's primary
       holder): the immediate probe-only repeat fails over to the
       surviving holder within the retry budget, oracle-equal;
    4. the replacement REBUILDS its image from the manifest
       (``rebuilding -> serving``), and a direct fenced replay on it
       answers warm — ZERO new traces at generation 2;
    5. ONE SCRIPTED ROUTER KILL: the standby takes the fenced lease,
       adopts the directory, binds the SAME advertised endpoint, and
       the client's reconnect+resend gets the pre-fault signature
       served warm at the correct generation;
    6. a post-takeover append still reaches BOTH holders (generation
       3), and the final probe-only join is oracle-equal over
       register + both deltas.

    Returns the JSON record (kind ``fleet_ha_smoke``) whose
    deterministic counter signature ``--ha-smoke`` gates against
    ``results/baselines_torch/fleet_ha_smoke.json``.
    """
    import tempfile

    violations: list = []
    workdir_owned = args.persist_dir is None
    workdir = args.persist_dir or tempfile.mkdtemp(
        prefix="djtpu_fleet_ha_smoke_")
    cfg = FleetConfig(
        n_replicas=2,
        replica_ranks=args.replica_ranks,
        persist_dir=os.path.join(workdir, "programs"),
        history_dir=(args.history_dir
                     or os.path.join(workdir, "history")),
        coord_dir=os.path.join(workdir, "coord"),
        table_replication=2,
        # Request-path fault discovery, as in run_fleet_smoke: the
        # prober must not drain the victim before the failover
        # attempt counts are graded.
        probe_interval_s=max(args.probe_interval_s, 5.0),
        retry_budget=2,
        max_inflight_per_replica=args.max_inflight,
        spawn_timeout_s=args.spawn_timeout_s,
        lease_ttl_s=2.0,
        lease_renew_s=0.25,
        flight_recorder_path=args.flight_recorder_path,
    )
    factory = process_fleet_factory(cfg, device=args.device)
    router = FleetRouter(factory, cfg)
    ha1 = RouterHA(router, owner="router-a")
    port = ha1.start_primary()
    # retries=8 spans the takeover gap (lease TTL + poll + settle +
    # bind) under the client's jittered exponential backoff.
    client = ServiceClient("127.0.0.1", port, retries=8)

    table = "ha_users"
    reg = {"op": "register", "name": table, "rows": 4096,
           "seed": 23, "rand_max": 8192, "unique_keys": True}
    delta = {"op": "append", "name": table, "rows": 512,
             "seed": 29, "rand_max": 8192}
    delta2 = {"op": "append", "name": table, "rows": 256,
              "seed": 31, "rand_max": 8192}
    q = {"op": "join", "table": table, "probe_nrows": 2048,
         "seed": 23, "selectivity": 0.4, "rand_max": 8192,
         "out_capacity_factor": 3.0}

    def oracle_matches(delta_specs):
        return resident_oracle_matches(
            reg, delta_specs, q, replica_device(args.device, 0))

    standby_router = None
    ha2 = None
    crashed_primary = False
    try:
        # 1. replicated registration + append.
        r = client.send(reg)
        if not r.get("ok"):
            raise RuntimeError(f"register failed: {r}")
        reg_holders = r.get("fleet", {}).get("holders") or []
        reg_gen = int(r.get("generation", -1))
        if len(reg_holders) != 2:
            violations.append(
                f"register landed on {reg_holders}, wanted 2 "
                "holders")
        if reg_gen != 1:
            violations.append(
                f"register generation {reg_gen} != 1")
        a = client.send(delta)
        if not a.get("ok"):
            raise RuntimeError(f"append failed: {a}")
        append_gen = int(a.get("generation", -1))
        append_applied = a.get("fleet", {}).get("applied") or []
        if append_gen != 2:
            violations.append(f"append generation {append_gen} != 2")
        if len(append_applied) != 2:
            violations.append(
                f"append applied on {append_applied}, wanted both "
                "holders")

        # Durable artifacts on disk.
        man = load_table_manifest(cfg.coord_dir, table)
        if man is None:
            violations.append("no table manifest on disk")
        else:
            if man.get("generation") != 2:
                violations.append(
                    f"manifest generation {man.get('generation')} "
                    "!= 2")
            if len(man.get("deltas") or []) != 1:
                violations.append(
                    f"manifest holds {len(man.get('deltas') or [])} "
                    "delta(s), wanted 1")
            if not man.get("payload_digest"):
                violations.append("manifest missing payload_digest")
        dirdoc = load_router_directory(cfg.coord_dir)
        if dirdoc is None:
            violations.append("no router directory on disk")
        elif table not in (dirdoc.get("tables") or {}):
            violations.append(
                f"router directory does not list {table!r}")

        # 2. cold/warm probe-only discipline.
        expected2 = oracle_matches([delta])
        cold = client.send(q)
        if not cold.get("ok"):
            raise RuntimeError(f"cold probe-only join failed: "
                               f"{cold}")
        warm = client.send(q)
        if not warm.get("ok"):
            raise RuntimeError(f"warm probe-only join failed: "
                               f"{warm}")
        for name_, resp_ in (("cold", cold), ("warm", warm)):
            if resp_["matches"] != expected2:
                violations.append(
                    f"{name_} matches {resp_['matches']} != oracle "
                    f"{expected2}")
            gen_ = (resp_.get("resident") or {}).get("generation")
            if gen_ != 2:
                violations.append(
                    f"{name_} served at generation {gen_} != 2")
        if warm["new_traces"] != 0:
            violations.append(
                f"warm probe-only repeat traced "
                f"{warm['new_traces']} new program(s)")

        # 3. THE holder kill: SIGKILL the serving (primary) holder.
        victim_index = cold["fleet"]["replica"]
        router.replicas[victim_index].backend.kill()
        failover = client.send(q)
        if not failover.get("ok"):
            violations.append(
                f"probe-only failover was not served: {failover}")
        else:
            if failover["matches"] != expected2:
                violations.append(
                    f"failover matches {failover['matches']} != "
                    f"oracle {expected2}")
            if failover["fleet"]["replica"] == victim_index:
                violations.append(
                    "failover answered from the killed holder")
            if failover["fleet"]["attempts"] > cfg.retry_budget + 1:
                violations.append(
                    f"failover took "
                    f"{failover['fleet']['attempts']} attempts > "
                    f"budget {cfg.retry_budget + 1}")
            fgen = (failover.get("resident") or {}).get("generation")
            if fgen != 2:
                violations.append(
                    f"failover served at generation {fgen} != 2")

        # 4. replacement rebuild from the manifest -> serving, then
        # a direct FENCED replay answers warm at generation 2.
        if not router.wait_replaced(victim_index,
                                    timeout_s=cfg.spawn_timeout_s):
            violations.append(
                f"killed holder {victim_index} was not replaced "
                f"within {cfg.spawn_timeout_s}s")
        holder_ok = False
        deadline = time.monotonic() + cfg.spawn_timeout_s
        while time.monotonic() < deadline:
            tbl = router.stats()["tables"].get(table) or {}
            h = (tbl.get("holders") or {}).get(str(victim_index))
            if h and h["state"] == "serving" \
                    and h["generation"] == 2:
                holder_ok = True
                break
            time.sleep(0.2)
        if not holder_ok:
            violations.append(
                f"replacement holder {victim_index} never reached "
                "serving at generation 2")
        rebuilds = router.stats()["rebuilds_total"]
        if rebuilds < 1:
            violations.append("no rebuild counted")
        rebuild_s = [r.get("elapsed_s") for r in
                     router.recorder.snapshot()["records"]
                     if r.get("op") == "rebuild"]
        replay: dict = {}
        if holder_ok:
            direct = ServiceClient(
                *router.replicas[victim_index].addr(),
                timeout_s=120.0)
            try:
                replay = direct.send(
                    {**q, "min_generation": 2,
                     "request_id": "ha-smoke-replay"})
            finally:
                direct.close()
            if not replay.get("ok"):
                violations.append(
                    f"rebuilt holder refused the fenced replay: "
                    f"{replay}")
            else:
                if replay["matches"] != expected2:
                    violations.append(
                        f"rebuilt replay matches "
                        f"{replay['matches']} != oracle "
                        f"{expected2}")
                if replay["new_traces"] != 0:
                    violations.append(
                        "rebuilt holder was not warm: "
                        f"{replay['new_traces']} new trace(s) — "
                        "the shared persist dir must hand it the "
                        "probe-only program")
                rgen = (replay.get("resident")
                        or {}).get("generation")
                if rgen != 2:
                    violations.append(
                        f"rebuilt replay served at generation "
                        f"{rgen} != 2")

        # 5. THE router kill: crash the primary, standby takes over
        # the same advertised endpoint, the client resends.
        standby_router = FleetRouter(factory,
                                     dataclasses.replace(cfg))
        ha2 = RouterHA(standby_router, owner="router-b")
        ha2.start_standby()
        t_crash = time.monotonic()
        ha1.crash()
        crashed_primary = True
        if not ha2.took_over.wait(timeout=cfg.lease_ttl_s * 10
                                  + 30.0):
            raise RuntimeError(
                "standby router never took over the lease")
        takeover_s = time.monotonic() - t_crash
        # The resend rides ONE trace across the takeover
        # (docs/OBSERVABILITY.md "Distributed tracing"):
        # ServiceClient.send mints once per LOGICAL send, before its
        # reconnect loop, so every retry against the dead primary and
        # the attempt the standby finally serves carry this context.
        ha_ctx = tracectx.mint()
        after = client.send(tracectx.attach(
            {**q, "request_id": "ha-after-takeover"}, ha_ctx))
        after_tid = (after.get(tracectx.TRACE_FIELD)
                     or {}).get("trace_id")
        if after_tid != ha_ctx["trace_id"]:
            violations.append(
                "post-takeover resend left its original trace: "
                f"response trace {after_tid} != minted "
                f"{ha_ctx['trace_id']}")
        ha_ring = [r for r in
                   standby_router.recorder.snapshot()["records"]
                   if r.get("request_id") == "ha-after-takeover"]
        ha_ring_tids = {(r.get("trace") or {}).get("trace_id")
                        for r in ha_ring}
        if not ha_ring or ha_ring_tids != {ha_ctx["trace_id"]}:
            violations.append(
                "standby flight ring does not tie the takeover "
                f"resend to its trace: ids "
                f"{sorted(map(str, ha_ring_tids))} over "
                f"{len(ha_ring)} record(s), wanted exactly "
                f"{ha_ctx['trace_id']}")
        if not after.get("ok"):
            violations.append(
                f"post-takeover resend was not served: {after}")
        else:
            if after["matches"] != expected2:
                violations.append(
                    f"post-takeover matches {after['matches']} != "
                    f"oracle {expected2}")
            if after["new_traces"] != 0:
                violations.append(
                    "post-takeover repeat traced "
                    f"{after['new_traces']} new program(s)")
            agen = (after.get("resident") or {}).get("generation")
            if agen != 2:
                violations.append(
                    f"post-takeover served at generation {agen} "
                    "!= 2")
        st2 = standby_router.stats()
        if st2["router_role"] != "primary":
            violations.append(
                f"standby role after takeover is "
                f"{st2['router_role']!r}, wanted 'primary'")
        if st2["takeovers_total"] != 1:
            violations.append(
                f"takeovers_total {st2['takeovers_total']} != 1")

        # 6. the new primary still owns the table: append reaches
        # both holders; the final probe-only join is oracle-equal
        # over register + both deltas.
        a2 = client.send(delta2)
        if not a2.get("ok"):
            violations.append(f"post-takeover append failed: {a2}")
        post_gen = int(a2.get("generation", -1))
        post_applied = a2.get("fleet", {}).get("applied") or []
        if post_gen != 3:
            violations.append(
                f"post-takeover append generation {post_gen} != 3")
        if len(post_applied) != 2:
            violations.append(
                f"post-takeover append applied on {post_applied}, "
                "wanted both holders")
        expected3 = oracle_matches([delta, delta2])
        final = client.send(q)
        if not final.get("ok"):
            violations.append(f"final probe-only join failed: "
                              f"{final}")
        else:
            if final["matches"] != expected3:
                violations.append(
                    f"final matches {final['matches']} != oracle "
                    f"{expected3}")
            lgen = (final.get("resident") or {}).get("generation")
            if lgen != 3:
                violations.append(
                    f"final served at generation {lgen} != 3")

        replica_memory = _replica_memory(standby_router)
        prom = standby_router.prometheus_metrics()
        for needle in ("djtpu_fleet_rebuilds_total",
                       "djtpu_router_takeovers_total",
                       "djtpu_router_role",
                       'djtpu_fleet_resident_holders{table="'):
            if needle not in prom:
                violations.append(
                    f"prometheus exposition missing {needle}")
    finally:
        client.close()
        if ha2 is not None:
            try:
                ha2.stop(drain=False)
            except Exception:  # noqa: BLE001 - teardown boundary
                pass
        if not crashed_primary:
            try:
                ha1.crash()
            except Exception:  # noqa: BLE001 - teardown boundary
                pass
        # Reap every subprocess replica from BOTH router
        # incarnations (adopted AttachedReplica endpoints hold no
        # process handle — the originals do).
        seen: set = set()
        for rep_ in (list(router.replicas)
                     + list(getattr(standby_router, "replicas",
                                    None) or [])):
            if id(rep_.backend) in seen:
                continue
            seen.add(id(rep_.backend))
            try:
                rep_.backend.stop()
            except Exception:  # noqa: BLE001 - teardown boundary
                pass

    record = {
        "kind": "fleet_ha_smoke",
        "benchmark": "fleet_ha_smoke",
        "n_ranks": cfg.replica_ranks,
        "replicas": cfg.n_replicas,
        "table_replication": cfg.table_replication,
        "table": table,
        "matches_expected": expected2,
        "matches_expected_final": expected3,
        "killed_holder": victim_index,
        "failover_attempts": (failover.get("fleet", {})
                              .get("attempts")),
        "rebuilds_total": rebuilds,
        "rebuild_s": rebuild_s,
        "takeovers_total": st2["takeovers_total"],
        "takeover_s": takeover_s,
        "replica_memory": replica_memory,
        "platform": _platform(args.device),
        "coord_dir": cfg.coord_dir,
        "violations": violations,
        "counter_signature": {
            "signature_version": 1,
            "n_ranks": cfg.replica_ranks,
            "counters": {
                "replicas": cfg.n_replicas,
                "table_replication": cfg.table_replication,
                "register_holders": len(reg_holders),
                "register_generation": reg_gen,
                "append_generation": append_gen,
                "append_applied": len(append_applied),
                "matches_cold": cold["matches"],
                "matches_warm": warm["matches"],
                "warm_new_traces": warm["new_traces"],
                "matches_failover": failover.get("matches", -1),
                "rebuilds_total": rebuilds,
                "rebuilt_replay_matches": replay.get("matches",
                                                     -1),
                "rebuilt_replay_new_traces": replay.get(
                    "new_traces", -1),
                "takeovers_total": st2["takeovers_total"],
                "matches_after_takeover": after.get("matches",
                                                    -1),
                "takeover_new_traces": after.get("new_traces",
                                                 -1),
                "post_takeover_append_generation": post_gen,
                "post_takeover_append_applied":
                    len(post_applied),
                "matches_final": final.get("matches", -1),
            },
        },
    }
    _gate_counters(record, "fleet_ha_smoke", args)
    if violations:
        record["workdir"] = workdir
        raise FleetSmokeError(
            "fleet HA smoke violations: " + "; ".join(violations),
            record)
    if workdir_owned:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return record


# -- CLI ---------------------------------------------------------------


def parse_args(argv=None):
    from distributed_join_tpu_torch.benchmarks import refuse_flags
    from distributed_join_tpu_torch.service.server import (
        SMOKE_BASELINE_DIR,
    )

    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    refuse_flags(p, argv, {
        "--platform": "platform selection (the JAX package's backend "
                      "choice; the fleet places its replicas by "
                      "--device)",
    })
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="router TCP port (0 = ephemeral; printed on "
                        "the 'listening' line)")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--replica-ranks", type=int, default=2,
                   help="ranks of EACH replica (1: --communicator "
                        "local; k > 1: --communicator emulated "
                        "--n-ranks k on the replica's device)")
    p.add_argument("--device", default=None,
                   help="where the replicas run: default the GPU "
                        "(replica i on cuda:{i mod device_count}); "
                        "'cpu' only for rehearsals and tests")
    p.add_argument("--persist-dir", default=None, metavar="DIR",
                   help="SHARED program-cache dir: the fleet's "
                        "distribution tier (replacements bind their "
                        "predecessors' programs with no new trace)")
    p.add_argument("--history-dir", default=None, metavar="DIR",
                   help="fleet-level per-request history store "
                        "(entries stamped with the serving replica)")
    p.add_argument("--probe-interval-s", type=float, default=1.0)
    p.add_argument("--probe-timeout-s", type=float, default=5.0)
    p.add_argument("--spawn-timeout-s", type=float, default=180.0)
    p.add_argument("--suspect-strikes", type=int, default=2)
    p.add_argument("--retry-budget", type=int, default=2,
                   help="bounded failover attempts per request "
                        "beyond the first")
    p.add_argument("--request-deadline-s", type=float, default=300.0)
    p.add_argument("--max-inflight", type=int, default=4,
                   help="per-replica inflight admission bound "
                        "(beyond it the router sheds with a "
                        "structured AdmissionError)")
    p.add_argument("--shed-p95-s", type=float, default=None)
    p.add_argument("--shed-qps", type=float, default=None)
    p.add_argument("--no-respawn", action="store_true",
                   help="drain faulted replicas but do not replace "
                        "them (debugging)")
    p.add_argument("--replica-arg", action="append", default=[],
                   metavar="ARG",
                   help="extra argv token forwarded to every "
                        "replica (repeatable)")
    p.add_argument("--flight-records", type=int, default=256)
    p.add_argument("--flight-recorder-path", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="run the CI acceptance protocol (2-replica "
                        "fleet, scripted replica kill, "
                        "oracle/drain/replace/shed gates, the "
                        "replacement's first request beside a "
                        "fresh-dir replica's, the counter "
                        "signature against --smoke-baseline-dir) "
                        "instead of serving; JSON record on stdout")
    p.add_argument("--smoke-baseline-dir", default=SMOKE_BASELINE_DIR,
                   metavar="DIR",
                   help="where fleet_smoke.json and fleet_ha_smoke.json "
                        "live; a baseline gates a run at its own rank "
                        "count and device type (default: the "
                        "repository's results/baselines_torch)")
    p.add_argument("--tenant-smoke", action="store_true",
                   help="run the multi-tenancy + autoscaling "
                        "acceptance protocol (two-tenant 2-replica "
                        "fleet: quota refusal, priority shed order, "
                        "autoscale spawn with warm-serve gate) "
                        "instead of serving; JSON record on stdout")
    p.add_argument("--tracing-smoke", action="store_true",
                   help="run the distributed-tracing acceptance "
                        "protocol (2-replica fleet with per-slot "
                        "telemetry dirs, scripted kill, one-trace "
                        "failover continuity, merged fleet timeline) "
                        "instead of serving; JSON record on stdout")
    p.add_argument("--ha-smoke", action="store_true",
                   help="run the replication/HA acceptance protocol "
                        "(K=2 resident table, scripted holder kill "
                        "with manifest rebuild, scripted router kill "
                        "with lease takeover) instead of serving; "
                        "JSON record on stdout")
    p.add_argument("--coord-dir", default=None, metavar="DIR",
                   help="SHARED durable coordination dir (table "
                        "manifests, router directory, router lease); "
                        "enables the HA tier when set")
    p.add_argument("--table-replication", type=int, default=1,
                   metavar="K",
                   help="resident-table replication factor: "
                        "register/append fan out to the first K live "
                        "replicas on the signature ring (1 = legacy "
                        "single-holder)")
    p.add_argument("--standby", action="store_true",
                   help="serve as a STANDBY router: poll the lease "
                        "in --coord-dir and take over the advertised "
                        "endpoint when the primary dies")
    p.add_argument("--router-id", default=None,
                   help="stable owner id stamped into the lease and "
                        "directory (default: fleet-<pid>)")
    p.add_argument("--lease-ttl-s", type=float, default=3.0)
    p.add_argument("--lease-renew-s", type=float, default=0.5)
    p.add_argument("--json-output", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from distributed_join_tpu_torch.benchmarks import report as _report

    def report(headline, record, json_output):
        _report(record, json_output, headline=headline)

    args = parse_args(argv)
    if args.tracing_smoke:
        try:
            record = run_tracing_smoke(args)
        except FleetSmokeError as exc:
            report("tracing smoke FAILED", exc.record,
                   args.json_output)
            print(str(exc), file=sys.stderr)
            return 1
        report(
            f"tracing smoke: {record['replicas']} replicas, kill -> "
            f"failover in {record['failover_attempts']} attempt(s) "
            f"sharing trace {record['root_trace_id'][:18]}, "
            f"{record['attempt_failed_records']} failed attempt(s) "
            "on-trace, timeline over "
            f"{record['timeline_processes']} process(es) with "
            f"{record['timeline']['hops']} hop(s)",
            record, args.json_output)
        return 0
    if args.ha_smoke:
        try:
            record = run_fleet_ha_smoke(args)
        except FleetSmokeError as exc:
            report("fleet HA smoke FAILED", exc.record,
                   args.json_output)
            print(str(exc), file=sys.stderr)
            return 1
        sig = record["counter_signature"]["counters"]
        report(
            f"fleet HA smoke: K={record['table_replication']} "
            f"holders, holder kill -> failover in "
            f"{record['failover_attempts']} attempt(s) + rebuild "
            f"warm ({sig['rebuilt_replay_new_traces']} traces), "
            f"router kill -> takeover #{record['takeovers_total']} "
            f"warm ({sig['takeover_new_traces']} traces)",
            record, args.json_output)
        return 0
    if args.tenant_smoke:
        try:
            record = run_tenant_smoke(args)
        except FleetSmokeError as exc:
            report("tenant smoke FAILED", exc.record,
                   args.json_output)
            print(str(exc), file=sys.stderr)
            return 1
        sig = record["counter_signature"]["counters"]
        report(
            f"tenant smoke: {record['replicas']} replicas + "
            f"{sig['autoscale_spawned']} autoscaled (warm-verified="
            f"{sig['autoscale_warm_verified']}), bronze quota-"
            f"refused={sig['bronze_quota_refused']} priority-shed="
            f"{sig['bronze_priority_shed']}, gold served exactly "
            "under the same pressure",
            record, args.json_output)
        return 0
    if args.smoke:
        try:
            record = run_fleet_smoke(args)
        except FleetSmokeError as exc:
            report("fleet smoke FAILED", exc.record,
                   args.json_output)
            print(str(exc), file=sys.stderr)
            return 1
        report(
            f"fleet smoke: {record['replicas']} replicas, kill -> "
            f"drained in {record['drained_after_s']}s, failover in "
            f"{record['failover_attempts']} attempt(s), replacement "
            "warm with 0 traces, "
            f"{record['burst_shed']} shed under synthetic overload",
            record, args.json_output)
        return 0

    cfg = FleetConfig(
        n_replicas=args.replicas,
        replica_ranks=args.replica_ranks,
        persist_dir=args.persist_dir,
        history_dir=args.history_dir,
        probe_interval_s=args.probe_interval_s,
        probe_timeout_s=args.probe_timeout_s,
        spawn_timeout_s=args.spawn_timeout_s,
        suspect_strikes=args.suspect_strikes,
        retry_budget=args.retry_budget,
        request_deadline_s=args.request_deadline_s,
        max_inflight_per_replica=args.max_inflight,
        shed_p95_s=args.shed_p95_s,
        shed_qps=args.shed_qps,
        respawn=not args.no_respawn,
        flight_records=args.flight_records,
        flight_recorder_path=args.flight_recorder_path,
        coord_dir=args.coord_dir,
        table_replication=args.table_replication,
        lease_ttl_s=args.lease_ttl_s,
        lease_renew_s=args.lease_renew_s,
        router_id=args.router_id,
    )
    router = FleetRouter(
        process_fleet_factory(cfg, device=args.device,
                              extra_args=args.replica_arg),
        cfg)
    ha = None
    server = None
    if args.standby:
        if not args.coord_dir:
            print("--standby requires --coord-dir", file=sys.stderr)
            return 2
        # Standby mode: no replicas are spawned here — on takeover
        # the fleet is ADOPTED from the durable directory and the
        # primary's advertised endpoint is re-bound.
        ha = RouterHA(router, host=args.host, port=args.port,
                      owner=args.router_id)
        ha.start_standby()
        print(f"join-fleet STANDBY watching lease in "
              f"{args.coord_dir}", flush=True)
    elif args.coord_dir:
        ha = RouterHA(router, host=args.host, port=args.port,
                      owner=args.router_id)
        port = ha.start_primary()
        print(f"join-fleet listening on {args.host}:{port} "
              f"({cfg.n_replicas} replicas x {cfg.replica_ranks} "
              f"ranks, K={cfg.table_replication}, leased primary)",
              flush=True)
    else:
        router.start()
        server, port = start_router_daemon(router, args.host,
                                           args.port)
        print(f"join-fleet listening on {args.host}:{port} "
              f"({cfg.n_replicas} replicas x "
              f"{cfg.replica_ranks} ranks)",
              flush=True)
    try:
        import signal

        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        while not stop.wait(0.5):
            if router.shutdown_requested.is_set():
                break
    except KeyboardInterrupt:
        pass
    finally:
        if ha is not None:
            ha.stop()
        else:
            if server is not None:
                server.shutdown()
                server.server_close()
            router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
