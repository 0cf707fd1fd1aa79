"""The join program cache: built join programs keyed by signature.

Port of ``distributed_join_tpu/service/programs.py``: ``_canon`` (:68),
``spec_digest`` (:82), ``atomic_write_json`` (:94), ``_schema_of``
(:109), ``JoinSignature`` (:120-176), ``CachedProgram`` (:179-203) and
``JoinProgramCache`` (:206-520) with its disk tier. A program here is
the callable ``comm.spmd(step, sharded_out=...)`` over a built step;
building it resolves every option and capacity once, and a warm call is
a dict lookup and a dispatch. The cache groups calls as the JAX
package's does (the same signature fields, the same LRU bound, the same
counters), so one sequence of calls gives both packages the same hits,
misses, traces and evictions.

Where the signatures differ from the JAX package's (the digests differ
with them):
- the options are the port's ``make_join_step`` keywords, the metrics
  and integrity switches (``with_metrics``, ``with_integrity``,
  ``metrics_static``) among them: a program with either switch on is
  one of the ``(JoinResult, Metrics)`` programs (JAX :185, :404, :517),
  keyed apart from the plain one;
- the ladder rung is a field of its own (``rung``), where the JAX
  package keys it through ``metrics_static`` alone;
- a schema names numpy dtypes (``int64``), as the JAX package's does.

``with_metrics=None`` resolves from the telemetry session (JAX :266-281),
so a session keys the metrics programs apart from the plain ones, and
``planning.build_plan``'s digest equals :meth:`JoinProgramCache.signature`'s
for the same call.

**The disk tier** (``persist_dir=``, JAX :400-520). The JAX package
stores a serialised XLA executable, and a restarted server loads it with
no trace and no compile. An eager PyTorch program is a Python closure
over the step and cannot be serialised, so the port's entry
(``<persist_dir>/<digest>.joinprog``, JSON, written atomically and read
back at once) stores what a build resolves and what a fresh process
would otherwise find out on its first request:

- the canonical signature: every resolved ``make_join_step`` option
  (``_STEP_DEFAULTS`` filled in) and the rung;
- the backend: the device type, the card's name and compute capability,
  and the torch and CUDA versions;
- the CUDA kernels the program launches on a card (``PROGRAM_KERNELS``),
  each by its library's file name in ``build/torch_kernels/``, which
  carries the digest of its sources and flags (``ops/_kernels.py``).

A load checks every field against this process; a foreign or stale
entry (another backend, another card, another kernel digest, a missing
binary, a version bump) is a miss, counted in ``disk_load_failures``
with a ``program_cache_load_failed`` event, and the program is then
built, counted as a trace, never silently inside a "disk load". A good
entry loads the named kernel binaries (``dlopen``, never ``nvcc``) and
binds the step from the stored options: ``source == "disk"``, ``traces``
unchanged, ``disk_loads`` + 1. A disk load therefore does a build's work:
it calls the same builder, which binds the step closure (a build in the
port is that binding). What it adds is the entry's check and, through
:meth:`JoinProgramCache.preload`, the kernels' ``dlopen`` before a
service takes its first request. So ``traces == 0`` (a request's
``new_traces == 0``) says that the entry was found and checked, not that
the process is warm: its first run of the program still pays the lazy
loading of the CUDA modules and the allocator's first blocks. What the
tier saves a fresh process is measured on the card (``chip_smoke.py``
phase 25(b): the replacement replica's first request with and without
the tier).
A program over a ``FaultInjectingCommunicator`` never enters the tier
(the JAX package's fault-wrapped ``spmd`` has no ``lower``): a corrupted
program must not reach the replicas that share the directory.

The JAX package's chipless AOT helpers (:523-592: compiling for a TPU
topology the host lacks) are TPU mechanism with no counterpart.

With a telemetry session on, each build records a
``program_cache_trace`` event, each LRU eviction a
``program_cache_lru_evict`` event and each disk load a
``program_cache_disk_load`` event, under the JAX package's names and
payloads (:303, :329, :410, :516).
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import threading
from collections import OrderedDict
from typing import Callable, Optional

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.parallel.communicator import Communicator
from distributed_join_tpu_torch.parallel.distributed_join import (
    make_join_step,
    spmd_join,
)

# Every make_join_step option takes part in the signature, at its
# default where the caller did not pass it: read from the function's own
# signature, so a new knob can never alias two programs to one entry.
_STEP_DEFAULTS = {
    name: p.default
    for name, p in inspect.signature(make_join_step).parameters.items()
    if p.default is not inspect.Parameter.empty
}


def _canon(v):
    """Hashable, JSON-stable form of one option value."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return tuple(sorted((str(k), _canon(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    # flat frozen dataclasses: their repr tells values apart
    return repr(v)


def spec_digest(doc) -> str:
    """Stable content digest (sha256 hex) of a JSON-ish document
    (dicts, lists, scalars), through :func:`_canon`."""
    canon = _canon(doc)
    return hashlib.sha256(
        json.dumps(canon, sort_keys=True, default=str).encode()
    ).hexdigest()


def atomic_write_json(path: str, doc) -> str:
    """Crash-safe JSON write: a temporary file, then ``os.replace``, so a
    reader never sees a torn document (the program entries, and the
    fleet's table manifests and router directory)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _schema_of(table) -> tuple:
    """(name, dtype, trailing dims) triples, name-sorted: a table's shape
    identity less its row capacity, which is carried apart. Dtypes by
    their numpy names."""
    return tuple(sorted(
        (name, _dtype_name(c.dtype), tuple(int(d) for d in c.shape[1:]))
        for name, c in table.columns.items()))


def _digest(doc: dict) -> str:
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=str).encode()).hexdigest()


def step_options(opts: dict, defaults: dict, what: str) -> dict:
    """``opts`` over ``defaults``; an option that ``defaults`` does not
    know raises ``TypeError``."""
    unknown = set(opts) - set(defaults)
    if unknown:
        raise TypeError(f"unknown join option(s) {sorted(unknown)}; the "
                        f"signature covers {what}'s keywords")
    return {**defaults, **opts}


@dataclasses.dataclass(frozen=True)
class JoinSignature:
    """The identity of one join program. Two calls with equal signatures
    run the same program; two that could run different ones differ
    somewhere in here: the rank count and slice split, both tables'
    schemas and capacities, every ``make_join_step`` option (defaults
    filled in) and the ladder rung. Table contents never enter."""

    n_ranks: int
    build_schema: tuple
    build_capacity: int
    probe_schema: tuple
    probe_capacity: int
    options: tuple
    n_slices: int = 1
    rung: int = 0

    @classmethod
    def of(cls, comm: Communicator, build, probe, rung: int = 0,
           **opts) -> "JoinSignature":
        merged = step_options(opts, _STEP_DEFAULTS, "make_join_step")
        return cls(
            n_ranks=comm.n_ranks,
            build_schema=_schema_of(build),
            build_capacity=int(build.capacity),
            probe_schema=_schema_of(probe),
            probe_capacity=int(probe.capacity),
            options=tuple(sorted((name, _canon(v))
                                 for name, v in merged.items())),
            n_slices=int(comm.n_slices),
            rung=int(rung))

    def canonical(self) -> dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        return _digest(self.canonical())


PROGRAM_SUFFIX = ".joinprog"
PROGRAM_ENTRY_SCHEMA_VERSION = 1
# The csrc/ kernels a join program launches on a card: the merged-domain
# scans (B1), the order-preserving compaction (B2, record and pack
# sites) and the expand gather (B3). The radix sort is on no path.
PROGRAM_KERNELS = ("join_scans", "stream_compact", "expand_gather")


def _kernel_signatures(name: str) -> dict:
    from distributed_join_tpu_torch.ops import compact, expand, scan

    return {"join_scans": scan, "stream_compact": compact,
            "expand_gather": expand}[name]._SIGNATURES


def backend_identity(device) -> dict:
    """What a program entry binds to besides its signature: the device
    type, the card's name and compute capability, and the torch and
    CUDA versions."""
    device = torch.device(device)
    out = {"device_type": device.type, "device_name": None,
           "capability": None, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        out["device_name"] = torch.cuda.get_device_name(idx)
        out["capability"] = list(torch.cuda.get_device_capability(idx))
    return out


def program_kernels(device) -> dict:
    """``{kernel: library file name}`` of the kernels a join program
    launches on ``device`` (none off a card): each name carries the
    digest of its sources and flags."""
    from distributed_join_tpu_torch.ops import _kernels

    if torch.device(device).type != "cuda":
        return {}
    return {k: _kernels._library_path(k).name for k in PROGRAM_KERNELS}


def _json_form(doc):
    """``doc`` as JSON reads it back (tuples become lists)."""
    return json.loads(json.dumps(doc, sort_keys=True, default=str))


@dataclasses.dataclass
class CachedProgram:
    """One cached program: ``raw`` is the ``comm.spmd`` callable. It
    holds the built step and the communicator, never the tables of the
    call that built it. ``source`` is ``"trace"`` (built here) or
    ``"disk"`` (bound from a persisted entry); ``persisted`` says
    whether its entry is on disk."""

    signature: object
    raw: Callable
    source: str = "trace"
    persisted: bool = False

    def __call__(self, *args):
        return self.raw(*args)


class JoinProgramCache:
    """Program cache for one communicator.

    Keyed by signature, never by table contents, so any stream of
    same-shaped calls shares one program. ``max_entries`` bounds it
    (least recently used out first): every distinct table shape is a
    program, and a long-lived server must not grow with its requests.
    ``traces`` counts the programs built. ``persist_dir`` arms the disk
    tier (module docstring); ``device`` is where the programs run (the
    backend an entry binds to; default the communicator's device under
    a process group, else the GPU). Not thread-safe by itself: one
    caller at a time, as in the JAX package.
    """

    def __init__(self, comm: Communicator,
                 persist_dir: Optional[str] = None,
                 max_entries: Optional[int] = None, device=None):
        self.comm = comm
        self.persist_dir = persist_dir
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.traces = 0
        self.disk_loads = 0
        self.disk_load_failures = 0
        self.disk_persists = 0
        self.lru_evictions = 0
        self.integrity_evictions = 0
        self.generation_evictions = 0
        self._device = device
        self._backend: Optional[dict] = None

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        """Occupancy and counters, under the JAX package's keys."""
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "occupancy": (round(len(self._entries) / self.max_entries, 4)
                          if self.max_entries else None),
            "hits": self.hits,
            "misses": self.misses,
            "traces": self.traces,
            "disk_loads": self.disk_loads,
            "disk_load_failures": self.disk_load_failures,
            "disk_persists": self.disk_persists,
            "lru_evictions": self.lru_evictions,
            "integrity_evictions": self.integrity_evictions,
            "generation_evictions": self.generation_evictions,
        }

    def signature(self, build, probe, with_metrics=None,
                  **opts) -> JoinSignature:
        """The signature :meth:`get` keys this call under (the
        ``with_metrics=None`` session resolution applied)."""
        if with_metrics is None:
            with_metrics = telemetry.enabled()
        return JoinSignature.of(self.comm, build, probe,
                                with_metrics=with_metrics, **opts)

    def get(self, build, probe, with_metrics=None, **opts):
        """``(program, hit)`` for this shape and option set: a step is
        built only on a miss that the disk tier does not answer. A
        metrics or integrity program hangs its block on the result as
        ``res.telemetry``, as ``make_distributed_join``'s does."""
        if with_metrics is None:
            with_metrics = telemetry.enabled()
        sig = self.signature(build, probe, with_metrics=with_metrics, **opts)
        opts.pop("rung", None)
        with_aux = bool(with_metrics or opts.get("with_integrity"))

        def builder():
            return spmd_join(self.comm, make_join_step(
                self.comm, with_metrics=with_metrics, **opts), with_aux)

        return self.get_keyed(sig, builder, persist=True)

    def get_keyed(self, sig, builder: Callable, *, persist: bool = False):
        """Admission of any program under any frozen signature with
        ``digest()`` and ``canonical()`` (the resident prep, merge and
        probe-only programs, and the query programs): ``builder()`` makes
        it on a miss. The same LRU bound and counters as :meth:`get`.
        ``persist`` arms the disk tier for this program, as the JAX
        package's ``example_args`` do (its plain joins, probe-only joins
        and query plans; the prep and merge programs stay memory-only)."""
        entry = self._entries.get(sig)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(sig)
            return entry, True
        self.misses += 1
        tiered = persist and self._tier_on()
        if tiered:
            self.backend()  # no device to bind entries to raises here
        entry = self._load_persisted(sig, builder) if tiered else None
        if entry is None:
            raw = builder()
            self.traces += 1
            telemetry.event("program_cache_trace", digest=sig.digest()[:12],
                            entries=len(self._entries) + 1)
            persisted = False
            if tiered:
                try:
                    persisted = self._persist(sig)
                except Exception as exc:  # noqa: BLE001 - the tier is an
                    # optimisation: a failed write leaves a memory entry
                    telemetry.event("program_cache_persist_failed",
                                    digest=sig.digest()[:12],
                                    error=f"{type(exc).__name__}: {exc}")
            entry = CachedProgram(sig, raw, "trace", persisted=persisted)
        self._entries[sig] = entry
        if self.max_entries is not None \
                and len(self._entries) > self.max_entries:
            # the disk entry stays: a re-miss loads instead of building
            old_sig, _ = self._entries.popitem(last=False)
            self.lru_evictions += 1
            telemetry.event("program_cache_lru_evict",
                            digest=old_sig.digest()[:12],
                            entries=len(self._entries))
        return entry, False

    def predict_hit(self, digest: str) -> dict:
        """Whether a signature digest would dispatch a cached program,
        bind a persisted one, or build one. Read-only: never loads or
        builds (the entry's existence, as the JAX package checks)."""
        resident = any(sig.digest() == digest for sig in list(self._entries))
        persisted = bool(
            self.persist_dir is not None
            and os.path.exists(os.path.join(self.persist_dir,
                                            digest + PROGRAM_SUFFIX)))
        return {"resident": resident, "persisted": persisted,
                "would_trace": not (resident or persisted)}

    def evict(self, signature, reason: str = "integrity") -> bool:
        """Drop one entry, memory and disk, counted by ``reason``
        (``integrity``: a program whose run failed a check, which must
        not be bound again from disk either; ``generation``: a probe-only
        program of a resident table's old image)."""
        dropped = self._entries.pop(signature, None) is not None
        if self.persist_dir is not None:
            try:
                os.unlink(self._entry_path(signature))
                dropped = True
            except OSError:
                pass
        if dropped and reason == "integrity":
            self.integrity_evictions += 1
        elif dropped and reason == "generation":
            self.generation_evictions += 1
        return dropped

    def clear(self) -> None:
        self._entries.clear()

    # -- the disk tier ----------------------------------------------------

    def _tier_on(self) -> bool:
        from distributed_join_tpu_torch.parallel.faults import (
            FaultInjectingCommunicator,
        )

        return (self.persist_dir is not None
                and not isinstance(self.comm, FaultInjectingCommunicator))

    def _run_device(self) -> torch.device:
        if self._device is None:
            from distributed_join_tpu_torch.benchmarks import rank_device

            inner = self.comm
            while hasattr(inner, "_inner"):
                inner = inner._inner
            self._device = rank_device(inner)
        return torch.device(self._device)

    def backend(self) -> dict:
        if self._backend is None:
            self._backend = backend_identity(self._run_device())
        return self._backend

    def _entry_path(self, sig) -> str:
        return os.path.join(self.persist_dir, sig.digest() + PROGRAM_SUFFIX)

    def _entry_doc(self, sig) -> dict:
        return {
            "kind": "join_program",
            "schema_version": PROGRAM_ENTRY_SCHEMA_VERSION,
            "digest": sig.digest(),
            "signature": _json_form(sig.canonical()),
            "backend": self.backend(),
            "kernels": program_kernels(self._run_device()),
        }

    def _check_entry(self, doc: dict, sig) -> Optional[str]:
        """Why the entry ``doc`` cannot serve ``sig`` in this process, or
        None when it can (every field checked, every binary present)."""
        from distributed_join_tpu_torch.ops import _kernels

        if doc.get("kind") != "join_program" or doc.get(
                "schema_version") != PROGRAM_ENTRY_SCHEMA_VERSION:
            return "not a join program entry of this schema"
        if doc.get("digest") != sig.digest() or doc.get(
                "signature") != _json_form(sig.canonical()):
            return "signature differs"
        if doc.get("backend") != self.backend():
            return (f"backend {doc.get('backend')} is not this process's "
                    f"{self.backend()}")
        want = program_kernels(self._run_device())
        if doc.get("kernels") != want:
            return f"kernels {doc.get('kernels')} are not this tree's {want}"
        for name in want:
            if not _kernels._library_path(name).exists():
                return f"kernel binary {want[name]} is missing"
        return None

    def _load_kernels(self, names) -> None:
        from distributed_join_tpu_torch.ops import _kernels

        for name in names:
            _kernels.library(name, _kernel_signatures(name))

    def _persist(self, sig) -> bool:
        """Write ``sig``'s entry atomically and load it back at once (a
        bad entry found now, not at the next restart)."""
        path = atomic_write_json(self._entry_path(sig), self._entry_doc(sig))
        with open(path) as fh:
            why = self._check_entry(json.load(fh), sig)
        if why is not None:
            raise RuntimeError(f"the entry just written fails its load: "
                               f"{why}")
        self.disk_persists += 1
        return True

    def _load_persisted(self, sig, builder: Callable):
        path = self._entry_path(sig)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                doc = json.load(fh)
            why = self._check_entry(doc, sig)
            if why is not None:
                raise RuntimeError(why)
            self._load_kernels(doc["kernels"])
            raw = builder()
        except Exception as exc:  # noqa: BLE001 - a foreign or stale
            # entry is a miss, never an outage
            self.disk_load_failures += 1
            telemetry.event("program_cache_load_failed", path=path,
                            error=f"{type(exc).__name__}: {exc}")
            return None
        self.disk_loads += 1
        telemetry.event("program_cache_disk_load", digest=sig.digest()[:12])
        return CachedProgram(sig, raw, "disk", persisted=True)

    def preload(self) -> int:
        """Load the kernel binaries named by every good entry of the
        persist directory (for this backend), before the first request:
        that request then pays no ``dlopen``. Returns how many entries
        named kernels this process loaded; foreign entries, and entries
        whose binaries are missing, are skipped here (never built) and
        counted when a request reaches them."""
        from distributed_join_tpu_torch.ops import _kernels

        if not self._tier_on() or not os.path.isdir(self.persist_dir):
            return 0
        want = program_kernels(self._run_device())
        loaded = 0
        for fname in sorted(os.listdir(self.persist_dir)):
            if not fname.endswith(PROGRAM_SUFFIX):
                continue
            try:
                with open(os.path.join(self.persist_dir, fname)) as fh:
                    doc = json.load(fh)
            except (OSError, ValueError):
                continue
            if doc.get("backend") != self.backend() or not doc.get(
                    "kernels") or doc.get("kernels") != want:
                continue
            if not all(_kernels._library_path(k).exists() for k in want):
                # a missing binary is a miss for the request to count;
                # loading it here would build it
                continue
            try:
                self._load_kernels(want)
            except Exception as exc:  # noqa: BLE001 - the request's own
                # load reports it
                telemetry.event("program_cache_preload_failed",
                                error=f"{type(exc).__name__}: {exc}")
                return loaded
            loaded += 1
        return loaded
