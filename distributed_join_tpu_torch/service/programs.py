"""The join program cache: built join programs keyed by signature.

Port of ``distributed_join_tpu/service/programs.py``: ``_canon`` (:68),
``spec_digest`` (:82), ``_schema_of`` (:109), ``JoinSignature``
(:120-176), ``CachedProgram`` (:179-203) and ``JoinProgramCache``
(:206-428). A program here is the callable ``comm.spmd(step,
sharded_out=...)`` over a built step; building it resolves every option
and capacity once, and a warm call is a dict lookup and a dispatch. The
cache groups calls as the JAX package's does (the same signature
fields, the same LRU bound, the same counters), so one sequence of calls
gives both packages the same hits, misses, traces and evictions.

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

The JAX package's disk tier (XLA executable serialisation,
``persist_dir``, and its chipless AOT helpers, :430-592) has no
counterpart in the port: ``persist_dir`` refuses by name.

With a telemetry session on, each build records a
``program_cache_trace`` event and each LRU eviction a
``program_cache_lru_evict`` event, under the JAX package's names and
payloads (:303, :329, :410).
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
from collections import OrderedDict
from typing import Callable, Optional

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


@dataclasses.dataclass
class CachedProgram:
    """One cached program: ``raw`` is the ``comm.spmd`` callable. It
    holds the built step and the communicator, never the tables of the
    call that built it."""

    signature: object
    raw: Callable

    def __call__(self, *args):
        return self.raw(*args)


class JoinProgramCache:
    """Program cache for one communicator.

    Keyed by signature, never by table contents, so any stream of
    same-shaped calls shares one program. ``max_entries`` bounds it
    (least recently used out first): every distinct table shape is a
    program, and a long-lived server must not grow with its requests.
    ``traces`` counts the programs built. Not thread-safe by itself: one
    caller at a time, as in the JAX package.
    """

    def __init__(self, comm: Communicator,
                 persist_dir: Optional[str] = None,
                 max_entries: Optional[int] = None):
        if persist_dir is not None:
            raise NotImplementedError(
                f"persist_dir={persist_dir!r}: the program cache's disk "
                "tier (XLA executable serialisation) is not part of the "
                "port")
        self.comm = comm
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.traces = 0
        self.lru_evictions = 0
        self.integrity_evictions = 0
        self.generation_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        """Occupancy and counters, under the JAX package's keys (its disk
        tier's counters stay 0)."""
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "occupancy": (round(len(self._entries) / self.max_entries, 4)
                          if self.max_entries else None),
            "hits": self.hits,
            "misses": self.misses,
            "traces": self.traces,
            "disk_loads": 0,
            "disk_load_failures": 0,
            "disk_persists": 0,
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
        built only on a miss. A metrics or integrity program hangs its
        block on the result as ``res.telemetry``, as
        ``make_distributed_join``'s does."""
        if with_metrics is None:
            with_metrics = telemetry.enabled()
        sig = self.signature(build, probe, with_metrics=with_metrics, **opts)
        opts.pop("rung", None)
        with_aux = bool(with_metrics or opts.get("with_integrity"))

        def builder():
            return spmd_join(self.comm, make_join_step(
                self.comm, with_metrics=with_metrics, **opts), with_aux)

        return self.get_keyed(sig, builder)

    def get_keyed(self, sig, builder: Callable):
        """Admission of any program under any frozen signature with
        ``digest()`` (the resident prep, merge and probe-only programs,
        and the query programs): ``builder()`` makes it on a miss. The
        same LRU bound and counters as :meth:`get`."""
        entry = self._entries.get(sig)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(sig)
            return entry, True
        self.misses += 1
        entry = CachedProgram(sig, builder())
        self.traces += 1
        telemetry.event("program_cache_trace", digest=sig.digest()[:12],
                        entries=len(self._entries) + 1)
        self._entries[sig] = entry
        if self.max_entries is not None \
                and len(self._entries) > self.max_entries:
            old_sig, _ = self._entries.popitem(last=False)
            self.lru_evictions += 1
            telemetry.event("program_cache_lru_evict",
                            digest=old_sig.digest()[:12],
                            entries=len(self._entries))
        return entry, False

    def predict_hit(self, digest: str) -> dict:
        """Whether a signature digest would dispatch a cached program or
        build one. Read-only."""
        resident = any(sig.digest() == digest for sig in list(self._entries))
        return {"resident": resident, "persisted": False,
                "would_trace": not resident}

    def evict(self, signature, reason: str = "integrity") -> bool:
        """Drop one entry, counted by ``reason`` (``integrity``: a program
        whose run failed a check; ``generation``: a probe-only program of
        a resident table's old image)."""
        dropped = self._entries.pop(signature, None) is not None
        if dropped and reason == "integrity":
            self.integrity_evictions += 1
        elif dropped and reason == "generation":
            self.generation_evictions += 1
        return dropped

    def clear(self) -> None:
        self._entries.clear()
