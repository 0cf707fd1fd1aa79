"""Failure semantics: fault injection, the ``auto_retry`` capacity
ladder, the ragged plan's validation, retries with backoff and the
out-of-core resume manifest.

Port of ``distributed_join_tpu/parallel/faults.py``:

- ``FaultInjectedError``, ``FaultPlan`` with every field,
  ``plan_from_record`` and ``FaultInjectingCommunicator`` (JAX :60-469):
  a communicator wrapper that injects scheduled dispatch failures,
  drops and delays, forced overflow flags, rank-inconsistent ragged
  plans, and the four data corruption modes (``bit_flip``,
  ``row_truncate``, ``row_duplicate``, ``misroute``) that only the
  wire-integrity digests (``parallel/integrity.py``) detect, so that
  every branch of the ladder and of the batch loop's retry and
  degradation can be driven deterministically.
- ``RetryAttempt``, ``RetryReport`` and ``CapacityLadder`` (:697-892)
  over the capacities the port has: the compressed wire's bits, the
  shuffle and output factors, ``out_rows_per_rank``, and the skew
  sidecar's three heavy-hitter blocks, the autotuner's seeding
  (``base_rung``, ``next_rung``, ``seed_rung``: a pre-sized ladder labels
  its attempts with absolute rungs and its first with
  ``tuned_presize``), and the integrity rung (``note(integrity_ok=)``,
  ``hold("retry_integrity")``: a mismatch reruns the same sizing). The
  same shapes give the same rungs.
- The ragged plan's cross-rank validation (JAX :472-634, switched on by
  ``DJTPU_VALIDATE_PLANS`` or :func:`validate_plans`).
- ``retry_with_backoff`` (JAX :636), which the bootstrap's handshake and
  the out-of-core batch loop retry through.
- The out-of-core resume manifest: ``ManifestMismatchError`` (JAX
  :898), ``JoinManifest`` (:904) and ``batch_config_fingerprint``
  (:990), whose JSON is the JAX package's, so a manifest one package
  writes the other reads.

With a telemetry session on, ladder attempts and manifest writes also
stream into its event log (``retry_attempt``, ``manifest_batch``,
``manifest_failure``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.ops.join import JoinResult
from distributed_join_tpu_torch.parallel.communicator import Communicator


class FaultInjectedError(RuntimeError):
    """An injected (not organic) failure: raised by
    :class:`FaultInjectingCommunicator` on a scheduled dispatch fault, so
    that recovery paths can be driven deterministically."""


class PlanValidationError(RuntimeError):
    """A ragged transfer plan failed the cross-rank consistency check.
    Raised by :func:`check_plan_violations`: the check itself records
    the violation and trips the overflow flag, as the JAX package's
    in-program callback does."""


# -- ragged-plan validation -------------------------------------------

_PLAN_VALIDATION: Optional[bool] = None  # None: the environment decides
_plan_violations: list = []


def plan_validation_enabled() -> bool:
    """Whether ragged shuffles validate their plan before the exchange
    (``DJTPU_VALIDATE_PLANS`` set and not 0, unless
    :func:`validate_plans` overrides it)."""
    if _PLAN_VALIDATION is not None:
        return _PLAN_VALIDATION
    return os.environ.get("DJTPU_VALIDATE_PLANS", "") not in ("", "0")


@contextmanager
def validate_plans(enabled: bool = True):
    """Force plan validation on (or off) inside the context."""
    global _PLAN_VALIDATION
    prev = _PLAN_VALIDATION
    _PLAN_VALIDATION = enabled
    try:
        yield
    finally:
        _PLAN_VALIDATION = prev


def plan_violations() -> list:
    """Messages recorded since the last :func:`check_plan_violations`
    (newest last)."""
    return list(_plan_violations)


def clear_plan_violations() -> None:
    """Drop recorded violations (``distributed_inner_join`` does before
    each attempt, so that what it raises belongs to that attempt)."""
    _plan_violations.clear()


def check_plan_violations(clear: bool = True) -> None:
    """Raise :class:`PlanValidationError` if a validated shuffle saw an
    inconsistent plan."""
    if not _plan_violations:
        return
    msg = "; ".join(_plan_violations)
    if clear:
        _plan_violations.clear()
    raise PlanValidationError(msg)


def validate_ragged_plan(comm, send_sizes, recv_sizes, output_offsets,
                         out_capacity: int,
                         where: str = "shuffle_ragged") -> torch.Tensor:
    """Cross-rank consistency check of a ragged transfer plan (JAX
    :547-634): every rank all-gathers its (send, recv, offset) vectors
    and checks, with the same arithmetic everywhere, that rank j's
    ``send_sizes[i]`` is rank i's ``recv_sizes[j]``; that sizes and
    offsets are non-negative and every write ``[offset, offset + send)``
    of a sender that sends rows ends within ``out_capacity``; and that
    on each receiver the senders' windows are in rank order and do not
    overlap. One unhappy rank fails all (a psum of the verdicts).

    Returns a 0-d int32 token, 1 on a violation, which the caller folds
    into its overflow flag; the violation is also recorded (see
    :func:`check_plan_violations`, the raise point) and warned. The
    verdict is read on the host: a debug-mode cost."""
    n = comm.n_ranks
    dev = send_sizes.device
    mine = torch.stack([send_sizes.to(torch.int32),
                        recv_sizes.to(torch.int32),
                        output_offsets.to(torch.int32)])
    g = comm.all_gather(mine.reshape(1, 3 * n)).reshape(n, 3, n)
    g_send, g_recv, g_off = g[:, 0, :], g[:, 1, :], g[:, 2, :]
    ok = torch.equal(g_send, g_recv.T)
    ok = ok and bool((g_send >= 0).all() & (g_recv >= 0).all()
                     & (g_off >= 0).all())
    # a sender squeezed out by a clamp carries start > out_capacity with
    # nothing to send: valid
    ok = ok and bool(torch.where(g_send > 0, g_off + g_send <= out_capacity,
                                 True).all())
    off_r = g_off.T                          # (receiver, sender)
    ok = ok and bool((off_r[:, 1:] >= off_r[:, :-1] + g_recv[:, :-1]).all())
    n_bad = comm.psum(torch.tensor(0 if ok else 1, dtype=torch.int32,
                                   device=dev))
    if int(n_bad) == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    msg = (f"ragged plan inconsistent across ranks in {where}: "
           "send/recv/offset vectors disagree — the exchange would "
           "corrupt rows. A rank computed its plan from a different "
           "count matrix; suspect a corrupted or raced metadata "
           "all-gather.")
    _plan_violations.append(msg)
    warnings.warn(msg, stacklevel=2)
    return torch.ones((), dtype=torch.int32, device=dev)


def retry_with_backoff(
    fn: Callable,
    *,
    max_attempts: int = 3,
    backoff_s: float = 1.0,
    deadline_s: Optional[float] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Optional[Callable] = None,
):
    """Call ``fn()`` on failure again after ``backoff_s``, doubling the
    wait after each failure.

    Returns ``(result, attempts)``, ``attempts`` being one record
    ``{"attempt", "elapsed_s", "error"}`` a try (``error`` None on the
    success). When the attempts or the deadline run out, raises the last
    error with the trail attached as ``exc._retry_attempts``; the caller
    wraps it in its own error. No retry starts when its backoff would
    end past ``deadline_s``. ``on_retry(attempt, exc, delay)`` runs
    before each backoff. ``sleep`` and ``clock`` are for tests."""
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    t0 = clock()
    attempts = []
    delay = backoff_s
    last = None
    for attempt in range(max_attempts):
        ta = clock()
        try:
            result = fn()
            attempts.append({"attempt": attempt,
                             "elapsed_s": clock() - ta, "error": None})
            return result, attempts
        except Exception as exc:  # noqa: PERF203 - retry loop
            last = exc
            attempts.append({"attempt": attempt,
                             "elapsed_s": clock() - ta,
                             "error": f"{type(exc).__name__}: {exc}"})
            out_of_time = (deadline_s is not None
                           and clock() - t0 + delay > deadline_s)
            if attempt == max_attempts - 1 or out_of_time:
                break
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
            delay *= 2.0
    last._retry_attempts = attempts
    raise last


@dataclasses.dataclass(frozen=True)
class RetryAttempt:
    """One rung: the sizing that ran and whether it overflowed.
    ``attempt`` is the absolute rung label (``base_rung`` + the attempt's
    index); ``action`` is what produced the sizing ("initial",
    "tuned_presize", "widen_compression_bits", "double_capacities", or
    "retry_integrity": the same sizing again after a wire-integrity
    mismatch). ``integrity_ok`` is the digests' verdict where the
    attempt was verified (None: verification off, or skipped on an
    overflow)."""

    attempt: int
    action: str
    overflow: Optional[bool]
    shuffle_capacity_factor: float
    out_capacity_factor: float
    out_rows_per_rank: Optional[int]
    compression_bits: Optional[int]
    hh_build_capacity: Optional[int]
    hh_probe_capacity: Optional[int]
    hh_out_capacity: Optional[int]
    integrity_ok: Optional[bool] = None

    def as_record(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RetryReport:
    """The retry trail of one ``auto_retry`` join."""

    attempts: tuple

    @property
    def n_attempts(self) -> int:
        return len(self.attempts)

    @property
    def resolved(self) -> Optional[bool]:
        """True when the final attempt ran clean, False when it still
        overflowed, None when nothing ran."""
        if not self.attempts:
            return None
        last = self.attempts[-1].overflow
        return None if last is None else not last

    def as_record(self) -> Optional[dict]:
        """JSON-shaped record; None when the join ran once, clean, from
        rung 0. A tuner-seeded ladder keeps its record for one clean
        attempt: the rung label and its sizing are what the history
        store keeps for the next pre-size."""
        if self.n_attempts <= 1 and self.resolved and (
                not self.attempts or self.attempts[0].attempt == 0):
            return None
        return {
            "n_attempts": self.n_attempts,
            "resolved": self.resolved,
            "attempts": [a.as_record() for a in self.attempts],
        }


class CapacityLadder:
    """Overflow escalation. With the compressed wire on, a rung first
    widens its bits (2 -> 4 -> ... -> 32): a codec overflow reads like
    a capacity overflow on the flag, and bits are the cheap axis. Then
    each rung doubles every capacity a retry can relieve — both factors,
    ``out_rows_per_rank`` when set (it supersedes the output factor),
    and, with the skew path on, the heavy-hitter blocks. The HH probe
    and output blocks jump straight to at least the rank's full probe
    rows (``local_probe_rows``): one retry must cover any skew.

    ``base_rung`` (or :meth:`seed_rung`) starts the ladder at an
    absolute rung label: the autotuner pre-sized the knobs to a rung an
    earlier run escalated to, so the first attempt carries that run's
    label, and with it the program signature the cache already holds."""

    def __init__(self, *, shuffle_capacity_factor: float,
                 out_capacity_factor: float,
                 out_rows_per_rank: Optional[int] = None,
                 compression_bits: Optional[int] = None,
                 skew: bool = False,
                 hh_build_capacity: Optional[int] = None,
                 hh_probe_capacity: Optional[int] = None,
                 hh_out_capacity: Optional[int] = None,
                 local_probe_rows: Optional[int] = None,
                 base_rung: int = 0):
        self.shuffle_f = shuffle_capacity_factor
        self.out_f = out_capacity_factor
        self.out_rows = out_rows_per_rank
        self.bits = compression_bits
        self.skew = skew
        self.hh_build = hh_build_capacity
        self.hh_probe = hh_probe_capacity
        self.hh_out = hh_out_capacity
        self.p_local = local_probe_rows
        self.base_rung = base_rung
        self._action = "initial" if base_rung == 0 else "tuned_presize"
        self._attempts: list = []

    @property
    def next_rung(self) -> int:
        """The absolute rung label of the attempt about to run."""
        return self.base_rung + len(self._attempts)

    def seed_rung(self, rung: int) -> None:
        """Start at absolute rung ``rung`` (the sizing was applied to
        the construction's knobs already); no-op for rung 0."""
        if rung:
            self.base_rung = int(rung)
            self._action = "tuned_presize"

    def sizing(self) -> dict:
        """Keyword arguments for ``make_join_step`` at this rung."""
        return dict(shuffle_capacity_factor=self.shuffle_f,
                    out_capacity_factor=self.out_f,
                    out_rows_per_rank=self.out_rows,
                    compression_bits=self.bits,
                    hh_build_capacity=self.hh_build,
                    hh_probe_capacity=self.hh_probe,
                    hh_out_capacity=self.hh_out)

    def note(self, overflow: Optional[bool],
             integrity_ok: Optional[bool] = None) -> None:
        """Record the outcome of running the current rung (and the
        digests' verdict, where the attempt was verified)."""
        att = RetryAttempt(
            attempt=self.base_rung + len(self._attempts),
            action=self._action,
            overflow=overflow, shuffle_capacity_factor=self.shuffle_f,
            out_capacity_factor=self.out_f,
            out_rows_per_rank=self.out_rows,
            compression_bits=self.bits,
            hh_build_capacity=self.hh_build,
            hh_probe_capacity=self.hh_probe,
            hh_out_capacity=self.hh_out,
            integrity_ok=integrity_ok)
        self._attempts.append(att)
        telemetry.event("retry_attempt", **att.as_record())

    def escalate(self) -> str:
        """Advance one rung; returns the action taken."""
        if self.bits is not None and self.bits < 32:
            self.bits = min(self.bits * 2, 32)
            self._action = "widen_compression_bits"
            return self._action
        self.shuffle_f *= 2.0
        self.out_f *= 2.0
        if self.out_rows is not None:
            self.out_rows *= 2
        if self.skew:
            if self.hh_build is not None:
                self.hh_build *= 2
            if self.hh_probe is not None:
                self.hh_probe = (max(self.hh_probe * 2, self.p_local)
                                 if self.p_local else self.hh_probe * 2)
            if self.hh_out is not None:
                self.hh_out = (max(self.hh_out * 2, self.p_local)
                               if self.p_local else self.hh_out * 2)
        self._action = "double_capacities"
        return self._action

    def hold(self, action: str = "retry_integrity") -> str:
        """Advance to a rung of the SAME sizing: the answer to a
        wire-integrity mismatch (corruption is transient, the capacities
        were right). The rerun builds its program again, so a finite
        injected budget (``FaultPlan.corrupt_collectives``) runs out
        across holds."""
        self._action = action
        return self._action

    def report(self) -> RetryReport:
        return RetryReport(attempts=tuple(self._attempts))


# -- the out-of-core resume manifest ------------------------------------


class ManifestMismatchError(RuntimeError):
    """An existing manifest describes another run (batch count,
    capacities or per-batch row counts differ): resuming against it
    would merge unrelated partial totals."""


class JoinManifest:
    """Durable per-batch progress of the out-of-core batch loop.

    One JSON file, rewritten atomically (a temporary file, then
    ``os.replace``) after every completed batch: ``version``, the run's
    ``config`` fingerprint, ``batches`` (each completed batch's exact
    total and overflow flag, by batch id as a string) and ``failures``
    (the last ``MAX_FAILURES`` failed attempts). A killed run resumes
    from the first incomplete batch; matching keys share a batch, so the
    batch totals are independent and the resumed sum is exact. The
    format is the JAX package's, and so are its telemetry events."""

    VERSION = 1
    MAX_FAILURES = 50

    def __init__(self, path: str, config: dict):
        """Load and check the manifest at ``path``, or start one. A
        manifest of another run raises ``ManifestMismatchError``."""
        self.path = path
        self.config = config
        self._data = {"version": self.VERSION, "config": config,
                      "batches": {}, "failures": []}
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
            if (existing.get("version") != self.VERSION
                    or existing.get("config") != config):
                raise ManifestMismatchError(
                    f"manifest {path} was written by a different "
                    f"run config; refusing to resume against it "
                    f"(have {existing.get('config')!r}, "
                    f"want {config!r}). Delete the file or pass "
                    "a fresh manifest path to start over.")
            else:
                self._data = existing
        else:
            self._write()

    @property
    def completed(self) -> dict:
        """``{batch id: {"total": int, "overflow": bool}}``"""
        return {int(k): v for k, v in self._data["batches"].items()}

    @property
    def failures(self) -> list:
        return list(self._data["failures"])

    def record_batch(self, batch: int, total: int, overflow: bool) -> None:
        self._data["batches"][str(batch)] = {
            "total": int(total), "overflow": bool(overflow)}
        self._write()
        telemetry.event("manifest_batch", path=self.path,
                        batch=int(batch), total=int(total),
                        overflow=bool(overflow))

    def record_failure(self, batch: int, error: str, attempt: int) -> None:
        log = self._data["failures"]
        log.append({"batch": int(batch), "attempt": int(attempt),
                    "error": error})
        del log[:-self.MAX_FAILURES]
        self._write()
        telemetry.event("manifest_failure", path=self.path,
                        batch=int(batch), attempt=int(attempt),
                        error=error)

    def _write(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1)
        os.replace(tmp, self.path)


def batch_config_fingerprint(build_batches: Sequence, probe_batches:
                             Sequence, n_ranks: int, key,
                             bcap: int, pcap: int) -> dict:
    """What a manifest binds to: the same batching of the same tables,
    witnessed by the per-batch row counts, the rank count, the key and
    the capacities. (The join's sizing factors are left out on purpose:
    a run that overflowed resumes with larger ones.)"""
    return {
        "n_batches": len(build_batches),
        "n_ranks": int(n_ranks),
        "key": list(key) if isinstance(key, (list, tuple)) else key,
        "build_capacity": int(bcap),
        "probe_capacity": int(pcap),
        "build_rows": [int(next(iter(b.values())).shape[0])
                       for b in build_batches],
        "probe_rows": [int(next(iter(b.values())).shape[0])
                       for b in probe_batches],
    }


# -- fault injection -----------------------------------------------------


@dataclasses.dataclass
class FaultPlan:
    """Deterministic failure schedule for
    :class:`FaultInjectingCommunicator` (the JAX package's fields, every
    one). Counters are cumulative over the wrapper's life, so one plan
    scripts one outage.

    - ``overflow_programs``: the first N programs built through ``spmd``
      report ``JoinResult.overflow`` True whatever the data: to the
      ``auto_retry`` ladder, a capacity squeeze (every rung builds a
      program, so program index == ladder attempt).
    - ``fail_dispatches``: the first N calls of any program raise
      :class:`FaultInjectedError` (a transient launch failure).
    - ``fail_after_dispatches``: every call after the first N raises (a
      persistent outage: the killed-mid-run scenario).
    - ``drop_dispatches``: exactly these 1-based call ordinals raise.
    - ``dispatch_delay_s``: sleep this long before each call (a slow
      interconnect: drives deadlines); ``delay_after_dispatches`` lets
      the first N calls run at full speed first.
    - ``corrupt_plan_gathers``: the first N ragged-plan count gathers
      come back perturbed rank-dependently (each rank adds its rank
      index to one row of its gathered view), so every rank plans from
      a different count matrix: what :func:`validate_ragged_plan`
      catches.
    - ``corrupt_mode`` + ``corrupt_collectives``: DATA corruption at
      the collectives, the adversary of the wire-integrity digests
      (``parallel/integrity.py``). The first N eligible collectives over
      the wrapper's life are perturbed on rank ``corrupt_rank`` (default
      ``seed % n_ranks``). Which collectives of a program are corrupted
      is decided once, on the program's first call (the JAX package
      decides at trace time), and the program corrupts the same ones on
      every later call: a cached program never heals by itself, and a
      rung that builds its program again draws from what is left.

      * ``"bit_flip"``: one seed-addressed bit of one element of a
        received data block flips (padded blocks through ``all_to_all``
        and the cross-slice exchange, ragged buffers through
        ``ragged_all_to_all``);
      * ``"row_truncate"`` / ``"row_duplicate"``: a received row count
        drops or gains 1, so the receiver loses a real row or adopts a
        garbage one. On the padded wires the target rank's received
        count vector slips; on the ragged wire one entry of the gathered
        count matrix changes identically on every rank, a consistent lie
        that :func:`validate_ragged_plan` cannot see;
      * ``"misroute"``: rows land at the wrong rank: on the target rank
        the received block axis rolls by one (padded), or the target
        sender's offsets for two destinations swap (ragged).
    """

    seed: int = 0
    overflow_programs: int = 0
    fail_dispatches: int = 0
    fail_after_dispatches: Optional[int] = None
    drop_dispatches: tuple = ()
    dispatch_delay_s: float = 0.0
    delay_after_dispatches: Optional[int] = None
    corrupt_plan_gathers: int = 0
    corrupt_mode: Optional[str] = None
    corrupt_collectives: int = 0
    corrupt_rank: Optional[int] = None


def plan_from_record(record: dict) -> FaultPlan:
    """A :class:`FaultPlan` from its JSON-shaped record (the inverse of
    ``dataclasses.asdict``); an unknown key refuses by name."""
    known = {f.name for f in dataclasses.fields(FaultPlan)}
    unknown = set(record) - known
    if unknown:
        raise ValueError(
            f"unknown FaultPlan field(s) {sorted(unknown)}; "
            f"known: {sorted(known)}")
    record = dict(record)
    if record.get("drop_dispatches") is not None:
        record["drop_dispatches"] = tuple(record["drop_dispatches"])
    return FaultPlan(**record)


CORRUPTION_MODES = ("bit_flip", "row_truncate", "row_duplicate",
                    "misroute")


class FaultInjectingCommunicator(Communicator):
    """A ``Communicator`` decorator that injects a :class:`FaultPlan`.

    Collectives go to the wrapped backend unchanged; the faults enter at
    the wrapper's own seams (building a program, calling it, the ragged
    plan's count gather, the exchanges' results), so the join and
    shuffle code run as they are and see what the real failure would
    show them. Every method of the port's communicators is forwarded
    (the shuffles' counters, host reads and staging included); any other
    attribute (``hier``, ``device``, ``mesh``) is the wrapped one's. The
    wrapper is not a ``ProcessGroupCommunicator``: where a driver would
    take a process group's device from it, pass the device.

    An injected overflow ORs a device ``True`` into the result's
    ``overflow``, and a corruption edits the received tensor on the
    device (by indices known on the host): no value is read to the host.
    The intra-slice exchange (``all_to_all_chip``) is delivered clean,
    as in the JAX package: the corruption modes aim at the cross-slice
    hop and the flat exchanges.
    """

    def __init__(self, inner: Communicator, plan: FaultPlan):
        if (plan.corrupt_mode is not None
                and plan.corrupt_mode not in CORRUPTION_MODES):
            raise ValueError(
                f"unknown corrupt_mode {plan.corrupt_mode!r}; pick one of "
                f"{CORRUPTION_MODES}")
        self._inner = inner
        self.plan = plan
        self.name = f"faulty({inner.name})"
        self._programs_built = 0
        self._dispatches = 0
        self._plan_gathers: dict = {}   # rank -> plan gathers seen
        self._corruptions = 0           # the corruption budget spent
        self._lock = threading.Lock()
        # the program a rank thread is running, and its position in the
        # program's eligible collectives (see _corrupt_budget)
        self._tls = threading.local()

    # -- delegation ---------------------------------------------------

    @property
    def n_ranks(self) -> int:
        return self._inner.n_ranks

    @property
    def n_slices(self) -> int:
        return self._inner.n_slices

    @property
    def chips_per_slice(self) -> int:
        return self._inner.chips_per_slice

    def all_to_all(self, x):
        return self._corrupt_exchanged(self._inner.all_to_all(x))

    def ppermute_all_to_all(self, x):
        return self._corrupt_exchanged(self._inner.ppermute_all_to_all(x))

    def all_to_all_chip(self, x):
        return self._inner.all_to_all_chip(x)

    def all_to_all_slice(self, x):
        """The cross-slice exchange: the flat exchanges' corruption modes
        on what it delivers. Its leading axis is the source slice, so a
        misroute attributes whole slices to the wrong source."""
        return self._corrupt_exchanged(self._inner.all_to_all_slice(x))

    def axis_index(self) -> int:
        return self._inner.axis_index()

    def psum(self, x):
        return self._inner.psum(x)

    def ragged_all_to_all(self, operand, output, input_offsets,
                          send_sizes, output_offsets, recv_sizes,
                          recv_offsets=None):
        mode = self.plan.corrupt_mode
        n = self.n_ranks
        if mode == "misroute" and n > 1 and self._corrupt_budget() \
                and self._active():
            # the target sender reads two destinations' rows from each
            # other's offsets: its rows land at the wrong ranks
            d1 = self.plan.seed % n
            d2 = (d1 + 1 + (self.plan.seed // n) % (n - 1)) % n
            offs = (input_offsets.clone()
                    if isinstance(input_offsets, torch.Tensor)
                    else list(input_offsets))
            offs[d1], offs[d2] = input_offsets[d2], input_offsets[d1]
            input_offsets = offs
        out = self._inner.ragged_all_to_all(
            operand, output, input_offsets, send_sizes, output_offsets,
            recv_sizes, recv_offsets=recv_offsets)
        if mode == "bit_flip" and self._corrupt_budget() and self._active():
            out = _flip_one_bit(out, self.plan.seed)
        return out

    def count_wire(self, rows: int, nbytes: int) -> None:
        self._inner.count_wire(rows, nbytes)

    def count_tiers(self, ici: int, dcn: int, saved: int = 0) -> None:
        self._inner.count_tiers(ici, dcn, saved)

    def counters(self) -> dict:
        return self._inner.counters()

    def host_ints(self, *vectors) -> list:
        return self._inner.host_ints(*vectors)

    def local_rows(self, capacity: int) -> range:
        return self._inner.local_rows(capacity)

    def barrier(self) -> None:
        self._inner.barrier()

    def host_max(self, value: float) -> float:
        return self._inner.host_max(value)

    def finalize(self) -> None:
        self._inner.finalize()

    def __getattr__(self, name):
        # reached only for attributes the wrapper does not define
        return getattr(self._inner, name)

    # -- injection seams ----------------------------------------------

    def all_gather(self, x):
        g = self._inner.all_gather(x)
        # The ragged plan's count exchange: an int64 (1, m) row a rank
        # (shuffle.prefetch_ragged_plans, ragged_plan), gathered to (n,
        # m). Each rank adds its own rank index to row seed % n of its
        # view: rank 0 adds 0, so the ranks disagree rather than shift.
        if (self.plan.corrupt_plan_gathers and x.dtype == torch.int64
                and x.ndim == 2 and x.shape[0] == 1
                and self._take_plan_gather()):
            n = self.n_ranks
            g = g.clone()
            g[self.plan.seed % n] += self.axis_index()
        return g

    def all_gather_counts(self, x):
        g = self.all_gather(x)
        if (self.plan.corrupt_mode in ("row_truncate", "row_duplicate")
                and self._corrupt_budget()):
            # A consistent lie, the same on every rank, about how many
            # rows the target sender routes to one destination (the
            # first n columns are the first batch's counts): the
            # senders' digests commit to their true local counts before
            # this gather, so only the digests can tell.
            n = self.n_ranks
            col = (self.plan.seed // n) % n
            g = g.clone()
            cell = g[self._corrupt_rank(), col]
            g[self._corrupt_rank(), col] = (
                cell + (-1 if self.plan.corrupt_mode == "row_truncate"
                        else 1)).clamp(min=0)
        return g

    def _take_plan_gather(self) -> bool:
        """Whether this rank's next plan gather is one of the first
        ``corrupt_plan_gathers`` (counted a rank: the emulated ranks are
        threads, each making the same gathers)."""
        me = self.axis_index()
        with self._lock:
            seen = self._plan_gathers.get(me, 0)
            self._plan_gathers[me] = seen + 1
            return seen < self.plan.corrupt_plan_gathers

    def _corrupt_rank(self) -> int:
        """The rank whose traffic the corruption modes hit."""
        t = self.plan.corrupt_rank
        return (self.plan.seed if t is None else t) % self.n_ranks

    def _active(self) -> bool:
        return self.axis_index() == self._corrupt_rank()

    def _corrupt_budget(self) -> bool:
        """Whether this eligible collective is corrupted. Inside a
        program (``spmd``) the decision for its k-th eligible collective
        is made once, by the first rank to reach it on the program's
        first call, from the budget left (``corrupt_collectives`` over
        the wrapper's life), and holds for every rank and every later
        call: the JAX package's trace-time budget. Outside a program
        each call decides."""
        prog = getattr(self._tls, "program", None)
        with self._lock:
            if prog is not None:
                k = self._tls.ordinal
                self._tls.ordinal += 1
                if k in prog:
                    return prog[k]
            take = (self.plan.corrupt_mode is not None
                    and self._corruptions < self.plan.corrupt_collectives)
            self._corruptions += take
            if prog is not None:
                prog[k] = take
            return take

    def rearm_corruption(self) -> None:
        """Reset the budget, so that the NEXT program built carries the
        schedule again (the drivers' ``benchmarks.collect_integrity``
        calls this before its verified step: the timed program spent the
        budget, and a clean verification would bless numbers the
        corruption touched). Programs already called keep their
        decisions."""
        with self._lock:
            self._corruptions = 0

    def _corrupt_exchanged(self, y):
        """An ``all_to_all`` result as the target rank receives it. An
        int32 block of exactly ``n_ranks`` entries, 1-D or nested (slice,
        chip), is a count exchange (the truncate and duplicate seam: the
        count from one sender slips by 1); any block of 2 or more
        dimensions is data (the bit-flip and misroute seam)."""
        mode = self.plan.corrupt_mode
        if mode is None:
            return y
        n = self.n_ranks
        is_counts = (y.dtype == torch.int32 and y.numel() == n
                     and y.ndim in (1, 2))
        if (mode in ("row_truncate", "row_duplicate") and is_counts
                and self._corrupt_budget() and self._active()):
            j = (self.plan.seed // n) % n
            flat = y.reshape(-1).clone()
            flat[j] += -1 if mode == "row_truncate" else 1
            return flat.clamp(min=0).reshape(y.shape)
        if (mode == "bit_flip" and y.ndim >= 2 and self._corrupt_budget()
                and self._active()):
            return _flip_one_bit(y, self.plan.seed)
        if (mode == "misroute" and y.ndim >= 2 and n > 1
                and self._corrupt_budget() and self._active()):
            # every received block attributed to the wrong source
            return torch.roll(y, 1, dims=0)
        return y

    def spmd(self, fn: Callable, *, sharded_out=None,
             local_inputs=False) -> Callable:
        idx = self._programs_built
        self._programs_built += 1
        inject_overflow = idx < self.plan.overflow_programs

        decided: dict = {}   # eligible collective -> corrupted?

        def wrapped(*args):
            tls = self._tls
            prev = getattr(tls, "program", None), getattr(tls, "ordinal", 0)
            tls.program, tls.ordinal = decided, 0
            try:
                out = fn(*args)
            finally:
                tls.program, tls.ordinal = prev
            if inject_overflow:
                if isinstance(out, JoinResult):
                    out = dataclasses.replace(out,
                                              overflow=out.overflow | True)
                elif (isinstance(out, tuple) and out
                      and isinstance(out[0], JoinResult)):
                    out = (dataclasses.replace(
                        out[0], overflow=out[0].overflow | True),) + out[1:]
            return out

        compiled = self._inner.spmd(wrapped, sharded_out=sharded_out,
                                    local_inputs=local_inputs)

        def dispatch(*args, **kwargs):
            with self._lock:
                self._dispatches += 1
                k = self._dispatches
            plan = self.plan
            if plan.dispatch_delay_s and k > (
                    plan.delay_after_dispatches or 0):
                time.sleep(plan.dispatch_delay_s)
            if k <= plan.fail_dispatches:
                raise FaultInjectedError(
                    f"injected dispatch failure #{k} "
                    f"(fail_dispatches={plan.fail_dispatches})")
            if k in (plan.drop_dispatches or ()):
                raise FaultInjectedError(
                    f"injected dispatch drop #{k} "
                    f"(drop_dispatches={plan.drop_dispatches})")
            after = plan.fail_after_dispatches
            if after is not None and k > after:
                raise FaultInjectedError(
                    f"injected persistent outage: dispatch #{k} > "
                    f"fail_after_dispatches={after}")
            return compiled(*args, **kwargs)

        return dispatch


def _flip_one_bit(block: torch.Tensor, seed: int) -> torch.Tensor:
    """``block`` with one seed-addressed bit of one seed-addressed
    element flipped: the least payload corruption. Every dtype flips a
    real bit, floats through a same-width integer view (where the TPU
    cannot view a float64, the JAX package nudges it by 1.0 instead)."""
    if block.numel() == 0 or block.dtype == torch.bool:
        return block
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    flat = block.reshape(-1).clone()
    bits = flat.view(ints[flat.element_size()]) \
        if block.dtype.is_floating_point else flat
    idx = seed % flat.numel()
    nbits = flat.element_size() * 8
    bit = (seed // flat.numel()) % nbits
    signed = bits.dtype != torch.uint8
    bits[idx] ^= (torch.iinfo(bits.dtype).min if signed and bit == nbits - 1
                  else 1 << bit)
    return flat.reshape(block.shape)
