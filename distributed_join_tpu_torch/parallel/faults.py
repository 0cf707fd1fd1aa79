"""The ``auto_retry`` capacity ladder and the ragged plan's validation.

Port of ``distributed_join_tpu/parallel/faults.py`` ``RetryAttempt``,
``RetryReport`` and ``CapacityLadder`` (:697-892) over the capacities the
port has: the compressed wire's bits, the shuffle and output factors,
``out_rows_per_rank``, and the skew sidecar's three heavy-hitter blocks.
(The JAX ladder's tuner seeding and integrity rung belong to options the
port refuses.) The same shapes give the same rungs.

Also the ragged plan's cross-rank validation (JAX :472-634, switched on
by ``DJTPU_VALIDATE_PLANS`` or :func:`validate_plans`),
``retry_with_backoff`` (JAX :636), which the bootstrap's handshake and
the out-of-core batch loop retry through, and the out-of-core resume
manifest: ``ManifestMismatchError`` (JAX :898), ``JoinManifest`` (:904)
and ``batch_config_fingerprint`` (:990), whose JSON is the JAX
package's, so a manifest one package writes the other reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch


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
):
    """Call ``fn()`` on failure again after ``backoff_s``, doubling the
    wait after each failure.

    Returns ``(result, attempts)``, ``attempts`` being one record
    ``{"attempt", "elapsed_s", "error"}`` a try (``error`` None on the
    success). When the attempts or the deadline run out, raises the last
    error with the trail attached as ``exc._retry_attempts``; the caller
    wraps it in its own error. No retry starts when its backoff would
    end past ``deadline_s``. ``sleep`` and ``clock`` are for tests."""
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
            sleep(delay)
            delay *= 2.0
    last._retry_attempts = attempts
    raise last


@dataclasses.dataclass(frozen=True)
class RetryAttempt:
    """One rung: the sizing that ran and whether it overflowed.
    ``action`` is what produced the sizing ("initial",
    "widen_compression_bits" or "double_capacities")."""

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
        """JSON-shaped record; None when the join ran once, clean."""
        if self.n_attempts <= 1 and self.resolved:
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
    rows (``local_probe_rows``): one retry must cover any skew."""

    def __init__(self, *, shuffle_capacity_factor: float,
                 out_capacity_factor: float,
                 out_rows_per_rank: Optional[int] = None,
                 compression_bits: Optional[int] = None,
                 skew: bool = False,
                 hh_build_capacity: Optional[int] = None,
                 hh_probe_capacity: Optional[int] = None,
                 hh_out_capacity: Optional[int] = None,
                 local_probe_rows: Optional[int] = None):
        self.shuffle_f = shuffle_capacity_factor
        self.out_f = out_capacity_factor
        self.out_rows = out_rows_per_rank
        self.bits = compression_bits
        self.skew = skew
        self.hh_build = hh_build_capacity
        self.hh_probe = hh_probe_capacity
        self.hh_out = hh_out_capacity
        self.p_local = local_probe_rows
        self._action = "initial"
        self._attempts: list = []

    def sizing(self) -> dict:
        """Keyword arguments for ``make_join_step`` at this rung."""
        return dict(shuffle_capacity_factor=self.shuffle_f,
                    out_capacity_factor=self.out_f,
                    out_rows_per_rank=self.out_rows,
                    compression_bits=self.bits,
                    hh_build_capacity=self.hh_build,
                    hh_probe_capacity=self.hh_probe,
                    hh_out_capacity=self.hh_out)

    def note(self, overflow: Optional[bool]) -> None:
        """Record the outcome of running the current rung."""
        self._attempts.append(RetryAttempt(
            attempt=len(self._attempts), action=self._action,
            overflow=overflow, shuffle_capacity_factor=self.shuffle_f,
            out_capacity_factor=self.out_f,
            out_rows_per_rank=self.out_rows,
            compression_bits=self.bits,
            hh_build_capacity=self.hh_build,
            hh_probe_capacity=self.hh_probe,
            hh_out_capacity=self.hh_out))

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
    format is the JAX package's (its telemetry events are not part of
    the port)."""

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

    def record_failure(self, batch: int, error: str, attempt: int) -> None:
        log = self._data["failures"]
        log.append({"batch": int(batch), "attempt": int(attempt),
                    "error": error})
        del log[:-self.MAX_FAILURES]
        self._write()

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
