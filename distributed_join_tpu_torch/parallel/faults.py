"""The ``auto_retry`` capacity ladder.

Port of ``distributed_join_tpu/parallel/faults.py`` ``RetryAttempt``,
``RetryReport`` and ``CapacityLadder`` (:697-892) over the capacities the
port has: the shuffle and output factors, ``out_rows_per_rank``, and the
skew sidecar's three heavy-hitter blocks. (The JAX ladder's
compression-bit rung and its tuner seeding belong to options the port
refuses.) The same shapes give the same rungs.

Also ``retry_with_backoff`` (JAX :636), which the bootstrap's handshake
retries through.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


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
    ``action`` is what produced the sizing ("initial" or
    "double_capacities")."""

    attempt: int
    action: str
    overflow: Optional[bool]
    shuffle_capacity_factor: float
    out_capacity_factor: float
    out_rows_per_rank: Optional[int]
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
    """Overflow escalation: each rung doubles every capacity a retry can
    relieve — both factors, ``out_rows_per_rank`` when set (it
    supersedes the output factor), and, with the skew path on, the
    heavy-hitter blocks. The HH probe and output blocks jump straight to
    at least the rank's full probe rows (``local_probe_rows``): one
    retry must cover any skew."""

    def __init__(self, *, shuffle_capacity_factor: float,
                 out_capacity_factor: float,
                 out_rows_per_rank: Optional[int] = None,
                 skew: bool = False,
                 hh_build_capacity: Optional[int] = None,
                 hh_probe_capacity: Optional[int] = None,
                 hh_out_capacity: Optional[int] = None,
                 local_probe_rows: Optional[int] = None):
        self.shuffle_f = shuffle_capacity_factor
        self.out_f = out_capacity_factor
        self.out_rows = out_rows_per_rank
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
            hh_build_capacity=self.hh_build,
            hh_probe_capacity=self.hh_probe,
            hh_out_capacity=self.hh_out))

    def escalate(self) -> str:
        """Advance one rung; returns the action taken."""
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
