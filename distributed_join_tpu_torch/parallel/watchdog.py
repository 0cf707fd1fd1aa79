"""Hang watchdog: bounded execution of host-side blocking calls.

Port of ``distributed_join_tpu/parallel/watchdog.py`` (:43-171):

- :func:`call_with_deadline` runs ``fn()`` on a watchdog worker thread
  and raises a structured :class:`HangError` on timeout, emitting
  ``watchdog_armed`` / ``watchdog_timeout`` telemetry events. The
  timed-out worker cannot be killed; it is a daemon thread, so a wedged
  call cannot hang the interpreter's exit (the handshake's deadline,
  ``parallel/bootstrap.py``, rides on it too).
- :func:`resolve_guard_deadline` resolves a driver's run deadline:
  ``--guard-deadline-s``, else ``DJTPU_GUARD_DEADLINE_S``, else None
  (unguarded).
- :func:`shutdown_bounded` tears a worker pool down with a bounded join
  (the out-of-core batch loop's pools), reporting a
  ``worker_shutdown_timeout`` event for a worker that does not exit.

The CUDA seam: a new thread's current CUDA device is device 0 and its
current stream that device's default stream. :func:`call_with_deadline`
hands the worker the caller's current device and stream, so the
guarded work queues where the caller's would have (a rank's own card
under NCCL, the out-of-core loop's compute stream) and a wait on a
tensor or an event inside it waits on the right one.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Callable, Optional

ENV_GUARD_DEADLINE = "DJTPU_GUARD_DEADLINE_S"

# How long the bounded teardown waits for a worker before declaring it
# wedged and detaching it from the exit-time join.
DEFAULT_SHUTDOWN_TIMEOUT_S = 10.0


class HangError(RuntimeError):
    """A watchdogged call did not complete within its deadline. The work
    may still be running on its (detached) worker thread, so the caller
    must treat any state it touches as poisoned."""

    def __init__(self, message: str, *, what: str = "guarded call",
                 deadline_s: Optional[float] = None):
        super().__init__(message)
        self.what = what
        self.deadline_s = deadline_s

    def record(self) -> dict:
        """The JSON-shaped failure record."""
        return {
            "error": "HangError",
            "what": self.what,
            "deadline_s": self.deadline_s,
            "message": str(self),
        }


def _detach_from_atexit(thread) -> None:
    """Best effort: drop ``thread`` from concurrent.futures' exit-time
    join table (a private dict of CPython's; if it moves, the worst case
    is a blocked exit)."""
    try:
        from concurrent.futures import thread as _cft

        _cft._threads_queues.pop(thread, None)
    except Exception:  # pragma: no cover - interpreter-internal drift
        pass


def _cuda_context():
    """A context manager that makes the caller's current CUDA device and
    stream current in another thread (a no-op context where CUDA is not
    in use)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return contextlib.nullcontext
    stream = torch.cuda.current_stream()
    return lambda: torch.cuda.stream(stream)


def call_with_deadline(fn: Callable, deadline_s: float,
                       what: str = "guarded call"):
    """Run ``fn()`` under a watchdog thread; raise :class:`HangError` if
    it does not complete within ``deadline_s`` seconds.

    Exceptions raised by ``fn`` propagate unchanged. On timeout the
    worker (a daemon thread) stays blocked inside ``fn``; the caller
    decides whether the process can go on (the drivers write their
    record and exit hard)."""
    from distributed_join_tpu_torch import telemetry

    telemetry.event("watchdog_armed", what=what,
                    deadline_s=float(deadline_s))
    ctx = _cuda_context()
    box: dict = {}

    def body():
        try:
            with ctx():
                box["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc

    worker = threading.Thread(target=body, name=f"watchdog-{what[:24]}",
                              daemon=True)
    worker.start()
    worker.join(deadline_s)
    if worker.is_alive():
        telemetry.event("watchdog_timeout", what=what,
                        deadline_s=float(deadline_s))
        raise HangError(
            f"{what} did not complete within {deadline_s:g}s",
            what=what, deadline_s=float(deadline_s))
    if "error" in box:
        raise box["error"]
    return box.get("result")


def resolve_guard_deadline(args=None) -> Optional[float]:
    """The run's guard deadline: ``--guard-deadline-s`` when the driver
    passed one (0 = unguarded), else ``DJTPU_GUARD_DEADLINE_S``, else
    None (unguarded: a long out-of-core run is legitimate)."""
    flag = getattr(args, "guard_deadline_s", None) if args is not None \
        else None
    if flag is not None:
        return float(flag) if flag > 0 else None
    env = os.environ.get(ENV_GUARD_DEADLINE, "")
    if not env:
        return None
    val = float(env)
    return val if val > 0 else None


def shutdown_bounded(executor, what: str,
                     timeout_s: float = DEFAULT_SHUTDOWN_TIMEOUT_S) -> bool:
    """Shut ``executor`` down, joining its workers for at most
    ``timeout_s`` in all. A worker still alive after that is reported
    (``worker_shutdown_timeout`` event and a warning) and detached from
    the exit-time join. Returns True when every worker exited."""
    from distributed_join_tpu_torch import telemetry

    executor.shutdown(wait=False, cancel_futures=True)
    threads = list(getattr(executor, "_threads", ()))
    deadline = time.monotonic() + timeout_s
    clean = True
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            clean = False
            _detach_from_atexit(t)
            telemetry.event("worker_shutdown_timeout", pool=what,
                            thread=t.name, timeout_s=float(timeout_s))
            warnings.warn(
                f"{what} worker {t.name!r} did not exit within "
                f"{timeout_s:g}s — detached from interpreter-exit "
                "join; treat its outputs as abandoned",
                stacklevel=2,
            )
    return clean
