"""Multi-process bootstrap: the reference's MPI control plane over
``torch.distributed``.

Port of ``distributed_join_tpu/parallel/bootstrap.py``. The reference
launches one OS process a GPU under ``mpirun``; MPI is control plane only
(rank, size, the broadcast of the NCCL id) while NCCL owns the data
plane. Here ``torch.distributed.init_process_group`` with a
``tcp://<coordinator>`` init method is the handshake (process 0 hosts the
rendezvous store), and the communicator's collectives are the data
plane: NCCL between cards, one process a card, or gloo on the CPU.

Configuration comes from arguments or the ``DJTPU_*`` environment that
the launcher (``benchmarks/launch.py``) sets, under the JAX package's
names:

  DJTPU_COORDINATOR    host:port of process 0 (the coordinator)
  DJTPU_NUM_PROCESSES  total process count
  DJTPU_PROCESS_ID     this process's id in [0, num_processes)
  DJTPU_CPU_DEVICES_PER_PROCESS
                       1 selects gloo on the CPU (one rank a process:
                       no other value is accepted)

``DJTPU_BOOTSTRAP_DEADLINE``, ``_RETRIES`` and ``_BACKOFF`` bound the
handshake as in the JAX package.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributed_join_tpu_torch.parallel.faults import retry_with_backoff
from distributed_join_tpu_torch.parallel.mesh import local_device

ENV_COORDINATOR = "DJTPU_COORDINATOR"
ENV_NUM_PROCESSES = "DJTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "DJTPU_PROCESS_ID"
ENV_CPU_DEVICES = "DJTPU_CPU_DEVICES_PER_PROCESS"
ENV_BOOTSTRAP_DEADLINE = "DJTPU_BOOTSTRAP_DEADLINE"
ENV_BOOTSTRAP_RETRIES = "DJTPU_BOOTSTRAP_RETRIES"
ENV_BOOTSTRAP_BACKOFF = "DJTPU_BOOTSTRAP_BACKOFF"

DEFAULT_DEADLINE_S = 300.0
DEFAULT_RETRIES = 3
DEFAULT_BACKOFF_S = 2.0


class BootstrapError(RuntimeError):
    """The handshake failed or hung: an environment outage, not a join
    result. Carries the per-attempt trail, so a driver can report a
    machine-readable failure record."""

    def __init__(self, message: str, *, phase: str = "bootstrap",
                 attempts=None, deadline_s: Optional[float] = None,
                 coordinator: Optional[str] = None):
        super().__init__(message)
        self.phase = phase
        self.attempts = attempts or []
        self.deadline_s = deadline_s
        self.coordinator = coordinator

    def record(self) -> dict:
        return {
            "error": "BootstrapError",
            "phase": self.phase,
            "message": str(self),
            "coordinator": self.coordinator,
            "deadline_s": self.deadline_s,
            "attempts": self.attempts,
        }


def call_with_deadline(fn: Callable, deadline_s: float,
                       what: str = "handshake"):
    """Run ``fn()`` in a daemon thread and wait at most ``deadline_s``.
    An exception or a hang becomes a :class:`BootstrapError`; a hung
    thread is left behind (it is a daemon, and the handshake's own store
    timeout ends it)."""
    box: dict = {}

    def body():
        try:
            box["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc

    t = threading.Thread(target=body, name=f"bootstrap-{what}", daemon=True)
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        raise BootstrapError(
            f"{what} did not complete within {deadline_s:g}s",
            phase=what, deadline_s=deadline_s,
            attempts=[{"attempt": 0, "elapsed_s": deadline_s,
                       "error": f"timeout after {deadline_s:g}s"}])
    exc = box.get("error")
    if exc is not None:
        raise BootstrapError(
            f"{what} failed: {type(exc).__name__}: {exc}",
            phase=what, deadline_s=deadline_s,
            attempts=[{"attempt": 0, "elapsed_s": None,
                       "error": f"{type(exc).__name__}: {exc}"}]) from exc
    return box.get("result")


def _connect(coordinator_address: str, num_processes: int, process_id: int,
             backend: str, timeout_s: float) -> None:
    """One ``init_process_group`` attempt. ``timeout_s`` bounds the
    store's rendezvous and, afterwards, every collective's wait for a
    peer: a lost rank makes the others raise instead of blocking
    forever. A failed attempt leaves no group behind."""
    kwargs = ({"device_id": local_device(backend, process_id)}
              if backend == "nccl" else {})
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=max(timeout_s, 1.0)),
            **kwargs)
    except Exception:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu_devices_per_process: Optional[int] = None,
    *,
    deadline_s: Optional[float] = None,
    max_retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
    connect: Optional[Callable] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> None:
    """Join the process group. Call before any tensor is made: under NCCL
    this selects the process's card (``torch.cuda.set_device``) first,
    so that nothing lands on card 0 by default.

    ``cpu_devices_per_process=1`` selects gloo on the CPU; without it the
    backend is NCCL, which needs a card (no fallback to the CPU). The
    handshake retries with exponential backoff (``max_retries`` attempts,
    the first retry after ``backoff_s``) under an overall ``deadline_s``,
    each attempt bounded by what is left of it; exhaustion raises
    :class:`BootstrapError` with the trail. ``connect``/``sleep`` are
    injectable for tests."""
    if cpu_devices_per_process not in (None, 1):
        raise ValueError(
            f"cpu_devices_per_process={cpu_devices_per_process}: the port "
            "runs one rank a process; pass 1 (gloo on the CPU), or use the "
            "emulated communicator for several ranks in one process")
    deadline_s = (float(os.environ.get(ENV_BOOTSTRAP_DEADLINE,
                                       DEFAULT_DEADLINE_S))
                  if deadline_s is None else deadline_s)
    max_retries = (int(os.environ.get(ENV_BOOTSTRAP_RETRIES,
                                      DEFAULT_RETRIES))
                   if max_retries is None else max_retries)
    backoff_s = (float(os.environ.get(ENV_BOOTSTRAP_BACKOFF,
                                      DEFAULT_BACKOFF_S))
                 if backoff_s is None else backoff_s)
    backend = "gloo" if cpu_devices_per_process == 1 else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_device(backend, process_id))
    os.environ[ENV_NUM_PROCESSES] = str(num_processes)
    os.environ[ENV_PROCESS_ID] = str(process_id)
    do_connect = connect if connect is not None else _connect
    t0 = time.monotonic()

    def bounded_connect():
        # A timed-out attempt burned the whole remainder, so the retry
        # loop's deadline check stops before another attempt: a hung
        # handshake is never retried while its thread may still run.
        remaining = max(0.0, deadline_s - (time.monotonic() - t0))
        return call_with_deadline(
            lambda: do_connect(coordinator_address, num_processes,
                               process_id, backend, deadline_s),
            remaining, what="handshake")

    try:
        retry_with_backoff(bounded_connect, max_attempts=max(1, max_retries),
                           backoff_s=backoff_s, deadline_s=deadline_s,
                           sleep=sleep)
    except BootstrapError as exc:
        exc.coordinator = exc.coordinator or coordinator_address
        exc.deadline_s = deadline_s
        exc.attempts = getattr(exc, "_retry_attempts", None) or exc.attempts
        raise


def maybe_initialize_from_env() -> bool:
    """Initialize iff the ``DJTPU_*`` launch environment is present (and
    no group exists yet); returns whether a group exists afterwards.
    Drivers call this first, before any tensor: a single-process run
    (no environment) is untouched."""
    if dist.is_initialized():
        return True
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return False
    cpu = os.environ.get(ENV_CPU_DEVICES)
    initialize(coord, int(os.environ[ENV_NUM_PROCESSES]),
               int(os.environ[ENV_PROCESS_ID]),
               cpu_devices_per_process=int(cpu) if cpu else None)
    return True


def shutdown() -> None:
    """Leave the process group, if there is one (the port's
    ``Communicator::finalize``): every launched run ends here."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_id() -> int:
    """This process's rank: the group's once one exists, else the launch
    environment's, else 0. For rank-0-only printing."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get(ENV_PROCESS_ID, "0"))


def is_coordinator() -> bool:
    return process_id() == 0
