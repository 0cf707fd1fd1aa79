"""Multi-process launcher: the port's ``mpirun``.

    # one process a card on this host, NCCL:
    python -m distributed_join_tpu_torch.benchmarks.launch \\
        --num-processes 4 -- python -m \\
        distributed_join_tpu_torch.benchmarks.distributed_join \\
        --communicator nccl --build-table-nrows 40000000 \\
        --probe-table-nrows 40000000

    # two ranks on the CPU over gloo:
    python -m distributed_join_tpu_torch.benchmarks.launch \\
        --num-processes 2 --cpu-devices-per-process 1 -- python -m \\
        distributed_join_tpu_torch.benchmarks.distributed_join \\
        --communicator gloo --build-table-nrows 8192 \\
        --probe-table-nrows 8192 --iterations 1

    # several hosts: one launcher a host, each naming its process:
    python -m distributed_join_tpu_torch.benchmarks.launch \\
        --num-processes 8 --process-id $ID --coordinator host0:9876 -- ...

Port of ``distributed_join_tpu/benchmarks/launch.py``: the same flags and
the same ``DJTPU_*`` environment (``parallel/bootstrap.py``); ``--slices``,
``--sort-mode``, ``--sort-segments``, ``--telemetry``, ``--trace``,
``--diagnose``, ``--history``, ``--stage-profile``, ``--auto-tune`` and
``--guard-deadline-s`` are handed on to the command
(``benchmarks.FORWARDED_CHILD_FLAGS``), unless it carries the flag
already: every process writes its own rank's telemetry files into the
one session directory, and each process's run is guarded, not the
launcher's reaping. With
``--process-id`` the launcher execs the command in place for that one
process; without it, it starts every process here and reaps them with
mpirun's semantics: the first process to exit non-zero ends the others
(they would wait in a collective for it forever), and the launcher exits
non-zero naming that process and its exit code. Under NCCL each process
takes its own card, so this host needs as many cards as processes; two
ranks on one card are not NCCL (use ``--communicator emulated``).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from distributed_join_tpu_torch.benchmarks import (
    FORWARDED_CHILD_FLAGS,
    UNPORTED_FLAGS,
    refuse_flags,
)
from distributed_join_tpu_torch.parallel.bootstrap import (
    ENV_COORDINATOR,
    ENV_CPU_DEVICES,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
)

_REFUSED = dict(UNPORTED_FLAGS)
# How long the others get to exit after a terminate before they are
# killed.
TERMINATE_GRACE_S = 10.0


def parse_args(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    own = argv[:argv.index("--")] if "--" in argv else argv
    refuse_flags(p, own, _REFUSED)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, default=None,
                   help="run only this process (one launcher a host); "
                        "default: start every process on this host")
    p.add_argument("--coordinator", default="localhost:9876",
                   help="host:port of process 0's rendezvous store")
    p.add_argument("--cpu-devices-per-process", type=int, default=None,
                   help="1 = one rank a process on the CPU, over gloo "
                        "(without it: NCCL, one process a card)")
    p.add_argument("--slices", type=int, default=None,
                   help="hierarchical-mesh slice count, handed on to every "
                        "process (--shuffle hierarchical)")
    p.add_argument("--sort-mode", default=None,
                   help="handed on to every process")
    p.add_argument("--sort-segments", type=int, default=None,
                   help="handed on to every process")
    p.add_argument("--telemetry", nargs="?", const="telemetry",
                   default=None, metavar="DIR",
                   help="handed on to every process (one session "
                        "directory, a file set a rank)")
    p.add_argument("--trace", action="store_true",
                   help="handed on to every process")
    p.add_argument("--diagnose", action="store_true",
                   help="handed on to every process (rank 0 writes the "
                        "diagnosis)")
    p.add_argument("--history", default=None, metavar="FILE",
                   help="handed on to every process (rank 0 appends)")
    p.add_argument("--stage-profile", nargs="?", const=3, type=int,
                   default=None, metavar="N",
                   help="handed on to every process (every rank runs the "
                        "profile's programs)")
    p.add_argument("--explain", action="store_true",
                   help="forwarded to every process's driver")
    p.add_argument("--auto-tune", nargs="?", const="", default=None,
                   metavar="HISTORY",
                   help="handed on to every process (the driver's "
                        "history-driven pre-sizing)")
    p.add_argument("--verify-integrity", action="store_true",
                   help="handed on to every process (the drivers' one "
                        "verified join after the timed loop)")
    p.add_argument("--guard-deadline-s", type=float, default=None,
                   metavar="S", help="handed on to every process")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the command to launch (after --)")
    args = p.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command:
        p.error("no command given (append: -- <command> [args...])")
    for flag, dest, takes_value in FORWARDED_CHILD_FLAGS:
        value = getattr(args, dest)
        if value is None or value is False or any(
                c == flag or c.startswith(flag + "=") for c in args.command):
            continue
        args.command += [flag, str(value)] if takes_value else [flag]
    if args.num_processes < 1:
        p.error("--num-processes must be >= 1")
    if args.cpu_devices_per_process not in (None, 1):
        p.error("--cpu-devices-per-process: the port runs one rank a "
                "process; only 1 (gloo on the CPU) is accepted")
    return args


def _env_for(args, pid: int) -> dict:
    env = dict(os.environ)
    env[ENV_COORDINATOR] = args.coordinator
    env[ENV_NUM_PROCESSES] = str(args.num_processes)
    env[ENV_PROCESS_ID] = str(pid)
    if args.cpu_devices_per_process is not None:
        env[ENV_CPU_DEVICES] = str(args.cpu_devices_per_process)
    return env


def _check_cards(n: int) -> None:
    """NCCL: one process a card, so this host needs ``n`` cards."""
    import torch

    cards = torch.cuda.device_count()
    if cards < n:
        raise SystemExit(
            f"launch: {n} NCCL processes need {n} CUDA devices on this "
            f"host and {cards} are visible (two ranks on one card are not "
            "NCCL: use --communicator emulated; for gloo on the CPU pass "
            "--cpu-devices-per-process 1)")


def _stop(procs) -> None:
    for q in procs:
        if q.poll() is None:
            q.terminate()
    end = time.monotonic() + TERMINATE_GRACE_S
    for q in procs:
        try:
            q.wait(max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            q.kill()
            q.wait()


def run(args) -> int:
    if args.process_id is not None:
        os.execvpe(args.command[0], args.command,
                   _env_for(args, args.process_id))
    if args.cpu_devices_per_process is None:
        _check_cards(args.num_processes)
    # a terminated launcher still stops its processes (the finally below)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    procs = []
    try:
        for pid in range(args.num_processes):
            procs.append(subprocess.Popen(args.command,
                                          env=_env_for(args, pid)))
        live = list(procs)
        while live:
            for q in list(live):
                code = q.poll()
                if code is None:
                    continue
                live.remove(q)
                if code:
                    rank = procs.index(q)
                    print(f"launch: process {rank} exited with rc={code} "
                          f"(command: {' '.join(args.command)})",
                          file=sys.stderr, flush=True)
                    _stop(live)
                    return code if 0 < code < 256 else 1
            if live:
                time.sleep(0.05)
    finally:
        _stop(procs)
    return 0


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
