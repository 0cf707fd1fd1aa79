"""Benchmark drivers of the port, and what they share: the record stamp,
rank-0-only reporting and the refusal of the JAX drivers' flags the port
does not have (port of ``distributed_join_tpu/benchmarks/__init__.py``
``stamp_record`` :20 and ``report`` :59)."""

from __future__ import annotations

import json

import torch

from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.parallel.bootstrap import (
    is_coordinator,
    process_id,
)
from distributed_join_tpu_torch.parallel.communicator import (
    ProcessGroupCommunicator,
)

# The JAX package's record layout version (its optional telemetry block
# is not part of the port).
SCHEMA_VERSION = 2

# Telemetry and robustness flags of every JAX driver and of its launcher.
UNPORTED_FLAGS = {
    "--telemetry": "telemetry",
    "--trace": "telemetry",
    "--history": "telemetry",
    "--diagnose": "telemetry",
    "--verify-integrity": "wire-integrity digests",
    "--chaos-seed": "chaos injection",
    "--guard-deadline-s": "the watchdog",
}


def refuse_flags(parser, argv, refused: dict) -> None:
    """``parser.error`` naming the first flag of ``argv`` in ``refused``
    (flag -> what the port lacks)."""
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in refused:
            parser.error(f"{flag}: {refused[flag]} is not part of the port")


def rank_device(comm, device=None) -> torch.device:
    """Where a driver's tensors live: ``device`` when given, else the
    rank's own device under a process group (its card under NCCL, the
    CPU under gloo), else the GPU (``resolve_device``)."""
    if device is None and isinstance(comm, ProcessGroupCommunicator):
        return comm.device
    return resolve_device(device)


def stamp_record(record: dict) -> dict:
    """``schema_version`` and ``rank`` on every record (mutated and
    returned)."""
    record.setdefault("schema_version", SCHEMA_VERSION)
    record.setdefault("rank", process_id())
    return record


def report(record: dict, json_output: str | None,
           headline: str | None = None) -> None:
    """Stamp ``record``; on rank 0 only, print the headline (if any) and
    the record as one JSON line, and write it to ``json_output``. Other
    ranks print nothing to stdout, so the line a caller parses is never
    interleaved."""
    stamp_record(record)
    if not is_coordinator():
        return
    line = json.dumps(record)
    if json_output:
        with open(json_output, "w") as f:
            f.write(line + "\n")
    if headline:
        print(headline)
    print(line, flush=True)
