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
from distributed_join_tpu_torch.table import Table

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


def global_table(comm, table: Table) -> Table:
    """Every rank's rows of a row-sharded result. Under a process group
    ``spmd`` hands each process its own rank's part, so the parts are
    all-gathered (every rank's part has the same capacity); an
    in-process communicator's result holds every rank's rows already."""
    if not isinstance(comm, ProcessGroupCommunicator):
        return table
    return Table({n: comm.all_gather(c) for n, c in table.columns.items()},
                 comm.all_gather(table.valid))


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


def resolve_sort_mode(args, n_ranks: int, k: int, b_local: int,
                      p_local: int, shuffle_factor: float, shuffle: str,
                      n_slices: int = 1, dcn_codec: str = "auto",
                      compression_bits=None, kernel_config=None) -> str:
    """The drivers' ``--sort-mode`` (JAX :654-691): ``flat`` and
    ``segmented`` pass as they are (the step refuses what does not
    combine); ``auto`` is ``segmented`` exactly when
    ``resolve_sort_segments`` would segment this shape and the
    combination runs: never over the ragged or compressed wire, with
    kernel flags, or on a multi-slice mesh with the DCN codec on. Unset
    is ``flat``."""
    from distributed_join_tpu_torch.ops.segmented import (
        resolve_sort_segments,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        resolve_dcn_codec,
    )

    mode = getattr(args, "sort_mode", None) or "flat"
    if mode != "auto":
        return mode
    if (shuffle == "ragged" or n_ranks * k <= 1
            or compression_bits is not None or kernel_config is not None):
        return "flat"
    if (shuffle == "hierarchical" and n_slices > 1
            and resolve_dcn_codec(dcn_codec or "auto", n_slices)):
        return "flat"
    segs = resolve_sort_segments(getattr(args, "sort_segments", None),
                                 max(b_local, p_local), n_ranks, k,
                                 shuffle_factor)
    return "segmented" if segs > 1 else "flat"
