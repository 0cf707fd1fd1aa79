"""All-to-all shuffle microbenchmark: the reference's
``benchmark/all_to_all``, the second BASELINE metric (shuffle GB/s).

    python -m distributed_join_tpu_torch.benchmarks.launch \\
        --num-processes 4 -- python -m \\
        distributed_join_tpu_torch.benchmarks.all_to_all \\
        --communicator nccl --buffer-size 268435456

Port of ``distributed_join_tpu/benchmarks/all_to_all.py``: each rank
holds a ``--buffer-size`` float32 buffer, split into one block a peer;
``--iterations`` chained exchanges (each adds 1 and the loop counter to
the last one's result, so none can be skipped) make one window, timed
from a barrier to the end of the slowest rank (CUDA events; the host
clock on the CPU). After a warm-up window, ``WINDOWS`` windows run;
the record's time is their median, and the headline lists every
window. Each window's checksum is fetched once, after its timing, and
checked against the same arithmetic on the global buffer: an exchange
only moves values, so the sum of every rank's result is known without
it. Summed as int64 (every value is an integer in float32), the check
is exact.

Bandwidth: each rank sends ``(n - 1) / n`` of its buffer off its device
an exchange (its own block stays), so ``aggregate_offchip_gb_per_sec`` =
n x that egress / time; ``aggregate_gb_per_sec_incl_local`` counts the
whole buffer, as the reference does.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from distributed_join_tpu_torch.benchmarks import (
    UNPORTED_FLAGS,
    rank_device,
    refuse_flags,
    report,
)
from distributed_join_tpu_torch.parallel.bootstrap import (
    maybe_initialize_from_env,
    shutdown,
)
from distributed_join_tpu_torch.parallel.communicator import make_communicator

_REFUSED = {
    "--explain": "plan explain",
    "--platform": "platform selection (the benchmark runs on the GPU)",
    "--auto-tune": "the tuner",
    "--stage-profile": "the stage profile",
    "--sort-mode": "the segmented-sort pipeline",
    **UNPORTED_FLAGS,
}

# Timed windows a run; one window alone has read 3.4x another on the
# same cards, so the record takes their median.
WINDOWS = 5


def parse_args(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    refuse_flags(p, argv, _REFUSED)
    p.add_argument("--buffer-size", type=int, default=64 * 1024 * 1024,
                   help="bytes in each rank's send buffer (split across "
                        "peers), reference-style fixed-size exchange")
    p.add_argument("--communicator", default="nccl",
                   choices=["nccl", "gloo"])
    p.add_argument("--iterations", type=int, default=20,
                   help="chained exchanges in a timed window")
    p.add_argument("--json-output", default=None)
    return p.parse_args(argv)


def chained_exchanges(comm, x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` chained all-to-alls of each rank's rows of ``x`` (one
    block a peer), returning the replicated int64 sum of every rank's
    result; run under ``comm.spmd``."""
    n = comm.n_ranks
    y = x.reshape(n, -1)
    for i in range(iters):
        y = comm.all_to_all(y + 1) + i
    return comm.psum(y.to(torch.int64).sum())


def expected_checksum(x: torch.Tensor, iters: int) -> int:
    """The checksum of :func:`chained_exchanges` on the global buffer
    ``x``: the same float32 arithmetic, with no exchange."""
    y = x
    for i in range(iters):
        y = (y + 1) + i
    return int(y.to(torch.int64).sum())


def timed_window(comm, fn, x: torch.Tensor) -> tuple[float, int]:
    """One window: ``fn(x)`` from a barrier to its end, in seconds on
    the slowest rank, and its checksum, fetched after the timing."""
    on_gpu = x.device.type == "cuda"
    if on_gpu:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    comm.barrier()
    if on_gpu:
        start.record()
    t0 = time.perf_counter()
    checksum = fn(x)
    if on_gpu:
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
    else:
        sec = time.perf_counter() - t0
    return comm.host_max(sec), int(checksum)


def run(args, device=None) -> tuple[dict, list]:
    """The benchmark's record, and the ms an exchange of each window
    (for the headline only: the record keeps the JAX benchmark's
    keys)."""
    comm = make_communicator(args.communicator)
    n = comm.n_ranks
    if n < 2:
        raise SystemExit(
            "all_to_all needs >= 2 ranks: launch one process a card on a "
            "machine with two cards or more, or gloo processes on the CPU "
            "(--cpu-devices-per-process 1)")
    dev = rank_device(comm, device)
    elems = args.buffer_size // 4  # float32 lanes
    elems -= elems % n
    iters = args.iterations
    x = torch.arange(n * elems, dtype=torch.float32, device=dev)
    fn = comm.spmd(lambda xr: chained_exchanges(comm, xr, iters),
                   sharded_out=True)
    want = expected_checksum(x, iters)
    window_s = []
    for w in range(WINDOWS + 1):   # window 0 warms up
        sec, checksum = timed_window(comm, fn, x)
        if checksum != want:
            raise SystemExit(f"all_to_all: checksum {checksum} != {want}: "
                             "the exchange lost or changed values")
        if w:
            window_s.append(sec / iters)
    sec = statistics.median(window_s)

    bytes_per_rank = elems * 4
    egress = bytes_per_rank * (n - 1) / n
    record = {
        "benchmark": "all_to_all",
        "communicator": comm.name,
        "n_ranks": n,
        "buffer_bytes_per_rank": bytes_per_rank,
        "integrity": None,
        "explain": None,
        "chaos_seed": None,
        "elapsed_per_exchange_s": sec,
        "aggregate_offchip_gb_per_sec": n * egress / sec / 1e9,
        "aggregate_gb_per_sec_incl_local": n * bytes_per_rank / sec / 1e9,
    }
    return record, [w * 1e3 for w in window_s]


def main(argv=None) -> int:
    args = parse_args(argv)
    maybe_initialize_from_env()
    record, window_ms = run(args)
    report(record, args.json_output, headline=(
        f"all-to-all: {record['n_ranks']} ranks x "
        f"{record['buffer_bytes_per_rank'] / 1e6:.1f} MB in "
        f"{record['elapsed_per_exchange_s'] * 1e3:.3f} ms -> "
        f"{record['aggregate_offchip_gb_per_sec']:.2f} GB/s off-chip "
        f"({record['aggregate_gb_per_sec_incl_local']:.2f} GB/s incl. "
        f"local block); median of {WINDOWS} windows of "
        f"{args.iterations} exchanges, ms an exchange: "
        + " ".join(f"{ms:.4f}" for ms in window_ms)))
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
