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

``--verify-integrity`` (JAX :59-88, :147-176) runs one untimed exchange
of the same buffer with the wire digests after the timed windows: each
rank's per-(source, destination) digests of the blocks it sent and
received ride one step-end all-gather on a metrics tape, under
``wire.integrity``, and the record's ``integrity`` is the report (a
mismatch raises ``IntegrityError``).

Flags as the JAX benchmark's: ``--n-ranks`` must equal the process
group's size where given (with ``--communicator emulated``, the ranks of
one process, one thread each, on one device); ``--sort-mode flat`` and ``--sort-segments``
are taken (the microbenchmark has no local sort), any other sort mode
refuses with the JAX message, as do ``--stage-profile`` (the exchange
is one stage) and ``--auto-tune`` (no capacity to pre-size); ``--telemetry``, ``--trace``, ``--diagnose``,
``--history`` and ``--guard-deadline-s`` run through
``benchmarks.run_guarded``; ``--explain`` writes the exchange's plan and
the cost model's prediction (``planning.build_exchange_plan``); the
other JAX flags refuse by name.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from distributed_join_tpu_torch.benchmarks import (
    UNPORTED_FLAGS,
    add_auto_tune_arg,
    add_explain_arg,
    add_guard_arg,
    add_integrity_arg,
    add_telemetry_args,
    explain_summary,
    write_explain,
    rank_device,
    refuse_flags,
    report,
    run_guarded,
)
from distributed_join_tpu_torch.parallel.bootstrap import shutdown
from distributed_join_tpu_torch.parallel.communicator import make_communicator

_REFUSED = {
    "--platform": "platform selection (the benchmark runs on the GPU)",
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
                   choices=["nccl", "gloo", "emulated"],
                   help="nccl / gloo: one process a rank under the "
                        "launcher; emulated: --n-ranks ranks in one "
                        "process, one thread each, on one device")
    p.add_argument("--n-ranks", type=int, default=None,
                   help="ranks of the exchange; must equal the process "
                        "group's size (default: the group's size); "
                        "required with emulated")
    p.add_argument("--iterations", type=int, default=20,
                   help="chained exchanges in a timed window")
    p.add_argument("--json-output", default=None)
    p.add_argument("--sort-mode", choices=["flat", "segmented", "auto"],
                   default=None,
                   help="taken for the join drivers' command line's sake: "
                        "flat only (the microbenchmark has no local sort)")
    p.add_argument("--sort-segments", type=int, default=None, metavar="N",
                   help="taken for the join drivers' command line's sake; "
                        "never read")
    add_telemetry_args(p)
    add_explain_arg(p)
    add_guard_arg(p)
    add_auto_tune_arg(p)
    add_integrity_arg(p)
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


def verified_exchange(comm, x: torch.Tensor) -> dict:
    """One exchange of the benchmark buffer with the wire digests
    (untimed, after the timed windows): each rank digests the blocks it
    sends and the blocks it receives (``integrity.padded_block_digests``,
    every block full), and the pairs ride one step-end all-gather on a
    metrics tape under ``wire.integrity``: the join shuffles' integrity
    channel on the raw wire. Returns the report's record; a mismatch
    raises ``integrity.IntegrityError``. A fault-injecting
    communicator's corruption budget is rearmed first, as
    ``benchmarks.collect_integrity`` does."""
    from distributed_join_tpu_torch.parallel import integrity
    from distributed_join_tpu_torch.telemetry.metrics import MetricsTape

    n = comm.n_ranks
    rearm = getattr(comm, "rearm_corruption", None)
    if rearm is not None:
        rearm()

    def exchange(xr):
        buf = xr.reshape(n, -1)
        full = torch.full((n,), buf.shape[1], dtype=torch.int32,
                          device=buf.device)
        sent = integrity.padded_block_digests({"buf": buf}, full)
        recv = integrity.padded_block_digests({"buf": comm.all_to_all(buf)},
                                              full)
        tape = MetricsTape()
        integrity.record_pair_digests(tape.scoped("wire.integrity"), sent,
                                      recv)
        return tape.gathered(comm, buf.device)

    report = integrity.verify_digests(
        comm.spmd(exchange, sharded_out=True)(x))
    if not report.ok:
        raise integrity.IntegrityError(report)
    return report.as_record()


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
    if getattr(args, "auto_tune", None) is not None:
        # one fixed-size exchange has no join knobs to tune (JAX :93-97)
        raise SystemExit(
            "--auto-tune applies to the join drivers; the all_to_all "
            "microbenchmark has no capacity contract to pre-size")
    if getattr(args, "stage_profile", None):
        raise SystemExit(
            "--stage-profile needs the multi-stage join pipeline; "
            "this microbenchmark IS one shuffle stage — its timed "
            "wall already answers per-stage timing")
    if getattr(args, "sort_mode", None) not in (None, "flat"):
        raise SystemExit(
            "--sort-mode selects the join's LOCAL sort pipeline; "
            "this microbenchmark has no local sort")
    try:
        comm = make_communicator(args.communicator, n_ranks=args.n_ranks)
    except (ValueError, RuntimeError) as exc:
        raise SystemExit(f"--communicator {args.communicator} "
                         f"(--n-ranks {args.n_ranks}): {exc}") from exc
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
    # --verify-integrity: one untimed exchange of the same buffer with
    # the digests; the timed windows stay the plain program
    integ = verified_exchange(comm, x) if args.verify_integrity else None

    bytes_per_rank = elems * 4
    egress = bytes_per_rank * (n - 1) / n
    explain_rec = None
    if args.explain:
        from distributed_join_tpu_torch.planning.plan import (
            build_exchange_plan,
        )

        doc = build_exchange_plan(n, bytes_per_rank)
        write_explain(args, doc)
        explain_rec = explain_summary(doc)
    record = {
        "benchmark": "all_to_all",
        "communicator": comm.name,
        "n_ranks": n,
        "buffer_bytes_per_rank": bytes_per_rank,
        "integrity": integ,
        "explain": explain_rec,
        "chaos_seed": None,
        "elapsed_per_exchange_s": sec,
        "aggregate_offchip_gb_per_sec": n * egress / sec / 1e9,
        "aggregate_gb_per_sec_incl_local": n * bytes_per_rank / sec / 1e9,
    }
    return record, [w * 1e3 for w in window_s]


def _main(args) -> dict:
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
    return record


def main(argv=None) -> int:
    args = parse_args(argv)
    rc = run_guarded(_main, args, "all_to_all")
    shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
