"""The wire digests over a process group, one process a rank: verified
against unverified joins on every wire, and a corruption caught.

    python -m distributed_join_tpu_torch.benchmarks.launch \\
        --num-processes 4 -- python3 scripts/integrity_nccl.py \\
        [--rows N] [--reps R] [--communicator nccl|gloo]

Every rank makes the same global tables (seed 42, ``N`` rows a rank on
each side, stored in key order so the 16-bit codec packs them) and joins
its own rows at over-decomposition 4 through one program cache a wire:
padded, ppermute, compressed at 16 bits, ragged, and with 4 ranks the
2 x 2 hierarchy with the cross-slice codec. For each wire: one verified
join (its report: ok, ``2 n^2`` pairs) whose rows on every rank equal the
unverified join's (rows and wrapping sum of the row digests), then the
verified and the unverified ms a join, each the median over ``R`` joins
of the slowest rank's host clock from a barrier to its own synchronised
end, and on a card each join's CUDA kernels and their device ms
(``torch.profiler`` over one more join of each; rank 0's; NCCL's kernels
count the time they wait for their peers, so the device ms are no split
of the join's own work). Last, the
padded wire under ``FaultPlan(bit_flip, budget 1)`` with
``auto_retry=2`` (the ``retry_integrity`` trail, the clean rows) and an
unbounded budget (``IntegrityError`` on every rank). Rank 0 prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

WIRES = (
    ("padded", 1, {}),
    ("ppermute", 1, {"shuffle": "ppermute"}),
    ("compressed16", 1, {"compression_bits": 16}),
    ("ragged", 1, {"shuffle": "ragged"}),
    ("hier2x2_codec", 2, {"shuffle": "hierarchical", "dcn_codec": "on"}),
)


def _clustered(t):
    """``t`` stored in key order, each payload the row id: the layout the
    16-bit codec packs (``chip_smoke.clustered``)."""
    from distributed_join_tpu_torch.table import Table

    order = torch.argsort(t.columns["key"], stable=True)
    cols = {name: (torch.arange(order.numel(), dtype=c.dtype,
                                device=c.device)
                   if name.endswith("payload") else c[order])
            for name, c in t.columns.items()}
    return Table(cols, t.valid[order])


def _settled(opts: dict, res) -> dict:
    """``opts`` at the sizing ``res``'s ladder settled at, without the
    ladder: the timed joins run the settled rung alone."""
    last = res.retry_report.attempts[-1]
    out = {k: v for k, v in opts.items() if k != "auto_retry"}
    out.update(shuffle_capacity_factor=last.shuffle_capacity_factor,
               out_capacity_factor=last.out_capacity_factor)
    if last.compression_bits is not None:
        out["compression_bits"] = last.compression_bits
    return out


def _kernels(fn) -> tuple:
    """``(CUDA kernels, their device ms)`` of one call of ``fn``, by
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == cuda]
    return (sum(e.count for e in events),
            sum(e.device_time_total for e in events) / 1e3)


def _digest(res) -> list:
    from distributed_join_tpu_torch.parallel import integrity

    t = res.table
    rd = integrity.row_digests(t.columns)[t.valid]
    return [int(t.valid.sum()), int(rd.sum())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="rows a rank on each side")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--communicator", default="nccl",
                    choices=["nccl", "gloo"])
    args = ap.parse_args(argv)

    from distributed_join_tpu_torch.benchmarks import rank_device
    from distributed_join_tpu_torch.parallel import bootstrap
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )
    from distributed_join_tpu_torch.parallel.integrity import IntegrityError
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    bootstrap.maybe_initialize_from_env()
    flat = make_communicator(args.communicator)
    n, me = flat.n_ranks, flat.axis_index()
    dev = rank_device(flat)
    build, probe = (_clustered(t)
                    for t in generate_build_probe_tables(
                        seed=42, build_nrows=args.rows * n,
                        probe_nrows=args.rows * n, device=dev))
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def wall_ms(comm, fn) -> float:
        walls = []
        for _ in range(args.reps):
            comm.barrier()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(comm.host_max(time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    out = {"ranks": n, "rows_a_rank": args.rows, "wires": {}}
    comms = {1: flat}
    if n == 4:
        comms[2] = make_communicator(args.communicator, n_slices=2)
    for label, slices, opts in WIRES:
        if slices not in comms:
            continue
        comm = comms[slices]
        cache = JoinProgramCache(comm)
        opts = dict(opts, over_decomposition=4, auto_retry=2)

        def plain(comm=comm, cache=cache, opts=opts):
            return distributed_inner_join(build, probe, comm,
                                          program_cache=cache, **opts)

        def verified(comm=comm, cache=cache, opts=opts):
            return distributed_inner_join(build, probe, comm,
                                          program_cache=cache,
                                          verify_integrity=True, **opts)

        res_p, res_v = plain(), verified()
        attempts = res_v.retry_report.n_attempts
        if attempts > 1:
            # time the settled rung alone
            opts = _settled(opts, res_v)
            res_p, res_v = plain(opts=opts), verified(opts=opts)
        rep = res_v.integrity_report
        same = _digest(res_v) == _digest(res_p)
        if not (rep.ok and rep.checked_pairs == 2 * n * n and same
                and not bool(res_v.overflow)):
            raise SystemExit(f"rank {me} {label}: report "
                             f"{rep.as_record()}, rows equal: {same}")
        ms_p = wall_ms(comm, lambda: plain(opts=opts))
        ms_v = wall_ms(comm, lambda: verified(opts=opts))
        out["wires"][label] = {
            "checked_pairs": rep.checked_pairs,
            "total": int(res_v.total),
            "ladder_attempts": attempts,
            "unverified_ms": ms_p, "verified_ms": ms_v,
            "ratio": ms_v / ms_p}
        if on_card:
            for way, fn in (("unverified", plain), ("verified", verified)):
                k, dms = _kernels(lambda fn=fn: fn(opts=opts))
                out["wires"][label][f"{way}_cuda_kernels"] = k
                out["wires"][label][f"{way}_device_ms"] = dms
        del res_p, res_v

    plan = FaultPlan(seed=5, corrupt_mode="bit_flip", corrupt_collectives=1)
    faulty = FaultInjectingCommunicator(flat, plan)
    res = distributed_inner_join(build, probe, faulty, over_decomposition=4,
                                 verify_integrity=True, auto_retry=2)
    trail = [a.action for a in res.retry_report.attempts]
    clean = _digest(distributed_inner_join(build, probe, flat,
                                           over_decomposition=4))
    if trail != ["initial", "retry_integrity"] or _digest(res) != clean:
        raise SystemExit(f"rank {me}: bit_flip budget 1: trail {trail}")
    try:
        distributed_inner_join(
            build, probe, FaultInjectingCommunicator(flat, FaultPlan(
                seed=5, corrupt_mode="bit_flip",
                corrupt_collectives=1 << 30)),
            over_decomposition=4, verify_integrity=True)
        raise SystemExit(f"rank {me}: an unbounded budget returned rows")
    except IntegrityError as exc:
        pairs = len(exc.report.mismatches)
    out["corruption"] = {"mode": "bit_flip", "budget_1_trail": trail,
                         "unbounded_mismatched_pairs": pairs}
    if on_card:
        out["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    if me == 0:
        print(json.dumps(out), flush=True)
    bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
