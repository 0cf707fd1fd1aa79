"""Headline benchmark of the port — one JSON line.

    python -m distributed_join_tpu_torch.bench

The protocol of the JAX package's ``bench.py`` (``_run``): tables from
seed 42, 10 M build x 10 M probe rows, selectivity 0.3, the radix
hash-partition -> shuffle -> sort-merge inner join pipeline over every
visible rank (one GPU: the single-bucket path, which joins directly),
timed over ``--iters`` joins after a warm-up. Two output sizings, both
in the line:

- ``value``: the output block sized from the expected match count
  (0.6 per row) plus 25% slack;
- ``value_capacity_contract``: the general contract,
  out_capacity_factor (1.2) x probe rows.

Overflow escalates through the capacity ladder (``retry`` records the
trail) instead of crashing. ``unit`` is M rows/sec per GPU, rows being
build + probe rows per join. ``vs_baseline`` stays null: the port has
no GPU baseline yet. ``--device cpu`` runs the same protocol on the CPU
for rehearsals at small ``--nrows``; its times say nothing about a GPU.
``--sort-mode`` and ``--sort-segments`` pick the local sort as the JAX
``bench.py`` does (:354-382); the headline is one bucket, where both
modes are the flat program. ``--telemetry``, ``--trace``, ``--diagnose``,
``--history`` and ``--guard-deadline-s`` run it through
``benchmarks.run_guarded``, as the drivers; with a session on, the line
carries its summary under ``telemetry``, and without one it is
unchanged. ``--stage-profile N`` profiles the match-sized program stage
by stage after both timed loops (``benchmarks.maybe_stage_profile``;
the line's ``stage_profile``). ``--auto-tune[=HISTORY]`` pre-sizes both
ladders from the protocol's own history (JAX ``bench.py`` :349-435:
capacities and the rung label only, ``benchmarks.tuned_driver_record``);
the line carries its workload identity and ``tuned``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.benchmarks import (
    add_auto_tune_arg,
    add_guard_arg,
    add_telemetry_args,
    maybe_stage_profile,
    refuse_trace_with_profile,
    resolve_sort_mode,
    resolve_tuner,
    run_guarded,
    stamp_record,
    tuned_driver_record,
)
from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.parallel.communicator import (
    LocalCommunicator,
)
from distributed_join_tpu_torch.parallel.distributed_join import (
    DEFAULT_OUT_CAPACITY_FACTOR,
    DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    make_join_step,
)
from distributed_join_tpu_torch.parallel.faults import CapacityLadder
from distributed_join_tpu_torch.utils.benchmarking import (
    profile_join,
    timed_join_throughput,
)
from distributed_join_tpu_torch.utils.generators import (
    generate_build_probe_tables,
)

SEED = 42
NROWS = 10_000_000
SELECTIVITY = 0.3
MATCHES_PER_ROW = 0.6
OUT_SLACK = 1.25
ITERS = 8
AUTO_RETRY = 2


def gpu_identity() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"device_name": name, "power_limit": limit, "nvidia_smi": line}


def _sort_opts(sort_mode, sort_segments, nrows: int, n_ranks: int) -> dict:
    """The join options of ``--sort-mode`` (``auto`` resolved as the
    drivers resolve it); ``{}`` for the flat sort."""
    mode = resolve_sort_mode(
        argparse.Namespace(sort_mode=sort_mode, sort_segments=sort_segments),
        n_ranks, 1, nrows // n_ranks, nrows // n_ranks,
        DEFAULT_SHUFFLE_CAPACITY_FACTOR, "padded")
    if mode == "flat":
        return {}
    return {"sort_mode": mode, "sort_segments": sort_segments}


def run(nrows: int = NROWS, iters: int = ITERS, device=None,
        sort_mode=None, sort_segments=None, args=None) -> dict:
    """The headline protocol; returns the record (also what main
    prints). ``args``: the parsed flags, for ``--stage-profile`` and
    ``--auto-tune``."""
    dev = resolve_device(device)
    comm = LocalCommunicator()
    n_ranks = comm.n_ranks
    sort_opts = _sort_opts(sort_mode, sort_segments, nrows, n_ranks)
    # the workload identity (history.WORKLOAD_KEYS) the line carries, so
    # that a --history entry and the --auto-tune lookup key alike
    workload = {k: v for k, v in {
        "benchmark": "bench",
        "n_ranks": n_ranks,
        "build_table_nrows": nrows,
        "probe_table_nrows": nrows,
        "selectivity": SELECTIVITY,
        "sort_mode": sort_opts.get("sort_mode"),
        "sort_segments": sort_opts.get("sort_segments"),
    }.items() if v is not None}
    tuned_sizing, tuned_rung, tuned_rec = {}, 0, None
    tuner = resolve_tuner(args) if args is not None else None
    if tuner is not None:
        tuned_sizing, tuned_rung, tuned_rec = tuned_driver_record(
            tuner, workload)
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=nrows, probe_nrows=nrows,
        selectivity=SELECTIVITY, device=dev)
    expected = int(MATCHES_PER_ROW * nrows)

    def measure(out_rows_per_rank=None):
        # the match-sized variant keeps its own output size over a tuned
        # one
        ladder = CapacityLadder(
            shuffle_capacity_factor=tuned_sizing.get(
                "shuffle_capacity_factor", DEFAULT_SHUFFLE_CAPACITY_FACTOR),
            out_capacity_factor=tuned_sizing.get(
                "out_capacity_factor", DEFAULT_OUT_CAPACITY_FACTOR),
            out_rows_per_rank=(
                out_rows_per_rank if out_rows_per_rank is not None
                else tuned_sizing.get("out_rows_per_rank")),
            compression_bits=tuned_sizing.get("compression_bits"),
            base_rung=tuned_rung)
        for attempt in range(AUTO_RETRY + 1):
            step = make_join_step(comm, key="key", **sort_opts,
                                  **ladder.sizing())
            per_join, total, overflow = timed_join_throughput(
                comm, step, build, probe, iters)
            ladder.note(overflow)
            if not overflow:
                break
            if attempt < AUTO_RETRY:
                ladder.escalate()
        if total <= 0 or overflow:
            raise RuntimeError(
                ("join overflowed after ladder exhaustion" if overflow
                 else "join produced zero matches") + ": " + json.dumps(
                    {"total": total, "retry": ladder.report().as_record()}))
        rate = 2 * nrows / per_join / 1e6 / n_ranks
        return (rate, per_join, total, ladder.report().as_record(),
                ladder.sizing())

    match_out = int(expected * OUT_SLACK / n_ranks)
    value, sec_match, matches, retry_match, sizing_match = measure(
        match_out)
    contract, sec_contract, _, retry_contract, _ = measure()
    # the match-sized program at its settled rung, stage by stage (an
    # untimed side pass after both timed loops)
    stage_rec = maybe_stage_profile(args, comm, build, probe,
                                    dict(key="key", **sort_opts,
                                         **sizing_match))
    record = {
        **workload,
        "metric": "join throughput",
        "value": value,
        "value_capacity_contract": contract,
        "unit": "M rows/sec/GPU",
        "vs_baseline": None,
        "ms_per_join": {"match_sized": sec_match * 1e3,
                        "capacity_contract": sec_contract * 1e3},
        "matches_per_join": matches,
        "n_ranks": n_ranks,
        "build_table_nrows": nrows,
        "probe_table_nrows": nrows,
        "selectivity": SELECTIVITY,
        "sort_mode": sort_opts.get("sort_mode"),
        "sort_segments": sort_opts.get("sort_segments"),
        "iterations": iters,
        "tuned": tuned_rec,
        "out_rows": {"match_sized": match_out * n_ranks,
                     "contract": "out_capacity_factor=1.2 x probe rows"},
        "retry": {"match_sized": retry_match,
                  "capacity_contract": retry_contract},
        "stage_profile": stage_rec,
        "device": str(dev),
    }
    if dev.type == "cuda":
        record.update(gpu_identity())
        record["device_name_torch"] = torch.cuda.get_device_name(dev)
    return record


def profile(nrows: int = NROWS, joins: int = 3, top: int = 15) -> dict:
    """Where a match-sized headline join spends its device time
    (``utils.benchmarking.profile_join``), with the card's identity."""
    dev = resolve_device(None)
    comm = LocalCommunicator()
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=nrows, probe_nrows=nrows,
        selectivity=SELECTIVITY, device=dev)
    step = make_join_step(
        comm, key="key",
        out_rows_per_rank=int(MATCHES_PER_ROW * nrows * OUT_SLACK))
    return {**profile_join(step, build, probe, joins, top),
            **gpu_identity()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nrows", type=int, default=NROWS,
                   help="rows per side (the headline is 10 M)")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' only for rehearsals")
    p.add_argument("--profile", type=int, default=0, metavar="JOINS",
                   help="instead of the record, print where JOINS "
                        "match-sized joins spend their device time "
                        "(torch.profiler; GPU only)")
    p.add_argument("--sort-mode", choices=["flat", "segmented", "auto"],
                   default=None,
                   help="the local sort (default flat; one bucket is the "
                        "flat program in every mode)")
    p.add_argument("--sort-segments", type=int, default=None, metavar="N",
                   help="segments of --sort-mode segmented")
    add_telemetry_args(p)
    add_guard_arg(p)
    add_auto_tune_arg(p)
    args = p.parse_args(argv)
    refuse_trace_with_profile(p, args)
    return run_guarded(_main, args, "bench")


def _main(args) -> dict:
    if args.profile:
        record = profile(args.nrows, args.profile)
    else:
        record = run(args.nrows, args.iters, args.device, args.sort_mode,
                     args.sort_segments, args=args)
    if telemetry.enabled():
        stamp_record(record)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    sys.exit(main())
