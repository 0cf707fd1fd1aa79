"""Distributed-join benchmark driver of the port.

    python -m distributed_join_tpu_torch.benchmarks.distributed_join \\
        --communicator local --build-table-nrows 50000000 \\
        --probe-table-nrows 50000000 --zipf-alpha 1.5 \\
        --hh-out-capacity 48000000

Port of ``distributed_join_tpu/benchmarks/distributed_join.py``
(``parse_args`` :61, ``run`` :250) with the reference's flag names and
only the options the port has (the wires ``--shuffle padded|ppermute|
ragged|hierarchical`` with ``--slices`` and ``--dcn-codec``,
``--compression``, the local sort ``--sort-mode flat|segmented|auto``
with ``--sort-ab N``, the aggregate pushdown's ``--agg-ab N`` and the
resident build table's ``--resident-ab N``):
generate the tables from seed 42 (the
Zipf probe side from seed 43; ``--key-type``/``--payload-type``, the
composite and string tables of config 5, and ``--string-key-bytes`` as
in the JAX driver), resolve the skew auto-policy, then time
``--iterations`` dependent joins per ladder rung (``utils/benchmarking``:
a warm-up run, CUDA events, one synchronisation) and print one JSON
record. ``--telemetry``, ``--trace``, ``--history`` and
``--guard-deadline-s`` are the JAX driver's (``benchmarks.run_guarded``);
with a session on, one untimed join with the metrics tape follows the
timed loop (``benchmarks.collect_join_metrics``) and the ``--sort-ab``
and ``--agg-ab`` records carry their counter signatures (and the
segmented plan's ``wire_exact``); ``--explain`` writes the timed
program's plan (``planning.build_plan``) to ``explain.json``;
``--stage-profile N`` profiles the timed program stage by stage after
the timed loop (``benchmarks.maybe_stage_profile``: the record's
``stage_profile``, and ``stageprofile.json``), refusing up front the
skew sidecar, string keys and the ragged wire's string columns, which
do not segment; ``--diagnose`` reads the session back after the run.
``--auto-tune[=HISTORY]`` (JAX :432-480) pre-sizes the ladder from the
workload's history (``benchmarks.tuned_driver_record``: capacities and
the rung label only) and the record carries ``tuned``.
``--verify-integrity`` (JAX :572-687) runs one untimed join with the wire
digests at the final rung after the timed loop
(``benchmarks.collect_integrity``): the record's ``integrity``, and a
mismatch fails the run.
Every other flag of the JAX driver refuses by name.

Skew auto-policy (JAX :359-405): with ``--zipf-alpha`` and no
``--skew-threshold``, the skew path runs at threshold 0.001 with the
heavy-hitter probe and output blocks pre-sized from alpha by the top-K
mass model (``parallel/skew.zipf_top_k_mass``); ``--skew-threshold 0``
forces the naive path. An explicit threshold keeps the generic HH
defaults (probe block 1/8, output block 1/4 of the local probe rows).

Communicators: ``local`` (one rank), ``emulated`` (``--n-ranks`` threads
in one process, on one device), and ``nccl`` or ``gloo`` over a process
group, one process a rank, started by the launcher::

    python -m distributed_join_tpu_torch.benchmarks.launch \
        --num-processes 4 -- python -m \
        distributed_join_tpu_torch.benchmarks.distributed_join \
        --communicator nccl --build-table-nrows 40000000 \
        --probe-table-nrows 40000000 --over-decomposition-factor 4

Under a process group every process builds the same global tables from
the seed and joins its own rows (JAX :300-351); rank 0 prints the record.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.bench import gpu_identity
from distributed_join_tpu_torch.benchmarks import (
    UNPORTED_FLAGS,
    add_auto_tune_arg,
    add_explain_arg,
    add_guard_arg,
    add_integrity_arg,
    add_telemetry_args,
    collect_integrity,
    collect_join_metrics,
    explain_summary,
    maybe_stage_profile,
    write_explain,
    global_table,
    rank_device,
    refuse_flags,
    refuse_trace_with_profile,
    report,
    resolve_sort_mode,
    resolve_tuner,
    run_guarded,
    tuned_driver_record,
)
from distributed_join_tpu_torch.ops.aggregate import (
    AggregatePushdownUnsupported,
    AggregateSpec,
    aggregate_oracle,
    frames_equal,
    group_reduce_frame,
    groups_frame,
)
from distributed_join_tpu_torch.ops.hashing import hash_columns
from distributed_join_tpu_torch.ops.segmented import resolve_sort_segments
from distributed_join_tpu_torch.parallel.bootstrap import (
    is_coordinator,
    shutdown,
)
from distributed_join_tpu_torch.parallel.communicator import (
    ProcessGroupCommunicator,
    make_communicator,
)
from distributed_join_tpu_torch.parallel.distributed_join import (
    DEFAULT_HH_SLOTS,
    DEFAULT_OUT_CAPACITY_FACTOR,
    DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    JOIN_SHARDED_OUT,
    SHUFFLE_MODES,
    _varwidth_cols,
    make_distributed_join,
    make_join_step,
    resolve_join_ladder,
)
from distributed_join_tpu_torch.planning.cost import resolve_dcn_bits
from distributed_join_tpu_torch.planning.plan import build_plan
from distributed_join_tpu_torch.telemetry.baselines import counter_signature
from distributed_join_tpu_torch.parallel.skew import zipf_top_k_mass
from distributed_join_tpu_torch.service.programs import JoinProgramCache
from distributed_join_tpu_torch.service.resident import (
    ResidentError,
    ResidentTableRegistry,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils.benchmarking import (
    profile_join,
    timed_join_throughput,
)
from distributed_join_tpu_torch.utils.generators import (
    generate_build_probe_tables,
    generate_build_table,
    generate_composite_build_probe_tables,
    generate_zipf_probe_table,
)
from distributed_join_tpu_torch.utils.strings import (
    LEN_SUFFIX,
    encode_int_strings,
)
from distributed_join_tpu_torch.utils.tpch_host import _key_ids, inner_match

SEED = 42
ZIPF_SEED = 43
DEFAULT_SKEW_THRESHOLD = 0.001
DTYPES = {
    "int32": torch.int32,
    "int64": torch.int64,
    "float32": torch.float32,
    "float64": torch.float64,
}

# Flags of the JAX driver that the port does not have.
_REFUSED = {
    "--expand-kernel": "the kernel knobs",
    "--compact-kernel": "the kernel knobs",
    "--kernel-block": "the kernel knobs",
    "--platform": "platform selection (the driver runs on the GPU)",
    **UNPORTED_FLAGS,
}


def parse_args(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    refuse_flags(p, argv, _REFUSED)
    p.add_argument("--communicator",
                   choices=["local", "emulated", "nccl", "gloo"],
                   default="local",
                   help="local = one rank; emulated = --n-ranks ranks in "
                        "one process, one thread each, on one device; "
                        "nccl / gloo = one process a rank, under the "
                        "launcher (benchmarks/launch.py)")
    p.add_argument("--n-ranks", type=int, default=None,
                   help="ranks of the emulated communicator; with nccl or "
                        "gloo it must equal the process group's size")
    p.add_argument("--key-type", choices=DTYPES, default="int64")
    p.add_argument("--payload-type", choices=DTYPES, default="int64")
    p.add_argument("--build-table-nrows", type=int, default=1_000_000)
    p.add_argument("--probe-table-nrows", type=int, default=1_000_000)
    p.add_argument("--selectivity", type=float, default=0.3)
    p.add_argument("--rand-max", type=int, default=None,
                   help="key range [0, rand-max); default build-table-nrows")
    p.add_argument("--duplicate-build-keys", action="store_true",
                   help="draw build keys with replacement (default: unique)")
    p.add_argument("--zipf-alpha", type=float, default=None,
                   help="draw probe keys Zipf(alpha) (BASELINE config 3)")
    p.add_argument("--skew-threshold", type=float, default=None,
                   help="heavy-hitter handling: a key is heavy when its "
                        "global probe count exceeds this fraction of one "
                        "rank's probe rows; with --zipf-alpha it defaults "
                        "on (0.001, HH blocks pre-sized from alpha); 0 "
                        "forces the naive path")
    p.add_argument("--hh-slots", type=int, default=DEFAULT_HH_SLOTS)
    p.add_argument("--hh-build-capacity", type=int, default=None,
                   help="HH build rows per rank (default hh-slots * 32)")
    p.add_argument("--hh-probe-capacity", type=int, default=None,
                   help="HH probe block rows per rank (default 1/8 of "
                        "the local probe rows)")
    p.add_argument("--hh-out-capacity", type=int, default=None,
                   help="HH output rows per rank (default 1/4 of the "
                        "local probe rows)")
    p.add_argument("--key-columns", type=int, default=1,
                   help=">1 joins on a composite multi-column key "
                        "(BASELINE config 5)")
    p.add_argument("--string-payload-bytes", type=int, default=0,
                   help="attach a fixed-width string payload of this "
                        "many bytes to the build side (config 5)")
    p.add_argument("--string-payload-columns", type=int, default=1,
                   help="number of string payload columns")
    p.add_argument("--variable-length-strings", action="store_true",
                   help="render string payload ids without leading "
                        "zeros, so row lengths vary")
    p.add_argument("--string-key-bytes", type=int, default=0,
                   help="join on a fixed-width STRING key of this many "
                        "bytes (derived from the int key; packed-word "
                        "composite-key machinery)")
    p.add_argument("--over-decomposition-factor", type=int, default=1)
    p.add_argument("--shuffle", choices=SHUFFLE_MODES, default="padded",
                   help="the wire: padded = capacity-padded blocks, one "
                        "all-to-all; ppermute = the same blocks as a chain "
                        "of point-to-point steps; ragged = the exact-size "
                        "exchange, string payloads byte-exact; "
                        "hierarchical = the padded blocks in two hops, "
                        "intra-slice then cross-slice (--slices)")
    p.add_argument("--slices", type=int, default=None,
                   help="slice count of the hierarchical (slice, chip) "
                        "mesh; must divide the rank count (e.g. 4 ranks "
                        "as --slices 2 = 2 x 2)")
    p.add_argument("--dcn-codec", choices=["off", "auto", "on"],
                   default="auto",
                   help="FoR + bit-pack codec on the cross-slice hop of "
                        "--shuffle hierarchical (width --compression-bits); "
                        "auto resolves from the JAX package's cost model, "
                        "which the port does not have, and refuses on "
                        "more than one slice")
    p.add_argument("--sort-mode", choices=["flat", "segmented", "auto"],
                   default=None,
                   help="the local sort: flat = one merged sort a batch; "
                        "segmented = fine buckets from the shuffle, "
                        "joined as one batch of short runs; auto = "
                        "segmented where resolve_sort_segments segments "
                        "this shape and the wire allows it (default flat)")
    p.add_argument("--sort-segments", type=int, default=None, metavar="N",
                   help="segments per (batch, rank) receive of the "
                        "segmented sort (default: resolve_sort_segments)")
    p.add_argument("--sort-ab", type=int, default=0, metavar="N",
                   help="after the timed run: time N warm segmented joins "
                        "and N warm flat joins of the same tables (CUDA "
                        "events), graded against each other (totals, row "
                        "digests) and, on local and emulated ranks, the "
                        "numpy oracle; the record under 'sort_ab'. "
                        "Shapes the segmented path refuses skip with the "
                        "reason")
    p.add_argument("--agg-ab", type=int, default=0, metavar="N",
                   help="after the timed run: time N warm fused "
                        "join+aggregate (pushdown) calls against N warm "
                        "materialize-then-host-group-by passes of the "
                        "same query (group by the join key, count and a "
                        "sum of each side's first scalar payload), both "
                        "graded against the numpy group-by oracle; the "
                        "record under 'agg_ab'. Shapes the pushdown "
                        "refuses (string keys, the skew sidecar) skip "
                        "with the reason")
    p.add_argument("--resident-ab", type=int, default=0, metavar="N",
                   help="after the timed run: register the build table as "
                        "a resident image (service/resident.py) and time N "
                        "warm probe-only joins against N warm full joins of "
                        "the same query (host clock around a synchronised "
                        "call), graded by equal totals and row digests; the "
                        "record under 'resident_ab' (the warm probe-only "
                        "joins must build no program). Shapes the resident "
                        "tables refuse skip with the reason")
    p.add_argument("--compression", action="store_true",
                   help="FoR + bit-pack the integer columns on the padded "
                        "or ppermute wire")
    p.add_argument("--compression-bits", type=int, default=16,
                   help="packed residual width for --compression "
                        "(2/4/8/16/32; --auto-retry widens it on overflow)")
    p.add_argument("--shuffle-capacity-factor", type=float,
                   default=DEFAULT_SHUFFLE_CAPACITY_FACTOR)
    p.add_argument("--out-capacity-factor", type=float,
                   default=DEFAULT_OUT_CAPACITY_FACTOR)
    p.add_argument("--auto-retry", type=int, default=0,
                   help="on overflow, escalate capacities and re-time, up "
                        "to this many times; the trail lands under 'retry'")
    p.add_argument("--iterations", type=int, default=4,
                   help="timed dependent join steps")
    p.add_argument("--json-output", default=None,
                   help="also write the record to this file")
    p.add_argument("--registration-method", default=None,
                   help="accepted for the reference CLI's sake and "
                        "ignored: NCCL registers its own buffers (the JAX "
                        "driver ignores it too)")
    p.add_argument("--profile", type=int, default=0, metavar="JOINS",
                   help="instead of the record, print where JOINS joins at "
                        "the first rung's sizing spend their device time "
                        "(torch.profiler; GPU only)")
    add_telemetry_args(p)
    add_explain_arg(p)
    add_guard_arg(p)
    add_auto_tune_arg(p)
    add_integrity_arg(p)
    args = p.parse_args(argv)
    refuse_trace_with_profile(p, args)
    return args


def _communicator(args):
    if (args.slices or 1) > 1 and args.shuffle != "hierarchical":
        raise SystemExit(
            f"--slices {args.slices} builds a multi-slice mesh, and "
            f"--shuffle {args.shuffle} would route one global collective "
            "across its slow tier: pass --shuffle hierarchical (or drop "
            "--slices)")
    try:
        return make_communicator(args.communicator, n_ranks=args.n_ranks,
                                 n_slices=args.slices)
    except (ValueError, RuntimeError) as exc:
        raise SystemExit(f"--communicator {args.communicator} "
                         f"(--n-ranks {args.n_ranks}, --slices "
                         f"{args.slices}): {exc}") from exc


def skew_policy(args, n_ranks: int):
    """``(skew_threshold, hh_probe_capacity, hh_out_capacity, policy
    record)`` as the JAX driver resolves them."""
    threshold = args.skew_threshold
    hh_probe = args.hh_probe_capacity
    hh_out = args.hh_out_capacity
    if threshold is not None and threshold <= 0:
        return None, hh_probe, hh_out, None
    if args.zipf_alpha is None or threshold is not None:
        return threshold, hh_probe, hh_out, None
    domain = args.rand_max or args.build_table_nrows
    f_top = zipf_top_k_mass(args.zipf_alpha, domain, args.hh_slots)
    p_local = args.probe_table_nrows // n_ranks
    if hh_probe is None:
        # 1.3x slack over the expected HH mass, never beyond the rank's
        # own rows (HH probe rows stay local)
        hh_probe = min(p_local, int(1.3 * f_top * p_local) + 1024)
    if hh_out is None and not args.duplicate_build_keys:
        # one match per HH probe row against unique build keys; 2x for
        # moderate duplication. With duplicate build keys the model has
        # no bound, and the generic default sizes the block.
        hh_out = min(int(1.3 * p_local), int(2.6 * f_top * p_local) + 1024)
    return DEFAULT_SKEW_THRESHOLD, hh_probe, hh_out, {
        "auto": True,
        "top_k_mass": round(f_top, 4),
        "hh_probe_capacity": hh_probe,
        "hh_out_capacity": hh_out,
        "hh_out_generic_fallback": hh_out is None,
    }


def make_tables(args, dev):
    """The driver's tables on ``dev`` and the join key: uniform hit/miss
    probe keys of ``--key-type``; with ``--key-columns`` > 1 or
    ``--string-payload-bytes`` the composite config-5 tables (int64 keys
    only); with ``--zipf-alpha`` a Zipf probe side (seed 43); then with
    ``--string-key-bytes`` the key rendered as a fixed-width string."""
    b_rows, p_rows = args.build_table_nrows, args.probe_table_nrows
    rand_max = args.rand_max or b_rows
    key_dtype = DTYPES[args.key_type]
    payload_dtype = DTYPES[args.payload_type]
    join_key = "key"
    if args.key_columns > 1 or args.string_payload_bytes > 0:
        if args.zipf_alpha is not None:
            raise SystemExit("--key-columns/--string-payload-bytes do not "
                             "combine with --zipf-alpha yet")
        if args.key_type != "int64":
            raise SystemExit("composite keys currently use int64 columns")
        build, probe, key_names = generate_composite_build_probe_tables(
            seed=SEED, build_nrows=b_rows, probe_nrows=p_rows,
            key_columns=args.key_columns, rand_max=args.rand_max,
            selectivity=args.selectivity,
            string_payload_len=args.string_payload_bytes,
            string_payload_columns=args.string_payload_columns,
            variable_length_strings=args.variable_length_strings,
            unique_build_keys=not args.duplicate_build_keys, device=dev)
        join_key = key_names if args.key_columns > 1 else key_names[0]
    elif args.zipf_alpha is None:
        build, probe = generate_build_probe_tables(
            seed=SEED, build_nrows=b_rows, probe_nrows=p_rows,
            rand_max=args.rand_max, selectivity=args.selectivity,
            key_dtype=key_dtype, payload_dtype=payload_dtype,
            unique_build_keys=not args.duplicate_build_keys, device=dev)
    else:
        gb = torch.Generator(device=dev)
        gb.manual_seed(SEED)
        gp = torch.Generator(device=dev)
        gp.manual_seed(ZIPF_SEED)
        build = generate_build_table(
            gb, b_rows, rand_max, key_dtype=key_dtype,
            payload_dtype=payload_dtype,
            unique_keys=not args.duplicate_build_keys)
        probe = generate_zipf_probe_table(
            gp, p_rows, args.zipf_alpha, rand_max, key_dtype=key_dtype,
            payload_dtype=payload_dtype)
    if args.string_key_bytes > 0:
        build, probe, join_key = _stringify_key(build, probe, join_key,
                                                args.string_key_bytes)
    return build, probe, join_key


def _stringify_key(build, probe, join_key, nbytes):
    """Replace the (single, int) join key with a fixed-width string
    rendering of it, ``'itm-'`` + zero-padded digits, with its '#len'
    companion: the JAX driver's string-key join (JAX :1051)."""
    if not isinstance(join_key, str):
        raise SystemExit("--string-key-bytes needs a single key column")
    digits = nbytes - 4
    if digits < 1:
        raise SystemExit("--string-key-bytes must be >= 5 ('itm-' + d)")
    out = []
    for t in (build, probe):
        b, ln = encode_int_strings(t.columns[join_key], prefix="itm-",
                                   digits=digits)
        cols = {k: v for k, v in t.columns.items() if k != join_key}
        cols["skey"] = b
        cols["skey" + LEN_SUFFIX] = ln
        out.append(Table(cols, t.valid))
    return out[0], out[1], "skey"


def string_wire_bytes(build, shuffle: str) -> dict | None:
    """The JAX driver's ``_string_wire_accounting`` (JAX :214): for every
    2-D uint8 build column with a '#len' companion and a width divisible
    by 4, the bytes its rows take at fixed width and on the byte-exact
    wire (lengths rounded up to 4); ``byte_exact_on_wire`` says whether
    ``shuffle`` is the ragged wire, which ships the latter."""
    names = _varwidth_cols(build)
    if not names:
        return None
    per_col, fixed_total, exact_total = {}, 0, 0
    for name in names:
        col = build.columns[name]
        lens = build.columns[name + LEN_SUFFIX].to(torch.int64)
        fixed = int(col.shape[0]) * int(col.shape[1])
        exact = int(((lens + 3) // 4 * 4).sum())
        per_col[name] = {"fixed_width_bytes": fixed, "exact_bytes": exact}
        fixed_total += fixed
        exact_total += exact
    return {
        "columns": per_col,
        "fixed_width_bytes": fixed_total,
        "exact_bytes": exact_total,
        "savings_pct": round(100.0 * (1 - exact_total / fixed_total), 2)
        if fixed_total else 0.0,
        "byte_exact_on_wire": shuffle == "ragged",
    }


def compression_bits(args, n_slices: int = 1):
    """The codec's width when ``--compression`` is on, or when the
    hierarchical wire's cross-slice codec is (more than one slice and
    ``--dcn-codec on``), else None."""
    dcn = (args.shuffle == "hierarchical"
           and resolve_dcn_bits(args.dcn_codec, n_slices=n_slices))
    return args.compression_bits if args.compression or dcn else None


def workload_identity(args, n_ranks: int, n_slices: int, threshold,
                      sort_mode: str) -> dict:
    """The run's workload identity (``history.WORKLOAD_KEYS``, non-None
    only) with the record's own values: what ``--auto-tune`` looks up and
    what ``history.run_entry`` hashes for the record."""
    segmented = sort_mode != "flat"
    return {k: v for k, v in {
        "benchmark": "distributed_join",
        "n_ranks": n_ranks,
        "build_table_nrows": args.build_table_nrows,
        "probe_table_nrows": args.probe_table_nrows,
        "selectivity": args.selectivity,
        "shuffle": args.shuffle,
        "key_type": args.key_type,
        "payload_type": args.payload_type,
        "key_columns": args.key_columns,
        "over_decomposition_factor": args.over_decomposition_factor,
        "slices": n_slices if n_slices > 1 else None,
        "dcn_codec": (args.dcn_codec if args.shuffle == "hierarchical"
                      else None),
        "zipf_alpha": args.zipf_alpha,
        "skew_threshold": threshold,
        "string_payload_bytes": args.string_payload_bytes,
        "string_key_bytes": args.string_key_bytes,
        "sort_mode": sort_mode if segmented else None,
        "sort_segments": args.sort_segments if segmented else None,
    }.items() if v is not None}


def _prepare(args, device):
    """The communicator, the device (``rank_device``), the tables, the
    ladder at its first rung, the join options it leaves fixed, the
    skew policy and the ``--auto-tune`` record (None without the flag).
    The peak device memory is counted from here, before the tables."""
    comm = _communicator(args)
    dev = rank_device(comm, device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n = comm.n_ranks
    try:
        bits = compression_bits(args, comm.n_slices)
    except NotImplementedError as exc:
        raise SystemExit(f"--dcn-codec {args.dcn_codec}: {exc}") from exc
    b_rows, p_rows = args.build_table_nrows, args.probe_table_nrows
    if b_rows % n or p_rows % n:
        raise SystemExit(f"table nrows must be divisible by n_ranks={n}")
    if args.shuffle == "ragged" and args.string_payload_bytes % 4:
        # the byte-exact wire ships u32 planes (JAX :295)
        raise SystemExit("--string-payload-bytes must be a multiple of 4 "
                         "in ragged mode (u32-plane byte-exact wire)")
    if args.shuffle == "ragged" and args.compression:
        raise SystemExit("--compression applies to the padded and ppermute "
                         "wires; the ragged wire already sends exact rows")
    gen_t0 = time.perf_counter()
    build, probe, join_key = make_tables(args, dev)
    telemetry.span_complete("generate", gen_t0,
                            time.perf_counter() - gen_t0,
                            build_nrows=b_rows, probe_nrows=p_rows)
    threshold, hh_probe, hh_out, policy = skew_policy(args, n)
    k = args.over_decomposition_factor
    sort_mode = resolve_sort_mode(
        args, n, k, b_rows // n, p_rows // n, args.shuffle_capacity_factor,
        args.shuffle, n_slices=comm.n_slices, dcn_codec=args.dcn_codec,
        compression_bits=bits)
    opts = dict(shuffle_capacity_factor=args.shuffle_capacity_factor,
                out_capacity_factor=args.out_capacity_factor,
                compression_bits=bits,
                skew_threshold=threshold, hh_slots=args.hh_slots,
                hh_build_capacity=args.hh_build_capacity,
                hh_probe_capacity=hh_probe, hh_out_capacity=hh_out)
    # --auto-tune: the ladder pre-sized from this workload's history,
    # looked up under its pre-tuned identity (JAX :432-528). Tuned bits
    # only widen a codec the run asked for, and the heavy-hitter blocks
    # apply only with the skew path on.
    tuned_rung, tuned_rec = 0, None
    tuner = resolve_tuner(args)
    if tuner is not None:
        tuned_sizing, tuned_rung, tuned_rec = tuned_driver_record(
            tuner, workload_identity(args, n, comm.n_slices, threshold,
                                     sort_mode))
        if tuned_sizing:
            print(f"auto-tune: pre-sizing from history rung "
                  f"{tuned_rung}: " + " ".join(
                      f"{k}={v}" for k, v in sorted(tuned_sizing.items())),
                  file=sys.stderr)
        for knob, value in tuned_sizing.items():
            if value is None or (knob == "compression_bits" and bits is None
                                 ) or (knob.startswith("hh_")
                                       and threshold is None):
                continue
            opts[knob] = value
    ladder = resolve_join_ladder(build, probe, n, opts,
                                 n_slices=comm.n_slices)
    ladder.seed_rung(tuned_rung)
    # --sort-segments alone (armed for a --sort-ab side pass) leaves the
    # timed flat join as it is
    fixed = dict(key=join_key, shuffle=args.shuffle,
                 dcn_codec=args.dcn_codec, over_decomposition=k,
                 sort_mode=sort_mode,
                 sort_segments=(args.sort_segments
                                if sort_mode == "segmented" else None),
                 **opts)
    return comm, dev, build, probe, ladder, fixed, policy, tuned_rec


def row_digest(table: Table) -> torch.Tensor:
    """An order-independent digest of a table's valid rows: the int64
    wrapping sum of each row's hash over every column (a 2-D column by
    its bytes)."""
    cols = []
    for c in table.columns.values():
        cols.extend(c.reshape(c.shape[0], -1).unbind(1) if c.ndim > 1
                    else [c])
    h = hash_columns(cols)
    return torch.where(table.valid, h, 0).sum()


def _host_rows(table: Table, names) -> np.ndarray:
    """The valid rows of ``table``'s ``names`` as a lexicographically
    sorted (rows, fields) int64 array (a 2-D column a field a byte,
    floats by their bits): a multiset in canonical order."""
    valid = table.valid.cpu().numpy()
    parts = []
    for nm in names:
        a = table.columns[nm].cpu().numpy()[valid]
        if a.dtype.kind == "f":
            a = a.view(np.int64 if a.itemsize == 8 else np.int32)
        parts.append(a.reshape(a.shape[0], -1).astype(np.int64))
    a = np.concatenate(parts, axis=1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def _oracle_rows(build: Table, probe: Table, keys, names) -> np.ndarray:
    """The inner join of the valid rows by numpy (the join the query
    oracle uses, ``utils/tpch_host.inner_match``), as :func:`_host_rows`
    gives a result: rows are matched on key ids (a composite or 2-D
    key's distinct rows numbered over both sides) and gathered by row
    index."""
    bv, pv = build.valid.cpu().numpy(), probe.valid.cpu().numpy()
    bk, pk = _key_ids(*({k: t.columns[k].cpu().numpy()[v] for k in keys}
                        for t, v in ((build, bv), (probe, pv))), keys)
    p_idx, b_idx, _ = inner_match(bk, pk)
    bi, pi = np.flatnonzero(bv)[b_idx], np.flatnonzero(pv)[p_idx]
    cols = {}
    for nm in names:
        side, idx = ((build, bi) if nm in build.columns else (probe, pi))
        cols[nm] = side.columns[nm][torch.from_numpy(np.array(idx)).to(
            side.device)]
    return _host_rows(Table(cols, torch.ones(len(bi), dtype=torch.bool,
                                             device=build.device)), names)


def sort_ab(comm, build, probe, n_joins: int, join_opts: dict, args):
    """The segmented sort against the flat one on the same join (JAX
    ``_sort_ab``, :901-1040): N warm joins of each mode, each timed
    alone (CUDA events on a card, the host clock on the CPU, the slowest
    rank's), min and median; graded by equal totals and equal row
    digests (``row_digest``, summed over ranks), and on local and
    emulated ranks against the numpy oracle. Shapes the segmented path
    refuses skip with the reason. Both modes' programs come from one
    ``JoinProgramCache``, as in the JAX driver: the warm joins must build
    none (``warm_new_traces``). One untimed segmented join with the
    metrics tape gives the record's ``counter_signature``, and its wire
    bytes against the segmented plan's ``wire_exact`` (JAX :1010-1047)."""
    if join_opts.get("shuffle") == "ragged":
        return {"skipped": "ragged wire: the segmented path needs static "
                           "receive boundaries"}
    if join_opts.get("compression_bits") is not None:
        return {"skipped": "compressed wire: the codec's per-block framing "
                           "and the fine layout are disjoint"
                           + (" (the hierarchical DCN codec is armed: "
                              "rerun with --dcn-codec off)"
                              if join_opts.get("shuffle") == "hierarchical"
                              else "")}
    if join_opts.get("kernel_config") is not None:
        return {"skipped": "explicit kernel flags tune the flat pipeline; "
                           "the segmented path is the batched formulation"}
    n = comm.n_ranks
    k = join_opts.get("over_decomposition") or 1
    if n * k <= 1:
        return {"skipped": "single-bucket mesh: the segmented and flat "
                           "paths are the same program"}
    segs = resolve_sort_segments(
        args.sort_segments, max(build.capacity, probe.capacity) // n, n, k,
        join_opts.get("shuffle_capacity_factor")
        or DEFAULT_SHUFFLE_CAPACITY_FACTOR)
    if segs <= 1:
        return {"skipped": "segment resolution is 1 at this shape (flat "
                           "parity): pass --sort-segments N to force a "
                           "segmentation"}
    opts = {kk: v for kk, v in join_opts.items()
            if kk not in ("sort_mode", "sort_segments")}
    cache = JoinProgramCache(comm)

    def program(mode):
        def run_mode(b, p):
            fn, _ = cache.get(b, p, sort_mode=mode, sort_segments=(
                segs if mode == "segmented" else None), **opts)
            return fn(b, p)

        return run_mode

    fns = {mode: program(mode) for mode in ("flat", "segmented")}
    dev = build.device
    on_gpu = dev.type == "cuda"

    def timed(fn):
        if on_gpu:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
        comm.barrier()
        if on_gpu:
            start.record()
        t0 = time.perf_counter()
        out = fn(build, probe)
        if on_gpu:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        return out, comm.host_max(ms)

    warm = {mode: fn(build, probe) for mode, fn in fns.items()}
    warm = {mode: (res, _digest_of(comm, res.table))
            for mode, res in warm.items()}
    overflow = {mode: bool(res.overflow) for mode, (res, _) in warm.items()}
    if any(overflow.values()):
        return {"skipped": "overflow at this sizing: rerun with larger "
                           "capacity factors (a clamped A/B would time "
                           "partial answers)",
                "overflow_flat": overflow["flat"],
                "overflow_segmented": overflow["segmented"]}
    traces0 = cache.traces
    ms = {"flat": [], "segmented": []}
    for mode, fn in fns.items():
        for _ in range(n_joins):
            ms[mode].append(timed(fn)[1])
    warm_new_traces = cache.traces - traces0
    (flat, fd), (seg, sd) = warm["flat"], warm["segmented"]
    metrics = make_distributed_join(
        comm, with_metrics=True, sort_mode="segmented", sort_segments=segs,
        **opts)(build, probe).telemetry
    red = metrics.to_dict()["reduced"]
    plan = build_plan(comm, build, probe, with_metrics=True,
                      sort_mode="segmented", sort_segments=segs, **opts)
    rec = {
        "kind": "sort_ab",
        "n_joins": n_joins,
        "n_ranks": n,
        "over_decomposition_factor": k,
        "sort_segments": segs,
        "matches": int(seg.total),
        "matches_equal": int(seg.total) == int(flat.total),
        "digest_equal": sd == fd,
        "flat_ms_min": min(ms["flat"]),
        "flat_ms_median": statistics.median(ms["flat"]),
        "segmented_ms_min": min(ms["segmented"]),
        "segmented_ms_median": statistics.median(ms["segmented"]),
        "segmented_speedup": min(ms["flat"]) / min(ms["segmented"]),
        "flat_ms": ms["flat"],
        "segmented_ms": ms["segmented"],
        "warm_new_traces": warm_new_traces,
        "oracle_equal_flat": None,
        "oracle_equal_segmented": None,
        "wire_exact": all(plan.wire[side]["bytes_per_rank"] * n
                          == red.get(f"{side}.wire_bytes")
                          for side in ("build", "probe")),
        "plan_digest": plan.digest,
        "counter_signature": counter_signature(metrics),
    }
    if not isinstance(comm, ProcessGroupCommunicator):
        keys = ([join_opts["key"]] if isinstance(join_opts["key"], str)
                else list(join_opts["key"]))
        names = list(flat.table.columns)
        want = _oracle_rows(build, probe, keys, names)
        rec["oracle_equal_flat"] = bool(np.array_equal(
            _host_rows(flat.table, names), want))
        rec["oracle_equal_segmented"] = bool(np.array_equal(
            _host_rows(seg.table, names), want))
    return rec


def agg_ab(comm, build, probe, join_key, n_joins: int, join_opts: dict,
           args) -> dict:
    """The aggregate pushdown against materialize-then-reduce (JAX
    ``_agg_ab``, :788-889): one aggregate query, grouped by the join key
    (a count and a sum of each side's first scalar payload), answered
    two ways. A: the warm materializing join, its rows fetched to the
    host and grouped there (numpy). B: the warm fused pushdown, its
    groups fetched. N of each, each timed alone on the host clock (the
    fetch synchronises); both graded against the numpy oracle. Shapes
    the pushdown refuses skip with the reason. The pushdown's program
    comes from a ``JoinProgramCache``, as in the JAX driver: its warm
    calls must build none (``warm_pushdown_new_traces``). One untimed
    pushdown with the metrics tape gives the record's
    ``counter_signature`` (JAX :872-897)."""
    if args.string_key_bytes:
        return {"skipped": "string join keys: the fused pushdown covers "
                           "scalar keys"}
    if join_opts.get("skew_threshold") is not None:
        return {"skipped": "skew sidecar on: the fused pushdown refuses "
                           "the heavy-hitter path"}
    keys = [join_key] if isinstance(join_key, str) else list(join_key)

    def scalar_payload(t):
        return next((nm for nm, c in t.columns.items()
                     if nm not in keys and c.ndim == 1
                     and not nm.endswith(LEN_SUFFIX)), None)

    aggs = [("count", None, "n_rows")]
    for nm in (scalar_payload(build), scalar_payload(probe)):
        if nm is not None:
            aggs.append(("sum", nm, f"sum_{nm}"))
    spec = AggregateSpec.of(keys, aggs)
    opts = {k: v for k, v in join_opts.items() if k != "key"}

    cache = JoinProgramCache(comm)
    try:
        mat_fn = comm.spmd(make_join_step(comm, key=join_key, **opts),
                           sharded_out=JOIN_SHARDED_OUT)
        cache.get(build, probe, key=join_key, aggregate=spec, **opts)
    except AggregatePushdownUnsupported as exc:
        return {"skipped": str(exc)}

    def push_fn(b, p):
        fn, _ = cache.get(b, p, key=join_key, aggregate=spec, **opts)
        return fn(b, p)

    def run_materialize():
        # the workload consumes aggregates: side A's time includes
        # fetching the join's rows and grouping them on the host
        res = mat_fn(build, probe)
        return res, group_reduce_frame(
            global_table(comm, res.table).to_host(), spec)

    def run_pushdown():
        res = push_fn(build, probe)
        return res, groups_frame(global_table(comm, res.table), spec, keys)

    try:
        mat_res, _ = run_materialize()      # warm both
        push_res, _ = run_pushdown()
    except AggregatePushdownUnsupported as exc:
        return {"skipped": str(exc)}
    if bool(mat_res.overflow):
        return {"skipped": "materializing join overflowed at this sizing; "
                           "A-side frame would be partial — rerun with "
                           "larger capacity factors"}
    traces0 = cache.traces
    walls = {"materialize": [], "pushdown": []}
    for side, fn in (("materialize", run_materialize),
                     ("pushdown", run_pushdown)):
        for _ in range(n_joins):
            comm.barrier()
            t0 = time.perf_counter()
            res, frame = fn()
            walls[side].append(comm.host_max(time.perf_counter() - t0))
            if side == "materialize":
                mat_frame = frame
            else:
                push_res, push_frame = res, frame
    oracle = aggregate_oracle(build, probe, keys, spec)
    metrics = make_distributed_join(
        comm, key=join_key, with_metrics=True, aggregate=spec,
        **opts)(build, probe).telemetry
    mat_min, push_min = min(walls["materialize"]), min(walls["pushdown"])
    return {
        "kind": "agg_ab",
        "n_joins": n_joins,
        "n_ranks": comm.n_ranks,
        "spec": spec.as_record(),
        "matches": int(push_res.total),
        "groups": len(push_frame[keys[0]]),
        "overflow": bool(push_res.overflow),
        "materialize_wall_min_s": mat_min,
        "pushdown_wall_min_s": push_min,
        "pushdown_speedup": mat_min / push_min if push_min else None,
        "materialize_walls_s": walls["materialize"],
        "pushdown_walls_s": walls["pushdown"],
        "oracle_equal_pushdown": frames_equal(push_frame, oracle),
        "oracle_equal_materialize": frames_equal(mat_frame, oracle),
        "warm_pushdown_new_traces": cache.traces - traces0,
        "counter_signature": counter_signature(metrics),
    }


def _digest_of(comm, table: Table) -> int:
    """``row_digest`` of a result over every rank: a process group's
    ranks each hold their own rows."""
    d = row_digest(table)
    if isinstance(comm, ProcessGroupCommunicator):
        d = comm.psum(d)
    return int(d)


def resident_ab(comm, build, probe, join_key, n_joins: int,
                join_opts: dict) -> dict:
    """The resident build table against the full join (JAX
    ``_resident_ab``, :706-786): register the build table once, then N
    warm probe-only joins and N warm full joins of the same query at the
    same sizing, each timed alone on the host clock around a
    synchronised call (the slowest rank's); min per side. Graded by
    equal totals and equal row digests; the warm probe-only joins must
    build no program. Shapes the resident tables refuse skip with the
    reason."""
    if not isinstance(join_key, str):
        return {"skipped": "composite keys not yet resident"}
    if join_opts.get("shuffle") == "hierarchical":
        return {"skipped": "the probe-only program does not route "
                           "hierarchically yet — run --resident-ab on a "
                           "flat mesh"}
    dev = build.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        cache = JoinProgramCache(comm)
        registry = ResidentTableRegistry(comm, cache)
        comm.barrier()
        t0 = time.perf_counter()
        registry.register("driver_build", build, key=join_key)
        sync()
        register_s = comm.host_max(time.perf_counter() - t0)
    except ResidentError as exc:
        return {"skipped": f"{exc}"}
    sizing = {k: join_opts.get(k) for k in
              ("shuffle", "over_decomposition", "shuffle_capacity_factor",
               "out_capacity_factor", "out_rows_per_rank",
               "compression_bits", "kernel_config")
              if join_opts.get(k) is not None}
    cold_fn = comm.spmd(make_join_step(comm, **join_opts),
                        sharded_out=JOIN_SHARDED_OUT)

    def run_cold():
        return cold_fn(build, probe)

    def run_probe_only():
        return registry.join("driver_build", probe, **sizing)

    cold, po = run_cold(), run_probe_only()      # warm both programs
    digests = (_digest_of(comm, cold.table), _digest_of(comm, po.table))
    overflow = bool(cold.overflow) or bool(po.overflow)
    del cold, po
    traces0 = cache.traces
    walls = {"cold": [], "probe_only": []}
    matches = {}
    for side, fn in (("cold", run_cold), ("probe_only", run_probe_only)):
        for _ in range(n_joins):
            comm.barrier()
            t0 = time.perf_counter()
            res = fn()
            sync()
            walls[side].append(comm.host_max(time.perf_counter() - t0))
            matches[side] = int(res.total)
            del res
    cold_min, po_min = min(walls["cold"]), min(walls["probe_only"])
    return {
        "n_joins": n_joins,
        "register_s": register_s,
        "cold_wall_min_s": cold_min,
        "probe_only_wall_min_s": po_min,
        "probe_only_speedup": cold_min / po_min if po_min else None,
        "warm_probe_new_traces": cache.traces - traces0,
        "matches_cold": matches["cold"],
        "matches_probe_only": matches["probe_only"],
        "matches_equal": matches["cold"] == matches["probe_only"],
        "digest_equal": digests[0] == digests[1],
        "overflow": overflow,
        "cold_walls_s": walls["cold"],
        "probe_only_walls_s": walls["probe_only"],
        "resident": registry.stats()["tables"]["driver_build"],
    }


def run(args, device=None) -> dict:
    """The protocol; returns the record. ``device`` defaults to the
    rank's device (``rank_device``; ``"cpu"`` for rehearsals: its times
    say nothing of a GPU). The peak device memory covers the whole run,
    tables included."""
    if getattr(args, "stage_profile", None) and (
            args.string_key_bytes or args.zipf_alpha is not None
            or (args.skew_threshold or 0) > 0
            or (args.shuffle == "ragged" and args.string_payload_bytes)):
        # the stage profile's scope (telemetry/stageprof.py): refused
        # before the timed region runs, not after it (JAX :251-262)
        raise SystemExit(
            "--stage-profile supports the scalar-key, non-skew "
            "pipeline (any shuffle mode; ragged without string "
            "payload columns) — drop --zipf-alpha/--skew-threshold/"
            "--string-key-bytes, or profile the padded form")
    (comm, dev, build, probe, ladder, fixed, policy,
     tuned_rec) = _prepare(args, device)
    on_gpu = dev.type == "cuda"
    n = comm.n_ranks
    b_rows, p_rows = args.build_table_nrows, args.probe_table_nrows
    threshold = fixed["skew_threshold"]
    for attempt in range(args.auto_retry + 1):
        step = make_join_step(comm, **fixed, **ladder.sizing())
        before = comm.counters()
        sec, matches, overflow = timed_join_throughput(
            comm, step, build, probe, args.iterations, key=fixed["key"])
        ladder.note(overflow)
        if not overflow or attempt == args.auto_retry:
            break
        ladder.escalate()
    # the last rung's warm-up and timed joins; an in-process
    # communicator counts every rank's
    joins = 2 * args.iterations * (
        1 if isinstance(comm, ProcessGroupCommunicator) else n)
    per_join = {k: (v - before[k]) / joins
                for k, v in comm.counters().items()}
    # --telemetry: the device counters of one untimed join on the
    # unshifted tables, after the timed loop (which stays tape-off)
    # (the absolute rung label: a pre-sized run's counters carry the rung
    # it ran at)
    collect_join_metrics(comm, build, probe, dict(fixed, **ladder.sizing()),
                         attempt=ladder.base_rung + attempt)
    # --verify-integrity: one untimed join with the wire digests at the
    # final rung; a mismatch raises rather than report a throughput
    # computed from corrupt rows
    integ = (collect_integrity(comm, build, probe,
                               dict(fixed, **ladder.sizing()))
             if args.verify_integrity else None)
    explain_rec = None
    if args.explain:
        # the plan of the timed program (the final rung, tape off)
        doc = build_plan(comm, build, probe, with_metrics=False,
                         **fixed, **ladder.sizing()).explain_record()
        write_explain(args, doc)
        explain_rec = explain_summary(doc)
    # --stage-profile: the timed program at its final rung, stage by
    # stage (an untimed side pass)
    stage_rec = maybe_stage_profile(args, comm, build, probe,
                                    dict(fixed, **ladder.sizing()))

    rows_per_sec = (b_rows + p_rows) / sec
    record = {
        "benchmark": "distributed_join",
        "communicator": comm.name,
        "n_ranks": n,
        "key_type": args.key_type,
        "payload_type": args.payload_type,
        "build_table_nrows": b_rows,
        "probe_table_nrows": p_rows,
        "selectivity": args.selectivity,
        "duplicate_build_keys": args.duplicate_build_keys,
        "over_decomposition_factor": args.over_decomposition_factor,
        "shuffle": args.shuffle,
        # normalized as the JAX driver's record: set only where they
        # change the program
        "slices": comm.n_slices if comm.n_slices > 1 else None,
        # whether the slices are the job's nodes (else both hops stay
        # inside one node)
        "slices_are_nodes": (comm.hier.real_topology
                             if comm.n_slices > 1 else None),
        "dcn_codec": (args.dcn_codec if args.shuffle == "hierarchical"
                      else None),
        "compression_bits": (args.compression_bits if args.compression
                             else None),
        "sort_mode": (fixed["sort_mode"] if fixed["sort_mode"] != "flat"
                      else None),
        "sort_segments": (args.sort_segments
                          if fixed["sort_mode"] != "flat" else None),
        "zipf_alpha": args.zipf_alpha,
        "skew_threshold": threshold,
        "skew_policy": policy,
        "hh_slots": args.hh_slots if threshold is not None else None,
        "key_columns": args.key_columns,
        "string_payload_bytes": args.string_payload_bytes,
        "string_payload_columns": args.string_payload_columns,
        "variable_length_strings": args.variable_length_strings,
        "string_key_bytes": args.string_key_bytes,
        "string_wire_bytes": string_wire_bytes(build, args.shuffle),
        "iterations": args.iterations,
        "matches_per_join": matches,
        "overflow": overflow,
        "retry": ladder.report().as_record(),
        "tuned": tuned_rec,
        "integrity": integ,
        "elapsed_per_join_s": sec,
        "rows_per_sec": rows_per_sec,
        "m_rows_per_sec_per_rank": rows_per_sec / 1e6 / n,
        # a rank's data-plane rows and bytes handed to the exchange and
        # its host reads, a join (counted on the host)
        "wire_rows_per_join": per_join["wire_rows"],
        "wire_bytes_per_join": per_join["wire_bytes"],
        "host_reads_per_join": per_join["host_reads"],
        # the hierarchical wire's bytes on each tier, and what its
        # cross-slice codec saved
        "wire_bytes_ici_per_join": per_join["wire_bytes_ici"],
        "wire_bytes_dcn_per_join": per_join["wire_bytes_dcn"],
        "wire_bytes_saved_per_join": per_join["wire_bytes_saved"],
        "explain": explain_rec,
        "stage_profile": stage_rec,
        "agg_ab": (agg_ab(comm, build, probe, fixed["key"], args.agg_ab,
                          dict(fixed, **ladder.sizing()), args)
                   if args.agg_ab > 0 else None),
        "sort_ab": (sort_ab(comm, build, probe, args.sort_ab,
                            dict(fixed, **ladder.sizing()), args)
                    if args.sort_ab > 0 else None),
        "resident_ab": (resident_ab(comm, build, probe, fixed["key"],
                                    args.resident_ab,
                                    dict(fixed, **ladder.sizing()))
                        if args.resident_ab > 0 else None),
        "device": str(dev),
    }
    if on_gpu:
        record.update(gpu_identity())
        record["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return record


def profile(args, device=None) -> dict | None:
    """Where ``args.profile`` joins at the first rung's sizing spend
    their device time (``utils.benchmarking.profile_join``), on rank 0;
    the other ranks of a process group join unprofiled and return
    None."""
    comm, _, build, probe, ladder, fixed, policy, _ = _prepare(args, device)
    fn = comm.spmd(make_join_step(comm, **fixed, **ladder.sizing()),
                   sharded_out=JOIN_SHARDED_OUT)
    prof = profile_join(fn, build, probe, args.profile,
                        record=is_coordinator())
    if prof is None:
        return None
    return {"communicator": comm.name, "n_ranks": comm.n_ranks,
            "shuffle": args.shuffle, "slices": args.slices,
            "sort_mode": fixed["sort_mode"],
            "sort_segments": fixed["sort_segments"],
            "over_decomposition_factor": args.over_decomposition_factor,
            "compression_bits": (args.compression_bits if args.compression
                                 else None),
            "zipf_alpha": args.zipf_alpha,
            "skew_threshold": fixed["skew_threshold"], "skew_policy": policy,
            "build_table_nrows": args.build_table_nrows,
            "probe_table_nrows": args.probe_table_nrows,
            **prof, **gpu_identity()}


def _main(args):
    record = profile(args) if args.profile else run(args)
    if record is not None:
        report(record, args.json_output)
    return record


def main(argv=None) -> int:
    args = parse_args(argv)
    # the handshake (and, under NCCL, the choice of this rank's card)
    # comes first inside the guarded run, before any tensor
    rc = run_guarded(_main, args, "distributed_join")
    shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
