"""Distributed-join benchmark driver of the port.

    python -m distributed_join_tpu_torch.benchmarks.distributed_join \\
        --communicator local --build-table-nrows 50000000 \\
        --probe-table-nrows 50000000 --zipf-alpha 1.5 \\
        --hh-out-capacity 48000000

Port of ``distributed_join_tpu/benchmarks/distributed_join.py``
(``parse_args`` :61, ``run`` :250) with the reference's flag names and
only the options the port has: generate the tables from seed 42 (the
Zipf probe side from seed 43; ``--key-type``/``--payload-type``, the
composite and string tables of config 5, and ``--string-key-bytes`` as
in the JAX driver), resolve the skew auto-policy, then time
``--iterations`` dependent joins per ladder rung (``utils/benchmarking``:
a warm-up run, CUDA events, one synchronisation) and print one JSON
record. Every other flag of the JAX driver refuses by name.

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
import sys

import torch

from distributed_join_tpu_torch.bench import gpu_identity
from distributed_join_tpu_torch.benchmarks import (
    UNPORTED_FLAGS,
    rank_device,
    refuse_flags,
    report,
)
from distributed_join_tpu_torch.parallel.bootstrap import (
    is_coordinator,
    maybe_initialize_from_env,
    shutdown,
)
from distributed_join_tpu_torch.parallel.communicator import (
    make_communicator,
)
from distributed_join_tpu_torch.parallel.distributed_join import (
    DEFAULT_HH_SLOTS,
    DEFAULT_OUT_CAPACITY_FACTOR,
    DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    JOIN_SHARDED_OUT,
    make_join_step,
    resolve_join_ladder,
)
from distributed_join_tpu_torch.parallel.skew import zipf_top_k_mass
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
    "--shuffle": "the ragged, ppermute and hierarchical shuffles",
    "--slices": "the hierarchical mesh",
    "--dcn-codec": "the hierarchical DCN codec",
    "--registration-method": "RDMA registration",
    "--compression": "the compressed wire",
    "--compression-bits": "the compressed wire",
    "--expand-kernel": "the kernel knobs",
    "--compact-kernel": "the kernel knobs",
    "--kernel-block": "the kernel knobs",
    "--agg-ab": "the A/B modes",
    "--sort-ab": "the A/B modes",
    "--resident-ab": "the A/B modes",
    "--sort-mode": "the segmented-sort pipeline",
    "--sort-segments": "the segmented-sort pipeline",
    "--platform": "platform selection (the driver runs on the GPU)",
    "--explain": "plan explain",
    "--stage-profile": "the stage profile",
    "--auto-tune": "the tuner",
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
    p.add_argument("--profile", type=int, default=0, metavar="JOINS",
                   help="instead of the record, print where JOINS joins at "
                        "the first rung's sizing spend their device time "
                        "(torch.profiler; GPU only)")
    return p.parse_args(argv)


def _communicator(args):
    try:
        return make_communicator(args.communicator, n_ranks=args.n_ranks)
    except (ValueError, RuntimeError) as exc:
        raise SystemExit(f"--communicator {args.communicator} "
                         f"(--n-ranks {args.n_ranks}): {exc}") from exc


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


def string_wire_bytes(build) -> dict | None:
    """The JAX driver's ``_string_wire_accounting`` (JAX :214): for every
    2-D uint8 build column with a '#len' companion and a width divisible
    by 4, the bytes its rows take on the padded wire (fixed width) and
    what a byte-exact wire would take (lengths rounded up to 4). The
    port's wire is the padded one, so ``byte_exact_on_wire`` is False."""
    names = [n for n, c in build.columns.items()
             if c.ndim == 2 and c.dtype == torch.uint8
             and c.shape[1] % 4 == 0 and n + LEN_SUFFIX in build.columns]
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
        "byte_exact_on_wire": False,
    }


def _prepare(args, device):
    """The communicator, the device (``rank_device``), the tables, the
    ladder at its first rung, the join options it leaves fixed, and the
    skew policy. The peak device memory is counted from here, before
    the tables."""
    comm = _communicator(args)
    dev = rank_device(comm, device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n = comm.n_ranks
    b_rows, p_rows = args.build_table_nrows, args.probe_table_nrows
    if b_rows % n or p_rows % n:
        raise SystemExit(f"table nrows must be divisible by n_ranks={n}")
    build, probe, join_key = make_tables(args, dev)
    threshold, hh_probe, hh_out, policy = skew_policy(args, n)
    opts = dict(shuffle_capacity_factor=args.shuffle_capacity_factor,
                out_capacity_factor=args.out_capacity_factor,
                skew_threshold=threshold, hh_slots=args.hh_slots,
                hh_build_capacity=args.hh_build_capacity,
                hh_probe_capacity=hh_probe, hh_out_capacity=hh_out)
    ladder = resolve_join_ladder(build, probe, n, opts)
    fixed = dict(key=join_key,
                 over_decomposition=args.over_decomposition_factor, **opts)
    return comm, dev, build, probe, ladder, fixed, policy


def run(args, device=None) -> dict:
    """The protocol; returns the record. ``device`` defaults to the
    rank's device (``rank_device``; ``"cpu"`` for rehearsals: its times
    say nothing of a GPU). The peak device memory covers the whole run,
    tables included."""
    comm, dev, build, probe, ladder, fixed, policy = _prepare(args, device)
    on_gpu = dev.type == "cuda"
    n = comm.n_ranks
    b_rows, p_rows = args.build_table_nrows, args.probe_table_nrows
    threshold = fixed["skew_threshold"]
    for attempt in range(args.auto_retry + 1):
        step = make_join_step(comm, **fixed, **ladder.sizing())
        sec, matches, overflow = timed_join_throughput(
            comm, step, build, probe, args.iterations, key=fixed["key"])
        ladder.note(overflow)
        if not overflow or attempt == args.auto_retry:
            break
        ladder.escalate()

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
        "zipf_alpha": args.zipf_alpha,
        "skew_threshold": threshold,
        "skew_policy": policy,
        "hh_slots": args.hh_slots if threshold is not None else None,
        "key_columns": args.key_columns,
        "string_payload_bytes": args.string_payload_bytes,
        "string_payload_columns": args.string_payload_columns,
        "variable_length_strings": args.variable_length_strings,
        "string_key_bytes": args.string_key_bytes,
        "string_wire_bytes": string_wire_bytes(build),
        "iterations": args.iterations,
        "matches_per_join": matches,
        "overflow": overflow,
        "retry": ladder.report().as_record(),
        "elapsed_per_join_s": sec,
        "rows_per_sec": rows_per_sec,
        "m_rows_per_sec_per_rank": rows_per_sec / 1e6 / n,
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
    comm, _, build, probe, ladder, fixed, policy = _prepare(args, device)
    fn = comm.spmd(make_join_step(comm, **fixed, **ladder.sizing()),
                   sharded_out=JOIN_SHARDED_OUT)
    prof = profile_join(fn, build, probe, args.profile,
                        record=is_coordinator())
    if prof is None:
        return None
    return {"communicator": comm.name, "n_ranks": comm.n_ranks,
            "zipf_alpha": args.zipf_alpha,
            "skew_threshold": fixed["skew_threshold"], "skew_policy": policy,
            "build_table_nrows": args.build_table_nrows,
            "probe_table_nrows": args.probe_table_nrows,
            **prof, **gpu_identity()}


def main(argv=None) -> int:
    args = parse_args(argv)
    # the handshake (and, under NCCL, the choice of this rank's card)
    # comes before any tensor
    maybe_initialize_from_env()
    record = profile(args) if args.profile else run(args)
    if record is not None:
        report(record, args.json_output)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
