"""TPC-H ``lineitem ⋈ orders`` benchmark (the Q3 join pattern): BASELINE
config 4, in core and out of core, on the port.

    python -m distributed_join_tpu_torch.benchmarks.tpch_join \\
        --scale-factor 100 --host-generator --batches 24

Port of ``distributed_join_tpu/benchmarks/tpch_join.py``: ``parse_args``
(:42), ``_make_consumer`` (:110), ``run`` (:130) with its guards
(:160-199), the host-generator path (:219-279), the key-range path
(:295-331), the single-shot path (:332-398, with ``--agg``),
``_run_query`` (:426-587, ``--query``) and ``_report`` (:590), with the
JAX driver's record field names. Four paths:

- single shot (``--batches 1``): the tables generated on the card
  (``utils/tpch.py``, seed 42), ``--iterations`` dependent joins timed
  as the config driver times them (``utils/benchmarking``); with
  ``--agg`` the join is the fused join+group-by (group by the order key:
  revenue, line count, last ship date, the order date carried), graded
  against the numpy oracle;
- query (``--query q3|q10``): ``customer ⋈ orders ⋈ lineitem`` with the
  group-by fused into the second join, generated on the card with the
  query's filters (``utils/tpch.py``) and run as one plan
  (``parallel/query_exec.distributed_query``, ``auto_retry=4``): a cold
  run, then ``--iterations`` warm ones timed one by one (host clock
  around each query and a synchronisation), the groups graded against
  the numpy whole-query oracle (``utils/tpch_host.query_oracle``);
- key range (``--batches k``): the same tables, binned on the host into
  k key-range batches and joined one batch at a time
  (``parallel/out_of_core.keyrange_batched_join``);
- host generator (``--host-generator``): the tables generated on the
  host with numpy, chunk by chunk, straight into key-range batches
  (``utils/tpch_host.py``), then ``batched_join_host``: the path for
  scale factors whose tables do not fit a card. Its record has the
  phase seconds and the peak host memory.

A batched path's seconds are the batch loop's, host-to-device staging
included. ``--telemetry``, ``--trace``, ``--history`` and
``--guard-deadline-s`` are the JAX driver's (``benchmarks.run_guarded``);
``--explain`` writes the single-shot program's plan
(``planning.build_plan``) or, with ``--query``, the query's per-operator
plan (``planning.explain_query``); with a session on, the single shot
runs one untimed metrics join after its timed loop
(``benchmarks.collect_join_metrics``); ``--diagnose`` reads the session
back after the run, and ``--stage-profile N`` profiles the ``--query``
plan operator by operator after the timed loop
(``benchmarks.maybe_query_stage_profile``; the single-shot and batched
paths refuse it, as the JAX driver's do). ``--auto-tune`` parses and the
run refuses it with the JAX driver's message (JAX :131-137).
``--verify-integrity`` (JAX :176, :257-402) checks the wire digests: the
batched paths verify every batch (``batched_join_host``'s contract), the
single shot runs one verified join after its timed loop
(``benchmarks.collect_integrity``, the record's ``integrity``), and the
``--query`` path refuses it, as the JAX driver's does. ``--chaos-seed``
refuses by name. The ``--query`` record's
``programs_traced``, ``warm_new_traces`` and ``warm_cache_hit`` come
from the ``JoinProgramCache`` the plan runs through, and its
``counter_signature``, ``wire`` and ``wire_exact`` from one untimed
query with the metrics tape, graded against ``explain_query`` at the
rung the run resolved to, as in the JAX driver, and its
``stage_profile`` the per-operator summary. Communicators as in the config driver:
``local``, ``emulated`` (``--n-ranks``), and ``nccl`` or ``gloo`` under
the launcher (``benchmarks/launch.py``), where every
process generates the same tables and stages only its own rows.
"""

from __future__ import annotations

import argparse
import resource
import sys
import time
from typing import Optional

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
    write_explain,
    global_table,
    maybe_query_stage_profile,
    rank_device,
    refuse_flags,
    report,
    run_guarded,
)
from distributed_join_tpu_torch.parallel.bootstrap import shutdown
from distributed_join_tpu_torch.benchmarks.distributed_join import row_digest
from distributed_join_tpu_torch.ops.aggregate import (
    AggregateSpec,
    aggregate_oracle,
    frames_equal,
    groups_frame,
)
from distributed_join_tpu_torch.parallel.communicator import make_communicator
from distributed_join_tpu_torch.parallel.distributed_join import (
    JOIN_SHARDED_OUT,
    make_join_step,
)
from distributed_join_tpu_torch.parallel.query_exec import distributed_query
from distributed_join_tpu_torch.planning.plan import build_plan
from distributed_join_tpu_torch.planning.query import (
    explain_query,
    tpch_query_plan,
)
from distributed_join_tpu_torch.telemetry.baselines import (
    SIGNATURE_SCHEMA_VERSION,
)
from distributed_join_tpu_torch.service.programs import JoinProgramCache
from distributed_join_tpu_torch.parallel.out_of_core import (
    batched_join_host,
    keyrange_batched_join,
)
from distributed_join_tpu_torch.utils.benchmarking import (
    timed_join_throughput,
)
from distributed_join_tpu_torch.utils.tpch import (
    generate_tpch_join_tables,
    generate_tpch_query_tables,
    q3_filter,
    query_filters,
)
from distributed_join_tpu_torch.utils.tpch_host import (
    generate_tpch_host_batches,
    query_oracle,
    rename_batches,
)

SEED = 42

# Flags of the JAX driver that the port does not have.
_REFUSED = {
    "--platform": "platform selection (the driver runs on the GPU)",
    **UNPORTED_FLAGS,
}


def parse_args(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    refuse_flags(p, argv, _REFUSED)
    p.add_argument("--scale-factor", type=float, default=0.01,
                   help="TPC-H SF; SF-1 = 1.5M orders / ~6M lineitem rows")
    p.add_argument("--communicator",
                   choices=["local", "emulated", "nccl", "gloo"],
                   default="local",
                   help="local = one rank; emulated = --n-ranks ranks in "
                        "one process, one thread each, on one device; "
                        "nccl / gloo = one process a rank, under the "
                        "launcher (benchmarks/launch.py)")
    p.add_argument("--n-ranks", type=int, default=None)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--q3-filters", action="store_true",
                   help="apply Q3's date predicates before the join")
    p.add_argument("--agg", action="store_true",
                   help="run the single-shot join as the fused "
                        "join+group-by (group by the order key: revenue "
                        "= sum(l_extendedprice), line count, last ship "
                        "date, o_orderdate carried), graded against the "
                        "numpy group-by oracle")
    p.add_argument("--query", choices=("q3", "q10"), default=None,
                   help="run a whole query plan, customer ⋈ orders ⋈ "
                        "lineitem with the group-by fused into the last "
                        "join (q3 groups by orderkey: key mode; q10 by "
                        "custkey: build mode), graded against the numpy "
                        "whole-query oracle. Single-shot only")
    p.add_argument("--batches", type=int, default=1,
                   help=">1 engages the out-of-core key-range path")
    p.add_argument("--host-generator", action="store_true",
                   help="generate on the host (numpy, chunked) and stream "
                        "key-range batches to the card: the path for "
                        "tables larger than the card; batched even at "
                        "--batches 1")
    p.add_argument("--wide-wire", action="store_true",
                   help="stage int64 columns where the tables have them; "
                        "the default narrows every column to int32, "
                        "nearly halving the bytes staged")
    p.add_argument("--fetch-results", action="store_true",
                   help="bring every batch's join output to host memory "
                        "on the fetch thread, overlapped with the next "
                        "batch's join; the record gains fetched_bytes, "
                        "fetch_s and fetch_wait_s")
    p.add_argument("--manifest", default=None,
                   help="per-batch progress manifest of the batched "
                        "paths: a killed run invoked again with the same "
                        "flags resumes from the first incomplete batch")
    p.add_argument("--batch-retries", type=int, default=0,
                   help="dispatch retries a batch before it counts as "
                        "failed (batched paths)")
    p.add_argument("--continue-on-batch-failure", action="store_true",
                   help="record failed batch ids and report partial "
                        "totals instead of stopping the run")
    p.add_argument("--over-decomposition-factor", type=int, default=1)
    p.add_argument("--shuffle-capacity-factor", type=float, default=1.6)
    p.add_argument("--out-capacity-factor", type=float, default=1.5)
    p.add_argument("--json-output", default=None)
    p.add_argument("--sort-mode", choices=["flat", "segmented", "auto"],
                   default=None,
                   help="the local sort; this driver runs the flat one "
                        "(A/B the segmented sort with the join driver's "
                        "--sort-ab)")
    p.add_argument("--sort-segments", type=int, default=None, metavar="N",
                   help="taken for the JAX command line's sake; the flat "
                        "sort never reads it")
    add_telemetry_args(p)
    add_explain_arg(p)
    add_guard_arg(p)
    add_auto_tune_arg(p)
    add_integrity_arg(p)
    return p.parse_args(argv)


def _make_consumer(args):
    """With ``--fetch-results``, a consumer that copies every output
    column and the validity of a batch to host numpy (the reference
    driver's semantics: the joined table is a deliverable), counting the
    bytes. It runs on the batch loop's fetch thread."""
    fetched = {"bytes": 0}
    if not args.fetch_results:
        return None, fetched

    def consumer(b, res):
        for c in [*res.table.columns.values(), res.table.valid]:
            fetched["bytes"] += c.cpu().numpy().nbytes

    return consumer, fetched


def _batched_opts(args, consumer, stats):
    return dict(
        over_decomposition=args.over_decomposition_factor,
        shuffle_capacity_factor=args.shuffle_capacity_factor,
        out_capacity_factor=args.out_capacity_factor,
        stats=stats,
        on_batch_result=consumer,
        manifest_path=args.manifest,
        batch_retries=args.batch_retries,
        on_batch_failure=("continue" if args.continue_on_batch_failure
                          else "raise"),
        verify_integrity=args.verify_integrity)


def _guards(args) -> None:
    """The JAX driver's refusals of flags that do not apply (JAX
    :131-199; those of the flags the port refuses by name are moot)."""
    if getattr(args, "auto_tune", None) is not None:
        # the batched paths re-plan a key-range batch, and the single
        # shot is a fixed TPC-H shape: nothing here reads the store
        raise SystemExit(
            "--auto-tune is wired for tpu-distributed-join, bench.py "
            "and the join service; the tpch driver does not consult "
            "the history store yet")
    if getattr(args, "stage_profile", None) and args.query is None:
        # the single-join paths stage fixed real-schema tables (and the
        # batched ones re-plan a key-range batch); the --query path is
        # segmentable at the operator boundary
        raise SystemExit(
            "--stage-profile is wired for tpu-distributed-join, "
            "bench.py, and the tpch --query path; profile the "
            "equivalent generator workload "
            "(tpu-distributed-join --stage-profile) instead")
    if args.sort_mode not in (None, "flat"):
        # the TPC-H joins carry string payloads end to end; refusing
        # beats timing the flat path under a segmented label
        raise SystemExit(
            "--sort-mode is wired for the join driver and bench.py; the "
            "tpch driver runs the flat pipeline: A/B the segmented sort on "
            "the generator workload (distributed_join --sort-ab)")
    batched = args.batches > 1 or args.host_generator
    if args.explain and batched:
        print("note: --explain covers the single-shot path; the batched "
              "paths write no plan", file=sys.stderr)
    if args.query is not None:
        bad = [flag for flag, on in (
            ("--agg", args.agg),
            ("--batches > 1", args.batches > 1),
            ("--host-generator", args.host_generator),
            ("--q3-filters", args.q3_filters),
            ("--fetch-results", args.fetch_results),
            ("--manifest", bool(args.manifest)),
            ("--verify-integrity", args.verify_integrity),
        ) if on]
        if bad:
            # the query path is a single-shot program family of its own
            raise SystemExit(
                f"--query composes its own plan; {', '.join(bad)} "
                "do(es) not apply — drop the flag(s)")
    if args.agg and batched:
        raise SystemExit(
            "--agg covers the single-shot path; the batched/"
            "out-of-core paths materialize per batch — drop "
            "--batches/--host-generator")
    if (args.manifest or args.batch_retries
            or args.continue_on_batch_failure) and not batched:
        raise SystemExit(
            "--manifest/--batch-retries/--continue-on-batch-failure "
            "apply to the batched paths; add --batches > 1 or "
            "--host-generator")
    if args.fetch_results and not batched:
        raise SystemExit(
            "--fetch-results applies to the batched paths; add "
            "--batches > 1 or --host-generator")


def _host_rss() -> Optional[int]:
    """This process's resident bytes now (Linux), or None."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()
    except (OSError, IndexError, ValueError):
        return None


def _peak_host_rss() -> int:
    # ru_maxrss is in KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run(args, device=None) -> dict:
    """The protocol; returns the record. ``device`` defaults to the
    rank's device (``rank_device``; ``"cpu"`` for rehearsals: its times
    say nothing of a GPU)."""
    _guards(args)
    try:
        comm = make_communicator(args.communicator, n_ranks=args.n_ranks)
    except (ValueError, RuntimeError) as exc:
        raise SystemExit(f"--communicator {args.communicator} "
                         f"(--n-ranks {args.n_ranks}): {exc}") from exc
    dev = rank_device(comm, device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n = comm.n_ranks

    if args.query is not None:
        return _run_query(args, comm, dev)

    if args.host_generator:
        rss = {"before_generate": _host_rss()}
        gen_t0 = time.perf_counter()
        ob, lb = generate_tpch_host_batches(
            seed=SEED, scale_factor=args.scale_factor,
            n_batches=args.batches, q3_filters=args.q3_filters,
            narrow_wire=not args.wide_wire)
        gen_s = time.perf_counter() - gen_t0
        rss["after_generate"] = _host_rss()
        peak_gen = _peak_host_rss()
        build_b = rename_batches(ob, {"o_orderkey": "key"})
        probe_b = rename_batches(lb, {"l_orderkey": "key"})
        del ob, lb
        orders_rows = sum(b["key"].shape[0] for b in build_b)
        lineitem_rows = sum(b["key"].shape[0] for b in probe_b)
        stats = {}
        consumer, fetched = _make_consumer(args)
        total, overflow = batched_join_host(
            build_b, probe_b, comm, device=dev,
            **_batched_opts(args, consumer, stats))
        rss["after_loop"] = _host_rss()
        extra = {
            "host_generator": True,
            "verify_integrity": args.verify_integrity,
            "narrow_wire": not args.wide_wire,
            "generate_s": gen_s,
            "batch_build_capacity": stats["build_capacity"],
            "batch_probe_capacity": stats["probe_capacity"],
            "pad_s": stats["pad_s"],
            "put_s": stats["put_s"],
            "dispatch_s": stats["dispatch_s"],
            "fetch_s": stats["fetch_s"],
            "fetch_wait_s": stats["fetch_wait_s"],
            "fetch_results": args.fetch_results,
            "fetched_bytes": fetched["bytes"] if consumer else None,
            "manifest": args.manifest,
            "resumed_batches": stats["resumed_batches"],
            "failed_batches": stats["failed_batches"],
            "host_rss_bytes": rss,
            "peak_host_rss_generate_bytes": peak_gen,
        }
        return _report(args, comm, dev, orders_rows, lineitem_rows,
                       orders_rows + lineitem_rows, total, overflow,
                       stats["elapsed_s"], extra)

    with telemetry.span("generate", scale_factor=args.scale_factor):
        orders, lineitem = generate_tpch_join_tables(
            seed=SEED, scale_factor=args.scale_factor, device=dev)
        if args.q3_filters:
            orders, lineitem = q3_filter(orders, lineitem)
    build = orders.rename({"o_orderkey": "key"})
    probe = lineitem.rename({"l_orderkey": "key"})
    # real rows (the filters mask rows in place), so the batched and
    # single-shot paths report comparable rows/s
    orders_rows, lineitem_rows = (int(build.num_valid()),
                                  int(probe.num_valid()))
    rows = orders_rows + lineitem_rows

    if args.batches > 1:
        # each batch runs once after the warm-up: --iterations does not
        # apply, and the staging is part of the out-of-core time
        stats = {}
        consumer, fetched = _make_consumer(args)
        matches, overflow = keyrange_batched_join(
            build, probe, comm, n_batches=args.batches,
            **_batched_opts(args, consumer, stats))
        sec = stats["elapsed_s"]
        extra = {
            "verify_integrity": args.verify_integrity,
            "manifest": args.manifest,
            "resumed_batches": stats["resumed_batches"],
            "failed_batches": stats["failed_batches"],
        }
        if consumer is not None:
            extra.update({
                "fetch_results": True,
                "fetched_bytes": fetched["bytes"],
                "fetch_s": stats["fetch_s"],
                "fetch_wait_s": stats["fetch_wait_s"],
            })
    else:
        build = build.pad_to(build.capacity + (-build.capacity) % n)
        probe = probe.pad_to(probe.capacity + (-probe.capacity) % n)
        spec = AggregateSpec.of(
            "key", [("sum", "l_extendedprice", "revenue"),
                    ("count", None, "n_lines"),
                    ("max", "l_shipdate", "last_ship")],
            carry=("o_orderdate",)) if args.agg else None
        join_opts = dict(
            key="key", over_decomposition=args.over_decomposition_factor,
            shuffle_capacity_factor=args.shuffle_capacity_factor,
            out_capacity_factor=args.out_capacity_factor, aggregate=spec)
        step = make_join_step(comm, **join_opts)
        sec, matches, overflow = timed_join_throughput(
            comm, step, build, probe, args.iterations)
        # --telemetry: one untimed metrics join after the timed loop
        collect_join_metrics(comm, build, probe, join_opts)
        extra = {} if spec is None else {
            "agg": True, "aggregate": _grade_agg(comm, step, build, probe,
                                                 spec)}
        if args.verify_integrity:
            # one untimed join with the wire digests, as the config
            # driver's
            extra["integrity"] = collect_integrity(comm, build, probe,
                                                   join_opts)
        if args.explain:
            doc = build_plan(comm, build, probe, with_metrics=False,
                             **join_opts).explain_record()
            write_explain(args, doc)
            extra["explain"] = explain_summary(doc)
    return _report(args, comm, dev, orders_rows, lineitem_rows, rows,
                   matches, overflow, sec, extra)


def _grade_agg(comm, step, build, probe, spec) -> dict:
    """One untimed fused join+group-by on the unshifted tables (the timed
    loop shifts keys), its groups held against the numpy join+group-by;
    wrong groups refuse, never land in a record."""
    res = comm.spmd(step, sharded_out=JOIN_SHARDED_OUT)(build, probe)
    got = global_table(comm, res.table)
    oracle_ok = frames_equal(groups_frame(got, spec, ["key"]),
                             aggregate_oracle(build, probe, "key", spec))
    if not oracle_ok and not bool(res.overflow):
        raise SystemExit("--agg: fused group-by diverged from the numpy "
                         "oracle — refusing to report wrong aggregates")
    return dict(spec.as_record(), groups=int(got.valid.sum()),
                oracle_equal=oracle_ok)


def _run_query(args, comm, dev) -> dict:
    """The whole-query path (JAX :426-587): generate the three tables on
    the card with the query's filters, run the plan cold through the
    ladder, then ``--iterations`` warm runs timed one by one (host
    clock around the query and a synchronisation, the slowest rank's),
    and grade the groups against the numpy whole-query oracle. Then the
    plan is priced at the rung the run resolved to (``explain_query``)
    and one untimed query with the metrics tape grades its padded wire
    bytes exactly, operator by operator (``wire_exact``); its counters,
    under op-id prefixes, are the record's ``counter_signature``. The
    ``--stage-profile N`` then profiles the plan an operator at a time
    at that rung (``benchmarks.maybe_query_stage_profile``)."""
    plan = tpch_query_plan(args.query)
    with telemetry.span("generate", scale_factor=args.scale_factor):
        tables = query_filters(generate_tpch_query_tables(
            seed=SEED, scale_factor=args.scale_factor, device=dev),
            args.query)
    rows = sum(int(t.num_valid()) for t in tables.values())
    factors = dict(over_decomposition=args.over_decomposition_factor,
                   shuffle_capacity_factor=args.shuffle_capacity_factor,
                   out_capacity_factor=args.out_capacity_factor)
    cache = JoinProgramCache(comm)

    def run_once():
        return distributed_query(tables, plan, comm, auto_retry=4,
                                 program_cache=cache, with_metrics=False,
                                 **factors)

    res = run_once()
    if bool(res.overflow):
        raise SystemExit(
            "--query: the capacity ladder ran out — raise "
            "--out-capacity-factor/--shuffle-capacity-factor")
    cold_traces = cache.traces
    query_s = []
    for _ in range(max(args.iterations, 1)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        comm.barrier()
        t0 = time.perf_counter()
        res = run_once()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        query_s.append(comm.host_max(time.perf_counter() - t0))
    spec = plan.aggregate
    groups = global_table(comm, res.table)
    got = groups_frame(groups, spec, list(spec.group_keys))
    want = query_oracle(plan, {name: t.to_host()
                               for name, t in tables.items()})
    oracle_ok = frames_equal(got, want)
    if not oracle_ok:
        raise SystemExit(
            f"--query {args.query}: the composed program diverged from "
            "the whole-query numpy oracle — refusing to report wrong "
            "groups")
    # the plan at the rung the run resolved to, graded against one
    # untimed query with the metrics tape
    scale = 2 ** res.retry_attempts
    rung_factors = dict(
        factors,
        shuffle_capacity_factor=args.shuffle_capacity_factor * scale,
        out_capacity_factor=args.out_capacity_factor * scale)
    doc = explain_query(plan, comm, tables, defaults=rung_factors)
    res_m = distributed_query(tables, plan, comm, auto_retry=0,
                              with_metrics=True, **rung_factors)
    wire_exact = True
    wire_ops = []
    qcounters = {}
    for orec, m in zip(doc["operators"], res_m.telemetry):
        red = m.to_dict()["reduced"]
        entry = {"id": orec["id"]}
        for side in ("build", "probe"):
            pred = int(orec["wire"][side]["bytes_total"])
            # a single rank ships nothing: no counter, zero predicted
            meas = int(red.get(f"{side}.wire_bytes", 0))
            entry[side] = {"predicted_bytes": pred, "measured_bytes": meas}
            wire_exact &= pred == meas
        wire_ops.append(entry)
        for k, v in sorted(red.items()):
            qcounters[f"{orec['id']}.{k}"] = int(v)
    if args.explain:
        write_explain(args, doc)
    # the untimed per-operator profile at the resolved rung
    sp_summary = maybe_query_stage_profile(args, comm, plan, tables,
                                           rung_factors)
    extra = {
        "kind": "query_smoke",
        "query": args.query,
        "counter_signature": {
            "signature_version": SIGNATURE_SCHEMA_VERSION,
            "n_ranks": comm.n_ranks,
            "counters": qcounters,
        },
        "plan_digest": res.plan_digest,
        "n_operators": plan.n_operators(),
        "customer_nrows": int(tables["customer"].num_valid()),
        "op_totals": [int(t) for t in res.op_totals],
        "groups": int(groups.valid.sum()),
        "groups_digest": int(row_digest(groups)),
        "oracle_equal": oracle_ok,
        "retry_attempts": res.retry_attempts,
        "query_s": query_s,
        "query_ms_min": min(query_s) * 1e3,
        "aggregate": spec.as_record(),
        "programs_traced": cache.traces,
        "warm_new_traces": cache.traces - cold_traces,
        "warm_cache_hit": bool(res.cache_hit),
        "wire_exact": wire_exact,
        "wire": wire_ops,
        "cost_total_s": doc["total_s"],
        "order_candidates": doc["orders"],
    }
    if sp_summary is not None:
        extra["stage_profile"] = sp_summary
    return _report(args, comm, dev, int(tables["orders"].num_valid()),
                   int(tables["lineitem"].num_valid()), rows,
                   int(res.total), bool(res.overflow),
                   sum(query_s) / len(query_s), extra)


def _report(args, comm, dev, orders_rows, lineitem_rows, rows, matches,
            overflow, sec, extra) -> dict:
    """The record: the JAX driver's fields, then the device, the card's
    name and power limit, and peak device, host and pinned host memory
    (the caching host allocator's bytes, each allocation rounded up to a
    power of two)."""
    n = comm.n_ranks
    rows_per_sec = rows / sec
    record = {
        "benchmark": "tpch_join",
        "communicator": comm.name,
        "n_ranks": n,
        "scale_factor": args.scale_factor,
        "orders_nrows": orders_rows,
        "lineitem_nrows": lineitem_rows,
        "q3_filters": args.q3_filters,
        "batches": args.batches,
        "matches_per_join": matches,
        "overflow": overflow,
        "elapsed_per_join_s": sec,
        "rows_per_sec": rows_per_sec,
        "m_rows_per_sec_per_rank": rows_per_sec / 1e6 / n,
        **extra,
        "device": str(dev),
        "peak_host_rss_bytes": _peak_host_rss(),
    }
    if dev.type == "cuda":
        record.update(gpu_identity())
        record["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        record["pinned_host_bytes"] = torch.cuda.host_memory_stats().get(
            "allocated_bytes.peak")
    return record


def headline(record: dict) -> str:
    return (f"tpch lineitem⋈orders SF-{record['scale_factor']:g}: "
            f"{record['orders_nrows'] + record['lineitem_nrows']} rows in "
            f"{record['elapsed_per_join_s']:.4f} s -> "
            f"{record['rows_per_sec'] / 1e6:.2f} M rows/s over "
            f"{record['n_ranks']} rank(s)"
            + (" [OVERFLOW]" if record["overflow"] else ""))


def _main(args) -> dict:
    record = run(args)
    report(record, args.json_output, headline(record))
    return record


def main(argv=None) -> int:
    args = parse_args(argv)
    # the handshake (and, under NCCL, the choice of this rank's card)
    # comes first inside the guarded run, before any tensor
    rc = run_guarded(_main, args, "tpch_join")
    shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
