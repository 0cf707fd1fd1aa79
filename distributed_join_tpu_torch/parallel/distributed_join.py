"""The distributed join orchestrator: partition both tables ->
all-to-all shuffle -> local join, with over-decomposition batching and
the ``auto_retry`` capacity ladder, for every join type.

Port of ``distributed_join_tpu/parallel/distributed_join.py``: the
materializing path of ``make_join_step`` (:517-801, including the skew
sidecar :568-628, the single-bucket shortcut :640-655 and the segmented
sort :656-715), the shuffle dispatch ``_batch_shuffle`` (:95-141) and
``_batch_shuffle_segmented`` (:144-171), ``resolve_join_ladder``
(:1421), ``distributed_inner_join`` (:1486) and the probe-only steps
of the resident build tables (``resolve_probe_capacities``,
``make_probe_join_step``, ``_make_probe_agg_step``: :985-1380) and
``make_distributed_join`` (:1383). With n
ranks and over-decomposition k, rows hash into ``bucket = h % (k*n)``;
``dest = bucket % n`` and ``batch = bucket // n``, so one partition sort
serves all k batches and matching keys always share (dest, batch).

Four wires (``shuffle``): ``padded`` (capacity-padded blocks, one
all-to-all), ``ppermute`` (the same blocks over the communicator's
point-to-point chain), ``ragged`` (the exact-size exchange, with every
string payload column on the byte-exact wire) and ``hierarchical`` (the
padded blocks in two hops over a ``(slice, chip)`` communicator); the
padded and ppermute wires take the FoR + bit-pack codec
(``compression_bits``), the hierarchical wire takes it on its
cross-slice hop (``dcn_codec``). Two local sorts (``sort_mode``):
``flat`` and ``segmented`` (ops/segmented.py).

Composite keys, 2-D (fixed-width string) payload columns and string
keys run as in the JAX package: 2-D columns are gathered and shuffled as
whole rows, and string keys are packed into 64-bit word columns once,
before hashing (JAX :536-552), and rebuilt on the way out (:783-790).
Typed joins (``join_type``, ops/join.JOIN_TYPES) run each bucket's local
join with the type: hash partitioning puts every key's rows of both
sides in one bucket, so unmatched rows are local.
``distributed_inner_join(tuner=)`` consults the autotuner
(``planning/tuner.py``) before the ladder resolves (JAX :1571-1597).

Device metrics (``with_metrics``; JAX :517-1372): every step takes the
JAX package's ``MetricsTape`` (``telemetry/metrics.py``) and then returns
``(JoinResult, Metrics)``: the shuffles' wire accounting under
``build.``/``probe.``/``partials.``, ``rows_partitioned`` and
``overflow_margin_min`` a side, ``matches``, ``skew.hh_matches``,
``sort_segments``, ``agg.groups``, ``resident.rows`` and the constants of
``metrics_static`` (``retry_attempt_max``). ``make_distributed_join``
resolves ``with_metrics=None`` from the telemetry session, as the JAX
package does, and hangs the block on the result as ``res.telemetry``.
With the tape off a step launches exactly what it launched before.

Wire integrity (``with_integrity``; JAX :196, :514-521, :678-763,
:807-914, :952-956, :1022-1357): every shuffle of the step digests what
it sends and what it believes it received (``parallel/integrity.py``),
under ``build.integrity``, ``probe.integrity`` and
``partials.integrity``, on the same tape, so a step with integrity on
returns ``(JoinResult, Metrics)`` as a metrics step does and adds no
collective. ``distributed_inner_join(verify_integrity=True)`` checks
every (source, destination) pair on the host after each attempt: a
mismatch on an attempt that did not overflow is the ladder's
``retry_integrity`` rung (the same sizing, the attempt's cached program
evicted), and the last attempt raises ``integrity.IntegrityError``
rather than return its rows. With both switches off a step launches
exactly what it launched before.

Telemetry (JAX :572-947, :1177-1348): with a session on, the steps
record JAX's spans under JAX's names and payloads: ``skew``,
``partition``, ``shuffle`` (``batch=``), ``join`` (``batch=`` where the
step has batches), ``join_agg``, ``agg_combine`` and
``partials_exchange``. They fire on every call (the JAX package's at
trace time, once a compile); see ``telemetry/spans.py`` for which thread
records them and what their durations mean.

Aggregate pushdown (``aggregate=``, an ``ops.aggregate.AggregateSpec``;
JAX :475-507 and ``_make_join_agg_step`` :804-983): each side partitions
and shuffles only the columns the reduction reads, each batch reduces in
its merged domain (``ops.aggregate.local_join_aggregate``), and the
result holds the finalized groups, with ``total`` the rows the
materializing join would emit. Key mode is final per rank; probe and
build modes combine their batches' partials and exchange them across
ranks (the padded wire, or the hierarchical one on a multi-slice mesh).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.ops import aggregate as agg_ops
from distributed_join_tpu_torch.ops.hashing import hash_columns
from distributed_join_tpu_torch.ops.join import (
    JOIN_TYPES,
    JoinResult,
    patch_string_lengths,
    sort_merge_inner_join,
)
from distributed_join_tpu_torch.ops import segmented as seg_ops
from distributed_join_tpu_torch.ops.partition import radix_hash_partition
from distributed_join_tpu_torch.parallel import skew
from distributed_join_tpu_torch.parallel.communicator import Communicator
from distributed_join_tpu_torch.parallel import faults, integrity
from distributed_join_tpu_torch.parallel.faults import CapacityLadder
from distributed_join_tpu_torch.planning.cost import (
    DEFAULT_DCN_CODEC_BITS,
    resolve_dcn_bits,
    resolve_dcn_codec,
)
from distributed_join_tpu_torch.parallel.shuffle import (
    prefetch_ragged_plans,
    shuffle_hierarchical,
    shuffle_padded,
    shuffle_padded_compressed,
    shuffle_ragged,
    shuffle_segmented,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.telemetry.metrics import MetricsTape
from distributed_join_tpu_torch.utils.strings import (
    LEN_SUFFIX,
    prepare_string_key_join,
    rebuild_string_keys,
)

DEFAULT_SHUFFLE_CAPACITY_FACTOR = 1.6
DEFAULT_OUT_CAPACITY_FACTOR = 1.2
DEFAULT_HH_SLOTS = 64
HH_BUILD_SLOTS_PER_HH = 32  # default hh_build_capacity = slots * this
SHUFFLE_MODES = ("padded", "ragged", "ppermute", "hierarchical")
SORT_MODES = ("flat", "segmented")
# The table row-sharded; the summed total and overflow replicated.
JOIN_SHARDED_OUT = JoinResult(table=False, total=True, overflow=True)
# A metrics step returns (JoinResult, Metrics); the block is replicated
# (one all-gather in the step).
JOIN_METRICS_SHARDED_OUT = (JOIN_SHARDED_OUT, True)

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _varwidth_cols(table: Table) -> list:
    """The 2-D uint8 columns with a ``<name>#len`` companion and a width
    divisible by 4: the columns the ragged wire ships byte-exactly (JAX
    :80)."""
    return [name for name, c in table.columns.items()
            if c.ndim == 2 and c.dtype == torch.uint8 and c.shape[1] % 4 == 0
            and name + LEN_SUFFIX in table.columns]


def _padded_wire(comm, padded, counts, capacity: int, mode: str = "padded",
                 compression_bits: Optional[int] = None,
                 dcn_codec_on: bool = False, tape=None, digest_tape=None):
    """One batch's exchange of one side's padded blocks on the wire of
    ``mode`` (padded, ppermute or hierarchical; with the codec where
    ``compression_bits`` or the cross-slice codec puts it): the
    received table and the codec's overflow flag (None where the wire
    has no codec). The step and the stage profiler's shuffle segment
    (``telemetry/stageprof.py``) dispatch through this one function. On
    one slice the hierarchical wire is the padded one, byte for
    byte."""
    if mode == "hierarchical" and comm.n_slices > 1:
        dcn_bits = ((compression_bits or DEFAULT_DCN_CODEC_BITS)
                    if dcn_codec_on else None)
        table, _, c_ovf = shuffle_hierarchical(
            comm, padded, counts, capacity, dcn_bits=dcn_bits, tape=tape,
            digest_tape=digest_tape)
        return table, c_ovf
    if mode == "hierarchical":
        mode, compression_bits = "padded", None
    via = "ppermute" if mode == "ppermute" else "all_to_all"
    if compression_bits is not None:
        table, _, c_ovf = shuffle_padded_compressed(
            comm, padded, counts, capacity, bits=compression_bits, via=via,
            tape=tape, digest_tape=digest_tape)
        return table, c_ovf
    table, _ = shuffle_padded(comm, padded, counts, capacity, via=via,
                              tape=tape, digest_tape=digest_tape)
    return table, None


def _batch_shuffle(comm, pt, batch: int, n_ranks: int, capacity: int,
                   mode: str = "padded",
                   compression_bits: Optional[int] = None, varwidth=None,
                   dcn_codec_on: bool = False, tape=None, digest_tape=None):
    """One batch's shuffle of one side (JAX :95): the received table and
    the overflow flag. The ragged wire's receive buffer holds what the
    padded layout would flatten to (``n_ranks * capacity`` rows), and
    ``capacity_per_bucket`` gives it the padded wire's overflow
    contract, so ``auto_retry`` fires under the same conditions; the
    other wires take the batch's padded blocks (:func:`_padded_wire`)."""
    if mode == "ragged":
        return shuffle_ragged(
            comm, pt, n_ranks * capacity, bucket_start=batch * n_ranks,
            capacity_per_bucket=capacity, varwidth=varwidth, tape=tape,
            digest_tape=digest_tape)
    padded, counts, overflow, _ = pt.to_padded(
        capacity, bucket_start=batch * n_ranks, n_buckets=n_ranks)
    table, c_ovf = _padded_wire(comm, padded, counts, capacity, mode,
                                compression_bits, dcn_codec_on, tape,
                                digest_tape)
    return table, overflow if c_ovf is None else overflow | c_ovf


def resolve_probe_capacities(p_local: int, n: int, k: int,
                             shuffle_capacity_factor: float,
                             out_capacity_factor: float,
                             out_rows_per_rank: Optional[int]):
    """``(p_cap, out_cap)``: a side's shuffle pad per (batch,
    destination) bucket and the join output block per batch (JAX
    :985-1004). The probe-only step resolves its probe side with it, and
    ``_step_capacities`` both sides, so the two programs cannot size a
    probe apart."""
    p_cap = _round_up(
        int(math.ceil(p_local / (k * n) * shuffle_capacity_factor)), 8)
    if out_rows_per_rank is not None:
        out_cap = _round_up(int(math.ceil(out_rows_per_rank / k)), 8)
    else:
        out_cap = _round_up(
            int(math.ceil(p_local / k * out_capacity_factor)), 8)
    return p_cap, out_cap


def _step_capacities(b_rows: int, p_rows: int, n: int, k: int,
                     shuffle_capacity_factor: float,
                     out_capacity_factor: float,
                     out_rows_per_rank: Optional[int]):
    """The step's static capacities, shared by the materializing and the
    fused aggregate step so that the ladder relieves one contract: each
    side's shuffle pad per (batch, destination) bucket, and the join
    output block per batch."""
    b_cap, _ = resolve_probe_capacities(b_rows, n, k, shuffle_capacity_factor,
                                        out_capacity_factor, None)
    p_cap, out_cap = resolve_probe_capacities(
        p_rows, n, k, shuffle_capacity_factor, out_capacity_factor,
        out_rows_per_rank)
    return b_cap, p_cap, out_cap


def _new_tape(with_aux: bool, metrics_static) -> Optional[MetricsTape]:
    """The step's tape (None with metrics and integrity off: the digests
    ride the same tape, so either switch makes it), holding the caller's
    constants (``metrics_static``, e.g. ``retry_attempt_max``)."""
    if not with_aux:
        return None
    tape = MetricsTape()
    for name, value in (metrics_static or {}).items():
        tape.add(name, int(value))
    return tape


def _bill_partition(tape, pt, cap: int) -> None:
    """A side's partitioned rows and its tightest bucket's headroom under
    the shuffle capacity (device scalars); nothing without a tape."""
    if tape is not None:
        tape.add("rows_partitioned", pt.counts.sum(dtype=torch.int64))
        tape.record_min("overflow_margin_min",
                        cap - pt.counts.max().to(torch.int64))


def _scopes(tape, n: int, suffix: str = "") -> list:
    """The side scopes of a tape (None without one), ``suffix`` after
    the side's name (``.integrity``: the digest scopes)."""
    names = ("build", "probe") if n == 2 else ("probe",)
    return [None if tape is None else tape.scoped(s + suffix)
            for s in names]


def _digest_scopes(tape, with_integrity: bool, n: int) -> list:
    """The sides' digest tapes (``build.integrity``,
    ``probe.integrity``), None each with integrity off."""
    return _scopes(tape if with_integrity else None, n, ".integrity")


def _flat_batches(comm, sides, keys, k: int, shuffle: str,
                  compression_bits, dcn_on: bool, strings: bool,
                  tape=None, with_integrity: bool = False):
    """Partition each ``(table, bucket capacity)`` side into ``k *
    n_ranks`` buckets and yield each of the ``k`` batches as ``(*received
    sides, overflow)``: both sides (build first) for a join of two
    shuffled tables, the probe alone for the probe-only step, whose
    build is resident. With ``strings`` on
    the ragged wire, each side's string payload columns ride the
    byte-exact wire, each bucket ordered by the first one's length,
    descending. The partition runs in a ``partition`` span and each
    batch's exchange in a ``shuffle`` span (``batch=b``; the ragged
    wire's one plan read, both sides and every batch, in batch 0's).
    ``tape``: the step's metrics tape, each side billed under its own
    scope (``build``/``probe``, or ``probe`` alone); with
    ``with_integrity`` each side's shuffles also digest under
    ``<side>.integrity``."""
    n = comm.n_ranks
    parted = []
    scoped = _scopes(tape, len(sides))
    digests = _digest_scopes(tape, with_integrity, len(sides))
    with telemetry.span("partition"):
        for (t, cap), st, dt in zip(sides, scoped, digests):
            vw = _varwidth_cols(t) if strings and shuffle == "ragged" else []
            pt = radix_hash_partition(
                t, keys, k * n,
                order_within=vw[0] + LEN_SUFFIX if vw else None)
            parted.append((pt, cap, vw, st, dt))
            if st is not None:
                _bill_partition(st, pt, cap)
    for b in range(k):
        recv, overflow = [], None
        with telemetry.span("shuffle", batch=b):
            if shuffle == "ragged" and b == 0:
                # both sides' plans in one read to the host
                prefetch_ragged_plans(
                    comm, [(pt, vw) for pt, _, vw, _, _ in parted])
            for pt, cap, vw, st, dt in parted:
                table, ovf = _batch_shuffle(
                    comm, pt, b, n, cap, mode=shuffle,
                    compression_bits=compression_bits, varwidth=vw,
                    dcn_codec_on=dcn_on, tape=st, digest_tape=dt)
                recv.append(table)
                overflow = ovf if overflow is None else overflow | ovf
        yield (*recv, overflow)


def _batch_shuffle_segmented(comm, pt, batch: int, n_ranks: int,
                             segments: int, seg_cap: int, mode: str,
                             tape=None, digest_tape=None):
    """One batch of the segmented exchange (JAX :144-171): the fine
    buckets pad to ``seg_cap`` and ride one block a destination
    (``shuffle_segmented``). Returns ``(recv_cols (n, s, seg_cap, ...),
    recv_fine_counts (n, s), overflow)``; the flag fires when a fine
    bucket exceeds ``seg_cap``."""
    padded, counts, overflow, _ = pt.to_padded(
        seg_cap, bucket_start=batch * n_ranks * segments,
        n_buckets=n_ranks * segments)
    via = {"padded": "all_to_all", "ppermute": "ppermute",
           "hierarchical": "hierarchical"}[mode]
    recv_cols, recv_counts = shuffle_segmented(
        comm, padded, counts, seg_cap, segments, via=via, tape=tape,
        digest_tape=digest_tape)
    return recv_cols, recv_counts, overflow


def _concat(parts) -> Table:
    """The batches' tables in one."""
    return Table({name: torch.cat([t.columns[name] for t in parts])
                  for name in parts[0].column_names},
                 torch.cat([t.valid for t in parts]))


def _settle(comm, out: Table, total, overflow, tape=None):
    """The step's result: its table, the match count summed and the
    overflow flag OR-ed over the ranks; with a tape, ``(result,
    Metrics)``, the rank's own (pre-sum) ``matches`` on the tape."""
    metrics = None
    if tape is not None:
        tape.add("matches", total)
        metrics = tape.gathered(comm, total.device)
    total = comm.psum(total)
    overflow = comm.psum(overflow.to(torch.int32)) > 0
    res = JoinResult(out, total=total, overflow=overflow)
    return res if tape is None else (res, metrics)


def make_join_step(
    comm: Communicator,
    key="key",
    join_type: str = "inner",
    over_decomposition: int = 1,
    shuffle_capacity_factor: float = DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    out_capacity_factor: float = DEFAULT_OUT_CAPACITY_FACTOR,
    out_rows_per_rank: Optional[int] = None,
    build_payload: Optional[Sequence[str]] = None,
    probe_payload: Optional[Sequence[str]] = None,
    kernel_config=None,
    skew_threshold: Optional[float] = None,
    hh_slots: int = DEFAULT_HH_SLOTS,
    hh_build_capacity: Optional[int] = None,
    hh_probe_capacity: Optional[int] = None,
    hh_out_capacity: Optional[int] = None,
    shuffle: str = "padded",
    compression_bits: Optional[int] = None,
    dcn_codec: str = "auto",
    sort_mode: str = "flat",
    sort_segments: Optional[int] = None,
    aggregate=None,
    with_metrics: bool = False,
    with_integrity: bool = False,
    metrics_static: Optional[dict] = None,
):
    """The per-rank join step ``step(build_local, probe_local) ->
    JoinResult``, to run under ``comm.spmd``; with ``with_metrics`` or
    ``with_integrity``, ``(JoinResult, Metrics)`` (run it with
    ``JOIN_METRICS_SHARDED_OUT``).

    Static capacities, as in the JAX package:
    - shuffle pad per (batch, destination) bucket =
      ceil(local_rows / (k * n) * shuffle_capacity_factor), rounded up
      to 8;
    - join output block per batch = local probe rows / k *
      out_capacity_factor (or out_rows_per_rank / k), rounded up to 8.
    Overflow of either is reported, never hidden. A single bucket
    (n * k == 1) skips partition and shuffle — both pure row
    permutations — and joins directly.

    Skew sidecar (``skew_threshold``; parallel/skew.py): a key is heavy
    when its global probe count exceeds ``skew_threshold`` x local probe
    rows. Heavy probe rows stay on their rank, compacted into an
    ``hh_probe_capacity`` block (default 1/8 of local probe rows); heavy
    build rows are broadcast (``hh_build_capacity`` slots per rank,
    default ``hh_slots * 32``) and joined locally into an output block of
    ``hh_out_capacity`` rows (default 1/4 of local probe rows), which
    comes first in the result. The normal path sees neither side's heavy
    rows. Every overflow folds into the one flag.

    ``join_type``: ``inner`` or one of left, right, full_outer, semi and
    anti (ops/join.JOIN_TYPES; the probe is the preserved side). A typed
    join refuses the skew sidecar, as in the JAX package.

    ``shuffle``: the wire, ``padded``, ``ppermute``, ``ragged`` or
    ``hierarchical``. With ``ragged``, each side's string payload
    columns (2-D uint8 with a ``#len`` companion, width divisible by 4)
    ride the byte-exact wire, the partition ordering each bucket by the
    first one's length. ``compression_bits`` (2, 4, 8, 16 or 32) puts
    the FoR + bit-pack codec on the padded and ppermute wires; a block
    it cannot pack raises the overflow flag. ``hierarchical`` is the
    two-level shuffle over a ``(slice, chip)`` communicator
    (``n_slices`` > 1): every block rides the intra-slice exchange,
    then the cross-slice one, with the codec on that tier alone when
    ``dcn_codec`` is ``on`` (``compression_bits`` its width, default
    16); on one slice it is the padded wire. The skew sidecar's light
    rows ride the chosen wire.

    ``sort_mode``: ``flat`` (the local join above) or ``segmented``
    (ops/segmented.py): the partition splits each (batch, destination)
    bucket into ``sort_segments`` fine buckets (default
    ``resolve_sort_segments`` of the table shapes), the padded,
    ppermute or hierarchical wire carries them as static
    per-(source, segment) blocks, and the receiver joins all segments
    as one batch of short runs, each segment with its share of the
    output block. A fine bucket or segment overflow raises the shared
    flag. The result is the flat path's row multiset, segment-major. The
    ragged wire, the compressed wire, the DCN codec on a multi-slice
    mesh, ``kernel_config`` and typed joins refuse; one segment, or one
    bucket (n * k == 1), is the flat path.

    ``aggregate``: an ``ops.aggregate.AggregateSpec`` runs the fused
    join+aggregate step (:func:`_make_join_agg_step`) in place of the
    materializing one. The segmented sort, the skew sidecar, explicit
    payload lists, ``kernel_config`` and typed joins refuse, as in the
    JAX package.

    ``with_metrics``: the step keeps a ``MetricsTape`` (module
    docstring) and returns its gathered block beside the result;
    ``metrics_static`` adds constants to it. ``with_integrity``: the
    same tape, with every shuffle's digest pairs under
    ``build.integrity`` and ``probe.integrity`` (checked on the host by
    ``integrity.verify_digests``); the single-bucket shortcut has no
    wire and carries none.
    """
    if join_type not in JOIN_TYPES:
        raise ValueError(f"unknown join_type {join_type!r}; expected one "
                         f"of {JOIN_TYPES}")
    if join_type != "inner":
        if skew_threshold is not None:
            raise ValueError(
                f"join_type={join_type!r} does not combine with the skew "
                "sidecar: broadcast heavy-hitter build rows are replicated "
                "on every rank, so an unmatched heavy build row would emit "
                "once PER RANK; run typed joins without skew_threshold")
        if aggregate is not None:
            raise ValueError(
                f"join_type={join_type!r} does not combine with "
                "aggregate pushdown: the fused reduction counts "
                "matches in the merged domain and has no NULL-row "
                "emission — aggregate over a materialized typed join "
                "instead")
        if sort_mode == "segmented":
            raise ValueError(
                f"join_type={join_type!r} is not part of the segmented-"
                "sort path (the batched short-run formulation emits "
                "matches only): use sort_mode='flat'")
    if shuffle not in SHUFFLE_MODES:
        # checked for every configuration: a one-bucket join never
        # reaches the shuffle, and a typo must not pass
        raise ValueError(f"unknown shuffle mode {shuffle!r}")
    if compression_bits is not None and shuffle == "ragged":
        raise ValueError(
            "compression applies to the padded/ppermute shuffles; the "
            "ragged exchange already sends exact rows (combining the "
            "two is unimplemented)")
    n = comm.n_ranks
    if shuffle == "hierarchical":
        if compression_bits is not None and dcn_codec == "off":
            raise ValueError(
                "dcn_codec='off' contradicts compression_bits="
                f"{compression_bits}: the hierarchical mode's codec rides "
                "only the cross-slice tier; drop the bits or the knob")
        dcn_on = resolve_dcn_codec(dcn_codec)
    else:
        resolve_dcn_codec(dcn_codec)
        dcn_on = False
        if n > 1 and comm.n_slices > 1:
            raise ValueError(
                f"shuffle {shuffle!r} routes one global collective over a "
                "multi-slice mesh, dragging intra-slice traffic across "
                "the slow tier: use shuffle='hierarchical' (or a flat "
                "communicator)")
    if sort_mode not in SORT_MODES:
        raise ValueError(
            f"unknown sort_mode {sort_mode!r}; pick one of {SORT_MODES}")
    if sort_segments is not None and int(sort_segments) < 1:
        raise ValueError("sort_segments must be >= 1")
    if sort_mode == "flat" and sort_segments is not None:
        raise ValueError(
            "sort_segments applies to sort_mode='segmented' only: the "
            "flat pipeline never reads it; drop the knob or pass "
            "sort_mode='segmented'")
    if sort_mode == "segmented":
        if shuffle == "ragged":
            raise ValueError(
                "sort_mode='segmented' needs static per-(source, segment) "
                "receive boundaries; the ragged exchange's exist only at "
                "run time: use shuffle='padded'/'ppermute' (or "
                "sort_mode='flat')")
        if compression_bits is not None:
            raise ValueError(
                "sort_mode='segmented' does not combine with the "
                "compressed wire: the codec's per-destination frame "
                "streams assume one valid prefix per block, which the "
                "fine-bucket layout breaks; drop compression_bits (or use "
                "sort_mode='flat')")
        if shuffle == "hierarchical" and dcn_on and comm.n_slices > 1:
            raise ValueError(
                "sort_mode='segmented' does not combine with the "
                "hierarchical DCN codec (the same per-block framing "
                "problem as compression_bits): pass dcn_codec='off' (or "
                "sort_mode='flat')")
        if kernel_config is not None:
            raise ValueError(
                "sort_mode='segmented' ignores kernel_config (the knob "
                "tunes the flat kernel pipeline; the segmented path is the "
                "batched formulation): drop the knob")
    k = over_decomposition
    if k < 1:
        raise ValueError("over_decomposition must be >= 1")
    nb = k * n
    keys = [key] if isinstance(key, str) else list(key)

    if aggregate is not None:
        if not isinstance(aggregate, agg_ops.AggregateSpec):
            raise TypeError(
                "aggregate must be an ops.aggregate.AggregateSpec "
                f"(got {type(aggregate).__name__}); build one with "
                "AggregateSpec.of(group_by, aggs, ...)")
        if sort_mode == "segmented":
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported under "
                "sort_mode='segmented': the fused reduction rides "
                "the flat pipeline's own sorts — run aggregates with "
                "sort_mode='flat'")
        if skew_threshold is not None:
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported: the skew sidecar "
                "joins heavy hitters through a separate output block "
                "the fused reduction does not cover — run skewed "
                "workloads through the materializing join")
        if build_payload is not None or probe_payload is not None:
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported: explicit payload "
                "lists conflict with the pushdown's own wire-column "
                "resolution (ops.aggregate.wire_columns resolves "
                "exactly the columns the reduction reads)")
        if kernel_config is not None:
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported: kernel_config tunes "
                "the materializing expand/compact gathers the fused "
                "reduction never runs — drop the knob (silently "
                "ignoring it would cache one program per value)")
        return _make_join_agg_step(
            comm, aggregate, keys=keys, k=k,
            shuffle_capacity_factor=shuffle_capacity_factor,
            out_capacity_factor=out_capacity_factor,
            out_rows_per_rank=out_rows_per_rank, shuffle=shuffle,
            compression_bits=compression_bits, dcn_on=dcn_on,
            with_metrics=with_metrics, with_integrity=with_integrity,
            metrics_static=metrics_static)

    def step(build_local: Table, probe_local: Table):
        tape = _new_tape(with_metrics or with_integrity, metrics_static)
        for kname in keys:
            bdt = build_local.columns[kname].dtype
            pdt = probe_local.columns[kname].dtype
            if bdt != pdt:
                # hash routing is dtype-dependent
                raise TypeError(
                    f"key {kname!r} dtype mismatch: build {bdt} vs probe {pdt}")
        # String keys: packed into word columns once, before hashing, so
        # every stage below sees a composite scalar key (the build side's
        # dead '#len' companion never rides the shuffle); the byte
        # columns are rebuilt on the way out.
        (build_local, probe_local, keys_eff, bpay, ppay,
         str_spec) = prepare_string_key_join(
            build_local, probe_local, keys, build_payload, probe_payload)
        sk_names = tuple(nm for _, wns, _ in str_spec for nm in wns)
        b_rows, p_rows = build_local.capacity, probe_local.capacity
        b_cap, p_cap, out_cap = _step_capacities(
            b_rows, p_rows, n, k, shuffle_capacity_factor,
            out_capacity_factor, out_rows_per_rank)

        def local_join(b, p, cap=out_cap):
            return sort_merge_inner_join(
                b, p, keys_eff, cap, build_payload=bpay, probe_payload=ppay,
                kernel_config=kernel_config, join_type=join_type,
                _internal=sk_names)

        parts = []
        total = torch.zeros((), dtype=torch.int64, device=build_local.device)
        overflow = torch.zeros((), dtype=torch.bool,
                               device=build_local.device)
        if skew_threshold is not None:
            with telemetry.span("skew"):
                # Classify on the key-tuple hash: it only has to be
                # consistent across sides and ranks (a collision merely
                # makes a key heavy; the HH join matches on the real key).
                bh = hash_columns([build_local.columns[c]
                                   for c in keys_eff])
                ph = hash_columns([probe_local.columns[c]
                                   for c in keys_eff])
                bh, ph = bh.view(torch.uint64), ph.view(torch.uint64)
                hh = skew.global_heavy_hitters(
                    comm, ph, probe_local.valid, hh_slots,
                    threshold=int(skew_threshold * p_rows))
                is_hh_b = skew.mark_heavy(bh, hh)
                is_hh_p = skew.mark_heavy(ph, hh)
                hh_build_cap, hh_probe_cap, hh_out_cap = skew_capacities(
                    p_rows, hh_slots, hh_build_capacity, hh_probe_capacity,
                    hh_out_capacity)
                hh_build, ovf_hb = skew.broadcast_heavy_build(
                    comm, build_local, is_hh_b, hh_build_cap,
                    kernel_config=kernel_config)
                # heavy probe rows stay local, compacted into a
                # right-sized block first, so the HH join does not
                # re-sort all p_rows
                hh_probe, _, ovf_hp = skew.extract_prefix(
                    probe_local, probe_local.valid & is_hh_p,
                    _round_up(hh_probe_cap, 8), kernel_config=kernel_config)
                hh_res = local_join(hh_build, hh_probe, hh_out_cap)
                parts.append(hh_res.table)
                total = total + hh_res.total
                overflow = overflow | ovf_hb | ovf_hp | hh_res.overflow
                if tape is not None:
                    tape.add("skew.hh_matches", hh_res.total)
                build_local = Table(build_local.columns,
                                    build_local.valid & ~is_hh_b)
                probe_local = Table(probe_local.columns,
                                    probe_local.valid & ~is_hh_p)

        seg = 1
        if sort_mode == "segmented" and nb > 1:
            # one segment count for both sides: segments must be the same
            # hash classes on build and probe
            seg = seg_ops.resolve_sort_segments(
                sort_segments, max(b_rows, p_rows), n, k,
                shuffle_capacity_factor)
        if nb == 1:
            with telemetry.span("join"):
                res = local_join(build_local, probe_local)
            parts.append(res.table)
            total = total + res.total
            overflow = overflow | res.overflow
        elif seg > 1:
            # the fine partition (sub-bucket bits on the same partition
            # sort), the per-segment padded wire, one batched join a batch
            caps = [seg_ops.segment_capacity(rows, n, k, seg,
                                             shuffle_capacity_factor)
                    for rows in (b_rows, p_rows)]
            out_cap_s = seg_ops.segmented_out_capacity(
                p_rows, k, seg, out_capacity_factor, out_rows_per_rank)
            with telemetry.span("partition"):
                pts = [radix_hash_partition(t, keys_eff, nb,
                                            sub_buckets=seg)
                       for t in (build_local, probe_local)]
            scoped = _scopes(tape, 2)
            digests = _digest_scopes(tape, with_integrity, 2)
            if tape is not None:
                tape.add("sort_segments", seg)
                for st, pt, cap in zip(scoped, pts, caps):
                    _bill_partition(st, pt, cap)
            for b in range(k):
                blocks = []
                with telemetry.span("shuffle", batch=b):
                    for pt, cap, st, dt in zip(pts, caps, scoped, digests):
                        cols, counts, ovf = _batch_shuffle_segmented(
                            comm, pt, b, n, seg, cap, shuffle, tape=st,
                            digest_tape=dt)
                        blocks.append((cols, counts))
                        overflow = overflow | ovf
                with telemetry.span("join", batch=b):
                    runs = [r for cols, counts in blocks
                            for r in seg_ops.runs_from_blocks(cols, counts)]
                    table, t_batch, ovf_j = \
                        seg_ops.batched_sort_merge_inner_join(
                            *runs, keys_eff, out_cap_s, build_payload=bpay,
                            probe_payload=ppay, _internal=sk_names)
                parts.append(table)
                total = total + t_batch
                overflow = overflow | ovf_j
        else:
            for b, (recv_b, recv_p, ovf) in enumerate(_flat_batches(
                    comm, ((build_local, b_cap), (probe_local, p_cap)),
                    keys_eff, k, shuffle, compression_bits, dcn_on,
                    strings=True, tape=tape,
                    with_integrity=with_integrity)):
                overflow = overflow | ovf
                with telemetry.span("join", batch=b):
                    res = local_join(recv_b, recv_p)
                parts.append(res.table)
                total = total + res.total
                overflow = overflow | res.overflow
        out = _concat(parts)
        if str_spec:
            out = patch_string_lengths(
                rebuild_string_keys(out, str_spec, keys), keys, join_type)
        return _settle(comm, out, total, overflow, tape)

    return step


def _check_scalar_columns(resident_local: Table, probe_local: Table,
                          keys) -> None:
    """The probe-only program's input checks (JAX :1139-1154): scalar
    columns on both sides, and equal key dtypes (hash routing is
    dtype-dependent)."""
    for t, side in ((resident_local, "resident"), (probe_local, "probe")):
        for name, c in t.columns.items():
            if c.ndim != 1:
                raise TypeError(
                    f"{side} column {name!r} is {c.ndim}-D; the "
                    "probe-only program covers scalar columns "
                    "(register 2-D/string workloads through the full "
                    "join)")
    for kname in keys:
        bdt = resident_local.columns[kname].dtype
        pdt = probe_local.columns[kname].dtype
        if bdt != pdt:
            raise TypeError(f"key {kname!r} dtype mismatch: resident {bdt} "
                            f"vs probe {pdt}")


def _make_join_agg_step(comm, spec, *, keys, k, shuffle_capacity_factor,
                        out_capacity_factor, out_rows_per_rank, shuffle,
                        compression_bits, dcn_on, resident: bool = False,
                        with_metrics: bool = False,
                        with_integrity: bool = False, metrics_static=None):
    """The fused join+aggregate step (JAX :804-983): partition and
    shuffle only the columns the reduction reads
    (``ops.aggregate.wire_columns``), with the materializing step's
    capacity arithmetic, and reduce each batch with
    ``ops.aggregate.local_join_aggregate``. Key mode is final per rank
    (a key lives in one (batch, rank)); probe and build modes combine
    the batches' partials, then exchange them by the hash of the group
    columns (a destination block holds the whole partials block, so a
    send never overflows) and combine what arrives. Returns
    ``step(build, probe) -> JoinResult``: ``table`` the finalized groups,
    ``total`` the would-be join row count, ``overflow`` any shuffle
    bucket or groups block that overflowed.

    ``resident``: the probe-only form (JAX ``_make_probe_agg_step``,
    :1234-1380): the build is a resident shard, already on its rank, so
    only the probe partitions and shuffles and every batch reduces
    against the whole shard; build-mode group keys refuse.

    With ``with_metrics`` the tape adds ``agg.groups`` (the rank's final
    groups) and, resident, ``resident.rows``; the partials exchange
    bills under ``partials.``. With ``with_integrity`` each side's
    shuffles digest under ``<side>.integrity`` and the partials exchange
    under ``partials.integrity`` (JAX :952-956)."""
    n = comm.n_ranks
    nb = k * n
    partials_mode = "hierarchical" if shuffle == "hierarchical" \
        else "padded"

    def step(build_local: Table, probe_local: Table):
        tape = _new_tape(with_metrics or with_integrity, metrics_static)
        if resident:
            _check_scalar_columns(build_local, probe_local, keys)
        for kname in keys:
            bc = build_local.columns[kname]
            pc = probe_local.columns[kname]
            if bc.ndim != 1:
                raise agg_ops.AggregatePushdownUnsupported(
                    f"aggregate pushdown unsupported: join key "
                    f"{kname!r} is a 2-D (string) column; the fused "
                    "reduction covers scalar keys — run string-key "
                    "workloads through the materializing join")
            if bc.dtype != pc.dtype:
                raise TypeError(
                    f"key {kname!r} dtype mismatch: build {bc.dtype} "
                    f"vs probe {pc.dtype}")
        bschema = agg_ops.table_schema(build_local)
        pschema = agg_ops.table_schema(probe_local)
        mode = agg_ops.resolve_agg_mode(spec, keys, bschema, pschema)
        if resident and mode == "build":
            raise agg_ops.AggregatePushdownUnsupported(
                "group keys live on the RESIDENT (build) side; the "
                "probe-only program keeps the build shards pinned and "
                "only exchanges probe rows, so build-keyed group-bys "
                "ride make_join_step(aggregate=) instead")
        wire_b, wire_p = agg_ops.wire_columns(spec, mode, keys, bschema,
                                              pschema)
        build_w = build_local.select(wire_b)
        probe_w = probe_local.select(wire_p)
        lanes_schema = agg_ops.partial_lane_schema(spec, bschema, pschema)
        group_names = list(keys) if mode == "key" \
            else list(spec.group_keys)

        b_cap, p_cap, out_cap = _step_capacities(
            build_w.capacity, probe_w.capacity, n, k,
            shuffle_capacity_factor, out_capacity_factor, out_rows_per_rank)
        groups_cap = agg_ops.resolve_groups_capacity(spec, out_cap)
        if tape is not None and resident:
            tape.add("resident.rows", build_local.num_valid())

        dev = build_local.device
        total = torch.zeros((), dtype=torch.int64, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        if nb == 1:
            batches = [(build_w, probe_w, overflow)]
        elif resident:
            batches = ((build_w, recv_p, ovf) for recv_p, ovf in _flat_batches(
                comm, ((probe_w, p_cap),), keys, k, shuffle, compression_bits,
                dcn_on, strings=False, tape=tape,
                with_integrity=with_integrity))
        else:
            batches = _flat_batches(
                comm, ((build_w, b_cap), (probe_w, p_cap)), keys, k,
                shuffle, compression_bits, dcn_on, strings=False, tape=tape,
                with_integrity=with_integrity)
        parts = []
        for b, (recv_b, recv_p, ovf) in enumerate(batches):
            with telemetry.span("join_agg",
                                **({} if nb == 1 else {"batch": b})):
                partials, t, _, ovf_j = agg_ops.local_join_aggregate(
                    recv_b, recv_p, keys, spec, mode, groups_cap)
            parts.append(partials)
            total = total + t
            overflow = overflow | ovf | ovf_j
        if mode in ("probe", "build"):
            # non-key groups recur across batches and ranks
            if len(parts) > 1:
                with telemetry.span("agg_combine"):
                    combined, _, ovf = agg_ops.combine_partials(
                        parts, spec, group_names, lanes_schema, groups_cap)
                overflow = overflow | ovf
                parts = [combined]
            if n > 1:
                with telemetry.span("partials_exchange"):
                    ptg = radix_hash_partition(parts[0], group_names, n)
                    recv, ovf_x = _batch_shuffle(
                        comm, ptg, 0, n, groups_cap, mode=partials_mode,
                        tape=None if tape is None else tape.scoped(
                            "partials"),
                        digest_tape=tape.scoped("partials.integrity")
                        if with_integrity else None)
                    combined, _, ovf_c = agg_ops.combine_partials(
                        [recv], spec, group_names, lanes_schema,
                        groups_cap)
                overflow = overflow | ovf_x | ovf_c
                parts = [combined]
        finals = [agg_ops.finalize_groups(p, spec, group_names)
                  for p in parts]
        out = finals[0] if len(finals) == 1 else _concat(finals)
        if tape is not None:
            # the rank's final groups: every group lives on one rank
            tape.add("agg.groups", out.num_valid())
        return _settle(comm, out, total, overflow, tape)

    return step


PROBE_SHUFFLE_MODES = ("padded", "ragged", "ppermute")


def make_probe_join_step(
    comm: Communicator,
    key="key",
    over_decomposition: int = 1,
    shuffle_capacity_factor: float = DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    out_capacity_factor: float = DEFAULT_OUT_CAPACITY_FACTOR,
    out_rows_per_rank: Optional[int] = None,
    build_payload: Optional[Sequence[str]] = None,
    probe_payload: Optional[Sequence[str]] = None,
    shuffle: str = "padded",
    compression_bits: Optional[int] = None,
    sort_mode: str = "flat",
    aggregate=None,
    kernel_config=None,
    with_metrics: bool = False,
    with_integrity: bool = False,
    metrics_static: Optional[dict] = None,
):
    """The probe-only join step against a resident build shard
    (service/resident.py; JAX :1007-1231): ``step(resident_local,
    probe_local) -> JoinResult``, to run under ``comm.spmd``.

    ``resident_local`` is one rank's shard of a registered build table
    that already went through the build side's partition, shuffle and
    key sort (``service.resident.make_resident_prep_step``). Only the
    probe partitions (``_flat_batches`` with the probe as its one side)
    and shuffles; each batch joins against the whole resident shard.
    Registration buckets rows by ``h % n`` and this step by ``h % (k *
    n)``; ``(h % kn) % n == h % n``, so matching keys meet at every
    over-decomposition, and each probe row rides one batch. The probe
    side's capacities are the full join's
    (:func:`resolve_probe_capacities`), so the same ladder relieves the
    same overflow flag; the build side has none to size.

    ``aggregate``: the fused join+aggregate on the probe-only dispatch
    (:func:`_make_join_agg_step` with ``resident=True``); build-mode
    group keys, explicit payload lists and ``kernel_config`` refuse as
    in the JAX package. The segmented sort, a multi-slice communicator,
    compression on the ragged wire, the skew sidecar and 2-D (string)
    columns are not part of the probe-only program. ``with_metrics``
    keeps the tape as :func:`make_join_step` does, with ``resident.rows``
    and the probe side's counters; ``with_integrity`` digests the probe
    side's shuffle under ``probe.integrity`` (JAX :1045-1205). The build
    side has no wire to digest: its image moved at registration.
    """
    n = comm.n_ranks
    k = over_decomposition
    if k < 1:
        raise ValueError("over_decomposition must be >= 1")
    if shuffle not in PROBE_SHUFFLE_MODES:
        raise ValueError(f"unknown shuffle mode {shuffle!r}")
    if sort_mode not in SORT_MODES:
        raise ValueError(
            f"unknown sort_mode {sort_mode!r}; pick one of {SORT_MODES}")
    if sort_mode != "flat":
        raise ValueError(
            "sort_mode='segmented' is not part of the probe-only "
            "program: the resident build image is one flat key-sorted "
            "run registered before the probe's segment count is known, "
            "and segments must be the SAME hash classes on both sides "
            "— segment-aligned resident images are unimplemented; "
            "serve resident joins with sort_mode='flat'")
    if compression_bits is not None and shuffle == "ragged":
        raise ValueError(
            "compression applies to the padded/ppermute shuffles; the "
            "ragged exchange already sends exact rows (combining the "
            "two is unimplemented)")
    if n > 1 and comm.n_slices > 1:
        raise ValueError(
            "probe-only joins route one GLOBAL collective over the "
            "mesh; a multi-slice topology would drag intra-slice "
            "traffic across DCN, and hierarchical probe-only serving "
            "is not implemented yet — register resident tables on a "
            "flat 1-D communicator")
    nb = k * n
    keys = [key] if isinstance(key, str) else list(key)

    if aggregate is not None:
        if not isinstance(aggregate, agg_ops.AggregateSpec):
            raise TypeError(
                "aggregate must be an ops.aggregate.AggregateSpec "
                f"(got {type(aggregate).__name__})")
        if build_payload is not None or probe_payload is not None:
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported: explicit payload "
                "lists conflict with the pushdown's own wire-column "
                "resolution")
        if kernel_config is not None:
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported: kernel_config tunes "
                "the materializing expand/compact gathers the fused "
                "reduction never runs — drop the knob")
        return _make_join_agg_step(
            comm, aggregate, keys=keys, k=k,
            shuffle_capacity_factor=shuffle_capacity_factor,
            out_capacity_factor=out_capacity_factor,
            out_rows_per_rank=out_rows_per_rank, shuffle=shuffle,
            compression_bits=compression_bits, dcn_on=False, resident=True,
            with_metrics=with_metrics, with_integrity=with_integrity,
            metrics_static=metrics_static)

    def step(resident_local: Table, probe_local: Table):
        tape = _new_tape(with_metrics or with_integrity, metrics_static)
        _check_scalar_columns(resident_local, probe_local, keys)
        p_cap, out_cap = resolve_probe_capacities(
            probe_local.capacity, n, k, shuffle_capacity_factor,
            out_capacity_factor, out_rows_per_rank)
        if tape is not None:
            tape.add("resident.rows", resident_local.num_valid())
        dev = probe_local.device
        total = torch.zeros((), dtype=torch.int64, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        batches = ([(probe_local, overflow)] if nb == 1 else _flat_batches(
            comm, ((probe_local, p_cap),), keys, k, shuffle,
            compression_bits, False, strings=False, tape=tape,
            with_integrity=with_integrity))
        parts = []
        for b, (recv_p, ovf) in enumerate(batches):
            with telemetry.span("join", **({} if nb == 1 else {"batch": b})):
                res = sort_merge_inner_join(
                    resident_local, recv_p, keys, out_cap,
                    build_payload=build_payload,
                    probe_payload=probe_payload,
                    kernel_config=kernel_config)
            parts.append(res.table)
            total = total + res.total
            overflow = overflow | ovf | res.overflow
        return _settle(comm, _concat(parts), total, overflow, tape)

    return step


def with_telemetry(program):
    """``program`` (a ``comm.spmd`` of a metrics step) as ``fn(build,
    probe) -> JoinResult`` with the block hung on the result as
    ``res.telemetry`` (host-side, as ``retry_report``)."""
    def fn(*args):
        res, metrics = program(*args)
        object.__setattr__(res, "telemetry", metrics)
        return res

    return fn


def spmd_join(comm: Communicator, step, with_aux: bool,
              local_inputs=False):
    """A join step (``make_join_step``, ``make_probe_join_step``, the
    aggregate steps; its tape on iff ``with_aux``, the step's
    ``with_metrics or with_integrity``) as ``comm.spmd``'s ``fn(build,
    probe) -> JoinResult``: with the tape on, the step's block hangs on
    the result as ``res.telemetry``. The one place the tape on/off
    choice picks the program's sharding."""
    if not with_aux:
        return comm.spmd(step, sharded_out=JOIN_SHARDED_OUT,
                         local_inputs=local_inputs)
    return with_telemetry(comm.spmd(step,
                                    sharded_out=JOIN_METRICS_SHARDED_OUT,
                                    local_inputs=local_inputs))


def make_distributed_join(comm: Communicator, local_inputs: bool = False,
                          with_metrics=None, with_integrity: bool = False,
                          **opts):
    """``fn(build, probe) -> JoinResult`` over row-sharded global tables
    (capacity divisible by n_ranks): the result table row-sharded, the
    global match count and overflow flag replicated. ``local_inputs``:
    the tables hold this process's rows only (``Communicator.local_rows``;
    see ``Communicator.spmd``). ``with_metrics=None`` resolves from the
    telemetry session (JAX :1383-1418); with metrics on, the result
    carries the step's ``Metrics`` as ``res.telemetry``. With
    ``with_integrity`` it always carries it, digests included: check it
    with ``integrity.verify_join_result``, or let
    :func:`distributed_inner_join`'s ``verify_integrity`` do it."""
    if with_metrics is None:
        with_metrics = telemetry.enabled()
    return spmd_join(comm, make_join_step(comm, with_metrics=with_metrics,
                                          with_integrity=with_integrity,
                                          **opts),
                     with_metrics or with_integrity,
                     local_inputs=local_inputs)


def skew_capacities(p_rows: int, hh_slots: Optional[int] = None,
                    hh_build_capacity: Optional[int] = None,
                    hh_probe_capacity: Optional[int] = None,
                    hh_out_capacity: Optional[int] = None) -> tuple:
    """The skew sidecar's blocks on a rank of ``p_rows`` probe rows, as
    ``(hh_build, hh_probe, hh_out)``: each given capacity as it is, else
    its default (``hh_slots * HH_BUILD_SLOTS_PER_HH`` broadcast build
    slots, 1/8 and 1/4 of the local probe rows, at least 1024). The
    step rounds the probe block up to 8 rows. The one copy of these
    defaults: the step, the ladder and the plans read them here."""
    slots = DEFAULT_HH_SLOTS if hh_slots is None else hh_slots
    return (int(hh_build_capacity or slots * HH_BUILD_SLOTS_PER_HH),
            int(hh_probe_capacity or max(p_rows // 8, 1024)),
            int(hh_out_capacity or max(p_rows // 4, 1024)))


def resolve_join_ladder(build: Table, probe: Table, n_ranks: int,
                        opts: dict, n_slices: int = 1) -> CapacityLadder:
    """Pop the sizing knobs from ``opts`` (mutated: what remains goes to
    ``make_join_step``), resolve the skew defaults exactly as the step
    would, and return the ladder at its first rung. The HH capacities
    are resolved here so that a retry can double them too, and so are
    the hierarchical codec's bits (JAX :1452-1467), so that a
    cross-slice residual overflow widens them first."""
    shuffle_f = opts.pop("shuffle_capacity_factor",
                         DEFAULT_SHUFFLE_CAPACITY_FACTOR)
    out_f = opts.pop("out_capacity_factor", DEFAULT_OUT_CAPACITY_FACTOR)
    skew_on = opts.get("skew_threshold") is not None
    comp_bits = opts.pop("compression_bits", None)
    if opts.get("shuffle") == "hierarchical" and comp_bits is None:
        comp_bits = resolve_dcn_bits(opts.get("dcn_codec", "auto"),
                                     n_slices=n_slices)
    hh_caps = (opts.pop("hh_build_capacity", None),
               opts.pop("hh_probe_capacity", None),
               opts.pop("hh_out_capacity", None))
    if skew_on:
        hh_caps = skew_capacities(probe.capacity // n_ranks,
                                  opts.get("hh_slots"), *hh_caps)
    hh_build_cap, hh_probe_cap, hh_out_cap = hh_caps
    return CapacityLadder(
        shuffle_capacity_factor=shuffle_f,
        out_capacity_factor=out_f,
        out_rows_per_rank=opts.pop("out_rows_per_rank", None),
        compression_bits=comp_bits,
        skew=skew_on,
        hh_build_capacity=hh_build_cap,
        hh_probe_capacity=hh_probe_cap,
        hh_out_capacity=hh_out_cap,
        local_probe_rows=probe.capacity // n_ranks,
    )


@telemetry.phased("entry")
def distributed_inner_join(build: Table, probe: Table, comm: Communicator,
                           key="key", auto_retry: int = 0,
                           verify_integrity: bool = False,
                           program_cache=None, explain: bool = False,
                           with_metrics=None, tuner=None,
                           **opts) -> JoinResult:
    """One-shot join: pad to rank-divisible capacity, run the step on
    every rank, and on overflow re-run with the ladder's escalated
    capacities up to ``auto_retry`` times (every capacity doubles; the
    skew path's HH probe and output blocks jump to full local probe
    coverage; compression bits widen first). The result carries the
    escalation trail as ``res.retry_report`` (faults.RetryReport).
    With plan validation on (``faults.plan_validation_enabled``), a
    violation recorded by an attempt's ragged shuffles raises
    ``faults.PlanValidationError`` after it, instead of a retry.

    ``verify_integrity``: every attempt's shuffles carry the wire digests
    (``with_integrity``), checked on the host after it. A mismatch on an
    attempt that did not overflow is a retry rung of its own,
    ``retry_integrity``: the SAME sizing again (the data was wrong, not
    too big), within the ``auto_retry`` budget; the last attempt raises
    ``integrity.IntegrityError`` instead of returning its rows. A clean
    verified result carries the report as ``res.integrity_report``. An
    overflowed attempt is not verified (a clamp drops rows by design;
    the overflow rung handles it). Through ``program_cache`` a
    mismatching attempt's program is evicted first: the corruption a
    fault plan injects is part of a program, so only a new one meets a
    new schedule, and a program that delivered corrupt rows must not
    serve again.

    ``program_cache``: a ``service.programs.JoinProgramCache`` over
    ``comm``. Every attempt then takes its program from the cache, keyed
    by the tables' shapes, the options, the rung's sizing and the
    attempt's index, so a repeat query, and a rung seen before, builds
    no step (JAX :1575-1587).

    ``with_metrics`` (None: the telemetry session's state): the result
    carries the final attempt's ``Metrics`` as ``res.telemetry``, folded
    into the session by ``telemetry.emit_metrics`` after the loop (one
    read to the host). ``explain``: the result carries the plan of the
    attempt that produced it (``planning.build_plan`` at the final
    rung) as ``res.plan``; its digest is the program cache's key for
    the same call. Building it is host arithmetic.

    ``tuner``: a ``planning.tuner.JoinTuner``, consulted on the unpadded
    tables and the caller's options (the basis the service keys its
    history on) before the ladder resolves. A workload whose ladder
    escalated before starts at the rung it resolved to: its sizing and
    its absolute rung label, so through ``program_cache`` it runs the
    program the cold run built, with no rung climbed; structural knobs
    the caller left unset may be filled from evidence. No history is the
    static resolution. The verdict rides as ``res.tuned``
    (``TunedConfig.as_record()``); the ladder still guards every run."""
    if with_metrics is None:
        with_metrics = telemetry.enabled()
    if program_cache is not None and program_cache.comm is not comm:
        # the cache's programs run over ITS communicator's ranks
        raise ValueError(
            "program_cache was built for a different communicator")
    n = comm.n_ranks
    opts = dict(opts)
    tuned = None
    if tuner is not None:
        # before pad_to, on the caller's options: the signature the
        # service's history lines were written under
        tuned = tuner.resolve(comm, build, probe, key=key,
                              with_integrity=verify_integrity,
                              opts=dict(opts, with_metrics=with_metrics))
        opts = tuned.apply(opts)
    build = build.pad_to(_round_up(build.capacity, n))
    probe = probe.pad_to(_round_up(probe.capacity, n))
    ladder = resolve_join_ladder(build, probe, n, opts,
                                 n_slices=comm.n_slices)
    if tuned is not None:
        ladder.seed_rung(tuned.rung)
    for attempt in range(auto_retry + 1):
        # the absolute rung label: a pre-sized first attempt carries the
        # label, and so the program signature, of the cold run's rung;
        # also the tape's retry_attempt_max (JAX :1601), which a step
        # with the tape off ignores
        rung = ladder.base_rung + attempt
        static = {"metrics_static": {"retry_attempt_max": rung},
                  "with_integrity": verify_integrity}
        sig = None
        if program_cache is not None:
            fn, _ = program_cache.get(build, probe, key=key, rung=rung,
                                      with_metrics=with_metrics, **static,
                                      **ladder.sizing(), **opts)
            sig = fn.signature
        else:
            fn = make_distributed_join(comm, key=key,
                                       with_metrics=with_metrics, **static,
                                       **ladder.sizing(), **opts)
        validating = faults.plan_validation_enabled()
        if validating:
            faults.clear_plan_violations()
        res = fn(build, probe)
        with telemetry.phase("sync.overflow"):
            overflow = bool(res.overflow)
        if validating:
            faults.check_plan_violations()
        report = None
        if verify_integrity and not overflow:
            report = integrity.verify_join_result(res)
        ladder.note(overflow,
                    integrity_ok=None if report is None else report.ok)
        corrupt = report is not None and not report.ok
        if corrupt and sig is not None:
            # a program that delivered corrupt rows serves no more
            program_cache.evict(sig)
        if attempt == auto_retry or not (overflow or corrupt):
            object.__setattr__(res, "retry_report", ladder.report())
            if tuned is not None:
                object.__setattr__(res, "tuned", tuned.as_record())
            if explain:
                from distributed_join_tpu_torch.planning.plan import (
                    build_plan,
                )

                object.__setattr__(res, "plan", build_plan(
                    comm, build, probe, key=key, rung=rung,
                    with_metrics=with_metrics, **static,
                    **ladder.sizing(), **opts))
            if report is not None:
                object.__setattr__(res, "integrity_report", report)
            telemetry.emit_metrics(getattr(res, "telemetry", None))
            if corrupt:
                raise integrity.IntegrityError(report)
            return res
        if overflow:
            ladder.escalate()
        else:
            ladder.hold("retry_integrity")
    raise AssertionError("unreachable")
