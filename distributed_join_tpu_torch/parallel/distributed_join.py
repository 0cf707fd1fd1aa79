"""The distributed join orchestrator: partition both tables ->
all-to-all shuffle -> local join, with over-decomposition batching and
the ``auto_retry`` capacity ladder, for every join type.

Port of ``distributed_join_tpu/parallel/distributed_join.py``: the flat
inner path of ``make_join_step`` (:517-801, including the skew sidecar
:568-628 and the single-bucket shortcut :640-655), the shuffle dispatch
``_batch_shuffle`` (:95-141), ``resolve_join_ladder`` (:1421) and
``distributed_inner_join`` (:1486). With n ranks and over-decomposition
k, rows hash into ``bucket = h % (k*n)``; ``dest = bucket % n`` and
``batch = bucket // n``, so one partition sort serves all k batches and
matching keys always share (dest, batch).

Three wires (``shuffle``): ``padded`` (capacity-padded blocks, one
all-to-all), ``ppermute`` (the same blocks over the communicator's
point-to-point chain) and ``ragged`` (the exact-size exchange, with
every string payload column on the byte-exact wire); the padded and
ppermute wires take the FoR + bit-pack codec (``compression_bits``).

Composite keys, 2-D (fixed-width string) payload columns and string
keys run as in the JAX package: 2-D columns are gathered and shuffled as
whole rows, and string keys are packed into 64-bit word columns once,
before hashing (JAX :536-552), and rebuilt on the way out (:783-790).
Typed joins (``join_type``, ops/join.JOIN_TYPES) run each bucket's local
join with the type: hash partitioning puts every key's rows of both
sides in one bucket, so unmatched rows are local. The JAX step's other
options (the hierarchical wire, segmented sort, metrics and integrity
digests, aggregate pushdown) refuse by name.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from distributed_join_tpu_torch.ops.hashing import hash_columns
from distributed_join_tpu_torch.ops.join import (
    JOIN_TYPES,
    JoinResult,
    patch_string_lengths,
    sort_merge_inner_join,
)
from distributed_join_tpu_torch.ops.partition import radix_hash_partition
from distributed_join_tpu_torch.parallel import skew
from distributed_join_tpu_torch.parallel.communicator import Communicator
from distributed_join_tpu_torch.parallel import faults
from distributed_join_tpu_torch.parallel.faults import CapacityLadder
from distributed_join_tpu_torch.parallel.shuffle import (
    prefetch_ragged_plans,
    shuffle_padded,
    shuffle_padded_compressed,
    shuffle_ragged,
)
from distributed_join_tpu_torch.table import Table
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
# The table row-sharded; the summed total and overflow replicated.
JOIN_SHARDED_OUT = JoinResult(table=False, total=True, overflow=True)

# Options of the JAX package's join step and driver that the port does
# not have, with the default each may still be passed as.
_UNPORTED = {
    "sort_mode": ("the segmented-sort pipeline", "flat"),
    "sort_segments": ("the segmented-sort pipeline", None),
    "dcn_codec": ("the hierarchical DCN codec", "auto"),
    "aggregate": ("aggregate pushdown", None),
    "with_metrics": ("device metrics", False),
    "with_integrity": ("wire-integrity digests", False),
    "metrics_static": ("device metrics", None),
    "verify_integrity": ("wire-integrity digests", False),
    "program_cache": ("the serving program cache", None),
    "explain": ("plan explain", False),
    "tuner": ("the autotuner", None),
}


def _refuse_unported(opts: dict) -> None:
    for name, value in opts.items():
        if name not in _UNPORTED:
            raise TypeError(f"unexpected join option {name!r}")
        what, default = _UNPORTED[name]
        if value is not None and value != default:
            raise NotImplementedError(
                f"{name}={value!r}: {what} is not part of the port")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _varwidth_cols(table: Table) -> list:
    """The 2-D uint8 columns with a ``<name>#len`` companion and a width
    divisible by 4: the columns the ragged wire ships byte-exactly (JAX
    :80)."""
    return [name for name, c in table.columns.items()
            if c.ndim == 2 and c.dtype == torch.uint8 and c.shape[1] % 4 == 0
            and name + LEN_SUFFIX in table.columns]


def _batch_shuffle(comm, pt, batch: int, n_ranks: int, capacity: int,
                   mode: str = "padded",
                   compression_bits: Optional[int] = None, varwidth=None):
    """One batch's shuffle of one side (JAX :95): the received table and
    the overflow flag. The ragged wire's receive buffer holds what the
    padded layout would flatten to (``n_ranks * capacity`` rows), and
    ``capacity_per_bucket`` gives it the padded wire's overflow
    contract, so ``auto_retry`` fires under the same conditions."""
    if mode == "ragged":
        return shuffle_ragged(
            comm, pt, n_ranks * capacity, bucket_start=batch * n_ranks,
            capacity_per_bucket=capacity, varwidth=varwidth)
    padded, counts, overflow, _ = pt.to_padded(
        capacity, bucket_start=batch * n_ranks, n_buckets=n_ranks)
    via = "ppermute" if mode == "ppermute" else "all_to_all"
    if compression_bits is not None:
        table, _, c_ovf = shuffle_padded_compressed(
            comm, padded, counts, capacity, bits=compression_bits, via=via)
        return table, overflow | c_ovf
    table, _ = shuffle_padded(comm, padded, counts, capacity, via=via)
    return table, overflow


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
    **unported,
):
    """The per-rank join step ``step(build_local, probe_local) ->
    JoinResult``, to run under ``comm.spmd``.

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

    ``shuffle``: the wire, ``padded``, ``ppermute`` or ``ragged``
    (``hierarchical`` is not part of the port). With ``ragged``, each
    side's string payload columns (2-D uint8 with a ``#len`` companion,
    width divisible by 4) ride the byte-exact wire, the partition
    ordering each bucket by the first one's length. ``compression_bits``
    (2, 4, 8, 16 or 32) puts the FoR + bit-pack codec on the padded and
    ppermute wires; a block it cannot pack raises the overflow flag.
    The skew sidecar's light rows ride the chosen wire.
    """
    _refuse_unported(unported)
    if shuffle not in SHUFFLE_MODES:
        # checked for every configuration: a one-bucket join never
        # reaches the shuffle, and a typo must not pass
        raise ValueError(f"unknown shuffle mode {shuffle!r}")
    if compression_bits is not None and shuffle == "ragged":
        raise ValueError(
            "compression applies to the padded/ppermute shuffles; the "
            "ragged exchange already sends exact rows (combining the "
            "two is unimplemented)")
    if shuffle == "hierarchical":
        raise NotImplementedError(
            "shuffle='hierarchical': the hierarchical (slice, chip) "
            "shuffle is not part of the port")
    if join_type not in JOIN_TYPES:
        raise ValueError(f"unknown join_type {join_type!r}; expected one "
                         f"of {JOIN_TYPES}")
    if join_type != "inner" and skew_threshold is not None:
        raise ValueError(
            f"join_type={join_type!r} does not combine with the skew "
            "sidecar: broadcast heavy-hitter build rows are replicated on "
            "every rank, so an unmatched heavy build row would emit once "
            "PER RANK; run typed joins without skew_threshold")
    n = comm.n_ranks
    k = over_decomposition
    if k < 1:
        raise ValueError("over_decomposition must be >= 1")
    nb = k * n
    keys = [key] if isinstance(key, str) else list(key)

    def step(build_local: Table, probe_local: Table) -> JoinResult:
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
        b_cap = _round_up(int(math.ceil(
            b_rows / nb * shuffle_capacity_factor)), 8)
        p_cap = _round_up(int(math.ceil(
            p_rows / nb * shuffle_capacity_factor)), 8)
        if out_rows_per_rank is not None:
            out_cap = _round_up(int(math.ceil(out_rows_per_rank / k)), 8)
        else:
            out_cap = _round_up(int(math.ceil(
                p_rows / k * out_capacity_factor)), 8)

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
            # Classify on the key-tuple hash: it only has to be
            # consistent across sides and ranks (a collision merely
            # makes a key heavy; the HH join matches on the real key).
            bh = hash_columns([build_local.columns[c] for c in keys_eff])
            ph = hash_columns([probe_local.columns[c] for c in keys_eff])
            bh, ph = bh.view(torch.uint64), ph.view(torch.uint64)
            hh = skew.global_heavy_hitters(
                comm, ph, probe_local.valid, hh_slots,
                threshold=int(skew_threshold * p_rows))
            is_hh_b = skew.mark_heavy(bh, hh)
            is_hh_p = skew.mark_heavy(ph, hh)
            hh_build, ovf_hb = skew.broadcast_heavy_build(
                comm, build_local, is_hh_b,
                hh_build_capacity or hh_slots * HH_BUILD_SLOTS_PER_HH,
                kernel_config=kernel_config)
            # heavy probe rows stay local, compacted into a right-sized
            # block first, so the HH join does not re-sort all p_rows
            hh_probe_cap = _round_up(
                hh_probe_capacity or max(p_rows // 8, 1024), 8)
            hh_probe, _, ovf_hp = skew.extract_prefix(
                probe_local, probe_local.valid & is_hh_p, hh_probe_cap,
                kernel_config=kernel_config)
            hh_res = local_join(hh_build, hh_probe,
                                hh_out_capacity or max(p_rows // 4, 1024))
            parts.append(hh_res.table)
            total = total + hh_res.total
            overflow = overflow | ovf_hb | ovf_hp | hh_res.overflow
            build_local = Table(build_local.columns,
                                build_local.valid & ~is_hh_b)
            probe_local = Table(probe_local.columns,
                                probe_local.valid & ~is_hh_p)

        if nb == 1:
            res = local_join(build_local, probe_local)
            parts.append(res.table)
            total = total + res.total
            overflow = overflow | res.overflow
        else:
            # The byte-exact string wire: each bucket ordered by its
            # first string column's length, descending.
            sides = []
            for t, cap in ((build_local, b_cap), (probe_local, p_cap)):
                vw = _varwidth_cols(t) if shuffle == "ragged" else []
                pt = radix_hash_partition(
                    t, keys_eff, nb,
                    order_within=vw[0] + LEN_SUFFIX if vw else None)
                sides.append((pt, cap, vw))
            if shuffle == "ragged":
                # both sides' plans in one read to the host
                prefetch_ragged_plans(comm, [(pt, vw) for pt, _, vw in sides])
            for b in range(k):
                recv = []
                for pt, cap, vw in sides:
                    table, ovf = _batch_shuffle(
                        comm, pt, b, n, cap, mode=shuffle,
                        compression_bits=compression_bits, varwidth=vw)
                    recv.append(table)
                    overflow = overflow | ovf
                res = local_join(*recv)
                parts.append(res.table)
                total = total + res.total
                overflow = overflow | res.overflow
        out = Table(
            {name: torch.cat([t.columns[name] for t in parts])
             for name in parts[0].column_names},
            torch.cat([t.valid for t in parts]))
        if str_spec:
            out = patch_string_lengths(
                rebuild_string_keys(out, str_spec, keys), keys, join_type)
        total = comm.psum(total)
        overflow = comm.psum(overflow.to(torch.int32)) > 0
        return JoinResult(out, total=total, overflow=overflow)

    return step


def make_distributed_join(comm: Communicator, local_inputs: bool = False,
                          **opts):
    """``fn(build, probe) -> JoinResult`` over row-sharded global tables
    (capacity divisible by n_ranks): the result table row-sharded, the
    global match count and overflow flag replicated. ``local_inputs``:
    the tables hold this process's rows only (``Communicator.local_rows``;
    see ``Communicator.spmd``)."""
    return comm.spmd(make_join_step(comm, **opts),
                     sharded_out=JOIN_SHARDED_OUT, local_inputs=local_inputs)


def resolve_join_ladder(build: Table, probe: Table, n_ranks: int,
                        opts: dict) -> CapacityLadder:
    """Pop the sizing knobs from ``opts`` (mutated: what remains goes to
    ``make_join_step``), resolve the skew defaults exactly as the step
    would, and return the ladder at its first rung. The HH capacities
    are resolved here so that a retry can double them too."""
    shuffle_f = opts.pop("shuffle_capacity_factor",
                         DEFAULT_SHUFFLE_CAPACITY_FACTOR)
    out_f = opts.pop("out_capacity_factor", DEFAULT_OUT_CAPACITY_FACTOR)
    skew_on = opts.get("skew_threshold") is not None
    comp_bits = opts.pop("compression_bits", None)
    hh_build_cap = opts.pop("hh_build_capacity", None)
    hh_probe_cap = opts.pop("hh_probe_capacity", None)
    hh_out_cap = opts.pop("hh_out_capacity", None)
    if skew_on:
        hh_build_cap = hh_build_cap or (
            opts.get("hh_slots", DEFAULT_HH_SLOTS) * HH_BUILD_SLOTS_PER_HH)
        hh_probe_cap = hh_probe_cap or max(
            probe.capacity // (8 * n_ranks), 1024)
        hh_out_cap = hh_out_cap or max(
            probe.capacity // (4 * n_ranks), 1024)
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


def distributed_inner_join(build: Table, probe: Table, comm: Communicator,
                           key="key", auto_retry: int = 0,
                           **opts) -> JoinResult:
    """One-shot join: pad to rank-divisible capacity, run the step on
    every rank, and on overflow re-run with the ladder's escalated
    capacities up to ``auto_retry`` times (every capacity doubles; the
    skew path's HH probe and output blocks jump to full local probe
    coverage; compression bits widen first). The result carries the
    escalation trail as ``res.retry_report`` (faults.RetryReport).
    With plan validation on (``faults.plan_validation_enabled``), a
    violation recorded by an attempt's ragged shuffles raises
    ``faults.PlanValidationError`` after it, instead of a retry."""
    _refuse_unported({k: v for k, v in opts.items() if k in _UNPORTED})
    n = comm.n_ranks
    build = build.pad_to(_round_up(build.capacity, n))
    probe = probe.pad_to(_round_up(probe.capacity, n))
    opts = dict(opts)
    ladder = resolve_join_ladder(build, probe, n, opts)
    for attempt in range(auto_retry + 1):
        fn = make_distributed_join(comm, key=key, **ladder.sizing(), **opts)
        validating = faults.plan_validation_enabled()
        if validating:
            faults.clear_plan_violations()
        res = fn(build, probe)
        overflow = bool(res.overflow)
        if validating:
            faults.check_plan_violations()
        ladder.note(overflow)
        if attempt == auto_retry or not overflow:
            object.__setattr__(res, "retry_report", ladder.report())
            return res
        ladder.escalate()
    raise AssertionError("unreachable")
