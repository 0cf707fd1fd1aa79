"""EXPLAIN for the distributed join: the plan, before any execution.

Port of ``distributed_join_tpu/planning/plan.py``: ``SidePlan``,
``JoinPlan`` (``as_record``, ``explain_record``, ``format``),
``build_plan`` with ``_predict_wire`` and ``_predict_memory``,
``abstract_tables``, ``explain_join``, ``build_probe_plan`` and
``build_exchange_plan``. A plan resolves everything a join step would
(capacities, wire bytes a side and a tier, the memory footprint, the
skew sidecar's blocks, the cost model's prediction) from the tables'
shapes and the options alone: it builds no step and touches no device.

Two agreements hold, as in the JAX package:

- **Plan digest == cache key.** ``digest`` is the port's
  :class:`~..service.programs.JoinSignature` digest of the same call
  (the probe-only plan takes the resident program's
  ``ResidentSignature`` digest), so an explain and the program a run
  dispatches cannot disagree. The digest is the port's own, not the
  JAX package's.
- **Padded wire bytes are exact.** The padded, ppermute, compressed and
  hierarchical wires move static blocks, so the predicted bytes equal
  the device metrics tape's ``wire_bytes`` (and ``wire_bytes_ici`` /
  ``wire_bytes_dcn``) to the byte. The ragged wire ships actual rows:
  its bytes are an estimate and say so (``wire.exact = false``).

The capacities are the step's own arithmetic, called, not copied
(``parallel/distributed_join.resolve_join_ladder``, ``_step_capacities``
and ``resolve_probe_capacities``; ``ops/segmented``'s owners one level
down), so a plan cannot drift from the program it describes. Abstract
tables are ``Table``s of ``meta`` tensors: shapes and dtypes, no data.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional

import torch

from distributed_join_tpu_torch.planning.cost import (
    DEFAULT_DCN_CODEC_BITS,
    CostModel,
    predict,
    predict_exchange,
    resolve_dcn_codec,
)

EXPLAIN_SCHEMA_VERSION = 1

_DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "int32": 4, "uint32": 4, "float32": 4, "int64": 8, "uint64": 8,
    "float64": 8,
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _itemsize(dtype: str) -> int:
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r} in plan schema")


def _row_bytes(columns) -> int:
    """Fixed-width wire bytes a row over (name, dtype, trailing)."""
    return sum(_itemsize(dtype) * math.prod(trailing or (1,))
               for _, dtype, trailing in columns)


@dataclasses.dataclass(frozen=True)
class SidePlan:
    """One side: the columns that ride the partition and the shuffle
    (after the string-key packing), global and local rows, and the row
    width on the wire."""

    rows_global: int
    rows_local: int
    columns: tuple            # ((name, dtype, trailing), ...) sorted
    varwidth: tuple           # byte-exact string columns (ragged wire)
    row_bytes: int            # bytes a row, varwidth columns included
    row_bytes_fixed: int      # bytes a row without the varwidth columns

    def as_record(self) -> dict:
        return {
            "rows_global": self.rows_global,
            "rows_local": self.rows_local,
            "columns": [list(c) for c in self.columns],
            "varwidth": list(self.varwidth),
            "row_bytes": self.row_bytes,
            "row_bytes_fixed": self.row_bytes_fixed,
        }


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """The resolved description of one join program; ``digest`` is its
    program-cache key."""

    digest: str
    n_ranks: int
    over_decomposition: int
    key: tuple
    shuffle: str
    compression_bits: Optional[int]
    with_metrics: bool
    with_integrity: bool
    build: SidePlan
    probe: SidePlan
    capacities: dict
    skew: Optional[dict]
    wire: dict
    memory: dict
    resolved_options: dict
    cost: dict
    pipeline: str = "join"
    probe_only: bool = False
    aggregate: Optional[dict] = None
    n_slices: int = 1

    @property
    def n_buckets(self) -> int:
        return self.n_ranks * self.over_decomposition

    def as_record(self) -> dict:
        return {
            "pipeline": self.pipeline,
            "probe_only": self.probe_only,
            "aggregate": self.aggregate,
            "signature_digest": self.digest,
            "n_ranks": self.n_ranks,
            "n_slices": self.n_slices,
            "over_decomposition": self.over_decomposition,
            "n_buckets": self.n_buckets,
            "key": list(self.key),
            "shuffle": self.shuffle,
            "compression_bits": self.compression_bits,
            "with_metrics": self.with_metrics,
            "with_integrity": self.with_integrity,
            "build": self.build.as_record(),
            "probe": self.probe.as_record(),
            "capacities": dict(self.capacities),
            "skew": self.skew,
            "wire": self.wire,
            "memory": self.memory,
            "resolved_options": self.resolved_options,
        }

    def explain_record(self) -> dict:
        """The ``explain.json`` body: no timestamps, so the same query
        spec gives the same bytes."""
        return {
            "schema_version": EXPLAIN_SCHEMA_VERSION,
            "kind": "explain",
            "plan": self.as_record(),
            "cost": self.cost,
        }

    def format(self) -> str:
        """Human rendering (the drivers' ``--explain`` lines)."""
        c = self.capacities
        w = self.wire
        lines = [
            f"plan {self.digest[:16]}: {self.shuffle} shuffle, "
            f"{self.n_ranks} rank(s) x k={self.over_decomposition}"
            + (f", compression_bits={self.compression_bits}"
               if self.compression_bits is not None else ""),
            f"  build {self.build.rows_global} rows "
            f"({self.build.row_bytes} B/row) | probe "
            f"{self.probe.rows_global} rows "
            f"({self.probe.row_bytes} B/row)",
            f"  capacities: shuffle {c['shuffle_build_per_bucket']}/"
            f"{c['shuffle_probe_per_bucket']} rows/bucket, out "
            f"{c['out_rows_per_batch']} rows/batch",
            f"  wire: build {w['build']['bytes_total']} B, probe "
            f"{w['probe']['bytes_total']} B "
            f"({'EXACT' if w['exact'] else 'estimate'})",
            f"  memory/rank: {self.memory['total_per_rank_bytes']} B"
            + ("" if self.memory["fits_hbm"] else
               "  [EXCEEDS the card's memory]"),
            f"  predicted: {self.cost['total_s']}s "
            f"({self.cost['predicted_m_rows_per_sec_per_rank']} "
            f"M rows/s/rank, {self.cost['platform']})",
        ]
        if self.skew is not None:
            lines.insert(3, f"  skew: threshold="
                            f"{self.skew['threshold']}, hh "
                            f"{c.get('hh_build')}/{c.get('hh_probe')}/"
                            f"{c.get('hh_out')}")
        return "\n".join(lines)


# -- schema resolution ----------------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def column_schema(table) -> dict:
    """{name: (dtype, trailing shape)} of a Table: metadata only (what
    :func:`abstract_table` takes)."""
    return {name: (_dtype_name(c.dtype), tuple(int(d) for d in c.shape[1:]))
            for name, c in table.columns.items()}


def _sorted_cols(cols: dict) -> tuple:
    return tuple(sorted((name, dtype, trailing)
                        for name, (dtype, trailing) in cols.items()))


def _wire_schemas(build, probe, keys, build_payload, probe_payload):
    """The columns each side partitions and shuffles after
    ``utils.strings.prepare_string_key_join``'s packing, at the shape
    level: ``(build_cols, probe_cols, keys_eff)``."""
    from distributed_join_tpu_torch.utils.strings import (
        LEN_SUFFIX,
        string_key_word_names,
    )

    bcols = column_schema(build)
    pcols = column_schema(probe)
    str_keys = [k for k in keys if len(bcols[k][1]) == 1]
    if not str_keys:
        return _sorted_cols(bcols), _sorted_cols(pcols), tuple(keys)
    drop = {k + LEN_SUFFIX for k in str_keys}
    if build_payload is None:
        build_payload = [n for n in bcols if n not in keys and n not in drop]
    keys_eff = []
    for i, k in enumerate(keys):
        dtype, trailing = bcols[k]
        if len(trailing) != 1:
            keys_eff.append(k)
            continue
        # the 2-D uint8 key becomes 64-bit word columns on both sides
        word_names = string_key_word_names(i, (trailing[0] + 7) // 8)
        for nm in word_names:
            bcols[nm] = ("uint64", ())
            pcols[nm] = ("uint64", ())
        del bcols[k], pcols[k]
        keys_eff.extend(word_names)
    keep_b = set(keys_eff) | set(build_payload)
    bcols = {n: v for n, v in bcols.items() if n in keep_b}
    return _sorted_cols(bcols), _sorted_cols(pcols), tuple(keys_eff)


def _varwidth_names(columns) -> tuple:
    """``distributed_join._varwidth_cols`` over a plan schema."""
    names = {name for name, _, _ in columns}
    return tuple(name for name, dtype, trailing in columns
                 if dtype == "uint8" and len(trailing) == 1
                 and trailing[0] % 4 == 0 and name + "#len" in names)


def _codec_eligible_col(name: str, dtype, trailing) -> bool:
    """``shuffle._codec_eligible`` over a plan schema: scalar integer
    columns of 4 or 8 bytes that are not string word columns."""
    from distributed_join_tpu_torch.utils.strings import _WORD_PREFIX

    return (not trailing
            and dtype in ("int32", "uint32", "int64", "uint64")
            and not name.startswith(_WORD_PREFIX))


# -- wire bytes ------------------------------------------------------------


_COMPRESSION_BLOCK = 256   # shuffle_padded_compressed's block


def _codec_bytes(rows: int, bits: int) -> int:
    """One frame stream's bytes: the word plane and an int64 frame a
    block of ``rows`` rows padded to the block."""
    n_pad = _round_up(max(rows, 1), _COMPRESSION_BLOCK)
    return n_pad * bits // 8 + (n_pad // _COMPRESSION_BLOCK) * 8


def _padded_side_bytes(n: int, k: int, cap: int, columns,
                       compression_bits: Optional[int]):
    """A rank's wire bytes of one side over the k batches of the padded
    or ppermute wire, as the tape bills them: the whole (n, cap) block a
    column, or the codec's planes a destination. Returns
    ``(sent, raw)``."""
    raw = sent = 0
    for name, dtype, trailing in columns:
        col_bytes = n * cap * _itemsize(dtype) * math.prod(trailing or (1,))
        raw += col_bytes
        if compression_bits is None or not _codec_eligible_col(
                name, dtype, trailing):
            sent += col_bytes
        else:
            sent += n * _codec_bytes(cap, compression_bits)
    return k * sent, k * raw


def _hier_side_bytes(n: int, n_slices: int, k: int, cap: int, columns,
                     dcn_bits: Optional[int]):
    """A rank's bytes of one side on each tier of the hierarchical wire
    over the k batches: the whole block on the intra-slice hop; on the
    cross-slice hop the same block raw, or the codec's planes, one frame
    stream a destination slice (``chips * cap`` rows). Returns ``(ici,
    dcn_sent, dcn_raw)``."""
    chips = n // n_slices
    ici = dcn_raw = dcn_sent = 0
    for name, dtype, trailing in columns:
        col_bytes = n * cap * _itemsize(dtype) * math.prod(trailing or (1,))
        ici += col_bytes
        dcn_raw += col_bytes
        if dcn_bits is None or not _codec_eligible_col(name, dtype, trailing):
            dcn_sent += col_bytes
        else:
            dcn_sent += n_slices * _codec_bytes(chips * cap, dcn_bits)
    return k * ici, k * dcn_sent, k * dcn_raw


def _predict_wire(n: int, k: int, shuffle: str,
                  compression_bits: Optional[int],
                  build: SidePlan, probe: SidePlan,
                  b_cap: int, p_cap: int, n_slices: int = 1,
                  dcn_codec_on: bool = False) -> dict:
    if n * k == 1:
        zero = {"bytes_per_rank": 0, "bytes_total": 0, "rows_estimate": 0}
        return {"exact": True, "build": dict(zero), "probe": dict(zero),
                "collectives_per_step": 0}
    hier = shuffle == "hierarchical" and n_slices > 1
    if shuffle == "hierarchical" and not hier:
        # one slice routes the flat raw padded wire
        compression_bits = None
    sides = {}
    exact = shuffle in ("padded", "ppermute", "hierarchical")
    for side, cap, sp in (("build", b_cap, build), ("probe", p_cap, probe)):
        if hier:
            dcn_bits = ((compression_bits or DEFAULT_DCN_CODEC_BITS)
                        if dcn_codec_on else None)
            ici, dcn, dcn_raw = _hier_side_bytes(
                n, n_slices, k, cap, sp.columns, dcn_bits)
            sides[side] = {
                "bytes_per_rank": int(ici + dcn),
                "bytes_total": int(ici + dcn) * n,
                "rows_estimate": sp.rows_local * n,
                "ici_bytes_per_rank": int(ici),
                "dcn_bytes_per_rank": int(dcn),
            }
            if dcn_bits is not None:
                sides[side]["dcn_raw_bytes_per_rank"] = int(dcn_raw)
            continue
        if shuffle == "ragged":
            # actual rows, every one assumed valid, string planes at full
            # width: an upper bound on a masked table
            vw_bytes = sp.row_bytes - sp.row_bytes_fixed
            per_rank = sp.rows_local * sp.row_bytes_fixed \
                + sp.rows_local * vw_bytes
            raw = per_rank
        else:
            per_rank, raw = _padded_side_bytes(n, k, cap, sp.columns,
                                               compression_bits)
        sides[side] = {
            "bytes_per_rank": int(per_rank),
            "bytes_total": int(per_rank) * n,
            "rows_estimate": sp.rows_local * n,
        }
        if compression_bits is not None:
            sides[side]["raw_bytes_per_rank"] = int(raw)
    # data-plane collectives a step: a side and batch, the count
    # exchange and one a column (two for a codec column); hierarchical:
    # two hops each, three for a codec column
    coll = 0
    for sp in (build, probe):
        if hier:
            per_side = 2
            for name, dtype, trailing in sp.columns:
                eligible = (dcn_codec_on
                            and _codec_eligible_col(name, dtype, trailing))
                per_side += 3 if eligible else 2
            coll += k * per_side
            continue
        per_col = 2 if compression_bits is not None else 1
        coll += k * (1 + per_col * len(sp.columns))
    return {"exact": exact, "build": sides["build"], "probe": sides["probe"],
            "collectives_per_step": coll}


# -- the builder -------------------------------------------------------------


def _jsonable(obj):
    """Canonical option values as JSON-stable lists and dicts."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


def _agg_record(agg_ops, spec, mode, keys, bsch, psch, out_cap,
                capacities):
    """The aggregate block of a plan and its partials row width."""
    groups_cap = agg_ops.resolve_groups_capacity(spec, out_cap)
    capacities["groups_per_rank"] = groups_cap
    partial_cols = agg_ops.partial_columns(spec, mode, keys, bsch, psch)
    row_bytes = sum(_itemsize(dt) for _, dt in partial_cols)
    return {
        "spec": spec.as_record(),
        "mode": mode,
        "groups_per_rank": groups_cap,
        "partial_columns": [list(c) for c in partial_cols],
        "partial_row_bytes": row_bytes,
    }, len(partial_cols)


def build_plan(comm, build, probe, key="key", with_metrics=None,
               cost_model: Optional[CostModel] = None, rung: int = 0,
               **opts) -> JoinPlan:
    """The :class:`JoinPlan` of exactly the program
    ``make_join_step(comm, key=key, **opts)`` builds over these tables,
    building nothing. ``build``/``probe`` are Tables, of ``meta`` tensors
    or real ones (only shapes and dtypes are read). ``with_metrics=None``
    resolves from the telemetry session and ``rung`` is the ladder rung,
    as the program cache keys them, so the digest equals the cache key
    of the run the plan predicts. Options the step refuses raise the
    step's errors."""
    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_HH_SLOTS,
        SHUFFLE_MODES,
        SORT_MODES,
        _step_capacities,
        skew_capacities,
    )
    from distributed_join_tpu_torch.service.programs import JoinSignature

    if with_metrics is None:
        with_metrics = telemetry.enabled()
    keys = [key] if isinstance(key, str) else list(key)
    sig = JoinSignature.of(comm, build, probe, key=key,
                           with_metrics=with_metrics, rung=rung, **opts)
    resolved = dict(sig.options)

    n = sig.n_ranks
    n_slices = sig.n_slices
    k = int(resolved.get("over_decomposition") or 1)
    nb = n * k
    shuffle = resolved.get("shuffle") or "padded"
    comp_bits = resolved.get("compression_bits")
    # the step's refusals, so an explain of a config the step would
    # refuse is the same error
    if k < 1:
        raise ValueError("over_decomposition must be >= 1")
    if shuffle not in SHUFFLE_MODES:
        raise ValueError(f"unknown shuffle mode {shuffle!r}")
    if comp_bits is not None and shuffle == "ragged":
        raise ValueError(
            "compression applies to the padded/ppermute shuffles; the "
            "ragged exchange already sends exact rows (combining the "
            "two is unimplemented)")
    sort_mode = resolved.get("sort_mode") or "flat"
    sort_segments = resolved.get("sort_segments")
    if sort_mode not in SORT_MODES:
        raise ValueError(
            f"unknown sort_mode {sort_mode!r}; pick one of {SORT_MODES}")
    if sort_mode == "flat" and sort_segments is not None:
        raise ValueError(
            "sort_segments applies to sort_mode='segmented' only: drop "
            "the knob or pass sort_mode='segmented'")
    dcn_knob = resolved.get("dcn_codec") or "auto"
    if shuffle == "hierarchical":
        if comp_bits is not None and dcn_knob == "off":
            raise ValueError(
                "dcn_codec='off' contradicts compression_bits="
                f"{comp_bits} (hierarchical mode compresses only the "
                "cross-slice tier)")
        dcn_on = resolve_dcn_codec(dcn_knob)
    else:
        resolve_dcn_codec(dcn_knob)
        dcn_on = False
        if n > 1 and n_slices > 1:
            raise ValueError(
                f"shuffle {shuffle!r} routes one global collective over a "
                "multi-slice mesh: use shuffle='hierarchical' (or a flat "
                "communicator)")
    if sort_mode == "segmented":
        if shuffle == "ragged":
            raise ValueError(
                "sort_mode='segmented' needs static per-(source, segment) "
                "receive boundaries: use shuffle='padded'/'ppermute' (or "
                "sort_mode='flat')")
        if comp_bits is not None:
            raise ValueError(
                "sort_mode='segmented' does not combine with the "
                "compressed wire: drop compression_bits (or use "
                "sort_mode='flat')")
        if shuffle == "hierarchical" and dcn_on and n_slices > 1:
            raise ValueError(
                "sort_mode='segmented' does not combine with the "
                "hierarchical DCN codec: pass dcn_codec='off' (or "
                "sort_mode='flat')")
        if resolved.get("kernel_config") is not None:
            raise ValueError(
                "sort_mode='segmented' ignores kernel_config: drop the knob")
    shuffle_f = float(resolved["shuffle_capacity_factor"])
    out_f = float(resolved["out_capacity_factor"])
    out_rows = resolved.get("out_rows_per_rank")

    b_global, p_global = sig.build_capacity, sig.probe_capacity
    b_local, p_local = b_global // n, p_global // n

    wb, wp, keys_eff = _wire_schemas(
        build, probe, keys,
        resolved.get("build_payload"), resolved.get("probe_payload"))
    agg_spec = opts.get("aggregate")
    agg_mode = None
    if agg_spec is not None:
        from distributed_join_tpu_torch.ops import aggregate as agg_ops

        if sort_mode == "segmented":
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported under "
                "sort_mode='segmented': run aggregates with "
                "sort_mode='flat'")
        if resolved.get("skew_threshold") is not None:
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported: the skew sidecar is not "
                "part of the fused pipeline")
        if resolved.get("build_payload") or resolved.get("probe_payload"):
            raise agg_ops.AggregatePushdownUnsupported(
                "aggregate pushdown unsupported: explicit payload lists "
                "conflict with the pushdown's wire-column resolution")
        bcols0 = column_schema(build)
        for kname in keys:
            if bcols0[kname][1]:
                raise agg_ops.AggregatePushdownUnsupported(
                    f"aggregate pushdown unsupported: join key {kname!r} "
                    "is a 2-D (string) column")
        bsch = {name: (dtype, 1 + len(tr)) for name, dtype, tr in wb}
        psch = {name: (dtype, 1 + len(tr)) for name, dtype, tr in wp}
        agg_mode = agg_ops.resolve_agg_mode(agg_spec, keys_eff, bsch, psch)
        need_b, need_p = agg_ops.wire_columns(
            agg_spec, agg_mode, keys_eff, bsch, psch)
        wb = tuple(c for c in wb if c[0] in set(need_b))
        wp = tuple(c for c in wp if c[0] in set(need_p))
    vb = _varwidth_names(wb) if shuffle == "ragged" else ()
    vp = _varwidth_names(wp) if shuffle == "ragged" else ()
    side_b = SidePlan(
        rows_global=b_global, rows_local=b_local, columns=wb, varwidth=vb,
        row_bytes=_row_bytes(wb),
        row_bytes_fixed=_row_bytes([c for c in wb if c[0] not in vb]))
    side_p = SidePlan(
        rows_global=p_global, rows_local=p_local, columns=wp, varwidth=vp,
        row_bytes=_row_bytes(wp),
        row_bytes_fixed=_row_bytes([c for c in wp if c[0] not in vp]))

    # the step's own capacity arithmetic; the segmented path one level
    # down, each per-bucket key carrying the effective block
    seg = 1
    if sort_mode == "segmented" and nb > 1:
        from distributed_join_tpu_torch.ops import segmented as seg_ops

        seg = seg_ops.resolve_sort_segments(
            sort_segments, max(b_local, p_local), n, k, shuffle_f)
    if seg > 1:
        b_cap_seg = seg_ops.segment_capacity(b_local, n, k, seg, shuffle_f)
        p_cap_seg = seg_ops.segment_capacity(p_local, n, k, seg, shuffle_f)
        out_cap_seg = seg_ops.segmented_out_capacity(p_local, k, seg, out_f,
                                                     out_rows)
        b_cap, p_cap, out_cap = (seg * b_cap_seg, seg * p_cap_seg,
                                 seg * out_cap_seg)
    else:
        b_cap, p_cap, out_cap = _step_capacities(
            b_local, p_local, n, k, shuffle_f, out_f, out_rows)
    capacities = {
        "shuffle_build_per_bucket": b_cap,
        "shuffle_probe_per_bucket": p_cap,
        "out_rows_per_batch": out_cap,
        "shuffle_capacity_factor": shuffle_f,
        "out_capacity_factor": out_f,
        "out_rows_per_rank": out_rows,
    }
    if seg > 1:
        capacities.update(
            sort_segments=seg,
            shuffle_build_per_segment=b_cap_seg,
            shuffle_probe_per_segment=p_cap_seg,
            out_rows_per_segment=out_cap_seg)

    skew = None
    if resolved.get("skew_threshold") is not None:
        hh_slots = int(resolved.get("hh_slots") or DEFAULT_HH_SLOTS)
        hh_build, hh_probe, hh_out = skew_capacities(
            p_local, hh_slots, resolved.get("hh_build_capacity"),
            resolved.get("hh_probe_capacity"),
            resolved.get("hh_out_capacity"))
        capacities.update(hh_build=hh_build,
                          hh_probe=_round_up(hh_probe, 8), hh_out=hh_out)
        skew = {"threshold": resolved["skew_threshold"],
                "hh_slots": hh_slots}

    wire = _predict_wire(n, k, shuffle, comp_bits, side_b, side_p,
                         b_cap, p_cap, n_slices=n_slices,
                         dcn_codec_on=dcn_on)

    agg_record = None
    if agg_spec is not None:
        agg_record, n_partial = _agg_record(
            agg_ops, agg_spec, agg_mode, keys_eff, bsch, psch, out_cap,
            capacities)
        if agg_mode in ("probe", "build") and n > 1:
            # the partials exchange: one padded collective of the whole
            # groups block a destination (both tiers, raw, when
            # hierarchical)
            block = n * agg_record["groups_per_rank"] \
                * agg_record["partial_row_bytes"]
            hier = shuffle == "hierarchical" and n_slices > 1
            per_rank = 2 * block if hier else block
            wire["partials"] = {
                "bytes_per_rank": int(per_rank),
                "bytes_total": int(per_rank) * n,
                "rows_estimate": agg_record["groups_per_rank"],
            }
            if hier:
                wire["partials"]["ici_bytes_per_rank"] = int(block)
                wire["partials"]["dcn_bytes_per_rank"] = int(block)
                wire["collectives_per_step"] += 2 * (1 + n_partial)
            else:
                wire["collectives_per_step"] += 1 + n_partial

    model = cost_model or CostModel()
    memory = _predict_memory(
        n, k, side_b, side_p, b_cap, p_cap,
        out_cap if agg_spec is None else capacities["groups_per_rank"],
        capacities, model,
        out_row_bytes=None if agg_record is None
        else agg_record["partial_row_bytes"])

    plan = JoinPlan(
        digest=sig.digest(),
        n_ranks=n,
        over_decomposition=k,
        key=tuple(keys_eff),
        shuffle=shuffle,
        compression_bits=comp_bits,
        with_metrics=bool(with_metrics),
        with_integrity=bool(resolved.get("with_integrity")),
        build=side_b,
        probe=side_p,
        capacities=capacities,
        skew=skew,
        wire=wire,
        memory=memory,
        resolved_options=_jsonable(resolved),
        cost={},
        n_slices=n_slices,
        pipeline="join" if agg_spec is None else "join_agg",
        aggregate=agg_record,
    )
    object.__setattr__(plan, "cost", predict(plan, model))
    return plan


def _predict_memory(n, k, side_b, side_p, b_cap, p_cap, out_cap,
                    capacities, model: CostModel,
                    out_row_bytes: Optional[int] = None) -> dict:
    """A rank's device footprint of the arrays the step holds: the local
    shards, one batch's shuffle send and receive blocks a side, and the
    k output blocks (a roofline bound: sort working copies are not
    counted)."""
    input_b = (side_b.rows_local * side_b.row_bytes
               + side_p.rows_local * side_p.row_bytes)
    shuffle_b = 2 * n * (b_cap * side_b.row_bytes + p_cap * side_p.row_bytes)
    if out_row_bytes is None:
        out_row_bytes = side_b.row_bytes + side_p.row_bytes
    output_b = k * out_cap * out_row_bytes
    hh_b = 0
    if "hh_build" in capacities:
        hh_b = (capacities["hh_build"] * side_b.row_bytes
                + capacities["hh_probe"] * side_p.row_bytes
                + capacities["hh_out"] * out_row_bytes)
    total = input_b + shuffle_b + output_b + hh_b
    return {
        "per_rank_bytes": {
            "input": int(input_b),
            "shuffle_blocks": int(shuffle_b),
            "output_blocks": int(output_b),
            "skew_blocks": int(hh_b),
        },
        "total_per_rank_bytes": int(total),
        "hbm_capacity_bytes": int(model.hbm_capacity_bytes),
        "fits_hbm": bool(total < model.hbm_capacity_bytes),
    }


# -- dry-run surfaces ----------------------------------------------------------


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def abstract_table(schema: dict, rows: int):
    """A Table of ``meta`` tensors of ``schema`` ({name: (dtype, trailing
    shape)}) and ``rows`` rows: shapes only, no memory."""
    from distributed_join_tpu_torch.table import Table

    cols = {name: torch.empty((rows,) + tuple(shape),
                              dtype=_torch_dtype(dtype), device="meta")
            for name, (dtype, shape) in schema.items()}
    return Table(cols, torch.empty((rows,), dtype=torch.bool, device="meta"))


def abstract_tables(build_rows: int, probe_rows: int,
                    key_dtype: str = "int64",
                    payload_dtype: str = "int64"):
    """Abstract build and probe Tables of the generator drivers' schema
    (``key`` and ``build_payload``/``probe_payload``): the service
    ``explain`` op's dry-run inputs."""
    return (abstract_table({"key": (key_dtype, ()),
                            "build_payload": (payload_dtype, ())},
                           build_rows),
            abstract_table({"key": (key_dtype, ()),
                            "probe_payload": (payload_dtype, ())},
                           probe_rows))


def _abstract_padded(table, n: int):
    """``table`` padded to a multiple of ``n`` rows, as ``meta`` tensors
    (a dry run never copies a real table)."""
    return abstract_table(column_schema(table), _round_up(table.capacity, n))


def explain_join(build, probe, comm, key="key",
                 verify_integrity: bool = False,
                 cost_model: Optional[CostModel] = None,
                 **opts) -> JoinPlan:
    """``distributed_inner_join``'s resolution, run dry: the padding, the
    capacity defaults, the skew capacities and the ladder's first rung,
    and the plan of that program, executing nothing. The library
    explain surface; ``distributed_inner_join(explain=True)`` attaches
    the plan of the final rung to its result."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        resolve_join_ladder,
    )

    n = comm.n_ranks
    build, probe = _abstract_padded(build, n), _abstract_padded(probe, n)
    opts = dict(opts)
    ladder = resolve_join_ladder(build, probe, n, opts,
                                 n_slices=comm.n_slices)
    return build_plan(comm, build, probe, key=key,
                      with_integrity=verify_integrity,
                      metrics_static={"retry_attempt_max": 0},
                      cost_model=cost_model, **ladder.sizing(), **opts)


def build_probe_plan(comm, resident, probe, key="key",
                     digest: Optional[str] = None, with_metrics=None,
                     cost_model: Optional[CostModel] = None,
                     **opts) -> JoinPlan:
    """The probe-only plan (resident build tables,
    ``service/resident.py``): the program ``make_probe_join_step`` builds
    against a registered build image. Wire bytes and partition work are
    the probe side's; each batch merges against the whole resident
    shard. ``resident`` has the image's schema and global rows.
    ``digest`` is the cached program's ``ResidentSignature`` digest; a
    plan-local hash stands in without one (dry runs without a
    registry)."""
    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_OUT_CAPACITY_FACTOR,
        DEFAULT_SHUFFLE_CAPACITY_FACTOR,
        PROBE_SHUFFLE_MODES,
        resolve_probe_capacities,
    )

    if with_metrics is None:
        with_metrics = telemetry.enabled()
    keys = [key] if isinstance(key, str) else list(key)
    n = comm.n_ranks
    k = int(opts.get("over_decomposition") or 1)
    nb = n * k
    shuffle = opts.get("shuffle") or "padded"
    comp_bits = opts.get("compression_bits")
    if k < 1:
        raise ValueError("over_decomposition must be >= 1")
    if shuffle not in PROBE_SHUFFLE_MODES:
        raise ValueError(f"unknown shuffle mode {shuffle!r}")
    shuffle_f = float(opts.get("shuffle_capacity_factor")
                      or DEFAULT_SHUFFLE_CAPACITY_FACTOR)
    out_f = float(opts.get("out_capacity_factor")
                  or DEFAULT_OUT_CAPACITY_FACTOR)
    out_rows = opts.get("out_rows_per_rank")

    r_global, p_global = resident.capacity, probe.capacity
    r_local, p_local = r_global // n, p_global // n

    rcols = _sorted_cols(column_schema(resident))
    pcols = _sorted_cols(column_schema(probe))
    # the whole image stays resident whatever an aggregate reads
    r_row_bytes_full = _row_bytes(rcols)
    agg_spec = opts.get("aggregate")
    agg_mode = None
    if agg_spec is not None:
        from distributed_join_tpu_torch.ops import aggregate as agg_ops

        rsch = {name: (dtype, 1 + len(tr)) for name, dtype, tr in rcols}
        psch = {name: (dtype, 1 + len(tr)) for name, dtype, tr in pcols}
        agg_mode = agg_ops.resolve_agg_mode(agg_spec, keys, rsch, psch)
        if agg_mode == "build":
            raise agg_ops.AggregatePushdownUnsupported(
                "group keys live on the RESIDENT (build) side; the "
                "probe-only program keeps the build shards pinned and "
                "only exchanges probe rows, so build-keyed group-bys "
                "ride make_join_step(aggregate=) instead")
        need_b, need_p = agg_ops.wire_columns(agg_spec, agg_mode, keys,
                                              rsch, psch)
        rcols = tuple(c for c in rcols if c[0] in set(need_b))
        pcols = tuple(c for c in pcols if c[0] in set(need_p))
    side_b = SidePlan(rows_global=r_global, rows_local=r_local,
                      columns=rcols, varwidth=(), row_bytes=_row_bytes(rcols),
                      row_bytes_fixed=_row_bytes(rcols))
    side_p = SidePlan(rows_global=p_global, rows_local=p_local,
                      columns=pcols, varwidth=(), row_bytes=_row_bytes(pcols),
                      row_bytes_fixed=_row_bytes(pcols))

    p_cap, out_cap = resolve_probe_capacities(p_local, n, k, shuffle_f,
                                              out_f, out_rows)
    capacities = {
        "shuffle_build_per_bucket": 0,
        "shuffle_probe_per_bucket": p_cap,
        "out_rows_per_batch": out_cap,
        "shuffle_capacity_factor": shuffle_f,
        "out_capacity_factor": out_f,
        "out_rows_per_rank": out_rows,
        "resident_rows_per_rank": r_local,
    }

    if nb == 1:
        probe_wire = {"bytes_per_rank": 0, "bytes_total": 0,
                      "rows_estimate": 0}
        coll, exact = 0, True
    elif shuffle == "ragged":
        per_rank = p_local * side_p.row_bytes
        probe_wire = {"bytes_per_rank": int(per_rank),
                      "bytes_total": int(per_rank) * n,
                      "rows_estimate": p_local * n}
        coll, exact = k * (1 + len(pcols)), False
    else:
        per_rank, raw = _padded_side_bytes(n, k, p_cap, pcols, comp_bits)
        probe_wire = {"bytes_per_rank": int(per_rank),
                      "bytes_total": int(per_rank) * n,
                      "rows_estimate": p_local * n}
        if comp_bits is not None:
            probe_wire["raw_bytes_per_rank"] = int(raw)
        coll = k * (1 + (2 if comp_bits is not None else 1) * len(pcols))
        exact = True
    wire = {
        "exact": exact,
        "build": {"bytes_per_rank": 0, "bytes_total": 0,
                  "rows_estimate": 0, "resident": True},
        "probe": probe_wire,
        "collectives_per_step": coll,
    }

    agg_record = None
    if agg_spec is not None:
        agg_record, n_partial = _agg_record(
            agg_ops, agg_spec, agg_mode, keys, rsch, psch, out_cap,
            capacities)
        if agg_mode == "probe" and n > 1:
            block = n * agg_record["groups_per_rank"] \
                * agg_record["partial_row_bytes"]
            wire["partials"] = {
                "bytes_per_rank": int(block),
                "bytes_total": int(block) * n,
                "rows_estimate": agg_record["groups_per_rank"],
            }
            wire["collectives_per_step"] += 1 + n_partial

    model = cost_model or CostModel()
    if agg_record is None:
        out_blocks = k * out_cap * (side_b.row_bytes + side_p.row_bytes)
    else:
        out_blocks = (k * agg_record["groups_per_rank"]
                      * agg_record["partial_row_bytes"])
    input_b = r_local * r_row_bytes_full + p_local * side_p.row_bytes
    shuffle_b = 2 * n * p_cap * side_p.row_bytes
    mem_total = input_b + shuffle_b + out_blocks
    memory = {
        "per_rank_bytes": {
            "input": int(input_b),
            "shuffle_blocks": int(shuffle_b),
            "output_blocks": int(out_blocks),
            "skew_blocks": 0,
        },
        "total_per_rank_bytes": int(mem_total),
        "hbm_capacity_bytes": int(model.hbm_capacity_bytes),
        "fits_hbm": bool(mem_total < model.hbm_capacity_bytes),
    }

    if digest is None:
        digest = hashlib.sha256(json.dumps(
            {"probe_only": True, "n_ranks": n, "key": keys,
             "resident": [list(c) for c in rcols],
             "probe": [list(c) for c in pcols],
             "capacities": capacities, "shuffle": shuffle,
             "aggregate": agg_record},
            sort_keys=True, default=str).encode()).hexdigest()

    plan = JoinPlan(
        digest=digest,
        n_ranks=n,
        over_decomposition=k,
        key=tuple(keys),
        shuffle=shuffle,
        compression_bits=comp_bits,
        with_metrics=bool(with_metrics),
        with_integrity=False,
        build=side_b,
        probe=side_p,
        capacities=capacities,
        skew=None,
        wire=wire,
        memory=memory,
        resolved_options=_jsonable(dict(opts)),
        cost={},
        pipeline="probe_join" if agg_spec is None else "probe_join_agg",
        probe_only=True,
        aggregate=agg_record,
    )
    object.__setattr__(plan, "cost", predict(plan, model))
    return plan


def build_exchange_plan(n_ranks: int, buffer_bytes_per_rank: int,
                        cost_model: Optional[CostModel] = None) -> dict:
    """The all-to-all benchmark's explain record: one fixed-size
    exchange, no join pipeline."""
    body = {
        "pipeline": "all_to_all",
        "n_ranks": int(n_ranks),
        "buffer_bytes_per_rank": int(buffer_bytes_per_rank),
        "wire": {
            "exact": True,
            "bytes_per_rank": int(buffer_bytes_per_rank),
            "bytes_total": int(buffer_bytes_per_rank) * int(n_ranks),
            "offchip_bytes_per_rank": int(
                buffer_bytes_per_rank * (n_ranks - 1) // n_ranks),
        },
    }
    body["signature_digest"] = hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()
    return {
        "schema_version": EXPLAIN_SCHEMA_VERSION,
        "kind": "explain",
        "plan": body,
        "cost": predict_exchange(n_ranks, buffer_bytes_per_rank, cost_model),
    }
