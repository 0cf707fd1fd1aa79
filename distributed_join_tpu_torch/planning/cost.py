"""The roofline cost model of the port: per-stage wall seconds of one
join step, priced from per-primitive constants measured on an H100.

Port of ``distributed_join_tpu/planning/cost.py``: ``CostModel`` and its
``provenance``, ``predict``, ``predict_exchange``, ``resolve_dcn_codec``,
``resolve_dcn_bits``, ``calibrate_from_history``, ``STAGE_CONSTANTS``,
``calibrate_from_stage_profile``, ``DEFAULT_PREDICTION_BAND`` and
``CODEC_BREAK_EVEN_BYTES_PER_S``, with the JAX package's names and record
keys, so an explain record, a history entry and a calibration read the
same fields. The arithmetic is the reference's; the constants are the
card's own. Each measured default names its measurement:
``python3 chip_smoke.py --phase 21`` times each primitive on the port's
own code at the headline's shape (10 M x 10 M rows, 20 M merged
positions) and prints the fitted constants beside the card's name and
power limit. The one bandwidth with no link to measure (the tier across
nodes) is spec-derived and ``provenance`` says so.

Predictions model an H100's roofline, not the backend the process runs
on: on the CPU the predicted wall is deliberately wrong, while the
predicted wire bytes are exact on the padded, ppermute, compressed and
hierarchical wires (the device metrics tape measures them).

Everything here is host arithmetic: no torch import, no device touch,
the same output to the byte for the same plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

COST_MODEL_VERSION = 1

# Prediction band for grading: a measured wall within [predicted / BAND,
# predicted * BAND] is inside the model (the reference's band).
DEFAULT_PREDICTION_BAND = 4.0

# What ``predict``'s record names as the roofline it prices.
ROOFLINE_PLATFORM = "h100-sxm-roofline"


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-primitive costs on an NVIDIA H100 80GB HBM3 (ns/element
    unless noted). Every measured default comes from ``chip_smoke.py``
    phase 21(a), its ``[cost] (a) fitted constants`` line, on an H100
    80GB HBM3 at a 700.00 W power limit, timed with CUDA events at the
    headline's shape (10 M x 10 M rows, 20 M merged positions); each
    comment names what the phase timed for the field. The fields of
    :data:`STAGE_REFITTED` are those times rescaled by
    ``calibrate_from_stage_profile`` over phase 22's stage profiles
    (the partition stage's ratio for the fields it owns, the join
    stage's for its own), each comment giving the time and the scale.
    Replace any field and re-run ``predict``: the explain record embeds
    the constants used.

    The two bandwidths stand for the H100's links: ``ici_bytes_per_s``
    is a card's NCCL all-to-all egress inside one node (NVLink), and
    ``dcn_bytes_per_s`` a card's egress to the tier across nodes (the
    hierarchical wire's cross-slice hop).
    """

    # the join's stable merged sort (ops/join._merged_sort: int64 key and
    # int8 tag as keys, the int64 payload lane as values), 20 M positions:
    # 0.2682 by phase 21(a), refitted x0.876629 from stage profiles (the
    # partition stage's measured/predicted of phase 22(a)'s k = 4
    # profile, chip_smoke.py phase 22(c)'s refit line, on an H100 80GB
    # HBM3 at 700.00 W; PERF.md, the stage-profile refit)
    sort_ns_per_elem: float = 0.2351
    # the segmented path's batched sort (ops/segmented._lexsort_rows on
    # (319, 62512) runs, the value lane gathered)
    sort_run_ns_per_elem: float = 0.2951
    # one more int64 value lane on the merged sort, a merged position:
    # 0.03823 by phase 21(a), refitted x1.426223 from stage profiles (the
    # median join-stage measured/predicted of phase 22(a)'s profiles and
    # 22(b)'s Q3 operators, phase 22(c)'s refit line, H100 80GB HBM3,
    # 700.00 W; as the three join fields below)
    sort_lane_ns_per_elem: float = 0.05452
    # join_scans (csrc/join_scans.cu), 20 M positions: 0.01491 by phase
    # 21(a), refitted x1.426223 (phase 22(c), the join stage)
    scan_ns_per_elem: float = 0.02126
    # a random int64 gather, 20 M elements: 0.03306 by phase 21(a),
    # refitted x0.876629 (phase 22(c), the partition stage)
    gather_ns_per_elem: float = 0.02898
    # ops/join._row_gather of 16-byte rows, 20 M rows: 0.06511 by phase
    # 21(a), refitted x0.876629 (phase 22(c), the partition stage)
    row_gather_ns_per_row: float = 0.05708
    # stream_compact (csrc/stream_compact.cu) at the run-record site, a
    # merged position: 0.009378 by phase 21(a), refitted x1.426223
    # (phase 22(c), the join stage)
    compact_ns_per_elem: float = 0.01338
    # expand_gather in build mode (csrc/expand_gather.cu), an output
    # slot: 0.01754 by phase 21(a), refitted x1.426223 (phase 22(c), the
    # join stage)
    expand_ns_per_out_row: float = 0.02502
    # a device copy of 2 GiB: bytes read and written over its time
    hbm_bytes_per_s: float = 3.0377e12
    # ops/compression.py's encode and decode at 16 bits of a k = 4
    # batch's int64 key block: twice its raw bytes over their time
    codec_bytes_per_s: float = 2.5227e11
    # a card's NCCL all_to_all egress inside one node: 748.55 GB/s
    # aggregate off-chip over four cards / 4 (benchmarks/all_to_all.py at
    # 256 MiB a rank over four H100 80GB HBM3 at 700.00 W, one node)
    ici_bytes_per_s: float = 1.8714e11
    # SPEC-DERIVED: a card's egress across nodes, one 400 Gb/s NDR
    # InfiniBand port a GPU (a DGX H100 node's eight ConnectX-7 ports):
    # 50 GB/s. No machine of several nodes is measured.
    dcn_bytes_per_s: float = 5.0e10
    # one NCCL all_to_all_single of 8 KiB over a world of 1
    collective_latency_s: float = 4.771e-05
    # torch.cuda.get_device_properties(0).total_memory
    hbm_capacity_bytes: int = 85_017_493_504
    # Set by calibrate_from_history: the global measured/predicted wall
    # scale this model was refit with (None = as shipped).
    calibrated_scale: Optional[float] = None
    # Set by calibrate_from_stage_profile: ((stage, scale), ...) of the
    # per-stage ratios the stage-owned constants were refit with.
    calibrated_stage_scales: Optional[tuple] = None

    @property
    def provenance(self) -> dict:
        return {
            "measured": [
                "sort_ns_per_elem", "sort_run_ns_per_elem",
                "sort_lane_ns_per_elem",
                "scan_ns_per_elem", "gather_ns_per_elem",
                "row_gather_ns_per_row", "compact_ns_per_elem",
                "expand_ns_per_out_row", "hbm_bytes_per_s",
                "codec_bytes_per_s", "ici_bytes_per_s",
                "collective_latency_s", "hbm_capacity_bytes",
            ],
            "spec_derived": ["dcn_bytes_per_s"],
            # measured fields whose defaults are phase 21's times scaled
            # by a stage's measured/predicted ratio
            "stage_refitted": list(STAGE_REFITTED),
            "source": "chip_smoke.py phase 21 (H100 80GB HBM3, 700.00 W); "
                      "the stage_refitted fields rescaled from stage "
                      "profiles by chip_smoke.py phase 22(c) (the same "
                      "card); benchmarks/all_to_all.py on four cards; "
                      "dcn: 400 Gb/s NDR InfiniBand a GPU"
                      + ("" if self.calibrated_scale is None else
                         f"; calibrated x{self.calibrated_scale:g} "
                         "from measured history")
                      + ("" if self.calibrated_stage_scales is None
                         else "; stage-calibrated "
                         + " ".join(f"{s}=x{v:g}" for s, v in
                                    self.calibrated_stage_scales)
                         + " from a stage profile"),
        }

    def as_record(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["model_version"] = COST_MODEL_VERSION
        rec["provenance"] = self.provenance
        return rec


# The defaults refitted from stage profiles (chip_smoke.py phase 22(c):
# each moved more than 10 % from phase 21(a)'s time).
STAGE_REFITTED = (
    "sort_ns_per_elem", "gather_ns_per_elem", "row_gather_ns_per_row",
    "sort_lane_ns_per_elem", "scan_ns_per_elem", "compact_ns_per_elem",
    "expand_ns_per_out_row",
)

DEFAULT_COST_MODEL = CostModel()

# The FoR + bit-pack codec's break-even wire rate on the H100: below it,
# encode + decode cost less than the bytes they remove. chip_smoke.py
# phase 14 measures 41-95 GB/s over the headline's k = 4 blocks (H100
# 80GB HBM3, 700.00 W; PERF.md section 5); the upper edge, as the
# reference takes its own. NVLink (~187 GB/s a card) sits above it, so
# the codec loses inside a node; the tier across nodes (50 GB/s) below.
CODEC_BREAK_EVEN_BYTES_PER_S = 9.5e10

DCN_CODEC_KNOBS = ("off", "auto", "on")

# The hierarchical codec's residual width when the caller set the codec
# on but no compression_bits (parallel/distributed_join re-exports it).
DEFAULT_DCN_CODEC_BITS = 16


def resolve_dcn_codec(knob: str,
                      model: Optional[CostModel] = None) -> bool:
    """The hierarchical shuffle's ``dcn_codec`` knob as on or off:
    ``auto`` turns the codec on exactly when the cross-slice bandwidth
    sits below the codec's break-even. Every value is validated."""
    if knob not in DCN_CODEC_KNOBS:
        raise ValueError(
            f"unknown dcn_codec {knob!r}; pick one of {DCN_CODEC_KNOBS}")
    if knob == "auto":
        m = model or DEFAULT_COST_MODEL
        return m.dcn_bytes_per_s < CODEC_BREAK_EVEN_BYTES_PER_S
    return knob == "on"


def resolve_dcn_bits(knob: str, compression_bits: Optional[int] = None,
                     *, n_slices: int,
                     model: Optional[CostModel] = None) -> Optional[int]:
    """The one resolution of the cross-slice residual width, shared by
    the capacity ladder, the drivers and the plans: the caller's bits
    (default ``DEFAULT_DCN_CODEC_BITS``) exactly when the codec resolves
    on and the mesh has a cross-slice tier; else None (one slice routes
    the flat padded wire, which has no codec). The knob is validated on
    every topology."""
    on = resolve_dcn_codec(knob, model)
    if n_slices <= 1 or not on:
        return None
    return compression_bits or DEFAULT_DCN_CODEC_BITS


def _round_s(x: float) -> float:
    """Deterministic second rounding for the record (9 digits)."""
    return round(float(x), 9)


def predict(plan, model: Optional[CostModel] = None) -> dict:
    """Per-stage predicted wall seconds (per rank: the pipeline is
    symmetric) of one join step and the derived throughput. ``plan`` is
    a :class:`~.plan.JoinPlan`. The stages mirror the step: partition
    (one bucket sort a side and the padded layout's row gathers),
    shuffle (wire bytes over the link, a latency a collective, the codec
    where it runs), join a batch (merged sort, scans and compaction over
    the merged domain, the expand over the output block) and the skew
    sidecar."""
    m = model or DEFAULT_COST_MODEL
    n = plan.n_ranks
    k = plan.over_decomposition
    ns = 1e-9
    # Probe-only plans (resident build tables): no build partition or
    # wire; each batch merges against the whole resident shard.
    probe_only = bool(getattr(plan, "probe_only", False))
    # The fused join+aggregate runs no expand; probe and build modes
    # add the partials exchange (plan.wire["partials"]).
    fused_agg = getattr(plan, "pipeline", "join") in (
        "join_agg", "probe_join_agg")
    wire_sides = ("build", "probe", "partials") if fused_agg \
        else ("build", "probe")

    b_local = plan.build.rows_local
    p_local = plan.probe.rows_local
    b_cols = max(len(plan.build.columns), 1)
    p_cols = max(len(plan.probe.columns), 1)

    single = plan.n_buckets == 1
    b_shipped = 0 if single else \
        k * n * plan.capacities["shuffle_build_per_bucket"]
    p_shipped = 0 if single else \
        k * n * plan.capacities["shuffle_probe_per_bucket"]

    if single:
        partition_s = 0.0
    elif probe_only:
        partition_s = ns * (
            p_local * m.sort_ns_per_elem
            + p_shipped * m.row_gather_ns_per_row * _col_groups(p_cols))
    else:
        partition_s = ns * (
            (b_local + p_local) * m.sort_ns_per_elem
            + b_shipped * m.row_gather_ns_per_row * _col_groups(b_cols)
            + p_shipped * m.row_gather_ns_per_row * _col_groups(p_cols))

    shuffle_tiers = None
    if single:
        shuffle_s = 0.0
    elif (plan.shuffle == "hierarchical"
          and getattr(plan, "n_slices", 1) > 1):
        # two tiers in sequence, each at its link's rate
        s_ = getattr(plan, "n_slices", 1)
        c_ = max(n // s_, 1)
        ici_rank = sum((plan.wire.get(side) or {})
                       .get("ici_bytes_per_rank", 0)
                       for side in wire_sides)
        dcn_rank = sum((plan.wire.get(side) or {})
                       .get("dcn_bytes_per_rank", 0)
                       for side in wire_sides)
        ici_s = (ici_rank * (c_ - 1) / c_) / m.ici_bytes_per_s
        dcn_s = (dcn_rank * (s_ - 1) / s_) / m.dcn_bytes_per_s
        codec_s = 0.0
        raw = sum((plan.wire.get(side) or {})
                  .get("dcn_raw_bytes_per_rank", 0)
                  for side in wire_sides)
        if raw:
            codec_s = 2.0 * raw / m.codec_bytes_per_s
        shuffle_s = (ici_s + dcn_s + codec_s
                     + plan.wire["collectives_per_step"]
                     * m.collective_latency_s)
        shuffle_tiers = {"ici_s": _round_s(ici_s),
                         "dcn_s": _round_s(dcn_s),
                         "codec_s": _round_s(codec_s)}
    else:
        wire_rank = sum((plan.wire.get(side) or {})
                        .get("bytes_per_rank", 0)
                        for side in wire_sides)
        offchip = wire_rank * (n - 1) / n
        shuffle_s = (offchip / m.ici_bytes_per_s
                     + plan.wire["collectives_per_step"]
                     * m.collective_latency_s)
        if plan.compression_bits is not None:
            raw = (plan.wire["build"].get("raw_bytes_per_rank", 0)
                   + plan.wire["probe"].get("raw_bytes_per_rank", 0))
            shuffle_s += 2.0 * raw / m.codec_bytes_per_s

    if single:
        merged = b_local + p_local
        out_total = plan.capacities["out_rows_per_batch"]
        batches = 1
    elif probe_only:
        merged = (plan.capacities.get("resident_rows_per_rank", b_local)
                  + n * plan.capacities["shuffle_probe_per_bucket"])
        out_total = plan.capacities["out_rows_per_batch"]
        batches = k
    else:
        merged = (n * plan.capacities["shuffle_build_per_bucket"]
                  + n * plan.capacities["shuffle_probe_per_bucket"])
        out_total = plan.capacities["out_rows_per_batch"]
        batches = k
    if fused_agg:
        out_total = 0
    sort_c = (m.sort_run_ns_per_elem
              if (plan.capacities.get("sort_segments") or 1) > 1
              else m.sort_ns_per_elem)
    join_s = batches * ns * (
        merged * (sort_c
                  + m.sort_lane_ns_per_elem * 2
                  + m.scan_ns_per_elem
                  + m.compact_ns_per_elem)
        + out_total * m.expand_ns_per_out_row)

    skew_s = 0.0
    if plan.skew is not None:
        hh_rows = (plan.capacities.get("hh_build") or 0) * n \
            + (plan.capacities.get("hh_probe") or 0)
        skew_s = ns * (
            (b_local + p_local) * m.scan_ns_per_elem
            + hh_rows * m.sort_ns_per_elem
            + (plan.capacities.get("hh_out") or 0)
            * m.expand_ns_per_out_row)

    total = partition_s + shuffle_s + join_s + skew_s
    rows = plan.build.rows_global + plan.probe.rows_global
    out = {
        "model": m.as_record(),
        "platform": ROOFLINE_PLATFORM,
        "stages": {
            "partition": _round_s(partition_s),
            "shuffle": _round_s(shuffle_s),
            "join": _round_s(join_s),
            "skew": _round_s(skew_s),
        },
        "total_s": _round_s(total),
        "predicted_rows_per_sec": _round_s(rows / total) if total else None,
        "predicted_m_rows_per_sec_per_rank": (
            _round_s(rows / total / 1e6 / n) if total else None),
    }
    if shuffle_tiers is not None:
        # a sibling of "stages" (the stage set is STAGE_CONSTANTS')
        out["shuffle_tiers"] = shuffle_tiers
    return out


def _col_groups(n_cols: int) -> float:
    """A packed row gather is priced one gather a group of 4 columns."""
    return max((n_cols + 3) // 4, 1)


# The constants a calibration scale applies to: time-per-element
# constants scale with the measured/predicted ratio, bandwidths against.
_TIME_CONSTANTS = (
    "sort_ns_per_elem", "sort_lane_ns_per_elem", "scan_ns_per_elem",
    "gather_ns_per_elem", "row_gather_ns_per_row",
    "compact_ns_per_elem", "expand_ns_per_out_row",
    "collective_latency_s",
)
_BANDWIDTH_CONSTANTS = ("hbm_bytes_per_s", "codec_bytes_per_s",
                        "ici_bytes_per_s", "dcn_bytes_per_s")


def calibrate_from_history(entries, model: Optional[CostModel] = None,
                           *, min_entries: int = 3,
                           platform: Optional[str] = "cuda"):
    """Refit the model from a workload-history store's measured/
    predicted wall ratios (``prediction.wall_ratio`` an entry): one
    multiplicative correction, the median ratio, applied uniformly.
    Only entries measured on ``platform`` count (default ``cuda``, the
    port's stamp: a CPU wall measures the host, not the card; ``None``
    counts every entry). Returns ``(model or None, report)``; fewer than
    ``min_entries`` eligible entries refuse with ``calibrated=False``."""
    base = model or DEFAULT_COST_MODEL
    ratios = []
    for e in entries or []:
        pred = e.get("prediction")
        if not isinstance(pred, dict) or not pred.get("wall_ratio"):
            continue
        if e.get("outcome") not in ("ok", "served", "recovered"):
            continue
        if platform is not None and e.get("platform") != platform:
            continue
        ratios.append(float(pred["wall_ratio"]))
    report = {
        "platform": platform,
        "n_eligible": len(ratios),
        "min_entries": min_entries,
        "base_calibrated_scale": base.calibrated_scale,
    }
    if len(ratios) < min_entries:
        report.update(
            calibrated=False,
            reason=(f"need >= {min_entries} measured "
                    f"{platform or 'any'}-platform entries with a "
                    f"wall ratio, have {len(ratios)}"))
        return None, report
    ratios.sort()
    scale = ratios[len(ratios) // 2]
    fields = {k: getattr(base, k) * scale for k in _TIME_CONSTANTS}
    fields.update({k: getattr(base, k) / scale
                   for k in _BANDWIDTH_CONSTANTS})
    calibrated = dataclasses.replace(
        base, calibrated_scale=round(scale, 6), **fields)
    report.update(
        calibrated=True,
        scale=round(scale, 6),
        ratio_min=round(ratios[0], 4),
        ratio_median=round(scale, 4),
        ratio_max=round(ratios[-1], 4),
    )
    return calibrated, report


# The constants each stage owns for the per-constant refit.
STAGE_CONSTANTS = {
    "partition": {
        "time": ("sort_ns_per_elem", "gather_ns_per_elem",
                 "row_gather_ns_per_row"),
        "bandwidth": (),
    },
    "shuffle": {
        "time": ("collective_latency_s",),
        "bandwidth": ("ici_bytes_per_s", "dcn_bytes_per_s",
                      "codec_bytes_per_s"),
    },
    "join": {
        "time": ("sort_run_ns_per_elem", "sort_lane_ns_per_elem",
                 "scan_ns_per_elem", "compact_ns_per_elem",
                 "expand_ns_per_out_row"),
        "bandwidth": (),
    },
}


def calibrate_from_stage_profile(profiles,
                                 model: Optional[CostModel] = None,
                                 *, min_profiles: int = 1,
                                 platform: Optional[str] = "cuda"):
    """Refit individual constants from stage-segmented profiles
    (``kind: "stageprofile"`` records): per stage the median measured/
    predicted ratio scales the constants the stage owns
    (:data:`STAGE_CONSTANTS`). A shuffle ratio of a profile that moved
    cross-slice bytes refits ``dcn_bytes_per_s`` alone; a segmented
    profile's join ratio refits ``sort_run_ns_per_elem`` alone.
    Overflowed profiles and other platforms' never count (``None``
    counts every platform). Returns ``(model or None, report)``."""
    base = model or DEFAULT_COST_MODEL
    if isinstance(profiles, dict):
        profiles = [profiles]
    ratios: dict = {}
    dcn_ratios: list = []
    sort_run_ratios: list = []
    eligible = 0
    for p in profiles or []:
        if not isinstance(p, dict) or p.get("kind") != "stageprofile":
            continue
        if p.get("overflow"):
            continue
        if platform is not None and p.get("platform") != platform:
            continue
        counted = False
        for stage, info in (p.get("stages") or {}).items():
            if stage not in STAGE_CONSTANTS:
                continue
            if not isinstance(info, dict) or not info.get("ran"):
                continue
            pred, wall = info.get("predicted_s"), info.get("wall_s")
            if pred and wall:
                r = float(wall) / float(pred)
                if stage == "shuffle" and any(
                        (info.get("counters") or {}).get(
                            f"{s}.wire_bytes_dcn")
                        for s in ("build", "probe")):
                    dcn_ratios.append(r)
                elif stage == "join" and (
                        p.get("sort_segments") or 1) > 1:
                    sort_run_ratios.append(r)
                else:
                    ratios.setdefault(stage, []).append(r)
                counted = True
        if counted:
            eligible += 1
    report = {
        "platform": platform,
        "n_eligible": eligible,
        "min_profiles": min_profiles,
    }
    if eligible < min_profiles:
        report.update(
            calibrated=False,
            reason=(f"need >= {min_profiles} non-overflowed "
                    f"{platform or 'any'}-platform stage profiles "
                    f"with per-stage ratios, have {eligible}"))
        return None, report
    fields: dict = {}
    scales: dict = {}
    refit: dict = {}
    for stage, rs in sorted(ratios.items()):
        rs.sort()
        scale = round(rs[len(rs) // 2], 6)
        scales[stage] = scale
        owned = STAGE_CONSTANTS[stage]
        fit_time = list(owned["time"])
        if stage == "join":
            fit_time.remove("sort_run_ns_per_elem")
        for k in fit_time:
            fields[k] = getattr(base, k) * scale
        fit_bw = list(owned["bandwidth"])
        if stage == "shuffle":
            fit_bw.remove("dcn_bytes_per_s")
        for k in fit_bw:
            fields[k] = getattr(base, k) / scale
        refit[stage] = fit_time + fit_bw
    sort_run_scale = None
    if sort_run_ratios:
        sort_run_ratios.sort()
        sort_run_scale = round(
            sort_run_ratios[len(sort_run_ratios) // 2], 6)
        fields["sort_run_ns_per_elem"] = \
            base.sort_run_ns_per_elem * sort_run_scale
        refit.setdefault("join", []).append("sort_run_ns_per_elem")
        scales.setdefault("join", sort_run_scale)
    dcn_scale = None
    if dcn_ratios:
        dcn_ratios.sort()
        dcn_scale = round(dcn_ratios[len(dcn_ratios) // 2], 6)
        fields["dcn_bytes_per_s"] = base.dcn_bytes_per_s / dcn_scale
        refit.setdefault("shuffle", []).append("dcn_bytes_per_s")
    calibrated = dataclasses.replace(
        base,
        calibrated_stage_scales=tuple(sorted(scales.items())),
        **fields)
    report.update(
        calibrated=True,
        stage_scales=scales,
        dcn_scale=dcn_scale,
        sort_run_scale=sort_run_scale,
        refit=refit,
        worst_stage=max(scales, key=lambda s: abs(math.log(scales[s]))),
        unfit_stages=[s for s in STAGE_CONSTANTS if s not in scales],
    )
    return calibrated, report


def predict_exchange(n_ranks: int, bytes_per_rank: int,
                     model: Optional[CostModel] = None) -> dict:
    """One fixed-size exchange (the all-to-all benchmark's
    ``--explain``)."""
    m = model or DEFAULT_COST_MODEL
    offchip = bytes_per_rank * (n_ranks - 1) / n_ranks
    total = offchip / m.ici_bytes_per_s + m.collective_latency_s
    return {
        "model": m.as_record(),
        "platform": ROOFLINE_PLATFORM,
        "stages": {"all_to_all": _round_s(total)},
        "total_s": _round_s(total),
        "predicted_aggregate_offchip_gb_per_sec": _round_s(
            n_ranks * offchip / total / 1e9),
    }
