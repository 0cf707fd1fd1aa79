"""Stage-segmented profiling: measured walls a stage, and the overlap
credit.

Port of ``distributed_join_tpu/telemetry/stageprof.py``: ``STAGE_KEYS``,
``StageProfile``, ``QueryStageProfile``, ``format_stage_record``,
``format_query_stage_record``, ``profile_join_stages`` and
``profile_query_stages``, with the JAX package's record keys, so its
``analyze stages`` and ``planning.cost.calibrate_from_stage_profile``
read the port's ``stageprofile.json`` as their own.

The cost model (``planning/cost.py``) predicts a wall a stage; a driver
measures only whole joins. :func:`profile_join_stages` runs the same
join twice:

1. **Segmented**: the step split at the boundaries the model prices,
   each segment its own ``comm.spmd`` callable with its own
   ``MetricsTape``:

   - ``partition``: the hash, the bucket sort and the padded (or, on the
     ragged wire, the bucket-sorted) layout's gathers, which the model
     bills here;
   - ``shuffle``: the plan's wire alone (padded, ppermute, compressed,
     hierarchical with the plan's codec, or ragged; the segmented
     sort's per-segment blocks), through the step's own dispatch
     (``parallel/distributed_join._padded_wire``);
   - ``join``: ``sort_merge_inner_join`` on the kernel path (the
     ``join_scans``, ``stream_compact`` and ``expand_gather`` kernels on
     a card), or the segmented sort's batched join.

   The segments' capacities come from the plan (``planning.build_plan``
   over ``resolve_join_ladder``'s sizing, the resolution every call
   uses), so they are the monolithic step's. One rank at k = 1 is one
   bucket: the step joins directly, and so does the profile (the join
   alone).
2. **Monolithic**: ``make_join_step`` with the tape off, the program the
   drivers time.

Both sides are timed alike: the host's ``time.perf_counter`` around each
call, ended by one ``fetch_one_scalar`` (``telemetry/spans.py``: the one
honest synchronisation, an element read to the host), N repeats, the
median and the minimum. ``sum(stage walls) - monolithic wall`` is the
overlap credit: what the monolithic run hides across the boundaries that
the segmented run pays one after the other. In eager torch nothing fuses
across a boundary, so the credit is mostly the segments' own host
launches and barriers, and on small tables it can be negative.

``platform`` is the device type the tables live on (``cuda`` or
``cpu``), the string ``calibrate_from_stage_profile(platform=...)`` and
the history store filter on. The shuffle's ICI block divides the
measured off-chip bytes by the model's ``ici_bytes_per_s``; at a world
of 1 no byte leaves the card, and the block says so.

Profiling is an untimed side pass after a driver's timed region
(``benchmarks.maybe_stage_profile``); with ``--stage-profile`` off
nothing here runs. Scope (refusals, never wrong numbers): the skew
sidecar, string (2-D) keys and the ragged wire's varwidth columns raise
a ValueError naming what is not segmentable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

STAGE_PROFILE_SCHEMA_VERSION = 1

# The stage keys: those of planning.cost.predict's ``stages`` (grading
# joins the two by key).
STAGE_KEYS = ("partition", "shuffle", "join", "skew")


def _round_s(x: float) -> float:
    return round(float(x), 9)


def _median(vals):
    s = sorted(vals)
    return s[len(s) // 2] if s else 0.0


@dataclasses.dataclass
class StageProfile:
    """One profiled join: walls and counters a stage, the monolithic
    walls, and the overlap credit. ``as_record()`` is the
    ``stageprofile.json`` artifact (``analyze check`` validates it);
    ``summary()`` the block a driver's record carries (the history
    store's ``stages``)."""

    plan_digest: str
    shuffle: str
    n_ranks: int
    over_decomposition: int
    repeats: int
    platform: str
    overflow: bool
    stages: dict                 # name -> stage dict (see _stage_entry)
    monolithic_walls_s: list
    cost: dict                   # the plan's cost prediction (model incl.)
    # the segmented sort's segment count the programs ran with (1 = flat)
    sort_segments: int = 1

    @property
    def monolithic_wall_s(self) -> float:
        return _median(self.monolithic_walls_s)

    @property
    def sum_of_stages_s(self) -> float:
        return sum(s["wall_s"] for s in self.stages.values())

    @property
    def sum_of_stages_min_s(self) -> float:
        """The sum of each stage's least wall. Noise only inflates a
        wall, so the minima bound the work from below: the consistency
        check (the segments do at least the fused program's work, so
        their sum is not below the monolithic wall) compares minima,
        the reported credit medians."""
        return sum(s["wall_min_s"] for s in self.stages.values())

    @property
    def monolithic_wall_min_s(self) -> float:
        return min(self.monolithic_walls_s) \
            if self.monolithic_walls_s else 0.0

    @property
    def overlap(self) -> dict:
        total = self.sum_of_stages_s
        credit = total - self.monolithic_wall_s
        return {
            "credit_s": _round_s(credit),
            "fraction": (_round_s(credit / total) if total > 0
                         else None),
            "note": ("sum-of-segments minus monolithic wall: work the "
                     "monolithic step overlaps across stage boundaries "
                     "that the segmented run pays serially"),
        }

    def as_record(self) -> dict:
        return {
            "schema_version": STAGE_PROFILE_SCHEMA_VERSION,
            "kind": "stageprofile",
            "pipeline": "join",
            "plan_digest": self.plan_digest,
            "shuffle": self.shuffle,
            "n_ranks": self.n_ranks,
            "over_decomposition": self.over_decomposition,
            "repeats": self.repeats,
            "platform": self.platform,
            "overflow": self.overflow,
            "sort_segments": self.sort_segments,
            "stages": {k: dict(v) for k, v in self.stages.items()},
            "sum_of_stages_s": _round_s(self.sum_of_stages_s),
            "sum_of_stages_min_s": _round_s(self.sum_of_stages_min_s),
            "monolithic": {
                "wall_s": _round_s(self.monolithic_wall_s),
                "wall_min_s": _round_s(self.monolithic_wall_min_s),
                "walls_s": [_round_s(w)
                            for w in self.monolithic_walls_s],
            },
            "overlap": self.overlap,
            "cost_model": self.cost.get("model"),
            "predicted_total_s": self.cost.get("total_s"),
        }

    def summary(self) -> dict:
        """The compact block of a record (history's ``stages`` seam)."""
        return {
            "plan_digest": self.plan_digest,
            "shuffle": self.shuffle,
            "repeats": self.repeats,
            "platform": self.platform,
            "overflow": self.overflow,
            "wall_s": {k: v["wall_s"] for k, v in self.stages.items()},
            "ratio": {k: v["ratio"] for k, v in self.stages.items()
                      if v.get("ratio") is not None},
            "sum_of_stages_s": _round_s(self.sum_of_stages_s),
            "monolithic_wall_s": _round_s(self.monolithic_wall_s),
            "overlap_fraction": self.overlap["fraction"],
        }

    def format(self) -> str:
        return format_stage_record(self.as_record())


def format_stage_record(record: dict, worst_stage: Optional[str] = None,
                        worst_constants=None) -> str:
    """The one human rendering of a stage-profile record: the drivers'
    ``--stage-profile`` printout (:meth:`StageProfile.format`) and
    ``analyze stages``, which adds the worst-mispredicted line."""
    stages = record.get("stages") or {}
    lines = [
        f"stage profile {str(record.get('plan_digest'))[:16]}: "
        f"{record.get('shuffle')} shuffle, "
        f"{record.get('n_ranks')} rank(s) x "
        f"k={record.get('over_decomposition')}, "
        f"{record.get('repeats')} repeat(s), "
        f"platform={record.get('platform')}"
        + ("  [OVERFLOW — walls belong to a clamped run]"
           if record.get("overflow") else ""),
        f"  {'stage':<10} {'measured':>12} {'predicted':>12} "
        f"{'ratio':>9}",
    ]
    ordered = [s for s in STAGE_KEYS if s in stages] + \
        sorted(s for s in stages if s not in STAGE_KEYS)
    for name in ordered:
        s = stages[name]
        if not s.get("ran"):
            lines.append(f"  {name:<10} {'-':>12} "
                         f"{s.get('predicted_s')!s:>12} {'-':>9}")
            continue
        ratio = (f"x{s['ratio']:.3g}" if s.get("ratio") is not None
                 else "-")
        lines.append(f"  {name:<10} {s['wall_s']:>12.6f} "
                     f"{s['predicted_s']:>12.6f} {ratio:>9}")
    ov = record.get("overlap") or {}
    mono = (record.get("monolithic") or {}).get("wall_s")
    if record.get("sum_of_stages_s") is not None and mono is not None:
        lines.append(
            f"  sum-of-stages {record['sum_of_stages_s']:.6f}s vs "
            f"monolithic {mono:.6f}s -> overlap credit "
            f"{ov.get('credit_s'):.6f}s"
            + (f" ({ov['fraction']:.1%} of segmented work hidden)"
               if ov.get("fraction") is not None else ""))
    ici = (stages.get("shuffle") or {}).get("ici")
    if ici:
        lines.append(
            f"  shuffle wire: {ici['offchip_bytes_per_rank']} "
            f"off-chip B/rank at "
            f"{ici['measured_gb_per_s']:.4g} GB/s = "
            f"{ici['ici_utilization']:.2%} of spec "
            f"{ici['spec_gb_per_s']:.3g} GB/s"
            + (f"  ({ici['note']})" if ici.get("note") else "")
            + ("" if record.get("platform") == "cuda" else
               "  (not a card: utilization against the H100's link "
               "rate is not meaningful)"))
    if worst_stage:
        lines.append(
            f"  worst-mispredicted stage: {worst_stage} -> refit "
            "constants " + ", ".join(worst_constants or ())
            + " (planning.cost.calibrate_from_stage_profile)")
    return "\n".join(lines)


def _stage_entry(ran: bool, walls, counters: Optional[dict],
                 predicted_s: float) -> dict:
    wall = _median(walls) if ran else 0.0
    return {
        "ran": bool(ran),
        "wall_s": _round_s(wall),
        "wall_min_s": _round_s(min(walls) if ran and walls else 0.0),
        "walls_s": [_round_s(w) for w in (walls or [])],
        "counters": {k: int(v) for k, v in
                     sorted((counters or {}).items())},
        "predicted_s": predicted_s,
        "ratio": (_round_s(wall / predicted_s)
                  if ran and predicted_s else None),
    }


def _prefixed(payload: dict, prefix: str) -> dict:
    """The columns of ``payload`` under ``prefix``, named without it."""
    return {name[len(prefix):]: c for name, c in payload.items()
            if name.startswith(prefix)}


def profile_join_stages(comm, build, probe, key="key", repeats: int = 3,
                        cost_model=None, **opts) -> StageProfile:
    """Profile one join stage by stage (module docstring).

    ``opts`` are ``distributed_inner_join``'s options, sizing factors
    included; the capacities resolve through ``resolve_join_ladder`` and
    ``planning.build_plan``, so the profile's ``plan_digest`` is the
    ``JoinSignature`` digest of the monolithic tape-off step (and the
    digest of a driver's ``explain.json`` for the same run).

    Builds three segment programs (the join alone on one bucket) and the
    monolithic step; an untimed side pass, never inside a timed
    region."""
    import torch

    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.ops import segmented as seg_ops
    from distributed_join_tpu_torch.ops.partition import (
        PartitionedTable,
        radix_hash_partition,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        JOIN_SHARDED_OUT,
        _bill_partition,
        _concat,
        _padded_wire,
        _round_up,
        _varwidth_cols,
        make_join_step,
        resolve_join_ladder,
    )
    from distributed_join_tpu_torch.parallel.shuffle import (
        prefetch_ragged_plans,
        shuffle_ragged,
        shuffle_segmented,
    )
    from distributed_join_tpu_torch.planning.cost import resolve_dcn_codec
    from distributed_join_tpu_torch.planning.plan import build_plan
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.telemetry.metrics import MetricsTape
    from distributed_join_tpu_torch.telemetry.spans import fetch_one_scalar

    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    opts = dict(opts)
    if opts.get("skew_threshold") is not None:
        raise ValueError(
            "stage profiling does not support the skew sidecar yet — "
            "profile with skew off (the skew stage is reported 0.0, "
            "matching cost.predict's key set)")
    keys = [key] if isinstance(key, str) else list(key)
    for kname in keys:
        if build.columns[kname].ndim != 1:
            raise ValueError(
                f"stage profiling does not support string (2-D) key "
                f"{kname!r} yet — profile the integer-key form")

    n = comm.n_ranks
    build = build.pad_to(_round_up(build.capacity, n))
    probe = probe.pad_to(_round_up(probe.capacity, n))
    dev = build.device

    # the one resolution: the ladder pops the sizing knobs out of opts,
    # and the plan's capacities are the step's arithmetic
    ladder = resolve_join_ladder(build, probe, n, opts,
                                 n_slices=comm.n_slices)
    sizing = ladder.sizing()
    plan = build_plan(comm, build, probe, key=key, with_metrics=False,
                      cost_model=cost_model, **sizing, **opts)
    mode = plan.shuffle
    k = plan.over_decomposition
    nb = n * k
    b_cap = plan.capacities["shuffle_build_per_bucket"]
    p_cap = plan.capacities["shuffle_probe_per_bucket"]
    out_cap = plan.capacities["out_rows_per_batch"]
    comp_bits = sizing.get("compression_bits")
    kc = opts.get("kernel_config")
    bpay, ppay = opts.get("build_payload"), opts.get("probe_payload")
    join_type = opts.get("join_type", "inner")
    if mode == "ragged" and (_varwidth_cols(build)
                             or _varwidth_cols(probe)):
        raise ValueError(
            "stage profiling does not support ragged-mode varwidth "
            "(byte-exact string) columns yet — profile with "
            "shuffle='padded' or drop the string columns")
    # the step's codec switch of the hierarchical wire's cross-slice hop
    dcn_on = (resolve_dcn_codec(opts.get("dcn_codec", "auto"))
              if mode == "hierarchical" else False)
    single = nb == 1
    # the segmented sort: the plan's segment count and fine capacities
    sort_seg = int(plan.capacities.get("sort_segments") or 1)
    seg_b_cap = plan.capacities.get("shuffle_build_per_segment")
    seg_p_cap = plan.capacities.get("shuffle_probe_per_segment")
    seg_out_cap = plan.capacities.get("out_rows_per_segment")
    sides = (("build", b_cap, seg_b_cap), ("probe", p_cap, seg_p_cap))

    def flag(x) -> torch.Tensor:
        return comm.psum(x.to(torch.int32)) > 0

    def false():
        return torch.zeros((), dtype=torch.bool, device=dev)

    # -- segment programs (each rank's part, run under comm.spmd) -------

    def seg_partition(build_local, probe_local):
        tape = MetricsTape()
        if sort_seg > 1:
            tape.add("sort_segments", sort_seg)
        out = {}
        overflow = false()
        for (side, cap, seg_cap), t in zip(sides, (build_local,
                                                  probe_local)):
            pt = radix_hash_partition(t, keys, nb, sub_buckets=sort_seg)
            _bill_partition(tape.scoped(side),
                            pt, seg_cap if sort_seg > 1 else cap)
            if mode == "ragged":
                # the bucket-sorted layout's gather is partition work
                # in the model, as to_padded's below
                rows = pt.order.to(torch.int64)
                for cname, c in pt.source.columns.items():
                    out[f"{side}.col.{cname}"] = c[rows]
                out[f"{side}.valid"] = pt.source.valid[rows]
                out[f"{side}.offsets"] = pt.offsets
                out[f"{side}.counts"] = pt.counts
                overflow = overflow | (pt.counts > cap).any()
                continue
            for b in range(k):
                if sort_seg > 1:
                    padded, counts, ovf, _ = pt.to_padded(
                        seg_cap, bucket_start=b * n * sort_seg,
                        n_buckets=n * sort_seg)
                else:
                    padded, counts, ovf, _ = pt.to_padded(
                        cap, bucket_start=b * n, n_buckets=n)
                out[f"{side}.b{b}.counts"] = counts
                for cname, c in padded.items():
                    out[f"{side}.b{b}.col.{cname}"] = c
                overflow = overflow | ovf
        return out, flag(overflow), tape.gathered(comm, dev)

    def seg_shuffle(payload):
        tape = MetricsTape()
        out = {}
        overflow = false()
        if mode == "ragged":
            pts = {}
            for side, _, _ in sides:
                rows = payload[f"{side}.valid"].shape[0]
                pts[side] = PartitionedTable(
                    source=Table(_prefixed(payload, f"{side}.col."),
                                 payload[f"{side}.valid"]),
                    order=torch.arange(rows, dtype=torch.int32,
                                       device=dev),
                    offsets=payload[f"{side}.offsets"],
                    counts=payload[f"{side}.counts"])
            # both sides' plans in one read, as the step
            prefetch_ragged_plans(comm, [(pts[s], []) for s, _, _ in sides])
        for side, cap, seg_cap in sides:
            t = tape.scoped(side)
            for b in range(k):
                if mode == "ragged":
                    recv, ovf = shuffle_ragged(
                        comm, pts[side], n * cap, bucket_start=b * n,
                        capacity_per_bucket=cap, tape=t)
                    overflow = overflow | ovf
                elif sort_seg > 1:
                    via = {"padded": "all_to_all", "ppermute": "ppermute",
                           "hierarchical": "hierarchical"}[mode]
                    cols, counts = shuffle_segmented(
                        comm, _prefixed(payload, f"{side}.b{b}.col."),
                        payload[f"{side}.b{b}.counts"], seg_cap, sort_seg,
                        via=via, tape=t)
                    out[f"{side}.b{b}.counts"] = counts
                    for cname, c in cols.items():
                        out[f"{side}.b{b}.col.{cname}"] = c
                    continue
                else:
                    recv, c_ovf = _padded_wire(
                        comm, _prefixed(payload, f"{side}.b{b}.col."),
                        payload[f"{side}.b{b}.counts"], cap, mode,
                        comp_bits, dcn_on, t)
                    if c_ovf is not None:
                        overflow = overflow | c_ovf
                out[f"{side}.b{b}.valid"] = recv.valid
                for cname, c in recv.columns.items():
                    out[f"{side}.b{b}.col.{cname}"] = c
        return out, flag(overflow), tape.gathered(comm, dev)

    def local_join(b_tbl, p_tbl):
        return sort_merge_inner_join(
            b_tbl, p_tbl, keys, out_cap, build_payload=bpay,
            probe_payload=ppay, kernel_config=kc, join_type=join_type)

    def settle(parts, total, overflow, tape):
        out = _concat(parts)
        tape.add("matches", total)
        metrics = tape.gathered(comm, dev)
        return ({"col." + nm: c for nm, c in out.columns.items()}
                | {"valid": out.valid}, comm.psum(total), flag(overflow),
                metrics)

    def seg_join(payload):
        tape = MetricsTape()
        parts = []
        total = torch.zeros((), dtype=torch.int64, device=dev)
        overflow = false()
        for b in range(k):
            if sort_seg > 1:
                runs = [r for side, _, _ in sides
                        for r in seg_ops.runs_from_blocks(
                            _prefixed(payload, f"{side}.b{b}.col."),
                            payload[f"{side}.b{b}.counts"])]
                table, t_batch, ovf = seg_ops.batched_sort_merge_inner_join(
                    *runs, keys, seg_out_cap, build_payload=bpay,
                    probe_payload=ppay)
            else:
                res = local_join(*(
                    Table(_prefixed(payload, f"{side}.b{b}.col."),
                          payload[f"{side}.b{b}.valid"])
                    for side, _, _ in sides))
                table, t_batch, ovf = res.table, res.total, res.overflow
            parts.append(table)
            total = total + t_batch
            overflow = overflow | ovf
        return settle(parts, total, overflow, tape)

    def seg_join_single(build_local, probe_local):
        res = local_join(build_local, probe_local)
        return settle([res.table], res.total.to(torch.int64), res.overflow,
                      MetricsTape())

    # -- the programs, warmed once, in a chain ------------------------

    aux_out = (False, True, True)        # payload sharded, rest replicated
    join_out = (False, True, True, True)
    seg_metrics: dict = {}
    if single:
        fn_join = comm.spmd(seg_join_single, sharded_out=join_out)
        j_out = fn_join(build, probe)
        fetch_one_scalar(j_out[1])
        overflow_seen = bool(j_out[2])
        seg_metrics["join"] = j_out[3].to_dict()["reduced"]
        chain = [("join", fn_join, (build, probe), 1)]
    else:
        # the later segments take this process's own part of the previous
        # segment's output (a process group hands each process its own)
        fn_part = comm.spmd(seg_partition, sharded_out=aux_out)
        fn_shuf = comm.spmd(seg_shuffle, sharded_out=aux_out,
                            local_inputs=True)
        fn_join = comm.spmd(seg_join, sharded_out=join_out,
                            local_inputs=True)
        a_out = fn_part(build, probe)
        fetch_one_scalar(a_out[1])
        b_out = fn_shuf(a_out[0])
        fetch_one_scalar(b_out[1])
        j_out = fn_join(b_out[0])
        fetch_one_scalar(j_out[1])
        overflow_seen = any(bool(o) for o in
                            (a_out[1], b_out[1], j_out[2]))
        seg_metrics["partition"] = a_out[2].to_dict()["reduced"]
        seg_metrics["shuffle"] = b_out[2].to_dict()["reduced"]
        seg_metrics["join"] = j_out[3].to_dict()["reduced"]
        chain = [("partition", fn_part, (build, probe), 1),
                 ("shuffle", fn_shuf, (a_out[0],), 1),
                 ("join", fn_join, (b_out[0],), 1)]

    # the monolithic comparator: the tape-off step the drivers time, at
    # the ladder's sizing (its digest is plan.digest)
    fn_mono = comm.spmd(make_join_step(comm, key=key, **sizing, **opts),
                        sharded_out=JOIN_SHARDED_OUT)
    warm = fn_mono(build, probe)
    fetch_one_scalar(warm.total)
    overflow_seen = overflow_seen or bool(warm.overflow)

    # -- the timed repeats: the same protocol on both sides -----------

    walls: dict = {name: [] for name, *_ in chain}
    mono_walls = []
    for _ in range(repeats):
        for name, fn, fargs, sync_idx in chain:
            t0 = time.perf_counter()
            res = fn(*fargs)
            fetch_one_scalar(res[sync_idx])
            dt = time.perf_counter() - t0
            walls[name].append(dt)
            telemetry.span_complete(f"stage_profile.{name}", t0, dt)
        t0 = time.perf_counter()
        res = fn_mono(build, probe)
        fetch_one_scalar(res.total)
        dt = time.perf_counter() - t0
        mono_walls.append(dt)
        telemetry.span_complete("stage_profile.monolithic", t0, dt)

    # -- assemble -----------------------------------------------------

    predicted = plan.cost["stages"]
    stages = {}
    for name in STAGE_KEYS:
        ran = name in walls
        stages[name] = _stage_entry(
            ran, walls.get(name), seg_metrics.get(name),
            predicted.get(name, 0.0))
    # the shuffle's link use: measured off-chip bytes over its wall
    # against the model's link rate
    sh = stages["shuffle"]
    if sh["ran"] and sh["wall_s"] > 0:
        wire_total = sum(sh["counters"].get(f"{s}.wire_bytes", 0)
                         for s in ("build", "probe"))
        offchip = int(wire_total / n * (n - 1) / n)
        spec = float(plan.cost["model"]["ici_bytes_per_s"])
        bw = offchip / sh["wall_s"]
        sh["ici"] = {
            "wire_bytes_per_rank": int(wire_total / n),
            "offchip_bytes_per_rank": offchip,
            "measured_gb_per_s": _round_s(bw / 1e9),
            "spec_gb_per_s": _round_s(spec / 1e9),
            "ici_utilization": _round_s(bw / spec),
        }
        if n == 1:
            sh["ici"]["note"] = ("a world of 1: no byte leaves the "
                                 "device; the shuffle wall times a "
                                 "local copy, not a link")

    return StageProfile(
        plan_digest=plan.digest,
        shuffle=mode,
        n_ranks=n,
        over_decomposition=k,
        repeats=repeats,
        platform=dev.type,
        overflow=overflow_seen,
        stages=stages,
        monolithic_walls_s=mono_walls,
        cost=plan.cost,
        sort_segments=sort_seg,
    )


# -- query profiling (walls an operator) ------------------------------


@dataclasses.dataclass
class QueryStageProfile:
    """One profiled multi-operator query: the walls of each operator
    (its own ``comm.spmd`` program), the monolithic ``make_query_step``
    walls (the program ``distributed_query`` runs) and the overlap
    credit across operators. Operators key like ``explain_query``'s
    verdicts, by op id.

    ``as_record()`` is the ``query_stageprofile.json`` artifact (a kind
    of its own: the join's four stage keys do not apply); ``summary()``
    is shaped for ``history.stages_block`` with op ids as the stage
    keys."""

    plan_digest: str
    n_ranks: int
    n_operators: int
    repeats: int
    platform: str
    overflow: bool
    operators: dict              # op_id -> stage dict (_stage_entry)
    order: list                  # op_ids in plan order
    monolithic_walls_s: list
    predicted_total_s: Optional[float]
    cost_model: Optional[dict] = None

    @property
    def monolithic_wall_s(self) -> float:
        return _median(self.monolithic_walls_s)

    @property
    def monolithic_wall_min_s(self) -> float:
        return min(self.monolithic_walls_s) \
            if self.monolithic_walls_s else 0.0

    @property
    def sum_of_operators_s(self) -> float:
        return sum(s["wall_s"] for s in self.operators.values())

    @property
    def overlap(self) -> dict:
        total = self.sum_of_operators_s
        credit = total - self.monolithic_wall_s
        return {
            "credit_s": _round_s(credit),
            "fraction": (_round_s(credit / total) if total > 0
                         else None),
            "note": ("sum-of-operators minus monolithic wall: what the "
                     "one query program hides across operator "
                     "boundaries that the per-op programs pay serially"),
        }

    def as_record(self) -> dict:
        return {
            "schema_version": STAGE_PROFILE_SCHEMA_VERSION,
            "kind": "query_stageprofile",
            "pipeline": "query",
            "plan_digest": self.plan_digest,
            "n_ranks": self.n_ranks,
            "n_operators": self.n_operators,
            "repeats": self.repeats,
            "platform": self.platform,
            "overflow": self.overflow,
            "order": list(self.order),
            "operators": {k: dict(v)
                          for k, v in self.operators.items()},
            "sum_of_operators_s": _round_s(self.sum_of_operators_s),
            "monolithic": {
                "wall_s": _round_s(self.monolithic_wall_s),
                "wall_min_s": _round_s(self.monolithic_wall_min_s),
                "walls_s": [_round_s(w)
                            for w in self.monolithic_walls_s],
            },
            "overlap": self.overlap,
            "cost_model": self.cost_model,
            "predicted_total_s": self.predicted_total_s,
        }

    def summary(self) -> dict:
        """The compact block of a record: ``history.stages_block`` reads
        the ``wall_s`` and ``ratio`` dicts whatever their keys, so the
        operators' walls reach ``analyze history`` trends."""
        return {
            "plan_digest": self.plan_digest,
            "pipeline": "query",
            "repeats": self.repeats,
            "platform": self.platform,
            "overflow": self.overflow,
            "wall_s": {k: v["wall_s"]
                       for k, v in self.operators.items()},
            "ratio": {k: v["ratio"] for k, v in self.operators.items()
                      if v.get("ratio") is not None},
            "sum_of_stages_s": _round_s(self.sum_of_operators_s),
            "monolithic_wall_s": _round_s(self.monolithic_wall_s),
            "overlap_fraction": self.overlap["fraction"],
        }

    def format(self) -> str:
        return format_query_stage_record(self.as_record())


def format_query_stage_record(record: dict) -> str:
    """The one human rendering of a query stage-profile record (the
    tpch driver's ``--query --stage-profile`` printout)."""
    ops = record.get("operators") or {}
    lines = [
        f"query stage profile {str(record.get('plan_digest'))[:16]}: "
        f"{record.get('n_operators')} operator(s), "
        f"{record.get('n_ranks')} rank(s), "
        f"{record.get('repeats')} repeat(s), "
        f"platform={record.get('platform')}"
        + ("  [OVERFLOW — walls belong to a clamped run]"
           if record.get("overflow") else ""),
        f"  {'operator':<14} {'measured':>12} {'predicted':>12} "
        f"{'ratio':>9}",
    ]
    order = [o for o in (record.get("order") or []) if o in ops] + \
        sorted(o for o in ops if o not in (record.get("order") or []))
    for name in order:
        s = ops[name]
        if not s.get("ran"):
            lines.append(f"  {name:<14} {'-':>12} "
                         f"{s.get('predicted_s')!s:>12} {'-':>9}")
            continue
        ratio = (f"x{s['ratio']:.3g}" if s.get("ratio") is not None
                 else "-")
        pred = s.get("predicted_s")
        pred_txt = f"{pred:>12.6f}" if pred else f"{'-':>12}"
        lines.append(f"  {name:<14} {s['wall_s']:>12.6f} "
                     f"{pred_txt} {ratio:>9}")
    ov = record.get("overlap") or {}
    mono = (record.get("monolithic") or {}).get("wall_s")
    if record.get("sum_of_operators_s") is not None \
            and mono is not None:
        lines.append(
            f"  sum-of-operators {record['sum_of_operators_s']:.6f}s "
            f"vs monolithic {mono:.6f}s -> overlap credit "
            f"{ov.get('credit_s'):.6f}s"
            + (f" ({ov['fraction']:.1%} of per-op work hidden)"
               if ov.get("fraction") is not None else ""))
    return "\n".join(lines)


def profile_query_stages(comm, plan, tables, repeats: int = 3,
                         cost_model=None,
                         **defaults) -> QueryStageProfile:
    """Profile one multi-operator ``planning.query.QueryPlan`` operator
    by operator.

    Each operator runs as its own ``make_join_step`` program (the steps
    ``make_query_step`` chains, through the shared ``_op_steps`` seam:
    the same keys, join type, fused aggregate and options) on the
    intermediates the warm chain produced, timed as the join profile
    times its stages; the monolithic side is the one ``make_query_step``
    program ``distributed_query`` runs. The predictions are
    ``explain_query``'s verdicts at the same defaults.

    Each operator's ``counters`` are what its warm run returned:
    ``matches`` (the step's total: the would-be join rows of a fused
    aggregate) and, for an aggregate, ``agg.groups``, the names of the
    metrics tape's counters for the same operator.

    ``defaults`` are ``distributed_query``'s executor defaults (an
    operator's own options win). An untimed side pass."""
    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.parallel.communicator import (
        ProcessGroupCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        JOIN_SHARDED_OUT,
        _round_up,
    )
    from distributed_join_tpu_torch.parallel.query_exec import (
        _op_steps,
        make_query_step,
        query_sharded_out,
    )
    from distributed_join_tpu_torch.planning.query import explain_query
    from distributed_join_tpu_torch.telemetry.spans import fetch_one_scalar

    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    defaults = dict(defaults)

    # the predictions first (host arithmetic): one verdict an operator
    # at the defaults the programs are built with
    doc = explain_query(plan, comm, dict(tables), cost_model=cost_model,
                        defaults=defaults, orders=False)
    predicted = {o["id"]: ((o.get("cost") or {}).get("total_s"))
                 for o in doc.get("operators") or []}

    n = comm.n_ranks
    missing = [name for name in plan.tables if name not in tables]
    if missing:
        raise ValueError(
            f"plan references base tables {missing} not supplied "
            f"(have {sorted(tables)})")
    padded = {
        name: tables[name].pad_to(_round_up(tables[name].capacity, n))
        for name in plan.tables
    }
    dev = next(iter(padded.values())).device

    # -- an operator a program (the _op_steps seam) ---------------------

    # an intermediate is the previous program's output: under a process
    # group, this process's own part
    base = set(plan.tables)
    op_fns = [comm.spmd(s, sharded_out=JOIN_SHARDED_OUT,
                        local_inputs=(op.build not in base,
                                      op.probe not in base))
              for op, s in zip(plan.ops,
                               _op_steps(comm, plan, defaults, False, None))]

    # the warm chain threads the intermediates as make_query_step's env
    # does; the timed repeats re-run each operator on its inputs
    overflow_seen = False
    env = dict(padded)
    op_inputs = []
    counters = {}
    for op, fn in zip(plan.ops, op_fns):
        fargs = (env[op.build], env[op.probe])
        res = fn(*fargs)
        fetch_one_scalar(res.total)
        overflow_seen = overflow_seen or bool(res.overflow)
        env[op.op_id] = res.table
        op_inputs.append((op.op_id, fn, fargs))
        c = {"matches": int(res.total)}
        if op.aggregate is not None:
            groups = res.table.valid.sum()
            if isinstance(comm, ProcessGroupCommunicator):
                groups = comm.psum(groups)
            c["agg.groups"] = int(groups)
        counters[op.op_id] = c

    # the monolithic comparator: the program distributed_query runs
    # (tape off)
    fn_mono = comm.spmd(make_query_step(comm, plan, defaults=defaults),
                        sharded_out=query_sharded_out(plan, False))
    margs = tuple(padded[name] for name in plan.tables)
    warm = fn_mono(*margs)
    fetch_one_scalar(warm.total)
    overflow_seen = overflow_seen or bool(warm.overflow)

    # -- the timed repeats --------------------------------------------

    walls: dict = {op_id: [] for op_id, *_ in op_inputs}
    mono_walls = []
    for _ in range(repeats):
        for op_id, fn, fargs in op_inputs:
            t0 = time.perf_counter()
            res = fn(*fargs)
            fetch_one_scalar(res.total)
            dt = time.perf_counter() - t0
            walls[op_id].append(dt)
            telemetry.span_complete(f"query_profile.{op_id}", t0, dt)
        t0 = time.perf_counter()
        res = fn_mono(*margs)
        fetch_one_scalar(res.total)
        dt = time.perf_counter() - t0
        mono_walls.append(dt)
        telemetry.span_complete("query_profile.monolithic", t0, dt)

    operators = {
        op_id: _stage_entry(True, walls[op_id], counters[op_id],
                            predicted.get(op_id) or 0.0)
        for op_id, *_ in op_inputs
    }
    return QueryStageProfile(
        plan_digest=doc.get("digest") or plan.digest(),
        n_ranks=n,
        n_operators=len(plan.ops),
        repeats=repeats,
        platform=dev.type,
        overflow=overflow_seen,
        operators=operators,
        order=[op.op_id for op in plan.ops],
        monolithic_walls_s=mono_walls,
        predicted_total_s=doc.get("total_s"),
    )
