"""The history-driven autotuner.

Port of ``distributed_join_tpu/planning/tuner.py``: the workload
identity the serving layer keys on (``workload_signature``, JAX
:95-127), ``TunedConfig`` (:129-178), ``JoinTuner`` (:180-685),
``_fixed_row_bytes``, ``_static_defaults`` and ``format_tune``
(:687-756). Names, record keys, ``basis`` notes and strings are the JAX
package's, so ``analyze tune`` prints the same text for the same store.

The history store (:mod:`..telemetry.history`) records, per workload
signature, what the retry ladder resolved to, the device counters' skew
and headroom indicators and, for ``--stage-profile`` runs, the stage
walls. :class:`JoinTuner` reads them back:

- a signature with no history runs the static resolution, the exact
  tuner-off program;
- a workload whose ladder escalated starts at the final rung it resolved
  to, with that rung's sizing *and* its absolute rung label, so its
  program signature is the one the cold run already built: a warm tuned
  repeat builds no program and climbs no rung;
- structural knobs (``skew_threshold``, ``shuffle``, ``dcn_codec``,
  ``sort_mode``) are filled from evidence, and only where the caller
  left them unset;
- the ladder still guards every run, so a lying history costs rebuilt
  programs, never wrong rows.

Sizing knobs override the caller's values: the history of this exact
signature, which binds those values, shows that they overflowed.

The fill rules are the JAX package's, written for the TPU (thresholds
from ``telemetry/analyze.py``); ``chip_smoke.py`` phase 23 measures what
each does on an H100.

Surfaces: ``distributed_inner_join(tuner=)``, the resident join's
``tuner=``, ``JoinService(auto_tune=True)`` and the daemon's
``--auto-tune``, the join driver's and ``bench.py``'s
``--auto-tune[=HISTORY]`` (capacity pre-sizing only: the driver store
keys a run by its flags, where a mode switch would fork the signature),
and ``analyze tune`` (the dry run).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Optional

TUNER_SCHEMA_VERSION = 1

# The ladder's own axes: pre-applied from history, overriding the
# caller's values.
SIZING_KNOBS = (
    "shuffle_capacity_factor", "out_capacity_factor",
    "out_rows_per_rank", "compression_bits",
    "hh_build_capacity", "hh_probe_capacity", "hh_out_capacity",
)
# Program-shape knobs: filled only where the caller left them unset.
STRUCTURAL_KNOBS = ("shuffle", "skew_threshold", "dcn_codec",
                    "sort_mode")

# The join stage (where the merged sort lives) dominates when its
# measured wall crosses this share of the summed stage walls: the
# evidence bar for the segmented sort.
SORT_STAGE_SHARE_WARN = 0.5

# The cross-slice tier dominates a hierarchical run's wire when its
# share of the bytes crosses this: the evidence bar for the DCN codec.
DCN_SHARE_WARN = 0.4

# The skew threshold the fill sets (analyze's skew_enable_prpd advice).
DEFAULT_SKEW_THRESHOLD = 0.001
# The headroom bump (analyze's shuffle_headroom advice).
HEADROOM_BUMP = 1.5


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def workload_signature(comm, build, probe, key="key",
                       with_metrics=None, with_integrity: bool = False,
                       **opts) -> str:
    """The rung-stable workload identity (16 hex chars): the program
    cache's canonical signature digest over the tables and the caller's
    pre-tuned options, before the ladder resolves its sizing and before
    the tuner applies its verdict, so one workload keeps one identity
    across rungs and tuned repeats. The service's live metrics, flight
    records and history lines key on it, and so does the tuner's lookup.

    ``with_metrics=None`` resolves from the telemetry session, as the
    program cache resolves it (JAX :95-127). An option set that
    does not resolve to a signature (an unknown option, a refused one, a
    malformed table) still gets an identity, the JAX package's sha256 of
    the key, the column names and the options, so the join's own refusal
    is what the caller sees."""
    if with_metrics is None:
        from distributed_join_tpu_torch import telemetry

        with_metrics = telemetry.enabled()
    try:
        from distributed_join_tpu_torch.service.programs import (
            JoinSignature,
        )

        return JoinSignature.of(
            comm, build, probe, key=key, with_metrics=with_metrics,
            with_integrity=with_integrity, **opts).digest()[:16]
    except Exception:
        basis = json.dumps(
            {"key": key,
             "build": sorted(build.columns),
             "probe": sorted(probe.columns),
             "opts": sorted((k, repr(v)) for k, v in opts.items())},
            sort_keys=True, default=str)
        return hashlib.sha256(basis.encode()).hexdigest()[:16]


@dataclasses.dataclass
class TunedConfig:
    """One signature's verdict: what to override (sizing), what to fill
    (structural), which rung to label the first attempt with, and the
    evidence. ``source`` is ``"history"`` when anything was adopted,
    ``"static"`` for the no-history first run."""

    signature: str
    source: str = "static"
    rung: int = 0
    sizing: dict = dataclasses.field(default_factory=dict)
    structural: dict = dataclasses.field(default_factory=dict)
    basis: dict = dataclasses.field(default_factory=dict)
    applied: dict = dataclasses.field(default_factory=dict)

    def apply(self, opts: dict) -> dict:
        """This verdict merged into a join's options (a new dict).
        Structural knobs fill only where absent; sizing knobs override.
        The heavy-hitter blocks apply only when the merged options run
        the skew path: in a skew-off program they would fork its cache
        signature for options the step never reads. What changed lands
        in ``self.applied``."""
        new = dict(opts)
        applied = {}
        for k, v in self.structural.items():
            if k not in new:
                new[k] = v
                applied[k] = v
        skew_on = new.get("skew_threshold") is not None
        for k, v in self.sizing.items():
            if k.startswith("hh_") and not skew_on:
                continue
            if new.get(k) != v:
                applied[k] = v
            new[k] = v
        self.applied = applied
        return new

    def as_record(self) -> dict:
        return {
            "schema_version": TUNER_SCHEMA_VERSION,
            "signature": self.signature,
            "source": self.source,
            "rung": self.rung,
            "sizing": dict(self.sizing),
            "structural": dict(self.structural),
            "applied": dict(self.applied),
            "basis": dict(self.basis),
        }


class JoinTuner:
    """Per-signature knob selection from a workload-history store.

    An in-memory table of :class:`~..telemetry.history.SignatureTrend`
    aggregates: loaded once from a history file (a missing file is an
    empty table: every workload static), then fed live entries through
    :meth:`observe_entry` (the service does, after each request, so a
    pre-size that still escalated is corrected for the next one).
    Thresholds default to the diagnosis layer's
    (``telemetry/analyze.py``)."""

    def __init__(self, history: Optional[str] = None, *,
                 min_entries: int = 1,
                 skew_gini_warn: Optional[float] = None,
                 wire_efficiency_warn: Optional[float] = None,
                 headroom_ratio_warn: Optional[float] = None):
        from distributed_join_tpu_torch.telemetry.analyze import (
            HEADROOM_RATIO_WARN,
            SKEW_GINI_WARN,
            WIRE_EFFICIENCY_WARN,
        )

        self.path = None
        self.min_entries = int(min_entries)
        self.skew_gini_warn = (skew_gini_warn if skew_gini_warn
                               is not None else SKEW_GINI_WARN)
        self.wire_efficiency_warn = (
            wire_efficiency_warn if wire_efficiency_warn is not None
            else WIRE_EFFICIENCY_WARN)
        self.headroom_ratio_warn = (
            headroom_ratio_warn if headroom_ratio_warn is not None
            else HEADROOM_RATIO_WARN)
        self._trends: dict = {}
        self.observed = 0
        self.recommendations = 0
        self.history_hits = 0
        # the serving layer's request tenant, pinned under its exec lock
        # before dispatch: recommend() reads it when the call names no
        # tenant (None: the default tenant, the bare-signature lookup)
        self.active_tenant: Optional[str] = None
        if history:
            self.load(history)

    # -- what the tuner knows ------------------------------------------------

    def load(self, history: str) -> int:
        """(Re)load a history store; a missing file is an empty table.
        Returns the entries loaded."""
        from distributed_join_tpu_torch.telemetry import history as hist

        self.path = hist.history_path(history)
        self._trends = {}
        self.observed = 0
        if not os.path.exists(self.path):
            return 0
        entries, _ = hist.load_history(self.path)
        for e in entries:
            self.observe_entry(e)
        return len(entries)

    def observe_entry(self, entry: dict) -> None:
        """Fold one history entry (request, run or rollup line) into the
        table. A non-default tenant's entries key as
        ``tenant/signature``, so one tenant's history never pre-sizes
        another's programs."""
        from distributed_join_tpu_torch.telemetry.history import (
            SignatureTrend,
            tenant_key,
        )

        sig = tenant_key(entry.get("signature"), entry.get("tenant"))
        self._trends.setdefault(sig, SignatureTrend()).add(entry)
        self.observed += 1

    def stats(self) -> dict:
        return {
            "signatures": len(self._trends),
            "observed": self.observed,
            "recommendations": self.recommendations,
            "history_hits": self.history_hits,
            "min_entries": self.min_entries,
            "history_path": self.path,
        }

    # -- the decision --------------------------------------------------------

    def recommend(self, signature: str, user_opts: Optional[dict] = None,
                  *, side_geometry: Optional[dict] = None,
                  tenant: Optional[str] = None) -> TunedConfig:
        """The verdict for one workload signature.

        ``user_opts`` is the caller's option dict (a structural knob
        present there is never filled). ``side_geometry`` (``{"b_local",
        "p_local", "nb", "n_ranks", "n_slices", "row_bytes": {side:
        int}}``) enables the shape-dependent clauses; :meth:`resolve`
        derives it from the tables.

        The clauses, in order, each recording its evidence in ``basis``:

        1. no trend, fewer than ``min_entries`` entries, no successful
           run, or counter drift at unchanged sizing: static;
        2. escalations on record: adopt the final rung's sizing and its
           rung label;
        3. else a recorded overflow margin under ``headroom_ratio_warn``
           of the bucket capacity: bump ``shuffle_capacity_factor`` by
           ``HEADROOM_BUMP``;
        4. per-rank key-skew Gini over the warn threshold: fill
           ``skew_threshold`` (never under aggregation);
        5. padded wire efficiency under the warn threshold: fill
           ``shuffle`` (ragged, or hierarchical over several slices),
           compression off;
        6. the cross-slice share of the wire over ``DCN_SHARE_WARN``
           with the codec off: fill ``dcn_codec="on"``;
        7. the join stage over ``SORT_STAGE_SHARE_WARN`` of the stage
           walls, at a shape that segments: fill
           ``sort_mode="segmented"`` (never over the ragged or
           compressed wire, an aggregate, kernel flags, or an armed
           cross-slice codec).
        """
        from distributed_join_tpu_torch.telemetry.history import tenant_key

        user_opts = user_opts or {}
        self.recommendations += 1
        cfg = TunedConfig(signature=signature)
        if tenant is None:
            tenant = self.active_tenant
        trend = self._trends.get(tenant_key(signature, tenant))
        if trend is None or trend.entries < self.min_entries:
            cfg.basis["note"] = (
                f"no history for signature ({trend.entries if trend else 0}"
                f"/{self.min_entries} entries) — static plan")
            return cfg
        cfg.basis["entries"] = trend.entries
        if trend.successes == 0:
            cfg.basis["note"] = ("no successful run on record — "
                                 "refusing to pre-size from failures")
            return cfg
        if trend.counter_drift:
            cfg.basis["note"] = (
                "counter signature drifted at unchanged sizing — data "
                "moved; re-observing before pre-sizing")
            return cfg

        # 2. the escalated rung's sizing and label
        if trend.escalations and trend.resolved_knobs_last:
            cfg.sizing = {k: v for k, v
                          in trend.resolved_knobs_last.items()
                          if k in SIZING_KNOBS}
            cfg.rung = int(trend.resolved_rung_last or 0)
            cfg.source = "history"
            cfg.basis["adopted_rung"] = {
                "escalations": trend.escalations,
                "rung": cfg.rung,
            }
        elif side_geometry:
            # 3. the recorded headroom against the observed factor's
            # capacity
            bump = self._headroom_bump(trend, user_opts, side_geometry)
            if bump is not None:
                cfg.sizing["shuffle_capacity_factor"] = bump[0]
                cfg.source = "history"
                cfg.basis["headroom"] = bump[1]

        # 4. skew; never under the aggregate pushdown, which refuses the
        # skew sidecar
        if "skew_threshold" not in user_opts \
                and user_opts.get("aggregate") is None:
            gini = self._worst_gini(trend.indicators_last)
            if gini is not None and gini[1] > self.skew_gini_warn:
                cfg.structural["skew_threshold"] = DEFAULT_SKEW_THRESHOLD
                cfg.source = "history"
                cfg.basis["skew"] = {"counter": gini[0],
                                     "gini": gini[1],
                                     "warn": self.skew_gini_warn}

        # 5. the wire: padding-dominated bytes go to the ragged wire on a
        # flat mesh, and to the two-level shuffle over several slices
        # (ragged would route one global exchange across the slow tier)
        if ("shuffle" not in user_opts
                and user_opts.get("compression_bits") is None
                and "compression_bits" not in cfg.sizing
                and side_geometry):
            eff = self._wire_efficiency(trend.counters_last, side_geometry)
            if eff is not None and eff[1] < self.wire_efficiency_warn:
                multi_slice = (side_geometry.get("n_slices") or 1) > 1
                cfg.structural["shuffle"] = (
                    "hierarchical" if multi_slice else "ragged")
                cfg.source = "history"
                cfg.basis["wire"] = {"side": eff[0],
                                     "efficiency": eff[1],
                                     "warn": self.wire_efficiency_warn}

        # 6. the cross-slice codec, for a hierarchical workload whose
        # cross-slice bytes dominate and whose codec was off
        if "dcn_codec" not in user_opts:
            share = self._dcn_share(trend.counters_last)
            if share is not None and share[0] > DCN_SHARE_WARN \
                    and not share[1]:
                cfg.structural["dcn_codec"] = "on"
                cfg.source = "history"
                cfg.basis["dcn_codec"] = {
                    "dcn_share": share[0],
                    "warn": DCN_SHARE_WARN,
                    "codec_was_on": share[1]}

        # 7. the sort mode, from stage-profiled history. The step refuses
        # segmented over the ragged or compressed wire, an aggregate,
        # kernel flags and an armed cross-slice codec, and a filled knob
        # must not turn a working workload into an error; a one-segment
        # resolution is the flat program under another signature.
        shuffle_eff = cfg.structural.get("shuffle", user_opts.get("shuffle"))
        dcn_knob = cfg.structural.get(
            "dcn_codec", user_opts.get("dcn_codec", "auto")) or "auto"
        from distributed_join_tpu_torch.planning.cost import (
            DCN_CODEC_KNOBS,
            resolve_dcn_codec,
        )

        hier_codec_armed = (
            shuffle_eff == "hierarchical"
            and ((side_geometry or {}).get("n_slices") or 1) > 1
            # an invalid knob is the join's error: treat it as armed
            and (dcn_knob not in DCN_CODEC_KNOBS
                 or resolve_dcn_codec(dcn_knob)))
        if ("sort_mode" not in user_opts
                and shuffle_eff != "ragged"
                and not hier_codec_armed
                and user_opts.get("compression_bits") is None
                and "compression_bits" not in cfg.sizing
                and user_opts.get("aggregate") is None
                and user_opts.get("kernel_config") is None
                and side_geometry):
            share = self._join_stage_share(trend.stages_last)
            if share is not None and share > SORT_STAGE_SHARE_WARN:
                from distributed_join_tpu_torch.ops.segmented import (
                    resolve_sort_segments,
                )

                n_ranks = int(side_geometry.get("n_ranks") or 1)
                nb = int(side_geometry.get("nb") or n_ranks)
                factor = float(
                    (trend.resolved_knobs_last or {}).get(
                        "shuffle_capacity_factor")
                    or user_opts.get("shuffle_capacity_factor")
                    or _static_defaults()["shuffle_capacity_factor"])
                segs = resolve_sort_segments(
                    user_opts.get("sort_segments"),
                    max(side_geometry.get("b_local") or 0,
                        side_geometry.get("p_local") or 0),
                    n_ranks, max(nb // max(n_ranks, 1), 1), factor)
                if segs > 1:
                    cfg.structural["sort_mode"] = "segmented"
                    cfg.source = "history"
                    cfg.basis["sort_mode"] = {
                        "join_stage_share": round(share, 4),
                        "warn": SORT_STAGE_SHARE_WARN,
                        "segments": segs}
        if cfg.source == "history":
            self.history_hits += 1
        return cfg

    def resolve(self, comm, build, probe, *, key="key",
                with_integrity: bool = False,
                opts: Optional[dict] = None) -> TunedConfig:
        """The library path's verdict (``distributed_inner_join(tuner=)``):
        the workload signature of the call, hashed as the service keys
        its history (unpadded tables, pre-tuned options; ``with_metrics``
        in ``opts``, None resolving from the session), and the shape
        geometry of the shape-dependent clauses."""
        opts = dict(opts or {})
        wm = opts.pop("with_metrics", None)
        wi = opts.pop("with_integrity", with_integrity)
        sig = workload_signature(comm, build, probe, key=key,
                                 with_metrics=wm, with_integrity=wi,
                                 **opts)
        n = comm.n_ranks
        k = int(opts.get("over_decomposition") or 1)
        geometry = {
            "nb": n * k,
            "n_ranks": n,
            "n_slices": int(getattr(comm, "n_slices", 1)),
            "b_local": _round_up(build.capacity, n) // n,
            "p_local": _round_up(probe.capacity, n) // n,
            "row_bytes": {
                "build": _fixed_row_bytes(build),
                "probe": _fixed_row_bytes(probe),
            },
        }
        return self.recommend(sig, user_opts=opts, side_geometry=geometry)

    def resolve_resident(self, comm, resident_rows_per_rank: int, probe, *,
                         signature: str,
                         opts: Optional[dict] = None) -> TunedConfig:
        """The probe-only verdict (``service/resident.py``): sizing and
        the rung label only. The resident image's sizing was fixed at
        registration, and structural fills never apply (the probe-only
        program has no skew sidecar, and its wire was chosen when the
        workload was shaped), so a structural recommendation lands in
        ``basis["structural_dropped"]``. ``signature`` is the registry's
        generation-free identity, so the history survives merges."""
        opts = dict(opts or {})
        n = comm.n_ranks
        k = int(opts.get("over_decomposition") or 1)
        geometry = {
            "nb": n * k,
            "n_ranks": n,
            # the build margin slot maps to the resident image, whose
            # margin never shows in probe-only indicators
            "b_local": int(resident_rows_per_rank),
            "p_local": _round_up(probe.capacity, n) // n,
            "row_bytes": {
                "build": None,
                "probe": _fixed_row_bytes(probe),
            },
        }
        cfg = self.recommend(signature, user_opts=opts,
                             side_geometry=geometry)
        if cfg.structural:
            cfg.basis["structural_dropped"] = dict(cfg.structural)
            cfg.structural = {}
        return cfg

    # -- the clauses' evidence ------------------------------------------------

    @staticmethod
    def _join_stage_share(stages_last):
        """The join stage's share of the summed stage walls in the
        latest stages block (``{"wall_s": {stage: s}}``), or None
        without stage-profiled evidence."""
        walls = ((stages_last or {}).get("wall_s") or {})
        join_w = walls.get("join")
        total = sum(v for v in walls.values() if v)
        if not join_w or total <= 0:
            return None
        return float(join_w) / float(total)

    @staticmethod
    def _worst_gini(indicators):
        worst = None
        for name, d in (indicators or {}).items():
            if not isinstance(d, dict) or "gini" not in d:
                continue
            if worst is None or d["gini"] > worst[1]:
                worst = (name, d["gini"])
        return worst

    def _headroom_bump(self, trend, user_opts: dict, geometry: dict):
        """``(new factor, basis)`` when a side's recorded minimum
        overflow margin is within ``headroom_ratio_warn`` of its bucket
        capacity, else None."""
        ind = trend.indicators_last or {}
        factor = float(
            (trend.resolved_knobs_last or {}).get("shuffle_capacity_factor")
            or user_opts.get("shuffle_capacity_factor")
            or _static_defaults()["shuffle_capacity_factor"])
        nb = geometry["nb"]
        if nb <= 1:
            return None
        tight = None
        for side, local in (("build", geometry["b_local"]),
                            ("probe", geometry["p_local"])):
            margin = ind.get(f"{side}.overflow_margin_min")
            if margin is None:
                continue
            cap = _round_up(int(math.ceil(local / nb * factor)), 8)
            if cap <= 0:
                continue
            ratio = margin / cap
            if 0 <= ratio < self.headroom_ratio_warn:
                if tight is None or ratio < tight["ratio"]:
                    tight = {"side": side, "margin_rows": int(margin),
                             "capacity_rows": cap,
                             "ratio": round(ratio, 4)}
        if tight is None:
            return None
        new_factor = round(factor * HEADROOM_BUMP, 6)
        tight["factor"] = {"from": factor, "to": new_factor}
        return new_factor, tight

    @staticmethod
    def _dcn_share(counters):
        """``(cross-slice share of the wire bytes, codec was on)`` from
        the last per-tier counters (hierarchical runs only), else None.
        Whether the codec was on is read from its savings: a codec-on
        run with nothing to compress reads as off, and the ``on`` fill
        is then a no-op."""
        if not counters:
            return None
        dcn = sum(counters.get(f"{s}.wire_bytes_dcn") or 0
                  for s in ("build", "probe"))
        total = sum(counters.get(f"{s}.wire_bytes") or 0
                    for s in ("build", "probe"))
        if not dcn or not total:
            return None
        saved = sum(counters.get(f"{s}.wire_bytes_saved") or 0
                    for s in ("build", "probe"))
        return round(dcn / total, 4), saved > 0

    def _wire_efficiency(self, counters, geometry: dict):
        """``(side, efficiency)`` of the worst side from the last
        counters: payload bytes (the fixed-width schema estimate) over
        wire bytes."""
        if not counters:
            return None
        worst = None
        for side in ("build", "probe"):
            wire = counters.get(f"{side}.wire_bytes")
            rows = counters.get(f"{side}.rows_shuffled")
            row_bytes = geometry["row_bytes"].get(side)
            if not wire or not rows or not row_bytes:
                continue
            eff = round((rows * row_bytes) / wire, 4)
            if worst is None or eff < worst[1]:
                worst = (side, eff)
        return worst

    # -- the dry run (analyze tune) -------------------------------------------

    def dry_run(self, signature: Optional[str] = None) -> dict:
        """The ``analyze tune`` record: every known signature's (or one
        signature's) verdict and its knob delta against the static
        defaults, with the evidence; nothing runs."""
        statics = _static_defaults()
        sigs = [signature] if signature else sorted(self._trends)
        out: dict = {}
        for sig in sigs:
            cfg = self.recommend(sig)
            trend = self._trends.get(sig)
            t = trend.as_dict() if trend is not None else None
            knobs = {**cfg.structural, **cfg.sizing}
            out[sig] = {
                "source": cfg.source,
                "rung": cfg.rung,
                "knobs": knobs,
                "delta": {
                    k: {"static": statics.get(k), "tuned": v}
                    for k, v in sorted(knobs.items())
                    if statics.get(k) != v
                },
                "basis": cfg.basis,
                "trend": {
                    "entries": t["entries"],
                    "outcomes": t["outcomes"],
                    "escalations": t["escalations"],
                    "counter_drift": t["counter_drift"],
                } if t else None,
            }
        return {
            "schema_version": TUNER_SCHEMA_VERSION,
            "kind": "tune",
            "history": self.path,
            "n_signatures": len(out),
            "signatures": out,
        }


def _fixed_row_bytes(table) -> Optional[int]:
    """Fixed-width bytes a row over a table's columns (the ``#len``
    companions excluded: they describe, they do not ship); a shape-level
    estimate for the wire-efficiency clause. None when a column has no
    fixed width."""
    total = 0
    try:
        for name, c in table.columns.items():
            if name.endswith("#len"):
                continue
            trailing = 1
            for d in c.shape[1:]:
                trailing *= int(d)
            total += c.element_size() * trailing
    except Exception:
        return None
    return total or None


def _static_defaults() -> dict:
    """The knob values a tuner-off run resolves to (the static column of
    ``analyze tune``'s delta)."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_OUT_CAPACITY_FACTOR,
        DEFAULT_SHUFFLE_CAPACITY_FACTOR,
    )

    return {
        "shuffle_capacity_factor": DEFAULT_SHUFFLE_CAPACITY_FACTOR,
        "out_capacity_factor": DEFAULT_OUT_CAPACITY_FACTOR,
        "out_rows_per_rank": None,
        "compression_bits": None,
        "hh_build_capacity": None,
        "hh_probe_capacity": None,
        "hh_out_capacity": None,
        "shuffle": "padded",
        "skew_threshold": None,
        "dcn_codec": "auto",
    }


def format_tune(record: dict) -> str:
    """The ``analyze tune`` report of a :meth:`JoinTuner.dry_run`
    record."""
    lines = [f"tune: {record['n_signatures']} signature(s)"
             + (f"  [{record['history']}]" if record.get("history")
                else "")]
    for sig, v in record["signatures"].items():
        trend = v.get("trend") or {}
        lines.append(
            f"  {sig}: {v['source']}"
            + (f" (rung {v['rung']})" if v["rung"] else "")
            + (f"  [{trend.get('entries', 0)} run(s), "
               f"{trend.get('escalations', 0)} escalation(s)]"
               if trend else ""))
        for k, d in (v.get("delta") or {}).items():
            lines.append(f"    {k}: {d['static']} -> {d['tuned']}")
        basis = v.get("basis") or {}
        note = basis.get("note")
        if note:
            lines.append(f"    note: {note}")
        for kind in ("adopted_rung", "headroom", "skew", "wire"):
            if kind in basis:
                lines.append(f"    evidence[{kind}]: "
                             f"{json.dumps(basis[kind], sort_keys=True)}")
        if not v.get("delta") and not note:
            lines.append("    no knob changes vs the static plan")
    return "\n".join(lines)
