"""Run analysis: the read side of the telemetry session.

Port of ``distributed_join_tpu/telemetry/analyze.py``, with the JAX
package's names, artifact schemas, outputs and exit codes, so the same
files give the same verdicts through either package:

- :func:`load_run` merges a run directory (per-rank
  ``events.rank<r>.jsonl`` and rank 0's ``summary.json``) into one
  cross-rank view;
- :func:`compute_indicators` turns it into health indicators: the
  straggler index (max/mean span seconds a stage across ranks), the
  key-skew Gini over the per-rank row counters, the overflow-margin
  headroom, the wire-byte efficiency (actual against ideal payload,
  with the varwidth prefixes and the codec's savings), the retry
  ladder's cost and the host-side stage split;
- :func:`recommend` maps a warning indicator to the knobs that relieve
  it (``--skew-threshold`` and ``--hh-*`` of ``parallel/skew.py``,
  ``--shuffle-capacity-factor``, ``--out-capacity-factor``,
  ``--over-decomposition-factor`` and ``--shuffle ragged`` of
  ``parallel/distributed_join.py``);
- :func:`diagnose_run` writes ``diagnosis.json`` beside the run's
  telemetry files and renders the report (every driver's
  ``--diagnose`` lands here through ``benchmarks.run_guarded``);
- :func:`grade_explain`, :func:`grade_queryplan` and
  :func:`grade_stages` hold an ``explain.json``, a ``queryplan`` record
  and a ``stageprofile.json`` (:mod:`.stageprof`) against what was
  measured; :func:`check_file` validates every artifact kind by shape.

The CLI, ``python -m distributed_join_tpu_torch.telemetry.analyze``:
``diagnose``, ``report``, ``compare`` (the regression gate against a
baseline of :mod:`.baselines`: exit 2 on counter drift or a banded
wall-time regression), ``explain`` (``--gate-wire-bytes`` makes the
exact wire-byte prediction a gate), ``stages``, ``history`` (a
workload-history store's per-signature trends, :mod:`.history`),
``timeline`` (:mod:`.timeline`), ``tune`` (the autotuner's dry run over
a history store, :mod:`..planning.tuner`: per signature the knobs a
tuned run would dispatch with against the static plan) and ``check``.

Device-free: analysis reads the artifacts, never the card, so it runs
anywhere the files are.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import sys
from typing import Optional

from distributed_join_tpu_torch.telemetry import baselines
# THE stage-key contract (1:1 with planning.cost.predict's stage
# keys) — one definition, owned by the profiling harness (whose
# module-level imports are deliberately light).
from distributed_join_tpu_torch.telemetry.stageprof import (
    STAGE_KEYS as _STAGEPROFILE_STAGES,
)

DIAGNOSIS_SCHEMA_VERSION = 1

# Warning thresholds: the JAX package's, so both packages give one
# verdict on the same files.
SKEW_GINI_WARN = 0.10        # Gini over per-rank counters
SKEW_IMBALANCE_WARN = 1.30   # max/mean over per-rank counters
STRAGGLER_WARN = 1.50        # max/mean span seconds across ranks
HEADROOM_RATIO_WARN = 0.15   # overflow margin / avg bucket rows
WIRE_EFFICIENCY_WARN = 0.60  # payload bytes / wire bytes

# The per-rank counters whose imbalance means KEY skew (receive-side:
# hash routing concentrated rows; matches: multiplicity concentrated
# work). Send-side counters are generator-balanced by construction.
_SKEW_COUNTERS = ("build.rows_received", "probe.rows_received",
                  "matches")
# Span names worth a cross-rank straggler index (host-visible stages).
_STAGE_SPANS = ("timed_join", "all_to_all", "collect_metrics",
                "generate", "stage", "fetch", "dispatch")


@dataclasses.dataclass
class RunData:
    """One run directory, merged cross-rank."""

    run_dir: str
    events: list                 # all ranks' JSONL events, ts-sorted
    summary: Optional[dict]      # rank-0 summary.json (None if absent)
    record: Optional[dict]       # driver/bench JSON record (optional)
    ranks_seen: list             # ranks with an events file
    malformed_lines: int

    @property
    def metrics(self) -> Optional[dict]:
        """The device-counter block {n_ranks, per_rank, reduced}."""
        if self.summary and isinstance(self.summary.get("metrics"), dict):
            return self.summary["metrics"]
        if self.record:
            sig = None
            tel = self.record.get("telemetry")
            if isinstance(tel, dict) and isinstance(
                    tel.get("metrics"), dict):
                sig = tel["metrics"]
            return sig
        return None


def load_run(run_dir: str, record=None) -> RunData:
    """Load a telemetry run directory. ``record`` may be a path to the
    driver's ``--json-output`` file or an already-loaded dict; any
    pre-``schema_version: 2`` record is tolerated
    (``benchmarks.load_record`` stamps missing versions as v1)."""
    from distributed_join_tpu_torch.benchmarks import load_record

    if not os.path.isdir(run_dir):
        raise FileNotFoundError(f"not a run directory: {run_dir}")
    events, ranks, malformed = [], [], 0
    for path in sorted(glob.glob(os.path.join(run_dir,
                                              "events.rank*.jsonl"))):
        m = re.search(r"events\.rank(\d+)\.jsonl$", path)
        rank = int(m.group(1)) if m else 0
        ranks.append(rank)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    malformed += 1   # a killed run's torn last line
                    continue
                ev.setdefault("rank", rank)
                events.append(ev)
    events.sort(key=lambda e: e.get("ts_us", 0.0))
    summary = None
    spath = os.path.join(run_dir, "summary.json")
    if os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
    if record is not None and not isinstance(record, dict):
        record = load_record(record)
    return RunData(run_dir=run_dir, events=events, summary=summary,
                   record=record, ranks_seen=sorted(set(ranks)),
                   malformed_lines=malformed)


# -- small stats ------------------------------------------------------


def gini(values) -> Optional[float]:
    """Gini coefficient over non-negative per-rank totals: 0 =
    perfectly balanced, ->1 = one rank holds everything."""
    vals = sorted(float(v) for v in values)
    n = len(vals)
    total = sum(vals)
    if n < 2 or total <= 0:
        return None
    cum = 0.0
    for i, v in enumerate(vals, start=1):
        cum += i * v
    return (2.0 * cum) / (n * total) - (n + 1.0) / n


def imbalance(values) -> Optional[float]:
    vals = [float(v) for v in values]
    if not vals or sum(vals) <= 0:
        return None
    mean = sum(vals) / len(vals)
    return max(vals) / mean if mean > 0 else None


def _status(warn: bool) -> str:
    return "warn" if warn else "ok"


# -- indicators -------------------------------------------------------


def compute_indicators(run: RunData) -> dict:
    """The structured health block of ``diagnosis.json``. Every
    indicator degrades to ``{"status": "unknown"}`` when its inputs
    were not recorded (telemetry-off runs, non-join drivers) — a
    diagnosis must never crash on a sparse run."""
    return {
        "key_skew": _key_skew(run),
        "straggler": _straggler(run),
        "overflow_headroom": _overflow_headroom(run),
        "wire_efficiency": _wire_efficiency(run),
        "retry_ladder": _retry_ladder(run),
        "stage_split": _stage_split(run),
    }


def _key_skew(run: RunData) -> dict:
    m = run.metrics
    if not m or not m.get("per_rank"):
        return {"status": "unknown"}
    per_counter, worst = {}, ("", 0.0)
    for name in _SKEW_COUNTERS:
        vals = m["per_rank"].get(name)
        if not vals:
            continue
        g, imb = gini(vals), imbalance(vals)
        if g is None:
            continue
        per_counter[name] = {
            "gini": round(g, 4),
            "max_over_mean": round(imb, 4),
            "per_rank": [int(v) for v in vals],
        }
        if g > worst[1]:
            worst = (name, g)
    if not per_counter:
        return {"status": "unknown"}
    skewed = any(
        c["gini"] > SKEW_GINI_WARN
        or c["max_over_mean"] > SKEW_IMBALANCE_WARN
        for c in per_counter.values()
    )
    return {
        "status": _status(skewed),
        "counters": per_counter,
        "worst_counter": worst[0],
        "gini_warn_threshold": SKEW_GINI_WARN,
        "imbalance_warn_threshold": SKEW_IMBALANCE_WARN,
    }


def _straggler(run: RunData) -> dict:
    """max/mean of per-rank span seconds, per stage — needs >= 2 ranks
    WITH event files (a single-process CPU-mesh run has one log; its
    in-program imbalance shows up in key_skew instead)."""
    per_rank: dict = {}
    for ev in run.events:
        if ev.get("kind") != "span":
            continue
        name = ev.get("name")
        if name not in _STAGE_SPANS:
            continue
        per_rank.setdefault(name, {})
        r = ev.get("rank", 0)
        per_rank[name][r] = (per_rank[name].get(r, 0.0)
                             + ev.get("dur_us", 0.0) / 1e6)
    stages = {}
    for name, by_rank in per_rank.items():
        if len(by_rank) < 2:
            continue
        vals = list(by_rank.values())
        idx = imbalance(vals)
        if idx is None:
            continue
        stages[name] = {
            "straggler_index": round(idx, 4),
            "per_rank_s": {str(r): round(s, 6)
                           for r, s in sorted(by_rank.items())},
        }
    if not stages:
        return {"status": "unknown",
                "note": "needs per-rank event logs from >= 2 processes"}
    worst = max(stages.values(), key=lambda s: s["straggler_index"])
    return {
        "status": _status(worst["straggler_index"] > STRAGGLER_WARN),
        "stages": stages,
        "warn_threshold": STRAGGLER_WARN,
    }


def _overflow_headroom(run: RunData) -> dict:
    m = run.metrics
    if not m or not m.get("reduced"):
        return {"status": "unknown"}
    red = m["reduced"]
    n = int(m.get("n_ranks", 0)) or 1
    sides, tight = {}, False
    for side in ("build", "probe"):
        margin = red.get(f"{side}.overflow_margin_min")
        rows = red.get(f"{side}.rows_shuffled")
        if margin is None:
            continue
        # Average rows per (sender, destination) bucket — the unit the
        # margin is measured against (shuffle.py's per-bucket clamp).
        avg_bucket = (rows / (n * n)) if rows else None
        ratio = (margin / avg_bucket
                 if avg_bucket and avg_bucket > 0 else None)
        low = bool(margin <= 0
                   or (ratio is not None and ratio < HEADROOM_RATIO_WARN))
        tight = tight or low
        sides[side] = {
            "margin_rows_min": int(margin),
            "avg_bucket_rows": (round(avg_bucket, 1)
                                if avg_bucket is not None else None),
            "headroom_ratio": (round(ratio, 4)
                               if ratio is not None else None),
            "low": low,
        }
    if not sides:
        return {"status": "unknown"}
    # Trend across successive metrics emissions (retried/batched runs
    # emit more than one metrics event).
    trend = [
        {s: ev["payload"]["reduced"].get(f"{s}.overflow_margin_min")
         for s in ("build", "probe")}
        for ev in run.events
        if ev.get("name") == "metrics"
        and isinstance(ev.get("payload"), dict)
        and isinstance(ev["payload"].get("reduced"), dict)
    ]
    return {
        "status": _status(tight),
        "sides": sides,
        "trend": trend if len(trend) > 1 else None,
        "warn_ratio_threshold": HEADROOM_RATIO_WARN,
    }


def _wire_efficiency(run: RunData) -> dict:
    """Actual wire bytes vs. the ideal payload. The ideal row width
    comes from the record's dtypes when available; the codec/varwidth
    ledger (``wire_bytes_saved``) is always available from the
    counters themselves."""
    m = run.metrics
    if not m or not m.get("reduced"):
        return {"status": "unknown"}
    red = m["reduced"]
    row_bytes = _ideal_row_bytes(run.record)
    sides, inflated = {}, False
    for side in ("build", "probe"):
        wire = red.get(f"{side}.wire_bytes")
        rows = red.get(f"{side}.rows_shuffled")
        if not wire or not rows:
            continue
        saved = red.get(f"{side}.wire_bytes_saved", 0)
        entry = {
            "wire_bytes": int(wire),
            "bytes_per_row": round(wire / rows, 2),
            "saved_vs_fixed_width_bytes": int(saved),
            "varwidth_prefix_bytes":
                int(red.get(f"{side}.varwidth_bytes", 0)),
        }
        if row_bytes:
            eff = (rows * row_bytes) / wire
            entry["ideal_row_bytes"] = row_bytes
            entry["efficiency"] = round(eff, 4)
            if eff < WIRE_EFFICIENCY_WARN:
                entry["inflated"] = True
                inflated = True
        sides[side] = entry
    if not sides:
        return {"status": "unknown"}
    return {
        "status": _status(inflated),
        "sides": sides,
        "shuffle_mode": (run.record or {}).get("shuffle"),
        "warn_efficiency_threshold": WIRE_EFFICIENCY_WARN,
    }


_DTYPE_BYTES = {"int32": 4, "int64": 8, "float32": 4, "float64": 8}


def _ideal_row_bytes(record: Optional[dict]) -> Optional[int]:
    """Fixed row width on the wire for the generator drivers' simple
    schema (one key + one payload column, possibly composite). String
    payloads are varwidth — the counters' own ledger covers those."""
    if not record or record.get("string_payload_bytes") or \
            record.get("string_key_bytes"):
        return None
    kb = _DTYPE_BYTES.get(record.get("key_type", ""))
    pb = _DTYPE_BYTES.get(record.get("payload_type", ""))
    if kb is None or pb is None:
        return None
    return kb * max(int(record.get("key_columns", 1) or 1), 1) + pb


def _retry_ladder(run: RunData) -> dict:
    attempts = [ev["payload"] for ev in run.events
                if ev.get("name") == "retry_attempt"
                and isinstance(ev.get("payload"), dict)]
    red = (run.metrics or {}).get("reduced", {})
    attempt_max = red.get("retry_attempt_max")
    if not attempts and attempt_max in (None, 0):
        return {"status": "ok", "n_attempts": 1 if red else None,
                "escalations": 0}
    overflowed = [a for a in attempts if a.get("overflow")]
    final = attempts[-1] if attempts else None
    return {
        "status": _status(bool(overflowed) or bool(attempt_max)),
        "n_attempts": len(attempts) or (
            attempt_max + 1 if attempt_max is not None else None),
        "escalations": len(overflowed),
        "resolved": (not final.get("overflow")) if final else None,
        "final_sizing": {
            k: final[k] for k in (
                "shuffle_capacity_factor", "out_capacity_factor",
                "out_rows_per_rank", "compression_bits",
                "hh_probe_capacity", "hh_out_capacity",
            ) if final and final.get(k) is not None
        } if final else None,
    }


def _stage_split(run: RunData) -> dict:
    """Host-visible span totals (from the rank-0 summary): where the
    run's wall time went. Spans inside the compiled step time tracing,
    not execution (docs/OBSERVABILITY.md) — this is the HOST split;
    the device split needs ``--trace``'s device trace."""
    if not run.summary or not run.summary.get("spans"):
        return {"status": "unknown"}
    spans = {path: {"count": st.get("count"),
                    "total_s": round(st.get("total_s", 0.0), 6)}
             for path, st in sorted(run.summary["spans"].items())}
    return {"status": "info", "spans": spans}


# -- recommendations --------------------------------------------------


def recommend(indicators: dict, run: RunData) -> list:
    """Map warning indicators to the concrete knobs that relieve them.
    Every entry names the flag (driver CLI) and the module owning the
    mechanism, so the reader can go from symptom to code."""
    recs = []
    rec = run.record or {}

    skew = indicators["key_skew"]
    if skew.get("status") == "warn":
        already_skew = bool(
            (run.metrics or {}).get("reduced", {}).get("skew.hh_matches")
        ) or rec.get("skew_threshold")
        worst = skew.get("worst_counter", "")
        detail = skew["counters"].get(worst, {})
        if already_skew:
            recs.append({
                "id": "skew_widen_hh",
                "severity": "warn",
                "knob": "hh_slots / hh capacities",
                "flags": ["--hh-slots 128", "--hh-probe-capacity",
                          "--hh-out-capacity"],
                "module": "parallel/skew.py",
                "message": (
                    f"per-rank {worst} still imbalanced (gini="
                    f"{detail.get('gini')}) with the PRPD skew path "
                    "already on — widen the heavy-hitter set "
                    "(--hh-slots) and its capacities so more hot keys "
                    "leave the hashed shuffle."),
            })
        else:
            recs.append({
                "id": "skew_enable_prpd",
                "severity": "warn",
                "knob": "skew_threshold",
                "flags": ["--skew-threshold 0.001"],
                "module": "parallel/skew.py",
                "message": (
                    f"per-rank {worst} is key-skewed (gini="
                    f"{detail.get('gini')}, max/mean="
                    f"{detail.get('max_over_mean')}): enable the PRPD "
                    "heavy-hitter path (--skew-threshold 0.001; "
                    "--hh-slots/--hh-probe-capacity/--hh-out-capacity "
                    "size its static blocks) so hot keys stay on their "
                    "generating rank instead of overloading one "
                    "receiver."),
            })

    head = indicators["overflow_headroom"]
    if head.get("status") == "warn":
        factor = rec.get("shuffle_capacity_factor") or 1.6
        tight_sides = [s for s, d in head["sides"].items() if d["low"]]
        recs.append({
            "id": "shuffle_headroom",
            "severity": "warn",
            "knob": "shuffle_capacity_factor",
            "flags": [f"--shuffle-capacity-factor {factor * 1.5:g}"],
            "module": "parallel/distributed_join.py",
            "message": (
                f"{'/'.join(tight_sides)} shuffle buckets are within "
                f"{HEADROOM_RATIO_WARN:.0%} of overflow (tightest "
                "margin "
                + ", ".join(
                    f"{s}={head['sides'][s]['margin_rows_min']} rows"
                    for s in tight_sides)
                + ") — raise --shuffle-capacity-factor before the "
                "next data drift trips auto_retry's recompile."),
        })

    retry = indicators["retry_ladder"]
    if retry.get("status") == "warn":
        sizing = retry.get("final_sizing") or {}
        flags = [f"--{k.replace('_', '-')} {v:g}" for k, v in
                 sizing.items()
                 if k in ("shuffle_capacity_factor",
                          "out_capacity_factor")]
        recs.append({
            "id": "bake_retry_sizing",
            "severity": "warn",
            "knob": "out_capacity_factor / shuffle_capacity_factor",
            "flags": flags or ["--out-capacity-factor",
                               "--shuffle-capacity-factor"],
            "module": "parallel/faults.py (CapacityLadder)",
            "message": (
                f"the run paid {retry.get('escalations', 0)} overflow "
                "recompile(s) on the capacity ladder — start from the "
                "final rung's sizing so production runs compile once."),
        })

    wire = indicators["wire_efficiency"]
    if wire.get("status") == "warn":
        recs.append({
            "id": "ragged_wire",
            "severity": "warn",
            "knob": "shuffle",
            "flags": ["--shuffle ragged"],
            "module": "parallel/shuffle.py",
            "message": (
                "wire bytes are dominated by static-capacity padding "
                "(efficiency "
                + ", ".join(
                    f"{s}={d.get('efficiency')}"
                    for s, d in wire["sides"].items()
                    if "efficiency" in d)
                + ") — the exact-size ragged exchange ships only real "
                "rows."),
        })

    strag = indicators["straggler"]
    if strag.get("status") == "warn":
        worst_stage = max(strag["stages"].items(),
                          key=lambda kv: kv[1]["straggler_index"])
        recs.append({
            "id": "over_decompose",
            "severity": "warn",
            "knob": "over_decomposition",
            "flags": ["--over-decomposition-factor 4"],
            "module": "parallel/distributed_join.py",
            "message": (
                f"stage '{worst_stage[0]}' has a straggler (max/mean "
                f"= {worst_stage[1]['straggler_index']}) — over-"
                "decompose so each rank's work splits into more, "
                "smaller batches that interleave around the slow "
                "rank."),
        })
    return recs


# -- diagnosis --------------------------------------------------------


def diagnose(run: RunData) -> dict:
    indicators = compute_indicators(run)
    recs = recommend(indicators, run)
    sig = baselines.counter_signature(run.metrics)
    status = ("warn" if any(i.get("status") == "warn"
                            for i in indicators.values()) else "ok")
    return {
        "schema_version": DIAGNOSIS_SCHEMA_VERSION,
        "run_dir": run.run_dir,
        "ranks_seen": run.ranks_seen,
        "n_events": len(run.events),
        "malformed_lines": run.malformed_lines,
        "status": status,
        "indicators": indicators,
        "recommendations": recs,
        "signature": sig,
    }


def diagnose_run(run_dir: str, record=None, *, write: bool = True,
                 print_report: bool = False) -> dict:
    """Load, diagnose, write ``<run_dir>/diagnosis.json`` (atomic,
    rank-0 caller's job), optionally print the human report. The
    drivers' ``--diagnose`` entry point."""
    run = load_run(run_dir, record=record)
    diag = diagnose(run)
    if write:
        tmp = os.path.join(run_dir, "diagnosis.json.tmp")
        with open(tmp, "w") as f:
            json.dump(diag, f, indent=1)
            f.write("\n")
        os.replace(tmp, os.path.join(run_dir, "diagnosis.json"))
    if print_report:
        print(format_report(diag))
    return diag


def format_report(diag: dict) -> str:
    """The human-readable rendering of a diagnosis."""
    lines = [
        f"run: {diag['run_dir']}  "
        f"[{diag['status'].upper()}]  ranks={diag['ranks_seen']}  "
        f"events={diag['n_events']}",
    ]
    ind = diag["indicators"]

    def head(title, block):
        lines.append(f"  {title:<18} {block.get('status', '?')}")

    skew = ind["key_skew"]
    head("key skew", skew)
    for name, c in (skew.get("counters") or {}).items():
        lines.append(f"    {name}: gini={c['gini']} "
                     f"max/mean={c['max_over_mean']}")
    strag = ind["straggler"]
    head("stragglers", strag)
    for name, s in (strag.get("stages") or {}).items():
        lines.append(f"    {name}: max/mean="
                     f"{s['straggler_index']}")
    headr = ind["overflow_headroom"]
    head("overflow headroom", headr)
    for side, d in (headr.get("sides") or {}).items():
        lines.append(
            f"    {side}: margin_min={d['margin_rows_min']} rows"
            + (f" ({d['headroom_ratio']:.0%} of avg bucket)"
               if d.get("headroom_ratio") is not None else ""))
    wire = ind["wire_efficiency"]
    head("wire efficiency", wire)
    for side, d in (wire.get("sides") or {}).items():
        lines.append(
            f"    {side}: {d['wire_bytes']} B "
            f"({d['bytes_per_row']} B/row"
            + (f", efficiency={d['efficiency']}"
               if "efficiency" in d else "")
            + (f", saved={d['saved_vs_fixed_width_bytes']} B"
               if d.get("saved_vs_fixed_width_bytes") else "") + ")")
    retry = ind["retry_ladder"]
    head("retry ladder", retry)
    if retry.get("escalations"):
        lines.append(f"    {retry['n_attempts']} attempts, "
                     f"{retry['escalations']} overflowed; final "
                     f"sizing {retry.get('final_sizing')}")
    split = ind["stage_split"]
    if split.get("spans"):
        lines.append("  host stage split (s):")
        for path, st in split["spans"].items():
            lines.append(f"    {path:<28} {st['total_s']:>10.4f} "
                         f"x{st['count']}")
    if diag["recommendations"]:
        lines.append("  recommendations:")
        for r in diag["recommendations"]:
            lines.append(f"    [{r['id']}] {r['message']}")
            lines.append(f"      knob: {' '.join(r['flags'])}  "
                         f"({r['module']})")
    else:
        lines.append("  no action needed — balanced run, headroom ok")
    return "\n".join(lines)


# -- explain grading (EXPLAIN ANALYZE: prediction vs measurement) -----


def grade_explain(explain: dict, metrics: Optional[dict],
                  record: Optional[dict]) -> dict:
    """Join a plan's predictions (``explain.json``,
    ``planning.JoinPlan.explain_record()``) to a run's MEASURED
    device counters and wall time — the read side of EXPLAIN ANALYZE.

    Wire bytes and shuffled rows compare against the ``Metrics``
    reduced counters; wall time against the record's
    ``elapsed_per_join_s``. For padded/compressed plans the wire
    prediction is EXACT by construction (static blocks), so any
    mismatch is a bug in the plan or the tape — the
    ``--gate-wire-bytes`` CI gate fails on it. Wall ratios are
    honest model error (and meaningless on the CPU, whose ranks are
    emulated: the prediction models the H100's roofline)."""
    plan = explain.get("plan") or {}
    cost = explain.get("cost") or {}
    wire = plan.get("wire") or {}
    # metrics may be a Metrics.to_dict() block ("reduced") or a
    # counter-signature body ("counters") — same keyspace either way.
    red = ((metrics or {}).get("reduced")
           or (metrics or {}).get("counters") or {})
    out: dict = {
        "plan_digest": plan.get("signature_digest"),
        "pipeline": plan.get("pipeline"),
        "wire_exact": wire.get("exact"),
        "wire": {},
        "rows": {},
        "wall": None,
        "predicted_stages": cost.get("stages"),
    }
    exact = bool(wire.get("exact"))
    n_ranks = int(plan.get("n_ranks") or 0)
    # Aggregation-pushdown plans (pipeline "join_agg") add the
    # groups-sized partials exchange as its own gated side — exact in
    # padded mode like build/probe (docs/AGGREGATION.md).
    sides = ("build", "probe", "partials") if "partials" in wire \
        else ("build", "probe")
    for side in sides:
        pred = (wire.get(side) or {}).get("bytes_total")
        meas = red.get(f"{side}.wire_bytes")
        if pred is not None and meas is not None:
            entry = {
                "predicted_bytes": int(pred),
                "measured_bytes": int(meas),
                "error_ratio": (round(meas / pred, 6) if pred
                                else None),
            }
            # Hierarchical plans carry per-tier predictions
            # (ici/dcn_bytes_per_rank) next to per-tier counters
            # (wire_bytes_ici/_dcn) — each tier is gated exactly on
            # its own, and a tier mismatch fails the side's verdict
            # (the --gate-wire-bytes CI gate reads only "match").
            tiers = {}
            for tier in ("ici", "dcn"):
                pred_rank = (wire.get(side) or {}).get(
                    f"{tier}_bytes_per_rank")
                meas_t = red.get(f"{side}.wire_bytes_{tier}")
                if pred_rank is None or meas_t is None:
                    continue
                pred_t = int(pred_rank) * n_ranks
                tiers[tier] = {
                    "predicted_bytes": pred_t,
                    "measured_bytes": int(meas_t),
                    "match": pred_t == int(meas_t),
                }
            if tiers:
                entry["tiers"] = tiers
            if exact:
                entry["match"] = (int(pred) == int(meas)
                                  and all(t["match"]
                                          for t in tiers.values()))
            else:
                # Estimate-only plans (ragged) are graded, not
                # pass/failed: an exact-equality verdict on an upper
                # bound would read every run as MISMATCH.
                entry["estimate"] = True
            out["wire"][side] = entry
        prows = (wire.get(side) or {}).get("rows_estimate")
        mrows = red.get(f"{side}.rows_shuffled")
        if prows is not None and mrows is not None:
            out["rows"][side] = {
                "predicted_rows": int(prows),
                "measured_rows": int(mrows),
                "error_ratio": (round(mrows / prows, 6) if prows
                                else None),
            }
    wall = baselines.wall_time_of(record)
    predicted_wall = cost.get("total_s")
    if wall and predicted_wall:
        out["wall"] = {
            "predicted_s": predicted_wall,
            "measured_s": wall,
            # measured / predicted: >1 = the model was optimistic.
            "ratio": round(wall / predicted_wall, 4),
        }
    return out


def grade_queryplan(doc: dict, record: Optional[dict]) -> dict:
    """EXPLAIN ANALYZE for a multi-operator plan (docs/QUERY.md):
    join the queryplan artifact's per-operator wire predictions to
    the driver's measured per-operator counters (the ``wire`` list
    of a ``--query`` record) and surface the join-order candidates
    the cost model priced. With no record the predictions render
    ungraded."""
    meas = {}
    if record is not None:
        for entry in record.get("wire") or []:
            meas[entry.get("id")] = entry
    # Per-operator measured WALLS: the record's embedded
    # query-stage-profile summary (stageprof.profile_query_stages —
    # wall_s keyed by op_id), when the driver ran --stage-profile.
    sp = (record or {}).get("stage_profile") or {}
    sp_walls = sp.get("wall_s") if isinstance(sp, dict) else None
    sp_walls = sp_walls if isinstance(sp_walls, dict) else {}
    ops = []
    gated = record is not None
    exact = True
    for orec in doc.get("operators") or []:
        entry = {
            "id": orec.get("id"),
            "join_type": orec.get("join_type"),
            "aggregate": bool(orec.get("aggregate")),
            "wire": {},
        }
        m = meas.get(orec.get("id")) or {}
        for side in ("build", "probe"):
            pred = int(((orec.get("wire") or {}).get(side) or {})
                       .get("bytes_total", 0))
            e = {"predicted_bytes": pred}
            if side in m:
                mb = int(m[side]["measured_bytes"])
                e["measured_bytes"] = mb
                e["match"] = pred == mb
                exact &= pred == mb
            entry["wire"][side] = e
        w = sp_walls.get(orec.get("id"))
        if w is not None:
            pred_s = (orec.get("cost") or {}).get("total_s")
            entry["wall"] = {
                "predicted_s": pred_s,
                "measured_s": w,
                "ratio": (round(float(w) / float(pred_s), 6)
                          if pred_s else None),
            }
        ops.append(entry)
    grade = {
        "kind": "queryplan_grade",
        "plan_digest": doc.get("digest"),
        "n_operators": doc.get("n_operators"),
        "total_s": doc.get("total_s"),
        "operators": ops,
        "orders": doc.get("orders"),
        "wire_match": (exact if gated else None),
    }
    if sp_walls:
        grade["walls"] = {
            "sum_of_operators_s": sp.get("sum_of_stages_s"),
            "monolithic_wall_s": sp.get("monolithic_wall_s"),
            "overlap_fraction": sp.get("overlap_fraction"),
        }
    return grade


def format_queryplan_grade(grade: dict) -> str:
    lines = [f"queryplan {str(grade.get('plan_digest'))[:16]}  "
             f"{grade.get('n_operators')} operators, predicted "
             f"{grade.get('total_s')} s"]
    for op in grade.get("operators") or []:
        tag = f"{op['id']} [{op['join_type']}" + \
            ("+agg]" if op.get("aggregate") else "]")
        parts = []
        for side, d in sorted(op["wire"].items()):
            if "measured_bytes" in d:
                verdict = ("MATCH" if d["match"] else
                           f"MISMATCH ({d['measured_bytes']} B "
                           "measured)")
                parts.append(f"{side} {d['predicted_bytes']} B "
                             f"-> {verdict}")
            else:
                parts.append(f"{side} {d['predicted_bytes']} B")
        w = op.get("wall")
        if w:
            ratio = (f" -> x{w['ratio']:.3g}"
                     if w.get("ratio") is not None else "")
            pred = (f"{w['predicted_s']:.6g}s"
                    if w.get("predicted_s") is not None else "?")
            parts.append(f"wall {pred} predicted, "
                         f"{w['measured_s']:.6g}s measured{ratio}")
        lines.append(f"  {tag}: " + ", ".join(parts))
    walls = grade.get("walls")
    if walls:
        frac = walls.get("overlap_fraction")
        lines.append(
            f"  operator walls: sum {walls.get('sum_of_operators_s')}s"
            f" vs monolithic {walls.get('monolithic_wall_s')}s"
            + (f" ({frac:.1%} overlapped)" if frac is not None
               else ""))
    orders = grade.get("orders") or []
    if orders:
        lines.append("  join orders priced:")
        for o in orders:
            marks = "".join(
                [" <- chosen" if o.get("chosen") else "",
                 " (cheapest)" if o.get("cheapest") else ""])
            total = o.get("total_s")
            cost = (f"{total} s" if total is not None
                    else str(o.get("note")))
            lines.append(
                f"    {' -> '.join(o.get('tables', []))}: "
                f"{cost}{marks}")
    if grade.get("wire_match") is not None:
        lines.append("  wire prediction: "
                     + ("EXACT" if grade["wire_match"]
                        else "MISMATCH"))
    return "\n".join(lines)


def format_explain_grade(grade: dict) -> str:
    lines = [f"explain {str(grade.get('plan_digest'))[:16]} "
             f"[{grade.get('pipeline')}]  wire prediction: "
             + ("EXACT" if grade.get("wire_exact") else "estimate")]
    for side, d in sorted(grade["wire"].items()):
        if d.get("estimate"):
            verdict = f"ESTIMATE x{d['error_ratio']}"
        else:
            verdict = ("MATCH" if d["match"]
                       else f"MISMATCH x{d['error_ratio']}")
        lines.append(
            f"  wire {side}: predicted {d['predicted_bytes']} B, "
            f"measured {d['measured_bytes']} B -> {verdict}")
        for tier, t in sorted((d.get("tiers") or {}).items()):
            lines.append(
                f"    {tier}: predicted {t['predicted_bytes']} B, "
                f"measured {t['measured_bytes']} B -> "
                + ("MATCH" if t["match"] else "MISMATCH"))
    for side, d in sorted(grade["rows"].items()):
        lines.append(
            f"  rows {side}: predicted {d['predicted_rows']}, "
            f"measured {d['measured_rows']} "
            f"(x{d['error_ratio']})")
    w = grade.get("wall")
    if w:
        lines.append(
            f"  wall: predicted {w['predicted_s']}s (H100 roofline), "
            f"measured {w['measured_s']:.6g}s -> x{w['ratio']} "
            "(CPU walls measure emulated ranks, not the model)")
    st = grade.get("predicted_stages")
    if st:
        lines.append("  predicted stage split (s): "
                     + "  ".join(f"{k}={v}"
                                 for k, v in sorted(st.items())))
    return "\n".join(lines)


# -- stage-profile grading (measured per-stage walls vs the model) ----


def grade_stages(profile: dict) -> dict:
    """Grade a ``stageprofile.json`` (``telemetry/stageprof.py``):
    per-stage predicted-vs-measured ratios, the overlap credit, and
    the worst-mispredicted stage with the cost constants it owns
    (``planning.cost.STAGE_CONSTANTS``) — the read side of the
    per-constant calibration loop."""
    import math

    from distributed_join_tpu_torch.planning.cost import STAGE_CONSTANTS

    stages = profile.get("stages") or {}
    graded = {}
    worst = (None, 0.0)
    ordered = [s for s in _STAGEPROFILE_STAGES if s in stages] + \
        sorted(s for s in stages if s not in _STAGEPROFILE_STAGES)
    for name in ordered:
        info = stages[name]
        if not isinstance(info, dict):
            continue
        entry = {
            "ran": bool(info.get("ran")),
            "wall_s": info.get("wall_s"),
            "predicted_s": info.get("predicted_s"),
            "ratio": info.get("ratio"),
            "constants": list(
                STAGE_CONSTANTS.get(name, {}).get("time", ())
            ) + list(STAGE_CONSTANTS.get(name, {}).get("bandwidth",
                                                       ())),
        }
        if info.get("ici"):
            entry["ici"] = info["ici"]
        graded[name] = entry
        ratio = info.get("ratio")
        if info.get("ran") and ratio:
            off = abs(math.log(float(ratio)))
            if off > worst[1]:
                worst = (name, off)
    return {
        "kind": "stages_grade",
        "plan_digest": profile.get("plan_digest"),
        "shuffle": profile.get("shuffle"),
        "n_ranks": profile.get("n_ranks"),
        "platform": profile.get("platform"),
        "overflow": profile.get("overflow"),
        "stages": graded,
        "sum_of_stages_s": profile.get("sum_of_stages_s"),
        "monolithic_wall_s": (profile.get("monolithic")
                              or {}).get("wall_s"),
        "overlap": profile.get("overlap"),
        "worst_stage": worst[0],
        "worst_constants": (graded.get(worst[0], {}).get("constants")
                            if worst[0] else None),
    }


def format_stages(profile: dict) -> str:
    """Human rendering of a stage-profile ARTIFACT: the shared
    renderer (``stageprof.format_stage_record`` — the same lines the
    driver prints) plus the grade's worst-mispredicted verdict."""
    from distributed_join_tpu_torch.telemetry.stageprof import (
        format_stage_record,
    )

    grade = grade_stages(profile)
    return format_stage_record(
        profile, worst_stage=grade.get("worst_stage"),
        worst_constants=grade.get("worst_constants"))


# -- schema checks (the perfgate lane's artifact validation) ----------

_SUMMARY_REQUIRED = ("telemetry_format_version", "rank", "counters",
                     "spans", "events")
_DIAGNOSIS_REQUIRED = ("schema_version", "status", "indicators",
                       "recommendations", "signature")
_BASELINE_REQUIRED = ("name", "signature")
_FLIGHTRECORDER_REQUIRED = ("schema_version", "kind", "reason",
                            "capacity", "recorded_total", "records")
_EXPLAIN_REQUIRED = ("schema_version", "kind", "plan", "cost")
_EXPLAIN_PLAN_REQUIRED = ("pipeline", "signature_digest", "wire")
_EXPLAIN_COST_REQUIRED = ("stages", "total_s")
_STAGEPROFILE_REQUIRED = ("schema_version", "kind", "plan_digest",
                          "stages", "sum_of_stages_s", "monolithic",
                          "overlap")


def _sniff_history_lines(path: str) -> bool:
    """Whether a non-``.jsonl``-named file is a workload-history store
    (one JSON object per line, each stamped ``kind: request|run``)."""
    try:
        with open(path) as f:
            first = f.readline()
        doc = json.loads(first)
    except (OSError, ValueError):
        return False
    return isinstance(doc, dict) and doc.get("kind") in (
        "request", "run", "rollup")


def check_file(path: str) -> list:
    """Validate one telemetry artifact by shape; returns a list of
    problems (empty = valid). Hand-rolled on purpose: no jsonschema
    dependency in this container."""
    problems = []
    history_file = os.path.basename(path) == "history.jsonl"
    try:
        if not path.endswith(".jsonl") and _sniff_history_lines(path):
            # --history FILE accepts any filename; a line-JSON store
            # whose first entry carries a history kind stamp is
            # validated as JSONL, not as one document.
            history_file = True
        if history_file or path.endswith(".jsonl"):
            torn = []   # (line_no, error) of unparseable lines
            with open(path) as f:
                lines = [(i, ln) for i, ln in enumerate(f, 1)
                         if ln.strip()]
            for i, line in lines:
                try:
                    ev = json.loads(line)
                except ValueError as exc:
                    torn.append((i, exc))
                    continue
                kind = ev.get("kind")
                if kind == "rollup":
                    # Compaction summary line (history.WorkloadHistory
                    # with --history-max-entries): per-signature
                    # aggregate of rolled-up entries.
                    for key in ("schema_version", "signature",
                                "entries"):
                        if key not in ev:
                            problems.append(
                                f"line {i}: rollup entry missing "
                                f"{key!r}")
                elif history_file or kind in ("request", "run"):
                    # Workload-history lines (telemetry/history.py):
                    # recognized by basename OR by their own kind
                    # stamp (the --history flag accepts any filename).
                    # Each carries the fields the autotuner's
                    # summarizer keys on.
                    for key in ("schema_version", "signature",
                                "outcome", "op"):
                        if key not in ev:
                            problems.append(
                                f"line {i}: history entry missing "
                                f"{key!r}")
                    # Resident stamp (service/resident.py): requests
                    # served against a registered build table carry
                    # the handle + generation they dispatched under
                    # (None = a cold full join).
                    res_stamp = ev.get("resident")
                    if res_stamp is not None:
                        if not isinstance(res_stamp, dict) or not \
                                {"table", "generation"} <= \
                                set(res_stamp):
                            problems.append(
                                f"line {i}: resident stamp missing "
                                "table/generation keys")
                    # Aggregation-pushdown stamp (history.
                    # request_entry / run_entry): fused-pipeline
                    # entries carry the spec shape; None = a
                    # materializing join.
                    agg_stamp = ev.get("aggregate")
                    if agg_stamp is not None:
                        if not isinstance(agg_stamp, dict) or not \
                                {"group_keys", "aggs"} <= \
                                set(agg_stamp):
                            problems.append(
                                f"line {i}: aggregate stamp missing "
                                "group_keys/aggs keys")
                    # Fleet stamp (service/fleet.py): router-side
                    # entries carry the serving replica's index and
                    # generation (None = single-daemon traffic).
                    rep_stamp = ev.get("replica")
                    if rep_stamp is not None:
                        if not isinstance(rep_stamp, dict) or not \
                                {"index", "generation"} <= \
                                set(rep_stamp):
                            problems.append(
                                f"line {i}: replica stamp missing "
                                "index/generation keys")
                    # Tenant stamp (telemetry/history.py): entries
                    # from a named non-default tenant carry it;
                    # default-tenant entries omit it (byte-identical
                    # to the pre-tenant format).
                    ten_stamp = ev.get("tenant")
                    if ten_stamp is not None and \
                            not isinstance(ten_stamp, str):
                        problems.append(
                            f"line {i}: tenant stamp is not a "
                            "string")
                elif kind not in ("event", "span"):
                    problems.append(f"line {i}: bad kind {kind!r}")
            # A torn FINAL line is the advertised killed-run artifact
            # (export.py streams and a kill can land mid-write) —
            # tolerated, exactly as load_run tolerates it. Torn lines
            # anywhere else mean real corruption.
            for i, exc in torn:
                if not (lines and i == lines[-1][0]):
                    problems.append(f"line {i}: unparseable: {exc}")
            return problems
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as exc:
        return [f"unreadable: {exc}"]
    name = os.path.basename(path)
    if isinstance(doc, list) or "traceEvents" in doc or \
            name.startswith("trace."):
        # Chrome trace: JSON Object Format, or the equally valid JSON
        # Array Format (a bare list of events).
        evs = doc if isinstance(doc, list) else doc.get("traceEvents")
        if not isinstance(evs, list):
            return ["traceEvents is not a list"]
        for i, ev in enumerate(evs):
            if not isinstance(ev, dict) or \
                    not {"name", "ph", "ts", "pid"} <= set(ev):
                problems.append(f"traceEvents[{i}] missing required "
                                "Chrome-trace keys")
        return problems
    if name == "summary.json":
        required = _SUMMARY_REQUIRED
    elif name == "diagnosis.json":
        required = _DIAGNOSIS_REQUIRED
    elif name.startswith("queryplan") or \
            doc.get("kind") == "queryplan":
        # The multi-operator EXPLAIN artifact (planning/query.py
        # explain_query, docs/QUERY.md): the whole plan priced
        # operator by operator plus the join-order candidates.
        # Dispatched BEFORE the single-join explain branch so a
        # kind-stamped queryplan doc named explain.json still lands
        # here.
        for key in ("schema_version", "kind", "digest", "n_ranks",
                    "plan", "operators", "n_operators", "total_s",
                    "orders"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        ops = doc.get("operators")
        if isinstance(ops, list):
            for j, orec in enumerate(ops):
                for key in ("id", "build", "probe", "key",
                            "join_type", "out_capacity", "wire",
                            "cost"):
                    if not isinstance(orec, dict) or key not in orec:
                        problems.append(
                            f"operators[{j}] missing {key!r}")
        elif "operators" in doc:
            problems.append("operators is not a list")
        if "orders" in doc and not isinstance(doc["orders"], list):
            problems.append("orders is not a list")
        return problems
    elif name.startswith("query_smoke") or \
            doc.get("kind") == "query_smoke":
        # The tpch driver's --query record (docs/QUERY.md): the whole
        # plan graded end to end — oracle equality, warm traces, the
        # exact per-operator wire bytes — whose merged per-operator
        # counter signature the perfgate lane gates against
        # results/baselines/query_smoke.json.
        for key in ("kind", "n_ranks", "query", "plan_digest",
                    "n_operators", "groups", "oracle_equal",
                    "warm_new_traces", "wire_exact", "wire",
                    "counter_signature"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.endswith(".joinprog") or \
            doc.get("kind") == "join_program":
        # A program-cache disk entry (service/programs.py _entry_doc):
        # the signature it was built for, its digest, the backend it
        # binds to and the kernel binaries it launches.
        for key in ("kind", "schema_version", "digest", "signature",
                    "backend", "kernels"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if "digest" in doc and not (isinstance(doc["digest"], str)
                                    and doc["digest"]):
            problems.append("digest is not a non-empty string")
        for key in ("signature", "backend", "kernels"):
            if key in doc and not isinstance(doc[key], dict):
                problems.append(f"{key} is not an object")
        backend = doc.get("backend")
        if isinstance(backend, dict) and "device_type" not in backend:
            problems.append("backend missing 'device_type'")
        return problems
    elif name.startswith("explain") or doc.get("kind") == "explain":
        # The EXPLAIN artifact (planning/plan.py): a plan + cost
        # prediction pair, recognized by basename OR kind stamp.
        for key in _EXPLAIN_REQUIRED:
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if isinstance(doc.get("plan"), dict):
            for key in _EXPLAIN_PLAN_REQUIRED:
                if key not in doc["plan"]:
                    problems.append(f"plan missing {key!r}")
        elif "plan" in doc:
            problems.append("plan is not an object")
        if isinstance(doc.get("cost"), dict):
            for key in _EXPLAIN_COST_REQUIRED:
                if key not in doc["cost"]:
                    problems.append(f"cost missing {key!r}")
        elif "cost" in doc:
            problems.append("cost is not an object")
        return problems
    elif name.startswith("stageprofile") or \
            doc.get("kind") == "stageprofile":
        # The stage-segmented profiling artifact
        # (telemetry/stageprof.py), recognized by basename OR kind.
        for key in _STAGEPROFILE_REQUIRED:
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if isinstance(doc.get("stages"), dict):
            for sk in _STAGEPROFILE_STAGES:
                if sk not in doc["stages"]:
                    problems.append(f"stages missing {sk!r} (must "
                                    "match cost.predict's stage keys)")
        elif "stages" in doc:
            problems.append("stages is not an object")
        if isinstance(doc.get("monolithic"), dict) and \
                "wall_s" not in doc["monolithic"]:
            problems.append("monolithic missing 'wall_s'")
        return problems
    elif name.startswith("query_stageprofile") or \
            doc.get("kind") == "query_stageprofile":
        # The per-OPERATOR query profiling artifact
        # (telemetry/stageprof.py profile_query_stages): its own kind
        # — the join-stage contract's four fixed stage keys do not
        # apply; the stage keys here are the plan's op_ids, listed in
        # 'order'.
        for key in ("schema_version", "kind", "plan_digest",
                    "n_ranks", "n_operators", "repeats", "order",
                    "operators", "sum_of_operators_s", "monolithic",
                    "overlap"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        ops = doc.get("operators")
        if isinstance(ops, dict):
            for oid in doc.get("order") or []:
                if oid not in ops:
                    problems.append(
                        f"operators missing {oid!r} (every op in "
                        "'order' must have an entry)")
        elif "operators" in doc:
            problems.append("operators is not an object")
        if isinstance(doc.get("monolithic"), dict) and \
                "wall_s" not in doc["monolithic"]:
            problems.append("monolithic missing 'wall_s'")
        return problems
    elif name.startswith("tracing_smoke") or \
            doc.get("kind") == "tracing_smoke":
        # The tracing lane's acceptance record (service/fleet.py
        # run_tracing_smoke): one-trace failover continuity through a
        # scripted kill plus the merged fleet-timeline census, whose
        # deterministic counter signature the perfgate lane gates
        # against results/baselines/tracing_smoke.json.
        for key in ("kind", "n_ranks", "replicas", "root_trace_id",
                    "timeline_processes", "focus_trace_processes",
                    "timeline", "counter_signature"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.startswith("resident_drill") or \
            doc.get("kind") == "resident_drill":
        # The service smoke's resident A/B sub-record (register ->
        # probe-only vs cold full joins; service/server.py
        # run_smoke): carries the deterministic counter signature the
        # perfgate lane gates against results/baselines/
        # resident_smoke.json.
        for key in ("kind", "n_ranks", "counter_signature"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.startswith("agg_smoke") or doc.get("kind") == "agg_ab":
        # The join driver's --agg-ab sub-record (fused pushdown vs
        # materialize-then-host-group-by; docs/AGGREGATION.md):
        # carries the deterministic counter signature the perfgate
        # lane gates against results/baselines/agg_smoke.json.
        for key in ("kind", "n_ranks", "counter_signature", "spec"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.startswith("sortpath_smoke") or \
            doc.get("kind") == "sort_ab":
        # The join driver's --sort-ab sub-record (segmented vs flat
        # local sort; docs/ROOFLINE.md §9): carries the deterministic
        # segmented counter signature the perfgate lane gates against
        # results/baselines/sortpath_smoke.json.
        for key in ("kind", "n_ranks", "counter_signature",
                    "sort_segments"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.startswith("fleet_smoke") or \
            doc.get("kind") == "fleet_smoke":
        # The fleet router's CI smoke record (service/fleet.py
        # run_fleet_smoke): scripted-kill acceptance protocol whose
        # deterministic counter signature the perfgate lane gates
        # against results/baselines/fleet_smoke.json.
        for key in ("kind", "n_ranks", "replicas",
                    "counter_signature", "stats"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.startswith("fleet_ha_smoke") or \
            doc.get("kind") == "fleet_ha_smoke":
        # The fleet replication/HA CI smoke record (service/fleet.py
        # run_fleet_ha_smoke): K=2 resident table, scripted holder
        # kill with manifest rebuild, scripted router kill with lease
        # takeover; deterministic counter signature gated against
        # results/baselines/fleet_ha_smoke.json.
        for key in ("kind", "n_ranks", "replicas",
                    "table_replication", "counter_signature",
                    "rebuilds_total", "takeovers_total"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.endswith(".manifest.json") or \
            doc.get("kind") == "table_manifest":
        # A durable resident-table manifest (service/fleet.py,
        # docs/FAILURE_SEMANTICS.md "Replication & durability
        # contract"): the versioned register spec + ordered delta
        # specs a replacement holder replays to rebuild its image.
        for key in ("kind", "schema_version", "name", "generation",
                    "register", "deltas", "payload_digest"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("deltas"), list):
            problems.append("deltas is not a list")
        return problems
    elif name == "router_directory.json" or \
            doc.get("kind") == "router_directory":
        # The generation-fenced replica/table directory a standby
        # router adopts on takeover (service/fleet.py).
        for key in ("kind", "schema_version", "fence",
                    "tables", "replicas"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("tables"), dict):
            problems.append("tables is not an object")
        if not isinstance(doc.get("replicas"), list):
            problems.append("replicas is not a list")
        return problems
    elif name.startswith("fleet_soak") or \
            doc.get("kind") == "fleet_soak":
        # The fleet chaos soak summary (parallel/chaos.py --fleet):
        # one replica killed/hung/corrupted mid-soak, every
        # non-refused answer pandas-oracle-graded.
        for key in ("kind", "harness_seed", "fault", "trials",
                    "verdicts", "failures", "drain_replace"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("verdicts"), dict):
            problems.append("verdicts is not an object")
        return problems
    elif name.startswith("fleet_tenant_soak") or \
            doc.get("kind") == "fleet_tenant_soak":
        # The multi-tenant chaos soak summary (parallel/chaos.py
        # --tenants): a noisy tenant floods at a multiple of its
        # quota while a quiet tenant runs oracle-graded joins — the
        # quiet tenant's answers must stay exact with ZERO sheds and
        # its tuner namespace untouched.
        for key in ("kind", "harness_seed", "trials", "noisy",
                    "quiet", "failures"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        for side in ("noisy", "quiet"):
            block = doc.get(side)
            if block is not None and not isinstance(block, dict):
                problems.append(f"{side} is not an object")
        return problems
    elif name.startswith("fleet_autoscale") or \
            doc.get("kind") == "fleet_autoscale":
        # The signature-level autoscaler's decision log
        # (service/fleet.py autoscale_record): spawn/drain events
        # with the load figures that triggered them and, for spawns,
        # the pre-warm verification verdict.
        for key in ("kind", "schema_version", "enabled",
                    "spawns_total", "drains_total", "events"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        evs = doc.get("events")
        if not isinstance(evs, list):
            problems.append("events is not a list")
        else:
            for j, ev in enumerate(evs):
                if not isinstance(ev, dict) or \
                        not {"action", "replica", "reason"} <= \
                        set(ev):
                    problems.append(
                        f"events[{j}] missing required "
                        "action/replica/reason keys")
                elif ev["action"] not in ("spawn", "spawn_failed",
                                          "drain"):
                    problems.append(
                        f"events[{j}] bad action "
                        f"{ev['action']!r}")
        return problems
    elif name.startswith("fleet_tenant_smoke") or \
            doc.get("kind") == "fleet_tenant_smoke":
        # The fleet lane's two-tenant CI smoke record
        # (service/fleet.py run_tenant_smoke): quota refusal,
        # priority shed ordering, and an autoscale spawn whose fresh
        # replica must serve the hot signature warm.
        for key in ("kind", "n_ranks", "replicas",
                    "counter_signature", "tenants", "autoscale"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        sig = doc.get("counter_signature")
        if isinstance(sig, dict):
            if not isinstance(sig.get("counters"), dict):
                problems.append("counter_signature missing "
                                "'counters'")
        elif "counter_signature" in doc:
            problems.append("counter_signature is not an object")
        return problems
    elif name.startswith("fleet_timeline") or \
            doc.get("kind") == "fleet_timeline":
        # The merged fleet-timeline summary (telemetry/timeline.py
        # via `analyze timeline`): per-process inventory, trace
        # census, cross-process hop count, skew bound, critical
        # path. (The sibling .trace.json is a Chrome trace and lands
        # in the traceEvents branch above.)
        for key in ("schema_version", "kind", "processes",
                    "n_spans", "n_traces", "hops",
                    "skew_bound_us", "critical_path"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("processes"), list):
            problems.append("processes is not a list")
        if not isinstance(doc.get("critical_path"), list):
            problems.append("critical_path is not a list")
        return problems
    elif name == "flightrecorder.json" or \
            doc.get("kind") == "flightrecorder":
        # The daemon's postmortem ring (telemetry/live.py).
        for key in _FLIGHTRECORDER_REQUIRED:
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("records"), list):
            problems.append("records is not a list")
        else:
            for i, rec in enumerate(doc["records"]):
                if not isinstance(rec, dict) or \
                        not {"request_id", "op", "outcome"} <= set(rec):
                    problems.append(
                        f"records[{i}] missing required "
                        "request_id/op/outcome keys")
        return problems
    elif name.startswith("tuner") or doc.get("kind") == "tune":
        # The autotuner's decision snapshot (planning/tuner.py
        # summarize/`analyze tune`): per-signature recommendation
        # derived from the workload history.
        for key in ("schema_version", "kind", "history",
                    "n_signatures", "signatures"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("signatures"), dict):
            problems.append("signatures is not an object")
        return problems
    elif name == "router_lease.json" or \
            doc.get("kind") == "router_lease":
        # The HA router's fenced leadership lease (service/fleet.py
        # RouterLease): owner + epoch + TTL; a standby adopts the
        # directory only after winning this file.
        for key in ("kind", "owner", "epoch", "ttl_s",
                    "renewed_unix_s", "addr"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        return problems
    elif doc.get("kind") == "queryplan_grade":
        # `analyze queryplan` verdict: the committed queryplan golden
        # re-priced and diffed (operators, orders, wire agreement).
        for key in ("kind", "plan_digest", "n_operators", "total_s",
                    "operators", "orders", "wire_match"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("operators"), list):
            problems.append("operators is not a list")
        return problems
    elif doc.get("kind") == "stages_grade":
        # `analyze stages` verdict: a stageprofile graded against the
        # cost model's per-stage predictions.
        for key in ("kind", "plan_digest", "shuffle", "n_ranks",
                    "platform", "overflow", "stages",
                    "sum_of_stages_s", "monolithic_wall_s"):
            if key not in doc:
                problems.append(f"missing required key {key!r}")
        if not isinstance(doc.get("stages"), dict):
            problems.append("stages is not an object")
        return problems
    elif "signature" in doc:
        required = _BASELINE_REQUIRED
    else:
        return [f"unrecognized artifact (basename {name!r})"]
    for key in required:
        if key not in doc:
            problems.append(f"missing required key {key!r}")
    if name == "diagnosis.json" and not problems:
        for ind in ("key_skew", "straggler", "overflow_headroom",
                    "wire_efficiency", "retry_ladder"):
            if ind not in doc["indicators"]:
                problems.append(f"indicators missing {ind!r}")
    return problems


# -- CLI --------------------------------------------------------------


def _signature_source(path: str, record_path: Optional[str]):
    """Resolve a compare/diagnose SOURCE argument: a run directory, a
    driver record JSON, or a diagnosis.json. Returns (source_for_
    signature, record_dict_or_None)."""
    from distributed_join_tpu_torch.benchmarks import load_record

    record = load_record(record_path) if record_path else None
    if os.path.isdir(path):
        run = load_run(path, record=record)
        source = run.metrics
        if source is None:
            # No summary.json (non-rank-0 dir copy): fall back to a
            # previously written diagnosis's signature.
            dpath = os.path.join(path, "diagnosis.json")
            if os.path.exists(dpath):
                with open(dpath) as f:
                    source = json.load(f)
        return source, record if record is not None else run.record
    doc = load_record(path)
    return doc, record if record is not None else doc


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m distributed_join_tpu_torch.telemetry.analyze",
        description=__doc__.split("\n")[0],
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("diagnose",
                       help="analyze a run dir, write diagnosis.json, "
                            "print the report")
    d.add_argument("run_dir")
    d.add_argument("--record", default=None,
                   help="driver --json-output record for workload "
                        "context (v1 records accepted)")
    d.add_argument("--json", action="store_true",
                   help="print the diagnosis JSON instead of the "
                        "human report")

    r = sub.add_parser("report", help="print the report only "
                                      "(no diagnosis.json written)")
    r.add_argument("run_dir")
    r.add_argument("--record", default=None)

    c = sub.add_parser("compare",
                       help="gate a run's counter signature (and "
                            "banded wall time) against a baseline; "
                            "exit 2 on drift/regression")
    c.add_argument("source",
                   help="run dir, driver record JSON, or "
                        "diagnosis.json")
    c.add_argument("--baseline", required=True,
                   help="baseline name in the registry (or a path)")
    c.add_argument("--baseline-dir", default=None,
                   help=f"registry dir (default "
                        f"{baselines.DEFAULT_BASELINE_DIR})")
    c.add_argument("--record", default=None,
                   help="record JSON supplying the wall time when "
                        "source is a run dir")
    c.add_argument("--noise-band", type=float, default=None,
                   help="wall-time relative band (default: the "
                        "baseline's, else 0.25)")
    c.add_argument("--write", action="store_true",
                   help="write/update the baseline from this run "
                        "instead of gating")
    c.add_argument("--with-wall", action="store_true",
                   help="with --write: also store the record's wall "
                        "time (hardware sessions only)")
    c.add_argument("--note", default=None,
                   help="with --write: free-text provenance note")

    hs = sub.add_parser(
        "history",
        help="summarize a workload-history store (per-signature "
             "trends: runs, outcomes, wall times, escalations, "
             "resolved knobs)")
    hs.add_argument("path",
                    help="history.jsonl, or a directory containing it")
    hs.add_argument("--tenant", default=None,
                    help="summarize one tenant's entries only "
                         "('default' selects unstamped entries — "
                         "the default tenant omits its stamp)")
    hs.add_argument("--json", action="store_true",
                    help="print the summary JSON instead of the "
                         "human report")

    tn = sub.add_parser(
        "tune",
        help="dry-run the autotuner (planning/tuner.py) against a "
             "history store: per signature, the knobs a tuned run "
             "would dispatch with against the static plan, and why")
    tn.add_argument("path",
                    help="history.jsonl, or a directory containing it")
    tn.add_argument("--signature", default=None,
                    help="dry-run one workload signature only")
    tn.add_argument("--min-entries", type=int, default=1,
                    help="history entries a signature needs before "
                         "the tuner pre-sizes (default 1)")
    tn.add_argument("--json", action="store_true",
                    help="print the tune record JSON instead of the "
                         "human report")

    ex = sub.add_parser(
        "explain",
        help="EXPLAIN ANALYZE: grade an explain.json's predictions "
             "(wire bytes, rows, wall) against a run's measured "
             "counters; --gate-wire-bytes turns the padded-mode "
             "exact-byte prediction into a CI gate (exit 2 on "
             "mismatch)")
    ex.add_argument("explain", help="explain.json path")
    ex.add_argument("--run", default=None,
                    help="telemetry run dir supplying the measured "
                         "counters (summary.json)")
    ex.add_argument("--record", default=None,
                    help="driver --json-output record supplying "
                         "counters and/or the measured wall time")
    ex.add_argument("--json", action="store_true",
                    help="print the grade JSON instead of the human "
                         "report")
    ex.add_argument("--gate-wire-bytes", action="store_true",
                    help="fail (exit 2) unless every predicted wire "
                         "byte count EXACTLY equals the measured "
                         "counter; refuses (exit 1) on estimate-only "
                         "plans (ragged) — only static-block modes "
                         "are gateable")
    ex.add_argument("--no-gate", action="store_true",
                    help="grade only, never gate — overrides "
                         "--gate-wire-bytes (for wrappers that pass "
                         "the gate unconditionally): estimate-only "
                         "(ragged) plans grade rows/wall normally "
                         "with wire bytes labeled ESTIMATE instead "
                         "of refusing")

    st = sub.add_parser(
        "stages",
        help="grade a stage-segmented profile (stageprofile.json, "
             "telemetry/stageprof.py): measured per-stage walls vs "
             "the cost model's per-stage prediction, the measured "
             "overlap credit (sum-of-stages minus monolithic wall), "
             "per-stage ICI utilization, and the worst-mispredicted "
             "stage with the constants "
             "calibrate_from_stage_profile would refit")
    st.add_argument("profile", help="stageprofile.json path")
    st.add_argument("--json", action="store_true",
                    help="print the grade JSON instead of the human "
                         "report")

    tl = sub.add_parser(
        "timeline",
        help="merge per-process telemetry session dirs into ONE "
             "fleet timeline: a Perfetto trace with a track per "
             "process and flow arrows across wire hops, the focus "
             "trace's critical path, and a fleet_timeline.json "
             "summary artifact (telemetry/timeline.py, "
             "docs/OBSERVABILITY.md \"Distributed tracing\")")
    tl.add_argument("dirs", nargs="+",
                    help="telemetry session dirs (or explicit "
                         "events.rank*.jsonl streams), one per "
                         "process — router + every replica")
    tl.add_argument("--trace-id", default=None,
                    help="focus trace (default: the trace touching "
                         "the most processes)")
    tl.add_argument("--out", default=None,
                    help="output directory for fleet_timeline.json "
                         "+ fleet_timeline.trace.json (default: the "
                         "first DIR)")
    tl.add_argument("--json", action="store_true",
                    help="print the fleet_timeline record instead "
                         "of the human report")

    k = sub.add_parser("check",
                       help="shape-validate telemetry artifacts "
                            "(summary/diagnosis/baseline/trace/"
                            "explain/stageprofile/events); exit 1 on "
                            "any problem")
    k.add_argument("files", nargs="+")

    args = p.parse_args(argv)
    try:
        if args.cmd in ("diagnose", "report"):
            diag = diagnose_run(args.run_dir, record=args.record,
                                write=args.cmd == "diagnose",
                                print_report=not getattr(
                                    args, "json", False))
            if getattr(args, "json", False):
                print(json.dumps(diag, indent=1))
            return 0
        if args.cmd == "compare":
            source, record = _signature_source(args.source, args.record)
            if args.write:
                path = baselines.write_baseline(
                    args.baseline, source,
                    baseline_dir=args.baseline_dir, record=record,
                    with_wall=args.with_wall, note=args.note)
                print(f"baseline written: {path}")
                return 0
            baseline = baselines.load_baseline(args.baseline,
                                               args.baseline_dir)
            cmp = baselines.compare(baseline, source, record=record,
                                    noise_band=args.noise_band)
            print(cmp.format())
            return 0 if cmp.ok else 2
        if args.cmd == "history":
            # Lazy import: history imports this module's gini/
            # imbalance helpers lazily in the other direction.
            from distributed_join_tpu_torch.telemetry import history

            entries, malformed = history.load_history(args.path)
            if args.tenant is not None:
                # The default tenant omits its stamp (the pre-tenant
                # line format, byte-identical), so selecting it means
                # selecting the unstamped entries.
                if args.tenant == history.DEFAULT_TENANT:
                    entries = [e for e in entries
                               if e.get("tenant") is None]
                else:
                    entries = [e for e in entries
                               if e.get("tenant") == args.tenant]
            summary = history.summarize(entries)
            if args.tenant is not None:
                summary["tenant"] = args.tenant
            if malformed:
                summary["malformed_lines"] = malformed
            if args.json:
                print(json.dumps(summary, indent=1))
            else:
                print(history.format_summary(
                    summary, path=history.history_path(args.path)))
            return 0
        if args.cmd == "tune":
            from distributed_join_tpu_torch.planning.tuner import (
                JoinTuner,
                format_tune,
            )

            tuner = JoinTuner(args.path, min_entries=args.min_entries)
            record = tuner.dry_run(signature=args.signature)
            if args.json:
                print(json.dumps(record, indent=1))
            else:
                print(format_tune(record))
            return 0
        if args.cmd == "explain":
            with open(args.explain) as f:
                explain_doc = json.load(f)
            if explain_doc.get("kind") == "queryplan":
                # Multi-operator plans grade against the --query
                # record's per-operator wire list (docs/QUERY.md).
                record = None
                if args.record:
                    from distributed_join_tpu_torch.benchmarks import (
                        load_record,
                    )

                    record = load_record(args.record)
                grade = grade_queryplan(explain_doc, record)
                if args.json:
                    print(json.dumps(grade, indent=1))
                else:
                    print(format_queryplan_grade(grade))
                if args.gate_wire_bytes and not args.no_gate:
                    if grade.get("wire_match") is None:
                        print("error: --gate-wire-bytes needs a "
                              "--record with measured per-operator "
                              "wire counters (--query driver "
                              "record)", file=sys.stderr)
                        return 1
                    if not grade["wire_match"]:
                        print("wire-byte gate FAILED: a predicted "
                              "operator wire size diverged from "
                              "the measured counter",
                              file=sys.stderr)
                        return 2
                return 0
            metrics, record = None, None
            if args.run:
                run = load_run(args.run)
                metrics = run.metrics
            if args.record:
                from distributed_join_tpu_torch.benchmarks import load_record

                record = load_record(args.record)
                if metrics is None:
                    metrics = baselines._find_metrics(record)
            grade = grade_explain(explain_doc, metrics, record)
            if args.json:
                print(json.dumps(grade, indent=1))
            else:
                print(format_explain_grade(grade))
            if args.gate_wire_bytes and not args.no_gate:
                if not grade.get("wire_exact"):
                    print("error: --gate-wire-bytes needs an exact "
                          "(padded/compressed) plan; this plan's "
                          "wire prediction is an estimate",
                          file=sys.stderr)
                    return 1
                if not grade["wire"]:
                    print("error: no measured wire counters to gate "
                          "against (run with --telemetry)",
                          file=sys.stderr)
                    return 1
                if not all(d["match"] for d in
                           grade["wire"].values()):
                    return 2
            return 0
        if args.cmd == "stages":
            with open(args.profile) as f:
                profile = json.load(f)
            if profile.get("kind") != "stageprofile":
                print(f"error: {args.profile} is not a stageprofile "
                      "artifact (kind "
                      f"{profile.get('kind')!r})", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(grade_stages(profile), indent=1))
            else:
                print(format_stages(profile))
            return 0
        if args.cmd == "timeline":
            from distributed_join_tpu_torch.telemetry import (
                timeline as tl_mod,
            )

            asm = tl_mod.assemble(args.dirs,
                                  trace_id=args.trace_id)
            out_dir = args.out or (
                args.dirs[0] if os.path.isdir(args.dirs[0])
                else os.path.dirname(args.dirs[0]) or ".")
            os.makedirs(out_dir, exist_ok=True)
            trace_path = tl_mod.write_perfetto(
                asm, os.path.join(out_dir,
                                  "fleet_timeline.trace.json"))
            record = tl_mod.as_record(asm, trace_file=trace_path)
            rec_path = os.path.join(out_dir, "fleet_timeline.json")
            with open(rec_path, "w") as f:
                json.dump(record, f, indent=1)
            if args.json:
                print(json.dumps(record, indent=1))
            else:
                print(tl_mod.format_report(asm))
                print(f"\nwrote {rec_path}")
                print(f"wrote {trace_path} (load in "
                      "ui.perfetto.dev)")
            return 0
        if args.cmd == "check":
            bad = 0
            for path in args.files:
                problems = check_file(path)
                if problems:
                    bad += 1
                    for prob in problems:
                        print(f"{path}: {prob}")
                else:
                    print(f"{path}: OK")
            return 1 if bad else 0
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
