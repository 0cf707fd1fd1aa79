"""Workload-history store — the persisted per-workload diagnosis trail.

Port of ``distributed_join_tpu/telemetry/history.py`` (:59-850): the
same JSONL store, line for line, so a history file one package writes
the other reads and summarizes alike.

- :class:`WorkloadHistory` — an append-only ``history.jsonl`` (one JSON
  object per line, flushed per append, torn-tail tolerant), bounded by
  ``max_entries_per_signature``: past twice the bound the file compacts,
  keeping the newest N entries of each signature and rolling the older
  ones into one ``kind: "rollup"`` line;
- :func:`request_entry` — one serving request's line;
- :func:`run_entry` — one driver run's line (the drivers' ``--history
  FILE``);
- :func:`load_history`, :func:`trends_of`, :func:`summarize`,
  :func:`format_summary` — the read side: per-signature trends (runs,
  outcomes, wall quantiles, escalations, the last resolved knobs);
- :class:`SignatureTrend` — the one per-signature aggregate;
- :func:`tenant_key` and :class:`tenant_scope` — the tenant namespace of
  the trend keys.

A trend's ``prediction`` (:meth:`SignatureTrend.as_dict`) grades the
measured/predicted wall ratios of its entries against the port's cost
model's band (``planning/cost.DEFAULT_PREDICTION_BAND``); an entry's
``counter_signature`` and ``indicators`` come from the device metrics
block of the request when the metrics tape rode it.

Device-free: the store is files, and the summarizer runs anywhere.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional

from distributed_join_tpu_torch.telemetry import baselines
# the one definition of the skew statistics, as in the JAX package
# (its history imports them from analyze too)
from distributed_join_tpu_torch.telemetry.analyze import (  # noqa: F401
    gini,
    imbalance,
)

HISTORY_SCHEMA_VERSION = 1
HISTORY_FILENAME = "history.jsonl"

# Multi-tenancy (docs/FLEET.md "Multi-tenancy & autoscaling"): the
# tenant every un-stamped request belongs to. Default-tenant entries
# carry NO tenant field and key their trends by the bare signature —
# the exact pre-tenancy store, byte for byte.
DEFAULT_TENANT = "default"


def tenant_key(signature: Optional[str],
               tenant: Optional[str]) -> str:
    """THE one composition of the tenant-namespaced trend key shared
    by :func:`trends_of` and the JAX package's autotuner
    (``planning/tuner.py``): ``tenant/signature`` for a
    non-default tenant, the bare signature otherwise — so one
    tenant's poisoned or skewed history can never pre-size another
    tenant's programs, while tenant-free deployments keep their
    historical keys."""
    sig = signature or "?"
    if tenant is None or tenant == DEFAULT_TENANT:
        return sig
    return f"{tenant}/{sig}"


# The per-thread tenant scope: the wire handler installs the request's
# tenant here (like telemetry.request_scope installs the trace), so
# every accounting site on the request's thread — admission refusals,
# the _observe fan-out — stamps the same tenant without threading a
# parameter through every op signature. None = default tenant = the
# exact pre-tenancy records.
_TENANT_LOCAL = threading.local()


class tenant_scope:
    """Context manager installing ``tenant`` as the current thread's
    tenant (restores the previous value on exit; None is a valid
    scope — it masks an outer one)."""

    def __init__(self, tenant: Optional[str]):
        self.tenant = str(tenant) if tenant is not None else None
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TENANT_LOCAL, "tenant", None)
        _TENANT_LOCAL.tenant = self.tenant
        return self.tenant

    def __exit__(self, *exc):
        _TENANT_LOCAL.tenant = self._prev
        return False


def current_tenant() -> Optional[str]:
    return getattr(_TENANT_LOCAL, "tenant", None)

# Per-stage wall drift: the same workload signature's measured stage
# wall moving more than this factor across runs flags the trend (the
# per-stage analog of counter_drift — re-profile before trusting a
# stage-level calibration refit).
STAGE_DRIFT_RATIO = 2.0

# The resolved-knob fields worth persisting from a retry ladder's
# final rung (the values the autotuner would pre-size from).
_KNOB_FIELDS = (
    "shuffle_capacity_factor", "out_capacity_factor",
    "out_rows_per_rank", "compression_bits",
    "hh_build_capacity", "hh_probe_capacity", "hh_out_capacity",
)

# Driver-record keys that identify a WORKLOAD (not a measurement) —
# the basis of run_entry's signature hash. Public: maybe_history
# back-fills these from driver args when a failure record carries
# only its benchmark name.
WORKLOAD_KEYS = (
    "benchmark", "n_ranks", "build_table_nrows", "probe_table_nrows",
    "selectivity", "shuffle", "key_type", "payload_type",
    "key_columns", "over_decomposition_factor", "zipf_alpha",
    "skew_threshold", "string_payload_bytes", "string_key_bytes",
    "scale_factor", "nbytes", "slices", "dcn_codec", "agg",
    "sort_mode", "sort_segments",
)


def history_path(dir_or_file: str) -> str:
    """Resolve a history location: an EXISTING directory maps to its
    ``history.jsonl`` inside; anything else is taken verbatim as a
    file path (the ``--history FILE`` contract — a user-named file
    must never silently become a directory)."""
    if os.path.isdir(dir_or_file):
        return os.path.join(dir_or_file, HISTORY_FILENAME)
    return dir_or_file


class WorkloadHistory:
    """Append-only JSONL store. Thread-safe appends over one
    persistent line-buffered handle (the TelemetrySink log pattern:
    flushed per line, so a killed server keeps its history; no
    per-request open/close on the serving hot path).

    ``max_entries_per_signature`` (None = unbounded, the historical
    behavior) arms size-bounded compaction: when a signature
    accumulates more than 2N live entries the whole file is rewritten
    atomically keeping the newest N per signature plus one rolled-up
    ``kind: "rollup"`` summary line per signature (the dropped
    entries' counts/outcomes/escalations/last-resolved-knobs, merged
    into any prior rollup) — the per-signature trend the autotuner
    reads survives, the file stops growing."""

    def __init__(self, path: str,
                 max_entries_per_signature: Optional[int] = None):
        self.path = history_path(path)
        self.max_entries_per_signature = max_entries_per_signature
        self.compactions = 0
        self._lock = threading.Lock()
        self._f = None
        self._counts = None     # sig -> live (non-rollup) line count

    def _handle(self):
        if self._f is None or self._f.closed:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        return self._f

    def _load_counts_locked(self) -> dict:
        if self._counts is None:
            self._counts = {}
            if os.path.exists(self.path):
                entries, _ = load_history(self.path)
                for e in entries:
                    if e.get("kind") == "rollup":
                        continue
                    sig = tenant_key(e.get("signature"),
                                     e.get("tenant"))
                    self._counts[sig] = self._counts.get(sig, 0) + 1
        return self._counts

    def append(self, entry: dict) -> dict:
        entry = dict(entry)
        entry.setdefault("schema_version", HISTORY_SCHEMA_VERSION)
        line = json.dumps(entry, default=str)
        with self._lock:
            self._handle().write(line + "\n")
            bound = self.max_entries_per_signature
            if bound:
                counts = self._load_counts_locked()
                sig = tenant_key(entry.get("signature"),
                                 entry.get("tenant"))
                counts[sig] = counts.get(sig, 0) + 1
                if counts[sig] > 2 * bound:
                    self._compact_locked(bound)
        return entry

    def compact(self) -> None:
        """Force one compaction pass (normally automatic on append)."""
        if not self.max_entries_per_signature:
            return
        with self._lock:
            self._compact_locked(self.max_entries_per_signature)

    def _compact_locked(self, keep: int) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()
        entries, _ = load_history(self.path)
        # Grouped by the TENANT-NAMESPACED key: a rollup line carries
        # the composed key in its signature field (and no tenant
        # stamp), which tenant_key passes through unchanged — so a
        # compacted store's trends land under the same keys as its
        # live entries, and one tenant's flood can never compact away
        # another tenant's same-signature trail.
        by_sig: dict = {}        # key -> [entries], insertion-ordered
        for e in entries:
            by_sig.setdefault(
                tenant_key(e.get("signature"), e.get("tenant")),
                []).append(e)
        tmp = self.path + ".tmp"
        counts: dict = {}
        with open(tmp, "w") as f:
            for sig, sig_entries in by_sig.items():
                live = [e for e in sig_entries
                        if e.get("kind") != "rollup"]
                rolled = [e for e in sig_entries
                          if e.get("kind") == "rollup"]
                drop = live[:-keep] if len(live) > keep else []
                kept = live[-keep:] if len(live) > keep else live
                if drop or rolled:
                    trend = SignatureTrend()
                    for e in rolled + drop:
                        trend.add(e)
                    f.write(json.dumps(
                        _rollup_line(sig, trend), default=str) + "\n")
                for e in kept:
                    f.write(json.dumps(e, default=str) + "\n")
                counts[sig] = len(kept)
        os.replace(tmp, self.path)
        self._counts = counts
        self.compactions += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.close()


def _rollup_line(sig: str, trend: "SignatureTrend") -> dict:
    """One compacted summary line carrying everything the trend
    aggregation (and hence the autotuner) needs from the dropped
    entries. Wall-time quantiles and prediction ratios deliberately
    reflect only RETAINED entries after compaction (quantiles do not
    merge); counts, outcomes, escalations, and the last resolved
    sizing survive exactly."""
    return {
        "schema_version": HISTORY_SCHEMA_VERSION,
        "kind": "rollup",
        "signature": sig,
        "entries": trend.entries,
        "outcomes": dict(trend.outcomes),
        "ops": dict(trend.ops),
        "escalations": trend.escalations,
        "integrity_retries": trend.integrity_retries,
        "new_traces": trend.new_traces,
        "resolved_knobs_last": trend.resolved_knobs_last,
        "resolved_rung_last": trend.resolved_rung_last,
        "tuned_entries": trend.tuned_entries,
        "platform_last": trend.platform_last,
    }


# -- entry builders ---------------------------------------------------


def _resolved_knobs(retry_record: Optional[dict]) -> Optional[dict]:
    """The final rung's sizing from a ``RetryReport.as_record()`` dict
    (None = single clean attempt, no sizing drift to persist)."""
    if not retry_record or not retry_record.get("attempts"):
        return None
    final = retry_record["attempts"][-1]
    return {k: final[k] for k in _KNOB_FIELDS
            if final.get(k) is not None}


def retry_counts(retry_record: Optional[dict]) -> dict:
    attempts = (retry_record or {}).get("attempts") or []
    return {
        "n_attempts": max(len(attempts), 1),
        "escalations": sum(1 for a in attempts if a.get("overflow")),
        "integrity_retries": sum(
            1 for a in attempts
            if a.get("action") == "retry_integrity"),
    }


def resolved_rung(retry_record: Optional[dict],
                  tuned: Optional[dict] = None) -> int:
    """The absolute ladder rung the entry settled at: the final
    attempt's rung label when a retry trail exists (attempts carry
    absolute indices — a tuner-seeded ladder starts above 0), else
    the tuned base rung, else 0."""
    attempts = (retry_record or {}).get("attempts") or []
    if attempts and attempts[-1].get("attempt") is not None:
        return int(attempts[-1]["attempt"])
    if tuned and tuned.get("rung") is not None:
        return int(tuned["rung"])
    return 0


def tuned_summary(tuned: Optional[dict]) -> Optional[dict]:
    """The compact per-entry record of what the autotuner did (the
    ``TunedConfig.as_record()`` dict, reduced to the fields the trend
    aggregation keys on)."""
    if not tuned:
        return None
    return {k: tuned[k] for k in ("source", "rung", "applied")
            if tuned.get(k) is not None}


def quick_indicators(metrics: Optional[dict]) -> Optional[dict]:
    """Per-request health indicators from one device-metrics block
    (``Metrics.to_dict()``): the skew/headroom signals
    ``analyze.compute_indicators`` derives for a full run, reduced to
    what one request can tell. None when no metrics rode the program
    (telemetry off)."""
    if not metrics or not isinstance(metrics.get("per_rank"), dict):
        return None
    per_rank = metrics["per_rank"]
    reduced = metrics.get("reduced", {})
    out: dict = {}
    for name in ("matches", "build.rows_received",
                 "probe.rows_received"):
        vals = per_rank.get(name)
        if not vals:
            continue
        g, imb = gini(vals), imbalance(vals)
        if g is None:
            continue
        out[name] = {"gini": round(g, 4),
                     "max_over_mean": round(imb, 4)}
    for side in ("build", "probe"):
        margin = reduced.get(f"{side}.overflow_margin_min")
        if margin is not None:
            out[f"{side}.overflow_margin_min"] = int(margin)
    return out or None


def stages_block(stage_profile: Optional[dict]) -> Optional[dict]:
    """The optional per-entry ``stages`` block: the compact summary a
    ``--stage-profile`` run embeds in its record
    (``stageprof.StageProfile.summary()``), reduced to what the trend
    aggregation keys on — per-stage measured walls, per-stage
    measured/predicted ratios, and the overlap fraction. None when the
    run carried no stage profile (the common case)."""
    if not isinstance(stage_profile, dict) or \
            not stage_profile.get("wall_s"):
        return None
    return {
        "wall_s": dict(stage_profile["wall_s"]),
        "ratio": dict(stage_profile.get("ratio") or {}),
        "overlap_fraction": stage_profile.get("overlap_fraction"),
        "monolithic_wall_s": stage_profile.get("monolithic_wall_s"),
    }


def prediction_block(wall_s, predicted_wall_s) -> Optional[dict]:
    """The cost-model grading carried per entry: predicted wall vs
    measured, as a ratio (measured / predicted — >1 means the model
    was optimistic). The summarizer turns these into the per-signature
    prediction-band drift flag the autotuner reads (where is the
    model wrong, and is it wrong CONSISTENTLY)."""
    if not predicted_wall_s:
        return None
    block = {"predicted_wall_s": float(predicted_wall_s)}
    if wall_s:
        block["wall_ratio"] = round(
            float(wall_s) / float(predicted_wall_s), 6)
    return block


def request_entry(*, request_id: str, op: str, signature: str,
                  outcome: str, wall_s: float, new_traces: int = 0,
                  cache_hits: int = 0, matches: Optional[int] = None,
                  retry_record: Optional[dict] = None,
                  metrics: Optional[dict] = None,
                  predicted_wall_s: Optional[float] = None,
                  tuned: Optional[dict] = None,
                  platform: Optional[str] = None,
                  stage_profile: Optional[dict] = None,
                  resident: Optional[dict] = None,
                  aggregate: Optional[dict] = None,
                  replica: Optional[dict] = None,
                  error: Optional[str] = None,
                  trace: Optional[dict] = None,
                  tenant: Optional[str] = None) -> dict:
    """One serving request's history line (the JoinService write
    path). ``metrics`` is the request's ``Metrics.to_dict()`` block
    when telemetry rode the program, else None; ``predicted_wall_s``
    the plan's cost-model prediction when the service computed one;
    ``tuned`` the autotuner's ``TunedConfig.as_record()`` when the
    request dispatched pre-sized; ``platform`` the backend the wall
    was measured on (the calibration seam only trusts real-hardware
    entries); ``resident`` stamps a request that ran against a
    resident build table (``{"table", "generation", ...}`` —
    service/resident.py) so the store distinguishes probe-only
    serving from cold full joins (None = cold; ``analyze check``
    validates the stamp's shape)."""
    entry = {
        "schema_version": HISTORY_SCHEMA_VERSION,
        "kind": "request",
        "request_id": request_id,
        "op": op,
        "signature": signature,
        "outcome": outcome,
        "wall_s": round(float(wall_s), 6),
        "new_traces": int(new_traces),
        "cache_hits": int(cache_hits),
        "matches": matches,
        "retry": retry_counts(retry_record),
        "resolved_knobs": _resolved_knobs(retry_record),
        "rung": resolved_rung(retry_record, tuned),
        "tuned": tuned_summary(tuned),
        "platform": platform,
        "counter_signature": baselines.counter_signature(metrics),
        "indicators": quick_indicators(metrics),
        "prediction": prediction_block(wall_s, predicted_wall_s),
        "stages": stages_block(stage_profile),
        "resident": resident,
        # Aggregation-pushdown stamp (docs/AGGREGATION.md): requests
        # that ran the fused join+aggregate pipeline carry the spec
        # (group_keys/aggs/...) plus the groups emitted; None = a
        # materializing join. `analyze check` validates the shape.
        "aggregate": aggregate,
        # Fleet stamp (service/fleet.py): requests routed through the
        # fleet router carry the serving replica's index/generation
        # (None = a single-daemon request; `analyze check` validates
        # the shape).
        "replica": replica,
        # Distributed-trace stamp (telemetry/tracectx.py): the
        # (trace_id, span_id, parent_span_id) context active when the
        # request ran, so `analyze timeline` joins history lines from
        # every process of a fleet into one causal chain. None = an
        # untraced request; `analyze check` validates the shape.
        "trace": (dict(trace) if trace and trace.get("trace_id")
                  else None),
        "error": error,
    }
    if tenant is not None and tenant != DEFAULT_TENANT:
        # Tenant stamp (docs/FLEET.md "Multi-tenancy"): present only
        # for non-default tenants, so default-tenant entries stay
        # byte-identical to the pre-tenancy schema. `analyze check`
        # validates the stamp; `analyze history --tenant` filters on
        # it; trends key on tenant/signature through tenant_key().
        entry["tenant"] = str(tenant)
    return entry


def run_signature(workload: dict) -> str:
    """THE one hash of a driver run's workload-identity dict (the
    keys of :data:`WORKLOAD_KEYS`, non-None only) — shared by
    :func:`run_entry` and the drivers' ``--auto-tune`` pre-run lookup
    so the two can never disagree."""
    return hashlib.sha256(
        json.dumps(workload, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def _retry_view(record: dict) -> Optional[dict]:
    """A record's retry trail in RetryReport.as_record() shape.
    bench.py nests two trails ({"match_sized", "capacity_contract"});
    the capacity-contract one is the general-contract sizing the
    autotuner cares about."""
    r = record.get("retry")
    if isinstance(r, dict) and "attempts" not in r \
            and isinstance(r.get("capacity_contract"), dict):
        return r["capacity_contract"]
    return r if isinstance(r, dict) else None


def run_entry(record: Optional[dict] = None,
              summary: Optional[dict] = None,
              platform: Optional[str] = None) -> dict:
    """One benchmark run's history line (the ``--history`` driver
    flag): the workload identity is hashed from the record's
    workload-shaped keys, the knobs/wall/counters from wherever the
    record carries them. A ``--auto-tune`` run embeds its PRE-TUNED
    workload dict under ``record["tuned"]["workload"]`` — that is the
    identity hashed here, so a tuner-adjusted knob never forks the
    workload's signature away from its own history."""
    record = record or {}
    tuned = record.get("tuned") if isinstance(record.get("tuned"),
                                              dict) else None
    workload = (tuned or {}).get("workload") or {
        k: record.get(k) for k in WORKLOAD_KEYS
        if record.get(k) is not None
    }
    digest = run_signature(workload)
    metrics = None
    if summary and isinstance(summary.get("metrics"), dict):
        metrics = summary["metrics"]
    # THE one extraction of a record's comparable wall number
    # (bench.py's "value" is a rate, not a time — never recorded).
    wall = baselines.wall_time_of(record)
    # --explain runs embed their prediction summary in the record;
    # grade it here so the store carries per-signature model error.
    predicted = (record.get("explain") or {}).get("predicted_wall_s")
    retry = _retry_view(record)
    return {
        "schema_version": HISTORY_SCHEMA_VERSION,
        "kind": "run",
        "request_id": None,
        "op": record.get("benchmark") or "run",
        "signature": digest,
        "workload": workload,
        "outcome": "failed" if record.get("error") else "ok",
        "wall_s": round(float(wall), 6) if wall else None,
        "new_traces": 0,
        "cache_hits": 0,
        "matches": record.get("matches_per_join"),
        "retry": retry_counts(retry),
        "resolved_knobs": _resolved_knobs(retry),
        "rung": resolved_rung(retry, tuned),
        "tuned": tuned_summary(tuned),
        "platform": platform,
        "counter_signature": baselines.counter_signature(
            metrics if metrics is not None else record),
        "indicators": quick_indicators(metrics),
        "prediction": prediction_block(wall, predicted),
        # A --stage-profile run embeds its compact per-stage summary;
        # the trend shows per-stage drift next to counter drift.
        "stages": stages_block(record.get("stage_profile")),
        # The tpch driver's --agg mode (and any record carrying an
        # aggregate block) stamps the pushdown spec + groups emitted.
        "aggregate": (record.get("aggregate")
                      if isinstance(record.get("aggregate"), dict)
                      else None),
        "error": record.get("error"),
    }


# -- the read side ----------------------------------------------------


def load_history(path: str):
    """Read a history store; returns ``(entries, malformed_lines)``.
    A torn final line (killed mid-append) is tolerated exactly as
    ``analyze.load_run`` tolerates torn event logs."""
    path = history_path(path)
    entries, malformed = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except ValueError:
                malformed += 1
    return entries, malformed


def _wall_stats(walls) -> Optional[dict]:
    vals = sorted(w for w in walls if w is not None)
    if not vals:
        return None
    n = len(vals)
    return {
        "n": n,
        "min_s": round(vals[0], 6),
        "p50_s": round(vals[n // 2], 6),
        "max_s": round(vals[-1], 6),
        "mean_s": round(sum(vals) / n, 6),
        "last_s": round([w for w in walls if w is not None][-1], 6),
    }


def _prediction_stats(ratios) -> Optional[dict]:
    """Per-signature cost-model grading (JAX :590): the measured/
    predicted wall ratios across runs, flagged ``drift`` when any run
    lands outside the cost model's band."""
    if not ratios:
        return None
    from distributed_join_tpu_torch.planning.cost import (
        DEFAULT_PREDICTION_BAND,
    )

    band = DEFAULT_PREDICTION_BAND
    return {
        "n": len(ratios),
        "wall_ratio_min": round(min(ratios), 4),
        "wall_ratio_max": round(max(ratios), 4),
        "wall_ratio_last": round(ratios[-1], 4),
        "band": band,
        "drift": any(r > band or r < 1.0 / band for r in ratios),
    }


class SignatureTrend:
    """Incremental per-signature aggregate over history entries — THE
    one definition of "what this workload's history says", shared by
    :func:`summarize` (the CLI view) and the JAX package's autotuner
    table (its ``planning/tuner.py`` feeds it one entry per
    request). Understands the compaction rollup lines, so a bounded
    store keeps its counts."""

    def __init__(self):
        self.entries = 0
        self.outcomes: dict = {}
        self.ops: dict = {}
        self.walls: list = []
        self.escalations = 0
        self.integrity_retries = 0
        self.new_traces = 0
        self.resolved_knobs_last = None
        self.resolved_rung_last = None
        self.counter_drift = False
        self.counters_last = None
        self.indicators_last = None
        self.tuned_entries = 0
        self.platform_last = None
        self.rolled_up = 0
        self.pred_ratios: list = []
        self.stages_last = None
        self.stage_drift = False
        self._stage_walls: dict = {}   # stage -> [measured walls]
        # counters keyed by the sizing that produced them: the SAME
        # workload at a DIFFERENT rung (or with different tuner-applied
        # knobs) legitimately moves wire/margin counters — drift means
        # the data moved under an UNCHANGED sizing.
        self._counters_by_sizing: dict = {}

    def add(self, e: dict) -> None:
        if e.get("kind") == "rollup":
            self.entries += int(e.get("entries") or 0)
            self.rolled_up += int(e.get("entries") or 0)
            for k, v in (e.get("outcomes") or {}).items():
                self.outcomes[k] = self.outcomes.get(k, 0) + int(v)
            for k, v in (e.get("ops") or {}).items():
                self.ops[k] = self.ops.get(k, 0) + int(v)
            self.escalations += int(e.get("escalations") or 0)
            self.integrity_retries += int(
                e.get("integrity_retries") or 0)
            self.new_traces += int(e.get("new_traces") or 0)
            self.tuned_entries += int(e.get("tuned_entries") or 0)
            if e.get("resolved_knobs_last"):
                self.resolved_knobs_last = e["resolved_knobs_last"]
                self.resolved_rung_last = e.get("resolved_rung_last")
            if e.get("platform_last"):
                self.platform_last = e["platform_last"]
            return
        self.entries += 1
        outcome = e.get("outcome") or "?"
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        op = e.get("op") or "?"
        self.ops[op] = self.ops.get(op, 0) + 1
        self.walls.append(e.get("wall_s"))
        retry = e.get("retry") or {}
        self.escalations += int(retry.get("escalations") or 0)
        self.integrity_retries += int(
            retry.get("integrity_retries") or 0)
        self.new_traces += int(e.get("new_traces") or 0)
        if (e.get("tuned") or {}).get("source") == "history":
            self.tuned_entries += 1
        if e.get("platform"):
            self.platform_last = e["platform"]
        if e.get("resolved_knobs"):
            self.resolved_knobs_last = e["resolved_knobs"]
            rung = e.get("rung")
            if rung is None:
                # Pre-rung-stamp entries (older stores): the ladder
                # always started at rung 0 then, so the final rung IS
                # n_attempts - 1. Without this back-fill a tuner fed
                # an old store would adopt escalated sizing under
                # rung label 0 — a signature matching NO resident
                # executable, silently re-tracing every warm run.
                rung = max(int(retry.get("n_attempts") or 1) - 1, 0)
            self.resolved_rung_last = int(rung)
        if e.get("indicators"):
            self.indicators_last = e["indicators"]
        # ONE sizing identity for every drift signal: the SAME
        # workload at a DIFFERENT rung (or with different tuner-
        # applied knobs) legitimately moves counters AND stage walls
        # (doubled capacities mean more partition/shuffle work) —
        # drift means the measurement moved under an UNCHANGED sizing.
        sizing_key = (int(e.get("rung") or 0), json.dumps(
            (e.get("tuned") or {}).get("applied") or {},
            sort_keys=True, default=str))
        csig = e.get("counter_signature")
        if isinstance(csig, dict) and csig.get("counters"):
            self.counters_last = csig["counters"]
            seen = self._counters_by_sizing.get(sizing_key)
            if seen is None:
                self._counters_by_sizing[sizing_key] = csig["counters"]
            elif seen != csig["counters"]:
                # Same workload signature, same sizing, different
                # device counters: the data (or a seam) moved — the
                # drift the autotuner must re-observe before trusting
                # old sizing.
                self.counter_drift = True
        pred = e.get("prediction")
        if isinstance(pred, dict) and pred.get("wall_ratio"):
            self.pred_ratios.append(float(pred["wall_ratio"]))
        st = e.get("stages")
        if isinstance(st, dict) and st.get("wall_s"):
            self.stages_last = st
            for stage, wall in st["wall_s"].items():
                if not wall:
                    continue
                # Keyed per sizing, like the counters above: a
                # re-profiled run at an escalated rung does MORE
                # partition/shuffle work by design and must not read
                # as drift.
                walls = self._stage_walls.setdefault(
                    (sizing_key, stage), [])
                walls.append(float(wall))
                if max(walls) / min(walls) > STAGE_DRIFT_RATIO:
                    # The same workload's measured stage wall moved
                    # more than the drift band across runs at one
                    # unchanged sizing — the per-stage analog of
                    # counter drift.
                    self.stage_drift = True

    @property
    def successes(self) -> int:
        return sum(self.outcomes.get(k, 0)
                   for k in ("ok", "served", "recovered"))

    def as_dict(self) -> dict:
        return {
            "entries": self.entries,
            "outcomes": dict(self.outcomes),
            "ops": dict(self.ops),
            "wall": _wall_stats(self.walls),
            "escalations": self.escalations,
            "integrity_retries": self.integrity_retries,
            "new_traces": self.new_traces,
            "resolved_knobs_last": self.resolved_knobs_last,
            "resolved_rung_last": self.resolved_rung_last,
            "counter_drift": self.counter_drift,
            "tuned_entries": self.tuned_entries,
            "platform_last": self.platform_last,
            "rolled_up": self.rolled_up,
            "prediction": _prediction_stats(self.pred_ratios),
            "stages_last": self.stages_last,
            "stage_drift": self.stage_drift,
        }


def trends_of(entries) -> dict:
    """{trend key: SignatureTrend} over a loaded store. Keys are the
    tenant-namespaced :func:`tenant_key` composition — the bare
    signature for default-tenant (un-stamped) entries, so a
    tenant-free store summarizes exactly as before."""
    sigs: dict = {}
    for e in entries:
        sigs.setdefault(tenant_key(e.get("signature"),
                                   e.get("tenant")),
                        SignatureTrend()).add(e)
    return sigs


def summarize(entries) -> dict:
    """Per-signature trends over a history store — the view the
    JAX package's autotuner (``planning/tuner.py``) pre-sizes from."""
    sigs = trends_of(entries)
    out = {digest: t.as_dict() for digest, t in sigs.items()}
    return {
        "schema_version": HISTORY_SCHEMA_VERSION,
        "n_entries": len(entries),
        "n_signatures": len(out),
        "signatures": out,
    }


def format_summary(summary: dict, path: str = "") -> str:
    lines = [
        f"history: {summary['n_entries']} entr"
        f"{'y' if summary['n_entries'] == 1 else 'ies'}, "
        f"{summary['n_signatures']} signature(s)"
        + (f"  [{path}]" if path else ""),
    ]
    for digest, s in sorted(summary["signatures"].items(),
                            key=lambda kv: -kv[1]["entries"]):
        outcomes = ", ".join(f"{k}={v}" for k, v in
                             sorted(s["outcomes"].items()))
        lines.append(f"  {digest}: {s['entries']} run(s)  {outcomes}")
        wall = s.get("wall")
        if wall:
            lines.append(
                f"    wall p50={wall['p50_s']}s "
                f"mean={wall['mean_s']}s last={wall['last_s']}s")
        if s["escalations"] or s["integrity_retries"]:
            lines.append(
                f"    ladder: {s['escalations']} escalation(s), "
                f"{s['integrity_retries']} integrity retr"
                f"{'y' if s['integrity_retries'] == 1 else 'ies'}")
        if s.get("resolved_knobs_last"):
            knobs = " ".join(f"{k}={v}" for k, v in
                             sorted(s["resolved_knobs_last"].items()))
            rung = s.get("resolved_rung_last")
            lines.append(f"    resolved"
                         + (f" (rung {rung})" if rung else "")
                         + f": {knobs}")
        if s.get("tuned_entries"):
            lines.append(f"    tuned: {s['tuned_entries']} pre-sized "
                         "run(s)")
        if s.get("rolled_up"):
            lines.append(f"    compacted: {s['rolled_up']} older "
                         "entr(ies) rolled up")
        if s.get("counter_drift"):
            lines.append("    counter signature DRIFTED across runs "
                         "(data moved; re-observe before pre-sizing)")
        st = s.get("stages_last")
        if st:
            walls = " ".join(f"{k}={v}" for k, v in
                             sorted((st.get("wall_s") or {}).items()))
            of = st.get("overlap_fraction")
            lines.append("    stages (s): " + walls
                         + (f"  overlap={of:.0%}"
                            if of is not None else ""))
            if s.get("stage_drift"):
                lines.append(
                    f"    stage walls DRIFTED >x{STAGE_DRIFT_RATIO:g} "
                    "across runs (re-profile before trusting "
                    "per-stage calibration)")
        pred = s.get("prediction")
        if pred:
            tag = (" OUTSIDE prediction band" if pred["drift"]
                   else "")
            lines.append(
                f"    cost model: wall/predicted "
                f"{pred['wall_ratio_min']}-{pred['wall_ratio_max']}x "
                f"over {pred['n']} run(s) (band "
                f"{pred['band']:g}x){tag}")
    return "\n".join(lines)
