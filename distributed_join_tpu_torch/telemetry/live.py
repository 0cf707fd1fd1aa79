"""Live serving metrics: the streaming read side of a resident server.

A copy of ``distributed_join_tpu/telemetry/live.py``, whole:
``LatencyHistogram`` (:53), ``LiveMetrics`` (:133), ``merge_snapshots``
(:507), ``fleet_prometheus`` (:548) and ``FlightRecorder`` (:619). It is
plain Python over host timestamps, with no device and no JAX, so the
port keeps its own copy rather than importing the JAX module. The
Prometheus metric names (``djtpu_*``) and the snapshot keys stay the JAX
package's: scrapers and ``results/contracts/wire_ops.json`` rely on them.

A resident daemon never finalizes a telemetry session; its operators
need the live view:

- :class:`LatencyHistogram`: fixed log-spaced buckets, so snapshots
  taken on different processes (or at different times) MERGE by adding
  counts, and p50/p95/p99 derive from any snapshot;
- :class:`LiveMetrics`: the lock-protected accumulator behind the
  daemon's ``metrics`` wire op and ``stats`` quantiles: per-op outcome
  counters and latency histograms, per-workload-signature counters
  (served/failed, cache hits, ``new_traces``, retry rungs, integrity
  retries), rolling QPS and uptime, as a JSON snapshot and as Prometheus
  text exposition;
- :class:`FlightRecorder`: a bounded ring of the last-N per-request
  records (request id, signature hash, timings, rung path, outcome),
  dumped as ``flightrecorder.json`` on poison or terminal error.

Everything here is host bookkeeping around requests that already ran;
none of it touches a program or a tensor.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

FLIGHT_RECORDER_SCHEMA_VERSION = 1
FLIGHT_RECORDER_FILENAME = "flightrecorder.json"

# Log-spaced latency bucket upper bounds: 100 us .. 100 s, four buckets
# per decade. FIXED (not configurable) so every snapshot ever taken is
# mergeable with every other by adding counts position-wise.
LATENCY_BUCKETS_S = tuple(
    round(1e-4 * 10 ** (i / 4), 10) for i in range(25)
)


class LatencyHistogram:
    """Fixed-bucket log-spaced histogram with mergeable snapshots.

    ``counts[i]`` is the number of observations with value <=
    ``LATENCY_BUCKETS_S[i]`` (and > the previous bound); the final slot
    is the overflow bucket. Not thread-safe by itself —
    :class:`LiveMetrics` holds the lock.
    """

    __slots__ = ("counts", "count", "sum_s")

    def __init__(self):
        self.counts = [0] * (len(LATENCY_BUCKETS_S) + 1)
        self.count = 0
        self.sum_s = 0.0

    def observe(self, seconds: float) -> None:
        i = bisect.bisect_left(LATENCY_BUCKETS_S, float(seconds))
        self.counts[i] += 1
        self.count += 1
        self.sum_s += float(seconds)

    def merge(self, snapshot: dict) -> None:
        """Fold another histogram's :meth:`snapshot` into this one —
        bucket bounds are module constants, so addition is exact."""
        other = snapshot["counts"]
        if len(other) != len(self.counts):
            raise ValueError(
                f"histogram shape mismatch: {len(other)} buckets vs "
                f"{len(self.counts)} (snapshots merge only across the "
                "same LATENCY_BUCKETS_S)")
        for i, c in enumerate(other):
            self.counts[i] += int(c)
        self.count += int(snapshot["count"])
        self.sum_s += float(snapshot["sum_s"])

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile by cumulative walk + linear
        interpolation inside the landing bucket. None when empty."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = LATENCY_BUCKETS_S[i - 1] if i > 0 else 0.0
                hi = (LATENCY_BUCKETS_S[i]
                      if i < len(LATENCY_BUCKETS_S)
                      else LATENCY_BUCKETS_S[-1])
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return LATENCY_BUCKETS_S[-1]  # pragma: no cover - defensive

    def snapshot(self) -> dict:
        return {
            "le_s": list(LATENCY_BUCKETS_S),
            "counts": list(self.counts),
            "count": self.count,
            "sum_s": round(self.sum_s, 6),
        }

    def summary(self) -> dict:
        """The quantile block ``stats``/``metrics`` embed."""
        out = {"count": self.count, "sum_s": round(self.sum_s, 6)}
        if self.count:
            out["mean_s"] = round(self.sum_s / self.count, 6)
        if self.counts[-1]:
            # Quantiles saturate at the top bucket bound (100 s) —
            # say so instead of silently understating a slow tail.
            out["overflow"] = self.counts[-1]
        for name, q in (("p50_s", 0.50), ("p95_s", 0.95),
                        ("p99_s", 0.99)):
            v = self.quantile(q)
            out[name] = round(v, 6) if v is not None else None
        return out


class LiveMetrics:
    """Lock-protected streaming serving stats (one per
    :class:`~..service.server.JoinService`).

    ``record_request`` is the single write path — the service calls it
    once per request with the outcome ("served", "failed", "hang",
    "rejected") and the per-request accounting it captured under its
    exec lock. Reads (:meth:`snapshot`, :meth:`to_prometheus`,
    :meth:`overall_latency`) take the same lock, so a scrape never sees
    a torn update.
    """

    QPS_WINDOW_S = 60
    MAX_SIGNATURES = 256
    MAX_TENANTS = 64

    def __init__(self, now=time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._t0 = now()
        self._epoch0 = time.time()
        self._ops: dict = {}
        self._signatures: OrderedDict = OrderedDict()
        self._signatures_dropped = 0
        self._tenants: OrderedDict = OrderedDict()
        self._tenants_dropped = 0
        self._arrivals = deque()        # (second, count) ring

    # -- write path ---------------------------------------------------

    def _op_slot(self, op: str) -> dict:
        slot = self._ops.get(op)
        if slot is None:
            slot = self._ops[op] = {
                "outcomes": {},
                "cache_hits": 0,
                "new_traces": 0,
                "retry_rungs": 0,
                "integrity_retries": 0,
                "latency": LatencyHistogram(),
            }
        return slot

    def _sig_slot(self, digest: str) -> Optional[dict]:
        slot = self._signatures.get(digest)
        if slot is not None:
            self._signatures.move_to_end(digest)
            return slot
        if len(self._signatures) >= self.MAX_SIGNATURES:
            # Bounded like the program cache: drop the least recently
            # SERVED workload, count the drop (no silent caps).
            self._signatures.popitem(last=False)
            self._signatures_dropped += 1
        slot = self._signatures[digest] = {
            "requests": 0,
            "outcomes": {},
            "cache_hits": 0,
            "new_traces": 0,
            "retry_rungs": 0,
            "integrity_retries": 0,
            "latency": LatencyHistogram(),
        }
        return slot

    def _tenant_slot(self, tenant: str) -> dict:
        """Per-tenant accounting slot (docs/FLEET.md "Multi-tenancy"):
        only traffic that CARRIES a tenant lands here, so a
        tenant-free deployment's snapshots and exposition stay
        byte-identical to the pre-tenancy contract. Bounded LRU like
        the signature table — never an unbounded label cardinality."""
        slot = self._tenants.get(tenant)
        if slot is not None:
            self._tenants.move_to_end(tenant)
            return slot
        if len(self._tenants) >= self.MAX_TENANTS:
            self._tenants.popitem(last=False)
            self._tenants_dropped += 1
        slot = self._tenants[tenant] = {
            "requests": 0,
            "outcomes": {},
            "shed": 0,
            "latency": LatencyHistogram(),
            "arrivals": deque(),
        }
        return slot

    def _tick(self) -> None:
        sec = int(self._now())
        if self._arrivals and self._arrivals[-1][0] == sec:
            self._arrivals[-1][1] += 1
        else:
            self._arrivals.append([sec, 1])
        horizon = sec - self.QPS_WINDOW_S
        while self._arrivals and self._arrivals[0][0] <= horizon:
            self._arrivals.popleft()

    def record_request(self, op: str, outcome: str, *,
                       latency_s: Optional[float] = None,
                       signature: Optional[str] = None,
                       cache_hits: int = 0, new_traces: int = 0,
                       retry_rungs: int = 0,
                       integrity_retries: int = 0,
                       tenant: Optional[str] = None,
                       shed: bool = False) -> None:
        with self._lock:
            self._tick()
            slots = [self._op_slot(op)]
            if signature is not None:
                slots.append(self._sig_slot(signature))
            for slot in slots:
                slot["outcomes"][outcome] = (
                    slot["outcomes"].get(outcome, 0) + 1)
                slot["cache_hits"] += int(cache_hits)
                slot["new_traces"] += int(new_traces)
                slot["retry_rungs"] += int(retry_rungs)
                slot["integrity_retries"] += int(integrity_retries)
                if "requests" in slot:
                    slot["requests"] += 1
                if latency_s is not None:
                    slot["latency"].observe(latency_s)
            if tenant is not None:
                ts = self._tenant_slot(str(tenant))
                ts["requests"] += 1
                ts["outcomes"][outcome] = (
                    ts["outcomes"].get(outcome, 0) + 1)
                ts["shed"] += int(bool(shed))
                if latency_s is not None:
                    ts["latency"].observe(latency_s)
                sec = int(self._now())
                arr = ts["arrivals"]
                if arr and arr[-1][0] == sec:
                    arr[-1][1] += 1
                else:
                    arr.append([sec, 1])
                horizon = sec - self.QPS_WINDOW_S
                while arr and arr[0][0] <= horizon:
                    arr.popleft()

    # -- read path ----------------------------------------------------

    def uptime_s(self) -> float:
        return self._now() - self._t0

    def qps(self) -> float:
        with self._lock:
            horizon = int(self._now()) - self.QPS_WINDOW_S
            n = sum(c for sec, c in self._arrivals if sec > horizon)
        window = min(max(self.uptime_s(), 1.0), self.QPS_WINDOW_S)
        return n / window

    def overall_latency(self) -> dict:
        """Quantiles over every op's SERVED latency (the ``stats``
        block) — merged from the per-op histograms."""
        merged = LatencyHistogram()
        with self._lock:
            for slot in self._ops.values():
                merged.merge(slot["latency"].snapshot())
        return merged.summary()

    def latency_by_op(self) -> dict:
        """Per-op p50/p95/p99 summaries (``stats.latency_by_op``, the
        ``--watch`` console's per-op segment, and the Prometheus
        quantile gauges) — the histograms always existed per op; this
        surfaces them without shipping full bucket arrays."""
        with self._lock:
            return {op: slot["latency"].summary()
                    for op, slot in sorted(self._ops.items())
                    if slot["latency"].count}

    def tenants_summary(self) -> dict:
        """Per-tenant served/shed counters, rolling QPS, and latency
        quantiles — the ``stats.tenants`` block and the ``--watch``
        console's per-tenant segment. Empty dict when no request ever
        carried a tenant (the tenant-free wire contract)."""
        with self._lock:
            horizon = int(self._now()) - self.QPS_WINDOW_S
            window = min(max(self.uptime_s(), 1.0),
                         self.QPS_WINDOW_S)
            out = {}
            for tenant, slot in sorted(self._tenants.items()):
                n = sum(c for sec, c in slot["arrivals"]
                        if sec > horizon)
                out[tenant] = {
                    "requests": slot["requests"],
                    "outcomes": dict(slot["outcomes"]),
                    "shed": slot["shed"],
                    "qps_60s": round(n / window, 3),
                    "latency": slot["latency"].summary(),
                }
        return out

    def snapshot(self) -> dict:
        """The ``metrics`` wire op's JSON body."""
        with self._lock:
            ops = {
                op: {
                    "outcomes": dict(slot["outcomes"]),
                    "cache_hits": slot["cache_hits"],
                    "new_traces": slot["new_traces"],
                    "retry_rungs": slot["retry_rungs"],
                    "integrity_retries": slot["integrity_retries"],
                    "latency": slot["latency"].summary(),
                    "latency_histogram": slot["latency"].snapshot(),
                }
                for op, slot in sorted(self._ops.items())
            }
            signatures = {
                digest: {
                    "requests": slot["requests"],
                    "outcomes": dict(slot["outcomes"]),
                    "cache_hits": slot["cache_hits"],
                    "new_traces": slot["new_traces"],
                    "retry_rungs": slot["retry_rungs"],
                    "integrity_retries": slot["integrity_retries"],
                    "latency": slot["latency"].summary(),
                }
                for digest, slot in self._signatures.items()
            }
            dropped = self._signatures_dropped
            have_tenants = bool(self._tenants)
        snap = {
            "uptime_s": round(self.uptime_s(), 3),
            "epoch_start_s": self._epoch0,
            "qps_60s": round(self.qps(), 3),
            "ops": ops,
            "signatures": signatures,
            "signatures_dropped": dropped,
        }
        if have_tenants:
            # Key present only when some request CARRIED a tenant —
            # tenant-free snapshots stay byte-identical to the
            # pre-tenancy schema (committed baselines depend on it).
            snap["tenants"] = self.tenants_summary()
        return snap

    def to_prometheus(self, gauges: Optional[dict] = None) -> str:
        """Prometheus text exposition (version 0.0.4) of the live
        stats: outcome counters and latency histograms per op, the
        per-signature request counters, uptime/QPS, plus any caller-
        supplied ``gauges`` (the service adds pending/poisoned and the
        program-cache counters)."""
        lines = [
            "# HELP djtpu_uptime_seconds Service uptime.",
            "# TYPE djtpu_uptime_seconds gauge",
            f"djtpu_uptime_seconds {self.uptime_s():.3f}",
            "# HELP djtpu_qps_60s Requests/s over the last 60s.",
            "# TYPE djtpu_qps_60s gauge",
            f"djtpu_qps_60s {self.qps():.3f}",
        ]
        with self._lock:
            lines += [
                "# HELP djtpu_requests_total Requests by op and "
                "outcome.",
                "# TYPE djtpu_requests_total counter",
            ]
            for op, slot in sorted(self._ops.items()):
                for outcome, n in sorted(slot["outcomes"].items()):
                    lines.append(
                        f'djtpu_requests_total{{op="{op}",'
                        f'outcome="{outcome}"}} {n}')
            for name in ("cache_hits", "new_traces", "retry_rungs",
                         "integrity_retries"):
                lines += [
                    f"# TYPE djtpu_{name}_total counter",
                ]
                for op, slot in sorted(self._ops.items()):
                    lines.append(
                        f'djtpu_{name}_total{{op="{op}"}} '
                        f'{slot[name]}')
            lines += [
                "# HELP djtpu_request_latency_seconds Served request "
                "latency.",
                "# TYPE djtpu_request_latency_seconds histogram",
            ]
            for op, slot in sorted(self._ops.items()):
                hist = slot["latency"]
                cum = 0
                for i, le in enumerate(LATENCY_BUCKETS_S):
                    cum += hist.counts[i]
                    lines.append(
                        "djtpu_request_latency_seconds_bucket"
                        f'{{op="{op}",le="{le:g}"}} {cum}')
                lines.append(
                    "djtpu_request_latency_seconds_bucket"
                    f'{{op="{op}",le="+Inf"}} {hist.count}')
                lines.append(
                    "djtpu_request_latency_seconds_sum"
                    f'{{op="{op}"}} {hist.sum_s:.6f}')
                lines.append(
                    "djtpu_request_latency_seconds_count"
                    f'{{op="{op}"}} {hist.count}')
            # Pre-derived per-op quantile gauges: scrapers that can't
            # (or won't) do histogram_quantile still get p50/p95/p99.
            lines += [
                "# HELP djtpu_request_latency_quantile_seconds "
                "Per-op latency quantiles (derived from the fixed "
                "log-spaced histogram).",
                "# TYPE djtpu_request_latency_quantile_seconds gauge",
            ]
            for op, slot in sorted(self._ops.items()):
                hist = slot["latency"]
                if not hist.count:
                    continue
                for label, q in (("0.5", 0.50), ("0.95", 0.95),
                                 ("0.99", 0.99)):
                    v = hist.quantile(q)
                    if v is not None:
                        lines.append(
                            "djtpu_request_latency_quantile_seconds"
                            f'{{op="{op}",quantile="{label}"}} '
                            f"{v:.6f}")
            lines += [
                "# HELP djtpu_signature_requests_total Requests by "
                "join signature.",
                "# TYPE djtpu_signature_requests_total counter",
            ]
            for digest, slot in self._signatures.items():
                lines.append(
                    "djtpu_signature_requests_total"
                    f'{{signature="{digest}"}} {slot["requests"]}')
            if self._tenants:
                # Multi-tenancy series (docs/FLEET.md): emitted only
                # once tenant-stamped traffic exists, so tenant-free
                # scrapes keep the pre-tenancy exposition exactly.
                lines += [
                    "# HELP djtpu_tenant_requests_total Requests by "
                    "tenant and outcome.",
                    "# TYPE djtpu_tenant_requests_total counter",
                ]
                for tenant, slot in sorted(self._tenants.items()):
                    for outcome, n in sorted(
                            slot["outcomes"].items()):
                        lines.append(
                            "djtpu_tenant_requests_total"
                            f'{{tenant="{tenant}",'
                            f'outcome="{outcome}"}} {n}')
                lines += [
                    "# HELP djtpu_tenant_shed_total Requests shed by "
                    "tenant quota/priority policy.",
                    "# TYPE djtpu_tenant_shed_total counter",
                ]
                for tenant, slot in sorted(self._tenants.items()):
                    lines.append(
                        "djtpu_tenant_shed_total"
                        f'{{tenant="{tenant}"}} {slot["shed"]}')
                lines += [
                    "# HELP "
                    "djtpu_tenant_request_latency_quantile_seconds "
                    "Per-tenant latency quantiles.",
                    "# TYPE "
                    "djtpu_tenant_request_latency_quantile_seconds "
                    "gauge",
                ]
                for tenant, slot in sorted(self._tenants.items()):
                    hist = slot["latency"]
                    if not hist.count:
                        continue
                    for label, q in (("0.5", 0.50), ("0.95", 0.95),
                                     ("0.99", 0.99)):
                        v = hist.quantile(q)
                        if v is not None:
                            lines.append(
                                "djtpu_tenant_request_latency_"
                                "quantile_seconds"
                                f'{{tenant="{tenant}",'
                                f'quantile="{label}"}} {v:.6f}')
        for name, value in sorted((gauges or {}).items()):
            if value is None:
                continue
            lines.append(f"# TYPE djtpu_{name} gauge")
            lines.append(f"djtpu_{name} {value}")
        return "\n".join(lines) + "\n"


def merge_snapshots(snapshots: list) -> dict:
    """Fold N :meth:`LiveMetrics.snapshot` dicts (one per fleet
    replica) into ONE fleet-level view: per-op outcome counters
    summed, latency histograms merged bucket-wise (exact — the bounds
    are the module constants), QPS summed (replicas serve disjoint
    traffic), uptime = the longest-lived replica. The shape mirrors a
    single snapshot's ``ops`` block so readers (the ``--watch``
    console, ``analyze``) need no second schema."""
    merged_ops: dict = {}
    for snap in snapshots:
        for op, slot in (snap.get("ops") or {}).items():
            m = merged_ops.setdefault(op, {
                "outcomes": {}, "cache_hits": 0, "new_traces": 0,
                "retry_rungs": 0, "integrity_retries": 0,
                "_hist": LatencyHistogram(),
            })
            for outcome, n in (slot.get("outcomes") or {}).items():
                m["outcomes"][outcome] = (
                    m["outcomes"].get(outcome, 0) + int(n))
            for k in ("cache_hits", "new_traces", "retry_rungs",
                      "integrity_retries"):
                m[k] += int(slot.get(k) or 0)
            hist = slot.get("latency_histogram")
            if hist:
                m["_hist"].merge(hist)
    ops = {}
    for op, m in sorted(merged_ops.items()):
        hist = m.pop("_hist")
        ops[op] = {**m, "latency": hist.summary(),
                   "latency_histogram": hist.snapshot()}
    return {
        "replicas": len(snapshots),
        "uptime_s": round(max(
            [float(s.get("uptime_s") or 0.0) for s in snapshots],
            default=0.0), 3),
        "qps_60s": round(sum(float(s.get("qps_60s") or 0.0)
                             for s in snapshots), 3),
        "ops": ops,
    }


def fleet_prometheus(per_replica: dict) -> str:
    """The fleet-level Prometheus section the router appends to its
    own exposition: per-replica-labeled request counters plus the
    MERGED cross-replica latency histogram (bucket counts add — the
    fixed-bound contract), so one scrape sees the whole fleet.
    ``per_replica`` maps a replica index to its ``metrics`` snapshot
    (None for a replica that did not answer — exported as
    ``djtpu_fleet_replica_up 0``)."""
    lines = [
        "# HELP djtpu_fleet_replica_up Replica answered the metrics "
        "fan-out.",
        "# TYPE djtpu_fleet_replica_up gauge",
    ]
    answered = {}
    for idx in sorted(per_replica):
        snap = per_replica[idx]
        lines.append(
            f'djtpu_fleet_replica_up{{replica="{idx}"}} '
            f"{int(snap is not None)}")
        if snap is not None:
            answered[idx] = snap
    lines += [
        "# HELP djtpu_fleet_replica_requests_total Replica requests "
        "by op and outcome.",
        "# TYPE djtpu_fleet_replica_requests_total counter",
    ]
    for idx, snap in sorted(answered.items()):
        for op, slot in sorted((snap.get("ops") or {}).items()):
            for outcome, n in sorted(
                    (slot.get("outcomes") or {}).items()):
                lines.append(
                    "djtpu_fleet_replica_requests_total"
                    f'{{replica="{idx}",op="{op}",'
                    f'outcome="{outcome}"}} {n}')
    merged = merge_snapshots(list(answered.values()))
    lines += [
        "# HELP djtpu_fleet_requests_total Fleet-merged requests by "
        "op and outcome.",
        "# TYPE djtpu_fleet_requests_total counter",
    ]
    for op, slot in sorted(merged["ops"].items()):
        for outcome, n in sorted(slot["outcomes"].items()):
            lines.append(
                "djtpu_fleet_requests_total"
                f'{{op="{op}",outcome="{outcome}"}} {n}')
    lines += [
        "# HELP djtpu_fleet_request_latency_seconds Fleet-merged "
        "served request latency (replica histograms added "
        "bucket-wise).",
        "# TYPE djtpu_fleet_request_latency_seconds histogram",
    ]
    for op, slot in sorted(merged["ops"].items()):
        hist = slot["latency_histogram"]
        cum = 0
        for i, le in enumerate(LATENCY_BUCKETS_S):
            cum += hist["counts"][i]
            lines.append(
                "djtpu_fleet_request_latency_seconds_bucket"
                f'{{op="{op}",le="{le:g}"}} {cum}')
        lines.append(
            "djtpu_fleet_request_latency_seconds_bucket"
            f'{{op="{op}",le="+Inf"}} {hist["count"]}')
        lines.append(
            "djtpu_fleet_request_latency_seconds_sum"
            f'{{op="{op}"}} {hist["sum_s"]:.6f}')
        lines.append(
            "djtpu_fleet_request_latency_seconds_count"
            f'{{op="{op}"}} {hist["count"]}')
    return "\n".join(lines) + "\n"


class FlightRecorder:
    """Bounded ring of the last-N per-request records — the resident
    server's postmortem buffer.

    Each :meth:`record` call appends one dict (request id, op,
    signature hash, timings, rung path, outcome, error); the ring
    keeps the newest ``capacity`` and counts what rotated out. On
    poison or terminal error the service dumps the ring as
    ``flightrecorder.json`` (:meth:`dump` — atomic write), the
    artifact ``telemetry.analyze check`` validates.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.capacity)
        self._recorded_total = 0

    def record(self, **fields) -> dict:
        rec = dict(fields)
        rec.setdefault("ts_epoch_s", time.time())
        with self._lock:
            self._ring.append(rec)
            self._recorded_total += 1
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self, reason: str = "snapshot",
                 trace: Optional[dict] = None) -> dict:
        with self._lock:
            records = [dict(r) for r in self._ring]
            total = self._recorded_total
        doc = {
            "schema_version": FLIGHT_RECORDER_SCHEMA_VERSION,
            "kind": "flightrecorder",
            "reason": reason,
            "dumped_epoch_s": time.time(),
            "capacity": self.capacity,
            "recorded_total": total,
            "dropped": max(total - len(records), 0),
            "records": records,
        }
        if trace:
            # The trace context active when the dump was cut (a
            # poisoned replica's hung request): the postmortem joins
            # that request's fleet timeline by trace_id.
            doc["trace"] = dict(trace)
        return doc

    def dump(self, path: str, reason: str,
             trace: Optional[dict] = None) -> str:
        """Atomically write the ring to ``path`` and return it."""
        doc = self.snapshot(reason, trace=trace)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path
