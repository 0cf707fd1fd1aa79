"""Fleet timeline assembly — ONE causal view across processes.

Port of ``distributed_join_tpu/telemetry/timeline.py`` (:56-427), copied
whole (plain Python over the event logs). In the port it assembles the
per-rank ``events.rank*.jsonl`` streams of a multi-process NCCL or gloo
run (one telemetry session directory, one stream a rank) into one
trace; the JAX package's ``telemetry.analyze timeline`` and ``check``
read what it writes.

A fleet request crosses processes: client -> router -> replica (and,
for fan-outs, several replicas), each writing its OWN per-process
telemetry session (``export.TelemetrySink``: ``events.rank*.jsonl``
streams, line-buffered, so even a SIGKILLed victim leaves its log).
``tracectx`` stamps every record with ``(trace_id, span_id,
parent_span_id)``; this module merges the per-process JSONL streams
into one timeline on a common clock and follows the parent/child
edges ACROSS processes — the "one causal timeline" of
docs/OBSERVABILITY.md "Distributed tracing".

Clock alignment: each stream's ``session_start`` event carries the
process's wall-clock epoch (``payload.epoch_s``) next to the stream's
perf-counter origin, so every record maps to absolute microseconds:
``epoch_s*1e6 + (ts_us - session_start.ts_us)``. Residual skew is
BOUNDED, not corrected, by wire causality: a child record (receiver
side of a hop) cannot precede its parent (sender side) — the maximum
observed inversion across all hops is reported as ``skew_bound_us``
and is the error bar on every cross-process comparison in the
timeline (same-host fleets: ~0).

Outputs (the JAX package's ``telemetry.analyze timeline DIR...`` renders
them; the port has no CLI for them yet):

- ``fleet_timeline.trace.json`` — a merged Perfetto/Chrome trace,
  one track (pid) per process, flow arrows on every cross-process
  parent/child hop (the Chrome trace format's ``ph:"s"``/``ph:"f"``
  flow events);
- a text rendering of the focus trace's span tree and CRITICAL PATH
  (admission -> route -> dispatch attempt -> replica request span ->
  settle), the blocking chain a latency investigation walks first;
- ``fleet_timeline.json`` — the ``kind: "fleet_timeline"`` summary
  artifact (``analyze check``-validated) CI asserts trace continuity
  on (the tracing smoke: a killed dispatch attempt and its failover
  retry must share one trace with >= 1 cross-process hop).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

SCHEMA_VERSION = 1
KIND = "fleet_timeline"

# Keep text renderings bounded: a soak's trace can hold thousands of
# spans; the tree view exists to READ, the Perfetto file to explore.
MAX_TREE_NODES = 48

_RANK_RE = re.compile(r"events\.rank(\d+)\.jsonl$")


def _iter_records(path: str):
    """Parse one JSONL stream, tolerating a torn FINAL line (the
    advertised killed-process artifact — the sink streams line-
    buffered and a SIGKILL can land mid-write). A torn line anywhere
    else is real corruption and raises."""
    with open(path) as f:
        lines = f.readlines()
    last = len(lines)
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except ValueError as exc:
            if i != last:
                raise ValueError(
                    f"{path}: unparseable line {i}: {exc}") from exc


def discover(paths) -> list:
    """Resolve CLI arguments (session dirs and/or explicit JSONL
    files) to per-process stream descriptors. One PROCESS = one
    ``events.rank*.jsonl`` stream; the label names it
    ``<session-dir-basename>:r<rank>`` so a fleet layout like
    ``tele/router`` + ``tele/replica0`` reads naturally."""
    procs = []
    for p in paths:
        if os.path.isdir(p):
            streams = sorted(
                glob.glob(os.path.join(p, "events.rank*.jsonl")))
            if not streams:
                raise ValueError(
                    f"{p}: no events.rank*.jsonl streams (not a "
                    "telemetry session dir)")
        elif os.path.isfile(p):
            streams = [p]
        else:
            raise ValueError(f"{p}: no such file or directory")
        for s in streams:
            m = _RANK_RE.search(os.path.basename(s))
            rank = int(m.group(1)) if m else 0
            base = os.path.basename(
                os.path.normpath(os.path.dirname(s) or "."))
            procs.append({"path": s, "rank": rank,
                          "label": f"{base}:r{rank}"})
    if not procs:
        raise ValueError("no telemetry streams to assemble")
    return procs


def _load_stream(proc: dict) -> None:
    """Read one stream in place: records, the session_start clock
    anchor, and absolute-time mapping. A stream missing its anchor
    (truncated head — not a sink-written file) is kept but marked
    unanchored; its records cannot land on the common clock and are
    excluded from the merged timeline."""
    records = [r for r in _iter_records(proc["path"])
               if isinstance(r, dict)]
    anchor = next(
        (r for r in records
         if r.get("kind") == "event"
         and r.get("name") == "session_start"), None)
    epoch_s = ((anchor.get("payload") or {}).get("epoch_s")
               if anchor else None)
    proc["records"] = records
    proc["epoch_s"] = epoch_s
    proc["anchored"] = epoch_s is not None
    proc["anchor_ts_us"] = (anchor.get("ts_us", 0.0)
                            if anchor else 0.0)


def _abs_us(proc: dict, rec: dict) -> Optional[float]:
    if not proc["anchored"]:
        return None
    ts = rec.get("ts_us")
    if ts is None:
        return None
    return (proc["epoch_s"] * 1e6
            + (float(ts) - proc["anchor_ts_us"]))


def assemble(paths, trace_id: Optional[str] = None) -> dict:
    """Merge the streams: the flat record list on the common clock,
    the span registry, the cross-process hop set, the skew bound,
    and the focus trace's tree + critical path. Pure function of the
    files — safe to run against a live (or killed) session."""
    procs = discover(paths)
    for proc in procs:
        _load_stream(proc)
    if not any(p["anchored"] for p in procs):
        raise ValueError(
            "no stream carries a session_start clock anchor — "
            "cannot place records on a common clock")

    merged = []          # (abs_us, pid, rec)
    span_owner = {}      # span_id -> (pid, abs_us, rec)
    traces: dict = {}    # trace_id -> aggregate
    for pid, proc in enumerate(procs):
        for rec in proc["records"]:
            if rec.get("kind") not in ("event", "span"):
                continue
            t = _abs_us(proc, rec)
            if t is None:
                continue
            merged.append((t, pid, rec))
            sid = rec.get("span_id")
            if sid is not None and sid not in span_owner:
                span_owner[sid] = (pid, t, rec)
            tid = rec.get("trace_id")
            if tid is not None:
                agg = traces.setdefault(tid, {
                    "spans": 0, "events": 0, "t0": t, "t1": t,
                    "procs": set()})
                agg["spans" if rec.get("kind") == "span"
                    else "events"] += 1
                agg["procs"].add(pid)
                end = t + float(rec.get("dur_us") or 0.0)
                agg["t0"] = min(agg["t0"], t)
                agg["t1"] = max(agg["t1"], end)
    merged.sort(key=lambda item: item[0])

    # Cross-process hops: a record whose parent span was recorded by
    # ANOTHER process is the receiver side of a wire hop (router
    # attempt -> replica request span, fan-out leg -> holder span...).
    hops = []
    seen = set()
    skew_bound_us = 0.0
    for t, pid, rec in merged:
        psid = rec.get("parent_span_id")
        if psid is None or psid not in span_owner:
            continue
        ppid, pt, _prec = span_owner[psid]
        if ppid == pid:
            continue
        key = (psid, rec.get("span_id"), pid)
        if key in seen:
            continue
        seen.add(key)
        hops.append({"parent_span_id": psid,
                     "span_id": rec.get("span_id"),
                     "trace_id": rec.get("trace_id"),
                     "from": ppid, "to": pid,
                     "t_from_us": pt, "t_to_us": t})
        # Causality bound: the receiver side cannot precede the
        # sender side; any inversion measures residual clock skew.
        skew_bound_us = max(skew_bound_us, pt - t)

    focus = trace_id
    if focus is None and traces:
        # Default focus: the trace touching the most processes (ties:
        # the one with the most spans) — in a fleet smoke, that's the
        # failover request crossing router + both replicas.
        focus = max(traces,
                    key=lambda k: (len(traces[k]["procs"]),
                                   traces[k]["spans"],
                                   traces[k]["events"]))
    tree, critical = _trace_tree(merged, focus)

    return {
        "procs": procs,
        "merged": merged,
        "span_owner": span_owner,
        "traces": traces,
        "hops": hops,
        "skew_bound_us": skew_bound_us,
        "focus_trace": focus,
        "tree": tree,
        "critical_path": critical,
    }


def _trace_tree(merged, trace_id):
    """The focus trace's causal tree: nodes are its records (span
    records carry duration; stamped instant events — attempt marks,
    link events — are zero-width nodes), edges follow
    parent_span_id. Returns (roots, critical_path): the critical
    path walks from the dominant root through, at each level, the
    child whose subtree SETTLES LAST — the blocking chain."""
    if trace_id is None:
        return [], []
    nodes = {}
    order = []
    for t, pid, rec in merged:
        if rec.get("trace_id") != trace_id:
            continue
        sid = rec.get("span_id")
        node = {"t": t, "pid": pid, "rec": rec, "children": [],
                "dur_us": float(rec.get("dur_us") or 0.0)}
        order.append(node)
        if sid is not None and sid not in nodes:
            nodes[sid] = node
    roots = []
    for node in order:
        psid = node["rec"].get("parent_span_id")
        parent = nodes.get(psid) if psid is not None else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)

    def settle(node):
        end = node["t"] + node["dur_us"]
        for c in node["children"]:
            end = max(end, settle(c))
        return end

    critical = []
    if roots:
        node = max(roots, key=settle)
        while node is not None:
            critical.append(node)
            node = max(node["children"], key=settle) \
                if node["children"] else None
    return roots, critical


def _fmt_node(node, asm, t0_us):
    rec = node["rec"]
    label = asm["procs"][node["pid"]]["label"]
    dur = (f" {node['dur_us'] / 1e3:9.3f}ms"
           if rec.get("kind") == "span" else "  " + 9 * "-" + "  ")
    return (f"+{(node['t'] - t0_us) / 1e3:10.3f}ms{dur}  "
            f"{label:<16} {rec.get('name')}")


def format_report(asm: dict) -> str:
    """The human rendering: per-process inventory, trace census, the
    focus trace's span tree (bounded) and its critical path."""
    out = ["fleet timeline"]
    for pid, proc in enumerate(asm["procs"]):
        n_span = sum(1 for r in proc["records"]
                     if r.get("kind") == "span")
        out.append(
            f"  [{pid}] {proc['label']:<16} "
            f"{len(proc['records']):5d} records "
            f"({n_span} spans)"
            + ("" if proc["anchored"] else "  UNANCHORED"))
    out.append(f"  traces: {len(asm['traces'])}   cross-process "
               f"hops: {len(asm['hops'])}   skew bound: "
               f"{asm['skew_bound_us'] / 1e3:.3f}ms")
    focus = asm["focus_trace"]
    if focus is None:
        out.append("  (no stamped trace records — nothing to walk)")
        return "\n".join(out)
    agg = asm["traces"][focus]
    out.append(
        f"\nfocus trace {focus} — {agg['spans']} spans / "
        f"{agg['events']} events across "
        f"{len(agg['procs'])} process(es), "
        f"{(agg['t1'] - agg['t0']) / 1e3:.3f}ms end to end")
    t0 = agg["t0"]
    shown = 0

    def walk(node, depth):
        nonlocal shown
        if shown >= MAX_TREE_NODES:
            return
        shown += 1
        out.append("  " + "  " * depth + _fmt_node(node, asm, t0))
        for c in sorted(node["children"], key=lambda n: n["t"]):
            walk(c, depth + 1)

    for root in sorted(asm["tree"], key=lambda n: n["t"]):
        walk(root, 0)
    if shown >= MAX_TREE_NODES:
        out.append(f"  ... tree truncated at {MAX_TREE_NODES} nodes "
                   "(full detail in the Perfetto file)")
    if asm["critical_path"]:
        out.append("\ncritical path (blocking chain, settles last):")
        for node in asm["critical_path"]:
            out.append("  " + _fmt_node(node, asm, t0))
    return "\n".join(out)


def write_perfetto(asm: dict, path: str) -> str:
    """The merged Chrome/Perfetto trace: one pid per process (named
    tracks), every anchored record as a slice (spans) or instant
    (events), and a flow arrow per cross-process hop — load in
    ui.perfetto.dev and the fleet's causal chains draw themselves."""
    evs = []
    for pid, proc in enumerate(asm["procs"]):
        evs.append({"name": "process_name", "ph": "M", "ts": 0,
                    "pid": pid, "args": {"name": proc["label"]}})
        evs.append({"name": "thread_name", "ph": "M", "ts": 0,
                    "pid": pid, "tid": proc["rank"],
                    "args": {"name": f"rank{proc['rank']}"}})
    for t, pid, rec in asm["merged"]:
        tid = asm["procs"][pid]["rank"]
        args = {k: rec[k] for k in ("request_id", "trace_id",
                                    "span_id", "parent_span_id")
                if k in rec}
        payload = rec.get("payload")
        if isinstance(payload, dict):
            for k, v in payload.items():
                args.setdefault(k, v)
        ev = {"name": rec.get("name", "?"), "ts": t, "pid": pid,
              "tid": tid, "args": args}
        if rec.get("kind") == "span":
            ev.update(ph="X", cat="span",
                      dur=float(rec.get("dur_us") or 0.0))
        else:
            ev.update(ph="i", cat="event", s="t")
        evs.append(ev)
    for k, hop in enumerate(asm["hops"]):
        common = {"name": "hop", "cat": "trace_hop", "id": k + 1}
        evs.append({**common, "ph": "s",
                    "ts": hop["t_from_us"], "pid": hop["from"],
                    "tid": asm["procs"][hop["from"]]["rank"]})
        evs.append({**common, "ph": "f", "bp": "e",
                    "ts": max(hop["t_to_us"], hop["t_from_us"]),
                    "pid": hop["to"],
                    "tid": asm["procs"][hop["to"]]["rank"]})
    doc = {"traceEvents": evs,
           "displayTimeUnit": "ms",
           "otherData": {"kind": KIND,
                         "schema_version": SCHEMA_VERSION}}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def as_record(asm: dict, trace_file: Optional[str] = None) -> dict:
    """The ``kind: "fleet_timeline"`` artifact (analyze check's
    schema): the assembly summarized to what CI asserts on — per-
    process inventory, trace census, hop count, skew bound, and the
    focus trace's critical path."""
    focus = asm["focus_trace"]
    agg = asm["traces"].get(focus) if focus else None
    t0 = agg["t0"] if agg else 0.0
    return {
        "schema_version": SCHEMA_VERSION,
        "kind": KIND,
        "processes": [
            {"label": p["label"], "rank": p["rank"],
             "path": p["path"], "anchored": p["anchored"],
             "epoch_s": p["epoch_s"],
             "records": len(p["records"])}
            for p in asm["procs"]],
        "n_spans": sum(a["spans"] for a in asm["traces"].values()),
        "n_events": sum(a["events"]
                        for a in asm["traces"].values()),
        "n_traces": len(asm["traces"]),
        "hops": len(asm["hops"]),
        "hop_detail": asm["hops"],
        "skew_bound_us": asm["skew_bound_us"],
        "focus_trace": focus,
        "focus_trace_processes": (sorted(agg["procs"])
                                  if agg else []),
        "critical_path": [
            {"proc": asm["procs"][n["pid"]]["label"],
             "name": n["rec"].get("name"),
             "kind": n["rec"].get("kind"),
             "t_ms": round((n["t"] - t0) / 1e3, 3),
             "dur_ms": round(n["dur_us"] / 1e3, 3),
             "span_id": n["rec"].get("span_id")}
            for n in asm["critical_path"]],
        "trace_file": trace_file,
    }


def trace_ids_for_request(asm: dict, request_id: str) -> set:
    """Every trace_id stamped on records carrying ``request_id`` —
    the continuity probe CI uses: a failed dispatch attempt and its
    failover retry carry the same request id, so their records must
    resolve to ONE trace id."""
    out = set()
    for _t, _pid, rec in asm["merged"]:
        if rec.get("request_id") == request_id \
                and rec.get("trace_id") is not None:
            out.add(rec["trace_id"])
    return out
