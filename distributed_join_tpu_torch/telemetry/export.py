"""Telemetry export: JSONL event log + Chrome trace + summary.

Port of ``distributed_join_tpu/telemetry/export.py`` ``TelemetrySink``
(:59-437). One sink per process (rank). Files under the session
directory, each under the JAX package's name and in its format:

- ``events.rank<r>.jsonl`` — every event and span as one JSON line,
  appended and flushed as it happens (a killed run keeps its log);
- ``trace.rank<r>.json`` — Chrome trace-event format, loadable in
  Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``: spans as
  ``"ph": "X"`` complete events on a per-(rank, thread) track, instant
  events as ``"ph": "i"``, counters as ``"ph": "C"`` tracks of their
  running totals. Written at close.
- ``summary.json`` — rank 0 only: the session summary.
- the stage profile's two tracks in the Chrome trace
  (:meth:`TelemetrySink.add_stage_profile`): the measured stages and
  their device counters, linked by flow events.
- ``device_trace/trace.rank<r>.json`` — the device seam: where the JAX
  package writes an XLA profile under ``xla/``, ``--trace`` here runs a
  ``torch.profiler`` session (CPU and, on a card, CUDA activity) from
  :meth:`TelemetrySink.maybe_start_device_trace` to close, and exports
  it as a Chrome trace. The spans' ``record_function`` ranges
  (:mod:`.spans`) carry the span names in it, beside the kernels.

The summary and the event records keep every key the JAX package
writes; ``metrics`` is the last device metrics block folded in by
``telemetry.emit_metrics`` (None until one is), and a summary of a
session with a device trace also names its file (``device_trace_path``).

Timestamps are microseconds since the sink's origin (a ``perf_counter``
stamp taken at construction). Thread-safe: the out-of-core staging and
fetch workers log from their own threads.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Optional

# The JAX package's telemetry file-format version: the files are its
# format, and its readers (telemetry.analyze, timeline) read the port's.
TELEMETRY_FORMAT_VERSION = 1
# Chrome-trace events are buffered until close; past this many, further
# ones are counted as dropped (the JSONL log streams and is unaffected).
MAX_TRACE_EVENTS = 200_000
DEVICE_TRACE_DIR = "device_trace"


def _json_default(o):
    import numpy as np

    if isinstance(o, np.generic):
        return o.item()
    return str(o)


class TelemetrySink:
    """Collects events, spans and counters and writes the per-rank
    files. Use through the module-level ``telemetry`` API."""

    def __init__(self, out_dir: str, rank: int = 0,
                 device_trace: bool = False):
        self.dir = str(out_dir)
        self.rank = int(rank)
        os.makedirs(self.dir, exist_ok=True)
        self._origin = time.perf_counter()
        self._epoch = time.time()
        self._lock = threading.Lock()
        self._request_id: Optional[str] = None
        self._trace: Optional[dict] = None
        self._counters: dict = {}
        self._metrics: Optional[dict] = None
        self._span_stats: dict = {}
        self._trace_events: list = []
        self._dropped_trace_events = 0
        self._n_events = 0
        self._closed = False
        self._device_trace_armed = device_trace
        self._profiler = None
        self._profiler_thread = None
        self.device_trace_path: Optional[str] = None
        self.events_path = os.path.join(
            self.dir, f"events.rank{self.rank}.jsonl")
        self.trace_path = os.path.join(
            self.dir, f"trace.rank{self.rank}.json")
        self._log = open(self.events_path, "a", buffering=1)
        self.event("session_start", payload={
            "rank": self.rank, "epoch_s": self._epoch,
            "telemetry_format_version": TELEMETRY_FORMAT_VERSION,
        })

    # -- time base ----------------------------------------------------

    def _us(self, t_perf: Optional[float] = None) -> float:
        t = time.perf_counter() if t_perf is None else t_perf
        return (t - self._origin) * 1e6

    # -- recording ----------------------------------------------------

    def set_request_id(self, request_id: Optional[str]) -> Optional[str]:
        """Install the request correlation tag; every event and span
        recorded while it is set carries it. Sink-global, not
        thread-local, so that a request's worker threads carry it too.
        Returns the previous tag."""
        with self._lock:
            prev = self._request_id
            self._request_id = request_id
        return prev

    def set_trace(self, trace: Optional[dict]) -> Optional[dict]:
        """Install the distributed trace context (``tracectx`` dict);
        every record while it is set carries its three fields.
        Sink-global like the request id. Returns the previous one."""
        with self._lock:
            prev = self._trace
            self._trace = dict(trace) if trace else None
        return prev

    def current_trace(self) -> Optional[dict]:
        with self._lock:
            return dict(self._trace) if self._trace else None

    def _stamp_trace(self, rec: dict, args: dict) -> None:
        """Lock held: stamp the active trace context on one record.
        Payload-carried fields win (a link event names another span's
        ids); the scope fills the rest."""
        t = self._trace
        if t is None and "trace_id" not in args:
            return
        for k in ("trace_id", "span_id", "parent_span_id"):
            v = args.get(k, (t or {}).get(k))
            if v is not None:
                rec[k] = v
                args.setdefault(k, v)

    def _write_line(self, rec: dict) -> None:
        self._log.write(json.dumps(rec, default=_json_default) + "\n")

    def _push_trace(self, ev: dict) -> None:
        if len(self._trace_events) < MAX_TRACE_EVENTS:
            self._trace_events.append(ev)
        else:
            self._dropped_trace_events += 1

    def _tag(self, rec: dict, args: dict) -> None:
        """Lock held: the request id (a payload-carried one wins: an
        event fired outside a request's scope names its own) and the
        trace context."""
        rid = args.get("request_id", self._request_id)
        if rid is not None:
            rec["request_id"] = rid
            args.setdefault("request_id", rid)
        self._stamp_trace(rec, args)

    def event(self, name: str, payload: Optional[dict] = None) -> None:
        with self._lock:
            if self._closed:
                return
            self._n_events += 1
            rec = {"kind": "event", "name": name,
                   "ts_us": self._us(), "rank": self.rank,
                   "payload": payload}
            args = dict(payload or {})
            self._tag(rec, args)
            self._write_line(rec)
            self._push_trace({
                "name": name, "cat": "event", "ph": "i", "s": "t",
                "ts": self._us(), "pid": self.rank,
                "tid": threading.get_ident() % 2**31,
                "args": args,
            })

    def span_event(self, name: str, t0_perf: float, dur_s: float,
                   path: Optional[str] = None,
                   payload: Optional[dict] = None) -> None:
        """A completed span: ``t0_perf`` is its ``perf_counter`` start,
        ``dur_s`` its duration (the caller owns the timing)."""
        with self._lock:
            if self._closed:
                return
            self._n_events += 1
            rec = {"kind": "span", "name": name,
                   "path": path or name,
                   "ts_us": self._us(t0_perf),
                   "dur_us": dur_s * 1e6, "rank": self.rank,
                   "payload": payload}
            args = dict(payload or {}, path=path or name)
            self._tag(rec, args)
            self._write_line(rec)
            self._push_trace({
                "name": name, "cat": "span", "ph": "X",
                "ts": self._us(t0_perf), "dur": dur_s * 1e6,
                "pid": self.rank,
                "tid": threading.get_ident() % 2**31,
                "args": args,
            })
            st = self._span_stats.setdefault(
                path or name, {"count": 0, "total_s": 0.0})
            st["count"] += 1
            st["total_s"] += dur_s

    # the stage-profile tracks' thread ids: far from any real thread's
    _STAGEPROF_TID = 990001
    _STAGEPROF_COUNTER_TID = 990002

    def add_stage_profile(self, record: dict) -> None:
        """Draw a stage profile (``telemetry/stageprof.py``
        ``as_record()``; JAX :229-310) as two named tracks: the measured
        stages as back-to-back ``"X"`` slices of their median walls (the
        stages ran one after the other, barriered, so laid end to end
        they are the measured timeline), then the monolithic wall; and
        each stage's device-counter totals as a slice of a second track,
        linked from its stage by a flow (``"ph": "s"``/``"f"``). A query
        profile's operators draw in plan order."""
        from distributed_join_tpu_torch.telemetry.stageprof import (
            STAGE_KEYS,
        )

        stages = record.get("stages") or {}
        ordered = [s for s in STAGE_KEYS if s in stages]
        if not stages:
            stages = record.get("operators") or {}
            ordered = [o for o in (record.get("order") or [])
                       if o in stages]
        with self._lock:
            if self._closed:
                return
            base = self._us()
            tid, ctid = self._STAGEPROF_TID, self._STAGEPROF_COUNTER_TID
            for t, label in ((tid, "stage profile (measured)"),
                             (ctid, "stage profile (device counters)")):
                self._push_trace({
                    "name": "thread_name", "ph": "M", "ts": 0,
                    "pid": self.rank, "tid": t,
                    "args": {"name": label},
                })
            t_us = base
            for name in ordered:
                info = stages.get(name)
                if not isinstance(info, dict) or not info.get("ran"):
                    continue
                dur = max(float(info.get("wall_s") or 0.0), 0.0) * 1e6
                counters = info.get("counters") or {}
                args = {"predicted_s": info.get("predicted_s"),
                        "ratio": info.get("ratio"), **counters}
                self._push_trace({
                    "name": name, "cat": "stageprof", "ph": "X",
                    "ts": t_us, "dur": dur, "pid": self.rank,
                    "tid": tid, "args": args,
                })
                if counters:
                    fid = f"stageprof-{self.rank}-{name}"
                    mid = t_us + dur / 2
                    self._push_trace({
                        "name": "stage_counters", "cat": "stageprof",
                        "ph": "s", "id": fid, "ts": mid,
                        "pid": self.rank, "tid": tid,
                    })
                    self._push_trace({
                        "name": f"{name} counters",
                        "cat": "stageprof", "ph": "X", "ts": mid,
                        "dur": max(dur / 4, 1.0), "pid": self.rank,
                        "tid": ctid, "args": dict(counters),
                    })
                    self._push_trace({
                        "name": "stage_counters", "cat": "stageprof",
                        "ph": "f", "bp": "e", "id": fid, "ts": mid,
                        "pid": self.rank, "tid": ctid,
                    })
                t_us += dur
            mono = (record.get("monolithic") or {}).get("wall_s")
            if mono:
                self._push_trace({
                    "name": "monolithic", "cat": "stageprof",
                    "ph": "X", "ts": t_us,
                    "dur": float(mono) * 1e6, "pid": self.rank,
                    "tid": tid,
                    "args": {"overlap": record.get("overlap")},
                })

    def set_metrics(self, metrics_dict: dict) -> None:
        """Install the host-read device metrics block (``Metrics.to_dict``,
        already gathered over the ranks)."""
        with self._lock:
            self._metrics = metrics_dict

    def counter_add(self, name: str, value) -> None:
        with self._lock:
            if self._closed:
                return
            total = self._counters.get(name, 0) + value
            self._counters[name] = total
            # the running total as a counter track of the Chrome trace
            self._push_trace({
                "name": name, "cat": "counter", "ph": "C",
                "ts": self._us(), "pid": self.rank,
                "args": {"value": total},
            })

    def rebind_rank(self, rank: int) -> None:
        """Adopt the authoritative rank once the process group is up: a
        session configured before the handshake sees only the launch
        environment's rank. Renames the event log and restamps the
        buffered trace events (only session bookkeeping precedes the
        handshake)."""
        rank = int(rank)
        with self._lock:
            if rank == self.rank or self._closed:
                return
            old_events = self.events_path
            old_log = self._log
            self.rank = rank
            self.events_path = os.path.join(
                self.dir, f"events.rank{rank}.jsonl")
            self.trace_path = os.path.join(
                self.dir, f"trace.rank{rank}.json")
            for ev in self._trace_events:
                ev["pid"] = rank
        # file I/O outside the lock: rebinding happens in the
        # single-threaded start of a run
        old_log.close()
        try:
            os.replace(old_events, self.events_path)
        except OSError:
            pass  # another process owns the old name: start afresh
        log = open(self.events_path, "a", buffering=1)
        with self._lock:
            self._log = log

    # -- the device trace ---------------------------------------------

    def maybe_start_device_trace(self) -> None:
        """Start the armed ``torch.profiler`` session (CPU activity, and
        CUDA activity where a card is present), once. Start and stop it
        on one thread: the profiler records the operator ranges of the
        thread that started it."""
        if not self._device_trace_armed or self._profiler is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities)
            prof.start()
        except RuntimeError as exc:  # another profiler session is open
            warnings.warn(f"could not start the device trace: {exc}",
                          stacklevel=2)
            self._device_trace_armed = False
            return
        self._profiler = prof
        self._profiler_thread = threading.current_thread()

    def stop_device_trace(self) -> Optional[str]:
        """Stop the device trace and export it as a Chrome trace into
        the session directory; returns its path (None when none ran).
        Idempotent."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return self.device_trace_path
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        d = os.path.join(self.dir, DEVICE_TRACE_DIR)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace.rank{self.rank}.json")
        prof.export_chrome_trace(path)
        self.device_trace_path = path
        return path

    # -- summary + close ----------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            out = {
                "telemetry_format_version": TELEMETRY_FORMAT_VERSION,
                "rank": self.rank,
                "dir": self.dir,
                "events": self._n_events,
                "events_path": self.events_path,
                "trace_path": self.trace_path,
                "counters": dict(self._counters),
                "spans": {k: dict(v)
                          for k, v in self._span_stats.items()},
                "metrics": self._metrics,
            }
            if self._device_trace_armed:
                out["device_trace_path"] = self.device_trace_path
            return out

    def close(self) -> dict:
        """Stop the device trace, write the Chrome trace (and rank 0's
        summary.json), close the log; returns the final summary.
        Idempotent."""
        owner = self._profiler_thread
        if (self._profiler is not None and owner is not None
                and owner is not threading.current_thread()
                and owner.is_alive()):
            # its thread is still busy (a run past its guard deadline):
            # the session cannot be stopped from here, and is abandoned
            warnings.warn("the device trace's thread has not finished; "
                          "its trace is abandoned", stacklevel=2)
            self._profiler = None
        self.stop_device_trace()
        trace = None
        with self._lock:
            if not self._closed:
                self._closed = True
                trace = {
                    "displayTimeUnit": "ms",
                    "otherData": {
                        "rank": self.rank,
                        "telemetry_format_version": TELEMETRY_FORMAT_VERSION,
                        "epoch_s": self._epoch,
                        "dropped_events": self._dropped_trace_events,
                    },
                    "traceEvents": self._trace_events,
                }
                self._log.close()
        if trace is not None:
            # written outside the lock: once closed every writer bails
            tmp = self.trace_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(trace, f, default=_json_default)
            os.replace(tmp, self.trace_path)
        s = self.summary()
        if self.rank == 0:
            tmp = os.path.join(self.dir, "summary.json.tmp")
            with open(tmp, "w") as f:
                json.dump(s, f, indent=1, default=_json_default)
            os.replace(tmp, os.path.join(self.dir, "summary.json"))
        return s


def device_trace_kernels(path: str, range_name: str) -> dict:
    """Read a ``--trace`` device trace (a ``torch.profiler`` Chrome
    trace): for each CUDA kernel by name, ``{"launches": n, "inside":
    m}``, ``m`` of them launched inside a ``range_name`` span (a
    ``record_function`` range of the launching thread, matched through
    the launch's correlation id)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ranges: dict = {}     # (pid, tid) -> [(start, end)]
    launches: dict = {}   # correlation -> (pid, tid, ts)
    kernels = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation" and e.get("name") == range_name:
            ranges.setdefault((e.get("pid"), e.get("tid")), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launches[args["correlation"]] = (e.get("pid"), e.get("tid"),
                                             e["ts"])
        elif cat == "kernel":
            kernels.append((e.get("name"), args.get("correlation")))
    out: dict = {}
    for name, corr in kernels:
        rec = out.setdefault(name, {"launches": 0, "inside": 0})
        rec["launches"] += 1
        launch = launches.get(corr)
        if launch is not None and any(
                t0 <= launch[2] <= t1
                for t0, t1 in ranges.get(launch[:2], ())):
            rec["inside"] += 1
    return out
