"""The reduction of one rank's ``torch.profiler`` trace (its exported
Chrome trace) to the numbers the per-layer readers take.

- **Device events**: ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  events. Each is tied to the host call that launched it
  (``cuda_runtime`` or ``cuda_driver`` events) by its ``correlation``
  id, and so to the spans (``user_annotation`` ranges: the port's
  ``record_function`` spans and the harness's ``joinbench.op``) open on
  the launching thread at the launch.
- **Window**: from the start of the first ``joinbench.op`` range to the
  end of the last; each op range ends after a device synchronise.
- **Busy**: the union of the device events' intervals inside the
  window, never their sum; idle is the rest of the window.
- **Idle gaps**: each named by the innermost host range (a span, an
  ``aten`` op or the op itself) open at the gap's midpoint.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

OP_RANGE = "joinbench.op"
# The spans of the port's steps (``parallel/distributed_join.py``) that
# device time is attributed to.
PORT_SPANS = ("skew", "partition", "shuffle", "join", "join_agg",
              "agg_combine", "partials_exchange")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")
TOP = 10
GAPS_NAMED = 200
NAME_CHARS = 120      # a name in the breakdown, cut to this length


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Ranges:
    """Host ranges of one thread, for 'which are open at time t'."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: r[0])
        self.starts = [r[0] for r in self.ranges]

    def open_at(self, t):
        i = bisect.bisect_right(self.starts, t)
        return [r for r in self.ranges[:i] if r[1] >= t]


def reduce_events(events: list, span_names=PORT_SPANS) -> dict:
    """The numbers of one rank's trace (a list of Chrome trace events).
    Times in the result are in seconds (the trace's are microseconds).

    ``span_device_s``: device seconds of the events launched inside each
    span of ``span_names`` (an event counts once a name, at any depth);
    ``kernel_s``: device seconds and launches by event name;
    ``span_kernel_s``: ``[spans, name, seconds]``, device seconds by event
    name and the set of those spans open at its launch (each event once);
    ``busy_s``, ``window_s``, ``n_ops`` (op ranges in the window);
    ``device_ops``: the names that took most device time;
    ``idle_gaps``: the longest gaps (the ``GAPS_NAMED`` longest, summed)
    by the host range they fell in."""
    ops, launches, host = [], {}, defaultdict(list)
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", ""),
                        (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat in HOST_CATS:
            host[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
            if e.get("name") == OP_RANGE:
                ops.append((ts, ts + dur, e.get("tid")))
    if not ops:
        return {"n_ops": 0}
    w0, w1 = min(o[0] for o in ops), max(o[1] for o in ops)
    names = set(span_names)
    spans = {tid: _Ranges([r for r in rs if r[2] in names])
             for tid, rs in host.items()}
    span_s = defaultdict(float)
    span_kernel = defaultdict(float)
    kernel_s = defaultdict(float)
    kernel_n = defaultdict(int)
    inside = []
    for a, b, name, corr in dev:
        if b <= w0 or a >= w1:
            continue
        inside.append((max(a, w0), min(b, w1)))
        kernel_s[name] += (b - a) * 1e-6
        kernel_n[name] += 1
        launch = launches.get(corr)
        open_spans = () if launch is None or launch[0] not in spans else \
            tuple(sorted({r[2] for r in spans[launch[0]].open_at(launch[1])}))
        span_kernel[(open_spans, name)] += (b - a) * 1e-6
        for s in open_spans:
            span_s[s] += (b - a) * 1e-6
    busy = _union(inside)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    # the longest gaps, each named by the innermost host range open at
    # its midpoint on the thread that issued the ops
    host_ranges = _Ranges(host.get(ops[0][2], []))
    gap_by = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        rs = host_ranges.open_at((a + b) / 2)
        inner = min(rs, key=lambda r: r[1] - r[0])[2] if rs else "no host range"
        gap_by[inner] += (b - a) * 1e-6
    device_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gap_by.items(), key=lambda kv: -kv[1])[:TOP]
    return {"n_ops": len(ops), "window_s": (w1 - w0) * 1e-6,
            "busy_s": busy_s, "span_device_s": dict(span_s),
            "span_kernel_s": [[list(sp), n, v]
                              for (sp, n), v in span_kernel.items()],
            "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
            "device_ops": [[k[:NAME_CHARS], v] for k, v in device_ops],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in idle]}


def reduce_file(path, span_names=PORT_SPANS) -> dict:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return reduce_events(events, span_names)
