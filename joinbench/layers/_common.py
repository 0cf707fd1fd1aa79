"""Helpers the per-layer readers share (not a metric: no entry of
``BENCHMARK.json`` names it)."""

import re


def per_op_mean(ctx, fn):
    """The mean over the traced ranks of ``fn(trace) / n_ops``, or None
    where no rank's ``fn`` found anything (``fn`` returns None then)."""
    vals = []
    for t in ctx.traces:
        v = fn(t)
        if v is not None:
            vals.append(v / t["n_ops"])
    return sum(vals) / len(vals) if vals else None


def span_ms(name):
    """Device ms launched inside spans ``name`` of one rank's trace."""
    def fn(t):
        s = t["span_device_s"].get(name)
        return None if s is None else s * 1e3
    return fn


def kernel_ms(patterns, spans=None):
    """Device ms of the events whose name matches one of ``patterns``;
    with ``spans``, only those launched inside one of these spans."""
    rx = [re.compile(p) for p in patterns]

    def named(n):
        return any(r.search(n) for r in rx)

    def fn(t):
        if spans is None:
            hits = [s for n, s in t["kernel_s"].items() if named(n)]
        else:
            hits = [s for sp, n, s in t["span_kernel_s"]
                    if named(n) and set(sp) & set(spans)]
        return sum(hits) * 1e3 if hits else None
    return fn
