"""Distributed trace context — the causal key of the fleet trace plane.

Port of ``distributed_join_tpu/telemetry/tracectx.py`` (:57-161), copied
whole: plain host-side string bookkeeping, the same ids and wire shape,
so a context one package mints the other adopts.

A trace context is three strings:

- ``trace_id`` — one per LOGICAL request, minted exactly once (by the
  outermost client: the smoke/``--watch`` console, ``ServiceClient``,
  or the fleet router when the wire carried none) and carried
  UNCHANGED across every hop, retry, failover, fan-out leg, rebuild
  replay, and HA-takeover resend of that request;
- ``span_id`` — one per UNIT OF WORK (a client send, a router dispatch
  attempt, a replica-side request, a fan-out leg). Every process mints
  its own span id and stamps it on every telemetry record it emits
  while working on the request;
- ``parent_span_id`` — the span id of the hop that CAUSED this one
  (None at the root). The parent/child edges are what
  ``telemetry/timeline.py`` follows to draw flow arrows across
  process-track boundaries and to walk the cross-process critical
  path.

On the wire the context rides as one ``"trace"`` field::

    {"trace": {"trace_id": "...", "span_id": "..."}}

The RECEIVER treats the carried ``span_id`` as its parent and mints a
fresh span id for its own work (:func:`child_of_wire`); responses echo
``{"trace": {...}}`` so clients can log the correlation without
grepping server files.

Client-minted trace ids are honored end to end under the same
cap/alias rule as request ids (the prefix+sha256 scheme,
:func:`cap_id`): two long ids sharing a 64-char prefix must stay
distinct, because the timeline groups everything by ``trace_id``.

Everything here is plain host-side string bookkeeping — no telemetry
session required, nothing touches compiled programs. With telemetry
OFF the context still rides the wire (it is one small dict per
request, far off the hot path) so a telemetry-enabled process can
join a trace started by a telemetry-off client.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

# Wire/JSONL field names, in one place so the writer (export.py), the
# wire layers (service/server.py, service/fleet.py) and the reader
# (timeline.py and the JAX package's analyze.py) can never drift apart.
TRACE_FIELD = "trace"
TRACE_KEYS = ("trace_id", "span_id", "parent_span_id")
# Ids longer than this are capped (prefix + sha256 tail) — the same
# bound request ids use, so one grep pattern covers both.
MAX_ID_LEN = 64


def cap_id(raw) -> str:
    """Cap a client-supplied id at :data:`MAX_ID_LEN` WITHOUT
    aliasing (the request-id scheme of ``JoinService._mint_request_
    id``): two long ids sharing a 64-char prefix must stay distinct,
    because flight records, history lines, and the fleet timeline all
    group by the capped value."""
    s = str(raw)
    if len(s) <= MAX_ID_LEN:
        return s
    return s[:48] + "-" + hashlib.sha256(s.encode()).hexdigest()[:15]


def new_trace_id() -> str:
    """Mint a fresh trace id (random 128-bit hex, ``t-`` prefixed so a
    minted id is visually distinct from a client-supplied one)."""
    return "t-" + os.urandom(16).hex()


def new_span_id() -> str:
    """Mint a fresh span id (random 64-bit hex)."""
    return os.urandom(8).hex()


def mint(trace_id=None) -> dict:
    """A ROOT context: fresh trace id (or the capped client-supplied
    one) and a fresh root span with no parent."""
    return {
        "trace_id": cap_id(trace_id) if trace_id else new_trace_id(),
        "span_id": new_span_id(),
        "parent_span_id": None,
    }


def child(ctx: Optional[dict]) -> Optional[dict]:
    """A child context INSIDE the same process: same trace, fresh span
    id, parented on ``ctx``'s span (a router dispatch attempt under
    the dispatch root, a fan-out leg under the fan-out). None in, None
    out."""
    if not ctx or not ctx.get("trace_id"):
        return None
    return {
        "trace_id": ctx["trace_id"],
        "span_id": new_span_id(),
        "parent_span_id": ctx.get("span_id"),
    }


def from_wire(req) -> Optional[dict]:
    """Parse (and sanitize) the ``"trace"`` field of a wire request.
    Returns None when absent/malformed — a trace-less request is
    legal, tracing is always optional."""
    t = req.get(TRACE_FIELD) if isinstance(req, dict) else None
    if not isinstance(t, dict) or not t.get("trace_id"):
        return None
    return {
        "trace_id": cap_id(t["trace_id"]),
        "span_id": (cap_id(t["span_id"])
                    if t.get("span_id") else None),
        "parent_span_id": (cap_id(t["parent_span_id"])
                           if t.get("parent_span_id") else None),
    }


def child_of_wire(req) -> Optional[dict]:
    """The RECEIVER's context for a wire request: same trace, fresh
    span, parented on the SENDER's carried span id (the cross-process
    edge the timeline's flow arrows follow). None when the request
    carries no trace."""
    ctx = from_wire(req)
    if ctx is None:
        return None
    return {
        "trace_id": ctx["trace_id"],
        "span_id": new_span_id(),
        "parent_span_id": ctx["span_id"],
    }


def to_wire(ctx: Optional[dict]) -> Optional[dict]:
    """The dict a SENDER attaches as the request's ``"trace"`` field:
    trace id + this hop's span id (the receiver's parent). The
    sender's own parent edge stays in the sender's records — the wire
    carries only what the receiver needs."""
    if not ctx or not ctx.get("trace_id"):
        return None
    return {"trace_id": ctx["trace_id"], "span_id": ctx.get("span_id")}


def attach(req: dict, ctx: Optional[dict]) -> dict:
    """A COPY of ``req`` with ``ctx`` attached as its wire trace field
    (the original is never mutated — a retry must not see a previous
    attempt's span id). No-op passthrough when ``ctx`` is None."""
    wire = to_wire(ctx)
    if wire is None:
        return req
    return {**req, TRACE_FIELD: wire}


def stamp(ctx: Optional[dict]) -> dict:
    """The three-field stamp flight records and history entries carry
    (``{}`` when no context, so callers can ``**stamp(ctx)`` or store
    ``stamp(ctx) or None``)."""
    if not ctx or not ctx.get("trace_id"):
        return {}
    return {k: ctx.get(k) for k in TRACE_KEYS}
