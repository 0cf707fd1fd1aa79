"""Telemetry: one host-side observability session for the port.

Port of ``distributed_join_tpu/telemetry/__init__.py`` (:65-272): one
process-global session with three parts:

- :mod:`.spans` — hierarchical host-side spans, each also a
  ``torch.profiler.record_function`` range (and an NVTX range on a card),
  so span names line up with the kernels of a ``--trace`` device trace;
  and phases (:func:`phase`), device-trace ranges alone, inside a span's
  work;
- :mod:`.export` — the :class:`~.export.TelemetrySink`: the JSONL event
  log, the Chrome trace with counter tracks, the rank-0 summary, and the
  ``torch.profiler`` device trace of ``--trace``;
- the readers that need no device: :mod:`.history` (the workload-history
  store of ``--history``), :mod:`.timeline` (one trace from the per-rank
  event logs) and the two signature helpers of :mod:`.baselines`.

- :mod:`.metrics` — the device metrics tape (``MetricsTape``,
  ``Metrics``): counters a join step keeps on the device and gathers
  once; :func:`emit_metrics` reads a block to the host after the timed
  region and folds it into the session. A join's ``with_metrics=None``
  resolves to the session's state.

- the stage profile (:mod:`.stageprof`): :func:`stage_profile` draws a
  ``stageprofile`` record into the session's Chrome trace as two tracks
  (the stages' measured walls, and their device counters) linked by
  flow events; the read side is :mod:`.analyze`.

The contract: **telemetry off changes nothing**. Until :func:`configure`
activates a session every function here is a no-op and :func:`span` and
:func:`phase` the shared ``nullcontext``. So is every call on a muted
thread (an emulated rank other than rank 0; :mod:`.spans`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

from distributed_join_tpu_torch.telemetry import spans as _spans
from distributed_join_tpu_torch.telemetry.export import TelemetrySink
from distributed_join_tpu_torch.telemetry.metrics import Metrics, MetricsTape

__all__ = [
    "Metrics", "MetricsTape", "TelemetrySink",
    "configure", "configure_from_args", "counter_add",
    "current_trace", "emit_metrics", "enabled", "event", "finalize",
    "maybe_start_device_trace", "phase", "phased", "refresh_rank",
    "request_scope", "session", "sink", "span", "span_complete",
    "stage_profile", "stop_device_trace", "summary",
]

_active: Optional[TelemetrySink] = None
_null = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a telemetry session is active."""
    return _active is not None


def sink() -> Optional[TelemetrySink]:
    return _active


def _recording() -> Optional[TelemetrySink]:
    """The sink, where this thread records (None when off or muted)."""
    return None if _spans.muted() else _active


def configure(out_dir: str, *, trace: bool = False,
              rank: Optional[int] = None) -> TelemetrySink:
    """Activate a session writing under ``out_dir``. ``trace`` arms the
    device trace, started later by :func:`maybe_start_device_trace`:
    under NCCL the profiler must not start before the handshake has
    chosen this process's card. Reconfiguring finalizes the previous
    session."""
    global _active
    if _active is not None:
        finalize()
    if rank is None:
        from distributed_join_tpu_torch.parallel.bootstrap import process_id

        rank = process_id()
    _active = TelemetrySink(out_dir, rank=rank, device_trace=trace)
    return _active


def configure_from_args(args) -> bool:
    """Driver seam: activate from ``--telemetry[=DIR]``, ``--trace``,
    ``--diagnose``, ``--history`` or ``--stage-profile``
    (``benchmarks.add_telemetry_args``). Any of the last four alone
    implies a session at the default directory: the diagnosis reads the
    session's files, a history entry wants its counter signature, and
    ``stageprofile.json`` lands in it. Returns whether a session was
    configured."""
    out_dir = getattr(args, "telemetry", None)
    trace = bool(getattr(args, "trace", False))
    if out_dir is None and (trace or getattr(args, "diagnose", False)
                            or getattr(args, "history", None)
                            or getattr(args, "stage_profile", None)):
        out_dir = "telemetry"
    if out_dir is None:
        return False
    configure(out_dir, trace=trace)
    return True


def maybe_start_device_trace() -> None:
    """Start the ``--trace`` device trace, once, after the handshake (the
    drivers call it from ``benchmarks.run_guarded``'s body). No-op
    without an armed session."""
    if _active is not None:
        _active.maybe_start_device_trace()


def stop_device_trace() -> Optional[str]:
    """Stop and export the device trace on the thread that started it;
    :func:`finalize` does so too. Returns its path, or None."""
    if _active is None:
        return None
    return _active.stop_device_trace()


def refresh_rank() -> None:
    """Rebind the sink's files to the process group's rank once the
    handshake is done. No-op without a session or when unchanged."""
    if _active is not None:
        from distributed_join_tpu_torch.parallel.bootstrap import process_id

        _active.rebind_rank(process_id())


def finalize() -> Optional[dict]:
    """Close the session: stop the device trace, write the Chrome trace
    and rank 0's summary, close the log. Returns the final summary (None
    when no session was active). Idempotent."""
    global _active
    if _active is None:
        return None
    s = _active
    _active = None
    return s.close()


@contextlib.contextmanager
def session(out_dir: str, *, trace: bool = False, rank: Optional[int] = None):
    """``with telemetry.session(d) as sink: ...`` — configured on entry,
    finalized on exit."""
    s = configure(out_dir, trace=trace, rank=rank)
    try:
        yield s
    finally:
        if _active is s:
            finalize()


def span(name: str, **payload):
    """Hierarchical span context manager (the shared nullcontext when off
    or muted). The handle supports ``note(**kv)`` and ``sync_on(tensor)``
    (:mod:`.spans`)."""
    s = _recording()
    if s is None:
        return _null
    return _spans.span_scope(s, name, payload or None)


def phase(name: str):
    """A named device-trace range inside a step's work (the shared
    nullcontext when off or muted): a ``record_function`` range where a
    profiler records this thread, and an NVTX range on a card, with no
    event, payload, stack entry or sync (:mod:`.spans`)."""
    if _recording() is None:
        return _null
    return _spans._device_range(name)


def phased(name: str):
    """Decorator: every call of the function runs inside
    :func:`phase` ``name`` (the port's entry points take ``entry``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with phase(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def span_complete(name: str, t0_perf: float, dur_s: float, **payload) -> None:
    """Record an already-measured interval as a completed span
    (``t0_perf`` a ``time.perf_counter()`` stamp)."""
    s = _recording()
    if s is not None:
        s.span_event(name, t0_perf, dur_s, payload=payload or None)


@contextlib.contextmanager
def request_scope(request_id: Optional[str],
                  trace: Optional[dict] = None):
    """Tag every event and span recorded inside the scope with a request
    id and, when ``trace`` carries a ``tracectx`` context, with its
    ``(trace_id, span_id, parent_span_id)``. The tags are sink-global,
    so the request's worker threads carry them too. No-op when off or
    both tags are None; nests (the previous tags come back on exit)."""
    s = _active
    if s is None or (request_id is None and trace is None):
        yield
        return
    prev = s.set_request_id(request_id) if request_id is not None \
        else None
    prev_trace = s.set_trace(trace) if trace is not None else None
    try:
        yield
    finally:
        if trace is not None:
            s.set_trace(prev_trace)
        if request_id is not None:
            s.set_request_id(prev)


def current_trace() -> Optional[dict]:
    """The trace context of the innermost active :func:`request_scope`
    (None when off or unset)."""
    if _active is None:
        return None
    return _active.current_trace()


def event(name: str, **payload) -> None:
    """Record an instant event (retry attempts, manifest writes, batch
    completion, watchdog timeouts...)."""
    s = _recording()
    if s is not None:
        s.event(name, payload=payload or None)


def counter_add(name: str, value) -> None:
    """Accumulate a host-side counter (``counters`` in the summary, a
    counter track in the Chrome trace)."""
    s = _recording()
    if s is not None:
        s.counter_add(name, value)


def emit_metrics(metrics: Optional[Metrics]) -> Optional[dict]:
    """Read a device :class:`~.metrics.Metrics` block to the host (one
    read, after the timed region) and fold it into the session's summary
    and event log (a ``metrics`` event with the reduced values). Returns
    the host dict (``Metrics.to_dict``); None passes."""
    if metrics is None:
        return None
    d = metrics.to_dict()
    if _active is not None:
        _active.set_metrics(d)
        _active.event("metrics", payload={"reduced": d["reduced"]})
    return d


def stage_profile(record: Optional[dict]) -> None:
    """Draw a stage-profile record (``stageprof.StageProfile.as_record``
    or ``QueryStageProfile.as_record``) into the session's Chrome trace:
    a track of the measured stages, a track of their device counters,
    and a flow from each stage to its counters (no-op when off)."""
    if _active is not None and record is not None:
        _active.add_stage_profile(record)


def summary() -> Optional[dict]:
    """The session summary drivers embed in their records (counters,
    span totals, file locations). None when off."""
    if _active is None:
        return None
    return _active.summary()
