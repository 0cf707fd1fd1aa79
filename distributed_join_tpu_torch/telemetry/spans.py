"""Hierarchical host-side span timer.

Port of ``distributed_join_tpu/telemetry/spans.py`` (:39-113). A span
measures a host-visible interval (a driver stage, a step's partition,
shuffle and join, an out-of-core batch's staging and fetch) and lands in
the session's event log and Chrome trace with its slash-joined path.

The one device seam: where the JAX package enters ``jax.named_scope``
and ``jax.profiler.TraceAnnotation``, a span here enters
``torch.profiler.record_function(name)`` while a profiler session
records the thread (the ``--trace`` device trace), and on a CUDA device
an NVTX range (``torch.cuda.nvtx.range_push``/``range_pop``), so that the
span names line up with the kernels in a ``--trace`` profile (and in
``nsys``).

Three differences from the JAX package, each on purpose:

- **When spans fire.** The JAX package's step spans run while the step
  is traced, once a compile. The port's steps are eager, so a step's
  spans fire on every call: one call on one rank gives the sequence of
  names, paths and payloads that one trace of the JAX step gives.
- **Which thread records.** Span nesting is per thread. Under the
  emulated communicator the ranks are threads: ``EmulatedCommunicator.
  spmd`` hands every rank thread the caller's span stack
  (:func:`adopted`) and mutes all ranks but rank 0, so a step's spans
  are recorded once a call, on rank 0's thread, under the caller's
  path. Under a process group every process records its own rank's
  spans into its own files. A muted thread records no span, event or
  counter.
- **What a duration means.** The port's kernel pipeline makes no host
  synchronisation (``ops/join.py``), so a span's duration is host time:
  the time to enqueue its work. The device's view is the ``--trace``
  profile. A span that should cover device completion registers one
  scalar with ``sp.sync_on(tensor)``; it is fetched at span close
  (:func:`fetch_one_scalar`), the one honest sync, as in the JAX
  package, at the JAX package's ``sync_on`` sites only.

**Phases** (``telemetry.phase(name)``) name the parts of a span's work
in a device trace: a step's span is as coarse as the JAX package's, and
the kernels of its merged sort, its run reductions or its hash passes
cannot be told apart inside it. A phase is :func:`_device_range` alone,
under an active session on a thread that records: no event-log
record, no payload, no entry on the span stack, no sync. So a span's
path, the event log and the Chrome trace are the same with phases as
without, and only a ``torch.profiler`` trace (or ``nsys``) shows them.
The phases of the port's hot path, and the ``sync.<site>`` ranges
around its blocking device-to-host reads (one synchronising call each),
are listed in ``PHASES.md`` beside this module.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional


def fetch_one_scalar(x):
    """Wait for the work that produced ``x`` by pulling exactly one
    element of it to the host (``.item()`` of its first element).
    Non-tensors pass through as Python numbers where they are one."""
    if hasattr(x, "reshape") and getattr(x, "ndim", 0):
        x = x.reshape(-1)[0]
    try:
        return x.item()
    except (AttributeError, ValueError, RuntimeError):
        return None


_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def muted() -> bool:
    """Whether this thread records nothing (an emulated rank other than
    rank 0)."""
    return getattr(_tls, "muted", False)


def thread_context() -> tuple:
    """The calling thread's span stack and mute flag, for a worker
    thread to take over with :func:`adopted`."""
    return tuple(_stack()), muted()


@contextmanager
def adopted(ctx: tuple, mute: bool = False):
    """Run the body with ``ctx`` (a :func:`thread_context`) as this
    thread's span stack, muted if ``ctx`` was or ``mute`` is set; the
    thread's own state is restored on exit."""
    stack, was_muted = ctx
    prev = getattr(_tls, "stack", None), muted()
    _tls.stack, _tls.muted = list(stack), was_muted or mute
    try:
        yield
    finally:
        _tls.stack, _tls.muted = prev


class Span:
    """The handle a span context yields: attach payload with
    ``note(**kv)``; register the completion scalar with
    ``sync_on(tensor)`` (fetched at close)."""

    __slots__ = ("name", "path", "payload", "t0", "_sync")

    def __init__(self, name: str, path: str, payload: Optional[dict]):
        self.name = name
        self.path = path
        self.payload = dict(payload) if payload else {}
        self.t0 = 0.0
        self._sync = None

    def note(self, **kv) -> None:
        self.payload.update(kv)

    def sync_on(self, scalar) -> None:
        self._sync = scalar


@contextmanager
def _device_range(name: str):
    """``record_function(name)`` where a ``torch.profiler`` session
    records this thread (elsewhere it records nothing and costs a
    dispatcher call), and on a CUDA device an NVTX range."""
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with (torch.profiler.record_function(name)
          if torch.autograd._profiler_enabled() else nullcontext()):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextmanager
def span_scope(sink, name: str, payload: Optional[dict] = None):
    """The active-session span behind ``telemetry.span`` (which returns
    a nullcontext when off or muted)."""
    stack = _stack()
    path = "/".join([*(s.name for s in stack), name])
    sp = Span(name, path, payload)
    stack.append(sp)
    err = None
    try:
        with _device_range(name):
            sp.t0 = time.perf_counter()
            try:
                yield sp
                if sp._sync is not None:
                    sp.payload["sync_value"] = fetch_one_scalar(sp._sync)
            except BaseException as exc:
                err = exc
                raise
    finally:
        dur = time.perf_counter() - sp.t0
        stack.pop()
        if err is not None:
            sp.payload["error"] = f"{type(err).__name__}: {err}"
        sink.span_event(name, sp.t0, dur, path=sp.path,
                        payload=sp.payload or None)
