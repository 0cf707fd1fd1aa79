"""Out-of-core key-range batching: joins of tables larger than a card.

Port of ``distributed_join_tpu/parallel/out_of_core.py``: the numpy hash
twins (``fmix64_np`` :33, ``hash_combine_np`` :45, ``fmix32_np`` :53,
``_hash_one_np`` :64, ``hash_columns_np`` :95), ``key_batch_ids`` (:104),
``batched_join_host`` (:138) and ``keyrange_batched_join`` (:618). The
host splits the key space into ``n_batches`` by the upper bits of the
key hash (the device routes buckets by its lower bits), so equal keys
share a batch on both sides; each batch pair runs through one
distributed join, and the batch totals sum.

The batch loop on a CUDA device (the JAX package's per-buffer readiness
has no torch counterpart, so each hand-over is explicit):

- a staging thread pads each batch's rows of this process
  (``Communicator.local_rows``) into **pinned** host buffers, a few
  sets used in rotation, and copies them with ``non_blocking=True`` on a
  copy stream of its own; a set is refilled only after the event of its
  last copy has fired. The join's stream waits on the copy's event, and
  the staged tensors are recorded on it (``record_stream``).
- after each dispatch the batch's ``total`` and ``overflow`` are copied
  into pinned host scalars and an event is recorded; a batch settles on
  that event, which does not wait for the batches queued after it.
- the fetch thread hands each result to ``on_batch_result`` on a D2H
  stream of its own that waits on the batch's event, so the consumer's
  copies do not queue behind the next batch's join.
- backpressure, as in the JAX package: before batch b + 1 is dispatched
  batch b - 1 is fetched and settled, which bounds the card to about
  three batches of inputs and two output blocks.

On the CPU the same loop runs with host tensors and no streams.

Telemetry (JAX :305-513): the phase seconds also accumulate as
``out_of_core.<phase>`` session counters (the ``stats`` keys unchanged),
each batch's staging and fetch run in ``stage`` and ``fetch`` spans
(``batch=``), and the loop records ``out_of_core_measured_window``,
``batch_complete`` and ``batch_failed`` events.

The watchdog (``batch_deadline_s``, JAX :418-490): each batch's settle
(the wait on its pinned total, and the warm-up's fetch) runs under
``watchdog.call_with_deadline``, which hands its worker the loop's
current CUDA stream; a batch that does not settle in time is a
``HangError`` batch failure under the loop's degradation contract. The
two worker pools are torn down by ``watchdog.shutdown_bounded``, so a
wedged worker cannot hang the interpreter's exit.

Wire integrity (``verify_integrity``, JAX :150-185, :324-450): the batch
program carries the shuffles' digests (``parallel/integrity.py``); its
metrics block is copied to pinned host memory beside the batch's total,
behind the same event, and checked on the fetch thread before the
consumer sees a row, and at the batch's settle. A mismatch is a batch
failure under the loop's contract: ``"raise"`` propagates the
``IntegrityError``, ``"continue"`` abandons the batch (its total is
never counted) and records it.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.parallel.communicator import (
    Communicator,
    ProcessGroupCommunicator,
)
from distributed_join_tpu_torch.parallel.distributed_join import (
    make_distributed_join,
)
from distributed_join_tpu_torch.parallel import integrity
from distributed_join_tpu_torch.parallel.faults import (
    JoinManifest,
    batch_config_fingerprint,
    retry_with_backoff,
)
from distributed_join_tpu_torch.parallel.watchdog import (
    call_with_deadline,
    shutdown_bounded,
)
from distributed_join_tpu_torch.table import Table

PINNED_SLOTS = 3  # pinned buffer sets: one copying, one staged, one free
PINNED_ALIGN = 512  # bytes: where each column starts in its set


def fmix64_np(x: np.ndarray) -> np.ndarray:
    """numpy Murmur3 64-bit finalizer, the constants of
    ``ops/hashing.fmix64``."""
    k = x.astype(np.uint64)
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xFF51AFD7ED558CCD)
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xC4CEB9FE1A85EC53)
    k ^= k >> np.uint64(33)
    return k


def hash_combine_np(seed: np.ndarray, h: np.ndarray) -> np.ndarray:
    """numpy ``ops/hashing.hash_combine``."""
    magic = np.uint64(0x9E3779B97F4A7C15)
    return seed ^ (h + magic + (seed << np.uint64(6)) + (seed >> np.uint64(2)))


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """numpy ``ops/hashing.fmix32``."""
    h = x.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _hash_one_np(col: np.ndarray) -> np.ndarray:
    """The JAX package's per-dtype host hash, bit for bit.

    Integer and float32 keys hash as the device does. float64 keys
    follow the JAX package's arithmetic decomposition with ``np.log2``
    and ``np.exp2``, which need not give the device hash's bits (the
    port's device hash decomposes with ``torch.frexp``): batching needs
    only that both sides of a key batch by the same host hash, which
    always holds."""
    dt = col.dtype
    if dt in (np.dtype(np.int64), np.dtype(np.uint64)):
        return fmix64_np(col)
    if dt in (np.dtype(t) for t in
              (np.int32, np.uint32, np.int16, np.uint16, np.int8, np.uint8)):
        return fmix32_np(col).astype(np.uint64)
    if dt == np.dtype(np.float64):
        a = np.abs(col)
        with np.errstate(divide="ignore"):
            e = np.where(a > 0, np.floor(np.log2(a)), 0.0)
        m = np.where(a > 0, a / np.exp2(e), 0.0)
        mi = (m * (2.0 ** 52)).astype(np.int64).astype(np.uint64)
        ebits = e.astype(np.int32) ^ (col < 0).astype(np.int32) << 30
        return hash_combine_np(fmix64_np(mi),
                               fmix32_np(ebits).astype(np.uint64))
    if dt == np.dtype(np.float32):
        return fmix32_np(col.view(np.uint32)).astype(np.uint64)
    raise TypeError(f"unhashable key dtype {dt}")


def hash_columns_np(cols) -> np.ndarray:
    """numpy ``ops/hashing.hash_columns``: a composite key batches by
    the combined hash."""
    acc = _hash_one_np(cols[0])
    for c in cols[1:]:
        acc = hash_combine_np(acc, _hash_one_np(c))
    return acc


def key_batch_ids(keys, n_batches: int) -> np.ndarray:
    """The batch of each row; ``keys`` is one array or a list of key
    columns. Bits 40 and up of a re-mixed hash: the device routes by
    ``hash % n_buckets`` (the low bits), so the two splits stay
    independent, and a key pair that joins shares a batch. (The re-mix
    matters for 32-bit keys, whose hash widens fmix32 and has no upper
    bits.)"""
    cols = keys if isinstance(keys, (list, tuple)) else [keys]
    h = fmix64_np(hash_columns_np([np.asarray(c) for c in cols]))
    return ((h >> np.uint64(40)) % np.uint64(n_batches)).astype(np.int64)


def _host_columns(table: Table) -> dict:
    mask = table.valid.cpu().numpy()
    return {n: c.cpu().numpy()[mask] for n, c in table.columns.items()}


def _loop_device(comm: Communicator, device) -> torch.device:
    """The device of this process's ranks: the rank's own under a
    process group, else ``device`` (default: the GPU)."""
    if device is None and isinstance(comm, ProcessGroupCommunicator):
        return comm.device
    return resolve_device(device)


class _Stager:
    """Pads this process's rows of each batch (``comm.local_rows`` of the
    batch capacity, zero-padded, valid = row < the batch's rows) and puts
    them on ``device``. Runs on the staging thread.

    On a CUDA device the rows go through ``PINNED_SLOTS`` sets of pinned
    buffers, used in rotation, copied on ``self.stream``. Before a set is
    refilled its last copy's event is waited on, and that copy's time on
    the stream is added to ``put_s``. ``stage`` returns the tables and
    the copy's event, which the join's stream must wait on. On the CPU
    the padded buffers are the tables."""

    def __init__(self, comm: Communicator, device: torch.device, caps,
                 phase_add: Callable):
        self.comm, self.device, self.caps = comm, device, caps
        self.phase_add = phase_add
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.compute = (torch.cuda.current_stream(device) if self.cuda
                        else None)
        self.slots = [None] * PINNED_SLOTS  # pinned buffers, by (side, col)
        self.pending = [None] * PINNED_SLOTS  # (start, end) of last copy
        self.next_slot = 0
        self.refills_waited = 0       # refills that found a copy in flight

    def _columns(self, cols: dict, cap: int):
        """``(name, shape, numpy dtype)`` of each staged column of a
        side, its validity last."""
        n = len(self.comm.local_rows(cap))
        return [(name, (n,) + c.shape[1:], c.dtype) for name, c in
                cols.items()] + [("#valid", (n,), np.dtype(bool))]

    def _pinned_set(self, build_cols: dict, probe_cols: dict) -> dict:
        """A set's pinned columns, as views by ``(side, name)``. torch's
        caching host allocator rounds each allocation up to a power of
        two, and what it pins costs host memory and, for the sets first
        filled in the loop, the pad's time: the set is one allocation or
        one a column, whichever pins fewer bytes."""
        cols = [((side, name), shape, dt, int(np.prod(shape)) * dt.itemsize)
                for side, cc, cap in (("b", build_cols, self.caps[0]),
                                      ("p", probe_cols, self.caps[1]))
                for name, shape, dt in self._columns(cc, cap)]

        def span(group):  # bytes of a group's columns, each aligned
            return max(sum(-(-c[3] // PINNED_ALIGN) * PINNED_ALIGN
                           for c in group), 1)

        def pinned(groups):
            return sum(1 << (span(g) - 1).bit_length() for g in groups)

        bufs = {}
        for group in min([cols], [[c] for c in cols], key=pinned):
            flat = torch.empty(span(group), dtype=torch.uint8,
                               pin_memory=True)
            off = 0
            for key, shape, dt, size in group:
                tdt = torch.from_numpy(np.empty(0, dt)).dtype
                bufs[key] = flat[off:off + size].view(tdt).view(shape)
                off += -(-size // PINNED_ALIGN) * PINNED_ALIGN
        return bufs

    def _pad(self, cols: dict, cap: int, bufs: Optional[dict], side: str):
        rows = self.comm.local_rows(cap)
        m = next(iter(cols.values())).shape[0]
        k = max(0, min(rows.stop, m) - rows.start)
        out = {}
        for (name, shape, dt), c in zip(self._columns(cols, cap),
                                        [*cols.values(), None]):
            if bufs is None:
                buf = torch.from_numpy(np.empty(shape, dt))
            else:
                buf = bufs[(side, name)]
            a = buf.numpy()
            if c is None:
                a[:k] = True
            else:
                a[:k] = c[rows.start:rows.start + k]
            a[k:] = 0
            out[name] = buf
        return out

    def stage(self, build_cols: dict, probe_cols: dict):
        t0 = time.perf_counter()
        if not self.cuda:
            bt = self._pad(build_cols, self.caps[0], None, "b")
            pt = self._pad(probe_cols, self.caps[1], None, "p")
            self.phase_add("pad_s", time.perf_counter() - t0)
            self.phase_add("put_s", 0.0)  # the padded buffers are the tables
            return _table(bt), _table(pt), None
        s = self.next_slot
        self.next_slot = (s + 1) % len(self.slots)
        if self.pending[s] is not None:
            start, end = self.pending[s]
            if not end.query():
                self.refills_waited += 1
            end.synchronize()  # never refill a buffer under a copy
            self.phase_add("put_s", start.elapsed_time(end) / 1e3)
            self.pending[s] = None
            t0 = time.perf_counter()
        if self.slots[s] is None:
            self.slots[s] = self._pinned_set(build_cols, probe_cols)
        host = [self._pad(build_cols, self.caps[0], self.slots[s], "b"),
                self._pad(probe_cols, self.caps[1], self.slots[s], "p")]
        self.phase_add("pad_s", time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            dev = [{n: t.to(self.device, non_blocking=True)
                    for n, t in side.items()} for side in host]
            end.record(self.stream)
        for side in dev:
            for t in side.values():
                t.record_stream(self.compute)
        self.pending[s] = (start, end)
        return _table(dev[0]), _table(dev[1]), end

    def close(self) -> None:
        """Add every outstanding copy's time to ``put_s``."""
        for s, ev in enumerate(self.pending):
            if ev is not None:
                ev[1].synchronize()
                self.phase_add("put_s", ev[0].elapsed_time(ev[1]) / 1e3)
                self.pending[s] = None


class _Scalars:
    """A batch's ``(total, overflow)`` on its way to the host, and with
    ``metrics`` (the integrity program's block) that block too. On a card
    they are copied into pinned host memory right after the dispatch,
    behind an event on the join's stream (``done``), and ``get`` and
    :meth:`metrics` wait on that event alone: not on the batches
    dispatched after it, as reading the device tensors would. On the CPU
    they are read at once."""

    def __init__(self, res, device: torch.device, metrics=None):
        self.done = None
        self._metrics = metrics
        if device.type != "cuda":
            self.host = (int(res.total), bool(res.overflow))
            return
        self.host = torch.empty(2, dtype=torch.int64, pin_memory=True)
        self.host.copy_(torch.stack([res.total.to(torch.int64),
                                     res.overflow.to(torch.int64)]),
                        non_blocking=True)
        if metrics is not None:
            block = torch.empty(metrics.values.shape, dtype=torch.int64,
                                pin_memory=True)
            block.copy_(metrics.values, non_blocking=True)
            self._metrics = dataclasses.replace(metrics, values=block)
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(device))

    def get(self) -> tuple:
        if self.done is None:
            return self.host
        self.done.synchronize()
        return int(self.host[0]), bool(self.host[1])

    def metrics(self):
        """The batch's metrics block, on the host once settled."""
        if self.done is not None:
            self.done.synchronize()
        return self._metrics


def _table(cols: dict) -> Table:
    valid = cols.pop("#valid")
    return Table(cols, valid)


def batched_join_host(
    build_batches,
    probe_batches,
    comm: Communicator,
    key: str = "key",
    warmup: bool = True,
    stats: Optional[dict] = None,
    on_batch_result: Optional[Callable] = None,
    manifest_path: Optional[str] = None,
    batch_retries: int = 0,
    batch_retry_backoff_s: float = 1.0,
    on_batch_failure: str = "raise",
    verify_integrity: bool = False,
    batch_deadline_s: Optional[float] = None,
    device=None,
    **join_opts,
) -> Tuple[int, bool]:
    """Join pre-binned HOST batches (lists of numpy column dicts, as
    ``utils/tpch_host.generate_tpch_host_batches`` makes them) through
    one distributed join, staging one batch ahead; returns
    ``(total matches, any overflow)``.

    Every batch runs at one capacity pair (the largest batch's rows,
    rounded up to the rank count), so a resumed run runs the same join.

    Failure semantics, as in the JAX package:

    - ``manifest_path``: a ``faults.JoinManifest``, rewritten atomically
      as each batch settles. A run invoked again with the same arguments
      resumes from the first incomplete batch, exactly; a batch recorded
      with overflow runs again (its rows were cut), and a manifest of
      another batching is refused (``ManifestMismatchError``).
    - ``batch_retries``: dispatch retries a batch, with exponential
      backoff from ``batch_retry_backoff_s``.
    - ``on_batch_failure``: ``"raise"`` (the default) propagates a
      batch's last failure; ``"continue"`` records it in
      ``stats['failed_batches']`` and the manifest's failure log and
      returns the PARTIAL total of the batches that completed.
    - ``batch_deadline_s``: each batch's settle (its total reaching the
      host) is bounded by the watchdog; a batch that does not settle in
      time fails with ``HangError`` under the same contract.
    - ``verify_integrity``: each batch's join carries the wire digests
      and is checked before the consumer sees its rows and at its
      settle (an overflowed batch is not checked). A mismatch is a batch
      failure under the same contract: ``"raise"`` propagates the
      ``integrity.IntegrityError``, ``"continue"`` abandons the batch (its
      total is NOT counted) and records it.

    ``stats`` receives ``elapsed_s`` (the loop after the warm-up,
    staging included), ``build_capacity``, ``probe_capacity``, the
    phase seconds ``pad_s`` (host pad), ``put_s`` (the H2D copies: on a
    card their time on the copy stream, by CUDA events), ``dispatch_s``
    (enqueueing the joins), ``fetch_s`` (the consumer, on the fetch
    thread) and ``fetch_wait_s`` (the main loop blocked on a fetch or a
    settle: what the overlap did not hide), and ``resumed_batches`` and
    ``failed_batches``. ``on_batch_result(batch, JoinResult)`` runs on
    the fetch thread, in batch order. With ``warmup`` batch 0 runs once
    first (kernel builds, allocator) and its staged tables are reused
    by the loop, whose phases start after it. ``device``: where the
    batches go (default: the rank's card under a process group, else
    the GPU)."""
    if len(build_batches) != len(probe_batches):
        raise ValueError("build/probe batch counts differ")
    if on_batch_failure not in ("raise", "continue"):
        raise ValueError(
            f"on_batch_failure must be 'raise' or 'continue', "
            f"got {on_batch_failure!r}")
    n_batches = len(build_batches)
    n = comm.n_ranks
    dev = _loop_device(comm, device)

    def _cap(batches):
        c = max(next(iter(b.values())).shape[0] for b in batches)
        return max(-(-c // n) * n, n)

    bcap, pcap = _cap(build_batches), _cap(probe_batches)

    manifest = None
    completed: dict = {}
    if manifest_path is not None:
        manifest = JoinManifest(
            manifest_path,
            batch_config_fingerprint(build_batches, probe_batches, n, key,
                                     bcap, pcap))
        # an overflowed batch's total is exact but its rows were cut, and
        # the natural resume (larger capacities, the same manifest) must
        # run it again
        completed = {b: v for b, v in manifest.completed.items()
                     if not v["overflow"]}
        if completed and on_batch_result is not None:
            warnings.warn(
                "resuming from a manifest: on_batch_result will not "
                f"be called for already-completed batches "
                f"{sorted(completed)} — the consumer's stream covers "
                "only batches run in THIS invocation, though the "
                "returned total covers all of them",
                stacklevel=2)
    pending = [b for b in range(n_batches) if b not in completed]
    failed: set = set()

    # each key is written by one thread: pad_s and put_s by the staging
    # thread, fetch_s by the fetch thread, the rest by this one
    phase = {"pad_s": 0.0, "put_s": 0.0, "dispatch_s": 0.0,
             "fetch_s": 0.0, "fetch_wait_s": 0.0}

    def _phase_add(k, dt):
        phase[k] += dt
        telemetry.counter_add("out_of_core." + k, dt)

    stager = _Stager(comm, dev, (bcap, pcap), _phase_add)

    def stage(b):
        with telemetry.span("stage", batch=b):
            return stager.stage(build_batches[b], probe_batches[b])

    def bounded(fn, what):
        """``fn()``, under the watchdog when a batch deadline is set."""
        if batch_deadline_s is None:
            return fn()
        return call_with_deadline(fn, batch_deadline_s, what=what)

    fn = make_distributed_join(comm, key=key, local_inputs=True,
                               with_integrity=verify_integrity, **join_opts)
    pool = ThreadPoolExecutor(max_workers=1)
    fetch_pool = ThreadPoolExecutor(max_workers=1)
    d2h = torch.cuda.Stream(dev) if stager.cuda else None
    # {pending index: IntegrityReport}, checked on the fetch thread and
    # reused by the settle, so each batch's digests are checked once
    reports: dict = {}

    def _verified(i) -> bool:
        """Whether pending[i]'s digests agree (an overflowed batch is not
        checked: a clamp drops rows by design)."""
        if i not in reports:
            sc = totals[i]
            if sc.get()[1]:
                return True
            reports[i] = integrity.verify_digests(sc.metrics())
        return reports[i].ok

    def _fetch(i, b, res, done):
        # on the fetch thread, in batch order; on a card its copies run on
        # the D2H stream, after the batch's join and nothing later
        if verify_integrity and not _verified(i):
            # a corrupt batch's rows never reach the consumer; its settle
            # fails it under the loop's contract
            telemetry.event("batch_integrity_mismatch", batch=b,
                            mismatches=len(reports[i].mismatches))
            return
        with telemetry.span("fetch", batch=b):
            tf = time.perf_counter()
            if d2h is None:
                on_batch_result(b, res)
            else:
                with torch.cuda.stream(d2h):
                    d2h.wait_event(done)
                    for t in [*res.table.columns.values(), res.table.valid,
                              res.total, res.overflow]:
                        t.record_stream(d2h)
                    on_batch_result(b, res)
            _phase_add("fetch_s", time.perf_counter() - tf)

    # the remaining budget of FAILED attempts a batch, shared by the
    # warm-up and the loop (a success is free)
    tries_left: dict = {}

    def _dispatch(b, bt, pt, ready):
        """``fn(bt, pt)`` under batch ``b``'s failure budget, with
        backoff between attempts; the JoinResult, or None when the batch
        is abandoned (``continue``, budget spent)."""
        if ready is not None:
            torch.cuda.current_stream(dev).wait_event(ready)
        last = None
        res = None
        tries_left.setdefault(b, batch_retries + 1)
        budget = tries_left[b]
        if budget > 0:
            try:
                res, attempts = retry_with_backoff(
                    lambda: fn(bt, pt), max_attempts=budget,
                    backoff_s=batch_retry_backoff_s)
            except Exception as exc:  # noqa: BLE001 - the retry seam
                last = exc
                attempts = getattr(exc, "_retry_attempts", [])
            fails = [a for a in attempts if a["error"] is not None]
            tries_left[b] -= len(fails)
            if manifest is not None:
                base = batch_retries + 1 - budget
                for k, a in enumerate(fails):
                    manifest.record_failure(b, a["error"], base + k)
            if res is not None:
                return res
        if on_batch_failure == "continue":
            failed.add(b)
            return None
        raise last

    def _settle(i):
        """Bring pending[i]'s total to the host (waiting on its event
        only) and record it in the manifest; a failure here is a batch
        failure too."""
        if not isinstance(totals[i], _Scalars):
            return
        b = pending[i]
        try:
            sc = totals[i]
            total, overflow = bounded(
                sc.get, f"out-of-core batch {b} result fetch")
            if verify_integrity and not _verified(i):
                # a corrupt batch's total never folds into the sum
                raise integrity.IntegrityError(reports[i])
            totals[i], overflows[i] = total, overflow
        except Exception as exc:  # noqa: BLE001 - the degradation seam
            if manifest is not None:
                manifest.record_failure(
                    b, f"{type(exc).__name__}: {exc}", batch_retries)
            if on_batch_failure != "continue":
                raise
            totals[i], overflows[i] = None, None
            failed.add(b)
            telemetry.event("batch_failed", batch=b,
                            error=f"{type(exc).__name__}: {exc}")
            return
        telemetry.event("batch_complete", batch=b, total=totals[i],
                        overflow=overflows[i])
        if manifest is not None:
            manifest.record_batch(b, totals[i], overflows[i])

    nxt = None
    try:
        if warmup and pending:
            nxt = stage(pending[0])
            # the warm-up runs under the loop's retry and degradation
            # contract and shares its attempt budget; its result is
            # dropped, its staged tables are the loop's first batch
            res = _dispatch(pending[0], *nxt)
            if res is not None:
                try:
                    bounded(lambda: int(res.total),
                            "out-of-core warmup result fetch")
                except Exception as exc:  # noqa: BLE001 - as _settle
                    if manifest is not None:
                        manifest.record_failure(
                            pending[0], f"{type(exc).__name__}: {exc}",
                            batch_retries)
                    if on_batch_failure != "continue":
                        raise
                    failed.add(pending[0])
            del res

        # the phases cover the measured window only (the session's
        # counters cover the whole run; the event marks where the window
        # starts)
        stager.close()
        for k_ in phase:
            phase[k_] = 0.0
        telemetry.event("out_of_core_measured_window",
                        n_batches=n_batches, pending=len(pending),
                        resumed=sorted(completed))
        t0 = time.perf_counter()
        fut = None
        if pending:
            fut = (pool.submit(lambda: nxt) if nxt is not None
                   else pool.submit(stage, pending[0]))
        # aligned with `pending`: totals[i] is the batch's _Scalars until
        # _settle(i) makes it an int, None for an abandoned batch
        totals, overflows, fetch_futs = [], [], []
        for i, b in enumerate(pending):
            bt, pt, ready = fut.result()
            td = time.perf_counter()
            res = _dispatch(b, bt, pt, ready)
            if res is not None:
                # a batch failed at the warm-up's fetch that this
                # dispatch recovered is counted
                failed.discard(b)
            sc = None if res is None else _Scalars(
                res, dev, res.telemetry if verify_integrity else None)
            _phase_add("dispatch_s", time.perf_counter() - td)
            totals.append(sc)
            overflows.append(None)
            fetch_futs.append(
                fetch_pool.submit(_fetch, i, b, res, sc.done)
                if (on_batch_result is not None and res is not None)
                else None)
            del bt, pt, res
            if i + 1 < len(pending):
                # stage the next batch while this one computes
                fut = pool.submit(stage, pending[i + 1])
                if i >= 1:
                    # backpressure: batch i-1 fetched and settled before
                    # a third batch's buffers exist
                    tf = time.perf_counter()
                    if fetch_futs[i - 1] is not None:
                        fetch_futs[i - 1].result()
                    _settle(i - 1)
                    _phase_add("fetch_wait_s", time.perf_counter() - tf)
        tf = time.perf_counter()
        for f in fetch_futs:
            if f is not None:
                f.result()  # drain, and surface the consumer's errors
        for i in range(len(pending)):
            _settle(i)
        total = sum(t for t in totals if t is not None)
        overflow = any(bool(o) for o in overflows if o is not None)
        _phase_add("fetch_wait_s", time.perf_counter() - tf)
        stager.close()
    finally:
        # bounded: a worker wedged in a dead device call must not hang
        # the interpreter's exit
        shutdown_bounded(pool, "out_of_core.stage")
        shutdown_bounded(fetch_pool, "out_of_core.fetch")
    # the batches a previous run completed (no overflow among them)
    total += sum(v["total"] for v in completed.values())
    if failed and stats is None:
        warnings.warn(
            f"on_batch_failure='continue': batches {sorted(failed)} "
            "were abandoned and the returned total is PARTIAL — pass "
            "a stats dict to receive failed_batches programmatically",
            stacklevel=2)
    if stats is not None:
        stats["elapsed_s"] = time.perf_counter() - t0
        stats["build_capacity"] = bcap
        stats["probe_capacity"] = pcap
        stats["resumed_batches"] = sorted(completed)
        stats["failed_batches"] = sorted(failed)
        stats.update(phase)
    return total, overflow


def keyrange_batched_join(
    build: Table,
    probe: Table,
    comm: Communicator,
    key: str = "key",
    n_batches: int = 4,
    on_batch_result: Optional[Callable] = None,
    warmup: bool = True,
    stats: Optional[dict] = None,
    manifest_path: Optional[str] = None,
    batch_retries: int = 0,
    batch_retry_backoff_s: float = 1.0,
    on_batch_failure: str = "raise",
    verify_integrity: bool = False,
    batch_deadline_s: Optional[float] = None,
    device=None,
    **join_opts,
) -> Tuple[int, bool]:
    """Join two tables in ``n_batches`` key-range pieces; returns
    ``(total matches, any overflow)``. The valid rows come to the host,
    are binned by ``key_batch_ids`` (deterministic, so a resumed run
    rebuilds the same batches) and go through :func:`batched_join_host`
    with its arguments. ``device`` defaults to the tables' device."""
    keys = [key] if isinstance(key, str) else list(key)
    hb, hp = _host_columns(build), _host_columns(probe)
    bb = key_batch_ids([hb[k] for k in keys], n_batches)
    pb = key_batch_ids([hp[k] for k in keys], n_batches)

    def _bin(cols, ids):
        # column by column, each source column released once binned: the
        # host holds one column besides the batches, not a second copy
        # (int32 indices below 2^31 rows)
        idx_dt = np.int32 if len(ids) < 2**31 else np.int64
        idx = [np.flatnonzero(ids == b).astype(idx_dt)
               for b in range(n_batches)]
        out = [{} for _ in range(n_batches)]
        for nm in list(cols):
            c = cols.pop(nm)
            for b in range(n_batches):
                out[b][nm] = c[idx[b]]
        return out

    return batched_join_host(
        _bin(hb, bb), _bin(hp, pb), comm, key=key,
        warmup=warmup, stats=stats, on_batch_result=on_batch_result,
        manifest_path=manifest_path, batch_retries=batch_retries,
        batch_retry_backoff_s=batch_retry_backoff_s,
        on_batch_failure=on_batch_failure,
        verify_integrity=verify_integrity,
        batch_deadline_s=batch_deadline_s,
        device=build.device if device is None else device,
        **join_opts)
