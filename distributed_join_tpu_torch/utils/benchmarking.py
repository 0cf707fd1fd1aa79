"""Join timing discipline on the GPU.

Port of ``distributed_join_tpu/utils/benchmarking.py``
``consume_all_columns`` (:75) and ``timed_join_throughput`` (:100), plus
:func:`profile_join` and :func:`profile_calls`, where a join's (or a
query's) device time goes. One
warm-up run of the whole timed loop, then ``iters`` joins between two
CUDA events, with both sides' keys shifted by the loop counter (the
shift keeps the hit/miss structure — the generator's miss keys occupy a
disjoint range that shifts with the hits — while every iteration sorts
and hashes new values). Every output column is reduced into one device
scalar, and the host synchronises once, at the end: nothing inside a
join step reads a value back. Under a process group every rank starts
its interval after a barrier, and the time reported is the slowest
rank's, as one SPMD program's time is in the JAX package.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.table import Table


def consume_all_columns(table: Table) -> torch.Tensor:
    """Reduce every output column over the valid rows into one int64
    scalar, so no part of the result goes unmaterialised."""
    acc = torch.zeros((), dtype=torch.int64, device=table.device)
    for c in table.columns.values():
        if c.dtype.is_floating_point:
            c = c.to(torch.int32)
        if c.ndim > 1:  # string columns: every byte, not just byte 0
            c = c.reshape(c.shape[0], -1).to(torch.int32).sum(1)
        acc = acc + torch.where(table.valid, c.to(torch.int64),
                                torch.zeros_like(c, dtype=torch.int64)).sum()
    return acc


def timed_join_throughput(comm, step: Callable, build: Table, probe: Table,
                          iters: int, key="key"):
    """Time ``iters`` join steps; returns ``(sec_per_join,
    total_matches_per_join, overflow)``. On a CUDA device the interval
    is taken with CUDA events; on the CPU (rehearsals, gloo) with the
    host clock after the work. The interval is the largest over the
    job's processes."""
    shift_key = key if isinstance(key, str) else key[0]
    key_dtype = probe.columns[shift_key].dtype
    # A string key's bytes all shift (wrapping), as in the JAX package:
    # equal byte rows stay equal, and no other pair becomes equal.

    def looped(build, probe):
        dev = build.device
        total = torch.zeros((), dtype=torch.int64, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        consumed = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(iters):
            shift = i if not key_dtype.is_floating_point else float(i)
            bcols = dict(build.columns)
            bcols[shift_key] = bcols[shift_key] + shift
            pcols = dict(probe.columns)
            pcols[shift_key] = pcols[shift_key] + shift
            res = step(Table(bcols, build.valid), Table(pcols, probe.valid))
            total = total + res.total
            overflow = overflow | res.overflow
            consumed = consumed + consume_all_columns(res.table)
        return total, overflow, comm.psum(consumed)

    fn = comm.spmd(looped, sharded_out=(True, True, True))
    fn(build, probe)  # warm-up: kernel builds, allocator, caches
    on_gpu = build.device.type == "cuda"
    if on_gpu:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(build.device)
    comm.barrier()
    if on_gpu:
        start.record()
    t0 = time.perf_counter()
    total, overflow, consumed = fn(build, probe)
    if on_gpu:
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
    else:
        sec = time.perf_counter() - t0
    total, overflow = int(total), bool(overflow)
    int(consumed)
    telemetry.span_complete("timed_join", t0, sec, iters=iters,
                            per_iter_s=sec / iters)
    return comm.host_max(sec) / iters, total // iters, overflow


def profile_join(step: Callable, build: Table, probe: Table, joins: int = 3,
                 top: int = 15, record: bool = True) -> dict | None:
    """Where ``joins`` calls of ``step`` (after a warm-up call) spend
    their device time, by ``torch.profiler`` on a CUDA device: the top
    ``top`` device events by self time (ms per join), the device-busy
    total and the host wall time per join, whose ratio is the device's
    busy share. ``record=False`` (every rank of a process group but
    rank 0) makes the same calls unprofiled and returns None."""
    return profile_calls(lambda: step(build, probe), build.device, joins,
                         top, record)


def profile_calls(call: Callable, dev, joins: int = 3, top: int = 15,
                  record: bool = True) -> dict | None:
    """:func:`profile_join` of any ``call()`` whose result has ``total``
    and ``overflow`` (a join, or a whole query) on the CUDA device
    ``dev``."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize(dev)
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if record else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        for _ in range(joins):
            res = call()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if not record:
        return None
    # device-side events only (kernels, copies, sets): the host-side
    # aten:: events carry their kernels' time again
    rows = [(e.device_time_total / 1e3 / joins, e.key, e.count // joins)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    wall_ms = wall * 1e3 / joins
    return {
        "profile_joins": joins,
        "total": int(res.total),
        "overflow": bool(res.overflow),
        "device_busy_ms_per_join": busy,
        "host_wall_ms_per_join": wall_ms,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "top_kernels_ms_per_join": [
            {"name": k[:120], "ms": ms, "calls_per_join": c}
            for ms, k, c in rows[:top]],
    }
