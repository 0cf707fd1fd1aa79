"""One rank's run: set-up, warm-up, then either the measured window
(``--trace 0``) or a short traced stretch (``--trace 1``), the check, and
the rank's report.

The loop is closed: one client issues an operation, waits until the
entry has returned and the device is synchronised, and issues the next.
Under a process group every rank issues the same operations; rank 0
decides when the window has closed and tells the others, after each
operation, by a one-element broadcast.
"""

from __future__ import annotations

import gc
import random
import time

import torch
import torch.distributed as dist

from joinbench.harness import spec as spec_mod
from joinbench.harness.collective import RankContext, gather
from joinbench.harness.trace import OP_RANGE, reduce_file
from joinbench.reference.imports import forbidden_loaded


def _sync(ctx: RankContext) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _barrier(ctx: RankContext) -> None:
    if ctx.distributed:
        if ctx.device.type == "cuda":
            dist.barrier(device_ids=[ctx.device.index])
        else:
            dist.barrier()
    _sync(ctx)


def _stop(ctx: RankContext, stop: bool) -> bool:
    """Rank 0's decision, on every rank."""
    if not ctx.distributed:
        return stop
    flag = torch.tensor([1 if stop else 0], dtype=torch.int32,
                        device=ctx.device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def sample_indices(seed: int, first: int) -> set:
    """The results kept for the check besides the last: one drawn from
    the seed among the first ``first`` operations."""
    return {random.Random(seed).randrange(max(first, 1))}


def _peak(ctx: RankContext) -> int:
    if ctx.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(ctx.device))


def _reset_peak(ctx: RankContext) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)


class _Ops:
    """The operations of the window or the traced stretch: each one's
    latency, failure and retries, and the sampled results' kept parts
    (``lost``: sampled operations that raised, whose answer never
    came)."""

    def __init__(self, system, ctx: RankContext, keep_at: set):
        self.system, self.ctx, self.keep_at = system, ctx, keep_at
        self.lat, self.retries, self.failed = [], [], 0
        self.kept, self.lost = [], 0

    def issue(self):
        """Run one operation to completion: ``(result or None, t_done)``."""
        t_a = time.perf_counter()
        try:
            res = self.system.op()
            _sync(self.ctx)
        except Exception:
            if self.ctx.distributed:
                raise
            res = None
        t_b = time.perf_counter()
        self.lat.append(t_b - t_a)
        if res is None:
            self.failed += 1
            self.retries.append(0)
        else:
            failed, retries = self.system.outcome(res)
            self.failed += int(failed)
            self.retries.append(retries)
        return res, t_b

    def settle(self, res, last: bool) -> None:
        """Keep what the check needs of a sampled (or the last) result."""
        if (len(self.lat) - 1) in self.keep_at or last:
            if res is None:
                self.lost += 1
            else:
                self.kept.append(self.system.keep(res))


def measure_window(system, ctx: RankContext, seconds: float,
                   keep_at: set) -> tuple:
    """The closed loop for ``seconds``: ``(ops, window_s)``, the window
    closing at the completion of the operation that reached it."""
    ops = _Ops(system, ctx, keep_at)
    start = time.perf_counter()
    while True:
        res, t = ops.issue()
        stop = _stop(ctx, t - start >= seconds)
        ops.settle(res, last=stop)
        res = None
        if stop:
            return ops, t - start


def warm_up(system, ctx: RankContext, n: int, phases: dict, t0: float):
    for i in range(n):
        system.op()
        _sync(ctx)
        phases[f"warmup{i}"] = time.perf_counter() - t0


def release(system, ctx: RankContext) -> None:
    """Drop the program's state before the reference runs."""
    system.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def run_rank(ctx: RankContext, cell: spec_mod.Cell, *, seed: int,
             seconds: float, trace: bool, t0: float) -> list:
    """Every rank's report (this rank's among them): what rank 0 needs to
    print the line."""
    traffic = cell.traffic
    phases = {"group": time.perf_counter() - t0}
    system = spec_mod.system_class(cell)(cell.config, traffic, ctx)
    system.setup(seed)
    _sync(ctx)
    phases["inputs"] = time.perf_counter() - t0
    if trace:
        from distributed_join_tpu_torch import telemetry

        telemetry.configure(str(ctx.tmpdir / "telemetry"), rank=ctx.rank)
    warm_up(system, ctx, int(traffic["warmup_ops"]), phases, t0)
    setup_peak = _peak(ctx)
    _barrier(ctx)
    _reset_peak(ctx)
    report = {"rank": ctx.rank, "setup_s": time.perf_counter() - t0,
              "phases": phases}
    if not trace:
        ops, report["window_s"] = measure_window(
            system, ctx, seconds,
            sample_indices(seed, traffic["sample_from_first"]))
    else:
        n = int(traffic["trace_ops"])
        ops = _Ops(system, ctx, sample_indices(seed, n))
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([torch.profiler.ProfilerActivity.CUDA]
              if ctx.device.type == "cuda" else [])])
        with prof:
            # every rank's profiler is running before the first operation,
            # so no rank's first collective waits for another's start
            _barrier(ctx)
            for i in range(n):
                with torch.profiler.record_function(OP_RANGE):
                    res, _ = ops.issue()
                ops.settle(res, last=i == n - 1)
                res = None
        path = ctx.tmpdir / f"trace-{ctx.rank}.json"
        prof.export_chrome_trace(str(path))
        del prof
        from distributed_join_tpu_torch import telemetry

        telemetry.finalize()
        report["trace"] = reduce_file(path)
        path.unlink()
    report.update(ops=len(ops.lat), latencies=ops.lat, retries=ops.retries,
                  failed=ops.failed, window_peak=_peak(ctx),
                  setup_peak=setup_peak, forbidden=forbidden_loaded())
    release(system, ctx)
    numbers, work = system.check(ops.kept, seed)
    numbers["answers_lost"] = (ops.lost, 0)
    report.update(numbers=numbers, work=work,
                  rows_per_op=system.rows_per_op)
    del ops
    return gather(ctx, report)
