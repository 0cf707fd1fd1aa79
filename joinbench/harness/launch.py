"""The launch of one cell: the checks before any work, one process a
chip (rank 0 is this process; the others are started first thing and
joined before the line is printed), a deadline over the whole run, and
the printing of the line.

Under a process group each rank takes card ``rank`` and joins an NCCL
group at ``tcp://127.0.0.1:<free port>`` (gloo on the CPU, which only
the tests use). A rank that fails ends the run: the others are killed
and nothing is printed on standard output.
"""

from __future__ import annotations

import ctypes
import datetime
import importlib
import importlib.util
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

DEADLINE_S = 340.0
PORT_PACKAGE = "distributed_join_tpu_torch"
RUN_JOB = ("joinbench.harness.loop", "run_rank")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fixed_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path in the checkout. (The
    port's kernels build into ``build/torch_kernels/`` by themselves.)"""
    base = Path(root) / "build" / "joinbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")


def _die_with_parent() -> None:
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _call(spec, *args, **kw):
    mod, fn = spec
    return getattr(importlib.import_module(mod), fn)(*args, **kw)


def _rank(rank, world, port, device_type, cell, t0, tmpdir, job, job_args,
          prepare):
    """One rank: plant what the tests ask (``prepare``), join the group,
    run ``job(ctx, cell, t0=t0, **job_args)``."""
    import torch
    import torch.distributed as dist

    from joinbench.harness.collective import RankContext

    if prepare is not None:
        _call(prepare)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    if world > 1:
        kw = {"device_id": device} if device_type == "cuda" else {}
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=240), **kw)
    ctx = RankContext(rank=rank, world=world, device=device,
                      tmpdir=Path(tmpdir))
    try:
        return _call(job, ctx, cell, t0=t0, **job_args)
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def child_main(spec_path: str) -> None:
    """A rank other than 0, started by :class:`World` with its arguments
    in a JSON file."""
    from joinbench.harness.spec import Cell

    _die_with_parent()
    with open(spec_path) as f:
        a = json.load(f)
    a["cell"] = Cell(**a["cell"])
    _rank(a["rank"], a["world"], a["port"], a["device_type"], a["cell"],
          a["t0"], a["tmpdir"], tuple(a["job"]), a["job_args"],
          tuple(a["prepare"]) if a["prepare"] else None)


class World:
    """The processes of one run: ``start()`` the ranks other than 0 (as
    early as possible: each takes seconds to import torch), ``run()``
    rank 0's job here and wait for the others."""

    def __init__(self, cell, t0: float, job=RUN_JOB, job_args=None,
                 device_type: str = "cuda", prepare=None, root=None):
        from joinbench.harness import spec as spec_mod

        self.root = Path(root or spec_mod.ROOT)
        self.cell, self.t0 = cell, t0
        self.world = cell.chips
        self.tmpdir = tempfile.mkdtemp(prefix="joinbench-")
        self.port = _free_port() if self.world > 1 else 0
        # perf_counter is the system's monotonic clock: every rank counts
        # its phases from the start of rank 0's process
        self.args = (self.world, self.port, device_type, cell, t0,
                     self.tmpdir, job, dict(job_args or {}), prepare)
        self.children = []
        self._done = threading.Event()

    def start(self) -> "World":
        import dataclasses

        world, port, device_type, cell, t0, tmpdir, job, job_args, \
            prepare = self.args
        code = (f"import sys; sys.path.insert(0, {str(self.root)!r}); "
                "from joinbench.harness.launch import child_main; "
                "child_main(sys.argv[1])")
        for r in range(1, self.world):
            path = Path(tmpdir) / f"rank-{r}.json"
            path.write_text(json.dumps({
                "rank": r, "world": world, "port": port,
                "device_type": device_type,
                "cell": dataclasses.asdict(cell), "t0": t0,
                "tmpdir": tmpdir, "job": list(job), "job_args": job_args,
                "prepare": list(prepare) if prepare else None}))
            self.children.append(subprocess.Popen(
                [sys.executable, "-c", code, str(path)],
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL))
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def _watch(self):
        while not self._done.is_set():
            for r, c in enumerate(self.children, 1):
                code = c.poll()
                if code not in (None, 0):
                    print(f"joinbench: rank {r} exited with {code}",
                          file=sys.stderr, flush=True)
                    self._done.set()
                    os.kill(os.getpid(), signal.SIGTERM)
                    return
            time.sleep(0.5)

    def run(self) -> list:
        try:
            out = _rank(0, *self.args)
            codes = [c.wait(timeout=60) for c in self.children]
            if any(code != 0 for code in codes):
                raise RuntimeError(f"a rank process failed: {codes}")
            return out
        finally:
            self.close()

    def close(self) -> None:
        self._done.set()
        for c in self.children:
            if c.poll() is None:
                c.kill()
            c.wait(timeout=30)
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def run_world(cell, seed: int, seconds: float, trace: bool, t0: float,
              device_type: str = "cuda", prepare=None, root=None) -> list:
    """Every rank's report of one run of ``cell`` (rank 0's first).
    ``prepare``: ``(module, function)`` each process calls first (the
    tests plant faults with it)."""
    return World(cell, t0, job_args=dict(seed=seed, seconds=seconds,
                                         trace=trace),
                 device_type=device_type, prepare=prepare,
                 root=root).start().run()


def line(cell, ranks: list, trace: bool, device: dict) -> dict:
    """The result line's object, ``checks`` last."""
    from joinbench.harness import report as rep
    from joinbench.harness import spec as spec_mod

    ctx = rep.ReadContext(cell=cell.name, chips=cell.chips, ranks=ranks,
                          kernels=spec_mod.kernel_specs())
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = rep.read_metrics(entries, "layers" if trace else "end_to_end",
                               ctx)
    nums = rep.numbers(ranks)
    out = {"correct": all(v <= lim for v, lim in nums.values()),
           "attempted": ranks[0]["ops"],
           "failed": ranks[0]["failed"],
           "metrics": metrics, "device": dict(device)}
    out["device"]["memory_peak_bytes"] = max(
        max(r["setup_peak"], r["window_peak"]) for r in ranks)
    if trace:
        ts = ctx.traces
        out["device"]["busy_s"] = sum(t["busy_s"] for t in ts) / len(ts)
        out["device"]["window_s"] = sum(t["window_s"] for t in ts) / len(ts)
        bd = rep.breakdown(ctx)
        if bd is not None:
            out["breakdown"] = bd
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in nums.items()}
    return out


def _deadline(world: "World") -> None:
    print(f"joinbench: the run passed its {DEADLINE_S:.0f} s deadline",
          file=sys.stderr, flush=True)
    for c in world.children:
        c.kill()
    os._exit(4)


def main(argv, t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="joinbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = p.parse_args(argv)

    from joinbench.harness import spec as spec_mod

    root = spec_mod.ROOT
    if importlib.util.find_spec(PORT_PACKAGE) is None:
        print(f"joinbench: the program ({PORT_PACKAGE}) is not in this "
              f"checkout ({root})", file=sys.stderr)
        return 2
    cell = spec_mod.resolve_cell(spec_mod.load_benchmark(root), args.workload)
    fixed_cache_dirs(root)
    world = World(cell, t0, job_args=dict(seed=args.seed,
                                          seconds=args.seconds,
                                          trace=bool(args.trace)))
    timer = threading.Timer(DEADLINE_S - (time.perf_counter() - t0),
                            _deadline, args=(world,))
    timer.daemon = True
    timer.start()
    world.start()   # the other ranks import torch while this one checks
    import torch

    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_dev < cell.chips:
        world.close()
        print(f"joinbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {n_dev}", file=sys.stderr)
        return 2
    ranks = world.run()
    timer.cancel()
    found = sorted({m for r in ranks for m in r["forbidden"]})
    if found:
        print("joinbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips}
    out = line(cell, ranks, bool(args.trace), device)
    print("set-up, s from the start of rank 0's process: " + "; ".join(
        f"rank {r['rank']}: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in r["phases"].items())
        for r in ranks), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
