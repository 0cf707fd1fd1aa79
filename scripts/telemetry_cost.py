"""Host cost of the telemetry session's primitives, and of a span's parts.

    python3 scripts/telemetry_cost.py [--calls 20000] [--dir DIR]
    python3 scripts/telemetry_cost.py --join 10000000 [--reps 10] [--nccl]

Prints one JSON line: microseconds a call (host clock over ``--calls``
calls, after as many warm ones) of a span, an event and a counter with a
session open in ``DIR`` (default: a new directory under ``build/``), and
of the parts a span is made of: the sink's line write (a JSON line
appended to a line-buffered file in the session's directory), the JSON
encoding of a span record, an NVTX push/pop pair, a
``torch.profiler.record_function`` range with no profiler running, and
``torch.autograd._profiler_enabled()``. On a machine with a card the
CUDA context is made first, so that spans take their NVTX ranges, and
the line names the card and its power limit (nvidia-smi).

``--join ROWS`` instead times one join step (ROWS x ROWS, seed 42, unique
build keys, over-decomposition 4 on one rank: 9 spans a join) on the
card in turns ``off on bare mute mute bare on off`` (``--reps`` joins
each turn): ``off`` without a session; ``on`` with one; ``bare`` with one
whose spans enter no device range (no NVTX, no ``record_function``);
``mute`` with one whose sink records no span. For each: the median ms a
join by CUDA events, of the host's enqueue (the call's return, before a
synchronisation), and of the host's wall to the synchronisation.
``--nccl`` runs the step over a process group of one NCCL rank
(``ProcessGroupCommunicator``) in place of the local communicator.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributed_join_tpu_torch import telemetry  # noqa: E402


def per_call_us(fn, calls: int) -> float:
    for _ in range(calls):
        fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def time_join(rows: int, reps: int, d: str, nccl: bool = False) -> dict:
    """The ``--join`` mode (module docstring)."""
    import contextlib
    import socket
    import statistics

    from distributed_join_tpu_torch.parallel import bootstrap
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
        make_communicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_distributed_join,
    )
    from distributed_join_tpu_torch.telemetry import export, spans
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    build, probe = generate_build_probe_tables(
        seed=42, build_nrows=rows, probe_nrows=rows,
        unique_build_keys=True, device="cuda")
    if nccl:
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        bootstrap.initialize(f"localhost:{port}", 1, 0)
        comm = make_communicator("nccl")
    else:
        comm = LocalCommunicator()
    fn = make_distributed_join(comm, over_decomposition=4)
    real_range, real_event = spans._device_range, \
        export.TelemetrySink.span_event

    @contextlib.contextmanager
    def variant(name, i):
        spans._device_range = (real_range if name != "bare" else
                               lambda _n: contextlib.nullcontext())
        export.TelemetrySink.span_event = (
            real_event if name != "mute" else lambda *a, **k: None)
        try:
            with (contextlib.nullcontext() if name == "off" else
                  telemetry.session(os.path.join(d, f"join_{i}_{name}"))):
                yield
        finally:
            spans._device_range = real_range
            export.TelemetrySink.span_event = real_event

    for _ in range(3):
        fn(build, probe)
    torch.cuda.synchronize()
    order = ("off", "on", "bare", "mute", "mute", "bare", "on", "off")
    got = {k: {"event_ms": [], "enqueue_ms": [], "wall_ms": []}
           for k in order}
    for i, name in enumerate(order):
        with variant(name, i):
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                t0 = time.perf_counter()
                res = fn(build, probe)
                t1 = time.perf_counter()
                end.record()
                end.synchronize()
                t2 = time.perf_counter()
                got[name]["event_ms"].append(start.elapsed_time(end))
                got[name]["enqueue_ms"].append((t1 - t0) * 1e3)
                got[name]["wall_ms"].append((t2 - t0) * 1e3)
                del res
    if nccl:
        bootstrap.shutdown()
    return {"rows": rows, "reps_a_turn": reps, "order": order,
            "communicator": comm.name,
            "median": {k: {m: statistics.median(v) for m, v in x.items()}
                       for k, x in got.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=20000)
    p.add_argument("--dir", default=None)
    p.add_argument("--join", type=int, default=0, metavar="ROWS")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--nccl", action="store_true")
    args = p.parse_args(argv)
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(root, exist_ok=True)
    d = args.dir or tempfile.mkdtemp(prefix="telemetry_cost_", dir=root)
    card = torch.cuda.is_available()
    if card:
        torch.zeros(1, device="cuda")  # the CUDA context: NVTX on
    n = args.calls
    out = {"calls": n, "dir": d, "cuda": card}
    if args.join:
        if not card:
            raise SystemExit("--join times the step on a card: no CUDA "
                             "device here")
        out.update(time_join(args.join, args.reps, d, nccl=args.nccl))
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps(out), flush=True)
        return 0

    def span():
        with telemetry.span("join", batch=0):
            pass

    with telemetry.session(d, rank=0):
        out["span_us"] = per_call_us(span, n)
        out["event_us"] = per_call_us(lambda: telemetry.event("e", a=1), n)
        out["counter_us"] = per_call_us(
            lambda: telemetry.counter_add("c", 1), n)
    rec = {"kind": "span", "name": "join", "path": "join", "ts_us": 1.0,
           "dur_us": 2.0, "rank": 0, "payload": {"batch": 0}}
    with open(os.path.join(d, "lines.jsonl"), "a", buffering=1) as f:
        line = json.dumps(rec) + "\n"
        out["line_write_us"] = per_call_us(lambda: f.write(line), n)
    out["json_dumps_us"] = per_call_us(lambda: json.dumps(rec), n)
    if card:
        def nvtx():
            torch.cuda.nvtx.range_push("join")
            torch.cuda.nvtx.range_pop()

        out["nvtx_pair_us"] = per_call_us(nvtx, n)

    def ranged():
        with torch.profiler.record_function("join"):
            pass

    out["record_function_us"] = per_call_us(ranged, n)
    out["profiler_enabled_us"] = per_call_us(
        torch.autograd._profiler_enabled, n)
    if card:
        out["device"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
