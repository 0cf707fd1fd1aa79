"""What the join paths run with the metrics tape off, in the tree this is
run from: for a parent-against-change check that the tape costs nothing
when it is off.

    cd TREE && python3 PATH/TO/tape_off_census.py [--rows N] [--device cuda|cpu]

The working directory goes first on ``sys.path``, so the same file
counts a checkout of the parent commit and this tree (through
``scripts/tree_ab.py``: parent, change, change, parent). Every path
runs with no telemetry session and no ``with_metrics`` argument (the
tape off, and the only form the parent takes), once to warm up and then
once counted:

- ``aten``: the ATen operators it dispatches (a ``TorchDispatchMode``
  entered on every thread, so each emulated rank's thread counts), as
  their number and the sha256 of each thread's sequence of names;
- ``wrappers``: the hand kernels' launches, by wrapper or call site;
- ``cuda``: on a card, every CUDA kernel, memset and copy by name
  (``torch.profiler``), in one more call.

Prints one JSON line, ``{"paths": {path: {...}}}``. Two trees whose
lines are equal path by path dispatch the same operators in the same
order and launch the same kernels.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from distributed_join_tpu_torch.ops import (
        aggregate,
        compact,
        expand,
        join,
        merge_sort,
        scan,
    )
    from distributed_join_tpu_torch.ops import _kernels
    from distributed_join_tpu_torch.parallel import skew
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.parallel.query_exec import (
        distributed_query,
    )
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
        generate_zipf_probe_table,
    )
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_query_tables,
        query_filters,
    )

    dev = args.device
    cuda = dev.startswith("cuda")
    n = args.rows
    wrappers = (scan.join_scans, join.compact_records,
                join.pack_matched_builds, join.pack_valid_builds,
                compact.stream_compact, expand.expand_gather,
                skew.extract_prefix, merge_sort.merge_sort_planes,
                expand.expand_pull, aggregate.compact_groups)

    seqs: dict = {}
    recording = threading.Event()

    class Recorder(TorchDispatchMode):
        def __init__(self, out):
            super().__init__()
            self.out = out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.out.append(func.name())
            return func(*args, **(kwargs or {}))

    base_run = threading.Thread.run

    def run(self):
        if not recording.is_set():
            return base_run(self)
        with Recorder(seqs.setdefault(self.name, [])):
            return base_run(self)

    threading.Thread.run = run

    def sync():
        if cuda:
            torch.cuda.synchronize()

    build, probe = generate_build_probe_tables(
        seed=42, build_nrows=n, probe_nrows=n, selectivity=0.3, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(43)
    zipf = generate_zipf_probe_table(g, n, 1.5, n)
    small = max(n // 40, 4096)
    _, sprobe = generate_build_probe_tables(
        seed=44, build_nrows=small, probe_nrows=small, device=dev)
    local = LocalCommunicator()
    emu = EmulatedCommunicator(4)
    hier = EmulatedCommunicator(4, n_slices=2)
    registry = ResidentTableRegistry(local, JoinProgramCache(local))
    registry.register("dim", build)
    sf = 1.0 if cuda else 0.01
    q3 = query_filters(generate_tpch_query_tables(
        seed=42, scale_factor=sf, device=dev), "q3")
    from distributed_join_tpu_torch.ops.aggregate import AggregateSpec
    spec = AggregateSpec.of("key", [("count", None, "n"),
                                    ("sum", "probe_payload", "s")])
    paths = {
        "headline": lambda: distributed_inner_join(build, probe, local),
        "padded4": lambda: distributed_inner_join(build, probe, emu),
        "emulated4_k4": lambda: distributed_inner_join(
            build, probe, emu, over_decomposition=4),
        "ppermute": lambda: distributed_inner_join(
            build, probe, emu, shuffle="ppermute"),
        "ragged": lambda: distributed_inner_join(
            build, probe, emu, shuffle="ragged"),
        "compressed16": lambda: distributed_inner_join(
            build, probe, emu, compression_bits=16),
        "hier2x2": lambda: distributed_inner_join(
            build, probe, hier, shuffle="hierarchical", dcn_codec="on"),
        "segmented": lambda: distributed_inner_join(
            build, probe, emu, over_decomposition=4, sort_mode="segmented"),
        "anti": lambda: distributed_inner_join(build, probe, emu,
                                               join_type="anti"),
        "skew": lambda: distributed_inner_join(
            build, zipf, emu, skew_threshold=0.001,
            out_capacity_factor=4.0),
        "aggregate": lambda: distributed_inner_join(build, probe, emu,
                                                    aggregate=spec),
        "resident": lambda: registry.join("dim", sprobe),
        "query_q3": lambda: distributed_query(
            q3, tpch_query_plan("q3"), local, auto_retry=4,
            shuffle_capacity_factor=1.6, out_capacity_factor=1.5),
    }
    out = {}
    for name, fn in paths.items():
        fn()
        sync()
        _kernels.reset_launch_counts(*wrappers)
        seqs.clear()
        recording.set()
        try:
            with Recorder(seqs.setdefault("main", [])):
                fn()
            sync()
        finally:
            recording.clear()
        row = {
            "aten": {th: {"ops": len(s), "sha256": hashlib.sha256(
                "\n".join(s).encode()).hexdigest()[:16]}
                for th, s in sorted(seqs.items()) if s},
            "wrappers": {w.__name__: w.launches for w in wrappers
                         if w.launches},
        }
        if cuda:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                sync()
            kinds = collections.Counter()
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    kinds[e.name] += 1
            row["cuda"] = {"total": sum(kinds.values()),
                           "by_name": dict(sorted(kinds.items()))}
        out[name] = row
        print(f"[census] {name}: {json.dumps(row)[:300]}", file=sys.stderr,
              flush=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader 2>/dev/null").read().strip()
    print(json.dumps({"kind": "tape_off_census", "rows": n,
                      "gpu": smi or None, "paths": out}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
