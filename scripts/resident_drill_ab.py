"""The service smoke's resident drill, timed in the tree it is run from.

    cd TREE && python3 PATH/TO/resident_drill_ab.py [--joins N] [--rounds R]
        [--device cuda|cpu]

The working directory goes first on ``sys.path``, so the same file
times a checkout of the parent commit and this tree (run it through
``scripts/tree_ab.py``: parent, change, change, parent). It registers
the drill's build table (``service.server._resident_drill``'s shapes:
seed 7, 16,384 build rows, 2,048 probe rows, keys below 8,192,
selectivity 0.5, out capacity factor 3) with a ``JoinService`` over one
rank, builds both programs outside the timing, then runs R rounds of N
warm joins a side in back-to-back pairs, the side that goes first
alternating from pair to pair, as the drill takes them. Prints one JSON
line: each round's minimum and median wall a side and the ratios full
/ probe-only (above 1: the probe-only join is the faster), the median
over the pairs of a pair's ratio (the drill's gate) and the pairs the
probe-only join won, with
``--walls`` every join's wall too, and the Python function calls a warm
request of each side makes (``cProfile`` over 10 requests after the
rounds): the host work a request, free of the host's speed.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--joins", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walls", action="store_true",
                    help="add every join's wall to each round")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.service.server import JoinService
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    service = JoinService(LocalCommunicator(), device=args.device)
    with service.on_device():
        build, probe = generate_build_probe_tables(
            seed=7, build_nrows=16384, probe_nrows=2048, rand_max=8192,
            selectivity=0.5, device=service.device)
    opts = dict(out_capacity_factor=3.0)
    service.register_table("drill", build)
    sides = {"full": lambda: service.join(build, probe, **opts),
             "probe_only": lambda: service.resident_join("drill", probe,
                                                         **opts)}
    for fn in sides.values():
        fn()
    order = list(sides)
    rounds = []
    for _ in range(args.rounds):
        walls = {side: [] for side in sides}
        for i in range(args.joins):
            for side in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                sides[side]()
                walls[side].append(time.perf_counter() - t0)
        row = {}
        for stat, f in (("min", min), ("median", statistics.median)):
            full, po = f(walls["full"]), f(walls["probe_only"])
            row.update({f"full_{stat}_s": full, f"probe_only_{stat}_s": po,
                        f"speedup_{stat}": full / po})
        ratios = [a / b for a, b in zip(walls["full"], walls["probe_only"])]
        row["speedup_pairs"] = statistics.median(ratios)
        row["probe_only_pair_wins"] = sum(r > 1 for r in ratios)
        if args.walls:
            row["walls_s"] = walls
        rounds.append(row)
    calls = {}
    for side, fn in sides.items():
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(10):
            fn()
        prof.disable()
        calls[side] = pstats.Stats(prof).total_calls // 10
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader 2>/dev/null").read().strip()
    print(json.dumps({
        "kind": "resident_drill_ab", "joins": args.joins,
        "torch": torch.__version__, "gpu": smi or None,
        "speedup_min": [r["speedup_min"] for r in rounds],
        "speedup_median": [r["speedup_median"] for r in rounds],
        "speedup_pairs": [r["speedup_pairs"] for r in rounds],
        "probe_only_pair_wins": [r["probe_only_pair_wins"] for r in rounds],
        "python_calls_a_request": calls,
        "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
