"""The readings a cell's limits are set from, on the card, at the cell's
own size and load, in one set of processes:

- the program's: for each seed of ``--seeds``, the inputs made from the
  seed, the warm-up, a short closed-loop window of ``--seconds`` and the
  check of its sampled results, as a run makes them;
- the control's: for each seed of ``--control-seeds``, the reference at
  the lower precision (``System.control``) put in the program's place
  and held to the same check.

    python3 joinbench/checks/seeds.py --workload tpch_sf12_5.q3 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 \\
        --out seeds_q3.json

Prints one line a seed and writes every reading to ``--out``.
"""

import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def rank_job(ctx, cell, *, t0, seeds, control_seeds, seconds):
    from joinbench.harness import loop
    from joinbench.harness import spec as spec_mod
    from joinbench.harness.collective import gather

    system_cls = spec_mod.system_class(cell)
    rows = []
    for seed in seeds:
        system = system_cls(cell.config, cell.traffic, ctx)
        system.setup(seed)
        loop.warm_up(system, ctx, int(cell.traffic["warmup_ops"]), {}, t0)
        ops, window_s = loop.measure_window(
            system, ctx, seconds,
            loop.sample_indices(seed, cell.traffic["sample_from_first"]))
        loop.release(system, ctx)
        numbers, _ = system.check(ops.kept, seed)
        numbers["answers_lost"] = (ops.lost, 0)
        rows.append({"side": "program", "seed": seed, "ops": len(ops.lat),
                     "failed": ops.failed, "window_s": window_s,
                     "numbers": numbers})
        del ops, system
    for seed in control_seeds:
        system = system_cls(cell.config, cell.traffic, ctx)
        numbers, _ = system.check([system.control(seed)], seed)
        rows.append({"side": "control", "seed": seed, "numbers": numbers})
        del system
    return gather(ctx, rows)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="joinbench/checks/seeds.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from joinbench.harness import launch
    from joinbench.harness import spec as spec_mod

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    cell = spec_mod.resolve_cell(spec_mod.load_benchmark(), args.workload)
    launch.fixed_cache_dirs(spec_mod.ROOT)
    rows = launch.World(
        cell, T0, job=("joinbench.checks.seeds", "rank_job"),
        job_args=dict(seeds=ints(args.seeds),
                      control_seeds=ints(args.control_seeds),
                      seconds=args.seconds)).start().run()[0]
    for r in rows:
        print(r["side"], r["seed"], r.get("ops", ""), " ".join(
            f"{k}={v[0]}" for k, v in r["numbers"].items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
