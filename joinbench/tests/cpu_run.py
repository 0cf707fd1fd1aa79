"""Drive a cell on the CPU at tiny sizes, past the harness's look for a
card: the launch (gloo between processes), the loop, the check and the
line, as a run makes them.

    python -m joinbench.tests.cpu_run <cell> <trace 0|1> [fault]

prints the line; ``fault`` names a function of ``tests/faults.py`` that
every rank process calls first. A fault patches the port in the process
it runs in, rank 0's among them, so a faulted run takes a process of its
own (:func:`run_in_subprocess`).
"""

import dataclasses
import json
import sys
import time

T0 = time.perf_counter()

# Tiny sizes a test run holds; the shapes are the configuration's.
TINY = {"synth_join": {"build_rows_per_gpu": 4096,
                       "probe_rows_per_gpu": 4096, "selectivity": 0.3,
                       "communicator": "gloo"},
        "tpch_query": {"scale_factor": 0.004}}


def tiny_cell(name: str, overrides=None, root=None):
    from joinbench.harness import spec

    cell = spec.resolve_cell(spec.load_benchmark(root or spec.ROOT), name,
                             root=root or spec.ROOT)
    conf = dict(cell.config)
    conf.update(TINY.get(conf["system"], {}))
    conf.update(overrides or {})
    return dataclasses.replace(cell, config=conf)


def run(name: str, trace: bool = False, seed: int = 3_000_000_019,
        seconds: float = 0.2, overrides=None, prepare=None) -> dict:
    """The line of one tiny CPU run of cell ``name``."""
    from joinbench.harness import launch

    cell = tiny_cell(name, overrides)
    ranks = launch.run_world(cell, seed, seconds, trace, T0,
                             device_type="cpu", prepare=prepare)
    return launch.line(cell, ranks, trace, {"platform": "cpu",
                                            "kind": "cpu",
                                            "count": cell.chips})


def run_in_subprocess(name: str, trace: bool = False, fault=None,
                      timeout: float = 600) -> dict:
    """:func:`run` in a fresh Python process; its line."""
    import subprocess

    from joinbench.harness import spec

    cmd = [sys.executable, "-m", "joinbench.tests.cpu_run", name,
           str(int(trace))] + ([fault] if fault else [])
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=str(spec.ROOT))
    if out.returncode != 0:
        raise RuntimeError(f"{cmd} exited {out.returncode}: "
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    fault = sys.argv[3] if len(sys.argv) > 3 else None
    print(json.dumps(run(sys.argv[1], bool(int(sys.argv[2])),
                         prepare=fault and ("joinbench.tests.faults",
                                            fault))))
