"""The benchmark's command:

    python3 joinbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port. Prints one JSON
line last on standard output; exits non-zero, printing no line, when the
cell's CUDA devices are missing, the port is absent, a rank fails, or a
module of JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from joinbench.harness.launch import main

    sys.exit(main(sys.argv[1:], T0))
