"""Parent against change on one GPU: the same commands in two trees.

    python3 scripts/tree_ab.py PARENT_DIR "CMD" ["CMD" ...]

Runs each command (a shell string, run from the tree's root) in the
order parent, change, change, parent, where the change is this tree and
the parent a checkout of the parent commit (for example ``git archive``
unpacked into a git-ignored directory). Prints the last line of each
run's output, which the port's drivers make a JSON record, tagged with
the tree and the command; and the card's name and power limit. Every
run is a process of its own, so each builds its kernels and warms up on
its own; only times taken inside one call of this script are compared.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, commands = os.path.abspath(argv[0]), argv[1:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[tree-ab] {smi.stdout.strip()}", flush=True)
    rc = 0
    for cmd in commands:
        for tag, tree in (("parent", parent), ("change", ROOT),
                          ("change", ROOT), ("parent", parent)):
            out = subprocess.run(cmd, shell=True, cwd=tree,
                                 capture_output=True, text=True)
            lines = out.stdout.strip().splitlines()
            last = lines[-1] if lines else ""
            print(f"[tree-ab] {tag} rc={out.returncode} {cmd}\n{last}",
                  flush=True)
            if out.returncode:
                rc = 1
                print(out.stderr[-2000:], file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
