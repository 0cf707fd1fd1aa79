"""The benchmark's command on the card: each cell whose chips the machine
has, one short untraced and one traced run, held to the contract and to
``correct``. Marked ``cuda``; each skips, deciding in a fixture, where
the card or the cards are missing.

    python -m pytest joinbench/tests/test_joinbench_cuda.py -m cuda
"""

import json
import subprocess
import sys

import pytest

from joinbench.harness import spec
from joinbench.tests import contract

DOC = spec.load_benchmark()


@pytest.fixture
def devices():
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        pytest.skip("no CUDA device: the command runs only on the card")
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in DOC["workloads"]])
def test_the_command_on_the_card(devices, name, trace):
    cell = spec.resolve_cell(DOC, name)
    if devices < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} cards; {devices} here")
    out = subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", name, "--seed",
         "4294967311", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=400, cwd=str(spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert contract.line_problems(line, cell, bool(trace)) == []
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == cell.chips
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
