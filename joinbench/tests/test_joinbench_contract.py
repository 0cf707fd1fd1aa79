"""The benchmark against its contract: ``BENCHMARK.json``, the names,
and each cell's last line from a tiny CPU run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from joinbench.harness import spec
from joinbench.tests import contract, cpu_run

DOC = spec.load_benchmark()
CELLS = [w["name"] for w in DOC["workloads"]]


def test_benchmark_json_meets_the_contract():
    assert contract.benchmark_problems(DOC, spec.ROOT) == []


def test_file_is_small_and_paths_hold_the_command():
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert DOC["command"] == ["python3", "joinbench/run.py"]
    assert DOC["paths"] == ["joinbench"]


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "x" * 65, "é",
                                 "-lead"])
def test_names_refuse_bad_characters(bad):
    assert not contract.NAME_RE.match(bad)


@pytest.mark.parametrize("good", ["ref_synth_100m.k4", "tpch_sf12_5.q3",
                                  "_x", "9a-b.c"])
def test_names_take_the_allowed_characters(good):
    assert contract.NAME_RE.match(good)


@pytest.mark.parametrize("unit,ok", [("Mrows/s", True), ("%", True),
                                     ("ms", True), ("rows per s", False),
                                     ("µs", False), ("x" * 17, False)])
def test_units(unit, ok):
    assert bool(contract.UNIT_RE.match(unit)) is ok


def test_every_unit_and_name_in_the_file():
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert contract.UNIT_RE.match(m["unit"]), m
        assert contract.NAME_RE.match(m["name"]), m


def test_every_metric_has_a_reader_and_every_kernel_file_parses():
    for m in DOC["end_to_end"]:
        assert callable(spec.reader("end_to_end", m["name"]))
    for m in DOC["per_layer"]:
        assert callable(spec.reader("layers", m["name"]))
    kernels = spec.kernel_specs()
    assert set(kernels) == {"join_scans", "stream_compact", "expand_gather"}
    for k in kernels.values():
        assert set(k) == {"source", "match", "bytes", "ops"}


def test_configs_name_their_systems_and_traffic_files_exist():
    for w in DOC["workloads"]:
        cell = spec.resolve_cell(DOC, w["name"])
        assert spec.system_class(cell)
        assert cell.traffic["loop"] == "closed"


def test_a_problem_is_found():
    bad = json.loads(json.dumps(DOC))
    bad["end_to_end"][0]["bound"] = 0.5
    bad["workloads"][0]["name"] = "has space"
    assert len(contract.benchmark_problems(bad, spec.ROOT)) >= 2


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_each_cells_line(name, trace):
    line = cpu_run.run(name, trace=trace)
    cell = cpu_run.tiny_cell(name)
    assert contract.line_problems(line, cell, trace) == []
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert all(c["value"] == 0 for c in line["checks"].values())
    if not trace:
        # every end-to-end metric but the memory peak reads on the CPU
        names = {m["name"] for m in cell.end_to_end} - {"peak_mem_gib"}
        assert names <= set(line["metrics"])
    else:
        assert "retries_per_op" in line["metrics"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", "tpch_sf12_5.q3",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(cwd),
        env=env)


def test_without_a_card_the_command_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(spec.ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_in_a_directory_of_the_benchmark_alone_it_prints_nothing(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "not in this checkout" in out.stderr
