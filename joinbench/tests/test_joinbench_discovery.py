"""Discovery by name: a throwaway configuration, traffic mix, cell and
metrics, added to a copy of the benchmark as new files and new
``BENCHMARK.json`` entries only, are found and reported by the harness
as it stands."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from joinbench.harness import spec


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "joinbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_discovery_finds_every_part_by_name():
    doc = spec.load_benchmark()
    cell = spec.resolve_cell(doc, "tpch_sf12_5.q3")
    assert cell.config_name == "tpch_sf12_5"
    assert cell.traffic_name == "q3" and cell.traffic["query"] == "q3"
    assert [m["name"] for m in cell.end_to_end] == [
        "rows_per_s", "op_ms_p95", "peak_mem_gib", "setup_s"]
    assert "join_agg_ms_per_op" in [m["name"] for m in cell.per_layer]
    assert "partition_ms_per_op" not in [m["name"] for m in cell.per_layer]
    k4 = spec.resolve_cell(doc, "ref_synth_100m.k4")
    assert "op_ms_p95" not in [m["name"] for m in k4.end_to_end]
    assert k4.chips == 4


def test_a_new_cell_and_metrics_from_new_files_only(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = spec.load_benchmark()
    before = _digests(tmp_path)
    bench = tmp_path / "joinbench"
    conf = json.loads((bench / "configs" / "tpch_sf12_5.json").read_text())
    conf["scale_factor"] = 0.003
    (bench / "configs" / "tpch_tiny.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "q3.json").read_text())
    traffic["trace_ops"] = 2
    (bench / "traffic" / "q3_short.json").write_text(json.dumps(traffic))
    (bench / "layers" / "ops_traced.py").write_text(
        "def read(ctx):\n    return ctx.rank0['trace']['n_ops']\n")
    (bench / "end_to_end" / "ops_done.py").write_text(
        "def read(ctx):\n    return ctx.rank0['ops']\n")
    name = "tpch_tiny.q3_short"
    doc["configs"].append({"name": "tpch_tiny", "source": "a test",
                           "file": "joinbench/configs/tpch_tiny.json",
                           "reduced": ["scale_factor"], "why": "a test"})
    doc["workloads"].append({"name": name, "config": "tpch_tiny",
                             "traffic": "q3_short", "chips": 1,
                             "why": "a test"})
    doc["end_to_end"].append({"name": "ops_done", "unit": "count",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock", "workloads": [name]})
    doc["per_layer"].append({"name": "ops_traced", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "orchestrator and capacity ladder",
                             "moves": "rows_per_s", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    for trace, metric, want in ((0, "ops_done", None), (1, "ops_traced", 2)):
        code = ("import json, sys\n"
                f"sys.path[:0] = [{str(tmp_path)!r}, {str(spec.ROOT)!r}]\n"
                "from joinbench.tests import cpu_run\n"
                f"print(json.dumps(cpu_run.run({name!r}, {bool(trace)})))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=300,
                             cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        assert metric in line["metrics"]
        if want is not None:
            assert line["metrics"][metric]["value"] == want
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "joinbench/configs/tpch_tiny.json", "joinbench/traffic/q3_short.json",
        "joinbench/layers/ops_traced.py", "joinbench/end_to_end/ops_done.py"}


@pytest.mark.parametrize("where,key,value", [
    ("config", "clients", 4),                 # a key nothing reads
    ("config", "key_type", "int32"),          # a value the adapter lacks
    ("traffic", "clients", 4),                # one client is all it runs
    ("traffic", "loop", "open"),
    ("traffic", "operation", "join"),
])
def test_a_key_nothing_reads_or_a_value_it_does_not_run_is_refused(
        where, key, value):
    cell = spec.resolve_cell(spec.load_benchmark(), "ref_synth_100m.k4")
    config, traffic = dict(cell.config), dict(cell.traffic)
    (config if where == "config" else traffic)[key] = value
    system = spec.system_module(config).System
    with pytest.raises(ValueError, match=repr(key)):
        spec.refuse_unread(config, traffic, system)
    spec.refuse_unread(cell.config, cell.traffic, system)


def test_a_run_refuses_such_a_key_and_resolving_imports_no_torch():
    from joinbench.tests import cpu_run

    with pytest.raises(ValueError, match="'orders'"):
        cpu_run.run("tpch_sf12_5.q3", overrides={"orders": 18_750_000})
    # rank 0 resolves the cell before it starts the other ranks, which
    # import torch meanwhile: resolving must not import it first
    code = ("import sys\nfrom joinbench.harness import spec\n"
            "spec.resolve_cell(spec.load_benchmark(), 'ref_synth_100m.k4')\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(spec.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
