"""joinlint over the port (distributed_join_tpu_torch/analysis/): the
rules against torch fixtures and against the JAX package's own fixtures
and linter, the port's self-lint, the wire contract and the CLI's exit
codes. The recorded schedules are tests/test_torch_schedule.py."""

import json
import os
import shutil

import pytest

from distributed_join_tpu.analysis import Linter as JaxLinter
from distributed_join_tpu.analysis.linter import (
    DEFAULT_SUPPRESSIONS as JAX_SUPPRESSIONS,
    _parse_toml_subset as jax_parse_toml,
)
from distributed_join_tpu_torch.analysis import Linter, load_suppressions
from distributed_join_tpu_torch.analysis import lint as cli
from distributed_join_tpu_torch.analysis import wirecheck as W
from distributed_join_tpu_torch.analysis.linter import (
    DEFAULT_SUPPRESSIONS,
    DEFAULT_TARGETS,
    _parse_toml_subset,
)
from distributed_join_tpu_torch.telemetry.analyze import check_file

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
CONTRACT_PATH = os.path.join(REPO, "results", "contracts", "wire_ops.json")

# (rule, bad source, good source): each bad fixture flags its rule and
# nothing else; its good twin is clean.
TORCH_FIXTURES = {
    "DJL001": (
        '''
def step(comm, x):
    if comm.axis_index() == 0:
        x = comm.all_to_all(x)
    return comm.psum(x)


def early(comm, x):
    rank = comm.axis_index()
    if rank > 2:
        return x
    return comm.host_ints(x)


def dist_branch(dist, t):
    if dist.get_rank() == 0:
        dist.all_reduce(t)
''',
        '''
def step(comm, x):
    x = comm.all_to_all(x)
    me = comm.axis_index()
    y = x + me
    return comm.psum(y)


def pair(comm, x):
    n, r = comm.n_ranks, comm.axis_index()
    for d in range(1, n):
        x = comm.ppermute_all_to_all(x)
    return x, r
'''),
    "DJL002": (
        '''
import torch
from distributed_join_tpu_torch import telemetry


def timed(step, b, p):
    with telemetry.span("join"):
        res = step(b, p)
        n = res.total.item()
        torch.cuda.synchronize()
        t = torch.arange(4)
        m = int(t)
        host = res.table.valid.cpu()
    return n, m, host
''',
        '''
from distributed_join_tpu_torch import telemetry


def timed(step, b, p):
    with telemetry.span("join") as sp:
        res = step(b, p)
        sp.sync_on(res.total)
    return int(res.total)
'''),
    "DJL004": (
        '''
import torch


def sizes(mask, t):
    a = int(torch.sum(mask))
    x = torch.cumsum(t, 0)
    b = float(x.max())
    c = torch.count_nonzero(mask).item()
    return a, b, c
''',
        '''
import numpy as np
import torch


def sizes(counts, mask):
    a = int(np.sum(counts))
    b = int(max(counts))
    total = torch.sum(mask)
    return a, b, total
'''),
    "DJL005": (
        '''
def bill(tape, counts):
    tape.add("rows", counts.sum())


def step(x, with_metrics=False):
    from distributed_join_tpu_torch.telemetry import MetricsTape
    tape = MetricsTape()
    return x, tape
''',
        '''
def bill(tape, counts):
    if tape is not None:
        tape.add("rows", counts.sum())


def step(x, with_metrics=False):
    from distributed_join_tpu_torch.telemetry import MetricsTape
    tape = MetricsTape() if with_metrics else None
    if tape is not None:
        tape.add("rows", x)
    return x, tape
'''),
    "DJL006": (
        '''
import ctypes
import ctypes.util
import os


def f():
    return ctypes.util.find_library("c")
''',
        '''
import ctypes.util


def f():
    return ctypes.util.find_library("c")
'''),
}
# The JAX fixtures that name no JAX mechanism: the port's findings there
# equal the JAX linter's, rule and line.
SHARED_FIXTURES = sorted(
    n for n in os.listdir(JAX_FIXTURES)
    if any(k in n for k in ("lock_order", "blocking_locked", "lock_release",
                            "thread_leak"))
) + ["bad_unused_import.py", "bad_tape_parity.py", "good_clean.py"]


def _write(tmp_path, name, src):
    path = tmp_path / name
    path.write_text(src.lstrip("\n"))
    return name


@pytest.mark.parametrize("rule", sorted(TORCH_FIXTURES))
def test_torch_bad_fixture_flags_its_rule(rule, tmp_path):
    name = _write(tmp_path, f"bad_{rule}.py", TORCH_FIXTURES[rule][0])
    findings = Linter(str(tmp_path)).lint_file(name)
    assert findings, f"bad fixture of {rule} produced no findings"
    assert {f.rule for f in findings} == {rule}, "; ".join(
        f.format() for f in findings)


@pytest.mark.parametrize("rule", sorted(TORCH_FIXTURES))
def test_torch_good_fixture_is_clean(rule, tmp_path):
    name = _write(tmp_path, f"good_{rule}.py", TORCH_FIXTURES[rule][1])
    findings = Linter(str(tmp_path)).lint_file(name)
    assert findings == [], "; ".join(f.format() for f in findings)


def test_divergence_covers_branch_early_exit_and_dist():
    src = TORCH_FIXTURES["DJL001"][0]
    msgs = [f.message for f in Linter(REPO).lint_source(src, "x.py")]
    assert any("all_to_all() under a rank-dependent branch" in m
               for m in msgs)
    assert any("host_ints() is reachable after a rank-dependent early exit"
               in m for m in msgs)
    assert any("all_reduce()" in m for m in msgs)


@pytest.mark.parametrize("fixture", SHARED_FIXTURES)
def test_shared_fixture_findings_equal_the_jax_linter(fixture):
    want = [(f.rule, f.line) for f in JaxLinter(JAX_FIXTURES).lint_file(
        fixture)]
    got = [(f.rule, f.line) for f in Linter(JAX_FIXTURES).lint_file(
        fixture)]
    assert got == want
    assert bool(got) == fixture.startswith("bad_")


def test_jax_rule_ids_without_a_torch_mechanism_stay_unused():
    from distributed_join_tpu_torch.analysis import ALL_RULES

    ids = sorted(r.id for r in ALL_RULES)
    assert "DJL003" not in ids
    assert ids == ["DJL001", "DJL002", "DJL004", "DJL005", "DJL006",
                   "DJL007", "DJL008", "DJL009", "DJL010"]


@pytest.mark.parametrize("path", [JAX_SUPPRESSIONS, DEFAULT_SUPPRESSIONS])
def test_suppression_files_parse_alike_under_both_parsers(path):
    text = open(path).read()
    assert _parse_toml_subset(text, path) == jax_parse_toml(text, path)


def test_every_port_suppression_has_a_reason_and_a_port_path():
    sups = load_suppressions(DEFAULT_SUPPRESSIONS)
    assert sups
    for s in sups:
        assert len(s.reason) > 40, s.origin
        assert s.path.startswith(("distributed_join_tpu_torch/",
                                  "chip_smoke.py", "scripts/")), s.origin


def test_self_lint_clean_modulo_suppressions():
    result = Linter(REPO, suppressions=load_suppressions(
        DEFAULT_SUPPRESSIONS)).run()
    assert result.findings == [], "\n".join(
        f.format() for f in result.findings)
    assert not result.unused_suppressions, ", ".join(
        s.origin for s in result.unused_suppressions)
    assert result.files_checked > 60


def test_default_targets_name_the_port_only():
    for t in DEFAULT_TARGETS:
        assert os.path.exists(os.path.join(REPO, t)), t
        assert not t.startswith(("distributed_join_tpu/", "native/")), t
    for t in DEFAULT_TARGETS:
        if t.startswith("scripts/"):
            src = open(os.path.join(REPO, t)).read()
            assert "import jax" not in src and \
                "from distributed_join_tpu." not in src, t


def test_wire_contract_is_clean_and_reads_the_committed_golden():
    violations, contract = W.check_wire_contract(REPO)
    assert violations == [], "\n".join(violations)
    assert len(contract["daemon_ops"]) >= 10
    golden = json.load(open(CONTRACT_PATH))
    for key, want in golden.items():
        if key != "schema_version":
            assert contract[key] == want, key


def test_wire_cross_checks_hold():
    daemon = W.daemon_ops(REPO)
    assert W.resendable_ops(REPO) <= daemon
    assert W.router_ops(REPO) <= daemon
    assert W.fanout_ops(REPO) <= daemon
    assert W.affinity_ops(REPO) <= daemon
    assert not (W.fanout_ops(REPO) & W.resendable_ops(REPO))
    assert W.advertised_ops(REPO) == daemon
    classes, families = W.fault_classification(REPO)
    assert classes <= W.defined_error_classes(REPO)
    assert families
    assert W.emitted_gauges(REPO) == W.documented_gauges(REPO)


def test_artifact_kind_registry_is_closed_with_join_program():
    writers = W.artifact_writer_kinds(REPO)
    validators = W.artifact_validator_kinds(REPO)
    assert "join_program" in writers and "join_program" in validators
    assert writers <= validators, sorted(writers - validators)


def test_perturbed_wire_golden_fails(tmp_path):
    golden = json.load(open(CONTRACT_PATH))
    golden["daemon_ops"] = [o for o in golden["daemon_ops"] if o != "join"]
    path = tmp_path / "wire_ops.json"
    path.write_text(json.dumps(golden))
    violations, _ = W.check_wire_contract(REPO, path=str(path))
    assert any("daemon_ops" in v and "join" in v for v in violations), \
        violations
    missing, _ = W.check_wire_contract(REPO, path=str(tmp_path / "no.json"))
    assert any("no committed" in v for v in missing), missing


def test_analyze_check_accepts_a_join_program_entry(tmp_path):
    doc = {"kind": "join_program", "schema_version": 1, "digest": "ab12",
           "signature": {"n_ranks": 1}, "backend": {"device_type": "cuda"},
           "kernels": {"join_scans": "join_scans-0.so"}}
    good = tmp_path / "ab12.joinprog"
    good.write_text(json.dumps(doc))
    assert check_file(str(good)) == []
    bad = dict(doc, backend={}, digest="")
    del bad["kernels"]
    path = tmp_path / "bad.joinprog"
    path.write_text(json.dumps(bad))
    problems = check_file(str(path))
    assert "missing required key 'kernels'" in problems
    assert "backend missing 'device_type'" in problems
    assert "digest is not a non-empty string" in problems


def test_cli_exit_codes(tmp_path, capsys):
    # 0: a clean subtree (the whole tree is the self-lint test above)
    assert cli.main(["--rules-only",
                     "distributed_join_tpu_torch/analysis"]) == 0
    assert cli.main(["--contracts-only"]) == 0
    # 1: a bad fixture; a drifted contract
    _write(tmp_path, "bad.py", TORCH_FIXTURES["DJL001"][0])
    assert cli.main(["--rules-only", "--no-suppressions", "--root",
                     str(tmp_path), "bad.py"]) == 1
    assert "DJL001" in capsys.readouterr().out
    golden = json.load(open(CONTRACT_PATH))
    golden["router_ops"] = golden["router_ops"][:-1]
    drift = tmp_path / "wire_ops.json"
    drift.write_text(json.dumps(golden))
    assert cli.main(["--contracts-only", "--contract-path",
                     str(drift)]) == 1
    assert "router_ops" in capsys.readouterr().out
    # 2: configuration errors
    (tmp_path / "sup.toml").write_text('[[suppress]]\nrule = "DJL001"\n')
    assert cli.main(["--rules-only", "--suppressions",
                     str(tmp_path / "sup.toml")]) == 2
    assert cli.main(["--rules-only", "no_such_dir"]) == 2
    assert cli.main(["--update-contracts"]) == 2
    assert "JAX package's" in capsys.readouterr().err
    assert cli.main(["--rules-only", "--schedules-only"]) == 2


def test_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    root = tmp_path / "root"
    root.mkdir()
    shutil.copy(os.path.join(JAX_FIXTURES, "bad_lock_order.py"), root)
    rc = subprocess.run(
        [sys.executable, "-m", "distributed_join_tpu_torch.analysis.lint",
         "--rules-only", "--no-suppressions", "--root", str(root),
         "bad_lock_order.py"],
        cwd=REPO, capture_output=True, text=True)
    assert rc.returncode == 1, rc.stdout + rc.stderr
    assert "DJL007" in rc.stdout
