"""No run loads JAX or the JAX package, compared by whole top-level
names, and the reference imports nothing of the port."""

import subprocess
import sys

import pytest

from joinbench.reference import imports
from joinbench.harness import spec


@pytest.mark.parametrize("name,banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("distributed_join_tpu", True),
    ("distributed_join_tpu.ops.join", True),
    ("distributed_join_tpu_torch", False),
    ("distributed_join_tpu_torch.ops.join", False),
    ("jaxtyping", False), ("numpy", False)])
def test_whole_top_level_names(name, banned):
    assert (imports.forbidden_loaded({name: None}) == [name]) is banned


def test_reference_sources_import_nothing_banned():
    assert imports.reference_violations() == {}


def test_reference_violation_is_found(tmp_path):
    (tmp_path / "bad.py").write_text(
        "from distributed_join_tpu_torch.ops import join\nimport jax\n")
    (tmp_path / "good.py").write_text("import torch\n")
    assert imports.reference_violations(tmp_path) == {
        str(tmp_path / "bad.py"): ["distributed_join_tpu_torch", "jax"]}


def test_reference_modules_load_no_port_and_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import joinbench.reference.join, joinbench.reference.query\n"
        "import joinbench.reference.compare, joinbench.reference.imports\n"
        "import joinbench.frozen.generators, joinbench.frozen.tpch\n"
        "import joinbench.frozen.bounds\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ("
        "'jax', 'jaxlib', 'flax', 'distributed_join_tpu', "
        "'distributed_join_tpu_torch')]\n"
        "print(bad)\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax():
    """A tiny CPU run of the Q3 cell, in a fresh process: its check of
    ``sys.modules`` after the window found nothing."""
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from joinbench.tests import cpu_run\n"
            "line = cpu_run.run('tpch_sf12_5.q3')\n"
            "print(json.dumps(line['checks']['forbidden_modules']))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'distributed_join_tpu')))\n"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-2:]
    assert last == ['{"value": 0, "limit": 0}', "[]"]
