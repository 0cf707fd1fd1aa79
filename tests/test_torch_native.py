"""The port's native driver (distributed_join_tpu_torch/native/): the
libtorch ``join_main`` built with g++, run with ``--device cpu`` (the
ATen twins of the three kernel stages), against the JAX package's
exported program (native/export_join.py ``build_looped_join``, jitted
on the CPU) and the port's own ``build_looped_join`` on the tables the
driver dumps; the sidecar against the JAX export's; and the driver's
refusals. The driver on the card is tests/test_torch_cuda.py and
chip_smoke.py phase 27."""

import importlib.util
import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_join_tpu_torch.native import export_join as E

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 4096
ITERS = 2
# The JAX package's program on the driver's tables at the size of the
# card test (tests/test_torch_cuda.py
# test_native_driver_on_card_equals_the_python_join, which holds the
# driver's kernel path to the same three numbers; the card runs no JAX):
# (total x iters, overflow, checksum), checked live below.
CARD_ROWS = 65536
JAX_AT_CARD_ROWS = [39230, False, 5154481199]


def _jax_export_module():
    """The JAX package's native/export_join.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_native_export_join", os.path.join(REPO, "native",
                                               "export_join.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def driver():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: join_main cannot be built here")
    return str(E.build_driver())


@pytest.fixture(scope="module")
def cpu_run(driver, tmp_path_factory):
    """export --device cpu, then the driver with --dump-tables: (record,
    artifact dir, tables dir)."""
    d = tmp_path_factory.mktemp("native")
    art, tables = d / "art", d / "tables"
    E.main(["--device", "cpu", "--build-table-nrows", str(ROWS),
            "--probe-table-nrows", str(ROWS), "--iterations", str(ITERS),
            "-o", str(art)])
    r = subprocess.run([driver, "--artifact-dir", str(art), "--device",
                        "cpu", "--dump-tables", str(tables)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1]), str(art), \
        str(tables)


def _run(driver, *argv):
    return subprocess.run([driver, *argv], capture_output=True, text=True,
                          timeout=60)


def test_driver_record(cpu_run):
    rec, _, _ = cpu_run
    assert rec["benchmark"] == "distributed_join_native"
    assert rec["communicator"] == "local" and rec["n_ranks"] == 1
    assert rec["device"] == "cpu"
    assert rec["iterations"] == ITERS
    assert rec["build_table_nrows"] == rec["probe_table_nrows"] == ROWS
    # unique build keys: every probe hit matches exactly one build row
    assert rec["matches_per_join"] == rec["probe_hits"] > 0
    assert rec["total_matches_x_iters"] == ITERS * rec["matches_per_join"]
    assert rec["overflow"] is False
    # the twins launch no kernel
    assert rec["kernel_launches"] == {"djt_join_scans": 0,
                                      "djt_stream_compact": 0,
                                      "djt_expand_gather": 0}


def test_driver_equals_the_jax_program_on_its_tables(cpu_run):
    rec, _, tables = cpu_run
    mod = _jax_export_module()
    out_rows = int(np.ceil(ROWS * 1.2))
    looped, _ = mod.build_looped_join(ROWS, ROWS, ITERS, out_rows,
                                      jnp.int64, jnp.int64)
    cols = [c.numpy() for c in E.load_tables(tables, ROWS, ROWS)]
    total, overflow, checksum = jax.jit(looped)(*[jnp.asarray(c)
                                                  for c in cols])
    assert int(total) == rec["total_matches_x_iters"]
    assert bool(overflow) == rec["overflow"]
    assert int(checksum) == rec["dce_guard_checksum"]


def test_driver_equals_the_numpy_reference(cpu_run):
    rec, _, tables = cpu_run
    cols = E.load_tables(tables, ROWS, ROWS)
    assert E.numpy_reference(cols, ITERS, int(np.ceil(ROWS * 1.2))) == [
        rec["total_matches_x_iters"], rec["overflow"],
        rec["dce_guard_checksum"]]


def test_driver_at_the_card_test_size_equals_the_jax_program(driver,
                                                            tmp_path):
    """The card test's 64 K rows: the driver's twins, the numpy
    reference and the JAX package's program give the numbers the card
    test holds the kernel path to."""
    art, tables = tmp_path / "art", tmp_path / "tables"
    E.main(["--device", "cpu", "--build-table-nrows", str(CARD_ROWS),
            "--probe-table-nrows", str(CARD_ROWS), "--iterations",
            str(ITERS), "-o", str(art)])
    r = subprocess.run([driver, "--artifact-dir", str(art), "--device",
                        "cpu", "--dump-tables", str(tables)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    cols = [c.numpy() for c in E.load_tables(tables, CARD_ROWS, CARD_ROWS)]
    out_rows = int(np.ceil(CARD_ROWS * 1.2))
    looped, _ = _jax_export_module().build_looped_join(
        CARD_ROWS, CARD_ROWS, ITERS, out_rows, jnp.int64, jnp.int64)
    total, overflow, checksum = jax.jit(looped)(*[jnp.asarray(c)
                                                  for c in cols])
    assert [int(total), bool(overflow), int(checksum)] == JAX_AT_CARD_ROWS
    assert [rec["total_matches_x_iters"], rec["overflow"],
            rec["dce_guard_checksum"]] == JAX_AT_CARD_ROWS
    assert E.numpy_reference(cols, ITERS, out_rows) == JAX_AT_CARD_ROWS


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_reference_on_repeated_keys_and_invalid_rows(seed):
    """Repeated build keys and invalid rows on both sides: the reference
    against a loop over the pairs and the port's build_looped_join."""
    rng = np.random.default_rng(seed)
    nb, npr, iters = 300, 400, 3
    cols = [rng.integers(0, 120, nb), rng.integers(-50, 50, nb),
            rng.random(nb) < 0.9, rng.integers(0, 200, npr),
            rng.integers(-50, 50, npr), rng.random(npr) < 0.8]
    bk, bp, bv, pk, pp, pv = cols
    pairs, one = 0, 0
    for j in np.flatnonzero(pv):
        for i in np.flatnonzero(bv & (bk == pk[j])):
            pairs += 1
            one += int(pk[j]) + int(bp[i]) + int(pp[j])
    want = [iters * pairs, False,
            iters * one + pairs * (iters * (iters - 1) // 2)]
    out_rows = 4 * pairs
    assert E.numpy_reference(cols, iters, out_rows) == want
    looped, _ = E.build_looped_join(nb, npr, iters, out_rows, "cpu")
    got = looped(*[torch.from_numpy(np.asarray(c)) for c in cols])
    assert [int(got[0]), bool(got[1]), int(got[2])] == want
    assert E.numpy_reference(cols, iters, pairs - 9) == [iters * pairs,
                                                         True, None]


def test_driver_equals_the_port_loop_on_its_tables(cpu_run):
    rec, _, tables = cpu_run
    looped, args = E.build_looped_join(ROWS, ROWS, ITERS,
                                       int(np.ceil(ROWS * 1.2)), "cpu")
    cols = E.load_tables(tables, ROWS, ROWS, "cpu")
    assert [a[0] for a in args] == list(E.ARG_NAMES)
    total, overflow, checksum = looped(*cols)
    assert total.dtype == checksum.dtype == torch.int64
    assert (int(total), bool(overflow), int(checksum)) == (
        rec["total_matches_x_iters"], rec["overflow"],
        rec["dce_guard_checksum"])


def test_dumped_tables_are_the_generator_s(cpu_run):
    rec, _, tables = cpu_run
    bk, bp, bv, pk, pp, pv = [c.numpy() for c in E.load_tables(
        tables, ROWS, ROWS)]
    assert sorted(bk.tolist()) == list(range(ROWS))
    # the keys are shuffled in place, the payloads are not
    assert (bp == 2 * np.arange(ROWS)).all()
    assert bv.all() and pv.all()
    assert (pp == np.arange(ROWS)).all()
    assert int((pk < ROWS).sum()) == rec["probe_hits"]
    assert ((pk >= 0) & (pk < 2 * ROWS)).all()


def test_sidecar_equals_the_jax_export(cpu_run, tmp_path):
    _, art, _ = cpu_run
    mod = _jax_export_module()
    mod.main(["--build-table-nrows", str(ROWS), "--probe-table-nrows",
              str(ROWS), "--iterations", str(ITERS), "-o", str(tmp_path)])
    want = json.load(open(tmp_path / "join_step.json"))
    got = json.load(open(os.path.join(art, "join_step.json")))
    assert got.pop("device") == "cpu"
    for key in ("platforms", "artifact"):
        want.pop(key)
    assert got == want
    meta = dict(line.split("=", 1) for line in open(
        os.path.join(art, "join_step.meta")).read().splitlines())
    for nm in E.DRIVER_KERNELS:
        assert meta[f"lib_{nm}"].endswith(".so")


@pytest.mark.parametrize("argv,needle", [
    (["--communicator", "tpu"], "TPU backend"),
    (["--communicator", "nccl"], "launcher"),
    (["--communicator", "ucx"], "launcher"),
    (["--plugin", "libtpu.so"], "PJRT"),
    (["--selftest-exec"], "PJRT"),
    (["--key-type", "float64"], "int64 only"),
    (["--device", "tpu"], "cuda or cpu"),
    (["--bogus"], "unknown flag"),
])
def test_driver_refusals(driver, argv, needle):
    r = _run(driver, *argv)
    assert r.returncode == 1 and needle in r.stderr, r.stderr


def test_driver_refuses_a_size_mismatch(driver, cpu_run):
    _, art, _ = cpu_run
    r = _run(driver, "--artifact-dir", art, "--device", "cpu",
             "--build-table-nrows", str(ROWS + 8))
    assert r.returncode == 1 and "mismatches the meta" in r.stderr


def test_driver_accepts_the_reference_flags(driver, cpu_run):
    _, art, _ = cpu_run
    r = _run(driver, "--artifact-dir", art, "--device", "cpu",
             "--registration-method", "buffer", "--compression",
             "--key-type", "int64", "--payload-type", "int64",
             "--communicator", "local")
    assert r.returncode == 0, r.stderr


def test_default_device_without_a_card_exits_1_naming_cuda(driver, cpu_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    _, art, _ = cpu_run
    for argv in ([], ["--artifact-dir", art], ["--selftest"]):
        r = _run(driver, *argv)
        assert r.returncode == 1 and "CUDA" in r.stderr, r.stderr
        assert r.stdout == ""


def test_export_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        E.main(["--device", "cuda"])
