"""The port's process-group backend on the CPU: real OS processes, one
rank each, started by the port's launcher over gloo, against the
in-process ``EmulatedCommunicator`` and the JAX package's ``tpu``
communicator on the 8 virtual CPU devices (tests/conftest.py).

One launch a world size (2 and 4 processes) runs a worker that does
every exchange and join of the cases below on the same global tables
(made here, passed as numpy files) and writes each rank's results; the
tests hold them against the other two implementations. Also: the skew
sidecar's uint64 hash gather, ``ragged_all_to_all``, dtypes on the wire,
the launcher's failure semantics, the bootstrap deadline and the
all-to-all benchmark. Every subprocess has a timeout.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.parallel import faults as jfaults
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.parallel.shuffle import (
    shuffle_padded as jshuffle_padded,
)
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils.generators import (
    generate_build_probe_tables as jgenerate,
)
from distributed_join_tpu_torch.benchmarks import all_to_all as ta2a
from distributed_join_tpu_torch.parallel import faults as tfaults
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
    make_communicator,
)
from distributed_join_tpu_torch.parallel.mesh import make_hierarchical_mesh
from distributed_join_tpu_torch.table import Table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
NAMES = ["key", "build_payload", "probe_payload"]

# the joins each world size runs: (tables, options)
JOIN_CASES = {
    "plain": ("uniform", dict(out_capacity_factor=3.0)),
    "k2": ("uniform", dict(over_decomposition=2, out_capacity_factor=4.0)),
    # the first rung's output block overflows; one retry relieves it
    "ladder": ("uniform", dict(out_capacity_factor=1.0, auto_retry=1)),
}
SKEW_OPTS = dict(skew_threshold=0.05, hh_slots=32, auto_retry=1,
                 out_capacity_factor=2.0)
SHUFFLE_CAP = 4096  # no bucket of the probe side overflows it
RAGGED_LEN = 40
DTYPE_ROWS = 8  # rows a rank: one block of 4 or 2 rows a peer
LADDER_FIELDS = ("attempt", "action", "overflow", "shuffle_capacity_factor",
                 "out_capacity_factor", "out_rows_per_rank")

WORKER = r'''
import json, sys
import numpy as np
import torch
from distributed_join_tpu_torch.ops.partition import radix_hash_partition
from distributed_join_tpu_torch.parallel import bootstrap
from distributed_join_tpu_torch.parallel.communicator import make_communicator
from distributed_join_tpu_torch.parallel.distributed_join import (
    distributed_inner_join)
from distributed_join_tpu_torch.parallel.shuffle import shuffle_padded
from distributed_join_tpu_torch.table import Table

spec = json.load(open(sys.argv[1]))
assert bootstrap.maybe_initialize_from_env()
comm = make_communicator("gloo")
n, r = comm.n_ranks, comm.axis_index()
out = {}


def table(path, side):
    z = np.load(path)
    cols = {k.split("/", 1)[1]: z[k] for k in z.files
            if k.startswith(side + "/")}
    return Table.from_numpy(cols, z[side + "_valid"], device="cpu")


def save_result(prefix, res):
    cols, valid = res.table.to_numpy()
    for k, v in cols.items():
        out[f"{prefix}/col/{k}"] = v
    out[f"{prefix}/valid"] = valid
    out[f"{prefix}/total"] = np.int64(int(res.total))
    out[f"{prefix}/overflow"] = np.bool_(bool(res.overflow))
    out[f"{prefix}/attempts"] = np.array(json.dumps(
        [a.as_record() for a in res.retry_report.attempts]))


for name, case in spec["joins"].items():
    b, p = table(case["tables"], "build"), table(case["tables"], "probe")
    save_result(name, distributed_inner_join(b, p, comm, **case["opts"]))

# the padded shuffle of the probe side, one batch
b, p = table(spec["shuffle_tables"], "build"), table(spec["shuffle_tables"],
                                                     "probe")

def shuffle(t):
    pt = radix_hash_partition(t, ["key"], n)
    padded, counts, ovf, _ = pt.to_padded(spec["shuffle_cap"])
    recv, rc = shuffle_padded(comm, padded, counts, spec["shuffle_cap"])
    return recv, rc, comm.psum(ovf.to(torch.int32))

recv, rc, ovf = comm.spmd(shuffle)(p)
out["shuffle/counts"] = rc.numpy()
out["shuffle/overflow"] = np.int64(int(ovf))
for k, v in recv.columns.items():
    out[f"shuffle/col/{k}"] = v.numpy()
out["shuffle/valid"] = recv.valid.numpy()

# ragged_all_to_all: rank r's operand and vectors are row r of each
z = np.load(spec["ragged"])
got = comm.ragged_all_to_all(
    *(torch.from_numpy(z[k][r]) for k in (
        "operand", "output", "input_offsets", "send_sizes",
        "output_offsets", "recv_sizes")))
out["ragged"] = got.numpy()

# dtypes on the wire: this rank's rows of each global array
z = np.load(spec["dtypes"])
for k in z.files:
    x = torch.from_numpy(z[k])
    if k.startswith("u64"):
        x = x.view(torch.uint64)
    x = comm.spmd(lambda t: t)(x)
    a2a, gat, tot = comm.all_to_all(x), comm.all_gather(x), comm.psum(x)
    for tag, v in (("a2a", a2a), ("gather", gat), ("psum", tot)):
        assert v.dtype == x.dtype, (k, tag, v.dtype)
        v = v.view(torch.int64) if v.dtype == torch.uint64 else v
        out[f"dtype/{k}/{tag}"] = v.numpy()

if "skew_tables" in spec:
    b = table(spec["skew_tables"], "build")
    p = table(spec["skew_tables"], "probe")
    save_result("skew", distributed_inner_join(b, p, comm,
                                               **spec["skew_opts"]))

np.savez(f"{spec['out']}/rank{r}.npz", **out)
bootstrap.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(n: int, command: list, cpu: bool = True,
            timeout: float = TIMEOUT_S) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "distributed_join_tpu_torch.benchmarks.launch",
           "--num-processes", str(n),
           *(["--cpu-devices-per-process", "1"] if cpu else []),
           "--coordinator", f"localhost:{_free_port()}", "--", *command]
    return subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def _save_tables(path, build_cols, build_valid, probe_cols, probe_valid):
    arrays = {f"build/{k}": np.asarray(v) for k, v in build_cols.items()}
    arrays.update({f"probe/{k}": np.asarray(v) for k, v in probe_cols.items()})
    np.savez(path, build_valid=np.asarray(build_valid),
             probe_valid=np.asarray(probe_valid), **arrays)


@functools.lru_cache(maxsize=None)
def _uniform_tables():
    """4,096 x 8,192 rows, keys in [0, 2048), selectivity 0.5, duplicate
    build keys: made by the JAX package's generator, held as numpy."""
    b, p = jgenerate(seed=42, build_nrows=4096, probe_nrows=8192,
                     rand_max=2048, selectivity=0.5)
    return ({k: np.asarray(v) for k, v in b.columns.items()},
            np.asarray(b.valid),
            {k: np.asarray(v) for k, v in p.columns.items()},
            np.asarray(p.valid))


@functools.lru_cache(maxsize=None)
def _zipf_tables():
    rng = np.random.default_rng(1)
    u = rng.uniform(1e-12, 1.0, 16384)
    pk = np.clip(np.minimum(u ** (-2.0), 4096).astype(np.int64) - 1, 0, 4095)
    bc = {"key": np.arange(4096, dtype=np.int64),
          "build_payload": rng.integers(-(1 << 40), 1 << 40, 4096)}
    pc = {"key": pk, "probe_payload": np.arange(16384)}
    return bc, np.ones(4096, bool), pc, np.ones(16384, bool)


def _ragged_inputs(n: int) -> dict:
    """Rank i sends sizes[i][j] rows to rank j, from a shuffled window
    of its operand, each into a window the sender picks in j's output
    (senders in rank order, after a gap of 3 rows)."""
    rng = np.random.default_rng(n)
    sizes = rng.integers(0, 7, (n, n))
    operand = rng.integers(-(1 << 50), 1 << 50, (n, RAGGED_LEN, 3))
    input_offsets = np.zeros((n, n), np.int64)
    for i in range(n):
        order = rng.permutation(n)
        at = 1
        for j in order:
            input_offsets[i, j] = at
            at += sizes[i, j]
    output_offsets = np.zeros((n, n), np.int64)
    for j in range(n):
        at = 3
        for i in range(n):
            output_offsets[i, j] = at
            at += sizes[i, j]
    output = np.full((n, RAGGED_LEN, 3), -1, np.int64)
    return {"operand": operand, "output": output,
            "input_offsets": input_offsets.astype(np.int32),
            "send_sizes": sizes.astype(np.int32),
            "output_offsets": output_offsets.astype(np.int32),
            "recv_sizes": sizes.T.copy().astype(np.int32)}


def _dtype_arrays(n: int) -> dict:
    """Global arrays of every dtype the port ships, DTYPE_ROWS * n rows
    each (integer-valued float64, so the psum is exact in any order)."""
    rng = np.random.default_rng(100 + n)
    m = DTYPE_ROWS * n
    u64 = rng.integers(0, 1 << 63, m, dtype=np.uint64) | np.uint64(1 << 63)
    return {
        "u64": u64.view(np.int64),
        "bool": rng.random(m) < 0.5,
        "int8": rng.integers(-128, 128, m).astype(np.int8),
        "float64": rng.integers(-1000, 1000, m).astype(np.float64),
        "bytes2d": rng.integers(0, 256, (m, 5)).astype(np.uint8),
    }


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    """One gloo launch a world size; ``{n: (per-rank results, inputs)}``."""
    runs = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"gloo{n}")
        _save_tables(d / "uniform.npz", *_uniform_tables())
        ragged = _ragged_inputs(n)
        np.savez(d / "ragged.npz", **ragged)
        dtypes = _dtype_arrays(n)
        np.savez(d / "dtypes.npz", **dtypes)
        spec = {"out": str(d),
                "joins": {c: {"tables": str(d / f"{t}.npz"), "opts": o}
                          for c, (t, o) in JOIN_CASES.items()},
                "shuffle_tables": str(d / "uniform.npz"),
                "shuffle_cap": SHUFFLE_CAP,
                "ragged": str(d / "ragged.npz"),
                "dtypes": str(d / "dtypes.npz")}
        if n == 2:
            _save_tables(d / "zipf.npz", *_zipf_tables())
            spec["skew_tables"] = str(d / "zipf.npz")
            spec["skew_opts"] = SKEW_OPTS
        (d / "spec.json").write_text(json.dumps(spec))
        (d / "worker.py").write_text(WORKER)
        t0 = time.monotonic()
        r = _launch(n, [sys.executable, str(d / "worker.py"),
                        str(d / "spec.json")])
        assert r.returncode == 0, r.stderr[-4000:]
        assert time.monotonic() - t0 < TIMEOUT_S
        ranks = [dict(np.load(d / f"rank{i}.npz")) for i in range(n)]
        runs[n] = (ranks, {"ragged": ragged, "dtypes": dtypes})
    return runs


@pytest.fixture(scope="module")
def jcomms():
    return {n: jcomm.make_communicator("tpu", n_ranks=n) for n in (2, 4)}


def _jtable(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _ttable(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _multiset(cols: dict, valid, names) -> np.ndarray:
    """Valid rows as a lexicographically sorted (rows, cols) int64
    array: a multiset in canonical order."""
    valid = np.asarray(valid)
    a = np.stack([np.asarray(cols[k])[valid].astype(np.int64)
                  for k in names], axis=1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def _per_rank(cols: dict, valid, n: int, names) -> list:
    """The multisets of each rank's part of a row-sharded result."""
    valid = np.asarray(valid)
    m = valid.shape[0] // n
    return [_multiset({k: np.asarray(cols[k])[i * m:(i + 1) * m]
                       for k in names}, valid[i * m:(i + 1) * m], names)
            for i in range(n)]


def _gloo_part(rank: dict, prefix: str, names) -> np.ndarray:
    return _multiset({k: rank[f"{prefix}/col/{k}"] for k in names},
                     rank[f"{prefix}/valid"], names)


def _attempts(report) -> list:
    return [{f: getattr(a, f) for f in LADDER_FIELDS}
            for a in report.attempts]


# -- (a), (b): joins over 2 and 4 gloo processes ------------------------


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_gloo_join_equals_emulated_and_jax(worker_runs, jcomms, n, case):
    """Rows of each rank, total, overflow and the retry trail of the
    launched gloo join equal the emulated join's and the JAX package's
    on the same global tables (plain; over-decomposition 2; the ladder
    from an overflowing first rung)."""
    ranks, _ = worker_runs[n]
    bc, bv, pc, pv = _uniform_tables()
    opts = JOIN_CASES[case][1]
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomms[n], **opts)
    emu = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(n), **opts)
    assert not bool(want.overflow) and not bool(emu.overflow)
    totals = {int(rk[f"{case}/total"]) for rk in ranks}
    assert totals == {int(emu.total)} == {int(want.total)}
    assert int(want.total) > 0
    assert not any(bool(rk[f"{case}/overflow"]) for rk in ranks)
    trails = {rk[f"{case}/attempts"].item() for rk in ranks}
    assert len(trails) == 1  # every rank took the same rungs
    got_trail = [{f: a[f] for f in LADDER_FIELDS}
                 for a in json.loads(trails.pop())]
    assert got_trail == _attempts(emu.retry_report) == _attempts(
        want.retry_report)
    if case == "ladder":
        assert len(got_trail) == 2 and got_trail[0]["overflow"]
    gloo = [_gloo_part(rk, case, NAMES) for rk in ranks]
    ecols, evalid = emu.table.to_numpy()
    jcols = {k: np.asarray(v) for k, v in want.table.columns.items()}
    for i, (g, e, j) in enumerate(zip(
            gloo, _per_rank(ecols, evalid, n, NAMES),
            _per_rank(jcols, want.table.valid, n, NAMES))):
        np.testing.assert_array_equal(g, e, err_msg=f"rank {i}")
        np.testing.assert_array_equal(g, j, err_msg=f"rank {i}")


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_shuffle_equals_emulated_and_jax(worker_runs, jcomms, n):
    """The padded shuffle of the probe side: each rank's received
    counts exactly, and its received block as a sorted multiset."""
    ranks, _ = worker_runs[n]
    _, _, pc, pv = _uniform_tables()
    names = sorted(pc)

    def jstep(t):
        pt = jpart.radix_hash_partition(t, ["key"], n)
        padded, counts, _, _ = pt.to_padded(SHUFFLE_CAP)
        return jshuffle_padded(jcomms[n], padded, counts, SHUFFLE_CAP)

    jrecv, jcounts = jcomms[n].spmd(jstep)(_jtable(pc, pv))
    emu = EmulatedCommunicator(n)

    def tstep(t):
        from distributed_join_tpu_torch.ops.partition import (
            radix_hash_partition,
        )
        from distributed_join_tpu_torch.parallel.shuffle import (
            shuffle_padded,
        )
        pt = radix_hash_partition(t, ["key"], n)
        padded, counts, _, _ = pt.to_padded(SHUFFLE_CAP)
        return shuffle_padded(emu, padded, counts, SHUFFLE_CAP)

    erecv, ecounts = emu.spmd(tstep)(_ttable(pc, pv))
    gcounts = np.concatenate([rk["shuffle/counts"] for rk in ranks])
    np.testing.assert_array_equal(gcounts, ecounts.numpy())
    np.testing.assert_array_equal(gcounts, np.asarray(jcounts))
    assert all(int(rk["shuffle/overflow"]) == 0 for rk in ranks)
    ecols, evalid = erecv.to_numpy()
    jcols = {k: np.asarray(v) for k, v in jrecv.columns.items()}
    for i, (rk, e, j) in enumerate(zip(
            ranks, _per_rank(ecols, evalid, n, names),
            _per_rank(jcols, jrecv.valid, n, names))):
        g = _gloo_part(rk, "shuffle", names)
        assert len(g) == int(rk["shuffle/counts"].sum()) > 0
        np.testing.assert_array_equal(g, e, err_msg=f"rank {i}")
        np.testing.assert_array_equal(g, j, err_msg=f"rank {i}")


# -- (c): the skew sidecar over 2 gloo processes --------------------------


def test_gloo_skew_join_gathers_uint64_hashes(worker_runs, jcomms):
    """The skew sidecar all-gathers uint64 key hashes (gloo has no
    uint64): the 2-process Zipf join equals the emulated and JAX joins,
    first rung overflowing its HH blocks and one retry relieving them."""
    ranks, _ = worker_runs[2]
    bc, bv, pc, pv = _zipf_tables()
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomms[2], **SKEW_OPTS)
    emu = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(2), **SKEW_OPTS)
    assert {int(rk["skew/total"]) for rk in ranks} == {int(emu.total)} == {
        int(want.total)}
    trail = json.loads(ranks[0]["skew/attempts"].item())
    assert [{f: a[f] for f in LADDER_FIELDS} for a in trail] == _attempts(
        want.retry_report) == _attempts(emu.retry_report)
    assert not bool(want.overflow) and not any(
        bool(rk["skew/overflow"]) for rk in ranks)
    ecols, evalid = emu.table.to_numpy()
    jcols = {k: np.asarray(v) for k, v in want.table.columns.items()}
    for i, (rk, e, j) in enumerate(zip(
            ranks, _per_rank(ecols, evalid, 2, NAMES),
            _per_rank(jcols, want.table.valid, 2, NAMES))):
        np.testing.assert_array_equal(_gloo_part(rk, "skew", NAMES), e)
        np.testing.assert_array_equal(_gloo_part(rk, "skew", NAMES), j)


# -- (d): ragged_all_to_all ------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_ragged_all_to_all_gloo_and_emulated_equal_jax(worker_runs, jcomms, n):
    """Exact-size exchange with shuffled send windows and gapped receive
    windows: gloo (all_to_all_single with split sizes), the emulated and
    local backends' emulation, and JAX's semantics give the same
    buffers."""
    ranks, inputs = worker_runs[n]
    z = inputs["ragged"]
    keys = ("operand", "output", "input_offsets", "send_sizes",
            "output_offsets", "recv_sizes")
    jc = jcomms[n]
    want = jc.spmd(lambda *a: jc.ragged_all_to_all(*(x[0] for x in a))[None])(
        *(jnp.asarray(z[k]) for k in keys))
    emu = EmulatedCommunicator(n)
    got_emu = emu.spmd(lambda *a: emu.ragged_all_to_all(
        *(x[0] for x in a))[None])(*(torch.from_numpy(z[k]) for k in keys))
    want = np.asarray(want)
    np.testing.assert_array_equal(got_emu.numpy(), want)
    for i, rk in enumerate(ranks):
        np.testing.assert_array_equal(rk["ragged"], want[i])
    # the one-rank emulation: everything to itself
    one = {k: z[k][:1, ...] if z[k].ndim == 3 else z[k][:1, :1]
           for k in keys}
    local = LocalCommunicator().ragged_all_to_all(
        *(torch.from_numpy(one[k][0]) for k in keys))
    jone = jcomm.make_communicator("local").ragged_all_to_all(
        *(jnp.asarray(one[k][0]) for k in keys))
    np.testing.assert_array_equal(local.numpy(), np.asarray(jone))


# -- (e): dtypes on the wire -----------------------------------------------


@pytest.mark.parametrize("dtype", ["u64", "bool", "int8", "float64",
                                   "bytes2d"])
@pytest.mark.parametrize("n", [2, 4])
def test_dtypes_cross_gloo_bit_exact(worker_runs, n, dtype):
    """all_to_all, all_gather and psum over gloo keep the dtype and equal
    the emulated collectives bit for bit (uint64, which gloo lacks,
    included)."""
    ranks, inputs = worker_runs[n]
    x = torch.from_numpy(inputs["dtypes"][dtype])
    if dtype == "u64":
        x = x.view(torch.uint64)
    emu = EmulatedCommunicator(n)
    a2a, gat, tot = emu.spmd(lambda t: (
        emu.all_to_all(t), emu.all_gather(t)[None], emu.psum(t)))(x)
    m = x.shape[0] // n
    for i, rk in enumerate(ranks):
        for tag, want in (("a2a", a2a[i * m:(i + 1) * m]), ("gather", gat[i]),
                          ("psum", tot[i * m:(i + 1) * m])):
            want = want.view(torch.int64) if want.dtype == torch.uint64 \
                else want
            got = rk[f"dtype/{dtype}/{tag}"]
            assert got.dtype == want.numpy().dtype, (tag, got.dtype)
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=f"{tag} rank {i}")


# -- (f), (g): the launcher and the bootstrap ----------------------------


def test_launcher_takes_the_job_down_with_the_first_failing_rank():
    code = ("import os, sys, time\n"
            "r = int(os.environ['DJTPU_PROCESS_ID'])\n"
            "sys.exit(3) if r == 1 else time.sleep(60)\n")
    t0 = time.monotonic()
    r = _launch(3, [sys.executable, "-c", code], timeout=60)
    assert time.monotonic() - t0 < 30  # the sleepers were terminated
    assert r.returncode == 3
    assert "process 1 exited with rc=3" in r.stderr


def test_launcher_refusals():
    """Flags the port lacks refuse by name, several ranks a process are
    refused, and NCCL without enough cards is refused before a process
    starts (no fallback to the CPU)."""
    base = [sys.executable, "-m",
            "distributed_join_tpu_torch.benchmarks.launch",
            "--num-processes", "2"]
    for extra, match in ((["--slices", "2"], "--slices"),
                         (["--cpu-devices-per-process", "4"], "one rank"),
                         (["--telemetry", "x"], "--telemetry")):
        r = subprocess.run([*base, *extra, "--", "true"], env=_env(),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode != 0 and match in r.stderr, r.stderr
    if not torch.cuda.is_available():
        r = subprocess.run([*base, "--", "true"], env=_env(),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode != 0 and "CUDA devices" in r.stderr, r.stderr


def test_bootstrap_against_a_silent_coordinator_raises_in_its_deadline():
    """Process 1 of 2 against a port nobody serves: BootstrapError with
    its record, inside the 5 s deadline."""
    code = (
        "import json, sys, time\n"
        "from distributed_join_tpu_torch.parallel import bootstrap\n"
        "t0 = time.monotonic()\n"
        "try:\n"
        f"    bootstrap.initialize('localhost:{_free_port()}', 2, 1,\n"
        "        cpu_devices_per_process=1, deadline_s=5.0, max_retries=3,\n"
        "        backoff_s=0.5)\n"
        "except bootstrap.BootstrapError as exc:\n"
        "    print(json.dumps({'s': time.monotonic() - t0,\n"
        "                      'record': exc.record()}))\n"
        "    sys.exit(0)\n"
        "sys.exit('no BootstrapError')\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["s"] < 5.0 + 1.0
    rec = out["record"]
    assert rec["error"] == "BootstrapError" and rec["deadline_s"] == 5.0
    assert rec["coordinator"].startswith("localhost:")
    assert rec["attempts"] and rec["attempts"][-1]["error"]


def test_bootstrap_refuses_several_ranks_a_process_and_nccl_without_a_card():
    from distributed_join_tpu_torch.parallel import bootstrap
    with pytest.raises(ValueError, match="one rank a process"):
        bootstrap.initialize("localhost:1", 2, 0, cpu_devices_per_process=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            bootstrap.initialize("localhost:1", 1, 0, deadline_s=1.0)


def test_retry_with_backoff_matches_jax():
    """The handshake's retry loop: the same trail, sleeps and final error
    as the JAX package's on a scripted failure sequence and clock."""
    def run(impl, fails, deadline):
        state = {"t": 0.0, "calls": 0}
        sleeps = []

        def fn():
            state["calls"] += 1
            state["t"] += 0.25
            if state["calls"] <= fails:
                raise ConnectionError(f"refused {state['calls']}")
            return "ok"

        def sleep(d):
            sleeps.append(d)
            state["t"] += d

        try:
            res, trail = impl(fn, max_attempts=4, backoff_s=1.0,
                              deadline_s=deadline, sleep=sleep,
                              clock=lambda: state["t"])
            return res, trail, sleeps
        except ConnectionError as exc:
            return str(exc), exc._retry_attempts, sleeps

    for fails, deadline in ((2, None), (9, None), (9, 2.0), (0, 1.0)):
        assert run(tfaults.retry_with_backoff, fails, deadline) == run(
            jfaults.retry_with_backoff, fails, deadline)


def test_make_communicator_names_and_refusals():
    assert make_communicator("local").n_ranks == 1
    assert make_communicator("emulated", n_ranks=3).n_ranks == 3
    for name, kw, match in (("ucx", {}, "ucx"), ("tpu", {}, "nccl"),
                            ("local", {"n_slices": 2}, "hierarchical"),
                            ("emulated", {}, "n_ranks"),
                            ("nccl", {}, "no process group"),
                            ("gloo", {}, "no process group")):
        with pytest.raises((ValueError, RuntimeError), match=match):
            make_communicator(name, **kw)
    with pytest.raises(NotImplementedError, match="hierarchical"):
        make_hierarchical_mesh(2)


# -- (h): the all-to-all benchmark ---------------------------------------


def test_all_to_all_benchmark_record_matches_jax_over_gloo(tmp_path):
    """Two gloo processes: exit 0 (the checksum held), one record on
    stdout from rank 0 only, its keys those of the JAX benchmark's
    record."""
    out = tmp_path / "a2a.json"
    r = _launch(2, [sys.executable, "-m",
                    "distributed_join_tpu_torch.benchmarks.all_to_all",
                    "--communicator", "gloo", "--buffer-size", "65536",
                    "--iterations", "3", "--json-output", str(out)])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    head = [ln for ln in r.stdout.splitlines()
            if ln.startswith("all-to-all:")]
    assert len(head) == 1 and "median of 5 windows" in head[0]
    assert len(head[0].split("ms an exchange: ")[1].split()) == ta2a.WINDOWS
    rec = json.loads(lines[0])
    assert rec == json.loads(out.read_text())
    assert rec["n_ranks"] == 2 and rec["communicator"] == "gloo"
    assert rec["buffer_bytes_per_rank"] == 65536 and rec["rank"] == 0
    assert rec["aggregate_offchip_gb_per_sec"] > 0

    from distributed_join_tpu.benchmarks import all_to_all as ja2a
    jrec = ja2a.run(ja2a.parse_args(
        ["--communicator", "tpu", "--n-ranks", "2", "--buffer-size", "65536",
         "--iterations", "2"]))
    assert set(rec) == set(jrec)


def test_all_to_all_benchmark_refuses_one_rank_and_unported_flags():
    r = _launch(1, [sys.executable, "-m",
                    "distributed_join_tpu_torch.benchmarks.all_to_all",
                    "--communicator", "gloo", "--buffer-size", "4096"])
    assert r.returncode != 0 and "needs >= 2 ranks" in r.stderr
    for flag in ("--verify-integrity", "--explain", "--chaos-seed"):
        with pytest.raises(SystemExit):
            ta2a.parse_args([flag])


@pytest.mark.parametrize("n", [2, 3])
def test_chained_exchanges_checksum_on_emulated_ranks(n):
    """The benchmark's chained loop moves values only: its checksum is
    the same arithmetic on the global buffer with no exchange."""
    x = torch.arange(n * n * 50, dtype=torch.float32) * 7.5e4
    emu = EmulatedCommunicator(n)
    got = emu.spmd(lambda t: ta2a.chained_exchanges(emu, t, 5),
                   sharded_out=True)(x)
    assert int(got) == ta2a.expected_checksum(x, 5)


def test_config_driver_over_gloo_equals_one_rank(tmp_path):
    """The join driver launched on 2 gloo processes at over-decomposition
    2: rank 0's record only, with the 1-rank driver's match count."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    argv = ["--build-table-nrows", "8192", "--probe-table-nrows", "8192",
            "--iterations", "1"]
    out = tmp_path / "rec.json"
    r = _launch(2, [sys.executable, "-m",
                    "distributed_join_tpu_torch.benchmarks.distributed_join",
                    "--communicator", "gloo", "--n-ranks", "2",
                    "--over-decomposition-factor", "2",
                    "--json-output", str(out), *argv])
    assert r.returncode == 0, r.stderr[-3000:]
    assert len([ln for ln in r.stdout.splitlines() if ln.strip()]) == 1
    rec = json.loads(out.read_text())
    one = D.run(D.parse_args(["--communicator", "local", *argv]),
                device="cpu")
    assert rec["communicator"] == "gloo" and rec["n_ranks"] == 2
    assert rec["matches_per_join"] == one["matches_per_join"] > 0
    assert not rec["overflow"] and rec["rank"] == 0
