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

import dataclasses
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
from distributed_join_tpu.parallel import out_of_core as jooc
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.parallel.shuffle import (
    shuffle_padded as jshuffle_padded,
)
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.ops import aggregate as jagg
from distributed_join_tpu.parallel import query_exec as jquery
from distributed_join_tpu.planning.query import tpch_query_plan
from distributed_join_tpu.utils import tpch as jtpch
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
    # the wires: the exact-size exchange, the point-to-point chain, the
    # compressed padded wire, and string payloads on the byte-exact wire
    "ragged": ("uniform", dict(shuffle="ragged", over_decomposition=2,
                               out_capacity_factor=4.0)),
    "ppermute": ("uniform", dict(shuffle="ppermute", over_decomposition=2,
                                 out_capacity_factor=4.0)),
    "compressed": ("uniform", dict(compression_bits=16,
                                   out_capacity_factor=3.0)),
    "ragged_strings": ("strings", dict(shuffle="ragged",
                                       out_capacity_factor=4.0)),
    # the segmented sort: fine buckets on the padded wire, the batched
    # short-run join
    "segmented": ("uniform", dict(sort_mode="segmented", sort_segments=4,
                                  over_decomposition=2,
                                  shuffle_capacity_factor=3.0,
                                  out_capacity_factor=4.0)),
}
# the hierarchical wire over 4 processes as 2 slices x 2 (gloo subgroups)
HIER_SLICES = 2
HIER_CASES = {
    "hier_off": dict(shuffle="hierarchical", dcn_codec="off",
                     over_decomposition=2, out_capacity_factor=3.0),
    "hier_on": dict(shuffle="hierarchical", dcn_codec="on",
                    compression_bits=4, auto_retry=3,
                    out_capacity_factor=3.0),
    "hier_segmented": dict(shuffle="hierarchical", dcn_codec="off",
                           sort_mode="segmented", sort_segments=4,
                           shuffle_capacity_factor=3.0,
                           out_capacity_factor=4.0),
}
SKEW_OPTS = dict(skew_threshold=0.05, hh_slots=32, auto_retry=1,
                 out_capacity_factor=2.0)
# the resident table's probe-only joins over 2 gloo processes: k = 1,
# k = 2 on the ragged wire, and a first rung that overflows
RESIDENT_JOINS = [dict(out_capacity_factor=4.0),
                  dict(over_decomposition=2, shuffle="ragged",
                       out_capacity_factor=4.0),
                  dict(out_capacity_factor=0.5, auto_retry=2)]
# fault plans over 2 gloo processes (parallel/faults.py), on the uniform
# tables: the ladder from injected overflows, and the batch loop's retry
# and degradation
FAULT_JOINS = {
    "fault_ladder": dict(plan={"overflow_programs": 2},
                         opts=dict(auto_retry=3, out_capacity_factor=3.0)),
    "fault_bits": dict(plan={"overflow_programs": 2},
                       opts=dict(auto_retry=4, out_capacity_factor=3.0,
                                 shuffle_capacity_factor=2.5,
                                 compression_bits=8)),
}
FAULT_LOOP_OPTS = dict(n_batches=4, warmup=False, batch_retries=1,
                       batch_retry_backoff_s=0.01, out_capacity_factor=3.0,
                       shuffle_capacity_factor=3.0)
FAULT_LOOPS = {
    "loop_retry": dict(plan={"fail_dispatches": 1}, opts=FAULT_LOOP_OPTS),
    "loop_degrade": dict(plan={"fail_dispatches": 2},
                         opts=dict(FAULT_LOOP_OPTS,
                                   on_batch_failure="continue")),
}
# the wire digests over 2 gloo processes (parallel/integrity.py): clean
# verified joins on each flat wire, then each corruption mode on the
# padded and ragged wires with a budget of one (the retry_integrity rung
# recovers) and one unbounded bit flip (IntegrityError on every rank)
INTEGRITY_CLEAN = {
    "int_padded": dict(out_capacity_factor=3.0),
    "int_ragged": dict(shuffle="ragged", over_decomposition=2,
                       out_capacity_factor=4.0),
    "int_ppermute": dict(shuffle="ppermute", out_capacity_factor=3.0),
    "int_compressed": dict(compression_bits=16, auto_retry=2,
                           out_capacity_factor=3.0),
}
INTEGRITY_MODES = ("bit_flip", "row_truncate", "row_duplicate", "misroute")
INTEGRITY_CORRUPT = {
    **{f"int_{wire}_{mode}": dict(
        plan={"seed": 5, "corrupt_mode": mode, "corrupt_collectives": 1},
        opts=dict(shuffle=wire, auto_retry=2, out_capacity_factor=3.0))
       for wire in ("padded", "ragged") for mode in INTEGRITY_MODES},
    # a count lie on the corrupt sender's last bucket asks for a window
    # past its operand's end (zero-filled; the exchange keeps its sizes)
    "int_ragged_row_duplicate_last": dict(
        plan={"seed": 3, "corrupt_mode": "row_duplicate",
              "corrupt_collectives": 1},
        opts=dict(shuffle="ragged", auto_retry=2, out_capacity_factor=3.0)),
    "int_unbounded": dict(
        plan={"seed": 5, "corrupt_mode": "bit_flip",
              "corrupt_collectives": 1 << 30},
        opts=dict(auto_retry=2, out_capacity_factor=3.0)),
}
SHUFFLE_CAP = 4096  # no bucket of the probe side overflows it
RAGGED_LEN = 40
DTYPE_ROWS = 8  # rows a rank: one block of 4 or 2 rows a peer
LADDER_FIELDS = ("attempt", "action", "overflow", "shuffle_capacity_factor",
                 "out_capacity_factor", "out_rows_per_rank",
                 "compression_bits")

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
    chain = comm.ppermute_all_to_all(x)
    for tag, v in (("a2a", a2a), ("gather", gat), ("psum", tot),
                   ("ppermute", chain)):
        assert v.dtype == x.dtype, (k, tag, v.dtype)
        v = v.view(torch.int64) if v.dtype == torch.uint64 else v
        out[f"dtype/{k}/{tag}"] = v.numpy()

if "hier_joins" in spec:
    hcomm = make_communicator("gloo", n_slices=spec["hier_slices"])
    for name, opts in spec["hier_joins"].items():
        b = table(spec["shuffle_tables"], "build")
        p = table(spec["shuffle_tables"], "probe")
        before = hcomm.counters()
        save_result(name, distributed_inner_join(b, p, hcomm, **opts))
        after = hcomm.counters()
        out[f"{name}/counters"] = np.array(json.dumps(
            {k: after[k] - before[k] for k in after}))

for q, path in spec.get("queries", {}).items():
    from distributed_join_tpu_torch.parallel.query_exec import (
        distributed_query)
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    tables = {name: table(path, name)
              for name in ("customer", "orders", "lineitem")}
    res = distributed_query(tables, tpch_query_plan(q), comm, auto_retry=4)
    cols, valid = res.table.to_numpy()
    for k, v in cols.items():
        out[f"query_{q}/col/{k}"] = v
    out[f"query_{q}/valid"] = valid
    out[f"query_{q}/overflow"] = np.bool_(bool(res.overflow))
    out[f"query_{q}/op_totals"] = np.array([int(t) for t in res.op_totals])

if "skew_tables" in spec:
    b = table(spec["skew_tables"], "build")
    p = table(spec["skew_tables"], "probe")
    save_result("skew", distributed_inner_join(b, p, comm,
                                               **spec["skew_opts"]))

if "resident" in spec:
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry)
    cache = JoinProgramCache(comm)
    reg = ResidentTableRegistry(comm, cache)
    b = table(spec["shuffle_tables"], "build")
    p = table(spec["shuffle_tables"], "probe")
    reg.register("dim", b)
    for i, opts in enumerate(spec["resident"]["joins"]):
        save_result(f"resident{i}", reg.join("dim", p, **opts))
    z = np.load(spec["resident"]["delta"])
    reg.append("dim", Table.from_numpy({k: z[k] for k in z.files
                                        if k != "valid"}, z["valid"],
                                       device="cpu"), maintain=True)
    save_result("resident_after", reg.join("dim", p,
                                           **spec["resident"]["joins"][0]))
    h = reg.get("dim")
    out["resident/state"] = np.array(json.dumps(
        [h.rows, h.key_digest, h.generation, h.capacity_per_rank,
         h.merges, cache.stats()]))

if "faults" in spec:
    # fault plans over the process group, inside a telemetry session (one
    # event log a rank in one directory)
    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectedError, FaultInjectingCommunicator, plan_from_record)
    from distributed_join_tpu_torch.parallel.out_of_core import (
        keyrange_batched_join)
    f = spec["faults"]
    b = table(spec["shuffle_tables"], "build")
    p = table(spec["shuffle_tables"], "probe")
    with telemetry.session(f["telemetry"]):
        for name, case in f["joins"].items():
            fc = FaultInjectingCommunicator(comm,
                                            plan_from_record(case["plan"]))
            save_result(name, distributed_inner_join(b, p, fc,
                                                     **case["opts"]))
        for name, case in f["loops"].items():
            fc = FaultInjectingCommunicator(comm,
                                            plan_from_record(case["plan"]))
            stats = {}
            total, ovf = keyrange_batched_join(b, p, fc, device="cpu",
                                               stats=stats, **case["opts"])
            out[f"{name}/total"] = np.int64(total)
            out[f"{name}/overflow"] = np.bool_(ovf)
            out[f"{name}/failed"] = np.array(stats["failed_batches"],
                                             np.int64)
        try:
            distributed_inner_join(b, p, FaultInjectingCommunicator(
                comm, plan_from_record({"fail_dispatches": 1})))
            out["fault_error"] = np.array("")
        except FaultInjectedError as exc:
            out["fault_error"] = np.array(str(exc))

if "integrity" in spec:
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator, plan_from_record)
    from distributed_join_tpu_torch.parallel.integrity import IntegrityError
    g = spec["integrity"]
    b = table(spec["shuffle_tables"], "build")
    p = table(spec["shuffle_tables"], "probe")
    for name, opts in g["clean"].items():
        res = distributed_inner_join(b, p, comm, verify_integrity=True,
                                     **opts)
        save_result(name, res)
        out[f"{name}/report"] = np.array(json.dumps(
            res.integrity_report.as_record()))
    for name, case in g["corrupt"].items():
        fc = FaultInjectingCommunicator(comm, plan_from_record(case["plan"]))
        try:
            save_result(name, distributed_inner_join(
                b, p, fc, verify_integrity=True, **case["opts"]))
            out[f"{name}/error"] = np.array("")
        except IntegrityError as exc:
            out[f"{name}/error"] = np.array(str(exc))

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


def _resident_delta():
    """A 1,024-row delta of the uniform tables' build side (seed 5)."""
    rng = np.random.default_rng(5)
    cols = {"key": rng.integers(0, 2048, 1024).astype(np.int64),
            "build_payload": rng.integers(0, 1 << 40, 1024).astype(np.int64)}
    return cols, np.ones(1024, bool)


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
def _string_tables():
    """2,048 x 4,096 rows, keys in [0, 600): a variable-length 12-byte
    string payload on each side (tied lengths), with '#len'."""
    rng = np.random.default_rng(7)

    def strings(n, width):
        lens = (rng.integers(0, width + 1, n) // 4 * 4).astype(np.int32)
        raw = rng.integers(1, 256, (n, width)).astype(np.uint8)
        raw[np.arange(width)[None, :] >= lens[:, None]] = 0
        return raw, lens

    bc = {"key": rng.integers(0, 600, 2048),
          "build_payload": rng.integers(0, 1 << 20, 2048)}
    pc = {"key": rng.integers(0, 600, 4096)}
    bc["bs"], bc["bs#len"] = strings(2048, 12)
    pc["ps"], pc["ps#len"] = strings(4096, 8)
    return bc, np.ones(2048, bool), pc, np.ones(4096, bool)


TABLES = {"uniform": _uniform_tables, "strings": _string_tables}
QUERIES = ("q3", "q10")
QUERY_SF = 0.004


@functools.lru_cache(maxsize=None)
def _query_tables(q: str) -> dict:
    """The JAX package's TPC-H query tables (SF 0.004) with ``q``'s
    filters."""
    return jtpch.query_filters(
        jtpch.generate_tpch_query_tables(seed=7, scale_factor=QUERY_SF), q)


def _query_arrays(q: str) -> dict:
    """:func:`_query_tables` as the worker's npz arrays."""
    arrays = {}
    for name, t in _query_tables(q).items():
        arrays[f"{name}_valid"] = np.asarray(t.valid)
        arrays.update({f"{name}/{k}": np.asarray(v)
                       for k, v in t.columns.items()})
    return arrays


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
        for kind, make in TABLES.items():
            _save_tables(d / f"{kind}.npz", *make())
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
        if n == 4:
            spec["hier_joins"] = HIER_CASES
            spec["hier_slices"] = HIER_SLICES
        if n == 2:
            spec["queries"] = {}
            for q in QUERIES:
                np.savez(d / f"{q}.npz", **_query_arrays(q))
                spec["queries"][q] = str(d / f"{q}.npz")
            _save_tables(d / "zipf.npz", *_zipf_tables())
            spec["skew_tables"] = str(d / "zipf.npz")
            spec["skew_opts"] = SKEW_OPTS
            cols, valid = _resident_delta()
            np.savez(d / "delta.npz", valid=valid, **cols)
            spec["resident"] = {"joins": RESIDENT_JOINS,
                                "delta": str(d / "delta.npz")}
            spec["faults"] = {"joins": FAULT_JOINS, "loops": FAULT_LOOPS,
                              "telemetry": str(d / "telemetry")}
            spec["integrity"] = {"clean": INTEGRITY_CLEAN,
                                 "corrupt": INTEGRITY_CORRUPT}
        (d / "spec.json").write_text(json.dumps(spec))
        (d / "worker.py").write_text(WORKER)
        t0 = time.monotonic()
        r = _launch(n, [sys.executable, str(d / "worker.py"),
                        str(d / "spec.json")])
        assert r.returncode == 0, r.stderr[-4000:]
        assert time.monotonic() - t0 < TIMEOUT_S
        ranks = [dict(np.load(d / f"rank{i}.npz")) for i in range(n)]
        runs[n] = (ranks, {"ragged": ragged, "dtypes": dtypes,
                           "dir": str(d)})
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
    array (a 2-D column one int64 column a byte): a multiset in
    canonical order."""
    valid = np.asarray(valid)
    parts = []
    for k in names:
        a = np.asarray(cols[k])[valid]
        parts.append(a.reshape(a.shape[0], -1).astype(np.int64))
    a = np.concatenate(parts, axis=1)
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
    kind, opts = JOIN_CASES[case]
    bc, bv, pc, pv = TABLES[kind]()
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
    names = sorted(emu.table.columns)
    assert names == sorted(want.table.columns)
    gloo = [_gloo_part(rk, case, names) for rk in ranks]
    ecols, evalid = emu.table.to_numpy()
    jcols = {k: np.asarray(v) for k, v in want.table.columns.items()}
    for i, (g, e, j) in enumerate(zip(
            gloo, _per_rank(ecols, evalid, n, names),
            _per_rank(jcols, want.table.valid, n, names))):
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


# -- the hierarchical wire over 4 gloo processes as 2 x 2 -----------------


@pytest.mark.parametrize("case", sorted(HIER_CASES))
def test_gloo_hierarchical_join_equals_emulated_and_jax(worker_runs, case):
    """4 processes as 2 slices of 2 over gloo subgroups (the codec off;
    on at 4 bits, which overflows and widens; the segmented sort on the
    route): each rank's rows, the total, the retry trail and the ranks'
    tier bytes summed equal the emulated 2 x 2 join's and the JAX
    package's on its 2 x 2 hierarchical mesh."""
    n = 4
    ranks, _ = worker_runs[n]
    opts = HIER_CASES[case]
    bc, bv, pc, pv = _uniform_tables()
    jc = jcomm.HierarchicalTpuCommunicator(n_slices=HIER_SLICES, n_ranks=n)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jc, **opts)
    ecomm = EmulatedCommunicator(n, n_slices=HIER_SLICES)
    emu = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       ecomm, **opts)
    assert not bool(want.overflow) and not bool(emu.overflow)
    assert {int(rk[f"{case}/total"]) for rk in ranks} == {
        int(emu.total)} == {int(want.total)}
    assert int(want.total) > 0
    trails = {rk[f"{case}/attempts"].item() for rk in ranks}
    assert len(trails) == 1
    got_trail = [{f: a[f] for f in LADDER_FIELDS}
                 for a in json.loads(trails.pop())]
    assert got_trail == _attempts(emu.retry_report) == _attempts(
        want.retry_report)
    if case == "hier_on":
        assert [a["action"] for a in got_trail][:2] == [
            "initial", "widen_compression_bits"]
    names = sorted(emu.table.columns)
    assert names == sorted(want.table.columns)
    ecols, evalid = emu.table.to_numpy()
    jcols = {k: np.asarray(v) for k, v in want.table.columns.items()}
    for i, (rk, e, j) in enumerate(zip(
            ranks, _per_rank(ecols, evalid, n, names),
            _per_rank(jcols, want.table.valid, n, names))):
        g = _gloo_part(rk, case, names)
        np.testing.assert_array_equal(g, e, err_msg=f"rank {i}")
        np.testing.assert_array_equal(g, j, err_msg=f"rank {i}")
    counted = [json.loads(rk[f"{case}/counters"].item()) for rk in ranks]
    for k, v in ecomm.counters().items():
        assert sum(c[k] for c in counted) == v, k
    assert ecomm.wire_bytes_ici > 0 and ecomm.wire_bytes_dcn > 0


# -- (c): the skew sidecar over 2 gloo processes --------------------------


@pytest.mark.parametrize("q", QUERIES)
def test_gloo_query_equals_jax(worker_runs, jcomms, q):
    """TPC-H Q3 (key mode) and Q10 (build mode: the partials exchange
    over gloo) through ``distributed_query`` on 2 processes: every
    rank's groups together equal JAX's ``distributed_query`` on its
    2-device mesh, and so do the operators' totals."""
    from distributed_join_tpu_torch.ops import aggregate as tagg
    ranks, _ = worker_runs[2]
    plan = tpch_query_plan(q)
    want = jquery.distributed_query(_query_tables(q), plan, jcomms[2],
                                    auto_retry=4)
    spec = plan.aggregate
    gk = list(spec.group_keys)
    wframe = jagg.groups_frame(want.table, spec, gk)
    names = list(wframe.columns)
    valid = np.concatenate([r[f"query_{q}/valid"] for r in ranks])
    cols = {k: np.concatenate([r[f"query_{q}/col/{k}"] for r in ranks])[valid]
            for k in names}
    order = np.lexsort([cols[g] for g in gk][::-1])
    got = {k: cols[k][order] for k in names}
    assert valid.sum() > 0
    assert tagg.frames_equal(got, {c: wframe[c].to_numpy() for c in names})
    for r in ranks:
        assert not r[f"query_{q}/overflow"]
        assert list(r[f"query_{q}/op_totals"]) == [
            int(t) for t in want.op_totals]


def test_gloo_resident_join_equals_jax(worker_runs, jcomms):
    """The resident table over 2 gloo processes (each holds its rank's
    shard): register, probe-only joins at k = 1, at k = 2 on the ragged
    wire and through the ladder, an append merged, and a re-probe. Every
    rank's rows together, the totals, retry trails, conservation pair,
    generation and the program cache's counters equal the JAX package's
    registry on its 2-device mesh."""
    from distributed_join_tpu.service.programs import JoinProgramCache
    from distributed_join_tpu.service.resident import ResidentTableRegistry
    ranks, _ = worker_runs[2]
    bcols, bvalid, pcols, pvalid = _uniform_tables()
    cache = JoinProgramCache(jcomms[2])
    reg = ResidentTableRegistry(jcomms[2], cache)
    reg.register("dim", _jtable(bcols, bvalid))
    jp = _jtable(pcols, pvalid)
    want = [reg.join("dim", jp, with_metrics=False, **o)
            for o in RESIDENT_JOINS]
    dcols, dvalid = _resident_delta()
    reg.append("dim", _jtable(dcols, dvalid), maintain=True)
    want.append(reg.join("dim", jp, with_metrics=False, **RESIDENT_JOINS[0]))
    prefixes = [f"resident{i}" for i in range(len(RESIDENT_JOINS))]
    for prefix, w in zip(prefixes + ["resident_after"], want):
        got = np.concatenate([_gloo_part(r, prefix, NAMES) for r in ranks])
        got = got[np.lexsort(got.T[::-1])]
        wcols = {k: np.asarray(v) for k, v in w.table.columns.items()}
        np.testing.assert_array_equal(
            got, _multiset(wcols, np.asarray(w.table.valid), NAMES))
        for r in ranks:
            assert int(r[f"{prefix}/total"]) == int(w.total)
            assert not r[f"{prefix}/overflow"]
            assert json.loads(str(r[f"{prefix}/attempts"])) == [
                a.as_record() for a in tdist_attempts(w.retry_report)]
    h = reg.get("dim")
    for r in ranks:
        rows, digest, gen, cap, merges, stats = json.loads(
            str(r["resident/state"]))
        assert (rows, digest, gen, cap, merges) == (
            h.rows, h.key_digest, h.generation, h.capacity_per_rank,
            h.merges)
        assert stats == cache.stats()


def test_gloo_integrity_verified_and_corrupted(worker_runs, tmp_path):
    """The wire digests over 2 gloo processes: every flat wire verifies
    clean (2 n^2 pairs) with the emulated join's total; each corruption
    mode on the padded and ragged wires is caught and recovered by one
    ``retry_integrity`` rung; an unbounded budget raises IntegrityError on
    both ranks, the same pairs named; and the all-to-all driver's
    ``--verify-integrity`` record is clean."""
    ranks, _ = worker_runs[2]
    bc, bv, pc, pv = _uniform_tables()
    tb, tp = _ttable(bc, bv), _ttable(pc, pv)
    for name, opts in INTEGRITY_CLEAN.items():
        want = tdist.distributed_inner_join(tb, tp, EmulatedCommunicator(2),
                                            verify_integrity=True, **opts)
        for rank in ranks:
            rep = json.loads(str(rank[f"{name}/report"]))
            assert rep["ok"] and rep["checked_pairs"] == 2 * 2 * 2, name
            assert rep["channels"] == ["build", "probe"]
            assert int(rank[f"{name}/total"]) == int(want.total), name
            assert not bool(rank[f"{name}/overflow"])
    clean = int(ranks[0]["int_padded/total"])
    for name in INTEGRITY_CORRUPT:
        errors = {str(rank[f"{name}/error"]) for rank in ranks}
        assert len(errors) == 1, name     # every rank reads one block
        if name == "int_unbounded":
            assert "wire integrity violated" in errors.pop()
            continue
        assert errors == {""}, name
        for rank in ranks:
            att = json.loads(str(rank[f"{name}/attempts"]))
            assert [a["action"] for a in att] == [
                "initial", "retry_integrity"], name
            assert [a["integrity_ok"] for a in att] == [False, True], name
            assert int(rank[f"{name}/total"]) == clean, name
    out = tmp_path / "a2a.json"
    r = _launch(2, [sys.executable, "-m",
                    "distributed_join_tpu_torch.benchmarks.all_to_all",
                    "--communicator", "gloo", "--buffer-size", "65536",
                    "--iterations", "2", "--verify-integrity",
                    "--json-output", str(out)])
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["integrity"] == {"ok": True, "checked_pairs": 4,
                                "channels": ["wire"], "mismatches": []}


def tdist_attempts(report) -> list:
    """JAX's retry trail in the port's record form (its fields)."""
    from distributed_join_tpu_torch.parallel.faults import RetryAttempt
    names = [f.name for f in dataclasses.fields(RetryAttempt)]
    return [RetryAttempt(**{k: getattr(a, k) for k in names})
            for a in report.attempts]


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


@pytest.mark.parametrize("dtype", ["u64", "bool", "int8", "float64",
                                   "bytes2d"])
@pytest.mark.parametrize("n", [2, 4])
def test_ppermute_chain_over_gloo_equals_all_to_all(worker_runs, n, dtype):
    """The point-to-point chain (``batch_isend_irecv``, one send and one
    receive a step) delivers what ``all_to_all`` delivers, bit for bit,
    in every dtype."""
    ranks, _ = worker_runs[n]
    for i, rk in enumerate(ranks):
        got, want = rk[f"dtype/{dtype}/ppermute"], rk[f"dtype/{dtype}/a2a"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"rank {i}")


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
    """Several ranks a process are refused, and NCCL without enough cards
    is refused before a process starts (no fallback to the CPU);
    ``--auto-tune`` and ``--chaos-seed`` are handed on to every
    process's command once."""
    base = [sys.executable, "-m",
            "distributed_join_tpu_torch.benchmarks.launch",
            "--num-processes", "2"]
    for extra, match in ((["--cpu-devices-per-process", "4"], "one rank"),):
        r = subprocess.run([*base, *extra, "--", "true"], env=_env(),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode != 0 and match in r.stderr, r.stderr
    # --auto-tune and --chaos-seed are ported: the launcher hands each on
    # to the command (a flag the command carries already wins)
    for flags, cmd_flags, want in (
            (["--auto-tune", "h.jsonl"], [], ["--auto-tune", "h.jsonl"]),
            (["--chaos-seed", "2"], [], ["--chaos-seed", "2"]),
            (["--chaos-seed", "2"], ["--chaos-seed", "9"],
             ["--chaos-seed", "9"])):
        r = subprocess.run([*base, "--cpu-devices-per-process", "1",
                            *flags, "--", sys.executable, "-c",
                            "import sys; assert sys.argv[1:] == "
                            f"{want!r}, sys.argv", *cmd_flags],
                           env=_env(), capture_output=True, text=True,
                           timeout=60)
        assert r.returncode == 0, r.stderr
    if not torch.cuda.is_available():
        r = subprocess.run([*base, "--", "true"], env=_env(),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode != 0 and "CUDA devices" in r.stderr, r.stderr


def test_launcher_forwards_hierarchy_and_sort_flags():
    """--slices, --sort-mode and --sort-segments given to the launcher
    reach every process's command (as the JAX launcher forwards them),
    unless the command carries the flag already."""
    from distributed_join_tpu_torch.benchmarks import launch
    args = launch.parse_args(["--num-processes", "2", "--slices", "2",
                              "--sort-mode", "segmented", "--", "drv",
                              "--sort-segments=8"])
    assert args.command == ["drv", "--sort-segments=8", "--slices", "2",
                            "--sort-mode", "segmented"]
    bare = launch.parse_args(["--num-processes", "2", "--", "drv"])
    assert bare.command == ["drv"]


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
    # no process group: a hierarchical mesh needs its rank count
    with pytest.raises(RuntimeError, match="n_ranks"):
        make_hierarchical_mesh(2)
    with pytest.raises(ValueError, match="does not divide"):
        make_hierarchical_mesh(3, 8)


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
    # --chaos-seed is ported: the communicator runs the seed's schedule;
    # seed 3 draws no fault (the record carries the seed), seed 0 flips
    # bits on the wire and the window's checksum refuses the run
    def a2a(seed):
        return ta2a.run(ta2a.parse_args(
            ["--communicator", "emulated", "--n-ranks", "4",
             "--buffer-size", "4096", "--iterations", "2",
             "--chaos-seed", str(seed)]), device="cpu")
    rec, _ = a2a(3)
    assert rec["chaos_seed"] == 3 and rec["communicator"] == \
        "faulty(emulated)"
    with pytest.raises(SystemExit, match="checksum"):
        a2a(0)
    with pytest.raises(SystemExit):
        ta2a.parse_args(["--chaos-seed"])   # the seed is required
    # the wire digests are ported: --verify-integrity parses (its run is
    # test_gloo_integrity_verified_and_corrupted's)
    assert ta2a.parse_args(["--verify-integrity"]).verify_integrity
    # --auto-tune parses (a flag of every driver) and the run refuses it
    # with the JAX message: one exchange has no capacity to pre-size
    with pytest.raises(SystemExit, match="no capacity contract"):
        ta2a.run(ta2a.parse_args(["--auto-tune"]))
    # the exchange is one stage: --stage-profile parses (a telemetry flag
    # of every driver) and the run refuses it with the JAX message
    with pytest.raises(SystemExit, match="IS one shuffle stage"):
        ta2a.run(ta2a.parse_args(["--stage-profile"]))
    # --explain is ported: the exchange's plan
    assert ta2a.parse_args(["--explain"]).explain


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


DRIVER_TELEMETRY_CASES = {
    "distributed_join": ["--communicator", "gloo", "--build-table-nrows",
                         "4096", "--probe-table-nrows", "4096",
                         "--iterations", "1"],
    "tpch_join": ["--communicator", "gloo", "--scale-factor", "0.002",
                  "--batches", "2", "--host-generator"],
    "all_to_all": ["--communicator", "gloo", "--buffer-size", "16384",
                   "--iterations", "2"],
}


@pytest.mark.parametrize("driver", sorted(DRIVER_TELEMETRY_CASES))
def test_drivers_over_gloo_with_telemetry_trace_history_and_guard(
        tmp_path, driver):
    """``--telemetry DIR --trace --history FILE --guard-deadline-s S``
    given to the launcher reach both gloo processes of each driver: one
    record (rank 0's) with the session's summary, each rank's event log,
    Chrome trace and device trace in DIR, and one history entry. The
    join driver's session also holds the counters of its untimed metrics
    join (the batched tpch path and the exchange benchmark run none)."""
    tel, hist = tmp_path / "tel", tmp_path / "h.jsonl"
    cmd = [sys.executable, "-m",
           "distributed_join_tpu_torch.benchmarks.launch",
           "--num-processes", "2", "--cpu-devices-per-process", "1",
           "--coordinator", f"localhost:{_free_port()}",
           "--telemetry", str(tel), "--trace", "--history", str(hist),
           "--guard-deadline-s", "300", "--",
           sys.executable, "-m",
           f"distributed_join_tpu_torch.benchmarks.{driver}",
           *DRIVER_TELEMETRY_CASES[driver]]
    r = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=TIMEOUT_S, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["telemetry"]["rank"] == 0 and "not_ported" not in rec
    metrics = rec["telemetry"]["metrics"]
    if driver == "distributed_join":
        assert metrics["n_ranks"] == 2
        assert metrics["reduced"]["matches"] == rec["matches_per_join"] > 0
    else:
        assert metrics is None
    for rank in (0, 1):
        for f in (f"events.rank{rank}.jsonl", f"trace.rank{rank}.json",
                  f"device_trace/trace.rank{rank}.json"):
            assert (tel / f).exists(), f
    with open(tel / "events.rank1.jsonl") as f:
        names = [json.loads(line)["name"] for line in f]
    assert "watchdog_armed" in names and "bootstrap_ok" in names
    with open(hist) as f:
        entries = [json.loads(line) for line in f]
    assert len(entries) == 1 and entries[0]["outcome"] == "ok"
    assert entries[0]["op"] == driver and entries[0]["platform"] == "cpu"


TPCH_WORKER = r'''
import json, sys
import numpy as np
from distributed_join_tpu_torch.parallel import bootstrap, out_of_core
from distributed_join_tpu_torch.parallel.communicator import make_communicator
from distributed_join_tpu_torch.utils.tpch_host import (
    generate_tpch_host_batches, rename_batches)

spec = json.loads(sys.argv[1])
assert bootstrap.maybe_initialize_from_env()
comm = make_communicator("gloo")
ob, lb = generate_tpch_host_batches(spec["seed"], spec["sf"],
                                    spec["batches"], chunk_orders=1000,
                                    q3_filters=True)
bb = rename_batches(ob, {"o_orderkey": "key"})
pb = rename_batches(lb, {"l_orderkey": "key"})
staged = []
real = out_of_core.make_distributed_join


def factory(*args, **kwargs):
    fn = real(*args, **kwargs)

    def each(bt, pt):
        staged.append([bt.capacity, pt.capacity, int(bt.valid.sum()),
                       int(pt.valid.sum()),
                       int(bt.columns["key"][bt.valid].sum()),
                       int(pt.columns["key"][pt.valid].sum())])
        return fn(bt, pt)
    return each


out_of_core.make_distributed_join = factory
stats = {}
total, overflow = out_of_core.batched_join_host(
    bb, pb, comm, stats=stats, out_capacity_factor=3.0,
    shuffle_capacity_factor=3.0)
with open(f"{spec['out']}/rank{comm.axis_index()}.json", "w") as f:
    json.dump({"total": total, "overflow": overflow, "staged": staged,
               "caps": [stats["build_capacity"], stats["probe_capacity"]]},
              f)
bootstrap.shutdown()
'''


def test_host_generator_batches_over_gloo_stage_each_rank_rows(tmp_path):
    """The out-of-core batch loop on 2 gloo processes: the total and
    overflow of the 1-rank loop on the same host batches, and each rank
    stages only its half of every padded batch (its capacity, and its
    window of the batch's rows: the two ranks' valid rows and key sums
    add up to the batch's)."""
    from distributed_join_tpu_torch.parallel import out_of_core
    from distributed_join_tpu_torch.utils.tpch_host import (
        generate_tpch_host_batches,
        rename_batches,
    )
    spec = {"seed": 3, "sf": 0.004, "batches": 3, "out": str(tmp_path)}
    worker = tmp_path / "tpch_worker.py"
    worker.write_text(TPCH_WORKER)
    r = _launch(2, [sys.executable, str(worker), json.dumps(spec)])
    assert r.returncode == 0, r.stderr[-4000:]
    ranks = [json.loads((tmp_path / f"rank{i}.json").read_text())
             for i in range(2)]
    ob, lb = generate_tpch_host_batches(3, 0.004, 3, chunk_orders=1000,
                                        q3_filters=True)
    bb = rename_batches(ob, {"o_orderkey": "key"})
    pb = rename_batches(lb, {"l_orderkey": "key"})
    stats = {}
    total, overflow = out_of_core.batched_join_host(
        bb, pb, LocalCommunicator(), device="cpu", stats=stats,
        out_capacity_factor=3.0, shuffle_capacity_factor=3.0)
    bcap, pcap = ranks[0]["caps"]
    for g in ranks:
        assert g["total"] == total > 0 and g["overflow"] == overflow is False
        assert g["caps"] == [bcap, pcap]
        # the warm-up (batch 0) and the loop's 3 batches
        assert [s[:2] for s in g["staged"]] == [[bcap // 2, pcap // 2]] * 4
    for i, b in enumerate([0, 0, 1, 2]):
        got = [sum(g["staged"][i][k] for g in ranks) for k in (2, 3, 4, 5)]
        assert got == [len(bb[b]["key"]), len(pb[b]["key"]),
                       int(bb[b]["key"].sum()), int(pb[b]["key"].sum())]


def test_tpch_driver_over_gloo_equals_one_rank(tmp_path):
    """The config-4 driver on the host generator, launched on 2 gloo
    processes: rank 0's record only, with the 1-rank driver's rows and
    matches and no overflow."""
    from distributed_join_tpu_torch.benchmarks import tpch_join
    argv = ["--scale-factor", "0.004", "--host-generator", "--batches", "3",
            "--q3-filters"]
    out = tmp_path / "rec.json"
    r = _launch(2, [sys.executable, "-m",
                    "distributed_join_tpu_torch.benchmarks.tpch_join",
                    "--communicator", "gloo", "--json-output", str(out),
                    *argv])
    assert r.returncode == 0, r.stderr[-3000:]
    assert len([ln for ln in r.stdout.splitlines() if ln.startswith("{")]) == 1
    rec = json.loads(out.read_text())
    one = tpch_join.run(tpch_join.parse_args(argv), device="cpu")
    assert rec["communicator"] == "gloo" and rec["n_ranks"] == 2
    for k in ("orders_nrows", "lineitem_nrows", "matches_per_join"):
        assert rec[k] == one[k], k
    assert rec["matches_per_join"] > 0 and not rec["overflow"]


# -- fault plans and telemetry over 2 gloo processes ------------------------


def _fault_comm(jcomms, n, plan):
    return jfaults.FaultInjectingCommunicator(
        jcomms[n], jfaults.plan_from_record(plan))


@pytest.mark.parametrize("case", sorted(FAULT_JOINS))
def test_gloo_fault_ladders_equal_jax(worker_runs, jcomms, case):
    """An injected overflow drives the ladder over the process group as
    on emulated ranks and in the JAX package: the same trail, the clean
    total."""
    ranks, _ = worker_runs[2]
    plan, opts = FAULT_JOINS[case]["plan"], FAULT_JOINS[case]["opts"]
    bc, bv, pc, pv = _uniform_tables()
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        _fault_comm(jcomms, 2, plan), **opts)
    emu = tdist.distributed_inner_join(
        _ttable(bc, bv), _ttable(pc, pv), tfaults.FaultInjectingCommunicator(
            EmulatedCommunicator(2), tfaults.plan_from_record(plan)), **opts)
    assert {int(rk[f"{case}/total"]) for rk in ranks} == {
        int(emu.total)} == {int(want.total)}
    trails = {rk[f"{case}/attempts"].item() for rk in ranks}
    assert len(trails) == 1
    got = [{f: a[f] for f in LADDER_FIELDS} for a in json.loads(trails.pop())]
    assert got == _attempts(emu.retry_report) == _attempts(want.retry_report)
    assert [a["overflow"] for a in got] == [True, True, False]


def test_gloo_fault_loops_equal_jax(worker_runs, jcomms):
    """The batch loop over the process group recovers a transient
    dispatch failure with a retry, and with ``continue`` degrades to the
    partial total of the batches that ran, as the JAX package's loop."""
    ranks, _ = worker_runs[2]
    bc, bv, pc, pv = _uniform_tables()
    for case, spec in FAULT_LOOPS.items():
        stats = {}
        want, _ = jooc.keyrange_batched_join(
                            _jtable(bc, bv), _jtable(pc, pv),
                            _fault_comm(jcomms, 2, spec["plan"]),
                            stats=stats, **spec["opts"])
        for rk in ranks:
            assert int(rk[f"{case}/total"]) == int(want)
            assert not bool(rk[f"{case}/overflow"])
            assert rk[f"{case}/failed"].tolist() == stats["failed_batches"]
    assert ranks[0]["loop_degrade/failed"].tolist() == [0]
    assert all(str(rk["fault_error"]).startswith(
        "injected dispatch failure #1") for rk in ranks)


def test_gloo_telemetry_session_a_rank(worker_runs):
    """Each process writes its own rank's files into the one session
    directory; both packages' timeline readers assemble them, and each
    rank's log holds the steps' spans and the ladder's and the loop's
    events."""
    from distributed_join_tpu.telemetry import timeline as jtimeline
    from distributed_join_tpu.telemetry.analyze import check_file
    from distributed_join_tpu_torch.telemetry import timeline as ttimeline
    d = os.path.join(worker_runs[2][1]["dir"], "telemetry")
    asm = ttimeline.assemble([d])
    assert [p["label"].rsplit(":", 1)[1] for p in asm["procs"]] == ["r0",
                                                                     "r1"]
    assert ttimeline.as_record(asm) == jtimeline.as_record(
        jtimeline.assemble([d]))
    for rank in (0, 1):
        with open(os.path.join(d, f"events.rank{rank}.jsonl")) as f:
            events = [json.loads(line) for line in f]
        spans = {e["name"] for e in events if e["kind"] == "span"}
        assert {"partition", "shuffle", "join", "stage"} <= spans
        names = [e["name"] for e in events]
        assert "retry_attempt" in names and "batch_complete" in names
        assert all(e["rank"] == rank for e in events)
        assert check_file(os.path.join(d, f"trace.rank{rank}.json")) == []

