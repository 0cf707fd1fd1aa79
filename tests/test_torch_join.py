"""PyTorch port vs the JAX package: the local sort-merge inner join, the
padded shuffle, and the 8-rank distributed join with its retry ladder,
on the CPU. Tables are made with numpy from a seed and reach both
packages as numpy arrays; result rows are compared as multisets (row
order inside a key run is arbitrary in both packages). Also: the port
imports nothing of JAX, and its entry points refuse to fall back to the
CPU unasked."""

import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
import distributed_join_tpu_torch
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch import bench as tbench
from distributed_join_tpu_torch.ops import join as tjoin
from distributed_join_tpu_torch.ops import partition as tpart
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.parallel.shuffle import shuffle_padded
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils import generators as tgen


def _tables(rng, nb, npr, key_max, b_invalid=0.0, p_invalid=0.0,
            key_dtype=np.int64):
    bcols = {"key": rng.integers(0, key_max, nb).astype(key_dtype),
             "build_payload": rng.integers(-(1 << 40), 1 << 40, nb)}
    pcols = {"key": rng.integers(0, key_max, npr).astype(key_dtype),
             "probe_payload": rng.integers(-(1 << 40), 1 << 40, npr)}
    bvalid = rng.random(nb) >= b_invalid
    pvalid = rng.random(npr) >= p_invalid
    return (bcols, bvalid), (pcols, pvalid)


def _jtable(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _ttable(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _rows(cols: dict, valid, names) -> np.ndarray:
    """The valid rows as a lexicographically sorted (rows, cols) array
    of 64-bit patterns: a multiset in canonical order."""
    valid = np.asarray(valid)
    a = np.stack([np.asarray(cols[n])[valid].astype(np.float64).view(
        np.int64) if np.asarray(cols[n]).dtype.kind == "f"
        else np.asarray(cols[n])[valid].astype(np.int64) for n in names],
        axis=1) if valid.any() else np.zeros((0, len(names)), np.int64)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def _jrows(res, names):
    return _rows(res.table.columns, res.table.valid, names)


def _trows(res, names):
    cols, valid = res.table.to_numpy()
    return _rows(cols, valid, names)


NAMES = ["key", "build_payload", "probe_payload"]


# -- local join ---------------------------------------------------------


JOIN_CASES = {
    "duplicates": dict(nb=300, npr=400, key_max=50, out_cap=4096),
    "invalid_rows": dict(nb=256, npr=256, key_max=40, b_invalid=0.3,
                         p_invalid=0.2, out_cap=3072),
    "all_invalid_build": dict(nb=128, npr=200, key_max=30, b_invalid=1.0,
                              out_cap=256),
    "all_invalid_probe": dict(nb=128, npr=200, key_max=30, p_invalid=1.0,
                              out_cap=256),
    "int32_keys_sparse": dict(nb=500, npr=400, key_max=5000, out_cap=512,
                              key_dtype=np.int32),
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
@pytest.mark.parametrize("port_mode", ["auto", "kernel"])
def test_local_join_matches_jax_xla_path(case, port_mode):
    spec = dict(JOIN_CASES[case])
    out_cap = spec.pop("out_cap")
    rng = np.random.default_rng(zlib_seed(case))
    (bc, bv), (pc, pv) = _tables(rng, **spec)
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       "key", out_cap)
    got = tjoin.sort_merge_inner_join(
        _ttable(bc, bv), _ttable(pc, pv), "key", out_cap,
        kernel_config=KernelConfig(expand=port_mode))
    assert int(got.total) == int(want.total)
    assert bool(got.overflow) == bool(want.overflow) is False
    assert got.table.column_names == list(want.table.columns)
    for nm in NAMES:
        assert got.table.columns[nm].shape == (out_cap,)
    np.testing.assert_array_equal(_trows(got, NAMES), _jrows(want, NAMES))


def zlib_seed(s: str) -> int:
    import zlib
    return zlib.crc32(s.encode())


@pytest.mark.parametrize("port_mode", ["auto", "kernel"])
def test_local_join_matches_jax_pallas_path(port_mode):
    """Against the JAX kernel pipeline (KernelConfig(expand="pallas"),
    interpreted), with mixed payload dtypes riding the u64 lanes."""
    rng = np.random.default_rng(4)
    (bc, bv), (pc, pv) = _tables(rng, 240, 256, 60, b_invalid=0.1)
    bc["b32"] = rng.integers(-100, 100, 240).astype(np.int32)
    pc["pf32"] = rng.standard_normal(256).astype(np.float32)
    pc["p16"] = rng.integers(-300, 300, 256).astype(np.int16)
    out_cap = 2048
    want = jjoin.sort_merge_inner_join(
        _jtable(bc, bv), _jtable(pc, pv), "key", out_cap,
        kernel_config=JKernelConfig(expand="pallas"))
    got = tjoin.sort_merge_inner_join(
        _ttable(bc, bv), _ttable(pc, pv), "key", out_cap,
        kernel_config=KernelConfig(expand=port_mode))
    names = [*NAMES, "b32", "pf32", "p16"]
    assert int(got.total) == int(want.total) > 0
    for nm in names:
        assert got.table.columns[nm].numpy().dtype == np.asarray(
            want.table.columns[nm]).dtype
    np.testing.assert_array_equal(_trows(got, names), _jrows(want, names))


@pytest.mark.parametrize("port_mode", ["auto", "kernel"])
def test_local_join_overflow_matches_jax(port_mode):
    rng = np.random.default_rng(9)
    (bc, bv), (pc, pv) = _tables(rng, 256, 256, 8)
    out_cap = 512
    for cfg in (None, JKernelConfig(expand="pallas")):
        want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                           "key", out_cap, kernel_config=cfg)
        got = tjoin.sort_merge_inner_join(
            _ttable(bc, bv), _ttable(pc, pv), "key", out_cap,
            kernel_config=KernelConfig(expand=port_mode))
        assert int(got.total) == int(want.total) > out_cap
        assert bool(got.overflow) and bool(want.overflow)
        assert int(got.table.valid.sum()) == int(
            np.asarray(want.table.valid).sum()) == out_cap


def test_local_join_composite_key_matches_jax():
    rng = np.random.default_rng(12)
    bc = {"k0": rng.integers(0, 6, 200), "k1": rng.integers(0, 5, 200)
          .astype(np.int32), "bp": rng.integers(0, 1000, 200)}
    pc = {"k0": rng.integers(0, 6, 300), "k1": rng.integers(0, 5, 300)
          .astype(np.int32), "pp": rng.integers(0, 1000, 300)}
    bv, pv = np.ones(200, bool), np.ones(300, bool)
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       ["k0", "k1"], 4096)
    for mode in ("auto", "kernel"):
        got = tjoin.sort_merge_inner_join(
            _ttable(bc, bv), _ttable(pc, pv), ["k0", "k1"], 4096,
            kernel_config=KernelConfig(expand=mode))
        names = ["k0", "k1", "bp", "pp"]
        assert int(got.total) == int(want.total)
        np.testing.assert_array_equal(_trows(got, names), _jrows(want, names))


def test_local_join_without_build_payload():
    rng = np.random.default_rng(21)
    (bc, bv), (pc, pv) = _tables(rng, 200, 300, 40)
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       "key", 4096, build_payload=[])
    got = tjoin.sort_merge_inner_join(
        _ttable(bc, bv), _ttable(pc, pv), "key", 4096, build_payload=[],
        kernel_config=KernelConfig(expand="kernel"))
    names = ["key", "probe_payload"]
    assert got.table.column_names == names
    np.testing.assert_array_equal(_trows(got, names), _jrows(want, names))


@pytest.mark.parametrize("n_payloads", [1, 9])
def test_local_join_many_lanes_takes_kernel_path(n_payloads):
    """More payload lanes per side than one kernel launch carries: the
    kernel pipeline still runs (its wrappers launch per group of lanes)
    and equals the JAX join."""
    rng = np.random.default_rng(30 + n_payloads)
    (bc, bv), (pc, pv) = _tables(rng, 200, 240, 40)
    for i in range(n_payloads):
        bc[f"b{i}"] = rng.integers(-1000, 1000, 200).astype(
            np.int32 if i % 2 else np.int64)
        pc[f"p{i}"] = rng.standard_normal(240).astype(np.float32)
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       "key", 4096)
    b, p = _ttable(bc, bv), _ttable(pc, pv)
    b1d = [c for c in b.column_names if c != "key"]
    p1d = [c for c in p.column_names if c != "key"]
    assert tjoin._kernel_path_ok(b, p, ["key"], b1d, p1d, 4096)
    got = tjoin.sort_merge_inner_join(b, p, "key", 4096,
                                      kernel_config=KernelConfig("kernel"))
    names = ["key", *b1d, *p1d]
    assert int(got.total) == int(want.total) > 0
    np.testing.assert_array_equal(_trows(got, names), _jrows(want, names))


@pytest.mark.parametrize("port_mode", ["auto", "kernel"])
def test_local_join_zero_out_capacity_matches_jax(port_mode):
    rng = np.random.default_rng(17)
    (bc, bv), (pc, pv) = _tables(rng, 64, 80, 20)
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       "key", 0)
    b, p = _ttable(bc, bv), _ttable(pc, pv)
    assert tjoin._kernel_path_ok(b, p, ["key"], ["build_payload"],
                                 ["probe_payload"], 0)
    got = tjoin.sort_merge_inner_join(b, p, "key", 0,
                                      kernel_config=KernelConfig(port_mode))
    assert int(got.total) == int(want.total) > 0
    assert bool(got.overflow) and bool(want.overflow)
    assert got.table.capacity == 0


def test_local_join_refuses_by_name():
    t = _ttable({"key": np.arange(8), "a": np.arange(8)}, np.ones(8, bool))
    u = _ttable({"key": np.arange(8), "b": np.arange(8)}, np.ones(8, bool))
    with pytest.raises(ValueError, match="join_type"):
        tjoin.sort_merge_inner_join(t, u, "key", 16, join_type="cross")
    # 2-D columns join; the same 2-D name on both sides is refused, as
    # the JAX package refuses it
    s = Table({"key": torch.arange(8), "s": torch.zeros(8, 4,
                                                        dtype=torch.uint8)},
              torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="collision"):
        tjoin.sort_merge_inner_join(s, s, "key", 16)
    with pytest.raises(ValueError, match="expand"):
        KernelConfig(expand="pallas")


# -- shuffle and the distributed join -----------------------------------


def test_padded_shuffle_routes_rows_to_their_hash_owner():
    n = 4
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 10_000, 1024)
    t = _ttable({"key": keys, "payload": np.arange(1024)}, np.ones(1024, bool))
    comm = EmulatedCommunicator(n)

    def per_rank(t_local):
        pt = tpart.radix_hash_partition(t_local, ["key"], n)
        padded, counts, ovf, _ = pt.to_padded(96)
        recv, _ = shuffle_padded(comm, padded, counts, 96)
        return recv, comm.psum(ovf.to(torch.int32)) > 0

    recv, ovf = comm.spmd(per_rank, sharded_out=(False, True))(t)
    assert not bool(ovf)
    from distributed_join_tpu_torch.ops.hashing import bucket_ids
    owner = bucket_ids([torch.from_numpy(keys)], n).numpy()
    rk = recv.columns["key"].numpy().reshape(n, -1)
    rv = recv.valid.numpy().reshape(n, -1)
    for r in range(n):
        assert sorted(rk[r][rv[r]].tolist()) == sorted(keys[owner == r]
                                                       .tolist())


def test_emulated_collectives():
    comm = EmulatedCommunicator(4)

    def per_rank(x):
        r = comm.axis_index()
        return (comm.all_gather(x + r), comm.psum(x.sum().reshape(1)),
                comm.all_to_all(torch.arange(4) + 10 * r))

    gathered, summed, a2a = comm.spmd(
        per_rank, sharded_out=(True, True, False))(torch.arange(8))
    assert gathered.tolist() == [0, 1, 3, 4, 6, 7, 9, 10]
    assert summed.tolist() == [28]
    # rank r receives element r of every rank's block, in rank order
    assert a2a.tolist() == [0, 10, 20, 30, 1, 11, 21, 31,
                            2, 12, 22, 32, 3, 13, 23, 33]
    with pytest.raises(RuntimeError, match="inside spmd"):
        comm.axis_index()


def test_emulated_rank_failure_reaches_the_caller():
    comm = EmulatedCommunicator(3, timeout_s=30)

    def per_rank(x):
        if comm.axis_index() == 1:
            raise ValueError("rank 1 failed")
        return comm.all_gather(x)

    with pytest.raises(ValueError, match="rank 1 failed"):
        comm.spmd(per_rank)(torch.arange(6))


@pytest.fixture(scope="module")
def jcomm8():
    return jcomm.make_communicator("tpu", n_ranks=8)


DIST_CASES = {
    "plain": dict(nb=1000, npr=1200, key_max=700, opts=dict(
        out_capacity_factor=3.0)),
    "k2_invalid": dict(nb=800, npr=900, key_max=300, b_invalid=0.2,
                       opts=dict(over_decomposition=2,
                                 out_capacity_factor=4.0)),
}


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_distributed_join_matches_jax_8_ranks(case, jcomm8):
    spec = dict(DIST_CASES[case])
    opts = spec.pop("opts")
    rng = np.random.default_rng(zlib_seed(case))
    (bc, bv), (pc, pv) = _tables(rng, **spec)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomm8, **opts)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(8), **opts)
    assert not bool(want.overflow) and not bool(got.overflow)
    assert int(got.total) == int(want.total) > 0
    assert got.table.capacity == np.asarray(want.table.valid).shape[0]
    np.testing.assert_array_equal(_trows(got, NAMES), _jrows(want, NAMES))


def test_distributed_join_retry_ladder_matches_jax(jcomm8):
    """A too-small output block overflows; auto_retry escalates through
    the same rungs in both packages and ends with the same rows."""
    rng = np.random.default_rng(77)
    (bc, bv), (pc, pv) = _tables(rng, 512, 512, 256)
    opts = dict(out_capacity_factor=0.25, auto_retry=5)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomm8, **opts)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(8), **opts)
    fields = ("attempt", "action", "overflow", "shuffle_capacity_factor",
              "out_capacity_factor", "out_rows_per_rank")
    jatt = [{f: getattr(a, f) for f in fields}
            for a in want.retry_report.attempts]
    tatt = [{f: getattr(a, f) for f in fields}
            for a in got.retry_report.attempts]
    assert len(tatt) > 1 and tatt == jatt
    assert got.retry_report.resolved and want.retry_report.resolved
    assert int(got.total) == int(want.total)
    np.testing.assert_array_equal(_trows(got, NAMES), _jrows(want, NAMES))


def test_distributed_join_refuses_unported_options():
    t = _ttable({"key": np.arange(8), "a": np.arange(8)}, np.ones(8, bool))
    u = _ttable({"key": np.arange(8), "b": np.arange(8)}, np.ones(8, bool))
    # the wire digests are ported: one rank has no wire, so its report is
    # vacuously clean; with_integrity is the step's switch, which the
    # one-shot join sets itself (a TypeError, as in the JAX package)
    res = tdist.distributed_inner_join(t, u, LocalCommunicator(),
                                       verify_integrity=True)
    assert res.integrity_report.ok and res.integrity_report.checked_pairs == 0
    assert int(res.total) == 8
    assert [a.integrity_ok for a in res.retry_report.attempts] == [True]
    with pytest.raises(TypeError, match="with_integrity"):
        tdist.distributed_inner_join(t, u, LocalCommunicator(),
                                     with_integrity=True)
    # the autotuner is ported: a tuner with no history is the static plan
    from distributed_join_tpu_torch.planning.tuner import JoinTuner
    res = tdist.distributed_inner_join(t, u, LocalCommunicator(),
                                       tuner=JoinTuner())
    assert res.tuned["source"] == "static" and int(res.total) == 8
    # the metrics tape and the plan are ported
    res = tdist.distributed_inner_join(t, u, LocalCommunicator(),
                                       with_metrics=True, explain=True)
    assert res.telemetry.to_dict()["reduced"] == {
        "matches": 8, "retry_attempt_max": 0}
    assert res.plan.with_metrics and res.plan.n_ranks == 1
    # aggregate pushdown is ported: a value that is no AggregateSpec is a
    # TypeError, in the JAX package's words
    cols = ({"key": np.arange(8), "a": np.arange(8)},
            {"key": np.arange(8), "b": np.arange(8)})
    msgs = []
    for fn, mk, comm in ((jdist.distributed_inner_join, _jtable,
                          jcomm.make_communicator("local")),
                         (tdist.distributed_inner_join, _ttable,
                          LocalCommunicator())):
        with pytest.raises(TypeError, match="AggregateSpec") as exc:
            fn(mk(cols[0], np.ones(8, bool)), mk(cols[1], np.ones(8, bool)),
               comm, aggregate=object())
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_one_rank_join_equals_emulated_ranks():
    rng = np.random.default_rng(5)
    (bc, bv), (pc, pv) = _tables(rng, 600, 600, 400)
    one = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       LocalCommunicator(),
                                       out_capacity_factor=2.0)
    four = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                        EmulatedCommunicator(4),
                                        out_capacity_factor=2.0)
    assert int(one.total) == int(four.total) > 0
    np.testing.assert_array_equal(_trows(one, NAMES), _trows(four, NAMES))


# -- generators, bench, device and import discipline --------------------


def test_generator_match_relation_and_bench_on_cpu():
    """The port's generator holds the headline's relation (~0.6 matches
    per probe row at selectivity 0.3, rand_max = rows); the bench
    protocol runs end to end on the CPU at a small size."""
    rec = tbench.run(nrows=20_000, iters=2, device="cpu")
    assert 0.55 < rec["matches_per_join"] / 20_000 < 0.65
    assert rec["unit"] == "M rows/sec/GPU" and rec["vs_baseline"] is None
    assert rec["value"] > 0 and rec["value_capacity_contract"] > 0
    assert rec["retry"] == {"match_sized": None, "capacity_contract": None}


def test_entry_points_refuse_to_run_on_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.generate_build_probe_tables(seed=1, build_nrows=8,
                                         probe_nrows=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Table.from_numpy({"key": np.arange(4)}, np.ones(4, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.run(nrows=8, iters=1)
    from distributed_join_tpu_torch.benchmarks import distributed_join
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed_join.run(distributed_join.parse_args(
            ["--build-table-nrows", "8", "--probe-table-nrows", "8"]))


def test_port_imports_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(
        distributed_join_tpu_torch.__path__, "distributed_join_tpu_torch.")]
    assert {"distributed_join_tpu_torch.ops.join",
            "distributed_join_tpu_torch.parallel.bootstrap",
            "distributed_join_tpu_torch.parallel.mesh",
            "distributed_join_tpu_torch.benchmarks.launch",
            "distributed_join_tpu_torch.benchmarks.all_to_all",
            "distributed_join_tpu_torch.ops.compression",
            "distributed_join_tpu_torch.ops.segmented",
            "distributed_join_tpu_torch.telemetry",
            "distributed_join_tpu_torch.telemetry.spans",
            "distributed_join_tpu_torch.telemetry.export",
            "distributed_join_tpu_torch.telemetry.tracectx",
            "distributed_join_tpu_torch.telemetry.baselines",
            "distributed_join_tpu_torch.telemetry.history",
            "distributed_join_tpu_torch.telemetry.timeline",
            "distributed_join_tpu_torch.parallel.watchdog",
            "distributed_join_tpu_torch.parallel.faults",
            "distributed_join_tpu_torch.telemetry.live",
            "distributed_join_tpu_torch.planning.tuner",
            "distributed_join_tpu_torch.planning.plan",
            "distributed_join_tpu_torch.planning.cost",
            "distributed_join_tpu_torch.telemetry.metrics",
            "distributed_join_tpu_torch.service.server"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['distributed_join_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m == 'jax' or m.startswith(('jax.', 'distributed_join_tpu.')))]"
            "\n"
            "assert not bad, bad\n"
            "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
