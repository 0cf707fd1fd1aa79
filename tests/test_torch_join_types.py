"""PyTorch port vs the JAX package: the join-type family (inner, left,
right, full_outer, semi, anti) in the local join on both of the port's
routes, and in the 8-rank distributed join with its retry ladder, on the
CPU. Tables are made with numpy from a seed and reach both packages as
numpy arrays. Every comparison is exact (no tolerance): totals, overflow
flags, column names, order and dtypes, and the valid rows, validity
columns included, as sorted multisets (row order inside a key run is
arbitrary in both packages). The port's ``KernelConfig("kernel")`` runs
the kernel pipeline's structure on the CPU, each wrapper on its plain
twin; ``"auto"`` takes the plain formulation there."""

import functools
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils import strings as js
from distributed_join_tpu_torch.ops import join as tjoin
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.table import Table

TYPES = list(tjoin.JOIN_TYPES)
MODES = ["auto", "kernel"]


def _rows(cols, valid, names) -> np.ndarray:
    """Valid rows as a lexicographically sorted int64 array: 2-D columns
    one int64 column an element, floats by their float64 bits, bools as
    0 and 1."""
    valid = np.asarray(valid)
    parts = []
    for n in names:
        a = np.asarray(cols[n])[valid]
        a = a.reshape(a.shape[0], int(np.prod(a.shape[1:])))
        parts.append(a.astype(np.float64).view(np.int64)
                     if a.dtype.kind == "f" else a.astype(np.int64))
    a = np.concatenate(parts, axis=1)
    return a[np.lexsort(a.T[::-1])]


def _jtable(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _ttable(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _seed(*parts) -> int:
    return zlib.crc32("/".join(map(str, parts)).encode())


def _float_keys(rng, dtype, n, key_max):
    k = (rng.integers(0, key_max, n) - key_max // 2).astype(dtype) / 4
    k[rng.random(n) < 0.06] = 0.0
    k[rng.random(n) < 0.06] = -0.0
    k[rng.random(n) < 0.03] = np.inf
    k[rng.random(n) < 0.03] = -np.inf
    return k


def _case(name):
    """``(bc, bv, pc, pv, keys)`` of one local-join case."""
    rng = np.random.default_rng(_seed(name))
    nb, npr = 240, 300
    bv, pv = np.ones(nb, bool), np.ones(npr, bool)
    keys = "key"
    bc, pc = {}, {}
    if name == "duplicates":          # ~10 builds and probes a key
        bc["key"], pc["key"] = rng.integers(0, 24, nb), rng.integers(0, 30,
                                                                     npr)
    elif name == "invalid_rows":
        bc["key"], pc["key"] = rng.integers(0, 60, nb), rng.integers(0, 90,
                                                                     npr)
        bv, pv = rng.random(nb) >= 0.3, rng.random(npr) >= 0.2
    elif name == "all_invalid_build":
        bc["key"], pc["key"] = rng.integers(0, 40, nb), rng.integers(0, 40,
                                                                     npr)
        bv = np.zeros(nb, bool)
    elif name == "all_unmatched_probe":
        bc["key"] = rng.integers(0, 50, nb)
        pc["key"] = rng.integers(1000, 1050, npr)
    elif name == "int32_keys":
        bc["key"] = rng.integers(-40, 40, nb).astype(np.int32)
        pc["key"] = rng.integers(-60, 60, npr).astype(np.int32)
    elif name in ("float32_keys", "float64_keys"):
        dt = np.float32 if name == "float32_keys" else np.float64
        bc["key"], pc["key"] = (_float_keys(rng, dt, nb, 80),
                                _float_keys(rng, dt, npr, 120))
        bv, pv = rng.random(nb) < 0.9, rng.random(npr) < 0.9
    elif name == "composite_key":
        for c, n, hi in ((bc, nb, 5), (pc, npr, 7)):
            c["k0"] = rng.integers(0, hi, n)
            c["k1"] = rng.integers(0, 6, n).astype(np.int32)
        keys = ["k0", "k1"]
    elif name == "two_d_payloads":
        bc["key"], pc["key"] = rng.integers(0, 60, nb), rng.integers(0, 90,
                                                                     npr)
        bc["bs"] = rng.integers(0, 256, (nb, 7)).astype(np.uint8)
        bc["bm"] = rng.integers(-300, 300, (nb, 3)).astype(np.int16)
        pc["ps"] = rng.integers(0, 256, (npr, 12)).astype(np.uint8)
        bv, pv = rng.random(nb) < 0.9, rng.random(npr) < 0.9
    else:
        raise KeyError(name)
    bc["bp"] = rng.integers(-(1 << 40), 1 << 40, nb)
    pc["pp"] = rng.integers(-(1 << 40), 1 << 40, npr)
    return bc, bv, pc, pv, keys


CASES = ["duplicates", "invalid_rows", "all_invalid_build",
         "all_unmatched_probe", "int32_keys", "float32_keys", "float64_keys",
         "composite_key", "two_d_payloads"]
OUT_CAP = 8192


def _summary(res, names=None):
    """(total, overflow, column names, dtypes, sorted valid rows)."""
    if isinstance(res.table, Table):
        cols, valid = res.table.to_numpy()
    else:
        cols = {k: np.asarray(v) for k, v in res.table.columns.items()}
        valid = np.asarray(res.table.valid)
    names = list(cols) if names is None else names
    return (int(res.total), bool(res.overflow), names,
            [cols[n].dtype for n in names], _rows(cols, valid, names))


def _assert_same(got, want):
    assert got[:4] == want[:4]
    np.testing.assert_array_equal(got[4], want[4])


@functools.lru_cache(maxsize=None)
def _jax_local(case, join_type, cap=OUT_CAP):
    bc, bv, pc, pv, keys = _case(case)
    return _summary(jjoin.sort_merge_inner_join(
        _jtable(bc, bv), _jtable(pc, pv), keys, cap, join_type=join_type))


def _port_local(case, join_type, mode, cap=OUT_CAP, **kw):
    bc, bv, pc, pv, keys = _case(case)
    return tjoin.sort_merge_inner_join(
        _ttable(bc, bv), _ttable(pc, pv), keys, cap, join_type=join_type,
        kernel_config=KernelConfig(mode), **kw)


def test_join_type_names_are_the_jax_package_s():
    assert tjoin.JOIN_TYPES == jjoin.JOIN_TYPES
    assert tjoin.OUTER_TYPES == jjoin.OUTER_TYPES
    assert (tjoin.BUILD_VALID, tjoin.PROBE_VALID) == (jjoin.BUILD_VALID,
                                                      jjoin.PROBE_VALID)


# -- the local join -----------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("join_type", TYPES)
@pytest.mark.parametrize("case", CASES)
def test_local_typed_join_matches_jax(case, join_type, mode):
    want = _jax_local(case, join_type)
    got = _port_local(case, join_type, mode)
    _assert_same(_summary(got), want)
    assert not want[1]
    names = want[2]
    if join_type in ("semi", "anti"):
        assert "bp" not in names and not any("#valid" in n for n in names)
    if join_type in ("left", "full_outer"):
        assert tjoin.BUILD_VALID in names
    if join_type in ("right", "full_outer"):
        assert names[-1] == tjoin.PROBE_VALID


@pytest.mark.parametrize("mode", MODES)
def test_right_join_with_shared_payload_lanes(mode):
    """Same-dtype build and probe payloads share one lane of the kernel
    route's merged sort, so an unmatched build row's record carries its
    build value in the probe lane: the probe outputs (1-D, 2-D and the
    row index behind them) must come back zero there, as in the JAX
    package, whose merged sort plants zeros."""
    rng = np.random.default_rng(61)
    nb, npr = 200, 160
    bc = {"key": rng.integers(0, 80, nb),
          "b32": rng.integers(1, 1000, nb).astype(np.int32),
          "bf": rng.standard_normal(nb).astype(np.float32) + 5,
          "bs": rng.integers(1, 256, (nb, 5)).astype(np.uint8)}
    pc = {"key": rng.integers(40, 140, npr),
          "p32": rng.integers(1, 1000, npr).astype(np.int32),
          "pf": rng.standard_normal(npr).astype(np.float32) + 5,
          "ps": rng.integers(1, 256, (npr, 4)).astype(np.uint8)}
    bv, pv = np.ones(nb, bool), np.ones(npr, bool)
    for jt in ("right", "full_outer"):
        want = _summary(jjoin.sort_merge_inner_join(
            _jtable(bc, bv), _jtable(pc, pv), "key", 2048, join_type=jt))
        res = tjoin.sort_merge_inner_join(
            _ttable(bc, bv), _ttable(pc, pv), "key", 2048, join_type=jt,
            kernel_config=KernelConfig(mode))
        _assert_same(_summary(res), want)
        cols, valid = res.table.to_numpy()
        absent = valid & ~cols[tjoin.PROBE_VALID]
        assert absent.sum() > 20
        for nm in ("p32", "pf", "ps"):
            assert not cols[nm][absent].any(), nm
        assert cols["b32"][absent].all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("join_type", TYPES)
def test_output_block_at_and_one_under_the_total(join_type, mode):
    """An output block of exactly ``total`` rows holds every row; one row
    fewer overflows, in both packages, with ``total`` still exact."""
    total = _jax_local("duplicates", join_type)[0]
    assert total > 0
    want = _jax_local("duplicates", join_type, total)
    _assert_same(_summary(_port_local("duplicates", join_type, mode, total)),
                 want)
    assert not want[1]
    short = _jax_local("duplicates", join_type, total - 1)
    got = _port_local("duplicates", join_type, mode, total - 1)
    assert (int(got.total), bool(got.overflow)) == short[:2] == (total, True)
    assert int(got.table.valid.sum()) == total - 1 == got.table.capacity


@pytest.mark.parametrize("mode", MODES)
def test_outer_join_matches_jax_pallas_record_expand(mode):
    """A full outer join against the JAX package with
    ``KernelConfig(expand="pallas")``: its typed path then expands the
    records with the Pallas record-mode kernel (expand_pallas.py:264,
    interpreted), the kernel the port's record mode replaces."""
    rng = np.random.default_rng(73)
    nb, npr = 100, 128
    bc = {"key": rng.integers(0, 40, nb), "bp": rng.integers(0, 99, nb)}
    pc = {"key": rng.integers(20, 70, npr),
          "pp": rng.integers(0, 99, npr).astype(np.int32)}
    bv, pv = rng.random(nb) < 0.9, np.ones(npr, bool)
    want = jjoin.sort_merge_inner_join(
        _jtable(bc, bv), _jtable(pc, pv), "key", 1024, join_type="full_outer",
        kernel_config=JKernelConfig(expand="pallas"))
    got = tjoin.sort_merge_inner_join(
        _ttable(bc, bv), _ttable(pc, pv), "key", 1024, join_type="full_outer",
        kernel_config=KernelConfig(mode))
    _assert_same(_summary(got), _summary(want))


def _assert_same_string_join(got, want, join_type):
    """``_assert_same`` but for the '#len' companion's dtype: the JAX
    package's right and full outer joins widen it to int64 (the default
    accumulator of the ``jnp.sum`` in its ``patch_string_lengths``),
    while every other type keeps the input's int32; the port keeps int32
    for every type. Its values are compared as the other columns'."""
    i = got[2].index("name#len")
    assert got[3][i] == np.int32
    assert want[3][i] == (np.int32 if join_type == "left" else np.int64)
    assert got[:3] == want[:3]
    assert got[3][:i] + got[3][i + 1:] == want[3][:i] + want[3][i + 1:]
    np.testing.assert_array_equal(got[4], want[4])


def _string_tables(seed, width):
    """A string key (``width`` bytes, interior lengths) with its '#len'
    companion on both sides, a probe key range half outside the build's,
    and an int64 payload a side."""
    rng = np.random.default_rng(seed)
    nb, npr = 150, 180
    out = []
    for n, lo, hi, side in ((nb, 0, 60, "b"), (npr, 30, 90, "p")):
        ids = rng.integers(lo, hi, n)
        b, ln = js.encode_strings([f"s{v * 7}"[:width] for v in ids], width)
        out.append(({"name": np.asarray(b),
                     "name" + js.LEN_SUFFIX: np.asarray(ln),
                     f"{side}v": rng.integers(1, 1000, n)},
                    rng.random(n) < 0.95))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("join_type", ["left", "right", "full_outer"])
def test_string_key_typed_join_matches_jax(join_type, mode):
    """String keys ride the typed path; for right and full outer joins
    the probe's '#len' companion of an unmatched build row is recomputed
    from the key bytes (``patch_string_lengths``), as in the JAX
    package."""
    (bc, bv), (pc, pv) = _string_tables(_seed(join_type, mode), 5)
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       "name", 1024, join_type=join_type)
    got = tjoin.sort_merge_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                      "name", 1024, join_type=join_type,
                                      kernel_config=KernelConfig(mode))
    _assert_same_string_join(_summary(got), _summary(want), join_type)
    cols, valid = got.table.to_numpy()
    assert cols["name"].dtype == np.uint8
    np.testing.assert_array_equal(
        cols["name#len"][valid], (cols["name"][valid] != 0).sum(1))


# -- the compaction sites' position contract ----------------------------


@pytest.mark.parametrize("join_type", TYPES[1:])
def test_typed_compaction_sites_get_cumsum_positions(monkeypatch, join_type):
    """The typed kernel route's two compaction sites: the run records
    (mask: the positions that emit) and the valid-build pack (mask: the
    valid builds), each with pos exactly cumsum(mask) - 1 over its
    survivors, which the compaction kernel relies on. Semi and anti
    joins carry no build lanes and pack nothing."""
    calls = []
    real = tjoin.stream_compact

    def record(mask, pos, cols, capacity, launch_counter=None):
        calls.append((launch_counter, mask, pos, capacity))
        return real(mask, pos, cols, capacity, launch_counter=launch_counter)
    monkeypatch.setattr(tjoin, "stream_compact", record)
    got = _port_local("invalid_rows", join_type, "kernel")
    _assert_same(_summary(got), _jax_local("invalid_rows", join_type))
    sites = {c[0]: c[1:] for c in calls}
    want_sites = {tjoin.compact_records}
    if join_type not in ("semi", "anti"):
        want_sites.add(tjoin.pack_valid_builds)
    assert set(sites) == want_sites and len(calls) == len(want_sites)
    for mask, pos, _ in sites.values():
        m = mask.bool()
        assert int(m.sum()) > 0
        np.testing.assert_array_equal(
            pos[m].long().numpy(),
            (torch.cumsum(m.to(torch.int64), 0) - 1)[m].numpy())
    mask, _, cap = sites[tjoin.compact_records]
    assert int(mask.sum()) <= int(got.total) and cap == OUT_CAP
    if join_type not in ("semi", "anti"):
        mask, _, cap = sites[tjoin.pack_valid_builds]
        _, bv, _, _, _ = _case("invalid_rows")
        assert int(mask.sum()) == int(bv.sum()) and cap == len(bv)


# -- refusals -----------------------------------------------------------


def test_typed_refusals_match_jax():
    """The same exception types as the JAX package: an unknown type, a
    semi or anti join with an explicit build payload, validity columns
    that collide with payload names, and a typed join with the skew
    sidecar."""
    rng = np.random.default_rng(5)
    bc = {"key": rng.integers(0, 9, 16), "bp": np.arange(16)}
    pc = {"key": rng.integers(0, 9, 16), "pp": np.arange(16)}
    v = np.ones(16, bool)
    pairs = ((jjoin.sort_merge_inner_join, _jtable),
             (tjoin.sort_merge_inner_join, _ttable))
    for fn, mk in pairs:
        with pytest.raises(ValueError, match="join_type"):
            fn(mk(bc, v), mk(pc, v), "key", 64, join_type="cross")
        for jt in ("semi", "anti"):
            with pytest.raises(ValueError, match="build_payload"):
                fn(mk(bc, v), mk(pc, v), "key", 64, join_type=jt,
                   build_payload=["bp"])
            res = fn(mk(bc, v), mk(pc, v), "key", 64, join_type=jt,
                     build_payload=[])
            assert list(res.table.columns) == ["key", "pp"]
        for jt, col in (("left", "build#valid"), ("right", "probe#valid"),
                        ("full_outer", "probe#valid")):
            with pytest.raises(ValueError, match="validity"):
                fn(mk(bc, v), mk({**pc, col: np.arange(16)}, v), "key", 64,
                   join_type=jt)
        # an inner join takes a payload of that name
        fn(mk(bc, v), mk({**pc, "build#valid": np.arange(16)}, v), "key", 64)
    jc = jcomm.make_communicator("local")
    for fn, mk, comm in ((jdist.distributed_inner_join, _jtable, jc),
                         (tdist.distributed_inner_join, _ttable,
                          LocalCommunicator())):
        with pytest.raises(ValueError, match="join_type"):
            fn(mk(bc, v), mk(pc, v), comm, join_type="cross")
        with pytest.raises(ValueError, match="skew"):
            fn(mk(bc, v), mk(pc, v), comm, join_type="left",
               skew_threshold=0.01)
        # a typed join refuses the aggregate pushdown, as in the JAX
        # package (before it looks at the spec)
        with pytest.raises(ValueError, match="aggregate pushdown"):
            fn(mk(bc, v), mk(pc, v), comm, join_type="left",
               aggregate=object())


# -- the distributed join -----------------------------------------------


@pytest.fixture(scope="module")
def jcomm8():
    return jcomm.make_communicator("tpu", n_ranks=8)


def _dist_tables(seed):
    rng = np.random.default_rng(seed)
    nb, npr = 600, 720
    bc = {"key": rng.integers(0, 400, nb), "bp": rng.integers(0, 1 << 40,
                                                              nb)}
    pc = {"key": rng.integers(200, 700, npr),
          "pp": rng.integers(0, 1 << 40, npr)}
    return (bc, rng.random(nb) < 0.95), (pc, rng.random(npr) < 0.95)


def _port_order(names, join_type):
    """The port keeps keys, build payloads, probe payloads, validity; the
    JAX distributed join returns its columns in name order (shard_map
    flattens the Table dict)."""
    order = ["key", "bp", "pp", tjoin.BUILD_VALID, tjoin.PROBE_VALID]
    assert names == [n for n in order if n in names], names
    return names


@pytest.mark.parametrize("join_type", TYPES)
def test_distributed_typed_join_matches_jax_8_ranks(join_type, jcomm8):
    """8 emulated ranks with over-decomposition 2 against the JAX
    package's 8-device CPU mesh, and the port's one-bucket path (one
    rank) against the same rows."""
    (bc, bv), (pc, pv) = _dist_tables(_seed("dist", join_type))
    opts = dict(join_type=join_type, over_decomposition=2,
                shuffle_capacity_factor=3.0, out_capacity_factor=4.0)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomm8, **opts)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(8), **opts)
    names = _port_order(got.table.column_names, join_type)
    assert sorted(names) == sorted(want.table.columns)
    _assert_same(_summary(got, names), _summary(want, names))
    assert not bool(got.overflow) and int(got.total) > 0
    one = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       LocalCommunicator(), **opts)
    _assert_same(_summary(one, names), _summary(want, names))


@pytest.mark.parametrize("join_type", ["right", "full_outer"])
def test_distributed_string_key_outer_join_matches_jax(join_type, jcomm8):
    """The step rebuilds string keys after the batches and recomputes the
    '#len' companion of unmatched build rows, as the JAX step does."""
    (bc, bv), (pc, pv) = _string_tables(_seed("dist-str", join_type), 6)
    opts = dict(key="name", join_type=join_type, out_capacity_factor=4.0)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomm8, **opts)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(8), **opts)
    names = got.table.column_names
    assert names[0] == "name" and names[-1] == tjoin.PROBE_VALID
    assert sorted(names) == sorted(want.table.columns)
    _assert_same_string_join(_summary(got, names), _summary(want, names),
                             join_type)
    cols, valid = got.table.to_numpy()
    absent = valid & ~cols[tjoin.PROBE_VALID]
    assert absent.any()
    np.testing.assert_array_equal(cols["name#len"][absent],
                                  (cols["name"][absent] != 0).sum(1))


def test_full_outer_overflow_recovered_by_the_ladder(jcomm8):
    """A duplicate-heavy full outer join overflows a starved output block
    loudly; auto_retry escalates through the same rungs in both packages
    and ends with the same rows (JAX's
    test_dup_heavy_outer_overflow_and_ladder)."""
    rng = np.random.default_rng(34)
    nb, npr = 1024, 2048
    bc = {"key": rng.integers(0, 400, nb), "bp": rng.integers(0, 999, nb)}
    pc = {"key": rng.integers(0, 500, npr), "pp": rng.integers(0, 999, npr)}
    bv, pv = np.ones(nb, bool), np.ones(npr, bool)
    opts = dict(join_type="full_outer", out_capacity_factor=0.25)
    starved = tdist.distributed_inner_join(
        _ttable(bc, bv), _ttable(pc, pv), EmulatedCommunicator(8), **opts)
    assert bool(starved.overflow)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomm8, auto_retry=6, **opts)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(8), auto_retry=6,
                                       **opts)
    fields = ("attempt", "action", "overflow", "out_capacity_factor",
              "out_rows_per_rank")
    jatt = [{f: getattr(a, f) for f in fields}
            for a in want.retry_report.attempts]
    tatt = [{f: getattr(a, f) for f in fields}
            for a in got.retry_report.attempts]
    assert len(tatt) > 1 and tatt == jatt and got.retry_report.resolved
    assert int(starved.total) == int(got.total) == int(want.total)
    names = got.table.column_names
    _assert_same(_summary(got, names), _summary(want, names))
