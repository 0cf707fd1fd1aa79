"""PyTorch port vs the JAX package on the CPU: typed joins (int32,
float32 and float64 keys and payloads), composite keys, 2-D payload
columns, the float64 lane, the float32 hash's signed zeros, the config
driver's typed, composite and string flags, and the config-5 generator.
Inputs come from numpy with a seed and reach both packages as numpy
arrays; join rows are compared as exact sorted multisets, under the
port's kernel pipeline (through the kernels' plain twins) and its plain
formulation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.benchmarks import distributed_join as jdriver
from distributed_join_tpu.ops import hashing as jh
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils import generators as jgen
from distributed_join_tpu.utils import strings as js
from distributed_join_tpu_torch.benchmarks import distributed_join as tdriver
from distributed_join_tpu_torch.ops import hashing as th
from distributed_join_tpu_torch.ops import join as tjoin
from distributed_join_tpu_torch.ops import lanes as tl
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils import generators as tgen

MODES = ["kernel", "plain"]


def _rows(cols, valid, names) -> np.ndarray:
    """Valid rows as a lexicographically sorted int64 array: 2-D columns
    one int64 column an element, floats by their float64 bits."""
    valid = np.asarray(valid)
    parts = []
    for n in names:
        a = np.asarray(cols[n])[valid]
        a = a.reshape(a.shape[0], -1)
        parts.append(a.astype(np.float64).view(np.int64)
                     if a.dtype.kind == "f" else a.astype(np.int64))
    a = np.concatenate(parts, axis=1)
    return a[np.lexsort(a.T[::-1])]


def _jtable(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _ttable(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _check_join(bc, bv, pc, pv, keys, cap, mode, **kw):
    """The port's join (``mode``) against the JAX package's: names,
    dtypes, shapes, total and the rows."""
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       keys, cap, **kw)
    got = tjoin.sort_merge_inner_join(_ttable(bc, bv), _ttable(pc, pv), keys,
                                      cap, kernel_config=KernelConfig(mode),
                                      **kw)
    names = list(want.table.columns)
    assert got.table.column_names == names
    for nm in names:
        g, w = got.table.columns[nm].numpy(), np.asarray(
            want.table.columns[nm])
        assert g.dtype == w.dtype and g.shape == w.shape, nm
    assert int(got.total) == int(want.total) > 0
    assert bool(got.overflow) == bool(want.overflow)
    gc, gv = got.table.to_numpy()
    np.testing.assert_array_equal(
        _rows(gc, gv, names),
        _rows(want.table.columns, want.table.valid, names))
    return got


def _typed_keys(rng, dtype, n, key_max):
    k = rng.integers(0, key_max, n)
    if np.dtype(dtype).kind != "f":
        return k.astype(dtype)
    k = (k - key_max // 2).astype(dtype) / 4
    k[rng.random(n) < 0.06] = 0.0
    k[rng.random(n) < 0.06] = -0.0
    k[rng.random(n) < 0.03] = np.inf
    k[rng.random(n) < 0.03] = -np.inf
    return k


# -- typed and composite joins ------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
def test_typed_join_matches_jax(dtype, mode):
    """Keys and payloads of one type; float keys include +-0.0 and
    +-inf, which join as IEEE equality says (0.0 == -0.0)."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize * 10 + len(mode))
    nb, npr = 300, 400
    bc = {"key": _typed_keys(rng, dtype, nb, 80),
          "bp": rng.standard_normal(nb).astype(dtype)
          if np.dtype(dtype).kind == "f" else rng.integers(-9, 9, nb)
          .astype(dtype)}
    pc = {"key": _typed_keys(rng, dtype, npr, 80),
          "pp": rng.integers(-99, 99, npr).astype(dtype)}
    bv, pv = rng.random(nb) < 0.9, rng.random(npr) < 0.9
    _check_join(bc, bv, pc, pv, "key", 8192, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ncols", [2, 3])
def test_composite_key_join_matches_jax(ncols, mode):
    """2 and 3 key columns of mixed dtypes (int64, int32, float64)."""
    rng = np.random.default_rng(ncols + 31 * len(mode))
    kdt = [np.int64, np.int32, np.float64][:ncols]
    nb, npr = 300, 350
    bc = {f"k{i}": rng.integers(0, 4, nb).astype(d) for i, d in
          enumerate(kdt)}
    pc = {f"k{i}": rng.integers(0, 5, npr).astype(d) for i, d in
          enumerate(kdt)}
    bc["bp"], pc["pp"] = rng.integers(0, 1000, nb), rng.integers(0, 1000,
                                                                  npr)
    bv, pv = rng.random(nb) < 0.95, np.ones(npr, bool)
    _check_join(bc, bv, pc, pv, [f"k{i}" for i in range(ncols)], 16384, mode)


TWO_D = {
    "build": (True, False, True),
    "probe": (False, True, True),
    "both": (True, True, True),
    "build_only_2d": (True, False, False),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(TWO_D))
def test_2d_payload_join_matches_jax(case, mode):
    """2-D payloads on either side and on both (uint8 bytes and an int16
    matrix); ``build_only_2d`` has no 1-D build payload, so only the
    build row index rides the matched-build pack."""
    b2d, p2d, b1d = TWO_D[case]
    rng = np.random.default_rng(len(case) * 7 + len(mode))
    nb, npr = 250, 300
    bc = {"key": rng.integers(0, 60, nb)}
    pc = {"key": rng.integers(0, 90, npr)}
    if b1d:
        bc["bp"] = rng.integers(-(1 << 40), 1 << 40, nb)
    pc["pp"] = rng.integers(0, 7, npr).astype(np.int32)
    if b2d:
        bc["bs"] = rng.integers(0, 256, (nb, 7)).astype(np.uint8)
        bc["bm"] = rng.integers(-300, 300, (nb, 3)).astype(np.int16)
    if p2d:
        pc["ps"] = rng.integers(0, 256, (npr, 12)).astype(np.uint8)
    bv, pv = rng.random(nb) < 0.9, rng.random(npr) < 0.9
    _check_join(bc, bv, pc, pv, "key", 4096, mode)


def test_same_2d_name_on_both_sides_is_refused_as_in_jax():
    rng = np.random.default_rng(3)
    cols = {"key": np.arange(8), "s": rng.integers(0, 9, (8, 4))
            .astype(np.uint8)}
    valid = np.ones(8, bool)
    for join, mk in ((jjoin.sort_merge_inner_join, _jtable),
                     (tjoin.sort_merge_inner_join, _ttable)):
        with pytest.raises(ValueError, match="collision"):
            join(mk(cols, valid), mk(cols, valid), "key", 16)


def test_float64_join_takes_the_kernel_pipeline(monkeypatch):
    """float64 keys and payloads ride lanes: with the kernel pipeline
    asked for, the join never falls to the plain formulation."""
    calls = []
    real = tjoin._join_kernel_path
    monkeypatch.setattr(tjoin, "_join_plain",
                        lambda *a, **k: pytest.fail("took the plain path"))
    monkeypatch.setattr(tjoin, "_join_kernel_path",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(8)
    bc = {"key": _typed_keys(rng, np.float64, 200, 40),
          "bp": rng.standard_normal(200)}
    pc = {"key": _typed_keys(rng, np.float64, 200, 40),
          "pp": rng.standard_normal(200)}
    _check_join(bc, np.ones(200, bool), pc, np.ones(200, bool), "key", 4096,
                "kernel")
    assert calls == [1]


def test_float64_lane_is_the_bit_view():
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-310, -2.5,
                     np.finfo(np.float64).max], dtype=np.float64)
    c = torch.from_numpy(vals)
    assert tl.u64_lane_ok(torch.float64)
    lane = tl.to_u64_lane(c)
    assert lane.dtype == torch.int64
    np.testing.assert_array_equal(lane.numpy(), vals.view(np.int64))
    back = tl.from_u64_lane(lane, torch.float64)
    np.testing.assert_array_equal(back.numpy().view(np.int64),
                                  vals.view(np.int64))


# -- the float32 hash's signed zeros ------------------------------------


def test_float32_bucket_ids_equal_jax_except_negative_zero():
    """Every float32 bucket id equals the JAX package's except at -0.0,
    where the port folds onto 0.0 (one bucket at n = 3) and the JAX
    package hashes the raw bits (its -0.0 lands in another bucket: a
    fault of the reference, which the port does not copy)."""
    rng = np.random.default_rng(19)
    k = np.concatenate([(rng.standard_normal(4000) * 1e4).astype(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0],
                                 np.float32)])
    neg0 = (k == 0) & np.signbit(k)
    for n in (3, 8, 1000):
        want = np.asarray(jh.bucket_ids([jnp.asarray(k)], n))
        got = th.bucket_ids([torch.from_numpy(k)], n).numpy()
        np.testing.assert_array_equal(got[~neg0], want[~neg0])
    z = np.array([0.0, -0.0], np.float32)
    tz = th.bucket_ids([torch.from_numpy(z)], 3).numpy()
    jz = np.asarray(jh.bucket_ids([jnp.asarray(z)], 3))
    assert tz[0] == tz[1]
    assert jz[0] != jz[1]          # the reference fault, recorded


def _signed_zero_tables():
    rng = np.random.default_rng(23)
    n = 96
    bk = rng.integers(1, 50, n).astype(np.float32)
    pk = rng.integers(1, 50, n).astype(np.float32)
    bk[:4] = 0.0
    pk[:3] = -0.0
    return ({"key": bk, "bp": np.arange(n)}, np.ones(n, bool)), \
        ({"key": pk, "pp": np.arange(n)}, np.ones(n, bool))


def test_float32_signed_zeros_meet_in_a_3_rank_join():
    """0.0 on the build side and -0.0 on the probe side are one key: a
    3-rank emulated join finds all 4 x 3 of their matches and equals the
    1-rank join (and the JAX package's local join)."""
    (bc, bv), (pc, pv) = _signed_zero_tables()
    three = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                         EmulatedCommunicator(3),
                                         out_capacity_factor=4.0)
    one = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       LocalCommunicator(),
                                       out_capacity_factor=4.0)
    local = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        "key", 4096)
    names = ["key", "bp", "pp"]
    assert int(three.total) == int(one.total) == int(local.total)
    gc, gv = three.table.to_numpy()
    zero_rows = (gc["key"] == 0) & gv
    assert int(zero_rows.sum()) == 12
    np.testing.assert_array_equal(
        _rows(gc, gv, names),
        _rows(local.table.columns, local.table.valid, names))
    # the JAX package's 3-rank join routes -0.0 apart and loses them
    jres = jdist.distributed_inner_join(
        _jtable(bc, bv), _jtable(pc, pv),
        jcomm.make_communicator("tpu", n_ranks=3), out_capacity_factor=4.0)
    assert int(jres.total) == int(local.total) - 12


# -- the config driver --------------------------------------------------

SEVEN = ["--key-type", "float32", "--payload-type", "int32",
         "--key-columns", "3", "--string-payload-bytes", "12",
         "--string-payload-columns", "2", "--variable-length-strings",
         "--string-key-bytes", "16"]
SEVEN_FIELDS = ("key_type", "payload_type", "key_columns",
                "string_payload_bytes", "string_payload_columns",
                "variable_length_strings", "string_key_bytes")


def test_driver_parses_the_seven_flags_as_jax():
    targs, jargs = tdriver.parse_args(SEVEN), jdriver.parse_args(SEVEN)
    for f in SEVEN_FIELDS:
        assert getattr(targs, f) == getattr(jargs, f), f
    assert list(tdriver.DTYPES) == list(jdriver.DTYPES)
    assert not any(f in tdriver._REFUSED for f in SEVEN[::2] if
                   f.startswith("--"))
    d_t, d_j = tdriver.parse_args([]), jdriver.parse_args([])
    for f in SEVEN_FIELDS:
        assert getattr(d_t, f) == getattr(d_j, f), f


@pytest.mark.parametrize("argv,match", [
    (["--key-columns", "2", "--zipf-alpha", "1.5"], "zipf"),
    (["--string-payload-bytes", "16", "--zipf-alpha", "1.5"], "zipf"),
    (["--key-columns", "2", "--key-type", "float32"], "int64"),
    (["--key-columns", "2", "--string-key-bytes", "16"], "single key"),
    (["--string-key-bytes", "4"], ">= 5"),
])
def test_driver_refusals_match_jax(argv, match):
    common = ["--build-table-nrows", "64", "--probe-table-nrows", "64",
              "--iterations", "1"]
    with pytest.raises(SystemExit) as want:
        jdriver.run(jdriver.parse_args(common + argv))
    with pytest.raises(SystemExit) as got:
        tdriver.run(tdriver.parse_args(common + argv), device="cpu")
    assert str(got.value) == str(want.value)
    assert match in str(got.value)


@pytest.mark.parametrize("argv", [
    ["--key-columns", "2", "--string-payload-bytes", "16"],
    ["--key-type", "float64", "--payload-type", "float64"],
    ["--string-key-bytes", "16", "--communicator", "emulated",
     "--n-ranks", "4"],
])
def test_driver_record_carries_the_jax_field_names(argv):
    args = tdriver.parse_args(["--build-table-nrows", "4000",
                               "--probe-table-nrows", "4000",
                               "--iterations", "1"] + argv)
    rec = tdriver.run(args, device="cpu")
    for f in (*SEVEN_FIELDS, "string_wire_bytes"):
        assert f in rec, f
        if f != "string_wire_bytes":
            assert rec[f] == getattr(args, f)
    assert not rec["overflow"] and rec["matches_per_join"] > 0
    # the wire accounting equals the JAX driver's on the same build table
    build, _, _ = tdriver.make_tables(args, torch.device("cpu"))
    cols, valid = build.to_numpy()
    want = jdriver._string_wire_accounting(_jtable(cols, valid), "padded")
    assert rec["string_wire_bytes"] == want


# -- tables and generators ----------------------------------------------


def test_table_from_numpy_takes_2d_uint8_columns():
    rng = np.random.default_rng(2)
    cols = {"key": np.arange(6), "s": rng.integers(0, 256, (6, 5))
            .astype(np.uint8)}
    t = Table.from_numpy(cols, np.ones(6, bool), device="cpu")
    assert t.columns["s"].dtype == torch.uint8
    assert tuple(t.columns["s"].shape) == (6, 5)
    back, valid = t.to_numpy()
    np.testing.assert_array_equal(back["s"], cols["s"])
    grown = t.pad_to(9)
    assert tuple(grown.columns["s"].shape) == (9, 5)
    assert not grown.columns["s"][6:].any() and not grown.valid[6:].any()


def test_composite_generator_matches_jax_derivation():
    """The derived key columns are the JAX package's on the same base
    keys, bit for bit, and the string payloads are the JAX package's
    rendering of the port's row ids."""
    build, probe, keys = tgen.generate_composite_build_probe_tables(
        seed=3, build_nrows=500, probe_nrows=700, key_columns=3,
        string_payload_len=16, string_payload_columns=2,
        variable_length_strings=True, device="cpu")
    assert keys == ["key0", "key1", "key2"]
    for t in (build, probe):
        base = t.columns["key0"].numpy()
        want = jgen.expand_composite_key(jnp.asarray(base), 3, 500)
        for k in keys:
            np.testing.assert_array_equal(t.columns[k].numpy(),
                                          np.asarray(want[k]))
    ids = build.columns["build_payload"].numpy()
    for c, (name, prefix) in enumerate((("build_tag", "itm-"),
                                        ("build_tag1", "tg1-"))):
        col_ids = ids if c == 0 else (ids * 3 + 1) % 10**9
        wb, wl = js.encode_int_strings(col_ids, prefix=prefix, digits=12,
                                       pad_digits=False)
        np.testing.assert_array_equal(build.columns[name].numpy(),
                                      np.asarray(wb))
        np.testing.assert_array_equal(
            build.columns[name + js.LEN_SUFFIX].numpy(), np.asarray(wl))


def test_float_key_range_check_against_jax():
    """float32 holds every integer up to 2^24: the port refuses a key
    range exactly when two of its keys would collide; the JAX package's
    check refuses from 2^23 on, so it refuses everything the port
    refuses (and some ranges without a collision)."""
    for needed in (2**23, 2**23 + 1, 2**24, 2**24 + 1, 2**24 + 2):
        keys = np.arange(needed - 2, needed, dtype=np.int64)
        collide = np.unique(keys.astype(np.float32)).shape[0] < 2
        try:
            tgen.check_float_key_range(torch.float32, needed)
            port_ok = True
        except ValueError:
            port_ok = False
        try:
            jgen._check_float_key_range(jnp.float32, needed)
            jax_ok = True
        except ValueError:
            jax_ok = False
        assert port_ok == (not collide), needed
        assert jax_ok <= port_ok
    tgen.check_float_key_range(torch.int32, 2**40)
