"""PyTorch port vs the JAX package: the hierarchical wire on the CPU.

The port's ``EmulatedCommunicator(8, n_slices=2)`` (8 ranks nested as 2
slices x 4 chips) against the JAX package's
``HierarchicalTpuCommunicator(n_slices=2, n_ranks=8)`` on the 8 virtual
CPU devices of tests/conftest.py, as the JAX package's
``tests/test_hierarchy.py`` fakes a multi-slice mesh: the mesh and its
refusals, the two-level route, ``shuffle_hierarchical`` with the
cross-slice codec off and on, the join (k = 1 and 2, skew, a string
key) against JAX and the pandas-free oracle of sorted rows, one slice
identical to the padded wire, the ladder's bits rung, and each tier's
bytes against their closed form. Inputs are made with numpy from a
seed; blocks and counts are compared exactly, join rows as sorted
multisets.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.parallel import mesh as jmesh
from distributed_join_tpu.parallel import shuffle as jshuffle
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils.generators import (
    generate_build_probe_tables as jgenerate,
)
from distributed_join_tpu_torch.ops import partition as tpart
from distributed_join_tpu_torch.ops.compression import ALLOWED_BITS
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import mesh as tmesh
from distributed_join_tpu_torch.parallel import shuffle as tshuffle
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    make_communicator,
)
from distributed_join_tpu_torch.table import Table

N = 8
LADDER_FIELDS = ("attempt", "action", "overflow", "shuffle_capacity_factor",
                 "out_capacity_factor", "out_rows_per_rank",
                 "compression_bits")


@pytest.fixture(scope="module")
def jh():
    return jcomm.HierarchicalTpuCommunicator(n_slices=2, n_ranks=N)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int64) if x.dtype == torch.uint64 else x
        return x.numpy()
    return np.asarray(x)


def _jtable(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _ttable(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _rows(cols, valid, names) -> np.ndarray:
    valid = _np(valid).astype(bool)
    parts = []
    for k in names:
        a = _np(cols[k])[valid]
        parts.append(a.reshape(a.shape[0], -1).astype(np.int64))
    a = np.concatenate(parts, axis=1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def _gen(seed, bn, pn, rand_max, sel, **kw):
    b, p = jgenerate(seed=seed, build_nrows=bn, probe_nrows=pn,
                     rand_max=rand_max, selectivity=sel, **kw)
    return ({k: np.asarray(v) for k, v in b.columns.items()},
            np.asarray(b.valid),
            {k: np.asarray(v) for k, v in p.columns.items()},
            np.asarray(p.valid))


def _oracle_rows(bc, bv, pc, pv, names, key="key"):
    """The inner join of the valid rows by brute force: every (build,
    probe) pair of equal keys, as sorted rows."""
    bi, pi = np.flatnonzero(bv), np.flatnonzero(pv)
    order = np.argsort(pc[key][pi], kind="stable")
    pk = pc[key][pi][order]
    pairs = []
    for b in bi:
        lo, hi = np.searchsorted(pk, bc[key][b], "left"), np.searchsorted(
            pk, bc[key][b], "right")
        pairs.extend((b, p) for p in pi[order[lo:hi]])
    b_idx = np.array([b for b, _ in pairs], np.int64)
    p_idx = np.array([p for _, p in pairs], np.int64)
    cols = {k: (bc[k][b_idx] if k in bc else pc[k][p_idx]) for k in names}
    return _rows(cols, np.ones(len(pairs), bool), names)


def _join_both(jc, bc, bv, pc, pv, oracle=True, **opts):
    """The same join in both packages over the 2 x 4 hierarchy: total,
    overflow, retry trail and rows equal (and equal to the oracle)."""
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jc, **opts)
    emu = EmulatedCommunicator(N, n_slices=2)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       emu, **opts)
    assert bool(got.overflow) == bool(want.overflow) is False
    assert int(got.total) == int(want.total) > 0
    assert [{f: getattr(a, f) for f in LADDER_FIELDS}
            for a in got.retry_report.attempts] == [
        {f: getattr(a, f) for f in LADDER_FIELDS}
        for a in want.retry_report.attempts]
    names = sorted(got.table.columns)
    assert names == sorted(want.table.columns)
    rows = _rows(got.table.columns, got.table.valid, names)
    np.testing.assert_array_equal(
        rows, _rows(want.table.columns, want.table.valid, names))
    if oracle:
        np.testing.assert_array_equal(
            rows, _oracle_rows(bc, bv, pc, pv, names, opts.get("key", "key")))
    return got, emu


# -- the mesh -------------------------------------------------------------


def test_mesh_refusals_and_layout_match_jax():
    for n_slices, match in ((3, "does not divide"), (0, "n_slices")):
        for make in (jmesh.make_hierarchical_mesh,
                     tmesh.make_hierarchical_mesh):
            with pytest.raises(ValueError, match=match):
                make(n_slices, N)
    for s in (1, 2, 4, 8):
        want = jmesh.make_hierarchical_mesh(s, N)
        got = tmesh.make_hierarchical_mesh(s, N)
        assert (got.n_slices, got.chips_per_slice) == tuple(
            want.devices.shape)
        # slice-major: rank r is (r // c, r % c), as the JAX mesh's
        # devices are laid out
        ids = np.vectorize(lambda d: d.id)(want.devices)
        for r in range(N):
            assert tuple(int(v) for v in np.argwhere(ids == r)[0]) == \
                got.coords(r)
    assert tmesh.device_slice_id(5) == 0


def test_device_slice_id_is_the_node(monkeypatch):
    """Under a launcher that sets LOCAL_WORLD_SIZE a rank's slow-tier
    group is its node; without it every rank is on one node."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert [tmesh.device_slice_id(r) for r in range(8)] == [0] * 4 + [1] * 4
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert {tmesh.device_slice_id(r) for r in range(8)} == {0}


def test_factory_builds_hierarchical_communicators():
    comm = make_communicator("emulated", n_ranks=N, n_slices=2)
    assert (comm.n_slices, comm.chips_per_slice) == (2, 4)
    flat = make_communicator("emulated", n_ranks=N, n_slices=1)
    assert (flat.n_slices, flat.chips_per_slice) == (1, N)
    with pytest.raises(ValueError, match="slices"):
        make_communicator("local", n_slices=2)
    with pytest.raises(ValueError, match="slices"):
        jcomm.make_communicator("local", n_slices=2)
    with pytest.raises(ValueError, match="does not divide"):
        make_communicator("emulated", n_ranks=N, n_slices=3)


# -- the route ----------------------------------------------------------------


@pytest.mark.parametrize("slices", [2, 4, 8])
def test_hier_route_equals_all_to_all_and_jax(slices):
    """The two-level route of an (n, m, 2) block equals one global
    all_to_all of it and the JAX package's route, for 2 x 4, 4 x 2 and
    8 x 1 (all traffic cross-slice)."""
    rng = np.random.default_rng(slices)
    x = rng.integers(-(1 << 60), 1 << 60, (N * N, 3, 2))
    emu = EmulatedCommunicator(N, n_slices=slices)
    got = emu.spmd(lambda t: tshuffle._hier_route(emu, t))(
        torch.from_numpy(x))
    flat = emu.spmd(lambda t: emu.all_to_all(t))(torch.from_numpy(x))
    assert torch.equal(got, flat)
    jc = jcomm.HierarchicalTpuCommunicator(n_slices=slices, n_ranks=N)
    want = jc.spmd(lambda t: jshuffle._hier_route(jc, t))(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the phase-1 hop alone
    p1 = emu.spmd(lambda t: tshuffle._hier_phase1(emu, t).reshape(
        (N,) + tuple(t.shape[1:])))(torch.from_numpy(x))
    jp1 = jc.spmd(lambda t: jshuffle._hier_phase1(jc, t).reshape(
        (N,) + t.shape[1:]))(jnp.asarray(x))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(jp1))


def _shuffle_inputs(seed=4, rows=2048):
    rng = np.random.default_rng(seed)
    cols = {"key": rng.integers(0, 1000, rows).astype(np.int64),
            "small": rng.integers(0, 12, rows).astype(np.int32),
            "wide": rng.integers(-(1 << 13), 1 << 13, rows),
            "__sk0w0": rng.integers(-(1 << 62), 1 << 62, rows),
            "s": rng.integers(0, 256, (rows, 8)).astype(np.uint8)}
    return cols, rng.random(rows) >= 0.1


@pytest.mark.parametrize("bits", [None, 4, 16, 32])
def test_shuffle_hierarchical_matches_jax(jh, bits):
    """Received table, counts and the codec's flag, the codec off and
    at 4 (overflowing on the wide column), 16 and 32 bits, with a string
    column and a packed string-key word column riding raw."""
    cap = 80
    cols, valid = _shuffle_inputs()
    names = list(cols)

    def step(comm, part, shuffle_hierarchical):
        def fn(t):
            pt = part.radix_hash_partition(t, ["key"], N)
            padded, counts, _, _ = pt.to_padded(cap)
            got, rc, ovf = shuffle_hierarchical(comm, padded, counts, cap,
                                                dcn_bits=bits)
            return [got.columns[k] for k in names], got.valid, rc, ovf[None]
        return fn

    want = jh.spmd(step(jh, jpart, jshuffle.shuffle_hierarchical))(
        _jtable(cols, valid))
    emu = EmulatedCommunicator(N, n_slices=2)
    got = emu.spmd(step(emu, tpart, tshuffle.shuffle_hierarchical))(
        _ttable(cols, valid))
    valid_rows = _np(got[1])
    np.testing.assert_array_equal(valid_rows, _np(want[1]))
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
    assert bool(_np(got[3]).any()) == (bits == 4)
    for k, g, w in zip(names, got[0], want[0]):
        if bits == 4 and k in ("key", "wide"):
            continue  # overflowed columns: rows are not to be trusted
        np.testing.assert_array_equal(_np(g)[valid_rows], _np(w)[valid_rows],
                                      err_msg=k)


# -- the join ------------------------------------------------------------------


@pytest.mark.parametrize("k,codec", [(1, "off"), (2, "on"), (3, "on"),
                                     (1, "on")])
def test_hier_join_matches_jax_and_oracle(jh, k, codec):
    _join_both(jh, *_gen(21, 4096, 8192, 2048, 0.5), shuffle="hierarchical",
               dcn_codec=codec, over_decomposition=k, out_capacity_factor=3.0)


def test_hier_join_skew_matches_jax(jh):
    """Heavy duplication and the skew sidecar over the route: the
    sidecar all-gathers over every rank, the light rows ride two hops."""
    _join_both(jh, *_gen(22, 2048, 4096, 64, 0.9, unique_build_keys=False),
               shuffle="hierarchical", dcn_codec="on", skew_threshold=0.05,
               out_capacity_factor=0.0, out_rows_per_rank=200_000,
               shuffle_capacity_factor=8.0, hh_out_capacity=200_000)


def test_hier_join_string_key_matches_jax(jh):
    rng = np.random.default_rng(9)
    bn, pn = 2048, 4096

    def names(ids):
        txt = np.zeros((len(ids), 10), np.uint8)
        for i, v in enumerate(ids):
            txt[i, :6] = np.frombuffer(f"n{v:05d}".encode(), np.uint8)
        return txt, np.full(len(ids), 6, np.int32)

    bc, pc = {"bv": rng.integers(0, 1000, bn)}, {"pv": rng.integers(
        0, 1000, pn)}
    bc["name"], bc["name#len"] = names(rng.integers(0, 300, bn))
    pc["name"], pc["name#len"] = names(rng.integers(0, 300, pn))
    _join_both(jh, bc, np.ones(bn, bool), pc, np.ones(pn, bool),
               oracle=False, key="name", shuffle="hierarchical",
               dcn_codec="on", out_capacity_factor=10.0,
               shuffle_capacity_factor=6.0, auto_retry=2)


def test_pure_cross_slice_hierarchy_matches_jax():
    """8 slices of one chip: the intra-slice hop is an identity and
    every block crosses slices."""
    bc, bv, pc, pv = _gen(24, 2048, 4096, 1024, 0.5)
    opts = dict(shuffle="hierarchical", dcn_codec="off",
                out_capacity_factor=3.0)
    jc = jcomm.HierarchicalTpuCommunicator(n_slices=8, n_ranks=N)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jc, **opts)
    emu = EmulatedCommunicator(N, n_slices=8)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       emu, **opts)
    names = sorted(got.table.columns)
    assert int(got.total) == int(want.total) > 0
    np.testing.assert_array_equal(
        _rows(got.table.columns, got.table.valid, names),
        _rows(want.table.columns, want.table.valid, names))
    assert emu.wire_bytes_dcn == emu.wire_bytes_ici > 0


def test_single_slice_is_the_padded_wire():
    """One slice: the hierarchical mode runs the padded wire, byte for
    byte: the same rows in the same order and the same counters, with
    nothing on either tier (the codec knob is ignored)."""
    bc, bv, pc, pv = _gen(23, 2048, 2048, 1024, 0.5)
    outs = []
    for opts in (dict(shuffle="padded"),
                 dict(shuffle="hierarchical", dcn_codec="on")):
        emu = EmulatedCommunicator(N)
        res = tdist.distributed_inner_join(
            _ttable(bc, bv), _ttable(pc, pv), emu, out_capacity_factor=3.0,
            **opts)
        outs.append((res, emu.counters()))
        assert res.retry_report.attempts[0].compression_bits is None
    (pad, pc_), (hier, hc) = outs
    assert pc_ == hc and hc["wire_bytes_ici"] == hc["wire_bytes_dcn"] == 0
    for k in pad.table.columns:
        assert torch.equal(pad.table.columns[k], hier.table.columns[k])
    assert torch.equal(pad.table.valid, hier.table.valid)


def test_bits_rung_widens_on_a_codec_overflow_like_jax(jh):
    """2-bit residuals overflow on these keys: the ladder widens the
    cross-slice codec's bits before it doubles a capacity, in both."""
    got, _ = _join_both(jh, *_gen(25, 4096, 4096, 2048, 0.5),
                        shuffle="hierarchical", dcn_codec="on",
                        compression_bits=2, auto_retry=5,
                        out_capacity_factor=3.0)
    acts = [(a.action, a.compression_bits)
            for a in got.retry_report.attempts]
    assert acts[0] == ("initial", 2)
    assert all(a == "widen_compression_bits" for a, _ in acts[1:])
    assert acts[-1][1] in (8, 16, 32)


# -- refusals ----------------------------------------------------------------


def test_refusals_match_jax(jh):
    emu = EmulatedCommunicator(N, n_slices=2)
    for comm, mod in ((emu, tdist), (jh, jdist)):
        for mode in ("padded", "ragged", "ppermute"):
            with pytest.raises(ValueError, match="hierarchical"):
                mod.make_join_step(comm, shuffle=mode)
        with pytest.raises(ValueError, match="dcn_codec"):
            mod.make_join_step(comm, shuffle="hierarchical",
                               dcn_codec="sometimes")
        with pytest.raises(ValueError, match="contradicts"):
            mod.make_join_step(comm, shuffle="hierarchical",
                               dcn_codec="off", compression_bits=16)
    # auto resolves by the port's cost model (planning/cost.py): the
    # H100's tier across nodes sits below the codec's break-even, so the
    # codec goes on, as the JAX package's model puts it on for the TPU
    tdist.make_join_step(emu, shuffle="hierarchical")
    res = tdist.distributed_inner_join(
        _ttable({"key": np.arange(8)}, np.ones(8, bool)),
        _ttable({"key": np.arange(8)}, np.ones(8, bool)), emu,
        shuffle="hierarchical", with_metrics=True, explain=True)
    assert int(res.total) == 8 and res.plan.capacities is not None
    assert res.retry_report.attempts[0].compression_bits == \
        tdist.DEFAULT_DCN_CODEC_BITS
    red = res.telemetry.to_dict()["reduced"]
    assert red["build.wire_bytes_dcn"] == \
        res.plan.wire["build"]["dcn_bytes_per_rank"] * N
    # on other shuffles, and on one slice, the knob is validated and
    # ignored
    tdist.make_join_step(EmulatedCommunicator(N), dcn_codec="auto")
    tdist.make_join_step(EmulatedCommunicator(N), shuffle="hierarchical")
    with pytest.raises(ValueError, match="dcn_codec"):
        tdist.make_join_step(EmulatedCommunicator(N), dcn_codec="bogus")


# -- each tier's bytes -------------------------------------------------------


def _padded_caps(local_rows, nb, factor=1.6):
    import math
    return -(-int(math.ceil(local_rows / nb * factor)) // 8) * 8


@pytest.mark.parametrize("codec", ["off", "on"])
def test_tier_bytes_equal_their_closed_form(codec):
    """The hierarchical join's counters against the closed form (JAX's
    metrics tape is red on jax 0.9.0, so the port's counters are held
    against the expectations of tests/test_hierarchy.py): every block
    once on each tier with the codec off; with it on, the intra-slice
    tier still carries every block, the cross-slice tier the codec's
    words and frames for the integer columns (one frame stream a
    destination slice), and the saving is the difference."""
    bc, bv, pc, pv = _gen(25, 4096, 8192, 2048, 0.5)
    k, s, c, bits, block = 2, 2, N // 2, 16, 256
    _, emu = _join_both(
        jcomm.HierarchicalTpuCommunicator(n_slices=2, n_ranks=N), bc, bv,
        pc, pv, shuffle="hierarchical", dcn_codec=codec,
        compression_bits=bits if codec == "on" else None,
        over_decomposition=k, out_capacity_factor=3.0)
    ici = dcn = saved = 0
    for cols, rows in ((bc, 4096), (pc, 8192)):
        cap = _padded_caps(rows // N, k * N)
        for col in cols.values():
            block_bytes = N * cap * col.itemsize
            ici += block_bytes
            if codec == "off":
                dcn += block_bytes
                continue
            n_pad = -(-c * cap // block) * block
            enc = s * (n_pad * bits // 8 + 8 * n_pad // block)
            dcn += enc
            saved += block_bytes - enc
    # every rank, every batch
    assert emu.wire_bytes_ici == N * k * ici
    assert emu.wire_bytes_dcn == N * k * dcn
    assert emu.wire_bytes_saved == N * k * saved
    assert emu.wire_bytes == emu.wire_bytes_ici + emu.wire_bytes_dcn
    if codec == "on":
        # the cross-slice bytes fall below what the flat padded wire
        # moves for the same join, and the codec saved bytes
        flat = EmulatedCommunicator(N)
        tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv), flat,
                                     over_decomposition=k,
                                     out_capacity_factor=3.0)
        assert 0 < emu.wire_bytes_dcn < flat.wire_bytes
        assert emu.wire_bytes_saved > 0
    assert bits in ALLOWED_BITS


# -- the drivers ----------------------------------------------------------------


@pytest.mark.parametrize("codec", ["off", "on"])
def test_driver_hierarchical_record_matches_jax_driver(codec):
    """The join driver on 8 ranks as 2 slices: the wire fields of its
    record (``shuffle``, ``slices``, ``dcn_codec``, ``compression_bits``,
    the overflow flag and the ladder's rungs) against the JAX driver's
    for the same flags, and the tier bytes of a join."""
    from distributed_join_tpu.benchmarks import distributed_join as jdriver
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    flags = ["--build-table-nrows", "8000", "--probe-table-nrows", "8000",
             "--iterations", "1", "--shuffle", "hierarchical", "--slices",
             "2", "--dcn-codec", codec, "--auto-retry", "2"]
    want = jdriver.run(jdriver.parse_args(
        ["--communicator", "tpu", "--n-ranks", "8", *flags]))
    got = tdriver.run(tdriver.parse_args(
        ["--communicator", "emulated", "--n-ranks", "8", *flags]),
        device="cpu")
    for f in ("shuffle", "slices", "dcn_codec", "compression_bits",
              "overflow"):
        assert got[f] == want[f], f
    assert not got["overflow"]

    def rungs(rec):
        return [(a["action"], a["compression_bits"])
                for a in (rec["retry"] or {}).get("attempts", [])]

    assert rungs(got) == rungs(want)
    # emulated ranks live in one process: the slices are no nodes
    assert got["slices_are_nodes"] is False
    assert got["wire_bytes_per_join"] == (got["wire_bytes_ici_per_join"]
                                          + got["wire_bytes_dcn_per_join"])
    assert (got["wire_bytes_saved_per_join"] > 0) == (codec == "on")


def test_driver_slices_refusals():
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    base = ["--communicator", "emulated", "--n-ranks", "4",
            "--build-table-nrows", "4000", "--probe-table-nrows", "4000",
            "--iterations", "1"]
    for extra, match in ((["--slices", "2"], "--shuffle hierarchical"),
                         (["--shuffle", "hierarchical", "--slices", "3",
                           "--dcn-codec", "off"], "does not divide")):
        with pytest.raises(SystemExit, match=match):
            tdriver.run(tdriver.parse_args(base + extra), device="cpu")
    # --dcn-codec auto (the default) resolves by the port's cost model:
    # the codec on the tier across slices, saving bytes there
    rec = tdriver.run(tdriver.parse_args(
        base + ["--shuffle", "hierarchical", "--slices", "2"]), device="cpu")
    assert rec["dcn_codec"] == "auto" and not rec["overflow"]
    assert rec["wire_bytes_saved_per_join"] > 0


def test_wire_bytes_of_a_block_with_a_strided_unit_dimension():
    """A process group moves every tensor as (rows, row bytes): a
    contiguous block may carry any stride on a dimension of size 1 (the
    counts' (2, 1) block of a 2 x 1 slice mesh), and its bytes must
    still cross bit-exact."""
    import math

    import torch

    from distributed_join_tpu_torch.parallel.communicator import (
        _from_bytes,
        _to_bytes,
    )
    x = torch.arange(2, dtype=torch.int32).reshape(1, 2).transpose(0, 1)
    assert x.is_contiguous() and x.stride() == (1, 2)
    for t in (x, torch.zeros(0, 3, dtype=torch.int64),
              torch.arange(12).reshape(3, 4), torch.ones(5, dtype=torch.bool),
              torch.arange(24, dtype=torch.int16).reshape(2, 3, 4)):
        b = _to_bytes(t)
        assert b.dtype == torch.uint8
        assert b.shape == (t.shape[0],
                           math.prod(t.shape[1:]) * t.element_size())
        assert torch.equal(_from_bytes(b, t), t)
