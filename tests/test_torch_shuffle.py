"""PyTorch port vs the JAX package: the flat shuffle wires on the CPU.

The partition's within-bucket order, the ragged plan, the exact-size
shuffle with its byte-exact string wire, the FoR + bit-pack codec, the
compressed padded shuffle, the ppermute exchange, the ragged plan's
validation, the ladder's compression rung, and the distributed join in
each wire mode. Inputs are made with numpy from a seed and reach both
packages as numpy arrays. The JAX package runs on the 8 virtual CPU
devices of tests/conftest.py (its ragged exchange through its own
emulation), the port on ``EmulatedCommunicator``. Shuffled blocks,
plans and codec words are compared exactly, position by position; join
rows as sorted multisets (row order within a key run is free in both).
"""

import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import compression as jcodec
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.parallel import faults as jfaults
from distributed_join_tpu.parallel import shuffle as jshuffle
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import compression as tcodec
from distributed_join_tpu_torch.ops import partition as tpart
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import faults as tfaults
from distributed_join_tpu_torch.parallel import shuffle as tshuffle
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.table import Table

LADDER_FIELDS = ("attempt", "action", "overflow", "shuffle_capacity_factor",
                 "out_capacity_factor", "out_rows_per_rank",
                 "compression_bits", "hh_build_capacity",
                 "hh_probe_capacity", "hh_out_capacity")


def _jtable(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _ttable(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _np(x) -> np.ndarray:
    """A tensor or JAX array as numpy (uint64 as its int64 bits)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int64) if x.dtype == torch.uint64 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _strings(rng, n, width, tie_every=1):
    """(bytes uint8 (n, width), lengths int32 (n,)): lengths 0..width,
    drawn from few values so that many rows tie, and zero bytes past
    each length."""
    lens = (rng.integers(0, width + 1, n) // tie_every) * tie_every
    lens = np.minimum(lens, width).astype(np.int32)
    raw = rng.integers(1, 256, (n, width)).astype(np.uint8)
    raw[np.arange(width)[None, :] >= lens[:, None]] = 0
    return raw, lens


def _string_table(rng, n, key_max, widths, invalid=0.0):
    cols = {"key": rng.integers(0, key_max, n).astype(np.int64),
            "v": rng.integers(-(1 << 40), 1 << 40, n)}
    for i, w in enumerate(widths):
        cols[f"s{i}"], cols[f"s{i}#len"] = _strings(rng, n, w, tie_every=4)
    return cols, rng.random(n) >= invalid


@pytest.fixture(scope="module")
def jcomms():
    return {n: jcomm.make_communicator("tpu", n_ranks=n) for n in (4, 8)}


# -- the partition's within-bucket order ----------------------------------


@pytest.mark.parametrize("invalid", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_order_within_matches_jax(invalid, dtype):
    """order, offsets and counts bit for bit, with many tied lengths
    (the row index breaks ties) and invalid rows after every bucket."""
    rng = np.random.default_rng(3)
    n = 3000
    cols = {"key": rng.integers(0, 500, n).astype(np.int64),
            "len": (rng.integers(0, 9, n) * 4).astype(dtype)}
    valid = rng.random(n) >= invalid
    want = jpart.radix_hash_partition(_jtable(cols, valid), ["key"], 12,
                                      order_within="len")
    got = tpart.radix_hash_partition(_ttable(cols, valid), ["key"], 12,
                                     order_within="len")
    for f in ("order", "offsets", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)
    # ties really occur inside buckets
    assert len(np.unique(cols["len"])) < 10


@pytest.mark.parametrize("case", ["sub_buckets", "two_d", "float"])
def test_order_within_refusals_match_jax(case):
    n = 16
    cols = {"key": np.arange(n, dtype=np.int64),
            "f": np.linspace(0, 1, n),
            "b": np.zeros((n, 4), np.uint8)}
    name, kw, exc = {"sub_buckets": ("key", dict(sub_buckets=2), ValueError),
                     "two_d": ("b", {}, TypeError),
                     "float": ("f", {}, TypeError)}[case]
    valid = np.ones(n, bool)
    with pytest.raises(exc):
        jpart.radix_hash_partition(_jtable(cols, valid), ["key"], 2,
                                   order_within=name, **kw)
    with pytest.raises(exc, match="order_within|sub_buckets"):
        tpart.radix_hash_partition(_ttable(cols, valid), ["key"], 2,
                                   order_within=name, **kw)


# -- the ragged plan -----------------------------------------------------


def _plan_counts(n, rng, hot=False):
    counts = rng.integers(0, 40, (n, n)).astype(np.int32)
    if hot:
        counts[1, 2] = 300  # one bucket above any per-bucket capacity
    return counts


@pytest.mark.parametrize("case", ["fits", "clamp", "flag_only"])
@pytest.mark.parametrize("n", [4, 8])
def test_ragged_plan_matches_jax(jcomms, n, case):
    """send and receive sizes, output offsets, total and flag of every
    rank: with a clamp (the pooled buffer too small), and with a
    bucket over ``capacity_per_bucket`` that clamps nothing."""
    rng = np.random.default_rng(n)
    counts = _plan_counts(n, rng, hot=case == "flag_only")
    out_cap, cpb = {"fits": (40 * n, None), "clamp": (50, None),
                    "flag_only": (40 * n + 300, 64)}[case]
    jc = jcomms[n]

    def jstep(c):
        s, r, o, t, f = jshuffle.ragged_plan(jc, c, out_cap, cpb)
        return s, r, o, t[None], f[None]

    want = jc.spmd(jstep)(jnp.asarray(counts.reshape(-1)))
    emu = EmulatedCommunicator(n)

    def tstep(c):
        s, r, o, t, f = tshuffle.ragged_plan(emu, c, out_cap, cpb)
        return s, r, o, t[None], f[None]

    got = emu.spmd(tstep)(torch.from_numpy(counts.reshape(-1)))
    for g, w, f in zip(got, want, ("send", "recv", "offsets", "total",
                                   "overflow")):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f)
    flags = _np(got[4])
    if case == "fits":
        assert not flags.any()
    else:
        assert flags.any()
    if case == "flag_only":
        # nothing was clamped: every rank receives all its rows
        np.testing.assert_array_equal(_np(got[3]), counts.sum(0))


# -- the exact-size shuffle ----------------------------------------------


def _ragged_both(jc, n, cols, valid, out_cap, varwidth=None,
                 order_within=None, cpb=None, nb=None, bucket_start=0):
    nb = nb or n
    names = list(cols)

    def jstep(t):
        pt = jpart.radix_hash_partition(t, ["key"], nb,
                                        order_within=order_within)
        got, ovf = jshuffle.shuffle_ragged(
            jc, pt, out_cap, bucket_start=bucket_start,
            capacity_per_bucket=cpb, varwidth=varwidth)
        return [got.columns[k] for k in names], got.valid, ovf[None]

    want = jc.spmd(jstep)(_jtable(cols, valid))
    emu = EmulatedCommunicator(n)

    def tstep(t):
        pt = tpart.radix_hash_partition(t, ["key"], nb,
                                        order_within=order_within)
        got, ovf = tshuffle.shuffle_ragged(
            emu, pt, out_cap, bucket_start=bucket_start,
            capacity_per_bucket=cpb, varwidth=varwidth)
        return [got.columns[k] for k in names], got.valid, ovf[None]

    got = emu.spmd(tstep)(_ttable(cols, valid))
    return names, got, want, emu


def _assert_blocks_equal(names, got, want):
    for k, g, w in zip(names, got[0], want[0]):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=k)
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))


@pytest.mark.parametrize("out_cap", [1024, 96])
@pytest.mark.parametrize("n", [4, 8])
def test_shuffle_ragged_matches_jax(jcomms, n, out_cap):
    """The received buffer of every rank, position by position (the
    valid prefix in sender order, zeros after it), and the overflow
    flag: with room, and with a clamp at 96 rows a rank."""
    rng = np.random.default_rng(10 + n)
    rows = 2048
    cols = {"key": rng.integers(0, 700, rows).astype(np.int64),
            "v": rng.integers(-(1 << 40), 1 << 40, rows),
            "w": rng.integers(-5, 5, rows).astype(np.int32)}
    valid = rng.random(rows) >= 0.1
    names, got, want, _ = _ragged_both(jcomms[n], n, cols, valid, out_cap)
    _assert_blocks_equal(names, got, want)
    assert _np(got[2]).any() == (out_cap == 96)


def test_shuffle_ragged_batch_of_an_over_decomposed_partition(jcomms):
    """The second of two batches (buckets [4, 8) of 8): the batch's
    input offsets start past the first batch's rows."""
    rng = np.random.default_rng(5)
    cols = {"key": rng.integers(0, 900, 2048).astype(np.int64),
            "v": rng.integers(0, 1 << 30, 2048)}
    names, got, want, emu = _ragged_both(
        jcomms[4], 4, cols, np.ones(2048, bool), 1024, nb=8,
        bucket_start=4, cpb=128)
    _assert_blocks_equal(names, got, want)
    assert emu.host_reads == 4  # one bucket-matrix read a rank


@pytest.mark.parametrize("widths", [(12,), (20, 12)])
@pytest.mark.parametrize("n", [4, 8])
def test_varwidth_wire_matches_jax(jcomms, n, widths):
    """The byte-exact string wire with one and with two string columns:
    every received byte, the lengths and the rows, against the JAX
    package's plane exchange (the second column length-sorted on the
    sender and un-sorted on the receiver, over tied lengths)."""
    rng = np.random.default_rng(20 + n + len(widths))
    cols, valid = _string_table(rng, 2048, 600, widths, invalid=0.05)
    vw = tuple(f"s{i}" for i in range(len(widths)))
    names, got, want, emu = _ragged_both(
        jcomms[n], n, cols, valid, 1024, varwidth=vw,
        order_within="s0#len")
    _assert_blocks_equal(names, got, want)
    assert not _np(got[2]).any()
    # the bucket matrix and every string column's plane counts in one
    # read a rank
    assert emu.host_reads == n
    # and it is the padded wire's rows: received bytes zero past len
    tv = _np(got[1])
    for i in range(len(widths)):
        b, ln = _np(got[0][names.index(f"s{i}")]), _np(
            got[0][names.index(f"s{i}#len")])
        assert not b[tv][np.arange(b.shape[1])[None, :]
                         >= ln[tv][:, None]].any()


def test_multi_varwidth_overflow_zeroes_extra_columns_only_on_clamp(jcomms):
    """The JAX test of the same name on the port, and against JAX: an
    actual clamp delivers the second string column all zero with the
    flag up; a flag-only ``capacity_per_bucket`` trip leaves it as the
    unclamped run delivers it."""
    rng = np.random.default_rng(31)
    cols, valid = _string_table(rng, 2048, 512, (20, 12))
    n = 8

    def run(out_cap, cpb=None):
        return _ragged_both(jcomms[n], n, cols, valid, out_cap,
                            varwidth=("s0", "s1"), order_within="s0#len",
                            cpb=cpb)

    names, got, want, _ = run(64)
    _assert_blocks_equal(names, got, want)
    assert _np(got[2]).any()
    assert not _np(got[0][names.index("s1")]).any()
    _, base, _, _ = run(2048)
    names, cons, cwant, _ = run(2048, cpb=2)
    _assert_blocks_equal(names, cons, cwant)
    assert not _np(base[2]).any() and _np(cons[2]).any()
    i = names.index("s1")
    np.testing.assert_array_equal(_np(base[0][i]), _np(cons[0][i]))
    assert _np(base[0][i])[_np(base[1])].any()


# -- the codec -------------------------------------------------------------


def _codec_input(case, dtype, n, bits, rng):
    big = np.iinfo(dtype)
    if case == "random":
        base = int(rng.integers(big.min // 4, big.max // 4))
        x = base + rng.integers(0, 1 << min(bits, 30), n)
    elif case == "negative":
        x = -(np.arange(n) * 3 + (1 << 20)) - rng.integers(0, 4, n)
    elif case == "constant":
        x = np.full(n, big.min + 7)
    elif case == "near_max":
        x = big.max - rng.integers(0, 1 << 12, n)
    else:  # full range: spans reach past 2^(width - 1)
        x = rng.integers(big.min, big.max, n, endpoint=True)
    return np.asarray(x).astype(dtype)


@pytest.mark.parametrize("case", ["random", "negative", "constant",
                                  "near_max", "full_range"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("bits", [2, 4, 8, 16, 32])
def test_bitpack_matches_jax(bits, dtype, case):
    """words (as uint32 bits), frames, overflow, required_bits and the
    decoded values bit for bit, on 1000 values (not a block multiple:
    the tail pads with the last value)."""
    rng = np.random.default_rng(bits * 7 + len(case))
    x = _codec_input(case, dtype, 1000, bits, rng)
    want = jcodec.for_bitpack_encode(jnp.asarray(x), bits, block=256)
    got = tcodec.for_bitpack_encode(torch.from_numpy(x), bits, block=256)
    np.testing.assert_array_equal(_np(got.words).view(np.uint32),
                                  np.asarray(want.words))
    np.testing.assert_array_equal(_np(got.frames), np.asarray(want.frames))
    assert bool(got.overflow) == bool(want.overflow)
    assert int(got.required_bits) == int(want.required_bits)
    dt = jnp.int32 if dtype == np.int32 else jnp.int64
    np.testing.assert_array_equal(
        _np(tcodec.for_bitpack_decode(got, torch.from_numpy(x).dtype)),
        np.asarray(jcodec.for_bitpack_decode(want, dt)))
    assert tcodec.wire_bytes(got) == jcodec.wire_bytes(want)
    if not bool(got.overflow):
        np.testing.assert_array_equal(
            _np(tcodec.for_bitpack_decode(got, torch.from_numpy(x).dtype)),
            x)


def test_bitpack_full_int64_span_needs_64_bits():
    x = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max] * 16)
    got = tcodec.for_bitpack_encode(torch.from_numpy(x), 32, block=32)
    want = jcodec.for_bitpack_encode(jnp.asarray(x), 32, block=32)
    assert int(got.required_bits) == int(want.required_bits) == 64
    assert bool(got.overflow) and bool(want.overflow)
    with pytest.raises(ValueError, match="bits"):
        tcodec.for_bitpack_encode(torch.from_numpy(x), 12)


# -- the compressed padded shuffle and ppermute ----------------------------


@pytest.mark.parametrize("via", ["all_to_all", "ppermute"])
@pytest.mark.parametrize("bits", [4, 16, 32])
def test_shuffle_padded_compressed_matches_jax(jcomms, bits, via):
    """The received blocks and counts, and the codec's flag, with a
    string column and a packed string-key word column riding raw."""
    n, cap = 4, 200
    rng = np.random.default_rng(bits)
    rows = 2048
    cols = {"key": rng.integers(0, 1000, rows).astype(np.int64),
            "small": rng.integers(0, 12, rows).astype(np.int32),
            "__sk0w0": rng.integers(-(1 << 62), 1 << 62, rows),
            "s": rng.integers(0, 256, (rows, 8)).astype(np.uint8)}
    valid = rng.random(rows) >= 0.1
    names = list(cols)
    jc = jcomms[n]

    def jstep(t):
        pt = jpart.radix_hash_partition(t, ["key"], n)
        padded, counts, _, _ = pt.to_padded(cap)
        got, rc, ovf = jshuffle.shuffle_padded_compressed(
            jc, padded, counts, cap, bits, via=via)
        return [got.columns[k] for k in names], got.valid, rc, ovf[None]

    want = jc.spmd(jstep)(_jtable(cols, valid))
    emu = EmulatedCommunicator(n)

    def tstep(t):
        pt = tpart.radix_hash_partition(t, ["key"], n)
        padded, counts, _, _ = pt.to_padded(cap)
        got, rc, ovf = tshuffle.shuffle_padded_compressed(
            emu, padded, counts, cap, bits, via=via)
        return [got.columns[k] for k in names], got.valid, rc, ovf[None]

    got = emu.spmd(tstep)(_ttable(cols, valid))
    for k, g, w in zip(names, got[0], want[0]):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(g), _np(w))
    # keys below 1000 pack in 16 bits, not in 4; the word column rides raw
    assert _np(got[3]).any() == (bits == 4)
    word_col = torch.zeros(2, 2, dtype=torch.int64)
    assert not tshuffle._codec_eligible("__sk0w0", word_col)


@pytest.mark.parametrize("n", [4, 8])
def test_ppermute_all_to_all_equals_all_to_all(jcomms, n):
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 60), 1 << 60, (n * n * 3, 2))
    emu = EmulatedCommunicator(n)
    got = emu.spmd(lambda t: emu.ppermute_all_to_all(t))(torch.from_numpy(x))
    want = emu.spmd(lambda t: emu.all_to_all(t))(torch.from_numpy(x))
    assert torch.equal(got, want)
    jc = jcomms[n]
    jwant = jc.spmd(lambda t: jc.ppermute_all_to_all(
        t.reshape(n, 3, 2)).reshape(-1, 2))(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


# -- plan validation --------------------------------------------------------


def test_plan_validation_flags_a_hand_made_inconsistent_plan(jcomms):
    """Rank 2 believes it receives one row more from rank 0 than rank 0
    sends: both packages record the violation and return the token 1 on
    every rank; the consistent plan returns 0 and records nothing."""
    n = 4
    counts = np.full((n, n), 3, np.int32)
    send = counts.copy()
    recv = counts.T.copy()
    offs = np.cumsum(counts, axis=0) - counts   # offs[j, i]: j's start on i
    bad_recv = recv.copy()
    bad_recv[2, 0] += 1

    def run(recv_m):
        jc = jcomms[n]
        want = jc.spmd(lambda s, r, o: jfaults.validate_ragged_plan(
            jc, s, r, o, 64)[None])(
            *(jnp.asarray(a.reshape(-1)) for a in (send, recv_m, offs)))
        emu = EmulatedCommunicator(n)
        got = emu.spmd(lambda s, r, o: tfaults.validate_ragged_plan(
            emu, s, r, o, 64)[None])(
            *(torch.from_numpy(a.reshape(-1).copy())
              for a in (send, recv_m, offs)))
        return _np(got), np.asarray(want)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = run(recv)
        np.testing.assert_array_equal(got, want)
        assert not got.any()
        tfaults.check_plan_violations()
        got, want = run(bad_recv)
    np.testing.assert_array_equal(got, want)
    assert got.all()
    assert tfaults.plan_violations()
    with pytest.raises(tfaults.PlanValidationError,
                       match="ragged plan inconsistent"):
        tfaults.check_plan_violations()
    tfaults.check_plan_violations()  # cleared by the raise
    jfaults.clear_plan_violations()


def test_plan_validation_switch_and_clean_ragged_join(monkeypatch):
    assert not tfaults.plan_validation_enabled()
    monkeypatch.setenv("DJTPU_VALIDATE_PLANS", "1")
    assert tfaults.plan_validation_enabled()
    with tfaults.validate_plans(False):
        assert not tfaults.plan_validation_enabled()
    rng = np.random.default_rng(2)
    cols = {"key": rng.integers(0, 300, 512),
            "v": rng.integers(0, 9, 512)}
    t = _ttable(cols, np.ones(512, bool))
    u = _ttable({"key": cols["key"], "w": cols["v"]}, np.ones(512, bool))
    res = tdist.distributed_inner_join(t, u, EmulatedCommunicator(4),
                                       shuffle="ragged",
                                       out_capacity_factor=4.0)
    assert not bool(res.overflow) and not tfaults.plan_violations()


# -- the ladder's compression rung ------------------------------------------


def test_ladder_widens_bits_before_capacities_like_jax():
    kw = dict(shuffle_capacity_factor=1.6, out_capacity_factor=1.2,
              compression_bits=2, skew=True, hh_build_capacity=2048,
              hh_probe_capacity=1024, hh_out_capacity=1024,
              local_probe_rows=4096)
    want = jfaults.CapacityLadder(**kw)
    got = tfaults.CapacityLadder(**kw)
    actions = []
    for _ in range(6):
        for lad in (want, got):
            lad.note(True)
        a = got.escalate()
        assert a == want.escalate()
        actions.append(a)
        assert got.sizing() == want.sizing()
    assert actions == ["widen_compression_bits"] * 4 + [
        "double_capacities"] * 2
    assert [{f: getattr(a, f) for f in LADDER_FIELDS}
            for a in got.report().attempts] == [
        {f: getattr(a, f) for f in LADDER_FIELDS}
        for a in want.report().attempts]


# -- the distributed join in each mode --------------------------------------

JOIN_MODES = {
    "padded": dict(),
    "ragged": dict(shuffle="ragged"),
    "ppermute": dict(shuffle="ppermute"),
    "compressed": dict(compression_bits=16),
    "compressed_ppermute": dict(shuffle="ppermute", compression_bits=32),
    # 2 bits overflow on the 14-bit payloads: the ladder widens to 16
    "compressed_ladder": dict(compression_bits=2, auto_retry=5),
}


def _join_rows(cols, valid, names):
    valid = np.asarray(valid)
    parts = []
    for k in names:
        a = _np(cols[k])[valid]
        parts.append(a.reshape(a.shape[0], -1).astype(np.int64))
    a = np.concatenate(parts, axis=1)
    return a[np.lexsort(a.T[::-1])]


def _join_both(jc, n, bcols, bvalid, pcols, pvalid, key, opts):
    want = jdist.distributed_inner_join(_jtable(bcols, bvalid),
                                        _jtable(pcols, pvalid), jc,
                                        key=key, **opts)
    got = tdist.distributed_inner_join(_ttable(bcols, bvalid),
                                       _ttable(pcols, pvalid),
                                       EmulatedCommunicator(n), key=key,
                                       **opts)
    assert bool(got.overflow) == bool(want.overflow)
    assert int(got.total) == int(want.total) > 0
    assert [{f: getattr(a, f) for f in LADDER_FIELDS}
            for a in got.retry_report.attempts] == [
        {f: getattr(a, f) for f in LADDER_FIELDS}
        for a in want.retry_report.attempts]
    names = sorted(got.table.columns)
    assert names == sorted(want.table.columns)
    np.testing.assert_array_equal(
        _join_rows(got.table.columns, _np(got.table.valid), names),
        _join_rows(want.table.columns, want.table.valid, names))
    return got, want


@pytest.mark.parametrize("mode", sorted(JOIN_MODES))
def test_distributed_join_mode_matches_jax(jcomms, mode):
    rng = np.random.default_rng(40)
    bn, pn = 2048, 4096
    bcols = {"key": rng.integers(0, 1500, bn),
             "build_payload": rng.integers(-(1 << 13), 1 << 13, bn)}
    pcols = {"key": rng.integers(0, 1500, pn),
             "probe_payload": rng.integers(0, 1 << 14, pn)}
    opts = dict(JOIN_MODES[mode], over_decomposition=2,
                out_capacity_factor=3.0)
    got, _ = _join_both(jcomms[4], 4, bcols, rng.random(bn) >= 0.05,
                        pcols, rng.random(pn) >= 0.05, "key", opts)
    assert not bool(got.overflow)
    if mode == "compressed_ladder":
        acts = [a.action for a in got.retry_report.attempts]
        assert acts == ["initial"] + ["widen_compression_bits"] * 3


@pytest.mark.parametrize("mode", ["ragged", "compressed"])
def test_skew_join_light_rows_ride_the_wire_like_jax(jcomms, mode):
    """The skew sidecar with each wire: heavy keys stay local, the
    light rows ride the chosen wire; one retry relieves the HH blocks."""
    rng = np.random.default_rng(9)
    u = rng.uniform(1e-12, 1.0, 8192)
    pk = np.clip(np.minimum(u ** (-2.0), 2048).astype(np.int64) - 1, 0, 2047)
    bcols = {"key": np.arange(2048, dtype=np.int64),
             "build_payload": rng.integers(0, 1 << 20, 2048)}
    pcols = {"key": pk, "probe_payload": np.arange(8192)}
    opts = dict(JOIN_MODES[mode], skew_threshold=0.05, hh_slots=32,
                auto_retry=2, out_capacity_factor=2.0)
    got, _ = _join_both(jcomms[4], 4, bcols, np.ones(2048, bool), pcols,
                        np.ones(8192, bool), "key", opts)
    assert not bool(got.overflow)


@pytest.mark.parametrize("mode", ["ragged", "ppermute", "compressed"])
def test_config5_like_string_join_matches_jax(jcomms, mode):
    """Config 5's shape at a small size: a 2-column composite key, two
    variable-length string payloads on the build side and one on the
    probe side (the ragged wire ships all three byte-exactly)."""
    rng = np.random.default_rng(50)
    bn, pn = 1024, 2048
    k1b, k1p = rng.integers(0, 40, bn), rng.integers(0, 40, pn)
    k2b, k2p = rng.integers(0, 30, bn), rng.integers(0, 30, pn)
    bcols = {"k1": k1b, "k2": k2b}
    bcols["s"], bcols["s#len"] = _strings(rng, bn, 16, tie_every=4)
    bcols["t"], bcols["t#len"] = _strings(rng, bn, 8)
    pcols = {"k1": k1p, "k2": k2p, "pp": rng.integers(0, 1 << 12, pn)}
    pcols["u"], pcols["u#len"] = _strings(rng, pn, 12, tie_every=4)
    opts = dict(JOIN_MODES[mode], out_capacity_factor=6.0,
                shuffle_capacity_factor=2.5)
    got, _ = _join_both(jcomms[4], 4, bcols, np.ones(bn, bool), pcols,
                        np.ones(pn, bool), ["k1", "k2"], opts)
    assert not bool(got.overflow)


def test_string_key_join_on_the_ragged_wire_matches_jax(jcomms):
    """A string key (packed into word columns before hashing) with a
    string payload: the key's words ride the row exchange, the payload
    the byte-exact wire."""
    rng = np.random.default_rng(60)
    bn, pn = 1024, 2048
    ids_b, ids_p = rng.integers(0, 300, bn), rng.integers(0, 300, pn)

    def key_bytes(ids):
        txt = np.zeros((len(ids), 12), np.uint8)
        for i, v in enumerate(ids):
            b = f"k-{v}".encode()
            txt[i, :len(b)] = np.frombuffer(b, np.uint8)
        return txt, np.array([len(f"k-{v}") for v in ids], np.int32)

    bcols, pcols = {}, {}
    bcols["sk"], bcols["sk#len"] = key_bytes(ids_b)
    pcols["sk"], pcols["sk#len"] = key_bytes(ids_p)
    bcols["s"], bcols["s#len"] = _strings(rng, bn, 8, tie_every=2)
    pcols["pp"] = rng.integers(0, 99, pn)
    _join_both(jcomms[4], 4, bcols, np.ones(bn, bool), pcols,
               np.ones(pn, bool), "sk",
               dict(shuffle="ragged", out_capacity_factor=6.0))


# -- refusals ---------------------------------------------------------------


@pytest.mark.parametrize("opts,exc,match", [
    (dict(shuffle="ragged", compression_bits=16), ValueError,
     "compression applies"),
    (dict(shuffle="bogus"), ValueError, "unknown shuffle mode"),
    (dict(shuffle="hierarchical", dcn_codec="bogus"), ValueError,
     "dcn_codec"),
    (dict(sort_mode="bogus"), ValueError, "sort_mode"),
    # the step's switch; the one-shot join sets it from verify_integrity
    (dict(with_integrity=True), TypeError, "with_integrity"),
])
def test_join_refusals(opts, exc, match):
    t = _ttable({"key": np.arange(8), "a": np.arange(8)}, np.ones(8, bool))
    u = _ttable({"key": np.arange(8), "b": np.arange(8)}, np.ones(8, bool))
    with pytest.raises(exc, match=match):
        tdist.distributed_inner_join(t, u, LocalCommunicator(), **opts)
    if exc in (ValueError, TypeError):
        # the JAX package refuses the same options the same way
        jt = _jtable({"key": np.arange(8), "a": np.arange(8)},
                     np.ones(8, bool))
        ju = _jtable({"key": np.arange(8), "b": np.arange(8)},
                     np.ones(8, bool))
        with pytest.raises(exc, match=match):
            jdist.distributed_inner_join(
                jt, ju, jcomm.make_communicator("local"), **opts)


# -- the config driver ------------------------------------------------------

DRIVER_BASE = ["--build-table-nrows", "4000", "--probe-table-nrows", "4000",
               "--iterations", "1", "--over-decomposition-factor", "2"]


@pytest.mark.parametrize("flags", [
    ["--shuffle", "ragged", "--key-columns", "2", "--string-payload-bytes",
     "16", "--variable-length-strings"],
    ["--key-columns", "2", "--string-payload-bytes", "16"],
    ["--shuffle", "ppermute", "--compression", "--compression-bits", "32"],
    ["--compression", "--compression-bits", "4", "--auto-retry", "3"],
], ids=["ragged_strings", "padded_strings", "ppermute_compressed",
        "compressed_ladder"])
def test_driver_record_matches_jax_driver(flags):
    """The wire fields of the driver's record (``shuffle``,
    ``compression_bits``, ``byte_exact_on_wire`` and the string columns
    it accounts), the flag and the ladder's actions and bits, against
    the JAX driver's record for the same flags. (The two drivers draw
    their tables from different generators, so matches differ.)"""
    from distributed_join_tpu.benchmarks import distributed_join as jdriver
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    want = jdriver.run(jdriver.parse_args(
        ["--communicator", "tpu", "--n-ranks", "4", *DRIVER_BASE, *flags]))
    got = tdriver.run(tdriver.parse_args(
        ["--communicator", "emulated", "--n-ranks", "4", *DRIVER_BASE,
         *flags]), device="cpu")
    for f in ("shuffle", "compression_bits", "overflow"):
        assert got[f] == want[f], f
    assert not got["overflow"]
    sw, jw = got["string_wire_bytes"], want["string_wire_bytes"]
    assert (sw is None) == (jw is None)
    if sw is not None:
        assert sw["byte_exact_on_wire"] == jw["byte_exact_on_wire"] == (
            got["shuffle"] == "ragged")
        assert sorted(sw["columns"]) == sorted(jw["columns"])

    def rungs(rec):
        return [(a["action"], a["compression_bits"])
                for a in (rec["retry"] or {}).get("attempts", [])]

    assert rungs(got) == rungs(want)
    if "--auto-retry" in flags:
        assert rungs(got)[1] == ("widen_compression_bits", 8)
    if got["shuffle"] == "ragged":
        # both sides' bucket matrices and the build side's plane counts
        # in one read, whatever the batches
        assert got["host_reads_per_join"] == 1
        assert got["wire_rows_per_join"] == 2 * 4000 / 4
    else:
        assert got["host_reads_per_join"] == 0


@pytest.mark.parametrize("argv,match", [
    (["--agg-ab", "2"], None),
    (["--resident-ab", "2"], None),
    (["--expand-kernel", "xla"], "--expand-kernel"),
    (["--explain"], None),
])
def test_driver_refuses_what_the_port_lacks(argv, match, capsys, tmp_path,
                                            monkeypatch):
    """The JAX driver's flags the port lacks refuse by name; ``--agg-ab``,
    ``--resident-ab`` and ``--explain`` (``match`` None) are ported: on 4
    emulated ranks over the ragged wire the record holds both sides of
    the aggregate A/B, each equal to the numpy oracle, or of the resident
    A/B, with equal matches and row digests, or the plan's summary (the
    ragged wire's bytes an estimate) beside its ``explain.json``.
    ``--expand-kernel`` is ported too (its JAX names onto
    ``KernelConfig.expand``, the plain formulation's matches equal to the
    kernel pipeline's on the ragged wire), and ``--compact-kernel``, a
    TPU mechanism, refuses in its place."""
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    monkeypatch.chdir(tmp_path)
    if match is None:
        rec = tdriver.run(tdriver.parse_args(argv + [
            "--communicator", "emulated", "--n-ranks", "4", "--shuffle",
            "ragged", "--build-table-nrows", "4000", "--probe-table-nrows",
            "4000", "--iterations", "1"]), device="cpu")
        if argv[0] == "--explain":
            exp = rec["explain"]
            assert exp["wire_exact"] is False and exp["predicted_wall_s"] > 0
            doc = json.load(open(tmp_path / "explain.json"))
            assert doc["plan"]["signature_digest"] == exp["plan_digest"]
            return
        if argv[0] == "--resident-ab":
            ab = rec["resident_ab"]
            assert ab["n_joins"] == 2 and ab["warm_probe_new_traces"] == 0
            assert ab["matches_equal"] and ab["digest_equal"]
            assert ab["matches_probe_only"] == rec["matches_per_join"] > 0
            assert ab["resident"]["rows"] == 4000 and not ab["overflow"]
            assert rec["agg_ab"] is None
            return
        ab = rec["agg_ab"]
        assert ab["kind"] == "agg_ab" and ab["n_joins"] == 2
        assert ab["oracle_equal_pushdown"] and ab["oracle_equal_materialize"]
        assert ab["matches"] == rec["matches_per_join"] > 0
        assert 0 < ab["groups"] <= ab["matches"] and not ab["overflow"]
        assert [a[0] for a in ab["spec"]["aggs"]] == ["count", "sum", "sum"]
        assert len(ab["materialize_walls_s"]) == len(ab["pushdown_walls_s"]) \
            == 2
        return
    if argv[0] == "--expand-kernel":
        recs = [tdriver.run(tdriver.parse_args(
            ["--expand-kernel", flag, "--communicator", "emulated",
             "--n-ranks", "4", "--shuffle", "ragged", "--build-table-nrows",
             "4000", "--probe-table-nrows", "4000", "--iterations", "1"]),
            device="cpu") for flag in ("xla", "pallas")]
        assert [r["expand_kernel"] for r in recs] == ["plain", "kernel"]
        assert recs[0]["matches_per_join"] == recs[1]["matches_per_join"] > 0
        argv, match = ["--compact-kernel", "mxu"], "--compact-kernel"
    with pytest.raises(SystemExit):
        tdriver.parse_args(argv)
    assert match in capsys.readouterr().err


def test_driver_accepts_and_ignores_registration_method():
    """A JAX command line carrying ``--registration-method`` (the
    reference CLI's RDMA flag, which the JAX driver accepts and ignores)
    parses on the port's driver too, and changes nothing."""
    from distributed_join_tpu.benchmarks import distributed_join as jdriver
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    flag = ["--registration-method", "buffer"]
    assert jdriver.parse_args(flag).registration_method == "buffer"
    assert tdriver.parse_args(flag).registration_method == "buffer"
    assert "--registration-method" not in tdriver._REFUSED
    argv = ["--communicator", "emulated", "--n-ranks", "2", *DRIVER_BASE]
    plain = tdriver.run(tdriver.parse_args(argv), device="cpu")
    got = tdriver.run(tdriver.parse_args(argv + flag), device="cpu")
    assert got["matches_per_join"] == plain["matches_per_join"] > 0
    assert not got["overflow"]


def test_driver_refuses_compression_on_the_ragged_wire():
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    with pytest.raises(SystemExit, match="ragged"):
        tdriver.run(tdriver.parse_args(
            ["--communicator", "emulated", "--n-ranks", "2", *DRIVER_BASE,
             "--shuffle", "ragged", "--compression"]), device="cpu")
    with pytest.raises(SystemExit, match="multiple of 4"):
        tdriver.run(tdriver.parse_args(
            ["--communicator", "emulated", "--n-ranks", "2", *DRIVER_BASE,
             "--shuffle", "ragged", "--string-payload-bytes", "10"]),
            device="cpu")


@pytest.mark.parametrize("mode", [None, "flat", "segmented", "auto"])
def test_all_to_all_driver_sort_mode_guard_matches_jax(mode, capsys):
    """The all-to-all benchmark takes ``--sort-mode flat`` and
    ``--sort-segments`` as the JAX benchmark does, refuses any other
    sort mode with its message, and takes ``--n-ranks``."""
    from distributed_join_tpu.benchmarks import all_to_all as ja2a
    from distributed_join_tpu_torch.benchmarks import all_to_all as ta2a
    argv = ["--sort-segments", "4", "--n-ranks", "2"] + (
        ["--sort-mode", mode] if mode else [])
    targs, jargs = ta2a.parse_args(argv), ja2a.parse_args(argv)
    for f in ("sort_mode", "sort_segments", "n_ranks"):
        assert getattr(targs, f) == getattr(jargs, f)
    if mode in (None, "flat"):
        # past the guard: a two-rank exchange needs the process group
        with pytest.raises(SystemExit, match="--n-ranks 2"):
            ta2a.run(targs, device="cpu")
        return
    with pytest.raises(SystemExit) as got:
        ta2a.run(targs, device="cpu")
    with pytest.raises(SystemExit) as want:
        ja2a.run(jargs)
    assert str(got.value) == str(want.value)
    assert "no local sort" in str(got.value)


@pytest.mark.parametrize("ranks", [1, 4])
def test_driver_ab_passes_build_no_warm_program(ranks):
    """``--agg-ab`` and ``--sort-ab`` take their programs from a program
    cache, as the JAX driver's do (JAX ``benchmarks/distributed_join.py``
    :844, :962): one build a program on the warm-up, none on the timed
    passes, so ``warm_pushdown_new_traces`` and ``warm_new_traces`` are
    the JAX driver's 0 (its own passes also run a metrics program, which
    raises on the installed jax, so the count is held to that value).
    The records' counter signatures come from the port's own untimed
    metrics pass."""
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    comm = (["--communicator", "local"] if ranks == 1 else
            ["--communicator", "emulated", "--n-ranks", str(ranks)])
    rec = tdriver.run(tdriver.parse_args(
        [*comm, "--build-table-nrows", "8000", "--probe-table-nrows",
         "8000", "--iterations", "1", "--over-decomposition-factor", "2",
         "--agg-ab", "2", "--sort-ab", "2", "--sort-segments", "2"]),
        device="cpu")
    agg, srt = rec["agg_ab"], rec["sort_ab"]
    assert agg["warm_pushdown_new_traces"] == 0
    assert agg["counter_signature"]["counters"]["matches"] == agg["matches"]
    assert agg["oracle_equal_pushdown"] and agg["matches"] > 0
    assert srt["warm_new_traces"] == 0 and srt["digest_equal"]
    assert srt["counter_signature"]["counters"]["matches"] == srt["matches"]
    assert srt["wire_exact"] is True

