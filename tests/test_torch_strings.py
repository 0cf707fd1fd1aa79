"""PyTorch port vs the JAX package: fixed-width string columns
(``utils/strings.py``) byte for byte, string-key joins, and the emulated
4-rank join with a composite key, a string payload and a string key, on
the CPU. Inputs come from numpy with a seed and reach both packages as
numpy arrays; join rows are compared as exact sorted multisets."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils import strings as js
from distributed_join_tpu_torch.ops import join as tjoin
from distributed_join_tpu_torch.ops import partition as tpart
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils import strings as ts

WIDTHS = [1, 7, 8, 9, 16, 33]
MODES = ["kernel", "plain"]


def _rows(cols, valid, names) -> np.ndarray:
    """Valid rows as a lexicographically sorted int64 array: 2-D columns
    one int64 column a byte, floats by their float64 bits."""
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


def _texts(rng, n, width, full):
    """ASCII strings of exactly ``width`` bytes (``full``) or of
    0..width bytes (interior lengths)."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789-",
                             dtype=np.uint8)
    lens = (np.full(n, width) if full
            else rng.integers(0, width + 1, n))
    return [bytes(rng.choice(alphabet, k)).decode() for k in lens]


# -- the helpers, byte for byte -----------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_encode_decode_strings_match_jax(width):
    rng = np.random.default_rng(width)
    for full in (True, False):
        vals = _texts(rng, 50, width, full)
        jb, jl = js.encode_strings(vals, width)
        tb, tl = ts.encode_strings(vals, width, device="cpu")
        assert tb.dtype == torch.uint8 and tl.dtype == torch.int32
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        for lens in (None, tl):
            want = js.decode_strings(np.asarray(jb),
                                     None if lens is None else np.asarray(jl))
            assert ts.decode_strings(tb, lens) == want
            assert want == vals
    with pytest.raises(ValueError, match="max_len"):
        ts.encode_strings(["x" * (width + 1)], width, device="cpu")


# (prefix, digits) for each byte width
INT_WIDTHS = {1: ("", 1), 7: ("itm-", 3), 8: ("itm-", 4), 9: ("", 9),
              16: ("itm-", 12), 33: ("order-line-item-", 17)}


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_encode_int_strings_matches_jax(width, pad):
    prefix, digits = INT_WIDTHS[width]
    rng = np.random.default_rng(width + 100 * pad)
    top = 10**digits
    ids = np.concatenate([[0, top - 1, 1, 9, 10],
                          [10**k for k in range(1, digits)],
                          rng.integers(0, top, 64)]).astype(np.int64)
    ids = ids[ids < top]
    jb, jl = js.encode_int_strings(ids, prefix=prefix, digits=digits,
                                   pad_digits=pad)
    tb, tl = ts.encode_int_strings(torch.from_numpy(ids), prefix=prefix,
                                   digits=digits, pad_digits=pad)
    assert tb.shape == (ids.shape[0], width)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for bad in ([top], [-1]):
        for enc, arr in ((js.encode_int_strings, np.array(bad)),
                         (ts.encode_int_strings, torch.tensor(bad))):
            with pytest.raises(ValueError):
                enc(arr, prefix=prefix, digits=digits)


def test_add_string_column_matches_jax():
    vals = ["", "a", "héllo", "twelve bytes"]
    jc = js.add_string_column({"k": jnp.arange(4)}, "s", vals, 16)
    tc = ts.add_string_column({"k": torch.arange(4)}, "s", vals, 16,
                              device="cpu")
    assert list(tc) == list(jc) == ["k", "s", "s" + ts.LEN_SUFFIX]
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    assert ts.LEN_SUFFIX == js.LEN_SUFFIX


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_and_unpack_string_key_match_jax(width):
    rng = np.random.default_rng(200 + width)
    b = rng.integers(0, 256, (40, width)).astype(np.uint8)
    b[::3, width // 2:] = 0           # interior lengths: zero tails
    jw = js.pack_string_key(jnp.asarray(b))
    tw = ts.pack_string_key(torch.from_numpy(b))
    assert len(tw) == len(jw) == (width + 7) // 8
    for t, j in zip(tw, jw):
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy().view(np.uint64),
                                      np.asarray(j))
    back = ts.unpack_string_key(tw, width)
    np.testing.assert_array_equal(back.numpy(), b)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(js.unpack_string_key(jw, width)))
    assert ts.string_key_word_names(2, len(tw)) == \
        js.string_key_word_names(2, len(jw))


def _string_key_tables(rng, width, nb=60, npr=80, with_len=True):
    ids_b, ids_p = rng.integers(0, 40, nb), rng.integers(0, 60, npr)
    out = []
    for ids, side, n in ((ids_b, "b", nb), (ids_p, "p", npr)):
        vals = [f"k{i}"[:width] for i in ids]
        b, ln = js.encode_strings(vals, width)
        cols = {"sk": np.asarray(b), f"{side}p": rng.integers(0, 99, n)}
        if with_len:
            cols["sk" + js.LEN_SUFFIX] = np.asarray(ln)
        out.append((cols, rng.random(n) < 0.9))
    return out


@pytest.mark.parametrize("width", WIDTHS)
def test_split_rebuild_and_prepare_match_jax(width):
    rng = np.random.default_rng(300 + width)
    (bc, bv), (pc, pv) = _string_key_tables(rng, width)
    jb, jp, tb, tp = (_jtable(bc, bv), _jtable(pc, pv), _ttable(bc, bv),
                      _ttable(pc, pv))
    jout = js.prepare_string_key_join(jb, jp, ["sk"], None, None)
    tout = ts.prepare_string_key_join(tb, tp, ["sk"], None, None)
    assert tout[2] == jout[2] and tout[3] == jout[3] and tout[4] == jout[4]
    assert tout[5] == [(k, list(w), n) for k, w, n in jout[5]]
    for t, j in ((tout[0], jout[0]), (tout[1], jout[1])):
        assert t.column_names == list(j.columns)
        for name, c in t.columns.items():
            got = c.numpy().view(np.uint64) if name.startswith("__sk") \
                else c.numpy()
            np.testing.assert_array_equal(got, np.asarray(j.columns[name]))
    # split then rebuild is the identity on the probe table
    b2, p2, keys2, spec = ts.split_string_keys(tb, tp, ["sk"])
    back = ts.rebuild_string_keys(p2, spec, ["sk"])
    jback = js.rebuild_string_keys(js.split_string_keys(jb, jp, ["sk"])[1],
                                   js.split_string_keys(jb, jp, ["sk"])[3],
                                   ["sk"])
    assert back.column_names == list(jback.columns)
    for name in back.column_names:
        np.testing.assert_array_equal(back.columns[name].numpy(),
                                      np.asarray(jback.columns[name]))
        np.testing.assert_array_equal(back.columns[name].numpy(), pc[name])


def test_string_key_refusals_match_jax():
    rng = np.random.default_rng(5)
    (bc, bv), (pc, pv) = _string_key_tables(rng, 8)
    flat = dict(pc, sk=np.arange(80))
    for mod, mk in ((js, _jtable), (ts, _ttable)):
        with pytest.raises(TypeError, match="dimensionality"):
            mod.check_key_ndim(mk(bc, bv), mk(flat, pv), ["sk"])
        narrow = dict(pc, sk=pc["sk"][:, :4])
        with pytest.raises(TypeError, match="width mismatch"):
            mod.split_string_keys(mk(bc, bv), mk(narrow, pv), ["sk"])
        wide = dict(pc, sk=pc["sk"].astype(np.int32))
        with pytest.raises(TypeError, match="uint8"):
            mod.split_string_keys(mk(bc, bv), mk(wide, pv), ["sk"])
        taken = dict(pc, __sk0w0=np.arange(80))
        with pytest.raises(ValueError, match="collides"):
            mod.split_string_keys(mk(bc, bv), mk(taken, pv), ["sk"])


# -- string-key joins ---------------------------------------------------


STRING_JOINS = {
    # (key widths, with a scalar key beside the string key)
    "alone_w8": ([8], False),
    "alone_w33": ([33], False),
    "mixed_scalar_w9": ([9], True),
    "two_string_keys_w7_w16": ([7, 16], False),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(STRING_JOINS))
def test_string_key_join_matches_jax(case, mode):
    widths, scalar = STRING_JOINS[case]
    rng = np.random.default_rng(len(case) + 7 * len(widths))
    nb, npr = 120, 150
    base_b, base_p = rng.integers(0, 30, nb), rng.integers(0, 45, npr)
    cols = []
    for base, n, side in ((base_b, nb, "b"), (base_p, npr, "p")):
        c = {}
        for i, w in enumerate(widths):
            vals = [f"{v * (i + 3)}" for v in base]
            vals = [s[-w:] for s in vals]
            b, ln = js.encode_strings(vals, w)
            c[f"s{i}"] = np.asarray(b)
            c[f"s{i}" + js.LEN_SUFFIX] = np.asarray(ln)
        if scalar:
            c["k"] = (base % 3).astype(np.int32)
        c[f"{side}p"] = rng.integers(-50, 50, n)
        c[f"{side}bytes"] = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        cols.append((c, rng.random(n) < 0.92))
    (bc, bv), (pc, pv) = cols
    keys = [f"s{i}" for i in range(len(widths))] + (["k"] if scalar else [])
    want = jjoin.sort_merge_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                       keys, 2048)
    got = tjoin.sort_merge_inner_join(_ttable(bc, bv), _ttable(pc, pv), keys,
                                      2048, kernel_config=KernelConfig(mode))
    names = list(want.table.columns)
    assert got.table.column_names == names
    assert int(got.total) == int(want.total) > 0
    assert not bool(got.overflow)
    for k in keys[:len(widths)]:
        assert got.table.columns[k].dtype == torch.uint8
    gc, gv = got.table.to_numpy()
    np.testing.assert_array_equal(
        _rows(gc, gv, names),
        _rows(want.table.columns, want.table.valid, names))


# -- the emulated 4-rank join -------------------------------------------


@pytest.fixture(scope="module")
def jcomm4():
    return jcomm.make_communicator("tpu", n_ranks=4)


def _four_rank_tables(seed):
    """A string key (16 bytes) beside an int64 key: a composite key with a
    string column; a 2-D string payload with its length on the build
    side."""
    rng = np.random.default_rng(seed)
    nb, npr = 512, 640
    base_b, base_p = rng.integers(0, 300, nb), rng.integers(0, 450, npr)
    out = []
    for base, n, side in ((base_b, nb, "build"), (base_p, npr, "probe")):
        sb, sl = js.encode_int_strings(base, prefix="itm-", digits=12)
        c = {"skey": np.asarray(sb), "skey" + js.LEN_SUFFIX: np.asarray(sl),
             "k1": base % 7, f"{side}_payload": np.arange(n)}
        if side == "build":
            tb, tl = js.encode_int_strings(np.arange(n) * 7 + 3,
                                           prefix="tag-", digits=8,
                                           pad_digits=False)
            c["build_tag"] = np.asarray(tb)
            c["build_tag" + js.LEN_SUFFIX] = np.asarray(tl)
        out.append((c, rng.random(n) < 0.95))
    return out


def test_emulated_4_rank_string_join_matches_jax(jcomm4):
    (bc, bv), (pc, pv) = _four_rank_tables(41)
    opts = dict(key=["skey", "k1"], out_capacity_factor=4.0)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jcomm4, **opts)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(4), **opts)
    # (the JAX result's columns come out of shard_map in name order)
    names = got.table.column_names
    assert names[:2] == ["skey", "k1"]
    assert sorted(names) == list(want.table.columns)
    assert not bool(want.overflow) and not bool(got.overflow)
    assert int(got.total) == int(want.total) > 0
    assert got.table.capacity == np.asarray(want.table.valid).shape[0]
    gc, gv = got.table.to_numpy()
    np.testing.assert_array_equal(
        _rows(gc, gv, names),
        _rows(want.table.columns, want.table.valid, names))


def test_to_padded_and_unpad_keep_whole_2d_rows():
    """The partition's padded layout gathers whole rows of a 2-D column,
    equal to the JAX package's, and unpad flattens them back row by
    row."""
    (bc, bv), _ = _four_rank_tables(43)
    jp = jpart.radix_hash_partition(_jtable(bc, bv), ["k1"], 4)
    tp = tpart.radix_hash_partition(_ttable(bc, bv), ["k1"], 4)
    cap = 200
    jpad, jcnt, _, _ = jp.to_padded(cap)
    tpad, tcnt, _, _ = tp.to_padded(cap)
    for name in ("build_tag", "skey"):
        assert tpad[name].shape == (4, cap, bc[name].shape[1])
        np.testing.assert_array_equal(tpad[name].numpy(),
                                      np.asarray(jpad[name]))
    back = tpart.unpad(tpad, tcnt, cap)
    assert back.columns["build_tag"].shape == (4 * cap, 12)
    order = tp.order.numpy()
    offs = tp.offsets.numpy()
    flat = back.columns["build_tag"].numpy().reshape(4, cap, -1)
    for b in range(4):
        rows = order[offs[b]:offs[b + 1]]
        np.testing.assert_array_equal(flat[b, :len(rows)],
                                      bc["build_tag"][rows])
