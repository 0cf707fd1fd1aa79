"""PyTorch port vs the JAX package: the two experimental kernels' entry
points on the CPU. B6, the merge sort (``ops/merge_sort.py`` against
``ops/sort_pallas.py``): the plane codecs bit for bit, and the sort
against ``lax.sort``, the function the JAX merge sort is a drop-in for.
B7, ``expand_pull`` against ``expand_gather_reference`` (its drop-in
contract), including repeating build ranks, where the JAX kernel is
wrong. The JAX Pallas kernels themselves are not interpreted here (their
own tests take minutes each)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax import lax

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import expand_pallas as jex
from distributed_join_tpu.ops import sort_pallas as jsort
from distributed_join_tpu_torch.ops import expand as tex
from distributed_join_tpu_torch.ops import merge_sort as tsort

I32_MAX = 2**31 - 1
TILE = 1024  # the JAX tests' tile: their sizes straddle it

NP_TO_TORCH = {np.int64: torch.int64, np.uint64: torch.uint64,
               np.int32: torch.int32, np.int16: torch.int16,
               np.int8: torch.int8, np.float32: torch.float32}


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint64:
        return torch.from_numpy(a.view(np.int64).copy()).view(torch.uint64)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint64:
        return t.view(torch.int64).numpy().view(np.uint64)
    return t.numpy()


def _plane_bits(p) -> np.ndarray:
    """A plane (a JAX uint32 array or a port int32 tensor) as uint32."""
    if isinstance(p, torch.Tensor):
        return p.numpy().view(np.uint32)
    return np.asarray(p)


def _column(rng, dt, n=500):
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        return rng.integers(int(info.min), int(info.max), size=n, dtype=dt,
                            endpoint=True)
    return (rng.normal(size=n) * 1e3).astype(dt)


# -- B6: codecs ---------------------------------------------------------------


@pytest.mark.parametrize("dt", list(NP_TO_TORCH))
def test_codecs_bit_exact_with_jax(dt):
    """key_to_planes / val_to_planes give JAX's planes bit for bit, and
    the inverses give the column back (tests/test_sort_pallas.py:105-147
    on the port)."""
    rng = np.random.default_rng(np.dtype(dt).itemsize * 7)
    a = _column(rng, dt)
    a[:4] = np.array([0, 1, -1 if np.issubdtype(dt, np.signedinteger)
                      or dt == np.float32 else 2, 3]).astype(dt)
    for enc, dec in ((jsort.key_to_planes, jsort.planes_to_key),
                     (jsort.val_to_planes, jsort.planes_to_val)):
        want = enc(jnp.asarray(a))
        tenc = getattr(tsort, enc.__name__)
        tdec = getattr(tsort, dec.__name__)
        got = tenc(_torch(a))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(_plane_bits(g), _plane_bits(w))
        back = tdec(got, NP_TO_TORCH[dt])
        assert back.dtype == NP_TO_TORCH[dt]
        np.testing.assert_array_equal(_np(back).view(a.dtype), a)


# -- B6: the sort ---------------------------------------------------------------


def _sorted_records(planes, nk):
    """Row multiset in canonical order (tests/test_sort_pallas.py)."""
    arr = np.stack([_plane_bits(p) for p in planes], axis=1)
    idx = np.lexsort([arr[:, j] for j in range(arr.shape[1] - 1, -1, -1)])
    return arr[idx]


@pytest.mark.parametrize("n", [0, 1, 100, TILE, TILE + 1, 3 * TILE,
                               4 * TILE, 5 * TILE + 77, 8 * TILE - 1,
                               13 * TILE + 1000, 9 * TILE + 11,
                               17 * TILE + 3])
@pytest.mark.parametrize("nk", [1, 2])
def test_merge_sort_planes_matches_lax(n, nk):
    """The sizes of test_merge_sort_planes_matches_lax: key planes equal
    to lax.sort's, whole records equal as a multiset."""
    rng = np.random.default_rng(n * 7 + nk)
    planes = [rng.integers(0, 50, size=n, dtype=np.uint32) if i < nk
              else rng.integers(0, 2**32, size=n, dtype=np.uint32)
              for i in range(nk + 2)]
    want = lax.sort(tuple(jnp.asarray(p) for p in planes), num_keys=nk,
                    is_stable=False)
    got = tsort.merge_sort_planes(
        [torch.from_numpy(p.view(np.int32)) for p in planes], nk)
    for i in range(nk):
        np.testing.assert_array_equal(_plane_bits(got[i]),
                                      np.asarray(want[i]))
    np.testing.assert_array_equal(_sorted_records(got, nk),
                                  _sorted_records(planes, nk))


@pytest.mark.parametrize("case", ["all_equal", "sentinel_tail", "wide"])
def test_merge_sort_planes_edge_keys(case):
    """All-equal keys, a sentinel-heavy tail (all-ones keys, which the
    TPU kernel reserves for padding and the port sorts as rows), and keys
    over the whole u32 range."""
    rng = np.random.default_rng(len(case))
    n = 6 * TILE + 123
    if case == "all_equal":
        keys = [np.full(n, 7, np.uint32)]
    elif case == "sentinel_tail":
        k0 = rng.integers(0, 9, n, dtype=np.uint32)
        k0[n // 3:] = 0xFFFFFFFF
        keys = [k0, np.where(np.arange(n) % 2 == 0, 0xFFFFFFFF,
                             rng.integers(0, 2**32, n)).astype(np.uint32)]
    else:
        keys = [rng.integers(0, 2**32, n, dtype=np.uint32)]
    planes = keys + [np.arange(n, dtype=np.uint32)]
    nk = len(keys)
    want = lax.sort(tuple(jnp.asarray(p) for p in planes), num_keys=nk,
                    is_stable=True)
    got = tsort.merge_sort_planes(
        [torch.from_numpy(p.view(np.int32)) for p in planes], nk)
    # the port's twin is stable, so it equals lax.sort(is_stable=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_plane_bits(g), np.asarray(w))


@pytest.mark.parametrize("key_dt", [np.int64, np.float32, np.int32])
def test_merged_sort_is_a_drop_in_for_lax_sort(key_dt):
    """The join's operand shape (a key, the int8 side tag, an int64 value)
    through the codecs: keys sorted and identical to lax.sort's, rows
    equal as a multiset."""
    rng = np.random.default_rng(9)
    n = 4 * TILE + 321
    # float keys without -0.0: lax.sort ranks -0.0 and 0.0 as equal, the
    # codecs (JAX's and the port's) rank -0.0 first
    key = (rng.integers(-1000, 1000, n).astype(key_dt) if key_dt != np.float32
           else rng.normal(size=n).astype(np.float32).round(1) + 0.0)
    tag = rng.integers(0, 3, n).astype(np.int8)
    val = rng.integers(-2**60, 2**60, n)
    want = lax.sort((jnp.asarray(key), jnp.asarray(tag), jnp.asarray(val)),
                    num_keys=2)
    got = tsort.merged_sort((_torch(key), _torch(tag), _torch(val)), 2)
    ref = tsort.merged_sort_reference((_torch(key), _torch(tag),
                                       _torch(val)), 2)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    def exact(a):
        a = np.asarray(a)
        return (a.view(np.int32) if a.dtype == np.float32 else a).astype(
            np.int64)

    gr = np.stack([exact(g.numpy()) for g in got], 1)
    wr = np.stack([exact(w) for w in want], 1)
    gi = np.lexsort([gr[:, 2], gr[:, 1], gr[:, 0]])
    wi = np.lexsort([wr[:, 2], wr[:, 1], wr[:, 0]])
    np.testing.assert_array_equal(gr[gi], wr[wi])


def test_merge_sort_planes_refuses_bad_planes():
    with pytest.raises(TypeError):
        tsort.merge_sort_planes([torch.zeros(4, dtype=torch.int64)], 1)
    with pytest.raises(ValueError):
        tsort.merge_sort_planes([torch.zeros(4, dtype=torch.int32)], 2)


# -- B7: expand_pull --------------------------------------------------------------


def _runs(rng, n_real, max_run, dup_lo_every=0):
    """Records with strictly increasing starts S and matched-rank lo;
    ``dup_lo_every`` makes some runs re-reference the previous run's
    build rows (a duplicate probe key: repeating ranks), as in
    tests/test_expand_planes.py."""
    cnts = rng.integers(1, max_run + 1, size=n_real)
    S = np.concatenate([[0], np.cumsum(cnts)[:-1]]).astype(np.int32)
    lo = np.zeros(n_real, np.int32)
    cur = 0
    for i in range(n_real):
        if dup_lo_every and i % dup_lo_every == 1 and cnts[i] == cnts[i - 1]:
            lo[i] = lo[i - 1]
        else:
            lo[i] = cur
        cur = lo[i] + cnts[i]
    return S, lo, cnts, int(cur)


@pytest.mark.parametrize("n_real,max_run,dup", [
    (100, 7, 0), (1, 5000, 0), (4000, 3, 3), (500, 40, 5)])
def test_expand_pull_matches_expand_gather_reference(n_real, max_run, dup):
    """Both modes against JAX's expand_gather_reference for the record
    lanes, and against the contract (start_b = S[r], build lanes at
    lo[r] + j - S[r]) for the rest, repeating ranks included."""
    rng = np.random.default_rng(n_real + max_run)
    S, lo, cnts, nb = _runs(rng, n_real, max_run, dup)
    out_cap = int(S[-1] + cnts[-1])
    S_p = np.concatenate([S, np.full(37, I32_MAX, np.int32)])
    lo_p = np.concatenate([lo, np.zeros(37, np.int32)])
    cols = [rng.integers(0, 1 << 63, size=len(S_p), dtype=np.uint64)
            for _ in range(2)]
    bcols = [rng.integers(0, 1 << 63, size=max(nb, 1), dtype=np.uint64)]
    want_rec = jex.expand_gather_reference(
        jnp.asarray(S_p), [jnp.asarray(c) for c in cols], out_cap)
    r = np.clip(np.searchsorted(S_p, np.arange(out_cap), side="right") - 1,
                0, len(S_p) - 1)
    want_sb = S_p[r]
    rank = np.clip(lo_p[r] + (np.arange(out_cap) - want_sb), 0, nb - 1)
    want_b = bcols[0][rank]

    t = [torch.from_numpy(c.view(np.int64).copy()) for c in cols]
    tb = [torch.from_numpy(b.view(np.int64).copy()) for b in bcols]
    rec, sb, zero, bout = tex.expand_pull(
        torch.from_numpy(S_p), t, out_cap, lo=torch.from_numpy(lo_p),
        build_cols=tb)
    for g, w in zip(rec, want_rec):
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w))
    np.testing.assert_array_equal(sb.numpy(), want_sb)
    assert zero.dtype == torch.int32 and not zero.any()
    np.testing.assert_array_equal(bout[0].numpy().view(np.uint64), want_b)
    rec2, sb2 = tex.expand_pull(torch.from_numpy(S_p), t, out_cap)
    for g, w in zip(rec2, want_rec):
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w))
    np.testing.assert_array_equal(sb2.numpy(), want_sb)
    # the same contract as expand_gather in build mode
    eg_rec, eg_b = tex.expand_gather(torch.from_numpy(S_p), t, out_cap,
                                     lo=torch.from_numpy(lo_p),
                                     build_cols=tb)
    assert torch.equal(eg_b[0], bout[0])
    assert all(torch.equal(a, b) for a, b in zip(eg_rec, rec))


def test_expand_pull_needs_lo_and_lanes():
    S = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="build mode"):
        tex.expand_pull(S, [torch.zeros(4, dtype=torch.int64)], 4,
                        build_cols=[torch.zeros(4, dtype=torch.int64)])
