"""A numpy model of the expand-gather kernel's tile decomposition
(``distributed_join_tpu_torch/csrc/expand_gather.cu``), step for step:
the per-tile 32-way search for the window's first and last record, the
window clamp, the merge-path walk of each thread's consecutive slots,
the pairs of the output phase and the rank clip. Every index the kernel
would use is checked against its array's bounds, and every slot must be
written exactly once. At tile sizes 1, 7, 64, 1024 and 2048 the model
equals the JAX package's ``expand_gather_reference`` and the port's
plain twin over every slot, in record mode and in build mode."""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import expand_pallas as jex
from distributed_join_tpu_torch.ops import expand as tex

I32_MAX = 2**31 - 1
# (threads, items): tiles of 1, 7, 64, 1024 (the kernel's own THREADS
# and ITEMS) and 2048 slots
TILES = [(1, 1), (1, 7), (8, 8), (256, 4), (256, 8)]


def _at(a, i):
    """a[i], refusing the index the kernel must never form."""
    assert 0 <= i < len(a), (i, len(a))
    return a[i]


def warp_count_le(S, m, j):
    """The kernel's ``warp_count_le``: 32 probes a round, one ballot."""
    lo, hi = 0, m
    while hi > lo:
        span = hi - lo
        c = sum(int(_at(S, lo + span * lane // 32) <= j)
                for lane in range(32))
        if c == 0:
            hi = lo
        else:
            q = lo + span * (c - 1) // 32
            hi = lo + span * c // 32 if c < 32 else hi
            lo = q + 1
    return lo


def tile_expand(S, lo, cols, bcols, out_cap, threads, items):
    """What the kernel writes: (rec_outs, start_b, build_outs or None)."""
    T = threads * items
    m = len(S)
    build = bcols is not None
    nb = len(bcols[0]) if build else 0
    rec_outs = [np.zeros(out_cap, np.uint64) for _ in cols]
    start_b = np.zeros(out_cap, np.int64)
    bld_outs = [np.zeros(out_cap, np.uint64) for _ in (bcols or [])]
    written = np.zeros(out_cap, np.int64)
    for blk in range(-(-out_cap // T)):
        j0 = blk * T
        ns = min(T, out_cap - j0)
        # 1. the window, clamped to one tile of records
        c0 = warp_count_le(S, m, j0)
        c1 = warp_count_le(S, m, j0 + ns - 1)
        ws, we = max(c0 - 1, 0), max(c1 - 1, 0)
        wn = min(max(we - ws + 1, 1), T)
        # 2. the window in shared memory (T entries a lane)
        s_S = np.zeros(T, np.int64)
        s_lo = np.zeros(T, np.int64)
        s_rec = [np.zeros(T, np.uint64) for _ in cols]
        for i in range(wn):
            s_S[i] = _at(S, ws + i)
            if build:
                s_lo[i] = _at(lo, ws + i)
            for sr, c in zip(s_rec, cols):
                sr[i] = _at(c, ws + i)
        # 3. merge path: items consecutive slots a thread
        s_w = np.full(T, -7, np.int64)
        for t in range(threads):
            i0 = t * items
            if i0 >= ns:
                continue
            jt = j0 + i0
            b, e = 0, wn
            while b < e:
                mid = (b + e) >> 1
                if _at(s_S, mid) <= jt:
                    b = mid + 1
                else:
                    e = mid
            w = b - 1
            for i in range(items):
                j = j0 + min(i0 + i, ns - 1)
                while w + 1 < wn and _at(s_S, w + 1) <= j:
                    w += 1
                assert i0 + i < T
                s_w[i0 + i] = w
        # 4. pairs of consecutive slots, strided by the block
        n_pairs = -(-T // 2)
        for q in range(-(-n_pairs // threads)):
            for t in range(threads):
                i = 2 * (t + q * threads)
                for h in range(2):
                    if i + h >= ns:
                        continue
                    w = _at(s_w, i + h)
                    assert -1 <= w < wn
                    r = max(w, 0)
                    sb = 0 if w < 0 else _at(s_S, w)
                    j = j0 + i + h
                    written[j] += 1
                    for o, sr in zip(rec_outs, s_rec):
                        o[j] = _at(sr, r)
                    start_b[j] = sb
                    if build:
                        rank = min(max(int(_at(s_lo, r)) + (j - sb), 0),
                                   nb - 1)
                        for o, bc in zip(bld_outs, bcols):
                            o[j] = _at(bc, rank)
    assert (written == 1).all(), "a slot written other than once"
    return rec_outs, start_b, (bld_outs if build else None)


def _records(rng, specs, sentinels=7, first_slot=0):
    """Records as the join makes them: per key with c builds and p
    probes, p records of run length c sharing lo; p == 0 keys advance lo
    without records (unmatched-build gaps)."""
    S_list, lo_list = [], []
    lo = 0
    slot = first_slot
    for c, p in specs:
        for _ in range(p):
            S_list.append(slot)
            lo_list.append(lo)
            slot += c
        lo += c
    m = len(S_list) + sentinels
    S = np.full(m, I32_MAX, np.int32)
    S[:len(S_list)] = S_list
    lo_arr = np.zeros(m, np.int32)
    lo_arr[:len(lo_list)] = lo_list
    cols = [rng.integers(0, 1 << 63, m, dtype=np.uint64) for _ in range(2)]
    bcols = [rng.integers(0, 1 << 63, max(lo, 1), dtype=np.uint64)]
    return S, lo_arr, cols, bcols, slot


# name -> (specs, first slot, out_capacity as a function of (total, T))
CASES = {
    "first-record-after-slot-0": ([(3, 2), (1, 4)] * 6, 5,
                                  lambda tot, T: tot + 3),
    "run-over-3-tiles": ([(2, 1), (1, 1)], 0,
                         lambda tot, T: 3 * T + 9),
    "records-on-every-tile-boundary": (None, 0,
                                       lambda tot, T: 4 * T),
    "all-runs-of-length-1": (None, 0, lambda tot, T: tot),
    "ragged-last-tile": ([(3, 2), (2, 3), (1, 1)] * 20, 0,
                         lambda tot, T: tot - 1 if tot % T == 0 else tot),
    "capacity-below-records": ([(2, 3), (1, 1)] * 40, 0,
                               lambda tot, T: max(tot // 3, 1)),
    "capacity-above-records": ([(2, 3), (5, 1)] * 10, 0,
                               lambda tot, T: tot + 2 * T + 1),
    "clipped-ranks-gap-data": ([(3, 2), (400, 0), (2, 3), (900, 0),
                                (1, 4)] * 3, 0, lambda tot, T: tot + 50),
}


def _case(name, T, rng):
    specs, first, cap = CASES[name]
    if name == "records-on-every-tile-boundary":
        specs = [(T, 1)] * 3 + [(1, 1)]
    if name == "all-runs-of-length-1":
        specs = [(1, 1)] * (2 * T + 3)
    if name == "run-over-3-tiles":
        specs = [(2, 1), (3 * T + 1, 1), (1, 1)]
    S, lo, cols, bcols, tot = _records(rng, specs, first_slot=first)
    out_cap = cap(tot, T)
    if out_cap < tot:  # records past the block become sentinels
        keep = S < out_cap
        S = np.where(keep, S, I32_MAX).astype(np.int32)
        lo = np.where(keep, lo, 0).astype(np.int32)
    return S, lo, cols, bcols, out_cap


def _jax_expected(S, lo, cols, bcols, out_cap):
    """The JAX package's record-mode reference, with lo and S riding as
    lanes; start_b and the clipped rank gather spelled out from them."""
    outs = jex.expand_gather_reference(
        jnp.asarray(S), [jnp.asarray(c) for c in cols]
        + [jnp.asarray(lo), jnp.asarray(S)], out_cap)
    outs = [np.asarray(o) for o in outs]
    j = np.arange(out_cap, dtype=np.int64)
    sb = np.where(j < S[0], 0, outs[-1].astype(np.int64))
    rank = np.clip(outs[-2].astype(np.int64) + (j - sb), 0,
                   len(bcols[0]) - 1)
    return outs[:-2], sb, [b[rank] for b in bcols]


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int64).copy())


@pytest.mark.parametrize("threads,items", TILES)
@pytest.mark.parametrize("name", list(CASES))
def test_tile_model_equals_references(name, threads, items):
    T = threads * items
    rng = np.random.default_rng(zlib.crc32(f"{name}/{T}".encode()))
    S, lo, cols, bcols, out_cap = _case(name, T, rng)
    got_r, got_sb, got_b = tile_expand(S, lo, cols, bcols, out_cap,
                                       threads, items)
    got_rr, got_rsb, _ = tile_expand(S, lo, cols, None, out_cap, threads,
                                     items)
    want_r, want_sb, want_b = _jax_expected(S, lo, cols, bcols, out_cap)
    tS, tlo = torch.from_numpy(S), torch.from_numpy(lo)
    t_r, t_b = tex.expand_gather(tS, [_i64(c) for c in cols], out_cap,
                                 lo=tlo, build_cols=[_i64(b) for b in bcols])
    t_rr, t_sb = tex.expand_gather(tS, [_i64(c) for c in cols], out_cap)
    for g, w, t in zip(got_r + got_b, want_r + want_b, t_r + t_b):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, t.numpy().view(np.uint64))
    for g, w, t in zip(got_rr, want_r, t_rr):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, t.numpy().view(np.uint64))
    for sb in (got_sb, got_rsb):
        np.testing.assert_array_equal(sb, want_sb)
        np.testing.assert_array_equal(sb, t_sb.numpy())


@pytest.mark.parametrize("threads,items", TILES)
def test_tile_model_window_holds_at_most_one_tile(threads, items):
    """With unique S a tile's window [r0, r1] has at most T records, the
    records of a run-length-1 tile exactly T; the clamp never cuts
    contract input."""
    T = threads * items
    S = np.concatenate([np.arange(5 * T + 3, dtype=np.int32),
                        np.full(4, I32_MAX, np.int32)])
    for blk in range(5):
        j0 = blk * T
        c0 = warp_count_le(S, len(S), j0)
        c1 = warp_count_le(S, len(S), j0 + T - 1)
        assert c1 - c0 + 1 == T


def test_tile_model_duplicate_S_stays_in_bounds():
    """S outside the contract (a value repeated past one tile) gives
    clamped windows, never an index out of bounds (``_at`` asserts)."""
    threads, items = 8, 8
    T = threads * items
    S = np.concatenate([np.zeros(3 * T, np.int32),
                        np.arange(1, 40, dtype=np.int32),
                        np.full(3, I32_MAX, np.int32)])
    m = len(S)
    cols = [np.arange(m, dtype=np.uint64)]
    bcols = [np.arange(17, dtype=np.uint64)]
    lo = np.zeros(m, np.int32)
    rec, _, bld = tile_expand(S, lo, cols, bcols, 2 * T + 5, threads, items)
    assert rec[0].shape == (2 * T + 5,) and bld[0].max() <= 16


@pytest.mark.parametrize("j", [0, 1, 5, 6, 99, 100, 101, 10**6, I32_MAX - 1])
def test_warp_count_le_is_upper_bound(j):
    S = np.array([1, 5, 5, 7, 100, 100, 100, 2**20] + [I32_MAX] * 5,
                 np.int32)
    for m in range(1, len(S) + 1):
        assert warp_count_le(S, m, j) == int(
            np.searchsorted(S[:m], j, side="right"))
