"""The port's CUDA kernels against their plain twins on the card, at
edge-case shapes (tile boundaries, one element, no survivors, truncated
capacities, more lanes than one launch carries, unaligned views,
all-equal keys, and every arrangement of dead and live radix digits).
Every test needs a CUDA device and the CUDA toolkit; without them each
skips, decided in the ``card`` fixture. Run on a machine with a GPU:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from distributed_join_tpu_torch.ops import (
    _kernels,
    compact,
    expand,
    merge_sort,
    scan,
)
from distributed_join_tpu_torch.ops import join as join_mod
from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import skew
from distributed_join_tpu_torch.table import Table

pytestmark = pytest.mark.cuda

I32_MAX = 2**31 - 1
TILE = 4096  # join_scans.cu: THREADS * ITEMS
COMPACT_TILE = 8192  # stream_compact.cu: THREADS * VEC
EXPAND_TILE = 1024  # expand_gather.cu: THREADS * ITEMS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _merged(rng, n_keys, max_b, max_p, pad):
    tags, firsts = [], []
    for _ in range(n_keys):
        b = int(rng.integers(0, max_b + 1))
        p = int(rng.integers(0, max_p + 1))
        if b + p == 0:
            b = 1
        tags.extend([0] * b + [1] * p)
        firsts.extend([1] + [0] * (b + p - 1))
    if pad:
        tags.extend([2] * pad)
        firsts.extend([1] + [0] * (pad - 1))
    return np.array(tags, np.int8), np.array(firsts, bool)


def _random_scan_inputs(rng, n, p_first, card):
    tag = torch.from_numpy(rng.integers(0, 3, n).astype(np.int8)).to(card)
    first = torch.from_numpy(rng.random(n) < p_first).to(card)
    return tag, first


def _scans_equal(tag, first):
    got = scan.join_scans(tag, first)
    want = scan.join_scans_reference(tag, first)
    for k in scan.NAMES:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n,p_first", [
    (1, 0.5), (TILE - 1, 0.05), (TILE, 0.05), (TILE + 1, 0.0),
    (3 * TILE + 5, 0.001), (600_001, 0.0001), (600_001, 0.3)])
def test_join_scans_kernel_on_arbitrary_tags(card, n, p_first):
    rng = np.random.default_rng(n)
    _scans_equal(*_random_scan_inputs(rng, n, p_first, card))


@pytest.mark.parametrize("n", [5 * TILE + 3, 200_003])
def test_join_scans_kernel_back_to_back_calls(card, n):
    """Two calls at the same n on different inputs: the second reuses
    the caching allocator's scratch, which still holds the first call's
    look-back status words; both must equal their twins."""
    rng = np.random.default_rng(n + 1)
    a = _random_scan_inputs(rng, n, 0.001, card)
    b = _random_scan_inputs(rng, n, 0.2, card)
    got_a = scan.join_scans(*a)
    got_b = scan.join_scans(*b)
    for inputs, got in ((a, got_a), (b, got_b)):
        want = scan.join_scans_reference(*inputs)
        for k in scan.NAMES:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("off", [1, 7, 16])
def test_join_scans_kernel_unaligned_views(card, off):
    """tag and first views that start off a 16-byte boundary take the
    byte path (an offset of 16 stays aligned)."""
    rng = np.random.default_rng(50 + off)
    n = 3 * TILE + 29
    tag_full, first_full = _random_scan_inputs(rng, n + off, 0.01, card)
    tag, first = tag_full[off:], first_full[off:]
    assert (tag.data_ptr() % 16 == 0) == (off == 16)
    _scans_equal(tag, first)
    _scans_equal(tag, first_full[:n])  # one aligned, one not


def test_join_scans_kernel_many_tiles(card):
    """2^16 tiles and a ragged last one: the look-back chains of both
    passes across every tile, runs spanning tiles, first[0] False."""
    n = (1 << 16) * TILE + 1234
    g = torch.Generator(device=card)
    g.manual_seed(16)
    tag = torch.randint(0, 3, (n,), generator=g, device=card,
                        dtype=torch.int8)
    first = torch.rand(n, generator=g, device=card) < 1e-4
    first[0] = False
    _scans_equal(tag, first)


@pytest.mark.parametrize("n_keys,max_b,max_p,pad", [
    (40, 3, 3, 0), (200, 5, 2, 37), (20_000, 20, 1, 0), (300, 400, 300, 5),
    (5, 3000, 2000, 7)])
def test_join_scans_kernel_on_merged_layouts(card, n_keys, max_b, max_p, pad):
    rng = np.random.default_rng(n_keys)
    tag, first = _merged(rng, n_keys, max_b, max_p, pad)
    _scans_equal(torch.from_numpy(tag).to(card),
                 torch.from_numpy(first).to(card))


@pytest.mark.parametrize("n,density,capacity,k", [
    (5000, 0.3, 4096, 2), (5000, 1.0, 8192, 4), (5000, 0.0, 1024, 1),
    (5000, 0.7, 1000, 3), (257, 0.5, 256, 1), (40_000, 0.6, 30_000, 11),
    (300, 0.5, 0, 2)])
def test_stream_compact_kernel(card, n, density, capacity, k):
    rng = np.random.default_rng(n + k)
    mask = torch.from_numpy(rng.random(n) < density).to(card)
    pos = (torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1)
    cols = [torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n,
                                          dtype=np.int64)).to(card)
            for _ in range(k)]
    before = compact.stream_compact.launches
    got = compact.stream_compact(mask, pos, cols, capacity)
    launches = -(-k // _kernels.MAX_LANES) if capacity else 0
    assert compact.stream_compact.launches == before + launches
    want = compact.stream_compact_reference(mask, pos, cols, capacity)
    total = min(int(mask.sum()), capacity)
    for g, w in zip(got, want):
        assert torch.equal(g[:total], w[:total])


def _compact_check(mask, pos, cols, capacity):
    got = compact.stream_compact(mask, pos, cols, capacity)
    want = compact.stream_compact_reference(mask, pos, cols, capacity)
    total = min(int(mask.sum()), capacity)
    for g, w in zip(got, want):
        assert torch.equal(g[:total], w[:total])


def _lanes(rng, n, k, card):
    return [torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n,
                                          dtype=np.int64)).to(card)
            for _ in range(k)]


@pytest.mark.parametrize("off", range(1, 16))
def test_stream_compact_kernel_unaligned_views(card, off):
    """A mask at any byte offset (the head and tail chunks take the byte
    path), with pos and lanes views at the same offset."""
    rng = np.random.default_rng(100 + off)
    n = 3 * COMPACT_TILE + 777
    full = torch.ones(n + 16, dtype=torch.bool, device=card)
    full[:] = torch.from_numpy(rng.random(n + 16) < 0.3).to(card)
    mask = full[off:off + n]
    pos_full = torch.zeros(n + 16, dtype=torch.int32, device=card)
    pos_full[off:off + n] = torch.cumsum(mask.to(torch.int32), 0,
                                         dtype=torch.int32) - 1
    pos = pos_full[off:off + n]
    cols = [c[off:off + n] for c in _lanes(rng, n + 16, 3, card)]
    assert mask.data_ptr() % 16 == (full.data_ptr() + off) % 16
    _compact_check(mask, pos, cols, n)
    _compact_check(mask, pos, cols, int(mask.sum()) // 2)


@pytest.mark.parametrize("pattern,k,cut", [
    ("dense-empty", 4, None), ("dense-empty", 11, None),
    ("dense-empty", 1, "in-tile"), ("one-survivor-tiles", 2, None),
    ("one-survivor-tiles", 2, "in-tile"), ("dense", 3, "in-tile")])
def test_stream_compact_kernel_tile_patterns(card, pattern, k, cut):
    """Tiles without survivors between dense ones, tiles with a single
    survivor, a capacity that ends inside a tile, and 11 lanes (two
    launches)."""
    rng = np.random.default_rng(len(pattern) + k)
    tiles = 9
    n = tiles * COMPACT_TILE + 1234
    m = np.zeros(n, bool)
    for t in range(tiles + 1):
        lo, hi = t * COMPACT_TILE, min((t + 1) * COMPACT_TILE, n)
        if pattern == "dense":
            m[lo:hi] = rng.random(hi - lo) < 0.9
        elif pattern == "dense-empty" and t % 3 == 0:
            m[lo:hi] = rng.random(hi - lo) < 0.8
        elif pattern == "one-survivor-tiles":
            m[lo + int(rng.integers(0, hi - lo))] = True
    mask = torch.from_numpy(m).to(card)
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    cols = _lanes(rng, n, k, card)
    capacity = int(m.sum())
    if cut == "in-tile":
        # the output ends part way through the survivors of tile 3
        capacity = int(m[:3 * COMPACT_TILE].sum()) + max(
            1, int(m[3 * COMPACT_TILE:4 * COMPACT_TILE].sum()) // 2)
    before = compact.stream_compact.launches
    _compact_check(mask, pos, cols, capacity)
    assert compact.stream_compact.launches == before + -(-k // 8)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, COMPACT_TILE - 1])
def test_stream_compact_kernel_below_one_tile(card, n):
    rng = np.random.default_rng(n)
    for density in (0.0, 0.5, 1.0):
        mask = torch.from_numpy(rng.random(n) < density).to(card)
        pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
        cols = _lanes(rng, n, 2, card)
        for cap in (n, max(n // 3, 1)):
            _compact_check(mask, pos, cols, cap)


def _join_records(rng, key_specs, kb=2):
    S_list, lo_list = [], []
    lo = slot = 0
    for c, p in key_specs:
        for _ in range(p):
            S_list.append(slot)
            lo_list.append(lo)
            slot += c
        lo += c
    m = len(S_list) + 7
    S = np.full((m,), I32_MAX, np.int32)
    S[:len(S_list)] = S_list
    lo_arr = np.zeros((m,), np.int32)
    lo_arr[:len(lo_list)] = lo_list
    cols = [rng.integers(0, 1 << 63, m, dtype=np.int64) for _ in range(2)]
    bcols = [rng.integers(0, 1 << 63, max(lo, 1), dtype=np.int64)
             for _ in range(kb)]
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return t(S), t(lo_arr), [t(c) for c in cols], [t(b) for b in bcols], slot


@pytest.mark.parametrize("key_specs", [
    [(2, 3)] * 40 + [(1, 1)] * 30,
    [(700, 2), (1, 5), (300, 3), (2, 2)],
    [(2000, 1)],
    [(1, 1), (1, 1), (5000, 0), (1, 1)],
    [(3, 2), (400, 0), (2, 3), (900, 0), (1, 4)] * 3,
])
def test_expand_gather_kernel_both_modes(card, key_specs):
    rng = np.random.default_rng(len(key_specs))
    S, lo, cols, bcols, total = _join_records(rng, key_specs)
    for out_cap in (total, total + 50, max(total // 2, 1)):
        keep = min(total, out_cap)
        got = expand.expand_gather(S, cols, out_cap, lo=lo, build_cols=bcols)
        want = expand.expand_gather_reference(S, cols, out_cap, lo=lo,
                                              build_cols=bcols)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(g[:keep], w[:keep])
        got_r, got_sb = expand.expand_gather(S, cols, out_cap)
        want_r, want_sb = expand.expand_gather_reference(S, cols, out_cap)
        for g, w in zip(got_r, want_r):
            assert torch.equal(g[:keep], w[:keep])
        assert torch.equal(got_sb[:keep], want_sb[:keep])


@pytest.mark.parametrize("k,kb", [(11, 3), (2, 17), (9, 9)])
def test_expand_gather_kernel_lane_groups(card, k, kb):
    """More lanes than one launch carries: one launch per group of
    MAX_LANES lanes on the longer side, every lane equal to the twin."""
    rng = np.random.default_rng(k * 31 + kb)
    S, lo, _, bcols, total = _join_records(rng, [(3, 2), (50, 4), (1, 7)],
                                           kb=kb)
    m = S.shape[0]
    cols = [torch.from_numpy(rng.integers(0, 1 << 63, m, dtype=np.int64))
            .to(card) for _ in range(k)]
    groups = -(-max(k, kb) // _kernels.MAX_LANES)
    before = expand.expand_gather.launches
    got = expand.expand_gather(S, cols, total, lo=lo, build_cols=bcols)
    assert expand.expand_gather.launches == before + groups
    want = expand.expand_gather_reference(S, cols, total, lo=lo,
                                          build_cols=bcols)
    assert len(got[0]) == k and len(got[1]) == kb
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    got_r, got_sb = expand.expand_gather(S, cols, total)
    want_r, want_sb = expand.expand_gather_reference(S, cols, total)
    for g, w in zip(got_r + [got_sb], want_r + [want_sb]):
        assert torch.equal(g, w)


def _expand_equal(S, cols, out_cap, lo, bcols):
    """Both modes of expand_gather equal to the twin on every slot."""
    got = expand.expand_gather(S, cols, out_cap, lo=lo, build_cols=bcols)
    want = expand.expand_gather_reference(S, cols, out_cap, lo=lo,
                                          build_cols=bcols)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    got_r, got_sb = expand.expand_gather(S, cols, out_cap)
    want_r, want_sb = expand.expand_gather_reference(S, cols, out_cap)
    for g, w in zip(got_r + [got_sb], want_r + [want_sb]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("out_cap", [
    1, EXPAND_TILE - 1, EXPAND_TILE, EXPAND_TILE + 1, 3 * EXPAND_TILE + 5])
def test_expand_gather_kernel_tile_boundaries(card, out_cap):
    """Records starting on every tile boundary (runs of one tile, then
    of one slot), cut at each tile-edge capacity; every slot, the
    ragged last tile's too, equal to the twin."""
    rng = np.random.default_rng(out_cap)
    specs = [(EXPAND_TILE, 1)] * 2 + [(1, 1)] * 5 + [(EXPAND_TILE - 5, 1),
                                                     (3, 2), (1, 1)]
    S, lo, cols, bcols, total = _join_records(rng, specs)
    if out_cap < total:
        keep = S < out_cap
        S = torch.where(keep, S, torch.full_like(S, I32_MAX))
        lo = torch.where(keep, lo, torch.zeros_like(lo))
    _expand_equal(S, cols, out_cap, lo, bcols)


def test_expand_gather_kernel_run_over_tiles(card):
    """One run covering more than three whole tiles (the window holds
    one record), between short runs, and slots past the total."""
    rng = np.random.default_rng(9)
    specs = [(2, 3), (3 * EXPAND_TILE + 77, 1), (1, 4), (5, 2)]
    S, lo, cols, bcols, total = _join_records(rng, specs)
    _expand_equal(S, cols, total + EXPAND_TILE + 3, lo, bcols)


def test_expand_gather_kernel_run_length_one_many_tiles(card):
    """Config 3's shape: every run one slot long (full windows), over
    2**16 tiles and a ragged one."""
    n = (1 << 16) * EXPAND_TILE + 3
    S = torch.arange(n, dtype=torch.int32, device=card)
    g = torch.Generator(device=card)
    g.manual_seed(11)
    lo = torch.randperm(n, generator=g, device=card).to(torch.int32)
    cols = [torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                          device=card) for _ in range(2)]
    bcols = [torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                           device=card)]
    _expand_equal(S, cols, n, lo, bcols)


@pytest.mark.parametrize("off", [1, 3, 4])
def test_expand_gather_kernel_unaligned_views(card, off):
    """S, lo and record-lane views ``off`` elements into their storage:
    off a 16-byte boundary (1, 3) every wrapper raises before launching;
    on one (4) the views are taken and equal the twin."""
    rng = np.random.default_rng(off)
    S, lo, cols, bcols, total = _join_records(
        rng, [(3, 2), (700, 1), (1, 9), (EXPAND_TILE, 1), (2, 2)])

    def shifted(t):
        big = torch.empty(t.shape[0] + off, dtype=t.dtype, device=card)
        big[off:] = t
        return big[off:]

    Sv, lov = shifted(S), shifted(lo)
    colsv = [shifted(c) for c in cols]
    bcolsv = [shifted(b) for b in bcols]
    if off == 4:
        _expand_equal(Sv, colsv, total + 5, lov, bcolsv)
        return
    assert Sv.data_ptr() % 16 and colsv[0].data_ptr() % 16
    before = (expand.expand_gather.launches, expand.expand_pull.launches)
    calls = [
        lambda: expand.expand_gather(Sv, colsv, total, lo=lov,
                                     build_cols=bcolsv),
        lambda: expand.expand_gather(Sv, colsv, total),
        lambda: expand.expand_gather(S, colsv, total),
        lambda: expand.expand_gather(S, cols, total, lo=lov,
                                     build_cols=bcols),
        lambda: expand.expand_pull(Sv, colsv, total, lo=lov,
                                   build_cols=bcolsv),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="16-byte"):
            call()
    assert (expand.expand_gather.launches,
            expand.expand_pull.launches) == before


def test_expand_gather_kernel_zero_capacity(card):
    S = torch.zeros(0, dtype=torch.int32, device=card)
    before = expand.expand_gather.launches
    out, sb = expand.expand_gather(S, [torch.zeros(0, dtype=torch.int64,
                                                   device=card)], 0)
    assert expand.expand_gather.launches == before
    assert out[0].shape == (0,) and sb.shape == (0,)


def test_expand_gather_kernel_without_records(card):
    S = torch.full((16,), I32_MAX, dtype=torch.int32, device=card)
    out, sb = expand.expand_gather(S, [torch.arange(16, device=card)], 64)
    torch.cuda.synchronize()
    assert out[0].shape == (64,) and sb.shape == (64,)


@pytest.mark.parametrize("key_dtype,payload_dtype", [
    (torch.int64, torch.int64), (torch.int32, torch.float32),
    (torch.int16, torch.int8)])
def test_join_kernel_pipeline_equals_plain(card, key_dtype, payload_dtype):
    g = torch.Generator(device=card)
    g.manual_seed(3)
    n = 50_000
    bk = torch.randint(0, 3000, (n,), generator=g, device=card)
    pk = torch.randint(0, 6000, (n,), generator=g, device=card)
    b = Table({"key": bk.to(key_dtype),
               "bp": torch.arange(n, device=card).to(payload_dtype)},
              torch.rand(n, generator=g, device=card) < 0.9)
    p = Table({"key": pk.to(key_dtype),
               "pp": (-torch.arange(n, device=card)).to(payload_dtype)},
              torch.rand(n, generator=g, device=card) < 0.95)
    # ~17 build rows per key and half the probe keys hit: ~7 matches a row
    k = sort_merge_inner_join(b, p, "key", 12 * n)
    q = sort_merge_inner_join(b, p, "key", 12 * n,
                              kernel_config=KernelConfig("plain"))
    assert int(k.total) == int(q.total) > 0 and not bool(k.overflow)

    def rows(r):
        cols = [r.table.columns[c][r.table.valid].double()
                for c in ("key", "bp", "pp")]
        a = torch.stack(cols, 1).cpu().numpy()
        return a[np.lexsort(a.T[::-1])]

    np.testing.assert_array_equal(rows(k), rows(q))


def test_join_kernel_pipeline_many_lanes_and_zero_capacity(card):
    """Nine payloads a side (more than one launch carries) and an empty
    output block both stay on the kernel pipeline and equal the plain
    formulation."""
    g = torch.Generator(device=card)
    g.manual_seed(5)
    n = 20_000
    bcols = {"key": torch.randint(0, 2000, (n,), generator=g, device=card)}
    pcols = {"key": torch.randint(0, 4000, (n,), generator=g, device=card)}
    for i in range(9):
        bcols[f"b{i}"] = torch.randint(-99, 99, (n,), generator=g,
                                       device=card).to(torch.int32)
        pcols[f"p{i}"] = torch.rand(n, generator=g, device=card)
    b = Table(bcols, torch.ones(n, dtype=torch.bool, device=card))
    p = Table(pcols, torch.ones(n, dtype=torch.bool, device=card))
    names = list(bcols) + [c for c in pcols if c != "key"]
    before = scan.join_scans.launches
    k = sort_merge_inner_join(b, p, "key", 8 * n)
    q = sort_merge_inner_join(b, p, "key", 8 * n,
                              kernel_config=KernelConfig("plain"))
    assert scan.join_scans.launches == before + 1
    assert int(k.total) == int(q.total) > 0 and not bool(k.overflow)

    def rows(r):
        cols = [r.table.columns[c][r.table.valid].double() for c in names]
        a = torch.stack(cols, 1).cpu().numpy()
        return a[np.lexsort(a.T[::-1])]

    np.testing.assert_array_equal(rows(k), rows(q))
    z = sort_merge_inner_join(b, p, "key", 0)
    assert scan.join_scans.launches == before + 2
    assert int(z.total) == int(k.total) and bool(z.overflow)


def _closed_form_check(outs: dict, want, n: int, chunk: int = 1 << 27):
    """Each output against ``want(name, i)`` (int64 positions ``i``),
    exactly, chunk by chunk."""
    for lo in range(0, n, chunk):
        i = torch.arange(lo, min(n, lo + chunk), device=outs["cnt"].device)
        for name in scan.NAMES:
            w = want(name, i).to(torch.int32)
            assert torch.equal(outs[name][lo:lo + chunk], w), (name, lo)


def test_join_scans_kernel_at_the_int32_limit(card):
    """n = 2^31 - 3 positions (the largest merged domain the join's
    kernel pipeline admits, up to one): one run of builds ending in a
    probe, then a run of 9,998 builds and two probes. Every count of the
    forward status words (builds, matched builds, open builds, matched
    builds before the last run start, the wrapping sum of cnt) passes
    2^30 and reaches its 31-bit field's top; every output equals its
    closed form. About 58 GB of the card."""
    n = 2**31 - 3
    s = n - 10_000                       # the second run's first position
    tag = torch.zeros(n, dtype=torch.int8, device=card)
    tag[s - 1] = 1
    tag[n - 2:] = 1
    first = torch.zeros(n, dtype=torch.bool, device=card)
    first[0] = first[s] = True
    before = scan.join_scans.launches
    outs = scan.join_scans(tag, first)
    torch.cuda.synchronize()
    assert scan.join_scans.launches == before + 1
    del tag, first

    def want(name, i):
        probe = (i == s - 1) | (i >= n - 2)
        run2 = i >= s
        if name == "matched":
            return (~probe).long()
        if name == "cnt":
            return torch.where(i == s - 1, s - 1,
                               torch.where(i >= n - 2, n - 2 - s, 0))
        if name == "start_out":
            return torch.where(i == n - 1, n - 3,
                               torch.where(run2, s - 1, 0))
        if name == "lo_m":
            return torch.where(run2, s - 1, 0)
        if name == "rec_pos":
            return torch.where(i < s - 1, -1, torch.where(
                i < n - 2, 0, torch.where(i == n - 2, 1, 2)))
        # mb_pos: matched builds through i, less one
        return torch.where(i < s - 1, i, torch.where(
            i == s - 1, s - 2, torch.where(i < n - 2, i - 1, n - 4)))

    _closed_form_check(outs, want, n)


def test_join_above_2_30_merged_positions(card, monkeypatch):
    """A join of 2^30 + 2^17 merged positions on the kernel pipeline
    (above the scan's old limit of 2^30 - 1): int32 keys, no payloads.
    Build keys are 0 .. nb - 1, probe keys the even numbers 0 ..
    2 (npr - 1), so the result is exactly the even keys below nb, once
    each. Prints the run's peak device memory."""
    nb = npr = 2**29 + 2**16
    keys = torch.arange(nb, dtype=torch.int32, device=card)
    b = Table({"key": keys}, torch.ones(nb, dtype=torch.bool, device=card))
    p = Table({"key": 2 * keys}, torch.ones(npr, dtype=torch.bool,
                                            device=card))
    del keys
    total = nb // 2
    monkeypatch.setattr(join_mod, "_join_plain",
                        lambda *a, **kw: pytest.fail("took the plain path"))
    torch.cuda.reset_peak_memory_stats(card)
    before = scan.join_scans.launches
    r = sort_merge_inner_join(b, p, "key", total)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card)
    assert scan.join_scans.launches == before + 1
    assert int(r.total) == total and not bool(r.overflow)
    got = torch.sort(r.table.columns["key"][r.table.valid]).values
    assert torch.equal(got, torch.arange(0, nb, 2, dtype=torch.int32,
                                         device=card))
    print(f"[join above 2^30] {nb + npr} merged positions, total {total}, "
          f"peak_memory_bytes {peak} "
          f"({torch.cuda.get_device_name(0)})")


def test_float64_bucket_ids_on_card_equal_cpu(card):
    """The float64 key hash decomposes a = m * 2^e with log2 and exp2;
    on the card it must give the CPU's bits, or equal keys would route
    apart between devices. Integer keys over +-2^24, every power of two
    from 2^-30 to 2^60 with both signs, and both zeros."""
    from distributed_join_tpu_torch.ops.hashing import bucket_ids, hash_columns
    rng = np.random.default_rng(31)
    pw = 2.0 ** np.arange(-30, 61)
    k = np.concatenate([rng.integers(-(1 << 24), 1 << 24, 100_000),
                        pw, -pw, [0.0, -0.0]]).astype(np.float64)
    cpu = torch.from_numpy(k)
    gpu = cpu.to(card)
    assert torch.equal(hash_columns([gpu]).cpu(), hash_columns([cpu]))
    for n in (3, 8, 1_000_003):
        assert torch.equal(bucket_ids([gpu], n).cpu(), bucket_ids([cpu], n))


def _typed_case(name, g, card, n=40_000):
    """Tables of one typed/composite/2-D/string case on the card."""
    def ints(hi, n=n):
        return torch.randint(0, hi, (n,), generator=g, device=card)

    def signed_floats(k):
        k = (k - 2000).double() / 4
        k[k == -500] = -0.0          # two of every ~4000 keys are +-0.0
        k[k == -499.75] = float("inf")
        k[k == -499.5] = float("-inf")
        return k

    if name == "float64":
        b = {"key": signed_floats(ints(4000)), "bp": ints(99).double()}
        p = {"key": signed_floats(ints(4000)), "pp": ints(99).double()}
        keys = "key"
    elif name == "composite3":
        b = {"k0": ints(30), "k1": ints(20).int(), "k2": ints(9).float(),
             "bp": ints(99)}
        p = {"k0": ints(30), "k1": ints(20).int(), "k2": ints(9).float(),
             "pp": ints(99)}
        keys = ["k0", "k1", "k2"]
    elif name == "two_d":
        b = {"key": ints(3000), "bs": ints(256, n * 7).view(n, 7)
             .to(torch.uint8), "bp": ints(99)}
        p = {"key": ints(6000), "ps": ints(256, n * 16).view(n, 16)
             .to(torch.uint8)}
        keys = "key"
    else:  # string key beside an int32 key, 2-D payload
        from distributed_join_tpu_torch.utils.strings import (
            encode_int_strings,
        )
        b, p = {}, {}
        for cols, hi, side in ((b, 3000, "b"), (p, 6000, "p")):
            base = ints(hi)
            cols["sk"], cols["sk#len"] = encode_int_strings(
                base, prefix="itm-", digits=12)
            cols["k"] = (base % 3).int()
            cols[side + "tag"] = ints(256, n * 5).view(n, 5).to(torch.uint8)
        keys = ["sk", "k"]
    ones = torch.ones(n, dtype=torch.bool, device=card)
    return Table(b, ones), Table(p, ones), keys


@pytest.mark.parametrize("name", ["float64", "composite3", "two_d",
                                  "string_key"])
def test_join_kernel_pipeline_types_and_strings_equal_plain(card, name,
                                                            monkeypatch):
    """float64 keys with +-0.0 and +-inf, a 3-column mixed-dtype key,
    2-D payloads on both sides, and a string key beside a scalar key:
    each stays on the kernel pipeline (one join_scans launch, the plain
    formulation never called) and gives the plain formulation's rows."""
    g = torch.Generator(device=card)
    g.manual_seed(zlib.crc32(name.encode()))
    b, p, keys = _typed_case(name, g, card)
    q = sort_merge_inner_join(b, p, keys, 40 * 40_000,
                              kernel_config=KernelConfig("plain"))
    monkeypatch.setattr(join_mod, "_join_plain",
                        lambda *a, **kw: pytest.fail("took the plain path"))
    before = scan.join_scans.launches
    k = sort_merge_inner_join(b, p, keys, 40 * 40_000)
    assert scan.join_scans.launches == before + 1
    assert int(k.total) == int(q.total) > 0 and not bool(k.overflow)
    assert k.table.column_names == q.table.column_names

    def rows(r):
        parts = []
        for c in r.table.column_names:
            x = r.table.columns[c][r.table.valid]
            if x.dtype.is_floating_point:
                x = x.double().view(torch.int64)
            parts.append(x.reshape(x.shape[0], -1).long())
        a = torch.cat(parts, 1).cpu().numpy()
        return a[np.lexsort(a.T[::-1])]

    np.testing.assert_array_equal(rows(k), rows(q))


def test_kernel_wrappers_refuse_wrong_dtypes(card):
    tag = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        scan.join_scans(tag, torch.ones(8, dtype=torch.bool, device=card))


@pytest.mark.parametrize("dup", [0, 3])
def test_expand_pull_kernel_both_modes(card, dup):
    """expand_pull equals its twin (expand_gather_reference's contract)
    in both modes, also where build ranks repeat (the JAX kernel's
    known limit), and counts its launches apart from expand_gather."""
    rng = np.random.default_rng(40 + dup)
    specs = [(3, 1 + dup), (50, 2), (1, 7), (700, 1 + dup)] * 5
    S, lo, cols, bcols, total = _join_records(rng, specs)
    before = (expand.expand_pull.launches, expand.expand_gather.launches)
    got = expand.expand_pull(S, cols, total, lo=lo, build_cols=bcols)
    assert (expand.expand_pull.launches,
            expand.expand_gather.launches) == (before[0] + 1, before[1])
    want = expand.expand_pull_reference(S, cols, total, lo=lo,
                                        build_cols=bcols)
    assert len(got) == 4
    for g, w in zip(got[0] + [got[1], got[2]] + got[3],
                    want[0] + [want[1], want[2]] + want[3]):
        assert torch.equal(g, w)
    got_r, got_sb = expand.expand_pull(S, cols, total)
    want_r, want_sb = expand.expand_pull_reference(S, cols, total)
    for g, w in zip(got_r + [got_sb], want_r + [want_sb]):
        assert torch.equal(g, w)


def _planes(rng, n, nk, nv, key_max):
    key = [rng.integers(0, key_max, n, dtype=np.uint32) for _ in range(nk)]
    val = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(nv)]
    return [torch.from_numpy(a.view(np.int32)).cuda() for a in key + val]


@pytest.mark.parametrize("nk", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("tiles,extra", [
    (0, 1), (0, 100), (1, 0), (1, 1), (2, 0), (3, 0), (3, 77), (5, -1),
    (13, 1000), (64, 0)])
def test_merge_sort_kernel_edge_shapes(card, nk, tiles, extra):
    """Boundaries of the scatter passes' tiles and one row, keys of 1 to
    8 planes: bit-identical to the stable twin."""
    T = merge_sort.tile_rows(nk)
    n = tiles * T + extra
    rng = np.random.default_rng(n * 10 + nk)
    planes = _planes(rng, n, nk, 2, 50 if nk < 3 else 4)
    before = merge_sort.merge_sort_planes.launches
    got = merge_sort.merge_sort_planes(planes, nk)
    assert merge_sort.merge_sort_planes.launches == before + 1
    want = merge_sort.merge_sort_planes_reference(planes, nk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [0, 5, 3 * 2048 + 5])
def test_merge_sort_kernel_all_equal_and_sentinel_keys(card, n):
    """All-equal keys keep input order (the index breaks ties); rows
    whose keys are all ones sort last and stay rows, no padding."""
    ones = torch.full((n,), -1, dtype=torch.int32, device=card)
    same = torch.full((n,), 7, dtype=torch.int32, device=card)
    iota = torch.arange(n, dtype=torch.int32, device=card)
    for keys in ([same], [ones, ones]):
        got = merge_sort.merge_sort_planes(keys + [iota], len(keys))
        assert torch.equal(got[-1], iota)
    mixed = torch.where(iota % 3 == 0, ones, iota)
    got = merge_sort.merge_sort_planes([mixed, iota], 1)
    want = merge_sort.merge_sort_planes_reference([mixed, iota], 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _u32_planes(arrays, card):
    return [torch.from_numpy(np.asarray(a, np.uint32).view(np.int32))
            .to(card) for a in arrays]


# the digit-pattern cases and their key planes
_DIGIT_CASES = {
    "all-dead": 2, "lowest-only": 2, "highest-only-1-word": 2,
    "highest-only-2-words": 4, "high-word-only": 4, "tag-only-in-word-1": 3,
    "two-passes": 2, "three-passes": 2, "all-ones-last": 2, "one-row": 2,
    "2^20+3-rows": 3}


def _digit_case(name, rng):
    """(key planes, n): keys whose live digit positions are known.
    Digit positions count bytes from the least significant of the last
    key word."""
    n = 5 * merge_sort.tile_rows(_DIGIT_CASES[name]) + 321

    def const(v):
        return np.full(n, v, np.uint32)

    def rnd(bits):
        return rng.integers(0, 1 << bits, n, dtype=np.uint64)

    if name == "all-dead":               # every digit dead: no pass runs
        return [const(0x12345678), const(0x9ABCDEF0)], n
    if name == "lowest-only":            # digit 0: one pass (odd)
        return [const(7), 0xABCDEF00 | rnd(8)], n
    if name == "highest-only-1-word":    # digit 7 of one word
        return [0x00ABCDEF | (rnd(8) << 24), const(3)], n
    if name == "highest-only-2-words":   # digit 15 of two words
        return [0x00ABCDEF | (rnd(8) << 24), const(1), const(2),
                const(9)], n
    if name == "high-word-only":         # 8 passes in word 0 only (even)
        return [rnd(32), rnd(32), const(5), const(6)], n
    if name == "tag-only-in-word-1":     # key + tag: 4 + 1 passes (odd)
        return [const(0x80000000), rnd(25), 128 + rng.integers(
            0, 3, n, dtype=np.uint64)], n
    if name == "two-passes":             # even
        return [const(0x80000000), rnd(16)], n
    if name == "three-passes":           # odd
        return [const(0x80000000), rnd(24)], n
    if name == "all-ones-last":
        hi, lo = rnd(3), rnd(32)
        ones = rng.random(n) < 0.2
        hi[ones] = lo[ones] = 0xFFFFFFFF
        return [hi, lo], n
    if name == "one-row":
        return [rnd(32)[:1], rnd(32)[:1]], 1
    if name == "2^20+3-rows":
        m = (1 << 20) + 3
        return [rng.integers(0, 1 << 32, m, dtype=np.uint64)
                for _ in range(3)], m
    raise ValueError(name)


@pytest.mark.parametrize("name", list(_DIGIT_CASES))
def test_radix_sort_kernel_digit_patterns(card, name):
    """Dead and live digit positions in every arrangement the device-side
    skipping meets: none live, one at either end, only the high word,
    the tag alone in the second word, even and odd live counts (so each
    ping-pong buffer ends a sort); bit-identical to the stable twin."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    keys, n = _digit_case(name, rng)
    assert len(keys) == _DIGIT_CASES[name]
    vals = [rng.integers(0, 1 << 32, n, dtype=np.uint64) for _ in range(2)]
    planes = _u32_planes(list(keys) + vals, card)
    nk = len(keys)
    got = merge_sort.merge_sort_planes(planes, nk)
    want = merge_sort.merge_sort_planes_reference(planes, nk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if name == "all-dead":
        assert torch.equal(got[nk], planes[nk])   # input order kept
    if name == "all-ones-last":
        ones = (planes[0] == -1) & (planes[1] == -1)
        k = int(ones.sum())
        assert bool(((got[0] == -1) & (got[1] == -1))[n - k:].all())


def test_merged_sort_kernel_join_operands(card):
    """The join's merged-sort operand set (int64 key + int8 tag as keys,
    int64 value) against the stable twin run through the same codecs."""
    g = torch.Generator(device=card)
    g.manual_seed(11)
    n = 300_000
    key = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g, device=card)
    key[::7] = key[0]
    tag = torch.randint(0, 3, (n,), generator=g, device=card).to(torch.int8)
    val = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g, device=card)
    got = merge_sort.merged_sort((key, tag, val), 2)
    cpu = merge_sort.merged_sort((key.cpu(), tag.cpu(), val.cpu()), 2)
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dtypes,nk", [
    ((torch.int8, torch.int64, torch.int32), 2),
    ((torch.float32, torch.uint64, torch.int16, torch.uint8), 3),
    ((torch.uint32, torch.int32, torch.uint16, torch.uint8, torch.int64,
      torch.float32), 5)])
def test_merged_sort_kernel_operand_dtypes(card, dtypes, nk):
    """Keys of every width and order map, 8-byte keys on odd planes
    included, and values of several widths: the kernel reads the
    operands as they are and equals the codecs' plain route on the CPU."""
    rng = np.random.default_rng(len(dtypes) * 10 + nk)
    planes = sum(2 if dt.itemsize == 8 else 1 for dt in dtypes[:nk])
    n = 3 * merge_sort.tile_rows(planes) + 99
    ops = []
    for dt in dtypes:
        if dt == torch.float32:
            a = rng.choice([-2.5, -0.0, 0.0, 1.0, 3.25, -1e30, 7e20], n)
            ops.append(torch.from_numpy(a.astype(np.float32)))
        else:
            bits = torch.iinfo(dt).bits
            a = rng.integers(0, 1 << min(bits, 63), n, dtype=np.uint64)
            a = a % 5 if len(ops) < nk else a   # ties among the keys
            ops.append(torch.from_numpy(a.astype(np.int64)).to(dt))
    got = merge_sort.merged_sort([o.to(card) for o in ops], nk)
    want = merge_sort.merged_sort(ops, nk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_extract_prefix_kernel_branch_counts_its_own_site(card):
    """extract_prefix's kernel branch (n >= 2 * capacity) launches the
    compaction under its own count, equal to the sort branch over the
    valid rows."""
    rng = np.random.default_rng(8)
    n, cap = 50_000, 4096
    sel = torch.from_numpy(rng.random(n) < 0.05).to(card)
    t = Table({"key": torch.arange(n, device=card) * 3,
               "v": torch.arange(n, device=card)},
              torch.ones(n, dtype=torch.bool, device=card))
    before = (skew.extract_prefix.launches, compact.stream_compact.launches)
    k, kc, kovf = skew.extract_prefix(t, sel, cap)
    assert (skew.extract_prefix.launches,
            compact.stream_compact.launches) == (before[0] + 1, before[1])
    p, pc, povf = skew.extract_prefix(t, sel, cap,
                                      kernel_config=KernelConfig("plain"))
    assert skew.extract_prefix.launches == before[0] + 1
    assert int(kc) == int(pc) and bool(kovf) == bool(povf) is False
    assert torch.equal(k.valid, p.valid)
    for c in ("key", "v"):
        assert torch.equal(k.columns[c][k.valid], p.columns[c][p.valid])


# -- the typed joins (left, right, full outer, semi, anti) ---------------


TYPED = ("left", "right", "full_outer", "semi", "anti")


def _sorted_rows(res):
    """The valid rows as a lexicographically sorted int64 array (floats
    by their bits, bools as 0 and 1, 2-D columns an element a column)."""
    parts = []
    for c in res.table.column_names:
        x = res.table.columns[c][res.table.valid]
        if x.dtype.is_floating_point:
            x = x.double().view(torch.int64)
        parts.append(x.reshape(x.shape[0], -1).long())
    a = torch.cat(parts, 1).cpu().numpy()
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("join_type", TYPED)
def test_typed_join_kernel_route_equals_plain(card, join_type, monkeypatch):
    """Each type at 2 M x 2 M rows (the headline's generator: duplicate
    build keys, 30 % probe hits, invalid rows on both sides) through the
    kernel pipeline, never the plain formulation, and equal to the plain
    formulation's rows. Semi and anti joins expand in record mode."""
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    n = 2_000_000
    b, p = generate_build_probe_tables(seed=17, build_nrows=n,
                                       probe_nrows=n, device=card)
    g = torch.Generator(device=card)
    g.manual_seed(4)
    b = Table(b.columns, torch.rand(n, generator=g, device=card) < 0.97)
    p = Table(p.columns, torch.rand(n, generator=g, device=card) < 0.97)
    cap = 2 * n
    q = sort_merge_inner_join(b, p, "key", cap, join_type=join_type,
                              kernel_config=KernelConfig("plain"))
    monkeypatch.setattr(join_mod, "_join_plain",
                        lambda *a, **kw: pytest.fail("took the plain path"))
    sites = (scan.join_scans, join_mod.compact_records,
             join_mod.pack_valid_builds, expand.expand_gather)
    before = [w.launches for w in sites]
    k = sort_merge_inner_join(b, p, "key", cap, join_type=join_type)
    torch.cuda.synchronize()
    packs = 0 if join_type in ("semi", "anti") else 1
    assert [w.launches - x for w, x in zip(sites, before)] == [1, 1, packs, 1]
    assert int(k.total) == int(q.total) > 0 and not bool(k.overflow)
    assert k.table.column_names == q.table.column_names
    np.testing.assert_array_equal(_sorted_rows(k), _sorted_rows(q))


def _typed_stages(card, join_type, n=300_000):
    """The typed kernel route's merged-domain quantities on the card,
    from the plain twins' torch ops: (sorted keys, emit)."""
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    b, p = generate_build_probe_tables(seed=23, build_nrows=n,
                                       probe_nrows=n, device=card)
    g = torch.Generator(device=card)
    g.manual_seed(9)
    b = Table(b.columns, torch.rand(n, generator=g, device=card) < 0.9)
    skeys, stag, _ = join_mod._merged_sort(b, p, ["key"], ["build_payload"],
                                           ["probe_payload"])
    sc = scan.join_scans_reference(stag, join_mod._run_starts(skeys))
    is_b, is_p = stag == 0, stag == 1
    return skeys, join_mod._emit(join_type, is_p, sc["cnt"],
                                 is_b & (sc["matched"] == 0))


def test_valid_build_pack_equals_the_build_side_sort(card):
    """The valid-build pack (kernel, mask: the valid builds of the merged
    order) equals the prefix of the plain formulation's build-side sort,
    row for row: both sorts are stable, so valid builds come in (key,
    row) order in both."""
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    n = 300_000
    b, p = generate_build_probe_tables(seed=23, build_nrows=n,
                                       probe_nrows=n, device=card)
    g = torch.Generator(device=card)
    g.manual_seed(9)
    b = Table({"key": b.columns["key"], "row": torch.arange(n, device=card)},
              torch.rand(n, generator=g, device=card) < 0.9)
    _, stag, svals = join_mod._merged_sort(b, p, ["key"], ["row"], [])
    mask = stag == 0
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    got, = join_mod.pack_valid_builds(mask, pos, [svals[("b", "row")]], n)
    keys = torch.where(b.valid, b.columns["key"],
                       torch.full_like(b.columns["key"], 2**63 - 1))
    perm_b = join_mod._lexsort([keys, (~b.valid).to(torch.int8)])
    nv = int(b.valid.sum())
    assert torch.equal(got[:nv], perm_b[:nv])


@pytest.mark.parametrize("join_type", TYPED)
def test_typed_record_compaction_equals_the_record_sort(card, join_type):
    """The record block (kernel, mask: emit > 0) equals the prefix of the
    plain formulation's record sort by start_out, on the key and the
    start_out lanes."""
    skeys, emit = _typed_stages(card, join_type)
    start_out = torch.cumsum(emit, 0, dtype=torch.int32) - emit
    mask = emit > 0
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    n_rec = int(mask.sum())
    cap = n_rec + 5000
    got = join_mod.compact_records(mask, pos, [start_out.long(), skeys[0]],
                                   cap)
    rkey = torch.where(mask, start_out, torch.full_like(start_out, I32_MAX))
    rperm = torch.sort(rkey, stable=True).indices[:n_rec]
    assert torch.equal(got[0][:n_rec], start_out[rperm].long())
    assert torch.equal(got[1][:n_rec], skeys[0][rperm])


def test_right_join_shared_lanes_zero_probe_outputs(card):
    """Same-dtype build and probe payloads (int32, float32, 2-D bytes)
    share the merged sort's lanes; the right and full outer joins' rows
    without a probe side carry zeros in every probe output on the kernel
    pipeline, as in the plain formulation."""
    g = torch.Generator(device=card)
    g.manual_seed(12)
    n = 200_000

    def ints(lo, hi, m=n):
        return torch.randint(lo, hi, (m,), generator=g, device=card)

    ones = torch.ones(n, dtype=torch.bool, device=card)
    b = Table({"key": ints(0, 80_000), "b32": ints(1, 999).int(),
               "bf": ints(1, 99).float(),
               "bs": ints(1, 256, n * 5).view(n, 5).to(torch.uint8)}, ones)
    p = Table({"key": ints(40_000, 120_000), "p32": ints(1, 999).int(),
               "pf": ints(1, 99).float(),
               "ps": ints(1, 256, n * 4).view(n, 4).to(torch.uint8)}, ones)
    for jt in ("right", "full_outer"):
        k = sort_merge_inner_join(b, p, "key", 4 * n, join_type=jt)
        q = sort_merge_inner_join(b, p, "key", 4 * n, join_type=jt,
                                  kernel_config=KernelConfig("plain"))
        assert int(k.total) == int(q.total) and not bool(k.overflow)
        np.testing.assert_array_equal(_sorted_rows(k), _sorted_rows(q))
        c = k.table.columns
        absent = k.table.valid & ~c["probe#valid"]
        assert int(absent.sum()) > 1000
        for nm in ("p32", "pf", "ps"):
            assert not bool(c[nm][absent].any()), nm
        assert bool(c["b32"][absent].all())


_NCCL_WORKER = r'''
import sys
import numpy as np
import torch
from distributed_join_tpu_torch.parallel import bootstrap
from distributed_join_tpu_torch.parallel.communicator import make_communicator
from distributed_join_tpu_torch.parallel.distributed_join import (
    distributed_inner_join)
from distributed_join_tpu_torch.utils.generators import (
    generate_build_probe_tables)

assert bootstrap.maybe_initialize_from_env()
comm = make_communicator("nccl")
assert comm.n_ranks == 1 and comm.device.type == "cuda"
b, p = generate_build_probe_tables(seed=3, build_nrows=1_000_000,
                                   probe_nrows=1_000_000, device=comm.device)
res = distributed_inner_join(b, p, comm, over_decomposition=4)
out = {"total": np.int64(int(res.total)),
       "overflow": np.bool_(bool(res.overflow))}
cols = res.table.columns
for name in res.table.column_names:
    out["col/" + name] = cols[name][res.table.valid].cpu().numpy()
# dtypes NCCL lacks or takes as bytes, through every collective
x = {"u64": torch.tensor([-(1 << 63) + 12345 * i for i in range(8)],
                        device=comm.device).view(torch.uint64),
     "bool": torch.arange(8, device=comm.device) % 3 == 0,
     "bytes2d": torch.arange(40, device=comm.device).view(8, 5).to(
         torch.uint8)}
for k, t in x.items():
    for tag, v in (("a2a", comm.all_to_all(t)), ("gather", comm.all_gather(t)),
                   ("psum", comm.psum(t))):
        assert v.dtype == t.dtype, (k, tag)
        bits = torch.int64 if t.dtype == torch.uint64 else t.dtype
        assert torch.equal(v.view(bits), t.view(bits)), (k, tag)
np.savez(sys.argv[1], **out)
comm.finalize()
'''


def test_nccl_world_of_one_join_equals_local(card, tmp_path):
    """One NCCL process (a world of 1, started by the port's launcher)
    joins 1 M x 1 M rows at over-decomposition 4, so the partition runs
    and every batch crosses NCCL's all_to_all_single; its rows equal the
    LocalCommunicator join's on the same tables. The same process sends
    uint64, bool and 2-D byte columns through all_to_all, all_gather
    and psum unchanged."""
    import os
    import socket
    import subprocess
    import sys

    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path / "rank0.npz"
    r = subprocess.run(
        [sys.executable, "-m", "distributed_join_tpu_torch.benchmarks.launch",
         "--num-processes", "1", "--coordinator", f"localhost:{port}", "--",
         sys.executable, "-c", _NCCL_WORKER, str(out)],
        capture_output=True, text=True, timeout=120, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr[-4000:]
    got = np.load(out)
    b, p = generate_build_probe_tables(seed=3, build_nrows=1_000_000,
                                       probe_nrows=1_000_000, device=card)
    want = distributed_inner_join(b, p, LocalCommunicator())
    assert not bool(want.overflow) and not bool(got["overflow"])
    assert int(got["total"]) == int(want.total) > 0
    names = want.table.column_names
    rows = np.stack([got["col/" + n] for n in names], 1)
    np.testing.assert_array_equal(rows[np.lexsort(rows.T[::-1])],
                                  _sorted_rows(want))


_WIRE_WORKER = r'''
import json, sys
import numpy as np
from distributed_join_tpu_torch.parallel import bootstrap
from distributed_join_tpu_torch.parallel.communicator import make_communicator
from distributed_join_tpu_torch.parallel.distributed_join import (
    distributed_inner_join)
from distributed_join_tpu_torch.utils.generators import (
    generate_build_probe_tables, generate_composite_build_probe_tables)

assert bootstrap.maybe_initialize_from_env()
comm = make_communicator("nccl")
cases = json.loads(sys.argv[2])
out = {}
for name, (tables, opts) in cases.items():
    if tables == "strings":
        b, p, keys = generate_composite_build_probe_tables(
            seed=5, build_nrows=200_000, probe_nrows=200_000, key_columns=2,
            string_payload_len=16, variable_length_strings=True,
            device=comm.device)
    else:
        b, p = generate_build_probe_tables(
            seed=3, build_nrows=1_000_000, probe_nrows=1_000_000,
            device=comm.device)
        keys = ["key"]
    res = distributed_inner_join(b, p, comm, key=keys, **opts)
    out[name + "/total"] = np.int64(int(res.total))
    out[name + "/overflow"] = np.bool_(bool(res.overflow))
    for col in res.table.column_names:
        out[f"{name}/col/{col}"] = (
            res.table.columns[col][res.table.valid].cpu().numpy())
np.savez(sys.argv[1], **out)
comm.finalize()
'''

WIRE_CASES = {
    "ragged": ("ints", dict(shuffle="ragged", over_decomposition=4)),
    "ppermute": ("ints", dict(shuffle="ppermute", over_decomposition=4)),
    "compressed": ("ints", dict(compression_bits=16, over_decomposition=4,
                                auto_retry=2)),
    "ragged_strings": ("strings", dict(shuffle="ragged",
                                       over_decomposition=4)),
}


@pytest.fixture(scope="module")
def wire_run(tmp_path_factory):
    """One NCCL process (a world of 1) joins in every wire mode."""
    import json
    import os
    import socket
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs between cards")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path_factory.mktemp("wires") / "rank0.npz"
    r = subprocess.run(
        [sys.executable, "-m", "distributed_join_tpu_torch.benchmarks.launch",
         "--num-processes", "1", "--coordinator", f"localhost:{port}", "--",
         sys.executable, "-c", _WIRE_WORKER, str(out),
         json.dumps(WIRE_CASES)],
        capture_output=True, text=True, timeout=300, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_nccl_world_of_one_wire_equals_local(card, wire_run, case):
    """Each wire (ragged, ppermute, compressed, and the byte-exact
    string wire at config 5's shape) over NCCL at over-decomposition 4:
    the rows, total and flag of the LocalCommunicator join of the same
    tables (one bucket, no shuffle)."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
        generate_composite_build_probe_tables,
    )
    tables, _ = WIRE_CASES[case]
    if tables == "strings":
        b, p, keys = generate_composite_build_probe_tables(
            seed=5, build_nrows=200_000, probe_nrows=200_000, key_columns=2,
            string_payload_len=16, variable_length_strings=True, device=card)
    else:
        b, p = generate_build_probe_tables(seed=3, build_nrows=1_000_000,
                                           probe_nrows=1_000_000,
                                           device=card)
        keys = ["key"]
    want = distributed_inner_join(b, p, LocalCommunicator(), key=keys)
    assert not bool(want.overflow) and not bool(wire_run[case + "/overflow"])
    assert int(wire_run[case + "/total"]) == int(want.total) > 0
    names = want.table.column_names
    got = [wire_run[f"{case}/col/{n}"] for n in names]
    rows = np.concatenate([g.reshape(g.shape[0], -1).astype(np.int64)
                           for g in got], axis=1)
    cols = [want.table.columns[n][want.table.valid].cpu().numpy()
            for n in names]
    ref = np.concatenate([c.reshape(c.shape[0], -1).astype(np.int64)
                          for c in cols], axis=1)
    np.testing.assert_array_equal(rows[np.lexsort(rows.T[::-1])],
                                  ref[np.lexsort(ref.T[::-1])])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("bits", [2, 8, 16, 32])
def test_codec_on_card_equals_cpu(card, bits, dtype):
    """The FoR + bit-pack codec on CUDA tensors: words, frames, flags,
    required bits and decoded rows equal the CPU's bit for bit, on a
    batch of rows with narrow, negative and full-range blocks."""
    from distributed_join_tpu_torch.ops import compression
    g = torch.Generator().manual_seed(bits)
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max, (4, 3000), generator=g,
                      dtype=dtype)
    x[0] = torch.randint(-1000, 1 << (bits - 1), (3000,), generator=g,
                         dtype=dtype)
    x[1, :1024] = info.min + 5
    cpu = compression.encode_rows(x, bits, 256)
    gpu = compression.encode_rows(x.to(card), bits, 256)
    for a, b_ in zip(cpu, gpu):
        assert torch.equal(a, b_.cpu())
    back = compression.decode_rows(gpu[0], gpu[1], 3000, bits, 256, dtype)
    assert torch.equal(back.cpu(), compression.decode_rows(
        cpu[0], cpu[1], 3000, bits, 256, dtype))
    if bits >= 16:  # row 0 spans less than 2^16
        assert not bool(cpu[2][0])


# -- the out-of-core batch loop (config 4) on the card --------------------


def _batch_rows(res) -> np.ndarray:
    """A batch result's valid rows as an int64 matrix, columns in name
    order."""
    t = res.table
    cols = [t.columns[n][t.valid].cpu().numpy().astype(np.int64)
            for n in sorted(t.column_names)]
    return np.stack(cols, axis=1)


def _batch_multiset(parts) -> np.ndarray:
    rows = np.concatenate(parts)
    return rows[np.lexsort(rows.T[::-1])]


def test_pinned_rotation_waits_for_a_copy_in_flight(card):
    """PINNED_SLOTS (three) pinned buffer sets and four batches: the
    fourth refills the first's buffers while the first's copy still
    waits behind a busy copy stream. The refill must wait for it
    (counted), and every staged table must hold its own batch's rows."""
    from distributed_join_tpu_torch.parallel import out_of_core
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )

    def batch(v, m):
        return {"key": np.full(m, v, np.int32),
                "x": np.arange(m, dtype=np.int32) * v}

    assert out_of_core.PINNED_SLOTS == 3
    phase = {}
    st = out_of_core._Stager(
        LocalCommunicator(), card, (4096, 8192),
        lambda k, dt: phase.__setitem__(k, phase.get(k, 0.0) + dt))
    with torch.cuda.stream(st.stream):
        torch.cuda._sleep(400_000_000)  # ~0.2 s of a busy copy stream
    staged = [st.stage(batch(v, 4000), batch(v + 10, 8000))
              for v in (1, 2, 3, 4)]
    assert st.refills_waited == 1
    torch.cuda.synchronize()
    st.close()
    assert phase["put_s"] > 0
    for v, (bt, pt, _) in zip((1, 2, 3, 4), staged):
        for t, w, m, cap in ((bt, v, 4000, 4096), (pt, v + 10, 8000, 8192)):
            assert torch.equal(t.columns["key"][:m].cpu(),
                               torch.full((m,), w, dtype=torch.int32))
            assert torch.equal(t.columns["x"][:m].cpu(),
                               torch.arange(m, dtype=torch.int32) * w)
            assert t.valid[:m].all() and not t.valid[m:].any()
            assert t.capacity == cap


@pytest.mark.parametrize("caps,allocations", [
    ((4096, 8192), 6),  # powers of two: a column each pins no more
    ((4200, 8400), 1),  # a column each would pin ~1.9x the bytes
])
def test_pinned_set_takes_the_allocation_that_pins_less(card, caps,
                                                        allocations):
    """A pinned set is one allocation or one a column (the caching host
    allocator rounds each up to a power of two), whichever pins fewer
    bytes; every column is pinned and stages its batch's rows."""
    from distributed_join_tpu_torch.parallel import out_of_core
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    st = out_of_core._Stager(LocalCommunicator(), card, caps,
                             lambda k, dt: None)
    bt, pt, _ = st.stage(
        {"key": np.arange(4000, dtype=np.int32),
         "x": np.arange(4000, dtype=np.int32) * 3},
        {"key": np.arange(8000, dtype=np.int32) % 97,
         "y": np.arange(8000, dtype=np.int32) * 5})
    bufs = st.slots[0]
    assert len({t.untyped_storage().data_ptr()
                for t in bufs.values()}) == allocations
    assert all(t.is_pinned() for t in bufs.values())
    st.close()
    assert torch.equal(bt.columns["x"][:4000].cpu(),
                       torch.arange(4000, dtype=torch.int32) * 3)
    assert torch.equal(pt.columns["key"][:8000].cpu(),
                       torch.arange(8000, dtype=torch.int32) % 97)
    assert torch.equal(pt.columns["y"][:8000].cpu(),
                       torch.arange(8000, dtype=torch.int32) * 5)
    assert bt.valid[:4000].all() and not bt.valid[4000:].any()
    assert pt.valid[:8000].all() and not pt.valid[8000:].any()
    assert (bt.capacity, pt.capacity) == caps


def test_slow_consumer_and_many_small_batches_fetch_every_row(card):
    """Twelve small key-range batches (four times the pinned sets) with a
    consumer that sleeps on every batch: the fetched rows equal the CPU
    batch loop's, batch by batch, and the totals agree."""
    import time

    from distributed_join_tpu_torch.parallel import out_of_core
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.utils.tpch_host import (
        generate_tpch_host_batches,
        rename_batches,
    )
    ob, lb = generate_tpch_host_batches(3, 0.01, 12, chunk_orders=2000)
    bb = rename_batches(ob, {"o_orderkey": "key"})
    pb = rename_batches(lb, {"l_orderkey": "key"})
    runs = {}
    for dev in (card, torch.device("cpu")):
        got = {}

        def consumer(b, res):
            time.sleep(0.02)
            got[b] = _batch_rows(res)

        stats = {}
        total, overflow = out_of_core.batched_join_host(
            bb, pb, LocalCommunicator(), device=dev, stats=stats,
            on_batch_result=consumer, out_capacity_factor=1.5)
        assert not overflow and stats["failed_batches"] == []
        runs[dev.type] = (total, got)
    assert runs["cuda"][0] == runs["cpu"][0] == sum(len(b["key"])
                                                    for b in pb)
    assert sorted(runs["cuda"][1]) == list(range(12))
    for b in range(12):
        np.testing.assert_array_equal(_batch_multiset([runs["cuda"][1][b]]),
                                      _batch_multiset([runs["cpu"][1][b]]))


def test_settle_of_a_batch_does_not_wait_for_the_next_join(card):
    """A batch's scalars settle on their own event: with a long kernel
    queued behind the batch on the join's stream (standing for the next
    batch's join), ``get`` returns while that kernel still runs."""
    import time

    from distributed_join_tpu_torch.parallel import out_of_core
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_distributed_join,
    )
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_join_tables,
    )
    orders, lineitem = generate_tpch_join_tables(1, 0.01, device=card)
    fn = make_distributed_join(LocalCommunicator(), key="key",
                               out_capacity_factor=1.5)
    res = fn(orders.rename({"o_orderkey": "key"}),
             lineitem.rename({"l_orderkey": "key"}))
    sc = out_of_core._Scalars(res, card)
    torch.cuda._sleep(2_000_000_000)  # ~1 s on the join's stream
    t0 = time.perf_counter()
    total, overflow = sc.get()
    waited = time.perf_counter() - t0
    still_busy = not torch.cuda.current_stream(card).query()
    torch.cuda.synchronize()
    assert still_busy and waited < 0.25, waited
    assert total == int(res.total) == lineitem.capacity and not overflow


def test_batched_path_at_sf_0_1_equals_the_plain_path(card):
    """The host batches at SF 0.1 (4 batches) through the batch loop on
    the card's kernels and through the plain path: equal rows (sorted
    multisets), totals equal to the line count, no overflow."""
    from distributed_join_tpu_torch.parallel import out_of_core
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.utils.tpch_host import (
        generate_tpch_host_batches,
        rename_batches,
    )
    ob, lb = generate_tpch_host_batches(42, 0.1, 4)
    bb = rename_batches(ob, {"o_orderkey": "key"})
    pb = rename_batches(lb, {"l_orderkey": "key"})
    rows = {}
    for label, cfg in (("kernels", None), ("plain", KernelConfig("plain"))):
        got = []
        total, overflow = out_of_core.batched_join_host(
            bb, pb, LocalCommunicator(), device=card,
            on_batch_result=lambda b, res: got.append(_batch_rows(res)),
            out_capacity_factor=1.5, kernel_config=cfg)
        assert total == sum(len(b["key"]) for b in pb) and not overflow
        rows[label] = _batch_multiset(got)
    np.testing.assert_array_equal(rows["kernels"], rows["plain"])


def _table_rows(table) -> np.ndarray:
    """A result table's valid rows as a sorted (rows, fields) int64
    array, columns by name (a 2-D column a field a byte)."""
    valid = table.valid.cpu().numpy()
    parts = []
    for nm in sorted(table.columns):
        a = table.columns[nm].cpu().numpy()[valid]
        parts.append(a.reshape(a.shape[0], -1).astype(np.int64))
    a = np.concatenate(parts, axis=1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


@pytest.mark.parametrize("case", ["plain", "two_d_composite", "overflow"])
def test_batched_join_on_card_equals_cpu(card, case):
    """The segmented sort's batched join on the card against the same
    call on the CPU (held against the JAX package by
    tests/test_torch_segmented.py): rows, total, overflow; 128 segments
    of runs past a tile, duplicate keys, invalid rows."""
    from distributed_join_tpu_torch.ops.segmented import (
        batched_sort_merge_inner_join,
    )
    rng = np.random.default_rng(len(case))
    s, rb, rp = 128, 3000, 5000
    b = {"key": rng.integers(0, 2000, (s, rb)),
         "bp": rng.integers(-(1 << 40), 1 << 40, (s, rb))}
    p = {"key": rng.integers(0, 2000, (s, rp)),
         "pp": rng.integers(0, 1 << 20, (s, rp)).astype(np.int32)}
    keys = ["key"]
    if case == "two_d_composite":
        b["k2"] = rng.integers(0, 2, (s, rb)).astype(np.int32)
        p["k2"] = rng.integers(0, 2, (s, rp)).astype(np.int32)
        b["bs"] = rng.integers(0, 256, (s, rb, 6)).astype(np.uint8)
        p["ps"] = rng.integers(0, 256, (s, rp, 4)).astype(np.uint8)
        keys = ["key", "k2"]
    bv, pv = rng.random((s, rb)) >= 0.1, rng.random((s, rp)) >= 0.1
    out_cap = 8000 if case != "overflow" else 4000
    outs = []
    for dev in (card, torch.device("cpu")):
        outs.append(batched_sort_merge_inner_join(
            {k: torch.from_numpy(v).to(dev) for k, v in b.items()},
            torch.from_numpy(bv).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in p.items()},
            torch.from_numpy(pv).to(dev), keys, out_cap))
    (gt, gtot, govf), (ct, ctot, covf) = outs
    assert int(gtot) == int(ctot) > 0
    assert bool(govf) == bool(covf) == (case == "overflow")
    np.testing.assert_array_equal(_table_rows(gt), _table_rows(ct))


def test_emulated_hierarchy_on_card_equals_one_rank(card):
    """4 emulated ranks as 2 slices x 2 on the card: the hierarchical
    wire with the codec off and on (4 bits: the ladder widens) and the
    segmented sort over it, each equal to the 1-rank join."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    build, probe = generate_build_probe_tables(
        seed=3, build_nrows=400_000, probe_nrows=400_000, device=card)
    one = distributed_inner_join(build, probe, LocalCommunicator(),
                                 auto_retry=2)
    want = _table_rows(one.table)
    for opts in (dict(dcn_codec="off"),
                 dict(dcn_codec="on", compression_bits=4, auto_retry=3),
                 dict(dcn_codec="off", sort_mode="segmented",
                      sort_segments=8)):
        comm = EmulatedCommunicator(4, n_slices=2)
        res = distributed_inner_join(build, probe, comm,
                                     shuffle="hierarchical", **opts)
        assert not bool(res.overflow) and int(res.total) == int(one.total)
        np.testing.assert_array_equal(_table_rows(res.table), want)
        assert comm.wire_bytes_ici > 0 and comm.wire_bytes_dcn > 0


# -- the fused join+aggregate (ops/aggregate.py) ----------------------------


def _groups_site_inputs(rng, n, runs, p_rec, card):
    """A per-run domain as the aggregate compacts it: n slots, the first
    ``runs`` of them runs, each a record with probability ``p_rec``; four
    lanes (an int64 key, an int64 sum, a count, an int32 carry)."""
    from distributed_join_tpu_torch.ops.lanes import to_u64_lane
    rec = np.zeros(n, bool)
    rec[:runs] = rng.random(runs) < p_rec
    mask = torch.from_numpy(rec).to(card)
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    lanes = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(card),
             torch.from_numpy(rng.integers(0, 1 << 40, n)).to(card),
             torch.from_numpy(rng.integers(1, 8, n)).to(card),
             to_u64_lane(torch.from_numpy(
                 rng.integers(-2**31, 2**31, n).astype(np.int32)).to(card))]
    return mask, pos, lanes


@pytest.mark.parametrize("n,runs,p_rec,cap", [
    (3 * COMPACT_TILE + 17, 2 * COMPACT_TILE, 0.3, 4096),
    (600_001, 400_000, 0.05, 32_768),
    # an overflowing groups block: the first ``cap`` groups, in order
    (600_001, 400_000, 0.05, 1000),
    (COMPACT_TILE, COMPACT_TILE, 1.0, COMPACT_TILE)])
def test_groups_compaction_kernel(card, n, runs, p_rec, cap):
    """``stream_compact`` at the groups site (``compact_groups``)
    against its twin over the survivor prefix, its launch counted on the
    site."""
    from distributed_join_tpu_torch.ops import aggregate
    rng = np.random.default_rng(n + cap)
    mask, pos, lanes = _groups_site_inputs(rng, n, runs, p_rec, card)
    kept = min(int(mask.sum()), cap)
    _kernels.reset_launch_counts(aggregate.compact_groups)
    got = aggregate.compact_groups(mask, pos, lanes, cap)
    want = compact.stream_compact_reference(mask, pos, lanes, cap)
    torch.cuda.synchronize()
    assert aggregate.compact_groups.launches == 1
    for g, w in zip(got, want):
        assert torch.equal(g[:kept], w[:kept])


def _aggregate_tables(dev, seed=9, nb=200_000, npr=600_000, kmax=150_000):
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, kmax, nb)
    pk = rng.integers(0, kmax, npr)
    bg = rng.integers(0, 97, nb)
    build = Table.from_numpy({
        "key": bk, "bgroup": bg, "bcarry": bg * 3 + 1,
        "b_val": rng.integers(-1000, 1000, nb),
        "b_f": rng.random(nb)}, rng.random(nb) < 0.95, device=dev)
    probe = Table.from_numpy({
        "key": pk, "p_val": rng.integers(0, 1 << 30, npr).astype(np.int32),
        "p_f": rng.random(npr).astype(np.float32)},
        rng.random(npr) < 0.95, device=dev)
    return build, probe


@pytest.mark.parametrize("mode", ["key", "build"])
def test_local_join_aggregate_on_card_equals_cpu(card, mode):
    """Key and build mode on the card (the groups compaction's kernel,
    torch's CUDA sorts, scans and scatters) equal to the same call on
    the CPU: integer lanes exactly, float lanes within ``frames_equal``'s
    rtol 1e-5, atol 1e-8 (the segment sums add in another order, and a
    float32 sum rounds at ~1e-7)."""
    from distributed_join_tpu_torch.ops import aggregate as A
    aggs = [("count", None), ("sum", "p_val"), ("sum", "b_val"),
            ("min", "p_val"), ("max", "b_val"), ("mean", "p_val"),
            ("sum", "b_f"), ("sum", "p_f")]
    spec = (A.AggregateSpec.of("key", aggs, carry=("bcarry",))
            if mode == "key" else
            A.AggregateSpec.of("bgroup", aggs, carry=("bcarry",)))
    gn = ["key"] if mode == "key" else ["bgroup"]
    frames = []
    for dev in (card, torch.device("cpu")):
        build, probe = _aggregate_tables(dev)
        _kernels.reset_launch_counts(A.compact_groups)
        part, total, groups, ovf = A.local_join_aggregate(
            build, probe, ["key"], spec, mode, 300_000)
        assert not bool(ovf) and int(groups) > 0
        if dev.type == "cuda":
            assert A.compact_groups.launches >= 1
        frames.append((int(total), A.groups_frame(
            A.finalize_groups(part, spec, gn), spec, gn)))
    (gt, got), (ct, want) = frames
    assert gt == ct
    assert A.frames_equal(got, want)
    for c in want:
        if want[c].dtype.kind != "f":
            np.testing.assert_array_equal(got[c], want[c])


def _resident_tables(dev, seed=3):
    rng = np.random.default_rng(seed)
    nb, npr = 200_000, 300_000
    build = Table.from_numpy({
        "key": rng.permutation(400_000)[:nb].astype(np.int64),
        "build_payload": rng.integers(0, 1 << 40, nb).astype(np.int64)},
        np.ones(nb, bool), device=dev)
    probe = Table.from_numpy({
        "key": rng.integers(0, 400_000, npr).astype(np.int64),
        "probe_payload": rng.integers(0, 1 << 40, npr).astype(np.int64),
        "grp": rng.integers(0, 1024, npr).astype(np.int64)},
        rng.random(npr) < 0.95, device=dev)
    delta = Table.from_numpy({
        "key": rng.integers(0, 400_000, 50_000).astype(np.int64),
        "build_payload": rng.integers(0, 1 << 40, 50_000).astype(np.int64)},
        np.ones(50_000, bool), device=dev)
    return build, probe, delta


def _host_multiset(table):
    cols, valid = table.to_numpy()
    names = sorted(cols)
    a = np.stack([cols[n][valid].astype(np.int64) for n in names], 1)
    return names, a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("ranks,k", [(1, 1), (1, 3), (4, 2)])
def test_resident_registry_on_card_equals_cpu(card, ranks, k):
    """Register, probe-only join, append, merge and re-probe on the card
    (the join kernels on every probe batch, the run sorts and the int64
    wrapping key-hash sums on CUDA) equal to the same calls on the CPU:
    rows as multisets, totals, the conservation pairs and generations."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    out = []
    for dev in (card, torch.device("cpu")):
        build, probe, delta = _resident_tables(dev)
        comm = LocalCommunicator() if ranks == 1 else \
            EmulatedCommunicator(ranks)
        reg = ResidentTableRegistry(comm, JoinProgramCache(comm))
        reg.register("dim", build)
        _kernels.reset_launch_counts(scan.join_scans, join_mod.compact_records,
                                     expand.expand_gather)
        first = reg.join("dim", probe, over_decomposition=k)
        if dev.type == "cuda":
            assert scan.join_scans.launches == ranks * k
            assert join_mod.compact_records.launches == ranks * k
            assert expand.expand_gather.launches == ranks * k
        reg.append("dim", delta, maintain=True)
        second = reg.join("dim", probe, over_decomposition=k)
        h = reg.get("dim")
        out.append([(int(r.total), bool(r.overflow), _host_multiset(r.table))
                    for r in (first, second)]
                   + [(h.rows, h.key_digest, h.generation, h.merges)])
    (g1, g2, gs), (c1, c2, cs) = out
    assert gs == cs
    for g, c in ((g1, c1), (g2, c2)):
        assert g[:2] == c[:2] and not g[1]
        assert g[2][0] == c[2][0]
        np.testing.assert_array_equal(g[2][1], c[2][1])


@pytest.mark.parametrize("mode", ["key", "probe"])
def test_probe_only_aggregate_on_card_equals_cpu(card, mode):
    """The probe-only fused aggregate on the card (key mode; probe mode
    with the cross-batch combine at k = 2) equal to the CPU's: integer
    lanes exactly."""
    from distributed_join_tpu_torch.ops import aggregate as A
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    group = "key" if mode == "key" else "grp"
    spec = A.AggregateSpec.of(group, [("count", None),
                                      ("sum", "probe_payload"),
                                      ("sum", "build_payload")])
    frames = []
    for dev in (card, torch.device("cpu")):
        build, probe, _ = _resident_tables(dev, seed=4)
        reg = ResidentTableRegistry(LocalCommunicator())
        reg.register("dim", build)
        res = reg.join("dim", probe, aggregate=spec,
                       over_decomposition=1 if mode == "key" else 2)
        assert not bool(res.overflow)
        frames.append((int(res.total),
                       A.groups_frame(res.table, spec, [group])))
    (gt, got), (ct, want) = frames
    assert gt == ct and len(want[group]) > 0
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def test_mixed_dtype_composite_key_on_card_equals_cpu(card):
    """The micro-batch's key (int64 key, int32 ``#batch``) on the kernel
    pipeline: K = 8 colliding requests combined, joined on the card and
    on the CPU, split per request; each request's rows equal."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.service import batching
    rng = np.random.default_rng(6)
    reqs = []
    for i in range(8):
        b = {"key": rng.permutation(5000)[:4000].astype(np.int64),
             "bv": np.arange(4000, dtype=np.int64) + 10_000 * i}
        p = {"key": rng.integers(0, 5000, 6000).astype(np.int64),
             "pv": np.arange(6000, dtype=np.int64) + 100_000 * i}
        reqs.append((b, p))
    outs = []
    for dev in (card, torch.device("cpu")):
        mb = batching.combine([
            (Table.from_numpy(b, np.ones(4000, bool), device=dev),
             Table.from_numpy(p, np.ones(6000, bool), device=dev))
            for b, p in reqs])
        _kernels.reset_launch_counts(scan.join_scans)
        res = distributed_inner_join(mb.build, mb.probe, LocalCommunicator(),
                                     key=list(mb.key), out_capacity_factor=1.5)
        if dev.type == "cuda":
            assert scan.join_scans.launches == 1
        assert not bool(res.overflow)
        outs.append(batching.split(res, mb, with_rows=True))
    for g, c in zip(*outs):
        assert g["matches"] == c["matches"] > 0
        for name in c["rows"]:
            np.testing.assert_array_equal(np.sort(g["rows"][name]),
                                          np.sort(c["rows"][name]))


def test_trace_nests_the_join_kernels_in_the_join_span(card, tmp_path):
    """A telemetry session with the device trace on around a join on the
    card: the profiler's trace holds every launch of ``join_scans``,
    ``stream_compact`` and ``expand_gather`` inside a ``join`` span, the
    spans line up with the kernels; and the session changes neither the
    launches nor the rows."""
    import re

    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.telemetry.export import (
        device_trace_kernels,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    build, probe = generate_build_probe_tables(
        seed=3, build_nrows=1 << 20, probe_nrows=1 << 20, device=card)
    wrappers = (scan.join_scans, join_mod.compact_records,
                join_mod.pack_matched_builds, expand.expand_gather)

    def counted_join():
        _kernels.reset_launch_counts(*wrappers)
        res = distributed_inner_join(build, probe, LocalCommunicator(),
                                     over_decomposition=2,
                                     out_capacity_factor=2.0)
        torch.cuda.synchronize()
        return res, [w.launches for w in wrappers]

    off, off_counts = counted_join()
    with telemetry.session(str(tmp_path / "tel"), trace=True) as sink:
        telemetry.maybe_start_device_trace()
        on, on_counts = counted_join()
        path = telemetry.stop_device_trace()
        events_path = sink.events_path
    assert on_counts == off_counts and min(on_counts) > 0
    assert int(on.total) == int(off.total) > 0
    sums = [sum(int(torch.where(r.table.valid, c.to(torch.int64), 0).sum())
                for c in r.table.columns.values()) for r in (off, on)]
    assert sums[0] == sums[1]
    kernels = device_trace_kernels(path, "join")
    found = {}
    for src, names in (("join_scans", ("r_pass", "f_pass")),
                       ("stream_compact", ("compact_kernel",)),
                       ("expand_gather", ("expand_kernel",))):
        hits = [v for k, v in kernels.items()
                if any(re.search(rf"\b{n}\b", k) for n in names)]
        found[src] = (sum(h["launches"] for h in hits),
                      sum(h["inside"] for h in hits))
        assert found[src][0] > 0 and found[src][0] == found[src][1], found
    with open(events_path) as f:
        spans = [json.loads(line)["name"] for line in f]
    assert {"partition", "shuffle", "join"} <= set(spans)


def test_daemon_warm_request_run_only_equals_in_process_join(card):
    """The join service's daemon on the card, over TCP on localhost: the
    warm repeat of a wire join builds no program and launches the join
    kernels, and its matches equal an in-process join of the tables the
    same spec generates."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.service import server
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    svc = server.JoinService(LocalCommunicator())
    assert svc.device.type == "cuda"
    daemon, port = server.start_daemon(svc)
    client = server.ServiceClient("127.0.0.1", port)
    spec = {"op": "join", "build_nrows": 300_000, "probe_nrows": 200_000,
            "seed": 5, "selectivity": 0.3, "out_capacity_factor": 2.0}
    try:
        cold = client.send(dict(spec))
        torch.cuda.synchronize()
        _kernels.reset_launch_counts(scan.join_scans,
                                     join_mod.compact_records,
                                     expand.expand_gather)
        warm = client.send(dict(spec))
        torch.cuda.synchronize()
        assert cold["ok"] and warm["ok"], (cold, warm)
        assert cold["new_traces"] == 1 and warm["new_traces"] == 0
        assert scan.join_scans.launches >= 1
        assert join_mod.compact_records.launches >= 1
        assert expand.expand_gather.launches >= 1
        build, probe = generate_build_probe_tables(
            seed=5, build_nrows=300_000, probe_nrows=200_000)
        want = int(distributed_inner_join(build, probe, LocalCommunicator(),
                                          out_capacity_factor=2.0).total)
        assert warm["matches"] == cold["matches"] == want > 0
        assert client.send({"op": "shutdown"})["ok"]
    finally:
        client.close()
        daemon.server_close()


def test_resident_wire_probe_at_registration_seed_is_the_generators(card):
    """A resident wire join whose seed is the registration seed draws,
    on the card, the probe ``generate_build_probe_tables(seed)`` draws,
    and its matches equal the full join of that pair."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.service import server
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    svc = server.JoinService(LocalCommunicator())
    daemon, port = server.start_daemon(svc)
    client = server.ServiceClient("127.0.0.1", port)
    try:
        assert client.send({"op": "register", "name": "dim",
                            "rows": 1_000_000, "seed": 42})["ok"]
        spec = {"op": "join", "table": "dim", "probe_nrows": 1 << 18,
                "seed": 42}
        drawn = server._probe_from_spec(spec, svc.resident.get("dim"), None)
        build, probe = generate_build_probe_tables(
            seed=42, build_nrows=1_000_000, probe_nrows=1 << 18)
        for c in probe.columns:
            assert torch.equal(drawn.columns[c], probe.columns[c])
        resp = client.send(spec)
        want = int(distributed_inner_join(build, probe,
                                          LocalCommunicator()).total)
        assert resp["ok"] and resp["matches"] == want > 0
        assert client.send({"op": "shutdown"})["ok"]
    finally:
        client.close()
        daemon.server_close()


@pytest.mark.parametrize("opts", [
    dict(n=4), dict(n=4, shuffle="ragged", over_decomposition=2),
    dict(n=4, compression_bits=32), dict(n=4, slices=2,
                                         shuffle="hierarchical",
                                         dcn_codec="on"),
    dict(n=4, join_type="anti"), dict(n=4, sort_mode="segmented",
                                      sort_segments=2),
], ids=str)
def test_tape_on_card_equals_cpu(card, opts):
    """A join with the metrics tape on the card gives the CPU's counters,
    rank by rank (the hand kernels on the card, their twins on the CPU),
    and each side's wire bytes equal its plan's; the explain record of
    the run is the same on both devices."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    opts = dict(opts)
    n, slices = opts.pop("n"), opts.pop("slices", 1)
    b, p = generate_build_probe_tables(seed=5, build_nrows=60_000,
                                       probe_nrows=80_000, rand_max=30_000,
                                       device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        tb, tp = (Table({k: c.to(dev) for k, c in t.columns.items()},
                        t.valid.to(dev)) for t in (b, p))
        res = distributed_inner_join(
            tb, tp, EmulatedCommunicator(n, n_slices=slices),
            with_metrics=True, explain=True, out_capacity_factor=3.0, **opts)
        assert not bool(res.overflow)
        out[dev] = (res.telemetry.to_dict(),
                    json.dumps(res.plan.explain_record(), sort_keys=True),
                    int(res.total))
    assert out["cuda"] == out["cpu"]
    red, doc, _ = out["cuda"]
    plan = json.loads(doc)["plan"]
    if plan["wire"]["exact"]:
        for side in ("build", "probe"):
            assert red["reduced"][f"{side}.wire_bytes"] == \
                plan["wire"][side]["bytes_total"]


def test_explain_on_card_equals_cpu_and_touches_no_device(card):
    """``explain_join`` of tables on the card and on the CPU gives the
    same record and allocates nothing on the card."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
    )
    from distributed_join_tpu_torch.planning.plan import explain_join
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    b, p = generate_build_probe_tables(seed=5, build_nrows=60_000,
                                       probe_nrows=80_000, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = explain_join(b, p, EmulatedCommunicator(4), over_decomposition=2)
    assert torch.cuda.memory_allocated() == before
    cpu = [Table({k: c.cpu() for k, c in t.columns.items()}, t.valid.cpu())
           for t in (b, p)]
    want = explain_join(*cpu, EmulatedCommunicator(4), over_decomposition=2)
    assert json.dumps(got.explain_record(), sort_keys=True) == \
        json.dumps(want.explain_record(), sort_keys=True)


def test_stage_profile_on_card_launches_the_join_kernels(card):
    """A stage profile at 1 M x 1 M, one rank at k = 4, on the card: the
    join segment launches the scans, both compactions and the expand
    once a batch a call; each stage's counters equal the tape-on
    monolithic join's and the CPU profile's; the record names the
    device type."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.telemetry import stageprof
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    b, p = generate_build_probe_tables(seed=5, build_nrows=1_000_000,
                                       probe_nrows=1_000_000, device="cpu")
    comm, k, repeats = LocalCommunicator(), 4, 2
    recs = {}
    for dev in ("cpu", "cuda"):
        tb, tp = (Table({n: c.to(dev) for n, c in t.columns.items()},
                        t.valid.to(dev)) for t in (b, p))
        wrappers = (scan.join_scans, join_mod.compact_records,
                    join_mod.pack_matched_builds, expand.expand_gather)
        _kernels.reset_launch_counts(*wrappers)
        rec = stageprof.profile_join_stages(
            comm, tb, tp, repeats=repeats, over_decomposition=k).as_record()
        if dev == "cuda":
            # the join segment and the monolithic step, warm-up and
            # repeats: k batches a call
            for w in wrappers:
                assert w.launches == 2 * (repeats + 1) * k, w.__name__
        mono = distributed_inner_join(tb, tp, comm, with_metrics=True,
                                      over_decomposition=k)
        red = mono.telemetry.to_dict()["reduced"]
        for st in ("partition", "shuffle", "join"):
            assert rec["stages"][st]["ran"]
            for name, v in rec["stages"][st]["counters"].items():
                assert red[name] == v, (st, name)
        assert rec["platform"] == dev and not rec["overflow"]
        recs[dev] = {s: v["counters"] for s, v in rec["stages"].items()}
    assert recs["cuda"] == recs["cpu"]


def test_tuned_warm_repeat_on_card_builds_no_program(card, tmp_path):
    """The autotuner's warm contract at 1 M x 1 M on the card: the cold
    join escalates (out_capacity_factor 0.1), and fed its history line,
    the repeat builds no program, runs one ``tuned_presize`` attempt at
    the cold run's final rung and launches the join kernels with the cold
    run's total."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.planning.tuner import JoinTuner
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.telemetry import history
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    b, p = generate_build_probe_tables(seed=5, build_nrows=1_000_000,
                                       probe_nrows=1_000_000, device=card)
    comm = LocalCommunicator()
    cache, tuner = JoinProgramCache(comm), JoinTuner()
    store = history.WorkloadHistory(str(tmp_path / "h.jsonl"))
    cold = distributed_inner_join(b, p, comm, auto_retry=6,
                                  program_cache=cache, tuner=tuner,
                                  out_capacity_factor=0.1)
    assert cold.retry_report.n_attempts >= 3 and cold.retry_report.resolved
    store.append(history.request_entry(
        request_id="cold", op="join", signature=cold.tuned["signature"],
        outcome="served", wall_s=0.0,
        retry_record=cold.retry_report.as_record(), tuned=cold.tuned))
    tuner.load(store.path)
    traces = cache.traces
    _kernels.reset_launch_counts(scan.join_scans, expand.expand_gather)
    warm = distributed_inner_join(b, p, comm, auto_retry=6,
                                  program_cache=cache, tuner=tuner,
                                  out_capacity_factor=0.1)
    assert cache.traces == traces
    final = cold.retry_report.attempts[-1].attempt
    assert [(a.attempt, a.action) for a in warm.retry_report.attempts] == [
        (final, "tuned_presize")]
    assert int(warm.total) == int(cold.total)
    assert scan.join_scans.launches == expand.expand_gather.launches == 1


def _on(t, dev):
    return Table({k: c.to(dev) for k, c in t.columns.items()},
                 t.valid.to(dev))


def test_integrity_digests_on_card_equal_cpu(card):
    """The digest functions on the card give the CPU's bits: every dtype
    the shuffles carry, the block sums and the segment sums (int64
    wrapping sums and cumsums on both)."""
    from distributed_join_tpu_torch.parallel import integrity
    rng = np.random.default_rng(11)
    rows = 1 << 16
    cols = {"k64": rng.integers(-2**63, 2**63 - 1, rows, dtype=np.int64),
            "k32": rng.integers(-2**31, 2**31 - 1, rows, dtype=np.int32),
            "f32": rng.standard_normal(rows).astype(np.float32),
            "f64": rng.standard_normal(rows),
            "s": rng.integers(0, 256, (rows, 16), dtype=np.uint8),
            "odd": rng.integers(0, 256, (rows, 3), dtype=np.uint8)}
    host = {k: torch.from_numpy(v) for k, v in cols.items()}
    dev = {k: v.to(card) for k, v in host.items()}
    assert torch.equal(integrity.row_digests(dev).cpu(),
                       integrity.row_digests(host))
    blk = {k: v.reshape((8, rows // 8) + tuple(v.shape[1:]))
           for k, v in host.items()}
    counts = torch.tensor([0, 1, 8191, 8192, 5000, 17, 4096, 3],
                          dtype=torch.int32)
    want = integrity.padded_block_digests(blk, counts)
    got = integrity.padded_block_digests(
        {k: v.to(card) for k, v in blk.items()}, counts.to(card))
    assert torch.equal(got.cpu(), want)
    rd = integrity.row_digests(host)
    starts, sizes = [0, 7, 60_000, 65_000], [7, 59_993, 5_000, 1_000]
    assert torch.equal(
        integrity.segment_digests(rd.to(card), starts, sizes).cpu(),
        integrity.segment_digests(rd, starts, sizes))


@pytest.mark.parametrize("wire", [
    dict(), dict(shuffle="ragged", over_decomposition=2),
    dict(compression_bits=32), dict(shuffle="ppermute"),
    dict(slices=2, shuffle="hierarchical", dcn_codec="on"),
    dict(sort_mode="segmented", sort_segments=2),
], ids=str)
def test_integrity_verified_join_on_card_equals_cpu(card, wire):
    """A verified join over 4 emulated ranks on the card: a clean report
    of 2 n^2 pairs, every digest lane the CPU's, the join kernels
    launched; a one-unit bit flip recovers through ``retry_integrity``."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    opts = dict(wire)
    slices = opts.pop("slices", 1)
    b, p = generate_build_probe_tables(seed=5, build_nrows=60_000,
                                       probe_nrows=80_000, rand_max=30_000,
                                       device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        tb, tp = _on(b, dev), _on(p, dev)
        _kernels.reset_launch_counts(scan.join_scans)
        res = distributed_inner_join(
            tb, tp, EmulatedCommunicator(4, n_slices=slices),
            verify_integrity=True, out_capacity_factor=3.0, **opts)
        rep = res.integrity_report
        assert rep.ok and rep.checked_pairs == 2 * 4 * 4
        per_rank = res.telemetry.to_dict()["per_rank"]
        out[dev] = ({k: v for k, v in per_rank.items()
                     if ".integrity." in k}, int(res.total))
        if dev == "cuda" and wire.get("sort_mode") != "segmented":
            assert scan.join_scans.launches > 0
    assert out["cuda"] == out["cpu"]
    comm = FaultInjectingCommunicator(
        EmulatedCommunicator(4, n_slices=slices),
        FaultPlan(seed=5, corrupt_mode="bit_flip", corrupt_collectives=1))
    res = distributed_inner_join(_on(b, card), _on(p, card), comm,
                                 verify_integrity=True, auto_retry=2,
                                 out_capacity_factor=3.0, **opts)
    assert [a.action for a in res.retry_report.attempts] == [
        "initial", "retry_integrity"]
    assert int(res.total) == out["cpu"][1]


def test_integrity_batch_loop_on_card(card):
    """The batch loop's verified path on the card (the metrics block
    copied to pinned memory beside the total): a clean run is the plain
    run; a corrupted batch program fails every batch under ``raise`` and
    ``continue`` alike, and no corrupt total is counted."""
    from distributed_join_tpu_torch.parallel import out_of_core as ooc
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )
    from distributed_join_tpu_torch.parallel.integrity import IntegrityError
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    b, p = generate_build_probe_tables(seed=9, build_nrows=200_000,
                                       probe_nrows=200_000, device=card)
    opts = dict(n_batches=4, warmup=False, out_capacity_factor=3.0,
                shuffle_capacity_factor=3.0)
    want = ooc.keyrange_batched_join(b, p, EmulatedCommunicator(4), **opts)
    assert ooc.keyrange_batched_join(b, p, EmulatedCommunicator(4),
                                     verify_integrity=True, **opts) == want
    plan = FaultPlan(seed=5, corrupt_mode="bit_flip", corrupt_collectives=1)
    with pytest.raises(IntegrityError):
        ooc.keyrange_batched_join(
            b, p, FaultInjectingCommunicator(EmulatedCommunicator(4), plan),
            verify_integrity=True, **opts)
    stats = {}
    total, _ = ooc.keyrange_batched_join(
        b, p, FaultInjectingCommunicator(EmulatedCommunicator(4), plan),
        verify_integrity=True, on_batch_failure="continue", stats=stats,
        **opts)
    assert total == 0 and stats["failed_batches"] == [0, 1, 2, 3]


def test_fleet_of_two_in_process_replicas_equals_the_direct_join(
        card, tmp_path):
    """Two in-process replicas on the card behind the fleet's router,
    K = 2 replication: a registered table on both holders, a probe-only
    join and a wire join each equal to a direct ``JoinService`` on the
    same card, the warm repeat on the same replica with no program built,
    and the join kernels launched on the fleet's requests."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.service import fleet, server

    cfg = fleet.FleetConfig(n_replicas=2, replica_ranks=1,
                            table_replication=2, probe_interval_s=30.0,
                            persist_dir=str(tmp_path / "programs"),
                            coord_dir=str(tmp_path / "coord"))
    router = fleet.FleetRouter(fleet.in_process_fleet_factory(
        2, 1, persist_dir=cfg.persist_dir, device="cuda"), cfg)
    router.start()
    rserver, rport = fleet.start_router_daemon(router)
    client = server.ServiceClient("127.0.0.1", rport)
    direct = server.JoinService(LocalCommunicator())
    reg = {"op": "register", "name": "t", "rows": 400_000, "seed": 3,
           "unique_keys": True}
    probe = {"op": "join", "table": "t", "probe_nrows": 65_536, "seed": 4}
    wire = {"op": "join", "build_nrows": 300_000, "probe_nrows": 200_000,
            "seed": 5, "selectivity": 0.3, "out_capacity_factor": 2.0}
    try:
        r = client.send(reg)
        assert r["ok"] and sorted(r["fleet"]["holders"]) == [0, 1], r
        build, state = server._build_from_spec(reg, direct.device)
        direct.register_table("t", build, wire_spec={
            k: reg[k] for k in ("rows", "seed", "unique_keys")},
            wire_probe_state=state)
        handle = direct.resident.get("t")
        want_p = direct.resident_join(
            "t", server._probe_from_spec(probe, handle, direct.device))
        want_w = direct.join(*server._tables_from_spec(wire, direct.device),
                             out_capacity_factor=2.0)
        for spec, want in ((probe, want_p), (wire, want_w)):
            cold = client.send(dict(spec))
            torch.cuda.synchronize()
            _kernels.reset_launch_counts(scan.join_scans,
                                         join_mod.compact_records,
                                         expand.expand_gather)
            warm = client.send(dict(spec))
            torch.cuda.synchronize()
            assert cold["ok"] and warm["ok"], (cold, warm)
            assert warm["fleet"]["replica"] == cold["fleet"]["replica"]
            assert cold["new_traces"] == 1 and warm["new_traces"] == 0
            assert warm["matches"] == cold["matches"] == want.matches > 0
            assert scan.join_scans.launches >= 1
            assert join_mod.compact_records.launches >= 1
            assert expand.expand_gather.launches >= 1
    finally:
        client.close()
        rserver.shutdown()
        rserver.server_close()
        router.stop()


def test_program_cache_disk_tier_restart_on_card(card, tmp_path):
    """The disk tier on the card: the entry binds the card's name and
    capability, the CUDA version and the three join kernels by their
    source digests; a fresh cache binds it (``source == "disk"``, no
    trace, one disk load) with the kernels loaded before the first
    request (``preload``), and the totals equal; an entry naming another
    kernel digest is a counted miss."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.service import programs
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    b, p = generate_build_probe_tables(seed=7, build_nrows=300_000,
                                       probe_nrows=300_000, device=card)
    d = str(tmp_path / "programs")
    c1 = programs.JoinProgramCache(LocalCommunicator(), persist_dir=d)
    e1, _ = c1.get(b, p, key="key", out_capacity_factor=2.0)
    assert e1.persisted and e1.source == "trace"
    total = int(e1(b, p).total)
    (name,) = [f for f in os.listdir(d) if f.endswith(".joinprog")]
    doc = json.load(open(os.path.join(d, name)))
    assert doc["backend"]["device_type"] == "cuda"
    assert doc["backend"]["device_name"] == torch.cuda.get_device_name(0)
    assert doc["backend"]["capability"] == list(
        torch.cuda.get_device_capability(0))
    assert doc["backend"]["cuda"] == torch.version.cuda
    assert sorted(doc["kernels"]) == sorted(programs.PROGRAM_KERNELS)
    for kname, lib in doc["kernels"].items():
        assert lib == _kernels._library_path(kname).name
    c2 = programs.JoinProgramCache(LocalCommunicator(), persist_dir=d)
    assert c2.preload() == 1
    e2, hit = c2.get(b, p, key="key", out_capacity_factor=2.0)
    assert not hit and e2.source == "disk"
    st = c2.stats()
    assert (st["traces"], st["disk_loads"], st["disk_load_failures"]) == (
        0, 1, 0)
    assert int(e2(b, p).total) == total > 0
    doc["kernels"]["join_scans"] = "join_scans-0000000000000000.so"
    programs.atomic_write_json(os.path.join(d, name), doc)
    c3 = programs.JoinProgramCache(LocalCommunicator(), persist_dir=d)
    e3, _ = c3.get(b, p, key="key", out_capacity_factor=2.0)
    assert e3.source == "trace"
    assert (c3.stats()["traces"], c3.stats()["disk_load_failures"]) == (1, 1)


def _join_launches():
    return (scan.join_scans, join_mod.compact_records,
            join_mod.pack_matched_builds, expand.expand_gather)


def test_chaos_soak_on_card_grades_clean(card):
    """The seeded soak on the card (``parallel/chaos.py``, 8 emulated
    ranks, the GPU by default): ``soak(42, 4)`` grades 0 failures over the
    four config families, every trial's join launched the join kernels,
    and ``--trial K`` replays trial K's record."""
    from distributed_join_tpu_torch.parallel import chaos

    torch.cuda.synchronize()
    _kernels.reset_launch_counts(*_join_launches())
    summary = chaos.soak(42, 4, repro_out=None)
    torch.cuda.synchronize()
    assert summary["failures"] == 0, summary
    assert summary["device"] == "cuda"
    assert [r["config"]["mode"] for r in summary["records"]] == \
        list(chaos.CONFIGS)
    for w in _join_launches():
        assert w.launches >= 4, w.__name__
    rec = summary["records"][2]
    (again,) = chaos.soak(42, 1, only_trial=2, repro_out=None)["records"]
    for f in ("config", "fault_plan", "verdict", "expected_total",
              "got_total"):
        assert again[f] == rec[f], f


def test_chaos_hier_and_tuner_slices_on_card(card):
    """Two hierarchical trials and the poisoned-history tuner slice on
    the card: never a FAILED verdict; the tuner pre-sized from the lie
    and learned the escalated rung."""
    from distributed_join_tpu_torch.parallel import chaos

    hier = chaos.hier_slice(42, 2)
    assert hier["failures"] == 0 and hier["device"] == "cuda", hier
    tuner = chaos.tuner_slice(7, 2)
    assert tuner["failures"] == 0, tuner
    for rec in tuner["records"]:
        assert rec["tuner_presized"] and rec["tuner_corrected"], rec


@pytest.mark.parametrize("mode", ["bit_flip", "row_truncate",
                                  "row_duplicate", "misroute"])
def test_chaos_corruption_mode_on_card_detected_or_recovered(card, mode):
    """A chaos-graded trial of each corruption mode on the card, on the
    padded and ragged wires: detected or recovered, never FAILED (never
    silently joined), the budget spent."""
    from distributed_join_tpu_torch.parallel import chaos
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )

    config = {"build_rows": 1024, "probe_rows": 2048, "rand_max": 700,
              "selectivity": 0.5, "table_seed": 11, "auto_retry": 2}
    for shuffle in ("padded", "ragged"):
        b, p = chaos._tables(config, card)
        cols, total = chaos._oracle(b, p)
        comm = FaultInjectingCommunicator(
            EmulatedCommunicator(4),
            FaultPlan(seed=5, corrupt_mode=mode, corrupt_collectives=1,
                      corrupt_rank=1))
        out = chaos._graded_join(
            b, p, comm, config,
            dict(out_capacity_factor=3.0, shuffle_capacity_factor=3.0,
                 shuffle=shuffle), cols, total, True,
            chaos._loud(True, total))
        assert out.verdict in ("detected", "recovered", "ok"), out
        assert not out.failed and comm._corruptions == 1
