"""The port's CUDA kernels against their plain twins on the card, at
edge-case shapes (tile boundaries, one element, no survivors, truncated
capacities, more lanes than one launch carries, unaligned views,
all-equal keys, and every arrangement of dead and live radix digits).
Every test needs a CUDA device and the CUDA toolkit; without them each
skips, decided in the ``card`` fixture. Run on a machine with a GPU:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

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
