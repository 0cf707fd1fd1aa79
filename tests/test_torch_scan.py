"""The carry algebra of ``csrc/join_scans.cu`` on the CPU.

The kernel cannot run here, so this file copies its combine rules, its
per-thread folds, its scans and its look-back into plain Python, composes
them in the kernel's order, and holds the six outputs against the JAX
package's ``join_scans_reference``:

- a tile is ``threads`` threads of ``items`` positions; a thread folds
  its positions left to right (``r_fold``, ``f_fold``);
- a warp scans its lanes by shuffles (``warp_scan``: Hillis-Steele, the
  reverse pass from the last lane down), then one warp scans the warps'
  totals the same way;
- each tile publishes its total, then looks back over the tiles before
  it in scan order (the reverse pass: the tiles to its right) in windows
  of 32, combining up to the nearest inclusive prefix;
- each thread walks its positions from its incoming summary and emits
  the outputs (``r_emit``, ``f_emit``).

Tiles of 1, 7, 16 and 4096 positions and several thread widths, on
arbitrary tags (runs that span several tiles, ``first[0]`` False) and on
merged layouts.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import scan_pallas as jsc
from distributed_join_tpu_torch.ops import scan as tsc

M32 = 0xFFFFFFFF
WARP = 32


# -- the reverse summary: (q, has) ----------------------------------------

R_ID = (0, 0)


def r_combine(l, r):
    return (l[0] if l[1] else l[0] + r[0], l[1] | r[1])


def r_fold(tag, first):
    q = has = 0
    for t, f in zip(tag, first):
        has |= int(f)
        q += int(not has and t == 1)
    return (q, has)


def r_emit(tag, first, right):
    q, out = right[0], [0] * len(tag)
    for j in range(len(tag) - 1, -1, -1):
        c = q + (tag[j] == 1)
        out[j] = int(tag[j] == 0 and c > 0)
        q = 0 if first[j] else c
    return out


# -- the forward summary ----------------------------------------------------

F_KEYS = ("nB", "nM", "has", "endOpenB", "endLM", "npre", "nrecPre0",
          "nrecPost", "sumPre", "sumPost")
F_ID = dict.fromkeys(F_KEYS, 0)


def f_combine(l, r):
    o = {"nB": l["nB"] + r["nB"], "nM": l["nM"] + r["nM"],
         "has": l["has"] | r["has"]}
    o["endOpenB"] = (r["endOpenB"] if r["has"] else
                     l["endOpenB"] + r["nB"] if l["has"] else 0)
    o["endLM"] = (l["nM"] + r["endLM"] if r["has"] else
                  l["endLM"] if l["has"] else 0)
    if l["has"]:
        o["npre"], o["sumPre"] = l["npre"], l["sumPre"]
        o["nrecPre0"] = l["nrecPre0"]
        o["sumPost"] = (l["sumPost"] + r["sumPost"] + r["sumPre"]
                        + r["npre"] * l["endOpenB"]) & M32
        o["nrecPost"] = l["nrecPost"] + r["nrecPost"] + (
            r["npre"] if l["endOpenB"] > 0 else r["nrecPre0"])
    else:
        o["npre"] = l["npre"] + r["npre"]
        o["sumPre"] = (l["sumPre"] + r["sumPre"] + r["npre"] * l["nB"]) & M32
        o["nrecPre0"] = l["nrecPre0"] + (
            r["npre"] if l["nB"] > 0 else r["nrecPre0"])
        o["sumPost"] = (l["sumPost"] + r["sumPost"]) & M32
        o["nrecPost"] = l["nrecPost"] + r["nrecPost"]
    return o


def f_fold(tag, first, matched):
    a = dict(F_ID)
    for t, f, m in zip(tag, first, matched):
        b = int(t == 0)
        if f:
            a["has"], a["endOpenB"], a["endLM"] = 1, 0, a["nM"]
        elif t == 1:
            if a["has"]:
                a["sumPost"] = (a["sumPost"] + a["endOpenB"]) & M32
                a["nrecPost"] += int(a["endOpenB"] > 0)
            else:
                a["npre"] += 1
                a["sumPre"] = (a["sumPre"] + a["nB"]) & M32
                a["nrecPre0"] += int(a["nB"] > 0)
        a["nB"] += b
        a["nM"] += int(m != 0)
        a["endOpenB"] += b if a["has"] else 0
    return a


def f_emit(tag, first, matched, acc):
    open_b = acc["endOpenB"] if acc["has"] else acc["nB"]
    csum = (acc["sumPre"] + acc["sumPost"]) & M32
    recs = acc["nrecPre0"] + acc["nrecPost"]
    nm = acc["nM"]
    lm = acc["endLM"] if acc["has"] else 0
    rows = []
    for t, f, m in zip(tag, first, matched):
        if f:
            open_b, lm = 0, nm
        c = open_b if t == 1 else 0
        recs += int(c > 0)
        nm += int(m != 0)
        rows.append((c, csum, lm, recs - 1, nm - 1))
        csum = (csum + c) & M32
        open_b += int(t == 0)
    return rows


# -- scans and the look-back, in the kernel's order --------------------------


def warp_scan(vals, comb, ident, rev):
    """Hillis-Steele over one warp's lanes (shfl_up / shfl_down)."""
    v = list(vals)
    lanes, d = len(v), 1
    while d < lanes:
        if rev:
            v = [comb(v[i], v[i + d]) if i + d < lanes else v[i]
                 for i in range(lanes)]
        else:
            v = [comb(v[i - d], v[i]) if i >= d else v[i]
                 for i in range(lanes)]
        d *= 2
    ex = ([v[i + 1] for i in range(lanes - 1)] + [ident] if rev
          else [ident] + v[:-1])
    return v, ex


def tile_contexts(sums, comb, ident, rev):
    """Each thread's summary of the tile's threads before it in scan
    order (a warp scan, then one warp over the warps' totals), and the
    tile's total."""
    warps = [sums[i:i + WARP] for i in range(0, len(sums), WARP)]
    scans = [warp_scan(w, comb, ident, rev) for w in warps]
    totals = [inc[0] if rev else inc[-1] for inc, _ in scans]
    winc, wex = warp_scan(totals, comb, ident, rev)
    ctx = []
    for w, (_, ex) in enumerate(scans):
        ctx += [comb(e, wex[w]) if rev else comb(wex[w], e) for e in ex]
    return ctx, winc[0] if rev else winc[-1]


def look_back(published, tile, comb, ident, rev):
    """The summary of every tile before ``tile`` in scan order, from the
    tiles' published (flag, summary) pairs, 32 at a time up to the
    nearest inclusive one. Forward lane l reads tile p - 31 + l; reverse
    lane l reads tile p + l."""
    nt = len(published)
    acc, p = ident, (tile + 1 if rev else tile - 1)
    while True:
        idx = [p + l if rev else p - 31 + l for l in range(WARP)]
        got = [published[i] if 0 <= i < nt else ("incl", ident) for i in idx]
        incl = [k for k, (flag, _) in enumerate(got) if flag == "incl"]
        if rev:
            keep = range(0, incl[0] + 1) if incl else range(WARP)
        else:
            keep = range(incl[-1], WARP) if incl else range(WARP)
        window = [got[k][1] if k in keep else ident for k in range(WARP)]
        inc, _ = warp_scan(window, comb, ident, rev)
        if rev:
            acc = comb(acc, inc[0])
        else:
            acc = comb(inc[-1], acc)
        if incl:
            return acc
        p = p + WARP if rev else p - WARP


def kernel_scans(tag, first, items, threads):
    """The six outputs as the kernel composes them, with the tiles
    processed in scan order and an arbitrary mix of AGG and INCL flags."""
    n = len(tag)
    tile_n = items * threads
    nt = -(-n // tile_n)
    pad = nt * tile_n - n
    tag = list(tag) + [2] * pad
    first = [int(f) for f in first] + [0] * pad
    rng = np.random.default_rng(n + tile_n)

    def chunk(a, tile, t):
        lo = tile * tile_n + t * items
        return a[lo:lo + items]

    # reverse pass: tiles claimed from the last
    matched = [0] * len(tag)
    pub = [None] * nt
    for tile in range(nt - 1, -1, -1):
        sums = [r_fold(chunk(tag, tile, t), chunk(first, tile, t))
                for t in range(threads)]
        ctx, total = tile_contexts(sums, r_combine, R_ID, rev=True)
        right = R_ID if tile == nt - 1 else look_back(pub, tile, r_combine,
                                                      R_ID, rev=True)
        for t in range(threads):
            lo = tile * tile_n + t * items
            matched[lo:lo + items] = r_emit(chunk(tag, tile, t),
                                            chunk(first, tile, t),
                                            r_combine(ctx[t], right))
        # leave some tiles at AGG: a later tile must walk past them
        pub[tile] = (("incl", r_combine(total, right)) if rng.random() < 0.5
                     or tile == nt - 1 else ("agg", total))

    rows = [None] * len(tag)
    pub = [None] * nt
    for tile in range(nt):
        sums = [f_fold(chunk(tag, tile, t), chunk(first, tile, t),
                       chunk(matched, tile, t)) for t in range(threads)]
        ctx, total = tile_contexts(sums, f_combine, F_ID, rev=False)
        left = F_ID if tile == 0 else look_back(pub, tile, f_combine, F_ID,
                                                rev=False)
        for t in range(threads):
            lo = tile * tile_n + t * items
            rows[lo:lo + items] = f_emit(chunk(tag, tile, t),
                                         chunk(first, tile, t),
                                         chunk(matched, tile, t),
                                         f_combine(left, ctx[t]))
        pub[tile] = (("incl", f_combine(left, total)) if rng.random() < 0.5
                     or tile == 0 else ("agg", total))

    cols = np.array(rows[:n], dtype=np.int64).reshape(n, 5)
    as_i32 = cols.astype(np.uint32).view(np.int32)
    out = {k: as_i32[:, j] for j, k in enumerate(
        ("cnt", "start_out", "lo_m", "rec_pos", "mb_pos"))}
    out["matched"] = np.array(matched[:n], np.int32)
    return out


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


def _check(tag, first, items, threads):
    want = jsc.join_scans_reference(jnp.asarray(tag), jnp.asarray(first))
    got = kernel_scans(tag.tolist(), first.tolist(), items, threads)
    for k in tsc.NAMES:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


# (items a thread, threads a tile): tiles of 1, 7, 16 and 4096 positions
WIDTHS = [(1, 1), (7, 1), (1, 7), (16, 1), (4, 4), (2, 8), (16, 256),
          (8, 512)]


@pytest.mark.parametrize("items,threads", WIDTHS)
def test_carry_algebra_on_arbitrary_tags(items, threads):
    """Tags in any order; runs over at least three tiles with
    first[0] False (few run starts)."""
    tile_n = items * threads
    n = max(3 * tile_n + 5, 40 * tile_n + 3) if tile_n < 64 else 3 * tile_n + 5
    rng = np.random.default_rng(items * 1000 + threads)
    tag = rng.integers(0, 3, n).astype(np.int8)
    first = rng.random(n) < 0.3 / tile_n
    first[0] = False
    run_lengths = np.diff(np.flatnonzero(np.r_[True, first[1:], True]))
    assert run_lengths.max() >= 3 * tile_n
    _check(tag, first, items, threads)


@pytest.mark.parametrize("items,threads", [(1, 1), (7, 1), (4, 4),
                                           (16, 256)])
@pytest.mark.parametrize("n_keys,max_b,max_p,pad", [
    (200, 5, 2, 37), (30, 300, 200, 5)])
def test_carry_algebra_on_merged_layouts(items, threads, n_keys, max_b,
                                         max_p, pad):
    rng = np.random.default_rng(n_keys + items * threads)
    tag, first = _merged(rng, n_keys, max_b, max_p, pad)
    _check(tag, first, items, threads)


@pytest.mark.parametrize("n", [1, 15, 17, 4095, 4097])
def test_carry_algebra_ragged_last_tile(n):
    """The kernel's own tile (16 items, 256 threads) on lengths that end
    inside a thread's chunk, a warp or the first tile."""
    rng = np.random.default_rng(n)
    tag = rng.integers(0, 3, n).astype(np.int8)
    first = rng.random(n) < 0.01
    _check(tag, first, 16, 256)


def test_carry_algebra_wraps_start_out_like_int32():
    """start_out wraps in int32 in the reference; the kernel's unsigned
    sums must wrap the same way: one run of 70,000 builds then 70,000
    probes (cnt sums to 4.9e9)."""
    b = p = 70_000
    tag = np.array([0] * b + [1] * p, np.int8)
    first = np.zeros(b + p, bool)
    first[0] = True
    _check(tag, first, 16, 256)


# -- the status words ---------------------------------------------------------

VALID = 1 << 63
M30 = (1 << 30) - 1


def f_put(a):
    """The forward summary as the kernel's five status words."""
    return [VALID | a["sumPre"] << 30 | a["nB"],
            VALID | a["sumPost"] << 30 | a["nM"],
            VALID | a["endOpenB"] << 31 | a["endLM"] << 1 | a["has"],
            VALID | a["npre"] << 30 | a["nrecPre0"],
            VALID | a["nrecPost"]]


def f_unpack(w):
    return {"sumPre": w[0] >> 30 & M32, "nB": w[0] & M30,
            "sumPost": w[1] >> 30 & M32, "nM": w[1] & M30,
            "endOpenB": w[2] >> 31 & M30, "endLM": w[2] >> 1 & M30,
            "has": w[2] & 1, "npre": w[3] >> 30 & M30,
            "nrecPre0": w[3] & M30, "nrecPost": w[4] & M30}


def r_word(a, flag):
    return flag << 33 | a[1] << 32 | a[0]


@pytest.mark.parametrize("seed", range(3))
def test_status_words_round_trip(seed):
    """Every field at its limits (counts below 2^30, the wrapping sums
    over all 32 bits) survives the packing; every word carries the valid
    bit, and a zeroed word does not."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        a = {k: int(rng.integers(0, M30 + 1)) for k in F_KEYS}
        a["has"] = int(rng.integers(0, 2))
        for k in ("sumPre", "sumPost"):
            a[k] = int(rng.integers(0, M32 + 1))
        if rng.random() < 0.2:
            a = {k: (1 if k == "has" else M32 if k.startswith("sum")
                     else M30) for k in F_KEYS}
        w = f_put(a)
        assert all(x < 1 << 64 and x & VALID for x in w)
        assert f_unpack(w) == a
        q, has = int(rng.integers(0, 1 << 31)), int(rng.integers(0, 2))
        for flag in (1, 2):
            word = r_word((q, has), flag)
            assert word >> 33 == flag and (word & M32, word >> 32 & 1) == (
                q, has)
    assert not (0 & VALID)
