"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. The card's name and power limit (nvidia-smi); the build of every
   kernel in distributed_join_tpu_torch/csrc (one nvcc each, in
   parallel), with its wall time.
2. Each kernel against its plain PyTorch twin at the headline's shapes
   (10 M x 10 M rows, selectivity 0.3, seed 42): the fused join scans
   over the 20 M merged positions, the stream compaction at each of the
   join's two call sites (run records, matched-build pack),
   the expand-gather in build mode and record mode, the radix sort (B6)
   on the join's merged-sort operand set (int64 key + int8 tag as keys,
   int64 value; and one int64 key with one int64 value, each with its
   live digit passes counted from the keys), and
   expand_pull in both modes. Outputs must be bit-identical over the
   prefix each contract defines. Times with CUDA events: kernel, plain
   twin, one PyTorch library call where one computes the same function,
   and the bound (bytes this data needs over 3.35 TB/s, or operations
   over the scalar rate, whichever is larger); and the kernel's device
   time alone (torch.profiler), without the host's gaps between calls.
3. The headline protocol (python -m distributed_join_tpu_torch.bench):
   no overflow, every kernel launched, and an order-independent digest of
   the result rows equal to the same join forced through the plain path;
   plus a small join held against the CPU path.
4. A join without build payloads (the expand's record mode) against the
   plain path.
5. An emulated 4-rank join on the one card (hash -> partition -> padded
   shuffle -> local join) at 2 M x 2 M rows, equal to the 1-rank join.
6. BASELINE config 3 on one card (50 M x 50 M rows, Zipf alpha 1.5,
   unique build keys, skew threshold 0.001, 64 heavy-hitter slots, HH
   output block 48 M): first the config driver's protocol with the skew
   path and without it (python -m distributed_join_tpu_torch.benchmarks.
   distributed_join), alone on the card so that its peak memory is its
   own: no overflow, 50 M matches, every kernel of the path launched.
   Then, on tables of its own, the compaction at the skew call site
   against its twin (the HH build mask at capacity 2048, the shape the
   path launches; and, off the path, the HH probe mask at n/8), and one
   untimed join of each kind through the kernels and through the plain
   twins: the four row digests must be equal, which holds the join
   kernels against their twins at config 3's shapes (100 M merged
   positions in the normal join, 50 M in the HH join).
7. An emulated 4-rank Zipf join on the card (2 M x 2 M, alpha 1.5,
   shuffle capacity factor 1.6): the naive join's first attempt
   overflows and the ladder relieves it; the skew join with the driver's
   auto-policy capacities fits on its first attempt; both equal the
   1-rank join.
8. The radix sort (B6) and expand_pull through their own entry points
   (``merged_sort``, ``expand_pull``), which no join path calls, each at
   the shapes of phase 2.
9. The scan's int32 domain: one ``join_scans`` call on 2^30 + 2^20
   positions (above its old 2^30 - 1 limit), every output exactly equal
   to its closed form, with its time and byte bound.
10. BASELINE config 5 at its size (5 M x 5 M rows, a 2-column composite
   key, a 16-byte string payload) through the config driver: no
   overflow, every join kernel launched; then one join of its tables
   through the kernels and one through the plain formulation, with
   equal row digests (the 2-D byte columns included).
11. Types and strings, each as phase 10: the headline in float64 keys
   and payloads (10 M x 10 M), a 16-byte string key (5 M x 5 M) and a
   float32 join (8 M x 8 M, keys below 2^24); then 4 emulated ranks at
   2 M x 2 M with a string key beside an int64 key and a string
   payload, equal to the 1-rank join.
12. The join types: left, right, full outer, semi and anti joins of the
   headline's tables (10 M x 10 M) through ``distributed_inner_join``,
   each with an output block of its expected rows plus 25 %, the rows
   counted from the tables alone (matches by binary search, unmatched
   rows by ``torch.isin``): no overflow on the first rung, that total,
   the scans, the compactions and the expand launched (record mode on
   semi and anti), and a row digest equal to the plain formulation's;
   each timed as benchmarks/distributed_join.py times a join (4 warm-up
   and 4 timed joins, CUDA events), the full outer join profiled. The kernels at the typed
   shapes the headline does not have (the full outer record block and
   expand, the valid-build pack, the anti join's record-mode expand)
   against their twins, their inputs taken from one join of each. Then
   4 emulated ranks at 2 M x 2 M for the full outer and anti joins,
   equal to the 1-rank join.
13. The join over NCCL, one process a card on every card of the machine
   (a world of 1 on one card), started by the port's launcher
   (benchmarks/launch.py): the config driver at BASELINE config 2's
   shape with 10 M x 10 M rows a rank, at over-decomposition 1 and 4
   (with 4 even one card partitions into 4 buckets and sends each batch
   through NCCL's all_to_all_single): no overflow, the match count of
   the plain 1-rank join of the same global tables, ms a join and M
   rows/s a rank; the same driver with ``--profile 3`` (rank 0); then a
   worker rank of this script (``--nccl-rank-worker``) runs one untimed
   ``distributed_inner_join`` at over-decomposition 4 in every rank:
   the scans, both compaction sites and the build-mode expand launched
   on every rank, and the ranks' row digests combined equal to the
   plain 1-rank join's; rank 0 then holds the scans, both compaction
   sites and the expand against their twins on the inputs the last
   bucket's local join gave them (the padded bucket's shapes), and
   every rank times the partition and shuffle of such a join alone.
   Last, the all-to-all benchmark at 64 and 256 MiB a rank with two
   cards or more (the median of 5 timed windows, each window printed);
   on one card its refusal (it needs two ranks). ``python3
   chip_smoke.py --phase 13`` runs this phase alone (after the build).

Launch counts are set to zero just before each path and read just after;
the launches of phase 2, of the config-3 kernel check and of the
bucket-shape checks do not count.
The line before the last is one JSON object with every kernel's numbers,
one row per kernel and call site (the join sites also carry their
launches on the paths of phases 10 to 13, phase 13's summed over the
ranks); the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
with code 2, and without the package beside it with code 3; neither
prints a result.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 42
NROWS = 10_000_000
EMU_ROWS = 2_000_000
EMU_RANKS = 4
CONFIG3_ROWS = 50_000_000
CONFIG3_HH_OUT = 48_000_000
ZIPF_ALPHA = 1.5
ZIPF_EMU_FACTOR = 1.6
REPS = 10
DEVICE = "cuda"
C1_POSITIONS = 2**30 + 2**20   # above the scan's old 2^30 - 1 limit
CONFIG5_ROWS = 5_000_000
STRING_KEY_ROWS = 5_000_000
FLOAT32_ROWS = 8_000_000       # keys up to 2 * rows < 2^24: exact in float32
TYPED = ("left", "right", "full_outer", "semi", "anti")
TYPED_EMU = ("full_outer", "anti")
TYPED_ITERS = 4                # 4 warm-up and 4 timed joins, as the config
                               # benchmark times them


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = REPS) -> tuple[float, dict]:
    """Mean device time of the kernels ``fn`` launches per call
    (torch.profiler), after a warm-up call, and its split by kernel name:
    what ``time_ms`` measures less the host's gaps between launches,
    which bind a call whose kernels take tens of microseconds."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.split(r"[(<]", e.key.replace(
                "(anonymous namespace)::", ""))[0].split("::")[-1].strip()
            ms = e.device_time_total / 1e3 / reps
            parts[name] = parts.get(name, 0.0) + ms
    return sum(parts.values()), parts


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(got, want, n: int | None = None) -> float:
    """Largest |difference| over the first ``n`` entries of each pair
    (every entry when ``n`` is None); 0 when they are bit-identical."""
    err = 0.0
    for g, w in zip(got, want):
        g, w = (g, w) if n is None else (g[:n], w[:n])
        if g.numel() and not torch.equal(g, w):
            err = max(err, float((g.double() - w.double()).abs().max()), 1.0)
    return err


def row_digest(res) -> tuple:
    """Order-independent digest of the valid rows: (rows, wrapping sum
    and xor of a 64-bit hash of each row). Floats enter by their bits; a
    2-D column enters element by element, a bool column as 0 or 1."""
    from distributed_join_tpu_torch.ops.hashing import fmix64, hash_combine
    t = res.table
    h = None
    for name in t.column_names:
        c = t.columns[name]
        if c.dtype == torch.bool:   # an outer join's validity columns
            c = c.to(torch.int64)
        if c.dtype.is_floating_point:
            c = c.view(torch.int64 if c.element_size() == 8 else torch.int32)
        for col in c.reshape(c.shape[0], -1).unbind(1):
            hc = fmix64(col)
            h = hc if h is None else hash_combine(h, hc)
    h = h[t.valid]
    return int(t.valid.sum()), int(h.sum()), _xor_reduce(h)


def _xor_reduce(h: torch.Tensor) -> int:
    while h.numel() > 1:
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        h = h[0::2] ^ h[1::2]
    return int(h[0]) if h.numel() else 0


def gpu_line() -> str:
    from distributed_join_tpu_torch.bench import gpu_identity
    return gpu_identity()["nvidia_smi"]


# -- phase 2: the kernels at the headline's shapes ---------------------


def stage_inputs(build, probe, out_cap: int) -> dict:
    """The inputs each kernel sees inside the headline join, made with
    the plain twins (so every stage is checked on its own)."""
    from distributed_join_tpu_torch.ops import join as J
    from distributed_join_tpu_torch.ops.compact import stream_compact_reference
    from distributed_join_tpu_torch.ops.lanes import to_u64_lane
    from distributed_join_tpu_torch.ops.scan import join_scans_reference

    keys, b1d, p1d = ["key"], ["build_payload"], ["probe_payload"]
    m_ops, m_tag = J._masked_keys(build, probe, keys)
    m_val = torch.cat([build.columns["build_payload"],
                       probe.columns["probe_payload"]])
    skeys, stag, svals = J._merged_sort(build, probe, keys, b1d, p1d)
    first = J._run_starts(skeys)
    sc = join_scans_reference(stag, first)
    is_rec = (stag == 1) & (sc["cnt"] > 0)
    rec_lanes = [to_u64_lane(sc["start_out"]), to_u64_lane(skeys[0]),
                 to_u64_lane(svals[("p", "probe_payload")]),
                 to_u64_lane(sc["lo_m"])]
    compacted = stream_compact_reference(is_rec, sc["rec_pos"], rec_lanes,
                                         out_cap)
    rec_total = int(sc["rec_pos"][-1]) + 1
    kept = min(rec_total, out_cap)
    j = torch.arange(out_cap, dtype=torch.int32, device=stag.device)
    live = j < kept
    S = torch.where(live, compacted[0].to(torch.int32),
                    torch.full_like(j, J.I32_MAX))
    lo = torch.where(live, compacted[3].to(torch.int32), torch.zeros_like(j))
    matched = sc["matched"] != 0
    pack_lane = [to_u64_lane(svals[("b", "build_payload")])]
    pack = stream_compact_reference(matched, sc["mb_pos"], pack_lane,
                                    build.capacity)
    total = int(sc["cnt"].sum(dtype=torch.int64))
    return dict(tag=stag, first=first, is_rec=is_rec, rec_pos=sc["rec_pos"],
                rec_lanes=rec_lanes, matched=matched, mb_pos=sc["mb_pos"],
                pack_lane=pack_lane, S=S, lo=lo,
                rec_cols=[compacted[1], compacted[2]], pack=pack,
                kept=kept, total=total, n_matched=int(matched.sum()),
                nb=build.capacity, out_cap=out_cap,
                sort_ops=(m_ops[0], m_tag, m_val),
                join_sort=lambda: J._merged_sort(build, probe, keys, b1d,
                                                 p1d))


def check_and_time(rows, name, source, replaces, got, want, prefix, fn_k,
                   fn_p, fn_lib, nbytes, ops, **extra):
    """Hold one kernel's outputs against its twin's (bit-identical over
    the first ``prefix`` entries), time kernel, twin and library call,
    and append the kernel's row."""
    torch.cuda.synchronize()
    err = max_abs_err(got, want, prefix)
    _check(err == 0, f"{name}: kernel disagrees with its plain twin "
                     f"(max_abs_err {err})")
    b, by = bound_ms(nbytes, ops)
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               max_abs_err=err, ms=time_ms(fn_k), plain_ms=time_ms(fn_p),
               bound_ms=b, bound_by=by,
               library_ms=None if fn_lib is None else time_ms(fn_lib),
               **{k: time_ms(f) for k, f in extra.items()})
    row["device_ms"], parts = device_ms(fn_k)
    print(f"[kernel] {name}: kernel_ms={row['ms']:.4f} "
          f"device_ms={row['device_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={b:.4f} ({by}) "
          f"library_ms={row['library_ms']} max_abs_err={err}"
          + "".join(f" {k}={row[k]:.4f}" for k in extra), flush=True)
    if len(parts) > 1:
        print(f"[kernel] {name}: device ms by kernel " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(parts.items(),
                                              key=lambda kv: -kv[1])),
              flush=True)
    rows.append(row)


def kernel_phase(build, probe, out_cap: int) -> list:
    from distributed_join_tpu_torch.ops import compact, expand, scan

    x = stage_inputs(build, probe, out_cap)
    n = x["tag"].shape[0]
    rows = []

    def add(*args, **kw):
        check_and_time(rows, *args, **kw)

    # fused scans over the 20 M merged positions
    got = scan.join_scans(x["tag"], x["first"])
    want = scan.join_scans_reference(x["tag"], x["first"])
    add("join_scans", "distributed_join_tpu_torch/csrc/join_scans.cu",
        "distributed_join_tpu/ops/scan_pallas.py:106,150 "
        "(_scan_r_kernel, _scan_f_kernel)",
        [got[k] for k in scan.NAMES], [want[k] for k in scan.NAMES], None,
        lambda: scan.join_scans(x["tag"], x["first"]),
        lambda: scan.join_scans_reference(x["tag"], x["first"]), None,
        nbytes=2 * n + 6 * 4 * n, ops=40 * n)

    # the two compactions of one join, each at its own call site: the
    # run-record block, 4 lanes, 20 M -> out_cap, and the matched-build
    # pack, 1 lane, 20 M -> nb; each checked over its survivor prefix.
    # Bound: every mask byte read, and the kept survivors' lanes read and
    # written. No pos byte: pos == cumsum(mask) - 1 (the contract) follows
    # from the mask, so the function needs none of it (the kernel reads
    # one a tile).
    surv = int(x["is_rec"].sum())
    kept = min(surv, out_cap)
    k = len(x["rec_lanes"])
    nm = x["n_matched"]
    mask_r, mask_m = x["is_rec"], x["matched"]
    packed = torch.stack(x["rec_lanes"], 1)
    pack_lane = x["pack_lane"][0]
    for name, mask, pos, lanes, cap, n_kept, lib, nbytes in (
            ("stream_compact[record]", mask_r, x["rec_pos"], x["rec_lanes"],
             out_cap, kept, lambda: packed[mask_r], n + 2 * kept * 8 * k),
            ("stream_compact[pack]", mask_m, x["mb_pos"], x["pack_lane"],
             x["nb"], nm, lambda: pack_lane[mask_m], n + 2 * nm * 8)):
        got = compact.stream_compact(mask, pos, lanes, cap)
        want = compact.stream_compact_reference(mask, pos, lanes, cap)
        add(name, "distributed_join_tpu_torch/csrc/stream_compact.cu",
            "distributed_join_tpu/ops/compact_planes.py:53 (_compact_kernel); "
            "distributed_join_tpu/ops/compact_pallas.py:62 (_compact_kernel)",
            got, want, n_kept,
            lambda m=mask, q=pos, ls=lanes, c=cap: compact.stream_compact(
                m, q, ls, c),
            lambda m=mask, q=pos, ls=lanes, c=cap:
                compact.stream_compact_reference(m, q, ls, c),
            lib, nbytes=nbytes, ops=n)
        del got, want
    del packed

    # expand-gather, build mode: 2 record lanes + 1 build lane -> out_cap
    tot = min(x["total"], out_cap)
    S, lo, rc, pk = x["S"], x["lo"], x["rec_cols"], x["pack"]
    got_r, got_b = expand.expand_gather(S, rc, out_cap, lo=lo, build_cols=pk)
    want_r, want_b = expand.expand_gather_reference(S, rc, out_cap, lo=lo,
                                                    build_cols=pk)
    kk, kb = len(rc), len(pk)
    add("expand_gather[build]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_pallas.py:335 (_expand_kernel_b8)",
        got_r + got_b, want_r + want_b, tot,
        lambda: expand.expand_gather(S, rc, out_cap, lo=lo, build_cols=pk),
        lambda: expand.expand_gather_reference(S, rc, out_cap, lo=lo,
                                               build_cols=pk),
        None,
        nbytes=x["kept"] * (4 + 4 + 8 * kk) + nm * 8 * kb
        + tot * 8 * (kk + kb),
        ops=tot * 2 * 32)

    # expand-gather, record mode: the same records, 2 lanes + start_b
    got_r, got_s = expand.expand_gather(S, rc, out_cap)
    want_r, want_s = expand.expand_gather_reference(S, rc, out_cap)
    kept_r = x["kept"]
    run_len = torch.diff(torch.cat([
        S[:kept_r].long(), torch.tensor([tot], device=S.device)]))
    rec_pack = torch.stack(rc, 1)[:kept_r]
    add("expand_gather[record]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_pallas.py:264 (_expand_kernel)",
        got_r + [got_s], want_r + [want_s], tot,
        lambda: expand.expand_gather(S, rc, out_cap),
        lambda: expand.expand_gather_reference(S, rc, out_cap),
        lambda: torch.repeat_interleave(rec_pack, run_len, dim=0,
                                        output_size=tot),
        nbytes=kept_r * (4 + 8 * kk) + tot * (8 * kk + 4),
        ops=tot * 2 * 32)

    # expand_pull (B7) on the same records: equal to expand_gather's
    # output, and to its own twin (which adds start_b and the zero rank
    # placeholder in build mode)
    gat_r, gat_b = expand.expand_gather(S, rc, out_cap, lo=lo, build_cols=pk)
    got = expand.expand_pull(S, rc, out_cap, lo=lo, build_cols=pk)
    want = expand.expand_pull_reference(S, rc, out_cap, lo=lo, build_cols=pk)
    _check(max_abs_err(got[0] + got[3], gat_r + gat_b, tot) == 0,
           "expand_pull[build] differs from expand_gather")
    add("expand_pull[build]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_planes.py:58 (_expand_kernel)",
        got[0] + [got[1], got[2]] + got[3],
        want[0] + [want[1], want[2]] + want[3], tot,
        lambda: expand.expand_pull(S, rc, out_cap, lo=lo, build_cols=pk),
        lambda: expand.expand_pull_reference(S, rc, out_cap, lo=lo,
                                             build_cols=pk),
        None,
        nbytes=x["kept"] * (4 + 4 + 8 * kk) + nm * 8 * kb
        + tot * (8 * (kk + kb) + 4 + 4),
        ops=tot * 2 * 32)
    got_r, got_s = expand.expand_pull(S, rc, out_cap)
    want_r, want_s = expand.expand_pull_reference(S, rc, out_cap)
    gat_r, gat_s = expand.expand_gather(S, rc, out_cap)
    _check(max_abs_err(got_r + [got_s], gat_r + [gat_s], tot) == 0,
           "expand_pull[record] differs from expand_gather")
    add("expand_pull[record]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_planes.py:58 (_expand_kernel)",
        got_r + [got_s], want_r + [want_s], tot,
        lambda: expand.expand_pull(S, rc, out_cap),
        lambda: expand.expand_pull_reference(S, rc, out_cap),
        lambda: torch.repeat_interleave(rec_pack, run_len, dim=0,
                                        output_size=tot),
        nbytes=kept_r * (4 + 8 * kk) + tot * (8 * kk + 4),
        ops=tot * 2 * 32)
    del rec_pack
    rows.extend(merge_sort_rows(x["sort_ops"], x["join_sort"]))
    return rows


def live_digit_passes(operands, nk: int) -> tuple[int, int]:
    """The radix sort's live passes on these operands, and its digit
    positions, counted with torch ops: the key planes packed two to a
    64-bit word, and a byte position is live where not every row has the
    same byte there."""
    from distributed_join_tpu_torch.ops import merge_sort as ms
    planes = [p for c in operands[:nk] for p in ms.key_to_planes(c)]
    live = 0
    for i in range(0, len(planes), 2):
        word = ms._wide(planes[i]) << 32
        if i + 1 < len(planes):
            word = word | ms._wide(planes[i + 1])
        for b in range(8):
            digit = (word >> (8 * b)) & 0xFF
            live += int(digit.amin() != digit.amax())
    return live, 8 * ((len(planes) + 1) // 2)


def merge_sort_rows(sort_ops, join_sort) -> list:
    """B6 at the join's merged-sort operand set (int64 key + int8 tag as
    keys, int64 value) and at one int64 key with one int64 value: the
    kernel route and the stable twin both give the stable order, so every
    operand must be bit-identical (stronger than the contract's sorted
    keys plus equal rows within each key run). Each row carries the
    number of live digit passes of these keys."""
    from distributed_join_tpu_torch.ops import merge_sort as ms

    key, tag, val = sort_ops
    n = key.shape[0]
    rows = []
    src = "distributed_join_tpu_torch/csrc/radix_sort.cu"
    rep = ("distributed_join_tpu/ops/sort_pallas.py:314 (_merge_tile_kernel)")
    for name, operands, nk, lib in (
            ("merge_sort[key+tag]", (key, tag, val), 2, None),
            ("merge_sort[key]", (key, val), 1,
             lambda: _sort_and_gather(key, val))):
        got = ms.merged_sort(operands, nk)
        want = ms.merged_sort_reference(operands, nk)
        width = sum(c.element_size() for c in operands)
        extra = {"join_merged_sort_ms": join_sort} if lib is None else {}
        # bytes: every operand read once and written once; operations:
        # one digit per row for each live digit position of these keys
        # at the scalar rate (never binds next to the bytes)
        live, digits = live_digit_passes(operands, nk)
        check_and_time(rows, name, src, rep, list(got), list(want), None,
                       lambda o=operands, k=nk: ms.merged_sort(o, k),
                       lambda o=operands, k=nk: ms.merged_sort_reference(o, k),
                       lib, nbytes=2 * n * width, ops=n * max(live, 1),
                       **extra)
        rows[-1]["live_passes"] = live
        print(f"[kernel] {name}: {live} live digit passes of {digits}",
              flush=True)
        del got, want
    return rows


def _sort_and_gather(key, val):
    srt = torch.sort(key)
    return srt.values, val[srt.indices]


# -- the paths ----------------------------------------------------------


def counted(fn):
    """Run ``fn`` with every launch count set to zero; returns (its
    result, the counts it left, by wrapper or call site)."""
    from distributed_join_tpu_torch.ops import (
        _kernels,
        compact,
        expand,
        join,
        merge_sort,
        scan,
    )
    from distributed_join_tpu_torch.parallel import skew
    wrappers = (scan.join_scans, join.compact_records,
                join.pack_matched_builds, join.pack_valid_builds,
                compact.stream_compact,
                expand.expand_gather, skew.extract_prefix,
                merge_sort.merge_sort_planes, expand.expand_pull)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts(*wrappers)
    out = fn()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in wrappers}


JOIN_KERNELS = ("join_scans", "compact_records", "pack_matched_builds",
                "expand_gather")


def _require_launched(counts: dict, names, where: str) -> None:
    for name in names:
        _check(counts[name] > 0, f"{name} was not launched on {where}")


def headline_phase():
    from distributed_join_tpu_torch import bench
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    record, counts = counted(lambda: bench.run(NROWS, bench.ITERS, device=DEVICE))
    print("[headline] " + json.dumps(record), flush=True)
    print(f"[headline] launches {counts}", flush=True)
    _require_launched(counts, JOIN_KERNELS, "the headline path")

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        selectivity=bench.SELECTIVITY, device=DEVICE)
    match_out = int(bench.MATCHES_PER_ROW * NROWS * bench.OUT_SLACK)
    contract_out = int(NROWS * 1.2)
    for label, out_cap in (("match_sized", match_out),
                           ("contract", contract_out)):
        k = sort_merge_inner_join(build, probe, "key", out_cap)
        p = sort_merge_inner_join(build, probe, "key", out_cap,
                                  kernel_config=KernelConfig("plain"))
        _check(not bool(k.overflow), f"headline {label} join overflowed")
        _check(int(k.total) == int(p.total) == record["matches_per_join"],
               f"headline {label} totals differ")
        dk, dp = row_digest(k), row_digest(p)
        print(f"[headline] {label}: out_cap={out_cap} total={int(k.total)} "
              f"digest kernel={dk} plain={dp}", flush=True)
        _check(dk == dp, f"headline {label} digest differs from the plain "
                         "path")
        del k, p

    # a small join on the card against the CPU path (held against the
    # JAX package by the CPU tests)
    sb, sp = generate_build_probe_tables(seed=7, build_nrows=20_000,
                                         probe_nrows=30_000, rand_max=5_000,
                                         device=DEVICE)
    g = sort_merge_inner_join(sb, sp, "key", 200_000)
    cpu = [Table({n: c.cpu() for n, c in t.columns.items()}, t.valid.cpu())
           for t in (sb, sp)]
    c = sort_merge_inner_join(*cpu, "key", 200_000)
    _check(row_digest(g) == row_digest(c) and int(g.total) == int(c.total)
           > 0, "small join on the card differs from the CPU path")
    print(f"[headline] small join vs CPU path: total={int(g.total)} equal",
          flush=True)
    return record, counts


def record_mode_phase():
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS, device=DEVICE)
    out_cap = int(NROWS * 0.75)
    k, counts = counted(lambda: sort_merge_inner_join(
        build, probe, "key", out_cap, build_payload=[]))
    p = sort_merge_inner_join(build, probe, "key", out_cap, build_payload=[],
                              kernel_config=KernelConfig("plain"))
    _check(counts["expand_gather"] > 0 and counts["join_scans"] > 0,
           f"no-build-payload join launched {counts}")
    _check(not bool(k.overflow) and int(k.total) == int(p.total),
           "no-build-payload join: totals differ or overflow")
    _check(row_digest(k) == row_digest(p),
           "no-build-payload join differs from the plain path")
    print(f"[record-mode] total={int(k.total)} launches {counts} equal",
          flush=True)
    return counts


def emulated_phase():
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
        seed=SEED, build_nrows=EMU_ROWS, probe_nrows=EMU_ROWS, device=DEVICE)
    t0 = time.perf_counter()
    multi, counts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), auto_retry=2))
    wall = time.perf_counter() - t0
    one = distributed_inner_join(build, probe, LocalCommunicator(),
                                 auto_retry=2)
    _check(not bool(multi.overflow) and not bool(one.overflow),
           "emulated join overflowed")
    _check(int(multi.total) == int(one.total) > 0,
           "emulated 4-rank total differs from 1 rank")
    _check(row_digest(multi) == row_digest(one),
           "emulated 4-rank rows differ from 1 rank")
    _require_launched(counts, JOIN_KERNELS, "the emulated path")
    print(f"[emulated] {EMU_RANKS} ranks on one card: total="
          f"{int(multi.total)} equal to 1 rank; wall {wall:.3f} s "
          f"(host clock, first call); launches {counts}", flush=True)
    return counts


def _config3_args(skew_on: bool, rows: int | None = None):
    """The config driver's arguments for BASELINE config 3: with the skew
    path on, the driver's auto-policy sets threshold 0.001 and the HH
    probe block; the HH output block is 48 M of 50 M (scaled with rows)."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    rows = CONFIG3_ROWS if rows is None else rows
    argv = ["--communicator", "local", "--build-table-nrows", str(rows),
            "--probe-table-nrows", str(rows), "--zipf-alpha",
            str(ZIPF_ALPHA), "--hh-slots", "64", "--iterations", "4"]
    if skew_on:
        argv += ["--hh-out-capacity",
                 str(CONFIG3_HH_OUT * rows // CONFIG3_ROWS)]
    else:
        argv += ["--skew-threshold", "0"]
    return D.parse_args(argv)


def skew_site_row(build, probe, args) -> dict:
    """B5 at the skew call site, on the config-3 tables: the compaction
    of the row iota under the HH build mask at capacity 2048 (the HH
    build broadcast, the one skew-site shape config 3 launches), with
    the library call iota[mask][:cap]. The HH probe mask at n/8 (the
    generic HH probe block, which config 3's policy does not use: its
    block covers every local row, and extract_prefix sorts) is checked
    and timed too, on a log line of its own that the kernels line does
    not carry. The bound reads each mask byte and each kept survivor's
    lane, and writes the kept lanes (no pos byte, as at the join
    sites)."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.ops import compact
    from distributed_join_tpu_torch.ops.hashing import hash_columns
    from distributed_join_tpu_torch.parallel import skew
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        HH_BUILD_SLOTS_PER_HH,
    )

    thr = D.skew_policy(args, 1)[0]
    bh = hash_columns([build.columns["key"]]).view(torch.uint64)
    ph = hash_columns([probe.columns["key"]]).view(torch.uint64)
    hh = skew.global_heavy_hitters(
        LocalCommunicator(), ph, probe.valid, args.hh_slots,
        threshold=int(thr * probe.capacity))
    n = probe.capacity
    iota = torch.arange(n, dtype=torch.int64, device=probe.device)
    sites = (("stream_compact[skew]", skew.mark_heavy(bh, hh) & build.valid,
              args.hh_slots * HH_BUILD_SLOTS_PER_HH),
             ("stream_compact[skew, HH probe at n/8, off the path]",
              skew.mark_heavy(ph, hh) & probe.valid, n // 8))
    del bh, ph
    rows = []
    for name, mask, cap in sites:
        pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
        surv = int(mask.sum())
        kept = min(surv, cap)
        print(f"[config3] {name}: {surv} survivors, capacity {cap}",
              flush=True)
        _check(surv > 0, f"config 3 found no heavy hitters ({name})")
        got = compact.stream_compact(mask, pos, [iota], cap)
        want = compact.stream_compact_reference(mask, pos, [iota], cap)
        check_and_time(
            rows, name, "distributed_join_tpu_torch/csrc/stream_compact.cu",
            "distributed_join_tpu/ops/compact_pallas.py:62 (_compact_kernel), "
            "called from distributed_join_tpu/parallel/skew.py:252-269",
            [got[0][:kept]], [want[0][:kept]], None,
            lambda m=mask, p=pos, c=cap: compact.stream_compact(
                m, p, [iota], c),
            lambda m=mask, p=pos, c=cap: compact.stream_compact_reference(
                m, p, [iota], c),
            lambda m=mask, c=cap: iota[m][:c],
            nbytes=n + 2 * 8 * kept, ops=2 * n)
        del got, want, pos
    return rows[0]


def config3_phase():
    """BASELINE config 3 through the config driver, skew on and naive;
    then the skew join's rows against the naive join's, each through the
    kernels and through the plain twins, on the same tables."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_join_step,
    )

    skew_args, naive_args = _config3_args(True), _config3_args(False)
    torch.cuda.empty_cache()
    rec, counts = counted(lambda: D.run(skew_args, device=DEVICE))
    print("[config3] skew " + json.dumps(rec), flush=True)
    print(f"[config3] skew launches {counts}", flush=True)
    torch.cuda.empty_cache()
    naive, ncounts = counted(lambda: D.run(naive_args, device=DEVICE))
    print("[config3] naive " + json.dumps(naive), flush=True)
    print(f"[config3] peak_memory_bytes skew={rec.get('peak_memory_bytes')} "
          f"naive={naive.get('peak_memory_bytes')} (each driver run alone "
          "on the card)", flush=True)
    rows = skew_args.build_table_nrows
    for label, r in (("skew", rec), ("naive", naive)):
        _check(not r["overflow"], f"config 3 {label} join overflowed")
        _check(r["matches_per_join"] == rows,
               f"config 3 {label}: {r['matches_per_join']} matches, "
               f"expected {rows}")
    _require_launched(counts, JOIN_KERNELS + ("extract_prefix",),
                      "the config-3 skew path")
    _require_launched(ncounts, JOIN_KERNELS, "the config-3 naive path")

    build, probe, _ = D.make_tables(skew_args, torch.device(DEVICE))
    row = skew_site_row(build, probe, skew_args)
    torch.cuda.empty_cache()

    # the rows: one untimed join of each kind on the unshifted tables,
    # through the kernels and through the plain twins (the plain skew
    # join's extract_prefix takes its sort branch: no kernel at all)
    comm = LocalCommunicator()
    thr, hh_probe, hh_out, _ = D.skew_policy(skew_args, 1)
    digests = {}
    for label, opts in (("skew", dict(skew_threshold=thr,
                                      hh_slots=skew_args.hh_slots,
                                      hh_probe_capacity=hh_probe,
                                      hh_out_capacity=hh_out)),
                        ("naive", {})):
        for route in ("kernel", "plain"):
            res = make_join_step(comm, key="key",
                                 kernel_config=KernelConfig(route),
                                 **opts)(build, probe)
            _check(not bool(res.overflow) and int(res.total) == rows,
                   f"config 3 {label} {route} digest join: total "
                   f"{int(res.total)}")
            digests[f"{label}/{route}"] = row_digest(res)
            del res
            torch.cuda.empty_cache()
    print(f"[config3] digests {digests}", flush=True)
    _check(len(set(digests.values())) == 1,
           "config 3: the skew and naive joins, through the kernels and "
           "through the plain twins, do not give the same rows")
    return row, counts


def zipf_emulated_phase():
    """The naive-overflows / skew-fits pair on 4 emulated ranks: JAX's
    test_zipf_skew_relieves_shuffle_padding, on the card."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )

    args = _config3_args(True, EMU_ROWS)
    build, probe, _ = D.make_tables(args, torch.device(DEVICE))
    thr, hh_probe, hh_out, _ = D.skew_policy(args, EMU_RANKS)
    sizing = dict(shuffle_capacity_factor=ZIPF_EMU_FACTOR,
                  out_capacity_factor=2.0)
    one = distributed_inner_join(build, probe, LocalCommunicator(),
                                 auto_retry=2, **sizing)
    naive, ncounts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), auto_retry=2,
        **sizing))
    skewed, scounts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), skew_threshold=thr,
        hh_slots=args.hh_slots, hh_probe_capacity=hh_probe,
        hh_out_capacity=hh_out, **sizing))
    trail = naive.retry_report
    print(f"[zipf-emulated] naive attempts "
          f"{[a.overflow for a in trail.attempts]}; skew attempts "
          f"{[a.overflow for a in skewed.retry_report.attempts]}",
          flush=True)
    _check(trail.attempts[0].overflow and trail.resolved,
           "naive Zipf join: the first attempt did not overflow, or the "
           "ladder did not relieve it")
    _check(skewed.retry_report.n_attempts == 1 and not bool(skewed.overflow),
           "skew Zipf join overflowed on its first attempt")
    d1 = row_digest(one)
    for label, r in (("naive", naive), ("skew", skewed)):
        _check(int(r.total) == int(one.total) == EMU_ROWS
               and row_digest(r) == d1,
               f"emulated Zipf {label} join differs from the 1-rank join")
    _require_launched(ncounts, JOIN_KERNELS, "the emulated naive Zipf path")
    _require_launched(scounts, JOIN_KERNELS + ("extract_prefix",),
                      "the emulated skew Zipf path")
    print(f"[zipf-emulated] {EMU_RANKS} ranks, factor {ZIPF_EMU_FACTOR}: "
          f"total={int(one.total)}, both equal to 1 rank; launches naive "
          f"{ncounts} skew {scounts}", flush=True)


def entry_points_phase(build, probe) -> dict:
    """B6 and B7 through their own entry points, each call counted on
    its own, at phase 2's shapes."""
    from distributed_join_tpu_torch.ops import expand
    from distributed_join_tpu_torch.ops.merge_sort import merged_sort

    x = stage_inputs(build, probe, int(0.6 * NROWS * 1.25))
    key, tag, val = x["sort_ops"]
    S, lo, rc, pk, cap = x["S"], x["lo"], x["rec_cols"], x["pack"], \
        x["out_cap"]
    calls = {
        "merge_sort[key+tag]": (lambda: merged_sort((key, tag, val), 2),
                                "merge_sort_planes"),
        "merge_sort[key]": (lambda: merged_sort((key, val), 1),
                            "merge_sort_planes"),
        "expand_pull[build]": (lambda: expand.expand_pull(
            S, rc, cap, lo=lo, build_cols=pk), "expand_pull"),
        "expand_pull[record]": (lambda: expand.expand_pull(S, rc, cap),
                                "expand_pull"),
    }
    launches = {}
    for name, (fn, wrapper) in calls.items():
        _, counts = counted(fn)
        _check(counts[wrapper] > 0, f"{name}: {wrapper} was not launched")
        launches[name] = counts[wrapper]
    print(f"[entry-points] launches {launches}", flush=True)
    return launches


# -- phases 9-11: the scan's int32 domain, config 5, types and strings --


def c1_phase() -> dict:
    """One ``join_scans`` call on C1_POSITIONS positions of runs
    [build, build, probe, probe]: every output has a closed form in the
    run index r = i // 4, checked exactly chunk by chunk, past the old
    2^30 - 1 limit too. Device time by CUDA events; the bound reads tag
    and first and writes six int32 outputs, 26 B a position."""
    from distributed_join_tpu_torch.ops import scan

    n = C1_POSITIONS
    dev = torch.device(DEVICE)
    tag = torch.tensor([0, 0, 1, 1], dtype=torch.int8, device=dev).repeat(
        n // 4)
    first = torch.tensor([1, 0, 0, 0], dtype=torch.bool, device=dev).repeat(
        n // 4)
    outs = scan.join_scans(tag, first)
    torch.cuda.synchronize()
    # per position of a run (b, b, p, p): value = a * r + c
    forms = {"matched": ((0, 1), (0, 1), (0, 0), (0, 0)),
             "cnt": ((0, 0), (0, 0), (0, 2), (0, 2)),
             "start_out": ((4, 0), (4, 0), (4, 0), (4, 2)),
             "lo_m": ((2, 0), (2, 0), (2, 0), (2, 0)),
             "rec_pos": ((2, -1), (2, -1), (2, 0), (2, 1)),
             "mb_pos": ((2, 0), (2, 1), (2, 1), (2, 1))}
    chunk = 1 << 26
    for lo in range(0, n, chunk):
        i = torch.arange(lo, min(n, lo + chunk), device=dev)
        r, q = i // 4, i % 4
        for name, per_q in forms.items():
            a = torch.tensor([f[0] for f in per_q], device=dev)[q]
            c = torch.tensor([f[1] for f in per_q], device=dev)[q]
            _check(torch.equal(outs[name][lo:lo + chunk],
                               (a * r + c).to(torch.int32)),
                   f"join_scans at {n} positions: {name} differs from its "
                   f"closed form in [{lo}, {lo + chunk})")
    del outs
    torch.cuda.empty_cache()
    ms = time_ms(lambda: scan.join_scans(tag, first), reps=3)
    b, by = bound_ms(26 * n, 40 * n)
    print(f"[c1] join_scans on {n} positions (2^30 + 2^20): all six "
          f"outputs equal their closed forms; ms={ms:.4f} bound_ms={b:.4f} "
          f"({by}, 26 B a position)", flush=True)
    del tag, first
    torch.cuda.empty_cache()
    return {"positions": n, "ms": ms, "bound_ms": b}


def _driver_and_digest(label: str, argv: list) -> dict:
    """The config driver's protocol on ``argv`` (counted: every join
    kernel launched, no overflow), then one join of its tables through
    the kernel pipeline and one through the plain formulation, whose row
    digests (2-D byte columns included) must be equal. Returns the
    launch counts of the driver's run."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_join_step,
    )

    args = D.parse_args(["--communicator", "local", "--iterations", "4",
                         *argv])
    torch.cuda.empty_cache()
    rec, counts = counted(lambda: D.run(args, device=DEVICE))
    print(f"[{label}] " + json.dumps(rec), flush=True)
    print(f"[{label}] launches {counts}", flush=True)
    _check(not rec["overflow"], f"{label}: the driver's join overflowed")
    _require_launched(counts, JOIN_KERNELS, f"the {label} path")
    build, probe, key = D.make_tables(args, torch.device(DEVICE))
    digests = {}
    for route in ("kernel", "plain"):
        res = make_join_step(LocalCommunicator(), key=key,
                             kernel_config=KernelConfig(route))(build, probe)
        _check(not bool(res.overflow) and int(res.total)
               == rec["matches_per_join"],
               f"{label} {route} digest join: total {int(res.total)}")
        digests[route] = row_digest(res)
        del res
        torch.cuda.empty_cache()
    print(f"[{label}] digests {digests}", flush=True)
    _check(digests["kernel"] == digests["plain"],
           f"{label}: the kernel pipeline and the plain formulation give "
           "different rows")
    return counts


def config5_phase() -> dict:
    """BASELINE config 5 (scripts/run_baseline_configs.sh:58-63) at its
    size: a 2-column composite key and a 16-byte string payload."""
    rows = str(CONFIG5_ROWS)
    return _driver_and_digest("config5", [
        "--build-table-nrows", rows, "--probe-table-nrows", rows,
        "--key-columns", "2", "--string-payload-bytes", "16"])


def types_phase() -> dict:
    """The headline in float64 keys and payloads, a 16-byte string key,
    and a float32 join whose keys stay below 2^24."""
    counts = {}
    for label, rows, argv in (
            ("float64", NROWS, ["--key-type", "float64",
                                "--payload-type", "float64"]),
            ("string-key", STRING_KEY_ROWS, ["--string-key-bytes", "16"]),
            ("float32", FLOAT32_ROWS, ["--key-type", "float32",
                                       "--payload-type", "float32"])):
        counts[label] = _driver_and_digest(label, [
            "--build-table-nrows", str(rows), "--probe-table-nrows",
            str(rows), *argv])
    return counts


def emulated_strings_phase() -> None:
    """4 emulated ranks at EMU_ROWS x EMU_ROWS: a composite key of a
    16-byte string key and an int64 column, with a 16-byte string
    payload; equal to the 1-rank join (results, not speed)."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.generators import (
        generate_composite_build_probe_tables,
    )
    from distributed_join_tpu_torch.utils.strings import encode_int_strings

    build, probe, _ = generate_composite_build_probe_tables(
        seed=SEED, build_nrows=EMU_ROWS, probe_nrows=EMU_ROWS,
        key_columns=2, string_payload_len=16, device=DEVICE)

    def stringify(t):
        cols = dict(t.columns)
        cols["skey"], cols["skey#len"] = encode_int_strings(
            cols.pop("key0"), prefix="itm-", digits=12)
        return Table(cols, t.valid)

    build, probe = stringify(build), stringify(probe)
    opts = dict(key=["skey", "key1"], auto_retry=2)
    multi, counts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), **opts))
    one = distributed_inner_join(build, probe, LocalCommunicator(), **opts)
    _check(not bool(multi.overflow) and not bool(one.overflow),
           "emulated string join overflowed")
    _check(int(multi.total) == int(one.total) > 0
           and row_digest(multi) == row_digest(one),
           "emulated 4-rank string join differs from 1 rank")
    _require_launched(counts, JOIN_KERNELS, "the emulated string path")
    print(f"[emulated-strings] {EMU_RANKS} ranks: total={int(multi.total)} "
          f"equal to 1 rank (string key + int64 key, string payload); "
          f"launches {counts}", flush=True)


# -- phase 12: the join types -------------------------------------------


def expected_typed_rows(build, probe) -> dict:
    """Each type's output rows, counted from the tables alone: the
    matches by binary search of the sorted valid build keys, unmatched
    probes and builds by ``torch.isin`` on the valid keys."""
    bk = build.columns["key"][build.valid]
    pk = probe.columns["key"][probe.valid]
    sb = torch.sort(bk).values
    matches = int((torch.searchsorted(sb, pk, right=True)
                   - torch.searchsorted(sb, pk)).sum())
    hit_p = torch.isin(pk, bk)
    unmatched_p = int((~hit_p).sum())
    unmatched_b = int((~torch.isin(bk, pk)).sum())
    return {"left": matches + unmatched_p, "right": matches + unmatched_b,
            "full_outer": matches + unmatched_p + unmatched_b,
            "semi": int(hit_p.sum()), "anti": unmatched_p}


def join_kernel_ms(top: list) -> dict:
    """Device ms a join of the port's join kernels in a profile's rows
    (the compaction's two call sites share one kernel)."""
    names = {"compaction": ("compact_kernel",),
             "expand": ("expand_kernel",),
             "join_scans": ("f_pass", "r_pass")}
    return {k: sum(r["ms"] for r in top if any(p in r["name"] for p in pats))
            for k, pats in names.items()}


def captured_join_calls(fn):
    """Run ``fn`` with the join's scans, compaction and expand calls
    recorded: returns (its result, {call site: the arguments of its last
    call})."""
    from distributed_join_tpu_torch.ops import join as J
    calls = {}
    real_scans = J.join_scans
    real_compact, real_expand = J.stream_compact, J.expand_gather

    def scans(tag, first):
        calls["join_scans"] = (tag, first)
        return real_scans(tag, first)

    def compact(mask, pos, cols, capacity, launch_counter=None):
        calls[launch_counter.__name__] = (mask, pos, list(cols), capacity)
        return real_compact(mask, pos, cols, capacity,
                            launch_counter=launch_counter)

    def expand(S, cols, out_capacity, lo=None, build_cols=None):
        calls["expand_gather"] = (S, list(cols), out_capacity, lo,
                                  build_cols)
        return real_expand(S, cols, out_capacity, lo=lo,
                           build_cols=build_cols)

    J.join_scans, J.stream_compact, J.expand_gather = scans, compact, expand
    try:
        return fn(), calls
    finally:
        J.join_scans = real_scans
        J.stream_compact, J.expand_gather = real_compact, real_expand


def typed_kernel_rows(build, probe, caps) -> list:
    """The kernels at the typed joins' shapes that phase 2 does not have:
    the full outer join's record block (5 lanes: S, key, probe payload,
    build rank, side flags) and build-mode expand, the valid-build pack,
    and the anti join's record-mode expand (run length 1); each with the
    inputs one join of that type gives it, against its twin. Bounds as
    phase 2's: a compaction reads every mask byte and the kept survivors'
    lanes and writes them; an expand reads each live record (and each
    valid build row the pack holds) and writes each slot up to the
    total."""
    from distributed_join_tpu_torch.ops import compact, expand
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig

    rows = []
    route = KernelConfig("kernel")
    src_c = "distributed_join_tpu_torch/csrc/stream_compact.cu"
    src_e = "distributed_join_tpu_torch/csrc/expand_gather.cu"
    rep_c = ("distributed_join_tpu/ops/compact_planes.py:53 "
             "(_compact_kernel); distributed_join_tpu/ops/compact_pallas.py:"
             "62 (_compact_kernel)")
    res, calls = captured_join_calls(lambda: sort_merge_inner_join(
        build, probe, "key", caps["full_outer"], join_type="full_outer",
        kernel_config=route))
    tot = min(int(res.total), caps["full_outer"])
    del res
    n = build.capacity + probe.capacity
    for name, site in (("stream_compact[record, full_outer]",
                        "compact_records"),
                       ("stream_compact[valid-build pack]",
                        "pack_valid_builds")):
        mask, pos, lanes, cap = calls[site]
        kept = min(int(mask.sum()), cap)
        lib = (lambda m=mask, packed=torch.stack(lanes, 1): packed[m])
        got = compact.stream_compact(mask, pos, lanes, cap)
        want = compact.stream_compact_reference(mask, pos, lanes, cap)
        check_and_time(
            rows, name, src_c, rep_c, got, want, kept,
            lambda m=mask, q=pos, ls=lanes, c=cap: compact.stream_compact(
                m, q, ls, c),
            lambda m=mask, q=pos, ls=lanes, c=cap:
                compact.stream_compact_reference(m, q, ls, c),
            lib, nbytes=n + 2 * kept * 8 * len(lanes), ops=n)
        del got, want, lib
    n_rec = int(calls["compact_records"][0].sum())
    n_valid_b = int(build.valid.sum())
    S, rc, cap, lo, pk = calls["expand_gather"]
    got_r, got_b = expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk)
    want_r, want_b = expand.expand_gather_reference(S, rc, cap, lo=lo,
                                                    build_cols=pk)
    check_and_time(
        rows, "expand_gather[build, full_outer]", src_e,
        "distributed_join_tpu/ops/expand_pallas.py:335 (_expand_kernel_b8)",
        got_r + got_b, want_r + want_b, tot,
        lambda: expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk),
        lambda: expand.expand_gather_reference(S, rc, cap, lo=lo,
                                               build_cols=pk), None,
        nbytes=n_rec * (4 + 4 + 8 * len(rc)) + n_valid_b * 8 * len(pk)
        + tot * 8 * (len(rc) + len(pk)), ops=tot * 2 * 32)
    del calls, got_r, got_b, want_r, want_b, S, rc, lo, pk
    torch.cuda.empty_cache()

    res, calls = captured_join_calls(lambda: sort_merge_inner_join(
        build, probe, "key", caps["anti"], join_type="anti",
        kernel_config=route))
    tot = min(int(res.total), caps["anti"])
    del res
    S, rc, cap, _, _ = calls["expand_gather"]
    n_rec = int(calls["compact_records"][0].sum())
    got_r, got_s = expand.expand_gather(S, rc, cap)
    want_r, want_s = expand.expand_gather_reference(S, rc, cap)
    run_len = torch.diff(torch.cat([
        S[:n_rec].long(), torch.tensor([tot], device=S.device)]))
    rec_pack = torch.stack(rc, 1)[:n_rec]
    check_and_time(
        rows, "expand_gather[record, anti]", src_e,
        "distributed_join_tpu/ops/expand_pallas.py:264 (_expand_kernel)",
        got_r + [got_s], want_r + [want_s], tot,
        lambda: expand.expand_gather(S, rc, cap),
        lambda: expand.expand_gather_reference(S, rc, cap),
        lambda: torch.repeat_interleave(rec_pack, run_len, dim=0,
                                        output_size=tot),
        nbytes=n_rec * (4 + 8 * len(rc)) + tot * (8 * len(rc) + 4),
        ops=tot * 2 * 32)
    del calls, rec_pack
    torch.cuda.empty_cache()
    return rows


def typed_phase():
    """The five typed joins of the headline's tables (phase 12)."""
    from distributed_join_tpu_torch import bench
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
        make_join_step,
    )
    from distributed_join_tpu_torch.utils.benchmarking import (
        profile_join,
        timed_join_throughput,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        selectivity=bench.SELECTIVITY, device=DEVICE)
    want = expected_typed_rows(build, probe)
    caps = {t: int(want[t] * bench.OUT_SLACK) for t in TYPED}
    print(f"[typed] expected rows {want}; output blocks {caps}", flush=True)
    comm = LocalCommunicator()
    counts, timing = {}, {}
    for t in TYPED:
        res, c = counted(lambda: distributed_inner_join(
            build, probe, comm, join_type=t, out_rows_per_rank=caps[t]))
        _check(not bool(res.overflow) and res.retry_report.n_attempts == 1,
               f"{t} join overflowed its first rung")
        _check(int(res.total) == want[t],
               f"{t} join: total {int(res.total)}, counted {want[t]}")
        need = ["join_scans", "compact_records", "expand_gather"]
        if t not in ("semi", "anti"):
            need.append("pack_valid_builds")
        _require_launched(c, need, f"the {t} path")
        dk = row_digest(res)
        del res
        plain = distributed_inner_join(
            build, probe, comm, join_type=t, out_rows_per_rank=caps[t],
            kernel_config=KernelConfig("plain"))
        dp = row_digest(plain)
        _check(int(plain.total) == want[t] and dk == dp,
               f"{t} join: the kernel pipeline and the plain formulation "
               "give different rows")
        del plain
        torch.cuda.empty_cache()
        step = make_join_step(comm, key="key", join_type=t,
                              out_rows_per_rank=caps[t])
        sec, total, ovf = timed_join_throughput(comm, step, build, probe,
                                                TYPED_ITERS)
        _check(not ovf and total == want[t],
               f"{t} join: the timed joins gave {total} rows")
        timing[t] = sec * 1e3
        counts[t] = c
        print(f"[typed] {t}: total={want[t]} out_rows={caps[t]} "
              f"ms_per_join={sec * 1e3:.4f} "
              f"m_rows_per_sec={2 * NROWS / sec / 1e6:.1f} digest equal to "
              f"the plain formulation; launches {c}", flush=True)
        prof = profile_join(step, build, probe, joins=3, top=60)
        if t == "full_outer":
            print("[typed] full_outer profile " + json.dumps(prof),
                  flush=True)
        print(f"[typed] {t} device ms a join: busy "
              f"{prof['device_busy_ms_per_join']:.4f} of wall "
              f"{prof['host_wall_ms_per_join']:.4f}; " + ", ".join(
                  f"{k} {v:.4f}" for k, v in
                  join_kernel_ms(prof["top_kernels_ms_per_join"]).items()),
              flush=True)
    n = 2 * NROWS
    x = torch.arange(n, dtype=torch.int32, device=DEVICE) % 1000
    print(f"[typed] torch.cummax on {n} int32: "
          f"{time_ms(lambda: torch.cummax(x, 0), reps=3):.3f} ms; "
          f"torch.cumsum: {time_ms(lambda: torch.cumsum(x, 0)):.4f} ms",
          flush=True)
    del x
    rows = typed_kernel_rows(build, probe, caps)
    del build, probe
    torch.cuda.empty_cache()

    eb, ep = generate_build_probe_tables(
        seed=SEED, build_nrows=EMU_ROWS, probe_nrows=EMU_ROWS, device=DEVICE)
    for t in TYPED_EMU:
        multi, c = counted(lambda: distributed_inner_join(
            eb, ep, EmulatedCommunicator(EMU_RANKS), join_type=t,
            auto_retry=2))
        one = distributed_inner_join(eb, ep, comm, join_type=t,
                                     auto_retry=2)
        _check(not bool(multi.overflow) and not bool(one.overflow),
               f"emulated {t} join overflowed")
        _check(int(multi.total) == int(one.total) > 0
               and row_digest(multi) == row_digest(one),
               f"emulated 4-rank {t} join differs from 1 rank")
        _require_launched(c, ("compact_records", "expand_gather"),
                          f"the emulated {t} path")
        print(f"[typed-emulated] {EMU_RANKS} ranks: {t} total="
              f"{int(multi.total)} equal to 1 rank (attempts "
              f"{multi.retry_report.n_attempts}); launches {c}", flush=True)
    return counts, timing, rows


# -- phase 13: the join over NCCL, one process a card ---------------------


NCCL_SITES = ("join_scans", "compact_records", "pack_matched_builds",
              "pack_valid_builds", "expand_gather")
NCCL_K = 4                     # over-decomposition of the worker's join
A2A_MIB = (64, 256)
NCCL_TIMEOUT_S = 600


def _launch(n: int, argv: list, timeout: float = NCCL_TIMEOUT_S):
    """``python <argv>`` on ``n`` processes, one a card, through the
    port's launcher (NCCL), from this script's directory."""
    import signal
    import socket
    import subprocess
    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "distributed_join_tpu_torch.benchmarks.launch",
           "--num-processes", str(n), "--coordinator", f"localhost:{port}",
           "--", sys.executable, *argv]
    # a session of its own, so that a timeout stops every rank with it
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=root,
                            env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        _fail(f"the launched job {argv[:3]} passed {timeout} s")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _launched_record(label: str, n: int, argv: list) -> dict:
    """The JSON record rank 0 printed last; fails the phase if any rank
    failed (the launcher's exit code)."""
    r = _launch(n, argv)
    if r.returncode != 0:
        print(r.stderr[-6000:], file=sys.stderr, flush=True)
        _fail(f"{label}: the launched job exited with {r.returncode}")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    _check(len(lines) == 1, f"{label}: {len(lines)} records on stdout "
                            "(rank 0 alone prints one)")
    for ln in r.stdout.splitlines():
        if ln.strip() and not ln.startswith("{"):
            print(f"[nccl] {label}: {ln}", flush=True)
    return json.loads(lines[0])


def bucket_kernel_rows(calls) -> list:
    """The join kernels at the shapes one bucket of the NCCL path gives
    them: the inputs the last bucket's local join passed to the scans,
    both compaction sites and the build-mode expand (``calls``, from
    ``captured_join_calls``), each held against its twin. The buckets
    arrive padded (the shuffle's capacity factor), so the merged domain
    is not the headline's. Bounds as phase 2's."""
    from distributed_join_tpu_torch.ops import compact, expand, scan

    rows = []
    tag, first = calls["join_scans"]
    n = tag.shape[0]
    got = scan.join_scans(tag, first)
    want = scan.join_scans_reference(tag, first)
    check_and_time(
        rows, "join_scans[nccl bucket]",
        "distributed_join_tpu_torch/csrc/join_scans.cu",
        "distributed_join_tpu/ops/scan_pallas.py:106,150 "
        "(_scan_r_kernel, _scan_f_kernel)",
        [got[k] for k in scan.NAMES], [want[k] for k in scan.NAMES], None,
        lambda: scan.join_scans(tag, first),
        lambda: scan.join_scans_reference(tag, first), None,
        nbytes=2 * n + 6 * 4 * n, ops=40 * n)
    total = int(want["cnt"].sum(dtype=torch.int64))
    del got, want
    kept = {}
    for name, site in (("stream_compact[record, nccl bucket]",
                        "compact_records"),
                       ("stream_compact[pack, nccl bucket]",
                        "pack_matched_builds")):
        mask, pos, lanes, cap = calls[site]
        kept[site] = min(int(mask.sum()), cap)
        lib = (lambda m=mask, packed=torch.stack(lanes, 1): packed[m])
        got = compact.stream_compact(mask, pos, lanes, cap)
        want = compact.stream_compact_reference(mask, pos, lanes, cap)
        check_and_time(
            rows, name, "distributed_join_tpu_torch/csrc/stream_compact.cu",
            "distributed_join_tpu/ops/compact_planes.py:53 (_compact_kernel)"
            "; distributed_join_tpu/ops/compact_pallas.py:62 "
            "(_compact_kernel)",
            got, want, kept[site],
            lambda m=mask, q=pos, ls=lanes, c=cap: compact.stream_compact(
                m, q, ls, c),
            lambda m=mask, q=pos, ls=lanes, c=cap:
                compact.stream_compact_reference(m, q, ls, c),
            lib, nbytes=n + 2 * kept[site] * 8 * len(lanes), ops=n)
        del got, want, lib
    S, rc, cap, lo, pk = calls["expand_gather"]
    tot = min(total, cap)
    got_r, got_b = expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk)
    want_r, want_b = expand.expand_gather_reference(S, rc, cap, lo=lo,
                                                    build_cols=pk)
    check_and_time(
        rows, "expand_gather[build, nccl bucket]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_pallas.py:335 (_expand_kernel_b8)",
        got_r + got_b, want_r + want_b, tot,
        lambda: expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk),
        lambda: expand.expand_gather_reference(S, rc, cap, lo=lo,
                                               build_cols=pk), None,
        nbytes=kept["compact_records"] * (4 + 4 + 8 * len(rc))
        + kept["pack_matched_builds"] * 8 * len(pk)
        + tot * 8 * (len(rc) + len(pk)), ops=tot * 2 * 32)
    for r in rows:
        r["merged_positions"] = n
    return rows


def partition_shuffle_ms(comm, build, probe) -> tuple:
    """The partition and the NCCL shuffle of one join at
    over-decomposition ``NCCL_K``, with no local join: the step's own
    calls (parallel/distributed_join.py ``make_join_step``) at its
    default capacity factor. Returns, each the slowest rank's: the ms a
    call as ``time_ms`` times it (host gaps included), and the device ms
    of its kernels as ``device_ms`` sums them, NCCL's apart (an NCCL
    kernel also counts the time it waits for a peer)."""
    import math

    from distributed_join_tpu_torch.ops.partition import (
        radix_hash_partition,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_SHUFFLE_CAPACITY_FACTOR,
        _round_up,
    )
    from distributed_join_tpu_torch.parallel.shuffle import shuffle_padded
    n = comm.n_ranks
    nb = NCCL_K * n

    def step(b_local, p_local):
        rows = 0
        for t in (b_local, p_local):
            cap = _round_up(int(math.ceil(
                t.capacity / nb * DEFAULT_SHUFFLE_CAPACITY_FACTOR)), 8)
            pt = radix_hash_partition(t, ["key"], nb)
            for b in range(NCCL_K):
                padded, counts, _, _ = pt.to_padded(
                    cap, bucket_start=b * n, n_buckets=n)
                recv, _ = shuffle_padded(comm, padded, counts, cap)
                rows += recv.capacity
        return torch.tensor([rows], device=b_local.valid.device)

    fn = comm.spmd(step, sharded_out=True)
    ms = comm.host_max(time_ms(lambda: fn(build, probe)))
    # the first profiler of a process starts CUPTI, which stalls this
    # rank while its peers' NCCL kernels wait: that run is not kept
    device_ms(lambda: fn(build, probe), reps=1)
    _, parts = device_ms(lambda: fn(build, probe))
    nccl = sum(v for k, v in parts.items() if "nccl" in k.lower())
    other = sum(parts.values()) - nccl
    return ms, comm.host_max(other), comm.host_max(nccl)


def nccl_rank_worker() -> int:
    """One rank of phase 13(b), started by the launcher: the global
    tables of ``NROWS`` rows a rank from the seed, one untimed
    ``distributed_inner_join`` over NCCL at over-decomposition
    ``NCCL_K`` with the launch counts set to zero just before it and read
    just after, then this rank's row digest and counts, all-gathered to
    rank 0, which prints them as one JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_join_tpu_torch.parallel.bootstrap import (
        maybe_initialize_from_env,
    )
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    _check(maybe_initialize_from_env(), "the worker runs under the launcher")
    comm = make_communicator("nccl")
    n = comm.n_ranks
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS * n, probe_nrows=NROWS * n,
        unique_build_keys=True, device=comm.device)
    rank0 = comm.axis_index() == 0
    join = (lambda: distributed_inner_join(
        build, probe, comm, over_decomposition=NCCL_K))
    if rank0:
        (res, counts), calls = captured_join_calls(lambda: counted(join))
    else:
        res, counts = counted(join)
    digest = row_digest(res)
    mine = torch.tensor([[*digest, int(res.total), int(res.overflow),
                          *(counts[s] for s in NCCL_SITES)]],
                        dtype=torch.int64, device=comm.device)
    del res
    # rank 0's kernel checks launch nothing on the path: its counts are
    # read above; the other ranks wait at the next collective
    rows = bucket_kernel_rows(calls) if rank0 else []
    if rank0:
        del calls
    ps_ms = partition_shuffle_ms(comm, build, probe)
    every = comm.all_gather(mine).tolist()
    if rank0:
        print(json.dumps({"ranks": [
            {"digest": v[:3], "total": v[3], "overflow": bool(v[4]),
             "launches": dict(zip(NCCL_SITES, v[5:]))} for v in every],
            "bucket_rows": rows, "partition_shuffle_ms": ps_ms}),
            flush=True)
    comm.finalize()
    return 0


def _combine_digests(digests) -> tuple:
    """Per-rank row digests as one: rows and hash sums add (the sum
    wrapping in 64 bits, as ``row_digest``'s), xors fold."""
    rows, total, x = 0, 0, 0
    for d in digests:
        rows += d[0]
        total = (total + d[1] + 2**63) % 2**64 - 2**63
        x ^= d[2]
    return rows, total, x


def nccl_phase() -> dict:
    """Phase 13: the port's driver over NCCL on every card, one process
    a card (a world of 1 on a one-card machine), at ``NROWS`` rows a
    rank; the worker's join digests against the plain 1-rank join of the
    same global tables; the all-to-all benchmark. Returns the launch
    counts summed over ranks, by call site, and the kernel rows at a
    bucket's shapes (rank 0)."""
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    smi = gpu_line()
    n = torch.cuda.device_count()
    rows = NROWS * n
    # the driver's tables: selectivity 0.3, unique build keys
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=rows, probe_nrows=rows,
        unique_build_keys=True, device=DEVICE)
    plain = distributed_inner_join(build, probe, LocalCommunicator(),
                                   kernel_config=KernelConfig("plain"))
    _check(not bool(plain.overflow), "phase 13: the 1-rank join overflowed")
    want_total, want_digest = int(plain.total), row_digest(plain)
    del build, probe, plain
    torch.cuda.empty_cache()
    print(f"[nccl] {n} process(es), one a card; global tables {rows:,} x "
          f"{rows:,}; the plain 1-rank join: total={want_total} digest="
          f"{want_digest}", flush=True)

    driver = ["-m", "distributed_join_tpu_torch.benchmarks.distributed_join",
              "--communicator", "nccl", "--build-table-nrows", str(rows),
              "--probe-table-nrows", str(rows), "--iterations", "4"]
    for k in (1, NCCL_K):
        rec = _launched_record(f"nccl k={k}", n, [
            *driver, "--over-decomposition-factor", str(k)])
        print(f"[nccl] k={k} " + json.dumps(rec), flush=True)
        _check(rec["communicator"] == "nccl" and rec["n_ranks"] == n,
               f"nccl k={k}: record of {rec['communicator']} x "
               f"{rec['n_ranks']}")
        _check(not rec["overflow"], f"nccl k={k}: the join overflowed")
        _check(rec["matches_per_join"] == want_total,
               f"nccl k={k}: {rec['matches_per_join']} matches, the 1-rank "
               f"join has {want_total}")
        print(f"[nccl] k={k}: {rec['elapsed_per_join_s'] * 1e3:.3f} ms a "
              f"join, {rec['m_rows_per_sec_per_rank']:.2f} M rows/s a rank "
              f"({n} rank(s)); {smi}", flush=True)
    prof = _launched_record("nccl profile", n, [
        *driver, "--over-decomposition-factor", str(NCCL_K),
        "--profile", "3"])
    print(f"[nccl] profile k={NCCL_K}, rank 0: " + json.dumps(prof),
          flush=True)

    worker = _launched_record("nccl worker", n, [
        os.path.abspath(__file__), "--nccl-rank-worker"])
    got = worker["ranks"]
    _check(len(got) == n, f"nccl worker: {len(got)} ranks reported")
    ps_ms, ps_busy, ps_nccl = worker["partition_shuffle_ms"]
    print(f"[nccl] partition + shuffle at k={NCCL_K}, no local join: "
          f"{ps_ms:.4f} ms a join; device ms of its kernels {ps_busy:.4f} "
          f"besides NCCL's {ps_nccl:.4f} (slowest rank of {n}); {smi}",
          flush=True)
    for r, g in enumerate(got):
        print(f"[nccl] worker rank {r}: {json.dumps(g)}", flush=True)
        _check(not g["overflow"] and g["total"] == want_total,
               f"nccl worker rank {r}: total {g['total']}, overflow "
               f"{g['overflow']}")
        _require_launched(g["launches"], JOIN_KERNELS,
                          f"rank {r} of the NCCL path")
    combined = _combine_digests(tuple(g["digest"]) for g in got)
    _check(combined == want_digest,
           f"nccl worker: combined digest {combined} != the plain 1-rank "
           f"join's {want_digest}")
    print(f"[nccl] combined row digest over {n} rank(s) equals the plain "
          "1-rank join's", flush=True)

    a2a = ["-m", "distributed_join_tpu_torch.benchmarks.all_to_all",
           "--communicator", "nccl"]
    if n < 2:
        r = _launch(n, [*a2a, "--buffer-size", str(A2A_MIB[0] << 20)])
        _check(r.returncode != 0 and "needs >= 2 ranks" in r.stderr,
               "all_to_all on one card: expected its refusal")
        print("[nccl] all_to_all needs >= 2 ranks: one card, not measured "
              "(the benchmark refused, as the JAX benchmark does)",
              flush=True)
    for mib in (A2A_MIB if n >= 2 else ()):
        rec = _launched_record(f"all_to_all {mib} MiB", n, [
            *a2a, "--buffer-size", str(mib << 20)])
        print(f"[nccl] all_to_all {mib} MiB a rank x {n}: "
              f"{rec['aggregate_offchip_gb_per_sec']:.2f} GB/s off-chip, "
              f"{rec['aggregate_gb_per_sec_incl_local']:.2f} GB/s incl. "
              f"local ({rec['elapsed_per_exchange_s'] * 1e3:.4f} ms an "
              f"exchange, median window); {smi}", flush=True)
    return ({s: sum(g["launches"][s] for g in got) for s in NCCL_SITES},
            worker["bucket_rows"])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv not in ([], ["--phase", "13"], ["--nccl-rank-worker"]):
        print("usage: chip_smoke.py [--phase 13]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from distributed_join_tpu_torch.ops import _kernels
    except ModuleNotFoundError:
        print("chip_smoke: distributed_join_tpu_torch/ is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 3
    if argv == ["--nccl-rank-worker"]:
        return nccl_rank_worker()
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    t_start = time.perf_counter()
    smi = gpu_line()
    print(f"[gpu] {smi}", flush=True)
    print(f"[gpu] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    reports = _kernels.build(verbose=True)
    secs = time.perf_counter() - t0
    print(f"[build] {len(_kernels.SOURCES)} kernel libraries in "
          f"{secs:.2f} s (nvcc, sm_90a, in parallel)", flush=True)
    for name, text in reports.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "stack frame" in ln]
        print(f"[build] {name}: " + " | ".join(regs), flush=True)
    ok = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    if argv == ["--phase", "13"]:
        nccl, _ = nccl_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"nccl_launches": nccl}), flush=True)
        print(ok, flush=True)
        return 0

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS, device=DEVICE)
    rows = kernel_phase(build, probe, int(0.6 * NROWS * 1.25))
    own = entry_points_phase(build, probe)
    del build, probe
    torch.cuda.empty_cache()

    _, head = headline_phase()
    rec = record_mode_phase()
    emulated_phase()
    skew_row, c3 = config3_phase()
    zipf_emulated_phase()
    c1 = c1_phase()
    paths = {"config5": config5_phase(), **types_phase()}
    emulated_strings_phase()
    typed, typed_ms, typed_rows = typed_phase()
    paths.update(typed)
    print(f"[typed] ms_per_join {json.dumps(typed_ms)}; {smi}", flush=True)
    paths["nccl"], bucket_rows = nccl_phase()

    launches = {"join_scans": head["join_scans"],
                "stream_compact[record]": head["compact_records"],
                "stream_compact[pack]": head["pack_matched_builds"],
                "stream_compact[skew]": c3["extract_prefix"],
                "expand_gather[build]": head["expand_gather"],
                "expand_gather[record]": rec["expand_gather"],
                **{k: own[k] for k in ("merge_sort[key+tag]",
                                       "merge_sort[key]")},
                **{k: own[k] for k in ("expand_pull[build]",
                                       "expand_pull[record]")},
                "stream_compact[record, full_outer]":
                    typed["full_outer"]["compact_records"],
                "stream_compact[valid-build pack]":
                    typed["full_outer"]["pack_valid_builds"],
                "expand_gather[build, full_outer]":
                    typed["full_outer"]["expand_gather"],
                "expand_gather[record, anti]": typed["anti"]["expand_gather"],
                "join_scans[nccl bucket]": paths["nccl"]["join_scans"],
                "stream_compact[record, nccl bucket]":
                    paths["nccl"]["compact_records"],
                "stream_compact[pack, nccl bucket]":
                    paths["nccl"]["pack_matched_builds"],
                "expand_gather[build, nccl bucket]":
                    paths["nccl"]["expand_gather"]}
    # the join sites' launches on the paths of phases 10-12, each path's
    # own run
    site = {"join_scans": "join_scans",
            "stream_compact[record]": "compact_records",
            "stream_compact[pack]": "pack_matched_builds",
            "stream_compact[valid-build pack]": "pack_valid_builds",
            "expand_gather[build]": "expand_gather"}
    by_name = {r["name"]: r for r in [*rows, skew_row, *typed_rows,
                                      *bucket_rows]}
    kernels = []
    for name, count in launches.items():
        r = dict(by_name[name], launches=count)
        if name in site:
            r["launches_by_path"] = {p: c[site[name]]
                                     for p, c in paths.items()}
        if name == "join_scans":
            r["c1_ms"], r["c1_bound_ms"] = c1["ms"], c1["bound_ms"]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            *[k for k in r if k.endswith("_ms") and k not in (
                "ms", "plain_ms", "bound_ms", "library_ms")],
            *(["live_passes"] if "live_passes" in r else []),
            *(["merged_positions"] if "merged_positions" in r else []),
            *(["launches_by_path"] if "launches_by_path" in r else []))})
    print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ok, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
