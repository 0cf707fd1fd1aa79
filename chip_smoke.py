"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. The card's name and power limit (nvidia-smi); the build of every
   kernel in distributed_join_tpu_torch/csrc (one nvcc each, in
   parallel), with its wall time.
2. Each kernel against its plain PyTorch twin at the headline's shapes
   (10 M x 10 M rows, selectivity 0.3, seed 42): the fused join scans
   over the 20 M merged positions, both stream compactions, and the
   expand-gather in build mode and record mode. Outputs must be
   bit-identical over the prefix each contract defines. Times with CUDA
   events: kernel, plain twin, one PyTorch library call where one
   computes the same function, and the bound (bytes this data needs over
   3.35 TB/s, or operations over the scalar rate, whichever is larger).
3. The headline protocol (python -m distributed_join_tpu_torch.bench):
   no overflow, every kernel launched, and an order-independent digest of
   the result rows equal to the same join forced through the plain path;
   plus a small join held against the CPU path.
4. A join without build payloads (the expand's record mode) against the
   plain path.
5. An emulated 4-rank join on the one card (hash -> partition -> padded
   shuffle -> local join) at 2 M x 2 M rows, equal to the 1-rank join.

Launch counts are set to zero just before each path and read just after;
the launches of phase 2 do not count. The line before the last is one
JSON object with every kernel's numbers; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
with code 2, and without the package beside it with code 3; neither
prints a result.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 42
NROWS = 10_000_000
EMU_ROWS = 2_000_000
EMU_RANKS = 4
REPS = 10
DEVICE = "cuda"


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
    and xor of a 64-bit hash of each row)."""
    from distributed_join_tpu_torch.ops.hashing import fmix64, hash_combine
    t = res.table
    h = None
    for name in t.column_names:
        c = t.columns[name]
        hc = fmix64(c if not c.dtype.is_floating_point
                    else c.view(torch.int32))
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
                nb=build.capacity, out_cap=out_cap)


def kernel_phase(build, probe, out_cap: int) -> list:
    from distributed_join_tpu_torch.ops import compact, expand, scan

    x = stage_inputs(build, probe, out_cap)
    n = x["tag"].shape[0]
    rows = []

    def add(name, source, replaces, got, want, prefix, fn_k, fn_p, fn_lib,
            nbytes, ops):
        torch.cuda.synchronize()
        err = max_abs_err(got, want, prefix)
        _check(err == 0, f"{name}: kernel disagrees with its plain twin "
                         f"(max_abs_err {err})")
        b, by = bound_ms(nbytes, ops)
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   max_abs_err=err, ms=time_ms(fn_k), plain_ms=time_ms(fn_p),
                   bound_ms=b, bound_by=by,
                   library_ms=None if fn_lib is None else time_ms(fn_lib))
        print(f"[kernel] {name}: kernel_ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={b:.4f} ({by}) "
              f"library_ms={row['library_ms']} max_abs_err={err}",
              flush=True)
        rows.append(row)

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

    # both compactions of one join (the wrapper's two call sites): the
    # run-record block, 4 lanes, 20 M -> out_cap, then the matched-build
    # pack, 1 lane, 20 M -> nb; each checked over its survivor prefix
    surv = int(x["is_rec"].sum())
    kept = min(surv, out_cap)
    k = len(x["rec_lanes"])
    nm = x["n_matched"]
    mask_r, mask_m = x["is_rec"], x["matched"]
    packed = torch.stack(x["rec_lanes"], 1)
    pack_lane = x["pack_lane"][0]

    def both(fn):
        return (fn(mask_r, x["rec_pos"], x["rec_lanes"], out_cap),
                fn(mask_m, x["mb_pos"], x["pack_lane"], x["nb"]))

    got_r, got_p = both(compact.stream_compact)
    want_r, want_p = both(compact.stream_compact_reference)
    add("stream_compact",
        "distributed_join_tpu_torch/csrc/stream_compact.cu",
        "distributed_join_tpu/ops/compact_planes.py:53 (_compact_kernel); "
        "distributed_join_tpu/ops/compact_pallas.py:62 (_compact_kernel)",
        [g[:kept] for g in got_r] + [g[:nm] for g in got_p],
        [w[:kept] for w in want_r] + [w[:nm] for w in want_p], None,
        lambda: both(compact.stream_compact),
        lambda: both(compact.stream_compact_reference),
        lambda: (packed[mask_r], pack_lane[mask_m]),
        nbytes=2 * n + surv * (4 + 8 * k) + kept * 8 * k
        + nm * (4 + 8) + nm * 8, ops=2 * n)
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
    return rows


# -- the paths ----------------------------------------------------------


def counted(fn):
    """Run ``fn`` with every launch count set to zero; returns (its
    result, the counts it left)."""
    from distributed_join_tpu_torch.ops import _kernels, compact, expand, scan
    wrappers = (scan.join_scans, compact.stream_compact, expand.expand_gather)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts(*wrappers)
    out = fn()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in wrappers}


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
    for name, c in counts.items():
        _check(c > 0, f"{name} was not launched on the headline path")

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
    for name, c in counts.items():
        _check(c > 0, f"{name} was not launched on the emulated path")
    print(f"[emulated] {EMU_RANKS} ranks on one card: total="
          f"{int(multi.total)} equal to 1 rank; wall {wall:.3f} s "
          f"(host clock, first call); launches {counts}", flush=True)
    return counts


def main() -> int:
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

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS, device=DEVICE)
    rows = kernel_phase(build, probe, int(0.6 * NROWS * 1.25))
    del build, probe
    torch.cuda.empty_cache()

    _, head = headline_phase()
    rec = record_mode_phase()
    emulated_phase()

    launches = {"join_scans": head["join_scans"],
                "stream_compact": head["stream_compact"],
                "expand_gather[build]": head["expand_gather"],
                "expand_gather[record]": rec["expand_gather"]}
    kernels = []
    for r in rows:
        r = dict(r, launches=launches[r["name"]])
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
