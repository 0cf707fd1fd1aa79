"""A/B of expand_gather kernel sources on one GPU, in one process.

    python3 scripts/expand_ab.py [--config3] [VARIANT.cu ...]

Builds ``distributed_join_tpu_torch/csrc/expand_gather.cu`` and each
variant source given (a copy of that file with a change; it must keep
the ``djt_expand_gather`` C interface; ``common.cuh`` resolves from
``csrc/``) into libraries of their own with the port's nvcc flags. On
the expand's inputs inside the headline join (10 M x 10 M rows,
selectivity 0.3, seed 42: 7.5 M output slots, 2 record lanes, 1 build
lane), or with ``--config3`` inside BASELINE config 3's naive join
(50 M x 50 M rows, Zipf alpha 1.5, unique build keys: 60 M slots, 50 M
records of run length 1), it checks each library against
``expand_gather_reference`` in build mode and record mode (bit-identical
over the join's total), prints each mode's byte bound (each live record
and matched build row read once, each output slot up to the total
written once, at 3.35 TB/s), and times each source with
``chip_smoke.py``'s timers: call ms by CUDA events and device ms by
torch.profiler, 20 calls, each source twice in the order A B ... B A.
Variants whose outputs differ are timed too and marked.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from distributed_join_tpu_torch.ops import _kernels, expand  # noqa: E402

REPS = 20


def build(sources: dict, out_dir: str) -> dict:
    """{name: loaded library}, one nvcc per source, all started together."""
    procs = {}
    for name, path in sources.items():
        cmd = [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(_kernels.CSRC),
               "-o", os.path.join(out_dir, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "stack frame" in ln]
        print(f"[build] {name} rc={proc.returncode}: " + " | ".join(regs),
              flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} did not build:\n{text}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.djt_error_string.restype = ctypes.c_char_p
        lib.djt_error_string.argtypes = [ctypes.c_int]
        for fn, (res, args) in expand._SIGNATURES.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        libs[name] = lib
    return libs


def inputs(config3: bool) -> dict:
    """The expand's inputs inside the chosen join (chip_smoke's
    ``stage_inputs``, made with the plain twins)."""
    if config3:
        from distributed_join_tpu_torch.benchmarks import distributed_join as D
        args = chip_smoke._config3_args(False)
        build_t, probe_t, _ = D.make_tables(args, torch.device("cuda"))
        out_cap = -(-int(args.probe_table_nrows * 1.2) // 8) * 8
    else:
        from distributed_join_tpu_torch.utils.generators import (
            generate_build_probe_tables,
        )
        build_t, probe_t = generate_build_probe_tables(
            seed=chip_smoke.SEED, build_nrows=chip_smoke.NROWS,
            probe_nrows=chip_smoke.NROWS, selectivity=0.3, device="cuda")
        out_cap = int(0.6 * chip_smoke.NROWS * 1.25)
    x = chip_smoke.stage_inputs(build_t, probe_t, out_cap)
    keep = ("S", "lo", "rec_cols", "pack", "kept", "total", "n_matched",
            "out_cap")
    return {k: x[k] for k in keep}


def flat(out) -> list:
    """Every output tensor of one expand_gather call, either mode."""
    rec, rest = out
    return [*rec, *(rest if isinstance(rest, list) else [rest])]


def main(argv: list) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config3", action="store_true")
    ap.add_argument("variants", nargs="*")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("expand_ab: no CUDA device", file=sys.stderr)
        return 2
    sources = {"repo": os.path.join(str(_kernels.CSRC), "expand_gather.cu")}
    for path in opts.variants:
        sources[os.path.splitext(os.path.basename(path))[0]] = path
    with tempfile.TemporaryDirectory() as out_dir:
        libs = build(sources, out_dir)
        x = inputs(opts.config3)
        torch.cuda.empty_cache()
        S, lo, rc, pk, cap = x["S"], x["lo"], x["rec_cols"], x["pack"], \
            x["out_cap"]
        tot = min(x["total"], cap)
        kk, kb = len(rc), len(pk)
        modes = {
            "build": (lambda: expand.expand_gather(S, rc, cap, lo=lo,
                                                   build_cols=pk),
                      expand.expand_gather_reference(S, rc, cap, lo=lo,
                                                     build_cols=pk),
                      x["kept"] * (4 + 4 + 8 * kk) + x["n_matched"] * 8 * kb
                      + tot * 8 * (kk + kb)),
            "record": (lambda: expand.expand_gather(S, rc, cap),
                       expand.expand_gather_reference(S, rc, cap),
                       x["kept"] * (4 + 8 * kk) + tot * (8 * kk + 4)),
        }
        print(f"[ab] {'config3 naive' if opts.config3 else 'headline'}: "
              f"out_capacity={cap} records={x['kept']} total={x['total']} "
              f"matched_builds={x['n_matched']} record_lanes={kk} "
              f"build_lanes={kb}; {chip_smoke.gpu_line()}", flush=True)
        for mode, (_, _, nbytes) in modes.items():
            b, by = chip_smoke.bound_ms(nbytes, 0)
            print(f"[ab] bound {mode}: {nbytes} bytes, {b:.4f} ms ({by})",
                  flush=True)
        for name, lib in libs.items():
            _kernels._LIBS["expand_gather"] = lib
            for mode, (fn, want, _) in modes.items():
                got = fn()
                torch.cuda.synchronize()
                got, want = flat(got), flat(want)
                equal = all(torch.equal(g[:tot], w[:tot])
                            for g, w in zip(got, want))
                print(f"[ab] {name} {mode}: equal={equal}", flush=True)
                del got
        names = list(libs)
        for name in names + names[::-1]:
            _kernels._LIBS["expand_gather"] = libs[name]
            for mode, (fn, _, _) in modes.items():
                ms = chip_smoke.time_ms(fn, REPS)
                dev, parts = chip_smoke.device_ms(fn, REPS)
                print(f"[ab] {name} {mode}: ms={ms:.4f} device_ms={dev:.4f} "
                      + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                          parts.items(), key=lambda kv: -kv[1])), flush=True)
        _kernels._LIBS.pop("expand_gather", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
