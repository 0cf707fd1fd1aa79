"""A/B of join_scans kernel sources on one GPU, in one process.

    python3 scripts/join_scans_ab.py [VARIANT.cu ...]

Builds ``distributed_join_tpu_torch/csrc/join_scans.cu`` and each
variant source given (a copy of that file with a change; it must keep
the ``djt_join_scans`` C interface, and includes ``common.cuh`` by a
path that resolves from where it lies) into libraries of their own with
the port's nvcc flags, then, on the headline's merged domain (10 M x 10 M
rows, selectivity 0.3, seed 42: 20 M positions), checks each against
``join_scans_reference`` and times it with ``chip_smoke.py``'s timers:
call ms by CUDA events and device ms by torch.profiler, 20 calls, each
source twice in the order A B ... B A. Variants whose outputs differ are
timed too and marked: a diagnostic variant may drop work on purpose.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from distributed_join_tpu_torch.ops import _kernels, scan  # noqa: E402
from distributed_join_tpu_torch.ops import join as J  # noqa: E402
from distributed_join_tpu_torch.utils.generators import (  # noqa: E402
    generate_build_probe_tables,
)

REPS = 20


def build(sources: dict, out_dir: str) -> dict:
    """{name: loaded library}, one nvcc per source, all started together."""
    procs = {}
    for name, path in sources.items():
        cmd = [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", os.path.join(out_dir, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        print(f"[build] {name} rc={proc.returncode}: " + " | ".join(regs),
              flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} did not build:\n{text}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, (res, args) in scan._SIGNATURES.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        libs[name] = lib
    return libs


def call(lib, tag, first) -> dict:
    n = tag.shape[0]
    outs = {k: torch.empty(n, dtype=torch.int32, device=tag.device)
            for k in scan.NAMES}
    scratch = torch.empty(lib.djt_join_scans_scratch_bytes(n),
                          dtype=torch.uint8, device=tag.device)
    p = _kernels.ptr
    rc = lib.djt_join_scans(
        p(tag), p(first), p(outs["matched"]), p(outs["cnt"]),
        p(outs["start_out"]), p(outs["lo_m"]), p(outs["rec_pos"]),
        p(outs["mb_pos"]), n, p(scratch), _kernels.stream(tag.device))
    if rc != 0:
        raise RuntimeError(f"djt_join_scans returned {rc}")
    return outs


def main(variants: list) -> int:
    if not torch.cuda.is_available():
        print("join_scans_ab: no CUDA device", file=sys.stderr)
        return 2
    sources = {"repo": os.path.join(str(_kernels.CSRC), "join_scans.cu")}
    for path in variants:
        sources[os.path.splitext(os.path.basename(path))[0]] = path
    with tempfile.TemporaryDirectory() as out_dir:
        libs = build(sources, out_dir)
        build_t, probe_t = generate_build_probe_tables(
            seed=chip_smoke.SEED, build_nrows=chip_smoke.NROWS,
            probe_nrows=chip_smoke.NROWS, selectivity=0.3, device="cuda")
        skeys, stag, _ = J._merged_sort(build_t, probe_t, ["key"],
                                        ["build_payload"], ["probe_payload"])
        first = J._run_starts(skeys)
        del build_t, probe_t, skeys
        want = scan.join_scans_reference(stag, first)
        print(f"[ab] n={stag.shape[0]} {chip_smoke.gpu_line()}", flush=True)
        for name, lib in libs.items():
            got = call(lib, stag, first)
            torch.cuda.synchronize()
            bad = [k for k in scan.NAMES if not torch.equal(got[k], want[k])]
            print(f"[ab] {name}: equal={not bad} {bad}", flush=True)
        names = list(libs)
        for name in names + names[::-1]:
            fn = (lambda lib=libs[name]: call(lib, stag, first))
            ms = chip_smoke.time_ms(fn, REPS)
            dev, parts = chip_smoke.device_ms(fn, REPS)
            print(f"[ab] {name}: ms={ms:.4f} device_ms={dev:.4f} " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(parts.items(),
                                                  key=lambda kv: -kv[1])),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
