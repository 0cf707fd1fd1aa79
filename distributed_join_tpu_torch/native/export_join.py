"""Stage the native C++ driver (``native/join_main.cpp``): write its
sidecar, build the kernels it calls, and compile it against libtorch.

Port of ``native/export_join.py`` of the JAX package. There the compute
definition is exported as a StableHLO artifact that a C++ ``main`` runs
through the PJRT C API; here the C++ ``main`` links libtorch and runs
the one-rank inner join itself, calling the hand-written kernels of
``csrc/`` through their C entry points. What is left to stage:

  1. ``join_step.meta`` (key=value, read by the driver) and
     ``join_step.json`` (the JAX package's sidecar fields, with
     ``device``, the card's name, where JAX has ``platforms``; there is
     no StableHLO artifact and no ``compile_options.pb``: those are
     PJRT mechanisms). The meta lists the kernel libraries the driver
     ``dlopen``s (``ops/_kernels.py`` names them, and builds them here);
  2. the driver binary (:func:`build_driver`, ``--build-driver``).

:func:`build_looped_join` is the Python program the driver mirrors:
``iterations`` dependent joins of ``make_join_step`` over a
``LocalCommunicator`` with both keys shifted by the loop counter, the
same three outputs as the JAX package's exported program. On a card:

    python -m distributed_join_tpu_torch.native.export_join \\
        --build-table-nrows 10000000 --probe-table-nrows 10000000 \\
        --iterations 8 -o build/native/artifacts --build-driver

then ``build/native/join_main-<digest> --artifact-dir
build/native/artifacts`` (``--device cpu`` for the plain twins; the
export then takes ``--device cpu`` too).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

from distributed_join_tpu_torch.ops import _kernels

SOURCE = Path(__file__).resolve().parent / "join_main.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# The kernels the driver calls, in the meta as lib_<name>=<path>.
DRIVER_KERNELS = ("join_scans", "stream_compact", "expand_gather")
ARG_NAMES = ("build_key", "build_payload", "build_valid",
             "probe_key", "probe_payload", "probe_valid")
OUTPUTS = (("total_matches_x_iters", "int64"), ("overflow", "bool"),
           ("dce_guard_checksum", "int64"))


def build_looped_join(b_rows: int, p_rows: int, iterations: int,
                      out_rows: int, device):
    """``(looped, args)``: ``looped(bkey, bpay, bvalid, pkey, ppay,
    pvalid) -> (total x iterations, overflow, checksum)`` as 0-d tensors
    on ``device``, and the arguments' ``(name, shape, dtype)``. The
    checksum is ``consume_all_columns`` of every join's result, summed.
    Nothing is read back to the host inside."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_join_step,
    )
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.benchmarking import (
        consume_all_columns,
    )

    step = make_join_step(LocalCommunicator(), key="key",
                          out_rows_per_rank=out_rows)
    device = torch.device(device)

    def looped(bkey, bpay, bvalid, pkey, ppay, pvalid):
        total = torch.zeros((), dtype=torch.int64, device=device)
        overflow = torch.zeros((), dtype=torch.bool, device=device)
        consumed = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(iterations):
            build = Table({"key": bkey + i, "build_payload": bpay}, bvalid)
            probe = Table({"key": pkey + i, "probe_payload": ppay}, pvalid)
            res = step(build, probe)
            total = total + res.total.to(torch.int64)
            overflow = overflow | res.overflow
            consumed = consumed + consume_all_columns(res.table)
        return total, overflow, consumed

    args = [(nm, (rows,), dt) for nm, rows, dt in zip(
        ARG_NAMES, (b_rows, b_rows, b_rows, p_rows, p_rows, p_rows),
        ("int64", "int64", "bool", "int64", "int64", "bool"))]
    return looped, args


def load_tables(dump_dir, b_rows: int, p_rows: int, device="cpu"):
    """The six columns the driver wrote with ``--dump-tables``, as
    tensors on ``device`` in :data:`ARG_NAMES` order."""
    import numpy as np

    out = []
    for nm, rows in zip(ARG_NAMES, (b_rows,) * 3 + (p_rows,) * 3):
        dt = np.bool_ if nm.endswith("valid") else np.dtype("<i8")
        a = np.fromfile(os.path.join(dump_dir, f"{nm}.bin"), dtype=dt)
        if a.shape != (rows,):
            raise ValueError(f"{nm}.bin holds {a.shape[0]} rows, not {rows}")
        out.append(torch.from_numpy(a).to(device))
    return out


def numpy_reference(cols, iterations: int, out_rows: int) -> list:
    """``[total x iterations, overflow, checksum]`` of the looped join
    over the six columns (numpy arrays or tensors, :data:`ARG_NAMES`
    order), by a sort and binary searches alone: none of the port's join
    code. Build keys may repeat. Shifting both keys by the loop counter
    keeps every pair, so a join's output is the same pairs each time,
    with the key column ``+ i``; the checksum sums the key and both
    payloads over the pairs, wrapping as int64 does. A join overflows
    past ``out_rows`` rounded up to 8, the block ``make_join_step``
    allocates; the checksum is defined only where none does (the device
    then keeps an unspecified block of the pairs): there it is None."""
    import numpy as np

    bk, bp, bv, pk, pp, pv = (np.asarray(c) for c in cols)
    bk, bp = bk[bv.astype(bool)], bp[bv.astype(bool)]
    pk, pp = pk[pv.astype(bool)], pp[pv.astype(bool)]
    order = np.argsort(bk, kind="stable")
    sk = bk[order]
    run_sum = np.concatenate([[0], np.cumsum(bp[order], dtype=np.int64)])
    lo = np.searchsorted(sk, pk, "left")
    hi = np.searchsorted(sk, pk, "right")
    cnt = (hi - lo).astype(np.int64)
    pairs = int(cnt.sum())
    one_join = (int((cnt * pk).sum()) + int((cnt * pp).sum())
                + int((run_sum[hi] - run_sum[lo]).sum()))
    if pairs > (out_rows + 7) // 8 * 8:
        return [iterations * pairs, True, None]
    checksum = (iterations * one_join
                + pairs * (iterations * (iterations - 1) // 2))
    return [iterations * pairs, False,
            (checksum + 2**63) % 2**64 - 2**63]


def _driver_flags() -> list:
    """g++ flags of the driver: libtorch's headers and libraries, its C++
    ABI, and on a CUDA build of torch its CUDA libraries linked whether or
    not a symbol is used: their static initialisers register the CUDA
    backend, without which ``torch::cuda::is_available()`` reads false on
    a card."""
    from torch.utils import cpp_extension

    flags = ["-O2", "-std=c++20", "-Wall",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    libs = []
    for p in cpp_extension.library_paths():
        libs += [f"-L{p}", f"-Wl,-rpath,{p}"]
    if torch.version.cuda is not None:
        libs += ["-Wl,--no-as-needed", "-ltorch_cuda", "-lc10_cuda",
                 "-Wl,--as-needed"]
    libs += ["-ltorch", "-ltorch_cpu", "-lc10", "-ldl",
             "-Wl,--allow-shlib-undefined"]
    return flags, libs


def driver_path() -> Path:
    flags, libs = _driver_flags()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags + libs).encode())
    return BUILD_DIR / f"join_main-{h.hexdigest()[:16]}"


def build_driver(verbose: bool = False) -> Path:
    """Compile ``join_main.cpp`` with ``g++`` into
    ``build/native/join_main-<digest of source and flags>``, unless that
    binary exists. Returns its path; raises with the compiler's output
    if the build fails."""
    out = driver_path()
    if out.exists():
        return out
    flags, libs = _driver_flags()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-o", str(tmp), str(SOURCE), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"join_main build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, file=sys.stderr)
    os.replace(tmp, out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--build-table-nrows", type=int, default=1_000_000)
    p.add_argument("--probe-table-nrows", type=int, default=1_000_000)
    p.add_argument("--selectivity", type=float, default=0.3,
                   help="recorded in the sidecar (the native generator "
                        "reads it); output capacity is probe rows x "
                        "--out-capacity-factor")
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--out-capacity-factor", type=float, default=1.2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default): build the kernels the driver "
                        "calls; cpu: the driver's --device cpu, no build")
    p.add_argument("--build-driver", action="store_true",
                   help="also compile join_main.cpp (g++) and print its path")
    p.add_argument("-o", "--output-dir", default="build/native/artifacts")
    args = p.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("export_join: CUDA is not available (pass "
                             "--device cpu for the driver's plain twins)")
        _kernels.build(DRIVER_KERNELS)
        device = torch.cuda.get_device_name(0)
    else:
        device = "cpu"

    b, pr = args.build_table_nrows, args.probe_table_nrows
    out_rows = int(math.ceil(pr * args.out_capacity_factor))
    _, arg_specs = build_looped_join(b, pr, args.iterations, out_rows, "cpu")

    os.makedirs(args.output_dir, exist_ok=True)
    sidecar = {
        "device": device,
        "iterations": args.iterations,
        "build_table_nrows": b,
        "probe_table_nrows": pr,
        "selectivity": args.selectivity,
        "out_rows": out_rows,
        "args": [{"name": nm, "shape": list(shape), "dtype": dt}
                 for nm, shape, dt in arg_specs],
        "outputs": [{"name": nm, "dtype": dt} for nm, dt in OUTPUTS],
    }
    with open(os.path.join(args.output_dir, "join_step.json"), "w") as f:
        json.dump(sidecar, f, indent=2)
    libs = "".join(f"lib_{nm}={_kernels._library_path(nm)}\n"
                   for nm in DRIVER_KERNELS)
    with open(os.path.join(args.output_dir, "join_step.meta"), "w") as f:
        f.write(
            f"iterations={args.iterations}\n"
            f"build_table_nrows={b}\n"
            f"probe_table_nrows={pr}\n"
            f"selectivity={args.selectivity}\n"
            f"out_rows={out_rows}\n"
            f"device={device}\n"
            f"{libs}"
        )
    print(f"exported {args.output_dir}/join_step.meta for {device}")
    if args.build_driver:
        print(f"driver {build_driver()}")


if __name__ == "__main__":
    main()
