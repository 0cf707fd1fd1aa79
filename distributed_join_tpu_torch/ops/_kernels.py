"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles at first use, with ``nvcc`` for
``sm_90a``, into its own shared library with a plain C interface, which
ctypes loads. The libraries land in ``build/torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by a digest of
their sources and flags, so an edited source rebuilds and an unchanged
one loads as it is. Nothing here runs at import time: the CPU tests
import every module of the port on machines without ``nvcc``.

Every entry point returns the ``cudaError_t`` of its launches; a
non-zero code raises here, right after the launch (a refused launch
never runs, and a later synchronize would not report it).

Launch counts: each kernel wrapper carries a plain integer ``launches``
that it raises by one where it launches its kernel (``count_launch``),
and nowhere else; ``reset_launch_counts`` sets them to zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("join_scans", "stream_compact", "expand_gather", "radix_sort")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Lanes one launch carries per side (DJT_MAX_LANES in csrc/common.cuh);
# the multi-lane wrappers launch once per group of this many lanes.
MAX_LANES = 8

_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build on a machine "
            "with the CUDA toolkit")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict:
    """Compile the missing libraries of ``names``, one ``nvcc`` per
    source, all started together. Returns ``{name: ptxas report}`` for
    what was compiled here (the report is empty unless ``verbose``,
    which adds ``-Xptxas -v``). Raises with the compiler's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
        reports[name] = text
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use),
    with ``signatures`` ({function: (restype, [argtypes])}) declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.djt_error_string.restype = ctypes.c_char_p
            lib.djt_error_string.argtypes = [ctypes.c_int]
            for fn, (res, args) in signatures.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.djt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def ptr_array(ts) -> ctypes.Array:
    """A host array of device pointers (for the multi-lane kernels)."""
    return (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """A wrapper's argument check before launching: CUDA, contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: mixed devices ({t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def count_launch(wrapper) -> None:
    with _LOCK:
        wrapper.launches += 1


def reset_launch_counts(*wrappers) -> None:
    with _LOCK:
        for w in wrappers:
            w.launches = 0

