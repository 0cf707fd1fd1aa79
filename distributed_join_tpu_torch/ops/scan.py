"""Fused join scans over the merged-sorted domain.

Port of ``distributed_join_tpu/ops/scan_pallas.py``: the kernel
(``csrc/join_scans.cu``) replaces the Pallas passes ``_scan_r_kernel``
and ``_scan_f_kernel``; :func:`join_scans_reference` is the plain twin
(the scan chain spelled out), bit-exact with the JAX package's
``join_scans_reference``. Quantities, all int32:

    b_before  = cumsum(is_build) - is_build
    lo_raw    = cummax(first ? b_before : 0)
    cnt       = is_probe ? b_before - lo_raw : 0
    start_out = cumsum(cnt) - cnt
    rec_pos   = cumsum(is_probe & cnt > 0) - 1
    matched   = is_build & (probes in [i, next run start) > 0)
    mb_pos    = cumsum(matched) - 1
    lo_m      = cummax(first ? cumsum(matched) - matched : 0)
"""

from __future__ import annotations

import ctypes

import torch

from distributed_join_tpu_torch.ops import _kernels

_SIGNATURES = {
    "djt_join_scans_scratch_bytes": (ctypes.c_longlong, [ctypes.c_longlong]),
    "djt_join_scans": (ctypes.c_int, [ctypes.c_void_p] * 8
                       + [ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_void_p]),
}
NAMES = ("cnt", "start_out", "lo_m", "rec_pos", "matched", "mb_pos")


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def join_scans_reference(tag: torch.Tensor, first: torch.Tensor) -> dict:
    """The plain twin: the scan chain as torch ops."""
    is_b = tag == 0
    is_p = tag == 1
    zero = torch.zeros((), dtype=torch.int32, device=tag.device)
    b_incl = _cumsum(is_b.to(torch.int32))
    b_before = b_incl - is_b.to(torch.int32)
    lo_raw = _cummax(torch.where(first, b_before, zero))
    cnt = torch.where(is_p, b_before - lo_raw, zero)
    csum = _cumsum(cnt)
    is_rec = is_p & (cnt > 0)
    rec_pos = _cumsum(is_rec.to(torch.int32)) - 1
    P = torch.flip(_cumsum(torch.flip(is_p.to(torch.int32), (0,))), (0,))
    masked = torch.where(first, P, zero)
    nxt = torch.cat([masked[1:], zero.reshape(1)])
    NR = torch.flip(_cummax(torch.flip(nxt, (0,))), (0,))
    matched = (is_b & (P - NR > 0)).to(torch.int32)
    mb_incl = _cumsum(matched)
    lo_m = _cummax(torch.where(first, mb_incl - matched, zero))
    return {
        "cnt": cnt,
        "start_out": csum - cnt,
        "lo_m": lo_m,
        "rec_pos": rec_pos,
        "matched": matched,
        "mb_pos": mb_incl - 1,
    }


def join_scans(tag: torch.Tensor, first: torch.Tensor) -> dict:
    """All merged-domain scans of the sort-merge join.

    tag:   (n,) int8 — 0 build, 1 probe, 2 padding.
    first: (n,) bool — run starts (key changes; ``first[0]`` True).

    Returns a dict of (n,) int32 tensors keyed by ``NAMES``. CPU
    tensors take the plain twin; CUDA tensors launch the kernel: two
    single-pass look-back scans after one memset of their status words,
    which the entry point issues in the stream each call (the scratch
    comes from the caching allocator and may hold an earlier call's).
    ``tag`` and ``first`` may be views at any byte offset: off a 16-byte
    boundary the kernel reads them byte by byte.
    """
    if tag.device.type == "cpu":
        return join_scans_reference(tag, first)
    if tag.dtype != torch.int8 or first.dtype != torch.bool:
        raise TypeError("join_scans takes int8 tag and bool first")
    _kernels.require_cuda("join_scans", tag, first)
    n = tag.shape[0]
    outs = {nm: torch.empty(n, dtype=torch.int32, device=tag.device)
            for nm in NAMES}
    if n == 0:
        return outs
    lib = _kernels.library("join_scans", _SIGNATURES)
    scratch = torch.empty(lib.djt_join_scans_scratch_bytes(n),
                          dtype=torch.uint8, device=tag.device)
    p = _kernels.ptr
    rc = lib.djt_join_scans(
        p(tag), p(first), p(outs["matched"]), p(outs["cnt"]),
        p(outs["start_out"]), p(outs["lo_m"]), p(outs["rec_pos"]),
        p(outs["mb_pos"]), n, p(scratch), _kernels.stream(tag.device))
    _kernels.check(lib, rc, "join_scans")
    _kernels.count_launch(join_scans)
    return outs


join_scans.launches = 0
