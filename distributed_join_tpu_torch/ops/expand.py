"""Expand-gather: broadcast each run record down its output slots and,
in build mode, gather each slot's build values at its in-run rank.

Port of ``distributed_join_tpu/ops/expand_pallas.py`` ``expand_gather``
in both modes (record mode: ``_expand_kernel``; build mode:
``_expand_kernel_b8``) as one kernel, ``csrc/expand_gather.cu``.
:func:`expand_gather_reference` is the plain twin: the JAX reference's
scatter + cummax + row gather, plus the rank gather of the join's
fallback branch. A GPU gather has no window bound, so the port has no
``build_windows_ok`` gate: build mode is exact on matched-rank and gap
data alike.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_join_tpu_torch.ops import _kernels

_SIGNATURES = {
    "djt_expand_gather": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
}


def expand_gather_reference(S, cols, out_capacity: int, lo=None,
                            build_cols=None):
    """The plain twin; same signature and results as
    :func:`expand_gather`."""
    m = S.shape[0]
    dev = S.device
    r = torch.arange(m, dtype=torch.int32, device=dev)
    keep = (S >= 0) & (S < out_capacity)
    idx = torch.where(keep, S, torch.full_like(S, out_capacity)).long()
    raw = torch.zeros(out_capacity + 1, dtype=torch.int32, device=dev)
    raw.scatter_(0, idx, r + 1)
    raw = raw[:out_capacity]
    ridx = (torch.cummax(raw, 0).values - 1).clamp(0, m - 1).long()
    rec_outs = [c[ridx] for c in cols]
    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    start_b = torch.cummax(torch.where(raw > 0, j, torch.zeros_like(j)),
                           0).values
    if build_cols is None:
        return rec_outs, start_b
    nb = build_cols[0].shape[0]
    rank = lo[ridx].long() + (j - start_b).long()
    safe = rank.clamp(0, nb - 1)
    return rec_outs, [b[safe] for b in build_cols]


def expand_gather(S: torch.Tensor, cols, out_capacity: int,
                  lo: torch.Tensor | None = None, build_cols=None):
    """For each output slot j in [0, out_capacity): the covering record
    r = max{r : S[r] <= j}.

    S: (m,) int32, ascending, unique among real records, INT32_MAX
    sentinels after them. cols: k (m,) int64 lanes.

    Record mode (``build_cols`` None): returns ``(rec_outs, start_b)``
    — each lane at r, and ``start_b[j] = S[r]`` (int32).
    Build mode (``lo``: (m,) int32 build rank of each record's run
    start; ``build_cols``: kb (nb,) int64 lanes): returns
    ``(rec_outs, build_outs)``, ``build_outs`` gathered at
    ``clip(lo[r] + (j - S[r]), 0, nb - 1)``.

    Values at slots >= the join's total are undefined (masked by the
    caller). CPU tensors take the plain twin; CUDA tensors launch the
    kernel.
    """
    build = build_cols is not None
    if build and (lo is None or not build_cols):
        raise ValueError("build mode needs lo and at least one build lane")
    if S.device.type == "cpu":
        return expand_gather_reference(S, cols, out_capacity, lo, build_cols)
    bcols = list(build_cols) if build else []
    if S.dtype != torch.int32 or (build and lo.dtype != torch.int32) or any(
            c.dtype != torch.int64 for c in [*cols, *bcols]):
        raise TypeError("expand_gather takes int32 S/lo and int64 lanes")
    _kernels.require_cuda("expand_gather", S, *cols, *bcols,
                          *([lo] if build else []))
    dev = S.device
    rec_outs = [torch.empty(out_capacity, dtype=torch.int64, device=dev)
                for _ in cols]
    build_outs = [torch.empty(out_capacity, dtype=torch.int64, device=dev)
                  for _ in bcols]
    start_b = None if build else torch.empty(out_capacity, dtype=torch.int32,
                                             device=dev)
    result = (rec_outs, build_outs) if build else (rec_outs, start_b)
    if out_capacity == 0:
        return result
    m = S.shape[0]
    if m < 1 or any(c.shape[0] != m for c in cols) or (
            build and lo.shape[0] != m):
        raise ValueError("expand_gather: S, lo and record lanes must share "
                         "a length >= 1")
    nb = bcols[0].shape[0] if build else 0
    if build and (nb < 1 or any(b.shape[0] != nb for b in bcols)):
        raise ValueError("expand_gather: build lanes must share a length >= 1")
    lib = _kernels.library("expand_gather", _SIGNATURES)
    p = _kernels.ptr
    step = _kernels.MAX_LANES
    # one launch per group of lanes on each side; record mode writes
    # start_b in the first
    for g in range(0, max(len(cols), len(bcols), 1), step):
        rs, ro = cols[g:g + step], rec_outs[g:g + step]
        bs, bo = bcols[g:g + step], build_outs[g:g + step]
        rc = lib.djt_expand_gather(
            p(S), m, p(lo), _kernels.ptr_array(rs), _kernels.ptr_array(ro),
            len(rs), _kernels.ptr_array(bs), _kernels.ptr_array(bo),
            len(bs), nb, out_capacity, p(start_b if g == 0 else None),
            _kernels.stream(dev))
        _kernels.check(lib, rc, "expand_gather")
        _kernels.count_launch(expand_gather)
    return result


expand_gather.launches = 0
