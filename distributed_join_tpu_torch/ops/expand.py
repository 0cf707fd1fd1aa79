"""Expand-gather: broadcast each run record down its output slots and,
in build mode, gather each slot's build values at its in-run rank.

Port of ``distributed_join_tpu/ops/expand_pallas.py`` ``expand_gather``
in both modes (record mode: ``_expand_kernel``; build mode:
``_expand_kernel_b8``) and of ``distributed_join_tpu/ops/expand_planes.py``
``expand_pull`` (its ``_expand_kernel``, a drop-in for the same
contract) as one kernel, ``csrc/expand_gather.cu``.
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


def _expand_reference(S, cols, out_capacity: int, lo=None,
                      build_cols=None):
    """``(rec_outs, start_b, build_outs or None)`` by scatter + cummax +
    row gathers."""
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
        return rec_outs, start_b, None
    nb = build_cols[0].shape[0]
    rank = lo[ridx].long() + (j - start_b).long()
    safe = rank.clamp(0, nb - 1)
    return rec_outs, start_b, [b[safe] for b in build_cols]


def expand_gather_reference(S, cols, out_capacity: int, lo=None,
                            build_cols=None):
    """The plain twin; same signature and results as
    :func:`expand_gather`."""
    rec_outs, start_b, build_outs = _expand_reference(
        S, cols, out_capacity, lo, build_cols)
    if build_cols is None:
        return rec_outs, start_b
    return rec_outs, build_outs


def expand_pull_reference(S, cols, out_capacity: int, lo=None,
                          build_cols=None):
    """The plain twin of :func:`expand_pull`."""
    rec_outs, start_b, build_outs = _expand_reference(
        S, cols, out_capacity, lo, build_cols)
    if build_cols is None:
        return rec_outs, start_b
    return rec_outs, start_b, torch.zeros_like(start_b), build_outs


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
    kernel, a tiled load-balanced search (one block a tile of 1024
    slots). There ``S``, ``lo`` and the record lanes must start on a
    16-byte boundary (fresh tensors do); a view off one raises.
    """
    if build_cols is not None and (lo is None or not build_cols):
        raise ValueError("build mode needs lo and at least one build lane")
    if S.device.type == "cpu":
        return expand_gather_reference(S, cols, out_capacity, lo, build_cols)
    rec_outs, start_b, build_outs = _launch(
        "expand_gather", expand_gather, S, cols, out_capacity, lo,
        build_cols, with_start_b=build_cols is None)
    if build_cols is None:
        return rec_outs, start_b
    return rec_outs, build_outs


def expand_pull(S: torch.Tensor, cols, out_capacity: int,
                lo: torch.Tensor | None = None, build_cols=None):
    """The port of ``expand_planes.expand_pull``, a drop-in for
    :func:`expand_gather` with the JAX function's return shapes:
    ``(rec_outs, start_b)`` without a build side, ``(rec_outs, start_b,
    rank, build_outs)`` with one (``rank`` a zero placeholder, as in the
    JAX function). Arguments as :func:`expand_gather`; the TPU-only
    ``block`` and ``interpret`` have no counterpart.

    The JAX kernel's build side is wrong where build ranks repeat
    (duplicate probe keys; ``expand_planes.py:23-32``); this one computes
    the contract there too, equal to ``expand_gather_reference``. CPU
    tensors take the plain twin; CUDA tensors launch
    ``csrc/expand_gather.cu``, counted on ``expand_pull.launches``.
    """
    if build_cols is not None and (lo is None or not build_cols):
        raise ValueError("build mode needs lo and at least one build lane")
    if S.device.type == "cpu":
        return expand_pull_reference(S, cols, out_capacity, lo, build_cols)
    rec_outs, start_b, build_outs = _launch(
        "expand_pull", expand_pull, S, cols, out_capacity, lo, build_cols,
        with_start_b=True)
    if build_cols is None:
        return rec_outs, start_b
    return rec_outs, start_b, torch.zeros_like(start_b), build_outs


def _launch(what, counter, S, cols, out_capacity, lo, build_cols,
            with_start_b):
    """Check, allocate and launch ``csrc/expand_gather.cu`` once per
    group of lanes; returns ``(rec_outs, start_b or None, build_outs)``
    and counts each launch on ``counter``."""
    build = build_cols is not None
    bcols = list(build_cols) if build else []
    if S.dtype != torch.int32 or (build and lo.dtype != torch.int32) or any(
            c.dtype != torch.int64 for c in [*cols, *bcols]):
        raise TypeError(f"{what} takes int32 S/lo and int64 lanes")
    _kernels.require_cuda(what, S, *cols, *bcols, *([lo] if build else []))
    if any(t.data_ptr() % 16 for t in [S, *cols, *([lo] if build else [])]):
        raise ValueError(f"{what}: S, lo and the record lanes must start "
                         "on a 16-byte boundary (the kernel loads them 16 "
                         "bytes at a time)")
    dev = S.device
    rec_outs = [torch.empty(out_capacity, dtype=torch.int64, device=dev)
                for _ in cols]
    build_outs = [torch.empty(out_capacity, dtype=torch.int64, device=dev)
                  for _ in bcols]
    start_b = (torch.empty(out_capacity, dtype=torch.int32, device=dev)
               if with_start_b else None)
    result = (rec_outs, start_b, build_outs)
    if out_capacity == 0:
        return result
    m = S.shape[0]
    if m < 1 or any(c.shape[0] != m for c in cols) or (
            build and lo.shape[0] != m):
        raise ValueError(f"{what}: S, lo and record lanes must share a "
                         "length >= 1")
    nb = bcols[0].shape[0] if build else 0
    if build and (nb < 1 or any(b.shape[0] != nb for b in bcols)):
        raise ValueError(f"{what}: build lanes must share a length >= 1")
    lib = _kernels.library("expand_gather", _SIGNATURES)
    p = _kernels.ptr
    step = _kernels.MAX_LANES
    # one launch per group of lanes on each side; start_b is written in
    # the first
    for g in range(0, max(len(cols), len(bcols), 1), step):
        rs, ro = cols[g:g + step], rec_outs[g:g + step]
        bs, bo = bcols[g:g + step], build_outs[g:g + step]
        rc = lib.djt_expand_gather(
            p(S), m, p(lo), _kernels.ptr_array(rs), _kernels.ptr_array(ro),
            len(rs), _kernels.ptr_array(bs), _kernels.ptr_array(bo),
            len(bs), nb, out_capacity, p(start_b if g == 0 else None),
            _kernels.stream(dev))
        _kernels.check(lib, rc, what)
        _kernels.count_launch(counter)
    return result


expand_gather.launches = 0
expand_pull.launches = 0
