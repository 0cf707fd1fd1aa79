"""Order-preserving stream compaction of uint64 lanes.

Port of the contract shared by ``distributed_join_tpu/ops/compact_planes.py``
(``plane_stream_compact``, the TPU default) and
``distributed_join_tpu/ops/compact_pallas.py`` (``stream_compact``): the
kernel is ``csrc/stream_compact.cu``; :func:`stream_compact_reference`
is the plain twin (one scatter per lane, as the JAX reference).
"""

from __future__ import annotations

import ctypes

import torch

from distributed_join_tpu_torch.ops import _kernels

_SIGNATURES = {
    "djt_stream_compact": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
}


def stream_compact_reference(mask, pos, cols, capacity: int):
    """The plain twin: zeros, then each survivor scattered to its slot
    (the JAX reference's output, zeros past the survivors included)."""
    keep = mask & (pos >= 0) & (pos < capacity)
    # dropped elements scatter into one extra slot that is cut off
    idx = torch.where(keep, pos, torch.full_like(pos, capacity)).long()
    outs = []
    for c in cols:
        out = c.new_zeros(capacity + 1)
        out.scatter_(0, idx, c)
        outs.append(out[:capacity])
    return outs


def stream_compact(mask: torch.Tensor, pos: torch.Tensor, cols,
                   capacity: int, launch_counter=None):
    """Compact k uint64 lanes (int64 bit patterns).

    mask: (n,) bool survivors; pos: (n,) int32 == cumsum(mask) - 1;
    cols: k (n,) int64 lanes. Returns k (capacity,) int64 lanes;
    survivors with pos >= capacity are dropped, and slots at or past the
    survivor count are undefined.

    The kernel relies on ``pos == cumsum(mask) - 1`` exactly: it reads
    ``pos`` once per tile of 8192 positions, at the tile's first
    survivor, and places the tile's survivors one slot apart from there.
    Every caller passes such a ``pos``: the join's ``rec_pos`` and
    ``mb_pos`` (``ops/scan.py``) and ``extract_prefix``'s cumsum
    (``parallel/skew.py``). The plain twin scatters by ``pos`` itself.

    Launches are counted on ``launch_counter`` (an object with a
    ``launches`` integer; default this wrapper): each call site of the
    join and ``extract_prefix`` counts its launches on itself.
    """
    if mask.device.type == "cpu":
        return stream_compact_reference(mask, pos, cols, capacity)
    if mask.dtype != torch.bool or pos.dtype != torch.int32 or any(
            c.dtype != torch.int64 for c in cols):
        raise TypeError("stream_compact takes bool mask, int32 pos and "
                        "int64 lanes")
    _kernels.require_cuda("stream_compact", mask, pos, *cols)
    n = mask.shape[0]
    if pos.shape[0] != n or any(c.shape[0] != n for c in cols):
        raise ValueError("stream_compact: mask, pos and lanes differ in length")
    outs = [torch.empty(capacity, dtype=torch.int64, device=mask.device)
            for _ in cols]
    if not cols or n == 0 or capacity == 0:
        return outs
    lib = _kernels.library("stream_compact", _SIGNATURES)
    step = _kernels.MAX_LANES
    for lo in range(0, len(cols), step):
        src, dst = cols[lo:lo + step], outs[lo:lo + step]
        rc = lib.djt_stream_compact(
            _kernels.ptr(mask), _kernels.ptr(pos), _kernels.ptr_array(src),
            _kernels.ptr_array(dst), len(src), n, capacity,
            _kernels.stream(mask.device))
        _kernels.check(lib, rc, "stream_compact")
        _kernels.count_launch(launch_counter or stream_compact)
    return outs


stream_compact.launches = 0
