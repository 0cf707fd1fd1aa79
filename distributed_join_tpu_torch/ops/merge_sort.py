"""Merge sort on 32-bit planes: the port of
``distributed_join_tpu/ops/sort_pallas.py`` (EXPERIMENTAL there, and
here: the join's merged sort stays on ``torch.sort``, as the JAX join
stays on ``lax.sort``).

- The codecs ``key_to_planes``, ``planes_to_key``, ``val_to_planes`` and
  ``planes_to_val`` (JAX :91-168), bit for bit. A plane is a u32 held as
  an int32 bit pattern; unsigned lexicographic order of a key's planes
  is the dtype's order. uint64/uint32/uint16 columns come as torch's
  unsigned dtypes (int64 bit patterns ``.view(torch.uint64)``).
- :func:`merge_sort_planes` (JAX :489): planes in the order of the first
  ``num_keys`` planes. CUDA tensors launch ``csrc/radix_sort.cu``, a
  least-significant-digit radix sort that skips, on the device, the
  digit positions where every row has the same digit; every plane then
  comes out in sorted order (a key plane from the key words the last
  pass left sorted, where it kept them; any other gathered by the
  sorting permutation). CPU tensors take the plain twin
  :func:`merge_sort_planes_reference`, stable ``torch.sort`` passes from
  the least significant key plane up.
- :func:`merged_sort` (JAX ``pallas_merged_sort`` :659): a drop-in for
  ``lax.sort(operands, num_keys)``. On CPU tensors it runs the codecs
  around the plain twin; on CUDA tensors the same kernel reads the
  operands in their own dtypes (it applies the key codecs' order map as
  it packs, and gathers each operand whole), so no plane is made.

The contract is the JAX function's: key operands come out sorted; ties
may be permuted. Both routes here are stable (every radix pass is), so
they agree bit for bit. Unlike the TPU kernel, no key tuple is reserved
for padding.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_join_tpu_torch.ops import _kernels
from distributed_join_tpu_torch.ops.lanes import MASK32, srl

_SIGNATURES = {
    "djt_radix_sort_tile": (ctypes.c_int, [ctypes.c_int]),
    "djt_radix_sort_scratch_bytes": (ctypes.c_longlong, [
        ctypes.c_longlong, ctypes.c_int]),
    "djt_radix_sort": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]),
    "djt_gather_sorted": (ctypes.c_int, [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]),
}
# how the kernel maps a key operand's bits to unsigned order (KIND_* in
# csrc/radix_sort.cu): as they are, sign bit flipped, IEEE-754 monotone
_RAW, _SIGNED, _FLOAT = 0, 1, 2
# key planes the kernel takes: 4 words of 64 bits (csrc/radix_sort.cu)
MAX_KEY_PLANES = 8
_SIGN32 = 1 << 31
_SIGN64 = -(1 << 63)
_SMALL_INTS = (torch.int8, torch.uint8, torch.int16, torch.uint16)
_ORDER_KINDS = {torch.int8: _SIGNED, torch.int16: _SIGNED,
                torch.int32: _SIGNED, torch.int64: _SIGNED,
                torch.uint8: _RAW, torch.uint16: _RAW, torch.uint32: _RAW,
                torch.uint64: _RAW, torch.float32: _FLOAT}


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as an int32 plane."""
    return x.to(torch.int32)


def _wide(p: torch.Tensor) -> torch.Tensor:
    """A plane as its unsigned value in an int64 tensor."""
    return p.to(torch.int64) & MASK32


def _split64(bits: torch.Tensor) -> list:
    return [_u32(srl(bits, 32)), _u32(bits)]


def _join64(planes) -> torch.Tensor:
    return (_wide(planes[0]) << 32) | _wide(planes[1])


def key_to_planes(c: torch.Tensor) -> list:
    """Order-preserving planes, most significant first."""
    dt = c.dtype
    if dt == torch.uint32:
        return [c.view(torch.int32)]
    if dt == torch.int32:
        return [_u32(c.to(torch.int64) ^ _SIGN32)]
    if dt in _SMALL_INTS:
        lo = torch.iinfo(dt).min
        return [c.to(torch.int32) - lo]
    if dt == torch.uint64:
        return _split64(c.view(torch.int64))
    if dt == torch.int64:
        return _split64(c ^ _SIGN64)
    if dt == torch.float32:
        b = _wide(c.view(torch.int32))
        # monotone IEEE-754 transform: negatives reversed, sign flipped
        return [_u32(torch.where(b >> 31 != 0, ~b & MASK32, b | _SIGN32))]
    raise TypeError(f"unsupported key dtype {dt}")


def planes_to_key(planes, dt: torch.dtype) -> torch.Tensor:
    if dt == torch.uint32:
        return planes[0].view(torch.uint32)
    if dt == torch.int32:
        return _u32(_wide(planes[0]) ^ _SIGN32)
    if dt in _SMALL_INTS:
        return (planes[0] + torch.iinfo(dt).min).to(dt)
    if dt == torch.uint64:
        return _join64(planes).view(torch.uint64)
    if dt == torch.int64:
        return _join64(planes) ^ _SIGN64
    if dt == torch.float32:
        b = _wide(planes[0])
        b = torch.where(b >> 31 != 0, b & 0x7FFFFFFF, ~b & MASK32)
        return _u32(b).view(torch.float32)
    raise TypeError(dt)


def val_to_planes(c: torch.Tensor) -> list:
    """Bit-preserving planes (values ride, never compared)."""
    dt = c.dtype
    if dt in (torch.int64, torch.uint64):
        return _split64(c.view(torch.int64))
    if dt in (torch.float32, torch.uint32):
        return [c.view(torch.int32)]
    if dt == torch.int32 or dt in _SMALL_INTS:
        bits = torch.iinfo(dt).bits
        return [_u32(c.to(torch.int64) & ((1 << bits) - 1))]
    raise TypeError(f"unsupported value dtype {dt}")


def planes_to_val(planes, dt: torch.dtype) -> torch.Tensor:
    if dt in (torch.int64, torch.uint64):
        return _join64(planes).view(dt)
    if dt in (torch.float32, torch.uint32):
        return planes[0].view(dt)
    if dt == torch.int32 or dt in _SMALL_INTS:
        # int32 -> narrower casts keep the low bits
        return planes[0].to(dt)
    raise TypeError(dt)


def merge_sort_planes_reference(planes, num_keys: int) -> list:
    """The plain twin: stable sorts from the least significant key plane
    up, every plane gathered by the permutation."""
    planes = list(planes)
    perm = None
    for p in reversed(planes[:num_keys]):
        v = _wide(p) if perm is None else _wide(p)[perm]
        idx = torch.sort(v, stable=True).indices
        perm = idx if perm is None else perm[idx]
    if perm is None:
        return [p.clone() for p in planes]
    return [p[perm] for p in planes]


def _check_planes(planes, num_keys: int) -> None:
    if not planes or not 0 < num_keys <= len(planes):
        raise ValueError("need 0 < num_keys <= len(planes)")
    n = planes[0].shape[0]
    if any(p.dtype != torch.int32 or p.ndim != 1 or p.shape[0] != n
           for p in planes):
        raise TypeError("planes must be 1-D int32 tensors of one length")


def merge_sort_planes(planes, num_keys: int) -> list:
    """Sort u32 planes (int32 bit patterns) by the first ``num_keys``
    planes, unsigned lexicographic, most significant first; returns the
    planes in sorted row order. CPU tensors take the plain twin; CUDA
    tensors launch the kernel (at most ``MAX_KEY_PLANES`` key planes,
    fewer than 2^31 rows), counted once per sort on
    ``merge_sort_planes.launches``."""
    planes = list(planes)
    _check_planes(planes, num_keys)
    if planes[0].device.type == "cpu":
        return merge_sort_planes_reference(planes, num_keys)
    return _radix_sort(planes[:num_keys], [_RAW] * num_keys, planes)


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _radix_sort(keys, kinds, operands) -> list:
    """Launch the kernel: the rows sorted by ``keys`` (each mapped to
    unsigned order by its kind), every operand gathered in that order.
    No host synchronisation."""
    n = operands[0].shape[0]
    _kernels.require_cuda("merge_sort_planes", *operands)
    if any(op.ndim != 1 or op.shape[0] != n for op in operands):
        raise ValueError("merge_sort_planes: operands must be 1-D, of one "
                         "length")
    n_planes = sum(2 if k.element_size() == 8 else 1 for k in keys)
    if n_planes > MAX_KEY_PLANES:
        raise ValueError(f"merge_sort_planes: at most {MAX_KEY_PLANES} key "
                         f"planes, got {n_planes}")
    if n >= 2**31 - 1:
        raise ValueError("merge_sort_planes: at most 2^31 - 2 rows")
    if n == 0:
        return [op.clone() for op in operands]
    dev = operands[0].device
    words = (n_planes + 1) // 2
    lib = _kernels.library("radix_sort", _SIGNATURES)
    # key words (packed by the kernel), ping-pong with the row index
    k0 = torch.empty((words, n), dtype=torch.int64, device=dev)
    k1 = torch.empty_like(k0)
    i0 = torch.empty(n, dtype=torch.int32, device=dev)
    i1 = torch.empty_like(i0)
    scratch = torch.empty(lib.djt_radix_sort_scratch_bytes(n, words),
                          dtype=torch.uint8, device=dev)
    p, stream = _kernels.ptr, _kernels.stream(dev)
    rc = lib.djt_radix_sort(
        _kernels.ptr_array(keys), _ints([k.element_size() for k in keys]),
        _ints(kinds), len(keys), p(k0), p(k1), p(i0), p(i1), p(scratch), n,
        stream)
    _kernels.check(lib, rc, "radix_sort")
    _kernels.count_launch(merge_sort_planes)
    # each key operand's first plane (values: -1), for the gather to read
    # the keys the sort left sorted
    first = [sum(2 if k.element_size() == 8 else 1 for k in keys[:i])
             for i in range(len(keys))]
    planes = first + [-1] * (len(operands) - len(keys))
    kinds = list(kinds) + [_RAW] * (len(operands) - len(keys))
    outs = [torch.empty_like(op) for op in operands]
    step = _kernels.MAX_LANES
    for g in range(0, len(operands), step):
        src, dst = operands[g:g + step], outs[g:g + step]
        rc = lib.djt_gather_sorted(
            p(scratch), p(k0), p(k1), p(i0), p(i1), _kernels.ptr_array(src),
            _kernels.ptr_array(dst), _ints([c.element_size() for c in src]),
            _ints(planes[g:g + step]), _ints(kinds[g:g + step]), len(src),
            n, stream)
        _kernels.check(lib, rc, "radix_sort gather")
    return outs


merge_sort_planes.launches = 0


def tile_rows(num_keys: int) -> int:
    """Rows per block of the kernel's scatter passes for ``num_keys`` key
    planes (CUDA only; the edge-shape tests straddle it)."""
    lib = _kernels.library("radix_sort", _SIGNATURES)
    return lib.djt_radix_sort_tile((num_keys + 1) // 2)


def _sort_operands(sort_planes, operands, num_keys: int) -> tuple:
    operands = list(operands)
    planes, spec = [], []
    for i, c in enumerate(operands):
        is_key = i < num_keys
        ps = key_to_planes(c) if is_key else val_to_planes(c)
        spec.append((is_key, c.dtype, len(ps)))
        planes.extend(ps)
    nk = sum(cnt for is_key, _, cnt in spec if is_key)
    srt = sort_planes(planes, nk)
    out, pos = [], 0
    for is_key, dt, cnt in spec:
        sub = srt[pos:pos + cnt]
        pos += cnt
        out.append(planes_to_key(sub, dt) if is_key
                   else planes_to_val(sub, dt))
    return tuple(out)


def merged_sort(operands, num_keys: int) -> tuple:
    """Drop-in for ``lax.sort(operands, num_keys=num_keys)``: the first
    ``num_keys`` operands are compare keys (most significant first), the
    rest ride. Returns the operands in sorted order: on CPU tensors
    through the plane codecs and the plain twin, on CUDA tensors through
    the kernel of :func:`merge_sort_planes` on the operands as they are
    (the same order; dtypes the codecs refuse raise TypeError)."""
    operands = list(operands)
    if not 0 < num_keys <= len(operands):
        raise ValueError("need 0 < num_keys <= len(operands)")
    if operands[0].device.type == "cpu":
        return _sort_operands(merge_sort_planes_reference, operands,
                              num_keys)
    for c in operands:
        if c.dtype not in _ORDER_KINDS:
            raise TypeError(f"unsupported dtype {c.dtype}")
    keys = operands[:num_keys]
    return tuple(_radix_sort(keys, [_ORDER_KINDS[k.dtype] for k in keys],
                             operands))


def merged_sort_reference(operands, num_keys: int) -> tuple:
    """The plain twin of :func:`merged_sort` on any device."""
    return _sort_operands(merge_sort_planes_reference, operands, num_keys)
