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
  ``num_keys`` planes. CUDA tensors launch ``csrc/merge_sort.cu``, a
  tile sort plus one merge-path launch per level, then a gather of every
  plane by the sorting permutation; CPU tensors take the plain twin
  :func:`merge_sort_planes_reference`, stable ``torch.sort`` passes from
  the least significant key plane up.
- :func:`merged_sort` (JAX ``pallas_merged_sort`` :659): a drop-in for
  ``lax.sort(operands, num_keys)``.

The contract is the JAX function's: key operands come out sorted; ties
may be permuted. Both routes here are stable (the kernel breaks ties on
the row index), so they agree bit for bit. Unlike the TPU kernel, no key
tuple is reserved for padding.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_join_tpu_torch.ops import _kernels
from distributed_join_tpu_torch.ops.lanes import MASK32, srl

_SIGNATURES = {
    "djt_merge_sort_tile": (ctypes.c_int, [ctypes.c_int]),
    "djt_merge_sort": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]),
    "djt_gather_planes": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p]),
}
# key planes the kernel takes: 4 words of 64 bits (csrc/merge_sort.cu)
MAX_KEY_PLANES = 8
_SIGN32 = 1 << 31
_SIGN64 = -(1 << 63)
_SMALL_INTS = (torch.int8, torch.uint8, torch.int16, torch.uint16)


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


def _check_planes(planes, num_keys: int) -> int:
    if not planes or not 0 < num_keys <= len(planes):
        raise ValueError("need 0 < num_keys <= len(planes)")
    n = planes[0].shape[0]
    if any(p.dtype != torch.int32 or p.ndim != 1 or p.shape[0] != n
           for p in planes):
        raise TypeError("planes must be 1-D int32 tensors of one length")
    return n


def merge_sort_planes(planes, num_keys: int) -> list:
    """Sort u32 planes (int32 bit patterns) by the first ``num_keys``
    planes, unsigned lexicographic, most significant first; returns the
    planes in sorted row order. CPU tensors take the plain twin; CUDA
    tensors launch the kernel (at most ``MAX_KEY_PLANES`` key planes,
    fewer than 2^31 rows), counted once per sort on
    ``merge_sort_planes.launches``."""
    planes = list(planes)
    n = _check_planes(planes, num_keys)
    if planes[0].device.type == "cpu":
        return merge_sort_planes_reference(planes, num_keys)
    _kernels.require_cuda("merge_sort_planes", *planes)
    if num_keys > MAX_KEY_PLANES:
        raise ValueError(f"merge_sort_planes: at most {MAX_KEY_PLANES} key "
                         f"planes, got {num_keys}")
    if n >= 2**31 - 1:
        raise ValueError("merge_sort_planes: at most 2^31 - 2 rows")
    if n == 0:
        return [p.clone() for p in planes]
    dev = planes[0].device
    words = (num_keys + 1) // 2
    k0 = torch.empty((n, words), dtype=torch.int64, device=dev)
    for w in range(words):
        hi = planes[2 * w]
        lo = planes[2 * w + 1] if 2 * w + 1 < num_keys else None
        k0[:, w] = (_wide(hi) << 32) | (0 if lo is None else _wide(lo))
    k1 = torch.empty_like(k0)
    i0 = torch.empty(n, dtype=torch.int32, device=dev)
    i1 = torch.empty_like(i0)
    lib = _kernels.library("merge_sort", _SIGNATURES)
    p = _kernels.ptr
    in_1 = ctypes.c_int(0)
    rc = lib.djt_merge_sort(p(k0), p(k1), p(i0), p(i1), n, words,
                            ctypes.byref(in_1), _kernels.stream(dev))
    _kernels.check(lib, rc, "merge_sort")
    _kernels.count_launch(merge_sort_planes)
    perm = i1 if in_1.value else i0
    outs = [torch.empty_like(pl) for pl in planes]
    step = _kernels.MAX_LANES
    for g in range(0, len(planes), step):
        rc = lib.djt_gather_planes(
            p(perm), _kernels.ptr_array(planes[g:g + step]),
            _kernels.ptr_array(outs[g:g + step]),
            len(planes[g:g + step]), n, _kernels.stream(dev))
        _kernels.check(lib, rc, "merge_sort gather")
    return outs


merge_sort_planes.launches = 0


def tile_rows(num_keys: int) -> int:
    """The kernel's tile length for ``num_keys`` key planes (CUDA only;
    the edge-shape tests straddle it)."""
    lib = _kernels.library("merge_sort", _SIGNATURES)
    return lib.djt_merge_sort_tile((num_keys + 1) // 2)


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
    rest ride. Returns the operands in sorted order, through
    :func:`merge_sort_planes`."""
    return _sort_operands(merge_sort_planes, operands, num_keys)


def merged_sort_reference(operands, num_keys: int) -> tuple:
    """The plain twin of :func:`merged_sort` on any device."""
    return _sort_operands(merge_sort_planes_reference, operands, num_keys)
