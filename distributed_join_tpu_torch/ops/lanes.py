"""uint64 lanes carried as int64 bit patterns.

The JAX package moves every join column through uint64 "lanes"
(``ops/join.py`` ``_to_u64_lane``/``_from_u64_lane``) so one kernel
signature serves every dtype. torch has no general uint64 arithmetic
(the CPU build cannot even shift one), so the port keeps the same 64
bits in int64 tensors. Wrapping add, multiply and xor give the same bits
as their uint64 counterparts; a logical right shift is an arithmetic
shift followed by a mask (:func:`srl`).
"""

from __future__ import annotations

from typing import Optional

import torch

MASK32 = 0xFFFFFFFF


def u64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


_NARROW_INTS = (torch.int8, torch.uint8, torch.int16, torch.int32)


def u64_lane_ok(dtype: torch.dtype) -> bool:
    """Can a column of ``dtype`` ride a lane bit-exactly? The JAX
    package's static ``_u64_lane_ok`` (64-bit and narrower integers,
    float32) plus float64: the TPU cannot bitcast a float64, the GPU
    views its 64 bits as they are."""
    return (dtype in (torch.int64, torch.float32, torch.float64)
            or dtype in _NARROW_INTS)


def to_u64_lane(c: torch.Tensor) -> Optional[torch.Tensor]:
    """Bit-exact lane encoding, or None for a dtype that has none.
    Narrow integers zero-extend their BIT PATTERN (a plain widening
    cast would sign-extend and change the upper bits)."""
    dt = c.dtype
    if dt == torch.int64:
        return c
    if dt in _NARROW_INTS:
        bits = torch.iinfo(dt).bits
        return c.to(torch.int64) & ((1 << bits) - 1)
    if dt == torch.float32:
        return c.view(torch.int32).to(torch.int64) & MASK32
    if dt == torch.float64:
        return c.view(torch.int64)
    return None


def from_u64_lane(c64: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int64:
        return c64
    if dtype in _NARROW_INTS:
        # int64 -> narrower casts keep the low bits (two's complement)
        return c64.to(dtype)
    if dtype == torch.float32:
        return c64.to(torch.int32).view(torch.float32)
    if dtype == torch.float64:
        return c64.view(torch.float64)
    raise TypeError(f"no lane decoding for {dtype}")


def split_u64(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit planes of a lane, as int32 bit patterns (the JAX
    package's ``sort_pallas.split_u64`` returns uint32 planes)."""
    return srl(c, 32).to(torch.int32), c.to(torch.int32)


def merge_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & MASK32)
