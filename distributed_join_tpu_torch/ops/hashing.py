"""Key hashing for radix partitioning: Murmur3 finalizers plus a
boost-style combine, bit-exact with ``distributed_join_tpu/ops/hashing.py``.

All arithmetic runs on int64 bit patterns (ops/lanes.py): wrapping
multiplies and masked logical shifts give the uint64 results.
"""

from __future__ import annotations

from typing import Sequence

import torch

from distributed_join_tpu_torch.ops.lanes import MASK32, srl, u64

_C1 = u64(0xFF51AFD7ED558CCD)
_C2 = u64(0xC4CEB9FE1A85EC53)
_MAGIC = u64(0x9E3779B97F4A7C15)


def fmix64(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 64-bit finalizer. Any integer input (widened with sign
    extension, as ``astype(uint64)`` does); output uint64 bits in int64."""
    k = x.to(torch.int64)
    k = k ^ srl(k, 33)
    k = k * _C1
    k = k ^ srl(k, 33)
    k = k * _C2
    return k ^ srl(k, 33)


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer on the low 32 bits of ``x``; the uint32
    result comes back zero-extended in an int64 tensor."""
    h = x.to(torch.int64) & MASK32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def _hash_one(col: torch.Tensor) -> torch.Tensor:
    dt = col.dtype
    if dt == torch.int64:
        return fmix64(col)
    if dt in (torch.int32, torch.int16, torch.int8, torch.uint8):
        return fmix32(col)
    if dt == torch.float64:
        # The JAX package's decomposition |x| = m * 2^e, m in [1, 2)
        # (its arithmetic stands in for the f64 bitcast the TPU lacks):
        # equal values hash equal; -0.0 folds onto 0.0. JAX writes it
        # with floor(log2) and exp2, which are inexact on some devices
        # (XLA:CPU; the H100 gives other bits than the CPU); frexp is
        # exact everywhere. Infinities and NaNs take e = 1024 and their
        # payload bits, the same on every device.
        a = col.abs()
        frac, ex = torch.frexp(a)           # a = frac * 2^ex, frac in [.5, 1)
        pos = a > 0
        finite = torch.isfinite(a)
        mi = torch.where(pos & finite, (frac * 2.0 ** 53).to(torch.int64),
                         torch.where(finite, 0, a.view(torch.int64)))
        e = torch.where(pos & finite, ex - 1,
                        torch.where(finite, 0, 1024)).to(torch.int32)
        ebits = e ^ ((col < 0).to(torch.int32) << 30)
        return hash_combine(fmix64(mi), fmix32(ebits))
    if dt == torch.float32:
        # -0.0 folds onto 0.0 before the bit view, as the float64 hash
        # folds it: the join's merge takes them as one key, so they must
        # meet on one rank. (The JAX package hashes the raw bits, so its
        # -0.0 lands apart; every other float32 id is its id.)
        return fmix32(torch.where(col == 0, torch.zeros_like(col),
                                  col).view(torch.int32))
    raise TypeError(f"unhashable column dtype {dt}")


def hash_combine(seed: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """boost::hash_combine on uint64 bit patterns."""
    return seed ^ (h + _MAGIC + (seed << 6) + srl(seed, 2))


def hash_columns(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise uint64 hash (int64 bits) over one or more key columns."""
    if not cols:
        raise ValueError("need at least one key column")
    acc = _hash_one(cols[0])
    for c in cols[1:]:
        acc = hash_combine(acc, _hash_one(c))
    return acc


def _udivmod(h: torch.Tensor, n: int):
    """Unsigned (h // n, h % n) of uint64 bits held in int64, n < 2^62.
    Halving first keeps every intermediate non-negative: with
    u = 2*(u>>1) + (u&1), q0 = (u>>1) // n gives u - 2*q0*n < 2n."""
    q = (srl(h, 1) // n) * 2
    r = h - q * n          # true value in [0, 2n): exact despite wrapping
    over = r >= n
    return q + over.to(torch.int64), r - over.to(torch.int64) * n


def bucket_ids(cols: Sequence[torch.Tensor], n_buckets: int,
               sub_buckets: int = 1) -> torch.Tensor:
    """Row-wise bucket id in [0, n_buckets) as int32: the UNSIGNED hash
    modulo n_buckets. ``sub_buckets`` > 1 returns the fine id
    ``(h % n) * sub_buckets + (h // n) % sub_buckets``."""
    q, coarse = _udivmod(hash_columns(cols), n_buckets)
    coarse = coarse.to(torch.int32)
    if sub_buckets <= 1:
        return coarse
    # q is uint64 bits too (n_buckets == 1 leaves it >= 2^63)
    seg = _udivmod(q, sub_buckets)[1].to(torch.int32)
    return coarse * sub_buckets + seg
