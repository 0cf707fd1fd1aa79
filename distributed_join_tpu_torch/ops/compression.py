"""Frame-of-reference + bit-pack codec for shuffle buckets (plain torch).

Port of ``distributed_join_tpu/ops/compression.py``: each block of
``block`` values is stored as its minimum (an int64 frame) and the
residuals against it in ``bits`` bits, ``32 / bits`` residuals a 32-bit
word. The width is fixed by the caller; a block whose residual span
needs more bits raises ``overflow`` (and ``required_bits`` says how many
the widest block needed), so the caller retries wider. bits in {2, 4, 8,
16, 32}.

Torch has few operations on unsigned types, so the codec works in int64:
a residual is the int64 difference, wrapping exactly as the JAX
package's uint64 residual's bits do, and a block whose span reaches
2^63 (keys over the whole int64 range) reads negative and needs 64
bits. The words are int32 tensors carrying the uint32 bits; compare
them with the JAX package's through ``.view(uint32)`` on the numpy side.

The encoder takes one row (n,) or a batch of rows (R, n): each row is
padded to a multiple of ``block`` with its own last value and packed on
its own, so a batch equals the rows encoded one by one (the JAX
package's ``vmap``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ALLOWED_BITS = (2, 4, 8, 16, 32)
_U32 = 0xFFFFFFFF


class Packed(NamedTuple):
    words: torch.Tensor         # (n_pad * bits / 32,) int32 (uint32 bits)
    frames: torch.Tensor        # (n_pad / block,) int64 block minima
    overflow: torch.Tensor      # bool: some block's residual needs > bits
    required_bits: torch.Tensor  # int32: most bits any block needed
    n: int                      # logical length
    bits: int
    block: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def to_int64(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``astype(int64)``: sign-extend signed types,
    zero-extend uint32, keep a uint64's bits."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & _U32
    return x.to(torch.int64)


def from_int64(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse cast: the low bits of each int64, as ``dtype``."""
    if dtype == torch.uint64:
        return x.view(torch.uint64)
    if dtype == torch.uint32:
        return x.to(torch.int32).view(torch.uint32)
    return x.to(dtype)


def _bit_length(span: torch.Tensor) -> torch.Tensor:
    """Bits a residual span needs, as the JAX package counts them (the
    b < 64 with span >= 2^b, unsigned): 64 for a span that reads
    negative, else the bit length, by six halving steps."""
    v = span.clamp(min=0)
    r = torch.zeros(span.shape, dtype=torch.int32, device=span.device)
    for s in (32, 16, 8, 4, 2, 1):
        hi = v >= (1 << s)
        r = r + hi.to(torch.int32) * s
        v = torch.where(hi, v >> s, v)
    r = r + (v >= 1).to(torch.int32)
    return torch.where(span < 0, torch.full_like(r, 64), r)


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(0, 32, bits, dtype=torch.int64, device=device)


def encode_rows(x: torch.Tensor, bits: int, block: int = 1024,
                required_bits: bool = True):
    """Encode each row of ``x`` (R, n): returns ``(words (R, n_pad *
    bits / 32) int32, frames (R, n_pad / block) int64, overflow (R,)
    bool, required_bits (R,) int32)``; the last is None with
    ``required_bits=False`` (the shuffle needs only the flag)."""
    if bits not in ALLOWED_BITS:
        raise ValueError(f"bits={bits}: expected one of {ALLOWED_BITS}")
    if block % 32:
        raise ValueError(f"block={block} must be a multiple of 32")
    rows, n = x.shape
    n_pad = _round_up(max(n, 1), block)
    xi = to_int64(x)
    if n_pad > n:
        # pad with each row's last value (residual 0 against a real frame)
        fill = (xi[:, -1:] if n else
                torch.zeros((rows, 1), dtype=torch.int64, device=x.device))
        xi = torch.cat([xi, fill.expand(rows, n_pad - n)], dim=1)
    blocks = xi.reshape(rows, -1, block)
    frames = blocks.amin(dim=2)
    # wraps as the JAX package's uint64 residual does
    resid = blocks - frames[..., None]
    span = blocks.amax(dim=2) - frames
    overflow = ((span < 0) | (span >= (1 << bits))).any(dim=1)
    lanes = 32 // bits
    r = (resid & ((1 << bits) - 1)).reshape(rows, -1, lanes)
    words = (r << _shifts(bits, x.device)).sum(dim=2).to(torch.int32)
    required = _bit_length(span).amax(dim=1) if required_bits else None
    return words, frames, overflow, required


def decode_rows(words: torch.Tensor, frames: torch.Tensor, n: int,
                bits: int, block: int, dtype=torch.int64) -> torch.Tensor:
    """The rows :func:`encode_rows` packed, (R, n) of ``dtype``."""
    rows = words.shape[0]
    w = words.to(torch.int64) & _U32
    parts = (w[..., None] >> _shifts(bits, words.device)) & ((1 << bits) - 1)
    resid = parts.reshape(rows, -1, block)
    out = (resid + frames[..., None]).reshape(rows, -1)[:, :n]
    return from_int64(out, dtype)


def for_bitpack_encode(x: torch.Tensor, bits: int,
                       block: int = 1024) -> Packed:
    """Pack the 1-D integer tensor ``x``."""
    words, frames, overflow, required = encode_rows(x[None], bits, block)
    return Packed(words=words[0], frames=frames[0], overflow=overflow[0],
                  required_bits=required[0], n=x.shape[0], bits=bits,
                  block=block)


def for_bitpack_decode(p: Packed, dtype=torch.int64) -> torch.Tensor:
    return decode_rows(p.words[None], p.frames[None], p.n, p.bits,
                       p.block, dtype)[0]


def wire_bytes(p: Packed) -> int:
    """Bytes of the packed form: the words and the frames."""
    return int(p.words.shape[0] * 4 + p.frames.shape[0] * 8)
