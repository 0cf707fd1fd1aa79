"""Fixed-width string columns.

Port of ``distributed_join_tpu/utils/strings.py``, byte for byte. A
string column is a 2-D table column plus a companion length column:

    bytes:   uint8[capacity, max_len]   (zero-padded row bytes)
    lengths: int32[capacity]            (companion column "<name>#len")

so every stage that moves rows (the partition gather, the padded
all-to-all, the join's output gather) moves it by row indexing with no
string-specific code.

String JOIN KEYS pack into ceil(max_len/8) 64-bit word columns,
big-endian within each word, which every stage then handles as an
ordinary composite scalar key; the byte column is rebuilt exactly from
the output words. The words are uint64 bit patterns held in int64, as
in ``ops/lanes.py``: hashing gives the JAX package's bits, and the
merged sort orders them signed, which changes the order of rows inside
the result but not which rows match (keys compare by their zero-padded
bytes, as in the JAX package).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.table import Table

LEN_SUFFIX = "#len"
_I64_MAX = 2**63 - 1


def encode_strings(values: Sequence[str], max_len: int, device=None):
    """Encode to (bytes uint8[n, max_len], lengths int32[n]) on
    ``device`` (default: the GPU). Raises if any UTF-8 encoding exceeds
    ``max_len`` (silent truncation would corrupt payloads)."""
    n = len(values)
    out = np.zeros((n, max_len), dtype=np.uint8)
    lens = np.zeros((n,), dtype=np.int32)
    for i, s in enumerate(values):
        raw = s.encode("utf-8")
        if len(raw) > max_len:
            raise ValueError(
                f"string row {i} is {len(raw)} bytes > max_len={max_len}")
        out[i, :len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        lens[i] = len(raw)
    dev = resolve_device(device)
    return torch.from_numpy(out).to(dev), torch.from_numpy(lens).to(dev)


def decode_strings(bytes_2d, lengths=None) -> List[str]:
    """Decode uint8[n, max_len] (a tensor or an array) back to Python
    strings. Without ``lengths``, trailing zero bytes are stripped."""
    a = _host(bytes_2d)
    lens = None if lengths is None else _host(lengths)
    out = []
    for i in range(a.shape[0]):
        row = a[i]
        k = int(lens[i]) if lens is not None else (
            int(np.max(np.nonzero(row)[0])) + 1 if row.any() else 0)
        out.append(bytes(row[:k]).decode("utf-8"))
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _digit(ids: torch.Tensor, k) -> torch.Tensor:
    """Decimal digit ``k`` (a power index, int or tensor) of
    non-negative ``ids``; zero where 10^k exceeds int64."""
    if isinstance(k, int):
        if 10**k > _I64_MAX:
            return torch.zeros_like(ids)
        return (ids // 10**k) % 10
    top = min(18, int(k.max()) if k.numel() else 0)
    pow10 = torch.tensor([10**e for e in range(top + 1)], dtype=torch.int64,
                         device=ids.device)
    return torch.where(k <= 18, (ids // pow10[k.clamp(max=top)]) % 10, 0)


def encode_int_strings(ids: torch.Tensor, prefix: str = "itm-",
                       digits: int = 12, pad_digits: bool = True):
    """``'<prefix><id>'`` for every id, rendered with tensor ops on the
    ids' device: generator-scale string payloads without a loop over the
    rows. ``pad_digits`` zero-pads every id to ``digits`` (fixed row
    length); with False, ids render without leading zeros, left-aligned
    after the prefix, zero bytes beyond the length. The byte buffer is
    ``len(prefix) + digits`` wide either way. Returns (uint8[n, width],
    int32[n] lengths)."""
    ids = ids.to(torch.int64)
    if ids.numel():
        hi, lo = int(ids.max()), int(ids.min())
        if hi >= 10**digits:
            raise ValueError(f"id {hi} needs more than digits={digits} digits")
        if lo < 0:
            raise ValueError(f"negative id {lo} is not encodable")
    praw = prefix.encode("utf-8")
    n, w0 = ids.shape[0], len(praw)
    out = torch.empty((n, w0 + digits), dtype=torch.uint8, device=ids.device)
    out[:, :w0] = torch.tensor(list(praw), dtype=torch.uint8,
                               device=ids.device)
    if pad_digits:
        for d in range(digits):
            out[:, w0 + d] = _digit(ids, digits - 1 - d) + ord("0")
        lens = torch.full((n,), w0 + digits, dtype=torch.int32,
                          device=ids.device)
        return out, lens
    # digit count by exact integer comparison against powers of 10
    nd = torch.ones_like(ids)
    for d in range(1, digits):
        if 10**d <= _I64_MAX:
            nd += ids >= 10**d
    for p in range(digits):
        e = nd - 1 - p
        digit = _digit(ids, e.clamp(min=0)) + ord("0")
        out[:, w0 + p] = torch.where(e >= 0, digit, 0)
    return out, (w0 + nd).to(torch.int32)


def add_string_column(columns: dict, name: str, values: Sequence[str],
                      max_len: int, device=None) -> dict:
    """Insert a string column plus its companion length column."""
    b, ln = encode_strings(values, max_len, device=device)
    columns = dict(columns)
    columns[name] = b
    columns[name + LEN_SUFFIX] = ln
    return columns


# -- string JOIN KEYS: packed-word representation ----------------------

_WORD_PREFIX = "__sk"


def string_key_word_names(name_idx: int, n_words: int):
    return [f"{_WORD_PREFIX}{name_idx}w{w}" for w in range(n_words)]


def pack_string_key(bytes_2d: torch.Tensor):
    """uint8[n, L] -> list of (n,) int64 big-endian word columns (uint64
    bit patterns): the row's bytes, zero-padded to whole words, each
    word's first byte its most significant."""
    n, L = bytes_2d.shape
    nw = (L + 7) // 8
    padded = torch.zeros((n, 8 * nw), dtype=torch.uint8,
                         device=bytes_2d.device)
    padded[:, :L] = bytes_2d
    # little-endian int64: the lowest address holds the least significant
    # byte, so each word's bytes are reversed before the view
    words = padded.view(n, nw, 8).flip(2).contiguous().view(torch.int64)
    return list(words.view(n, nw).unbind(1))


def unpack_string_key(words, max_len: int) -> torch.Tensor:
    """Inverse of :func:`pack_string_key` -> uint8[n, max_len]."""
    w = torch.stack(list(words), 1).contiguous()
    n, nw = w.shape
    b = w.view(torch.uint8).view(n, nw, 8).flip(2)
    return b.reshape(n, 8 * nw)[:, :max_len].contiguous()


def check_key_ndim(build, probe, keys):
    """Raise TypeError if any key column's dimensionality differs
    between sides."""
    for k in keys:
        if build.columns[k].ndim != probe.columns[k].ndim:
            raise TypeError(
                f"key {k!r} dimensionality mismatch: build ndim "
                f"{build.columns[k].ndim} vs probe ndim "
                f"{probe.columns[k].ndim} (string keys must be 2-D "
                "uint8 byte columns on BOTH sides)")


def split_string_keys(build, probe, keys):
    """Replace 2-D uint8 key columns with packed word columns in both
    tables. Returns ``(build2, probe2, keys2, spec)`` where ``spec`` is
    ``[(orig_name, word_names, max_len), ...]`` for
    :func:`rebuild_string_keys`; empty spec = nothing to do."""
    spec = []
    keys2 = []
    bcols = dict(build.columns)
    pcols = dict(probe.columns)
    for i, k in enumerate(keys):
        c = bcols[k]
        if c.ndim != 2:
            keys2.append(k)
            continue
        taken = set(bcols) | set(pcols)
        wn = string_key_word_names(i, (c.shape[1] + 7) // 8)
        for nm in wn:
            if nm in taken:
                raise ValueError(
                    f"column {nm!r} collides with the packed string-key "
                    "word columns")
        if c.dtype != torch.uint8 or pcols[k].dtype != torch.uint8:
            raise TypeError(f"2-D key {k!r} must be uint8 bytes, got "
                            f"{c.dtype}")
        if c.shape[1] != pcols[k].shape[1]:
            raise TypeError(f"2-D key {k!r} width mismatch: {c.shape[1]} "
                            f"vs {pcols[k].shape[1]}")
        max_len = c.shape[1]
        for nm, w in zip(wn, pack_string_key(bcols.pop(k))):
            bcols[nm] = w
        for nm, w in zip(wn, pack_string_key(pcols.pop(k))):
            pcols[nm] = w
        keys2.extend(wn)
        spec.append((k, wn, max_len))
    if not spec:
        return build, probe, keys, []
    return (Table(bcols, build.valid), Table(pcols, probe.valid), keys2,
            spec)


def rebuild_string_keys(table, spec, key_order):
    """Inverse of :func:`split_string_keys` on a join output table: word
    columns collapse back to the byte column, output columns reordered
    keys first in ``key_order``."""
    cols = dict(table.columns)
    rebuilt = {}
    for name, word_names, max_len in spec:
        rebuilt[name] = unpack_string_key(
            [cols.pop(nm) for nm in word_names], max_len)
    out = {}
    for k in key_order:
        out[k] = rebuilt[k] if k in rebuilt else cols.pop(k)
    out.update(cols)
    return Table(out, table.valid)


def prepare_string_key_join(build, probe, keys, build_payload,
                            probe_payload):
    """The front half of a string-key join: payload defaulting (the
    probe's '<key>#len' companion wins; the build side's is dropped so it
    never rides the shuffle) and the packed-word split. Returns
    ``(build2, probe2, keys2, build_payload, probe_payload, spec)``;
    empty spec = no string keys."""
    check_key_ndim(build, probe, keys)
    str_keys = [k for k in keys if build.columns[k].ndim == 2]
    if not str_keys:
        return build, probe, keys, build_payload, probe_payload, []
    drop = {k + LEN_SUFFIX for k in str_keys}
    if build_payload is None:
        build_payload = [n for n in build.column_names
                         if n not in keys and n not in drop]
    if probe_payload is None:
        probe_payload = [n for n in probe.column_names if n not in keys]
    build2, probe2, keys2, spec = split_string_keys(build, probe, keys)
    keep_b = set(keys2) | set(build_payload)
    build2 = Table({n: c for n, c in build2.columns.items() if n in keep_b},
                   build2.valid)
    return build2, probe2, keys2, build_payload, probe_payload, spec
