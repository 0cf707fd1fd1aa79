"""Synthetic build/probe tables, generated on the device from a seed.

Port of ``distributed_join_tpu/utils/generators.py``
``generate_build_table`` (:41), ``generate_build_probe_tables`` (:95),
``expand_composite_key`` (:119), ``generate_composite_build_probe_tables``
(:134), ``zipf_keys`` (:210) and ``generate_zipf_probe_table`` (:224).

``generate_build_probe_tables``: build keys uniform in
[0, rand_max), payload = row id; probe keys drawn from the build keys
with probability ``selectivity`` (a guaranteed match) and otherwise from
the disjoint range [rand_max, 2*rand_max) (a guaranteed miss). The
distributions are the JAX package's; the bits are not (torch.Generator
is not jax.random). At rand_max = rows and selectivity 0.3, a probe hit
is a size-biased draw of a build key, so matches come to ~0.6 per probe
row, the relation the headline's output sizing rests on.

``zipf_keys``: bounded Zipf keys for BASELINE config 3, by the JAX
package's inverse CDF of the Pareto tail, ``k = floor(u^(-1/(alpha-1))) -
1`` clipped to [0, rand_max), u uniform in [1e-12, 1). At alpha = 1.5,
key 0 takes P(u > 1/sqrt 2) = 29.3 % of the rows.
"""

from __future__ import annotations

import math

import torch

from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.ops.hashing import _udivmod, fmix64
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils.strings import (
    LEN_SUFFIX,
    encode_int_strings,
)


def check_float_key_range(key_dtype: torch.dtype, max_needed: int) -> None:
    """Float keys must hold every integer in [0, max_needed) exactly, or
    the guaranteed hit and miss keys (and unique keys) collide. A float
    with ``m`` mantissa bits holds every integer up to 2^(m+1); the first
    collision is 2^(m+1) + 1, which rounds onto 2^(m+1). (The JAX
    package's ``_check_float_key_range`` refuses from 2^m on, half the
    range: it also refuses ranges in which no two keys collide.)"""
    if key_dtype.is_floating_point:
        exact = 2 << round(-math.log2(torch.finfo(key_dtype).eps))
        if max_needed - 1 > exact:
            raise ValueError(
                f"key range needs integers up to {max_needed - 1}, beyond "
                f"{key_dtype}'s exact-integer range ({exact}); generated "
                "keys would collide and break the hit/miss guarantees")


def generate_build_table(generator: torch.Generator, nrows: int,
                         rand_max: int, key_dtype: torch.dtype = torch.int64,
                         payload_dtype: torch.dtype = torch.int64,
                         unique_keys: bool = False) -> Table:
    """Build side on ``generator``'s device: keys uniform in [0, rand_max)
    (``unique_keys``: key i is i, which needs nrows <= rand_max), payload
    = row id."""
    dev = generator.device
    check_float_key_range(key_dtype, rand_max)
    if unique_keys:
        if nrows > rand_max:
            raise ValueError("unique keys need nrows <= rand_max")
        keys = torch.arange(nrows, dtype=torch.int64, device=dev)
    else:
        keys = torch.randint(0, rand_max, (nrows,), generator=generator,
                             dtype=torch.int64, device=dev)
    return Table.from_dense({
        "key": keys.to(key_dtype),
        "build_payload": torch.arange(nrows, dtype=payload_dtype,
                                      device=dev),
    })


def generate_build_probe_tables(
    seed: int,
    build_nrows: int,
    probe_nrows: int,
    rand_max: int | None = None,
    selectivity: float = 0.3,
    key_dtype: torch.dtype = torch.int64,
    payload_dtype: torch.dtype = torch.int64,
    unique_build_keys: bool = False,
    device=None,
) -> tuple[Table, Table]:
    """(build, probe) on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    if rand_max is None:
        rand_max = build_nrows
    check_float_key_range(key_dtype, 2 * rand_max)  # the miss keys
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    build = generate_build_table(g, build_nrows, rand_max, key_dtype,
                                 payload_dtype, unique_build_keys)
    bkeys = build.columns["key"]
    pick = torch.randint(0, build_nrows, (probe_nrows,), generator=g,
                         dtype=torch.int64, device=dev)
    miss = torch.randint(rand_max, 2 * rand_max, (probe_nrows,),
                         generator=g, dtype=torch.int64, device=dev)
    is_hit = torch.rand(probe_nrows, generator=g, device=dev) < selectivity
    probe = Table.from_dense({
        "key": torch.where(is_hit, bkeys[pick],
                           miss.to(key_dtype)).to(key_dtype),
        "probe_payload": torch.arange(probe_nrows, dtype=payload_dtype,
                                      device=dev),
    })
    return build, probe


def zipf_keys(generator: torch.Generator, nrows: int, alpha: float,
              rand_max: int, dtype: torch.dtype = torch.int64
              ) -> torch.Tensor:
    """Bounded Zipf(alpha) keys in [0, rand_max) on ``generator``'s
    device; heavy hitters land on small key values.

    ``u^(-1/(alpha-1))`` reaches 1e24 at alpha = 1.5, and a float ->
    int64 cast out of range is undefined (x86 and CUDA give INT64_MIN,
    which would clip to key 0), so the value is clamped in float64
    before the cast: the clip to rand_max - 1 is the same."""
    if alpha <= 1.0:
        raise ValueError("alpha must be > 1")
    u = torch.rand(nrows, dtype=torch.float64, generator=generator,
                   device=generator.device)
    u = u * (1.0 - 1e-12) + 1e-12
    x = torch.pow(u, -1.0 / (alpha - 1.0)).clamp_(max=float(rand_max))
    k = x.to(torch.int64) - 1
    return k.clamp_(0, rand_max - 1).to(dtype)


def generate_zipf_probe_table(generator: torch.Generator, nrows: int,
                              alpha: float, rand_max: int,
                              key_dtype: torch.dtype = torch.int64,
                              payload_dtype: torch.dtype = torch.int64
                              ) -> Table:
    """Probe side with Zipf(alpha) keys, payload = row id."""
    keys = zipf_keys(generator, nrows, alpha, rand_max, key_dtype)
    return Table.from_dense({
        "key": keys,
        "probe_payload": torch.arange(nrows, dtype=payload_dtype,
                                      device=generator.device),
    })


def expand_composite_key(base: torch.Tensor, n_cols: int, rand_max: int
                         ) -> dict:
    """``n_cols`` key columns derived from a scalar base key, so that two
    rows' composite tuples are equal iff their bases are equal: the hit
    and miss guarantees of the scalar generator carry over (BASELINE
    config 5). Column i > 0 is ``fmix64(base + i) % rand_max``, unsigned,
    as in the JAX package."""
    cols = {"key0": base}
    for i in range(1, n_cols):
        h = fmix64(base.to(torch.int64) + i)
        cols[f"key{i}"] = _udivmod(h, rand_max)[1].to(base.dtype)
    return cols


def generate_composite_build_probe_tables(
    seed: int,
    build_nrows: int,
    probe_nrows: int,
    key_columns: int = 2,
    rand_max: int | None = None,
    selectivity: float = 0.3,
    string_payload_len: int = 0,
    unique_build_keys: bool = False,
    string_payload_columns: int = 1,
    variable_length_strings: bool = False,
    device=None,
):
    """The config-5 generator: multi-column keys, plus
    ``string_payload_columns`` fixed-width string payload columns of
    ``string_payload_len`` bytes on the build side (``build_tag``,
    ``build_tag1``, ... with their '#len' companions), rendered on the
    device from the build row id (column c > 0 from a scrambled id and
    its own prefix). ``variable_length_strings`` renders the ids without
    leading zeros, so row lengths vary. Returns (build, probe,
    key_names) on ``device`` (default: the GPU)."""
    if rand_max is None:
        rand_max = build_nrows
    build, probe = generate_build_probe_tables(
        seed, build_nrows, probe_nrows, rand_max=rand_max,
        selectivity=selectivity, unique_build_keys=unique_build_keys,
        device=device)
    key_names = [f"key{i}" for i in range(key_columns)]

    def expand(t: Table, payload_names) -> Table:
        cols = expand_composite_key(t.columns["key"], key_columns, rand_max)
        for p in payload_names:
            cols[p] = t.columns[p]
        return Table(cols, t.valid)

    build = expand(build, ["build_payload"])
    probe = expand(probe, ["probe_payload"])
    if string_payload_len > 0:
        cols = dict(build.columns)
        ids = build.columns["build_payload"].to(torch.int64)
        for c in range(string_payload_columns):
            prefix = "itm-" if c == 0 else f"tg{c % 10}-"
            if string_payload_len <= len(prefix):
                raise ValueError(
                    f"string_payload_len must exceed {len(prefix)} (the "
                    f"{prefix!r} prefix) so the payload has id digits")
            col_ids = ids if c == 0 else (
                (ids * (2 * c + 1) + c)
                % (10 ** min(9, string_payload_len - len(prefix))))
            sbytes, slens = encode_int_strings(
                col_ids, prefix=prefix,
                digits=string_payload_len - len(prefix),
                pad_digits=not variable_length_strings)
            name = "build_tag" if c == 0 else f"build_tag{c}"
            cols[name] = sbytes
            cols[name + LEN_SUFFIX] = slens
        build = Table(cols, build.valid)
    return build, probe, key_names
