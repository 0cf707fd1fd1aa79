"""Synthetic build/probe tables, generated on the device from a seed.

Port of ``distributed_join_tpu/utils/generators.py``
``generate_build_table`` (:41), ``generate_build_probe_tables`` (:95),
``zipf_keys`` (:210) and ``generate_zipf_probe_table`` (:224).

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

import torch

from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.table import Table


def generate_build_table(generator: torch.Generator, nrows: int,
                         rand_max: int, key_dtype: torch.dtype = torch.int64,
                         payload_dtype: torch.dtype = torch.int64,
                         unique_keys: bool = False) -> Table:
    """Build side on ``generator``'s device: keys uniform in [0, rand_max)
    (``unique_keys``: key i is i, which needs nrows <= rand_max), payload
    = row id."""
    dev = generator.device
    if key_dtype.is_floating_point:
        exact = 1 << (torch.finfo(key_dtype).bits
                      - 1 - (8 if key_dtype == torch.float32 else 11))
        if 2 * rand_max > exact:
            raise ValueError(
                f"key range needs integers up to {2 * rand_max}, beyond "
                f"{key_dtype}'s exact-integer range")
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
