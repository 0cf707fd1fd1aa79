"""The synthetic build/probe generator, frozen from the port's
``utils/generators.py`` (``generate_build_table``,
``generate_probe_table``, ``generate_build_probe_tables``) at commit
5f4d2a6, with the rule for one rank's shard of the global tables.

The global tables are the generator's: build keys uniform in
[0, rand_max), or unique (global build row g has key g); build payload
the global row id; a probe row is a hit with probability
``selectivity``, its key a uniformly drawn build key, else a miss drawn
from the disjoint range [rand_max, 2 * rand_max); probe payload the
global row id.

A shard: rank r of n holds global build rows [r * B, (r + 1) * B) and
global probe rows [r * P, (r + 1) * P), and draws its own random values
on its own device from ``(seed, rank)``, in the generator's order (the
probe's pick, miss and hit draws). With unique build keys the key of
global build row g is g, so a hit draws its key uniformly from every
rank's build keys without reading them. Duplicate build keys would need
the other ranks' keys for a hit, so a shard refuses them.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def shard_seed(seed: int, rank: int, stream: int = 0) -> int:
    """A 63-bit generator seed from ``(seed, rank, stream)`` (splitmix64
    finaliser over a golden-ratio mix); ``seed`` may exceed 32 bits."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(rank) + 1) * 0xBF58476D1CE4E5B9
         + (int(stream) + 1) * 0x94D049BB133111EB) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def build_shard(rank: int, n_ranks: int, rows: int, rand_max: int,
                generator: torch.Generator, unique_keys: bool) -> dict:
    """Rank ``rank``'s build rows: ``{"key", "build_payload"}`` (int64)."""
    dev = generator.device
    ids = torch.arange(rank * rows, (rank + 1) * rows, dtype=torch.int64,
                       device=dev)
    if unique_keys:
        if rows * n_ranks > rand_max:
            raise ValueError("unique keys need the global build rows "
                             "<= rand_max")
        keys = ids.clone()
    else:
        keys = torch.randint(0, rand_max, (rows,), generator=generator,
                             dtype=torch.int64, device=dev)
    return {"key": keys, "build_payload": ids}


def probe_shard(rank: int, n_ranks: int, rows: int, build_rows: int,
                rand_max: int, selectivity: float,
                generator: torch.Generator, unique_keys: bool) -> dict:
    """Rank ``rank``'s probe rows: ``{"key", "probe_payload"}`` (int64)."""
    if not unique_keys:
        raise ValueError("a shard draws its hits without the other ranks' "
                         "build keys, which needs unique build keys")
    dev = generator.device
    pick = torch.randint(0, build_rows * n_ranks, (rows,),
                         generator=generator, dtype=torch.int64, device=dev)
    miss = torch.randint(rand_max, 2 * rand_max, (rows,),
                         generator=generator, dtype=torch.int64, device=dev)
    is_hit = torch.rand(rows, generator=generator, device=dev) < selectivity
    return {"key": torch.where(is_hit, pick, miss),
            "probe_payload": torch.arange(rank * rows, (rank + 1) * rows,
                                          dtype=torch.int64, device=dev)}

