"""Synthetic build/probe tables, generated on the device from a seed.

Port of ``distributed_join_tpu/utils/generators.py``
``generate_build_probe_tables`` (:95): build keys uniform in
[0, rand_max), payload = row id; probe keys drawn from the build keys
with probability ``selectivity`` (a guaranteed match) and otherwise from
the disjoint range [rand_max, 2*rand_max) (a guaranteed miss). The
distributions are the JAX package's; the bits are not (torch.Generator
is not jax.random). At rand_max = rows and selectivity 0.3, a probe hit
is a size-biased draw of a build key, so matches come to ~0.6 per probe
row, the relation the headline's output sizing rests on.
"""

from __future__ import annotations

import torch

from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.table import Table


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
    if key_dtype.is_floating_point:
        exact = 1 << (torch.finfo(key_dtype).bits
                      - 1 - (8 if key_dtype == torch.float32 else 11))
        if 2 * rand_max > exact:
            raise ValueError(
                f"key range needs integers up to {2 * rand_max}, beyond "
                f"{key_dtype}'s exact-integer range")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if unique_build_keys:
        if build_nrows > rand_max:
            raise ValueError("unique keys need nrows <= rand_max")
        bkeys = torch.arange(build_nrows, dtype=torch.int64, device=dev)
    else:
        bkeys = torch.randint(0, rand_max, (build_nrows,), generator=g,
                              dtype=torch.int64, device=dev)
    build = Table.from_dense({
        "key": bkeys.to(key_dtype),
        "build_payload": torch.arange(build_nrows, dtype=payload_dtype,
                                      device=dev),
    })
    pick = torch.randint(0, build_nrows, (probe_nrows,), generator=g,
                         dtype=torch.int64, device=dev)
    miss = torch.randint(rand_max, 2 * rand_max, (probe_nrows,),
                         generator=g, dtype=torch.int64, device=dev)
    is_hit = torch.rand(probe_nrows, generator=g, device=dev) < selectivity
    probe = Table.from_dense({
        "key": torch.where(is_hit, bkeys[pick], miss).to(key_dtype),
        "probe_payload": torch.arange(probe_nrows, dtype=payload_dtype,
                                      device=dev),
    })
    return build, probe
