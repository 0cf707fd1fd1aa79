"""A plain equi-join: every (build row, probe row) pair with equal keys,
by a sort of the build keys and two binary searches a probe row.

``match_key`` maps a key column to what is compared (the identity for
the join; a 32-bit fingerprint for the control, the tempting shortcut
of a hash join on short hashes). The output key is the probe row's.
"""

from __future__ import annotations

import torch

PROBE_BLOCK_ROWS = 1 << 25


def fingerprint32(key: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of the splitmix64 finaliser of ``key`` (int64)."""
    z = key.to(torch.int64)
    z = (z ^ ((z >> 30) & 0x3FFFFFFFF)) * -4658895280553007687
    z = (z ^ ((z >> 27) & 0x1FFFFFFFFF)) * -7723592293110705685
    z = z ^ ((z >> 31) & 0x1FFFFFFFF)
    return z & 0xFFFFFFFF


def inner_join(build_key: torch.Tensor, build_cols: dict,
               probe_key: torch.Tensor, probe_cols: dict,
               match_key=None, block_rows: int = PROBE_BLOCK_ROWS) -> dict:
    """Columns ``{"key", *build_cols, *probe_cols}`` of the inner join,
    probe rows in their order, each probe row's matches in build order.
    Only valid rows are passed in; payload names must differ."""
    bm = build_key if match_key is None else match_key(build_key)
    order = torch.sort(bm, stable=True).indices
    bsorted = bm[order]
    outs = []
    for lo in range(0, probe_key.shape[0], block_rows):
        pk = probe_key[lo:lo + block_rows]
        pm = pk if match_key is None else match_key(pk)
        first = torch.searchsorted(bsorted, pm, side="left")
        cnt = torch.searchsorted(bsorted, pm, side="right") - first
        total = int(cnt.sum())
        pidx = torch.repeat_interleave(
            torch.arange(pk.shape[0], device=pk.device), cnt,
            output_size=total)
        starts = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(total, device=pk.device) - starts[pidx]
        bidx = order[first[pidx] + within]
        part = {"key": pk[pidx]}
        part.update({n: c[bidx] for n, c in build_cols.items()})
        part.update({n: c[lo:lo + block_rows][pidx]
                     for n, c in probe_cols.items()})
        outs.append(part)
    if not outs:
        empty = build_key.new_empty(0)
        return {"key": empty, **{n: c[:0] for n, c in build_cols.items()},
                **{n: c[:0] for n, c in probe_cols.items()}}
    return {n: torch.cat([o[n] for o in outs]) for n in outs[0]}
