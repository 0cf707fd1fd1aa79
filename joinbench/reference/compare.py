"""The comparison that decides ``correct``: two multisets of rows, each a
dict of equal-length integer columns, compared exactly.

``row_diff`` sorts both sides' rows together and counts, for every
distinct row, how often each side holds it: ``missing`` rows the
reference holds more often than the program, ``extra`` rows the program
holds more often. Both are 0 exactly when the multisets are equal.
"""

from __future__ import annotations

import torch


def _lexsort(cols: list) -> torch.Tensor:
    """The permutation sorting rows by ``cols[0]``, then ``cols[1]``..."""
    idx = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        idx = idx[torch.sort(c[idx], stable=True).indices]
    return idx


def row_diff(got: dict, want: dict, names) -> dict:
    """``{"missing", "extra"}`` between the program's rows ``got`` and
    the reference's ``want`` over the columns ``names``."""
    cols = [torch.cat([got[n].to(torch.int64), want[n].to(torch.int64)])
            for n in names]
    n_got = got[names[0]].shape[0]
    side = torch.zeros(cols[0].shape[0], dtype=torch.int64,
                       device=cols[0].device)
    side[n_got:] = 1
    if cols[0].shape[0] == 0:
        return {"missing": 0, "extra": 0}
    order = _lexsort(cols)
    sc = [c[order] for c in cols]
    s = side[order]
    differs = torch.zeros_like(s, dtype=torch.bool)
    differs[0] = True
    for c in sc:
        differs[1:] |= c[1:] != c[:-1]
    gid = torch.cumsum(differs.to(torch.int64), 0) - 1
    n = int(gid[-1]) + 1
    from_got = torch.zeros(n, dtype=torch.int64, device=s.device)
    from_want = torch.zeros(n, dtype=torch.int64, device=s.device)
    from_got.index_add_(0, gid, (s == 0).to(torch.int64))
    from_want.index_add_(0, gid, (s == 1).to(torch.int64))
    gap = from_got - from_want
    return {"missing": int((-gap).clamp(min=0).sum()),
            "extra": int(gap.clamp(min=0).sum())}
