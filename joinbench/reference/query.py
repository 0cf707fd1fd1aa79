"""The port's TPC-H Q3 plan in plain PyTorch: each join materialised by
``reference.join.inner_join`` over the valid rows, then the group-by.

``customer ⋈ orders`` on ``custkey``, that ``⋈ lineitem`` on
``orderkey``, grouped by ``orderkey``: ``revenue`` the sum of
``l_extendedprice`` (int64 cents), ``n_lines`` the count, and
``o_orderdate`` carried. The carried column is one value per group (the
key determines it), taken from the group's first row.
"""

from __future__ import annotations

import torch

from joinbench.reference.join import inner_join

GROUP, CARRY = "orderkey", "o_orderdate"


def _valid(table) -> dict:
    cols, valid = table
    return {n: c[valid] for n, c in cols.items()}


def group_by(keys: torch.Tensor, values: torch.Tensor,
             carry: torch.Tensor, float32_sums: bool = False) -> dict:
    """``{"key", "revenue", "n_lines", "carry"}``, one row a distinct
    key, sorted by key. ``float32_sums``: the control, revenue summed in
    float32 and rounded back to int64 cents."""
    order = torch.sort(keys, stable=True).indices
    k = keys[order]
    uniq, gid = torch.unique_consecutive(k, return_inverse=True)
    n = uniq.shape[0]
    v = values[order]
    if float32_sums:
        rev = torch.zeros(n, dtype=torch.float32, device=k.device)
        rev.index_add_(0, gid, v.to(torch.float32))
        rev = torch.round(rev).to(torch.int64)
    else:
        rev = torch.zeros(n, dtype=torch.int64, device=k.device)
        rev.index_add_(0, gid, v.to(torch.int64))
    cnt = torch.zeros(n, dtype=torch.int64, device=k.device)
    cnt.index_add_(0, gid, torch.ones_like(gid, dtype=torch.int64))
    first = torch.cumsum(cnt, 0) - cnt
    return {"key": uniq, "revenue": rev, "n_lines": cnt,
            "carry": carry[order][first]}


def query_reference(tables: dict, query: str,
                    float32_sums: bool = False) -> dict:
    """The groups of ``query`` (``"q3"``) over filtered tables
    ``{"customer", "orders", "lineitem"}`` (each ``(columns, valid)``),
    and the join counts: ``{"groups": {...}, "j1_rows", "j2_rows",
    "j1_builds"}``."""
    if query != "q3":
        raise ValueError(f"the reference has Q3 only, not {query!r}")
    c, o, li = (_valid(tables["customer"]), _valid(tables["orders"]),
                _valid(tables["lineitem"]))
    j1 = inner_join(c["custkey"], {}, o["custkey"],
                    {"orderkey": o["orderkey"],
                     "o_orderdate": o["o_orderdate"]})
    j1_builds = int(torch.unique(j1["key"]).shape[0])
    j2 = inner_join(j1["orderkey"], {"o_orderdate": j1["o_orderdate"]},
                    li["orderkey"], {"l_extendedprice": li["l_extendedprice"]})
    groups = group_by(j2["key"], j2["l_extendedprice"], j2[CARRY],
                      float32_sums=float32_sums)
    return {"groups": groups, "j1_rows": int(j1["key"].shape[0]),
            "j1_builds": j1_builds, "j2_rows": int(j2["key"].shape[0])}
