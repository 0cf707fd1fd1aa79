"""The TPC-H tables of the query layer and the queries' filters, frozen
from the port's ``utils/tpch.py`` (``sparse_order_keys``,
``generate_orders``, ``generate_lineitem``, ``generate_customer``,
``generate_tpch_query_tables``, ``query_filters``' Q3 branch) at commit
5f4d2a6.

dbgen's join structure: ``customer`` holds SF * 150 k rows with dense
keys 1..n, a market segment of 5 and an account balance in cents;
``orders`` SF * 1.5 M rows with dbgen's sparse order keys (8 used in
every block of 32), ``o_orderdate`` uniform over the 2406 days of
1992-01-01..1998-08-02, ``o_totalprice`` in cents and the
``o_custkey`` foreign key uniform over the customers; ``lineitem`` 1..7
lines an order, uniform (about SF * 6 M rows), ``l_shipdate`` 1..121
days after its order's date, ``l_quantity`` 1..50,
``l_extendedprice`` in cents and ``l_discount`` 0..10 percent. One
``torch.Generator`` on the device, drawn in the frozen order.

A table here is ``(columns, valid)``: a dict of equal-length tensors
and a bool mask; the filters narrow the mask and keep the shapes.
"""

from __future__ import annotations

import torch

ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000
N_MKT_SEGMENTS = 5
DATE_RANGE_DAYS = 2406       # 1992-01-01 .. 1998-08-02
MAX_SHIP_LAG_DAYS = 121
MAX_LINES_PER_ORDER = 7


def _randint(g: torch.Generator, low: int, high: int, n: int, dtype):
    return torch.randint(low, high, (n,), generator=g, dtype=dtype,
                         device=g.device)


def _all_valid(cols: dict) -> tuple:
    first = next(iter(cols.values()))
    return cols, torch.ones(first.shape[0], dtype=torch.bool,
                            device=first.device)


def _rename(cols: dict, mapping: dict) -> dict:
    """The columns renamed, in their order."""
    return {mapping.get(k, k): v for k, v in cols.items()}


def sparse_order_keys(n_orders: int, device) -> torch.Tensor:
    """Order i (0-based) gets ``(i // 8) * 32 + (i % 8) + 1``."""
    i = torch.arange(n_orders, dtype=torch.int64, device=device)
    return (i // 8) * 32 + (i % 8) + 1


def generate_customer(g: torch.Generator, scale_factor: float) -> dict:
    n = int(CUSTOMERS_PER_SF * scale_factor)
    return {
        "c_custkey": torch.arange(1, n + 1, dtype=torch.int64,
                                  device=g.device),
        "c_mktsegment": _randint(g, 0, N_MKT_SEGMENTS, n, torch.int32),
        "c_acctbal": _randint(g, -99_999, 1_000_000, n, torch.int64),
        "c_nationkey": _randint(g, 0, 25, n, torch.int32),
    }


def generate_orders(g: torch.Generator, scale_factor: float) -> dict:
    n = int(ORDERS_PER_SF * scale_factor)
    return {
        "o_orderkey": sparse_order_keys(n, g.device),
        "o_orderdate": _randint(g, 0, DATE_RANGE_DAYS, n, torch.int32),
        "o_totalprice": _randint(g, 90_000, 55_550_000, n, torch.int64),
    }


def generate_lineitem(g: torch.Generator, orders: dict) -> dict:
    """1..7 lines an order; the line count is read to the host once."""
    n = orders["o_orderkey"].shape[0]
    counts = _randint(g, 1, MAX_LINES_PER_ORDER + 1, n, torch.int64)
    total = int(counts.sum())

    def rep(col):
        return torch.repeat_interleave(col, counts, output_size=total)

    orderdate = rep(orders["o_orderdate"])
    return {
        "l_orderkey": rep(orders["o_orderkey"]),
        "l_shipdate": orderdate + _randint(g, 1, MAX_SHIP_LAG_DAYS + 1,
                                           total, torch.int32),
        "l_quantity": _randint(g, 1, 51, total, torch.int32),
        "l_extendedprice": _randint(g, 90_000, 10_500_000, total,
                                    torch.int64),
        "l_discount": _randint(g, 0, 11, total, torch.int32),
    }


def generate_query_tables(seed: int, scale_factor: float, device) -> dict:
    """``{"customer", "orders", "lineitem"}`` as ``(columns, valid)``,
    the join keys under the plans' names (``custkey``, ``orderkey``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    customer = generate_customer(g, scale_factor)
    orders = generate_orders(g, scale_factor)
    lineitem = generate_lineitem(g, orders)
    orders["o_custkey"] = _randint(
        g, 1, customer["c_custkey"].shape[0] + 1,
        orders["o_orderkey"].shape[0], torch.int64)
    customer = _rename(customer, {"c_custkey": "custkey"})
    orders = _rename(orders, {"o_custkey": "custkey",
                              "o_orderkey": "orderkey"})
    lineitem = _rename(lineitem, {"l_orderkey": "orderkey"})
    return {"customer": _all_valid(customer), "orders": _all_valid(orders),
            "lineitem": _all_valid(lineitem)}


def query_filters(tables: dict, query: str,
                  cutoff_day: int = DATE_RANGE_DAYS // 2,
                  segment: int = 1) -> dict:
    """Q3: ``c_mktsegment == segment``, ``o_orderdate < cutoff``,
    ``l_shipdate > cutoff``. Masks only; the shapes stay."""
    (c, cv), (o, ov), (li, lv) = (tables["customer"], tables["orders"],
                                  tables["lineitem"])
    if query != "q3":
        raise ValueError(f"the frozen filters have Q3 only, not {query!r}")
    cv = cv & (c["c_mktsegment"] == segment)
    ov = ov & (o["o_orderdate"] < cutoff_day)
    lv = lv & (li["l_shipdate"] > cutoff_day)
    return {"customer": (c, cv), "orders": (o, ov), "lineitem": (li, lv)}
