"""TPC-H ``orders`` and ``lineitem`` for the config-4 join (the Q3 join
pattern), generated on the device from a seed.

Port of ``distributed_join_tpu/utils/tpch.py``: the join's constants
(:48-53, less the customer table's),
``sparse_order_keys`` (:56), ``generate_orders`` (:64),
``generate_lineitem`` (:81), ``generate_tpch_join_tables`` (:117) and
``q3_filter`` (:207), and the query layer's three tables:
``generate_customer`` (:129), ``generate_tpch_query_tables`` (:148) and
``query_filters`` (:181). dbgen's join structure: ``orders`` holds SF * 1.5 M
rows with dbgen's sparse order keys (8 used in every block of 32),
``o_orderdate`` uniform over the 2406 days of 1992-01-01..1998-08-02 and
``o_totalprice`` in cents; ``lineitem`` holds 1..7 lines an order,
uniform (about SF * 6 M rows), ``l_shipdate`` 1..121 days after its
order's date, ``l_quantity`` 1..50, ``l_extendedprice`` in cents and
``l_discount`` 0..10 percent. Text and enum columns are left out: they do
not shape the join.

The random source is one ``torch.Generator`` on the caller's device,
drawn in the order the JAX package splits its keys. The distributions are
the JAX package's; the bits are not (``torch.Generator`` is not
``jax.random``). The line count is read to the host once, at generation,
as in the JAX package: the join never does this.

The query tables add ``customer`` (SF * 150 k rows, dbgen's dense keys
1..n, a market segment of 5, an account balance in cents and a nation
key) and give ``orders`` its ``o_custkey`` foreign key, uniform over the
customers; the join keys carry the plans' names, ``custkey`` and
``orderkey``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from distributed_join_tpu_torch.device import resolve_device
from distributed_join_tpu_torch.table import Table

ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000
N_MKT_SEGMENTS = 5
DATE_RANGE_DAYS = 2406       # 1992-01-01 .. 1998-08-02
MAX_SHIP_LAG_DAYS = 121
MAX_LINES_PER_ORDER = 7


def sparse_order_keys(n_orders: int, device=None) -> torch.Tensor:
    """dbgen's sparse keys: order i (0-based) gets ``(i // 8) * 32 +
    (i % 8) + 1``, 8 keys in every block of 32, so a quarter of the key
    space is used."""
    i = torch.arange(n_orders, dtype=torch.int64,
                     device=resolve_device(device))
    return (i // 8) * 32 + (i % 8) + 1


def _randint(g: torch.Generator, low: int, high: int, n: int,
             dtype) -> torch.Tensor:
    return torch.randint(low, high, (n,), generator=g, dtype=dtype,
                         device=g.device)


def generate_orders(generator: torch.Generator, scale_factor: float) -> Table:
    """SF * 1.5 M orders on ``generator``'s device."""
    n = int(ORDERS_PER_SF * scale_factor)
    return Table.from_dense({
        "o_orderkey": sparse_order_keys(n, generator.device),
        "o_orderdate": _randint(generator, 0, DATE_RANGE_DAYS, n,
                                torch.int32),
        "o_totalprice": _randint(generator, 90_000, 55_550_000, n,
                                 torch.int64),  # cents
    })


def generate_lineitem(generator: torch.Generator, scale_factor: float,
                      orders: Table) -> Table:
    """1..7 lines an order, uniform; the ship date trails the order date
    by 1..121 days. The row count is read to the host here, once."""
    g = generator
    counts = _randint(g, 1, MAX_LINES_PER_ORDER + 1, orders.capacity,
                      torch.int64)
    total = int(counts.sum())  # generator time only

    def rep(col):
        return torch.repeat_interleave(col, counts, output_size=total)

    orderdate = rep(orders.columns["o_orderdate"])
    return Table.from_dense({
        "l_orderkey": rep(orders.columns["o_orderkey"]),
        "l_shipdate": orderdate + _randint(g, 1, MAX_SHIP_LAG_DAYS + 1,
                                           total, torch.int32),
        "l_quantity": _randint(g, 1, 51, total, torch.int32),
        "l_extendedprice": _randint(g, 90_000, 10_500_000, total,
                                    torch.int64),  # cents
        "l_discount": _randint(g, 0, 11, total, torch.int32),
    })


def generate_tpch_join_tables(seed: int, scale_factor: float,
                              device=None) -> Tuple[Table, Table]:
    """``(orders, lineitem)`` for the config-4 join: orders is the build
    side (the smaller), lineitem the probe side."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    orders = generate_orders(g, scale_factor)
    return orders, generate_lineitem(g, scale_factor, orders)


def q3_filter(orders: Table, lineitem: Table,
              cutoff_day: int = DATE_RANGE_DAYS // 2) -> Tuple[Table, Table]:
    """Q3's date predicates as validity masks (the shapes stay):
    ``o_orderdate < cutoff`` and ``l_shipdate > cutoff``."""
    o = Table(orders.columns,
              orders.valid & (orders.columns["o_orderdate"] < cutoff_day))
    li = Table(lineitem.columns,
               lineitem.valid & (lineitem.columns["l_shipdate"] > cutoff_day))
    return o, li


def generate_customer(generator: torch.Generator,
                      scale_factor: float) -> Table:
    """SF * 150 k customers with dbgen's dense keys 1..n:
    ``c_mktsegment`` uniform over 5 segments, ``c_acctbal`` in cents in
    dbgen's [-999.99, 9999.99], ``c_nationkey`` 0..24."""
    g = generator
    n = int(CUSTOMERS_PER_SF * scale_factor)
    return Table.from_dense({
        "c_custkey": torch.arange(1, n + 1, dtype=torch.int64,
                                  device=g.device),
        "c_mktsegment": _randint(g, 0, N_MKT_SEGMENTS, n, torch.int32),
        "c_acctbal": _randint(g, -99_999, 1_000_000, n, torch.int64),
        "c_nationkey": _randint(g, 0, 25, n, torch.int32),
    })


def generate_tpch_query_tables(seed: int, scale_factor: float,
                               device=None) -> dict:
    """``{"customer", "orders", "lineitem"}`` for the query plans, the
    join keys under the plans' names: ``custkey`` on customer and
    orders, ``orderkey`` on orders and lineitem. ``orders`` gains the
    ``o_custkey`` foreign key, uniform over the customers (unmatched
    customers included)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    customer = generate_customer(g, scale_factor)
    orders = generate_orders(g, scale_factor)
    lineitem = generate_lineitem(g, scale_factor, orders)
    custkey = _randint(g, 1, customer.capacity + 1, orders.capacity,
                       torch.int64)
    orders = Table(dict(orders.columns, o_custkey=custkey), orders.valid)
    return {
        "customer": customer.rename({"c_custkey": "custkey"}),
        "orders": orders.rename({"o_custkey": "custkey",
                                 "o_orderkey": "orderkey"}),
        "lineitem": lineitem.rename({"l_orderkey": "orderkey"}),
    }


def query_filters(tables: dict, query: str,
                  cutoff_day: int = DATE_RANGE_DAYS // 2,
                  segment: int = 1) -> dict:
    """The queries' predicates as validity masks (the shapes stay). Q3:
    ``c_mktsegment == segment``, ``o_orderdate < cutoff``,
    ``l_shipdate > cutoff``. Q10: ``o_orderdate`` in the 90 days from
    ``cutoff`` (dbgen's quarter)."""
    c, o, li = (tables["customer"], tables["orders"], tables["lineitem"])
    if query == "q3":
        c = Table(c.columns,
                  c.valid & (c.columns["c_mktsegment"] == segment))
        o = Table(o.columns,
                  o.valid & (o.columns["o_orderdate"] < cutoff_day))
        li = Table(li.columns,
                   li.valid & (li.columns["l_shipdate"] > cutoff_day))
    elif query == "q10":
        date = o.columns["o_orderdate"]
        o = Table(o.columns, o.valid & (date >= cutoff_day)
                  & (date < cutoff_day + 90))
    else:
        raise ValueError(f"unknown query {query!r}")
    return {"customer": c, "orders": o, "lineitem": li}
