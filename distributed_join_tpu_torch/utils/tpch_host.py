"""The config-4 tables generated on the host, chunk by chunk, into
key-range batches: TPC-H at a scale that does not fit a card.

Port of ``distributed_join_tpu/utils/tpch_host.py``: the dtype maps
(:48-59), the narrow-wire limit (:69-71), ``_gen_chunk`` (:76),
``generate_tpch_host_batches`` (:108) and ``rename_batches`` (:181). The
generator is numpy's PCG64, drawn in the JAX package's order with its
chunking and its release of chunk pieces, so the batches equal the JAX
package's bit for bit. Every generated row is binned into its key-range
batch as it appears (``parallel/out_of_core.key_batch_ids``, the batch
loop's own routing), so no table exists whole, on the host or the card:
only per-batch column blocks, which feed
``parallel/out_of_core.batched_join_host``.

With ``q3_filters`` the rows that fail Q3's date predicates are dropped
at generation and never cross PCIe. ``narrow_wire`` (the default) stages
every column as int32: every value fits while the sparse order keys stay
below 2^31 (SF up to about 357), and the H2D bytes nearly halve.

The whole-query oracle (``_merge_oracle`` :198 and ``query_oracle``
:237) is numpy here, where the JAX package's is pandas: a frame is a
dict of equal-length numpy columns (``Table.to_host``), so the oracle
runs on a machine without pandas.
"""

from __future__ import annotations

import ctypes.util
import functools
from typing import List, Tuple

import numpy as np

from distributed_join_tpu_torch.parallel.out_of_core import key_batch_ids
from distributed_join_tpu_torch.utils.tpch import (
    DATE_RANGE_DAYS,
    MAX_LINES_PER_ORDER,
    MAX_SHIP_LAG_DAYS,
    ORDERS_PER_SF,
)

DEFAULT_CHUNK_ORDERS = 4_000_000  # ~80 MB of orders, ~450 MB of lineitem

#: the numpy dtypes of the device generator's columns (utils/tpch.py)
ORDERS_DTYPES = {
    "o_orderkey": np.int64,
    "o_orderdate": np.int32,
    "o_totalprice": np.int64,
}
LINEITEM_DTYPES = {
    "l_orderkey": np.int64,
    "l_shipdate": np.int32,
    "l_quantity": np.int32,
    "l_extendedprice": np.int64,
    "l_discount": np.int32,
}

#: the narrow wire: every column int32, exact while the order keys
#: (about 4 * n_orders) stay below 2^31 (o_totalprice < 55.55 M and
#: l_extendedprice < 10.5 M always fit)
NARROW_ORDERS_DTYPES = {k: np.int32 for k in ORDERS_DTYPES}
NARROW_LINEITEM_DTYPES = {k: np.int32 for k in LINEITEM_DTYPES}
MAX_NARROW_ORDERS = 2**31 - 1

HostBatches = List[dict]  # one dict of numpy columns a key-range batch


def _gen_chunk(rng: np.random.Generator, start: int, count: int):
    """One chunk of orders and its lineitem rows (dbgen's semantics)."""
    i = np.arange(start, start + count, dtype=np.int64)
    okey = (i // 8) * 32 + (i % 8) + 1  # tpch.sparse_order_keys
    odate = rng.integers(0, DATE_RANGE_DAYS, count, dtype=np.int32)
    oprice = rng.integers(90_000, 55_550_000, count, dtype=np.int64)
    counts = rng.integers(1, MAX_LINES_PER_ORDER + 1, count, dtype=np.int32)

    lkey = np.repeat(okey, counts)
    ldate = np.repeat(odate, counts)
    t = lkey.shape[0]
    orders = {
        "o_orderkey": okey,
        "o_orderdate": odate,
        "o_totalprice": oprice,
    }
    lineitem = {
        "l_orderkey": lkey,
        "l_shipdate": ldate + rng.integers(
            1, MAX_SHIP_LAG_DAYS + 1, t, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, t, dtype=np.int32),
        "l_extendedprice": rng.integers(90_000, 10_500_000, t,
                                        dtype=np.int64),
        "l_discount": rng.integers(0, 11, t, dtype=np.int32),
    }
    return orders, lineitem


@functools.lru_cache(maxsize=None)
def _malloc_trim():
    """glibc's ``malloc_trim``, or None where the C library has none."""
    name = ctypes.util.find_library("c")
    return getattr(ctypes.CDLL(name), "malloc_trim", None) if name else None


def _return_freed_heap() -> None:
    """Hand the heap's free pages back to the OS. The chunk pieces (a few
    MB each, below glibc's mmap threshold) live on the heap, and glibc
    keeps a freed block that lies below a live one resident: without
    this the freed pieces stay in RSS, up to a second dataset."""
    trim = _malloc_trim()
    if trim is not None:
        trim(0)


def _select(cols: dict, sel: np.ndarray) -> dict:
    return {n: c[sel] for n, c in cols.items()}


def generate_tpch_host_batches(
    seed: int,
    scale_factor: float,
    n_batches: int,
    chunk_orders: int = DEFAULT_CHUNK_ORDERS,
    q3_filters: bool = False,
    cutoff_day: int = DATE_RANGE_DAYS // 2,
    narrow_wire: bool = True,
) -> Tuple[HostBatches, HostBatches]:
    """``(orders_batches, lineitem_batches)``: numpy column blocks, one a
    key-range batch, generated ``chunk_orders`` orders at a time. With
    ``q3_filters`` the rows failing ``o_orderdate < cutoff`` or
    ``l_shipdate > cutoff`` are dropped. ``narrow_wire`` casts every
    column to int32 (refused where the order keys reach 2^31)."""
    if n_batches < 1:
        raise ValueError("n_batches must be >= 1")
    rng = np.random.default_rng(seed)
    n_orders = int(ORDERS_PER_SF * scale_factor)
    if narrow_wire and n_orders * 4 >= MAX_NARROW_ORDERS:
        raise ValueError(
            "narrow_wire requires orderkeys < 2^31; lower the scale "
            "factor or pass narrow_wire=False")
    odt = NARROW_ORDERS_DTYPES if narrow_wire else ORDERS_DTYPES
    ldt = NARROW_LINEITEM_DTYPES if narrow_wire else LINEITEM_DTYPES

    oparts: List[List[dict]] = [[] for _ in range(n_batches)]
    lparts: List[List[dict]] = [[] for _ in range(n_batches)]
    for start in range(0, n_orders, chunk_orders):
        count = min(chunk_orders, n_orders - start)
        orders, lineitem = _gen_chunk(rng, start, count)
        if narrow_wire:
            orders = {k: v.astype(np.int32) for k, v in orders.items()}
            lineitem = {k: v.astype(np.int32) for k, v in lineitem.items()}
        if q3_filters:
            orders = _select(orders, orders["o_orderdate"] < cutoff_day)
            lineitem = _select(lineitem, lineitem["l_shipdate"] > cutoff_day)
        ob = key_batch_ids(orders["o_orderkey"], n_batches)
        lb = key_batch_ids(lineitem["l_orderkey"], n_batches)
        for b in range(n_batches):
            oparts[b].append(_select(orders, ob == b))
            lparts[b].append(_select(lineitem, lb == b))

    def _concat(parts: List[List[dict]], dtypes: dict) -> HostBatches:
        out = []
        for b in range(len(parts)):
            batch = parts[b]
            out.append({
                n: np.concatenate([p[n] for p in batch])
                if batch else np.zeros((0,), dtype=dt)
                for n, dt in dtypes.items()
            })
            # release the chunk pieces as each batch is made: with every
            # piece alive until the end, peak host memory would be twice
            # the dataset
            parts[b] = None
            _return_freed_heap()
        return out

    return _concat(oparts, odt), _concat(lparts, ldt)


def rename_batches(batches: HostBatches, mapping: dict) -> HostBatches:
    """Rename the columns of every batch (``Table.rename`` on the host)."""
    return [{mapping.get(n, n): c for n, c in cols.items()}
            for cols in batches]


# -- the whole-query oracle (multi-operator plans) --------------------------
#
# The replay mirrors the device semantics: the probe is the preserved
# (left) side, an absent side's payloads are zero, and the outer types
# add the `build#valid` / `probe#valid` columns, so
# `ops.aggregate.frames_equal` compares frames as they are.


def _key_ids(build: dict, probe: dict, keys) -> tuple:
    """Comparable 1-D key values of both sides: a single 1-D key as it
    is, a composite or 2-D key as ids numbered over both sides."""
    if len(keys) == 1 and np.asarray(build[keys[0]]).ndim == 1:
        return np.asarray(build[keys[0]]), np.asarray(probe[keys[0]])
    nb = len(build[keys[0]])
    ids = []
    for k in keys:
        both = np.concatenate([np.asarray(build[k]), np.asarray(probe[k])])
        _, inv = np.unique(both.reshape(both.shape[0], -1), axis=0,
                           return_inverse=True)
        ids.append(inv.reshape(-1))
    if len(ids) == 1:
        inv = ids[0]
    else:
        _, inv = np.unique(np.stack(ids, 1), axis=0, return_inverse=True)
        inv = inv.reshape(-1)
    return inv[:nb], inv[nb:]


def inner_match(bk: np.ndarray, pk: np.ndarray) -> tuple:
    """Every (probe row, build row) pair with equal keys: ``(probe
    index, build index, matches of each probe row)``, probe-major."""
    order = np.argsort(bk, kind="stable")
    sb = bk[order]
    lo = np.searchsorted(sb, pk, "left")
    cnt = np.searchsorted(sb, pk, "right") - lo
    p_idx = np.repeat(np.arange(len(pk)), cnt)
    first = np.cumsum(cnt) - cnt
    b_idx = order[np.repeat(lo - first, cnt) + np.arange(int(cnt.sum()))]
    return p_idx, b_idx, cnt


def _merge_oracle(probe: dict, build: dict, keys, join_type: str) -> dict:
    """The join of two host frames (JAX ``utils/tpch_host.py:198``):
    probe columns, then the build's non-key columns, then the outer
    types' validity columns; an absent side's values are zero."""
    keys = list(keys)
    bk, pk = _key_ids(build, probe, keys)
    p_idx, b_idx, cnt = inner_match(bk, pk)
    if join_type in ("semi", "anti"):
        keep = cnt > 0 if join_type == "semi" else cnt == 0
        return {c: np.asarray(v)[keep] for c, v in probe.items()}
    b_pay = [c for c in build if c not in keys]
    # (probe rows, build rows): None for an absent side
    parts = [(p_idx, b_idx)]
    if join_type in ("left", "full_outer"):
        parts.append((np.flatnonzero(cnt == 0), None))
    if join_type in ("right", "full_outer"):
        parts.append((None, np.flatnonzero(~np.isin(bk, pk))))

    def column(frame, idx, rows, col):
        a = np.asarray(frame[col])
        if idx is None:
            return np.zeros((rows,) + a.shape[1:], a.dtype)
        return a[idx]

    out = {}
    for frame, cols, side in ((probe, list(probe), 0), (build, b_pay, 1)):
        for col in cols:
            pieces = []
            for pb in parts:
                rows = len(pb[0] if pb[0] is not None else pb[1])
                if col in keys and pb[0] is None:   # a lone build's key
                    pieces.append(np.asarray(build[col])[pb[1]])
                else:
                    pieces.append(column(frame, pb[side], rows, col))
            out[col] = np.concatenate(pieces)
    for name, side, types in (("build#valid", 1, ("left", "full_outer")),
                              ("probe#valid", 0, ("right", "full_outer"))):
        if join_type in types:
            out[name] = np.concatenate([
                np.full(len(pb[0] if pb[0] is not None else pb[1]),
                        pb[side] is not None) for pb in parts])
    return out


def query_oracle(plan, frames: dict) -> dict:
    """Replay ``plan`` (a ``planning.query.QueryPlan``) over host frames
    (``Table.to_host`` of each base table). Returns the final frame:
    the joined rows of a materializing plan, or one row per group
    (sorted by the group keys) when the plan ends in a fused
    aggregate."""
    from distributed_join_tpu_torch.ops.aggregate import (
        AggregateSpec,
        group_reduce_frame,
    )

    env = dict(frames)
    for op in plan.ops:
        env[op.op_id] = _merge_oracle(env[op.probe], env[op.build],
                                      op.keys, op.join_type)
    final = env[plan.ops[-1].op_id]
    wire = plan.ops[-1].aggregate
    if wire is None:
        return final
    return group_reduce_frame(final, AggregateSpec.from_wire(wire))
