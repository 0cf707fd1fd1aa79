"""The segmented-sort local join: short runs, sorted as one batch, with
the bucketing done by the shuffle.

Port of ``distributed_join_tpu/ops/segmented.py``. The sender partitions
at fine granularity (``s`` sub-buckets per (batch, destination) bucket,
``ops/hashing.bucket_ids``), the wire pads each fine bucket to a static
capacity (``parallel/shuffle.shuffle_segmented``), and the receiver
reshapes its ``(source, segment)`` blocks into a ``(segments, run)``
batch: segment j's run concatenates every source's segment-j slots.
Segments are disjoint hash classes (equal keys share a hash, so a
segment), so matches never cross them, and the whole join runs batched
per segment, each segment owning an ``out_capacity`` output block.

:func:`batched_sort_merge_inner_join` is the plain join of
``ops/join.py`` with a leading segment axis: three batched stable sorts
along dim 1 (the build side, the merged side, the run records), one
int32 scatter of the record starts into ``segments * out_capacity``
slots, and row gathers along dim 1. The JAX package's segmented join is
an XLA formulation that reaches no Pallas kernel, and so is this one:
it launches none of the port's hand kernels.

Every scan of the batched domain is one 1-D cumulative sum over the
flattened ``(segments, run)`` tensor, rebased to each segment's start
(:func:`_row_cumsum`), and the reference's two ``cummax`` scans become
gathers at each run's start: on CUDA a 1-D ``cumsum`` is one device-wide
scan, where ``cummax`` (any shape) and a scan of a 2-D tensor along one
of its dims run a few thread blocks over a long row.

:func:`resolve_sort_segments` is the one owner of the segment count;
the capacity functions are exact host integer arithmetic, in the JAX
package's float order, since the overflow flag depends on them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from distributed_join_tpu_torch.table import Table

# Runs up to this many elements are the "short run" regime the segment
# count aims for; the resolver stops halving before fine buckets drop
# under MIN_SEGMENT_CAPACITY rows (pad overhead dominates there).
SEGMENT_TARGET_RUN = 32768
MIN_SEGMENT_CAPACITY = 64
I32_MAX = 2**31 - 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def segment_capacity(rows_local: int, n_ranks: int, k: int,
                     segments: int, factor: float) -> int:
    """Static per-(sender, destination, segment) fine-bucket capacity:
    the flat per-bucket arithmetic one level down. ``segments == 1``
    gives the flat per-bucket capacity."""
    return _round_up(
        int(math.ceil(rows_local / (n_ranks * k * segments) * factor)), 8)


def segmented_out_capacity(p_local: int, k: int, segments: int,
                           out_factor: float,
                           out_rows_per_rank: Optional[int]) -> int:
    """Static per-(batch, segment) output block."""
    if out_rows_per_rank is not None:
        return _round_up(
            int(math.ceil(int(out_rows_per_rank) / (k * segments))), 8)
    return _round_up(
        int(math.ceil(p_local / (k * segments) * out_factor)), 8)


def resolve_sort_segments(sort_segments: Optional[int], rows_local: int,
                          n_ranks: int, k: int, factor: float) -> int:
    """The segment count. An explicit ``sort_segments`` (>= 1) wins as
    it is; auto (None) doubles the count until the receive run
    ``n_ranks * segment_capacity`` fits ``SEGMENT_TARGET_RUN``,
    stopping early when the next doubling would shrink fine buckets
    below ``MIN_SEGMENT_CAPACITY``."""
    if sort_segments is not None:
        s = int(sort_segments)
        if s < 1:
            raise ValueError("sort_segments must be >= 1")
        return s
    s = 1
    while (n_ranks * segment_capacity(rows_local, n_ranks, k, s, factor)
           > SEGMENT_TARGET_RUN
           and segment_capacity(rows_local, n_ranks, k, 2 * s, factor)
           >= MIN_SEGMENT_CAPACITY):
        s *= 2
    return s


def runs_from_blocks(recv_cols: dict, recv_counts: torch.Tensor):
    """One side's received ``(n_src, segments, seg_cap, ...)`` blocks
    and ``(n_src, segments)`` fine counts as the ``(segments, run)``
    batch the batched join takes: segment j's run is every source's
    segment-j slots. Returns ``(cols, valid)``, cols ``(segments, n_src
    * seg_cap, ...)``."""
    n, s, cap = next(iter(recv_cols.values())).shape[:3]
    cols = {name: c.transpose(0, 1).reshape((s, n * cap)
                                            + tuple(c.shape[3:]))
            for name, c in recv_cols.items()}
    lane = torch.arange(cap, dtype=torch.int32, device=recv_counts.device)
    valid = (lane[None, None, :] < recv_counts[:, :, None]).transpose(
        0, 1).reshape(s, n * cap)
    return cols, valid


def _grouped_take(cols: dict, idx: torch.Tensor) -> dict:
    """Rows ``idx[seg, j]`` of every (segments, R) column, one gather a
    dtype group (same-dtype columns stacked on a trailing dim)."""
    groups: dict = {}
    for name, c in cols.items():
        groups.setdefault(c.dtype, []).append(name)
    out = {}
    for names in groups.values():
        if len(names) == 1:
            out[names[0]] = torch.take_along_dim(cols[names[0]], idx, 1)
        else:
            pack = torch.stack([cols[nm] for nm in names], dim=2)
            rows = torch.take_along_dim(pack, idx[:, :, None], 1)
            for j, nm in enumerate(names):
                out[nm] = rows[:, :, j]
    return out


def _row_cumsum(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inclusive cumulative sum of (segments, R) ``x`` along dim 1:
    one 1-D cumsum of the flattened tensor, each row rebased by the sum
    before it (exact in modular int32 arithmetic too)."""
    s, r = x.shape
    if r == 0:
        return x.to(dtype)
    flat = torch.cumsum(x.reshape(-1), 0, dtype=dtype).reshape(s, r)
    base = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - base[:, None]


def _lexsort_rows(ops) -> torch.Tensor:
    """The (segments, R) permutation sorting each row by ``ops`` (most
    significant first): stable sorts along dim 1 from the least
    significant operand up."""
    perm = None
    for op in reversed(ops):
        v = op if perm is None else torch.take_along_dim(op, perm, 1)
        idx = torch.sort(v, dim=1, stable=True).indices
        perm = idx if perm is None else torch.take_along_dim(perm, idx, 1)
    return perm


def _sentinel_max(dt: torch.dtype):
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


def batched_sort_merge_inner_join(
    bcols: dict, bvalid: torch.Tensor,
    pcols: dict, pvalid: torch.Tensor,
    keys: Sequence[str], out_capacity: int,
    build_payload: Optional[Sequence[str]] = None,
    probe_payload: Optional[Sequence[str]] = None,
    _internal: Sequence[str] = (),
):
    """Inner-join ``segments`` disjoint (build, probe) run pairs in one
    batched pipeline.

    ``bcols``/``pcols`` map names to ``(segments, R[, width])`` tensors,
    ``bvalid``/``pvalid`` are the (segments, R) masks, ``out_capacity``
    is a segment's block. Returns ``(table, total, overflow)``: the
    table flattened segment-major to ``segments * out_capacity`` masked
    rows (keys, build payloads, probe payloads), ``total`` the int64
    match count, ``overflow`` True iff a segment's matches (counted in
    int64) exceed its block."""
    keys = list(keys)
    if build_payload is None:
        build_payload = [nm for nm in bcols if nm not in keys]
    if probe_payload is None:
        probe_payload = [nm for nm in pcols if nm not in keys]
    build_payload, probe_payload = list(build_payload), list(probe_payload)
    clash = set(build_payload) & set(probe_payload)
    if clash:
        raise ValueError(f"payload name collision: {sorted(clash)}")
    reserved = [nm for nm in (*keys, *build_payload, *probe_payload)
                if nm.startswith("__") and nm not in _internal]
    if reserved:
        raise ValueError("column names starting with '__' are reserved for "
                         f"internal join lanes: {sorted(set(reserved))}")
    b1d = [nm for nm in build_payload if bcols[nm].ndim == 2]
    b2d = [nm for nm in build_payload if bcols[nm].ndim > 2]
    p1d = [nm for nm in probe_payload if pcols[nm].ndim == 2]
    p2d = [nm for nm in probe_payload if pcols[nm].ndim > 2]

    s, nb = bvalid.shape
    npr = pvalid.shape[1]
    n = nb + npr
    assert s * out_capacity < I32_MAX, (s, out_capacity)
    dev = bvalid.device

    def masked(c, valid):
        return torch.where(valid, c, torch.full_like(
            c, _sentinel_max(c.dtype)))

    # 1. build-side sort (batched): keys + tag; the permutation itself
    #    is each segment's build row index for 2-D columns.
    btag = (~bvalid).to(torch.int8)
    perm_b = _lexsort_rows([*(masked(bcols[k], bvalid) for k in keys),
                            btag])
    sb_payload = {nm: torch.take_along_dim(bcols[nm], perm_b, 1)
                  for nm in b1d}

    # 2. merged sort (batched): keys + side tag, probe values riding.
    m_ops = [torch.cat([masked(bcols[k], bvalid), masked(pcols[k], pvalid)],
                       dim=1) for k in keys]
    zero8 = torch.zeros((), dtype=torch.int8, device=dev)
    two8 = torch.full((), 2, dtype=torch.int8, device=dev)
    tag = torch.cat([torch.where(bvalid, zero8, two8),
                     torch.where(pvalid, zero8 + 1, two8)], dim=1)
    perm = _lexsort_rows([*m_ops, tag])
    skeys = [torch.take_along_dim(op, perm, 1) for op in m_ops]
    stag = torch.take_along_dim(tag, perm, 1)
    sp_payload = {nm: torch.take_along_dim(torch.cat(
        [pcols[nm].new_zeros((s, nb)), pcols[nm]], dim=1), perm, 1)
        for nm in p1d}

    # 3. scans, per segment: a run starts where a key changes or a
    #    segment starts; lo is b_before at its run's start.
    is_build = stag == 0
    is_probe = stag == 1
    ib = is_build.to(torch.int32)
    b_before = _row_cumsum(ib, torch.int32) - ib
    first = torch.zeros((s, n), dtype=torch.bool, device=dev)
    first[:, 0] = True
    for sk in skeys:
        first[:, 1:] |= sk[:, 1:] != sk[:, :-1]
    run = _row_cumsum(first.to(torch.int32), torch.int32)
    run_flat = (run - 1 + torch.arange(s, dtype=torch.int32, device=dev)[
        :, None] * n).reshape(-1)
    at_start = torch.zeros(s * n + 1, dtype=torch.int32, device=dev)
    at_start.scatter_(0, torch.where(first.reshape(-1), run_flat,
                                     s * n).long(), b_before.reshape(-1))
    lo = at_start[run_flat.long()].reshape(s, n)
    cnt = torch.where(is_probe, b_before - lo, 0)
    total_seg = cnt.sum(1, dtype=torch.int64)
    total = total_seg.sum()
    start_out = _row_cumsum(cnt, torch.int64) - cnt    # segment-local slots

    # 4. run-record sort (batched): one record per matching probe, by
    #    its first output slot.
    is_rec = is_probe & (cnt > 0)
    rkey = torch.where(is_rec, start_out.clamp(max=I32_MAX).to(torch.int32),
                       I32_MAX)
    rperm = torch.sort(rkey, dim=1, stable=True).indices
    rec_cols = {f"__key{i}": sk for i, sk in enumerate(skeys)}
    rec_cols.update(sp_payload)
    rec_cols["__lo"] = lo
    if p2d:
        rec_cols["__prow"] = perm.to(torch.int32)

    def prefix(a, fill):
        a = torch.take_along_dim(a, rperm, 1)
        if n >= out_capacity:
            return a[:, :out_capacity]
        return torch.cat([a, torch.full((s, out_capacity - n), fill,
                                        dtype=a.dtype, device=dev)], dim=1)

    S = prefix(rkey, I32_MAX)
    recs = {nm: prefix(c, 0) for nm, c in rec_cols.items()}

    # 5. expansion: one int32 scatter of each record's index + 1 to its
    #    first slot, the segment's offset folded in (records past a
    #    segment's block land in a dropped slot); a slot's record is the
    #    count of record starts up to it, less one.
    j = torch.arange(out_capacity, dtype=torch.int32, device=dev).expand(
        s, out_capacity)
    seg_off = torch.arange(s, dtype=torch.int64, device=dev)[:, None] \
        * out_capacity
    slot = torch.where(S < out_capacity, seg_off + S, s * out_capacity)
    raw = torch.zeros(s * out_capacity + 1, dtype=torch.int32, device=dev)
    raw.scatter_(0, slot.reshape(-1), (j + 1).reshape(-1))
    starts = raw[:-1].reshape(s, out_capacity) > 0
    ridx = (_row_cumsum(starts.to(torch.int32), torch.int32) - 1).clamp(
        min=0).long()
    out_vals = _grouped_take(recs, ridx)
    start_b = torch.take_along_dim(S, ridx, 1)
    rank = out_vals.pop("__lo").long() + (j - start_b).long()
    safe_rank = rank.clamp(0, max(nb - 1, 0))
    build_vals = _grouped_take(sb_payload, safe_rank)

    out_cols = {k: out_vals.pop(f"__key{i}") for i, k in enumerate(keys)}
    for nm in b1d:
        out_cols[nm] = build_vals[nm]
    if b2d:
        bidx = torch.take_along_dim(perm_b, safe_rank, 1)
        for nm in b2d:
            out_cols[nm] = torch.take_along_dim(bcols[nm], bidx[:, :, None],
                                                1)
    for nm in p1d:
        out_cols[nm] = out_vals.pop(nm)
    if p2d:
        prow = (out_vals.pop("__prow").long() - nb).clamp(0, max(npr - 1, 0))
        for nm in p2d:
            out_cols[nm] = torch.take_along_dim(pcols[nm], prow[:, :, None],
                                                1)
    out_valid = j.to(torch.int64) < total_seg[:, None]
    flat = {nm: out_cols[nm].reshape((s * out_capacity,)
                                     + tuple(out_cols[nm].shape[2:]))
            for nm in [*keys, *build_payload, *probe_payload]}
    overflow = (total_seg > out_capacity).any()
    return Table(flat, out_valid.reshape(-1)), total, overflow
