"""Per-partition sort-merge join: the inner join and its typed family.

Port of ``distributed_join_tpu/ops/join.py`` ``sort_merge_inner_join``
in its two formulations:

- the kernel pipeline (``_join_kernel_path``; CUDA tensors): ONE
  value-carrying merged sort (``torch.sort``, stable by key then side
  tag), the fused scans (ops/scan.py), two stream compactions
  (ops/compact.py: the run-record block and a build pack) and the
  expand-gather with in-kernel build materialization (ops/expand.py).
  The inner join packs the matched builds, the typed joins every valid
  build, so that an unmatched build row can gather its own values;
- the plain formulation (``_join_plain``; CPU tensors, and the kernel
  pipeline's twin): build-side sort, merged sort, scans as torch ops, a
  record sort, and scatter + cummax + row gathers.

Join types (``JOIN_TYPES``; the probe is the preserved, "left" side):
each merged position emits ``emit`` output rows instead of its match
count ``cnt`` (left and full outer pad an unmatched probe to one row,
semi and anti keep a presence or absence bit, right and full outer emit
an unmatched build row once). Outer types append bool validity columns
(``BUILD_VALID``, ``PROBE_VALID``) and zero the absent side's values.

Output capacity is static; the true output row count (int64) and an
overflow flag come back beside it. Duplicate keys on both sides are
supported; padding rows never match. Row order inside a key run is
arbitrary: the result is a multiset of rows, as in the JAX package. The
kernel pipeline makes no host synchronisation.

Composite keys are extra key operands of the same sorts. 2-D columns
(fixed-width strings, utils/strings.py) ride neither sort nor kernel:
their row indices do (``__prow`` on the probe side, ``__browidx`` on the
build side), and each 2-D column is one row gather after the expand. A
2-D uint8 key joins on its bytes through packed 64-bit words, the
composite-key machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.ops.compact import stream_compact
from distributed_join_tpu_torch.ops.expand import (
    expand_gather,
    expand_gather_reference,
)
from distributed_join_tpu_torch.ops.kernel_config import (
    KernelConfig,
    resolve as resolve_kernel_config,
)
from distributed_join_tpu_torch.ops.lanes import (
    from_u64_lane,
    to_u64_lane,
    u64_lane_ok,
)
from distributed_join_tpu_torch.ops.scan import join_scans
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils.strings import (
    LEN_SUFFIX,
    check_key_ndim,
    prepare_string_key_join,
    rebuild_string_keys,
)

I32_MAX = 2**31 - 1
JOIN_TYPES = ("inner", "left", "right", "full_outer", "semi", "anti")
OUTER_TYPES = ("left", "right", "full_outer")
BUILD_VALID = "build#valid"   # emitted by left and full outer joins
PROBE_VALID = "probe#valid"   # emitted by right and full outer joins


@dataclasses.dataclass(frozen=True)
class JoinResult:
    table: Table            # static capacity; .valid marks result rows
    total: torch.Tensor     # 0-d int64: true match count (may exceed capacity)
    overflow: torch.Tensor  # 0-d bool: total > capacity, rows truncated
    # distributed_inner_join attaches a host-side ``retry_report``
    # (parallel/faults.RetryReport) as an extra attribute.


def patch_string_lengths(table: Table, keys, join_type: str) -> Table:
    """Recompute '<key>#len' companions from the rebuilt key bytes on
    rows whose probe side is absent (right and full outer joins: the
    companion rides as probe payload and is zeroed there). The encoding
    is zero-padded with no interior NULs, so the byte count is the
    length. The inner join has no such rows: it returns ``table``."""
    if join_type not in ("right", "full_outer"):
        return table
    cols = dict(table.columns)
    pm = cols[PROBE_VALID]
    for k in keys:
        ln = k + LEN_SUFFIX
        if ln in cols and cols[k].ndim == 2:
            from_bytes = (cols[k] != 0).sum(1).to(cols[ln].dtype)
            cols[ln] = torch.where(pm, cols[ln], from_bytes)
    return Table(cols, table.valid)


def _sentinel_max(dt: torch.dtype):
    if dt.is_floating_point:
        return float("inf")
    return torch.iinfo(dt).max


def _lexsort(ops) -> torch.Tensor:
    """Permutation sorting rows by ``ops`` (most significant first):
    stable sorts from the least significant operand up."""
    perm = None
    for op in reversed(ops):
        v = op if perm is None else op[perm]
        idx = torch.sort(v, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def _masked_keys(build: Table, probe: Table, keys):
    """Merged key operands (invalid rows -> dtype max) and side tag
    (0 build, 1 probe, 2 padding)."""
    m_ops = []
    for k in keys:
        b, p = build.columns[k], probe.columns[k]
        s = _sentinel_max(b.dtype)
        m_ops.append(torch.cat([
            torch.where(build.valid, b, torch.full_like(b, s)),
            torch.where(probe.valid, p, torch.full_like(p, s)),
        ]))
    dev = build.device
    two = torch.full((), 2, dtype=torch.int8, device=dev)
    tag = torch.cat([
        torch.where(build.valid, torch.zeros((), dtype=torch.int8,
                                             device=dev), two),
        torch.where(probe.valid, torch.ones((), dtype=torch.int8,
                                            device=dev), two),
    ])
    return m_ops, tag


def _run_starts(skeys) -> torch.Tensor:
    n = skeys[0].shape[0]
    first = torch.zeros(n, dtype=torch.bool, device=skeys[0].device)
    for sk in skeys:
        first[1:] |= sk[1:] != sk[:-1]
    first[:1] = True
    return first


def _kernel_path_ok(build, probe, keys, b1d, p1d, out_capacity) -> bool:
    """Static rules for the kernel pipeline (the JAX package's
    ``_kernel_path_ok``): both sides non-empty, the merged domain and
    the output inside int32, and every column a u64 lane."""
    nb, npr = build.capacity, probe.capacity
    if not (0 < nb and npr > 0 and nb + npr < 2**31 - 2
            and out_capacity < 2**31 - 2):
        return False
    dts = ([build.columns[k].dtype for k in keys]
           + [build.columns[c].dtype for c in b1d]
           + [probe.columns[c].dtype for c in p1d])
    return all(u64_lane_ok(dt) for dt in dts)


def _merged_sort(build: Table, probe: Table, keys, b1d, p1d,
                 b2d=(), p2d=()):
    """The kernel pipeline's one merged sort: keys + side tag as sort
    keys; both sides' payloads ride as values, same-dtype (probe, build)
    pairs sharing one lane (a build row never needs a probe value). With
    2-D columns on a side, that side's row index rides too (``__prow``,
    ``__browidx``: int32, per side).
    Returns (sorted keys, sorted tag, {("p"|"b", name): sorted lane}),
    all of it launched inside the ``merged_sort`` phase."""
    nb, npr = build.capacity, probe.capacity
    with telemetry.phase("merged_sort"):
        m_ops, tag = _masked_keys(build, probe, keys)
        perm = _lexsort([*m_ops, tag])
        pq = [(nm, probe.columns[nm]) for nm in p1d]
        bq = [(nm, build.columns[nm]) for nm in b1d]
        if p2d:
            pq.append(("__prow", torch.arange(npr, dtype=torch.int32,
                                              device=probe.device)))
        if b2d:
            bq.append(("__browidx", torch.arange(nb, dtype=torch.int32,
                                                 device=build.device)))
        svals = {}
        for pnm, pc in pq:
            mate = next((t for t in bq if t[1].dtype == pc.dtype), None)
            if mate is not None:
                bq.remove(mate)
                lane = torch.cat([mate[1], pc])
                svals[("b", mate[0])] = svals[("p", pnm)] = lane[perm]
            else:
                svals[("p", pnm)] = torch.cat([pc.new_zeros(nb), pc])[perm]
        for bnm, bc in bq:
            svals[("b", bnm)] = torch.cat([bc, bc.new_zeros(npr)])[perm]
        return [op[perm] for op in m_ops], tag[perm], svals


def _row_gather(col: torch.Tensor, idx: torch.Tensor, n: int):
    """Rows ``idx`` of a 2-D column, indices clipped into [0, n): slots
    past the total carry an arbitrary row, as in the JAX package (zeros
    from a side with no rows).

    A row is gathered as the widest words its bytes divide into, one
    element of the index a word: on CUDA, ``col[idx]`` of narrow rows
    takes a gather that spends a block a row (3.6 ms for config 5's
    6 M rows of 16 bytes, PERF.md section 5)."""
    shape = (idx.shape[0],) + tuple(col.shape[1:])
    if n == 0:
        return col.new_zeros(shape)
    rows = col.reshape(n, -1)
    nbytes = rows.shape[1] * rows.element_size()
    word = next(dt for dt in (torch.int64, torch.int32, torch.int16,
                              torch.uint8)
                if nbytes % dt.itemsize == 0)
    if rows.is_contiguous():
        rows = rows.view(word)
    k = torch.arange(rows.shape[1], device=col.device)
    out = rows[idx.long().clamp(0, n - 1)[:, None], k[None, :]]
    return out.view(col.dtype).reshape(shape)


def compact_records(mask, pos, cols, capacity):
    """The run-record block of the kernel pipeline: :func:`stream_compact`
    with its launches counted on this call site."""
    return stream_compact(mask, pos, cols, capacity,
                          launch_counter=compact_records)


def pack_matched_builds(mask, pos, cols, capacity):
    """The matched-build pack of the kernel pipeline: :func:`stream_compact`
    with its launches counted on this call site."""
    return stream_compact(mask, pos, cols, capacity,
                          launch_counter=pack_matched_builds)


def pack_valid_builds(mask, pos, cols, capacity):
    """The valid-build pack of the typed joins' kernel pipeline:
    :func:`stream_compact` with its launches counted on this call site."""
    return stream_compact(mask, pos, cols, capacity,
                          launch_counter=pack_valid_builds)


compact_records.launches = 0
pack_matched_builds.launches = 0
pack_valid_builds.launches = 0


def _emit(join_type, is_probe, cnt, b_unmatched):
    """Output rows of each merged position (JAX ops/join.py:849-858):
    a probe emits its match count ``cnt``, padded to one row by left and
    full outer joins, collapsed to a presence (semi) or absence (anti)
    bit; right and full outer joins add one row for each unmatched build
    (``b_unmatched``: a build row whose key run holds no probe)."""
    if join_type == "inner":
        return cnt
    if join_type == "semi":
        return (is_probe & (cnt > 0)).to(torch.int32)
    if join_type == "anti":
        return (is_probe & (cnt == 0)).to(torch.int32)
    # a position is a probe, a build or padding: one of the two terms
    probe_rows = cnt if join_type == "right" else cnt.clamp(min=1)
    return torch.where(is_probe, probe_rows,
                       0 if join_type == "left" else
                       b_unmatched.to(torch.int32))


def _join_kernel_path(build, probe, keys, b1d, p1d, out_capacity,
                      b2d=(), p2d=(), join_type="inner"):
    """The kernel pipeline. The inner join takes its run records, output
    slots and matched-build pack from the fused scans. A typed join takes
    ``cnt`` and ``matched`` from them (an unmatched build is a build the
    scans did not mark matched), its emission and output slots from
    torch cumsums, and packs every valid build in merged order: a probe
    record gathers from its run's first build, rank ``b_before - cnt``,
    and an unmatched build record its own row, rank ``b_before``. The
    merged sort shares a lane between a same-dtype (probe, build) pair,
    so a build record carries build values in its probe lanes: right and
    full outer joins zero every probe output where the probe side is
    absent."""
    nb, npr = build.capacity, probe.capacity
    dev = build.device
    skeys, stag, svals = _merged_sort(build, probe, keys, b1d, p1d, b2d,
                                      p2d)
    # Scan outputs are dropped from (a copy of) the scans' dict as their
    # last use passes: at 2^30 merged positions each is 4 GiB.
    sc = dict(join_scans(stag, _run_starts(skeys)))
    cnt = sc.pop("cnt")
    pack_names = list(b1d) + (["__browidx"] if b2d else [])
    lo = flags = None
    if join_type == "inner":
        # start_out is int32; past 2**31 matches it wraps, but the int64
        # total still raises `overflow`, flagging every row untrustworthy.
        total = cnt.sum(dtype=torch.int64)
        rec_total = sc["rec_pos"][-1] + 1
        is_rec = (stag == 1) & (cnt > 0)
        start_out, rec_pos = sc.pop("start_out"), sc.pop("rec_pos")
        lo = sc.pop("lo_m")
    else:
        is_build, is_probe = stag == 0, stag == 1
        emit = _emit(join_type, is_probe, cnt,
                     is_build & (sc.pop("matched") == 0))
        total = emit.sum(dtype=torch.int64)
        start_out = torch.cumsum(emit, 0, dtype=torch.int32) - emit
        is_rec = emit > 0
        del emit
        rec_pos = torch.cumsum(is_rec.to(torch.int32), 0,
                               dtype=torch.int32) - 1
        rec_total = rec_pos[-1] + 1
        if pack_names:
            ib = is_build.to(torch.int32)
            b_incl = torch.cumsum(ib, 0, dtype=torch.int32)
            lo = b_incl - ib - cnt
        if join_type in OUTER_TYPES:
            # 1: only the build side is present (an unmatched build);
            # 2: only the probe side (an unmatched probe); 3: both
            flags = torch.where(is_probe, (cnt > 0).to(torch.int8) + 2,
                                is_build.to(torch.int8)).long()
    del cnt

    # Run records: one per emitting position, in start_out order (their
    # compaction slot rises with it), carrying S, the probe-side output
    # values, the build rank of the run start (with a build pack), the
    # side flags (outer joins) and the probe row index of 2-D columns.
    rec_lanes = {"__S": to_u64_lane(start_out)}
    del start_out
    for i, sk in enumerate(skeys):
        rec_lanes[f"__key{i}"] = to_u64_lane(sk)
    del skeys
    for nm in p1d:
        rec_lanes[nm] = to_u64_lane(svals[("p", nm)])
    if pack_names:
        rec_lanes["__lo"] = to_u64_lane(lo)
    del lo
    if flags is not None:
        rec_lanes["__flags"] = flags
        del flags
    if p2d:
        rec_lanes["__prow"] = to_u64_lane(svals[("p", "__prow")])
    rec_names = list(rec_lanes)
    compacted = dict(zip(rec_names, compact_records(
        is_rec, rec_pos, [rec_lanes.pop(nm) for nm in rec_names],
        out_capacity)))
    del rec_pos
    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    live = j < torch.clamp(rec_total, max=out_capacity)
    # slots past the survivor count are undefined: S gets the sentinel,
    # lo zero
    S = torch.where(live, compacted["__S"].to(torch.int32),
                    torch.full_like(j, I32_MAX))

    rec_value_names = [nm for nm in rec_names if nm not in ("__S", "__lo")]
    cols_list = [compacted[nm] for nm in rec_value_names]
    if pack_names:
        lo_rec = torch.where(live, compacted["__lo"].to(torch.int32),
                             torch.zeros_like(j))
        lanes = [to_u64_lane(svals[("b", nm)]) for nm in pack_names]
        if join_type == "inner":
            # matched-build pack: dense, key-ordered
            pack = pack_matched_builds(sc["matched"] != 0, sc["mb_pos"],
                                       lanes, nb)
        else:
            # every valid build, in merged order
            pack = pack_valid_builds(is_build, b_incl - 1, lanes, nb)
        rec_outs, build_outs = expand_gather(
            S, cols_list, out_capacity, lo=lo_rec, build_cols=pack)
    else:
        rec_outs, _ = expand_gather(S, cols_list, out_capacity)
        build_outs = []
    rec_vals = dict(zip(rec_value_names, rec_outs))
    build_vals = dict(zip(pack_names, build_outs))

    out_cols = {}
    for i, k in enumerate(keys):
        out_cols[k] = from_u64_lane(rec_vals[f"__key{i}"],
                                    build.columns[k].dtype)
    for nm in b1d:
        out_cols[nm] = from_u64_lane(build_vals[nm], build.columns[nm].dtype)
    for nm in b2d:
        out_cols[nm] = _row_gather(build.columns[nm],
                                   build_vals["__browidx"], nb)
    for nm in p1d:
        out_cols[nm] = from_u64_lane(rec_vals[nm], probe.columns[nm].dtype)
    for nm in p2d:
        # __prow is the per-side probe row index: no -nb rebase
        out_cols[nm] = _row_gather(probe.columns[nm], rec_vals["__prow"],
                                   npr)
    if "__flags" in rec_vals:
        f = rec_vals["__flags"].to(torch.int8)
        _null_absent_sides(out_cols, join_type, (f & 1) != 0, f > 1,
                           [*b1d, *b2d], [*p1d, *p2d])
    return out_cols, total, j


def _null_absent_sides(out_cols, join_type, bm, pm, b_names, p_names):
    """Zero the values of the side an outer join's row lacks (``bm``,
    ``pm``: the build or probe side is present), and append the validity
    columns (JAX ops/join.py:936-966). A right join's build side and a
    left join's probe side are always present."""
    zero_b = join_type in ("left", "full_outer")
    zero_p = join_type in ("right", "full_outer")
    for names, present, on in ((b_names, bm, zero_b), (p_names, pm, zero_p)):
        for nm in names if on else ():
            c = out_cols[nm]
            keep = present.reshape(-1, *([1] * (c.ndim - 1)))
            out_cols[nm] = torch.where(keep, c, 0)
    if zero_b:
        out_cols[BUILD_VALID] = bm
    if zero_p:
        out_cols[PROBE_VALID] = pm


def _join_plain(build, probe, keys, b1d, p1d, out_capacity, b2d=(),
                p2d=(), join_type="inner"):
    nb, npr = build.capacity, probe.capacity
    n = nb + npr
    dev = build.device

    # 1. build-side sort: valid rows land in a key-sorted prefix whose
    #    order agrees with the merge ranks below; the permutation itself
    #    is the build row index of 2-D columns.
    b_ops = []
    for k in keys:
        c = build.columns[k]
        b_ops.append(torch.where(build.valid, c,
                                 torch.full_like(c, _sentinel_max(c.dtype))))
    btag = (~build.valid).to(torch.int8)
    perm_b = _lexsort([*b_ops, btag])
    sb_payload = {nm: build.columns[nm][perm_b] for nm in b1d}

    # 2. merged sort (the ``merged_sort`` phase): keys + side tag; probe
    #    payloads ride (zeros on build rows, which an unmatched build's
    #    record carries), and the merged row index for 2-D columns (the
    #    permutation itself).
    with telemetry.phase("merged_sort"):
        m_ops, tag = _masked_keys(build, probe, keys)
        perm = _lexsort([*m_ops, tag])
        skeys = [op[perm] for op in m_ops]
        stag = tag[perm]
        sp_payload = {
            nm: torch.cat([probe.columns[nm].new_zeros(nb),
                           probe.columns[nm]])[perm]
            for nm in p1d
        }

    # 3. runs and counts; the typed joins' emission
    is_build = stag == 0
    is_probe = stag == 1
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    first = _run_starts(skeys)
    b_before = (torch.cumsum(is_build.to(torch.int32), 0, dtype=torch.int32)
                - is_build.to(torch.int32))
    lo = torch.cummax(torch.where(first, b_before, zero), 0).values
    cnt = torch.where(is_probe, b_before - lo, zero)
    b_unmatched = None
    if join_type in ("right", "full_outer"):
        # probes through each run's end, broadcast back down the run (a
        # reversed cummin of the run-last samples, which never decrease):
        # a build whose run has no probe after it has none at all
        p_incl = torch.cumsum(is_probe.to(torch.int32), 0,
                              dtype=torch.int32)
        run_last = torch.cat([first[1:], first.new_ones(1)])
        p_thru = torch.flip(torch.cummin(torch.flip(torch.where(
            run_last, p_incl, torch.full_like(p_incl, I32_MAX)), (0,)),
            0).values, (0,))
        b_unmatched = is_build & (p_thru == p_incl)
    emit = _emit(join_type, is_probe, cnt, b_unmatched)
    csum = torch.cumsum(emit, 0, dtype=torch.int32)
    total = emit.sum(dtype=torch.int64)
    start_out = csum - emit
    is_rec = emit > 0

    # 4. run-record sort: one record per emitting position, keyed by its
    #    first output slot; everything an output slot needs rides. An
    #    unmatched build's record gathers its own row, rank b_before.
    rkey = torch.where(is_rec, start_out, torch.full_like(start_out, I32_MAX))
    rperm = torch.sort(rkey, stable=True).indices
    rec_cols = {f"__key{i}": sk for i, sk in enumerate(skeys)}
    rec_cols.update(sp_payload)
    if join_type == "inner":
        rec_cols["__lo"] = lo
    else:
        rec_cols["__lo"] = torch.where(is_build, b_before, lo)
        rec_cols["__bm"] = is_build | (cnt > 0)
        rec_cols["__pm"] = is_probe
    if p2d:
        rec_cols["__prow"] = perm

    def _prefix(a, fill):
        a = a[rperm]
        if n >= out_capacity:
            return a[:out_capacity]
        return torch.cat([a, torch.full((out_capacity - n,), fill,
                                        dtype=a.dtype, device=dev)])

    S = _prefix(rkey, I32_MAX)
    recs = {nm: _prefix(c, 0) for nm, c in rec_cols.items()}

    # 5. expansion: scatter + cummax + row gathers; the build side is a
    #    row gather at the derived in-run rank.
    names = list(recs)
    outs, start_b = expand_gather_reference(S, [recs[nm] for nm in names],
                                            out_capacity)
    out_vals = dict(zip(names, outs))
    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    rank = out_vals.pop("__lo").long() + (j - start_b).long()
    safe = rank.clamp(0, max(nb - 1, 0))
    out_cols = {k: out_vals[f"__key{i}"] for i, k in enumerate(keys)}
    for nm in b1d:
        out_cols[nm] = sb_payload[nm][safe]
    if b2d:
        bidx = perm_b[safe] if nb else safe
        for nm in b2d:
            out_cols[nm] = _row_gather(build.columns[nm], bidx, nb)
    for nm in p1d:
        out_cols[nm] = out_vals[nm]
    for nm in p2d:
        out_cols[nm] = _row_gather(probe.columns[nm],
                                   out_vals["__prow"] - nb, npr)
    if join_type in OUTER_TYPES:
        _null_absent_sides(out_cols, join_type, out_vals["__bm"],
                           out_vals["__pm"], [*b1d, *b2d], [*p1d, *p2d])
    return out_cols, total, j


def sort_merge_inner_join(
    build: Table,
    probe: Table,
    key,
    out_capacity: int,
    build_payload: Optional[Sequence[str]] = None,
    probe_payload: Optional[Sequence[str]] = None,
    kernel_config: Optional[KernelConfig] = None,
    join_type: str = "inner",
    _internal: Sequence[str] = (),
) -> JoinResult:
    """Join ``build`` and ``probe`` on equality of ``key`` (a column name
    or a sequence of names). A key column may be a fixed-width 2-D uint8
    byte column (utils/strings.py): it joins on equality of its
    zero-padded bytes through packed 64-bit words, and comes back as
    bytes. Output columns: the key column(s), then build payloads, then
    probe payloads, then the validity columns of an outer join
    (``BUILD_VALID`` for left and full outer, ``PROBE_VALID`` for right
    and full outer). Payload names must not collide.

    ``join_type`` is one of ``JOIN_TYPES``; semi and anti joins emit
    probe columns only and refuse an explicit build payload. ``total``
    counts output rows.

    ``kernel_config`` (ops/kernel_config.KernelConfig) picks the
    formulation; by default the kernel pipeline runs on CUDA tensors and
    the plain formulation on CPU tensors.

    ``_internal`` names the packed string-key word columns, which the
    string-key branch passes through the '__' reservation.
    """
    if join_type not in JOIN_TYPES:
        raise ValueError(f"unknown join_type {join_type!r}; expected one "
                         f"of {JOIN_TYPES}")
    cfg = resolve_kernel_config(kernel_config)
    keys = [key] if isinstance(key, str) else list(key)
    check_key_ndim(build, probe, keys)
    if any(build.columns[k].ndim == 2 for k in keys):
        # String keys: packed into word columns, joined as a composite
        # scalar key, and the byte columns rebuilt from the output words.
        b2, p2, keys2, bp, pp, spec = prepare_string_key_join(
            build, probe, keys, build_payload, probe_payload)
        res = sort_merge_inner_join(
            b2, p2, keys2, out_capacity, build_payload=bp, probe_payload=pp,
            kernel_config=kernel_config, join_type=join_type,
            _internal=tuple(nm for _, wns, _ in spec for nm in wns))
        out = patch_string_lengths(
            rebuild_string_keys(res.table, spec, keys), keys, join_type)
        return JoinResult(out, total=res.total, overflow=res.overflow)

    if join_type in ("semi", "anti"):
        if build_payload:
            raise ValueError(
                f"join_type={join_type!r} emits probe rows only; an "
                "explicit build_payload cannot be honored: drop it or use "
                "a left join with the build#valid column")
        build_payload = []
    if build_payload is None:
        build_payload = [c for c in build.column_names if c not in keys]
    if probe_payload is None:
        probe_payload = [c for c in probe.column_names if c not in keys]
    build_payload, probe_payload = list(build_payload), list(probe_payload)
    clash = set(build_payload) & set(probe_payload)
    if clash:
        raise ValueError(f"payload name collision: {sorted(clash)}")
    validity = ([BUILD_VALID] if join_type in ("left", "full_outer")
                else []) + ([PROBE_VALID] if join_type in ("right",
                                                           "full_outer")
                            else [])
    taken = {*keys, *build_payload, *probe_payload}
    if any(nm in taken for nm in validity):
        raise ValueError(f"column(s) {[nm for nm in validity if nm in taken]}"
                         " collide with the outer-join validity columns")
    # Internal lanes (__S, __key{i}, __lo, __flags, __prow, __browidx)
    # share one namespace with the columns; only the packed word names
    # of the string-key branch are exempt.
    reserved = [c for c in (*keys, *build_payload, *probe_payload)
                if c.startswith("__") and c not in _internal]
    if reserved:
        raise ValueError("column names starting with '__' are reserved for "
                         f"internal join lanes: {sorted(set(reserved))}")
    for k in keys:
        bdt, pdt = build.columns[k].dtype, probe.columns[k].dtype
        if bdt != pdt:
            raise TypeError(f"key dtype mismatch: build {bdt} vs probe {pdt}")
    if build.device != probe.device:
        raise ValueError("build and probe live on different devices")
    b1d = [c for c in build_payload if build.columns[c].ndim == 1]
    b2d = [c for c in build_payload if build.columns[c].ndim > 1]
    p1d = [c for c in probe_payload if probe.columns[c].ndim == 1]
    p2d = [c for c in probe_payload if probe.columns[c].ndim > 1]

    if (cfg.kernel_pipeline(build.device)
            and _kernel_path_ok(build, probe, keys, b1d, p1d, out_capacity)):
        out_cols, total, j = _join_kernel_path(
            build, probe, keys, b1d, p1d, out_capacity, b2d, p2d, join_type)
    else:
        out_cols, total, j = _join_plain(
            build, probe, keys, b1d, p1d, out_capacity, b2d, p2d, join_type)
    out_cols = {c: out_cols[c] for c in [*keys, *build_payload,
                                         *probe_payload, *validity]}
    return JoinResult(Table(out_cols, j < total), total=total,
                      overflow=total > out_capacity)
