"""PyTorch port vs the JAX package: the segmented sort on the CPU.

The segment-count and capacity arithmetic, the fine partition, the
segmented shuffle's received blocks and counts, ``runs_from_blocks``,
the batched short-run join, and the join step and the ladder in
segmented mode with the option sets of the JAX package's
``tests/test_sortpath.py``; its refusals; the drivers' ``--sort-mode``
resolution and the join driver's ``--sort-ab`` record. Inputs are made
with numpy from a seed. The JAX package runs on the 8 virtual CPU
devices of tests/conftest.py, the port on ``EmulatedCommunicator(8)``.
Blocks, counts and capacities are compared exactly; join rows as sorted
multisets (row order within a key run is free in both, and the
segmented output is segment-major).
"""

import argparse

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu import benchmarks as jbench
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.ops import segmented as jseg
from distributed_join_tpu.ops.hashing import bucket_ids as jbucket_ids
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.parallel import shuffle as jshuffle
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils.generators import (
    generate_build_probe_tables as jgenerate,
)
from distributed_join_tpu_torch import benchmarks as tbench
from distributed_join_tpu_torch.ops import partition as tpart
from distributed_join_tpu_torch.ops import segmented as tseg
from distributed_join_tpu_torch.ops.hashing import bucket_ids as tbucket_ids
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import shuffle as tshuffle
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
)
from distributed_join_tpu_torch.table import Table

N = 8
LADDER_FIELDS = ("attempt", "action", "overflow", "shuffle_capacity_factor",
                 "out_capacity_factor", "out_rows_per_rank",
                 "compression_bits")
# tests/test_sortpath.py's option sets
SORTPATH_OPTS = [
    dict(sort_segments=4),
    dict(sort_segments=4, shuffle="ppermute"),
    dict(sort_segments=4, over_decomposition=2, shuffle_capacity_factor=3.0),
    dict(sort_segments=3),
    dict(sort_segments=16, shuffle_capacity_factor=4.0),
]


@pytest.fixture(scope="module")
def jc8():
    return jcomm.make_communicator("tpu", n_ranks=N)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int64) if x.dtype == torch.uint64 else x
        return x.numpy()
    return np.asarray(x)


def _jtable(cols, valid):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(valid))


def _ttable(cols, valid):
    return Table.from_numpy(cols, valid, device="cpu")


def _rows(cols, valid, names) -> np.ndarray:
    """Valid rows as a sorted (rows, fields) int64 array (a 2-D column a
    field a byte): a multiset in canonical order."""
    valid = _np(valid).astype(bool)
    parts = []
    for k in names:
        a = _np(cols[k])[valid]
        parts.append(a.reshape(a.shape[0], -1).astype(np.int64))
    a = np.concatenate(parts, axis=1)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def _assert_same_join(got, want, names=None):
    assert bool(got.overflow) == bool(want.overflow)
    assert int(got.total) == int(want.total)
    names = names or sorted(got.table.columns)
    assert names == sorted(want.table.columns)
    np.testing.assert_array_equal(
        _rows(got.table.columns, got.table.valid, names),
        _rows(want.table.columns, want.table.valid, names))


@pytest.fixture(scope="module")
def sortpath_tables():
    """tests/test_sortpath.py's tables: seed 7, 4,096 x 8,192 rows, keys
    in [0, 2000), selectivity 0.5."""
    b, p = jgenerate(seed=7, build_nrows=4096, probe_nrows=8192,
                     rand_max=2000, selectivity=0.5)
    return ({k: np.asarray(v) for k, v in b.columns.items()},
            np.asarray(b.valid),
            {k: np.asarray(v) for k, v in p.columns.items()},
            np.asarray(p.valid))


def _step_both(jc, tables, **opts):
    """The step under spmd in both packages (no ladder), with the JAX
    test's out_capacity_factor of 4."""
    bc, bv, pc, pv = tables
    opts = {"out_capacity_factor": 4.0, **opts}
    want = jc.spmd(jdist.make_join_step(jc, **opts),
                   sharded_out=jdist.JOIN_SHARDED_OUT)(
        *jc.device_put_sharded((_jtable(bc, bv), _jtable(pc, pv))))
    emu = EmulatedCommunicator(N)
    got = emu.spmd(tdist.make_join_step(emu, **opts),
                   sharded_out=tdist.JOIN_SHARDED_OUT)(
        _ttable(bc, bv), _ttable(pc, pv))
    return got, want, emu


# -- the arithmetic ---------------------------------------------------------


@pytest.mark.parametrize("rows", [0, 1, 1000, 4096, 2_500_000, 10_000_000])
def test_capacity_and_resolution_functions_match_jax(rows):
    for n in (1, 2, 4, 8):
        for k in (1, 2, 4):
            for f in (1.0, 1.6, 3.0):
                for s in (1, 3, 4, 128):
                    assert tseg.segment_capacity(rows, n, k, s, f) == \
                        jseg.segment_capacity(rows, n, k, s, f)
                    for orows in (None, 100_000):
                        assert tseg.segmented_out_capacity(
                            rows, k, s, 1.2, orows) == \
                            jseg.segmented_out_capacity(rows, k, s, 1.2,
                                                        orows)
                for sort_segments in (None, 1, 5):
                    assert tseg.resolve_sort_segments(
                        sort_segments, rows, n, k, f) == \
                        jseg.resolve_sort_segments(sort_segments, rows, n,
                                                   k, f)
    for mod in (tseg, jseg):
        with pytest.raises(ValueError, match="sort_segments"):
            mod.resolve_sort_segments(0, rows, 8, 1, 1.6)


def test_config2_shape_resolves_128_segments():
    """Config 2's shape, k = 4: one rank's 10 M rows into 128 fine
    buckets of 31,256 rows (a run under 32,768); four ranks' 10 M each
    into 128 of 7,816 (runs of 31,264)."""
    assert tseg.resolve_sort_segments(None, 10_000_000, 1, 4, 1.6) == 128
    assert tseg.segment_capacity(10_000_000, 1, 4, 128, 1.6) == 31_256
    assert tseg.resolve_sort_segments(None, 10_000_000, 4, 4, 1.6) == 128
    assert 4 * tseg.segment_capacity(10_000_000, 4, 4, 128, 1.6) == 31_264


# -- the fine partition and the shuffle ------------------------------------


@pytest.mark.parametrize("segments", [2, 3, 4, 16])
def test_fine_bucket_ids_and_partition_match_jax(segments):
    rng = np.random.default_rng(segments)
    n = 3000
    cols = {"key": rng.integers(0, 700, n).astype(np.int64),
            "v": rng.integers(0, 99, n)}
    valid = rng.random(n) >= 0.1
    np.testing.assert_array_equal(
        tbucket_ids([torch.from_numpy(cols["key"])], 8,
                    sub_buckets=segments).numpy(),
        np.asarray(jbucket_ids([jnp.asarray(cols["key"])], 8,
                               sub_buckets=segments)))
    want = jpart.radix_hash_partition(_jtable(cols, valid), ["key"], 8,
                                      sub_buckets=segments)
    got = tpart.radix_hash_partition(_ttable(cols, valid), ["key"], 8,
                                     sub_buckets=segments)
    for f in ("order", "offsets", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)


def _seg_inputs(seed=5, rows=4096):
    rng = np.random.default_rng(seed)
    cols = {"key": rng.integers(0, 1500, rows).astype(np.int64),
            "v": rng.integers(-(1 << 40), 1 << 40, rows),
            "s": rng.integers(0, 256, (rows, 6)).astype(np.uint8)}
    return cols, rng.random(rows) >= 0.05


@pytest.mark.parametrize("via", ["all_to_all", "ppermute"])
def test_shuffle_segmented_matches_jax(jc8, via):
    """Received (n_src, segments, seg_cap) blocks under the count mask,
    the (n_src, segments) counts, and the to_padded overflow flag, for
    batch 1 of a k = 2 fine partition (a 2-D column included)."""
    segs, cap, k = 4, 24, 2
    cols, valid = _seg_inputs()
    names = list(cols)

    def step(comm, part, shuffle_segmented):
        def fn(t):
            pt = part.radix_hash_partition(t, ["key"], N * k,
                                           sub_buckets=segs)
            padded, counts, ovf, _ = pt.to_padded(
                cap, bucket_start=N * segs, n_buckets=N * segs)
            rc, rcnt = shuffle_segmented(comm, padded, counts, cap, segs,
                                         via=via)
            return [rc[nm] for nm in names], rcnt, ovf[None]
        return fn

    want = jc8.spmd(step(jc8, jpart, jshuffle.shuffle_segmented))(
        _jtable(cols, valid))
    emu = EmulatedCommunicator(N)
    got = emu.spmd(step(emu, tpart, tshuffle.shuffle_segmented))(
        _ttable(cols, valid))
    counts = _np(got[1])
    np.testing.assert_array_equal(counts, _np(want[1]))
    assert counts.shape == (N * N, segs) and counts.sum() > 0
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    mask = np.arange(cap)[None, None, :] < counts[:, :, None]
    for nm, g, w in zip(names, got[0], want[0]):
        g, w = _np(g), _np(w)
        assert g.shape[:3] == (N * N, segs, cap)
        np.testing.assert_array_equal(g[mask], w[mask], err_msg=nm)
    # the full block rides: 2 * segs * cap rows a destination a rank
    assert emu.wire_rows == N * N * segs * cap
    assert emu.wire_bytes == N * sum(
        np.prod((N * segs * cap,) + c.shape[1:]) * c.itemsize
        for c in cols.values())


def test_runs_from_blocks_matches_jax():
    rng = np.random.default_rng(3)
    n, s, cap = 3, 5, 7
    blocks = {"key": rng.integers(0, 100, (n, s, cap)),
              "w": rng.integers(0, 9, (n, s, cap, 2)).astype(np.int32)}
    counts = rng.integers(0, cap + 1, (n, s)).astype(np.int32)
    want_cols, want_valid = jseg.runs_from_blocks(
        {k: jnp.asarray(v) for k, v in blocks.items()}, jnp.asarray(counts))
    got_cols, got_valid = tseg.runs_from_blocks(
        {k: torch.from_numpy(v) for k, v in blocks.items()},
        torch.from_numpy(counts))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    for k in blocks:
        np.testing.assert_array_equal(got_cols[k].numpy(),
                                      np.asarray(want_cols[k]))


# -- the batched join ---------------------------------------------------


def _batched_case(case):
    """(segments, R_build, R_probe) runs and the per-segment block."""
    rng = np.random.default_rng(len(case))
    s, rb, rp, key_max, out_cap = 6, 40, 64, 30, 96
    if case == "duplicates":
        key_max, out_cap = 4, 1200
    b = {"key": rng.integers(0, key_max, (s, rb)),
         "bp": rng.integers(0, 1 << 20, (s, rb))}
    p = {"key": rng.integers(0, key_max, (s, rp)),
         "pp": rng.integers(0, 1 << 20, (s, rp)).astype(np.int32)}
    bv = rng.random((s, rb)) >= 0.1
    pv = rng.random((s, rp)) >= 0.1
    keys = ["key"]
    if case == "empty_segments":
        bv[1:4] = False
        pv[2:5] = False
    if case == "two_d":
        b["bs"] = rng.integers(0, 256, (s, rb, 5)).astype(np.uint8)
        p["ps"] = rng.integers(0, 256, (s, rp, 3)).astype(np.uint8)
    if case == "composite":
        b["k2"] = rng.integers(0, 3, (s, rb)).astype(np.int32)
        p["k2"] = rng.integers(0, 3, (s, rp)).astype(np.int32)
        keys = ["key", "k2"]
    if case == "overflow_by_one":
        # segment 2: exactly one match more than its block
        out_cap = 32
        bv[2], pv[2] = False, False
        b["key"][2, :1], bv[2, :1] = 7, True
        p["key"][2, :out_cap + 1], pv[2, :out_cap + 1] = 7, True
        p["key"][2, out_cap + 1:] = 1000
    return b, bv, p, pv, keys, out_cap


@pytest.mark.parametrize("case", ["plain", "duplicates", "empty_segments",
                                  "two_d", "composite", "overflow_by_one"])
def test_batched_join_matches_jax(case):
    """Row multiset, total and overflow of the batched join against
    JAX's on the same runs; ``overflow_by_one``: a segment with one
    match more than its block raises the flag in both."""
    b, bv, p, pv, keys, out_cap = _batched_case(case)
    jt, jtot, jovf = jseg.batched_sort_merge_inner_join(
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(bv),
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(pv),
        keys, out_cap)
    tt, ttot, tovf = tseg.batched_sort_merge_inner_join(
        {k: torch.from_numpy(v) for k, v in b.items()}, torch.from_numpy(bv),
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(pv),
        keys, out_cap)
    assert int(ttot) == int(jtot) > 0
    assert bool(tovf) == bool(jovf) == (case == "overflow_by_one")
    assert list(tt.columns) == list(jt.columns)
    names = sorted(tt.columns)
    np.testing.assert_array_equal(_rows(tt.columns, tt.valid, names),
                                  _rows(jt.columns, jt.valid, names))
    if case != "overflow_by_one":
        # and the oracle: every (build, probe) pair of equal keys in a
        # segment
        want = 0
        for i in range(bv.shape[0]):
            bk = [tuple(b[k][i, j] for k in keys)
                  for j in np.flatnonzero(bv[i])]
            pk = [tuple(p[k][i, j] for k in keys)
                  for j in np.flatnonzero(pv[i])]
            want += sum(bk.count(x) for x in pk)
        assert int(ttot) == want


# -- the step and the ladder ------------------------------------------------


@pytest.mark.parametrize("opts", SORTPATH_OPTS)
def test_step_matches_jax(jc8, sortpath_tables, opts):
    """tests/test_sortpath.py's option sets through the step: rows,
    total and the overflow flag. At sort_segments=4 with factor 1.6 one
    build fine bucket of seed 7's tables holds 33 rows against a
    capacity of 32: both packages raise the flag and drop the same
    row."""
    got, want, _ = _step_both(jc8, sortpath_tables, sort_mode="segmented",
                              **opts)
    _assert_same_join(got, want)
    tight = opts.get("shuffle_capacity_factor") is None and \
        opts["sort_segments"] == 4
    assert bool(got.overflow) == tight
    flat, _, _ = _step_both(jc8, sortpath_tables, **{
        k: v for k, v in opts.items() if k != "sort_segments"})
    assert not bool(flat.overflow)
    assert int(got.total) == int(flat.total) - (1 if tight else 0)
    if tight:
        bc, bv, _, _ = sortpath_tables
        fullest = max(int(tpart.radix_hash_partition(
            _ttable({"key": bc["key"][r * 512:(r + 1) * 512]},
                    bv[r * 512:(r + 1) * 512]), ["key"], N,
            sub_buckets=4).counts.max()) for r in range(N))
        assert fullest == 33 and tseg.segment_capacity(
            512, N, 1, 4, 1.6) == 32


@pytest.mark.parametrize("opts", SORTPATH_OPTS[:2])
def test_overflow_recovers_with_the_ladder_like_jax(jc8, sortpath_tables,
                                                    opts):
    bc, bv, pc, pv = sortpath_tables
    kw = dict(sort_mode="segmented", out_capacity_factor=4.0,
              auto_retry=1, **opts)
    want = jdist.distributed_inner_join(_jtable(bc, bv), _jtable(pc, pv),
                                        jc8, **kw)
    got = tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                       EmulatedCommunicator(N), **kw)
    _assert_same_join(got, want)
    assert not bool(got.overflow)
    trail = [{f: getattr(a, f) for f in LADDER_FIELDS}
             for a in got.retry_report.attempts]
    assert trail == [{f: getattr(a, f) for f in LADDER_FIELDS}
                     for a in want.retry_report.attempts]
    assert [a["action"] for a in trail] == ["initial", "double_capacities"]
    assert trail[0]["overflow"] and not trail[1]["overflow"]


def _join_both(jc, bcols, bvalid, pcols, pvalid, **opts):
    want = jdist.distributed_inner_join(_jtable(bcols, bvalid),
                                        _jtable(pcols, pvalid), jc, **opts)
    got = tdist.distributed_inner_join(_ttable(bcols, bvalid),
                                       _ttable(pcols, pvalid),
                                       EmulatedCommunicator(N), **opts)
    _assert_same_join(got, want)
    assert not bool(got.overflow) and int(got.total) > 0
    return got, want


def _gen(seed, bn, pn, rand_max, sel, **kw):
    b, p = jgenerate(seed=seed, build_nrows=bn, probe_nrows=pn,
                     rand_max=rand_max, selectivity=sel, **kw)
    return ({k: np.asarray(v) for k, v in b.columns.items()},
            np.asarray(b.valid),
            {k: np.asarray(v) for k, v in p.columns.items()},
            np.asarray(p.valid))


def test_duplicate_heavy_keys_match_jax(jc8):
    _join_both(jc8, *_gen(11, 2048, 4096, 64, 0.8), sort_mode="segmented",
               sort_segments=4, shuffle_capacity_factor=6.0,
               out_capacity_factor=200.0)


def test_skew_sidecar_matches_jax(jc8, sortpath_tables):
    _join_both(jc8, *sortpath_tables, sort_mode="segmented",
               sort_segments=4, skew_threshold=0.01, auto_retry=1,
               out_capacity_factor=4.0)


def test_string_key_matches_jax(jc8):
    """A 12-byte string key (packed into word columns before hashing)
    with a 2-D string payload on the probe side, through the
    segmented path."""
    rng = np.random.default_rng(9)
    bn, pn = 1024, 2048

    def key_bytes(ids):
        txt = np.zeros((len(ids), 12), np.uint8)
        for i, v in enumerate(ids):
            s = f"itm-{v:06d}".encode()
            txt[i, :len(s)] = np.frombuffer(s, np.uint8)
        return txt, np.full(len(ids), 10, np.int32)

    bcols, pcols = {"bv": rng.integers(0, 99, bn)}, {}
    bcols["sk"], bcols["sk#len"] = key_bytes(rng.integers(0, 400, bn))
    pcols["sk"], pcols["sk#len"] = key_bytes(rng.integers(0, 400, pn))
    pcols["ps"] = rng.integers(1, 256, (pn, 8)).astype(np.uint8)
    _join_both(jc8, bcols, np.ones(bn, bool), pcols, np.ones(pn, bool),
               key="sk", sort_mode="segmented", sort_segments=4,
               shuffle_capacity_factor=3.0, out_capacity_factor=6.0)


def test_empty_segments_match_jax(jc8):
    """16 distinct keys into 8 ranks x 8 segments: most fine buckets are
    empty on every source."""
    _join_both(jc8, *_gen(3, 1024, 1024, 16, 1.0), sort_mode="segmented",
               sort_segments=8, shuffle_capacity_factor=40.0,
               out_capacity_factor=1600.0)


def test_one_segment_is_the_flat_path(sortpath_tables):
    """sort_segments=1, and a one-bucket mesh, run the flat program: the
    same rows in the same order, and the same wire."""
    bc, bv, pc, pv = sortpath_tables
    outs = []
    for opts in ({}, dict(sort_mode="segmented", sort_segments=1)):
        emu = EmulatedCommunicator(N)
        res = tdist.distributed_inner_join(
            _ttable(bc, bv), _ttable(pc, pv), emu, out_capacity_factor=4.0,
            **opts)
        outs.append((res, emu.counters()))
    (flat, fc), (seg, sc) = outs
    assert fc == sc
    for k in flat.table.columns:
        assert torch.equal(flat.table.columns[k], seg.table.columns[k])
    assert torch.equal(flat.table.valid, seg.table.valid)
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    one = [tdist.distributed_inner_join(_ttable(bc, bv), _ttable(pc, pv),
                                        LocalCommunicator(), **opts)
           for opts in ({}, dict(sort_mode="segmented"))]
    assert torch.equal(one[0].table.columns["key"],
                       one[1].table.columns["key"])


# -- refusals -----------------------------------------------------------


@pytest.mark.parametrize("opts,match", [
    (dict(sort_mode="bogus"), "sort_mode"),
    (dict(sort_mode="segmented", sort_segments=0), "sort_segments"),
    (dict(sort_segments=4), "sort_segments applies"),
    (dict(sort_mode="segmented", shuffle="ragged"), "static"),
    (dict(sort_mode="segmented", compression_bits=16), "codec"),
    (dict(sort_mode="segmented", join_type="left"), "segmented"),
])
def test_refusals_match_jax(jc8, opts, match):
    with pytest.raises(ValueError, match=match):
        tdist.make_join_step(EmulatedCommunicator(N), **opts)
    with pytest.raises(ValueError, match=match):
        jdist.make_join_step(jc8, **opts)


def test_kernel_config_and_dcn_codec_refusals_match_jax(jc8):
    with pytest.raises(ValueError, match="kernel_config"):
        tdist.make_join_step(EmulatedCommunicator(N), sort_mode="segmented",
                             kernel_config=KernelConfig("plain"))
    jh = jcomm.HierarchicalTpuCommunicator(n_slices=2, n_ranks=N)
    for comm in (EmulatedCommunicator(N, n_slices=2), jh):
        mod = tdist if isinstance(comm, EmulatedCommunicator) else jdist
        with pytest.raises(ValueError, match="DCN codec"):
            mod.make_join_step(comm, sort_mode="segmented",
                               shuffle="hierarchical", dcn_codec="on")
        # the codec off: segments ride the hierarchical route
        mod.make_join_step(comm, sort_mode="segmented",
                           shuffle="hierarchical", dcn_codec="off")
    # aggregate pushdown refuses the segmented sort, in the JAX
    # package's words
    from distributed_join_tpu.ops import aggregate as jagg
    from distributed_join_tpu_torch.ops import aggregate as tagg
    msgs = []
    for mod, agg, comm in ((jdist, jagg, jc8),
                           (tdist, tagg, EmulatedCommunicator(N))):
        with pytest.raises(agg.AggregatePushdownUnsupported,
                           match="segmented") as exc:
            mod.make_join_step(comm, sort_mode="segmented",
                               aggregate=agg.AggregateSpec.of(
                                   "key", [("count", None)]))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# -- the drivers ----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(mode=None), dict(mode="flat"), dict(mode="segmented"),
    dict(mode="auto"), dict(mode="auto", rows=4096),
    dict(mode="auto", shuffle="ragged"),
    dict(mode="auto", bits=16), dict(mode="auto", n=1, k=1),
    dict(mode="auto", segments=1), dict(mode="auto", segments=8, rows=4096),
    dict(mode="auto", shuffle="hierarchical", slices=2, codec="off"),
])
def test_resolve_sort_mode_matches_jax(kw):
    args = argparse.Namespace(sort_mode=kw["mode"],
                              sort_segments=kw.get("segments"))
    a = (args, kw.get("n", 8), kw.get("k", 2), kw.get("rows", 2_500_000),
         kw.get("rows", 2_500_000), 1.6, kw.get("shuffle", "padded"))
    opts = dict(n_slices=kw.get("slices", 1),
                dcn_codec=kw.get("codec", "auto"),
                compression_bits=kw.get("bits"))
    assert tbench.resolve_sort_mode(*a, **opts) == \
        jbench.resolve_sort_mode(*a, **opts)


def test_hierarchical_codec_on_resolves_flat_like_jax():
    args = argparse.Namespace(sort_mode="auto", sort_segments=None)
    a = (args, 8, 1, 2_500_000, 2_500_000, 1.6, "hierarchical")
    assert tbench.resolve_sort_mode(*a, n_slices=2, dcn_codec="on") == \
        jbench.resolve_sort_mode(*a, n_slices=2, dcn_codec="on") == "flat"
    # auto resolves by each package's cost model: both put the codec on
    # the tier across slices (the H100's 50 GB/s below its 95 GB/s
    # break-even; the TPU's 3 GB/s below 7), so both stay flat
    assert tbench.resolve_sort_mode(*a, n_slices=2, dcn_codec="auto") == \
        jbench.resolve_sort_mode(*a, n_slices=2, dcn_codec="auto") == "flat"


SORT_AB_BASE = ["--communicator", "emulated", "--n-ranks", "4",
                "--build-table-nrows", "40000", "--probe-table-nrows",
                "40000", "--iterations", "1", "--over-decomposition-factor",
                "2"]


def test_driver_sort_ab_record_on_emulated_ranks():
    """The join driver in segmented mode with --sort-ab: its record's
    sort fields normalized as the JAX driver's, the A/B graded (totals,
    digests, the pandas oracle on emulated ranks) with min and median
    times of each mode; its counter signature from one segmented join
    with the tape, whose wire bytes equal the segmented plan's."""
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    rec = tdriver.run(tdriver.parse_args(
        [*SORT_AB_BASE, "--sort-mode", "segmented", "--sort-segments", "4",
         "--sort-ab", "2"]), device="cpu")
    assert rec["sort_mode"] == "segmented" and rec["sort_segments"] == 4
    assert not rec["overflow"] and rec["matches_per_join"] > 0
    ab = rec["sort_ab"]
    assert ab["sort_segments"] == 4 and ab["n_joins"] == 2
    assert ab["matches"] == rec["matches_per_join"]
    for f in ("matches_equal", "digest_equal", "oracle_equal_flat",
              "oracle_equal_segmented"):
        assert ab[f] is True, f
    assert len(ab["flat_ms"]) == len(ab["segmented_ms"]) == 2
    assert ab["flat_ms_min"] <= ab["flat_ms_median"]
    # both modes' programs come from one cache: the warm joins build none
    assert ab["warm_new_traces"] == 0
    assert "not_ported" not in ab
    assert ab["wire_exact"] is True
    counters = ab["counter_signature"]["counters"]
    assert counters["matches"] == rec["matches_per_join"]
    assert counters["sort_segments"] == 4 * rec["n_ranks"]
    flat = tdriver.run(tdriver.parse_args(
        [*SORT_AB_BASE, "--sort-segments", "4"]), device="cpu")
    # a bare --sort-segments leaves the flat run as it is
    assert flat["sort_mode"] is None and flat["sort_segments"] is None
    assert flat["matches_per_join"] == rec["matches_per_join"]


@pytest.mark.parametrize("extra,reason", [
    (["--shuffle", "ragged"], "ragged"),
    (["--compression"], "compressed"),
    (["--over-decomposition-factor", "1", "--n-ranks", "1"],
     "single-bucket"),
    (["--sort-segments", "1"], "segment resolution is 1"),
], ids=["ragged", "compressed", "single_bucket", "one_segment"])
def test_driver_sort_ab_skips_with_jax_reasons(extra, reason):
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    argv = [*SORT_AB_BASE, "--sort-ab", "1", *extra]
    rec = tdriver.run(tdriver.parse_args(argv), device="cpu")
    assert reason in rec["sort_ab"]["skipped"]


def test_driver_sort_ab_skips_an_overflowing_sizing():
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as tdriver,
    )
    rec = tdriver.run(tdriver.parse_args(
        [*SORT_AB_BASE, "--sort-ab", "1", "--sort-segments", "4",
         "--out-capacity-factor", "0.2"]), device="cpu")
    ab = rec["sort_ab"]
    assert "overflow" in ab["skipped"]
    assert ab["overflow_flat"] and ab["overflow_segmented"]


def test_bench_sort_mode_flags():
    """bench.py's --sort-mode: the headline is one bucket, so every mode
    runs the flat program; the record says which mode was asked."""
    from distributed_join_tpu_torch import bench
    flat = bench.run(nrows=20_000, iters=1, device="cpu")
    seg = bench.run(nrows=20_000, iters=1, device="cpu",
                    sort_mode="segmented", sort_segments=4)
    auto = bench.run(nrows=20_000, iters=1, device="cpu", sort_mode="auto")
    assert flat["sort_mode"] is None and auto["sort_mode"] is None
    assert seg["sort_mode"] == "segmented" and seg["sort_segments"] == 4
    assert flat["matches_per_join"] == seg["matches_per_join"] \
        == auto["matches_per_join"] > 0
