"""PyTorch port vs the JAX package: the fused-scan and stream-compaction
kernel contracts of the join, bit for bit on the CPU. The JAX kernels
run under the Pallas interpreter as their own tests run them; the
port's wrappers take their plain twins on CPU tensors. Compaction
outputs are compared over the prefix their contract defines, and every
call site of the compaction is held to the ``pos == cumsum(mask) - 1``
contract that its kernel relies on."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import compact_pallas as jcp
from distributed_join_tpu.ops import compact_planes as jpl
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.ops import scan_pallas as jsc
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import compact as tcp
from distributed_join_tpu_torch.ops import join as tjoin
from distributed_join_tpu_torch.ops import scan as tsc
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import skew as tskew
from distributed_join_tpu_torch.table import Table


def _i64(a) -> torch.Tensor:
    """A uint64 numpy/JAX array as the int64 tensor with the same bits."""
    return torch.from_numpy(np.asarray(a).view(np.int64).copy())


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# -- fused scans --------------------------------------------------------


def _random_merged(rng, n_keys, max_b, max_p, pad=0):
    """A merged-sorted domain: per key, b builds then p probes; plus a
    padding tail (tag 2)."""
    tags, firsts = [], []
    for _ in range(n_keys):
        b = int(rng.integers(0, max_b + 1))
        p = int(rng.integers(0, max_p + 1))
        if b + p == 0:
            b = 1
        tags.extend([0] * b + [1] * p)
        firsts.extend([1] + [0] * (b + p - 1))
    if pad:
        tags.extend([2] * pad)
        firsts.extend([1] + [0] * (pad - 1))
    return np.array(tags, np.int8), np.array(firsts, bool)


@pytest.mark.parametrize("n_keys,max_b,max_p,pad,seed", [
    (40, 3, 3, 0, 0),
    (200, 5, 2, 37, 1),
    (1000, 2, 4, 0, 2),
    (17, 0, 6, 5, 3),
    (60, 6, 0, 0, 4),
])
def test_join_scans_match_jax_kernel(n_keys, max_b, max_p, pad, seed):
    rng = np.random.default_rng(seed)
    tag, first = _random_merged(rng, n_keys, max_b, max_p, pad)
    want = jsc.join_scans(jnp.asarray(tag), jnp.asarray(first),
                          interpret=True)
    got = tsc.join_scans(torch.from_numpy(tag), torch.from_numpy(first))
    assert set(got) == set(want) == set(tsc.NAMES)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("n,p_first,seed", [
    (1, 0.5, 0), (2049, 0.05, 1), (70000, 0.001, 2), (70000, 0.3, 3)])
def test_join_scans_reference_on_arbitrary_tags(n, p_first, seed):
    """Tags in any order and runs that span many kernel tiles (long
    runs, first[0] False): the plain twin against the JAX reference."""
    rng = np.random.default_rng(seed)
    tag = rng.integers(0, 3, n).astype(np.int8)
    first = rng.random(n) < p_first
    want = jsc.join_scans_reference(jnp.asarray(tag), jnp.asarray(first))
    got = tsc.join_scans_reference(torch.from_numpy(tag),
                                   torch.from_numpy(first))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# -- stream compaction --------------------------------------------------


def _compact_case(rng, n, density, capacity, k):
    mask = rng.random(n) < density
    pos = (np.cumsum(mask) - 1).astype(np.int32)
    cols = [rng.integers(0, 1 << 64, size=(n,), dtype=np.uint64)
            for _ in range(k)]
    return mask, pos, cols, int(min(mask.sum(), capacity))


@pytest.mark.parametrize("n,density,capacity,route", [
    (5000, 0.3, 4096, "mxu"),
    (5000, 1.0, 8192, "mxu"),
    (5000, 0.0, 1024, "mxu"),
    (5000, 0.7, 1000, "mxu"),      # capacity truncation mid-stream
    (257, 0.5, 256, "mxu"),
    (4096, 0.01, 512, "mxu"),
    (5000, 0.7, 1000, "plane"),    # the plane kernel is slow to interpret
    (257, 0.5, 256, "plane"),
    (4096, 0.01, 512, "plane"),
])
def test_stream_compact_matches_jax_kernels(n, density, capacity, route):
    rng = np.random.default_rng(n + int(density * 100) + capacity)
    mask, pos, cols, total = _compact_case(rng, n, density, capacity, k=2)
    jargs = (jnp.asarray(mask), jnp.asarray(pos),
             [jnp.asarray(c) for c in cols], capacity)
    if route == "mxu":
        want = jcp.stream_compact(*jargs, block=256, interpret=True)
    else:
        want = jpl.plane_stream_compact(*jargs, block=4096, interpret=True)
    got = tcp.stream_compact(torch.from_numpy(mask), torch.from_numpy(pos),
                             [_i64(c) for c in cols], capacity)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (capacity,) and g.dtype == torch.int64
        np.testing.assert_array_equal(_u64(g)[:total], np.asarray(w)[:total])


def test_stream_compact_join_widths():
    """The join's two call shapes: four record lanes, one pack lane."""
    rng = np.random.default_rng(8)
    for k, capacity in ((4, 600), (1, 3000)):
        mask, pos, cols, total = _compact_case(rng, 3000, 0.4, capacity, k)
        want = jcp.stream_compact_reference(
            jnp.asarray(mask), jnp.asarray(pos),
            [jnp.asarray(c) for c in cols], capacity)
        got = tcp.stream_compact(torch.from_numpy(mask),
                                 torch.from_numpy(pos),
                                 [_i64(c) for c in cols], capacity)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u64(g)[:total],
                                          np.asarray(w)[:total])


# -- the compaction's position contract at its call sites ---------------


def _assert_cumsum_positions(mask, pos):
    """pos[mask] == (cumsum(mask) - 1)[mask]: the survivors' slots are
    consecutive from 0, which the compaction kernel relies on."""
    m = mask.bool()
    want = torch.cumsum(m.to(torch.int64), 0) - 1
    assert int(m.sum()) > 0
    np.testing.assert_array_equal(pos[m].long().numpy(), want[m].numpy())


def _recording(monkeypatch, module, calls):
    real = module.stream_compact

    def record(mask, pos, cols, capacity, launch_counter=None):
        calls.append((launch_counter, mask, pos))
        return real(mask, pos, cols, capacity, launch_counter=launch_counter)
    monkeypatch.setattr(module, "stream_compact", record)


@pytest.mark.parametrize("nb,npr,key_max,b_invalid,p_invalid,out_cap", [
    (300, 400, 40, 0.2, 0.1, 4096),   # duplicate keys, padding rows
    (256, 256, 8, 0.1, 0.25, 512),    # the output overflows
    (500, 200, 300, 0.5, 0.0, 1024),  # sparse matches, half the builds pad
])
def test_join_compaction_sites_get_cumsum_positions(
        monkeypatch, nb, npr, key_max, b_invalid, p_invalid, out_cap):
    """The join's two compaction sites (run records, matched-build pack)
    on reference-built tables: the scans that make their positions equal
    the JAX package's on the same tags, and each site's pos is exactly
    cumsum(mask) - 1 over its survivors."""
    rng = np.random.default_rng(nb + npr + key_max)
    cols = {}
    for side, n in (("build", nb), ("probe", npr)):
        cols[side] = ({"key": rng.integers(0, key_max, n),
                       f"{side}_payload": rng.integers(-(1 << 40), 1 << 40,
                                                       n)},
                      rng.random(n) >= (b_invalid if side == "build"
                                        else p_invalid))
    scans, calls = [], []
    real_scans = tjoin.join_scans

    def record_scans(tag, first):
        out = real_scans(tag, first)
        scans.append((tag, first, out))
        return out
    monkeypatch.setattr(tjoin, "join_scans", record_scans)
    _recording(monkeypatch, tjoin, calls)
    got = tjoin.sort_merge_inner_join(
        *[Table.from_numpy(c, v, device="cpu") for c, v in
          (cols["build"], cols["probe"])], "key", out_cap,
        kernel_config=KernelConfig("kernel"))
    want = jjoin.sort_merge_inner_join(
        *[JTable({k: jnp.asarray(a) for k, a in c.items()}, jnp.asarray(v))
          for c, v in (cols["build"], cols["probe"])], "key", out_cap)
    assert int(got.total) == int(want.total) > 0
    assert bool(got.overflow) == bool(want.overflow) == (
        int(want.total) > out_cap)

    (tag, first, sc), = scans
    assert bool((tag == 2).any()) and bool((~first).any())
    jsc_ref = jsc.join_scans_reference(jnp.asarray(tag.numpy()),
                                       jnp.asarray(first.numpy()))
    for k in tsc.NAMES:
        np.testing.assert_array_equal(sc[k].numpy(), np.asarray(jsc_ref[k]),
                                      err_msg=k)
    sites = {counter: (mask, pos) for counter, mask, pos in calls}
    assert set(sites) == {tjoin.compact_records, tjoin.pack_matched_builds}
    mask, pos = sites[tjoin.compact_records]
    assert torch.equal(mask, (tag == 1) & (sc["cnt"] > 0))
    assert torch.equal(pos, sc["rec_pos"])
    _assert_cumsum_positions(mask, pos)
    mask, pos = sites[tjoin.pack_matched_builds]
    assert torch.equal(mask, sc["matched"] != 0)
    assert torch.equal(pos, sc["mb_pos"])
    _assert_cumsum_positions(mask, pos)


@pytest.mark.parametrize("n,density,capacity", [
    (5000, 0.05, 1024), (5000, 0.3, 600)])
def test_skew_compaction_site_gets_cumsum_positions(monkeypatch, n, density,
                                                    capacity):
    """extract_prefix's kernel branch (n >= 2 * capacity) on a table with
    padding rows, fitting and overflowing: its pos is cumsum(sel) - 1."""
    rng = np.random.default_rng(n + capacity)
    valid = rng.random(n) >= 0.2
    t = Table.from_numpy({"key": rng.integers(0, 100, n),
                          "v": np.arange(n)}, valid, device="cpu")
    sel = torch.from_numpy((rng.random(n) < density) & valid)
    calls = []
    _recording(monkeypatch, tskew, calls)
    out, count, overflow = tskew.extract_prefix(
        t, sel, capacity, kernel_config=KernelConfig("kernel"))
    assert bool(overflow) == (int(sel.sum()) > capacity) == (density > 0.1)
    (counter, mask, pos), = calls
    assert counter is tskew.extract_prefix and torch.equal(mask, sel)
    _assert_cumsum_positions(mask, pos)
    kept = min(int(count), capacity)
    np.testing.assert_array_equal(out.columns["v"][:kept].numpy(),
                                  np.flatnonzero(sel.numpy())[:kept])
