"""PyTorch port vs the JAX package: the expand-gather kernel contract
(record mode and build mode), bit for bit on the CPU. The JAX kernels
run under the Pallas interpreter as their own tests run them; the
port's wrappers take their plain twins on CPU tensors. Outputs are
compared over the prefix the contract defines."""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import expand_pallas as jex
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu_torch.ops import expand as tex

I32_MAX = 2**31 - 1


def _i64(a) -> torch.Tensor:
    """A uint64 numpy/JAX array as the int64 tensor with the same bits."""
    return torch.from_numpy(np.asarray(a).view(np.int64).copy())


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# -- expand-gather ------------------------------------------------------


def _make_records(rng, n_records, k):
    lens = rng.integers(1, 7, size=n_records)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    total = int(np.cumsum(lens)[-1])
    m = n_records + 13
    S = np.full((m,), I32_MAX, np.int32)
    S[:n_records] = starts
    cols = [rng.integers(0, 1 << 63, size=(m,), dtype=np.uint64)
            for _ in range(k)]
    return S, cols, total


@pytest.mark.parametrize("n_records,out_cap,k", [
    (50, 256, 1),
    (200, 1024, 3),
    (1000, 2048, 2),
])
def test_expand_record_mode_matches_jax_kernel(n_records, out_cap, k):
    rng = np.random.default_rng(n_records)
    S, cols, total = _make_records(rng, n_records, k)
    total = min(total, out_cap)
    want, want_sb = jex.expand_gather(
        jnp.asarray(S), [jnp.asarray(c) for c in cols], out_cap, block=128,
        interpret=True)
    got, got_sb = tex.expand_gather(torch.from_numpy(S),
                                    [_i64(c) for c in cols], out_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u64(g)[:total], np.asarray(w)[:total])
    assert got_sb.dtype == torch.int32
    np.testing.assert_array_equal(got_sb.numpy()[:total],
                                  np.asarray(want_sb)[:total])


def _make_join_records(rng, key_specs, kb=2):
    """Records as the join makes them: per key with c builds and p
    probes, p records of run length c sharing lo; p == 0 keys advance lo
    without records (unmatched-build gaps)."""
    S_list, lo_list = [], []
    lo = 0
    slot = 0
    for c, p in key_specs:
        for _ in range(p):
            S_list.append(slot)
            lo_list.append(lo)
            slot += c
        lo += c
    nb = max(lo, 1)
    m = len(S_list) + 7
    S = np.full((m,), I32_MAX, np.int32)
    S[:len(S_list)] = S_list
    lo_arr = np.zeros((m,), np.int32)
    lo_arr[:len(lo_list)] = lo_list
    cols = [rng.integers(0, 1 << 63, size=(m,), dtype=np.uint64)]
    bcols = [rng.integers(0, 1 << 63, size=(nb,), dtype=np.uint64)
             for _ in range(kb)]
    return S, lo_arr, cols, bcols, slot


def _port_build_mode(S, lo, cols, bcols, out_cap):
    return tex.expand_gather(torch.from_numpy(S), [_i64(c) for c in cols],
                             out_cap, lo=torch.from_numpy(lo),
                             build_cols=[_i64(b) for b in bcols])


@pytest.mark.parametrize("key_specs,block", [
    ([(2, 3)] * 40 + [(1, 1)] * 30, 256),
    ([(3, 2)] * 10, 256),
    ([(700, 2), (1, 5), (300, 3), (2, 2)], 256),
    ([(256, 1), (256, 2), (1, 7)], 256),
    ([(2000, 1)], 256),
    ([(2, 2), (2, 0), (2, 2)] * 15, 256),
    ([(5, 3)] * 20 + [(70, 2)], 64),
])
def test_expand_build_mode_matches_jax_kernel(key_specs, block):
    """Matched-rank data: the JAX build-mode kernel's window bound holds,
    and the port's single kernel contract equals it."""
    rng = np.random.default_rng(zlib.crc32(str(key_specs).encode()))
    S, lo, cols, bcols, total = _make_join_records(rng, key_specs)
    out_cap = total
    jS, jlo = jnp.asarray(S), jnp.asarray(lo)
    assert bool(jex.build_windows_ok(jS, jlo, out_cap, block=block))
    w_rec, _sb, _rank, w_bld = jex.expand_gather(
        jS, [jnp.asarray(c) for c in cols], out_cap, block=block,
        interpret=True, lo=jlo, build_cols=[jnp.asarray(b) for b in bcols])
    g_rec, g_bld = _port_build_mode(S, lo, cols, bcols, out_cap)
    for g, w in zip(g_rec + g_bld, list(w_rec) + list(w_bld)):
        np.testing.assert_array_equal(_u64(g)[:total], np.asarray(w)[:total])


@pytest.mark.parametrize("key_specs,out_cap", [
    ([(1, 1), (1, 1), (5000, 0), (1, 1)], 8),
    ([(3, 2), (400, 0), (2, 3), (900, 0), (1, 4)] * 3, None),
    ([(5, 3)] * 50 + [(900, 1), (2, 4)] * 3, 700),   # truncated output
])
def test_expand_build_mode_on_gap_data_matches_jax_fallback(key_specs,
                                                            out_cap):
    """Gap data (large unmatched build runs between matched ones) fails
    the JAX kernel's window bound; the JAX join then takes its fallback
    branch (record expand + clipped rank gather). The port's build mode,
    which has no window bound, equals that branch."""
    rng = np.random.default_rng(zlib.crc32(str(key_specs).encode()))
    S, lo, cols, bcols, total = _make_join_records(rng, key_specs)
    if out_cap is None:
        out_cap = total
    if out_cap < total:
        keep = np.arange(S.shape[0]) < int((S < out_cap).sum())
        S = np.where(keep, S, I32_MAX).astype(np.int32)
        lo = np.where(keep, lo, 0).astype(np.int32)
    total = min(total, out_cap)
    jS, jlo = jnp.asarray(S), jnp.asarray(lo)
    nb = bcols[0].shape[0]
    if out_cap == 8:
        assert not bool(jex.build_windows_ok(jS, jlo, out_cap, block=256))
    # the fallback branch of the JAX join's kernel path, spelled out
    lo_lane = jjoin._to_u64_lane(jlo)
    outs2, sb2 = jex.expand_gather(
        jS, [jnp.asarray(c) for c in cols] + [lo_lane], out_cap, block=64,
        interpret=True)
    j = jnp.arange(out_cap, dtype=jnp.int32)
    rank2 = outs2[-1].astype(jnp.int32) + (j - sb2)
    safe = jnp.clip(rank2, 0, max(nb - 1, 0))
    w_bld = jjoin._chunked_rank_gather([jnp.asarray(b) for b in bcols], safe)
    g_rec, g_bld = _port_build_mode(S, lo, cols, bcols, out_cap)
    for g, w in zip(g_rec + g_bld, list(outs2[:-1]) + list(w_bld)):
        np.testing.assert_array_equal(_u64(g)[:total], np.asarray(w)[:total])


def test_expand_without_records():
    S = torch.full((16,), I32_MAX, dtype=torch.int32)
    out, sb = tex.expand_gather(S, [torch.zeros(16, dtype=torch.int64)], 64)
    assert out[0].shape == (64,) and sb.shape == (64,)


def test_expand_build_mode_needs_lo_and_lanes():
    S = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="build mode"):
        tex.expand_gather(S, [], 8, build_cols=[torch.zeros(3,
                                                            dtype=torch.int64)])
