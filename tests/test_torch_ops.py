"""PyTorch port vs the JAX package: lanes, hashing and the radix
partition, bit for bit on the CPU. Inputs come from numpy seeds and
reach both packages as numpy arrays."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import hashing as jh
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.ops import partition as jpart
from distributed_join_tpu.ops import sort_pallas as jsort
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import hashing as th
from distributed_join_tpu_torch.ops import lanes as tl
from distributed_join_tpu_torch.ops import partition as tpart
from distributed_join_tpu_torch.table import Table


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _keys(rng, dtype, n=4099):
    if dtype == np.float64:
        # The f64 hash decomposes a = m * 2^e with log2/exp2. XLA's CPU
        # exp2 is an approximation (exp2(13.0) != 8192.0 exactly), so the
        # JAX bits match exact arithmetic only where exp2 is exact:
        # integer keys of magnitude below 8 here; the port's exact
        # decomposition is checked over wide keys against numpy below.
        return rng.integers(-7, 8, n).astype(np.float64)
    if dtype == np.float32:
        return (rng.standard_normal(n) * 1e6).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int16, np.int8,
                                   np.uint8, np.float32, np.float64])
def test_hash_columns_bit_exact(dtype):
    rng = np.random.default_rng(11)
    k = _keys(rng, dtype)
    want = np.asarray(jh.hash_columns([jnp.asarray(k)]))
    got = _u64(th.hash_columns([torch.from_numpy(k)]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float32,
                                   np.float64])
@pytest.mark.parametrize("n_buckets,sub_buckets", [
    (1, 1), (8, 1), (7, 1), (1000003, 1), (8, 4), (3, 5), (1, 6)])
def test_bucket_ids_bit_exact(dtype, n_buckets, sub_buckets):
    rng = np.random.default_rng(n_buckets * 10 + sub_buckets)
    k = _keys(rng, dtype)
    want = np.asarray(jh.bucket_ids([jnp.asarray(k)], n_buckets,
                                    sub_buckets=sub_buckets))
    got = th.bucket_ids([torch.from_numpy(k)], n_buckets,
                        sub_buckets=sub_buckets).numpy()
    np.testing.assert_array_equal(got, want)


def test_composite_key_hash_bit_exact():
    rng = np.random.default_rng(3)
    cols = [_keys(rng, np.int64), _keys(rng, np.int32), _keys(rng, np.float32)]
    want = np.asarray(jh.bucket_ids([jnp.asarray(c) for c in cols], 16))
    got = th.bucket_ids([torch.from_numpy(c) for c in cols], 16).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int16, np.int8,
                                   np.uint8, np.float32])
def test_u64_lanes_bit_exact(dtype):
    rng = np.random.default_rng(5)
    c = _keys(rng, dtype, 513)
    want = np.asarray(jjoin._to_u64_lane(jnp.asarray(c)))
    lane = tl.to_u64_lane(torch.from_numpy(c))
    np.testing.assert_array_equal(_u64(lane), want)
    back = tl.from_u64_lane(lane, torch.from_numpy(c).dtype).numpy()
    np.testing.assert_array_equal(back.view(np.uint8), c.view(np.uint8))
    hi, lo = tl.split_u64(lane)
    jhi, jlo = jsort.split_u64(jnp.asarray(want))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    np.testing.assert_array_equal(_u64(tl.merge_u64(hi, lo)), want)


@pytest.mark.parametrize("n,n_buckets,invalid_frac", [
    (1000, 8, 0.0), (4096, 8, 0.3), (777, 5, 0.9), (64, 16, 1.0)])
def test_partition_bit_exact(n, n_buckets, invalid_frac):
    rng = np.random.default_rng(n)
    cols = {"key": rng.integers(0, 200, n).astype(np.int64),
            "pay": rng.integers(-50, 50, n).astype(np.int64)}
    valid = rng.random(n) >= invalid_frac
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()},
                jnp.asarray(valid))
    tt = Table.from_numpy(cols, valid, device="cpu")
    jp = jpart.radix_hash_partition(jt, ["key"], n_buckets)
    tp = tpart.radix_hash_partition(tt, ["key"], n_buckets)
    for name in ("order", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    cap = max(n // n_buckets, 8)
    jpad, jcnt, jovf, jrv = jp.to_padded(cap, bucket_start=2,
                                         n_buckets=n_buckets - 2)
    tpad, tcnt, tovf, trv = tp.to_padded(cap, bucket_start=2,
                                         n_buckets=n_buckets - 2)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert bool(tovf) == bool(jovf)
    np.testing.assert_array_equal(trv.numpy(), np.asarray(jrv))
    for name in cols:
        np.testing.assert_array_equal(tpad[name].numpy(),
                                      np.asarray(jpad[name]))
    back = tpart.unpad(tpad, tcnt, cap)
    jback = jpart.unpad(jpad, jcnt, cap)
    np.testing.assert_array_equal(back.valid.numpy(), np.asarray(jback.valid))


def test_partition_refuses_order_within():
    """order_within is refused where the JAX package refuses it: with
    sub_buckets > 1, and on a column that is not 1-D integer."""
    t = Table.from_numpy({"key": np.arange(8), "f": np.ones(8)},
                         np.ones(8, bool), device="cpu")
    with pytest.raises(ValueError, match="order_within"):
        tpart.radix_hash_partition(t, ["key"], 2, order_within="key",
                                   sub_buckets=2)
    with pytest.raises(TypeError, match="order_within"):
        tpart.radix_hash_partition(t, ["key"], 2, order_within="f")


def test_f64_hash_is_the_exact_decomposition():
    """Integer-valued f64 keys below 2^24 against the decomposition in
    exact numpy arithmetic (frexp/ldexp): floor(log2) and the mantissa
    capture agree, so equal keys land in one bucket on any device."""
    rng = np.random.default_rng(17)
    k = rng.integers(-(1 << 24), 1 << 24, 4099).astype(np.float64)
    a = np.abs(k)
    mant, exp = np.frexp(a)                 # a = mant * 2^exp, mant in [.5, 1)
    e = np.where(a > 0, exp - 1, 0)
    m = np.where(a > 0, mant * 2.0, 0.0)
    mi = torch.from_numpy((m * 2.0 ** 52).astype(np.int64))
    eb = torch.from_numpy(e.astype(np.int32) ^ ((k < 0).astype(np.int32) << 30))
    want = th.hash_combine(th.fmix64(mi), th.fmix32(eb))
    got = th.hash_columns([torch.from_numpy(k)])
    np.testing.assert_array_equal(_u64(got), _u64(want))
