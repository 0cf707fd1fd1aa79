"""The join's dispatch around its one size limit, on the CPU.

The kernel pipeline takes every merged domain ``nb + npr < 2^31 - 2``
(and an output block below the same bound), as the JAX package's
``_kernel_path_ok`` does: the CUDA scan's status words count positions
in 31 bits, so nothing below that limit sends a join elsewhere. The
gate is checked at the limit on zero-stride tables (no data), held
against the JAX package's gate; and a small join with the kernel
pipeline asked for runs the pipeline through the kernels' plain twins,
never the plain formulation, with rows equal to the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.ops.kernel_config import KernelConfig as JConfig
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import join as tjoin
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.table import Table

NAMES = ["key", "build_payload", "probe_payload"]
LIMIT = 2**31 - 2


def _rows(cols, valid):
    valid = np.asarray(valid)
    a = np.stack([np.asarray(cols[n])[valid].astype(np.int64)
                  for n in NAMES], axis=1)
    return a[np.lexsort(a.T[::-1])]


def _strided_table(rows: int, names) -> Table:
    """``rows`` rows of zero-stride columns: one element of storage."""
    one = torch.zeros(1, dtype=torch.int64)
    return Table({n: one.expand(rows) for n in names},
                 torch.ones(1, dtype=torch.bool).expand(rows))


@pytest.mark.parametrize("below", [1, 0, -1])
def test_merged_domain_around_scan_limit_keeps_kernel_pipeline(
        monkeypatch, below):
    """``below`` = how far nb + npr sits under 2^31 - 2."""
    nb = 2**30
    npr = LIMIT - below - nb
    big_b = _strided_table(nb, ["key", "build_payload"])
    big_p = _strided_table(npr, ["key", "probe_payload"])
    ok = tjoin._kernel_path_ok(big_b, big_p, ["key"], ["build_payload"],
                               ["probe_payload"], 8192)
    small = JTable({"key": jnp.zeros(8, jnp.int64)}, jnp.ones(8, bool))
    want_ok, _ = jjoin._kernel_path_ok(small, small, ["key"], [], [], nb,
                                       npr, 8192, JConfig(expand="pallas"))
    assert ok == bool(want_ok) == (below > 0)
    # the output block has the same bound
    small_t = _strided_table(8, ["key"])
    assert tjoin._kernel_path_ok(small_t, small_t, ["key"], [], [],
                                 LIMIT - below) == (below > 0)

    rng = np.random.default_rng(60 + below)
    nb, npr = 700, 900
    bcols = {"key": rng.integers(0, 300, nb),
             "build_payload": rng.integers(-(1 << 40), 1 << 40, nb)}
    pcols = {"key": rng.integers(0, 300, npr),
             "probe_payload": rng.integers(-(1 << 40), 1 << 40, npr)}
    bvalid = rng.random(nb) < 0.9
    pvalid = rng.random(npr) < 0.95
    cap = 8192
    want = jjoin.sort_merge_inner_join(
        JTable({k: jnp.asarray(v) for k, v in bcols.items()},
               jnp.asarray(bvalid)),
        JTable({k: jnp.asarray(v) for k, v in pcols.items()},
               jnp.asarray(pvalid)), "key", cap)

    calls = {"kernel": 0, "plain": 0}
    kernel_path, plain_path = tjoin._join_kernel_path, tjoin._join_plain

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tjoin, "_join_kernel_path", spy("kernel",
                                                         kernel_path))
    monkeypatch.setattr(tjoin, "_join_plain", spy("plain", plain_path))
    got = tjoin.sort_merge_inner_join(
        Table.from_numpy(bcols, bvalid, device="cpu"),
        Table.from_numpy(pcols, pvalid, device="cpu"), "key", cap,
        kernel_config=KernelConfig(expand="kernel"))
    assert calls == {"kernel": 1, "plain": 0}
    assert int(got.total) == int(want.total) > 0
    assert not bool(got.overflow) and not bool(want.overflow)
    gcols, gvalid = got.table.to_numpy()
    np.testing.assert_array_equal(_rows(gcols, gvalid),
                                  _rows(want.table.columns,
                                        want.table.valid))
