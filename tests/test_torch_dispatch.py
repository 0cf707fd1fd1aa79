"""The join's dispatch around the scan kernel's limit, on the CPU.

``scan.MAX_N`` bounds only the CUDA scan (its status words count
positions in 30 bits; above it the card's join raises, see
``tests/test_torch_cuda.py``). The join has no gate of its own at that
limit: with the kernel pipeline asked for, a CPU join on either side of
a lowered ``scan.MAX_N`` runs the pipeline through the kernels' plain
twins, and never the plain formulation. The rows must equal the JAX
package's join either way."""

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import join as jjoin
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import join as tjoin
from distributed_join_tpu_torch.ops import scan
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.table import Table

NAMES = ["key", "build_payload", "probe_payload"]


def _rows(cols, valid):
    valid = np.asarray(valid)
    a = np.stack([np.asarray(cols[n])[valid].astype(np.int64)
                  for n in NAMES], axis=1)
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("below", [0, 1, 300])
def test_merged_domain_around_scan_limit_keeps_kernel_pipeline(
        monkeypatch, below):
    """``below`` = how far ``scan.MAX_N`` sits under nb + npr."""
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
    monkeypatch.setattr(scan, "MAX_N", nb + npr - below)
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
