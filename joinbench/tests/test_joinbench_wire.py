"""``wire_ms_per_op`` on traces made by hand: NCCL's kernels launched
inside a ``shuffle`` span, by name, and nothing where none ran there."""

import pytest

from joinbench.harness import spec
from joinbench.harness.report import ReadContext
from joinbench.harness.trace import OP_RANGE, reduce_events


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, kernel, k_ts, k_dur, cat="cuda_runtime"):
    return [_x(cat, "cudaLaunchKernel", ts, 1, corr=corr),
            _x("kernel", kernel, k_ts, k_dur, tid=7, corr=corr)]


def _trace(wire="ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"):
    """Two operations: in each, a packing gather and the wire inside
    ``shuffle`` (the wire launched through the driver API, as NCCL
    does), and an NCCL reduction of counts outside any span."""
    ev = []
    for i, t0 in enumerate((0, 1000)):
        c = 10 * i
        ev += [_x("user_annotation", OP_RANGE, t0, 900),
               _x("user_annotation", "shuffle", t0 + 100, 300)]
        ev += _launch(t0 + 110, c + 1, "index_elementwise_kernel",
                      t0 + 110, 40)
        ev += _launch(t0 + 200, c + 2, wire, t0 + 200, 150 + 50 * i,
                      cat="cuda_driver")
        ev += _launch(t0 + 500, c + 3,
                      "ncclDevKernel_AllReduce_Sum_u64_RING_LL(x)",
                      t0 + 500, 30)
    return reduce_events(ev)


def _read(*traces):
    ctx = ReadContext(cell="x", chips=len(traces),
                      kernels=spec.kernel_specs(),
                      ranks=[{"trace": t, "work": {}, "retries": [0, 1]}
                             for t in traces])
    return spec.reader("layers", "wire_ms_per_op")(ctx)


@pytest.mark.parametrize("kernel", [
    "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
    "ncclKernel_SendRecv_RING_SIMPLE_Sum_int8_t(ncclWorkElem)"])
def test_wire_counts_nccl_kernels_inside_shuffle_only(kernel):
    """(150 + 200) us over two operations on one rank; the gather in the
    span and the reduction outside it are not the wire."""
    assert _read(_trace(kernel)) == pytest.approx(0.175)


def test_wire_is_the_mean_over_the_ranks():
    t = _trace()
    assert _read(t, t) == pytest.approx(0.175)


def test_wire_reads_nothing_where_no_nccl_kernel_ran_in_a_shuffle():
    """A one-chip query (no shuffle span) and a gloo run (no device
    kernel in the span) read None, and the line leaves the metric out."""
    no_span = [_x("user_annotation", OP_RANGE, 0, 900),
               *_launch(10, 1, "ncclDevKernel_SendRecv(x)", 10, 50)]
    assert _read(reduce_events(no_span)) is None
    assert _read(_trace(wire="index_elementwise_kernel")) is None
