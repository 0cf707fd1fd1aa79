"""The reduction of a device trace and the readers over it, on a trace
made by hand: busy is the union of the device intervals, a kernel is
tied to the spans open where it was launched, and a roofline reads
nothing where no kernel of it ran."""

from joinbench.harness import spec
from joinbench.harness.report import ReadContext
from joinbench.harness.trace import OP_RANGE, reduce_events


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    return [
        _x("user_annotation", OP_RANGE, 0, 100),
        _x("user_annotation", "partition", 5, 20),
        _x("user_annotation", "join", 30, 40),
        _x("cpu_op", "aten::nonzero", 72, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=3),
        _x("kernel", "void r_pass(unsigned char const*)", 12, 20,
           tid=7, corr=1),
        _x("kernel", "cub::DeviceRadixSortOnesweepKernel<x>", 36, 30,
           tid=7, corr=2),
        _x("kernel", "compact_kernel(int)", 50, 10, tid=8, corr=3),
    ]


def test_busy_is_a_union_and_spans_take_their_launches():
    t = reduce_events(_trace())
    assert t["n_ops"] == 1
    assert abs(t["window_s"] - 100e-6) < 1e-12
    # [12, 32] and [36, 66] ([50, 60] lies inside the second)
    assert abs(t["busy_s"] - 50e-6) < 1e-12
    assert abs(t["span_device_s"]["partition"] - 20e-6) < 1e-12
    assert abs(t["span_device_s"]["join"] - 40e-6) < 1e-12
    gaps = dict(t["idle_gaps"])
    assert abs(gaps["aten::nonzero"] - 34e-6) < 1e-12   # [66, 100]
    assert t["device_ops"][0][0].startswith("cub::DeviceRadixSort")


def test_readers_over_the_trace():
    t = reduce_events(_trace())
    work = {k: 1000 for k in ("scan_positions", "compact_positions",
                              "compact_kept_words", "expand_records",
                              "expand_record_words", "expand_build_words",
                              "expand_out_words", "expand_rows")}
    ctx = ReadContext(cell="x", chips=1, kernels=spec.kernel_specs(),
                      ranks=[{"trace": t, "work": work, "retries": [0, 2]}])
    read = lambda name: spec.reader("layers", name)(ctx)  # noqa: E731
    assert abs(read("device_idle_pct") - 50.0) < 1e-9
    assert abs(read("local_join_ms_per_op") - 0.04) < 1e-12
    assert abs(read("sort_ms_per_op") - 0.03) < 1e-12
    assert read("join_agg_ms_per_op") is None
    assert read("retries_per_op") == 1.0
    # scans 26 kB and compaction 17 kB at 3.35 TB/s, over their 30 us
    want = 100 * (26e3 + 17e3) / 3.35e12 / 30e-6
    assert abs(read("hand_kernels_roofline_pct") - want) < 1e-9
    no_kernels = dict(t, kernel_s={"other": 1e-3})
    ctx.ranks[0]["trace"] = no_kernels
    assert read("hand_kernels_roofline_pct") is None


def test_sorts_count_only_inside_the_local_join_spans():
    """A sort launched in the partition (its bucket ids) is a sort kernel
    by name, but not the local join's."""
    t = reduce_events(_trace() + [
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=4),
        _x("kernel", "cub::DeviceRadixSortOnesweepKernel<int>", 14, 10,
           tid=9, corr=4)])
    assert abs(t["span_device_s"]["partition"] - 30e-6) < 1e-12
    ctx = ReadContext(cell="x", chips=1, kernels=spec.kernel_specs(),
                      ranks=[{"trace": t}])
    assert abs(spec.reader("layers", "sort_ms_per_op")(ctx) - 0.03) < 1e-12
    outside = dict(t, span_kernel_s=[[["partition"], n, v] for _, n, v
                                     in t["span_kernel_s"]])
    ctx.ranks[0]["trace"] = outside
    assert spec.reader("layers", "sort_ms_per_op")(ctx) is None
