"""The port's phases (``telemetry.phase``: ``record_function`` ranges
inside its spans) and ``sync.*`` ranges against the reduction of a
device trace, on a trace made by hand: every number the accepted
metrics read, for the accepted spans, is the same with the phases as
without, and so are the metrics; the naming of idle gaps may take a
phase, the innermost host range open there."""

from collections import defaultdict

import pytest

from joinbench.harness import spec
from joinbench.harness.report import ReadContext
from joinbench.harness.trace import OP_RANGE, PORT_SPANS, reduce_events

# The eight per-layer metrics of the accepted benchmark.
METRICS = ("retries_per_op", "partition_ms_per_op", "shuffle_ms_per_op",
           "local_join_ms_per_op", "sort_ms_per_op", "join_agg_ms_per_op",
           "hand_kernels_roofline_pct", "device_idle_pct")


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, kernel, k_ts, k_dur):
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=corr),
            _x("kernel", kernel, k_ts, k_dur, tid=7, corr=corr)]


def _spans():
    """Two operations: a partition (a hash pass and a sort), a shuffle
    (a packing gather and the wire), a join (the merged sort and a scan)
    and a fused aggregate (its sort and its reduction), with the host
    reading the overflow flag at each operation's end."""
    ev = []
    for i, t0 in enumerate((0, 1000)):
        ev += [_x("user_annotation", OP_RANGE, t0, 900),
               _x("user_annotation", "partition", t0 + 10, 100),
               _x("user_annotation", "shuffle", t0 + 120, 100),
               _x("user_annotation", "join", t0 + 230, 200),
               _x("user_annotation", "join_agg", t0 + 440, 200)]
        c = 10 * i
        ev += _launch(t0 + 20, c + 1, "elementwise_kernel<hash>", t0 + 25,
                      40)
        ev += _launch(t0 + 80, c + 2,
                      "cub::DeviceRadixSortOnesweepKernel<int>", t0 + 70, 30)
        ev += _launch(t0 + 130, c + 3, "index_elementwise_kernel", t0 + 130,
                      20)
        ev += _launch(t0 + 180, c + 4, "ncclDevKernel_SendRecv", t0 + 160,
                      50)
        ev += _launch(t0 + 240, c + 5,
                      "cub::DeviceRadixSortOnesweepKernel<long>", t0 + 240,
                      60)
        ev += _launch(t0 + 400, c + 6, "void r_pass(unsigned char const*)",
                      t0 + 320, 80)
        ev += _launch(t0 + 450, c + 7,
                      "cub::DeviceRadixSortOnesweepKernel<long>", t0 + 450,
                      40)
        ev += _launch(t0 + 600, c + 8, "elementwise_kernel_with_index",
                      t0 + 600, 100)
        ev += [_x("cpu_op", "aten::_local_scalar_dense", t0 + 720, 150)]
    return ev


def _phases():
    """The ranges the port adds inside the same operations."""
    ev = []
    for t0 in (0, 1000):
        ev += [_x("user_annotation", "entry", t0 + 5, 880),
               _x("user_annotation", "partition_hash", t0 + 15, 60),
               _x("user_annotation", "merged_sort", t0 + 235, 100),
               _x("user_annotation", "merged_sort", t0 + 445, 50),
               _x("user_annotation", "agg_reduce", t0 + 500, 130),
               _x("user_annotation", "sync.overflow", t0 + 715, 160)]
    return ev


def _read_all(t):
    work = {k: 1000 for k in ("scan_positions", "compact_positions",
                              "compact_kept_words", "expand_records",
                              "expand_record_words", "expand_build_words",
                              "expand_out_words", "expand_rows")}
    ctx = ReadContext(cell="x", chips=1, kernels=spec.kernel_specs(),
                      ranks=[{"trace": t, "work": work, "retries": [0, 1]}])
    return {m: spec.reader("layers", m)(ctx) for m in METRICS}


def _by_port_spans(span_kernel_s):
    """``span_kernel_s`` with each launch's open ranges cut to the
    accepted spans (the tuples may gain phase names)."""
    out = defaultdict(float)
    for sp, name, s in span_kernel_s:
        out[(tuple(sorted(set(sp) & set(PORT_SPANS))), name)] += s
    return {k: pytest.approx(v) for k, v in out.items()}


@pytest.mark.parametrize("ordered", ["spans_first", "phases_first"])
def test_phases_leave_every_number_and_metric_as_it_was(ordered):
    """Whether the phases come before or after the spans in the trace,
    each key of today's reduction keeps its value for the accepted span
    names, the idle gaps keep their total, and the eight accepted
    metrics read the same."""
    spans, phases = _spans(), _phases()
    before = reduce_events(spans)
    after = reduce_events(spans + phases if ordered == "spans_first"
                          else phases + spans)
    for key in ("n_ops", "window_s", "busy_s", "kernel_s", "kernel_n",
                "device_ops"):
        assert after[key] == before[key], key
    assert {s: after["span_device_s"].get(s) for s in PORT_SPANS} == {
        s: before["span_device_s"].get(s) for s in PORT_SPANS}
    assert _by_port_spans(after["span_kernel_s"]) == _by_port_spans(
        before["span_kernel_s"])
    assert sum(v for _, v in after["idle_gaps"]) == pytest.approx(
        sum(v for _, v in before["idle_gaps"]))
    got, want = _read_all(after), _read_all(before)
    assert got == want
    assert all(want[m] is not None for m in METRICS)


def test_an_idle_gap_is_named_by_the_phase_open_there():
    """The host's preparation at an entry's start leaves the device idle:
    the gap was named by the operation's range, and is now named by the
    ``entry`` range inside it (the innermost range open at its middle);
    its length is the same."""
    ev = [_x("user_annotation", OP_RANGE, 0, 100),
          _x("user_annotation", "join", 30, 65),
          *_launch(40, 1, "void r_pass(unsigned char const*)", 50, 50)]
    before = dict(reduce_events(ev)["idle_gaps"])
    after = dict(reduce_events(
        ev + [_x("user_annotation", "entry", 2, 98)])["idle_gaps"])
    assert before == {OP_RANGE: pytest.approx(50e-6)}
    assert after == {"entry": pytest.approx(50e-6)}
