"""The port's live serving metrics (telemetry/live.py) against the JAX
package's, on the CPU.

The same request streams (ops, outcomes, latencies, signatures, tenants,
shed flags, rejections), made from a seed with numpy, go through both
modules' ``LiveMetrics``, each on a fake clock that ticks the same way.
Compared exactly: the histogram buckets, counts and quantiles, merged
snapshots, ``LiveMetrics.snapshot()`` less its wall-clock field, the
Prometheus text (and, on real clocks, with the uptime and QPS values
masked), ``fleet_prometheus``, and the ``FlightRecorder`` ring and its
dump's schema.
"""

import json
import re

import numpy as np
import pytest

from distributed_join_tpu.telemetry import live as jlive
from distributed_join_tpu_torch.telemetry import live as tlive

OPS = ("join", "batch", "resident_join", "query", "register", "explain")
OUTCOMES = ("served", "served", "served", "failed", "hang", "rejected")


class _Clock:
    """A monotonic clock that advances by a fixed step a reading."""

    def __init__(self, step: float):
        self.t = 1000.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _stream(seed: int, n: int, n_sigs: int, tenants: bool):
    """``n`` requests as ``record_request`` keyword sets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        outcome = OUTCOMES[rng.integers(len(OUTCOMES))]
        rec = dict(
            op=OPS[rng.integers(len(OPS))], outcome=outcome,
            latency_s=(float(rng.lognormal(-5.0, 2.0))
                       if outcome == "served" else None),
            signature=(f"{int(rng.integers(n_sigs)):016x}"
                       if rng.random() < 0.9 else None),
            cache_hits=int(rng.integers(0, 3)),
            new_traces=int(rng.integers(0, 2)),
            retry_rungs=int(rng.integers(0, 3)),
            integrity_retries=int(rng.integers(0, 2)))
        if tenants and rng.random() < 0.7:
            rec["tenant"] = f"t{int(rng.integers(80))}"
            rec["shed"] = bool(rng.random() < 0.2)
        out.append(rec)
    return out


def _fed(stream, step=0.37):
    j = jlive.LiveMetrics(now=_Clock(step))
    t = tlive.LiveMetrics(now=_Clock(step))
    for rec in stream:
        j.record_request(**rec)
        t.record_request(**rec)
    return j, t


def _no_epoch(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k != "epoch_start_s"}


def test_constants_equal():
    assert tlive.LATENCY_BUCKETS_S == jlive.LATENCY_BUCKETS_S
    assert len(tlive.LATENCY_BUCKETS_S) == 25
    assert tlive.FLIGHT_RECORDER_FILENAME == jlive.FLIGHT_RECORDER_FILENAME
    assert (tlive.FLIGHT_RECORDER_SCHEMA_VERSION
            == jlive.FLIGHT_RECORDER_SCHEMA_VERSION)
    for name in ("QPS_WINDOW_S", "MAX_SIGNATURES", "MAX_TENANTS"):
        assert getattr(tlive.LiveMetrics, name) == getattr(
            jlive.LiveMetrics, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_buckets_and_quantiles_equal(seed):
    """Every observation lands in the same bucket, so the snapshots, the
    quantiles at any q and the summaries are equal; merges too."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(-6.0, 3.0, 500),
                           list(jlive.LATENCY_BUCKETS_S),   # on the bounds
                           [0.0, 1e-9, 250.0, 1e4]])        # overflow
    hists = []
    for mod in (jlive, tlive):
        h = mod.LatencyHistogram()
        for v in vals:
            h.observe(float(v))
        hists.append(h)
    jh, th = hists
    assert th.snapshot() == jh.snapshot()
    assert th.summary() == jh.summary()
    assert th.summary()["overflow"] > 0
    for q in np.linspace(0.0, 1.0, 41):
        assert th.quantile(float(q)) == jh.quantile(float(q))
    assert tlive.LatencyHistogram().quantile(0.5) is None
    # merge: the snapshot of one package folds into the other's
    jm, tm = jlive.LatencyHistogram(), tlive.LatencyHistogram()
    jm.merge(th.snapshot())
    tm.merge(jh.snapshot())
    jm.merge(jh.snapshot())
    tm.merge(th.snapshot())
    assert tm.snapshot() == jm.snapshot()
    bad = dict(th.snapshot(), counts=[1, 2])
    with pytest.raises(ValueError) as te:
        tlive.LatencyHistogram().merge(bad)
    with pytest.raises(ValueError) as je:
        jlive.LatencyHistogram().merge(bad)
    assert str(te.value) == str(je.value)


STREAMS = [
    dict(seed=3, n=300, n_sigs=8, tenants=False),      # tenant-free
    dict(seed=4, n=400, n_sigs=12, tenants=True),      # tenants, shed
    dict(seed=5, n=900, n_sigs=400, tenants=True),     # both LRUs drop
]


@pytest.mark.parametrize("spec", STREAMS, ids=["plain", "tenants", "lru"])
def test_snapshot_and_prometheus_equal(spec):
    """The same stream on the same fake clock: the snapshot less its
    epoch, every read path and the Prometheus text (with the service's
    gauges) are equal, bounded tables included."""
    stream = _stream(**spec)
    j, t = _fed(stream)
    js, ts = j.snapshot(), t.snapshot()
    assert _no_epoch(ts) == _no_epoch(js)
    assert ("tenants" in ts) == spec["tenants"]
    if spec["n_sigs"] > tlive.LiveMetrics.MAX_SIGNATURES:
        assert ts["signatures_dropped"] > 0
        assert len(ts["signatures"]) == tlive.LiveMetrics.MAX_SIGNATURES
    assert t.overall_latency() == j.overall_latency()
    assert t.latency_by_op() == j.latency_by_op()
    assert t.tenants_summary() == j.tenants_summary()
    gauges = {"pending": 2, "poisoned": 0, "program_cache_hits": 17,
              "program_cache_occupancy": 0.25, "skipped": None}
    jp, tp = j.to_prometheus(gauges=gauges), t.to_prometheus(gauges=gauges)
    assert tp == jp
    assert "djtpu_requests_total" in tp and "djtpu_skipped" not in tp
    assert "djtpu_request_latency_seconds_bucket" in tp


_CLOCK_LINE = re.compile(r"^(djtpu_uptime_seconds|djtpu_qps_60s) .*$",
                         re.M)


def _masked(text: str) -> str:
    return _CLOCK_LINE.sub(r"\1 <masked>", text)


def test_real_clock_snapshot_and_prometheus_masked():
    """On the real clocks (the service's default), the snapshot less
    ``uptime_s``, ``epoch_start_s`` and ``qps_60s``, and the Prometheus
    text with the uptime and QPS values masked, are equal."""
    stream = _stream(seed=6, n=120, n_sigs=5, tenants=True)
    j, t = jlive.LiveMetrics(), tlive.LiveMetrics()
    for rec in stream:
        j.record_request(**rec)
        t.record_request(**rec)
    wall = ("uptime_s", "epoch_start_s", "qps_60s")

    def strip(snap):
        out = {k: v for k, v in snap.items() if k not in wall}
        out["tenants"] = {n: {k: v for k, v in s.items() if k != "qps_60s"}
                          for n, s in snap["tenants"].items()}
        return out

    assert strip(t.snapshot()) == strip(j.snapshot())
    assert _masked(t.to_prometheus()) == _masked(j.to_prometheus())
    assert "<masked>" in _masked(t.to_prometheus())


def test_merge_snapshots_equal():
    """Replica snapshots merge bucket-wise to the same fleet view, a
    snapshot of either package in either merge."""
    snaps = []
    for k in range(3):
        j, t = _fed(_stream(seed=10 + k, n=150, n_sigs=6, tenants=False),
                    step=0.1 * (k + 1))
        snaps.append((j.snapshot(), t.snapshot()))
    jm = jlive.merge_snapshots([j for j, _ in snaps])
    tm = tlive.merge_snapshots([t for _, t in snaps])
    assert tm == jm
    assert tm["replicas"] == 3
    assert tlive.merge_snapshots([j for j, _ in snaps]) == jm
    assert tlive.merge_snapshots([]) == jlive.merge_snapshots([])


def test_fleet_prometheus_equal():
    """The fleet section: per-replica up gauges (a silent replica is 0),
    per-replica counters and the merged histogram."""
    per = {}
    for k in range(3):
        _, t = _fed(_stream(seed=20 + k, n=80, n_sigs=4, tenants=False))
        per[k] = t.snapshot()
    per[3] = None
    text = tlive.fleet_prometheus(per)
    assert text == jlive.fleet_prometheus(per)
    assert 'djtpu_fleet_replica_up{replica="3"} 0' in text
    assert "djtpu_fleet_request_latency_seconds_bucket" in text


@pytest.mark.parametrize("capacity", [4, 64])
def test_flight_recorder_ring_and_dump_equal(capacity, tmp_path):
    """The ring keeps the newest ``capacity`` records and counts the
    rest; the snapshot less its timestamps is equal, and the port's dump
    has the JAX dump's keys and passes the JAX package's schema check."""
    from distributed_join_tpu.telemetry.analyze import check_file

    rng = np.random.default_rng(capacity)
    recs = [dict(request_id=f"req-{i:04d}", op=OPS[i % len(OPS)],
                 signature=f"{int(rng.integers(1 << 60)):016x}",
                 outcome=OUTCOMES[i % len(OUTCOMES)],
                 elapsed_s=round(float(rng.random()), 6), matches=i,
                 overflow=False, new_traces=i % 2, cache_hits=1,
                 rung_path=["initial"], tuned=None, resident=None,
                 aggregate=None, error=None, trace=None)
            for i in range(10)]
    jr, tr = (jlive.FlightRecorder(capacity),
              tlive.FlightRecorder(capacity))
    for r in recs:
        jr.record(**r)
        tr.record(**r)
    assert len(tr) == len(jr) == min(10, capacity)

    def strip(doc):
        doc = {k: v for k, v in doc.items() if k != "dumped_epoch_s"}
        doc["records"] = [{k: v for k, v in r.items() if k != "ts_epoch_s"}
                          for r in doc["records"]]
        return doc

    trace = {"trace_id": "t-1", "span_id": "s-1"}
    assert (strip(tr.snapshot("why", trace=trace))
            == strip(jr.snapshot("why", trace=trace)))
    assert tr.snapshot()["dropped"] == max(10 - capacity, 0)
    tpath = tr.dump(str(tmp_path / "t" / "flightrecorder.json"), "poisoned")
    jpath = jr.dump(str(tmp_path / "j" / "flightrecorder.json"), "poisoned")
    tdoc, jdoc = json.load(open(tpath)), json.load(open(jpath))
    assert set(tdoc) == set(jdoc)
    assert [set(r) for r in tdoc["records"]] == [set(r)
                                                 for r in jdoc["records"]]
    assert strip(tdoc) == strip(jdoc)
    assert check_file(tpath) == []
