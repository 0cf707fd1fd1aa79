"""The port's stage profiler (telemetry/stageprof.py) on the CPU.

The JAX package's multi-rank stage profile raises shard_map's
``out_specs`` replication error on the installed jax, so over emulated
ranks the port is held against the written expectations of the JAX
package's ``tests/test_stageprof.py`` and against the port's own tape
and plan:

- the stage set is ``explain_join(...).cost["stages"]``'s, one to one;
- each stage's counters equal the tape-on monolithic join's, exactly,
  and the padded wire bytes equal the plan's prediction;
- the sum of the stages' least walls is at least half the monolithic
  step's least wall (the JAX suite's in-process bound: eager segments on
  small CPU tables sit close to the fused step, either way);
- profiling leaves the tape-off step's torch op sequence unchanged, and
  the profile's ``plan_digest`` is that step's ``JoinSignature`` digest.

Where the JAX profile runs (one rank, the join alone), the two packages
profile the same tables, made by the JAX package's generators and passed
through numpy. The scope refusals carry the JAX package's messages.
"""

import json

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.telemetry import analyze as janalyze
from distributed_join_tpu.telemetry import stageprof as jstageprof
from distributed_join_tpu.utils import generators as jgen
from distributed_join_tpu_torch import telemetry as ttel
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import query_exec as tq
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.planning import cost as tcost
from distributed_join_tpu_torch.planning.plan import explain_join
from distributed_join_tpu_torch.planning.query import tpch_query_plan
from distributed_join_tpu_torch.service.programs import JoinSignature
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.telemetry import history as thist
from distributed_join_tpu_torch.telemetry import stageprof
from distributed_join_tpu_torch.utils.tpch import (
    generate_tpch_query_tables,
    query_filters,
)

OPTS = dict(out_capacity_factor=3.0)


@pytest.fixture(autouse=True)
def _no_leaked_session():
    ttel.finalize()
    yield
    ttel.finalize()


def _port(jt) -> Table:
    return Table.from_numpy({c: np.asarray(v) for c, v in jt.columns.items()},
                            np.asarray(jt.valid), device="cpu")


def _jax_tables(seed, rows, **kw):
    jb, jp = jgen.generate_build_probe_tables(
        seed=seed, build_nrows=rows, probe_nrows=rows, selectivity=0.3, **kw)
    return (jb, jp), (_port(jb), _port(jp))


@pytest.fixture(scope="module")
def tables():
    return _jax_tables(42, 8000)[1]


@pytest.fixture(scope="module")
def comm():
    return EmulatedCommunicator(8)


@pytest.fixture(scope="module")
def profiled(comm, tables):
    b, p = tables
    prof = stageprof.profile_join_stages(comm, b, p, repeats=7, **OPTS)
    return prof, prof.as_record()


def _merged_counters(rec) -> dict:
    out = {}
    for st in rec["stages"].values():
        out.update(st["counters"])
    return out


# -- against the JAX package's live profile (one rank) -------------------------


@pytest.mark.parametrize("seed,rows", [(7, 1024), (11, 4096)])
def test_single_rank_profile_equals_jax(seed, rows):
    """One rank at k = 1: both packages profile the join alone (the step
    joins one bucket directly), with the same stage set, ``ran`` flags
    and ``matches``."""
    (jb, jp), (tb, tp) = _jax_tables(seed, rows)
    jrec = jstageprof.profile_join_stages(
        jcomm.LocalCommunicator(), jb, jp, repeats=1, **OPTS).as_record()
    trec = stageprof.profile_join_stages(
        LocalCommunicator(), tb, tp, repeats=1, **OPTS).as_record()
    assert set(trec["stages"]) == set(jrec["stages"]) == set(
        stageprof.STAGE_KEYS)
    assert {k: v["ran"] for k, v in trec["stages"].items()} == \
        {k: v["ran"] for k, v in jrec["stages"].items()}
    assert trec["stages"]["join"]["counters"] == \
        jrec["stages"]["join"]["counters"]
    assert trec["stages"]["join"]["counters"]["matches"] > 0
    assert trec["stages"]["join"]["wall_s"] > 0
    assert trec["platform"] == "cpu" and not trec["overflow"]
    assert stageprof.STAGE_KEYS == jstageprof.STAGE_KEYS


def test_scope_refusals_carry_the_jax_messages(comm, tables):
    """The skew sidecar, 2-D string keys and the ragged wire's varwidth
    columns refuse, with the JAX package's messages."""
    b, p = tables
    sb = {"key": np.zeros((64, 8), np.uint8),
          "key#len": np.full((64,), 8, np.int32)}
    vb = {"key": np.arange(64, dtype=np.int64),
          "s": np.zeros((64, 8), np.uint8),
          "s#len": np.full((64,), 8, np.int32)}
    valid = np.ones((64,), bool)
    import jax.numpy as jnp

    from distributed_join_tpu.table import Table as JTable
    jsb = JTable({k: jnp.asarray(v) for k, v in sb.items()},
                 jnp.asarray(valid))
    jvb = JTable({k: jnp.asarray(v) for k, v in vb.items()},
                 jnp.asarray(valid))
    tsb = Table.from_numpy(sb, valid, device="cpu")
    tvb = Table.from_numpy(vb, valid, device="cpu")
    jb, jp = jgen.generate_build_probe_tables(seed=1, build_nrows=64,
                                              probe_nrows=64)
    cases = [
        ((jb, jp, dict(skew_threshold=0.001)),
         (b, p, dict(skew_threshold=0.001)), "skew sidecar"),
        ((jsb, jsb, {}), (tsb, tsb, {}), "string"),
        ((jvb, jvb, dict(shuffle="ragged")), (tvb, tvb,
                                              dict(shuffle="ragged")),
         "varwidth"),
    ]
    jmesh = jcomm.make_communicator("tpu", n_ranks=8)
    for (jx, jy, jo), (tx, ty, to), what in cases:
        with pytest.raises(ValueError, match=what) as jerr:
            jstageprof.profile_join_stages(jmesh, jx, jy, repeats=1,
                                           **jo, **OPTS)
        with pytest.raises(ValueError, match=what) as terr:
            stageprof.profile_join_stages(comm, tx, ty, repeats=1, **to,
                                          **OPTS)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="repeats"):
        stageprof.profile_join_stages(comm, b, p, repeats=0)


# -- the red tests' written expectations, over 8 emulated ranks ---------------


def test_stage_set_matches_cost_predict_keys(comm, tables, profiled):
    b, p = tables
    _, rec = profiled
    plan = explain_join(b, p, comm, **OPTS)
    assert set(rec["stages"]) == set(plan.cost["stages"])
    assert set(rec["stages"]) == set(stageprof.STAGE_KEYS)


def test_stage_sum_bounds_monolithic_on_min_walls(profiled):
    prof, rec = profiled
    assert rec["sum_of_stages_min_s"] >= 0.5 * rec["monolithic"]["wall_min_s"]
    assert prof.sum_of_stages_min_s >= 0.5 * prof.monolithic_wall_min_s
    for name in ("partition", "shuffle", "join"):
        assert rec["stages"][name]["ran"]
        assert rec["stages"][name]["wall_s"] > 0
        assert len(rec["stages"][name]["walls_s"]) == 7
    assert rec["stages"]["skew"]["ran"] is False
    assert rec["overflow"] is False
    assert rec["platform"] == "cpu"


WIRES = {
    "padded": (8, 1, {}),
    "ppermute": (8, 1, dict(shuffle="ppermute")),
    "ragged": (8, 1, dict(shuffle="ragged")),
    "compressed16": (8, 1, dict(compression_bits=16)),
    "hierarchical_2x4": (8, 2, dict(shuffle="hierarchical",
                                    dcn_codec="on")),
    "padded_k2": (4, 1, dict(over_decomposition=2)),
    "segmented": (4, 1, dict(sort_mode="segmented", sort_segments=2,
                             shuffle_capacity_factor=3.0)),
}


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_stage_counters_equal_the_monolithic_tape(wire, tables):
    """Each stage's counters equal the tape-on monolithic join's, and on
    every wire whose bytes are static the shuffle's bytes equal the
    plan's prediction (both tiers of the hierarchy)."""
    b, p = tables
    n, slices, opts = WIRES[wire]
    comm = EmulatedCommunicator(n, n_slices=slices)
    rec = stageprof.profile_join_stages(comm, b, p, repeats=1, **opts,
                                        **OPTS).as_record()
    mono = tdist.distributed_inner_join(
        b, p, comm, with_metrics=True, **opts,
        **OPTS).telemetry.to_dict()["reduced"]
    got = _merged_counters(rec)
    assert {k: mono[k] for k in got} == got
    assert set(mono) - set(got) == {"retry_attempt_max"}
    part = rec["stages"]["partition"]["counters"]
    sh = rec["stages"]["shuffle"]["counters"]
    for side in ("build", "probe"):
        assert f"{side}.rows_partitioned" in part
        assert f"{side}.overflow_margin_min" in part
        assert f"{side}.rows_shuffled" in sh and f"{side}.wire_bytes" in sh
    assert rec["stages"]["join"]["counters"] == {"matches": mono["matches"]}
    plan = explain_join(b, p, comm, **opts, **OPTS)
    if plan.wire["exact"]:
        for side in ("build", "probe"):
            assert sh[f"{side}.wire_bytes"] == plan.wire[side]["bytes_total"]
            for tier in ("ici", "dcn"):
                if f"{tier}_bytes_per_rank" in plan.wire[side]:
                    assert sh[f"{side}.wire_bytes_{tier}"] == \
                        plan.wire[side][f"{tier}_bytes_per_rank"] * n
    assert rec["shuffle"] == plan.shuffle
    assert rec["sort_segments"] == (plan.capacities.get("sort_segments")
                                    or 1)


def test_padded_ici_block_from_the_exact_counters(profiled):
    _, rec = profiled
    sh = rec["stages"]["shuffle"]
    ici = sh["ici"]
    assert ici["wire_bytes_per_rank"] * 8 == \
        sh["counters"]["build.wire_bytes"] + sh["counters"]["probe.wire_bytes"]
    assert ici["offchip_bytes_per_rank"] == int(
        ici["wire_bytes_per_rank"] * 7 / 8)
    assert 0 < ici["ici_utilization"]
    assert ici["spec_gb_per_s"] == pytest.approx(
        tcost.DEFAULT_COST_MODEL.ici_bytes_per_s / 1e9)
    assert "note" not in ici


def test_world_of_one_shuffle_says_it_crosses_no_link(tables):
    """One rank at k = 4: all three stages run; the shuffle moves no
    byte off the device, and its ICI block says so."""
    b, p = tables
    rec = stageprof.profile_join_stages(LocalCommunicator(), b, p,
                                        repeats=2, over_decomposition=4,
                                        **OPTS).as_record()
    assert all(rec["stages"][s]["ran"] for s in ("partition", "shuffle",
                                                 "join"))
    ici = rec["stages"]["shuffle"]["ici"]
    assert ici["offchip_bytes_per_rank"] == 0
    assert ici["ici_utilization"] == 0
    assert "no byte leaves the device" in ici["note"]
    assert "no byte leaves the device" in stageprof.format_stage_record(rec)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("opts", [dict(over_decomposition=2),
                                  dict(over_decomposition=2,
                                       shuffle="ragged"),
                                  dict(over_decomposition=2,
                                       compression_bits=16)], ids=str)
def test_profile_leaves_the_tape_off_step_unchanged(opts, tables):
    """The tape-off step's torch op sequence and result, recorded before
    and after a profile, are the same (one rank: a dispatch mode sees
    its own thread only)."""
    b, p = tables
    comm = LocalCommunicator()

    def run():
        fn = tdist.make_distributed_join(comm, **opts, **OPTS)
        mode = _Ops()
        with mode:
            res = fn(b, p)
        return mode.ops, int(res.total)

    before = run()
    stageprof.profile_join_stages(comm, b, p, repeats=1, **opts, **OPTS)
    assert run() == before


def test_plan_digest_is_the_join_signature(comm, tables, profiled):
    b, p = tables
    _, rec = profiled
    sig = JoinSignature.of(comm, b, p, key="key", with_metrics=False,
                           **OPTS)
    assert rec["plan_digest"] == sig.digest()


def test_record_passes_both_packages_checks(profiled, tmp_path):
    """The record and its grade pass the JAX package's ``analyze check``
    and grade alike in both packages."""
    from distributed_join_tpu_torch.telemetry import analyze
    _, rec = profiled
    path = tmp_path / "stageprofile.json"
    path.write_text(json.dumps(rec, indent=1))
    assert janalyze.check_file(str(path)) == []
    assert analyze.check_file(str(path)) == []
    assert analyze.grade_stages(rec) == janalyze.grade_stages(rec)


# -- the query profile ---------------------------------------------------------


@pytest.fixture(scope="module")
def q3_profile():
    comm = EmulatedCommunicator(8)
    tables = query_filters(generate_tpch_query_tables(
        seed=42, scale_factor=0.01, device="cpu"), "q3")
    plan = tpch_query_plan("q3")
    defaults = dict(out_capacity_factor=3.0, shuffle_capacity_factor=3.0)
    prof = stageprof.profile_query_stages(comm, plan, tables, repeats=2,
                                          **defaults)
    return comm, tables, plan, defaults, prof


def test_query_profile_counters_equal_the_monolithic_query(q3_profile):
    """Q3 at SF-0.01 over 8 emulated ranks: each operator's ``matches``
    (and the aggregate's groups) equal the tape-on monolithic query's
    counters for that operator, and its totals."""
    comm, tables, plan, defaults, prof = q3_profile
    rec = prof.as_record()
    mono = tq.distributed_query(tables, plan, comm, with_metrics=True,
                                **defaults)
    assert not rec["overflow"] and not bool(mono.overflow)
    assert rec["order"] == [op.op_id for op in plan.ops]
    for op, m, total in zip(plan.ops, mono.telemetry, mono.op_totals):
        got = rec["operators"][op.op_id]["counters"]
        red = m.to_dict()["reduced"]
        assert got["matches"] == red["matches"] == int(total)
        if op.aggregate is not None:
            assert got["agg.groups"] == red["agg.groups"] == \
                int(mono.table.valid.sum())
        else:
            assert "agg.groups" not in got
    assert rec["platform"] == "cpu"
    assert rec["plan_digest"] == plan.digest()


def test_query_profile_record_and_summary(q3_profile, tmp_path):
    comm, tables, plan, defaults, prof = q3_profile
    rec = prof.as_record()
    from distributed_join_tpu_torch.planning.query import explain_query
    doc = explain_query(plan, comm, tables, defaults=defaults, orders=False)
    for o in doc["operators"]:
        entry = rec["operators"][o["id"]]
        assert entry["ran"] and entry["wall_s"] > 0
        assert entry["predicted_s"] == o["cost"]["total_s"]
    assert rec["predicted_total_s"] == doc["total_s"]
    path = tmp_path / "query_stageprofile.json"
    path.write_text(json.dumps(rec))
    assert janalyze.check_file(str(path)) == []
    block = thist.stages_block(prof.summary())
    assert set(block["wall_s"]) == {op.op_id for op in plan.ops}
    text = prof.format()
    assert all(op.op_id in text for op in plan.ops)


# -- the calibration on the port's records ------------------------------------


def _as(rec, platform=None, overflow=None, drop=()):
    r = json.loads(json.dumps(rec))
    if platform is not None:
        r["platform"] = platform
    if overflow is not None:
        r["overflow"] = overflow
    for stage in drop:
        r["stages"][stage]["ran"] = False
    return r


def test_calibrate_from_port_records_holds_the_honesty_gates(profiled):
    """``calibrate_from_stage_profile`` on the port's records: a CPU
    profile never refits the card's constants (``platform="cuda"``),
    an overflowed one never counts, ``min_profiles`` refuses, and an
    eligible record refits each stage's constants by its ratio."""
    _, rec = profiled
    model, report = tcost.calibrate_from_stage_profile(rec)
    assert model is None and report["calibrated"] is False
    assert report["platform"] == "cuda" and report["n_eligible"] == 0
    model, report = tcost.calibrate_from_stage_profile(
        _as(rec, overflow=True), platform=None)
    assert model is None and report["calibrated"] is False
    model, report = tcost.calibrate_from_stage_profile(
        [rec], platform=None, min_profiles=2)
    assert model is None and "need >=" in report["reason"]
    model, report = tcost.calibrate_from_stage_profile(_as(rec, "cuda"))
    assert report["calibrated"]
    base = tcost.DEFAULT_COST_MODEL
    scales = dict(model.calibrated_stage_scales)
    assert set(scales) == {"partition", "shuffle", "join"}
    for stage in ("partition", "join"):
        assert scales[stage] == pytest.approx(
            rec["stages"][stage]["ratio"], rel=1e-9, abs=1e-6)
    assert model.sort_ns_per_elem == pytest.approx(
        base.sort_ns_per_elem * scales["partition"])
    assert model.ici_bytes_per_s == pytest.approx(
        base.ici_bytes_per_s / scales["shuffle"])
    assert model.expand_ns_per_out_row == pytest.approx(
        base.expand_ns_per_out_row * scales["join"])
    # a profile whose shuffle crossed no link is fed without that stage:
    # the bandwidths keep their values
    model, report = tcost.calibrate_from_stage_profile(
        _as(rec, "cuda", drop=("shuffle",)))
    assert report["unfit_stages"] == ["shuffle"]
    assert model.ici_bytes_per_s == base.ici_bytes_per_s
    assert model.collective_latency_s == base.collective_latency_s


# -- the trace's tracks and the history ---------------------------------------


def test_perfetto_stage_track_with_flows(profiled, tmp_path):
    _, rec = profiled
    with ttel.session(str(tmp_path), rank=0):
        ttel.stage_profile(rec)
    trace = json.loads((tmp_path / "trace.rank0.json").read_text())
    evs = trace["traceEvents"]
    slices = [e for e in evs
              if e.get("cat") == "stageprof" and e["ph"] == "X"]
    names = [e["name"] for e in slices]
    for stage in ("partition", "shuffle", "join"):
        assert stage in names and f"{stage} counters" in names
    assert "monolithic" in names
    shuffle_slice = next(e for e in slices if e["name"] == "shuffle")
    assert shuffle_slice["args"]["build.wire_bytes"] == \
        rec["stages"]["shuffle"]["counters"]["build.wire_bytes"]
    starts = [e for e in evs if e.get("ph") == "s"]
    finishes = [e for e in evs if e.get("ph") == "f"]
    assert {e["id"] for e in starts} == {e["id"] for e in finishes}
    assert len(starts) >= 3
    thread_names = {e["args"]["name"] for e in evs if e.get("ph") == "M"}
    assert {"stage profile (measured)",
            "stage profile (device counters)"} <= thread_names
    assert janalyze.check_file(str(tmp_path / "trace.rank0.json")) == []


def test_history_entry_carries_stages_block(profiled):
    prof, _ = profiled
    record = {"benchmark": "distributed_join", "n_ranks": 8,
              "build_table_nrows": 8000, "probe_table_nrows": 8000,
              "elapsed_per_join_s": 0.04, "stage_profile": prof.summary()}
    entry = thist.run_entry(record=record, platform="cpu")
    st = entry["stages"]
    assert set(st["wall_s"]) == set(stageprof.STAGE_KEYS)
    assert st["overlap_fraction"] == prof.summary()["overlap_fraction"]
    from distributed_join_tpu.telemetry import history as jhist
    assert jhist.stages_block(prof.summary()) == \
        thist.stages_block(prof.summary())


def test_stage_profile_spans_land_in_the_session(tables, tmp_path):
    b, p = tables
    with ttel.session(str(tmp_path), rank=0) as sink:
        stageprof.profile_join_stages(LocalCommunicator(), b, p, repeats=2,
                                      over_decomposition=2, **OPTS)
    names = [json.loads(ln)["name"] for ln in open(sink.events_path)
             if ln.strip()]
    for stage in ("partition", "shuffle", "join", "monolithic"):
        assert names.count(f"stage_profile.{stage}") == 2
