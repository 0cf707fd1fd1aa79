"""The port's cost model (planning/cost.py) against the JAX package's, on
the CPU.

Run on the JAX package's own constants (a port ``CostModel`` made from
``dataclasses.asdict`` of the JAX model), the port's arithmetic must give
the JAX package's seconds to the ninth digit: ``predict`` over the
port's and the JAX package's plans of the same call, ``predict_exchange``,
``resolve_dcn_codec``/``resolve_dcn_bits`` and both calibrations. The
port's own defaults are the H100's: none of them is a TPU number.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.planning import cost as jcost
from distributed_join_tpu.planning import plan as jplan
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
)
from distributed_join_tpu_torch.planning import cost as tcost
from distributed_join_tpu_torch.planning import plan as tplan
from distributed_join_tpu_torch.table import Table

PRICED = ("stages", "total_s", "predicted_rows_per_sec",
          "predicted_m_rows_per_sec_per_rank")


def _port_model(jmodel=None):
    return tcost.CostModel(**dataclasses.asdict(jmodel or jcost.CostModel()))


def _tables(rows_b: int, rows_p: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    cols_b = {"key": rng.integers(0, 1000, rows_b).astype(np.int64),
              "build_payload": rng.integers(0, 99, rows_b).astype(np.int64)}
    cols_p = {"key": rng.integers(0, 1000, rows_p).astype(np.int64),
              "probe_payload": rng.integers(0, 99, rows_p).astype(np.int64)}
    vb, vp = np.ones(rows_b, bool), np.ones(rows_p, bool)
    jt = tuple(JTable({k: jnp.asarray(v) for k, v in c.items()},
                      jnp.asarray(m)) for c, m in ((cols_b, vb), (cols_p, vp)))
    tt = tuple(Table.from_numpy(c, m, device="cpu")
               for c, m in ((cols_b, vb), (cols_p, vp)))
    return jt, tt


CASES = [
    dict(n=1),
    dict(n=4),
    dict(n=4, over_decomposition=4),
    dict(n=4, shuffle="ragged"),
    dict(n=4, compression_bits=16),
    dict(n=4, skew_threshold=0.01),
    dict(n=4, sort_mode="segmented", sort_segments=4),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="on"),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="off"),
]


def _comms(case):
    n, s = case.get("n", 4), case.get("slices", 1)
    if s > 1:
        return (jcomm.HierarchicalTpuCommunicator(n_slices=s, n_ranks=n),
                EmulatedCommunicator(n, n_slices=s))
    return jcomm.TpuCommunicator(n_ranks=n), EmulatedCommunicator(n)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_predict_on_jax_constants_equals_jax(case):
    opts = {k: v for k, v in case.items() if k not in ("n", "slices")}
    jc, tc = _comms(case)
    (jb, jp), (tb, tp) = _tables(4096, 8192)
    jp_ = jplan.build_plan(jc, jb, jp, with_metrics=False, **opts)
    tp_ = tplan.build_plan(tc, tb, tp, with_metrics=False, **opts)
    jm = jcost.CostModel()
    want = jcost.predict(jp_, jm)
    got = tcost.predict(tp_, _port_model(jm))
    for k in PRICED:
        assert got[k] == want[k], k
    assert got.get("shuffle_tiers") == want.get("shuffle_tiers")
    # the plans' own verdicts, each on its package's defaults, differ in
    # the constants only
    assert tp_.cost["platform"] == tcost.ROOFLINE_PLATFORM


def test_predict_probe_only_and_exchange_on_jax_constants():
    jc, tc = jcomm.TpuCommunicator(n_ranks=4), EmulatedCommunicator(4)
    (jb, jp), (tb, tp) = _tables(4096, 2048)
    jm = jcost.CostModel()
    want = jcost.predict(jplan.build_probe_plan(
        jc, jb, jp, with_metrics=False, over_decomposition=2), jm)
    got = tcost.predict(tplan.build_probe_plan(
        tc, tb, tp, with_metrics=False, over_decomposition=2),
        _port_model(jm))
    for k in PRICED:
        assert got[k] == want[k], k
    for n, nbytes in ((2, 1 << 20), (4, 64 << 20), (8, 12345)):
        w = jcost.predict_exchange(n, nbytes, jm)
        g = tcost.predict_exchange(n, nbytes, _port_model(jm))
        assert g["stages"] == w["stages"] and g["total_s"] == w["total_s"]
        assert g["predicted_aggregate_offchip_gb_per_sec"] == \
            w["predicted_aggregate_offchip_gb_per_sec"]


@pytest.mark.parametrize("knob", ["off", "auto", "on"])
@pytest.mark.parametrize("n_slices", [1, 2])
@pytest.mark.parametrize("bits", [None, 8])
def test_resolve_dcn_on_jax_constants_equals_jax(knob, n_slices, bits):
    jm = jcost.CostModel()
    assert tcost.resolve_dcn_codec(knob, _port_model(jm)) == \
        jcost.resolve_dcn_codec(knob, jm)
    assert tcost.resolve_dcn_bits(knob, bits, n_slices=n_slices,
                                  model=_port_model(jm)) == \
        jcost.resolve_dcn_bits(knob, bits, n_slices=n_slices, model=jm)


def test_resolve_dcn_refuses_unknown_knob_like_jax():
    for mod in (tcost, jcost):
        with pytest.raises(ValueError, match="dcn_codec"):
            mod.resolve_dcn_codec("sometimes")
        with pytest.raises(ValueError, match="dcn_codec"):
            mod.resolve_dcn_bits("sometimes", n_slices=1)


def _history(platform: str):
    ratios = [0.7, 1.9, 1.2, 3.3, 0.4]
    out = [{"prediction": {"wall_ratio": r}, "outcome": "ok",
            "platform": platform} for r in ratios]
    out += [{"prediction": {"wall_ratio": 9.0}, "outcome": "failed",
             "platform": platform},
            {"prediction": None, "outcome": "ok", "platform": platform},
            {"prediction": {"wall_ratio": 5.0}, "outcome": "ok",
             "platform": "other"}]
    return out


@pytest.mark.parametrize("min_entries", [3, 9])
def test_calibrate_from_history_on_jax_constants_equals_jax(min_entries):
    jm = jcost.CostModel()
    entries = _history("tpu")
    jgot, jrep = jcost.calibrate_from_history(
        entries, jm, min_entries=min_entries, platform="tpu")
    tgot, trep = tcost.calibrate_from_history(
        entries, _port_model(jm), min_entries=min_entries, platform="tpu")
    assert trep == jrep
    assert (tgot is None) == (jgot is None)
    if jgot is not None:
        assert dataclasses.asdict(tgot) == dataclasses.asdict(jgot)


def _profiles():
    def prof(stages, **kw):
        return {"kind": "stageprofile", "platform": "tpu",
                "stages": stages, **kw}

    flat = prof({"partition": {"ran": True, "predicted_s": 0.1,
                               "wall_s": 0.25},
                 "shuffle": {"ran": True, "predicted_s": 0.2,
                             "wall_s": 0.1},
                 "join": {"ran": True, "predicted_s": 0.3,
                          "wall_s": 0.9},
                 "skew": {"ran": False}})
    hier = prof({"shuffle": {"ran": True, "predicted_s": 0.5,
                             "wall_s": 2.0,
                             "counters": {"build.wire_bytes_dcn": 64}}})
    seg = prof({"join": {"ran": True, "predicted_s": 0.2, "wall_s": 0.3}},
               sort_segments=8)
    over = prof({"join": {"ran": True, "predicted_s": 1.0,
                          "wall_s": 50.0}}, overflow=True)
    return [flat, hier, seg, over]


@pytest.mark.parametrize("which", [slice(0, 1), slice(0, 4), slice(1, 3),
                                   slice(3, 4)])
def test_calibrate_from_stage_profile_on_jax_constants_equals_jax(which):
    jm = jcost.CostModel()
    profiles = _profiles()[which]
    jgot, jrep = jcost.calibrate_from_stage_profile(profiles, jm,
                                                    platform="tpu")
    tgot, trep = tcost.calibrate_from_stage_profile(
        profiles, _port_model(jm), platform="tpu")
    assert trep == jrep
    assert (tgot is None) == (jgot is None)
    if jgot is not None:
        assert dataclasses.asdict(tgot) == dataclasses.asdict(jgot)
    assert tcost.STAGE_CONSTANTS == jcost.STAGE_CONSTANTS


def test_port_defaults_are_the_cards_own():
    """No measured default is the JAX package's TPU number, the record
    keeps the JAX field names, and the one spec-derived bandwidth is
    marked so."""
    t, j = tcost.CostModel(), jcost.CostModel()
    assert set(dataclasses.asdict(t)) == set(dataclasses.asdict(j))
    prov = t.provenance
    assert prov["spec_derived"] == ["dcn_bytes_per_s"]
    for name in prov["measured"]:
        assert getattr(t, name) != getattr(j, name), name
    assert set(prov["measured"]) | set(prov["spec_derived"]) == {
        f for f in dataclasses.asdict(t)
        if f not in ("calibrated_scale", "calibrated_stage_scales")}
    assert "tpu" not in tcost.ROOFLINE_PLATFORM
    assert tcost.CODEC_BREAK_EVEN_BYTES_PER_S != \
        jcost.CODEC_BREAK_EVEN_BYTES_PER_S
    assert 80e9 < t.hbm_capacity_bytes < 96e9
    # the H100's links: NVLink above the codec's break-even, the tier
    # across nodes below it, so auto puts the codec on that tier alone
    assert t.ici_bytes_per_s > tcost.CODEC_BREAK_EVEN_BYTES_PER_S \
        > t.dcn_bytes_per_s
    assert tcost.resolve_dcn_codec("auto") is True
    assert tcost.resolve_dcn_bits("auto", n_slices=2) == \
        tcost.DEFAULT_DCN_CODEC_BITS
    assert tcost.resolve_dcn_bits("auto", n_slices=1) is None


def test_calibration_refuses_other_platforms_by_default():
    """The port's default calibration platform is its own stamp: CPU
    walls and the JAX package's TPU walls never refit the H100 model."""
    entries = [{"prediction": {"wall_ratio": 2.0}, "outcome": "ok",
                "platform": p} for p in ("tpu", "cpu", "tpu", "cpu")]
    model, rep = tcost.calibrate_from_history(entries)
    assert model is None and rep["n_eligible"] == 0
    entries = [dict(e, platform="cuda") for e in entries[:3]]
    model, rep = tcost.calibrate_from_history(entries)
    assert rep["calibrated"] and model.calibrated_scale == 2.0
    assert model.sort_ns_per_elem == 2.0 * tcost.CostModel().sort_ns_per_elem
