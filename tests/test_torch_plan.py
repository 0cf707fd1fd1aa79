"""The port's plans (planning/plan.py) against the JAX package's live
ones, on the CPU.

The same call (tables made from a numpy seed, the same options) goes
through ``build_plan``, ``explain_join``, ``build_probe_plan`` and
``build_exchange_plan`` of both packages, on the port's emulated ranks
and the JAX package's CPU mesh. Every record field is held equal:
capacities, the wire bytes a side and a tier, the memory footprint, the
schemas and the resolved options. Two fields differ by design: the
digest (the port's program-cache key, not the JAX package's) and the
cost block (the H100's constants; ``tests/test_torch_cost.py`` holds the
arithmetic on the JAX package's constants). The port's digest equals its
own program cache's key of the same call. The port's plans are priced
on the JAX package's constants here, so the memory verdict (which reads
the card's capacity from the model) is held equal too.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.ops import aggregate as ja
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.planning import cost as jcost
from distributed_join_tpu.planning import plan as jplan
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch.ops import aggregate as ta
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.planning import cost as tcost
from distributed_join_tpu_torch.planning import plan as tplan
from distributed_join_tpu_torch.service.programs import JoinProgramCache
from distributed_join_tpu_torch.table import Table

ROWS_B, ROWS_P = 2048, 4096
# the JAX package's constants in the port's model
JAX_MODEL = tcost.CostModel(**dataclasses.asdict(jcost.CostModel()))
PRICED = ("stages", "total_s", "predicted_rows_per_sec")


def _tables(kind: str, seed: int = 7):
    """``((jax build, jax probe), (port build, port probe), key)`` of one
    key kind, made from one numpy seed."""
    rng = np.random.default_rng(seed)

    def side(rows, payload, ptype):
        cols = {}
        if kind in ("int32", "int64", "float64"):
            cols["key"] = rng.integers(0, 60_000, rows).astype(kind)
            key = "key"
        elif kind == "composite":
            cols["k0"] = rng.integers(0, 20, rows).astype(np.int64)
            cols["k1"] = rng.integers(0, 30, rows).astype(np.int64)
            key = ["k0", "k1"]
        else:  # a 16-byte string key with its length
            lens = rng.integers(1, 17, rows).astype(np.int32)
            b = rng.integers(32, 127, (rows, 16)).astype(np.uint8)
            b[np.arange(16)[None, :] >= lens[:, None]] = 0
            cols["skey"], cols["skey#len"] = b, lens
            key = "skey"
        cols[payload] = rng.integers(0, 9, rows).astype(np.int64)
        if ptype is not None:
            cols[payload + "_x"] = rng.random(rows).astype(ptype)
        return cols, np.ones(rows, bool), key

    (cb, vb, key), (cp, vp, _) = (side(ROWS_B, "build_payload", None),
                                  side(ROWS_P, "probe_payload", np.float64))
    jt = tuple(JTable({k: jnp.asarray(v) for k, v in c.items()},
                      jnp.asarray(m)) for c, m in ((cb, vb), (cp, vp)))
    tt = tuple(Table.from_numpy(c, m, device="cpu")
               for c, m in ((cb, vb), (cp, vp)))
    return jt, tt, key


def _comms(n: int, slices: int = 1):
    if slices > 1:
        return (jcomm.HierarchicalTpuCommunicator(n_slices=slices, n_ranks=n),
                EmulatedCommunicator(n, n_slices=slices))
    if n == 1:
        return jcomm.TpuCommunicator(n_ranks=1), LocalCommunicator()
    return jcomm.TpuCommunicator(n_ranks=n), EmulatedCommunicator(n)


def _comparable(record: dict) -> dict:
    rec = json.loads(json.dumps(record, sort_keys=True, default=str))
    rec.pop("signature_digest", None)
    return rec


def _agg(mod, kind):
    if kind == "key":
        return mod.AggregateSpec.of("key", [("count", None, "n"),
                                            ("sum", "probe_payload", "s")])
    return mod.AggregateSpec.of("probe_payload", [("count", None, "n"),
                                                  ("max", "build_payload",
                                                   "m")])


GRID = [
    dict(n=1),
    dict(n=4),
    dict(n=4, shuffle="ppermute"),
    dict(n=4, shuffle="ragged"),
    dict(n=4, shuffle="ragged", kind="string"),
    dict(n=4, compression_bits=16),
    dict(n=4, shuffle="ppermute", compression_bits=16),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="off"),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="on"),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="on",
         compression_bits=8),
    dict(n=4, shuffle="hierarchical"),
    dict(n=4, sort_mode="segmented", sort_segments=4),
    dict(n=4, sort_mode="segmented", sort_segments=4, over_decomposition=4),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="off",
         sort_mode="segmented", sort_segments=2),
    dict(n=4, over_decomposition=4),
    dict(n=1, over_decomposition=4),
    dict(n=4, skew_threshold=0.01),
    dict(n=4, skew_threshold=0.01, hh_slots=8, hh_out_capacity=4096),
    dict(n=4, kind="int32"),
    dict(n=4, kind="float64"),
    dict(n=4, kind="composite"),
    dict(n=4, kind="string"),
    dict(n=4, kind="string", over_decomposition=2),
    dict(n=4, join_type="left"),
    dict(n=4, join_type="full_outer"),
    dict(n=4, join_type="semi"),
    dict(n=4, join_type="anti", over_decomposition=2),
    dict(n=4, out_rows_per_rank=3000),
    dict(n=4, shuffle_capacity_factor=2.5, out_capacity_factor=0.7),
    dict(n=4, agg="key"),
    dict(n=4, agg="probe"),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="off", agg="probe"),
]


def _split(case):
    opts = {k: v for k, v in case.items()
            if k not in ("n", "slices", "kind", "agg")}
    return (case.get("n", 4), case.get("slices", 1),
            case.get("kind", "int64"), case.get("agg"), opts)


@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_build_plan_equals_jax(case):
    n, slices, kind, agg, opts = _split(case)
    jc, tc = _comms(n, slices)
    (jb, jp), (tb, tp), key = _tables(kind)
    jopts, topts = dict(opts), dict(opts)
    if agg is not None:
        jopts["aggregate"], topts["aggregate"] = _agg(ja, agg), _agg(ta, agg)
    want = jplan.build_plan(jc, jb, jp, key=key, with_metrics=False, **jopts)
    got = tplan.build_plan(tc, tb, tp, key=key, with_metrics=False,
                           cost_model=JAX_MODEL, **topts)
    assert _comparable(got.as_record()) == _comparable(want.as_record())
    assert got.wire == want.wire and got.memory == want.memory
    assert got.capacities == want.capacities
    for k in PRICED:
        assert got.cost[k] == want.cost[k], k
    # the plan is the cache key of the same call
    cache = JoinProgramCache(tc)
    assert got.digest == cache.signature(tb, tp, key=key,
                                         with_metrics=False,
                                         **topts).digest()
    assert got.format().startswith(f"plan {got.digest[:16]}")


@pytest.mark.parametrize("case", [
    dict(n=4), dict(n=4, over_decomposition=2, auto_retry=2),
    dict(n=4, shuffle="ragged"), dict(n=4, skew_threshold=0.01),
    dict(n=4, slices=2, shuffle="hierarchical", dcn_codec="on"),
    dict(n=1),
], ids=str)
def test_explain_join_equals_jax_and_digest_is_the_run_key(case):
    """``explain_join`` runs the ladder's first rung dry; its record
    equals the JAX package's, and its digest is the key the port's
    cached ``distributed_inner_join`` dispatches under, which attaches
    the same plan (``explain=True``)."""
    n, slices, kind, _, opts = _split(case)
    auto_retry = opts.pop("auto_retry", 0)
    jc, tc = _comms(n, slices)
    (jb, jp), (tb, tp), key = _tables(kind)
    want = jplan.explain_join(jb, jp, jc, key=key, with_metrics=False,
                              **opts)
    got = tplan.explain_join(tb, tp, tc, key=key, with_metrics=False,
                             cost_model=JAX_MODEL, **opts)
    assert _comparable(got.as_record()) == _comparable(want.as_record())
    cache = JoinProgramCache(tc)
    res = tdist.distributed_inner_join(
        tb, tp, tc, key=key, auto_retry=auto_retry, program_cache=cache,
        explain=True, with_metrics=False, out_capacity_factor=4.0, **opts)
    assert not bool(res.overflow)
    ran = tplan.explain_join(tb, tp, tc, key=key, with_metrics=False,
                             out_capacity_factor=4.0, **opts)
    assert res.plan.digest == ran.digest
    assert cache.predict_hit(ran.digest)["resident"]
    assert res.plan.explain_record() == ran.explain_record()


def test_explain_record_is_byte_deterministic():
    (_, _), (tb, tp), key = _tables("int64")
    tc = EmulatedCommunicator(4)
    docs = [json.dumps(tplan.explain_join(tb, tp, tc, key=key,
                                          over_decomposition=2)
                       .explain_record(), sort_keys=True)
            for _ in range(3)]
    # the meta tables of the same shapes give the same bytes
    mb, mp = (tplan.abstract_table(tplan.column_schema(t), t.capacity)
              for t in (tb, tp))
    docs.append(json.dumps(tplan.explain_join(
        mb, mp, tc, key=key, over_decomposition=2).explain_record(),
        sort_keys=True))
    assert len(set(docs)) == 1
    assert "timestamp" not in docs[0] and '"kind": "explain"' in docs[0]


@pytest.mark.parametrize("case", [
    dict(n=4), dict(n=4, over_decomposition=2), dict(n=4, shuffle="ragged"),
    dict(n=4, compression_bits=16), dict(n=1), dict(n=4, agg="key"),
    dict(n=4, agg="probe"),
], ids=str)
def test_build_probe_plan_equals_jax(case):
    n, slices, kind, agg, opts = _split(case)
    jc, tc = _comms(n, slices)
    (jb, jp), (tb, tp), key = _tables(kind)
    jopts, topts = dict(opts), dict(opts)
    if agg is not None:
        jopts["aggregate"], topts["aggregate"] = _agg(ja, agg), _agg(ta, agg)
    want = jplan.build_probe_plan(jc, jb, jp, key=key, with_metrics=False,
                                  **jopts)
    got = tplan.build_probe_plan(tc, tb, tp, key=key, with_metrics=False,
                                 cost_model=JAX_MODEL, **topts)
    assert _comparable(got.as_record()) == _comparable(want.as_record())
    for k in PRICED:
        assert got.cost[k] == want.cost[k], k


@pytest.mark.parametrize("n, nbytes", [(2, 1 << 20), (4, 256 << 20),
                                       (8, 4096)])
def test_build_exchange_plan_equals_jax(n, nbytes):
    want = jplan.build_exchange_plan(n, nbytes)
    got = tplan.build_exchange_plan(n, nbytes)
    assert got["plan"] == want["plan"]
    assert got["schema_version"] == want["schema_version"]
    assert got["cost"]["stages"].keys() == want["cost"]["stages"].keys()


def test_plan_refusals_match_the_step():
    (_, _), (tb, tp), key = _tables("int64")
    tc = EmulatedCommunicator(4)
    for opts, err in ((dict(shuffle="bogus"), ValueError),
                      (dict(shuffle="ragged", compression_bits=16),
                       ValueError),
                      (dict(sort_segments=4), ValueError),
                      (dict(dcn_codec="sometimes"), ValueError),
                      (dict(not_an_option=1), TypeError)):
        with pytest.raises(err):
            tplan.build_plan(tc, tb, tp, key=key, **opts)
        with pytest.raises(err):
            tdist.make_join_step(tc, key=key, **opts)
    # the integrity switch is ported: it enters the plan and its digest,
    # which stays the program cache's key for the same call
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    plan = tplan.build_plan(tc, tb, tp, key=key, with_integrity=True)
    assert plan.with_integrity
    assert plan.digest == JoinProgramCache(tc).signature(
        tb, tp, key=key, with_integrity=True).digest()
    assert plan.digest != tplan.build_plan(tc, tb, tp, key=key).digest
    tdist.make_join_step(tc, key=key, with_integrity=True)
    verified = tplan.explain_join(tb, tp, tc, verify_integrity=True)
    assert verified.with_integrity
    assert verified.digest != tplan.explain_join(tb, tp, tc).digest
    hier = EmulatedCommunicator(4, n_slices=2)
    with pytest.raises(ValueError, match="hierarchical"):
        tplan.build_plan(hier, tb, tp, key=key, shuffle="padded")


def test_plan_capacities_come_from_the_step():
    """The plan's capacities are the step's own arithmetic: the probe
    side's and the output block are ``resolve_probe_capacities``'."""
    (_, _), (tb, tp), key = _tables("int64")
    for n, k, f, o in ((4, 1, 1.6, 1.2), (4, 3, 2.0, 0.5), (1, 2, 1.1, 3.0)):
        tc = EmulatedCommunicator(n) if n > 1 else LocalCommunicator()
        plan = tplan.build_plan(tc, tb, tp, key=key, over_decomposition=k,
                                shuffle_capacity_factor=f,
                                out_capacity_factor=o)
        p_cap, out_cap = tdist.resolve_probe_capacities(
            ROWS_P // n, n, k, f, o, None)
        b_cap, _ = tdist.resolve_probe_capacities(ROWS_B // n, n, k, f, o,
                                                  None)
        c = plan.capacities
        assert (c["shuffle_build_per_bucket"], c["shuffle_probe_per_bucket"],
                c["out_rows_per_batch"]) == (b_cap, p_cap, out_cap)
