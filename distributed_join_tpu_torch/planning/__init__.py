"""Plan explain and the cost model of the port (port of
``distributed_join_tpu/planning/__init__.py``).

- :mod:`.plan` — :class:`JoinPlan`, :func:`build_plan`,
  :func:`explain_join`, :func:`build_probe_plan`,
  :func:`build_exchange_plan`: the resolved program (capacities, wire
  bytes, memory, the cache-key digest) from table shapes alone;
- :mod:`.cost` — :class:`CostModel`, :func:`predict`: per-stage wall
  seconds from per-primitive constants measured on an H100, refit by
  :func:`calibrate_from_history` and :func:`calibrate_from_stage_profile`;
- :mod:`.query` — the multi-operator query plans and
  :func:`explain_query`;
- :mod:`.tuner` — :class:`JoinTuner`, :class:`TunedConfig`,
  :func:`format_tune` and :func:`workload_signature`: the history-driven
  autotuner, which starts a repeat workload at the rung its ladder
  escalated to and fills structural knobs from evidence.
"""

from distributed_join_tpu_torch.planning.cost import (
    COST_MODEL_VERSION,
    DEFAULT_COST_MODEL,
    DEFAULT_PREDICTION_BAND,
    STAGE_CONSTANTS,
    CostModel,
    calibrate_from_history,
    calibrate_from_stage_profile,
    predict,
    predict_exchange,
)
from distributed_join_tpu_torch.planning.plan import (
    EXPLAIN_SCHEMA_VERSION,
    JoinPlan,
    SidePlan,
    abstract_tables,
    build_exchange_plan,
    build_plan,
    build_probe_plan,
    explain_join,
)
from distributed_join_tpu_torch.planning.query import (
    QUERY_SCHEMA_VERSION,
    QueryOp,
    QueryPlan,
    explain_query,
    tpch_query_plan,
)
from distributed_join_tpu_torch.planning.tuner import (
    TUNER_SCHEMA_VERSION,
    JoinTuner,
    TunedConfig,
    format_tune,
    workload_signature,
)

__all__ = [
    "COST_MODEL_VERSION",
    "DEFAULT_COST_MODEL",
    "DEFAULT_PREDICTION_BAND",
    "EXPLAIN_SCHEMA_VERSION",
    "QUERY_SCHEMA_VERSION",
    "STAGE_CONSTANTS",
    "TUNER_SCHEMA_VERSION",
    "CostModel",
    "JoinPlan",
    "JoinTuner",
    "QueryOp",
    "QueryPlan",
    "SidePlan",
    "TunedConfig",
    "abstract_tables",
    "build_exchange_plan",
    "build_plan",
    "build_probe_plan",
    "calibrate_from_history",
    "calibrate_from_stage_profile",
    "explain_join",
    "explain_query",
    "format_tune",
    "predict",
    "predict_exchange",
    "tpch_query_plan",
    "workload_signature",
]
