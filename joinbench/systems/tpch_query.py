"""A TPC-H query on one chip (configuration ``system: tpch_query``):
``customer``, ``orders`` and ``lineitem`` made on the card from the seed
(``frozen/tpch.py``), filtered by the query's predicates, and run by the
port's ``parallel.query_exec.distributed_query`` over its
``planning.query.tpch_query_plan`` and the local communicator, with a
``service.programs.JoinProgramCache``.

The check: every sampled result's groups (the key, revenue, line count
and carried column) are compared, as a multiset, with the plain
reference's (``reference/query.py``) over the same tables made again
from the seed; then the would-be join rows (the result's total) and the
overflow flag. The control sums revenue in float32.
"""

from __future__ import annotations

from joinbench.frozen.generators import shard_seed
from joinbench.frozen.tpch import generate_query_tables, query_filters
from joinbench.reference.compare import row_diff
from joinbench.reference.query import CARRY, GROUP, query_reference

# The columns the first join needs: the key and what the rest of the
# query reads of each side (orders' orderkey and o_orderdate; nothing
# of customer).
J1_PROBE_COLS = 2
J1_BUILD_COLS = 0
GROUP_LANES = 4          # the key, revenue, count and carry of a group


class System:
    # What this adapter reads of its configuration and traffic files
    # (``spec.refuse_unread``), each key with the one value it runs where
    # it runs only one.
    CONFIG_KEYS = {"scale_factor": None, "cutoff_day": None,
                   "market_segment": None, "columns": None}
    TRAFFIC_KEYS = {"auto_retry": None, "query": "q3"}

    def __init__(self, config: dict, traffic: dict, ctx):
        if ctx.world != 1:
            raise ValueError("tpch_query runs on one chip")
        self.config, self.traffic, self.ctx = config, traffic, ctx
        self.query = traffic["query"]
        self.names = (GROUP, "revenue", "n_lines", CARRY)
        self.tables = self.plan = self.comm = self.cache = None
        self.rows_per_op = 0

    def _tables(self, seed: int) -> dict:
        c = self.config
        tables = generate_query_tables(shard_seed(seed, 0),
                                       float(c["scale_factor"]),
                                       self.ctx.device)
        made = {n: list(cols) for n, (cols, _) in tables.items()}
        if made != c["columns"]:
            raise ValueError(f"the generator makes the columns {made}, "
                             f"the configuration states {c['columns']}")
        return query_filters(tables, self.query,
                             cutoff_day=int(c["cutoff_day"]),
                             segment=int(c["market_segment"]))

    def setup(self, seed: int) -> None:
        from distributed_join_tpu_torch.parallel.communicator import (
            LocalCommunicator,
        )
        from distributed_join_tpu_torch.planning.query import tpch_query_plan
        from distributed_join_tpu_torch.service.programs import (
            JoinProgramCache,
        )
        from distributed_join_tpu_torch.table import Table

        self.comm = LocalCommunicator()
        self.cache = JoinProgramCache(self.comm)
        self.plan = tpch_query_plan(self.query)
        self.tables = {name: Table(dict(cols), valid)
                       for name, (cols, valid) in self._tables(seed).items()}
        self.rows_per_op = sum(t.capacity for t in self.tables.values())

    def op(self):
        from distributed_join_tpu_torch.parallel.query_exec import (
            distributed_query,
        )

        return distributed_query(
            self.tables, self.plan, self.comm,
            auto_retry=int(self.traffic["auto_retry"]),
            program_cache=self.cache, with_metrics=False)

    @staticmethod
    def outcome(res) -> tuple:
        return bool(res.overflow), int(res.retry_attempts)

    def keep(self, res) -> dict:
        t = res.table
        return {"rows": {n: t.columns[n][t.valid] for n in self.names},
                "total": int(res.total), "overflow": bool(res.overflow)}

    def release(self) -> None:
        self.tables = self.cache = None

    def _reference_rows(self, ref: dict) -> dict:
        g = ref["groups"]
        key, _, _, carry = self.names
        return {key: g["key"], "revenue": g["revenue"],
                "n_lines": g["n_lines"], carry: g["carry"]}

    def check(self, kept: list, seed: int) -> tuple:
        tables = self._tables(seed)
        ref = query_reference(tables, self.query)
        want = self._reference_rows(ref)
        missing = extra = gap = overflow = 0
        for k in kept:
            d = row_diff(k["rows"], want, self.names)
            missing, extra = missing + d["missing"], extra + d["extra"]
            gap += abs(k["total"] - ref["j2_rows"])
            overflow += int(k["overflow"])
        numbers = {"groups_missing": (missing, 0),
                   "groups_extra": (extra, 0),
                   "total_gap": (gap, 0), "overflowed": (overflow, 0)}
        return numbers, self._work(tables, ref)

    def _work(self, tables: dict, ref: dict) -> dict:
        """One query's work: the first join materialised (its merged
        positions, its records and matched builds, its rows), and the
        fused aggregate's group compaction over the second join's
        positions."""
        valid = {n: int(v.sum()) for n, (_, v) in tables.items()}
        pos1 = valid["customer"] + valid["orders"]
        rec1, nm1 = ref["j1_rows"], ref["j1_builds"]
        kk, kb = 1 + J1_PROBE_COLS, J1_BUILD_COLS
        pos2 = ref["j1_rows"] + valid["lineitem"]
        groups = int(ref["groups"]["key"].shape[0])
        return {
            "scan_positions": pos1,
            "compact_positions": pos1 * (2 if kb else 1) + pos2,
            "compact_kept_words": (rec1 * (2 + kk) + nm1 * kb
                                   + groups * GROUP_LANES),
            "expand_records": rec1,
            "expand_record_words": rec1 * kk,
            "expand_build_words": nm1 * kb,
            "expand_out_words": rec1 * (kk + kb),
            "expand_rows": rec1,
        }

    def control(self, seed: int) -> dict:
        ref = query_reference(self._tables(seed), self.query,
                              float32_sums=True)
        return {"rows": self._reference_rows(ref), "total": ref["j2_rows"],
                "overflow": False}
