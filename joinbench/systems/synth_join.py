"""The synthetic distributed join (configuration ``system:
synth_join``): one rank a chip, each making its shard of the global
build and probe tables from ``(seed, rank)`` (``frozen/generators.py``),
joined by the port's ``parallel.distributed_join.distributed_inner_join``
over its communicator (NCCL between cards; the local one on one chip).

The build payloads: the frozen generator gives build row g the key g
and the payload g. The reference's driver pairs random unique keys with
sequential payloads, so a row's payload tells nothing of its key; here
each rank's payloads are its global row ids in an order drawn from
``(seed, rank)`` on a stream of their own. An output that puts the key
in a payload's place then fails the check.

The check: every sampled result's rows (the key and both payloads) are
sent to the rank that owns their probe row and compared there, as a
multiset, with the plain join of that rank's probe shard against every
rank's build shard, both made again from the seed; then the match total
and the overflow flag. The control joins on a 32-bit fingerprint of the
key instead of the key.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from joinbench.frozen.generators import build_shard, probe_shard, shard_seed
from joinbench.harness.collective import all_sum, exchange_rows
from joinbench.reference.compare import row_diff
from joinbench.reference.join import fingerprint32, inner_join

NAMES = ("key", "build_payload", "probe_payload")
KEY_COLS, PROBE_PAYLOADS, BUILD_PAYLOADS = 1, 1, 1


class System:
    # What this adapter reads of its configuration and traffic files
    # (``spec.refuse_unread``), each key with the one value it runs where
    # it runs only one.
    CONFIG_KEYS = {"build_rows_per_gpu": None, "probe_rows_per_gpu": None,
                   "key_type": "int64", "payload_type": "int64",
                   "selectivity": None, "unique_build_keys": True,
                   "over_decomposition_factor": None, "communicator": None,
                   "rand_max": None, "shuffle": None}
    TRAFFIC_KEYS = {"auto_retry": None}

    def __init__(self, config: dict, traffic: dict, ctx):
        self.config, self.traffic, self.ctx = config, traffic, ctx
        self.b_rows = int(config["build_rows_per_gpu"])
        self.p_rows = int(config["probe_rows_per_gpu"])
        self.rand_max = int(config.get("rand_max")
                            or self.b_rows * ctx.world)
        self.rows_per_op = ctx.world * (self.b_rows + self.p_rows)
        self.comm = self.build = self.probe = None
        self._ref = None

    # -- the inputs --------------------------------------------------

    def _shard(self, seed: int, rank: int, probe: bool = True):
        c, dev = self.config, self.ctx.device
        g = torch.Generator(device=dev)
        g.manual_seed(shard_seed(seed, rank))
        build = build_shard(rank, self.ctx.world, self.b_rows, self.rand_max,
                            g, bool(c["unique_build_keys"]))
        pg = torch.Generator(device=dev)
        pg.manual_seed(shard_seed(seed, rank, stream=1))
        build["build_payload"] = rank * self.b_rows + torch.randperm(
            self.b_rows, generator=pg, device=dev)
        if not probe:
            return build, None
        return build, probe_shard(
            rank, self.ctx.world, self.p_rows, self.b_rows, self.rand_max,
            float(c["selectivity"]), g, bool(c["unique_build_keys"]))

    def setup(self, seed: int) -> None:
        from distributed_join_tpu_torch.parallel.communicator import (
            LocalCommunicator,
            make_communicator,
        )
        from distributed_join_tpu_torch.table import Table

        ctx = self.ctx
        if ctx.distributed and dist.get_backend() != self.config[
                "communicator"]:
            raise ValueError(f"the configuration states the "
                             f"{self.config['communicator']} communicator; "
                             f"the group is {dist.get_backend()}")
        self.comm = (make_communicator(dist.get_backend(), n_ranks=ctx.world)
                     if ctx.distributed else LocalCommunicator())
        build, probe = self._shard(seed, ctx.rank)
        self.build, self.probe = Table.from_dense(build), Table.from_dense(probe)

    # -- one operation -----------------------------------------------

    def op(self):
        from distributed_join_tpu_torch.parallel.distributed_join import (
            distributed_inner_join,
        )

        c = self.config
        return distributed_inner_join(
            self.build, self.probe, self.comm, key="key",
            auto_retry=int(self.traffic["auto_retry"]), local_inputs=True,
            with_metrics=False, shuffle=c["shuffle"],
            over_decomposition=int(c["over_decomposition_factor"]))

    @staticmethod
    def outcome(res) -> tuple:
        return bool(res.overflow), res.retry_report.n_attempts - 1

    @staticmethod
    def keep(res) -> dict:
        t = res.table
        return {"rows": {n: t.columns[n][t.valid] for n in NAMES},
                "total": int(res.total), "overflow": bool(res.overflow)}

    def release(self) -> None:
        self.build = self.probe = None

    # -- the reference -----------------------------------------------

    def _joined(self, seed: int, match_key=None) -> dict:
        """This rank's probe shard joined with every rank's build shard."""
        ctx = self.ctx
        builds = [self._shard(seed, r, probe=False)[0]
                  for r in range(ctx.world)]
        bk = torch.cat([b["key"] for b in builds])
        bp = torch.cat([b["build_payload"] for b in builds])
        del builds
        probe = self._shard(seed, ctx.rank)[1]
        return inner_join(bk, {"build_payload": bp}, probe["key"],
                          {"probe_payload": probe["probe_payload"]},
                          match_key=match_key)

    def _owner(self, rows: dict) -> torch.Tensor:
        return rows["probe_payload"] // self.p_rows

    def check(self, kept: list, seed: int) -> tuple:
        ref = self._joined(seed)
        ref_total = all_sum(self.ctx, [ref["key"].shape[0]])[0]
        missing = extra = gap = overflow = 0
        for k in kept:
            got = exchange_rows(self.ctx, k["rows"], self._owner(k["rows"]))
            d = row_diff(got, ref, NAMES)
            m, e = all_sum(self.ctx, [d["missing"], d["extra"]])
            missing, extra = missing + m, extra + e
            gap += abs(k["total"] - ref_total)
            overflow += int(k["overflow"])
        numbers = {"rows_missing": (missing, 0), "rows_extra": (extra, 0),
                   "total_gap": (gap, 0), "overflowed": (overflow, 0)}
        return numbers, self._work(ref, ref_total)

    def _work(self, ref: dict, ref_total: int) -> dict:
        """One join's work: the merged positions (every valid row), the
        probe rows with a match (records), the build rows with a match,
        and the output rows."""
        records_local = int(torch.unique(ref["probe_payload"]).shape[0])
        bp = ref["build_payload"]
        owned = exchange_rows(self.ctx, {"b": bp}, bp // self.b_rows)["b"]
        records, builds = all_sum(
            self.ctx, [records_local, torch.unique(owned).shape[0]])
        positions = self.rows_per_op
        kk, kb = KEY_COLS + PROBE_PAYLOADS, BUILD_PAYLOADS
        return {
            "scan_positions": positions,
            "compact_positions": 2 * positions,
            "compact_kept_words": records * (2 + kk) + builds * kb,
            "expand_records": records,
            "expand_record_words": records * kk,
            "expand_build_words": builds * kb,
            "expand_out_words": ref_total * (kk + kb),
            "expand_rows": ref_total,
        }

    def control(self, seed: int) -> dict:
        rows = self._joined(seed, match_key=fingerprint32)
        total = all_sum(self.ctx, [rows["key"].shape[0]])[0]
        return {"rows": {n: rows[n] for n in NAMES}, "total": total,
                "overflow": False}
