"""The workload identity the serving layer keys on.

Port of the part of ``distributed_join_tpu/planning/tuner.py`` that the
join service reads: ``workload_signature`` (:95-127). The autotuner
itself (``JoinTuner``, ``TunedConfig`` and the history-driven policies)
is not part of the port yet (ROADMAP A5c).
"""

from __future__ import annotations

import hashlib
import json


def workload_signature(comm, build, probe, key="key",
                       with_metrics=None, with_integrity: bool = False,
                       **opts) -> str:
    """The rung-stable workload identity (16 hex chars): the program
    cache's canonical signature digest over the tables and the caller's
    options, before the ladder resolves its sizing, so one workload keeps
    one identity across rungs. The service's live metrics, flight records
    and history lines key on it.

    ``with_metrics=None`` resolves from the telemetry session, as the
    program cache resolves it (JAX :95-127). An option set that
    does not resolve to a signature (an unknown option, a refused one, a
    malformed table) still gets an identity, the JAX package's sha256 of
    the key, the column names and the options, so the join's own refusal
    is what the caller sees."""
    if with_metrics is None:
        from distributed_join_tpu_torch import telemetry

        with_metrics = telemetry.enabled()
    try:
        from distributed_join_tpu_torch.service.programs import (
            JoinSignature,
        )

        return JoinSignature.of(
            comm, build, probe, key=key, with_metrics=with_metrics,
            with_integrity=with_integrity, **opts).digest()[:16]
    except Exception:
        basis = json.dumps(
            {"key": key,
             "build": sorted(build.columns),
             "probe": sorted(probe.columns),
             "opts": sorted((k, repr(v)) for k, v in opts.items())},
            sort_keys=True, default=str)
        return hashlib.sha256(basis.encode()).hexdigest()[:16]
