"""Counter signatures and a record's comparable wall time.

Port of the part of ``distributed_join_tpu/telemetry/baselines.py``
(:46-101) that :mod:`.history` reads: ``counter_signature``,
``_find_metrics`` and ``wall_time_of``. A record of a run with the
device metrics tape (``telemetry/metrics.py``) carries counters, and its
signature is theirs; a record without them has None, as a telemetry-off
JAX record does. The baseline registry (``write_baseline``) and the
``compare`` gate are not part of the port yet (ROADMAP A5b).
"""

from __future__ import annotations

from typing import Optional

SIGNATURE_SCHEMA_VERSION = 1


def counter_signature(source) -> Optional[dict]:
    """``{"signature_version", "n_ranks", "counters"}`` from whatever
    carries the device counters (a metrics dict, a session summary, a
    driver record, a signature), or None when nothing does."""
    m = _find_metrics(source)
    if m is None:
        return None
    if "signature_version" in m:  # already a signature
        return dict(m)
    return {
        "signature_version": SIGNATURE_SCHEMA_VERSION,
        "n_ranks": int(m.get("n_ranks", 0)),
        "counters": {k: int(v) for k, v in
                     sorted(m.get("reduced", {}).items())},
    }


def _find_metrics(source):
    if source is None:
        return None
    if hasattr(source, "to_dict"):
        source = source.to_dict()
    if not isinstance(source, dict):
        return None
    if "counters" in source and "signature_version" in source:
        return source                       # a signature / baseline body
    if "reduced" in source:
        return source                       # a metrics dict
    for key in ("counter_signature", "signature", "metrics",
                "telemetry"):
        found = _find_metrics(source.get(key))
        if found is not None:
            return found
    return None


def wall_time_of(record: Optional[dict]) -> Optional[float]:
    """The comparable wall number of a record, when one exists:
    ``elapsed_per_join_s`` (the join drivers), else
    ``elapsed_per_exchange_s`` (all_to_all)."""
    if not isinstance(record, dict) or record.get("proxy"):
        return None
    for key in ("elapsed_per_join_s", "elapsed_per_exchange_s"):
        v = record.get(key)
        if isinstance(v, (int, float)) and v > 0:
            return float(v)
    return None
