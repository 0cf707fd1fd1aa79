"""Counter-signature baselines: the deterministic regression gate.

Port of ``distributed_join_tpu/telemetry/baselines.py``, with the JAX
package's names, record keys and exit semantics: ``counter_signature``,
``_find_metrics``, ``wall_time_of``, the registry (``baseline_path``,
``load_baseline``, ``write_baseline``, ``_config_of``) and the gate
(``Comparison``, ``compare``).

A *counter signature* is the device metrics tape's reduced block
(``telemetry/metrics.py``: rows partitioned, shuffled and received, wire
bytes, overflow margins, matches) plus the rank count. The counters are
integer arithmetic over a seeded workload, the same on every run of the
same configuration, so the gate has two layers:

1. **signature drift**: any counter that differs from the baseline's
   fails, exactly (there is no noise to band). An intended change
   re-baselines with ``analyze compare --write``, and the diff of the
   committed file shows it.
2. **wall-time regression**: only when both the baseline and the run
   carry a real timing, within a relative noise band (default ±25 %).
   A wall measured on the CPU is ``null`` in a baseline, as in the JAX
   package: it times the host's emulation of the ranks, not the card,
   so only a baseline written ``--with-wall`` from a run on the card
   gates a wall time.

Baseline files live under ``results/baselines_torch/<name>.json``. The
JAX package's committed files stay in ``results/baselines/``, which this
module reads (``load_baseline("name", "results/baselines")``) but never
writes by default. The port's generators draw other bits than the JAX
package's, and other bits on a card than on the CPU, so the port's own
smokes gate against the port's own files, drawn where the smoke runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

SIGNATURE_SCHEMA_VERSION = 1
DEFAULT_BASELINE_DIR = os.path.join("results", "baselines_torch")
DEFAULT_NOISE_BAND = 0.25


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


# -- registry ---------------------------------------------------------


def baseline_path(name: str, baseline_dir: Optional[str] = None) -> str:
    """A baseline name (or an explicit ``.json`` path) inside the
    registry directory."""
    if name.endswith(".json"):
        if os.sep in name or os.path.exists(name):
            return name
        name = name[: -len(".json")]   # a registry name typed with .json
    return os.path.join(baseline_dir or DEFAULT_BASELINE_DIR,
                        f"{name}.json")


def load_baseline(name: str, baseline_dir: Optional[str] = None) -> dict:
    path = baseline_path(name, baseline_dir)
    with open(path) as f:
        baseline = json.load(f)
    if "signature" not in baseline:
        raise ValueError(f"{path}: not a baseline file (no 'signature')")
    return baseline


def write_baseline(name: str, source, *,
                   baseline_dir: Optional[str] = None,
                   record: Optional[dict] = None,
                   with_wall: bool = False,
                   note: Optional[str] = None) -> str:
    """Create or overwrite ``<dir>/<name>.json`` from a signature source.
    ``with_wall`` also stores the record's wall time (runs on the card
    only: a CPU wall would gate the host's noise)."""
    sig = counter_signature(source)
    if sig is None:
        raise ValueError("source carries no device counters — run with "
                         "--telemetry so the metrics block is recorded")
    d = baseline_dir or DEFAULT_BASELINE_DIR
    os.makedirs(d, exist_ok=True)
    path = baseline_path(name, d)
    baseline = {
        "name": os.path.basename(name),
        "created_unix_s": time.time(),
        "signature": sig,
        "wall_time_s": wall_time_of(record) if with_wall else None,
        "noise_band": DEFAULT_NOISE_BAND,
        "note": note,
        "config": _config_of(record),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(baseline, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def _config_of(record: Optional[dict]) -> Optional[dict]:
    """The workload-identifying subset of a driver record: context for
    whoever reviews a re-baseline diff, not part of the gate. The
    port's records add ``platform``, the device type the counters were
    drawn on."""
    if not isinstance(record, dict):
        return None
    keys = ("benchmark", "communicator", "n_ranks", "key_type",
            "payload_type", "build_table_nrows", "probe_table_nrows",
            "selectivity", "shuffle", "over_decomposition_factor",
            "zipf_alpha", "skew_threshold", "scale_factor", "batches",
            "compression_bits", "key_columns", "string_payload_bytes",
            "platform")
    cfg = {k: record[k] for k in keys if k in record}
    return cfg or None


# -- comparison -------------------------------------------------------


@dataclasses.dataclass
class Comparison:
    """The compare verdict: exact counter drift and an optional banded
    wall check. ``ok`` is the gate (the CLI's exit code)."""

    baseline_name: str
    drifted: dict           # name -> {"baseline": int, "current": int}
    missing: list           # counters in the baseline, absent from the run
    extra: list             # counters in the run, absent from the baseline
    wall: Optional[dict]    # {"baseline_s", "current_s", "ratio", ...}

    @property
    def signature_ok(self) -> bool:
        return not (self.drifted or self.missing)

    @property
    def wall_ok(self) -> bool:
        return self.wall is None or not self.wall["regressed"]

    @property
    def ok(self) -> bool:
        return self.signature_ok and self.wall_ok

    def as_record(self) -> dict:
        return {
            "baseline": self.baseline_name,
            "ok": self.ok,
            "signature_ok": self.signature_ok,
            "drifted": self.drifted,
            "missing": self.missing,
            "extra": self.extra,
            "wall": self.wall,
        }

    def format(self) -> str:
        lines = [f"baseline {self.baseline_name}: "
                 + ("OK" if self.ok else "FAIL")]
        for name, d in sorted(self.drifted.items()):
            lines.append(f"  DRIFT {name}: baseline {d['baseline']} "
                         f"-> current {d['current']}")
        for name in self.missing:
            lines.append(f"  MISSING counter {name} (in baseline, "
                         "not in run)")
        for name in self.extra:
            lines.append(f"  note: new counter {name} not in baseline "
                         "(not gated; re-baseline to adopt)")
        if self.wall is not None:
            w = self.wall
            lines.append(
                f"  wall: {w['current_s']:.6g}s vs baseline "
                f"{w['baseline_s']:.6g}s (x{w['ratio']:.3f}, band "
                f"±{w['noise_band']:.0%})"
                + (" REGRESSED" if w["regressed"] else ""))
        return "\n".join(lines)


def compare(baseline: dict, source, *,
            record: Optional[dict] = None,
            noise_band: Optional[float] = None) -> Comparison:
    """Gate ``source``'s signature (and, when both sides carry one, its
    wall time) against a loaded baseline. Counters the baseline predates
    are reported but do not fail (adding a counter must not break every
    committed baseline); a removed counter and any changed value
    fail."""
    sig = counter_signature(source)
    if sig is None:
        raise ValueError("run carries no device counters to compare "
                         "(was it run with --telemetry?)")
    want = dict(baseline["signature"].get("counters", {}))
    want["n_ranks"] = baseline["signature"].get("n_ranks")
    got = dict(sig.get("counters", {}))
    got["n_ranks"] = sig.get("n_ranks")
    drifted, missing = {}, []
    for name, b in want.items():
        if name not in got:
            missing.append(name)
        elif got[name] != b:
            drifted[name] = {"baseline": b, "current": got[name]}
    extra = sorted(set(got) - set(want))

    wall = None
    base_wall = baseline.get("wall_time_s")
    cur_wall = wall_time_of(record)
    if base_wall and cur_wall:
        band = (noise_band if noise_band is not None
                else baseline.get("noise_band", DEFAULT_NOISE_BAND))
        ratio = cur_wall / base_wall
        wall = {
            "baseline_s": base_wall,
            "current_s": cur_wall,
            "ratio": ratio,
            "noise_band": band,
            "regressed": ratio > 1.0 + band,
        }
    return Comparison(
        baseline_name=baseline.get("name", "?"),
        drifted=drifted, missing=missing, extra=extra, wall=wall,
    )
