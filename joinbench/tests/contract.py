"""The benchmark contract as checks the tests run: ``BENCHMARK.json``'s
shape, names, units and bounds, and a result line's keys."""

import re
from pathlib import Path

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text(s, limit=200) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s \
        and "\t" not in s


def benchmark_problems(doc: dict, root: Path) -> list:
    """What in ``doc`` (``BENCHMARK.json``) breaks the contract."""
    bad = []
    if set(doc) != TOP_KEYS:
        bad.append(f"top-level keys {sorted(doc)}")
    paths = doc["paths"]
    if not (1 <= len(paths) <= 16) or not all(
            PATH_RE.match(p) and not p.startswith("/") and ".." not in p
            for p in paths):
        bad.append(f"paths {paths}")
    cmd = doc["command"]
    if not (1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)):
        bad.append("command")
    for w in cmd[1:]:
        if "/" in w and not any(w.startswith(p + "/") for p in paths):
            bad.append(f"command names {w} outside paths")
    if not (isinstance(doc["run_seconds"], int)
            and 1 <= doc["run_seconds"] <= 51):
        bad.append("run_seconds")
    n = len(doc["workloads"])
    total = 2 + 14 * 24
    if total * (doc["run_seconds"] + 60) + 24 * 180 + 1200 > 43200:
        bad.append("run_seconds does not fit 24 cells")
    names = []
    for c in doc["configs"]:
        names.append(c["name"])
        if set(c) != CONFIG_KEYS:
            bad.append(f"config keys {sorted(c)}")
        if not (_text(c["source"]) and _text(c["why"])):
            bad.append(f"config {c['name']} text")
        if not any(c["file"].startswith(p + "/") for p in paths) or \
                not (Path(root) / c["file"]).is_file():
            bad.append(f"config file {c['file']}")
        if len(c["reduced"]) > 16 or not all(NAME_RE.match(k)
                                             for k in c["reduced"]):
            bad.append(f"reduced {c['reduced']}")
    if len({c["file"] for c in doc["configs"]}) != len(doc["configs"]):
        bad.append("two configs share a file")
    used = {w["config"] for w in doc["workloads"]}
    if used != {c["name"] for c in doc["configs"]}:
        bad.append("a config no cell uses, or a cell's unknown config")
    pairs = set()
    for w in doc["workloads"]:
        names.append(w["name"])
        if set(w) != WORKLOAD_KEYS or w["chips"] not in (1, 4) \
                or not _text(w["why"]):
            bad.append(f"workload {w['name']}")
        for k in ("config", "traffic"):
            if not NAME_RE.match(w[k]):
                bad.append(f"workload {w['name']} {k}")
        pairs.add((w["config"], w["traffic"]))
    if len(pairs) != n or not 1 <= n <= 24:
        bad.append("workload pairs")
    if sum(w["chips"] == 4 for w in doc["workloads"]) > max(1, n // 4):
        bad.append("too many four-chip cells")
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    if "setup_s" not in e2e or not 1 <= len(e2e) <= 16:
        bad.append("end_to_end")
    for m in doc["end_to_end"]:
        names.append(m["name"])
        if not set(m) - {"workloads"} == E2E_KEYS:
            bad.append(f"e2e keys {m['name']}")
        if m["source"] not in ("host_clock", "device_trace"):
            bad.append(f"e2e source {m['name']}")
        if not 0.01 <= m["bound"] <= 0.25:
            bad.append(f"bound {m['name']}")
    cells = {w["name"] for w in doc["workloads"]}
    for m in doc["per_layer"]:
        names.append(m["name"])
        if set(m) - {"workloads"} != LAYER_KEYS or \
                m["source"] not in SOURCES or not _text(m["layer"]):
            bad.append(f"per_layer {m['name']}")
        if m["moves"] not in e2e:
            bad.append(f"{m['name']} moves {m['moves']}")
        moved = e2e.get(m["moves"], {})
        for c in m.get("workloads", []):
            if c not in cells or c not in moved.get("workloads", cells):
                bad.append(f"{m['name']} lists {c}")
    for m in doc["end_to_end"] + doc["per_layer"]:
        if not UNIT_RE.match(m["unit"]) or m["better"] not in ("lower",
                                                               "higher"):
            bad.append(f"unit or better of {m['name']}")
    for x in names:
        if not NAME_RE.match(x):
            bad.append(f"name {x!r}")
    for group in (doc["configs"], doc["workloads"],
                  doc["end_to_end"] + doc["per_layer"]):
        ns = [g["name"] for g in group]
        if len(ns) != len(set(ns)):
            bad.append("duplicate names")
    for cell in cells:
        reported = [m for m in doc["end_to_end"]
                    if cell in m.get("workloads", cells)]
        if len(reported) < 2:
            bad.append(f"{cell} reports too few end-to-end metrics")
        if not any(cell in m.get("workloads", cells)
                   for m in doc["per_layer"]):
            bad.append(f"{cell} reports no per-layer metric")
    return bad


def line_problems(line: dict, cell, trace: bool) -> list:
    """What in a result line breaks the contract, for ``cell``."""
    bad = []
    keys = set(line)
    allowed = LINE_KEYS | {"checks"} | ({"breakdown"} if trace else set())
    if not LINE_KEYS <= keys or not keys <= allowed:
        bad.append(f"keys {sorted(keys)}")
    if list(line)[-1] != "checks":
        bad.append("checks is not the last key")
    if not isinstance(line["correct"], bool):
        bad.append("correct")
    for k in ("attempted", "failed"):
        if not isinstance(line[k], int) or line[k] < 0:
            bad.append(k)
    want = {m["name"]: m["unit"]
            for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, m in line["metrics"].items():
        if name not in want or m.get("unit") != want[name] or \
                not isinstance(m.get("value"), (int, float)):
            bad.append(f"metric {name}")
    dev = line["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes") + (
            ("busy_s", "window_s") if trace else ()):
        if k not in dev:
            bad.append(f"device.{k}")
    if "breakdown" in line:
        for k in ("device_ops", "idle_gaps"):
            if len(line["breakdown"][k]) > 10:
                bad.append(f"breakdown.{k}")
    for name, c in line["checks"].items():
        if set(c) != {"value", "limit"}:
            bad.append(f"check {name}")
    return bad
