"""``BENCHMARK.json`` and the files it names, found by name.

- a cell is an entry of ``workloads``; its configuration is the
  ``configs`` entry of that name, whose ``file`` holds the sizes and
  names the system adapter (``"system"``: ``joinbench/systems/<system>.py``);
- its traffic is ``joinbench/traffic/<traffic>.json``;
- an end-to-end metric is read by ``joinbench/end_to_end/<name>.py``, a
  per-layer metric by ``joinbench/layers/<name>.py``, each a module with
  ``read(ctx)`` that returns a number, or None where it found nothing;
- a kernel whose launches a roofline counts is
  ``joinbench/layers/kernels/<kernel>.json``.

A later cell, traffic mix or metric is new files and new entries here,
with no edit to a file that is there. A key of a configuration or
traffic file that no code reads, or a value the harness does not run,
is refused (``refuse_unread``, in every rank before its set-up), so that
such a file is never run as if it said something else.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

# Keys of a configuration file that describe the deployment to a reader;
# no code reads them.
NOTE_KEYS = ("system", "source", "deployment", "guarantees", "reduced",
             "assumed", "departures")
# Keys of a traffic file that the loop reads, each with the one value it
# runs where it runs only one: a closed loop of one client.
LOOP_KEYS = {"why": None, "loop": "closed", "clients": 1,
             "warmup_ops": None, "trace_ops": None,
             "sample_from_first": None}


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple     # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(bench: dict, name: str, root: Path = ROOT,
                 bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    config = load_json(Path(root) / conf["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    moved = {m["name"] for m in e2e}
    layers = tuple(m for m in bench["per_layer"]
                   if (name in m["workloads"] if "workloads" in m
                       else m["moves"] in moved))
    return Cell(name=name, chips=int(w["chips"]),
                config_name=conf["name"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                end_to_end=e2e, per_layer=layers)


def refuse_unread(config: dict, traffic: dict, system_cls) -> None:
    """Raise ValueError on a key that neither the harness nor the
    system's adapter reads (its ``CONFIG_KEYS`` and ``TRAFFIC_KEYS``),
    or on a value other than the one such a key is pinned to."""
    for what, doc, known in (
            ("configuration", config,
             dict.fromkeys(NOTE_KEYS) | system_cls.CONFIG_KEYS),
            ("traffic", traffic, LOOP_KEYS | system_cls.TRAFFIC_KEYS)):
        for key, value in doc.items():
            if key not in known:
                raise ValueError(f"{what} key {key!r}: nothing reads it")
            if known[key] is not None and value != known[key]:
                raise ValueError(f"{what} key {key!r} is {value!r}; the "
                                 f"harness runs only {known[key]!r}")


def _load_module(path: Path, label: str):
    if not path.exists():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"joinbench_{label}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` of metric ``name``: ``kind`` is ``end_to_end``
    or ``layers``."""
    return _load_module(bench_dir / kind / f"{name}.py", kind).read


def system_module(config: dict, bench_dir: Path = BENCH_DIR):
    """The adapter module of the configuration's ``system``."""
    return _load_module(bench_dir / "systems" / f"{config['system']}.py",
                        "system")


def system_class(cell: Cell, bench_dir: Path = BENCH_DIR):
    """The cell's adapter class, once its files pass ``refuse_unread``.
    Each rank calls it: an adapter imports torch, which rank 0 must not
    wait for before it starts the other ranks."""
    cls = system_module(cell.config, bench_dir).System
    refuse_unread(cell.config, cell.traffic, cls)
    return cls


def kernel_specs(bench_dir: Path = BENCH_DIR) -> dict:
    """``{kernel: spec}`` from ``layers/kernels/*.json``."""
    return {p.stem: load_json(p)
            for p in sorted((bench_dir / "layers" / "kernels").glob("*.json"))}
