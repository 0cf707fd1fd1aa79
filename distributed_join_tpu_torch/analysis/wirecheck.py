"""Level-3 joinlint over the port: the wire-protocol contract checker.

Port of ``distributed_join_tpu/analysis/wirecheck.py``. The wire
contract is the JAX package's: the port's daemon, client and router
answer it, so this module extracts the port's op tables and holds them
against the committed ``results/contracts/wire_ops.json`` and
``docs/OBSERVABILITY.md``, and never writes either (there is no
``--update-contracts`` here; a change of the contract is the JAX
package's).

The service layer keeps THREE hand-maintained op tables whose
agreement is what makes failover safe: the daemon's dispatch table
(``service/server.py _dispatch``), the client's resendable-op set
(``ServiceClient.RESENDABLE_OPS`` — what a retry-armed client may
blindly resend after a torn connection), and the router's
routed/fanout/fault-classified sets (``service/fleet.py``). Nothing
executable ties them together — a new op added to the daemon but not
to the router's affinity function, or a mutating op accidentally
added to RESENDABLE_OPS, ships silently and only fails in a failover.

This module extracts all of them STATICALLY (pure ``ast`` over the
committed sources — no torch, no sockets, milliseconds) and enforces:

1. **mutual consistency** — resendable/routed/fanout/affinity ops all
   exist in the daemon table; no replicated-fanout (mutating) op is
   resendable; the daemon's unknown-op error message advertises
   exactly the dispatch set; every fault-classified error name is a
   real exception class defined in this package.
2. **the committed golden** — the whole contract is pinned in
   ``results/contracts/wire_ops.json`` (the JAX package's); any drift
   of the port from it fails.
3. **Prometheus/doc parity** — every ``djtpu_*`` gauge the telemetry
   and fleet layers emit appears in ``docs/OBSERVABILITY.md`` and
   vice versa (a live check, not goldened: both sides are in-repo).
4. **artifact-kind registry** — every ``kind:``-stamped artifact
   writer in the package has a matching ``analyze check`` validator
   branch, so no artifact the system writes is unverifiable.
"""

from __future__ import annotations

import ast
import functools
import json
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from distributed_join_tpu_torch.analysis.rules import annotate_parents

WIRE_SCHEMA_VERSION = 1
DEFAULT_CONTRACT_PATH = os.path.join("results", "contracts",
                                     "wire_ops.json")

_PACKAGE = "distributed_join_tpu_torch"
_SERVER = os.path.join(_PACKAGE, "service", "server.py")
_FLEET = os.path.join(_PACKAGE, "service", "fleet.py")
_LIVE = os.path.join(_PACKAGE, "telemetry", "live.py")
_ANALYZE = os.path.join(_PACKAGE, "telemetry", "analyze.py")
_OBSERVABILITY = os.path.join("docs", "OBSERVABILITY.md")

# The files whose Prometheus expositions the parity check covers: the
# metrics endpoint bodies plus the service/fleet gauge dictionaries.
PROMETHEUS_SOURCES = (_LIVE, _FLEET, _SERVER)

_GAUGE_RE = re.compile(r"djtpu_[a-z0-9_]+")
# Histogram component series normalize to their base metric name —
# the doc documents the histogram, not its three exposition columns.
_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse(root: str, rel: str) -> ast.Module:
    path = os.path.join(root, rel)
    return _parse_cached(path, os.stat(path).st_mtime_ns)


@functools.lru_cache(maxsize=512)
def _parse_cached(path: str, mtime_ns: int) -> ast.Module:
    """One parse a file version: every extractor walks the same sources
    (nothing edits a parsed tree)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    annotate_parents(tree)
    return tree


def _functions(tree: ast.Module, name: str) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name == name]


def _str_elts(node) -> Set[str]:
    out: Set[str] = set()
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.add(e.value)
    return out


def _compared_strings(fn, var: str) -> Tuple[Set[str], Set[str]]:
    """(eq, membership) string constants compared against ``var`` —
    ``var == "x"`` and ``var in ("x", "y")`` — inside ``fn``."""
    eq: Set[str] = set()
    memb: Set[str] = set()
    for n in ast.walk(fn):
        if not (isinstance(n, ast.Compare) and len(n.ops) == 1
                and isinstance(n.left, ast.Name)
                and n.left.id == var):
            continue
        comp = n.comparators[0]
        if isinstance(n.ops[0], ast.Eq) \
                and isinstance(comp, ast.Constant) \
                and isinstance(comp.value, str):
            eq.add(comp.value)
        if isinstance(n.ops[0], (ast.In, ast.NotIn)):
            memb |= _str_elts(comp)
    return eq, memb


# -- op-table extraction ----------------------------------------------


def daemon_ops(root: str) -> Set[str]:
    """Ops the daemon's ``_dispatch`` handles (``op == "..."``
    chains)."""
    tree = _parse(root, _SERVER)
    ops: Set[str] = set()
    for fn in _functions(tree, "_dispatch"):
        eq, memb = _compared_strings(fn, "op")
        ops |= eq | memb
    return ops


def advertised_ops(root: str) -> Set[str]:
    """The op list the daemon's unknown-op ValueError advertises
    (``... (ops: ping, stats, ...)``) — operator-facing docs that
    drift from the dispatch table when an op lands in only one."""
    tree = _parse(root, _SERVER)
    for fn in _functions(tree, "_dispatch"):
        for n in ast.walk(fn):
            if not isinstance(n, ast.Raise):
                continue
            text = "".join(
                c.value for c in ast.walk(n)
                if isinstance(c, ast.Constant)
                and isinstance(c.value, str))
            m = re.search(r"\(ops: ([a-z_, ]+)\)", text)
            if m:
                return {op.strip() for op in m.group(1).split(",")
                        if op.strip()}
    return set()


def resendable_ops(root: str) -> Set[str]:
    """``ServiceClient.RESENDABLE_OPS`` — the idempotent subset a
    retry-armed client may resend after a torn connection."""
    tree = _parse(root, _SERVER)
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "RESENDABLE_OPS"
                for t in n.targets):
            value = n.value
            if isinstance(value, ast.Call) and value.args:
                value = value.args[0]
            return _str_elts(value)
    return set()


def router_ops(root: str) -> Set[str]:
    """Ops the fleet router answers at ROUTER level (``_route``'s
    ``op ==`` chain); everything else proxies to a replica."""
    tree = _parse(root, _FLEET)
    ops: Set[str] = set()
    for fn in _functions(tree, "_route"):
        eq, _ = _compared_strings(fn, "op")
        ops |= eq
    return ops


def fanout_ops(root: str) -> Set[str]:
    """The replicated table-mutation ops ``FleetRouter.dispatch`` fans
    out to the holder set (the membership tuple carrying
    ``register``)."""
    tree = _parse(root, _FLEET)
    ops: Set[str] = set()
    for fn in _functions(tree, "dispatch"):
        for n in ast.walk(fn):
            if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.ops[0], ast.In):
                elts = _str_elts(n.comparators[0])
                if "register" in elts:
                    ops |= elts
    return ops


def affinity_ops(root: str) -> Set[str]:
    """Ops ``affinity_key`` routes by a dedicated digest (table name /
    plan digest / workload signature) rather than canonical JSON."""
    tree = _parse(root, _FLEET)
    ops: Set[str] = set()
    for fn in _functions(tree, "affinity_key"):
        eq, memb = _compared_strings(fn, "op")
        ops |= eq | memb
    return ops


def fault_classification(root: str) -> Tuple[Set[str], Set[str]]:
    """(error class names, fault families) the router's
    ``_replica_fault`` classifies as replica-fatal/failover-able."""
    tree = _parse(root, _FLEET)
    classes: Set[str] = set()
    families: Set[str] = set()
    for fn in _functions(tree, "_replica_fault"):
        eq, memb = _compared_strings(fn, "err")
        classes |= eq | memb
        for n in ast.walk(fn):
            if isinstance(n, ast.Return) \
                    and isinstance(n.value, ast.Constant) \
                    and isinstance(n.value.value, str):
                families.add(n.value.value)
    return classes, families


def _package_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(root, _PACKAGE)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.relpath(
                    os.path.join(dirpath, fn), root))
    return sorted(out)


def defined_error_classes(root: str) -> Set[str]:
    """Every exception class name defined in the package (the router
    classifies faults by ``type(exc).__name__`` strings on the wire —
    a typo'd string silently never matches)."""
    out: Set[str] = set()
    for rel in _package_files(root):
        try:
            tree = _parse(root, rel)
        except SyntaxError:
            continue
        for n in ast.walk(tree):
            if isinstance(n, ast.ClassDef) and n.name.endswith("Error"):
                out.add(n.name)
    return out


# -- Prometheus gauge parity ------------------------------------------


def _module_str_consts(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) \
                and isinstance(n.value, ast.Constant) \
                and isinstance(n.value.value, str):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = n.value.value
    return out


def _for_loop_values(node: ast.AST, var: str) -> Optional[Set[str]]:
    """Resolve ``var`` through an enclosing ``for var in ("a", ...)``
    loop of string constants; None when unresolvable (a dynamic
    iterable — the caller skips rather than guesses)."""
    cur = getattr(node, "_djl_parent", None)
    while cur is not None:
        if isinstance(cur, ast.For) and isinstance(cur.target, ast.Name) \
                and cur.target.id == var:
            vals = _str_elts(cur.iter)
            return vals or None
        cur = getattr(cur, "_djl_parent", None)
    return None


def _normalize_gauge(name: str) -> Optional[str]:
    if name.endswith("_"):
        # A truncated fragment (an f-string prefix like "djtpu_" or a
        # smoke prefix= argument), not a metric name.
        return None
    for suf in _HISTOGRAM_SUFFIXES:
        if name.endswith(suf):
            name = name[: -len(suf)]
    return name


def _joinedstr_gauges(node: ast.JoinedStr) -> Set[str]:
    """Gauge names from one f-string: literal fragments, plus
    ``f"djtpu_{name}_total"`` expanded through a constant for-loop."""
    out: Set[str] = set()
    vals = node.values
    for i, part in enumerate(vals):
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            for m in _GAUGE_RE.finditer(part.value):
                out.add(m.group(0))
            if part.value.endswith("djtpu_") and i + 1 < len(vals) \
                    and isinstance(vals[i + 1], ast.FormattedValue) \
                    and isinstance(vals[i + 1].value, ast.Name):
                expansions = _for_loop_values(
                    node, vals[i + 1].value.id)
                if expansions is None:
                    continue
                suffix = ""
                if i + 2 < len(vals) and isinstance(
                        vals[i + 2], ast.Constant):
                    m = re.match(r"[a-z0-9_]*", str(vals[i + 2].value))
                    suffix = m.group(0) if m else ""
                for v in expansions:
                    out.add(f"djtpu_{v}{suffix}")
    return out


def emitted_gauges(root: str) -> Set[str]:
    """Every ``djtpu_*`` metric name the Prometheus expositions emit,
    normalized (histogram ``_bucket/_sum/_count`` columns fold into
    the base name)."""
    raw: Set[str] = set()
    for rel in PROMETHEUS_SOURCES:
        tree = _parse(root, rel)
        for n in ast.walk(tree):
            if isinstance(n, ast.JoinedStr):
                raw |= _joinedstr_gauges(n)
            elif isinstance(n, ast.Constant) \
                    and isinstance(n.value, str):
                for m in _GAUGE_RE.finditer(n.value):
                    raw.add(m.group(0))
            if isinstance(n, ast.Call):
                for kw in n.keywords:
                    if kw.arg == "gauges" \
                            and isinstance(kw.value, ast.Dict):
                        for k in kw.value.keys:
                            if isinstance(k, ast.Constant) \
                                    and isinstance(k.value, str):
                                raw.add(f"djtpu_{k.value}")
    out: Set[str] = set()
    for name in raw:
        norm = _normalize_gauge(name)
        if norm is not None:
            out.add(norm)
    return out


def documented_gauges(root: str) -> Set[str]:
    """Every ``djtpu_*`` name docs/OBSERVABILITY.md mentions, under
    the same normalization as the emitted side."""
    with open(os.path.join(root, _OBSERVABILITY)) as f:
        text = f.read()
    out: Set[str] = set()
    for m in _GAUGE_RE.finditer(text):
        norm = _normalize_gauge(m.group(0))
        if norm is not None:
            out.add(norm)
    return out


# -- artifact-kind registry -------------------------------------------


def artifact_writer_kinds(root: str) -> Set[str]:
    """Every ``kind`` value the package stamps into an artifact dict
    (``{"kind": "x", ...}`` literals; a Name value resolves through
    a module-level string constant, e.g. timeline.py's KIND)."""
    kinds: Set[str] = set()
    for rel in _package_files(root):
        try:
            tree = _parse(root, rel)
        except SyntaxError:
            continue
        consts = _module_str_consts(tree)
        for n in ast.walk(tree):
            if not isinstance(n, ast.Dict):
                continue
            for k, v in zip(n.keys, n.values):
                if not (isinstance(k, ast.Constant)
                        and k.value == "kind"):
                    continue
                if isinstance(v, ast.Constant) \
                        and isinstance(v.value, str):
                    kinds.add(v.value)
                elif isinstance(v, ast.Name) and v.id in consts:
                    kinds.add(consts[v.id])
    return kinds


def artifact_validator_kinds(root: str) -> Set[str]:
    """Every ``kind`` the ``analyze check`` validator recognizes
    (string constants compared against a kind-carrying expression in
    telemetry/analyze.py)."""
    tree = _parse(root, _ANALYZE)
    kinds: Set[str] = set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Compare) and len(n.ops) == 1):
            continue
        left = n.left
        is_kind = (isinstance(left, ast.Name) and "kind" in left.id) \
            or (isinstance(left, ast.Call)
                and isinstance(left.func, ast.Attribute)
                and left.func.attr == "get" and left.args
                and isinstance(left.args[0], ast.Constant)
                and left.args[0].value == "kind")
        if not is_kind:
            continue
        comp = n.comparators[0]
        if isinstance(n.ops[0], ast.Eq) \
                and isinstance(comp, ast.Constant) \
                and isinstance(comp.value, str):
            kinds.add(comp.value)
        if isinstance(n.ops[0], (ast.In, ast.NotIn)):
            kinds |= _str_elts(comp)
    return kinds


# -- the contract + checks --------------------------------------------


def extract_wire_contract(root: str) -> dict:
    """The whole statically-extracted wire contract, in golden form
    (sorted lists — byte-stable across runs)."""
    classes, families = fault_classification(root)
    return {
        "schema_version": WIRE_SCHEMA_VERSION,
        "daemon_ops": sorted(daemon_ops(root)),
        "resendable_ops": sorted(resendable_ops(root)),
        "router_ops": sorted(router_ops(root)),
        "fanout_ops": sorted(fanout_ops(root)),
        "affinity_ops": sorted(affinity_ops(root)),
        "fault_classes": sorted(classes),
        "fault_families": sorted(families),
    }


def consistency_violations(root: str, contract: dict) -> List[str]:
    """The always-on cross-checks — regen cannot bless these."""
    v: List[str] = []
    daemon = set(contract["daemon_ops"])
    if not daemon:
        return ["wirecheck: extracted EMPTY daemon op table from "
                f"{_SERVER} _dispatch — the extractor lost the "
                "dispatch chain (refactor wirecheck.daemon_ops "
                "alongside the server)"]

    def subset(name: str, ops, why: str) -> None:
        extra = sorted(set(ops) - daemon)
        if extra:
            v.append(f"{name} op(s) {extra} missing from the daemon "
                     f"dispatch table — {why}")

    subset("resendable", contract["resendable_ops"],
           "a client would resend an op no daemon can serve")
    subset("router-level", contract["router_ops"],
           "a fleet-only op must still exist daemon-side so "
           "single-daemon deployments answer it")
    subset("replicated-fanout", contract["fanout_ops"],
           "the router would fan out an op the replicas reject")
    subset("affinity-routed", contract["affinity_ops"],
           "affinity_key special-cases an op the daemon dropped")
    overlap = sorted(set(contract["fanout_ops"])
                     & set(contract["resendable_ops"]))
    if overlap:
        v.append(f"mutating fanout op(s) {overlap} are marked "
                 "RESENDABLE — a blind resend after a torn connection "
                 "double-applies the mutation")
    advertised = advertised_ops(root)
    if advertised != daemon:
        v.append("the daemon's unknown-op error advertises "
                 f"{sorted(advertised)} but dispatches "
                 f"{sorted(daemon)} — keep the (ops: ...) list in "
                 "sync with the dispatch chain")
    defined = defined_error_classes(root)
    ghost = sorted(set(contract["fault_classes"]) - defined)
    if ghost:
        v.append(f"fault-classified error name(s) {ghost} have no "
                 "exception class in the package — the router "
                 "matches type names on the wire, so a ghost name "
                 "never classifies")
    emitted = emitted_gauges(root)
    documented = documented_gauges(root)
    for name in sorted(emitted - documented):
        v.append(f"Prometheus gauge {name} is emitted but not "
                 f"documented in {_OBSERVABILITY}")
    for name in sorted(documented - emitted):
        v.append(f"Prometheus gauge {name} is documented in "
                 f"{_OBSERVABILITY} but never emitted")
    writers = artifact_writer_kinds(root)
    validators = artifact_validator_kinds(root)
    unvalidated = sorted(writers - validators)
    if unvalidated:
        v.append(f"artifact kind(s) {unvalidated} are written but "
                 "`analyze check` has no validator branch for them — "
                 "every kind-stamped artifact must be checkable")
    return v


def contract_path(root: str, path: Optional[str] = None) -> str:
    return path or os.path.join(root, DEFAULT_CONTRACT_PATH)


def golden_violations(contract: dict, path: str) -> List[str]:
    if not os.path.exists(path):
        return [f"no committed wire-contract golden at {path}: the "
                "contract is the JAX package's (its analysis.lint "
                "--update-contracts writes it)"]
    with open(path) as f:
        golden = json.load(f)
    if golden.get("schema_version") != WIRE_SCHEMA_VERSION:
        return [f"wire-contract golden schema_version "
                f"{golden.get('schema_version')} != "
                f"{WIRE_SCHEMA_VERSION}"]
    v: List[str] = []
    for key in sorted(set(contract) | set(golden)):
        if key == "schema_version":
            continue
        want, got = golden.get(key), contract.get(key)
        if want == got:
            continue
        added = sorted(set(got or ()) - set(want or ()))
        removed = sorted(set(want or ()) - set(got or ()))
        detail = []
        if added:
            detail.append(f"added {added}")
        if removed:
            detail.append(f"removed {removed}")
        v.append(f"the port's wire contract drifted from {path}: {key} "
                 + " and ".join(detail or [f"{want} -> {got}"])
                 + " — the port answers the committed contract; change "
                 "the port, not the golden")
    return v


def check_wire_contract(root: str, path: Optional[str] = None):
    """Extract the port's contract, cross-check it and diff it against
    the committed golden. Returns ``(violations, contract)``."""
    contract = extract_wire_contract(root)
    violations = consistency_violations(root, contract)
    violations.extend(golden_violations(contract, contract_path(root, path)))
    return violations, contract
