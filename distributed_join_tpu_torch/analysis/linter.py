"""joinlint engine: file discovery, rule dispatch, suppressions.

Port of ``distributed_join_tpu/analysis/linter.py``: the same engine,
suppression format and ``noqa`` handling; only the default targets
differ (the port's package, ``chip_smoke.py`` and the port's scripts).

The suppression file (``distributed_join_tpu_torch/analysis/
suppressions.toml`` by default, committed) is a TOML array of tables;
this module parses the subset it needs directly (no stdlib ``tomllib``
before Python 3.11), so the format is deliberately flat:

    [[suppress]]
    rule = "DJL005"                          # or "*"
    path = "distributed_join_tpu_torch/parallel/shuffle.py"   # fnmatch glob
    match = "pure_callback"                  # optional message substr
    reason = "why this pattern is deliberate (required)"

A suppression with no ``reason`` is a configuration error, and
suppressions that matched nothing are reported so dead entries don't
accumulate (``LintResult.unused_suppressions``).
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import re
from typing import List, Optional, Sequence

from distributed_join_tpu_torch.analysis import rules as _rules
from distributed_join_tpu_torch.analysis.concurrency import CONCURRENCY_RULES
from distributed_join_tpu_torch.analysis.rules import (
    Finding,
    ParsedModule,
    annotate_parents,
)

# The full rule set: the SPMD and host-sync rules (DJL001-006)
# plus the host-concurrency tier (DJL007-010). Combined here rather
# than in rules.py so concurrency.py can import rules.py's AST
# helpers without a cycle.
ALL_RULES = tuple(_rules.ALL_RULES) + tuple(CONCURRENCY_RULES)

# What `python -m distributed_join_tpu_torch.analysis.lint` scans when
# no explicit paths are given: the port's production files. scripts/
# holds both packages' files, so the port's are named one by one; tests/
# is excluded by design (it holds the deliberately-bad lint fixtures).
PORT_SCRIPTS = (
    "scripts/expand_ab.py", "scripts/fleet_cards.py",
    "scripts/integrity_nccl.py", "scripts/join_scans_ab.py",
    "scripts/resident_drill_ab.py", "scripts/tape_off_census.py",
    "scripts/telemetry_cost.py", "scripts/tree_ab.py",
)
DEFAULT_TARGETS = ("distributed_join_tpu_torch", "chip_smoke.py",
                   *PORT_SCRIPTS)
DEFAULT_SUPPRESSIONS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "suppressions.toml"
)


@dataclasses.dataclass
class Suppression:
    rule: str
    path: str
    reason: str
    match: Optional[str] = None
    origin: str = "?"
    hits: int = 0

    def covers(self, f: Finding) -> bool:
        if self.rule not in ("*", f.rule, f.name):
            return False
        if not fnmatch.fnmatch(f.path, self.path):
            return False
        if self.match is not None and self.match not in f.message:
            return False
        return True


# `# noqa` (whole line) / `# noqa: DJL006` (specific rules). Flake8
# codes the repo already carries map onto the DJL rule they
# correspond to, so existing side-effect-import markers keep working.
_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Za-z0-9, ]+))?",
                      re.IGNORECASE)
_FLAKE8_ALIASES = {"F401": "DJL006", "F811": "DJL006"}


def _noqa_lines(source: str) -> dict:
    """line number -> frozenset of suppressed rule ids (empty set =
    suppress every rule on that line)."""
    out = {}
    for lineno, line in enumerate(source.splitlines(), 1):
        m = _NOQA_RE.search(line)
        if m is None:
            continue
        codes = m.group("codes")
        if codes is None:
            out[lineno] = frozenset()
            continue
        ids = set()
        for c in codes.replace(",", " ").split():
            c = c.strip().upper()
            ids.add(_FLAKE8_ALIASES.get(c, c))
        out[lineno] = frozenset(ids)
    return out


class SuppressionError(ValueError):
    """The suppression file itself is malformed — a lint config error,
    reported loudly rather than silently suppressing nothing."""


def _parse_toml_subset(text: str, origin: str) -> List[dict]:
    """The flat subset this file format needs: ``[[suppress]]``
    headers and ``key = "string"`` pairs."""
    entries: List[dict] = []
    current: Optional[dict] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[suppress]]":
            current = {"_line": lineno}
            entries.append(current)
            continue
        if line.startswith("["):
            raise SuppressionError(
                f"{origin}:{lineno}: only [[suppress]] tables are "
                f"supported, got {line!r}"
            )
        m = re.match(r'^([A-Za-z_][\w-]*)\s*=\s*"([^"]*)"\s*(?:#.*)?$',
                     line)
        if m is None or current is None:
            raise SuppressionError(
                f'{origin}:{lineno}: expected `key = "value"` inside '
                f"a [[suppress]] table, got {line!r}"
            )
        current[m.group(1)] = m.group(2)
    return entries


def load_suppressions(path: str) -> List[Suppression]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        text = f.read()
    out = []
    for e in _parse_toml_subset(text, path):
        line = e.pop("_line")
        missing = [k for k in ("rule", "path", "reason") if not e.get(k)]
        if missing:
            raise SuppressionError(
                f"{path}:{line}: suppression missing required "
                f"field(s) {missing} — every suppression needs a "
                "rule, a path, and a one-line reason"
            )
        unknown = set(e) - {"rule", "path", "reason", "match"}
        if unknown:
            raise SuppressionError(
                f"{path}:{line}: unknown suppression field(s) "
                f"{sorted(unknown)}"
            )
        out.append(Suppression(rule=e["rule"], path=e["path"],
                               reason=e["reason"], match=e.get("match"),
                               origin=f"{path}:{line}"))
    return out


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    suppressed: List[Finding]
    unused_suppressions: List[Suppression]
    files_checked: int

    @property
    def ok(self) -> bool:
        return not self.findings


class Linter:
    """Run the rule set over a file tree, applying suppressions."""

    def __init__(self, root: str,
                 suppressions: Optional[Sequence[Suppression]] = None,
                 rules=ALL_RULES):
        self.root = os.path.abspath(root)
        self.suppressions = list(suppressions or ())
        self.rules = rules

    def lint_source(self, source: str, rel_path: str) -> List[Finding]:
        """Rule findings for one source blob (file-level suppressions
        NOT applied — the fixture tests call this directly; inline
        ``# noqa`` markers ARE honored, see :func:`_noqa_lines`)."""
        try:
            tree = ast.parse(source)
        except SyntaxError as exc:
            return [Finding("DJL000", "parse-error", rel_path,
                            exc.lineno or 0, f"syntax error: {exc.msg}")]
        annotate_parents(tree)
        mod = ParsedModule(path=rel_path, tree=tree)
        noqa = _noqa_lines(source)
        findings: List[Finding] = []
        for rule in self.rules:
            for f in rule.run(mod):
                codes = noqa.get(f.line)
                if codes is not None and (not codes
                                          or f.rule in codes):
                    continue
                findings.append(f)
        return findings

    def lint_file(self, rel_path: str) -> List[Finding]:
        with open(os.path.join(self.root, rel_path)) as f:
            source = f.read()
        return self.lint_source(source, rel_path.replace(os.sep, "/"))

    def iter_files(self, targets: Sequence[str]) -> List[str]:
        out: List[str] = []
        for target in targets:
            abs_t = os.path.join(self.root, target)
            if not os.path.exists(abs_t):
                # A typo'd/renamed target must be a loud config error:
                # os.walk on a missing path is an empty iterator, and
                # a gate that silently lints nothing passes forever.
                raise FileNotFoundError(
                    f"lint target {target!r} does not exist under "
                    f"{self.root}"
                )
            if os.path.isfile(abs_t):
                if target.endswith(".py"):
                    out.append(target)
                continue
            for dirpath, dirnames, filenames in os.walk(abs_t):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.relpath(
                            os.path.join(dirpath, fn), self.root))
        return sorted(set(out))

    def run(self, targets: Optional[Sequence[str]] = None) -> LintResult:
        targets = list(targets or DEFAULT_TARGETS)
        for s in self.suppressions:
            s.hits = 0  # per-run accounting (instances are reusable)
        raw: List[Finding] = []
        files = self.iter_files(targets)
        for rel in files:
            raw.extend(self.lint_file(rel))
        kept, suppressed = [], []
        for f in raw:
            hit = next((s for s in self.suppressions if s.covers(f)),
                       None)
            if hit is not None:
                hit.hits += 1
                suppressed.append(f)
            else:
                kept.append(f)
        kept.sort(key=lambda f: (f.path, f.line, f.rule))
        return LintResult(
            findings=kept,
            suppressed=suppressed,
            unused_suppressions=[s for s in self.suppressions
                                 if s.hits == 0],
            files_checked=len(files),
        )
