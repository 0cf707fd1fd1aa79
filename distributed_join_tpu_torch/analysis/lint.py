"""joinlint CLI over the port — ``python -m
distributed_join_tpu_torch.analysis.lint``.

Port of ``distributed_join_tpu/analysis/lint.py``. Runs all three levels:

  python -m distributed_join_tpu_torch.analysis.lint
      AST rules (DJL001, 002, 004-010) over the port's files + the wire
      contract check against results/contracts/wire_ops.json + the
      recorded collective schedules against results/schedules_torch/.
      Exit 0 when clean (modulo the committed suppressions), 1 on
      findings or contract/schedule violations, 2 on configuration
      errors.

  python -m distributed_join_tpu_torch.analysis.lint --rules-only [PATHS]
      Level 1 only (pure ast, milliseconds; PATHS default to the port's
      files).

  python -m distributed_join_tpu_torch.analysis.lint --contracts-only
      Level 3 only: the port's op tables, the Prometheus/doc gauge
      parity and the artifact-kind registry (pure ast).

  python -m distributed_join_tpu_torch.analysis.lint --schedules-only
      Level 2 only: the fourteen key programs run over eight emulated
      ranks on the CPU, each rank's cross-rank calls recorded.

  python -m distributed_join_tpu_torch.analysis.lint --update-schedules
      Re-record the programs and rewrite results/schedules_torch/ (commit
      the diff). The invariants (identical rank sequences, nothing
      recorded in a telemetry-off program) still gate a regen.

``--update-contracts`` refuses: the wire contract is the JAX package's,
and the port answers it.
"""

from __future__ import annotations

import argparse
import os
import sys

from distributed_join_tpu_torch.analysis.linter import (
    DEFAULT_SUPPRESSIONS,
    DEFAULT_TARGETS,
    Linter,
    SuppressionError,
    load_suppressions,
)


def repo_root() -> str:
    """The tree joinlint scans by default: the repository holding this
    package (``analysis/`` -> ``distributed_join_tpu_torch/`` -> root)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m distributed_join_tpu_torch.analysis.lint",
        description="joinlint over the port: SPMD hazard linter, wire "
                    "contract check and recorded collective schedules",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint, relative to the repo "
                         f"root (default: {' '.join(DEFAULT_TARGETS)})")
    ap.add_argument("--root", default=None,
                    help="repo root to scan (default: the repository "
                         "containing this package)")
    ap.add_argument("--suppressions", default=None, metavar="TOML",
                    help="suppression file (default: the committed "
                         "distributed_join_tpu_torch/analysis/"
                         "suppressions.toml)")
    ap.add_argument("--no-suppressions", action="store_true",
                    help="report every finding, committed "
                         "suppressions ignored (burn-in mode)")
    ap.add_argument("--rules-only", action="store_true",
                    help="level 1 only: AST rules")
    ap.add_argument("--schedules-only", action="store_true",
                    help="level 2 only: the recorded schedule check")
    ap.add_argument("--contracts-only", action="store_true",
                    help="level 3 only: the wire-protocol contract "
                         "check (pure ast)")
    ap.add_argument("--update-schedules", action="store_true",
                    help="re-record the key programs and rewrite "
                         "results/schedules_torch/ (commit the diff)")
    ap.add_argument("--update-contracts", action="store_true",
                    help="refused: the wire contract is the JAX "
                         "package's (its own analysis.lint rewrites it)")
    ap.add_argument("--schedule-dir", default=None,
                    help="golden schedule directory (default: "
                         "results/schedules_torch under the root)")
    ap.add_argument("--contract-path", default=None,
                    help="wire-contract golden path (default: "
                         "results/contracts/wire_ops.json under the "
                         "root)")
    return ap.parse_args(argv)


def run_rules(args, root: str) -> int:
    sup_path = args.suppressions or DEFAULT_SUPPRESSIONS
    try:
        sups = ([] if args.no_suppressions
                else load_suppressions(sup_path))
    except SuppressionError as exc:
        print(f"joinlint: bad suppression file: {exc}",
              file=sys.stderr)
        return 2
    linter = Linter(root, suppressions=sups)
    try:
        result = linter.run(args.paths or None)
    except FileNotFoundError as exc:
        print(f"joinlint: {exc}", file=sys.stderr)
        return 2
    for f in result.findings:
        print(f.format())
    n = len(result.findings)
    print(f"joinlint rules: {n} finding(s) in "
          f"{result.files_checked} file(s)"
          + (f", {len(result.suppressed)} suppressed"
             if result.suppressed else ""))
    # Dead suppressions rot; surface them (a note, not a failure —
    # a partial-path lint run legitimately misses some).
    if not args.paths and not args.no_suppressions:
        for s in result.unused_suppressions:
            print(f"joinlint: note: suppression at {s.origin} "
                  f"({s.rule} {s.path}) matched nothing",
                  file=sys.stderr)
    return 1 if result.findings else 0


def run_contracts(args, root: str) -> int:
    from distributed_join_tpu_torch.analysis.wirecheck import (
        check_wire_contract,
    )

    violations, contract = check_wire_contract(
        root, path=args.contract_path or None)
    for v in violations:
        print(f"joinlint contract: {v}")
    n_ops = len(contract["daemon_ops"])
    print(f"joinlint contracts: {n_ops} daemon op(s) checked, "
          f"{len(violations)} violation(s)")
    return 1 if violations else 0


def run_schedules(args, root: str) -> int:
    from distributed_join_tpu_torch.analysis.schedule import (
        DEFAULT_SCHEDULE_DIR,
        check_schedules,
    )

    sched_dir = args.schedule_dir or os.path.join(
        root, DEFAULT_SCHEDULE_DIR)
    violations, schedules = check_schedules(
        schedule_dir=sched_dir, update=args.update_schedules)
    for v in violations:
        print(f"joinlint schedule: {v}")
    verb = "updated" if args.update_schedules else "checked"
    print(f"joinlint schedules: {len(schedules)} program(s) {verb}, "
          f"{len(violations)} violation(s)")
    return 1 if violations else 0


def main(argv=None) -> int:
    args = parse_args(argv)
    only = (args.rules_only, args.schedules_only, args.contracts_only)
    if sum(map(bool, only)) > 1:
        print("joinlint: choose at most one of --rules-only/"
              "--schedules-only/--contracts-only", file=sys.stderr)
        return 2
    if args.update_contracts:
        print("joinlint: --update-contracts refused: the wire contract "
              "(results/contracts/wire_ops.json) is the JAX package's, and "
              "the port answers it; change the port, not the golden",
              file=sys.stderr)
        return 2
    if args.update_schedules and (args.rules_only or args.contracts_only):
        print("joinlint: --update-schedules excludes --rules-only and "
              "--contracts-only", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root) if args.root else repo_root()
    do_rules = not (args.schedules_only or args.contracts_only
                    or args.update_schedules)
    do_contracts = args.contracts_only or not (
        args.rules_only or args.schedules_only or args.update_schedules)
    do_schedules = args.schedules_only or args.update_schedules or not (
        args.rules_only or args.contracts_only)
    rc = 0
    if do_rules:
        rc = run_rules(args, root)
        if rc == 2:
            return rc
    if do_contracts:
        rc = max(rc, run_contracts(args, root))
    if do_schedules:
        rc = max(rc, run_schedules(args, root))
    return rc


if __name__ == "__main__":
    sys.exit(main())
