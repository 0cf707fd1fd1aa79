"""joinlint over the port — static and run-time analysis of the SPMD join.

Port of ``distributed_join_tpu/analysis/``. Every rank must issue the
same ordered sequence of cross-rank calls, so a collective under a
rank-dependent branch, a hidden host sync inside a timed span, or a tape
call that fires with telemetry off is a deadlock or a performance fault
that a one-process test does not see. Three levels:

- **Level 1** (:mod:`.rules`, :mod:`.concurrency`, :mod:`.linter`): an
  AST linter with the port's vocabulary (DJL001, 002, 004-010), pure
  syntax, milliseconds. Deliberate patterns are suppressed in
  ``suppressions.toml`` (same directory), one reason an entry.
- **Level 2** (:mod:`.schedule`): the port runs eagerly and has no
  trace to read, so the schedule is RECORDED: every ``Communicator``
  call of each rank while the key programs run over
  ``EmulatedCommunicator(8)`` on small seeded tables, held to the
  committed goldens in ``results/schedules_torch/``, with every rank's
  sequence identical and no metrics tape in a telemetry-off program.
- **Level 3** (:mod:`.wirecheck`): the port's daemon, client, router and
  Prometheus expositions held to the JAX package's committed wire
  contract (``results/contracts/wire_ops.json``) and
  ``docs/OBSERVABILITY.md``, which it reads and never writes.

CLI: ``python -m distributed_join_tpu_torch.analysis.lint``.
"""

from __future__ import annotations

from distributed_join_tpu_torch.analysis.linter import (  # noqa: F401
    ALL_RULES,
    LintResult,
    Linter,
    Suppression,
    load_suppressions,
)
from distributed_join_tpu_torch.analysis.rules import Finding  # noqa: F401

__all__ = [
    "ALL_RULES", "Finding", "LintResult", "Linter", "Suppression",
    "load_suppressions",
]
