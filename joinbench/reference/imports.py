"""The import checks. A module's top-level name is the part of its name
before the first dot, compared whole: ``distributed_join_tpu_torch``
begins with ``distributed_join_tpu`` and is not it."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

# What no process of a run may hold once the window has closed.
FORBIDDEN_IN_RUN = ("jax", "jaxlib", "flax", "distributed_join_tpu")
# What the reference may not import, besides those.
PORT = "distributed_join_tpu_torch"
REFERENCE_DIR = Path(__file__).resolve().parent


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None, forbidden=FORBIDDEN_IN_RUN) -> list:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is one of ``forbidden``, sorted."""
    mods = sys.modules if modules is None else modules
    banned = set(forbidden)
    return sorted(m for m in list(mods) if top_level(m) in banned)


def source_imports(path: Path) -> set:
    """The top-level names a Python file imports (absolute imports)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(top_level(node.module))
    return names


def reference_violations(directory: Path = REFERENCE_DIR) -> dict:
    """``{file: [banned names]}`` for every file of the reference that
    imports the port, JAX or the JAX package."""
    banned = set(FORBIDDEN_IN_RUN) | {PORT}
    out = {}
    for path in sorted(Path(directory).rglob("*.py")):
        bad = sorted(source_imports(path) & banned)
        if bad:
            out[str(path)] = bad
    return out
