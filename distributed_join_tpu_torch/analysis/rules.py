"""Level-1 joinlint rules over the port: AST-level SPMD hazard detection.

Port of ``distributed_join_tpu/analysis/rules.py``, with the port's
vocabulary. Each rule encodes an invariant the rest of the port only
documents:

- DJL001 collective-divergence — a cross-rank call reachable under a
  rank-dependent Python branch, or after a rank-dependent early exit.
  The callees are the ``Communicator``'s cross-rank methods
  (``parallel/communicator.py``: ``all_to_all``, ``all_gather``,
  ``all_gather_counts``, ``psum``, ``ppermute_all_to_all``,
  ``all_to_all_chip``, ``all_to_all_slice``, ``ragged_all_to_all``,
  ``host_ints``, ``host_max``, ``barrier``) and ``torch.distributed``'s
  collectives; the rank sources ``axis_index``, ``get_rank``,
  ``process_id`` and the JAX package's. A host collective under a
  rank-dependent branch deadlocks NCCL just as a device collective does.
- DJL002 hidden-sync — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``torch.cuda.synchronize`` (any ``synchronize()``), and ``int()``/
  ``float()``/``bool()``/``np.asarray`` over ``torch`` results inside a
  ``telemetry.span`` region. A span times a host interval; a hidden
  device sync inside one bills device completion to whatever span is
  open (the honest protocol is ``sp.sync_on(scalar)``,
  ``telemetry/spans.py``).
- DJL004 host-sync-reduction — ``int()``/``float()``/``.item()`` over a
  torch reduction: a hidden host sync, which breaks the kernel
  pipeline's no-sync contract (``ops/join.py`` module docstring).
- DJL005 tape-parity — a function taking ``tape=``/``with_metrics=``/
  ``with_integrity=`` must guard every tape method call, so that a
  telemetry-off step is the seed step.
- DJL006 unused-symbol — unused and duplicate imports.

DJL003 (callback discipline) and DJL004's other half (list and dict
literals as jit static arguments) have no torch mechanism: an eager
torch program has no backend host callback to poison a dispatch stream,
and no trace whose cache a static argument keys. Their IDs stay unused
here, so that an ID means the same thing in both packages.

Rules are deliberately narrow: deliberate patterns are suppressed WITH
A REASON in ``analysis/suppressions.toml`` rather than widening the
rules until they see nothing.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, List, Optional

# Rank-dependent value sources: anything derived from these diverges
# across ranks/processes.
RANK_SOURCES = {
    "axis_index", "get_rank", "process_id", "process_index",
    "is_coordinator",
}
# The Communicator's collectives that move device tensors (their results
# are device values) ...
DEVICE_COLLECTIVES = {
    "all_to_all", "all_gather", "all_gather_counts", "psum",
    "ppermute_all_to_all", "all_to_all_chip", "all_to_all_slice",
    "ragged_all_to_all",
}
# ... its host-level cross-rank calls, and torch.distributed's (plus the
# JAX names, so that an ID flags the same code in both packages).
COLLECTIVE_CALLEES = DEVICE_COLLECTIVES | {
    "host_ints", "host_max", "barrier",
    "all_reduce", "all_gather_into_tensor", "all_to_all_single",
    "broadcast", "reduce_scatter", "reduce_scatter_tensor",
    "all_gather_object", "broadcast_object_list", "batch_isend_irecv",
    "monitored_barrier", "ppermute", "pbroadcast",
}
SYNC_CALLEES = {"synchronize", "block_until_ready", "device_get"}
# No-argument tensor methods that read a device value to the host.
SYNC_METHODS = {"item", "cpu"}
# Roots whose calls produce tensors (for the hidden-sync taint) ...
TRACED_ROOTS = {"torch"}
# ... except these host-side torch namespaces.
HOST_TORCH_PREFIXES = (
    "torch.cuda", "torch.distributed", "torch.device", "torch.iinfo",
    "torch.finfo", "torch.utils", "torch.profiler", "torch.autograd",
    "torch.backends", "torch.version", "torch.get_", "torch.set_",
    "torch.is_", "torch.manual_seed", "torch.Generator",
)
REDUCERS = {
    "max", "min", "sum", "prod", "argmax", "argmin", "count_nonzero",
    "amax", "amin", "any", "all", "mean",
}
NP_ROOTS = {"np", "numpy"}
# Receivers whose reductions are host values, never tensors.
HOST_ROOTS = NP_ROOTS | {"math", "statistics", "builtins"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, anchored to a repo-relative path + line."""

    rule: str       # "DJL00x"
    name: str       # "collective-divergence"
    path: str       # repo-relative, posix separators
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.name}] " \
               f"{self.message}"


@dataclasses.dataclass
class ParsedModule:
    """One parsed source file, parent-annotated (see
    :func:`annotate_parents`)."""

    path: str
    tree: ast.Module


# -- AST helpers ------------------------------------------------------


def walk(node: ast.AST) -> List[ast.AST]:
    """``ast.walk(node)`` as a list, kept on the node: the rules walk the
    same subtrees many times, and a tree is not edited while it is
    linted."""
    got = node.__dict__.get("_djl_walk")
    if got is None:
        got = list(ast.walk(node))
        node._djl_walk = got  # type: ignore[attr-defined]
    return got


def annotate_parents(tree: ast.AST) -> None:
    """Attach ``_djl_parent`` to every node so rules can walk UP."""
    for node in walk(tree):
        for child in ast.iter_child_nodes(node):
            child._djl_parent = node  # type: ignore[attr-defined]


def parents(node: ast.AST) -> Iterator[ast.AST]:
    while True:
        node = getattr(node, "_djl_parent", None)
        if node is None:
            return
        yield node


def dotted(expr) -> Optional[str]:
    """Best-effort dotted name of an expression: ``comm.all_to_all``,
    ``torch.sum``; for a chain rooted in a call (``f().attr``) only the
    attribute tail is returned."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = dotted(expr.value)
        return f"{base}.{expr.attr}" if base else expr.attr
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def last_seg(name: Optional[str]) -> Optional[str]:
    return None if name is None else name.rsplit(".", 1)[-1]


def first_seg(name: Optional[str]) -> Optional[str]:
    return None if name is None else name.split(".", 1)[0]


def enclosing_function(node: ast.AST):
    for p in parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return p
    return None


def outermost_scopes(tree: ast.Module) -> List[ast.AST]:
    """Top-level function scopes (methods of top-level classes count —
    their enclosing *function* is None)."""
    return [
        n for n in walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and enclosing_function(n) is None
    ]


# Attributes that are Python-static even on a traced object: reading
# them off a tainted value yields host data, so they must not
# propagate taint (Table.capacity is THE case: an int property of a
# traced table, used in host capacity math everywhere).
STATIC_ATTRS = {
    "capacity", "shape", "ndim", "dtype", "itemsize", "size",
    "n_ranks", "column_names", "name", "device", "is_cuda", "numel",
    "element_size", "nbytes",
}


def _taint_carrier(n: ast.AST, tainted: set) -> bool:
    """``n`` is a Name occurrence that carries taint — tainted, and
    not merely the base of a static-attribute read."""
    if not (isinstance(n, ast.Name) and n.id in tainted):
        return False
    parent = getattr(n, "_djl_parent", None)
    if isinstance(parent, ast.Attribute) and parent.value is n \
            and parent.attr in STATIC_ATTRS:
        return False
    return True


def tainted_names(scope: ast.AST, is_source) -> set:
    """Names in ``scope`` (nested functions included — closures taint
    through) assigned, directly or transitively, from an expression
    containing a source node. Fixpoint over simple assignments — no
    attribute/subscript tracking, which keeps false positives near
    zero at the cost of under-approximating (a linter's right
    trade)."""
    tainted: set = set()

    def value_tainted(expr) -> bool:
        for n in walk(expr):
            if _taint_carrier(n, tainted):
                return True
            if is_source(n):
                return True
        return False

    changed = True
    while changed:
        changed = False
        for node in walk(scope):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                if node.value is None:
                    continue
                targets, value = [node.target], node.value
            elif isinstance(node, ast.NamedExpr):
                targets, value = [node.target], node.value
            else:
                continue
            pairs = [(t, value) for t in targets]
            # `a, b = x, y` pairs element by element: only what a
            # tainted element is assigned to carries taint
            pairs = [pair for t, v in pairs for pair in (
                zip(t.elts, v.elts)
                if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                and len(t.elts) == len(v.elts)
                and not any(isinstance(e, ast.Starred) for e in t.elts)
                else [(t, v)])]
            for t, v in pairs:
                if not value_tainted(v):
                    continue
                for n in walk(t):
                    if isinstance(n, ast.Name) and n.id not in tainted:
                        tainted.add(n.id)
                        changed = True
    return tainted


def _is_rank_source(node) -> bool:
    return (isinstance(node, ast.Call)
            and last_seg(call_name(node)) in RANK_SOURCES)


def _is_torch_call(node) -> bool:
    """A ``torch.*`` call that returns a tensor (not a host namespace)."""
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    return (first_seg(name) in TRACED_ROOTS
            and not (name or "").startswith(HOST_TORCH_PREFIXES))


def _is_traced_source(node) -> bool:
    return _is_torch_call(node) or (
        isinstance(node, ast.Call)
        and last_seg(call_name(node)) in DEVICE_COLLECTIVES)


def _mentions(expr, names: set, also_sources=None) -> bool:
    for n in walk(expr):
        if _taint_carrier(n, names):
            return True
        if also_sources is not None and also_sources(n):
            return True
    return False


def _has_early_exit(body_nodes) -> bool:
    for stmt in body_nodes:
        for n in walk(stmt):
            if isinstance(n, (ast.Return, ast.Raise, ast.Continue,
                              ast.Break)):
                # Exits inside nested defs execute later, elsewhere.
                if enclosing_function(n) is enclosing_function(stmt):
                    return True
    return False


# -- DJL001 collective-divergence -------------------------------------


class CollectiveDivergence:
    id = "DJL001"
    name = "collective-divergence"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        for scope in outermost_scopes(mod.tree):
            tainted = tainted_names(scope, _is_rank_source)

            def rank_dep(expr) -> bool:
                return _mentions(expr, tainted,
                                 also_sources=_is_rank_source)

            collectives = [
                n for n in walk(scope)
                if isinstance(n, ast.Call)
                and last_seg(call_name(n)) in COLLECTIVE_CALLEES
            ]
            for call in collectives:
                cname = last_seg(call_name(call))
                prev = call
                hit = None
                for anc in parents(call):
                    if anc is scope:
                        break
                    if isinstance(anc, (ast.If, ast.While)) \
                            and prev is not anc.test \
                            and rank_dep(anc.test):
                        hit = anc.test
                    elif isinstance(anc, ast.IfExp) \
                            and prev is not anc.test \
                            and rank_dep(anc.test):
                        hit = anc.test
                    elif isinstance(anc, ast.For) \
                            and prev is not anc.iter \
                            and rank_dep(anc.iter):
                        hit = anc.iter
                    if hit is not None:
                        break
                    prev = anc
                if hit is not None:
                    yield Finding(
                        self.id, self.name, mod.path, call.lineno,
                        f"collective {cname}() under a rank-dependent "
                        f"branch (condition at line {hit.lineno}) — "
                        "SPMD ranks would issue different collective "
                        "sequences and deadlock",
                    )

            # Rank-dependent early exit with collectives issued after
            # it: the exiting rank skips them, every other rank blocks.
            for iff in walk(scope):
                if not isinstance(iff, ast.If) or not rank_dep(iff.test):
                    continue
                if not (_has_early_exit(iff.body)
                        or _has_early_exit(iff.orelse)):
                    continue
                fn = enclosing_function(iff)
                for call in collectives:
                    if enclosing_function(call) is not fn:
                        continue
                    if call.lineno <= iff.lineno:
                        continue
                    if any(a is iff for a in parents(call)):
                        continue  # inside the if itself: handled above
                    yield Finding(
                        self.id, self.name, mod.path, call.lineno,
                        f"collective {last_seg(call_name(call))}() is "
                        f"reachable after a rank-dependent early exit "
                        f"(line {iff.lineno}) — exiting ranks skip it "
                        "while the rest block in it",
                    )


# -- DJL002 hidden-sync -----------------------------------------------


def _span_withs(tree: ast.Module) -> List[ast.With]:
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call) \
                    and last_seg(call_name(ctx)) in ("span",
                                                     "span_scope"):
                out.append(node)
                break
    return out


def _span_label(with_node: ast.With) -> str:
    for item in with_node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Call) and ctx.args:
            a = ctx.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
    return "?"


class HiddenSync:
    id = "DJL002"
    name = "hidden-sync"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        for w in _span_withs(mod.tree):
            scope = enclosing_function(w) or mod.tree
            tainted = tainted_names(scope, _is_traced_source)
            label = _span_label(w)
            seen = set()
            for node in walk(w):
                if not isinstance(node, ast.Call):
                    continue
                f = self._classify(node, tainted)
                if f and (node.lineno, f) not in seen:
                    seen.add((node.lineno, f))
                    yield Finding(
                        self.id, self.name, mod.path, node.lineno,
                        f"{f} inside span '{label}' — a hidden device "
                        "sync mis-bills device completion to the span; "
                        "register the completion scalar with "
                        "sp.sync_on(...) instead (telemetry/spans.py)",
                    )

    def _classify(self, call: ast.Call, tainted) -> Optional[str]:
        name = call_name(call)
        seg = last_seg(name)
        if seg in SYNC_CALLEES:
            return f"{seg}()"
        bare = (not call.args and not call.keywords
                and isinstance(call.func, ast.Attribute))
        if bare and seg in SYNC_METHODS:
            return f".{seg}()"
        if bare and seg == "tolist" and _mentions(
                call.func.value, tainted, also_sources=_is_traced_source):
            return ".tolist() on a tensor"
        arg = call.args[0] if len(call.args) == 1 else None
        if arg is None:
            return None

        def arg_traced() -> bool:
            return _mentions(arg, tainted,
                             also_sources=_is_traced_source)

        if isinstance(call.func, ast.Name) \
                and call.func.id in ("int", "float", "bool") \
                and arg_traced():
            return f"{call.func.id}() on a tensor"
        if first_seg(name) in NP_ROOTS \
                and seg in ("asarray", "array") and arg_traced():
            return f"{name}() on a tensor"
        return None


# -- DJL004 host-sync-reduction ----------------------------------------


def _is_torch_reduction(node, tainted: set) -> bool:
    """``torch.sum(x)``, or ``x.sum()`` on a receiver that holds a
    tensor: one derived, in the same function, from a ``torch.*`` call or
    a device collective."""
    if not isinstance(node, ast.Call) \
            or last_seg(call_name(node)) not in REDUCERS:
        return False
    if first_seg(call_name(node)) in TRACED_ROOTS:
        return True
    return (isinstance(node.func, ast.Attribute)
            and _mentions(node.func.value, tainted,
                          also_sources=_is_traced_source))


class HostSyncReduction:
    id = "DJL004"
    name = "host-sync-reduction"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        scopes = outermost_scopes(mod.tree) or [mod.tree]
        seen = set()
        for scope in [mod.tree, *scopes]:
            tainted = tainted_names(scope, _is_traced_source)
            for node in walk(scope):
                if id(node) in seen or not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Name) \
                        and node.func.id in ("int", "float") \
                        and len(node.args) == 1:
                    what = node.func.id
                    inner = [sub for sub in walk(node.args[0])
                             if _is_torch_reduction(sub, tainted)]
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "item" and not node.args \
                        and _is_torch_reduction(node.func.value, tainted):
                    what = ".item"
                    inner = [node.func.value]
                else:
                    continue
                if inner:
                    seen.add(id(node))
                    yield Finding(
                        self.id, self.name, mod.path, node.lineno,
                        f"{what}({call_name(inner[0])}(...)) reads a "
                        "torch reduction back to the host: a device sync "
                        "(the kernel pipeline makes none; ops/join.py)",
                    )


# -- DJL005 tape-parity -----------------------------------------------


TAPE_METHODS = {"add", "record_min", "scoped", "gathered"}


class TapeParity:
    id = "DJL005"
    name = "tape-parity"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        for fn in walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            tape_like = {
                a.arg for a in (fn.args.args + fn.args.kwonlyargs)
                if a.arg == "tape"
            }
            # with_integrity is the second parity switch: the
            # integrity digests ride the same aux Metrics slot, so a
            # tape expression guarded on it is exactly as sound as one
            # guarded on with_metrics.
            has_with_metrics = any(
                a.arg in ("with_metrics", "with_integrity")
                for a in fn.args.args + fn.args.kwonlyargs
            )
            for node in fn.body:
                for sub in walk(node):
                    if enclosing_function(sub) is not fn:
                        continue
                    if isinstance(sub, ast.Assign) \
                            and self._guarded_tape_expr(sub.value):
                        for t in sub.targets:
                            if isinstance(t, ast.Name):
                                tape_like.add(t.id)
                    elif (isinstance(sub, ast.Assign)
                          and has_with_metrics
                          and self._bare_tape_ctor(sub.value)):
                        yield Finding(
                            self.id, self.name, mod.path, sub.lineno,
                            "MetricsTape constructed unconditionally "
                            "in a function taking with_metrics= — "
                            "telemetry-off would no longer run "
                            "the seed step (guard with `... if "
                            "with_metrics else None`)",
                        )
            if not tape_like:
                continue
            guards = tape_like | {"with_metrics", "with_integrity"}
            for node in walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in TAPE_METHODS
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in tape_like):
                    continue
                if not self._guarded(node, fn, guards):
                    yield Finding(
                        self.id, self.name, mod.path, node.lineno,
                        f"unguarded {node.func.value.id}."
                        f"{node.func.attr}(...) — tape may be None "
                        "(telemetry off); guard with `if "
                        f"{node.func.value.id} is not None:` so "
                        "telemetry-off stays the seed step",
                    )

    def _guarded_tape_expr(self, value) -> bool:
        """``X if <cond> else None`` where X builds/derives a tape."""
        if not (isinstance(value, ast.IfExp)
                and isinstance(value.orelse, ast.Constant)
                and value.orelse.value is None):
            return False
        for n in walk(value.body):
            if isinstance(n, ast.Call) and last_seg(call_name(n)) in (
                    "MetricsTape", "scoped"):
                return True
        return False

    def _bare_tape_ctor(self, value) -> bool:
        return (isinstance(value, ast.Call)
                and last_seg(call_name(value)) == "MetricsTape")

    def _guarded(self, call, fn, guard_names) -> bool:
        prev = call
        for anc in parents(call):
            if anc is fn:
                return False
            if isinstance(anc, (ast.If, ast.IfExp)) \
                    and prev is not anc.test \
                    and _mentions(anc.test, guard_names):
                return True
            prev = anc
        return False


# -- DJL006 unused-symbol ---------------------------------------------


class UnusedSymbol:
    id = "DJL006"
    name = "unused-symbol"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        is_init = mod.path.endswith("__init__.py")
        exported = self._dunder_all(mod.tree)
        # imports per scope (module or the function they live in)
        scopes: dict = {}
        for node in walk(mod.tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(node, ast.ImportFrom) \
                    and node.module == "__future__":
                continue
            scope = enclosing_function(node) or mod.tree
            scopes.setdefault(id(scope), (scope, []))[1].append(node)
        for scope, imports in scopes.values():
            imports.sort(key=lambda n: n.lineno)
            used = {
                n.id for n in walk(scope)
                if isinstance(n, ast.Name)
            }
            used |= self._string_annotation_names(scope)
            bound: dict = {}
            for imp in imports:
                for alias in imp.names:
                    if alias.name == "*":
                        continue
                    name = alias.asname or alias.name.split(".")[0]
                    in_try = any(isinstance(p, ast.Try)
                                 for p in parents(imp))
                    if name in bound and not in_try \
                            and not bound[name][1]:
                        yield Finding(
                            self.id, self.name, mod.path, imp.lineno,
                            f"duplicate import of {name!r} (first "
                            f"bound at line {bound[name][0]}) — one "
                            "of the two is dead, or one shadows the "
                            "other",
                        )
                    else:
                        bound[name] = (imp.lineno, in_try)
                    if is_init or name in exported:
                        continue  # re-export idiom
                    if name not in used:
                        yield Finding(
                            self.id, self.name, mod.path, imp.lineno,
                            f"import {name!r} is never used in its "
                            "scope",
                        )

    def _string_annotation_names(self, scope) -> set:
        """Identifier tokens inside STRING annotations (forward refs
        like ``Optional["KernelConfig"]`` never appear as Name
        nodes)."""
        import re as _re

        anns = []
        for n in walk(scope):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                anns.extend(a.annotation
                            for a in n.args.args + n.args.kwonlyargs
                            if a.annotation is not None)
                if n.returns is not None:
                    anns.append(n.returns)
            elif isinstance(n, ast.AnnAssign):
                anns.append(n.annotation)
        out: set = set()
        for ann in anns:
            for c in walk(ann):
                if isinstance(c, ast.Constant) \
                        and isinstance(c.value, str):
                    out.update(_re.findall(r"[A-Za-z_]\w*", c.value))
        return out

    def _dunder_all(self, tree) -> set:
        out: set = set()
        for node in tree.body:
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "__all__"
                            for t in node.targets) \
                    and isinstance(node.value, (ast.List, ast.Tuple)):
                out.update(
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                )
        return out


ALL_RULES = (
    CollectiveDivergence(),
    HiddenSync(),
    HostSyncReduction(),
    TapeParity(),
    UnusedSymbol(),
)
