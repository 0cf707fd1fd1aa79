"""Level-1 joinlint rules, concurrency tier: DJL007-010.

The AST rules in :mod:`.rules` guard the SPMD/compiler contract; these
guard the HOST concurrency contract that grew around it (the daemon,
the fleet router, the telemetry fan-outs — 20+ ``threading`` sites).
Every rule encodes a bug class that was once fixed by hand in those
sites:

- DJL007 lock-order-inversion — a cycle in the per-class
  lock-acquisition graph: method A takes ``self._x`` then ``self._y``
  while method B takes ``self._y`` then ``self._x`` (directly or one
  call hop away through another method of the same class). Two
  threads interleaving those methods deadlock.
- DJL008 blocking-while-locked — a blocking operation (socket
  recv/accept/connect, ``subprocess`` waits, ``Thread.join``,
  ``time.sleep`` at or above the guard, file I/O) lexically inside a
  held-lock region. The admission-slot-releases-before-file-I/O class
  of bug: every request on that lock stalls behind one slow syscall.
- DJL009 thread-leak — a started ``threading.Thread`` that is neither
  ``daemon=True`` nor reachable by any ``join()``: stop/drain paths
  cannot settle it, and a non-daemon leak blocks interpreter exit.
- DJL010 lock-release-discipline — a bare ``lock.acquire()`` with no
  release in a ``finally`` (an exception between acquire and release
  leaks the lock forever), and ``os._exit`` issued while a tracked
  lock is held (the exit is fine — it never unwinds — but anything
  after the region is dead code the author probably expected to run).

Lock identity is tracked by TAINT, not by name convention: an
attribute is a lock only if some method of the same class assigns it
``threading.Lock/RLock/Condition/Semaphore(...)``; a plain name only
if it is assigned one in the same scope chain. ``RouterLease.acquire``
-style domain methods therefore never flag. The timed-acquire idiom
(``ok = lock.acquire(timeout=...)`` then a conditional release —
server.py's quiesce) is recognized and held to the weaker "some
release in the same function" bar.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

from distributed_join_tpu_torch.analysis.rules import (
    Finding,
    ParsedModule,
    call_name,
    dotted,
    enclosing_function,
    first_seg,
    last_seg,
    parents,
    walk,
)

# threading constructors whose instances this tier tracks as locks.
LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
              "BoundedSemaphore"}
# Condition methods that RELEASE the lock while blocking — calling
# them inside the lock's own region is the documented protocol, not a
# blocking-while-locked bug.
_CONDITION_WAITS = {"wait", "wait_for"}
# time.sleep at or above this many seconds inside a held-lock region
# flags; shorter constant sleeps are treated as deliberate backoff
# polls (the duplicate-fence loop sleeps 0.05 OUTSIDE its lock — the
# honest pattern this guard encodes).
SLEEP_GUARD_S = 0.05
# Blocking socket-layer calls (method names on a socket object, or
# the module-level constructor that performs a connect).
SOCKET_BLOCKING = {"accept", "recv", "recv_into", "recvfrom",
                   "connect", "create_connection", "sendall"}
# subprocess module-level calls that block until the child exits.
SUBPROCESS_BLOCKING = {"run", "call", "check_call", "check_output",
                       "communicate", "wait"}
# File-writing helpers of this repo (direct open() is matched by name).
FILE_IO_CALLEES = {"open", "atomic_write_json"}


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    return (last_seg(name) in LOCK_CTORS
            and first_seg(name) in ("threading", last_seg(name)))


def _is_thread_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    return (last_seg(name) == "Thread"
            and first_seg(name) in ("threading", "Thread"))


def _self_attr(expr) -> Optional[str]:
    """``self.X`` -> ``X`` (None for anything else)."""
    if isinstance(expr, ast.Attribute) \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return expr.attr
    return None


@dataclasses.dataclass
class _LockScope:
    """One lock-tracking scope: a class (``self.X`` locks) or the
    module (plain-name locks). ``label`` names it in findings."""

    label: str
    node: ast.AST                      # ClassDef or Module
    lock_attrs: Set[str]               # self.<attr> locks (classes)
    lock_names: Set[str]               # plain-name locks
    condition_ids: Set[str]            # the subset that are Conditions

    def lock_id(self, expr) -> Optional[str]:
        """The tracked lock id an expression refers to, if any."""
        attr = _self_attr(expr)
        if attr is not None and attr in self.lock_attrs:
            return attr
        if isinstance(expr, ast.Name) and expr.id in self.lock_names:
            return expr.id
        return None


def _functions_of(node: ast.AST, *, own: bool = True) -> List[ast.AST]:
    """Function scopes belonging directly to ``node`` (a ClassDef's
    methods, or the module's top-level functions when ``own``)."""
    out = []
    for n in walk(node):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(n)
    return out


def lock_scopes(tree: ast.Module) -> List[_LockScope]:
    """Every class holding tracked locks, plus a module scope for
    plain-name locks."""
    scopes: List[_LockScope] = []
    classes = [n for n in walk(tree) if isinstance(n, ast.ClassDef)]
    class_nodes: Set[int] = set()
    for cls in classes:
        attrs: Set[str] = set()
        conds: Set[str] = set()
        for n in walk(cls):
            if isinstance(n, ast.Assign) and _is_lock_ctor(n.value):
                for t in n.targets:
                    a = _self_attr(t)
                    if a is not None:
                        attrs.add(a)
                        if last_seg(call_name(n.value)) == "Condition":
                            conds.add(a)
        if attrs:
            scopes.append(_LockScope(label=cls.name, node=cls,
                                     lock_attrs=attrs,
                                     lock_names=set(),
                                     condition_ids=conds))
            class_nodes.add(id(cls))
    # Plain-name locks: module globals and function locals, tracked at
    # module granularity (names are resolved lexically by the callers).
    names: Set[str] = set()
    conds: Set[str] = set()
    for n in walk(tree):
        if isinstance(n, ast.Assign) and _is_lock_ctor(n.value):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if last_seg(call_name(n.value)) == "Condition":
                        conds.add(t.id)
    if names:
        scopes.append(_LockScope(label="<module>", node=tree,
                                 lock_attrs=set(), lock_names=names,
                                 condition_ids=conds))
    return scopes


def _with_regions(fn: ast.AST, scope: _LockScope
                  ) -> List[Tuple[str, ast.With]]:
    """(lock id, With node) for every ``with <tracked lock>:`` region
    in ``fn`` (nested defs excluded — they run later, elsewhere)."""
    out = []
    for n in walk(fn):
        if not isinstance(n, ast.With):
            continue
        if enclosing_function(n) is not fn:
            continue
        for item in n.items:
            lid = scope.lock_id(item.context_expr)
            if lid is not None:
                out.append((lid, n))
    return out


def _acquire_calls(fn: ast.AST, scope: _LockScope
                   ) -> List[Tuple[str, ast.Call]]:
    out = []
    for n in walk(fn):
        if isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "acquire" \
                and enclosing_function(n) is fn:
            lid = scope.lock_id(n.func.value)
            if lid is not None:
                out.append((lid, n))
    return out


def _region_calls(region: ast.With, fn: ast.AST) -> Iterator[ast.Call]:
    """Calls lexically inside a held-lock region that execute WHILE
    the lock is held (nested function bodies excluded)."""
    for n in walk(region):
        if isinstance(n, ast.Call) and enclosing_function(n) is fn:
            yield n


# -- DJL007 lock-order-inversion --------------------------------------


class LockOrderInversion:
    id = "DJL007"
    name = "lock-order-inversion"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        for scope in lock_scopes(mod.tree):
            yield from self._check_scope(mod, scope)

    def _check_scope(self, mod, scope) -> Iterator[Finding]:
        fns = [n for n in walk(scope.node)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # Pass 1: locks each function acquires directly (with-regions
        # plus explicit .acquire calls).
        fn_locks: Dict[str, Set[str]] = {}
        for fn in fns:
            ids = {lid for lid, _ in _with_regions(fn, scope)}
            ids |= {lid for lid, _ in _acquire_calls(fn, scope)}
            if ids:
                fn_locks.setdefault(fn.name, set()).update(ids)
        # Pass 2: ordered edges A -> B (A held while B is acquired),
        # from lexical nesting and from one same-class call hop.
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

        def add_edge(a: str, b: str, line: int) -> None:
            if a != b and (a, b) not in edges:
                edges[(a, b)] = (mod.path, line)

        for fn in fns:
            regions = _with_regions(fn, scope)
            for lid, region in regions:
                for inner_id, inner in regions:
                    if inner is not region \
                            and any(p is region for p in parents(inner)):
                        add_edge(lid, inner_id, inner.lineno)
                for call in _region_calls(region, fn):
                    callee = None
                    attr = _self_attr(call.func) if isinstance(
                        call.func, ast.Attribute) else None
                    if attr is not None:
                        callee = attr
                    elif isinstance(call.func, ast.Name):
                        callee = call.func.id
                    for b in fn_locks.get(callee, ()):
                        add_edge(lid, b, call.lineno)
                    inner_id = scope.lock_id(
                        call.func.value) if isinstance(
                        call.func, ast.Attribute) else None
                    if inner_id is not None \
                            and call.func.attr == "acquire":
                        add_edge(lid, inner_id, call.lineno)
        yield from self._report_cycles(scope, edges)

    def _report_cycles(self, scope, edges) -> Iterator[Finding]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        seen_cycles: Set[frozenset] = set()
        for start in sorted(graph):
            path: List[str] = []
            on_path: Set[str] = set()

            def dfs(node: str) -> Optional[List[str]]:
                if node in on_path:
                    return path[path.index(node):] + [node]
                if node not in graph:
                    return None
                path.append(node)
                on_path.add(node)
                for nxt in sorted(graph[node]):
                    cyc = dfs(nxt)
                    if cyc is not None:
                        return cyc
                path.pop()
                on_path.discard(node)
                return None

            cycle = dfs(start)
            if cycle is None:
                continue
            key = frozenset(cycle)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            first_edge = edges[(cycle[0], cycle[1])]
            sites = "; ".join(
                f"{a}->{b} at line {edges[(a, b)][1]}"
                for a, b in zip(cycle, cycle[1:]))
            yield Finding(
                self.id, self.name, first_edge[0], first_edge[1],
                f"lock-order inversion in {scope.label}: cycle "
                + " -> ".join(cycle) + f" ({sites}) — two threads "
                "interleaving these paths deadlock; pick one global "
                "order and stick to it",
            )


# -- DJL008 blocking-while-locked -------------------------------------


class BlockingWhileLocked:
    id = "DJL008"
    name = "blocking-while-locked"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        for scope in lock_scopes(mod.tree):
            fns = [n for n in walk(scope.node)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
            for fn in fns:
                popen_names = self._popen_names(fn)
                thread_ids = _thread_handles(mod.tree, fn)
                for lid, region in _with_regions(fn, scope):
                    seen = set()
                    for call in _region_calls(region, fn):
                        what = self._classify(
                            call, lid, scope, popen_names, thread_ids)
                        if what and (call.lineno, what) not in seen:
                            seen.add((call.lineno, what))
                            yield Finding(
                                self.id, self.name, mod.path,
                                call.lineno,
                                f"{what} while holding {scope.label}."
                                f"{lid} (region at line "
                                f"{region.lineno}) — every thread "
                                "contending on the lock stalls behind "
                                "it; move the blocking work outside "
                                "the region",
                            )

    def _popen_names(self, fn) -> Set[str]:
        out: Set[str] = set()
        for n in walk(fn):
            if isinstance(n, ast.Assign) \
                    and isinstance(n.value, ast.Call) \
                    and last_seg(call_name(n.value)) == "Popen":
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
        return out

    def _classify(self, call, held_id, scope, popen_names,
                  thread_ids) -> Optional[str]:
        name = call_name(call)
        seg = last_seg(name)
        recv = call.func.value if isinstance(call.func, ast.Attribute) \
            else None
        if seg in SOCKET_BLOCKING:
            # Condition.wait-style release-while-blocked protocol:
            # never socket-named, so no carve-out needed here; but a
            # connect() on the HELD lock object is nonsense — require
            # a non-lock receiver or a module-level constructor.
            if recv is not None and scope.lock_id(recv) is not None:
                return None
            return f"socket {seg}()"
        if first_seg(name) == "subprocess" \
                and seg in SUBPROCESS_BLOCKING:
            return f"subprocess.{seg}()"
        if seg in ("communicate", "wait") and recv is not None \
                and isinstance(recv, ast.Name) \
                and recv.id in popen_names:
            return f"subprocess {dotted(recv)}.{seg}()"
        if seg in _CONDITION_WAITS and recv is not None:
            lid = scope.lock_id(recv)
            if lid is not None and lid != held_id \
                    and lid not in scope.condition_ids:
                return f"{seg}() on {lid}"
            return None
        if seg == "join" and recv is not None \
                and dotted(recv) in thread_ids:
            return f"Thread {dotted(recv)}.join()"
        if seg == "sleep" and first_seg(name) in ("time", "sleep"):
            if call.args and isinstance(call.args[0], ast.Constant):
                v = call.args[0].value
                if isinstance(v, (int, float)) and v >= SLEEP_GUARD_S:
                    return f"time.sleep({v})"
                return None
            return "time.sleep(<non-constant>)"
        if isinstance(call.func, ast.Name) \
                and call.func.id in FILE_IO_CALLEES:
            return f"file I/O {call.func.id}()"
        return None


def _thread_handles(tree: ast.Module, fn) -> Set[str]:
    """Dotted names that hold Thread objects, visible from ``fn``:
    same-function locals plus any ``self.X`` assigned a Thread
    anywhere in the module."""
    out: Set[str] = set()
    for n in walk(fn):
        if isinstance(n, ast.Assign) and _is_thread_ctor(n.value):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    for n in walk(tree):
        if isinstance(n, ast.Assign) and _is_thread_ctor(n.value):
            for t in n.targets:
                a = _self_attr(t)
                if a is not None:
                    out.add(f"self.{a}")
    return out


# -- DJL009 thread-leak -----------------------------------------------


class ThreadLeak:
    id = "DJL009"
    name = "thread-leak"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        src_joins = self._joined_attrs(mod.tree)
        for ctor in walk(mod.tree):
            if not _is_thread_ctor(ctor):
                continue
            if self._daemonic(ctor):
                continue
            verdict = self._track(ctor, mod.tree, src_joins)
            if verdict is None:
                continue
            yield Finding(
                self.id, self.name, mod.path, ctor.lineno,
                f"thread {verdict} is started with neither "
                "daemon=True nor a reachable join() — stop/drain "
                "paths cannot settle it and a non-daemon leak blocks "
                "interpreter exit",
            )

    def _daemonic(self, ctor: ast.Call) -> bool:
        for kw in ctor.keywords:
            if kw.arg == "daemon" \
                    and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False

    def _joined_attrs(self, tree) -> Set[str]:
        """Attr names X with a ``<anything>.X.join(...)`` call or a
        ``<anything>.X.daemon = True`` somewhere in the module."""
        out: Set[str] = set()
        for n in walk(tree):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "join" \
                    and isinstance(n.func.value, ast.Attribute):
                out.add(n.func.value.attr)
            if isinstance(n, ast.Assign) \
                    and isinstance(n.value, ast.Constant) \
                    and n.value.value is True:
                for t in n.targets:
                    if isinstance(t, ast.Attribute) \
                            and t.attr == "daemon" \
                            and isinstance(t.value, ast.Attribute):
                        out.add(t.value.attr)
        return out

    def _track(self, ctor, tree, src_joins) -> Optional[str]:
        """None = accounted for (joined / daemonized / not visibly
        started / ownership escapes tracking); else a short label of
        the leaking handle."""
        parent = getattr(ctor, "_djl_parent", None)
        # threading.Thread(...).start() inline: started, no handle.
        if isinstance(parent, ast.Attribute) \
                and parent.attr == "start":
            return "started inline (no handle)"
        if isinstance(parent, ast.Assign):
            for t in parent.targets:
                if isinstance(t, ast.Name):
                    return self._track_local(t.id, ctor)
                attr = _self_attr(t)
                if attr is not None:
                    if attr in src_joins:
                        return None
                    if self._attr_started(tree, attr):
                        return f"self.{attr}"
                    return None
        # append(threading.Thread(...)) onto a list that is later
        # iterated-and-joined.
        if isinstance(parent, ast.Call) \
                and isinstance(parent.func, ast.Attribute) \
                and parent.func.attr == "append" \
                and isinstance(parent.func.value, ast.Name):
            lst = parent.func.value.id
            if self._list_joined(tree, lst):
                return None
            fn = enclosing_function(ctor)
            if fn is not None and self._name_started_via_list(fn, lst):
                return f"threads in {lst!r}"
            return None
        return None  # returned / passed along: ownership escapes

    def _track_local(self, name: str, ctor) -> Optional[str]:
        fn = enclosing_function(ctor)
        scope = fn if fn is not None else None
        if scope is None:
            return None
        started = joined = False
        for n in walk(scope):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == name:
                if n.func.attr == "start":
                    started = True
                if n.func.attr in ("join", "setDaemon"):
                    joined = True
            if isinstance(n, ast.Assign) \
                    and isinstance(n.value, ast.Constant) \
                    and n.value.value is True:
                for t in n.targets:
                    if isinstance(t, ast.Attribute) \
                            and t.attr == "daemon" \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == name:
                        joined = True
            if isinstance(n, ast.Return) and n.value is not None \
                    and any(isinstance(x, ast.Name) and x.id == name
                            for x in walk(n.value)):
                joined = True  # handle escapes to the caller
        return name if (started and not joined) else None

    def _attr_started(self, tree, attr: str) -> bool:
        for n in walk(tree):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "start" \
                    and isinstance(n.func.value, ast.Attribute) \
                    and n.func.value.attr == attr:
                return True
        return False

    def _name_started_via_list(self, fn, lst: str) -> bool:
        """``for t in <lst>: t.start()`` (or any .start() in a loop
        over the list)."""
        for loop in walk(fn):
            if isinstance(loop, ast.For) \
                    and any(isinstance(x, ast.Name) and x.id == lst
                            for x in walk(loop.iter)):
                for n in walk(loop):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and n.func.attr == "start":
                        return True
        return False

    def _list_joined(self, tree, lst: str) -> bool:
        for loop in walk(tree):
            if isinstance(loop, ast.For) \
                    and any(isinstance(x, ast.Name) and x.id == lst
                            for x in walk(loop.iter)):
                for n in walk(loop):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and n.func.attr == "join":
                        return True
        return False


# -- DJL010 lock-release-discipline -----------------------------------


class LockReleaseDiscipline:
    id = "DJL010"
    name = "lock-release-discipline"

    def run(self, mod: ParsedModule) -> Iterator[Finding]:
        for scope in lock_scopes(mod.tree):
            fns = [n for n in walk(scope.node)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
            for fn in fns:
                yield from self._check_fn(mod, scope, fn)
                yield from self._check_exits(mod, scope, fn)

    def _check_fn(self, mod, scope, fn) -> Iterator[Finding]:
        releases = self._releases(fn, scope)
        for lid, call in _acquire_calls(fn, scope):
            conditional = bool(call.args or call.keywords) \
                or self._result_captured(call)
            rel_any = lid in releases["any"]
            rel_finally = lid in releases["finally"]
            if conditional:
                if not rel_any:
                    yield Finding(
                        self.id, self.name, mod.path, call.lineno,
                        f"timed/conditional acquire of {scope.label}."
                        f"{lid} with no release() anywhere in "
                        f"{fn.name}() — a success leaks the lock",
                    )
                continue
            if not rel_finally:
                detail = ("release() exists but not in a finally — "
                          "an exception in between leaks the lock"
                          if rel_any else
                          "no release() in this function")
                yield Finding(
                    self.id, self.name, mod.path, call.lineno,
                    f"{scope.label}.{lid}.acquire() without "
                    f"try/finally release ({detail}); prefer "
                    f"`with {lid}:`",
                )

    def _check_exits(self, mod, scope, fn) -> Iterator[Finding]:
        for lid, region in _with_regions(fn, scope):
            for n in walk(region):
                if isinstance(n, ast.Call) \
                        and call_name(n) in ("os._exit", "_exit") \
                        and enclosing_function(n) is fn:
                    yield Finding(
                        self.id, self.name, mod.path, n.lineno,
                        f"os._exit() while holding {scope.label}."
                        f"{lid} (region at line {region.lineno}) — "
                        "the process dies mid-critical-section; "
                        "release the lock (leave the with block) "
                        "before exiting",
                    )

    def _result_captured(self, call) -> bool:
        parent = getattr(call, "_djl_parent", None)
        return isinstance(parent, (ast.Assign, ast.NamedExpr,
                                   ast.AnnAssign, ast.Compare,
                                   ast.UnaryOp, ast.BoolOp, ast.If,
                                   ast.While, ast.Return))

    def _releases(self, fn, scope) -> Dict[str, Set[str]]:
        out = {"any": set(), "finally": set()}
        for n in walk(fn):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "release" \
                    and enclosing_function(n) is fn:
                lid = scope.lock_id(n.func.value)
                if lid is None:
                    continue
                out["any"].add(lid)
                node = n
                for p in parents(n):
                    if isinstance(p, ast.Try) \
                            and any(node is s or any(
                                node is d for d in walk(s))
                                for s in p.finalbody):
                        out["finally"].add(lid)
                        break
                    if isinstance(p, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        break
        return out


CONCURRENCY_RULES = (
    LockOrderInversion(),
    BlockingWhileLocked(),
    ThreadLeak(),
    LockReleaseDiscipline(),
)
