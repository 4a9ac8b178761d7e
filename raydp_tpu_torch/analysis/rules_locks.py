"""R1 lock-discipline.

Builds a per-module lock-acquisition graph and reports:

* ``lock-held-blocking`` (error) — a blocking call (RPC, queue get,
  ``time.sleep``, subprocess, ``future.result()``, ``Event.wait``,
  thread ``join``) executed while a lock is held. This is the shape of
  the ``SPMDJob`` dispatch stalls and the flight-recorder SIGTERM hang.
* ``lock-held-blocking-transitive`` (warning) — same, but the blocking
  call sits one resolved call away (depth 1 only, to stay quiet).
* ``lock-order-inversion`` (error) — two locks acquired in both
  ``A→B`` and ``B→A`` order somewhere in the same module.
* ``lock-reacquire`` (error) — a non-reentrant lock acquired while
  already held (guaranteed self-deadlock).

Lock identity is normalized so ``self._mu`` inside ``class C`` of
module ``m`` becomes ``m.C._mu`` — order edges line up across methods.
The walk is path-insensitive inside a function (branch-local
``acquire()`` effects don't leak out) but tracks ``try/finally``
release so the canonical ``acquire(); try: ...; finally: release()``
idiom doesn't poison the rest of the function.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from raydp_tpu_torch.analysis.callgraph import (
    CallGraph,
    FunctionInfo,
    call_name,
    classify_blocking,
    qual_last,
    walk_no_nested,
)
from raydp_tpu_torch.analysis.core import Finding, ModuleInfo, Project

RULE = "R1"

_LOCK_CTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
    "multiprocessing.Lock", "multiprocessing.RLock",
}
_REENTRANT_CTORS = {"RLock", "threading.RLock", "multiprocessing.RLock"}

# name-based fallback when the constructor site isn't visible
_LOCKY_NAMES = ("lock", "_mu", "mutex", "_cv", "cond")


def _looks_like_lock(dotted: str) -> bool:
    last = qual_last(dotted).lower()
    return any(last == t or last.endswith(t) for t in _LOCKY_NAMES)


class _LockRegistry:
    """Which attributes/names are locks, and which are reentrant."""

    def __init__(self) -> None:
        self.kinds: Dict[str, str] = {}  # normalized id -> ctor name

    def record(self, norm: str, ctor: str) -> None:
        self.kinds[norm] = ctor

    def is_known(self, norm: str) -> bool:
        return norm in self.kinds

    def is_reentrant(self, norm: str) -> bool:
        return self.kinds.get(norm) in _REENTRANT_CTORS


def _normalize(dotted: str, fn: Optional[FunctionInfo], mod: ModuleInfo) -> str:
    """``self._mu`` in ``m.C.f`` → ``m.C._mu``; bare ``x`` → ``m.x``."""
    if dotted.startswith("self.") and fn is not None and fn.cls:
        return f"{fn.cls}.{dotted[len('self.'):]}"
    if "." not in dotted:
        return f"{mod.name}.{dotted}"
    return dotted


def _collect_locks(project: Project, graph: CallGraph) -> _LockRegistry:
    reg = _LockRegistry()
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            ctor = call_name(node.value.func)
            if ctor not in _LOCK_CTORS:
                continue
            fn = graph.enclosing_function(mod, node.lineno)
            for t in node.targets:
                tgt = call_name(t)
                if tgt:
                    reg.record(_normalize(tgt, fn, mod), ctor)
    return reg


def _lock_expr(expr: ast.AST, reg: _LockRegistry,
               fn: Optional[FunctionInfo], mod: ModuleInfo) -> Optional[str]:
    """Normalized lock id if ``expr`` denotes a lock, else None."""
    dotted = call_name(expr)
    if not dotted:
        return None
    norm = _normalize(dotted, fn, mod)
    if reg.is_known(norm) or _looks_like_lock(dotted):
        return norm
    return None


def check(project: Project) -> List[Finding]:
    graph: CallGraph = project.graph
    reg = _collect_locks(project, graph)
    findings: List[Finding] = []
    # module -> ordered (outer, inner, path, line) edges for inversions
    edges: Dict[str, List[Tuple[str, str, str, int]]] = {}

    for fn in graph.functions.values():
        if isinstance(fn.node, ast.Lambda):
            continue
        scanner = _Scanner(fn, graph, reg, findings,
                           edges.setdefault(fn.module.name, []))
        scanner.scan(fn.node.body, [])

    for es in edges.values():
        _report_inversions(es, findings)
    return findings


class _Scanner:
    """Recursive statement walker tracking the held-lock stack."""

    def __init__(self, fn: FunctionInfo, graph: CallGraph,
                 reg: _LockRegistry, findings: List[Finding],
                 edges: List[Tuple[str, str, str, int]]):
        self.fn = fn
        self.mod = fn.module
        self.graph = graph
        self.reg = reg
        self.findings = findings
        self.edges = edges

    def scan(self, stmts, held: List[str]) -> None:
        held = list(held)
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                for item in stmt.items:
                    lock = _lock_expr(item.context_expr, self.reg,
                                      self.fn, self.mod)
                    if lock is not None:
                        self._on_acquire(lock, stmt, held + acquired)
                        acquired.append(lock)
                    else:
                        self._scan_expr(item.context_expr, held)
                self.scan(stmt.body, held + acquired)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(stmt.test, held)
                self.scan(stmt.body, held)
                self.scan(stmt.orelse, held)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(stmt.iter, held)
                self.scan(stmt.body, held)
                self.scan(stmt.orelse, held)
            elif isinstance(stmt, ast.Try):
                self.scan(stmt.body, held)
                for h in stmt.handlers:
                    self.scan(h.body, held)
                self.scan(stmt.orelse, held)
                self.scan(stmt.finalbody, held)
                # `acquire(); try: ... finally: release()` — honour the
                # finally-release so code after the try isn't poisoned
                for lock in self._released_in(stmt.finalbody):
                    if lock in held:
                        held.remove(lock)
            else:
                self._scan_simple(stmt, held)

    # -- helpers -------------------------------------------------------

    def _released_in(self, stmts) -> List[str]:
        out = []
        for stmt in stmts:
            for node in walk_no_nested(stmt):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "release":
                    lock = _lock_expr(node.func.value, self.reg,
                                      self.fn, self.mod)
                    if lock is not None:
                        out.append(lock)
        return out

    def _scan_expr(self, expr: ast.AST, held: List[str]) -> None:
        if expr is None:
            return
        for node in walk_no_nested(expr):
            if isinstance(node, ast.Call):
                self._check_call(node, held, mutate=None)

    def _scan_simple(self, stmt: ast.stmt, held: List[str]) -> None:
        for node in walk_no_nested(stmt):
            if isinstance(node, ast.Call):
                self._check_call(node, held, mutate=held)

    def _check_call(self, node: ast.Call, held: List[str],
                    mutate: Optional[List[str]]) -> None:
        label = classify_blocking(
            node, self.graph.resolved_external(self.fn, node))
        if label is None:
            if held:
                self._check_transitive(node, held)
            return
        if label.startswith("lock acquire"):
            lock = _lock_expr(node.func.value, self.reg, self.fn, self.mod) \
                if isinstance(node.func, ast.Attribute) else None
            if lock is not None:
                self._on_acquire(lock, node, held)
                if mutate is not None and lock not in mutate:
                    mutate.append(lock)
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "release":
            lock = _lock_expr(node.func.value, self.reg, self.fn, self.mod)
            if lock is not None and mutate is not None and lock in mutate:
                mutate.remove(lock)
            return
        if not held:
            return
        # Condition.wait() releases the lock it is paired with
        if ".wait()" in label and isinstance(node.func, ast.Attribute):
            cv = _lock_expr(node.func.value, self.reg, self.fn, self.mod)
            if cv is not None and cv in held:
                return
        self.findings.append(Finding(
            rule=RULE, name="lock-held-blocking", severity="error",
            path=self.mod.rel, line=node.lineno, col=node.col_offset,
            message=f"{label} while holding {_short(held[-1])}; release "
                    f"the lock or move the blocking work outside it",
            scope=self.fn.qualname,
        ))

    def _on_acquire(self, lock: str, node: ast.AST,
                    held: List[str]) -> None:
        if not held:
            return
        for outer in held:
            self.edges.append((outer, lock, self.mod.rel, node.lineno))
        if lock in held and not self.reg.is_reentrant(lock):
            self.findings.append(Finding(
                rule=RULE, name="lock-reacquire", severity="error",
                path=self.mod.rel, line=node.lineno, col=node.col_offset,
                message=f"{_short(lock)} re-acquired while already held "
                        f"(non-reentrant: self-deadlock)",
                scope=self.fn.qualname,
            ))

    def _check_transitive(self, node: ast.Call, held: List[str]) -> None:
        target = self.graph.resolve_call(self.fn, node)
        if not target:
            return
        callee = self.graph.functions.get(target)
        if callee is None:
            return
        for call, _t in callee.calls:
            label = classify_blocking(
                call, self.graph.resolved_external(callee, call))
            if label is None or label.startswith("lock acquire"):
                continue
            self.findings.append(Finding(
                rule=RULE, name="lock-held-blocking-transitive",
                severity="warning",
                path=self.mod.rel, line=node.lineno, col=node.col_offset,
                message=f"call to {qual_last(target)}() while holding "
                        f"{_short(held[-1])}; callee does {label} "
                        f"(at {callee.module.rel}:{call.lineno})",
                scope=self.fn.qualname,
            ))
            return  # one report per call site is enough


def _short(lock: str) -> str:
    parts = lock.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else lock


def _report_inversions(edges: List[Tuple[str, str, str, int]],
                       findings: List[Finding]) -> None:
    order: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for outer, inner, path, line in edges:
        if outer == inner:
            continue
        order.setdefault((outer, inner), (path, line))
    reported: Set[frozenset] = set()
    for (a, b), (path, line) in sorted(order.items()):
        pair = frozenset((a, b))
        if pair in reported or (b, a) not in order:
            continue
        reported.add(pair)
        other_path, other_line = order[(b, a)]
        findings.append(Finding(
            rule=RULE, name="lock-order-inversion", severity="error",
            path=path, line=line, col=0,
            message=f"lock order inversion: {_short(a)} -> {_short(b)} "
                    f"here but {_short(b)} -> {_short(a)} at "
                    f"{other_path}:{other_line}; pick one global order",
            scope="",
        ))
