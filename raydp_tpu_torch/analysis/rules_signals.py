"""R2 signal-safety.

Walks the call graph reachable from every handler registered via
``signal.signal(...)`` and flags operations that can deadlock or
corrupt state when the interrupted frame already holds the resource —
the exact shape of the flight recorder's SIGTERM hang, where the handler blocked on
the flight-recorder mutex held by the frame it interrupted:

* ``signal-unsafe-lock`` (error) — blocking lock acquisition
  (``with lock:`` or ``.acquire()`` without ``blocking=False``)
  reachable from a signal handler. Try-acquire is the safe idiom
  (``FlightRecorder.record_nowait``).
* ``signal-unsafe-logging`` (error) — stdlib ``logging`` calls; the
  logging machinery takes a module-level lock internally.
* ``signal-unsafe-blocking`` (error) — any other blocking call
  (sleep, subprocess, RPC, queue get) in the handler path.
* ``signal-alloc`` (warning) — unbounded allocation or serialization
  (``copy.deepcopy``, ``pickle.dumps``) in the handler path.

Reachability prunes call edges whose call site carries an inline
``# raydp: ignore[R2]`` — that is how a dual-use function documents
"this branch is not taken on the signal path" (e.g. a call guarded by
a ``signal_safe`` flag).
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Dict, List, Optional, Set

from raydp_tpu_torch.analysis.callgraph import (
    CallGraph,
    FunctionInfo,
    call_name,
    classify_blocking,
    walk_no_nested,
)
from raydp_tpu_torch.analysis.core import Finding, ModuleInfo, Project

RULE = "R2"

_SIGNAL_CONSTANTS = {"SIG_DFL", "SIG_IGN"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error",
                "exception", "critical", "log"}
_LOG_RECEIVERS = ("log", "logger", "logging")
_ALLOC_CALLS = {"copy.deepcopy", "deepcopy", "pickle.dumps",
                "pickle.dump", "marshal.dumps"}


def _handler_roots(project: Project, graph: CallGraph) -> Dict[str, ast.Call]:
    """Resolved handler qualname -> the registering ``signal.signal``
    call (for diagnostics on unresolvable handlers)."""
    roots: Dict[str, ast.Call] = {}
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node.func)
            if not (name == "signal.signal" or name.endswith(".signal")
                    or name == "signal"):
                continue
            if len(node.args) < 2:
                continue
            handler = node.args[1]
            hname = call_name(handler)
            if not hname or hname.split(".")[-1] in _SIGNAL_CONSTANTS:
                continue
            fn = graph.enclosing_function(mod, node.lineno)
            resolved = _resolve_ref(graph, mod, fn, hname)
            if resolved:
                roots[resolved] = node
    return roots


def _resolve_ref(graph: CallGraph, mod: ModuleInfo,
                 fn: Optional[FunctionInfo], dotted: str) -> Optional[str]:
    """Resolve a bare function reference (not a call) to a project
    function qualname."""
    if dotted.startswith("self.") and fn is not None and fn.cls:
        cand = f"{fn.cls}.{dotted[len('self.'):]}"
        if cand in graph.functions:
            return cand
    resolved = graph._resolve_dotted(mod, dotted)
    if resolved in graph.functions:
        return resolved
    # method on a known class (e.g. `recorder._sigterm_handler` where
    # the instance table resolved the class already)
    if "." in resolved:
        base, meth = resolved.rsplit(".", 1)
        if base in graph.classes and f"{base}.{meth}" in graph.functions:
            return f"{base}.{meth}"
    last = dotted.rsplit(".", 1)[-1]
    matches = graph._methods_by_name.get(last, [])
    if len(matches) == 1:
        return matches[0]
    cand = f"{mod.name}.{last}"
    if cand in graph.functions:
        return cand
    return None


def _r2_reachable(graph: CallGraph, roots) -> Dict[str, List[str]]:
    """BFS like CallGraph.reachable, but skips call edges whose source
    line carries an R2 suppression — the escape hatch for dual-use
    functions with a signal-safe branch."""
    chains: Dict[str, List[str]] = {}
    dq = deque()
    for r in roots:
        if r in graph.functions:
            chains[r] = [r]
            dq.append((r, 0))
    while dq:
        cur, depth = dq.popleft()
        if depth >= 12:
            continue
        fn = graph.functions[cur]
        for call, target in fn.calls:
            if not target or target in chains:
                continue
            if _edge_suppressed(fn.module, call.lineno):
                continue
            chains[target] = chains[cur] + [target]
            dq.append((target, depth + 1))
    return chains


def _edge_suppressed(mod: ModuleInfo, lineno: int) -> bool:
    lines = [lineno]
    above = lineno - 1
    while above >= 1 and mod.source_at(above).lstrip().startswith("#"):
        lines.append(above)
        above -= 1
    for line in lines:
        tokens = mod.suppressions.get(line)
        if tokens and ("all" in tokens or RULE in tokens):
            return True
    return False


def check(project: Project) -> List[Finding]:
    graph: CallGraph = project.graph
    roots = _handler_roots(project, graph)
    if not roots:
        return []
    chains = _r2_reachable(graph, roots)
    findings: List[Finding] = []
    for qual in sorted(chains):
        fn = graph.functions[qual]
        via = " -> ".join(q.rsplit(".", 1)[-1] for q in chains[qual])
        _scan_function(fn, graph, via, findings)
    return findings


def _scan_function(fn: FunctionInfo, graph: CallGraph, via: str,
                   findings: List[Finding]) -> None:
    mod = fn.module
    if isinstance(fn.node, ast.Lambda):
        nodes = list(walk_no_nested(fn.node.body))
    else:
        nodes = []
        for stmt in fn.node.body:
            nodes.extend(walk_no_nested(stmt))
    for node in nodes:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                dotted = call_name(item.context_expr)
                if dotted and _looks_locky(dotted):
                    findings.append(_mk(
                        "signal-unsafe-lock", "error", mod, node,
                        f"`with {dotted}:` reachable from signal handler "
                        f"({via}); a handler interrupting the holder "
                        f"deadlocks — use try-acquire", fn))
            continue
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node.func)
        resolved_ext = graph.resolved_external(fn, node)
        label = classify_blocking(node, resolved_ext)
        if label is not None:
            if label.startswith("lock acquire"):
                findings.append(_mk(
                    "signal-unsafe-lock", "error", mod, node,
                    f"blocking {name}() reachable from signal handler "
                    f"({via}); pass blocking=False and degrade "
                    f"gracefully", fn))
            else:
                findings.append(_mk(
                    "signal-unsafe-blocking", "error", mod, node,
                    f"{label} reachable from signal handler ({via})",
                    fn))
            continue
        if _is_logging(node, name):
            findings.append(_mk(
                "signal-unsafe-logging", "error", mod, node,
                f"logging call {name}() reachable from signal handler "
                f"({via}); the logging module takes an internal lock",
                fn))
            continue
        for alloc in _ALLOC_CALLS:
            if name == alloc or resolved_ext == alloc:
                findings.append(_mk(
                    "signal-alloc", "warning", mod, node,
                    f"unbounded allocation {name}() reachable from "
                    f"signal handler ({via}); keep handlers O(1)", fn))
                break


def _looks_locky(dotted: str) -> bool:
    last = dotted.rsplit(".", 1)[-1].lower()
    return (last == "_mu" or "lock" in last or "mutex" in last
            or last.endswith("_cv"))


def _is_logging(node: ast.Call, name: str) -> bool:
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr not in _LOG_METHODS:
        return False
    recv = call_name(node.func.value).rsplit(".", 1)[-1].lower()
    return any(recv == r or recv.endswith(r) for r in _LOG_RECEIVERS)


def _mk(name: str, severity: str, mod: ModuleInfo, node: ast.AST,
        message: str, fn: FunctionInfo) -> Finding:
    return Finding(
        rule=RULE, name=name, severity=severity, path=mod.rel,
        line=node.lineno, col=getattr(node, "col_offset", 0),
        message=message, scope=fn.qualname,
    )
