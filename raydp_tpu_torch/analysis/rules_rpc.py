"""R3 RPC-handler discipline.

:class:`RpcServer` auto-brackets every handler with
``inflight("rpc/<method>")`` so the watchdog can see stalls — but the
stall threshold is the *short* one unless the method name is in
``_LONG_HANDLER_METHODS``. A handler that legitimately blocks for
minutes (task execution, profile capture) therefore needs to be either

* registered in the long-stall set, or
* bracketed with its own ``inflight(...)`` region around the slow part
  (so the default bracket returns quickly).

This rule finds every handler table wired into an ``RpcServer(...)``
(dict literals, either inline or assigned to a local first), resolves
the handler functions, and walks each one (bounded depth) for blocking
work. Findings:

* ``blocking-handler-not-long`` (error) — handler transitively blocks
  but its method is not in ``_LONG_HANDLER_METHODS`` and its body has
  no ``inflight()`` bracket of its own. These are watchdog
  false-stall + SIGTERM-escalation candidates.
* ``stale-long-entry`` (warning) — a ``_LONG_HANDLER_METHODS`` entry
  that no scanned handler table registers (dead config).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from raydp_tpu_torch.analysis.callgraph import (
    CallGraph,
    FunctionInfo,
    call_name,
    classify_blocking,
    walk_no_nested,
)
from raydp_tpu_torch.analysis.core import Finding, ModuleInfo, Project

RULE = "R3"

_MAX_DEPTH = 6


def _long_methods(project: Project) -> Tuple[Set[str], Optional[Tuple[ModuleInfo, int]]]:
    """Parse ``_LONG_HANDLER_METHODS = frozenset({...})`` wherever it
    is defined (cluster/rpc.py in the real tree, any module in
    fixtures). Returns the set and its definition site."""
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "_LONG_HANDLER_METHODS" not in names:
                continue
            out: Set[str] = set()
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    out.add(sub.value)
            return out, (mod, node.lineno)
    return set(), None


def _handler_tables(project: Project, graph: CallGraph):
    """Yield (module, method_name, handler_expr, lineno) for every
    entry of a handlers dict passed to an ``RpcServer(...)`` call."""
    for mod in project.modules.values():
        # dict literals assigned to names, per enclosing scope
        dicts_by_name: Dict[Tuple[Optional[str], str], ast.Dict] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
                fn = graph.enclosing_function(mod, node.lineno)
                scope = fn.qualname if fn else None
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        dicts_by_name[(scope, t.id)] = node.value
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            ctor = call_name(node.func)
            if not ctor or call_name(node.func).rsplit(".", 1)[-1] != "RpcServer":
                continue
            fn = graph.enclosing_function(mod, node.lineno)
            scope = fn.qualname if fn else None
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                d: Optional[ast.Dict] = None
                if isinstance(arg, ast.Dict):
                    d = arg
                elif isinstance(arg, ast.Name):
                    d = dicts_by_name.get((scope, arg.id)) or \
                        dicts_by_name.get((None, arg.id))
                if d is None:
                    continue
                for k, v in zip(d.keys, d.values):
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        yield mod, k.value, v, k.lineno, fn


def _has_inflight(fn: FunctionInfo) -> bool:
    for call, _t in fn.calls:
        name = call_name(call.func)
        if name and name.rsplit(".", 1)[-1] == "inflight":
            return True
    return False


def _blocking_evidence(graph: CallGraph, root: str) -> Optional[Tuple[str, str, int]]:
    """First blocking call transitively reachable from ``root``:
    (label, rel path, line). Lock acquires don't count — they are R1's
    concern and are typically short."""
    chains = graph.reachable([root], max_depth=_MAX_DEPTH)
    for qual in sorted(chains, key=lambda q: len(chains[q])):
        fn = graph.functions[qual]
        for call, _t in fn.calls:
            label = classify_blocking(
                call, graph.resolved_external(fn, call))
            if label is None or label.startswith("lock acquire"):
                continue
            return label, fn.module.rel, call.lineno
    return None


def check(project: Project) -> List[Finding]:
    graph: CallGraph = project.graph
    long_set, long_site = _long_methods(project)
    findings: List[Finding] = []
    registered: Set[str] = set()
    saw_table = False

    for mod, method, hexpr, lineno, encl in _handler_tables(project, graph):
        saw_table = True
        registered.add(method)
        if isinstance(hexpr, ast.Lambda):
            # lambdas are trivial ping-style handlers; a blocking lambda
            # would be caught by the direct scan below
            blocking = _lambda_blocking(graph, mod, encl, hexpr)
            target = None
        else:
            dotted = call_name(hexpr)
            from raydp_tpu_torch.analysis.rules_signals import _resolve_ref
            target = _resolve_ref(graph, mod, encl, dotted) if dotted else None
            blocking = _blocking_evidence(graph, target) if target else None
        if blocking is None:
            continue
        if method in long_set:
            continue
        if target and _has_inflight(graph.functions[target]):
            continue
        label, where, bline = blocking
        findings.append(Finding(
            rule=RULE, name="blocking-handler-not-long", severity="error",
            path=mod.rel, line=lineno, col=0,
            message=f"handler '{method}' does {label} (at {where}:{bline}) "
                    f"but is not in _LONG_HANDLER_METHODS and has no "
                    f"inflight() bracket; the watchdog will flag it as a "
                    f"stall and may escalate",
            scope=encl.qualname if encl else "",
        ))

    if saw_table and long_site is not None:
        mod, line = long_site
        for method in sorted(long_set - registered):
            findings.append(Finding(
                rule=RULE, name="stale-long-entry", severity="warning",
                path=mod.rel, line=line, col=0,
                message=f"_LONG_HANDLER_METHODS entry '{method}' is not "
                        f"registered by any scanned handler table",
                scope="",
            ))
    return findings


def _lambda_blocking(graph: CallGraph, mod: ModuleInfo,
                     encl: Optional[FunctionInfo],
                     lam: ast.Lambda) -> Optional[Tuple[str, str, int]]:
    fn = graph.function_at(mod, lam)
    for node in walk_no_nested(lam.body):
        if isinstance(node, ast.Call):
            resolved = graph.resolved_external(fn, node) if fn else ""
            label = classify_blocking(node, resolved)
            if label and not label.startswith("lock acquire"):
                return label, mod.rel, node.lineno
    return None
