"""R4 telemetry consistency.

Three string-keyed contracts hold the telemetry plane together, and
none of them were machine-checked before this rule:

* **metric routing** — ``metrics.counter_add("x/y", ...)`` names are
  routed to dedicated Prometheus families by literal comparisons in
  ``telemetry/export.py``; anything unrouted silently lands in the
  generic ``raydp_counter_total``/``raydp_gauge``/``raydp_histogram``
  fallbacks. An emitted name must therefore be routed **or**
  documented (so the generic-family landing is a recorded decision).
  → ``unrouted-metric`` (error)
* **family docs** — every family registered via ``_Family(name, ...)``
  must appear in the docs. → ``undocumented-family`` (error)
* **env vars** — every ``RAYDP_TPU_*`` variable read in code must
  appear in the docs table. → ``undocumented-env`` (error)
* **job attribution** — the ``usage/*`` and ``job/*`` counter
  namespaces are the job accounting ledger; they are only coherent
  when both halves (the cluster-global ``usage/<kind>`` counter and
  the per-job ``job/<id>/<kind>`` counter) are emitted together, which
  is exactly what ``accounting.add_usage`` does. A raw
  ``metrics.counter_add("usage/...", ...)`` anywhere outside
  ``telemetry/accounting.py`` bypasses the ledger and silently loses
  the per-job attribution. → ``unattributed-metric`` (error)

Name resolution follows module-level string constants (e.g.
``STALL_COUNTER = "watchdog/stalls"`` used as ``counter_add(STALL_COUNTER)``),
including across modules via imports. f-string names are checked by
their static prefix against routed prefixes; fully dynamic names are
skipped (under-approximate, never noisy).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from raydp_tpu_torch.analysis.callgraph import CallGraph, call_name
from raydp_tpu_torch.analysis.core import Finding, ModuleInfo, Project

RULE = "R4"

_EMIT_METHODS = {"counter_add", "gauge_set", "gauge_max", "histogram",
                 "timer", "meter"}
_ENV_PREFIX = "RAYDP_TPU_"

# The job accounting ledger's namespaces: raw emits into these outside
# the accounting module lose per-job attribution (use add_usage).
_LEDGER_PREFIXES = ("usage/", "job/")
_LEDGER_HOME = "telemetry/accounting.py"


def _module_constants(project: Project) -> Dict[str, str]:
    """``module.NAME`` -> string value, for top-level str assignments."""
    out: Dict[str, str] = {}
    for mod in project.modules.values():
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[f"{mod.name}.{t.id}"] = node.value.value
    return out


def _resolve_str(expr: ast.AST, mod: ModuleInfo, graph: CallGraph,
                 consts: Dict[str, str]) -> Tuple[Optional[str], bool]:
    """(value, is_prefix_only). Constants resolve exactly; f-strings
    resolve to their static prefix with is_prefix_only=True; everything
    else is (None, False)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value, False
    if isinstance(expr, (ast.Name, ast.Attribute)):
        dotted = call_name(expr)
        if dotted:
            resolved = graph._resolve_dotted(mod, dotted)
            if resolved in consts:
                return consts[resolved], False
            if "." not in dotted and f"{mod.name}.{dotted}" in consts:
                return consts[f"{mod.name}.{dotted}"], False
    if isinstance(expr, ast.JoinedStr):
        prefix = ""
        for part in expr.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                prefix += part.value
            else:
                break
        return (prefix, True) if prefix else (None, False)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left, lp = _resolve_str(expr.left, mod, graph, consts)
        if left is not None and not lp:
            right, rp = _resolve_str(expr.right, mod, graph, consts)
            if right is not None and not rp:
                return left + right, False
            return left, True
    return None, False


def _export_module(project: Project) -> Optional[ModuleInfo]:
    mod = project.module_endswith("telemetry/export.py")
    if mod is not None:
        return mod
    # fixture fallback: any module that registers _Family instances
    for m in project.modules.values():
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call) and \
                    call_name(node.func).rsplit(".", 1)[-1] == "_Family":
                return m
    return None


def _routing(mod: ModuleInfo) -> Tuple[Set[str], Set[str], Set[str]]:
    """(family_names, routed_exact, routed_prefixes) from the export
    module: ``_Family("name", ...)`` first args, string literals used
    in ``==``/``in`` comparisons, and ``.startswith("p")`` prefixes."""
    families: Set[str] = set()
    exact: Set[str] = set()
    prefixes: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            fname = call_name(node.func).rsplit(".", 1)[-1]
            if fname == "_Family" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                families.add(node.args[0].value)
            elif fname == "startswith":
                for a in node.args:
                    if isinstance(a, ast.Constant) and isinstance(a.value, str):
                        prefixes.add(a.value)
        elif isinstance(node, ast.Compare):
            ops = node.ops
            if not any(isinstance(o, (ast.Eq, ast.In)) for o in ops):
                continue
            for sub in [node.left] + node.comparators:
                for c in ast.walk(sub):
                    if isinstance(c, ast.Constant) and \
                            isinstance(c.value, str) and c.value:
                        exact.add(c.value)
    return families, exact, prefixes


def _doc_text(project: Project) -> str:
    return "\n".join(project.docs.values())


def check(project: Project) -> List[Finding]:
    graph: CallGraph = project.graph
    consts = _module_constants(project)
    docs = _doc_text(project)
    findings: List[Finding] = []

    export_mod = _export_module(project)
    families: Set[str] = set()
    exact: Set[str] = set()
    prefixes: Set[str] = set()
    if export_mod is not None:
        families, exact, prefixes = _routing(export_mod)

    # 1. emitted metric names must be routed or documented
    seen_metrics: Set[Tuple[str, str, int]] = set()
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in _EMIT_METHODS or not node.args:
                continue
            value, prefix_only = _resolve_str(
                node.args[0], mod, graph, consts)
            if value is None:
                continue  # fully dynamic — out of scope
            if _ledger_name(value) and not mod.rel.endswith(_LEDGER_HOME):
                key = (mod.rel, value, node.lineno)
                if key in seen_metrics:
                    continue
                seen_metrics.add(key)
                findings.append(Finding(
                    rule=RULE, name="unattributed-metric",
                    severity="error",
                    path=mod.rel, line=node.lineno, col=node.col_offset,
                    message=f"raw emit of ledger metric '{value}' "
                            f"bypasses job attribution; use "
                            f"accounting.add_usage so the per-job "
                            f"counter is billed alongside the "
                            f"cluster-global one",
                    scope="",
                ))
                continue
            if _routed(value, prefix_only, exact, prefixes):
                continue
            if not prefix_only and value in docs:
                continue
            if prefix_only and value in docs:
                continue
            key = (mod.rel, value, node.lineno)
            if key in seen_metrics:
                continue
            seen_metrics.add(key)
            kind = "name prefix" if prefix_only else "name"
            findings.append(Finding(
                rule=RULE, name="unrouted-metric", severity="error",
                path=mod.rel, line=node.lineno, col=node.col_offset,
                message=f"metric {kind} '{value}' has no dedicated "
                        f"family route in telemetry/export.py and is "
                        f"not documented; it will land in the generic "
                        f"fallback family unannounced",
                scope="",
            ))

    # 2. every registered family must be documented
    if export_mod is not None:
        for fam in sorted(families):
            if fam not in docs:
                findings.append(Finding(
                    rule=RULE, name="undocumented-family",
                    severity="error",
                    path=export_mod.rel, line=1, col=0,
                    message=f"Prometheus family '{fam}' is registered "
                            f"in {export_mod.rel} but never mentioned "
                            f"in the docs",
                    scope="",
                ))

    # 3. every RAYDP_TPU_* env var read must be documented
    env_sites: Dict[str, Tuple[str, int]] = {}
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            var = _env_read(node, mod, graph, consts)
            if var and var.startswith(_ENV_PREFIX):
                env_sites.setdefault(var, (mod.rel, node.lineno))
        # constants that *look like* env names count as reads too when
        # passed around (covered above via resolution); nothing extra.
    for var in sorted(env_sites):
        if var not in docs:
            rel, line = env_sites[var]
            findings.append(Finding(
                rule=RULE, name="undocumented-env", severity="error",
                path=rel, line=line, col=0,
                message=f"env var '{var}' is read here but absent from "
                        f"the docs (add it to "
                        f"raydp_tpu_torch/doc/configuration.md)",
                scope="",
            ))
    return findings


def _ledger_name(value: str) -> bool:
    return any(value.startswith(p) for p in _LEDGER_PREFIXES)


def _routed(value: str, prefix_only: bool, exact: Set[str],
            prefixes: Set[str]) -> bool:
    if not prefix_only and value in exact:
        return True
    for p in prefixes:
        if value.startswith(p) or (prefix_only and p.startswith(value)):
            return True
    return False


def _env_read(node: ast.AST, mod: ModuleInfo, graph: CallGraph,
              consts: Dict[str, str]) -> Optional[str]:
    """The env-var name if ``node`` reads one: ``os.environ.get(K)``,
    ``os.environ[K]``, ``os.getenv(K)`` — K literal or constant."""
    key_expr = None
    if isinstance(node, ast.Call):
        name = call_name(node.func)
        last = name.rsplit(".", 1)[-1] if name else ""
        if (name.endswith("environ.get") or last == "getenv") and node.args:
            key_expr = node.args[0]
    elif isinstance(node, ast.Subscript):
        base = call_name(node.value)
        if base.endswith("environ"):
            key_expr = node.slice
    if key_expr is None:
        return None
    value, prefix_only = _resolve_str(key_expr, mod, graph, consts)
    if value is None or prefix_only:
        return None
    return value
