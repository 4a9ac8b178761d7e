"""R5 device hazards.

Host↔device synchronization inside hot code is the quiet throughput
killer on a GPU: a single ``.item()`` in a step loop waits for every
kernel queued before it, so the host stops running ahead of the card.
Inside a captured CUDA graph a sync is worse: it fails the capture or
freezes a host value into every replay. Checks:

* ``host-sync-in-jit`` (error) — ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``float(x)``/``int(x)`` on non-literals
  and ``torch.cuda.synchronize()`` inside a captured step: the function
  handed to :class:`~raydp_tpu_torch.utils.graphed.CapturedStep`, or
  the body of a ``with torch.cuda.graph(...)`` block. The name is the
  JAX package's (a captured step is the port's jitted program).
* ``host-sync-in-step-loop`` (warning) — per-iteration ``.item()`` /
  ``.cpu()`` / ``.tolist()`` / ``torch.cuda.synchronize()`` inside a
  training step loop (a ``for``/``while`` in a function whose name
  mentions train/fit/epoch/step). Profiling helpers are exempt:
  syncing before reading a timer is the one legitimate use. A loop's
  ``.numpy()`` is not counted: it works on host tensors only, so the
  wait is the ``.cpu()`` before it.
* ``host-sync-in-decode-loop`` (warning) — the same syncs inside an
  autoregressive decode loop (a ``for``/``while`` in a function whose
  name mentions decode/generate/run_round). Decode rounds must fetch
  the whole batch's tokens in ONE host sync per round — a per-token
  sync serializes the round loop exactly like a per-step ``.item()``
  serializes training, but at token frequency.

The JAX package's ``jit-missing-donation`` and ``device-put-in-jit``
have no counterpart: PyTorch has no buffer donation (an optimizer
updates its parameters in place), and placing a tensor inside a
captured step is a copy the graph records like any other kernel.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from raydp_tpu_torch.analysis.callgraph import (
    CallGraph,
    FunctionInfo,
    call_name,
    walk_no_nested,
)
from raydp_tpu_torch.analysis.core import Finding, Project

RULE = "R5"

_LOOPY_FN_HINTS = ("train", "fit", "epoch", "step_loop", "run_steps")
_DECODE_FN_HINTS = ("decode", "generate", "run_round", "token_loop")
_PROFILING_HINTS = ("profil", "bench", "timing", "measure", "trace",
                    "warmup")

# Tensor methods that copy to the host and wait for the card; in a
# captured step ``.numpy()`` too, which reads a host value once.
_SYNC_METHODS = ("item", "cpu", "tolist")
_CAPTURED_SYNC_METHODS = _SYNC_METHODS + ("numpy",)
_CAPTURE_CLASSES = ("CapturedStep",)


def _sync_label(node: ast.Call,
                methods=_SYNC_METHODS) -> Optional[str]:
    """``"`.item()`"`` and the like if ``node`` is a host sync (a
    ``float``/``int`` cast is not: it is the caller's to judge)."""
    name = call_name(node.func)
    last = name.rsplit(".", 1)[-1] if name else ""
    if isinstance(node.func, ast.Attribute) and last in methods \
            and not node.args:
        return f"`.{last}()`"
    if name.endswith("cuda.synchronize"):
        return "`torch.cuda.synchronize()`"
    return None


def _captured_bodies(project: Project, graph: CallGraph) -> Set[str]:
    """Functions handed to ``CapturedStep(...)`` (first argument or
    ``fn=``) anywhere in the project → their qualnames."""
    from raydp_tpu_torch.analysis.rules_signals import _resolve_ref

    out: Set[str] = set()
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node.func).rsplit(".", 1)[-1] \
                    not in _CAPTURE_CLASSES:
                continue
            body = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "fn"), None)
            dotted = call_name(body) if body is not None else ""
            if not dotted:
                continue
            fn = graph.enclosing_function(mod, node.lineno)
            target = _resolve_ref(graph, mod, fn, dotted)
            if target:
                out.add(target)
    return out


def _is_graph_block(stmt: ast.AST) -> bool:
    if not isinstance(stmt, (ast.With, ast.AsyncWith)):
        return False
    return any(isinstance(item.context_expr, ast.Call) and
               call_name(item.context_expr.func).endswith("cuda.graph")
               for item in stmt.items)


def _profiling_context(fn: FunctionInfo) -> bool:
    text = (fn.qualname + " " + fn.module.rel).lower()
    return any(h in text for h in _PROFILING_HINTS)


def check(project: Project) -> List[Finding]:
    graph: CallGraph = project.graph
    findings: List[Finding] = []
    captured = _captured_bodies(project, graph)

    for qual, fn in graph.functions.items():
        if isinstance(fn.node, ast.Lambda):
            continue
        if qual in captured:
            _scan_captured(fn, fn.node.body, findings)
        for stmt in ast.walk(fn.node):
            if _is_graph_block(stmt):
                _scan_captured(fn, stmt.body, findings)
        if any(h in fn.node.name.lower() for h in _LOOPY_FN_HINTS) and \
                not _profiling_context(fn):
            _scan_loops(fn, findings, "host-sync-in-step-loop",
                        "every iteration waits for the card and stops "
                        "the host running ahead; accumulate on device "
                        "and sync once per log interval")
        if any(h in fn.node.name.lower() for h in _DECODE_FN_HINTS) and \
                not _profiling_context(fn) and \
                "reference" not in fn.node.name.lower():
            _scan_loops(fn, findings, "host-sync-in-decode-loop",
                        "per token serializes the decode round; fetch "
                        "the whole batch's tokens in one host copy per "
                        "round")
    return findings


def _iter_calls(stmts):
    for stmt in stmts:
        for node in walk_no_nested(stmt):
            if isinstance(node, ast.Call):
                yield node


def _scan_captured(fn: FunctionInfo, stmts,
                   findings: List[Finding]) -> None:
    mod = fn.module
    for node in _iter_calls(stmts):
        label = _sync_label(node, _CAPTURED_SYNC_METHODS)
        name = call_name(node.func)
        if label is None and name in ("float", "int") and \
                len(node.args) == 1 and \
                not isinstance(node.args[0], ast.Constant):
            label = f"`{name}()` on a tensor"
        if label is None:
            continue
        findings.append(Finding(
            rule=RULE, name="host-sync-in-jit", severity="error",
            path=mod.rel, line=node.lineno, col=node.col_offset,
            message=f"{label} inside a captured CUDA graph step is a "
                    f"host sync (it fails the capture or freezes a host "
                    f"value into every replay)",
            scope=fn.qualname,
        ))


def _scan_loops(fn: FunctionInfo, findings: List[Finding], name: str,
                why: str) -> None:
    """Host syncs inside any ``for``/``while`` of ``fn``; reference
    implementations are exempt by name (a ``reference_*`` decode is
    *supposed* to be the slow unbatched path)."""
    mod = fn.module
    seen: Set[Tuple[int, int]] = set()
    for stmt in ast.walk(fn.node):
        if not isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
            continue
        for node in _iter_calls(stmt.body):
            label = _sync_label(node)
            if label is None or (node.lineno, node.col_offset) in seen:
                continue  # nested loops walk the same body twice
            seen.add((node.lineno, node.col_offset))
            findings.append(Finding(
                rule=RULE, name=name, severity="warning",
                path=mod.rel, line=node.lineno, col=node.col_offset,
                message=f"{label} {why}", scope=fn.qualname,
            ))
