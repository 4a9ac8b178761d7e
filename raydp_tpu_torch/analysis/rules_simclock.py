"""R6 — clock-seam discipline: simulable modules never read the wall
clock directly.

The simulator (:mod:`raydp_tpu_torch.sim`) works by installing a virtual
clock behind :mod:`raydp_tpu_torch.utils.clock`. That only holds if every
time read, sleep, and timed wait in the simulated code routes through
the seam: one stray ``time.monotonic()`` in the arbiter and a
virtual-hour cooldown silently compares a virtual timestamp against a
wall timestamp — the worst kind of bug, because nothing crashes and
every simulated cooldown/TTL/linger number is quietly wrong.

The rule bans direct ``time.monotonic`` / ``time.time`` /
``time.sleep`` / ``time.perf_counter`` calls (and ``threading.Timer``
construction, which embeds a real-clock sleep) in the modules the
simulator runs:

* everything under ``raydp_tpu_torch/control/``
* ``raydp_tpu_torch/serve/batching.py`` (the queue the sim drives)
* everything under ``raydp_tpu_torch/sim/`` (the simulator itself must go
  through the seam's ``Clock`` objects, not the wall)

``time.time()`` for *wall-stamping* records (not durations) is out of
scope elsewhere in the tree; inside the fence it is still flagged —
the simulated timeline must be internally consistent.

Fix: ``from raydp_tpu_torch.utils import clock as _clock`` and use
``_clock.monotonic() / sleep / wait_on / wait_event / call_later /
defer``. A deliberate wall read (e.g. a real-time watchdog inside the
sim) instantiates ``clock.Clock()`` explicitly — the real
implementation, reached through the seam's type, which the rule
accepts.
"""
from __future__ import annotations

import ast
from typing import List

from raydp_tpu_torch.analysis.core import Finding, Project

RULE = "R6"

#: Module prefixes (repo-relative, '/'-separated) inside the fence.
FENCED_PREFIXES = ("raydp_tpu_torch/control/", "raydp_tpu_torch/sim/")
#: Individual fenced files.
FENCED_FILES = ("raydp_tpu_torch/serve/batching.py",)

_BANNED_TIME_ATTRS = (
    "monotonic", "time", "sleep", "perf_counter", "monotonic_ns",
    "perf_counter_ns",
)


def _fenced(rel: str) -> bool:
    return rel in FENCED_FILES or any(
        rel.startswith(p) for p in FENCED_PREFIXES
    )


def _scope_of(stack: List[str]) -> str:
    return ".".join(stack)


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, findings: List[Finding]):
        self.rel = rel
        self.findings = findings
        self.stack: List[str] = []
        # Names that alias the time module in this file
        # (``import time``, ``import time as t``).
        self.time_aliases = {"time"}

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "time":
                self.time_aliases.add(alias.asname or "time")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "time":
            for alias in node.names:
                if alias.name in _BANNED_TIME_ATTRS:
                    self._flag(
                        node,
                        f"from time import {alias.name}",
                        f"imports time.{alias.name} directly; route "
                        "through raydp_tpu_torch.utils.clock so the "
                        "simulator's virtual clock applies",
                    )
        self.generic_visit(node)

    def _walk_scope(self, node, name: str) -> None:
        self.stack.append(name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._walk_scope(node, node.name)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._walk_scope(node, node.name)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._walk_scope(node, node.name)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if (isinstance(base, ast.Name)
                    and base.id in self.time_aliases
                    and fn.attr in _BANNED_TIME_ATTRS):
                self._flag(
                    node,
                    f"{base.id}.{fn.attr}()",
                    f"calls time.{fn.attr}() directly; use "
                    "raydp_tpu_torch.utils.clock so simulations replace the "
                    "clock",
                )
            elif (isinstance(base, ast.Name)
                    and base.id == "threading"
                    and fn.attr == "Timer"):
                self._flag(
                    node,
                    "threading.Timer(...)",
                    "constructs threading.Timer directly (a real-clock "
                    "sleep); use raydp_tpu_torch.utils.clock.call_later",
                )
        self.generic_visit(node)

    def _flag(self, node: ast.AST, what: str, why: str) -> None:
        self.findings.append(Finding(
            rule=RULE,
            name="direct-wall-clock",
            severity="error",
            path=self.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=f"{what} inside the clock-seam fence: {why}",
            scope=_scope_of(self.stack),
        ))


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for rel, mod in sorted(project.modules.items()):
        if not _fenced(rel):
            continue
        visitor = _Visitor(rel, findings)
        visitor.visit(mod.tree)
    return findings
