"""Project call graph + blocking-call classifier.

Builds a conservative, alias-aware call graph over every parsed module:

* a **function index** mapping qualnames (``pkg.mod.Class.method`` /
  ``pkg.mod.func``) to their AST nodes;
* per-module **import alias** tables (``from x import y as a`` →
  ``a`` resolves to ``x.y``), including function-level imports;
* **module-level instances** (``recorder = FlightRecorder()``) so
  ``recorder.record(...)`` resolves to ``FlightRecorder.record``;
* ``self.m()`` resolution to the enclosing class's method.

Resolution is best-effort and intentionally under-approximate (unknown
calls resolve to nothing rather than everything); the rules that walk
it (R2 signal-safety, R3 handler discipline) compensate by also
classifying *direct* blocking evidence syntactically.
"""
from __future__ import annotations

import ast
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from raydp_tpu_torch.analysis.core import ModuleInfo, Project

__all__ = [
    "FunctionInfo",
    "CallGraph",
    "classify_blocking",
    "call_name",
    "qual_last",
    "walk_no_nested",
]


def call_name(node: ast.AST) -> str:
    """Dotted source text of a call target: ``a.b.c`` for
    ``a.b.c(...)``; empty string for computed targets."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call):
        # chained call like FlightRecorder().record — keep the attrs only
        pass
    elif parts:
        # computed base (subscript etc.) — keep attribute tail
        pass
    else:
        return ""
    return ".".join(reversed(parts))


def qual_last(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def walk_no_nested(node: ast.AST):
    """Yield ``node`` and descendants without descending into nested
    function/class definitions — calls in a closure belong to the
    closure's own :class:`FunctionInfo`, not its parent's."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        yield from walk_no_nested(child)


# -- blocking-call classifier -------------------------------------------

# Dotted-suffix matches on the *resolved or source* call name.
_BLOCKING_SUFFIXES = (
    "time.sleep",
    "sleep",  # bare `sleep(...)` after `from time import sleep`
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "socket.create_connection",
)

# Method names that block regardless of receiver type.
_BLOCKING_METHODS = {"result", "communicate", "recv", "recv_bytes", "send_bytes"}

# RPC idioms in this repo: RpcClient.call / try_call, shipping senders.
_RPC_METHODS = {"call", "try_call"}


def _is_queue_receiver(recv: str) -> bool:
    last = qual_last(recv).lower()
    return last == "q" or last.endswith("_q") or "queue" in last


def classify_blocking(node: ast.Call, resolved: Optional[str] = None) -> Optional[str]:
    """Return a human label if ``node`` is a blocking call, else None.

    ``resolved`` is the project-resolved dotted name when the call graph
    could resolve the target (e.g. ``subprocess.run`` for an aliased
    import); the syntactic name is always checked too.
    """
    src = call_name(node.func)
    names = [n for n in (resolved, src) if n]
    for name in names:
        for suf in _BLOCKING_SUFFIXES:
            if name == suf or name.endswith("." + suf):
                return f"blocking call {name}()"
    if not isinstance(node.func, ast.Attribute):
        return None
    meth = node.func.attr
    recv = call_name(node.func.value)
    if meth in _BLOCKING_METHODS:
        return f"blocking {recv or '<expr>'}.{meth}()"
    if meth in _RPC_METHODS:
        return f"RPC {recv or '<expr>'}.{meth}()"
    if meth == "get" and _is_queue_receiver(recv):
        return f"blocking queue get {recv}.get()"
    if meth == "wait":
        # Event.wait()/Condition.wait() — any receiver; `wait(0)` with a
        # constant-zero timeout is a poll, not a block.
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(a, ast.Constant) and a.value == 0:
                return None
        return f"blocking {recv or '<expr>'}.wait()"
    if meth == "join" and not node.args:
        # thread/process join; `sep.join(iterable)` always has an arg.
        return f"blocking {recv or '<expr>'}.join()"
    if meth == "acquire":
        for kw in node.keywords:
            if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return None
        if node.args and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value is False:
            return None
        return f"lock acquire {recv or '<expr>'}.acquire()"
    return None


# -- function index + call graph ----------------------------------------


@dataclass
class FunctionInfo:
    qualname: str  # module.Class.method or module.func
    module: ModuleInfo
    node: ast.AST  # FunctionDef / AsyncFunctionDef / Lambda
    cls: Optional[str] = None  # enclosing class qualname (module.Class)
    calls: List[Tuple[ast.Call, str]] = field(default_factory=list)
    # resolved callee qualnames (filled by CallGraph)
    callees: Set[str] = field(default_factory=set)


class _Indexer(ast.NodeVisitor):
    """Collects functions, import aliases, and module-level instances
    for one module."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.functions: Dict[str, FunctionInfo] = {}
        self.aliases: Dict[str, str] = {}  # local name -> dotted target
        self.instances: Dict[str, str] = {}  # var name -> class dotted name
        self.classes: Dict[str, List[str]] = {}  # class qual -> base names
        self._stack: List[str] = [mod.name]
        self._cls_stack: List[str] = []

    # imports ----------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        if node.level:
            # relative import: resolve against this module's package
            pkg = self.mod.name.split(".")
            # drop the module segment itself plus (level-1) packages
            pkg = pkg[: len(pkg) - node.level]
            base = ".".join(pkg + ([node.module] if node.module else []))
        for a in node.names:
            if a.name == "*":
                continue
            self.aliases[a.asname or a.name] = f"{base}.{a.name}" if base else a.name
        self.generic_visit(node)

    # definitions ------------------------------------------------------
    def _qual(self, name: str) -> str:
        return ".".join(self._stack + [name])

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        qual = self._qual(node.name)
        self.classes[qual] = [call_name(b) for b in node.bases]
        self._stack.append(node.name)
        self._cls_stack.append(qual)
        self.generic_visit(node)
        self._cls_stack.pop()
        self._stack.pop()

    def _visit_func(self, node) -> None:
        qual = self._qual(node.name)
        cls = self._cls_stack[-1] if self._cls_stack else None
        self.functions[qual] = FunctionInfo(
            qualname=qual, module=self.mod, node=node, cls=cls)
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # module-level instances -------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        if len(self._stack) == 1 and isinstance(node.value, ast.Call):
            ctor = call_name(node.value.func)
            if ctor and ctor[:1].isupper() or "." in ctor:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.instances[t.id] = ctor
        self.generic_visit(node)


class CallGraph:
    """Whole-project function index with best-effort call resolution."""

    def __init__(self, project: Project):
        self.project = project
        self.functions: Dict[str, FunctionInfo] = {}
        self.aliases: Dict[str, Dict[str, str]] = {}  # module -> alias table
        self.instances: Dict[str, Dict[str, str]] = {}
        self.classes: Dict[str, List[str]] = {}
        self._methods_by_name: Dict[str, List[str]] = {}

        for mod in project.modules.values():
            ix = _Indexer(mod)
            ix.visit(mod.tree)
            self.functions.update(ix.functions)
            self.aliases[mod.name] = ix.aliases
            self.instances[mod.name] = ix.instances
            self.classes.update(ix.classes)

        for qual, fn in self.functions.items():
            if fn.cls:
                self._methods_by_name.setdefault(
                    qual.rsplit(".", 1)[-1], []).append(qual)

        for fn in self.functions.values():
            self._link(fn)

    # -- resolution ----------------------------------------------------

    def _resolve_dotted(self, mod: ModuleInfo, dotted: str) -> str:
        """Expand the leading segment through the module's alias and
        instance tables; returns a project-absolute dotted name (may
        still refer to something external)."""
        if not dotted:
            return dotted
        head, _, rest = dotted.partition(".")
        table = self.aliases.get(mod.name, {})
        inst = self.instances.get(mod.name, {})
        if head in inst:
            cls = self._resolve_dotted(mod, inst[head])
            return f"{cls}.{rest}" if rest else cls
        if head in table:
            head = table[head]
        elif f"{mod.name}.{head}" in self.functions or \
                f"{mod.name}.{head}" in self.classes:
            head = f"{mod.name}.{head}"
        return f"{head}.{rest}" if rest else head

    def resolve_call(self, fn: FunctionInfo, node: ast.Call) -> Optional[str]:
        """Resolve a call inside ``fn`` to a known function qualname,
        or None if the target is external/unknown."""
        dotted = call_name(node.func)
        if not dotted:
            return None
        mod = fn.module
        if dotted.startswith("self."):
            rest = dotted[len("self."):]
            if fn.cls:
                # direct method on the enclosing class (or single-class
                # fallback by method name)
                cand = f"{fn.cls}.{rest.split('.')[0]}"
                if cand in self.functions:
                    return cand
            first = rest.split(".")[0]
            matches = self._methods_by_name.get(first, [])
            if len(matches) == 1:
                return matches[0]
            return None
        resolved = self._resolve_dotted(mod, dotted)
        if resolved in self.functions:
            return resolved
        # instance method: Class.attr chains — `recorder.record` resolved
        # to pkg.mod.FlightRecorder.record above; also try trailing pair.
        if resolved in self.classes:
            return None
        # maybe Class().__init__ or classmethod via class name
        if "." in resolved:
            base, meth = resolved.rsplit(".", 1)
            if base in self.classes:
                cand = f"{base}.{meth}"
                if cand in self.functions:
                    return cand
        # cross-module instance: `metrics.snapshot()` after
        # `from pkg.utils.profiling import metrics` resolves through the
        # defining module's instance table to MetricsRegistry.snapshot.
        parts = resolved.split(".")
        for i in range(len(parts) - 1, 0, -1):
            owner_name = ".".join(parts[:i])
            owner = self.project.by_name.get(owner_name)
            if owner is None:
                continue
            rest = parts[i:]
            inst = self.instances.get(owner_name, {})
            if rest and rest[0] in inst:
                cls = self._resolve_dotted(owner, inst[rest[0]])
                cand = ".".join([cls] + rest[1:])
                if cand in self.functions:
                    return cand
            break
        # Deliberately NO unique-method-name fallback here: resolving
        # `os.path.join` to some project `join()` poisons reachability
        # with wildly wrong edges. Unknown attribute targets stay
        # unresolved (under-approximate).
        return None

    def resolved_external(self, fn: FunctionInfo, node: ast.Call) -> str:
        """The alias-expanded dotted name even when it's not a project
        function (used by the blocking classifier for aliased imports)."""
        return self._resolve_dotted(fn.module, call_name(node.func))

    def _link(self, fn: FunctionInfo) -> None:
        body = fn.node.body if not isinstance(fn.node, ast.Lambda) \
            else [fn.node.body]
        for stmt in body:
            for node in walk_no_nested(stmt):
                if isinstance(node, ast.Call):
                    target = self.resolve_call(fn, node)
                    fn.calls.append((node, target or ""))
                    if target:
                        fn.callees.add(target)

    # -- queries -------------------------------------------------------

    def function_at(self, mod: ModuleInfo, node: ast.AST) -> Optional[FunctionInfo]:
        for fn in self.functions.values():
            if fn.module is mod and fn.node is node:
                return fn
        return None

    def enclosing_function(self, mod: ModuleInfo, lineno: int) -> Optional[FunctionInfo]:
        best = None
        for fn in self.functions.values():
            if fn.module is not mod:
                continue
            n = fn.node
            end = getattr(n, "end_lineno", n.lineno)
            if n.lineno <= lineno <= end:
                if best is None or n.lineno > best.node.lineno:
                    best = fn
        return best

    def reachable(self, roots: Iterable[str], max_depth: int = 12) -> Dict[str, List[str]]:
        """BFS over the call graph. Returns reached qualname -> call
        chain (root..target) for diagnostics."""
        chains: Dict[str, List[str]] = {}
        dq = deque()
        for r in roots:
            if r in self.functions:
                chains[r] = [r]
                dq.append((r, 0))
        while dq:
            cur, depth = dq.popleft()
            if depth >= max_depth:
                continue
            for callee in self.functions[cur].callees:
                if callee not in chains:
                    chains[callee] = chains[cur] + [callee]
                    dq.append((callee, depth + 1))
        return chains
