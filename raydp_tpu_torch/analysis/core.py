"""Engine core: file loading, rule registry, suppressions, results.

The engine parses every file once into a :class:`ModuleInfo`, builds a
project-wide :class:`~raydp_tpu_torch.analysis.callgraph.CallGraph`, runs
each enabled rule's ``check(project)``, then filters the findings
through inline suppressions and the baseline. Rules are pure functions
over the parsed project — no imports of the analyzed code ever happen,
so the checker can run against broken or heavyweight modules.
"""
from __future__ import annotations

import ast
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "ModuleInfo",
    "Project",
    "AnalysisResult",
    "RULES",
    "run_analysis",
]

# Suppression comment: ``# raydp: ignore[R1]`` / ``ignore[lock-order]``
# / ``ignore[all]``; several tokens comma-separated. Valid on the
# finding's own line or the line directly above it.
_SUPPRESS_RE = re.compile(r"#\s*raydp:\s*ignore\[([A-Za-z0-9_,\- ]+)\]")

SEVERITIES = ("error", "warning", "info")

# The port's documentation, which R4's parity checks read by default.
# The repo's ``doc/`` belongs to the JAX package, so the port keeps its
# own, plus the README's section on the port.
PORT_DOC_DIR = os.path.join("raydp_tpu_torch", "doc")
README_SECTION = "## PyTorch/CUDA port"


@dataclass
class Finding:
    """One diagnostic. ``rule`` is the family id (``R1``…``R5``),
    ``name`` the specific check (``lock-held-blocking``), ``scope``
    the enclosing function/class qualname (stable across line drift —
    it anchors the baseline fingerprint)."""

    rule: str
    name: str
    severity: str
    path: str  # repo-relative
    line: int
    col: int
    message: str
    scope: str = ""
    fingerprint: str = ""  # filled by the engine (needs dup indices)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule}[{self.name}] {self.severity}: {self.message}"
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "name": self.name,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "scope": self.scope,
            "fingerprint": self.fingerprint,
        }


@dataclass
class ModuleInfo:
    """One parsed source file."""

    path: str  # absolute
    rel: str  # repo-relative, '/'-separated
    name: str  # dotted module name relative to the repo root
    tree: ast.Module
    lines: List[str]
    suppressions: Dict[int, set] = field(default_factory=dict)

    def source_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclass
class Project:
    """Everything the rules see: parsed modules, the shared call graph,
    and the documentation corpus for the parity checks."""

    root: str
    modules: Dict[str, ModuleInfo]  # keyed by rel path
    by_name: Dict[str, ModuleInfo]  # keyed by dotted module name
    docs: Dict[str, str]  # rel path -> raw text of doc files
    graph: Any = None  # CallGraph, attached after construction

    def module_endswith(self, suffix: str) -> Optional[ModuleInfo]:
        for rel, mod in self.modules.items():
            if rel.endswith(suffix):
                return mod
        return None


@dataclass
class AnalysisResult:
    findings: List[Finding]  # active (not suppressed, not baselined)
    suppressed: int
    baselined: int
    stale_baseline: List[str]
    files: int
    seconds: float
    parse_errors: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": self.suppressed,
            "baselined": self.baselined,
            "stale_baseline": self.stale_baseline,
            "files": self.files,
            "seconds": round(self.seconds, 3),
            "parse_errors": self.parse_errors,
        }


# -- file discovery -----------------------------------------------------


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", ".venv", "node_modules")
                ]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        out.append(os.path.join(dirpath, f))
    return sorted(set(out))


def _find_root(files: Sequence[str], explicit: Optional[str]) -> str:
    """Repo root: the parent of the top-most package directory (the
    directory holding the first scanned package, e.g. the parent of
    ``raydp_tpu_torch/``). Falls back to the common prefix of the inputs."""
    if explicit:
        return os.path.abspath(explicit)
    candidates = []
    for f in files:
        d = os.path.dirname(f)
        # climb while the directory is a package (__init__.py present)
        while os.path.isfile(os.path.join(d, "__init__.py")):
            d = os.path.dirname(d)
        candidates.append(d)
    if not candidates:
        return os.getcwd()
    root = os.path.commonpath(candidates)
    return root


def _port_section(text: str) -> str:
    """The README's section on the port, from its heading to the next
    heading of the same level; the whole text where it has none."""
    start = text.find(README_SECTION)
    if start < 0:
        return text
    end = text.find("\n## ", start + len(README_SECTION))
    return text[start:] if end < 0 else text[start:end]


def _load_docs(root: str, docs_dir: Optional[str]) -> Dict[str, str]:
    texts: Dict[str, str] = {}
    doc_roots = [os.path.abspath(docs_dir) if docs_dir
                 else os.path.join(root, PORT_DOC_DIR)]
    for base in doc_roots:
        if not os.path.isdir(base):
            continue
        for dirpath, _dirnames, filenames in os.walk(base):
            for f in sorted(filenames):
                if f.endswith((".md", ".rst", ".txt")):
                    path = os.path.join(dirpath, f)
                    try:
                        with open(path, "r", encoding="utf-8") as fh:
                            texts[os.path.relpath(path, root)] = fh.read()
                    except OSError:
                        pass
    readme = os.path.join(root, "README.md")
    if os.path.isfile(readme):
        try:
            with open(readme, "r", encoding="utf-8") as fh:
                texts["README.md"] = _port_section(fh.read())
        except OSError:
            pass
    return texts


def _parse_suppressions(lines: List[str]) -> Dict[int, set]:
    out: Dict[int, set] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            tokens = {t.strip() for t in m.group(1).split(",") if t.strip()}
            out[i] = tokens
    return out


def _module_name(rel: str) -> str:
    name = rel[:-3] if rel.endswith(".py") else rel
    parts = name.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# -- rule registry ------------------------------------------------------
# Populated lazily so core.py has no import cycle with the rule modules.


def _rule_modules():
    from raydp_tpu_torch.analysis import (
        rules_device,
        rules_locks,
        rules_rpc,
        rules_signals,
        rules_simclock,
        rules_telemetry,
    )

    return {
        "R1": rules_locks,
        "R2": rules_signals,
        "R3": rules_rpc,
        "R4": rules_telemetry,
        "R5": rules_device,
        "R6": rules_simclock,
    }


RULES = {
    "R1": "lock-discipline: inversions + locks held across blocking calls",
    "R2": "signal-safety: no locks/logging/allocation in handler paths",
    "R3": "rpc-handler discipline: blocking handlers must be long-stall "
          "registered or inflight()-bracketed",
    "R4": "telemetry consistency: metric/family/env-var doc parity",
    "R5": "device hazards: host syncs in captured steps and step/decode "
          "loops",
    "R6": "clock-seam discipline: no direct time.monotonic/sleep in "
          "simulable modules (control/, serve/batching.py, sim/)",
}


def _is_suppressed(f: Finding, mod: Optional[ModuleInfo]) -> bool:
    """A suppression applies on the finding's own line or anywhere in
    the contiguous comment block directly above it."""
    if mod is None:
        return False
    lines = [f.line]
    above = f.line - 1
    while above >= 1 and mod.source_at(above).lstrip().startswith("#"):
        lines.append(above)
        above -= 1
    for line in lines:
        tokens = mod.suppressions.get(line)
        if not tokens:
            continue
        if "all" in tokens or f.rule in tokens or f.name in tokens:
            return True
    return False


def _fingerprint_all(findings: List[Finding]) -> None:
    """Stable ids: rule|path|scope|name|slug(message)|dup-index. Line
    numbers are deliberately excluded so unrelated edits above a
    baselined finding don't un-baseline it."""
    seen: Dict[str, int] = {}
    for f in sorted(findings, key=lambda x: (x.path, x.line, x.col)):
        slug = re.sub(r"[0-9]+", "#", f.message)[:120]
        base = f"{f.rule}|{f.path}|{f.scope}|{f.name}|{slug}"
        n = seen.get(base, 0)
        seen[base] = n + 1
        f.fingerprint = base if n == 0 else f"{base}|{n}"


def run_analysis(
    paths: Sequence[str],
    rules: Optional[Iterable[str]] = None,
    root: Optional[str] = None,
    docs_dir: Optional[str] = None,
    baseline: Optional[Dict[str, Any]] = None,
) -> AnalysisResult:
    """Analyze ``paths`` and return the filtered result.

    ``baseline`` is the loaded baseline document (see
    :mod:`~raydp_tpu_torch.analysis.baseline`); findings whose fingerprint it
    contains are counted but not reported as active.
    """
    t0 = time.perf_counter()
    files = _iter_py_files(paths)
    repo_root = _find_root(files, root)

    modules: Dict[str, ModuleInfo] = {}
    by_name: Dict[str, ModuleInfo] = {}
    findings: List[Finding] = []
    parse_errors = 0
    for path in files:
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as exc:
            parse_errors += 1
            findings.append(Finding(
                rule="R0", name="parse-error", severity="error",
                path=rel, line=getattr(exc, "lineno", 1) or 1, col=0,
                message=f"file could not be parsed: {exc}",
            ))
            continue
        lines = source.splitlines()
        mod = ModuleInfo(
            path=path, rel=rel, name=_module_name(rel), tree=tree,
            lines=lines, suppressions=_parse_suppressions(lines),
        )
        modules[rel] = mod
        by_name[mod.name] = mod

    project = Project(
        root=repo_root, modules=modules, by_name=by_name,
        docs=_load_docs(repo_root, docs_dir),
    )
    from raydp_tpu_torch.analysis.callgraph import CallGraph

    project.graph = CallGraph(project)

    enabled = set(rules) if rules else set(RULES)
    for rule_id, rule_mod in _rule_modules().items():
        if rule_id not in enabled:
            continue
        try:
            findings.extend(rule_mod.check(project))
        except Exception as exc:  # a broken rule must not hide the rest
            findings.append(Finding(
                rule=rule_id, name="rule-crashed", severity="error",
                path="<engine>", line=1, col=0,
                message=f"rule {rule_id} crashed: "
                        f"{type(exc).__name__}: {exc}",
            ))

    # inline suppressions
    active: List[Finding] = []
    suppressed = 0
    for f in findings:
        if _is_suppressed(f, modules.get(f.path)):
            suppressed += 1
        else:
            active.append(f)

    _fingerprint_all(active)

    # baseline ratchet
    baselined = 0
    stale: List[str] = []
    if baseline:
        known = set((baseline.get("findings") or {}).keys())
        matched = set()
        remaining = []
        for f in active:
            if f.fingerprint in known:
                baselined += 1
                matched.add(f.fingerprint)
            else:
                remaining.append(f)
        active = remaining
        stale = sorted(known - matched)

    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule, f.name))
    return AnalysisResult(
        findings=active, suppressed=suppressed, baselined=baselined,
        stale_baseline=stale, files=len(files),
        seconds=time.perf_counter() - t0, parse_errors=parse_errors,
    )
