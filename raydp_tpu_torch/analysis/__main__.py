"""CLI: ``python -m raydp_tpu_torch.analysis [paths]``.

Exit codes: 0 clean (or everything baselined), 1 active findings,
2 usage/internal error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from raydp_tpu_torch.analysis import baseline as baseline_mod
from raydp_tpu_torch.analysis.core import RULES, run_analysis


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raydp_tpu_torch.analysis",
        description="raydpcheck: framework-aware static analysis "
                    "(rules R1-R6; see raydp_tpu_torch/doc/analysis.md)",
    )
    p.add_argument("paths", nargs="*", default=["raydp_tpu_torch"],
                   help="files/directories to analyze "
                        "(default: raydp_tpu_torch)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run "
                        f"(default: all of {','.join(sorted(RULES))})")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the JSON report to stdout instead of "
                        "human output")
    p.add_argument("--json-out", default=None, metavar="FILE",
                   help="also write the JSON report to FILE")
    p.add_argument("--root", default=None,
                   help="repo root override (docs + baseline live here; "
                        "auto-detected from the scanned packages)")
    p.add_argument("--docs-dir", default=None,
                   help="docs directory override for the R4 parity "
                        "checks (default: <root>/raydp_tpu_torch/doc plus "
                        "the README's section on the port)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline file (default: "
                        "<root>/analysis-baseline.json if present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept all current findings into the baseline "
                        "file and exit 0")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid}  {RULES[rid]}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"error: unknown rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(RULES))})", file=sys.stderr)
            return 2

    # First pass without a baseline to discover the root, then load the
    # baseline relative to it. Cheap enough (<1s) to keep the CLI simple
    # would be ideal, but one pass suffices: detect root up front.
    from raydp_tpu_torch.analysis.core import _find_root, _iter_py_files

    files = _iter_py_files(args.paths)
    if not files:
        print(f"error: no Python files under: {' '.join(args.paths)}",
              file=sys.stderr)
        return 2
    root = _find_root(files, args.root)

    baseline_path = args.baseline or baseline_mod.default_path(root)
    baseline_doc = None
    if not args.no_baseline and not args.write_baseline:
        try:
            baseline_doc = baseline_mod.load(baseline_path)
        except (ValueError, OSError, json.JSONDecodeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2

    result = run_analysis(
        args.paths, rules=rules, root=root, docs_dir=args.docs_dir,
        baseline=baseline_doc,
    )

    if args.write_baseline:
        baseline_mod.write(baseline_path, result.findings)
        print(f"baseline: wrote {len(result.findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    report = result.to_dict()
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")

    if args.as_json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        for f in result.findings:
            print(f.render())
        parts = [
            f"{len(result.findings)} finding(s)",
            f"{result.files} file(s)",
            f"{result.seconds:.2f}s",
        ]
        if result.suppressed:
            parts.append(f"{result.suppressed} suppressed")
        if result.baselined:
            parts.append(f"{result.baselined} baselined")
        print("raydpcheck: " + ", ".join(parts))
        if result.stale_baseline:
            print(f"raydpcheck: {len(result.stale_baseline)} stale "
                  f"baseline entr(y/ies) no longer fire — ratchet down "
                  f"by removing them from {baseline_path}:")
            for fp in result.stale_baseline:
                print(f"  stale: {fp}")

    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
