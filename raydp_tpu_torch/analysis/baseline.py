"""Ratcheting baseline: accepted pre-existing findings.

The baseline file (default ``<repo>/analysis-baseline.json``) maps
finding fingerprints to a short record of what was accepted. Runs
subtract baselined findings from the active set, so the repo gates on
*new* debt only, and report **stale** entries (baselined findings that
no longer fire) so the file only ever shrinks — the ratchet.

Fingerprints hash the rule, path, scope, check name and a
digit-stripped message slug — not line numbers — so unrelated edits
don't churn the file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.analysis.core import Finding

__all__ = ["default_path", "load", "write"]

DEFAULT_NAME = "analysis-baseline.json"


def default_path(repo_root: str) -> str:
    return os.path.join(repo_root, DEFAULT_NAME)


def load(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.isfile(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "findings" not in doc:
        raise ValueError(f"{path}: not a baseline file "
                         f"(missing 'findings' mapping)")
    return doc


def write(path: str, findings: List[Finding]) -> Dict[str, Any]:
    doc = {
        "version": 1,
        "comment": "Accepted pre-existing raydpcheck findings. Entries "
                   "are removed (never added back) as debt is paid "
                   "down — see raydp_tpu_torch/doc/analysis.md for the workflow.",
        "findings": {
            f.fingerprint: {
                "rule": f.rule,
                "name": f.name,
                "path": f.path,
                "message": f.message,
            }
            for f in findings
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return doc
