"""Offline renderer for load-observatory results.

``python -m raydp_tpu_torch.loadgen report results.jsonl`` reconstructs the
knee curve and the per-phase latency breakdown from the raw
``request`` records in a :func:`~raydp_tpu_torch.loadgen.knee.write_results`
file — the summary/step lines are cross-checked, not trusted, so a
truncated or hand-edited file still renders honestly.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def _load(path: str) -> Dict[str, List[Dict[str, Any]]]:
    out: Dict[str, List[Dict[str, Any]]] = {
        "knee": [], "step": [], "request": [],
    }
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.setdefault(rec.get("kind", "unknown"), []).append(rec)
    return out


def _quantile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))]


def reconstruct_curve(
    requests: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Rebuild per-step stats from raw request records, grouped by
    the ``step_rps`` each record was fired at."""
    by_step: Dict[float, List[Dict[str, Any]]] = {}
    for rec in requests:
        rps = rec.get("step_rps")
        if rps is None:
            continue
        by_step.setdefault(float(rps), []).append(rec)
    curve = []
    for rps in sorted(by_step):
        recs = by_step[rps]
        oks = [r["latency_s"] for r in recs if r.get("status") == "ok"]
        shed = sum(1 for r in recs if r.get("status") == "shed")
        errors = sum(
            1 for r in recs
            if r.get("status") in ("error", "overload")
        )
        curve.append({
            "rps": rps,
            "requests": len(recs),
            "ok": len(oks),
            "p50_s": _quantile(oks, 0.5),
            "p99_s": _quantile(oks, 0.99),
            "shed_rate": shed / len(recs) if recs else 0.0,
            "error_rate": errors / len(recs) if recs else 0.0,
        })
    return curve


def phase_breakdown(
    requests: List[Dict[str, Any]]
) -> Dict[str, Dict[str, float]]:
    """Mean seconds and fraction-of-total per phase over all request
    records that carried a decomposition."""
    sums: Dict[str, float] = {}
    wall = 0.0
    n = 0
    for rec in requests:
        phases = rec.get("phases")
        if not phases:
            continue
        total = phases.get("total") or rec.get("latency_s") or 0.0
        if total <= 0:
            continue
        n += 1
        wall += total
        for name, value in phases.items():
            if name == "total":
                continue
            sums[name] = sums.get(name, 0.0) + float(value)
    if not n:
        return {}
    return {
        name: {
            "mean_s": sums[name] / n,
            "fraction": sums[name] / wall if wall > 0 else 0.0,
        }
        for name in sorted(sums)
    }


def _ms(v: Optional[float]) -> str:
    return f"{v * 1000.0:8.1f}" if v is not None else "       -"


def render_report(path: str, as_json: bool = False) -> str:
    data = _load(path)
    curve = reconstruct_curve(data["request"])
    phases = phase_breakdown(data["request"])
    knee = data["knee"][0] if data["knee"] else {}
    if as_json:
        return json.dumps({
            "knee": knee,
            "curve": curve,
            "phases": phases,
        }, indent=2, sort_keys=True)
    lines = []
    if knee:
        sat = "saturated" if knee.get("saturated") else "unsaturated"
        lines.append(
            f"knee: {knee.get('knee_rps', 0.0):.1f} rps ({sat}, "
            f"slo {knee.get('slo_ms')} ms, "
            f"{knee.get('steps', len(curve))} steps)"
        )
    lines.append("")
    lines.append(
        "   rps     reqs    ok    p50 ms    p99 ms   shed%    err%"
    )
    for pt in curve:
        lines.append(
            f"{pt['rps']:7.1f} {pt['requests']:7d} {pt['ok']:6d}"
            f" {_ms(pt['p50_s'])}  {_ms(pt['p99_s'])}"
            f" {pt['shed_rate'] * 100:6.1f}% {pt['error_rate'] * 100:6.1f}%"
        )
    if phases:
        lines.append("")
        lines.append("phase breakdown (mean over decomposed requests):")
        for name, st in phases.items():
            lines.append(
                f"  {name:<14} {st['mean_s'] * 1000.0:9.2f} ms  "
                f"{st['fraction'] * 100:5.1f}%"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m raydp_tpu_torch.loadgen",
        description="Render a load-observatory results JSONL offline.",
    )
    sub = parser.add_subparsers(dest="cmd")
    rep = sub.add_parser(
        "report", help="knee curve + phase breakdown from results JSONL"
    )
    rep.add_argument("path", help="results JSONL (knee.write_results)")
    rep.add_argument("--json", action="store_true",
                     help="machine-readable output")
    args = parser.parse_args(argv)
    if args.cmd != "report":
        parser.print_help()
        return 2
    try:
        print(render_report(args.path, as_json=args.json))
    except BrokenPipeError:  # downstream `| head` closed the pipe
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
