"""Critical-path and straggler analysis over a merged trace.

The port's copy of ``raydp_tpu/telemetry/analyze.py``.

``_device_plane`` reads the ``train/phases`` events the estimator's
device plane emits once an epoch (``telemetry/device_profiler.py``).

Answers the whole-gang questions the raw shards cannot: where did the
job's wall-clock actually go (critical path through the merged span
tree), which rank is the straggler (per-rank ``train/step`` skew), and
is the pipeline input-bound or compute-bound (data-wait vs compute
split from the loader's ``ingest/chunk`` vs the estimator's
``train/step`` spans).

Two entry points over the same report dict:

* ``python -m raydp_tpu_torch.telemetry.analyze <dir>`` — CLI over a
  telemetry directory of ``spans*.jsonl`` shards.
* :meth:`raydp_tpu_torch.cluster.cluster.Cluster.trace_report` — live, on the
  driver.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.telemetry.chrome_trace import (
    aligned_interval,
    clock_offsets,
    load_span_records,
    process_labels,
    write_chrome_trace,
)

__all__ = [
    "analyze_records",
    "load_stage_stats",
    "trace_report",
    "format_report",
    "main",
]

STEP_SPAN = "train/step"
DATA_SPANS = ("ingest/chunk",)
PHASES_EVENT = "train/phases"
_PHASE_FRACS = (
    "input_wait_frac", "dispatch_frac", "compute_frac", "collective_frac",
)


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _proc_label(rec: Dict[str, Any], labels: Dict[int, str]) -> str:
    return labels.get(int(rec.get("pid", 0)), f"pid {rec.get('pid', 0)}")


def _critical_path(
    records: List[Dict[str, Any]],
    offsets: Dict[int, float],
    labels: Dict[int, str],
) -> List[Dict[str, Any]]:
    """Longest last-finishing chain from the trace root.

    At each node descend into the child that finishes last — the span
    the parent's completion actually waited on. The chain crosses
    process boundaries wherever traceparent links do, so a driver-side
    ``spmd/dispatch`` that waited on a straggler rank descends into
    that rank's span."""
    by_id = {r["span_id"]: r for r in records}
    children: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for rec in records:
        parent = rec.get("parent_id")
        if parent not in by_id:
            parent = None  # orphan: treat as a root candidate
        children.setdefault(parent, []).append(rec)

    roots = children.get(None, [])
    if not roots:
        return []
    # The job root is the earliest root; ties broken toward the one
    # whose subtree finishes last (it owns the job's wall-clock).
    root = min(roots, key=lambda r: aligned_interval(r, offsets)[0])

    def subtree_end(rec: Dict[str, Any]) -> float:
        end = aligned_interval(rec, offsets)[1]
        for child in children.get(rec["span_id"], ()):
            end = max(end, subtree_end(child))
        return end

    base = aligned_interval(root, offsets)[0]
    path: List[Dict[str, Any]] = []
    node: Optional[Dict[str, Any]] = root
    while node is not None:
        start, end = aligned_interval(node, offsets)
        path.append({
            "name": node.get("name", "?"),
            "process": _proc_label(node, labels),
            "span_id": node.get("span_id"),
            "start_s": round(start - base, 6),
            "duration_s": round(end - start, 6),
        })
        kids = children.get(node["span_id"])
        node = max(kids, key=subtree_end) if kids else None
    return path


def _step_skew(
    records: List[Dict[str, Any]], labels: Dict[int, str]
) -> Dict[str, Any]:
    groups: Dict[str, List[float]] = {}
    for rec in records:
        if rec.get("name") != STEP_SPAN or rec.get("duration_s") is None:
            continue
        groups.setdefault(_proc_label(rec, labels), []).append(
            float(rec["duration_s"])
        )
    ranks: Dict[str, Dict[str, float]] = {}
    for label, durs in groups.items():
        durs.sort()
        ranks[label] = {
            "steps": len(durs),
            "p50_s": round(_pct(durs, 0.50), 6),
            "p99_s": round(_pct(durs, 0.99), 6),
            "mean_s": round(sum(durs) / len(durs), 6),
            "total_s": round(sum(durs), 6),
        }
    skew: Dict[str, Any] = {"ranks": ranks}
    if ranks:
        slowest = max(ranks, key=lambda k: ranks[k]["p50_s"])
        fastest = min(ranks, key=lambda k: ranks[k]["p50_s"])
        skew["slowest"] = slowest
        skew["fastest"] = fastest
        fast_p50 = ranks[fastest]["p50_s"]
        skew["skew_p50"] = round(
            ranks[slowest]["p50_s"] / fast_p50 if fast_p50 > 0 else 1.0, 3
        )
    return skew


def _data_compute(
    records: List[Dict[str, Any]], labels: Dict[int, str]
) -> Dict[str, Dict[str, float]]:
    split: Dict[str, Dict[str, float]] = {}
    for rec in records:
        dur = rec.get("duration_s")
        if dur is None:
            continue
        name = rec.get("name", "")
        bucket = None
        if name in DATA_SPANS:
            bucket = "data_s"
        elif name == STEP_SPAN:
            bucket = "compute_s"
        if bucket is None:
            continue
        entry = split.setdefault(
            _proc_label(rec, labels), {"data_s": 0.0, "compute_s": 0.0}
        )
        entry[bucket] += float(dur)
    for entry in split.values():
        total = entry["data_s"] + entry["compute_s"]
        entry["data_s"] = round(entry["data_s"], 6)
        entry["compute_s"] = round(entry["compute_s"], 6)
        entry["data_frac"] = round(
            entry["data_s"] / total if total > 0 else 0.0, 4
        )
    return split


def _device_plane(
    records: List[Dict[str, Any]], labels: Dict[int, str]
) -> Dict[str, Dict[str, Any]]:
    """Per-process step-phase breakdown from ``train/phases`` events
    (one per epoch, emitted by the estimator's device plane). Fractions
    are wall-weighted across the process's epochs; ``bound`` and ``mfu``
    come from the latest epoch — the steady-state view."""
    by_proc: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("name") != PHASES_EVENT or rec.get("kind") != "event":
            continue
        attrs = rec.get("attrs") or {}
        by_proc.setdefault(_proc_label(rec, labels), []).append(
            {"seq": rec.get("seq", 0), **attrs}
        )
    plane: Dict[str, Dict[str, Any]] = {}
    for label, epochs in by_proc.items():
        epochs.sort(key=lambda e: e["seq"])
        total_wall = sum(float(e.get("wall_s", 0.0)) for e in epochs)
        entry: Dict[str, Any] = {
            "epochs": len(epochs),
            "steps": int(sum(e.get("steps", 0) for e in epochs)),
            "wall_s": round(total_wall, 6),
        }
        for frac in _PHASE_FRACS:
            weighted = sum(
                float(e.get(frac, 0.0)) * float(e.get("wall_s", 0.0))
                for e in epochs
            )
            entry[frac] = round(
                weighted / total_wall if total_wall > 0 else 0.0, 4
            )
        last = epochs[-1]
        entry["bound"] = last.get("bound", "?")
        if "mfu" in last:
            entry["mfu"] = last["mfu"]
        if "intensity_flops_per_byte" in last:
            entry["intensity_flops_per_byte"] = (
                last["intensity_flops_per_byte"]
            )
        plane[label] = entry
    return plane


def _job_rollup(
    records: List[Dict[str, Any]], offsets: Dict[int, float]
) -> Dict[str, Dict[str, Any]]:
    """Per-job rollup over job-attributed records (the event timeline's
    ``events-*.jsonl`` shards carry a top-level ``job`` id). For each
    job: event count, distinct processes, wall extent on the aligned
    timeline, and a per-kind event histogram."""
    jobs: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        job = rec.get("job")
        if not job:
            continue
        start, end = aligned_interval(rec, offsets)
        entry = jobs.setdefault(str(job), {
            "name": rec.get("job_name", ""),
            "events": 0,
            "pids": set(),
            "first_s": start,
            "last_s": end,
            "by_kind": {},
        })
        entry["events"] += 1
        entry["pids"].add(int(rec.get("pid", 0)))
        entry["first_s"] = min(entry["first_s"], start)
        entry["last_s"] = max(entry["last_s"], end)
        if rec.get("job_name") and not entry["name"]:
            entry["name"] = rec["job_name"]
        kind = rec.get("name", "?")
        entry["by_kind"][kind] = entry["by_kind"].get(kind, 0) + 1
    for entry in jobs.values():
        entry["processes"] = len(entry.pop("pids"))
        entry["wall_s"] = round(entry["last_s"] - entry["first_s"], 6)
        del entry["first_s"], entry["last_s"]
    return jobs


def analyze_records(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    offsets = clock_offsets(records)
    labels = process_labels(records)
    trace_counts: Dict[str, int] = {}
    for rec in records:
        trace_counts[rec.get("trace_id", "?")] = (
            trace_counts.get(rec.get("trace_id", "?"), 0) + 1
        )
    dominant = max(trace_counts, key=trace_counts.get) if trace_counts else None
    main_trace = [r for r in records if r.get("trace_id") == dominant]
    return {
        "num_spans": len(records),
        "num_processes": len({int(r.get("pid", 0)) for r in records}),
        "num_traces": len(trace_counts),
        "trace_id": dominant,
        "process_labels": {str(k): v for k, v in labels.items()},
        "critical_path": _critical_path(main_trace, offsets, labels),
        "step_skew": _step_skew(main_trace, labels),
        "data_compute": _data_compute(main_trace, labels),
        # All records, not just the dominant trace: a standalone fit's
        # phase events may carry their own trace id.
        "device_plane": _device_plane(records, labels),
        # Likewise all records: each job's timeline is its own trace.
        "jobs": _job_rollup(records, offsets),
    }


def load_stage_stats(directory: str) -> List[Dict[str, Any]]:
    """Read every ``stats-*.jsonl`` shard (one dict per executed
    DataFrame stage, written by :class:`StageStatsStore` when
    ``RAYDP_TPU_STATS_DIR`` is set) under ``directory``."""
    stats: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(directory, "stats-*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        stats.append(json.loads(line))
        except (OSError, ValueError):
            continue  # partial shard from a dying process
    return stats


def _stage_summary(stats: List[Dict[str, Any]]) -> Dict[str, Any]:
    per_op: Dict[str, Dict[str, Any]] = {}
    for st in stats:
        agg = per_op.setdefault(st.get("op", "?"), {
            "stages": 0, "rows_in": 0, "rows_out": 0,
            "bytes_out": 0, "wall_s": 0.0, "max_skew": 1.0,
        })
        agg["stages"] += 1
        agg["rows_in"] += int(st.get("rows_in", 0))
        agg["rows_out"] += int(st.get("rows_out", 0))
        agg["bytes_out"] += int(st.get("bytes_out", 0))
        agg["wall_s"] = round(agg["wall_s"] + float(st.get("wall_s", 0.0)), 6)
        agg["max_skew"] = max(agg["max_skew"], float(st.get("skew", 1.0)))
    return {
        "stages": len(stats),
        "wall_s": round(sum(float(s.get("wall_s", 0.0)) for s in stats), 6),
        "per_op": per_op,
    }


def trace_report(directory: str) -> Dict[str, Any]:
    """Read every ``spans*.jsonl`` shard under ``directory`` and build
    the analysis report dict (see :func:`format_report` for rendering).
    ``stats-*.jsonl`` stage-stat shards in the same directory are folded
    in as a ``stage_stats`` section."""
    report = analyze_records(load_span_records(directory))
    stats = load_stage_stats(directory)
    if stats:
        report["stage_stats"] = _stage_summary(stats)
    return report


def format_report(report: Dict[str, Any]) -> str:
    lines = [
        f"{report['num_spans']} spans · {report['num_processes']} processes"
        f" · {report['num_traces']} trace(s)"
        f" · dominant trace {report['trace_id']}",
        "",
        "critical path:",
    ]
    path = report["critical_path"]
    if not path:
        lines.append("  (no spans)")
    for hop in path:
        lines.append(
            f"  +{hop['start_s']:>10.4f}s {hop['duration_s']:>10.4f}s"
            f"  {hop['name']:<24} [{hop['process']}]"
        )
    lines += ["", "per-rank step skew:"]
    ranks = report["step_skew"].get("ranks", {})
    if not ranks:
        lines.append("  (no train/step spans)")
    else:
        lines.append(
            f"  {'rank':<16} {'steps':>6} {'p50':>10} {'p99':>10}"
            f" {'mean':>10} {'total':>10}"
        )
        for label in sorted(ranks):
            st = ranks[label]
            lines.append(
                f"  {label:<16} {st['steps']:>6}"
                f" {st['p50_s']:>9.4f}s {st['p99_s']:>9.4f}s"
                f" {st['mean_s']:>9.4f}s {st['total_s']:>9.4f}s"
            )
        lines.append(
            f"  slowest: {report['step_skew']['slowest']}"
            f" (p50 skew {report['step_skew']['skew_p50']}x vs"
            f" {report['step_skew']['fastest']})"
        )
    lines += ["", "data-wait vs compute:"]
    split = report["data_compute"]
    if not split:
        lines.append("  (no loader/step spans)")
    for label in sorted(split):
        entry = split[label]
        lines.append(
            f"  {label:<16} data {entry['data_s']:.4f}s"
            f" · compute {entry['compute_s']:.4f}s"
            f" · data-wait {entry['data_frac'] * 100:.1f}%"
        )
    plane = report.get("device_plane") or {}
    if plane:
        lines += ["", "device plane (step phases):"]
        lines.append(
            f"  {'rank':<16} {'steps':>6} {'input':>7} {'dispatch':>8}"
            f" {'compute':>8} {'coll':>6}  bound"
        )
        for label in sorted(plane):
            entry = plane[label]
            extra = ""
            if "mfu" in entry:
                extra = f" · mfu {entry['mfu'] * 100:.1f}%"
            lines.append(
                f"  {label:<16} {entry['steps']:>6}"
                f" {entry['input_wait_frac'] * 100:>6.1f}%"
                f" {entry['dispatch_frac'] * 100:>7.1f}%"
                f" {entry['compute_frac'] * 100:>7.1f}%"
                f" {entry['collective_frac'] * 100:>5.1f}%"
                f"  {entry['bound']}{extra}"
            )
    jobs = report.get("jobs") or {}
    if jobs:
        lines += ["", "jobs (event timeline):"]
        for job_id in sorted(jobs):
            entry = jobs[job_id]
            label = job_id if not entry["name"] else (
                f"{job_id} ({entry['name']})"
            )
            kinds = sorted(
                entry["by_kind"].items(), key=lambda kv: -kv[1]
            )
            kind_str = " ".join(f"{k}×{n}" for k, n in kinds[:6])
            lines.append(
                f"  {label:<32} {entry['events']:>4} events"
                f" · {entry['processes']} proc"
                f" · {entry['wall_s']:.3f}s span"
            )
            if kind_str:
                lines.append(f"    {kind_str}")
    stage = report.get("stage_stats")
    if stage:
        lines += [
            "",
            f"dataframe stages: {stage['stages']}"
            f" · {stage['wall_s']:.4f}s total wall",
            f"  {'op':<32} {'stages':>6} {'rows out':>12}"
            f" {'bytes out':>12} {'wall':>10} {'skew':>6}",
        ]
        per_op = stage["per_op"]
        by_wall = sorted(
            per_op, key=lambda k: per_op[k]["wall_s"], reverse=True
        )
        for op in by_wall:
            agg = per_op[op]
            lines.append(
                f"  {op[:32]:<32} {agg['stages']:>6}"
                f" {agg['rows_out']:>12,} {agg['bytes_out']:>12,}"
                f" {agg['wall_s']:>9.4f}s {agg['max_skew']:>5.2f}x"
            )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    chrome_out = None
    if "--chrome" in argv:
        idx = argv.index("--chrome")
        if idx + 1 >= len(argv):
            print("--chrome requires an output path", file=sys.stderr)
            return 2
        chrome_out = argv[idx + 1]
        del argv[idx:idx + 2]
    if len(argv) != 1:
        print(
            "usage: python -m raydp_tpu_torch.telemetry.analyze"
            " [--chrome trace.json] <telemetry-dir>",
            file=sys.stderr,
        )
        return 2
    directory = argv[0]
    print(format_report(trace_report(directory)))
    if chrome_out:
        print(f"\nchrome trace: {write_chrome_trace(directory, chrome_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
