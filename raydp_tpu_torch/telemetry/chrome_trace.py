"""Merge per-process span shards into one Chrome Trace Event JSON.

The port's copy of ``raydp_tpu/telemetry/chrome_trace.py``; it leaves nothing
of it to a later slice.

Every process of a job flushes its ring buffer to its own
``spans-<pid>.jsonl`` shard under ``RAYDP_TPU_TELEMETRY_DIR``
(:func:`raydp_tpu_torch.telemetry.export.flush_spans`). This module reads all
shards, aligns their clocks, and emits Chrome Trace Event Format JSON —
loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``
— with one track per (process, thread).

Clock alignment: durations inside a process are exact (monotonic
``perf_counter`` pairs), but ``perf_counter`` epochs differ per
process. Each span carries both ``start_wall`` (comparable across
processes, jittery) and ``start_mono`` (incomparable, precise), so the
per-process offset ``median(start_wall - start_mono)`` maps every
monotonic timestamp onto one shared wall-clock timeline without
degrading within-process precision.
"""
from __future__ import annotations

import glob
import json
import os
import statistics
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "load_span_records",
    "clock_offsets",
    "aligned_interval",
    "process_labels",
    "to_chrome_trace",
    "write_chrome_trace",
]


def load_span_records(directory: str) -> List[Dict[str, Any]]:
    """All span records under ``directory`` (``spans*.jsonl`` shards,
    plus the cluster event timeline's ``events-*.jsonl`` shards — event
    records are span-shaped, so they merge into the same Perfetto
    timeline as instants), sorted by aligned start time. Malformed
    lines (a shard whose writer died mid-append) are skipped, not
    fatal."""
    records: List[Dict[str, Any]] = []
    shards = sorted(glob.glob(os.path.join(directory, "spans*.jsonl")))
    shards += sorted(glob.glob(os.path.join(directory, "events-*.jsonl")))
    for path in shards:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "span_id" in rec:
                    records.append(rec)
    offsets = clock_offsets(records)
    records.sort(key=lambda r: aligned_interval(r, offsets)[0])
    return records


def clock_offsets(records: Iterable[Dict[str, Any]]) -> Dict[int, float]:
    """Per-pid ``wall - mono`` offset (median over that pid's spans)."""
    deltas: Dict[int, List[float]] = {}
    for rec in records:
        try:
            delta = float(rec["start_wall"]) - float(rec["start_mono"])
        except (KeyError, TypeError, ValueError):
            continue
        deltas.setdefault(int(rec.get("pid", 0)), []).append(delta)
    return {pid: statistics.median(ds) for pid, ds in deltas.items()}


def aligned_interval(
    rec: Dict[str, Any], offsets: Dict[int, float]
) -> Tuple[float, float]:
    """(start, end) of a record on the shared wall-clock timeline, in
    seconds. Events and still-open spans get end == start."""
    offset = offsets.get(int(rec.get("pid", 0)), 0.0)
    start = float(rec.get("start_mono", 0.0)) + offset
    duration = rec.get("duration_s") or 0.0
    return start, start + float(duration)


def process_labels(records: Iterable[Dict[str, Any]]) -> Dict[int, str]:
    """Human names for pid tracks, inferred from what each process
    recorded: the job-root minting process is the driver; processes
    whose spans carry ``worker_id`` / ``rank`` attrs are labeled with
    it. Unrecognized processes keep their pid."""
    labels: Dict[int, str] = {}
    hints: Dict[int, str] = {}
    for rec in records:
        pid = int(rec.get("pid", 0))
        name = rec.get("name", "")
        attrs = rec.get("attrs") or {}
        if name in ("cluster/job", "spmd/job"):
            labels[pid] = "driver"
        elif pid not in hints:
            if "worker_id" in attrs:
                hints[pid] = f"worker {attrs['worker_id']}"
            elif "rank" in attrs:
                hints[pid] = f"rank {attrs['rank']}"
    for pid, hint in hints.items():
        labels.setdefault(pid, hint)
    return labels


def to_chrome_trace(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Records → Chrome Trace Event Format dict (``traceEvents`` +
    ``displayTimeUnit``). Finished spans become complete (``ph: "X"``)
    events; zero-duration annotations become instants (``ph: "i"``)."""
    offsets = clock_offsets(records)
    starts = [aligned_interval(r, offsets)[0] for r in records]
    base = min(starts) if starts else 0.0
    labels = process_labels(records)

    events: List[Dict[str, Any]] = []
    seen_tracks: set = set()
    for rec in records:
        pid = int(rec.get("pid", 0))
        tid = int(rec.get("tid", 0) or 0)
        if pid not in seen_tracks:
            seen_tracks.add(pid)
            events.append({
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": labels.get(pid, f"pid {pid}")},
            })
        if (pid, tid) not in seen_tracks:
            seen_tracks.add((pid, tid))
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": f"thread {tid:#x}"},
            })
        start, end = aligned_interval(rec, offsets)
        ts_us = (start - base) * 1e6
        args = {
            "span_id": rec.get("span_id"),
            "trace_id": rec.get("trace_id"),
            "parent_id": rec.get("parent_id"),
            "status": rec.get("status", "ok"),
            **(rec.get("attrs") or {}),
        }
        if rec.get("job"):  # event-timeline records carry attribution
            args["job"] = rec["job"]
        if rec.get("kind") == "event":
            events.append({
                "name": rec.get("name", "?"),
                "cat": "event",
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": round(ts_us, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            })
        else:
            events.append({
                "name": rec.get("name", "?"),
                "cat": "span",
                "ph": "X",
                "ts": round(ts_us, 3),
                "dur": round((end - start) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # The JAX package's producer name: a trace of either package is
        # the same document to the tools that read it.
        "otherData": {"producer": "raydp_tpu.telemetry.chrome_trace"},
    }


def write_chrome_trace(
    directory: str, out_path: Optional[str] = None
) -> str:
    """Merge every shard under ``directory`` into a Perfetto-loadable
    JSON file (default ``<directory>/trace.json``); returns the path."""
    records = load_span_records(directory)
    trace = to_chrome_trace(records)
    out_path = out_path or os.path.join(directory, "trace.json")
    out_dir = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(out_dir, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(trace, f, default=str)
    os.replace(tmp, out_path)
    return out_path
