"""Cluster event timeline: the durable "what happened when" record.

The port's copy of ``raydp_tpu/telemetry/events.py``.

The ``sentinel/*`` kinds come from the device plane's anomaly
sentinels, the ``slo/*`` kinds from the SLO engine, as in the JAX
package.

Counters say *how many* restarts happened; nothing said *when*, *to
whom*, or *in what order*. This module is the bounded, structured
event log the recovery story is audited against: worker
spawn/death/restart, gang launch/teardown/resize, preemption
request→drain→emergency-checkpoint, checkpoint completion, fault-plan
clause firings, stall/anomaly sentinel trips, compile failures — each
stamped with the ambient :class:`~raydp_tpu_torch.telemetry.accounting.JobContext`
and trace context so the timeline correlates with per-job usage and
the merged Perfetto trace.

Storage mirrors spans: an in-process ring (bounded by
``RAYDP_TPU_EVENT_BUFFER``) plus write-through to a per-process
``events-<pid>.jsonl`` shard under ``RAYDP_TPU_TELEMETRY_DIR``.
Records are span-record shaped (``kind="event"``, zero duration), so
:mod:`~raydp_tpu_torch.telemetry.chrome_trace` merges them into the Perfetto
trace as instant events with no translation.

Consumers: ``/debug/events`` on every debug endpoint
(:func:`raydp_tpu_torch.telemetry.export.serve_prometheus`), and ``python -m
raydp_tpu_torch.telemetry.events <dir>`` — a per-job timeline renderer with
MTTR breakdowns (failure → recovery episodes, with the intermediate
causal steps and their offsets).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import spans as _spans
from raydp_tpu_torch.telemetry.export import (
    append_jsonl,
    prune_shards_once,
    telemetry_dir,
)

__all__ = [
    "EVENT_BUFFER_ENV",
    "emit",
    "local_events",
    "load_event_records",
    "mttr_report",
    "format_timeline",
    "main",
]

EVENT_BUFFER_ENV = "RAYDP_TPU_EVENT_BUFFER"
_DEFAULT_BUFFER = 2048


def _capacity() -> int:
    try:
        return max(16, int(os.environ.get(EVENT_BUFFER_ENV, "")))
    except ValueError:
        return _DEFAULT_BUFFER


_ring: "deque[Dict[str, Any]]" = deque(maxlen=_capacity())
_mu = threading.Lock()
_seq = itertools.count(1)

#: Event kinds that open a recovery episode (something died / was
#: taken away) and kinds that close one (the workload is making
#: progress again). Everything between them in a job's timeline is the
#: causal repair chain the MTTR breakdown itemizes.
FAILURE_KINDS = frozenset(
    {"rank/dead", "worker/dead", "gang/failed", "preempt/request",
     "sched/preempt", "slo/breach"}
)
RECOVERY_KINDS = frozenset(
    {"train/resume", "worker/restart", "gang/launch", "sched/resume",
     "slo/recovered"}
)


def emit(
    kind: str,
    job: Optional[_acct.JobContext] = None,
    **attrs: Any,
) -> Dict[str, Any]:
    """Record one timeline event, stamped with job + trace correlation.

    Appends to the in-process ring and (when a telemetry dir is
    configured) writes through to this process's ``events-<pid>.jsonl``
    shard. Never raises — the timeline is an observer, not a
    participant. ``RAYDP_TPU_JOB_ACCOUNTING=0`` turns it off (the
    record is still built and returned, just not stored)."""
    jctx = job if job is not None else _acct.current_job()
    tctx = _spans.recorder.current_context()
    seq = next(_seq)
    pid = os.getpid()
    span_id = f"{pid:x}-evt{seq:x}"
    rec: Dict[str, Any] = {
        "name": kind,
        "kind": "event",
        "span_id": span_id,
        "trace_id": tctx.trace_id if tctx else span_id,
        "parent_id": tctx.span_id if tctx else None,
        "seq": seq,
        "start_wall": time.time(),
        "start_mono": time.perf_counter(),
        "duration_s": 0.0,
        "status": "ok",
        "pid": pid,
        "tid": threading.get_ident(),
        "job": jctx.job_id if jctx else None,
        "job_name": jctx.name if jctx else None,
        "attrs": dict(attrs),
    }
    if not _acct.accounting_enabled():
        return rec
    evicted = False
    with _mu:
        if _ring.maxlen is not None and len(_ring) == _ring.maxlen:
            evicted = True
        _ring.append(rec)
    if evicted:
        # Count outside the ring lock; ships on heartbeats as
        # raydp_events_dropped_total so ring evictions are never silent
        # (mirrors the span-recorder drop accounting).
        try:
            from raydp_tpu_torch.utils.profiling import metrics

            metrics.counter_add("events/dropped")
        except Exception:  # pragma: no cover - accounting best-effort
            pass
    try:
        _write_through(rec)
    except Exception:  # the timeline must never sink the workload
        pass
    return rec


def _write_through(rec: Dict[str, Any]) -> None:
    directory = telemetry_dir()
    if not directory:
        return
    prune_shards_once(directory, "events")
    append_jsonl(
        os.path.join(directory, f"events-{os.getpid()}.jsonl"), [rec]
    )


def local_events(
    limit: Optional[int] = None, job: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Snapshot of this process's ring, oldest first."""
    with _mu:
        out = list(_ring)
    if job:
        out = [r for r in out if r.get("job") == job]
    return out if limit is None else out[-limit:]


def load_event_records(
    directory: Optional[str] = None, job: Optional[str] = None
) -> List[Dict[str, Any]]:
    """All timeline events under ``directory`` (``events-*.jsonl``
    shards from every process of the job), merged and sorted by wall
    clock. Malformed lines (a writer that died mid-append) are skipped.
    Falls back to the local ring when no directory is configured."""
    import glob

    directory = directory or telemetry_dir()
    if not directory:
        return local_events(job=job)
    records: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(directory, "events-*.jsonl"))):
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("kind") == "event":
                        records.append(rec)
        except OSError:
            continue
    if job:
        records = [r for r in records if r.get("job") == job]
    records.sort(key=lambda r: (r.get("start_wall") or 0.0, r.get("seq", 0)))
    return records


# -- MTTR ---------------------------------------------------------------


def mttr_report(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Failure→recovery episodes per job, with causal step offsets.

    An episode opens at a :data:`FAILURE_KINDS` event and closes at
    the next :data:`RECOVERY_KINDS` event in the same job's timeline;
    every event in between is an itemized repair step (teardown,
    relaunch, checkpoint restore, …). Returns ``{job_id: {"episodes":
    [...], "count", "mean_repair_s", "max_repair_s"}}``."""
    by_job: Dict[str, List[Dict[str, Any]]] = {}
    for rec in events:
        by_job.setdefault(rec.get("job") or "(unattributed)", []).append(rec)
    report: Dict[str, Any] = {}
    for job_id, recs in by_job.items():
        recs = sorted(recs, key=lambda r: (r.get("start_wall") or 0.0,
                                           r.get("seq", 0)))
        episodes: List[Dict[str, Any]] = []
        open_ep: Optional[Dict[str, Any]] = None
        for rec in recs:
            kind = rec.get("name", "")
            wall = float(rec.get("start_wall") or 0.0)
            if open_ep is None:
                if kind in FAILURE_KINDS:
                    open_ep = {
                        "start_kind": kind,
                        "start_wall": wall,
                        "steps": [],
                    }
                continue
            if kind in RECOVERY_KINDS:
                open_ep["end_kind"] = kind
                open_ep["end_wall"] = wall
                open_ep["repair_s"] = wall - open_ep["start_wall"]
                episodes.append(open_ep)
                open_ep = None
            else:
                open_ep["steps"].append(
                    {"kind": kind, "dt_s": wall - open_ep["start_wall"]}
                )
        repairs = [e["repair_s"] for e in episodes]
        report[job_id] = {
            "episodes": episodes,
            "count": len(episodes),
            "mean_repair_s": sum(repairs) / len(repairs) if repairs else 0.0,
            "max_repair_s": max(repairs) if repairs else 0.0,
            "unresolved": open_ep is not None,
        }
    return report


# -- rendering ----------------------------------------------------------


def _fmt_attrs(attrs: Dict[str, Any]) -> str:
    return " ".join(f"{k}={attrs[k]}" for k in sorted(attrs))


def format_timeline(events: List[Dict[str, Any]]) -> str:
    """Human-readable per-job timeline + MTTR section."""
    if not events:
        return "(no events)"
    by_job: Dict[str, List[Dict[str, Any]]] = {}
    names: Dict[str, str] = {}
    for rec in events:
        job_id = rec.get("job") or "(unattributed)"
        by_job.setdefault(job_id, []).append(rec)
        if rec.get("job_name"):
            names.setdefault(job_id, rec["job_name"])
    mttr = mttr_report(events)
    lines: List[str] = []
    for job_id in sorted(by_job):
        label = names.get(job_id)
        header = f"== job {job_id}" + (f" ({label})" if label else "")
        lines.append(header + " ==")
        recs = sorted(by_job[job_id],
                      key=lambda r: (r.get("start_wall") or 0.0,
                                     r.get("seq", 0)))
        t0 = float(recs[0].get("start_wall") or 0.0)
        for rec in recs:
            wall = float(rec.get("start_wall") or 0.0)
            stamp = time.strftime("%H:%M:%S", time.localtime(wall))
            attrs = rec.get("attrs") or {}
            extra = _fmt_attrs(attrs)
            lines.append(
                f"  {stamp} +{wall - t0:8.3f}s  {rec.get('name', '?'):24s}"
                + (f" {extra}" if extra else "")
            )
        job_mttr = mttr.get(job_id, {})
        if job_mttr.get("count"):
            lines.append(
                f"  MTTR: {job_mttr['count']} recovery episode(s), "
                f"mean {job_mttr['mean_repair_s']:.3f}s, "
                f"max {job_mttr['max_repair_s']:.3f}s"
            )
            for i, ep in enumerate(job_mttr["episodes"], 1):
                steps = ", ".join(
                    f"{s['kind']} +{s['dt_s']:.3f}s" for s in ep["steps"]
                )
                lines.append(
                    f"    episode {i}: {ep['start_kind']} -> "
                    f"{ep['end_kind']} in {ep['repair_s']:.3f}s"
                    + (f" ({steps})" if steps else "")
                )
        if job_mttr.get("unresolved"):
            lines.append("  WARNING: unresolved failure (no recovery event)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m raydp_tpu_torch.telemetry.events",
        description="Render the cluster event timeline (per job, with "
                    "MTTR breakdowns) from events-*.jsonl shards.",
    )
    parser.add_argument(
        "directory", nargs="?", default=None,
        help="telemetry dir holding events-*.jsonl shards "
             "(default: $RAYDP_TPU_TELEMETRY_DIR)",
    )
    parser.add_argument("--job", default=None,
                        help="only this job id")
    parser.add_argument("--json", action="store_true",
                        help="raw records as JSON instead of the timeline")
    args = parser.parse_args(argv)
    directory = args.directory or telemetry_dir()
    if not directory:
        print("no directory given and RAYDP_TPU_TELEMETRY_DIR unset",
              file=sys.stderr)
        return 2
    events = load_event_records(directory, job=args.job)
    try:
        if args.json:
            print(json.dumps(
                {"events": events, "mttr": mttr_report(events)}, default=str
            ))
        else:
            print(format_timeline(events))
    except BrokenPipeError:
        # Downstream consumer (e.g. `| grep -q` under pipefail) closed
        # the pipe after finding what it wanted; redirect stdout to
        # devnull so the interpreter's shutdown flush stays quiet.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
