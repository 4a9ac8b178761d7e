"""Unified flywheel dashboard: the whole system in one view.

The port's copy of ``raydp_tpu/telemetry/dashboard.py``. Its control
section folds the autoscaler's pool size and decisions and the
arbiter's queue (``raydp_tpu_torch/control/``), with the arbiter's
whole report as ``control.scheduler`` where the caller passes it
(``Cluster.dashboard_report`` does); its sim section, a replay of
``raydp_tpu_torch/sim/`` in this process.

Every plane built so far reports somewhere — training MFU and step
phases in the device profiler, ETL stage rows in the operator metrics,
serving latency/fill/shed in the replica group, pool size and queue
depth in the autoscaler and arbiter, objective status in the SLO
engine — but each lives behind its own report call. This module folds
the merged metrics view plus the SLO status table plus the event
timeline into one job-aware dashboard document, served three ways:

* ``/debug/dashboard`` on the Prometheus sidecar
  (:func:`~raydp_tpu_torch.telemetry.export.serve_prometheus`);
* ``Cluster.dashboard_report()`` / the ``DashboardReport`` RPC in
  client mode (idempotent, retried like the other report RPCs);
* ``python -m raydp_tpu_torch.telemetry.dashboard`` — live against a scrape
  URL, offline against a telemetry directory's event shards, or
  in-process.

The document is plain JSON (``build``); ``format_dashboard`` renders
it for terminals.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.telemetry import slo as _slo
from raydp_tpu_torch.telemetry.timeseries import active_store, flatten_view

__all__ = [
    "build",
    "local_dashboard",
    "format_dashboard",
    "main",
]

#: Timeline tail length carried in the document — enough to show the
#: current episode without shipping the whole ring over the RPC.
_EVENT_TAIL = 32


def _ms(value: Optional[float]) -> Optional[float]:
    return round(value * 1000.0, 3) if value is not None else None


def _rounded(value: Optional[float], digits: int = 4) -> Optional[float]:
    return round(value, digits) if value is not None else None


def _collect_prefix(flat: Dict[str, float], prefix: str) -> Dict[str, float]:
    return {
        name[len(prefix):]: round(value, 4)
        for name, value in sorted(flat.items())
        if name.startswith(prefix)
    }


def build(
    view: Dict[str, Any],
    scheduler: Optional[Dict[str, Any]] = None,
    events: Optional[List[Dict[str, Any]]] = None,
    ts_stats: Optional[Dict[str, Any]] = None,
    slo: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Fold a merged metrics view (``Cluster.metrics_snapshot()``
    shape) into the dashboard document.

    ``scheduler``/``events``/``ts_stats``/``slo`` default to this
    process's live sources (active SLO engine, local event ring, active
    sampler store) so the driver-side call needs only the view."""
    flat = flatten_view(view)

    def g(name: str) -> Optional[float]:
        return flat.get(name)

    shuffle_bytes = g("shuffle/bytes") or 0.0
    shuffle_local = g("shuffle/local_bytes") or 0.0
    train = {
        "mfu": _rounded(g("mfu")),
        "step_p50_ms": _ms(g("train/step/p50_s")),
        "step_p99_ms": _ms(g("train/step/p99_s")),
        "steps": g("train/step/count"),
        "restarts": g("restarts/total"),
        "preemptions": g("preemptions/total"),
        "watchdog_stalls": g("watchdog/stalls"),
        "phase_fractions": {
            name: _rounded(g(f"phase/{name}_frac"))
            for name in ("input_wait", "dispatch", "compute", "collective")
            if g(f"phase/{name}_frac") is not None
        },
        "anomalies": _collect_prefix(flat, "anomalies/"),
    }
    etl = {
        "ingest_rows_per_sec": _rounded(g("ingest/rows/per_sec")),
        "ingest_bytes_per_sec": _rounded(g("ingest/bytes/per_sec")),
        "ingest_wait_seconds": _rounded(g("ingest/wait_seconds")),
        "stage_rows_out": _collect_prefix(flat, "stage/rows_out/"),
        "shuffle_bytes": shuffle_bytes,
        "shuffle_locality": _rounded(
            shuffle_local / shuffle_bytes if shuffle_bytes > 0 else None
        ),
        "pipeline_overlap_seconds": _rounded(g("pipeline/overlap_seconds")),
    }
    serve = {
        "requests": g("serve/requests"),
        "replies": g("serve/replies"),
        "errors": g("serve/errors"),
        "shed": g("serve/rejected"),
        "restarts": g("serve/restarts"),
        "p50_ms": _ms(g("serve/latency/p50_s")),
        "p99_ms": _ms(g("serve/latency/p99_s")),
        "batch_fill": _rounded(g("serve/batch_fill")),
        "queue_depth": g("serve/queue_depth"),
        "replicas_alive": g("serve/replicas_alive"),
        "throughput_per_sec": _rounded(g("serve/throughput/per_sec")),
        # Latency provenance (mean ms per phase) and the most recent
        # capacity knee, when a load sweep has run.
        "phase_ms": {
            name: _ms(g(f"serve/phase/{name}/mean_s"))
            for name in ("queue_wait", "linger", "execute", "reply",
                         "padding_waste")
            if g(f"serve/phase/{name}/mean_s") is not None
        },
        "knee_rps": _rounded(g("loadgen/knee_rps")),
    }
    control = {
        "pool_size": g("autoscale/pool_size"),
        "pending_spawns": g("autoscale/pending_spawns"),
        "autoscale_decisions": _collect_prefix(flat, "autoscale/decisions/"),
        "sched_queue_depth": g("sched/queue_depth"),
        "sched_queue_wait_oldest_s": _rounded(g("sched/queue_wait_oldest")),
        "sched_sheds": g("sched/sheds"),
    }
    if scheduler:
        control["scheduler"] = scheduler

    # Observatory panel: what the virtual-clock simulator saw. Only
    # present when a replay ran in this process (or its counters were
    # merged in) so live dashboards without simulation stay unchanged.
    sim = {
        "arrivals": g("sim/arrivals"),
        "completed": g("sim/completed"),
        "shed": g("sim/shed"),
        "invariant_violations": g("sim/invariant_violations"),
        "pathologies": _collect_prefix(flat, "sim/pathologies/"),
        "knee_rps": _rounded(g("sim/knee_rps")),
        "events_per_sec": _rounded(g("sim/events_per_s")),
        "replica_deaths": g("sim/replica_deaths"),
    }
    has_sim = any(
        value not in (None, {}) for value in sim.values()
    )

    if events is None:
        events = _events.local_events()
    tail = [
        {
            "kind": rec.get("name"),
            "job": rec.get("job"),
            "wall": rec.get("start_wall"),
            "attrs": rec.get("attrs") or {},
        }
        for rec in events[-_EVENT_TAIL:]
    ]
    mttr = _events.mttr_report(events)

    doc: Dict[str, Any] = {
        "generated_wall": time.time(),
        "train": train,
        "etl": etl,
        "serve": serve,
        "control": control,
        "slo": slo if slo is not None else _slo.status_report(),
        "jobs": _acct.usage_report(view),
        "events": {"tail": tail, "mttr": mttr},
        "timeseries": (
            ts_stats if ts_stats is not None
            else (lambda s: s.stats() if s else {})(active_store())
        ),
    }
    if has_sim:
        doc["sim"] = sim
    return doc


def local_dashboard() -> Dict[str, Any]:
    """Dashboard over this process's own registry — the default
    ``/debug/dashboard`` callback when no cluster wired a richer one."""
    from raydp_tpu_torch.utils.profiling import metrics as _metrics

    view = {"workers": {}, "aggregate": {}, "driver": _metrics.snapshot()}
    return build(view)


# -- terminal rendering -------------------------------------------------


def _fmt(value: Any) -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:g}"
    return str(value)


def _section(title: str, rows: Dict[str, Any]) -> List[str]:
    lines = [f"== {title} =="]
    for key, value in rows.items():
        if isinstance(value, dict):
            if not value:
                continue
            inner = ", ".join(f"{k}={_fmt(v)}" for k, v in value.items())
            lines.append(f"  {key:28s} {inner}")
        else:
            lines.append(f"  {key:28s} {_fmt(value)}")
    return lines


def format_dashboard(dash: Dict[str, Any]) -> str:
    """Human rendering of a :func:`build` document."""
    lines: List[str] = ["raydp_tpu_torch flywheel dashboard"]
    for title, key in (
        ("train", "train"), ("etl", "etl"), ("serve", "serve"),
        ("control", "control"),
    ):
        lines.extend(_section(title, dash.get(key) or {}))
    if dash.get("sim"):
        lines.extend(_section("sim", dash["sim"]))

    slo = dash.get("slo") or {}
    lines.append("== slo ==")
    if not slo:
        lines.append("  (engine not running)")
    for name, row in slo.items():
        status = row.get("status", "?")
        lines.append(
            f"  [{status:8s}] {name:22s} "
            f"burn={_fmt(row.get('burn_short'))}/"
            f"{_fmt(row.get('burn_long'))} "
            f"value={_fmt(row.get('value'))} "
            f"thr={_fmt(row.get('threshold'))} "
            f"breaches={_fmt(row.get('breaches'))} "
            f"mttr={_fmt(row.get('last_mttr_s'))}"
        )
        for top in row.get("top_series") or []:
            lines.append(
                f"             ^ {top.get('series')} = "
                f"{_fmt(top.get('value'))}"
            )

    jobs = (dash.get("jobs") or {}).get("jobs") or {}
    if jobs:
        lines.append("== jobs ==")
        for job_id, row in jobs.items():
            usage = ", ".join(
                f"{k}={_fmt(v)}"
                for k, v in (row.get("usage") or {}).items()
            )
            lines.append(
                f"  {row.get('name') or job_id:24s} {usage}"
            )

    events = dash.get("events") or {}
    tail = events.get("tail") or []
    lines.append("== events ==")
    now = dash.get("generated_wall") or time.time()
    for rec in tail:
        ago = now - (rec.get("wall") or now)
        job = rec.get("job") or "-"
        lines.append(
            f"  {ago:8.1f}s ago  {rec.get('kind'):24s} job={job}"
        )
    mttr = events.get("mttr") or {}
    for job_id, report in mttr.items():
        lines.append(
            f"  mttr[{job_id}]: {report.get('count')} episode(s), "
            f"mean={_fmt(report.get('mean_repair_s'))}s "
            f"max={_fmt(report.get('max_repair_s'))}s"
        )
        for ep in report.get("episodes") or []:
            lines.append(
                f"    {ep.get('start_kind')} -> {ep.get('end_kind')} "
                f"in {_fmt(ep.get('repair_s'))}s"
            )

    ts = dash.get("timeseries") or {}
    if ts:
        lines.extend(_section("timeseries", ts))
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------


def _fetch_url(url: str) -> Dict[str, Any]:
    import urllib.request

    target = url.rstrip("/")
    if not target.endswith("/debug/dashboard"):
        target = target + "/debug/dashboard"
    with urllib.request.urlopen(target, timeout=10) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _offline_dashboard(directory: str) -> Dict[str, Any]:
    """Post-hoc dashboard from a telemetry directory's event shards —
    no metrics view survives a run, so this is the episode story:
    timeline tail, MTTR episodes, and the SLO breach/recovery events."""
    records = _events.load_event_records(directory)
    empty_view: Dict[str, Any] = {"workers": {}, "aggregate": {}, "driver": {}}
    # Simulator episode story: the sim/* events a replay wrote through
    # become the offline sim panel (violations, pathology episodes,
    # last run's headline numbers).
    sim_rows: Dict[str, Any] = {
        "pathologies": {}, "invariant_violations": 0,
    }
    saw_sim = False
    for rec in records:
        name = rec.get("name")
        attrs = rec.get("attrs") or {}
        if name == "sim/run":
            saw_sim = True
            sim_rows.update(
                arrivals=attrs.get("arrivals"),
                completed=attrs.get("completed"),
                shed=attrs.get("shed"),
                events_per_sec=attrs.get("events_per_s"),
            )
        elif name == "sim/invariant":
            saw_sim = True
            sim_rows["invariant_violations"] += 1
        elif name == "sim/pathology":
            saw_sim = True
            kind = attrs.get("pathology") or "?"
            sim_rows["pathologies"][kind] = (
                sim_rows["pathologies"].get(kind, 0) + 1
            )
        elif name == "sim/knee":
            saw_sim = True
            sim_rows["knee_rps"] = attrs.get("knee_rps")
    slo_rows: Dict[str, Any] = {}
    for rec in records:
        if rec.get("name") not in ("slo/breach", "slo/recovered"):
            continue
        attrs = rec.get("attrs") or {}
        name = attrs.get("objective") or "?"
        row = slo_rows.setdefault(name, {
            "status": "ok", "series": attrs.get("series"),
            "breaches": 0, "last_mttr_s": None, "top_series": [],
        })
        if rec.get("name") == "slo/breach":
            row["status"] = "breached"
            row["breaches"] += 1
            row["value"] = attrs.get("value")
            row["threshold"] = attrs.get("threshold")
            row["burn_short"] = attrs.get("burn_short")
            row["burn_long"] = attrs.get("burn_long")
            row["top_series"] = attrs.get("top_series") or []
        else:
            row["status"] = "ok"
            row["last_mttr_s"] = attrs.get("mttr_s")
    dash = build(
        empty_view, events=records, ts_stats={}, slo=slo_rows,
    )
    if saw_sim:
        dash["sim"] = sim_rows
    return dash


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m raydp_tpu_torch.telemetry.dashboard",
        description="Render the unified flywheel dashboard.",
    )
    parser.add_argument(
        "directory", nargs="?", default=None,
        help="telemetry directory (offline mode: event shards only)",
    )
    parser.add_argument(
        "--url", default=None,
        help="scrape-server base URL (live mode via /debug/dashboard)",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit the raw JSON document"
    )
    args = parser.parse_args(argv)

    if args.url:
        dash = _fetch_url(args.url)
    elif args.directory:
        dash = _offline_dashboard(args.directory)
    else:
        dash = local_dashboard()

    if args.json:
        print(json.dumps(dash, indent=2, sort_keys=True, default=str))
    else:
        print(format_dashboard(dash))
    return 0


if __name__ == "__main__":
    sys.exit(main())
