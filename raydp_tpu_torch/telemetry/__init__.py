"""Telemetry of the port (the counterpart of ``raydp_tpu/telemetry/``).

Standard library only, importable from the torch-free ETL worker and
rank mains. The planes this package holds:

* the trace plane: :mod:`~raydp_tpu_torch.telemetry.spans` (nested spans
  in a bounded ring, evictions counted), :mod:`.propagation` (the W3C
  ``traceparent`` carried in RPC envelopes, launch envs and across
  threads, so one run is one trace across processes), :mod:`.export`
  (per-process JSONL shards, the Prometheus exposition and the debug
  endpoint), :mod:`.chrome_trace` and :mod:`.analyze` (clock-aligned
  Chrome trace, critical path, per-rank step skew, data-wait against
  compute; ``python -m raydp_tpu_torch.telemetry.analyze <dir>``);
* the accounting plane: :mod:`.accounting` (a :class:`JobContext`
  minted at workload roots, the usage ledger billed per job; its
  ``chip_seconds`` are CUDA-device seconds here) and :mod:`.events` (the
  cluster's event timeline, MTTR);
* the health plane: :mod:`.watchdog` (stall detection of in-flight
  ops), :mod:`.flight_recorder` (postmortem bundles on a crash, an
  unhandled exception or SIGTERM) and :mod:`.logs` (trace-stamped JSONL
  logs);
* the shipped metrics: :mod:`.shipping` (heartbeat deltas, the master's
  merged view with tombstones) and :mod:`.overlap` (how much of the
  scheduler's work overlaps);
* :mod:`.progress`: the DataFrame engine's stage statistics;
* the device plane: :mod:`.device_profiler` (a stream step's input-wait
  / dispatch / compute / collective split from CUDA events, ``mfu``
  against the card's peak, anomaly sentinels, and ``torch.profiler``
  captures across a gang merged into one Perfetto trace:
  ``Cluster.capture_profile()``, ``/debug/profile``);
* the observability control plane: :mod:`.timeseries` (the driver's
  bounded rings sampled from the merged view), :mod:`.slo` (objectives
  evaluated as burn rates over two windows, breach and recovery events,
  ``raydp_slo_*`` families) and :mod:`.dashboard` (one document:
  ``Cluster.dashboard_report()``, ``/debug/dashboard``,
  ``python -m raydp_tpu_torch.telemetry.dashboard``).
"""
from raydp_tpu_torch.telemetry.chrome_trace import (
    load_span_records,
    to_chrome_trace,
    write_chrome_trace,
)
from raydp_tpu_torch.telemetry.export import (
    DEBUG_PORT_ENV,
    METRICS_PORT_ENV,
    TELEMETRY_DIR_ENV,
    flush_spans,
    render_prometheus,
    serve_prometheus,
    telemetry_dir,
    write_events,
)
from raydp_tpu_torch.telemetry import (
    accounting,
    dashboard,
    device_profiler,
    events,
    flight_recorder,
    logs,
    progress,
    slo,
    timeseries,
    watchdog,
)
from raydp_tpu_torch.telemetry.accounting import (
    JOB_ENV,
    JobContext,
    add_usage,
    adopt_env_job,
    current_job,
    ensure_job,
    job_scope,
    mint_job,
    set_process_job,
    usage_report,
)
from raydp_tpu_torch.telemetry.events import (
    EVENT_BUFFER_ENV,
    load_event_records,
    mttr_report,
)
from raydp_tpu_torch.telemetry.device_profiler import (
    AnomalySentinel,
    StepPhaseAccumulator,
    capture_trace_archive,
    classify_fractions,
    merge_rank_traces,
)
from raydp_tpu_torch.telemetry.progress import (
    PROGRESS_LOG_ENV,
    STAGE_STATS_ENV,
    STATS_DIR_ENV,
    ProgressTracker,
    StageStats,
    StageStatsStore,
    stage_stats_enabled,
    stage_store,
)
from raydp_tpu_torch.telemetry.flight_recorder import (
    POSTMORTEM_DIR_ENV,
    dump_bundle,
    latest_bundle,
    postmortem_dir,
)
from raydp_tpu_torch.telemetry.watchdog import Watchdog, inflight
from raydp_tpu_torch.telemetry.propagation import (
    TRACEPARENT_ENV,
    TraceContext,
    adopt_env_context,
    current_context,
    env_for_child,
    from_traceparent,
    mint_context,
    process_context,
    propagated,
    set_process_context,
    to_traceparent,
)
from raydp_tpu_torch.telemetry.shipping import ClusterTelemetry, MetricsShipper
from raydp_tpu_torch.telemetry.slo import Objective, SloConfig, SloEngine
from raydp_tpu_torch.telemetry.spans import (
    Span,
    SpanRecorder,
    event,
    recorder,
    span,
)
from raydp_tpu_torch.telemetry.timeseries import (
    TIMESERIES_ENV,
    TimeSeriesConfig,
    TimeSeriesSampler,
    TimeSeriesStore,
    timeseries_enabled,
)

__all__ = [
    "Span",
    "SpanRecorder",
    "TraceContext",
    "recorder",
    "span",
    "event",
    "MetricsShipper",
    "ClusterTelemetry",
    "TELEMETRY_DIR_ENV",
    "METRICS_PORT_ENV",
    "DEBUG_PORT_ENV",
    "POSTMORTEM_DIR_ENV",
    "TRACEPARENT_ENV",
    "JOB_ENV",
    "EVENT_BUFFER_ENV",
    "flight_recorder",
    "logs",
    "watchdog",
    "device_profiler",
    "accounting",
    "events",
    "dashboard",
    "slo",
    "timeseries",
    "TIMESERIES_ENV",
    "TimeSeriesConfig",
    "TimeSeriesStore",
    "TimeSeriesSampler",
    "timeseries_enabled",
    "Objective",
    "SloConfig",
    "SloEngine",
    "JobContext",
    "current_job",
    "job_scope",
    "mint_job",
    "ensure_job",
    "set_process_job",
    "adopt_env_job",
    "add_usage",
    "usage_report",
    "load_event_records",
    "mttr_report",
    "AnomalySentinel",
    "StepPhaseAccumulator",
    "capture_trace_archive",
    "classify_fractions",
    "merge_rank_traces",
    "Watchdog",
    "inflight",
    "dump_bundle",
    "latest_bundle",
    "postmortem_dir",
    "telemetry_dir",
    "flush_spans",
    "write_events",
    "render_prometheus",
    "serve_prometheus",
    "current_context",
    "propagated",
    "set_process_context",
    "process_context",
    "mint_context",
    "adopt_env_context",
    "env_for_child",
    "to_traceparent",
    "from_traceparent",
    "load_span_records",
    "to_chrome_trace",
    "write_chrome_trace",
]
