"""Export surface: Prometheus text exposition + append-only JSONL logs
(the port's copy of ``raydp_tpu/telemetry/export.py``).

:func:`render_prometheus` is whole, and :func:`serve_prometheus` serves
every route of the JAX package's, ``/debug/profile`` (a
``torch.profiler`` capture) and ``/debug/dashboard`` included. The
port's one addition: a view's ``gangs`` (finished
SPMD gangs' rank views, which the master keeps) render as workers do,
but with no ``raydp_worker_up`` series: a rank is not an ETL worker.

Two consumers, two formats:

* **Prometheus text exposition v0.0.4** — :func:`render_prometheus`
  turns a merged cluster view (``Cluster.metrics_snapshot()``) into
  scrape-ready text. Registry names become label values (not metric
  names), so arbitrary ``ingest/rows``-style names need no mangling and
  the metric families stay fixed:

  - ``raydp_worker_up{worker=…}`` gauge (0 = tombstoned)
  - ``raydp_counter_total{worker=…,name=…}`` counter
  - ``raydp_meter_units_total`` / ``raydp_meter_units_per_second``
  - ``raydp_timer_seconds`` summary (quantile samples + ``_sum``/``_count``)

* **JSONL logs** — :func:`flush_spans` drains the process span ring to
  a per-process ``<telemetry_dir>/spans-<pid>.jsonl`` shard (so
  concurrent processes never interleave within a line and the
  Chrome-trace merger can attribute shards);  :func:`write_events`
  appends master lifecycle events to ``events.jsonl``. One JSON object
  per line, append-only, safe to tail while the job runs.

``telemetry_dir`` is configured with the ``RAYDP_TPU_TELEMETRY_DIR``
environment variable (inherited by worker subprocesses, so every
process of a job logs under one directory) or passed explicitly.
:func:`serve_prometheus` exposes the exposition over a tiny stdlib
HTTP endpoint for in-cluster scrapes (the k8s manifests annotate pods
with ``prometheus.io/scrape`` pointing at it) — and doubles as the
per-process **debug server**: ``/livez`` (pure responsiveness, always
200 — the k8s *liveness* target, because a watchdog stall can be a
legitimately long op), ``/healthz`` (200/503 from the local watchdog
state, the *readiness* target), ``/debug/state`` (JSON health +
flight-recorder tail + metrics snapshot), ``/debug/stacks``
(all-thread dump). Pass ``port=0`` for an ephemeral port (reported on
the handle and in the startup log line) so several processes on one
host never collide on ``RAYDP_TPU_METRICS_PORT``.
"""
from __future__ import annotations

import glob as _glob
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from raydp_tpu_torch.telemetry import spans as _spans

__all__ = [
    "TELEMETRY_DIR_ENV",
    "METRICS_PORT_ENV",
    "DEBUG_PORT_ENV",
    "SHARD_KEEP_ENV",
    "telemetry_dir",
    "append_jsonl",
    "shard_keep",
    "prune_shards",
    "prune_shards_once",
    "flush_spans",
    "write_events",
    "render_prometheus",
    "serve_prometheus",
]

TELEMETRY_DIR_ENV = "RAYDP_TPU_TELEMETRY_DIR"
METRICS_PORT_ENV = "RAYDP_TPU_METRICS_PORT"
# Worker processes serve their own /healthz + /debug endpoints on this
# port when set. Use 0 for an ephemeral port (many workers per host).
DEBUG_PORT_ENV = "RAYDP_TPU_DEBUG_PORT"
# Per-kind retention cap for JSONL shards (spans-/logs-/stats-/events-);
# oldest shards beyond the cap are pruned on a process's first write of
# that kind, mirroring the RAYDP_TPU_POSTMORTEM_KEEP bundle cap.
SHARD_KEEP_ENV = "RAYDP_TPU_SHARD_KEEP"
_DEFAULT_SHARD_KEEP = 64

logger = logging.getLogger(__name__)

_write_mu = threading.Lock()


def telemetry_dir() -> Optional[str]:
    """The configured telemetry directory, or None when disabled."""
    return os.environ.get(TELEMETRY_DIR_ENV) or None


def append_jsonl(path: str, records: Iterable[Dict[str, Any]]) -> int:
    """Append records as JSON lines; returns the number written.
    Non-JSON-safe attr values are stringified rather than dropped."""
    count = 0
    with _write_mu:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
                count += 1
    return count


# -- shard retention ----------------------------------------------------

# Kinds already pruned by this process: retention runs once per
# (directory, kind) per process — at the first write — not per append.
_pruned_kinds: set = set()
_prune_mu = threading.Lock()


def shard_keep() -> int:
    """Retention cap per shard kind (``RAYDP_TPU_SHARD_KEEP``)."""
    try:
        return max(1, int(os.environ.get(SHARD_KEEP_ENV, "")))
    except ValueError:
        return _DEFAULT_SHARD_KEEP


def _shard_age_key(path: str) -> tuple:
    # mtime first; the numeric <pid> breaks same-mtime ties so
    # "oldest" stays well-defined on coarse-mtime filesystems.
    name = os.path.basename(path)
    try:
        pid = int(name.rsplit("-", 1)[1].split(".", 1)[0])
    except (IndexError, ValueError):
        pid = 0
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0.0
    return (mtime, pid)


def prune_shards(
    directory: str, kind: str, keep: Optional[int] = None
) -> int:
    """Delete the oldest ``<kind>-*.jsonl`` shards beyond ``keep`` —
    the disk bound for a telemetry dir reused across many runs.
    Lock-free and per-file best-effort (several processes may prune one
    shared directory concurrently). Returns the number deleted."""
    keep = shard_keep() if keep is None else max(1, int(keep))
    removed = 0
    try:
        shards = _glob.glob(os.path.join(directory, f"{kind}-*.jsonl"))
        if len(shards) <= keep:
            return 0
        shards.sort(key=_shard_age_key)
        for path in shards[:-keep]:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
    except OSError:
        pass
    return removed


def prune_shards_once(directory: str, kind: str) -> None:
    """Run retention for ``kind`` at most once per process — writers
    call this before their first append so a long-lived telemetry dir
    converges to the cap without per-write listdir cost."""
    key = (directory, kind)
    with _prune_mu:
        if key in _pruned_kinds:
            return
        _pruned_kinds.add(key)
    prune_shards(directory, kind)


def flush_spans(
    directory: Optional[str] = None, recorder: Optional[Any] = None
) -> Optional[str]:
    """Drain the span ring buffer to ``<dir>/spans-<pid>.jsonl``.

    One shard per process: every process of a job appends only to its
    own file, and :mod:`~raydp_tpu_torch.telemetry.chrome_trace` merges the
    shards. No-op (buffer left intact) when no directory is configured,
    so instrumented code calls this unconditionally. Returns the shard
    path when writing happened.
    """
    directory = directory or telemetry_dir()
    if not directory:
        return None
    rec = recorder if recorder is not None else _spans.recorder
    drained = rec.drain()
    prune_shards_once(directory, "spans")
    path = os.path.join(directory, f"spans-{os.getpid()}.jsonl")
    append_jsonl(path, (s.to_dict() for s in drained))
    return path


def write_events(
    events: List[Dict[str, Any]], directory: Optional[str] = None
) -> Optional[str]:
    """Append lifecycle events to ``<dir>/events.jsonl``."""
    directory = directory or telemetry_dir()
    if not directory or not events:
        return None
    path = os.path.join(directory, "events.jsonl")
    append_jsonl(path, events)
    return path


# -- Prometheus text exposition v0.0.4 ---------------------------------


def _fmt(value: float) -> str:
    try:
        value = float(value)
    except (TypeError, ValueError):
        return "NaN"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _label(value: str) -> str:
    """Escape a label value per the exposition format."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class _Family:
    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[str] = []

    def add(self, labels: Dict[str, str], value: float,
            suffix: str = "") -> None:
        inner = ",".join(
            f'{k}="{_label(v)}"' for k, v in sorted(labels.items())
        )
        self.samples.append(f"{self.name}{suffix}{{{inner}}} {_fmt(value)}")

    def render(self) -> List[str]:
        if not self.samples:
            return []
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
            *self.samples,
        ]


def render_prometheus(view: Dict[str, Any]) -> str:
    """Merged cluster view → Prometheus text exposition v0.0.4.

    ``view`` is the ``Cluster.metrics_snapshot()`` shape: ``{"workers":
    {wid: {...sections...}}, "aggregate": ..., "driver": ...}``. The
    driver's own registry renders under ``worker="driver"``; the
    aggregate is intentionally NOT rendered (Prometheus aggregates at
    query time — pre-aggregated series would double-count on ``sum()``).
    ``view["gangs"]`` (``{"<gang>/rank-<r>": {...sections...}}``, the
    port's) renders under ``worker="<gang>/rank-<r>"`` with no liveness.
    """
    up = _Family(
        "raydp_worker_up", "gauge",
        "Worker liveness (0 = dead; final snapshot tombstoned).",
    )
    counters = _Family(
        "raydp_counter_total", "counter",
        "MetricsRegistry counters, one series per (worker, name).",
    )
    meter_total = _Family(
        "raydp_meter_units_total", "counter",
        "ThroughputMeter cumulative units (rows, bytes, samples).",
    )
    meter_rate = _Family(
        "raydp_meter_units_per_second", "gauge",
        "ThroughputMeter rate since first record.",
    )
    timers = _Family(
        "raydp_timer_seconds", "summary",
        "StepTimer rolling-window summaries.",
    )
    dropped = _Family(
        "raydp_spans_dropped_total", "counter",
        "Spans evicted from a process's ring buffer before any flush "
        "drained them (raise RAYDP_TPU_SPAN_BUFFER or flush more often).",
    )
    stalls = _Family(
        "raydp_stalls_total", "counter",
        "Watchdog-detected stall episodes: a component's oldest "
        "in-flight op exceeded RAYDP_TPU_WATCHDOG_STALL_S.",
    )
    rpc_payload = _Family(
        "raydp_rpc_payload_bytes", "counter",
        "Serialized request-envelope bytes this process sent over the "
        "control plane. Tables move through the shm object store, so a "
        "fat series here means some path is smuggling data through RPC.",
    )
    shuffle_bytes = _Family(
        "raydp_shuffle_bytes_total", "counter",
        "Bytes entering exchange merge tasks (split-chunk sizes summed "
        "at merge dispatch).",
    )
    shuffle_local = _Family(
        "raydp_shuffle_local_bytes_total", "counter",
        "Subset of raydp_shuffle_bytes_total already resident on the "
        "merge worker's node — zero-copy shm reads. The ratio to the "
        "total is the exchange locality hit-rate.",
    )
    shuffles_elided = _Family(
        "raydp_shuffles_elided_total", "counter",
        "Exchanges skipped by the co-partitioning planner because the "
        "frame's existing hash partitioning already co-located the keys.",
    )
    aqe_replans = _Family(
        "raydp_aqe_replans_total", "counter",
        "Adaptive-query-engine replan decisions, per rule "
        "(rule=coalesce|salt|join|scan). Each bump has exactly one "
        "matching aqe[<rule>] annotation in the plan explain(analyze) "
        "renders — the explain/Prometheus parity invariant.",
    )
    aqe_coalesced = _Family(
        "raydp_aqe_coalesced_partitions_total", "counter",
        "Post-shuffle buckets merged away by the AQE coalesce rule "
        "(measured bytes below RAYDP_TPU_AQE_TARGET_PARTITION_MB).",
    )
    aqe_salted = _Family(
        "raydp_aqe_salted_keys_total", "counter",
        "Hot buckets/partitions the AQE salt rule split across "
        "sub-parts (layout skew above RAYDP_TPU_AQE_SKEW_RATIO).",
    )
    aqe_bytes_saved = _Family(
        "raydp_aqe_bytes_saved_total", "counter",
        "Compressed parquet bytes the AQE scan rule avoided reading: "
        "skipped column chunks plus row groups pruned from footer "
        "min/max statistics.",
    )
    pipeline_overlap = _Family(
        "raydp_pipeline_overlap_seconds_total", "counter",
        "Wall seconds during which ETL partition tasks and training "
        "ingest (staging/device transfers) were in flight SIMULTANEOUSLY "
        "— the time the streaming stage scheduler hid behind the "
        "consumer. Zero under RAYDP_TPU_STREAMING=0.",
    )
    stage_rows = _Family(
        "raydp_stage_rows_total", "counter",
        "Rows entering/leaving DataFrame stages, per plan-node label "
        "(direction=in|out).",
    )
    stage_bytes = _Family(
        "raydp_stage_bytes_total", "counter",
        "Arrow bytes entering/leaving DataFrame stages (direction=in|out).",
    )
    stage_seconds = _Family(
        "raydp_stage_seconds_total", "counter",
        "Wall seconds spent in DataFrame stages, per plan-node label.",
    )
    compiles = _Family(
        "raydp_compiles_total", "counter",
        "XLA backend compiles observed via jax.monitoring (one per "
        "top-level compile event).",
    )
    compile_seconds = _Family(
        "raydp_compile_seconds_total", "counter",
        "Cumulative XLA compile seconds (all compile-phase duration "
        "events summed).",
    )
    compile_failures = _Family(
        "raydp_compile_failures_total", "counter",
        "XLA compiles that raised (remote-compile HTTP errors included).",
    )
    restarts = _Family(
        "raydp_restarts_total", "counter",
        "Supervised fit_spmd gang relaunches (rank death, registration "
        "timeout, or preemption; see doc/fault_tolerance.md).",
    )
    preemptions = _Family(
        "raydp_preemptions_total", "counter",
        "Preemption notices observed by the fit_spmd supervisor (drained "
        "with an emergency checkpoint when checkpoint_dir is set).",
    )
    replay_steps = _Family(
        "raydp_replay_steps_total", "counter",
        "Optimizer steps re-executed after recovery: steps the dead "
        "incarnation ran past the checkpoint it resumed from (advisory, "
        "heartbeat-lag accuracy; bounded by save_every_steps).",
    )
    worker_restarts = _Family(
        "raydp_worker_restarts_total", "counter",
        "ETL worker respawns by the cluster elastic loop, labelled by "
        "the worker that crashed (per-lineage sliding-window budget).",
    )
    host_rss = _Family(
        "raydp_host_rss_bytes", "gauge",
        "Host resident-set size per process (kind=current|peak; peak is "
        "the VmHWM watermark).",
    )
    hbm_bytes = _Family(
        "raydp_hbm_bytes", "gauge",
        "Device HBM bytes summed over the process's local jax devices "
        "(kind=used|peak).",
    )
    store_occupancy = _Family(
        "raydp_store_occupancy_bytes", "gauge",
        "Shm object-store bytes registered in this process's store "
        "(kind=current|peak).",
    )
    gauges = _Family(
        "raydp_gauge", "gauge",
        "MetricsRegistry gauges without a dedicated family, one series "
        "per (worker, name).",
    )
    mfu = _Family(
        "raydp_mfu", "gauge",
        "Model FLOPs utilization: analytical step FLOPs (HLO cost "
        "analysis) over measured step wall x device peak. Absent on "
        "backends without a known peak (CPU).",
    )
    anomalies = _Family(
        "raydp_anomalies_total", "counter",
        "Training anomaly sentinel trips (kind=nan_loss|nan_grad_norm|"
        "step_regression). NaN kinds also dump a flight-recorder bundle.",
    )
    step_hist = _Family(
        "raydp_step_seconds", "histogram",
        "Training step wall time (jitted-call dispatch; donated-buffer "
        "block makes steady-state dispatch = device step time).",
    )
    generic_hist = _Family(
        "raydp_histogram", "histogram",
        "MetricsRegistry histograms without a dedicated family, one "
        "series set per (worker, name).",
    )
    usage_total = _Family(
        "raydp_usage_total", "counter",
        "Cluster-global usage-ledger totals (kind=chip_seconds|"
        "task_seconds|shuffle_bytes|staged_bytes|fetched_bytes|"
        "hbm_byte_seconds|compile_seconds) — the job-attributed "
        "raydp_job_* families partition these by job.",
    )
    job_chip_seconds = _Family(
        "raydp_job_chip_seconds_total", "counter",
        "Accelerator seconds billed to a job: accumulated training-step "
        "wall time x local device count (see accounting.add_usage).",
    )
    job_task_seconds = _Family(
        "raydp_job_task_seconds_total", "counter",
        "Host-CPU task seconds billed to a job: ETL worker task "
        "execution time attributed via the RPC job envelope.",
    )
    job_bytes = _Family(
        "raydp_job_bytes_total", "counter",
        "Bytes moved on behalf of a job (kind=shuffle|staged|fetched).",
    )
    job_hbm_byte_seconds = _Family(
        "raydp_job_hbm_byte_seconds_total", "counter",
        "HBM residency integral billed to a job: device HBM bytes in "
        "use integrated over wall time at heartbeat cadence.",
    )
    job_compile_seconds = _Family(
        "raydp_job_compile_seconds_total", "counter",
        "XLA compile seconds billed to a job (guarded first-dispatch "
        "compiles plus jax.monitoring durations under a job scope).",
    )
    job_counter = _Family(
        "raydp_job_counter_total", "counter",
        "Job-attributed counters without a dedicated family, one "
        "series per (worker, job, name).",
    )
    sched_queue_depth = _Family(
        "raydp_sched_queue_depth", "gauge",
        "Jobs waiting in the control-plane admission queue (driver "
        "arbiter; see doc/scheduling.md).",
    )
    sched_preemptions = _Family(
        "raydp_sched_preemptions_total", "counter",
        "Scheduler-initiated preemptions by reason (reason=priority|"
        "pressure|lease_timeout).",
    )
    sched_wait = _Family(
        "raydp_sched_wait_seconds_total", "counter",
        "Cumulative admission-queue wait per job — the fairness/latency "
        "cost a tenant paid before each capacity grant.",
    )
    sched_sheds = _Family(
        "raydp_sched_sheds_total", "counter",
        "Admissions rejected with ClusterBusyError by the load-shedding "
        "cap (queue at RAYDP_TPU_SCHED_MAX_QUEUE or explicit shed mode).",
    )
    sched_wait_oldest = _Family(
        "raydp_sched_queue_wait_oldest_seconds", "gauge",
        "Age of the longest-queued admission waiter (0 when the queue "
        "is empty) — the starvation signal the autoscaler reads.",
    )
    autoscale_decisions = _Family(
        "raydp_autoscale_decisions_total", "counter",
        "Autoscaler scale actions by kind (kind=grow|shrink|binpack; "
        "doc/scheduling.md, Autoscaling).",
    )
    autoscale_pool_size = _Family(
        "raydp_autoscale_pool_size", "gauge",
        "Worker-pool size as last observed by the autoscaler loop.",
    )
    autoscale_pending = _Family(
        "raydp_autoscale_pending_spawns", "gauge",
        "Hosts requested from the provisioner but not yet confirmed up.",
    )
    autoscale_drains = _Family(
        "raydp_autoscale_drains_total", "counter",
        "Hosts drained as graceful scale-down victims.",
    )
    autoscale_spawn_failures = _Family(
        "raydp_autoscale_spawn_failures_total", "counter",
        "Provisioner spawn attempts that failed; each burns one retry "
        "from the RAYDP_TPU_AUTOSCALE_SPAWN_RETRIES budget.",
    )
    autoscale_denied = _Family(
        "raydp_autoscale_denied_total", "counter",
        "Scale decisions denied by cooldown, gang floor, or a missing "
        "victim — the anti-flap machinery holding the line.",
    )
    serve_requests = _Family(
        "raydp_serve_requests_total", "counter",
        "Requests accepted into the serving queue (doc/serving.md).",
    )
    serve_replies = _Family(
        "raydp_serve_replies_total", "counter",
        "Requests answered successfully (the exactly-one-reply "
        "invariant: replies + errors + cancellations == accepted).",
    )
    serve_errors = _Family(
        "raydp_serve_errors_total", "counter",
        "Requests completed with an error reply (model failure or "
        "deadline expiry while queued).",
    )
    serve_rejected = _Family(
        "raydp_serve_rejected_total", "counter",
        "Requests shed at admission — queue at RAYDP_TPU_SERVE_MAX_QUEUE "
        "turns into HTTP 429 with a Retry-After derived from shed ETA.",
    )
    serve_requeued = _Family(
        "raydp_serve_requeued_total", "counter",
        "In-flight requests returned to the front of the queue after a "
        "replica died mid-batch (the zero-drop failover path).",
    )
    serve_dup_replies = _Family(
        "raydp_serve_duplicate_replies_total", "counter",
        "Replica replies discarded because the request had already been "
        "answered (at-most-once delivery under failover).",
    )
    serve_restarts = _Family(
        "raydp_serve_restarts_total", "counter",
        "Replica respawns by the group's supervision loop (bounded by "
        "RAYDP_TPU_SERVE_MAX_RESTARTS per lineage).",
    )
    serve_batches = _Family(
        "raydp_serve_batches_total", "counter",
        "Batches dispatched by the continuous batcher.",
    )
    serve_batch_requests = _Family(
        "raydp_serve_batch_requests_total", "counter",
        "Requests carried inside dispatched batches (ratio against "
        "batches x max_batch is the aggregate fill fraction).",
    )
    serve_queue_depth = _Family(
        "raydp_serve_queue_depth", "gauge",
        "Requests waiting in the serving queue right now.",
    )
    serve_batch_fill = _Family(
        "raydp_serve_batch_fill", "gauge",
        "Fill fraction (size / max_batch) of the most recent batch.",
    )
    serve_replicas_alive = _Family(
        "raydp_serve_replicas_alive", "gauge",
        "Replicas currently registered and serving in the group.",
    )
    serve_rps = _Family(
        "raydp_serve_requests_per_second", "gauge",
        "Reply throughput of the serving plane since start.",
    )
    serve_latency = _Family(
        "raydp_serve_latency_seconds", "histogram",
        "End-to-end request latency (accept to reply) on the driver; "
        "cumulative log-spaced buckets, so the merged cross-replica "
        "p99 is exact (histogram_quantile on the _bucket ramp).",
    )
    serve_replica_latency = _Family(
        "raydp_serve_replica_latency_seconds", "histogram",
        "Per-replica ExecuteBatch wall time, labelled by replica index "
        "(cumulative histogram buckets).",
    )
    serve_phase = _Family(
        "raydp_serve_phase_seconds", "histogram",
        "Per-request latency provenance, labelled by phase: "
        "queue_wait, linger, execute, reply (the four sum to the "
        "end-to-end wall) plus padding_waste (the pad-row slice "
        "inside execute).",
    )
    loadgen_fired = _Family(
        "raydp_loadgen_fired_total", "counter",
        "Requests fired by the open-loop load runner (offered load, "
        "counted at the timer wheel — backend stalls never slow it).",
    )
    loadgen_requests = _Family(
        "raydp_loadgen_requests_total", "counter",
        "Load-runner terminal outcomes by status "
        "(ok|shed|timeout|error|overload).",
    )
    loadgen_offered_rps = _Family(
        "raydp_loadgen_offered_rps", "gauge",
        "Offered request rate of the most recent load-runner schedule.",
    )
    loadgen_achieved_rps = _Family(
        "raydp_loadgen_achieved_rps", "gauge",
        "Achieved (status=ok) rate of the most recent load-runner "
        "schedule.",
    )
    loadgen_knee_rps = _Family(
        "raydp_loadgen_knee_rps", "gauge",
        "Capacity knee from the most recent stepped-ramp sweep: the "
        "highest offered RPS that held the SLO (load/knee event "
        "carries the full verdict).",
    )
    events_dropped = _Family(
        "raydp_events_dropped_total", "counter",
        "Timeline events evicted from the bounded RAYDP_TPU_EVENT_BUFFER "
        "ring before anything read them (same operability treatment as "
        "raydp_spans_dropped_total).",
    )
    slo_status = _Family(
        "raydp_slo_status", "gauge",
        "SLO objective state: 1 while breached, 0 while meeting the "
        "objective (doc/telemetry.md, SLO engine).",
    )
    slo_burn = _Family(
        "raydp_slo_burn_rate", "gauge",
        "Short-window error-budget burn rate per objective (1.0 = "
        "consuming exactly the RAYDP_TPU_SLO_BUDGET).",
    )
    slo_breaches = _Family(
        "raydp_slo_breaches_total", "counter",
        "Breach episodes opened per objective (each also emits an "
        "slo/breach timeline event with auto-triage context).",
    )
    sim_requests = _Family(
        "raydp_sim_requests_total", "counter",
        "Simulator request accounting by outcome "
        "(arrivals|completed|shed) across every run_trace replay in "
        "this process (doc/simulation.md).",
    )
    sim_invariants = _Family(
        "raydp_sim_invariant_violations_total", "counter",
        "Safety-invariant violations observed by the simulation's "
        "live monitors (capacity overcommit, starvation, pool bounds, "
        "duplicate replies, conservation). Nonzero is always a bug.",
    )
    sim_pathologies = _Family(
        "raydp_sim_pathologies_total", "counter",
        "Detected pathology episodes by kind (resonance, shed_storm, "
        "priority_inversion, fragmentation) from post-run timeline "
        "scans.",
    )
    sim_replica_lifecycle = _Family(
        "raydp_sim_replica_lifecycle_total", "counter",
        "Virtual-replica fault events (event=death|respawn) from "
        "serve_kill clauses honored on virtual time.",
    )
    sim_knee = _Family(
        "raydp_sim_knee_rps", "gauge",
        "Capacity knee from the most recent virtual-time sweep "
        "(sim_knee): the sim-side twin of raydp_loadgen_knee_rps.",
    )
    sim_events_rate = _Family(
        "raydp_sim_events_per_second", "gauge",
        "Simulator throughput: virtual events processed per wall "
        "second in the most recent replay.",
    )
    decode_rounds = _Family(
        "raydp_decode_rounds_total", "counter",
        "Decode scheduler rounds executed (one jitted decode step over "
        "the live batch per round; doc/serving.md, autoregressive "
        "decode).",
    )
    decode_prefills = _Family(
        "raydp_decode_prefills_total", "counter",
        "Sequences admitted into KV slots (each admission runs one "
        "prefill and produces the first token).",
    )
    decode_tokens = _Family(
        "raydp_decode_tokens_total", "counter",
        "Output tokens produced by the decode rounds (prefill first "
        "tokens included).",
    )
    decode_retired = _Family(
        "raydp_decode_retired_total", "counter",
        "Sequences retired from the decode batch by reason "
        "(eos|length|timeout|cancel|evict).",
    )
    decode_evictions = _Family(
        "raydp_decode_evictions_total", "counter",
        "Sequences evicted from their KV slot under page pressure — "
        "recompute preemption: the sequence re-enters the queue as a "
        "prefill of its generated-so-far context.",
    )
    decode_dup_tokens = _Family(
        "raydp_decode_duplicate_tokens_total", "counter",
        "Token events discarded by the driver's global-index dedup "
        "(at-most-once streams under replica failover).",
    )
    decode_requeued = _Family(
        "raydp_decode_requeued_prefills_total", "counter",
        "In-flight decode sequences returned to the queue as prefills "
        "after their replica died (the zero-drop failover path at "
        "token granularity).",
    )
    decode_batch_occupancy = _Family(
        "raydp_decode_batch_occupancy", "gauge",
        "Live sequences in the decode batch after the most recent "
        "round (out of RAYDP_TPU_DECODE_SLOTS).",
    )
    decode_page_fill = _Family(
        "raydp_decode_page_fill", "gauge",
        "Fraction of the KV page budget currently allocated to live "
        "slots.",
    )
    decode_kv_bucket = _Family(
        "raydp_decode_kv_bucket", "gauge",
        "KV cache-length bucket the most recent decode round compiled "
        "for (tightest power-of-two page multiple covering the "
        "longest live sequence).",
    )
    decode_pending = _Family(
        "raydp_decode_pending", "gauge",
        "Admitted sequences waiting for a free KV slot on the "
        "replica.",
    )
    decode_tps = _Family(
        "raydp_decode_tokens_per_second", "gauge",
        "Output-token throughput of the decode plane since start.",
    )
    decode_ttft = _Family(
        "raydp_decode_ttft_seconds", "histogram",
        "Time to first token: driver accept to first streamed token "
        "(cumulative log-spaced buckets).",
    )
    decode_tpot = _Family(
        "raydp_decode_tpot_seconds", "histogram",
        "Per-output-token latency after the first token "
        "((wall - ttft) / (n - 1) per finished sequence).",
    )
    serve_counter_routes = {
        "serve/requests": serve_requests,
        "serve/replies": serve_replies,
        "serve/errors": serve_errors,
        "serve/rejected": serve_rejected,
        "serve/requeued": serve_requeued,
        "serve/dup_replies": serve_dup_replies,
        "serve/restarts": serve_restarts,
        "serve/batches": serve_batches,
        "serve/batch_requests": serve_batch_requests,
    }
    decode_counter_routes = {
        "decode/rounds": decode_rounds,
        "decode/prefills": decode_prefills,
        "decode/tokens": decode_tokens,
        "decode/evictions": decode_evictions,
        "decode/dup_tokens": decode_dup_tokens,
        "decode/requeued_prefills": decode_requeued,
    }

    sources: Dict[str, Dict[str, Any]] = dict(view.get("workers") or {})
    gangs = view.get("gangs") or {}
    sources.update(gangs)
    driver = view.get("driver")
    if driver:
        sources["driver"] = driver

    for worker_id in sorted(sources):
        sections = sources[worker_id]
        if worker_id != "driver" and worker_id not in gangs:
            up.add(
                {"worker": worker_id},
                0.0 if sections.get("tombstone") else 1.0,
            )
        for key in sorted(sections):
            section = sections[key]
            if key in ("tombstone", "updated_wall"):
                continue
            if key == "counters":
                for name in sorted(section):
                    if name == "spans/dropped":
                        # Span loss is an operability signal, not a
                        # workload stat: dedicated family so alerts can
                        # target it without label matching.
                        dropped.add({"worker": worker_id}, section[name])
                        continue
                    if name == "events/dropped":
                        events_dropped.add({"worker": worker_id},
                                           section[name])
                        continue
                    if name.startswith("slo/breaches/"):
                        slo_breaches.add(
                            {"worker": worker_id,
                             "objective": name[len("slo/breaches/"):]},
                            section[name],
                        )
                        continue
                    if name == "watchdog/stalls":
                        # Same operability treatment as span loss: a
                        # dedicated family so "any rank stalled" is one
                        # alert expression.
                        stalls.add({"worker": worker_id}, section[name])
                        continue
                    if name == "rpc/payload_bytes":
                        # Control-plane hygiene signal (see family help);
                        # dedicated so dashboards can plot it against
                        # store/remote_fetch_bytes without label tricks.
                        rpc_payload.add({"worker": worker_id}, section[name])
                        continue
                    if name == "shuffle/bytes":
                        shuffle_bytes.add({"worker": worker_id}, section[name])
                        continue
                    if name == "shuffle/local_bytes":
                        shuffle_local.add({"worker": worker_id}, section[name])
                        continue
                    if name == "shuffle/elided":
                        # Dedicated families so the dashboard's locality
                        # hit-rate and elision panels are one expression
                        # each (local/total ratio, elided rate).
                        shuffles_elided.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name == "pipeline/overlap_seconds":
                        pipeline_overlap.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name.startswith("aqe/replans/"):
                        # One series per replan rule, mirroring the
                        # aqe[<rule>] plan annotations one-for-one.
                        aqe_replans.add(
                            {"worker": worker_id,
                             "rule": name[len("aqe/replans/"):]},
                            section[name],
                        )
                        continue
                    if name == "aqe/coalesced_partitions":
                        aqe_coalesced.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name == "aqe/salted_keys":
                        aqe_salted.add({"worker": worker_id}, section[name])
                        continue
                    if name == "aqe/bytes_saved":
                        aqe_bytes_saved.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name.startswith("stage/"):
                        # Per-stage runtime stats recorded by the
                        # DataFrame executors: stage/<kind>/<op label>.
                        _, kind, op = name.split("/", 2)
                        if kind in ("rows_in", "rows_out"):
                            stage_rows.add(
                                {"worker": worker_id, "op": op,
                                 "direction": kind[5:]},
                                section[name],
                            )
                            continue
                        if kind in ("bytes_in", "bytes_out"):
                            stage_bytes.add(
                                {"worker": worker_id, "op": op,
                                 "direction": kind[6:]},
                                section[name],
                            )
                            continue
                        if kind == "seconds":
                            stage_seconds.add(
                                {"worker": worker_id, "op": op},
                                section[name],
                            )
                            continue
                    if name.startswith("anomalies/"):
                        anomalies.add(
                            {"worker": worker_id,
                             "kind": name[len("anomalies/"):]},
                            section[name],
                        )
                        continue
                    if name == "restarts/total":
                        restarts.add({"worker": worker_id}, section[name])
                        continue
                    if name == "preemptions/total":
                        preemptions.add({"worker": worker_id}, section[name])
                        continue
                    if name == "replay/steps":
                        replay_steps.add({"worker": worker_id}, section[name])
                        continue
                    if name.startswith("worker_restarts/"):
                        # The label is the CRASHED worker; the series
                        # source is the supervising driver process.
                        worker_restarts.add(
                            {"worker": name[len("worker_restarts/"):]},
                            section[name],
                        )
                        continue
                    if name.startswith("usage/"):
                        usage_total.add(
                            {"worker": worker_id,
                             "kind": name[len("usage/"):]},
                            section[name],
                        )
                        continue
                    if name.startswith("job/"):
                        # Per-job ledger counters: job/<job_id>/<kind>.
                        job_id, sep, kind = (
                            name[len("job/"):].partition("/")
                        )
                        if sep:
                            labels = {"worker": worker_id, "job": job_id}
                            if kind == "chip_seconds":
                                job_chip_seconds.add(labels, section[name])
                            elif kind == "task_seconds":
                                job_task_seconds.add(labels, section[name])
                            elif kind in ("shuffle_bytes", "staged_bytes",
                                          "fetched_bytes"):
                                job_bytes.add(
                                    {**labels,
                                     "kind": kind[:-len("_bytes")]},
                                    section[name],
                                )
                            elif kind == "hbm_byte_seconds":
                                job_hbm_byte_seconds.add(
                                    labels, section[name]
                                )
                            elif kind == "compile_seconds":
                                job_compile_seconds.add(
                                    labels, section[name]
                                )
                            else:
                                job_counter.add(
                                    {**labels, "name": kind},
                                    section[name],
                                )
                            continue
                    if name == "compile/count":
                        compiles.add({"worker": worker_id}, section[name])
                        continue
                    if name == "compile/seconds":
                        compile_seconds.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name == "compile/failures":
                        compile_failures.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name.startswith("sched/preemptions/"):
                        sched_preemptions.add(
                            {"worker": worker_id,
                             "reason": name[len("sched/preemptions/"):]},
                            section[name],
                        )
                        continue
                    if name.startswith("sched/wait/"):
                        sched_wait.add(
                            {"worker": worker_id,
                             "job": name[len("sched/wait/"):]},
                            section[name],
                        )
                        continue
                    if name == "sched/sheds":
                        sched_sheds.add({"worker": worker_id}, section[name])
                        continue
                    if name.startswith("autoscale/decisions/"):
                        autoscale_decisions.add(
                            {"worker": worker_id,
                             "kind": name[len("autoscale/decisions/"):]},
                            section[name],
                        )
                        continue
                    if name == "autoscale/drains":
                        autoscale_drains.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name == "autoscale/spawn_failed":
                        autoscale_spawn_failures.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name == "autoscale/denied":
                        autoscale_denied.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name in ("serve/requests", "serve/replies",
                                "serve/errors", "serve/rejected",
                                "serve/requeued", "serve/dup_replies",
                                "serve/restarts", "serve/batches",
                                "serve/batch_requests"):
                        serve_counter_routes[name].add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name in ("decode/rounds", "decode/prefills",
                                "decode/tokens", "decode/evictions",
                                "decode/dup_tokens",
                                "decode/requeued_prefills"):
                        decode_counter_routes[name].add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name.startswith("decode/retired/"):
                        decode_retired.add(
                            {"worker": worker_id,
                             "reason": name[len("decode/retired/"):]},
                            section[name],
                        )
                        continue
                    if name == "loadgen/fired":
                        loadgen_fired.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name in ("sim/arrivals", "sim/completed",
                                "sim/shed"):
                        sim_requests.add(
                            {"worker": worker_id,
                             "outcome": name[len("sim/"):]},
                            section[name],
                        )
                        continue
                    if name == "sim/invariant_violations":
                        sim_invariants.add(
                            {"worker": worker_id}, section[name]
                        )
                        continue
                    if name.startswith("sim/pathologies/"):
                        sim_pathologies.add(
                            {"worker": worker_id,
                             "kind": name[len("sim/pathologies/"):]},
                            section[name],
                        )
                        continue
                    if name in ("sim/replica_deaths",
                                "sim/replica_respawns"):
                        sim_replica_lifecycle.add(
                            {"worker": worker_id,
                             "event": ("death" if name.endswith("deaths")
                                       else "respawn")},
                            section[name],
                        )
                        continue
                    if name.startswith("loadgen/status/"):
                        loadgen_requests.add(
                            {"worker": worker_id,
                             "status": name[len("loadgen/status/"):]},
                            section[name],
                        )
                        continue
                    counters.add(
                        {"worker": worker_id, "name": name}, section[name]
                    )
            elif key == "gauges":
                for name in sorted(section):
                    value = section[name]
                    if name in ("mem/rss_bytes", "mem/rss_peak_bytes"):
                        host_rss.add(
                            {"worker": worker_id,
                             "kind": "peak" if "peak" in name
                             else "current"},
                            value,
                        )
                    elif name in ("hbm/used_bytes", "hbm/peak_bytes"):
                        hbm_bytes.add(
                            {"worker": worker_id,
                             "kind": "peak" if "peak" in name else "used"},
                            value,
                        )
                    elif name in ("store/occupancy_bytes",
                                  "store/occupancy_peak_bytes"):
                        store_occupancy.add(
                            {"worker": worker_id,
                             "kind": "peak" if "peak" in name
                             else "current"},
                            value,
                        )
                    elif name == "sched/queue_depth":
                        sched_queue_depth.add({"worker": worker_id}, value)
                    elif name == "sched/queue_wait_oldest":
                        sched_wait_oldest.add({"worker": worker_id}, value)
                    elif name == "autoscale/pool_size":
                        autoscale_pool_size.add({"worker": worker_id}, value)
                    elif name == "autoscale/pending_spawns":
                        autoscale_pending.add({"worker": worker_id}, value)
                    elif name == "decode/batch_occupancy":
                        decode_batch_occupancy.add(
                            {"worker": worker_id}, value
                        )
                    elif name == "decode/page_fill":
                        decode_page_fill.add({"worker": worker_id}, value)
                    elif name == "decode/kv_bucket":
                        decode_kv_bucket.add({"worker": worker_id}, value)
                    elif name == "decode/pending":
                        decode_pending.add({"worker": worker_id}, value)
                    elif name == "serve/queue_depth":
                        serve_queue_depth.add({"worker": worker_id}, value)
                    elif name == "serve/batch_fill":
                        serve_batch_fill.add({"worker": worker_id}, value)
                    elif name == "serve/replicas_alive":
                        serve_replicas_alive.add({"worker": worker_id}, value)
                    elif name == "loadgen/offered_rps":
                        loadgen_offered_rps.add({"worker": worker_id}, value)
                    elif name == "loadgen/achieved_rps":
                        loadgen_achieved_rps.add({"worker": worker_id}, value)
                    elif name == "loadgen/knee_rps":
                        loadgen_knee_rps.add({"worker": worker_id}, value)
                    elif name == "sim/knee_rps":
                        sim_knee.add({"worker": worker_id}, value)
                    elif name == "sim/events_per_s":
                        sim_events_rate.add({"worker": worker_id}, value)
                    elif name == "mfu":
                        mfu.add({"worker": worker_id}, value)
                    elif name.startswith("slo/status/"):
                        slo_status.add(
                            {"worker": worker_id,
                             "objective": name[len("slo/status/"):]},
                            value,
                        )
                    elif name.startswith("slo/burn/"):
                        slo_burn.add(
                            {"worker": worker_id,
                             "objective": name[len("slo/burn/"):]},
                            value,
                        )
                    else:
                        gauges.add(
                            {"worker": worker_id, "name": name}, value
                        )
            elif key.startswith("meter/"):
                mname = key[len("meter/"):]
                labels = {"worker": worker_id, "name": mname}
                meter_total.add(labels, section.get("total", 0.0))
                meter_rate.add(labels, section.get("per_sec", 0.0))
                if mname == "serve/throughput":
                    # The serving plane's headline rate also gets its own
                    # family so dashboards don't need label matching.
                    serve_rps.add(
                        {"worker": worker_id}, section.get("per_sec", 0.0)
                    )
                elif mname == "decode/throughput":
                    decode_tps.add(
                        {"worker": worker_id}, section.get("per_sec", 0.0)
                    )
            elif key.startswith("timer/"):
                tname = key[len("timer/"):]
                family = timers
                labels = {"worker": worker_id, "name": tname}
                for q, stat in (("0.5", "p50_s"), ("0.9", "p90_s"),
                                ("0.99", "p99_s")):
                    family.add(
                        {**labels, "quantile": q}, section.get(stat, 0.0)
                    )
                family.add(labels, section.get("total_s", 0.0), suffix="_sum")
                family.add(labels, section.get("count", 0.0), suffix="_count")
            elif key.startswith("hist/"):
                name = key[len("hist/"):]
                if name == "train/step_seconds":
                    family, labels = step_hist, {"worker": worker_id}
                elif name == "serve/latency":
                    family, labels = serve_latency, {"worker": worker_id}
                elif name.startswith("serve/replica/"):
                    family = serve_replica_latency
                    labels = {
                        "worker": worker_id,
                        "replica":
                            name[len("serve/replica/"):].split("/", 1)[0],
                    }
                elif name.startswith("serve/phase/"):
                    family = serve_phase
                    labels = {
                        "worker": worker_id,
                        "phase": name[len("serve/phase/"):],
                    }
                elif name == "decode/ttft":
                    family, labels = decode_ttft, {"worker": worker_id}
                elif name == "decode/tpot":
                    family, labels = decode_tpot, {"worker": worker_id}
                else:
                    family = generic_hist
                    labels = {"worker": worker_id, "name": name}
                buckets = section.get("buckets") or {}
                # Registry summaries store cumulative counts keyed by
                # upper bound; exposition order must be ascending with
                # +Inf last (Prometheus requires the _bucket ramp).
                finite = sorted(
                    (b for b in buckets if b != "+Inf"), key=float
                )
                for bound in finite:
                    family.add(
                        {**labels, "le": bound}, buckets[bound],
                        suffix="_bucket",
                    )
                family.add(
                    {**labels, "le": "+Inf"},
                    buckets.get("+Inf", section.get("count", 0.0)),
                    suffix="_bucket",
                )
                family.add(labels, section.get("sum", 0.0), suffix="_sum")
                family.add(labels, section.get("count", 0.0),
                           suffix="_count")

    lines: List[str] = []
    for family in (up, counters, meter_total, meter_rate, timers, dropped,
                   stalls, rpc_payload, shuffle_bytes, shuffle_local,
                   shuffles_elided, pipeline_overlap,
                   aqe_replans, aqe_coalesced, aqe_salted, aqe_bytes_saved,
                   stage_rows, stage_bytes, stage_seconds,
                   compiles, compile_seconds, compile_failures,
                   restarts, preemptions, replay_steps, worker_restarts,
                   usage_total, job_chip_seconds, job_task_seconds,
                   job_bytes, job_hbm_byte_seconds, job_compile_seconds,
                   job_counter,
                   sched_queue_depth, sched_preemptions, sched_wait,
                   sched_sheds, sched_wait_oldest,
                   autoscale_decisions, autoscale_pool_size,
                   autoscale_pending, autoscale_drains,
                   autoscale_spawn_failures, autoscale_denied,
                   serve_requests, serve_replies, serve_errors,
                   serve_rejected, serve_requeued, serve_dup_replies,
                   serve_restarts, serve_batches, serve_batch_requests,
                   serve_queue_depth, serve_batch_fill,
                   serve_replicas_alive, serve_rps, serve_latency,
                   serve_replica_latency, serve_phase,
                   decode_rounds, decode_prefills, decode_tokens,
                   decode_retired, decode_evictions, decode_dup_tokens,
                   decode_requeued, decode_batch_occupancy,
                   decode_page_fill, decode_kv_bucket, decode_pending,
                   decode_tps, decode_ttft, decode_tpot,
                   loadgen_fired, loadgen_requests, loadgen_offered_rps,
                   loadgen_achieved_rps, loadgen_knee_rps,
                   events_dropped, slo_status, slo_burn, slo_breaches,
                   host_rss,
                   hbm_bytes, store_occupancy, mfu, anomalies, step_hist,
                   generic_hist, gauges):
        lines.extend(family.render())
    return "\n".join(lines) + ("\n" if lines else "")


# -- scrape endpoint ----------------------------------------------------


class _ScrapeServer:
    """Handle to a running :func:`serve_prometheus` endpoint."""

    def __init__(self, httpd, thread):
        self._httpd = httpd
        self._thread = thread
        self._closed = False
        self._close_mu = threading.Lock()
        self.port = httpd.server_address[1]

    def close(self) -> None:
        # Idempotent: both Cluster.shutdown() and atexit paths may call
        # this, and http.server raises on double server_close().
        with self._close_mu:
            if self._closed:
                return
            self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


def _default_health() -> Dict[str, Any]:
    from raydp_tpu_torch.telemetry import watchdog as _watchdog

    return _watchdog.health()


def _debug_state(health: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    from raydp_tpu_torch.telemetry import flight_recorder as _flight
    from raydp_tpu_torch.utils.profiling import metrics as _metrics

    return {
        "pid": os.getpid(),
        "wall_time": time.time(),
        "component": _flight.installed_component(),
        "health": health(),
        "flight": _flight.recorder.tail(100),
        "metrics": _metrics.snapshot(),
    }


def _default_progress() -> Dict[str, Any]:
    from raydp_tpu_torch.telemetry.progress import progress as _progress
    from raydp_tpu_torch.telemetry.progress import stage_store as _stage_store

    report = _progress.report()
    report["stage_totals"] = _stage_store.snapshot()["totals"]
    return report


def _default_events(job: Optional[str] = None) -> Dict[str, Any]:
    """Timeline for ``/debug/events``: every events-*.jsonl shard under
    the telemetry dir when one is configured (so the driver endpoint
    shows worker events too), else this process's in-memory ring."""
    from raydp_tpu_torch.telemetry import events as _events

    records = _events.load_event_records(telemetry_dir(), job=job)
    return {"events": records, "mttr": _events.mttr_report(records)}


def _default_dashboard() -> Dict[str, Any]:
    """``/debug/dashboard`` over this process's registry; driver
    endpoints pass ``Cluster.dashboard_report`` (imported lazily: the
    dashboard pulls in the event and accounting stack)."""
    from raydp_tpu_torch.telemetry import dashboard as _dash

    return _dash.local_dashboard()


# /debug/profile capture windows are clamped, so a stray ?seconds=86400
# cannot pin a handler thread (and a profiler's buffers) for a day.
_PROFILE_MAX_SECONDS = 120.0


def _default_profile(seconds: float) -> Dict[str, Any]:
    """One process's capture: a ``torch.profiler`` trace of THIS process
    for ``seconds``, written under the telemetry dir (or a temporary
    one). Driver endpoints pass the cluster-wide capture instead."""
    from raydp_tpu_torch.telemetry import device_profiler as _devprof

    base = telemetry_dir()
    out_dir = None
    if base:
        out_dir = os.path.join(
            base, f"profile-{os.getpid()}-{int(time.time())}"
        )
    return _devprof.capture_local_trace(seconds, out_dir)


def serve_prometheus(
    render: Callable[[], str],
    port: int,
    host: str = "0.0.0.0",
    health: Optional[Callable[[], Dict[str, Any]]] = None,
    progress: Optional[Callable[[], Dict[str, Any]]] = None,
    profile: Optional[Callable[[float], Dict[str, Any]]] = None,
    events: Optional[Callable[[Optional[str]], Dict[str, Any]]] = None,
    dashboard: Optional[Callable[[], Dict[str, Any]]] = None,
) -> _ScrapeServer:
    """Serve the process debug surface on a daemon thread.

    Routes: ``/metrics`` (``render()`` exposition text — the scrape
    target the k8s manifests annotate), ``/livez`` (always 200 while
    the process can answer HTTP at all — the k8s *liveness* target;
    stall state must not feed liveness, because a stalled op may be a
    healthy long compile/epoch and kubelet would kill a working pod),
    ``/healthz`` (JSON from ``health()`` — default: the local watchdog
    — with status 503 when unhealthy, the k8s *readiness* target),
    ``/debug/state`` (health + flight-recorder tail + metrics
    snapshot), ``/debug/stacks`` (plain-text all-thread dump),
    ``/debug/progress`` (JSON from ``progress()`` — default: the
    process's live :mod:`~raydp_tpu_torch.telemetry.progress` tracker plus
    stage-store totals), ``/debug/profile?seconds=N`` (an on-demand
    trace: ``profile(seconds)`` — default this process's
    ``torch.profiler`` capture; the driver endpoint passes
    ``Cluster.capture_profile``; it holds the request for the window,
    other routes stay responsive), ``/debug/events?job=ID`` (the cluster
    event timeline + MTTR report from ``events()`` — default: every
    events shard under the telemetry dir, else the local ring), and
    ``/debug/dashboard`` (the dashboard JSON from ``dashboard()`` —
    default this process's registry; the driver passes
    ``Cluster.dashboard_report``).
    Stdlib ``http.server`` only: one scrape every few seconds, no need
    for more. ``port=0`` binds an ephemeral port. Returns a handle with
    ``.port`` and idempotent ``.close()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    health_fn = health if health is not None else _default_health
    progress_fn = progress if progress is not None else _default_progress
    profile_fn = profile if profile is not None else _default_profile
    events_fn = events if events is not None else _default_events
    dashboard_fn = dashboard if dashboard is not None else _default_dashboard

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - http.server API
            from urllib.parse import parse_qs, urlsplit

            parts = urlsplit(self.path)
            path, query = parts.path, parse_qs(parts.query)
            try:
                if path in ("/metrics", "/"):
                    self._reply(
                        200, render().encode("utf-8"),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/livez":
                    # Pure responsiveness: reaching this line IS the
                    # check. No watchdog state — liveness restarts must
                    # target wedged processes, not slow-but-healthy ops.
                    self._reply(
                        200,
                        json.dumps(
                            {"alive": True, "pid": os.getpid()}
                        ).encode("utf-8"),
                        "application/json",
                    )
                elif path == "/healthz":
                    state = health_fn()
                    code = 200 if state.get("healthy", True) else 503
                    self._reply(
                        code,
                        json.dumps(state, default=str).encode("utf-8"),
                        "application/json",
                    )
                elif path == "/debug/state":
                    self._reply(
                        200,
                        json.dumps(
                            _debug_state(health_fn), default=str
                        ).encode("utf-8"),
                        "application/json",
                    )
                elif path == "/debug/progress":
                    self._reply(
                        200,
                        json.dumps(
                            progress_fn(), default=str
                        ).encode("utf-8"),
                        "application/json",
                    )
                elif path == "/debug/events":
                    job = (query.get("job") or [None])[0]
                    self._reply(
                        200,
                        json.dumps(
                            events_fn(job), default=str
                        ).encode("utf-8"),
                        "application/json",
                    )
                elif path == "/debug/dashboard":
                    self._reply(
                        200,
                        json.dumps(
                            dashboard_fn(), default=str
                        ).encode("utf-8"),
                        "application/json",
                    )
                elif path == "/debug/profile":
                    try:
                        seconds = float(query.get("seconds", ["3"])[0])
                    except ValueError:
                        self.send_error(400, "seconds must be a number")
                        return
                    seconds = min(max(0.0, seconds), _PROFILE_MAX_SECONDS)
                    self._reply(
                        200,
                        json.dumps(
                            profile_fn(seconds), default=str
                        ).encode("utf-8"),
                        "application/json",
                    )
                elif path == "/debug/stacks":
                    from raydp_tpu_torch.telemetry import flight_recorder as _fl

                    text = "\n".join(
                        f"--- thread {label} ---\n{stack}"
                        for label, stack in _fl.all_thread_stacks().items()
                    )
                    self._reply(
                        200, text.encode("utf-8"),
                        "text/plain; charset=utf-8",
                    )
                else:
                    self.send_error(404)
            except Exception as exc:  # a route must not kill the endpoint
                try:
                    self.send_error(500, str(exc))
                except Exception:
                    pass

        def log_message(self, *args):  # silence per-scrape stderr noise
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=httpd.serve_forever, name="raydp-metrics-http", daemon=True
    )
    thread.start()
    server = _ScrapeServer(httpd, thread)
    # port=0 callers learn the ephemeral port here (and via .port).
    logger.info(
        "telemetry debug endpoint on %s:%d "
        "(/metrics /livez /healthz /debug/state /debug/stacks "
        "/debug/progress /debug/profile /debug/events /debug/dashboard)",
        host, server.port,
    )
    return server
