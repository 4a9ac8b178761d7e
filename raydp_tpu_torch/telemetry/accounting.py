"""Job-scoped usage accounting: attribute consumption to workloads.

The port's copy of ``raydp_tpu/telemetry/accounting.py``.

In the port ``chip_seconds`` are CUDA-device seconds (wall time times
the cards a process uses) and ``hbm_byte_seconds`` the CUDA memory a
gang rank holds, integrated over its heartbeats. ``compile_seconds``
are the port's compiles: kernel builds and CUDA graph captures
(``utils/profiling.run_compile``).

Everything the telemetry plane measured before this module was
*cluster-global*: two pipelines sharing one cluster (or two gangs
sharing one TPU pool) are indistinguishable in ``/metrics``. This
module adds the missing dimension — a first-class :class:`JobContext`
minted at every workload root (DataFrame materialization,
``SPMDJob.start``, ``fit_spmd``, loader epochs) and propagated exactly
like the traceparent (:mod:`~raydp_tpu_torch.telemetry.propagation`):

* **Process spawn** — ``RAYDP_TPU_JOB`` in the worker launch env;
  worker mains call :func:`adopt_env_job` next to
  ``adopt_env_context``.
* **RPC** — :class:`~raydp_tpu_torch.cluster.rpc.RpcClient` stamps the
  caller's job into the request dict as a ``job`` entry and
  :class:`~raydp_tpu_torch.cluster.rpc.RpcServer` runs handlers inside
  :func:`job_scope`, so work a worker does *on behalf of* a job is
  billed to it.
* **Thread hand-off** — capture :func:`current_job` on the submitting
  thread, wrap the worker thread's body in ``with job_scope(ctx):``.

On top of propagation sits the **usage ledger**: :func:`add_usage` is
the one sanctioned emit path for consumption metrics (chip-seconds,
task-seconds, shuffle/staged/fetched bytes, HBM-byte-seconds,
compile-seconds). It increments both the cluster-global
``usage/<kind>`` counter and — when a job is in scope — a
``job/<job_id>/<kind>`` counter. Per-job counters ride the existing
heartbeat delta-shipping unchanged, merge in the master's cluster
view, export as ``raydp_job_*`` Prometheus families, and fold into
``Cluster.usage_report()`` / ``SPMDJob.usage_report()``. raydpcheck's
R4 ``unattributed-metric`` lint keeps this the *only* emit path for
ledger kinds outside this module.

The wire format is ``"<job_id>;<name>;<priority>"`` — job ids are
sanitized to never contain ``;`` or ``/`` (they embed in metric names
as path segments). Parsing is tolerant: malformed input yields
``None``, and a ``None`` job is always a safe no-op to propagate.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional

from raydp_tpu_torch.utils.profiling import metrics as _metrics

__all__ = [
    "ACCOUNTING_ENV",
    "JOB_ENV",
    "JOB_KEY",
    "JOB_METRIC_PREFIX",
    "USAGE_KINDS",
    "JobContext",
    "current_job",
    "job_scope",
    "set_process_job",
    "process_job",
    "mint_job",
    "ensure_job",
    "to_wire",
    "from_wire",
    "inject",
    "extract",
    "env_for_child",
    "job_from_env",
    "adopt_env_job",
    "add_usage",
    "registered_jobs",
    "usage_report",
]

JOB_ENV = "RAYDP_TPU_JOB"

#: Kill switch: ``RAYDP_TPU_JOB_ACCOUNTING=0`` disables ledger billing
#: and event-timeline emits (propagation itself stays on — it is just
#: an env var and a dict key). The ``bench.py`` ``job_accounting``
#: section uses this as its off-arm; budget <5% overhead.
ACCOUNTING_ENV = "RAYDP_TPU_JOB_ACCOUNTING"


def accounting_enabled() -> bool:
    return os.environ.get(ACCOUNTING_ENV, "").strip() != "0"

#: Key carried in RPC request dicts (and SPMD run-queue items).
JOB_KEY = "job"

#: Per-job counters are named ``job/<job_id>/<kind>``.
JOB_METRIC_PREFIX = "job/"

#: Ledger kinds with dedicated ``raydp_job_*`` Prometheus families.
#: Anything else emitted through :func:`add_usage` still works — it
#: lands in the generic ``raydp_job_counter_total`` family.
CHIP_SECONDS = "chip_seconds"
TASK_SECONDS = "task_seconds"
SHUFFLE_BYTES = "shuffle_bytes"
STAGED_BYTES = "staged_bytes"
FETCHED_BYTES = "fetched_bytes"
HBM_BYTE_SECONDS = "hbm_byte_seconds"
COMPILE_SECONDS = "compile_seconds"
USAGE_KINDS = (
    CHIP_SECONDS,
    TASK_SECONDS,
    SHUFFLE_BYTES,
    STAGED_BYTES,
    FETCHED_BYTES,
    HBM_BYTE_SECONDS,
    COMPILE_SECONDS,
)


@dataclass(frozen=True)
class JobContext:
    """Identity of one workload: everything billed under one job_id.

    ``priority`` is carried but not yet consumed — it is the input the
    fair-share scheduler (ROADMAP item 2) will read."""

    job_id: str
    name: str = ""
    priority: int = 0


def _sanitize(part: str) -> str:
    # job ids embed in metric names (path segments) and in the
    # ';'-separated wire format; both separators must never appear.
    return "".join(
        ch if (ch.isalnum() or ch in "._-") else "-" for ch in str(part)
    ) or "job"


# -- ambient context ----------------------------------------------------

_tls = threading.local()
_process_job: Optional[JobContext] = None

# Driver-side metadata for jobs minted (or adopted) in this process:
# job_id -> {name, priority, started_wall}. usage_report() joins it so
# reports show human names next to raw ids.
_registry_mu = threading.Lock()
_registry: Dict[str, Dict[str, Any]] = {}


def _register(ctx: JobContext) -> None:
    with _registry_mu:
        if ctx.job_id not in _registry:
            _registry[ctx.job_id] = {
                "name": ctx.name,
                "priority": ctx.priority,
                "started_wall": time.time(),
            }


def registered_jobs() -> Dict[str, Dict[str, Any]]:
    """Metadata for every job this process has minted or adopted."""
    with _registry_mu:
        return {k: dict(v) for k, v in _registry.items()}


def current_job() -> Optional[JobContext]:
    """The job new usage on this thread would be billed to: the
    thread's :func:`job_scope` override, else the process default."""
    ctx = getattr(_tls, "job", None)
    return ctx if ctx is not None else _process_job


@contextlib.contextmanager
def job_scope(ctx: Optional[JobContext]) -> Iterator[None]:
    """``with job_scope(ctx):`` — usage emitted in the block (on this
    thread) is billed to ``ctx``. ``None`` clears any thread override
    (the process job still applies)."""
    prev = getattr(_tls, "job", None)
    _tls.job = ctx
    try:
        yield
    finally:
        _tls.job = prev


def set_process_job(ctx: Optional[JobContext]) -> None:
    """Default job for every emit with no thread override — how a
    worker process adopts the spawning driver's job for its lifetime."""
    global _process_job
    _process_job = ctx


def process_job() -> Optional[JobContext]:
    return _process_job


def mint_job(
    name: str = "job", priority: int = 0, **attrs: Any
) -> JobContext:
    """Mint a fresh job identity at a workload root.

    Records a ``job/start`` timeline event (and a root span event) so
    the job's birth is visible in ``/debug/events`` and the merged
    trace, and registers driver-side metadata for
    :func:`usage_report`."""
    name = _sanitize(name)
    ctx = JobContext(
        job_id=f"{name}-{uuid.uuid4().hex[:8]}",
        name=name,
        priority=int(priority),
    )
    _register(ctx)
    try:
        from raydp_tpu_torch.telemetry import events as _events

        _events.emit(
            "job/start", job=ctx, name=name, priority=ctx.priority, **attrs
        )
    except Exception:  # accounting must never sink the workload
        pass
    return ctx


def ensure_job(name: str = "job", priority: int = 0, **attrs: Any) -> JobContext:
    """The ambient job if one is in scope, else a freshly minted one.

    Workload roots call this so explicit user-scoped jobs win and bare
    invocations still get attributed identities."""
    ctx = current_job()
    if ctx is not None:
        return ctx
    return mint_job(name, priority, **attrs)


# -- wire format --------------------------------------------------------


def to_wire(ctx: Optional[JobContext]) -> Optional[str]:
    if ctx is None:
        return None
    return f"{ctx.job_id};{ctx.name};{ctx.priority}"


def from_wire(header: Optional[str]) -> Optional[JobContext]:
    if not header or not isinstance(header, str):
        return None
    parts = header.split(";")
    if not parts or not parts[0]:
        return None
    try:
        priority = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    except ValueError:
        priority = 0
    return JobContext(
        job_id=_sanitize(parts[0]),
        name=parts[1] if len(parts) > 1 else "",
        priority=priority,
    )


def inject(request: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Return ``request`` with the caller's job stamped in as ``job``.
    Copies rather than mutates (retry loops reuse payload dicts); an
    explicit caller-provided job wins."""
    if request is None or not isinstance(request, dict):
        return request
    if JOB_KEY in request:
        return request
    header = to_wire(current_job())
    if header is None:
        return request
    return {**request, JOB_KEY: header}


def extract(request: Any) -> Optional[JobContext]:
    if not isinstance(request, Mapping):
        return None
    ctx = from_wire(request.get(JOB_KEY))
    if ctx is not None:
        _register(ctx)
    return ctx


# -- process spawn ------------------------------------------------------


def env_for_child(ctx: Optional[JobContext] = None) -> Dict[str, str]:
    """Environment entries that hand ``ctx`` (default: the caller's
    current job) to a child process. Empty when there is nothing to
    propagate, so it is always safe to splat into a launch env."""
    header = to_wire(ctx if ctx is not None else current_job())
    return {JOB_ENV: header} if header else {}


def job_from_env(
    environ: Optional[Mapping[str, str]] = None,
) -> Optional[JobContext]:
    env = os.environ if environ is None else environ
    return from_wire(env.get(JOB_ENV))


def adopt_env_job() -> Optional[JobContext]:
    """Install the spawning process's job (if any) as this process's
    default. Worker mains call this next to ``adopt_env_context``."""
    ctx = job_from_env()
    if ctx is not None:
        set_process_job(ctx)
        _register(ctx)
    return ctx


# -- usage ledger -------------------------------------------------------


def add_usage(
    kind: str, value: float, job: Optional[JobContext] = None
) -> None:
    """Bill ``value`` of ``kind`` to the current (or given) job.

    Always increments the cluster-global ``usage/<kind>`` counter;
    when a job is in scope it also increments ``job/<job_id>/<kind>``,
    which ships on heartbeats and exports as a ``raydp_job_*`` family.
    This is the ONLY sanctioned emit path for ledger kinds outside
    this module (raydpcheck R4 ``unattributed-metric``)."""
    if not accounting_enabled():
        return
    try:
        value = float(value)
    except (TypeError, ValueError):
        return
    if value <= 0.0:
        return
    _metrics.counter_add(f"usage/{kind}", value)
    ctx = job if job is not None else current_job()
    if ctx is not None:
        _metrics.counter_add(f"job/{ctx.job_id}/{kind}", value)


def _fold_counters(
    jobs: Dict[str, Dict[str, float]], counters: Mapping[str, Any]
) -> None:
    for name, value in counters.items():
        if not name.startswith(JOB_METRIC_PREFIX):
            continue
        rest = name[len(JOB_METRIC_PREFIX):]
        job_id, sep, kind = rest.partition("/")
        if not sep or not job_id or not kind:
            continue
        try:
            value = float(value)
        except (TypeError, ValueError):
            continue
        jobs.setdefault(job_id, {})
        jobs[job_id][kind] = jobs[job_id].get(kind, 0.0) + value


def usage_report(view: Mapping[str, Any]) -> Dict[str, Any]:
    """Fold a merged cluster metrics view (``Cluster.metrics_snapshot()``
    shape) into per-job usage totals.

    Returns ``{"jobs": {job_id: {"name", "priority", "usage": {kind:
    total}}}, "totals": {kind: total}}`` — per-job counters summed
    across every worker section plus the driver's own registry, and
    (the port's) the finished SPMD gangs' rank views under ``gangs``."""
    jobs: Dict[str, Dict[str, float]] = {}
    sources = dict(view.get("workers") or {})
    sources.update(view.get("gangs") or {})
    driver = view.get("driver")
    if driver:
        sources["_driver"] = driver
    for sections in sources.values():
        if not isinstance(sections, Mapping):
            continue
        counters = sections.get("counters")
        if isinstance(counters, Mapping):
            _fold_counters(jobs, counters)
    meta = registered_jobs()
    totals: Dict[str, float] = {}
    report_jobs: Dict[str, Any] = {}
    for job_id in sorted(jobs):
        usage = {k: jobs[job_id][k] for k in sorted(jobs[job_id])}
        for kind, value in usage.items():
            totals[kind] = totals.get(kind, 0.0) + value
        info = meta.get(job_id, {})
        report_jobs[job_id] = {
            "name": info.get("name", job_id.rsplit("-", 1)[0]),
            "priority": info.get("priority", 0),
            "started_wall": info.get("started_wall"),
            "usage": usage,
        }
    return {"jobs": report_jobs, "totals": totals}
