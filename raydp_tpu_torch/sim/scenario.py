"""Scenario runner: real control plane, virtual cluster, one heap.

``run_trace`` wires the production components together exactly as the
serving stack does — a :class:`RequestQueue` fed by an arrival
observer, an :class:`Autoscaler` over a :class:`HostProvisioner`, the
process :class:`ClusterArbiter` for gang admission — then installs a
:class:`SimClock` behind the clock seam and replays a loadgen trace
(the same ``TraceEvent`` list / JSONL format the open-loop runner
consumes) through them on virtual time. Millions of arrivals over
thousands of hosts execute in seconds of wall clock; every decision
(linger, cooldown, preemption, shed, backoff) is made by the real
code under its real locks.

``sim_knee`` reruns the loadgen knee-finder's ramp/bisect control
flow with virtual steps, so a capacity knee for a thousand-host
deployment costs seconds instead of a cluster.

The port's copy of ``raydp_tpu/sim/scenario.py``: for the same trace
and configuration, :func:`run_trace`'s :func:`result_to_json` (wall
seconds apart), decisions and events equal the reference's.
"""
from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from raydp_tpu_torch.control import arbiter as _arbiter_mod
from raydp_tpu_torch.control.autoscaler import Autoscaler, AutoscalerConfig
from raydp_tpu_torch.loadgen.schedules import TraceEvent, poisson_schedule
from raydp_tpu_torch.serve.batching import (
    QueueFullError,
    RequestQueue,
    ServeRequest,
)
from raydp_tpu_torch.sim.cluster import (
    ReplicaPool,
    ServiceModel,
    SimProvisioner,
    SizedPayload,
)
from raydp_tpu_torch.sim.monitors import InvariantMonitor
from raydp_tpu_torch.sim.pathology import (
    PathologyKnobs,
    report_pathologies,
    scan_timeline,
)
from raydp_tpu_torch.sim.vclock import SimClock
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.telemetry.accounting import JobContext
from raydp_tpu_torch.utils import clock as _clock
from raydp_tpu_torch.utils.profiling import metrics as _metrics
from raydp_tpu_torch.utils.profiling import quantile_from_hist_summary

__all__ = ["ScenarioConfig", "GangJobSpec", "SimResult", "run_trace",
           "sim_knee"]

# Wall-clock access for result stamping, through the seam's real
# implementation (never time.monotonic() directly).
_REAL = _clock.Clock()

SIM_SERVICE_MS_ENV = "RAYDP_TPU_SIM_SERVICE_MS"
SIM_SERVICE_PER_ITEM_MS_ENV = "RAYDP_TPU_SIM_SERVICE_PER_ITEM_MS"
SIM_MONITOR_INTERVAL_ENV = "RAYDP_TPU_SIM_MONITOR_INTERVAL_S"
SIM_STARVATION_ENV = "RAYDP_TPU_SIM_STARVATION_S"
SIM_RESPAWN_ENV = "RAYDP_TPU_SIM_RESPAWN_S"
SIM_STORM_COUNT_ENV = "RAYDP_TPU_SIM_STORM_COUNT"
SIM_STORM_WINDOW_ENV = "RAYDP_TPU_SIM_STORM_WINDOW_S"
SIM_FRAG_RUN_ENV = "RAYDP_TPU_SIM_FRAG_RUN"
SIM_MAX_WALL_ENV = "RAYDP_TPU_SIM_MAX_WALL_S"

# Nested virtual waits consume interpreter stack (one pump frame per
# concurrently-blocked actor); thousand-replica scenarios need more
# headroom than the default 1000.
_RECURSION_LIMIT = 200_000


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass(frozen=True)
class GangJobSpec:
    """One simulated gang-training job driving the real arbiter:
    arrive, acquire ``slots``, hold, release; on preemption, drain for
    ``drain_s`` then release, and re-acquire when ``resume``."""

    arrive_t: float
    slots: int
    priority: int = 0
    hold_s: float = 10.0
    drain_s: float = 0.1
    resume: bool = True
    preemptible: bool = True
    admit_timeout_s: float = 60.0
    label: str = ""


@dataclass
class ScenarioConfig:
    """Everything one simulated deployment needs. Field defaults read
    the ``RAYDP_TPU_SIM_*`` env family (doc/configuration.md) so CI
    can retune detectors without code changes."""

    hosts: int = 2
    service_ms: float = field(default_factory=lambda: _env_float(
        SIM_SERVICE_MS_ENV, 12.0))
    service_per_item_ms: float = field(default_factory=lambda: _env_float(
        SIM_SERVICE_PER_ITEM_MS_ENV, 0.0))
    provision_s: float = 0.0
    respawn_s: float = field(default_factory=lambda: _env_float(
        SIM_RESPAWN_ENV, 1.0))
    # Serving queue knobs (None defers to the queue's own env family).
    max_batch: Optional[int] = 8
    slo_ms: Optional[float] = 50.0
    max_queue: Optional[int] = 256
    buckets: Optional[Sequence[int]] = None
    timeout_s: float = 5.0
    # Arbiter: capacity 0 leaves the process arbiter untouched.
    arbiter_capacity: int = 0
    arbiter_kwargs: Dict[str, Any] = field(default_factory=dict)
    jobs: Tuple[GangJobSpec, ...] = ()
    # Autoscaler (None = no autoscaler in the scenario).
    autoscaler: Optional[AutoscalerConfig] = None
    autoscale_interval_s: float = 1.0
    # Monitors and detectors.
    monitor_interval_s: float = field(default_factory=lambda: _env_float(
        SIM_MONITOR_INTERVAL_ENV, 0.5))
    starvation_s: float = field(default_factory=lambda: _env_float(
        SIM_STARVATION_ENV, 30.0))
    storm_count: int = field(default_factory=lambda: int(_env_float(
        SIM_STORM_COUNT_ENV, 50)))
    storm_window_s: float = field(default_factory=lambda: _env_float(
        SIM_STORM_WINDOW_ENV, 1.0))
    frag_run: int = field(default_factory=lambda: int(_env_float(
        SIM_FRAG_RUN_ENV, 5)))
    # Runaway guard: 0 disables.
    max_wall_s: float = field(default_factory=lambda: _env_float(
        SIM_MAX_WALL_ENV, 0.0))

    def knobs(self) -> PathologyKnobs:
        up_cd = (self.autoscaler.up_cooldown_s
                 if self.autoscaler is not None else 5.0)
        return PathologyKnobs(
            resonance_window_s=up_cd,
            storm_count=self.storm_count,
            storm_window_s=self.storm_window_s,
            frag_run=self.frag_run,
        )


@dataclass
class SimResult:
    """One replay's verdict: throughput, latency, safety, pathology."""

    arrivals: int
    admitted: int
    completed: int
    shed: int
    errors: int
    duration_s: float
    wall_s: float
    events_processed: int
    p50_ms: Optional[float]
    p99_ms: Optional[float]
    pool_size_final: int
    replica_deaths: int
    replica_respawns: int
    invariant_violations: List[Dict[str, Any]]
    pathologies: List[Dict[str, Any]]
    gangs: List[Dict[str, Any]] = field(default_factory=list)
    latencies_s: Optional[List[float]] = None

    @property
    def shed_rate(self) -> float:
        return self.shed / self.arrivals if self.arrivals else 0.0

    @property
    def events_per_s(self) -> float:
        return (self.events_processed / self.wall_s
                if self.wall_s > 0 else 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arrivals": self.arrivals,
            "admitted": self.admitted,
            "completed": self.completed,
            "shed": self.shed,
            "errors": self.errors,
            "shed_rate": round(self.shed_rate, 4),
            "duration_s": round(self.duration_s, 3),
            "wall_s": round(self.wall_s, 3),
            "events_processed": self.events_processed,
            "events_per_s": round(self.events_per_s, 1),
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "pool_size_final": self.pool_size_final,
            "replica_deaths": self.replica_deaths,
            "replica_respawns": self.replica_respawns,
            "invariant_violations": self.invariant_violations,
            "pathologies": self.pathologies,
            "gangs": self.gangs,
        }


class _OutcomeTracker:
    """Exact per-request latencies (knee steps need real quantiles,
    not bucket-interpolated ones); off by default — a million floats
    is a cost large replays should not pay."""

    __slots__ = ("latencies",)

    def __init__(self) -> None:
        self.latencies: List[float] = []

    def on_complete(self, req: Any, now: float) -> None:
        self.latencies.append(now - req.enqueued_mono)


class _ServeGroupProxy:
    """The shape ``Autoscaler.register_serve_group`` needs: an object
    with a ``.queue``."""

    __slots__ = ("queue",)

    def __init__(self, queue: RequestQueue):
        self.queue = queue


class _GangActor:
    """Drives one :class:`GangJobSpec` against the real arbiter."""

    def __init__(self, sim: SimClock, arbiter: Any, spec: GangJobSpec,
                 index: int):
        self.sim = sim
        self.arbiter = arbiter
        self.spec = spec
        self.job = JobContext(
            job_id=f"sim-gang-{index}",
            name=spec.label or f"gang{index}",
            priority=spec.priority,
        )
        self.lease: Optional[Any] = None
        self.admits = 0
        self.sheds = 0
        self.preempts = 0
        self.completions = 0
        sim.at(spec.arrive_t, self._start)

    def _start(self) -> None:
        try:
            lease = self.arbiter.acquire(
                job=self.job,
                slots=self.spec.slots,
                kind="gang",
                label=self.spec.label,
                timeout=self.spec.admit_timeout_s,
                preemptible=self.spec.preemptible,
                on_preempt=self._on_preempt,
            )
        except _arbiter_mod.ClusterBusyError:
            self.sheds += 1
            return
        self.lease = lease
        self.admits += 1
        self.sim.after(self.spec.hold_s, self._finish, lease)

    def _on_preempt(self) -> None:
        self.preempts += 1
        self.sim.after(self.spec.drain_s, self._drain_release)

    def _drain_release(self) -> None:
        lease, self.lease = self.lease, None
        if lease is not None and lease.active:
            lease.release("drained")
        if self.spec.resume:
            self.sim.at(self.sim.monotonic(), self._start)

    def _finish(self, lease: Any) -> None:
        if lease is not self.lease:
            return  # preempted and drained (and possibly resumed) already
        self.lease = None
        if lease.active:
            lease.release()
            self.completions += 1

    def summary(self) -> Dict[str, Any]:
        return {
            "job": self.job.job_id,
            "label": self.spec.label,
            "priority": self.spec.priority,
            "slots": self.spec.slots,
            "admits": self.admits,
            "sheds": self.sheds,
            "preempts": self.preempts,
            "completions": self.completions,
        }


def _counters_delta(before: Dict[str, float], after: Dict[str, float],
                    name: str) -> float:
    return after.get(name, 0.0) - before.get(name, 0.0)


def _hist_delta(before: Dict[str, Any], after: Dict[str, Any],
                name: str) -> Optional[Dict[str, Any]]:
    """Cumulative-histogram subtraction: the run's own latency
    distribution even when the process histogram already has history."""
    a = after.get(f"hist/{name}")
    if not a:
        return None
    b = before.get(f"hist/{name}") or {"sum": 0.0, "count": 0.0,
                                       "buckets": {}}
    b_buckets = b.get("buckets", {})
    return {
        "sum": a["sum"] - b.get("sum", 0.0),
        "count": a["count"] - b.get("count", 0.0),
        "buckets": {
            le: c - float(b_buckets.get(le, 0.0))
            for le, c in a["buckets"].items()
        },
    }


def run_trace(events: Sequence[TraceEvent],
              config: Optional[ScenarioConfig] = None,
              record_outcomes: bool = False) -> SimResult:
    """Replay ``events`` through the real control plane on a virtual
    clock and return the :class:`SimResult` — counts from the metrics
    registry's deltas (the same counters production increments),
    invariant violations from the live monitor, pathologies from the
    post-run timeline scan."""
    cfg = config or ScenarioConfig()
    events = sorted(events, key=lambda e: e.t)
    sim = SimClock(max_wall_s=cfg.max_wall_s)
    tracker = _OutcomeTracker() if record_outcomes else None
    timeline: List[Tuple[float, str, Dict[str, Any]]] = []

    before = _metrics.snapshot()
    old_recursion = sys.getrecursionlimit()
    if old_recursion < _RECURSION_LIMIT:
        sys.setrecursionlimit(_RECURSION_LIMIT)
    orig_emit = _events.emit

    def tap(kind: str, job: Any = None, **attrs: Any) -> Dict[str, Any]:
        timeline.append((sim.monotonic(), kind, attrs))
        return orig_emit(kind, job=job, **attrs)

    wall0 = _REAL.monotonic()
    _clock.install(sim)
    configured_arbiter = False
    try:
        _events.emit = tap

        queue = RequestQueue(
            max_depth=cfg.max_queue, slo_ms=cfg.slo_ms,
            max_batch=cfg.max_batch, buckets=cfg.buckets,
        )
        service = ServiceModel(
            base_s=cfg.service_ms / 1000.0,
            per_item_s=cfg.service_per_item_ms / 1000.0,
        )
        pool = ReplicaPool(sim, queue, service, respawn_s=cfg.respawn_s,
                           tracker=tracker)
        provisioner = SimProvisioner(pool, initial=cfg.hosts,
                                     provision_s=cfg.provision_s)

        arbiter = None
        if cfg.arbiter_capacity > 0:
            arbiter = _arbiter_mod.configure(
                cfg.arbiter_capacity, **dict(cfg.arbiter_kwargs)
            )
            configured_arbiter = True

        autoscaler = None
        if cfg.autoscaler is not None:
            autoscaler = Autoscaler(provisioner, cfg.autoscaler)
            autoscaler.register_serve_group(_ServeGroupProxy(queue))

        last_t = events[-1].t if events else 0.0
        end_t = last_t + cfg.timeout_s + 1.0

        monitor = InvariantMonitor(
            sim, interval_s=cfg.monitor_interval_s, arbiter=arbiter,
            autoscaler=autoscaler, provisioner=provisioner,
            starvation_s=cfg.starvation_s,
        )
        monitor.install(end_t)

        if autoscaler is not None:
            # The loop thread becomes pre-scheduled tick events; the
            # busy guard mirrors the real single loop thread (a step
            # blocked in spawn backoff must not re-enter itself when
            # its own pump reaches the next tick).
            stepping = [False]

            def _autoscaler_tick() -> None:
                if stepping[0]:
                    return
                stepping[0] = True
                try:
                    autoscaler.step()
                finally:
                    stepping[0] = False

            t = cfg.autoscale_interval_s
            while t <= end_t:
                sim.at(t, _autoscaler_tick)
                t += cfg.autoscale_interval_s

        actors = [
            _GangActor(sim, arbiter, spec, i)
            for i, spec in enumerate(cfg.jobs)
        ] if arbiter is not None else []

        shed_local = [0]

        def _feed(i: int) -> None:
            ev = events[i]
            if i + 1 < len(events):
                sim.at(events[i + 1].t, _feed, i + 1)
            req = ServeRequest(
                SizedPayload(ev.size), timeout_s=cfg.timeout_s,
                request_id=f"r{i}",
            )
            try:
                queue.submit(req)
            except QueueFullError:
                shed_local[0] += 1

        if events:
            sim.at(events[0].t, _feed, 0)

        sim.run(until=end_t)
        queue.close()
        sim.run()  # drain in-flight completions past the horizon

        after = _metrics.snapshot()
        a_c = after.get("counters", {})
        b_c = before.get("counters", {})
        admitted = int(_counters_delta(b_c, a_c, "serve/requests"))
        rejected = int(_counters_delta(b_c, a_c, "serve/rejected"))
        replies = int(_counters_delta(b_c, a_c, "serve/replies"))
        errors = int(_counters_delta(b_c, a_c, "serve/errors"))
        monitor.check_conservation(
            arrivals=len(events), admitted=admitted, shed=rejected,
            replies=replies, errors=errors,
        )

        pathologies = scan_timeline(timeline, monitor.samples,
                                    cfg.knobs())
        report_pathologies(pathologies)

        _metrics.counter_add("sim/arrivals", float(len(events)))
        _metrics.counter_add("sim/completed", float(replies))
        _metrics.counter_add("sim/shed", float(rejected))

        if tracker is not None and tracker.latencies:
            lat = sorted(tracker.latencies)
            p50 = lat[int(0.50 * (len(lat) - 1))]
            p99 = lat[int(0.99 * (len(lat) - 1))]
        else:
            hist = _hist_delta(before, after, "serve/latency")
            p50 = (quantile_from_hist_summary(hist, 0.50)
                   if hist else None)
            p99 = (quantile_from_hist_summary(hist, 0.99)
                   if hist else None)

        wall_s = _REAL.monotonic() - wall0
        _metrics.gauge_set("sim/events_per_s",
                           sim.events_processed / max(wall_s, 1e-9))
        result = SimResult(
            arrivals=len(events),
            admitted=admitted,
            completed=replies,
            shed=rejected,
            errors=errors,
            duration_s=sim.monotonic(),
            wall_s=wall_s,
            events_processed=sim.events_processed,
            p50_ms=round(p50 * 1000.0, 3) if p50 is not None else None,
            p99_ms=round(p99 * 1000.0, 3) if p99 is not None else None,
            pool_size_final=len(provisioner.hosts()),
            replica_deaths=int(
                _counters_delta(b_c, a_c, "sim/replica_deaths")
            ),
            replica_respawns=int(
                _counters_delta(b_c, a_c, "sim/replica_respawns")
            ),
            invariant_violations=[
                v.to_dict() for v in monitor.violations
            ],
            pathologies=[p.to_dict() for p in pathologies],
            gangs=[a.summary() for a in actors],
            latencies_s=(tracker.latencies if tracker is not None
                         else None),
        )
        _events.emit(
            "sim/run", arrivals=result.arrivals,
            completed=result.completed, shed=result.shed,
            duration_s=round(result.duration_s, 3),
            wall_s=round(result.wall_s, 3),
            events_per_s=round(result.events_per_s, 1),
            violations=len(result.invariant_violations),
            pathologies=len(result.pathologies),
        )
        return result
    finally:
        _events.emit = orig_emit
        _clock.uninstall()
        if configured_arbiter:
            _arbiter_mod.reset_for_tests()
        sys.setrecursionlimit(old_recursion)


def _step_breached(result: SimResult, slo_ms: float,
                   shed_threshold: float) -> bool:
    """Mirror of the loadgen knee-finder's breach predicate."""
    if result.p99_ms is not None and result.p99_ms > slo_ms:
        return True
    if result.shed_rate > shed_threshold:
        return True
    return result.arrivals > 0 and result.completed == 0


def sim_knee(config: Optional[ScenarioConfig] = None,
             knee_config: Optional[Any] = None) -> Dict[str, Any]:
    """Virtual-time capacity-knee sweep: the loadgen finder's exact
    ramp / confirm-twice / bisect control flow, each step a fresh
    :func:`run_trace` over a seeded Poisson schedule. Returns a
    summary dict shaped like ``KneeResult.summary()`` plus the curve.
    """
    from raydp_tpu_torch.loadgen.knee import KneeConfig

    cfg = config or ScenarioConfig()
    kcfg = knee_config or KneeConfig.from_env()
    curve: List[Dict[str, Any]] = []
    step_index = 0

    def run(rps: float, stage: str) -> Dict[str, Any]:
        nonlocal step_index
        schedule = poisson_schedule(
            rps, kcfg.step_duration_s, seed=kcfg.seed + step_index
        )
        step_index += 1
        res = run_trace(schedule, cfg, record_outcomes=True)
        point = {
            "stage": stage,
            "rps": round(rps, 3),
            "achieved_rps": round(
                res.completed / max(res.duration_s, 1e-9), 3
            ),
            "p50_ms": res.p50_ms,
            "p99_ms": res.p99_ms,
            "shed_rate": round(res.shed_rate, 4),
            "requests": res.arrivals,
            "breached": _step_breached(
                res, kcfg.slo_ms, kcfg.shed_threshold
            ),
        }
        curve.append(point)
        return point

    last_good: Optional[Dict[str, Any]] = None
    first_bad: Optional[Dict[str, Any]] = None
    prev_bad: Optional[Dict[str, Any]] = None
    offered = kcfg.start_rps
    while offered <= kcfg.max_rps:
        point = run(offered, "ramp")
        if point["breached"]:
            if prev_bad is not None:
                first_bad = prev_bad
                break
            prev_bad = point
        else:
            last_good = point
            prev_bad = None
        offered *= kcfg.step_factor
    else:
        first_bad = None

    if first_bad is None or last_good is None:
        knee_rps = last_good["rps"] if last_good is not None else 0.0
        saturated = False
        at_knee = last_good
    else:
        lo, hi = last_good, first_bad
        for _ in range(max(0, kcfg.bisect_rounds)):
            if hi["rps"] - lo["rps"] < max(0.5, 0.05 * lo["rps"]):
                break
            point = run((lo["rps"] + hi["rps"]) / 2.0, "bisect")
            if point["breached"]:
                hi = point
            else:
                lo = point
        knee_rps = lo["rps"]
        saturated = True
        at_knee = lo

    _metrics.gauge_set("sim/knee_rps", knee_rps)
    _events.emit(
        "sim/knee", knee_rps=round(knee_rps, 3), saturated=saturated,
        p99_at_knee_ms=(at_knee or {}).get("p99_ms"),
        shed_at_knee=(at_knee or {}).get("shed_rate", 0.0),
        steps=len(curve), slo_ms=kcfg.slo_ms,
    )
    return {
        "kind": "sim_knee",
        "knee_rps": round(knee_rps, 3),
        "saturated": saturated,
        "p99_at_knee_ms": (at_knee or {}).get("p99_ms"),
        "shed_at_knee": (at_knee or {}).get("shed_rate", 0.0),
        "slo_ms": kcfg.slo_ms,
        "shed_threshold": kcfg.shed_threshold,
        "steps": len(curve),
        "curve": curve,
    }


def result_to_json(result: SimResult, path: str) -> None:
    """Persist a run for ``python -m raydp_tpu_torch.sim report`` and the
    dashboard's offline directory mode."""
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(result.to_dict(), fh, indent=2, sort_keys=True)
        fh.write("\n")
