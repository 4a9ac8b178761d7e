"""AppMaster: the control-plane service (the port's copy of
``raydp_tpu/cluster/master.py``).

Role parity with the reference's RayAppMaster
(reference: core/.../deploy/raydp/RayAppMaster.scala:40-296): registers the
application, tracks workers (register / started / request / kill),
schedules workers onto placement-group bundles round-robin
(``RayAppMaster.scala:281-289``), detects worker death and cleans up, and
hosts the **object directory** with holder ownership (the reference
splits this into ObjectRefHolder + a Python holder actor).

Runs as an RPC service (``cluster/rpc.py``) in a thread of the driver
process, so holder-owned objects survive worker teardown for the
driver's lifetime; the service boundary means workers speak to it the
same way a detached deployment would.

Telemetry (``raydp_tpu/cluster/master.py:328-482``): workers' heartbeat
deltas merge into :attr:`AppMaster.telemetry` (a worker that dies or
stops is tombstoned with what it last shipped), worker lifecycle events
land in its ring and as span events, and the master answers
``MetricsSnapshot``, ``HealthReport``, ``UsageReport``, ``EventsReport``
and ``ProgressReport`` for second drivers. The port adds ``GangReport``:
``fit_spmd`` hands each finished gang's rank views to the session's
master (:meth:`AppMaster.record_gang`), which bills them with the
workers', and ``DashboardReport``. ``SchedulerReport`` answers with the
master process's arbiter (the master and the cluster owner share a
process; ``raydp_tpu/cluster/master.py:107, 337-355``), and the
dashboard carries it as its scheduler section.
"""
from __future__ import annotations

import copy
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from raydp_tpu_torch.cluster import placement as pl
from raydp_tpu_torch.cluster.rpc import RpcServer
from raydp_tpu_torch.store.agent import agent_handlers
from raydp_tpu_torch.store.directory import DirectoryStore
from raydp_tpu_torch.store.object_store import DEFAULT_NODE, OWNER_HOLDER
from raydp_tpu_torch.telemetry import ClusterTelemetry
from raydp_tpu_torch.telemetry import spans as _spans

logger = logging.getLogger(__name__)

SERVICE = "raydp.AppMaster"
# Generous by design: local crashes are detected instantly via the
# cluster's proc.poll() monitor, so the heartbeat path only covers hung
# or remote workers — and a CPU-saturated host (big shuffle on few
# cores) must not read as death.
HEARTBEAT_TIMEOUT_S = float(
    os.environ.get("RAYDP_TPU_HEARTBEAT_TIMEOUT", "45")
)


@dataclass
class WorkerInfo:
    worker_id: str
    address: str  # worker RPC endpoint
    pid: int
    node_id: str
    resources: Dict[str, float]
    state: str = "ALIVE"  # ALIVE | DEAD | STOPPED
    last_heartbeat: float = field(default_factory=time.monotonic)
    # Watchdog stall flags shipped on the last heartbeat (empty =
    # healthy): {component: {age_s, since_wall, count, attrs}}.
    stalls: Dict[str, dict] = field(default_factory=dict)


class AppMaster:
    """Control-plane state machine + its RPC server."""

    def __init__(
        self,
        namespace: str,
        nodes: Optional[List[pl.NodeInfo]] = None,
        bind_host: str = "127.0.0.1",
        advertise_host: Optional[str] = None,
        port: int = 0,
    ):
        self.namespace = namespace
        self.nodes = nodes if nodes is not None else pl.detect_nodes()
        self.node_id = DEFAULT_NODE  # the master lives on the driver node
        self.store = DirectoryStore(namespace=namespace, node_id=self.node_id)
        self._workers: Dict[str, WorkerInfo] = {}
        self._lock = threading.RLock()
        self._registration_event = threading.Event()
        self._expected_workers = 0
        self._agent_event = threading.Event()
        self._expected_agent_nodes: set = set()
        self._monitor_stop = threading.Event()
        # Cluster-wide metrics view: workers ship registry deltas on
        # their heartbeats; this merges them keyed by worker id.
        self.telemetry = ClusterTelemetry()
        # Finished SPMD gangs' final rank views, "<gang>/rank-<r>" ->
        # sections (record_gang); kept apart from the workers' views.
        self._gangs: Dict[str, dict] = {}
        handlers = {
            "RegisterWorker": self._on_register_worker,
            "Heartbeat": self._on_heartbeat,
            "WorkerStopped": self._on_worker_stopped,
            "RegisterObject": self._on_register_object,
            "PutObject": self._on_put_object,
            "RegisterAgent": self._on_register_agent,
            "TransferToHolder": self._on_transfer_to_holder,
            "GetObjectMeta": self._on_get_object_meta,
            "ListObjects": self._on_list_objects,
            "DeleteObject": self._on_delete_object,
            "ListWorkers": self._on_list_workers,
            "ClusterResources": self._on_cluster_resources,
            "MetricsSnapshot": self._on_metrics_snapshot,
            "HealthReport": self._on_health_report,
            "ProgressReport": self._on_progress_report,
            "UsageReport": self._on_usage_report,
            "EventsReport": self._on_events_report,
            "DashboardReport": self._on_dashboard_report,
            "SchedulerReport": self._on_scheduler_report,
            "GangReport": self._on_gang_report,
            "Ping": lambda req: {"pong": True, "namespace": self.namespace},
        }
        # The master doubles as the driver node's store agent (no extra
        # process on the node the driver already occupies).
        handlers.update(agent_handlers(self.store))
        self._server = RpcServer(SERVICE, handlers, host=bind_host, port=port)
        # A server bound to every interface is dialled at a concrete
        # address (the reference's RpcServer advertises the same way).
        if advertise_host is None and bind_host == "0.0.0.0":
            advertise_host = pl.local_ip()
        self._address = (f"{advertise_host}:{self._server.port}"
                         if advertise_host else self._server.address)
        self.store.register_agent(self.node_id, self.address, SERVICE)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="raydp-master-monitor", daemon=True
        )
        self._monitor.start()

    # ------------------------------------------------------------------
    @property
    def address(self) -> str:
        return self._address

    def expect_workers(self, n: int) -> None:
        with self._lock:
            self._expected_workers = n
            self._registration_event.clear()
            self._check_registration_barrier()

    def wait_for_workers(self, timeout: float = 60.0) -> bool:
        """Registration barrier (reference:
        RayCoarseGrainedSchedulerBackend.scala:155,180-182)."""
        return self._registration_event.wait(timeout)

    def expect_agents(self, node_ids) -> None:
        with self._lock:
            self._expected_agent_nodes = set(node_ids)
            self._agent_event.clear()
            self._check_agent_barrier()

    def wait_for_agents(self, timeout: float = 60.0) -> bool:
        return self._agent_event.wait(timeout)

    def _check_agent_barrier(self) -> None:
        if self._expected_agent_nodes <= set(self.store.agents()):
            self._agent_event.set()

    def object_meta(self, object_id: str):
        """In-process resolver hook: (ref, agent) for the driver."""
        return self.store.meta(object_id)

    def alive_workers(self) -> List[WorkerInfo]:
        with self._lock:
            return [w for w in self._workers.values() if w.state == "ALIVE"]

    def mark_worker_dead(self, worker_id: str, reason: str = "") -> None:
        """Worker-disconnect path (reference: RayAppMaster.scala:184-186
        kills executors on RPC disconnect). Unlinks the worker's
        non-transferred objects."""
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None or info.state != "ALIVE":
                return
            info.state = "DEAD"
        # Tombstone, don't drop: the final shipped snapshot is what a
        # straggler postmortem needs.
        self.telemetry.tombstone(worker_id)
        self.telemetry.event("worker/dead", worker_id=worker_id,
                             reason=reason)
        _spans.event("cluster/worker_dead", worker_id=worker_id,
                     reason=reason)
        doomed = self.store.on_owner_died(worker_id)
        logger.warning(
            "worker %s dead (%s); unlinked %d objects",
            worker_id,
            reason,
            len(doomed),
        )

    def release_holder(self) -> int:
        """Unlink holder-owned objects (the del_obj_holder=True path)."""
        doomed = self.store.on_owner_died(OWNER_HOLDER)
        return len(doomed)

    def shutdown(self) -> None:
        self._monitor_stop.set()
        self._server.stop()

    # -- handlers -------------------------------------------------------
    def _on_register_worker(self, req: dict) -> dict:
        info = WorkerInfo(
            worker_id=req["worker_id"],
            address=req["address"],
            pid=req["pid"],
            node_id=req.get("node_id", "node-0"),
            resources=req.get("resources", {}),
        )
        with self._lock:
            self._workers[info.worker_id] = info
            self._check_registration_barrier()
        self.telemetry.event("worker/registered", worker_id=info.worker_id,
                             node_id=info.node_id, pid=info.pid)
        _spans.event("cluster/worker_registered", worker_id=info.worker_id,
                     node_id=info.node_id)
        logger.info("registered worker %s @ %s", info.worker_id, info.address)
        return {"namespace": self.namespace}

    def _check_registration_barrier(self) -> None:
        alive = sum(1 for w in self._workers.values() if w.state == "ALIVE")
        if self._expected_workers and alive >= self._expected_workers:
            self._registration_event.set()

    def _on_heartbeat(self, req: dict) -> dict:
        # The piggybacked metrics delta merges even for a worker this
        # master wrote off (its last beats still carry data), outside
        # the worker-table lock (the merged view has its own).
        delta = req.get("metrics")
        if delta:
            self.telemetry.apply(req["worker_id"], delta)
        with self._lock:
            info = self._workers.get(req["worker_id"])
            if info is None:
                return {"known": False}
            info.last_heartbeat = time.monotonic()
            # A beat without a health payload means the worker's
            # watchdog sees no stall: recovery clears the flags.
            info.stalls = (req.get("health") or {}).get("stalls") or {}
            return {"known": info.state == "ALIVE"}

    def _on_worker_stopped(self, req: dict) -> dict:
        worker_id = req["worker_id"]
        # A graceful exit ships the full final snapshot: merge and
        # tombstone, so the worker's lifetime totals outlive it.
        self.telemetry.apply(worker_id, req.get("metrics"), final=True)
        self.telemetry.event("worker/stopped", worker_id=worker_id)
        _spans.event("cluster/worker_stopped", worker_id=worker_id)
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                info.state = "STOPPED"
        # Graceful stop loses non-transferred objects too — data survives
        # worker teardown only via the holder (reference semantics:
        # test_data_owner_transfer.py:34-78, stop_spark → OwnerDiedError).
        doomed = self.store.on_owner_died(worker_id)
        if doomed:
            logger.info(
                "worker %s stopped; unlinked %d non-transferred objects",
                worker_id,
                len(doomed),
            )
        return {}

    def _on_register_object(self, req: dict) -> dict:
        ref = req["ref"]
        # A worker this master already wrote off (disowned mid-task but
        # still finishing — the heartbeat-starvation survival path) may
        # register worker-owned objects whose segments were unlinked the
        # moment it was marked dead. Registering such a ref would hand
        # later readers a pointer to deleted storage; fail the task
        # loudly here instead (holder-owned refs — every DataFrame stage
        # output — are unaffected: the holder never "dies").
        owner = getattr(ref, "owner", None)
        if owner is not None and owner != OWNER_HOLDER:
            # check + register under ONE lock hold: mark_worker_dead
            # flips state to DEAD under this lock and only unlinks
            # afterwards, so with the lock held across both steps a
            # registration lands either strictly before the DEAD
            # transition (the subsequent on_owner_died unlinks it) or
            # after (this raises) — never in between as a dangling ref.
            with self._lock:
                info = self._workers.get(owner)
                if info is not None and info.state != "ALIVE":
                    raise RuntimeError(
                        f"owner {owner} was marked dead; its objects were "
                        "unlinked — refusing to register a dangling ref"
                    )
                self.store.register_ref(ref)
            return {}
        self.store.register_ref(ref)
        return {}

    def _on_put_object(self, req: dict) -> dict:
        """Remote write path: bytes land in the driver node's store under
        the requested owner."""
        ref = self.store.put(
            req["data"],
            owner=req.get("owner", OWNER_HOLDER),
            num_rows=req.get("num_rows", -1),
        )
        return {"ref": ref}

    def _on_register_agent(self, req: dict) -> dict:
        self.store.register_agent(
            req["node_id"], req["address"], req["service"]
        )
        with self._lock:
            self._check_agent_barrier()
        return {"namespace": self.namespace}

    def _on_transfer_to_holder(self, req: dict) -> dict:
        return {"ref": self.store.transfer_to_holder(req["ref"])}

    def _on_get_object_meta(self, req: dict) -> dict:
        ref, agent = self.store.meta(req["object_id"])
        return {"ref": ref, "agent": agent}

    def _on_list_objects(self, req: dict) -> dict:
        return {"refs": self.store.refs()}

    def _on_delete_object(self, req: dict) -> dict:
        return {"deleted": self.store.delete(req["object_id"])}

    def _on_list_workers(self, req: dict) -> dict:
        with self._lock:
            return {"workers": list(self._workers.values())}

    def _on_cluster_resources(self, req: dict) -> dict:
        return self.cluster_resources()

    def _on_metrics_snapshot(self, req: dict) -> dict:
        return {"snapshot": self.metrics_snapshot()}

    def _on_health_report(self, req: dict) -> dict:
        return {"report": self.health_report()}

    def _on_progress_report(self, req: dict) -> dict:
        return {"report": self.progress_report()}

    def _on_usage_report(self, req: dict) -> dict:
        return {"report": self.usage_report()}

    def _on_events_report(self, req: dict) -> dict:
        return {"report": self.events_report(job=req.get("job"))}

    def _on_scheduler_report(self, req: dict) -> dict:
        return {"report": self.scheduler_report()}

    def _on_dashboard_report(self, req: dict) -> dict:
        return {"report": self.dashboard_report()}

    def _on_gang_report(self, req: dict) -> dict:
        self.record_gang(req["gang"], req["views"])
        return {}

    def record_gang(self, gang: str, views: Dict[str, dict]) -> None:
        """Keep one finished SPMD gang's final per-rank views (``{"rank-<r>":
        sections}``) as ``<gang>/rank-<r>`` under ``gangs`` in
        :meth:`metrics_snapshot`: :meth:`usage_report` bills them and the
        exposition renders them, but they are not workers (no liveness,
        health or aggregate). ``gang`` names one launch of one fit, so a
        second fit or a relaunch adds views and overwrites none;
        re-sending the same report is harmless."""
        with self._lock:
            for rank_key, sections in views.items():
                self._gangs[f"{gang}/{rank_key}"] = {
                    k: copy.deepcopy(v) for k, v in sections.items()
                    if k not in ("tombstone", "updated_wall")}

    def usage_report(self) -> dict:
        """Per-job usage ledger folded over the merged cluster view."""
        from raydp_tpu_torch.telemetry import accounting as _acct

        return _acct.usage_report(self.metrics_snapshot())

    def events_report(self, job: Optional[str] = None) -> dict:
        """Cluster event timeline plus MTTR episodes, from the
        telemetry dir's shards (or this process's ring)."""
        from raydp_tpu_torch.telemetry import events as _events
        from raydp_tpu_torch.telemetry import telemetry_dir

        records = _events.load_event_records(telemetry_dir(), job=job)
        return {"events": records, "mttr": _events.mttr_report(records)}

    def dashboard_report(self) -> dict:
        """The dashboard over the merged cluster view, for a second
        driver (``Cluster.dashboard_report``'s document)."""
        from raydp_tpu_torch.telemetry import dashboard as _dash
        from raydp_tpu_torch.telemetry import events as _events
        from raydp_tpu_torch.telemetry import telemetry_dir

        records = _events.load_event_records(telemetry_dir())
        return _dash.build(self.metrics_snapshot(),
                           scheduler=self.scheduler_report(),
                           events=records)

    def scheduler_report(self) -> dict:
        """The master process's arbiter state (``ClusterArbiter.report``):
        the authoritative view a second driver polls."""
        from raydp_tpu_torch.control import get_arbiter

        return get_arbiter().report()

    def progress_report(self) -> dict:
        """Live stage progress: the driver-process tracker (DataFrame
        stages run driver-side; workers only execute their tasks) plus
        recent completed-stage stats from the stage store."""
        from raydp_tpu_torch.telemetry.progress import progress, stage_store

        report = progress.report()
        store_snap = stage_store.snapshot()
        report["stage_totals"] = store_snap["totals"]
        report["recent_stage_stats"] = store_snap["stages"][-16:]
        return report

    def health_report(self) -> dict:
        """Aggregated cluster health: per-worker heartbeat age and stall
        flags, plus slowest-rank attribution from the merged timers.

        Fires before the heartbeat timeout: a wedged task does not stop
        the worker's heartbeat thread, so the stall flag arrives on the
        next beat (~2 s), while death detection waits
        ``HEARTBEAT_TIMEOUT_S``.
        """
        from raydp_tpu_torch.telemetry import watchdog as _watchdog

        now = time.monotonic()
        with self._lock:
            workers = {
                wid: {
                    "state": w.state,
                    "node_id": w.node_id,
                    "pid": w.pid,
                    "heartbeat_age_s": round(now - w.last_heartbeat, 3),
                    "stalls": dict(w.stalls),
                }
                for wid, w in self._workers.items()
            }
        stalled = sorted(
            wid for wid, w in workers.items()
            if w["stalls"] and w["state"] == "ALIVE"
        )
        dead = sorted(
            wid for wid, w in workers.items() if w["state"] == "DEAD"
        )
        late = sorted(
            wid for wid, w in workers.items()
            if w["state"] == "ALIVE"
            and w["heartbeat_age_s"] > HEARTBEAT_TIMEOUT_S / 2
        )
        driver = _watchdog.health()
        return {
            "healthy": not (stalled or dead or late)
            and driver.get("healthy", True),
            "workers": workers,
            "stalled_workers": stalled,
            "dead_workers": dead,
            "late_workers": late,
            "slowest_rank": self._slowest_rank(),
            "heartbeat_timeout_s": HEARTBEAT_TIMEOUT_S,
            "driver": driver,
        }

    def _slowest_rank(self) -> Optional[dict]:
        """Straggler attribution from shipped step/task timers (p50:
        robust to one-off spikes)."""
        view = self.telemetry.merged()
        slowest: Optional[dict] = None
        for wid, sections in (view.get("workers") or {}).items():
            for key in ("timer/train/step", "timer/worker/task"):
                sec = sections.get(key)
                if not sec or not sec.get("p50_s"):
                    continue
                if slowest is None or sec["p50_s"] > slowest["p50_s"]:
                    slowest = {
                        "worker": wid,
                        "timer": key[len("timer/"):],
                        "p50_s": sec["p50_s"],
                    }
                break  # prefer train/step when a worker has both
        return slowest

    def metrics_snapshot(self) -> dict:
        """Merged cluster metrics: per-worker views (tombstones
        included), the cross-worker aggregate, lifecycle events,
        this (driver) process's own registry under ``"driver"``, and the
        finished gangs' rank views under ``"gangs"`` once there are any
        (:meth:`record_gang`)."""
        from raydp_tpu_torch.utils.profiling import metrics as _m
        from raydp_tpu_torch.utils.profiling import sample_resource_gauges

        # The driver's gauges are sampled now; workers' arrive sampled
        # on their heartbeats.
        sample_resource_gauges()
        view = self.telemetry.merged()
        view["driver"] = _m.snapshot()
        with self._lock:
            if self._gangs:
                view["gangs"] = copy.deepcopy(self._gangs)
        return view

    def cluster_resources(self) -> dict:
        """Resource introspection (reference:
        python/raydp/ray_cluster_resources.py)."""
        with self._lock:
            alive = [w for w in self._workers.values() if w.state == "ALIVE"]
        total: Dict[str, float] = {}
        for node in self.nodes:
            for k, v in node.resources.items():
                total[k] = total.get(k, 0.0) + v
        used: Dict[str, float] = {}
        for w in alive:
            for k, v in w.resources.items():
                used[k] = used.get(k, 0.0) + v
        return {
            "total": total,
            "used": used,
            "available": {k: total.get(k, 0.0) - used.get(k, 0.0) for k in total},
            "num_nodes": len(self.nodes),
            "num_alive_workers": len(alive),
        }

    # -- monitor --------------------------------------------------------
    def _monitor_loop(self) -> None:
        prev = time.monotonic()
        while not self._monitor_stop.wait(1.0):
            now = time.monotonic()
            prev = self._monitor_tick(now, prev)

    def _monitor_tick(self, now: float, prev: float) -> float:
        """One liveness pass; returns the new ``prev`` timestamp.

        Self-stall defense: if the loop overslept its 1 s period (driver
        process GIL-starved by a big shuffle on a small host), the
        workers' heartbeats were starved by the same cause — their
        staleness is evidence of OUR stall, not their death. Grant the
        oversleep back as grace instead of declaring a massacre.
        """
        oversleep = (now - prev) - 1.0
        if oversleep > 2.0:
            with self._lock:
                for w in self._workers.values():
                    if w.state == "ALIVE":
                        # Clamped: grace covers staleness accrued DURING
                        # the stall; a beat processed near the stall's
                        # end must not end up timestamped in the future.
                        w.last_heartbeat = min(
                            now, w.last_heartbeat + oversleep
                        )
            # Fall through to the stale check: under CHRONIC oversleep
            # net staleness still accumulates tick by tick, and skipping
            # the check here would blind death detection.
        with self._lock:
            stale = [
                w.worker_id
                for w in self._workers.values()
                if w.state == "ALIVE"
                and now - w.last_heartbeat > HEARTBEAT_TIMEOUT_S
            ]
        for worker_id in stale:
            self.mark_worker_dead(worker_id, reason="heartbeat timeout")
        return now
