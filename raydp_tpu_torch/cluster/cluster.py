"""Cluster facade: AppMaster + worker-pool lifecycle + task submission
(the port's copy of ``raydp_tpu/cluster/cluster.py``).

Collapses the reference's Python/JVM control-plane sandwich
(reference: python/raydp/spark/ray_cluster.py:30-97 SparkCluster,
ray_cluster_master.py:36-196 RayDPSparkMaster spawning a JVM via py4j)
into one component: the AppMaster runs in-process, workers are spawned as
subprocesses of this driver, and everything speaks one RPC protocol
(``cluster/rpc.py``). Task functions travel through the closure carrier
(``cluster/closure.py``). Every worker is launched with
``CUDA_VISIBLE_DEVICES=""`` (the counterpart of the reference's
``JAX_PLATFORMS=cpu``): ETL workers never open a context on a card.

Dynamic allocation parity (reference:
RayCoarseGrainedSchedulerBackend.scala:219-242
doRequestTotalExecutors/doKillExecutors): ``request_workers`` /
``kill_worker`` grow and shrink the pool; shm objects survive worker
death when holder-owned (the external-shuffle-service capability —
shuffle state outliving executors — reference C16).

Telemetry (``raydp_tpu/cluster/cluster.py:109-204, 644-751``):
``start`` mints the session's trace root (``cluster/job``) and hands it,
with the ambient job, to every worker's launch env; it arms the
driver's flight recorder (no signal handlers: the driver is the user's
process), logs and watchdog, and serves the merged view at ``/metrics``
when ``RAYDP_TPU_METRICS_PORT`` is set. Task submissions carry the
submitting thread's trace context and job onto the pool threads that
send them. :meth:`Cluster.metrics_snapshot`, :meth:`trace_report`,
:meth:`usage_report`, :meth:`events_report` and :meth:`health_report`
read the planes; worker churn lands on the event timeline.

``start()`` arms the time-series sampler and the SLO engine over the
merged view (``_start_observability``); :meth:`dashboard_report` folds
them into one document and :meth:`capture_profile` merges a trace of
the driver and every worker, both also served on the metrics endpoint
(``/debug/dashboard``, ``/debug/profile``). :meth:`scheduler_report`
is the control plane's arbiter (``raydp_tpu/cluster/cluster.py:
690-723``), and the dashboard's scheduler section; the autoscaler's
``ClusterProvisioner`` grows and shrinks the pool through
:meth:`request_workers`, :meth:`kill_worker` and :meth:`alive_workers`.
"""
from __future__ import annotations

import itertools
import logging
import os
import secrets
import subprocess
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from raydp_tpu_torch.cluster import closure
from raydp_tpu_torch.cluster import placement as pl
from raydp_tpu_torch.cluster.launcher import (
    LaunchSpec,
    LocalLauncher,
    WorkerLauncher,
)
from raydp_tpu_torch.cluster.master import AppMaster, WorkerInfo
from raydp_tpu_torch.cluster.rpc import (
    RpcClient,
    RpcError,
    RpcTimeout,
    RpcUnavailable,
)
from raydp_tpu_torch.config import ClusterConfig
from raydp_tpu_torch.store.object_store import DEFAULT_NODE

logger = logging.getLogger(__name__)


# The launch env of every worker and agent process: no card (the
# counterpart of the reference's JAX_PLATFORMS=cpu; ETL never touches one).
_CHILD_ENV = {"CUDA_VISIBLE_DEVICES": ""}


class ClusterError(RuntimeError):
    pass


@dataclass
class TaskSpec:
    """One task in a :meth:`Cluster.submit_batch` call.

    ``data_args`` are Arrow tables that travel the DATA plane: they are
    written to the submitter's shm store and only their ObjectRefs ride
    the RPC envelope; the worker resolves them (zero-copy when
    co-located) and appends the tables after ``args`` in the call.
    """

    fn: Callable
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    worker_id: Optional[str] = None  # locality preference, not a pin
    data_args: Tuple = ()
    # Node-level placement hint: when the preferred worker is gone (or
    # none was named), any alive worker on this node still gets the
    # zero-copy shm reads the hint was chosen for (shuffle merge
    # placement). Softer than worker_id, harder than round-robin.
    node_id: Optional[str] = None


class _WorkerGone(Exception):
    """Batch envelope lost to worker death; tasks are retriable."""


#: Sentinel outcome: the envelope thread already resolved its futures
#: inline (per-envelope streaming) — nothing left for the joiner to do.
_BATCH_RESOLVED = object()


class Cluster:
    def __init__(self, config: ClusterConfig):
        self.config = config
        self.namespace = f"{_slug(config.app_name)}-{secrets.token_hex(3)}"
        self.master: Optional[AppMaster] = None
        self.pg: Optional[pl.PlacementGroup] = None
        self.launcher: WorkerLauncher = config.launcher or LocalLauncher()
        self._procs: Dict[str, subprocess.Popen] = {}
        self._worker_nodes: Dict[str, str] = {}
        self._agent_procs: Dict[str, subprocess.Popen] = {}
        self._worker_clients: Dict[str, RpcClient] = {}
        self._worker_seq = itertools.count()
        self._rr = itertools.count()  # round-robin task cursor
        self._lock = threading.RLock()
        self._pool = ThreadPoolExecutor(max_workers=32)
        self._resolver = None
        self._restarts_used = 0
        # Per-worker-lineage restart timestamps (monotonic) for the
        # sliding-window budget; a respawned worker inherits its
        # predecessor's list so a crash-looping worker exhausts its OWN
        # budget without starving respawns of healthy workers.
        self._restart_history: Dict[str, List[float]] = {}
        self._elastic_stop = threading.Event()
        self._elastic_thread: Optional[threading.Thread] = None
        self._trace_ctx = None
        self._metrics_server = None
        # The observability plane (time series and SLO engine), armed by
        # start().
        self._ts_sampler = None
        self._slo_engine = None
        self._log_dir = os.path.join(
            tempfile.gettempdir(), "raydp_tpu_torch",
            f"{_slug(config.app_name)}-{os.getpid()}",
        )

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        os.makedirs(self._log_dir, exist_ok=True)
        # The session's trace root: every span recorded in this session
        # (driver threads, master handlers, worker processes) parents
        # under it, so a whole run is one trace.
        from raydp_tpu_torch.telemetry import flight_recorder as _flight
        from raydp_tpu_torch.telemetry import logs as _logs
        from raydp_tpu_torch.telemetry import propagation as _prop
        from raydp_tpu_torch.telemetry import watchdog as _watchdog

        self._trace_ctx = _prop.mint_context(
            "cluster/job",
            app=self.config.app_name,
            namespace=self.namespace,
        )
        _prop.set_process_context(self._trace_ctx)
        _flight.install(component="driver", signals=False)
        _logs.install()
        _watchdog.ensure_started()
        _flight.record("state", "cluster_start", namespace=self.namespace,
                       app=self.config.app_name,
                       num_workers=self.config.num_workers)
        nodes = (
            pl.detect_nodes(self.config.num_virtual_nodes)
            if self.config.num_virtual_nodes
            else None
        )
        self.master = AppMaster(
            self.namespace,
            nodes=nodes,
            bind_host=self.config.bind_host,
            advertise_host=self.config.advertise_host,
            port=self.config.master_port,
        )
        try:
            self._place_group()
            self._spawn_agents()
            self.master.expect_workers(self.config.num_workers)
            for _ in range(self.config.num_workers):
                self._spawn_worker()
            if self.config.num_workers and not self.master.wait_for_workers(60.0):
                raise ClusterError(
                    f"workers failed to register within 60s "
                    f"(logs: {self._log_dir})"
                )
        except BaseException:
            # Partial start must not leak the master server/monitor thread.
            self.shutdown(del_obj_holder=True)
            raise
        logger.info(
            "cluster %s up: %d workers, master @ %s",
            self.namespace,
            self.config.num_workers,
            self.master.address,
        )
        self._elastic_thread = threading.Thread(
            target=self._elastic_loop, name="raydp-elastic", daemon=True
        )
        self._elastic_thread.start()
        self._warm_workers_async()
        self._serve_metrics()
        self._start_observability()

    def _serve_metrics(self) -> None:
        """Serve the merged Prometheus view at ``/metrics`` (and the debug
        routes) when ``RAYDP_TPU_METRICS_PORT`` is set. A taken port does
        not fail the session's start."""
        from raydp_tpu_torch.telemetry import (
            METRICS_PORT_ENV,
            serve_prometheus,
        )

        port = os.environ.get(METRICS_PORT_ENV)
        if not port:
            return
        try:
            self._metrics_server = serve_prometheus(
                self.prometheus_metrics, int(port),
                health=self.health_report,
                progress=self.progress_report,
                # The cluster-wide capture and the merged dashboard, not
                # just the driver process's.
                profile=lambda seconds: self.capture_profile(seconds) or {},
                events=self.events_report,
                dashboard=self.dashboard_report,
            )
            logger.info("prometheus scrape endpoint on :%d/metrics",
                        self._metrics_server.port)
        except Exception:
            logger.exception("metrics endpoint failed to start")

    def _start_observability(self) -> None:
        """Arm the driver's time-series sampler over the merged view and
        the SLO engine over its store; each has its kill switch
        (``RAYDP_TPU_TIMESERIES=0``, ``RAYDP_TPU_SLO=0``) and costs one
        snapshot fold a sampling interval. A failure here is logged and
        never fails the session's start."""
        from raydp_tpu_torch.telemetry import slo as _slo
        from raydp_tpu_torch.telemetry import timeseries as _ts

        try:
            if _ts.timeseries_enabled():
                self._ts_sampler = _ts.TimeSeriesSampler(
                    snapshot_fn=self.metrics_snapshot).start()
            if _slo.slo_enabled() and self._ts_sampler is not None:
                self._slo_engine = _slo.SloEngine(
                    store=self._ts_sampler.store).start()
        except Exception:
            logger.exception("observability plane failed to start")

    @property
    def log_dir(self) -> str:
        """Where each worker and agent writes its log
        (``<tmp>/raydp_tpu_torch/<app>-<driver pid>/<worker id>.log``)."""
        return self._log_dir

    def _warm_workers_async(self) -> None:
        """Pre-import the ETL stack on every worker in the background.

        A worker's first dataframe task otherwise pays the pandas/pyarrow
        import chain inside the first query (hundreds of ms, multiplied
        when all workers cold-start concurrently on a small host). Fire-
        and-forget: results are dropped, failures are harmless (a dead
        worker surfaces through the elastic loop, not here)."""

        def _warm(ctx):
            import pandas  # noqa: F401

            import raydp_tpu_torch.dataframe.dataframe  # noqa: F401

            return True

        def _fire():
            try:
                for w in self.alive_workers():
                    self.submit_async(_warm, worker_id=w.worker_id)
            except Exception:  # pragma: no cover - warmup is best-effort
                pass

        threading.Thread(
            target=_fire, name="raydp-warmup", daemon=True
        ).start()

    def _elastic_loop(self) -> None:
        """Crash recovery (reference: executor reschedule on disconnect,
        RayAppMaster.scala:184-186 + schedule() re-request): a worker
        process that EXITS without being stopped by us is marked dead and
        respawned on its node. Intentional stops pop the proc from
        ``_procs`` first, so they never trip this.

        The restart budget is a PER-WORKER sliding window:
        ``max_worker_restarts`` restarts within
        ``RAYDP_TPU_RESTART_WINDOW_S`` seconds (default 600), tracked
        per lineage — the respawn inherits its predecessor's history.
        A crash-looping worker burns through its own window and stays
        down; an unrelated healthy worker that crashes later still gets
        its full budget (a global counter would have starved it).
        Restarts are counted in the metrics registry
        (``worker_restarts/<worker>``).
        """
        from raydp_tpu_torch.telemetry import events as _events
        from raydp_tpu_torch.utils.profiling import metrics as _metrics

        window_s = 600.0
        raw = os.environ.get("RAYDP_TPU_RESTART_WINDOW_S")
        if raw:
            try:
                window_s = float(raw)
            except ValueError:
                pass
        while not self._elastic_stop.wait(0.5):
            with self._lock:
                exited = [
                    (wid, proc)
                    for wid, proc in self._procs.items()
                    if proc.poll() is not None
                ]
            for wid, proc in exited:
                with self._lock:
                    if self._procs.get(wid) is not proc:
                        continue  # stopped/replaced concurrently
                    self._procs.pop(wid, None)
                    node = self._worker_nodes.get(wid)
                    now = time.monotonic()
                    history = self._restart_history.setdefault(wid, [])
                    history[:] = [t for t in history if now - t < window_s]
                    allow = len(history) < self.config.max_worker_restarts
                    if allow:
                        history.append(now)
                        self._restarts_used += 1
                if self.master is None:
                    return
                _events.emit("worker/dead", worker=wid, node=node,
                             rc=proc.returncode)
                self.master.mark_worker_dead(
                    wid, reason=f"process exited rc={proc.returncode}"
                )
                if allow:
                    _metrics.counter_add(f"worker_restarts/{wid}")
                    new_id = self._spawn_worker(node_id=node)
                    _events.emit(
                        "worker/restart", worker=wid, respawned_as=new_id,
                        node=node, restarts_in_window=len(history),
                    )
                    with self._lock:
                        # Lineage carry-over: if the respawn crash-loops,
                        # it exhausts this same window, not a fresh one.
                        self._restart_history[new_id] = history
                    logger.warning(
                        "worker %s crashed (rc=%s); respawned as %s on %s "
                        "(%d/%d restarts in window)",
                        wid, proc.returncode, new_id, node,
                        len(history), self.config.max_worker_restarts,
                    )
                else:
                    logger.error(
                        "worker %s crashed; its restart budget (%d in "
                        "%.0fs window) is exhausted",
                        wid, self.config.max_worker_restarts, window_s,
                    )

    def _spawn_agents(self) -> None:
        self._ensure_agents(
            self._bundle_node(i) for i in range(self.config.num_workers)
        )

    def _ensure_agents(self, node_ids) -> None:
        """One store agent per non-driver node that hosts workers (the
        per-node data-plane process; the driver node's agent is embedded in
        the master). Idempotent — called again when dynamic allocation
        lands workers on new nodes."""
        with self._lock:
            agent_nodes = (
                set(node_ids) - {DEFAULT_NODE} - set(self._agent_procs)
            )
        if not agent_nodes:
            return
        for node_id in sorted(agent_nodes):
            spec = LaunchSpec(
                argv=[
                    "-m",
                    "raydp_tpu_torch.store.agent",
                    "--namespace",
                    self.namespace,
                    "--node-id",
                    node_id,
                    "--master",
                    self.master.address,
                    "--bind-host",
                    self.config.bind_host,
                ],
                node_id=node_id,
                log_path=os.path.join(self._log_dir, f"agent-{node_id}.log"),
                env=dict(_CHILD_ENV),
                cwd=_repo_root(),
            )
            with self._lock:
                self._agent_procs[node_id] = self.launcher.launch(spec)
        with self._lock:
            all_agent_nodes = set(self._agent_procs)
        self.master.expect_agents(all_agent_nodes)
        if not self.master.wait_for_agents(60.0):
            raise ClusterError(
                f"store agents failed to register (logs: {self._log_dir})"
            )

    def _place_group(self) -> None:
        if self.config.placement_group is not None:
            self.pg = self.config.placement_group
            return
        if self.config.placement_strategy is None:
            self.pg = None
            return
        bundles = [
            {
                "cpu": float(self.config.cores_per_worker),
                "memory": float(self.config.memory_per_worker),
            }
            for _ in range(self.config.num_workers)
        ]
        self.pg = pl.place(
            bundles, self.config.placement_strategy, self.master.nodes
        )

    def _bundle_node(self, index: int) -> str:
        if self.pg is None:
            # No placement group: on a multi-node cluster, spread workers
            # round-robin over nodes so every host gets a data-plane
            # presence; single node degenerates to node-0.
            nodes = self.master.nodes if self.master is not None else []
            if len(nodes) > 1:
                return nodes[index % len(nodes)].node_id
            return DEFAULT_NODE
        indexes = self.config.placement_bundle_indexes
        if indexes is not None:
            index = indexes[index % len(indexes)]
        # Round-robin over bundles (reference: RayAppMaster.scala:281-289).
        bundle = self.pg.bundles[index % len(self.pg.bundles)]
        return bundle.node_id or "node-0"

    def _child_trace_env(self) -> Dict[str, str]:
        """The trace and the job a child process joins: the session's
        trace root and the ambient job (no entry where there is none)."""
        from raydp_tpu_torch.telemetry import accounting as _acct
        from raydp_tpu_torch.telemetry import propagation as _prop

        return {
            **_prop.env_for_child(self._trace_ctx),
            **_acct.env_for_child(),
        }

    def _spawn_worker(self, node_id: Optional[str] = None) -> str:
        seq = next(self._worker_seq)
        worker_id = f"w{seq}"
        if node_id is None:
            node_id = self._bundle_node(seq)
        spec = LaunchSpec(
            argv=[
                "-m",
                "raydp_tpu_torch.cluster.worker_main",
                "--worker-id",
                worker_id,
                "--master",
                self.master.address,
                "--node-id",
                node_id,
                "--cores",
                str(self.config.cores_per_worker),
                "--memory",
                str(self.config.memory_per_worker),
                "--bind-host",
                self.config.bind_host,
            ],
            node_id=node_id,
            log_path=os.path.join(self._log_dir, f"{worker_id}.log"),
            env={**_CHILD_ENV, **self._child_trace_env()},
            cwd=_repo_root(),
        )
        proc = self.launcher.launch(spec)
        with self._lock:
            self._procs[worker_id] = proc
            self._worker_nodes[worker_id] = node_id
        from raydp_tpu_torch.telemetry import events as _events

        _events.emit("worker/spawn", worker=worker_id, node=node_id)
        return worker_id

    def shutdown(self, del_obj_holder: bool = True, fast: bool = False) -> None:
        """Stop workers; tear down master now (del_obj_holder=True) or keep
        it + holder objects alive for later release_holder().

        ``fast=True`` (interpreter-exit path) skips the graceful RPC dance:
        thread pools are already being torn down by CPython at that point,
        so RPCs to/from the master would race executor shutdown.
        """
        self._elastic_stop.set()  # teardown must never trigger respawns
        from raydp_tpu_torch.telemetry import flight_recorder as _flight

        _flight.record("state", "cluster_shutdown",
                       namespace=self.namespace, fast=fast)
        with self._lock:
            worker_ids = list(self._procs)
        if fast:
            # Workers die hard; agents are NOT terminated here — they must
            # stay reachable so release_holder() can broadcast DestroyStore
            # before stopping them (else remote-node segments leak).
            with self._lock:
                procs = list(self._procs.values())
                self._procs.clear()
            for proc in procs:
                proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    proc.kill()
        else:
            for worker_id in worker_ids:
                self._stop_worker(worker_id, kill_objects=False)
            self._flush_telemetry()
        self._pool.shutdown(wait=False)
        for attr in ("_slo_engine", "_ts_sampler"):
            plane = getattr(self, attr)
            if plane is not None:
                try:
                    plane.stop()
                except Exception:  # pragma: no cover - teardown best-effort
                    pass
                setattr(self, attr, None)
        if self._metrics_server is not None:
            try:
                self._metrics_server.close()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            self._metrics_server = None
        self._reset_trace_context()
        if self.master is not None:
            if del_obj_holder:
                self.release_holder()
        # Note: with del_obj_holder=False the store agents stay up — holder
        # objects on remote nodes must remain fetchable until
        # release_holder() (reference: stop_spark(del_obj_holder=False),
        # context.py:208-215).

    def _reset_trace_context(self) -> None:
        """Drop the session's trace context, if it is still this
        session's: a driver may start a second session before the first
        is torn down."""
        if self._trace_ctx is None:
            return
        from raydp_tpu_torch.telemetry import propagation as _prop

        if _prop.process_context() == self._trace_ctx:
            _prop.set_process_context(None)
        self._trace_ctx = None

    def _flush_telemetry(self) -> None:
        """Write the master's lifecycle events and the driver's spans to
        the telemetry dir on a graceful stop (a no-op without one). The
        workers have stopped, so their final snapshots are merged."""
        from raydp_tpu_torch.telemetry import (
            flush_spans,
            telemetry_dir,
            write_events,
        )

        if telemetry_dir() is None:
            return
        try:
            if self.master is not None:
                write_events(self.master.telemetry.events())
            flush_spans()
        except Exception:  # pragma: no cover - telemetry must not block exit
            logger.exception("telemetry flush failed")

    def release_holder(self) -> None:
        """Unlink holder-owned objects, stop agents + the master service."""
        if self.master is None:
            return
        self.master.release_holder()
        self.master.store.destroy()  # broadcasts DestroyStore to agents
        self._stop_agents()
        # Backstop for same-machine virtual nodes (and crashed agents):
        # sweep every segment of this namespace across ALL node prefixes.
        from raydp_tpu_torch.store import shm

        for name in shm.list_segments(f"rdp-{self.namespace}-"):
            shm.unlink(name)
        self.master.shutdown()
        self.master = None

    def _stop_agents(self) -> None:
        with self._lock:
            procs = dict(self._agent_procs)
            self._agent_procs.clear()
        for node_id, proc in procs.items():
            agent = self.master.store.agent_for(node_id) if self.master else None
            if agent is not None:
                client = RpcClient(agent["address"], agent["service"])
                client.try_call("Stop", {}, timeout=2.0)
                client.close()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    proc.kill()

    def _stop_worker(self, worker_id: str, kill_objects: bool = True) -> None:
        # Pop the proc FIRST: once it is out of _procs the elastic loop
        # cannot mistake this intentional stop for a crash.
        with self._lock:
            proc = self._procs.pop(worker_id, None)
        client = self._client_for(worker_id)
        if client is not None:
            client.try_call("Stop", {}, timeout=2.0)
            client.close()
        with self._lock:
            self._worker_clients.pop(worker_id, None)
        if proc is not None:
            if client is None:
                # Never registered (no RPC path) — don't wait out a
                # heartbeat loop that won't stop; terminate directly.
                proc.terminate()
            try:
                proc.wait(timeout=10 if client is not None else 2)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        if kill_objects and self.master is not None:
            self.master.mark_worker_dead(worker_id, reason="killed")

    # -- dynamic allocation ---------------------------------------------
    def request_workers(self, num_additional: int) -> List[str]:
        """Grow the pool (dynamic allocation)."""
        current = len(self.alive_workers())
        self.master.expect_workers(current + num_additional)
        ids = [self._spawn_worker() for _ in range(num_additional)]
        # New workers may land on nodes the initial pool never used; those
        # nodes need a store agent before any object lands there.
        with self._lock:
            new_nodes = [self._worker_nodes[wid] for wid in ids]
        self._ensure_agents(new_nodes)
        if not self.master.wait_for_workers(60.0):
            raise ClusterError("additional workers failed to register")
        return ids

    def kill_worker(self, worker_id: str) -> None:
        """Shrink the pool; the worker's non-holder objects are unlinked,
        holder-owned objects survive (shuffle-survival semantics)."""
        self._stop_worker(worker_id, kill_objects=True)

    # -- object access ----------------------------------------------------
    @property
    def resolver(self):
        """Driver-side node-aware reader: local shm for driver-node objects,
        agent fetch for everything else."""
        if self._resolver is None:
            from raydp_tpu_torch.store.resolver import ObjectResolver

            self._resolver = ObjectResolver(
                self.master.store, self.master.object_meta
            )
        return self._resolver

    # -- introspection ----------------------------------------------------
    def alive_workers(self) -> List[WorkerInfo]:
        return self.master.alive_workers() if self.master else []

    def cluster_resources(self) -> dict:
        return self.master.cluster_resources()

    def metrics_snapshot(self) -> dict:
        """Merged cluster-wide metrics: per-worker views (heartbeat-shipped
        deltas, tombstoned final snapshots for dead workers), a cross-worker
        aggregate, lifecycle events, and the driver's own registry."""
        if self.master is not None:
            return self.master.metrics_snapshot()
        from raydp_tpu_torch.utils.profiling import metrics as _m

        return {"workers": {}, "aggregate": {}, "events": [],
                "driver": _m.snapshot()}

    def prometheus_metrics(self) -> str:
        """The merged view as Prometheus text exposition v0.0.4."""
        from raydp_tpu_torch.telemetry import render_prometheus

        return render_prometheus(self.metrics_snapshot())

    def trace_report(self) -> Optional[dict]:
        """Critical path, per-rank step skew and data-wait against
        compute over the run's merged trace
        (:mod:`raydp_tpu_torch.telemetry.analyze`). Flushes the driver's
        own spans first; workers' arrive as they flush (each heartbeat
        and on exit). None unless ``RAYDP_TPU_TELEMETRY_DIR`` is set."""
        from raydp_tpu_torch.telemetry import (
            analyze,
            flush_spans,
            telemetry_dir,
        )

        directory = telemetry_dir()
        if directory is None:
            return None
        flush_spans()
        return analyze.trace_report(directory)

    def usage_report(self) -> dict:
        """Per-job usage folded from the merged view: chip-seconds (CUDA
        device seconds here), task-seconds, shuffle/staged/fetched
        bytes, each billed to the job in scope when the work ran; also
        exported as the ``raydp_job_*`` Prometheus families."""
        from raydp_tpu_torch.telemetry import accounting as _acct

        return _acct.usage_report(self.metrics_snapshot())

    def scheduler_report(self) -> dict:
        """The control plane's arbiter state: capacity, slots in use, the
        admission queue in grant order, active leases, each job's
        lifecycle state and queue-wait statistics. ``{"enabled": False,
        ...}`` while arbitration is off (``RAYDP_TPU_SCHED_CAPACITY``
        unset, the single-tenant default)."""
        from raydp_tpu_torch.control import get_arbiter

        return get_arbiter().report()

    def record_gang(self, gang: str, views: dict) -> None:
        """Bill a finished SPMD gang's final rank views with the session
        (``fit_spmd`` calls it after each launch; see
        :meth:`AppMaster.record_gang`)."""
        self.master.record_gang(gang, views)

    def events_report(self, job: Optional[str] = None) -> dict:
        """The cluster event timeline and MTTR report; also served at
        ``/debug/events``."""
        from raydp_tpu_torch.telemetry import events as _events
        from raydp_tpu_torch.telemetry import telemetry_dir

        records = _events.load_event_records(telemetry_dir(), job=job)
        return {"events": records, "mttr": _events.mttr_report(records)}

    def dashboard_report(self) -> dict:
        """The dashboard: train, ETL, serve and control sections folded
        from the merged view, the SLO table, the event timeline's tail
        with MTTR episodes, usage by job and the arbiter's state
        (:meth:`scheduler_report`) in one document
        (:mod:`raydp_tpu_torch.telemetry.dashboard`). Also served at
        ``/debug/dashboard`` and, to a second driver, by the
        ``DashboardReport`` RPC."""
        from raydp_tpu_torch.telemetry import dashboard as _dash
        from raydp_tpu_torch.telemetry import events as _events
        from raydp_tpu_torch.telemetry import telemetry_dir

        records = _events.load_event_records(telemetry_dir())
        return _dash.build(self.metrics_snapshot(),
                           scheduler=self.scheduler_report(),
                           events=records)

    def health_report(self) -> Optional[dict]:
        """Aggregated cluster health: per-worker heartbeat age and the
        watchdog stall flags shipped on heartbeats, stalled/dead/late
        worker lists, slowest-rank attribution, and the driver's own
        watchdog. None before :meth:`start`."""
        if self.master is None:
            return None
        return self.master.health_report()

    def capture_profile(self, seconds: float = 3.0,
                        out_dir: Optional[str] = None) -> Optional[dict]:
        """A trace capture across the cluster: every alive worker and the
        driver itself record a ``torch.profiler`` trace for ``seconds``
        from (nearly) the same wall instant, and the archives merge into
        one clock-aligned Perfetto file (``merged_trace.json`` under the
        returned ``out_dir``). Worker archives travel through the shm
        object store (a ref on the reply), not the control RPC. Also
        served as ``/debug/profile?seconds=N`` on the driver's metrics
        endpoint. None before :meth:`start`."""
        if self.master is None:
            return None
        from raydp_tpu_torch.telemetry import device_profiler

        payloads: Dict[str, dict] = {}
        errors: Dict[str, str] = {}

        def _one(worker_id: str) -> None:
            client = self._client_for(worker_id)
            if client is None:
                errors[worker_id] = "no client"
                return
            try:
                payloads[worker_id] = client.call(
                    "ProfileRequest", {"seconds": seconds},
                    timeout=seconds + device_profiler.WORKER_CAPTURE_SLACK_S)
            except Exception as exc:
                errors[worker_id] = str(exc)

        threads = [threading.Thread(target=_one, args=(w.worker_id,),
                                    daemon=True)
                   for w in self.alive_workers()]
        for t in threads:
            t.start()
        # The driver takes part, beside the fan-out: its loader and
        # dispatch threads are half a step's story.
        driver_payload = device_profiler.capture_trace_archive(seconds)
        driver_payload["worker_id"] = "driver"
        for t in threads:
            t.join(timeout=seconds
                   + device_profiler.WORKER_CAPTURE_SLACK_S + 30.0)
        ordered = [driver_payload] + [payloads[w] for w in sorted(payloads)]
        for payload in ordered:  # store-shipped archives -> bytes
            ref = payload.pop("ref", None)
            if ref is not None and "zip" not in payload:
                payload["zip"] = self.resolver.get_bytes(ref)
        merged = device_profiler.merge_rank_traces(ordered, out_dir)
        if errors:
            merged["errors"] = errors
        return merged

    def progress_report(self) -> dict:
        """Live stage progress — in-flight stages with done/total task
        counts, recently completed stages, and stage-store totals."""
        if self.master is not None:
            return self.master.progress_report()
        from raydp_tpu_torch.telemetry.progress import progress, stage_store

        report = progress.report()
        report["stage_totals"] = stage_store.snapshot()["totals"]
        return report

    # -- task submission --------------------------------------------------
    def submit(
        self,
        fn: Callable,
        *args,
        worker_id: Optional[str] = None,
        timeout: float = 300.0,
        **kwargs,
    ) -> Any:
        """Run ``fn(worker_ctx, *args, **kwargs)`` on one worker."""
        return self.submit_async(
            fn, *args, worker_id=worker_id, timeout=timeout, **kwargs
        ).result()

    def submit_async(
        self,
        fn: Callable,
        *args,
        worker_id: Optional[str] = None,
        timeout: float = 300.0,
        retries: int = 2,
        data_args: Sequence = (),
        meta_sink: Optional[Callable] = None,
        **kwargs,
    ) -> Future:
        """Run ``fn(worker_ctx, *args, *data_args, **kwargs)`` on a worker.

        ``data_args`` (Arrow tables) move through the shm object store:
        the tables are written into the driver's store here and only
        their ObjectRefs are shipped in the RunTask envelope — a
        co-located worker maps them zero-copy, a remote one streams them
        from this node's agent in bounded chunks. The control-plane
        payload stays O(refs) regardless of table size.
        """
        staged = self._stage_data_args(data_args)
        payload = {
            "fn": closure.dumps(fn),
            "args": args,
            "kwargs": kwargs,
        }
        if staged:
            payload["data_refs"] = staged
        # The RunTask RPC leaves from a pool thread: capture the
        # submitting thread's trace context and job here, so the task
        # span parents under e.g. the driver's stage span and the task
        # bills the submitter's job.
        from raydp_tpu_torch.telemetry import accounting as _acct
        from raydp_tpu_torch.telemetry import propagation as _prop

        trace_ctx = _prop.current_context()
        job_ctx = _acct.current_job()

        def run():
            preferred = worker_id
            last: Optional[BaseException] = None
            for attempt in range(retries + 1):
                try:
                    target = self._pick_worker(preferred)
                except ClusterError as exc:
                    # Preferred worker gone (or none alive yet — elastic
                    # respawn may still be bringing one back).
                    last = exc
                    preferred = None
                    time.sleep(0.3 * (attempt + 1))
                    continue
                client = self._client_for(target)
                if client is None:
                    preferred = None
                    last = ClusterError(f"worker {target} is gone")
                    continue
                try:
                    reply = client.call("RunTask", payload, timeout=timeout)
                    if meta_sink is not None:
                        try:
                            meta_sink(0, target, reply.get("exec_s", 0.0))
                        except Exception:
                            pass  # stats sink must never fail the task
                    return reply["result"]
                except RpcUnavailable as exc:
                    # A worker that is gone (connection refused or
                    # dropped with our call in flight) makes the
                    # idempotent stage task retriable elsewhere; a
                    # deadline (RpcTimeout) is a slow task on a healthy
                    # worker and must not unlink its objects or re-run
                    # the work. ...except when WE initiated the teardown:
                    # re-running tasks on surviving workers would
                    # duplicate side effects and stall the teardown.
                    if self._elastic_stop.is_set():
                        raise ClusterError(
                            f"task RPC to worker {target} failed: {exc} "
                            "(cluster is shutting down)"
                        ) from exc
                    if (not isinstance(exc, RpcTimeout)
                            and self.master is not None):
                        self.master.mark_worker_dead(
                            target, reason="worker unreachable"
                        )
                        last = ClusterError(
                            f"task RPC to worker {target} failed: {exc}"
                        )
                        preferred = None
                        continue  # idempotent stage task: retry elsewhere
                    raise ClusterError(
                        f"task RPC to worker {target} failed: {exc}"
                    ) from exc
            raise ClusterError(
                f"task failed after {retries + 1} attempts: {last}"
            ) from last

        def run_and_discard():
            try:
                with _prop.propagated(trace_ctx), _acct.job_scope(job_ctx):
                    return run()
            finally:
                # Staged data_args are scratch: the worker has consumed
                # them (re-put under its own ownership where needed) by
                # the time the RPC returns. Unlink keeps driver shm flat.
                self._discard_staged(staged)

        return self._pool.submit(run_and_discard)

    def map_tasks(
        self,
        fn: Callable,
        items: List[Any],
        timeout: float = 300.0,
    ) -> List[Any]:
        """Run ``fn(ctx, item)`` for each item, load-balanced round-robin
        over alive workers; preserves order."""
        futures = [
            self.submit_async(fn, item, timeout=timeout) for item in items
        ]
        return [f.result() for f in futures]

    # -- batched submission (one envelope per worker) ---------------------
    def submit_batch(
        self,
        specs: Sequence[TaskSpec],
        timeout: float = 300.0,
        retries: int = 2,
        meta_sink: Optional[Callable] = None,
    ) -> List[Future]:
        """Run many tasks with ONE RunTaskBatch envelope per worker.

        Tasks are grouped by their (locality-preferred) target worker and
        each group ships as a single RPC carrying all of that worker's
        tasks — per-call RPC + pickle overhead is paid once per worker
        instead of once per partition. Each distinct ``fn`` is serialized
        once per envelope. Returns one Future per spec, in order; a
        future resolves as soon as its worker's envelope lands, so
        callers can stream per-task completions (``add_done_callback``)
        instead of waiting for the slowest worker.

        Worker death fails only that worker's envelope; its tasks are
        reassigned to surviving workers (stage tasks are idempotent),
        up to ``retries`` rounds.

        ``meta_sink(spec_index, worker_id, exec_s)`` — optional per-task
        completion callback carrying the executing worker and its
        measured task seconds (stage-stats attribution); invoked before
        the matching future resolves.
        """
        futures: List[Future] = [Future() for _ in specs]
        if not specs:
            return futures
        from raydp_tpu_torch.telemetry import accounting as _acct
        from raydp_tpu_torch.telemetry import propagation as _prop

        trace_ctx = _prop.current_context()
        job_ctx = _acct.current_job()

        def orchestrate():
            with _prop.propagated(trace_ctx), _acct.job_scope(job_ctx):
                try:
                    self._run_batch(
                        list(specs), futures, timeout, retries, meta_sink
                    )
                except BaseException as exc:  # noqa: BLE001 - fan to futures
                    for f in futures:
                        if not f.done():
                            f.set_exception(exc)

        self._pool.submit(orchestrate)
        return futures

    def _run_batch(
        self,
        specs: List[TaskSpec],
        futures: List[Future],
        timeout: float,
        retries: int,
        meta_sink: Optional[Callable] = None,
    ) -> None:
        staged = [self._stage_data_args(s.data_args) for s in specs]
        try:
            pending = list(range(len(specs)))
            last: Optional[BaseException] = None
            for attempt in range(retries + 1):
                groups: Dict[str, List[int]] = {}
                try:
                    for i in pending:
                        target = self._resolve_batch_target(
                            specs[i], attempt
                        )
                        groups.setdefault(target, []).append(i)
                except ClusterError as exc:
                    # No alive workers (elastic respawn may still be
                    # bringing one back) — wait and retry the round.
                    last = exc
                    time.sleep(0.3 * (attempt + 1))
                    continue
                results: Dict[str, Any] = {}
                threads = []
                for wid, idxs in groups.items():
                    t = threading.Thread(
                        target=self._call_batch_into,
                        args=(results, wid, idxs, specs, staged, timeout,
                              futures, meta_sink),
                        name=f"raydp-batch-{wid}",
                        daemon=True,
                    )
                    t.start()
                    threads.append(t)
                # Futures resolve INSIDE each envelope thread the moment
                # its worker replies (per-envelope streaming); this join
                # only gates the retry round on the stragglers.
                for t in threads:
                    t.join()
                next_pending: List[int] = []
                for wid, idxs in groups.items():
                    outcome = results.get(wid)
                    if outcome is _BATCH_RESOLVED:
                        continue
                    if isinstance(outcome, _WorkerGone):
                        last = ClusterError(str(outcome))
                        next_pending.extend(idxs)
                        continue
                    if isinstance(outcome, BaseException):
                        raise outcome
                    raise ClusterError(
                        f"batch envelope to {wid} vanished without an "
                        f"outcome"
                    )
                pending = next_pending
                if not pending:
                    return
            for i in pending:
                if not futures[i].done():
                    futures[i].set_exception(
                        ClusterError(
                            f"batched task failed after {retries + 1} "
                            f"attempts: {last}"
                        )
                    )
        finally:
            for refs in staged:
                self._discard_staged(refs)

    def _resolve_batch_target(self, spec: TaskSpec, attempt: int) -> str:
        """Placement for one batched task: the preferred worker on the
        first attempt, then any alive worker on the spec's hint node
        (``node_id`` — keeps shuffle merges next to their bytes when the
        chosen worker died), then plain round-robin. Raises ClusterError
        when nothing is alive."""
        if attempt == 0 and spec.worker_id is not None:
            try:
                return self._pick_worker(spec.worker_id)
            except ClusterError:
                pass  # preferred worker gone; fall through to the node
        if spec.node_id is not None:
            node_workers = sorted(
                w.worker_id
                for w in self.alive_workers()
                if w.node_id == spec.node_id
            )
            if node_workers:
                return node_workers[next(self._rr) % len(node_workers)]
        return self._pick_worker(None)

    def _call_batch_into(
        self,
        results: Dict[str, Any],
        worker_id: str,
        idxs: List[int],
        specs: List[TaskSpec],
        staged: List[List[Any]],
        timeout: float,
        futures: Optional[List[Future]] = None,
        meta_sink: Optional[Callable] = None,
    ) -> None:
        """One RunTaskBatch envelope to one worker. On success the
        envelope's futures resolve HERE, the moment this worker replies
        — not after every worker's thread is joined — so downstream
        completion callbacks (streaming stages, ingest) fire while
        slower envelopes are still running. ``results`` then carries the
        resolved sentinel; failures (_WorkerGone / hard error) still
        land there for the retry loop."""
        try:
            client = self._client_for(worker_id)
            if client is None:
                raise _WorkerGone(f"worker {worker_id} is gone")
            fn_blobs: List[bytes] = []
            fn_index: Dict[int, int] = {}  # id(fn) -> slot, dedup per envelope
            tasks = []
            for i in idxs:
                spec = specs[i]
                slot = fn_index.get(id(spec.fn))
                if slot is None:
                    slot = len(fn_blobs)
                    fn_blobs.append(closure.dumps(spec.fn))
                    fn_index[id(spec.fn)] = slot
                task = {"fn": slot, "args": spec.args, "kwargs": spec.kwargs}
                if staged[i]:
                    task["data_refs"] = staged[i]
                tasks.append(task)
            payload = {"fns": fn_blobs, "tasks": tasks}
            try:
                reply = client.call("RunTaskBatch", payload, timeout=timeout)
            except RpcUnavailable as exc:
                if self._elastic_stop.is_set():
                    raise ClusterError(
                        f"batch RPC to worker {worker_id} failed: {exc} "
                        "(cluster is shutting down)"
                    ) from exc
                # Same death taxonomy as submit_async: a worker that is
                # gone makes the idempotent stage tasks re-runnable
                # elsewhere; a deadline is a hard error.
                if (not isinstance(exc, RpcTimeout)
                        and self.master is not None):
                    self.master.mark_worker_dead(
                        worker_id, reason="worker unreachable"
                    )
                    raise _WorkerGone(
                        f"batch RPC to worker {worker_id} failed: {exc}"
                    ) from exc
                raise ClusterError(
                    f"batch RPC to worker {worker_id} failed: {exc}"
                ) from exc
            res_list = reply["results"]
            if futures is None:
                results[worker_id] = res_list
                return
            for i, res in zip(idxs, res_list):
                if res.get("ok"):
                    if meta_sink is not None:
                        try:
                            meta_sink(i, worker_id, res.get("exec_s", 0.0))
                        except Exception:
                            pass  # sink must never fail the batch
                    futures[i].set_result(res.get("value"))
                else:
                    futures[i].set_exception(
                        RpcError(
                            f"batched task failed on {worker_id}: "
                            f"{res.get('error')}\n"
                            f"{res.get('traceback', '')}"
                        )
                    )
            results[worker_id] = _BATCH_RESOLVED
        except BaseException as exc:  # noqa: BLE001 - marshalled to caller
            results[worker_id] = exc

    # -- data-plane staging ----------------------------------------------
    def _stage_data_args(self, tables: Sequence) -> List[Any]:
        """Write Arrow tables into the driver-node store; only the refs
        ride the control plane."""
        if not tables:
            return []
        from raydp_tpu_torch.telemetry import accounting as _acct

        store = self.master.store
        refs = [store.put_arrow_table(t) for t in tables]
        _acct.add_usage(_acct.STAGED_BYTES, sum(r.size for r in refs))
        return refs

    def _discard_staged(self, refs: Sequence) -> None:
        if not refs or self.master is None:
            return
        for ref in refs:
            try:
                self.master.store.delete(ref)
            except Exception:  # pragma: no cover - scratch cleanup
                pass

    def _pick_worker(self, worker_id: Optional[str]) -> str:
        workers = self.alive_workers()
        if not workers:
            raise ClusterError("no alive workers")
        if worker_id is not None:
            if not any(w.worker_id == worker_id for w in workers):
                raise ClusterError(f"worker {worker_id} not alive")
            return worker_id
        return workers[next(self._rr) % len(workers)].worker_id

    def _client_for(self, worker_id: str) -> Optional[RpcClient]:
        with self._lock:
            client = self._worker_clients.get(worker_id)
            if client is not None:
                return client
        info = next(
            (w for w in self.alive_workers() if w.worker_id == worker_id), None
        )
        if info is None:
            return None
        client = RpcClient(info.address, "raydp.Worker")
        with self._lock:
            winner = self._worker_clients.setdefault(worker_id, client)
        if winner is not client:  # lost a create race; drop our channel
            client.close()
        return winner


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() or c == "-" else "-" for c in name.lower())


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
