"""ETL worker process entry point (the port's copy of
``raydp_tpu/cluster/worker_main.py``).

Role parity with the reference's executor backend
(reference: core/.../executor/RayCoarseGrainedExecutorBackend.scala:38-262):
a separately spawned process that registers with the AppMaster (with
retries, :58-81), runs tasks shipped from the driver, heartbeats, and
exits on Stop or on master disappearance.

Tasks are callables ``fn(worker_ctx, *args)`` carried by
:mod:`raydp_tpu_torch.cluster.closure` (the reference ships them
cloudpickled). A worker loads each distinct blob once: a stage's
closure reaches it once per envelope and is reused from a small cache
by its bytes. Results return inline; large Arrow results go through the
shm object store and return ObjectRefs.

The process imports no torch: its launch env hides every CUDA device
(``CUDA_VISIBLE_DEVICES=""``), and the engine's modules it loads import
pyarrow and numpy only. The fault plan's hooks run here as in the
reference (``raydp_tpu/cluster/worker_main.py:289-295, 435-441``): every
task start is counted and offered to ``kill worker=…,task=K``, and an
``hb_stall`` clause skips heartbeats.

Telemetry (``raydp_tpu/cluster/worker_main.py:31-36, 134, 252-370,
430-475, 522-562``): the process joins the driver's trace and job from
its launch env, arms the flight recorder (component ``worker``), the
trace-stamped JSONL logs and the watchdog; every task runs in a
``worker/task`` span and watchdog bracket and bills its seconds to the
caller's job (``task_seconds``); a batch's trace context and job are
carried onto the task pool's threads. Each heartbeat ships the registry
sections that changed (rolled back when the beat is missed), the
watchdog's stall flags, and flushes the span ring to this process's
shard; ``WorkerStopped`` carries the full final snapshot.
``RAYDP_TPU_DEBUG_PORT`` serves this worker's ``/metrics``, ``/healthz``
and ``/debug/*``.
"""
from __future__ import annotations

import argparse
import atexit
import logging
import os
import sys
import threading
import time
import traceback
from collections import OrderedDict

from raydp_tpu_torch import fault
from raydp_tpu_torch.cluster import closure
from raydp_tpu_torch.cluster.rpc import RpcClient, RpcServer
from raydp_tpu_torch.store.object_store import ObjectStore
from raydp_tpu_torch.telemetry import MetricsShipper, flush_spans, span
from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import flight_recorder as _flight
from raydp_tpu_torch.telemetry import logs as _logs
from raydp_tpu_torch.telemetry import propagation as trace_prop
from raydp_tpu_torch.telemetry import watchdog as _watchdog
from raydp_tpu_torch.utils.profiling import metrics, sample_resource_gauges

logger = logging.getLogger(__name__)

WORKER_SERVICE = "raydp.Worker"
REGISTER_RETRIES = 3
# Completed-task replies kept for duplicate-delivery detection. Sized
# for the realistic retry window (seconds), not task history.
_DEDUP_CAPACITY = 1024
# A duplicate that arrives while the original is still executing waits
# this long for the first execution to finish before giving up.
_DEDUP_WAIT_S = 300.0
# Loaded task functions kept by blob: a stage's closure arrives in every
# envelope of the stage and is loaded once.
_FN_CACHE_CAPACITY = 64


class WorkerContext:
    """Handed to every shipped task as its first argument."""

    def __init__(self, worker_id: str, node_id: str, store: ObjectStore,
                 master: RpcClient):
        self.worker_id = worker_id
        self.node_id = node_id
        self.store = store
        self._master = master
        from raydp_tpu_torch.store.resolver import ObjectResolver

        self.resolver = ObjectResolver(store, self._object_meta)

    def _object_meta(self, object_id: str):
        reply = self._master.call("GetObjectMeta", {"object_id": object_id})
        return reply.get("ref"), reply.get("agent")

    def put_table(self, table, holder: bool = False):
        """Store an Arrow table; returns ObjectRef.

        Owned by this worker by default (dies with it); ``holder=True``
        writes it holder-owned up front (ingest data that must survive pool
        shrinks). The ref is registered in the master's object directory so
        owner lifetime is enforced cluster-wide (reference: executor-side
        Ray.put with optional owner, ObjectStoreWriter.scala:58-79).
        """
        from raydp_tpu_torch.store.object_store import OWNER_HOLDER

        owner = OWNER_HOLDER if holder else self.worker_id
        ref = self.store.put_arrow_table(table, owner=owner)
        self._master.call("RegisterObject", {"ref": ref})
        return ref

    def put_bytes(self, data) -> "ObjectRef":
        ref = self.store.put(data, owner=self.worker_id)
        self._master.call("RegisterObject", {"ref": ref})
        return ref

    def get_table(self, ref):
        """Read an Arrow table from anywhere in the cluster: local shm
        zero-copy, or a pull from the owning node's store agent."""
        return self.resolver.get_arrow_table(ref)

    def get_bytes(self, ref):
        return self.resolver.get_bytes(ref)


class Worker:
    def __init__(self, worker_id: str, master_address: str, node_id: str,
                 resources: dict, bind_host: str = "127.0.0.1"):
        self.worker_id = worker_id
        self.node_id = node_id
        self.resources = resources
        # Generous default timeout: control RPCs (RegisterObject) must
        # survive a driver process saturated by a big shuffle on a small
        # host — a slow master is not a dead master.
        self.master = RpcClient(
            master_address, "raydp.AppMaster", timeout=120.0
        )
        self.store: ObjectStore = None  # namespace learned at registration
        self.ctx: WorkerContext = None
        self._stop_event = threading.Event()
        # Tasks in flight right now. A worker mid-task must never decide
        # the master is gone and exit: on a core-starved host heartbeat
        # round-trips stall for tens of seconds precisely WHILE tasks
        # run, and a mid-task exit cancels the in-flight RunTask on the
        # driver side.
        self._busy = 0
        self._busy_lock = threading.Lock()
        # Tasks started by this process, for the fault plan's task=K.
        self._task_seq = 0
        # At-most-once execution for id-carrying tasks: request_id ->
        # {"done": Event, "reply": dict | None, "error": str | None}.
        # A retry that re-delivers an envelope this process already saw
        # waits for (or returns) the first execution's outcome instead
        # of running the fn twice. Bounded: oldest entries age out past
        # _DEDUP_CAPACITY.
        self._dedup: "OrderedDict[str, dict]" = OrderedDict()
        self._dedup_lock = threading.Lock()
        # blob -> loaded function, most recently used last.
        self._fns: "OrderedDict[bytes, object]" = OrderedDict()
        self._fns_lock = threading.Lock()
        # Each heartbeat carries the registry sections that changed
        # since the previous beat (a delta-encoded snapshot).
        self._shipper = MetricsShipper()
        # The RPC server is up before registration completes, and the master
        # lists this worker ALIVE the moment RegisterWorker returns — so a
        # task can arrive while ctx is still being built. Gate on readiness.
        self._ready = threading.Event()
        # Batched tasks run concurrently on this pool (pyarrow releases
        # the GIL for the heavy kernels, so same-worker tasks in one
        # envelope keep the intra-worker parallelism that per-partition
        # RPCs would get from separate handler threads).
        self._task_pool = None
        self._task_pool_lock = threading.Lock()
        self._server = RpcServer(
            WORKER_SERVICE,
            {
                "RunTask": self._on_run_task,
                "RunTaskBatch": self._on_run_task_batch,
                "Ping": lambda req: {"pong": True, "worker_id": self.worker_id},
                "ProfileRequest": self._on_profile,
                "Stop": self._on_stop,
            },
            host=bind_host,
        )

    def register(self) -> None:
        last_exc = None
        for attempt in range(REGISTER_RETRIES):
            try:
                reply = self.master.call(
                    "RegisterWorker",
                    {
                        "worker_id": self.worker_id,
                        "address": self._server.address,
                        "pid": os.getpid(),
                        "node_id": self.node_id,
                        "resources": self.resources,
                    },
                )
                namespace = reply["namespace"]
                self.store = ObjectStore(
                    namespace=namespace, node_id=self.node_id
                )
                from raydp_tpu_torch.store.object_store import (
                    set_current_resolver,
                    set_current_store,
                )

                set_current_store(self.store)
                self.ctx = WorkerContext(
                    self.worker_id, self.node_id, self.store, self.master
                )
                set_current_resolver(self.ctx.resolver)
                self._ready.set()
                return
            except Exception as exc:
                last_exc = exc
                time.sleep(0.5 * (attempt + 1))
        raise RuntimeError(
            f"worker {self.worker_id} failed to register after "
            f"{REGISTER_RETRIES} attempts: {last_exc}"
        )

    def _load_fn(self, blob: bytes):
        """The function ``blob`` carries, loaded once per distinct blob."""
        with self._fns_lock:
            fn = self._fns.get(blob)
            if fn is not None:
                self._fns.move_to_end(blob)
                return fn
        fn = closure.loads(blob)
        with self._fns_lock:
            self._fns[blob] = fn
            while len(self._fns) > _FN_CACHE_CAPACITY:
                self._fns.popitem(last=False)
        metrics.counter_add("worker/fn_loads")
        return fn

    def _on_run_task(self, req: dict) -> dict:
        rid = req.get("request_id")
        if rid is None:
            return self._execute_task(req)
        with self._dedup_lock:
            entry = self._dedup.get(rid)
            owner = entry is None
            if owner:
                entry = {
                    "done": threading.Event(), "reply": None, "error": None,
                }
                self._dedup[rid] = entry
                while len(self._dedup) > _DEDUP_CAPACITY:
                    self._dedup.popitem(last=False)
            else:
                self._dedup.move_to_end(rid)
        if not owner:
            # Re-delivery of an envelope this process already has:
            # return the first execution's outcome (waiting it out if
            # still in flight) — never run the fn a second time.
            metrics.counter_add("worker/dup_tasks")
            if not entry["done"].wait(timeout=_DEDUP_WAIT_S):
                raise RuntimeError(
                    f"duplicate delivery of task {rid}: original "
                    f"execution still in flight after {_DEDUP_WAIT_S:.0f}s"
                )
            if entry["error"] is not None:
                raise RuntimeError(entry["error"])
            return entry["reply"]
        try:
            reply = self._execute_task(req)
        except Exception as exc:
            entry["error"] = f"{type(exc).__name__}: {exc}"
            entry["done"].set()
            raise
        entry["reply"] = reply
        entry["done"].set()
        return reply

    def _execute_task(self, req: dict) -> dict:
        # Busy goes up FIRST: between this handler starting and fn
        # deserializing, the heartbeat thread must already see the task
        # — an exit decision in that setup window would cancel it.
        with self._busy_lock:
            self._busy += 1
        try:
            if not self._ready.wait(timeout=15.0):
                raise RuntimeError(
                    "worker context not ready (registration hung)"
                )
            fn = self._load_fn(req["fn"])
            args = req.get("args", ())
            kwargs = req.get("kwargs", {})
            # data_args travel the data plane: the envelope carries refs,
            # the tables are resolved here (zero-copy from local shm when
            # co-located with the submitter, chunked agent fetch if not).
            data = self._resolve_data_refs(req.get("data_refs", ()))
            self._fault_task_hook()
            metrics.counter_add("worker/tasks")
            _flight.record("task", "start", worker_id=self.worker_id)
            # The RPC server runs this handler in the caller's trace
            # context and job scope, so the task span joins the driver's
            # trace under the submitting stage span, and its seconds
            # bill to the caller's job. A wedged body shows in the
            # watchdog as "worker/task", at the long-op threshold.
            t0 = time.perf_counter()
            with _watchdog.inflight(
                "worker/task", worker_id=self.worker_id,
                stall_after_s=_watchdog.long_stall_s(),
            ):
                with span("worker/task", worker_id=self.worker_id):
                    with metrics.timer("worker/task").time():
                        result = fn(self.ctx, *args, *data, **kwargs)
            _flight.record("task", "end", worker_id=self.worker_id)
            exec_s = time.perf_counter() - t0
            _acct.add_usage(_acct.TASK_SECONDS, exec_s)
            return {"result": result, "exec_s": exec_s}
        finally:
            with self._busy_lock:
                self._busy -= 1

    def _resolve_data_refs(self, refs):
        return [self.ctx.get_table(r) for r in refs]

    def _fault_task_hook(self) -> None:
        """Count a task start (0-based, per process) and offer it to the
        fault plan (``kill worker=…,task=K``)."""
        with self._busy_lock:
            seq = self._task_seq
            self._task_seq += 1
        if fault.active():
            fault.on_task(self.worker_id, seq)

    def _pool(self):
        with self._task_pool_lock:
            if self._task_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._task_pool = ThreadPoolExecutor(
                    max_workers=max(4, os.cpu_count() or 4),
                    thread_name_prefix=f"{self.worker_id}-task",
                )
            return self._task_pool

    def _on_run_task_batch(self, req: dict) -> dict:
        """One envelope, many tasks (the driver's submit_batch).

        Each distinct fn arrives once in ``fns``; tasks reference it by
        slot. Tasks run concurrently on the worker task pool and each
        reports per-task ``{"ok": ...}`` so one bad partition fails only
        its own future, not its siblings in the envelope.
        """
        with self._busy_lock:
            self._busy += 1
        try:
            if not self._ready.wait(timeout=15.0):
                raise RuntimeError(
                    "worker context not ready (registration hung)"
                )
            fns = [self._load_fn(b) for b in req["fns"]]
            tasks = req.get("tasks", ())
            metrics.counter_add("worker/tasks", len(tasks))
            metrics.counter_add("worker/task_batches")
            _flight.record("task", "batch_start", worker_id=self.worker_id,
                           tasks=len(tasks))
            # The task pool's threads do not inherit this handler
            # thread's trace context and job: carry both over, so each
            # task's span parents under the driver's stage span.
            batch_ctx = trace_prop.current_context()
            batch_job = _acct.current_job()

            def run_one(task: dict) -> dict:
                try:
                    fn = fns[task["fn"]]
                    args = task.get("args", ())
                    kwargs = task.get("kwargs", {})
                    data = self._resolve_data_refs(task.get("data_refs", ()))
                    self._fault_task_hook()
                    t0 = time.perf_counter()
                    with trace_prop.propagated(batch_ctx), \
                            _acct.job_scope(batch_job):
                        with span("worker/task", worker_id=self.worker_id):
                            with metrics.timer("worker/task").time():
                                value = fn(self.ctx, *args, *data, **kwargs)
                        exec_s = time.perf_counter() - t0
                        _acct.add_usage(_acct.TASK_SECONDS, exec_s)
                    return {"ok": True, "value": value, "exec_s": exec_s}
                except Exception as exc:
                    return {
                        "ok": False,
                        "error": f"{type(exc).__name__}: {exc}",
                        "traceback": traceback.format_exc(),
                    }

            with _watchdog.inflight(
                "worker/task", worker_id=self.worker_id,
                stall_after_s=_watchdog.long_stall_s(),
            ):
                if len(tasks) == 1:
                    results = [run_one(tasks[0])]
                else:
                    results = list(self._pool().map(run_one, tasks))
            _flight.record("task", "batch_end", worker_id=self.worker_id,
                           tasks=len(tasks))
            return {"results": results}
        finally:
            with self._busy_lock:
                self._busy -= 1

    def _on_profile(self, req: dict) -> dict:
        """A trace capture on this ETL worker, on the RPC handler thread
        beside any tasks in flight. The zip ships through the shm object
        store once the worker is registered (``{"ref": ...}``), inline
        before. The capture loads torch (its profiler) into the worker,
        which ETL tasks alone never do."""
        from raydp_tpu_torch.telemetry import device_profiler

        seconds = float(req.get("seconds", 3.0))
        _flight.record("profile", "start", worker_id=self.worker_id,
                       seconds=seconds)
        payload = device_profiler.capture_trace_archive(seconds)
        payload["worker_id"] = self.worker_id
        if self._ready.is_set():
            blob = payload.pop("zip")
            try:
                payload["ref"] = self.ctx.put_bytes(blob)
            except Exception:
                payload["zip"] = blob  # store unavailable: inline
        _flight.record("profile", "end", worker_id=self.worker_id)
        return payload

    def _on_stop(self, req: dict) -> dict:
        # Non-transferred objects die with the worker; the master unlinks
        # them on WorkerStopped/death.
        self._stop_event.set()
        return {"stopping": True}

    def _serve_debug(self):
        """This worker's ``/metrics``, ``/healthz`` and ``/debug/*`` when
        ``RAYDP_TPU_DEBUG_PORT`` is set (0: an ephemeral port, logged)."""
        from raydp_tpu_torch.telemetry import (
            DEBUG_PORT_ENV,
            render_prometheus,
            serve_prometheus,
        )

        port = os.environ.get(DEBUG_PORT_ENV)
        if port is None:
            return None
        try:
            return serve_prometheus(
                lambda: render_prometheus(
                    {"workers": {self.worker_id: metrics.snapshot()}}
                ),
                int(port),
            )
        except Exception:
            logger.exception("worker debug endpoint failed to start")
            return None

    def _beat(self) -> dict:
        """A heartbeat's body: the metrics delta and any stall flags."""
        beat = {"worker_id": self.worker_id}
        try:
            sample_resource_gauges()
        except Exception:
            metrics.counter_add("telemetry/gauge_errors")
        delta = self._shipper.delta()
        if delta:
            beat["metrics"] = delta
        # Stall flags reach the master's health_report() on a live beat,
        # long before a heartbeat timeout: a wedged task does not stop
        # this thread.
        health = _watchdog.health()
        if not health.get("healthy", True):
            beat["health"] = {"stalls": health.get("stalls", {})}
        return beat

    def run(self) -> None:
        self.register()
        _flight.record("state", "registered", worker_id=self.worker_id)
        debug_server = self._serve_debug()
        missed = 0
        beat_index = 0
        while not self._stop_event.wait(2.0):
            beat_index += 1
            # A plan's hb_stall clause skips this beat, so the master's
            # liveness monitor sees a partitioned host.
            if fault.active() and fault.on_heartbeat(beat_index - 1,
                                                     worker=self.worker_id):
                continue
            beat = self._beat()
            reply = self.master.try_call("Heartbeat", beat, timeout=8.0)
            # One shard write a beat (a no-op without a telemetry dir):
            # the driver's trace_report() sees this worker's spans at
            # heartbeat latency, and a SIGKILL loses at most one beat.
            flush_spans()
            with self._busy_lock:
                busy = self._busy > 0
            if reply is None:
                _flight.record("heartbeat", "missed", missed=missed + 1)
                # A missed beat must not eat its metrics delta: the
                # sections ship again on the next beat.
                self._shipper.rollback(beat.get("metrics"))
                # Transient master hiccups — including a driver process
                # saturated by a big shuffle on a small host — are
                # absorbed; only a sustained outage means exit. And never
                # while a task is executing: exiting here cancels the
                # very task the driver is waiting on.
                missed += 1
                if missed >= 8 and not busy:
                    logger.warning(
                        "worker %s: master unreachable for %d beats; exiting",
                        self.worker_id, missed,
                    )
                    break
                if missed >= 60:
                    # Hard cap even while busy: with the driver gone AND
                    # the task wedged, nothing else can ever end this
                    # process; without a bound it would orphan forever
                    # with its shm segments.
                    logger.error(
                        "worker %s: master unreachable for %d beats with "
                        "a task still in flight; exiting to avoid an "
                        "immortal orphan", self.worker_id, missed,
                    )
                    break
                continue
            missed = 0
            if not reply.get("known", False):
                if busy:
                    # The master wrote us off but the driver's task RPC to
                    # us is still open — finish it; the result makes it
                    # back on that same connection. Exit once idle.
                    logger.warning(
                        "worker %s: master disowned us mid-task; finishing "
                        "in-flight work before exiting", self.worker_id,
                    )
                    continue
                # Master explicitly wrote us off — exit now (parity with
                # executor exit on AppMaster disconnect).
                logger.warning("worker %s: master disowned us; exiting",
                               self.worker_id)
                break
        # The full final snapshot, not a delta: a clean exit leaves the
        # master's tombstoned view complete even if a delta was lost.
        self.master.try_call(
            "WorkerStopped",
            {"worker_id": self.worker_id, "metrics": self._shipper.full()},
            timeout=2.0,
        )
        _flight.record("state", "stopping", worker_id=self.worker_id)
        flush_spans()
        if debug_server is not None:
            debug_server.close()
        with self._task_pool_lock:
            if self._task_pool is not None:
                self._task_pool.shutdown(wait=False)
        self._server.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--master", required=True)
    parser.add_argument("--node-id", default="node-0")
    parser.add_argument("--cores", type=float, default=1.0)
    parser.add_argument("--memory", type=float, default=0.0)
    parser.add_argument("--bind-host", default="127.0.0.1")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format=f"[{args.worker_id}] %(levelname)s %(message)s",
    )
    # Join the driver's trace and job (RAYDP_TPU_TRACEPARENT and
    # RAYDP_TPU_JOB in the launch env) before any span or usage is
    # recorded; arm the postmortem bundles (crash, SIGTERM), the JSONL
    # logs and the watchdog; flush tail spans at interpreter exit.
    trace_prop.adopt_env_context()
    _acct.adopt_env_job()
    _flight.install(component="worker")
    _logs.install()
    _watchdog.ensure_started()
    atexit.register(flush_spans)
    worker = Worker(
        args.worker_id,
        args.master,
        args.node_id,
        {"cpu": args.cores, "memory": args.memory},
        bind_host=args.bind_host,
    )
    try:
        worker.run()
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
