"""Client mode: a second driver attaching to a live AppMaster (the port's
copy of ``raydp_tpu/cluster/client.py``).

Parity with the reference's Ray-client story, where every test runs both
direct and through ``ray://`` (reference: python/raydp/tests/
conftest.py:42-49) and a driver can live inside another process
(test_spark_cluster.py:38-57). The whole control plane already speaks
the RPC layer (``cluster/rpc.py``), so a remote driver is a set of thin
proxies:

  * object writes → ``PutObject`` on the master (driver-node store);
  * object reads  → the standard resolver (master directory → node agent
    ``FetchObjectChunk``; the client has no shm mapping of its own, so
    every read is remote);
  * stage tasks   → shipped straight to workers' RunTask endpoints through
    the closure carrier (``cluster/closure.py``), with the same retry
    discipline as the in-process Cluster;
  * lifecycle RPCs (ListWorkers, ClusterResources, TransferToHolder…) →
    the master service.

``raydp_tpu_torch.connect(addr)`` installs a ClientSession as the
process session, so the DataFrame/MLDataset/estimator surface works
unchanged. Disconnecting never tears the remote cluster down.

The reports (``raydp_tpu/cluster/client.py:193-233, 293-376``):
``metrics_snapshot``, ``health_report``, ``usage_report``,
``events_report`` and ``progress_report`` are the master's, through its
RPCs; ``prometheus_metrics`` renders the remote view here, and
``trace_report`` analyses the telemetry dir this client shares with the
session. Task submissions carry the submitting thread's trace context
onto the pool threads that send them. ``dashboard_report`` is the
master's too (``DashboardReport``), and so is ``scheduler_report``
(``SchedulerReport``, the session's arbiter; ``raydp_tpu/cluster/
client.py:211, 338-345``), retried as an idempotent read;
``capture_profile`` fans the profile request to the workers from here
and merges their traces. A master RPC's retries and backoff read
``RAYDP_TPU_CLIENT_RETRIES`` and ``RAYDP_TPU_CLIENT_BACKOFF_S`` per call.
"""
from __future__ import annotations

import itertools
import logging
import os
import random
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import pyarrow as pa

from raydp_tpu_torch.cluster import closure
from raydp_tpu_torch.cluster.master import SERVICE, WorkerInfo
from raydp_tpu_torch.cluster.rpc import (
    RpcClient,
    RpcError,
    RpcTimeout,
    RpcUnavailable,
)
from raydp_tpu_torch.store.object_store import OWNER_HOLDER, ObjectRef
from raydp_tpu_torch.store.resolver import ObjectResolver

logger = logging.getLogger(__name__)


#: Retries of an idempotent master RPC, and the first retry's delay,
#: read per call (``raydp_tpu/cluster/client.py:62-74``).
CLIENT_RETRIES_ENV = "RAYDP_TPU_CLIENT_RETRIES"
CLIENT_BACKOFF_ENV = "RAYDP_TPU_CLIENT_BACKOFF_S"
_RETRIES = 4
_BACKOFF_S = 0.25

#: Sentinel outcome: the envelope thread resolved its futures inline
#: (per-envelope streaming) — nothing left for the retry joiner to do.
_BATCH_DONE = object()


class ClientError(RuntimeError):
    pass


def _retry_idempotent(fn: Callable[[], Any], what: str) -> Any:
    """Run an idempotent master RPC with jittered exponential backoff.

    A briefly unreachable master (restarting process, transient
    partition) must not fail the client's first RPC — but only
    IDEMPOTENT calls may be retried: a timed-out mutation could have
    been applied, and re-sending it would double-apply. Read-only calls
    (Ping, ListWorkers, GetObjectMeta, …) are safe to re-send verbatim.

    ``RAYDP_TPU_CLIENT_RETRIES`` attempts (default 4) with base delay
    ``RAYDP_TPU_CLIENT_BACKOFF_S`` (default 0.25) doubling per attempt,
    plus up to 25% jitter so a fleet of reconnecting clients doesn't
    stampede the recovering master in lockstep. An unparsable value
    reads as its default.
    """
    try:
        retries = max(0, int(os.environ.get(CLIENT_RETRIES_ENV,
                                            str(_RETRIES))))
    except ValueError:
        retries = _RETRIES
    try:
        backoff = float(os.environ.get(CLIENT_BACKOFF_ENV, str(_BACKOFF_S)))
    except ValueError:
        backoff = _BACKOFF_S
    attempt = 0
    while True:
        try:
            return fn()
        except RpcUnavailable as exc:
            # Transport-level failure only: an RpcError (remote handler
            # raised) means the master IS reachable — retrying a
            # handler exception would just repeat it.
            if attempt >= retries:
                raise
            delay = backoff * (2 ** attempt)
            delay *= 1.0 + random.uniform(0.0, 0.25)
            attempt += 1
            logger.warning(
                "client: %s unreachable (%s); retry %d/%d in %.2fs",
                what, exc, attempt, retries, delay,
            )
            time.sleep(delay)


class _RemoteStore:
    """Duck-types the DirectoryStore surface the executor layer uses,
    proxying every operation to the master."""

    def __init__(self, master: RpcClient, namespace: str):
        self.namespace = namespace
        self.node_id = f"client-{os.getpid()}"  # never matches a data node
        self._master = master

    def put(self, data, owner: str = OWNER_HOLDER,
            num_rows: int = -1) -> ObjectRef:
        reply = self._master.call(
            "PutObject",
            {"data": bytes(data), "owner": owner, "num_rows": num_rows},
            timeout=120.0,
        )
        return reply["ref"]

    def put_arrow_table(self, table: pa.Table,
                        owner: str = OWNER_HOLDER) -> ObjectRef:
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return self.put(
            sink.getvalue().to_pybytes(), owner=owner, num_rows=table.num_rows
        )

    def get_ref(self, object_id: str) -> Optional[ObjectRef]:
        reply = self._master.call("GetObjectMeta", {"object_id": object_id})
        return reply.get("ref")

    def transfer_to_holder(self, ref: ObjectRef) -> ObjectRef:
        return self._master.call("TransferToHolder", {"ref": ref})["ref"]

    def delete(self, ref_or_id) -> bool:
        reply = self._master.call("DeleteObject",
                                  {"object_id": _object_id(ref_or_id)})
        return bool(reply.get("deleted"))

    def contains(self, ref_or_id) -> bool:
        return self.get_ref(_object_id(ref_or_id)) is not None

    def refs(self) -> List[ObjectRef]:
        return self._master.call("ListObjects", {})["refs"]

    # Resolver local-store protocol: the client holds no segments.
    def get_buffer(self, ref_or_id):
        raise KeyError("client has no local segments")

    def get_bytes(self, ref_or_id):
        raise KeyError("client has no local segments")

    def get_arrow_table(self, ref_or_id):
        raise KeyError("client has no local segments")


class _RemoteMaster:
    """The ``cluster.master`` facet a client sees."""

    def __init__(self, client: RpcClient, namespace: str):
        self._client = client
        self.namespace = namespace
        self.store = _RemoteStore(client, namespace)

    # Read-only lookups retry through master blips (idempotent: the
    # identical request can be re-sent with no double-apply risk).
    # Mutations (PutObject, RegisterObject, TransferToHolder) do NOT —
    # a timed-out mutation may have landed, and the caller must decide.
    def object_meta(self, object_id: str):
        reply = _retry_idempotent(
            lambda: self._client.call("GetObjectMeta",
                                      {"object_id": object_id}),
            "master GetObjectMeta",
        )
        return reply.get("ref"), reply.get("agent")

    def alive_workers(self) -> List[WorkerInfo]:
        workers = _retry_idempotent(
            lambda: self._client.call("ListWorkers", {}),
            "master ListWorkers",
        )["workers"]
        return [w for w in workers if w.state == "ALIVE"]

    def cluster_resources(self) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("ClusterResources", {}),
            "master ClusterResources",
        )

    def metrics_snapshot(self) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("MetricsSnapshot", {}),
            "master MetricsSnapshot",
        )["snapshot"]

    def health_report(self) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("HealthReport", {}),
            "master HealthReport",
        )["report"]

    def progress_report(self) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("ProgressReport", {}),
            "master ProgressReport",
        )["report"]

    def usage_report(self) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("UsageReport", {}),
            "master UsageReport",
        )["report"]

    def scheduler_report(self) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("SchedulerReport", {}),
            "master SchedulerReport",
        )["report"]

    def record_gang(self, gang: str, views: dict) -> None:
        # Idempotent: the master keys the views by gang and rank.
        _retry_idempotent(
            lambda: self._client.call("GangReport",
                                      {"gang": gang, "views": views}),
            "master GangReport",
        )

    def events_report(self, job: Optional[str] = None) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("EventsReport", {"job": job}),
            "master EventsReport",
        )["report"]

    def dashboard_report(self) -> dict:
        return _retry_idempotent(
            lambda: self._client.call("DashboardReport", {}),
            "master DashboardReport",
        )["report"]

    def mark_worker_dead(self, worker_id: str, reason: str = "") -> None:
        # Best-effort: the real master's own monitors are authoritative;
        # a client merely stops routing to the worker.
        logger.warning("client: worker %s unreachable (%s)", worker_id, reason)


class RemoteCluster:
    """Duck-types the Cluster surface used by executors/datasets."""

    _WORKER_TTL = 1.0  # seconds of ListWorkers caching

    def __init__(self, master_address: str):
        self.master_address = master_address
        self._client = RpcClient(master_address, SERVICE)
        # The connect handshake retries: attaching while the master is
        # briefly unreachable (restart, partition) should wait it out,
        # not fail the session's very first RPC. Ping is idempotent.
        reply = _retry_idempotent(
            lambda: self._client.call("Ping", {}),
            f"master {master_address}",
        )
        self.namespace = reply["namespace"]
        self.master = _RemoteMaster(self._client, self.namespace)
        self._pool = ThreadPoolExecutor(max_workers=32)
        self._worker_clients: Dict[str, RpcClient] = {}
        self._workers_cache: List[WorkerInfo] = []
        self._workers_stamp = 0.0
        self._lock = threading.RLock()
        self._resolver: Optional[ObjectResolver] = None
        # Round-robin cursor for unpinned tasks (parity with the in-process
        # Cluster._pick_worker): without it every attempt-0 submit lands on
        # workers[0] and client drivers load one worker.
        self._rr = itertools.count()

    # -- object access --------------------------------------------------
    @property
    def resolver(self) -> ObjectResolver:
        if self._resolver is None:
            self._resolver = ObjectResolver(
                self.master.store, self.master.object_meta
            )
        return self._resolver

    # -- introspection --------------------------------------------------
    def alive_workers(self) -> List[WorkerInfo]:
        now = time.monotonic()
        with self._lock:
            if now - self._workers_stamp < self._WORKER_TTL:
                return list(self._workers_cache)
        workers = self.master.alive_workers()
        with self._lock:
            self._workers_cache = workers
            self._workers_stamp = now
        return list(workers)

    def cluster_resources(self) -> dict:
        return self.master.cluster_resources()

    def metrics_snapshot(self) -> dict:
        """The remote master's merged telemetry view (its ``driver`` entry
        is the session-owning process, not this client)."""
        return self.master.metrics_snapshot()

    def prometheus_metrics(self) -> str:
        """The remote view rendered here: only the pickled snapshot
        crosses the wire."""
        from raydp_tpu_torch.telemetry import render_prometheus

        return render_prometheus(self.metrics_snapshot())

    def trace_report(self) -> Optional[dict]:
        """Analyse the merged trace like ``Cluster.trace_report``: useful
        where this client shares ``RAYDP_TPU_TELEMETRY_DIR`` with the
        session's host; None where the directory is not set here."""
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

    def health_report(self) -> dict:
        """The remote master's aggregated health (the shape of
        ``Cluster.health_report``; its ``driver`` entry is the
        session-owning process)."""
        return self.master.health_report()

    def usage_report(self) -> dict:
        """Per-job usage folded on the session's owner (the shape of
        ``Cluster.usage_report``)."""
        return self.master.usage_report()

    def scheduler_report(self) -> dict:
        """The session's arbiter state, from its master (the shape of
        ``Cluster.scheduler_report``; retried through master blips)."""
        return self.master.scheduler_report()

    def record_gang(self, gang: str, views: dict) -> None:
        """A finished gang's rank views to the session's master (the
        shape of ``Cluster.record_gang``)."""
        self.master.record_gang(gang, views)

    def events_report(self, job: Optional[str] = None) -> dict:
        """The event timeline and MTTR from the master's shards (the
        shape of ``Cluster.events_report``)."""
        return self.master.events_report(job=job)

    def dashboard_report(self) -> dict:
        """The session's dashboard, from its master (the shape of
        ``Cluster.dashboard_report``)."""
        return self.master.dashboard_report()

    def progress_report(self) -> dict:
        """Stage progress as seen from THIS client (DataFrame stages
        run on the submitting driver), with the cluster-owning
        process's report attached under ``"cluster"``."""
        from raydp_tpu_torch.telemetry.progress import progress, stage_store

        report = progress.report()
        report["stage_totals"] = stage_store.snapshot()["totals"]
        report["cluster"] = self.master.progress_report()
        return report

    def capture_profile(self, seconds: float = 3.0,
                        out_dir: Optional[str] = None) -> Optional[dict]:
        """``Cluster.capture_profile`` from a client: the profile request
        fans out to every alive worker straight from here (the client
        holds their stubs) and the archives merge here. The client
        itself is not captured: it runs no device work. None without
        workers."""
        from raydp_tpu_torch.telemetry import device_profiler

        workers = self.alive_workers()
        if not workers:
            return None
        payloads: Dict[str, dict] = {}
        errors: Dict[str, str] = {}

        def _one(info: WorkerInfo) -> None:
            try:
                payloads[info.worker_id] = self._worker_client(info).call(
                    "ProfileRequest", {"seconds": seconds},
                    timeout=seconds + device_profiler.WORKER_CAPTURE_SLACK_S)
            except Exception as exc:
                errors[info.worker_id] = str(exc)

        threads = [threading.Thread(target=_one, args=(w,), daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds
                   + device_profiler.WORKER_CAPTURE_SLACK_S + 30.0)
        if not payloads:
            raise ClientError(
                f"profile capture failed on every worker: {errors}")
        ordered = [payloads[w] for w in sorted(payloads)]
        for payload in ordered:
            ref = payload.pop("ref", None)
            if ref is not None and "zip" not in payload:
                payload["zip"] = self.resolver.get_bytes(ref)
        merged = device_profiler.merge_rank_traces(ordered, out_dir)
        if errors:
            merged["errors"] = errors
        return merged

    # -- task submission ------------------------------------------------
    def submit(self, fn, *args, worker_id=None, timeout=300.0, **kwargs):
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
        data_args=(),
        meta_sink: Optional[Callable] = None,
        **kwargs,
    ) -> Future:
        """Like ``Cluster.submit_async``; ``data_args`` tables are staged
        into the cluster's driver-node store via PutObject (a client has
        no shm of its own — one hop to the master, after which workers
        resolve them through the normal data plane) and only refs ride
        the per-task envelope."""
        staged = self._stage_data_args(data_args)
        # One id for ALL delivery attempts of this submission: a
        # reconnect retry after a dropped connection may land on a
        # worker that already executed (or is still executing) the first
        # delivery — the worker-side dedup cache keyed on this id turns
        # the re-delivery into a wait-for-the-original instead of a
        # second execution.
        payload = {
            "fn": closure.dumps(fn),
            "args": args,
            "kwargs": kwargs,
            "request_id": uuid.uuid4().hex,
        }
        if staged:
            payload["data_refs"] = staged
        # The RPC leaves from a pool thread: capture the submitting
        # thread's trace context (as Cluster.submit_async does).
        from raydp_tpu_torch.telemetry import propagation as _prop

        trace_ctx = _prop.current_context()

        def run():
            preferred = worker_id
            rr = next(self._rr)
            last: Optional[BaseException] = None
            for attempt in range(retries + 1):
                workers = self.alive_workers()
                target = None
                if preferred is not None:
                    target = next(
                        (w for w in workers if w.worker_id == preferred), None
                    )
                if target is None:
                    if not workers:
                        last = ClientError("no alive workers")
                        time.sleep(0.3 * (attempt + 1))
                        continue
                    target = workers[(rr + attempt) % len(workers)]
                client = self._worker_client(target)
                try:
                    reply = client.call("RunTask", payload, timeout=timeout)
                    if meta_sink is not None:
                        try:
                            meta_sink(
                                0, target.worker_id,
                                reply.get("exec_s", 0.0),
                            )
                        except Exception:
                            pass
                    return reply["result"]
                except RpcTimeout as exc:
                    raise ClientError(
                        f"task RPC to {target.worker_id} failed: {exc}"
                    ) from exc
                except RpcUnavailable:
                    with self._lock:
                        self._workers_stamp = 0.0  # force refresh
                    preferred = None
                    last = ClientError(
                        f"worker {target.worker_id} unreachable"
                    )
                    continue
            raise ClientError(
                f"task failed after {retries + 1} attempts: {last}"
            ) from last

        def run_and_discard():
            try:
                with _prop.propagated(trace_ctx):
                    return run()
            finally:
                self._discard_staged(staged)

        return self._pool.submit(run_and_discard)

    # -- batched submission (one envelope per worker) --------------------
    def submit_batch(self, specs, timeout: float = 300.0,
                     retries: int = 2,
                     meta_sink: Optional[Callable] = None) -> List[Future]:
        """Client-mode twin of ``Cluster.submit_batch``: one RunTaskBatch
        envelope per worker, one Future per spec (in order).
        ``meta_sink(spec_index, worker_id, exec_s)`` fires before the
        matching future resolves, mirroring the in-process Cluster."""
        futures: List[Future] = [Future() for _ in specs]
        if not specs:
            return futures
        from raydp_tpu_torch.telemetry import propagation as _prop

        trace_ctx = _prop.current_context()

        def orchestrate():
            with _prop.propagated(trace_ctx):
                try:
                    self._run_batch(
                        list(specs), futures, timeout, retries, meta_sink
                    )
                except BaseException as exc:  # noqa: BLE001
                    for f in futures:
                        if not f.done():
                            f.set_exception(exc)

        self._pool.submit(orchestrate)
        return futures

    def _run_batch(self, specs, futures, timeout, retries, meta_sink=None):
        staged = [self._stage_data_args(s.data_args) for s in specs]
        try:
            pending = list(range(len(specs)))
            last: Optional[BaseException] = None
            for attempt in range(retries + 1):
                workers = self.alive_workers()
                if not workers:
                    last = ClientError("no alive workers")
                    time.sleep(0.3 * (attempt + 1))
                    continue
                by_id = {w.worker_id: w for w in workers}
                groups: Dict[str, List[int]] = {}
                for i in pending:
                    pref = specs[i].worker_id if attempt == 0 else None
                    if pref not in by_id:
                        pref = workers[
                            (next(self._rr)) % len(workers)
                        ].worker_id
                    groups.setdefault(pref, []).append(i)
                results: Dict[str, Any] = {}

                def call_group(wid, idxs):
                    try:
                        client = self._worker_client(by_id[wid])
                        fn_blobs, fn_index, tasks = [], {}, []
                        for i in idxs:
                            spec = specs[i]
                            slot = fn_index.get(id(spec.fn))
                            if slot is None:
                                slot = len(fn_blobs)
                                fn_blobs.append(closure.dumps(spec.fn))
                                fn_index[id(spec.fn)] = slot
                            task = {"fn": slot, "args": spec.args,
                                    "kwargs": spec.kwargs}
                            if staged[i]:
                                task["data_refs"] = staged[i]
                            tasks.append(task)
                        reply = client.call(
                            "RunTaskBatch",
                            {"fns": fn_blobs, "tasks": tasks},
                            timeout=timeout,
                        )
                        # Per-envelope streaming: resolve this worker's
                        # futures the moment IT replies, not after the
                        # slowest envelope joins.
                        for i, res in zip(idxs, reply["results"]):
                            if res.get("ok"):
                                if meta_sink is not None:
                                    try:
                                        meta_sink(
                                            i, wid, res.get("exec_s", 0.0)
                                        )
                                    except Exception:
                                        pass
                                futures[i].set_result(res.get("value"))
                            else:
                                futures[i].set_exception(RpcError(
                                    f"batched task failed on {wid}: "
                                    f"{res.get('error')}\n"
                                    f"{res.get('traceback', '')}"
                                ))
                        results[wid] = _BATCH_DONE
                    except RpcUnavailable as exc:
                        if isinstance(exc, RpcTimeout):
                            results[wid] = ClientError(
                                f"batch RPC to {wid} failed: {exc}"
                            )
                            results[wid].__cause__ = exc
                            results[wid]._hard = True
                        else:
                            with self._lock:
                                self._workers_stamp = 0.0  # force refresh
                            results[wid] = ClientError(
                                f"worker {wid} unreachable"
                            )
                    except BaseException as exc:  # noqa: BLE001
                        exc._hard = True
                        results[wid] = exc

                threads = [
                    threading.Thread(target=call_group, args=(wid, idxs),
                                     daemon=True)
                    for wid, idxs in groups.items()
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                next_pending: List[int] = []
                for wid, idxs in groups.items():
                    outcome = results.get(wid)
                    if outcome is _BATCH_DONE:
                        continue
                    if isinstance(outcome, BaseException):
                        if getattr(outcome, "_hard", False):
                            raise outcome
                        last = outcome
                        next_pending.extend(idxs)
                        continue
                    raise ClientError(
                        f"batch envelope to {wid} vanished without an "
                        f"outcome"
                    )
                pending = next_pending
                if not pending:
                    return
            for i in pending:
                if not futures[i].done():
                    futures[i].set_exception(ClientError(
                        f"batched task failed after {retries + 1} "
                        f"attempts: {last}"
                    ))
        finally:
            for refs in staged:
                self._discard_staged(refs)

    # -- data-plane staging ----------------------------------------------
    def _stage_data_args(self, tables) -> List[ObjectRef]:
        if not tables:
            return []
        store = self.master.store
        return [store.put_arrow_table(t) for t in tables]

    def _discard_staged(self, refs) -> None:
        for ref in refs or ():
            try:
                self.master.store.delete(ref)
            except Exception:
                pass

    def _worker_client(self, info: WorkerInfo) -> RpcClient:
        with self._lock:
            client = self._worker_clients.get(info.worker_id)
            if client is None or client.address != info.address:
                client = RpcClient(info.address, "raydp.Worker")
                self._worker_clients[info.worker_id] = client
            return client

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._lock:
            for client in self._worker_clients.values():
                client.close()
            self._worker_clients.clear()
        if self._resolver is not None:
            self._resolver.close()
        self._client.close()


class ClientSession:
    """Session facade for a remote driver. ``stop()`` disconnects only —
    the cluster belongs to the process that ran ``init()``."""

    # context.init() inspects this when replacing a stopped session; a
    # client never owns holder objects, so it is always "released".
    _holder_released = True

    def __init__(self, master_address: str):
        self.cluster = RemoteCluster(master_address)
        self._closed = False

    @property
    def stopped(self) -> bool:
        return self._closed

    def stop(self, del_obj_holder: bool = True, fast: bool = False) -> None:
        if not self._closed:
            self.cluster.close()
            self._closed = True

    disconnect = stop


def _object_id(ref_or_id) -> str:
    return ref_or_id.object_id if isinstance(ref_or_id, ObjectRef) \
        else ref_or_id
