"""SPMD job worker process (the port's copy of
``raydp_tpu/spmd/worker_main.py``).

One rank of the gang launched by :class:`raydp_tpu_torch.spmd.job.SPMDJob`.
Registers with the driver, then executes shipped functions on a dedicated
runner thread in strict ``func_id`` order (the reference's TaskRunner with
monotonic-id check, reference: python/raydp/mpi/mpi_worker.py:63-96).

Functions receive an :class:`SPMDWorkerContext`; for collective work they
call ``ctx.init_distributed()``, which joins ``torch.distributed`` at the
driver-provisioned rank-0 coordinator — the role MPI collectives play in
the reference and ``jax.distributed`` in the JAX package. Its backend
follows :func:`collective_backend`: NCCL where every rank on a host has
a card of its own, gloo where ranks share a card or run on the CPU.

The process imports no torch until a shipped function does (nor any
other library of the card): functions arrive through the closure carrier
(``cluster/closure.py``), and this module loads only the RPC layer, the
store's fetch protocol, the fault plane and the telemetry (all of it
standard library).

Preemption (``raydp_tpu/spmd/worker_main.py:127-139, 431``): the
driver's ``Preempt`` RPC and a SIGTERM (routed by
:func:`~raydp_tpu_torch.fault.install_sigterm_drain` before the runner
starts) both set the process's drain flag; a training function drains
at its next step boundary. A plan's ``hb_stall`` clause silences this
rank's heartbeats. The drain is installed after the flight recorder
and chains to it: once the rank has drained and stops, the SIGTERM is
handed on (:func:`~raydp_tpu_torch.fault.reraise_drained_sigterm`), so
the rank leaves a postmortem bundle and dies by the signal.

Telemetry (``raydp_tpu/spmd/worker_main.py:40-45, 200-400, 431-440``):
the rank joins the driver's trace and job from its env, arms the flight
recorder (component ``spmd-worker``), the JSONL logs and the watchdog;
each shipped function runs in the dispatch's trace context and job (the
``traceparent`` and ``job`` keys ride the queued request) inside an
``spmd/func`` span and watchdog bracket; each heartbeat samples the
resource gauges, bills ``hbm_byte_seconds``, ships the metric delta
(rolled back when the Ping is missed) and the stall flags, and flushes
the span ring; a stopping rank ships its full final snapshot on a last
Ping (the ETL worker's ``WorkerStopped`` does the same for its master).
``RAYDP_TPU_DEBUG_PORT`` serves this rank's ``/metrics``
and ``/healthz``. A ``ProfileRequest`` captures a ``torch.profiler``
trace of the rank beside its running function, and the rank counts its
compiles (kernel builds, graph captures) from its start.
"""
from __future__ import annotations

import atexit
import contextlib
import logging
import os
import queue
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from raydp_tpu_torch import fault
from raydp_tpu_torch.cluster import closure
from raydp_tpu_torch.cluster.rpc import RpcClient, RpcServer
from raydp_tpu_torch.spmd.job import (
    DRIVER_SERVICE,
    ENV_COORDINATOR,
    ENV_DRIVER_ADDR,
    ENV_JOB_NAME,
    ENV_LOCAL_RANK,
    ENV_LOCAL_WORLD_SIZE,
    ENV_RANK,
    ENV_WORLD_SIZE,
    WORKER_SERVICE,
)
from raydp_tpu_torch.telemetry import MetricsShipper, flush_spans, span
from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import flight_recorder as _flight
from raydp_tpu_torch.telemetry import logs as _logs
from raydp_tpu_torch.telemetry import propagation as trace_prop
from raydp_tpu_torch.telemetry import watchdog as _watchdog
from raydp_tpu_torch.utils import startup
from raydp_tpu_torch.utils.net import local_ip
from raydp_tpu_torch.utils.profiling import (
    install_compile_listener,
    metrics,
    sample_resource_gauges,
)

logger = logging.getLogger(__name__)

# Seconds between heartbeats, and beats missed before a rank decides its
# driver is gone.
HEARTBEAT_S = 5.0
MISSED_BEATS = 3
# How long rank 0 waits for the gang at the coordinator.
DISTRIBUTED_TIMEOUT_S = 300.0


def collective_backend(local_world_size: int, device: str = "cuda") -> str:
    """The ``torch.distributed`` backend for a gang whose collectives run
    on ``device``, with ``local_world_size`` ranks on each host, decided
    before the group is joined (never by retrying after a failure):

    * ``"nccl"`` when the device is a card and every rank on a host has
      one of its own (``local_world_size <= torch.cuda.device_count()``;
      local rank r on ``cuda:r``);
    * ``"gloo"`` when ranks share a card (NCCL refuses two ranks on one
      device) or run on the CPU. Gloo all-reduces and broadcasts CUDA
      tensors by staging them through the host.

    A card's gang on a host with no card raises. Every host is taken to
    have as many cards as this one."""
    if not str(device).startswith("cuda"):
        return "gloo"
    import torch

    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(
            f"collectives on {device!r} asked for, but this host has no "
            "CUDA device (pass device='cpu' for a gang on the CPU)")
    return "nccl" if local_world_size <= cards else "gloo"


class SPMDWorkerContext:
    """First argument to every shipped function
    (reference: WorkerContext, mpi/mpi_worker.py:45-60)."""

    def __init__(self, job_name: str, rank: int, world_size: int,
                 local_rank: int, node_ip: str, coordinator_address: str,
                 fail_job: Optional[Callable[[str], None]] = None,
                 local_world_size: int = 1):
        self.job_name = job_name
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        # Ranks on this rank's host (``job.host_layout``).
        self.local_world_size = local_world_size
        self.node_ip = node_ip
        self.coordinator_address = coordinator_address
        self._fail_job = fail_job
        self._dist_initialized = False
        # The backend the gang's process group runs, once joined.
        self.backend: Optional[str] = None

    def device(self, device: str = "cuda") -> str:
        """This rank's device for a gang on ``device``: ``"cpu"``, or
        ``cuda:<local_rank mod the visible cards>`` (one card a rank
        where there are enough, else ranks share them)."""
        if not str(device).startswith("cuda"):
            return "cpu"
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {self.rank}: a CUDA gang's rank sees no CUDA device")
        return f"cuda:{self.local_rank % torch.cuda.device_count()}"

    def init_distributed(self, backend: Optional[str] = None,
                         device: str = "cuda") -> str:
        """Join the gang's ``torch.distributed`` process group at
        ``coordinator_address``, where rank 0's ``TCPStore`` listens;
        afterwards collectives span every rank. Idempotent per process
        (the counterpart of the JAX package's ``init_jax_distributed``,
        as in its ``examples/spmd_job.py:52-67``). ``device`` is where
        the collectives' tensors live: ``"cuda"`` (the default) raises
        on a host with no card, ``"cpu"`` runs them on the host. The
        backend follows :func:`collective_backend` unless ``backend``
        names one (for NCCL the rank's card becomes the current
        device). Returns the backend.

        A rank that cannot join (rank 0's store cannot bind the port,
        which another process took after the driver probed it) fails
        the whole gang at once with a reason naming the port: the other
        ranks would otherwise wait out the store's timeout."""
        if self._dist_initialized:
            return self.backend
        import datetime

        import torch
        import torch.distributed as dist

        if backend is None:
            backend = collective_backend(self.local_world_size, device)
        if backend == "nccl":
            torch.cuda.set_device(self.device("cuda"))

        host, _, port = self.coordinator_address.rpartition(":")
        timeout = datetime.timedelta(seconds=DISTRIBUTED_TIMEOUT_S)
        try:
            with startup.part("dist"):
                store = dist.TCPStore(host, int(port), self.world_size,
                                      is_master=self.rank == 0,
                                      timeout=timeout,
                                      wait_for_workers=False)
                dist.init_process_group(backend=backend, store=store,
                                        world_size=self.world_size,
                                        rank=self.rank, timeout=timeout)
        except Exception as exc:
            reason = (f"rank {self.rank}: cannot join the gang's process "
                      f"group at coordinator {self.coordinator_address} "
                      f"(port {port}): {type(exc).__name__}: {exc}")
            if self._fail_job is not None:
                self._fail_job(reason)
            raise RuntimeError(reason) from exc
        self._dist_initialized = True
        self.backend = backend
        logger.info("rank %d joined the gang's process group (%s, %d "
                    "ranks)", self.rank, backend, self.world_size)
        return backend


class SPMDWorker:
    def __init__(self):
        self.job_name = os.environ[ENV_JOB_NAME]
        self.rank = int(os.environ[ENV_RANK])
        self.world_size = int(os.environ[ENV_WORLD_SIZE])
        self.ctx = SPMDWorkerContext(
            self.job_name,
            self.rank,
            self.world_size,
            local_rank=int(os.environ[ENV_LOCAL_RANK]),
            node_ip=local_ip(),
            coordinator_address=os.environ[ENV_COORDINATOR],
            fail_job=self._fail_job,
            local_world_size=int(os.environ[ENV_LOCAL_WORLD_SIZE]),
        )
        driver_addr = os.environ[ENV_DRIVER_ADDR]
        self.driver = RpcClient(driver_addr, DRIVER_SERVICE)
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._stop_event = threading.Event()
        # Registry deltas for the Pings, and the final full snapshot.
        self._shipper = MetricsShipper()
        self._last_func_id = 0
        # Mirror the driver's multi-host binding: a remote driver must be
        # able to reach this rank's service across the network.
        multihost = not driver_addr.startswith("127.0.0.1")
        self._server = RpcServer(
            WORKER_SERVICE,
            {"RunFunction": self._on_run_function, "Stop": self._on_stop,
             "ProfileRequest": self._on_profile,
             "Preempt": self._on_preempt},
            host="0.0.0.0" if multihost else "127.0.0.1",
        )
        self._advertise = (
            f"{self.ctx.node_ip}:{self._server.port}" if multihost
            else self._server.address
        )

    def _fail_job(self, reason: str) -> None:
        self.driver.try_call("JobFailed", {"reason": reason}, timeout=5.0)

    def _on_run_function(self, req: dict) -> dict:
        self._queue.put(req)
        return {"queued": req["func_id"]}

    def _on_stop(self, req: dict) -> dict:
        self._stop_event.set()
        self._queue.put(None)
        return {"stopping": True}

    def _on_profile(self, req: dict) -> dict:
        """A trace capture across the gang: runs ON the RPC handler
        thread, beside whatever shipped function the runner thread is
        executing, so the window samples live training without pausing
        it (``torch.profiler`` records this thread's host ops, the
        card's kernels from every thread, and the span ring)."""
        from raydp_tpu_torch.telemetry import device_profiler

        seconds = float(req.get("seconds", 3.0))
        _flight.record("profile", "start", rank=self.rank, seconds=seconds)
        payload = device_profiler.capture_trace_archive(seconds,
                                                        rank=self.rank)
        _flight.record("profile", "end", rank=self.rank,
                       nbytes=len(payload.get("zip") or b""))
        return payload

    def _on_preempt(self, req: dict) -> dict:
        """The driver's preemption notice: sets the drain flag a SIGTERM
        would (:func:`~raydp_tpu_torch.fault.request_preemption`, with
        the request's ``grace_s`` or the environment's), so a training
        function finishes its step, writes an emergency checkpoint and
        raises ``PreemptionError``."""
        grace = req.get("grace_s")
        fault.request_preemption(
            grace_s=float(grace) if grace is not None else None)
        return {"preempting": True, "rank": self.rank}

    def _payload_blob(self, item: dict, key: str) -> Optional[bytes]:
        """Bytes for ``key`` (``fn`` / ``args``) of a queued dispatch.

        Inline payloads ride the envelope; oversize payloads arrive as
        ``<key>_ref`` and are pulled back from the driver's staging store
        in bounded chunks — the same FetchObjectChunk protocol (and
        chunk-size env) the cross-host data plane uses, so a large
        closure never has to fit one RPC message.
        """
        blob = item.get(key)
        if blob is not None:
            return blob
        object_id = item.get(f"{key}_ref")
        if object_id is None:
            return None
        from raydp_tpu_torch.store.resolver import _fetch_chunk_bytes
        from raydp_tpu_torch.utils.profiling import metrics as _metrics

        chunk = max(1024 * 1024, _fetch_chunk_bytes())
        reply = self.driver.call(
            "FetchObjectChunk",
            {"object_id": object_id, "offset": 0, "length": chunk},
            timeout=120.0,
        )
        total = int(reply["size"])
        first = reply["data"]
        buf = bytearray(total)
        buf[: len(first)] = first
        offset = len(first)
        while offset < total:
            part = self.driver.call(
                "FetchObjectChunk",
                {"object_id": object_id, "offset": offset, "length": chunk},
                timeout=120.0,
            )["data"]
            if not part:
                raise RuntimeError(
                    f"short read fetching dispatch blob {object_id}: "
                    f"{offset}/{total} bytes"
                )
            buf[offset: offset + len(part)] = part
            offset += len(part)
        expect = int(item.get(f"{key}_size") or total)
        if offset != expect:
            raise RuntimeError(
                f"dispatch blob {object_id} size mismatch: fetched "
                f"{offset}, expected {expect}"
            )
        _metrics.counter_add("spmd/blob_fetches")
        _metrics.counter_add("spmd/blob_fetch_bytes", total)
        return bytes(buf)

    def _runner(self) -> None:
        while not self._stop_event.is_set():
            item = self._queue.get()
            if item is None:
                return
            func_id = item["func_id"]
            if func_id <= self._last_func_id:
                # Duplicate delivery — the driver's ids only move forward.
                continue
            self._last_func_id = func_id
            value, error = None, None
            # The RunFunction handler only enqueues; this thread runs the
            # function, so the dispatch's trace context and job ride the
            # queued request and are installed here.
            ctx = trace_prop.extract(item)
            jctx = _acct.extract(item)
            _flight.record("func", "start", rank=self.rank, func_id=func_id)
            # A wedged function (a collective waiting on a dead peer)
            # shows as "spmd/func", at the long-op threshold: a shipped
            # function is often a whole training loop.
            with (trace_prop.propagated(ctx) if ctx is not None
                  else contextlib.nullcontext()), \
                    (_acct.job_scope(jctx) if jctx is not None
                     else contextlib.nullcontext()), \
                    _watchdog.inflight("spmd/func", rank=self.rank,
                                       func_id=func_id,
                                       stall_after_s=_watchdog.long_stall_s()), \
                    span("spmd/func", rank=self.rank, func_id=func_id) as sp:
                try:
                    fn = closure.loads(self._payload_blob(item, "fn"))
                    args_blob = self._payload_blob(item, "args")
                    args = (closure.loads(args_blob)
                            if args_blob is not None else ())
                    value = fn(self.ctx, *args)
                except Exception:
                    error = traceback.format_exc()
                    sp.status = "error"
            _flight.record("func", "end", rank=self.rank, func_id=func_id,
                           **({"status": "error"} if error else {}))
            reply = self.driver.try_call(
                "FuncResult",
                {
                    "func_id": func_id,
                    "rank": self.rank,
                    "value": value,
                    "error": error,
                },
                timeout=10.0,
            )
            if reply is None:
                logger.warning(
                    "rank %d: driver unreachable posting result %d; exiting",
                    self.rank, func_id,
                )
                self._stop_event.set()
                return

    def _heartbeat(self) -> None:
        """Detect a dead driver while idle — without this, a SIGKILLed
        driver would orphan the whole gang (and the cards it holds)
        forever; result-posting only notices mid-function."""
        shipper = self._shipper
        missed = 0
        # Compile accounting (kernel builds, graph captures) for all this
        # rank runs; the counters ride the same deltas as its timers.
        install_compile_listener()
        beat_index = 0
        last_mono = time.monotonic()
        while not self._stop_event.wait(HEARTBEAT_S):
            beat_index += 1
            # A plan's hb_stall clause skips this beat: no ping leaves,
            # as from a partitioned host.
            if fault.active() and fault.on_heartbeat(beat_index - 1,
                                                     rank=self.rank):
                continue
            beat = self._beat(shipper, last_mono)
            last_mono = time.monotonic()
            # One shard write a beat (a no-op without a telemetry dir).
            flush_spans()
            if self.driver.try_call("Ping", beat, timeout=5.0) is None:
                _flight.record("heartbeat", "missed", missed=missed + 1)
                shipper.rollback(beat.get("metrics"))  # ships next beat
                missed += 1
                if missed >= MISSED_BEATS:
                    logger.warning(
                        "rank %d: driver unreachable for %d beats; exiting",
                        self.rank, missed,
                    )
                    self._stop_event.set()
                    self._queue.put(None)
                    return
            else:
                missed = 0

    def _beat(self, shipper: MetricsShipper, last_mono: float) -> dict:
        """A Ping's body: the metric delta (after refreshing the resource
        gauges and billing the device memory held since ``last_mono``)
        and any stall flags."""
        beat = {"rank": self.rank}
        try:
            sample_resource_gauges()
        except Exception:
            metrics.counter_add("telemetry/gauge_errors")
        # Device-memory byte-seconds: the occupancy gauge integrated at
        # beat cadence, so the ledger bills memory held.
        hbm = metrics.gauge_value("hbm/used_bytes")
        if hbm:
            _acct.add_usage(_acct.HBM_BYTE_SECONDS,
                            hbm * (time.monotonic() - last_mono))
        delta = shipper.delta()
        if delta:
            beat["metrics"] = delta
        # Stall flags reach SPMDJob.health_report() while the function
        # is still running.
        health = _watchdog.health()
        if not health.get("healthy", True):
            beat["health"] = {"stalls": health.get("stalls", {})}
        return beat

    def _serve_debug(self):
        """This rank's ``/metrics`` and ``/healthz`` when
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
                    {"workers": {f"rank-{self.rank}": metrics.snapshot()}}),
                int(port),
            )
        except Exception:
            logger.exception("rank debug endpoint failed to start")
            return None

    def run(self) -> int:
        self.driver.call(
            "RegisterWorker",
            {
                "rank": self.rank,
                "address": self._advertise,
                "host": self.ctx.node_ip,
                "pid": os.getpid(),
            },
        )
        _flight.record("state", "registered", rank=self.rank)
        debug_server = self._serve_debug()
        runner = threading.Thread(target=self._runner, daemon=True)
        runner.start()
        threading.Thread(target=self._heartbeat, daemon=True).start()
        self._stop_event.wait()
        runner.join(timeout=2.0)
        # The full final snapshot on one last Ping: the driver waits for
        # the ranks to exit before it closes its server, so a function's
        # last usage (an epoch's chip-seconds billed as it ends) reaches
        # SPMDJob.telemetry without waiting for a beat.
        self.driver.try_call(
            "Ping", {"rank": self.rank, "metrics": self._shipper.full()},
            timeout=2.0)
        _flight.record("state", "stopping", rank=self.rank)
        flush_spans()  # the tail of a clean stop (atexit is the backstop)
        if debug_server is not None:
            debug_server.close()
        self._server.stop()
        self.driver.close()
        return 0


def main() -> int:
    logging.basicConfig(
        level=logging.INFO,
        format=f"[spmd-{os.environ.get(ENV_RANK, '?')}] %(levelname)s "
               f"%(message)s",
    )
    # Join the driver's trace and job before any span or usage is
    # recorded; arm the postmortem bundles, the JSONL logs and the
    # watchdog; flush tail spans at interpreter exit.
    trace_prop.adopt_env_context()
    _acct.adopt_env_job()
    _flight.install(component="spmd-worker")
    # After the flight recorder, and chained to it: SIGTERM drains a
    # training function to an emergency checkpoint instead of killing
    # the rank; the signal is handed on once the rank stops.
    fault.install_sigterm_drain()
    _logs.install()
    _watchdog.ensure_started()
    atexit.register(flush_spans)
    try:
        code = SPMDWorker().run()
        fault.reraise_drained_sigterm()
        return code
    except Exception:
        traceback.print_exc()
        # Best-effort failure report so the driver fails fast rather than
        # timing out (reference: mpirun watcher failed_callback,
        # mpi/mpi_job.py:265-271).
        try:
            RpcClient(
                os.environ[ENV_DRIVER_ADDR], DRIVER_SERVICE
            ).try_call(
                "JobFailed",
                {"reason": f"rank {os.environ.get(ENV_RANK)}: "
                           f"{traceback.format_exc(limit=3)}"},
                timeout=2.0,
            )
        except Exception:
            pass
        return 1


if __name__ == "__main__":
    sys.exit(main())
