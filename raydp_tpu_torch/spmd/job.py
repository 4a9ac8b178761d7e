"""SPMD host-process job runner — driver side (the port's copy of
``raydp_tpu/spmd/job.py``).

Capability parity with the reference's MPI-on-Ray subsystem
(reference: python/raydp/mpi/mpi_job.py:119-426, __init__.py:36-91):
launch a gang of ``world_size`` host processes, ship functions to every
rank, collect per-rank results, stop/restart the gang.

Differences from the reference:

* No mpirun. Each rank is a process this driver spawns (a subprocess per
  rank; a ``script_prepare_fn`` hook customizes the launch command for
  ssh/pod launchers, the reference's ``mpi_script_prepare_fn`` extension
  point, reference: mpi/mpi_job.py:239-248).
* The collective fabric inside shipped functions is ``torch.distributed``,
  not MPI. The driver provisions the rank-0 coordinator address and every
  :class:`~raydp_tpu_torch.spmd.worker_main.SPMDWorkerContext` exposes
  ``init_distributed()``, which joins a group there (NCCL where every
  rank on a host has a card of its own, else gloo).
* One wire protocol: the port's RPC layer (``cluster/rpc.py``), with
  functions and arguments carried by the closure carrier
  (``cluster/closure.py``), as the session's tasks are.

Telemetry (``raydp_tpu/spmd/job.py:37-41, 208-342, 374-525, 630-688,
725-740, 859-940``): a gang joins the driver's trace and job (a gang
inside a session joins the session's trace; a standalone one mints its
own root and job) and hands both to its ranks' env; the ranks' metric
deltas on their Pings merge into :attr:`SPMDJob.telemetry`
(:meth:`SPMDJob.metrics_snapshot`, :meth:`SPMDJob.usage_report`), their
stall flags into :meth:`SPMDJob.health_report`; each dispatch is an
``spmd/dispatch`` span and watchdog bracket; ``gang/launch``,
``rank/dead``, ``gang/failed``, ``preempt/request`` and
``gang/teardown`` land on the event timeline.

:meth:`SPMDJob.capture_profile` merges a trace of every rank, taken
beside the running function; :meth:`SPMDJob.resource_report` reads each
rank's shipped gauges (memory, compiles, phase fractions, ``bound``,
``mfu``).

Admission (``raydp_tpu/spmd/job.py:313-323``): ``start()`` acquires
``world_size`` slots from the control plane's arbiter before it spawns
a rank, blocking in the admission queue when the pool is full (a no-op
when the arbiter is off or a supervisor such as ``fit_spmd`` already
holds the job's lease); the arbiter's preemption of the gang is
:meth:`SPMDJob.request_preemption`. ``stop()`` releases the lease.
"""
from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from raydp_tpu_torch.cluster import closure
from raydp_tpu_torch.cluster.rpc import RpcClient, RpcServer
from raydp_tpu_torch.store.object_store import DEFAULT_NODE
from raydp_tpu_torch.telemetry import ClusterTelemetry, span
from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.telemetry import flight_recorder as _flight
from raydp_tpu_torch.telemetry import propagation as trace_prop
from raydp_tpu_torch.telemetry import watchdog as _watchdog
from raydp_tpu_torch.utils.net import find_free_port
from raydp_tpu_torch.utils.profiling import metrics as _metrics

logger = logging.getLogger(__name__)

DRIVER_SERVICE = "raydp.SPMDDriver"
WORKER_SERVICE = "raydp.SPMDWorker"

# Env vars carrying gang identity to worker processes (the reference ships
# these via mpirun's environment, reference: mpi/constants.py:20-28,
# mpi/mpi_job.py:250-258).
ENV_JOB_NAME = "RAYDP_SPMD_JOB_NAME"
ENV_RANK = "RAYDP_SPMD_RANK"
ENV_WORLD_SIZE = "RAYDP_SPMD_WORLD_SIZE"
ENV_DRIVER_ADDR = "RAYDP_SPMD_DRIVER_ADDR"
ENV_COORDINATOR = "RAYDP_SPMD_COORDINATOR"
# A rank's index among the ranks on its host, and how many ranks its
# host runs (:func:`host_layout`).
ENV_LOCAL_RANK = "RAYDP_SPMD_LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "RAYDP_SPMD_LOCAL_WORLD_SIZE"
# Registration barrier (driver side): the soft window is the job's
# ``timeout`` and resets on every new rank registration; alive-but-slow
# workers (cold imports on a busy host) are waited on up to the hard cap,
# ``register_hard_timeout`` or else ``_REGISTER_HARD_FACTOR`` soft windows
# and never under ``_REGISTER_HARD_MIN_S``. The env vars override both.
ENV_REGISTER_TIMEOUT = "RAYDP_SPMD_REGISTER_TIMEOUT"
ENV_REGISTER_HARD_TIMEOUT = "RAYDP_SPMD_REGISTER_HARD_TIMEOUT"
_REGISTER_HARD_FACTOR = 10.0
_REGISTER_HARD_MIN_S = 300.0
# Dispatch-payload shipping policy. Payloads (fn closure + scatter blob)
# above the inline cap leave the RPC envelope and travel the chunked
# FetchObjectChunk path instead. The hard cap is the fail-fast guard:
# anything bigger than the transport can ever carry raises a structured
# DispatchPayloadError instead of timing out against a wedged channel.
ENV_INLINE_CAP = "RAYDP_TPU_RPC_INLINE_CAP_MB"
ENV_PAYLOAD_HARD_CAP = "RAYDP_TPU_RPC_PAYLOAD_HARD_CAP_MB"
_DEFAULT_INLINE_CAP_MB = 64.0
_DEFAULT_HARD_CAP_MB = 448.0  # headroom under the 512 MB frame limit

_LOCAL_HOSTS = ("127.0.0.1", "localhost")


def host_layout(world_size: int, hosts: List[str],
                num_procs_per_node: int) -> List[tuple]:
    """``(local_rank, local_world_size)`` of every rank: its index among
    the ranks on its host and how many ranks that host runs. Ranks fill
    hosts in order, ``num_procs_per_node`` per host, wrapping round when
    the gang outnumbers the slots (as :meth:`SPMDJob.rank_nodes` places
    them); the loopback names are one host."""
    keys = []
    for r in range(world_size):
        host = hosts[(r // num_procs_per_node) % len(hosts)]
        keys.append("127.0.0.1" if host in _LOCAL_HOSTS else host)
    seen: Dict[str, int] = {}
    local_ranks = []
    for key in keys:
        local_ranks.append(seen.get(key, 0))
        seen[key] = local_ranks[-1] + 1
    return [(lr, seen[key]) for lr, key in zip(local_ranks, keys)]


def _env_mb(name: str, default_mb: float) -> int:
    raw = os.environ.get(name)
    try:
        mb = float(raw) if raw else default_mb
    except ValueError:
        mb = default_mb
    return int(mb * 1024 * 1024)


class SPMDJobError(RuntimeError):
    pass


class DispatchPayloadError(SPMDJobError):
    """A dispatch whose payload cannot travel (the counterpart of the
    reference's structured ``CompileError`` for oversize dispatches):
    ``label`` names the job and function, ``payload_bytes`` the size,
    ``server_exception`` the transport's failure class where one was
    seen, and ``retryable`` is False only for a payload over the hard
    cap, which no retry can ship."""

    def __init__(self, message: str, *, label: str, payload_bytes: int,
                 retryable: bool, server_exception: Optional[str] = None):
        super().__init__(message)
        self.label = label
        self.payload_bytes = payload_bytes
        self.retryable = retryable
        self.server_exception = server_exception


class SPMDJobContext:
    """Handed to ``script_prepare_fn`` so users can customize the launch
    (reference: MPIJobContext, mpi/mpi_job.py:91-116)."""

    def __init__(self, job_name: str, world_size: int, hosts: List[str],
                 num_procs_per_node: int):
        self.job_name = job_name
        self.world_size = world_size
        self._hosts = hosts
        self._num_procs_per_node = num_procs_per_node
        self._env: Dict[str, str] = {}

    @property
    def hosts(self) -> List[str]:
        return self._hosts

    @property
    def num_procs_per_node(self) -> int:
        return self._num_procs_per_node

    @property
    def env(self) -> Dict[str, str]:
        return self._env

    def add_env(self, key: str, value: str) -> None:
        self._env[key] = value

    def add_envs(self, envs: Dict[str, str]) -> None:
        self._env.update(envs)


class _FuncResults:
    """Barrier collecting one result per rank for a shipped function
    (reference: FunctionResults, mpi/mpi_job.py:82-88)."""

    def __init__(self, func_id: int, world_size: int):
        self.func_id = func_id
        self.results: List[Any] = [None] * world_size
        self.errors: List[Optional[str]] = [None] * world_size
        self._remaining = world_size
        self._lock = threading.Lock()
        self.done = threading.Event()

    def post(self, rank: int, value: Any, error: Optional[str]) -> None:
        with self._lock:
            self.results[rank] = value
            self.errors[rank] = error
            self._remaining -= 1
            if self._remaining == 0:
                self.done.set()


class SPMDJob:
    """A restartable gang of SPMD host processes.

    Lifecycle mirrors the reference MPIJob: ``start()`` brings up the gang
    and blocks until every rank registers; ``run(fn)`` ships ``fn`` to all
    ranks and returns rank-ordered results; ``stop()`` tears the gang down;
    ``start()`` again relaunches (restartability tested by the reference at
    python/raydp/tests/test_mpi.py:28-56).
    """

    def __init__(
        self,
        job_name: str,
        world_size: int,
        num_procs_per_node: int = 1,
        script_prepare_fn: Optional[Callable[[SPMDJobContext], List[str]]] = None,
        env: Optional[Dict[str, str]] = None,
        timeout: float = 30.0,
        hosts: Optional[List[str]] = None,
        coordinator_port: Optional[int] = None,
        register_hard_timeout: Optional[float] = None,
        host_nodes: Optional[List[str]] = None,
    ):
        """``timeout`` is the registration barrier's SOFT window (resets
        on progress); ``register_hard_timeout`` caps how long ranks that
        are alive-but-slow are waited on past it (default
        ``max(10 × soft, 300)`` seconds). ``RAYDP_SPMD_REGISTER_TIMEOUT``
        and ``RAYDP_SPMD_REGISTER_HARD_TIMEOUT`` override both.
        ``host_nodes`` names the cluster node of each host (placement
        fills it) for :meth:`rank_nodes`."""
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        self.job_name = job_name
        self.world_size = world_size
        self.num_procs_per_node = num_procs_per_node
        self.script_prepare_fn = script_prepare_fn
        self.base_env = dict(env or {})
        self.timeout = timeout
        self.register_hard_timeout = register_hard_timeout
        self.hosts = hosts or ["127.0.0.1"]
        self.host_nodes = list(host_nodes) if host_nodes is not None else None
        self.coordinator_port = coordinator_port
        self._multihost = any(h not in _LOCAL_HOSTS for h in self.hosts)

        self._server: Optional[RpcServer] = None
        self._procs: List[subprocess.Popen] = []
        self._worker_addrs: Dict[int, str] = {}
        self._worker_hosts: Dict[int, str] = {}
        self._stubs: Dict[int, RpcClient] = {}
        self._register_barrier = threading.Event()
        self._func_id = 0
        self._inflight: Optional[_FuncResults] = None
        self._lock = threading.Lock()
        self._started = False
        self._failed: Optional[str] = None
        # Ranks that registered in the most recent start() attempt —
        # survives the stop() cleanup so a supervisor can size an
        # elastic relaunch to the hosts that actually showed up.
        self.last_registered: Optional[int] = None
        self._gen = 0  # incarnation counter scoping watcher threads
        self._stopping = False
        self._log_paths: List[str] = []
        self._trace_ctx = None
        self._owns_trace_ctx = False
        self._job_ctx: Optional[_acct.JobContext] = None
        self._owns_job_ctx = False
        # The arbiter's lease start() took for a standalone gang (None
        # where a supervisor holds the job's lease, or arbitration is off).
        self._sched_lease = None
        # Driver-local staging store for oversize dispatch payloads:
        # blobs above the inline cap are parked here and ranks pull
        # them through the chunked FetchObjectChunk path.
        self._blob_store = None
        # Per-rank metrics merged from the deltas on their Pings; kept
        # across relaunches (ranks keep their keys).
        self.telemetry = ClusterTelemetry()
        # Stall flags from each rank's last Ping (empty = healthy), and
        # when it last beat; a lock of their own, so Pings never contend
        # with dispatch bookkeeping.
        self._health_lock = threading.Lock()
        self._rank_health: Dict[str, dict] = {}
        self._rank_beats: Dict[str, float] = {}

    def rank_nodes(self) -> List[str]:
        """Node of every rank — ranks fill hosts in order,
        ``num_procs_per_node`` per host. Feed to
        ``MLDataset(rank_nodes=...)`` for locality-preferring shard plans.

        A rank's node is named as the object store names it (``node-0``
        ...), so it compares with the blocks' nodes: the node placement
        put its host on, else the driver's node for a rank on this host,
        else the host itself. The reference returns the host address,
        which no block node equals."""
        nodes = []
        for r in range(self.world_size):
            h = (r // self.num_procs_per_node) % len(self.hosts)
            if self.host_nodes is not None:
                nodes.append(self.host_nodes[h])
            elif self.hosts[h] in _LOCAL_HOSTS:
                nodes.append(DEFAULT_NODE)
            else:
                nodes.append(self.hosts[h])
        return nodes

    # ------------------------------------------------------------------ start

    def start(self) -> "SPMDJob":
        if self._started:
            raise SPMDJobError(f"job {self.job_name} already started")
        self._failed = None
        self._stopping = False
        self._gen += 1
        gen = self._gen
        self._register_barrier.clear()
        self._worker_addrs.clear()
        self._worker_hosts.clear()

        # Multi-host gangs must reach the driver across the network: bind
        # all interfaces and advertise the routable IP, not loopback.
        from raydp_tpu_torch.store.agent import agent_handlers
        from raydp_tpu_torch.store.object_store import ObjectStore
        from raydp_tpu_torch.utils.env import child_pythonpath
        from raydp_tpu_torch.utils.net import local_ip

        bind_host = "0.0.0.0" if self._multihost else "127.0.0.1"
        # The driver doubles as a store agent for dispatch blobs: ranks
        # pull oversize fn/args payloads via the same chunked
        # FetchObjectChunk protocol the data plane uses across hosts.
        if self._blob_store is None:
            self._blob_store = ObjectStore()
        self._server = RpcServer(
            DRIVER_SERVICE,
            {
                "RegisterWorker": self._on_register_worker,
                "FuncResult": self._on_func_result,
                "JobFailed": self._on_job_failed,
                "Ping": self._on_ping,
                "FetchObjectChunk": agent_handlers(self._blob_store)[
                    "FetchObjectChunk"
                ],
            },
            host=bind_host,
        )
        advertise = local_ip() if self._multihost else "127.0.0.1"
        driver_addr = f"{advertise}:{self._server.port}"
        coordinator = f"{self.hosts[0]}:{self._pick_coordinator_port()}"
        ctx = SPMDJobContext(
            self.job_name, self.world_size, self.hosts, self.num_procs_per_node
        )
        ctx.add_envs(self.base_env)
        prefix: List[str] = []
        if self.script_prepare_fn is not None:
            prefix = list(self.script_prepare_fn(ctx) or [])

        # The gang's trace: the driver's ambient context where there is
        # one (a gang in a session joins the session's trace), else a
        # root of its own. Its job, the same way: a gang launched under
        # a job (fit_spmd's) bills there; a standalone gang is its own
        # accounting root. Ranks inherit both through their env.
        self._trace_ctx = trace_prop.current_context()
        self._owns_trace_ctx = self._trace_ctx is None
        if self._trace_ctx is None:
            self._trace_ctx = trace_prop.mint_context(
                "spmd/job", job=self.job_name, world_size=self.world_size)
            trace_prop.set_process_context(self._trace_ctx)
        self._job_ctx = _acct.current_job()
        self._owns_job_ctx = self._job_ctx is None
        if self._job_ctx is None:
            self._job_ctx = _acct.mint_job(self.job_name,
                                           world_size=self.world_size)
            _acct.set_process_job(self._job_ctx)
        # Admission before any rank spawns: blocks in the arbiter's queue
        # while the pool is full, raises ClusterBusyError on a shed or an
        # admission timeout (the gang is torn down first).
        from raydp_tpu_torch.control import get_arbiter

        try:
            self._sched_lease = get_arbiter().ensure_admitted(
                self._job_ctx, slots=self.world_size, label=self.job_name,
                on_preempt=self.request_preemption)
        except Exception:
            self.stop()
            raise

        log_dir = os.path.join(
            tempfile.gettempdir(), "raydp_tpu_torch", "spmd",
            f"{self.job_name}-{os.getpid()}",
        )
        os.makedirs(log_dir, exist_ok=True)
        self._log_paths = []
        layout = host_layout(self.world_size, self.hosts,
                             self.num_procs_per_node)
        for rank in range(self.world_size):
            # Ranks keep the driver's cwd and import what it can (shipped
            # functions go by reference to its modules).
            env = dict(os.environ, PYTHONPATH=child_pythonpath())
            env.update(ctx.env)
            env.update(
                {
                    ENV_JOB_NAME: self.job_name,
                    ENV_RANK: str(rank),
                    ENV_WORLD_SIZE: str(self.world_size),
                    ENV_DRIVER_ADDR: driver_addr,
                    ENV_COORDINATOR: coordinator,
                    ENV_LOCAL_RANK: str(layout[rank][0]),
                    ENV_LOCAL_WORLD_SIZE: str(layout[rank][1]),
                    **trace_prop.env_for_child(self._trace_ctx),
                    **_acct.env_for_child(self._job_ctx),
                }
            )
            cmd = prefix + [sys.executable, "-m",
                            "raydp_tpu_torch.spmd.worker_main"]
            # Capture each rank's output so bring-up failures can show it
            # (the reference forwards mpirun output to the driver's stdout,
            # reference: mpi/utils.py:68-80; files keep it available after
            # the fact too).
            log_path = os.path.join(log_dir, f"rank-{rank}.log")
            self._log_paths.append(log_path)
            with open(log_path, "ab") as logf:
                proc = subprocess.Popen(
                    cmd, env=env, stdout=logf, stderr=subprocess.STDOUT,
                )
            self._procs.append(proc)
            threading.Thread(
                target=self._watch_proc, args=(proc, rank, gen), daemon=True
            ).start()

        self._await_registration()
        if self._failed:
            # A rank crashed during bring-up; the barrier was released by
            # _fail so this raises immediately, not after the timeout.
            reason = self._failed
            tails = self._log_tails()
            self.stop()
            raise SPMDJobError(
                f"job {self.job_name} failed: {reason}" + tails
            )
        for rank, addr in self._worker_addrs.items():
            self._stubs[rank] = RpcClient(addr, WORKER_SERVICE, timeout=None)
        self.last_registered = len(self._worker_addrs)
        self._started = True
        _events.emit(
            "gang/launch", job=self._job_ctx, gang=self.job_name,
            world_size=self.world_size, registered=self.last_registered,
            gen=self._gen,
        )
        return self

    @property
    def log_paths(self) -> List[str]:
        """Each rank's log file, rank-ordered
        (``<tmp>/raydp_tpu_torch/spmd/<job>-<driver pid>/rank-<r>.log``)."""
        return list(self._log_paths)

    def _await_registration(self) -> None:
        """Progress-aware registration barrier. A fixed wall timeout fails
        spuriously when cold imports contend for CPU, so: the soft window
        (``timeout``) resets whenever a new rank registers, and workers
        that are still *alive* are waited on past it up to the hard cap
        (``max(10×soft, 300)``s). Dead-without-
        registering ranks fail fast via the process watcher. Failure
        messages carry each rank's log tail."""
        soft, hard = self._registration_timeouts()
        start_t = time.monotonic()
        deadline = start_t + soft
        seen = 0
        while not self._register_barrier.wait(1.0):
            now = time.monotonic()
            got = len(self._worker_addrs)
            if got > seen:
                seen = got
                deadline = now + soft  # progress resets the soft window
                continue
            if now < deadline:
                continue
            alive = all(p.poll() is None for p in self._procs)
            if alive and now < start_t + hard:
                continue  # slow but alive: cold imports on a loaded host
            tails = self._log_tails()
            self.last_registered = got
            self.stop()
            raise SPMDJobError(
                f"job {self.job_name}: only {got}/{self.world_size} ranks "
                f"registered within {now - start_t:.0f}s "
                f"(soft={soft:.0f}s hard={hard:.0f}s, "
                f"workers alive={alive})" + tails
            )

    def _registration_timeouts(self) -> "tuple[float, float]":
        """(soft, hard) windows for the registration barrier. The env vars
        take precedence over the constructor's values, the soft window's
        and the hard cap's alike (``raydp_tpu/spmd/job.py:419-431``)."""
        soft = float(os.environ.get(ENV_REGISTER_TIMEOUT) or self.timeout)
        hard_env = os.environ.get(ENV_REGISTER_HARD_TIMEOUT)
        if hard_env:
            hard = float(hard_env)
        elif self.register_hard_timeout is not None:
            hard = float(self.register_hard_timeout)
        else:
            hard = max(_REGISTER_HARD_FACTOR * soft, _REGISTER_HARD_MIN_S)
        return soft, hard

    def _log_tails(self, limit: int = 2000) -> str:
        """Last ``limit`` bytes of every rank's captured output, formatted
        for inclusion in an error message ('' when nothing captured)."""
        parts = []
        for rank, path in enumerate(self._log_paths):
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() - limit))
                    text = f.read().decode("utf-8", "replace").strip()
            except OSError:
                continue
            if text:
                parts.append(f"--- rank {rank} ({path}) ---\n{text}")
        if not parts:
            return ""
        return "\nworker logs:\n" + "\n".join(parts)

    def _pick_coordinator_port(self) -> int:
        """The ``torch.distributed`` coordinator's port. Probing only
        proves a port is free on THIS machine, so it is used only when
        rank 0 runs here; multi-host launches take ``coordinator_port``
        (default 8476). The probe releases the port, and rank 0's
        ``TCPStore`` binds it later: a process that takes it in between
        makes ``init_distributed`` raise an error naming the port."""
        if self.coordinator_port is not None:
            return self.coordinator_port
        if self.hosts[0] in _LOCAL_HOSTS:
            return find_free_port()
        return 8476

    def _watch_proc(self, proc: subprocess.Popen, rank: int, gen: int) -> None:
        """A rank exiting nonzero fails the whole gang (the reference's
        mpirun watcher thread, reference: mpi/utils.py:53-66). Scoped to
        one incarnation: a rank reaped by stop() (or outliving into a
        restarted gang) must not poison the next one."""
        code = proc.wait()
        if code not in (0, None) and gen == self._gen and not self._stopping:
            _events.emit("rank/dead", job=self._job_ctx, gang=self.job_name,
                         rank=rank, rc=code, gen=gen)
            self._fail(f"rank {rank} exited with code {code}")

    def _fail(self, reason: str) -> None:
        self._failed = reason
        _flight.record("error", "spmd_fail", job=self.job_name,
                       reason=str(reason)[:200])
        _events.emit("gang/failed", job=self._job_ctx, gang=self.job_name,
                     reason=str(reason)[:200])
        logger.warning("SPMD job %s failed: %s", self.job_name, reason)
        self._register_barrier.set()  # wake a start() still waiting
        inflight = self._inflight
        if inflight is not None:
            inflight.done.set()

    # ----------------------------------------------------------- rpc handlers

    def _on_register_worker(self, req: dict) -> dict:
        rank = req["rank"]
        self._worker_addrs[rank] = req["address"]
        self._worker_hosts[rank] = req["host"]
        if len(self._worker_addrs) == self.world_size:
            self._register_barrier.set()
        return {"ok_rank": rank}

    def _on_func_result(self, req: dict) -> dict:
        inflight = self._inflight
        if inflight is None or req["func_id"] != inflight.func_id:
            return {"stale": True}
        inflight.post(req["rank"], req.get("value"), req.get("error"))
        return {"stale": False}

    def _on_job_failed(self, req: dict) -> dict:
        self._fail(req.get("reason", "worker-reported failure"))
        return {}

    def _on_ping(self, req: dict) -> dict:
        # A rank's heartbeat: the answer is its proof that the driver
        # lives (it exits after missing three). It carries the rank's
        # metric delta and its watchdog's stall flags; a beat without
        # flags means the rank sees no stall.
        rank_key = f"rank-{req.get('rank', '?')}"
        delta = req.get("metrics")
        if delta:
            self.telemetry.apply(rank_key, delta)
        with self._health_lock:
            self._rank_health[rank_key] = (
                (req.get("health") or {}).get("stalls") or {})
            self._rank_beats[rank_key] = time.monotonic()
        return {"pong": True, "gen": self._gen}

    def metrics_snapshot(self) -> dict:
        """Merged per-rank metrics view (the deltas shipped on Pings)."""
        return self.telemetry.merged()

    def capture_profile(self, seconds: float = 3.0,
                        out_dir: Optional[str] = None) -> dict:
        """A trace capture across the gang: every rank starts a
        ``torch.profiler`` trace at (nearly) the same wall instant,
        records for ``seconds`` and ships its directory back as a zip;
        the driver merges them into one clock-aligned Perfetto file
        (``merged_trace.json`` under ``out_dir``, a temporary directory
        by default). One thread a rank, so the start skew is an RPC's
        latency; each capture runs on the rank's RPC handler thread,
        beside the shipped function on its runner thread, so it samples
        live training. A rank that fails is named under ``errors``."""
        if not self._started:
            raise SPMDJobError("job not started")
        from raydp_tpu_torch.telemetry import device_profiler

        out_dir = out_dir or tempfile.mkdtemp(prefix="raydp-gang-profile-")
        payloads: Dict[int, dict] = {}
        errors: Dict[int, str] = {}

        def _one(rank: int, stub: RpcClient) -> None:
            try:
                payloads[rank] = stub.call(
                    "ProfileRequest", {"seconds": seconds},
                    timeout=seconds + 30.0)
            except Exception as exc:  # a partial gang still merges
                errors[rank] = str(exc)

        threads = [threading.Thread(target=_one, args=(rank, stub),
                                    daemon=True)
                   for rank, stub in sorted(self._stubs.items())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 60.0)
        if not payloads:
            raise SPMDJobError(
                f"profile capture failed on every rank: {errors}")
        merged = device_profiler.merge_rank_traces(
            [payloads[r] for r in sorted(payloads)], out_dir)
        if errors:
            merged["errors"] = errors
        _flight.record("profile", "merged", job=self.job_name,
                       ranks=len(payloads))
        return merged

    def resource_report(self) -> dict:
        """Per-rank resources from the shipped gauges: host RSS, the
        card's memory in use and at peak, compile counters, and, once a
        rank has shipped an epoch's phase gauges, its phase fractions,
        ``bound`` and ``mfu``. Ranks that shipped nothing yet appear with
        zeros."""
        from raydp_tpu_torch.telemetry import device_profiler

        view = self.telemetry.merged()
        ranks = {}
        for rid, sections in sorted((view.get("workers") or {}).items()):
            gauges = sections.get("gauges") or {}
            counters = sections.get("counters") or {}
            ranks[rid] = {
                "rss_bytes": gauges.get("mem/rss_bytes", 0),
                "rss_peak_bytes": gauges.get("mem/rss_peak_bytes", 0),
                "hbm_used_bytes": gauges.get("hbm/used_bytes", 0),
                "hbm_peak_bytes": gauges.get("hbm/peak_bytes", 0),
                "compiles": counters.get("compile/count", 0),
                "compile_seconds": counters.get("compile/seconds", 0.0),
                "compile_failures": counters.get("compile/failures", 0),
            }
            fractions = {
                name: gauges[f"phase/{name}"]
                for name in ("input_wait_frac", "dispatch_frac",
                             "compute_frac", "collective_frac")
                if f"phase/{name}" in gauges
            }
            if fractions:
                ranks[rid]["phases"] = fractions
                ranks[rid]["bound"] = device_profiler.classify_fractions(
                    fractions)
            if "mfu" in gauges:
                ranks[rid]["mfu"] = gauges["mfu"]
        agg = view.get("aggregate") or {}
        agg_gauges = agg.get("gauges") or {}
        agg_counters = agg.get("counters") or {}
        return {
            "ranks": ranks,
            "totals": {
                "rss_bytes": agg_gauges.get("mem/rss_bytes", 0),
                "hbm_used_bytes": agg_gauges.get("hbm/used_bytes", 0),
                "hbm_peak_bytes": agg_gauges.get("hbm/peak_bytes", 0),
                "compiles": agg_counters.get("compile/count", 0),
                "compile_seconds": agg_counters.get("compile/seconds",
                                                    0.0),
            },
        }

    def usage_report(self) -> dict:
        """Per-job usage folded from the ranks' shipped counters
        (chip-seconds, bytes moved): the gang's face of
        :func:`raydp_tpu_torch.telemetry.accounting.usage_report`."""
        return _acct.usage_report(self.telemetry.merged())

    # A rank quiet for half this window is late, for all of it dead (the
    # vocabulary of Cluster.health_report).
    PING_TIMEOUT_S = 30.0

    def health_report(self) -> dict:
        """Gang health: per-rank stall flags from the Pings, aged against
        each rank's last Ping (late, dead), plus the job's failure state.
        Ranks outside the current world (an elastic restart shrank the
        gang) are reported as departed."""
        now = time.monotonic()
        with self._health_lock:
            snapshot = dict(self._rank_health)
            beats = dict(self._rank_beats)
        ranks: Dict[str, dict] = {}
        departed: List[str] = []
        for rid in sorted(snapshot):
            try:
                idx = int(rid.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                idx = -1
            if 0 <= idx < self.world_size:
                ranks[rid] = dict(snapshot[rid])
            else:
                departed.append(rid)
        stalled = sorted(rid for rid, stalls in ranks.items() if stalls)
        # A rank that has not beaten yet (a gang just launched) ages
        # from now.
        dead = sorted(rid for rid in ranks
                      if now - beats.get(rid, now) > self.PING_TIMEOUT_S)
        late = sorted(rid for rid in ranks if rid not in dead
                      and now - beats.get(rid, now) > self.PING_TIMEOUT_S / 2)
        return {
            "healthy": not (stalled or dead or late) and not self._failed,
            "ranks": ranks,
            "stalled_ranks": stalled,
            "dead_ranks": dead,
            "late_ranks": late,
            "departed_ranks": departed,
            "failed": self._failed,
            "world_size": self.world_size,
        }

    # -------------------------------------------------------------------- run

    def run(
        self,
        fn: Callable[..., Any],
        timeout: Optional[float] = None,
        per_rank_args: Optional[List[tuple]] = None,
    ) -> List[Any]:
        """Ship ``fn(worker_context, *args)`` to every rank; return
        rank-ordered results (reference: MPIJob.run, mpi/mpi_job.py:321-335).

        ``per_rank_args`` scatters: rank ``r`` receives only
        ``per_rank_args[r]`` — large per-rank payloads (data shards) are
        serialized once per rank, not world× to every rank."""
        if not self._started:
            raise SPMDJobError("job not started")
        if self._failed:
            raise SPMDJobError(f"job {self.job_name} failed: {self._failed}")
        if per_rank_args is not None and len(per_rank_args) != self.world_size:
            raise ValueError(
                f"per_rank_args has {len(per_rank_args)} entries for "
                f"world_size {self.world_size}"
            )
        # The lock covers only the inflight-slot claim: a second
        # concurrent run() fails fast instead of queueing behind it.
        with self._lock:
            if self._inflight is not None:
                raise SPMDJobError(
                    f"job {self.job_name} already has function "
                    f"{self._inflight.func_id} in flight; SPMDJob.run() "
                    f"is one-at-a-time"
                )
            self._func_id += 1
            func_id = self._func_id
            results = _FuncResults(func_id, self.world_size)
            self._inflight = results
        staged_ids: List[str] = []
        label = f"{self.job_name}/func{func_id}"
        _flight.record("dispatch", "start", job=self.job_name,
                       func_id=func_id)
        try:
            # A gang that never reports back (a rank wedged in a
            # collective) shows as "spmd/dispatch" on the driver; the
            # dispatch may run to its own deadline, so the threshold is
            # that deadline.
            with _watchdog.inflight(
                "spmd/dispatch", job=self.job_name, func_id=func_id,
                stall_after_s=timeout or max(self.timeout, 60.0),
            ), span("spmd/dispatch", job=self.job_name, func_id=func_id,
                    world_size=self.world_size):
                fn_blob = closure.dumps(fn)
                inline_cap = _env_mb(ENV_INLINE_CAP, _DEFAULT_INLINE_CAP_MB)
                hard_cap = _env_mb(ENV_PAYLOAD_HARD_CAP, _DEFAULT_HARD_CAP_MB)
                for rank, stub in self._stubs.items():
                    payload: Dict[str, Any] = {"func_id": func_id}
                    blobs = {"fn": fn_blob}
                    nbytes = len(fn_blob)
                    if per_rank_args is not None:
                        blob = closure.dumps(tuple(per_rank_args[rank]))
                        blobs["args"] = blob
                        nbytes += len(blob)
                    if nbytes > hard_cap:
                        # Fail fast: retrying an over-the-ceiling payload is
                        # deterministic waste, so retryable=False.
                        raise DispatchPayloadError(
                            f"dispatch payload for rank {rank} is {nbytes} "
                            f"bytes, over the {ENV_PAYLOAD_HARD_CAP} hard cap "
                            f"of {hard_cap} bytes",
                            label=label, payload_bytes=nbytes, retryable=False,
                        )
                    if nbytes > inline_cap:
                        # Oversize payload: stage in the driver-local store;
                        # the envelope carries only refs and the rank pulls
                        # the bytes back in bounded chunks.
                        for key, blob in blobs.items():
                            ref = self._blob_store.put(blob)
                            staged_ids.append(ref.object_id)
                            payload[f"{key}_ref"] = ref.object_id
                            payload[f"{key}_size"] = len(blob)
                        _metrics.counter_add("spmd/oversize_dispatches")
                        _metrics.counter_add("spmd/staged_bytes", nbytes)
                        send_bytes = 4096
                    else:
                        payload.update(blobs)
                        send_bytes = nbytes
                    # Deadline sized to the bytes riding THIS envelope (refs
                    # make it constant) at a worst-case ~10 MB/s, on top of
                    # the control default — NOT the whole-job timeout, which
                    # would let the serial send loop hide failures for
                    # world×timeout.
                    try:
                        stub.call("RunFunction", payload,
                                  timeout=10.0 + send_bytes / 10e6)
                    except Exception as exc:
                        if nbytes <= inline_cap:
                            raise
                        raise DispatchPayloadError(
                            f"oversize dispatch to rank {rank} failed after "
                            f"staging ({nbytes} bytes): {exc}",
                            label=label, payload_bytes=nbytes, retryable=True,
                            server_exception=type(exc).__name__,
                        ) from exc
                if not results.done.wait(timeout or max(self.timeout, 60.0)):
                    raise SPMDJobError(
                        f"function {func_id} timed out on job {self.job_name}"
                    )
                if self._failed:
                    raise SPMDJobError(
                        f"job {self.job_name} failed mid-function: "
                        f"{self._failed}"
                    )
                errors = [
                    f"rank {i}: {e}" for i, e in enumerate(results.errors) if e
                ]
                if errors:
                    raise SPMDJobError(
                        f"function failed on {len(errors)} rank(s):\n"
                        + "\n".join(errors)
                    )
                return results.results
        finally:
            self._inflight = None
            # Staged blobs are per-dispatch; every rank has either
            # fetched them or failed by now.
            for object_id in staged_ids:
                try:
                    self._blob_store.delete(object_id)
                except Exception:
                    pass

    def request_preemption(self) -> None:
        """Deliver a preemption notice to every live rank
        (``raydp_tpu/spmd/job.py:844-881``): each rank's ``Preempt``
        handler sets its drain flag, so a training function finishes its
        step, writes an emergency checkpoint and raises
        ``PreemptionError``. A rank that does not answer gets SIGTERM
        (which its drain handler routes the same way); a rank that has
        exited is skipped. Each rank's grace is its
        ``RAYDP_TPU_PREEMPT_GRACE_S``. Advisory: never raises."""
        _events.emit("preempt/request", job=self._job_ctx,
                     gang=self.job_name, source="scheduler", gen=self._gen)
        _flight.record("supervisor", "preempt_notice", job=self.job_name,
                       ranks=len(self._procs))
        notified = set()
        for rank, stub in list(self._stubs.items()):
            try:
                if stub.try_call("Preempt", {}, timeout=5.0) is not None:
                    notified.add(rank)
            except Exception:
                pass
        for rank, proc in enumerate(list(self._procs)):
            if rank in notified or proc.poll() is not None:
                continue
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def get_rank_addresses(self) -> List[str]:
        """Host of each rank, rank-ordered (reference: mpi_job.py:337-339)."""
        return [self._worker_hosts[r] for r in range(self.world_size)]

    # ------------------------------------------------------------------- stop

    def stop(self) -> None:
        """Stop workers, reap processes; the job can be start()ed again
        (reference: MPIJob.stop/_reset, mpi/mpi_job.py:341-398)."""
        self._stopping = True
        if self._started:
            _events.emit("gang/teardown", job=self._job_ctx,
                         gang=self.job_name, world_size=self.world_size,
                         gen=self._gen)
        for stub in self._stubs.values():
            try:
                stub.call("Stop", {}, timeout=2.0)
            except Exception:
                pass
            stub.close()
        deadline = time.time() + 5.0
        for proc in self._procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if self._server is not None:
            self._server.stop()
        self._server = None
        if self._blob_store is not None:
            try:
                self._blob_store.destroy()
            except Exception:
                pass
            self._blob_store = None
        self._procs = []
        self._stubs = {}
        self._worker_addrs = {}
        self._worker_hosts = {}
        self._inflight = None
        self._started = False
        if self._owns_trace_ctx and self._trace_ctx is not None:
            if trace_prop.process_context() == self._trace_ctx:
                trace_prop.set_process_context(None)
        self._trace_ctx = None
        self._owns_trace_ctx = False
        if self._sched_lease is not None:
            self._sched_lease.release()
            self._sched_lease = None
        if self._owns_job_ctx and self._job_ctx is not None:
            if _acct.process_job() == self._job_ctx:
                _acct.set_process_job(None)
        self._job_ctx = None
        self._owns_job_ctx = False

    def __enter__(self) -> "SPMDJob":
        if not self._started:
            self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.stop()

    def __del__(self):
        if self._started:
            try:
                self.stop()
            except Exception:
                pass


def create_spmd_job(
    job_name: str,
    world_size: int,
    num_procs_per_node: int = 1,
    script_prepare_fn: Optional[Callable[[SPMDJobContext], List[str]]] = None,
    env: Optional[Dict[str, str]] = None,
    timeout: float = 30.0,
    hosts: Optional[List[str]] = None,
    coordinator_port: Optional[int] = None,
    placement_strategy: Optional[str] = None,
    placement_group=None,
) -> SPMDJob:
    """Create (but do not start) an SPMD job — the reference's
    ``create_mpi_job`` entry point (reference: mpi/__init__.py:36-91).

    The MPI-flavor dispatch (OpenMPI/IntelMPI/MPICH) collapses away: there
    is one launcher, and ``script_prepare_fn`` covers launcher
    customization. ``placement_strategy``/``placement_group`` reserve one
    bundle per gang host over the cluster's nodes and derive ``hosts``
    from the assignment (the reference reserves a STRICT_SPREAD group and
    discovers node IPs with peer actors — mpi/mpi_job.py:193-223).
    """
    pg = placement_group
    host_nodes = None
    if hosts is None and (placement_strategy is not None or pg is not None):
        from raydp_tpu_torch.cluster import placement as pl
        from raydp_tpu_torch.context import current_session

        # The live session's nodes (a client's master proxy has none).
        session = current_session()
        master = session.cluster.master if session is not None else None
        nodes = getattr(master, "nodes", None) or pl.detect_nodes()
        n_hosts = -(-world_size // num_procs_per_node)
        if pg is None:
            bundles = [{"cpu": float(num_procs_per_node)}] * n_hosts
            pg = pl.place(bundles, placement_strategy, nodes)
        addr_of = {n.node_id: n.address for n in nodes}
        host_nodes = [b.node_id for b in pg.bundles[:n_hosts]]
        hosts = [addr_of.get(n, "127.0.0.1") for n in host_nodes]
    job = SPMDJob(
        job_name=job_name,
        world_size=world_size,
        num_procs_per_node=num_procs_per_node,
        script_prepare_fn=script_prepare_fn,
        env=env,
        timeout=timeout,
        hosts=hosts,
        coordinator_port=coordinator_port,
        host_nodes=host_nodes,
    )
    job.placement_group = pg
    return job

