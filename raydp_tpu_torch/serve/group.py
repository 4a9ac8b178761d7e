"""Self-healing replica group: the serving plane's supervisor.

The counterpart of ``raydp_tpu/serve/group.py``. A :class:`ReplicaGroup`
owns N replica *lineages*. Each lineage is a slot thread that spawns
``python -m raydp_tpu_torch.serve.replica_main`` as a child process on
the group's device, registers it (the registration reply ships the
pickled model function), and then acts as that replica's dispatcher:
pull a batch from the shared
:class:`~raydp_tpu_torch.serve.batching.RequestQueue`, ship it as one
``ExecuteBatch`` envelope, deliver replies. Replica death at ANY point,
mid-batch included, requeues the batch's un-replied requests at the
front of the queue, where a surviving lineage's dispatcher picks them
up: zero dropped requests, with the queue's replied-flag dedup keeping
delivery at-most-once when a presumed-dead replica's reply races the
retry.

Supervision: jittered exponential backoff between respawns under a
per-lineage restart budget (``RAYDP_TPU_SERVE_MAX_RESTARTS``). The
model function travels with ``pickle``, that is by reference: a
module-level function or a ``functools.partial`` of one, importable in
the child, whose ``PYTHONPATH`` carries this process's ``sys.path``.
The group's ``device`` is the one setting of where the model runs: a
model function (or decode engine factory) that takes a ``device``
keyword is called with the group's, whatever it binds itself.
The group's lifecycle lands on the event timeline as the reference's
does (``serve/start``, ``replica_up``, ``replica_down``, ``requeue``,
``lineage_dead``, ``drain``, ``stop``).

The control plane (``raydp_tpu/serve/group.py:426-445, 578-582``):
``start()`` bills the group to the ambient job (or mints one of its own,
which its replicas inherit through ``RAYDP_TPU_JOB``) and is admitted by
the cluster arbiter with ``slots = replicas``, so serving shares
capacity with training under one policy; a busy cluster raises
:class:`~raydp_tpu_torch.control.ClusterBusyError` there (the HTTP
frontend's 429). The arbiter's preemption of the group
(:meth:`ReplicaGroup._on_preempt`) drains it; ``stop()`` releases the
lease. An :class:`~raydp_tpu_torch.control.Autoscaler` reads the
group's queue once registered with ``register_serve_group``.
"""
from __future__ import annotations

import logging
import os
import pickle
import random
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from raydp_tpu_torch.cluster.rpc import RpcClient, RpcServer
from raydp_tpu_torch.serve.batching import (
    DecodeState,
    PHASE_LABELS,
    RequestQueue,
    ServeRequest,
)
from raydp_tpu_torch.serve.replica_main import (
    ENV_DEVICE,
    ENV_GROUP,
    ENV_INCARNATION,
    ENV_MODE,
    ENV_REPLICA,
    ENV_SERVE_DRIVER_ADDR,
    REPLICA_SERVICE,
    SERVE_DRIVER_SERVICE,
)
from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device
from raydp_tpu_torch.utils.env import _env_float, _env_int, child_pythonpath
from raydp_tpu_torch.utils.profiling import metrics

logger = logging.getLogger(__name__)

SERVE_REPLICAS_ENV = "RAYDP_TPU_SERVE_REPLICAS"
SERVE_MAX_RESTARTS_ENV = "RAYDP_TPU_SERVE_MAX_RESTARTS"
SERVE_RESTART_BACKOFF_ENV = "RAYDP_TPU_SERVE_RESTART_BACKOFF_S"
SERVE_DISPATCH_TIMEOUT_ENV = "RAYDP_TPU_SERVE_DISPATCH_TIMEOUT_S"

_DEFAULT_REPLICAS = 2
_DEFAULT_MAX_RESTARTS = 3
_DEFAULT_BACKOFF_S = 0.5
_DEFAULT_DISPATCH_TIMEOUT_S = 30.0
_REGISTER_TIMEOUT_S = 30.0
# How long a retired incarnation may take to exit by itself before
# it is terminated: a drained replica stops its RPC server before its
# interpreter exits, and a SIGTERM during that exit kills it.
_SELF_EXIT_S = 5.0


class ServeError(RuntimeError):
    """Serving control-plane failure (spawn, registration, budget)."""


def _reap(proc: subprocess.Popen, grace_s: float = 5.0,
          exit_s: float = 0.0) -> None:
    """Wait up to ``exit_s`` for ``proc`` to exit by itself, then
    terminate it (SIGTERM, then SIGKILL after ``grace_s``) and wait for
    it to exit."""
    try:
        proc.wait(timeout=exit_s)
    except subprocess.TimeoutExpired:
        pass
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


class _ReplicaSlot:
    """One replica lineage: spawn → register → dispatch → respawn."""

    def __init__(self, group: "ReplicaGroup", index: int):
        self.group = group
        self.index = index
        self.restarts = 0
        self.proc: Optional[subprocess.Popen] = None
        self.addr: Optional[str] = None
        self.registered = threading.Event()
        self.alive = False
        self.dead_lineage = False
        self.thread = threading.Thread(
            target=self._run, daemon=True, name=f"serve-slot-{index}"
        )

    # -- registration callback (driver RPC thread) ----------------------

    def on_register(self, addr: str) -> None:
        self.addr = addr
        self.registered.set()

    # -- lineage loop ---------------------------------------------------

    def _run(self) -> None:
        g = self.group
        while not g._stopping.is_set():
            if self.restarts > g.max_restarts:
                self.dead_lineage = True
                logger.error(
                    "serve slot %d: restart budget exhausted "
                    "(%d restarts); lineage abandoned",
                    self.index, g.max_restarts,
                )
                _events.emit("serve/lineage_dead", replica=self.index,
                             restarts=self.restarts, group=g.label)
                return
            try:
                self._spawn()
            except Exception as exc:
                logger.error(
                    "serve slot %d: spawn failed: %s", self.index, exc
                )
                self._backoff()
                continue
            stub = RpcClient(self.addr, REPLICA_SERVICE)
            self.alive = True
            g._publish_alive()
            _events.emit("serve/replica_up", replica=self.index,
                         incarnation=self.restarts, group=g.label)
            try:
                self._dispatch(stub)
            finally:
                self.alive = False
                g._publish_alive()
                try:
                    stub.close()
                except Exception:
                    pass
            if g._stopping.is_set():
                return
            self._retire()
            metrics.counter_add("serve/restarts")
            _events.emit("serve/replica_down", replica=self.index,
                         group=g.label, exit_code=self.proc.returncode)
            logger.warning(
                "serve slot %d: replica down (exit code %s); respawning",
                self.index, self.proc.returncode,
            )
            self._backoff()

    def _spawn(self) -> None:
        g = self.group
        self.registered.clear()
        self.addr = None
        env = dict(os.environ)
        env.update(
            {
                ENV_REPLICA: str(self.index),
                ENV_INCARNATION: str(self.restarts),
                ENV_GROUP: g.label,
                ENV_MODE: g.mode,
                ENV_DEVICE: str(g.device),
                ENV_SERVE_DRIVER_ADDR: g._driver_addr,
                **_acct.env_for_child(g._job_ctx),
                # The child resolves the model by reference: it sees
                # every module this process can import.
                "PYTHONPATH": child_pythonpath(),
            }
        )
        cmd = [sys.executable, "-m", "raydp_tpu_torch.serve.replica_main"]
        log_path = os.path.join(g._log_dir, f"replica-{self.index}.log")
        with g._spawn_mu, open(log_path, "ab") as logf:
            # Under the lock stop() takes after setting _stopping: no
            # replica is spawned once stop() has begun.
            if g._stopping.is_set():
                raise ServeError(f"replica group {g.label} is stopping")
            # raydp: ignore[R1] -- Popen returns once the child exists
            self.proc = subprocess.Popen(
                cmd, env=env, stdout=logf, stderr=subprocess.STDOUT
            )
        deadline = time.monotonic() + _REGISTER_TIMEOUT_S
        while not self.registered.wait(timeout=0.1):
            if g._stopping.is_set():
                _reap(self.proc)
                raise ServeError(f"replica group {g.label} is stopping")
            if time.monotonic() >= deadline:
                _reap(self.proc)
                raise ServeError(
                    f"replica {self.index} did not register within "
                    f"{_REGISTER_TIMEOUT_S:.0f}s (log: {log_path})"
                )
            if self.proc.poll() is not None:
                raise ServeError(
                    f"replica {self.index} exited with code "
                    f"{self.proc.returncode} before registering "
                    f"(log: {log_path})"
                )

    def _retire(self) -> None:
        """The dispatcher gave up on this incarnation (it died, timed
        out, failed a call or drained): make sure it is gone before its
        successor starts, so no replica runs unsupervised. It gets
        ``_SELF_EXIT_S`` to exit by itself first, so a clean drain
        exits 0 rather than by a SIGTERM."""
        _reap(self.proc, exit_s=_SELF_EXIT_S)

    def _backoff(self) -> None:
        self.restarts += 1
        delay = self.group.restart_backoff_s * (2 ** (self.restarts - 1))
        delay *= 1.0 + random.uniform(0.0, 0.25)
        self.group._stopping.wait(timeout=delay)

    # -- dispatch -------------------------------------------------------

    def _dispatch(self, stub: RpcClient) -> None:
        """Pull batches and ship them until the replica dies or the
        group stops. Every failure path requeues the batch."""
        g = self.group
        if g.mode == "decode":
            try:
                self._dispatch_decode(stub)
            finally:
                # Replica gone (or group stopping): every sequence this
                # lineage still owns re-enters the queue as a prefill —
                # cache is lost, the generated-so-far prefix is re-fed.
                g._decode_requeue_for_slot(self.index)
            return
        while not g._stopping.is_set():
            if self.proc is not None and self.proc.poll() is not None:
                return
            batch = g.queue.next_batch(wait_timeout=0.25)
            if not batch:
                continue
            payload = {
                "requests": [
                    {"id": r.request_id, "payload": r.payload}
                    for r in batch
                ],
                "bucket": g.queue.bucket_for(
                    max(r.length for r in batch)
                ),
            }
            t0 = time.monotonic()
            for r in batch:
                r.dispatched_mono = t0
            try:
                reply = stub.call(
                    "ExecuteBatch", payload, timeout=g.dispatch_timeout_s
                )
            except Exception:
                # Dead or unreachable replica mid-batch: the requests
                # go BACK to the queue head and retry on a surviving
                # replica — the zero-dropped-request guarantee.
                g.queue.requeue(batch)
                g._requeued(self.index, "dispatch_failed", batch)
                return
            if reply.get("draining"):
                # Drain refusal: replica got SIGTERM/preemption after
                # assembly; hand the batch to a healthy lineage and
                # wait out this incarnation.
                g.queue.requeue(batch)
                g._requeued(self.index, "draining", batch)
                self._await_exit()
                return
            wall = time.monotonic() - t0
            g.queue.observe_service_time(wall / max(1, len(batch)))
            metrics.histogram(
                f"serve/replica/{self.index}/latency"
            ).observe(wall)
            results = reply.get("results") or []
            exec_s = reply.get("exec_s")
            for req, result in zip(batch, results):
                if isinstance(exec_s, (int, float)):
                    req.exec_s = float(exec_s)
                g.queue.complete(req, result=result)
            for req in batch[len(results):]:
                g.queue.complete(
                    req, error="replica returned short batch"
                )

    def _dispatch_decode(self, stub: RpcClient) -> None:
        """Admission pump for one decode replica: pull arrivals from
        the shared queue, ship them as ``AdmitSequences``, and requeue
        whatever the replica's slot pool cannot take. Token traffic
        flows the other way — the replica pushes ``DecodeEvents`` to
        the driver once per round."""
        g = self.group
        while not g._stopping.is_set():
            if self.proc is not None and self.proc.poll() is not None:
                return
            batch = g.queue.next_batch(wait_timeout=0.25)
            if not batch:
                continue
            now = time.monotonic()
            admitted: List[ServeRequest] = []
            payload = []
            for r in batch:
                if r.decode is None:
                    g.queue.complete(
                        r, error="decode group received a non-decode "
                                 "request (use generate())",
                    )
                    continue
                r.dispatched_mono = now
                st = r.decode
                # Refeed contract: an earlier incarnation's tokens ride
                # along in the prompt; start_index keeps the global
                # token indices (and so the dedup) contiguous.
                payload.append(
                    {
                        "id": r.request_id,
                        "tokens": st.prompt + st.tokens,
                        "start_index": len(st.tokens),
                        "max_new": st.max_new,
                        "eos": st.eos,
                        "deadline_s": max(0.05, r.remaining_s(now)),
                    }
                )
                admitted.append(r)
            if not admitted:
                continue
            try:
                reply = stub.call(
                    "AdmitSequences", {"requests": payload},
                    timeout=g.dispatch_timeout_s,
                )
            except Exception:
                g.queue.requeue(admitted)
                g._requeued(self.index, "admit_failed", admitted)
                return
            if reply.get("draining"):
                g.queue.requeue(admitted)
                g._requeued(self.index, "draining", admitted)
                self._await_exit()
                return
            if reply.get("error"):
                # A replica that cannot admit at all (wrong mode, bad
                # engine) would spin the requeue cycle forever — treat
                # it as dead and let supervision decide.
                logger.error(
                    "serve slot %d: admit error: %s",
                    self.index, reply["error"],
                )
                g.queue.requeue(admitted)
                return
            accepted = set(reply.get("accepted") or ())
            rejected = [
                r for r in admitted if r.request_id not in accepted
            ]
            for r in admitted:
                if r.request_id in accepted:
                    g._decode_track(r, self.index)
            if rejected:
                g.queue.requeue(rejected)
                # A full slot pool rejects everything; don't spin the
                # admit/requeue cycle against it.
                time.sleep(0.02)

    def _await_exit(self) -> None:
        if self.proc is None:
            return
        deadline = time.monotonic() + self.group.dispatch_timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.05)


class ReplicaGroup:
    """N supervised serving replicas behind one bounded request queue."""

    def __init__(
        self,
        replicas: Optional[int] = None,
        model_fn: Optional[Callable[[List[Any], int], List[Any]]] = None,
        label: str = "serve",
        max_queue: Optional[int] = None,
        slo_ms: Optional[float] = None,
        max_batch: Optional[int] = None,
        buckets: Optional[List[int]] = None,
        max_restarts: Optional[int] = None,
        restart_backoff_s: Optional[float] = None,
        dispatch_timeout_s: Optional[float] = None,
        mode: str = "batch",
        device: DeviceLike = "cuda",
    ):
        if mode not in ("batch", "decode"):
            raise ValueError(f"unknown serve mode {mode!r}")
        self.mode = mode
        self.replicas = (
            _env_int(SERVE_REPLICAS_ENV, _DEFAULT_REPLICAS)
            if replicas is None else int(replicas)
        )
        self.model_fn = model_fn
        self.label = label
        # Resolved at start(): a group may be built (and its cold stats
        # read) on a machine without the card it is meant for.
        self.device = device
        self.max_restarts = (
            _env_int(SERVE_MAX_RESTARTS_ENV, _DEFAULT_MAX_RESTARTS)
            if max_restarts is None else int(max_restarts)
        )
        self.restart_backoff_s = (
            _env_float(SERVE_RESTART_BACKOFF_ENV, _DEFAULT_BACKOFF_S)
            if restart_backoff_s is None else float(restart_backoff_s)
        )
        self.dispatch_timeout_s = (
            _env_float(SERVE_DISPATCH_TIMEOUT_ENV,
                       _DEFAULT_DISPATCH_TIMEOUT_S)
            if dispatch_timeout_s is None else float(dispatch_timeout_s)
        )
        self.queue = RequestQueue(
            max_depth=max_queue, slo_ms=slo_ms,
            max_batch=max_batch, buckets=buckets,
        )
        self._slots: List[_ReplicaSlot] = []
        self._stopping = threading.Event()
        self._spawn_mu = threading.Lock()
        self._started = False
        self._server: Optional[RpcServer] = None
        self._driver_addr = ""
        self._log_dir = ""
        self._job_ctx = None
        self._owns_job_ctx = False
        self._sched_lease = None
        self._model_blob: Optional[bytes] = None
        # Decode mode: driver-side truth for in-flight sequences —
        # request_id → (ServeRequest, owning slot index).
        self._decode_mu = threading.Lock()
        self._decode_inflight: Dict[str, Any] = {}

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ReplicaGroup":
        """Resolve the device, admit through the arbiter, bring up the
        driver RPC surface, and launch every lineage. Raises when the
        device is ``cuda`` and there is no card (the group never serves
        on the CPU by itself), :class:`ServeError` when ``model_fn``
        cannot be pickled, and
        :class:`~raydp_tpu_torch.control.ClusterBusyError` when the
        cluster has no capacity for the group."""
        if self._started:
            raise ServeError(f"replica group {self.label} already started")
        self.device = resolve_device(self.device)
        if self.model_fn is not None:
            try:
                self._model_blob = pickle.dumps(self.model_fn)
            except (pickle.PicklingError, AttributeError, TypeError) as exc:
                raise ServeError(
                    f"replica group {self.label}: model_fn "
                    f"{self.model_fn!r} cannot be pickled ({exc}); it is "
                    "shipped to the replicas by reference, so pass a "
                    "module-level function or a functools.partial of one"
                ) from exc
        self._job_ctx = _acct.current_job()
        self._owns_job_ctx = self._job_ctx is None
        if self._job_ctx is None:
            self._job_ctx = _acct.mint_job(self.label,
                                           world_size=self.replicas)
            _acct.set_process_job(self._job_ctx)
        from raydp_tpu_torch.control import get_arbiter

        try:
            self._sched_lease = get_arbiter().ensure_admitted(
                self._job_ctx, slots=self.replicas, label=self.label,
                on_preempt=self._on_preempt)
        except Exception:
            self._release_job()
            raise
        self._stopping.clear()
        self._server = RpcServer(
            SERVE_DRIVER_SERVICE,
            {
                "RegisterReplica": self._on_register_replica,
                "DecodeEvents": self._on_decode_events,
                "Ping": lambda req: {"pong": True},
            },
        )
        self._driver_addr = f"127.0.0.1:{self._server.port}"
        self._log_dir = os.path.join(
            tempfile.gettempdir(), "raydp_tpu_torch", "serve",
            f"{self.label}-{os.getpid()}",
        )
        os.makedirs(self._log_dir, exist_ok=True)
        _events.emit("serve/start", group=self.label, replicas=self.replicas,
                     max_batch=self.queue.max_batch,
                     slo_ms=self.queue.slo_s * 1000.0)
        self._slots = [
            _ReplicaSlot(self, i) for i in range(self.replicas)
        ]
        self._started = True
        for slot in self._slots:
            slot.thread.start()
        return self

    def _on_register_replica(self, req: dict) -> dict:
        idx = int(req["replica"])
        if not 0 <= idx < len(self._slots):
            raise ServeError(f"unknown replica index {idx}")
        self._slots[idx].on_register(req["addr"])
        return {
            "ok": True,
            "model": self._model_blob,
            "buckets": list(self.queue.buckets),
        }

    # -- decode token plane (driver RPC thread) -------------------------

    def _decode_track(self, req: ServeRequest, slot: int) -> None:
        with self._decode_mu:
            self._decode_inflight[req.request_id] = (req, slot)

    def _decode_requeue_for_slot(self, slot: int) -> None:
        """A dead replica's live sequences re-enter the queue as
        prefills. Generated-so-far tokens live driver-side, so nothing
        is lost with the cache; the queue's front-requeue + replied
        dedup keep the zero-drop / at-most-once contract intact."""
        with self._decode_mu:
            mine = [
                rid for rid, (_, s) in self._decode_inflight.items()
                if s == slot
            ]
            reqs = [self._decode_inflight.pop(rid)[0] for rid in mine]
        if not reqs:
            return
        metrics.counter_add("decode/requeued_prefills", len(reqs))
        n = self.queue.requeue(reqs)
        self._requeued(slot, "decode_replica_death", reqs, requeued=n)

    def _requeued(self, replica: int, reason: str, reqs,
                  **attrs: Any) -> None:
        """A ``serve/requeue`` event: which replica gave the requests
        back, why, and their ids."""
        _events.emit("serve/requeue", group=self.label, replica=replica,
                     reason=reason,
                     request_ids=[r.request_id for r in reqs], **attrs)

    def _on_decode_events(self, msg: dict) -> dict:
        """Apply one replica round's token/done events. Tokens append
        only when their global index equals the driver-side stream
        length — a late or replayed event from a presumed-dead replica
        is counted (``decode/dup_tokens``) and dropped."""
        now = time.monotonic()
        for ev in msg.get("tokens") or ():
            with self._decode_mu:
                entry = self._decode_inflight.get(ev["id"])
            if entry is None:
                metrics.counter_add("decode/dup_tokens")
                continue
            req = entry[0]
            st = req.decode
            idx = int(ev["index"])
            if idx == len(st.tokens):
                st.tokens.append(int(ev["token"]))
                if st.first_token_mono is None:
                    st.first_token_mono = now
                    metrics.histogram("decode/ttft").observe(
                        now - req.enqueued_mono
                    )
                metrics.counter_add("decode/tokens")
                metrics.meter("decode/throughput").add(1)
            else:
                metrics.counter_add("decode/dup_tokens")
        for d in msg.get("done") or ():
            with self._decode_mu:
                entry = self._decode_inflight.pop(d["id"], None)
            if entry is None:
                continue
            req = entry[0]
            st = req.decode
            reason = d.get("reason")
            if reason == "evict":
                # Recompute-preemption: back to the queue head as a
                # prefill; tokens so far stay with the request.
                metrics.counter_add("decode/evictions")
                self.queue.requeue([req])
                continue
            metrics.counter_add(f"decode/retired/{reason}")
            if reason in ("eos", "length"):
                st.finish_reason = reason
                n = len(st.tokens)
                if n > 1 and st.first_token_mono is not None:
                    metrics.histogram("decode/tpot").observe(
                        (now - st.first_token_mono) / (n - 1)
                    )
                self.queue.complete(
                    req,
                    result={
                        "tokens": list(st.tokens),
                        "n": n,
                        "finish_reason": reason,
                    },
                )
            elif reason == "timeout":
                self.queue.complete(
                    req,
                    error=f"request {req.request_id} deadline expired "
                          "mid-decode",
                )
            else:
                self.queue.complete(
                    req, error=f"decode retired with reason {reason!r}"
                )
        return {"ok": True}

    def _on_preempt(self) -> None:
        """The arbiter's preemption of the group: the whole group drains
        (replicas finish their in-flight batches, the queue stops
        admitting) on a thread of its own, off the arbiter's."""
        _events.emit("serve/preempt", group=self.label)
        threading.Thread(target=self.stop, daemon=True,
                         name=f"serve-preempt-{self.label}").start()

    def _release_job(self) -> None:
        """Return the arbiter's lease and drop a job this group minted."""
        if self._sched_lease is not None:
            self._sched_lease.release()
            self._sched_lease = None
        if self._owns_job_ctx:
            _acct.set_process_job(None)
            self._owns_job_ctx = False
        self._job_ctx = None

    def _publish_alive(self) -> None:
        metrics.gauge_set(
            "serve/replicas_alive",
            sum(1 for s in self._slots if s.alive),
        )

    # -- request path ---------------------------------------------------

    def submit(self, payload: Any, timeout_s: Optional[float] = None,
               request_id: Optional[str] = None) -> ServeRequest:
        """Admit one request (non-blocking). Raises
        :class:`~raydp_tpu_torch.serve.batching.QueueFullError` on overflow;
        the returned request's ``wait()`` blocks for the reply."""
        if not self._started:
            raise ServeError(f"replica group {self.label} not started")
        req = ServeRequest(payload, timeout_s=timeout_s,
                           request_id=request_id)
        self.queue.submit(req)
        return req

    def predict(self, payload: Any,
                timeout_s: Optional[float] = None) -> Any:
        return self.submit(payload, timeout_s=timeout_s).wait()

    def submit_generate(
        self,
        prompt: Any,
        max_new: int = 32,
        eos: Optional[int] = None,
        timeout_s: Optional[float] = None,
        request_id: Optional[str] = None,
    ) -> ServeRequest:
        """Admit one autoregressive request (decode mode). The request
        queues by prompt length; its reply is the assembled token
        stream ``{"tokens", "n", "finish_reason"}``."""
        if self.mode != "decode":
            raise ServeError(
                f"group {self.label} is mode={self.mode!r}; "
                "generate() needs mode='decode'"
            )
        if not self._started:
            raise ServeError(f"replica group {self.label} not started")
        prompt = [int(t) for t in prompt]
        req = ServeRequest(
            prompt, timeout_s=timeout_s, request_id=request_id,
            decode=DecodeState(prompt, max_new, eos=eos),
        )
        self.queue.submit(req)
        return req

    def generate(self, prompt: Any, max_new: int = 32,
                 eos: Optional[int] = None,
                 timeout_s: Optional[float] = None) -> Any:
        return self.submit_generate(
            prompt, max_new=max_new, eos=eos, timeout_s=timeout_s
        ).wait()

    # -- introspection --------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        # Histogram-backed: cumulative bucket counts merge exactly
        # across replicas, and an empty histogram reads as None: a cold
        # group reports nulls, never a fake 0 or a
        # KeyError from an empty summary.
        lat = metrics.histogram("serve/latency")
        thr = metrics.meter("serve/throughput").summary()
        snap = metrics.snapshot().get("counters", {})
        batches = snap.get("serve/batches", 0.0)
        batch_requests = snap.get("serve/batch_requests", 0.0)
        fill = (
            batch_requests / (batches * self.queue.max_batch)
            if batches else 0.0
        )
        per_replica = {}
        for slot in self._slots:
            h = metrics.histogram(
                f"serve/replica/{slot.index}/latency"
            )
            s = h.summary()
            per_replica[str(slot.index)] = {
                "alive": slot.alive,
                "restarts": slot.restarts,
                "p50_s": h.quantile(0.5),
                "p99_s": h.quantile(0.99),
                "batches": s["count"],
            }
        phases = {}
        for name in PHASE_LABELS:
            ph = metrics.histogram(f"serve/phase/{name}")
            s = ph.summary()
            count = s["count"]
            phases[name] = {
                "count": count,
                "total_s": round(float(s["sum"]), 6),
                "mean_s": (
                    round(float(s["sum"]) / count, 6) if count else None
                ),
                "p99_s": ph.quantile(0.99),
            }
        decode = None
        if self.mode == "decode":
            ttft = metrics.histogram("decode/ttft")
            tpot = metrics.histogram("decode/tpot")
            tok_rate = metrics.meter("decode/throughput").summary()
            with self._decode_mu:
                inflight = len(self._decode_inflight)
            decode = {
                "tokens": snap.get("decode/tokens", 0.0),
                "tokens_per_sec": round(tok_rate["per_sec"], 3),
                "ttft_p50_s": ttft.quantile(0.5),
                "ttft_p99_s": ttft.quantile(0.99),
                "tpot_p50_s": tpot.quantile(0.5),
                "tpot_p99_s": tpot.quantile(0.99),
                "inflight": inflight,
                "dup_tokens": snap.get("decode/dup_tokens", 0.0),
                "evictions": snap.get("decode/evictions", 0.0),
                "requeued_prefills": snap.get(
                    "decode/requeued_prefills", 0.0
                ),
                "retired": {
                    reason: snap.get(f"decode/retired/{reason}", 0.0)
                    for reason in
                    ("eos", "length", "timeout", "cancel", "evict")
                },
            }
        return {
            "group": self.label,
            "mode": self.mode,
            "decode": decode,
            "replicas": self.replicas,
            "replicas_alive": sum(1 for s in self._slots if s.alive),
            "dead_lineages": sum(
                1 for s in self._slots if s.dead_lineage
            ),
            "queue_depth": self.queue.depth(),
            "max_batch": self.queue.max_batch,
            "slo_ms": self.queue.slo_s * 1000.0,
            "accepted": snap.get("serve/requests", 0.0),
            "replies": snap.get("serve/replies", 0.0),
            "errors": snap.get("serve/errors", 0.0),
            "rejected": snap.get("serve/rejected", 0.0),
            "requeued": snap.get("serve/requeued", 0.0),
            "dup_replies": snap.get("serve/dup_replies", 0.0),
            "restarts": snap.get("serve/restarts", 0.0),
            "batch_fill": round(fill, 4),
            "requests_per_sec": round(thr["per_sec"], 3),
            "latency_p50_s": lat.quantile(0.5),
            "latency_p99_s": lat.quantile(0.99),
            "phases": phases,
            "per_replica": per_replica,
        }

    def ping(self, timeout: float = 30.0) -> List[Dict[str, Any]]:
        """Each replica's ``Ping`` reply, in replica order: the device
        its model runs on, the bytes it holds on the card, its flash
        kernel launch counts and, in decode mode once its engine is
        built, its captured graphs. A diagnostic; raises
        :class:`ServeError` for a replica that has not registered and
        :class:`RpcError` for one that does not answer."""
        out = []
        for slot in self._slots:
            addr = slot.addr
            if addr is None:
                raise ServeError(
                    f"replica {slot.index} of {self.label} has not "
                    "registered"
                )
            stub = RpcClient(addr, REPLICA_SERVICE)
            try:
                out.append(stub.call("Ping", {}, timeout=timeout))
            finally:
                stub.close()
        return out

    def drain_replica(self, index: int) -> bool:
        """Migrate one replica's work to its surviving siblings.

        The autoscaler's serve-drain hook: terminating the replica
        process routes any in-flight batch through the dispatcher's
        requeue path (back to the queue *head*, picked up by another
        lineage — zero drops), after which the slot's supervisor
        respawns the lineage as usual. Returns False when the index is
        unknown or the replica is not currently running.
        """
        if not self._started or not 0 <= index < len(self._slots):
            return False
        slot = self._slots[index]
        if slot.proc is None or slot.proc.poll() is not None:
            return False
        _events.emit("serve/drain", group=self.label, replica=index)
        slot.proc.terminate()
        return True

    # -- shutdown -------------------------------------------------------

    def stop(self) -> None:
        """Graceful teardown: stop admitting, stop the replicas and wait
        for their processes to exit, release the arbiter's lease.
        Idempotent."""
        if not self._started:
            return
        self._started = False
        self._stopping.set()
        with self._spawn_mu:
            pass  # a spawn in progress has finished; no new one starts
        self.queue.close()
        for slot in self._slots:
            if slot.addr and slot.proc is not None \
                    and slot.proc.poll() is None:
                stub = RpcClient(slot.addr, REPLICA_SERVICE)
                stub.try_call("Stop", {}, timeout=2.0)
                stub.close()
        for slot in self._slots:
            slot.thread.join(timeout=10.0)
            if slot.proc is not None:
                # A replica told to Stop exits by itself; one signalled
                # while it shuts down would die of the signal instead.
                _reap(slot.proc, exit_s=10.0)
        if self._server is not None:
            try:
                self._server.stop(grace=0.5)
            except Exception:
                pass
            self._server = None
        self._release_job()
        _events.emit("serve/stop", group=self.label)

    def __enter__(self) -> "ReplicaGroup":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.stop()
