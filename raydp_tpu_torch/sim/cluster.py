"""Simulated hosts and replicas behind the real seams.

Two production seams let the simulator swap hardware for bookkeeping
while every policy decision stays in real code:

* :class:`SimProvisioner` implements the autoscaler's
  :class:`~raydp_tpu_torch.control.autoscaler.HostProvisioner` interface
  with virtual host ids. ``grow`` still passes through the
  :func:`raydp_tpu_torch.fault.inject.on_spawn` chaos hook (the autoscaler
  calls it before the provisioner), so ``spawn_fail`` exercises the
  real backoff-and-retry budget and ``spawn_delay`` stalls *virtual*
  time via the clock seam.
* :class:`SimReplica` sits behind the
  :class:`~raydp_tpu_torch.serve.batching.RequestQueue` dispatch edge: it
  pulls batches with the real ``next_batch`` (real linger, real
  bucket grouping, real expiry sweeping), models execution as a
  scheduled completion event, and delivers replies through the real
  at-most-once ``complete``. ``serve_kill`` and ``latency`` fault
  clauses are honored on virtual time — a killed replica requeues its
  in-flight batch through the real front-of-queue ``requeue`` path
  and respawns after a delay, mirroring the ReplicaGroup
  requeue-and-respawn recipe without ever calling ``os._exit``.

Replicas are event-driven, not threaded: an idle replica is parked in
the :class:`ReplicaPool`'s idle set and *kicked* by the queue's
arrival observer; a busy one re-kicks itself when its completion
event fires. One kick per arrival keeps the simulation O(events), so
a thousand replicas cost no more than the work they actually do.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.control.autoscaler import HostProvisioner
from raydp_tpu_torch.fault import inject as _inject
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.utils import clock as _clock
from raydp_tpu_torch.utils.profiling import metrics as _metrics

__all__ = ["SizedPayload", "ServiceModel", "SimReplica", "ReplicaPool",
           "SimProvisioner"]


class SizedPayload:
    """A payload that is only a length — 1M simulated requests must
    not allocate 1M real input lists."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = int(n)

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        # A handful of consumers sum() payloads; keep them working.
        return iter(())


class ServiceModel:
    """Replica execution-time model: ``base_s`` per batch plus
    ``per_item_s`` per request in it. The default, ``base_s=0.012,
    per_item_s=0``, is a 12 ms-per-call backend."""

    __slots__ = ("base_s", "per_item_s")

    def __init__(self, base_s: float = 0.012, per_item_s: float = 0.0):
        self.base_s = float(base_s)
        self.per_item_s = float(per_item_s)

    def batch_s(self, batch_len: int) -> float:
        return self.base_s + self.per_item_s * batch_len


class DecodeServiceModel(ServiceModel):
    """Decode-aware replica model: a batch pays ``prefill_s`` once (the
    prompt forward) plus ``per_token_s`` per *output token* per request
    — roughly batch-size-independent per round, which is the whole
    point of continuous batching: a decode step over 8 slots costs
    about the same wall as over 1, so per-request cost collapses as
    occupancy rises. ``tokens_per_request`` sets the workload's mean
    output length; the knee finder sweeps offered tokens/s by scaling
    arrival rate against it."""

    __slots__ = ("prefill_s", "per_token_s", "tokens_per_request")

    def __init__(self, prefill_s: float = 0.004,
                 per_token_s: float = 0.002,
                 tokens_per_request: int = 32):
        super().__init__(base_s=prefill_s, per_item_s=0.0)
        self.prefill_s = float(prefill_s)
        self.per_token_s = float(per_token_s)
        self.tokens_per_request = int(tokens_per_request)

    def batch_s(self, batch_len: int) -> float:
        # The decode rounds run once per token position regardless of
        # how many sequences share them; prefill is per-admission but
        # overlaps the running batch, so only the first one gates.
        if batch_len <= 0:
            return self.prefill_s
        return (self.prefill_s
                + self.per_token_s * self.tokens_per_request)


class SimReplica:
    """One virtual replica: an event-driven dispatcher against the
    real :class:`RequestQueue`."""

    __slots__ = ("sim", "queue", "pool", "index", "host_id", "service",
                 "busy", "dead", "stopping", "incarnation",
                 "requests_seen", "batches")

    def __init__(self, sim: Any, queue: Any, pool: "ReplicaPool",
                 index: int, host_id: str, service: ServiceModel):
        self.sim = sim
        self.queue = queue
        self.pool = pool
        self.index = index
        self.host_id = host_id
        self.service = service
        self.busy = False
        self.dead = False
        self.stopping = False
        self.incarnation = 0
        self.requests_seen = 0
        self.batches = 0

    def kick(self) -> None:
        """Try to dispatch one batch. Runs the real continuous-batching
        assembly (``next_batch`` lingers on virtual time, coalescing
        arrivals that land during the window via the event pump)."""
        if self.busy or self.dead or self.stopping:
            return
        self.busy = True
        batch = self.queue.next_batch(wait_timeout=0.0)
        if not batch:
            self.busy = False
            self.pool.mark_idle(self)
            return
        self.batches += 1
        kill, extra_s = self._consume_clauses(len(batch))
        if kill:
            self._die(batch)
            return
        now = self.sim.monotonic()
        for req in batch:
            req.dispatched_mono = now
        service_s = self.service.batch_s(len(batch)) + extra_s
        self.sim.after(service_s, self._finish, batch, service_s)

    def _consume_clauses(self, batch_len: int):
        """Honor ``serve_kill``/``latency`` fault clauses against this
        replica's per-incarnation request counter — same matching
        semantics as :func:`inject.on_serve_request`, minus the
        process-killing side effects."""
        kill = False
        extra_s = 0.0
        clauses = _inject.plan_clauses()
        if not clauses:
            self.requests_seen += batch_len
            return kill, extra_s
        for _ in range(batch_len):
            idx = self.requests_seen
            self.requests_seen += 1
            for c in clauses:
                if not c.armed or c.fired:
                    continue
                if not c.matches_replica(self.index):
                    continue
                if c.kind == "serve_kill" and c.request == idx:
                    if self.incarnation > 0:
                        continue  # first incarnation only, like the real hook
                    c.fired = True
                    kill = True
                elif c.kind == "latency" and c.nth == idx:
                    c.fired = True
                    extra_s += float(c.delay or 0.0)
                    _events.emit(
                        "fault/clause", clause=c.kind,
                        what=f"sim replica {self.index} stalled "
                             f"{c.delay}s at request {idx}",
                    )
        return kill, extra_s

    def _die(self, batch: List[Any]) -> None:
        """Simulated hard death: the in-flight batch retries at the
        queue front (real ``requeue`` path), the replica respawns
        after the pool's respawn delay with a bumped incarnation."""
        _metrics.counter_add("sim/replica_deaths")
        _events.emit(
            "fault/clause", clause="serve_kill",
            what=f"sim replica {self.index} killed "
                 f"(incarnation {self.incarnation})",
        )
        _events.emit(
            "sim/replica_die", replica=self.index, host=self.host_id,
            inflight=len(batch), incarnation=self.incarnation,
        )
        self.queue.requeue(batch)
        self.dead = True
        self.busy = False
        self.pool.schedule_respawn(self)

    def _respawn(self) -> None:
        if self.stopping:
            return
        self.incarnation += 1
        self.requests_seen = 0
        self.dead = False
        _metrics.counter_add("sim/replica_respawns")
        _events.emit(
            "sim/replica_respawn", replica=self.index, host=self.host_id,
            incarnation=self.incarnation,
        )
        self.kick()

    def _finish(self, batch: List[Any], service_s: float) -> None:
        queue = self.queue
        now = self.sim.monotonic()
        tracker = self.pool.tracker
        for req in batch:
            req.exec_s = service_s
            delivered = queue.complete(req, result=0.0)
            if delivered and tracker is not None:
                tracker.on_complete(req, now)
        queue.observe_service_time(service_s / max(1, len(batch)))
        self.busy = False
        if self.stopping:
            self.pool.on_replica_stopped(self)
            return
        self.kick()


class ReplicaPool:
    """Replica lifecycle + arrival fan-out for one simulated serving
    group. ``attach_host``/``detach_host`` are the provisioner's
    callbacks; the queue's arrival observer wakes exactly one idle
    replica per admit."""

    def __init__(self, sim: Any, queue: Any, service: ServiceModel,
                 respawn_s: float = 1.0, tracker: Optional[Any] = None):
        self.sim = sim
        self.queue = queue
        self.service = service
        self.respawn_s = float(respawn_s)
        self.tracker = tracker
        self.replicas: Dict[str, SimReplica] = {}
        self._idle: "deque[SimReplica]" = deque()
        self._index = itertools.count()
        queue.add_arrival_observer(self._on_arrival)

    # -- provisioner callbacks -------------------------------------------

    def attach_host(self, host_id: str) -> None:
        replica = SimReplica(
            self.sim, self.queue, self, next(self._index), host_id,
            self.service,
        )
        self.replicas[host_id] = replica
        # Deferred kick: a freshly grown host starts draining any
        # backlog once the current event unwinds to a pump.
        self.sim.at(self.sim.monotonic(), replica.kick)

    def detach_host(self, host_id: str) -> None:
        replica = self.replicas.pop(host_id, None)
        if replica is None:
            return
        replica.stopping = True
        try:
            self._idle.remove(replica)
        except ValueError:
            pass  # busy or dead; finishes (or stays down) gracefully

    # -- replica callbacks -----------------------------------------------

    def mark_idle(self, replica: SimReplica) -> None:
        if not replica.stopping and not replica.dead:
            self._idle.append(replica)

    def schedule_respawn(self, replica: SimReplica) -> None:
        self.sim.after(self.respawn_s, replica._respawn)

    def on_replica_stopped(self, replica: SimReplica) -> None:
        _events.emit("sim/replica_retired", replica=replica.index,
                     host=replica.host_id)

    def _on_arrival(self, req: Any, now: float) -> None:
        while self._idle:
            replica = self._idle.popleft()
            if replica.stopping or replica.dead or replica.busy:
                continue
            replica.kick()
            return

    def live_count(self) -> int:
        return sum(1 for r in self.replicas.values()
                   if not r.dead and not r.stopping)


class SimProvisioner(HostProvisioner):
    """Virtual host lifecycle behind the autoscaler's seam.

    ``grow`` may stall virtual time (``provision_s`` models cloud
    spin-up); the :func:`inject.on_spawn` chaos hook runs on the
    *autoscaler's* side of this seam, exactly as with the real
    :class:`ClusterProvisioner`. Hosts created at construction model
    the pre-existing pool and skip the spawn hook."""

    def __init__(self, pool: ReplicaPool, initial: int = 0,
                 provision_s: float = 0.0, name_prefix: str = "sim-host"):
        self.pool = pool
        self.provision_s = float(provision_s)
        self.name_prefix = name_prefix
        self._ids: List[str] = []
        self._counter = itertools.count()
        for _ in range(int(initial)):
            self._attach()

    def _attach(self) -> str:
        host_id = f"{self.name_prefix}-{next(self._counter)}"
        self._ids.append(host_id)
        self.pool.attach_host(host_id)
        return host_id

    def grow(self, n: int) -> List[str]:
        if self.provision_s > 0:
            _clock.sleep(self.provision_s)
        return [self._attach() for _ in range(int(n))]

    def retire(self, host_id: str) -> None:
        try:
            self._ids.remove(host_id)
        except ValueError:
            raise RuntimeError(f"unknown sim host {host_id!r}")
        self.pool.detach_host(host_id)

    def hosts(self) -> List[str]:
        return list(self._ids)
