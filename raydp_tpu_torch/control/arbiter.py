"""Driver-side control plane: admission, fair share, preemption.

The port's copy of ``raydp_tpu/control/arbiter.py``. A gang survives a
preemption (``fault/``, ``fit_spmd``'s supervisor) and every
chip-second is billed to a job (``telemetry/accounting.py``); this
module arbitrates when two jobs want the same pool. Workload roots
(``fit_spmd`` gangs, a standalone ``SPMDJob``, DataFrame stage
execution, serving replica groups) acquire capacity through
:class:`ClusterArbiter` leases instead of grabbing workers directly:

* **Admission queue**: a job that does not fit waits in ``QUEUED``
  with a queue-position event (``sched/queue``) instead of failing or
  oversubscribing. Grant order is priority tier first
  (:class:`~raydp_tpu_torch.telemetry.accounting.JobContext.priority`),
  then deficit-weighted round-robin within a tier: each job's
  usage-ledger consumption (chip-seconds + task-seconds) normalized by
  its weight, so a job that got starved catches up (Podracer-style
  decoupled sharing, arXiv:2104.06272).
* **Preemption as a primitive**: a higher-priority arrival (or queue
  pressure past ``RAYDP_TPU_SCHED_PRESSURE_S``) selects the
  lowest-priority preemptible gang as victim and fires its
  ``on_preempt`` callback, which routes into ``request_preemption`` ->
  emergency-checkpoint drain -> teardown. The victim's supervisor
  releases its lease (freeing the slots to the arrival), re-acquires
  behind it, and resumes from the emergency checkpoint with bounded
  replay. A preempt-deadline timer force-reclaims the slots if the
  victim hangs mid-drain (``reason="lease_timeout"``).
* **Graceful degradation**: lease acquisition is bounded
  (``RAYDP_TPU_SCHED_ADMIT_TIMEOUT_S``) and fails with a structured
  :class:`ClusterBusyError` carrying queue depth and an ETA; a
  load-shedding cap (``RAYDP_TPU_SCHED_MAX_QUEUE``) rejects new
  admissions outright when the queue is saturated; lease TTLs
  (``RAYDP_TPU_SCHED_LEASE_TTL_S``) reclaim capacity from hung jobs.
  Queue waits are registered with the process watchdog
  (``sched/queue`` component) so a starved admission shows up in
  ``/healthz`` stall flags.

Every transition (submit -> queued -> admitted -> running -> preempting
-> drained -> resumed / completed / shed) emits a
:mod:`~raydp_tpu_torch.telemetry.events` record (``sched/*``) and rides
the metrics registry as ``sched/queue_depth`` (gauge),
``sched/preemptions/<reason>``, ``sched/wait/<job_id>`` and
``sched/sheds`` counters, exported as the ``raydp_sched_*`` Prometheus
families (``doc/scheduling.md`` walks the state machine). Every time
read and wait goes through :mod:`raydp_tpu_torch.utils.clock`, so the
simulator (:mod:`raydp_tpu_torch.sim`) drives this code on virtual time.

The arbiter is **disabled by default**: with no configured capacity
(``RAYDP_TPU_SCHED_CAPACITY`` unset or 0) every acquire returns an
inert granted lease and single-tenant workloads pay one attribute
read. Tests and multi-tenant deployments opt in via the env var or
:func:`configure`. No torch here: the ETL executor, which the workers
load, passes :func:`stage_gate`.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
from typing import Any, Callable, Dict, List, Optional

from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.telemetry import watchdog as _watchdog
from raydp_tpu_torch.utils import clock as _clock
from raydp_tpu_torch.utils.profiling import metrics as _metrics

__all__ = [
    "SCHED_CAPACITY_ENV",
    "SCHED_MAX_QUEUE_ENV",
    "SCHED_ADMIT_TIMEOUT_ENV",
    "SCHED_LEASE_TTL_ENV",
    "SCHED_PREEMPT_TIMEOUT_ENV",
    "SCHED_PRESSURE_ENV",
    "ClusterBusyError",
    "Lease",
    "ClusterArbiter",
    "get_arbiter",
    "configure",
    "stage_gate",
    "reset_for_tests",
]

#: Total schedulable slots (hosts/chips — the unit the deployment
#: chooses). Unset or 0 disables arbitration entirely.
SCHED_CAPACITY_ENV = "RAYDP_TPU_SCHED_CAPACITY"
#: Queue-depth cap: admissions beyond it are shed immediately with
#: ClusterBusyError instead of queueing (0 = unbounded queue).
SCHED_MAX_QUEUE_ENV = "RAYDP_TPU_SCHED_MAX_QUEUE"
#: Default bound on how long one acquire() waits in the queue before
#: failing with ClusterBusyError.
SCHED_ADMIT_TIMEOUT_ENV = "RAYDP_TPU_SCHED_ADMIT_TIMEOUT_S"
#: Lease time-to-live: a lease not renewed within this window is
#: reclaimed (reason="lease_timeout"). 0 disables the reaper.
SCHED_LEASE_TTL_ENV = "RAYDP_TPU_SCHED_LEASE_TTL_S"
#: How long a preempted victim gets to drain and release before its
#: slots are force-reclaimed (reason="lease_timeout").
SCHED_PREEMPT_TIMEOUT_ENV = "RAYDP_TPU_SCHED_PREEMPT_TIMEOUT_S"
#: Queue-pressure threshold: a waiter older than this may preempt an
#: equal-priority victim (reason="pressure"). 0 disables pressure
#: preemption; priority preemption is always on.
SCHED_PRESSURE_ENV = "RAYDP_TPU_SCHED_PRESSURE_S"

_DEFAULT_ADMIT_TIMEOUT_S = 300.0
_DEFAULT_PREEMPT_TIMEOUT_S = 60.0
# Queue waits surface as watchdog stalls past this (raised above the
# global threshold: waiting queued is legitimate, silence is not).
_QUEUE_STALL_S = 120.0
# Recent grant-wait samples kept for ETA estimation / p50 reporting.
_WAIT_WINDOW = 256

# Job lifecycle states (emitted in events and scheduler_report()).
SUBMITTED = "submitted"
QUEUED = "queued"
ADMITTED = "admitted"
RUNNING = "running"
PREEMPTING = "preempting"
DRAINED = "drained"
COMPLETED = "completed"
SHED = "shed"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class ClusterBusyError(RuntimeError):
    """Admission rejected or timed out: the cluster is saturated.

    Structured so callers can degrade gracefully instead of
    retry-spinning: ``queue_depth`` is the number of jobs waiting ahead
    (including the rejected one's would-be position) and ``eta_s`` an
    estimate of when capacity frees up (mean recent grant wait ×
    depth; ``None`` when there is no history to estimate from).
    """

    def __init__(self, message: str, queue_depth: int = 0,
                 eta_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.eta_s = eta_s


class Lease:
    """A capacity grant: ``slots`` schedulable units held by ``job``.

    ``kind="gang"`` leases are long-lived (a supervised fit holds one
    across restarts) and preemptible via their ``on_preempt`` callback;
    ``kind="turn"`` leases are transient per-ETL-stage grants that give
    the arbiter its fair-share interleaving points. Release is
    idempotent; ``renew()`` refreshes the TTL clock.
    """

    def __init__(self, arbiter: "ClusterArbiter", job: _acct.JobContext,
                 slots: int, kind: str, label: str,
                 preemptible: bool, inert: bool = False):
        self.arbiter = arbiter
        self.job = job
        self.slots = slots
        self.kind = kind
        self.label = label
        self.preemptible = preemptible
        self.inert = inert  # disabled arbiter: every operation no-ops
        self.active = True
        self.preempt_requested = False
        self.granted_mono = _clock.monotonic()
        self.renewed_mono = self.granted_mono
        self._on_preempt: Optional[Callable[[], None]] = None

    def bind_preempt(self, callback: Optional[Callable[[], None]]) -> None:
        """(Re)bind the preemption callback — supervisors rebind each
        incarnation so the victim teardown hits the live gang."""
        self._on_preempt = callback

    def renew(self) -> None:
        self.renewed_mono = _clock.monotonic()

    def release(self, state: str = COMPLETED) -> None:
        """Return the slots; ``state`` records why (``completed`` for a
        finished job, ``drained`` for a preemption drain)."""
        if self.inert or not self.active:
            return
        self.arbiter._release(self, state)

    def resize(self, slots: int) -> None:
        """Shrink (elastic resize) — freed slots go to the queue.
        Growing re-enters admission; use a fresh acquire for that."""
        if self.inert or not self.active or slots >= self.slots:
            return
        self.arbiter._resize(self, slots)

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.release()


class _Waiter:
    """One queued acquire(): a condition-slot in the admission queue."""

    def __init__(self, job: _acct.JobContext, slots: int, seq: int):
        self.job = job
        self.slots = slots
        self.seq = seq
        self.enqueued_mono = _clock.monotonic()
        self.granted = False
        self.shed_reason: Optional[str] = None


class ClusterArbiter:
    """Slot-pool arbiter; one per driver process (see module doc)."""

    def __init__(
        self,
        capacity: int = 0,
        max_queue: Optional[int] = None,
        admit_timeout_s: Optional[float] = None,
        lease_ttl_s: Optional[float] = None,
        preempt_timeout_s: Optional[float] = None,
        pressure_s: Optional[float] = None,
    ):
        self.capacity = int(capacity)
        self.max_queue = (
            int(_env_float(SCHED_MAX_QUEUE_ENV, 0))
            if max_queue is None else int(max_queue)
        )
        self.admit_timeout_s = (
            _env_float(SCHED_ADMIT_TIMEOUT_ENV, _DEFAULT_ADMIT_TIMEOUT_S)
            if admit_timeout_s is None else float(admit_timeout_s)
        )
        self.lease_ttl_s = (
            _env_float(SCHED_LEASE_TTL_ENV, 0.0)
            if lease_ttl_s is None else float(lease_ttl_s)
        )
        self.preempt_timeout_s = (
            _env_float(SCHED_PREEMPT_TIMEOUT_ENV, _DEFAULT_PREEMPT_TIMEOUT_S)
            if preempt_timeout_s is None else float(preempt_timeout_s)
        )
        self.pressure_s = (
            _env_float(SCHED_PRESSURE_ENV, 0.0)
            if pressure_s is None else float(pressure_s)
        )
        self.shedding = False
        self._mu = threading.Condition(threading.Lock())
        self._seq = itertools.count(1)
        self._leases: List[Lease] = []
        self._waiters: List[_Waiter] = []
        # job_id -> lifecycle state (scheduler_report's state machine
        # view; completed jobs age out of interest but stay for audit).
        self._states: Dict[str, str] = {}
        # job_id -> True once preempted; the next grant for the job is
        # its resume and emits sched/resume instead of sched/admit.
        self._preempted_jobs: Dict[str, bool] = {}
        self._wait_samples: "collections.deque[float]" = collections.deque(
            maxlen=_WAIT_WINDOW
        )
        # Timer-shaped handles from _clock.call_later (threading.Timer
        # on the real clock, virtual-event handles under the sim).
        self._preempt_timers: Dict[int, Any] = {}

    # -- public surface -------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def in_use(self) -> int:
        with self._mu:
            return sum(l.slots for l in self._leases)

    def acquire(
        self,
        job: Optional[_acct.JobContext] = None,
        slots: int = 1,
        kind: str = "gang",
        label: str = "",
        timeout: Optional[float] = None,
        preemptible: bool = True,
        on_preempt: Optional[Callable[[], None]] = None,
    ) -> Lease:
        """Block until ``slots`` are granted to ``job`` (ambient job by
        default); returns the :class:`Lease`. Raises
        :class:`ClusterBusyError` on shed or admission timeout."""
        job = job if job is not None else _acct.ensure_job("sched")
        if not self.enabled:
            return Lease(self, job, slots, kind, label,
                         preemptible, inert=True)
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if slots > self.capacity:
            raise ValueError(
                f"job {job.job_id} requests {slots} slots but the "
                f"arbiter capacity is {self.capacity}"
            )
        timeout = self.admit_timeout_s if timeout is None else float(timeout)
        _events.emit("sched/submit", job=job, slots=slots, lease_kind=kind,
                     label=label, priority=job.priority)
        with self._mu:
            self._reap_expired_locked()
            if self._should_shed_locked():
                return self._shed_locked(job, kind, label)
            waiter = _Waiter(job, slots, next(self._seq))
            self._waiters.append(waiter)
            self._set_state_locked(job, QUEUED if not
                                   self._fits_locked(slots) else ADMITTED)
            if not self._fits_locked(slots):
                _events.emit(
                    "sched/queue", job=job, slots=slots, lease_kind=kind,
                    position=self._position_locked(waiter),
                    depth=len(self._waiters), priority=job.priority,
                )
            self._publish_depth_locked()
            deadline = _clock.monotonic() + timeout
            preempt_fired = False
            try:
                with _watchdog.inflight(
                    "sched/queue", job=job.job_id, lease_kind=kind,
                    stall_after_s=max(_QUEUE_STALL_S, timeout),
                ):
                    while True:
                        self._grant_locked()
                        if waiter.granted:
                            break
                        if not preempt_fired:
                            preempt_fired = self._maybe_preempt_locked(
                                waiter
                            )
                        now = _clock.monotonic()
                        if now >= deadline:
                            raise self._busy_locked(
                                f"admission timed out after {timeout:.1f}s "
                                f"for job {job.job_id} "
                                f"({slots} slot(s), kind={kind})"
                            )
                        _clock.wait_on(
                            self._mu, timeout=min(0.2, deadline - now)
                        )
                        self._reap_expired_locked()
            finally:
                if waiter in self._waiters:
                    self._waiters.remove(waiter)
                self._publish_depth_locked()
            waited = _clock.monotonic() - waiter.enqueued_mono
            self._wait_samples.append(waited)
            _metrics.counter_add(f"sched/wait/{job.job_id}", waited)
            lease = Lease(self, job, slots, kind, label, preemptible)
            lease.bind_preempt(on_preempt)
            self._leases.append(lease)
            resumed = self._preempted_jobs.pop(job.job_id, False)
            self._set_state_locked(job, RUNNING)
            _events.emit(
                "sched/resume" if resumed else "sched/admit",
                job=job, slots=slots, lease_kind=kind, label=label,
                wait_s=round(waited, 4), priority=job.priority,
            )
            _events.emit("sched/lease", job=job, slots=slots, lease_kind=kind,
                         in_use=sum(l.slots for l in self._leases),
                         capacity=self.capacity)
            return lease

    def ensure_admitted(
        self, job: Optional[_acct.JobContext], slots: int,
        label: str = "", on_preempt: Optional[Callable[[], None]] = None,
    ) -> Optional[Lease]:
        """Admission for workload roots that may already be covered: a
        no-op when the arbiter is disabled or ``job`` already holds an
        active lease (``fit_spmd``'s gang lease wins over the
        ``SPMDJob.start`` it wraps). Returns the new lease, or None
        when already covered."""
        if not self.enabled or job is None:
            return None
        with self._mu:
            if any(l.active and l.job.job_id == job.job_id
                   for l in self._leases):
                return None
        return self.acquire(job, slots=slots, kind="gang", label=label,
                            on_preempt=on_preempt)

    def holds_lease(self, job: Optional[_acct.JobContext]) -> bool:
        if job is None:
            return False
        with self._mu:
            return any(l.active and l.job.job_id == job.job_id
                       for l in self._leases)

    def set_shedding(self, shedding: bool) -> None:
        """Explicit load-shed switch (ops override; the queue-depth cap
        flips the same behaviour automatically)."""
        with self._mu:
            self.shedding = bool(shedding)

    def complete(self, job: Optional[_acct.JobContext]) -> None:
        """Mark ``job`` finished in the state machine (its leases must
        already be released)."""
        if job is None:
            return
        with self._mu:
            if self._states.get(job.job_id) not in (SHED,):
                self._set_state_locked(job, COMPLETED)

    def report(self) -> Dict[str, Any]:
        """Scheduler state for ``Cluster.scheduler_report()`` / tests:
        capacity, in-use slots, queue, leases, job states, wait stats."""
        with self._mu:
            waits = sorted(self._wait_samples)
            p50 = waits[len(waits) // 2] if waits else 0.0
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "in_use": sum(l.slots for l in self._leases),
                "queue_depth": len(self._waiters),
                "shedding": self.shedding or self._should_shed_locked(),
                "queue": [
                    {
                        "job": w.job.job_id,
                        "priority": w.job.priority,
                        "slots": w.slots,
                        "waited_s": round(
                            _clock.monotonic() - w.enqueued_mono, 3
                        ),
                    }
                    for w in self._order_locked(self._waiters)
                ],
                "leases": [
                    {
                        "job": l.job.job_id,
                        "priority": l.job.priority,
                        "kind": l.kind,
                        "label": l.label,
                        "slots": l.slots,
                        "preemptible": l.preemptible,
                        "preempt_requested": l.preempt_requested,
                        "held_s": round(
                            _clock.monotonic() - l.granted_mono, 3
                        ),
                    }
                    for l in self._leases
                ],
                "states": dict(self._states),
                "wait_p50_s": round(p50, 4),
                "wait_oldest_s": self._oldest_wait_locked(),
                "eta_s": self._eta_locked(),
            }

    # -- internals (all *_locked run under self._mu) --------------------

    def _fits_locked(self, slots: int) -> bool:
        # Granted-but-not-yet-leased waiters still reserve their slots
        # (the winning thread materializes the Lease after it wakes);
        # ignoring them would double-allocate under concurrent grants.
        used = sum(l.slots for l in self._leases) + sum(
            w.slots for w in self._waiters if w.granted
        )
        return used + slots <= self.capacity

    def _position_locked(self, waiter: _Waiter) -> int:
        ordered = self._order_locked(self._waiters)
        return ordered.index(waiter) + 1 if waiter in ordered else 0

    def _deficit(self, job: _acct.JobContext) -> float:
        """Usage-ledger consumption normalized by priority weight — the
        DWRR key: lower means the job is *behind* its fair share and
        gets granted first within its priority tier."""
        counters = _metrics.snapshot().get("counters", {})
        used = (
            counters.get(f"job/{job.job_id}/chip_seconds", 0.0)
            + counters.get(f"job/{job.job_id}/task_seconds", 0.0)
        )
        weight = max(1, 1 + job.priority)
        return used / weight

    def _order_locked(self, waiters: List[_Waiter]) -> List[_Waiter]:
        return sorted(
            waiters,
            key=lambda w: (-w.job.priority, self._deficit(w.job), w.seq),
        )

    def _grant_locked(self) -> None:
        """Admit queued waiters in fair-share order while they fit.
        Strict ordering: a small job never jumps a bigger higher-rank
        job (head-of-line respect keeps priority meaningful)."""
        for waiter in self._order_locked(self._waiters):
            if waiter.granted:
                continue
            if not self._fits_locked(waiter.slots):
                break
            waiter.granted = True
            self._mu.notify_all()

    def _maybe_preempt_locked(self, waiter: _Waiter) -> bool:
        """Select and preempt a victim for ``waiter``: the
        lowest-priority preemptible gang strictly below the waiter's
        tier (``reason="priority"``), or — once the waiter has queued
        past the pressure threshold — at or below it
        (``reason="pressure"``). Returns True when a preemption was
        initiated (one per waiter: re-preempting while the first victim
        drains would cascade)."""
        waited = _clock.monotonic() - waiter.enqueued_mono
        pressure = self.pressure_s > 0 and waited >= self.pressure_s
        candidates = [
            l for l in self._leases
            if l.preemptible and not l.preempt_requested
            and l.kind == "gang"
            and l.job.job_id != waiter.job.job_id
            and (l.job.priority < waiter.job.priority
                 or (pressure and l.job.priority <= waiter.job.priority))
        ]
        if not candidates:
            return False
        victim = min(
            candidates,
            key=lambda l: (l.job.priority, -self._deficit(l.job)),
        )
        reason = ("priority" if victim.job.priority < waiter.job.priority
                  else "pressure")
        victim.preempt_requested = True
        self._set_state_locked(victim.job, PREEMPTING)
        self._preempted_jobs[victim.job.job_id] = True
        _metrics.counter_add(f"sched/preemptions/{reason}")
        _events.emit(
            "sched/preempt", job=victim.job, reason=reason,
            victim=victim.job.job_id, victim_priority=victim.job.priority,
            for_job=waiter.job.job_id, for_priority=waiter.job.priority,
            slots=victim.slots,
        )
        callback = victim._on_preempt
        if callback is not None:
            # Off-lock, off-stack: the callback SIGTERMs gang ranks /
            # touches RPC; holding the arbiter lock through that would
            # serialize the whole control plane behind it.
            _clock.defer(
                lambda: self._run_preempt_callback(victim, callback),
                name="raydp-sched-preempt",
            )
        timer = _clock.call_later(
            self.preempt_timeout_s, self._preempt_deadline, victim
        )
        self._preempt_timers[id(victim)] = timer
        return True

    @staticmethod
    def _run_preempt_callback(victim: Lease,
                              callback: Callable[[], None]) -> None:
        try:
            callback()
        except Exception:
            # The deadline timer force-reclaims if the drain never
            # happens; a broken callback must not kill the arbiter.
            pass

    def _preempt_deadline(self, victim: Lease) -> None:
        """A preempted lease that never released within the window: the
        victim is hung mid-drain — reclaim its slots so the arrival is
        not wedged behind a zombie."""
        if not victim.active:
            return
        _metrics.counter_add("sched/preemptions/lease_timeout")
        _events.emit(
            "sched/preempt", job=victim.job, reason="lease_timeout",
            victim=victim.job.job_id, slots=victim.slots,
        )
        self._release(victim, DRAINED)

    def _reap_expired_locked(self) -> None:
        """TTL reaper: leases silent past ``lease_ttl_s`` are reclaimed
        (a hung driver thread must not hold capacity forever). Runs
        piggybacked on waiter wakeups — exactly when someone is starved
        enough to care."""
        if self.lease_ttl_s <= 0:
            return
        now = _clock.monotonic()
        expired = [
            l for l in self._leases
            if now - l.renewed_mono > self.lease_ttl_s
        ]
        for lease in expired:
            _metrics.counter_add("sched/preemptions/lease_timeout")
            _events.emit(
                "sched/preempt", job=lease.job, reason="lease_timeout",
                victim=lease.job.job_id, slots=lease.slots,
                idle_s=round(now - lease.renewed_mono, 3),
            )
            self._release_locked(lease, DRAINED)

    def _should_shed_locked(self) -> bool:
        if self.shedding:
            return True
        return bool(self.max_queue and len(self._waiters) >= self.max_queue)

    def _shed_locked(self, job: _acct.JobContext, kind: str,
                     label: str) -> Lease:
        _metrics.counter_add("sched/sheds")
        self._set_state_locked(job, SHED)
        _events.emit("sched/shed", job=job, lease_kind=kind, label=label,
                     depth=len(self._waiters))
        raise self._busy_locked(
            f"admission shed for job {job.job_id}: queue depth "
            f"{len(self._waiters)} at cap "
            f"(max_queue={self.max_queue}, shedding={self.shedding})"
        )

    def _busy_locked(self, message: str) -> ClusterBusyError:
        depth = len(self._waiters)
        eta = self._eta_locked()
        return ClusterBusyError(
            message + f" (queue_depth={depth}, eta_s={eta})",
            queue_depth=depth, eta_s=eta,
        )

    def _eta_locked(self) -> Optional[float]:
        if not self._wait_samples:
            return None
        mean = sum(self._wait_samples) / len(self._wait_samples)
        return round(mean * max(1, len(self._waiters)), 3)

    def _publish_depth_locked(self) -> None:
        _metrics.gauge_set("sched/queue_depth", float(len(self._waiters)))
        _metrics.gauge_set(
            "sched/queue_wait_oldest", self._oldest_wait_locked()
        )

    def _oldest_wait_locked(self) -> float:
        """Age in seconds of the longest-queued waiter (0.0 when the
        queue is empty) — the starvation signal the autoscaler keys on:
        depth alone cannot distinguish a deep fast-moving queue from a
        shallow stuck one."""
        if not self._waiters:
            return 0.0
        now = _clock.monotonic()
        return round(
            max(now - w.enqueued_mono for w in self._waiters), 4
        )

    def _set_state_locked(self, job: _acct.JobContext, state: str) -> None:
        self._states[job.job_id] = state

    def _release(self, lease: Lease, state: str) -> None:
        with self._mu:
            self._release_locked(lease, state)

    def _release_locked(self, lease: Lease, state: str) -> None:
        if not lease.active:
            return
        lease.active = False
        if lease in self._leases:
            self._leases.remove(lease)
        timer = self._preempt_timers.pop(id(lease), None)
        if timer is not None:
            timer.cancel()
        # A drained victim stays interesting (it will resume); a
        # completed lease finishes the job unless other leases remain.
        if state == DRAINED:
            self._set_state_locked(lease.job, DRAINED)
        elif not any(l.job.job_id == lease.job.job_id
                     for l in self._leases):
            self._set_state_locked(lease.job, COMPLETED)
        _events.emit(
            "sched/release" if state == COMPLETED else "sched/drain",
            job=lease.job, slots=lease.slots, lease_kind=lease.kind,
            state=state,
            held_s=round(_clock.monotonic() - lease.granted_mono, 4),
        )
        self._grant_locked()
        self._mu.notify_all()

    def _resize(self, lease: Lease, slots: int) -> None:
        with self._mu:
            freed = lease.slots - slots
            lease.slots = slots
            _events.emit("sched/lease", job=lease.job, slots=slots,
                         lease_kind=lease.kind, resized=True, freed=freed,
                         in_use=sum(l.slots for l in self._leases),
                         capacity=self.capacity)
            self._grant_locked()
            self._mu.notify_all()


# -- process singleton --------------------------------------------------

_arbiter_mu = threading.Lock()
_arbiter: Optional[ClusterArbiter] = None


def get_arbiter() -> ClusterArbiter:
    """The process arbiter, built from ``RAYDP_TPU_SCHED_*`` env on
    first use (capacity 0 = disabled no-op)."""
    global _arbiter
    with _arbiter_mu:
        if _arbiter is None:
            _arbiter = ClusterArbiter(
                capacity=int(_env_float(SCHED_CAPACITY_ENV, 0)),
            )
        return _arbiter


def configure(capacity: int, **kwargs: Any) -> ClusterArbiter:
    """Install a fresh arbiter with explicit settings (tests, embedders;
    production uses the env vars)."""
    global _arbiter
    with _arbiter_mu:
        _arbiter = ClusterArbiter(capacity=capacity, **kwargs)
        return _arbiter


def reset_for_tests() -> None:
    global _arbiter
    with _arbiter_mu:
        _arbiter = None


# -- ETL stage gate ------------------------------------------------------

# Reentrancy: a stage executing inside another stage's gate (nested
# pipelines, recursive plans) must not re-queue — deadlock with
# capacity 1 otherwise.
_gate_tls = threading.local()


@contextlib.contextmanager
def stage_gate(label: str = ""):
    """Fair-share turn around one DataFrame stage execution.

    No-op when the arbiter is disabled, when this thread already holds
    a gate (nested stages), or when the ambient job already holds a
    lease (a gang job's own ETL must not queue behind its gang). One
    slot per turn: with N jobs looping stages, grants interleave in
    DWRR order, which is what makes the throughput split follow the
    priority weights."""
    arb = get_arbiter()
    if not arb.enabled:
        yield
        return
    if getattr(_gate_tls, "depth", 0) > 0:
        yield
        return
    job = _acct.current_job()
    if arb.holds_lease(job):
        yield
        return
    _gate_tls.depth = 1
    try:
        lease = arb.acquire(job, slots=1, kind="turn", label=label,
                            preemptible=False)
        try:
            yield
        finally:
            lease.release()
    finally:
        _gate_tls.depth = 0
