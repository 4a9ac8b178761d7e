"""Invariant monitors: safety properties checked *during* the run.

A load test tells you what the steady-state numbers were; an
invariant monitor tells you whether the control plane ever — even for
one virtual instant — violated a property it is supposed to hold
always. The monitor is itself a simulated actor: a periodic tick
event that samples the real arbiter's :meth:`report`, the real
provisioner's pool, and the metrics registry, then evaluates:

* **I1 capacity** — granted slots never exceed arbiter capacity
  (double-allocation would mean two gangs fitted onto one set of cards).
* **I2 starvation** — no admission waiter waits beyond
  ``starvation_s`` while a strictly lower-priority lease holds slots
  (the preemption machinery exists precisely so this cannot happen).
* **I3 pool bounds** — the autoscaler's pool stays within
  ``[min_workers, max_workers]`` and never dips below the gang floor.
* **I4 at-most-once** — the serving queue never records a duplicate
  reply (``serve/dup_replies`` stays zero).

Violations are recorded, counted under ``sim/invariant_violations``,
and emitted as ``sim/invariant`` events so the report and dashboard
surface them. The per-tick samples double as the timeline input for
the pathology detectors (:mod:`raydp_tpu_torch.sim.pathology`): invariants
are point-in-time safety, pathologies are *shapes over time*.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.utils.profiling import metrics as _metrics

__all__ = ["InvariantViolation", "InvariantMonitor"]


@dataclass
class InvariantViolation:
    """One observed breach of a safety property at one virtual instant."""

    invariant: str
    t: float
    detail: str

    def to_dict(self) -> Dict[str, Any]:
        return {"invariant": self.invariant, "t": round(self.t, 3),
                "detail": self.detail}


@dataclass
class InvariantMonitor:
    """Periodic sampler + safety checker over the live components.

    ``install(end_t)`` pre-schedules every tick up to the scenario's
    end; ticks are plain heap events, so sampling interleaves with the
    workload in global virtual-time order and costs nothing when the
    run is idle.
    """

    sim: Any
    interval_s: float = 0.5
    arbiter: Optional[Any] = None
    autoscaler: Optional[Any] = None
    provisioner: Optional[Any] = None
    starvation_s: float = 30.0
    violations: List[InvariantViolation] = field(default_factory=list)
    samples: List[Dict[str, Any]] = field(default_factory=list)
    _last_rejected: float = 0.0
    _last_sheds: float = 0.0
    _prev_pool: Optional[int] = None

    def install(self, end_t: float) -> None:
        t = self.sim.monotonic()
        while t <= end_t:
            self.sim.at(t, self._tick)
            t += self.interval_s

    # -- sampling --------------------------------------------------------

    def _tick(self) -> None:
        now = self.sim.monotonic()
        counters = _metrics.snapshot().get("counters", {})
        sample: Dict[str, Any] = {"t": now}

        rejected = float(counters.get("serve/rejected", 0.0))
        sheds = float(counters.get("sched/sheds", 0.0))
        sample["rejected_delta"] = rejected - self._last_rejected
        sample["sheds_delta"] = sheds - self._last_sheds
        self._last_rejected = rejected
        self._last_sheds = sheds

        if self.arbiter is not None:
            rep = self.arbiter.report()
            waiters = rep.get("queue", [])
            leases = rep.get("leases", [])
            sample.update(
                capacity=rep.get("capacity", 0),
                in_use=rep.get("in_use", 0),
                queue_depth=rep.get("queue_depth", 0),
                wait_oldest_s=rep.get("wait_oldest_s", 0.0),
                min_waiter_slots=min(
                    (w["slots"] for w in waiters), default=0
                ),
                max_waiter_priority=max(
                    (w["priority"] for w in waiters), default=None
                ),
                min_lease_priority=min(
                    (l_["priority"] for l_ in leases), default=None
                ),
                lease_count=len(leases),
            )
            self._check_capacity(now, rep)
            self._check_starvation(now, rep)

        if self.provisioner is not None:
            sample["pool_size"] = len(self.provisioner.hosts())
            self._check_pool_bounds(now, sample["pool_size"])

        dup = float(counters.get("serve/dup_replies", 0.0))
        sample["dup_replies"] = dup
        if dup > 0 and not any(
            v.invariant == "at_most_once" for v in self.violations
        ):
            self._violate("at_most_once", now,
                          f"serve/dup_replies={dup:.0f} — a request was "
                          "answered twice")

        self.samples.append(sample)

    # -- the invariants --------------------------------------------------

    def _check_capacity(self, now: float, rep: Dict[str, Any]) -> None:
        in_use = int(rep.get("in_use", 0))
        capacity = int(rep.get("capacity", 0))
        if capacity > 0 and in_use > capacity:
            self._violate(
                "capacity", now,
                f"{in_use} slots granted against capacity {capacity} "
                "(double allocation)",
            )

    def _check_starvation(self, now: float, rep: Dict[str, Any]) -> None:
        leases = rep.get("leases", [])
        if not leases:
            return
        for w in rep.get("queue", []):
            if w.get("waited_s", 0.0) <= self.starvation_s:
                continue
            lower = [
                l_ for l_ in leases
                if l_.get("preemptible")
                and l_.get("priority", 0) < w.get("priority", 0)
            ]
            if lower:
                self._violate(
                    "starvation", now,
                    f"job {w.get('job')} (priority {w.get('priority')}) "
                    f"waited {w.get('waited_s', 0.0):.1f}s > "
                    f"{self.starvation_s}s while {len(lower)} "
                    "lower-priority preemptible lease(s) held slots",
                )

    def _check_pool_bounds(self, now: float, pool_size: int) -> None:
        if self.autoscaler is None:
            return
        cfg = self.autoscaler.config
        if pool_size < cfg.min_workers or pool_size > cfg.max_workers:
            self._violate(
                "pool_bounds", now,
                f"pool size {pool_size} outside "
                f"[{cfg.min_workers}, {cfg.max_workers}]",
            )
        # The gang-floor contract is directional: the autoscaler must
        # never SHRINK the pool below what live gang leases hold. A
        # pool that was already smaller (arbiter capacity is not
        # always host-backed) is the operator's topology, not a
        # violation — so flag only an observed decrease below floor.
        floor = self.autoscaler._gang_floor()
        prev = self._prev_pool
        self._prev_pool = pool_size
        if (floor > 0 and pool_size < floor
                and prev is not None and pool_size < prev):
            self._violate(
                "pool_bounds", now,
                f"pool shrank {prev} -> {pool_size} below gang floor "
                f"{floor} (a live SPMD fit lost ranks)",
            )

    # -- end-of-run conservation -----------------------------------------

    def check_conservation(self, arrivals: int, admitted: float,
                           shed: float, replies: float,
                           errors: float) -> None:
        """No request may vanish or double-count: every arrival was
        admitted or shed, every admitted request got exactly one reply
        or one error. Called by the scenario after the drain."""
        now = self.sim.monotonic()
        if arrivals != int(admitted + shed):
            self._violate(
                "conservation", now,
                f"{arrivals} arrivals != {admitted:.0f} admitted + "
                f"{shed:.0f} shed",
            )
        if int(admitted) != int(replies + errors):
            self._violate(
                "conservation", now,
                f"{admitted:.0f} admitted != {replies:.0f} replies + "
                f"{errors:.0f} errors (a request was dropped or "
                "answered twice)",
            )

    # -- plumbing --------------------------------------------------------

    def _violate(self, invariant: str, t: float, detail: str) -> None:
        self.violations.append(InvariantViolation(invariant, t, detail))
        _metrics.counter_add("sim/invariant_violations")
        _events.emit("sim/invariant", invariant=invariant,
                     t=round(t, 3), what=detail)
