"""Telemetry-driven worker-pool autoscaler with graceful drain.

The port's copy of ``raydp_tpu/control/autoscaler.py``. The arbiter
divides a *fixed* pool fairly; the :class:`Autoscaler` sizes that pool
from the pressure signals the telemetry plane already exports —
admission-queue depth and oldest-waiter age from the arbiter, loader
starvation (``ingest/wait_seconds`` rate), per-stage ``queue_s`` from
the stage-stats store, and registered serving groups' queue depth /
shed ETA. Each signal normalizes to a backlog score; the *maximum*
drives the decision, so any one starved subsystem is enough to grow
and every decision event names the signal that tripped it.

Anti-flap is structural: dual thresholds (``up`` must be crossed to
grow, ``down`` to shrink), per-direction cooldowns measured against
the last action in *either* direction, a per-decision step limit, and
a consecutive-idle-evaluations requirement before any shrink. Scale-up
reacts within one evaluation interval of sustained pressure; scale-down
is deliberate by construction.

Scale-down is graceful by construction: a victim host is never picked
while doing so would cut the pool below the slots held by active
``gang`` leases (SPMD ranks are untouchable mid-fit), the freed host
is first offered to waiting serving replica groups (bin-packing)
before being released, and the provisioner's retire path runs the
existing drain machinery (ETL tasks requeue through the worker-gone
retry path; serving replicas migrate via the ReplicaGroup
requeue-and-respawn recipe).

Provisioning failure is a first-class state: every spawn attempt
passes the :func:`raydp_tpu_torch.fault.inject.on_spawn` chaos hook, and a
provisioner error (injected or real) puts the loop into
backoff-and-retry under a bounded budget instead of wedging or
flapping.

The :class:`HostProvisioner` interface is the seam for real cloud
backends; :class:`ClusterProvisioner` rides the session's
``Cluster.request_workers`` / ``kill_worker`` / ``alive_workers``
(which ride ``cluster/launcher.py``: torch-free ETL worker processes)
and is what tests and ``chip_smoke.py`` use. Stage queueing is read
from :data:`raydp_tpu_torch.telemetry.progress.stage_store`.
"""
from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.utils import clock as _clock
from raydp_tpu_torch.utils.profiling import metrics as _metrics

logger = logging.getLogger(__name__)

AUTOSCALE_MIN_ENV = "RAYDP_TPU_AUTOSCALE_MIN"
AUTOSCALE_MAX_ENV = "RAYDP_TPU_AUTOSCALE_MAX"
AUTOSCALE_INTERVAL_ENV = "RAYDP_TPU_AUTOSCALE_INTERVAL_S"
AUTOSCALE_UP_ENV = "RAYDP_TPU_AUTOSCALE_UP_THRESHOLD"
AUTOSCALE_DOWN_ENV = "RAYDP_TPU_AUTOSCALE_DOWN_THRESHOLD"
AUTOSCALE_UP_COOLDOWN_ENV = "RAYDP_TPU_AUTOSCALE_UP_COOLDOWN_S"
AUTOSCALE_DOWN_COOLDOWN_ENV = "RAYDP_TPU_AUTOSCALE_DOWN_COOLDOWN_S"
AUTOSCALE_STEP_ENV = "RAYDP_TPU_AUTOSCALE_STEP"
AUTOSCALE_IDLE_EVALS_ENV = "RAYDP_TPU_AUTOSCALE_IDLE_EVALS"
AUTOSCALE_SPAWN_RETRIES_ENV = "RAYDP_TPU_AUTOSCALE_SPAWN_RETRIES"
AUTOSCALE_BACKOFF_ENV = "RAYDP_TPU_AUTOSCALE_BACKOFF_S"

# Normalization references: each raw signal divided by its reference
# yields "units of backlog" comparable against the thresholds. One
# queued admission, ~5 s of oldest-waiter age, a loader starved half
# of wall-clock, ~1 s of stage queueing, one full serving batch of
# queue depth, or ~1 s of serving shed ETA each score 1.0.
_STARVE_REF_S = 5.0
_INGEST_REF_RATE = 0.5
_STAGE_REF_S = 1.0
_SERVE_DEPTH_REF = 8.0
_SERVE_ETA_REF_S = 1.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class ProvisionerError(RuntimeError):
    """A host-provisioner operation failed (spawn, retire)."""


class HostProvisioner:
    """The seam between scale decisions and host lifecycle.

    Implementations own the mechanics of bringing hosts up and down;
    the autoscaler owns *when*. ``grow`` may raise
    :class:`ProvisionerError` (or anything else) — the loop treats it
    as a retryable provisioning failure. ``retire`` must run the
    backend's graceful-drain path before reclaiming the host.
    """

    def grow(self, n: int) -> List[str]:
        """Spawn ``n`` hosts, returning their ids. Blocking."""
        raise NotImplementedError

    def retire(self, host_id: str) -> None:
        """Drain and release one host (graceful: in-flight work must
        survive via the backend's requeue machinery)."""
        raise NotImplementedError

    def hosts(self) -> List[str]:
        """Currently-live host ids, oldest first."""
        raise NotImplementedError

    def pick_victim(self) -> Optional[str]:
        """Host to drain next; newest-first keeps long-lived hosts'
        caches warm. None when nothing is drainable."""
        live = self.hosts()
        return live[-1] if live else None


class ClusterProvisioner(HostProvisioner):
    """Local-subprocess provider riding ``Cluster``'s spawn machinery.

    ``grow`` goes through ``Cluster.request_workers`` (launcher spec,
    agent wiring, registration wait); ``retire`` through
    ``Cluster.kill_worker``, whose stop path marks the worker dead on
    the master so in-flight ETL tasks requeue through the worker-gone
    retry machinery. This is the CI/test provider and the reference
    for the k8s seam.
    """

    def __init__(self, cluster: Any):
        self.cluster = cluster

    def grow(self, n: int) -> List[str]:
        try:
            return list(self.cluster.request_workers(n))
        except ProvisionerError:
            raise
        except Exception as exc:
            raise ProvisionerError(f"worker spawn failed: {exc}") from exc

    def retire(self, host_id: str) -> None:
        try:
            self.cluster.kill_worker(host_id)
        except Exception as exc:
            raise ProvisionerError(
                f"worker retire failed for {host_id}: {exc}"
            ) from exc

    def hosts(self) -> List[str]:
        # alive_workers() returns WorkerInfo records; the autoscaler
        # trades in plain host ids.
        return [w.worker_id for w in self.cluster.alive_workers()]


@dataclass
class AutoscalerConfig:
    """Scale-policy knobs; :meth:`from_env` reads the
    ``RAYDP_TPU_AUTOSCALE_*`` family (doc/configuration.md)."""

    min_workers: int = 1
    max_workers: int = 4
    interval_s: float = 5.0
    up_threshold: float = 1.0
    down_threshold: float = 0.25
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 30.0
    step: int = 1
    idle_evals: int = 3
    spawn_retries: int = 3
    backoff_s: float = 0.5

    @classmethod
    def from_env(cls) -> "AutoscalerConfig":
        d = cls()
        return cls(
            min_workers=_env_int(AUTOSCALE_MIN_ENV, d.min_workers),
            max_workers=_env_int(AUTOSCALE_MAX_ENV, d.max_workers),
            interval_s=_env_float(AUTOSCALE_INTERVAL_ENV, d.interval_s),
            up_threshold=_env_float(AUTOSCALE_UP_ENV, d.up_threshold),
            down_threshold=_env_float(AUTOSCALE_DOWN_ENV,
                                      d.down_threshold),
            up_cooldown_s=_env_float(AUTOSCALE_UP_COOLDOWN_ENV,
                                     d.up_cooldown_s),
            down_cooldown_s=_env_float(AUTOSCALE_DOWN_COOLDOWN_ENV,
                                       d.down_cooldown_s),
            step=_env_int(AUTOSCALE_STEP_ENV, d.step),
            idle_evals=_env_int(AUTOSCALE_IDLE_EVALS_ENV, d.idle_evals),
            spawn_retries=_env_int(AUTOSCALE_SPAWN_RETRIES_ENV,
                                   d.spawn_retries),
            backoff_s=_env_float(AUTOSCALE_BACKOFF_ENV, d.backoff_s),
        )


@dataclass
class Decision:
    """One evaluation's outcome, also recorded as an
    ``autoscale/decision`` event (the timeline is the audit log)."""

    verdict: str                  # grow | shrink | steady | denied | failed
    reason: str
    pressure: float
    size: int
    target: int
    signals: Dict[str, float] = field(default_factory=dict)


class Autoscaler:
    """Driver-side scale loop over a :class:`HostProvisioner`.

    ``step()`` runs one evaluation synchronously (what unit tests and
    the smoke gate drive); ``start()``/``stop()`` run the same
    evaluation on a daemon thread at ``interval_s``.
    """

    def __init__(
        self,
        provisioner: HostProvisioner,
        config: Optional[AutoscalerConfig] = None,
    ):
        self.provisioner = provisioner
        self.config = config or AutoscalerConfig.from_env()
        if self.config.max_workers < self.config.min_workers:
            raise ValueError(
                "autoscaler: max_workers "
                f"{self.config.max_workers} < min_workers "
                f"{self.config.min_workers}"
            )
        self._mu = threading.RLock()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._serve_groups: List[Any] = []
        self._host_waiters: List[Tuple[str, Callable[[str], bool]]] = []
        self._last_grow_mono: Optional[float] = None
        self._last_shrink_mono: Optional[float] = None
        self._idle_streak = 0
        self._last_sample_mono: Optional[float] = None
        self._last_ingest_wait = 0.0
        self._last_stage_id = 0
        self.decisions: List[Decision] = []

    # -- registration ---------------------------------------------------

    def register_serve_group(self, group: Any) -> None:
        """Track a ReplicaGroup's queue as a pressure source (and a
        drain target during scale-down)."""
        with self._mu:
            if group not in self._serve_groups:
                self._serve_groups.append(group)

    def unregister_serve_group(self, group: Any) -> None:
        with self._mu:
            if group in self._serve_groups:
                self._serve_groups.remove(group)

    def request_host(
        self, label: str, accept: Callable[[str], bool]
    ) -> None:
        """Register a waiting serving replica group for bin-packing:
        the next host freed by a drain is offered to ``accept`` (which
        returns True to take ownership) before the provisioner
        releases it."""
        with self._mu:
            self._host_waiters.append((label, accept))

    # -- pressure -------------------------------------------------------

    def sample_pressure(self) -> Dict[str, float]:
        """One normalized reading of every pressure source. Each key
        is already divided by its reference, so ``max(values)`` is the
        backlog score the thresholds compare against."""
        now = _clock.monotonic()
        sig: Dict[str, float] = {}
        try:
            from raydp_tpu_torch.control.arbiter import get_arbiter

            rep = get_arbiter().report()
            if rep.get("enabled"):
                sig["sched_queue_depth"] = float(
                    rep.get("queue_depth") or 0
                )
                sig["sched_wait_oldest"] = (
                    float(rep.get("wait_oldest_s") or 0.0) / _STARVE_REF_S
                )
        except Exception:
            pass
        try:
            snap = _metrics.snapshot().get("counters", {})
            wait_total = float(snap.get("ingest/wait_seconds", 0.0))
            if self._last_sample_mono is not None:
                dt = max(1e-6, now - self._last_sample_mono)
                rate = max(0.0, wait_total - self._last_ingest_wait) / dt
                sig["ingest_wait"] = rate / _INGEST_REF_RATE
            self._last_ingest_wait = wait_total
        except Exception:
            pass
        try:
            from raydp_tpu_torch.telemetry import stage_store

            last = stage_store.last_id()
            if last > self._last_stage_id:
                fresh = [
                    s for s in stage_store.recent(64)
                    if s.stage_id > self._last_stage_id
                ]
                if fresh:
                    sig["stage_queue"] = (
                        max(s.queue_s for s in fresh) / _STAGE_REF_S
                    )
                self._last_stage_id = last
        except Exception:
            pass
        with self._mu:
            groups = list(self._serve_groups)
        depth = 0.0
        eta = 0.0
        for g in groups:
            try:
                depth += float(g.queue.depth())
                eta = max(eta, float(g.queue.shed_eta_s()))
            except Exception:
                continue
        if groups:
            sig["serve_queue_depth"] = depth / _SERVE_DEPTH_REF
            sig["serve_shed_eta"] = eta / _SERVE_ETA_REF_S
        self._last_sample_mono = now
        return sig

    def _gang_floor(self) -> int:
        """Slots held by active gang leases: the pool must never
        shrink below what a live SPMD fit is leasing, so ranks are
        never chosen as victims mid-gang."""
        try:
            from raydp_tpu_torch.control.arbiter import get_arbiter

            rep = get_arbiter().report()
            if not rep.get("enabled"):
                return 0
            return sum(
                int(l.get("slots", 0)) for l in rep.get("leases", [])
                if l.get("kind") == "gang"
            )
        except Exception:
            return 0

    # -- the loop -------------------------------------------------------

    def step(self) -> Decision:
        """One evaluation: sample pressure, decide, act. Thread-safe;
        the background loop and tests share this path."""
        with self._mu:
            return self._step_locked()

    def _step_locked(self) -> Decision:
        cfg = self.config
        now = _clock.monotonic()
        signals = self.sample_pressure()
        pressure = max(signals.values()) if signals else 0.0
        size = len(self.provisioner.hosts())
        _metrics.gauge_set("autoscale/pool_size", float(size))

        decision: Decision
        if pressure >= cfg.up_threshold and size < cfg.max_workers:
            self._idle_streak = 0
            blocked = self._cooldown_left(now, cfg.up_cooldown_s)
            if blocked > 0.0:
                decision = self._deny(
                    f"up-cooldown {blocked:.1f}s left", pressure, size,
                    signals,
                )
            else:
                n = min(cfg.step, cfg.max_workers - size)
                decision = self._grow(n, pressure, size, signals)
        elif pressure <= cfg.down_threshold and size > cfg.min_workers:
            self._idle_streak += 1
            floor = max(cfg.min_workers, self._gang_floor())
            if size <= floor:
                decision = self._deny(
                    f"gang floor {floor}", pressure, size, signals
                )
            elif self._idle_streak < cfg.idle_evals:
                decision = Decision(
                    "steady",
                    f"idle {self._idle_streak}/{cfg.idle_evals} evals",
                    pressure, size, size, signals,
                )
            else:
                blocked = self._cooldown_left(now, cfg.down_cooldown_s)
                if blocked > 0.0:
                    decision = self._deny(
                        f"down-cooldown {blocked:.1f}s left", pressure,
                        size, signals,
                    )
                else:
                    n = min(cfg.step, size - floor)
                    decision = self._shrink(n, pressure, size, signals)
        else:
            if pressure > cfg.down_threshold:
                self._idle_streak = 0
            decision = Decision(
                "steady", "within thresholds", pressure, size, size,
                signals,
            )

        self.decisions.append(decision)
        if decision.verdict != "steady":
            _events.emit(
                "autoscale/decision", verdict=decision.verdict,
                reason=decision.reason,
                pressure=round(decision.pressure, 4),
                size=decision.size, target=decision.target,
                signals={k: round(v, 4)
                         for k, v in decision.signals.items()},
            )
        return decision

    def _cooldown_left(self, now: float, cooldown_s: float) -> float:
        """Seconds of cooldown remaining, measured against the last
        action in EITHER direction — a direction change inside its
        cooldown window is exactly the flap the loop must not make."""
        left = 0.0
        for stamp in (self._last_grow_mono, self._last_shrink_mono):
            if stamp is not None:
                left = max(left, cooldown_s - (now - stamp))
        return left

    def _deny(
        self, reason: str, pressure: float, size: int,
        signals: Dict[str, float],
    ) -> Decision:
        _metrics.counter_add("autoscale/denied")
        return Decision("denied", reason, pressure, size, size, signals)

    # -- scale-up -------------------------------------------------------

    def _grow(
        self, n: int, pressure: float, size: int,
        signals: Dict[str, float],
    ) -> Decision:
        """Spawn ``n`` hosts with backoff-and-retry: a provisioner
        failure (injected via ``spawn_fail`` or real) burns one
        attempt from the budget and backs off exponentially; the loop
        converges or reports a ``failed`` decision — never wedges."""
        from raydp_tpu_torch.fault import inject as _inject

        cfg = self.config
        attempts = 0
        _metrics.gauge_set("autoscale/pending_spawns", float(n))
        try:
            while True:
                try:
                    _inject.on_spawn()
                    new_ids = self.provisioner.grow(n)
                    break
                except Exception as exc:
                    attempts += 1
                    _metrics.counter_add("autoscale/spawn_failed")
                    _events.emit(
                        "autoscale/spawn_failed", attempt=attempts,
                        budget=cfg.spawn_retries, error=repr(exc),
                    )
                    if attempts > cfg.spawn_retries:
                        logger.error(
                            "autoscaler: spawn budget exhausted after "
                            "%d attempts: %s", attempts, exc,
                        )
                        return Decision(
                            "failed",
                            f"spawn budget exhausted ({attempts})",
                            pressure, size, size + n, signals,
                        )
                    delay = cfg.backoff_s * (2 ** (attempts - 1))
                    if _clock.wait_event(self._stopping, timeout=delay):
                        return Decision(
                            "failed", "stopped during spawn backoff",
                            pressure, size, size + n, signals,
                        )
        finally:
            _metrics.gauge_set("autoscale/pending_spawns", 0.0)
        self._last_grow_mono = _clock.monotonic()
        self._idle_streak = 0
        _metrics.counter_add("autoscale/decisions/grow")
        _metrics.gauge_set(
            "autoscale/pool_size", float(len(self.provisioner.hosts()))
        )
        _events.emit(
            "autoscale/grow", added=list(new_ids), size=size + len(new_ids),
            attempts=attempts + 1,
        )
        return Decision(
            "grow", f"pressure {pressure:.2f} >= {cfg.up_threshold}",
            pressure, size, size + len(new_ids), signals,
        )

    # -- scale-down -----------------------------------------------------

    def _shrink(
        self, n: int, pressure: float, size: int,
        signals: Dict[str, float],
    ) -> Decision:
        """Drain-then-retire ``n`` victims. Order per victim: emit the
        drain marker, offer the host to waiting serve groups
        (bin-packing), and only then let the provisioner retire it —
        the retire path requeues in-flight work through the existing
        worker-gone machinery."""
        cfg = self.config
        drained = 0
        for _ in range(n):
            victim = self.provisioner.pick_victim()
            if victim is None:
                break
            _metrics.counter_add("autoscale/drains")
            _events.emit("autoscale/drain", host=victim)
            if self._offer_host(victim):
                drained += 1
                continue
            try:
                self.provisioner.retire(victim)
            except Exception as exc:
                _events.emit(
                    "autoscale/retire_failed", host=victim,
                    error=repr(exc),
                )
                logger.warning(
                    "autoscaler: retire of %s failed: %s", victim, exc
                )
                continue
            drained += 1
            _events.emit("autoscale/retire", host=victim)
        if drained == 0:
            return self._deny("no drainable victim", pressure, size,
                              signals)
        self._last_shrink_mono = _clock.monotonic()
        self._idle_streak = 0
        _metrics.counter_add("autoscale/decisions/shrink")
        _metrics.gauge_set(
            "autoscale/pool_size", float(len(self.provisioner.hosts()))
        )
        return Decision(
            "shrink", f"pressure {pressure:.2f} <= {cfg.down_threshold}",
            pressure, size, size - drained, signals,
        )

    def _offer_host(self, host_id: str) -> bool:
        """FIFO bin-packing offer of a freed host to waiting serve
        groups. An accepted host changes owner instead of dying."""
        while self._host_waiters:
            label, accept = self._host_waiters.pop(0)
            try:
                taken = bool(accept(host_id))
            except Exception:
                taken = False
            if taken:
                _metrics.counter_add("autoscale/decisions/binpack")
                _events.emit(
                    "autoscale/binpack", host=host_id, group=label
                )
                return True
        return False

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Autoscaler":
        """Run the loop on a daemon thread at ``interval_s``."""
        with self._mu:
            if self._thread is not None:
                return self
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="raydp-autoscaler"
            )
            _events.emit(
                "autoscale/start", min_workers=self.config.min_workers,
                max_workers=self.config.max_workers,
                interval_s=self.config.interval_s,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stopping.wait(timeout=self.config.interval_s):
            try:
                self.step()
            except Exception:
                logger.exception("autoscaler: evaluation failed")

    def stop(self) -> None:
        """Stop the loop; the pool keeps its current size."""
        # Set the flag before taking the lock: a step mid-backoff
        # holds the lock but watches the event, so this unblocks it.
        self._stopping.set()
        with self._mu:
            thread = self._thread
            self._thread = None
        if thread is None:
            return
        thread.join(timeout=10.0)
        _events.emit("autoscale/stop")

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.stop()
