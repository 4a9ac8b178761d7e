"""SLO engine: declarative objectives over the time-series store.

The port's copy of ``raydp_tpu/telemetry/slo.py``.

The telemetry stack measures everything and judges nothing: whether
the serve p99 is acceptable, whether the restart rate is an incident,
whether a tenant has been starved too long — those judgements lived in
humans reading dashboards. This module makes them declarative: an
:class:`Objective` names a series (from
:mod:`~raydp_tpu_torch.telemetry.timeseries`), a signal (windowed sample
values or a counter rate), and a threshold; the :class:`SloEngine`
evaluates every objective as an SRE-style **multi-window burn rate**:

* the *bad fraction* of a window is the fraction of samples violating
  the threshold (value signals) or whether the windowed rate exceeds
  it (rate signals);
* the burn rate is ``bad_fraction / error_budget``
  (``RAYDP_TPU_SLO_BUDGET``) — 1.0 means "exactly consuming budget";
* a **breach** requires the burn to exceed
  ``RAYDP_TPU_SLO_BURN_THRESHOLD`` in BOTH the short window (it is
  still happening) and the long window (it is sustained, not a blip);
* **recovery** needs the short-window burn back under the threshold
  for ``RAYDP_TPU_SLO_RECOVERY_EVALS`` consecutive evaluations — the
  hysteresis that stops a flapping signal from spamming episodes.

A breach emits ``slo/breach`` into the event timeline carrying the top
contributing series and the correlated recent events in the breach
window (auto-triage: the restart/preempt/shed that likely caused it
rides in the breach record); recovery emits ``slo/recovered`` with the
measured MTTR. Both kinds participate in
:func:`~raydp_tpu_torch.telemetry.events.mttr_report` episodes. Status,
burn, and breach counts export as the ``raydp_slo_*`` Prometheus
families via the ``slo/status/<objective>``, ``slo/burn/<objective>``
and ``slo/breaches/<objective>`` registry names.

Kill-switched with ``RAYDP_TPU_SLO=0`` like every other plane.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.telemetry.timeseries import TimeSeriesStore, active_store
from raydp_tpu_torch.utils.profiling import metrics as _metrics

__all__ = [
    "SLO_ENV",
    "SLO_INTERVAL_ENV",
    "SLO_SHORT_WINDOW_ENV",
    "SLO_LONG_WINDOW_ENV",
    "SLO_BUDGET_ENV",
    "SLO_BURN_THRESHOLD_ENV",
    "SLO_RECOVERY_EVALS_ENV",
    "SLO_QUEUE_WAIT_ENV",
    "SLO_MFU_FLOOR_ENV",
    "slo_enabled",
    "Objective",
    "SloConfig",
    "SloEngine",
    "default_objectives",
    "active_engine",
    "status_report",
]

SLO_ENV = "RAYDP_TPU_SLO"
SLO_INTERVAL_ENV = "RAYDP_TPU_SLO_INTERVAL_S"
SLO_SHORT_WINDOW_ENV = "RAYDP_TPU_SLO_SHORT_WINDOW_S"
SLO_LONG_WINDOW_ENV = "RAYDP_TPU_SLO_LONG_WINDOW_S"
SLO_BUDGET_ENV = "RAYDP_TPU_SLO_BUDGET"
SLO_BURN_THRESHOLD_ENV = "RAYDP_TPU_SLO_BURN_THRESHOLD"
SLO_RECOVERY_EVALS_ENV = "RAYDP_TPU_SLO_RECOVERY_EVALS"
SLO_QUEUE_WAIT_ENV = "RAYDP_TPU_SLO_QUEUE_WAIT_S"
SLO_MFU_FLOOR_ENV = "RAYDP_TPU_SLO_MFU_FLOOR"

#: Fixed thresholds for the rate objectives (rates are "per second of
#: wall clock"; any sustained nonzero restart/stall rate is already an
#: incident, shedding and ingest starvation get small allowances).
_SHED_RATE_THRESHOLD = 0.5
_RESTART_RATE_THRESHOLD = 0.0
_STALL_RATE_THRESHOLD = 0.0
_INGEST_STARVE_RATE = 0.5

#: How many correlated timeline events / contributing series ride in a
#: breach event (auto-triage payload, bounded so a busy timeline can't
#: bloat the record).
_TRIAGE_EVENTS = 8
_TRIAGE_SERIES = 3


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


def slo_enabled() -> bool:
    """Live kill switch (``RAYDP_TPU_SLO=0``), checked per evaluation."""
    return os.environ.get(SLO_ENV, "1") != "0"


@dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``series`` is a time-series name, or a prefix ending in ``*``
    (matches are folded: rates sum, values take the worst). ``signal``
    is ``"value"`` (judge windowed sample values against the
    threshold) or ``"rate"`` (judge the windowed per-second increase).
    ``op`` is ``"gt"`` (violating when above the threshold) or
    ``"lt"`` (below — e.g. an MFU floor).
    """

    name: str
    series: str
    signal: str = "value"
    op: str = "gt"
    threshold: float = 0.0
    description: str = ""


@dataclass
class SloConfig:
    """Engine knobs; ``from_env`` reads ``RAYDP_TPU_SLO_*``."""

    interval_s: float = 1.0
    short_window_s: float = 30.0
    long_window_s: float = 300.0
    budget: float = 0.05
    burn_threshold: float = 1.0
    recovery_evals: int = 3

    @classmethod
    def from_env(cls) -> "SloConfig":
        return cls(
            interval_s=max(0.01, _env_float(SLO_INTERVAL_ENV, 1.0)),
            short_window_s=max(
                0.1, _env_float(SLO_SHORT_WINDOW_ENV, 30.0)
            ),
            long_window_s=max(0.1, _env_float(SLO_LONG_WINDOW_ENV, 300.0)),
            budget=min(1.0, max(1e-6, _env_float(SLO_BUDGET_ENV, 0.05))),
            burn_threshold=max(
                1e-6, _env_float(SLO_BURN_THRESHOLD_ENV, 1.0)
            ),
            recovery_evals=max(1, _env_int(SLO_RECOVERY_EVALS_ENV, 3)),
        )


def default_objectives() -> List[Objective]:
    """The built-in flywheel objectives, thresholds from the existing
    env surface. The MFU floor ships disabled (0.0) until
    ``RAYDP_TPU_SLO_MFU_FLOOR`` is set — there is no universal floor
    across models and backends."""
    serve_slo_s = _env_float("RAYDP_TPU_SERVE_SLO_MS", 50.0) / 1000.0
    objectives = [
        Objective(
            name="serve_p99",
            series="serve/latency/p99_s",
            signal="value",
            op="gt",
            threshold=serve_slo_s,
            description="serving p99 latency vs RAYDP_TPU_SERVE_SLO_MS",
        ),
        Objective(
            name="serve_shed_rate",
            series="serve/rejected",
            signal="rate",
            op="gt",
            threshold=_SHED_RATE_THRESHOLD,
            description="requests shed at admission per second",
        ),
        Objective(
            name="worker_stalls",
            series="watchdog/stalls",
            signal="rate",
            op="gt",
            threshold=_STALL_RATE_THRESHOLD,
            description="watchdog stall episodes per second",
        ),
        Objective(
            name="worker_restart_rate",
            series="worker_restarts/*",
            signal="rate",
            op="gt",
            threshold=_RESTART_RATE_THRESHOLD,
            description="ETL worker respawns per second (any lineage)",
        ),
        Objective(
            name="gang_restart_rate",
            series="restarts/total",
            signal="rate",
            op="gt",
            threshold=_RESTART_RATE_THRESHOLD,
            description="supervised gang relaunches per second",
        ),
        Objective(
            name="arbiter_starvation",
            series="sched/queue_wait_oldest",
            signal="value",
            op="gt",
            threshold=_env_float(SLO_QUEUE_WAIT_ENV, 30.0),
            description="oldest admission waiter age vs the queue-wait "
                        "objective",
        ),
        Objective(
            name="ingest_starvation",
            series="ingest/wait_seconds",
            signal="rate",
            op="gt",
            threshold=_INGEST_STARVE_RATE,
            description="loader wait seconds per wall second (input-bound "
                        "training)",
        ),
    ]
    mfu_floor = _env_float(SLO_MFU_FLOOR_ENV, 0.0)
    if mfu_floor > 0.0:
        objectives.append(Objective(
            name="mfu_floor",
            series="mfu",
            signal="value",
            op="lt",
            threshold=mfu_floor,
            description="model FLOPs utilization floor",
        ))
    return objectives


@dataclass
class _ObjectiveState:
    breached: bool = False
    breach_wall: float = 0.0
    good_streak: int = 0
    burn_short: float = 0.0
    burn_long: float = 0.0
    breaches: int = 0
    last_mttr_s: Optional[float] = None
    last_value: Optional[float] = None
    top_series: List[Dict[str, Any]] = field(default_factory=list)


class SloEngine:
    """Evaluates objectives against a store; emits breach/recovery.

    ``store`` defaults to the process's active sampler store at
    evaluation time, so an engine constructed before the sampler still
    binds to it. ``step()``-style synchronous evaluation
    (:meth:`evaluate`) for tests; ``start()``/``stop()`` for the
    background loop.
    """

    def __init__(
        self,
        store: Optional[TimeSeriesStore] = None,
        config: Optional[SloConfig] = None,
        objectives: Optional[List[Objective]] = None,
    ):
        self.config = config or SloConfig.from_env()
        self.objectives = (
            list(objectives) if objectives is not None
            else default_objectives()
        )
        self._store = store
        self._states: Dict[str, _ObjectiveState] = {
            o.name: _ObjectiveState() for o in self.objectives
        }
        self._mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # -- burn-rate math -------------------------------------------------

    def _resolve_store(self) -> Optional[TimeSeriesStore]:
        return self._store if self._store is not None else active_store()

    def _violates(self, obj: Objective, value: float) -> bool:
        if obj.op == "lt":
            return value < obj.threshold
        return value > obj.threshold

    def _bad_fraction(
        self, store: TimeSeriesStore, obj: Objective, window_s: float,
        now: float,
    ) -> Optional[float]:
        """Fraction of the window in violation; None with no data."""
        names = store.matching(obj.series)
        if not names:
            return None
        if obj.signal == "rate":
            rates = [store.rate(n, window_s, now) for n in names]
            rates = [r for r in rates if r is not None]
            if not rates:
                return None
            return 1.0 if self._violates(obj, sum(rates)) else 0.0
        bad = total = 0
        for name in names:
            for _, value in store.window(name, window_s, now):
                total += 1
                if self._violates(obj, value):
                    bad += 1
        if total == 0:
            return None
        return bad / total

    def burn_rates(
        self, obj: Objective, now: Optional[float] = None
    ) -> Optional[Dict[str, float]]:
        """``{"short": burn, "long": burn}`` or None with no data."""
        store = self._resolve_store()
        if store is None:
            return None
        now = time.time() if now is None else now
        short = self._bad_fraction(
            store, obj, self.config.short_window_s, now
        )
        long_ = self._bad_fraction(
            store, obj, self.config.long_window_s, now
        )
        if short is None or long_ is None:
            return None
        return {
            "short": short / self.config.budget,
            "long": long_ / self.config.budget,
        }

    def _current_value(
        self, store: TimeSeriesStore, obj: Objective, now: float
    ) -> Optional[float]:
        names = store.matching(obj.series)
        if not names:
            return None
        if obj.signal == "rate":
            rates = [
                store.rate(n, self.config.short_window_s, now)
                for n in names
            ]
            rates = [r for r in rates if r is not None]
            return sum(rates) if rates else None
        values = [store.last(n) for n in names]
        values = [v for v in values if v is not None]
        if not values:
            return None
        return min(values) if obj.op == "lt" else max(values)

    def _top_contributors(
        self, store: TimeSeriesStore, obj: Objective, now: float
    ) -> List[Dict[str, Any]]:
        """The matching series ranked by how hard they violate — the
        'offending series' payload of a breach event."""
        rows: List[Dict[str, Any]] = []
        for name in store.matching(obj.series):
            if obj.signal == "rate":
                value = store.rate(name, self.config.short_window_s, now)
            else:
                value = store.max_value(
                    name, self.config.short_window_s, now
                ) if obj.op == "gt" else store.avg(
                    name, self.config.short_window_s, now
                )
            if value is None:
                continue
            rows.append({"series": name, "value": round(value, 6)})
        reverse = obj.op != "lt"
        rows.sort(key=lambda r: r["value"], reverse=reverse)
        return rows[:_TRIAGE_SERIES]

    def _correlated_events(self, now: float) -> List[Dict[str, Any]]:
        """Recent non-SLO timeline events inside the short window — the
        auto-triage payload: what else happened while the objective was
        burning."""
        cutoff = now - self.config.short_window_s
        out: List[Dict[str, Any]] = []
        for rec in _events.local_events(limit=256):
            wall = float(rec.get("start_wall") or 0.0)
            kind = rec.get("name", "")
            if wall < cutoff or kind.startswith("slo/"):
                continue
            out.append({
                "kind": kind,
                "ago_s": round(now - wall, 3),
                "job": rec.get("job"),
            })
        return out[-_TRIAGE_EVENTS:]

    # -- evaluation -----------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One synchronous evaluation of every objective; returns the
        breach/recovery transitions that fired. No-op when
        kill-switched or when no store is bound."""
        if not slo_enabled():
            return []
        store = self._resolve_store()
        if store is None:
            return []
        now = time.time() if now is None else now
        transitions: List[Dict[str, Any]] = []
        with self._mu:
            for obj in self.objectives:
                state = self._states[obj.name]
                burns = self.burn_rates(obj, now)
                if burns is None:
                    # No data: never breach-triggering; counts toward
                    # recovery (a torn-down plane must not wedge an
                    # open episode forever).
                    state.burn_short = 0.0
                    state.burn_long = 0.0
                    if state.breached:
                        state.good_streak += 1
                        if state.good_streak >= self.config.recovery_evals:
                            transitions.append(
                                self._recover(obj, state, now)
                            )
                    self._export_state(obj, state)
                    continue
                state.burn_short = burns["short"]
                state.burn_long = burns["long"]
                state.last_value = self._current_value(store, obj, now)
                burning = (
                    burns["short"] >= self.config.burn_threshold
                    and burns["long"] >= self.config.burn_threshold
                )
                if not state.breached:
                    if burning:
                        transitions.append(
                            self._breach(store, obj, state, now)
                        )
                else:
                    if burns["short"] < self.config.burn_threshold:
                        state.good_streak += 1
                        if state.good_streak >= self.config.recovery_evals:
                            transitions.append(
                                self._recover(obj, state, now)
                            )
                    else:
                        state.good_streak = 0
                self._export_state(obj, state)
        return transitions

    def _breach(
        self, store: TimeSeriesStore, obj: Objective,
        state: _ObjectiveState, now: float,
    ) -> Dict[str, Any]:
        state.breached = True
        state.breach_wall = now
        state.good_streak = 0
        state.breaches += 1
        state.top_series = self._top_contributors(store, obj, now)
        _metrics.counter_add(f"slo/breaches/{obj.name}")
        rec = _events.emit(
            "slo/breach",
            objective=obj.name,
            series=obj.series,
            threshold=obj.threshold,
            value=state.last_value,
            burn_short=round(state.burn_short, 4),
            burn_long=round(state.burn_long, 4),
            top_series=state.top_series,
            correlated=self._correlated_events(now),
        )
        return {"kind": "breach", "objective": obj.name, "event": rec}

    def _recover(
        self, obj: Objective, state: _ObjectiveState, now: float
    ) -> Dict[str, Any]:
        mttr = now - state.breach_wall
        state.breached = False
        state.good_streak = 0
        state.last_mttr_s = mttr
        rec = _events.emit(
            "slo/recovered",
            objective=obj.name,
            series=obj.series,
            mttr_s=round(mttr, 3),
        )
        return {
            "kind": "recovered", "objective": obj.name,
            "mttr_s": mttr, "event": rec,
        }

    def _export_state(self, obj: Objective, state: _ObjectiveState) -> None:
        _metrics.gauge_set(
            f"slo/status/{obj.name}", 1.0 if state.breached else 0.0
        )
        _metrics.gauge_set(
            f"slo/burn/{obj.name}", round(state.burn_short, 4)
        )

    # -- reporting ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """Per-objective status table (the dashboard's SLO section)."""
        now = time.time()
        out: Dict[str, Any] = {}
        with self._mu:
            for obj in self.objectives:
                state = self._states[obj.name]
                out[obj.name] = {
                    "status": "breached" if state.breached else "ok",
                    "series": obj.series,
                    "signal": obj.signal,
                    "op": obj.op,
                    "threshold": obj.threshold,
                    "value": state.last_value,
                    "burn_short": round(state.burn_short, 4),
                    "burn_long": round(state.burn_long, 4),
                    "breaches": state.breaches,
                    "last_mttr_s": state.last_mttr_s,
                    "breach_age_s": (
                        round(now - state.breach_wall, 3)
                        if state.breached else None
                    ),
                    "top_series": list(state.top_series),
                }
        return out

    # -- background loop ------------------------------------------------

    def start(self) -> "SloEngine":
        if self._thread is not None:
            return self
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._loop, name="raydp-slo", daemon=True
        )
        self._thread.start()
        _set_active(self)
        return self

    def _loop(self) -> None:
        while not self._stopping.is_set():
            try:
                self.evaluate()
            except Exception:  # the judge must never sink the workload
                pass
            self._stopping.wait(timeout=self.config.interval_s)

    def stop(self) -> None:
        self._stopping.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        _clear_active(self)


# -- process-wide registration ------------------------------------------

_active_mu = threading.Lock()
_active: Optional[SloEngine] = None


def _set_active(engine: SloEngine) -> None:
    global _active
    with _active_mu:
        _active = engine


def _clear_active(engine: SloEngine) -> None:
    global _active
    with _active_mu:
        if _active is engine:
            _active = None


def active_engine() -> Optional[SloEngine]:
    with _active_mu:
        return _active


def status_report() -> Dict[str, Any]:
    """The active engine's status table, or ``{}`` when none runs."""
    engine = active_engine()
    return engine.status() if engine is not None else {}
