"""Driver-side time-series retention for the merged metric registry.

The port's copy of ``raydp_tpu/telemetry/timeseries.py``.

Every Prometheus family in :mod:`~raydp_tpu_torch.telemetry.export` is an
instantaneous value: the exposition answers "what is the counter NOW",
never "what was it doing over the last minute". Windowed questions —
is the serve p99 above its SLO *sustained*, is the shed rate rising,
did MFU fall off a cliff — need short-horizon history, and requiring
an external Prometheus server for them makes the SLO engine
(:mod:`~raydp_tpu_torch.telemetry.slo`) unusable in tests, CI gates, and
single-host runs.

This module is that history: a bounded in-memory store of per-series
rings sampled at fixed cadence from the same merged view the
heartbeat-shipping path already maintains
(``ClusterTelemetry.merged()`` + the driver registry — no new RPCs,
no new collection paths). Like every other plane it is memory-bounded
(per-series ring capacity × a series-count cap, both env-tunable) and
kill-switched (``RAYDP_TPU_TIMESERIES=0`` makes sampling a no-op).

Series names are the flattened registry names (``serve/rejected``,
``mfu``, ``serve/latency/p99_s``, ``ingest/rows/per_sec``), so the
per-job label dimension comes through unchanged: job-attributed
counters are already namespaced ``job/<job_id>/<kind>`` by the
accounting ledger.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "TIMESERIES_ENV",
    "TIMESERIES_INTERVAL_ENV",
    "TIMESERIES_CAPACITY_ENV",
    "TIMESERIES_MAX_SERIES_ENV",
    "timeseries_enabled",
    "flatten_view",
    "TimeSeriesConfig",
    "TimeSeriesStore",
    "TimeSeriesSampler",
    "active_sampler",
    "active_store",
]

#: Kill switch: ``0`` disables sampling entirely (the store stays
#: empty, the SLO engine sees no data and stays quiet).
TIMESERIES_ENV = "RAYDP_TPU_TIMESERIES"
TIMESERIES_INTERVAL_ENV = "RAYDP_TPU_TIMESERIES_INTERVAL_S"
TIMESERIES_CAPACITY_ENV = "RAYDP_TPU_TIMESERIES_CAPACITY"
TIMESERIES_MAX_SERIES_ENV = "RAYDP_TPU_TIMESERIES_MAX_SERIES"

#: Timer stats that take the cross-source max when flattening (the
#: straggler view, matching ClusterTelemetry.merged aggregation);
#: count/total_s sum.
_TIMER_MAX_STATS = ("p50_s", "p90_s", "p99_s", "mean_s")

# Rough per-sample / per-series memory accounting for stats(): a
# (wall, value) float pair in a deque plus dict/key overhead.
_SAMPLE_BYTES = 120
_SERIES_BYTES = 300


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


def timeseries_enabled() -> bool:
    """Live kill switch — checked per sample, not cached, so flipping
    ``RAYDP_TPU_TIMESERIES=0`` stops retention without a restart."""
    return os.environ.get(TIMESERIES_ENV, "1") != "0"


@dataclass
class TimeSeriesConfig:
    """Retention knobs; ``from_env`` reads ``RAYDP_TPU_TIMESERIES_*``
    (constructor arguments win, mirroring AutoscalerConfig)."""

    interval_s: float = 1.0
    capacity: int = 512
    max_series: int = 4096

    @classmethod
    def from_env(cls) -> "TimeSeriesConfig":
        return cls(
            interval_s=max(
                0.01, _env_float(TIMESERIES_INTERVAL_ENV, 1.0)
            ),
            capacity=max(8, _env_int(TIMESERIES_CAPACITY_ENV, 512)),
            max_series=max(16, _env_int(TIMESERIES_MAX_SERIES_ENV, 4096)),
        )


def flatten_view(view: Dict[str, Any]) -> Dict[str, float]:
    """Merged-snapshot shape → flat ``{series_name: value}``.

    Folds the cross-worker ``aggregate`` and the ``driver`` registry
    into one namespace (counters/gauges/meter stats sum; timer
    percentiles take the max — the straggler view). Histogram sections
    flatten to the same ``<name>/p50_s``-style percentile series so
    consumers (SLO engine, dashboard) are agnostic to whether a
    latency is timer- or histogram-backed; empty histograms emit
    nothing rather than a fabricated 0.
    """
    from raydp_tpu_torch.utils.profiling import quantile_from_hist_summary
    out: Dict[str, float] = {}
    for source_key in ("aggregate", "driver"):
        sections = view.get(source_key) or {}
        for key, section in sections.items():
            if key == "counters" or key == "gauges":
                for name, value in section.items():
                    try:
                        out[name] = out.get(name, 0.0) + float(value)
                    except (TypeError, ValueError):
                        continue
            elif key.startswith("timer/"):
                tname = key[len("timer/"):]
                for stat, value in section.items():
                    series = f"{tname}/{stat}"
                    try:
                        value = float(value)
                    except (TypeError, ValueError):
                        continue
                    if stat in _TIMER_MAX_STATS:
                        out[series] = max(out.get(series, 0.0), value)
                    else:
                        out[series] = out.get(series, 0.0) + value
            elif key.startswith("hist/"):
                hname = key[len("hist/"):]
                try:
                    count = float(section.get("count", 0.0))
                except (AttributeError, TypeError, ValueError):
                    continue
                if count <= 0:
                    continue
                total = float(section.get("sum", 0.0))
                for stat, q in (("p50_s", 0.5), ("p90_s", 0.9), ("p99_s", 0.99)):
                    value = quantile_from_hist_summary(section, q)
                    if value is None:
                        continue
                    series = f"{hname}/{stat}"
                    out[series] = max(out.get(series, 0.0), value)
                out[f"{hname}/mean_s"] = max(
                    out.get(f"{hname}/mean_s", 0.0), total / count
                )
                out[f"{hname}/count"] = out.get(f"{hname}/count", 0.0) + count
            elif key.startswith("meter/"):
                mname = key[len("meter/"):]
                for stat in ("total", "per_sec"):
                    series = f"{mname}/{stat}"
                    out[series] = out.get(series, 0.0) + float(
                        section.get(stat, 0.0)
                    )
    return out


class TimeSeriesStore:
    """Bounded per-series rings with windowed queries.

    Memory bound is structural: at most ``max_series`` rings of at
    most ``capacity`` samples each; a sample for a new series past the
    cap is counted in ``dropped_series`` and discarded (existing
    series keep updating — the cap sheds cardinality, not history).
    """

    def __init__(self, config: Optional[TimeSeriesConfig] = None):
        self.config = config or TimeSeriesConfig.from_env()
        self._mu = threading.Lock()
        self._series: Dict[str, "deque[Tuple[float, float]]"] = {}
        self._dropped_series = 0

    # -- writes ---------------------------------------------------------

    def record(self, name: str, value: float,
               wall: Optional[float] = None) -> bool:
        """Append one sample; False when the series cap rejected a new
        series."""
        wall = time.time() if wall is None else wall
        with self._mu:
            ring = self._series.get(name)
            if ring is None:
                if len(self._series) >= self.config.max_series:
                    self._dropped_series += 1
                    return False
                ring = deque(maxlen=self.config.capacity)
                self._series[name] = ring
            ring.append((wall, float(value)))
        return True

    def observe(self, flat: Dict[str, float],
                wall: Optional[float] = None) -> int:
        """Record a whole flattened snapshot; returns series written."""
        wall = time.time() if wall is None else wall
        written = 0
        for name, value in flat.items():
            if self.record(name, value, wall):
                written += 1
        return written

    # -- reads ----------------------------------------------------------

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._series)

    def matching(self, pattern: str) -> List[str]:
        """Series matching ``pattern``: exact, or prefix when the
        pattern ends with ``*`` (``worker_restarts/*``)."""
        if pattern.endswith("*"):
            prefix = pattern[:-1]
            return [n for n in self.names() if n.startswith(prefix)]
        return [pattern] if pattern in self.names() else []

    def window(self, name: str, seconds: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples of ``name`` in the trailing ``seconds``, oldest first."""
        now = time.time() if now is None else now
        cutoff = now - seconds
        with self._mu:
            ring = self._series.get(name)
            if not ring:
                return []
            return [(w, v) for w, v in ring if w >= cutoff]

    def last(self, name: str) -> Optional[float]:
        with self._mu:
            ring = self._series.get(name)
            return ring[-1][1] if ring else None

    def avg(self, name: str, seconds: float,
            now: Optional[float] = None) -> Optional[float]:
        samples = self.window(name, seconds, now)
        if not samples:
            return None
        return sum(v for _, v in samples) / len(samples)

    def max_value(self, name: str, seconds: float,
                  now: Optional[float] = None) -> Optional[float]:
        samples = self.window(name, seconds, now)
        return max((v for _, v in samples), default=None)

    def percentile(self, name: str, q: float, seconds: float,
                   now: Optional[float] = None) -> Optional[float]:
        """``q`` in [0, 1] over the window's sample values (nearest-rank
        on the sorted window — the same estimator StepTimer uses)."""
        samples = sorted(v for _, v in self.window(name, seconds, now))
        if not samples:
            return None
        idx = min(len(samples) - 1, int(q * (len(samples) - 1)))
        return samples[idx]

    def rate(self, name: str, seconds: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second increase of a cumulative series over the window,
        clamped at zero (a restart-reset counter reads as quiescent,
        not negative)."""
        samples = self.window(name, seconds, now)
        if len(samples) < 2:
            return None
        (w0, v0), (w1, v1) = samples[0], samples[-1]
        dt = w1 - w0
        if dt <= 0:
            return None
        return max(0.0, (v1 - v0) / dt)

    def stats(self) -> Dict[str, Any]:
        """Footprint report for the dashboard and the bounded-memory
        tests: series/sample counts, cap rejections, and a conservative
        byte estimate."""
        with self._mu:
            n_series = len(self._series)
            n_samples = sum(len(r) for r in self._series.values())
            dropped = self._dropped_series
        return {
            "series": n_series,
            "samples": n_samples,
            "dropped_series": dropped,
            "capacity": self.config.capacity,
            "max_series": self.config.max_series,
            "memory_bytes_est": (
                n_samples * _SAMPLE_BYTES + n_series * _SERIES_BYTES
            ),
        }


def _local_view() -> Dict[str, Any]:
    """Fallback snapshot source: this process's own registry, shaped
    like ``Cluster.metrics_snapshot()`` so ``flatten_view`` is one code
    path. The serving plane and the SLO engine both live driver-side,
    so a sampler without a cluster still sees every driver signal."""
    from raydp_tpu_torch.utils.profiling import metrics as _metrics

    return {"workers": {}, "aggregate": {}, "driver": _metrics.snapshot()}


class TimeSeriesSampler:
    """Fixed-cadence background sampler feeding a :class:`TimeSeriesStore`.

    ``snapshot_fn`` returns the merged-view shape; the driver passes
    ``Cluster.metrics_snapshot`` (riding the heartbeat-merge path), the
    default samples the local registry. ``step()``-style synchronous
    sampling (``sample()``) exists for tests and for callers that want
    to own the cadence.
    """

    def __init__(
        self,
        snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        store: Optional[TimeSeriesStore] = None,
        config: Optional[TimeSeriesConfig] = None,
    ):
        self.config = config or TimeSeriesConfig.from_env()
        self.store = store or TimeSeriesStore(self.config)
        self._snapshot_fn = snapshot_fn or _local_view
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self.samples_taken = 0

    def sample(self, wall: Optional[float] = None) -> int:
        """One synchronous sample; 0 when kill-switched or the source
        raised (sampling is an observer — it must never sink the
        workload)."""
        if not timeseries_enabled():
            return 0
        try:
            flat = flatten_view(self._snapshot_fn())
        except Exception:
            return 0
        written = self.store.observe(flat, wall)
        self.samples_taken += 1
        return written

    def start(self) -> "TimeSeriesSampler":
        if self._thread is not None:
            return self
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._loop, name="raydp-timeseries", daemon=True
        )
        self._thread.start()
        _set_active(self)
        return self

    def _loop(self) -> None:
        while not self._stopping.is_set():
            self.sample()
            self._stopping.wait(timeout=self.config.interval_s)

    def stop(self) -> None:
        self._stopping.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        _clear_active(self)


# -- process-wide registration ------------------------------------------
#
# The dashboard and the master's DashboardReport handler need to find
# the running sampler without threading it through every constructor;
# start()/stop() register the instance here (latest start wins).

_active_mu = threading.Lock()
_active: Optional[TimeSeriesSampler] = None


def _set_active(sampler: TimeSeriesSampler) -> None:
    global _active
    with _active_mu:
        _active = sampler


def _clear_active(sampler: TimeSeriesSampler) -> None:
    global _active
    with _active_mu:
        if _active is sampler:
            _active = None


def active_sampler() -> Optional[TimeSeriesSampler]:
    with _active_mu:
        return _active


def active_store() -> Optional[TimeSeriesStore]:
    sampler = active_sampler()
    return sampler.store if sampler is not None else None
