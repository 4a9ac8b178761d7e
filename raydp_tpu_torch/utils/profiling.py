"""Process-wide counters, gauges, timers, histograms and throughput meters.

The port's copy of the JAX package's ``utils/profiling.py`` registry:
``counter_add``, ``gauge_set``/``gauge_value``/``gauge_max``, ``meter``
(:class:`ThroughputMeter`), ``timer`` (:class:`StepTimer`), ``histogram``
(:class:`Histogram`), ``snapshot``/``reset`` and
:func:`sample_resource_gauges`.

Left for the device-phase plane (ROADMAP item 6.4): ``trace``,
``annotate``, the compile listener, ``enrich_compile_error`` and
``cost_analysis_summary`` (XLA's hooks; the port's counterparts sit on
``torch.profiler``).
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "StepTimer",
    "ThroughputMeter",
    "metrics",
    "quantile_from_hist_summary",
    "sample_resource_gauges",
]


class StepTimer:
    """Rolling window of step durations with percentiles. A per-timer
    lock covers the deque: ``snapshot()`` from a monitoring thread must
    not race a mutating append."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._times: "deque[float]" = deque(maxlen=window)
        self._total = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._mu:
            self._times.append(seconds)
            self._total += seconds
            self._count += 1

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def percentile(self, q: float) -> float:
        with self._mu:
            xs = sorted(self._times)
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))]

    def summary(self) -> Dict[str, float]:
        with self._mu:
            xs = sorted(self._times)
            total, count = self._total, self._count

        def pct(q: float) -> float:
            if not xs:
                return 0.0
            return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))]

        return {
            "count": float(count),
            "total_s": total,
            "mean_s": total / max(1, count),
            "p50_s": pct(50),
            "p90_s": pct(90),
            "p99_s": pct(99),
        }


class ThroughputMeter:
    """Counts units (tokens, rows) against wall time since the first add."""

    def __init__(self):
        self._units = 0.0
        self._start: Optional[float] = None
        self._last: Optional[float] = None
        self._mu = threading.Lock()

    def add(self, units: float) -> None:
        now = time.perf_counter()
        with self._mu:
            if self._start is None:
                self._start = now
            self._last = now
            self._units += units

    def _rate_locked(self) -> float:
        if self._start is None or self._last is None or self._last <= self._start:
            return 0.0
        return self._units / (self._last - self._start)

    @property
    def total(self) -> float:
        with self._mu:
            return self._units

    def rate(self) -> float:
        with self._mu:
            return self._rate_locked()

    def summary(self) -> Dict[str, float]:
        with self._mu:
            return {"total": self._units, "per_sec": self._rate_locked()}


class Histogram:
    """Fixed-bucket distribution, cumulative over the process lifetime.

    Buckets are upper bounds; counts are stored per bucket and emitted
    cumulatively by :meth:`summary`, so summaries of several processes
    merge by summation."""

    # Log-spaced bounds from ~100 µs to minutes keep quantile error
    # within one bucket.
    DEFAULT_BUCKETS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
    )

    def __init__(self, buckets: Optional[List[float]] = None):
        bounds = tuple(sorted(buckets)) if buckets else self.DEFAULT_BUCKETS
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._mu:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def summary(self) -> Dict[str, object]:
        """``{"sum", "count", "buckets": {"<le>": cumulative, ...,
        "+Inf": count}}``."""
        with self._mu:
            counts = list(self._counts)
            total, n = self._sum, self._count
        buckets: Dict[str, float] = {}
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            buckets[repr(bound)] = float(running)
        buckets["+Inf"] = float(n)
        return {"sum": total, "count": float(n), "buckets": buckets}

    def quantile(self, q: float) -> Optional[float]:
        """Quantile to within one bucket (linear inside the containing
        bucket); ``None`` when nothing was observed."""
        return quantile_from_hist_summary(self.summary(), q)


def quantile_from_hist_summary(
    summary: Dict[str, object], q: float
) -> Optional[float]:
    """Quantile from a :meth:`Histogram.summary` dict (also a merged
    one). ``None`` on zero observations; values in the +Inf bucket
    report the largest finite bound."""
    try:
        count = float(summary.get("count", 0.0))  # type: ignore[union-attr]
        buckets = summary.get("buckets") or {}
    except AttributeError:
        return None
    if count <= 0 or not buckets:
        return None
    q = min(max(q, 0.0), 1.0)
    rank = q * count
    finite = sorted(
        (float(le), float(c)) for le, c in buckets.items() if le != "+Inf"
    )
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in finite:
        if cum >= rank:
            span = cum - prev_cum
            if span <= 0:
                return bound
            frac = (rank - prev_cum) / span
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return finite[-1][0] if finite else None


@dataclass
class MetricsRegistry:
    """Named counters, gauges, timers, meters and histograms; one
    process-wide instance at :data:`metrics`."""

    _lock: threading.Lock = field(default_factory=threading.Lock)
    _counters: Dict[str, float] = field(default_factory=dict)
    _timers: Dict[str, StepTimer] = field(default_factory=dict)
    _meters: Dict[str, ThroughputMeter] = field(default_factory=dict)
    _gauges: Dict[str, float] = field(default_factory=dict)
    _hists: Dict[str, Histogram] = field(default_factory=dict)

    def counter_add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_value(self, name: str) -> Optional[float]:
        """Last value set on a gauge (None when never set)."""
        with self._lock:
            return self._gauges.get(name)

    def gauge_max(self, name: str, value: float) -> None:
        """Watermark gauge: keeps the max ever observed."""
        with self._lock:
            prev = self._gauges.get(name)
            if prev is None or value > prev:
                self._gauges[name] = float(value)

    def timer(self, name: str) -> StepTimer:
        with self._lock:
            if name not in self._timers:
                self._timers[name] = StepTimer()
            return self._timers[name]

    def meter(self, name: str) -> ThroughputMeter:
        with self._lock:
            if name not in self._meters:
                self._meters[name] = ThroughputMeter()
            return self._meters[name]

    def histogram(
        self, name: str, buckets: Optional[List[float]] = None
    ) -> Histogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(buckets)
            return self._hists[name]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out: Dict[str, Dict[str, float]] = {
                "counters": dict(self._counters)
            }
            if self._gauges:
                out["gauges"] = dict(self._gauges)
            for name, t in self._timers.items():
                out[f"timer/{name}"] = t.summary()
            for name, m in self._meters.items():
                out[f"meter/{name}"] = m.summary()
            for name, h in self._hists.items():
                out[f"hist/{name}"] = h.summary()
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._meters.clear()
            self._gauges.clear()
            self._hists.clear()


metrics = MetricsRegistry()


def sample_resource_gauges(registry: Optional[MetricsRegistry] = None) -> None:
    """Refresh the resource gauges on ``registry`` (default: the process
    registry): host RSS current/peak, the CUDA memory this process holds
    (``hbm/used_bytes`` and ``hbm/peak_bytes``: the JAX package's names,
    here ``torch.cuda.memory_allocated``/``max_memory_allocated`` summed
    over the process's cards), and the shm object store's occupancy when
    a store is open in this process. Called from worker heartbeats, SPMD
    pings and driver snapshots: one procfs read and dict lookups.

    ``torch`` is looked up in ``sys.modules``, never imported, and the
    card is read only once CUDA is initialised, so a torch-free ETL
    worker stays torch-free and no process starts a CUDA context here."""
    reg = registry if registry is not None else metrics
    from raydp_tpu_torch.utils.memory import host_rss_bytes

    rss, peak = host_rss_bytes()
    if rss:
        reg.gauge_set("mem/rss_bytes", rss)
        reg.gauge_max("mem/rss_peak_bytes", peak)
    try:
        import sys

        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            used = hwm = 0
            for dev in range(torch.cuda.device_count()):
                used += int(torch.cuda.memory_allocated(dev))
                hwm += int(torch.cuda.max_memory_allocated(dev))
            reg.gauge_set("hbm/used_bytes", used)
            reg.gauge_max("hbm/peak_bytes", hwm)
    except Exception:
        pass  # no card or a partial torch: skip the device gauges
    try:
        from raydp_tpu_torch.store.object_store import get_current_store

        store = get_current_store()
        if store is not None:
            occ = store.occupancy_bytes()
            reg.gauge_set("store/occupancy_bytes", occ)
            reg.gauge_max("store/occupancy_peak_bytes", occ)
    except Exception:
        pass
