"""Process-wide counters, gauges and throughput meters.

The part of the JAX package's ``utils/profiling.py`` registry that the
decode loop reports to: ``counter_add``, ``gauge_set``, ``meter`` and
``snapshot``/``reset``. Timers, histograms and the device trace hooks
arrive with the slices that read them.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["MetricsRegistry", "ThroughputMeter", "metrics"]


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

    def summary(self) -> Dict[str, float]:
        with self._mu:
            return {"total": self._units, "per_sec": self._rate_locked()}


@dataclass
class MetricsRegistry:
    """Named counters, gauges and meters; one process-wide instance at
    :data:`metrics`."""

    _lock: threading.Lock = field(default_factory=threading.Lock)
    _counters: Dict[str, float] = field(default_factory=dict)
    _meters: Dict[str, ThroughputMeter] = field(default_factory=dict)
    _gauges: Dict[str, float] = field(default_factory=dict)

    def counter_add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def meter(self, name: str) -> ThroughputMeter:
        with self._lock:
            if name not in self._meters:
                self._meters[name] = ThroughputMeter()
            return self._meters[name]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out: Dict[str, Dict[str, float]] = {
                "counters": dict(self._counters)
            }
            if self._gauges:
                out["gauges"] = dict(self._gauges)
            for name, m in self._meters.items():
                out[f"meter/{name}"] = m.summary()
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._meters.clear()
            self._gauges.clear()


metrics = MetricsRegistry()
