"""Metrics shipping: worker snapshots piggybacked on heartbeats.

The port's copy of ``raydp_tpu/telemetry/shipping.py``; it leaves nothing
of it to a later slice.

Every process already keeps a :class:`~raydp_tpu_torch.utils.profiling.
MetricsRegistry`; the problem is that worker-side registries die with
the worker and the master never sees them. The fix costs no new RPC:

* worker side — a :class:`MetricsShipper` wraps the registry and, on
  each heartbeat, returns a **delta**: only the snapshot sections
  (``counters``, ``timer/<name>``, ``meter/<name>``) whose values
  changed since the last ship. Registry values are cumulative, so a
  delta is a sparse overwrite, not an increment — merging is plain
  ``dict.update`` and a lost heartbeat self-heals on the next one.
* master side — a :class:`ClusterTelemetry` merges deltas into a
  per-worker view keyed by worker id. Worker death **tombstones** the
  view (final snapshot retained, ``tombstone: True``) instead of
  deleting it, so a straggler that died mid-run still shows up in the
  post-mortem aggregate.
"""
from __future__ import annotations

import copy
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["MetricsShipper", "ClusterTelemetry"]

# Keys in a worker view that are shipping bookkeeping, not registry
# sections — skipped by the aggregator.
_META_KEYS = ("tombstone", "updated_wall")


class MetricsShipper:
    """Delta-encodes a registry's snapshot stream for heartbeat payloads."""

    def __init__(self, registry=None):
        if registry is None:
            from raydp_tpu_torch.utils.profiling import metrics as registry
        self._registry = registry
        self._last: Dict[str, Any] = {}
        self._mu = threading.Lock()

    def delta(self) -> Dict[str, Any]:
        """Sections changed since the previous ``delta()``/``full()``
        call; ``{}`` when the registry is quiescent."""
        snap = self._registry.snapshot()
        with self._mu:
            changed = {
                k: v for k, v in snap.items() if self._last.get(k) != v
            }
            self._last = snap
        return changed

    def full(self) -> Dict[str, Any]:
        """The complete current snapshot (final ship on worker exit)."""
        snap = self._registry.snapshot()
        with self._mu:
            self._last = snap
        return snap

    def rollback(self, delta: Dict[str, Any]) -> None:
        """Un-ship a delta whose heartbeat failed in transport: mark its
        sections not-yet-shipped so the next ``delta()`` re-carries them.
        Without this a delta lost on a starved link only self-heals when
        the section changes AGAIN — a registry that went quiescent after
        the loss would never reach the master."""
        if not delta:
            return
        with self._mu:
            for key in delta:
                self._last.pop(key, None)


class ClusterTelemetry:
    """Master/driver-side merge of worker metric deltas + lifecycle events.

    The merged view survives worker death: :meth:`tombstone` marks the
    final snapshot instead of dropping it.
    """

    def __init__(self, max_events: int = 512):
        self._mu = threading.Lock()
        self._views: Dict[str, Dict[str, Any]] = {}
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=max_events)

    def apply(
        self, worker_id: str, delta: Optional[Dict[str, Any]],
        final: bool = False,
    ) -> None:
        """Merge one delta into ``worker_id``'s view. ``final=True``
        tombstones the view after merging (graceful-stop path: the last
        full snapshot arrives with the WorkerStopped RPC)."""
        if not delta and not final:
            return
        with self._mu:
            view = self._views.setdefault(worker_id, {})
            for key, value in (delta or {}).items():
                view[key] = value
            view["updated_wall"] = time.time()
            if final:
                view["tombstone"] = True

    def tombstone(self, worker_id: str) -> None:
        """Mark a worker dead, retaining whatever it last shipped."""
        with self._mu:
            view = self._views.setdefault(worker_id, {})
            view["tombstone"] = True
            view.setdefault("updated_wall", time.time())

    def event(self, name: str, **attrs: Any) -> None:
        """Record a lifecycle event (worker registered/dead/stopped)."""
        with self._mu:
            self._events.append(
                {"name": name, "wall_time": time.time(), **attrs}
            )

    def events(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [dict(e) for e in self._events]

    def merged(self) -> Dict[str, Any]:
        """``{"workers": {...}, "aggregate": {...}, "events": [...]}``.

        Aggregate semantics: counters and meter totals/rates sum across
        workers; timer counts and totals sum (mean recomputed), timer
        percentiles take the cross-worker **max** — the straggler view,
        which is what percentile aggregation is for here (exact merged
        percentiles would need the raw windows shipped).
        """
        with self._mu:
            workers = copy.deepcopy(self._views)
            events = [dict(e) for e in self._events]
        aggregate: Dict[str, Any] = {}
        for view in workers.values():
            for key, section in view.items():
                if key in _META_KEYS:
                    continue
                if key == "counters":
                    agg = aggregate.setdefault("counters", {})
                    for name, value in section.items():
                        agg[name] = agg.get(name, 0.0) + value
                elif key == "gauges":
                    # Resource gauges (RSS, HBM, store occupancy) sum
                    # across workers: the cluster-wide footprint.
                    agg = aggregate.setdefault("gauges", {})
                    for name, value in section.items():
                        agg[name] = agg.get(name, 0.0) + value
                elif key.startswith("timer/"):
                    agg = aggregate.setdefault(key, {})
                    for stat, value in section.items():
                        if stat in ("count", "total_s"):
                            agg[stat] = agg.get(stat, 0.0) + value
                        else:  # mean recomputed below; percentiles → max
                            agg[stat] = max(agg.get(stat, 0.0), value)
                elif key.startswith("meter/"):
                    agg = aggregate.setdefault(key, {})
                    for stat, value in section.items():
                        agg[stat] = agg.get(stat, 0.0) + value
                elif key.startswith("hist/"):
                    # Histogram buckets are cumulative counts — exact
                    # cross-worker merge is plain summation, bucket by
                    # bucket (same bounds on every worker by
                    # construction: one Histogram class).
                    agg = aggregate.setdefault(
                        key, {"sum": 0.0, "count": 0.0, "buckets": {}}
                    )
                    agg["sum"] += float(section.get("sum", 0.0))
                    agg["count"] += float(section.get("count", 0.0))
                    for bound, n in (section.get("buckets") or {}).items():
                        agg["buckets"][bound] = (
                            agg["buckets"].get(bound, 0.0) + float(n)
                        )
        for key, section in aggregate.items():
            if key.startswith("timer/"):
                section["mean_s"] = section.get("total_s", 0.0) / max(
                    1.0, section.get("count", 0.0)
                )
        return {"workers": workers, "aggregate": aggregate, "events": events}
