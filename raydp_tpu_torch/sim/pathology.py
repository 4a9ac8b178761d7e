"""Pathology detectors: emergent failure *shapes* in the timeline.

Invariants (:mod:`raydp_tpu_torch.sim.monitors`) are point-in-time safety
properties; pathologies are patterns that only exist across time — no
single snapshot is wrong, but the trajectory is. Each detector scans
the captured event timeline and the monitor's per-tick samples after
the run and returns :class:`Pathology` records:

* **autoscale_preempt_resonance** — an autoscale grow followed by a
  priority/pressure preemption within one up-cooldown window: the
  scaler and the arbiter are fighting, adding capacity with one hand
  and evicting work with the other.
* **shed_storm** — admission sheds clustered tighter than
  ``storm_count`` within ``storm_window_s``: the queue is not
  smoothing a burst, it is amplifying one (clients all retry at
  once).
* **priority_inversion** — a high-priority waiter aging behind
  lower-priority leases across consecutive samples with no preemption
  in the span: the preemption machinery should have fired and did
  not.
* **fragmentation** — free capacity ≥ the smallest waiter's ask for a
  sustained run of samples while the queue is non-empty: the strict
  head-of-line grant loop is blocking small jobs behind a large head
  (bin-packing fragmentation).

``report_pathologies`` turns the records into ``sim/pathology``
events and ``sim/pathologies/<kind>`` counters so the CLI report and
the dashboard's offline mode render them next to the run's metrics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.utils.profiling import metrics as _metrics

__all__ = ["Pathology", "PathologyKnobs", "scan_timeline",
           "report_pathologies"]


@dataclass
class Pathology:
    """One detected failure shape over ``[start_t, end_t]``."""

    kind: str
    start_t: float
    end_t: float
    count: int
    detail: str

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "start_t": round(self.start_t, 3),
            "end_t": round(self.end_t, 3),
            "count": self.count,
            "detail": self.detail,
        }


@dataclass
class PathologyKnobs:
    """Detector thresholds; the scenario wires these from its config
    (``RAYDP_TPU_SIM_*`` env family, doc/configuration.md)."""

    resonance_window_s: float = 5.0
    storm_count: int = 50
    storm_window_s: float = 1.0
    inversion_wait_s: float = 5.0
    inversion_run: int = 3
    frag_run: int = 5


def scan_timeline(
    timeline: List[Tuple[float, str, Dict[str, Any]]],
    samples: List[Dict[str, Any]],
    knobs: Optional[PathologyKnobs] = None,
) -> List[Pathology]:
    """Run every detector over one simulation's captured history.

    ``timeline`` is the tapped event stream as ``(t, kind, attrs)``
    tuples in virtual-time order; ``samples`` is the invariant
    monitor's per-tick state. Pure — emission is
    :func:`report_pathologies`."""
    knobs = knobs or PathologyKnobs()
    found: List[Pathology] = []
    found.extend(_detect_resonance(timeline, knobs))
    found.extend(_detect_shed_storm(timeline, samples, knobs))
    found.extend(_detect_priority_inversion(timeline, samples, knobs))
    found.extend(_detect_fragmentation(samples, knobs))
    found.sort(key=lambda p: p.start_t)
    return found


def report_pathologies(pathologies: List[Pathology]) -> None:
    for p in pathologies:
        _metrics.counter_add(f"sim/pathologies/{p.kind}")
        # "pathology", not "kind": the latter is emit()'s event-kind
        # positional and cannot double as an attr.
        _events.emit(
            "sim/pathology", pathology=p.kind,
            start_t=round(p.start_t, 3), end_t=round(p.end_t, 3),
            count=p.count, what=p.detail,
        )


# -- detectors -----------------------------------------------------------


def _detect_resonance(
    timeline: List[Tuple[float, str, Dict[str, Any]]],
    knobs: PathologyKnobs,
) -> List[Pathology]:
    grows = [t for t, kind, _ in timeline if kind == "autoscale/grow"]
    preempts = [
        (t, attrs) for t, kind, attrs in timeline
        if kind == "sched/preempt"
        and attrs.get("reason") in ("priority", "pressure")
    ]
    found: List[Pathology] = []
    gi = 0
    for pt, attrs in preempts:
        # Most recent grow at or before this preemption.
        while gi + 1 < len(grows) and grows[gi + 1] <= pt:
            gi += 1
        if not grows or grows[gi] > pt:
            continue
        gap = pt - grows[gi]
        if gap <= knobs.resonance_window_s:
            found.append(Pathology(
                kind="autoscale_preempt_resonance",
                start_t=grows[gi],
                end_t=pt,
                count=1,
                detail=(
                    f"grow at t={grows[gi]:.2f} then "
                    f"{attrs.get('reason')} preemption of job "
                    f"{attrs.get('victim')} {gap:.2f}s later — scaler and "
                    "arbiter are working against each other inside one "
                    "cooldown window"
                ),
            ))
    return _coalesce(found, "autoscale_preempt_resonance")


def _detect_shed_storm(
    timeline: List[Tuple[float, str, Dict[str, Any]]],
    samples: List[Dict[str, Any]],
    knobs: PathologyKnobs,
) -> List[Pathology]:
    # Shed instants: explicit shed events, plus per-sample rejected
    # deltas attributed to the tick timestamp (serve-side sheds emit no
    # per-request event at scale — the counter delta is the record).
    instants: List[Tuple[float, int]] = []
    for t, kind, _ in timeline:
        if kind == "sched/shed":
            instants.append((t, 1))
    for s in samples:
        n = int(s.get("rejected_delta", 0) or 0)
        if n > 0:
            instants.append((s["t"], n))
    instants.sort()
    found: List[Pathology] = []
    lo = 0
    window_total = 0
    for hi, (t, n) in enumerate(instants):
        window_total += n
        while instants[lo][0] < t - knobs.storm_window_s:
            window_total -= instants[lo][1]
            lo += 1
        if window_total >= knobs.storm_count:
            found.append(Pathology(
                kind="shed_storm",
                start_t=instants[lo][0],
                end_t=t,
                count=window_total,
                detail=(
                    f"{window_total} sheds within "
                    f"{knobs.storm_window_s}s (threshold "
                    f"{knobs.storm_count}) — the queue is amplifying "
                    "the burst, not absorbing it"
                ),
            ))
    return _coalesce(found, "shed_storm")


def _detect_priority_inversion(
    timeline: List[Tuple[float, str, Dict[str, Any]]],
    samples: List[Dict[str, Any]],
    knobs: PathologyKnobs,
) -> List[Pathology]:
    preempt_ts = [t for t, kind, _ in timeline if kind == "sched/preempt"]
    found: List[Pathology] = []
    run: List[Dict[str, Any]] = []

    def flush() -> None:
        if len(run) >= knobs.inversion_run:
            start, end = run[0]["t"], run[-1]["t"]
            if not any(start <= pt <= end for pt in preempt_ts):
                found.append(Pathology(
                    kind="priority_inversion",
                    start_t=start,
                    end_t=end,
                    count=len(run),
                    detail=(
                        f"priority {run[-1]['max_waiter_priority']} "
                        "waiter aged "
                        f"{run[-1].get('wait_oldest_s', 0.0):.1f}s behind "
                        f"priority {run[-1]['min_lease_priority']} "
                        f"lease(s) across {len(run)} samples with no "
                        "preemption — the eviction path never fired"
                    ),
                ))
        run.clear()

    for s in samples:
        wp = s.get("max_waiter_priority")
        lp = s.get("min_lease_priority")
        inverted = (
            wp is not None and lp is not None and wp > lp
            and float(s.get("wait_oldest_s", 0.0)) >= knobs.inversion_wait_s
        )
        if inverted:
            run.append(s)
        else:
            flush()
    flush()
    return _coalesce(found, "priority_inversion")


def _detect_fragmentation(
    samples: List[Dict[str, Any]],
    knobs: PathologyKnobs,
) -> List[Pathology]:
    found: List[Pathology] = []
    run: List[Dict[str, Any]] = []

    def flush() -> None:
        if len(run) >= knobs.frag_run:
            last = run[-1]
            free = int(last.get("capacity", 0)) - int(last.get("in_use", 0))
            found.append(Pathology(
                kind="fragmentation",
                start_t=run[0]["t"],
                end_t=last["t"],
                count=len(run),
                detail=(
                    f"{free} free slots sat idle for {len(run)} samples "
                    f"while a waiter asking {last.get('min_waiter_slots')} "
                    "queued — head-of-line blocking behind a larger ask"
                ),
            ))
        run.clear()

    for s in samples:
        cap = int(s.get("capacity", 0) or 0)
        if cap <= 0:
            flush()
            continue
        free = cap - int(s.get("in_use", 0) or 0)
        smallest = int(s.get("min_waiter_slots", 0) or 0)
        fragmented = (
            int(s.get("queue_depth", 0) or 0) > 0
            and smallest > 0
            and free >= smallest
        )
        if fragmented:
            run.append(s)
        else:
            flush()
    flush()
    return _coalesce(found, "fragmentation")


def _coalesce(found: List[Pathology], kind: str) -> List[Pathology]:
    """Merge overlapping/adjacent windows of one kind into episodes —
    a 30 s storm is one pathology, not three hundred."""
    if not found:
        return found
    found.sort(key=lambda p: (p.start_t, p.end_t))
    merged = [found[0]]
    for p in found[1:]:
        last = merged[-1]
        if p.start_t <= last.end_t:
            merged[-1] = Pathology(
                kind=kind,
                start_t=last.start_t,
                end_t=max(last.end_t, p.end_t),
                count=max(last.count, p.count)
                if kind == "shed_storm" else last.count + p.count,
                detail=last.detail,
            )
        else:
            merged.append(p)
    return merged
