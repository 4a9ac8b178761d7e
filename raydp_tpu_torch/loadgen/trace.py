"""JSONL arrival-trace format and the live-queue recorder.

A trace file is one JSON object per line: a header
``{"raydp_trace": 1, "events": N, ...meta}`` followed by
``{"t": <relative offset s>, "bucket": <padding bucket>,
"size": <payload size>}`` records. Floats round-trip bit-identically
(``json`` serialises via ``repr``, the shortest exact representation),
so ``read_trace(write_trace(events)) == events`` — a recorded
production trace replays the exact arrival process.

:class:`TraceRecorder` taps a live
:class:`~raydp_tpu_torch.serve.batching.RequestQueue` through its arrival
observer hook and captures every admitted request's offset, bucket,
and size. Record in production, replay in the load observatory. The port's
copy of ``raydp_tpu/loadgen/trace.py``; its clock is the queue's seam.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.loadgen.schedules import TraceEvent
from raydp_tpu_torch.utils import clock as _clock

TRACE_VERSION = 1


def write_trace(path: str, events: List[TraceEvent],
                meta: Optional[Dict[str, Any]] = None) -> int:
    """Serialise ``events`` to JSONL at ``path``; returns the count."""
    with open(path, "w", encoding="utf-8") as fh:
        header = {"raydp_trace": TRACE_VERSION, "events": len(events)}
        if meta:
            header.update(meta)
        fh.write(json.dumps(header, sort_keys=True) + "\n")
        for ev in events:
            fh.write(json.dumps(
                {"t": ev.t, "bucket": ev.bucket, "size": ev.size}
            ) + "\n")
    return len(events)


def read_trace(path: str) -> List[TraceEvent]:
    """Parse a JSONL trace; tolerates a missing header (plain event
    lines) so hand-written traces work too."""
    events: List[TraceEvent] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "raydp_trace" in rec:
                if rec["raydp_trace"] > TRACE_VERSION:
                    raise ValueError(
                        f"trace version {rec['raydp_trace']} is newer "
                        f"than supported {TRACE_VERSION}"
                    )
                continue
            events.append(TraceEvent(
                t=float(rec["t"]),
                bucket=int(rec["bucket"]),
                size=int(rec["size"]),
            ))
    events.sort(key=lambda e: e.t)
    return events


class TraceRecorder:
    """Capture a live queue's real arrivals for later replay.

    ``start()`` registers an arrival observer on the queue and zeroes
    the clock; every admitted request becomes a :class:`TraceEvent`
    with its offset from ``start()``. ``stop()`` detaches; ``save()``
    writes the JSONL trace. The observer is called outside the queue
    lock and appends under a plain list (GIL-atomic), so recording
    adds no contention to the admission path.
    """

    def __init__(self, queue: Any):
        self.queue = queue
        self._events: List[TraceEvent] = []
        self._t0: Optional[float] = None
        self._recording = False

    def start(self) -> "TraceRecorder":
        if self._recording:
            return self
        self._events = []
        self._t0 = _clock.monotonic()
        self._recording = True
        self.queue.add_arrival_observer(self._on_arrival)
        return self

    def _on_arrival(self, req: Any, now: float) -> None:
        if not self._recording or self._t0 is None:
            return
        length = getattr(req, "length", 1)
        self._events.append(TraceEvent(
            t=max(0.0, now - self._t0),
            bucket=self.queue.bucket_for(length),
            size=length,
        ))

    def stop(self) -> List[TraceEvent]:
        if self._recording:
            self._recording = False
            self.queue.remove_arrival_observer(self._on_arrival)
        return list(self._events)

    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def save(self, path: str,
             meta: Optional[Dict[str, Any]] = None) -> int:
        return write_trace(path, self.events(), meta=meta)
