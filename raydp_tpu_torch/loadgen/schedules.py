"""Arrival-schedule generators for the load observatory.

Every generator returns a list of :class:`TraceEvent` — relative
arrival offset (seconds from replay start), padding bucket, and
payload size — the same triple the JSONL trace format serialises, so
a synthetic schedule and a recorded production trace are
interchangeable inputs to the open-loop runner.

All generators are seeded (``random.Random(seed)``) and deterministic:
the same arguments produce the same schedule, which is what makes a
knee-finder step or a bench trajectory comparable across runs.
Inter-arrival distributions:

- ``poisson`` — exponential inter-arrivals; the memoryless baseline.
- ``heavy_tail`` — Pareto or lognormal inter-arrivals with the *same
  mean* as the Poisson schedule but a bursty tail (squared
  coefficient of variation well above 1), the arrival pattern that
  actually breaks batching lingers and queue bounds.
- ``diurnal`` — a sinusoidal day compressed into ``duration_s``
  (thinning against the peak rate), for exercising autoscalers.
- ``flash_crowd`` — baseline Poisson with a ``burst_mult``× window
  dropped in the middle, the retry-storm / front-page shape.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Sequence

from raydp_tpu_torch.serve.batching import env_buckets

#: Ceiling on generated events per schedule, a runaway guard for
#: pathological rate × duration combinations.
MAX_EVENTS = 2_000_000

#: Default payload sizes when the caller does not pass ``sizes`` —
#: one below each default serve padding bucket so a schedule sweeps
#: the bucket space.
DEFAULT_SIZES = (8, 24, 96)


@dataclass(frozen=True)
class TraceEvent:
    """One scheduled arrival: offset from replay start (seconds),
    padding bucket the payload lands in, and payload size."""

    t: float
    bucket: int
    size: int


def bucket_for(size: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest configured bucket that fits ``size`` (the last bucket
    absorbs oversize payloads, mirroring RequestQueue.bucket_for)."""
    bounds = tuple(sorted(buckets)) if buckets else env_buckets()
    for b in bounds:
        if size <= b:
            return b
    return bounds[-1]


def _sizes(rng: random.Random,
           sizes: Optional[Sequence[int]]) -> Sequence[int]:
    return tuple(sizes) if sizes else DEFAULT_SIZES


def _event(rng: random.Random, t: float, sizes: Sequence[int],
           buckets: Optional[Sequence[int]]) -> TraceEvent:
    size = rng.choice(sizes)
    return TraceEvent(t=t, bucket=bucket_for(size, buckets), size=size)


def _from_interarrivals(next_gap, rps: float, duration_s: float,
                        rng: random.Random,
                        sizes: Optional[Sequence[int]],
                        buckets: Optional[Sequence[int]]) -> List[TraceEvent]:
    if rps <= 0 or duration_s <= 0:
        return []
    chosen = _sizes(rng, sizes)
    events: List[TraceEvent] = []
    t = next_gap()
    while t < duration_s and len(events) < MAX_EVENTS:
        events.append(_event(rng, t, chosen, buckets))
        t += next_gap()
    return events


def poisson_schedule(rps: float, duration_s: float, *, seed: int = 0,
                     sizes: Optional[Sequence[int]] = None,
                     buckets: Optional[Sequence[int]] = None
                     ) -> List[TraceEvent]:
    """Memoryless arrivals at mean ``rps``."""
    rng = random.Random(seed)
    return _from_interarrivals(
        lambda: rng.expovariate(rps), rps, duration_s, rng, sizes, buckets
    )


def heavy_tail_schedule(rps: float, duration_s: float, *, seed: int = 0,
                        dist: str = "pareto", shape: float = 1.5,
                        sizes: Optional[Sequence[int]] = None,
                        buckets: Optional[Sequence[int]] = None
                        ) -> List[TraceEvent]:
    """Bursty arrivals: Pareto or lognormal inter-arrival times with
    mean ``1/rps``.

    ``dist="pareto"``: shape is the Pareto alpha (clamped > 1.05 so
    the mean exists; alpha in (1, 2] has infinite variance — maximal
    burstiness). ``dist="lognormal"``: shape is sigma.

    Infinite-variance gaps mean the *sample* mean rate would wander
    arbitrarily far from ``rps`` on any finite run, so the gap stream
    is rescaled onto ``duration_s`` after drawing: burstiness (the
    gaps' coefficient of variation) is scale-invariant and survives
    untouched, while the realized mean rate is pinned to ``rps``.
    """
    rng = random.Random(seed)
    if rps <= 0 or duration_s <= 0:
        return []
    if dist == "lognormal":
        sigma = max(0.1, float(shape))
        mu = -sigma * sigma / 2.0  # unit-mean before rescaling
        next_gap = lambda: rng.lognormvariate(mu, sigma)  # noqa: E731
    elif dist == "pareto":
        alpha = max(1.05, float(shape))
        xm = (alpha - 1.0) / alpha
        next_gap = lambda: xm * rng.paretovariate(alpha)  # noqa: E731
    else:
        raise ValueError(f"unknown heavy-tail dist {dist!r}")
    n = min(MAX_EVENTS, max(1, round(rps * duration_s)))
    offsets: List[float] = []
    t = 0.0
    for _ in range(n):
        t += next_gap()
        offsets.append(t)
    # Rescale so n arrivals span duration_s with the last one strictly
    # inside the window: realized rate == rps up to rounding.
    scale = duration_s * n / ((n + 1) * offsets[-1])
    chosen = _sizes(rng, sizes)
    return [
        _event(rng, off * scale, chosen, buckets) for off in offsets
    ]


def diurnal_schedule(rps: float, duration_s: float, *, seed: int = 0,
                     cycles: float = 1.0, amplitude: float = 0.8,
                     sizes: Optional[Sequence[int]] = None,
                     buckets: Optional[Sequence[int]] = None
                     ) -> List[TraceEvent]:
    """A compressed day: instantaneous rate
    ``rps × (1 + amplitude·sin(2π·cycles·t/duration))``, generated by
    thinning a peak-rate Poisson stream. Whole cycles integrate the
    sine away, so the mean rate stays ``rps``."""
    rng = random.Random(seed)
    amplitude = min(0.99, max(0.0, amplitude))
    peak = rps * (1.0 + amplitude)
    if peak <= 0 or duration_s <= 0:
        return []
    chosen = _sizes(rng, sizes)
    events: List[TraceEvent] = []
    t = rng.expovariate(peak)
    while t < duration_s and len(events) < MAX_EVENTS:
        rate = rps * (1.0 + amplitude * math.sin(
            2.0 * math.pi * cycles * t / duration_s
        ))
        if rng.random() < rate / peak:
            events.append(_event(rng, t, chosen, buckets))
        t += rng.expovariate(peak)
    return events


def flash_crowd_schedule(rps: float, duration_s: float, *, seed: int = 0,
                         burst_mult: float = 5.0,
                         burst_start_frac: float = 0.4,
                         burst_duration_frac: float = 0.2,
                         sizes: Optional[Sequence[int]] = None,
                         buckets: Optional[Sequence[int]] = None
                         ) -> List[TraceEvent]:
    """Baseline Poisson at ``rps`` with a ``burst_mult``× window
    starting at ``burst_start_frac`` of the run — the front-page /
    retry-storm arrival shape. The mean rate is above ``rps`` by
    construction; the burst is the point."""
    rng = random.Random(seed)
    if rps <= 0 or duration_s <= 0:
        return []
    burst_lo = duration_s * min(max(burst_start_frac, 0.0), 1.0)
    burst_hi = min(
        duration_s,
        burst_lo + duration_s * max(0.0, burst_duration_frac),
    )
    peak = rps * max(1.0, burst_mult)
    chosen = _sizes(rng, sizes)
    events: List[TraceEvent] = []
    t = rng.expovariate(peak)
    while t < duration_s and len(events) < MAX_EVENTS:
        rate = peak if burst_lo <= t < burst_hi else rps
        if rng.random() < rate / peak:
            events.append(_event(rng, t, chosen, buckets))
        t += rng.expovariate(peak)
    return events
