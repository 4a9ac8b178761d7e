"""Open-loop load runner: a timer wheel that never closes the loop.

The cardinal rule of capacity measurement (and the reason closed-loop
benchmarks lie): a slow backend must not slow the *offered* load.
The runner walks the schedule on one wheel thread, fires each request
at its scheduled offset (catching up immediately when behind — late
firing is recorded, never skipped), and hands the blocking wait to a
per-request thread. Backend latency therefore shapes only the
*in-flight* population, exactly like real traffic. A hard in-flight
cap (``RAYDP_TPU_LOADGEN_MAX_INFLIGHT``) bounds thread count; when it
is hit the arrival is recorded as ``overload`` — still charged to
offered load, still never throttled.

Targets adapt the firing surface:

- :class:`GroupTarget` — in-process ``submit()/wait()`` against a
  :class:`~raydp_tpu_torch.serve.group.ReplicaGroup` (or any stub with the
  same shape).
- :class:`QueueTarget` — a bare
  :class:`~raydp_tpu_torch.serve.batching.RequestQueue` (tests drain it with
  a fake dispatcher).
- :class:`HttpTarget` — POST ``/predict`` against a live
  :class:`~raydp_tpu_torch.serve.frontend.ServeFrontend`.

The port's copy of ``raydp_tpu/loadgen/runner.py``; the wheel reads
and sleeps through :mod:`raydp_tpu_torch.utils.clock`.

Outcome statuses: ``ok``, ``shed`` (429 / QueueFullError), ``timeout``
(504 / RequestCancelled), ``error`` (anything else), ``overload``
(in-flight cap). Each outcome carries wall latency, queue wait, the
phase decomposition when the backend reported one, and deadline slack.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from raydp_tpu_torch.loadgen.schedules import TraceEvent
from raydp_tpu_torch.serve.batching import (
    QueueFullError,
    RequestCancelled,
    ServeRequest,
)
from raydp_tpu_torch.utils import clock as _clock
from raydp_tpu_torch.utils.profiling import metrics

LOADGEN_MAX_INFLIGHT_ENV = "RAYDP_TPU_LOADGEN_MAX_INFLIGHT"
LOADGEN_TIMEOUT_ENV = "RAYDP_TPU_LOADGEN_TIMEOUT_S"

_DEFAULT_MAX_INFLIGHT = 4096
_DEFAULT_TIMEOUT_S = 5.0

#: Terminal statuses an outcome can land in.
STATUSES = ("ok", "shed", "timeout", "error", "overload")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    return int(_env_float(name, float(default)))


@dataclass
class RequestOutcome:
    """One fired request's terminal record."""

    index: int
    scheduled_t: float
    fired_t: float
    status: str
    latency_s: float
    size: int
    bucket: int
    wait_s: Optional[float] = None
    deadline_slack_s: Optional[float] = None
    phases: Optional[Dict[str, float]] = None
    request_id: Optional[str] = None
    # Token-level fields (decode workloads; None for plain predict):
    ttft_s: Optional[float] = None
    tokens: Optional[int] = None
    tokens_requested: Optional[int] = None

    @property
    def tpot_s(self) -> Optional[float]:
        """Per-output-token latency after the first token."""
        if self.ttft_s is None or not self.tokens or self.tokens < 2:
            return None
        return max(0.0, self.latency_s - self.ttft_s) / (self.tokens - 1)

    def to_record(self) -> Dict[str, Any]:
        return {
            "kind": "request",
            "index": self.index,
            "scheduled_t": round(self.scheduled_t, 6),
            "fired_t": round(self.fired_t, 6),
            "status": self.status,
            "latency_s": round(self.latency_s, 6),
            "size": self.size,
            "bucket": self.bucket,
            "wait_s": (round(self.wait_s, 6)
                       if self.wait_s is not None else None),
            "deadline_slack_s": (
                round(self.deadline_slack_s, 6)
                if self.deadline_slack_s is not None else None
            ),
            "phases": self.phases,
            "request_id": self.request_id,
            "ttft_s": (round(self.ttft_s, 6)
                       if self.ttft_s is not None else None),
            "tokens": self.tokens,
            "tokens_requested": self.tokens_requested,
        }


# -- targets ------------------------------------------------------------


class GroupTarget:
    """Fire into anything with ``submit(payload, timeout_s=...,
    request_id=...) -> waitable`` — normally a ReplicaGroup.

    With ``decode=True`` the target fires ``submit_generate`` instead
    (decode-mode groups): the event size becomes the prompt length,
    ``max_new`` the requested output tokens, and the fire dict carries
    the token-level fields (``ttft_s``, ``tokens``,
    ``tokens_requested``) the open-loop wheel threads into each
    :class:`RequestOutcome`."""

    def __init__(self, group: Any, *, decode: bool = False,
                 max_new: int = 32, eos: Optional[int] = None):
        self.group = group
        self.decode = decode
        self.max_new = max_new
        self.eos = eos

    def fire(self, event: TraceEvent, timeout_s: float) -> Dict[str, Any]:
        try:
            if self.decode:
                req = self.group.submit_generate(
                    [(i % 251) + 1 for i in range(max(1, event.size))],
                    max_new=self.max_new, eos=self.eos,
                    timeout_s=timeout_s,
                )
            else:
                req = self.group.submit(
                    [1.0] * max(1, event.size), timeout_s=timeout_s
                )
        except QueueFullError:
            return {"status": "shed"}
        except Exception as exc:
            return {"status": "error", "error": str(exc)}
        tokens_requested = self.max_new if self.decode else None
        try:
            result = req.wait()
        except RequestCancelled:
            return {"status": "timeout",
                    "request_id": getattr(req, "request_id", None),
                    "tokens_requested": tokens_requested}
        except Exception as exc:
            return {"status": "error", "error": str(exc),
                    "request_id": getattr(req, "request_id", None),
                    "tokens_requested": tokens_requested}
        out = {
            "status": "ok",
            "request_id": getattr(req, "request_id", None),
            "phases": getattr(req, "phases", None),
        }
        if self.decode:
            ttft = getattr(req, "ttft_s", lambda: None)()
            out["ttft_s"] = ttft
            out["tokens"] = (result or {}).get("n")
            out["tokens_requested"] = tokens_requested
        return out


class QueueTarget:
    """Fire bare :class:`ServeRequest` objects into a RequestQueue
    (something else must drain and complete them)."""

    def __init__(self, queue: Any):
        self.queue = queue

    def fire(self, event: TraceEvent, timeout_s: float) -> Dict[str, Any]:
        req = ServeRequest([1.0] * max(1, event.size), timeout_s=timeout_s)
        try:
            self.queue.submit(req)
        except QueueFullError:
            return {"status": "shed"}
        try:
            req.wait()
        except RequestCancelled:
            return {"status": "timeout", "request_id": req.request_id}
        except Exception as exc:
            return {"status": "error", "error": str(exc),
                    "request_id": req.request_id}
        return {"status": "ok", "request_id": req.request_id,
                "phases": req.phases}


class HttpTarget:
    """POST ``/predict`` on a live frontend; 429 → shed, 504 →
    timeout, other non-200 → error."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def fire(self, event: TraceEvent, timeout_s: float) -> Dict[str, Any]:
        import urllib.error
        import urllib.request

        body = json.dumps({
            "inputs": [1.0] * max(1, event.size),
            "timeout_s": timeout_s,
        }).encode("utf-8")
        req = urllib.request.Request(
            f"{self.base_url}/predict", data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(
                req, timeout=timeout_s + 2.0
            ) as resp:
                payload = json.loads(resp.read().decode("utf-8"))
                return {
                    "status": "ok",
                    "request_id": resp.headers.get("X-RayDP-Request-Id"),
                    "phases": payload.get("phases"),
                }
        except urllib.error.HTTPError as exc:
            status = {429: "shed", 504: "timeout"}.get(exc.code, "error")
            return {
                "status": status,
                "request_id": exc.headers.get("X-RayDP-Request-Id")
                if exc.headers else None,
            }
        except Exception as exc:
            return {"status": "error", "error": str(exc)}


# -- results ------------------------------------------------------------


@dataclass
class LoadResult:
    """One schedule's worth of outcomes plus offered/achieved rates."""

    offered_rps: float
    duration_s: float
    outcomes: List[RequestOutcome] = field(default_factory=list)

    @property
    def achieved_rps(self) -> float:
        ok = sum(1 for o in self.outcomes if o.status == "ok")
        return ok / self.duration_s if self.duration_s > 0 else 0.0

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATUSES}
        for o in self.outcomes:
            out[o.status] = out.get(o.status, 0) + 1
        return out

    def rate(self, status: str) -> float:
        n = len(self.outcomes)
        if not n:
            return 0.0
        return sum(1 for o in self.outcomes if o.status == status) / n

    def latency_quantile(self, q: float,
                         status: str = "ok") -> Optional[float]:
        lats = sorted(
            o.latency_s for o in self.outcomes if o.status == status
        )
        if not lats:
            return None
        idx = min(len(lats) - 1, int(q * len(lats)))
        return lats[idx]

    def ttft_quantile(self, q: float) -> Optional[float]:
        """Time-to-first-token quantile over ok decode outcomes."""
        vals = sorted(
            o.ttft_s for o in self.outcomes
            if o.status == "ok" and o.ttft_s is not None
        )
        if not vals:
            return None
        idx = min(len(vals) - 1, int(q * len(vals)))
        return vals[idx]

    def tpot_quantile(self, q: float) -> Optional[float]:
        """Per-output-token latency quantile over ok decode outcomes."""
        vals = sorted(
            o.tpot_s for o in self.outcomes
            if o.status == "ok" and o.tpot_s is not None
        )
        if not vals:
            return None
        idx = min(len(vals) - 1, int(q * len(vals)))
        return vals[idx]

    @property
    def achieved_tokens_per_sec(self) -> float:
        """Output tokens actually produced per second of schedule."""
        total = sum(
            o.tokens or 0 for o in self.outcomes if o.status == "ok"
        )
        return total / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def offered_tokens_per_sec(self) -> float:
        """Output tokens the schedule *asked* for per second — the
        decode analogue of offered_rps; achieved/offered below 1.0 is
        the knee signature for token workloads."""
        total = sum(o.tokens_requested or 0 for o in self.outcomes)
        return total / self.duration_s if self.duration_s > 0 else 0.0

    def phase_fractions(self) -> Dict[str, float]:
        """Mean fraction of end-to-end wall spent in each phase,
        over requests that carried a decomposition."""
        totals: Dict[str, float] = {}
        wall = 0.0
        for o in self.outcomes:
            if not o.phases:
                continue
            total = o.phases.get("total") or o.latency_s
            if total <= 0:
                continue
            wall += total
            for name, value in o.phases.items():
                if name == "total":
                    continue
                totals[name] = totals.get(name, 0.0) + float(value)
        if wall <= 0:
            return {}
        return {k: v / wall for k, v in sorted(totals.items())}

    def summary(self) -> Dict[str, Any]:
        counts = self.counts()
        out = {
            "offered_rps": round(self.offered_rps, 3),
            "achieved_rps": round(self.achieved_rps, 3),
            "duration_s": round(self.duration_s, 3),
            "requests": len(self.outcomes),
            "counts": counts,
            "shed_rate": round(self.rate("shed"), 4),
            "error_rate": round(
                self.rate("error") + self.rate("overload"), 4
            ),
            "p50_s": self.latency_quantile(0.5),
            "p99_s": self.latency_quantile(0.99),
            "phase_fractions": {
                k: round(v, 4)
                for k, v in self.phase_fractions().items()
            },
        }
        if any(o.tokens is not None or o.tokens_requested is not None
               for o in self.outcomes):
            ttft_p50 = self.ttft_quantile(0.5)
            ttft_p99 = self.ttft_quantile(0.99)
            tpot_p50 = self.tpot_quantile(0.5)
            tpot_p99 = self.tpot_quantile(0.99)
            out["tokens"] = {
                "offered_tokens_per_sec": round(
                    self.offered_tokens_per_sec, 3
                ),
                "achieved_tokens_per_sec": round(
                    self.achieved_tokens_per_sec, 3
                ),
                "ttft_p50_s": (round(ttft_p50, 6)
                               if ttft_p50 is not None else None),
                "ttft_p99_s": (round(ttft_p99, 6)
                               if ttft_p99 is not None else None),
                "tpot_p50_s": (round(tpot_p50, 6)
                               if tpot_p50 is not None else None),
                "tpot_p99_s": (round(tpot_p99, 6)
                               if tpot_p99 is not None else None),
            }
        return out


# -- the open-loop wheel ------------------------------------------------


def run_schedule(target: Any, events: Sequence[TraceEvent], *,
                 timeout_s: Optional[float] = None,
                 max_inflight: Optional[int] = None) -> LoadResult:
    """Replay ``events`` against ``target`` open-loop.

    The wheel thread (this thread) sleeps until each arrival's offset
    and fires it into a daemon thread; a backend that stalls inflates
    in-flight count and latency, never the firing schedule. Blocks
    until every fired request reaches a terminal status (bounded by
    the per-request timeout), then publishes ``loadgen/*`` counters
    and offered/achieved gauges.
    """
    if timeout_s is None:
        timeout_s = _env_float(LOADGEN_TIMEOUT_ENV, _DEFAULT_TIMEOUT_S)
    if max_inflight is None:
        max_inflight = _env_int(
            LOADGEN_MAX_INFLIGHT_ENV, _DEFAULT_MAX_INFLIGHT
        )
    ordered = sorted(events, key=lambda e: e.t)
    duration = ordered[-1].t if ordered else 0.0
    result = LoadResult(
        offered_rps=(len(ordered) / duration if duration > 0
                     else float(len(ordered))),
        duration_s=max(duration, 1e-9),
    )
    outcomes: List[Optional[RequestOutcome]] = [None] * len(ordered)
    inflight = threading.Semaphore(max_inflight)
    done: List[threading.Thread] = []

    def _fire(idx: int, ev: TraceEvent, fired_t: float) -> None:
        t_fire = _clock.monotonic()
        try:
            raw = target.fire(ev, timeout_s)
        except Exception as exc:
            raw = {"status": "error", "error": str(exc)}
        finally:
            inflight.release()
        latency = _clock.monotonic() - t_fire
        phases = raw.get("phases") or None
        wait_s = phases.get("queue_wait") if phases else None
        outcomes[idx] = RequestOutcome(
            index=idx,
            scheduled_t=ev.t,
            fired_t=fired_t,
            status=raw.get("status", "error"),
            latency_s=latency,
            size=ev.size,
            bucket=ev.bucket,
            wait_s=wait_s,
            deadline_slack_s=timeout_s - latency,
            phases=phases,
            request_id=raw.get("request_id"),
            ttft_s=raw.get("ttft_s"),
            tokens=raw.get("tokens"),
            tokens_requested=raw.get("tokens_requested"),
        )

    t0 = _clock.monotonic()
    for idx, ev in enumerate(ordered):
        delay = (t0 + ev.t) - _clock.monotonic()
        if delay > 0:
            _clock.sleep(delay)
        fired_t = _clock.monotonic() - t0
        metrics.counter_add("loadgen/fired")
        if not inflight.acquire(blocking=False):
            # Cap hit: charge the arrival, never block the wheel.
            outcomes[idx] = RequestOutcome(
                index=idx, scheduled_t=ev.t, fired_t=fired_t,
                status="overload", latency_s=0.0,
                size=ev.size, bucket=ev.bucket,
            )
            continue
        th = threading.Thread(
            target=_fire, args=(idx, ev, fired_t), daemon=True,
            name=f"loadgen-fire-{idx}",
        )
        th.start()
        done.append(th)
    join_deadline = _clock.monotonic() + timeout_s + 5.0
    for th in done:
        th.join(timeout=max(0.0, join_deadline - _clock.monotonic()))
    wall = max(_clock.monotonic() - t0, 1e-9)
    for idx, ev in enumerate(ordered):
        if outcomes[idx] is None:  # joiner gave up: count as error
            outcomes[idx] = RequestOutcome(
                index=idx, scheduled_t=ev.t, fired_t=ev.t,
                status="error", latency_s=timeout_s,
                size=ev.size, bucket=ev.bucket,
            )
    result.outcomes = [o for o in outcomes if o is not None]
    result.duration_s = max(duration, wall if not duration else duration)
    for status, n in result.counts().items():
        if n:
            metrics.counter_add(f"loadgen/status/{status}", n)
    metrics.gauge_set("loadgen/offered_rps", result.offered_rps)
    metrics.gauge_set("loadgen/achieved_rps", result.achieved_rps)
    return result
