"""Bounded request queue and continuous batch assembly.

The counterpart of ``raydp_tpu/serve/batching.py``, whole; its time
runs through the port's clock seam and its counters go to the port's
metrics registry.

The serving data structure: an accepted request becomes a
:class:`ServeRequest` with a stable id, a deadline, and a reply slot;
it sits in the :class:`RequestQueue` until a replica dispatcher pulls
a batch. Batch assembly is *continuous* — the dispatcher takes the
oldest request, then greedily drains same-bucket requests that are
already waiting (a short SLO-bounded linger lets near-simultaneous
arrivals coalesce) up to ``max_batch``. Requests are grouped by
padding bucket so the replica sees a small set of padded shapes and
each bucket is one padded shape (SNIPPETS: vLLM-style continuous
batching, simplified to whole-request granularity).

Reply delivery is **at-most-once**: ``complete()`` flips the replied
flag under the queue lock, so a late reply from a presumed-dead
replica racing the retry on a surviving one is counted
(``serve/dup_replies``) and dropped instead of delivered twice.
"""
from __future__ import annotations

import collections
import os
import threading
import uuid
from typing import Any, Deque, List, Optional, Sequence

from raydp_tpu_torch.utils import clock as _clock
from raydp_tpu_torch.utils.env import _env_float, _env_int
from raydp_tpu_torch.utils.profiling import metrics

SERVE_MAX_QUEUE_ENV = "RAYDP_TPU_SERVE_MAX_QUEUE"
SERVE_SLO_MS_ENV = "RAYDP_TPU_SERVE_SLO_MS"
SERVE_MAX_BATCH_ENV = "RAYDP_TPU_SERVE_MAX_BATCH"
SERVE_BUCKETS_ENV = "RAYDP_TPU_SERVE_BUCKETS"
SERVE_TIMEOUT_ENV = "RAYDP_TPU_SERVE_TIMEOUT_S"

_DEFAULT_MAX_QUEUE = 256
_DEFAULT_SLO_MS = 50.0
_DEFAULT_MAX_BATCH = 8
_DEFAULT_BUCKETS = (16, 64, 256)
_DEFAULT_TIMEOUT_S = 30.0


def env_buckets() -> tuple:
    """Padding buckets from ``RAYDP_TPU_SERVE_BUCKETS`` (ascending)."""
    raw = os.environ.get(SERVE_BUCKETS_ENV)
    if not raw:
        return _DEFAULT_BUCKETS
    try:
        vals = tuple(sorted(int(p) for p in raw.split(",") if p.strip()))
        return vals or _DEFAULT_BUCKETS
    except ValueError:
        return _DEFAULT_BUCKETS


class QueueFullError(RuntimeError):
    """Admission refused: the bounded queue is at capacity.

    ``eta_s`` estimates when capacity frees up (queue depth x recent
    per-request service time); the HTTP frontend turns it into a
    ``Retry-After`` header.
    """

    def __init__(self, message: str, queue_depth: int = 0,
                 eta_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.eta_s = eta_s


class RequestCancelled(RuntimeError):
    """The request's deadline expired (or it was cancelled) before a
    replica produced its reply."""


class DecodeState:
    """Driver-side truth for one autoregressive request.

    ``tokens`` is the only copy of the generated stream that survives
    replica death — a requeued sequence re-feeds ``prompt + tokens`` as
    its next incarnation's prefill, and token events are deduplicated
    against ``len(tokens)`` by global index (the token-level half of
    the at-most-once contract).
    """

    __slots__ = (
        "prompt", "max_new", "eos", "tokens", "first_token_mono",
        "finish_reason",
    )

    def __init__(self, prompt: Sequence[int], max_new: int,
                 eos: Optional[int] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos = eos
        self.tokens: List[int] = []
        self.first_token_mono: Optional[float] = None
        self.finish_reason: Optional[str] = None


class ServeRequest:
    """One accepted request, tracked from admission until its single
    reply is delivered."""

    __slots__ = (
        "request_id", "payload", "length", "enqueued_mono",
        "deadline_mono", "attempts", "done", "result", "error",
        "replied", "cancelled", "dequeued_mono", "dispatched_mono",
        "exec_s", "bucket", "phases", "decode",
    )

    def __init__(self, payload: Any, timeout_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 decode: Optional[DecodeState] = None):
        self.request_id = request_id or uuid.uuid4().hex
        self.payload = payload
        try:
            self.length = len(payload)
        except TypeError:
            self.length = 1
        self.enqueued_mono = _clock.monotonic()
        if timeout_s is None:
            timeout_s = _env_float(SERVE_TIMEOUT_ENV, _DEFAULT_TIMEOUT_S)
        self.deadline_mono = self.enqueued_mono + timeout_s
        self.attempts = 0
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[str] = None
        self.replied = False
        self.cancelled = False
        # Provenance stamps (monotonic): set as the request moves
        # queue → batch → replica; ``phases`` is filled at completion.
        self.dequeued_mono: Optional[float] = None
        self.dispatched_mono: Optional[float] = None
        self.exec_s: Optional[float] = None
        self.bucket: Optional[int] = None
        self.phases: Optional[dict] = None
        # Autoregressive requests carry a DecodeState; plain predict
        # requests leave this None and nothing downstream changes.
        self.decode = decode

    def ttft_s(self) -> Optional[float]:
        """Time to first token (decode requests only)."""
        if self.decode is None or self.decode.first_token_mono is None:
            return None
        return max(0.0, self.decode.first_token_mono - self.enqueued_mono)

    def remaining_s(self, now: Optional[float] = None) -> float:
        return self.deadline_mono - (now if now is not None
                                     else _clock.monotonic())

    def expired(self, now: Optional[float] = None) -> bool:
        return self.remaining_s(now) <= 0

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block the submitting thread until the reply; raises
        :class:`RequestCancelled` on deadline expiry or cancellation,
        re-raises a replica-side error as ``RuntimeError``."""
        budget = self.remaining_s() if timeout is None else timeout
        if not self.done.wait(max(0.0, budget) + 0.05):
            raise RequestCancelled(
                f"request {self.request_id} timed out after "
                f"{_clock.monotonic() - self.enqueued_mono:.3f}s"
            )
        if self.cancelled:
            raise RequestCancelled(
                self.error or f"request {self.request_id} cancelled"
            )
        if self.error is not None:
            raise RuntimeError(self.error)
        return self.result


#: The additive phase decomposition: these four account for the whole
#: accept→reply wall (queue_wait + linger + execute + reply == total).
PHASE_NAMES = ("queue_wait", "linger", "execute", "reply")

#: All phase histogram labels, including the informational
#: ``padding_waste`` sub-slice of ``execute`` (not part of the sum).
PHASE_LABELS = PHASE_NAMES + ("padding_waste",)

#: Decode-only sub-slices of ``execute``: ``prefill`` (dispatch → first
#: token) and ``decode`` (first token → completion). Like
#: ``padding_waste`` they are informational — already counted inside
#: ``execute``, so the four-phase sum contract is untouched.
DECODE_PHASE_LABELS = ("prefill", "decode")


def request_phases(req: ServeRequest,
                   completed_mono: float) -> Optional[dict]:
    """Decompose one request's life into phase durations (seconds).

    ``queue_wait`` (admit → popped into a batch), ``linger`` (popped →
    dispatched to a replica), ``execute`` (replica-measured model
    wall, when the reply carried ``exec_s``; else the whole RPC wall),
    ``reply`` (RPC + reply-delivery residual). The four sum to
    ``total`` by construction. ``padding_waste`` is the slice of
    ``execute`` spent on pad rows (``execute × (1 − length/bucket)``)
    — informational, already counted inside ``execute``.

    Returns ``None`` when the request never made it into a batch
    (shed, expired in queue) — there is nothing to decompose.
    """
    if req.dequeued_mono is None:
        return None
    total = max(0.0, completed_mono - req.enqueued_mono)
    queue_wait = max(0.0, req.dequeued_mono - req.enqueued_mono)
    dispatched = (req.dispatched_mono if req.dispatched_mono is not None
                  else req.dequeued_mono)
    linger = max(0.0, dispatched - req.dequeued_mono)
    tail = max(0.0, completed_mono - dispatched)
    if req.exec_s is not None:
        execute = min(max(0.0, req.exec_s), tail)
    else:
        execute = tail
    reply = max(0.0, tail - execute)
    waste = 0.0
    if req.bucket and req.bucket > 0:
        fill = min(1.0, max(0.0, req.length / req.bucket))
        waste = execute * (1.0 - fill)
    out = {
        "queue_wait": queue_wait,
        "linger": linger,
        "execute": execute,
        "reply": reply,
        "padding_waste": waste,
        "total": total,
    }
    if req.decode is not None and req.decode.first_token_mono is not None:
        # TTFT/TPOT provenance by construction: execute splits at the
        # first token's arrival. prefill+decode == execute exactly.
        prefill = min(
            execute, max(0.0, req.decode.first_token_mono - dispatched)
        )
        out["prefill"] = prefill
        out["decode"] = execute - prefill
    return out


class RequestQueue:
    """Bounded FIFO with bucket-aware continuous batch assembly."""

    def __init__(
        self,
        max_depth: Optional[int] = None,
        slo_ms: Optional[float] = None,
        max_batch: Optional[int] = None,
        buckets: Optional[Sequence[int]] = None,
    ):
        self.max_depth = (
            _env_int(SERVE_MAX_QUEUE_ENV, _DEFAULT_MAX_QUEUE)
            if max_depth is None else int(max_depth)
        )
        self.slo_s = (
            _env_float(SERVE_SLO_MS_ENV, _DEFAULT_SLO_MS)
            if slo_ms is None else float(slo_ms)
        ) / 1000.0
        self.max_batch = (
            _env_int(SERVE_MAX_BATCH_ENV, _DEFAULT_MAX_BATCH)
            if max_batch is None else int(max_batch)
        )
        self.buckets = tuple(sorted(buckets)) if buckets else env_buckets()
        self._mu = threading.Condition(threading.Lock())
        self._pending: Deque[ServeRequest] = collections.deque()
        self._closed = False
        # Arrival observers (loadgen trace recorder): called outside
        # the lock after each successful admit with (req, mono_now).
        self._arrival_observers: List[Any] = []
        # EWMA of per-request service time feeds the shed ETA; seeded
        # with the SLO so the very first 429 still carries a number.
        self._service_ewma_s = max(self.slo_s, 0.001)

    # -- admission ------------------------------------------------------

    def bucket_for(self, length: int) -> int:
        """Smallest configured bucket that fits ``length`` (the last
        bucket also absorbs oversize requests — the replica pads or
        truncates there; shape count stays bounded either way)."""
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def depth(self) -> int:
        with self._mu:
            return len(self._pending)

    def shed_eta_s(self) -> float:
        with self._mu:
            return self._eta_locked()

    def _eta_locked(self) -> float:
        waves = (len(self._pending) + 1) / max(1, self.max_batch)
        return max(0.1, waves * self._service_ewma_s)

    def observe_service_time(self, seconds: float) -> None:
        with self._mu:
            self._service_ewma_s = (
                0.8 * self._service_ewma_s + 0.2 * max(seconds, 1e-4)
            )

    def submit(self, req: ServeRequest) -> None:
        """Admit ``req`` or raise :class:`QueueFullError` (never
        blocks — backpressure is the caller's 429)."""
        with self._mu:
            if self._closed:
                raise QueueFullError("serving queue closed", 0, None)
            if len(self._pending) >= self.max_depth:
                metrics.counter_add("serve/rejected")
                raise QueueFullError(
                    f"serving queue full ({self.max_depth} pending)",
                    queue_depth=len(self._pending),
                    eta_s=self._eta_locked(),
                )
            self._pending.append(req)
            metrics.counter_add("serve/requests")
            metrics.gauge_set("serve/queue_depth", len(self._pending))
            self._mu.notify()
            observers = list(self._arrival_observers)
        if observers:
            now = _clock.monotonic()
            for fn in observers:
                try:
                    fn(req, now)
                except Exception:
                    pass

    def add_arrival_observer(self, fn: Any) -> None:
        """Register ``fn(req, mono_now)`` to see every admitted
        request — the loadgen trace recorder's capture point."""
        with self._mu:
            self._arrival_observers.append(fn)

    def remove_arrival_observer(self, fn: Any) -> None:
        with self._mu:
            try:
                self._arrival_observers.remove(fn)
            except ValueError:
                pass

    def requeue(self, reqs: Sequence[ServeRequest]) -> int:
        """Put in-flight requests back at the FRONT of the queue (a
        failed replica's batch retries before newer arrivals — FIFO
        fairness survives the failover). Expired or already-replied
        requests are not requeued; expired ones are cancelled so their
        submitter unblocks. Returns the number requeued."""
        n = 0
        now = _clock.monotonic()
        with self._mu:
            for req in reversed(list(reqs)):
                if req.replied:
                    continue
                if req.expired(now):
                    req.cancelled = True
                    req.error = (
                        f"request {req.request_id} expired during failover"
                    )
                    req.replied = True
                    metrics.counter_add("serve/errors")
                    req.done.set()
                    continue
                # Fresh provenance stamps for the retry attempt: the
                # failed attempt's time lands in queue_wait, keeping
                # the phase sum equal to the end-to-end wall.
                req.dequeued_mono = None
                req.dispatched_mono = None
                req.exec_s = None
                self._pending.appendleft(req)
                n += 1
            if n:
                metrics.counter_add("serve/requeued", n)
                metrics.gauge_set("serve/queue_depth", len(self._pending))
                self._mu.notify_all()
        return n

    # -- batch assembly -------------------------------------------------

    def next_batch(self, wait_timeout: float = 0.5) -> List[ServeRequest]:
        """Continuous batching: block up to ``wait_timeout`` for the
        first request, then linger up to the SLO window (bounded by
        the head request's own deadline slack) collecting same-bucket
        requests until ``max_batch``. Expired requests are cancelled
        in place, never dispatched."""
        with self._mu:
            deadline = _clock.monotonic() + wait_timeout
            head = self._pop_live_locked()
            while head is None:
                remaining = deadline - _clock.monotonic()
                if remaining <= 0 or self._closed:
                    return []
                _clock.wait_on(self._mu, timeout=remaining)
                head = self._pop_live_locked()
            bucket = self.bucket_for(head.length)
            batch = [head]
            # Linger window: bounded by the SLO and by how much slack
            # the head request has left — a nearly-expired head ships
            # immediately rather than dying in the linger.
            linger_end = _clock.monotonic() + min(
                self.slo_s, max(0.0, head.remaining_s() - self.slo_s)
            )
            while len(batch) < self.max_batch:
                more = self._pop_bucket_locked(bucket)
                if more is not None:
                    batch.append(more)
                    continue
                remaining = linger_end - _clock.monotonic()
                if remaining <= 0:
                    break
                _clock.wait_on(self._mu, timeout=remaining)
            metrics.gauge_set("serve/queue_depth", len(self._pending))
            metrics.counter_add("serve/batches")
            metrics.counter_add("serve/batch_requests", len(batch))
            metrics.gauge_set(
                "serve/batch_fill", len(batch) / max(1, self.max_batch)
            )
            for req in batch:
                req.attempts += 1
            return batch

    def _pop_live_locked(self) -> Optional[ServeRequest]:
        now = _clock.monotonic()
        while self._pending:
            req = self._pending.popleft()
            if req.expired(now):
                self._cancel_locked(req, "deadline expired in queue")
                continue
            req.dequeued_mono = now
            req.bucket = self.bucket_for(req.length)
            return req
        return None

    def _pop_bucket_locked(self, bucket: int) -> Optional[ServeRequest]:
        now = _clock.monotonic()
        for i, req in enumerate(self._pending):
            if req.expired(now):
                continue  # swept by the next _pop_live_locked pass
            if self.bucket_for(req.length) == bucket:
                del self._pending[i]
                req.dequeued_mono = now
                req.bucket = bucket
                return req
        return None

    def _cancel_locked(self, req: ServeRequest, why: str) -> None:
        if req.replied:
            return
        req.cancelled = True
        req.error = f"request {req.request_id}: {why}"
        req.replied = True
        metrics.counter_add("serve/errors")
        req.done.set()

    # -- reply delivery (at-most-once) ----------------------------------

    def complete(self, req: ServeRequest, result: Any = None,
                 error: Optional[str] = None) -> bool:
        """Deliver the single reply for ``req``. Returns False (and
        bumps ``serve/dup_replies``) when a reply already landed —
        the id-dedup half of the zero-dropped-request contract."""
        with self._mu:
            if req.replied:
                metrics.counter_add("serve/dup_replies")
                return False
            req.replied = True
        req.result = result
        req.error = error
        now = _clock.monotonic()
        if error is not None:
            metrics.counter_add("serve/errors")
        else:
            metrics.counter_add("serve/replies")
            metrics.meter("serve/throughput").add(1)
        # Cumulative histogram (not a rolling timer): bucket counts
        # sum across replicas/workers, so the merged p99 is exact.
        metrics.histogram("serve/latency").observe(now - req.enqueued_mono)
        phases = request_phases(req, now)
        if phases is not None:
            req.phases = phases
            for name in PHASE_LABELS:
                metrics.histogram(f"serve/phase/{name}").observe(
                    phases[name]
                )
            for name in DECODE_PHASE_LABELS:
                if name in phases:
                    metrics.histogram(f"serve/phase/{name}").observe(
                        phases[name]
                    )
        req.done.set()
        return True

    def close(self) -> None:
        with self._mu:
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
            self._mu.notify_all()
        for req in pending:
            with self._mu:
                self._cancel_locked(req, "serving plane shut down")
